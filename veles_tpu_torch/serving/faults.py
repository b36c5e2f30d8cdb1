"""Deterministic fault injection for the serving tier.

Port of ``veles_tpu/serving/faults.py``, whole: a :class:`FaultPlan`
arms named SITES (fixed strings compiled into ``serving/lm_engine.py``,
``serving/batcher.py``, ``serving/router.py`` and ``restful_api.py``)
with rules that raise, delay, or freeze at chosen call numbers, so the
serving stack's failure paths — a faulted dispatch failing exactly its
lanes, pool cleanup mid-prefill, a refused weight swap, a wedged worker
and its crash-safe restore — are driven as deterministic inputs
instead of monkeypatches.

Design rules (the reference's):

- UNARMED IS FREE.  Engines hold ``self._faults = None`` by default and
  every site is one attribute-is-None check — no dict lookup, no lock,
  no counter.
- DETERMINISTIC.  Rules fire on per-site CALL NUMBERS (``calls={3}``,
  ``every=4``, ``after=10``) counted under the plan's lock, so a given
  plan against a given request order always injects at the same
  dispatches.  ``prob=`` draws from the plan's own seeded
  ``numpy.random.RandomState`` under that lock, exactly as the
  reference draws, so one plan against one call order fires at the
  same call numbers in both packages.
- INJECTED ERRORS ARE LABELED.  The default exception is
  :class:`InjectedFault`; logs and asserts can always tell an injected
  fault from a real one.
- FREEZES ARE RELEASABLE.  ``kind="freeze"`` blocks the calling thread
  (a wedged replica) on an Event that :meth:`FaultPlan.release` sets —
  release a frozen plan before stopping the engine it wedged, or the
  worker's join times out.

Sites (each a no-op when unarmed):

===================== ==================================================
``engine.submit``     LMEngine.submit admission
``engine.tick``       top of the engine worker loop (latency / freeze;
                      a raised fault fails the busy lanes)
``engine.prefill``    whole-prompt prefill dispatch (the reference's
                      contiguous layout; no call site in the port yet)
``engine.chunk``      paged prompt-chunk dispatch (a lane's or a
                      standby ring entry's)
``engine.cow``        paged copy-on-write page-copy dispatch
``engine.step``       batched decode dispatch (per tick, the captured
                      scan, the while megastep)
``engine.verify``     speculative verify dispatch
``engine.swap``       weight-swap apply (LMEngine.swap_weights; a
                      raised fault refuses the swap, old weights
                      keep serving)
``batcher.submit``    MicroBatcher.submit admission
``batcher.dispatch``  MicroBatcher forward dispatch
``router.place``      Router placement, once a placement attempt
                      (``serving/router.py``, ``Router._place``)
``http.request``      restful_api request dispatch (transient HTTP
                      errors via :class:`InjectedHTTPError`, latency)
===================== ==================================================

Plans load from JSON (CLI ``--fault-plan plan.json``)::

    {"seed": 7, "sites": [
        {"site": "engine.step", "kind": "error", "calls": [3],
         "exc": "InjectedFault"},
        {"site": "engine.tick", "kind": "latency", "every": 8,
         "latency_s": 0.05},
        {"site": "http.request", "kind": "error", "exc": "http_503",
         "prob": 0.1, "times": 5}]}
"""

from __future__ import annotations

import json
import threading
import time

import numpy

from veles_tpu_torch.serving import lockcheck


class InjectedFault(RuntimeError):
    """An exception the fault layer raised on purpose — never confusable
    with a real device or CUDA runtime error in logs or test asserts."""


class InjectedHTTPError(RuntimeError):
    """A transient HTTP-level fault: ``restful_api`` serves ``code``
    with a structured body (and ``Retry-After`` on 429/503) instead of
    treating it as a real 500 — the shape retryable infrastructure
    blips (LB resets, proxy timeouts) have in production."""

    def __init__(self, code=503, retry_after=1.0):
        super().__init__("injected transient HTTP %d" % code)
        self.code = int(code)
        self.retry_after = float(retry_after)


def _named_exc(name):
    """Exception factory for JSON plans: a few serving-meaningful names
    plus the generic labeled fault."""
    def overloaded(msg):
        from veles_tpu_torch.serving.batcher import Overloaded
        return Overloaded()

    def pool_exhausted(msg):
        from veles_tpu_torch.serving.batcher import PoolExhausted
        return PoolExhausted(1, 0)

    table = {
        "InjectedFault": InjectedFault,
        "RuntimeError": RuntimeError,
        "Overloaded": overloaded,
        "PoolExhausted": pool_exhausted,
        "http_429": lambda msg: InjectedHTTPError(429, 0.25),
        "http_500": lambda msg: InjectedHTTPError(500),
        "http_503": lambda msg: InjectedHTTPError(503),
    }
    if name not in table:
        raise ValueError("unknown fault exception %r (one of %r)"
                         % (name, sorted(table)))
    return table[name]


class _Rule:
    __slots__ = ("kind", "make_exc", "message", "calls", "every",
                 "after", "prob", "times", "latency_s", "duration_s",
                 "fired")

    def __init__(self, kind, make_exc, message, calls, every, after,
                 prob, times, latency_s, duration_s):
        self.kind = kind
        self.make_exc = make_exc
        self.message = message
        self.calls = frozenset(calls) if calls is not None else None
        self.every = every
        self.after = after
        self.prob = prob
        self.times = times
        self.latency_s = latency_s
        self.duration_s = duration_s
        self.fired = 0


class FaultPlan:
    """A seeded set of fault rules over named sites; see the module
    docstring.  Thread-safe: counters and the RNG live under one lock
    (sites only pay it once ARMED — unarmed engines never call in)."""

    KINDS = ("error", "latency", "freeze")

    #: lock-discipline map: rules/counters/RNG are touched
    #: from every armed site's thread — one plan lock guards them all.
    _guarded_by = {
        "_rules": "_lock",
        "_counts": "_lock",
        "_fired": "_lock",
        "_rng": "_lock",
    }

    def __init__(self, seed=0):
        self._rules = {}        # site -> [_Rule]
        self._counts = {}       # site -> calls observed
        self._fired = {}        # site -> rules fired
        self._lock = lockcheck.make_lock("faults._lock")
        self._rng = numpy.random.RandomState(seed)
        #: set by release(): every current AND future freeze is a no-op
        #: (teardown must always be able to thaw a wedged worker)
        self._released = threading.Event()

    # -------------------------------------------------------------- arming
    def arm(self, site, kind="error", exc=None, message=None,
            calls=None, every=None, after=None, prob=None, times=None,
            latency_s=0.05, duration_s=600.0):
        """Add one rule at ``site``.  Conditions given are ANDed
        (``calls`` membership, ``every`` N-th call, ``after`` a call
        threshold, ``prob`` a seeded coin); no condition = every call.
        ``times`` caps total firings.  ``kind``: 'error' raises
        (``exc`` = class, factory, or JSON name; default
        InjectedFault), 'latency' sleeps ``latency_s``, 'freeze'
        blocks until :meth:`release` (at most ``duration_s``).
        Returns self (chainable)."""
        if kind not in self.KINDS:
            raise ValueError("fault kind %r (one of %r)"
                             % (kind, self.KINDS))
        if isinstance(exc, str):
            exc = _named_exc(exc)
        if exc is None:
            exc = InjectedFault
        rule = _Rule(kind, exc,
                     message or ("injected %s at %s" % (kind, site)),
                     calls, every, after, prob, times,
                     float(latency_s), float(duration_s))
        with self._lock:
            self._rules.setdefault(site, []).append(rule)
        return self

    def disarm(self, site=None):
        """Drop every rule (or just ``site``'s) — later calls are
        no-ops again; call counters survive for evidence reads."""
        with self._lock:
            if site is None:
                self._rules.clear()
            else:
                self._rules.pop(site, None)

    def release(self):
        """Thaw every freeze, present and future — MUST be called
        before stopping an engine a freeze rule wedged."""
        self._released.set()

    # -------------------------------------------------------------- firing
    def fire(self, site):
        """Evaluate ``site``'s rules at this call.  Called only from
        the compiled-in hooks (which already checked a plan is
        attached); raises / sleeps / blocks per the matching rules."""
        todo = []
        with self._lock:
            rules = self._rules.get(site)
            n = self._counts.get(site, 0) + 1
            self._counts[site] = n
            for r in rules or ():
                if r.times is not None and r.fired >= r.times:
                    continue
                if r.calls is not None and n not in r.calls:
                    continue
                if r.every is not None and n % r.every:
                    continue
                if r.after is not None and n <= r.after:
                    continue
                if r.prob is not None \
                        and self._rng.random_sample() >= r.prob:
                    continue
                r.fired += 1
                self._fired[site] = self._fired.get(site, 0) + 1
                todo.append(r)
        for r in todo:
            if r.kind == "latency":
                time.sleep(r.latency_s)
            elif r.kind == "freeze":
                self._released.wait(r.duration_s)
            else:
                raise r.make_exc(r.message)

    # ------------------------------------------------------------ evidence
    def calls(self, site):
        """Calls observed at ``site`` (armed or not, once fire ran)."""
        with self._lock:
            return self._counts.get(site, 0)

    def fired(self, site=None):
        """Rules fired at ``site`` — or the whole {site: count} map."""
        with self._lock:
            if site is not None:
                return self._fired.get(site, 0)
            return dict(self._fired)

    # --------------------------------------------------------------- specs
    @classmethod
    def from_spec(cls, spec):
        """Build a plan from a JSON-shaped dict: ``{"seed": S,
        "sites": [{"site": ..., "kind": ..., ...}, ...]}``."""
        plan = cls(seed=int(spec.get("seed", 0)))
        for entry in spec.get("sites", ()):
            entry = dict(entry)
            site = entry.pop("site")
            plan.arm(site, **entry)
        return plan

    @classmethod
    def from_file(cls, path):
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_spec(json.load(f))
