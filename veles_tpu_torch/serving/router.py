"""Data-parallel LM serving — N engine replicas behind a metrics-driven
router.

Port of ``veles_tpu/serving/router.py``'s placement and admission half:
N INDEPENDENT :class:`~veles_tpu_torch.serving.LMEngine` replicas, each
on its own device (:func:`replica_device_slices`), behind a
:class:`Router` that places each admitted request on one replica.
Replicas share nothing (no cross-replica KV, no shared queue); the
router keeps the serving contract intact:

- PLACEMENT is driven by the replicas' live ``serving/metrics.py``
  signals, nothing engine-internal: queue depth + busy lanes scaled by
  the replica's decode-step EWMA (its measured pace), the TTFT EWMA as
  the queueing penalty, and resident-KV-page pressure.  Ties (an idle
  fleet) break by fewest requests routed, so cold traffic spreads
  evenly instead of piling on replica 0.  ``policy="round_robin"``
  ignores the signals.
- ADMISSION semantics are unchanged: the router tries replicas in
  placement order and re-raises the engines' own
  :class:`~veles_tpu_torch.serving.batcher.Overloaded` /
  :class:`~veles_tpu_torch.serving.batcher.PoolExhausted` only when
  EVERY live replica refused (HTTP 429 upstream, as one engine) — with
  ``retry_after`` the MINIMUM over the refusing replicas, since the
  client may retry as soon as ANY replica frees; deadline sheds (503)
  and client errors (ValueError → 400) pass through untouched.  A
  single replica degenerates to the one-engine path — same outputs,
  same errors.
- A SICK replica HOT-UNREGISTERS (:meth:`Router.unregister`): it leaves
  the placement rotation at once and every request the router still
  has pending on it — queued or mid-decode — is withdrawn and REQUEUED
  on the surviving replicas.  A request completes exactly once: a
  requeue fires only for work the drain itself interrupted (cancelled,
  or returned short), never for a result that arrived whole.  A replica
  too wedged to resolve its withdrawn request is abandoned after
  ``drain_timeout_s`` and the request re-placed; the zombie's late
  result is ignored.  Requests never wedge: when no live replica can
  take a requeued request, its future fails loudly.

The router's own :class:`ServingMetrics` meters placement
(``routed_requests{replica="i"}``, ``requeued_requests``,
``replica_drains``, ``drain_forced_replacements``, rejected), and each
replica's engine metrics register under one family name with a
``{replica="i"}`` label — ``/metrics`` renders one ``# TYPE`` line per
family with one row per replica, and ``/metrics.json`` (via
:class:`RouterMetrics`) embeds every replica's snapshot under
``"replicas"``.

THREADS AND THE TRANSFER GUARD.  An engine resolves a request's future
on its worker, inside the guarded turn (``xfer.guard``), so
:meth:`Router._on_attempt_done` — and the re-placement it may start
on another replica — runs under replica i's guard.  Everything the router does is host work (numpy prompts, locks,
metrics, futures); it touches no card value.  The card's sync debug
mode is process-wide (ROADMAP Queue 3 item 23), so a boundary one
replica's worker opens lifts the mode for the other replicas' workers
while it is open; the router does not change that.

Not ported yet: the resilience layer — ``retries``, ``hedge_after_s``
and :class:`HealthChecker` (ROADMAP Queue 1 item 9(b)) — and
:meth:`Router.deploy` with the model manager (item 9(c)).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future

import numpy
import torch

from veles_tpu_torch.logger import Logger
from veles_tpu_torch.serving import lockcheck, tracing
from veles_tpu_torch.serving.batcher import DeadlineExceeded, Overloaded
from veles_tpu_torch.serving.metrics import ServingMetrics

_RESILIENCE = "ROADMAP Queue 1 item 9(b) (the router's resilience layer)"
_DEPLOY = "ROADMAP Queue 1 item 9(c) (fleet deploy and the model manager)"


def replica_device_slices(replicas, tp, devices=None):
    """The device slice each replica owns: replica ``i`` gets devices
    ``[i*tp, (i+1)*tp)`` when tensor-parallel (validated against the
    device count up front), one device round-robin otherwise.  THE one
    replica→devices mapping ``serve_lm`` consumes.  ``devices`` None
    means every visible CUDA card (raising without one: the fleet never
    falls back to the CPU); pass ``[torch.device("cpu")]`` for CPU
    replicas."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not n:
            raise RuntimeError("replica_device_slices: no CUDA card is "
                               "visible (pass devices= for CPU replicas)")
        devices = [torch.device("cuda", k) for k in range(n)]
    devices = list(devices)
    n_rep = max(1, int(replicas))
    tp_n = int(tp or 0)
    if tp_n >= 2:
        if n_rep * tp_n > len(devices):
            raise ValueError(
                "replicas=%d × tp=%d needs %d devices, have %d"
                % (n_rep, tp_n, n_rep * tp_n, len(devices)))
        return [devices[i * tp_n:(i + 1) * tp_n] for i in range(n_rep)]
    return [[devices[i % len(devices)]] for i in range(n_rep)]


class NoLiveReplicas(Overloaded):
    """Every replica is out of rotation (drained) — a TRANSIENT
    unavailability, served upstream as the retryable 429 +
    ``Retry-After``, never a 500."""

    def __init__(self, retry_after=1.0):
        RuntimeError.__init__(
            self, "router has no live replicas (all quarantined or "
                  "drained); retry after %.1fs" % retry_after)
        self.retry_after = retry_after


class RouterMetrics(ServingMetrics):
    """Router-owned metrics whose ``snapshot()`` additionally embeds
    each replica engine's snapshot under ``"replicas"`` — one
    ``/metrics.json`` fetch covers the whole fleet."""

    def __init__(self, name="lm_router", labels=None):
        super().__init__(name, labels=labels)
        self._router = None

    def snapshot(self):
        snap = super().snapshot()
        router = self._router
        if router is not None:
            snap["replicas"] = [e.metrics.snapshot()
                                for e in router.replicas]
        return snap


class _Attempt:
    """One engine-side placement of a job."""

    __slots__ = ("job", "replica", "engine_future", "requeue",
                 "abandoned", "span")

    def __init__(self, job):
        self.job = job
        self.replica = None
        self.engine_future = None
        #: this attempt's open span handle (tracing)
        self.span = None
        #: set by unregister() right before it withdraws the engine-side
        #: request: tells the completion callback that a cancellation or
        #: short result is drain fallout to REPLACE, not a client event
        self.requeue = False
        #: set when a drain timeout force-replaced this attempt while
        #: its engine was WEDGED: whatever the zombie engine eventually
        #: resolves is ignored (the replacement owns the client future)
        self.abandoned = False


class _Job:
    """One routed request: the client-facing future plus its live
    engine-side placement (at most one until retries and hedges, ROADMAP
    Queue 1 item 9(b), add siblings)."""

    __slots__ = ("prompt", "n_new", "future", "t0", "replica", "live",
                 "requeues", "version", "delivered", "trace", "own_trace")

    def __init__(self, prompt, n_new):
        self.prompt = prompt
        self.n_new = int(n_new)
        self.future = Future()
        #: the request's TraceContext (or None), and whether the ROUTER
        #: rooted it (finished in _forget, once every attempt settled)
        self.trace = None
        self.own_trace = False
        self.future.job = self          # router-level cancellation handle
        self.t0 = time.monotonic()
        #: replica of the newest placement (the delivering attempt's
        #: after delivery) — what serve_lm stamps into ``"replicas"``
        self.replica = None
        #: the weights_version that produced the delivered tokens
        self.version = None
        #: delivery claim (router lock): exactly one attempt stamps
        #: replica/version and resolves the future
        self.delivered = False
        #: live attempts (guarded by the router lock)
        self.live = set()
        self.requeues = 0


class Router(Logger):
    """Place requests on ``replicas`` (started/stopped together) by
    their live metrics; see the module docstring for the contract.

    ``faults`` attaches a :class:`~veles_tpu_torch.serving.faults.
    FaultPlan` whose ``router.place`` site fires per placement attempt;
    ``tracer`` a :class:`~veles_tpu_torch.serving.tracing.SpanTracer`
    (one ``attempt`` span a placement attempt).  ``seed`` seeds the
    canary coin of :meth:`_order`.  ``retries`` and ``hedge_after_s``
    must stay 0: retries, hedges and their backoff are ROADMAP Queue 1
    item 9(b)'s."""

    POLICIES = ("metrics", "round_robin")

    #: lock-discipline map: placement state is touched by client
    #: threads, engine-worker completion callbacks and drain timers —
    #: everything shared lives under ``_lock``.  ``_deploy_lock``
    #: serializes whole deploys and guards no attributes.  Job/attempt
    #: fields (job.live, job.delivered) are guarded by ``_lock`` too.
    _guarded_by = {
        "_live": "_lock",
        "_routed": "_lock",
        "_pending": "_lock",
        "_jobs": "_lock",
        "_timers": "_lock",
        "_stopping": "_lock",
        "_rr": "_lock",
        "_canary": "_lock",
        "_canary_fraction": "_lock",
        "_rng": "_lock",
    }

    def __init__(self, replicas, metrics=None, name="lm_router",
                 policy="metrics", retries=0, hedge_after_s=0.0,
                 drain_timeout_s=5.0, seed=0, faults=None,
                 tracer=None):
        replicas = list(replicas)
        if not replicas:
            raise ValueError("router needs at least one replica")
        if policy not in self.POLICIES:
            raise ValueError("unknown router policy %r (one of %r)"
                             % (policy, self.POLICIES))
        if int(retries):
            raise NotImplementedError(
                "Router(retries=) is not ported yet: %s" % _RESILIENCE)
        if float(hedge_after_s or 0.0):
            raise NotImplementedError(
                "Router(hedge_after_s=) is not ported yet: %s"
                % _RESILIENCE)
        self.name = name
        self.replicas = replicas
        self.policy = policy
        self.drain_timeout_s = float(drain_timeout_s)
        self.metrics = metrics or ServingMetrics(name)
        if isinstance(self.metrics, RouterMetrics):
            self.metrics._router = self
        self._faults = faults
        #: optional SpanTracer — one attribute-is-None check per site
        #: when unarmed
        self._tracer = tracer
        self._live = [True] * len(replicas)
        self._routed = [0] * len(replicas)
        self._pending = [set() for _ in replicas]
        self._jobs = set()              # outstanding requests
        self._timers = set()            # pending drain timers
        self._lock = lockcheck.make_lock("router._lock")
        self._rng = numpy.random.RandomState(seed)
        self._rr = 0
        self._stopping = False
        #: canary traffic steering: while a deploy watches its canary,
        #: placement prefers the canary set with this probability (inert
        #: until Router.deploy is ported)
        self._canary = frozenset()
        self._canary_fraction = 0.0
        self._deploy_lock = lockcheck.make_lock("router._deploy_lock")
        self.metrics.set_gauge("replicas_total", len(replicas))
        self.metrics.set_gauge("replicas_live", len(replicas))
        for i in range(len(replicas)):
            self._note_version(i)

    # ----------------------------------------------------------- properties
    @property
    def spec_k(self):
        """Speculation headroom upstream admission must reserve — the
        replicas share a config, but take the max so a heterogeneous
        fleet still reserves enough for any placement."""
        return max(e.spec_k for e in self.replicas)

    @property
    def max_len(self):
        return min(e.max_len for e in self.replicas)

    # ------------------------------------------------------------ lifecycle
    def start(self):
        """Start the replicas one after another, before any request is
        admitted.  Each engine's ``start()`` warms up and, on the card,
        captures its CUDA graphs before it returns, so no replica's
        capture overlaps another replica's launches."""
        for e in self.replicas:
            e.start()
        return self

    def stop(self):
        with self._lock:
            self._stopping = True
            timers = list(self._timers)
            self._timers.clear()
            jobs = list(self._jobs)
        for t in timers:
            t.cancel()
        # a job whose attempt a cancelled drain timer would have
        # re-placed has no live attempt left to resolve it — fail it
        # loudly instead of wedging the client on a future nobody owns
        for job in jobs:
            with self._lock:
                orphan = not job.live and not job.future.done()
            if orphan:
                self._settle_exc(job, RuntimeError("router stopped"))
                self._forget(job)
        for e in self.replicas:
            e.stop()

    @staticmethod
    def _settle_exc(job, exc):
        """Fail the client future unless a concurrent path already
        settled it — the Future's own state transition is the arbiter,
        as in _deliver's result race."""
        try:
            job.future.set_exception(exc)
        except Exception:   # noqa: BLE001 — someone else settled it
            pass

    # ------------------------------------------------------------ placement
    def _fault(self, site):
        if self._faults is not None:
            self._faults.fire(site)

    def _score(self, i):
        """Smaller = place here.  Everything read from the replica's
        live ServingMetrics: outstanding work (queue depth + busy
        lanes) scaled by the replica's measured decode-step EWMA (a
        slow replica's queue costs more wall than a fast one's), the
        TTFT EWMA weighted by queue depth (the queueing penalty new
        arrivals feel), and fractional resident-KV-page pressure as the
        paged-pool tiebreak."""
        m = self.replicas[i].metrics
        depth = m.gauge("queue_depth", 0) + m.gauge("slots_busy", 0)
        step = m.ewma("decode_step", 0.0) or 1e-4
        score = depth * step + m.ewma("ttft", 0.0) * m.gauge(
            "queue_depth", 0)
        kv_total = m.gauge("kv_pages_total", 0)
        if kv_total:
            score += (1.0 - m.gauge("kv_pages_free", kv_total)
                      / kv_total) * step
        return score

    def _note_version(self, i):
        """Export replica i's serving checkpoint generation as the
        ``weights_version{replica=}`` gauge."""
        v = getattr(self.replicas[i], "weights_version", None)
        if isinstance(v, (int, float)):
            self.metrics.set_gauge("weights_version", v,
                                   labels={"replica": str(i)})

    def _order(self):
        """Live replica indices, best placement first.  While a deploy
        watches a canary, a seeded coin steers ``_canary_fraction`` of
        placements to the canary set first (the rest of the fleet
        remains the admission fallback either way)."""
        with self._lock:
            live = [i for i, ok in enumerate(self._live) if ok]
            if self.policy == "round_robin":
                self._rr += 1
                start = self._rr
            routed = list(self._routed)
            canary = self._canary
            pick_canary = bool(canary) and \
                self._rng.random_sample() < self._canary_fraction
        if not live:
            raise NoLiveReplicas()
        if self.policy == "round_robin":
            order = [live[(start + j) % len(live)]
                     for j in range(len(live))]
        else:
            order = sorted(live,
                           key=lambda i: (self._score(i), routed[i], i))
        if canary:
            order = ([i for i in order if (i in canary) == pick_canary]
                     + [i for i in order
                        if (i in canary) != pick_canary])
        return order

    def submit(self, prompt, n_new):
        """Queue one prompt on the best replica; returns a Future for
        the (n_new,) continuation.  Raises exactly what one engine
        would: ValueError for client errors, Overloaded / PoolExhausted
        when every live replica refuses admission (with ``retry_after``
        the MINIMUM over the refusing replicas)."""
        job = _Job(prompt, int(n_new))
        # join the caller's trace (HTTP) or root one here: the attempt
        # spans _place opens nest under it.  A router-rooted trace
        # finishes in _forget, once every attempt settled; a
        # sampled-out decision leaves job.trace None and _place
        # propagates it so the engines never re-roll the coin
        if self._tracer is not None:
            ctx, job.own_trace = tracing.join_or_root(
                self._tracer, "request", "router")
            job.trace = None if ctx is tracing.SAMPLED_OUT else ctx
        with self._lock:
            self._jobs.add(job)
        try:
            self._place(job)
        except Exception as e:
            with self._lock:
                self._jobs.discard(job)
            if job.own_trace:
                job.trace.tracer.finish_request(job.trace, error=e)
            raise
        return job.future

    def _place(self, job):   # hot-path
        """Place one attempt for ``job`` on the first replica in
        placement order that admits it; raises when every live replica
        refuses.  Host work only: it may run on another replica's
        worker, under that worker's transfer guard."""
        last_exc = None
        min_retry = None
        for i in self._order():
            engine = self.replicas[i]
            with self._lock:
                if not self._live[i]:
                    continue
            att = _Attempt(job)
            trc = job.trace
            if trc is not None:
                # the reference's attribute set: no hedge and no retry
                # exist before ROADMAP Queue 1 item 9(b)
                att.span = trc.tracer.begin(
                    trc, "attempt", cat="router",
                    attrs={"replica": i, "hedge": False, "retry": 0,
                           "requeue": job.requeues})
            try:
                self._fault("router.place")
                if att.span is not None:
                    # the engine's spans nest under THIS attempt
                    with tracing.use(trc.at(att.span[1])):
                        f = engine.submit(job.prompt, job.n_new)
                elif self._tracer is not None:
                    # sampled out (or a late re-place of a sealed
                    # trace): tell the engine the decision is made
                    with tracing.use(tracing.SAMPLED_OUT):
                        f = engine.submit(job.prompt, job.n_new)
                else:
                    f = engine.submit(job.prompt, job.n_new)
            except Overloaded as exc:
                # queue/pool pressure on this replica: the next-best may
                # still have room (a ValueError propagates at once: it
                # is the same on every replica).  Keep the SMALLEST
                # Retry-After seen: the client may come back as soon as
                # the soonest-freeing replica frees
                last_exc = exc
                if att.span is not None:
                    trc.tracer.end(att.span, error=exc)
                ra = getattr(exc, "retry_after", None)
                if ra is not None:
                    min_retry = ra if min_retry is None \
                        else min(min_retry, ra)
                continue
            except Exception as exc:
                # a client error propagates — close the span on the way
                if att.span is not None:
                    trc.tracer.end(att.span, error=exc)
                raise
            att.replica = i
            att.engine_future = f
            with self._lock:
                # re-check at COMMIT: a drain that ran between the
                # pre-submit check and here already snapshotted
                # _pending[i] without this attempt, and the client may
                # have cancelled in the same window — withdraw in
                # either case
                done = job.future.done()
                stale = done or not self._live[i]
                if not stale:
                    self._pending[i].add(att)
                    job.live.add(att)
                    self._routed[i] += 1
                    job.replica = i
            if stale:
                engine._cancel(f.request)
                if att.span is not None:
                    trc.tracer.end(att.span, attrs={"stale": True})
                if done:
                    return True      # settled — nothing left to place
                continue
            self.metrics.record_enqueue()
            self.metrics.inc("routed_requests",
                             labels={"replica": str(i)})
            f.add_done_callback(
                lambda f, att=att: self._on_attempt_done(att, f))
            return True
        self.metrics.record_reject()
        if last_exc is not None:
            if min_retry is not None:
                last_exc.retry_after = min_retry
            raise last_exc
        raise Overloaded()

    # ----------------------------------------------------------- completion
    def _on_attempt_done(self, att, engine_future):
        """Runs on the replica's worker (inside its guarded turn) or on
        a canceller's thread when an engine-side future settles.
        Exactly-once delivery: the router future is resolved here and
        only here, by the job's one claimed attempt, and a requeue fires
        only for drain fallout (``_Attempt.requeue``)."""
        job = att.job
        i = att.replica
        if att.span is not None:
            if engine_future.cancelled():
                outcome = "cancelled"
            elif engine_future.exception() is not None:
                outcome = "error"
            else:
                outcome = "ok"
            job.trace.tracer.end(
                att.span, attrs={"outcome": outcome},
                error=(engine_future.exception()
                       if outcome == "error" else None))
        with self._lock:
            # membership in job.live is the CLAIM: a drain timeout that
            # force-replaced this attempt already removed it (and owns
            # the job now) — this late resolution belongs to a zombie
            claimed = att in job.live
            self._pending[i].discard(att)
            job.live.discard(att)
            live = self._live[i]
            stopping = self._stopping
        if att.abandoned or not claimed:
            self._forget(job)
            return
        if job.future.done():            # withdrawn by the client
            self._forget(job)
            return
        requeue = att.requeue and not stopping
        if engine_future.cancelled():
            if requeue:
                # withdrawn before any decode: drain fallout replaces
                # it; a router-level cancellation stays cancelled
                self._replace(job)
            else:
                job.future.cancel()
                self._forget(job)
            return
        exc = engine_future.exception()
        if exc is not None:
            benign = isinstance(exc, (Overloaded, DeadlineExceeded))
            if (requeue or not live) and not stopping and not benign:
                # in-flight work dying WITH its drained replica (engine
                # stopped, faulted step) is the router's problem
                self._replace(job)
                return
            self._settle_exc(job, exc)
            self._forget(job)
            return
        result = engine_future.result()
        if requeue and len(result) < job.n_new:
            # the drain interrupted this lane mid-decode: the engine
            # resolved it with the tokens it had (its cancellation
            # path) — rerun the request whole on a live replica
            self._replace(job)
            return
        self._deliver(job, att, result)

    def _deliver(self, job, att, result):
        """Resolve the client future with ``att``'s result; the claim is
        taken under the router lock, so exactly one attempt stamps
        replica/version."""
        with self._lock:
            if job.delivered or job.future.done():
                return
            job.delivered = True
            # stamped BEFORE the result resolves so a waiter unblocked
            # by set_result reads the delivering attempt's stamps
            job.replica = att.replica
            job.version = getattr(att.engine_future, "version", None)
        try:
            job.future.set_result(result)
        except Exception:   # noqa: BLE001 — cancelled meanwhile
            return
        self.metrics.record_response(time.monotonic() - job.t0)
        self._forget(job)

    def _forget(self, job):
        with self._lock:
            settled = not job.live
            if settled:
                self._jobs.discard(job)
        if settled and job.own_trace and job.future.done():
            # every attempt settled AND the client future resolved:
            # the span tree is complete — seal it (idempotent)
            tracing.finish_from_future(job.trace, job.future)

    def _replace(self, job):
        """Re-place a drain-interrupted job on the surviving replicas —
        or fail it loudly when none can take it (never wedge)."""
        if job.future.done():
            # raced a router-level cancellation: nobody reads this
            # result — do not spend a healthy replica's slots on it
            self._forget(job)
            return
        job.requeues += 1
        self.metrics.inc("requeued_requests")
        if job.trace is not None:
            job.trace.tracer.instant(
                job.trace, "drain.requeue", cat="router",
                attrs={"requeue": job.requeues})
        if job.requeues > len(self.replicas) + 1:
            self._settle_exc(job, RuntimeError(
                "request could not be re-placed after %d drain retries"
                % job.requeues))
            self._forget(job)
            return
        try:
            self._place(job)
        except Exception as exc:   # noqa: BLE001 — delivered, not raised
            self._settle_exc(job, exc)
            self._forget(job)

    # --------------------------------------------------------------- client
    def generate(self, prompts, n_new, return_replicas=False,
                 return_versions=False):
        """Decode a (b, s) prompt batch across the fleet; returns
        (b, s + n_new) int32 (with ``return_replicas`` also the replica
        index that served each row, with ``return_versions`` the
        ``weights_version`` each row decoded under).  All-or-nothing
        sibling cancellation, as ``LMEngine.generate``."""
        prompts = numpy.asarray(prompts, numpy.int32)
        futures = []
        try:
            for row in prompts:
                futures.append(self.submit(row, n_new))
            news = numpy.stack([f.result() for f in futures])
        except Exception:
            for f in futures:
                self.cancel(f)
            raise
        out = numpy.concatenate([prompts, news], axis=1)
        extras = []
        if return_replicas:
            extras.append([f.job.replica for f in futures])
        if return_versions:
            extras.append([f.job.version for f in futures])
        if extras:
            return (out, *extras)
        return out

    def cancel(self, future):
        """Withdraw a routed request (sibling cancellation): every
        engine-side attempt is cancelled and the router future will NOT
        be re-placed."""
        job = future.job
        with self._lock:
            attempts = list(job.live)
        for att in attempts:
            att.requeue = False
            if att.engine_future is not None:
                self.replicas[att.replica]._cancel(
                    att.engine_future.request)
        future.cancel()
        self._forget(job)

    # ---------------------------------------------------------------- drain
    def unregister(self, i, reason="sick"):
        """Hot-unregister replica ``i``: it leaves the placement
        rotation NOW, and every request the router still has pending on
        it is withdrawn and re-placed on the surviving replicas (queued
        requests requeue unserved; a mid-decode lane is cancelled and
        its request reruns whole elsewhere — no loss, no duplicate
        completion).  The engine itself keeps running — the caller
        decides whether to stop or restart it; re-admit with
        :meth:`reregister`.  Returns the number of placements
        withdrawn."""
        with self._lock:
            if not self._live[i]:
                return 0
            self._live[i] = False
            attempts = list(self._pending[i])
            live_now = sum(1 for ok in self._live if ok)
        self.metrics.set_gauge("replicas_live", live_now)
        self.metrics.inc("replica_drains")
        if self._tracer is not None:
            self._tracer.event(
                "router.drain", cat="router",
                attrs={"replica": i, "reason": str(reason),
                       "withdrawn": len(attempts)})
        self.warning("draining replica %d (%s): re-placing %d pending "
                     "request(s) on %d live replica(s)",
                     i, reason, len(attempts), live_now)
        engine = self.replicas[i]
        for att in attempts:
            att.requeue = True
            engine._cancel(att.engine_future.request)
            if not att.engine_future.done():
                # a WEDGED engine (frozen worker, hung device call)
                # cannot resolve its side of a mid-decode withdrawal —
                # after drain_timeout_s the attempt is force-abandoned
                # and the request re-placed anyway.  If the zombie later
                # thaws, its resolution is ignored (the claim check in
                # _on_attempt_done) — exactly-once holds
                timer = threading.Timer(self.drain_timeout_s,
                                        self._force_replace, args=(att,))
                timer.daemon = True
                with self._lock:
                    if not self._stopping:
                        self._timers.add(timer)
                        timer.start()
        return len(attempts)

    def _force_replace(self, att):
        """Drain-timeout fallout: abandon a wedged attempt and re-place
        its job (see unregister)."""
        job = att.job
        with self._lock:
            self._timers = {t for t in self._timers if t.is_alive()}
            if self._stopping or att not in job.live:
                return           # settled (or settling) normally
            att.abandoned = True
            job.live.discard(att)
            self._pending[att.replica].discard(att)
        if job.future.done():
            self._forget(job)
            return
        self.metrics.inc("drain_forced_replacements")
        if att.span is not None:
            job.trace.tracer.end(att.span, error="drain-abandoned")
        self.warning("replica %d never resolved a drained request in "
                     "%.1fs: force re-placing it", att.replica,
                     self.drain_timeout_s)
        self._replace(job)

    def reregister(self, i):
        """Return a drained replica to the placement rotation (after a
        restart or recovery)."""
        with self._lock:
            self._live[i] = True
            live_now = sum(1 for ok in self._live if ok)
        self.metrics.set_gauge("replicas_live", live_now)

    # -------------------------------------------------------------- deploy
    def deploy(self, params, version=None, **kwargs):
        """Roll ``params`` across the fleet canary-first — not ported
        yet."""
        raise NotImplementedError(
            "Router.deploy is not ported yet: %s" % _DEPLOY)

    # ------------------------------------------------------------- evidence
    def routed_counts(self):
        """Requests placed per replica (including requeues) — the
        server-side balance evidence."""
        with self._lock:
            return list(self._routed)
