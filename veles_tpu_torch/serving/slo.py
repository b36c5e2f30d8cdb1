"""Declarative SLOs with multi-window error-budget burn-rate alerting.

Port of ``veles_tpu/serving/slo.py``.  An :class:`Objective` states
what the serving tier promises — availability ("99.9% of engine
dispatches succeed"), latency ("95% of TTFTs under 500 ms", "99% of
decode steps under 50 ms"), shed rate ("under 1% of admitted traffic
shed or refused") — and the :class:`SLOMonitor` continuously answers
whether the promise holds, the way production systems alert on it: as
ERROR-BUDGET BURN RATES over several windows of the
:class:`~veles_tpu_torch.serving.timeseries.TimeSeriesStore`'s rings,
not as instantaneous threshold crossings.

BURN RATE: with target ``T`` the error budget is ``1 - T``; a window
whose bad-event fraction is ``E`` burns the budget at ``E / (1-T)``×
the sustainable pace.  Burn 1.0 = exactly on budget; 10× on a 99.9%
objective means the month's budget gone in ~3 days.  The monitor
evaluates every objective over a SHORT and a LONG window (defaults 60
s / 300 s) and runs the standard multi-window state machine per
objective (gauge ``slo_state{objective=}``):

- OK (0) → WARN (1): the short window burns ≥ ``warn_burn`` (budget
  is being spent faster than sustainable — worth a look, not a page).
- WARN → PAGE (2): EVERY window burns ≥ ``page_burn`` — the long
  window confirms the burn is sustained (a lone spike that already
  passed cannot page), the short window confirms it is still
  happening (a long-ago incident cannot keep paging).  Counted on the
  transition as ``slo_pages_total``.
- PAGE/WARN → OK: the short window's burn drops below ``warn_burn``
  (the budget-relevant bleeding stopped).

A window with fewer than ``min_events`` events holds its previous
state — one failed request at 3 a.m. on an idle fleet is not a page.

ROUTER HOOK: objectives are evaluated PER SOURCE — each replica's
metrics row separately — and a replica whose objective transitions to
PAGE is reported to a health checker (``checker=``, duck-typed: any
object with ``note_slo_page(replica, reason=)`` and
``note_slo_ok(replica)``, as the fleet's ``HealthChecker`` has): the
burn counts exactly like a failed health probe, so
``fail_threshold`` consecutive paging scans quarantine the replica
through the existing circuit-breaker/drain path (exactly-once
preserved; the half-open probe re-admits it).  A burn the whole fleet
shares (every source paging) is NOT fed to the
checker — quarantining everyone is an outage, not a mitigation.

``sample_once()`` (alias ``step()``) is public and synchronous;
``serve_lm`` registers it as the store's post-tick listener so
objectives advance once per sampling window.  ``GET /slo.json``
serves :meth:`SLOMonitor.snapshot` (strict JSON, shared monotonic
``sampled_at`` stamp).

Objective file format (``serve_lm(slo=)`` / ``--serve-slo FILE``)::

    {"windows_s": [60, 300], "warn_burn": 1.0, "page_burn": 2.0,
     "objectives": [
       {"name": "availability", "kind": "availability",
        "target": 0.999},
       {"name": "ttft", "kind": "latency", "series": "ttft",
        "threshold_s": 0.5, "target": 0.95},
       {"name": "decode", "kind": "latency", "series": "decode_step",
        "threshold_s": 0.05, "target": 0.99},
       {"name": "shed", "kind": "shed_rate", "target": 0.99}]}

(for ``shed_rate`` the target is the fraction of admitted traffic
NOT shed/refused — the same "good fraction" convention as the rest.)
"""

from __future__ import annotations

import json

from veles_tpu_torch.logger import Logger
from veles_tpu_torch.serving import lockcheck
from veles_tpu_torch.serving.metrics import ServingMetrics, monotonic_offset

KINDS = ("availability", "latency", "shed_rate")


class Objective:
    """One declarative SLO; see the module docstring for semantics."""

    def __init__(self, name, kind, target, series=None,
                 threshold_s=None):
        if kind not in KINDS:
            raise ValueError("objective kind %r (one of %r)"
                             % (kind, KINDS))
        if not 0.0 < float(target) < 1.0:
            raise ValueError("target must be in (0, 1), got %r"
                             % (target,))
        if kind == "latency":
            if series not in ("ttft", "decode_step", "latency",
                              "queue_wait"):
                raise ValueError(
                    "latency objective needs series= one of ttft/"
                    "decode_step/latency/queue_wait (got %r)"
                    % (series,))
            if threshold_s is None or float(threshold_s) <= 0:
                raise ValueError("latency objective needs "
                                 "threshold_s > 0")
        self.name = str(name)
        self.kind = kind
        self.target = float(target)
        self.series = series
        self.threshold_s = (float(threshold_s)
                            if threshold_s is not None else None)

    @property
    def budget(self):
        return 1.0 - self.target

    @classmethod
    def from_dict(cls, d):
        return cls(d["name"], d["kind"], d["target"],
                   series=d.get("series"),
                   threshold_s=d.get("threshold_s"))

    def to_dict(self):
        out = {"name": self.name, "kind": self.kind,
               "target": self.target}
        if self.series is not None:
            out["series"] = self.series
        if self.threshold_s is not None:
            out["threshold_s"] = self.threshold_s
        return out

    # ------------------------------------------------------------- counting
    def events(self, store, source, window_s):
        """(bad, total) events for this objective over ``window_s`` of
        ``source``'s rings."""
        if self.kind == "availability":
            bad = store.counter_delta(
                "%s.counter.errors" % source, window_s)
            good = store.counter_delta(
                "%s.counter.responses" % source, window_s)
            return bad, bad + good
        if self.kind == "shed_rate":
            bad = (store.counter_delta("%s.counter.shed" % source,
                                       window_s)
                   + store.counter_delta(
                       "%s.counter.rejected" % source, window_s))
            total = bad + store.counter_delta(
                "%s.counter.responses" % source, window_s)
            return bad, total
        good, total = store.count_in_window(
            "%s.hist.%s" % (source, self.series), window_s,
            self.threshold_s)
        return total - good, total


#: state machine values (the ``slo_state{objective=}`` gauge)
OK, WARN, PAGE = 0, 1, 2
STATE_NAMES = {OK: "ok", WARN: "warn", PAGE: "page"}


class SLOMonitor(Logger):
    """Evaluate ``objectives`` over ``store`` (a TimeSeriesStore) per
    source; see the module docstring.  ``sources`` defaults to every
    source the store samples; ``checker`` attaches the health
    checker's page hook (``source_replicas`` maps source key →
    replica index — built automatically by ``serve_lm``)."""

    #: lock-discipline map: the state machine advances on
    #: the sampler thread while ``/slo.json`` snapshots read from
    #: handlers — state and last-eval rows move together under one
    #: lock.
    _guarded_by = {
        "_state": "_lock",
        "_last": "_lock",
        "evaluations": "_lock",
    }

    def __init__(self, store, objectives, windows_s=(60.0, 300.0),
                 warn_burn=1.0, page_burn=2.0, min_events=5,
                 sources=None, checker=None, source_replicas=None,
                 metrics=None, name="slo"):
        if not objectives:
            raise ValueError("need at least one objective")
        windows_s = tuple(sorted(float(w) for w in windows_s))
        if not windows_s or windows_s[0] <= 0:
            raise ValueError("windows_s must be positive")
        self.name = name
        self.store = store
        self.objectives = list(objectives)
        self.windows_s = windows_s
        self.warn_burn = float(warn_burn)
        self.page_burn = float(page_burn)
        self.min_events = int(min_events)
        self._sources = list(sources) if sources is not None else None
        self.checker = checker
        self.source_replicas = dict(source_replicas or {})
        self.metrics = metrics or ServingMetrics(name)
        self._lock = lockcheck.make_lock("slo._lock")
        #: (source, objective) -> state
        self._state = {}
        self._last = {}          # (source, objective) -> last eval row
        self.evaluations = 0

    # ---------------------------------------------------------- construction
    @classmethod
    def from_spec(cls, spec, store, **kw):
        """Build from a JSON file path, a parsed dict, a list of
        objective dicts, or pass an SLOMonitor through.  None/False →
        None."""
        if spec is None or spec is False:
            return None
        if isinstance(spec, SLOMonitor):
            return spec
        if isinstance(spec, str):
            with open(spec, "r", encoding="utf-8") as f:
                spec = json.load(f)
        if isinstance(spec, (list, tuple)):
            spec = {"objectives": list(spec)}
        if not isinstance(spec, dict) or "objectives" not in spec:
            raise ValueError(
                "SLO spec must be a JSON object with 'objectives' "
                "(or a list of objectives); got %r" % (spec,))
        objectives = [o if isinstance(o, Objective)
                      else Objective.from_dict(o)
                      for o in spec["objectives"]]
        for key in ("windows_s", "warn_burn", "page_burn",
                    "min_events"):
            if key in spec and key not in kw:
                kw[key] = spec[key]
        return cls(store, objectives, **kw)

    @staticmethod
    def default_objectives():
        """The stock objective set ``serve_lm(slo=True)`` arms:
        availability 99.9%, TTFT p95 < 1 s, decode-step p99 < 250 ms,
        shed under 1%% — deliberately loose defaults meant to catch
        fires, not tune latency; ship a file for real targets."""
        return [
            Objective("availability", "availability", 0.999),
            Objective("ttft", "latency", 0.95, series="ttft",
                      threshold_s=1.0),
            Objective("decode_step", "latency", 0.99,
                      series="decode_step", threshold_s=0.25),
            Objective("shed", "shed_rate", 0.99),
        ]

    # ------------------------------------------------------------ evaluation
    def _eval_sources(self):
        if self._sources is not None:
            return list(self._sources)
        return self.store.sources()

    def sample_once(self):
        """One synchronous evaluation of every (source, objective)
        pair; returns the rows.  Registered as the store's post-tick
        listener by ``serve_lm`` (and driven by hand in tests),
        so state advances once per sampling window."""
        rows = []
        paged = {}               # source -> [objective names], FRESH
        held = set()             # sources with any held (stale) row
        sources = self._eval_sources()
        for src in sources:
            for obj in self.objectives:
                row = self._eval_one(src, obj)
                rows.append(row)
                if row["state"] == PAGE:
                    if row["held"]:
                        # a PAGE carried by the min_events gate is
                        # STALE evidence (a quarantined replica serves
                        # no traffic, so its window never refills) —
                        # display it, but never re-feed the checker
                        # from it: that would re-quarantine a
                        # recovered replica forever on the same burst
                        held.add(src)
                    else:
                        paged.setdefault(src, []).append(obj.name)
                elif row["held"]:
                    held.add(src)
        with self._lock:
            self.evaluations += 1
        # the router hook: a FRESHLY-paging replica source counts
        # toward the checker's fail_threshold on its DEDICATED counter
        # — only when it is NOT the whole fleet burning (quarantining
        # every replica is an outage, not a mitigation), which also
        # keeps a solo engine un-quarantined.  Sources whose every row
        # is fresh and not paging clear their streak, so the threshold
        # means CONSECUTIVE scans of live page evidence; held (stale)
        # sources touch the streak in neither direction.
        if self.checker is not None:
            mapped = [s for s in sources if s in self.source_replicas]
            burning = [s for s in paged if s in self.source_replicas]
            feed = bool(burning) and len(burning) < len(mapped)
            for src in mapped:
                if feed and src in paged:
                    self.checker.note_slo_page(
                        self.source_replicas[src],
                        reason="slo page: %s" % ",".join(paged[src]))
                elif src not in paged and src not in held:
                    self.checker.note_slo_ok(self.source_replicas[src])
        return rows

    #: synonym — the convention every driveable loop in serving uses
    step = sample_once

    def _eval_one(self, source, obj):
        key = (source, obj.name)
        with self._lock:
            prev = self._state.get(key, OK)
        burns = {}
        short_events = None
        for w in self.windows_s:
            bad, total = obj.events(self.store, source, w)
            ratio = bad / total if total else 0.0
            burns[w] = {"window_s": w, "bad": bad, "events": total,
                        "error_ratio": round(ratio, 6),
                        "burn": round(ratio / obj.budget, 4)}
            if short_events is None:
                short_events = total
        short = burns[self.windows_s[0]]["burn"]
        hold = short_events < self.min_events
        if hold:
            state = prev             # too little evidence to move
        elif short < self.warn_burn:
            state = OK
        elif all(b["burn"] >= self.page_burn
                 for b in burns.values()):
            state = PAGE
        else:
            state = WARN
        if state != prev:
            self._transition(source, obj, prev, state)
        row = {"source": source, "objective": obj.name,
               "kind": obj.kind, "target": obj.target,
               "state": state, "state_name": STATE_NAMES[state],
               "held": hold,
               "burn_rates": list(burns.values()),
               "budget": round(obj.budget, 6)}
        if obj.threshold_s is not None:
            row["threshold_s"] = obj.threshold_s
        if obj.series is not None:
            # consumers replay the named histogram — a latency
            # objective's series must round-trip
            row["series"] = obj.series
        with self._lock:
            # the sampler thread evaluates while /slo.json snapshots
            # read — state and rows move together under the lock so a
            # reader never iterates a dict mid-insert
            self._state[key] = state
            self._last[key] = row
        return row

    def _transition(self, source, obj, prev, state):
        self.metrics.set_gauge(
            "slo_state", state,
            labels={"objective": obj.name, "source": source})
        if state == PAGE:
            self.metrics.inc("slo_pages_total")
            self.warning("SLO PAGE: %s/%s burning past %.1fx on every "
                         "window", source, obj.name, self.page_burn)
        elif state == WARN and prev == OK:
            self.metrics.inc("slo_warns_total")
            self.info("SLO warn: %s/%s short-window burn >= %.1fx",
                      source, obj.name, self.warn_burn)
        elif state == OK:
            self.metrics.inc("slo_recoveries_total")
            self.info("SLO recovered: %s/%s back under budget",
                      source, obj.name)

    # --------------------------------------------------------------- reading
    def states(self):
        """(source, objective) -> state (the gauge's source of
        truth)."""
        with self._lock:
            return dict(self._state)

    def state(self, source, objective):
        with self._lock:
            return self._state.get((source, objective), OK)

    def worst_state(self):
        with self._lock:
            return max(self._state.values(), default=OK)

    def snapshot(self):
        """The ``GET /slo.json`` payload — strict JSON, shared
        monotonic ``sampled_at`` stamp."""
        with self._lock:
            evaluations = self.evaluations
            rows = [dict(v) for v in self._last.values()]
        return {"name": self.name,
                "sampled_at": round(monotonic_offset(), 6),
                "windows_s": list(self.windows_s),
                "warn_burn": self.warn_burn,
                "page_burn": self.page_burn,
                "min_events": self.min_events,
                "evaluations": evaluations,
                "worst_state": self.worst_state(),
                "worst_state_name": STATE_NAMES[self.worst_state()],
                "pages_total": self.metrics.counter("slo_pages_total"),
                "objectives": rows}
