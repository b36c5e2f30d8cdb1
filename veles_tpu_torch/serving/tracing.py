"""End-to-end request tracing for the serving stack.

Port of ``veles_tpu/serving/tracing.py``, whole.  The serving metrics
(``serving/metrics.py``) answer aggregate questions — p95 latency,
dispatch counts, EWMAs — but not "where did THIS request's 400 ms go?".
This module is a lock-cheap SPAN TRACER threaded through the request
path: ``restful_api.py`` opens an ``http.request`` root span,
``serving/batcher.py`` and ``serving/lm_engine.py`` record queue wait,
admission, every prompt chunk, every decode/verify dispatch, copy-on-
write page copies and weight-swap applies.  A fused decode megastep
records ONE ``decode.megastep`` span per dispatch — one replay of its
captured CUDA graph (or one launch of the while program) — with a
shared dispatch id and per-lane tokens on each request's copy, so the
cost ledger counts the program once, never its folded per-token work.
Spans carry the request id and the fast-path attributes (bucket, live
width, backend — the port's kernel route: ``cuda`` on the card,
``plain`` where the kernel wrappers run their plain versions), so one
request's timeline reads end to end across threads.

Design rules (the ``faults.py`` discipline):

- UNARMED IS FREE.  Engines hold ``self._tracer = None`` by default and
  every site is one attribute-is-None check — no lock, no allocation,
  no synchronization.
- DEVICE SPANS ARE FENCED.  A CUDA launch returns before the card
  finishes, so a span that closed at return would measure enqueue, not
  execution.  The decode paths read their output back synchronously,
  and their spans close after that read; the prompt chunk, the page
  copy and the swap apply run in place and return at once, so when
  (and only when) tracing is armed and a sampled request takes part,
  the engine synchronizes the current stream before closing their
  spans.  Unarmed engines and sampled-out dispatches never fence.
- A CAPTURED GRAPH HAS NO HOST CODE.  A replay runs no Python, so no
  span site sits inside a captured body: the engine records the span
  on the host, around the replay, after its read-back.
- THE FLIGHT RECORDER IS BOUNDED.  Finished requests land in a ring
  buffer (``last`` requests), so the recent past is always
  reconstructable after the fact; a request that errors or blows its
  deadline is additionally DUMPED (waterfall text, kept in a second
  small ring and logged) the moment it finishes.
- ONE DISPATCH, ONE COST.  A batched decode tick serves many lanes; the
  tracer records the span once per PARTICIPATING request (each request's
  timeline is complete) but stamps every copy with a shared dispatch id
  (``did``) so the COST LEDGER counts the dispatch once.

Modes (``serve_lm(trace=)`` / ``--serve-trace``):

=============== ======================================================
``off``         no tracer (the default — zero overhead)
``all``         every request traced and retained in the ring
``sample:P``    a seeded coin traces fraction P of requests, decided
                once at the outermost armed layer
``errors``      every request traced, but only errored/deadline-blown
                requests are RETAINED (the ring holds exactly the
                post-mortem set)
=============== ======================================================

Consumers: ``GET /trace.json?last=N`` exports the ring as
Chrome-trace/Perfetto JSON (load at https://ui.perfetto.dev or
chrome://tracing — one track per request), ``GET /ledger.json`` serves
the live per-op cost ledger (op family x bucket x backend -> p50/p95
duration, dispatch count).

Context plumbing: the REQUEST context travels two ways.  Down a call
stack, :func:`use` binds a :class:`TraceContext` to the thread and
:func:`current` reads it back (HTTP handler -> engine submit all run on
the caller's thread).  Across threads, the context rides the request
object itself (``_Request.trace``), so the engine worker thread
attributes its dispatch spans to the right requests.  Whoever STARTED a
request's trace finishes it (``TraceContext.owns``); layers below only
add child spans.  Timestamps are ``time.monotonic()`` readings, the
clock of ``serving/metrics.py::monotonic_offset``.
"""

from __future__ import annotations

import collections
import threading
import time

import numpy

from veles_tpu_torch.logger import Logger
from veles_tpu_torch.serving import lockcheck

_tls = threading.local()


def current():
    """The calling thread's active :class:`TraceContext` (bound by
    :func:`use`), :data:`SAMPLED_OUT`, or None — how a lower serving
    layer (router, engine, batcher) joins the request its caller
    already started instead of rooting a second one."""
    return getattr(_tls, "ctx", None)


#: sentinel an outer layer binds (via :func:`use`) when ITS sampler
#: skipped the request: lower layers must not re-roll the coin —
#: without this, ``sample:P`` behind HTTP would trace ~1-(1-P)^3 of
#: traffic as partial router-/engine-rooted trees
SAMPLED_OUT = object()


def join_or_root(tracer, name, cat="request", attrs=None):
    """THE join-or-root decision every traced layer makes on its
    submit path: returns ``(ctx, own_root)`` where ``ctx`` is the
    caller's existing context (own_root False), a fresh root this
    layer now OWNS (own_root True — it must ``finish_request``), or
    :data:`SAMPLED_OUT` when the sampler — here or upstream — skipped
    the request (record nothing, but PROPAGATE the sentinel to layers
    below via :func:`use`)."""
    up = current()
    if up is not None:          # a real ctx OR the sentinel
        return up, False
    ctx = tracer.start_request(name=name, cat=cat, attrs=attrs)
    if ctx is None:
        return SAMPLED_OUT, False
    return ctx, True


class use:
    """Bind ``ctx`` as the thread's current trace context for a
    ``with`` block (restored on exit, exception or not)."""

    __slots__ = ("ctx", "_prev")

    def __init__(self, ctx):
        self.ctx = ctx

    def __enter__(self):
        self._prev = getattr(_tls, "ctx", None)
        _tls.ctx = self.ctx
        return self.ctx

    def __exit__(self, *exc):
        _tls.ctx = self._prev
        return False


class TraceContext:
    """One traced request's handle: the owning tracer, the request id,
    the root span and the parent span new child spans attach under.
    ``at(sid)`` derives a context parented at ``sid`` (the router hands
    the engine a context under the current ATTEMPT span, so engine
    spans nest per attempt).  ``owns`` marks the layer that must call
    :meth:`SpanTracer.finish_request`."""

    __slots__ = ("tracer", "rid", "root", "parent", "owns")

    def __init__(self, tracer, rid, root, parent=None, owns=False):
        self.tracer = tracer
        self.rid = rid
        self.root = root
        self.parent = parent if parent is not None else root
        self.owns = owns

    def at(self, sid):
        return TraceContext(self.tracer, self.rid, self.root,
                            parent=sid, owns=False)


class _Span:
    __slots__ = ("sid", "parent", "name", "cat", "t0", "t1", "attrs")

    def __init__(self, sid, parent, name, cat, t0, t1=None, attrs=None):
        self.sid = sid
        self.parent = parent
        self.name = name
        self.cat = cat
        self.t0 = t0
        self.t1 = t1
        self.attrs = attrs


class SpanTracer(Logger):
    """The serving stack's span recorder; see the module docstring.

    Thread-safe: every mutation is a few dict/list operations under one
    lock.  ``last`` bounds the flight recorder (finished requests),
    ``max_spans`` bounds any single request's span count (a runaway
    long decode cannot grow without bound — excess spans are counted,
    not stored), ``seed`` makes ``sample:P`` reproducible."""

    MODES = ("all", "errors", "sample")

    #: lock-discipline map: the span store is mutated from
    #: every serving thread (handlers, workers, timers) — all of it
    #: under the one tracer lock, including the seeded sampler RNG.
    _guarded_by = {
        "_sid": "_lock", "_did": "_lock", "_auto_rid": "_lock",
        "_live": "_lock", "_ring": "_lock", "_dumps": "_lock",
        "_events": "_lock", "_ledger_live": "_lock", "_rng": "_lock",
        "started": "_lock", "finished": "_lock",
        "sampled_out": "_lock", "dropped_spans": "_lock",
        "dump_count": "_lock",
    }

    def __init__(self, mode="all", sample=1.0, last=64, max_spans=4096,
                 seed=0, name="trace", clock=time.monotonic):
        if mode not in self.MODES:
            raise ValueError("trace mode %r (one of %r)"
                             % (mode, self.MODES))
        self.name = name
        self.mode = mode
        self.sample = float(sample)
        self.max_spans = int(max_spans)
        self._clock = clock
        self._origin = clock()
        self._lock = lockcheck.make_lock("tracing._lock")
        self._rng = numpy.random.RandomState(seed)
        self._sid = 0
        self._did = 0
        self._auto_rid = 0
        self._live = {}                  # rid -> building record
        self._ring = collections.deque(maxlen=int(last))
        self._dumps = collections.deque(maxlen=32)
        #: engine-scope spans with no request (weight-swap applies,
        #: router drains/deploys) — exported on their own track
        self._events = collections.deque(maxlen=512)
        #: the LIVE per-op cost ledger: maintained
        #: incrementally as device spans are recorded — same rows, same
        #: dedup-by-dispatch-id rule as :func:`cost_ledger` over the
        #: ring (asserted equal on the same trace), but O(1) to serve
        #: (``GET /ledger.json``) and unbounded in TIME: it survives
        #: ring eviction and errors-mode discards.  Memory stays
        #: bounded: exact dispatch/lane counts, quantiles over the
        #: newest ``ledger_durs`` dispatch durations per row.
        self.ledger_durs = 2048
        self._ledger_live = {}           # key -> {durs, lanes, n}
        self.started = 0
        self.finished = 0
        self.sampled_out = 0
        self.dropped_spans = 0
        self.dump_count = 0

    @classmethod
    def from_spec(cls, spec, **kw):
        """Build a tracer from the CLI/`serve_lm(trace=)` spec:
        ``None``/``False``/``0``/``'off'`` -> None (tracing disabled),
        ``True``/``'all'``/``'errors'`` -> that mode, ``'sample:P'``
        -> seeded sampling at probability P, an existing
        :class:`SpanTracer` passes through."""
        if spec is None or spec is False or spec == 0 or spec == "off":
            return None
        if isinstance(spec, SpanTracer):
            return spec
        if spec is True:
            return cls(mode="all", **kw)
        s = str(spec)
        if s.startswith("sample:"):
            return cls(mode="sample", sample=float(s.split(":", 1)[1]),
                       **kw)
        if s in ("all", "errors"):
            return cls(mode=s, **kw)
        raise ValueError(
            "trace spec %r (off|errors|all|sample:P or a SpanTracer)"
            % (spec,))

    def _now(self):
        return self._clock() - self._origin

    # ------------------------------------------------------------ recording
    def start_request(self, rid=None, name="request", cat="request",
                      attrs=None):
        """Open a request's trace; returns its (owning)
        :class:`TraceContext`, or None when the sampler skipped it —
        callers treat None exactly like tracing-off.  ``rid`` is the
        join key across layers (the HTTP ``X-Request-Id``); omitted,
        one is generated."""
        with self._lock:
            self.started += 1
            if self.mode == "sample" \
                    and self._rng.random_sample() >= self.sample:
                self.sampled_out += 1
                return None
            if rid is None:
                self._auto_rid += 1
                rid = "r%05d" % self._auto_rid
            rid = str(rid)
            if rid in self._live:       # client-reused id: keep both
                self._auto_rid += 1
                rid = "%s#%d" % (rid, self._auto_rid)
            self._sid += 1
            sid = self._sid
            self._live[rid] = {
                "rid": rid,
                "spans": {sid: _Span(sid, None, name, cat,
                                     self._now(), attrs=attrs)},
                "open": {sid},
                "root": sid,
            }
        return TraceContext(self, rid, sid, owns=True)

    def begin(self, ctx, name, cat="span", attrs=None, parent=None):
        """Open a child span under ``ctx``; returns an opaque handle
        for :meth:`end` (None when the request is gone or at its span
        cap — safe to pass back to ``end``)."""
        if ctx is None:
            return None
        with self._lock:
            rec = self._live.get(ctx.rid)
            if rec is None:
                return None
            if len(rec["spans"]) >= self.max_spans:
                self.dropped_spans += 1
                return None
            self._sid += 1
            sid = self._sid
            rec["spans"][sid] = _Span(
                sid, parent if parent is not None else ctx.parent,
                name, cat, self._now(), attrs=attrs)
            rec["open"].add(sid)
        return (ctx.rid, sid)

    def end(self, handle, attrs=None, error=None):
        """Close a span (idempotent: a handle already closed — or None
        — is a no-op, so racing completion paths cannot corrupt a
        timeline)."""
        if handle is None:
            return
        rid, sid = handle
        t1 = self._now()
        with self._lock:
            rec = self._live.get(rid)
            if rec is None:
                return
            span = rec["spans"].get(sid)
            if span is None or span.t1 is not None:
                return
            span.t1 = t1
            rec["open"].discard(sid)
            if attrs:
                span.attrs = dict(span.attrs or (), **attrs)
            if error is not None:
                span.attrs = dict(span.attrs or (),
                                  error=_err_str(error))

    def instant(self, ctx, name, cat="mark", attrs=None):
        """A zero-duration marker span (retry scheduled, prefix hit,
        swap requeue, ...)."""
        if ctx is None:
            return
        t = self._now()
        with self._lock:
            rec = self._live.get(ctx.rid)
            if rec is None or len(rec["spans"]) >= self.max_spans:
                return
            self._sid += 1
            rec["spans"][self._sid] = _Span(
                self._sid, ctx.parent, name, cat, t, t, attrs)

    def add_many(self, ctxs, name, cat, t0, t1, attrs=None,
                 each_attrs=None):
        """Record one COMPLETED span per context — the batched-dispatch
        path (one decode tick advances many lanes): each participating
        request's timeline gets the span, all copies share one
        dispatch id (``did``) so the cost ledger counts the device
        dispatch once.  ``t0``/``t1`` are raw clock readings
        (``time.monotonic()`` — the caller already timed the fenced
        dispatch).  ``each_attrs`` (same length as ``ctxs``) merges
        per-participant attributes into that context's copy ON TOP of
        the shared ``attrs`` — the decode megastep stamps
        each lane's own tokens-emitted count on a span the ledger
        still counts once.  Returns the did (None when nothing
        recorded)."""
        did = None
        recorded = 0
        t0 -= self._origin
        t1 -= self._origin
        with self._lock:
            for i, ctx in enumerate(ctxs):
                if ctx is None:
                    continue
                rec = self._live.get(ctx.rid)
                if rec is None:
                    continue
                if len(rec["spans"]) >= self.max_spans:
                    self.dropped_spans += 1
                    continue
                if did is None:
                    self._did += 1
                    did = self._did
                span_attrs = dict(attrs or (), did=did)
                if each_attrs is not None and each_attrs[i]:
                    span_attrs.update(each_attrs[i])
                self._sid += 1
                rec["spans"][self._sid] = _Span(
                    self._sid, ctx.parent, name, cat, t0, t1,
                    span_attrs)
                recorded += 1
            if recorded:
                self._ledger_note(name, attrs, t0, t1, recorded)
        return did

    def add(self, ctx, name, cat, t0, t1, attrs=None):
        """One completed span on one request (unbatched dispatches)."""
        return self.add_many((ctx,), name, cat, t0, t1, attrs)

    def _ledger_note(self, name, attrs, t0, t1, lanes):
        # caller-holds: _lock
        """Fold one recorded dispatch into the live cost ledger
        (tracer lock held).  Mirrors :func:`cost_ledger` exactly: only
        device spans (a ``backend`` attr) count, one duration per
        dispatch id (this call), ``lanes`` per recorded span copy.
        Cost: one dict lookup + a deque append — measured and bounded
        (with the telemetry sampler) by the chaos overhead leg."""
        backend = (attrs or {}).get("backend") if attrs else None
        if backend is None:
            return
        key = (name, str((attrs or {}).get("bucket", "-")),
               str(backend))
        row = self._ledger_live.get(key)
        if row is None:
            row = self._ledger_live[key] = {
                "durs": collections.deque(maxlen=self.ledger_durs),
                "lanes": 0, "dispatches": 0}
        row["durs"].append(max(0.0, t1 - t0) * 1e3)
        row["lanes"] += lanes
        row["dispatches"] += 1

    def live_ledger(self):
        """The incrementally-maintained per-op cost ledger — the same
        row shape (and, while nothing has aged past the ring or the
        per-row duration window, the same values) as
        :func:`cost_ledger` over this tracer's records, served without
        touching the flight recorder.  ``dispatches``/``lanes`` are
        exact lifetime counts; p50/p95/mean/total cover the newest
        ``ledger_durs`` dispatches per row."""
        with self._lock:
            table = {key: {"durs": list(row["durs"]),
                           "lanes": row["lanes"],
                           "dispatches": row["dispatches"]}
                     for key, row in self._ledger_live.items()}
        return _ledger_rows(table)

    def event(self, name, cat="engine", t0=None, t1=None, attrs=None):
        """An ENGINE-scope span with no owning request (weight-swap
        apply, router drain/deploy) — bounded side channel, exported on
        its own track, excluded from per-request tree checks.
        ``t0``/``t1`` are raw clock readings (``time.monotonic()``);
        omitted, the event is an instant at now."""
        now = self._now()
        t0 = now if t0 is None else t0 - self._origin
        t1 = now if t1 is None else t1 - self._origin
        with self._lock:
            self._events.append({
                "name": name, "cat": cat, "t0": t0, "t1": t1,
                "attrs": dict(attrs or ())})

    def finish_request(self, ctx, error=None, deadline=False,
                       attrs=None):
        """Close a request's trace: the root (and any span a fault path
        left open — flagged ``unclosed``) is ended, the record moves to
        the flight-recorder ring (mode ``errors`` retains only
        errored/deadline requests), and an errored or deadline-blown
        request is DUMPED (waterfall text logged + kept).  Idempotent —
        racing finishers (a timed-out caller and a late worker) cannot
        double-record.  Returns the finished record, or None when the
        request was already finished or discarded by ``errors``-mode
        retention."""
        rid = ctx.rid if isinstance(ctx, TraceContext) else str(ctx)
        t1 = self._now()
        dump = error is not None or deadline
        keep = self.mode != "errors" or dump
        with self._lock:
            rec = self._live.pop(rid, None)
            if rec is None:
                return None
            self.finished += 1
            if not keep:
                # errors-mode discard: no O(spans) record build under
                # the lock for the (common) successful case — the armed
                # decode hot path shares this lock
                return None
            unclosed = []
            root = rec["root"]
            for sid in rec["open"]:
                span = rec["spans"][sid]
                span.t1 = t1
                if sid != root:
                    span.attrs = dict(span.attrs or (), unclosed=True)
                    unclosed.append(span.name)
            if attrs:
                rspan = rec["spans"][root]
                rspan.attrs = dict(rspan.attrs or (), **attrs)
            out = {
                "rid": rid,
                "error": _err_str(error) if error is not None else None,
                "deadline_blown": bool(deadline),
                "unclosed": unclosed,
                "spans": [{"sid": s.sid, "parent": s.parent,
                           "name": s.name, "cat": s.cat,
                           "t0": s.t0, "t1": s.t1,
                           "attrs": dict(s.attrs) if s.attrs else {}}
                          for s in rec["spans"].values()],
            }
            self._ring.append(out)
            if dump:
                self.dump_count += 1
        if dump:
            # render OUTSIDE the lock: the waterfall is O(spans) string
            # work, and an error burst must not stall the armed trace
            # sites (add_many on the decode hot path) behind it
            text = format_waterfall(out)
            with self._lock:
                self._dumps.append({"rid": rid, "text": text})
            self.warning("flight recorder dump (%s):\n%s",
                         "deadline" if deadline and error is None
                         else "error", text)
        return out

    # -------------------------------------------------------------- reading
    def requests(self, last=None):
        """The flight recorder's finished requests, oldest first
        (``last`` trims to the newest N)."""
        with self._lock:
            out = list(self._ring)
        if last is not None:
            last = int(last)
            out = out[-last:] if last > 0 else []
        return out

    def find(self, rid):
        """The NEWEST finished record for ``rid`` — the after-the-fact
        reconstruction path ("what happened to request X?")."""
        with self._lock:
            for rec in reversed(self._ring):
                if rec["rid"] == rid:
                    return rec
        return None

    def dumps(self):
        """Auto-dumped waterfalls ({"rid", "text"}), newest last."""
        with self._lock:
            return list(self._dumps)

    def stats(self):
        with self._lock:
            return {"mode": self.mode, "started": self.started,
                    "finished": self.finished,
                    "sampled_out": self.sampled_out,
                    "live": len(self._live),
                    "retained": len(self._ring),
                    "dropped_spans": self.dropped_spans,
                    "dumps": self.dump_count}

    def export_chrome(self, last=None):
        """The ring (newest ``last`` requests) + engine events as a
        Chrome-trace/Perfetto JSON object — one track (tid) per
        request, engine events on tid 0, ts/dur in microseconds.  Load
        at https://ui.perfetto.dev or chrome://tracing."""
        recs = self.requests(last)
        with self._lock:
            events = list(self._events)
        out = [{"ph": "M", "pid": 1, "tid": 0, "name": "thread_name",
                "args": {"name": "engine events"}}]
        for ev in events:
            out.append({"ph": "X", "pid": 1, "tid": 0,
                        "name": ev["name"], "cat": ev["cat"],
                        "ts": round(ev["t0"] * 1e6, 1),
                        "dur": round(max(0.0, ev["t1"] - ev["t0"])
                                     * 1e6, 1),
                        "args": ev["attrs"]})
        for tid, rec in enumerate(recs, start=1):
            label = "req %s" % rec["rid"]
            if rec["error"]:
                label += " [ERROR]"
            elif rec["deadline_blown"]:
                label += " [DEADLINE]"
            # rid/error/deadline ride as structured args too — the
            # label is for humans, and a rid containing spaces must
            # not confuse trace_report's rebuild
            out.append({"ph": "M", "pid": 1, "tid": tid,
                        "name": "thread_name",
                        "args": {"name": label, "rid": rec["rid"],
                                 "error": rec["error"],
                                 "deadline_blown":
                                     rec["deadline_blown"]}})
            for sp in rec["spans"]:
                args = dict(sp["attrs"], rid=rec["rid"],
                            sid=sp["sid"], parent=sp["parent"])
                out.append({"ph": "X", "pid": 1, "tid": tid,
                            "name": sp["name"], "cat": sp["cat"],
                            "ts": round(sp["t0"] * 1e6, 1),
                            "dur": round(max(0.0, (sp["t1"] or sp["t0"])
                                         - sp["t0"]) * 1e6, 1),
                            "args": args})
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": {"tracer": self.name, "mode": self.mode,
                              "stats": self.stats()}}

    def ledger(self, last=None):
        """The per-op cost ledger over the flight recorder — see
        :func:`cost_ledger`."""
        return cost_ledger(self.requests(last))


def _err_str(error):
    if isinstance(error, BaseException):
        return "%s: %s" % (type(error).__name__, error)
    return str(error)


def finish_from_future(ctx, future):
    """Future-settlement hook for engine-/router-owned roots: finish
    the request's trace with the future's outcome (result, exception —
    deadline sheds flagged — or cancellation)."""
    error, deadline = None, False
    if future.cancelled():
        error = "cancelled"
    else:
        exc = future.exception()
        if exc is not None:
            error = exc
            from veles_tpu_torch.serving.batcher import DeadlineExceeded
            deadline = isinstance(exc, DeadlineExceeded)
    ctx.tracer.finish_request(ctx, error=error, deadline=deadline)


def verify_integrity(records):
    """Assert every finished request's span tree is sound: exactly one
    root (parent None), every parent resolves INSIDE the same request,
    every span closed with t1 >= t0, nothing flagged ``unclosed``.
    Raises AssertionError naming the first violation; returns
    ``{"requests", "spans"}`` when clean — the bench/test contract
    (a traced run whose trees do not verify is a bug, not data)."""
    total = 0
    for rec in records:
        rid = rec["rid"]
        spans = rec["spans"]
        sids = {s["sid"] for s in spans}
        roots = [s for s in spans if s["parent"] is None]
        if len(roots) != 1:
            raise AssertionError(
                "request %s has %d root spans (want exactly 1): %r"
                % (rid, len(roots), [s["name"] for s in roots]))
        if rec["unclosed"]:
            raise AssertionError(
                "request %s finished with unclosed span(s): %r"
                % (rid, rec["unclosed"]))
        for s in spans:
            if s["parent"] is not None and s["parent"] not in sids:
                raise AssertionError(
                    "request %s span %s (sid %d) is an ORPHAN: parent "
                    "%d is not in this request"
                    % (rid, s["name"], s["sid"], s["parent"]))
            if s["t1"] is None:
                raise AssertionError(
                    "request %s span %s never closed" % (rid, s["name"]))
            if s["t1"] < s["t0"]:
                raise AssertionError(
                    "request %s span %s closed before it opened"
                    % (rid, s["name"]))
            if s["attrs"].get("unclosed"):
                raise AssertionError(
                    "request %s span %s flagged unclosed"
                    % (rid, s["name"]))
        total += len(spans)
    return {"requests": len(records), "spans": total}


def _pct(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(len(sorted_vals) - 1,
                           int(q * len(sorted_vals)))]


def cost_ledger(records):
    """Aggregate DEVICE spans (those stamped with a ``backend`` attr)
    into the per-op cost table the autotuning item needs: one row per
    (op family x bucket x backend) with dispatch count and p50/p95/mean
    duration (ms).  Batched spans are deduplicated by dispatch id, so
    ``dispatches`` counts device programs launched, not lanes served
    (``lanes`` keeps the participation count)."""
    table = {}
    seen = set()
    for rec in records:
        for sp in rec["spans"]:
            attrs = sp["attrs"]
            backend = attrs.get("backend")
            if backend is None:
                continue
            key = (sp["name"], str(attrs.get("bucket", "-")),
                   str(backend))
            row = table.setdefault(key, {"durs": [], "lanes": 0})
            row["lanes"] += 1
            did = attrs.get("did")
            if did is not None and (key, did) in seen:
                continue
            if did is not None:
                seen.add((key, did))
            row["durs"].append(
                max(0.0, (sp["t1"] or sp["t0"]) - sp["t0"]) * 1e3)
    return _ledger_rows(table)


def _ledger_rows(table):
    """``{(op, bucket, backend): {durs, lanes[, dispatches]}}`` into
    the sorted ledger-row list — ONE row maker for :func:`cost_ledger`
    (record aggregation) and :meth:`SpanTracer.live_ledger` (the
    incremental ledger), so the two cannot drift in shape or
    rounding."""
    rows = []
    for (op, bucket, backend), row in table.items():
        durs = sorted(row["durs"])
        rows.append({
            "op": op, "bucket": bucket, "backend": backend,
            "dispatches": row.get("dispatches", len(durs)),
            "lanes": row["lanes"],
            "p50_ms": round(_pct(durs, 0.50), 4),
            "p95_ms": round(_pct(durs, 0.95), 4),
            "mean_ms": round(sum(durs) / len(durs), 4) if durs else 0.0,
            "total_ms": round(sum(durs), 3),
        })
    rows.sort(key=lambda r: -r["total_ms"])
    return rows


def format_waterfall(record, width=40):
    """One finished request as an indented ASCII waterfall — the
    flight-recorder dump format (and ``tools/trace_report.py``'s
    per-request view)."""
    spans = sorted(record["spans"], key=lambda s: (s["t0"], s["sid"]))
    if not spans:
        return "request %s: no spans" % record["rid"]
    t0 = min(s["t0"] for s in spans)
    t1 = max((s["t1"] if s["t1"] is not None else s["t0"])
             for s in spans)
    total = max(t1 - t0, 1e-9)
    depth = {}
    by_sid = {s["sid"]: s for s in spans}
    for s in spans:
        d, p = 0, s["parent"]
        while p is not None and p in by_sid:
            d += 1
            p = by_sid[p]["parent"]
        depth[s["sid"]] = d
    head = "request %s  (%.3f ms total%s%s)" % (
        record["rid"], total * 1e3,
        ", ERROR: %s" % record["error"] if record["error"] else "",
        ", DEADLINE BLOWN" if record["deadline_blown"] else "")
    lines = [head]
    for s in spans:
        end = s["t1"] if s["t1"] is not None else s["t0"]
        lo = int((s["t0"] - t0) / total * width)
        hi = max(lo + 1, int((end - t0) / total * width))
        bar = " " * lo + "#" * (hi - lo) + " " * (width - hi)
        attrs = s["attrs"]
        extras = " ".join(
            "%s=%s" % (k, v) for k, v in sorted(attrs.items())
            if k not in ("did",))
        lines.append("  [%s] %8.3fms %s%s%s" % (
            bar, (end - s["t0"]) * 1e3, "  " * depth[s["sid"]],
            s["name"], (" {%s}" % extras) if extras else ""))
    return "\n".join(lines)
