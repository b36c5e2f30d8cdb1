"""Continuous telemetry — a bounded time-series store over the serving
metrics.

Port of ``veles_tpu/serving/timeseries.py``.  ``serving/metrics.py``
answers "what is the value NOW" and the tracer "where did THIS
request's milliseconds go"; this module answers "how has the server
behaved over the last five minutes, and is that within objective" —
the signal SLO burn-rate alerting (``serving/slo.py``) reads.  It adds
it without touching the hot path: a :class:`TimeSeriesStore` PULLS a
snapshot of every registered
:class:`~veles_tpu_torch.serving.metrics.ServingMetrics` source on a
background cadence (default 1 s) and keeps each family in a bounded
ring of ``(t, value)`` points:

- COUNTERS (requests, errors, tokens_out, every named counter) keep
  their cumulative value per sample; :meth:`TimeSeriesStore.window`
  turns them into windowed RATES with restart-tolerant deltas (a
  counter that went backwards — a replaced engine — contributes zero,
  never a negative rate).
- GAUGES (queue_depth, slots_busy, kv_pages_free, every runtime gauge
  below) keep the sampled value; a window read returns
  last/min/max/mean.
- HISTOGRAMS (ttft, decode_step, latency, queue_wait, batch_size)
  keep (count, sum, cumulative-bucket) tuples; a window read computes
  the DELTA histogram over the window and resolves p50/p95 from the
  bucket bounds — live tail latency without retaining samples.

RUNTIME / DEVICE GAUGES ride the same store: :func:`runtime_probe`
runs at the top of every sampling tick and writes into the engine's
own ServingMetrics (so ``/metrics[.json]`` carries them too):
``compile_programs`` (the engine's captured CUDA graphs, one per live
width of the fused decode; none on the CPU) and a monotone
``compiles_total`` counter, process RSS, ``device_mem_bytes``
(``torch.cuda.memory_allocated`` on the engine's card; absent on the
CPU), live MFU from the decode FLOPs model
(:func:`decode_flops_per_token`) over :func:`peak_flops_estimate`, and
the megastep waste fraction.  The probe runs on the sampler's thread
and reads host counters and the allocator's books only: it never
synchronizes the card and never reads an engine tensor.

DISCIPLINE (the ``faults.py``/``tracing.py`` rule): the serving hot
path has ZERO telemetry sites — the store samples from its own thread,
engines never call in; the armed sampler costs one ``sample_once()``
per ``interval_s`` of wall clock.

Consumers: ``GET /timeseries.json?window=S`` (strict JSON, stamped
with the shared monotonic ``sampled_at`` offset) on the serving port
and on the ``web_status`` dashboard (:func:`set_default`), and
``serving/slo.py``'s burn rates through :meth:`TimeSeriesStore.window`.
``sample_once()`` is public and synchronous so tests drive the cadence
deterministically.
"""

from __future__ import annotations

import collections
import math
import os
import threading
import time

from veles_tpu_torch.logger import Logger
from veles_tpu_torch.serving import lockcheck
from veles_tpu_torch.serving.metrics import ServingMetrics, monotonic_offset

#: fp32 peak FLOP/s by card name: the port serves in fp32 with TF32 off
#: (``ops/functional.py``), so the MFU denominator is the fp32 FMA peak
#: (H100 SXM: 67 TFLOP/s); ``VELES_PEAK_FLOPS`` overrides it
CARD_FP32_PEAK_FLOPS = (("H100", 67e12),)
#: nominal single-core CPU matmul ceiling — keeps the MFU column
#: well-defined (and honestly tiny) on CPU runs
CPU_NOMINAL_FLOPS = 1e11


def peak_flops_estimate(device=None):
    """(peak_flops, source_label) for the MFU denominator of an engine
    on ``device`` (a ``torch.device``; None is the CPU): the env
    override wins, then the card's fp32 peak by its name
    (``torch.cuda.get_device_name``; an unknown card is given the
    H100's, and its label says so), then the CPU nominal.  The label
    rides the ``mfu_peak_flops{source=}`` gauge so a reader can tell a
    calibrated number from a nominal one."""
    env = os.environ.get("VELES_PEAK_FLOPS")
    if env:
        return float(env), "env:VELES_PEAK_FLOPS"
    if device is not None and device.type == "cuda":
        import torch
        name = torch.cuda.get_device_name(device)
        for key, peak in CARD_FP32_PEAK_FLOPS:
            if key in name:
                return peak, "cuda:%s fp32" % key
        return (CARD_FP32_PEAK_FLOPS[0][1],
                "cuda:%s (H100 fp32 assumed)" % name)
    return CPU_NOMINAL_FLOPS, "cpu:nominal"


def decode_flops_per_token(vocab, d_model, n_layers, ctx,
                           n_heads=4, kv_heads=None, d_ff=None):
    """Model FLOPs one KV-cached greedy token costs (forward only):
    the qkvo projections, FFN and head matmuls plus the two attention
    matmuls against ``ctx`` resident rows — the numerator of the live
    ``mfu_live`` gauge (matmul FLOPs only; layernorms/softmax are noise
    at these widths)."""
    kv = kv_heads or n_heads
    d_kv = d_model // n_heads * kv
    d_ff = d_ff or 4 * d_model
    proj = 2 * d_model * (2 * d_model + 2 * d_kv)      # wq, wo, wk, wv
    ffn = 4 * d_model * d_ff
    attn = 4 * ctx * d_model                           # q·K + p·V
    head = 2 * d_model * vocab
    return n_layers * (proj + ffn + attn) + head


def engine_flops_per_token(engine, ctx=None):
    """The FLOPs model read off a live :class:`LMEngine`'s param tree
    (its shapes only; ``ctx`` defaults to half the cache — the
    mid-decode nominal)."""
    params = engine.params
    embed = params["embed"]
    vocab, d_model = int(embed.shape[0]), int(embed.shape[1])
    head_dim = d_model // engine.n_heads
    blk0 = params["blocks"][0]
    kv_heads = int(blk0["attn"]["wk"].shape[1]) // head_dim
    d_ff = int(blk0["w1"].shape[1]) if "w1" in blk0 else None
    return decode_flops_per_token(
        vocab, d_model, len(params["blocks"]),
        ctx if ctx is not None else engine.max_len // 2,
        n_heads=engine.n_heads, kv_heads=kv_heads, d_ff=d_ff)


def engine_program_cache_size(engine):
    """The engine's captured CUDA graphs: one per live-width ladder
    entry of the fused decode — a scan graph (``_megastep_programs``)
    or a while program of conditional nodes (``_while_graphs``) —
    captured at ``start()``.  The per-tick path, and every program on
    the CPU, run eagerly and count nothing.  Tolerant of stand-in
    engines that carry neither attribute."""
    whiles = getattr(engine, "_while_graphs", None) or {}
    if whiles:
        return len(whiles)
    device = getattr(engine, "device", None)
    if getattr(device, "type", None) != "cuda":
        return 0
    return len(getattr(engine, "_megastep_programs", None) or {})


def _process_rss_bytes():
    """Resident set size of THIS process (bytes) — /proc on Linux,
    getrusage elsewhere; 0 when neither works."""
    try:
        with open("/proc/self/statm", "r", encoding="ascii") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except Exception:   # noqa: BLE001 — platform fallback
        pass
    try:
        import resource
        rss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return int(rss_kb) * 1024
    except Exception:   # noqa: BLE001 — best-effort gauge
        return 0


def _device_mem_bytes(engine):
    """``torch.cuda.memory_allocated`` on the engine's card (the caching
    allocator's books: a host read, no synchronization), or None for an
    engine on the CPU."""
    device = getattr(engine, "device", None)
    if getattr(device, "type", None) != "cuda":
        return None
    import torch
    return int(torch.cuda.memory_allocated(device))


def runtime_probe(engine, flops_per_token=None, peak_flops=None,
                  clock=time.monotonic):
    """A per-tick probe closure for ``engine`` writing the runtime and
    device gauges into the engine's own ServingMetrics (so they ride
    ``/metrics[.json]`` AND the store's rings):

    - ``compile_programs`` gauge — the captured CUDA graphs
      (:func:`engine_program_cache_size`) — and the monotone
      ``compiles_total`` counter (its positive deltas);
    - ``process_rss_bytes`` gauge;
    - ``device_mem_bytes`` gauge on the card (absent on the CPU);
    - ``tokens_per_s`` + ``mfu_live`` gauges — tokens_out rate between
      probes times the decode FLOPs model over the peak — and
      ``mfu_peak_flops{source=}``, the peak used and its source;
    - ``megastep_waste_frac`` gauge — wasted/lane iterations between
      probes (the fused-decode early-exit tail, live).

    Host reads only: no card synchronization, no tensor read.
    """
    if flops_per_token is None:
        try:
            flops_per_token = engine_flops_per_token(engine)
        except Exception:   # noqa: BLE001 — MFU gauge is optional
            flops_per_token = None
    peak_source = "given"
    if peak_flops is None and flops_per_token is not None:
        peak_flops, peak_source = peak_flops_estimate(
            getattr(engine, "device", None))
    state = {"t": None, "tokens": 0, "programs": 0,
             "ms_lane": 0, "ms_waste": 0}

    def probe():
        m = engine.metrics
        now = clock()
        programs = engine_program_cache_size(engine)
        m.set_gauge("compile_programs", programs)
        if programs > state["programs"]:
            m.inc("compiles_total", programs - state["programs"])
            state["programs"] = programs
        m.set_gauge("process_rss_bytes", _process_rss_bytes())
        dev = _device_mem_bytes(engine)
        if dev is not None:
            m.set_gauge("device_mem_bytes", dev)
        tokens = m.counter("tokens_out")
        if state["t"] is not None and now > state["t"]:
            rate = max(0, tokens - state["tokens"]) / (now - state["t"])
            m.set_gauge("tokens_per_s", round(rate, 3))
            if flops_per_token and peak_flops:
                m.set_gauge("mfu_live",
                            round(rate * flops_per_token / peak_flops,
                                  8))
                m.set_gauge("mfu_peak_flops", peak_flops,
                            labels={"source": peak_source})
        lane = m.counter("megastep_lane_iterations")
        waste = m.counter("megastep_wasted_iterations")
        d_lane = lane - state["ms_lane"]
        d_waste = waste - state["ms_waste"]
        if d_lane > 0:
            m.set_gauge("megastep_waste_frac",
                        round(d_waste / d_lane, 6))
        state.update(t=now, tokens=tokens, ms_lane=lane,
                     ms_waste=waste)

    return probe


def _finite(v):
    """Strict-JSON guard: NaN/Infinity become None (strict parsers
    reject them)."""
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


class _Series:
    """One bounded ring of (t, value) points.  ``kind`` fixes the
    window() semantics; histogram points hold (count, sum, cum-bucket
    tuple) and carry the bound list once."""

    __slots__ = ("kind", "points", "bounds")

    def __init__(self, kind, capacity, bounds=None):
        self.kind = kind
        self.points = collections.deque(maxlen=capacity)
        self.bounds = bounds


class TimeSeriesStore(Logger):
    """Sample registered ServingMetrics sources into bounded rings on
    a cadence; see the module docstring.  ``capacity`` bounds every
    series (default 600 points ≈ 10 min at 1 Hz); ``sample_once()`` is
    the public synchronous tick (tests, the SLO monitor's
    determinism); ``start()`` runs it every ``interval_s`` on a
    daemon thread."""

    #: lock-discipline map: the rings and wiring lists are
    #: read by endpoint snapshots and the SLO monitor while the
    #: sampler thread folds — all under ``_lock``.  The error counters
    #: (probe_errors, listener_errors) stay unguarded: they are
    #: touched only on the sampling thread (or the test driving
    #: ``sample_once()`` in its place).
    _guarded_by = {
        "_sources": "_lock", "_probes": "_lock",
        "_listeners": "_lock", "_series": "_lock",
        "samples": "_lock", "last_sample_wall_s": "_lock",
    }

    def __init__(self, interval_s=1.0, capacity=600, name="telemetry"):
        self.name = name
        self.interval_s = float(interval_s)
        if self.interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        self.capacity = int(capacity)
        if self.capacity < 2:
            raise ValueError("capacity must be >= 2 (rates need two "
                             "points)")
        self._lock = lockcheck.make_lock("timeseries._lock")
        self._sources = []               # (key, ServingMetrics)
        self._probes = []
        self._listeners = []
        self._series = {}                # name -> _Series
        self.samples = 0
        #: separate failure counters: a flaky probe at startup must
        #: never use up the LISTENER path's log budget (a dead SLO
        #: monitor with no log line would be an invisible outage)
        self.probe_errors = 0
        self.listener_errors = 0
        self.last_sample_wall_s = 0.0
        self._stop = threading.Event()
        self._thread = None

    # ------------------------------------------------------------- wiring
    def add_source(self, metrics, key=None):
        """Sample ``metrics`` (a ServingMetrics) each tick under
        ``key`` (default: its registry identity — name plus instance
        labels, so replicas keep distinct rows)."""
        if key is None:
            from veles_tpu_torch.serving.metrics import _registry_key
            key = _registry_key(metrics)
        with self._lock:
            self._sources.append((str(key), metrics))
        return self

    def add_probe(self, fn):
        """Run ``fn()`` at the top of every tick (BEFORE sources are
        sampled) — the runtime-gauge writers.  A probe that raises is
        counted (``probe_errors``) and logged once per storm, never
        fatal: telemetry must not take serving down."""
        with self._lock:
            self._probes.append(fn)
        return self

    def add_listener(self, fn):
        """Run ``fn()`` AFTER every completed tick — the SLO monitor
        rides here so objectives are evaluated once per sampling
        window over fresh points."""
        with self._lock:
            self._listeners.append(fn)
        return self

    # ------------------------------------------------------------ sampling
    def sample_once(self):
        """One synchronous tick: probes, then one snapshot per source
        folded into the rings, then listeners.  Returns the tick's
        ``sampled_at`` offset."""
        t = monotonic_offset()
        t0 = time.perf_counter()
        with self._lock:
            probes = list(self._probes)
            sources = list(self._sources)
        for fn in probes:
            try:
                fn()
            except Exception as e:   # noqa: BLE001 — never fatal
                self.probe_errors += 1
                if self.probe_errors <= 3 \
                        or self.probe_errors % 100 == 0:
                    # first few immediately, then a heartbeat — a
                    # permanent failure stays visible in the logs
                    # without flooding them
                    self.warning("telemetry probe failed (%d): %s",
                                 self.probe_errors, e)
        # the FLAT base snapshot, explicitly: a fleet's metrics may
        # embed each replica's snapshot, which the fold ignores (the
        # replicas are sources of their own)
        snaps = [(key, ServingMetrics.snapshot(m))
                 for key, m in sources]
        with self._lock:
            for key, snap in snaps:
                self._fold(key, snap, t)
            self.samples += 1
            self.last_sample_wall_s = time.perf_counter() - t0
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn()
            except Exception as e:   # noqa: BLE001 — never fatal
                self.listener_errors += 1
                if self.listener_errors <= 3 \
                        or self.listener_errors % 100 == 0:
                    self.warning("telemetry listener failed (%d): %s",
                                 self.listener_errors, e)
        return t

    def _ring(self, name, kind, bounds=None):
        # caller-holds: _lock
        s = self._series.get(name)
        if s is None:
            s = self._series[name] = _Series(kind, self.capacity,
                                             bounds)
        return s

    def _fold(self, key, snap, t):
        # caller-holds: _lock
        """One source snapshot into the rings (store lock held)."""
        for cname in ("requests", "responses", "rejected", "shed",
                      "errors", "dispatches", "rows"):
            self._ring("%s.counter.%s" % (key, cname),
                       "counter").points.append((t, snap[cname]))
        for cname, v in snap.get("counters", {}).items():
            self._ring("%s.counter.%s" % (key, cname),
                       "counter").points.append((t, v))
        for gname, v in snap.get("gauges", {}).items():
            if isinstance(v, (int, float)):
                self._ring("%s.gauge.%s" % (key, gname),
                           "gauge").points.append((t, v))
        for ename, v in snap.get("ewma", {}).items():
            self._ring("%s.ewma.%s" % (key, ename),
                       "gauge").points.append((t, v))
        for hname in ("queue_wait", "batch_size", "latency", "ttft",
                      "decode_step"):
            h = snap.get(hname)
            if not isinstance(h, dict) or "buckets" not in h:
                continue
            bounds = tuple(h["buckets"].keys())
            ring = self._ring("%s.hist.%s" % (key, hname), "hist",
                              bounds)
            sm = h["sum"]
            if not (isinstance(sm, (int, float))
                    and math.isfinite(sm)):
                # a hostile NaN observation poisons the cumulative sum
                # forever — keep the ring strict-JSON (counts/buckets
                # still work; only the sum-derived mean degrades)
                sm = 0.0
            ring.points.append(
                (t, (h["count"], sm, tuple(h["buckets"].values()))))

    # ------------------------------------------------------------- reading
    @staticmethod
    def _window_points(points, seconds, now):
        lo = now - seconds
        return [p for p in points if p[0] >= lo]

    def window(self, name, seconds):
        """Windowed read of one series over the last ``seconds``:
        counters → restart-tolerant delta + rate, gauges → last/min/
        max/mean, histograms → delta count/sum/mean + bucket-resolved
        p50/p95.  Returns None for an unknown series or a window with
        fewer than one point (counters/hists need two for a delta —
        they report zero-delta until then)."""
        now = monotonic_offset()
        with self._lock:
            s = self._series.get(name)
            if s is None:
                return None
            pts = self._window_points(s.points, seconds, now)
            kind, bounds = s.kind, s.bounds
        return self._window_stats(kind, bounds, pts)

    @classmethod
    def _window_stats(cls, kind, bounds, pts):
        """Windowed stats over an already-copied point list — ONE
        implementation for :meth:`window` and :meth:`snapshot`, so a
        snapshot's stats and its raw points always come from the SAME
        ring copy (no second lock round-trip, no torn payload)."""
        if not pts:
            return None
        span = pts[-1][0] - pts[0][0]
        if kind == "counter":
            delta = sum(max(0, b[1] - a[1])
                        for a, b in zip(pts, pts[1:]))
            return {"kind": "counter", "last": pts[-1][1],
                    "delta": delta, "span_s": round(span, 6),
                    "rate_per_s": round(delta / span, 6) if span > 0
                    else 0.0, "points": len(pts)}
        if kind == "gauge":
            vals = [p[1] for p in pts]
            return {"kind": "gauge", "last": _finite(vals[-1]),
                    "min": _finite(min(vals)),
                    "max": _finite(max(vals)),
                    "mean": _finite(sum(vals) / len(vals)),
                    "span_s": round(span, 6), "points": len(pts)}
        # histogram: delta between the window's edges (cumulative
        # counts are monotone per engine; a restart resets to a smaller
        # count — clamp like counters, pairwise)
        count = sum(max(0, b[1][0] - a[1][0])
                    for a, b in zip(pts, pts[1:]))
        total = sum(max(0.0, b[1][1] - a[1][1])
                    for a, b in zip(pts, pts[1:]))
        n_b = len(bounds)
        cum = [0] * n_b
        for a, b in zip(pts, pts[1:]):
            ca, cb = a[1][2], b[1][2]
            if len(ca) == n_b and len(cb) == n_b:
                for i in range(n_b):
                    cum[i] += max(0, cb[i] - ca[i])
        out = {"kind": "hist", "count_delta": count,
               "rate_per_s": round(count / span, 6) if span > 0
               else 0.0,
               "mean": round(total / count, 6) if count else 0.0,
               "bounds": list(bounds),
               "span_s": round(span, 6), "points": len(pts)}
        for q, label in ((0.5, "p50"), (0.95, "p95")):
            out[label] = cls._bucket_quantile(bounds, cum, count, q)
        return out

    @staticmethod
    def _bucket_quantile(bounds, cum_delta, count, q):
        """The smallest bucket bound whose cumulative delta covers
        quantile ``q`` — an upper estimate at bucket resolution.  The
        +Inf bucket reports the largest finite bound (documented as
        ">= last bound" — and keeps the payload strict-JSON: note
        ``float("+Inf")`` PARSES, so the overflow bucket must be
        detected by finiteness, not by ValueError); no events →
        0.0."""
        if not count:
            return 0.0
        want = q * count
        last_finite = 0.0
        for bound, c in zip(bounds, cum_delta):
            try:
                b = float(bound)
            except ValueError:
                b = None
            if b is not None and not math.isfinite(b):
                b = None            # the "+Inf" overflow bucket
            if b is not None:
                last_finite = b
            if c >= want:
                return b if b is not None else last_finite
        return last_finite

    def count_in_window(self, name, seconds, below_s):
        """Histogram helper for the SLO layer: (events ≤ ``below_s``,
        total events) over the window, resolved at bucket granularity
        — the good count is read at the LAST bound <= ``below_s`` (a
        threshold between bounds rounds DOWN), so bucket resolution
        can only over-alert, never hide a violation behind the next
        bound up; a threshold below every bound counts nothing as
        good."""
        now = monotonic_offset()
        with self._lock:
            s = self._series.get(name)
            if s is None or s.kind != "hist":
                return 0, 0
            pts = self._window_points(s.points, seconds, now)
            bounds = s.bounds
        if len(pts) < 2:
            return 0, 0
        n_b = len(bounds)
        cum = [0] * n_b
        count = 0
        for a, b in zip(pts, pts[1:]):
            count += max(0, b[1][0] - a[1][0])
            ca, cb = a[1][2], b[1][2]
            if len(ca) == n_b and len(cb) == n_b:
                for i in range(n_b):
                    cum[i] += max(0, cb[i] - ca[i])
        good = 0
        for bound, c in zip(bounds, cum):
            try:
                b = float(bound)    # NB "+Inf" PARSES to inf — the
            except ValueError:      # overflow bucket never qualifies
                b = math.inf        # as a finite threshold cut
            if math.isfinite(b) and b <= below_s:
                good = c            # the last bound under the cut
            else:
                break               # bounds ascend: done
        return good, count

    def counter_delta(self, name, seconds):
        """Counter helper for the SLO layer: the restart-tolerant
        delta over the window (0 for unknown series — an absent signal
        burns no budget)."""
        w = self.window(name, seconds)
        if w is None or w["kind"] != "counter":
            return 0
        return w["delta"]

    def series_names(self, prefix=None):
        with self._lock:
            names = sorted(self._series)
        if prefix:
            names = [n for n in names if n.startswith(prefix)]
        return names

    def sources(self):
        """The sampled source keys, registration order."""
        with self._lock:
            return [k for k, _ in self._sources]

    def snapshot(self, window_s=60.0, points=True):
        """The ``GET /timeseries.json`` payload: every series'
        windowed stats (plus, with ``points``, its raw points inside
        the window — counters/gauges as ``[t, v]``, histograms as
        ``[t, count, sum]``), strict-JSON, stamped with the shared
        monotonic ``sampled_at``."""
        now = monotonic_offset()
        window_s = float(window_s)
        with self._lock:
            # ONE consistent copy per series: the windowed stats and
            # the raw points below come from the same ring state (a
            # sampler tick landing mid-snapshot cannot tear them), and
            # the lock is taken once, not once per series
            rings = {n: (s.kind, s.bounds,
                         self._window_points(s.points, window_s, now))
                     for n, s in sorted(self._series.items())}
            samples = self.samples
        out = {"name": self.name,
               "sampled_at": round(now, 6),
               "interval_s": self.interval_s,
               "capacity": self.capacity,
               "window_s": window_s,
               "samples": samples,
               "series": {}}
        for n, (kind, bounds, pts) in rings.items():
            w = self._window_stats(kind, bounds, pts)
            if w is None:
                continue
            if points:
                if kind == "hist":
                    # cumulative bucket counts ride along so a
                    # captured export can recompute windowed
                    # percentiles/burns offline
                    w["series"] = [[round(t, 6), c, round(sm, 9),
                                    list(cum)]
                                   for t, (c, sm, cum) in pts]
                else:
                    w["series"] = [[round(t, 6), _finite(v)]
                                   for t, v in pts]
            out["series"][n] = w
        return out

    # ------------------------------------------------------------ lifecycle
    def start(self):
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name="telemetry-%s" % self.name)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(10.0, 2 * self.interval_s))
            self._thread = None

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception as e:   # noqa: BLE001 — sampler survives
                self.warning("telemetry sample failed: %s", e)


def telemetry_for(server, interval_s=1.0, capacity=600,
                  extra_sources=(), probes=True):
    """Build a :class:`TimeSeriesStore` wired over ``server`` — an
    :class:`LMEngine`, or a fleet exposing ``replicas`` and metrics of
    its own: one source per replica's metrics (plus the fleet's), one
    :func:`runtime_probe` per engine.  THE construction ``serve_lm``
    uses, so what ships is what is measured."""
    store = TimeSeriesStore(interval_s=interval_s, capacity=capacity)
    engines = getattr(server, "replicas", None)
    if engines is None:
        engines = [server]
    else:
        store.add_source(server.metrics)
    for e in engines:
        store.add_source(e.metrics)
        if probes:
            store.add_probe(runtime_probe(e))
    for m in extra_sources:
        store.add_source(m)
    return store


# ------------------------------------------------------------ default store
_default = None   # guarded-by: _default_lock
_default_lock = threading.Lock()


def set_default(store):
    """Publish ``store`` as the process's default telemetry store —
    ``web_status.py`` serves it at ``/timeseries.json`` so the
    dashboard and the serving port expose the same rings."""
    global _default
    with _default_lock:
        _default = store
    return store


def get_default():
    with _default_lock:
        return _default
