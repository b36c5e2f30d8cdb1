"""REST serving — HTTP JSON in, forward pass out.

Port of ``veles_tpu/restful_api.py`` (its predict path): feed JSON input
through a trained forward pass over HTTP.  stdlib http.server on a
background thread; the forward is the fused runner's eval forward (on
the workflow's device), an exported artifact's program
(:func:`serve_artifact`), or any ``forward`` callable.

Two serving modes:

- DIRECT (default) — each request runs its own forward;
- BATCHED — :meth:`RESTfulAPI.enable_batching` routes ``/predict``
  through :class:`veles_tpu_torch.serving.MicroBatcher`: concurrent
  requests coalesce into one padded power-of-two-bucket forward, a full
  queue answers HTTP 429 with ``Retry-After``, and requests queued past
  their deadline are shed with 503.

Error contract: every non-200 reply is structured JSON
(``{"error": ...}``) with a meaningful status — 400 malformed request,
404 unknown path, 413 oversized body (``max_body``, refused before the
body is parsed), 429 overload (+ integer ``Retry-After`` seconds), 500
server fault, 503 shed past deadline; a fault plan's injected HTTP
error (``faults=``, the ``http.request`` site) replies at its status
with the same structure, ``Retry-After`` on 429 and 503.  Every POST
reply carries ``X-Request-Id`` (the client's, or one minted here) and
the same id as ``request_id`` in its body.  ``GET /metrics.json``
(snapshot), ``GET /metrics`` (Prometheus text) and ``GET /status`` (a
text panel) expose the serving counters on the serving port itself.

Observability (each a no-op when not given): ``tracer=`` (a
:class:`~veles_tpu_torch.serving.tracing.SpanTracer`) opens an
``http.request`` root span per POST keyed by its request id, joined by
the batcher and engine below, and serves the flight recorder as
Chrome-trace/Perfetto JSON at ``GET /trace.json?last=N`` and the live
per-op cost ledger at ``GET /ledger.json``; ``telemetry=`` (a
:class:`~veles_tpu_torch.serving.timeseries.TimeSeriesStore`) serves
its windowed series at ``GET /timeseries.json?window=S`` (400 on a bad
window) and is stopped with the server; ``slo=`` (an
:class:`~veles_tpu_torch.serving.slo.SLOMonitor`) serves its burn
rates and states at ``GET /slo.json``.  ``/status`` shows all three.

:func:`serve_lm` serves a trained transformer workflow's token
continuation: greedy requests through the paged ``LMEngine``'s slots,
sampled ones (and every one without slots) through ``generate``.

``serve_lm(replicas=N)`` serves N engine replicas behind the fleet's
:class:`~veles_tpu_torch.serving.Router`, with its resilience layer
(``health``, ``hedge``, ``retries``) on request.  Not ported yet: the
fleet's deploy (the model directory's publisher, canaries: Queue 1 item
9(c)), ``tp`` (item 4) and the contiguous KV layout (``paged_kv=0``,
item 8) — each raises NotImplementedError naming its item.

Usage::

    api = RESTfulAPI(workflow)          # a trained StandardWorkflow
    api.start(port=0)                   # 0 → ephemeral
    ... POST {"input": [[...]]} to http://host:port/predict ...
    api.stop()
"""

from __future__ import annotations

import json
import threading
import time
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy
import torch

from veles_tpu_torch.logger import Logger

_DEPLOY = "Queue 1 item 9(c) (fleet deploy and the model manager)"
#: serve_lm's knobs not ported yet: (name, default, ROADMAP item)
SERVE_LM_UNPORTED = (
    ("tp", 0, "Queue 1 item 4 (tensor-parallel serving)"),
    ("model_dir", None, _DEPLOY),
    ("publish_interval_s", 5.0, _DEPLOY), ("canary", 1, _DEPLOY),
    ("canary_watch_s", 2.0, _DEPLOY), ("auto_rollback", True, _DEPLOY),
)


class _Server(ThreadingHTTPServer):
    """The serving socket: a listen backlog sized for a burst of
    concurrent clients.  The default of 5 overflows when more connect at
    once while the accept loop waits for the interpreter lock (a busy
    engine worker), and a host that aborts on overflow resets them."""

    request_queue_size = 128


def _retry_after(seconds):
    """RFC 9110 delta-seconds: a whole number, at least 1."""
    return "%d" % max(1, int(seconds + 0.999))


class RESTfulAPI(Logger):
    def __init__(self, workflow, normalizer=None, forward=None,
                 handler=None, metrics=None, max_body=16 << 20,
                 faults=None, tracer=None, telemetry=None, slo=None):
        self.workflow = workflow
        #: the armed fault plan: its ``http.request`` site here, its
        #: ``batcher.*`` sites through :meth:`enable_batching`
        self.faults = faults
        #: optional SpanTracer: an ``http.request`` root span a POST,
        #: ``GET /trace.json`` and ``GET /ledger.json``; also handed to
        #: the batcher of :meth:`enable_batching`
        self.tracer = tracer
        #: optional TimeSeriesStore — ``GET /timeseries.json?window=S``
        #: (stopped with the server)
        self.telemetry = telemetry
        #: optional SLOMonitor over the store — ``GET /slo.json``
        self.slo = slo
        #: optional input normalizer (a loader's fitted normalizer) applied
        #: before the forward, so clients send raw feature scale
        self.normalizer = normalizer
        self._server = None
        self._thread = None
        #: explicit forward callable (batch ndarray -> ndarray) — used by
        #: artifact serving, where there is no workflow at all
        self._forward = forward
        #: full-request handler (payload dict -> response dict); when set
        #: it replaces the predict flow entirely
        self._handler = handler
        #: serving counters (ServingMetrics) — end-to-end latency and
        #: response counts are recorded here (the batcher owns queue and
        #: dispatch facts), so sharing one instance double-counts nothing
        self.metrics = metrics
        #: request bodies beyond this are refused with 413 before parsing
        self.max_body = int(max_body)
        #: optional MicroBatcher the predict path routes through
        self.batcher = None
        #: the LM engine :func:`serve_lm` started (stopped with the
        #: server)
        self.lm_engine = None
        #: the fleet's HealthChecker (serve_lm(health=True)), stopped
        #: after the telemetry store and before the engines
        self.health_checker = None
        self.port = None

    # ------------------------------------------------------------- inference
    def _ensure_forward(self):
        if self._forward is not None:
            return self._forward
        wf = self.workflow
        runner = getattr(wf, "_fused_runner", None)
        if runner is not None:
            fn = runner.eval_forward()

            def forward(x):
                x = torch.from_numpy(numpy.ascontiguousarray(x))
                return fn(runner.state, x.to(wf.device)).cpu().numpy()
        else:
            units = wf.forwards

            def forward(x):
                h = torch.from_numpy(numpy.ascontiguousarray(x)).to(
                    wf.device)
                with torch.no_grad():
                    for unit in units:
                        entry = {}
                        if unit.has_params:
                            entry = {"w": unit.weights.devmem}
                            if unit.include_bias:
                                entry["b"] = unit.bias.devmem
                        h, _ = unit.apply_fused(h, entry, None, False)
                return h.cpu().numpy()
        self._forward = forward
        return forward

    def _infer_sample_shape(self):
        """Best-effort input sample shape (for bucket warmup): the
        loader's minibatch row shape when a workflow is attached."""
        data = getattr(getattr(self.workflow, "loader", None),
                       "minibatch_data", None)
        shape = getattr(data, "shape", None)
        return tuple(shape[1:]) if shape and len(shape) > 1 else None

    def enable_batching(self, max_batch=64, queue_depth=128,
                        batch_wait_s=0.002, deadline_s=2.0,
                        sample_shape=None, metrics=None,
                        name="predict"):
        """Route ``/predict`` through a :class:`MicroBatcher` (started
        with the server).  Call before :meth:`start`.  ``name`` labels
        this engine's metrics row — give each server its own when
        several batched servers share one process (same-name engines
        replace each other in the /metrics registry)."""
        from veles_tpu_torch.serving import MicroBatcher
        from veles_tpu_torch.serving import metrics as metrics_mod
        if sample_shape is None:
            sample_shape = self._infer_sample_shape()
        # a fresh registered instance per enable: a (re)started server
        # starts its counters at zero
        m = metrics or metrics_mod.new(name)
        self.batcher = MicroBatcher(
            self._ensure_forward(), max_batch=max_batch,
            queue_depth=queue_depth, batch_wait_s=batch_wait_s,
            deadline_s=deadline_s, sample_shape=sample_shape,
            metrics=m, name=name, faults=self.faults, tracer=self.tracer)
        self.metrics = m
        return self

    def predict(self, batch):
        x = numpy.asarray(batch, numpy.float32)
        if self.normalizer is not None:
            x = self.normalizer.apply(x)
        if self.batcher is not None:
            probs = self.batcher.submit(x)
        else:
            probs = self._ensure_forward()(x)
        return {"output": probs.tolist(),
                "argmax": probs.reshape(len(probs), -1)
                               .argmax(axis=1).tolist()}

    # ---------------------------------------------------------------- server
    def start(self, host="127.0.0.1", port=8180):
        from veles_tpu_torch.serving.batcher import (DeadlineExceeded,
                                                     Overloaded)
        from veles_tpu_torch.serving.faults import InjectedHTTPError
        api = self
        if self.batcher is not None:
            self.batcher.start()

        class Handler(BaseHTTPRequestHandler):
            def _drain(self, length, cap=64 << 20):
                """Discard an unread request body (bounded) before an
                early error reply — closing with bytes still in flight
                resets the connection and the client never sees the
                structured error it was owed."""
                left = min(length, cap)
                while left > 0:
                    chunk = self.rfile.read(min(left, 1 << 16))
                    if not chunk:
                        return
                    left -= len(chunk)

            def _send(self, code, body, content_type, headers=()):
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _reply(self, code, payload, headers=()):
                self._send(code, json.dumps(payload).encode("utf-8"),
                           "application/json", headers)

            def do_GET(self):
                split = urllib.parse.urlsplit(self.path)
                path = split.path.rstrip("/")
                query = urllib.parse.parse_qs(split.query)
                if path == "/metrics.json" and api.metrics is not None:
                    self._reply(200, api.metrics.snapshot())
                elif path == "/timeseries.json" \
                        and api.telemetry is not None:
                    # every metrics family's windowed rates, gauges and
                    # percentiles plus the raw ring points
                    try:
                        window = float(query.get("window", ["60"])[0])
                    except ValueError:
                        window = float("nan")
                    # not (window > 0) also catches NaN, which would
                    # serialize as a non-strict literal
                    if not window > 0 or window == float("inf"):
                        self._reply(400, {"error": "window must be a "
                                          "positive number of seconds"})
                        return
                    self._reply(200, api.telemetry.snapshot(
                        window_s=window))
                elif path == "/slo.json" and api.slo is not None:
                    self._reply(200, api.slo.snapshot())
                elif path == "/ledger.json" and api.tracer is not None:
                    # the live per-op cost ledger: dispatches deduplicated
                    # by dispatch id, maintained as spans are recorded
                    from veles_tpu_torch.serving.metrics import \
                        monotonic_offset
                    rows = api.tracer.live_ledger()
                    self._reply(200, {
                        "sampled_at": round(monotonic_offset(), 6),
                        "dispatches_total": sum(r["dispatches"]
                                                for r in rows),
                        "rows": rows})
                elif path == "/trace.json" and api.tracer is not None:
                    # the flight recorder as Chrome-trace/Perfetto JSON;
                    # ?last=N trims to the newest N requests
                    try:
                        last = (int(query["last"][0]) if query.get("last")
                                else None)
                    except ValueError:
                        self._reply(400, {"error": "last must be an "
                                          "integer"})
                        return
                    self._reply(200, api.tracer.export_chrome(last=last))
                elif path == "/status":
                    self._send(200, render_status(
                        metrics=api.metrics, telemetry=api.telemetry,
                        slo=api.slo, tracer=api.tracer).encode(),
                        "text/plain; charset=utf-8")
                elif path == "/metrics":
                    from veles_tpu_torch.serving import metrics as \
                        metrics_mod
                    # merge this server's instance into the registry
                    # render (one # TYPE line per family) even when a
                    # later engine evicted it from the registry
                    instances = metrics_mod.registered()
                    if api.metrics is not None \
                            and api.metrics not in instances:
                        instances.append(api.metrics)
                    self._send(200, metrics_mod.render_instances(
                        instances).encode(), "text/plain; version=0.0.4")
                else:
                    self._reply(404, {"error": "unknown path %r"
                                      % self.path})

            def do_POST(self):
                # echo the client's X-Request-Id (or mint one) on every
                # reply — success and structured error alike
                t0 = time.monotonic()
                rid = (self.headers.get("X-Request-Id") or "").strip()
                rid = rid[:64] or uuid.uuid4().hex[:16]
                ctx = None
                if api.tracer is not None:
                    ctx = api.tracer.start_request(
                        rid=rid, name="http.request", cat="http",
                        attrs={"path": self.path})
                #: set by _handle_post's DeadlineExceeded branch: a 503
                #: alone is not a deadline (an injected one is not)
                self._shed = False
                code, payload, headers = 500, {"error": "internal"}, []
                try:
                    if api.tracer is not None:
                        from veles_tpu_torch.serving import tracing
                        # ctx None: the sampler skipped this request —
                        # the sentinel keeps the layers below from
                        # rooting partial trees of their own
                        with tracing.use(ctx if ctx is not None
                                         else tracing.SAMPLED_OUT):
                            code, payload, headers = \
                                self._handle_post(t0)
                    else:
                        code, payload, headers = self._handle_post(t0)
                finally:
                    if ctx is not None:
                        # 5xx replies dump the flight recorder
                        api.tracer.finish_request(
                            ctx, error=("http %d" % code) if code >= 500
                            else None, deadline=self._shed,
                            attrs={"status": code})
                if isinstance(payload, dict):
                    payload.setdefault("request_id", rid)
                self._reply(code, payload,
                            list(headers) + [("X-Request-Id", rid)])

            def _handle_post(self, t0):
                """Run one POST; returns (code, json_payload, headers)."""
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    return 400, {"error": "malformed "
                                 "Content-Length header"}, []
                if self.path.rstrip("/") != "/predict":
                    self._drain(length)
                    return 404, {"error": "unknown path %r — POST "
                                 "/predict" % self.path}, []
                if length > api.max_body:
                    self._drain(length)
                    return 413, {
                        "error": "request body %d bytes exceeds the "
                                 "%d limit" % (length, api.max_body)}, []
                try:    # parse: malformed payloads are 400, full stop
                    payload = json.loads(self.rfile.read(length))
                    batch = payload["input"]
                except (json.JSONDecodeError, KeyError, TypeError) as e:
                    return 400, {"error": "%s: %s"
                                 % (type(e).__name__, e)}, []
                if api.faults is not None:
                    try:
                        api.faults.fire("http.request")
                    except InjectedHTTPError as e:
                        # a transient HTTP-level fault: a structured
                        # reply at the injected status, Retry-After on
                        # the retryable codes
                        headers = []
                        if e.code in (429, 503):
                            headers = [("Retry-After",
                                        _retry_after(e.retry_after))]
                        return e.code, {"error": str(e),
                                        "retry_after": e.retry_after}, \
                            headers
                try:
                    result = (api._handler(payload)
                              if api._handler is not None
                              else api.predict(batch))
                except Overloaded as e:
                    # Retry-After is integer delta-seconds (the exact
                    # float rides in the JSON body)
                    return 429, {"error": str(e),
                                 "retry_after": e.retry_after}, \
                        [("Retry-After", _retry_after(e.retry_after))]
                except DeadlineExceeded as e:
                    self._shed = True
                    return 503, {"error": str(e)}, [("Retry-After", "1")]
                except (TypeError, ValueError) as e:
                    # shape/range complaints raised while processing the
                    # payload (the batcher's shape check, a ragged or
                    # mis-sized input) are the client's error
                    return 400, {"error": "%s: %s"
                                 % (type(e).__name__, e)}, []
                except Exception as e:   # noqa: BLE001 — server fault
                    if api.metrics is not None:
                        api.metrics.record_error()
                    api.warning("request failed: %s", e)
                    return 500, {"error": "%s: %s"
                                 % (type(e).__name__, e)}, []
                if api.metrics is not None:
                    api.metrics.record_response(time.monotonic() - t0)
                return 200, result, []

            def log_message(self, fmt, *args):
                api.debug("restful: " + fmt, *args)

        self._server = _Server((host, port), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        self.port = self._server.server_address[1]
        self.info("REST serving on http://%s:%d/predict", host, self.port)
        return self

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self.telemetry is not None:
            # the sampler reads engine metrics: stop it before the
            # engine so a tick never races a teardown
            self.telemetry.stop()
        if self.batcher is not None:
            self.batcher.stop()
        if self.health_checker is not None:
            # the prober must stop BEFORE its engines do, or its next
            # probe lands on a stopped engine and counts a fake failure
            self.health_checker.stop()
            self.health_checker = None
        if self.lm_engine is not None:
            self.lm_engine.stop()


def render_status(metrics=None, telemetry=None, slo=None, tracer=None,
                  window_s=60.0):
    """The ``GET /status`` text panel: the operator's one-glance view —
    the engine's counters and live gauges, windowed rates and tail
    latency from the telemetry store, every SLO objective's state and
    burn, and the top live-ledger rows; each section only when its
    component is given.  Plain text, readable over curl."""
    from veles_tpu_torch.serving.metrics import monotonic_offset
    lines = ["veles_tpu_torch serving status",
             "sampled_at %.3fs (monotonic offset)"
             % monotonic_offset(), ""]
    if metrics is not None:
        snap = metrics.snapshot()
        lines.append("[engine %s]" % snap["name"])
        lines.append(
            "  requests %d  responses %d  errors %d  429 %d  shed %d"
            % (snap["requests"], snap["responses"], snap["errors"],
               snap["rejected"], snap["shed"]))
        g = snap["gauges"]
        lines.append(
            "  queue_depth %g  slots %g/%g  kv_pages_free %g/%g  "
            "compile_programs %g"
            % (g.get("queue_depth", 0), g.get("slots_busy", 0),
               g.get("slots_total", 0), g.get("kv_pages_free", 0),
               g.get("kv_pages_total", 0),
               g.get("compile_programs", 0)))
        lines.append(
            "  dispatches %d  mean batch %s  ewma ttft %.4fs  "
            "decode_step %.4fs  mfu_live %s"
            % (snap["dispatches"], snap["batch_size"].get("mean", "-"),
               snap["ewma"].get("ttft", 0.0),
               snap["ewma"].get("decode_step", 0.0),
               g.get("mfu_live", "-")))
        lines.append("")
    if telemetry is not None:
        lines.append("[telemetry — last %gs of %d samples @ %gs]"
                     % (window_s, telemetry.samples,
                        telemetry.interval_s))
        for key in telemetry.sources():
            rq = telemetry.window("%s.counter.responses" % key,
                                  window_s)
            er = telemetry.window("%s.counter.errors" % key, window_s)
            tt = telemetry.window("%s.hist.ttft" % key, window_s)
            ds = telemetry.window("%s.hist.decode_step" % key,
                                  window_s)
            lines.append(
                "  %-24s %7.2f resp/s  %5.2f err/s  "
                "ttft p95 %ss  step p95 %ss"
                % (key,
                   rq["rate_per_s"] if rq else 0.0,
                   er["rate_per_s"] if er else 0.0,
                   tt["p95"] if tt else "-",
                   ds["p95"] if ds else "-"))
        lines.append("")
    if slo is not None:
        snap = slo.snapshot()
        lines.append("[slo — worst state: %s, %d page(s) total]"
                     % (snap["worst_state_name"],
                        snap["pages_total"]))
        for row in snap["objectives"]:
            burns = " ".join("%gs=%.2fx" % (b["window_s"], b["burn"])
                             for b in row["burn_rates"])
            lines.append("  %-5s %-24s %-12s target %g  burn %s"
                         % (row["state_name"].upper(), row["source"],
                            row["objective"], row["target"], burns))
        lines.append("")
    if tracer is not None:
        rows = tracer.live_ledger()
        lines.append("[cost ledger — %d dispatch(es), top rows]"
                     % sum(r["dispatches"] for r in rows))
        for r in rows[:8]:
            lines.append(
                "  %-18s bucket %-6s %-8s n=%-7d p50 %8.3fms  "
                "p95 %8.3fms  total %10.1fms"
                % (r["op"], r["bucket"], r["backend"],
                   r["dispatches"], r["p50_ms"], r["p95_ms"],
                   r["total_ms"]))
        lines.append("")
    return "\n".join(lines) + "\n"


def serve_lm(workflow, host="127.0.0.1", port=8180, max_new=256,
             slots=0, queue_depth=64, deadline_s=30.0,
             prefix_cache=0, prefill_chunk=0, spec_k=0,
             queue_tokens=0, paged_kv=True, megastep=0, tp=0, replicas=1,
             router="metrics", health=False, health_interval_s=1.0,
             hedge=0.0, retries=0, fault_plan=None, model_dir=None,
             publish_interval_s=5.0, canary=1, canary_watch_s=2.0,
             auto_rollback=True, trace=None, trace_last=256,
             telemetry=0.0, slo=None):
    """Serve a trained transformer-trainer workflow (e.g. char_lm) for
    autoregressive continuation: POST ``{"input": [[tok, ...]],
    "n_new": N, "temperature": T, "top_k": K, "seed": S}`` to
    ``/predict`` returns ``{"tokens": [[...]]}`` — prompt plus
    continuation per row.  The model runs on the trainer's device.

    ``slots > 0`` starts a paged :class:`veles_tpu_torch.serving.
    LMEngine` (``queue_depth``, ``deadline_s``, ``prefix_cache``,
    ``prefill_chunk``, ``spec_k``, ``queue_tokens``, ``megastep``, and
    ``paged_kv``: True sizes the pool to every slot's full span, an int
    sets its pages) and routes GREEDY requests (temperature 0, the
    default) through it: concurrent prompts decode side by side, each
    gets its exact ``n_new``, equal to the direct path's tokens, and
    the reply carries a per-row ``"weights_version"``.  A prompt too
    close to the cache cap for ``spec_k``'s headroom, every sampled
    request, and every request when ``slots`` is 0 take the DIRECT
    path: one ``generate`` a request (sampled under ``PRNGKey(seed)``),
    ``n_new`` rounded up to a tier (8, 32, 128, ``max_new``) and the
    prompt right-padded to a power of two with ``true_len``, as the
    reference bounds its compiles.  ``n_new`` 0 echoes the prompt; a
    prompt with no room to decode is a 400.

    ``replicas > 1`` (engine path) builds one engine a replica, each on
    its device from :func:`~veles_tpu_torch.serving.
    replica_device_slices` over the trainer's device kind (every visible
    card, or the CPU), named ``lm_r{i}`` with its metrics under the
    ``lm`` family labelled ``{replica="i"}``, each owning its copy of
    the weights, behind a :class:`~veles_tpu_torch.serving.Router`
    (``router``: ``"metrics"`` or ``"round_robin"`` placement) whose
    :class:`~veles_tpu_torch.serving.RouterMetrics` serve
    ``/metrics.json`` with every replica's snapshot; greedy replies then
    carry a per-row ``"replicas"`` list beside ``"weights_version"``.

    The fleet's resilience layer (engine path): ``retries=N`` re-places
    a request whose attempt faulted on a live replica on another one,
    up to N times, after a seeded exponential backoff; ``hedge=T``
    duplicates a request outstanding past ``T`` seconds (``T < 0``: 1.5×
    the live latency p95) on a second replica, the first to finish
    wins and the loser is cancelled; ``health=True`` starts a
    :class:`~veles_tpu_torch.serving.HealthChecker` every
    ``health_interval_s`` (probe timeout ``max(5, deadline_s / 2)``)
    that quarantines a wedged or failing replica and re-admits it
    through a half-open probe, served as ``replica_health_state`` and
    ``api.health_checker``; with ``slo`` the monitor's page signals
    feed it.  Any of the three wraps even one engine in a ``Router``
    (the engine keeps the name ``lm`` and no replica label).

    ``fault_plan`` (a :class:`veles_tpu_torch.serving.FaultPlan`, the
    CLI's ``--fault-plan FILE``) arms the engines' ``engine.*`` sites,
    the router's ``router.place`` and the server's ``http.request``
    site.

    ``trace`` (``"off"``/None, ``"all"``, ``"errors"``, ``"sample:P"``
    or a :class:`~veles_tpu_torch.serving.SpanTracer`; the CLI's
    ``--serve-trace``) arms a span tracer through the HTTP root, the
    engine's queue, prompt chunks, copies and decode dispatches (one
    span a captured-graph replay); the last ``trace_last`` finished
    requests stay in its flight recorder, served at ``GET
    /trace.json?last=N`` (Chrome-trace/Perfetto JSON) with the live cost
    ledger at ``GET /ledger.json``.  ``telemetry=S`` (engine path; True
    is 1 s) samples the engine's metrics every ``S`` seconds into a
    :class:`~veles_tpu_torch.serving.TimeSeriesStore` with the runtime
    probe (captured graphs, RSS, card memory, tokens/s, MFU), served at
    ``GET /timeseries.json?window=S`` and published as the process's
    default store (``web_status``'s ``/timeseries.json``); ``slo`` (a
    JSON objective file, a parsed spec, or True for the stock
    objectives) arms an :class:`~veles_tpu_torch.serving.SLOMonitor` on
    the store's tick, served at ``GET /slo.json``, and implies
    ``telemetry`` (1 s).  ``stop()`` stops the store, then the health
    checker, then the engines.

    Not ported yet, each raising NotImplementedError naming its ROADMAP
    item (:data:`SERVE_LM_UNPORTED`): ``tp``; the fleet's deploy
    (``model_dir``, ``publish_interval_s``, ``canary``,
    ``canary_watch_s``, ``auto_rollback``); and ``paged_kv=0``.  The
    reference's ``attn_kernel`` is not a keyword here: the port has one
    attention route, the kernels."""
    given = dict(tp=tp, model_dir=model_dir,
                 publish_interval_s=publish_interval_s, canary=canary,
                 canary_watch_s=canary_watch_s,
                 auto_rollback=auto_rollback)
    for knob, default, item in SERVE_LM_UNPORTED:
        if given[knob] != default:
            raise NotImplementedError(
                "serve_lm(%s=) is not ported yet: ROADMAP %s"
                % (knob, item))
    if slots > 0 and paged_kv is not True and int(paged_kv) == 0:
        raise NotImplementedError(
            "serve_lm(paged_kv=0) — the contiguous KV layout — is not "
            "ported yet: ROADMAP Queue 1 item 8 (contiguous KV layout)")
    from veles_tpu_torch.ops.transformer import (tree_leaves,
                                                 trainer_sample_tokens)
    trainer = workflow.trainer
    # marshalled once: the weights are frozen while serving
    params = trainer._to_portable(trainer.params)
    device = tree_leaves(params)[0].device
    cache_len = int(trainer.max_len)
    # a geometric ladder bounds the direct path's decode overshoot (at
    # most 4x the request's n_new)
    tiers = sorted({t for t in (8, 32, 128, max_new) if t <= max_new})
    from veles_tpu_torch.serving.tracing import SpanTracer
    tracer = SpanTracer.from_spec(trace, last=int(trace_last))
    engine = None
    checker = None
    routed = False
    if slots > 0:
        from veles_tpu_torch.serving import (HealthChecker, LMEngine, Router,
                                             RouterMetrics,
                                             replica_device_slices)
        from veles_tpu_torch.serving import metrics as metrics_mod
        n_rep = max(1, int(replicas))
        # the resilience layer lives on the Router: one replica wraps in
        # the degenerate router when health, hedge or retries is asked
        resilient = bool(health) or bool(hedge) or int(retries) > 0
        # every visible card, or the trainer's CPU
        slices = (replica_device_slices(
            n_rep, 0, devices=None if device.type == "cuda" else [device])
            if n_rep > 1 else None)

        def build_engine(i=None):
            """One engine: replica ``i`` on its device slice, its metrics
            a ``{replica="i"}`` row of the shared ``lm`` family; each
            engine owns its copy of the weights (``_owned_tree``)."""
            dev, label, eng_name = device, None, "lm"
            if i is not None:
                dev, label, eng_name = (slices[i][0], {"replica": str(i)},
                                        "lm_r%d" % i)
            return LMEngine(
                params, n_heads=trainer.n_heads, max_len=cache_len,
                slots=slots, rope=getattr(trainer, "rope", False),
                window=getattr(trainer, "window", None),
                sinks=getattr(trainer, "attn_sinks", 0),
                queue_depth=queue_depth, deadline_s=deadline_s,
                prefix_cache=prefix_cache, prefill_chunk=prefill_chunk,
                spec_k=spec_k, queue_tokens=queue_tokens,
                paged_kv=paged_kv, megastep=megastep, name=eng_name,
                metrics=metrics_mod.new("lm", labels=label),
                faults=fault_plan, tracer=tracer, device=dev)

        if n_rep > 1 or resilient:
            routed = True
            engine = Router(
                [build_engine(i if n_rep > 1 else None)
                 for i in range(n_rep)],
                metrics=metrics_mod.register(RouterMetrics("lm_router")),
                policy=router, retries=int(retries),
                hedge_after_s=float(hedge or 0.0),
                faults=fault_plan, tracer=tracer).start()
            if health:
                checker = HealthChecker(
                    engine, interval_s=float(health_interval_s),
                    probe_timeout_s=max(5.0, deadline_s / 2)).start()
        else:
            engine = build_engine().start()
        if slo and not telemetry:
            telemetry = 1.0         # objectives need the store
    store = monitor = None
    if engine is not None and telemetry:
        from veles_tpu_torch.serving import timeseries as ts_mod
        from veles_tpu_torch.serving.metrics import _registry_key
        from veles_tpu_torch.serving.slo import SLOMonitor
        interval = 1.0 if telemetry is True else float(telemetry)
        store = ts_mod.telemetry_for(engine, interval_s=interval)
        if slo:
            # the SLO gauges and counters land in the router's (or the
            # lone engine's) own family, so /metrics carries slo_state
            # too; a page on one replica feeds the health checker
            kw = dict(checker=checker, source_replicas={
                _registry_key(e.metrics): i for i, e in
                enumerate(getattr(engine, "replicas", [engine]))},
                metrics=engine.metrics)
            monitor = (SLOMonitor(store, SLOMonitor.default_objectives(),
                                  **kw) if slo is True
                       else SLOMonitor.from_spec(slo, store, **kw))
            # one evaluation per sampling window, on the store's tick
            store.add_listener(monitor.sample_once)
        ts_mod.set_default(store)
        store.start()

    def handler(request):
        prompt = numpy.asarray(request["input"], numpy.int32)
        want = min(int(request.get("n_new", 32)), max_new)
        if want < 1:        # n_new 0: an echo / validation probe
            return {"tokens": prompt.tolist()}
        s_true = prompt.shape[1]
        headroom = cache_len - s_true
        if headroom < 1:
            raise ValueError("prompt length %d leaves no room to decode "
                             "(max_len %d)" % (s_true, cache_len))
        temperature = float(request.get("temperature", 0.0))
        # a verify writes spec_k positions past the committed front: a
        # prompt too near the cap takes the direct path instead
        eng_headroom = headroom - (engine.spec_k if engine is not None
                                   else 0)
        if engine is not None and temperature == 0.0 \
                and eng_headroom >= 1:
            if routed:
                # per-row replica ids beside the weights_version stamps:
                # the client-side balance evidence
                toks, reps, vers = engine.generate(
                    prompt, min(want, eng_headroom), return_replicas=True,
                    return_versions=True)
                return {"tokens": toks.tolist(), "replicas": reps,
                        "weights_version": vers}
            toks, vers = engine.generate(prompt, min(want, eng_headroom),
                                         return_versions=True)
            return {"tokens": toks.tolist(), "weights_version": vers}
        # decode length: the request rounded UP to a tier; near the cap
        # the largest tier that fits (or the exact headroom)
        run = next((t for t in tiers if t >= want), tiers[-1])
        if run > headroom:
            fitting = [t for t in tiers if t <= headroom]
            run = fitting[-1] if fitting else headroom
        # prompt bucket: the next power of two that still fits the cache;
        # true_len keeps decoding exact
        bucket = 16
        while bucket < s_true:
            bucket *= 2
        bucket = min(bucket, cache_len - run)
        if bucket > s_true:
            prompt = numpy.pad(prompt, ((0, 0), (0, bucket - s_true)))
        top_k = request.get("top_k")
        out = trainer_sample_tokens(
            trainer, prompt, n_new=run, temperature=temperature,
            seed=int(request.get("seed", 0)), params=params,
            max_len=cache_len,
            top_k=int(top_k) if top_k is not None else None,
            true_len=s_true)
        # the continuation lands after the PADDED width: reply with the
        # true prompt plus min(want, run) new tokens
        new = out[:, prompt.shape[1]:prompt.shape[1] + min(want, run)]
        return {"tokens": numpy.concatenate(
            [out[:, :s_true], new], axis=1).tolist()}

    api = RESTfulAPI(None, handler=handler,
                     metrics=engine.metrics if engine is not None else None,
                     faults=fault_plan, tracer=tracer, telemetry=store,
                     slo=monitor)
    api.lm_engine = engine
    api.health_checker = checker
    return api.start(host=host, port=port)


def serve_artifact(path, host="127.0.0.1", port=8180, max_batch=0,
                   device=None):
    """Serve an export artifact (``veles_tpu_torch.export``) without
    constructing any training workflow: load weights and program, start
    HTTP.  ``device`` None means the CUDA card (raising without one).
    ``max_batch > 0`` coalesces concurrent requests through the
    micro-batcher (the artifact's dynamic batch takes every bucket)."""
    from veles_tpu_torch.export import load_model
    model = load_model(path, device=device)
    api = RESTfulAPI(None, forward=model.predict)
    if max_batch > 0:
        api.enable_batching(
            max_batch=max_batch,
            sample_shape=tuple(model.manifest["input_sample_shape"]))
    return api.start(host=host, port=port)


def serve_snapshot(path, host="127.0.0.1", port=8180, build=None):
    """Restore a snapshot into a rebuilt workflow and serve it.

    ``build`` is a zero-arg callable returning the (initialized) workflow —
    usually a sample's ``build`` + ``initialize``; the snapshot then
    restores the trained weights."""
    from veles_tpu_torch import snapshotter
    wf = build()
    snapshotter.restore(wf, path)
    return RESTfulAPI(wf).start(host=host, port=port)
