"""The port's request tracing (``serving/tracing.py`` and its spans in the
engine, the micro-batcher and the REST server) against the reference on
the CPU.

- Twins of ``tests/test_tracing.py``: the span tracer alone (the tree,
  the ring, the waterfall, the modes, ``from_spec``, unclosed and orphan
  spans caught, the ledger's dispatch dedup, ``max_spans``), the traced
  engine (the fast path's Chrome export, the flight recorder rebuilding
  a faulted request, an untraced engine unchanged), HTTP tracing (the
  request id echoed, ``/trace.json``, the id stamped without a tracer)
  and the review-hardening cases that need no router (the sample coin
  tossed once across layers, ``requests(last=0)`` empty, an injected
  503 not a deadline, a batcher dispatch fault leaving sound trees).
- PARITY: one small engine (2 layers, d 32, vocab 64, 4 slots, page 4)
  serves the same seeded prompts in both packages under
  ``SpanTracer("all")`` — with a prefix cache, with ``spec_k`` 2, the
  scan megastep at K = 4 and the while megastep with a ring of 2 — every
  request queued before the loops' first turn, so the schedule is fixed
  by the loop: the tokens are EQUAL, each request's ordered
  ``(name, cat, attributes)`` are EQUAL (durations and ``wait_s`` aside;
  ``backend`` present on the same spans, its value each package's own
  route: ``plain`` here, ``xla`` there), the two cost ledgers' keys up
  to the backend and their dispatch and lane counts are EQUAL, and the
  port's Chrome export, rebuilt by the reference's
  ``tools/trace_report.py``, passes the reference's ``verify_integrity``.
  One scripted span sequence gives both tracers the same records and
  exports, timings aside.

Left to the fleet (ROADMAP Queue 1 item 9: the router, its health
checker and hedging) and to tensor-parallel serving (item 4): the
reference's ``TestRouterTracing::test_retry_shows_both_attempts``,
``TestReviewHardening::test_hedge_loser_spans_closed_under_upstream_root``
and ``TestEngineTracing::test_tp_traced_acceptance_combo``; the
sampled-once case runs here across the HTTP layer and the engine.
"""

import json
import os
import sys
import time
import urllib.error
import urllib.request

import numpy
import pytest
import torch

from veles_tpu.serving import tracing as jtracing
from veles_tpu.serving.lm_engine import LMEngine as JaxLMEngine
from veles_tpu_torch import prng
from veles_tpu_torch.ops.transformer import init_transformer_params
from veles_tpu_torch.restful_api import RESTfulAPI
from veles_tpu_torch.serving import (FaultPlan, LMEngine, MicroBatcher,
                                     tracing)
from veles_tpu_torch.serving.tracing import (SpanTracer, cost_ledger,
                                             format_waterfall,
                                             verify_integrity)
from torch_witness import port_witness  # noqa: F401

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

VOCAB, D_MODEL, N_HEADS, N_LAYERS, PAGE, SLOTS = 64, 32, 4, 2, 4, 4
MAX_LEN, N_NEW = 48, 8

_rng = numpy.random.RandomState(25)
_SHARED = _rng.randint(0, VOCAB, 8).tolist()                # 2 full pages
#: 7 prompts through 4 slots: two sharing a 2-page prefix (a late hit for
#: the second), a repetitive one (drafts lock on), an exact repeat, and
#: short ones
PROMPTS = [
    _SHARED + _rng.randint(0, VOCAB, 3).tolist(),
    _SHARED + [3, 1, 4, 1] * 3,
    [5, 1] * 5,
    _rng.randint(0, VOCAB, 2).tolist(),
    _SHARED + _rng.randint(0, VOCAB, 6).tolist(),
    _SHARED + [3, 1, 4, 1] * 3,
    _rng.randint(0, VOCAB, 13).tolist(),
]
#: the engine paths held to the reference, span for span
PATHS = {
    "prefix": {"prefix_cache": 32},
    "spec_k2": {"spec_k": 2},
    "scan_k4": {"megastep": 4, "prefix_cache": 32},
    "while_ring2": {"megastep": 8, "megastep_mode": "while",
                    "refill_ring": 2},
}
#: attributes that are durations, not discrete facts
TIMED = ("wait_s", "quiesce_s")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def host():
    prng.reset()
    return init_transformer_params(prng.RandomGenerator("init", 25), VOCAB,
                                   d_model=D_MODEL, n_heads=N_HEADS,
                                   n_layers=N_LAYERS, max_len=MAX_LEN)


def _port(host, tracer=None, **knobs):
    return LMEngine(host, N_HEADS, MAX_LEN, slots=SLOTS, prefill_chunk=PAGE,
                    device="cpu", tracer=tracer, **knobs)


def _held(engine, prompts, n_new=N_NEW):
    """Start ``engine`` with every prompt queued before its loop's first
    turn; returns the outputs (the engine stopped)."""
    with engine._cond:
        engine.start()
        futures = [engine.submit(p, n_new) for p in prompts]
    try:
        return [f.result(timeout=120) for f in futures], futures
    finally:
        engine.stop()


def _get(port, path):
    try:
        with urllib.request.urlopen("http://127.0.0.1:%d%s" % (port, path),
                                    timeout=30) as r:
            return r.status, r.read(), r.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers


def _post(port, payload, rid=None, path="/predict"):
    headers = {"Content-Type": "application/json"}
    if rid:
        headers["X-Request-Id"] = rid
    req = urllib.request.Request("http://127.0.0.1:%d%s" % (port, path),
                                 data=json.dumps(payload).encode(),
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read()), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


# ---------------------------------------------------------------- the tracer
class TestSpanTracer:
    def test_span_tree_ring_and_waterfall(self):
        tr = SpanTracer(mode="all", last=2)
        ctx = tr.start_request(rid="abc", name="http.request", cat="http")
        h = tr.begin(ctx, "queue.wait", cat="queue")
        tr.end(h, attrs={"wait_s": 0.001})
        h2 = tr.begin(ctx, "attempt", cat="router", attrs={"replica": 0})
        child = ctx.at(h2[1])
        t = time.monotonic()
        tr.add_many([child], "decode.step", "decode", t, t + 0.002,
                    attrs={"backend": "cuda", "bucket": 4})
        tr.end(h2)
        rec = tr.finish_request(ctx)
        assert rec["rid"] == "abc" and rec["error"] is None
        assert verify_integrity([rec])["spans"] == 4
        step = next(s for s in rec["spans"] if s["name"] == "decode.step")
        assert step["parent"] == h2[1]
        text = format_waterfall(rec)
        assert "http.request" in text and "decode.step" in text
        for i in range(2):
            tr.finish_request(tr.start_request(rid="r%d" % i))
        assert [r["rid"] for r in tr.requests()] == ["r0", "r1"]
        assert tr.find("abc") is None and tr.find("r1") is not None

    def test_modes_errors_and_sampling(self):
        tr = SpanTracer(mode="errors")
        tr.finish_request(tr.start_request())
        bad = tr.start_request()
        tr.finish_request(bad, error=RuntimeError("boom"))
        recs = tr.requests()
        assert len(recs) == 1 and "boom" in recs[0]["error"]
        assert len(tr.dumps()) == 1 and tr.dumps()[0]["text"]
        shed = tr.start_request()
        tr.finish_request(shed, deadline=True)
        assert tr.requests()[-1]["deadline_blown"]
        assert len(tr.dumps()) == 2
        none = SpanTracer(mode="sample", sample=0.0)
        assert none.start_request() is None
        assert none.stats()["sampled_out"] == 1
        assert SpanTracer(mode="sample", sample=1.0).start_request() \
            is not None

    def test_from_spec(self):
        assert SpanTracer.from_spec(None) is None
        assert SpanTracer.from_spec("off") is None
        assert SpanTracer.from_spec(False) is None
        assert SpanTracer.from_spec("all").mode == "all"
        assert SpanTracer.from_spec(True).mode == "all"
        assert SpanTracer.from_spec("errors").mode == "errors"
        s = SpanTracer.from_spec("sample:0.25")
        assert s.mode == "sample" and s.sample == 0.25
        t = SpanTracer(mode="all")
        assert SpanTracer.from_spec(t) is t
        with pytest.raises(ValueError):
            SpanTracer.from_spec("sometimes")

    def test_unclosed_span_flagged_and_caught(self):
        tr = SpanTracer(mode="all")
        ctx = tr.start_request()
        tr.begin(ctx, "leaky")
        rec = tr.finish_request(ctx)
        assert rec["unclosed"] == ["leaky"]
        with pytest.raises(AssertionError, match="unclosed"):
            verify_integrity([rec])
        orphan = {"rid": "x", "error": None, "deadline_blown": False,
                  "unclosed": [],
                  "spans": [{"sid": 1, "parent": None, "name": "root",
                             "cat": "r", "t0": 0.0, "t1": 1.0, "attrs": {}},
                            {"sid": 2, "parent": 99, "name": "lost",
                             "cat": "s", "t0": 0.0, "t1": 1.0,
                             "attrs": {}}]}
        with pytest.raises(AssertionError, match="ORPHAN"):
            verify_integrity([orphan])

    def test_ledger_dedups_batched_dispatches(self):
        tr = SpanTracer(mode="all")
        a, b = tr.start_request(), tr.start_request()
        t = time.monotonic()
        tr.add_many([a, b], "decode.step", "decode", t, t + 0.004,
                    attrs={"backend": "cuda", "bucket": 2})
        tr.add_many([a], "decode.step", "decode", t, t + 0.002,
                    attrs={"backend": "cuda", "bucket": 2})
        rows = cost_ledger([tr.finish_request(a), tr.finish_request(b)])
        assert len(rows) == 1
        assert rows[0]["dispatches"] == 2 and rows[0]["lanes"] == 3
        assert cost_ledger([{"rid": "x", "spans": [
            {"sid": 1, "parent": None, "name": "queue.wait",
             "cat": "queue", "t0": 0.0, "t1": 1.0, "attrs": {}}],
            "error": None, "deadline_blown": False, "unclosed": []}]) == []

    def test_max_spans_bounds_a_request(self):
        tr = SpanTracer(mode="all", max_spans=4)
        ctx = tr.start_request()
        handles = [tr.begin(ctx, "s%d" % i) for i in range(6)]
        assert sum(1 for h in handles if h is not None) == 3
        for h in handles:
            tr.end(h)
        assert len(tr.finish_request(ctx)["spans"]) == 4
        assert tr.stats()["dropped_spans"] == 3

    def test_scripted_sequence_equals_the_reference(self):
        """One scripted sequence of calls on a stepped clock: the two
        tracers keep the same records, stats, ledgers and exports."""
        outs = []
        for mod in (tracing, jtracing):
            clock = iter(numpy.arange(0.0, 100.0, 0.125)).__next__
            tr = mod.SpanTracer(mode="errors", last=4, max_spans=6,
                                clock=clock)
            kept = []
            for i in range(3):
                ctx = tr.start_request(rid="q%d" % i, name="http.request",
                                       cat="http")
                h = tr.begin(ctx, "queue.wait", cat="queue")
                tr.end(h, attrs={"wait_s": 0.5})
                tr.instant(ctx, "prefix.hit", cat="prefill",
                           attrs={"chunks": i})
                tr.add_many([ctx, None], "decode.step", "decode", 1.0,
                            1.5 + i, attrs={"backend": "b", "bucket": 2},
                            each_attrs=[{"lane_tokens": i}, None])
                tr.begin(ctx, "leaky")
                kept.append(tr.finish_request(
                    ctx, error=None if i == 1 else "boom%d" % i))
            tr.event("swap.apply", cat="swap", t0=0.0,
                     attrs={"version": 1})
            chrome = tr.export_chrome()
            chrome["traceEvents"] = [e for e in chrome["traceEvents"]
                                     if e["name"] != "swap.apply"]
            outs.append((kept, tr.stats(), tr.ledger(), tr.live_ledger(),
                         chrome["traceEvents"], tr.dumps()))
        assert outs[0] == outs[1]


# ---------------------------------------------------------------- the engine
class TestEngineTracing:
    def test_full_fastpath_traced_chrome_export(self, host):
        """prefix_cache + page chunks + spec_k, traced: the tokens the
        untraced engine's, every tree sound, a strict Chrome export with
        rid/sid/parent on every span, the ledger populated and deduped."""
        knobs = dict(prefix_cache=32, spec_k=2)
        want, _ = _held(_port(host, **knobs), PROMPTS[:3])
        tracer = SpanTracer(mode="all", last=16)
        got, _ = _held(_port(host, tracer, **knobs), PROMPTS[:3])
        for a, b in zip(got, want):
            numpy.testing.assert_array_equal(a, b)
        recs = tracer.requests()
        assert verify_integrity(recs)["requests"] == 3
        names = {s["name"] for r in recs for s in r["spans"]}
        assert {"engine.request", "queue.wait", "prefill.chunk",
                "decode.verify"} <= names
        parsed = json.loads(json.dumps(tracer.export_chrome(),
                                       allow_nan=False))
        xs = [e for e in parsed["traceEvents"] if e["ph"] == "X"]
        assert xs and all("rid" in e["args"] and "ts" in e and "dur" in e
                          for e in xs)
        rows = cost_ledger(recs)
        assert rows and all(r["backend"] == "plain" for r in rows)
        assert {"decode.verify", "prefill.chunk"} <= {r["op"] for r in rows}
        assert all(r["dispatches"] <= r["lanes"] for r in rows)

    def test_flight_recorder_reconstructs_faulted_request(self, host):
        """A chunk fault mid-prefill: the failed request's timeline, the
        failed dispatch included, is rebuilt from the ring after the
        fact, and was dumped when it failed."""
        plan = FaultPlan(seed=0).arm("engine.chunk", kind="error",
                                     calls={2})
        tracer = SpanTracer(mode="all", last=16)
        want, _ = _held(_port(host), PROMPTS[:3])
        engine = _port(host, tracer, faults=plan)
        with engine._cond:
            engine.start()
            futures = [engine.submit(p, N_NEW) for p in PROMPTS[:3]]
        failed, survived = [], 0
        try:
            for f, w in zip(futures, want):
                try:
                    out = f.result(timeout=120)
                except Exception:   # noqa: BLE001 — the injected fault
                    failed.append(f)
                    continue
                numpy.testing.assert_array_equal(out, w)
                survived += 1
        finally:
            engine.stop()
        assert len(failed) == 1 and survived == 2
        rid = failed[0].request.trace.rid
        rec = tracer.find(rid)
        assert rec is not None and "InjectedFault" in rec["error"]
        assert [s for s in rec["spans"] if s["name"] == "prefill.chunk"
                and "error" in s["attrs"]]
        assert "InjectedFault" in format_waterfall(rec)
        assert rid in {d["rid"] for d in tracer.dumps()}
        verify_integrity(tracer.requests())

    def test_untraced_engine_unchanged(self, host):
        """tracer=None is the default: no trace fields set, no spans."""
        engine = _port(host)
        assert engine._tracer is None
        _, futures = _held(engine, PROMPTS[:1])
        assert futures[0].request.trace is None
        assert futures[0].request.tspan is None


# ------------------------------------------------------------------ HTTP
def _api(tracer, host):
    engine = _port(host, tracer).start()

    def handler(request):
        prompt = numpy.asarray(request["input"], numpy.int32)
        return {"tokens": engine.generate(
            prompt, int(request.get("n_new", 4))).tolist()}

    api = RESTfulAPI(None, handler=handler, metrics=engine.metrics,
                     tracer=tracer)
    api.lm_engine = engine
    return api.start(port=0)


class TestHTTPTracing:
    def test_request_id_echo_and_trace_json(self, host):
        """Every reply carries request_id (echoed or minted), and
        /trace.json exports the recorder joined on the client's ids."""
        tracer = SpanTracer(mode="all", last=32)
        api = _api(tracer, host)
        try:
            code, out, hdrs = _post(api.port, {"input": [[1, 2, 3]],
                                               "n_new": 4},
                                    rid="client-key-1")
            assert code == 200 and out["request_id"] == "client-key-1"
            assert hdrs["X-Request-Id"] == "client-key-1"
            code, out, hdrs = _post(api.port, {"input": [[2, 4, 6]],
                                               "n_new": 4})
            assert code == 200
            assert out["request_id"] == hdrs["X-Request-Id"]
            assert len(out["request_id"]) == 16
            code, out, _ = _post(api.port, {"nope": 1}, rid="bad-1")
            assert code == 400 and out["request_id"] == "bad-1"
            code, out, _ = _post(api.port, {"input": [[1]]},
                                 rid="lost-1", path="/nowhere")
            assert code == 404 and out["request_id"] == "lost-1"
            code, body, _ = _get(api.port, "/trace.json?last=8")
            assert code == 200
            trace = json.loads(body)
            xs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
            rids = {e["args"].get("rid") for e in xs}
            assert "client-key-1" in rids and "bad-1" in rids
            names = {e["name"] for e in xs}
            assert {"http.request", "decode.step", "queue.wait"} <= names
            # the engine's spans nest under the HTTP root
            assert "engine.request" not in names
            statuses = {e["args"].get("status") for e in xs
                        if e["name"] == "http.request"}
            assert {200, 400, 404} <= statuses
            assert _get(api.port, "/trace.json?last=x")[0] == 400
        finally:
            api.stop()

    def test_request_id_stamped_without_tracer(self, host):
        api = _api(None, host)
        try:
            code, out, hdrs = _post(api.port, {"input": [[1, 2, 3]],
                                               "n_new": 4},
                                    rid="no-trace-1")
            assert code == 200 and out["request_id"] == "no-trace-1"
            assert hdrs["X-Request-Id"] == "no-trace-1"
            for path in ("/trace.json", "/ledger.json"):
                assert _get(api.port, path)[0] == 404
        finally:
            api.stop()


class TestReviewHardening:
    def test_sample_decision_made_once_across_layers(self, host):
        """sample:P tosses the coin once at the outermost armed layer: a
        request the HTTP layer sampled out roots no tree in the engine,
        and a direct submit under the sentinel neither."""
        tracer = SpanTracer(mode="sample", sample=0.0)
        api = _api(tracer, host)
        try:
            for i in range(3):
                assert _post(api.port, {"input": [[1, 2, 3, 4]],
                                        "n_new": 4})[0] == 200
            with tracing.use(tracing.SAMPLED_OUT):
                api.lm_engine.submit([1, 2, 3], 4).result(timeout=60)
        finally:
            api.stop()
        stats = tracer.stats()
        assert stats["started"] == 3 and stats["sampled_out"] == 3
        assert stats["retained"] == 0 and stats["live"] == 0

    def test_requests_last_zero_is_empty(self):
        tr = SpanTracer(mode="all")
        for _ in range(3):
            tr.finish_request(tr.start_request())
        assert tr.requests(last=0) == []
        assert len(tr.requests(last=2)) == 2
        assert len(tr.export_chrome(last=0)["traceEvents"]) == 1

    def test_injected_503_not_flagged_deadline(self):
        plan = FaultPlan(seed=0).arm("http.request", kind="error",
                                     exc="http_503", times=1)
        tracer = SpanTracer(mode="all", last=8)
        api = RESTfulAPI(None, handler=lambda req: {"ok": True},
                         faults=plan, tracer=tracer).start(port=0)
        try:
            code, out, _ = _post(api.port, {"input": [[1]]}, rid="blip-1")
            assert code == 503 and out["request_id"] == "blip-1"
        finally:
            api.stop()
        rec = tracer.find("blip-1")
        assert rec is not None and rec["error"] == "http 503"
        assert rec["deadline_blown"] is False

    def test_batcher_injected_dispatch_fault_keeps_trees_sound(self):
        plan = FaultPlan(seed=0).arm("batcher.dispatch", kind="error",
                                     calls={1})
        tracer = SpanTracer(mode="all", last=8)
        mb = MicroBatcher(lambda x: x * 2, max_batch=4, sample_shape=(2,),
                          faults=plan, tracer=tracer).start()
        try:
            with pytest.raises(Exception, match="injected"):
                mb.submit(numpy.ones((1, 2), numpy.float32))
            out = mb.submit(numpy.ones((1, 2), numpy.float32))
            numpy.testing.assert_array_equal(
                out, 2 * numpy.ones((1, 2), numpy.float32))
        finally:
            mb.stop()
        recs = tracer.requests()
        assert len(recs) == 2
        verify_integrity(recs)
        assert any(r["error"] and "injected" in r["error"] for r in recs)
        ok = next(r for r in recs if not r["error"])
        names = [s["name"] for s in ok["spans"]]
        assert names == ["batch.request", "queue.wait", "batch.dispatch"]


# ---------------------------------------------------------------- parity
def _discrete(spans):
    """Each span's (name, cat, attributes): durations dropped, the
    backend's presence kept (its value names each package's route)."""
    out = []
    for s in spans:
        attrs = {k: v for k, v in s["attrs"].items() if k not in TIMED}
        if "backend" in attrs:
            attrs["backend"] = "<route>"
        out.append((s["name"], s["cat"], attrs))
    return out


def _ledger_counts(rows):
    return {(r["op"], r["bucket"]): (r["dispatches"], r["lanes"])
            for r in rows}


@pytest.fixture(scope="module", params=sorted(PATHS))
def both(request, host):
    """(path, port tracer, reference tracer, port outputs, reference
    outputs): the same prompts through both engines under
    ``SpanTracer("all")``."""
    knobs = PATHS[request.param]
    port_tr = SpanTracer(mode="all", last=64)
    port_out, _ = _held(_port(host, port_tr, **knobs), PROMPTS)
    ref_tr = jtracing.SpanTracer(mode="all", last=64)
    ref = JaxLMEngine(host, N_HEADS, MAX_LEN, slots=SLOTS,
                      prefill_chunk=PAGE, paged_kv=True, name="lm",
                      tracer=ref_tr, **knobs)
    ref_out, _ = _held(ref, PROMPTS)
    return request.param, port_tr, ref_tr, port_out, ref_out


def test_tokens_equal_the_reference(both):
    path, _, _, port_out, ref_out = both
    for a, b in zip(port_out, ref_out):
        numpy.testing.assert_array_equal(a, b, err_msg=path)


def test_span_sequences_equal_the_reference(both):
    path, port_tr, ref_tr, _, _ = both
    port = {r["rid"]: r for r in port_tr.requests()}
    ref = {r["rid"]: r for r in ref_tr.requests()}
    assert sorted(port) == sorted(ref) and len(port) == len(PROMPTS)
    for rid in sorted(ref):
        assert _discrete(port[rid]["spans"]) \
            == _discrete(ref[rid]["spans"]), (path, rid)
        assert port[rid]["error"] == ref[rid]["error"] is None
    names = {s["name"] for r in port.values() for s in r["spans"]}
    want = {"scan_k4": "decode.megastep", "while_ring2": "decode.megastep",
            "spec_k2": "decode.verify", "prefix": "decode.step"}[path]
    assert want in names


def test_cost_ledgers_equal_the_reference(both):
    path, port_tr, ref_tr, _, _ = both
    port_rows = cost_ledger(port_tr.requests())
    assert _ledger_counts(port_rows) \
        == _ledger_counts(jtracing.cost_ledger(ref_tr.requests())), path
    assert {r["backend"] for r in port_rows} == {"plain"}
    # the live ledger counts what the ring does
    assert _ledger_counts(port_tr.live_ledger()) \
        == _ledger_counts(port_rows)


def test_export_passes_the_reference_integrity_check(both, tmp_path):
    import trace_report
    path, port_tr, _, _, _ = both
    out = tmp_path / "trace.json"
    out.write_text(json.dumps(port_tr.export_chrome(), allow_nan=False))
    rebuilt = trace_report.rebuild_requests(trace_report.load_trace(
        str(out)))
    assert jtracing.verify_integrity(rebuilt)["requests"] == len(PROMPTS)
    assert _ledger_counts(jtracing.cost_ledger(rebuilt)) \
        == _ledger_counts(port_tr.live_ledger()), path
