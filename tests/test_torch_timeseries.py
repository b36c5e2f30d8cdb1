"""The port's continuous telemetry and SLO monitor
(``serving/timeseries.py``, ``serving/slo.py``, their endpoints and the
dashboard's ``/timeseries.json``) against the reference on the CPU.

- Twins of ``tests/test_timeseries.py``: the store's windows (the
  counter restart clamp, gauge and histogram windows, the ring's
  capacity, the strict-JSON snapshot with the shared ``sampled_at``,
  concurrent writers beside the sampler), the runtime probe on a live
  engine (``compile_programs`` counting captured CUDA graphs — none on
  the CPU, so a stand-in ladder checks the count and ``compiles_total``
  — no ``device_mem_bytes`` on the CPU, the peak's source on the
  ``mfu_peak_flops`` gauge) and the megastep waste gauge, the tracer's
  live ledger against the ring's and the reference's
  ``tools/trace_report.py`` rebuild, every ``TestSLOMonitor`` case (the
  health-checker hook driven with a duck-typed checker), the endpoints
  (payloads held to the reference's ``tools/check_stream_records.py``
  schema), the dashboard's default store, and ``serve_lm`` wiring the
  store, the monitor and the endpoints.
- PARITY: one scripted sequence of metric updates and clock readings
  goes through both packages' ``ServingMetrics`` → ``TimeSeriesStore``
  → ``SLOMonitor`` (their clocks patched to the same script): every
  window (rates, gauge stats, bucket p50/p95), every snapshot, every
  burn rate and the state sequence EQUAL, floats within 1e-12 relative.

Left to the fleet (ROADMAP Queue 1 item 9): the reference's
``test_page_streak_survives_successful_probes`` holds the router's
``HealthChecker`` itself; here its monitor side runs (the page and ok
signals a streak is made of).  ``TestChaosSLOSmoke`` is in the
reference's slow suite.
"""

import json
import math
import os
import sys
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy
import pytest
import torch

from veles_tpu.serving import metrics as jmetrics
from veles_tpu.serving import slo as jslo
from veles_tpu.serving import timeseries as jts
from veles_tpu_torch import prng
from veles_tpu_torch.ops.transformer import init_transformer_params
from veles_tpu_torch.restful_api import RESTfulAPI, serve_lm
from veles_tpu_torch.serving import (LMEngine, Objective, ServingMetrics,
                                     SLOMonitor, SpanTracer,
                                     TimeSeriesStore, cost_ledger)
from veles_tpu_torch.serving import slo as pslo
from veles_tpu_torch.serving import timeseries as ts_mod
from veles_tpu_torch.serving.timeseries import (engine_flops_per_token,
                                                engine_program_cache_size,
                                                peak_flops_estimate,
                                                runtime_probe)
from torch_witness import port_witness  # noqa: F401

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

VOCAB, D_MODEL, N_HEADS, N_LAYERS, PAGE, MAX_LEN = 16, 32, 2, 2, 8, 48


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _default_store_restored():
    """serve_lm publishes its store as the process default: put back
    what was there."""
    old = ts_mod.get_default()
    yield
    ts_mod.set_default(old)


@pytest.fixture(scope="module")
def host():
    prng.reset()
    return init_transformer_params(prng.RandomGenerator("init", 14), VOCAB,
                                   d_model=D_MODEL, n_heads=N_HEADS,
                                   n_layers=N_LAYERS, max_len=MAX_LEN)


def _get_json(port, path):
    with urllib.request.urlopen("http://127.0.0.1:%d%s" % (port, path),
                                timeout=10) as r:
        return json.loads(r.read())


# ---------------------------------------------------------------- the store
class TestTimeSeriesStore:
    def test_counter_windows_and_restart_clamp(self):
        m = ServingMetrics("ts_ctr")
        store = TimeSeriesStore(interval_s=0.05, capacity=64)
        store.add_source(m, key="src")
        for n in (5, 9, 2, 6):       # 9 -> 2 is the restart
            m.requests = n
            store.sample_once()
        w = store.window("src.counter.requests", 60)
        assert w["kind"] == "counter" and w["last"] == 6
        assert w["delta"] == 8 and w["rate_per_s"] >= 0

    def test_gauge_and_histogram_windows(self):
        m = ServingMetrics("ts_h")
        store = TimeSeriesStore(interval_s=0.05, capacity=64)
        store.add_source(m, key="src")
        store.sample_once()
        for depth, ttft in ((3, 0.004), (7, 0.004), (5, 0.2)):
            m.set_gauge("queue_depth", depth)
            m.record_ttft(ttft)
            store.sample_once()
        g = store.window("src.gauge.queue_depth", 60)
        assert g["last"] == 5 and g["min"] == 3 and g["max"] == 7
        h = store.window("src.hist.ttft", 60)
        assert h["count_delta"] == 3
        assert h["p50"] <= 0.005 and h["p95"] >= 0.2 and h["bounds"]
        assert store.count_in_window("src.hist.ttft", 60, 0.005) == (2, 3)

    def test_capacity_bounds_every_ring(self):
        m = ServingMetrics("ts_cap")
        store = TimeSeriesStore(interval_s=0.01, capacity=8)
        store.add_source(m, key="src")
        for _ in range(40):
            m.record_enqueue()
            store.sample_once()
        assert store.samples == 40
        assert store.window("src.counter.requests", 1e9)["points"] == 8
        with pytest.raises(ValueError):
            TimeSeriesStore(capacity=1)
        with pytest.raises(ValueError):
            TimeSeriesStore(interval_s=0)

    def test_snapshot_strict_json_with_shared_sampled_at(self):
        from veles_tpu_torch.serving.metrics import monotonic_offset
        m = ServingMetrics("ts_snap")
        store = TimeSeriesStore(interval_s=0.05, capacity=16)
        store.add_source(m, key="src")
        for _ in range(3):
            m.record_enqueue()
            m.record_response(0.01)
            m.record_decode_step(float("nan"))   # hostile input
            store.sample_once()
        snap = json.loads(json.dumps(store.snapshot(window_s=60),
                                     allow_nan=False))
        assert snap["samples"] == 3
        assert 0 < snap["sampled_at"] <= monotonic_offset()
        ctr = snap["series"]["src.counter.requests"]
        assert ctr["kind"] == "counter" and ctr["last"] == 3
        assert len(ctr["series"]) == 3
        before = m.snapshot()["sampled_at"]
        time.sleep(0.01)
        assert m.snapshot()["sampled_at"] > before

    def test_concurrent_writers_sampler_and_reads(self):
        m = ServingMetrics("ts_conc")
        store = TimeSeriesStore(interval_s=0.005, capacity=256)
        store.add_source(m, key="src")
        errors, stop = [], threading.Event()

        def hammer():
            try:
                i = 0
                while not stop.is_set():
                    m.record_enqueue()
                    m.record_response(0.001 * (i % 5 + 1))
                    m.record_ttft(0.002)
                    m.inc("tokens_out", 3)
                    m.set_gauge("queue_depth", i % 11)
                    i += 1
            except Exception as e:   # noqa: BLE001 — the assertion
                errors.append(e)

        writers = [threading.Thread(target=hammer) for _ in range(3)]
        for t in writers:
            t.start()
        store.start()
        try:
            last_seen = -1
            deadline = time.monotonic() + 0.8
            while time.monotonic() < deadline:
                w = store.window("src.counter.requests", 60)
                if w is not None:
                    assert w["delta"] >= 0 and w["rate_per_s"] >= 0
                    assert w["last"] >= last_seen
                    last_seen = w["last"]
                h = store.window("src.hist.ttft", 60)
                if h is not None:
                    assert h["count_delta"] >= 0
                json.dumps(store.snapshot(window_s=5), allow_nan=False)
        finally:
            stop.set()
            for t in writers:
                t.join(timeout=10)
            store.stop()
        assert not errors, errors
        assert store.samples > 10 and store._thread is None
        final = store.window("src.counter.requests", 1e9)
        assert final["last"] <= m.snapshot()["requests"]


# ---------------------------------------------------------- runtime probe
class TestRuntimeGauges:
    def test_engine_runtime_probe(self, host):
        """The probe on a live engine: RSS, tokens/s and MFU over the
        CPU's nominal peak (its source on ``mfu_peak_flops``), no
        ``device_mem_bytes`` on the CPU, and ``compile_programs`` the
        captured graphs — none for the CPU's eager programs; a ladder of
        captured graphs (stood in) is counted, growth into
        ``compiles_total``."""
        engine = LMEngine(host, N_HEADS, MAX_LEN, slots=2,
                          prefill_chunk=PAGE, megastep=4, device="cpu",
                          name="rp_t", metrics=ServingMetrics("rp_t"))
        engine.start()
        try:
            probe = runtime_probe(engine)
            probe()
            snap0 = engine.metrics.snapshot()
            assert snap0["gauges"]["process_rss_bytes"] > 0
            assert snap0["gauges"]["compile_programs"] == 0
            engine.generate(numpy.asarray([[1, 2, 3]] * 2), 6)
            probe()
            time.sleep(0.02)
            probe()
            g = engine.metrics.snapshot()["gauges"]
            assert "device_mem_bytes" not in g
            assert "tokens_per_s" in g and g["mfu_live"] >= 0
            assert g['mfu_peak_flops{source="cpu:nominal"}'] \
                == peak_flops_estimate()[0]
            assert engine_flops_per_token(engine) > 0
            # the card's ladder: one captured program a width
            assert engine_program_cache_size(engine) == 0
            engine._while_graphs = {w: object()
                                    for w in engine._width_ladder}
            probe()
            snap = engine.metrics.snapshot()
            assert snap["gauges"]["compile_programs"] \
                == len(engine._width_ladder) \
                == snap["counters"]["compiles_total"]
            engine._while_graphs = {}
            probe()
            assert engine.metrics.counter("compiles_total") \
                == len(engine._width_ladder)          # monotone
        finally:
            engine.stop()

    def test_peak_flops_sources(self, monkeypatch):
        monkeypatch.setenv("VELES_PEAK_FLOPS", "2.5e13")
        assert peak_flops_estimate(torch.device("cpu")) \
            == (2.5e13, "env:VELES_PEAK_FLOPS")
        monkeypatch.delenv("VELES_PEAK_FLOPS")
        assert peak_flops_estimate(torch.device("cpu")) \
            == (ts_mod.CPU_NOMINAL_FLOPS, "cpu:nominal")
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda device=None: "NVIDIA H100 80GB HBM3")
        assert peak_flops_estimate(torch.device("cuda")) \
            == (67e12, "cuda:H100 fp32")
        assert not hasattr(ts_mod, "TPU_PEAK_FLOPS")

    def test_megastep_waste_gauge(self):
        eng = SimpleNamespace(params=None, n_heads=2, max_len=32,
                              device=torch.device("cpu"),
                              metrics=ServingMetrics("ms_t"))
        probe = runtime_probe(eng, flops_per_token=None)
        probe()
        eng.metrics.record_megastep(k=8, lanes=2, tokens=12,
                                    wasted_iterations=4)
        probe()
        frac = eng.metrics.snapshot()["gauges"]["megastep_waste_frac"]
        assert frac == pytest.approx(4 / 16)


# ------------------------------------------------------------ live ledger
class TestLiveLedger:
    def test_live_ledger_equals_ring_and_trace_report(self, host, tmp_path):
        import trace_report
        tracer = SpanTracer(mode="all", last=64)
        engine = LMEngine(host, N_HEADS, MAX_LEN, slots=2,
                          prefill_chunk=PAGE, spec_k=2, device="cpu",
                          name="led_t", metrics=ServingMetrics("led_t"),
                          tracer=tracer).start()
        try:
            futures = [engine.submit(p, 6) for p in
                       ([1, 2, 3], [2, 4, 6, 8], [5, 1, 5, 1, 5], [7, 7])]
            for f in futures:
                f.result(timeout=60)
        finally:
            engine.stop()
        ring, live = tracer.ledger(), tracer.live_ledger()
        assert ring and live and ring == live
        path = tmp_path / "trace.json"
        path.write_text(json.dumps(tracer.export_chrome()))
        reported = cost_ledger(trace_report.rebuild_requests(
            trace_report.load_trace(str(path))))

        def key(r):
            return r["op"], r["bucket"], r["backend"]
        assert {key(r) for r in reported} == {key(r) for r in live}
        by_key = {key(r): r for r in reported}
        for row in live:
            rep = by_key[key(row)]
            assert rep["dispatches"] == row["dispatches"]
            assert rep["lanes"] == row["lanes"]
            for q in ("p50_ms", "p95_ms", "mean_ms"):
                assert rep[q] == pytest.approx(row[q], abs=2e-3)

    def test_errors_mode_ledger_survives_ring_discard(self):
        tr = SpanTracer(mode="errors", last=8)
        ctx = tr.start_request(name="r1")
        tr.add(ctx, "decode.step", "decode", 0.0, 0.001,
               attrs={"bucket": 2, "backend": "cuda"})
        tr.finish_request(ctx)
        assert tr.requests() == [] and tr.ledger() == []
        live = tr.live_ledger()
        assert len(live) == 1 and live[0]["dispatches"] == 1


# ------------------------------------------------------------------- SLOs
class _Checker:
    """A duck-typed health checker: records the monitor's signals."""

    def __init__(self):
        self.pages, self.oks = [], []

    def note_slo_page(self, i, reason=""):
        self.pages.append(i)

    def note_slo_ok(self, i):
        self.oks.append(i)


class TestSLOMonitor:
    @staticmethod
    def _store(metrics, key="src"):
        store = TimeSeriesStore(interval_s=0.05, capacity=256)
        store.add_source(metrics, key=key)
        return store

    def test_objective_validation(self):
        with pytest.raises(ValueError, match="kind"):
            Objective("x", "throughput", 0.9)
        with pytest.raises(ValueError, match="target"):
            Objective("x", "availability", 1.0)
        with pytest.raises(ValueError, match="threshold_s"):
            Objective("x", "latency", 0.9, series="ttft")
        with pytest.raises(ValueError, match="series"):
            Objective("x", "latency", 0.9, series="nope", threshold_s=0.1)
        with pytest.raises(ValueError):
            SLOMonitor(self._store(ServingMetrics("slo_v")), [])

    def test_state_machine_transitions(self):
        m = ServingMetrics("slo_sm")
        store = self._store(m)
        mon = SLOMonitor(store, [Objective("avail", "availability", 0.9)],
                         windows_s=(0.4, 300.0), min_events=1)
        store.add_listener(mon.sample_once)
        store.sample_once()
        for _ in range(100):
            m.record_response(0.001)
        store.sample_once()
        assert mon.state("src", "avail") == 0
        for _ in range(15):
            m.record_error()
        store.sample_once()
        assert mon.state("src", "avail") == 1
        for _ in range(85):
            m.record_error()
        store.sample_once()
        assert mon.state("src", "avail") == 2
        assert mon.metrics.counter("slo_pages_total") == 1
        time.sleep(0.5)
        for _ in range(2):
            for _ in range(50):
                m.record_response(0.001)
            store.sample_once()
        assert mon.state("src", "avail") == 0
        assert mon.metrics.counter("slo_recoveries_total") == 1
        snap = json.loads(json.dumps(mon.snapshot(), allow_nan=False))
        assert snap["pages_total"] == 1

    def test_latency_objective_bucket_resolution(self):
        m = ServingMetrics("slo_lat")
        store = self._store(m)
        mon = SLOMonitor(store, [Objective("ttft", "latency", 0.9,
                                           series="ttft",
                                           threshold_s=0.05)],
                         windows_s=(60.0, 300.0), min_events=1,
                         page_burn=2.0)
        store.sample_once()
        for _ in range(20):
            m.record_ttft(0.004)
        store.sample_once()
        mon.sample_once()
        assert mon.state("src", "ttft") == 0
        for _ in range(20):
            m.record_ttft(0.4)
        store.sample_once()
        mon.sample_once()
        assert mon.state("src", "ttft") == 2

    def test_min_events_holds_state(self):
        m = ServingMetrics("slo_idle")
        store = self._store(m)
        mon = SLOMonitor(store, [Objective("avail", "availability", 0.999)],
                         windows_s=(60.0, 300.0), min_events=5)
        store.sample_once()
        m.record_error()
        store.sample_once()
        rows = mon.sample_once()
        assert mon.state("src", "avail") == 0 and rows[0]["held"] is True

    def test_latency_threshold_between_bounds_rounds_down(self):
        m = ServingMetrics("slo_cut")
        store = self._store(m)
        mon = SLOMonitor(store, [Objective("ttft", "latency", 0.9,
                                           series="ttft",
                                           threshold_s=0.3)],
                         windows_s=(60.0, 300.0), min_events=1)
        store.sample_once()
        for _ in range(20):
            m.record_ttft(0.45)
        store.sample_once()
        mon.sample_once()
        assert mon.state("src", "ttft") == 2
        assert store.count_in_window("src.hist.ttft", 60, 0.3) == (0, 20)

    def test_held_page_never_refeeds_checker(self):
        m0, m1 = ServingMetrics("slo_held0"), ServingMetrics("slo_held1")
        store = TimeSeriesStore(interval_s=0.02, capacity=64)
        store.add_source(m0, key="r0")
        store.add_source(m1, key="r1")
        checker = _Checker()
        mon = SLOMonitor(store, [Objective("avail", "availability", 0.9)],
                         windows_s=(0.4, 300.0), min_events=5,
                         checker=checker, source_replicas={"r0": 0, "r1": 1})
        store.add_listener(mon.sample_once)
        store.sample_once()
        for _ in range(20):
            m0.record_error()
            m1.record_response(0.001)
        store.sample_once()
        assert mon.state("r0", "avail") == 2 and checker.pages == [0]
        time.sleep(0.5)
        pages_before = list(checker.pages)
        store.sample_once()
        store.sample_once()
        rows = {(r["source"], r["objective"]): r
                for r in mon.sample_once()}
        assert rows[("r0", "avail")]["state"] == 2
        assert rows[("r0", "avail")]["held"] is True
        assert checker.pages == pages_before

    def test_from_spec_file_and_shed_objective(self, tmp_path):
        spec = {"windows_s": [0.5, 120], "warn_burn": 1.0,
                "page_burn": 3.0, "min_events": 2,
                "objectives": [{"name": "shed", "kind": "shed_rate",
                                "target": 0.9}]}
        path = tmp_path / "slo.json"
        path.write_text(json.dumps(spec))
        m = ServingMetrics("slo_file")
        store = self._store(m)
        mon = SLOMonitor.from_spec(str(path), store)
        assert mon.windows_s == (0.5, 120.0) and mon.page_burn == 3.0
        store.sample_once()
        for _ in range(10):
            m.record_response(0.001)
        for _ in range(10):
            m.record_shed()
        store.sample_once()
        mon.sample_once()
        assert mon.state("src", "shed") == 2
        assert SLOMonitor.from_spec(None, store) is None
        assert SLOMonitor.from_spec(mon, store) is mon
        with pytest.raises(ValueError, match="objectives"):
            SLOMonitor.from_spec({"nope": 1}, store)

    def test_page_feeds_health_checker_not_fleet_wide(self):
        """A replica's burn pages the checker; a fleet-wide burn never
        does; a solo source is never fed."""
        ms = [ServingMetrics("slo_hc", labels={"replica": str(i)})
              for i in range(2)]
        store = TimeSeriesStore(interval_s=0.05, capacity=64)
        for i, m in enumerate(ms):
            store.add_source(m, key="r%d" % i)
        checker = _Checker()
        mon = SLOMonitor(store, [Objective("avail", "availability", 0.9)],
                         windows_s=(60.0, 300.0), min_events=1,
                         checker=checker, source_replicas={"r0": 0, "r1": 1})
        store.add_listener(mon.sample_once)
        store.sample_once()
        for m in ms:
            for _ in range(10):
                m.record_error()
        store.sample_once()
        assert mon.state("r0", "avail") == mon.state("r1", "avail") == 2
        assert checker.pages == []                 # the whole fleet
        time.sleep(0.05)
        for _ in range(200):
            ms[1].record_response(0.001)
        for _ in range(20):
            ms[0].record_error()
        store.sample_once()
        assert mon.state("r1", "avail") in (0, 1)
        store.sample_once()
        assert checker.pages == [0, 0] and 1 in checker.oks
        solo = ServingMetrics("slo_solo")
        store1 = self._store(solo)
        checker1 = _Checker()
        mon1 = SLOMonitor(store1, [Objective("avail", "availability", 0.9)],
                          windows_s=(60.0, 300.0), min_events=1,
                          checker=checker1, source_replicas={"src": 0})
        store1.sample_once()
        for _ in range(10):
            solo.record_error()
        store1.sample_once()
        mon1.sample_once()
        assert mon1.state("src", "avail") == 2 and checker1.pages == []

    def test_page_streak_survives_successful_probes(self):
        """The monitor's side of the checker's page streak: each fresh
        paging scan signals a page, a scan whose burn stopped signals
        ok (the streak's reset), and nothing else does."""
        ms = [ServingMetrics("slo_pr%d" % i) for i in range(2)]
        store = TimeSeriesStore(interval_s=0.05, capacity=64)
        for i, m in enumerate(ms):
            store.add_source(m, key="r%d" % i)
        checker = _Checker()
        mon = SLOMonitor(store, [Objective("avail", "availability", 0.9)],
                         windows_s=(0.3, 300.0), min_events=1,
                         checker=checker, source_replicas={"r0": 0, "r1": 1})
        store.sample_once()
        for scan in range(2):
            for _ in range(20):
                ms[0].record_error()
                ms[1].record_response(0.001)
            store.sample_once()
            mon.sample_once()
            assert checker.pages == [0] * (scan + 1)
            assert checker.oks == [1] * (scan + 1)
        time.sleep(0.35)
        for _ in range(2):
            for _ in range(50):
                ms[0].record_response(0.001)
                ms[1].record_response(0.001)
            store.sample_once()
        mon.sample_once()
        assert mon.state("r0", "avail") == 0
        assert checker.pages == [0, 0] and checker.oks[-2:] == [0, 1]


# -------------------------------------------------------------- endpoints
def _serve_components():
    m = ServingMetrics("ep_t")
    store = TimeSeriesStore(interval_s=0.05, capacity=32)
    store.add_source(m, key="ep")
    mon = SLOMonitor(store, [Objective("avail", "availability", 0.99)],
                     windows_s=(60.0, 300.0), min_events=1)
    tracer = SpanTracer(mode="all", last=8)
    ctx = tracer.start_request(name="seed")
    tracer.add(ctx, "decode.step", "decode", 0.0, 0.002,
               attrs={"bucket": 2, "backend": "cuda"})
    tracer.finish_request(ctx)
    for _ in range(3):
        m.record_enqueue()
        m.record_response(0.01)
        m.record_ttft(0.01)
        store.sample_once()
    mon.sample_once()
    return RESTfulAPI(None, handler=lambda p: {"ok": True}, metrics=m,
                      tracer=tracer, telemetry=store, slo=mon).start(port=0)


class TestTelemetryEndpoints:
    def test_endpoints_strict_json_and_status_panel(self):
        import check_stream_records as csr
        api = _serve_components()
        try:
            ts = _get_json(api.port, "/timeseries.json?window=30")
            assert ts["window_s"] == 30.0 and ts["samples"] == 3
            assert "ep.counter.responses" in ts["series"]
            assert ts["sampled_at"] > 0
            slo = _get_json(api.port, "/slo.json")
            assert slo["worst_state_name"] == "ok"
            assert slo["objectives"][0]["objective"] == "avail"
            led = _get_json(api.port, "/ledger.json")
            assert led["dispatches_total"] == 1
            assert led["rows"][0]["op"] == "decode.step"
            assert _get_json(api.port, "/metrics.json")["sampled_at"] > 0
            with urllib.request.urlopen(
                    "http://127.0.0.1:%d/status" % api.port,
                    timeout=10) as r:
                assert r.headers["Content-Type"].startswith("text/plain")
                text = r.read().decode()
            assert "veles_tpu_torch serving status" in text
            assert "[slo" in text and "[telemetry" in text
            assert "[cost ledger" in text
            assert csr.check_timeseries_payload(ts) == []
            assert csr.check_slo_payload(slo) == []
        finally:
            api.stop()
        assert api.telemetry._thread is None

    @pytest.mark.parametrize("window", ["banana", "-5", "nan", "inf", "0"])
    def test_bad_window_param_is_400(self, window):
        api = _serve_components()
        try:
            with pytest.raises(urllib.error.HTTPError) as err:
                _get_json(api.port, "/timeseries.json?window=" + window)
            assert err.value.code == 400
        finally:
            api.stop()

    def test_endpoints_absent_without_components(self):
        api = RESTfulAPI(None, handler=lambda p: {"ok": True}).start(port=0)
        try:
            for path in ("/timeseries.json", "/slo.json", "/ledger.json",
                         "/trace.json"):
                with pytest.raises(urllib.error.HTTPError) as err:
                    _get_json(api.port, path)
                assert err.value.code == 404
            with urllib.request.urlopen(
                    "http://127.0.0.1:%d/status" % api.port,
                    timeout=10) as r:
                assert b"serving status" in r.read()
        finally:
            api.stop()


class TestWebStatusTimeseries:
    def test_dashboard_serves_default_store(self):
        from veles_tpu_torch.web_status import WebStatus
        status = WebStatus().start(port=0)
        try:
            ts_mod.set_default(None)
            with pytest.raises(urllib.error.HTTPError) as err:
                _get_json(status.port, "/timeseries.json")
            assert err.value.code == 404
            m = ServingMetrics("ws_ts")
            store = TimeSeriesStore(interval_s=0.05, capacity=16)
            store.add_source(m, key="ws")
            m.record_enqueue()
            store.sample_once()
            ts_mod.set_default(store)
            snap = _get_json(status.port, "/timeseries.json?window=banana")
            assert "ws.counter.requests" in snap["series"]
            assert snap["window_s"] == 60.0
            assert _get_json(status.port, "/timeseries.json?window=5")[
                "window_s"] == 5.0
        finally:
            status.stop()


class TestServeLMTelemetry:
    def test_serve_lm_wires_store_slo_and_endpoints(self, host):
        """serve_lm(trace=, telemetry=, slo=True): the store samples the
        engine on its cadence with the monitor on its tick, every
        endpoint answers on the serving port, and stop() stops the
        sampler before the engine."""
        from veles_tpu_torch.ops.transformer import params_from_jax
        trainer = SimpleNamespace(
            params=params_from_jax(host, torch.device("cpu")),
            n_heads=N_HEADS, max_len=MAX_LEN,
            _to_portable=lambda tree: tree)
        api = serve_lm(SimpleNamespace(trainer=trainer), port=0, max_new=8,
                       slots=2, prefill_chunk=PAGE, trace="all",
                       trace_last=8, telemetry=0.05, slo=True)
        try:
            assert api.telemetry is not None and api.slo is not None
            assert api.tracer is not None and api.tracer.mode == "all"
            assert api.lm_engine._tracer is api.tracer
            assert ts_mod.get_default() is api.telemetry
            req = urllib.request.Request(
                "http://127.0.0.1:%d/predict" % api.port,
                data=json.dumps({"input": [[3, 4, 5]],
                                 "n_new": 4}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                assert len(json.loads(resp.read())["tokens"][0]) == 7
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline \
                    and api.telemetry.samples < 3:
                time.sleep(0.05)
            assert api.telemetry.samples >= 3
            ts = _get_json(api.port, "/timeseries.json")
            assert [n for n in ts["series"]
                    if n.endswith("counter.responses")]
            slo = _get_json(api.port, "/slo.json")
            assert slo["objectives"]
            assert slo["worst_state_name"] in ("ok", "warn", "page")
            g = _get_json(api.port, "/metrics.json")["gauges"]
            assert g["compile_programs"] == 0        # eager on the CPU
            assert "process_rss_bytes" in g
            trace = _get_json(api.port, "/trace.json")
            names = {e["name"] for e in trace["traceEvents"]}
            assert {"http.request", "queue.wait", "prefill.chunk",
                    "decode.step"} <= names
            assert _get_json(api.port, "/ledger.json")["dispatches_total"]
        finally:
            api.stop()
        assert api.telemetry._thread is None
        # slo implies telemetry at 1 s
        api = serve_lm(SimpleNamespace(trainer=trainer), port=0, max_new=8,
                       slots=2, prefill_chunk=PAGE, slo=True)
        try:
            assert api.telemetry.interval_s == 1.0 and api.tracer is None
        finally:
            api.stop()


# ----------------------------------------------------------------- parity
class _Clock:
    """A scripted monotonic offset, patched into both packages."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _script(metrics_cls):
    """The scripted metric updates: (clock step, [(method, args)])."""
    steps = []
    rng = numpy.random.RandomState(7)
    for i in range(40):
        ops = []
        for _ in range(int(rng.randint(3, 12))):
            ops.append(("record_enqueue", ()))
            ops.append(("record_response", (float(rng.choice(
                [0.003, 0.02, 0.2, 1.5])),)))
        if 10 <= i < 18:
            ops += [("record_error", ())] * int(rng.randint(1, 8))
        if 22 <= i < 26:
            ops += [("record_shed", ())] * 3 + [("record_reject", ())]
        if i == 30:
            ops.append(("restart", ()))
        ops += [("record_ttft", (float(rng.choice([0.004, 0.3, 2.0])),)),
                ("record_decode_step", (float(rng.choice(
                    [0.001, 0.03, 0.4])),)),
                ("set_gauge", ("queue_depth", int(rng.randint(0, 9)))),
                ("inc", ("tokens_out", int(rng.randint(1, 50))))]
        steps.append((float(rng.choice([0.25, 0.5, 1.0, 2.0])), ops))
    return steps


def _drive(metrics_mod, ts, slo, clock):
    m = metrics_mod.ServingMetrics("parity")
    store = ts.TimeSeriesStore(interval_s=1.0, capacity=24)
    store.add_source(m, key="src")
    mon = slo.SLOMonitor(store, slo.SLOMonitor.default_objectives() + [
        slo.Objective("queue", "latency", 0.9, series="queue_wait",
                      threshold_s=0.05)],
        windows_s=(5.0, 30.0), min_events=4)
    store.add_listener(mon.sample_once)
    out = []
    for dt, ops in _script(metrics_mod.ServingMetrics):
        clock.t += dt
        for name, args in ops:
            if name == "restart":
                m.requests = m.responses = 0
            else:
                getattr(m, name)(*args)
        store.sample_once()
        windows = {n: store.window(n, w) for n in store.series_names()
                   for w in (3.0, 12.0)}
        out.append({"windows": windows,
                    "count": store.count_in_window("src.hist.ttft", 12.0,
                                                   1.0),
                    "delta": store.counter_delta("src.counter.errors", 8.0),
                    "states": mon.states(),
                    "slo": mon.snapshot(),
                    "snapshot": store.snapshot(window_s=10.0)})
    return out


def _close(a, b, path="$"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _close(a[k], b[k], "%s.%s" % (path, k))
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, "%s[%d]" % (path, i))
    elif isinstance(a, float) and not isinstance(b, bool):
        assert isinstance(b, (int, float)), path
        assert math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0) \
            or a == b, (path, a, b)
    else:
        assert a == b, (path, a, b)


def test_store_and_monitor_equal_the_reference(monkeypatch):
    clock = _Clock()
    for mod in (ts_mod, jts, pslo, jslo):
        monkeypatch.setattr(mod, "monotonic_offset", clock)
    from veles_tpu_torch.serving import metrics as pmetrics
    for mod in (pmetrics, jmetrics):
        monkeypatch.setattr(mod, "monotonic_offset", clock)
    port = _drive(pmetrics, ts_mod, pslo, clock)
    clock.t = 1000.0
    ref = _drive(jmetrics, jts, jslo, clock)
    states = [sorted(set(s["states"].values())) for s in port]
    assert [0] in states and any(2 in s for s in states)   # moved
    for i, (a, b) in enumerate(zip(port, ref)):
        _close(a, b, "step %d" % i)
