"""The port's REST predict path (``veles_tpu_torch.restful_api``) and
micro-batcher (``veles_tpu_torch.serving.batcher``) on the CPU: the
reference's ``TestRESTServing``, ``TestMicroBatcher`` and
``TestBatchedHTTP`` cases that need no unported module
(``tests/test_services.py``, ``tests/test_serving.py``), and the port's
replies against the reference server's on the same weights.

The tiny MNIST-FC (hidden 16, 200 train / 100 validation, minibatch 50,
2 epochs, seed 1 — ``tests/test_services.py``'s size) is trained in both
packages, and the port's workflow takes the reference's trained state:
replies agree within 1e-6 absolute (the two packages' CPU GEMMs sum in
different orders) with equal argmax.
"""

import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy
import pytest
import torch

from veles_tpu import prng as jax_prng
from veles_tpu import restful_api as jax_restful
from veles_tpu.config import root as jax_root
from veles_tpu.samples import mnist as jax_mnist
from veles_tpu.serving import batch_buckets as jax_batch_buckets
from veles_tpu_torch import export, prng, snapshotter
from veles_tpu_torch.compiled import load_fused_state, state_from_jax
from veles_tpu_torch.config import root
from veles_tpu_torch.restful_api import (RESTfulAPI, serve_artifact,
                                         serve_lm, serve_snapshot)
from veles_tpu_torch.samples import mnist
from veles_tpu_torch.serving import (DeadlineExceeded, MicroBatcher,
                                     Overloaded, ServingMetrics,
                                     batch_buckets)

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

from load_gen import run_load  # noqa: E402
from torch_witness import port_witness  # noqa: E402,F401

SEED = 1
MNIST = {
    "loader": {"minibatch_size": 50, "n_train": 200, "n_valid": 100},
    "decision": {"max_epochs": 2, "fail_iterations": 5},
    "layers": [
        {"type": "all2all_tanh", "output_sample_shape": 16,
         "learning_rate": 0.03, "momentum": 0.9},
        {"type": "softmax", "output_sample_shape": 10,
         "learning_rate": 0.03, "momentum": 0.9},
    ],
}


def _post(port, payload, timeout=30, path="/predict", headers=None):
    req = urllib.request.Request(
        "http://127.0.0.1:%d%s" % (port, path),
        data=json.dumps(payload).encode(),
        headers=dict({"Content-Type": "application/json"},
                     **(headers or {})))
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read()), resp.headers


def _get(port, path):
    with urllib.request.urlopen("http://127.0.0.1:%d%s" % (port, path),
                                timeout=10) as resp:
        return resp.read().decode(), resp.headers


def _restore(cfg_root, name, saved):
    cfg_root.__dict__.pop(name, None)
    if saved is not None:
        cfg_root.__dict__[name] = saved


@pytest.fixture(scope="module")
def trained():
    """(port workflow, reference workflow), the port holding the
    reference's trained state."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    saved = jax_root.__dict__.pop("mnist", None)
    try:
        jax_prng.reset()
        jax_prng.seed_all(SEED)
        jax_root.mnist.update(MNIST)
        ref = jax_mnist.train()
    finally:
        _restore(jax_root, "mnist", saved)
        jax_prng.reset()
    saved = root.__dict__.pop("mnist", None)
    try:
        prng.reset()
        prng.seed_all(SEED)
        root.mnist.update(MNIST)
        wf = mnist.train(device="cpu")
    finally:
        _restore(root, "mnist", saved)
    load_fused_state(wf, state_from_jax(
        [{k: numpy.asarray(v) for k, v in e.items()}
         for e in ref._fused_runner.state], device="cpu"))
    yield wf, ref
    torch.set_num_threads(threads)
    prng.reset()


class TestRESTServing:
    def test_predict_roundtrip_equals_the_reference(self, trained):
        wf, ref = trained
        api = RESTfulAPI(wf).start(port=0)
        ref_api = jax_restful.RESTfulAPI(ref).start(port=0)
        try:
            x = numpy.asarray(wf.loader.original_data.mem[:6])
            out, headers = _post(api.port, {"input": x.tolist()})
            want, _ = _post(ref_api.port, {"input": x.tolist()})
        finally:
            api.stop()
            ref_api.stop()
        assert len(out["output"]) == 6 and len(out["output"][0]) == 10
        assert abs(sum(out["output"][0]) - 1.0) < 1e-3      # softmax
        numpy.testing.assert_allclose(out["output"], want["output"],
                                      rtol=0, atol=1e-6)
        assert out["argmax"] == want["argmax"]
        assert headers["X-Request-Id"] == out["request_id"]

    def test_unit_mode_serves_the_same_forward(self, trained):
        wf, _ = trained
        runner = wf._fused_runner
        runner.sync_to_units()
        x = numpy.asarray(wf.loader.original_data.mem[:4])
        fused = RESTfulAPI(wf).predict(x)
        saved = wf._fused_runner
        wf._fused_runner = None
        try:
            unit = RESTfulAPI(wf).predict(x)
        finally:
            wf._fused_runner = saved
        assert unit == fused

    def test_bad_request_is_400(self, trained):
        wf, _ = trained
        api = RESTfulAPI(wf).start(port=0)
        try:
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(api.port, {"wrong": 1})
            assert err.value.code == 400
            assert "error" in json.loads(err.value.read())
        finally:
            api.stop()

    def test_request_id_is_echoed_on_errors_too(self, trained):
        wf, _ = trained
        api = RESTfulAPI(wf).start(port=0)
        try:
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(api.port, {"nope": 1},
                      headers={"X-Request-Id": "abc-123"})
            body = json.loads(err.value.read())
            assert err.value.headers["X-Request-Id"] == "abc-123"
            assert body["request_id"] == "abc-123"
            out, headers = _post(
                api.port, {"input": numpy.zeros((1, 784)).tolist()},
                headers={"X-Request-Id": "x" * 100})
            assert headers["X-Request-Id"] == "x" * 64
        finally:
            api.stop()


def _artifact(trained, tmp_path):
    wf, _ = trained
    path = str(tmp_path / "mnist.veles")
    export.export_model(wf, path)
    return path


class TestArtifactAndSnapshotServing:
    def test_serve_artifact_without_workflow(self, trained, tmp_path):
        wf, _ = trained
        path = _artifact(trained, tmp_path)
        x = numpy.asarray(wf.loader.original_data.mem[:5])
        runner = wf._fused_runner
        want = runner.eval_forward()(runner.state,
                                     torch.from_numpy(x)).numpy()
        for max_batch in (0, 4):
            api = serve_artifact(path, port=0, max_batch=max_batch,
                                 device="cpu")
            try:
                out, _ = _post(api.port, {"input": x.tolist()})
            finally:
                api.stop()
            assert api.workflow is None
            # direct: the same batch, bit for bit; batched: the 5 rows
            # run as a bucket of 4 and one of 1, and the CPU GEMM's sums
            # depend on the batch
            numpy.testing.assert_allclose(
                numpy.asarray(out["output"], numpy.float32), want,
                rtol=0, atol=1e-6 if max_batch else 0)
            assert out["argmax"] == want.argmax(1).tolist()

    def test_serve_snapshot(self, trained, tmp_path):
        wf, _ = trained
        snap = snapshotter.save(wf, str(tmp_path / "mnist_current.pickle.gz"))
        x = numpy.asarray(wf.loader.original_data.mem[:3])
        direct = RESTfulAPI(wf).predict(x)

        def build():
            saved = root.__dict__.pop("mnist", None)
            try:
                root.mnist.update(MNIST)
                prng.reset()
                prng.seed_all(99)   # restore must overwrite the init
                fresh = mnist.build()
                fresh.initialize(device="cpu")
            finally:
                _restore(root, "mnist", saved)
            return fresh

        api = serve_snapshot(snap, port=0, build=build)
        try:
            out, _ = _post(api.port, {"input": x.tolist()})
        finally:
            api.stop()
        assert out["output"] == direct["output"]


class TestUnported:
    @pytest.mark.parametrize("knob,item", [
        ("faults", "Queue 2a item 15"), ("tracer", "Queue 1 item 7"),
        ("telemetry", "Queue 1 item 7"), ("slo", "Queue 1 item 7")])
    def test_restful_knobs_raise_naming_their_items(self, knob, item):
        """Every knob's item is done: ``faults`` is kept and reaches the
        batcher (``tests/test_torch_serving_faults.py`` serves through
        it); ``tracer``, ``telemetry`` and ``slo`` are kept, the tracer
        reaching the batcher too (``tests/test_torch_tracing.py``,
        ``tests/test_torch_timeseries.py`` serve through them)."""
        value = object()
        api = RESTfulAPI(None, forward=lambda x: x, **{knob: value})
        assert getattr(api, knob) is value
        if knob in ("faults", "tracer"):
            api.enable_batching(sample_shape=(2,))
            assert getattr(api.batcher, "_" + knob) is value

    @pytest.mark.parametrize("knob", ["faults", "tracer"])
    def test_batcher_knobs_raise_naming_their_item(self, knob):
        """Both are ported: the batcher keeps the plan and the tracer."""
        value = object()
        assert getattr(MicroBatcher(lambda x: x, **{knob: value}),
                       "_" + knob) is value

    def test_serve_lm_raises_naming_its_item(self):
        """serve_lm is ported; its fleet knobs raise naming their item
        before the workflow is read, and its trace, telemetry and SLO
        knobs are no longer among the unported."""
        with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
            serve_lm(None, port=0, replicas=2)
        from veles_tpu_torch.restful_api import SERVE_LM_UNPORTED
        assert not {"trace", "telemetry", "slo"} & {
            knob for knob, _, _ in SERVE_LM_UNPORTED}


class TestMicroBatcher:
    def test_coalesces_and_preserves_rows(self):
        dispatched = []

        def forward(x):
            dispatched.append(len(x))
            time.sleep(0.004)      # a forward the queue can fill behind
            return x * 2.0

        mb = MicroBatcher(forward, max_batch=8, batch_wait_s=0.01,
                          sample_shape=(4,),
                          metrics=ServingMetrics("mb_t1")).start()
        errors = []

        def client(ci):
            try:
                for j in range(5):
                    x = numpy.full((1, 4), ci * 10 + j, numpy.float32)
                    out = mb.submit(x)
                    assert out.shape == (1, 4)
                    numpy.testing.assert_array_equal(out, x * 2)
            except Exception as e:   # noqa: BLE001 — reported below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        mb.stop()
        assert errors == []
        snap = mb.metrics.snapshot()
        assert snap["requests"] == 40
        assert snap["dispatches"] < snap["requests"]
        assert snap["batch_size"]["mean"] > 1
        # every forward was a power-of-two bucket (the warmup's too)
        assert set(dispatched) <= {1, 2, 4, 8}

    def test_overload_rejects_instead_of_queueing(self):
        def slow_forward(x):
            time.sleep(0.05)
            return x

        mb = MicroBatcher(slow_forward, max_batch=2, queue_depth=2,
                          batch_wait_s=0.0, deadline_s=10.0,
                          sample_shape=(3,), name="mb_t2").start()
        outcomes = {"ok": 0, "over": 0}
        lock = threading.Lock()

        def client():
            try:
                mb.submit(numpy.zeros((1, 3), numpy.float32))
                with lock:
                    outcomes["ok"] += 1
            except Overloaded as e:
                assert e.retry_after > 0
                with lock:
                    outcomes["over"] += 1

        threads = [threading.Thread(target=client) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        mb.stop()
        assert outcomes["ok"] + outcomes["over"] == 16
        assert outcomes["over"] > 0
        assert mb.metrics.snapshot()["rejected"] == outcomes["over"]

    def test_deadline_sheds_stale_requests(self):
        def slow_forward(x):
            time.sleep(0.08)
            return x

        mb = MicroBatcher(slow_forward, max_batch=1, queue_depth=32,
                          batch_wait_s=0.0, deadline_s=0.02,
                          sample_shape=(2,), name="mb_t3").start()
        shed = []

        def client():
            try:
                mb.submit(numpy.zeros((1, 2), numpy.float32))
            except DeadlineExceeded:
                shed.append(1)

        threads = [threading.Thread(target=client) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        mb.stop()
        assert shed
        assert mb.metrics.snapshot()["shed"] == len(shed)

    def test_oversized_request_chunks(self):
        mb = MicroBatcher(lambda x: x + 1, max_batch=4,
                          sample_shape=(2,), name="mb_t4").start()
        out = mb.submit(numpy.zeros((10, 2), numpy.float32))
        mb.stop()
        assert out.shape == (10, 2)
        assert (out == 1).all()

    @pytest.mark.parametrize("max_batch", [1, 2, 6, 8, 32, 100])
    def test_bucket_ladder_equals_the_reference(self, max_batch):
        assert batch_buckets(max_batch) == jax_batch_buckets(max_batch)

    def test_stopped_batcher_refuses(self):
        mb = MicroBatcher(lambda x: x, max_batch=2, name="mb_t5")
        with pytest.raises(RuntimeError, match="not running"):
            mb.submit(numpy.zeros((1, 2), numpy.float32))
        with pytest.raises(ValueError):
            MicroBatcher(lambda x: x, max_batch=0)


class TestBatchedHTTP:
    def _api(self, forward, **knobs):
        api = RESTfulAPI(None, forward=forward)
        api.enable_batching(metrics=ServingMetrics("http_t"), **knobs)
        return api.start(port=0)

    def test_threaded_load_correct_and_coalesced(self):
        def forward(x):
            time.sleep(0.004)
            return x * 2.0

        api = self._api(forward, max_batch=8, batch_wait_s=0.01,
                        sample_shape=(4,))
        try:
            summary = run_load(
                "http://127.0.0.1:%d/predict" % api.port,
                payload=None, clients=8, requests_per_client=5,
                payload_fn=lambda ci, n: {
                    "input": [[float(ci * 10 + n)] * 4]})
            assert summary["ok"] == summary["sent"] == 40
            got = set()
            for r in summary["responses"]:
                assert r["output"][0] == [r["output"][0][0]] * 4
                got.add(r["output"][0][0])
            assert got == {2.0 * (ci * 10 + n)
                           for ci in range(8) for n in range(5)}
            snap = json.loads(_get(api.port, "/metrics.json")[0])
            assert snap["requests"] == 40
            assert snap["dispatches"] < snap["requests"]
            assert snap["batch_size"]["mean"] > 1
            assert snap["responses"] == 40
            assert snap["latency"]["p50"] > 0
            text, headers = _get(api.port, "/metrics")
            assert headers["Content-Type"].startswith("text/plain")
            assert "http_t" in text
            status, _ = _get(api.port, "/status")
            assert "[engine http_t]" in status and "responses 40" in status
        finally:
            api.stop()

    def test_burst_of_connections_waits_in_the_backlog(self):
        """32 clients connect at once while the server's accept loop is
        held in its first request: the listen backlog holds them all
        (the default of 5 overflows, and a host that aborts on overflow
        resets the rest), and every one is answered."""
        api = RESTfulAPI(None, forward=lambda x: x + 1.0).start(port=0)
        assert api._server.request_queue_size >= 32
        release = threading.Event()
        process = api._server.process_request

        def held(request, address):
            release.wait(10)
            process(request, address)
        api._server.process_request = held
        replies = []

        def client():
            replies.append(_post(api.port, {"input": [[1.0]]})[0]["output"])
        threads = [threading.Thread(target=client) for _ in range(32)]
        try:
            for t in threads:
                t.start()
            time.sleep(0.3)
            release.set()
            for t in threads:
                t.join(timeout=60)
        finally:
            release.set()
            api.stop()
        assert not any(t.is_alive() for t in threads)
        assert replies == [[[2.0]]] * 32

    def test_overload_yields_429_with_integer_retry_after(self):
        def slow_forward(x):
            time.sleep(0.05)
            return x

        api = self._api(slow_forward, max_batch=1, queue_depth=1,
                        batch_wait_s=0.0, deadline_s=10.0,
                        sample_shape=(2,))
        try:
            rejected = []

            def client():
                try:
                    _post(api.port, {"input": [[0.0, 0.0]]})
                except urllib.error.HTTPError as e:
                    rejected.append((e.code, e.headers.get("Retry-After"),
                                     json.loads(e.read())))

            threads = [threading.Thread(target=client) for _ in range(12)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert rejected
            for code, header, body in rejected:
                assert code == 429
                assert header == str(int(header)) and int(header) >= 1
                assert body["retry_after"] > 0
        finally:
            api.stop()

    def test_deadline_shed_is_503(self):
        def slow_forward(x):
            time.sleep(0.1)
            return x

        api = self._api(slow_forward, max_batch=1, queue_depth=16,
                        batch_wait_s=0.0, deadline_s=0.02,
                        sample_shape=(2,))
        try:
            codes = []

            def client():
                try:
                    _post(api.port, {"input": [[0.0, 0.0]]})
                    codes.append(200)
                except urllib.error.HTTPError as e:
                    codes.append((e.code, e.headers.get("Retry-After")))
                    e.read()

            threads = [threading.Thread(target=client) for _ in range(6)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert (503, "1") in codes
        finally:
            api.stop()

    def test_malformed_request_fails_alone(self):
        def forward(x):
            time.sleep(0.005)
            return x * 2.0

        api = self._api(forward, max_batch=8, batch_wait_s=0.02,
                        sample_shape=(4,))
        try:
            results = {"ok": [], "bad": []}
            lock = threading.Lock()

            def good(v):
                out, _ = _post(api.port, {"input": [[v] * 4]})
                with lock:
                    results["ok"].append(out["output"][0][0] == 2 * v)

            def bad():
                try:
                    _post(api.port, {"input": [[1.0] * 5]})
                except urllib.error.HTTPError as e:
                    with lock:
                        results["bad"].append(
                            (e.code, json.loads(e.read())))

            threads = [threading.Thread(target=good, args=(float(i),))
                       for i in range(4)] + \
                      [threading.Thread(target=bad) for _ in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert results["ok"] == [True] * 4
            assert len(results["bad"]) == 2
            for code, body in results["bad"]:
                assert code == 400 and "sample shape" in body["error"]
        finally:
            api.stop()

    def test_bad_first_request_does_not_poison_shape(self):
        def forward(x):
            if x.shape[1] != 4:
                raise RuntimeError("bad width %d" % x.shape[1])
            return x * 2.0

        api = RESTfulAPI(None, forward=forward)
        api.batcher = MicroBatcher(forward, max_batch=4,
                                   metrics=ServingMetrics("poison_t"))
        api.metrics = api.batcher.metrics
        api.start(port=0)
        try:
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(api.port, {"input": [[1.0] * 5]})
            assert err.value.code == 500
            out, _ = _post(api.port, {"input": [[3.0] * 4]})
            assert out["output"][0] == [6.0] * 4
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(api.port, {"input": [[1.0] * 5]})
            assert err.value.code == 400
            assert "sample shape" in json.loads(err.value.read())["error"]
        finally:
            api.stop()

    def test_malformed_content_length_is_400(self):
        import http.client
        api = self._api(lambda x: x, max_batch=2, sample_shape=(2,))
        try:
            conn = http.client.HTTPConnection("127.0.0.1", api.port,
                                              timeout=10)
            conn.putrequest("POST", "/predict")
            conn.putheader("Content-Length", "abc")
            conn.putheader("Content-Type", "application/json")
            conn.endheaders()
            resp = conn.getresponse()
            body = json.loads(resp.read())
            assert resp.status == 400 and "Content-Length" in body["error"]
            conn.close()
        finally:
            api.stop()

    def test_structured_errors(self):
        api = self._api(lambda x: x, max_batch=2, sample_shape=(2,))
        api.max_body = 200
        try:
            port = api.port

            def post_raw(body, path="/predict"):
                req = urllib.request.Request(
                    "http://127.0.0.1:%d%s" % (port, path), data=body,
                    headers={"Content-Type": "application/json"})
                with pytest.raises(urllib.error.HTTPError) as err:
                    urllib.request.urlopen(req, timeout=10)
                return err.value.code, json.loads(err.value.read())

            code, body = post_raw(b"this is not json")
            assert code == 400 and "error" in body
            code, body = post_raw(b"{}")                # no "input"
            assert code == 400 and "error" in body
            code, body = post_raw(b'{"input": [[0.0, 0.0]]}',
                                  path="/nope")
            assert code == 404 and "error" in body
            huge = json.dumps(
                {"input": [[0.0, 0.0]] * 100}).encode()
            assert len(huge) > api.max_body
            code, body = post_raw(huge)
            assert code == 413 and "error" in body
            with pytest.raises(urllib.error.HTTPError) as err:
                _get(port, "/nope")
            assert err.value.code == 404
        finally:
            api.stop()
