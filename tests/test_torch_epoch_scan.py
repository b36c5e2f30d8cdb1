"""The port's epoch-scan driver, gradient accumulation and step operands
on the CPU, where the captured step's functions run eagerly.

What is held, and how closely:

- the scan at chunk 1 equals the port's graph loop bit for bit (final
  weights and velocities, every epoch's metrics, the train-step
  counter), on a train set that is not a multiple of the minibatch (a
  short last minibatch: the inv_batch operand must follow it), with a
  test set, an adaptive solver and lr policies; chunk 2 and 3 equal
  chunk 1; completion mid-chunk and at a chunk's end drop the stopping
  epoch's last update as the graph loop does;
- a dropout network's scan keys are the reference's scan keys: its
  final weights equal the reference's epoch scan within 1e-5 absolute
  (the two packages' CPU GEMMs sum in different orders;
  ``tests/test_torch_mnist.py``), validation ``n_err`` equal;
- ``grad_accum``: ``tests/test_grad_accum.py``'s cases on the port (the
  accumulated step within rtol 1e-5 / atol 1e-6 of the monolithic one,
  runs with equal ``n_err`` and losses within 1e-5 relative, ``*_max``
  metrics by maximum), the port's accumulated step against the
  reference's (1e-5 absolute), and the scan running it bit-equal to the
  loop;
- streaming: windows of any size and stage-ahead equal the chunked
  scan bit for bit; a record file streams (bare ``--epoch-scan``
  included) bit-equal to the graph loop; the refusals of the reference.
"""

import numpy
import pytest
import torch

from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.epoch_driver import EpochScanDriver
from veles_tpu_torch.launcher import Launcher
from veles_tpu_torch.samples import mnist

TANH_SOFTMAX = [
    {"type": "all2all_tanh", "output_sample_shape": 16,
     "learning_rate": 0.03, "momentum": 0.9},
    {"type": "softmax", "output_sample_shape": 10, "learning_rate": 0.03,
     "momentum": 0.9}]


@pytest.fixture(autouse=True)
def _fresh():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    root.__dict__.pop("mnist", None)
    yield
    root.__dict__.pop("mnist", None)
    torch.set_num_threads(threads)


def _build(layers=TANH_SOFTMAX, max_epochs=3, seed=7, n_train=230,
           n_valid=70, mb=50, fail_iterations=50, **kw):
    prng.reset()
    prng.seed_all(seed)
    root.__dict__.pop("mnist", None)
    root.mnist.update({
        "loader": {"minibatch_size": mb, "n_train": n_train,
                   "n_valid": n_valid},
        "decision": {"max_epochs": max_epochs,
                     "fail_iterations": fail_iterations},
        "layers": [dict(layer) for layer in layers]})
    return mnist.build(fused=True, **kw)


def _run(wf, **kw):
    Launcher(wf, stats=False, device="cpu", **kw).boot()
    return wf


def _state(wf):
    return [numpy.array(v.mem) for f, g in zip(wf.forwards, wf.gds)
            if f.has_params for v in (f.weights, f.bias, g.velocity_weights,
                                      g.velocity_bias)]


def _assert_same_run(a, b):
    assert a.fused_step.train_steps == b.fused_step.train_steps
    assert len(a.decision.epoch_metrics) == len(b.decision.epoch_metrics)
    for ma, mb in zip(a.decision.epoch_metrics, b.decision.epoch_metrics):
        assert list(ma) == list(mb)
        for set_name in ma:
            for key in ("n_err", "count", "loss"):
                assert ma[set_name][key] == mb[set_name][key]
            numpy.testing.assert_array_equal(ma[set_name]["confusion"],
                                             mb[set_name]["confusion"])
    assert a.decision.best_epoch == b.decision.best_epoch
    for x, y in zip(_state(a), _state(b)):
        numpy.testing.assert_array_equal(x, y)


ADAM_POLICY = [
    {"type": "all2all_tanh", "output_sample_shape": 16,
     "learning_rate": 0.01, "solver": "adam"},
    {"type": "softmax", "output_sample_shape": 10, "learning_rate": 0.03,
     "momentum": 0.9, "lr_policy": {"policy": "exp", "gamma": 0.95}}]


@pytest.mark.parametrize("layers", [TANH_SOFTMAX, ADAM_POLICY],
                         ids=["momentum", "adam_and_policy"])
def test_chunk1_equals_graph_loop(layers):
    _assert_same_run(_run(_build(layers)), _run(_build(layers),
                                                epoch_scan=1))


@pytest.mark.parametrize("chunk", [2, 3])
def test_chunked_equals_chunk1(chunk):
    _assert_same_run(_run(_build(max_epochs=4), epoch_scan=1),
                     _run(_build(max_epochs=4), epoch_scan=chunk))


@pytest.mark.parametrize("max_epochs,chunk", [(3, 2), (4, 2), (5, 3)])
def test_completion_gate_parity(max_epochs, chunk):
    """Completion inside a chunk (replayed from the chunk's kept input)
    and at a chunk's end (the state before the last step is the other
    buffer): the stopping epoch's last update is dropped either way."""
    loop = _run(_build(max_epochs=max_epochs))
    scan = _run(_build(max_epochs=max_epochs), epoch_scan=chunk)
    _assert_same_run(loop, scan)
    assert int(scan.loader.epoch_number) == max_epochs


def test_test_set_metrics_equal_graph_loop():
    from veles_tpu_torch.loader.fullbatch import FullBatchLoader
    from veles_tpu_torch.standard_workflow import StandardWorkflow

    class ThreeSetLoader(FullBatchLoader):
        def load_data(self):
            r = numpy.random.RandomState(4)
            protos = r.uniform(-1, 1, (10, 20)).astype(numpy.float32)
            labels = (numpy.arange(250) % 10).astype(numpy.int32)
            data = (protos[labels]
                    + r.normal(0, .5, (250, 20)).astype(numpy.float32))
            self.original_data.reset(data)
            self.original_labels.reset(labels)
            self.class_lengths = [50, 80, 120]

    def build():
        prng.reset()
        prng.seed_all(11)
        return StandardWorkflow(
            None, name="threeset", loader_factory=ThreeSetLoader,
            loader_config={"minibatch_size": 25},
            decision_config={"max_epochs": 3, "fail_iterations": 5},
            layers=[{"type": "softmax", "output_sample_shape": 10,
                     "learning_rate": 0.05}])

    loop, scan = _run(build()), _run(build(), epoch_scan=2)
    assert set(scan.decision.epoch_metrics[0]) == {"test", "validation",
                                                   "train"}
    _assert_same_run(loop, scan)


DROPOUT = [
    {"type": "all2all_tanh", "output_sample_shape": 32,
     "learning_rate": 0.03, "momentum": 0.9},
    {"type": "dropout", "dropout_ratio": 0.3},
    {"type": "softmax", "output_sample_shape": 10, "learning_rate": 0.03,
     "momentum": 0.9}]


@pytest.mark.parametrize("chunk", [1, 2])
def test_dropout_scan_matches_reference_scan(chunk):
    """The scan's keys: one key a chunk, folded with the epoch's first
    step, the step, the layer — the reference's scan, so the weights
    agree with the reference's epoch scan (not with either graph
    loop)."""
    from veles_tpu import prng as jax_prng
    from veles_tpu.config import root as jax_root
    from veles_tpu.launcher import Launcher as JaxLauncher
    from veles_tpu.samples import mnist as jax_mnist
    saved = jax_root.__dict__.pop("mnist", None)
    try:
        jax_prng.reset()
        jax_prng.seed_all(5)
        jax_root.mnist.update({
            "loader": {"minibatch_size": 50, "n_train": 230,
                       "n_valid": 70},
            "decision": {"max_epochs": 3, "fail_iterations": 50},
            "layers": [dict(layer) for layer in DROPOUT]})
        ref = jax_mnist.build(fused=True)
        JaxLauncher(ref, stats=False, epoch_scan=chunk).boot()
        ref_w = [numpy.asarray(f.weights.mem) for f in ref.forwards
                 if f.has_params]
        ref_err = [m["validation"]["n_err"]
                   for m in ref.decision.epoch_metrics]
    finally:
        jax_root.__dict__.pop("mnist", None)
        if saved is not None:
            jax_root.__dict__["mnist"] = saved
        jax_prng.reset()
    port = _run(_build(DROPOUT, seed=5), epoch_scan=chunk)
    assert [m["validation"]["n_err"]
            for m in port.decision.epoch_metrics] == ref_err
    for f, w in zip([f for f in port.forwards if f.has_params], ref_w):
        numpy.testing.assert_allclose(f.weights.mem, w, rtol=0, atol=1e-5)
    # and the scan's keys differ from the graph loop's
    loop = _run(_build(DROPOUT, seed=5))
    assert not numpy.array_equal(loop.forwards[0].weights.mem,
                                 port.forwards[0].weights.mem)


# ------------------------------------------------------------ grad_accum
def _batch(rng, n=64):
    x = rng.randn(n, 784).astype(numpy.float32)
    labels = rng.randint(0, 10, n).astype(numpy.int32)
    return x, labels, numpy.ones(n, numpy.float32)


def test_accum_step_matches_monolithic():
    x, labels, mask = _batch(numpy.random.RandomState(3))
    out = []
    for accum in (1, 4):
        wf = _build(layers=[dict(TANH_SOFTMAX[0], output_sample_shape=32),
                            TANH_SOFTMAX[1]], mb=64, n_train=256,
                    n_valid=64, grad_accum=accum)
        wf.initialize(device="cpu")
        runner = wf._fused_runner
        assert runner.grad_accum == accum
        out.append(runner._train_step(runner.state, torch.as_tensor(x),
                                      torch.as_tensor(labels),
                                      torch.as_tensor(mask), 64))
    (s1, m1), (s4, m4) = out
    assert int(m1["n_err"]) == int(m4["n_err"])
    numpy.testing.assert_allclose(float(m1["loss_sum"]),
                                  float(m4["loss_sum"]), rtol=1e-5)
    for ea, eb in zip(s1, s4):
        for key in ea:
            numpy.testing.assert_allclose(ea[key].numpy(), eb[key].numpy(),
                                          rtol=1e-5, atol=1e-6)


def test_accum_step_matches_reference_accum():
    import jax.numpy as jnp
    from veles_tpu import prng as jax_prng
    from veles_tpu.config import root as jax_root
    from veles_tpu.samples import mnist as jax_mnist
    x, labels, mask = _batch(numpy.random.RandomState(4))
    layers = [dict(TANH_SOFTMAX[0], output_sample_shape=32),
              TANH_SOFTMAX[1]]
    saved = jax_root.__dict__.pop("mnist", None)
    try:
        jax_prng.reset()
        jax_prng.seed_all(7)
        jax_root.mnist.update({
            "loader": {"minibatch_size": 64, "n_train": 256,
                       "n_valid": 64},
            "decision": {"max_epochs": 2, "fail_iterations": 50},
            "layers": layers})
        ref = jax_mnist.build(fused=True, grad_accum=4)
        ref.initialize()
        r = ref._fused_runner
        want, _ = r._train(r.state, x, labels, mask,
                           jnp.asarray(60, jnp.int32), None,
                           jnp.asarray(0, jnp.int32))
        want = [{k: numpy.asarray(v) for k, v in e.items()} for e in want]
    finally:
        jax_root.__dict__.pop("mnist", None)
        if saved is not None:
            jax_root.__dict__["mnist"] = saved
        jax_prng.reset()
    wf = _build(layers=layers, mb=64, n_train=256, n_valid=64, grad_accum=4)
    wf.initialize(device="cpu")
    runner = wf._fused_runner
    got, _ = runner._train_step(runner.state, torch.as_tensor(x),
                                torch.as_tensor(labels),
                                torch.as_tensor(mask), 60)
    for g, w in zip(got, want):
        for key in w:
            numpy.testing.assert_allclose(g[key].numpy(), w[key], rtol=0,
                                          atol=1e-5)


def test_training_run_identical_with_accum():
    finals = []
    for accum in (1, 2):
        wf = _build(mb=64, n_train=256, n_valid=64, max_epochs=2,
                    grad_accum=accum)
        wf.initialize(device="cpu")
        wf.run()
        finals.append(wf.decision.epoch_metrics[-1]["validation"])
    assert finals[0]["n_err"] == finals[1]["n_err"]
    assert finals[0]["loss"] == pytest.approx(finals[1]["loss"], rel=1e-5)


def test_indivisible_minibatch_raises():
    wf = _build(mb=50, grad_accum=4)
    wf.initialize(device="cpu")
    runner = wf._fused_runner
    with pytest.raises(ValueError, match="divisible"):
        runner._train_step(runner.state, torch.zeros(50, 784),
                           torch.zeros(50, dtype=torch.int32),
                           torch.ones(50), 50)


def test_mse_max_metric_not_summed():
    from veles_tpu_torch.samples import mnist_ae
    outs = []
    for accum in (1, 4):
        prng.reset()
        prng.seed_all(5)
        root.__dict__.pop("mnist_ae", None)
        mnist_ae.default_config()
        root.mnist_ae.update({
            "loader": {"minibatch_size": 40, "n_train": 80, "n_valid": 40},
            "decision": {"max_epochs": 1, "fail_iterations": 10}})
        wf = mnist_ae.build(fused=True, grad_accum=accum)
        wf.initialize(device="cpu")
        runner = wf._fused_runner
        x = torch.as_tensor(numpy.asarray(wf.loader.original_data.mem[:40]))
        _, m = runner._train_step(runner.state, x, x, torch.ones(40), 40)
        outs.append({k: float(v) for k, v in m.items() if v.dim() == 0})
    root.__dict__.pop("mnist_ae", None)
    assert outs[0]["rmse_max"] == pytest.approx(outs[1]["rmse_max"],
                                                rel=1e-5)
    assert outs[0]["mse_sum"] == pytest.approx(outs[1]["mse_sum"], rel=1e-5)


@pytest.mark.parametrize("layers", [TANH_SOFTMAX, DROPOUT],
                         ids=["deterministic", "dropout"])
def test_scan_runs_accum_like_the_loop(layers):
    """The scan's operand tables hold every microbatch's keys: with no
    stochastic layer it equals the loop; with dropout it repeats."""
    a = _run(_build(layers, mb=50, grad_accum=5), epoch_scan=1)
    b = _run(_build(layers, mb=50, grad_accum=5),
             epoch_scan=1 if layers is DROPOUT else 0)
    _assert_same_run(a, b)


# ------------------------------------------------------------- streaming
@pytest.mark.parametrize("window,ahead", [(1, 1), (2, 2), (3, 1), (5, 1)])
def test_streaming_equals_chunked(window, ahead):
    chunked = _run(_build(), epoch_scan=1)
    streamed = _run(_build(), stream_window=window, stage_ahead=ahead)
    _assert_same_run(chunked, streamed)
    stats = streamed._stream_stats
    assert stats["epochs"] == 3 and stats["window_minibatches"] == window
    assert stats["windows"] == 3 * -(-5 // window)
    # one dispatch a graph replay: 5 train steps and 2 validation
    # minibatches an epoch
    assert stats["dispatches"] == 3 * (5 + 2)
    assert stats["train_samples"] == 3 * 230
    assert 0.0 <= stats["staging_stall_fraction"] <= 1.0


def _records_workflow(path, seed=21, max_epochs=3, **loader):
    from veles_tpu_torch.loader.records import RecordsLoader
    from veles_tpu_torch.standard_workflow import StandardWorkflow
    prng.reset()
    prng.seed_all(seed)
    return StandardWorkflow(
        None, name="stream_test", loader_factory=RecordsLoader,
        loader_config=dict(minibatch_size=16, path=path, **loader),
        layers=[{"type": "all2all_tanh", "output_sample_shape": 12,
                 "learning_rate": 0.05, "momentum": 0.9},
                {"type": "softmax", "output_sample_shape": 5,
                 "learning_rate": 0.05, "momentum": 0.9}],
        decision_config={"max_epochs": max_epochs, "fail_iterations": 10})


def test_records_stream_equal_graph_loop(tmp_path):
    from veles_tpu_torch.loader.records import write_records
    rng = numpy.random.RandomState(3)
    data = rng.normal(0, 1, (190, 8)).astype(numpy.float32)
    labels = (numpy.arange(190) % 5).astype(numpy.int32)
    path = write_records(str(tmp_path / "s.rec"), data, labels,
                         [0, 40, 150])
    loop = _run(_records_workflow(path))
    for kw in ({"stream_window": 4}, {"stream_window": 3,
                                      "stage_ahead": 2},
               {"epoch_scan": 1}):
        wf = _records_workflow(path)
        launcher = Launcher(wf, stats=False, device="cpu", **kw)
        launcher.boot()
        assert launcher.driver.streaming
        _assert_same_run(loop, wf)
    # a record window is the per-minibatch fill, bit for bit
    wf = _records_workflow(path)
    wf.initialize(device="cpu")
    idx = numpy.array([45, 3, 160, 7], numpy.int32)
    x, y = wf.loader.gather_window(idx)
    numpy.testing.assert_array_equal(x, data[idx])
    numpy.testing.assert_array_equal(y, labels[idx])


def test_driver_refusals():
    wf = _build(max_epochs=1)
    with pytest.raises(ValueError, match="fused"):
        EpochScanDriver(mnist.build(fused=False))
    wf.initialize(device="cpu")
    wf.decision.__class__ = type("Other", (object,), {})
    with pytest.raises(ValueError, match="DecisionGD"):
        EpochScanDriver(wf)
    no_valid = _build(n_valid=0)
    no_valid.initialize(device="cpu")
    with pytest.raises(ValueError, match="validation"):
        EpochScanDriver(no_valid)
    from veles_tpu_torch.loader.base import Loader
    assert not Loader.can_gather_windows.fget(
        type("L", (Loader,), {})(None))
