"""The port's Snapshotter on the CPU: the reference's snapshot tests
(``tests/test_snapshot.py``, ``tests/test_failure_recovery.py``) on the
port, and a reference snapshot carried across and resumed in the port.

Tolerances: a resumed port run equals the uninterrupted port run bit for
bit (graph loop and epoch scan).  A reference snapshot resumed in the
port ends within 1e-5 absolute of the reference's own uninterrupted run,
``n_err`` equal: the packages' CPU GEMMs sum in different orders
(``tests/test_torch_mnist.py``'s tolerance, over the same steps).
"""

import glob
import gzip
import os
import pickle

import numpy
import pytest
import torch

from veles_tpu_torch import prng, snapshotter
from veles_tpu_torch.config import root
from veles_tpu_torch.epoch_driver import EpochScanDriver
from veles_tpu_torch.launcher import Launcher
from veles_tpu_torch.samples import mnist


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    root.__dict__.pop("mnist", None)
    prng.reset()


def _configure(cfg_root, max_epochs=3, n_train=200, n_valid=64, mb=64,
               normalization=None):
    cfg_root.__dict__.pop("mnist", None)
    loader = {"minibatch_size": mb, "n_train": n_train, "n_valid": n_valid}
    if normalization:
        loader["normalization_type"] = normalization
    cfg_root.mnist.update({
        "loader": loader,
        "decision": {"max_epochs": max_epochs, "fail_iterations": 50},
        "layers": [
            {"type": "all2all_tanh", "output_sample_shape": 32,
             "learning_rate": 0.05, "momentum": 0.9},
            {"type": "softmax", "output_sample_shape": 10,
             "learning_rate": 0.05, "momentum": 0.9},
        ],
    })


def _seeded(seed=1):
    prng.reset()
    prng.seed_all(seed)


def _weights(wf):
    wf._fused_runner.sync_to_units()
    return [numpy.array(v.mem) for f, g in zip(wf.forwards, wf.gds)
            for v in (f.weights, f.bias, g.velocity_weights,
                      g.velocity_bias)]


@pytest.mark.parametrize("comp", ["", "gz", "bz2", "xz"])
def test_snapshot_compressions(tmp_path, comp):
    _seeded()
    _configure(root, max_epochs=1)
    wf = mnist.build(snapshotter_config={"directory": str(tmp_path),
                                         "compression": comp})
    wf.initialize(device="cpu")
    wf.run()
    path = wf.snapshotter.destination
    assert path.endswith(".pickle" + ("." + comp if comp else ""))
    payload = snapshotter.import_(path)
    assert payload["epoch"] == 1 and payload["format"] == 1
    w = payload["state"]["units"]["All2AllTanh"]["weights"]
    assert w[0] == "__vector__"
    numpy.testing.assert_array_equal(w[1], _weights(wf)[0])
    current = snapshotter.find_current(str(tmp_path), "mnist")
    assert os.path.basename(current) == "mnist_current" + path[
        path.index(".pickle"):]


def test_atomic_write_and_corrupt_rejection(tmp_path):
    _seeded()
    _configure(root, max_epochs=1)
    wf = mnist.build(snapshotter_config={"directory": str(tmp_path)})
    wf.initialize(device="cpu")
    wf.run()
    path = wf.snapshotter.destination
    assert not glob.glob(str(tmp_path / "*.tmp"))
    raw = open(path, "rb").read()
    torn = str(tmp_path / "torn.pickle.gz")
    with open(torn, "wb") as f:
        f.write(raw[:len(raw) // 2])
    flipped = str(tmp_path / "flipped.pickle.gz")
    with open(flipped, "wb") as f:
        f.write(raw[:40] + bytes([raw[40] ^ 0xFF]) + raw[41:])
    alien = str(tmp_path / "alien.pickle")
    with open(alien, "wb") as f:
        pickle.dump([1, 2, 3], f)
    for bad in (torn, flipped):
        with pytest.raises(ValueError, match="corrupt"):
            snapshotter.import_(bad)
    with pytest.raises(ValueError, match="unsupported snapshot format"):
        snapshotter.import_(alien)
    with pytest.raises(FileNotFoundError):
        snapshotter.import_(str(tmp_path / "missing.pickle"))
    # the staging file of a crashed write is never resumed from
    open(str(tmp_path / "mnist_current.pickle.gz.tmp"), "wb").close()
    assert snapshotter.find_current(str(tmp_path), "mnist").endswith(
        "mnist_current.pickle.gz")


def test_restricted_unpickler_refuses_foreign_globals(tmp_path):
    class Evil:
        def __reduce__(self):
            return (os.system, ("true",))

    path = str(tmp_path / "evil.pickle.gz")
    with gzip.open(path, "wb") as f:
        pickle.dump({"format": 1, "x": Evil()}, f)
    with pytest.raises(ValueError, match="not allowed"):
        snapshotter.import_(path)
    # a reference global names the carry-across function
    from veles_tpu.normalization import LinearNormalizer
    path = str(tmp_path / "ref.pickle.gz")
    with gzip.open(path, "wb") as f:
        pickle.dump({"format": 1, "n": LinearNormalizer()}, f)
    with pytest.raises(ValueError, match="state_from_reference"):
        snapshotter.import_(path)


def test_keep_last_prunes_and_skip_gates(tmp_path):
    _seeded()
    _configure(root, max_epochs=4)
    other = tmp_path / "mnist_big_1_0.pickle.gz"
    other.write_bytes(b"x")
    wf = mnist.build(snapshotter_config={"directory": str(tmp_path),
                                         "keep_last": 2})
    wf.initialize(device="cpu")
    wf.run()
    epochs = sorted(int(os.path.basename(p).split("_")[1])
                    for p in glob.glob(str(tmp_path / "mnist_[0-9]*")))
    assert epochs == [3, 4]
    assert other.exists()
    assert os.path.exists(str(tmp_path / "mnist_current.pickle.gz"))
    # a skipped snapshotter writes nothing, not even at completion
    skipped = tmp_path / "skipped"
    _seeded()
    wf = mnist.build(snapshotter_config={"directory": str(skipped)})
    wf.initialize(device="cpu")
    wf.snapshotter.skip.set(True)
    wf.run()
    assert not skipped.exists()


def test_resume_restores_decision_history(tmp_path):
    _seeded()
    _configure(root, max_epochs=2)
    wf = mnist.train(snapshotter_config={"directory": str(tmp_path)},
                     device="cpu")
    payload = snapshotter.import_(wf.snapshotter.destination)
    _seeded()
    fresh = mnist.build()
    fresh.initialize(device="cpu")
    snapshotter.restore(fresh, payload)
    assert fresh.decision.best_metric == wf.decision.best_metric
    assert fresh.decision.best_epoch == wf.decision.best_epoch
    assert len(fresh.decision.epoch_metrics) == 2
    assert bool(fresh.decision.complete)
    # a raised epoch limit reopens the completed run (fine-tuning)
    _configure(root, max_epochs=3)
    longer = mnist.build()
    longer.initialize(device="cpu")
    snapshotter.restore(longer, payload)
    assert not bool(longer.decision.complete)


@pytest.mark.parametrize("scan", [0, 1])
def test_resume_equivalence(tmp_path, scan):
    """A run resumed from its epoch-1 snapshot through ``--snapshot
    auto`` ends bit-equal to the uninterrupted 3-epoch run, on the graph
    loop and on the epoch scan (loader plan and cursor, PRNG streams,
    train-step counter and decision history all restored)."""
    _seeded()
    _configure(root, max_epochs=3)
    straight = mnist.build(snapshotter_config={"directory": str(tmp_path)})
    Launcher(straight, stats=False, epoch_scan=scan, device="cpu").boot()
    first = glob.glob(str(tmp_path / "mnist_1_*.pickle.gz"))
    assert len(first) == 1
    resumed_dir = tmp_path / "resumed"
    resumed_dir.mkdir()
    with open(first[0], "rb") as src, \
            open(str(resumed_dir / "mnist_current.pickle.gz"), "wb") as dst:
        dst.write(src.read())
    _seeded()
    resumed = mnist.build(snapshotter_config={
        "directory": str(resumed_dir)})
    launcher = Launcher(resumed, stats=False, epoch_scan=scan,
                        snapshot="auto", device="cpu")
    launcher.boot()
    assert launcher.restored_payload["epoch"] == 1
    assert int(resumed.loader.epoch_number) == 3
    assert resumed.fused_step.train_steps == straight.fused_step.train_steps
    for a, b in zip(_weights(straight), _weights(resumed)):
        numpy.testing.assert_array_equal(a, b)
    assert [m["validation"]["loss"] for m in
            resumed.decision.epoch_metrics] == [
        m["validation"]["loss"] for m in straight.decision.epoch_metrics]


def test_deferred_normalizer_restored_from_snapshot(tmp_path):
    """A loader with no train data defers its normalizer: running it
    raises until a snapshot delivers the fitted one."""
    _seeded()
    _configure(root, max_epochs=1, normalization="mean_disp")
    trained = mnist.train(snapshotter_config={"directory": str(tmp_path)},
                          device="cpu")
    fitted = trained.loader.normalizer
    assert fitted.is_fitted
    _seeded()
    _configure(root, max_epochs=1, n_train=0, normalization="mean_disp")
    serve = mnist.build()
    serve.initialize(device="cpu")
    raw = numpy.array(serve.loader.original_data.mem)
    with pytest.raises(ValueError, match="unfitted"):
        serve.loader.run()
    payload = snapshotter.import_(trained.snapshotter.destination)
    serve.loader.load_state_dict(
        payload["state"]["units"][serve.loader.name])
    numpy.testing.assert_array_equal(serve.loader.original_data.mem,
                                     fitted.apply(raw))
    serve.loader.run()


@pytest.mark.parametrize("scan", [0, 1])
def test_reference_snapshot_resumed_in_port(tmp_path, scan):
    """The reference trains 3 epochs with a fitted normalizer, writing a
    snapshot an epoch; its epoch-2 snapshot, read by the reference and
    carried across with ``state_from_reference``, resumes in the port
    (graph loop or epoch scan), which reaches the reference's final
    state."""
    from veles_tpu import prng as jax_prng, snapshotter as jax_snap
    from veles_tpu.config import root as jax_root
    from veles_tpu.samples import mnist as jax_mnist
    saved = jax_root.__dict__.pop("mnist", None)
    try:
        jax_prng.reset()
        jax_prng.seed_all(1)
        _configure(jax_root, max_epochs=3, normalization="linear")
        ref = jax_mnist.train(snapshotter_config={
            "directory": str(tmp_path)})
        ref._fused_runner.sync_to_units()
        ref_w = [numpy.asarray(f.weights.mem) for f in ref.forwards]
        ref_err = [m["validation"]["n_err"]
                   for m in ref.decision.epoch_metrics]
        mid = glob.glob(str(tmp_path / "mnist_2_*.pickle.gz"))
        assert len(mid) == 1
        state = jax_snap.import_(mid[0])["state"]
    finally:
        jax_root.__dict__.pop("mnist", None)
        if saved is not None:
            jax_root.__dict__["mnist"] = saved
        jax_prng.reset()
    with pytest.raises(ValueError, match="state_from_reference"):
        snapshotter.import_(mid[0])
    carried = snapshotter.state_from_reference(state)
    from veles_tpu_torch.normalization import LinearNormalizer
    assert isinstance(carried["units"]["loader"]["normalizer"],
                      LinearNormalizer)
    _seeded()
    _configure(root, max_epochs=3, normalization="linear")
    port = mnist.build()
    port.initialize(device="cpu")
    port.load_snapshot_state(carried)
    assert int(port.loader.epoch_number) == 2
    if scan:
        EpochScanDriver(port).run()
    else:
        port.run()
    assert [m["validation"]["n_err"]
            for m in port.decision.epoch_metrics] == ref_err
    for f, w in zip(port.forwards, ref_w):
        numpy.testing.assert_allclose(f.weights.mem, w, rtol=0, atol=1e-5)
