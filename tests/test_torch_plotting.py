"""The port's plotters (``plotter``, ``plotting_units``,
``nn_plotting_units``, ``StandardWorkflow.link_plotters``), the ZeroMQ
graphics transport and the Shell unit, against the JAX package on the
CPU.

What is held, and how closely:

- unit level, exactly: the same decision metrics, forward weights, SOM
  hits and MSE error outputs through both packages' plotter units give
  equal specs (keys, types, dtypes, values), every array a numpy array;
- renders: ``render_spec`` of each kind gives PNGs whose decoded pixels
  are equal in both packages; an unknown kind raises in both;
- transport: the port's server feeds the reference's client and the
  reference's server feeds the port's (specs hold no class of either
  package), the end-of-stream ``None`` ends a client, and the client's
  CLI renders; a spec is resent until the subscriber has joined, so no
  test waits a fixed time;
- end to end: the same seeded tiny MNIST run (``tests/test_torch_mnist.py``'s
  size) with ``link_plotters`` in both packages, graph loop and epoch
  scan: kinds, names and counts equal, the ``n_err`` curve and the
  confusion matrices equal, the loss curve and the weight images within
  1e-5, the MNIST-FC weight tolerance (``tests/test_torch_mnist.py``).
  The reference's ``Weights2D`` reads the unit Vector, which a fused run
  leaves at the initial weights until its end (ROADMAP Queue 3); the
  port's reads the committed weights, so it is held against the
  reference run's committed weights (its units synced before each
  plot).  Under the epoch scan neither package's plotters fire.
"""

import os
import pickle
import threading
import time

import numpy
import pytest
import torch

from veles_tpu import prng as jax_prng
from veles_tpu.config import root as jax_root
from veles_tpu_torch import prng
from veles_tpu_torch.config import root

SEED = 42
DEADLINE_S = 20.0


@pytest.fixture(autouse=True)
def _fresh():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def same(a, b):
    """Deep equality with types: dicts, lists, numpy arrays (dtype and
    shape too) and scalars of the same type."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same(x, y) for x, y in zip(a, b)))
    if isinstance(a, numpy.ndarray):
        return (isinstance(b, numpy.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and numpy.array_equal(a, b))
    return type(a) is type(b) and a == b


def only_numpy(spec):
    """True when every array-like in ``spec`` is a numpy array or a
    plain list, never a tensor."""
    if isinstance(spec, dict):
        return all(only_numpy(v) for v in spec.values())
    if isinstance(spec, (list, tuple)):
        return all(only_numpy(v) for v in spec)
    return not isinstance(spec, torch.Tensor)


class Sink:
    """A ``graphics_server`` stand-in that keeps what it is sent."""

    def __init__(self):
        self.got = []

    def send(self, spec):
        self.got.append(spec)


class Holder:
    def __init__(self, **kw):
        self.__dict__.update(kw)


# ------------------------------------------------------------- unit level
def _metrics(rng, n_epochs=3, n_classes=4):
    out = []
    for _ in range(n_epochs):
        epoch = {}
        for set_name in ("validation", "train"):
            n_err = int(rng.randint(0, 50))
            epoch[set_name] = {
                "n_err": n_err, "count": 100, "loss": float(rng.rand()),
                "err_pct": 100.0 * n_err / 100,
                "confusion": rng.randint(0, 9, (n_classes, n_classes))
                .astype(numpy.int32)}
        out.append(epoch)
    return out


def _units(pkg):
    """The plotter unit modules and the Workflow and Vector classes of
    ``pkg`` ("veles_tpu" or "veles_tpu_torch")."""
    import importlib
    mods = {n: importlib.import_module("%s.%s" % (pkg, n)) for n in (
        "plotting_units", "nn_plotting_units", "workflow", "memory",
        "ops.decision")}
    return mods


def _spec(pkg, case, rng_seed=3):
    """The spec one plotter unit of ``pkg`` emits for ``case`` (same
    numpy inputs in both packages), through ``redraw`` into a sink."""
    rng = numpy.random.RandomState(rng_seed)
    m = _units(pkg)
    wf = m["workflow"].Workflow(None, name="wf")
    wf.graphics_server = Sink()
    vec = m["memory"].Vector
    P, N = m["plotting_units"], m["nn_plotting_units"]
    metrics = _metrics(rng)
    if case in ("curve_err", "curve_loss"):
        unit = P.AccumulatingPlotter(
            wf, metric="err_pct" if case == "curve_err" else "loss",
            name="p")
        unit.input = Holder(epoch_metrics=metrics)
    elif case == "confusion":
        cm = m["ops.decision"].DecisionGD.confusion_matrix.fget(
            Holder(epoch_metrics=metrics))
        unit = P.MatrixPlotter(wf, name="p")
        unit.input = Holder(confusion_matrix=cm)
    elif case == "histogram":
        unit = P.Histogram(wf, bins=12, name="p")
        unit.input = Holder(values=vec(rng.randn(7, 5).astype(
            numpy.float32)))
    elif case.startswith("weights"):
        shape = {"weights_dense": (784, 20), "weights_conv3": (5, 5, 3, 8),
                 "weights_conv1": (3, 3, 1, 6),
                 "weights_conv4": (3, 3, 4, 6),
                 "weights_limit": (16, 100)}[case]
        unit = N.Weights2D(wf, name="p", limit=9 if case == "weights_limit"
                           else 64)
        unit.input = Holder(weights=vec(rng.randn(*shape).astype(
            numpy.float32)), name="fc1")
    elif case.startswith("kohonen"):
        unit = N.KohonenHits(wf, name="p")
        unit.input = Holder(hits=rng.randint(0, 30, 12).astype(numpy.int64))
        if case == "kohonen_trainer":
            unit.trainer = Holder(shape=(3, 4))
        else:
            unit.input.hits = unit.input.hits[:9]
    elif case == "mse":
        unit = N.MSEHistogram(wf, bins=7, name="p")
        unit.input = Holder(err_output=vec(rng.randn(6, 4, 2).astype(
            numpy.float32)))
    unit.redraw()
    assert wf.graphics_server.got == unit.specs
    return unit.specs


CASES = ("curve_err", "curve_loss", "confusion", "histogram",
         "weights_dense", "weights_conv3", "weights_conv1", "weights_conv4",
         "weights_limit", "kohonen_trainer", "kohonen_square", "mse")


@pytest.mark.parametrize("case", CASES)
def test_unit_specs_equal_the_reference(case):
    ours, theirs = _spec("veles_tpu_torch", case), _spec("veles_tpu", case)
    assert len(ours) == len(theirs) == 1
    assert same(ours, theirs), (ours, theirs)
    assert only_numpy(ours)


def test_non_square_dense_weights_give_no_spec_in_both():
    for pkg in ("veles_tpu_torch", "veles_tpu"):
        m = _units(pkg)
        wf = m["workflow"].Workflow(None, name="wf")
        unit = m["nn_plotting_units"].Weights2D(wf, name="p")
        unit.input = Holder(weights=m["memory"].Vector(
            numpy.ones((10, 3), numpy.float32)), name="fc")
        assert unit.plot_spec() is None


def test_histogram_copies_a_tensor_off_its_device():
    from veles_tpu_torch.plotting_units import Histogram
    from veles_tpu_torch.workflow import Workflow
    wf = Workflow(None, name="wf")
    wf.graphics_server = Sink()
    unit = Histogram(wf, name="h")
    unit.input = Holder(values=torch.arange(6, dtype=torch.float32))
    unit.redraw()
    values = unit.specs[0]["values"]
    assert isinstance(values, numpy.ndarray)
    numpy.testing.assert_array_equal(values, numpy.arange(6, dtype="f4"))


def test_stop_skips_an_identical_final_spec():
    """stop() must not repeat the last plot when nothing changed, but
    must emit state that accumulated after the last redraw (the
    reference's test on the port)."""
    from veles_tpu_torch.plotter import Plotter
    from veles_tpu_torch.workflow import Workflow

    class FixedPlotter(Plotter):
        payload = [1, 2, 3]

        def plot_spec(self):
            return {"kind": "curve", "series": {"y": list(self.payload)}}

    wf = Workflow(None, name="wf")
    wf.graphics_server = Sink()
    p = FixedPlotter(wf, name="p")
    p.redraw()
    p.stop()
    assert len(p.specs) == 1
    p.payload.append(4)
    p.stop()
    assert len(p.specs) == 2 and p.specs[-1]["series"]["y"] == [1, 2, 3, 4]


def test_snapshot_keeps_history_from_aliasing_live_buffers():
    from veles_tpu_torch.nn_plotting_units import KohonenHits
    from veles_tpu_torch.workflow import Workflow
    wf = Workflow(None, name="wf")
    wf.graphics_server = Sink()
    unit = KohonenHits(wf, name="k")
    hits = numpy.zeros(4, numpy.int64)
    unit.input = Holder(hits=hits)
    unit.redraw()
    hits += 1
    unit.stop()
    assert unit.specs[0]["matrix"].sum() == 0
    assert unit.specs[1]["matrix"].sum() == 4


# ----------------------------------------------------------------- renders
RENDER_SPECS = {
    "curve": {"kind": "curve", "series": {"train": [3.0, 2.0, 1.5],
                                          "validation": [4.0, 2.5, 2.0]},
              "ylabel": "err_pct", "title": "err_pct over epochs"},
    "matrix": {"kind": "matrix", "matrix": numpy.arange(
        16, dtype=numpy.int32).reshape(4, 4), "title": "confusion"},
    "hist": {"kind": "hist", "values": numpy.linspace(
        -1, 1, 50, dtype=numpy.float32), "bins": 9},
    "image_grid": {"kind": "image_grid", "images": numpy.random.RandomState(
        0).rand(5, 6, 6).astype(numpy.float32), "title": "w"},
}


@pytest.mark.parametrize("kind", sorted(RENDER_SPECS))
def test_render_pixels_equal_the_reference(kind, tmp_path):
    from PIL import Image
    from veles_tpu.plotter import render_spec as theirs
    from veles_tpu_torch.plotter import render_spec as ours
    spec = RENDER_SPECS[kind]
    a = ours(dict(spec), str(tmp_path / "ours.png"))
    b = theirs(dict(spec), str(tmp_path / "theirs.png"))
    pa = numpy.asarray(Image.open(a).convert("RGBA"))
    pb = numpy.asarray(Image.open(b).convert("RGBA"))
    assert pa.shape == pb.shape and pa.size > 0
    numpy.testing.assert_array_equal(pa, pb)


def test_unknown_kind_raises_in_both(tmp_path):
    from veles_tpu.plotter import render_spec as theirs
    from veles_tpu_torch.plotter import render_spec as ours
    for render in (ours, theirs):
        with pytest.raises(ValueError, match="unknown plot kind 'pie'"):
            render({"kind": "pie"}, str(tmp_path / "x.png"))


# --------------------------------------------------------------- transport
def _joined(server, client, spec):
    """Send ``spec`` until ``client`` renders one (the subscriber may
    join after the first sends); returns the number sent."""
    begin, sent = time.monotonic(), 0
    while time.monotonic() - begin < DEADLINE_S:
        server.send(spec)
        sent += 1
        if client.poll_once(100):
            return sent
    raise AssertionError("no spec arrived within %g s" % DEADLINE_S)


def _drained(client):
    """Poll until the end of the stream; True when the ``None`` marker
    ended it (a timeout takes the whole 5 s)."""
    begin = time.monotonic()
    while client.poll_once(5000):
        pass
    return time.monotonic() - begin < 4.5


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_cross_package_pub_sub(direction, tmp_path):
    from veles_tpu import graphics_client as ref_client
    from veles_tpu import graphics_server as ref_server
    from veles_tpu_torch import graphics_client, graphics_server
    if direction == "port_to_reference":
        server_cls, client_cls = (graphics_server.GraphicsServer,
                                  ref_client.GraphicsClient)
    else:
        server_cls, client_cls = (ref_server.GraphicsServer,
                                  graphics_client.GraphicsClient)
    spec = _spec("veles_tpu_torch", "weights_dense")[0]
    spec["name"] = "crossing"
    assert b"veles_tpu" not in pickle.dumps(spec)
    server = server_cls("tcp://127.0.0.1:0")
    client = client_cls(server.endpoint, out_dir=str(tmp_path / "out"))
    try:
        _joined(server, client, spec)
        files = sorted(os.listdir(tmp_path / "out"))
        assert files and all(f.startswith("crossing_") for f in files)
        server.close()
        assert _drained(client)
    finally:
        client.close()


def test_graphics_client_cli_renders_until_the_end(tmp_path):
    from veles_tpu_torch import graphics_client
    from veles_tpu_torch.graphics_server import GraphicsServer
    server = GraphicsServer("tcp://127.0.0.1:0")
    out = tmp_path / "cli"
    worker = threading.Thread(target=graphics_client.main, args=(
        [server.endpoint, "--out", str(out), "--timeout", "20000"],))
    worker.start()
    begin = time.monotonic()
    while not (out.exists() and os.listdir(out)):
        assert time.monotonic() - begin < DEADLINE_S
        server.send(dict(RENDER_SPECS["curve"], name="cli"))
        time.sleep(0.05)
    server.close()
    worker.join(DEADLINE_S)
    assert not worker.is_alive()
    assert all(f.startswith("cli_") for f in os.listdir(out))


# -------------------------------------------------------------------- shell
def test_shell_skips_without_a_tty(monkeypatch):
    from veles_tpu_torch.interaction import Shell
    from veles_tpu_torch.workflow import Workflow
    wf = Workflow(None, name="wf")
    shell = Shell(wf, name="shell")
    monkeypatch.setattr("sys.stdin.isatty", lambda: False)
    called = []
    shell.interact = called.append
    shell.run()
    assert bool(shell.fired) and not called


def test_shell_hands_the_workflow_to_interact_once(monkeypatch):
    from veles_tpu_torch.interaction import Shell
    from veles_tpu_torch.workflow import Workflow
    wf = Workflow(None, name="wf")
    shell = Shell(wf, name="shell")
    monkeypatch.setattr("sys.stdin.isatty", lambda: True)
    called = []
    shell.interact = called.append
    shell.run()
    shell.run()
    assert len(called) == 1
    assert called[0]["wf"] is wf and called[0]["workflow"] is wf
    assert called[0]["unit"] is shell


# -------------------------------------------------------------- end to end
LAYERS = [{"type": "all2all_tanh", "output_sample_shape": 64,
           "learning_rate": 0.03, "momentum": 0.9},
          {"type": "softmax", "output_sample_shape": 10,
           "learning_rate": 0.03, "momentum": 0.9}]


def _configure(cfg_root, max_epochs):
    cfg_root.__dict__.pop("mnist", None)
    cfg_root.mnist.update({
        "loader": {"minibatch_size": 100, "n_train": 500, "n_valid": 200},
        "decision": {"max_epochs": max_epochs, "fail_iterations": 50},
        "layers": [dict(layer) for layer in LAYERS]})


def _linked(wf, pkg):
    """``link_plotters`` into a sink, plus a loss curve."""
    import importlib
    P = importlib.import_module(pkg + ".plotting_units")
    wf.graphics_server = Sink()
    plotters = wf.link_plotters()
    loss = P.AccumulatingPlotter(wf, metric="loss", name="plot_loss")
    loss.input = wf.decision
    loss.link_from(wf.decision)
    return plotters + [loss]


def _reference_run(scan, max_epochs=3, synced=True):
    """The reference's seeded run with its plotters; ``synced`` points
    its units at the committed state before each weights plot."""
    from veles_tpu.samples import mnist as jax_mnist
    saved = jax_root.__dict__.pop("mnist", None)
    try:
        jax_prng.reset()
        jax_prng.seed_all(SEED)
        _configure(jax_root, max_epochs)
        wf = jax_mnist.build(fused=True)
        plotters = _linked(wf, "veles_tpu")
        wf.initialize()
        initial = numpy.array(wf.forwards[0].weights.mem)
        if synced:
            w2d = [p for p in plotters if p.name == "plot_weights"][0]
            inner = w2d.plot_spec

            def plot_spec():
                wf._fused_runner.sync_to_units()
                return inner()
            w2d.plot_spec = plot_spec
        if scan:
            from veles_tpu.epoch_driver import EpochScanDriver
            EpochScanDriver(wf, chunk=1).run()
        else:
            wf.run()
        return wf, plotters, initial
    finally:
        jax_root.__dict__.pop("mnist", None)
        if saved is not None:
            jax_root.__dict__["mnist"] = saved
        jax_prng.reset()


def _port_run(scan, max_epochs=3):
    from veles_tpu_torch.samples import mnist
    prng.reset()
    prng.seed_all(SEED)
    _configure(root, max_epochs)
    try:
        wf = mnist.build(fused=True)
        plotters = _linked(wf, "veles_tpu_torch")
        wf.initialize(device="cpu")
        if scan:
            from veles_tpu_torch.epoch_driver import EpochScanDriver
            EpochScanDriver(wf, chunk=1).run()
        else:
            wf.run()
        return wf, plotters
    finally:
        root.__dict__.pop("mnist", None)


@pytest.mark.parametrize("scan", [False, True], ids=["graph_loop", "scan"])
def test_link_plotters_run_matches_the_reference(scan):
    ours, our_plotters = _port_run(scan)
    theirs, their_plotters, _ = _reference_run(scan)
    assert [p.name for p in our_plotters] == [p.name for p in their_plotters]
    assert [p.name for p in our_plotters[:3]] == [
        "plot_curve", "plot_confusion", "plot_weights"]
    assert [len(p.specs) for p in our_plotters] == \
        [len(p.specs) for p in their_plotters]
    sent = ours.graphics_server.got
    assert len(sent) == sum(len(p.specs) for p in our_plotters)
    assert all(any(s is t for p in our_plotters for t in p.specs)
               for s in sent)
    if scan:
        assert all(not p.specs for p in our_plotters)
        return
    assert all(p.specs for p in our_plotters)
    curve, confusion, weights, loss = our_plotters
    ref_curve, ref_confusion, ref_weights, ref_loss = their_plotters
    for a, b in zip(curve.specs, ref_curve.specs):
        assert same(a, b)
    for a, b in zip(confusion.specs, ref_confusion.specs):
        assert same(a, b)
    assert same(confusion.specs[-1]["matrix"],
                ours.decision.confusion_matrix)
    for a, b in zip(loss.specs, ref_loss.specs):
        assert list(a["series"]) == list(b["series"])
        for k in a["series"]:
            numpy.testing.assert_allclose(a["series"][k], b["series"][k],
                                          rtol=0, atol=1e-5)
    for a, b in zip(weights.specs, ref_weights.specs):
        assert a["kind"] == b["kind"] == "image_grid"
        assert a["images"].shape == b["images"].shape == (64, 28, 28)
        assert a["images"].dtype == numpy.float32
        numpy.testing.assert_allclose(a["images"], numpy.asarray(
            b["images"]), rtol=0, atol=1e-5)
    final = ours._fused_runner.state[0]["w"].numpy()
    numpy.testing.assert_array_equal(weights.specs[-1]["images"],
                                     final.T.reshape(64, 28, 28))
    assert all(only_numpy(s) for p in our_plotters for s in p.specs)
    for p in our_plotters:
        assert all(s["name"] == p.name for s in p.specs)


def test_reference_weights_plot_shows_the_initial_weights():
    """The reference's own ``Weights2D`` in a fused graph loop reads the
    unit Vector, which holds the initial weights until the run's end:
    every image it plots is the initial weights (so its stop() drops the
    final plot as unchanged).  The port's plots the committed weights."""
    theirs, plotters, initial = _reference_run(False, max_epochs=2,
                                               synced=False)
    weights = [p for p in plotters if p.name == "plot_weights"][0]
    assert len(weights.specs) == 1
    numpy.testing.assert_array_equal(numpy.asarray(
        weights.specs[0]["images"]), initial.T.reshape(64, 28, 28))
    ours, our_plotters = _port_run(False, max_epochs=2)
    ours_w = [p for p in our_plotters if p.name == "plot_weights"][0]
    assert len(ours_w.specs) == 2
    assert not numpy.array_equal(ours_w.specs[0]["images"],
                                 initial.T.reshape(64, 28, 28))
