"""The port's export artifacts (``veles_tpu_torch.export``) against the
JAX package's (``veles_tpu.export``) on the CPU.

A tiny MNIST-FC (hidden 32, 300 train / 100 validation, minibatch 50,
2 epochs, seed 3 — ``tests/test_export.py``'s size) is trained in both
packages from one seed; the port's workflow then takes the reference's
trained state (``state_from_jax``), so both artifacts hold the same
weights.  Tolerances: the port's artifact ``predict`` equals the
reference's ``load_model(...).predict`` within the reference's own bar
(rtol = atol = 1e-6; the two packages' CPU GEMMs sum in different
orders), and its own workflow's eval forward bit for bit (the exported
program runs the same ATen ops).  int8 arrays and scales are bit-equal
to the reference's ``_quantize_int8`` on the same weights.

A narrow conv → LRN → pool → FC → softmax net (the AlexNet sample's
layers at 8 kernels, 16×16×3 images) keeps one
``veles_tpu_torch::lrn_forward`` node per LRN layer, and its artifact
matches the reference's eval forward (its LRN on the Pallas kernel in
interpret mode) within ``tests/test_torch_alexnet_ops.py``'s LRN bar
(rtol = atol = 2e-6).
"""

import io
import os
import tarfile

import numpy
import pytest
import torch

from veles_tpu import export as jax_export
from veles_tpu import prng as jax_prng
from veles_tpu.config import root as jax_root
from veles_tpu.ops import functional as JF
from veles_tpu.samples import imagenet as jax_imagenet
from veles_tpu.samples import mnist as jax_mnist
from veles_tpu_torch import export, prng
from veles_tpu_torch.compiled import load_fused_state, state_from_jax
from veles_tpu_torch.config import root
from veles_tpu_torch.ops import hopper_kernels as HK
from veles_tpu_torch.samples import imagenet, mnist

SEED = 3
MNIST = {
    "loader": {"minibatch_size": 50, "n_train": 300, "n_valid": 100},
    "decision": {"max_epochs": 2, "fail_iterations": 5},
    "layers": [
        {"type": "all2all_tanh", "output_sample_shape": 32,
         "learning_rate": 0.03, "momentum": 0.9},
        {"type": "softmax", "output_sample_shape": 10,
         "learning_rate": 0.03, "momentum": 0.9},
    ],
}


def lrn_net_layers():
    """conv → LRN → pool → FC → softmax at narrow widths."""
    return [
        {"type": "conv_str", "n_kernels": 8, "kx": 3, "ky": 3,
         "padding": "SAME", "learning_rate": 0.01, "momentum": 0.9},
        {"type": "norm"},
        {"type": "max_pooling", "kx": 2, "ky": 2},
        {"type": "all2all_str", "output_sample_shape": 16,
         "learning_rate": 0.01, "momentum": 0.9},
        {"type": "softmax", "output_sample_shape": 4,
         "learning_rate": 0.01, "momentum": 0.9},
    ]


LRN_NET = {
    "loader": {"minibatch_size": 16, "records_path": None, "n_train": 32,
               "n_valid": 16, "image_hw": (16, 16), "n_classes": 4},
    "decision": {"max_epochs": 1, "fail_iterations": 5},
}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _seed(*mods):
    for mod in mods:
        mod.reset()
        mod.seed_all(SEED)


class _Config:
    """A config subtree set in one package's root, restored after."""

    def __init__(self, cfg_root, name, cfg):
        self.root, self.name, self.cfg = cfg_root, name, cfg

    def __enter__(self):
        self.saved = self.root.__dict__.pop(self.name, None)
        getattr(self.root, self.name).update(self.cfg)
        return self

    def __exit__(self, *exc):
        self.root.__dict__.pop(self.name, None)
        if self.saved is not None:
            self.root.__dict__[self.name] = self.saved


@pytest.fixture(scope="module")
def mnist_pair(tmp_path_factory):
    """(port workflow, reference workflow, port artifact, reference
    artifact): both trained from one seed, the port holding the
    reference's trained state."""
    tmp = tmp_path_factory.mktemp("export")
    _seed(jax_prng)
    with _Config(jax_root, "mnist", MNIST):
        ref = jax_mnist.train(fused=True)
    ref_path = str(tmp / "ref.veles")
    jax_export.export_model(ref, ref_path, metadata={"note": "test"})
    jax_prng.reset()
    _seed(prng)
    with _Config(root, "mnist", MNIST):
        wf = mnist.train(fused=True, device="cpu")
    ref_runner = ref._fused_runner
    load_fused_state(wf, state_from_jax(
        [{k: numpy.asarray(v) for k, v in e.items()}
         for e in ref_runner.state], device="cpu"))
    path = str(tmp / "port.veles")
    export.export_model(wf, path, metadata={"note": "test"})
    yield wf, ref, path, ref_path
    prng.reset()


def test_artifact_matches_the_reference_artifact(mnist_pair):
    wf, _, path, ref_path = mnist_pair
    x = numpy.asarray(wf.loader.original_data.mem[:17])
    got = export.load_model(path, device="cpu").predict(x)
    want = jax_export.load_model(ref_path).predict(x)
    numpy.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [1, 3, 64])
def test_dynamic_batch_equals_the_eval_forward(mnist_pair, n):
    wf, _, path, _ = mnist_pair
    model = export.load_model(path, device="cpu")
    x = numpy.random.RandomState(n).uniform(-1, 1, (n, 784)).astype(
        numpy.float32)
    got = model.predict(x)
    runner = wf._fused_runner
    want = runner.eval_forward()(runner.state, torch.from_numpy(x)).numpy()
    assert got.shape == (n, 10)
    numpy.testing.assert_array_equal(got, want)


def test_manifest_keys_equal_the_reference(mnist_pair):
    _, _, path, ref_path = mnist_pair
    m = export.load_model(path, device="cpu").manifest
    r = jax_export.load_model(ref_path).manifest
    assert set(m) == set(r)
    assert m["platforms"] == ["cpu", "cuda"]
    for key in ("format", "name", "input_sample_shape", "input_dtype",
                "output_sample_shape", "output_dtype", "param_keys",
                "quantize", "metadata"):
        assert m[key] == r[key], key
    with tarfile.open(path, "r:gz") as tar:
        assert sorted(tar.getnames()) == sorted(
            [export.MANIFEST, export.MODEL, export.WEIGHTS])


def test_no_velocities_shipped(mnist_pair):
    _, _, path, _ = mnist_pair
    keys = export.load_model(path, device="cpu").manifest["param_keys"]
    assert keys and all(k.split("/")[1] in ("w", "b") for k in keys)


def test_int8_bit_equal_to_the_reference_quantizer(mnist_pair, tmp_path):
    wf, ref, path, _ = mnist_pair
    q_path = str(tmp_path / "int8.veles")
    export.export_model(wf, q_path, quantize="int8")
    flat = {k: numpy.asarray(v) for k, v in jax_export._flatten_state(
        [{k: v for k, v in e.items() if k in ("w", "b")}
         for e in ref._fused_runner.state]).items()}
    want = jax_export._quantize_int8(flat)
    with tarfile.open(q_path, "r:gz") as tar:
        npz = numpy.load(io.BytesIO(
            tar.extractfile(export.WEIGHTS).read()))
        assert sorted(npz.files) == sorted(want)
        for key, arr in want.items():
            assert npz[key].dtype == arr.dtype, key
            numpy.testing.assert_array_equal(npz[key], arr)
    assert npz is not None and want["0/w"].dtype == numpy.int8
    qm = export.load_model(q_path, device="cpu")
    assert qm.manifest["quantize"] == "int8"
    assert qm.manifest["format"] == export.FORMAT_QUANTIZED
    widx = qm.manifest["param_keys"].index("0/w")
    numpy.testing.assert_array_equal(
        qm._params[widx], want["0/w.scale"] * want["0/w"].astype(
            numpy.float32))
    x = numpy.random.RandomState(5).uniform(-1, 1, (200, 784)).astype(
        numpy.float32)
    a = export.load_model(path, device="cpu").predict(x).argmax(axis=1)
    b = qm.predict(x).argmax(axis=1)
    assert (a == b).mean() >= 0.98, (a == b).mean()
    assert os.path.getsize(q_path) < 0.6 * os.path.getsize(path)


def test_no_solver_accumulators_shipped(tmp_path):
    cfg = {"loader": {"minibatch_size": 50, "n_train": 200, "n_valid": 100},
           "decision": {"max_epochs": 1, "fail_iterations": 50},
           "layers": [
               {"type": "all2all_tanh", "output_sample_shape": 16,
                "<-": {"learning_rate": 0.5, "solver": "adagrad"}},
               {"type": "softmax", "output_sample_shape": 10,
                "<-": {"learning_rate": 0.5, "solver": "adagrad"}}]}
    _seed(prng)
    with _Config(root, "mnist", cfg):
        wf = mnist.train(fused=True, device="cpu")
    assert any(len(e) > 2 for e in wf._fused_runner.state)
    path = str(tmp_path / "adagrad.veles")
    export.export_model(wf, path)
    keys = export.load_model(path, device="cpu").manifest["param_keys"]
    assert all(k.split("/")[1] in ("w", "b") for k in keys)


def test_export_refuses_unit_mode_and_unknown_quantize(tmp_path):
    _seed(prng)
    with _Config(root, "mnist", MNIST):
        wf = mnist.build(fused=False)
        wf.initialize(device="cpu")
    with pytest.raises(ValueError, match="fused workflow"):
        export.export_model(wf, str(tmp_path / "a.veles"))
    with pytest.raises(ValueError, match="quantize"):
        export.export_model(wf, str(tmp_path / "a.veles"), quantize="int4")


def lrn_net(device="cpu"):
    """The narrow LRN net of the port, built and initialized from the
    seed (its initial weights are the reference's bit for bit)."""
    _seed(prng)
    cfg = dict(LRN_NET, layers=lrn_net_layers())
    with _Config(root, "imagenet", cfg):
        wf = imagenet.build(fused=True)
    wf.initialize(device=device)
    return wf


def test_lrn_net_keeps_one_op_node_per_lrn_and_matches_the_reference(
        tmp_path):
    wf = lrn_net()
    path = str(tmp_path / "lrn.veles")
    export.export_model(wf, path)
    model = export.load_model(path, device="cpu")
    nodes = [n for n in model._program.graph.nodes
             if n.op == "call_function"
             and str(n.target).startswith("veles_tpu_torch.lrn_forward")]
    n_lrn = sum(1 for layer in lrn_net_layers() if layer["type"] == "norm")
    assert len(nodes) == n_lrn == 1
    _seed(jax_prng)
    with _Config(jax_root, "imagenet", dict(LRN_NET,
                                            layers=lrn_net_layers())):
        JF.set_lrn_backend("pallas")
        try:
            ref = jax_imagenet.build(fused=True)
            ref.initialize()
            x = numpy.random.RandomState(7).uniform(
                0, 1, (5, 16, 16, 3)).astype(numpy.float32)
            runner = ref._fused_runner
            want = numpy.asarray(runner.eval_forward()(runner.state, x))
        finally:
            JF.set_lrn_backend("xla")
    jax_prng.reset()
    numpy.testing.assert_allclose(model.predict(x), want, rtol=2e-6,
                                  atol=2e-6)
    # the CPU ran the op's plain version: no kernel launch
    assert HK.lrn_forward.launches == 0


def test_load_model_needs_a_card_unless_asked(mnist_pair, monkeypatch):
    _, _, path, _ = mnist_pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.load_model(path)


@pytest.mark.parametrize("same", [("nhwc", "port"),
                                  ("crop_nhwc", "crop_hwio"),
                                  ("crop_relu", "crop_hwio_relu")])
def test_layout_repro_variants_compute_one_function(same):
    """The variants that ``tools/aoti_layout_repro.py`` compares differ
    only in layout, so in eager they agree: a gap that one of them shows
    in a compiled package is the compiler's."""
    from veles_tpu_torch.tools import aoti_layout_repro as repro
    outs = []
    for name in same:
        net, x = repro.build(name, "cpu")
        with torch.no_grad():
            outs.append(net(x))
    for out in outs[1:]:
        torch.testing.assert_close(out, outs[0], rtol=0, atol=1e-6)
