"""The CIFAR-10 small-conv and MNIST-conv samples of the port against the
JAX package on the CPU: ``CifarLoader``'s synthetic set and its
real-pickle path (tiny pickles written here), the tiny CIFAR config of
``tests/test_cifar.py`` (conv 16 5x5 SAME, 4x4 max pool, softmax; 600
train / 200 validation, minibatch 50, seed 42) trained 2 epochs in fused
and in unit mode, and a tiny MNIST-conv (conv 8, max pool, conv 8, max
pool, 32 tanh, softmax; 300 / 100, minibatch 50).

Tolerances: data, labels and initial weights are bit-equal (one host
PRNG stream); validation ``n_err`` is equal per epoch; weights agree
within ``WEIGHT_ATOL`` — measured 1.5e-8 (CIFAR, fused and unit) and
1.0e-7 (MNIST-conv) after the 2 epochs, validation losses within 1e-5
(measured 3.1e-7): the two packages' CPU
convolutions and GEMMs sum in different orders and the reference's
default update divides by the batch where the port's kernel multiplies
(ROADMAP Queue 3, items 2 and 5).  Torch is pinned to one thread.
"""

import pickle

import numpy
import pytest
import torch

from veles_tpu import prng as jax_prng
from veles_tpu.config import root as jax_root
from veles_tpu.samples import cifar as jax_cifar
from veles_tpu.samples import mnist_conv as jax_mnist_conv
from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.ops import hopper_kernels as HK
from veles_tpu_torch.samples import cifar, mnist_conv

SEED = 42
#: measured 1.5e-8 / 1.0e-7 (see the docstring); 10x for summation order
WEIGHT_ATOL = 1e-6

CIFAR_TINY = {
    "loader": {"minibatch_size": 50, "n_train": 600, "n_valid": 200},
    "decision": {"max_epochs": 2, "fail_iterations": 50},
    "layers": [
        {"type": "conv_str", "n_kernels": 16, "kx": 5, "ky": 5,
         "padding": "SAME", "learning_rate": 0.01, "weights_stddev": 0.05},
        {"type": "max_pooling", "kx": 4, "ky": 4},
        {"type": "softmax", "output_sample_shape": 10,
         "learning_rate": 0.01, "weights_stddev": 0.05},
    ],
}

MNIST_CONV_TINY = {
    "loader": {"minibatch_size": 50, "n_train": 300, "n_valid": 100},
    "decision": {"max_epochs": 2, "fail_iterations": 50},
    "layers": [
        {"type": "conv_str", "n_kernels": 8, "kx": 5, "ky": 5,
         "padding": "SAME", "learning_rate": 0.02, "momentum": 0.9,
         "weights_filling": "gaussian", "weights_stddev": 0.05},
        {"type": "max_pooling", "kx": 2, "ky": 2},
        {"type": "conv_str", "n_kernels": 8, "kx": 5, "ky": 5,
         "padding": "SAME", "learning_rate": 0.02, "momentum": 0.9,
         "weights_filling": "gaussian", "weights_stddev": 0.05},
        {"type": "max_pooling", "kx": 2, "ky": 2},
        {"type": "all2all_tanh", "output_sample_shape": 32,
         "learning_rate": 0.02, "momentum": 0.9},
        {"type": "softmax", "output_sample_shape": 10,
         "learning_rate": 0.02, "momentum": 0.9},
    ],
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


class _JaxConfig:
    """The reference's ``root.<name>`` set to ``cfg`` for the block, the
    prior node restored after."""

    def __init__(self, name, cfg):
        self.name, self.cfg = name, cfg

    def __enter__(self):
        self.saved = jax_root.__dict__.pop(self.name, None)
        getattr(jax_root, self.name).update(self.cfg)
        return self

    def __exit__(self, *exc):
        jax_root.__dict__.pop(self.name, None)
        if self.saved is not None:
            jax_root.__dict__[self.name] = self.saved
        jax_prng.reset()


def _port_config(name, cfg):
    root.__dict__.pop(name, None)
    getattr(root, name).update(cfg)


def _train_both(name, cfg, jax_module, module, fused):
    """(port workflow, reference workflow), trained from one seed."""
    _seed(jax_prng)
    with _JaxConfig(name, cfg):
        ref = jax_module.train(fused=fused)
        ref.snapshot_state()
    _seed(prng)
    _port_config(name, cfg)
    HK.reset_launch_counts()
    wf = module.build(fused=fused)
    wf.initialize(device="cpu")
    wf.run()
    wf.snapshot_state()
    return wf, ref


def _assert_same_training(wf, ref):
    got = wf.decision.epoch_metrics
    want = ref.decision.epoch_metrics
    assert len(got) == len(want) == 2
    for g, r in zip(got, want):
        assert g["validation"]["n_err"] == r["validation"]["n_err"]
        assert g["train"]["n_err"] == r["train"]["n_err"]
        assert abs(g["validation"]["loss"] - r["validation"]["loss"]) < 1e-5
    params = 0
    for f, r in zip(wf.forwards, ref.forwards):
        if f.has_params:
            params += 1
            numpy.testing.assert_allclose(
                f.weights.mem, numpy.asarray(r.weights.mem), rtol=0,
                atol=WEIGHT_ATOL)
            numpy.testing.assert_allclose(
                f.bias.mem, numpy.asarray(r.bias.mem), rtol=0,
                atol=WEIGHT_ATOL)
    assert params >= 2
    # the CPU runs the kernels' plain versions: nothing is launched
    assert all(n == 0 for n in HK.launch_counts().values())


def test_synthetic_data_and_initial_weights_bit_equal():
    _seed(jax_prng)
    with _JaxConfig("cifar", CIFAR_TINY):
        ref = jax_cifar.build(fused=False)
        ref.initialize()
    _seed(prng)
    _port_config("cifar", CIFAR_TINY)
    wf = cifar.build(fused=False)
    wf.initialize(device="cpu")
    numpy.testing.assert_array_equal(
        wf.loader.original_data.mem,
        numpy.asarray(ref.loader.original_data.mem))
    numpy.testing.assert_array_equal(
        wf.loader.original_labels.mem,
        numpy.asarray(ref.loader.original_labels.mem))
    assert wf.loader.original_data.shape == (800, 32, 32, 3)
    assert wf.loader.class_lengths == [0, 200, 600]
    for f, r in zip(wf.forwards, ref.forwards):
        assert tuple(f.output.shape) == tuple(r.output.shape)
        if f.has_params:
            numpy.testing.assert_array_equal(f.weights.mem,
                                             numpy.asarray(r.weights.mem))


def _write_batch(path, rng, n):
    data = rng.randint(0, 256, (n, 3 * 32 * 32)).astype(numpy.uint8)
    labels = [int(v) for v in rng.randint(0, 10, n)]
    with open(path, "wb") as f:
        pickle.dump({b"data": data, b"labels": labels}, f)


def test_real_pickle_path(tmp_path):
    """Five tiny train batches and a test batch in the CIFAR python
    pickle format: both loaders read them the same, cut to n_train /
    n_valid, scaled to [-1, 1]."""
    rng = numpy.random.RandomState(7)
    for i in range(1, 6):
        _write_batch(tmp_path / ("data_batch_%d" % i), rng, 6)
    _write_batch(tmp_path / "test_batch", rng, 5)
    cfg = {"minibatch_size": 4, "n_train": 25, "n_valid": 4,
           "data_dir": str(tmp_path)}
    from veles_tpu.workflow import Workflow as JaxWorkflow
    from veles_tpu_torch.workflow import Workflow
    ref = jax_cifar.CifarLoader(JaxWorkflow(None), **cfg)
    ref.load_data()
    got = cifar.CifarLoader(Workflow(None), **cfg)
    got.load_data()
    numpy.testing.assert_array_equal(
        got.original_data.mem, numpy.asarray(ref.original_data.mem))
    numpy.testing.assert_array_equal(
        got.original_labels.mem, numpy.asarray(ref.original_labels.mem))
    assert got.class_lengths == ref.class_lengths == [0, 4, 25]
    data = got.original_data.mem
    assert data.shape == (29, 32, 32, 3)
    assert data.min() >= -1.0 and data.max() <= 1.0


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unit"])
def test_cifar_tiny_matches_jax(fused):
    wf, ref = _train_both("cifar", CIFAR_TINY, jax_cifar, cifar, fused)
    _assert_same_training(wf, ref)


def test_mnist_conv_tiny_matches_jax():
    wf, ref = _train_both("mnist_conv", MNIST_CONV_TINY, jax_mnist_conv,
                          mnist_conv, True)
    assert wf.loader.original_data.shape[1:] == (28, 28, 1)
    _assert_same_training(wf, ref)


def test_default_topologies_build():
    """The samples' default layer stacks at full width (minibatch 2, no
    JAX): every output shape as the reference's configs give it."""
    for name, module, shapes in (
            ("cifar", cifar, [(2, 32, 32, 32), (2, 16, 16, 32),
                              (2, 16, 16, 32), (2, 8, 8, 32),
                              (2, 8, 8, 64), (2, 4, 4, 64), (2, 10)]),
            ("mnist_conv", mnist_conv, [(2, 28, 28, 32), (2, 14, 14, 32),
                                        (2, 14, 14, 64), (2, 7, 7, 64),
                                        (2, 100), (2, 10)])):
        _seed(prng)
        root.__dict__.pop(name, None)
        getattr(root, name).update({"loader": {
            "minibatch_size": 2, "n_train": 4, "n_valid": 2}})
        wf = module.build(fused=True)
        wf.initialize(device="cpu")
        assert [tuple(f.output.shape) for f in wf.forwards] == shapes
        root.__dict__.pop(name, None)
