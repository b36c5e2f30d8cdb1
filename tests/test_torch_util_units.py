"""The port's utility units against the JAX package on the CPU: the six
standalone activations (forward and backward, with exact zeros in the
input), the cutter, the mean/dispersion normalizer (with its deferred
initialize), a conv chain that routes its error through them, the
ZeroFiller through fused and unit training, ``ResizableAll2All.resize``
and the ImageSaver's file names.

Tolerances: activation outputs and gradients within 1e-6 absolute
(O(1) values; measured ≤ 4.8e-7: XLA's and PyTorch's CPU ``tanh``,
``exp``, ``log1p``, ``asinh`` differ in the last place, ROADMAP Queue 3
item 1) and equal at the exact zeros, where ``max(x, 0)`` and ``abs``
decide the gradient; the cutter and the normalizer bit-equal; the chain's
``n_err`` equal per epoch with weights within 1e-6 (measured 6.0e-8);
ZeroFiller weights within 1e-6 (measured 3.0e-8) and exactly zero where
masked; resized weights bit-equal, new columns included.  Torch is
pinned to one thread.
"""

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

from veles_tpu import prng as jax_prng
from veles_tpu.config import root as jax_root
from veles_tpu.memory import Vector as JaxVector
from veles_tpu.samples import cifar as jax_cifar
from veles_tpu.samples import mnist as jax_mnist
from veles_tpu.workflow import Workflow as JaxWorkflow
from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.memory import Vector
from veles_tpu_torch.ops.nn_units import LAYER_TYPES
from veles_tpu_torch.samples import cifar, mnist
from veles_tpu_torch.workflow import DeferredInitError, Workflow

ACT_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _units(kind, **kwargs):
    """(port unit, reference unit) of layer type ``kind``."""
    from veles_tpu.ops.nn_units import LAYER_TYPES as JAX_TYPES
    return (LAYER_TYPES[kind](Workflow(None), **kwargs),
            JAX_TYPES[kind](JaxWorkflow(None), **kwargs))


def _ref_vjp(unit, x, g):
    y, vjp = jax.vjp(unit.transform, jnp.asarray(x))
    return numpy.asarray(y), numpy.asarray(vjp(jnp.asarray(g))[0])


def _input(seed, shape=(4, 5, 6, 3)):
    rs = numpy.random.RandomState(seed)
    x = rs.randn(*shape).astype(numpy.float32)
    x.reshape(-1)[::7] = 0.0          # exact zeros
    return x, rs.randn(*shape).astype(numpy.float32)


@pytest.mark.parametrize("kind,kwargs", [
    ("activation_tanh", {}), ("activation_sigmoid", {}),
    ("activation_relu", {}), ("activation_str", {}),
    ("activation_log", {}), ("activation_mul", {"factor": -1.5})],
    ids=lambda v: v if isinstance(v, str) else "")
def test_activation_forward_backward(kind, kwargs):
    unit, ref = _units(kind, **kwargs)
    x, g = _input(len(kind))
    want_y, want_dx = _ref_vjp(ref, x, g)
    y, saved = unit.transform(torch.as_tensor(x))
    dx = unit.backward(torch.as_tensor(x), y, torch.as_tensor(g), saved)
    numpy.testing.assert_allclose(y.numpy(), want_y, rtol=0, atol=ACT_ATOL)
    numpy.testing.assert_allclose(dx.numpy(), want_dx, rtol=0,
                                  atol=ACT_ATOL)
    zeros = x == 0.0
    numpy.testing.assert_array_equal(dx.numpy()[zeros], want_dx[zeros])


def test_relu_gradient_at_zero_is_the_reference_vjp():
    """At x = 0 the reference's smooth relu gradient is 0 (abs takes the
    positive side, max(x, 0) half: -0.5 + 0.5), and strict relu's 0.5."""
    x = torch.zeros(3)
    g = torch.ones(3)
    for kind, want in (("activation_relu", 0.0), ("activation_str", 0.5)):
        unit, _ = _units(kind)
        assert unit.backward(x, None, g, None).tolist() == [want] * 3


def test_cutter_forward_backward():
    unit, ref = _units("cutter", padding=(1, 2, 0, 1))
    x, _ = _input(5)
    want_y, _ = _ref_vjp(ref, x, numpy.zeros((4, 2, 5, 3), numpy.float32))
    g = numpy.random.RandomState(6).randn(*want_y.shape).astype(
        numpy.float32)
    _, want_dx = _ref_vjp(ref, x, g)
    y, saved = unit.transform(torch.as_tensor(x))
    assert unit.output_shape(x.shape) == want_y.shape == (4, 2, 5, 3)
    numpy.testing.assert_array_equal(y.numpy(), want_y)
    numpy.testing.assert_array_equal(
        unit.backward(torch.as_tensor(x), y, torch.as_tensor(g),
                      saved).numpy(), want_dx)


def test_mean_disp_normalizer():
    rs = numpy.random.RandomState(8)
    mean = rs.randn(5, 6, 3).astype(numpy.float32)
    rdisp = rs.rand(5, 6, 3).astype(numpy.float32) + 0.5
    x, g = _input(9)
    unit, ref = _units("mean_disp_normalizer")
    unit.input = Vector(x)
    with pytest.raises(DeferredInitError):
        unit.initialize(device="cpu")
    unit.mean.reset(mean)
    unit.rdisp.reset(rdisp)
    unit.initialize(device="cpu")
    ref = type(ref)(JaxWorkflow(None), mean=mean, rdisp=rdisp)
    ref.input = JaxVector(x)
    ref.initialize()
    want_y, want_dx = _ref_vjp(ref, x, g)
    unit.run()
    numpy.testing.assert_array_equal(unit.output.mem, want_y)
    numpy.testing.assert_array_equal(
        unit.backward(torch.as_tensor(x), None, torch.as_tensor(g),
                      None).numpy(), want_dx)
    # run takes the statistics as they are now, not as they were
    unit.mean.reset(mean + 1.0)
    unit.run()
    numpy.testing.assert_array_equal(unit.output.mem,
                                     (x - (mean + 1.0)) * rdisp)


CHAIN = {
    "loader": {"minibatch_size": 25, "n_train": 100, "n_valid": 50},
    "decision": {"max_epochs": 2, "fail_iterations": 10},
    "layers": [
        {"type": "cutter", "padding": (2, 2, 2, 2)},
        {"type": "conv", "n_kernels": 4, "kx": 3, "ky": 3,
         "padding": "SAME", "learning_rate": 0.02, "momentum": 0.9},
        {"type": "activation_str"},
        {"type": "max_pooling", "kx": 4, "ky": 4},
        {"type": "activation_tanh"},
        {"type": "conv", "n_kernels": 4, "kx": 3, "ky": 3,
         "padding": "SAME", "learning_rate": 0.02, "momentum": 0.9},
        {"type": "activation_mul", "factor": 0.5},
        {"type": "softmax", "output_sample_shape": 10,
         "learning_rate": 0.02, "momentum": 0.9},
    ],
}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unit"])
def test_chain_through_utility_units_matches_jax(fused):
    jax_prng.reset()
    jax_prng.seed_all(4)
    saved = jax_root.__dict__.pop("cifar", None)
    try:
        jax_root.cifar.update(CHAIN)
        ref = jax_cifar.train(fused=fused)
        ref.snapshot_state()
    finally:
        jax_root.__dict__.pop("cifar", None)
        if saved is not None:
            jax_root.__dict__["cifar"] = saved
        jax_prng.reset()
    prng.reset()
    prng.seed_all(4)
    root.__dict__.pop("cifar", None)
    root.cifar.update(CHAIN)
    wf = cifar.train(fused=fused, device="cpu")
    wf.snapshot_state()
    for g, r in zip(wf.decision.epoch_metrics, ref.decision.epoch_metrics):
        assert g["validation"]["n_err"] == r["validation"]["n_err"]
        assert g["train"]["n_err"] == r["train"]["n_err"]
    for f, r in zip(wf.forwards, ref.forwards):
        assert tuple(f.output.shape) == tuple(r.output.shape)
        if f.has_params:
            numpy.testing.assert_allclose(
                f.weights.mem, numpy.asarray(r.weights.mem), rtol=0,
                atol=1e-6)


MNIST_ZF = {
    "loader": {"minibatch_size": 50, "n_train": 200, "n_valid": 50},
    "decision": {"max_epochs": 2, "fail_iterations": 10},
    "layers": [
        {"type": "all2all_tanh", "output_sample_shape": 16,
         "learning_rate": 0.05, "momentum": 0.9},
        {"type": "softmax", "output_sample_shape": 10,
         "learning_rate": 0.05, "momentum": 0.9},
    ],
}


def _zero_filled(module, cfg_root, prng_mod, zero_filler, fused, **init):
    prng_mod.reset()
    prng_mod.seed_all(1)
    cfg_root.__dict__.pop("mnist", None)
    cfg_root.mnist.update(MNIST_ZF)
    wf = module.build(fused=fused)
    mask = numpy.ones((784, 16), numpy.float32)
    mask[::2, :] = 0.0   # kill every other input row
    zf = zero_filler(wf, forward=wf.forwards[0], gd=wf.gds[0], mask=mask,
                     name="zerofiller")
    zf.link_from(wf.gds[0])
    wf.initialize(**init)
    wf.run()
    runner = getattr(wf, "_fused_runner", None)
    if runner is not None:
        runner.sync_to_units()
    cfg_root.__dict__.pop("mnist", None)
    return wf


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unit"])
def test_zero_filler_through_training(fused):
    from veles_tpu.ops.weights_zerofilling import ZeroFiller as JaxZF
    from veles_tpu_torch.ops.weights_zerofilling import ZeroFiller
    saved = jax_root.__dict__.pop("mnist", None)
    try:
        ref = _zero_filled(jax_mnist, jax_root, jax_prng, JaxZF, fused)
    finally:
        if saved is not None:
            jax_root.__dict__["mnist"] = saved
        jax_prng.reset()
    wf = _zero_filled(mnist, root, prng, ZeroFiller, fused, device="cpu")
    w = wf.forwards[0].weights.to_numpy()
    assert numpy.abs(w[::2, :]).max() == 0.0
    assert numpy.abs(w[1::2, :]).max() > 0.0
    for f, r in zip(wf.forwards, ref.forwards):
        numpy.testing.assert_allclose(
            f.weights.to_numpy(), numpy.asarray(r.weights.to_numpy()),
            rtol=0, atol=1e-6)
    assert ([m["validation"]["n_err"] for m in wf.decision.epoch_metrics]
            == [m["validation"]["n_err"] for m in ref.decision.epoch_metrics])


def test_resize_bit_equal():
    """Weights before and after growing and shrinking, new columns from
    the ``init`` stream, bit-equal to the reference's."""
    from veles_tpu.ops.resizable_all2all import ResizableAll2All as JaxRA
    from veles_tpu_torch.ops.resizable_all2all import ResizableAll2All

    def drive(cls, wf, vector, prng_mod, **init):
        prng_mod.reset()
        prng_mod.seed_all(12)
        unit = cls(wf, output_sample_shape=4, name="fc")
        unit.input = vector(numpy.ones((2, 6), numpy.float32))
        unit.initialize(**init)
        out = [unit.weights.to_numpy().copy(), unit.bias.to_numpy().copy()]
        unit.resize(6)
        unit.initialize(**init)
        out += [unit.weights.to_numpy().copy(), unit.bias.to_numpy().copy()]
        unit.resize(3)
        out += [unit.weights.to_numpy().copy(), unit.bias.to_numpy().copy()]
        prng_mod.reset()
        return out

    got = drive(ResizableAll2All, Workflow(None), Vector, prng,
                device="cpu")
    want = drive(JaxRA, JaxWorkflow(None), JaxVector, jax_prng)
    assert [a.shape for a in got] == [(6, 4), (4,), (6, 6), (6,), (6, 3),
                                      (3,)]
    for a, b in zip(got, want):
        numpy.testing.assert_array_equal(a, numpy.asarray(b))
    numpy.testing.assert_array_equal(got[2][:, :4], got[0])


def test_image_saver_names(tmp_path):
    """Mispredicted validation samples land under the reference's file
    names."""
    from veles_tpu.loader.base import VALID as JAX_VALID
    from veles_tpu.ops.image_saver import ImageSaver as JaxSaver
    from veles_tpu_torch.loader.base import VALID
    from veles_tpu_torch.ops.image_saver import ImageSaver

    def drive(cls, wf, vector, valid, directory, **init):
        saver = cls(wf, directory=str(directory), name="image_saver")
        saver.input = vector(numpy.linspace(
            0, 1, 6 * 16, dtype=numpy.float32).reshape(6, 16))
        probs = numpy.zeros((6, 3), numpy.float32)
        probs[:, 0] = 1.0                       # predicts class 0 always
        probs[4, 2] = 2.0                       # ... but sample 4
        saver.output = vector(probs)
        saver.labels = vector(numpy.array([0, 1, 2, 0, 2, 1], numpy.int32))
        saver.indices = vector(numpy.arange(10, 16, dtype=numpy.int32))
        saver.minibatch_class = valid
        saver.minibatch_size = 5                # the last one is padding
        saver.initialize(**init)
        saver.run()
        return sorted(p.name for p in directory.iterdir())

    got = drive(ImageSaver, Workflow(None), Vector, VALID,
                tmp_path / "port", device="cpu")
    want = drive(JaxSaver, JaxWorkflow(None), JaxVector, JAX_VALID,
                 tmp_path / "ref")
    assert got == want == ["1_as_0_11.png", "2_as_0_12.png"]
    for name in got:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "ref" / name).read_bytes())
