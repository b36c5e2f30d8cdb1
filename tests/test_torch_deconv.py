"""The port's transposed convolution, depooling and the MNIST conv
autoencoder against the JAX package on the CPU.

``deconv2d_forward`` and its explicit backward against
``lax.conv_transpose`` and ``jax.vjp`` at strides 1 and 2, kernels 3, 4
and 5, and every padding form ("SAME", "VALID", an int, a per-dimension
pair, with and without ``output_padding``); the conv mirror (``deconv(k,
s, p)`` with ``output_padding = (in + 2p − k) % s`` recovers the conv's
input size); ``depool`` in both modes, forward and backward; and the
``mnist_ae`` sample at a tiny size (conv_tanh 8, avg pool, depooling,
deconv; 300 train / 100 validation, minibatch 50, 2 epochs, seed 1) in
fused and unit mode, then one train step from the reference's state.

Tolerances: deconv outputs and gradients within 1e-5 of the largest
reference element (measured ≤ 9.9e-7 of it: the two CPU convolutions
sum in another order); depool bit-equal; the AE's
validation RMSE within 1e-6 relative per epoch (measured 1.3e-7) and
weights within ``WEIGHT_ATOL`` (measured 1.5e-6); one step within 1e-6
(measured 3.0e-8).
Torch is pinned to one thread.
"""

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

from veles_tpu import prng as jax_prng
from veles_tpu.config import root as jax_root
from veles_tpu.ops import functional as JF
from veles_tpu.samples import mnist_ae as jax_mnist_ae
from veles_tpu_torch import prng
from veles_tpu_torch.compiled import load_fused_state, state_from_jax
from veles_tpu_torch.config import root
from veles_tpu_torch.ops import functional as F
from veles_tpu_torch.samples import mnist_ae

#: a deconv output's or gradient's max gap, as a share of its largest
#: reference element
SHARE = 1e-5
#: measured 1.5e-6 (deconv) and 6.3e-7 (conv) after the 2 epochs on
#: weights up to 0.48: an MSE gradient sums 784 pixels a sample, so the
#: summation-order gap is larger than a classifier's
WEIGHT_ATOL = 1e-5

AE_TINY = {
    "loader": {"minibatch_size": 50, "n_train": 300, "n_valid": 100},
    "decision": {"max_epochs": 2, "fail_iterations": 10},
    "layers": [
        {"type": "conv_tanh", "n_kernels": 8, "kx": 5, "ky": 5,
         "padding": "SAME", "learning_rate": 0.0005, "momentum": 0.9},
        {"type": "avg_pooling", "kx": 2, "ky": 2},
        {"type": "depooling", "kx": 2, "ky": 2},
        {"type": "deconv", "n_kernels": 1, "kx": 5, "ky": 5,
         "padding": "SAME", "learning_rate": 0.0005, "momentum": 0.9},
    ],
}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want):
    want = numpy.asarray(want)
    assert got.shape == want.shape
    scale = max(float(numpy.abs(want).max()), 1e-30)
    assert float(numpy.abs(got.numpy() - want).max()) <= SHARE * scale


#: the string paddings at every (stride, k); the forward conv's own pads
#: (an int, a per-dimension pair) at three of them
CASES = ([(s, k, p) for p in ("SAME", "VALID") for k in (3, 4, 5)
          for s in (1, 2)]
         + [(s, k, p) for p in (0, 2, (1, 2))
            for s, k in ((1, 3), (2, 4), (2, 5))])


@pytest.mark.parametrize("stride,k,padding", CASES, ids=str)
def test_deconv_forward_backward(stride, k, padding):
    """Forward (with bias and tanh) and the three gradients; int and pair
    paddings also with ``output_padding`` 1."""
    rs = numpy.random.RandomState(k * 10 + stride)
    x = rs.randn(2, 6, 5, 3).astype(numpy.float32)
    w = rs.randn(k, k, 3, 4).astype(numpy.float32)
    b = rs.randn(4).astype(numpy.float32)
    extras = (0,) if isinstance(padding, str) else (0, 1)
    for op in extras:
        s = (stride, stride)

        @jax.jit
        def ref(a, ww, bb, g):
            y, vjp = jax.vjp(lambda *t: JF.deconv2d_forward(
                *t, s, padding, "tanh", op), a, ww, bb)
            return (y,) + vjp(g.reshape(y.shape))

        got = F.deconv2d_forward(torch.as_tensor(x), torch.as_tensor(w),
                                 torch.as_tensor(b), s, padding, "tanh", op)
        assert F.deconv2d_output_hw((6, 5), (k, k), s, padding,
                                    op) == tuple(got.shape[1:3])
        g = rs.randn(*got.shape).astype(numpy.float32)
        want = ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                   jnp.asarray(g))
        _close(got, want[0])
        for grad, ref_grad in zip(
                F.deconv2d_backward(torch.as_tensor(x), got,
                                    torch.as_tensor(g), torch.as_tensor(w),
                                    s, padding, "tanh", op), want[1:]):
            _close(grad, ref_grad)


@pytest.mark.parametrize("size,k,stride,pad", [
    (28, 5, 2, 2), (27, 5, 2, 2), (28, 3, 2, 1), (27, 4, 2, 1),
    (28, 5, 1, 2)])
def test_deconv_mirrors_conv(size, k, stride, pad):
    """deconv(k, s, p) with output_padding (in + 2p − k) % s restores the
    size conv(k, s, p) took, as the reference's does."""
    x = numpy.zeros((1, size, size, 3), numpy.float32)
    y = F.conv2d_forward(torch.as_tensor(x), torch.zeros(k, k, 3, 8), None,
                         (stride, stride), pad)
    op = (size + 2 * pad - k) % stride
    back = F.deconv2d_forward(y, torch.zeros(k, k, 8, 3), None,
                              (stride, stride), pad, output_padding=op)
    want = JF.deconv2d_forward(jnp.asarray(y.numpy()),
                               jnp.zeros((k, k, 8, 3)), None,
                               (stride, stride), pad, output_padding=op)
    assert tuple(back.shape) == want.shape == (1, size, size, 3)


@pytest.mark.parametrize("mode", ["nearest", "zero"])
def test_depool_forward_backward(mode):
    rs = numpy.random.RandomState(3)
    x = rs.randn(2, 3, 4, 5).astype(numpy.float32)
    want, vjp = jax.vjp(lambda a: JF.depool(a, (2, 3), mode),
                        jnp.asarray(x))
    got = F.depool(torch.as_tensor(x), (2, 3), mode)
    numpy.testing.assert_array_equal(got.numpy(), numpy.asarray(want))
    g = rs.randn(*want.shape).astype(numpy.float32)
    numpy.testing.assert_array_equal(
        F.depool_backward(torch.as_tensor(g), (2, 3), mode).numpy(),
        numpy.asarray(vjp(jnp.asarray(g))[0]))


def test_depool_unknown_mode_raises():
    x = numpy.zeros((1, 2, 2, 1), numpy.float32)
    for call in (lambda: F.depool(torch.as_tensor(x), (2, 2), "max"),
                 lambda: F.depool_backward(torch.as_tensor(x), (1, 1),
                                           "max"),
                 lambda: JF.depool(jnp.asarray(x), (2, 2), "max")):
        with pytest.raises(ValueError, match="unknown depooling mode"):
            call()


_AE = {}


def _ae_trained(fused):
    if fused not in _AE:
        jax_prng.reset()
        jax_prng.seed_all(1)
        saved = jax_root.__dict__.pop("mnist_ae", None)
        try:
            jax_root.mnist_ae.update(AE_TINY)
            ref = jax_mnist_ae.train(fused=fused)
            ref.snapshot_state()
        finally:
            jax_root.__dict__.pop("mnist_ae", None)
            if saved is not None:
                jax_root.__dict__["mnist_ae"] = saved
            jax_prng.reset()
        prng.reset()
        prng.seed_all(1)
        root.__dict__.pop("mnist_ae", None)
        root.mnist_ae.update(AE_TINY)
        wf = mnist_ae.train(fused=fused, device="cpu")
        wf.snapshot_state()
        _AE[fused] = (wf, ref)
    return _AE[fused]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unit"])
def test_mnist_ae_tiny_matches_jax(fused):
    wf, ref = _ae_trained(fused)
    assert [tuple(f.output.shape) for f in wf.forwards] == [
        tuple(f.output.shape) for f in ref.forwards]
    assert tuple(wf.forwards[-1].output.shape) == (50, 28, 28, 1)
    got = [m["validation"]["rmse"] for m in wf.decision.epoch_metrics]
    want = [m["validation"]["rmse"] for m in ref.decision.epoch_metrics]
    assert len(got) == len(want) == 2
    numpy.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[-1] < got[0]
    for f, r in zip(wf.forwards, ref.forwards):
        if f.has_params:
            numpy.testing.assert_allclose(
                f.weights.mem, numpy.asarray(r.weights.mem), rtol=0,
                atol=WEIGHT_ATOL)
            numpy.testing.assert_allclose(
                f.bias.mem, numpy.asarray(r.bias.mem), rtol=0,
                atol=WEIGHT_ATOL)


def test_state_from_jax_ae_net_one_step():
    """The reference's AE state (``w``/``vw``/``b``/``vb`` for the conv
    and the deconv, empty entries for the pooling and depooling) carries
    over, and one MSE train step from it agrees."""
    wf, ref = _ae_trained(True)
    runner = ref._fused_runner
    state = [{k: numpy.asarray(v) for k, v in e.items()}
             for e in runner.state]
    assert [sorted(e) for e in state] == [
        ["b", "vb", "vw", "w"], [], [], ["b", "vb", "vw", "w"]]
    load_fused_state(wf, state_from_jax(state, device="cpu"))
    x = numpy.random.RandomState(6).randn(16, 28, 28, 1).astype(
        numpy.float32)
    mask = numpy.ones(16, numpy.float32)
    want, _ = runner._train(runner.state, jnp.asarray(x), jnp.asarray(x),
                            jnp.asarray(mask), jnp.asarray(16, jnp.int32),
                            None, jnp.asarray(0, jnp.int32))
    port = wf._fused_runner
    got, _ = port._train_step(port.state, torch.as_tensor(x),
                              torch.as_tensor(x), torch.as_tensor(mask), 16)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for name in g:
            numpy.testing.assert_allclose(g[name].numpy(),
                                          numpy.asarray(w[name]), rtol=0,
                                          atol=1e-6)
