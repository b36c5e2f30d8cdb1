"""The port's training math against ``veles_tpu.ops.functional`` on the
same seeded numpy inputs, and the fused SGD kernel's plain version
against the Pallas kernel run in interpret mode.

Tolerances (fp32 on the CPU):
- activations and their derivatives: 1e-6 relative (XLA's and PyTorch's
  CPU ``tanh``/``exp``/``log1p`` round differently in the last place);
- dense forward/backward: 1e-5 (the 784-term products sum in another
  order, ROADMAP Queue 3 item 2);
- softmax_loss: ``n_err`` and ``confusion`` equal, the rest 1e-6;
- ``fused_sgd_update_ref`` against the interpret-mode Pallas kernel:
  bit-equal (<= 1 ulp is the stated bound; the kernel's fma order,
  measured, predicts equality);
- with a clip, against ``functional.sgd_update`` jitted with a traced
  batch size (the train step's XLA route), in ulps of each final
  operation's largest operand: p' <= 1 ulp; v' <= 2 ulps, because XLA
  divides by the batch where the kernel multiplies by its inverse (g
  differs by up to 1 ulp, and lr·g carries it into v').
"""

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu.ops import functional as JF
from veles_tpu.ops import pallas_kernels as PK
from veles_tpu_torch.ops import functional as TF
from veles_tpu_torch.ops import hopper_kernels as HK

ACTIVATIONS = ("linear", "tanh", "relu", "strict_relu", "sigmoid",
               "softmax")


def _t(a):
    return torch.from_numpy(numpy.array(a))


def _np(x):
    return numpy.asarray(x)


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_activation_and_derivative(activation):
    rng = numpy.random.RandomState(len(activation))
    z = (rng.randn(16, 10) * 2).astype(numpy.float32)
    y_ref = _np(JF.activate(jnp.asarray(z), activation))
    y = TF.activate(_t(z), activation).numpy()
    numpy.testing.assert_allclose(y, y_ref, rtol=1e-6, atol=1e-7)
    d_ref = _np(JF.activation_derivative_from_output(jnp.asarray(y_ref),
                                                     activation))
    d = TF.activation_derivative_from_output(_t(y_ref), activation).numpy()
    numpy.testing.assert_allclose(d, d_ref, rtol=1e-6, atol=1e-7)


def test_unknown_activation_raises():
    with pytest.raises(ValueError):
        TF.activate(torch.zeros(2), "gelu")


@pytest.mark.parametrize("activation,need_err_input,bias", [
    ("tanh", True, True), ("softmax", True, True), ("relu", False, False),
])
def test_dense_forward_backward(activation, need_err_input, bias):
    rng = numpy.random.RandomState(7)
    x = rng.randn(32, 784).astype(numpy.float32)
    w = (rng.randn(784, 50) * 0.05).astype(numpy.float32)
    b = rng.randn(50).astype(numpy.float32) if bias else None
    y_ref = _np(JF.dense_forward(jnp.asarray(x), jnp.asarray(w),
                                 None if b is None else jnp.asarray(b),
                                 activation))
    y = TF.dense_forward(_t(x), _t(w), None if b is None else _t(b),
                         activation).numpy()
    numpy.testing.assert_allclose(y, y_ref, rtol=1e-5, atol=1e-5)
    err = rng.randn(32, 50).astype(numpy.float32)
    ref = JF.dense_backward(jnp.asarray(x), jnp.asarray(y_ref),
                            jnp.asarray(err), jnp.asarray(w), activation,
                            bias, need_err_input)
    got = TF.dense_backward(_t(x), _t(y_ref), _t(err), _t(w), activation,
                            bias, need_err_input)
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is not None:
            numpy.testing.assert_allclose(g.numpy(), _np(r), rtol=1e-5,
                                          atol=1e-5)


def test_softmax_loss():
    rng = numpy.random.RandomState(3)
    z = rng.randn(100, 10).astype(numpy.float32)
    z[5, 2] = z[5, 7] = 9.0                  # an argmax tie: first wins
    probs = _np(JF.activate(jnp.asarray(z), "softmax"))
    labels = rng.randint(0, 10, 100).astype(numpy.int32)
    mask = (numpy.arange(100) < 83).astype(numpy.float32)
    err_ref, m_ref = JF.softmax_loss(jnp.asarray(probs),
                                     jnp.asarray(labels), jnp.asarray(mask))
    err, m = TF.softmax_loss(_t(probs), _t(labels), _t(mask))
    numpy.testing.assert_allclose(err.numpy(), _np(err_ref), rtol=1e-6,
                                  atol=1e-7)
    assert int(m["n_err"]) == int(m_ref["n_err"])
    assert m["n_err"].dtype == torch.int32
    numpy.testing.assert_array_equal(m["confusion"].numpy(),
                                     _np(m_ref["confusion"]))
    numpy.testing.assert_allclose(float(m["loss_sum"]),
                                  float(m_ref["loss_sum"]), rtol=1e-6)


def test_mse_loss():
    rng = numpy.random.RandomState(4)
    out = rng.randn(20, 6).astype(numpy.float32)
    target = rng.randn(20, 6).astype(numpy.float32)
    mask = (numpy.arange(20) < 15).astype(numpy.float32)
    err_ref, m_ref = JF.mse_loss(jnp.asarray(out), jnp.asarray(target),
                                 jnp.asarray(mask))
    err, m = TF.mse_loss(_t(out), _t(target), _t(mask))
    numpy.testing.assert_allclose(err.numpy(), _np(err_ref), rtol=1e-6)
    for key in ("mse_sum", "rmse_max", "loss_sum"):
        numpy.testing.assert_allclose(float(m[key]), float(m_ref[key]),
                                      rtol=1e-6)


@pytest.mark.parametrize("solver,momentum,wd,clip,step", [
    ("momentum", 0.9, 0.0, None, 0),
    ("momentum", None, 0.001, 0.05, 0),
    ("adagrad", None, 0.0, None, 0),
    ("adadelta", None, 0.0005, None, 3),
    ("adam", None, 0.0, None, 4),
    ("adam", 0.0, 0.001, 0.1, 9),
])
def test_adaptive_update(solver, momentum, wd, clip, step):
    rng = numpy.random.RandomState(11)
    p = rng.uniform(-0.3, 0.3, (40, 30)).astype(numpy.float32)
    v = numpy.abs(rng.randn(40, 30) * 0.01).astype(numpy.float32)
    a = numpy.abs(rng.randn(40, 30) * 0.01).astype(numpy.float32)
    g = (rng.randn(40, 30) * 3).astype(numpy.float32)
    args = (100, 0.03, momentum, wd, 0.3, clip, solver, 0.95, 1e-6, step)
    ref = JF.adaptive_update(jnp.asarray(p), jnp.asarray(v), jnp.asarray(a),
                             jnp.asarray(g), *args)
    got = TF.adaptive_update(_t(p), _t(v), _t(a), _t(g), *args)
    for x, r in zip(got, ref):
        numpy.testing.assert_allclose(x.numpy(), _np(r), rtol=1e-6,
                                      atol=1e-8)


SGD_CASES = [
    # n, batch, lr, momentum, weight_decay, l1_vs_l2
    (1, 100, 0.03, 0.9, 0.0, 0.0),
    (127, 1, 0.1, 0.5, 0.0005, 0.0),
    (129, 100, 0.03, 0.9, 0.0005, 0.3),
    (1000, 100, numpy.float32(0.03), 0.9, 0.0005, 1.0),
    (7850, 37, numpy.float32(0.01), 0.0, 0.01, 0.3),
    (78400, 100, 0.03, 0.9, 0.0, 0.0),
]


def _sgd_inputs(n, seed):
    rng = numpy.random.RandomState(seed)
    p = rng.uniform(-0.3, 0.3, n).astype(numpy.float32)
    v = (rng.randn(n) * 0.01).astype(numpy.float32)
    g = (rng.randn(n) * 5).astype(numpy.float32)
    return p, v, g


def _ulps(got, ref):
    return numpy.abs(got - ref) / numpy.spacing(numpy.abs(ref))


@pytest.mark.parametrize("n,batch,lr,momentum,wd,l1", SGD_CASES)
def test_fused_sgd_plain_matches_pallas_kernel(n, batch, lr, momentum, wd,
                                               l1):
    p, v, g = _sgd_inputs(n, n)
    ref_p, ref_v = PK.fused_sgd_update(
        jnp.asarray(p), jnp.asarray(v), jnp.asarray(g), batch, lr,
        momentum, wd, l1, interpret=True)
    ref_p, ref_v = _np(ref_p), _np(ref_v)
    before = HK.fused_sgd_update.launches
    got_p, got_v = HK.fused_sgd_update(_t(p), _t(v), _t(g), batch, lr,
                                       momentum, wd, l1)
    assert HK.fused_sgd_update.launches == before    # CPU: plain version
    assert _ulps(got_p.numpy(), ref_p).max() <= 1.0
    assert _ulps(got_v.numpy(), ref_v).max() <= 1.0
    numpy.testing.assert_array_equal(got_p.numpy(), ref_p)
    numpy.testing.assert_array_equal(got_v.numpy(), ref_v)
    # out of place: the inputs are untouched
    numpy.testing.assert_array_equal(p, _sgd_inputs(n, n)[0])


@pytest.mark.parametrize("clip,wd", [(0.05, 0.0), (0.05, 0.001)])
def test_fused_sgd_clip_matches_xla_route(clip, wd):
    p, v, g = _sgd_inputs(5000, 5)
    step = jax.jit(JF.sgd_update, static_argnums=(5, 6, 7, 8))
    ref_p, ref_v = step(jnp.asarray(p), jnp.asarray(v), jnp.asarray(g),
                        jnp.asarray(100, jnp.int32), 0.03, 0.9, wd, 0.3,
                        clip)
    ref_p, ref_v = _np(ref_p), _np(ref_v)
    got_p, got_v = HK.fused_sgd_update(_t(p), _t(v), _t(g), 100, 0.03, 0.9,
                                       wd, 0.3, clip)
    f32 = numpy.float32
    lr_g = f32(0.03) * numpy.clip(g / f32(100), -clip, clip)
    v_ops = numpy.maximum(numpy.abs(f32(0.9) * v), numpy.abs(lr_g))
    p_ops = numpy.maximum.reduce([numpy.abs(p), numpy.abs(ref_v),
                                  numpy.abs(ref_p)])
    assert (numpy.abs(got_v.numpy() - ref_v)
            / numpy.spacing(v_ops)).max() <= 2.0
    assert (numpy.abs(got_p.numpy() - ref_p)
            / numpy.spacing(p_ops)).max() <= 1.0


def test_fused_sgd_rejects_tensor_scalars_and_shape_mismatch():
    p = torch.zeros(8)
    with pytest.raises(TypeError, match="not tensors"):
        HK.fused_sgd_update(p, p, p, 10, torch.tensor(0.1), 0.9)
    with pytest.raises(ValueError, match="differ in shape"):
        HK.fused_sgd_update(p, torch.zeros(9), p, 10, 0.1, 0.9)
