"""The AlexNet slice's functions in the port against ``veles_tpu`` on
the CPU, on the same seeded numpy inputs: convolution forward and
backward (against ``jax.vjp``), ceil-padded pooling values and
gradients, the LRN plain versions against the Pallas kernel in interpret
mode, the dropout plain version against the Pallas wrapper and
``functional.dropout``, and the random crop.

Tolerances: conv values and gradients 2e-5 absolute — fp32 sums of up to
363 products in another order than XLA's (inputs O(1), weights O(0.2));
pooling and crop are selections and copies, equal (avg pooling divides
a sum: 1e-6); LRN at ``TestPallasLRN``'s tolerances (values 2e-6,
gradients rtol 3e-5 / atol 3e-6); dropout bit-equal.
"""

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

from veles_tpu.ops import functional as JF
from veles_tpu.ops import pallas_kernels as PK
from veles_tpu_torch.ops import functional as F
from veles_tpu_torch.ops import hopper_kernels as HK

CONV_ATOL = 2e-5


def _np(a):
    return numpy.asarray(a)


@pytest.mark.parametrize("hw,cin,cout,k,s,pad,act,zero_window", [
    (27, 3, 8, 11, 4, "VALID", "strict_relu", False),   # conv1's geometry
    (9, 4, 6, 5, 1, "SAME", "strict_relu", True),       # z == 0 windows
    (8, 4, 6, 3, 2, "SAME", "strict_relu", False),      # asymmetric SAME
    (9, 4, 6, 3, 2, "SAME", "tanh", False),
    (9, 4, 6, 3, 1, 1, "relu", False),                  # int padding
    (9, 4, 6, 3, 2, (1, 2), "linear", False),           # pair padding
])
def test_conv_forward_and_backward(hw, cin, cout, k, s, pad, act,
                                   zero_window):
    rng = numpy.random.RandomState(hw * 10 + k)
    x = rng.randn(2, hw, hw, cin).astype(numpy.float32)
    w = (rng.randn(k, k, cin, cout) * 0.2).astype(numpy.float32)
    b = (rng.randn(cout) * 0.1).astype(numpy.float32)
    if zero_window:
        # an all-zero input window with zero bias gives exactly z == 0
        x[0, :k + 2, :k + 2, :] = 0.0
        b[:] = 0.0
    ref, vjp = jax.vjp(lambda a, ww, bb: JF.conv2d_forward(
        a, ww, bb, (s, s), pad, act), *map(jnp.asarray, (x, w, b)))
    e = rng.randn(*ref.shape).astype(numpy.float32)
    gx, gw, gb = vjp(jnp.asarray(e))
    xt, wt, bt = map(torch.as_tensor, (x, w, b))
    z = F.conv2d_preact(xt, wt, bt, (s, s), pad)
    y = F.activate(z, act)
    assert tuple(y.shape[1:3]) == F.conv2d_output_hw((hw, hw), (k, k),
                                                     (s, s), pad)
    if zero_window:
        assert int((z == 0).sum()) > 0
    ex, ew, eb = F.conv2d_backward(xt, y, torch.as_tensor(e), wt, (s, s),
                                   pad, act, tie=z == 0)
    for got, want in ((y, ref), (ex, gx), (ew, gw), (eb, gb)):
        numpy.testing.assert_allclose(got.numpy(), _np(want), rtol=0,
                                      atol=CONV_ATOL)
    skipped, _, _ = F.conv2d_backward(xt, y, torch.as_tensor(e), wt, (s, s),
                                      pad, act, tie=z == 0,
                                      need_err_input=False)
    assert skipped is None


@pytest.mark.parametrize("kind", ["max", "maxabs", "avg"])
@pytest.mark.parametrize("hw,window,stride", [
    (7, (2, 2), (2, 2)),      # ceil: 7 -> 4
    (13, (3, 3), (2, 2)),     # AlexNet's overlapping 3/2
    (2, (3, 3), (2, 2)),      # smaller than the window
    (6, (3, 3), (2, 2)),
])
def test_pooling_values_and_gradients(kind, hw, window, stride):
    rng = numpy.random.RandomState(hw)
    x = rng.randn(2, hw, hw, 3).astype(numpy.float32)
    x[0, :3, :3, :] = 0.0       # all-zero windows: ties resolve alike
    jfn = {"max": JF.max_pooling, "maxabs": JF.maxabs_pooling,
           "avg": JF.avg_pooling}[kind]
    ref, vjp = jax.vjp(lambda a: jfn(a, window, stride), jnp.asarray(x))
    e = rng.randn(*ref.shape).astype(numpy.float32)
    gref = vjp(jnp.asarray(e))[0]
    xt, et = torch.as_tensor(x), torch.as_tensor(e)
    if kind == "max":
        y, idx = F.max_pooling(xt, window, stride)
        g = F.max_pooling_backward(xt, et, idx, window, stride)
    elif kind == "maxabs":
        y, saved = F.maxabs_pooling(xt, window, stride)
        g = F.maxabs_pooling_backward(xt, et, saved, window, stride)
    else:
        y = F.avg_pooling(xt, window, stride)
        g = F.avg_pooling_backward(xt, et, window, stride)
    assert tuple(y.shape[1:3]) == F.pool_output_hw((hw, hw), window, stride)
    atol = 1e-6 if kind == "avg" else 0.0
    numpy.testing.assert_allclose(y.numpy(), _np(ref), rtol=0, atol=atol)
    numpy.testing.assert_allclose(g.numpy(), _np(gref), rtol=0, atol=atol)


def _lrn_x(shape, seed, scale=1.0):
    return numpy.array(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                         jnp.float32) * scale)


@pytest.mark.parametrize("c", [16, 96, 128, 200])
def test_lrn_forward_matches_pallas(c):
    x = _lrn_x((3, 5, 5, c), c)
    y, d = HK.lrn_forward(torch.as_tensor(x))
    numpy.testing.assert_allclose(y.numpy(), _np(PK.lrn_forward(x)),
                                  rtol=2e-6, atol=2e-6)
    _, (_, d_ref) = PK._lrn_fwd(jnp.asarray(x), 1e-4, 0.75, 5, 2.0, None)
    numpy.testing.assert_allclose(d.numpy().reshape(-1, c), _np(d_ref),
                                  rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("n", [4, 5])
def test_lrn_even_and_odd_window_vjp(n):
    x = _lrn_x((2, 3, 3, 24), n)
    dy = _lrn_x((2, 3, 3, 24), n + 10)
    ref, vjp = jax.vjp(lambda a: PK.lrn_forward(a, n=n), jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_()
    y = HK.LRN.apply(xt, 1e-4, 0.75, n, 2.0)
    y.backward(torch.as_tensor(dy))
    numpy.testing.assert_allclose(y.detach().numpy(), _np(ref), rtol=2e-6,
                                  atol=2e-6)
    numpy.testing.assert_allclose(xt.grad.numpy(),
                                  _np(vjp(jnp.asarray(dy))[0]),
                                  rtol=3e-5, atol=3e-6)


#: the geometries the card kernels split on: C % 4 != 0 (the scalar
#: instance), n other than 5 (the runtime-n instance, odd and even), and
#: windows wider than the row (n > C)
LRN_EDGES = [(3, 5), (98, 5), (96, 1), (96, 7), (98, 7), (3, 7), (4, 9),
             (98, 4)]


@pytest.mark.parametrize("c,n", LRN_EDGES)
def test_lrn_edge_forward_matches_pallas(c, n):
    x = _lrn_x((2, 3, 3, c), 100 + c + n, scale=3.0)
    y, d = HK.lrn_forward(torch.as_tensor(x), 1e-4, 0.75, n, 2.0)
    y_ref, (_, d_ref) = PK._lrn_fwd(jnp.asarray(x), 1e-4, 0.75, n, 2.0,
                                    None)
    numpy.testing.assert_allclose(y.numpy(), _np(y_ref), rtol=2e-6,
                                  atol=2e-6)
    numpy.testing.assert_allclose(d.numpy().reshape(-1, c), _np(d_ref),
                                  rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("c,n", LRN_EDGES)
def test_lrn_edge_vjp_matches_pallas(c, n):
    x = _lrn_x((2, 3, 3, c), 100 + c + n, scale=3.0)
    dy = _lrn_x((2, 3, 3, c), 200 + c + n)
    _, vjp = jax.vjp(lambda a: PK.lrn_forward(a, n=n), jnp.asarray(x))
    xt = torch.as_tensor(x)
    _, d = HK.lrn_forward(xt, 1e-4, 0.75, n, 2.0)
    got = HK.lrn_backward(xt, d, torch.as_tensor(dy), 1e-4, 0.75, n)
    numpy.testing.assert_allclose(got.numpy(),
                                  _np(vjp(jnp.asarray(dy))[0]),
                                  rtol=3e-5, atol=3e-6)


def test_lrn_gradient_other_hyperparameters():
    x = _lrn_x((2, 4, 4, 32), 1, scale=2.0)
    dy = _lrn_x((2, 4, 4, 32), 2)
    ref = jax.vjp(lambda a: PK.lrn_forward(a, 2e-4, 0.7, 5, 1.5),
                  jnp.asarray(x))[1](jnp.asarray(dy))[0]
    xt = torch.as_tensor(x)
    _, d = HK.lrn_forward(xt, 2e-4, 0.7, 5, 1.5)
    got = HK.lrn_backward(xt, d, torch.as_tensor(dy), 2e-4, 0.7, 5)
    numpy.testing.assert_allclose(got.numpy(), _np(ref), rtol=3e-5,
                                  atol=3e-6)


@pytest.mark.parametrize("rate", [0.5, 0.3, 0.7])
@pytest.mark.parametrize("shape", [(130,), (128, 96), (3, 7, 5)])
def test_dropout_bit_equal_to_reference(rate, shape):
    x = numpy.random.RandomState(len(shape)).randn(*shape).astype(
        numpy.float32)
    got = HK.dropout(torch.as_tensor(x), 7, rate).numpy()
    numpy.testing.assert_array_equal(
        got, _np(PK.dropout(jnp.asarray(x), 7, rate, interpret=True)))
    key = jax.random.PRNGKey(123)
    got = F.dropout(torch.as_tensor(x), _np(key), rate, True).numpy()
    numpy.testing.assert_array_equal(
        got, _np(JF.dropout(jnp.asarray(x), key, rate, True)))
    assert F.dropout(torch.as_tensor(x), _np(key), rate, False) is not None


def test_dropout_identity_cases():
    x = torch.as_tensor(numpy.ones((4, 4), numpy.float32))
    assert HK.dropout(x, 1, 0.0) is x
    assert F.dropout(x, numpy.zeros(2, numpy.uint32), 0.5, False) is x
    with pytest.raises(ValueError, match="two uint32"):
        HK.dropout(x, numpy.zeros(3, numpy.uint32), 0.5)


@pytest.mark.parametrize("flip", [True, False])
def test_random_crop_flip_bit_equal(flip):
    x = numpy.random.RandomState(0).randn(8, 10, 12, 3).astype(
        numpy.float32)
    key = jax.random.PRNGKey(7)
    ref, vjp = jax.vjp(lambda a: JF.random_crop_flip(a, key, (6, 7), flip),
                       jnp.asarray(x))
    e = numpy.random.RandomState(1).randn(8, 6, 7, 3).astype(numpy.float32)
    xt = torch.as_tensor(x)
    got = F.random_crop_flip(xt, _np(key), (6, 7), flip)
    numpy.testing.assert_array_equal(got.numpy(), _np(ref))
    grad = F.random_crop_flip_backward(xt, torch.as_tensor(e), _np(key),
                                       (6, 7), flip)
    numpy.testing.assert_array_equal(grad.numpy(),
                                     _np(vjp(jnp.asarray(e))[0]))
    center = F.random_crop_flip(xt, None, (6, 7), flip, train=False)
    numpy.testing.assert_array_equal(
        center.numpy(),
        _np(JF.random_crop_flip(jnp.asarray(x), None, (6, 7), flip,
                                train=False)))
