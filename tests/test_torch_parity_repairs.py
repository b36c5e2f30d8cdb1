"""The port's precision modes and backend setters against
``veles_tpu.ops.functional``, and the port's LRN against the reference's
default ``'xla'`` route, on the same seeded numpy inputs on the CPU.

Tolerances (fp32 on the CPU):
- dense and conv products under ``'default'``: 1e-6 relative to the
  output's largest element — on the CPU neither side lowers a product's
  precision, so the two differ only in summation order (ROADMAP Queue 3
  item 2), kept small here by short contractions;
- LRN forward against the shifted-slice form: 2e-6 relative (the
  reference divides by d^β, the port multiplies by d^−β; pow rounds
  differently in XLA and PyTorch);
- LRN backward against ``jax.vjp`` of that form: rtol 3e-5 / atol 3e-6,
  the reference's own Pallas-vs-XLA tolerances (the VJP chains pow,
  divide and the window sum in another order).

Every test restores both packages' module state.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu.ops import functional as JF
from veles_tpu_torch.ops import functional as F

MODES = ("float32", "default", "bfloat16")
#: whether each mode lets cuBLAS and cuDNN run fp32 products in TF32
TF32 = {"float32": False, "default": True, "bfloat16": True}


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@contextlib.contextmanager
def _restored():
    """Both packages' precision modes, the port's TF32 flags and the
    reference's LRN and SGD backends, as they were before the block."""
    port, flags = F.get_matmul_precision(), _flags()
    ref = ("float32" if JF._PRECISION == jax.lax.Precision.HIGHEST
           else ("bfloat16" if JF._CAST_BF16 else "default"))
    lrn, sgd = JF._LRN_BACKEND, JF._SGD_BACKEND
    try:
        yield
    finally:
        F.set_matmul_precision(port)
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
        JF.set_matmul_precision(ref)
        JF.set_lrn_backend(lrn)
        JF.set_sgd_backend(sgd)


def _t(a):
    return torch.from_numpy(numpy.array(a))


@pytest.mark.parametrize("inner", MODES)
@pytest.mark.parametrize("outer", MODES)
def test_precision_round_trips(outer, inner):
    """Every mode sets both TF32 flags; a block under another mode
    restores the prior mode and its flags."""
    with _restored():
        F.set_matmul_precision(outer)
        assert F.get_matmul_precision() == outer
        assert _flags() == (TF32[outer],) * 2
        with F.matmul_precision(inner):
            assert F.get_matmul_precision() == inner
            assert _flags() == (TF32[inner],) * 2
        assert F.get_matmul_precision() == outer
        assert _flags() == (TF32[outer],) * 2


def test_default_then_float32_turns_tf32_off():
    with _restored():
        F.set_matmul_precision("default")
        assert _flags() == (True, True)
        F.set_matmul_precision("float32")
        assert _flags() == (False, False)



@pytest.mark.parametrize("mode", MODES)
def test_every_mode_pins_cudnn_deterministic(mode):
    """Every mode, and the parity pin a workflow makes at initialize,
    sets cuDNN's deterministic switch: seeded runs on the card repeat
    bit for bit, as the reference's seeded runs do."""
    before = torch.backends.cudnn.deterministic
    try:
        with _restored():
            torch.backends.cudnn.deterministic = False
            F.set_matmul_precision(mode)
            assert torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = False
            F.pin_fp32_matmul()
            assert torch.backends.cudnn.deterministic
            assert _flags() == (False, False)
    finally:
        torch.backends.cudnn.deterministic = before


def test_workflow_initialize_pins_cudnn_deterministic():
    """A workflow's initialize in the parity mode sets the switch (CPU
    here: the flag is process state, read by cuDNN on the card)."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.samples.cifar import CifarLoader
    from veles_tpu_torch.standard_workflow import StandardWorkflow
    before = torch.backends.cudnn.deterministic
    try:
        with _restored():
            torch.backends.cudnn.deterministic = False
            prng.reset()
            prng.seed_all(9)
            wf = StandardWorkflow(
                None, name="pin", loader_factory=CifarLoader,
                loader_config={"minibatch_size": 4, "n_train": 8,
                               "n_valid": 4},
                layers=[{"type": "softmax", "output_sample_shape": 10}],
                decision_config={"max_epochs": 1})
            wf.initialize(device="cpu")
            assert torch.backends.cudnn.deterministic
    finally:
        torch.backends.cudnn.deterministic = before

@pytest.mark.parametrize("mode", ["tf32", "highest", "", None])
def test_unknown_precision_raises_as_the_reference(mode):
    with _restored():
        with pytest.raises(ValueError, match="precision"):
            JF.set_matmul_precision(mode)
        with pytest.raises(ValueError, match="precision"):
            F.set_matmul_precision(mode)
        assert F.get_matmul_precision() == "float32"


def _close(got, want, rel=1e-6):
    want = numpy.asarray(want)
    numpy.testing.assert_allclose(numpy.asarray(got), want, rtol=0,
                                  atol=rel * numpy.abs(want).max())


@pytest.mark.parametrize("activation", ["linear", "tanh"])
def test_default_precision_dense_matches_reference(activation):
    rng = numpy.random.RandomState(31)
    x = rng.randn(16, 24).astype(numpy.float32)
    w = (rng.randn(24, 12) * 0.2).astype(numpy.float32)
    b = rng.randn(12).astype(numpy.float32)
    with _restored():
        JF.set_matmul_precision("default")
        F.set_matmul_precision("default")
        want = JF.dense_forward(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b), activation)
        got = F.dense_forward(_t(x), _t(w), _t(b), activation)
        _close(got.numpy(), want)
        _close(F.matmul(_t(x), _t(w)).numpy(),
               JF.matmul(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("stride,padding", [((1, 1), "SAME"),
                                            ((2, 2), "VALID")])
def test_default_precision_conv_matches_reference(stride, padding):
    rng = numpy.random.RandomState(32)
    x = rng.randn(2, 9, 9, 3).astype(numpy.float32)
    w = (rng.randn(3, 3, 3, 8) * 0.2).astype(numpy.float32)
    b = rng.randn(8).astype(numpy.float32)
    with _restored():
        JF.set_matmul_precision("default")
        F.set_matmul_precision("default")
        want = JF.conv2d_forward(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b), stride, padding,
                                 "strict_relu")
        got = F.conv2d_forward(_t(x), _t(w), _t(b), stride, padding,
                               "strict_relu")
        _close(got.numpy(), want)


@pytest.mark.parametrize("setter", ["set_lrn_backend", "set_sgd_backend"])
@pytest.mark.parametrize("mode", ["xla", "pallas"])
def test_backend_setters_take_the_reference_modes(setter, mode):
    with _restored():
        getattr(JF, setter)(mode)
        assert getattr(F, setter)(mode) is None


@pytest.mark.parametrize("setter", ["set_lrn_backend", "set_sgd_backend"])
@pytest.mark.parametrize("mode", ["triton", "XLA", "", None])
def test_backend_setters_raise_as_the_reference(setter, mode):
    with _restored():
        with pytest.raises(ValueError, match="backend") as ref:
            getattr(JF, setter)(mode)
        with pytest.raises(ValueError, match="backend") as port:
            getattr(F, setter)(mode)
        assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("shape,n", [
    ((2, 6, 6, 96), 5),     # conv1's channels, AlexNet's window
    ((2, 3, 3, 256), 5),    # conv2's channels
    ((2, 5, 5, 24), 4),     # an even window (asymmetric)
    ((1, 4, 4, 17), 3),
])
def test_lrn_matches_the_reference_xla_route(shape, n):
    """Forward by the reference's shifted slices, backward by jax.vjp of
    them (its default 'xla' route); the port's plain kernels on the CPU.
    Post-ReLU inputs of rms 3 so that the window term matters."""
    rng = numpy.random.RandomState(sum(shape) + n)
    x = (3 * numpy.abs(rng.randn(*shape))).astype(numpy.float32)
    dy = rng.randn(*shape).astype(numpy.float32)
    with _restored():
        JF.set_lrn_backend("xla")
        want, vjp = jax.vjp(lambda a: JF.lrn_forward(a, n=n),
                            jnp.asarray(x))
        (dx_want,) = vjp(jnp.asarray(dy))
        y, d = F.lrn_forward(_t(x), n=n)
        dx = F.lrn_backward(_t(x), d, _t(dy), n=n)
    numpy.testing.assert_allclose(y.numpy(), numpy.asarray(want),
                                  rtol=2e-6, atol=0)
    numpy.testing.assert_allclose(dx.numpy(), numpy.asarray(dx_want),
                                  rtol=3e-5, atol=3e-6)
    # the window term sits far above the limits: d is not k alone
    assert float((d - 2.0).mean()) > 1e-4
