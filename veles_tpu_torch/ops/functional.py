"""Pure numeric functions behind every accelerated unit.

Port of ``veles_tpu/ops/functional.py``, five subsets so far: the
matmul precision policy every op routes its products through
(``:37-90``); the MNIST-FC training path — activations and their
derivatives from the forward output (``:103-138``), the dense
forward/backward (``:142-169``), the softmax and MSE evaluators
(``:173-216``) and the update rules (``:624-719``); and the AlexNet path
— convolution (``:220-248``), ceil-padded max/maxabs/avg pooling
(``:311-395``), LRN (``:450``), dropout (``:473``) and the random crop
and mirror (``:485``); and the conv zoo — the transposed conv
(``:252-286``), positional depooling (``:289-308``) and the standalone
activations' vjp — each with the explicit backward the reference gets
from ``jax.vjp``; and the non-SGD trainers — the Kohonen SOM's distances,
winners and batch update and the RBM's CD-k step (``:516-600``), whose
Bernoulli draws go through the hand-written kernel's wrapper.
Activation semantics follow the reference exactly:
``tanh`` is the LeCun-scaled ``1.7159 * tanh(0.6666 x)``, ``relu`` the
smooth ``log(1 + exp(x))``, ``strict_relu`` is ``max(0, x)``.  Every
momentum update goes through the hand-written kernel's wrapper
(:func:`veles_tpu_torch.ops.hopper_kernels.fused_sgd_update_multi`, a
step's tensors in one launch), clipped or not, and every LRN and
dropout through theirs; the adaptive solvers,
convolutions and pooling are PyTorch ops (cuBLAS, cuDNN), as the
reference left them to XLA.  Convolutions run on NHWC tensors' NCHW
views, which are channels_last, with HWIO weights.

Precision modes:

- ``"float32"`` (default, the parity mode): full fp32 products.  On the
  card that means TF32 OFF in cuBLAS and cuDNN
  (``torch.backends.cuda.matmul.allow_tf32`` and
  ``torch.backends.cudnn.allow_tf32`` both False); the mode sets both,
  and ``LMEngine`` sets them again where it is built.
- ``"default"``: fp32 operands, with cuBLAS and cuDNN allowed TF32 (both
  ``allow_tf32`` flags True) — the libraries' reduced-precision fp32
  pass, the counterpart of the reference's ``Precision.DEFAULT`` with
  no bf16 cast.  On the CPU the flags change nothing: products stay
  fp32, as XLA's CPU products do under ``Precision.DEFAULT``.
- ``"bfloat16"`` (fast): operands are cast to bf16, the product
  accumulates in fp32 inside the library, and the result is cast back
  to the operands' type — what the reference's bf16 mode does.  Any
  fp32 product left uncast runs as under ``"default"`` (TF32 allowed),
  as the reference's bf16 mode keeps ``Precision.DEFAULT``.

Every mode sets both ``allow_tf32`` flags, so a switch back to
``"float32"`` turns TF32 off again.  Every mode (and
:func:`pin_fp32_matmul`) also sets ``torch.backends.cudnn.deterministic``:
cuDNN's default weight-gradient algorithms sum with atomics, so two
seeded runs on the card drift apart from the first update, where the
reference's seeded runs repeat bit for bit.  With the switch on they
repeat too, at a cost that
``python3 -m veles_tpu_torch.tools.determinism_probe`` measures.

Large products stay ``torch.matmul`` (cuBLAS), as the reference left
them to XLA.
"""

from __future__ import annotations

import contextlib

import numpy
import torch

#: mode -> whether cuBLAS and cuDNN may run fp32 products in TF32
_MODES = {"float32": False, "default": True, "bfloat16": True}


class _Policy:
    """The process-wide precision mode (the reference's module state)."""
    mode = "float32"


def _allow_tf32(allow):
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    # seeded runs repeat bit for bit on the card, as the reference's do
    torch.backends.cudnn.deterministic = True


def pin_fp32_matmul():
    """Full-precision fp32 products in cuBLAS and cuDNN (TF32 off), and
    cuDNN's deterministic algorithms."""
    _allow_tf32(False)


def set_matmul_precision(mode):
    """mode: 'float32' (default, parity) | 'default' (fp32 operands, TF32
    allowed in the libraries) | 'bfloat16' (fast)."""
    if mode not in _MODES:
        raise ValueError("unknown matmul precision mode %r" % (mode,))
    _allow_tf32(_MODES[mode])
    _Policy.mode = mode


def get_matmul_precision():
    return _Policy.mode


@contextlib.contextmanager
def matmul_precision(mode):
    """Run a block under another precision mode and restore the PRIOR
    mode on exit."""
    prior = _Policy.mode
    set_matmul_precision(mode)
    try:
        yield
    finally:
        set_matmul_precision(prior)


def matmul(a, b):
    """Precision-pinned matmul every op routes its products through."""
    if _Policy.mode == "bfloat16":
        out_dtype = torch.result_type(a, b)
        return torch.matmul(a.to(torch.bfloat16),
                            b.to(torch.bfloat16)).to(out_dtype)
    return torch.matmul(a, b)


def relu(z):
    """max(z, 0) with the reference's gradient: at z == 0 half the
    cotangent passes (``jnp.maximum``'s tie rule, which
    ``torch.maximum`` shares; ``clamp_min`` would pass all of it)."""
    return torch.maximum(z, _ZERO)


#: the 0-dim host zero ``relu`` compares against (a wrapped scalar on
#: every device, never promoting z's dtype)
_ZERO = torch.tensor(0.0)


def _conv_operands(*tensors):
    """The conv operands under the precision policy: bf16 mode casts
    them, as ``matmul`` casts GEMM operands."""
    if _Policy.mode == "bfloat16":
        return [t.to(torch.bfloat16) for t in tensors]
    return list(tensors)


# LeCun-scaled tanh constants (ref: veles/znicz/all2all.py::All2AllTanh [H])
TANH_A = 1.7159
TANH_B = 0.6666


# --------------------------------------------------------------- activations
def activate(z, activation):
    if activation == "linear":
        return z
    if activation == "tanh":
        return TANH_A * torch.tanh(TANH_B * z)
    if activation == "relu":  # smooth relu, see module docstring
        return torch.log1p(torch.exp(-torch.abs(z))) + torch.clamp_min(z, 0.0)
    if activation == "strict_relu":
        return torch.clamp_min(z, 0.0)
    if activation == "sigmoid":
        return torch.sigmoid(z)
    if activation == "softmax":
        return torch.softmax(z, dim=-1)
    raise ValueError("unknown activation %r" % (activation,))


def activation_derivative_from_output(y, activation):
    """d(activation)/d(pre-activation) expressed via the forward output y.
    Softmax returns ones: the softmax evaluator emits err_output already
    w.r.t. the logits (the softmax+NLL fusion)."""
    if activation in ("linear", "softmax"):
        return torch.ones_like(y)
    if activation == "tanh":
        # y = a tanh(bz)  =>  dy/dz = b (a - y^2 / a)
        return TANH_B * (TANH_A - y * y / TANH_A)
    if activation == "relu":
        # y = log(1+e^z)  =>  dy/dz = 1 - e^{-y}
        return 1.0 - torch.exp(-y)
    if activation == "strict_relu":
        return (y > 0.0).to(y.dtype)
    if activation == "sigmoid":
        return y * (1.0 - y)
    raise ValueError("unknown activation %r" % (activation,))


# --------------------------------------------------------------------- dense
def dense_forward(x, weights, bias, activation="linear"):
    """All2All forward: y = act(x @ W + b); x (batch, n_in), weights
    (n_in, n_out), bias (n_out,) or None."""
    z = matmul(x.reshape(x.shape[0], -1), weights)
    if bias is not None:
        z = z + bias
    return activate(z, activation)


def dense_backward(x, y, err_output, weights, activation="linear",
                   include_bias=True, need_err_input=True):
    """All2All backward: (err_input, grad_weights, grad_bias).  Gradients
    are SUMS over the batch (the update normalizes by the live batch
    size); ``need_err_input=False`` skips the dL/dx product."""
    x2 = x.reshape(x.shape[0], -1)
    dz = err_output * activation_derivative_from_output(y, activation)
    grad_weights = matmul(x2.T, dz)
    grad_bias = dz.sum(dim=0) if include_bias else None
    err_input = (matmul(dz, weights.T).reshape(x.shape)
                 if need_err_input else None)
    return err_input, grad_weights, grad_bias


# ---------------------------------------------------------------- evaluators
def softmax_loss(probs, labels, valid_mask):
    """Softmax+NLL evaluator: (err_output, metrics) with err_output =
    (probs − onehot)·mask, the gradient w.r.t. the LOGITS, and device
    metrics ``n_err`` (int32), ``loss_sum`` and the int32 ``confusion``
    counts [label, prediction] (a scatter-add).  ``argmax`` ties resolve
    to the first index, as in JAX."""
    n_classes = probs.shape[-1]
    labels = labels.long()
    onehot = torch.nn.functional.one_hot(labels, n_classes).to(probs.dtype)
    mask = valid_mask.to(probs.dtype)
    err_output = (probs - onehot) * mask[:, None]
    pred = torch.argmax(probs, dim=-1)
    wrong = (pred != labels) & (valid_mask > 0)
    n_err = wrong.sum(dtype=torch.int32)
    picked = probs.gather(-1, labels[:, None])[:, 0]
    nll = -torch.log(torch.clamp_min(picked, 1e-30))
    loss_sum = (nll * mask).sum()
    confusion = torch.zeros((n_classes, n_classes), dtype=torch.int32,
                            device=probs.device)
    confusion.index_put_((labels, pred), valid_mask.to(torch.int32),
                         accumulate=True)
    return err_output, {"n_err": n_err, "loss_sum": loss_sum,
                        "confusion": confusion}


def mse_loss(output, target, valid_mask):
    """MSE evaluator: err_output = (output − target)·mask, metric sums."""
    mask = valid_mask.to(output.dtype).reshape(
        (-1,) + (1,) * (output.dim() - 1))
    diff = (output - target) * mask
    per_sample = torch.sqrt((diff * diff).reshape(diff.shape[0], -1)
                            .sum(dim=1))
    return diff, {
        "mse_sum": (per_sample * per_sample).sum(),
        "rmse_max": per_sample.max(),
        "loss_sum": 0.5 * (diff * diff).sum(),
    }


# -------------------------------------------------------------- convolution
def _norm_padding(padding):
    """"SAME"/"VALID" pass through; int or (int, int) become symmetric
    per-dimension (lo, hi) pairs."""
    if isinstance(padding, int):
        return [(padding, padding), (padding, padding)]
    if (isinstance(padding, (tuple, list)) and len(padding) == 2
            and all(isinstance(p, int) for p in padding)):
        return [(padding[0], padding[0]), (padding[1], padding[1])]
    return padding


def conv_pads(in_hw, k_hw, stride, padding):
    """Per-dimension (lo, hi) pads of a conv.  "SAME" follows XLA's rule:
    out = ceil(in / stride) and the odd extra pad goes on the HIGH
    side; "VALID" pads nothing."""
    padding = _norm_padding(padding)
    if padding == "VALID":
        return [(0, 0), (0, 0)]
    if padding == "SAME":
        pads = []
        for size, k, s in zip(in_hw, k_hw, stride):
            total = max((-(-size // s) - 1) * s + k - size, 0)
            pads.append((total // 2, total - total // 2))
        return pads
    if isinstance(padding, str):
        raise ValueError("unknown padding %r" % (padding,))
    return [tuple(int(v) for v in p) for p in padding]


def conv2d_output_hw(in_hw, k_hw, stride, padding):
    """(oh, ow) of a conv, from arithmetic."""
    pads = conv_pads(in_hw, k_hw, stride, padding)
    return tuple((size + lo + hi - k) // s + 1 for size, k, s, (lo, hi)
                 in zip(in_hw, k_hw, stride, pads))


def _oihw(weights):
    """HWIO weights as an OIHW tensor in channels_last memory (OHWI)."""
    return weights.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)


def _padded_nchw(x, pads):
    """The NHWC input as an NCHW (channels_last) view, with the conv's
    pads: symmetric pads go to the conv itself ((ph, pw) returned),
    asymmetric ones are applied here as explicit zeros."""
    xv = x.permute(0, 3, 1, 2)
    if all(lo == hi for lo, hi in pads):
        return xv, (pads[0][0], pads[1][0])
    (lh, hh), (lw, hw) = pads
    xv = torch.nn.functional.pad(xv, (lw, hw, lh, hh)).contiguous(
        memory_format=torch.channels_last)
    return xv, (0, 0)


def conv2d_preact(x, weights, bias, stride=(1, 1), padding="VALID"):
    """The pre-activation z of a 2-D convolution: NHWC x, HWIO weights
    (kh, kw, cin, cout), bias (cout,) or None.  Returns NHWC z."""
    pads = conv_pads(x.shape[1:3], weights.shape[:2], stride, padding)
    xv, pad = _padded_nchw(x, pads)
    xc, wc = _conv_operands(xv, _oihw(weights))
    z = torch.nn.functional.conv2d(xc, wc, None, tuple(stride), pad)
    z = z.to(x.dtype).permute(0, 2, 3, 1)
    if bias is not None:
        z = z + bias
    return z.contiguous()


def conv2d_forward(x, weights, bias, stride=(1, 1), padding="VALID",
                   activation="linear"):
    """2-D convolution + activation, NHWC layout, HWIO weights; padding
    "SAME", "VALID", or an int/pair of ints applied symmetrically."""
    return activate(conv2d_preact(x, weights, bias, stride, padding),
                    activation)


def conv2d_backward(x, y, err_output, weights, stride=(1, 1),
                    padding="VALID", activation="linear", tie=None,
                    include_bias=True, need_err_input=True):
    """Conv backward: (err_input, grad_weights (HWIO), grad_bias) from
    the forward's input and output, without re-running the forward.

    err·activation' first — from the output y, except that ``strict_relu``
    takes ``tie`` (the forward's ``z == 0`` mask): the reference's
    ``jax.vjp`` of ``max(z, 0)`` gives 0.5 where z == 0, which y cannot
    tell from z < 0 — then ATen's convolution backward for the input and
    weight gradients (the input's skipped when ``need_err_input`` is
    False).  Gradients are batch SUMS."""
    if activation == "strict_relu":
        deriv = torch.where(y > 0.0, 1.0, torch.where(tie, 0.5, 0.0)).to(
            y.dtype)
    else:
        deriv = activation_derivative_from_output(y, activation)
    dz = err_output.reshape(y.shape) * deriv
    pads = conv_pads(x.shape[1:3], weights.shape[:2], stride, padding)
    xv, pad = _padded_nchw(x, pads)
    dzv, xc, wc = _conv_operands(dz.permute(0, 3, 1, 2), xv,
                                 _oihw(weights))
    grad_in, grad_w, _ = torch.ops.aten.convolution_backward(
        dzv, xc, wc, None, list(stride), list(pad), [1, 1], False, [0, 0],
        1, [need_err_input, True, False])
    grad_w = grad_w.to(weights.dtype).permute(2, 3, 1, 0).contiguous()
    grad_b = dz.sum(dim=(0, 1, 2)) if include_bias else None
    err_input = None
    if need_err_input:
        # explicit (asymmetric) pads: the gradient is the padded input's
        (lh, _), (lw, _) = pads
        h, w = x.shape[1:3]
        grad_in = grad_in[:, :, lh:lh + h, lw:lw + w] if xv.shape[2:] != (
            h, w) else grad_in
        err_input = grad_in.to(x.dtype).permute(0, 2, 3, 1).contiguous()
    return err_input, grad_w, grad_b


# ---------------------------------------------------------- transposed conv
def deconv_pads(k_hw, stride, padding, output_padding=0):
    """Per-dimension (lo, hi) pads of the stride-dilated input of a
    transposed conv, as ``lax.conv_transpose`` takes them.  "SAME" and
    "VALID" follow its ``_conv_transpose_padding``; an int or pairs are
    the forward conv's pads p, so the dilated input is padded k − 1 − p
    (raw), plus ``output_padding`` on the high side."""
    padding = _norm_padding(padding)
    if padding in ("SAME", "VALID"):
        pads = []
        for k, s in zip(k_hw, stride):
            if padding == "SAME":
                pad_len = k + s - 2
                pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
            else:
                pad_len = k + s - 2 + max(k - s, 0)
                pad_a = k - 1
            pads.append((pad_a, pad_len - pad_a))
        return pads
    if isinstance(padding, str):
        raise ValueError("unknown padding %r" % (padding,))
    extra = ((output_padding, output_padding)
             if isinstance(output_padding, int) else output_padding)
    return [(k - 1 - lo, k - 1 - hi + op)
            for k, (lo, hi), op in zip(k_hw, padding, extra)]


def deconv2d_output_hw(in_hw, k_hw, stride, padding, output_padding=0):
    """(oh, ow) of a transposed conv, from arithmetic."""
    pads = deconv_pads(k_hw, stride, padding, output_padding)
    return tuple((size - 1) * s + 1 + lo + hi - k + 1 for size, k, s, (lo, hi)
                 in zip(in_hw, k_hw, stride, pads))


def _deconv_weight(weights):
    """HWIO weights as ``conv_transpose2d``'s (in, out, kh, kw) kernel,
    spatially flipped: its transposed conv then correlates the dilated
    input with the weights unflipped, as ``lax.conv_transpose`` with
    ``transpose_kernel=False`` does."""
    return torch.flip(weights, (0, 1)).permute(2, 3, 0, 1).contiguous(
        memory_format=torch.channels_last)


def _edge_pads(pads, k_hw):
    """``F.pad``'s (w lo, w hi, h lo, h hi) that turn conv_transpose2d's
    unpadded output (the dilated input padded k − 1 a side) into the one
    under ``pads``: negative entries crop, positive ones add zeros."""
    (lh, hh), (lw, hw) = pads
    kh, kw = k_hw
    return (lw - kw + 1, hw - kw + 1, lh - kh + 1, hh - kh + 1)


def deconv2d_preact(x, weights, bias, stride=(1, 1), padding="SAME",
                    output_padding=0):
    """The pre-activation of a transposed conv (``lax.conv_transpose``,
    HWIO weights, I the input's channels, the kernel unflipped): cuDNN's
    transposed conv with the flipped kernel, then cropped or zero-padded
    to the reference's pads.  NHWC in and out."""
    k_hw = tuple(weights.shape[:2])
    pads = deconv_pads(k_hw, stride, padding, output_padding)
    xc, wc = _conv_operands(x.permute(0, 3, 1, 2), _deconv_weight(weights))
    z = torch.nn.functional.conv_transpose2d(xc, wc, None, tuple(stride))
    z = torch.nn.functional.pad(z, _edge_pads(pads, k_hw))
    z = z.to(x.dtype).permute(0, 2, 3, 1)
    if bias is not None:
        z = z + bias
    return z.contiguous()


def deconv2d_forward(x, weights, bias, stride=(1, 1), padding="SAME",
                     activation="linear", output_padding=0):
    """Transposed 2-D convolution + activation (the reference's
    ``deconv2d_forward``): upsamples by ``stride``; int padding means the
    transpose of a conv with that padding, ``output_padding`` extra
    high-side pixels (``(in + 2p − k) % s`` recovers the conv's input
    size)."""
    return activate(deconv2d_preact(x, weights, bias, stride, padding,
                                    output_padding), activation)


def deconv2d_backward(x, y, err_output, weights, stride=(1, 1),
                      padding="SAME", activation="linear", output_padding=0,
                      include_bias=True, need_err_input=True):
    """Transposed-conv backward: (err_input, grad_weights (HWIO),
    grad_bias), batch sums.  err·activation' from the output, the pad or
    crop undone (its adjoint is the opposite pad), then ATen's transposed
    convolution backward: a strided conv for the input's error and the
    weight gradient in the flipped kernel's layout, flipped back."""
    dz = (err_output.reshape(y.shape)
          * activation_derivative_from_output(y, activation))
    k_hw = tuple(weights.shape[:2])
    pads = deconv_pads(k_hw, stride, padding, output_padding)
    g = torch.nn.functional.pad(dz.permute(0, 3, 1, 2),
                                [-p for p in _edge_pads(pads, k_hw)])
    gc, xc, wc = _conv_operands(g, x.permute(0, 3, 1, 2),
                                _deconv_weight(weights))
    grad_in, grad_w, _ = torch.ops.aten.convolution_backward(
        gc, xc, wc, None, list(stride), [0, 0], [1, 1], True, [0, 0], 1,
        [need_err_input, True, False])
    grad_w = torch.flip(grad_w.to(weights.dtype),
                        (2, 3)).permute(2, 3, 0, 1).contiguous()
    grad_b = dz.sum(dim=(0, 1, 2)) if include_bias else None
    err_input = (grad_in.to(x.dtype).permute(0, 2, 3, 1).contiguous()
                 if need_err_input else None)
    return err_input, grad_w, grad_b


# ------------------------------------------------------------------ depooling
def depool(x, window=(2, 2), mode="nearest"):
    """Positional unpooling (the reference's ``depool``): "nearest"
    repeats each value over its window, "zero" puts it top-left and
    zero-fills."""
    kh, kw = window
    b, h, w, c = x.shape
    if mode == "nearest":
        return x[:, :, None, :, None, :].expand(b, h, kh, w, kw, c).reshape(
            b, h * kh, w * kw, c)
    if mode == "zero":
        out = x.new_zeros((b, h, kh, w, kw, c))
        out[:, :, 0, :, 0, :] = x
        return out.reshape(b, h * kh, w * kw, c)
    raise ValueError("unknown depooling mode %r" % (mode,))


def depool_backward(err, window=(2, 2), mode="nearest"):
    """The unpooling's vjp: each window's sum ("nearest"), or its
    top-left element ("zero")."""
    kh, kw = window
    b, hh, ww, c = err.shape
    e = err.reshape(b, hh // kh, kh, ww // kw, kw, c)
    if mode == "nearest":
        return e.sum(dim=(2, 4))
    if mode == "zero":
        return e[:, :, 0, :, 0, :].contiguous()
    raise ValueError("unknown depooling mode %r" % (mode,))


# ------------------------------------------------ standalone activation units
def activation_backward(x, err, activation):
    """The vjp of :func:`activate` at its INPUT x, as ``jax.vjp`` forms
    it (the standalone activation units' backward).  At exactly x = 0
    ``max(x, 0)`` sends half the cotangent each way (0.5 for
    ``strict_relu``), and ``abs`` takes the positive side, so the smooth
    relu's two terms cancel there (−0.5 + 0.5 = 0), as in the
    reference."""
    if activation == "tanh":
        t = torch.tanh(TANH_B * x)
        ct = err * TANH_A
        return (ct + ct * t) * (1.0 - t) * TANH_B
    if activation == "sigmoid":
        s = torch.sigmoid(x)
        return err * (s * (1.0 - s))
    if activation in ("relu", "strict_relu"):
        half = torch.where(x > 0.0, 1.0, torch.where(x == 0.0, 0.5, 0.0))
        ct_max = err * half.to(err.dtype)
        if activation == "strict_relu":
            return ct_max
        e = torch.exp(-torch.abs(x))
        ct_e = err / (e + 1.0) * e
        return torch.where(x >= 0.0, -ct_e, ct_e) + ct_max
    raise ValueError("unknown activation %r" % (activation,))


# ------------------------------------------------------------------- pooling
def _ceil_pad(size, k, s):
    """Right-pad so every input element is covered (ceil semantics: a 7x7
    input with 2x2/2 pooling yields 4x4, not 3x3)."""
    if size <= k:
        return max(k - size, 0)
    steps = -(-(size - k) // s)  # ceil division
    return steps * s + k - size


def pool_output_hw(in_hw, window, stride):
    """(oh, ow) of a ceil-padded pooling, from arithmetic."""
    return tuple((size + _ceil_pad(size, k, s) - k) // s + 1
                 for size, k, s in zip(in_hw, window, stride))


def _pool_padded(x, window, stride, value):
    """NHWC x as its NCHW (channels_last) view, right/bottom-padded with
    ``value`` to the ceil cover."""
    ph = _ceil_pad(x.shape[1], window[0], stride[0])
    pw = _ceil_pad(x.shape[2], window[1], stride[1])
    xv = x.permute(0, 3, 1, 2)
    if ph or pw:
        xv = torch.nn.functional.pad(xv, (0, pw, 0, ph), value=value)
    return xv


def _pool_plane(x, window, stride):
    """An uninitialized NCHW (channels_last) tensor of the padded plane's
    shape: the pooling backwards read only its geometry."""
    b, h, w, c = x.shape
    return torch.empty(
        (b, c, h + _ceil_pad(h, window[0], stride[0]),
         w + _ceil_pad(w, window[1], stride[1])), dtype=x.dtype,
        device=x.device).contiguous(memory_format=torch.channels_last)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).contiguous()


def max_pooling(x, window=(2, 2), stride=None):
    """Ceil-padded max pooling (tail windows padded with -inf); returns
    (y, argmax indices into the padded plane) — each window's first
    maximum in row-major order, XLA's select-and-scatter choice."""
    stride = tuple(stride or window)
    y, idx = torch.nn.functional.max_pool2d(
        _pool_padded(x, window, stride, float("-inf")), tuple(window),
        stride, return_indices=True)
    return _nhwc(y), idx


def _scatter_max(x, err, idx, window, stride):
    """Each window's gradient onto its argmax (summed where windows
    overlap), cropped back to x's plane."""
    g = torch.ops.aten.max_pool2d_with_indices_backward(
        err.permute(0, 3, 1, 2), _pool_plane(x, window, stride),
        list(window), list(stride), [0, 0], [1, 1], False, idx)
    return g[:, :, :x.shape[1], :x.shape[2]]


def max_pooling_backward(x, err, idx, window=(2, 2), stride=None):
    stride = tuple(stride or window)
    return _nhwc(_scatter_max(x, err, idx, window, stride))


def maxabs_pooling(x, window=(2, 2), stride=None):
    """Max-absolute-value pooling: the signed value of the abs-max
    element, out = mx if mx >= -mn else mn (ties to the positive one),
    from a max pool of x (-inf tail pad) and of -x (the min pool, +inf
    tail pad).  Returns (y, (choose_max, idx_max, idx_min))."""
    stride = tuple(stride or window)
    mx, imx = max_pooling(x, window, stride)
    neg_mn, imn = max_pooling(-x, window, stride)
    choose = mx >= neg_mn
    return torch.where(choose, mx, -neg_mn), (choose, imx, imn)


def maxabs_pooling_backward(x, err, saved, window=(2, 2), stride=None):
    stride = tuple(stride or window)
    choose, imx, imn = saved
    zero = torch.zeros((), dtype=err.dtype, device=err.device)
    return _nhwc(_scatter_max(x, torch.where(choose, err, zero), imx,
                              window, stride)
                 + _scatter_max(x, torch.where(choose, zero, err), imn,
                                window, stride))


def avg_pooling(x, window=(2, 2), stride=None):
    """Average pooling; tail windows are zero-padded and divided by the
    FULL window size."""
    stride = tuple(stride or window)
    return _nhwc(torch.nn.functional.avg_pool2d(
        _pool_padded(x, window, stride, 0.0), tuple(window), stride))


def avg_pooling_backward(x, err, window=(2, 2), stride=None):
    stride = tuple(stride or window)
    g = torch.ops.aten.avg_pool2d_backward(
        err.permute(0, 3, 1, 2), _pool_plane(x, window, stride),
        list(window), list(stride), [0, 0], False, True, None)
    return _nhwc(g[:, :, :x.shape[1], :x.shape[2]])


def _pool_patches(x, window, stride):
    """The ceil-padded pooling patches of NHWC ``x`` (zero tail pad), as
    (b, oh, ow, kh·kw, c): axis 3 enumerates the window row-major, the
    reference's ``conv_general_dilated_patches`` order."""
    kh, kw = window
    ph = _ceil_pad(x.shape[1], kh, stride[0])
    pw = _ceil_pad(x.shape[2], kw, stride[1])
    if ph or pw:
        x = torch.nn.functional.pad(x, (0, 0, 0, pw, 0, ph))
    p = x.unfold(1, kh, stride[0]).unfold(2, kw, stride[1])
    b, oh, ow, c = p.shape[:4]
    return p.reshape(b, oh, ow, c, kh * kw).transpose(3, 4)


def _key_words(rng):
    """A threefry key's two words: Python ints of a host key, or int64
    0-dim tensors of a key held as two int32 words in a tensor (on the
    card, the captured epoch scan's), never read on the host."""
    if isinstance(rng, torch.Tensor):
        w = rng.to(torch.int64) & 0xFFFFFFFF
        return w[0], w[1]
    from veles_tpu_torch.ops.hopper_kernels import _as_key
    return tuple(int(w) for w in _as_key(rng))


def stochastic_pooling(x, window=(2, 2), stride=None, rng=None, train=True,
                       use_abs=False):
    """Zeiler-style stochastic pooling (ref: veles/znicz/pooling.py::
    StochasticPooling / StochasticAbsPooling [H]): each window's
    probabilities are its relu'd (or absolute) values over their sum,
    uniform on an all-zero window.  Train: one position a window drawn
    by the Gumbel trick, the argmax of log(max(p, 1e-30)) + gumbel with
    jax's ``gumbel(rng, probs.shape)`` (the threefry bits of the flat
    counters under ``rng``); the output is the SIGNED value there.
    Eval: the probability-weighted sum.  Returns (y, idx), idx the
    chosen positions (b, oh, ow, 1, c) in training, None in eval.  A
    :class:`RowShard` key draws the rank's rows of the global draw
    (counter offset rank·numel).  Plain PyTorch, as the reference
    leaves it to XLA."""
    stride = tuple(stride or window)
    patches = _pool_patches(x, window, stride)
    weights = patches.abs() if use_abs else torch.clamp(patches, min=0.0)
    total = weights.sum(dim=3, keepdim=True)
    k = patches.shape[3]
    probs = torch.where(total > 0, weights / torch.clamp(total, min=1e-30),
                        torch.full_like(total, 1.0 / k))
    if not train:
        return (probs * patches).sum(dim=3), None
    if rng is None:
        raise ValueError("stochastic pooling needs rng when train=True")
    from veles_tpu_torch import prng
    offset = 0
    if isinstance(rng, RowShard):
        rng, rank, _ = rng
        offset = rank * probs.numel()
    k0, k1 = _key_words(rng)
    counters = torch.arange(offset, offset + probs.numel(),
                            dtype=torch.int64, device=x.device)
    gumbel = prng.gumbel_tensor(prng.bits_words(k0, k1, counters))
    scores = torch.log(torch.clamp(probs, min=1e-30)) \
        + gumbel.reshape(probs.shape)
    idx = scores.argmax(dim=3, keepdim=True)
    return torch.gather(patches, 3, idx)[:, :, :, 0, :], idx


def stochastic_pooling_backward(x, err, idx, window=(2, 2), stride=None):
    """The vjp of the training forward (the reference's autodiff of
    ``take_along_axis``): each window's gradient onto its chosen
    position, summed where windows overlap, cropped back to x's
    plane."""
    stride = tuple(stride or window)
    kh, kw = window
    b, h, w, c = x.shape
    oh, ow, k = idx.shape[1], idx.shape[2], kh * kw
    g = torch.zeros((b, oh, ow, k, c), dtype=err.dtype, device=err.device)
    g.scatter_(3, idx, err[:, :, :, None, :])
    hp = h + _ceil_pad(h, kh, stride[0])
    wp = w + _ceil_pad(w, kw, stride[1])
    cols = g.permute(0, 4, 3, 1, 2).reshape(b, c * k, oh * ow)
    plane = torch.nn.functional.fold(cols, (hp, wp), window, stride=stride)
    return _nhwc(plane[:, :, :h, :w])


# ------------------------------------------------- local response norm (LRN)
_BACKENDS = ("xla", "pallas")


def set_lrn_backend(mode):
    """mode: 'xla' | 'pallas', the reference's names and errors.  The
    port's route does not depend on it: a CUDA tensor goes through the
    hand-written kernel (its one route on the card) and a CPU tensor
    through the kernel's plain version, which equals the reference's
    'xla' route within fp32 roundoff and its 'pallas' route bit for
    bit."""
    if mode not in _BACKENDS:
        raise ValueError("unknown lrn backend %r" % (mode,))


def lrn_forward(x, alpha=1e-4, beta=0.75, n=5, k=2.0):
    """AlexNet cross-channel LRN over the last axis, through the
    hand-written kernel's wrapper: returns (y, d), d the denominator
    the backward takes."""
    from veles_tpu_torch.ops.hopper_kernels import lrn_forward as kernel
    return kernel(x.contiguous(), alpha, beta, n, k)


def lrn_backward(x, d, err, alpha=1e-4, beta=0.75, n=5):
    from veles_tpu_torch.ops.hopper_kernels import lrn_backward as kernel
    return kernel(x.contiguous(), d, err.contiguous(), alpha, beta, n)


# ------------------------------------------------------------------- dropout
class RowShard(tuple):
    """A stochastic layer's key on a data-parallel rank: ``(key, rank,
    ranks)``.  The rank's batch is rows [rank·b, (rank + 1)·b) of a
    global batch of ranks·b rows, and it draws exactly those rows of the
    global batch's draws (as a sharded run of the reference's
    partitionable threefry does): dropout hashes with the element offset
    rank·numel, a crop makes the global batch's draws and keeps its
    rows."""

    __slots__ = ()


def dropout(x, rng, rate, train):
    """Inverted Bernoulli dropout through the kernel's wrapper; the mask
    is regenerated from the same key in the backward (the same call on
    the cotangent).  Eval, or rate <= 0, is the identity.  A
    :class:`RowShard` key draws the rank's rows of the global mask."""
    if not train or rate <= 0.0:
        return x
    from veles_tpu_torch.ops.hopper_kernels import dropout as kernel
    offset = 0
    if isinstance(rng, RowShard):
        rng, rank, _ = rng
        offset = rank * x.numel()
    return kernel(x.contiguous(), rng, rate, offset)


# -------------------------------------------------------------- augmentation
class CropDraws(tuple):
    """A random crop's draws already made: (rows (b, oh), cols (b, ow))
    int64 source indices on the input's device — what a crop layer takes
    in place of its key inside a captured step (the epoch scan makes
    them on the host from the same key, a chunk at a time)."""

    __slots__ = ()


def crop_draws(rng, shape, out_hw, flip):
    """The crop's per-sample source indices for an input of ``shape``
    (b, h, w, ...) under the host key ``rng``, as one (b, oh + ow) int64
    numpy array (rows then cols).  The draws — ``split(rng, 3)``,
    ``randint`` for the tops and lefts, ``bernoulli(0.5)`` for the
    mirrors — are jax's bits exactly."""
    from veles_tpu_torch import prng
    b, h, w = shape[:3]
    oh, ow = out_hw
    k_top, k_left, k_flip = prng.split(rng, 3)
    tops = prng.randint(k_top, (b,), 0, h - oh + 1).astype(numpy.int64)
    lefts = prng.randint(k_left, (b,), 0, w - ow + 1).astype(numpy.int64)
    cols = numpy.arange(ow)[None, :].repeat(b, 0)
    if flip:
        mirror = prng.bernoulli(k_flip, 0.5, (b,))
        cols[mirror] = cols[mirror][:, ::-1]
    return numpy.concatenate([tops[:, None] + numpy.arange(oh)[None, :],
                              lefts[:, None] + cols], axis=1)


def _crop_index(x, rng, out_hw, flip, train):
    """Per-sample (rows (b, oh), cols (b, ow)) source indices, or None for
    the eval center crop: ``rng`` itself when it is :class:`CropDraws`,
    else :func:`crop_draws` of the host key (a :class:`RowShard`'s rows of
    the global batch's), uploaded once."""
    if not train or rng is None:
        return None
    if isinstance(rng, CropDraws):
        return rng
    oh = out_hw[0]
    if isinstance(rng, RowShard):
        rng, rank, ranks = rng
        b = x.shape[0]
        draws = crop_draws(rng, (b * ranks,) + tuple(x.shape[1:]), out_hw,
                           flip)[rank * b:(rank + 1) * b]
    else:
        draws = crop_draws(rng, x.shape, out_hw, flip)
    index = torch.as_tensor(draws).to(x.device)
    return index[:, :oh], index[:, oh:]


def random_crop_flip(x, rng, out_hw, flip=True, train=True):
    """AlexNet augmentation: per-sample random crop (+ horizontal mirror)
    in training, the center crop in eval (or with no key)."""
    b, h, w = x.shape[:3]
    oh, ow = out_hw
    index = _crop_index(x, rng, out_hw, flip, train)
    if index is None:
        top, left = (h - oh) // 2, (w - ow) // 2
        return x[:, top:top + oh, left:left + ow].contiguous()
    rows, cols = index
    batch = torch.arange(b, device=x.device)[:, None, None]
    return x[batch, rows[:, :, None], cols[:, None, :]]


def random_crop_flip_backward(x, err, rng, out_hw, flip=True, train=True):
    """The crop's vjp: each sample's gradient scattered back into its
    source window (the same draws, replayed from the key), zeros
    elsewhere."""
    b, h, w = x.shape[:3]
    oh, ow = out_hw
    grad = torch.zeros_like(x)
    index = _crop_index(x, rng, out_hw, flip, train)
    if index is None:
        top, left = (h - oh) // 2, (w - ow) // 2
        grad[:, top:top + oh, left:left + ow] = err
        return grad
    rows, cols = index
    batch = torch.arange(b, device=x.device)[:, None, None]
    grad[batch, rows[:, :, None], cols[:, None, :]] = err
    return grad


# ----------------------------------------------------------------- kohonen
def _device_scalar(value, like):
    """``value`` as a 0-dim tensor of ``like``'s type and device: a
    tensor passes through, a number becomes a fill on the device (no
    host copy), rounded to fp32 once, as the reference's ``jnp.asarray``
    of a host schedule value."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.full((), float(numpy.float32(value)), dtype=like.dtype,
                      device=like.device)


def kohonen_distances(x, weights):
    """Squared euclidean distances (mb, n_neurons) between samples and
    SOM codebook vectors, ``x² − 2x·w + w²`` with the cross term through
    :func:`matmul` (the reference's ``functional.py:516``)."""
    x = x.reshape(x.shape[0], -1)
    x2 = (x * x).sum(dim=1)[:, None]
    w2 = (weights * weights).sum(dim=1)[None, :]
    return x2 - 2.0 * matmul(x, weights.T) + w2


def kohonen_winners(x, weights):
    """(winner_index, min_sq_distance) per sample — the SOM forward.
    ``argmin`` takes the first minimum, as ``jnp.argmin`` does."""
    d = kohonen_distances(x, weights)
    return torch.argmin(d, dim=1), d.min(dim=1).values


def kohonen_update(weights, x, mask, grid, learning_rate, sigma):
    """One batch SOM update (the reference's ``functional.py:538``):

        w_n += lr/B * Σ_b h(b, n) (x_b - w_n),
        h(b, n) = exp(-||grid_n - grid_win(b)||² / (2σ²))

    with B the live rows; masked rows move nothing.  ``learning_rate``
    and ``sigma`` are fp32 0-dim tensors or numbers (see
    :func:`_device_scalar`).  Returns (new_weights, metrics) with the
    quantization-error sum as a device tensor."""
    lr = _device_scalar(learning_rate, weights)
    sigma = _device_scalar(sigma, weights)
    x = x.reshape(x.shape[0], -1)
    d = kohonen_distances(x, weights)
    winners = torch.argmin(d, dim=1)
    qe_sum = (torch.sqrt(torch.clamp_min(d.min(dim=1).values, 0.0))
              * mask).sum()
    wcoord = grid[winners]                               # (mb, 2)
    gd2 = ((grid[None, :, :] - wcoord[:, None, :]) ** 2).sum(-1)
    h = torch.exp(-gd2 / (2.0 * sigma * sigma)) * mask[:, None]
    batch = torch.clamp_min(mask.sum(), 1.0)
    num = matmul(h.T, x)                                 # (n_neurons, n_in)
    den = h.sum(dim=0)[:, None]
    new_w = weights + lr * (num - den * weights) / batch
    return new_w, {"qe_sum": qe_sum, "loss_sum": qe_sum}


# ---------------------------------------------------------------------- rbm
def rbm_hidden(v, weights, hbias):
    """P(h=1 | v) — sigmoid(v @ W + hb) (the reference's
    ``functional.py:561``)."""
    return torch.sigmoid(matmul(v.reshape(v.shape[0], -1), weights) + hbias)


def rbm_visible(h, weights, vbias):
    """P(v=1 | h) — sigmoid(h @ W^T + vb)."""
    return torch.sigmoid(matmul(h, weights.T) + vbias)


def bernoulli(key, p):
    """``jax.random.bernoulli(key, p).astype(float32)`` for a tensor
    ``p`` through the kernel's wrapper (its plain version on the CPU);
    ``key`` is a host key."""
    from veles_tpu_torch.ops.hopper_kernels import bernoulli as kernel
    return kernel(key, p.contiguous())


def rbm_cd_step(weights, vbias, hbias, v0, mask, rng, learning_rate,
                cd_k=1):
    """One contrastive-divergence (CD-k) update (the reference's
    ``functional.py:575``): positive phase from the data, negative phase
    from ``cd_k`` Gibbs steps, step i drawing its hidden samples with
    ``fold_in(rng, i)`` (``rng`` a host key; the fold is host work);
    the final statistics use probabilities.  Gradients are batch means
    over live rows.  Returns (new_w, new_vb, new_hb, metrics) with the
    summed per-sample reconstruction error as a device tensor."""
    from veles_tpu_torch import prng
    lr = _device_scalar(learning_rate, weights)
    v0 = v0.reshape(v0.shape[0], -1)
    m = mask[:, None]
    batch = torch.clamp_min(mask.sum(), 1.0)
    h0 = rbm_hidden(v0, weights, hbias)
    vk, hk = v0, h0
    for i in range(cd_k):
        h_samp = bernoulli(prng.fold_in(rng, i), hk)
        vk = rbm_visible(h_samp, weights, vbias)
        hk = rbm_hidden(vk, weights, hbias)
    grad_w = (matmul((v0 * m).T, h0) - matmul((vk * m).T, hk)) / batch
    grad_vb = ((v0 - vk) * m).sum(dim=0) / batch
    grad_hb = ((h0 - hk) * m).sum(dim=0) / batch
    recon = torch.sqrt((((v0 - vk) * m) ** 2).sum(dim=1)).sum()
    return (weights + lr * grad_w, vbias + lr * grad_vb,
            hbias + lr * grad_hb, {"recon_sum": recon, "loss_sum": recon})


# ------------------------------------------------------------------- updates
def set_sgd_backend(mode):
    """mode: 'xla' | 'pallas', the reference's names and errors.  The
    port's route does not depend on it: every momentum update goes
    through the fused kernel on the card and its plain version on the
    CPU, which equals the reference's 'pallas' route bit for bit (its
    'xla' route divides by the batch where the kernel multiplies, ≤ 2
    ulps apart)."""
    if mode not in _BACKENDS:
        raise ValueError("unknown sgd backend %r" % (mode,))


def sgd_update(param, velocity, grad, batch_size, learning_rate, momentum,
               weight_decay, l1_vs_l2, gradient_clip):
    """Momentum-SGD with mixed L1/L2 decay and optional clipping, through
    the fused kernel's wrapper (the plain version on CPU tensors).
    Gradients arrive as batch SUMS.  Returns new (param, velocity)."""
    from veles_tpu_torch.ops.hopper_kernels import fused_sgd_update
    return fused_sgd_update(param, velocity, grad, batch_size,
                            learning_rate, momentum, weight_decay, l1_vs_l2,
                            gradient_clip)


def sgd_update_multi(items, operands=None, out=None):
    """:func:`sgd_update` of several tensors at once: ``items`` are
    (param, velocity, grad, scalars) with each tensor's own ``scalars``
    (``(batch_size, learning_rate, momentum, weight_decay, l1_vs_l2,
    gradient_clip)``), one launch of the fused kernel on the card for the
    whole list.  With ``operands`` (a step's 1-D fp32 operand row on the
    tensors' device) the first two scalars are instead the offsets of
    the tensor's inv_batch and learning rate in it, which the kernel
    reads on the card.  ``out``: (new params, new velocities) to write.
    Returns [(new param, new velocity), ...]."""
    from veles_tpu_torch.ops import hopper_kernels as HK
    params, velocities, grads, scalars = zip(*items)
    if operands is None and out is None:
        new = HK.fused_sgd_update_multi(params, velocities, grads, scalars)
    elif operands is None:
        new = HK.fused_sgd_update_multi(params, velocities, grads, scalars,
                                        out=out)
    else:
        new = HK.fused_sgd_update_multi_dev(
            params, velocities, grads, operands,
            [s[:2] for s in scalars], [s[2:] for s in scalars], out=out)
    return list(zip(*new))


def _as_scalar(value, like):
    """``value`` as an fp32 0-dim tensor on ``like``'s device: a tensor
    passes through, a number becomes a fill (no host copy)."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.full((), float(numpy.float32(value)), dtype=like.dtype,
                      device=like.device)


def _effective_grad(param, grad, batch_size, weight_decay, l1_vs_l2,
                    gradient_clip):
    """Batch-normalized gradient + mixed L1/L2 decay + optional clipping
    — the preprocessing the adaptive solvers share.  ``batch_size`` is an
    int, or an fp32 0-dim tensor already holding max(batch, 1) (a step
    operand); either way the division is a true fp32 division, as the
    reference's."""
    if not isinstance(batch_size, torch.Tensor):
        batch_size = _as_scalar(max(int(batch_size), 1), grad)
    g = grad / batch_size
    if gradient_clip is not None and gradient_clip > 0.0:
        g = g.clamp(-gradient_clip, gradient_clip)
    if weight_decay:
        decay = l1_vs_l2 * torch.sign(param) + (1.0 - l1_vs_l2) * param
        g = g + weight_decay * decay
    return g


def adaptive_update(param, velocity, accum, grad, batch_size, learning_rate,
                    momentum, weight_decay, l1_vs_l2, gradient_clip,
                    solver="momentum", rho=0.95, epsilon=1e-6, step=0):
    """Per-parameter update with a selectable solver (the reference's
    ``adaptive_update``): ``momentum`` (the fused kernel; ``accum``
    ignored), ``adagrad``, ``adadelta`` (velocity doubles as E[Δx²]) and
    ``adam`` (β1 = momentum, None meaning 0.9; β2 = rho; bias correction
    from the global ``step``).  ``batch_size``, ``learning_rate`` and
    ``step`` may be fp32 0-dim tensors on the param's device (a step's
    operands).  Returns ``(param, velocity, accum)``."""
    if solver == "momentum":
        new_p, new_v = sgd_update(param, velocity, grad, batch_size,
                                  learning_rate,
                                  0.0 if momentum is None else momentum,
                                  weight_decay, l1_vs_l2, gradient_clip)
        return new_p, new_v, accum
    g = _effective_grad(param, grad, batch_size, weight_decay, l1_vs_l2,
                        gradient_clip)
    if solver == "adagrad":
        accum = accum + g * g
        return (param - learning_rate * g / torch.sqrt(accum + epsilon),
                velocity, accum)
    if solver == "adadelta":
        accum = rho * accum + (1.0 - rho) * g * g
        dx = -learning_rate * (torch.sqrt(velocity + epsilon)
                               / torch.sqrt(accum + epsilon)) * g
        velocity = rho * velocity + (1.0 - rho) * dx * dx
        return param + dx, velocity, accum
    if solver == "adam":
        beta1 = 0.9 if momentum is None else momentum
        # fp32 step on the param's device (a fill, not a host copy)
        t = _as_scalar(step, param) + 1.0
        velocity = beta1 * velocity + (1.0 - beta1) * g
        accum = rho * accum + (1.0 - rho) * g * g
        m_hat = velocity / (1.0 - beta1 ** t)
        v_hat = accum / (1.0 - rho ** t)
        return (param - learning_rate * m_hat
                / (torch.sqrt(v_hat) + epsilon),
                velocity, accum)
    raise ValueError("unknown solver %r" % (solver,))
