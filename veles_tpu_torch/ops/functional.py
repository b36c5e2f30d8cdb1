"""Pure numeric functions behind every accelerated unit.

Port of ``veles_tpu/ops/functional.py``, two subsets so far: the matmul
precision policy every op routes its products through (``:37-90``), and
the MNIST-FC training path — activations and their derivatives from the
forward output (``:103-138``), the dense forward/backward (``:142-169``),
the softmax and MSE evaluators (``:173-216``) and the update rules
(``:624-719``).  Activation semantics follow the reference exactly:
``tanh`` is the LeCun-scaled ``1.7159 * tanh(0.6666 x)``, ``relu`` the
smooth ``log(1 + exp(x))``, ``strict_relu`` is ``max(0, x)``.  Every
momentum update goes through the hand-written kernel's wrapper
(:func:`veles_tpu_torch.ops.hopper_kernels.fused_sgd_update`), clipped or
not; the adaptive solvers are plain tensor code, as the reference left
them to XLA.

Precision modes:

- ``"float32"`` (default, the parity mode): full fp32 products.  On the
  card that means TF32 OFF in cuBLAS and cuDNN
  (``torch.backends.cuda.matmul.allow_tf32`` and
  ``torch.backends.cudnn.allow_tf32`` both False); the mode sets both,
  and ``LMEngine`` sets them again where it is built.
- ``"bfloat16"`` (fast): operands are cast to bf16, the product
  accumulates in fp32 inside the library, and the result is cast back
  to the operands' type — what the reference's bf16 mode does.

Large products stay ``torch.matmul`` (cuBLAS), as the reference left
them to XLA.
"""

from __future__ import annotations

import contextlib

import torch

_MODES = ("float32", "bfloat16")


class _Policy:
    """The process-wide precision mode (the reference's module state)."""
    mode = "float32"


def pin_fp32_matmul():
    """Full-precision fp32 products in cuBLAS and cuDNN (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def set_matmul_precision(mode):
    """mode: 'float32' (default, parity) | 'bfloat16' (fast)."""
    if mode not in _MODES:
        raise ValueError("unknown matmul precision mode %r" % (mode,))
    if mode == "float32":
        pin_fp32_matmul()
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


# ------------------------------------------------------------------- updates
def sgd_update(param, velocity, grad, batch_size, learning_rate, momentum,
               weight_decay, l1_vs_l2, gradient_clip):
    """Momentum-SGD with mixed L1/L2 decay and optional clipping, through
    the fused kernel's wrapper (the plain version on CPU tensors).
    Gradients arrive as batch SUMS.  Returns new (param, velocity)."""
    from veles_tpu_torch.ops.hopper_kernels import fused_sgd_update
    return fused_sgd_update(param, velocity, grad, batch_size,
                            learning_rate, momentum, weight_decay, l1_vs_l2,
                            gradient_clip)


def _effective_grad(param, grad, batch_size, weight_decay, l1_vs_l2,
                    gradient_clip):
    """Batch-normalized gradient + mixed L1/L2 decay + optional clipping
    — the preprocessing the adaptive solvers share."""
    g = grad / float(max(int(batch_size), 1))
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
    from the global ``step``).  Returns ``(param, velocity, accum)``."""
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
        t = torch.full((), float(step) + 1.0, dtype=param.dtype,
                       device=param.device)
        velocity = beta1 * velocity + (1.0 - beta1) * g
        accum = rho * accum + (1.0 - rho) * g * g
        m_hat = velocity / (1.0 - beta1 ** t)
        v_hat = accum / (1.0 - rho ** t)
        return (param - learning_rate * m_hat
                / (torch.sqrt(v_hat) + epsilon),
                velocity, accum)
    raise ValueError("unknown solver %r" % (solver,))
