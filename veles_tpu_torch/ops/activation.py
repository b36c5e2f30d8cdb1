"""Standalone activation units (forward/backward pairs).

Port of ``veles_tpu/ops/activation.py`` (ref: veles/znicz/activation.py::
ForwardTanh/ForwardSigmoid/... and their backward halves [H]).  The
forward is :func:`functional.activate` (the fused dense/conv variants'
semantics); the backward is :func:`functional.activation_backward`, the
reference's ``jax.vjp`` taken at the input — including exact zeros,
where ``max(x, 0)`` splits the cotangent in halves.
"""

from __future__ import annotations

import torch

from veles_tpu_torch.ops.nn_units import (TransformUnit, TransformGD,
                                          register_layer_type,
                                          register_gd_for)
from veles_tpu_torch.ops import functional as F


class ActivationBase(TransformUnit):
    ACTIVATION = "linear"

    def transform(self, x, rng=None, train=False):
        return F.activate(x, self.ACTIVATION), None

    def backward(self, x, y, err, saved, rng=None):
        return F.activation_backward(x, err, self.ACTIVATION)


@register_layer_type("activation_tanh")
class ForwardTanh(ActivationBase):
    """LeCun-scaled tanh, standalone."""

    ACTIVATION = "tanh"


@register_layer_type("activation_sigmoid")
class ForwardSigmoid(ActivationBase):
    ACTIVATION = "sigmoid"


@register_layer_type("activation_relu")
class ForwardRELU(ActivationBase):
    """Smooth relu log(1+exp(x)) — the reference's RELU."""

    ACTIVATION = "relu"


@register_layer_type("activation_str")
class ForwardStrictRELU(ActivationBase):
    ACTIVATION = "strict_relu"


@register_layer_type("activation_log")
class ForwardLog(ActivationBase):
    """y = log(x + sqrt(x^2 + 1)) (asinh) — the reference's 'log' unit."""

    def transform(self, x, rng=None, train=False):
        return torch.asinh(x), None

    def backward(self, x, y, err, saved, rng=None):
        return err * torch.rsqrt(x * x + 1.0)


@register_layer_type("activation_mul")
class ForwardMul(ActivationBase):
    """y = k * x elementwise scale."""

    def __init__(self, workflow, factor=1.0, **kwargs):
        super().__init__(workflow, **kwargs)
        self.factor = float(factor)

    def transform(self, x, rng=None, train=False):
        return x * self.factor, None

    def backward(self, x, y, err, saved, rng=None):
        return err * self.factor


@register_gd_for(ActivationBase)
class BackwardActivation(TransformGD):
    """The backward of every standalone activation (the reference shipped
    a backward class per activation — BackwardTanh, BackwardRELU, ...)."""


BackwardTanh = BackwardSigmoid = BackwardRELU = BackwardStrictRELU = \
    BackwardLog = BackwardMul = BackwardActivation
