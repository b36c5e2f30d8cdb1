"""Dropout forward/backward.

Port of ``veles_tpu/ops/dropout.py`` (ref: veles/znicz/dropout.py::
DropoutForward/DropoutBackward [H]).  Training goes through the
hand-written kernel (``csrc/dropout.cu``), whose mask is jax's
``bernoulli(key, 1 - rate, shape)`` bit for bit; the backward is the
same kernel on the cotangent with the same key, so no mask is stored.
Inverted scaling (x / keep), so eval is the identity.
"""

from __future__ import annotations

from veles_tpu_torch.ops.nn_units import (TransformUnit, TransformGD,
                                          register_layer_type,
                                          register_gd_for)
from veles_tpu_torch.ops import functional as F


@register_layer_type("dropout")
class DropoutForward(TransformUnit):
    STOCHASTIC = True

    def __init__(self, workflow, dropout_ratio=0.5, **kwargs):
        super().__init__(workflow, **kwargs)
        self.dropout_ratio = float(dropout_ratio)

    def transform(self, x, rng=None, train=False):
        return F.dropout(x, rng, self.dropout_ratio, train), None

    def backward(self, x, y, err, saved, rng=None):
        return F.dropout(err, rng, self.dropout_ratio, True)


@register_gd_for(DropoutForward)
class DropoutBackward(TransformGD):
    """Mask replay from the key (see module docstring)."""
