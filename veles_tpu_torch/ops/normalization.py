"""Local response normalization (AlexNet LRN).

Port of ``veles_tpu/ops/normalization.py`` (ref: veles/znicz/
normalization.py::LRNormalizerForward/LRNormalizerBackward [H]).  Both
directions go through the hand-written kernels (``csrc/lrn.cu``): a
training forward keeps the denominator d, and the backward takes it, as
the reference's Pallas custom VJP keeps (x, d) — the forward runs once
per train step.
"""

from __future__ import annotations

from veles_tpu_torch.ops.nn_units import (TransformUnit, TransformGD,
                                          register_layer_type,
                                          register_gd_for)
from veles_tpu_torch.ops import functional as F


@register_layer_type("norm")
class LRNormalizerForward(TransformUnit):
    """Cross-channel LRN with the reference's default hyperparameters."""

    def __init__(self, workflow, alpha=1e-4, beta=0.75, n=5, k=2.0,
                 **kwargs):
        super().__init__(workflow, **kwargs)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.n = int(n)
        self.k = float(k)

    def transform(self, x, rng=None, train=False):
        return F.lrn_forward(x, self.alpha, self.beta, self.n, self.k)

    def backward(self, x, y, err, saved, rng=None):
        return F.lrn_backward(x, saved, err, self.alpha, self.beta, self.n)


@register_gd_for(LRNormalizerForward)
class LRNormalizerBackward(TransformGD):
    """The LRN backward kernel on the kept denominator."""
