"""Depooling (unpooling) unit — the autoencoder's pooling mirror.

Port of ``veles_tpu/ops/depooling.py`` (ref: veles/znicz/depooling.py::
Depooling [H]).  Positional unpooling (:func:`functional.depool`):
"nearest" repeats each value over its window, "zero" puts it top-left;
the backward is the window sum or the top-left gather.
"""

from __future__ import annotations

from veles_tpu_torch.ops.nn_units import (TransformUnit, TransformGD,
                                          register_layer_type,
                                          register_gd_for)
from veles_tpu_torch.ops import functional as F


@register_layer_type("depooling")
class Depooling(TransformUnit):
    """Config: kx, ky (upsample factors), mode ("nearest" | "zero")."""

    def __init__(self, workflow, kx=2, ky=2, mode="nearest", **kwargs):
        super().__init__(workflow, **kwargs)
        self.kx = int(kx)
        self.ky = int(ky)
        self.mode = mode

    def output_shape(self, input_shape):
        b, h, w, c = input_shape
        return (b, h * self.ky, w * self.kx, c)

    def transform(self, x, rng=None, train=False):
        return F.depool(x, (self.ky, self.kx), self.mode), None

    def backward(self, x, y, err, saved, rng=None):
        return F.depool_backward(err, (self.ky, self.kx), self.mode)


@register_gd_for(Depooling)
class GDDepooling(TransformGD):
    """Backward: the window sum ("nearest") or the top-left gather
    ("zero")."""
