"""Cutter — crops a spatial region out of NHWC activations.

Port of ``veles_tpu/ops/cutter.py`` (ref: veles/znicz/cutter.py::Cutter
[H]).  The backward pads the error back with zeros.
"""

from __future__ import annotations

import torch

from veles_tpu_torch.ops.nn_units import (TransformUnit, TransformGD,
                                          register_layer_type,
                                          register_gd_for)


@register_layer_type("cutter")
class Cutter(TransformUnit):
    def __init__(self, workflow, padding=(0, 0, 0, 0), **kwargs):
        """padding: (left, top, right, bottom) amounts to cut away."""
        super().__init__(workflow, **kwargs)
        self.padding = tuple(padding)

    def output_shape(self, input_shape):
        left, top, right, bottom = self.padding
        b, h, w, c = input_shape
        return (b, h - top - bottom, w - left - right, c)

    def transform(self, x, rng=None, train=False):
        left, top, right, bottom = self.padding
        h, w = x.shape[1], x.shape[2]
        return x[:, top:h - bottom, left:w - right, :], None

    def backward(self, x, y, err, saved, rng=None):
        left, top, right, bottom = self.padding
        h, w = x.shape[1], x.shape[2]
        grad = torch.zeros_like(x)
        grad[:, top:h - bottom, left:w - right, :] = err
        return grad


@register_gd_for(Cutter)
class GDCutter(TransformGD):
    pass
