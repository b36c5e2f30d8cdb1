"""MeanDispNormalizer — on-device input standardization unit.

Port of ``veles_tpu/ops/mean_disp_normalizer.py`` (ref: veles/znicz/
mean_disp_normalizer.py::MeanDispNormalizer [M]): y = (x - mean) * rdisp
with a precomputed mean sample and reciprocal-dispersion array.  A
weightless TransformUnit; its backward is err * rdisp, the reference's
``jax.vjp``.
"""

from __future__ import annotations

import numpy

from veles_tpu_torch.memory import Vector
from veles_tpu_torch.workflow import DeferredInitError
from veles_tpu_torch.ops.nn_units import (TransformUnit, TransformGD,
                                          register_layer_type,
                                          register_gd_for)


@register_layer_type("mean_disp_normalizer")
class MeanDispNormalizer(TransformUnit):
    """``mean`` and ``rdisp`` are sample-shaped Vectors (set directly or
    link_attrs'd from a pipeline unit); ``initialize`` defers until both
    are set, and every call reads their current values."""

    def __init__(self, workflow, mean=None, rdisp=None, **kwargs):
        super().__init__(workflow, **kwargs)
        self.mean = Vector(numpy.asarray(mean, numpy.float32)
                           if mean is not None else None)
        self.rdisp = Vector(numpy.asarray(rdisp, numpy.float32)
                            if rdisp is not None else None)

    def initialize(self, device=None, **kwargs):
        if self.mean.is_empty or self.rdisp.is_empty:
            raise DeferredInitError(self.name)
        super().initialize(device=device, **kwargs)

    def transform(self, x, rng=None, train=False):
        return (x - self.mean.devmem) * self.rdisp.devmem, None

    def backward(self, x, y, err, saved, rng=None):
        return err * self.rdisp.devmem


@register_gd_for(MeanDispNormalizer)
class GDMeanDispNormalizer(TransformGD):
    pass
