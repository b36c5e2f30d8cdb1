"""Pooling units (max / avg / max-abs) and their gradient.

Port of ``veles_tpu/ops/pooling.py`` (ref: veles/znicz/pooling.py::
MaxPooling/AvgPooling/MaxAbsPooling and gd_pooling.py::GDMaxPooling/
GDAvgPooling [H]).  Tail windows are ceil-padded (-inf for max, +inf for
the min half of max-abs, 0 for avg, which divides by the full window).
The max variants keep each window's argmax from the forward — the first
maximum in row-major window order, the element XLA's select-and-scatter
picks — and their backward scatters the gradient there.  Stochastic
pooling draws one position a window from jax's gumbel stream (the
threefry bits of ``prng``) and keeps it for its backward.
"""

from __future__ import annotations

from veles_tpu_torch.ops.nn_units import (TransformUnit, TransformGD,
                                          register_layer_type,
                                          register_gd_for)
from veles_tpu_torch.ops import functional as F


class PoolingBase(TransformUnit):
    """Config: kx, ky (window), sliding (stride, defaults to the window)."""

    def __init__(self, workflow, kx=2, ky=2, sliding=None, **kwargs):
        super().__init__(workflow, **kwargs)
        self.kx = int(kx)
        self.ky = int(ky)
        if sliding is None:
            sliding = (self.ky, self.kx)
        self.sliding = tuple(sliding if isinstance(sliding, (tuple, list))
                             else (sliding, sliding))

    @property
    def window(self):
        return (self.ky, self.kx)

    def output_shape(self, input_shape):
        b, h, w, c = input_shape
        return (b,) + F.pool_output_hw((h, w), self.window,
                                       self.sliding) + (c,)


@register_layer_type("max_pooling")
class MaxPooling(PoolingBase):
    def transform(self, x, rng=None, train=False):
        return F.max_pooling(x, self.window, self.sliding)

    def backward(self, x, y, err, saved, rng=None):
        return F.max_pooling_backward(x, err, saved, self.window,
                                      self.sliding)


@register_layer_type("maxabs_pooling")
class MaxAbsPooling(PoolingBase):
    def transform(self, x, rng=None, train=False):
        return F.maxabs_pooling(x, self.window, self.sliding)

    def backward(self, x, y, err, saved, rng=None):
        return F.maxabs_pooling_backward(x, err, saved, self.window,
                                         self.sliding)


@register_layer_type("avg_pooling")
class AvgPooling(PoolingBase):
    def transform(self, x, rng=None, train=False):
        return F.avg_pooling(x, self.window, self.sliding), None

    def backward(self, x, y, err, saved, rng=None):
        return F.avg_pooling_backward(x, err, self.window, self.sliding)


@register_layer_type("stochastic_pooling")
class StochasticPooling(PoolingBase):
    """Sample-by-magnitude pooling (ref: StochasticPooling [M]); eval mode
    uses the probability-weighted average.  The backward routes the
    gradient to the position the forward drew (kept in ``saved``)."""

    STOCHASTIC = True
    USE_ABS = False

    def transform(self, x, rng=None, train=False):
        return F.stochastic_pooling(x, self.window, self.sliding, rng,
                                    train, self.USE_ABS)

    def backward(self, x, y, err, saved, rng=None):
        return F.stochastic_pooling_backward(x, err, saved, self.window,
                                             self.sliding)


@register_layer_type("stochastic_abs_pooling")
class StochasticAbsPooling(StochasticPooling):
    """Probabilities from |x| (ref: StochasticAbsPooling [H])."""

    USE_ABS = True


@register_gd_for(PoolingBase)
class GDPooling(TransformGD):
    """One backward class for every pooling flavor (the forward unit's
    ``backward``).  The reference's names GDMaxPooling/GDAvgPooling are
    aliases."""


class GDMaxPooling(GDPooling):
    pass


class GDAvgPooling(GDPooling):
    pass
