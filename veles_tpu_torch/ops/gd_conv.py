"""Gradient units for convolution.

Port of ``veles_tpu/ops/gd_conv.py`` (ref: veles/znicz/gd_conv.py::
GradientDescentConv/GDTanhConv/GDRELUConv [H]).  The reference takes
``jax.vjp`` of the forward; here the backward is explicit
(:func:`veles_tpu_torch.ops.functional.conv2d_backward`): err times the
activation's derivative, then ATen's convolution backward for the input
and weight gradients — the forward conv is never re-run, and the input
gradient is skipped when ``need_err_input`` is False.
"""

from __future__ import annotations

from veles_tpu_torch.ops.nn_units import GradientDescentBase, register_gd_for
from veles_tpu_torch.ops import conv
from veles_tpu_torch.ops import functional as F


class GradientDescentConvBase(GradientDescentBase):
    def backward_fn(self, x, y, err_output, weights, bias=None, saved=None):
        fwd = self.forward
        return F.conv2d_backward(x, y, err_output, weights, fwd.sliding,
                                 fwd.padding, fwd.ACTIVATION, saved,
                                 fwd.include_bias, self.need_err_input)


@register_gd_for(conv.Conv)
class GradientDescentConv(GradientDescentConvBase):
    pass


@register_gd_for(conv.ConvTanh)
class GDTanhConv(GradientDescentConvBase):
    pass


@register_gd_for(conv.ConvRELU)
class GDRELUConv(GradientDescentConvBase):
    pass


@register_gd_for(conv.ConvStrictRELU)
class GDStrictRELUConv(GradientDescentConvBase):
    pass
