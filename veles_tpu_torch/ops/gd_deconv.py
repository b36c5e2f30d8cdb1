"""Gradient units for transposed convolution.

Port of ``veles_tpu/ops/gd_deconv.py`` (ref: veles/znicz/gd_deconv.py::
GDDeconv [H]).  The reference takes ``jax.vjp`` of the deconv forward;
here the backward is explicit (:func:`functional.deconv2d_backward`: a
plain strided conv for err_input — the transpose of a transpose — and
the weight gradient), skipping the input's error when
``need_err_input`` is False.
"""

from __future__ import annotations

from veles_tpu_torch.ops.gd_conv import GradientDescentConvBase
from veles_tpu_torch.ops.nn_units import register_gd_for
from veles_tpu_torch.ops import deconv
from veles_tpu_torch.ops import functional as F


@register_gd_for(deconv.DeconvBase)
class GDDeconv(GradientDescentConvBase):
    def backward_fn(self, x, y, err_output, weights, bias=None, saved=None):
        fwd = self.forward
        return F.deconv2d_backward(x, y, err_output, weights, fwd.sliding,
                                   fwd.padding, fwd.ACTIVATION,
                                   fwd.output_padding, fwd.include_bias,
                                   self.need_err_input)
