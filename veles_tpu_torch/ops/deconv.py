"""Transposed-convolution (deconv) forward units.

Port of ``veles_tpu/ops/deconv.py`` (ref: veles/znicz/deconv.py::Deconv
[H]) — the autoencoder samples' mirror of a conv encoder.  NHWC layout,
HWIO weights (I the input's channels) drawn from the ``init`` stream as
the reference's are; the op is :func:`functional.deconv2d_preact`
(cuDNN's transposed conv with the flipped kernel, cropped or padded to
the reference's pads).  ``deconv(k, s, p)`` inverts the spatial shape of
``conv(k, s, p)``; the output shape comes from arithmetic.
"""

from __future__ import annotations

from veles_tpu_torch.ops.conv import ConvBase
from veles_tpu_torch.ops.nn_units import register_layer_type
from veles_tpu_torch.ops import functional as F


class DeconvBase(ConvBase):
    """Config: n_kernels (output channels), kx, ky, sliding (upsample
    factor), padding, output_padding (mirror disambiguation — see
    :func:`functional.deconv2d_forward`).  Everything but the pure op is
    ConvBase."""

    def __init__(self, workflow, n_kernels=1, kx=5, ky=5, sliding=(1, 1),
                 padding="SAME", output_padding=0, **kwargs):
        super().__init__(workflow, n_kernels=n_kernels, kx=kx, ky=ky,
                         sliding=sliding, padding=padding, **kwargs)
        self.output_padding = output_padding

    def output_hw(self, in_hw):
        return F.deconv2d_output_hw(in_hw, (self.ky, self.kx), self.sliding,
                                    self.padding, self.output_padding)

    def preact(self, x, weights, bias):
        return F.deconv2d_preact(x, weights, bias, self.sliding,
                                 self.padding, self.output_padding)


@register_layer_type("deconv")
class Deconv(DeconvBase):
    ACTIVATION = "linear"


@register_layer_type("deconv_tanh")
class DeconvTanh(DeconvBase):
    ACTIVATION = "tanh"


@register_layer_type("deconv_relu")
class DeconvRELU(DeconvBase):
    ACTIVATION = "relu"
