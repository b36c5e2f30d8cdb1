"""Convolution forward units.

Port of ``veles_tpu/ops/conv.py`` (ref: veles/znicz/conv.py::Conv/
ConvTanh/ConvRELU/ConvStrictRELU [H]).  NHWC activations, HWIO weights
drawn from the ``init`` stream in the reference's order (so initial
weights are bit-equal and the reference's fused state carries over
unchanged); the convolution itself is cuDNN's, run on the NHWC tensor's
channels_last NCHW view.  The output shape comes from arithmetic.
"""

from __future__ import annotations

import numpy

from veles_tpu_torch.accel import AcceleratedUnit
from veles_tpu_torch.workflow import DeferredInitError
from veles_tpu_torch.ops.nn_units import ForwardBase, register_layer_type
from veles_tpu_torch.ops import functional as F


class ConvBase(ForwardBase):
    """Conv layer: config n_kernels, kx, ky, sliding (stride), padding.

    Its residuals for the GD (``saved``) are the ``z == 0`` mask of its
    pre-activation under ``strict_relu``: the reference's backward gives
    0.5 there, which the output alone cannot tell from z < 0."""

    def __init__(self, workflow, n_kernels=32, kx=5, ky=5, sliding=(1, 1),
                 padding="VALID", **kwargs):
        kwargs.setdefault("output_sample_shape", ())
        super().__init__(workflow, **kwargs)
        self.n_kernels = int(n_kernels)
        self.kx = int(kx)
        self.ky = int(ky)
        self.sliding = (sliding if isinstance(sliding, (tuple, list))
                        else (sliding, sliding))
        self.padding = padding

    def initialize(self, device=None, **kwargs):
        if not hasattr(self, "input") or self.input.is_empty:
            raise DeferredInitError(self.name)
        batch, in_h, in_w, in_c = self.input.shape
        if self.weights.is_empty:
            fan_in = self.ky * self.kx * in_c
            fan_out = self.n_kernels
            self.weights.reset(self._init_weights(
                (self.ky, self.kx, in_c, self.n_kernels), fan_in, fan_out))
            if self.include_bias:
                self.bias.reset(numpy.zeros(self.n_kernels, self.dtype))
        oh, ow = self.output_hw((in_h, in_w))
        self.output_sample_shape = (oh, ow, self.n_kernels)
        self.output.reset(numpy.zeros((batch, oh, ow, self.n_kernels),
                                      self.dtype))
        # skip ForwardBase.initialize's dense-specific weight init
        AcceleratedUnit.initialize(self, device=device, **kwargs)

    def output_hw(self, in_hw):
        """(oh, ow) for an input of ``in_hw``, from arithmetic."""
        return F.conv2d_output_hw(in_hw, (self.ky, self.kx), self.sliding,
                                  self.padding)

    def preact(self, x, weights, bias):
        """The pure op behind the layer (DeconvBase swaps in the
        transposed conv and inherits everything else)."""
        return F.conv2d_preact(x, weights, bias, self.sliding, self.padding)

    def _forward(self, x, weights, bias):
        """(y, the z == 0 mask or None)."""
        z = self.preact(x, weights, bias if self.include_bias else None)
        tie = (z == 0.0) if self.ACTIVATION == "strict_relu" else None
        return F.activate(z, self.ACTIVATION), tie

    def forward_fn(self, x, weights, bias):
        return self._forward(x, weights, bias)[0]

    def apply_fused(self, x, entry, rng=None, train=False):
        return self._forward(x, entry["w"], entry.get("b"))

    def run(self):
        y, self.saved = self._forward(
            self.input.devmem, self.weights.devmem,
            self.bias.devmem if self.include_bias else None)
        self.output.assign_device(y)


@register_layer_type("conv")
class Conv(ConvBase):
    ACTIVATION = "linear"


@register_layer_type("conv_tanh")
class ConvTanh(ConvBase):
    """Conv + LeCun-scaled tanh."""

    ACTIVATION = "tanh"


@register_layer_type("conv_relu")
class ConvRELU(ConvBase):
    """Conv + smooth relu log(1+exp(z)) (the reference's RELU)."""

    ACTIVATION = "relu"


@register_layer_type("conv_str")
class ConvStrictRELU(ConvBase):
    """Conv + max(0, z)."""

    ACTIVATION = "strict_relu"
