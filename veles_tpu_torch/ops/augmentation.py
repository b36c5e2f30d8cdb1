"""Augmentation units — input randomization inside the step.

Port of ``veles_tpu/ops/augmentation.py``: a stochastic weightless layer
(``functional.random_crop_flip``) whose per-sample offsets and mirrors
are jax's draws from the step key, made on the host and uploaded once;
eval minibatches are center-cropped.
"""

from __future__ import annotations

from veles_tpu_torch.ops.nn_units import (TransformUnit, TransformGD,
                                          register_layer_type,
                                          register_gd_for)
from veles_tpu_torch.ops import functional as F


@register_layer_type("random_crop_flip")
class RandomCropFlip(TransformUnit):
    """Config: crop (H, W) output size; flip enables horizontal mirroring."""

    STOCHASTIC = True

    def __init__(self, workflow, crop=(24, 24), flip=True, **kwargs):
        super().__init__(workflow, **kwargs)
        self.crop = tuple(crop)
        self.flip = bool(flip)

    def output_shape(self, input_shape):
        b, _, _, c = input_shape
        return (b,) + self.crop + (c,)

    def transform(self, x, rng=None, train=False):
        return F.random_crop_flip(x, rng, self.crop, self.flip, train), None

    def backward(self, x, y, err, saved, rng=None):
        return F.random_crop_flip_backward(x, err, rng, self.crop,
                                           self.flip)


@register_gd_for(RandomCropFlip)
class GDRandomCropFlip(TransformGD):
    """The crop's vjp: a scatter back into the source window."""
