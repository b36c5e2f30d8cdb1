"""ZeroFiller — sparse-connectivity weight masking.

Port of ``veles_tpu/ops/weights_zerofilling.py`` (ref: veles/znicz/
weights_zerofilling.py::ZeroFiller [M]): keeps a 0/1 mask over a forward
unit's weights and re-zeroes the masked entries after every update
(grouped/blocked connectivity).  The mask multiplies into the update
(the GD's ``weights_mask``); this unit owns the mask's lifecycle.
"""

from __future__ import annotations

import numpy
import torch

from veles_tpu_torch.units import Unit
from veles_tpu_torch.workflow import DeferredInitError


class ZeroFiller(Unit):
    """Attach to a (forward, gd) pair: ``mask`` is a 0/1 array of the
    forward's weight shape (or a callable shape -> mask)."""

    snapshot_attrs = ("mask",)

    def __init__(self, workflow, forward=None, gd=None, mask=None, **kwargs):
        super().__init__(workflow, **kwargs)
        self.forward = forward
        self.gd = gd
        self.mask = mask

    def initialize(self, device=None, **kwargs):
        if self.forward is None or self.forward.weights.is_empty:
            raise DeferredInitError(self.name)
        shape = self.forward.weights.shape
        if callable(self.mask):
            self.mask = self.mask(shape)
        if self.mask is None:
            raise ValueError("%s: a mask (array or shape->array callable) "
                             "is required" % self.name)
        self.mask = numpy.asarray(self.mask, self.forward.weights.dtype)
        if self.mask.shape != shape:
            raise ValueError("%s: mask shape %s != weights shape %s"
                             % (self.name, self.mask.shape, shape))
        # initial enforcement + the update's mask
        self.forward.weights.reset(
            numpy.asarray(self.forward.weights.to_numpy()) * self.mask)
        if self.gd is not None:
            self.gd.weights_mask = self.mask
        super().initialize(device=device, **kwargs)

    def run(self):
        # unit-mode safety net: with no gd wired (inference graphs), keep
        # the weights masked
        if self.gd is None:
            w = self.forward.weights.devmem
            self.forward.weights.assign_device(
                w * torch.as_tensor(self.mask, device=w.device))
