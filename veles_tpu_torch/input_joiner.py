"""InputJoiner — concatenate several units' outputs into one vector.

Port of ``veles_tpu/input_joiner.py`` (ref: veles/input_joiner.py::
InputJoiner [M]): joins the ``output`` of N producer units along the
feature axis (samples stay axis 0), on the device (one ``torch.cat``),
so heterogeneous feature sources can feed one downstream layer.
"""

from __future__ import annotations

import numpy
import torch

from veles_tpu_torch.accel import AcceleratedUnit
from veles_tpu_torch.memory import Vector
from veles_tpu_torch.workflow import DeferredInitError


class InputJoiner(AcceleratedUnit):
    """output = concat([inp.output flattened per-sample for inp in inputs])."""

    has_params = False

    def __init__(self, workflow, inputs=(), **kwargs):
        super().__init__(workflow, **kwargs)
        self.inputs = list(inputs)
        self.output = Vector()
        for producer in self.inputs:
            self.link_from(producer)

    def link_inputs(self, *producers):
        for producer in producers:
            self.inputs.append(producer)
            self.link_from(producer)
        return self

    def initialize(self, device=None, **kwargs):
        if not self.inputs:
            raise ValueError("%s: no inputs linked" % self.name)
        if any(p.output.is_empty for p in self.inputs):
            raise DeferredInitError(self.name)
        batch = self.inputs[0].output.shape[0]
        width = 0
        for producer in self.inputs:
            shape = producer.output.shape
            if shape[0] != batch:
                raise ValueError(
                    "%s: batch mismatch (%d vs %d from %s)" %
                    (self.name, batch, shape[0], producer.name))
            width += int(numpy.prod(shape[1:], dtype=numpy.int64))
        self.output.reset(numpy.zeros((batch, width), self.dtype))
        self.output_sample_shape = (width,)
        super().initialize(device=device, **kwargs)

    @staticmethod
    def join_fn(*arrays):
        return torch.cat([a.reshape(a.shape[0], -1) for a in arrays], dim=1)

    def run(self):
        self.output.assign_device(
            self.join_fn(*[p.output.devmem for p in self.inputs]))
