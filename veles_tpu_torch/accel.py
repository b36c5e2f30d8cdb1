"""AcceleratedUnit — base class for device-compute units.

Port of ``veles_tpu/accel.py``.  The reference jits each unit's pure
functions once at initialize time; PyTorch runs eagerly, so ``jit`` here
is a plain per-unit registry that returns the function it is given — the
unit code keeps its shape, and the hand-written kernels the functions
reach are built once per process by :mod:`veles_tpu_torch.ops._build`.
"""

from __future__ import annotations

import numpy

from veles_tpu_torch.units import Unit


class AcceleratedUnit(Unit):
    """A unit whose ``run`` dispatches device computations."""

    def __init__(self, workflow, dtype=None, **kwargs):
        super().__init__(workflow, **kwargs)
        self.dtype = numpy.dtype(dtype or "float32")
        self._jitted = {}

    def jit(self, name, fn):
        """Register ``fn`` once per unit under ``name`` and return the
        registered function (idempotent; nothing is compiled)."""
        return self._jitted.setdefault(name, fn)
