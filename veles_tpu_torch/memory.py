"""Vector — the host/device tensor pair.

Port of ``veles_tpu/memory.py``: the canonical storage is a
``torch.Tensor`` on the device of the unit that owns the Vector, with the
reference's map/unmap coherence state machine — a host read pulls the
device copy once, a host write marks the numpy side canonical, and
``unmap``/``devmem`` pushes it back.  The device is the Vector's own
``device`` attribute, set by its owning unit's ``initialize`` (see
:meth:`veles_tpu_torch.units.Unit.initialize`) or by the caller; there
is no process-wide default, and uploading a Vector that has none raises.
"""

from __future__ import annotations

import numpy
import torch

_HOST, _DEVICE, _BOTH = "host", "device", "both"


def numpy_dtype(dtype):
    """The numpy dtype of a torch dtype (numpy dtypes pass through)."""
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return numpy.dtype(dtype)


class Vector:
    """A named tensor on a device with lazy host mirroring."""

    def __init__(self, data=None, shape=None, dtype=numpy.float32,
                 device=None):
        self._host = None
        self._dev = None
        self._state = _HOST
        #: where ``devmem`` uploads host writes; None until the owning
        #: unit initializes (or the caller sets it)
        self.device = None if device is None else torch.device(device)
        if data is not None:
            self.reset(data)
        elif shape is not None:
            self.reset(numpy.zeros(shape, dtype=dtype))

    # ------------------------------------------------------------------ state
    def reset(self, data=None):
        """Replace contents with a host array or a device tensor (or
        clear).  A tensor is adopted as the canonical device copy."""
        if data is None:
            self._host = None
            self._dev = None
            self._state = _HOST
            return self
        if isinstance(data, Vector):
            data = data.to_numpy()
        if isinstance(data, torch.Tensor):
            return self.assign_device(data)
        self._host = numpy.ascontiguousarray(data)
        self._dev = None
        self._state = _HOST
        return self

    @property
    def is_empty(self):
        return self._host is None and self._dev is None

    def __bool__(self):
        return not self.is_empty

    # ------------------------------------------------------- host-side access
    @property
    def mem(self):
        """Host view for reading (implicit ``map_read``)."""
        return self.map_read()

    @mem.setter
    def mem(self, value):
        self.reset(value)

    def map_read(self):
        if self._state == _DEVICE:
            self._host = self._dev.detach().cpu().numpy()
            self._state = _BOTH
        return self._host

    def map_write(self):
        """Host view for writing; device copy becomes stale."""
        self.map_read()
        self._state = _HOST
        return self._host

    def unmap(self):
        """Push host writes to the device (no-op if already coherent)."""
        if self._state == _HOST and self._host is not None:
            if self.device is None:
                raise RuntimeError(
                    "Vector %s has no device: initialize its unit (or set "
                    "Vector.device) before reading devmem" % (self.shape,))
            self._dev = torch.as_tensor(self._host).to(self.device)
            self._state = _BOTH
        return self

    # ----------------------------------------------------- device-side access
    @property
    def devmem(self):
        """The canonical ``torch.Tensor`` (uploads host writes first)."""
        self.unmap()
        return self._dev

    def assign_device(self, arr):
        """Adopt a device tensor as the new canonical value (host goes
        stale).  This is how compiled steps hand results back without a
        transfer; the Vector's device follows the tensor."""
        self._dev = arr
        self.device = arr.device
        self._state = _DEVICE
        return self

    # ------------------------------------------------------------------ info
    @property
    def shape(self):
        if self._state == _DEVICE:
            return tuple(self._dev.shape)
        return tuple(self._host.shape) if self._host is not None else ()

    @property
    def dtype(self):
        """The numpy dtype of the contents (None when empty)."""
        if self._state == _DEVICE:
            return numpy_dtype(self._dev.dtype)
        return self._host.dtype if self._host is not None else None

    @property
    def size(self):
        shape = self.shape
        n = 1
        for dim in shape:
            n *= dim
        return n if shape else 0

    def __len__(self):
        shape = self.shape
        return shape[0] if shape else 0

    def to_numpy(self):
        mem = self.map_read()
        return None if mem is None else numpy.array(mem)

    def __getitem__(self, idx):
        return self.mem[idx]

    def __setitem__(self, idx, value):
        self.map_write()[idx] = value

    def __repr__(self):
        if self.is_empty:
            return "<Vector empty>"
        return "<Vector %s %s [%s] on %s>" % (self.shape, self.dtype,
                                             self._state, self.device)
