"""FullBatchLoader — the entire dataset resident on the device.

Port of ``veles_tpu/loader/fullbatch.py`` (ref: veles/loader/fullbatch.py::
FullBatchLoader [H]): the whole dataset is ONE tensor per array on the
loader's device, and ``fill_minibatch`` is a device-side
``index_select`` by the minibatch's indices — the only host→device
traffic per step is that index vector.  The plan's indices are always in
range (padding repeats a live index), so the reference's ``jnp.take``
FILL mode never shows (ROADMAP Queue 3, item 3).
"""

from __future__ import annotations

import numpy
import torch

from veles_tpu_torch.loader.base import Loader
from veles_tpu_torch.memory import Vector
from veles_tpu_torch.normalization import NoneNormalizer, from_spec


class FullBatchLoader(Loader):
    """Loader over in-memory arrays; subclasses fill original_data/labels.

    ``normalization_type`` plugs a :mod:`veles_tpu_torch.normalization`
    strategy in: statistics are fitted on the TRAIN slice only and applied
    to every set, on the host, once.
    """

    snapshot_attrs = Loader.snapshot_attrs + ("normalizer",)

    def __init__(self, workflow, normalization_type="none",
                 normalization_parameters=None, **kwargs):
        super().__init__(workflow, **kwargs)
        #: full dataset, laid out [test | validation | train] along axis 0
        self.original_data = Vector()
        self.original_labels = Vector()
        self.has_labels = True
        self.normalizer = from_spec(normalization_type,
                                    **(normalization_parameters or {}))

    def load_data(self):
        raise NotImplementedError

    def normalize_data(self):
        if isinstance(self.normalizer, NoneNormalizer):
            return
        data = self.original_data.mem
        begin, end = self.class_offsets()[2]   # TRAIN slice
        if end > begin:
            self.normalizer.analyze(data[begin:end])
        elif not self.normalizer.is_fitted:
            # no train data (a serving or evaluation loader): the
            # statistics must come from training time — a snapshot
            # restored after initialize delivers the fitted normalizer
            # (load_state_dict applies it), and run() refuses without
            self._normalize_deferred = True
            return
        self.original_data.reset(self.normalizer.apply(data))

    def load_state_dict(self, d):
        super().load_state_dict(d)
        if getattr(self, "_normalize_deferred", False) and \
                self.normalizer.is_fitted:
            self.original_data.reset(
                self.normalizer.apply(self.original_data.mem))
            self._normalize_deferred = False

    def run(self):
        if getattr(self, "_normalize_deferred", False):
            raise ValueError(
                "%s: normalizer is unfitted and there is no train data to "
                "fit it on; restore a snapshot holding the fitted "
                "normalizer or pass a pre-fitted one" % self.name)
        super().run()

    def create_minibatch_data(self):
        mb = self.local_minibatch_size
        sample_shape = self.original_data.shape[1:]
        self.minibatch_data.reset(
            numpy.zeros((mb,) + sample_shape, self.original_data.dtype))
        if self.has_labels:
            self.minibatch_labels.reset(numpy.zeros(mb, numpy.int32))

    def fill_minibatch(self, indices, actual_size):
        idx = self.minibatch_indices.devmem
        self.minibatch_data.assign_device(
            torch.index_select(self.original_data.devmem, 0, idx))
        if self.has_labels:
            self.minibatch_labels.assign_device(
                torch.index_select(self.original_labels.devmem, 0, idx))

    def gather_window(self, indices):
        """The streaming epoch scan's staging hook: the rows of the
        (normalized) host dataset at ``indices`` as float32, and their
        labels.  A full-batch loader never needs windows — its data is
        on the device already — but having the hook keeps
        ``--stream-window`` runnable on every sample and gives the
        streaming path a like-for-like check against the chunked one."""
        data = numpy.asarray(self.original_data.mem)[indices].astype(
            numpy.float32)
        labels = (numpy.ascontiguousarray(
            numpy.asarray(self.original_labels.mem)[indices], numpy.int32)
            if self.has_labels else None)
        return data, labels
