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
        if end <= begin:
            raise NotImplementedError(
                "%s: a loader with no train data needs a fitted normalizer "
                "from a snapshot, and the Snapshotter is not ported yet "
                "(ROADMAP Queue 2a, item 4)" % self.name)
        self.normalizer.analyze(data[begin:end])
        self.original_data.reset(self.normalizer.apply(data))

    def create_minibatch_data(self):
        mb = self.max_minibatch_size
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
