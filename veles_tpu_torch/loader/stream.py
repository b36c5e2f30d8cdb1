"""Streaming-loader base: fill minibatches from an incremental sample
source (a queue, a socket) instead of an indexed dataset.

Port of ``veles_tpu/loader/stream.py``: zero-filled static buffers, a
per-row drain from ``next_sample()``, the validity mask and the live
``minibatch_size``.  Each minibatch is assembled on the host and
uploads to the loader's device on first use (the Vectors' ``devmem``).
"""

from __future__ import annotations

import numpy

from veles_tpu_torch.loader.base import Loader


class StreamLoaderBase(Loader):
    """Subclasses implement ``next_sample() -> (data, label) | None``
    (None = source exhausted / nothing available right now)."""

    def __init__(self, workflow, sample_shape=(1,), **kwargs):
        super().__init__(workflow, **kwargs)
        self.sample_shape = tuple(sample_shape)

    def next_sample(self):
        raise NotImplementedError

    def create_minibatch_data(self):
        mb = self.max_minibatch_size
        self.minibatch_data.reset(
            numpy.zeros((mb,) + self.sample_shape, numpy.float32))
        self.minibatch_labels.reset(numpy.zeros(mb, numpy.int32))

    def fill_minibatch(self, indices, actual_size):
        mb = self.max_minibatch_size
        data = numpy.zeros((mb,) + self.sample_shape, numpy.float32)
        labels = numpy.zeros(mb, numpy.int32)
        mask = numpy.zeros(mb, numpy.float32)
        count = 0
        while count < mb:
            sample = self.next_sample()
            if sample is None:
                break
            data[count], labels[count] = sample
            mask[count] = 1.0
            count += 1
        self.minibatch_data.reset(data)
        self.minibatch_labels.reset(labels)
        self.minibatch_mask.reset(mask)
        self.minibatch_size = count
