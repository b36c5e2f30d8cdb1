"""InteractiveLoader — push samples from code into a live graph.

Port of ``veles_tpu/loader/interactive.py`` (ref: veles/loader/
interactive.py [M]): a queue the host program ``feed()``s; each graph
cycle consumes one minibatch (class TEST), which uploads to the
loader's device.
"""

from __future__ import annotations

import collections

import numpy

from veles_tpu_torch.loader.base import TEST
from veles_tpu_torch.loader.stream import StreamLoaderBase


class InteractiveLoader(StreamLoaderBase):
    def __init__(self, workflow, sample_shape=(1,), **kwargs):
        super().__init__(workflow, sample_shape=sample_shape, **kwargs)
        self._queue = collections.deque()

    def feed(self, data, label=0):
        """Queue one sample (exact ``sample_shape``) or a batch
        (``(n,) + sample_shape``); anything else raises — a silent
        broadcast would fabricate garbage samples."""
        data = numpy.asarray(data, numpy.float32)
        if data.shape == self.sample_shape:
            self._queue.append((data, int(label)))
        elif data.shape[1:] == self.sample_shape:
            labels = (label if hasattr(label, "__len__")
                      else [label] * len(data))
            for sample, lab in zip(data, labels):
                self._queue.append((numpy.asarray(sample), int(lab)))
        else:
            raise ValueError(
                "feed: data shape %s is neither %s nor (n,) + %s"
                % (data.shape, self.sample_shape, self.sample_shape))
        return self

    def load_data(self):
        self.class_lengths = [self.max_minibatch_size, 0, 0]

    def next_sample(self):
        return self._queue.popleft() if self._queue else None

    def run(self):
        super().run()
        self.minibatch_class = TEST
