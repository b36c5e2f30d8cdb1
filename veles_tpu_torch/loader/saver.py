"""Minibatch stream capture and replay (offline preprocessing).

Port of ``veles_tpu/loader/saver.py`` (ref: veles/loader/saver.py::
MinibatchesSaver/MinibatchesLoader [M]): record the loader's minibatch
output stream to one file during a run, then replay it later without the
original dataset or its preprocessing.  The file format is the
reference's byte for byte — a pickle stream of one header dict (the
``MAGIC`` string, class lengths, minibatch size), then one record per
minibatch (class, size, data, labels, mask, indices) holding numpy
arrays, never tensors — so each package replays the other's captures.
The capture reads each minibatch back from the device; the replay
uploads each one to the loader's device.
"""

from __future__ import annotations

import pickle

import numpy
import torch

from veles_tpu_torch.loader.base import Loader
from veles_tpu_torch.units import Unit

MAGIC = "veles_tpu-minibatches-v1"


class MinibatchesSaver(Unit):
    """Graph unit: hangs off the loader and records every minibatch.

    Wire: ``saver.link_from(loader)`` +
    ``saver.link_attrs(loader, "minibatch_data", …)`` (done by
    ``attach_to``).  Capture covers exactly one epoch: the file closes
    when the loader ends its first epoch.
    """

    def __init__(self, workflow, path="minibatches.pickle", **kwargs):
        super().__init__(workflow, **kwargs)
        self.path = path
        self._file = None
        self._recorded = 0

    @classmethod
    def attach_to(cls, loader, path, **kwargs):
        saver = cls(loader.workflow, path=path, **kwargs)
        saver.link_from(loader)
        saver.link_attrs(
            loader, "minibatch_data", "minibatch_labels", "minibatch_mask",
            "minibatch_indices", "minibatch_class", "minibatch_size",
            "class_lengths", "max_minibatch_size", "epoch_ended")
        return saver

    def initialize(self, device=None, **kwargs):
        self._file = open(self.path, "wb")
        pickle.dump({"magic": MAGIC,
                     "class_lengths": list(self.class_lengths),
                     "minibatch_size": int(self.max_minibatch_size)},
                    self._file, protocol=pickle.HIGHEST_PROTOCOL)
        super().initialize(device=device, **kwargs)

    def run(self):
        if self._file is None:
            return
        record = {
            "class": int(self.minibatch_class),
            "size": int(self.minibatch_size),
            "data": self.minibatch_data.to_numpy(),
            "labels": (self.minibatch_labels.to_numpy()
                       if not self.minibatch_labels.is_empty else None),
            "mask": self.minibatch_mask.to_numpy(),
            "indices": self.minibatch_indices.to_numpy(),
        }
        pickle.dump(record, self._file, protocol=pickle.HIGHEST_PROTOCOL)
        self._recorded += 1
        if bool(self.epoch_ended):
            self.close()

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None
            self.info("captured %d minibatches → %s", self._recorded,
                      self.path)

    def stop(self):
        self.close()


class MinibatchesLoader(Loader):
    """Replays a captured minibatch stream as a drop-in Loader.

    The epoch plan is the recorded sequence verbatim (no reshuffle — the
    capture IS the preprocessing artifact).
    """

    def __init__(self, workflow, path="minibatches.pickle", **kwargs):
        super().__init__(workflow, **kwargs)
        self.path = path
        #: per-record (file_offset, class, indices, size) — data stays on
        #: disk; one record is unpickled per step
        self._index = []
        self._file = None

    def load_data(self):
        self._index = []
        if self._file is not None:  # re-initialize: don't leak the handle
            self._file.close()
        self._file = open(self.path, "rb")
        header = pickle.load(self._file)
        if header.get("magic") != MAGIC:
            raise ValueError("%s is not a minibatch capture" % self.path)
        self.class_lengths = list(header["class_lengths"])
        self.max_minibatch_size = int(header["minibatch_size"])
        while True:
            offset = self._file.tell()
            try:
                record = pickle.load(self._file)
            except EOFError:
                break
            self._index.append(
                (offset, record["class"],
                 numpy.asarray(record["indices"], numpy.int32),
                 record["size"]))
        if not self._index:
            raise ValueError("%s holds no minibatches" % self.path)

    def _read_record(self, i):
        if self._file is None:  # reopened lazily after stop() closed it
            self._file = open(self.path, "rb")
        self._file.seek(self._index[i][0])
        return pickle.load(self._file)

    def create_minibatch_data(self):
        first = self._read_record(0)
        self.minibatch_data.reset(numpy.zeros_like(first["data"]))
        if first["labels"] is not None:
            self.minibatch_labels.reset(numpy.zeros_like(first["labels"]))

    def _plan_epoch(self):
        # the recorded order IS the plan; minibatch i replays record i
        self._order = [(cls, idx, size)
                       for _, cls, idx, size in self._index]

    def fill_minibatch(self, indices, actual_size):
        # Loader.run increments _position BEFORE fill_minibatch, so the
        # current plan entry — and therefore the current record — is
        # _position - 1
        record = self._read_record(self._position - 1)
        self._upload(self.minibatch_data, record["data"])
        if record["labels"] is not None:
            self._upload(self.minibatch_labels, record["labels"])
        self._upload(self.minibatch_mask, record["mask"])

    def _upload(self, vector, array):
        """Adopt ``array`` as ``vector``'s device tensor on the loader's
        device (no host copy is kept, so a capture of the replay reads
        the device back, as a capture of the original run does)."""
        vector.assign_device(torch.as_tensor(array).to(self._device))

    def stop(self):
        if self._file is not None:
            self._file.close()
            self._file = None
