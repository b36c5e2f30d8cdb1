"""Loader — the three-set minibatch engine.

Port of ``veles_tpu/loader/base.py`` (ref: veles/loader/base.py::Loader
[H]): three sample sets (TEST=0, VALID=1, TRAIN=2), per-epoch iteration
test→validation→train, train-index shuffling from the named "loader"
host PRNG stream (bit-equal to the reference's, so both packages see the
same minibatch sequence), epoch accounting, and short-final-minibatch
handling: every minibatch is padded to ``max_minibatch_size`` with a 0/1
``minibatch_mask`` marking live rows.

The mask lives on the loader's device and is built once per distinct
live count, so the only host→device traffic of a FullBatchLoader
minibatch is its index vector (a RecordsLoader uploads its gathered
minibatch too).  The epoch scan reads a set's plan as matrices
(``plan_arrays``) and a streaming loader's samples a window at a time
(``gather_window``: the record, LMDB and full-batch loaders have it).
``local_minibatch_size`` and ``local_chunk`` are the reference's
unsharded forms (the identity); multi-process sharding (``shard``,
``shard_spmd``) is not ported yet and raises (ROADMAP Queue 2a, item 8).
"""

from __future__ import annotations

import numpy
import torch

from veles_tpu_torch import prng
from veles_tpu_torch.memory import Vector
from veles_tpu_torch.units import Unit

TEST, VALID, TRAIN = 0, 1, 2
CLASS_NAME = ["test", "validation", "train"]


def _not_ported(what, item):
    raise NotImplementedError("%s is not ported yet: ROADMAP Queue 2a, "
                              "item %d" % (what, item))


class Loader(Unit):
    """Abstract minibatch engine; subclasses provide the data."""

    snapshot_attrs = ("epoch_number", "_position", "_order")

    def __init__(self, workflow, minibatch_size=100, shuffle=True,
                 prng_stream="loader", **kwargs):
        super().__init__(workflow, **kwargs)
        self.max_minibatch_size = int(minibatch_size)
        self.shuffle = shuffle
        self.prng_stream = prng_stream
        #: [test, validation, train] sample counts — set by load_data()
        self.class_lengths = [0, 0, 0]
        self.minibatch_data = Vector()
        self.minibatch_labels = Vector()
        self.minibatch_indices = Vector()
        self.minibatch_mask = Vector()
        self.minibatch_size = 0        # live rows in the current minibatch
        self.minibatch_class = TRAIN
        self.last_minibatch = False    # True on the final minibatch of epoch
        self.epoch_ended = False
        self.epoch_number = 0
        self._position = 0             # minibatch cursor within the epoch
        self._order = None             # epoch plan: list of minibatch tuples
        self._masks = {}               # live count -> device 0/1 mask
        self._device = None

    # -- to be provided by subclasses ---------------------------------------
    def load_data(self):
        """Populate class_lengths (and whatever backing store is needed)."""
        raise NotImplementedError

    def create_minibatch_data(self):
        """Allocate minibatch_data/labels Vectors at max_minibatch_size."""
        raise NotImplementedError

    def fill_minibatch(self, indices, actual_size):
        """Fill minibatch Vectors for the given global sample indices."""
        raise NotImplementedError

    # -- window gather (streaming epoch-scan) --------------------------------
    def gather_window(self, indices):
        """``(data float32 (len(indices), ...), labels int32 or None)``
        for a FLAT vector of global sample indices, on the host — the
        streaming epoch scan's staging hook, with the same conversion
        ``fill_minibatch`` applies.  Loaders with a random-access backing
        store override it; this one has none."""
        raise NotImplementedError(
            "%s cannot gather sample windows — the streaming epoch-scan "
            "needs a loader with a random-access backing store "
            "(RecordsLoader, LMDBLoader, any FullBatchLoader)"
            % type(self).__name__)

    @property
    def can_gather_windows(self):
        """True when this loader implements :meth:`gather_window`."""
        return type(self).gather_window is not Loader.gather_window

    def plan_arrays(self, wanted_cls=None, order=None):
        """(idx, mask) matrices of one set from a minibatch plan — the
        epoch scan's input: the loader's CURRENT plan, or ``order``.
        Returns (None, None) when the set is empty."""
        if wanted_cls is None:
            wanted_cls = TRAIN
        if order is None:
            order = self._order
        idx, mask = [], []
        for cls, chunk, actual in order:
            if cls != wanted_cls:
                continue
            idx.append(chunk)
            m = numpy.zeros(len(chunk), numpy.float32)
            m[:actual] = 1.0
            mask.append(m)
        if not idx:
            return None, None
        return numpy.stack(idx), numpy.stack(mask)

    # -- not ported yet ------------------------------------------------------
    def shard(self, process_index, process_count):
        _not_ported("loader sharding (shard)", 8)

    def shard_spmd(self, process_index, process_count):
        _not_ported("loader sharding (shard_spmd)", 8)

    @property
    def local_minibatch_size(self):
        """Rows this process holds per minibatch: ``max_minibatch_size``
        (the reference's value when not SPMD-sharded; sharding is not
        ported)."""
        return self.max_minibatch_size

    def local_chunk(self, chunk):
        """This process's slice of a plan chunk: the chunk itself (the
        reference's identity when not SPMD-sharded)."""
        return chunk

    @property
    def total_samples(self):
        return sum(self.class_lengths)

    def class_offsets(self):
        """Global index ranges per class: data layout is [test|valid|train]."""
        off, out = 0, []
        for n in self.class_lengths:
            out.append((off, off + n))
            off += n
        return out

    # -- engine --------------------------------------------------------------
    def normalize_data(self):
        """Hook between load_data and minibatch allocation (see
        FullBatchLoader: fits the configured normalizer on the train set)."""

    def initialize(self, device=None, **kwargs):
        self.load_data()
        if self.total_samples == 0:
            raise ValueError("%s: load_data produced no samples" % self.name)
        self.normalize_data()
        self.create_minibatch_data()
        self._plan_epoch()
        self._position = 0
        self._device = device
        self._masks = {}
        super().initialize(device=device, **kwargs)

    def _plan_epoch(self):
        """Build this epoch's minibatch plan: test → validation → train,
        the train indices shuffled from the host stream."""
        stream = prng.get(self.prng_stream)
        plan = []
        for cls, (begin, end) in enumerate(self.class_offsets()):
            idx = numpy.arange(begin, end)
            if len(idx) == 0:
                continue
            if cls == TRAIN and self.shuffle:
                stream.shuffle(idx)
            mb = self.max_minibatch_size
            for at in range(0, len(idx), mb):
                chunk = idx[at:at + mb]
                actual = len(chunk)
                if actual < mb:  # pad with the first index, masked dead
                    chunk = numpy.concatenate(
                        [chunk, numpy.full(mb - actual, chunk[0])])
                plan.append((cls, chunk.astype(numpy.int32), actual))
        self._order = plan

    def _mask(self, actual):
        """The (max_minibatch_size,) float32 0/1 mask of ``actual`` live
        rows, on the loader's device, uploaded once per live count."""
        mask = self._masks.get(actual)
        if mask is None:
            host = numpy.zeros(self.max_minibatch_size, numpy.float32)
            host[:actual] = 1.0
            mask = torch.as_tensor(host).to(self._device)
            self._masks[actual] = mask
        return mask

    def run(self):
        if self._order is None or self._position >= len(self._order):
            self._plan_epoch()
            self._position = 0
        cls, indices, actual = self._order[self._position]
        self._position += 1
        self.minibatch_class = cls
        self.minibatch_size = actual
        self.minibatch_mask.assign_device(self._mask(actual))
        self.minibatch_indices.reset(indices)
        self.fill_minibatch(indices, actual)
        self.last_minibatch = self._position >= len(self._order)
        self.epoch_ended = self.last_minibatch
        if self.last_minibatch:
            self.epoch_number += 1
