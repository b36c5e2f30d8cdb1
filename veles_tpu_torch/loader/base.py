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

Multi-process sharding (``veles_tpu/loader/base.py:99-170``): ``shard``
gives each process its own plan over a strided subset of every set (the
independent-shard model); ``shard_spmd`` keeps ONE global plan on every
process and yields the process's contiguous rows of each global
minibatch (``local_chunk``, ``local_minibatch_size``) with the global
live count as ``minibatch_size`` — what a data-parallel run consumes.
"""

from __future__ import annotations

import numpy
import torch

from veles_tpu_torch import prng
from veles_tpu_torch.memory import Vector
from veles_tpu_torch.units import Unit

TEST, VALID, TRAIN = 0, 1, 2
CLASS_NAME = ["test", "validation", "train"]


class Loader(Unit):
    """Abstract minibatch engine; subclasses provide the data."""

    snapshot_attrs = ("epoch_number", "_position", "_order", "_shard",
                      "_spmd_shard")

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
        self._shard = (0, 1)           # (process_index, process_count)
        self._spmd_shard = None        # SPMD slice-of-global-minibatch mode

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

    # -- sharding (multi-process) -------------------------------------------
    def shard(self, process_index, process_count):
        """Restrict this loader to a strided shard of every set: each
        process plans its OWN full-size minibatches over ``idx[pi::pc]``
        (the independent-shard model: per-process evaluation,
        screening); a lock-step data-parallel run uses
        :meth:`shard_spmd`."""
        self._shard = (int(process_index), int(process_count))
        self._order = None
        return self

    def shard_spmd(self, process_index, process_count):
        """Every process plans the SAME global minibatch sequence (the
        same seed gives the same shuffle) and this loader yields the
        process's contiguous rows of each global minibatch;
        ``minibatch_size`` stays the GLOBAL live count (the gradient
        normalizer).  Needs ``minibatch_size % process_count == 0``."""
        process_index, process_count = int(process_index), int(process_count)
        if self.max_minibatch_size % process_count:
            raise ValueError(
                "minibatch_size %d is not divisible by process_count %d"
                % (self.max_minibatch_size, process_count))
        self._spmd_shard = (process_index, process_count)
        self._order = None
        self._masks = {}
        return self

    def load_state_dict(self, d):
        """Snapshot restore, shard-aware.  Snapshots are written by
        process 0 only, so the captured ``_shard``/``_spmd_shard`` are
        process 0's; THIS process's identity (set by the launcher before
        the restore) wins.  An SPMD plan holds GLOBAL chunks, valid for
        every SPMD shard, so its plan and position survive (resume is
        bit-exact on every process); a strided plan is the shard's own
        and is rebuilt (epoch and PRNG streams still restored)."""
        runtime = (self._shard, self._spmd_shard)
        super().load_state_dict(d)
        restored = (tuple(self._shard),
                    None if self._spmd_shard is None
                    else tuple(self._spmd_shard))
        if restored != runtime:
            spmd_only = (restored[0] == runtime[0]
                         and restored[1] is not None
                         and runtime[1] is not None
                         and all(len(chunk) == self.max_minibatch_size
                                 for _, chunk, _ in self._order or ()))
            if not spmd_only:
                self._order = None
                self._position = 0
        self._shard, self._spmd_shard = runtime

    @property
    def local_minibatch_size(self):
        """Rows this process holds per minibatch (``max_minibatch_size``
        unless SPMD-sharded)."""
        if self._spmd_shard is None:
            return self.max_minibatch_size
        return self.max_minibatch_size // self._spmd_shard[1]

    def local_chunk(self, chunk):
        """This process's contiguous slice of a GLOBAL plan chunk (the
        identity when not SPMD-sharded)."""
        if self._spmd_shard is None:
            return chunk
        pi, pc = self._spmd_shard
        local = self.max_minibatch_size // pc
        return chunk[pi * local:(pi + 1) * local]

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
        the train indices shuffled from the host stream.  A strided shard
        plans over ``idx[pi::pc]``; an SPMD shard plans the GLOBAL index
        space and keeps the global chunks (sliced at consumption)."""
        stream = prng.get(self.prng_stream)
        pi, pc = self._shard
        plan = []
        for cls, (begin, end) in enumerate(self.class_offsets()):
            idx = numpy.arange(begin, end)
            if self._spmd_shard is None:
                idx = idx[pi::pc]
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
        """The (local_minibatch_size,) float32 0/1 mask of this
        process's rows of a minibatch of ``actual`` live rows, on the
        loader's device, uploaded once per live count."""
        mask = self._masks.get(actual)
        if mask is None:
            host = numpy.zeros(self.max_minibatch_size, numpy.float32)
            host[:actual] = 1.0
            host = self.local_chunk(host)
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
        indices = self.local_chunk(indices)
        self.minibatch_indices.reset(indices)
        self.fill_minibatch(indices, actual)
        self.last_minibatch = self._position >= len(self._order)
        self.epoch_ended = self.last_minibatch
        if self.last_minibatch:
            self.epoch_number += 1
