"""Record-file dataset: fixed-shape binary records with memory-mapped reads.

Port of ``veles_tpu/loader/records.py`` (ref: veles/znicz/loader/
loader_lmdb.py [M], SURVEY §2.2): a flat binary format that memory-maps
— a JSON header (shapes, dtype, split sizes) + a contiguous sample
tensor + a label vector, laid out [test | validation | train] as the
Loader expects.  A file the port writes is byte-identical to the
reference's, and each package reads the other's.

Per step the minibatch is gathered host-side from the mapped file by the
port's native gather (:mod:`veles_tpu_torch.native`) and uploaded once.
On a CUDA device the upload is the card-specific part: the loader owns a
ring of two pinned staging buffers that the gather writes straight into,
copies each into a fresh device tensor with ``non_blocking=True`` and
hands that tensor to ``minibatch_data``, which adopts it.  Before a
staging buffer is refilled the loader waits on the CUDA event of the
copy that last read it.  With ``prefetch`` the worker thread gathers
minibatch k+1 and issues its copy on a stream of its own while the card
trains on k; the step's stream waits on the copy's event, and
``record_stream`` keeps the caching allocator from handing the block
out early.  The device minibatch is the host minibatch, bit for bit.
On the CPU the host arrays are the minibatch, as in the reference.
"""

from __future__ import annotations

import json
import os
import struct

import numpy
import torch

from veles_tpu_torch import native
from veles_tpu_torch.loader.base import Loader

MAGIC = b"VTRECS1\n"


def write_records(path, data, labels, class_lengths):
    """Write a record file: data (N, ...) float32/uint8, labels (N,) int32,
    class_lengths [test, valid, train] summing to N."""
    data = numpy.ascontiguousarray(data)
    labels = (numpy.ascontiguousarray(labels, numpy.int32)
              if labels is not None else None)
    if sum(class_lengths) != len(data):
        raise ValueError("class_lengths %s don't sum to %d"
                         % (class_lengths, len(data)))
    header = {
        "shape": list(data.shape),
        "dtype": str(data.dtype),
        "labels": labels is not None,
        "class_lengths": list(int(n) for n in class_lengths),
    }
    blob = json.dumps(header).encode("utf-8")
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(blob)))
        f.write(blob)
        f.write(data.tobytes())
        if labels is not None:
            f.write(labels.tobytes())
    return path


def open_records(path):
    """(header dict, data memmap, labels array-or-None)."""
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError("%s is not a record file" % path)
        (hlen,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen).decode("utf-8"))
        data_off = f.tell()
    shape = tuple(header["shape"])
    dtype = numpy.dtype(header["dtype"])
    data = numpy.memmap(path, dtype=dtype, mode="r", offset=data_off,
                        shape=shape)
    labels = None
    if header["labels"]:
        lab_off = data_off + dtype.itemsize * int(numpy.prod(shape))
        labels = numpy.memmap(path, dtype=numpy.int32, mode="r",
                              offset=lab_off, shape=(shape[0],))
    return header, data, labels


class StagingRing:
    """Two pinned host buffers between the gather and the card.

    ``stage`` refills the next buffer (after the copy that last read it
    has finished), lets ``gather`` write the minibatch into it, and
    copies it into a fresh device tensor on ``stream`` without blocking
    the host.  Returns (device batch, device labels or None, the copy's
    event).  At most one ``stage`` call runs at a time (the loader's
    main thread or its one prefetch worker, handed over through a
    future)."""

    def __init__(self, device, batch_shape, with_labels):
        self.device = device
        self.slots = []
        for _ in range(2):
            data = torch.empty(batch_shape, dtype=torch.float32,
                               pin_memory=True)
            labels = (torch.empty(batch_shape[0], dtype=torch.int32,
                                  pin_memory=True) if with_labels else None)
            self.slots.append([data, labels, None])
        self.turn = 0

    def stage(self, gather, indices, stream):
        slot = self.slots[self.turn % 2]
        self.turn += 1
        data, labels, last_copy = slot
        if last_copy is not None:
            last_copy.synchronize()
        gather(indices, data.numpy(),
               None if labels is None else labels.numpy())
        with torch.cuda.stream(stream):
            dev = torch.empty(data.shape, dtype=data.dtype,
                              device=self.device)
            dev.copy_(data, non_blocking=True)
            dev_labels = None
            if labels is not None:
                dev_labels = torch.empty(labels.shape, dtype=labels.dtype,
                                         device=self.device)
                dev_labels.copy_(labels, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(stream)
        slot[2] = copied
        return dev, dev_labels, copied


class RecordsLoader(Loader):
    """Minibatch engine over a record file (memmap gather per step).

    Unlike FullBatchLoader the dataset does NOT live on the device — per
    step the minibatch is gathered host-side from the mapped file and
    uploaded once (the ImageNet-at-scale tradeoff; the reference's LMDB
    loader worked the same way).  ``scale_uint8`` rescales uint8 pixels
    to [-1, 1].
    """

    def __init__(self, workflow, path=None, scale_uint8=True,
                 prefetch=False, **kwargs):
        super().__init__(workflow, **kwargs)
        self.path = path
        self.scale_uint8 = scale_uint8
        #: double-buffering: a staging thread gathers (and on the card
        #: uploads) minibatch k+1 while the device trains on k (the C++
        #: gather releases the GIL, so the overlap is real).  The epoch
        #: plan makes the next indices known ahead of time; the last
        #: batch of an epoch stages nothing (the next plan is reshuffled
        #: later).
        self.prefetch = prefetch
        self._pending = None          # (indices bytes, Future)
        self._pool = None
        self._data = None
        self._labels = None
        self._ring = None             # CUDA only: the pinned staging ring
        self._copy_stream = None      # CUDA only: the prefetch worker's
        self.has_labels = True

    def load_data(self):
        if not self.path or not os.path.exists(self.path):
            raise ValueError("%s: record file %r not found"
                             % (self.name, self.path))
        header, self._data, self._labels = open_records(self.path)
        self.class_lengths = list(header["class_lengths"])
        self.has_labels = self._labels is not None

    def create_minibatch_data(self):
        mb = self.local_minibatch_size
        self.minibatch_data.reset(numpy.zeros(
            (mb,) + self._data.shape[1:], numpy.float32))
        if self.has_labels:
            self.minibatch_labels.reset(numpy.zeros(mb, numpy.int32))

    def initialize(self, device=None, **kwargs):
        super().initialize(device=device, **kwargs)
        device = None if device is None else torch.device(device)
        if device is not None and device.type == "cuda":
            self._ring = StagingRing(
                device, (self.local_minibatch_size,) + self._data.shape[1:],
                self.has_labels)
            self._copy_stream = torch.cuda.Stream(device)
        else:
            self._ring = self._copy_stream = None

    def _gather(self, indices, batch=None, labels=None):
        """(batch, labels) on the host: the fused gather+convert straight
        out of the mapped pages — the native (C++, threaded) hot path
        when libdataio is built, numpy otherwise — written into
        ``batch``/``labels`` when given."""
        if self.scale_uint8 and self._data.dtype == numpy.uint8:
            batch = native.gather_convert(self._data, indices,
                                          scale=1.0 / 127.5, offset=-1.0,
                                          out=batch)
        else:
            batch = native.gather_convert(self._data, indices, out=batch)
        if self.has_labels:
            labels = native.gather_labels(numpy.asarray(self._labels),
                                          indices, out=labels)
        return batch, labels

    def gather_window(self, indices):
        """Window-sized gather straight off the mapped pages — the
        streaming epoch-scan staging hook (same fused gather+convert as
        the per-minibatch path, so numerics match exactly; the scan
        itself is ROADMAP Queue 2a item 3)."""
        return self._gather(numpy.ascontiguousarray(indices, numpy.int32))

    def _fetch(self, indices, worker=False):
        """(batch, labels, copy event or None): host arrays on the CPU;
        on the card device tensors through the staging ring, copied on
        the current stream, or on the copy stream from the prefetch
        worker (then the event is returned for the step to wait on)."""
        if self._ring is None:
            return self._gather(indices) + (None,)
        stream = (self._copy_stream if worker
                  else torch.cuda.current_stream(self._ring.device))
        batch, labels, copied = self._ring.stage(self._gather, indices,
                                                 stream)
        return batch, labels, copied if worker else None

    def fill_minibatch(self, indices, actual_size):
        staged = None
        if self.prefetch:
            if self._pool is None:
                import concurrent.futures
                self._pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix=self.name)
            if self._pending is not None:
                key, fut = self._pending
                self._pending = None
                if key == indices.tobytes():
                    staged = fut.result()
                else:
                    # plan changed under us — discard; a stale gather's
                    # failure must not sink the fresh synchronous one
                    fut.cancel()
                    if not fut.cancelled():
                        fut.exception()
        if staged is None:
            staged = self._fetch(indices)
        batch, labels, copied = staged
        if copied is not None:
            # the worker copied on its own stream: the step's stream
            # waits for the copy, and the allocator keeps both blocks
            # until the step's work on them is done
            stream = torch.cuda.current_stream(self._ring.device)
            stream.wait_event(copied)
            for tensor in (batch, labels):
                if tensor is not None:
                    tensor.record_stream(stream)
        self.minibatch_data.reset(batch)
        if self.has_labels:
            self.minibatch_labels.reset(labels)
        if self.prefetch and self._position < len(self._order):
            # stage the NEXT minibatch while the device computes this one
            # (run() already advanced _position past the current entry)
            nxt = self.local_chunk(self._order[self._position][1])
            self._pending = (nxt.tobytes(),
                             self._pool.submit(self._fetch, nxt, True))

    def stop(self):
        if self._pool is not None:
            if self._pending is not None:
                self._pending[1].cancel()
                self._pending = None
            self._pool.shutdown(wait=True)
            self._pool = None
        super().stop()
