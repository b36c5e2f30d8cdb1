"""Caffe-LMDB dataset loader.

Port of ``veles_tpu/loader/lmdb.py``.  Ref: veles/znicz/loader/
loader_lmdb.py [M] (SURVEY §2.2): ImageNet-scale datasets prepared for
Caffe live in LMDB env files of serialized Datum records.  Reading
prefers the ``lmdb`` package when importable and otherwise falls back to
the pure-Python reader of the stable MDB on-disk format
(``veles_tpu_torch.loader.mdb``) — real env bytes either way, no fake
modules.  The supported in-tree path for LARGE datasets is
``records.py`` (convert once with ``lmdb_to_records``, then memmap).
"""

from __future__ import annotations

import os

import numpy

from veles_tpu_torch.loader.base import Loader


def _open_env(path):
    """Open ``path`` read-only; returns an object with ``stat()`` and
    ``items()`` (key/value bytes in key order)."""
    try:
        import lmdb
    except ImportError:
        from veles_tpu_torch.loader import mdb
        return mdb.open_env(path)

    class _PkgEnv:
        def __init__(self, path):
            self._env = lmdb.open(path, readonly=True, lock=False)

        def stat(self):
            return self._env.stat()

        def items(self):
            with self._env.begin() as txn:
                yield from txn.cursor()

        def close(self):
            self._env.close()
    return _PkgEnv(path)


def _iter_datums(env):
    """Yield (key, uint8 CHW array, label) from an opened environment."""
    for key, raw in env.items():
        arr, label = _parse_datum(raw)
        yield key, arr, label


def _varint(v):
    if v < 0:
        # protobuf encodes negatives as 10-byte two's complement; Datum
        # fields are all non-negative, so reject instead of hanging
        raise ValueError("negative varint %d (Datum fields are "
                         "non-negative)" % v)
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def serialize_datum(chw, label=0):
    """Serialize a uint8 CHW array to Caffe Datum protobuf wire bytes —
    the inverse of :func:`_parse_datum` (fixture/export use: author real
    Caffe-layout LMDBs with ``mdb.write_env``)."""
    chw = numpy.ascontiguousarray(chw, numpy.uint8)
    c, h, w = chw.shape
    out = b""
    for field, val in ((1, c), (2, h), (3, w)):
        out += _varint(field << 3) + _varint(val)
    data = chw.tobytes()
    out += _varint((4 << 3) | 2) + _varint(len(data)) + data
    out += _varint(5 << 3) + _varint(int(label))
    return out


def _parse_datum(raw):
    """Minimal Caffe Datum protobuf parse (channels/height/width/data/label)
    without a protobuf dependency — wire format is stable."""
    pos, fields = 0, {}
    data = raw
    while pos < len(data):
        tag = data[pos]
        pos += 1
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, shift = 0, 0
            while True:
                b = data[pos]
                pos += 1
                val |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            fields[field] = val
        elif wire == 2:  # length-delimited
            ln, shift = 0, 0
            while True:
                b = data[pos]
                pos += 1
                ln |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            fields[field] = data[pos:pos + ln]
            pos += ln
        else:
            raise ValueError("unsupported Datum wire type %d" % wire)
    c, h, w = fields.get(1, 0), fields.get(2, 0), fields.get(3, 0)
    pixels = numpy.frombuffer(fields[4], numpy.uint8).reshape(c, h, w)
    return pixels, int(fields.get(5, 0))


def lmdb_to_records(lmdb_path, out_path, class_lengths=None):
    """Convert a Caffe LMDB to the in-tree record format (HWC uint8).

    Streams sample-by-sample — only one decoded image is resident at a time
    (ImageNet-scale LMDBs do not fit in RAM); labels (4 bytes each) are
    buffered and appended after the data blob, matching records.py's layout.
    """
    import json
    import struct
    from veles_tpu_torch.loader.records import MAGIC
    env = _open_env(lmdb_path)
    try:
        n = env.stat()["entries"]
        if class_lengths is None:
            class_lengths = [0, 0, n]
        if sum(class_lengths) != n:
            raise ValueError("class_lengths %s don't sum to %d"
                             % (class_lengths, n))
        if n == 0:
            raise ValueError("empty LMDB %r: nothing to convert (a "
                             "record file needs at least one sample to "
                             "fix the header shape)" % lmdb_path)
    except Exception:
        env.close()               # validation errors must not leak the map
        raise
    labels = numpy.zeros(n, numpy.int32)
    written = 0
    sample_shape = None
    # stream into a temp file and rename on success: a mid-write abort
    # (shape mismatch, count mismatch, ENOSPC) must never leave a
    # valid-looking but truncated record file at out_path
    tmp_path = "%s.%d.tmp" % (out_path, os.getpid())
    try:
        with open(tmp_path, "wb") as f:
            for _, chw, label in _iter_datums(env):
                hwc = numpy.ascontiguousarray(chw.transpose(1, 2, 0))
                if sample_shape is None:
                    sample_shape = hwc.shape
                    header = {"shape": [n] + list(hwc.shape),
                              "dtype": "uint8", "labels": True,
                              "class_lengths": [int(c)
                                                for c in class_lengths]}
                    blob = json.dumps(header).encode("utf-8")
                    f.write(MAGIC)
                    f.write(struct.pack("<I", len(blob)))
                    f.write(blob)
                elif hwc.shape != sample_shape:
                    # the record layout is fixed-stride: a differently-
                    # shaped sample would corrupt every record after it
                    raise ValueError(
                        "record %d has shape %s, expected %s (record files "
                        "require uniform shapes — resize before converting)"
                        % (written, hwc.shape, sample_shape))
                f.write(hwc.tobytes())
                labels[written] = label
                written += 1
            if written != n:
                raise ValueError("LMDB yielded %d records, stat said %d"
                                 % (written, n))
            f.write(labels.tobytes())
        os.replace(tmp_path, out_path)
    finally:
        env.close()               # release the mmap/fd promptly
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)
    return out_path


class LMDBLoader(Loader):
    """Direct LMDB minibatch loader (train split; optional valid split)."""

    def __init__(self, workflow, train_path=None, validation_path=None,
                 **kwargs):
        super().__init__(workflow, **kwargs)
        self.train_path = train_path
        self.validation_path = validation_path
        self._splits = {}

    def _load_split(self, path):
        """uint8 HWC arrays — float conversion happens per minibatch (a
        float32 copy of an ImageNet split would 4x the resident set)."""
        env = _open_env(path)
        try:
            xs, ys = [], []
            for _, chw, label in _iter_datums(env):
                xs.append(chw.transpose(1, 2, 0))
                ys.append(label)
            return numpy.stack(xs), numpy.asarray(ys, numpy.int32)
        finally:
            env.close()           # splits are copied out; drop the map

    def load_data(self):
        valid = ((self._load_split(self.validation_path))
                 if self.validation_path else
                 (numpy.zeros((0, 1, 1, 1), numpy.uint8),
                  numpy.zeros(0, numpy.int32)))
        train = self._load_split(self.train_path)
        self._data = numpy.concatenate(
            [valid[0], train[0]]) if len(valid[0]) else train[0]
        self._labels = numpy.concatenate([valid[1], train[1]])
        self.class_lengths = [0, len(valid[1]), len(train[1])]

    def create_minibatch_data(self):
        mb = self.local_minibatch_size
        self.minibatch_data.reset(numpy.zeros(
            (mb,) + self._data.shape[1:], numpy.float32))
        self.minibatch_labels.reset(numpy.zeros(mb, numpy.int32))

    def fill_minibatch(self, indices, actual_size):
        batch = self._data[indices].astype(numpy.float32) / 127.5 - 1.0
        self.minibatch_data.reset(batch)
        self.minibatch_labels.reset(self._labels[indices])

    def gather_window(self, indices):
        """Streaming epoch-scan staging hook: identical conversion to
        :meth:`fill_minibatch`, a window of rows at a time."""
        batch = self._data[indices].astype(numpy.float32) / 127.5 - 1.0
        return batch, numpy.ascontiguousarray(self._labels[indices],
                                              numpy.int32)
