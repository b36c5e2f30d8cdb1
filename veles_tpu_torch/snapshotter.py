"""Snapshotter — periodic whole-workflow checkpoint, resume, and carry-over
from the reference.

Port of ``veles_tpu/snapshotter.py`` (ref: veles/snapshotter.py::
SnapshotterBase/SnapshotterToFile/Snapshotter.import_() [H]): at epoch
boundaries, when the validation metric improved or every ``interval``
epochs (rate-limited by ``time_interval``), the workflow's
``snapshot_state()`` — every unit's ``snapshot_attrs`` (Vectors as numpy
arrays) plus every named PRNG stream — is pickled with ""/gz/bz2/xz
compression into ``<prefix>_<epoch>_<metric>.pickle[.<codec>]``, staged,
fsync'd and atomically renamed, with a ``<prefix>_current`` copy beside
it.  Resuming restores the loader's plan and cursor and the PRNG states,
so a resumed run continues bit for bit.

Loading (:func:`import_`) unpickles through a restricted unpickler: numpy,
the builtins a state holds and this package's own classes.  A reference
snapshot pickles ``veles_tpu`` objects (the loader's normalizer); such a
global is refused, naming :func:`state_from_reference`, which turns a
reference snapshot's ``state`` (read by the reference, arrays as numpy)
into this package's.
"""

from __future__ import annotations

import bz2
import gzip
import lzma
import os
import pickle
import re
import shutil
import time
import zlib

import numpy

from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.units import Unit

#: snapshot container format version (the reference's)
FORMAT = 1

_OPENERS = {
    "": open,
    "gz": gzip.open,
    "bz2": bz2.open,
    "xz": lzma.open,
}


def _open_for(path, mode):
    for suffix, opener in _OPENERS.items():
        if suffix and path.endswith("." + suffix):
            return opener(path, mode)
    return open(path, mode)


def _fsync_path(path):
    """fsync one file (and best-effort its directory) so the rename that
    publishes it cannot be reordered past the data by a crash."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    try:
        dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:            # some filesystems refuse directory fds
        pass


def _write_staged(path, payload, compression):
    """Pickle ``payload`` to ``path + '.tmp'`` with the codec, fsync it;
    returns the staged path (the caller renames it into place)."""
    tmp = path + ".tmp"
    with _OPENERS[compression](tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    _fsync_path(tmp)
    return tmp


class SnapshotterBase(Unit):
    """Decides WHEN to snapshot; subclasses decide WHERE.

    Wired off the Decision unit: fires at epoch boundaries, writes when
    the validation metric improved or every ``interval`` epochs,
    whichever happens first; ``time_interval`` rate-limits writes by the
    wall clock (the final write at completion is never held back).
    """

    def __init__(self, workflow, prefix="wf", interval=1, time_interval=0.0,
                 compression="gz", **kwargs):
        super().__init__(workflow, **kwargs)
        self.prefix = prefix
        self.interval = int(interval)
        self.time_interval = float(time_interval)
        if compression not in _OPENERS:
            raise ValueError("unknown compression %r (known: %s)" %
                             (compression, ", ".join(sorted(_OPENERS))))
        self.compression = compression
        self.skip = Bool(False)
        self._last_write = 0.0
        self._last_epoch_written = None
        #: path of the most recent snapshot
        self.destination = None
        # linked from decision: improved, complete; from loader:
        # epoch_number, epoch_ended

    def _should_write(self):
        """True when a snapshot is due (on every rank alike)."""
        if bool(self.skip) or not bool(self.epoch_ended):
            return False
        epoch = int(self.epoch_number)
        if not bool(self.improved) and (self.interval <= 0
                                        or epoch % self.interval != 0):
            return False
        if self.time_interval > 0.0 and not bool(self.complete):
            if time.time() - self._last_write < self.time_interval:
                return False
        return True

    def run(self):
        if not self._should_write():
            return
        self._last_write = time.time()
        self._last_epoch_written = int(self.epoch_number)
        self._export_or_gather()

    def stop(self):
        # final snapshot on workflow completion (skipped if this epoch
        # was already written)
        if (self.is_initialized and not bool(self.skip)
                and bool(getattr(self, "complete", False))
                and self._last_epoch_written != int(self.epoch_number)):
            self._last_epoch_written = int(self.epoch_number)
            self._export_or_gather()

    def _export_or_gather(self):
        """Rank 0 writes; under tensor parallelism the other ranks take
        part in the gather of the split layers that its snapshot
        makes."""
        if self._is_writer_process():
            self.export()
            return
        trainer = getattr(self.workflow, "_sharded_trainer", None)
        if trainer is not None and trainer.split:
            trainer.sync_to_runner()

    @staticmethod
    def _is_writer_process():
        """Only rank 0 of an initialized ``torch.distributed`` group
        writes (the state is replicated); a single process always
        does."""
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank() == 0
        return True

    def payload(self):
        return build_payload(self.workflow,
                             epoch=int(getattr(self, "epoch_number", 0)))

    def export(self):
        raise NotImplementedError


class SnapshotterToFile(SnapshotterBase):
    """Writes snapshots as (optionally compressed) pickle files:
    ``<prefix>_<epoch>_<metric>.pickle[.<codec>]`` plus a
    ``<prefix>_current.pickle[.<codec>]`` copy of the latest write."""

    def __init__(self, workflow, directory=".", keep_last=0, **kwargs):
        super().__init__(workflow, **kwargs)
        self.directory = directory
        #: > 0 — retain only the newest N epoch files (the ``*_current``
        #: copy is never pruned); 0 keeps everything
        self.keep_last = int(keep_last)

    def _suffix(self):
        return ".pickle" + ("." + self.compression if self.compression
                            else "")

    def export(self):
        os.makedirs(self.directory, exist_ok=True)
        payload = self.payload()
        metric = payload["best_metric"]
        tag = ("%g" % metric) if isinstance(metric, (int, float)) else "na"
        path = os.path.join(self.directory, "%s_%d_%s%s" % (
            self.prefix, payload["epoch"], tag, self._suffix()))
        # serialize + compress ONCE; both files are staged, fsync'd and
        # published by atomic rename, so a crash never leaves a torn
        # snapshot behind
        tmp = _write_staged(path, payload, self.compression)
        current = os.path.join(self.directory,
                               "%s_current%s" % (self.prefix, self._suffix()))
        shutil.copyfile(tmp, current + ".tmp")
        _fsync_path(current + ".tmp")
        os.replace(tmp, path)
        os.replace(current + ".tmp", current)
        self.destination = path
        self.info("snapshot → %s", path)
        self._prune()
        return path

    def _prune(self):
        """Drop the lowest-epoch files beyond ``keep_last``: only this
        snapshotter's ``<prefix>_<epoch>_...`` files, ordered by the
        epoch in the name (never by mtime); ``*_current`` survives."""
        if self.keep_last <= 0:
            return
        pattern = re.compile(re.escape(self.prefix) + r"_(\d+)_")
        epochs = []
        for fname in os.listdir(self.directory):
            m = pattern.match(fname)
            if m is None or not fname.endswith(self._suffix()):
                continue
            epochs.append((int(m.group(1)),
                           os.path.join(self.directory, fname)))
        epochs.sort()
        for _, path in epochs[:max(0, len(epochs) - self.keep_last)]:
            try:
                os.remove(path)
            except OSError:       # a concurrent reader/cleaner — not fatal
                pass


class Snapshotter(SnapshotterToFile):
    """The reference's name for the file flavor."""


def find_current(directory, prefix=None):
    """Most recent ``*_current.pickle*`` snapshot in ``directory`` or
    None — the resolver behind ``--snapshot auto``.  Staging files
    (``*.tmp``) never match."""
    if not os.path.isdir(directory):
        return None
    suffixes = tuple(".pickle" + ("." + c if c else "") for c in _OPENERS)
    best, best_mtime = None, -1.0
    for fname in os.listdir(directory):
        stem = fname.split(".pickle")[0]
        if (not stem.endswith("_current")
                or not any(fname == stem + s for s in suffixes)):
            continue
        if prefix is not None and stem != prefix + "_current":
            continue
        path = os.path.join(directory, fname)
        mtime = os.path.getmtime(path)
        if mtime > best_mtime:
            best, best_mtime = path, mtime
    return best


#: builtins a snapshot state may name (containers and scalars)
_BUILTINS = {"set", "frozenset", "list", "dict", "tuple", "slice", "range",
             "complex", "bytearray", "bytes", "int", "float", "bool", "str",
             "object"}


class _Unpickler(pickle.Unpickler):
    """Admits numpy, the container builtins, ``collections`` and this
    package's classes; refuses a reference (``veles_tpu``) global with a
    pointer to :func:`state_from_reference`, and anything else."""

    def find_class(self, module, name):
        root = module.split(".")[0]
        if root == "veles_tpu":
            raise pickle.UnpicklingError(
                "%s.%s is the JAX package's: read a reference snapshot "
                "with the reference and carry its state across with "
                "veles_tpu_torch.snapshotter.state_from_reference"
                % (module, name))
        if (root in ("numpy", "veles_tpu_torch", "collections", "_codecs")
                or (module == "builtins" and name in _BUILTINS)):
            return super().find_class(module, name)
        raise pickle.UnpicklingError("global %s.%s is not allowed in a "
                                     "snapshot" % (module, name))


def import_(path):
    """Load a snapshot payload from disk (ref: Snapshotter.import_ [H]).

    A partial or corrupt file, a file that is not a snapshot, or one
    naming a global the restricted unpickler refuses raises ValueError
    naming the file; opening it (a missing path, permissions) raises
    the I/O error untouched."""
    f = _open_for(path, "rb")
    try:
        with f:
            payload = _Unpickler(f).load()
    except (OSError, EOFError, pickle.UnpicklingError, AttributeError,
            ImportError, IndexError, lzma.LZMAError, zlib.error,
            ValueError, TypeError) as e:
        raise ValueError("corrupt, truncated or foreign snapshot %s: %s: %s"
                         % (path, type(e).__name__, e)) from e
    if not isinstance(payload, dict) or payload.get("format") != FORMAT:
        raise ValueError("unsupported snapshot format %r in %s" %
                         (payload.get("format")
                          if isinstance(payload, dict) else
                          type(payload).__name__, path))
    return payload


def build_payload(workflow, epoch=None):
    """The one snapshot-payload builder (the unit's export and
    :func:`save` share it).  ``epoch`` defaults to the loader's."""
    import veles_tpu_torch
    from veles_tpu_torch.config import root
    if epoch is None:
        epoch = int(getattr(getattr(workflow, "loader", None),
                            "epoch_number", 0))
    return {
        "format": FORMAT,
        "framework_version": veles_tpu_torch.__version__,
        "workflow_class": "%s.%s" % (type(workflow).__module__,
                                     type(workflow).__name__),
        "workflow_name": workflow.name,
        "epoch": int(epoch),
        "best_metric": getattr(
            getattr(workflow, "decision", None), "best_metric", None),
        "time": time.time(),
        "state": workflow.snapshot_state(),
        "config": root.as_dict(),
    }


def save(workflow, path):
    """One-shot snapshot of a built workflow to ``path`` (compression
    from the suffix), atomically published."""
    suffix = path.rsplit(".", 1)[-1]
    compression = suffix if suffix in ("gz", "bz2", "xz") else ""
    os.replace(_write_staged(path, build_payload(workflow), compression),
               path)
    return path


def restore(workflow, path_or_payload):
    """Restore a built, initialized workflow from a snapshot (a path or
    a payload); returns the payload."""
    payload = (path_or_payload if isinstance(path_or_payload, dict)
               else import_(path_or_payload))
    workflow.load_snapshot_state(payload["state"])
    return payload


# ------------------------------------------------------------ carry across
#: the loader's sharding attributes, carried across as tuples (a
#: reference snapshot may hold them as lists)
_SHARD_ATTRS = ("_shard", "_spmd_shard")


def _carry(value):
    """A reference state value as this package's: containers walked,
    arrays as numpy, a ``veles_tpu.<m>.<C>`` object as a
    ``veles_tpu_torch.<m>.<C>`` with the same attributes."""
    if isinstance(value, dict):
        return {k: _carry(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_carry(v) for v in value]
    if isinstance(value, tuple):
        return tuple(_carry(v) for v in value)
    module = type(value).__module__ or ""
    if module == "veles_tpu" or module.startswith("veles_tpu."):
        import importlib
        port = importlib.import_module(
            "veles_tpu_torch" + module[len("veles_tpu"):])
        cls = getattr(port, type(value).__name__)
        obj = cls.__new__(cls)
        obj.__dict__.update(_carry(vars(value)))
        return obj
    if module.startswith(("jax", "jaxlib")):
        return numpy.asarray(value)
    return value


def state_from_reference(state):
    """A reference snapshot's ``state`` (``payload["state"]`` as the
    reference's ``import_`` reads it; device arrays may already be
    numpy) as this package's ``snapshot_state()``: the same units,
    attributes and PRNG streams, with each reference object (the
    loader's normalizer) rebuilt as the port's class of the same name
    and the loader's sharding attributes (``_shard``, ``_spmd_shard``:
    a sharded run's process-0 snapshot) carried across; the restoring
    process's own shard identity wins (``Loader.load_state_dict``).
    ``workflow.load_snapshot_state`` (or :func:`restore` of a payload
    holding it) then resumes the port where the reference stopped."""
    units = {}
    for name, attrs in state["units"].items():
        attrs = dict(attrs)
        for key in _SHARD_ATTRS:
            if attrs.get(key) is not None:
                attrs[key] = tuple(int(v) for v in attrs[key])
        units[name] = _carry(attrs)
    return {"workflow_class": state.get("workflow_class"), "units": units,
            "prng": _carry(state.get("prng", {}))}
