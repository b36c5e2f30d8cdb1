"""ctypes bindings for the native dataio library, with numpy fallbacks.

Port of ``veles_tpu/native/__init__.py`` (its ``dataio`` half; the PJRT
plugin discovery belongs with the artifact runner, ROADMAP Queue 2
item 6).  ``dataio.cpp`` is compiled with ``g++`` (no CUDA) at first use
into ``build/native/`` at the repository root, named by a hash of the
source and the flags, written to a temporary name and renamed, so an
edited source rebuilds and two processes never load a half-written
file.  Nothing is written into the package directory.

Every entry point has the reference's numpy fallback, so the package
works unbuilt: ``available()`` says which path is live,
``build_error()`` why the library is not, and ``VELES_TPU_TORCH_NO_NATIVE=1``
forces the fallback.  The two paths differ in the last place, as the
reference's do: the library computes ``float(u8) * scale + offset`` in
float32 (a multiply and an add, each rounded — the flags keep the
compiler from contracting them into one fused multiply-add), the
fallback multiplies the uint8 by the Python float in float64, rounds to
float32 and then adds.  Each path equals the reference's same path bit
for bit.

Each native call adds one to its entry's count (``call_counts``); the
fallback counts nothing, so a caller can show the library did the work.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy

SOURCE = Path(__file__).resolve().parent / "dataio.cpp"
BUILD_DIR = SOURCE.parent.parent.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread",
             "-ffp-contract=off")
NO_NATIVE_ENV = "VELES_TPU_TORCH_NO_NATIVE"
ENTRIES = ("gather_u8_to_f32", "gather_f32", "subtract_mean", "gather_i32")

_lock = threading.Lock()
_lib = None          # guarded-by: _lock
_tried = False       # guarded-by: _lock
_error = None        # guarded-by: _lock
_calls = dict.fromkeys(ENTRIES, 0)      # guarded-by: _lock


def library_path():
    """Where the library lives once built (content hash of the source
    and the flags)."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / ("libdataio-%s.so" % digest[:16])


def _build(out):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _declare(lib):
    i64, f32 = ctypes.c_int64, ctypes.c_float
    ptr = ctypes.POINTER
    lib.gather_u8_to_f32.argtypes = [
        ptr(ctypes.c_uint8), ptr(ctypes.c_int32), i64, i64, f32, f32,
        ptr(ctypes.c_float)]
    lib.gather_f32.argtypes = [
        ptr(ctypes.c_float), ptr(ctypes.c_int32), i64, i64, f32, f32,
        ptr(ctypes.c_float)]
    lib.subtract_mean.argtypes = [
        ptr(ctypes.c_float), ptr(ctypes.c_float), i64, i64]
    lib.gather_i32.argtypes = [
        ptr(ctypes.c_int32), ptr(ctypes.c_int32), i64, ptr(ctypes.c_int32)]
    for name in ENTRIES:
        getattr(lib, name).restype = None
    lib.dataio_abi_version.argtypes = []
    lib.dataio_abi_version.restype = ctypes.c_int


def _load():
    global _lib, _tried, _error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get(NO_NATIVE_ENV):
            _error = "%s is set" % NO_NATIVE_ENV
            return None
        out = library_path()
        try:
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
            _declare(lib)
            if lib.dataio_abi_version() != 1:
                _error = "libdataio ABI %d, not 1" % lib.dataio_abi_version()
                return None
        except subprocess.CalledProcessError as exc:
            _error = "g++ failed (%d):\n%s" % (exc.returncode, exc.stderr)
            return None
        except (OSError, AttributeError) as exc:
            # no compiler, or a corrupt library (a symbol missing): the
            # numpy fallback takes over, and build_error() says why
            _error = "%s: %s" % (type(exc).__name__, exc)
            return None
        _lib = lib
        return _lib


def available():
    """True when the native library is loaded (builds it on first call)."""
    return _load() is not None


def build_error():
    """Why the native library is not live (None when it is, or before
    the first call has tried to load it)."""
    _load()
    with _lock:
        return None if _lib is not None else _error


def call_counts():
    """{entry: native calls since the last reset}."""
    with _lock:
        return dict(_calls)


def reset_call_counts():
    with _lock:
        for name in _calls:
            _calls[name] = 0


def _count(name):
    with _lock:
        _calls[name] += 1


def _as_ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _check_indices(indices, n):
    if len(indices) and (int(indices.min()) < 0 or int(indices.max()) >= n):
        raise IndexError("gather indices outside [0, %d)" % n)


def _check_out(out, shape, dtype):
    if (out.shape != shape or out.dtype != dtype
            or not out.flags.c_contiguous or not out.flags.writeable):
        raise ValueError("out must be a writeable C-contiguous %s array of "
                         "shape %s, not %s %s" % (numpy.dtype(dtype), shape,
                                                  out.dtype, out.shape))


def _numpy_gather(src, indices, scale, offset, out):
    """Fallback: src[indices] copies only the minibatch rows, so it is
    safe for strided/memmapped sources of any size."""
    numpy.multiply(src[indices], scale, out=out, casting="unsafe")
    if offset:
        out += offset
    return out


def gather_convert(src, indices, scale=1.0, offset=0.0, out=None):
    """out[i] = float32(src[indices[i]]) * scale + offset.

    src: (n, ...) uint8 or float32 array/memmap (C-contiguous rows);
    returns (len(indices), ...) float32, written into ``out`` when given
    (e.g. a pinned staging buffer's numpy view).  The loader hot path.
    """
    indices = numpy.ascontiguousarray(indices, numpy.int32)
    sample_shape = src.shape[1:]
    sample_elems = int(numpy.prod(sample_shape)) if sample_shape else 1
    shape = (len(indices),) + sample_shape
    if out is None:
        out = numpy.empty(shape, numpy.float32)
    else:
        _check_out(out, shape, numpy.float32)
    lib = _load()
    if lib is None or not src.flags.c_contiguous or \
            src.dtype not in (numpy.uint8, numpy.float32):
        # no library; or a strided view the kernel cannot index (it reads
        # rows at idx * sample_elems) — never ascontiguousarray a whole
        # ImageNet-scale memmap just to gather a minibatch from it
        return _numpy_gather(src, indices, scale, offset, out)
    _check_indices(indices, len(src))
    if src.dtype == numpy.uint8:
        _count("gather_u8_to_f32")
        lib.gather_u8_to_f32(
            _as_ptr(src, ctypes.c_uint8), _as_ptr(indices, ctypes.c_int32),
            len(indices), sample_elems, scale, offset,
            _as_ptr(out, ctypes.c_float))
    else:
        _count("gather_f32")
        lib.gather_f32(
            _as_ptr(src, ctypes.c_float), _as_ptr(indices, ctypes.c_int32),
            len(indices), sample_elems, scale, offset,
            _as_ptr(out, ctypes.c_float))
    return out


def gather_labels(src, indices, out=None):
    """int32 label gather, into ``out`` when given."""
    indices = numpy.ascontiguousarray(indices, numpy.int32)
    if out is None:
        out = numpy.empty(len(indices), numpy.int32)
    else:
        _check_out(out, (len(indices),), numpy.int32)
    lib = _load()
    if lib is None or src.dtype != numpy.int32:
        out[...] = src[indices]
        return out
    src = numpy.ascontiguousarray(src, numpy.int32)
    _check_indices(indices, len(src))
    _count("gather_i32")
    lib.gather_i32(_as_ptr(src, ctypes.c_int32),
                   _as_ptr(indices, ctypes.c_int32), len(indices),
                   _as_ptr(out, ctypes.c_int32))
    return out


def subtract_mean(batch, mean):
    """In-place batch -= mean (row-parallel when native).

    The native kernel requires a full sample-shaped mean; broadcastable
    means (e.g. per-channel (3,)) take the numpy path so both paths keep
    numpy's broadcasting semantics.  A batch that is not C-contiguous
    float32 is copied first, as in the reference, so use the return
    value.
    """
    lib = _load()
    batch = numpy.ascontiguousarray(batch, numpy.float32)
    mean = numpy.ascontiguousarray(mean, numpy.float32)
    elems = int(numpy.prod(batch.shape[1:]))
    if lib is None or mean.size != elems:
        batch -= mean
        return batch
    _count("subtract_mean")
    lib.subtract_mean(_as_ptr(batch, ctypes.c_float),
                      _as_ptr(mean, ctypes.c_float), len(batch), elems)
    return batch
