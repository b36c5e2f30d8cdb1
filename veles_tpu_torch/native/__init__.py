"""ctypes bindings for the native dataio library, with numpy fallbacks,
and the build of the native artifact runner.

Port of ``veles_tpu/native/__init__.py``.  Its PJRT plugin discovery
has no counterpart: the port's runner (``artifact_runner.cpp``, see
:func:`build_runner`) links libtorch and needs no plugin.
``dataio.cpp`` is compiled with ``g++`` (no CUDA) at first use
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


# ------------------------------------------------------- the artifact runner
RUNNER_SOURCE = SOURCE.parent / "artifact_runner.cpp"
#: the environment variable naming the LRN kernel library to the runner
LRN_LIBRARY_ENV = "VELES_TPU_TORCH_LRN_LIBRARY"


def _runner_flags():
    """g++ flags for a libtorch program against the running torch: its
    headers and libraries (rpath'd), its C++ ABI, and with a CUDA build
    of torch its CUDA libraries and the toolkit's headers (the op's card
    implementation reads the current stream)."""
    import torch
    root = Path(torch.__file__).resolve().parent
    lib = root / "lib"
    flags = ["-O2", "-std=c++17", "-fPIC",
             "-D_GLIBCXX_USE_CXX11_ABI=%d" % int(torch._C._GLIBCXX_USE_CXX11_ABI),
             "-I%s" % (root / "include"),
             "-I%s" % (root / "include" / "torch" / "csrc" / "api" / "include")]
    libs = ["-L%s" % lib, "-Wl,-rpath,%s" % lib, "-Wl,--no-as-needed",
            "-ltorch", "-ltorch_cpu", "-lc10"]
    if torch.version.cuda is not None:
        from veles_tpu_torch.ops import _build
        cuda = Path(_build.nvcc_path()).resolve().parent.parent
        flags += ["-DARTIFACT_RUNNER_CUDA", "-I%s" % (cuda / "include")]
        cudart = _cudart(root, cuda)
        libs += ["-ltorch_cuda", "-lc10_cuda", str(cudart),
                 "-Wl,-rpath,%s" % cudart.parent]
    return flags, libs + ["-Wl,--as-needed", "-ldl", "-pthread"]


def _cudart(torch_root, cuda):
    """The CUDA runtime library torch runs on (its wheel's, else the
    toolkit's): the inline stream and guard code of c10's CUDA headers
    calls it."""
    for directory in (torch_root.parent / "nvidia" / "cuda_runtime" / "lib",
                      torch_root / "lib", cuda / "lib64"):
        hits = sorted(directory.glob("libcudart.so*"))
        if hits:
            return hits[0]
    raise RuntimeError("no libcudart.so beside torch or under %s" % cuda)


def runner_path(source=RUNNER_SOURCE):
    """Where the runner built from ``source`` lives (content hash of the
    source text and the flags)."""
    flags, libs = _runner_flags()
    digest = hashlib.sha256(Path(source).read_bytes()
                            + " ".join(flags + libs).encode()).hexdigest()
    return BUILD_DIR / ("artifact_runner-%s" % digest[:16])


def build_runner(source=RUNNER_SOURCE):
    """Build the artifact runner from ``source`` with g++ unless it is
    built already; returns its path.  Written to a temporary name and
    renamed; a failed build raises with the compiler's output."""
    out = runner_path(source)
    if out.exists():
        return out
    flags, libs = _runner_flags()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *flags, "-o", tmp, str(source), *libs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("g++ failed (%d) on %s:\n%s%s" % (
                proc.returncode, source, proc.stdout, proc.stderr))
        os.chmod(tmp, 0o755)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def run_artifact(bundle_dir, x, runner=None, timeout=600):
    """Run the native runner on the bundle with input ``x`` (numpy, the
    bundle's input shape); returns (output, lrn launches, the runner's
    stdout and stderr).  ``runner`` defaults to :func:`build_runner`'s.
    Raises RuntimeError, with the runner's stderr, when it fails."""
    import json
    bundle_dir = Path(bundle_dir)
    manifest = json.loads((bundle_dir / "manifest.json").read_text())
    x = numpy.ascontiguousarray(x, "<f4")
    if list(x.shape) != manifest["input_shape"]:
        raise ValueError("input %s, the bundle takes %s"
                         % (list(x.shape), manifest["input_shape"]))
    runner = str(runner or build_runner())
    env = dict(os.environ)
    if manifest["device"] == "cuda":
        # the op's card implementation loads the built LRN kernel
        from veles_tpu_torch.ops import _build
        env[LRN_LIBRARY_ENV] = str(_build.compile_source(
            _build.CSRC_DIR / "lrn.cu"))
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = Path(tmp) / "input.bin", Path(tmp) / "output.bin"
        x.tofile(src)
        proc = subprocess.run([runner, str(bundle_dir), str(src), str(dst)],
                              capture_output=True, text=True,
                              timeout=timeout, env=env)
        if proc.returncode != 0:
            raise RuntimeError("artifact_runner exited %d:\n%s"
                               % (proc.returncode, proc.stderr))
        out = numpy.fromfile(dst, "<f4").reshape(manifest["output_shape"])
    launches = [int(line.split()[-1]) for line in proc.stderr.splitlines()
                if line.startswith("lrn_forward launches ")]
    if len(launches) != 1:
        raise RuntimeError("artifact_runner printed no launch count:\n%s"
                           % proc.stderr)
    return out, launches[0], proc.stdout, proc.stderr
