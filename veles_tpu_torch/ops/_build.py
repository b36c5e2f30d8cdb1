"""Build the port's CUDA kernels at first use, from the checkout's own
sources.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with :mod:`ctypes` (no
PyTorch headers, so a build takes seconds, not minutes).  Libraries land
in ``build/kernels/`` at the repository root, named by a hash of the
source and the compiler flags, so an edited source rebuilds and an
unchanged one loads straight from disk.  A failed build raises with the
compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded = {}      # guarded-by: _lock


def nvcc_path():
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then
    the toolkit's default prefix.  Raises when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for path in candidates:
        if path.is_file():
            return str(path)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                       "PATH): the CUDA kernels build from source")


def library_path(source):
    """Where the library for ``source`` lives once built (content hash
    of the source text and the flags)."""
    source = Path(source)
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / ("%s-%s.so" % (source.stem, digest[:16]))


def compile_source(source):
    """Run nvcc on one source unless its library already exists;
    returns the library path.  The output is written to a temporary
    name and renamed, so a concurrent or interrupted build never leaves
    a torn library behind."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed (%d) on %s:\n%s%s" % (
                proc.returncode, source, proc.stdout, proc.stderr))
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name):
    """The loaded :class:`ctypes.CDLL` for ``csrc/<name>.cu``, built on
    first use and cached for the process.  The compile runs outside the
    lock (it is atomic on disk), so builds of different sources in
    different threads run side by side."""
    with _lock:
        lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = compile_source(CSRC_DIR / (name + ".cu"))
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib


def load_all(names):
    """Build and load several sources at once, one nvcc per source, all
    started together; returns {name: CDLL}.  Raises the first build
    failure."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        futures = {name: pool.submit(load, name) for name in names}
        return {name: f.result() for name, f in futures.items()}
