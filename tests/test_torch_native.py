"""The port's native dataio library against the reference's, on the CPU.

Both packages build the same ``dataio.cpp`` with ``g++`` (the port adds
``-ffp-contract=off`` and builds into ``build/native/``, never into its
package) and get the same numpy inputs from a seed.

Tolerances: none — every comparison is bit for bit.  The port's native
path equals the reference's native path, and the port's numpy fallback
equals the reference's ``_numpy_gather``.  The two paths differ from each
other by design, as the reference's do: the library computes
``float(u8) * scale + offset`` in float32, the fallback multiplies in
float64 and rounds before it adds, so at ``scale = 1/127.5, offset = -1``
111 of the 256 byte values land up to one ulp of 1.0 (2**-23 = 1.19e-7)
apart.
``test_native_and_fallback_gap_is_one_ulp`` states that gap.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy
import pytest

from veles_tpu import native as ref
from veles_tpu_torch import native

ROOT = Path(__file__).resolve().parent.parent
SCALE, OFFSET = 1.0 / 127.5, -1.0


@pytest.fixture(scope="module", autouse=True)
def _both_native():
    assert native.available(), native.build_error()
    assert ref.available()


@pytest.fixture
def fallback(monkeypatch):
    """The port's numpy fallback, as with the library absent."""
    monkeypatch.setattr(native, "_load", lambda: None)


def _bits(a):
    a = numpy.ascontiguousarray(a)
    return a.view(numpy.uint8)


def _equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    numpy.testing.assert_array_equal(_bits(got), _bits(want))


def _all_bytes():
    src = numpy.arange(256, dtype=numpy.uint8).reshape(16, 4, 4)
    return src, numpy.arange(16, dtype=numpy.int32)[::-1].copy()


def test_library_builds_outside_the_package():
    path = native.library_path()
    assert path.exists()
    assert path.parent == ROOT / "build" / "native"
    assert path.name.startswith("libdataio-")
    assert "-ffp-contract=off" in native.CXX_FLAGS
    assert not any(p.suffix == ".so" for p in
                   (ROOT / "veles_tpu_torch" / "native").iterdir())
    assert native.build_error() is None


def test_all_byte_values_bit_equal_to_reference_native():
    src, idx = _all_bytes()
    native.reset_call_counts()
    got = native.gather_convert(src, idx, scale=SCALE, offset=OFFSET)
    assert native.call_counts()["gather_u8_to_f32"] == 1
    _equal(got, ref.gather_convert(src, idx, scale=SCALE, offset=OFFSET))


@pytest.mark.parametrize("scale,offset", [(1.0, 0.0), (2.0, 1.0),
                                          (1.0 / 255.0, 0.0),
                                          (1.0 / 127.5, -1.0)])
def test_memmap_source_bit_equal(tmp_path, scale, offset):
    rng = numpy.random.RandomState(2)
    data = rng.randint(0, 256, (40, 6, 5, 3), dtype=numpy.uint8)
    path = str(tmp_path / "data.bin")
    data.tofile(path)
    mapped = numpy.memmap(path, numpy.uint8, "r", shape=data.shape)
    idx = rng.randint(0, 40, 24).astype(numpy.int32)
    _equal(native.gather_convert(mapped, idx, scale, offset),
           ref.gather_convert(mapped, idx, scale, offset))


def test_float32_source_bit_equal():
    rng = numpy.random.RandomState(1)
    src = rng.randn(50, 12).astype(numpy.float32)
    idx = rng.randint(0, 50, 20).astype(numpy.int32)
    native.reset_call_counts()
    for scale, offset in ((1.0, 0.0), (0.37, -2.5)):
        _equal(native.gather_convert(src, idx, scale, offset),
               ref.gather_convert(src, idx, scale, offset))
    assert native.call_counts()["gather_f32"] == 2
    _equal(native.gather_convert(src, idx), src[idx])


def test_strided_source_takes_the_fallback_bit_equal():
    rng = numpy.random.RandomState(5)
    full = rng.randint(0, 256, (20, 4, 4, 4), dtype=numpy.uint8)
    view = full[:, :, :, :3]            # rows the kernel cannot index
    idx = numpy.arange(0, 20, 2, dtype=numpy.int32)
    native.reset_call_counts()
    got = native.gather_convert(view, idx, scale=SCALE, offset=OFFSET)
    assert native.call_counts()["gather_u8_to_f32"] == 0
    _equal(got, ref.gather_convert(view, idx, scale=SCALE, offset=OFFSET))


def test_out_buffer_written_in_place():
    src, idx = _all_bytes()
    out = numpy.full((16, 4, 4), numpy.nan, numpy.float32)
    got = native.gather_convert(src, idx, SCALE, OFFSET, out=out)
    assert got is out
    _equal(out, ref.gather_convert(src, idx, SCALE, OFFSET))
    labels = numpy.arange(100, 116, dtype=numpy.int32)
    lab_out = numpy.zeros(16, numpy.int32)
    assert native.gather_labels(labels, idx, out=lab_out) is lab_out
    _equal(lab_out, labels[idx])
    for bad in (numpy.zeros((16, 4, 4), numpy.float64),
                numpy.zeros((15, 4, 4), numpy.float32),
                numpy.zeros((16, 4, 8), numpy.float32)[:, :, ::2]):
        with pytest.raises(ValueError, match="out must be"):
            native.gather_convert(src, idx, out=bad)


def test_out_of_range_index_raises_before_the_library():
    src, _ = _all_bytes()
    for idx in ([0, 16], [-1, 2]):
        with pytest.raises(IndexError):
            native.gather_convert(src, numpy.asarray(idx, numpy.int32))
    with pytest.raises(IndexError):
        native.gather_labels(numpy.arange(4, dtype=numpy.int32),
                             numpy.asarray([4], numpy.int32))


def test_labels_and_mean_bit_equal():
    rng = numpy.random.RandomState(3)
    labels = rng.randint(0, 1000, 100).astype(numpy.int32)
    idx = rng.randint(0, 100, 30).astype(numpy.int32)
    native.reset_call_counts()
    _equal(native.gather_labels(labels, idx), ref.gather_labels(labels, idx))
    batch = rng.randn(8, 6, 6, 3).astype(numpy.float32)
    mean = rng.randn(6, 6, 3).astype(numpy.float32)
    got = batch.copy()
    assert native.subtract_mean(got, mean) is got
    _equal(got, ref.subtract_mean(batch.copy(), mean))
    assert native.call_counts() == {"gather_u8_to_f32": 0, "gather_f32": 0,
                                    "subtract_mean": 1, "gather_i32": 1}


def test_broadcast_mean_keeps_numpy_semantics():
    rng = numpy.random.RandomState(4)
    batch = rng.randn(4, 6, 6, 3).astype(numpy.float32)
    channel_mean = numpy.array([104.0, 117.0, 123.0], numpy.float32)
    native.reset_call_counts()
    _equal(native.subtract_mean(batch.copy(), channel_mean),
           ref.subtract_mean(batch.copy(), channel_mean))
    assert native.call_counts()["subtract_mean"] == 0


def test_fallback_bit_equal_to_reference_fallback(fallback):
    src, idx = _all_bytes()
    native.reset_call_counts()
    want = ref._numpy_gather(src, idx, SCALE, OFFSET,
                             numpy.empty((16, 4, 4), numpy.float32))
    _equal(native.gather_convert(src, idx, SCALE, OFFSET), want)
    rng = numpy.random.RandomState(6)
    f32 = rng.randn(30, 7).astype(numpy.float32)
    i = rng.randint(0, 30, 9).astype(numpy.int32)
    _equal(native.gather_convert(f32, i, 0.37, -2.5),
           ref._numpy_gather(f32, i, 0.37, -2.5,
                             numpy.empty((9, 7), numpy.float32)))
    labels = numpy.arange(30, dtype=numpy.int32)
    _equal(native.gather_labels(labels, i), labels[i])
    batch = rng.randn(5, 7).astype(numpy.float32)
    mean = rng.randn(7).astype(numpy.float32)
    _equal(native.subtract_mean(batch.copy(), mean), batch - mean)
    assert sum(native.call_counts().values()) == 0


def test_native_and_fallback_gap_is_one_ulp(fallback):
    """The stated gap: the two paths of either package differ in 111 of
    the 256 byte values, each by at most one ulp of the offset's scale
    (ulp(1.0) = 2**-23, from the product rounded in float32 or float64
    before the add)."""
    src, idx = _all_bytes()
    fast = ref.gather_convert(src, idx, SCALE, OFFSET)     # native
    slow = native.gather_convert(src, idx, SCALE, OFFSET)  # fallback
    gap = numpy.abs(fast.astype(numpy.float64) - slow)
    assert int((gap > 0).sum()) == 111
    assert float(gap.max()) == 2.0 ** -23


def test_opt_out_variable_forces_the_fallback(tmp_path):
    code = ("import numpy\n"
            "from veles_tpu_torch import native\n"
            "assert not native.available()\n"
            "assert 'VELES_TPU_TORCH_NO_NATIVE' in native.build_error()\n"
            "src = numpy.arange(256, dtype=numpy.uint8).reshape(16, 16)\n"
            "out = native.gather_convert(src, numpy.arange(16), 1 / 127.5,"
            " -1.0)\n"
            "numpy.save(%r, out)\n")
    out_path = tmp_path / "out.npy"
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               VELES_TPU_TORCH_NO_NATIVE="1")
    proc = subprocess.run([sys.executable, "-c", code % str(out_path)],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    got = numpy.load(out_path)
    src = numpy.arange(256, dtype=numpy.uint8).reshape(16, 16)
    _equal(got, ref._numpy_gather(src, numpy.arange(16, dtype=numpy.int32),
                                  SCALE, OFFSET,
                                  numpy.empty((16, 16), numpy.float32)))
