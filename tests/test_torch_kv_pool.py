"""The port's KV page allocator against ``veles_tpu``'s: the same
alloc/retain/pin/release sequence leaves the same free lists, ref
counts and pins, and raises the same errors."""

import pytest

from veles_tpu.serving.kv_pool import KVPagePool as RefPool
from veles_tpu_torch.serving.kv_pool import KVPagePool
from torch_witness import port_witness  # noqa: F401


def _state(pool):
    return pool.snapshot(), pool.free_pages, pool.pinned_pages


def _apply(pool, op, *args):
    try:
        return ("ok", getattr(pool, op)(*args))
    except Exception as e:   # noqa: BLE001 — compared across packages
        return (type(e).__name__, str(e))


SEQUENCE = [
    ("alloc", 3), ("alloc", 2), ("pin", 1), ("retain", 2), ("pin", 2),
    ("release", 2), ("alloc", 9), ("release", 1), ("unpin", 1),
    ("release", 1), ("unpin", 2), ("release", 2), ("release", 2),
    ("retain", 7), ("pin", 0), ("alloc", 4), ("release", 3),
    ("unpin", 3), ("alloc", 0), ("alloc", -1), ("verify",),
]


def test_same_sequence_same_state():
    ref, port = RefPool(8, 4), KVPagePool(8, 4)
    for op in SEQUENCE:
        assert _apply(port, *op) == _apply(ref, *op), op
        assert _state(port) == _state(ref), op
    assert port.occupancy == ref.occupancy
    assert [port.shared(p) for p in range(1, 9)] == \
        [ref.shared(p) for p in range(1, 9)]


def test_construction_errors_match():
    for args in [(0, 4), (4, 0)]:
        with pytest.raises(ValueError) as want:
            RefPool(*args)
        with pytest.raises(ValueError) as got:
            KVPagePool(*args)
        assert str(got.value) == str(want.value)
