"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test skips without one.

This file imports neither JAX nor ``veles_tpu``, so it also runs where
JAX is not installed (the card's machine), without the suite's
conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: fp32 outputs are O(1) and the kernel sums up to 16384 keys
in another order than the plain version (~1e-7 apart on the card), so
max abs error <= 1e-4; the prefill install is a row copy, bit-equal.
The fused SGD kernel (one launch for a list of up to 48 tensors) is
held within 1 ulp per element of its plain version (the plain version forms each fused multiply-add in float64 and
rounds once, which can differ from the hardware fma only on a rare
double-rounding tie).  The LRN kernels sum each window in the plain
version's order, and differ from it only where CUDA's powf and PyTorch's
pow round differently: forward rtol/atol 2e-6, backward rtol 3e-5 /
atol 3e-6 (the reference's Pallas-vs-XLA tolerances).  Dropout and the
Bernoulli draw are bit-equal to their plain versions, and a seeded RBM
sample run repeats bit for bit.  The flash kernels (3xTF32 on the
tensor cores) and the split-KV decode and prefill repeat bit for bit
from launch to launch, and the flash kernels' error against an fp64 plain version is at
most 4x the fp32 plain version's.  The record loader's device
minibatches (two pinned staging buffers, prefetch on and off) equal its
host gather bit for bit, also with every copy held back behind a spin.
Two seeded training runs of a residual net end with bit-equal weights.
The device-operand entries of the fused SGD and dropout kernels,
captured in a CUDA graph and replayed with new operands, equal the
by-value entries bit for bit, and the epoch scan's captured train step
equals the eager step with host operands over an epoch whose last
minibatch is short.  The rolling-cache decode's every step's logits lie
within 1e-4 of a teacher-forced plain forward.  A narrow LRN net's
exported artifact, loaded on the card, equals its eval forward within
1e-6 and launches the LRN kernel once a predict; its native bundle, run
by the libtorch runner, lies within 1e-5 of that and launches it once.
On a card workflow, ``Weights2D``'s spec is a numpy array bit-equal to
the committed first-layer weights copied to the host.  The engine's
fused K-step decode, captured as a CUDA graph, launches the decode
kernel once a layer an iteration a replay, repeats bit for bit and
equals the same body run eagerly (greedy, and sampling: the draw kernel
once an iteration); a body that reads a value on the host makes the
engine's start raise.  The seeded token draw's tokens equal its plain
version's on the same card inputs (a token may differ only where the
plain version's two best perturbed scores lie within 1e-5), and a
second launch is bit-equal.  A traced engine (per tick, scan, while)
serves an untraced one's tokens with its launches, its span trees
sound, one ledger dispatch a step or replay, and every prompt chunk's
span closed after the chunk's CUDA event completed.  With the
lock-order witness and the transfer guard armed (each test arms them
itself), every decode path (per tick, ``spec_k``, scan, while) serves
the unarmed run's tokens with its kernel 5/6 launches, no violation, and
the sync debug mode back to default after ``stop()``; a decode dispatch
that reads a card value with ``.item()``, or uploads with a blocking
``torch.as_tensor(..., device=)``, fails its request with the sync error
and the engine serves the next.  Two engine replicas on the card behind
the router serve one engine's tokens (per tick and scan), with kernel 5
and 6 launches summed over the replicas; with ``retries=2`` and
replica 0 faulting every step, every request is retried onto replica 1
with the same tokens.
"""

import numpy
import pytest
import torch

from veles_tpu_torch.ops import hopper_kernels as HK

ATOL = 1e-4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on one")
    return torch.device("cuda")


def _randn(rng, *shape, dev):
    return torch.as_tensor(rng.randn(*shape).astype(numpy.float32),
                           device=dev)


def _tables(rng, b, m, n_pages, dev):
    return torch.as_tensor(rng.choice(n_pages, (b, m), replace=False)
                           .astype(numpy.int32), device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("h,kv,c,dh,page,window,sinks", [
    (4, 2, 1, 16, 8, None, 0),
    (4, 2, 4, 16, 8, 10, 2),
    (8, 2, 3, 64, 32, None, 0),
    (8, 8, 1, 64, 32, 100, 4),
    (4, 1, 1, 128, 16, None, 0),
    (4, 4, 1, 40, 8, None, 0),         # head_dim not a multiple of 32
])
def test_decode_matches_plain(h, kv, c, dh, page, window, sinks):
    dev = _card()
    rng = numpy.random.RandomState(h * 100 + c * 10 + dh)
    b, m, n_pages = 3, 6, 20
    q = _randn(rng, b, h, c, dh, dev=dev)
    kp = _randn(rng, n_pages, kv, page, dh, dev=dev)
    vp = _randn(rng, n_pages, kv, page, dh, dev=dev)
    ptab = _tables(rng, b, m, n_pages, dev)
    pos = torch.as_tensor([0, page + 1, m * page - c], dtype=torch.int32,
                          device=dev)
    before = HK.paged_flash_decode.launches
    got = HK.paged_flash_decode(q, kp, vp, ptab, pos, window, sinks)
    assert HK.paged_flash_decode.launches == before + 1
    ref = HK.paged_flash_decode_ref(q, kp, vp, ptab, pos, window, sinks)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("h,kv,dh,page,n_hist,window,sinks", [
    (4, 2, 16, 8, 0, None, 0),
    (4, 2, 16, 8, 3, 20, 2),
    (8, 8, 64, 32, 15, None, 0),
    (8, 2, 64, 32, 5, 100, 4),
])
def test_prefill_matches_plain_and_installs(h, kv, dh, page, n_hist,
                                            window, sinks):
    dev = _card()
    rng = numpy.random.RandomState(n_hist * 10 + dh)
    b, m, n_pages = 2, 16, 40
    q = _randn(rng, b, h, page, dh, dev=dev)
    kn = _randn(rng, b, kv, page, dh, dev=dev)
    vn = _randn(rng, b, kv, page, dh, dev=dev)
    kp = _randn(rng, n_pages, kv, page, dh, dev=dev)
    vp = _randn(rng, n_pages, kv, page, dh, dev=dev)
    ptab = _tables(rng, b, m, n_pages, dev)
    pos = torch.as_tensor([n_hist * page, 0], dtype=torch.int32,
                          device=dev)
    kr, vr = kp.clone(), vp.clone()
    before = HK.paged_flash_prefill.launches
    got, k_out, _ = HK.paged_flash_prefill(q, kn, vn, kp, vp, ptab, pos,
                                           window, sinks)
    assert k_out is kp
    assert HK.paged_flash_prefill.launches == before + 1
    ref, _, _ = HK.paged_flash_prefill_ref(q, kn, vn, kr, vr, ptab, pos,
                                           window, sinks)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= ATOL
    assert torch.equal(kp, kr) and torch.equal(vp, vr)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,h,kv,c,dh,page,m,window,sinks", [
    ("decode", 8, 8, 1, 128, 32, 512, None, 0),     # 16384-token view
    ("decode", 8, 2, 4, 64, 32, 400, 3000, 4),
    ("decode", 4, 2, 1, 18, 8, 40, None, 0),        # head_dim % 4 != 0
    ("decode", 4, 4, 1, 320, 64, 8, None, 0),       # two feature blocks
    ("prefill", 8, 2, 128, 128, 128, 64, None, 0),  # page above 32
    ("prefill", 4, 4, 32, 128, 32, 512, 5000, 2),   # 16384-token view
    ("decode", 8, 2, 1, 256, 16, 64, None, 0),      # > 48 KB shared
    ("prefill", 4, 2, 16, 320, 16, 32, 40, 1),      # feature blocks
])
def test_any_table_width_and_head_dim(kernel, h, kv, c, dh, page, m,
                                      window, sinks):
    """Nothing in a kernel block grows with the table: long tables, odd
    and wide heads and large pages all match the plain versions."""
    dev = _card()
    rng = numpy.random.RandomState(m + dh)
    b = 2
    n_pages = b * m + 1
    kp = _randn(rng, n_pages, kv, page, dh, dev=dev)
    vp = _randn(rng, n_pages, kv, page, dh, dev=dev)
    ptab = _tables(rng, b, m, n_pages, dev)
    q = _randn(rng, b, h, c, dh, dev=dev)
    if kernel == "decode":
        pos = torch.as_tensor([m * page - c, (m // 2) * page + 3],
                              dtype=torch.int32, device=dev)
        got = HK.paged_flash_decode(q, kp, vp, ptab, pos, window, sinks)
        ref = HK.paged_flash_decode_ref(q, kp, vp, ptab, pos, window, sinks)
    else:
        kn = _randn(rng, b, kv, c, dh, dev=dev)
        vn = _randn(rng, b, kv, c, dh, dev=dev)
        pos = torch.as_tensor([(m - 1) * page, (m // 2) * page],
                              dtype=torch.int32, device=dev)
        kr, vr = kp.clone(), vp.clone()
        got, _, _ = HK.paged_flash_prefill(q, kn, vn, kp, vp, ptab, pos,
                                           window, sinks)
        ref, _, _ = HK.paged_flash_prefill_ref(q, kn, vn, kr, vr, ptab,
                                               pos, window, sinks)
        assert torch.equal(kp, kr) and torch.equal(vp, vr)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,c,dh,page,m,window,sinks,shallow", [
    (8, 8, 8, 1, 64, 32, 512, None, 0, True),   # every split but one empty
    (8, 8, 8, 1, 64, 32, 512, 256, 4, False),   # middle splits empty
    (4, 8, 2, 4, 128, 16, 300, 700, 3, False),
    (2, 4, 2, 3, 40, 8, 17, None, 0, True),
])
def test_decode_split_edges_and_repeat(b, h, kv, c, dh, page, m, window,
                                       sinks, shallow):
    """The split-KV decode over ranges whose pages are all dead matches
    the plain version, and repeats bit for bit (the splits meet in a
    fixed order)."""
    dev = _card()
    rng = numpy.random.RandomState(m + c)
    n_pages = b * m + 1
    q = _randn(rng, b, h, c, dh, dev=dev)
    kp = _randn(rng, n_pages, kv, page, dh, dev=dev)
    vp = _randn(rng, n_pages, kv, page, dh, dev=dev)
    ptab = _tables(rng, b, m, n_pages, dev)
    top = page - c + 1 if shallow else m * page - c + 1
    pos = torch.as_tensor(rng.randint(top - min(top, 40), top, b)
                          .astype(numpy.int32), device=dev)
    assert HK.decode_splits(b, h, kv, c, dh, m) > 1
    got = HK.paged_flash_decode(q, kp, vp, ptab, pos, window, sinks)
    again = HK.paged_flash_decode(q, kp, vp, ptab, pos, window, sinks)
    ref = HK.paged_flash_decode_ref(q, kp, vp, ptab, pos, window, sinks)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= ATOL
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,dh,page,m,n_hist,window,sinks", [
    (1, 8, 8, 64, 32, 16, 0, None, 0),      # the serving shape, first chunk
    (1, 8, 8, 64, 32, 16, 1, None, 0),
    (1, 8, 8, 64, 32, 16, 15, None, 0),     # every split one live page
    (2, 8, 2, 128, 32, 512, 400, None, 0),  # 16384-token view, GQA
    (2, 4, 2, 18, 8, 40, 23, None, 0),      # head_dim % 4 != 0
    (1, 4, 4, 320, 64, 8, 5, None, 0),      # feature blocks, page 64
    (2, 8, 2, 128, 8, 64, 50, 100, 4),      # window + sinks: middle dead
    (1, 8, 2, 64, 64, 40, 30, 300, 2),
])
def test_prefill_split_edges_and_repeat(b, h, kv, dh, page, m, n_hist,
                                        window, sinks):
    """The split-KV prefill over ranges whose pages are all dead (no
    history, a window with sinks) matches the plain version, installs
    the chunk bit for bit, and repeats bit for bit (the splits meet in a
    fixed order)."""
    dev = _card()
    rng = numpy.random.RandomState(n_hist * 7 + dh + page)
    n_pages = b * m + 1
    q = _randn(rng, b, h, page, dh, dev=dev)
    kn = _randn(rng, b, kv, page, dh, dev=dev)
    vn = _randn(rng, b, kv, page, dh, dev=dev)
    kp = _randn(rng, n_pages, kv, page, dh, dev=dev)
    vp = _randn(rng, n_pages, kv, page, dh, dev=dev)
    ptab = _tables(rng, b, m, n_pages, dev)
    pos = torch.as_tensor([n_hist * page] + [(n_hist // 2) * page] * (b - 1),
                          dtype=torch.int32, device=dev)
    kr, vr = kp.clone(), vp.clone()
    got, _, _ = HK.paged_flash_prefill(q, kn, vn, kp, vp, ptab, pos, window,
                                       sinks)
    again, _, _ = HK.paged_flash_prefill(q, kn, vn, kp, vp, ptab, pos,
                                         window, sinks)
    ref, _, _ = HK.paged_flash_prefill_ref(q, kn, vn, kr, vr, ptab, pos,
                                           window, sinks)
    torch.cuda.synchronize()
    assert HK.prefill_splits(b, h, kv, page, dh, m) >= 1
    assert (got - ref).abs().max().item() <= ATOL
    assert torch.equal(got, again)
    assert torch.equal(kp, kr) and torch.equal(vp, vr)


@pytest.mark.cuda
def test_prefill_serving_shape_splits():
    """At the serving shape (one lane, 8 kv heads, 32 rows, 16 pages) the
    walk is cut into one range a page: 128 blocks for 132 SMs."""
    _card()
    assert HK.prefill_splits(1, 8, 8, 32, 64, 16) == 16


@pytest.mark.cuda
def test_decode_makes_no_host_sync():
    """pos stays on the card: the wrapper (split count, workspace, both
    launches) never waits for the card."""
    dev = _card()
    rng = numpy.random.RandomState(3)
    q = _randn(rng, 8, 8, 1, 64, dev=dev)
    kp = _randn(rng, 129, 8, 32, 64, dev=dev)
    vp = _randn(rng, 129, 8, 32, 64, dev=dev)
    ptab = _tables(rng, 8, 16, 129, dev)
    pos = torch.full((8,), 500, dtype=torch.int32, device=dev)
    HK.paged_flash_decode(q, kp, vp, ptab, pos)      # builds the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = HK.paged_flash_decode(q, kp, vp, ptab, pos)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ref = HK.paged_flash_decode_ref(q, kp, vp, ptab, pos)
    assert (got - ref).abs().max().item() <= ATOL


@pytest.mark.cuda
def test_wrappers_reject_bad_operands():
    dev = _card()
    q = torch.zeros(1, 2, 1, 16, device=dev)
    pool = torch.zeros(3, 2, 8, 16, device=dev)
    ptab = torch.zeros(1, 2, dtype=torch.int32, device=dev)
    pos = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="int32"):
        HK.paged_flash_decode(q, pool, pool, ptab.long(), pos)
    with pytest.raises(TypeError, match="float32"):
        HK.paged_flash_decode(q.double(), pool.double(), pool.double(),
                              ptab, pos)
    with pytest.raises(ValueError, match="contiguous"):
        HK.paged_flash_decode(torch.zeros(1, 2, 1, 32, device=dev)[..., ::2],
                              pool, pool, ptab, pos)
    with pytest.raises(ValueError, match="several devices"):
        HK.paged_flash_decode(q, pool, pool, ptab.cpu(), pos)


def _sgd_operands(rng, shape, dev, offset=0):
    """p, v, g of ``shape`` on the card; ``offset`` > 0 starts each one
    ``offset`` floats into a buffer, so the pointers lose 16-byte
    alignment and the kernel takes its scalar path."""
    n = int(numpy.prod(shape))

    def one(scale, uniform=False):
        data = (rng.uniform(-scale, scale, n) if uniform
                else rng.randn(n) * scale).astype(numpy.float32)
        buf = torch.empty(n + offset, device=dev)
        buf[offset:] = torch.as_tensor(data, device=dev)
        return buf[offset:].view(shape)

    return one(0.3, uniform=True), one(0.01), one(5.0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,wd,l1,clip,offset", [
    ((784, 100), 0.0, 0.0, None, 0),       # MNIST-FC's four parameters
    ((100,), 0.0, 0.0, None, 0),
    ((100, 10), 0.0, 0.0, None, 0),
    ((10,), 0.0, 0.0, None, 0),
    ((4096, 4096), 0.0, 0.0, None, 0),     # AlexNet's fc weights
    ((1,), 0.0, 0.0, None, 0),
    ((127,), 0.0005, 0.3, None, 0),
    ((129,), 0.0005, 1.0, None, 0),
    ((784, 100), 0.0005, 0.3, None, 0),
    ((784, 100), 0.0005, 0.3, 0.05, 0),
    ((129,), 0.0, 0.0, 0.05, 0),
    ((1001,), 0.0005, 0.3, None, 1),       # unaligned: scalar path
])
def test_fused_sgd_matches_plain(shape, wd, l1, clip, offset):
    dev = _card()
    rng = numpy.random.RandomState(int(numpy.prod(shape)) % 1000 + offset)
    p, v, g = _sgd_operands(rng, shape, dev, offset)
    p0, v0 = p.clone(), v.clone()
    before = HK.fused_sgd_update.launches
    got_p, got_v = HK.fused_sgd_update(p, v, g, 100, 0.03, 0.9, wd, l1, clip)
    assert HK.fused_sgd_update.launches == before + 1
    ref_p, ref_v = HK.fused_sgd_update_ref(p, v, g, 100, 0.03, 0.9, wd, l1,
                                           clip)
    torch.cuda.synchronize()
    assert torch.equal(p, p0) and torch.equal(v, v0)      # out of place
    for got, ref in ((got_p, ref_p), (got_v, ref_v)):
        ulp = torch.as_tensor(numpy.spacing(numpy.abs(ref.cpu().numpy())),
                              device=dev)
        assert ((got - ref).abs() / ulp).max().item() <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("count,offsets", [
    (4, (0, 0, 0, 0)),            # MNIST-FC's four tensors
    (4, (0, 1, 0, 3)),            # two tensors unaligned: scalar path
    (50, None),                   # more than one launch's table
])
def test_fused_sgd_multi_matches_plain(count, offsets):
    """One launch updates every tensor of the list (two when it is
    longer than SGD_MAX_TENSORS), each with its own scalars, each within
    1 ulp of the plain version."""
    dev = _card()
    rng = numpy.random.RandomState(count)
    shapes = [(784, 100), (100,), (100, 10), (10,)] if count == 4 else [
        (int(rng.randint(1, 3000)),) for _ in range(count)]
    offsets = offsets or [int(o) for o in rng.randint(0, 4, count)]
    ops = [_sgd_operands(rng, shape, dev, off)
           for shape, off in zip(shapes, offsets)]
    scalars = [(100, 0.03 if k % 2 == 0 else 0.05, 0.9,
                0.0005 * (k % 3), 0.3 * (k % 2), 0.05 if k % 5 == 4 else None)
               for k in range(count)]
    ps, vs, gs = (list(x) for x in zip(*ops))
    before = HK.fused_sgd_update.launches
    got_p, got_v = HK.fused_sgd_update_multi(ps, vs, gs, scalars)
    launches = -(-count // HK.SGD_MAX_TENSORS)
    assert HK.fused_sgd_update.launches == before + launches
    ref_p, ref_v = HK.fused_sgd_update_multi_ref(ps, vs, gs, scalars)
    torch.cuda.synchronize()
    for got, ref in zip(got_p + got_v, ref_p + ref_v):
        ulp = torch.as_tensor(numpy.spacing(numpy.abs(ref.cpu().numpy())),
                              device=dev)
        assert ((got - ref).abs() / ulp).max().item() <= 1.0
    again_p, again_v = HK.fused_sgd_update_multi(ps, vs, gs, scalars)
    assert all(torch.equal(a, b) for a, b in zip(again_p + again_v,
                                                 got_p + got_v))


@pytest.mark.cuda
def test_fused_sgd_rejects_bad_operands():
    dev = _card()
    p = torch.zeros(64, device=dev)
    with pytest.raises(TypeError, match="float32"):
        HK.fused_sgd_update(p.double(), p.double(), p.double(), 1, 0.1, 0.9)
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.zeros(128, device=dev)[::2]
        HK.fused_sgd_update(wide, wide, wide, 1, 0.1, 0.9)
    with pytest.raises(ValueError, match="several devices"):
        HK.fused_sgd_update(p, p.cpu(), p, 1, 0.1, 0.9)


def _lrn_operands(shape, n, offset, dev):
    """x (rms 3) and dy (rms 1) of ``shape``; with ``offset`` > 0 each
    starts that many floats into its buffer (16-byte alignment lost)."""
    rng = numpy.random.RandomState(shape[-1] + n)

    def place(t):
        buf = torch.empty(t.numel() + offset, device=dev)
        buf[offset:] = t.reshape(-1)
        return buf[offset:].view(shape)

    return (place(_randn(rng, *shape, dev=dev) * 3.0),
            place(_randn(rng, *shape, dev=dev)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n,offset", [
    ((2, 55, 55, 96), 5, 0),      # AlexNet LRN1's channels
    ((2, 27, 27, 256), 5, 0),     # LRN2's
    ((3, 5, 5, 200), 4, 0),       # even window: asymmetric
    ((7, 16), 5, 0),
    ((2, 3, 3000), 5, 0),         # one row per tile
    ((1, 24), 1, 0),
    ((2, 27, 27, 256), 5, 1),     # pointers 4 bytes off: 4-byte copies
    ((4, 9, 9, 98), 5, 0),        # C % 4 != 0: the scalar instance
    ((3, 5, 5, 96), 7, 0),        # the runtime-n instance
    ((5, 7, 3), 5, 0),            # n > C
    ((7, 13, 17, 96), 5, 0),      # a partial last tile
    ((3, 12000), 5, 0),           # backward rows too wide for the ring
    ((2, 30000), 3, 0),           # forward rows too wide for the ring
])
def test_lrn_matches_plain(shape, n, offset):
    dev = _card()
    x, dy = _lrn_operands(shape, n, offset, dev)
    before = (HK.lrn_forward.launches, HK.lrn_backward.launches)
    y, d = HK.lrn_forward(x, 1e-4, 0.75, n, 2.0)
    dx = HK.lrn_backward(x, d, dy, 1e-4, 0.75, n)
    assert (HK.lrn_forward.launches, HK.lrn_backward.launches) == (
        before[0] + 1, before[1] + 1)
    y_ref, d_ref = HK.lrn_forward_ref(x, 1e-4, 0.75, n, 2.0)
    dx_ref = HK.lrn_backward_ref(x, d_ref, dy, 1e-4, 0.75, n)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_ref, rtol=2e-6, atol=2e-6)
    torch.testing.assert_close(d, d_ref, rtol=2e-6, atol=2e-6)
    torch.testing.assert_close(dx, dx_ref, rtol=3e-5, atol=3e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n,offset", [
    ((2, 55, 55, 96), 5, 0), ((2, 27, 27, 256), 5, 1), ((4, 9, 9, 98), 7, 0),
])
def test_lrn_repeats_bit_equal(shape, n, offset):
    dev = _card()
    x, dy = _lrn_operands(shape, n, offset, dev)
    y, d = HK.lrn_forward(x, 1e-4, 0.75, n, 2.0)
    y2, d2 = HK.lrn_forward(x, 1e-4, 0.75, n, 2.0)
    dx = HK.lrn_backward(x, d, dy, 1e-4, 0.75, n)
    dx2 = HK.lrn_backward(x, d, dy, 1e-4, 0.75, n)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(d, d2) and torch.equal(dx, dx2)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,c,n,vec,backward,want", [
    (387200, 96, 5, True, False, (4, 5, 0)),    # AlexNet LRN1
    (93312, 256, 5, True, True, (4, 5, 0)),     # LRN2
    (93312, 256, 5, False, True, (1, 5, 0)),    # an unaligned pointer
    (324, 98, 5, True, False, (1, 5, 0)),       # C % 4 != 0
    (75, 96, 7, True, True, (4, 0, 0)),         # runtime n
    (3, 12000, 5, True, False, (4, 5, 0)),      # forward: still the ring
    (3, 12000, 5, True, True, (4, 0, 1)),       # backward: too wide
    (2, 30000, 3, True, False, (4, 0, 1)),
])
def test_lrn_plan_paths(rows, c, n, vec, backward, want):
    _card()
    plan = HK.lrn_plan(rows, c, n, vec, backward)
    assert (plan["width"], plan["template_n"], plan["wide"]) == want
    if not plan["wide"]:
        tiles = -(-rows // plan["rows_per_tile"])
        assert plan["stages"] >= 2 and 1 <= plan["blocks"] <= tiles
        assert plan["smem"] <= 227 * 1024


@pytest.mark.cuda
def test_lrn_autograd_uses_both_kernels():
    dev = _card()
    rng = numpy.random.RandomState(3)
    x = _randn(rng, 2, 4, 4, 32, dev=dev).requires_grad_()
    before = HK.lrn_backward.launches
    HK.LRN.apply(x, 2e-4, 0.7, 5, 1.5).sum().backward()
    assert HK.lrn_backward.launches == before + 1
    y, d = HK.lrn_forward_ref(x.detach(), 2e-4, 0.7, 5, 1.5)
    ref = HK.lrn_backward_ref(x.detach(), d, torch.ones_like(y), 2e-4,
                              0.7, 5)
    torch.testing.assert_close(x.grad, ref, rtol=3e-5, atol=3e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,rate,seed", [
    ((128, 9216), 0.5, 1),        # AlexNet's dropout inputs
    ((128, 4096), 0.5, 2),
    ((1,), 0.5, 3),
    ((127,), 0.3, 4),
    ((2 ** 16 + 3,), 0.7, 2 ** 40 + 5),
])
def test_dropout_bit_equal_to_plain(shape, rate, seed):
    dev = _card()
    from veles_tpu_torch import prng
    x = _randn(numpy.random.RandomState(seed % 1000), *shape, dev=dev)
    key = prng.fold_in(prng.PRNGKey(seed), 7)
    before = HK.dropout.launches
    got = HK.dropout(x, key, rate)
    assert HK.dropout.launches == before + 1
    ref = HK.dropout_ref(x, key, rate)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert torch.equal(HK.dropout(x, seed, rate),
                       HK.dropout_ref(x, seed, rate))
    kept = (got != 0).float().mean().item()
    if x.numel() > 1000:
        assert abs(kept - (1.0 - rate)) < 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("rows,features,ranks", [(64, 9216, 2), (64, 4096, 2),
                                                 (3, 127, 4)])
def test_dropout_offset_rows_equal_the_global_kernel(rows, features, ranks):
    """A data rank's dropout (its rows, element offset rank·rows·f)
    equals its rows of the global kernel's output and of the plain
    version with the offset, by value and through the key on the
    card."""
    dev = _card()
    from veles_tpu_torch import prng
    x = _randn(numpy.random.RandomState(rows), ranks * rows, features,
               dev=dev)
    key = prng.fold_in(prng.PRNGKey(features), 3)
    whole = HK.dropout(x, key, 0.5)
    on_card = torch.as_tensor(key.view(numpy.int32)).to(dev)
    for r in range(ranks):
        part = x[r * rows:(r + 1) * rows].contiguous()
        offset = r * rows * features
        before = HK.dropout.launches
        got = HK.dropout(part, key, 0.5, offset=offset)
        dev_got = HK.dropout(part, on_card, 0.5, offset=offset)
        assert HK.dropout.launches == before + 2
        want = whole[r * rows:(r + 1) * rows]
        assert torch.equal(got, want) and torch.equal(dev_got, want)
        assert torch.equal(got, HK.dropout_ref(part, key, 0.5, offset))


def _probabilities(rng, shape, exact, dev):
    p = rng.rand(*shape).astype(numpy.float32)
    if exact:
        flat = p.reshape(-1)
        flat[::3] = 0.0
        flat[1::3] = 1.0
    return torch.as_tensor(p, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(100, 784), (100, 256), (1,), (127,),
                                   (2 ** 16 + 3,)])
@pytest.mark.parametrize("exact", [False, True])
def test_bernoulli_bit_equal_to_plain(shape, exact):
    dev = _card()
    from veles_tpu_torch import prng
    p = _probabilities(numpy.random.RandomState(shape[0]), shape, exact, dev)
    key = prng.fold_in(prng.PRNGKey(shape[0]), 0xB1)
    before = HK.bernoulli.launches
    got = HK.bernoulli(key, p)
    assert HK.bernoulli.launches == before + 1
    ref = HK.bernoulli_ref(key, p)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.equal(got, ref)
    assert torch.equal(HK.bernoulli(key, p), got)
    if exact:
        flat = got.reshape(-1)
        assert not flat[::3].any() and bool(flat[1::3].all())


@pytest.mark.cuda
def test_rbm_sample_launches_two_draws_a_step_and_repeats():
    _card()
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples import mnist_rbm
    runs = []
    for _ in range(2):
        prng.reset()
        prng.seed_all(5)
        root.__dict__.pop("mnist_rbm", None)
        root.mnist_rbm.update({
            "loader": {"minibatch_size": 50, "n_train": 230,
                       "n_valid": 100},
            "trainer": {"n_hidden": 64}, "decision": {"max_epochs": 2}})
        before = HK.bernoulli.launches
        wf = mnist_rbm.train()
        root.__dict__.pop("mnist_rbm", None)
        assert wf.trainer.time == 10
        assert HK.bernoulli.launches - before == 2 * 10
        runs.append([getattr(wf.trainer, k).mem.copy()
                     for k in ("weights", "vbias", "hbias")])
    for a, b in zip(*runs):
        assert numpy.array_equal(a, b)


def _sample_operands(rows, vocab, mode, dev, seed=0):
    """Logits (rows, vocab) with a few exact ties, and the key (and the
    engine mode's per-row seeds and positions) of one draw."""
    from veles_tpu_torch import prng
    rng = numpy.random.RandomState(seed)
    lg = (rng.randn(rows, vocab) * 3).astype(numpy.float32)
    lg[:, 1::7] = lg[:, :1]             # ties, at the top-k cutoff too
    lg = torch.as_tensor(lg, device=dev)
    if mode == "key":
        return lg, prng.fold_in(prng.PRNGKey(seed), 0x5A), None, None
    base = prng.RandomGenerator("lm-sample", 123).base_key()
    seeds = torch.as_tensor(rng.randint(1, 1000, rows).astype(numpy.int32),
                            device=dev)
    pos = torch.as_tensor(rng.randint(0, 512, rows).astype(numpy.int32),
                          device=dev)
    return lg, base, seeds, pos


@pytest.mark.cuda
@pytest.mark.parametrize("rows,vocab", [(8, 256), (40, 256), (3, 1000),
                                        (5, 37)])
@pytest.mark.parametrize("top_k", [0, 40])
@pytest.mark.parametrize("mode", ["key", "seeded"])
def test_sample_token_equals_plain(rows, vocab, top_k, mode, monkeypatch):
    """The draw kernel's tokens equal its plain version's on the same
    card inputs (a token may differ only where the plain version's two
    best perturbed scores lie within 1e-5: there are none here), a
    second launch is bit-equal, and a CUDA tensor never reaches the
    plain version."""
    dev = _card()
    top_k = min(top_k, vocab)
    lg, key, seeds, pos = _sample_operands(rows, vocab, mode, dev,
                                           seed=rows + vocab)
    scores = HK.sample_scores_ref(lg, 0.8, key, top_k, seeds, pos)
    ref = HK.sample_token_ref(lg, 0.8, key, top_k, seeds, pos)

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(HK, "sample_token_ref", refuse)
    monkeypatch.setattr(HK, "sample_scores_ref", refuse)
    before = HK.sample_token.launches
    got = HK.sample_token(lg, 0.8, key, top_k, seeds, pos)
    again = HK.sample_token(lg, 0.8, key, top_k, seeds, pos)
    assert HK.sample_token.launches == before + 2
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (rows,)
    assert torch.equal(got, again)
    top2 = scores.topk(2, dim=-1).values
    near = (top2[:, 0] - top2[:, 1]) <= 1e-5
    differ = got != ref
    assert not bool((differ & ~near).any()), (got, ref)
    assert int(differ.sum()) == 0
    if top_k:
        cut = torch.topk(lg, top_k, dim=-1).values[:, -1]
        assert bool((lg.gather(1, got.long()[:, None])[:, 0] >= cut).all())


@pytest.mark.cuda
def test_sample_token_rejects_bad_operands():
    dev = _card()
    lg = torch.zeros(4, 16, device=dev)
    seeds = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="float32"):
        HK.sample_token(lg.double(), 1.0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        HK.sample_token(torch.zeros(4, 32, device=dev)[:, ::2], 1.0, 1)
    with pytest.raises(ValueError, match="int32"):
        HK.sample_token(lg, 1.0, 1, seeds=seeds.long(), positions=seeds)
    with pytest.raises(ValueError, match="together"):
        HK.sample_token(lg, 1.0, 1, seeds=seeds)
    with pytest.raises(ValueError, match="several devices"):
        HK.sample_token(lg, 1.0, 1, seeds=seeds.cpu(), positions=seeds)
    with pytest.raises(ValueError, match="temperature"):
        HK.sample_token(lg, 0.0, 1)
    with pytest.raises(ValueError, match="top_k"):
        HK.sample_token(lg, 1.0, 1, top_k=17)


@pytest.mark.cuda
def test_lrn_and_dropout_reject_bad_operands():
    dev = _card()
    x = torch.zeros(2, 3, 8, device=dev)
    with pytest.raises(TypeError, match="float32"):
        HK.lrn_forward(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        HK.lrn_forward(torch.zeros(2, 3, 16, device=dev)[..., ::2])
    with pytest.raises(ValueError, match="several devices"):
        HK.lrn_backward(x, x.cpu(), x)
    with pytest.raises(TypeError, match="float32"):
        HK.dropout(x.double(), 1, 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        HK.dropout(torch.zeros(4, 8, device=dev)[:, ::2], 1, 0.5)
    with pytest.raises(TypeError, match="float32"):
        HK.bernoulli(1, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        HK.bernoulli(1, torch.zeros(4, 8, device=dev)[:, ::2])


def _flash_operands(rng, b, h, sq, sk, dh, dev, peak=1.0):
    q = _randn(rng, b, h, sq, dh, dev=dev) * peak
    k = _randn(rng, b, h, sk, dh, dev=dev)
    v = _randn(rng, b, h, sk, dh, dev=dev)
    do = _randn(rng, b, h, sq, dh, dev=dev)
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,sq,sk,dh,causal", [
    (2, 3, 128, 128, 64, True),
    (2, 3, 200, 200, 40, True),      # ragged tail; dh % 32 != 0
    (2, 3, 200, 200, 40, False),
    (1, 2, 200, 200, 32, False),
    (1, 2, 77, 77, 128, True),       # two head-dim chunks
    (1, 1, 33, 33, 200, False),      # four chunks, the last ragged
    (1, 2, 64, 150, 16, False),      # more keys than queries
    (2, 2, 100, 130, 16, True),
    (1, 1, 1, 1, 8, True),
    (2, 4, 200, 200, 37, False),     # rows not 16-byte aligned: 4-byte copies
    (1, 2, 150, 70, 64, False),      # more queries than keys, both ragged
])
def test_flash_attention_matches_plain(b, h, sq, sk, dh, causal):
    """Kernels 7a, 7b, 7c against their plain versions.  Both backward
    kernels take the plain forward's o and lse, so each is held alone."""
    dev = _card()
    rng = numpy.random.RandomState(sq + dh)
    q, k, v, do = _flash_operands(rng, b, h, sq, sk, dh, dev)
    before = [HK.flash_attention_fwd.launches,
              HK.flash_attention_bwd_dkv.launches,
              HK.flash_attention_bwd_dq.launches]
    o, lse = HK.flash_attention_fwd(q, k, v, causal)
    o_ref, lse_ref = HK.flash_attention_ref(q, k, v, causal)
    dk, dv = HK.flash_attention_bwd_dkv(q, k, v, o_ref, lse_ref, do, causal)
    dq = HK.flash_attention_bwd_dq(q, k, v, o_ref, lse_ref, do, causal)
    ref = HK.flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, causal)
    torch.cuda.synchronize()
    assert [HK.flash_attention_fwd.launches,
            HK.flash_attention_bwd_dkv.launches,
            HK.flash_attention_bwd_dq.launches] == [n + 1 for n in before]
    for got, want in zip((o, lse, dq, dk, dv), (o_ref, lse_ref) + ref):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= ATOL


@pytest.mark.cuda
def test_flash_attention_peaked_scores():
    """Scores reaching ±100 (a nearly one-hot softmax): the running max
    and the residual keep every exp in range.  An fp32 score of 100
    carries 8e-6 of roundoff, which moves each probability by that
    share, so the limit scales with each output's largest value."""
    dev = _card()
    q, k, v, do = _flash_operands(numpy.random.RandomState(9), 1, 2, 96, 96,
                                  64, dev)
    q = q * (100.0 / (torch.matmul(q, k.transpose(-1, -2)) / 8.0).abs().max())
    o, lse = HK.flash_attention_fwd(q, k, v, True)
    o_ref, lse_ref = HK.flash_attention_ref(q, k, v, True)
    ref = HK.flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, True)
    dk, dv = HK.flash_attention_bwd_dkv(q, k, v, o_ref, lse_ref, do, True)
    dq = HK.flash_attention_bwd_dq(q, k, v, o_ref, lse_ref, do, True)
    torch.cuda.synchronize()
    for got, want in zip((o, lse, dq, dk, dv), (o_ref, lse_ref) + ref):
        assert torch.isfinite(got).all()
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= 1e-4 * max(scale, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,dh,causal", [(256, 256, 64, True),
                                             (200, 200, 37, False),
                                             (77, 130, 128, False)])
def test_flash_backward_repeats_bit_for_bit(sq, sk, dh, causal):
    """Two passes with no atomics: a second launch on the same inputs
    gives the same bits."""
    dev = _card()
    q, k, v, do = _flash_operands(numpy.random.RandomState(sq + dh), 2, 3,
                                  sq, sk, dh, dev)
    o, lse = HK.flash_attention_ref(q, k, v, causal)
    di = HK.flash_attention_di(o, do)
    first = (HK.flash_attention_bwd_dkv(q, k, v, o, lse, do, causal, di=di)
             + (HK.flash_attention_bwd_dq(q, k, v, o, lse, do, causal,
                                          di=di),))
    second = (HK.flash_attention_bwd_dkv(q, k, v, o, lse, do, causal, di=di)
              + (HK.flash_attention_bwd_dq(q, k, v, o, lse, do, causal,
                                           di=di),))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,dh,causal", [(512, 512, 64, True),
                                             (200, 200, 37, False),
                                             (96, 160, 128, True)])
def test_flash_backward_fp32_accurate(sq, sk, dh, causal):
    """Against an fp64 plain version on the same inputs, each backward
    kernel's max abs error is at most 4x the fp32 plain version's: the
    3xTF32 products keep fp32 accuracy (one TF32 product would not)."""
    dev = _card()
    q, k, v, do = _flash_operands(numpy.random.RandomState(dh), 2, 4, sq,
                                  sk, dh, dev)
    o, lse = HK.flash_attention_ref(q, k, v, causal)
    inputs = (q, k, v, o, lse, do)
    dk, dv = HK.flash_attention_bwd_dkv(*inputs, causal)
    dq = HK.flash_attention_bwd_dq(*inputs, causal)
    plain = HK.flash_attention_bwd_ref(*inputs, causal)
    exact = HK.flash_attention_bwd_ref(*(t.double() for t in inputs), causal)
    torch.cuda.synchronize()
    for got, fp32, want in zip((dq, dk, dv), plain, exact):
        err = (got.double() - want).abs().max().item()
        assert err <= 4.0 * (fp32.double() - want).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,dh,causal", [(512, 512, 64, True),
                                             (200, 200, 37, False),
                                             (96, 160, 128, True),
                                             (130, 70, 200, False)])
def test_flash_forward_fp32_accurate_and_repeats(sq, sk, dh, causal):
    """The forward on the tensor cores: o and lse against an fp64 plain
    version within 4x the fp32 plain version's error, and a second
    launch bit-equal to the first."""
    dev = _card()
    q, k, v, _ = _flash_operands(numpy.random.RandomState(sq + dh), 2, 4,
                                 sq, sk, dh, dev)
    first = HK.flash_attention_fwd(q, k, v, causal)
    second = HK.flash_attention_fwd(q, k, v, causal)
    plain = HK.flash_attention_ref(q, k, v, causal)
    exact = HK.flash_attention_ref(q.double(), k.double(), v.double(),
                                   causal)
    torch.cuda.synchronize()
    for got, again, fp32, want in zip(first, second, plain, exact):
        assert torch.equal(got, again)
        err = (got.double() - want).abs().max().item()
        assert err <= 4.0 * (fp32.double() - want).abs().max().item()


@pytest.mark.cuda
def test_flash_autograd_launches_each_kernel_once():
    dev = _card()
    q, k, v, do = _flash_operands(numpy.random.RandomState(4), 2, 2, 130,
                                  130, 64, dev)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = HK.launch_counts()
    out = HK.FlashAttention.apply(*leaves, True, None)
    grads = torch.autograd.grad(out, leaves, do)
    after = HK.launch_counts()
    for name in ("flash_attention_fwd", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"):
        assert after[name] == before[name] + 1
    o_ref, lse_ref = HK.flash_attention_ref(q, k, v, True)
    ref = HK.flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, True)
    torch.cuda.synchronize()
    assert (out - o_ref).abs().max().item() <= ATOL
    for got, want in zip(grads, ref):
        assert (got - want).abs().max().item() <= ATOL


@pytest.mark.cuda
def test_flash_rejects_bad_operands():
    dev = _card()
    q = torch.zeros(1, 2, 16, 8, device=dev)
    with pytest.raises(TypeError, match="float32"):
        HK.flash_attention_fwd(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="contiguous"):
        HK.flash_attention_fwd(q.transpose(1, 2), q.transpose(1, 2),
                               q.transpose(1, 2))
    with pytest.raises(ValueError, match="several devices"):
        HK.flash_attention_fwd(q, q.cpu(), q)
    lse = torch.zeros(1, 2, 16, device=dev)
    with pytest.raises(ValueError, match="does not match"):
        HK.flash_attention_bwd_dq(q, q, q, q, lse[..., :8], q)


# ------------------------------------------------- the conv zoo (no kernel)
#: deconv and depool on the card vs the CPU: max gap as a share of the
#: largest CPU element (cuDNN, TF32 off, sums in another order)
ZOO_SHARE = 1e-5


def _share(got, want):
    got, want = got.cpu(), want.cpu()
    assert got.shape == want.shape
    return ((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("stride,k,padding,extra", [
    (1, 5, "SAME", 0), (2, 5, "SAME", 0), (2, 3, "VALID", 0),
    (2, 5, 2, 1), (2, 4, (1, 2), 0), (1, 3, 0, 0)])
def test_deconv_backward_card_vs_cpu(stride, k, padding, extra):
    from veles_tpu_torch.ops import functional as F
    dev = _card()
    F.pin_fp32_matmul()
    rng = numpy.random.RandomState(k * 10 + stride)
    x = _randn(rng, 8, 9, 7, 6, dev="cpu")
    w = _randn(rng, k, k, 6, 5, dev="cpu")
    b = _randn(rng, 5, dev="cpu")
    s = (stride, stride)
    outs = []
    for where in (dev, "cpu"):
        xt, wt, bt = (t.to(where) for t in (x, w, b))
        y = F.deconv2d_forward(xt, wt, bt, s, padding, "tanh", extra)
        g = torch.as_tensor(numpy.random.RandomState(1).randn(
            *y.shape).astype(numpy.float32), device=where)
        outs.append((y,) + tuple(F.deconv2d_backward(
            xt, y, g, wt, s, padding, "tanh", extra)))
    torch.cuda.synchronize()
    for got, want in zip(*outs):
        assert _share(got, want) <= ZOO_SHARE


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["nearest", "zero"])
def test_depool_backward_card_vs_cpu(mode):
    from veles_tpu_torch.ops import functional as F
    dev = _card()
    rng = numpy.random.RandomState(5)
    x = _randn(rng, 4, 7, 5, 3, dev="cpu")
    g = _randn(rng, 4, 14, 10, 3, dev="cpu")
    y = F.depool(x.to(dev), (2, 2), mode)
    dx = F.depool_backward(g.to(dev), (2, 2), mode)
    torch.cuda.synchronize()
    assert torch.equal(y.cpu(), F.depool(x, (2, 2), mode))
    assert _share(dx, F.depool_backward(g, (2, 2), mode)) <= ZOO_SHARE


def _residual_workflow():
    """conv -> [conv(s=2) -> conv -> residual_proj(s=2)] -> [conv -> conv
    -> residual] -> softmax, 8 channels, on CIFAR-shaped data."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.samples.cifar import CifarLoader
    from veles_tpu_torch.standard_workflow import StandardWorkflow
    prng.reset()
    prng.seed_all(9)
    conv = {"type": "conv_str", "n_kernels": 8, "kx": 3, "ky": 3,
            "padding": "SAME", "learning_rate": 0.02, "momentum": 0.9}
    return StandardWorkflow(
        None, name="resnet", loader_factory=CifarLoader,
        loader_config={"minibatch_size": 16, "n_train": 32, "n_valid": 16},
        layers=[dict(conv), dict(conv, sliding=2), dict(conv),
                {"type": "residual_proj", "skip": 2, "n_kernels": 8,
                 "sliding": 2, "learning_rate": 0.02, "momentum": 0.9},
                dict(conv), dict(conv), {"type": "residual", "skip": 2},
                {"type": "softmax", "output_sample_shape": 10,
                 "learning_rate": 0.02, "momentum": 0.9}],
        decision_config={"max_epochs": 1, "fail_iterations": 5})


@pytest.mark.cuda
def test_residual_train_step_card_vs_cpu():
    """One fused train step of a residual net with a projected skip from
    the same state on the card and on the CPU: one SGD launch for all 13
    tensors, each new tensor's gap within 1e-2 of its movement (the
    first-update limit of ``chip_smoke.py``'s conv-zoo phases: a ReLU
    gate or a max-pool argmax whose inputs sit ~1e-6 from a tie flips on
    one side)."""
    dev = _card()
    rng = numpy.random.RandomState(3)
    x = rng.randn(16, 32, 32, 3).astype(numpy.float32)
    labels = rng.randint(0, 10, 16).astype(numpy.int32)
    runs = []
    for where in (dev, "cpu"):
        wf = _residual_workflow()
        wf.initialize(device=where)
        runner = wf._fused_runner
        before = HK.launch_counts()["fused_sgd_update"]
        new, _ = runner._train_step(
            runner.state, torch.as_tensor(x, device=where),
            torch.as_tensor(labels, device=where),
            torch.ones(16, device=where), 16)
        runs.append((runner.state, new,
                     HK.launch_counts()["fused_sgd_update"] - before))
    torch.cuda.synchronize()
    (old, card, launched), (old_cpu, cpu, _) = runs
    assert launched == 1
    assert sum(len([k for k in e if k in ("w", "b")]) for e in card) == 13
    for e_old, e_card, e_cpu in zip(old_cpu, card, cpu):
        for name in e_cpu:
            moved = (e_cpu[name] - e_old[name]).abs().max()
            gap = (e_card[name].cpu() - e_cpu[name]).abs().max()
            assert gap <= 1e-2 * moved, (name, gap.item(), moved.item())



@pytest.mark.cuda
def test_seeded_residual_runs_repeat_bit_for_bit():
    """Two seeded runs of the residual net's whole epoch on the card end
    with bit-equal weights: every precision mode pins cuDNN's
    deterministic algorithms (its default weight-gradient algorithms sum
    with atomics, and two runs drift apart from the first update)."""
    dev = _card()
    runs = []
    for _ in range(2):
        wf = _residual_workflow()
        wf.initialize(device=dev)
        assert torch.backends.cudnn.deterministic
        wf.run()
        runs.append([[e[k].cpu() for k in ("w", "b") if k in e]
                     for e in wf._fused_runner.state if e])
    for a, b in zip(*runs):
        for x, y in zip(a, b):
            assert torch.equal(x, y)

def _record_loader(tmp_path, prefetch, mean=False):
    """A seeded 40-sample uint8 record file (12 validation, 28 train,
    16x16x3) behind a card-side ImagenetRecordsLoader at minibatch 8."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.loader.records import write_records
    from veles_tpu_torch.samples.imagenet import ImagenetRecordsLoader
    from veles_tpu_torch.workflow import Workflow
    rng = numpy.random.RandomState(9)
    data = rng.randint(0, 256, (40, 16, 16, 3)).astype(numpy.uint8)
    path = str(tmp_path / "set.rec")
    write_records(path, data, rng.randint(0, 10, 40).astype(numpy.int32),
                  [0, 12, 28])
    mean_path = None
    if mean:
        mean_path = str(tmp_path / "mean.npy")
        numpy.save(mean_path, rng.randn(16, 16, 3).astype(numpy.float32))
    prng.reset()
    prng.seed_all(9)
    loader = ImagenetRecordsLoader(Workflow(None), path=path,
                                   mean_path=mean_path, prefetch=prefetch,
                                   minibatch_size=8, name="loader")
    loader.initialize(device=torch.device("cuda"))
    return loader


def _record_epochs(loader, delay):
    """Two epochs of (host gather, device minibatch) pairs.  With
    ``delay`` every copy queues behind a spin on its stream, so a
    staging buffer refilled before its copy has read it would show."""
    pairs = []
    try:
        while loader.epoch_number < 2:
            if delay:
                torch.cuda._sleep(2000000)
                with torch.cuda.stream(loader._copy_stream):
                    torch.cuda._sleep(2000000)
            loader.run()
            x = loader.minibatch_data.devmem
            y = loader.minibatch_labels.devmem
            host = loader._gather(loader.minibatch_indices.mem)
            pairs.append((host, x.clone(), y.clone()))
    finally:
        loader.stop()
    torch.cuda.synchronize()
    return pairs


@pytest.mark.cuda
@pytest.mark.parametrize("prefetch", [False, True], ids=["sync", "prefetch"])
def test_records_pinned_upload_equals_host_gather(tmp_path, prefetch):
    """The record loader's device minibatch is its host gather (with the
    mean subtracted) bit for bit, uploaded from two pinned buffers."""
    _card()
    loader = _record_loader(tmp_path, prefetch, mean=True)
    assert all(slot[0].is_pinned() and slot[1].is_pinned()
               for slot in loader._ring.slots)
    pairs = _record_epochs(loader, delay=False)
    assert len(pairs) == 2 * (2 + 4)
    for (batch, labels), x, y in pairs:
        assert x.device.type == "cuda" and x.dtype == torch.float32
        assert torch.equal(x.cpu().view(torch.int32),
                           torch.as_tensor(batch).view(torch.int32))
        assert torch.equal(y.cpu(), torch.as_tensor(labels))


@pytest.mark.cuda
@pytest.mark.parametrize("prefetch", [False, True], ids=["sync", "prefetch"])
def test_records_buffer_reuse_waits_for_its_copy(tmp_path, prefetch):
    """Copies held back behind a spin on their stream: the ring waits
    for the copy that last read a buffer before refilling it, so every
    device minibatch still equals its host gather, and the stream is the
    same with prefetch on and off."""
    _card()
    pairs = _record_epochs(_record_loader(tmp_path, prefetch), delay=True)
    sync = _record_epochs(_record_loader(tmp_path, False), delay=False)
    for ((batch, labels), x, y), (_, x0, y0) in zip(pairs, sync):
        assert torch.equal(x.cpu(), torch.as_tensor(batch))
        assert torch.equal(y.cpu(), torch.as_tensor(labels))
        assert torch.equal(x, x0) and torch.equal(y, y0)


# ------------------------------------------------- the captured train step
def _captured(fn, side):
    """``fn`` warmed up on ``side`` and captured into a CUDA graph."""
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        fn()
    return graph


@pytest.mark.cuda
def test_device_operand_entries_bit_equal_inside_a_graph():
    """The fused SGD entry that reads inv_batch and the learning rates
    from the card, and the dropout entry that reads its key there, each
    captured once and replayed with new operands, equal the by-value
    entries bit for bit."""
    from veles_tpu_torch import prng
    dev = _card()
    rng = numpy.random.RandomState(0)
    shapes = [(784, 100), (100,), (100, 10), (10,)]
    ps = [_randn(rng, *s, dev=dev) for s in shapes]
    vs = [_randn(rng, *s, dev=dev) for s in shapes]
    gs = [_randn(rng, *s, dev=dev) for s in shapes]
    row = torch.zeros(8, device=dev)
    outs = ([torch.empty_like(p) for p in ps],
            [torch.empty_like(p) for p in ps])
    at = [(1, 3), (1, 4), (1, 5), (1, 6)]
    hyper = (0.9, 5e-4, 0.25, None)
    side = torch.cuda.Stream()
    sgd = _captured(lambda: HK.fused_sgd_update_multi_dev(
        ps, vs, gs, row, at, [hyper] * 4, out=outs), side)
    x = _randn(rng, 128, 4096, dev=dev)
    key = torch.zeros(2, dtype=torch.int32, device=dev)
    dropped = []
    drop = _captured(lambda: dropped.append(HK.dropout(x, key, 0.5)), side)
    y = dropped[-1]
    for n, (bs, lrs) in enumerate(((100, (0.03, 0.01, 0.02, 0.5)),
                                   (37, (0.1, 0.2, 0.3, 0.4)),
                                   (1, (1e-3,) * 4))):
        host = numpy.zeros(8, numpy.float32)
        host[0] = bs
        host[1] = numpy.float32(1) / numpy.float32(bs)
        host[3:7] = lrs
        row.copy_(torch.as_tensor(host))
        k = prng.PRNGKey(n + 1)
        key.copy_(torch.as_tensor(k.view(numpy.int32)))
        sgd.replay()
        drop.replay()
        torch.cuda.synchronize()
        want = HK.fused_sgd_update_multi(
            ps, vs, gs, [(bs, lr) + hyper for lr in lrs])
        for got, ref in zip(outs[0] + outs[1], want[0] + want[1]):
            assert torch.equal(got, ref)
        assert torch.equal(y, HK.dropout(x, k, 0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("layers", ["momentum", "adam"])
def test_captured_step_short_last_minibatch_equals_eager(layers):
    """The captured train step over an epoch whose last minibatch is
    short (inv_batch and the adam step read from the operand table at
    each replay) equals the eager step with the host operands, step by
    step, bit for bit."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.compiled import ScanProgram
    from veles_tpu_torch.config import root
    from veles_tpu_torch.loader.base import TRAIN
    from veles_tpu_torch.samples import mnist
    dev = _card()
    prng.reset()
    prng.seed_all(3)
    root.__dict__.pop("mnist", None)
    first = {"type": "all2all_tanh", "output_sample_shape": 32,
             "learning_rate": 0.03, "momentum": 0.9}
    if layers == "adam":
        first = dict(first, solver="adam", momentum=None,
                     lr_policy={"policy": "exp", "gamma": 0.9})
    root.mnist.update({
        "loader": {"minibatch_size": 50, "n_train": 130, "n_valid": 50},
        "decision": {"max_epochs": 1},
        "layers": [first, {"type": "softmax", "output_sample_shape": 10,
                           "learning_rate": 0.03, "momentum": 0.9}]})
    wf = mnist.build(fused=True)
    root.__dict__.pop("mnist", None)
    wf.initialize(device=dev)
    runner, loader = wf._fused_runner, wf.loader
    idx, mask = loader.plan_arrays(TRAIN)
    assert mask[-1].sum() == 30
    data = loader.original_data.devmem
    labels = loader.original_labels.devmem
    program = ScanProgram(runner, dev, [data], [labels], len(idx), 50,
                          len(idx), 1)
    ops = [runner.host_operands(int(m.sum()), s) for s, m in enumerate(mask)]
    program.train.load(idx, mask, program.operand_tables(ops))
    program.train.reset()
    state = runner.state
    for s in range(len(idx)):
        program.replay_train()
        i = torch.as_tensor(idx[s], device=dev).long()
        state, _ = runner._step(state, data[i], labels[i],
                                torch.as_tensor(mask[s], device=dev),
                                ops[s])
        torch.cuda.synchronize()
        for got, want in zip(program.state, state):
            for k in want:
                assert torch.equal(got[k], want[k]), (s, k)
    assert program.captured


@pytest.mark.cuda
def test_epoch_scan_under_gloo_on_the_card_raises(tmp_path):
    """A gloo collective stages through the host and cannot be captured
    in a CUDA graph: under a gloo ShardedTrainer the scan refuses the
    card (naming the reason) instead of running uncaptured."""
    import torch.distributed as dist
    from veles_tpu_torch import parallel, prng
    from veles_tpu_torch.compiled import ScanProgram
    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples import mnist
    dev = _card()
    prng.reset()
    prng.seed_all(3)
    root.__dict__.pop("mnist", None)
    root.mnist.update({
        "loader": {"minibatch_size": 50, "n_train": 100, "n_valid": 50},
        "decision": {"max_epochs": 1, "fail_iterations": 5},
        "layers": [{"type": "softmax", "output_sample_shape": 10,
                    "learning_rate": 0.03, "momentum": 0.9}]})
    wf = mnist.build(fused=True)
    wf.initialize(device=dev)
    runner, ld = wf._fused_runner, wf.loader
    dist.init_process_group("gloo", init_method="file://%s"
                            % (tmp_path / "store"), rank=0, world_size=1)
    try:
        parallel.ShardedTrainer(runner, parallel.make_mesh())
        with pytest.raises(ValueError, match="needs the nccl backend"):
            ScanProgram(runner, dev, [ld.original_data.devmem],
                        [ld.original_labels.devmem], 2, 50, 2, 1)
    finally:
        parallel.shutdown()
        root.__dict__.pop("mnist", None)


@pytest.mark.cuda
def test_generate_rolling_matches_the_plain_forward(monkeypatch):
    """The rolling-cache decode on the card (RoPE, GQA, a 5-slot ring
    behind 2 sinks, 40 new tokens: the ring wraps 7 times): every step's
    logits within 1e-4 of a teacher-forced plain forward with the same
    window and sinks over the emitted sequence, TF32 off."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.ops import functional as F
    from veles_tpu_torch.ops import transformer as T
    dev = _card()
    F.set_matmul_precision("float32")
    host = T.init_transformer_params(prng.RandomGenerator("init", 5), 32,
                                     d_model=64, n_heads=4, n_layers=2,
                                     n_kv_heads=2, rope=True)
    params = T.tree_map(lambda a: torch.as_tensor(a, device=dev), host)
    rng = numpy.random.RandomState(5)
    prompt = torch.as_tensor(rng.randint(0, 32, (3, 9)).astype(numpy.int32),
                             device=dev)
    seen = []
    head = T.head_logits

    def recording(p, h):
        out = head(p, h)
        seen.append(out[:, -1].clone())
        return out

    monkeypatch.setattr(T, "head_logits", recording)
    toks = T.generate_rolling(params, prompt, 40, 4, 5, temperature=0,
                              sinks=2)
    monkeypatch.undo()
    assert toks.shape == (3, 49) and toks.device == prompt.device
    with torch.no_grad():
        want = T.transformer_forward(params, toks[:, :-1], 4, rope=True,
                                     window=5, sinks=2)[:, 8:]
    got = torch.stack(seen, 1)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= ATOL


@pytest.mark.cuda
def test_lrn_net_export_and_native_runner_on_the_card(tmp_path):
    dev = _card()
    from veles_tpu_torch import export, native, prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples import imagenet
    prng.reset()
    prng.seed_all(3)
    saved = root.__dict__.pop("imagenet", None)
    try:
        root.imagenet.update({
            "loader": {"minibatch_size": 16, "records_path": None,
                       "n_train": 32, "n_valid": 16, "image_hw": (16, 16),
                       "n_classes": 4},
            "decision": {"max_epochs": 1},
            "layers": [
                {"type": "conv_str", "n_kernels": 8, "kx": 3, "ky": 3,
                 "padding": "SAME"},
                {"type": "norm"},
                {"type": "max_pooling", "kx": 2, "ky": 2},
                {"type": "all2all_str", "output_sample_shape": 16},
                {"type": "softmax", "output_sample_shape": 4}]})
        wf = imagenet.build(fused=True)
        wf.initialize(device=dev)
    finally:
        root.__dict__.pop("imagenet", None)
        if saved is not None:
            root.__dict__["imagenet"] = saved
    path = export.export_model(wf, str(tmp_path / "lrn.veles"))
    model = export.load_model(path)
    x = numpy.random.RandomState(11).uniform(0, 1, (8, 16, 16, 3)).astype(
        numpy.float32)
    runner = wf._fused_runner
    want = runner.eval_forward()(runner.state,
                                 torch.from_numpy(x).to(dev)).cpu().numpy()
    HK.reset_launch_counts()
    got = model.predict(x)
    assert HK.launch_counts()["lrn_forward"] == 1
    numpy.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    bundle = export.export_native_bundle(wf, str(tmp_path / "bundle"))
    out, launches, _, _ = native.run_artifact(bundle, x)
    assert launches == 1
    numpy.testing.assert_allclose(out, got, rtol=0, atol=1e-5)
    numpy.testing.assert_array_equal(out.argmax(1), got.argmax(1))


@pytest.mark.cuda
def test_weights2d_spec_is_the_committed_weights_on_the_host():
    dev = _card()
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples import mnist
    prng.reset()
    prng.seed_all(5)
    saved = root.__dict__.pop("mnist", None)
    try:
        root.mnist.update({
            "loader": {"minibatch_size": 100, "n_train": 300,
                       "n_valid": 100},
            "decision": {"max_epochs": 2, "fail_iterations": 50},
            "layers": [
                {"type": "all2all_tanh", "output_sample_shape": 16,
                 "learning_rate": 0.03, "momentum": 0.9},
                {"type": "softmax", "output_sample_shape": 10,
                 "learning_rate": 0.03, "momentum": 0.9}]})
        wf = mnist.build(fused=True)
    finally:
        root.__dict__.pop("mnist", None)
        if saved is not None:
            root.__dict__["mnist"] = saved

    class Sink:
        def __init__(self):
            self.got = []

        def send(self, spec):
            self.got.append(spec)

    wf.graphics_server = Sink()
    plotters = wf.link_plotters()
    wf.initialize(device=dev)
    wf.run()
    weights = [p for p in plotters if p.name == "plot_weights"][0]
    assert len(weights.specs) == 2
    committed = wf._fused_runner.state[0]["w"]
    assert committed.device.type == "cuda"
    images = weights.specs[-1]["images"]
    assert type(images) is numpy.ndarray and images.dtype == numpy.float32
    numpy.testing.assert_array_equal(
        images, committed.cpu().numpy().T.reshape(16, 28, 28))
    assert all(not isinstance(v, torch.Tensor) for spec in
               wf.graphics_server.got for v in spec.values())


def _megastep_engine(**knobs):
    """A small paged engine (vocab 64, d 64, 4 heads, 2 layers, 4 slots,
    page 16, 8 pages a lane) with the fused decode on the card (K = 4
    unless ``knobs`` say otherwise)."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.ops.transformer import init_transformer_params
    from veles_tpu_torch.serving import LMEngine
    prng.reset()
    host = init_transformer_params(prng.RandomGenerator("init", 11), 64,
                                   d_model=64, n_heads=4, n_layers=2,
                                   max_len=128)
    knobs = dict({"megastep": 4}, **knobs)
    return LMEngine(host, 4, 128, slots=4, prefill_chunk=16, device="cuda",
                    **knobs)


def _stage_lanes(engine, seed):
    """Stage the fused program's inputs: 4 lanes on distinct pages at
    their own depths, with 4, 2, 0 (frozen) and 3 iterations of work,
    and with ``spec_k`` histories over 4 tokens (so drafts recur)."""
    rng = numpy.random.RandomState(seed)
    S, w, k = engine.slots, engine._max_pages, engine.spec_k
    stage = engine._ms_host
    stage["ptab"][:] = (1 + numpy.arange(S * w)).reshape(S, w)
    stage["last"][:] = rng.randint(0, 4, S)
    pos = rng.randint(1, engine.max_len - engine.megastep * (k + 1) - k, S)
    stage["pos"][:] = pos
    stage["left"][:] = [4, 2, 0, 3]
    if k:
        stage["hist"][:] = rng.randint(0, 4, stage["hist"].shape)
        stage["hlen"][:] = pos + 1
    engine._ms_in.copy_(engine._ms_stage)


@pytest.mark.cuda
@pytest.mark.parametrize("spec_k", [0, 2])
def test_megastep_graph_equals_eager_body_and_repeats(spec_k):
    """The captured program at the widest table: a replay launches kernel
    5 once a layer an iteration (2 x 4), a second replay is bit-equal to
    the first, and the same body run eagerly gives the same output."""
    _card()
    engine = _megastep_engine(spec_k=spec_k).start()
    engine.stop()
    w = engine._max_pages
    assert sorted(engine._megastep_programs) == [1, 2, 4, 8]
    assert engine.megastep_launches[w] == {"paged_flash_decode": 8}
    with torch.inference_mode():
        _stage_lanes(engine, seed=spec_k)
        HK.reset_launch_counts()
        first = engine._megastep_program(w).clone()
        per_replay = HK.launch_counts()
        second = engine._megastep_program(w).clone()
        eager = engine._megastep_body(w)
        torch.cuda.synchronize()
    assert per_replay["paged_flash_decode"] == 8
    assert sum(per_replay.values()) == 8
    assert torch.equal(first, second)
    assert torch.equal(first, eager)
    # the frozen lane emitted nothing and kept its carry
    S, K, c = engine.slots, engine.megastep, spec_k + 1
    out = first.cpu().numpy()
    emitted = out[2 * S:2 * S + K * S * c].reshape(K, S, c)
    assert (emitted[:, 2] == -1).all() and (emitted[:, 0, 0] >= 0).all()
    assert out[S + 2] == engine._ms_host["pos"][2]


@pytest.mark.cuda
def test_while_graph_equals_eager_body_with_an_armed_ring_entry():
    """The captured while program (K = 8 conditional nodes) at a small
    width: one lane with 2 tokens left drains at iteration 2 and the one
    published ring entry (3 tokens left, deeper) is armed into its slot,
    so 5 iterations run and 3 are skipped.  Two launches and the same
    program run eagerly give equal packed outputs, and the launches
    added a launch are the per-iteration ones (kernel 5 once a layer)
    times the realised iterations."""
    _card()
    engine = _megastep_engine(megastep=8, megastep_mode="while",
                              refill_ring=1)
    engine.start()
    engine.stop()
    w, S, K = 2, engine.slots, engine.megastep
    assert engine.megastep_launches[w] == {"paged_flash_decode": 2}
    stage = engine._ms_host
    for name in stage:
        stage[name][...] = 0
    stage["ptab"][0, :2] = [1, 2]
    stage["last"][0], stage["pos"][0] = 5, 10
    stage["left"][:] = [2, -1, -1, -1]
    stage["ring_tab"][0, :2] = [3, 4]
    stage["ring_last"][0], stage["ring_pos"][0] = 7, 20
    stage["ring_left"][0], stage["count"][0] = 3, 1
    with torch.inference_mode():
        engine._ms_in.copy_(engine._ms_stage)
        HK.reset_launch_counts()
        first = engine._megastep_program(w).clone()
        torch.cuda.synchronize()
        assert HK.launch_counts()["paged_flash_decode"] == 0
        second = engine._megastep_program(w).clone()
        eager = engine._while_body(w).clone()
        torch.cuda.synchronize()
    out = first.cpu().numpy()
    at = 2 * S + K * S
    iters, assign = int(out[at]), out[at + 1:]
    assert iters == 5 and assign.tolist() == [0]
    HK.reset_launch_counts()            # the eager run counted its own
    engine._count_while_launches(w, iters)
    counts = HK.launch_counts()
    assert counts["paged_flash_decode"] == 2 * iters
    assert sum(counts.values()) == 2 * iters
    assert torch.equal(first, second)
    assert torch.equal(first, eager)
    emitted = out[2 * S:at].reshape(K, S)
    assert (emitted[:iters, 0] >= 0).all() and (emitted[iters:] == -1).all()
    assert (emitted[:, 1:] == -1).all()
    # the armed entry's frontier: 20 + its 3 tokens
    assert out[S] == 23 and out[0] == emitted[iters - 1, 0]


SAMPLED = dict(temperature=0.8, top_k=40, sample_seed=123)


@pytest.mark.cuda
@pytest.mark.parametrize("spec_k", [0, 2])
def test_sampled_megastep_graph_equals_eager_body_and_repeats(spec_k):
    """A sampling engine's captured program draws each iteration's
    tokens with the draw kernel, the lanes' keys made in the graph from
    the staged seeds: a replay launches it once an iteration (4) beside
    kernel 5 (8), a second replay is bit-equal to the first, and the
    same body run eagerly gives the same output."""
    _card()
    engine = _megastep_engine(spec_k=spec_k, **SAMPLED).start()
    engine.stop()
    w = engine._max_pages
    assert engine.megastep_launches[w] == {"paged_flash_decode": 8,
                                           "sample_token": 4}
    with torch.inference_mode():
        _stage_lanes(engine, seed=spec_k)
        engine._ms_host["seeds"][:] = [3, 5, 0, 9]
        engine._ms_in.copy_(engine._ms_stage)
        HK.reset_launch_counts()
        first = engine._megastep_program(w).clone()
        per_replay = HK.launch_counts()
        second = engine._megastep_program(w).clone()
        eager = engine._megastep_body(w)
        torch.cuda.synchronize()
    assert per_replay["paged_flash_decode"] == 8
    assert per_replay["sample_token"] == 4
    assert torch.equal(first, second)
    assert torch.equal(first, eager)


@pytest.mark.cuda
def test_sampled_while_graph_equals_eager_body_with_an_armed_ring_entry():
    """The sampling while program with a ring entry that brings its own
    seed: the graph's two launches and the eager program agree bit for
    bit, and each realised iteration launches the draw kernel once."""
    _card()
    engine = _megastep_engine(megastep=8, megastep_mode="while",
                              refill_ring=1, **SAMPLED)
    engine.start()
    engine.stop()
    w, S, K = 2, engine.slots, engine.megastep
    assert engine.megastep_launches[w] == {"paged_flash_decode": 2,
                                           "sample_token": 1}
    stage = engine._ms_host
    for name in stage:
        stage[name][...] = 0
    stage["ptab"][0, :2] = [1, 2]
    stage["last"][0], stage["pos"][0], stage["seeds"][0] = 5, 10, 4
    stage["left"][:] = [2, -1, -1, -1]
    stage["ring_tab"][0, :2] = [3, 4]
    stage["ring_last"][0], stage["ring_pos"][0] = 7, 20
    stage["ring_left"][0], stage["ring_seeds"][0] = 3, 7
    stage["count"][0] = 1
    with torch.inference_mode():
        engine._ms_in.copy_(engine._ms_stage)
        first = engine._megastep_program(w).clone()
        second = engine._megastep_program(w).clone()
        eager = engine._while_body(w).clone()
        torch.cuda.synchronize()
    out = first.cpu().numpy()
    iters = int(out[2 * S + K * S])
    assert iters == 5
    HK.reset_launch_counts()
    engine._count_while_launches(w, iters)
    assert HK.launch_counts()["sample_token"] == iters
    assert torch.equal(first, second)
    assert torch.equal(first, eager)


def _swap_tree(seed):
    """A host tree of ``_megastep_engine``'s geometry from seed ``seed``."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.ops.transformer import init_transformer_params
    prng.reset()
    return init_transformer_params(prng.RandomGenerator("init", seed), 64,
                                   d_model=64, n_heads=4, n_layers=2,
                                   max_len=128)


@pytest.mark.cuda
@pytest.mark.parametrize("planted", [False, True])
def test_swap_under_captured_graphs_serves_the_new_weights(planted):
    """An engine captured on weights A (``megastep=4``: one graph a
    ladder width, reading the weights by address) swaps to B and then
    serves B's greedy tokens, equal to a fresh engine started on B, with
    every decode iteration a graph replay.  The planted pointer swap
    (``params`` reassigned, the reference's apply) leaves the graphs on
    A: its tokens differ from B's, so the check fails it."""
    from veles_tpu_torch.serving import LMEngine
    _card()
    prompts = numpy.asarray([[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8,
                                                         1, 8]])
    trees = {seed: _swap_tree(seed) for seed in (11, 12)}

    def engine(seed):
        return LMEngine(trees[seed], 4, 128, slots=4, prefill_chunk=16,
                        device="cuda", megastep=4).start()
    fresh = engine(12)
    try:
        want_b = fresh.generate(prompts, 24)
    finally:
        fresh.stop()
    live = engine(11)
    try:
        want_a = live.generate(prompts, 24)
        if planted:
            live._load_params = lambda staged: setattr(live, "params",
                                                       staged)
        assert live.swap_weights(trees[12]) == 1
        HK.reset_launch_counts()
        got, vers = live.generate(prompts, 24, return_versions=True)
        launches = HK.launch_counts()
    finally:
        live.stop()
    assert vers == [1, 1] and not numpy.array_equal(want_a, want_b)
    # every decode iteration ran inside a replayed graph (2 layers)
    steps = live.metrics.counter("megastep_dispatches")
    assert launches["paged_flash_decode"] >= 2 * 4 * 1 and steps > 0
    if planted:
        assert not numpy.array_equal(got, want_b)
    else:
        numpy.testing.assert_array_equal(got, want_b)


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [
    {"megastep": 0, "prefix_cache": 16}, {"megastep": 4},
    {"megastep": 8, "megastep_mode": "while", "refill_ring": 2}],
    ids=["tick", "scan", "while"])
def test_traced_engine_equals_untraced(knobs):
    """A traced engine on the card: its tokens and kernel 5/6 launches
    are an untraced engine's, every request's span tree is closed and
    sound, the ledger counts one decode dispatch a step or graph replay,
    and every prompt chunk's span closes after the card finished the
    chunk (a CUDA event recorded behind it has completed)."""
    from veles_tpu_torch.serving import SpanTracer, verify_integrity
    _card()
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6] * 3, [2, 7, 1, 8] * 5, [5, 5, 5],
               [3, 1, 4, 1, 5, 9, 2, 6] * 3 + [7], [1, 2, 3, 4, 5, 6]]

    def run(tracer):
        engine = _megastep_engine(tracer=tracer, **knobs)
        late = []

        def watch():
            # each served chunk records an event behind it; its span's
            # close reads whether the event has completed
            chunk, add = engine._chunk_program, tracer.add

            def recorded_chunk(*args):
                out = chunk(*args)
                event = torch.cuda.Event()
                event.record()
                late.append([event, None])
                return out

            def closing(ctx, name, *args, **kw):
                if name == "prefill.chunk":
                    late[-1][1] = late[-1][0].query()
                return add(ctx, name, *args, **kw)
            engine._chunk_program, tracer.add = recorded_chunk, closing
        with engine._cond:
            engine.start()          # the warmup's chunk is not watched
            if tracer is not None:
                watch()
            HK.reset_launch_counts()
            futures = [engine.submit(p, 16) for p in prompts]
        try:
            outs = [f.result(timeout=300) for f in futures]
        finally:
            engine.stop()
        return outs, HK.launch_counts(), engine, late

    want, want_launches, _, _ = run(None)
    tracer = SpanTracer(mode="all", last=16)
    got, launches, engine, late = run(tracer)
    for a, b in zip(got, want):
        numpy.testing.assert_array_equal(a, b)
    for name in ("paged_flash_decode", "paged_flash_prefill"):
        assert launches[name] == want_launches[name] > 0
    recs = tracer.requests()
    assert verify_integrity(recs)["requests"] == len(prompts)
    decode = sum(r["dispatches"] for r in tracer.live_ledger()
                 if r["op"].startswith("decode."))
    assert decode == engine.metrics.counter("decode_dispatches") > 0
    assert late and all(done for _, done in late)
    assert {r["backend"] for r in tracer.live_ledger()} == {"cuda"}



class _Witnessed:
    """The lock-order witness and the transfer guard (``"disallow"``)
    armed for a ``with`` block (this file runs without the suite's
    conftest, so each test arms them itself); ``witness`` is the lock
    witness."""

    def __enter__(self):
        from veles_tpu_torch.serving import lockcheck, xfer
        self.witness = lockcheck.arm(lockcheck.LockOrderWitness(
            name="card"))
        xfer.arm("disallow")
        return self

    def __exit__(self, *exc):
        from veles_tpu_torch.serving import lockcheck, xfer
        xfer.disarm()
        lockcheck.disarm()
        return False


GUARD_PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6] * 3, [2, 7, 1, 8] * 5, [5, 5, 5],
                 [3, 1, 4, 1, 5, 9, 2, 6] * 3 + [7], [1, 2, 3, 4, 5, 6]]


def _guard_run(knobs):
    """Serve ``GUARD_PROMPTS`` (16 tokens each, queued before the
    worker's first turn) on a fresh ``_megastep_engine(**knobs)``;
    returns (tokens, kernel 5/6 launches)."""
    engine = _megastep_engine(**knobs)
    with engine._cond:
        engine.start()
        HK.reset_launch_counts()
        futures = [engine.submit(p, 16) for p in GUARD_PROMPTS]
    try:
        outs = [list(f.result(timeout=300)) for f in futures]
    finally:
        engine.stop()
    launches = HK.launch_counts()
    return outs, {k: launches[k] for k in ("paged_flash_decode",
                                           "paged_flash_prefill")}


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [
    {"megastep": 0}, {"megastep": 0, "spec_k": 2}, {"megastep": 4},
    {"megastep": 8, "megastep_mode": "while", "refill_ring": 2}],
    ids=["tick", "spec", "scan", "while"])
def test_guard_and_witness_armed_engine_equals_unarmed(knobs):
    """With the lock-order witness and the transfer guard armed, every
    decode path serves the unarmed run's tokens with its kernel 5 and 6
    launches, no violation is recorded, every dispatch is checked, and
    the sync debug mode is back to default after ``stop()``."""
    _card()
    want = _guard_run(knobs)
    with _Witnessed() as armed:
        got = _guard_run(knobs)
    assert torch.cuda.get_sync_debug_mode() == 0
    assert got == want and got[1]["paged_flash_decode"] > 0
    report = armed.witness.report()
    assert report["violations"] == [], "\n\n".join(report["violations"])
    assert report["dispatch_checks"] > 0 and report["acquisitions"] > 0


@pytest.mark.cuda
def test_implicit_read_in_a_decode_dispatch_fails_the_request_loudly():
    """The twin of the reference's poisoned step: a decode dispatch that
    reads a card value with ``.item()`` fails its request's future with
    the sync error under the armed guard, and the engine goes on to
    serve the next request with the unarmed run's tokens."""
    _card()
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    engine = _megastep_engine(megastep=0).start()
    try:
        want = list(engine.submit(prompt, 8).result(timeout=300))
    finally:
        engine.stop()
    with _Witnessed() as armed:
        engine = _megastep_engine(megastep=0).start()
        real, left = engine._pick, [1]

        def poisoned(logits, seeds, pos):
            if left[0]:
                left[0] -= 1
                logits.max().item()
            return real(logits, seeds, pos)
        engine._pick = poisoned
        try:
            with pytest.raises(RuntimeError, match="synchroniz"):
                engine.submit(prompt, 8).result(timeout=300)
            got = list(engine.submit(prompt, 8).result(timeout=300))
        finally:
            engine.stop()
    assert got == want and not left[0]
    assert torch.cuda.get_sync_debug_mode() == 0
    assert armed.witness.violations == []


@pytest.mark.cuda
def test_blocking_upload_outside_to_device_is_caught():
    """Under the armed guard a blocking ``torch.as_tensor(...,
    device=)`` upload in a dispatch raises (the sync debug mode covers
    the synchronizing host-to-card copy), while the same values through
    ``xfer.to_device`` pass; the request fails and the next is served."""
    from veles_tpu_torch.serving import xfer
    dev = _card()
    with _Witnessed():
        with xfer.guard(dev):
            ok = xfer.to_device(numpy.arange(4), numpy.int32, dev)
            with pytest.raises(RuntimeError, match="synchroniz"):
                torch.as_tensor(numpy.arange(4, dtype=numpy.int32),
                                device=dev)
            with xfer.boundary():
                assert xfer.to_host(ok).tolist() == [0, 1, 2, 3]
        engine = _megastep_engine(megastep=0).start()
        real, left = engine._tensor, [1]

        def blocking(arr):
            if left[0]:
                left[0] -= 1
                return torch.as_tensor(numpy.asarray(arr, numpy.int32),
                                       device=engine.device)
            return real(arr)
        engine._tensor = blocking
        try:
            with pytest.raises(RuntimeError, match="synchroniz"):
                engine.submit([1, 2, 3], 4).result(timeout=300)
            assert len(engine.submit([1, 2, 3], 4).result(timeout=300)) == 4
        finally:
            engine.stop()
    assert torch.cuda.get_sync_debug_mode() == 0


def _sequential_fleet(engines):
    """``GUARD_PROMPTS`` one at a time (each resolved before the next is
    submitted) through a router over ``engines``, or through the lone
    engine; returns (tokens, replica stamps, kernel 5/6 launches)."""
    from veles_tpu_torch.serving import Router
    server = Router(engines) if len(engines) > 1 else engines[0]
    server.start()
    HK.reset_launch_counts()
    try:
        outs, stamps = [], []
        for p in GUARD_PROMPTS:
            f = server.submit(p, 16)
            outs.append(list(f.result(timeout=300)))
            stamps.append(getattr(getattr(f, "job", None), "replica", 0))
    finally:
        server.stop()
    launches = HK.launch_counts()
    return outs, stamps, {k: launches[k] for k in ("paged_flash_decode",
                                                   "paged_flash_prefill")}


@pytest.mark.cuda
@pytest.mark.parametrize("megastep", [0, 4], ids=["tick", "scan"])
def test_two_replica_router_serves_one_engines_tokens(megastep):
    """Two replicas on ``cuda:0`` behind the router, each with its own
    weights copy and, at K = 4, its own captured graphs: the tokens one
    engine serves for the same requests one at a time, the placements
    alternating, and kernels 5 and 6 launched n_layers x the replicas'
    summed decode iterations and prompt chunks."""
    _card()
    from veles_tpu_torch.serving import ServingMetrics
    want, _, _ = _sequential_fleet([_megastep_engine(megastep=megastep)])
    engines = [_megastep_engine(
        megastep=megastep, name="fleet_r%d" % i,
        metrics=ServingMetrics("fleet", labels={"replica": str(i)}))
        for i in range(2)]
    assert engines[0].params["embed"].data_ptr() \
        != engines[1].params["embed"].data_ptr()
    got, stamps, launches = _sequential_fleet(engines)
    assert got == want
    assert stamps == [0, 1, 0, 1, 0]
    steps = sum(e.metrics.counter("decode_dispatches") for e in engines)
    chunks = sum(e.metrics.counter("prefill_dispatches") for e in engines)
    n_layers, k = 2, max(1, megastep)
    assert launches == {"paged_flash_decode": n_layers * k * steps,
                        "paged_flash_prefill": n_layers * chunks}
    assert steps > 0 and chunks > 0


@pytest.mark.cuda
def test_retrying_router_on_the_card_serves_one_engines_tokens():
    """Two replicas on ``cuda:0`` behind a router with ``retries=2``,
    replica 0 faulting every decode step: every request is retried onto
    replica 1 and served with one engine's greedy tokens."""
    _card()
    from veles_tpu_torch.serving import FaultPlan, Router, ServingMetrics
    want, _, _ = _sequential_fleet([_megastep_engine(megastep=0)])
    plan = FaultPlan().arm("engine.step", times=1000)
    engines = [_megastep_engine(
        megastep=0, name="retry_r%d" % i, faults=plan if i == 0 else None,
        metrics=ServingMetrics("retry", labels={"replica": str(i)}))
        for i in range(2)]
    router = Router(engines, retries=2, retry_backoff_s=0.01).start()
    try:
        got, stamps = [], []
        for p in GUARD_PROMPTS:
            with router._lock:
                router._routed = [0, 1]     # replica 0 first every time
            f = router.submit(p, 16)
            got.append(list(f.result(timeout=300)))
            stamps.append(f.job.replica)
    finally:
        router.stop()
    assert got == want
    assert stamps == [1] * len(GUARD_PROMPTS)
    assert router.metrics.counter("requests_retried") == len(GUARD_PROMPTS)
    assert plan.fired("engine.step") >= len(GUARD_PROMPTS)


@pytest.mark.cuda
def test_megastep_capture_with_a_host_read_raises_at_start():
    """A body that reads a value on the host cannot be captured: the
    engine's start raises, and nothing falls back to eager dispatches.
    (Last in the file: the failed capture leaves its stream's pool.)"""
    _card()
    engine = _megastep_engine()
    real = engine._plain_iter

    def planted(ptabs, carry):
        carry[1].max().item()
        return real(ptabs, carry)
    engine._plain_iter = planted
    with pytest.raises(RuntimeError):
        engine.start()
    assert engine._thread is None and engine._megastep_programs is None
