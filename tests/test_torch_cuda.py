"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test skips without one.

This file imports neither JAX nor ``veles_tpu``, so it also runs where
JAX is not installed (the card's machine), without the suite's
conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: fp32 outputs are O(1) and the kernel sums up to 16384 keys
in another order than the plain version (~1e-7 apart on the card), so
max abs error <= 1e-4; the prefill install is a row copy, bit-equal.
The fused SGD kernel is held within 1 ulp per element of its plain
version (the plain version forms each fused multiply-add in float64 and
rounds once, which can differ from the hardware fma only on a rare
double-rounding tie).  The LRN kernels sum each window in the plain
version's order, and differ from it only where CUDA's powf and PyTorch's
pow round differently: forward rtol/atol 2e-6, backward rtol 3e-5 /
atol 3e-6 (the reference's Pallas-vs-XLA tolerances).  Dropout is
bit-equal to its plain version.  The flash backward kernels (3xTF32 on
the tensor cores) repeat bit for bit from launch to launch, and their
error against an fp64 plain version is at most 4x the fp32 plain
version's.
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n", [
    ((2, 55, 55, 96), 5),         # AlexNet LRN1's channels
    ((2, 27, 27, 256), 5),        # LRN2's
    ((3, 5, 5, 200), 4),          # even window: asymmetric
    ((7, 16), 5),
    ((2, 3, 3000), 5),            # one row per tile
    ((1, 24), 1),
])
def test_lrn_matches_plain(shape, n):
    dev = _card()
    rng = numpy.random.RandomState(shape[-1] + n)
    x = _randn(rng, *shape, dev=dev) * 3.0
    dy = _randn(rng, *shape, dev=dev)
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
