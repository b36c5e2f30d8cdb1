"""Hand-written Hopper kernels, with their plain PyTorch versions.

Counterpart of ``veles_tpu/ops/pallas_kernels.py``.  Each kernel is CUDA
C++ for ``sm_90a`` under ``csrc/``, built at first use by :mod:`._build`:
the training update in ``csrc/fused_sgd.cu``, the AlexNet LRN forward and
backward in ``csrc/lrn.cu``, dropout with its threefry mask, the RBM's
Bernoulli draws and the decoders' token draw in ``csrc/dropout.cu``, and
the serving hot loop's two paged attention kernels in
``csrc/paged_flash_attention.cu``.  The
attention kernels share the TPU kernels' geometry: the KV pool is
(n_pages, kv_heads, page, head_dim), a lane's page-table row maps its linear positions [0, m·page) onto pool
pages, and queries arrive as (b, heads, c, head_dim).  Grouped-query
attention folds into the kernels as (kv, g·c) query rows per kv head —
row r of kv head j is query head j·g + r // c at chunk offset r % c.

Every wrapper dispatches on the device of the tensors it is given: a
CPU tensor runs the plain version (``*_ref``), a CUDA tensor launches
the kernel and adds one to the wrapper's ``launches`` count, and any
other device raises.  There is no fallback from the kernel to the plain
version.

fused_sgd_update / fused_sgd_update_multi
    Replace ``veles_tpu/ops/pallas_kernels.py:92`` (fused_sgd_update).
    Bound on the H100: bytes (p, v, g read once, p' and v' written once:
    20 bytes per element).  One launch updates a whole list of tensors
    (a training step's, each with its own scalars) from a table passed
    by value, one elementwise pass with 16-byte accesses; the outputs are
    new tensors, because the fused training step holds an update
    pending until Decision commits it (or ``out=`` tensors: the epoch
    scan's static state buffers).  ``fused_sgd_update_multi_dev`` is the
    same kernel reading each tensor's inv_batch and learning rate from
    a device row when it runs — what a captured CUDA-graph step
    replays.  One count: ``fused_sgd_update``.
lrn_forward / lrn_backward
    Replace ``veles_tpu/ops/pallas_kernels.py:226`` (``_lrn_fwd``) and
    ``:244`` (``_lrn_bwd_vjp``).  Bound: bytes (12 and 16 bytes an
    element).  A block stages whole rows in shared memory and sums each
    channel window directly in fp32; the forward also writes the
    denominator d, which the backward takes instead of recomputing it
    (the Pallas custom VJP's residuals).  :class:`LRN` ties the two into
    a ``torch.autograd.Function``.
dropout
    Replaces ``veles_tpu/ops/pallas_kernels.py:272`` (dropout).  Bound:
    operations (the threefry hash, ~80 integer operations an element).
    The mask is jax's ``bernoulli(key, 1 - rate, shape)`` bit for bit;
    the backward is the same kernel on dy with the same key.  A key
    given as two int32 words on the card is read there when the kernel
    runs (a captured step's entry).  An element ``offset`` hashes
    element i as i + offset: a data-parallel rank draws its rows of the
    global batch's mask.
bernoulli
    No TPU kernel's port: ``jax.random.bernoulli(key, p)`` for a tensor
    ``p``, which the reference leaves to XLA (the RBM's visible
    binarization and Gibbs samples, one launch a draw).  The same
    threefry hash as dropout, compared with p[i]; bound: operations.
sample_token
    No TPU kernel's port: the seeded temperature / top-k draw of one
    token a row (``jax.random.categorical`` in the reference's decode
    programs, which XLA computes).  One block a row: the row's key (one
    key for the whole draw, or fold_in(fold_in(base, seed), position)
    made in the kernel), jax's threefry bits, uniform and gumbel draw,
    the top-k mask against a cutoff found by ``torch.topk`` before the
    launch, the division by the temperature and a block argmax; bound:
    operations.
paged_flash_decode
    Replaces ``veles_tpu/ops/pallas_kernels.py:367`` (paged_flash_decode).
    Bound on the H100: bytes — every live K/V page is read once for
    about 0.5 flop per byte.  Split-KV: each lane's table is cut into
    ranges of pages (:func:`decode_splits`, from the geometry alone) so
    that the (lane, kv head) pairs of a serving batch fill the card; a
    one-warp block walks its range in 32-key tiles with the reference's
    online softmax, skipping pages that hold no live key before
    anything is read, and stages K and V through shared memory by
    coalesced 16-byte ``cp.async`` with the next slab in flight.  A
    second small kernel combines the ranges' states in a fixed order
    (no atomics); both are one call and one count.
paged_flash_prefill
    Replaces ``veles_tpu/ops/pallas_kernels.py:443`` (paged_flash_prefill).
    Bound: bytes (history pages plus the chunk's K/V, read once).
    Split-KV as decode (:func:`prefill_splits`): a block of 8 warps owns
    a kv head's tile of up to 64 query rows and one range of the lane's
    pages (the last range also takes the chunk's own keys), stages each
    32-key tile's K and V through shared memory by coalesced ``cp.async``
    with two slabs in flight, and scores the whole row tile against it;
    the ranges' states meet in the same combine kernel, and the same call
    installs the chunk into its pool page.
    :func:`paged_flash_prefill_split_ref` and
    :func:`paged_flash_combine_ref` are the two phases' contract in plain
    PyTorch.
flash_attention_fwd / flash_attention_bwd_dkv / flash_attention_bwd_dq
    Replace jax's bundled TPU Pallas flash attention, which
    ``veles_tpu/ops/attention.py:176`` (flash_attention_tpu) calls for
    training: its forward and its dK/dV and dQ passes (three
    ``pallas_call`` s), in ``csrc/flash_attention.cu``.  Bound:
    operations (fp32 products of s²·dh per head), run on the tensor
    cores as 3xTF32 ``mma.sync`` (fp32 accuracy).  A block owns a 64-row
    tile and walks the other side's tiles with an online softmax (the
    forward) or the row residual lse (the backward), skipping tiles above
    the diagonal; no kernel uses atomics, so results repeat bit for bit.
    :class:`FlashAttention` ties the three into a
    ``torch.autograd.Function``.
"""

from __future__ import annotations

import ctypes
import threading

import numpy
import torch

NEG_INF = -1e30

#: guards the launch counts: a wrapper may launch from several threads
#: at once (a threaded HTTP server's handlers), and ``+=`` on an
#: attribute is a read and a write that another thread may come between
_COUNT_LOCK = threading.Lock()


def _count(wrapper):
    """Add one to ``wrapper.launches``: called where its kernel launches,
    and nowhere else."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def serving_kernels_supported(paged, n_heads, kv_heads, head_dim, page,
                              tp=0):
    """(ok, reason) — can the serving kernels carry this engine
    geometry?  The reference's structural checks (what the kernels
    cannot express); the CUDA kernels take any page size, head_dim and
    table width beyond them."""
    if tp and tp >= 2:
        return False, ("tensor-parallel mesh (tp=%d): the serving "
                       "kernels are single-device programs" % tp)
    if not paged:
        return False, ("contiguous KV layout (the kernels walk a page "
                       "table; enable paged_kv)")
    if n_heads % kv_heads:
        return False, ("n_heads %d not divisible by kv_heads %d"
                       % (n_heads, kv_heads))
    if page < 1 or head_dim < 1:
        return False, "degenerate geometry"
    return True, None


# ---------------------------------------------------------- fused SGD update
def _sgd_scalars(batch_size, learning_rate, momentum=0.0, weight_decay=0.0,
                 l1_vs_l2=0.0, gradient_clip=None, inv_batch=None):
    """The update's scalars as fp32 values, rounded the way JAX rounds
    them: inv_batch = float32(1) / float32(max(batch, 1)) in fp32, the
    others rounded to fp32 once from Python doubles (``1 - l1_vs_l2``
    computed in double first — JAX's weak-typed constant folding).  The
    clip is 0 when off.  Raises on a tensor: a scalar on the card would
    need a host sync per update."""
    values = (batch_size, learning_rate, momentum, weight_decay, l1_vs_l2,
              gradient_clip)
    if any(isinstance(v, torch.Tensor) for v in values):
        raise TypeError("fused_sgd_update takes its scalars as Python or "
                        "numpy numbers, not tensors")
    f32 = numpy.float32
    clip = (f32(gradient_clip) if gradient_clip is not None
            and gradient_clip > 0.0 else f32(0.0))
    if inv_batch is None:
        inv_batch = f32(1.0) / f32(max(int(batch_size), 1))
    return {"inv_batch": f32(inv_batch),
            "lr": f32(learning_rate), "momentum": f32(momentum),
            "weight_decay": f32(weight_decay), "l1": f32(l1_vs_l2),
            "one_minus_l1": f32(1.0 - float(l1_vs_l2)), "clip": clip}


def _fma(a, b, c):
    """fp32 fused multiply-add a*b + c, rounded once: the fp32 product is
    exact in float64, so one float64 add and one rounding to fp32 give
    the fused result (up to the rare double-rounding tie)."""
    return (a.double() * b + c.double()).float()


def fused_sgd_update_ref(param, velocity, grad, batch_size, learning_rate,
                         momentum=0.0, weight_decay=0.0, l1_vs_l2=0.0,
                         gradient_clip=None):
    """Plain PyTorch version of :func:`fused_sgd_update`, in the kernel's
    order of operations (see ``csrc/fused_sgd.cu``); each fused
    multiply-add is one float64 multiply-add rounded once to fp32.
    Returns new (param, velocity)."""
    return _sgd_apply_ref(param, velocity, grad, _sgd_scalars(
        batch_size, learning_rate, momentum, weight_decay, l1_vs_l2,
        gradient_clip))


def _sgd_apply_ref(param, velocity, grad, s):
    """The kernel's element function on tensors, for the scalars ``s``
    (:func:`_sgd_scalars`)."""
    wd, clip = float(s["weight_decay"]), float(s["clip"])
    if wd:
        decay = _fma(param, float(s["one_minus_l1"]),
                     torch.sign(param) * float(s["l1"]))
    if clip > 0.0:
        g = (grad * float(s["inv_batch"])).clamp(-clip, clip)
        if wd:
            g = _fma(decay, wd, g)
    elif wd:
        g = _fma(grad, float(s["inv_batch"]), decay * wd)
    else:
        g = grad * float(s["inv_batch"])
    v = _fma(velocity, float(s["momentum"]), -(g * float(s["lr"])))
    return param + v, v


# ------------------------------------------------------------ plain versions
def _band(k_pos, q_pos, window, sinks, base):
    """The ``chunk_live_mask`` band on position grids: ``base`` is the
    causal half (decode: k <= q; prefill history: k < frontier), window
    and sinks compose exactly as ``band_bias``."""
    live = base
    if window:
        in_w = k_pos > q_pos - window
        if sinks:
            in_w = in_w | (k_pos < sinks)
        live = live & in_w
    return live


def _flash_step(qg, k, v, live, state):
    """One online-softmax accumulation against a (b, kv, n, dh) K/V block
    for (b, kv, rows, dh) queries; ``live`` is (b, rows, n).  NEG_INF is
    finite and added, so a fully masked block's transient terms rescale
    to exactly 0 once a live block arrives."""
    acc, l, m = state
    s = torch.matmul(qg, k.transpose(-1, -2)) / torch.sqrt(
        torch.tensor(qg.shape[-1], dtype=torch.float32))
    s = s + torch.where(live, 0.0, NEG_INF)[:, None]
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l = l * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.matmul(p.to(v.dtype), v)
    return acc, l, m_new


def _fold(q, kv):
    """(b, h, c, dh) queries → (b, kv, g·c, dh) rows, plus each row's
    chunk offset (g·c,)."""
    b, h, c, dh = q.shape
    rows = torch.arange((h // kv) * c, device=q.device) % c
    return q.reshape(b, kv, (h // kv) * c, dh), rows


def _init_state(qg):
    shape = qg.shape[:-1]
    return (torch.zeros(qg.shape, dtype=torch.float32, device=qg.device),
            torch.zeros(shape, dtype=torch.float32, device=qg.device),
            torch.full(shape, NEG_INF, dtype=torch.float32,
                       device=qg.device))


def paged_flash_decode_ref(q, k_pool, v_pool, ptab, pos, window=None,
                           sinks=0):
    """Plain PyTorch version of :func:`paged_flash_decode`: the TPU
    kernel's page-by-page online softmax, every page of the table
    visited in order.  Returns (b, h, c, dh)."""
    b, h, c, dh = q.shape
    page = k_pool.shape[2]
    qg, rows = _fold(q, k_pool.shape[1])
    q_pos = pos.long()[:, None, None] + rows[None, :, None]
    state = _init_state(qg)
    for j in range(ptab.shape[1]):
        pid = ptab[:, j].long()
        k_pos = j * page + torch.arange(page, device=q.device)
        live = _band(k_pos, q_pos, window, sinks, k_pos <= q_pos)
        state = _flash_step(qg, k_pool[pid], v_pool[pid], live, state)
    acc, l, _ = state
    return (acc / l[..., None]).to(q.dtype).reshape(b, h, c, dh)


def paged_flash_prefill_ref(q, k_new, v_new, k_pool, v_pool, ptab, pos,
                            window=None, sinks=0):
    """Plain PyTorch version of :func:`paged_flash_prefill`: history
    pages masked strictly below the frontier, then the chunk's own K/V
    intra-causally, then the chunk installed into page
    ``ptab[i, pos // page]`` of both pools IN PLACE.  Returns
    (o, k_pool, v_pool)."""
    b, h, c, dh = q.shape
    page = k_pool.shape[2]
    _check_chunk(c, page)
    qg, rows = _fold(q, k_pool.shape[1])
    front = pos.long()[:, None, None]
    q_pos = front + rows[None, :, None]
    state = _init_state(qg)
    for j in range(ptab.shape[1]):
        pid = ptab[:, j].long()
        k_pos = j * page + torch.arange(page, device=q.device)
        live = _band(k_pos, q_pos, window, sinks, k_pos < front)
        state = _flash_step(qg, k_pool[pid], v_pool[pid], live, state)
    k_pos = front + torch.arange(c, device=q.device)
    live = _band(k_pos, q_pos, window, sinks, k_pos <= q_pos)
    acc, l, _ = _flash_step(qg, k_new, v_new, live, state)
    lanes = torch.arange(b, device=q.device)
    target = ptab.long()[lanes, pos.long() // page]
    k_pool[target] = k_new
    v_pool[target] = v_new
    o = (acc / l[..., None]).to(q.dtype).reshape(b, h, c, dh)
    return o, k_pool, v_pool


def split_ranges(m, splits):
    """The split kernels' cut of a table of ``m`` pages into ``splits``
    contiguous ranges of ceil(m / splits) pages (the last ones shorter or
    empty): a list of (first page, end page)."""
    per = -(-m // splits)
    return [(s * per, min(m, (s + 1) * per)) for s in range(splits)]


def paged_flash_prefill_split_ref(q, k_new, v_new, k_pool, v_pool, ptab,
                                  pos, splits, window=None, sinks=0):
    """The prefill split kernel's contract in plain PyTorch (no
    install): range s of :func:`split_ranges` (m, splits) leaves the
    online-softmax state of its history pages that hold a key live for
    the lane (a page with none is skipped, as the kernel never reads
    it), the last range also of the chunk's own keys; a range with no
    live page leaves the empty state (NEG_INF, 0, 0).  Returns (m, l)
    (b, kv, g·c, splits) and acc (b, kv, g·c, splits, dh), which
    :func:`paged_flash_combine_ref` meets."""
    c = q.shape[2]
    page = k_pool.shape[2]
    qg, rows = _fold(q, k_pool.shape[1])
    lane_pos = pos.long()
    front = lane_pos[:, None, None]
    q_pos = front + rows[None, :, None]
    states = []
    for s, (pg0, pg1) in enumerate(split_ranges(ptab.shape[1], splits)):
        state = _init_state(qg)
        for j in range(pg0, pg1):
            kb = j * page
            lane_live = kb < lane_pos
            if window:
                lane_live = lane_live & ((kb + page - 1 > lane_pos - window)
                                         | (kb < sinks))
            if not bool(lane_live.any()):
                continue
            pid = ptab[:, j].long()
            k_pos = kb + torch.arange(page, device=q.device)
            live = _band(k_pos, q_pos, window, sinks, k_pos < front)
            new = _flash_step(qg, k_pool[pid], v_pool[pid], live, state)
            keep = lane_live[:, None, None]
            state = (torch.where(keep[..., None], new[0], state[0]),
                     torch.where(keep, new[1], state[1]),
                     torch.where(keep, new[2], state[2]))
        if s == splits - 1:
            k_pos = front + torch.arange(c, device=q.device)
            live = _band(k_pos, q_pos, window, sinks, k_pos <= q_pos)
            state = _flash_step(qg, k_new, v_new, live, state)
        states.append(state)
    acc, l, m = (torch.stack(x, dim=3) for x in zip(*states))
    return m, l, acc


def paged_flash_combine_ref(m, l, acc):
    """The combine kernel in plain PyTorch: the splits' states meet in
    split order, o = Σ_s acc_s e^(m_s − M) / Σ_s l_s e^(m_s − M) with M
    the largest m_s (a split left empty weighs exp(NEG_INF − M) = 0).
    Takes :func:`paged_flash_prefill_split_ref`'s states; returns the
    (b, kv, g·c, dh) rows, which reshape to o (b, h, c, dh)."""
    a = torch.exp(m - m.amax(dim=-1, keepdim=True))
    num, den = acc[..., 0, :] * a[..., 0, None], l[..., 0] * a[..., 0]
    for s in range(1, acc.shape[3]):
        num = num + acc[..., s, :] * a[..., s, None]
        den = den + l[..., s] * a[..., s]
    return num / den[..., None]


# ----------------------------------------------------------------- wrappers
def _check_chunk(c, page):
    if c != page:
        raise ValueError("prefill kernel needs chunk (%d) == page (%d)"
                         % (c, page))


def _on_card(*tensors):
    """True when the operands lie on one CUDA device, False when they
    all lie on the CPU; raises on anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError("operands on several devices: %s"
                         % sorted(str(d) for d in devices))
    kind = next(iter(devices)).type
    if kind == "cpu":
        return False
    if kind != "cuda":
        raise ValueError("no kernel for device type %r" % kind)
    return True


def _check_operands(floats, ints):
    for name, t in floats:
        if t.dtype != torch.float32:
            raise TypeError("%s must be float32 (got %s)" % (name, t.dtype))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
        if t.data_ptr() % 16:
            raise ValueError("%s must start 16-byte aligned" % name)
    for name, t in ints:
        if t.dtype != torch.int32:
            raise TypeError("%s must be int32 (got %s)" % (name, t.dtype))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)


def _check_geometry(q, k_pool, v_pool, ptab, pos):
    b, h, c, dh = q.shape
    n_pages, kv, page, pdh = k_pool.shape
    if v_pool.shape != k_pool.shape:
        raise ValueError("k_pool %s and v_pool %s differ"
                         % (tuple(k_pool.shape), tuple(v_pool.shape)))
    if pdh != dh or h % kv:
        raise ValueError("q %s does not fit pool %s"
                         % (tuple(q.shape), tuple(k_pool.shape)))
    if ptab.dim() != 2 or ptab.shape[0] != b or tuple(pos.shape) != (b,):
        raise ValueError("ptab %s / pos %s do not match %d lanes"
                         % (tuple(ptab.shape), tuple(pos.shape), b))


_LIB = None


def _lib():
    """The kernels' shared library, built on first use."""
    global _LIB
    if _LIB is None:
        from veles_tpu_torch.ops import _build
        lib = _build.load("paged_flash_attention")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.paged_flash_decode_f32.argtypes = [ptr] * 7 + [i32] * 10 + [ptr]
        lib.paged_flash_decode_f32.restype = i32
        lib.paged_flash_decode_splits.argtypes = [i32] * 6
        lib.paged_flash_decode_splits.restype = i32
        lib.paged_flash_prefill_f32.argtypes = \
            [ptr] * 9 + [i32] * 9 + [ptr]
        lib.paged_flash_prefill_f32.restype = i32
        lib.paged_flash_prefill_splits.argtypes = [i32] * 6
        lib.paged_flash_prefill_splits.restype = i32
        lib.paged_flash_error_string.argtypes = [i32]
        lib.paged_flash_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _raise_on(code, what):
    if code:
        raise RuntimeError("%s launch failed: %s" % (
            what, _lib().paged_flash_error_string(code).decode()))


def paged_flash_decode(q, k_pool, v_pool, ptab, pos, window=None,
                       sinks=0):
    """Flash-decode over the paged KV pool: ``c`` query positions per
    lane ((b, h, c, dh), already projected, rotated and GQA-shaped)
    attend their lane's linear cache view through the page table,
    masked by the ``chunk_live_mask`` band.  The pool must already hold
    the lane's rows for positions [0, pos+c) — the caller
    ``paged_write``s the c new rows first.  Every entry of ``ptab`` for
    a page holding a live key must be a valid pool row.

    CPU tensors run :func:`paged_flash_decode_ref`; CUDA tensors launch
    the kernel (fp32 q and pools, int32 ptab and pos, all contiguous —
    anything else raises).  Returns (b, h, c, dh)."""
    _check_geometry(q, k_pool, v_pool, ptab, pos)
    if not _on_card(q, k_pool, v_pool, ptab, pos):
        return paged_flash_decode_ref(q, k_pool, v_pool, ptab, pos,
                                      window=window, sinks=sinks)
    _check_operands((("q", q), ("k_pool", k_pool), ("v_pool", v_pool)),
                    (("ptab", ptab), ("pos", pos)))
    b, h, c, dh = q.shape
    kv, page, m = k_pool.shape[1], k_pool.shape[2], ptab.shape[1]
    splits = decode_splits(b, h, kv, c, dh, m)
    o = torch.empty_like(q)
    # each split's (m, l) and accumulator rows, for the combine
    workspace = (torch.empty(b * h * c * splits * (dh + 2),
                             dtype=torch.float32, device=q.device)
                 if splits > 1 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = _lib().paged_flash_decode_f32(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            ptab.data_ptr(), pos.data_ptr(), o.data_ptr(),
            None if workspace is None else workspace.data_ptr(), b, h, kv,
            c, dh, page, m, int(window or 0), int(sinks), splits, stream)
    _raise_on(code, "paged_flash_decode")
    # one call: the split kernel and, with more than one split, the combine
    _count(paged_flash_decode)
    return o


paged_flash_decode.launches = 0


def decode_splits(b, h, kv, c, dh, m):
    """How many ranges of a lane's table :func:`paged_flash_decode`
    splits the walk into on the card, from the geometry alone (never
    from ``pos``, which lives on the card): enough blocks to fill the
    H100's 132 SMs, each split at least one page.  Builds the kernels'
    library on first use."""
    return _lib().paged_flash_decode_splits(b, h, kv, c, dh, m)


def paged_flash_prefill(q, k_new, v_new, k_pool, v_pool, ptab, pos,
                        window=None, sinks=0):
    """Fused chunked-prefill attention: one page-aligned chunk of
    ``c == page`` positions per lane attends the paged history (masked
    strictly below the frontier ``pos``) plus the chunk's own K/V, and
    the same call installs that K/V into the lane's pool page
    ``ptab[i, pos // page]``.

    The install MUTATES ``k_pool`` and ``v_pool`` in place — the port's
    counterpart of the TPU kernel's ``input_output_aliases``.  Caller
    contract (the engine's chunk program guarantees both): ``pos`` is
    page-aligned and the target page is a fresh page no other lane
    reads.  Raises ValueError when c != page.  CPU tensors run
    :func:`paged_flash_prefill_ref`; CUDA tensors launch the kernel.
    Returns (o (b, h, c, dh), k_pool, v_pool)."""
    _check_chunk(q.shape[2], k_pool.shape[2])
    _check_geometry(q, k_pool, v_pool, ptab, pos)
    b, h, c, dh = q.shape
    kv = k_pool.shape[1]
    if k_new.shape != (b, kv, c, dh) or v_new.shape != k_new.shape:
        raise ValueError("k_new %s / v_new %s must be %s" % (
            tuple(k_new.shape), tuple(v_new.shape), (b, kv, c, dh)))
    if not _on_card(q, k_new, v_new, k_pool, v_pool, ptab, pos):
        return paged_flash_prefill_ref(q, k_new, v_new, k_pool, v_pool,
                                       ptab, pos, window=window,
                                       sinks=sinks)
    _check_operands((("q", q), ("k_new", k_new), ("v_new", v_new),
                     ("k_pool", k_pool), ("v_pool", v_pool)),
                    (("ptab", ptab), ("pos", pos)))
    m = ptab.shape[1]
    splits = prefill_splits(b, h, kv, c, dh, m)
    o = torch.empty_like(q)
    # each split's (m, l) and accumulator rows, for the combine
    workspace = (torch.empty(b * h * c * splits * (dh + 2),
                             dtype=torch.float32, device=q.device)
                 if splits > 1 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = _lib().paged_flash_prefill_f32(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_pool.data_ptr(), v_pool.data_ptr(), ptab.data_ptr(),
            pos.data_ptr(), o.data_ptr(),
            None if workspace is None else workspace.data_ptr(), b, h, kv,
            c, dh, c, m, int(window or 0), int(sinks), stream)
    _raise_on(code, "paged_flash_prefill")
    # one call: the split kernel and, with more than one split, the combine
    _count(paged_flash_prefill)
    return o, k_pool, v_pool


paged_flash_prefill.launches = 0


def prefill_splits(b, h, kv, c, dh, m):
    """How many ranges of a lane's table :func:`paged_flash_prefill`
    splits the walk into on the card (the last range also takes the
    chunk's own keys), from the geometry alone, as
    :func:`decode_splits`.  Builds the kernels' library on first use."""
    return _lib().paged_flash_prefill_splits(b, h, kv, c, dh, m)


_SGD_LIB = None
#: the kernel's scalar arguments, in order (exact fp32 values)
_SGD_ORDER = ("inv_batch", "lr", "momentum", "weight_decay", "l1",
              "one_minus_l1", "clip")
#: the most tensors one launch updates (the kernel's table is a launch
#: parameter of at most 4 KB); a longer list takes several launches
SGD_MAX_TENSORS = 48


def _sgd_lib():
    """The fused SGD kernel's shared library, built on first use."""
    global _SGD_LIB
    if _SGD_LIB is None:
        from veles_tpu_torch.ops import _build
        lib = _build.load("fused_sgd")
        ptr = ctypes.c_void_p
        lib.fused_sgd_update_multi_f32.argtypes = [ptr] * 3 + [ctypes.c_int,
                                                               ptr]
        lib.fused_sgd_update_multi_f32.restype = ctypes.c_int
        lib.fused_sgd_update_multi_dev_f32.argtypes = [ptr] * 5 + [
            ctypes.c_int, ptr]
        lib.fused_sgd_update_multi_dev_f32.restype = ctypes.c_int
        lib.fused_sgd_max_tensors.restype = ctypes.c_int
        lib.fused_sgd_error_string.argtypes = [ctypes.c_int]
        lib.fused_sgd_error_string.restype = ctypes.c_char_p
        if lib.fused_sgd_max_tensors() != SGD_MAX_TENSORS:
            raise RuntimeError("fused_sgd.cu takes %d tensors a launch, "
                               "the wrapper expects %d" % (
                                   lib.fused_sgd_max_tensors(),
                                   SGD_MAX_TENSORS))
        _SGD_LIB = lib
    return _SGD_LIB


def fused_sgd_update_multi_ref(params, velocities, grads, scalars):
    """Plain PyTorch version of :func:`fused_sgd_update_multi`:
    :func:`fused_sgd_update_ref` on each tensor.  Returns (new params,
    new velocities) as lists."""
    out = [fused_sgd_update_ref(p, v, g, *s)
           for p, v, g, s in zip(params, velocities, grads, scalars)]
    return [p for p, _ in out], [v for _, v in out]


def _sgd_check(params, velocities, grads, n_scalars, out):
    """The lists as lists, their lengths and shapes checked; ``out``
    (new params, new velocities) checked against them when given."""
    params, velocities, grads = list(params), list(velocities), list(grads)
    if not (len(params) == len(velocities) == len(grads) == n_scalars):
        raise ValueError("%d params, %d velocities, %d grads and %d scalar "
                         "sets differ in number" % (
                             len(params), len(velocities), len(grads),
                             n_scalars))
    for p, v, g in zip(params, velocities, grads):
        if p.shape != v.shape or p.shape != g.shape:
            raise ValueError("param %s, velocity %s and grad %s differ in "
                             "shape" % (tuple(p.shape), tuple(v.shape),
                                        tuple(g.shape)))
    if out is not None:
        out = [list(o) for o in out]
        if len(out) != 2 or any(len(o) != len(params) for o in out):
            raise ValueError("out must be (new params, new velocities), "
                             "one of each per param")
        for o, p in zip(out[0] + out[1], params + params):
            if o.shape != p.shape:
                raise ValueError("out %s for param %s" % (
                    tuple(o.shape), tuple(p.shape)))
    return params, velocities, grads, out


def _sgd_outputs(params, velocities, out):
    """The output lists: ``out``'s tensors, or new ones."""
    if out is not None:
        return out
    return ([torch.empty_like(p) for p in params],
            [torch.empty_like(v) for v in velocities])


def _sgd_launch(params, velocities, grads, new_p, new_v, values, at=None,
                operands=None):
    """Launch the kernel over the lists, SGD_MAX_TENSORS at a time:
    by value, or (``operands`` given) with each tensor's inv_batch and lr
    read on the card from ``operands`` at ``at[i]``."""
    tensors = (("param", params), ("velocity", velocities), ("grad", grads),
               ("out", new_p + new_v))
    for name, ts in tensors:
        for t in ts:
            if t.dtype != torch.float32:
                raise TypeError("%s must be float32 (got %s)"
                                % (name, t.dtype))
            if not t.is_contiguous():
                raise ValueError("%s must be contiguous" % name)
    lib = _sgd_lib()
    device = params[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for lo in range(0, len(params), SGD_MAX_TENSORS):
            part = range(lo, min(lo + SGD_MAX_TENSORS, len(params)))
            ptrs = numpy.array(
                [t.data_ptr() for i in part for t in (
                    params[i], velocities[i], grads[i], new_p[i], new_v[i])],
                numpy.uint64)
            lengths = numpy.array([params[i].numel() for i in part],
                                  numpy.int64)
            scal = numpy.array([values[i][k] for i in part
                                for k in _SGD_ORDER], numpy.float32)
            if operands is None:
                code = lib.fused_sgd_update_multi_f32(
                    ptrs.ctypes.data, lengths.ctypes.data, scal.ctypes.data,
                    len(part), stream)
            else:
                offsets = numpy.array([at[i] for i in part], numpy.uint32)
                code = lib.fused_sgd_update_multi_dev_f32(
                    ptrs.ctypes.data, lengths.ctypes.data, scal.ctypes.data,
                    offsets.ctypes.data, operands.data_ptr(), len(part),
                    stream)
            if code:
                raise RuntimeError("fused_sgd_update launch failed: %s"
                                   % lib.fused_sgd_error_string(code)
                                   .decode())
            if lengths.any():
                _count(fused_sgd_update)


def fused_sgd_update_multi(params, velocities, grads, scalars, out=None):
    """Momentum-SGD updates of several tensors in ONE kernel launch (up
    to :data:`SGD_MAX_TENSORS` tensors a launch; a longer list takes
    several, each counted).  ``scalars[i]`` is tensor i's update
    arguments as :func:`fused_sgd_update` takes them after its three
    tensors: ``(batch_size, learning_rate[, momentum[, weight_decay[,
    l1_vs_l2[, gradient_clip]]]])`` — a weight and its bias may differ
    (the bias's own learning rate and weight decay).  Returns (new
    params, new velocities) as lists, leaving the inputs untouched: NEW
    tensors, or ``out``'s (two lists of tensors of the params' shapes,
    which must not overlap the inputs).

    CPU tensors run :func:`fused_sgd_update_multi_ref`; CUDA tensors
    launch the kernel (fp32, equal shapes per tensor, contiguous, all on
    one card — anything else raises).  A tensor whose pointers are not
    16-byte aligned takes the kernel's scalar loop.  Scalars are Python
    or numpy numbers, passed by value in the launch's table, so nothing
    is copied to or read back from the card."""
    scalars = list(scalars)
    params, velocities, grads, out = _sgd_check(params, velocities, grads,
                                                len(scalars), out)
    values = [_sgd_scalars(*s) for s in scalars]
    if not params or not _on_card(*params, *velocities, *grads):
        new_p, new_v = fused_sgd_update_multi_ref(params, velocities, grads,
                                                  scalars)
        return _into(new_p, new_v, out)
    new_p, new_v = _sgd_outputs(params, velocities, out)
    _sgd_launch(params, velocities, grads, new_p, new_v, values)
    return new_p, new_v


def _into(new_p, new_v, out):
    """The plain versions' results, copied into ``out`` when given."""
    if out is None:
        return new_p, new_v
    for dst, src in zip(out[0] + out[1], new_p + new_v):
        dst.copy_(src)
    return out


def fused_sgd_update_multi_dev_ref(params, velocities, grads, operands, at,
                                   scalars):
    """Plain PyTorch version of :func:`fused_sgd_update_multi_dev`: each
    tensor's inv_batch and lr read from the (CPU) ``operands`` at
    ``at[i]``, then :func:`fused_sgd_update_ref`'s arithmetic."""
    new_p, new_v = [], []
    for p, v, g, (ib, lr), (m, wd, l1, clip) in zip(params, velocities,
                                                   grads, at, scalars):
        s = _sgd_scalars(1, float(operands[lr]), m, wd, l1, clip,
                         inv_batch=numpy.float32(float(operands[ib])))
        p2, v2 = _sgd_apply_ref(p, v, g, s)
        new_p.append(p2)
        new_v.append(v2)
    return new_p, new_v


def fused_sgd_update_multi_dev(params, velocities, grads, operands, at,
                               scalars, out=None):
    """:func:`fused_sgd_update_multi` with each tensor's inv_batch
    (= 1/max(batch, 1) in fp32) and learning rate read on the card: they
    are ``operands[at[i][0]]`` and ``operands[at[i][1]]``, ``operands``
    a 1-D fp32 tensor on the tensors' device (a training step's operand
    row), which the wrapper never reads on the host.  ``scalars[i]`` is
    ``(momentum, weight_decay, l1_vs_l2, gradient_clip)`` by value.  The
    kernel and its arithmetic are the by-value entry's, so equal values
    give bit-equal results; the launch is one of ``fused_sgd_update``'s.
    A CUDA graph that captures this call reads the operands as they are
    at each replay.  CPU tensors run
    :func:`fused_sgd_update_multi_dev_ref`."""
    scalars, at = list(scalars), [tuple(int(i) for i in a) for a in at]
    params, velocities, grads, out = _sgd_check(params, velocities, grads,
                                                len(scalars), out)
    if len(at) != len(params):
        raise ValueError("%d offset pairs for %d params"
                         % (len(at), len(params)))
    if operands.dim() != 1 or operands.dtype != torch.float32:
        raise ValueError("operands must be a 1-D float32 tensor")
    if any(not 0 <= i < operands.numel() for a in at for i in a):
        raise ValueError("an offset lies outside the %d operands"
                         % operands.numel())
    if not params or not _on_card(operands, *params, *velocities, *grads):
        new_p, new_v = fused_sgd_update_multi_dev_ref(
            params, velocities, grads, operands, at, scalars)
        return _into(new_p, new_v, out)
    if not operands.is_contiguous():
        raise ValueError("operands must be contiguous")
    values = [_sgd_scalars(1, 0.0, *s) for s in scalars]
    new_p, new_v = _sgd_outputs(params, velocities, out)
    _sgd_launch(params, velocities, grads, new_p, new_v, values, at=at,
                operands=operands)
    return new_p, new_v


def fused_sgd_update(param, velocity, grad, batch_size, learning_rate,
                     momentum=0.0, weight_decay=0.0, l1_vs_l2=0.0,
                     gradient_clip=None):
    """Momentum-SGD update of one tensor: returns NEW (param, velocity)
    tensors, leaving the inputs untouched.  ``grad`` is the batch SUM;
    ``gradient_clip`` None or <= 0 means no clipping.  A one-entry
    :func:`fused_sgd_update_multi` (one launch on the card).

    CPU tensors run :func:`fused_sgd_update_ref`; CUDA tensors launch
    the kernel (fp32, equal shapes, contiguous — anything else raises).
    Scalars are Python or numpy numbers, passed to the kernel by value,
    so nothing is read back from the card."""
    (new_p,), (new_v,) = fused_sgd_update_multi(
        [param], [velocity], [grad],
        [(batch_size, learning_rate, momentum, weight_decay, l1_vs_l2,
          gradient_clip)])
    return new_p, new_v


fused_sgd_update.launches = 0


# ---------------------------------------------------------------------- LRN
#: one row of C channels must fit in the kernel's shared memory (227 KB)
LRN_MAX_CHANNELS = 227 * 1024 // 4


def _lrn_scalars(alpha, beta, n, k=None):
    """The kernels' fp32 scalars, rounded once from the Python doubles
    the reference folds them from (alpha/n, -beta, -beta - 1 and
    2·(alpha/n)·beta are weak-typed constants there)."""
    f32 = numpy.float32
    alpha_n = float(alpha) / int(n)
    return {"alpha_n": f32(alpha_n), "neg_beta": f32(-float(beta)),
            "k": f32(0.0 if k is None else k),
            "neg_beta_1": f32(-float(beta) - 1.0),
            "coef": f32(2.0 * alpha_n * float(beta))}


def _window_sum(t, n, left):
    """sum_{m < n} t[..., i - left + m] over the channel axis, zero
    outside [0, C), added in ascending channel order (the kernels'
    order)."""
    c = t.shape[-1]
    padded = torch.nn.functional.pad(t, (left, n - 1 - left))
    out = padded[..., 0:c]
    for m in range(1, n):
        out = out + padded[..., m:m + c]
    return out


def lrn_forward_ref(x, alpha=1e-4, beta=0.75, n=5, k=2.0):
    """Plain PyTorch version of :func:`lrn_forward`: returns (y, d) with
    d = k + (alpha/n)·Σ_{window(i)} x², window(i) = [i − n//2,
    i + n − 1 − n//2], and y = x·d^−β."""
    s = _lrn_scalars(alpha, beta, n, k)
    d = float(s["k"]) + float(s["alpha_n"]) * _window_sum(x * x, n, n // 2)
    return x * torch.pow(d, float(s["neg_beta"])), d


def lrn_backward_ref(x, d, dy, alpha=1e-4, beta=0.75, n=5):
    """Plain PyTorch version of :func:`lrn_backward`: dx = dy·(d·d^(−β−1))
    − (2(alpha/n)β)·x·Σ_{j: i ∈ window(j)} dy_j·x_j·d_j^(−β−1)."""
    s = _lrn_scalars(alpha, beta, n)
    dpow = torch.pow(d, float(s["neg_beta_1"]))
    inner = _window_sum(dy * x * dpow, n, n - 1 - n // 2)
    return dy * (d * dpow) - float(s["coef"]) * x * inner


def _check_lrn(name, t, c):
    if t.dtype != torch.float32:
        raise TypeError("%s must be float32 (got %s)" % (name, t.dtype))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)
    if c > LRN_MAX_CHANNELS:
        raise ValueError("LRN kernels take at most %d channels (got %d)"
                         % (LRN_MAX_CHANNELS, c))


_LRN_LIB = None


def _lrn_lib():
    global _LRN_LIB
    if _LRN_LIB is None:
        from veles_tpu_torch.ops import _build
        lib = _build.load("lrn")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        i64 = ctypes.c_longlong
        lib.lrn_forward_f32.argtypes = ([ptr] * 3 + [i64, i32, i32]
                                        + [f32] * 3 + [ptr])
        lib.lrn_forward_f32.restype = i32
        lib.lrn_backward_f32.argtypes = ([ptr] * 4 + [i64, i32, i32]
                                         + [f32] * 2 + [ptr])
        lib.lrn_backward_f32.restype = i32
        lib.lrn_plan_info.argtypes = [i64, i32, i32, i32, i32,
                                      ctypes.POINTER(i64)]
        lib.lrn_plan_info.restype = i32
        lib.lrn_error_string.argtypes = [i32]
        lib.lrn_error_string.restype = ctypes.c_char_p
        _LRN_LIB = lib
    return _LRN_LIB


def lrn_plan(rows, c, n=5, vec=True, backward=False):
    """How the LRN kernels launch a call of ``rows`` rows of ``c``
    channels (card only): the quad width (4: 16-byte accesses, C % 4 == 0
    and every pointer 16-byte aligned, as ``vec`` says; else 1), the
    template's n (0: the runtime window loop), whether the row is too
    wide for the ring of stages, rows a tile, stages, blocks and shared
    bytes a block."""
    lib = _lrn_lib()
    out = (ctypes.c_longlong * 7)()
    code = lib.lrn_plan_info(int(rows), int(c), int(n), int(bool(vec)),
                             int(bool(backward)), out)
    if code:
        raise RuntimeError("lrn_plan: %s" % lib.lrn_error_string(code)
                           .decode())
    keys = ("width", "template_n", "wide", "rows_per_tile", "stages",
            "blocks", "smem")
    return dict(zip(keys, (int(v) for v in out)))


#: the registered op's schema; the native artifact runner registers the
#: same one (``native/artifact_runner.cpp``)
LRN_FORWARD_OP = "veles_tpu_torch::lrn_forward"


@torch.library.custom_op(LRN_FORWARD_OP, mutates_args=(),
                         device_types="cpu")
def _lrn_forward_op(x: torch.Tensor, alpha: float, beta: float, n: int,
                    k: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The LRN forward as one dispatcher op, so that ``torch.export``
    keeps it as one node of an exported program: the CPU runs
    :func:`lrn_forward_ref`, the card the kernel (below)."""
    return lrn_forward_ref(x, alpha, beta, n, k)


@_lrn_forward_op.register_kernel("cuda")
def _lrn_forward_launch(x, alpha, beta, n, k):
    c = x.shape[-1]
    _check_lrn("x", x, c)
    s = _lrn_scalars(alpha, beta, n, k)
    y, d = torch.empty_like(x), torch.empty_like(x)
    lib = _lrn_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.lrn_forward_f32(
            x.data_ptr(), y.data_ptr(), d.data_ptr(), x.numel() // max(c, 1),
            c, int(n), float(s["alpha_n"]), float(s["neg_beta"]),
            float(s["k"]), stream)
    if code:
        raise RuntimeError("lrn_forward launch failed: %s"
                           % lib.lrn_error_string(code).decode())
    _count(lrn_forward)
    return y, d


@_lrn_forward_op.register_fake
def _lrn_forward_fake(x, alpha, beta, n, k):
    return torch.empty_like(x), torch.empty_like(x)


def lrn_forward(x, alpha=1e-4, beta=0.75, n=5, k=2.0):
    """Cross-channel LRN over the last axis: returns (y, d), y =
    x·d^−β and d the denominator the backward takes.

    Goes through the op ``veles_tpu_torch::lrn_forward``: CPU tensors
    run :func:`lrn_forward_ref`; CUDA tensors launch the kernel (fp32,
    contiguous — anything else raises)."""
    _on_card(x)
    return torch.ops.veles_tpu_torch.lrn_forward(
        x, float(alpha), float(beta), int(n), float(k))


lrn_forward.launches = 0


def lrn_backward(x, d, dy, alpha=1e-4, beta=0.75, n=5):
    """The LRN vector-Jacobian product from the forward's input x and
    denominator d: returns dx for the cotangent dy.

    CPU tensors run :func:`lrn_backward_ref`; CUDA tensors launch the
    kernel (fp32, equal shapes, contiguous — anything else raises)."""
    if x.shape != d.shape or x.shape != dy.shape:
        raise ValueError("x %s, d %s and dy %s differ in shape" % (
            tuple(x.shape), tuple(d.shape), tuple(dy.shape)))
    if not _on_card(x, d, dy):
        return lrn_backward_ref(x, d, dy, alpha, beta, n)
    c = x.shape[-1]
    for name, t in (("x", x), ("d", d), ("dy", dy)):
        _check_lrn(name, t, c)
    s = _lrn_scalars(alpha, beta, n)
    dx = torch.empty_like(x)
    lib = _lrn_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.lrn_backward_f32(
            x.data_ptr(), d.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            x.numel() // max(c, 1), c, int(n), float(s["neg_beta_1"]),
            float(s["coef"]), stream)
    if code:
        raise RuntimeError("lrn_backward launch failed: %s"
                           % lib.lrn_error_string(code).decode())
    _count(lrn_backward)
    return dx


lrn_backward.launches = 0


class LRN(torch.autograd.Function):
    """Differentiable LRN: the forward kernel saves (x, d), the backward
    kernel takes them — one launch each way.
    ``LRN.apply(x, alpha, beta, n, k)``."""

    @staticmethod
    def forward(ctx, x, alpha=1e-4, beta=0.75, n=5, k=2.0):
        y, d = lrn_forward(x, alpha, beta, n, k)
        ctx.save_for_backward(x, d)
        ctx.hyper = (alpha, beta, n)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, d = ctx.saved_tensors
        return (lrn_backward(x, d, dy.contiguous(), *ctx.hyper),
                None, None, None, None)


# ------------------------------------------------------------------ dropout
def _as_key(key):
    """A (2,) uint32 key from a key, an int seed (``PRNGKey(seed)``) or a
    CPU tensor of the two words (any integer type; its bits are read)."""
    from veles_tpu_torch import prng
    if isinstance(key, (int, numpy.integer)):
        return prng.PRNGKey(int(key))
    if isinstance(key, torch.Tensor):
        key = numpy.asarray([int(w) & 0xFFFFFFFF for w in key.tolist()],
                            numpy.uint32)
    key = numpy.asarray(key)
    if key.shape != (2,) or key.dtype != numpy.uint32:
        raise ValueError("a threefry key is two uint32 words (got %s %s)"
                         % (key.dtype, key.shape))
    return key


def dropout_ref(x, key, rate, offset=0):
    """Plain PyTorch version of :func:`dropout`: the threefry bits of
    every flat index (plus ``offset``) hashed on tensors, u =
    uniform(bits), out = x / p where u < p, else 0 (p = float32(1 −
    rate))."""
    if rate <= 0.0:
        return x
    keep = float(numpy.float32(1.0 - rate))
    u = _uniform_ref(key, x.numel(), x.device, offset)
    # a 0-dim tensor divisor: a true division on every device (a Python
    # scalar divisor becomes a multiply by its reciprocal on the card)
    divisor = torch.tensor(keep, dtype=torch.float32, device=x.device)
    return torch.where(u.reshape(x.shape) < keep, x / divisor,
                       torch.zeros((), dtype=x.dtype, device=x.device))


_DROPOUT_LIB = None


def _dropout_lib():
    global _DROPOUT_LIB
    if _DROPOUT_LIB is None:
        from veles_tpu_torch.ops import _build
        lib = _build.load("dropout")
        ptr, u32 = ctypes.c_void_p, ctypes.c_uint
        i64 = ctypes.c_longlong
        lib.dropout_f32.argtypes = [ptr, ptr, i64, u32, u32,
                                    ctypes.c_float, i64, ptr]
        lib.dropout_f32.restype = ctypes.c_int
        lib.dropout_dev_f32.argtypes = [ptr, ptr, i64, ptr,
                                        ctypes.c_float, i64, ptr]
        lib.dropout_dev_f32.restype = ctypes.c_int
        lib.bernoulli_f32.argtypes = [ptr, ptr, ctypes.c_longlong, u32, u32,
                                      ptr]
        lib.bernoulli_f32.restype = ctypes.c_int
        i32 = ctypes.c_int
        lib.sample_token_f32.argtypes = [ptr, i64, i32, ptr, i32,
                                         ctypes.c_float, u32, u32, ptr, ptr,
                                         ptr, ptr]
        lib.sample_token_f32.restype = ctypes.c_int
        lib.dropout_error_string.argtypes = [ctypes.c_int]
        lib.dropout_error_string.restype = ctypes.c_char_p
        _DROPOUT_LIB = lib
    return _DROPOUT_LIB


def dropout(x, key, rate, offset=0):
    """Inverted dropout: out = x / p where the element's threefry draw
    is below p = 1 − rate, else 0, with jax's
    ``bernoulli(key, p, x.shape)`` mask bit for bit.  ``key`` is a (2,)
    uint32 host key (``veles_tpu_torch.prng``) or an int seed, which
    means ``PRNGKey(seed)`` as the Pallas wrapper takes it.  ``rate``
    <= 0 returns x.  The backward is this function on dy with the same
    key (and offset).

    ``offset`` (>= 0, by value) makes flat element i draw as element
    i + offset: x holding rows [r, r + b) of a global batch of rows of
    f elements, offset r·f gives exactly those rows of the global
    batch's mask (a data-parallel rank's share).

    ``key`` may also be a tensor of two 32-bit words (int32 or int64, the
    bits of the key) on ``x``'s device: on the card the kernel then reads
    the words there when it runs (the entry a captured CUDA graph
    replays with a new key each time), which the wrapper never reads on
    the host; the mask is the by-value entry's bit for bit.

    CPU tensors run :func:`dropout_ref`; CUDA tensors launch the kernel
    (fp32, contiguous — anything else raises); a host key goes by
    value."""
    if rate <= 0.0:
        return x
    offset = int(offset)
    if offset < 0:
        raise ValueError("offset must be >= 0 (got %d)" % offset)
    on_device_key = isinstance(key, torch.Tensor)
    if not _on_card(x, *((key,) if on_device_key else ())):
        return dropout_ref(x, key, rate, offset)
    if x.dtype != torch.float32:
        raise TypeError("x must be float32 (got %s)" % x.dtype)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    out = torch.empty_like(x)
    lib = _dropout_lib()
    keep = float(numpy.float32(1.0 - rate))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if on_device_key:
            if (key.dtype != torch.int32 or key.numel() != 2
                    or not key.is_contiguous()):
                raise ValueError("a key on the card is two contiguous "
                                 "int32 words (got %s %s)"
                                 % (key.dtype, tuple(key.shape)))
            code = lib.dropout_dev_f32(x.data_ptr(), out.data_ptr(),
                                       x.numel(), key.data_ptr(), keep,
                                       offset, stream)
        else:
            k0, k1 = (int(w) for w in _as_key(key))
            code = lib.dropout_f32(x.data_ptr(), out.data_ptr(), x.numel(),
                                   k0, k1, keep, offset, stream)
    if code:
        raise RuntimeError("dropout launch failed: %s"
                           % lib.dropout_error_string(code).decode())
    _count(dropout)
    return out


dropout.launches = 0


def _uniform_ref(key, n, device, offset=0):
    """The float32 uniforms in [0, 1) of flat indices offset..offset+n-1
    under ``key``, on ``device``: jax's partitionable threefry bits, top
    23 bits as the mantissa of a float in [1, 2), minus 1."""
    from veles_tpu_torch import prng
    k0, k1 = (int(w) for w in _as_key(key))
    idx = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    return prng.unit_float_tensor(prng.bits_words(k0, k1, idx))


def bernoulli_ref(key, p):
    """Plain PyTorch version of :func:`bernoulli`: 1.0 where the flat
    index's threefry uniform is below ``p``, else 0.0 (float32, p's
    shape)."""
    u = _uniform_ref(key, p.numel(), p.device).reshape(p.shape)
    return (u < p).to(torch.float32)


def bernoulli(key, p):
    """``jax.random.bernoulli(key, p).astype(float32)`` for a tensor of
    probabilities ``p``, bit for bit: element i is 1.0 where the
    uniform of its flat (row-major) index is below p[i].  ``key`` is a
    (2,) uint32 host key (``veles_tpu_torch.prng``) or an int seed.
    Not a TPU kernel's port: the reference leaves this draw to XLA (the
    RBM's visible binarization and Gibbs samples).

    CPU tensors run :func:`bernoulli_ref`; CUDA tensors launch the
    kernel in ``csrc/dropout.cu`` (fp32, contiguous — anything else
    raises); the key goes by value."""
    if not _on_card(p):
        return bernoulli_ref(key, p)
    if p.dtype != torch.float32:
        raise TypeError("p must be float32 (got %s)" % p.dtype)
    if not p.is_contiguous():
        raise ValueError("p must be contiguous: the flat index is jax's "
                         "row-major counter")
    k0, k1 = (int(w) for w in _as_key(key))
    out = torch.empty_like(p)
    lib = _dropout_lib()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        code = lib.bernoulli_f32(p.data_ptr(), out.data_ptr(), p.numel(),
                                 k0, k1, stream)
    if code:
        raise RuntimeError("bernoulli launch failed: %s"
                           % lib.dropout_error_string(code).decode())
    _count(bernoulli)
    return out


bernoulli.launches = 0


def _sample_rows(logits, seeds, positions):
    """(rows, vocab) of a draw's logits, after the operands' checks."""
    if (seeds is None) != (positions is None):
        raise ValueError("seeds and positions come together (the "
                         "engine's per-row keys) or not at all")
    if logits.dim() < 1 or logits.shape[-1] < 1:
        raise ValueError("logits must end in a vocab axis (got %s)"
                         % (tuple(logits.shape),))
    vocab = logits.shape[-1]
    rows = logits.numel() // vocab
    if seeds is not None and not (seeds.numel() == positions.numel()
                                  == rows):
        raise ValueError("one seed and one position a row: %d rows, %d "
                         "seeds, %d positions"
                         % (rows, seeds.numel(), positions.numel()))
    return rows, vocab


def sample_scores_ref(logits, temperature, key, top_k=0, seeds=None,
                      positions=None):
    """The perturbed scores :func:`sample_token` takes the argmax of,
    (rows, vocab) float32: the keys and bits by ``prng``'s threefry on
    int64 tensors, jax's gumbel draw, plus the logits after the top-k
    mask (against ``torch.topk``'s k-th value) divided by the
    temperature."""
    from veles_tpu_torch import prng
    rows, vocab = _sample_rows(logits, seeds, positions)
    lg = logits.reshape(rows, vocab)
    k0, k1 = (int(w) for w in _as_key(key))
    cols = torch.arange(vocab, dtype=torch.int64, device=lg.device)
    if seeds is None:
        counters = torch.arange(rows, dtype=torch.int64,
                                device=lg.device)[:, None] * vocab + cols
    else:
        k0, k1 = prng.fold_in_words(k0, k1, seeds.reshape(rows))
        k0, k1 = prng.fold_in_words(k0, k1, positions.reshape(rows))
        k0, k1, counters = k0[:, None], k1[:, None], cols[None, :]
    gumbel = prng.gumbel_tensor(prng.bits_words(k0, k1, counters))
    if top_k:
        cut = torch.topk(lg, int(top_k), dim=-1).values[:, -1:]
        lg = torch.where(lg >= cut, lg, NEG_INF)
    # a division by a tensor: a CUDA division by a Python scalar is a
    # multiply by its reciprocal
    scores = lg / torch.full_like(lg, float(numpy.float32(temperature)))
    return gumbel + scores


def sample_token_ref(logits, temperature, key, top_k=0, seeds=None,
                     positions=None):
    """Plain PyTorch version of :func:`sample_token`: ``torch.argmax``
    (the first maximum) of :func:`sample_scores_ref`."""
    scores = sample_scores_ref(logits, temperature, key, top_k, seeds,
                               positions)
    return torch.argmax(scores, dim=-1).to(torch.int32).reshape(
        logits.shape[:-1])


def sample_token(logits, temperature, key, top_k=0, seeds=None,
                 positions=None):
    """One seeded token a row of ``logits`` (..., vocab), as the
    reference's ``sample_token`` / ``_make_sampler`` draw it: the logits
    below the row's ``top_k``-th largest (0: none) set to -1e30, divided
    by ``temperature``, plus jax's gumbel draw, argmax (the first
    maximum).  Returns int32 of the rows' shape.  Not a TPU kernel's
    port: the reference leaves the draw to XLA
    (``jax.random.categorical``).

    Two ways to key it: ``key`` (a (2,) uint32 host key or an int seed)
    alone draws the whole (rows, vocab) array under one key, element
    (r, i) at counter r·vocab + i (``generate``'s mode); with ``seeds``
    and ``positions`` ((rows,) int32 tensors on the logits' device)
    ``key`` is a base key, row r's key is fold_in(fold_in(key, seeds[r]),
    positions[r]) and its counters are 0..vocab-1 (the serving engine's
    mode, its keys made on the device).

    CPU tensors run :func:`sample_token_ref`; CUDA tensors launch the
    kernel in ``csrc/dropout.cu`` (fp32 contiguous logits, int32
    contiguous seeds and positions — anything else raises), after one
    ``torch.topk`` for the k-th value when ``top_k``.  The key and the
    temperature go by value (a captured graph keeps them)."""
    rows, vocab = _sample_rows(logits, seeds, positions)
    if not float(temperature) > 0.0:
        raise ValueError("temperature must be > 0 (got %r): greedy "
                         "decoding is an argmax" % (temperature,))
    top_k = int(top_k or 0)
    if not 0 <= top_k <= vocab:
        raise ValueError("top_k %d out of range (vocab %d)" % (top_k, vocab))
    keyed = () if seeds is None else (seeds, positions)
    if not _on_card(logits, *keyed):
        return sample_token_ref(logits, temperature, key, top_k, seeds,
                                positions)
    if logits.dtype != torch.float32 or not logits.is_contiguous():
        raise ValueError("logits must be contiguous float32 (got %s)"
                         % logits.dtype)
    for t in keyed:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("seeds and positions must be contiguous int32 "
                             "(got %s)" % t.dtype)
    # the k-th value of each row, read in place from topk's output
    top = (torch.topk(logits.view(rows, vocab), top_k, dim=-1).values
           if top_k else None)
    out = _sample_launch(logits, temperature, key, top, seeds, positions)
    _count(sample_token)
    return out


sample_token.launches = 0


def _sample_launch(logits, temperature, key, top, seeds, positions):
    """The draw kernel's launch alone, operands checked by
    :func:`sample_token`: ``top`` is None or the (rows, k) values of
    ``torch.topk`` (the cutoff its last column).  Not counted."""
    vocab = logits.shape[-1]
    rows = logits.numel() // vocab
    k0, k1 = (int(w) for w in _as_key(key))
    out = torch.empty(logits.shape[:-1], dtype=torch.int32,
                      device=logits.device)
    lib = _dropout_lib()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        code = lib.sample_token_f32(
            logits.data_ptr(), rows, vocab,
            None if top is None else top[:, -1:].data_ptr(),
            0 if top is None else top.shape[1],
            float(numpy.float32(temperature)), k0, k1,
            None if seeds is None else seeds.data_ptr(),
            None if positions is None else positions.data_ptr(),
            out.data_ptr(), stream)
    if code:
        raise RuntimeError("sample_token launch failed: %s"
                           % lib.dropout_error_string(code).decode())
    return out

# ---------------------------------------------------- flash attention (train)
def _flash_scale(q, sm_scale):
    """sm_scale as ``flash_attention_tpu`` passes it: float(1 / dh**0.5)
    when None."""
    return float(1.0 / (q.shape[-1] ** 0.5)) if sm_scale is None \
        else float(sm_scale)


def _flash_scores(q, k, causal, sm_scale):
    """s = (q kᵀ)·sm_scale with masked keys at -inf: the bundled
    kernel's causal rule, key c live for query row r when c <= r."""
    s = torch.matmul(q, k.transpose(-1, -2)) * sm_scale
    if causal:
        rows = torch.arange(q.shape[-2], device=q.device)[:, None]
        cols = torch.arange(k.shape[-2], device=q.device)[None, :]
        s = s.masked_fill(cols > rows, float("-inf"))
    return s


def flash_attention_ref(q, k, v, causal=True, sm_scale=None):
    """Plain PyTorch version of :func:`flash_attention_fwd`: returns (o,
    lse) with lse the row's log-sum-exp of the scaled, masked scores (the
    one fp32 residual the backward takes) and o = exp(s - lse)·v."""
    s = _flash_scores(q, k, causal, _flash_scale(q, sm_scale))
    lse = torch.logsumexp(s, dim=-1)
    return torch.matmul(torch.exp(s - lse[..., None]), v), lse


def flash_attention_di(o, do):
    """di = rowsum(o·do) (b, h, sq), the backward's second row residual:
    formed once per backward and handed to both backward kernels, as the
    bundled ``_flash_attention_bwd`` forms it in XLA before either
    ``pallas_call``."""
    return (o * do).sum(dim=-1)


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True, sm_scale=None,
                            di=None):
    """Plain PyTorch version of the two backward kernels, the formulas
    written out: P = exp(s - lse), dP = do vᵀ, di = rowsum(o·do) (unless
    given), dS = P (dP - di), dv = Pᵀ do, dk = sm_scale dSᵀ q, dq =
    sm_scale dS k.  Returns (dq, dk, dv)."""
    scale = _flash_scale(q, sm_scale)
    p = torch.exp(_flash_scores(q, k, causal, scale) - lse[..., None])
    if di is None:
        di = flash_attention_di(o, do)
    ds = p * (torch.matmul(do, v.transpose(-1, -2)) - di[..., None])
    return (torch.matmul(ds, k) * scale,
            torch.matmul(ds.transpose(-1, -2), q) * scale,
            torch.matmul(p.transpose(-1, -2), do))


def _check_flash(q, k, v, o=None, lse=None, do=None, di=None):
    """Shapes (b, h, sq, dh) for q, o and do, (b, h, sk, dh) for k and
    v, (b, h, sq) for lse and di; returns (b·h, sq, sk, dh)."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or q.shape[:2] != k.shape[:2] or q.shape[-1] != k.shape[-1]:
        raise ValueError("q %s, k %s, v %s are not (b, h, s, dh) heads of "
                         "one geometry" % (tuple(q.shape), tuple(k.shape),
                                           tuple(v.shape)))
    for t, want in ((o, q.shape), (do, q.shape), (lse, q.shape[:-1]),
                    (di, q.shape[:-1])):
        if t is not None and t.shape != want:
            raise ValueError("%s does not match q %s"
                             % (tuple(t.shape), tuple(q.shape)))
    b, h, sq, dh = q.shape
    if min(sq, k.shape[2], dh) < 1:
        raise ValueError("empty attention geometry q %s, k %s"
                         % (tuple(q.shape), tuple(k.shape)))
    return b * h, sq, k.shape[2], dh


def _check_flash_operands(**tensors):
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError("%s must be float32 (got %s): other types wait "
                            "for ROADMAP Queue 2a, item 12" % (name, t.dtype))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)


_FLASH_LIB = None


def _flash_lib():
    global _FLASH_LIB
    if _FLASH_LIB is None:
        from veles_tpu_torch.ops import _build
        lib = _build.load("flash_attention")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [i32] * 5 + [f32, ptr]
        lib.flash_attention_fwd_f32.argtypes = [ptr] * 5 + tail
        lib.flash_attention_bwd_dkv_f32.argtypes = [ptr] * 8 + tail
        lib.flash_attention_bwd_dq_f32.argtypes = [ptr] * 7 + tail
        for fn in (lib.flash_attention_fwd_f32,
                   lib.flash_attention_bwd_dkv_f32,
                   lib.flash_attention_bwd_dq_f32):
            fn.restype = i32
        lib.flash_attention_error_string.argtypes = [i32]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _FLASH_LIB = lib
    return _FLASH_LIB


def _flash_launch(what, entry, tensors, geometry, causal, scale):
    lib = _flash_lib()
    device = tensors[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, entry)(*[t.data_ptr() for t in tensors],
                                   *geometry, int(bool(causal)), scale,
                                   stream)
    if code:
        raise RuntimeError("%s launch failed: %s" % (
            what, lib.flash_attention_error_string(code).decode()))


def flash_attention_fwd(q, k, v, causal=True, sm_scale=None):
    """Flash attention forward (kernel 7a): q (b, h, sq, dh), k and v
    (b, h, sk, dh); returns (o (b, h, sq, dh), lse (b, h, sq)).
    ``sm_scale`` None means 1/√dh; ``causal`` masks key c from row r
    when c > r.

    CPU tensors run :func:`flash_attention_ref`; CUDA tensors launch the
    kernel (fp32, contiguous — anything else raises)."""
    geometry = _check_flash(q, k, v)
    scale = _flash_scale(q, sm_scale)
    if not _on_card(q, k, v):
        return flash_attention_ref(q, k, v, causal, scale)
    _check_flash_operands(q=q, k=k, v=v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    _flash_launch("flash_attention_fwd", "flash_attention_fwd_f32",
                  (q, k, v, o, lse), geometry, causal, scale)
    _count(flash_attention_fwd)
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd_dkv(q, k, v, o, lse, do, causal=True, sm_scale=None,
                            di=None):
    """The dK/dV pass of the flash backward (kernel 7b) from the
    forward's inputs, its output o and residual lse, and the cotangent
    do; returns (dk, dv).  ``di`` = :func:`flash_attention_di` (o, do),
    formed here when not given (the kernel reads di, not o).

    CPU tensors run :func:`flash_attention_bwd_ref`; CUDA tensors launch
    the kernel (fp32, contiguous — anything else raises)."""
    geometry = _check_flash(q, k, v, o, lse, do, di)
    scale = _flash_scale(q, sm_scale)
    if not _on_card(*[t for t in (q, k, v, o, lse, do, di)
                      if t is not None]):
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal, scale,
                                       di)[1:]
    if di is None:
        di = flash_attention_di(o, do)
    _check_flash_operands(q=q, k=k, v=v, di=di, lse=lse, do=do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _flash_launch("flash_attention_bwd_dkv", "flash_attention_bwd_dkv_f32",
                  (q, k, v, di, lse, do, dk, dv), geometry, causal, scale)
    _count(flash_attention_bwd_dkv)
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd_dq(q, k, v, o, lse, do, causal=True, sm_scale=None,
                           di=None):
    """The dQ pass of the flash backward (kernel 7c), from the same
    operands as :func:`flash_attention_bwd_dkv`; returns dq.

    CPU tensors run :func:`flash_attention_bwd_ref`; CUDA tensors launch
    the kernel (fp32, contiguous — anything else raises)."""
    geometry = _check_flash(q, k, v, o, lse, do, di)
    scale = _flash_scale(q, sm_scale)
    if not _on_card(*[t for t in (q, k, v, o, lse, do, di)
                      if t is not None]):
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal, scale,
                                       di)[0]
    if di is None:
        di = flash_attention_di(o, do)
    _check_flash_operands(q=q, k=k, v=v, di=di, lse=lse, do=do)
    dq = torch.empty_like(q)
    _flash_launch("flash_attention_bwd_dq", "flash_attention_bwd_dq_f32",
                  (q, k, v, di, lse, do, dq), geometry, causal, scale)
    _count(flash_attention_bwd_dq)
    return dq


flash_attention_bwd_dq.launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: the forward kernel saves (q, k,
    v, o, lse); the backward forms di = rowsum(o·do) once and runs the
    dK/dV and the dQ kernels on it — one launch each.
    ``FlashAttention.apply(q, k, v, causal, sm_scale)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, sm_scale=None):
        o, lse = flash_attention_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.hyper = (causal, sm_scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        di = flash_attention_di(o, do)
        dk, dv = flash_attention_bwd_dkv(q, k, v, o, lse, do, *ctx.hyper,
                                         di=di)
        dq = flash_attention_bwd_dq(q, k, v, o, lse, do, *ctx.hyper, di=di)
        return dq, dk, dv, None, None


_WRAPPERS = (fused_sgd_update, lrn_forward, lrn_backward, dropout,
             bernoulli, sample_token, paged_flash_decode,
             paged_flash_prefill, flash_attention_fwd, flash_attention_bwd_dkv,
             flash_attention_bwd_dq)


def reset_launch_counts():
    """Set every kernel wrapper's ``launches`` to 0."""
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts():
    """{kernel name: launches since the last reset}."""
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


def add_launches(counts):
    """Add ``counts`` ({wrapper: launches}) to the wrappers' counts: the
    launches of one replay of a captured graph, which runs no wrapper."""
    with _COUNT_LOCK:
        for fn, n in counts.items():
            fn.launches += n


__all__ = ["NEG_INF", "serving_kernels_supported", "fused_sgd_update",
           "fused_sgd_update_ref", "fused_sgd_update_multi",
           "fused_sgd_update_multi_ref", "fused_sgd_update_multi_dev",
           "fused_sgd_update_multi_dev_ref", "SGD_MAX_TENSORS", "lrn_forward",
           "lrn_forward_ref",
           "LRN_FORWARD_OP", "lrn_backward", "lrn_backward_ref", "LRN", "LRN_MAX_CHANNELS",
           "dropout", "dropout_ref", "bernoulli", "bernoulli_ref",
           "sample_token", "sample_token_ref", "sample_scores_ref",
           "paged_flash_decode",
           "paged_flash_decode_ref", "decode_splits", "paged_flash_prefill",
           "paged_flash_prefill_ref", "prefill_splits", "split_ranges",
           "paged_flash_prefill_split_ref", "paged_flash_combine_ref",
           "flash_attention_fwd",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
           "flash_attention_ref", "flash_attention_bwd_ref",
           "flash_attention_di",
           "FlashAttention", "reset_launch_counts", "launch_counts",
           "add_launches"]
