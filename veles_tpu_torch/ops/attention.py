"""Attention ops — training, KV-cached decoding and paged serving.

Port of ``veles_tpu/ops/attention.py``: dense ``attention`` and the
flash-style ``blockwise_attention`` (both masked through the one
``band_bias``), :func:`flash_attention` through the Hopper kernels,
rotary embeddings (half-split "NeoX" layout), grouped-query helpers,
``mha_forward`` with its attention-backend flag, the linear-cache decode
step and its ring-buffer sibling (``rolling_slot_update``,
``mha_decode_step_rolling``), the paged KV view/write and :func:`mha_paged_chunk_step`, the one
attention core of every paged serving program (decode step, prompt
chunk).

PyTorch idiom: functions on tensors in the reference's layouts
(activations (b, c, d_model), heads (b, h, c, head_dim), pools
(n_pages, kv_heads, page, head_dim)).  Where the reference returned an
updated pool from a functional ``.at[].set``, the port writes the pool
IN PLACE and returns the same tensor, so call sites read alike.
"""

from __future__ import annotations

import torch

from veles_tpu_torch.ops.functional import matmul

NEG_INF = -1e30


def _sqrt_dh(q):
    """√head_dim as a 0-dim tensor: dividing by it is a true division on
    every device, as the reference's ``/ jnp.sqrt(dh)``."""
    return torch.sqrt(torch.tensor(q.shape[-1], dtype=q.dtype))


def attention(q, k, v, causal=False, bias=None, window=None, sinks=0):
    """Dense scaled-dot-product attention over (..., heads, seq,
    head_dim); returns q's shape.  ``window=W`` restricts each query to
    the last W keys and requires causal=True."""
    if window and not causal:
        raise ValueError("window requires causal=True")
    scores = matmul(q, k.transpose(-1, -2)) / _sqrt_dh(q)
    if bias is not None:
        scores = scores + bias
    if causal or window:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        scores = scores + band_bias(
            torch.arange(s_q, device=q.device) + (s_k - s_q),
            torch.arange(s_k, device=q.device), causal, window,
            scores.dtype, sinks=sinks)
    return matmul(torch.softmax(scores, dim=-1), v)


# ----------------------------------------------------------------- rotary
def rope_rotate(x, positions, theta=10000.0):
    """Rotary position embedding over (..., seq, head_dim): feature
    pairs (i, i + head_dim/2) — the half-split ("NeoX") layout, not the
    interleaved even/odd pairing — rotated by position-dependent angles.
    ``positions``: (seq,) int tensor."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=x.dtype,
                                    device=x.device) / half)
    ang = positions.to(x.dtype)[:, None] * freqs[None, :]   # (s, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def rope_rotate_batched(x, positions, theta=10000.0):
    """:func:`rope_rotate` with PER-SEQUENCE positions: x
    (batch, heads, c, head_dim), ``positions`` (batch, c) — each batch
    row rotated at its own positions (every paged lane sits at its own
    depth).  The same math with the batch axis written out."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=x.dtype,
                                    device=x.device) / half)
    ang = positions.to(x.dtype)[:, :, None] * freqs    # (b, c, half)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def band_bias(q_pos, k_pos, causal, window, dtype, sinks=0):
    """Additive score bias for the global-position causal/sliding-window
    band — THE shared mask every decomposition applies.  ``sinks=K``
    keeps the first K positions attendable regardless of the window
    (never regardless of causality)."""
    allowed = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                         device=q_pos.device)
    if causal:
        allowed &= q_pos[:, None] >= k_pos[None, :]
    if window:
        in_window = q_pos[:, None] - k_pos[None, :] < window
        if sinks:
            in_window |= (k_pos < sinks)[None, :]
        allowed &= in_window
    return torch.where(allowed, 0.0, NEG_INF).to(dtype)


def chunk_live_mask(pos, c, cache_len, window=None, sinks=0):
    """(..., c, cache_len) bool mask for ``c`` query positions starting
    at ``pos`` (an int, or a tensor of per-lane starts — the leading
    dims) attending a linear cache; the window/sink rules of
    :func:`band_bias`."""
    pos = torch.as_tensor(pos)
    q_pos = pos[..., None] + torch.arange(c, device=pos.device)
    idx = torch.arange(cache_len, device=pos.device)
    live = idx <= q_pos[..., None]
    if window:
        in_window = idx > q_pos[..., None] - window
        if sinks:
            in_window |= idx < sinks
        live &= in_window
    return live


def _online_update(carry, q, k, v, score_bias):
    """One online-softmax accumulation step: carry (o, l, m) with o
    (..., sq, dh) and l, m (..., sq); returns the carry after this
    key/value block."""
    o, l, m = carry
    s = matmul(q, k.transpose(-1, -2)) / _sqrt_dh(q)
    if score_bias is not None:
        s = s + score_bias
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha[..., None] + matmul(p.to(v.dtype), v)
    return o_new, l_new, m_new


def blockwise_attention(q, k, v, block_size=128, causal=False,
                        window=None, sinks=0):
    """Flash-style attention as a loop over key/value blocks with the
    online softmax — equal to :func:`attention` up to roundoff, O(block)
    live scores.  NEG_INF is finite, so a fully masked early block's
    transient terms rescale to 0 once a live block arrives."""
    if window and not causal:
        raise ValueError("window requires causal=True")
    s_q, s_k = q.shape[-2], k.shape[-2]
    if s_k % block_size:
        raise ValueError("seq %d not divisible by block %d"
                         % (s_k, block_size))
    q_pos = torch.arange(s_q, device=q.device) + (s_k - s_q)
    carry = (torch.zeros_like(q),
             torch.zeros(q.shape[:-1], dtype=q.dtype, device=q.device),
             torch.full(q.shape[:-1], NEG_INF, dtype=q.dtype,
                        device=q.device))
    for start in range(0, s_k, block_size):
        bias = None
        if causal:
            bias = band_bias(q_pos, torch.arange(start, start + block_size,
                                                 device=q.device),
                             causal, window, q.dtype, sinks=sinks)
        carry = _online_update(carry, q, k[..., start:start + block_size, :],
                               v[..., start:start + block_size, :], bias)
    o, l, _ = carry
    return o / l[..., None]


def flash_attention(q, k, v, causal=True):
    """Flash attention through the Hopper kernels (the counterpart of the
    reference's ``flash_attention_tpu``): (b, h, s, dh) contiguous fp32
    in and out, sm_scale = float(1/√dh) as that function passes it.
    Differentiable: the backward is the kernels' dK/dV and dQ passes.
    CPU tensors run the kernels' plain versions."""
    from veles_tpu_torch.ops import hopper_kernels as HK
    dh = q.shape[-1]
    return HK.FlashAttention.apply(q, k, v, causal, float(1.0 / (dh ** 0.5)))


#: attention backend for mha_forward's non-windowed path: 'xla' (dense
#: ``attention`` or ``blockwise_attention``) | 'flash_pallas' (the
#: reference's name for its bundled flash kernel; here the Hopper kernels
#: of :func:`flash_attention`) | 'flash_serve' ('xla' for mha_forward;
#: serving engines built while it is set ask for their kernels)
_ATTN_BACKEND = "xla"


def set_attention_backend(mode):
    """mode: 'xla' | 'flash_pallas' | 'flash_serve' — read at every
    ``mha_forward`` call (PyTorch has no trace to clear)."""
    global _ATTN_BACKEND
    if mode not in ("xla", "flash_pallas", "flash_serve"):
        raise ValueError("unknown attention backend %r" % (mode,))
    _ATTN_BACKEND = mode


def serving_kernel_default():
    """True when the global backend is 'flash_serve'."""
    return _ATTN_BACKEND == "flash_serve"


# ------------------------------------------------------------ MHA helpers
def init_mha_params(stream, d_model, n_heads, dtype="float32",
                    n_kv_heads=None):
    """Host (numpy) params for one multi-head attention layer
    (wq/wk/wv/wo, each used as ``x @ w``), drawn from ``stream`` in the
    reference's order.  ``n_kv_heads < n_heads`` is grouped-query
    attention: wk/wv project to n_kv_heads·head_dim features."""
    import numpy
    kv = n_kv_heads or n_heads
    if n_heads % kv:
        raise ValueError("n_kv_heads %d must divide n_heads %d"
                         % (kv, n_heads))
    d_kv = d_model // n_heads * kv
    s = (6.0 / (2 * d_model)) ** 0.5

    def mk(n_out=d_model):
        w = numpy.zeros((d_model, n_out), dtype)
        stream.fill(w, -s, s)
        return w

    return {"wq": mk(), "wk": mk(d_kv), "wv": mk(d_kv), "wo": mk()}


def kv_heads_of(params, n_heads, d_model):
    """Number of key/value heads, inferred from wk's width (GQA-aware)."""
    return params["wk"].shape[-1] // (d_model // n_heads)


def _repeat_kv(k, n_heads):
    """Broadcast n_kv_heads → n_heads along the head axis (GQA share):
    kv head j serves query heads j·g .. j·g + g - 1."""
    reps = n_heads // k.shape[-3]
    return k if reps == 1 else torch.repeat_interleave(k, reps, dim=-3)


def mha_forward(params, x, n_heads, causal=True, block_size=None,
                return_kv=False, rope=False, window=None,
                positions=None, sinks=0):
    """Multi-head attention over (batch, seq, d_model).  ``return_kv``
    also returns the projected (k, v) heads (n_kv_heads wide under
    GQA); ``rope`` rotates q/k at ``positions`` (default 0..s-1);
    ``window`` restricts attention to the last W positions.  Under
    'flash_pallas' a non-windowed call goes through
    :func:`flash_attention`; otherwise ``block_size`` picks
    :func:`blockwise_attention`, else :func:`attention`."""
    b, s, d = x.shape
    dh = d // n_heads
    kv = kv_heads_of(params, n_heads, d)

    def split(w, heads):
        return matmul(x, w).reshape(b, s, heads, dh).transpose(1, 2)

    q = split(params["wq"], n_heads)
    k = split(params["wk"], kv)
    v = split(params["wv"], kv)
    if rope:
        pos = positions if positions is not None \
            else torch.arange(s, device=x.device)
        q, k = rope_rotate(q, pos), rope_rotate(k, pos)
    kr, vr = _repeat_kv(k, n_heads), _repeat_kv(v, n_heads)
    if _ATTN_BACKEND == "flash_pallas" and not window:
        o = flash_attention(q.contiguous(), kr.contiguous(),
                            vr.contiguous(), causal=causal)
    elif block_size:
        o = blockwise_attention(q, kr, vr, block_size, causal=causal,
                                window=window, sinks=sinks)
    else:
        o = attention(q, kr, vr, causal=causal, window=window, sinks=sinks)
    o = o.transpose(1, 2).reshape(b, s, d)
    out = matmul(o, params["wo"])
    return (out, k, v) if return_kv else out


def _decode_attend(params, x, k_cache, v_cache, write_idx, live, rope_pos,
                   n_heads):
    """The decode-step core: project q/k/v for one position, rotate q/k
    at ``rope_pos`` (None = no rope), write the new k/v at cache index
    ``write_idx`` IN PLACE, attend over the cache under the ``live``
    mask (cache_len,), and project out.  Returns (out, k_cache,
    v_cache)."""
    b, _, d = x.shape
    dh = d // n_heads
    kv = kv_heads_of(params, n_heads, d)

    def split(w, heads):
        return matmul(x, w).reshape(b, 1, heads, dh).transpose(1, 2)

    q = split(params["wq"], n_heads)            # (b, h, 1, dh)
    k_new = split(params["wk"], kv)
    if rope_pos is not None:
        pos_arr = (rope_pos if torch.is_tensor(rope_pos)
                   else torch.tensor([int(rope_pos)], device=x.device))
        q = rope_rotate(q, pos_arr)
        k_new = rope_rotate(k_new, pos_arr)
    k_cache[:, :, write_idx:write_idx + 1] = k_new
    v_cache[:, :, write_idx:write_idx + 1] = split(params["wv"], kv)
    scores = matmul(q, _repeat_kv(k_cache, n_heads).transpose(-1, -2)) \
        / _sqrt_dh(q)                    # (b, h, 1, cache_len)
    scores = torch.where(live, scores, NEG_INF)
    o = matmul(torch.softmax(scores, dim=-1), _repeat_kv(v_cache, n_heads))
    o = o.transpose(1, 2).reshape(b, 1, d)
    return matmul(o, params["wo"]), k_cache, v_cache


def mha_decode_step(params, x, k_cache, v_cache, pos, n_heads, rope=False,
                    window=None, sinks=0):
    """One autoregressive decode step: x (batch, 1, d_model) at position
    ``pos`` (a host int) against caches (batch, kv_heads, max_len,
    head_dim) holding positions [0, pos).  Writes position ``pos`` into
    the caches IN PLACE and returns (out, k_cache, v_cache).  The caller
    keeps ``pos < max_len``."""
    idx = torch.arange(k_cache.shape[2], device=x.device)
    live = idx <= pos
    if window:
        in_window = idx > pos - window
        if sinks:
            in_window |= idx < sinks
        live &= in_window
    return _decode_attend(params, x, k_cache, v_cache, pos, live,
                          pos if rope else None, n_heads)


def rolling_slot_update(slot_pos, pos, window, sinks=0):
    """Ring-buffer bookkeeping for one decode step, computed once a step
    and shared by every block (they all write the same slot).  Cache
    layout: ``sinks`` PINNED slots (positions 0..sinks-1, never
    evicted) followed by a ``window``-slot ring where position
    p >= sinks lands in slot sinks + (p - sinks) % window.
    ``slot_pos`` (sinks + window,) int32 on the cache's device holds the
    absolute position in each slot (-1: never written) and is updated
    IN PLACE.  ``pos`` is a host int, so the write slot is computed on
    the host and nothing is read back from the device.  Returns (write
    slot, slot_pos, live mask): a slot is live iff it holds a real
    position <= pos that is a sink or inside the window."""
    pos = int(pos)
    slot = pos if pos < sinks else sinks + (pos - sinks) % window
    slot_pos[slot] = pos
    live = (slot_pos >= 0) & (slot_pos <= pos)
    in_window = slot_pos > pos - window
    if sinks:
        in_window |= slot_pos < sinks
    return slot, slot_pos, live & in_window


def mha_decode_step_rolling(params, x, k_cache, v_cache, slot, live, pos,
                            n_heads):
    """One decode step against a RING-BUFFER KV cache (batch, kv_heads,
    sinks + window, head_dim): the core of :func:`mha_decode_step`,
    writing position ``pos`` at the host int ``slot`` IN PLACE and
    attending under ``live`` (both from :func:`rolling_slot_update`).
    q/k rotate at the ABSOLUTE position ``pos`` — a host int, or a (1,)
    int tensor on x's device, which spares the upload — never at the
    slot.  Returns (out, k_cache, v_cache)."""
    return _decode_attend(params, x, k_cache, v_cache, slot, live, pos,
                          n_heads)


# ------------------------------------------------------------- paged KV
def paged_view(pool, ptab):
    """Gather lanes' LINEAR cache views out of the shared page pool.

    pool: (n_pages, kv_heads, page, head_dim); ptab: (..., m) int page
    tables.  Returns (..., kv_heads, m·page, head_dim) — the array a
    contiguous per-lane cache would hold.  Entries past a lane's pages
    point at the scratch page; the caller's live mask covers them."""
    g = pool[ptab.long()]                    # (..., m, kv, page, dh)
    g = g.movedim(-4, -3)                    # (..., kv, m, page, dh)
    return g.reshape(g.shape[:-3] + (g.shape[-3] * g.shape[-2],
                                     g.shape[-1]))


def paged_write(pool, ptab, pos, rows, write_mask=None):
    """Write ``c`` new K (or V) rows into the pool at the lanes' LINEAR
    positions [pos, pos+c), IN PLACE; returns ``pool``.

    rows: (..., kv_heads, c, head_dim); ptab (..., m); pos (...,) — a
    tensor on the pool's device (a host value would be uploaded, which a
    captured graph cannot do).  Position p maps to (page ptab[p //
    page], offset p % page), so a write may straddle two pages.
    Duplicate targets (free lanes all park on the scratch page) are
    resolved arbitrarily — only garbage rows collide.  Indices must lie
    inside the table: torch raises where the reference's gather
    silently fills (the engine's live-width ladder keeps every write
    inside).

    ``write_mask`` ((...,) bool, one per lane) sends a masked-out lane's
    whole write to the scratch page (pool row 0,
    ``KVPagePool.SCRATCH``): the decode megastep keeps its finished
    lanes in the batched program, and their writes must not touch an
    allocated page, whatever position their frozen carry holds."""
    page = pool.shape[2]
    c = rows.shape[-2]
    linear = torch.as_tensor(pos, device=pool.device).long()[..., None] \
        + torch.arange(c, device=pool.device)
    page_ids = torch.gather(ptab.long(), -1, linear // page)
    if write_mask is not None:
        page_ids = torch.where(write_mask[..., None], page_ids, 0)
    offsets = linear % page
    # advanced indices split by the head slice: index dims move to the
    # front (numpy rules), so the update is (..., c, kv, dh)
    pool[page_ids, :, offsets, :] = rows.movedim(-3, -2)
    return pool


def mha_paged_chunk_step(params, x, k_pool, v_pool, ptab, pos, n_heads,
                         rope=False, window=None, sinks=0,
                         attn_kernel=None, write_mask=None):
    """``c`` positions per lane against the PAGED KV pool in one pass.

    x: (b, c, d_model) — b lanes' activations for positions
    [pos[i], pos[i]+c); k_pool/v_pool: (n_pages, kv_heads, page,
    head_dim) shared across lanes; ptab: (b, m) int32 page tables; pos:
    (b,) int32.  Writes the c new K/V rows through the tables (pools
    mutated in place) and attends each lane's query j causally over its
    own linear view (window/sinks as :func:`chunk_live_mask`).  c=1 is
    the decode step, b=1 with c=chunk the prompt chunk.

    ``attn_kernel`` routes the attention through the Hopper kernels
    instead of the gather + dense softmax: 'decode' (pool written
    first, then ``hopper_kernels.paged_flash_decode`` walks the table)
    or 'prefill' (c must equal the page size and ``pos`` be
    page-aligned; ``paged_flash_prefill`` attends the history and
    installs the chunk's rows).  None = the plain path.  Returns
    (out (b, c, d_model), k_pool, v_pool).

    ``write_mask`` ((b,) bool) sends masked lanes' K/V writes to the
    scratch page (:func:`paged_write`); their attention still runs and
    its output is discarded.  The 'prefill' route takes no mask (its
    fused install has no slot for one; the megastep never runs it)."""
    b, c, d = x.shape
    dh = d // n_heads
    kv = kv_heads_of(params, n_heads, d)

    def split(w, heads):
        return matmul(x, w).reshape(b, c, heads, dh).transpose(1, 2)

    q = split(params["wq"], n_heads)            # (b, h, c, dh)
    k_new = split(params["wk"], kv)
    v_new = split(params["wv"], kv)
    if rope:
        positions = pos.long()[:, None] \
            + torch.arange(c, device=x.device)                  # (b, c)
        q = rope_rotate_batched(q, positions)
        k_new = rope_rotate_batched(k_new, positions)
    if attn_kernel:
        from veles_tpu_torch.ops import hopper_kernels as HK
        q = q.contiguous()
        if attn_kernel == "prefill":
            if write_mask is not None:
                raise ValueError("write_mask is not supported with "
                                 "attn_kernel='prefill' (fused install)")
            o, k_pool, v_pool = HK.paged_flash_prefill(
                q, k_new.contiguous(), v_new.contiguous(), k_pool, v_pool,
                ptab, pos, window=window, sinks=sinks)
        elif attn_kernel == "decode":
            paged_write(k_pool, ptab, pos, k_new, write_mask)
            paged_write(v_pool, ptab, pos, v_new, write_mask)
            o = HK.paged_flash_decode(q, k_pool, v_pool, ptab, pos,
                                      window=window, sinks=sinks)
        else:
            raise ValueError("attn_kernel must be None, 'decode' or "
                             "'prefill' (got %r)" % (attn_kernel,))
        o = o.transpose(1, 2).reshape(b, c, d)
        return matmul(o, params["wo"]), k_pool, v_pool
    paged_write(k_pool, ptab, pos, k_new, write_mask)
    paged_write(v_pool, ptab, pos, v_new, write_mask)
    kx = paged_view(k_pool, ptab)               # (b, kv, L, dh)
    vx = paged_view(v_pool, ptab)
    scores = matmul(q, _repeat_kv(kx, n_heads).transpose(-1, -2)) \
        / torch.sqrt(torch.tensor(dh, dtype=q.dtype))     # (b, h, c, L)
    live = chunk_live_mask(pos.long(), c, kx.shape[-2], window, sinks)
    scores = torch.where(live[:, None], scores, NEG_INF)
    o = matmul(torch.softmax(scores, dim=-1), _repeat_kv(vx, n_heads))
    o = o.transpose(1, 2).reshape(b, c, d)
    return matmul(o, params["wo"]), k_pool, v_pool
