"""Ring attention — sequence parallelism over a mesh axis.

Port of ``veles_tpu/parallel/ring.py``.  The sequence axis is split over
the ``seq`` ranks of a ``(data, seq)`` mesh and the batch over its
``data`` ranks; each rank keeps its query block while the key/value
blocks rotate around the ring (rank r sends to r + 1), folded in one at
a time with the online softmax the single-device blockwise attention
uses (``ops.attention._online_update``) under the shared global-position
band (``ops.attention.band_bias``: causal, window, sinks).  A block with
no live (query, key) pair skips the arithmetic, never the rotation.

The reference's products are XLA's, so these are plain PyTorch ops
(cuBLAS on the card); no kernel of its own.  The reference takes its
gradient from JAX's transpose of ``ppermute``; here the ring is one
``torch.autograd.Function`` whose backward runs the steps in reverse
with the reverse rotation: K/V travel back around the ring with their
dK/dV accumulators, each rank adds its block's share (the flash
backward in plain ops: p = exp(s − lse), di = rowsum(o·do)), and after
n rotations each accumulator is home.  Every rank makes the same
rotations; with one rank there is no exchange.
"""

from __future__ import annotations

import numpy
import torch
import torch.distributed as dist

from veles_tpu_torch import parallel
from veles_tpu_torch.ops.attention import (NEG_INF, _online_update,
                                           _sqrt_dh, band_bias)
from veles_tpu_torch.ops.functional import matmul


def make_seq_mesh(n_devices=None, data_parallel=1):
    """(data, seq) mesh: batch over 'data', the sequence ring over
    'seq' (every rank of the joined run must call this); with no joined
    run, this one process."""
    n = n_devices or (dist.get_world_size() if dist.is_initialized()
                      else 1)
    if n % data_parallel:
        raise ValueError("n_devices %d not divisible by data_parallel %d"
                         % (n, data_parallel))
    if not dist.is_initialized():
        if n > 1:
            raise ValueError("requested %d devices, have 1" % n)
        return parallel.Mesh(numpy.zeros((1, 1), int), ("data", "seq"))
    return parallel.make_mesh(n, n // data_parallel,
                              axis_names=("data", "seq"))


def _live(src, s_local, q_first, q_last, window, sinks):
    """Whether key block ``src`` holds a live (query, key) pair for the
    causal queries [q_first, q_last]: k ≤ q and, under a window, q − k <
    W or k a sink — over the block's key span the interval test
    k_first ≤ q_last and (k_last > q_first − W or k_first < sinks)."""
    k_first = src * s_local
    k_last = k_first + s_local - 1
    live = k_first <= q_last
    if window:
        in_band = k_last > q_first - window
        if sinks:
            in_band |= k_first < sinks
        live &= in_band
    return live


def _rotate(tensors, mesh, seq_axis, shift):
    """The tensors one rank on around the seq ring (``shift`` +1: rank r
    sends to r + 1 and receives from r − 1; −1 the reverse)."""
    n = mesh.shape[seq_axis]
    if n == 1:
        return tensors
    axis = mesh.axis_names.index(seq_axis)
    coords = [mesh.index(a) for a in mesh.axis_names]

    def rank(offset):
        at = list(coords)
        at[axis] = (at[axis] + offset) % n
        return int(mesh.devices[tuple(at)])

    return parallel.p2p_exchange(tensors, rank(shift), tensors,
                                 rank(-shift), mesh.group(seq_axis))


class _Ring(torch.autograd.Function):
    """The ring over local blocks: forward keeps the output and each
    row's log-sum-exp; backward is the reverse ring."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, seq_axis, causal, window, sinks):
        n = mesh.shape[seq_axis]
        index = mesh.index(seq_axis)
        s_local = q.shape[-2]
        q_pos = index * s_local + torch.arange(s_local, device=q.device)
        carry = (torch.zeros_like(q), q[..., 0] * 0.0,
                 q[..., 0] * 0.0 + NEG_INF)
        kv, live = (k, v), []
        for step in range(n):
            src = (index - step) % n
            on = (not causal or _live(src, s_local, index * s_local,
                                      index * s_local + s_local - 1,
                                      window, sinks))
            if on:
                bias = (band_bias(q_pos, src * s_local + torch.arange(
                    s_local, device=q.device), causal, window, q.dtype,
                    sinks=sinks) if causal else None)
                carry = _online_update(carry, q, kv[0], kv[1], bias)
            live.append(on)
            if step < n - 1:
                kv = tuple(_rotate(list(kv), mesh, seq_axis, 1))
        o, l, m = carry
        out = o / l[..., None]
        ring_attention_local.counts = {"attends": sum(live),
                                       "skipped": n - sum(live)}
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.ring = (mesh, seq_axis, causal, window, sinks, live)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, seq_axis, causal, window, sinks, live = ctx.ring
        n = mesh.shape[seq_axis]
        index = mesh.index(seq_axis)
        s_local = q.shape[-2]
        q_pos = index * s_local + torch.arange(s_local, device=q.device)
        do = do.contiguous()
        di = (out * do).sum(dim=-1)
        dq = torch.zeros_like(q)
        held = [k, v, torch.zeros_like(k), torch.zeros_like(v)]
        for step in reversed(range(n)):
            held = _rotate(held, mesh, seq_axis, -1)
            if not live[step]:
                continue
            src = (index - step) % n
            k_blk, v_blk, dk, dv = held
            s = matmul(q, k_blk.transpose(-1, -2)) / _sqrt_dh(q)
            if causal:
                s = s + band_bias(q_pos, src * s_local + torch.arange(
                    s_local, device=q.device), causal, window, q.dtype,
                    sinks=sinks)
            p = torch.exp(s - lse[..., None])
            dv += matmul(p.transpose(-1, -2), do)
            ds = p * (matmul(do, v_blk.transpose(-1, -2)) - di[..., None])
            dq += matmul(ds, k_blk) / _sqrt_dh(q)
            dk += matmul(ds.transpose(-1, -2), q) / _sqrt_dh(q)
        return dq, held[2], held[3], None, None, None, None, None


def ring_attention_local(q, k, v, mesh, causal=True, seq_axis="seq",
                         window=None, sinks=0):
    """The per-rank ring: q, k, v are this rank's LOCAL sequence blocks
    (batch, heads, s_local, head_dim); returns its output block.
    ``ring_attention_local.counts`` holds the last call's attends and
    the ones the early exit skipped."""
    if window and not causal:
        raise ValueError("window requires causal=True")
    return _Ring.apply(q, k, v, mesh, seq_axis, causal, window, sinks)


ring_attention_local.counts = {"attends": 0, "skipped": 0}


class _Blocks(torch.autograd.Function):
    """Global tensors in, this rank's (data, seq) blocks out; the
    backward sums every rank's zero-padded block gradients, so each rank
    holds the global gradient."""

    @staticmethod
    def forward(ctx, mesh, axes, *tensors):
        ctx.mesh, ctx.axes, ctx.shape = mesh, axes, tensors[0].shape
        return tuple(_block(t, mesh, axes).contiguous() for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        out = []
        for g in grads:
            full = g.new_zeros(ctx.shape)
            _block(full, ctx.mesh, ctx.axes).copy_(g)
            for axis in ctx.axes:
                if ctx.mesh.shape[axis] > 1:
                    parallel.ring_input_grad_all_reduce(
                        full, ctx.mesh.group(axis))
            out.append(full)
        return (None, None) + tuple(out)


class _Gather(torch.autograd.Function):
    """This rank's output block in, the global output out (gathered over
    the seq then the data ranks); the backward takes the rank's own
    slice of the cotangent (the loss is replicated: no sum)."""

    @staticmethod
    def forward(ctx, block, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        out = block
        for axis, dim in zip(reversed(axes), (2, 0)):
            parts = mesh.shape[axis]
            if parts > 1:
                out = parallel.ring_all_gather(out, mesh.group(axis), parts,
                                               dim)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _block(grad, ctx.mesh, ctx.axes).contiguous(), None, None


def _block(t, mesh, axes):
    """This rank's (data, seq) block of a global (batch, heads, seq,
    head_dim) tensor: a view."""
    data_axis, seq_axis = axes
    nb, ns = mesh.shape[data_axis], mesh.shape[seq_axis]
    b, s = t.shape[0] // nb, t.shape[2] // ns
    i, j = mesh.index(data_axis), mesh.index(seq_axis)
    return t[i * b:(i + 1) * b, :, j * s:(j + 1) * s]


def ring_attention(q, k, v, mesh, causal=True, seq_axis="seq",
                   data_axis="data", window=None, sinks=0):
    """Sequence-parallel attention over ``mesh``: q, k, v (batch, heads,
    seq, head_dim) GLOBAL tensors (the same on every rank), the global
    output back on every rank.  Equals dense ``attention(q, k, v,
    causal, window=window, sinks=sinks)`` up to roundoff; steps whose
    whole key block is outside the band skip the arithmetic."""
    if window and not causal:
        raise ValueError("window requires causal=True")
    axes = (data_axis, seq_axis)
    for dim, axis in ((0, data_axis), (2, seq_axis)):
        if q.shape[dim] % mesh.shape[axis]:
            raise ValueError("%s %d not divisible by mesh axis %r (%d)"
                             % (("batch", None, "seq")[dim], q.shape[dim],
                                axis, mesh.shape[axis]))
    ql, kl, vl = _Blocks.apply(mesh, axes, q, k, v)
    out = ring_attention_local(ql, kl, vl, mesh, causal, seq_axis, window,
                               sinks)
    return _Gather.apply(out, mesh, axes)
