"""Transformer language model — the paged serving subset.

Port of ``veles_tpu/ops/transformer.py``: host-side init (bit-equal to
the reference for the same prng stream), the decoder block over the
paged KV pool, and :class:`TransformerLM`, an ``nn.Module`` holding the
weights under the reference tree's names and layouts (``wq`` is
(d_model, d_model) used as ``x @ w`` — no transposes), so a param tree
exported by the JAX package (nested dicts of numpy arrays) loads with
:func:`params_from_jax` / :meth:`TransformerLM.from_jax`.

The functions take the weights as a nested dict of tensors (the
reference's pytree), which :meth:`TransformerLM.tree` returns.
"""

from __future__ import annotations

import numpy
import torch
from torch import nn

from veles_tpu_torch.device import resolve_device
from veles_tpu_torch.ops.attention import (init_mha_params,
                                           mha_paged_chunk_step)
from veles_tpu_torch.ops.functional import matmul


def init_transformer_params(stream, vocab, d_model=64, n_heads=4,
                            n_layers=2, d_ff=None, max_len=512,
                            dtype="float32", n_experts=0,
                            n_kv_heads=None, rope=False):
    """Host (numpy) param tree drawn from ``stream`` in the reference's
    order — the same stream state gives bit-equal weights in both
    packages.  ``n_kv_heads`` < n_heads makes attention grouped-query;
    ``rope=True`` drops the learned positional table."""
    if n_experts > 0:
        raise NotImplementedError(
            "mixture-of-experts FFN (n_experts > 0) waits for the "
            "transformer training slice (ROADMAP Queue 2, item 3)")
    d_ff = d_ff or 4 * d_model
    s_emb = d_model ** -0.5

    def dense(n_in, n_out):
        w = numpy.zeros((n_in, n_out), dtype)
        stream.fill(w, -(6.0 / (n_in + n_out)) ** 0.5,
                    (6.0 / (n_in + n_out)) ** 0.5)
        return w

    embed = numpy.zeros((vocab, d_model), dtype)
    stream.fill_normal(embed, 0.0, s_emb)
    pos = None
    if not rope:
        pos = numpy.zeros((max_len, d_model), dtype)
        stream.fill_normal(pos, 0.0, s_emb)
    blocks = []
    for _ in range(n_layers):
        blk = {
            "attn": init_mha_params(stream, d_model, n_heads, dtype,
                                    n_kv_heads=n_kv_heads),
            "ln1": {"g": numpy.ones(d_model, dtype),
                    "b": numpy.zeros(d_model, dtype)},
            "ln2": {"g": numpy.ones(d_model, dtype),
                    "b": numpy.zeros(d_model, dtype)},
        }
        blk.update({
            "w1": dense(d_model, d_ff),
            "b1": numpy.zeros(d_ff, dtype),
            "w2": dense(d_ff, d_model),
            "b2": numpy.zeros(d_model, dtype),
        })
        blocks.append(blk)
    out = {"embed": embed, "blocks": blocks,
           "ln_f": {"g": numpy.ones(d_model, dtype),
                    "b": numpy.zeros(d_model, dtype)}}
    if pos is not None:
        out["pos"] = pos
    return out


def _layernorm(x, g, b, eps=1e-5):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * g + b


def _block_ffn(blk, hn):
    """The dense FFN half of a block."""
    if "moe" in blk:
        raise NotImplementedError(
            "mixture-of-experts blocks wait for the transformer training "
            "slice (ROADMAP Queue 2, item 3)")
    ff = torch.clamp_min(matmul(hn, blk["w1"]) + blk["b1"], 0.0)
    return matmul(ff, blk["w2"]) + blk["b2"]


def head_logits(params, h):
    """Final LN + tied output head over block-stack activations."""
    h = _layernorm(h, params["ln_f"]["g"], params["ln_f"]["b"])
    return matmul(h, params["embed"].T)


def block_paged_chunk_step(blk, h, k_pool, v_pool, ptab, pos, n_heads,
                           rope=False, window=None, sinks=0,
                           attn_kernel=None):
    """One block (pre-LN attention + FFN with residuals) over ``c``
    positions per lane against the PAGED KV pool (pools written in
    place).  ``attn_kernel`` (None | 'decode' | 'prefill') routes the
    attention through the Hopper kernels."""
    hn = _layernorm(h, blk["ln1"]["g"], blk["ln1"]["b"])
    attn, k_pool, v_pool = mha_paged_chunk_step(
        blk["attn"], hn, k_pool, v_pool, ptab, pos, n_heads, rope=rope,
        window=window, sinks=sinks, attn_kernel=attn_kernel)
    h = h + attn
    hn = _layernorm(h, blk["ln2"]["g"], blk["ln2"]["b"])
    return h + _block_ffn(blk, hn), k_pool, v_pool


def paged_chunk_embed(params, tokens, pos):
    """Token (+ learned positional, absent under RoPE) embedding for
    ``c`` positions per lane starting at per-lane ``pos`` (b,).
    Positional rows are clipped at the table edge — only a tail chunk's
    pad positions could pass it, and their outputs are never read."""
    c = tokens.shape[1]
    h = params["embed"][tokens.long()]
    if "pos" in params:
        table = params["pos"]
        idx = pos.long()[:, None] + torch.arange(c, device=tokens.device)
        h = h + table[idx.clamp(max=table.shape[0] - 1)]
    return h


def paged_chunk_apply(params, tokens, pools, ptab, pos, n_heads,
                      rope=False, window=None, sinks=0, attn_kernel=None):
    """Run ``c`` consecutive tokens PER LANE through the whole stack
    against the paged KV pools in one pass.

    tokens: (b, c) int; pools: per-block [(k_pool, v_pool)], each
    (n_pages, kv_heads, page, head_dim); ptab: (b, m) int32; pos: (b,)
    int32.  Returns (h (b, c, d), pools) with each lane's K/V written
    through its table at [pos, pos+c) — in place.  Serves the prompt
    chunk (b=1, c=chunk) and the decode step (c=1, b=slots)."""
    h = paged_chunk_embed(params, tokens, pos)
    for blk, (kp, vp) in zip(params["blocks"], pools):
        h, _, _ = block_paged_chunk_step(blk, h, kp, vp, ptab, pos,
                                         n_heads, rope=rope, window=window,
                                         sinks=sinks,
                                         attn_kernel=attn_kernel)
    return h, pools


# ------------------------------------------------------------------ module
def _leaf(value, device):
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return torch.as_tensor(numpy.asarray(value), device=device)


def params_from_jax(tree, device=None):
    """The reference's portable param tree (nested dicts/lists of numpy
    arrays — what the JAX ``LMEngine`` takes) as the same tree of
    tensors on ``device`` (None = the CUDA card; raises without one).
    Layouts and dtypes are kept as they are; tensor leaves are moved
    (not copied when already there)."""
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return _leaf(node, device)

    return conv(tree)


def _populate(mod, node):
    """Mirror one dict level of a param tree onto ``mod``: tensors become
    frozen Parameters, dicts submodules, block lists a ModuleList."""
    for key, value in node.items():
        if isinstance(value, dict):
            mod.add_module(key, _populate(nn.Module(), value))
        elif isinstance(value, (list, tuple)):
            mod.add_module(key, nn.ModuleList(
                _populate(nn.Module(), v) for v in value))
        else:
            mod.register_parameter(
                key, nn.Parameter(value, requires_grad=False))
    return mod


def _tree_of(mod):
    out = {name: p for name, p in mod.named_parameters(recurse=False)}
    for name, child in mod.named_children():
        out[name] = ([_tree_of(c) for c in child]
                     if isinstance(child, nn.ModuleList) else _tree_of(child))
    return out


class TransformerLM(nn.Module):
    """The decoder-only LM's weights as an ``nn.Module`` whose
    parameters carry the reference tree's names (``embed``, ``pos``,
    ``blocks.<i>.attn.wq``, ``ln_f.g``, ...) in the reference's layouts.
    Inference-only: the parameters do not require grad.  The serving
    functions take :meth:`tree`."""

    def __init__(self, tree):
        super().__init__()
        _populate(self, tree)

    @classmethod
    def from_jax(cls, tree, device=None):
        """Build from the reference's portable numpy tree on ``device``
        (None = the CUDA card; raises without one)."""
        return cls(params_from_jax(tree, device))

    def tree(self):
        """The weights as the reference's nested dict (the tensors
        themselves, not copies)."""
        return _tree_of(self)
