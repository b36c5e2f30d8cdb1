"""Transformer language model: training, decoding (greedy or seeded
sampling) and paged serving.

Port of ``veles_tpu/ops/transformer.py``: host-side init (bit-equal to
the reference for the same prng stream); the training forward
(``transformer_forward``, ``lm_loss``, with top-1-routed mixture-of-
experts blocks and their load-balancing term, ``ops/moe.py``) and the
Adam step; KV-cached
``generate`` (greedy, or temperature / top-k sampling through the draw
kernel) and its unbounded ring-buffer sibling
``generate_rolling``; the decoder block over the paged KV pool;
:class:`TransformerTrainer` (sequential, or GPipe stages through
``parallel/pipeline.py``) with :class:`TransformerDecision`; and
:class:`TransformerLM`, an ``nn.Module`` holding the weights under the
reference tree's names and layouts (``wq`` is (d_model, d_model) used
as ``x @ w`` — no transposes), so a param tree exported by the JAX
package (nested dicts of numpy arrays) loads with
:func:`params_from_jax` / :meth:`TransformerLM.from_jax`.

The functions take the weights as a nested dict of tensors (the
reference's pytree).  Trainable weights are leaf tensors with
``requires_grad``; gradients come from ``torch.autograd.grad`` of the
loss, as the reference takes ``jax.value_and_grad``.
"""

from __future__ import annotations

import numpy
import torch
from torch import nn

from veles_tpu_torch import prng as prng_mod
from veles_tpu_torch.accel import AcceleratedUnit
from veles_tpu_torch.device import resolve_device
from veles_tpu_torch.ops.attention import (init_mha_params, mha_decode_step,
                                           mha_decode_step_rolling,
                                           mha_forward,
                                           mha_paged_chunk_step,
                                           rolling_slot_update)
from veles_tpu_torch.ops import hopper_kernels as HK
from veles_tpu_torch.ops.decision import DecisionBase
from veles_tpu_torch.ops.functional import matmul, relu
from veles_tpu_torch.ops.moe import init_moe_params, moe_ffn
from veles_tpu_torch.workflow import DeferredInitError


def init_transformer_params(stream, vocab, d_model=64, n_heads=4,
                            n_layers=2, d_ff=None, max_len=512,
                            dtype="float32", n_experts=0,
                            n_kv_heads=None, rope=False):
    """Host (numpy) param tree drawn from ``stream`` in the reference's
    order — the same stream state gives bit-equal weights in both
    packages.  ``n_experts > 0`` gives every block a top-1-routed
    mixture of experts (``blk["moe"]``, ops/moe.py) INSTEAD of the dense
    FFN weights; ``n_kv_heads`` < n_heads makes attention grouped-query;
    ``rope=True`` drops the learned positional table."""
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
        if n_experts > 0:
            blk["moe"] = init_moe_params(stream, d_model, d_ff, n_experts,
                                         dtype)
        else:
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
    """The FFN half of a block (dense or routed MoE), shared by the
    training forward and every serving step."""
    if "moe" in blk:
        return moe_ffn(blk["moe"], hn)
    ff = relu(matmul(hn, blk["w1"]) + blk["b1"])
    return matmul(ff, blk["w2"]) + blk["b2"]


def head_logits(params, h):
    """Final LN + tied output head over block-stack activations."""
    h = _layernorm(h, params["ln_f"]["g"], params["ln_f"]["b"])
    return matmul(h, params["embed"].T)


# ---------------------------------------------------------------- training
def block_forward(blk, h, n_heads, block_size=None, attn_fn=None,
                  with_aux=False, token_mask=None, rope=False, window=None,
                  sinks=0):
    """One decoder block (pre-LN attention + FFN with residuals).
    ``attn_fn(attn_params, hn)`` replaces the attention call (``prefill``
    captures K/V through it); it never rotates or windows, so rope and
    window raise with it.  A block carrying ``moe`` params routes its
    FFN through the experts; ``with_aux=True`` returns (h, the MoE
    load-balancing loss) (0.0 for a dense block; ``token_mask`` keeps
    padded rows out of the router statistics)."""
    hn = _layernorm(h, blk["ln1"]["g"], blk["ln1"]["b"])
    if attn_fn is not None:
        if rope or window or sinks:
            raise ValueError("rope/window are not supported with an "
                             "injected attn_fn (ring attention)")
        h = h + attn_fn(blk["attn"], hn)
    else:
        h = h + mha_forward(blk["attn"], hn, n_heads, causal=True,
                            block_size=block_size, rope=rope,
                            window=window, sinks=sinks)
    hn = _layernorm(h, blk["ln2"]["g"], blk["ln2"]["b"])
    if "moe" in blk and with_aux:
        out, aux = moe_ffn(blk["moe"], hn, return_aux=True,
                           token_mask=token_mask)
        return h + out, aux
    h = h + _block_ffn(blk, hn)
    return (h, 0.0) if with_aux else h


def embed_tokens(params, tokens):
    """Token (+ learned positional, absent under RoPE) embedding."""
    s = tokens.shape[1]
    h = params["embed"][tokens.long()]
    if "pos" in params:
        h = h + params["pos"][:s]
    return h


def nll_from_hidden(params, h, targets, mask):
    """Masked mean next-token cross-entropy from block-stack
    activations; ``mask`` (batch,) marks live sequences."""
    logp = torch.log_softmax(head_logits(params, h), dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    m = mask[:, None]
    denom = torch.clamp_min(m.sum() * nll.shape[1], 1.0)
    return (nll * m).sum() / denom


def transformer_forward(params, tokens, n_heads, block_size=None,
                        attn_fn=None, rope=False, window=None, sinks=0):
    """Logits (batch, seq, vocab)."""
    h = embed_tokens(params, tokens)
    for blk in params["blocks"]:
        h = block_forward(blk, h, n_heads, block_size, attn_fn, rope=rope,
                          window=window, sinks=sinks)
    return head_logits(params, h)


def lm_loss(params, tokens, mask, n_heads, block_size=None,
            moe_aux_coef=0.0, remat=False, rope=False, window=None,
            sinks=0):
    """Mean next-token cross-entropy of ``tokens`` (batch, seq + 1),
    masked rows excluded.  ``moe_aux_coef > 0`` adds that weight times
    the mean load-balancing loss of the MoE blocks over LIVE tokens
    (``mask`` broadcast over the sequence).  ``remat=True`` checkpoints
    each block (with its aux term): its activations are recomputed in
    the backward instead of stored (the reference's
    ``jax.checkpoint``)."""
    h = embed_tokens(params, tokens[:, :-1])
    token_mask = mask[:, None].expand(h.shape[0], h.shape[1]).reshape(-1)
    aux_total, n_moe = 0.0, 0
    for blk in params["blocks"]:
        with_aux = bool(moe_aux_coef) and "moe" in blk

        def run(x, blk=blk, with_aux=with_aux):
            return block_forward(blk, x, n_heads, block_size,
                                 with_aux=with_aux, token_mask=token_mask,
                                 rope=rope, window=window, sinks=sinks)
        if remat:
            out = torch.utils.checkpoint.checkpoint(run, h,
                                                    use_reentrant=False)
        else:
            out = run(h)
        if with_aux:
            h, aux = out
            aux_total = aux_total + aux
            n_moe += 1
        else:
            h = out
    loss = nll_from_hidden(params, h, tokens[:, 1:], mask)
    if n_moe:
        loss = loss + moe_aux_coef * aux_total / n_moe
    return loss


def tree_map(fn, *trees):
    """``fn`` over the leaves of one or more param trees of equal
    structure (nested dicts and lists), returning a tree of the same
    structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *items) for items in zip(*trees))
    return fn(*trees)


def tree_leaves(tree):
    """The leaves of a param tree, in its own key order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in tree_leaves(item)]
    return [tree]


def adam_lr(learning_rate, beta1, beta2, t):
    """The bias-corrected step size at step ``t`` (from 0), in fp32 as
    the reference forms it: lr·√(1 − β₂ᵗ⁺¹)/(1 − β₁ᵗ⁺¹)."""
    f32 = numpy.float32
    tf = f32(t) + f32(1.0)
    return float(f32(learning_rate)
                 * numpy.sqrt(f32(1.0) - f32(beta2) ** tf)
                 / (f32(1.0) - f32(beta1) ** tf))


def make_adam_train_step(loss_fn, learning_rate, beta1=0.9, beta2=0.999,
                         eps=1e-8):
    """Adam step over a param tree: ``(params, opt_state, tokens, mask,
    t) -> (params, opt_state, metrics)`` with ``t`` the host step count.
    The reference's arithmetic in its order: m and v first, then
    p − lr_t·m/(√v + ε).  The parameters and moments are updated IN
    PLACE (the reference donates their buffers) and returned."""

    def train_step(params, opt_state, tokens, mask, t):
        leaves = tree_leaves(params)
        loss = loss_fn(params, tokens, mask)
        grads = torch.autograd.grad(loss, leaves)
        m, v = (tree_leaves(x) for x in opt_state)
        lr = adam_lr(learning_rate, beta1, beta2, t)
        with torch.no_grad():
            torch._foreach_mul_(m, beta1)
            torch._foreach_add_(m, torch._foreach_mul(grads, 1 - beta1))
            torch._foreach_mul_(v, beta2)
            torch._foreach_add_(v, torch._foreach_mul(
                torch._foreach_mul(grads, 1 - beta2), grads))
            denom = torch._foreach_sqrt(v)
            torch._foreach_add_(denom, eps)
            torch._foreach_sub_(leaves, torch._foreach_div(
                torch._foreach_mul(m, lr), denom))
        count = mask.sum()
        return params, opt_state, {"loss_sum": loss.detach() * count,
                                   "tokens": count}

    return train_step


# ------------------------------------------------------------------ decoding
def prefill(params, tokens, n_heads, max_len, rope=False, window=None,
            sinks=0):
    """Run the prompt through the stack once, capturing each block's
    projected K/V heads (n_kv_heads wide under GQA) into caches of
    (batch, kv_heads, max_len, head_dim) with positions [0, s) filled.
    Returns (h (b, s, d), caches)."""
    h = embed_tokens(params, tokens)
    s = h.shape[1]
    caches = []
    for blk in params["blocks"]:
        captured = {}

        def attn_capture(p, hn, captured=captured):
            out, k, v = mha_forward(p, hn, n_heads, causal=True,
                                    return_kv=True, rope=rope,
                                    window=window, sinks=sinks)
            captured["kv"] = (k, v)
            return out

        h = block_forward(blk, h, n_heads, attn_fn=attn_capture)
        k, v = captured["kv"]
        pad = (0, 0, 0, max_len - s)
        caches.append((torch.nn.functional.pad(k, pad),
                       torch.nn.functional.pad(v, pad)))
    return h, caches


def block_decode_step(blk, h, k_cache, v_cache, pos, n_heads, rope=False,
                      window=None, sinks=0):
    """One block over ONE position against its KV cache (written in
    place)."""
    hn = _layernorm(h, blk["ln1"]["g"], blk["ln1"]["b"])
    attn, k_cache, v_cache = mha_decode_step(blk["attn"], hn, k_cache,
                                             v_cache, pos, n_heads,
                                             rope=rope, window=window,
                                             sinks=sinks)
    h = h + attn
    hn = _layernorm(h, blk["ln2"]["g"], blk["ln2"]["b"])
    return h + _block_ffn(blk, hn), k_cache, v_cache


def _make_sampler(greedy, top_k, temperature):
    """The token sampler shared by the full-cache and rolling decoders
    (their top-k tie rule and temperature handling never drift apart),
    and its key schedule.  ``sample(logits, key)`` is the greedy argmax
    (the first maximum, as ``jnp.argmax``) or the seeded draw of
    :func:`sample_token` (``top_k`` None: no mask) under ``key`` for
    the whole (batch, vocab) draw; ``next_key(key)`` is the reference's
    split chain, (key, sub) = split(key), made on the host (the keys do
    not depend on the data), and (None, None) when greedy."""
    def sample(logits, key):
        if greedy:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return sample_token(key, logits, temperature, top_k or 0)

    def next_key(key):
        if key is None:
            return None, None
        key, sub = prng_mod.split(key)
        return key, sub

    return sample, next_key


def sample_token(key, logits, temperature, top_k=0):
    """Sample one token id from each (vocab,) row of ``logits``: the
    logits below the row's ``top_k``-th largest (0: none; ties at the
    cutoff stay eligible) set to -1e30, divided by ``temperature`` (>
    0), and drawn by ``jax.random.categorical(key, ...)``'s gumbel-max
    rule, ``key`` covering the whole array (the flat index is the
    counter).  int32 of the rows' shape.  On the card one launch of
    ``hopper_kernels.sample_token``; on the CPU its plain version."""
    return HK.sample_token(logits.contiguous(), temperature, key, top_k)


def generate(params, prompt, n_new, n_heads, rng=None, temperature=1.0,
             max_len=None, top_k=None, true_len=None, rope=False,
             window=None, sinks=0):
    """Autoregressive decoding with a KV cache: ``prompt`` (batch, s)
    int; returns (batch, s + n_new) int32.  ``temperature=0`` decodes
    greedily (and never reads ``top_k`` once it is in range); otherwise
    ``rng`` (a key or an int seed) seeds the draws through the
    reference's split chain, ``top_k`` keeping the k most likely tokens.
    ``max_len`` pins the cache size
    (default prompt + n_new); ``true_len`` says how many leading prompt
    positions are real when the prompt is right-padded to a bucket
    width — decoding continues from there and the continuation lands at
    ``out[:, prompt_width:]``."""
    if n_new < 1:
        raise ValueError("n_new must be >= 1")
    start = prompt.shape[1] if true_len is None else int(true_len)
    if not 1 <= start <= prompt.shape[1]:
        raise ValueError("true_len %d out of range (prompt width %d)"
                         % (start, prompt.shape[1]))
    if max_len is None:
        max_len = max(prompt.shape[1], start + n_new)
    if prompt.shape[1] > max_len:
        raise ValueError("padded prompt width %d exceeds max_len %d"
                         % (prompt.shape[1], max_len))
    if start + n_new > max_len:
        raise ValueError("prompt + n_new = %d exceeds max_len %d"
                         % (start + n_new, max_len))
    if "pos" in params and max_len > params["pos"].shape[0]:
        raise ValueError("max_len %d exceeds the positional table (%d)"
                         % (max_len, params["pos"].shape[0]))
    greedy = not temperature
    if not greedy and rng is None:
        raise ValueError("sampling (temperature > 0) needs rng")
    if top_k is not None and not 1 <= top_k <= params["embed"].shape[0]:
        raise ValueError("top_k %r out of range (vocab %d)"
                         % (top_k, params["embed"].shape[0]))
    sample, next_key = _make_sampler(greedy, top_k, temperature)
    key = None if greedy else HK._as_key(rng)
    with torch.no_grad():
        h, caches = prefill(params, prompt, n_heads, max_len, rope=rope,
                            window=window, sinks=sinks)
        logits = head_logits(params, h[:, start - 1:start])[:, 0]
        toks = []
        for i in range(n_new - 1):
            key, sub = next_key(key)
            tok = sample(logits, sub)
            pos = start + i
            x = params["embed"][tok.long()][:, None, :]
            if "pos" in params:
                x = x + params["pos"][pos:pos + 1][None]
            for blk, (kc, vc) in zip(params["blocks"], caches):
                x, _, _ = block_decode_step(blk, x, kc, vc, pos, n_heads,
                                            rope=rope, window=window,
                                            sinks=sinks)
            logits = head_logits(params, x)[:, 0]
            toks.append(tok)
        toks.append(sample(logits, next_key(key)[1]))
        return torch.cat([prompt.to(torch.int32), torch.stack(toks, 1)],
                         dim=1)



def block_decode_step_rolling(blk, h, k_cache, v_cache, slot, live, pos,
                              n_heads):
    """One block over ONE position against its ring-buffer cache
    (written in place): :func:`block_decode_step`'s wiring with the
    precomputed ``slot``/``live`` of ``attention.rolling_slot_update``
    (which encodes any sink pinning) and RoPE at the absolute ``pos``."""
    hn = _layernorm(h, blk["ln1"]["g"], blk["ln1"]["b"])
    attn, k_cache, v_cache = mha_decode_step_rolling(
        blk["attn"], hn, k_cache, v_cache, slot, live, pos, n_heads)
    h = h + attn
    hn = _layernorm(h, blk["ln2"]["g"], blk["ln2"]["b"])
    return h + _block_ffn(blk, hn), k_cache, v_cache


def generate_rolling(params, prompt, n_new, n_heads, window, rng=None,
                     temperature=1.0, top_k=None, sinks=0):
    """UNBOUNDED decoding in O(sinks + window) memory, for RoPE
    models: ``prompt`` (batch, s) int; returns (batch, s + n_new) int32.
    The prompt is prefilled at its own width (windowed, with sinks), its
    K/V folded into each block's [sinks | window-ring] cache, and every
    new position written at the ring slot of
    ``attention.rolling_slot_update``, so ``n_new`` is bounded by
    nothing.  Matches ``generate(..., rope=True, window=window,
    sinks=sinks)`` while that one's full cache lasts.  The loop makes no
    host-to-device copy: the rotary positions are uploaded once, the
    slot is a host int and the tokens stay on the device until the
    end.  ``temperature``, ``rng`` and ``top_k`` as in
    :func:`generate` (the same sampler and split chain)."""
    if "pos" in params:
        raise ValueError("generate_rolling needs a RoPE model (a learned "
                         "positional table bounds the length anyway — "
                         "use generate)")
    if n_new < 1:
        raise ValueError("n_new must be >= 1")
    if not window or window < 1:
        raise ValueError("generate_rolling needs window >= 1")
    greedy = not temperature
    if not greedy and rng is None:
        raise ValueError("sampling (temperature > 0) needs rng")
    if top_k is not None and not 1 <= top_k <= params["embed"].shape[0]:
        raise ValueError("top_k %r out of range (vocab %d)"
                         % (top_k, params["embed"].shape[0]))
    sample, next_key = _make_sampler(greedy, top_k, temperature)
    key = None if greedy else HK._as_key(rng)
    device = prompt.device
    b, s = prompt.shape
    with torch.no_grad():
        h, caches = prefill(params, prompt, n_heads, s, rope=True,
                            window=window, sinks=sinks)
        logits = head_logits(params, h[:, -1:])[:, 0]
        # the first min(sinks, s) positions pin to their own slots, the
        # last min(window, s - kept sinks) land at sinks + (p - sinks) %
        # window (consecutive, so distinct); other slots stay -1
        ps = list(range(min(sinks, s))) + list(range(max(sinks, s - window),
                                                     s))
        slots = [p if p < sinks else sinks + (p - sinks) % window
                 for p in ps]
        cache_len = sinks + window
        host_pos = numpy.full(cache_len, -1, numpy.int32)
        host_pos[slots] = ps
        slot_pos = torch.from_numpy(host_pos).to(device)
        src = torch.tensor(ps, dtype=torch.long, device=device)
        dst = torch.tensor(slots, dtype=torch.long, device=device)

        def to_ring(c):
            ring = c.new_zeros(c.shape[:2] + (cache_len,) + c.shape[3:])
            ring[:, :, dst] = c[:, :, src]
            return ring

        caches = [(to_ring(k), to_ring(v)) for k, v in caches]
        positions = torch.arange(s, s + n_new, device=device)
        out = torch.empty((b, s + n_new), dtype=torch.int32, device=device)
        out[:, :s] = prompt
        for i in range(n_new - 1):
            key, sub = next_key(key)
            tok = sample(logits, sub)
            out[:, s + i] = tok
            slot, slot_pos, live = rolling_slot_update(
                slot_pos, s + i, window, sinks=sinks)
            x = params["embed"][tok.long()][:, None, :]
            for blk, (kc, vc) in zip(params["blocks"], caches):
                x, _, _ = block_decode_step_rolling(
                    blk, x, kc, vc, slot, live, positions[i:i + 1], n_heads)
            logits = head_logits(params, x)[:, 0]
        out[:, s + n_new - 1] = sample(logits, next_key(key)[1])
        return out

def trainer_sample_tokens(trainer, prompt, n_new=32, temperature=0.0,
                          seed=0, params=None, max_len=None, top_k=None,
                          true_len=None):
    """Continue token sequences with a trained :class:`TransformerTrainer`
    by KV-cached :func:`generate` on the trainer's device, with its
    rope/window/sinks settings: greedy at ``temperature=0``, else
    sampled under ``PRNGKey(seed)``; ``prompt`` (batch, s) ints.
    Returns numpy int32 (batch, s + n_new).  A pipelined trainer's
    blocks are gathered from its stages first (every stage must call
    this)."""
    if params is None:
        params = trainer._to_portable(trainer.params)
    device = tree_leaves(params)[0].device
    out = generate(params, torch.as_tensor(numpy.asarray(prompt, numpy.int32),
                                           device=device),
                   n_new, trainer.n_heads,
                   rng=prng_mod.PRNGKey(seed) if temperature else None,
                   temperature=temperature,
                   max_len=max_len, top_k=top_k, true_len=true_len,
                   rope=getattr(trainer, "rope", False),
                   window=getattr(trainer, "window", None),
                   sinks=getattr(trainer, "attn_sinks", 0))
    return out.cpu().numpy()


# ----------------------------------------------------------------- trainer
class TransformerTrainer(AcceleratedUnit):
    """Whole-model trainer: an Adam update of the param tree per TRAIN
    minibatch; other minibatches score the loss only.  ``n_experts > 0``
    makes every block's FFN a routed mixture of experts, whose
    load-balancing term (``moe_aux_coef``) enters the sequential train
    loss only.  ``pipeline_stages`` S > 0 runs the blocks as a GPipe
    pipeline (``parallel/pipeline.py``) in ``pipeline_microbatches``
    microbatches, one stage a process: a joined run of exactly S
    processes (S = 1 needs none), each keeping its stage's stacked
    blocks and their Adam moments and reading the whole minibatch.
    ``state_dict`` carries every block unstacked (gathered from the
    stages), so pipelined and sequential trainers load each other's
    state."""

    def __init__(self, workflow, vocab=64, d_model=64, n_heads=4,
                 n_layers=2, max_len=512, learning_rate=1e-3,
                 block_size=None, beta1=0.9, beta2=0.999, eps=1e-8,
                 n_experts=0, moe_aux_coef=1e-2, pipeline_stages=0,
                 pipeline_microbatches=4, remat=False, n_kv_heads=None,
                 rope=False, window=None, attn_sinks=0, **kwargs):
        super().__init__(workflow, **kwargs)
        if attn_sinks and not window:
            raise ValueError("attn_sinks only means something under a "
                             "window (set window=W)")
        if pipeline_stages > 0 and (rope or window):
            raise ValueError(
                "rope/window are not threaded through the pipeline "
                "stage scan yet — use the sequential path "
                "(pipeline_stages=0) for these options")
        self.vocab = vocab
        self.d_model = d_model
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads
        self.rope = rope
        self.window = window
        self.attn_sinks = attn_sinks
        self.n_layers = n_layers
        self.max_len = max_len
        self.learning_rate = learning_rate
        self.block_size = block_size
        self.beta1, self.beta2, self.eps = beta1, beta2, eps
        self.n_experts = n_experts
        self.moe_aux_coef = moe_aux_coef
        self.pipeline_stages = pipeline_stages
        self.pipeline_microbatches = pipeline_microbatches
        self.remat = remat
        self._pp_mesh = None
        self.params = None
        self.opt_state = None
        self.time = 0
        self.metrics = {}
        self._device = None

    # The trees travel in the portable form: blocks as a per-layer list.
    # A pipelined trainer keeps its stage's blocks stacked.
    def _to_portable(self, tree):
        """``tree`` with every block unstacked; a stage's blocks are
        gathered from all the stages (every stage must call this)."""
        from veles_tpu_torch.parallel.pipeline import unstack_blocks
        if self.pipeline_stages > 0 and isinstance(tree.get("blocks"), dict):
            blocks = tree["blocks"]
            if self.pipeline_stages > 1:
                blocks = tree_map(self._gather_stages, blocks)
            tree = dict(tree, blocks=unstack_blocks(blocks, self.n_layers))
        return tree

    def _gather_stages(self, x):
        """A stacked leaf's stages joined along the layer axis, over the
        mesh's gloo group (host copies)."""
        import torch.distributed as dist
        host = x.detach().to("cpu")
        parts = [torch.empty_like(host) for _ in range(self.pipeline_stages)]
        dist.all_gather(parts, host, group=self._pp_mesh.guard_group)
        return torch.cat(parts).to(x.device)

    def _from_portable(self, tree):
        """``tree`` with this stage's blocks stacked (once the stage mesh
        exists)."""
        from veles_tpu_torch.parallel.pipeline import (StageBlocks,
                                                       stack_blocks)
        if self._pp_mesh is not None and isinstance(tree.get("blocks"),
                                                    list):
            n = self.pipeline_stages
            if self.n_layers % n:
                raise ValueError("n_layers %d %% n_stages %d != 0"
                                 % (self.n_layers, n))
            k = self.n_layers // n
            stage = self._pp_mesh.coords["stage"]
            tree = dict(tree, blocks=StageBlocks(stack_blocks(
                tree["blocks"][stage * k:(stage + 1) * k]), self.n_layers))
        return tree

    def state_dict(self):
        """The reference trainer's form: the portable numpy param tree,
        the (m, v) moment trees and the step count (a pipelined trainer
        gathers its stages: every stage must call this)."""
        def marshal(tree):    # copies: training goes on in place
            return tree_map(lambda t: t.detach().to("cpu", copy=True)
                            .numpy(), self._to_portable(tree))

        return {"params": None if self.params is None
                else marshal(self.params),
                "opt_state": (tuple(marshal(t) for t in self.opt_state)
                              if self.opt_state is not None else None),
                "time": self.time}

    def load_state_dict(self, d):
        """Take a ``state_dict()`` of either package's trainer, pipelined
        or not (a stage keeps its own blocks)."""
        if d.get("params") is not None:
            self._set_state(d["params"], d["opt_state"])
        self.time = d.get("time", 0)

    def _set_state(self, params, opt_state):
        device = self._device or torch.device("cpu")

        def leaf(x):
            return torch.tensor(numpy.asarray(x), device=device)

        self.params = self._from_portable(tree_map(leaf, params))
        for t in tree_leaves(self.params):
            t.requires_grad_()
        self.opt_state = tuple(self._from_portable(tree_map(leaf, t))
                               for t in opt_state)

    def _loss_fn(self, training):
        """(params, tokens, mask) -> loss, sequential or pipelined.  The
        MoE load-balancing term is a training regularizer only: the eval
        loss is the pure NLL (comparable across coefficients), without
        remat (it keeps no activations for a backward).  The pipeline
        threads neither (warned): train and eval run the same loss."""
        if self.pipeline_stages > 0:
            from veles_tpu_torch.parallel.pipeline import pipeline_lm_loss
            if training and self.remat:
                self.warning("remat is not applied on the pipeline path "
                             "(the stage scan already bounds live "
                             "activations to one microbatch per stage)")
            if training and self.n_experts > 0 and self.moe_aux_coef:
                self.warning(
                    "moe_aux_coef is not applied on the pipeline path "
                    "(the stage scan does not thread the aux term); "
                    "pipelined MoE trains without load balancing — set "
                    "moe_aux_coef=0 to silence this warning")
            return lambda params, tokens, mask: pipeline_lm_loss(
                params, tokens, mask, self.n_heads, self._pp_mesh,
                self.pipeline_microbatches, self.block_size)
        coef = self.moe_aux_coef if training and self.n_experts > 0 else 0.0
        return lambda params, tokens, mask: lm_loss(
            params, tokens, mask, self.n_heads, self.block_size,
            moe_aux_coef=coef, remat=self.remat and training,
            rope=self.rope, window=self.window, sinks=self.attn_sinks)

    def _pipeline_mesh(self):
        """The stage mesh: one stage a process of the joined run."""
        import torch.distributed as dist
        from veles_tpu_torch.parallel.pipeline import make_pipeline_mesh
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world > self.pipeline_stages:
            raise ValueError(
                "pipeline_stages=%d runs one stage a process: it needs a "
                "joined run of exactly %d processes, have %d"
                % (self.pipeline_stages, self.pipeline_stages, world))
        return make_pipeline_mesh(self.pipeline_stages)

    def initialize(self, device=None, **kwargs):
        if not hasattr(self, "input") or self.input.is_empty:
            raise DeferredInitError(self.name)
        loader_vocab = getattr(getattr(self.workflow, "loader", None),
                               "vocab", None)
        if loader_vocab is not None and loader_vocab > self.vocab:
            raise ValueError(
                "loader vocab %d exceeds trainer vocab %d — set "
                "root.<name>.trainer.vocab to cover the data source"
                % (loader_vocab, self.vocab))
        self._device = resolve_device(device)
        if self.pipeline_stages > 0 and self._pp_mesh is None:
            self._pp_mesh = self._pipeline_mesh()
        if self.params is None:
            host = init_transformer_params(
                prng_mod.get("init"), self.vocab, self.d_model,
                self.n_heads, self.n_layers, max_len=self.max_len,
                n_experts=self.n_experts, n_kv_heads=self.n_kv_heads,
                rope=self.rope)
            self._set_state(host, (tree_map(numpy.zeros_like, host),) * 2)
        else:       # loaded before the device was known: move it there
            state = self.state_dict()
            self._set_state(state["params"], state["opt_state"])
        train_step = make_adam_train_step(self._loss_fn(training=True),
                                          self.learning_rate, self.beta1,
                                          self.beta2, self.eps)
        eval_loss_fn = self._loss_fn(training=False)

        def eval_step(params, tokens, mask):
            with torch.no_grad():
                loss = eval_loss_fn(params, tokens, mask)
            count = mask.sum()
            return {"loss_sum": loss * count, "tokens": count}

        self._train = self.jit("train", train_step)
        self._evalf = self.jit("eval", eval_step)
        super().initialize(device=self._device, **kwargs)

    def run(self):
        tokens = self.input.devmem
        mask = self.mask.devmem
        if not self.is_train_minibatch():
            self.metrics = self._evalf(self.params, tokens, mask)
            return
        self.params, self.opt_state, self.metrics = self._train(
            self.params, self.opt_state, tokens, mask, self.time)
        self.time += 1


class TransformerDecision(DecisionBase):
    """Tracks mean next-token loss (improvement = lower)."""

    def should_skip_gd(self, cls):
        return False

    def reduce_metrics(self, host_totals):
        out = dict(host_totals)
        count = max(out.pop("tokens", 1), 1)
        if "loss_sum" in out:
            out["loss"] = out.pop("loss_sum") / count
        return out

    def epoch_metric(self, set_metrics):
        return set_metrics.get("loss")


def block_paged_chunk_step(blk, h, k_pool, v_pool, ptab, pos, n_heads,
                           rope=False, window=None, sinks=0,
                           attn_kernel=None, write_mask=None):
    """One block (pre-LN attention + FFN with residuals) over ``c``
    positions per lane against the PAGED KV pool (pools written in
    place).  ``attn_kernel`` (None | 'decode' | 'prefill') routes the
    attention through the Hopper kernels; ``write_mask`` ((b,) bool)
    sends masked lanes' K/V writes to the scratch page."""
    hn = _layernorm(h, blk["ln1"]["g"], blk["ln1"]["b"])
    attn, k_pool, v_pool = mha_paged_chunk_step(
        blk["attn"], hn, k_pool, v_pool, ptab, pos, n_heads, rope=rope,
        window=window, sinks=sinks, attn_kernel=attn_kernel,
        write_mask=write_mask)
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
                      rope=False, window=None, sinks=0, attn_kernel=None,
                      write_mask=None):
    """Run ``c`` consecutive tokens PER LANE through the whole stack
    against the paged KV pools in one pass.

    tokens: (b, c) int; pools: per-block [(k_pool, v_pool)], each
    (n_pages, kv_heads, page, head_dim); ptab: (b, m) int32; pos: (b,)
    int32.  Returns (h (b, c, d), pools) with each lane's K/V written
    through its table at [pos, pos+c) — in place.  Serves the prompt
    chunk (b=1, c=chunk), the decode step (c=1, b=slots) and the
    speculative verify (c=k+1).  ``write_mask`` ((b,) bool) sends
    masked lanes' writes to the scratch page (the megastep's finished
    lanes; see :func:`~veles_tpu_torch.ops.attention.paged_write`)."""
    h = paged_chunk_embed(params, tokens, pos)
    for blk, (kp, vp) in zip(params["blocks"], pools):
        h, _, _ = block_paged_chunk_step(blk, h, kp, vp, ptab, pos,
                                         n_heads, rope=rope, window=window,
                                         sinks=sinks,
                                         attn_kernel=attn_kernel,
                                         write_mask=write_mask)
    return h, pools


def propose_draft_in_graph(hist, hlen, k, max_ngram=3):
    """Prompt-lookup drafts for a batch of lanes, computed on the device
    with no host read — the in-graph sibling of
    ``serving/lm_engine.py::propose_draft``, for the decode megastep.

    hist: (b, n) int32 token histories (prompt + emitted; entries at and
    past a lane's ``hlen`` are garbage); hlen: (b,) int32.  For g =
    ``max_ngram`` down to 1 (the largest g wins) the lane's final g-gram
    is looked up among the windows that END strictly before its final
    position, and the MOST RECENT hit's start kept.  Returns (draft (b,
    k) int32, found (b,) bool): the k tokens after the match (zeros
    where nothing recurs; the window may run into garbage past
    ``hlen``).  The reference's clamps hold: the final g-gram's start is
    clamped into [0, n - g] and the continuation's into [0, n - k], so
    the answer equals the reference's on any input, garbage included.
    Draft quality affects speed only: the verifier accepts a draft
    token only where it equals its own argmax."""
    b, n = hist.shape
    dev = hist.device
    idx = torch.arange(n, device=dev)
    hlen = hlen.long()
    best_start = torch.zeros(b, dtype=torch.long, device=dev)
    best_g = torch.zeros(b, dtype=torch.long, device=dev)
    found = torch.zeros(b, dtype=torch.bool, device=dev)
    for g in range(max_ngram, 0, -1):
        start = (hlen - g).clamp(0, n - g)
        tail = torch.gather(hist, 1, start[:, None]
                            + torch.arange(g, device=dev))       # (b, g)
        eq = torch.ones((b, n), dtype=torch.bool, device=dev)
        for t in range(g):
            # hist[j + t] at index j; wrapped windows fail ``valid``
            eq &= torch.roll(hist, -t, dims=1) == tail[:, t:t + 1]
        valid = (idx[None] + g <= hlen[:, None] - 1) \
            & (hlen[:, None] >= g + 1)
        hit = eq & valid
        any_hit = hit.any(dim=1)
        recent = torch.where(hit, idx[None], -1).max(dim=1).values
        take = any_hit & ~found
        best_start = torch.where(take, recent, best_start)
        best_g = torch.where(take, g, best_g)
        found = found | any_hit
    first = (best_start + best_g).clamp(0, n - k)
    cont = torch.gather(hist, 1, first[:, None]
                        + torch.arange(k, device=dev))
    return torch.where(found[:, None], cont, 0), found


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
    return tree_map(lambda node: _leaf(node, device), tree)


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
