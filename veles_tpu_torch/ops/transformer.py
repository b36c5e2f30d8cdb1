"""Transformer language model: training, greedy decoding and paged
serving.

Port of ``veles_tpu/ops/transformer.py``: host-side init (bit-equal to
the reference for the same prng stream); the training forward
(``transformer_forward``, ``lm_loss``) and the Adam step; KV-cached
greedy ``generate``; the decoder block over the paged KV pool;
:class:`TransformerTrainer` with :class:`TransformerDecision`; and
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
                                           mha_forward,
                                           mha_paged_chunk_step)
from veles_tpu_torch.ops.decision import DecisionBase
from veles_tpu_torch.ops.functional import matmul
from veles_tpu_torch.workflow import DeferredInitError

_MOE = ("mixture-of-experts blocks (n_experts > 0) are not ported yet: "
        "ROADMAP Queue 2, item 3")


def init_transformer_params(stream, vocab, d_model=64, n_heads=4,
                            n_layers=2, d_ff=None, max_len=512,
                            dtype="float32", n_experts=0,
                            n_kv_heads=None, rope=False):
    """Host (numpy) param tree drawn from ``stream`` in the reference's
    order — the same stream state gives bit-equal weights in both
    packages.  ``n_kv_heads`` < n_heads makes attention grouped-query;
    ``rope=True`` drops the learned positional table."""
    if n_experts > 0:
        raise NotImplementedError(_MOE)
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
        raise NotImplementedError(_MOE)
    ff = torch.clamp_min(matmul(hn, blk["w1"]) + blk["b1"], 0.0)
    return matmul(ff, blk["w2"]) + blk["b2"]


def head_logits(params, h):
    """Final LN + tied output head over block-stack activations."""
    h = _layernorm(h, params["ln_f"]["g"], params["ln_f"]["b"])
    return matmul(h, params["embed"].T)


# ---------------------------------------------------------------- training
def block_forward(blk, h, n_heads, block_size=None, attn_fn=None,
                  rope=False, window=None, sinks=0):
    """One decoder block (pre-LN attention + FFN with residuals).
    ``attn_fn(attn_params, hn)`` replaces the attention call (``prefill``
    captures K/V through it); it never rotates or windows, so rope and
    window raise with it."""
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
    return h + _block_ffn(blk, hn)


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
    masked rows excluded.  ``remat=True`` checkpoints each block: its
    activations are recomputed in the backward instead of stored (the
    reference's ``jax.checkpoint``).  ``moe_aux_coef`` only weighs MoE
    blocks, which are not ported."""
    h = embed_tokens(params, tokens[:, :-1])
    for blk in params["blocks"]:
        def run(x, blk=blk):
            return block_forward(blk, x, n_heads, block_size, rope=rope,
                                 window=window, sinks=sinks)
        if remat:
            h = torch.utils.checkpoint.checkpoint(run, h,
                                                  use_reentrant=False)
        else:
            h = run(h)
    return nll_from_hidden(params, h, tokens[:, 1:], mask)


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


# ---------------------------------------------------------- greedy decoding
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


_SAMPLING = ("seeded sampling (temperature > 0, top_k) is not ported "
             "yet: ROADMAP Queue 1, item 6")


def _make_sampler(greedy, top_k, temperature):
    """The token sampler: greedy argmax (the first maximum, as
    ``jnp.argmax``).  Sampling raises."""
    if not greedy or top_k is not None:
        raise NotImplementedError(_SAMPLING)

    def sample(logits):
        return torch.argmax(logits, dim=-1).to(torch.int32)

    return sample


def generate(params, prompt, n_new, n_heads, rng=None, temperature=1.0,
             max_len=None, top_k=None, true_len=None, rope=False,
             window=None, sinks=0):
    """Greedy autoregressive decoding with a KV cache: ``prompt``
    (batch, s) int; returns (batch, s + n_new) int32.  ``temperature``
    must be 0 (sampling raises).  ``max_len`` pins the cache size
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
    sample = _make_sampler(not temperature, top_k, temperature)
    with torch.no_grad():
        h, caches = prefill(params, prompt, n_heads, max_len, rope=rope,
                            window=window, sinks=sinks)
        logits = head_logits(params, h[:, start - 1:start])[:, 0]
        toks = []
        for i in range(n_new - 1):
            tok = sample(logits)
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
        toks.append(sample(logits))
        return torch.cat([prompt.to(torch.int32), torch.stack(toks, 1)],
                         dim=1)


def trainer_sample_tokens(trainer, prompt, n_new=32, temperature=0.0,
                          seed=0, params=None, max_len=None, top_k=None,
                          true_len=None):
    """Continue token sequences with a trained :class:`TransformerTrainer`
    by greedy KV-cached :func:`generate` on the trainer's device, with
    its rope/window/sinks settings; ``prompt`` (batch, s) ints.  Returns
    numpy int32 (batch, s + n_new)."""
    if params is None:
        params = trainer.params
    device = tree_leaves(params)[0].device
    out = generate(params, torch.as_tensor(numpy.asarray(prompt, numpy.int32),
                                           device=device),
                   n_new, trainer.n_heads, temperature=temperature,
                   max_len=max_len, top_k=top_k, true_len=true_len,
                   rope=getattr(trainer, "rope", False),
                   window=getattr(trainer, "window", None),
                   sinks=getattr(trainer, "attn_sinks", 0))
    return out.cpu().numpy()


# ----------------------------------------------------------------- trainer
class TransformerTrainer(AcceleratedUnit):
    """Whole-model trainer: an Adam update of the param tree per TRAIN
    minibatch; other minibatches score the loss only.  Sequential path
    only: MoE (``n_experts``) and the pipeline (``pipeline_stages``)
    raise."""

    def __init__(self, workflow, vocab=64, d_model=64, n_heads=4,
                 n_layers=2, max_len=512, learning_rate=1e-3,
                 block_size=None, beta1=0.9, beta2=0.999, eps=1e-8,
                 n_experts=0, moe_aux_coef=1e-2, pipeline_stages=0,
                 pipeline_microbatches=4, remat=False, n_kv_heads=None,
                 rope=False, window=None, attn_sinks=0, **kwargs):
        super().__init__(workflow, **kwargs)
        if n_experts > 0:
            raise NotImplementedError(_MOE)
        if pipeline_stages > 0:
            raise NotImplementedError(
                "the pipeline-parallel trainer (pipeline_stages > 0) is not "
                "ported yet: ROADMAP Queue 2, item 5")
        if attn_sinks and not window:
            raise ValueError("attn_sinks only means something under a "
                             "window (set window=W)")
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
        self.params = None
        self.opt_state = None
        self.time = 0
        self.metrics = {}
        self._device = None

    def state_dict(self):
        """The reference trainer's form: the portable numpy param tree,
        the (m, v) moment trees and the step count."""
        def marshal(tree):    # copies: training goes on in place
            return tree_map(lambda t: t.detach().to("cpu", copy=True)
                            .numpy(), tree)

        return {"params": None if self.params is None
                else marshal(self.params),
                "opt_state": (tuple(marshal(t) for t in self.opt_state)
                              if self.opt_state is not None else None),
                "time": self.time}

    def load_state_dict(self, d):
        """Take a ``state_dict()`` of either package's trainer."""
        if d.get("params") is not None:
            self._set_state(d["params"], d["opt_state"])
        self.time = d.get("time", 0)

    def _set_state(self, params, opt_state):
        device = self._device or torch.device("cpu")

        def leaf(x):
            return torch.tensor(numpy.asarray(x), device=device)

        self.params = tree_map(lambda x: leaf(x).requires_grad_(), params)
        self.opt_state = tuple(tree_map(leaf, t) for t in opt_state)

    def _loss_fn(self):
        return lambda params, tokens, mask: lm_loss(
            params, tokens, mask, self.n_heads, self.block_size,
            remat=self.remat, rope=self.rope, window=self.window,
            sinks=self.attn_sinks)

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
        loss_fn = self._loss_fn()
        train_step = make_adam_train_step(loss_fn, self.learning_rate,
                                          self.beta1, self.beta2, self.eps)

        def eval_step(params, tokens, mask):
            with torch.no_grad():
                loss = loss_fn(params, tokens, mask)
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
