"""The port's paged LM engine against the reference.

The same weights (from one numpy prng stream) serve the same mixed
prompts through ``veles_tpu_torch``'s ``LMEngine`` on the CPU, through
``veles_tpu``'s paged ``LMEngine`` and through ``veles_tpu``'s
``generate``: the greedy tokens must be EQUAL — the serving contract.
"""

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

from veles_tpu import prng as jprng
from veles_tpu.ops import transformer as JT
from veles_tpu.serving.lm_engine import LMEngine as JaxLMEngine
from veles_tpu_torch import prng
from veles_tpu_torch.ops.transformer import (head_logits,
                                             init_transformer_params,
                                             paged_chunk_apply,
                                             params_from_jax)
from veles_tpu_torch.serving import LMEngine
from veles_tpu_torch.serving import lm_engine

VOCAB, D_MODEL, N_HEADS, N_LAYERS, MAX_LEN, PAGE = 32, 32, 4, 2, 64, 8
#: (prompt length, n_new): 3-40 tokens, 5-12 new, chunk tails of every
#: shape (exactly one page, a page plus one, several pages)
REQUESTS = [(3, 5), (17, 8), (40, 12), (8, 7), (25, 10), (9, 6)]


@pytest.fixture(scope="module")
def workload():
    prng.reset()
    host = init_transformer_params(prng.RandomGenerator("init", 7), VOCAB,
                                   d_model=D_MODEL, n_heads=N_HEADS,
                                   n_layers=N_LAYERS, max_len=MAX_LEN)
    rng = numpy.random.RandomState(11)
    prompts = [rng.randint(0, VOCAB, n).astype(numpy.int32)
               for n, _ in REQUESTS]
    return host, prompts


@pytest.fixture(scope="module")
def reference_tokens(workload):
    """Greedy continuations from the reference's ``generate`` — one
    compile: prompts right-padded to one width with ``true_len``, the
    longest n_new for all (greedy tokens never depend on later steps)."""
    host, prompts = workload
    params = jax.tree.map(jnp.asarray, host)
    width, n_max = 40, max(k for _, k in REQUESTS)
    out = []
    for p, (n, k) in zip(prompts, REQUESTS):
        row = numpy.pad(p, (0, width - n))[None]
        toks = numpy.asarray(JT.generate(
            params, jnp.asarray(row), n_max, N_HEADS, temperature=0.0,
            max_len=width + n_max, true_len=n))[0]
        out.append(toks[width:width + k])
    return out


def _serve(engine, prompts):
    futures = [engine.submit(p, k) for p, (_, k) in zip(prompts, REQUESTS)]
    try:
        return [f.result(timeout=120) for f in futures]
    finally:
        engine.stop()


def _greedy_gather(host, prompt, n_new):
    """One lane's greedy continuation through the plain gather path
    (``attn_kernel=None``) — the reference route the chip smoke holds
    the engine's kernels against — driven chunk by chunk, then one
    decode step per token, on a private pool."""
    params = params_from_jax(host, "cpu")
    head_dim = D_MODEL // N_HEADS
    kv = params["blocks"][0]["attn"]["wk"].shape[1] // head_dim
    n_pages = MAX_LEN // PAGE
    pools = [(torch.zeros(n_pages + 1, kv, PAGE, head_dim),
              torch.zeros(n_pages + 1, kv, PAGE, head_dim))
             for _ in params["blocks"]]
    ptab = torch.arange(1, n_pages + 1, dtype=torch.int32)[None]
    n = len(prompt)
    toks = numpy.zeros(-(-n // PAGE) * PAGE, numpy.int32)
    toks[:n] = prompt

    def step(tokens, start):
        h, _ = paged_chunk_apply(params, torch.as_tensor(tokens[None]),
                                 pools, ptab,
                                 torch.tensor([start], dtype=torch.int32),
                                 N_HEADS, attn_kernel=None)
        return head_logits(params, h)[0]

    with torch.inference_mode():
        for start in range(0, len(toks), PAGE):
            logits = step(toks[start:start + PAGE], start)
        out = [int(torch.argmax(logits[(n - 1) % PAGE]))]
        for pos in range(n, n + n_new - 1):
            out.append(int(torch.argmax(
                step(numpy.asarray([out[-1]], numpy.int32), pos)[0])))
    return numpy.asarray(out, numpy.int32)


@pytest.mark.parametrize("kernel_route", [True, 0])
def test_greedy_tokens_equal_reference(workload, reference_tokens,
                                       kernel_route):
    """The engine (its kernel route: the plain versions on the CPU) and
    the plain gather path both give generate's tokens; after the engine
    serves, every page is back and the counters add up."""
    host, prompts = workload
    if not kernel_route:
        for p, (_, k), want in zip(prompts, REQUESTS, reference_tokens):
            numpy.testing.assert_array_equal(_greedy_gather(host, p, k),
                                             want)
        return
    engine = LMEngine(host, N_HEADS, MAX_LEN, slots=3, prefill_chunk=PAGE,
                      device="cpu").start()
    got = _serve(engine, prompts)
    for g, want in zip(got, reference_tokens):
        numpy.testing.assert_array_equal(g, want)
    inv = engine.verify_pool_invariants()
    assert inv["free_pages"] == engine._pool.num_pages
    assert inv["used_pages"] == 0 and inv["pinned_pages"] == 0
    m = engine.metrics
    chunks = sum(-(-n // PAGE) for n, _ in REQUESTS)
    assert m.counter("prefill_dispatches") == chunks
    # every decode row yields exactly one token: the first token of each
    # request comes from its tail chunk, the rest from decode steps
    assert m.rows == sum(k - 1 for _, k in REQUESTS)
    assert m.counter("tokens_out") == sum(k for _, k in REQUESTS)
    steps = m.counter("decode_dispatches")
    assert max(k for _, k in REQUESTS) - 1 <= steps <= m.rows
    assert m.errors == 0


def test_unsupported_geometry_raises(workload):
    """A geometry the kernels cannot carry is refused when the engine
    is built — there is no other attention route to fall back to."""
    host, _ = workload
    # 3 kv heads of width 8 under 4 query heads: no GQA fold exists
    cut = 3 * (D_MODEL // N_HEADS)
    blocks = [dict(blk, attn=dict(blk["attn"], wk=blk["attn"]["wk"][:, :cut],
                                  wv=blk["attn"]["wv"][:, :cut]))
              for blk in host["blocks"]]
    with pytest.raises(ValueError, match="not divisible"):
        LMEngine(dict(host, blocks=blocks), N_HEADS, MAX_LEN,
                 prefill_chunk=PAGE, device="cpu")


def test_tokens_equal_reference_paged_engine(workload):
    """The reference's own paged engine on the same weights agrees with
    the port token for token."""
    host, prompts = workload
    jprng.reset()
    ref = JaxLMEngine(host, N_HEADS, MAX_LEN, slots=3, paged_kv=True,
                      prefill_chunk=PAGE, name="ref_pg").start()
    want = _serve(ref, prompts)
    engine = LMEngine(host, N_HEADS, MAX_LEN, slots=3, prefill_chunk=PAGE,
                      device="cpu").start()
    got = _serve(engine, prompts)
    for g, w in zip(got, want):
        numpy.testing.assert_array_equal(g, w)


def test_generate_batch_and_ttft(workload):
    host, prompts = workload
    engine = LMEngine(host, N_HEADS, MAX_LEN, slots=2, prefill_chunk=PAGE,
                      device="cpu").start()
    try:
        batch = numpy.stack([prompts[1][:8], prompts[3][:8]])
        out = engine.generate(batch, 4)
        fut = engine.submit(prompts[0], 3)
        fut.result(timeout=60)
    finally:
        engine.stop()
    assert out.shape == (2, 12)
    numpy.testing.assert_array_equal(out[:, :8], batch)
    assert fut.ttft_s >= 0 and fut.version == 0


@pytest.mark.parametrize("knob,value", [
    ("tp", 2), ("devices", ["cpu"]), ("temperature", 0.7),
    ("top_k", 5), ("sample_seed", 1),
    ("faults", object()), ("tracer", object()), ("paged_kv", 0),
])
def test_unported_knobs_raise(workload, knob, value):
    """Each knob not ported yet raises naming its ROADMAP item.  The
    sampling knobs serve now (``tests/test_torch_lm_sampling.py``):
    ``temperature`` alone asks for ``sample_seed``, and ``top_k`` or
    ``sample_seed`` alone leave a greedy engine.  ``faults`` arms a
    plan now (``tests/test_torch_serving_faults.py``): the engine keeps
    it and calls its ``fire`` at each site; so does ``tracer`` a span
    tracer (``tests/test_torch_tracing.py``)."""
    host, _ = workload
    if knob in ("faults", "tracer"):
        engine = LMEngine(host, N_HEADS, MAX_LEN, prefill_chunk=PAGE,
                          device="cpu", **{knob: value})
        assert getattr(engine, "_" + knob) is value
        assert knob not in lm_engine._ROADMAP
    elif knob == "temperature":
        with pytest.raises(ValueError, match="needs sample_seed"):
            LMEngine(host, N_HEADS, MAX_LEN, prefill_chunk=PAGE,
                     device="cpu", temperature=value)
    elif knob in ("top_k", "sample_seed"):
        engine = LMEngine(host, N_HEADS, MAX_LEN, prefill_chunk=PAGE,
                          device="cpu", **{knob: value})
        assert getattr(engine, knob) == value and not engine._sampling
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            LMEngine(host, N_HEADS, MAX_LEN, prefill_chunk=PAGE,
                     device="cpu", **{knob: value})


def test_unported_methods_raise(workload):
    """``swap_weights``, ``checkpoint`` and ``restore`` are ported
    (``tests/test_torch_lm_swap.py``, ``tests/test_torch_serving_faults.py``):
    a swap before ``start()`` applies at once, a quiet engine's
    checkpoint holds no request, and a state of no format is refused
    as the reference refuses it."""
    host, _ = workload
    engine = LMEngine(host, N_HEADS, MAX_LEN, prefill_chunk=PAGE,
                      device="cpu")
    assert engine.swap_weights(host) == 1 == engine.weights_version
    state = engine.checkpoint()
    assert state["format"] == 1 and state["requests"] == []
    with pytest.raises(ValueError, match="format"):
        engine.restore({})


def test_submit_validation(workload):
    host, _ = workload
    engine = LMEngine(host, N_HEADS, MAX_LEN, prefill_chunk=PAGE,
                      device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        engine.submit(numpy.zeros(60, numpy.int32), 8)
    with pytest.raises(ValueError, match="empty"):
        engine.submit([], 1)
    with pytest.raises(RuntimeError, match="not running"):
        engine.submit([1, 2], 1)
