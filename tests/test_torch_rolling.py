"""The port's rolling-cache decode against ``veles_tpu.ops.attention``'s
``rolling_slot_update`` / ``mha_decode_step_rolling`` and
``veles_tpu.ops.transformer.generate_rolling``.

Same inputs (numpy, from a seed; weights bit-equal from the same prng
stream) through both packages, at vocab 16, d_model 32, 4 heads, 2
layers (``tests/test_transformer.py``'s rolling geometry).  Tolerances:
the ring bookkeeping (slot, slot positions, live mask) bit-equal; one
decode step's output and caches within 1e-6 (fp32, two frameworks'
reduction orders); greedy tokens equal.
"""

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

from veles_tpu import prng as jprng
from veles_tpu.ops import attention as JA
from veles_tpu.ops import transformer as JT
from veles_tpu_torch import prng
from veles_tpu_torch.ops import attention as TA
from veles_tpu_torch.ops import transformer as TT

STEP_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU products run fastest single-threaded."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _host_params(seed, n_kv_heads=None, rope=True, max_len=16):
    """The reference's numpy param tree, checked bit-equal to the
    port's from the same stream."""
    jprng.reset()
    host = JT.init_transformer_params(
        jprng.RandomGenerator("init", seed), 16, d_model=32, n_heads=4,
        n_layers=2, max_len=max_len, n_kv_heads=n_kv_heads, rope=rope)
    mine = TT.init_transformer_params(
        prng.RandomGenerator("init", seed), 16, d_model=32, n_heads=4,
        n_layers=2, max_len=max_len, n_kv_heads=n_kv_heads, rope=rope)
    for a, b in zip(jax.tree.leaves(host), jax.tree.leaves(mine)):
        numpy.testing.assert_array_equal(a, b)
    return host


def _tensors(host):
    return TT.tree_map(torch.tensor, host)


@pytest.mark.parametrize("sinks", [0, 2])
@pytest.mark.parametrize("window", [1, 3, 4])
def test_slot_update_bit_equal(window, sinks):
    """Slot, slot positions and live mask equal the reference's at every
    position 0..40 — through the first fills, the sinks and every wrap."""
    n = sinks + window
    want_pos = jnp.full((n,), -1, jnp.int32)
    got_pos = torch.full((n,), -1, dtype=torch.int32)
    for pos in range(41):
        w_slot, want_pos, w_live = JA.rolling_slot_update(
            want_pos, jnp.asarray(pos, jnp.int32), window, sinks=sinks)
        g_slot, got_pos, g_live = TA.rolling_slot_update(
            got_pos, pos, window, sinks=sinks)
        assert isinstance(g_slot, int)
        assert g_slot == int(w_slot), pos
        assert got_pos.dtype == torch.int32
        numpy.testing.assert_array_equal(got_pos.numpy(),
                                         numpy.asarray(want_pos))
        numpy.testing.assert_array_equal(g_live.numpy(),
                                         numpy.asarray(w_live))


@pytest.mark.parametrize("n_kv_heads", [None, 2])
def test_decode_step_rolling_matches_reference(n_kv_heads):
    """Twelve steps of one attention layer over a 2-sink, 4-slot ring
    (wrapping twice): output and both caches within 1e-6 after each."""
    host = _host_params(5, n_kv_heads=n_kv_heads)["blocks"][0]["attn"]
    params = _tensors(host)
    jparams = jax.tree.map(jnp.asarray, host)
    rng = numpy.random.default_rng(3)
    kv = n_kv_heads or 4
    window, sinks = 4, 2
    shape = (2, kv, sinks + window, 8)
    want_k = jnp.zeros(shape, jnp.float32)
    want_v = jnp.zeros(shape, jnp.float32)
    got_k, got_v = torch.zeros(shape), torch.zeros(shape)
    want_pos = jnp.full((sinks + window,), -1, jnp.int32)
    got_pos = torch.full((sinks + window,), -1, dtype=torch.int32)
    for pos in range(12):
        x = rng.standard_normal((2, 1, 32)).astype(numpy.float32)
        slot, want_pos, live = JA.rolling_slot_update(
            want_pos, jnp.asarray(pos, jnp.int32), window, sinks=sinks)
        want, want_k, want_v = JA.mha_decode_step_rolling(
            jparams, jnp.asarray(x), want_k, want_v, slot, live,
            jnp.asarray(pos, jnp.int32), 4)
        g_slot, got_pos, g_live = TA.rolling_slot_update(
            got_pos, pos, window, sinks=sinks)
        # the position as a host int and as a (1,) tensor rotate alike
        rope_pos = pos if pos % 2 else torch.tensor([pos])
        got, got_k, got_v = TA.mha_decode_step_rolling(
            params, torch.from_numpy(x), got_k, got_v, g_slot, g_live,
            rope_pos, 4)
        for g, w in ((got, want), (got_k, want_k), (got_v, want_v)):
            numpy.testing.assert_allclose(g.numpy(), numpy.asarray(w),
                                          rtol=0, atol=STEP_ATOL)


GENERATE_CASES = [
    # (name, seed, n_kv_heads, prompt, n_new, window, sinks)
    ("mha_window3", 11, None, [[1, 2, 3, 4, 5], [9, 8, 7, 6, 5]], 8, 3, 0),
    ("gqa_window3", 11, 2, [[1, 2, 3, 4, 5], [9, 8, 7, 6, 5]], 8, 3, 0),
    ("sinks2_window4", 13, None, [[2, 4, 6, 8, 1]], 12, 4, 2),
    ("unbounded_window4", 11, None, [[3, 1, 4, 1]], 100, 4, 0),
    ("unbounded_sinks2", 13, None, [[2, 4, 6, 8, 1]], 80, 4, 2),
    # a prompt shorter than the sinks and than the window: slots stay -1
    ("short_prompt", 13, 2, [[7], [3]], 20, 6, 2),
]


@pytest.mark.parametrize("name,seed,kv,prompt,n_new,window,sinks",
                         GENERATE_CASES, ids=[c[0] for c in GENERATE_CASES])
def test_generate_rolling_equals_reference(name, seed, kv, prompt, n_new,
                                           window, sinks):
    host = _host_params(seed, n_kv_heads=kv)
    want = numpy.asarray(JT.generate_rolling(
        jax.tree.map(jnp.asarray, host), jnp.asarray(prompt, jnp.int32),
        n_new=n_new, n_heads=4, window=window, temperature=0, sinks=sinks))
    got = TT.generate_rolling(_tensors(host),
                              torch.tensor(prompt, dtype=torch.int32),
                              n_new, 4, window, temperature=0, sinks=sinks)
    assert got.dtype == torch.int32
    assert got.shape == (len(prompt), len(prompt[0]) + n_new)
    numpy.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kv,window,sinks", [(None, 3, 0), (2, 3, 0),
                                             (None, 4, 2), (2, 5, 3)])
def test_rolling_equals_port_generate_while_the_cache_lasts(kv, window,
                                                            sinks):
    """The port's rolling decode and its full-cache ``generate`` (rope,
    the same window and sinks) emit the same tokens up to max_len."""
    params = _tensors(_host_params(11, n_kv_heads=kv, max_len=24))
    prompt = torch.tensor([[1, 2, 3, 4, 5], [9, 8, 7, 6, 5]],
                          dtype=torch.int32)
    full = TT.generate(params, prompt, 19, 4, temperature=0, max_len=24,
                       rope=True, window=window, sinks=sinks)
    rolling = TT.generate_rolling(params, prompt, 19, 4, window,
                                  temperature=0, sinks=sinks)
    numpy.testing.assert_array_equal(rolling.numpy(), full.numpy())


def test_rolling_errors_match_reference():
    """The reference's errors: a positional table, window < 1, n_new < 1
    and top_k out of range raise ValueError, and so does sampling
    without ``rng``; sampling with one gives the reference's tokens;
    greedy decoding ignores an in-range top_k."""
    rope = _host_params(11)
    table = _host_params(11, rope=False)
    prompt = numpy.array([[1, 2]], numpy.int32)
    cases = [(table, dict(n_new=4, window=2), "RoPE"),
             (rope, dict(n_new=4, window=0), "window >= 1"),
             (rope, dict(n_new=0, window=2), "n_new must be >= 1"),
             (rope, dict(n_new=4, window=2, top_k=0), "top_k .* out of range"),
             (rope, dict(n_new=4, window=2, top_k=17),
              "top_k .* out of range")]
    for host, kw, match in cases:
        with pytest.raises(ValueError, match=match):
            JT.generate_rolling(jax.tree.map(jnp.asarray, host),
                                jnp.asarray(prompt), n_heads=4,
                                temperature=0, **kw)
        with pytest.raises(ValueError, match=match):
            TT.generate_rolling(_tensors(host), torch.from_numpy(prompt),
                                n_heads=4, temperature=0, **kw)
    params = _tensors(rope)
    with pytest.raises(ValueError, match="needs rng"):
        TT.generate_rolling(params, torch.from_numpy(prompt), 4, 4, 2,
                            temperature=0.8)
    numpy.testing.assert_array_equal(
        TT.generate_rolling(params, torch.from_numpy(prompt), 4, 4, 2,
                            rng=prng.PRNGKey(3), temperature=0.8).numpy(),
        numpy.asarray(JT.generate_rolling(
            jax.tree.map(jnp.asarray, rope), jnp.asarray(prompt), 4, 4, 2,
            rng=jax.random.PRNGKey(3), temperature=0.8)))
    numpy.testing.assert_array_equal(
        TT.generate_rolling(params, torch.from_numpy(prompt), 6, 4, 2,
                            temperature=0, top_k=5).numpy(),
        TT.generate_rolling(params, torch.from_numpy(prompt), 6, 4, 2,
                            temperature=0).numpy())


def test_rolling_cache_stays_window_sized(monkeypatch):
    """The decode loop allocates its caches once at sinks + window
    slots, whatever ``n_new`` is: every cache write lands in a
    (batch, kv_heads, sinks + window, head_dim) tensor."""
    params = _tensors(_host_params(11, n_kv_heads=2))
    seen = set()
    step = TA.mha_decode_step_rolling

    def spy(p, x, kc, vc, slot, live, pos, n_heads):
        seen.add((tuple(kc.shape), tuple(vc.shape), tuple(live.shape)))
        assert torch.is_tensor(pos) and pos.shape == (1,)
        return step(p, x, kc, vc, slot, live, pos, n_heads)

    monkeypatch.setattr(TT, "mha_decode_step_rolling", spy)
    TT.generate_rolling(params, torch.tensor([[1, 2, 3]]), 60, 4, 5,
                        temperature=0, sinks=2)
    assert seen == {((1, 2, 7, 8), (1, 2, 7, 8), (7,))}
