"""The port's transformer serving subset against
``veles_tpu.ops.transformer``: bit-equal host init from the same prng
stream, a lossless param-tree round trip, and paged chunk hidden states
at rtol 1e-5 / atol 1e-5 (fp32, two frameworks' reduction orders)."""

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

from veles_tpu import prng as jprng
from veles_tpu.ops import transformer as JT
from veles_tpu_torch import prng
from veles_tpu_torch.ops import transformer as TT


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], "%s/%s" % (prefix, k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, "%s/%d" % (prefix, i))
    else:
        yield prefix, tree


@pytest.mark.parametrize("kwargs", [
    {}, {"rope": True}, {"n_kv_heads": 2}, {"rope": True, "n_kv_heads": 1},
])
def test_init_bit_equal(kwargs):
    jprng.reset()
    prng.reset()
    jprng.seed_all(5)
    prng.seed_all(5)
    want = JT.init_transformer_params(jprng.get("init"), 48, d_model=32,
                                      n_heads=4, n_layers=2, max_len=32,
                                      **kwargs)
    got = TT.init_transformer_params(prng.get("init"), 48, d_model=32,
                                     n_heads=4, n_layers=2, max_len=32,
                                     **kwargs)
    want, got = dict(_flat(want)), dict(_flat(got))
    assert sorted(want) == sorted(got)
    for key in want:
        assert got[key].dtype == want[key].dtype
        numpy.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _host(rope=False, n_kv_heads=None):
    return TT.init_transformer_params(
        prng.RandomGenerator("init", 3), 32, d_model=32, n_heads=4,
        n_layers=2, max_len=32, n_kv_heads=n_kv_heads, rope=rope)


def test_params_from_jax_round_trip():
    host = _host(n_kv_heads=2)
    model = TT.TransformerLM.from_jax(host, device="cpu")
    names = {n for n, _ in model.named_parameters()}
    assert {"embed", "pos", "blocks.1.attn.wq", "ln_f.g"} <= names
    assert not any(p.requires_grad for p in model.parameters())
    back = dict(_flat(model.tree()))
    for key, want in _flat(host):
        assert back[key].shape == want.shape       # layouts kept as-is
        numpy.testing.assert_array_equal(back[key].numpy(), want)


@pytest.mark.parametrize("rope", [False, True])
def test_paged_chunk_apply_matches_reference(rope):
    host = _host(rope=rope, n_kv_heads=2)
    rng = numpy.random.RandomState(2)
    page, m, n_pages, b, c = 8, 4, 9, 2, 3
    tokens = rng.randint(0, 32, (b, c)).astype(numpy.int32)
    pools = [(rng.randn(n_pages, 2, page, 8).astype(numpy.float32),
              rng.randn(n_pages, 2, page, 8).astype(numpy.float32))
             for _ in range(2)]
    ptab = rng.permutation(n_pages)[:b * m].reshape(b, m).astype(
        numpy.int32)
    pos = numpy.asarray([4, 17], numpy.int32)
    want_h, _ = JT.paged_chunk_apply(
        jax.tree.map(jnp.asarray, host), jnp.asarray(tokens),
        [tuple(map(jnp.asarray, pr)) for pr in pools], jnp.asarray(ptab),
        jnp.asarray(pos), 4, rope=rope, window=12, sinks=1)
    params = TT.params_from_jax(host, "cpu")
    tpools = [tuple(torch.from_numpy(a.copy()) for a in pr) for pr in pools]
    got_h, _ = TT.paged_chunk_apply(
        params, torch.from_numpy(tokens), tpools, torch.from_numpy(ptab),
        torch.from_numpy(pos), 4, rope=rope, window=12, sinks=1)
    numpy.testing.assert_allclose(got_h.numpy(), numpy.asarray(want_h),
                                  rtol=1e-5, atol=1e-5)
    numpy.testing.assert_allclose(
        TT.head_logits(params, got_h).numpy(),
        numpy.asarray(JT.head_logits(jax.tree.map(jnp.asarray, host),
                                     want_h)), rtol=1e-5, atol=1e-5)


def test_engine_accepts_a_module_or_a_tensor_tree():
    from veles_tpu_torch.serving import LMEngine
    host = _host()
    model = TT.TransformerLM.from_jax(host, device="cpu")
    for params in (model, model.tree()):
        engine = LMEngine(params, 4, 32, prefill_chunk=8, device="cpu")
        assert engine.params["blocks"][1]["w2"] is \
            model.tree()["blocks"][1]["w2"]
