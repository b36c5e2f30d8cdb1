"""The port's seeded sampling against the reference's: ``prng``'s device
half against ``jax.random``, ``sample_token``, ``generate`` and
``generate_rolling`` with ``rng``, every ``LMEngine`` decode path under
``temperature``/``top_k``/``sample_seed``, and ``serve_lm`` over HTTP.

Same inputs (numpy, from seeds; weights from one prng stream, carried
to the reference as numpy arrays) through both packages at vocab 64,
d_model 32, 2 heads, 2 layers, max_len 96, on the CPU.  Tolerances:
keys, bits and uniforms bit-equal; the gumbel draw within 4e-6 (the two
``log`` implementations differ by about an ulp); sampled tokens EQUAL,
except where the reference's two best perturbed scores at the first
differing position lie within 1e-5 of each other (a near tie, counted
in the ``near_ties`` junit property; no seed is changed to avoid one).
"""

import json
import re
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

from veles_tpu.ops import transformer as JT
from veles_tpu.serving.lm_engine import LMEngine as JaxLMEngine
from veles_tpu_torch import prng
from veles_tpu_torch.ops import hopper_kernels as HK
from veles_tpu_torch.ops import transformer as TT
from veles_tpu_torch.restful_api import SERVE_LM_UNPORTED, serve_lm
from veles_tpu_torch.serving import FaultPlan, LMEngine

VOCAB, D_MODEL, N_HEADS, N_LAYERS, MAX_LEN = 64, 32, 2, 2, 96
#: the reference's seeded-sampling knobs (tests/test_lm_fastpath.py)
SEED_KW = dict(temperature=0.8, top_k=5, sample_seed=123)
GUMBEL_ATOL = 4e-6
NEAR_TIE = 1e-5
PROMPTS = [[1, 2, 3], [2, 4, 6, 8, 10], [7, 7], [5, 1, 5, 1, 5, 1, 5, 1, 5],
           list(range(40, 60)) * 2]
N_NEW = 12
#: the port's decode paths, each held to ONE reference engine run
MODES = {
    "tick": {},
    "chunked": {"prefill_chunk": 8},
    "scan": {"megastep": 4},
    "while": {"megastep": 4, "megastep_mode": "while"},
    "while_spec": {"megastep": 4, "megastep_mode": "while", "spec_k": 3,
                   "prefill_chunk": 8},
    "while_ring": {"megastep": 4, "megastep_mode": "while",
                   "refill_ring": 2, "prefill_chunk": 8},
}


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU products run fastest single-threaded."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def host():
    prng.reset()
    return TT.init_transformer_params(
        prng.RandomGenerator("init", 7), VOCAB, d_model=D_MODEL,
        n_heads=N_HEADS, n_layers=N_LAYERS, max_len=MAX_LEN)


def _jax(host):
    return jax.tree.map(jnp.asarray, host)


def _scaled(logits, temperature, top_k):
    """The top-k mask and division of the reference's ``sample_token``
    on one (vocab,) row of logits."""
    lg = jnp.asarray(logits)
    if top_k:
        cut = jax.lax.top_k(lg, top_k)[0][-1]
        lg = jnp.where(lg >= cut, lg, JT.NEG_INF_LOGIT)
    return numpy.asarray(lg / jnp.float32(temperature))


def _perturbed(logits, key, temperature, top_k):
    """The reference's perturbed scores of one (vocab,) row drawn under
    its own ``key``: ``jax.random.gumbel`` plus :func:`_scaled` — what
    ``jax.random.categorical`` takes the argmax of."""
    return (numpy.asarray(jax.random.gumbel(key, (VOCAB,)))
            + _scaled(logits, temperature, top_k))


def _gap(scores):
    top = numpy.sort(scores)[-2:]
    return float(top[1] - top[0])


def _near_ties(got, want, scores_at, record_property):
    """Assert ``got`` equals ``want`` row by row but at near ties: at a
    row's first differing token j, ``scores_at(row, j)`` (the
    reference's perturbed scores there) must have its two best within
    NEAR_TIE.  Records the count; returns it."""
    ties = 0
    for r, (a, b) in enumerate(zip(got, want)):
        diff = numpy.flatnonzero(numpy.asarray(a) != numpy.asarray(b))
        if len(diff):
            gap = _gap(scores_at(r, int(diff[0])))
            assert gap <= NEAR_TIE, (r, int(diff[0]), gap, a, b)
            ties += 1
    record_property("near_ties", ties)
    return ties


def _engine_scores(host, prompts, want, base):
    """``scores_at(row, j)`` for engine outputs: the reference's logits
    after prompt + want[:j] (a full forward) under the key of the
    request's admission id (row + 1) at position len(prompt) + j."""
    params = _jax(host)

    def at(r, j):
        seq = list(prompts[r]) + list(want[r][:j])
        logits = JT.transformer_forward(
            params, jnp.asarray([seq], jnp.int32), N_HEADS)[0, -1]
        key = jax.random.fold_in(jax.random.fold_in(
            jnp.asarray(base), r + 1), len(seq))
        return _perturbed(logits, key, SEED_KW["temperature"],
                          SEED_KW["top_k"])
    return at


# ------------------------------------------------------------ prng half
@pytest.mark.parametrize("data", [0, 1, 123, 2 ** 31 - 1, -1, -5])
def test_fold_in_words_bit_equal(data):
    key = jax.random.PRNGKey(11)
    want = numpy.asarray(jax.jit(jax.random.fold_in)(key, jnp.int32(data)))
    k0, k1 = prng.fold_in_words(0, 11, torch.tensor([data],
                                                    dtype=torch.int32))
    assert [int(k0[0]), int(k1[0])] == want.tolist()
    # the engine's chain, base then seed then position, on rows at once
    base = prng.RandomGenerator("lm-sample", 123).base_key()
    seeds = torch.tensor([data, 7], dtype=torch.int32)
    pos = torch.tensor([5, data & 0x7FFF], dtype=torch.int32)
    k0, k1 = prng.fold_in_words(*(int(w) for w in base), seeds)
    k0, k1 = prng.fold_in_words(k0, k1, pos)
    for r in range(2):
        ref = jax.jit(jax.random.fold_in)(jax.jit(jax.random.fold_in)(
            jnp.asarray(base), seeds[r].item()), pos[r].item())
        assert [int(k0[r]), int(k1[r])] == numpy.asarray(ref).tolist()


@pytest.mark.parametrize("seed,shape", [(0, (4, 64)), (3, (1000,)),
                                        (9, (2, 3, 256))])
def test_bits_uniform_split_bit_equal_gumbel_within_tolerance(seed, shape):
    key = jax.random.PRNGKey(seed)
    mine = prng.PRNGKey(seed)
    pair = numpy.asarray(jax.random.split(key))
    assert (prng.split(mine) == pair).all()
    k0, k1 = (int(w) for w in mine)
    n = int(numpy.prod(shape))
    bits = prng.bits_words(k0, k1, torch.arange(n, dtype=torch.int64))
    want_bits = numpy.asarray(jax.random.bits(key, shape)).reshape(-1)
    assert (bits.numpy().astype(numpy.uint32) == want_bits).all()
    tiny = numpy.finfo(numpy.float32).tiny
    want_u = numpy.asarray(jax.random.uniform(key, shape, minval=tiny,
                                              maxval=1.)).reshape(-1)
    got_u = prng.uniform_tiny(bits).numpy()
    assert (got_u.view(numpy.int32) == want_u.view(numpy.int32)).all()
    want_g = numpy.asarray(jax.random.gumbel(key, shape)).reshape(-1)
    numpy.testing.assert_allclose(prng.gumbel_tensor(bits).numpy(), want_g,
                                  rtol=0, atol=GUMBEL_ATOL)


# ---------------------------------------------------------- sample_token
@pytest.mark.parametrize("top_k", [0, 1, 5, VOCAB])
@pytest.mark.parametrize("temperature", [0.5, 1.0, 2.0])
def test_sample_token_equals_reference(temperature, top_k, record_property):
    """Six rows under one key (generate's mode), logits with exact ties
    (at the top-k cutoff too)."""
    rng = numpy.random.RandomState(int(temperature * 10) + top_k)
    lg = (rng.randn(6, VOCAB) * 2).astype(numpy.float32)
    lg[:, 1::9] = lg[:, :1]
    key = prng.fold_in(prng.PRNGKey(3), top_k)
    want = numpy.asarray(JT.sample_token(jnp.asarray(key), jnp.asarray(lg),
                                         temperature, top_k))
    got = TT.sample_token(key, torch.from_numpy(lg), temperature, top_k)
    assert got.dtype == torch.int32 and got.shape == (6,)
    flat = numpy.asarray(jax.random.gumbel(jnp.asarray(key), lg.shape))

    def scores(r, _):
        return flat[r] + _scaled(lg[r], temperature, top_k)
    _near_ties(got.numpy()[:, None], want[:, None], scores, record_property)
    if top_k:
        cut = numpy.sort(lg, axis=1)[:, -top_k]
        assert (lg[numpy.arange(6), got.numpy()] >= cut).all()


def test_sample_token_engine_keys_equal_the_references_pick():
    """The engine's mode: row keys fold_in(fold_in(base, seed), pos),
    counters 0..vocab-1, against the reference engine's ``pick1``."""
    rng = numpy.random.RandomState(4)
    lg = rng.randn(8, VOCAB).astype(numpy.float32)
    seeds = rng.randint(1, 100, 8).astype(numpy.int32)
    pos = rng.randint(0, MAX_LEN, 8).astype(numpy.int32)
    base = prng.RandomGenerator("lm-sample", 123).base_key()

    def pick1(logits, seed, p):
        key = jax.random.fold_in(jax.random.fold_in(jnp.asarray(base),
                                                    seed), p)
        return JT.sample_token(key, logits, 0.8, 5)
    want = numpy.asarray(jax.vmap(pick1)(jnp.asarray(lg), jnp.asarray(seeds),
                                         jnp.asarray(pos)))
    got = HK.sample_token(torch.from_numpy(lg), 0.8, base, 5,
                          torch.from_numpy(seeds), torch.from_numpy(pos))
    numpy.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------ the two decoders
@pytest.mark.parametrize("temperature,top_k", [(0.8, None), (1.3, 5),
                                               (0.5, 1)])
def test_generate_samples_the_references_tokens(host, temperature, top_k,
                                                record_property):
    """``generate`` with ``rng``: the reference's split chain and draws,
    over a padded prompt with ``true_len`` too."""
    prompt = numpy.random.RandomState(1).randint(0, VOCAB, (3, 10)).astype(
        numpy.int32)
    ties = 0
    for kw in ({}, {"true_len": 7, "max_len": 40}):
        want = numpy.asarray(JT.generate(
            _jax(host), jnp.asarray(prompt), 20, N_HEADS,
            rng=jax.random.PRNGKey(3), temperature=temperature, top_k=top_k,
            **kw))
        got = TT.generate(TT.params_from_jax(host, "cpu"),
                          torch.from_numpy(prompt), 20, N_HEADS,
                          rng=prng.PRNGKey(3), temperature=temperature,
                          top_k=top_k, **kw).numpy()
        start = kw.get("true_len", prompt.shape[1])

        def scores(r, j):
            # step j's sub-key of the split chain draws one gumbel array
            # over the whole (batch, vocab)
            key = jax.random.PRNGKey(3)
            for _ in range(j + 1):
                key, sub = jax.random.split(key)
            seq = list(want[r, :start]) + list(want[r, 10:10 + j])
            logits = JT.transformer_forward(
                _jax(host), jnp.asarray([seq], jnp.int32), N_HEADS)[0, -1]
            gumbel = numpy.asarray(jax.random.gumbel(sub, (len(want),
                                                           VOCAB)))
            return gumbel[r] + _scaled(logits, temperature, top_k or 0)
        ties += _near_ties(got[:, 10:], want[:, 10:], scores,
                           record_property)
    record_property("near_ties", ties)


def test_generate_rolling_samples_the_references_tokens():
    prng.reset()
    rope = TT.init_transformer_params(
        prng.RandomGenerator("init", 8), VOCAB, d_model=D_MODEL,
        n_heads=N_HEADS, n_layers=N_LAYERS, max_len=MAX_LEN, rope=True)
    prompt = numpy.random.RandomState(2).randint(0, VOCAB, (2, 10)).astype(
        numpy.int32)
    want = numpy.asarray(JT.generate_rolling(
        _jax(rope), jnp.asarray(prompt), 30, N_HEADS, 8,
        rng=jax.random.PRNGKey(4), temperature=0.7, top_k=10, sinks=2))
    got = TT.generate_rolling(TT.params_from_jax(rope, "cpu"),
                              torch.from_numpy(prompt), 30, N_HEADS, 8,
                              rng=4, temperature=0.7, top_k=10, sinks=2)
    numpy.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ the engine
@pytest.fixture(scope="module")
def reference_tokens(host):
    """ONE reference engine run (contiguous, per tick) with SEED_KW: the
    tokens every port mode must sample (keys depend on (seed, position)
    alone)."""
    engine = JaxLMEngine(_jax(host), n_heads=N_HEADS, max_len=MAX_LEN,
                         slots=2, name="sampling_ref", **SEED_KW).start()
    try:
        futures = [engine.submit(p, N_NEW) for p in PROMPTS]
        return [numpy.asarray(f.result(timeout=300)) for f in futures]
    finally:
        engine.stop()


def _serve(host, prompts, n_new, **knobs):
    engine = LMEngine(host, N_HEADS, MAX_LEN, slots=2, device="cpu",
                      name="sampling", **dict(SEED_KW, **knobs)).start()
    try:
        futures = [engine.submit(p, n_new) for p in prompts]
        return [f.result(timeout=300) for f in futures], engine
    finally:
        engine.stop()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_mode_samples_the_references_tokens(host, reference_tokens,
                                                   mode, record_property):
    got, engine = _serve(host, PROMPTS, N_NEW, **MODES[mode])
    base = prng.RandomGenerator("lm-sample", 123).base_key()
    _near_ties(got, reference_tokens,
               _engine_scores(host, PROMPTS, reference_tokens, base),
               record_property)
    assert engine.verify_pool_invariants()["used_pages"] == 0
    counters = engine.metrics.snapshot()["counters"]
    if mode == "while_ring":
        assert counters["megastep_refills"] > 0
    if mode == "while_spec":
        assert counters["draft_tokens"] > 0


def test_engine_reproducible_and_seed_sensitive(host):
    """The same seed on a FRESH engine gives the same stream; another
    sample_seed, and another admission order, give other streams."""
    a, _ = _serve(host, PROMPTS[:2], 8)
    b, _ = _serve(host, PROMPTS[:2], 8)
    c, _ = _serve(host, PROMPTS[:2], 8, sample_seed=321)
    d, _ = _serve(host, PROMPTS[1::-1], 8)
    assert all((x == y).all() for x, y in zip(a, b))
    assert any((x != y).any() for x, y in zip(a, c))
    assert any((x != y).any() for x, y in zip(a, d[::-1]))


def test_engine_greedy_default_unchanged(host):
    """temperature 0 (the default) threads no key: no seeds staged, no
    draw launched, and the tokens equal the reference's greedy
    ``generate``."""
    engine = LMEngine(host, N_HEADS, MAX_LEN, slots=2, device="cpu",
                      megastep=4, megastep_mode="while", refill_ring=1,
                      prefill_chunk=8, name="greedy").start()
    calls = []
    real = HK.sample_token_ref
    HK.sample_token_ref = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        out = engine.submit(PROMPTS[1], 9).result(timeout=120)
    finally:
        HK.sample_token_ref = real
        engine.stop()
    assert engine._sample_key is None and "seeds" not in engine._ms_host
    assert not calls
    want = numpy.asarray(JT.generate(
        _jax(host), jnp.asarray([PROMPTS[1]], jnp.int32), 9, N_HEADS,
        temperature=0.0))[0, len(PROMPTS[1]):]
    numpy.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("knobs,error,match", [
    ({"temperature": 0.8}, ValueError, "sample_seed"),
    ({"temperature": -1.0, "sample_seed": 1}, ValueError, ">= 0"),
    ({"top_k": -2}, ValueError, ">= 0"),
    ({"temperature": 0.8, "top_k": VOCAB + 1, "sample_seed": 1},
     ValueError, "top_k"),
])
def test_engine_sampling_validation(host, knobs, error, match):
    with pytest.raises(error, match=match):
        LMEngine(host, N_HEADS, MAX_LEN, slots=1, device="cpu", **knobs)


# -------------------------------------------------------------- serve_lm
def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def workflow():
    """A char-LM workflow at this file's width, built and initialized on
    the CPU (random weights from a seeded stream)."""
    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples import char_lm
    prng.reset()
    prng.seed_all(4)
    saved = root.__dict__.pop("char_lm", None)
    root.char_lm.update({
        "loader": {"minibatch_size": 8, "n_train": 16, "n_valid": 8,
                   "seq_len": 32, "vocab": VOCAB},
        "trainer": {"vocab": VOCAB, "d_model": D_MODEL, "n_heads": N_HEADS,
                    "n_layers": N_LAYERS, "max_len": MAX_LEN}})
    try:
        wf = char_lm.build()
        wf.initialize(device="cpu")
    finally:
        root.__dict__.pop("char_lm", None)
        if saved is not None:
            root.__dict__["char_lm"] = saved
    return wf


def _reference_trainer(wf):
    """The reference's ``trainer_sample_tokens`` reads the trainer's
    n_heads (and rope/window/sinks) and takes the params given."""
    host = TT.tree_map(lambda t: t.detach().numpy(), wf.trainer.params)
    return SimpleNamespace(n_heads=N_HEADS), _jax(host)


def test_serve_lm_over_http(workflow):
    """Greedy requests through the engine equal ``generate``'s tokens
    (with a weights_version a row); a sampled body with a seed through
    the direct path equals the reference's ``trainer_sample_tokens``
    (its tier and bucket cut back to n_new); n_new 0 echoes; a prompt
    with no headroom is a 400."""
    api = serve_lm(workflow, port=0, slots=2, megastep=4, max_new=32)
    url = "http://127.0.0.1:%d/predict" % api.port
    try:
        prompt = [[3, 1, 4, 1, 5], [2, 7, 1, 8, 2]]
        code, body = _post(url, {"input": prompt, "n_new": 6})
        assert code == 200 and body["weights_version"] == [0, 0]
        params = TT.tree_map(lambda t: t, workflow.trainer.params)
        want = TT.generate(params, torch.tensor(prompt, dtype=torch.int32),
                           6, N_HEADS, temperature=0.0).numpy()
        numpy.testing.assert_array_equal(body["tokens"], want)
        assert api.lm_engine.metrics.snapshot()["counters"][
            "tokens_out"] == 12
        ref_trainer, ref_params = _reference_trainer(workflow)
        for n_new, kw in ((6, {"top_k": 5}), (20, {})):
            code, body = _post(url, dict(input=prompt, n_new=n_new,
                                         temperature=0.9, seed=17, **kw))
            assert code == 200 and "weights_version" not in body
            # the direct path: tier 8 or 32, bucket 16, true_len 5
            run = 8 if n_new <= 8 else 32
            padded = numpy.pad(numpy.asarray(prompt, numpy.int32),
                               ((0, 0), (0, 11)))
            full = JT.trainer_sample_tokens(
                ref_trainer, padded, n_new=run, temperature=0.9, seed=17,
                params=ref_params, max_len=MAX_LEN, true_len=5, **kw)
            want = numpy.concatenate([full[:, :5], full[:, 16:16 + n_new]],
                                     axis=1)
            numpy.testing.assert_array_equal(body["tokens"], want)
        code, body = _post(url, {"input": prompt, "n_new": 0})
        assert code == 200 and body["tokens"] == prompt
        code, body = _post(url, {"input": [[1] * MAX_LEN], "n_new": 4})
        assert code == 400 and "no room to decode" in body["error"]
    finally:
        api.stop()
    assert api.lm_engine._thread is None


def test_serve_lm_fleet_over_http(workflow):
    """``replicas=2`` behind the round-robin router: greedy rows equal
    ``generate``'s and carry per-row replica stamps, the placements
    split evenly, ``/metrics`` renders one ``# TYPE`` line a family with
    a ``{replica="0"}`` and a ``{replica="1"}`` row, and
    ``/metrics.json`` embeds both replicas' snapshots."""
    api = serve_lm(workflow, port=0, slots=2, replicas=2,
                   router="round_robin", max_new=32)
    base = "http://127.0.0.1:%d" % api.port
    try:
        prompts = [[3, 1, 4, 1, 5], [2, 7, 1, 8, 2], [9, 9, 9, 9, 9],
                   [1, 2, 3, 4, 5], [6, 5, 4, 3, 2], [8, 8, 1, 1, 8]]
        seen = []
        for pair in (prompts[:2], prompts[2:4], prompts[4:]):
            code, body = _post(base + "/predict", {"input": pair,
                                                   "n_new": 6})
            assert code == 200 and body["weights_version"] == [0, 0]
            want = TT.generate(workflow.trainer.params,
                               torch.tensor(pair, dtype=torch.int32), 6,
                               N_HEADS, temperature=0.0).numpy()
            numpy.testing.assert_array_equal(body["tokens"], want)
            assert len(body["replicas"]) == 2
            seen += body["replicas"]
        assert sorted(seen) == [0, 0, 0, 1, 1, 1]
        assert api.lm_engine.routed_counts() == [3, 3]
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            text = r.read().decode()
        lines = text.splitlines()
        types = [line for line in lines if line.startswith("# TYPE ")]
        assert len(types) == len(set(types)) > 0
        for i in (0, 1):
            row = 'veles_serving_tokens_out_total{engine="lm",replica="%d"} 18'
            assert row % i in lines
            assert ('veles_serving_routed_requests_total{engine="lm_router",'
                    'replica="%d"} 3' % i) in lines
        with urllib.request.urlopen(base + "/metrics.json",
                                    timeout=60) as r:
            snap = json.loads(r.read())
        assert len(snap["replicas"]) == 2
        assert [s["counters"]["tokens_out"] for s in snap["replicas"]] \
            == [18, 18]
        assert snap["gauges"]["replicas_live"] == 2
    finally:
        api.stop()
    assert all(e._thread is None for e in api.lm_engine.replicas)


def test_serve_lm_resilient_fleet_over_http(workflow):
    """``replicas=2`` with the health checker, two retries and the SLO
    monitor: greedy rows equal ``generate``'s, ``/metrics`` renders one
    ``# TYPE`` line for ``replica_health_state`` with both replicas'
    rows (0: healthy), and the monitor's checker is the server's."""
    from veles_tpu_torch.serving import HealthChecker, timeseries
    old = timeseries.get_default()
    api = serve_lm(workflow, port=0, slots=2, replicas=2, health=True,
                   retries=2, slo=True, max_new=32)
    base = "http://127.0.0.1:%d" % api.port
    try:
        checker = api.health_checker
        assert isinstance(checker, HealthChecker)
        assert api.slo.checker is checker
        assert api.lm_engine.retries == 2
        pair = [[3, 1, 4, 1, 5], [2, 7, 1, 8, 2]]
        code, body = _post(base + "/predict", {"input": pair, "n_new": 6})
        want = TT.generate(workflow.trainer.params,
                           torch.tensor(pair, dtype=torch.int32), 6,
                           N_HEADS, temperature=0.0).numpy()
        assert code == 200
        numpy.testing.assert_array_equal(body["tokens"], want)
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            lines = r.read().decode().splitlines()
        types = [line for line in lines
                 if line.startswith("# TYPE ")
                 and "replica_health_state" in line]
        assert len(types) == 1, types
        for i in (0, 1):
            assert ('veles_serving_replica_health_state{engine="lm_router",'
                    'replica="%d"} 0' % i) in lines
        assert checker.states() == [HealthChecker.HEALTHY] * 2
    finally:
        api.stop()
        timeseries.set_default(old)
    assert api.health_checker is None and checker._thread is None
    assert all(e._thread is None for e in api.lm_engine.replicas)


def test_serve_lm_without_slots_samples_directly(workflow):
    """slots 0: every request, greedy or sampled, takes the direct path
    (no engine), and greedy rows equal ``generate``'s."""
    api = serve_lm(workflow, port=0)
    try:
        assert api.lm_engine is None
        url = "http://127.0.0.1:%d/predict" % api.port
        code, body = _post(url, {"input": [[9, 9, 9]], "n_new": 3})
        want = TT.generate(workflow.trainer.params,
                           torch.tensor([[9, 9, 9]], dtype=torch.int32), 3,
                           N_HEADS, temperature=0.0).numpy()
        assert code == 200
        numpy.testing.assert_array_equal(body["tokens"], want)
    finally:
        api.stop()


#: ``fault_plan``, ``trace``, ``telemetry``, ``slo``, ``replicas``,
#: ``router`` and the resilience knobs (``health``, ``hedge``,
#: ``retries``) are ported: their cases check that each arms the server
#: and its engine (the fleet's: a router over that many replicas)
PORTED_KNOBS = (("fault_plan", None, None), ("trace", None, None),
                ("telemetry", 0.0, None), ("slo", None, None),
                ("replicas", 1, None), ("router", "metrics", None),
                ("health", False, None), ("hedge", 0.0, None),
                ("retries", 0, None))
LATER_KNOBS = SERVE_LM_UNPORTED + PORTED_KNOBS


def _serve_armed(workflow, knob):
    """serve_lm with the ported ``knob`` set: the server and its engine
    hold what it arms (the process's default telemetry store restored
    after)."""
    from veles_tpu_torch.serving import timeseries
    old = timeseries.get_default()
    from veles_tpu_torch.serving import Router
    value = {"fault_plan": FaultPlan(), "trace": "all", "telemetry": 0.5,
             "slo": True, "replicas": 2, "router": "round_robin",
             "health": True, "hedge": 0.5, "retries": 2}[knob]
    # the policy only matters behind a fleet: two replicas carry it
    fleet = {"replicas": 2} if knob == "router" else {}
    api = serve_lm(workflow, port=0, slots=1, **fleet, **{knob: value})
    try:
        engine = api.lm_engine
        if knob in ("replicas", "router"):
            assert isinstance(engine, Router) and len(engine.replicas) == 2
            assert engine.policy == ("round_robin" if knob == "router"
                                     else "metrics")
            assert [e.name for e in engine.replicas] == ["lm_r0", "lm_r1"]
            assert all(e._thread is not None for e in engine.replicas)
        elif knob in ("health", "hedge", "retries"):
            # any resilience knob wraps the one engine in a router; the
            # engine keeps its name and no replica label
            assert isinstance(engine, Router) and len(engine.replicas) == 1
            [lone] = engine.replicas
            assert lone.name == "lm" and lone._thread is not None
            assert "replica" not in lone.metrics.labels
            checker = api.health_checker
            if knob == "health":
                assert checker is not None and checker.router is engine
                assert checker._thread is not None
                assert checker.probe_timeout_s == 15.0    # deadline 30 s
            else:
                assert checker is None
                assert (engine.retries, engine.hedge_after_s) == (
                    (2, 0.0) if knob == "retries" else (0, 0.5))
                assert (engine._hedge_thread is not None) \
                    == (knob == "hedge")
        elif knob == "fault_plan":
            assert api.faults is value and engine._faults is value
        elif knob == "trace":
            assert api.tracer.mode == "all" and engine._tracer is api.tracer
        else:
            assert api.telemetry.interval_s == (0.5 if knob == "telemetry"
                                                else 1.0)
            assert timeseries.get_default() is api.telemetry
            assert (api.slo is not None) == (knob == "slo")
    finally:
        api.stop()
        timeseries.set_default(old)


@pytest.mark.parametrize("knob,default,item", LATER_KNOBS,
                         ids=[k for k, _, _ in LATER_KNOBS])
def test_serve_lm_later_knobs_raise_naming_their_items(workflow, knob,
                                                       default, item):
    """The fleet's deploy knobs and ``tp`` raise naming their items
    (9(c), 4); the ported ones arm the server instead."""
    if item is None:
        _serve_armed(workflow, knob)
        return
    value = {bool: True, int: 2, float: 0.5, str: "x",
             type(None): "set"}[type(default)]
    if isinstance(default, bool):
        value = not default
    with pytest.raises(NotImplementedError,
                       match=re.escape(item.split(" (")[0])):
        serve_lm(workflow, port=0, slots=1, **{knob: value})


def test_serve_lm_contiguous_layout_and_attn_kernel_refused(workflow):
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        serve_lm(workflow, port=0, slots=1, paged_kv=0)
    with pytest.raises(TypeError):
        serve_lm(workflow, port=0, slots=1, attn_kernel="auto")
