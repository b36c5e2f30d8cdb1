"""The port's fused K-step decode (``megastep=K``) against the reference.

The same weights (from one numpy prng stream) serve the same prompts
through ``veles_tpu_torch``'s ``LMEngine`` on the CPU (the fused body as
a host loop of K iterations), through ``veles_tpu``'s paged ``LMEngine``
with the same knobs (its ``lax.scan`` megastep) and through
``veles_tpu``'s ``generate``: the greedy tokens must be EQUAL.  With
requests awaited one at a time the two engines must also keep the same
books — the ``megastep_*``, draft, prefix and dispatch counters, each
request's page table, the trie's page ids, the pool's refs, pins and
free list — after every request.  The two in-graph helpers
(``propose_draft_in_graph``, the masked ``paged_write``) are held to the
reference's on their own, and the boundary cases (deadline shedding, a
fault inside a fused dispatch) to the reference's own tests of them.
"""

import time

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

from veles_tpu import prng as jprng
from veles_tpu.ops import attention as JA
from veles_tpu.ops import transformer as JT
from veles_tpu.serving.lm_engine import LMEngine as JaxLMEngine
from veles_tpu_torch import prng
from veles_tpu_torch.ops import attention as A
from veles_tpu_torch.ops.transformer import (init_transformer_params,
                                             propose_draft_in_graph)
from veles_tpu_torch.serving import DeadlineExceeded, LMEngine

VOCAB, D_MODEL, N_HEADS, N_LAYERS, PAGE = 32, 32, 4, 2, 8
#: the engines' lane span (a short ladder: widths 1, 2, 4, 8 pages); the
#: weights' learned positions reach PARAMS_LEN for ``generate``
MAX_LEN, PARAMS_LEN = 64, 128
GEN_WIDTH, GEN_NEW = 48, 24

_rng = numpy.random.RandomState(21)
SHARED = _rng.randint(0, VOCAB, 16).tolist()                # 2 full pages
_FIRST = SHARED + _rng.randint(0, VOCAB, 5).tolist()
#: 4 prompts through 2 slots (slot reuse): two sharing a 2-page prefix,
#: the second repetitive (drafts lock on) with a reservation that ends at
#: ``MAX_LEN`` under ``spec_k`` 3 (40 + 21 + 3), a short periodic one,
#: and an exact repeat of the first (its chunks hit the cache)
REQUESTS = [
    (_FIRST, 12),
    (SHARED + [3, 1, 4, 1, 5, 9, 2, 6] * 3, 21),
    ([5, 1] * 5, 20),
    (list(_FIRST), 9),
]
SPEC_K = 3
#: the feature sets held to the reference; ``paged_kv=12`` is a pool
#: smaller than two lanes' full spans
FEATURE_SETS = {
    "plain_k4": {"megastep": 4},
    "prefix_spec_k8": {"megastep": 8, "prefix_cache": 32, "spec_k": SPEC_K},
    "prefix_pool12_k4": {"megastep": 4, "prefix_cache": 32, "paged_kv": 12},
}
#: the counters the two engines share by name and meaning
COUNTERS = ("megastep_dispatches", "megastep_tokens",
            "megastep_lane_iterations", "megastep_wasted_iterations",
            "decode_dispatches", "draft_tokens", "draft_accepted",
            "tokens_out", "prefix_hit_tokens", "kv_cow_copies")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def host():
    prng.reset()
    return init_transformer_params(prng.RandomGenerator("init", 21), VOCAB,
                                   d_model=D_MODEL, n_heads=N_HEADS,
                                   n_layers=N_LAYERS, max_len=PARAMS_LEN)


@pytest.fixture(scope="module")
def greedy(host):
    """``greedy(prompt, n_new)``: the reference ``generate``'s tokens (one
    compile: every prompt right-padded to one width with ``true_len``)."""
    params = jax.tree.map(jnp.asarray, host)
    memo = {}

    def run(prompt, n_new):
        key = tuple(prompt)
        if key not in memo:
            row = numpy.pad(numpy.asarray(prompt, numpy.int32),
                            (0, GEN_WIDTH - len(prompt)))[None]
            toks = numpy.asarray(JT.generate(
                params, jnp.asarray(row), GEN_NEW, N_HEADS,
                temperature=0.0, max_len=GEN_WIDTH + GEN_NEW,
                true_len=len(prompt)))[0]
            memo[key] = toks[GEN_WIDTH:]
        return memo[key][:n_new]
    return run


def _port(host, slots=2, **knobs):
    return LMEngine(host, N_HEADS, MAX_LEN, slots=slots, prefill_chunk=PAGE,
                    device="cpu", **knobs)


def _reference(host, slots=2, **knobs):
    knobs = dict({"paged_kv": True}, **knobs)
    return JaxLMEngine(host, N_HEADS, MAX_LEN, slots=slots,
                       prefill_chunk=PAGE, name="ref_ms", **knobs)


def _trie_pages(engine):
    out, stack = {}, [(engine._trie.root, ())]
    while stack:
        node, path = stack.pop()
        for key, child in node.children.items():
            out[path + key] = child.rows
            stack.append((child, path + key))
    return out


def _books(engine):
    c = engine.metrics.snapshot()["counters"]
    books = {"counters": {k: c.get(k, 0) for k in COUNTERS},
             "pool": engine._pool.snapshot(),
             "invariants": engine.verify_pool_invariants()}
    if engine._trie is not None:
        books["trie"] = _trie_pages(engine)
        books["live_pins"] = engine._trie.live_pins()
    return books


def _serve_sequential(engine):
    """Each request awaited before the next: (tokens, its page table,
    the books after it) per request."""
    tables = []
    finish = engine._finish

    def recording(slot):
        tables.append(engine._page_tables[slot].tolist())
        finish(slot)
    engine._finish = recording
    out = []
    for prompt, n_new in REQUESTS:
        toks = engine.submit(prompt, n_new).result(timeout=120)
        out.append((toks, tables[-1], _books(engine)))
    return out


def _serve_concurrent(engine):
    futures = [engine.submit(p, n) for p, n in REQUESTS]
    return [f.result(timeout=120) for f in futures]


@pytest.fixture(scope="module", params=sorted(FEATURE_SETS))
def reference(request, host):
    """One reference engine per feature set: its sequential run, then
    the same requests all at once."""
    jprng.reset()
    engine = _reference(host, **FEATURE_SETS[request.param]).start()
    try:
        sequential = _serve_sequential(engine)
        concurrent = _serve_concurrent(engine)
    finally:
        engine.stop()
    return request.param, sequential, concurrent


def test_tokens_equal_reference(host, greedy, reference):
    """All requests at once through two lanes: the port's tokens equal
    the reference megastep engine's and ``generate``'s."""
    name, _, want = reference
    engine = _port(host, **FEATURE_SETS[name]).start()
    try:
        assert sorted(engine._megastep_programs) == engine._width_ladder
        got = _serve_concurrent(engine)
    finally:
        engine.stop()
    for (prompt, n_new), g, w in zip(REQUESTS, got, want):
        numpy.testing.assert_array_equal(g, w)
        numpy.testing.assert_array_equal(g, greedy(prompt, n_new))
    assert engine.verify_pool_invariants()["pinned_pages"] == 0
    assert engine.metrics.errors == 0


def test_books_equal_reference(host, greedy, reference):
    """Requests awaited one at a time: after each, the counters, the
    request's page table, the trie's page ids and the pool's refs, pins
    and free list equal the reference engine's."""
    name, want, _ = reference
    engine = _port(host, **FEATURE_SETS[name]).start()
    try:
        got = _serve_sequential(engine)
    finally:
        engine.stop()
    for i, ((prompt, n_new), g, w) in enumerate(zip(REQUESTS, got, want)):
        numpy.testing.assert_array_equal(g[0], w[0])
        numpy.testing.assert_array_equal(g[0], greedy(prompt, n_new))
        assert g[1] == w[1], "request %d's page table" % i
        assert g[2] == w[2], "books after request %d" % i
    c = got[-1][2]["counters"]
    assert c["megastep_dispatches"] == c["decode_dispatches"] > 0
    if name == "plain_k4":
        assert c["megastep_tokens"] + c["megastep_wasted_iterations"] \
            == c["megastep_lane_iterations"]
    if "spec_k" in FEATURE_SETS[name]:
        assert c["draft_accepted"] > 0
    if "prefix_cache" in FEATURE_SETS[name]:
        assert c["prefix_hit_tokens"] > 0


# ------------------------------------------- the reference's own cases
def test_validation_and_noop(host):
    """K < 0 and an unknown mode raise; K of 0 or 1 keeps the per-tick
    path and builds no fused program; K >= 2 builds one a ladder
    width."""
    with pytest.raises(ValueError, match="megastep"):
        _port(host, slots=1, megastep=-1)
    with pytest.raises(ValueError, match="megastep_mode"):
        _port(host, slots=1, megastep=4, megastep_mode="loop")
    for k in (0, 1):
        engine = _port(host, slots=1, megastep=k).start()
        engine.stop()
        assert engine._megastep_programs is None
    engine = _port(host, slots=1, megastep=2, megastep_mode="scan").start()
    engine.stop()
    assert sorted(engine._megastep_programs) == [1, 2, 4, 8]


def test_deadline_mid_megastep_sheds_at_next_boundary(host, greedy):
    """A queued request whose deadline passes while a (slowed) megastep
    runs is shed at the next boundary, naming the sweep; the request
    already decoding keeps its tokens."""
    engine = _port(host, slots=1, megastep=4, deadline_s=0.35).start()
    real = engine._megastep_program

    def slow(w):
        time.sleep(0.25)
        return real(w)
    engine._megastep_program = slow
    try:
        fa = engine.submit([1, 2, 3], 8)
        time.sleep(0.05)
        fb = engine.submit([4, 5, 6], 4)
        numpy.testing.assert_array_equal(fa.result(timeout=60),
                                         greedy([1, 2, 3], 8))
        with pytest.raises(DeadlineExceeded, match="boundary"):
            fb.result(timeout=60)
        assert engine.metrics.snapshot()["shed"] == 1
    finally:
        engine.stop()


def test_fault_inside_megastep_fails_exactly_active_lanes(host, greedy):
    """A fused dispatch that raises fails the lanes that were in it and
    no other; the queued request then decodes greedy."""
    engine = _port(host, slots=1, megastep=4).start()
    real = engine._megastep_program
    calls = []

    class Injected(RuntimeError):
        pass

    def faulty(w):
        calls.append(w)
        if len(calls) == 1:
            raise Injected("planted fault in the fused dispatch")
        return real(w)
    engine._megastep_program = faulty
    try:
        fa = engine.submit([1, 2, 3], 6)
        fb = engine.submit([2, 4, 6, 8], 6)
        with pytest.raises(Injected):
            fa.result(timeout=60)
        numpy.testing.assert_array_equal(fb.result(timeout=120),
                                         greedy([2, 4, 6, 8], 6))
    finally:
        engine.stop()
    assert engine.metrics.errors == 1
    assert engine.verify_pool_invariants()["pinned_pages"] == 0


def test_counters_truthful(host, greedy):
    """The ``megastep_*`` counters: every token after the first (the
    prompt's tail chunk gives it) comes out of a megastep, the books
    close, one decode dispatch a megastep."""
    engine = _port(host, megastep=4).start()
    try:
        prompts = [[1, 2, 3], [2, 4, 6, 8]]
        futures = [engine.submit(p, 9) for p in prompts]
        for p, f in zip(prompts, futures):
            numpy.testing.assert_array_equal(f.result(timeout=120),
                                             greedy(p, 9))
    finally:
        engine.stop()
    c = engine.metrics.snapshot()["counters"]
    assert c["megastep_dispatches"] >= 1
    assert c["megastep_tokens"] == 2 * 8
    assert c["megastep_tokens"] + c["megastep_wasted_iterations"] \
        == c["megastep_lane_iterations"]
    assert c["decode_dispatches"] == c["megastep_dispatches"]


def test_boundary_shed_while_slots_busy(host, greedy):
    """Per-tick path, one slot busy with a long (slowed) decode: a
    queued request whose deadline passes is shed by the loop's boundary
    sweep while the first request still decodes — not when the slot
    frees."""
    engine = _port(host, slots=1, deadline_s=0.3).start()
    real = engine._step_program

    def slow(*args):
        time.sleep(0.05)
        return real(*args)
    engine._step_program = slow
    try:
        fa = engine.submit([1, 2, 3], GEN_NEW)
        time.sleep(0.05)
        fb = engine.submit([4, 5, 6], 4)
        with pytest.raises(DeadlineExceeded, match="boundary"):
            fb.result(timeout=60)
        assert not fa.done(), "the queued request waited for the slot"
        numpy.testing.assert_array_equal(fa.result(timeout=120),
                                         greedy([1, 2, 3], GEN_NEW))
    finally:
        engine.stop()
    assert engine.metrics.snapshot()["shed"] == 1


# ------------------------------------------------------------- helpers
def _histories(n, count, seed):
    """Seeded (hist, hlen) rows over a 4-token alphabet (so n-grams
    recur): every hlen from 0 to n, and garbage past it."""
    rng = numpy.random.RandomState(seed)
    hist = rng.randint(0, 4, (count, n)).astype(numpy.int32)
    hlen = numpy.concatenate([numpy.arange(n + 1),
                              rng.randint(0, n + 1, count - n - 1)])
    return hist, hlen.astype(numpy.int32)


@pytest.mark.parametrize("n,k,ngram", [(24, 3, 3), (64, 4, 3), (16, 5, 2),
                                       (10, 1, 1)])
def test_propose_draft_in_graph_equals_reference(n, k, ngram):
    """Draft AND found flag equal the reference's on every row: short
    histories (hlen <= max_ngram), full ones and garbage tails."""
    hist, hlen = _histories(n, 160, seed=n + k)
    want = jax.jit(jax.vmap(lambda h, l: JT.propose_draft_in_graph(
        h, l, k, ngram)))(jnp.asarray(hist), jnp.asarray(hlen))
    draft, found = propose_draft_in_graph(torch.from_numpy(hist),
                                          torch.from_numpy(hlen), k, ngram)
    numpy.testing.assert_array_equal(draft.numpy(), numpy.asarray(want[0]))
    numpy.testing.assert_array_equal(found.numpy(), numpy.asarray(want[1]))
    assert draft.dtype == torch.int32 and found.any() and not found.all()


@pytest.mark.parametrize("c", [1, 4])
def test_masked_paged_write_touches_only_scratch(c):
    """A masked lane's write lands on the scratch page: every other page
    is bit-equal to the reference's masked write and to the pool before
    it wherever an unmasked lane did not write."""
    rng = numpy.random.RandomState(c)
    n_pages, kv, dh, m, b = 9, 2, 4, 4, 4
    pool = rng.randn(n_pages, kv, PAGE, dh).astype(numpy.float32)
    # distinct pages a lane; the pos of a masked lane is garbage
    ptab = (1 + numpy.arange(b * 2).reshape(b, 2)).astype(numpy.int32)
    ptab = numpy.pad(ptab, ((0, 0), (0, m - 2)))
    pos = rng.randint(0, 2 * PAGE - c + 1, b).astype(numpy.int32)
    rows = rng.randn(b, kv, c, dh).astype(numpy.float32)
    mask = numpy.array([True, False, True, False])
    want = numpy.asarray(JA.paged_write(
        jnp.asarray(pool), jnp.asarray(ptab), jnp.asarray(pos),
        jnp.asarray(rows), jnp.asarray(mask)))
    got = A.paged_write(torch.from_numpy(pool.copy()),
                        torch.from_numpy(ptab), torch.from_numpy(pos),
                        torch.from_numpy(rows), torch.from_numpy(mask))
    numpy.testing.assert_array_equal(got.numpy()[1:], want[1:])
    masked_pages = ptab[~mask][:, :2].reshape(-1)
    numpy.testing.assert_array_equal(got.numpy()[masked_pages],
                                     pool[masked_pages])
    assert not numpy.array_equal(got.numpy()[0], pool[0])


def test_writes_stay_inside_the_sliced_table(host, greedy, monkeypatch):
    """A lane whose reservation ends at ``max_len`` (prompt + n_new +
    spec_k == 64) decodes speculatively through K = 8 megasteps beside
    a short lane that freezes early: every K/V write of every iteration
    indexes inside the table width the dispatch was given (on the card
    an index past it is a device assert)."""
    seen = []
    real = A.paged_write

    def recording(pool, ptab, pos, rows, write_mask=None):
        seen.append((int(pos.max()) + rows.shape[-2], ptab.shape[-1] * PAGE))
        return real(pool, ptab, pos, rows, write_mask)
    monkeypatch.setattr(A, "paged_write", recording)
    prompt, n_new = REQUESTS[1]
    assert len(prompt) + n_new + SPEC_K == MAX_LEN
    engine = _port(host, megastep=8, spec_k=SPEC_K).start()
    try:
        futures = [engine.submit(prompt, n_new),
                   engine.submit([7, 7, 7], 3)]
        results = [f.result(timeout=120) for f in futures]
    finally:
        engine.stop()
    numpy.testing.assert_array_equal(results[0], greedy(prompt, n_new))
    numpy.testing.assert_array_equal(results[1], greedy([7, 7, 7], 3))
    assert seen and all(end <= width for end, width in seen)
    # the long lane's last megasteps ran at the full table width
    assert any(width == MAX_LEN for _, width in seen)
