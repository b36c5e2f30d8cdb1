"""The port's serving fast path against the reference: the radix prefix
cache with copy-on-write pages, and prompt-lookup speculative verify.

The same weights (from one numpy prng stream) serve the same prompts
through ``veles_tpu_torch``'s ``LMEngine`` on the CPU, through
``veles_tpu``'s paged ``LMEngine`` with the same knobs and through
``veles_tpu``'s ``generate``: the greedy tokens must be EQUAL.  With
requests awaited one at a time the two engines must also keep the same
books — counters, each request's page table, the trie's page ids, the
pool's refs, pins and free list — after every request.
"""

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

from veles_tpu import prng as jprng
from veles_tpu.ops import transformer as JT
from veles_tpu.serving import PoolExhausted as JaxPoolExhausted
from veles_tpu.serving import propose_draft as jax_propose_draft
from veles_tpu.serving.lm_engine import LMEngine as JaxLMEngine
from veles_tpu_torch import prng
from veles_tpu_torch.ops.transformer import init_transformer_params
from veles_tpu_torch.serving import (KVPagePool, LMEngine, PoolExhausted,
                                     RadixPrefixCache, propose_draft)
from veles_tpu_torch.serving.lm_engine import _Request, _Slot
from torch_witness import port_witness  # noqa: F401

VOCAB, D_MODEL, N_HEADS, N_LAYERS, MAX_LEN, PAGE = 32, 32, 4, 2, 128, 8
#: every prompt of this file fits one padded ``generate`` shape
GEN_WIDTH, GEN_NEW = 64, 24

_rng = numpy.random.RandomState(5)
SHARED = _rng.randint(0, VOCAB, 16).tolist()                # 2 full pages
#: (prompt, n_new): shared-prefix prompts whose tails end at every
#: offset of a page, an exact repeat (its third chunk hits too), a
#: repetitive prompt the drafts lock onto, a short one, and a long one
#: whose reservation (10 pages) presses a 12-page pool into evicting
_FIRST = SHARED + _rng.randint(0, VOCAB, 5).tolist()
_SECOND = SHARED + _rng.randint(0, VOCAB, 11).tolist()
REQUESTS = [
    (_FIRST, 6),
    (_SECOND, 8),
    ([3, 1, 4, 1, 5, 9, 2, 6] * 3, 12),
    (SHARED + _rng.randint(0, VOCAB, 17).tolist(), 7),
    (_rng.randint(0, VOCAB, 3).tolist(), 5),
    (list(_SECOND), 10),
    (_rng.randint(0, VOCAB, 60).tolist(), 16),
    (SHARED + [7, 7, 7, 7] * 4, 20),
]

#: the feature sets held to the reference; ``paged_kv=12`` is a pool
#: smaller than the demand of three lanes
FEATURE_SETS = {
    "prefix": {"prefix_cache": 32},
    "spec": {"spec_k": 3},
    "prefix_spec": {"prefix_cache": 32, "spec_k": 3},
    "prefix_pool12": {"prefix_cache": 32, "paged_kv": 12},
}
#: the counters the two engines share by name and meaning
COUNTERS = ("prefix_hit_chunks", "prefix_hit_tokens", "kv_pages_referenced",
            "kv_cow_copies", "draft_tokens", "draft_accepted",
            "decode_dispatches", "prefill_dispatches", "prefill_tokens",
            "tokens_out")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def host():
    prng.reset()
    return init_transformer_params(prng.RandomGenerator("init", 7), VOCAB,
                                   d_model=D_MODEL, n_heads=N_HEADS,
                                   n_layers=N_LAYERS, max_len=MAX_LEN)


@pytest.fixture(scope="module")
def greedy(host):
    """``greedy(prompt, n_new)``: the reference ``generate``'s tokens —
    one compile: every prompt right-padded to one width with
    ``true_len``, GEN_NEW tokens for all (greedy tokens never depend on
    later steps)."""
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


def _port(host, slots=3, **knobs):
    return LMEngine(host, N_HEADS, MAX_LEN, slots=slots, prefill_chunk=PAGE,
                    device="cpu", **knobs)


def _trie_pages(engine):
    """{token path (root to node): page id} of every trie entry."""
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
        books["cache_gauge"] = engine.metrics.snapshot()["gauges"].get(
            "prefix_cache_chunks", 0)
        books["live_pins"] = engine._trie.live_pins()
    return books


def _record_tables(engine):
    """Keep each finishing lane's page-table row (its pages, hits
    included) before the slot is vacated."""
    tables = []
    finish = engine._finish

    def recording(slot):
        tables.append(engine._page_tables[slot].tolist())
        finish(slot)
    engine._finish = recording
    return tables


def _serve_sequential(engine):
    tables = _record_tables(engine)
    out = []
    for prompt, n_new in REQUESTS:
        toks = engine.submit(prompt, n_new).result(timeout=120)
        out.append((toks, tables[-1], _books(engine)))
    return out


def _serve_concurrent(engine):
    """Every request submitted at once; one refused for the queued page
    demand (a 12-page pool) is retried after the oldest unfinished
    request is answered."""
    futures = []
    for prompt, n_new in REQUESTS:
        while True:
            try:
                futures.append(engine.submit(prompt, n_new))
                break
            except (PoolExhausted, JaxPoolExhausted):
                for f in futures:
                    if not f.done():
                        f.result(timeout=120)
                        break
    return [f.result(timeout=120) for f in futures]


@pytest.fixture(scope="module", params=sorted(FEATURE_SETS))
def reference(request, host):
    """One reference engine per feature set: its sequential run (tokens,
    table and books after every request), then the same requests all
    at once."""
    jprng.reset()
    knobs = dict({"paged_kv": True}, **FEATURE_SETS[request.param])
    engine = JaxLMEngine(host, N_HEADS, MAX_LEN, slots=3,
                         prefill_chunk=PAGE, name="ref_fp", **knobs).start()
    try:
        sequential = _serve_sequential(engine)
        concurrent = _serve_concurrent(engine)
    finally:
        engine.stop()
    return request.param, sequential, concurrent


def test_tokens_equal_reference(host, greedy, reference):
    """All requests at once through three lanes: the port's tokens equal
    the reference engine's and generate's, for every feature set."""
    name, _, want = reference
    engine = _port(host, **FEATURE_SETS[name]).start()
    try:
        got = _serve_concurrent(engine)
    finally:
        engine.stop()
    for (prompt, n_new), g, w in zip(REQUESTS, got, want):
        numpy.testing.assert_array_equal(g, w)
        numpy.testing.assert_array_equal(g, greedy(prompt, n_new))
    inv = engine.verify_pool_invariants()
    assert inv["pinned_pages"] == 0
    assert engine.metrics.errors == 0


def test_books_equal_reference(host, greedy, reference):
    """Requests awaited one at a time: after each, the port's counters,
    the request's page table, the trie's page ids and the pool's refs,
    pins and free list equal the reference engine's."""
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
    counters = got[-1][2]["counters"]
    if "prefix_cache" in FEATURE_SETS[name]:
        assert counters["prefix_hit_chunks"] > 0
    if "spec_k" in FEATURE_SETS[name]:
        # the workload exercises acceptance, not only misses
        assert counters["draft_accepted"] > 0
        assert counters["decode_dispatches"] < counters["tokens_out"]
    if FEATURE_SETS[name].get("paged_kv") == 12:
        # the long request's reservation pressed the trie into evicting
        assert len(got[-1][2]["trie"]) < len(
            {k for g_ in got for k in g_[2]["trie"]})


def test_late_hit_equal_reference(host, greedy):
    """Two shared-prefix requests admitted in the same tick (queued while
    the worker is held off the queue's lock, so their order is fixed):
    neither hits at admission, and the second lane picks up the first's
    chunks as LATE HITS — counters and trie equal the reference's."""
    a = SHARED + [1, 2, 3]
    b = SHARED + [4, 5, 6, 7, 8, 9, 10, 11, 12]
    books = []
    for make in (lambda: JaxLMEngine(host, N_HEADS, MAX_LEN, slots=3,
                                     paged_kv=True, prefill_chunk=PAGE,
                                     prefix_cache=8, name="ref_late"),
                 lambda: _port(host, prefix_cache=8)):
        jprng.reset()
        engine = make().start()
        try:
            with engine._cond:
                futures = [engine.submit(p, 4) for p in (a, b)]
            got = [f.result(timeout=120) for f in futures]
        finally:
            engine.stop()
        for p, g in zip((a, b), got):
            numpy.testing.assert_array_equal(g, greedy(p, 4))
        books.append(_books(engine))
    assert books[1] == books[0]
    c = books[1]["counters"]
    assert c["prefix_hit_chunks"] == 2 and c["kv_pages_referenced"] == 2
    assert c["prefill_tokens"] == len(a) + len(b) - 2 * PAGE


@pytest.mark.parametrize("diverge", [11, 15])
def test_cache_poisoning_diverge_mid_chunk(host, greedy, diverge):
    """Two prompts share a prefix but diverge inside the SECOND chunk
    (mid-chunk, or at its last token): the second reuses only the
    identical first chunk, and both stay greedy."""
    a = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 1, 2]
    b = list(a)
    b[diverge] = 3
    engine = _port(host, slots=1, prefix_cache=32).start()
    try:
        for p in (a, b):
            numpy.testing.assert_array_equal(
                engine.submit(p, 6).result(timeout=60), greedy(p, 6))
    finally:
        engine.stop()
    c = engine.metrics.snapshot()["counters"]
    assert c["prefix_hit_chunks"] == 1
    assert c["prefix_hit_tokens"] == PAGE


def test_slot_reuse_after_eviction(host, greedy):
    """A capacity-2 cache thrashed by distinct prompts: entries evict
    (LRU), slots recycle, and every output — a re-submission of the
    first prompt after its entry was evicted included — stays greedy."""
    rng = numpy.random.RandomState(4)
    prompts = [rng.randint(0, VOCAB, 20).tolist() for _ in range(4)]
    prompts.append(list(prompts[0]))
    engine = _port(host, slots=1, prefix_cache=2).start()
    try:
        for p in prompts:
            numpy.testing.assert_array_equal(
                engine.submit(p, 5).result(timeout=60), greedy(p, 5))
            assert engine._trie.size <= 2      # capacity held
    finally:
        engine.stop()
    engine.verify_pool_invariants()
    # the resubmitted prompt's entries were gone: it hit nothing
    assert engine.metrics.counter("prefix_hit_chunks") == 0


def test_shared_system_prompt_hit_rate(host, greedy):
    """8 requests sharing a 40-token system prompt: the cache serves at
    least 7/8 of the shared rows and every reply stays greedy."""
    rng = numpy.random.RandomState(0)
    shared = rng.randint(0, VOCAB, 40).tolist()        # 5 full chunks
    prompts = [shared + rng.randint(0, VOCAB, 5).tolist() for _ in range(8)]
    engine = _port(host, slots=2, prefix_cache=64).start()
    try:
        for p in prompts:
            numpy.testing.assert_array_equal(
                engine.submit(p, 4).result(timeout=60), greedy(p, 4))
    finally:
        engine.stop()
    c = engine.metrics.snapshot()["counters"]
    assert c["prefix_hit_tokens"] >= 7 * 40, c
    assert c["prefill_tokens"] == sum(map(len, prompts)) \
        - c["prefix_hit_tokens"]


def test_on_evict_returns_pages_pinned_entries_refuse():
    """Evicting an unpinned entry returns its page to the pool; entries a
    lane still pins are refused."""
    pool = KVPagePool(4, 4)
    trie = RadixPrefixCache(capacity=8, chunk=4, on_evict=pool.release)
    (pa,) = pool.alloc(1)
    (pb,) = pool.alloc(1)
    na = trie.insert(trie.root, (1,) * 4, pa)    # pinned by insert
    nb = trie.insert(na, (2,) * 4, pb)
    trie.release([nb])                           # b evictable
    assert pool.free_pages == 2
    assert trie.evict_one() is True              # drops b -> pool
    assert pool.free_pages == 3
    assert trie.evict_one() is False             # a still pinned
    assert pool.free_pages == 3
    trie.release([na])
    assert trie.evict_one() is True
    assert pool.free_pages == 4
    with pytest.raises(ValueError):
        RadixPrefixCache(0, 4)


def test_refcount_release_on_lane_finish(host):
    """While the trie holds two shared chunks their pages stay allocated
    (the trie's references), every lane-owned page returns at finish,
    and emptying the trie drains the pool back to full."""
    rng = numpy.random.RandomState(7)
    shared = rng.randint(0, VOCAB, 16).tolist()
    engine = _port(host, slots=2, prefix_cache=16).start()
    try:
        for _ in range(2):
            engine.submit(shared + rng.randint(0, VOCAB, 3).tolist(),
                          4).result(timeout=60)
    finally:
        engine.stop()
    pool, trie = engine._pool, engine._trie
    assert pool.used_pages == trie.size == 2
    assert pool.pinned_pages == 0 and trie.live_pins() == 0
    engine.verify_pool_invariants()
    while trie.evict_one():
        pass
    assert pool.free_pages == pool.num_pages


def test_hopeless_reservation_keeps_cache_warm(host):
    """A reservation that even a full trie flush could not cover evicts
    nothing; a reachable one evicts just enough."""
    engine = _port(host, slots=1, paged_kv=4, prefix_cache=8)
    pool, trie = engine._pool, engine._trie
    (pa,) = pool.alloc(1)
    trie.release([trie.insert(trie.root, (1,) * PAGE, pa)])
    assert trie.evictable() == 1
    assert engine._alloc_pages(5) is None        # 3 free + 1 < 5
    assert trie.size == 1
    got = engine._alloc_pages(4)                 # 3 free + 1 >= 4
    assert got is not None and len(got) == 4
    assert trie.size == 0


def test_cow_leaves_shared_page_bit_identical(host):
    """A lane about to write into a page another referent shares gets a
    private copy: the original stays bit-identical, the copy starts
    bit-identical, and the lane (not the sibling) moves to the copy."""
    engine = _port(host, slots=1, paged_kv=4)
    pool = engine._pool
    (p,) = pool.alloc(1)
    for i, (kp, vp) in enumerate(engine._kv_pools):
        kp[p] = float(i + 1)
        vp[p] = float(-i - 1)
    before = [(kp[p].clone(), vp[p].clone()) for kp, vp in engine._kv_pools]
    pool.retain(p)                   # the sibling's reference
    pool.pin(p)                      # this lane's pin
    lane = _Slot(_Request(numpy.asarray([1, 2, 3], numpy.int32), 4, 30.0,
                          pages=1))
    lane.pages = [p]
    engine._page_tables[0, 0] = p
    engine._cow_guard(0, lane, 0, 1)
    q = lane.pages[0]
    assert q != p and engine._page_tables[0, 0] == q
    for (kb, vb), (kp, vp) in zip(before, engine._kv_pools):
        for t in (kp[p], kp[q]):
            assert torch.equal(t, kb)
        for t in (vp[p], vp[q]):
            assert torch.equal(t, vb)
    assert pool.refs(p) == 1 and not pool.pinned(p)   # the sibling's
    assert pool.refs(q) == 1 and pool.pinned(q)       # the lane's
    assert engine.metrics.counter("kv_cow_copies") == 1
    # a second write into the now-exclusive page copies nothing
    engine._cow_guard(0, lane, 1, 2)
    assert engine.metrics.counter("kv_cow_copies") == 1


def test_cow_copy_fault_returns_the_page(host):
    """A page copy that raises hands the fresh page back to the pool and
    leaves the lane on its shared page."""
    engine = _port(host, slots=1, paged_kv=4)
    pool = engine._pool
    (p,) = pool.alloc(1)
    pool.retain(p)
    pool.pin(p)
    lane = _Slot(_Request(numpy.asarray([1], numpy.int32), 4, 30.0, pages=1))
    lane.pages = [p]

    def broken(src, dst):
        raise RuntimeError("copy failed")
    engine._page_copy_program = broken
    with pytest.raises(RuntimeError, match="copy failed"):
        engine._cow_guard(0, lane, 0, 1)
    assert lane.pages == [p] and pool.free_pages == 3
    assert engine.metrics.counter("kv_cow_copies") == 0


@pytest.mark.parametrize("k,ngram", [(1, 1), (3, 3), (5, 2), (4, 4)])
def test_propose_draft_equals_reference(k, ngram):
    rng = numpy.random.RandomState(k * 10 + ngram)
    for n in range(0, 40):
        history = rng.randint(0, 4, n).astype(numpy.int32)
        got = propose_draft(history, k, ngram)
        want = jax_propose_draft(history, k, ngram)
        if want is None:
            assert got is None
        else:
            assert got.dtype == numpy.int32
            numpy.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("knobs,match", [
    ({"spec_k": MAX_LEN - 1}, "spec_k .* out of range"),
    ({"spec_k": -1}, "spec_k .* out of range"),
    ({"spec_k": PAGE}, "must not exceed prefill_chunk"),
    ({"spec_k": 2, "spec_ngram": 0}, "spec_ngram"),
])
def test_spec_k_value_errors(host, knobs, match):
    with pytest.raises(ValueError, match=match):
        _port(host, **knobs)


def test_speculative_headroom_in_submit(host):
    """``spec_k`` positions past the committed front count against the
    lane span and the page reservation, as in the reference."""
    engine = _port(host, spec_k=3, paged_kv=4)
    with pytest.raises(ValueError, match="speculative headroom"):
        engine.submit(numpy.zeros(MAX_LEN - 10, numpy.int32), 8)
    # 28 + 2 fits 4 pages, + spec_k does not
    with pytest.raises(ValueError, match="needs 5 KV pages"):
        engine.submit(numpy.zeros(28, numpy.int32), 2)
