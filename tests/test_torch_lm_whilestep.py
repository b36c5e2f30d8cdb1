"""The port's early-exit fused decode (``megastep_mode="while"``) and its
standby refill ring against the reference.

The same weights (from one numpy prng stream) serve the same prompts
through ``veles_tpu_torch``'s ``LMEngine`` on the CPU (the while program
as a host loop that stops when nothing is left live), through
``veles_tpu``'s paged ``LMEngine`` with the same knobs (its
``lax.while_loop``) and through ``veles_tpu``'s ``generate``: the greedy
tokens must be EQUAL.  Every request is queued before the engines' loops
take their first turn (the engine's condition is held across ``start()``
and the submits), so the schedule is fixed by the loop and not by the
clock, and the two engines must keep the same books at every finish: the
counters (``megastep_*`` with realised iterations, ``megastep_refills``,
draft and dispatch counts), the ring gauges, the finishing request's
page table and the pool's refs, pins and free list.  The program itself
is held to the reference's on seeded random carries (the vectorised arm
against the reference's loop over slots), and the boundary cases
(validation, the early exit, the in-program re-arm, a ring occupant past
its deadline, a fault in a dispatch with a ring occupant) to the
reference's own tests of them — on a stepped clock and a dispatch count,
never on sleeps.
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
from veles_tpu_torch.ops import attention as A
from veles_tpu_torch.ops.transformer import init_transformer_params
from veles_tpu_torch.serving import DeadlineExceeded, LMEngine
from veles_tpu_torch.serving import lm_engine

VOCAB, D_MODEL, N_HEADS, N_LAYERS, PAGE = 32, 32, 4, 2, 8
#: the engines' lane span (widths 1, 2, 4, 8 pages); the weights'
#: learned positions reach PARAMS_LEN for ``generate``
MAX_LEN, PARAMS_LEN = 64, 128
GEN_WIDTH, GEN_NEW = 48, 60
SPEC_K = 3

_rng = numpy.random.RandomState(22)
SHARED = _rng.randint(0, VOCAB, 16).tolist()                # 2 full pages
#: 7 requests through 2 slots and a ring of 2: multi-chunk prompts (a
#: standby entry prefills over several turns), a periodic one (drafts
#: lock on) whose reservation ends at ``MAX_LEN`` under ``spec_k`` 3
#: (40 + 21 + 3), an n_new of 1 (a standby entry done at its prefill
#: tail) and short ones that drain inside a program
REQUESTS = [
    (SHARED + _rng.randint(0, VOCAB, 5).tolist(), 12),
    (SHARED + [3, 1, 4, 1, 5, 9, 2, 6] * 3, 21),
    ([5, 1] * 5, 20),
    ([1, 2, 3], 6),
    (_rng.randint(0, VOCAB, 13).tolist(), 9),
    ([9, 8, 7], 1),
    ([2, 4, 6, 8], 5),
]
FEATURE_SETS = {
    "while_k8": {"megastep": 8, "megastep_mode": "while"},
    "while_spec_k4": {"megastep": 4, "megastep_mode": "while",
                      "spec_k": SPEC_K},
    "ring2_spec_k4": {"megastep": 4, "megastep_mode": "while",
                      "refill_ring": 2, "spec_k": SPEC_K},
    "ring2_prefix_k8": {"megastep": 8, "megastep_mode": "while",
                        "refill_ring": 2, "prefix_cache": 32},
}
#: the counters and gauges the two engines share by name and meaning
COUNTERS = ("megastep_dispatches", "megastep_tokens",
            "megastep_lane_iterations", "megastep_wasted_iterations",
            "megastep_refills", "decode_dispatches", "prefill_dispatches",
            "prefill_tokens", "draft_tokens", "draft_accepted",
            "tokens_out", "prefix_hit_tokens", "kv_cow_copies")
GAUGES = ("standby_ring_occupancy", "standby_ring_peak")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def host():
    prng.reset()
    return init_transformer_params(prng.RandomGenerator("init", 22), VOCAB,
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
                       prefill_chunk=PAGE, name="ref_ws", **knobs)


def _queued_then_started(engine, requests):
    """Start ``engine`` with every request already queued: the engine's
    condition (re-entrant) is held across ``start()`` and the submits,
    so the loop's first turn sees them all.  Returns the futures."""
    with engine._cond:
        engine.start()
        return [engine.submit(p, n) for p, n in requests]


def _record_books(engine, log):
    """At every finish — a lane's (``_finish``) or a standby entry's
    (``_resolve_standby``) — append (the request's prompt, its page
    table, the counters, the ring gauges, the pool's books) to
    ``log``."""
    def snap(req, table):
        m = engine.metrics.snapshot()
        c, g = m["counters"], m["gauges"]
        log.append((tuple(int(t) for t in req.prompt), list(map(int, table)),
                    {k: c.get(k, 0) for k in COUNTERS},
                    {k: g.get(k, 0) for k in GAUGES},
                    engine._pool.snapshot()))

    finish, resolve = engine._finish, engine._resolve_standby

    def on_finish(slot):
        snap(engine._lanes[slot].request, engine._page_tables[slot])
        finish(slot)

    def on_resolve(entry):
        snap(entry.lane.request, entry.table)
        resolve(entry)
    engine._finish, engine._resolve_standby = on_finish, on_resolve


def _serve(engine, requests=REQUESTS):
    """Every request queued before the first turn; returns (tokens,
    books at every finish, the books after the last)."""
    log = []
    _record_books(engine, log)
    try:
        futures = _queued_then_started(engine, requests)
        outs = [f.result(timeout=120) for f in futures]
    finally:
        engine.stop()
    return outs, log, engine.verify_pool_invariants()


@pytest.fixture(scope="module", params=sorted(FEATURE_SETS))
def reference(request, host):
    """One reference engine per feature set and its run."""
    jprng.reset()
    engine = _reference(host, **FEATURE_SETS[request.param])
    return request.param, _serve(engine)


def test_tokens_equal_reference_and_generate(host, greedy, reference):
    """The port's tokens equal the reference while engine's and
    ``generate``'s."""
    name, (want, _, _) = reference
    engine = _port(host, **FEATURE_SETS[name])
    got, _, inv = _serve(engine)
    assert sorted(engine._megastep_programs) == engine._width_ladder
    for (prompt, n_new), g, w in zip(REQUESTS, got, want):
        numpy.testing.assert_array_equal(g, w)
        numpy.testing.assert_array_equal(g, greedy(prompt, n_new))
    # only the prefix cache's chunks keep pages past the last finish
    trie = engine._trie.size if engine._trie is not None else 0
    assert inv["used_pages"] == trie and inv["pinned_pages"] == 0
    assert engine.metrics.errors == 0


def test_books_equal_reference(host, reference):
    """At every finish, in the same order: the finishing request, its
    page table, the counters (realised iterations, refills), the ring
    gauges and the pool's refs, pins and free list equal the
    reference's."""
    name, (_, want, want_inv) = reference
    _, got, inv = _serve(_port(host, **FEATURE_SETS[name]))
    assert len(got) == len(want) == len(REQUESTS)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[0] == w[0], "finish %d: another request" % i
        assert g[1] == w[1], "finish %d: the page table" % i
        assert g[2] == w[2], "finish %d: the counters" % i
        assert g[3] == w[3], "finish %d: the ring gauges" % i
        assert g[4] == w[4], "finish %d: the pool" % i
    assert inv == want_inv
    c = got[-1][2]
    assert c["megastep_dispatches"] == c["decode_dispatches"] > 0
    if not FEATURE_SETS[name].get("spec_k"):
        # one token or one wasted lane-iteration a realised iteration
        assert c["megastep_tokens"] + c["megastep_wasted_iterations"] \
            == c["megastep_lane_iterations"]
    if FEATURE_SETS[name].get("refill_ring"):
        assert c["megastep_refills"] > 0
        assert got[-1][3]["standby_ring_peak"] >= 1
        assert got[-1][3]["standby_ring_occupancy"] == 0
    if FEATURE_SETS[name].get("spec_k"):
        assert c["draft_accepted"] > 0


# --------------------------------------------- the program on its own
def _random_inputs(rng, S, R, M, k, n_pages):
    """Seeded random carries: lanes live (left > 0), drained (0) or idle
    (-1), each on pages of its own; R ring entries of which ``count``
    are published, each on pages of its own; a ``head`` of 0."""
    # 4 pages a row cover a frontier below one page plus the longest
    # dispatch's writes (K (k + 1) + k <= 19 positions)
    pages = rng.permutation(numpy.arange(1, n_pages + 1)).astype(numpy.int32)
    tabs = numpy.zeros((S + R, M), numpy.int32)
    for row in range(S + R):
        tabs[row, :4] = pages[4 * row:4 * row + 4]
    inp = {"ptab": tabs[:S], "last": rng.randint(0, VOCAB, S),
           "pos": rng.randint(0, PAGE, S),
           "left": rng.choice([-1, 0, 0, 1, 2, 3, 5], S),
           "ring_tab": tabs[S:], "ring_last": rng.randint(0, VOCAB, R),
           "ring_pos": rng.randint(1, PAGE, R),
           "ring_left": rng.randint(1, 6, R),
           "count": numpy.asarray([rng.randint(0, R + 1)])}
    if k:
        inp["hist"] = rng.randint(0, 4, (S, MAX_LEN))
        inp["hlen"] = inp["pos"] + 1
        inp["ring_hist"] = rng.randint(0, 4, (R, MAX_LEN))
        inp["ring_hlen"] = inp["ring_pos"] + 1
    return {n: numpy.asarray(v, numpy.int32) for n, v in inp.items()}


@pytest.mark.parametrize("spec", [0, SPEC_K])
def test_program_equals_reference_on_random_carries(host, spec):
    """The port's while program (the vectorised arm) and the reference's
    ``lax.while_loop`` (its loop over slots) on the same seeded random
    carries and ring: the realised iterations, ``assign``, the emitted
    tokens (and accepted counts) and the final carry are equal."""
    S, R, K = 4, 3, 4
    knobs = {"megastep": K, "megastep_mode": "while", "refill_ring": R,
             "spec_k": spec}
    port = _port(host, slots=S, **knobs)
    ref = _reference(host, slots=S, **knobs)
    M = port._max_pages
    c = spec + 1
    seen = set()
    for seed in range(12):
        inp = _random_inputs(numpy.random.RandomState(seed), S, R, M, spec,
                             port._pool.num_pages)
        for name, arr in inp.items():
            port._ms_host[name][...] = arr
        # a fresh pool a case, equal on both sides
        for kp, vp in port._kv_pools:
            kp.zero_()
            vp.zero_()
        res = port._while_body(M).numpy().copy()
        args = [ref.params, jax.tree.map(jnp.zeros_like, ref._kv_pools)]
        args += [jnp.asarray(inp[n]) for n in ("ptab", "last", "pos",
                                               "left")]
        if spec:
            args += [jnp.asarray(inp["hist"]), jnp.asarray(inp["hlen"])]
        args += [jnp.asarray(inp[n]) for n in ("ring_tab", "ring_last",
                                               "ring_pos", "ring_left")]
        if spec:
            args += [jnp.asarray(inp["ring_hist"]),
                     jnp.asarray(inp["ring_hlen"])]
        args.append(jnp.asarray(inp["count"][0]))
        out = [numpy.asarray(o) for o in ref._whilestep_jit(*args)[1:]]
        last, pos, emitted, iters = out[:4]
        assign = out[-1]
        at = 2 * S + K * S * c + (K * S if spec else 0)
        assert int(res[at]) == int(iters), "seed %d: iters" % seed
        numpy.testing.assert_array_equal(res[at + 1:], assign)
        numpy.testing.assert_array_equal(res[:S], last)
        numpy.testing.assert_array_equal(res[S:2 * S], pos)
        numpy.testing.assert_array_equal(
            res[2 * S:2 * S + K * S * c].reshape(emitted.shape), emitted)
        if spec:
            numpy.testing.assert_array_equal(
                res[2 * S + K * S * c:at], out[4].reshape(-1))
        seen.add((int(iters), int((assign >= 0).sum())))
    # the seeds cover early exits, full runs and arms of 0 to several
    assert len({i for i, _ in seen}) >= 3
    assert len({n for _, n in seen}) >= 3


# ------------------------------------------- the reference's own cases
def test_validation_and_alias(host):
    """An unknown mode, the while mode without a cap, and a ring without
    the while mode raise; ``megastep="while"`` is K = 16 in mode
    ``"while"``; a ring's size is kept."""
    with pytest.raises(ValueError, match="megastep_mode"):
        _port(host, slots=1, megastep=4, megastep_mode="unroll")
    with pytest.raises(ValueError, match="iteration cap"):
        _port(host, slots=1, megastep_mode="while")
    with pytest.raises(ValueError, match="refill_ring"):
        _port(host, slots=1, megastep=4, refill_ring=2)
    with pytest.raises(ValueError, match="refill_ring"):
        _port(host, slots=1, megastep=4, megastep_mode="while",
              refill_ring=-1)
    alias = _port(host, slots=1, megastep="while")
    assert (alias.megastep, alias.megastep_mode, alias.refill_ring) \
        == (16, "while", 0)
    ring = _port(host, slots=1, megastep=4, megastep_mode="while",
                 refill_ring=3)
    assert (ring.megastep_mode, ring.refill_ring) == ("while", 3)
    assert "megastep_mode" not in lm_engine._ROADMAP
    assert "refill_ring" not in lm_engine._ROADMAP


def test_early_exit_kills_waste_tail(host, greedy):
    """A lone lane with n_new 6 at K = 16: one dispatch of 5 realised
    iterations and no wasted lane-iteration, where the scan twin at the
    same K runs 16 and wastes 11."""
    prompt, n_new = [1, 2, 3], 6
    books = {}
    for mode in ("while", "scan"):
        engine = _port(host, slots=1, megastep=16, megastep_mode=mode)
        got = _queued_then_started(engine, [(prompt, n_new)])[0].result(
            timeout=120)
        engine.stop()
        numpy.testing.assert_array_equal(got, greedy(prompt, n_new))
        books[mode] = engine.metrics.snapshot()["counters"]
    c = books["while"]
    assert c["megastep_dispatches"] == 1
    assert c["megastep_tokens"] == n_new - 1
    assert c["megastep_lane_iterations"] == n_new - 1
    assert c["megastep_wasted_iterations"] == 0
    assert books["scan"]["megastep_lane_iterations"] == 16
    assert books["scan"]["megastep_wasted_iterations"] == 16 - (n_new - 1)


def test_refill_ring_rearm_in_graph(host, greedy):
    """5 prompts through ONE slot with a ring of 2: every output greedy,
    at least one entry armed inside a program, the occupancy back to 0
    and the pool whole."""
    prompts = [[1, 2, 3], [2, 4, 6, 8], [7, 7], [3, 1, 4, 1, 5], [9, 8, 7]]
    engine = _port(host, slots=1, megastep=8, megastep_mode="while",
                   refill_ring=2)
    futures = _queued_then_started(engine, [(p, 6) for p in prompts])
    try:
        for p, f in zip(prompts, futures):
            numpy.testing.assert_array_equal(f.result(timeout=120),
                                             greedy(p, 6))
    finally:
        engine.stop()
    m = engine.metrics.snapshot()
    assert m["counters"]["megastep_refills"] >= 1
    assert m["gauges"]["standby_ring_occupancy"] == 0
    assert m["gauges"]["standby_ring_peak"] >= 1
    assert engine.verify_pool_invariants()["used_pages"] == 0


class _SteppedClock:
    """The engine module's clock, advanced only by the test."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    def perf_counter(self):
        return self.now


def test_ring_occupant_never_shed(host, greedy, monkeypatch):
    """A request waiting in the standby ring past its deadline is
    admitted work and completes; one still queued is shed at the next
    boundary, the window quoted from the cap.  Each dispatch steps the
    engine's clock by 0.25 s (deadline 0.35 s): no sleep."""
    clock = _SteppedClock()
    monkeypatch.setattr(lm_engine, "time", clock)
    engine = _port(host, slots=1, megastep=4, megastep_mode="while",
                   refill_ring=1, deadline_s=0.35)
    real = engine._megastep_program

    def slow(w):
        clock.now += 0.25
        return real(w)
    engine._megastep_program = slow
    fa, fb, fc = _queued_then_started(
        engine, [([1, 2, 3], 12), ([4, 5, 6], 4), ([6, 5, 4], 4)])
    try:
        numpy.testing.assert_array_equal(fa.result(timeout=60),
                                         greedy([1, 2, 3], 12))
        # fb sat in the ring well past its deadline — it finishes
        numpy.testing.assert_array_equal(fb.result(timeout=60),
                                         greedy([4, 5, 6], 4))
        with pytest.raises(DeadlineExceeded, match="window <= 4"):
            fc.result(timeout=60)
    finally:
        engine.stop()
    assert engine.metrics.snapshot()["shed"] == 1
    assert engine.verify_pool_invariants()["used_pages"] == 0


def test_fault_fails_participants_including_ring(host, greedy):
    """A dispatch that raises while a ready ring entry is published fails
    exactly the participants — the decoding lane AND the ring occupant —
    with the planted exception and sends their pages home; the next
    request decodes greedy.  The fault fires at the first dispatch whose
    staged ``count`` is at least 1, so who takes part is fixed by the
    books, not by timing."""

    class Planted(RuntimeError):
        pass

    engine = _port(host, slots=1, megastep=4, megastep_mode="while",
                   refill_ring=1)
    real = engine._megastep_program
    fired = []

    def faulty(w):
        if not fired and engine._ms_host["count"][0] >= 1:
            fired.append([e.lane.request for e in engine._ring])
            raise Planted("planted fault in the while dispatch")
        return real(w)
    engine._megastep_program = faulty
    fa, fb = _queued_then_started(engine, [([1, 2, 3], 40),
                                           ([2, 4, 6, 8], 6)])
    try:
        with pytest.raises(Planted):
            fa.result(timeout=60)
        with pytest.raises(Planted):
            fb.result(timeout=60)
        assert [r.future for r in fired[0]] == [fb]
        assert engine.verify_pool_invariants()["used_pages"] == 0
        fc = engine.submit([9, 9, 9], 5)
        numpy.testing.assert_array_equal(fc.result(timeout=120),
                                         greedy([9, 9, 9], 5))
    finally:
        engine.stop()
    assert engine.metrics.errors == 1
    assert not engine._ring
    assert engine.verify_pool_invariants()["used_pages"] == 0


def test_armed_writes_stay_inside_the_sliced_table(host, greedy,
                                                   monkeypatch):
    """One slot, a long lane, then ring entries armed into it as it
    drains — the second at frontier 40, deeper than the slot's own: every
    K/V write of every iteration (an armed entry's included) indexes
    inside the table width the dispatch was given (on the card an index
    past it is a device assert)."""
    seen = []
    real = A.paged_write

    def recording(pool, ptab, pos, rows, write_mask=None):
        live = pos if write_mask is None else pos[write_mask]
        if live.numel():
            seen.append((int(live.max()) + rows.shape[-2],
                         ptab.shape[-1] * PAGE))
        return real(pool, ptab, pos, rows, write_mask)
    monkeypatch.setattr(A, "paged_write", recording)
    reqs = [([7, 7, 7], 60), (REQUESTS[4][0], 9), (REQUESTS[1][0], 20)]
    engine = _port(host, slots=1, megastep=8, megastep_mode="while",
                   refill_ring=2, paged_kv=24)
    futures = _queued_then_started(engine, reqs)
    try:
        for (p, n), f in zip(reqs, futures):
            numpy.testing.assert_array_equal(f.result(timeout=120),
                                             greedy(p, n))
    finally:
        engine.stop()
    assert engine.metrics.snapshot()["counters"]["megastep_refills"] == 2
    assert seen and all(end <= width for end, width in seen)
