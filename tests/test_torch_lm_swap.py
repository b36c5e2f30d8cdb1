"""The port's hot weight swap against the reference.

Two seeded weight trees (A and B, from one numpy prng stream each) serve
the same requests through the port's ``LMEngine`` on the CPU and the
reference's paged ``LMEngine``.  Each engine is frozen at the same loop
turn by a fault plan (``engine.tick``, kind ``freeze``) with every
request queued before its first turn, ``swap_weights(B)`` is called from
a second thread, and the plan is released: so the swap lands at the same
point of the same schedule on both sides.  Finish-on-old (per tick, the
scan, the while megastep with its standby ring) and ``drain=True`` (per
tick, the while megastep with the ring and ``spec_k``, and sampled)
give every request the reference's stamp and tokens, each greedy result
equal to ``generate`` on the weights of its stamped version.

The apply copies into the live tensors IN PLACE: the tensors a captured
graph holds by address (recorded before the swap) hold B's values after
it.  A planted swap that reassigns ``params`` instead leaves them on A,
and the check catches it (on the card it serves A's tokens from the
graphs: ``tests/test_torch_cuda.py``).  The apply FLUSHES the prefix
cache; the reference keeps it and serves a stale answer, pinned here
(ROADMAP Queue 3 item 22), and a planted swap that keeps the trie is
caught.  Refusals (a structural mismatch, an ``engine.swap`` fault, a
timeout, a stopping engine) leave the old weights serving.
"""

import threading
import time

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

from veles_tpu import prng as jprng
from veles_tpu.ops import transformer as JT
from veles_tpu.serving import FaultPlan as JaxFaultPlan
from veles_tpu.serving.lm_engine import LMEngine as JaxLMEngine
from veles_tpu_torch import prng
from veles_tpu_torch.ops import transformer as TT
from veles_tpu_torch.serving import FaultPlan, InjectedFault, LMEngine

VOCAB, D_MODEL, N_HEADS, N_LAYERS, PAGE = 32, 32, 4, 2, 8
MAX_LEN, PARAMS_LEN = 64, 128
GEN_WIDTH, GEN_NEW = 48, 24
SAMPLE_KW = dict(temperature=0.8, top_k=5, sample_seed=123)
NEW_VERSION = 7

_rng = numpy.random.RandomState(11)
REQUESTS = [
    (_rng.randint(0, VOCAB, 19).tolist(), 9),
    ([1, 2, 3], 12),
    ([5, 1] * 5, 8),
    (_rng.randint(0, VOCAB, 11).tolist(), 6),
    ([9, 8, 7], 7),
]
WHILE_RING = {"megastep": 4, "megastep_mode": "while", "refill_ring": 1}
#: (engine knobs, drain): the swap lands at the third loop turn
CASES = {
    "tick": ({}, False),
    "scan": ({"megastep": 4}, False),
    "while_ring": (dict(WHILE_RING, slots=1), False),
    "tick_drain": ({}, True),
    "while_ring_spec_drain": (dict(WHILE_RING, spec_k=3), True),
    "while_ring_sampled_drain": (dict(WHILE_RING, **SAMPLE_KW), True),
}
#: the prefix-cache case of ROADMAP Queue 3 item 22
TRIE_PROMPT, TRIE_NEW, TRIE_PAGE = list(range(1, 14)), 8, 4


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _weights(seed):
    prng.reset()
    return TT.init_transformer_params(
        prng.RandomGenerator("init", seed), VOCAB, d_model=D_MODEL,
        n_heads=N_HEADS, n_layers=N_LAYERS, max_len=PARAMS_LEN)


@pytest.fixture(scope="module")
def trees():
    """{version: host tree}: A serves at 0, B is swapped in."""
    return {0: _weights(24), NEW_VERSION: _weights(25)}


@pytest.fixture(scope="module")
def greedy(trees):
    """``greedy(version, prompt, n_new)``: the reference ``generate``'s
    tokens on that version's weights."""
    params = {v: jax.tree.map(jnp.asarray, t) for v, t in trees.items()}
    memo = {}

    def run(version, prompt, n_new):
        key = (version, tuple(prompt))
        if key not in memo:
            row = numpy.pad(numpy.asarray(prompt, numpy.int32),
                            (0, GEN_WIDTH - len(prompt)))[None]
            memo[key] = numpy.asarray(JT.generate(
                params[version], jnp.asarray(row), GEN_NEW, N_HEADS,
                temperature=0.0, max_len=GEN_WIDTH + GEN_NEW,
                true_len=len(prompt)))[0][GEN_WIDTH:]
        return memo[key][:n_new]
    return run


def _port(params, slots=2, page=PAGE, **knobs):
    return LMEngine(params, N_HEADS, MAX_LEN, slots=slots, prefill_chunk=page,
                    device="cpu", **knobs)


def _reference(params, slots=2, page=PAGE, **knobs):
    return JaxLMEngine(params, N_HEADS, MAX_LEN, slots=slots,
                       prefill_chunk=page, paged_kv=True, name="ref_swap",
                       **knobs)


def _wait_for(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out waiting"
        time.sleep(0.005)


def _in_thread(fn):
    """Run ``fn`` on a thread; returns (thread, box): box["value"] or
    box["exc"] once it is joined."""
    box = {}

    def run():
        try:
            box["value"] = fn()
        except Exception as e:   # noqa: BLE001 — read by the test
            box["exc"] = e
    thread = threading.Thread(target=run)
    thread.start()
    return thread, box


def _swap_mid_traffic(engine, plan, new, drain, requests=REQUESTS):
    """Queue ``requests`` before the first turn, let the plan freeze the
    worker at its third turn, ask for the swap from a second thread,
    then thaw.  Returns ([(tokens, stamped version)], the swap's
    result, the engine's counters)."""
    with engine._cond:
        engine.start()
        futures = [engine.submit(p, n) for p, n in requests]
    try:
        _wait_for(lambda: plan.calls("engine.tick") >= 3)
        thread, box = _in_thread(lambda: engine.swap_weights(
            new, version=NEW_VERSION, drain=drain))
        _wait_for(lambda: engine._pending_swap is not None)
        plan.release()
        thread.join(timeout=120)
        assert not thread.is_alive()
        outs = [([int(t) for t in f.result(timeout=120)], f.version)
                for f in futures]
    finally:
        plan.release()
        engine.stop()
    return outs, box, engine.metrics.snapshot()


@pytest.fixture(scope="module", params=sorted(CASES))
def reference_swap(request, trees):
    knobs, drain = CASES[request.param]
    jprng.reset()
    plan = JaxFaultPlan().arm("engine.tick", kind="freeze", calls=[3])
    engine = _reference(trees[0], faults=plan, **knobs)
    return request.param, _swap_mid_traffic(engine, plan,
                                            trees[NEW_VERSION], drain)


def _live_hold(live, tree):
    """The tensors a captured graph read (``live``, recorded before the
    swap) hold ``tree``'s values."""
    for t, want in zip(live, TT.tree_leaves(tree)):
        assert numpy.array_equal(t.numpy(), numpy.asarray(want)), \
            "a captured tensor kept the old weights"


def test_swap_mid_traffic_equals_reference(trees, greedy, reference_swap):
    """Every request resolves once with the reference's stamp and
    tokens; a greedy result equals ``generate`` on its stamp's weights;
    finish-on-old serves both versions, drain only the new one; the
    swap, requeue and version books equal the reference's; the tensors
    the programs read by address hold B; every page comes home."""
    name, (want, want_box, want_m) = reference_swap
    knobs, drain = CASES[name]
    plan = FaultPlan().arm("engine.tick", kind="freeze", calls=[3])
    engine = _port(trees[0], faults=plan, **knobs)
    live = TT.tree_leaves(engine.params)
    got, box, m = _swap_mid_traffic(engine, plan, trees[NEW_VERSION], drain)
    assert "exc" not in box and "exc" not in want_box
    assert box["value"] == want_box["value"] == NEW_VERSION
    assert got == want
    stamps = {v for _, v in got}
    assert stamps == ({NEW_VERSION} if drain else {0, NEW_VERSION})
    if not knobs.get("temperature"):
        for (prompt, n_new), (toks, version) in zip(REQUESTS, got):
            numpy.testing.assert_array_equal(toks,
                                             greedy(version, prompt, n_new))
    c, wc = m["counters"], want_m["counters"]
    for key in ("weight_swaps", "requests_requeued_for_swap", "tokens_out",
                "decode_dispatches", "prefill_dispatches",
                "megastep_refills"):
        assert c.get(key, 0) == wc.get(key, 0), key
    assert c["weight_swaps"] == 1 and m["errors"] == 0
    if drain or knobs.get("refill_ring"):
        assert c["requests_requeued_for_swap"] >= 1
    assert m["gauges"]["weights_version"] == NEW_VERSION
    assert m["gauges"]["swap_quiesce_s"] > 0
    assert [t is u for t, u in zip(live, TT.tree_leaves(engine.params))] \
        == [True] * len(live)
    _live_hold(live, trees[NEW_VERSION])
    inv = engine.verify_pool_invariants()
    assert inv["used_pages"] == 0 and not engine._ring


def test_planted_pointer_swap_is_caught(trees, greedy):
    """A swap that reassigns ``params`` (the reference's pointer swap)
    instead of copying in place leaves the tensors the captured graphs
    read on A: the check fails.  (On the CPU the programs read
    ``params`` per call, so its tokens would still be B's — only a
    captured graph binds the addresses; the card test serves A's tokens
    from one.)"""
    engine = _port(trees[0], megastep=4).start()
    live = TT.tree_leaves(engine.params)
    engine._load_params = lambda staged: setattr(engine, "params", staged)
    try:
        engine.swap_weights(trees[NEW_VERSION])
        out = engine.generate(numpy.asarray([[1, 2, 3]]), 5)
    finally:
        engine.stop()
    numpy.testing.assert_array_equal(out[0, 3:], greedy(NEW_VERSION,
                                                        [1, 2, 3], 5))
    with pytest.raises(AssertionError, match="kept the old weights"):
        _live_hold(live, trees[NEW_VERSION])
    _live_hold(live, trees[0])


def _trie_run(engine, new):
    """The prompt twice around a swap on a page-4 engine with a prefix
    cache: (tokens before, chunks cached before, tokens after, chunks
    cached right after the apply, the stamp after)."""
    engine.start()
    try:
        prompt = numpy.asarray([TRIE_PROMPT])
        before = engine.generate(prompt, TRIE_NEW)[0, len(TRIE_PROMPT):]
        cached = engine._trie.size
        engine.swap_weights(new)
        at_apply = engine._trie.size
        out, vers = engine.generate(prompt, TRIE_NEW, return_versions=True)
    finally:
        engine.stop()
    return (before.tolist(), cached, out[0, len(TRIE_PROMPT):].tolist(),
            at_apply, vers[0])


@pytest.fixture(scope="module")
def reference_trie(trees):
    jprng.reset()
    engine = _reference(trees[0], page=TRIE_PAGE, prefix_cache=8)
    return _trie_run(engine, trees[NEW_VERSION])


def test_trie_flushed_at_apply(trees, greedy, reference_trie):
    """ROADMAP Queue 3 item 22: after the swap the port answers the
    cached prompt with ``generate(B)``'s tokens — its trie was flushed
    at the apply (every page home, ``prefix_cache_chunks`` 0) and the
    prompt prefilled again; the reference kept its 3 chunks of A's K/V
    and answers with neither A's tokens nor B's (pinned)."""
    want_a = greedy(0, TRIE_PROMPT, TRIE_NEW).tolist()
    want_b = greedy(NEW_VERSION, TRIE_PROMPT, TRIE_NEW).tolist()
    engine = _port(trees[0], page=TRIE_PAGE, prefix_cache=8)
    before, cached, after, at_apply, version = _trie_run(
        engine, trees[NEW_VERSION])
    assert before == want_a and cached == 3
    assert at_apply == 0 and after == want_b and version == 1
    assert engine.metrics.gauge("prefix_cache_chunks") == 3   # refilled
    ref_before, ref_cached, ref_after, ref_at_apply, _ = reference_trie
    assert ref_before == want_a and ref_cached == ref_at_apply == 3
    assert ref_after != want_a and ref_after != want_b


def test_planted_trie_keep_is_caught(trees, greedy):
    """A swap that keeps the trie serves the old weights' prompt K/V:
    the answer is not ``generate(B)``'s."""
    engine = _port(trees[0], page=TRIE_PAGE, prefix_cache=8)
    engine._flush_prefix_cache = lambda: None
    _, _, after, at_apply, _ = _trie_run(engine, trees[NEW_VERSION])
    assert at_apply == 3
    assert after != greedy(NEW_VERSION, TRIE_PROMPT, TRIE_NEW).tolist()


def test_swap_before_start_applies_at_once(trees, greedy):
    """Not serving: the swap applies on the caller's thread and counts;
    the caller's trees are not written (the engine owns its weights);
    ``start()`` then serves B's tokens, stamped."""
    copy_a = TT.tree_map(numpy.copy, trees[0])
    engine = _port(trees[0], megastep=4)
    assert engine.swap_weights(trees[NEW_VERSION]) == 1
    assert engine.weights_version == 1
    assert engine.metrics.counter("weight_swaps") == 1
    for got, want in zip(TT.tree_leaves(trees[0]), TT.tree_leaves(copy_a)):
        numpy.testing.assert_array_equal(got, want)
    engine.start()
    try:
        out, vers = engine.generate(numpy.asarray([[4, 4, 2]]), 6,
                                    return_versions=True)
    finally:
        engine.stop()
    numpy.testing.assert_array_equal(out[0, 3:],
                                     greedy(NEW_VERSION, [4, 4, 2], 6))
    assert vers == [1]


def _mismatches(tree):
    """Trees the serving tree refuses: another width, a missing key, a
    block short, another dtype."""
    narrow = TT.init_transformer_params(
        prng.RandomGenerator("init", 3), VOCAB, d_model=16,
        n_heads=N_HEADS, n_layers=N_LAYERS, max_len=PARAMS_LEN)
    missing = {k: v for k, v in tree.items() if k != "embed"}
    short = dict(tree, blocks=tree["blocks"][:1])
    wide = TT.tree_map(lambda a: a.astype(numpy.float64), tree)
    return [("shape", narrow, "is \\(16, 16\\) float32 in the new tree but "
             "\\(32, 32\\)"),
            ("structure", missing, "\\['embed'\\] is absent in the new"),
            ("blocks", short, "\\['blocks'\\]\\[1\\]\\S* is absent"),
            ("dtype", wide, "float64 in the new tree")]


def test_mismatch_refused_old_weights_serve(trees, greedy):
    """A structurally incompatible tree refuses loudly (``swap
    refused``), naming the first leaf that differs; the live weights
    are not touched and the old weights keep serving."""
    engine = _port(trees[0]).start()
    try:
        for _, bad, detail in _mismatches(trees[NEW_VERSION]):
            with pytest.raises(ValueError, match="swap refused") as info:
                engine.swap_weights(bad)
            assert "old weights keep serving" in str(info.value)
            assert info.match(detail)
        out = engine.generate(numpy.asarray([[1, 2, 3]]), 5)
    finally:
        engine.stop()
    assert engine.weights_version == 0
    assert engine.metrics.counter("weight_swaps") == 0
    numpy.testing.assert_array_equal(out[0, 3:], greedy(0, [1, 2, 3], 5))


def _sorted_keys(tree):
    """``tree`` with every dict's keys in sorted order, as JAX's tree
    flattening or a sorted checkpoint file gives them."""
    if isinstance(tree, dict):
        return {k: _sorted_keys(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_sorted_keys(v) for v in tree]
    return tree


@pytest.mark.parametrize("serving", [False, True], ids=["idle", "serving"])
def test_swap_copies_by_key_not_position(trees, greedy, serving):
    """B with its keys in another order (each block's ``ln1``/``ln2``
    ``g`` and ``b`` and the four attention matrices swap places) is
    the same tree: the apply copies each leaf into the live tensor of
    the same path, so the engine serves ``generate(B)``'s tokens and
    every live tensor holds B's value at its own path."""
    shuffled = _sorted_keys(trees[NEW_VERSION])
    assert [id(a) for a in TT.tree_leaves(shuffled)] != \
        [id(a) for a in TT.tree_leaves(trees[NEW_VERSION])]
    engine = _port(trees[0], megastep=4)
    live = TT.tree_leaves(engine.params)
    if not serving:
        engine.swap_weights(shuffled)
    engine.start()
    try:
        if serving:
            engine.swap_weights(shuffled)
        out = engine.generate(numpy.asarray([[1, 2, 3]]), 5)
    finally:
        engine.stop()
    numpy.testing.assert_array_equal(out[0, 3:],
                                     greedy(NEW_VERSION, [1, 2, 3], 5))
    _live_hold(live, trees[NEW_VERSION])


def test_planted_positional_copy_is_caught(trees):
    """A swap that pairs the live and new leaves by position, each tree
    in its own key order, puts B's values into the wrong tensors: the
    keyed check above fails on it."""
    engine = _port(trees[0], megastep=4)
    live = TT.tree_leaves(engine.params)

    def positional(staged):
        with torch.no_grad():
            for t, new in zip(TT.tree_leaves(engine.params),
                              TT.tree_leaves(staged)):
                t.copy_(new)
    engine._load_params = positional
    try:
        engine.swap_weights(_sorted_keys(trees[NEW_VERSION]))
    except RuntimeError:
        return                     # a shape that does not broadcast
    with pytest.raises(AssertionError, match="kept the old weights"):
        _live_hold(live, trees[NEW_VERSION])


def test_swap_fault_refuses_then_next_swap_applies(trees, greedy):
    """An ``engine.swap`` fault refuses the swap and re-raises to the
    caller; A keeps serving (the live tensors untouched); the next swap
    applies."""
    plan = FaultPlan().arm("engine.swap", times=1)
    engine = _port(trees[0], faults=plan, megastep=4).start()
    live = TT.tree_leaves(engine.params)
    try:
        with pytest.raises(InjectedFault, match="engine.swap"):
            engine.swap_weights(trees[NEW_VERSION])
        _live_hold(live, trees[0])
        out_a = engine.generate(numpy.asarray([[1, 2, 3]]), 5)
        assert engine.swap_weights(trees[NEW_VERSION]) == 1
        out_b = engine.generate(numpy.asarray([[1, 2, 3]]), 5)
    finally:
        engine.stop()
    numpy.testing.assert_array_equal(out_a[0, 3:], greedy(0, [1, 2, 3], 5))
    numpy.testing.assert_array_equal(out_b[0, 3:],
                                     greedy(NEW_VERSION, [1, 2, 3], 5))
    m = engine.metrics
    assert m.counter("weight_swap_failures") == 1 and m.errors == 1
    assert m.counter("weight_swaps") == 1 and plan.fired("engine.swap") == 1


def test_timeout_withdraws_and_a_second_swap_is_refused(trees, greedy):
    """A wedged worker: a second swap while one is pending is refused;
    the pending one times out, is withdrawn, and A keeps serving."""
    plan = FaultPlan().arm("engine.tick", kind="freeze", calls=[2])
    engine = _port(trees[0], faults=plan).start()
    try:
        _wait_for(lambda: plan.calls("engine.tick") >= 2)
        thread, box = _in_thread(lambda: engine.swap_weights(
            trees[NEW_VERSION], timeout_s=0.5))
        _wait_for(lambda: engine._pending_swap is not None)
        with pytest.raises(RuntimeError, match="already in flight"):
            engine.swap_weights(trees[NEW_VERSION])
        thread.join(timeout=30)
        assert isinstance(box.get("exc"), RuntimeError)
        assert "old weights keep serving" in str(box["exc"])
        assert engine._pending_swap is None
        plan.release()
        out = engine.generate(numpy.asarray([[1, 2, 3]]), 5)
    finally:
        plan.release()
        engine.stop()
    assert engine.weights_version == 0
    numpy.testing.assert_array_equal(out[0, 3:], greedy(0, [1, 2, 3], 5))


def test_stop_fails_a_pending_swap(trees):
    """A worker that stops before it applies a pending swap fails the
    caller's swap instead of stranding it (its apply held back here so
    the swap is still pending when the loop ends)."""
    engine = _port(trees[0]).start()
    engine._maybe_apply_swap = lambda: None
    thread, box = _in_thread(lambda: engine.swap_weights(trees[NEW_VERSION]))
    try:
        _wait_for(lambda: engine._pending_swap is not None)
    finally:
        engine.stop()
    thread.join(timeout=30)
    assert isinstance(box.get("exc"), RuntimeError)
    assert "stopped before the swap applied" in str(box["exc"])
    assert engine.weights_version == 0


def test_swap_during_stop_is_refused(trees):
    """A swap asked for while ``stop()`` is joining the worker (here
    frozen in its loop turn) is refused, as the stop drain refuses a
    pending one: the worker may still be replaying a graph on the live
    tensors, so nothing is copied into them."""
    plan = FaultPlan().arm("engine.tick", kind="freeze", calls=[2])
    engine = _port(trees[0], faults=plan, megastep=4).start()
    live = TT.tree_leaves(engine.params)
    _wait_for(lambda: plan.calls("engine.tick") >= 2)
    stopper = threading.Thread(target=engine.stop)
    stopper.start()
    try:
        _wait_for(lambda: engine._stop)
        with pytest.raises(RuntimeError,
                           match="stopped before the swap applied"):
            engine.swap_weights(trees[NEW_VERSION])
    finally:
        plan.release()
        stopper.join(timeout=60)
    assert not stopper.is_alive()
    assert engine.weights_version == 0
    assert engine.metrics.counter("weight_swaps") == 0
    _live_hold(live, trees[0])
