"""The port's fault plans and crash-safe recovery against the reference.

``veles_tpu_torch.serving.FaultPlan`` and ``veles_tpu.serving.FaultPlan``
are driven with one spec and one call sequence: the same calls fire
(``prob`` drawn from the same seeded stream), with the same named
exceptions.  The same seeded weights (one numpy prng stream) then serve
the same requests through the port's ``LMEngine`` on the CPU and the
reference's paged ``LMEngine``, each armed with its own package's plan
from that spec, every request queued before the loops' first turn (the
engine's re-entrant condition is held across ``start()`` and the
submits), so the schedule — and the call number a rule fires at — is
fixed by the loop, not by the clock.  At every site (``engine.step`` per
tick, in the scan and in the while megastep; ``engine.chunk`` on a lane
and on a standby ring entry; ``engine.verify``; ``engine.tick``; a
seeded ``prob`` mix) the same futures fail with ``InjectedFault``, the
others' tokens are equal and greedy, the books are equal, every page
comes home, and the next requests decode greedy.  ``engine.cow`` is held
to the reference's own test of it (a shared page and one write).

A frozen engine's ``checkpoint()`` equals the reference's for the same
traffic, and ``restore`` into a fresh engine gives the reference
restore's tokens, greedy and sampled (a restored request draws under
its new admission id on both sides).  The HTTP, batcher, ``serve_lm``
and CLI sites close the file.
"""

import json
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

from veles_tpu import prng as jprng
from veles_tpu.ops import transformer as JT
from veles_tpu.restful_api import RESTfulAPI as JaxRESTfulAPI
from veles_tpu.serving import FaultPlan as JaxFaultPlan
from veles_tpu.serving.lm_engine import LMEngine as JaxLMEngine
from veles_tpu.serving.lm_engine import _Request as _JaxRequest
from veles_tpu.serving.lm_engine import _Slot as _JaxSlot
from veles_tpu_torch import __main__ as cli
from veles_tpu_torch import prng, restful_api
from veles_tpu_torch.config import root
from veles_tpu_torch.launcher import Launcher
from veles_tpu_torch.ops import transformer as TT
from veles_tpu_torch.restful_api import RESTfulAPI, serve_lm
from veles_tpu_torch.serving import (FaultPlan, InjectedFault, LMEngine,
                                     Overloaded, PoolExhausted, faults)
from veles_tpu_torch.serving.lm_engine import _Request, _Slot
from torch_witness import port_witness  # noqa: F401

VOCAB, D_MODEL, N_HEADS, N_LAYERS, PAGE = 32, 32, 4, 2, 8
#: the engines' lane span; the weights' learned positions reach
#: PARAMS_LEN for ``generate``
MAX_LEN, PARAMS_LEN = 64, 128
GEN_WIDTH, GEN_NEW = 48, 24
SAMPLE_KW = dict(temperature=0.8, top_k=5, sample_seed=123)

_rng = numpy.random.RandomState(24)
#: multi-chunk prompts (a lane and a ring entry prefill over several
#: turns), a periodic one (drafts lock on) and short ones
REQUESTS = [
    (_rng.randint(0, VOCAB, 19).tolist(), 7),
    ([1, 2, 3], 9),
    ([5, 1] * 5, 8),
    (_rng.randint(0, VOCAB, 11).tolist(), 5),
    ([9, 8, 7], 6),
]
AFTER = [([2, 4, 6, 8], 5), ([7, 7, 1], 4)]
WHILE_RING = {"megastep": 4, "megastep_mode": "while", "refill_ring": 1}
#: site scenarios: (engine knobs, the plan's spec)
SCENARIOS = {
    "step_tick": ({}, [{"site": "engine.step", "calls": [3]}]),
    "step_scan": ({"megastep": 4}, [{"site": "engine.step", "calls": [2]}]),
    "step_while_ring": (WHILE_RING,
                        [{"site": "engine.step", "calls": [2]}]),
    "chunk_lane": ({}, [{"site": "engine.chunk", "calls": [2]}]),
    # one slot and a ring of one: chunks 1 and 5-9 are the ring's, and
    # 5 is the first of the periodic prompt's entry
    "chunk_ring": (dict(WHILE_RING, slots=1),
                   [{"site": "engine.chunk", "calls": [5]}]),
    "verify": ({"spec_k": 3}, [{"site": "engine.verify", "calls": [2]}]),
    "tick_ring": (dict(WHILE_RING, slots=1),
                  [{"site": "engine.tick", "calls": [6]}]),
    "prob_mix": ({"megastep": 4, "prefix_cache": 16},
                 [{"site": "engine.step", "prob": 0.4, "times": 2},
                  {"site": "engine.chunk", "every": 5}]),
}
#: the counters the two engines share by name and meaning
COUNTERS = ("decode_dispatches", "prefill_dispatches", "prefill_tokens",
            "tokens_out", "megastep_dispatches", "megastep_refills",
            "draft_tokens", "draft_accepted", "prefix_hit_chunks")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def host():
    prng.reset()
    return TT.init_transformer_params(
        prng.RandomGenerator("init", 24), VOCAB, d_model=D_MODEL,
        n_heads=N_HEADS, n_layers=N_LAYERS, max_len=PARAMS_LEN)


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
            memo[key] = numpy.asarray(JT.generate(
                params, jnp.asarray(row), GEN_NEW, N_HEADS, temperature=0.0,
                max_len=GEN_WIDTH + GEN_NEW,
                true_len=len(prompt)))[0][GEN_WIDTH:]
        return memo[key][:n_new]
    return run


def _port(host, slots=2, **knobs):
    return LMEngine(host, N_HEADS, MAX_LEN, slots=slots, prefill_chunk=PAGE,
                    device="cpu", **knobs)


def _reference(host, slots=2, paged_kv=True, **knobs):
    return JaxLMEngine(host, N_HEADS, MAX_LEN, slots=slots,
                       prefill_chunk=PAGE, paged_kv=paged_kv,
                       name="ref_faults", **knobs)


def _queued_then_started(engine, requests):
    """Start ``engine`` with every request queued before its loop's first
    turn; returns the futures."""
    with engine._cond:
        engine.start()
        return [engine.submit(p, n) for p, n in requests]


def _outcomes(futures):
    """Each future's tokens, or the name of the exception it failed
    with (an injected fault reads ``"InjectedFault"`` in both
    packages)."""
    out = []
    for f in futures:
        try:
            out.append([int(t) for t in f.result(timeout=120)])
        except Exception as e:   # noqa: BLE001 — the outcome compared
            out.append(type(e).__name__)
    return out


def _wait_for(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out waiting"
        time.sleep(0.005)


# ------------------------------------------------------------ the plan
CALL_ORDER = ["engine.step", "engine.chunk", "engine.step", "http.request",
              "engine.tick", "engine.step", "engine.chunk"] * 30
PLAN_SPEC = {"seed": 7, "sites": [
    {"site": "engine.step", "calls": [2, 5, 9]},
    {"site": "engine.step", "every": 7, "after": 20, "times": 3},
    {"site": "engine.chunk", "prob": 0.3, "exc": "RuntimeError"},
    {"site": "http.request", "prob": 0.5, "times": 4, "exc": "http_503"},
    {"site": "engine.tick", "kind": "latency", "every": 10,
     "latency_s": 0.0},
]}


def _fire_all(plan, order):
    """(site, call number, what fired) for every call of ``order``: the
    raised exception's class name, message, and HTTP code and
    Retry-After where it has them (either package's classes)."""
    log = []
    for site in order:
        try:
            plan.fire(site)
            what = None
        except Exception as e:   # noqa: BLE001 — the outcome compared
            what = (type(e).__name__, str(e), getattr(e, "code", None),
                    getattr(e, "retry_after", None))
        log.append((site, plan.calls(site), what))
    return log


def test_plan_fires_at_the_reference_calls():
    """One spec, one call order: every call fires (or not) exactly as
    the reference plan's, ``prob`` included, with the same exception;
    the fired and call counts are equal."""
    port = FaultPlan.from_spec(PLAN_SPEC)
    ref = JaxFaultPlan.from_spec(PLAN_SPEC)
    got = _fire_all(port, CALL_ORDER)
    assert got == _fire_all(ref, CALL_ORDER)
    assert port.fired() == ref.fired()
    for site in set(CALL_ORDER):
        assert port.calls(site) == ref.calls(site)
    fired = {s for s, _, w in got if w}
    assert {w[0] for _, _, w in got if w} == {
        "InjectedFault", "RuntimeError", "InjectedHTTPError"}
    assert fired == {"engine.step", "engine.chunk", "http.request"}
    # prob fired on some chunk calls and not on others
    chunk = [w for s, _, w in got if s == "engine.chunk"]
    assert 0 < sum(bool(w) for w in chunk) < len(chunk)


def test_plan_rules_and_disarm():
    """``calls`` / ``every`` / ``after`` / ``times`` AND together;
    ``disarm`` of a site (then of all) makes later calls no-ops while the
    call counters go on."""
    plan = FaultPlan().arm("a", every=2, after=3, times=2) \
        .arm("b", calls={1, 3})
    fired = []
    for n in range(1, 11):
        try:
            plan.fire("a")
        except InjectedFault:
            fired.append(n)
    assert fired == [4, 6] and plan.fired("a") == 2
    with pytest.raises(InjectedFault, match="injected error at b"):
        plan.fire("b")
    plan.fire("b")
    plan.disarm("b")
    plan.fire("b")
    assert plan.calls("b") == 3 and plan.fired("b") == 1
    plan.arm("c")
    plan.disarm()
    plan.fire("c")
    assert plan.fired() == {"a": 2, "b": 1}
    with pytest.raises(ValueError, match="fault kind"):
        plan.arm("a", kind="explode")


@pytest.mark.parametrize("name,check", [
    ("InjectedFault", lambda e: type(e) is InjectedFault),
    ("RuntimeError", lambda e: type(e) is RuntimeError),
    ("Overloaded", lambda e: type(e) is Overloaded),
    ("PoolExhausted", lambda e: isinstance(e, PoolExhausted)
     and isinstance(e, Overloaded)),
    ("http_429", lambda e: (e.code, e.retry_after) == (429, 0.25)),
    ("http_500", lambda e: (e.code, e.retry_after) == (500, 1.0)),
    ("http_503", lambda e: (e.code, e.retry_after) == (503, 1.0)),
])
def test_named_exceptions(name, check):
    """The JSON names raise the port's own admission exceptions and the
    reference's HTTP codes."""
    plan = FaultPlan().arm("s", exc=name, message="m")
    with pytest.raises(Exception) as info:
        plan.fire("s")
    assert check(info.value)
    with pytest.raises(ValueError, match="unknown fault exception"):
        FaultPlan().arm("s", exc="Nope")


def test_spec_and_file(tmp_path):
    """A plan from a JSON file equals one from the same dict."""
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(PLAN_SPEC))
    a = FaultPlan.from_file(str(path))
    b = FaultPlan.from_spec(PLAN_SPEC)
    assert _fire_all(a, CALL_ORDER) == _fire_all(b, CALL_ORDER)
    assert a.fired() == b.fired()


def test_latency_freeze_and_release():
    """A latency rule sleeps; a freeze blocks its caller until
    ``release()``, after which every freeze, present and future, is a
    no-op."""
    plan = FaultPlan().arm("slow", kind="latency", latency_s=0.05) \
        .arm("wedge", kind="freeze", duration_s=30.0)
    t0 = time.monotonic()
    plan.fire("slow")
    assert time.monotonic() - t0 >= 0.05
    done = threading.Event()
    worker = threading.Thread(target=lambda: (plan.fire("wedge"),
                                              done.set()))
    worker.start()
    _wait_for(lambda: plan.calls("wedge") == 1)
    assert not done.wait(0.1)
    plan.release()
    worker.join(timeout=10)
    assert done.is_set() and not worker.is_alive()
    plan.fire("wedge")
    assert plan.fired("wedge") == 2


def test_faults_module_imports_no_reference():
    src = open(faults.__file__, encoding="utf-8").read()
    assert "import jax" not in src and "from veles_tpu." not in src


# ----------------------------------------------------- the engine sites
def _serve_with_plan(engine, plan, names):
    """Every request queued before the first turn; returns (outcomes,
    counters, errors, each of ``names``' calls and firings, the outcomes
    of the two requests after the drain with the plan disarmed, pool
    invariants after them)."""
    try:
        futures = _queued_then_started(engine, REQUESTS)
        outs = _outcomes(futures)
        _wait_for(lambda: all(ln is None for ln in engine._lanes)
                  and not engine._ring)
        m = engine.metrics.snapshot()
        counters = {k: m["counters"].get(k, 0) for k in COUNTERS}
        errors = m["errors"]
        calls = {n: (plan.calls(n), plan.fired(n)) for n in sorted(names)}
        plan.disarm()
        after = _outcomes([engine.submit(p, n) for p, n in AFTER])
        _wait_for(lambda: all(ln is None for ln in engine._lanes))
        inv = engine.verify_pool_invariants()
    finally:
        engine.stop()
    return outs, counters, errors, calls, after, inv


@pytest.fixture(scope="module", params=sorted(SCENARIOS))
def site_run(request, host):
    """One reference engine run per scenario."""
    knobs, sites = SCENARIOS[request.param]
    spec = {"seed": 5, "sites": sites}
    jprng.reset()
    plan = JaxFaultPlan.from_spec(spec)
    engine = _reference(host, faults=plan, **knobs)
    names = {s["site"] for s in sites} - {"engine.tick"}
    run = _serve_with_plan(engine, plan, names)
    return request.param, spec, plan.fired(), run


def test_sites_fail_the_reference_futures(host, greedy, site_run):
    """The same futures fail with ``InjectedFault`` as in the reference,
    the rest decode the reference's (greedy) tokens; the counters, the
    errors and each site's calls and firings are equal; every page
    comes home; with the plan disarmed the next requests decode
    greedy."""
    name, spec, want_fired, want = site_run
    knobs, sites = SCENARIOS[name]
    plan = FaultPlan.from_spec(spec)
    engine = _port(host, faults=plan, **knobs)
    standby = []
    fail = engine._fail_standby

    def record(entry, exc):
        # a ring entry that takes part in a faulted dispatch (or whose
        # own chunk faults) fails as a lane does
        standby.append(entry.lane.request.prompt.tolist())
        fail(entry, exc)
    engine._fail_standby = record
    ring_at_fault = []
    fail_active = engine._fail_active

    def record_active(active, exc):
        ring_at_fault.append(len(engine._ring))
        fail_active(active, exc)
    engine._fail_active = record_active
    names = {s["site"] for s in sites} - {"engine.tick"}
    got = _serve_with_plan(engine, plan, names)
    outs, counters, errors, calls, after, inv = got
    assert outs == want[0]
    assert "InjectedFault" in outs, "the plan fired at no request"
    if name in ("chunk_ring", "step_while_ring"):
        assert standby, "no ring entry took part in the fault"
    if name == "chunk_ring":
        # exactly the entry whose chunk faulted
        assert [p for (p, _), o in zip(REQUESTS, outs)
                if o == "InjectedFault"] == standby
    if name == "tick_ring":
        # a raised tick fault fails the busy lane, not the ring entry
        # waiting beside it
        assert ring_at_fault == [1] and not standby
    for (prompt, n_new), out in zip(REQUESTS, outs):
        if out != "InjectedFault":
            numpy.testing.assert_array_equal(out, greedy(prompt, n_new))
    assert counters == want[1]
    assert errors == want[2] > 0
    assert calls == want[3]
    assert plan.fired() == want_fired
    assert after == want[4]
    for (prompt, n_new), out in zip(AFTER, after):
        numpy.testing.assert_array_equal(out, greedy(prompt, n_new))
    trie = engine._trie.size if engine._trie is not None else 0
    assert inv["used_pages"] == trie == want[5]["used_pages"]
    assert inv["pinned_pages"] == 0


def test_cow_fault_returns_the_page_as_the_reference(host):
    """``engine.cow`` fires inside the page-copy try, as the reference's
    (``tests/test_kv_pool.py::test_mid_cow_fault_releases_orphan_page``):
    the fresh page goes home, the shared page keeps both referents and
    the lane's pin; disarmed, the same write copies."""
    books = []
    for make, request, slot, plan in (
            (lambda **k: _port(host, slots=1, paged_kv=4, **k), _Request,
             _Slot, FaultPlan().arm("engine.cow", times=1)),
            (lambda **k: _reference(host, slots=1, **dict(k, paged_kv=4)),
             _JaxRequest, _JaxSlot,
             JaxFaultPlan().arm("engine.cow", times=1))):
        engine = make(faults=plan)
        pool = engine._pool
        (p,) = pool.alloc(1)
        pool.retain(p)
        pool.pin(p)
        lane = slot(request(numpy.asarray([1, 2, 3], numpy.int32), 4, 30.0,
                            pages=1))
        lane.pages = [p]
        engine._page_tables[0, 0] = p
        free = pool.free_pages
        with pytest.raises(Exception) as info:
            engine._cow_guard(0, lane, 0, 1)
        assert type(info.value).__name__ == "InjectedFault"
        assert pool.free_pages == free
        assert pool.refs(p) == 2 and pool.pinned(p)
        first = (pool.snapshot(), engine.metrics.counter("kv_cow_copies"))
        plan.disarm()
        engine._cow_guard(0, lane, 0, 1)
        q = lane.pages[0]
        assert q != p and pool.refs(q) == 1 and pool.pinned(q)
        books.append((first, pool.snapshot(), q,
                      engine.metrics.counter("kv_cow_copies")))
    assert books[0] == books[1]
    assert books[0][3] == 1


def test_unarmed_plan_changes_nothing(host, greedy):
    """A plan with no rule: the same tokens and counters as no plan,
    every site counted; ``engine.submit`` counts every admission."""
    runs = []
    for plan in (None, FaultPlan()):
        engine = _port(host, faults=plan, megastep=4)
        futures = _queued_then_started(engine, REQUESTS)
        try:
            outs = _outcomes(futures)
        finally:
            engine.stop()
        m = engine.metrics.snapshot()["counters"]
        runs.append((outs, {k: m.get(k, 0) for k in COUNTERS}))
        if plan is not None:
            assert plan.calls("engine.submit") == len(REQUESTS)
            assert plan.calls("engine.step") == m["decode_dispatches"]
            assert plan.calls("engine.chunk") == m["prefill_dispatches"]
            assert plan.fired() == {}
    assert runs[0] == runs[1]
    for (prompt, n_new), out in zip(REQUESTS, runs[0][0]):
        numpy.testing.assert_array_equal(out, greedy(prompt, n_new))


def test_submit_fault_refuses_admission(host):
    """``engine.submit`` raises to the caller before anything queues (an
    admission storm's shape)."""
    plan = FaultPlan().arm("engine.submit", exc="PoolExhausted", times=1)
    engine = _port(host, faults=plan).start()
    try:
        with pytest.raises(PoolExhausted):
            engine.submit([1, 2, 3], 4)
        assert engine.submit([1, 2, 3], 4).result(timeout=60).shape == (4,)
    finally:
        engine.stop()
    assert engine.checkpoint()["requests"] == []


# ----------------------------------------------- checkpoint and restore
FROZEN = REQUESTS[:4]


def _frozen_checkpoint(engine, plan):
    """Freeze ``engine`` at its third loop turn with ``FROZEN`` queued
    before the first; returns its checkpoint (JSON round-tripped)."""
    _queued_then_started(engine, FROZEN)
    _wait_for(lambda: plan.calls("engine.tick") >= 3)
    return json.loads(json.dumps(engine.checkpoint()))


def _crash(engine, plan):
    plan.release()
    engine.stop()


@pytest.fixture(scope="module")
def reference_restore(host):
    """The reference's checkpoint of the frozen traffic and its restore's
    tokens, greedy and sampled."""
    out = {}
    for mode, kw in (("greedy", {}), ("sampled", SAMPLE_KW)):
        jprng.reset()
        plan = JaxFaultPlan().arm("engine.tick", kind="freeze", calls=[3])
        crashed = _reference(host, faults=plan, prefix_cache=8, **kw)
        try:
            state = _frozen_checkpoint(crashed, plan)
        finally:
            _crash(crashed, plan)
        fresh = _reference(host, prefix_cache=8, **kw).start()
        try:
            restored = fresh.restore(state)
            toks = {rid: [int(t) for t in f.result(timeout=120)]
                    for rid, f in restored.items()}
        finally:
            fresh.stop()
        out[mode] = (state, toks)
    return out


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_checkpoint_equals_reference(host, reference_restore, mode):
    """The frozen engine's checkpoint — the journaled requests, the
    config, the slot frontiers, the page tables and the pool's books —
    equals the reference's for the same traffic, and is JSON-safe."""
    want, _ = reference_restore[mode]
    plan = FaultPlan().arm("engine.tick", kind="freeze", calls=[3])
    crashed = _port(host, faults=plan, prefix_cache=8,
                    **(SAMPLE_KW if mode == "sampled" else {}))
    try:
        got = _frozen_checkpoint(crashed, plan)
    finally:
        _crash(crashed, plan)
    assert got["format"] == want["format"] == 1
    assert got["requests"] == want["requests"]
    assert [r["prompt"] for r in got["requests"]] == [p for p, _ in FROZEN]
    assert got["config"] == want["config"]
    for key in ("slot_frontiers", "page_tables", "pool",
                "prefix_cache_chunks"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_restore_equals_reference(host, greedy, reference_restore, mode):
    """Restored into a fresh engine, the journaled requests decode the
    reference restore's tokens (greedy: ``generate``'s too); the pool
    comes back whole, and the restore is counted."""
    state, want = reference_restore[mode]
    kw = SAMPLE_KW if mode == "sampled" else {}
    fresh = _port(host, prefix_cache=8, **kw).start()
    try:
        restored = fresh.restore(state)
        got = {rid: [int(t) for t in f.result(timeout=120)]
               for rid, f in restored.items()}
        out = fresh.generate(numpy.asarray([FROZEN[1][0]]), 4)
    finally:
        fresh.stop()
    assert got == want
    if mode == "greedy":
        for entry in state["requests"]:
            numpy.testing.assert_array_equal(
                got[entry["rid"]], greedy(entry["prompt"], entry["n_new"]))
        numpy.testing.assert_array_equal(out[0, 3:],
                                         greedy(FROZEN[1][0], 4))
    while fresh._trie.evict_one():
        pass
    inv = fresh.verify_pool_invariants()
    assert inv["free_pages"] == fresh._pool.num_pages
    assert fresh._trie.live_pins() == 0
    assert fresh.metrics.counter("engine_restores") == 1
    assert fresh.metrics.counter("requests_restored") == len(got)


def test_restore_refuses_garbage_and_oversized(host):
    """As the reference (``tests/test_serving.py``): no format, a longer
    max_len, and — all or nothing — an entry the pool can never place
    are refused before any entry is admitted."""
    engine = _port(host, slots=1)
    with pytest.raises(ValueError, match="format"):
        engine.restore({"format": 99})
    with pytest.raises(ValueError, match="format"):
        engine.restore("garbage")
    with pytest.raises(ValueError, match="max_len"):
        engine.restore({"format": 1, "config": {"max_len": 4096},
                        "requests": []})
    with pytest.raises(ValueError, match="cache positions"):
        engine.restore({"format": 1, "requests": [
            {"rid": 1, "prompt": list(range(60)), "n_new": 8}]})
    paged = _port(host, slots=1, paged_kv=2).start()
    try:
        with pytest.raises(ValueError, match="KV pages"):
            paged.restore({"format": 1, "config": {"max_len": MAX_LEN},
                           "requests": [
                               {"rid": 1, "prompt": [1, 2], "n_new": 2},
                               {"rid": 2, "prompt": list(range(20)),
                                "n_new": 10}]})
        assert paged.metrics.requests == 0        # nothing admitted
    finally:
        paged.stop()


def test_journal_pops_on_every_resolution(host):
    """The journal holds exactly the unresolved requests: finished,
    failed and cancelled ones leave it."""
    plan = FaultPlan().arm("engine.step", calls=[1])
    engine = _port(host, slots=1, faults=plan)
    futures = _queued_then_started(engine, [([1, 2, 3], 4), ([4, 5], 4),
                                            ([6, 7], 4)])
    try:
        with pytest.raises(InjectedFault):
            futures[0].result(timeout=60)
        assert futures[1].result(timeout=60).shape == (4,)
        assert futures[2].result(timeout=60).shape == (4,)
        held = engine.submit([1] * 40, 16)
        extra = engine.submit([3, 3], 4)
        engine._cancel(extra.request)
        held.result(timeout=60)
    finally:
        engine.stop()
    assert engine._journal == {}


# ------------------------------------------- HTTP, batcher, serve_lm, CLI
def _post(url, body, timeout=60):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def test_injected_http_errors_as_the_reference():
    """``http.request`` every 2nd call: the injected 503 is a structured
    reply with ``Retry-After``, equal to the reference server's reply
    for the same plan; a 429 carries its own Retry-After, a 500 none."""
    replies = []
    for make, plan in (
            (RESTfulAPI, FaultPlan().arm("http.request", exc="http_503",
                                         every=2)
             .arm("http.request", exc="http_429", calls=[5])
             .arm("http.request", exc="http_500", calls=[7])),
            (JaxRESTfulAPI, JaxFaultPlan().arm("http.request",
                                               exc="http_503", every=2)
             .arm("http.request", exc="http_429", calls=[5])
             .arm("http.request", exc="http_500", calls=[7]))):
        api = make(None, forward=lambda x: x * 2.0, faults=plan)
        api.start(port=0)
        url = "http://127.0.0.1:%d/predict" % api.port
        try:
            run = []
            for _ in range(8):
                code, body, headers = _post(url, {"input": [[1.0, 2.0]]})
                body.pop("request_id", None)
                run.append((code, body, headers.get("Retry-After")))
        finally:
            api.stop()
        replies.append(run)
    assert replies[0] == replies[1]
    codes = [c for c, _, _ in replies[0]]
    assert codes == [200, 503, 200, 503, 429, 503, 500, 503]
    assert replies[0][1] == (503, {"error": "injected transient HTTP 503",
                                   "retry_after": 1.0}, "1")
    assert replies[0][4][2] == "1" and replies[0][6][2] is None
    assert replies[0][0][1]["output"] == [[2.0, 4.0]]


def test_batcher_sites():
    """A ``batcher.dispatch`` fault fails its batch's clients, never the
    worker; ``batcher.submit`` raises to the caller before queueing;
    ``enable_batching`` arms the server's plan at both."""
    plan = FaultPlan().arm("batcher.dispatch", calls=[1]) \
        .arm("batcher.submit", exc="Overloaded", calls=[3])
    api = RESTfulAPI(None, forward=lambda x: x + 1.0, faults=plan)
    api.enable_batching(max_batch=4, batch_wait_s=0.0, sample_shape=(2,))
    batcher = api.batcher
    api.start(port=0)
    url = "http://127.0.0.1:%d/predict" % api.port
    try:
        code, body, _ = _post(url, {"input": [[1.0, 2.0]]})
        assert code == 500 and body["error"].startswith("InjectedFault")
        code, body, _ = _post(url, {"input": [[1.0, 2.0]]})
        assert code == 200 and body["output"] == [[2.0, 3.0]]
        code, body, headers = _post(url, {"input": [[1.0, 2.0]]})
        assert code == 429 and headers["Retry-After"] == "1"
        assert batcher.submit(numpy.ones((1, 2))).tolist() == [[2.0, 2.0]]
    finally:
        api.stop()
    assert plan.fired() == {"batcher.dispatch": 1, "batcher.submit": 1}
    assert plan.calls("batcher.dispatch") == 3


def _lm_workflow(host):
    """What ``serve_lm`` reads of a trained transformer workflow."""
    params = TT.params_from_jax(host, "cpu")
    trainer = SimpleNamespace(params=params, _to_portable=lambda p: p,
                              max_len=MAX_LEN, n_heads=N_HEADS)
    return SimpleNamespace(trainer=trainer)


def test_serve_lm_arms_engine_and_server(host, greedy):
    """``serve_lm(fault_plan=)``: an injected 429 at ``http.request``
    answers before the engine sees the request; an ``engine.submit``
    fault is a 500; then the engine serves ``generate``'s tokens."""
    plan = FaultPlan().arm("http.request", exc="http_429", calls=[1]) \
        .arm("engine.submit", calls=[1])
    api = serve_lm(_lm_workflow(host), port=0, slots=2, fault_plan=plan)
    url = "http://127.0.0.1:%d/predict" % api.port
    body = {"input": [[3, 1, 4, 1, 5]], "n_new": 6}
    try:
        code, reply, headers = _post(url, body)
        assert code == 429 and headers["Retry-After"] == "1"
        code, reply, _ = _post(url, body)
        assert code == 500 and "InjectedFault" in reply["error"]
        code, reply, _ = _post(url, body)
        assert code == 200 and reply["weights_version"] == [0]
        numpy.testing.assert_array_equal(
            reply["tokens"][0][5:], greedy([3, 1, 4, 1, 5], 6))
    finally:
        api.stop()
    assert api.lm_engine._faults is plan
    assert plan.calls("engine.submit") == 2


@pytest.mark.parametrize("sample,batch", [("char_lm", 0), ("mnist", 2)])
def test_cli_fault_plan_arms_the_served_stack(sample, batch, tmp_path,
                                              monkeypatch, capsys):
    """``--fault-plan FILE`` loads the JSON plan and arms it: an LM
    workflow's ``serve_lm`` gets it, a forward chain's server (and its
    batcher) too."""
    path = tmp_path / "plan.json"
    path.write_text(json.dumps({"seed": 3, "sites": [
        {"site": "engine.step", "calls": [2]},
        {"site": "http.request", "exc": "http_503", "every": 4}]}))
    seen = {}

    class Served:
        port = 4321

        def stop(self):
            seen["stopped"] = True

    def fake_serve_lm(wf, port, **kw):
        seen.update(kw)
        return Served()

    def fake_start(api, host="127.0.0.1", port=8180):
        seen.update(fault_plan=api.faults, batcher=api.batcher)
        api.port = 4321
        return api
    monkeypatch.setattr(Launcher, "boot", lambda self: None)
    monkeypatch.setattr(restful_api, "serve_lm", fake_serve_lm)
    monkeypatch.setattr(restful_api.RESTfulAPI, "start", fake_start)
    monkeypatch.setattr(restful_api.RESTfulAPI, "stop",
                        lambda api: seen.update(stopped=True))
    monkeypatch.setattr(cli, "_wait_for_interrupt", lambda: None)
    flags = ["--serve", "0", "--fault-plan", str(path)]
    if batch:
        flags += ["--serve-batch", str(batch)]
    try:
        assert cli.main(["veles_tpu_torch.samples.%s" % sample, "-d", "cpu",
                         *flags]) == 0
    finally:
        root.__dict__.pop(sample, None)
    plan = seen["fault_plan"]
    assert isinstance(plan, FaultPlan) and seen["stopped"]
    plan.fire("engine.step")
    with pytest.raises(InjectedFault):
        plan.fire("engine.step")
    if batch:
        assert seen["batcher"]._faults is plan
    assert "SERVING http://127.0.0.1:4321/predict" in capsys.readouterr().out
