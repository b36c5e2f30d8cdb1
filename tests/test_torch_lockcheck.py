"""The port's lock-order witness (``veles_tpu_torch/serving/lockcheck.py``)
against the reference's.

Every case of ``tests/test_lint.py::TestLockOrderWitness`` runs against
the port's module: a deliberate inversion is caught with both stacks (and
raised when asked), a lock held across a dispatch site is caught, a
non-reentrant re-acquire is caught, a Condition keeps its semantics
while armed, and the unarmed shims are inert.  Then one request script —
greedy and sampled engines, a fault plan, a traced request, a swap —
runs through the reference's ``LMEngine`` under the reference's witness
and through the port's under the port's: neither records a violation,
and the two role edge graphs are equal.
"""

import collections
import threading
import time

import numpy
import pytest
import torch

from veles_tpu.serving import FaultPlan as JaxFaultPlan
from veles_tpu.serving import SpanTracer as JaxSpanTracer
from veles_tpu.serving import lockcheck as jlockcheck
from veles_tpu.serving.lm_engine import LMEngine as JaxLMEngine
from veles_tpu_torch import prng
from veles_tpu_torch.ops import transformer as TT
from veles_tpu_torch.serving import (FaultPlan, LMEngine, LockOrderViolation,
                                     LockOrderWitness, SpanTracer, lockcheck)

VOCAB, D_MODEL, N_HEADS, N_LAYERS, PAGE, MAX_LEN = 32, 32, 4, 2, 8, 64
SAMPLE_KW = dict(temperature=0.8, top_k=5, sample_seed=123)
REQUESTS = [([1, 2, 3], 6), ([5, 1] * 5, 5), (list(range(3, 22)), 4)]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class TestLockOrderWitness:
    def test_deliberate_inversion_caught_with_both_stacks(self):
        w = LockOrderWitness(name="t_invert")
        lockcheck.arm(w)
        try:
            a = lockcheck.make_lock("fixture.A")
            b = lockcheck.make_lock("fixture.B")
            with a:
                with b:
                    pass
            with b:                # the documented order, inverted
                with a:
                    pass
        finally:
            lockcheck.disarm()
        assert len(w.violations) == 1
        report = w.violations[0]
        assert "cycle" in report
        assert "fixture.A" in report and "fixture.B" in report
        # both stacks: where the held lock was taken, where the
        # conflicting acquire happened
        assert report.count("test_torch_lockcheck.py") >= 2

    def test_inversion_raises_when_asked(self):
        w = LockOrderWitness(raise_on_violation=True)
        lockcheck.arm(w)
        try:
            a = lockcheck.make_lock("fixture.C")
            b = lockcheck.make_lock("fixture.D")
            with a:
                with b:
                    pass
            with pytest.raises(LockOrderViolation):
                with b:
                    with a:
                        pass
        finally:
            lockcheck.disarm()

    def test_lock_held_across_dispatch_caught(self):
        w = LockOrderWitness(name="t_dispatch")
        lockcheck.arm(w)
        try:
            lock = lockcheck.make_lock("fixture.E")
            lockcheck.note_dispatch("engine.step")   # lock-free: fine
            with lock:
                lockcheck.note_dispatch("engine.step")
        finally:
            lockcheck.disarm()
        assert len(w.violations) == 1
        assert "held across device dispatch" in w.violations[0]
        assert "engine.step" in w.violations[0]

    def test_nonreentrant_reacquire_caught(self):
        w = LockOrderWitness(name="t_reent", raise_on_violation=True)
        lockcheck.arm(w)
        try:
            lock = lockcheck.make_lock("fixture.F")
            with lock:
                with pytest.raises(LockOrderViolation):
                    with lock:
                        pass
        finally:
            lockcheck.disarm()

    def test_condition_wait_notify_under_witness(self):
        """The Condition wrapper keeps primitive semantics while armed:
        wait releases (held-stack popped — a concurrent notifier
        acquiring is no violation) and re-acquires."""
        w = LockOrderWitness(name="t_cond")
        lockcheck.arm(w)
        try:
            cond = lockcheck.make_condition("fixture.cond")
            seen = []

            def waiter():
                with cond:
                    while not seen:
                        cond.wait(5.0)
                    seen.append("woke")

            t = threading.Thread(target=waiter)
            t.start()
            time.sleep(0.05)
            with cond:
                seen.append("go")
                cond.notify_all()
            t.join(timeout=10)
            assert not t.is_alive()
            assert seen == ["go", "woke"]
        finally:
            lockcheck.disarm()
        assert w.violations == []
        assert w.acquisitions >= 2

    def test_unarmed_shims_are_inert(self):
        assert lockcheck.armed() is None
        lock = lockcheck.make_lock("fixture.G")
        with lock:
            lockcheck.note_dispatch("engine.step")
        cond = lockcheck.make_condition("fixture.H")
        with cond:
            cond.notify_all()


def test_api_and_dispatch_sites_match_the_reference():
    """The port's module carries the reference's whole API, its dispatch
    sites (``engine.prefill`` included, the contiguous layout's) and a
    re-entrant condition."""
    for name in ("LockOrderWitness", "LockOrderViolation", "arm", "disarm",
                 "armed", "note_dispatch", "DISPATCH_SITES", "TrackedLock",
                 "TrackedCondition", "make_lock", "make_condition"):
        assert hasattr(lockcheck, name), name
    assert lockcheck.DISPATCH_SITES == jlockcheck.DISPATCH_SITES
    cond = lockcheck.make_condition("fixture.I")
    with cond:
        with cond:
            pass
    assert isinstance(lockcheck.make_lock("fixture.J"), lockcheck.TrackedLock)


def _weights(seed):
    prng.reset()
    return TT.init_transformer_params(
        prng.RandomGenerator("init", seed), VOCAB, d_model=D_MODEL,
        n_heads=N_HEADS, n_layers=N_LAYERS, max_len=2 * MAX_LEN)


def _script(make, plan_cls, tracer_cls, trees):
    """The request script on engines built by ``make(params, **knobs)``:
    a greedy engine with a fault plan (the second chunk dispatch fails
    its request) and a tracer sampling every request, then a swap; a
    sampled engine.  Returns the greedy and sampled tokens (None where
    a request failed)."""
    plan = plan_cls().arm("engine.chunk", kind="error", calls=[2])
    tracer = tracer_cls(mode="all")
    out = []
    engine = make(trees[0], faults=plan, tracer=tracer).start()
    try:
        for prompt, n_new in REQUESTS:
            try:
                out.append([int(t) for t in
                            engine.submit(prompt, n_new).result(timeout=120)])
            except Exception:   # noqa: BLE001 — the planted fault
                out.append(None)
        assert engine.swap_weights(trees[1], version=3) == 3
        out.append([int(t) for t in
                    engine.submit([4, 4, 4], 5).result(timeout=120)])
    finally:
        engine.stop()
    engine = make(trees[0], **SAMPLE_KW).start()
    try:
        futures = [engine.submit(p, n) for p, n in REQUESTS]
        out += [[int(t) for t in f.result(timeout=120)] for f in futures]
    finally:
        engine.stop()
    return out


def _tallied(witness):
    """``witness`` with its dispatch sites counted in ``witness.sites``."""
    witness.sites = collections.Counter()
    check = witness.dispatch

    def dispatch(site):
        witness.sites[site] += 1
        check(site)
    witness.dispatch = dispatch
    return witness


def test_engine_edge_graph_equals_the_reference():
    """One request script through both engines, each under its own
    package's witness: no violation on either side, the same tokens, the
    same role edge graph, and the same dispatch checks a site but the
    fence.  The reference fences every traced decode dispatch after its
    read-back; the port's decode paths read back, which waits, and fence
    nothing, while it fences the swap's queued in-place copies, which the
    reference's pointer swap has none of (ROADMAP Queue 3)."""
    trees = [_weights(24), _weights(25)]

    def port(params, **knobs):
        return LMEngine(params, N_HEADS, MAX_LEN, slots=2,
                        prefill_chunk=PAGE, device="cpu", **knobs)

    def reference(params, **knobs):
        return JaxLMEngine(params, N_HEADS, MAX_LEN, slots=2,
                           prefill_chunk=PAGE, paged_kv=True,
                           name="ref_lockcheck", **knobs)

    want_w = _tallied(jlockcheck.LockOrderWitness(name="reference"))
    jlockcheck.arm(want_w)
    try:
        want = _script(reference, JaxFaultPlan, JaxSpanTracer, trees)
    finally:
        jlockcheck.disarm()
    got_w = _tallied(LockOrderWitness(name="port"))
    lockcheck.arm(got_w)
    try:
        got = _script(port, FaultPlan, SpanTracer, trees)
    finally:
        lockcheck.disarm()
    assert got == want
    assert sum(o is None for o in got) == 1
    want_r, got_r = want_w.report(), got_w.report()
    assert want_r["violations"] == [] and got_r["violations"] == [], \
        "\n\n".join(want_r["violations"] + got_r["violations"])
    assert got_r["edges"] == want_r["edges"]
    assert set(got_r["edges"]["lm_engine._cond"]) >= {"metrics._lock",
                                                      "tracing._lock"}
    assert got_r["acquisitions"] > 0
    fences = (got_w.sites.pop("engine.fence"),
              want_w.sites.pop("engine.fence"))
    assert got_w.sites == want_w.sites
    # the five traced prompt chunks that ran fence on both sides; the
    # port adds its swap fence, the reference its twelve traced decode
    # dispatches' (the requests go one at a time, so the schedule is fixed)
    assert fences == (5 + 1, 5 + 12)


def test_lock_held_across_engine_dispatch_is_caught():
    """The planted fault: a worker that holds ``lm_engine._cond`` across
    its ``engine.step`` dispatch is reported, with the dispatch site."""
    engine = LMEngine(_weights(24), N_HEADS, MAX_LEN, slots=2,
                      prefill_chunk=PAGE, device="cpu")
    step = engine._step_plain

    def held(active):
        with engine._cond:
            return step(active)
    engine._step_plain = held
    w = LockOrderWitness(name="t_engine_held")
    lockcheck.arm(w)
    try:
        engine.start()
        try:
            toks = engine.submit([1, 2, 3], 3).result(timeout=60)
        finally:
            engine.stop()
    finally:
        lockcheck.disarm()
    assert len(numpy.asarray(toks)) == 3
    assert w.violations
    assert all("'lm_engine._cond' held across device dispatch "
               "'engine.step'" in v for v in w.violations)
