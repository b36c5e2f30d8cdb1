"""The port's resilience layer (``veles_tpu_torch/serving/router.py``:
retries, hedging and :class:`HealthChecker`) against the reference's
``veles_tpu/serving/router.py`` on the CPU.

Tiny engines (vocab 32, d_model 32, 2 heads, 2 layers, max_len 48, page
8, 2 slots; weights from one seeded numpy stream, carried across with
``params_from_jax``), every case under the port's lock-order witness and
armed transfer guard (``tests/torch_witness.py``):

- (a) retry: the reference's ``test_retry_replaces_faulted_request_on_
  other_replica`` — a step fault on replica 0 is re-placed whole on
  replica 1 with the reference's greedy tokens, and with both replicas
  faulting ``InjectedFault`` reaches the client after exactly
  ``retries`` more re-places;
- (b) twenty scripted retries through a captured ``Timer``: the same
  backoff delays as the reference's, for one seed, base and cap;
- (c) hedge: the reference's ``test_hedge_wins_on_slow_replica`` — greedy
  tokens, hedges placed and won, every loser cancelled and never
  delivered, both pools sound once quiet; the dynamic threshold
  (``hedge_after_s < 0``) equal to the reference's response by response;
- (d) the health state machine on stub fleets driven by ``step(now=)``
  with scripted probe outcomes and staleness: states, gauges, counters
  and ``router._live`` EQUAL to the reference's step by step, through
  healthy, open, half-open, re-open with the cooldown doubled to its cap
  and re-registered, an operator-drained replica left alone;
- (e) quarantine and recovery on real engines (the reference's
  ``test_health_checker_quarantines_and_recovers``);
- (f) the SLO hooks (``tests/test_timeseries.py``'s page cases) with the
  port's ``SLOMonitor``; the monitor and a concurrent ``step()`` open
  the circuit exactly once;
- (g) tracing: a sequential retry script through ONE reference fleet and
  one port fleet, traced: each request's span ``(name, cat,
  attributes)`` sequence EQUAL and sound; the hedge loser's spans closed
  under an upstream root;
- (h) the role edge graph of that script, which adds a health-checked
  quarantine and its half-open return, EQUAL to the reference's;
- (i) four planted faults, each a mutated copy of one method: a retry
  that ignores ``exclude``, a ``_deliver`` that lets a hedge loser
  overwrite the winner's stamps, a half-open probe that does not double
  the cooldown, a probe success that resets the SLO page streak.
"""

import inspect
import textwrap
import threading
import time
from concurrent.futures import Future
from types import SimpleNamespace

import numpy
import pytest
import torch

import jax.numpy as jnp

from veles_tpu.ops import transformer as JT
from veles_tpu.serving import FaultPlan as JaxFaultPlan
from veles_tpu.serving import lockcheck as jlockcheck
from veles_tpu.serving import router as jrouter
from veles_tpu.serving import tracing as jtracing
from veles_tpu.serving.faults import InjectedFault as JaxInjectedFault
from veles_tpu.serving.lm_engine import LMEngine as JaxLMEngine
from veles_tpu.serving.metrics import ServingMetrics as JaxServingMetrics
from veles_tpu_torch import prng
from veles_tpu_torch.ops import transformer as TT
from veles_tpu_torch.serving import (FaultPlan, HealthChecker, InjectedFault,
                                     LMEngine, Objective, Router,
                                     RouterMetrics, ServingMetrics,
                                     SLOMonitor, SpanTracer, TimeSeriesStore,
                                     lockcheck, router as prouter,
                                     tracing, verify_integrity, xfer)
from torch_witness import port_witness  # noqa: F401

VOCAB, D_MODEL, N_HEADS, N_LAYERS, MAX_LEN, PAGE, SLOTS = \
    32, 32, 2, 2, 48, 8, 2
#: span attributes that are durations, not discrete facts
TIMED = ("wait_s", "quiesce_s")


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
        prng.RandomGenerator("init", 28), VOCAB, d_model=D_MODEL,
        n_heads=N_HEADS, n_layers=N_LAYERS, max_len=MAX_LEN)


def _greedy(host, prompts, n_new):
    """The reference's greedy continuations (its ``generate``)."""
    return [[int(t) for t in numpy.asarray(JT.generate(
        host, jnp.asarray([p], jnp.int32), n_new, N_HEADS,
        temperature=0.0, max_len=MAX_LEN))[0][len(p):]] for p in prompts]


def _port_fleet(host, n=2, plans=(), tracer=None, tag="rs", slots=SLOTS):
    """``n`` port engines on the CPU, replica ``i`` armed with
    ``plans[i]`` (when given) and its metrics a ``{replica="i"}`` row."""
    params = TT.params_from_jax(host, "cpu")
    return [LMEngine(params, N_HEADS, MAX_LEN, slots=slots,
                     prefill_chunk=PAGE, device="cpu",
                     name="%s_r%d" % (tag, i),
                     metrics=ServingMetrics(tag, labels={"replica": str(i)}),
                     faults=plans[i] if i < len(plans) else None,
                     tracer=tracer)
            for i in range(n)]


def _mutant(func, old, new):
    """A copy of ``func`` (a method of the port's router module) whose
    source has ``old`` replaced by ``new`` — a planted fault."""
    src = textwrap.dedent(inspect.getsource(func))
    assert src.count(old) == 1, old
    scope = {}
    exec(compile(src.replace(old, new), "<planted %s>" % func.__name__,
                 "exec"), vars(prouter), scope)
    return scope[func.__name__]


def _wait(cond, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


def _quiet(router):
    _wait(lambda: not router._jobs and all(
        e.metrics.gauge("slots_busy", 0) == 0
        and e.metrics.gauge("queue_depth", 0) == 0
        for e in router.replicas), "the fleet never went quiet")


# ------------------------------------------------------------- (a) retry
def test_retry_replaces_faulted_request_on_other_replica(host):
    """An engine FAULT on a live replica re-places the request whole on
    the other replica (``requests_retried`` metered) with greedy tokens;
    with BOTH replicas faulting the budget runs out and the client sees
    the injected fault after exactly ``retries`` more re-places."""
    plan = FaultPlan().arm("engine.step", times=20)
    replicas = _port_fleet(host, plans=[plan], tag="rty")
    router = Router(replicas, retries=2, retry_backoff_s=0.01).start()
    [want] = _greedy(host, [[1, 2, 3]], 6)
    try:
        fut = router.submit([1, 2, 3], 6)
        assert [int(t) for t in fut.result(timeout=60)] == want
        assert fut.job.replica == 1          # served by the healthy one
        retried = router.metrics.counter("requests_retried")
        assert retried >= 1
        replicas[1]._faults = FaultPlan().arm("engine.step", times=100)
        fut = router.submit([1, 2, 3], 6)
        with pytest.raises(InjectedFault):
            fut.result(timeout=60)
        assert router.metrics.counter("requests_retried") == retried + 2
        assert fut.job.retries == 2
        _quiet(router)
        assert router.metrics.responses == 1
    finally:
        router.stop()


# ---------------------------------------------- (b) the backoff delays
class _CapturedTimer:
    """``threading.Timer`` stand-in: records the delay, never runs."""

    made = []

    def __init__(self, delay, func, args=()):
        self.delay, self.func, self.args = delay, func, args
        self.daemon = False
        _CapturedTimer.made.append(self)

    def start(self):
        pass

    def cancel(self):
        pass

    def is_alive(self):
        return False


def _stub(metrics_cls, i):
    return SimpleNamespace(
        metrics=metrics_cls("stub", labels={"replica": str(i)}), spec_k=0,
        max_len=MAX_LEN, weights_version=0)


def _delays(module, metrics_cls, seed, base, cap):
    """Twenty retries, four jobs in a fixed interleaving: the captured
    delays and ``requests_retried``."""
    _CapturedTimer.made = []
    router = module.Router([_stub(metrics_cls, i) for i in range(2)],
                           retries=8, retry_backoff_s=base,
                           retry_backoff_cap_s=cap, seed=seed)
    jobs = [module._Job([1, 2, 3], 4) for _ in range(4)]
    for n in range(20):
        job = jobs[(n * 3) % 4 if n % 5 else n % 4]
        router._schedule_retry(job, RuntimeError("fault"), exclude={0})
    return ([t.delay for t in _CapturedTimer.made],
            router.metrics.counter("requests_retried"))


@pytest.mark.parametrize("seed,base,cap", [(0, 0.05, 2.0), (7, 0.01, 0.1),
                                           (123, 0.3, 1.0)])
def test_backoff_delays_equal_the_reference(monkeypatch, seed, base, cap):
    monkeypatch.setattr(threading, "Timer", _CapturedTimer)
    want = _delays(jrouter, JaxServingMetrics, seed, base, cap)
    got = _delays(prouter, ServingMetrics, seed, base, cap)
    assert got == want
    delays, retried = got
    assert retried == 20 and len(delays) == 20
    assert max(delays) <= 1.5 * cap and min(delays) >= base


# ------------------------------------------------------------- (c) hedge
def test_hedge_wins_on_slow_replica(host):
    """A request stuck on the injected-latency replica hedges onto the
    fast one past the threshold; the hedge wins, the output stays
    greedy, and the loser is cancelled, never delivered; both pools are
    sound once the fleet is quiet."""
    plan = FaultPlan().arm("engine.step", kind="latency", latency_s=0.2)
    replicas = _port_fleet(host, plans=[plan], tag="hdg")
    router = Router(replicas, hedge_after_s=0.15).start()
    settled = []
    done = router._on_attempt_done
    router._on_attempt_done = lambda att, f: (settled.append(att),
                                              done(att, f))
    delivered = []
    deliver = router._deliver
    router._deliver = lambda job, att, result: (delivered.append(att),
                                                deliver(job, att, result))
    prompts = [[1, 2, 3], [2, 4, 6]]
    want = _greedy(host, prompts, 6)
    try:
        futures = [router.submit(p, 6) for p in prompts]
        for f, w in zip(futures, want):
            assert [int(t) for t in f.result(timeout=60)] == w
        m = router.metrics
        assert m.counter("requests_hedged") >= 1
        assert m.counter("hedge_wins") >= 1
        _quiet(router)
        assert m.responses == 2
        jobs = [f.job for f in futures]
        assert sorted(id(a.job) for a in delivered) \
            == sorted(id(j) for j in jobs)             # once each
        losers = [a for a in settled if a not in delivered]
        assert losers and all(a.engine_future.request.cancelled
                              for a in losers)
        for e in replicas:
            e.verify_pool_invariants()
    finally:
        plan.release()
        router.stop()


def test_dynamic_hedge_threshold_equals_the_reference():
    """``hedge_after_s < 0``: None until 8 responses, then
    ``max(0.02, 1.5 × p95)`` of the live latencies — equal to the
    reference's response by response."""
    latencies = numpy.random.RandomState(28).exponential(0.03, 40)
    out = []
    for module, metrics_cls in ((jrouter, JaxServingMetrics),
                                (prouter, ServingMetrics)):
        router = module.Router([_stub(metrics_cls, i) for i in range(2)],
                               hedge_after_s=-1.0)
        row = [router._hedge_threshold()]
        for s in latencies:
            router.metrics.record_response(float(s))
            row.append(router._hedge_threshold())
        out.append(row)
    assert out[1] == out[0]
    assert out[1][:8] == [None] * 8 and out[1][8] is not None
    assert min(t for t in out[1] if t is not None) >= 0.02
    fixed = Router([_stub(ServingMetrics, 0)], hedge_after_s=0.4)
    assert fixed._hedge_threshold() == 0.4


# ---------------------------------------------- (d) the state machine
class _StubEngine:
    """A replica whose progress counters, load gauges and probe outcomes
    are scripted: ``outcome`` "ok", "raise" (submit raises) or "error"
    (the future fails)."""

    def __init__(self, metrics_cls, i, exc_cls):
        self.metrics = metrics_cls("hs", labels={"replica": str(i)})
        self.spec_k, self.max_len, self.weights_version = 0, MAX_LEN, 0
        self.outcome = "ok"
        self.exc_cls = exc_cls
        self.cancelled = 0

    def submit(self, prompt, n_new):
        if self.outcome == "raise":
            raise self.exc_cls("probe refused")
        f = Future()
        f.request = SimpleNamespace()
        if self.outcome == "error":
            f.set_exception(self.exc_cls("probe failed"))
        else:
            f.set_result(numpy.zeros(n_new, numpy.int32))
        return f

    def _cancel(self, req):
        self.cancelled += 1


#: (now, per replica (busy, progress advanced, probe outcome), operator
#: action) — replica 0 walks the whole circuit, replica 1 stalls while
#: busy, replica 2 is drained by hand at step 4 and left alone
SCRIPT = [
    (0.0, [(0, 0, "ok"), (1, 1, "ok"), (0, 0, "ok")], None),
    (0.5, [(0, 0, "error"), (1, 0, "ok"), (0, 0, "ok")], None),
    (1.0, [(0, 0, "raise"), (1, 0, "ok"), (0, 0, "ok")], None),
    (1.5, [(0, 0, "ok"), (1, 0, "ok"), (0, 0, "ok")], None),
    (2.0, [(0, 0, "error"), (1, 1, "ok"), (0, 0, "error")], "drain2"),
    (2.5, [(0, 0, "error"), (1, 0, "ok"), (0, 0, "error")], None),
    (3.0, [(0, 0, "error"), (0, 0, "ok"), (0, 0, "error")], None),
    (3.6, [(0, 0, "error"), (0, 0, "ok"), (0, 0, "error")], None),
    (4.5, [(0, 0, "error"), (0, 0, "ok"), (0, 0, "error")], None),
    (6.0, [(0, 0, "error"), (0, 0, "ok"), (0, 0, "error")], None),
    (8.0, [(0, 0, "error"), (0, 0, "ok"), (0, 0, "error")], None),
    (10.5, [(0, 0, "raise"), (0, 0, "ok"), (0, 0, "error")], None),
    (13.0, [(0, 0, "error"), (0, 0, "ok"), (0, 0, "error")], None),
    (17.0, [(0, 0, "ok"), (0, 0, "ok"), (0, 0, "error")], None),
    (17.5, [(0, 0, "ok"), (0, 0, "ok"), (0, 0, "ok")], None),
    (18.0, [(0, 0, "error"), (0, 0, "ok"), (0, 0, "ok")], None),
]
CIRCUIT_COUNTERS = ("circuit_open_total", "health_probes",
                    "health_probe_failures", "health_probe_warmups",
                    "replica_drains")


def _circuit(module, metrics_cls, exc_cls, checker_cls=None):
    """Drive ``SCRIPT`` through a stub fleet of ``module``: one row of
    (states, gauges, counters, live) per step."""
    engines = [_StubEngine(metrics_cls, i, exc_cls) for i in range(3)]
    router = module.Router(engines)
    checker = (checker_cls or module.HealthChecker)(
        router, fail_threshold=2, cooldown_s=1.0, cooldown_cap_s=4.0,
        stall_s=0.7, probe_timeout_s=0.1)
    checker.warm_probes()
    rows = []
    progress = 0
    for now, per, action in SCRIPT:
        if action == "drain2":
            router.unregister(2, reason="operator")
        for e, (busy, advanced, outcome) in zip(engines, per):
            e.metrics.set_gauge("slots_busy", busy)
            e.metrics.set_gauge("queue_depth", 0)
            if advanced:
                progress += 1
                e.metrics.inc("tokens_out")
            e.outcome = outcome
        checker.step(now=now)
        snap = router.metrics.snapshot()
        rows.append((checker.states(),
                     {k: v for k, v in snap["gauges"].items()
                      if k.startswith("replica_health_state")},
                     [router.metrics.counter(c) for c in CIRCUIT_COUNTERS],
                     list(router._live), list(checker._cooldown)))
    return rows


def test_health_state_machine_equals_the_reference():
    want = _circuit(jrouter, JaxServingMetrics, JaxInjectedFault)
    got = _circuit(prouter, ServingMetrics, InjectedFault)
    for n, (g, w) in enumerate(zip(got, want)):
        assert g == w, "step %d (now %.1f)" % (n, SCRIPT[n][0])
    states = [r[0][0] for r in got]
    o, h, c = HealthChecker.OPEN, HealthChecker.HALF_OPEN, \
        HealthChecker.HEALTHY
    # replica 0: opened, re-opened with the cooldown doubled to the cap,
    # and re-registered by a half-open success
    assert o in states and states[-1] == c and h not in states
    assert max(r[4][0] for r in got) == 4.0
    # four openings of replica 0, one of replica 1 (stalled while busy,
    # re-registered by its first half-open probe)
    assert got[-1][2][0] == 5                  # circuit_open_total
    assert got[-1][3] == [True, True, False]
    assert [r[3][1] for r in got][3:5] == [False, False]
    # the operator-drained replica 2 stays HEALTHY, never probed again
    assert all(r[0][2] == c for r in got)


def test_planted_half_open_without_doubling_is_caught():
    planted = type("Planted", (HealthChecker,), {
        "_half_open_probe": _mutant(
            HealthChecker._half_open_probe,
            "2 * self._cooldown[i]", "self._cooldown[i]")})
    want = _circuit(jrouter, JaxServingMetrics, JaxInjectedFault)
    assert _circuit(prouter, ServingMetrics, InjectedFault,
                    checker_cls=planted) != want


# -------------------------------------- (e) quarantine and recovery
def test_health_checker_quarantines_and_recovers(host):
    """The full circuit-breaker cycle, driven synchronously: a frozen
    replica is quarantined through the drain (its pending work completes
    on the survivor, once and whole), and after the release and the
    cooldown the half-open probe re-registers it and it serves again."""
    plan = FaultPlan().arm("engine.tick", kind="freeze", after=2, times=1,
                           duration_s=60.0)
    replicas = _port_fleet(host, plans=[plan], tag="hcq")
    router = Router(replicas, drain_timeout_s=0.3).start()
    checker = HealthChecker(router, interval_s=0.05, probe_timeout_s=2.0,
                            fail_threshold=2, cooldown_s=0.2, stall_s=0.25)
    prompts = [[1 + i, 2, 3] for i in range(6)]
    want = _greedy(host, prompts, 6)
    try:
        futures = [router.submit(p, 6) for p in prompts]
        deadline = time.monotonic() + 30
        while router._live[0] and time.monotonic() < deadline:
            checker.step()
            time.sleep(0.05)
        assert not router._live[0]                # quarantined
        assert checker.states()[0] == HealthChecker.OPEN
        assert router.metrics.counter("circuit_open_total") == 1
        for f, w in zip(futures, want):            # no loss, no wedge
            assert [int(t) for t in f.result(timeout=60)] == w
        assert router.metrics.responses == len(prompts)
        plan.release()
        time.sleep(0.25)
        deadline = time.monotonic() + 30
        while not router._live[0] and time.monotonic() < deadline:
            checker.step()
            time.sleep(0.05)
        assert router._live[0]
        assert checker.states()[0] == HealthChecker.HEALTHY
        snap = router.metrics.snapshot()
        assert snap["gauges"]['replica_health_state{replica="0"}'] == 0
        with router._lock:
            router._routed[1] += 10               # the tiebreak picks 0
        again = router.submit([1, 2, 3], 4)
        assert len(again.result(timeout=60)) == 4
        assert again.job.replica == 0             # it serves again
        _quiet(router)
        assert router.metrics.responses == len(prompts) + 1
        for e in replicas:
            e.verify_pool_invariants()
    finally:
        plan.release()
        checker.stop()
        router.stop()


# ------------------------------------------------------ (f) SLO hooks
def test_page_feeds_health_checker_not_fleet_wide(host):
    """A paging REPLICA source counts toward quarantine; a fleet-wide
    burn (every source paging) is never fed."""
    params = TT.params_from_jax(host, "cpu")
    replicas = [LMEngine(params, N_HEADS, MAX_LEN, slots=1, device="cpu",
                         name="slo_hc%d" % i,
                         metrics=ServingMetrics("slo_hc",
                                                labels={"replica": str(i)}))
                for i in range(2)]
    router = Router(replicas).start()
    checker = HealthChecker(router, fail_threshold=2, cooldown_s=600.0)
    try:
        store = TimeSeriesStore(interval_s=0.05, capacity=64)
        keys = []
        for i, e in enumerate(replicas):
            store.add_source(e.metrics, key="r%d" % i)
            keys.append("r%d" % i)
        mon = SLOMonitor(store, [Objective("avail", "availability", 0.9)],
                         windows_s=(60.0, 300.0), min_events=1,
                         checker=checker,
                         source_replicas={k: i for i, k in enumerate(keys)})
        store.add_listener(mon.sample_once)
        store.sample_once()
        for e in replicas:                     # fleet-wide: no quarantine
            for _ in range(10):
                e.metrics.record_error()
        store.sample_once()
        assert mon.state("r0", "avail") == 2
        assert mon.state("r1", "avail") == 2
        assert router._live == [True, True]
        time.sleep(0.05)
        for _ in range(200):
            replicas[1].metrics.record_response(0.001)
        for _ in range(20):
            replicas[0].metrics.record_error()
        store.sample_once()
        assert mon.state("r1", "avail") in (0, 1)
        store.sample_once()
        assert router._live[0] is False
        assert checker.states()[0] == checker.OPEN
        assert router._live[1] is True
        assert router.metrics.counter("slo_page_signals") == 2
    finally:
        checker.stop()
        router.stop()


def _page_streak(checker_cls):
    """The reference's page-streak script on a stub fleet whose probes
    succeed: (replica 0 opened after page, probe scan, page; replica 1
    still healthy after page, ok, page)."""
    engines = [_StubEngine(ServingMetrics, i, InjectedFault)
               for i in range(2)]
    router = Router(engines)
    checker = checker_cls(router, fail_threshold=2, cooldown_s=600.0)
    checker.warm_probes()
    checker.note_slo_page(0, reason="burning")
    checker.step()                       # a full probe scan succeeds
    assert checker.states()[0] == checker.HEALTHY
    checker.note_slo_page(0, reason="still burning")
    opened = checker.states()[0] == checker.OPEN
    checker.note_slo_page(1, reason="blip")
    checker.note_slo_ok(1)
    checker.note_slo_page(1, reason="later blip")
    return opened, checker.states()[1] == checker.HEALTHY


def test_page_streak_survives_successful_probes(host):
    """A slow-but-RESPONSIVE replica keeps answering the probes; those
    successes reset the probe fail count but not the SLO page streak —
    ``note_slo_ok`` does.  An operator drain is left alone."""
    params = TT.params_from_jax(host, "cpu")
    replicas = [LMEngine(params, N_HEADS, MAX_LEN, slots=1, device="cpu",
                         name="slo_pr%d" % i,
                         metrics=ServingMetrics("slo_pr%d" % i))
                for i in range(2)]
    router = Router(replicas).start()
    checker = HealthChecker(router, fail_threshold=2, cooldown_s=600.0)
    try:
        checker.warm_probes()
        checker.note_slo_page(0, reason="burning")
        checker.step()
        assert checker.states()[0] == checker.HEALTHY
        checker.note_slo_page(0, reason="still burning")
        assert checker.states()[0] == checker.OPEN
        assert router._live[0] is False
        checker.note_slo_page(1, reason="blip")
        checker.note_slo_ok(1)
        checker.note_slo_page(1, reason="later blip")
        assert checker.states()[1] == checker.HEALTHY
        router.unregister(1, reason="operator")
        checker.note_slo_page(1, reason="test")
        assert checker.states()[1] == checker.HEALTHY
        checker.note_slo_page(0, reason="already open")  # no-op
        assert checker.states()[0] == checker.OPEN
        with pytest.raises(ValueError):
            checker.note_slo_page(7)
    finally:
        checker.stop()
        router.stop()
    assert _page_streak(HealthChecker) == (True, True)


def test_planted_probe_resetting_the_page_streak_is_caught():
    planted = type("Planted", (HealthChecker,), {"step": _mutant(
        HealthChecker.step, "self._fails[i] = 0\n",
        "self._fails[i] = 0\n                "
        "self._slo_fails[i] = 0\n")})
    assert _page_streak(planted)[0] is False


def test_monitor_and_concurrent_step_open_the_circuit_once():
    """Twenty races: the SLO monitor's paging scan (telemetry thread)
    and a failing probe scan (prober thread) both reach the threshold at
    once; the quarantine is claimed once — one circuit opening, one
    drain."""
    for trial in range(20):
        engines = [_StubEngine(ServingMetrics, i, InjectedFault)
                   for i in range(2)]
        router = Router(engines)
        checker = HealthChecker(router, fail_threshold=2, cooldown_s=600.0)
        store = TimeSeriesStore(interval_s=0.05, capacity=64)
        for i, e in enumerate(engines):
            store.add_source(e.metrics, key="r%d" % i)
        mon = SLOMonitor(store, [Objective("avail", "availability", 0.9)],
                         windows_s=(60.0, 300.0), min_events=1,
                         checker=checker, source_replicas={"r0": 0, "r1": 1})
        store.add_listener(mon.sample_once)
        store.sample_once()
        for _ in range(200):
            engines[1].metrics.record_response(0.001)
        for _ in range(20):
            engines[0].metrics.record_error()
        store.sample_once()                    # streak 1 of 2
        assert checker._slo_fails[0] == 1
        engines[0].outcome = "error"
        with checker._lock:
            checker._fails[0] = 1              # one failed probe behind
        go = threading.Barrier(2)

        def scan():
            go.wait()
            store.sample_once()

        def probe():
            go.wait()
            checker.step()

        threads = [threading.Thread(target=t) for t in (scan, probe)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert checker.states()[0] == checker.OPEN, trial
        assert router.metrics.counter("circuit_open_total") == 1, trial
        assert router.metrics.counter("replica_drains") == 1, trial
        assert router._live == [False, True]


# ---------------------------------------------- (g), (h) the script
def _discrete(spans, relative_dids=False):
    """Each span's (name, cat, attributes): durations dropped, the
    backend's presence kept, dispatch ids as their rank in the record."""
    dids = sorted({s["attrs"]["did"] for s in spans if "did" in s["attrs"]})
    out = []
    for s in spans:
        attrs = {k: v for k, v in s["attrs"].items() if k not in TIMED}
        if "backend" in attrs:
            attrs["backend"] = "<route>"
        if relative_dids and "did" in attrs:
            attrs["did"] = dids.index(attrs["did"])
        out.append((s["name"], s["cat"], attrs))
    return out


RETRY_PROMPTS = ([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], [2, 4, 6, 8])


def _script(make, plan, router_cls, checker_cls, metrics_cls, tracer):
    """Sequential traffic through a started two-replica fleet (``make``
    builds it, replica 0 armed with ``plan``): the first prompt's first
    chunk faults on replica 0 and is retried on replica 1, the second is
    served by replica 0; then a health checker opens replica 0's circuit
    on two SLO pages and its half-open probe re-registers it, and one
    more request is served.  Returns what the fleet left."""
    plan.arm("engine.chunk", kind="error", calls={1})
    router = router_cls(make(tracer), metrics=metrics_cls("rs_router"),
                        retries=2, retry_backoff_s=0.01,
                        tracer=tracer).start()
    checker = checker_cls(router, fail_threshold=2, cooldown_s=0.05,
                          probe_timeout_s=30.0)
    outs, stamps = [], []
    try:
        for p in RETRY_PROMPTS:
            f = router.submit(p, 8)
            outs.append([int(t) for t in f.result(timeout=120)])
            stamps.append(f.job.replica)
            _quiet(router)
        checker.warm_probes()
        checker.step()
        checker.note_slo_page(0, reason="script")
        checker.note_slo_page(0, reason="script")
        live_open = list(router._live)
        checker.step(now=time.monotonic() + 1.0)
        _quiet(router)
        f = router.submit([3, 5, 7], 4)
        outs.append([int(t) for t in f.result(timeout=120)])
        stamps.append(f.job.replica)
    finally:
        checker.stop()
        router.stop()
    snap = router.metrics.snapshot()
    return {"outs": outs, "stamps": stamps, "live_open": live_open,
            "states": checker.states(), "live": list(router._live),
            "counters": snap["counters"], "gauges": snap["gauges"],
            "records": tracer.requests()}


@pytest.fixture(scope="module")
def script(host):
    """The script through the reference fleet under the reference's
    witness and through the port fleet under the port's: (port,
    reference, port witness report, reference witness report)."""

    def reference(tracer):
        return [JaxLMEngine(host, N_HEADS, MAX_LEN, slots=SLOTS,
                            prefill_chunk=PAGE, paged_kv=True,
                            name="rs_r%d" % i, tracer=tracer,
                            faults=jplan if i == 0 else None,
                            metrics=JaxServingMetrics(
                                "rs", labels={"replica": str(i)}))
                for i in range(2)]

    jplan = JaxFaultPlan(seed=0)
    want_w = jlockcheck.LockOrderWitness(name="reference_resilience")
    jlockcheck.arm(want_w)
    try:
        want = _script(reference, jplan, jrouter.Router,
                       jrouter.HealthChecker, jrouter.RouterMetrics,
                       jtracing.SpanTracer(mode="all", last=64))
    finally:
        jlockcheck.disarm()
    plan = FaultPlan(seed=0)
    got_w = lockcheck.LockOrderWitness(name="port_resilience")
    lockcheck.arm(got_w)
    xfer.arm("disallow")
    try:
        got = _script(lambda tracer: _port_fleet(host, plans=[plan],
                                                 tracer=tracer, tag="rs"),
                      plan, Router, HealthChecker, RouterMetrics,
                      SpanTracer(mode="all", last=64))
    finally:
        xfer.disarm()
        lockcheck.disarm()
    return got, want, got_w.report(), want_w.report()


def test_script_equals_the_reference(script, host):
    got, want, _, _ = script
    assert got["outs"] == want["outs"]
    assert got["outs"][:2] == _greedy(host, RETRY_PROMPTS, 8)
    assert got["stamps"] == want["stamps"] == [1, 0, 1]
    assert got["live_open"] == want["live_open"] == [False, True]
    assert got["live"] == want["live"] == [True, True]
    assert got["states"] == want["states"] == [HealthChecker.HEALTHY] * 2
    assert got["counters"] == want["counters"]
    assert got["counters"]["requests_retried"] == 1
    assert got["counters"]["circuit_open_total"] == 1
    assert got["gauges"] == want["gauges"]


def test_retry_span_sequences_equal_the_reference(script):
    """The retried request's ONE trace shows the errored attempt, the
    retry marker and the winning attempt with the engine spans nested
    under it — every request's sequence equal to the reference's."""
    got, want, _, _ = script
    port = {r["rid"]: r for r in got["records"]}
    ref = {r["rid"]: r for r in want["records"]}
    assert sorted(port) == sorted(ref)
    for rid in sorted(ref):
        assert _discrete(port[rid]["spans"], True) \
            == _discrete(ref[rid]["spans"], True), rid
        assert port[rid]["error"] == ref[rid]["error"]
    retried = [r for r in got["records"]
               if sum(s["name"] == "attempt" for s in r["spans"]) > 1]
    assert len(retried) == 1
    spans = retried[0]["spans"]
    attempts = [s for s in spans if s["name"] == "attempt"]
    assert any("error" in s["attrs"] for s in attempts)
    winner = next(s for s in attempts if s["attrs"].get("outcome") == "ok")
    assert winner["attrs"]["retry"] == 1
    assert any(s["name"] == "queue.wait" and s["parent"] == winner["sid"]
               for s in spans)
    assert any(s["name"] == "retry.backoff" for s in spans)
    assert verify_integrity(got["records"])["requests"] == len(port)
    assert jtracing.verify_integrity(got["records"])["requests"] == len(port)


def test_lock_edge_graph_equals_the_reference(script):
    _, _, got_r, want_r = script
    assert got_r["violations"] == [] and want_r["violations"] == [], \
        "\n\n".join(got_r["violations"] + want_r["violations"])
    assert got_r["edges"] == want_r["edges"]
    assert got_r["acquisitions"] > 0


def test_hedge_loser_spans_closed_under_upstream_root(host):
    """An upstream-owned (HTTP-shaped) root seals the trace the moment
    the handler returns — the hedge loser's attempt span is already
    closed (outcome hedge-lost), never flagged unclosed."""
    prompts = [[1, 2, 3, 4, 5, 6], [2, 4, 6, 8]]
    want = _greedy(host, prompts, 8)
    plan = FaultPlan(seed=0).arm("engine.step", kind="latency",
                                 latency_s=0.15)
    tracer = SpanTracer(mode="all", last=16)
    replicas = _port_fleet(host, plans=[plan], tracer=tracer, tag="hdl")
    router = Router(replicas, hedge_after_s=0.25, tracer=tracer).start()
    recs = []
    try:
        for p, w in zip(prompts, want):
            root = tracer.start_request(rid="up-%d" % len(recs),
                                        name="http.request", cat="http")
            with tracing.use(root):
                fut = router.submit(p, 8)
            out = fut.result(timeout=120)
            recs.append(tracer.finish_request(root))
            assert [int(t) for t in out] == w
        _quiet(router)
    finally:
        plan.release()
        router.stop()
    assert router.metrics.counter("requests_hedged") >= 1
    verify_integrity(recs)
    jtracing.verify_integrity(recs)
    lost = [s for r in recs for s in r["spans"]
            if s["attrs"].get("outcome") == "hedge-lost"]
    assert lost, "no hedge-lost attempt recorded"


# --------------------------------------------- (i) the other plantings
class _PendingEngine:
    """A stub replica whose futures the test resolves by hand."""

    def __init__(self, i):
        self.metrics = ServingMetrics("pe", labels={"replica": str(i)})
        self.spec_k, self.max_len, self.weights_version = 0, MAX_LEN, 0
        self.futures = []
        self.cancelled = []

    def submit(self, prompt, n_new):
        f = Future()
        f.request = SimpleNamespace(tspan=None)
        f.version = len(self.futures)
        self.futures.append(f)
        return f

    def _cancel(self, req):
        self.cancelled.append(req)


def _retry_targets(monkeypatch):
    """Replica 0 is the placement's first choice (replica 1 has more
    routed); its attempt faults and the retry must go to replica 1."""
    monkeypatch.setattr(threading, "Timer", _CapturedTimer)
    _CapturedTimer.made = []
    engines = [_PendingEngine(i) for i in range(2)]
    router = Router(engines, retries=1)
    router._routed = [0, 5]
    fut = router.submit([1, 2, 3], 2)
    engines[0].futures[0].set_exception(InjectedFault("step"))
    [timer] = _CapturedTimer.made
    timer.func(*timer.args)
    targets = [len(e.futures) for e in engines]
    for e in engines:
        for f in e.futures:
            if not f.done():
                f.set_result(numpy.zeros(2, numpy.int32))
    return targets, fut.job.replica


def test_retry_avoids_the_faulted_replica(monkeypatch):
    assert _retry_targets(monkeypatch) == ([1, 1], 1)


def test_planted_retry_ignoring_exclude_is_caught(monkeypatch):
    monkeypatch.setattr(Router, "_place", _mutant(
        Router._place, "    if exclude:\n", "    if False:\n"))
    assert _retry_targets(monkeypatch) != ([1, 1], 1)


def _stamps_after_race(router_cls=Router):
    """Primary on replica 0, hedge on replica 1; the hedge delivers
    first and the primary reaches ``_deliver`` in the same window (both
    passed the done check): the winner's stamps must hold."""
    engines = [_PendingEngine(i) for i in range(2)]
    router = router_cls(engines)
    fut = router.submit([1, 2, 3], 2)
    job = fut.job
    assert router._place(job, exclude={0}, hedge=True)
    [primary] = [a for a in job.live if not a.is_hedge]
    [hedge] = [a for a in job.live if a.is_hedge]
    engines[1].futures[0].set_result(numpy.ones(2, numpy.int32))
    router._deliver(job, primary, numpy.zeros(2, numpy.int32))
    return (job.replica, fut.result().tolist(),
            router.metrics.counter("hedge_wins"),
            [len(e.cancelled) for e in engines])


def test_hedge_loser_never_overwrites_the_winner():
    assert _stamps_after_race() == (1, [1, 1], 1, [1, 0])


def test_planted_loser_overwriting_stamps_is_caught(monkeypatch):
    monkeypatch.setattr(Router, "_deliver", _mutant(
        Router._deliver, "if job.delivered or job.future.done():",
        "if job.future.cancelled():"))
    assert _stamps_after_race()[0] != 1


# ------------------------------------------- sampled retries (a finding)
def test_sampled_retry_draws_under_the_serving_replicas_admission_id(host):
    """A sampled request's draw is keyed by ``sample_seed`` and the
    admission id of the engine that serves it.  A retry re-places it on
    another replica, which admits it under its own counter: the tokens
    equal a fault-free first attempt's only when both counters agree.
    Here replica 1 has admitted one request more than replica 0, so the
    retried request draws other tokens (a valid sample, not the same
    one); retries and hedges are idempotent for greedy replicas only."""
    params = TT.params_from_jax(host, "cpu")
    knobs = dict(slots=SLOTS, prefill_chunk=PAGE, device="cpu",
                 temperature=0.8, top_k=8, sample_seed=123)
    prompt = [1, 2, 3]
    alone = LMEngine(params, N_HEADS, MAX_LEN, name="smp_alone",
                     **knobs).start()
    try:
        first = [int(t) for t in alone.submit(prompt, 12).result(timeout=60)]
        second = [int(t) for t in alone.submit(prompt, 12).result(
            timeout=60)]
    finally:
        alone.stop()
    assert first != second                  # admission ids 0 and 1 differ
    plan = FaultPlan().arm("engine.step", times=1)
    replicas = [LMEngine(params, N_HEADS, MAX_LEN, name="smp_r%d" % i,
                         faults=plan if i == 0 else None,
                         metrics=ServingMetrics(
                             "smp", labels={"replica": str(i)}), **knobs)
                for i in range(2)]
    router = Router(replicas, retries=1, retry_backoff_s=0.01).start()
    try:
        replicas[1].submit([5, 5], 2).result(timeout=60)   # its id 0
        with router._lock:
            router._routed = [0, 1]           # replica 0 first
        f = router.submit(prompt, 12)
        got = [int(t) for t in f.result(timeout=60)]
    finally:
        router.stop()
    assert f.job.replica == 1 and f.job.retries == 1
    assert got == second and got != first
