"""The port's serving fleet (``veles_tpu_torch/serving/router.py``) against
the reference's ``veles_tpu/serving/router.py`` on the CPU.

Tiny engines (vocab 32, d_model 32, 2 heads, 2 layers, max_len 48, page
8, 2 slots; weights from one seeded numpy stream, which each port engine
carries across with ``params_from_jax``), every case under the port's
lock-order witness and armed transfer guard (``tests/torch_witness.py``):

- (a) placement: ``_order`` over 200 seeded stub fleets (2–4 replicas
  whose ``ServingMetrics`` gauges and EWMAs are set identically on both
  sides, some replicas drained, both policies, the round-robin counter
  advanced the same) gives EQUAL orders, and ``NoLiveReplicas`` when
  none is live;
- (b) ``replica_device_slices`` on placeholder devices: the same
  mapping, and the same ``tp`` error, as the reference;
- (c) ``Router([engine])`` gives the bare engine's tokens and its
  ``Overloaded``;
- (d) a sequential script (each request resolved before the next is
  submitted, so every placement score is 0 and the fewest-routed
  tiebreak alternates) on two replicas, traced, through ONE reference
  fleet under the reference's witness and one port fleet under the
  port's: tokens, replica stamps, ``routed_counts`` and the router's
  counters and gauges EQUAL; (h) each request's span ``(name, cat,
  attributes)`` sequence EQUAL and sound; (i) the role edge graphs
  EQUAL;
- (e) every replica refusing: both packages raise with the MINIMUM
  ``retry_after``; ``NoLiveReplicas`` after every replica is drained
  has the reference's message and ``retry_after``;
- (f) a drain mid-decode (replica 0 slowed by a ``latency`` plan):
  every request completes once, whole, with the reference fleet's
  tokens, and later placements avoid the drained replica; a burst on an
  idle fleet splits within the reference's bound; round robin splits
  evenly;
- (g) a wedged drain (replica 0 frozen mid-decode by a ``freeze``
  plan): force re-placed after ``drain_timeout_s``, the zombie's late
  result ignored;
- (j) three planted faults, each a mutated copy of one router method,
  caught by the checks above: an ``_order`` that keeps a drained
  replica, a completion path that delivers a drained attempt's short
  result, a ``Retry-After`` taken from the last refusal.

Retries, hedging and the health checker (``TestResilience``) are held
against the reference in ``tests/test_torch_resilience.py``.  Left to
ROADMAP Queue 1 item 9(c): deploy (the fleet cases of
``TestWeightSwap``); ``deploy`` refuses naming its item.
"""

import inspect
import textwrap
import time
from types import SimpleNamespace

import numpy
import pytest
import torch

from veles_tpu.serving import lockcheck as jlockcheck
from veles_tpu.serving import router as jrouter
from veles_tpu.serving import tracing as jtracing
from veles_tpu.serving.batcher import Overloaded as JaxOverloaded
from veles_tpu.serving.lm_engine import LMEngine as JaxLMEngine
from veles_tpu.serving.metrics import ServingMetrics as JaxServingMetrics
from veles_tpu_torch import prng
from veles_tpu_torch.ops import transformer as TT
from veles_tpu_torch.serving import (FaultPlan, LMEngine, NoLiveReplicas,
                                     Overloaded, Router, RouterMetrics,
                                     ServingMetrics, SpanTracer, lockcheck,
                                     replica_device_slices, router as prouter,
                                     verify_integrity, xfer)
from torch_witness import port_witness  # noqa: F401

VOCAB, D_MODEL, N_HEADS, N_LAYERS, MAX_LEN, PAGE, SLOTS = \
    32, 32, 2, 2, 48, 8, 2
#: the sequential script: 8 prompts, N_NEW tokens each
PROMPTS = [[1 + i % 7, 3, 5] + [i % 5 + 2] * (i % 4) for i in range(8)]
N_NEW = 6
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
        prng.RandomGenerator("init", 27), VOCAB, d_model=D_MODEL,
        n_heads=N_HEADS, n_layers=N_LAYERS, max_len=MAX_LEN)


def _port_fleet(host, n=2, plans=(), tracer=None, tag="rt"):
    """``n`` port engines on the CPU, replica ``i`` armed with
    ``plans[i]`` (when given) and its metrics a ``{replica="i"}`` row."""
    return [LMEngine(host, N_HEADS, MAX_LEN, slots=SLOTS, prefill_chunk=PAGE,
                     device="cpu", name="%s_r%d" % (tag, i),
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


# ------------------------------------------------------------- (a) orders
def _stub(metrics_cls, i, draw):
    m = metrics_cls("stub", labels={"replica": str(i)})
    queue, busy, total, free, step, ttft = draw
    m.set_gauge("queue_depth", queue)
    m.set_gauge("slots_busy", busy)
    if total:
        m.set_gauge("kv_pages_total", total)
        m.set_gauge("kv_pages_free", free)
    for s in step:
        m.record_decode_step(s)
    for s in ttft:
        m.record_ttft(s)
    return SimpleNamespace(metrics=m, spec_k=0, max_len=MAX_LEN,
                           weights_version=0)


def _fleet_draws(rng):
    n = int(rng.randint(2, 5))
    draws = []
    for _ in range(n):
        total = int(rng.choice([0, 12]))
        draws.append((int(rng.randint(0, 3)), int(rng.randint(0, 3)), total,
                      int(rng.randint(0, total + 1)),
                      [float(x) for x in rng.choice(
                          [0.001, 0.002, 0.004], rng.randint(0, 3))],
                      [float(x) for x in rng.choice(
                          [0.01, 0.03], rng.randint(0, 2))]))
    live = rng.rand(n) < 0.75
    routed = [int(x) for x in rng.randint(0, 3, n)]
    return draws, live, routed, int(rng.randint(0, 7))


def _orders(router_cls, metrics_cls, fleets, policy):
    out = []
    for draws, live, routed, rr in fleets:
        router = router_cls([_stub(metrics_cls, i, d)
                             for i, d in enumerate(draws)], policy=policy)
        router._live = [bool(x) for x in live]
        router._routed = list(routed)
        router._rr = rr
        got = []
        for _ in range(2):
            try:
                got.append(router._order())
            except (Overloaded, JaxOverloaded) as e:   # NoLiveReplicas
                got.append(type(e).__name__)
        out.append(got)
    return out


def _seeded_fleets(n=200):
    rng = numpy.random.RandomState(27)
    return [_fleet_draws(rng) for _ in range(n)]


@pytest.mark.parametrize("policy", ["metrics", "round_robin"])
def test_placement_orders_equal_the_reference(policy):
    fleets = _seeded_fleets()
    got = _orders(Router, ServingMetrics, fleets, policy)
    want = _orders(jrouter.Router, JaxServingMetrics, fleets, policy)
    assert got == want
    flat = [o for pair in got for o in pair]
    assert "NoLiveReplicas" in flat
    # the fleets exercise every tiebreak: some orders are not 0, 1, ...
    assert any(isinstance(o, list) and o != sorted(o) for o in flat)


def test_planted_order_keeping_a_drained_replica_is_caught(monkeypatch):
    monkeypatch.setattr(Router, "_order", _mutant(
        Router._order, "live = [i for i, ok in enumerate(self._live) if ok]",
        "live = list(range(len(self._live)))"))
    fleets = _seeded_fleets(50)
    assert _orders(Router, ServingMetrics, fleets, "metrics") \
        != _orders(jrouter.Router, JaxServingMetrics, fleets, "metrics")


# ------------------------------------------------------- (b) device slices
@pytest.mark.parametrize("n_dev", [1, 2, 3, 8])
def test_device_slices_equal_the_reference(n_dev):
    devices = ["dev%d" % k for k in range(n_dev)]
    for replicas in (0, 1, 2, 3, 4):
        for tp in (0, 1, 2, 3):
            try:
                want = jrouter.replica_device_slices(replicas, tp, devices)
            except ValueError as e:
                with pytest.raises(ValueError) as err:
                    replica_device_slices(replicas, tp, devices)
                assert str(err.value) == str(e)
                continue
            assert replica_device_slices(replicas, tp, devices) == want
    cpu = torch.device("cpu")
    assert replica_device_slices(2, 0, [cpu]) == [[cpu], [cpu]]


def test_device_slices_never_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        replica_device_slices(2, 0)


# --------------------------------------------------------- (c) one replica
def test_single_replica_is_the_bare_engine(host):
    """``Router([engine])``: the bare engine's tokens for the same
    prompts, and its ``Overloaded`` when its queue is full."""
    [bare] = _port_fleet(host, 1, tag="bare")
    bare.queue_depth = 2
    bare.start()
    try:
        want = [bare.submit(p, N_NEW).result(timeout=60)
                for p in PROMPTS[:3]]
        with bare._cond:         # the worker cannot pop the queue
            futures = [bare.submit(p, N_NEW) for p in PROMPTS[:2]]
            with pytest.raises(Overloaded) as err:
                bare.submit(PROMPTS[2], N_NEW)
        bare_ra = err.value.retry_after
        for f in futures:
            f.result(timeout=60)
    finally:
        bare.stop()
    [engine] = _port_fleet(host, 1, tag="one")
    engine.queue_depth = 2
    router = Router([engine]).start()
    try:
        got = [router.submit(p, N_NEW).result(timeout=60)
               for p in PROMPTS[:3]]
        for a, b in zip(got, want):
            numpy.testing.assert_array_equal(a, b)
        with engine._cond:
            futures = [router.submit(p, N_NEW) for p in PROMPTS[:2]]
            with pytest.raises(Overloaded) as err:
                router.submit(PROMPTS[2], N_NEW)
        assert type(err.value) is Overloaded
        assert err.value.retry_after == bare_ra
        for f in futures:
            assert f.job.replica == 0 and len(f.result(timeout=60)) == N_NEW
        snap = router.metrics.snapshot()
        assert snap["rejected"] == 1 and snap["requests"] == 5
        assert snap["counters"]['routed_requests{replica="0"}'] == 5
    finally:
        router.stop()


# ------------------------------------------------- (d), (h), (i) the script
def _sequential(router, prompts=PROMPTS):
    outs, stamps, versions = [], [], []
    for p in prompts:
        f = router.submit(p, N_NEW)
        outs.append([int(t) for t in f.result(timeout=120)])
        stamps.append(f.job.replica)
        versions.append(f.job.version)
    return outs, stamps, versions


def _script(make, router_cls, tracer):
    """The sequential script on a started two-replica fleet (``make``
    builds it), traced; returns what the router left (after stop)."""
    router = router_cls(make(tracer), metrics=RouterMetrics("rt_router")
                        if router_cls is Router
                        else jrouter.RouterMetrics("rt_router"),
                        tracer=tracer).start()
    try:
        outs, stamps, versions = _sequential(router)
        # a batch through generate, its rows at once, on the quiet fleet:
        # the first row takes the tiebreak, the second the idle replica
        _wait(lambda: all(e.metrics.gauge("slots_busy", 0) == 0
                          for e in router.replicas), "the fleet is busy")
        batch, reps = router.generate(
            numpy.asarray([[2, 4, 6], [3, 5, 7]], numpy.int32), N_NEW,
            return_replicas=True)
    finally:
        router.stop()
    snap = router.metrics.snapshot()
    return {"outs": outs, "stamps": stamps, "versions": versions,
            "batch": batch.tolist(), "batch_replicas": reps,
            "routed": router.routed_counts(), "counters": snap["counters"],
            "totals": [snap[k] for k in ("requests", "responses",
                                         "rejected", "shed", "errors")],
            "gauges": snap["gauges"],
            "replica_snapshots": len(snap.get("replicas", ())),
            "records": tracer.requests()}


@pytest.fixture(scope="module")
def script(host):
    """The script through the reference fleet under the reference's
    witness and through the port fleet under the port's: (port,
    reference, port witness report, reference witness report)."""

    def reference(tracer):
        return [JaxLMEngine(host, N_HEADS, MAX_LEN, slots=SLOTS,
                            prefill_chunk=PAGE, paged_kv=True,
                            name="rt_r%d" % i, tracer=tracer,
                            metrics=JaxServingMetrics(
                                "rt", labels={"replica": str(i)}))
                for i in range(2)]

    want_w = jlockcheck.LockOrderWitness(name="reference_router")
    jlockcheck.arm(want_w)
    try:
        want = _script(reference, jrouter.Router,
                       jtracing.SpanTracer(mode="all", last=64))
    finally:
        jlockcheck.disarm()
    got_w = lockcheck.LockOrderWitness(name="port_router")
    lockcheck.arm(got_w)
    xfer.arm("disallow")
    try:
        got = _script(lambda tracer: _port_fleet(host, tracer=tracer),
                      Router, SpanTracer(mode="all", last=64))
    finally:
        xfer.disarm()
        lockcheck.disarm()
    return got, want, got_w.report(), want_w.report()


def test_sequential_script_equals_the_reference(script):
    got, want, _, _ = script
    assert got["outs"] == want["outs"]
    # every score 0 between requests: the fewest-routed tiebreak
    # alternates the replicas
    assert got["stamps"] == want["stamps"] == [0, 1] * 4
    assert got["versions"] == want["versions"] == [0] * 8
    assert got["batch"] == want["batch"]
    assert got["batch_replicas"] == want["batch_replicas"] == [0, 1]
    assert got["routed"] == want["routed"]
    assert got["counters"] == want["counters"]
    assert got["totals"] == want["totals"] == [10, 10, 0, 0, 0]
    assert got["counters"]['routed_requests{replica="0"}'] \
        + got["counters"]['routed_requests{replica="1"}'] == 10
    assert got["gauges"] == want["gauges"]
    assert got["gauges"]["replicas_live"] == 2
    assert got["replica_snapshots"] == want["replica_snapshots"] == 2


def _discrete(spans, relative_dids=False):
    """Each span's (name, cat, attributes): durations dropped, the
    backend's presence kept.  With ``relative_dids`` a dispatch id
    becomes its rank among the record's: two replicas dispatching side
    by side interleave the tracer-wide ids by timing."""
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


def test_span_sequences_equal_the_reference(script):
    got, want, _, _ = script
    port = {r["rid"]: r for r in got["records"]}
    ref = {r["rid"]: r for r in want["records"]}
    assert sorted(port) == sorted(ref) and len(port) == len(PROMPTS) + 2
    burst = sorted(ref)[len(PROMPTS):]        # generate's two rows
    for rid in sorted(ref):
        assert _discrete(port[rid]["spans"], rid in burst) \
            == _discrete(ref[rid]["spans"], rid in burst), rid
        assert port[rid]["error"] == ref[rid]["error"] is None
    names = [s["name"] for s in port[sorted(port)[0]]["spans"]]
    assert names[:3] == ["request", "attempt", "queue.wait"]
    assert verify_integrity(got["records"])["requests"] == len(port)
    assert jtracing.verify_integrity(got["records"])["requests"] == len(port)


def test_lock_edge_graph_equals_the_reference(script):
    _, _, got_r, want_r = script
    assert got_r["violations"] == [] and want_r["violations"] == [], \
        "\n\n".join(got_r["violations"] + want_r["violations"])
    assert got_r["edges"] == want_r["edges"]
    assert set(got_r["edges"]["lm_engine._cond"]) >= {"metrics._lock",
                                                      "tracing._lock"}
    assert got_r["acquisitions"] > 0


# ------------------------------------------------------- (e) all refuse
def _refusing(metrics_cls, exc_cls, ras):
    fleet = []
    for i, ra in enumerate(ras):
        def submit(prompt, n_new, ra=ra):
            raise exc_cls(retry_after=ra)
        stub = _stub(metrics_cls, i, (0, 0, 0, 0, [], []))
        stub.submit = submit
        fleet.append(stub)
    return fleet


RETRY_AFTERS = (0.7, 0.3, 0.5)


def _all_refuse(router_cls, metrics_cls, exc_cls):
    router = router_cls(_refusing(metrics_cls, exc_cls, RETRY_AFTERS),
                        policy="round_robin")
    with pytest.raises(exc_cls) as err:
        router.submit([1, 2, 3], 4)
    return err.value.retry_after, router.metrics.rejected


def test_all_refuse_retry_after_is_the_minimum():
    want = _all_refuse(jrouter.Router, JaxServingMetrics, JaxOverloaded)
    assert _all_refuse(Router, ServingMetrics, Overloaded) == want \
        == (pytest.approx(min(RETRY_AFTERS)), 1)
    fleets = [jrouter.Router(_refusing(JaxServingMetrics, JaxOverloaded,
                                       (0.1, 0.2))),
              Router(_refusing(ServingMetrics, Overloaded, (0.1, 0.2)))]
    errors = []
    for router in fleets:
        assert router.unregister(0, reason="test") == 0
        assert router.unregister(1, reason="test") == 0
        assert router.unregister(1, reason="again") == 0
        with pytest.raises(Overloaded if router is fleets[1]
                           else JaxOverloaded) as err:
            router.submit([1, 2, 3], 4)
        errors.append(err.value)
        assert router.metrics.gauge("replicas_live") == 0
        assert router.metrics.counter("replica_drains") == 2
    assert type(errors[1]) is NoLiveReplicas
    assert type(errors[0]).__name__ == "NoLiveReplicas"
    assert str(errors[1]) == str(errors[0])
    assert errors[1].retry_after == errors[0].retry_after > 0


def test_planted_retry_after_from_the_last_refusal_is_caught(monkeypatch):
    monkeypatch.setattr(Router, "_place", _mutant(
        Router._place, "else min(min_retry, ra)", "else ra"))
    want = _all_refuse(jrouter.Router, JaxServingMetrics, JaxOverloaded)
    assert _all_refuse(Router, ServingMetrics, Overloaded) != want


def test_validation_and_later_slices_refused(host):
    with pytest.raises(ValueError, match="at least one"):
        Router([])
    [engine] = _port_fleet(host, 1, tag="val")
    with pytest.raises(ValueError, match="policy"):
        Router([engine], policy="fastest")
    # the resilience knobs are ported: accepted, with the reference's
    # backoff defaults
    armed = Router([engine], retries=2, hedge_after_s=0.1)
    assert (armed.retries, armed.hedge_after_s) == (2, 0.1)
    assert (armed.retry_backoff_s, armed.retry_backoff_cap_s) == (0.05, 2.0)
    assert armed._hedge_thread is None           # started by start()
    router = Router([engine])
    # the reference's role names, so the witnesses' graphs compare
    assert (router._lock.name, router._deploy_lock.name) \
        == ("router._lock", "router._deploy_lock")
    with pytest.raises(NotImplementedError, match=r"Queue 1 item 9\(c\)"):
        router.deploy(host)
    assert router.spec_k == 0 and router.max_len == MAX_LEN
    from veles_tpu_torch import serving
    assert serving.HealthChecker is prouter.HealthChecker


# ------------------------------------------------------------- (f) drain
def _wait(cond, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


def _drain_run(host):
    """Replica 0 slowed (0.1 s a decode dispatch) takes the burst's first
    request (the idle fleet's tiebreak) and it is unregistered once it
    has stepped twice, that request mid-decode.  Returns (outputs,
    withdrawn, snapshot, the replica of a later placement)."""
    plan = FaultPlan().arm("engine.step", kind="latency", latency_s=0.1)
    replicas = _port_fleet(host, plans=[plan], tag="drain")
    router = Router(replicas).start()
    try:
        futures = [router.submit(p, N_NEW) for p in PROMPTS]
        assert futures[0].job.replica == 0
        _wait(lambda: plan.calls("engine.step") >= 2, "replica 0 idle")
        moved = router.unregister(0, reason="test drain")
        outs = [[int(t) for t in f.result(timeout=120)] for f in futures]
        later = router.submit(PROMPTS[0], N_NEW)
        assert len(later.result(timeout=60)) == N_NEW
        return outs, moved, router.metrics.snapshot(), later.job.replica
    finally:
        router.stop()


def test_drain_completes_every_request_once_and_whole(host, script):
    want = script[1]["outs"]
    outs, moved, snap, later = _drain_run(host)
    assert outs == want                        # whole and greedy
    assert moved >= 1
    assert snap["counters"]["requeued_requests"] >= moved
    assert snap["counters"]["replica_drains"] == 1
    assert snap["responses"] == len(PROMPTS) + 1
    assert snap["gauges"]["replicas_live"] == 1
    assert later == 1


def test_planted_short_result_delivery_is_caught(host, script, monkeypatch):
    monkeypatch.setattr(Router, "_on_attempt_done", _mutant(
        Router._on_attempt_done,
        "if requeue and len(result) < job.n_new:", "if False:"))
    outs, _, _, _ = _drain_run(host)
    assert any(len(o) < N_NEW for o in outs)


def test_idle_burst_and_round_robin_split(host):
    """The reference's bounds: a burst on an idle fleet splits within 2
    (metrics policy), and round robin splits exactly in half."""
    for policy, n, bound in (("metrics", 8, 2), ("round_robin", 6, 0)):
        router = Router(_port_fleet(host, tag="split_" + policy),
                        policy=policy).start()
        try:
            futures = [router.submit(p, 3) for p in PROMPTS[:n]]
            assert all(len(f.result(timeout=60)) == 3 for f in futures)
            counts = router.routed_counts()
        finally:
            router.stop()
        assert sum(counts) == n and max(counts) - min(counts) <= bound, \
            (policy, counts)


# ------------------------------------------------------ (g) wedged drain
def test_wedged_drain_force_replaces_and_ignores_the_zombie(host, script):
    """Replica 0 (slowed, 0.05 s a decode dispatch) takes the request;
    once it has decoded, a freeze armed at its next loop turn wedges it
    with the request in a lane.  The drain cannot withdraw it, so after
    ``drain_timeout_s`` it is re-placed on replica 1.  Released, the
    zombie resolves its lane, and that late result is ignored."""
    plan = FaultPlan().arm("engine.step", kind="latency", latency_s=0.05)
    replicas = _port_fleet(host, plans=[plan], tag="wedge")
    router = Router(replicas, drain_timeout_s=0.3).start()
    n_new = 2 * N_NEW
    try:
        f = router.submit(PROMPTS[0], n_new)
        assert f.job.replica == 0
        _wait(lambda: plan.calls("engine.step") >= 1, "replica 0 idle")
        plan.arm("engine.tick", kind="freeze", times=1, duration_s=60.0,
                 after=plan.calls("engine.tick"))
        _wait(lambda: plan.fired("engine.tick") == 1, "no freeze")
        [att] = list(router._pending[0])
        zombie = att.engine_future
        assert not zombie.done()
        assert router.unregister(0, reason="wedged") == 1
        out = f.result(timeout=60)
        assert f.job.replica == 1
        assert router.metrics.counter("drain_forced_replacements") == 1
        assert router.metrics.counter("requeued_requests") == 1
        plan.release()
        late = zombie.result(timeout=60)
        assert len(late) < n_new                 # the withdrawn lane
        _wait(lambda: not router._jobs, "the job was not forgotten")
        assert f.result() is out
        assert router.metrics.responses == 1
    finally:
        plan.release()
        router.stop()
    short = script[1]["outs"][0][:N_NEW]
    assert [int(t) for t in out[:N_NEW]] == short
    assert len(out) == n_new
