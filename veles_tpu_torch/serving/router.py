"""Data-parallel LM serving — N engine replicas behind a metrics-driven
router.

Port of ``veles_tpu/serving/router.py``'s placement and admission half:
N INDEPENDENT :class:`~veles_tpu_torch.serving.LMEngine` replicas, each
on its own device (:func:`replica_device_slices`), behind a
:class:`Router` that places each admitted request on one replica.
Replicas share nothing (no cross-replica KV, no shared queue); the
router keeps the serving contract intact:

- PLACEMENT is driven by the replicas' live ``serving/metrics.py``
  signals, nothing engine-internal: queue depth + busy lanes scaled by
  the replica's decode-step EWMA (its measured pace), the TTFT EWMA as
  the queueing penalty, and resident-KV-page pressure.  Ties (an idle
  fleet) break by fewest requests routed, so cold traffic spreads
  evenly instead of piling on replica 0.  ``policy="round_robin"``
  ignores the signals.
- ADMISSION semantics are unchanged: the router tries replicas in
  placement order and re-raises the engines' own
  :class:`~veles_tpu_torch.serving.batcher.Overloaded` /
  :class:`~veles_tpu_torch.serving.batcher.PoolExhausted` only when
  EVERY live replica refused (HTTP 429 upstream, as one engine) — with
  ``retry_after`` the MINIMUM over the refusing replicas, since the
  client may retry as soon as ANY replica frees; deadline sheds (503)
  and client errors (ValueError → 400) pass through untouched.  A
  single replica degenerates to the one-engine path — same outputs,
  same errors.
- A SICK replica HOT-UNREGISTERS (:meth:`Router.unregister`): it leaves
  the placement rotation at once and every request the router still
  has pending on it — queued or mid-decode — is withdrawn and REQUEUED
  on the surviving replicas.  A request completes exactly once: a
  requeue fires only for work the drain itself interrupted (cancelled,
  or returned short), never for a result that arrived whole.  A replica
  too wedged to resolve its withdrawn request is abandoned after
  ``drain_timeout_s`` and the request re-placed; the zombie's late
  result is ignored.  Requests never wedge: when no live replica can
  take a requeued request, its future fails loudly.

The RESILIENCE layer adds three opt-in behaviors, all default-off, so an
untouched router keeps the placement contract above bit for bit:

- RETRY (``retries=N``): an engine-level FAULT on a live replica (an
  injected dispatch error, a faulted step — not ``Overloaded``, not a
  deadline shed, not a client error) re-places the request WHOLE on a
  different replica after an exponential backoff with seeded jitter, up
  to N times; a spent budget delivers the last fault to the client.
  Re-placement is idempotent for greedy replicas: they decode bit for
  bit alike and the failed attempt delivered nothing.  Metered as
  ``requests_retried``.
- HEDGING (``hedge_after_s=T``): a request still outstanding past the
  tail threshold (``T`` seconds, or ``T < 0`` for 1.5× the live latency
  p95) is DUPLICATED on a second replica; the first completed attempt
  resolves the client future and the loser is cancelled through the
  engines' ``_cancel``.  A loser on a captured decode graph runs its
  lane to the end of the replay before its slot and pages are freed.
  Metered as ``requests_hedged`` / ``hedge_wins`` (wins = the hedge
  finished first).
- HEALTH (:class:`HealthChecker`): a prober that quarantines a wedged or
  failing replica through ``unregister`` and re-registers it after a
  cooldown with half-open circuit-breaker semantics (see its
  docstring); the SLO monitor feeds it page signals.

The router's own :class:`ServingMetrics` meters placement
(``routed_requests{replica="i"}``, ``requeued_requests``,
``replica_drains``, ``drain_forced_replacements``, rejected), the
resilience layer (``requests_retried``, ``requests_hedged``,
``hedge_wins``, ``circuit_open_total``, ``health_probes``,
``health_probe_failures``, ``health_probe_warmups``,
``slo_page_signals``, ``replica_health_state{replica="i"}``), and each
replica's engine metrics register under one family name with a
``{replica="i"}`` label — ``/metrics`` renders one ``# TYPE`` line per
family with one row per replica, and ``/metrics.json`` (via
:class:`RouterMetrics`) embeds every replica's snapshot under
``"replicas"``.

THREADS AND THE TRANSFER GUARD.  An engine resolves a request's future
on its worker, inside the guarded turn (``xfer.guard``), so
:meth:`Router._on_attempt_done` — and the re-placement, retry timer or
loser cancel it may start on another replica — runs under replica i's
guard.  Retry timers, the hedge loop, the health prober and the SLO
monitor's hooks (the telemetry thread) run on threads of their own.
Everything the router and the checker do is host work (numpy prompts,
locks, metrics, futures); they touch no card value.  The card's sync
debug mode is process-wide (ROADMAP Queue 3 item 23), so a guard one
replica's worker holds puts every one of these threads under it too,
and a card read on any of them would fail only when it overlaps a
worker's turn; the router does not change that.

Not ported yet: :meth:`Router.deploy` with the model manager (ROADMAP
Queue 1 item 9(c)).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future

import numpy
import torch

from veles_tpu_torch.logger import Logger
from veles_tpu_torch.serving import lockcheck, tracing
from veles_tpu_torch.serving.batcher import DeadlineExceeded, Overloaded
from veles_tpu_torch.serving.metrics import ServingMetrics

_DEPLOY = "ROADMAP Queue 1 item 9(c) (fleet deploy and the model manager)"


def replica_device_slices(replicas, tp, devices=None):
    """The device slice each replica owns: replica ``i`` gets devices
    ``[i*tp, (i+1)*tp)`` when tensor-parallel (validated against the
    device count up front), one device round-robin otherwise.  THE one
    replica→devices mapping ``serve_lm`` consumes.  ``devices`` None
    means every visible CUDA card (raising without one: the fleet never
    falls back to the CPU); pass ``[torch.device("cpu")]`` for CPU
    replicas."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not n:
            raise RuntimeError("replica_device_slices: no CUDA card is "
                               "visible (pass devices= for CPU replicas)")
        devices = [torch.device("cuda", k) for k in range(n)]
    devices = list(devices)
    n_rep = max(1, int(replicas))
    tp_n = int(tp or 0)
    if tp_n >= 2:
        if n_rep * tp_n > len(devices):
            raise ValueError(
                "replicas=%d × tp=%d needs %d devices, have %d"
                % (n_rep, tp_n, n_rep * tp_n, len(devices)))
        return [devices[i * tp_n:(i + 1) * tp_n] for i in range(n_rep)]
    return [[devices[i % len(devices)]] for i in range(n_rep)]


class NoLiveReplicas(Overloaded):
    """Every replica is out of rotation (drained) — a TRANSIENT
    unavailability, served upstream as the retryable 429 +
    ``Retry-After``, never a 500."""

    def __init__(self, retry_after=1.0):
        RuntimeError.__init__(
            self, "router has no live replicas (all quarantined or "
                  "drained); retry after %.1fs" % retry_after)
        self.retry_after = retry_after


class RouterMetrics(ServingMetrics):
    """Router-owned metrics whose ``snapshot()`` additionally embeds
    each replica engine's snapshot under ``"replicas"`` — one
    ``/metrics.json`` fetch covers the whole fleet."""

    def __init__(self, name="lm_router", labels=None):
        super().__init__(name, labels=labels)
        self._router = None

    def snapshot(self):
        snap = super().snapshot()
        router = self._router
        if router is not None:
            snap["replicas"] = [e.metrics.snapshot()
                                for e in router.replicas]
        return snap


class _Attempt:
    """One engine-side placement of a job.  A job normally has exactly
    one; hedging adds a second, and the first to settle wins."""

    __slots__ = ("job", "replica", "engine_future", "requeue",
                 "is_hedge", "abandoned", "span")

    def __init__(self, job, is_hedge=False):
        self.job = job
        self.replica = None
        self.engine_future = None
        #: this attempt's open span handle (tracing)
        self.span = None
        #: set by unregister() right before it withdraws the engine-side
        #: request: tells the completion callback that a cancellation or
        #: short result is drain fallout to REPLACE, not a client event
        self.requeue = False
        self.is_hedge = is_hedge
        #: set when a drain timeout force-replaced this attempt while
        #: its engine was WEDGED: whatever the zombie engine eventually
        #: resolves is ignored (the replacement owns the client future)
        self.abandoned = False


class _Job:
    """One routed request: the client-facing future plus its live
    engine-side placements."""

    __slots__ = ("prompt", "n_new", "future", "t0", "replica", "live",
                 "requeues", "retries", "hedged", "last_exc", "version",
                 "delivered", "trace", "own_trace")

    def __init__(self, prompt, n_new):
        self.prompt = prompt
        self.n_new = int(n_new)
        self.future = Future()
        #: the request's TraceContext (or None), and whether the ROUTER
        #: rooted it (finished in _forget, once every attempt — hedge
        #: losers included — has settled)
        self.trace = None
        self.own_trace = False
        self.future.job = self          # router-level cancellation handle
        self.t0 = time.monotonic()
        #: replica of the newest placement (the WINNING attempt's after
        #: delivery) — what serve_lm stamps into ``"replicas"``
        self.replica = None
        #: the weights_version that produced the delivered tokens
        self.version = None
        #: delivery claim (router lock): exactly one attempt stamps
        #: replica/version and resolves the future
        self.delivered = False
        #: live attempts (guarded by the router lock)
        self.live = set()
        self.requeues = 0
        self.retries = 0
        self.hedged = False
        self.last_exc = None


class Router(Logger):
    """Place requests on ``replicas`` (started/stopped together) by
    their live metrics; see the module docstring for the contract.

    ``retries`` / ``hedge_after_s`` arm the resilience behaviors
    (default OFF); ``retry_backoff_s`` / ``retry_backoff_cap_s`` bound
    the retry delay; ``seed`` makes the retry jitter (and the canary
    coin of :meth:`_order`) reproducible; ``faults`` attaches a
    :class:`~veles_tpu_torch.serving.faults.FaultPlan` whose
    ``router.place`` site fires per placement attempt; ``tracer`` a
    :class:`~veles_tpu_torch.serving.tracing.SpanTracer` (one
    ``attempt`` span a placement attempt)."""

    POLICIES = ("metrics", "round_robin")

    #: lock-discipline map: placement state is touched by client
    #: threads, engine-worker completion callbacks, drain and retry
    #: timers, the hedge loop and the health checker — everything
    #: shared lives under ``_lock``.  ``_deploy_lock``
    #: serializes whole deploys and guards no attributes.  Job/attempt
    #: fields (job.live, job.delivered) are guarded by ``_lock`` too.
    _guarded_by = {
        "_live": "_lock",
        "_routed": "_lock",
        "_pending": "_lock",
        "_jobs": "_lock",
        "_timers": "_lock",
        "_stopping": "_lock",
        "_rr": "_lock",
        "_canary": "_lock",
        "_canary_fraction": "_lock",
        "_rng": "_lock",
    }

    def __init__(self, replicas, metrics=None, name="lm_router",
                 policy="metrics", retries=0, retry_backoff_s=0.05,
                 retry_backoff_cap_s=2.0, hedge_after_s=0.0,
                 drain_timeout_s=5.0, seed=0, faults=None,
                 tracer=None):
        replicas = list(replicas)
        if not replicas:
            raise ValueError("router needs at least one replica")
        if policy not in self.POLICIES:
            raise ValueError("unknown router policy %r (one of %r)"
                             % (policy, self.POLICIES))
        self.name = name
        self.replicas = replicas
        self.policy = policy
        self.retries = int(retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.retry_backoff_cap_s = float(retry_backoff_cap_s)
        self.hedge_after_s = float(hedge_after_s or 0.0)
        self.drain_timeout_s = float(drain_timeout_s)
        self.metrics = metrics or ServingMetrics(name)
        if isinstance(self.metrics, RouterMetrics):
            self.metrics._router = self
        self._faults = faults
        #: optional SpanTracer — one attribute-is-None check per site
        #: when unarmed
        self._tracer = tracer
        self._live = [True] * len(replicas)
        self._routed = [0] * len(replicas)
        self._pending = [set() for _ in replicas]
        self._jobs = set()              # outstanding (hedge scan set)
        self._timers = set()            # pending drain and retry timers
        self._lock = lockcheck.make_lock("router._lock")
        self._rng = numpy.random.RandomState(seed)
        self._rr = 0
        self._stopping = False
        self._hedge_thread = None
        self._hedge_wake = threading.Event()
        #: canary traffic steering: while a deploy watches its canary,
        #: placement prefers the canary set with this probability (inert
        #: until Router.deploy is ported)
        self._canary = frozenset()
        self._canary_fraction = 0.0
        self._deploy_lock = lockcheck.make_lock("router._deploy_lock")
        self.metrics.set_gauge("replicas_total", len(replicas))
        self.metrics.set_gauge("replicas_live", len(replicas))
        for i in range(len(replicas)):
            self._note_version(i)

    # ----------------------------------------------------------- properties
    @property
    def spec_k(self):
        """Speculation headroom upstream admission must reserve — the
        replicas share a config, but take the max so a heterogeneous
        fleet still reserves enough for any placement."""
        return max(e.spec_k for e in self.replicas)

    @property
    def max_len(self):
        return min(e.max_len for e in self.replicas)

    # ------------------------------------------------------------ lifecycle
    def start(self):
        """Start the replicas one after another, before any request is
        admitted.  Each engine's ``start()`` warms up and, on the card,
        captures its CUDA graphs before it returns, so no replica's
        capture overlaps another replica's launches.  The hedge thread
        starts after them."""
        for e in self.replicas:
            e.start()
        if self.hedge_after_s:
            self._hedge_wake.clear()
            self._hedge_thread = threading.Thread(
                target=self._hedge_loop, daemon=True,
                name="router-hedge-%s" % self.name)
            self._hedge_thread.start()
        return self

    def stop(self):
        with self._lock:
            self._stopping = True
            timers = list(self._timers)
            self._timers.clear()
            jobs = list(self._jobs)
        for t in timers:
            t.cancel()
        self._hedge_wake.set()
        if self._hedge_thread is not None:
            self._hedge_thread.join(timeout=10)
            self._hedge_thread = None
        # a job parked on a cancelled retry or drain timer has no live
        # attempt left to resolve it — fail it loudly instead of
        # wedging the client on a future nobody owns
        for job in jobs:
            with self._lock:
                orphan = not job.live and not job.future.done()
            if orphan:
                self._settle_exc(job,
                                 job.last_exc
                                 or RuntimeError("router stopped"))
                self._forget(job)
        for e in self.replicas:
            e.stop()

    @staticmethod
    def _settle_exc(job, exc):
        """Fail the client future unless a concurrent path (a hedge
        sibling's delivery, stop()'s orphan sweep, a racing retry timer)
        already settled it — the Future's own state transition is the
        arbiter, as in _deliver's result race."""
        try:
            job.future.set_exception(exc)
        except Exception:   # noqa: BLE001 — someone else settled it
            pass

    # ------------------------------------------------------------ placement
    def _fault(self, site):
        if self._faults is not None:
            self._faults.fire(site)

    def _score(self, i):
        """Smaller = place here.  Everything read from the replica's
        live ServingMetrics: outstanding work (queue depth + busy
        lanes) scaled by the replica's measured decode-step EWMA (a
        slow replica's queue costs more wall than a fast one's), the
        TTFT EWMA weighted by queue depth (the queueing penalty new
        arrivals feel), and fractional resident-KV-page pressure as the
        paged-pool tiebreak."""
        m = self.replicas[i].metrics
        depth = m.gauge("queue_depth", 0) + m.gauge("slots_busy", 0)
        step = m.ewma("decode_step", 0.0) or 1e-4
        score = depth * step + m.ewma("ttft", 0.0) * m.gauge(
            "queue_depth", 0)
        kv_total = m.gauge("kv_pages_total", 0)
        if kv_total:
            score += (1.0 - m.gauge("kv_pages_free", kv_total)
                      / kv_total) * step
        return score

    def _note_version(self, i):
        """Export replica i's serving checkpoint generation as the
        ``weights_version{replica=}`` gauge."""
        v = getattr(self.replicas[i], "weights_version", None)
        if isinstance(v, (int, float)):
            self.metrics.set_gauge("weights_version", v,
                                   labels={"replica": str(i)})

    def _order(self):
        """Live replica indices, best placement first.  While a deploy
        watches a canary, a seeded coin steers ``_canary_fraction`` of
        placements to the canary set first (the rest of the fleet
        remains the admission fallback either way)."""
        with self._lock:
            live = [i for i, ok in enumerate(self._live) if ok]
            if self.policy == "round_robin":
                self._rr += 1
                start = self._rr
            routed = list(self._routed)
            canary = self._canary
            pick_canary = bool(canary) and \
                self._rng.random_sample() < self._canary_fraction
        if not live:
            raise NoLiveReplicas()
        if self.policy == "round_robin":
            order = [live[(start + j) % len(live)]
                     for j in range(len(live))]
        else:
            order = sorted(live,
                           key=lambda i: (self._score(i), routed[i], i))
        if canary:
            order = ([i for i in order if (i in canary) == pick_canary]
                     + [i for i in order
                        if (i in canary) != pick_canary])
        return order

    def submit(self, prompt, n_new):
        """Queue one prompt on the best replica; returns a Future for
        the (n_new,) continuation.  Raises exactly what one engine
        would: ValueError for client errors, Overloaded / PoolExhausted
        when every live replica refuses admission (with ``retry_after``
        the MINIMUM over the refusing replicas)."""
        job = _Job(prompt, int(n_new))
        # join the caller's trace (HTTP) or root one here: the attempt
        # spans _place opens nest under it.  A router-rooted trace
        # finishes in _forget, once every attempt settled; a
        # sampled-out decision leaves job.trace None and _place
        # propagates it so the engines never re-roll the coin
        if self._tracer is not None:
            ctx, job.own_trace = tracing.join_or_root(
                self._tracer, "request", "router")
            job.trace = None if ctx is tracing.SAMPLED_OUT else ctx
        with self._lock:
            self._jobs.add(job)
        try:
            self._place(job)
        except Exception as e:
            with self._lock:
                self._jobs.discard(job)
            if job.own_trace:
                job.trace.tracer.finish_request(job.trace, error=e)
            raise
        return job.future

    def _place(self, job, exclude=(), hedge=False):   # hot-path
        """Place one attempt for ``job`` on the first replica in
        placement order that admits it.  ``exclude`` replicas are tried
        last (retry on a different replica) — or not at all when
        ``hedge`` (a duplicate on the same replica hedges nothing).
        Returns True when placed; a failed hedge returns False
        (best-effort), a failed primary placement raises.  Host work
        only: it may run on another replica's worker, under that
        worker's transfer guard, or on a timer or the hedge thread."""
        last_exc = None
        min_retry = None
        order = self._order()
        if exclude:
            preferred = [i for i in order if i not in exclude]
            order = preferred if hedge \
                else preferred + [i for i in order if i in exclude]
        for i in order:
            engine = self.replicas[i]
            with self._lock:
                if not self._live[i]:
                    continue
            att = _Attempt(job, is_hedge=hedge)
            trc = job.trace
            if trc is not None:
                att.span = trc.tracer.begin(
                    trc, "attempt", cat="router",
                    attrs={"replica": i, "hedge": hedge,
                           "retry": job.retries,
                           "requeue": job.requeues})
            try:
                self._fault("router.place")
                if att.span is not None:
                    # the engine's spans nest under THIS attempt
                    with tracing.use(trc.at(att.span[1])):
                        f = engine.submit(job.prompt, job.n_new)
                elif self._tracer is not None:
                    # sampled out (or a late re-place of a sealed
                    # trace): tell the engine the decision is made
                    with tracing.use(tracing.SAMPLED_OUT):
                        f = engine.submit(job.prompt, job.n_new)
                else:
                    f = engine.submit(job.prompt, job.n_new)
            except Overloaded as exc:
                # queue/pool pressure on this replica: the next-best may
                # still have room (a ValueError propagates at once: it
                # is the same on every replica).  Keep the SMALLEST
                # Retry-After seen: the client may come back as soon as
                # the soonest-freeing replica frees
                last_exc = exc
                if att.span is not None:
                    trc.tracer.end(att.span, error=exc)
                ra = getattr(exc, "retry_after", None)
                if ra is not None:
                    min_retry = ra if min_retry is None \
                        else min(min_retry, ra)
                continue
            except Exception as exc:
                # a client error propagates — close the span on the way
                if att.span is not None:
                    trc.tracer.end(att.span, error=exc)
                raise
            att.replica = i
            att.engine_future = f
            with self._lock:
                # re-check at COMMIT: a drain that ran between the
                # pre-submit check and here already snapshotted
                # _pending[i] without this attempt (stranding it on the
                # drained replica), and a sibling attempt may have
                # DELIVERED (or the client cancelled) in the same
                # window — withdraw in either case
                done = job.future.done()
                stale = done or not self._live[i]
                if not stale:
                    self._pending[i].add(att)
                    job.live.add(att)
                    self._routed[i] += 1
                    job.replica = i
            if stale:
                engine._cancel(f.request)
                if att.span is not None:
                    trc.tracer.end(att.span, attrs={"stale": True})
                if done:
                    return True      # settled — nothing left to place
                continue
            if hedge:
                self.metrics.inc("requests_hedged")
            else:
                self.metrics.record_enqueue()
            self.metrics.inc("routed_requests",
                             labels={"replica": str(i)})
            f.add_done_callback(
                lambda f, att=att: self._on_attempt_done(att, f))
            return True
        if hedge:
            return False
        self.metrics.record_reject()
        if last_exc is not None:
            if min_retry is not None:
                last_exc.retry_after = min_retry
            raise last_exc
        raise Overloaded()

    # ----------------------------------------------------------- completion
    def _on_attempt_done(self, att, engine_future):
        """Runs on the replica's worker (inside its guarded turn) or on
        a canceller's thread when an engine-side future settles.
        Exactly-once delivery: the router future is resolved here and
        only here — the first settled attempt wins, siblings are
        cancelled and ignored — and a requeue fires only for drain
        fallout (``_Attempt.requeue``).  A retry it schedules starts a
        timer; the timer's thread places the attempt."""
        job = att.job
        i = att.replica
        if att.span is not None:
            if engine_future.cancelled():
                outcome = "cancelled"
            elif engine_future.exception() is not None:
                outcome = "error"
            else:
                outcome = "ok"
            job.trace.tracer.end(
                att.span, attrs={"outcome": outcome},
                error=(engine_future.exception()
                       if outcome == "error" else None))
        with self._lock:
            # membership in job.live is the CLAIM: a drain timeout that
            # force-replaced this attempt already removed it (and owns
            # the job now) — this late resolution belongs to a zombie
            claimed = att in job.live
            self._pending[i].discard(att)
            job.live.discard(att)
            others = bool(job.live)
            live = self._live[i]
            stopping = self._stopping
        if att.abandoned or not claimed:
            self._forget(job)
            return
        if job.future.done():            # withdrawn, or a sibling won
            self._forget(job)
            return
        # a live SIBLING attempt already guarantees delivery: drain
        # fallout on this one never needs a replacement decode (the
        # `others` guards below) — re-placing anyway would duplicate the
        # work on the shrunken fleet exactly when it is drained
        requeue = att.requeue and not stopping
        if engine_future.cancelled():
            if requeue and not others:
                # withdrawn before any decode: drain fallout replaces
                # it; a router-level cancellation stays cancelled
                self._replace(job)
            elif others:
                pass                     # a cancelled hedge loser
            else:
                job.future.cancel()
                self._forget(job)
            return
        exc = engine_future.exception()
        if exc is not None:
            benign = isinstance(exc, (Overloaded, DeadlineExceeded))
            if (requeue or not live) and not others and not stopping \
                    and not benign:
                # in-flight work dying WITH its drained replica (engine
                # stopped, faulted step) is the router's problem,
                # whatever the retry budget says
                self._replace(job)
                return
            if others:
                # a hedge sibling is still decoding — let it deliver
                job.last_exc = exc
                return
            if not benign and not stopping and self.retries \
                    and job.retries < self.retries:
                # engine-level FAULT on a live replica: re-place WHOLE
                # on a different replica after a jittered backoff
                self._schedule_retry(job, exc, exclude={i})
                return
            self._settle_exc(job, exc)
            self._forget(job)
            return
        result = engine_future.result()
        if requeue and len(result) < job.n_new:
            # the drain interrupted this lane mid-decode: the engine
            # resolved it with the tokens it had (its cancellation
            # path) — rerun the request whole on a live replica, unless
            # a sibling attempt is already decoding it
            if not others:
                self._replace(job)
            return
        self._deliver(job, att, result)

    def _deliver(self, job, att, result):
        """First settled attempt wins; the set_result race (two attempts
        completing at once) is decided under the router lock: exactly
        ONE attempt claims delivery and stamps replica/version — a
        losing hedge sibling never overwrites the winner's stamps."""
        with self._lock:
            if job.delivered or job.future.done():
                return
            job.delivered = True
            # stamped BEFORE the result resolves so a waiter unblocked
            # by set_result reads the WINNING attempt's stamps
            job.replica = att.replica
            job.version = getattr(att.engine_future, "version", None)
            if job.trace is not None:
                # close the losers' open spans BEFORE the client
                # unblocks: an HTTP-owned root seals the trace the
                # moment the handler returns, and a still-open loser
                # would be flagged unclosed.  (Their engine-side work
                # is cancelled below, after set_result.)
                for loser in job.live:
                    job.trace.tracer.end(
                        loser.span, attrs={"outcome": "hedge-lost"})
                    lreq = getattr(loser.engine_future, "request", None)
                    if lreq is not None and lreq.tspan is not None:
                        job.trace.tracer.end(lreq.tspan,
                                             error="hedge-lost")
        try:
            job.future.set_result(result)
        except Exception:   # noqa: BLE001 — cancelled/settled meanwhile
            return
        if att.is_hedge:
            self.metrics.inc("hedge_wins")
        self.metrics.record_response(time.monotonic() - job.t0)
        with self._lock:
            losers = list(job.live)
        for loser in losers:
            # the loser's callback sees the done future and exits; on a
            # captured decode graph its lane runs to the replay's end
            self.replicas[loser.replica]._cancel(
                loser.engine_future.request)
        self._forget(job)

    def _forget(self, job):
        with self._lock:
            settled = not job.live
            if settled:
                self._jobs.discard(job)
        if settled and job.own_trace and job.future.done():
            # every attempt settled AND the client future resolved:
            # the span tree is complete — seal it (idempotent)
            tracing.finish_from_future(job.trace, job.future)

    def _replace(self, job):
        """Re-place a drain-interrupted job on the surviving replicas —
        or fail it loudly when none can take it (never wedge)."""
        if job.future.done():
            # raced a router-level cancellation: nobody reads this
            # result — do not spend a healthy replica's slots on it
            self._forget(job)
            return
        job.requeues += 1
        self.metrics.inc("requeued_requests")
        if job.trace is not None:
            job.trace.tracer.instant(
                job.trace, "drain.requeue", cat="router",
                attrs={"requeue": job.requeues})
        if job.requeues > len(self.replicas) + 1:
            self._settle_exc(job, RuntimeError(
                "request could not be re-placed after %d drain retries"
                % job.requeues))
            self._forget(job)
            return
        try:
            self._place(job)
        except Exception as exc:   # noqa: BLE001 — delivered, not raised
            self._settle_exc(job, exc)
            self._forget(job)

    # -------------------------------------------------------------- retry
    def _schedule_retry(self, job, exc, exclude):
        """Re-place ``job`` after ``min(cap, base · 2^(n−1))`` seconds
        plus seeded jitter ``uniform(0, delay/2)``, on a timer that
        :meth:`stop` cancels."""
        job.retries += 1
        job.last_exc = exc
        self.metrics.inc("requests_retried")
        delay = min(self.retry_backoff_cap_s,
                    self.retry_backoff_s * (2 ** (job.retries - 1)))
        if job.trace is not None:
            job.trace.tracer.instant(
                job.trace, "retry.backoff", cat="router",
                attrs={"retry": job.retries,
                       "base_delay_s": round(delay, 4)})
        with self._lock:
            # seeded jitter (deterministic for a fixed retry order):
            # desynchronizes a burst of same-fault retries so they do
            # not land on the survivor as one thundering herd
            delay += float(self._rng.uniform(0.0, delay * 0.5))
            stopping = self._stopping
            if not stopping:
                timer = threading.Timer(
                    delay, self._retry_place, args=(job, exclude))
                timer.daemon = True
                self._timers.add(timer)
        if stopping:
            self._settle_exc(job, exc)
            self._forget(job)
            return
        timer.start()

    def _retry_place(self, job, exclude):
        with self._lock:
            # drop timers whose threads finished (this one is still
            # alive while its callback runs; it prunes next round)
            self._timers = {t for t in self._timers if t.is_alive()}
            stopping = self._stopping
        if job.future.done():
            self._forget(job)
            return
        if stopping:
            self._settle_exc(job,
                             job.last_exc or RuntimeError("router stopped"))
            self._forget(job)
            return
        try:
            self._place(job, exclude=exclude)
        except Exception as exc:   # noqa: BLE001 — delivered, not raised
            self._settle_exc(job, exc)
            self._forget(job)

    # ------------------------------------------------------------- hedging
    def _hedge_threshold(self):
        """Seconds outstanding before a request hedges: the fixed
        ``hedge_after_s``, or (when negative) 1.5× the live latency
        p95 — None until enough responses exist to estimate a tail."""
        if self.hedge_after_s > 0:
            return self.hedge_after_s
        p95 = self.metrics.latency_quantile(0.95)
        if p95 is None:
            return None
        return max(0.02, 1.5 * p95)

    def _hedge_loop(self):
        interval = max(0.005, self.hedge_after_s / 4) \
            if self.hedge_after_s > 0 else 0.02
        while not self._hedge_wake.wait(interval):
            thr = self._hedge_threshold()
            if thr is None:
                continue
            now = time.monotonic()
            with self._lock:
                jobs = [j for j in self._jobs
                        if not j.hedged and len(j.live) == 1]
                live_n = sum(1 for ok in self._live if ok)
            if live_n < 2:
                continue
            for job in jobs:
                if job.future.done() or now - job.t0 < thr:
                    continue
                with self._lock:
                    exclude = {a.replica for a in job.live}
                    job.hedged = True
                try:
                    # best-effort: a refused hedge (fleet under
                    # pressure) just leaves the primary to finish
                    self._place(job, exclude=exclude, hedge=True)
                except Exception:   # noqa: BLE001 — hedge is optional
                    pass

    # --------------------------------------------------------------- client
    def generate(self, prompts, n_new, return_replicas=False,
                 return_versions=False):
        """Decode a (b, s) prompt batch across the fleet; returns
        (b, s + n_new) int32 (with ``return_replicas`` also the replica
        index that served each row, with ``return_versions`` the
        ``weights_version`` each row decoded under).  All-or-nothing
        sibling cancellation, as ``LMEngine.generate``."""
        prompts = numpy.asarray(prompts, numpy.int32)
        futures = []
        try:
            for row in prompts:
                futures.append(self.submit(row, n_new))
            news = numpy.stack([f.result() for f in futures])
        except Exception:
            for f in futures:
                self.cancel(f)
            raise
        out = numpy.concatenate([prompts, news], axis=1)
        extras = []
        if return_replicas:
            extras.append([f.job.replica for f in futures])
        if return_versions:
            extras.append([f.job.version for f in futures])
        if extras:
            return (out, *extras)
        return out

    def cancel(self, future):
        """Withdraw a routed request (sibling cancellation): every
        engine-side attempt is cancelled and the router future will NOT
        be re-placed."""
        job = future.job
        with self._lock:
            attempts = list(job.live)
        for att in attempts:
            att.requeue = False
            if att.engine_future is not None:
                self.replicas[att.replica]._cancel(
                    att.engine_future.request)
        future.cancel()
        self._forget(job)

    # ---------------------------------------------------------------- drain
    def unregister(self, i, reason="sick"):
        """Hot-unregister replica ``i``: it leaves the placement
        rotation NOW, and every request the router still has pending on
        it is withdrawn and re-placed on the surviving replicas (queued
        requests requeue unserved; a mid-decode lane is cancelled and
        its request reruns whole elsewhere — no loss, no duplicate
        completion).  The engine itself keeps running — the caller
        decides whether to stop or restart it; re-admit with
        :meth:`reregister`.  Returns the number of placements
        withdrawn."""
        with self._lock:
            if not self._live[i]:
                return 0
            self._live[i] = False
            attempts = list(self._pending[i])
            live_now = sum(1 for ok in self._live if ok)
        self.metrics.set_gauge("replicas_live", live_now)
        self.metrics.inc("replica_drains")
        if self._tracer is not None:
            self._tracer.event(
                "router.drain", cat="router",
                attrs={"replica": i, "reason": str(reason),
                       "withdrawn": len(attempts)})
        self.warning("draining replica %d (%s): re-placing %d pending "
                     "request(s) on %d live replica(s)",
                     i, reason, len(attempts), live_now)
        engine = self.replicas[i]
        for att in attempts:
            att.requeue = True
            engine._cancel(att.engine_future.request)
            if not att.engine_future.done():
                # a WEDGED engine (frozen worker, hung device call)
                # cannot resolve its side of a mid-decode withdrawal —
                # after drain_timeout_s the attempt is force-abandoned
                # and the request re-placed anyway.  If the zombie later
                # thaws, its resolution is ignored (the claim check in
                # _on_attempt_done) — exactly-once holds
                timer = threading.Timer(self.drain_timeout_s,
                                        self._force_replace, args=(att,))
                timer.daemon = True
                with self._lock:
                    if not self._stopping:
                        self._timers.add(timer)
                        timer.start()
        return len(attempts)

    def _force_replace(self, att):
        """Drain-timeout fallout: abandon a wedged attempt and re-place
        its job (see unregister)."""
        job = att.job
        with self._lock:
            self._timers = {t for t in self._timers if t.is_alive()}
            if self._stopping or att not in job.live:
                return           # settled (or settling) normally
            att.abandoned = True
            job.live.discard(att)
            self._pending[att.replica].discard(att)
        if job.future.done():
            self._forget(job)
            return
        self.metrics.inc("drain_forced_replacements")
        if att.span is not None:
            job.trace.tracer.end(att.span, error="drain-abandoned")
        self.warning("replica %d never resolved a drained request in "
                     "%.1fs: force re-placing it", att.replica,
                     self.drain_timeout_s)
        self._replace(job)

    def reregister(self, i):
        """Return a drained replica to the placement rotation (after a
        restart or recovery)."""
        with self._lock:
            self._live[i] = True
            live_now = sum(1 for ok in self._live if ok)
        self.metrics.set_gauge("replicas_live", live_now)

    # -------------------------------------------------------------- deploy
    def deploy(self, params, version=None, **kwargs):
        """Roll ``params`` across the fleet canary-first — not ported
        yet."""
        raise NotImplementedError(
            "Router.deploy is not ported yet: %s" % _DEPLOY)

    # ------------------------------------------------------------- evidence
    def routed_counts(self):
        """Requests placed per replica (including requeues, retries and
        hedges) — the server-side balance evidence."""
        with self._lock:
            return list(self._routed)


class HealthChecker(Logger):
    """Background health prober with half-open circuit-breaker
    semantics per replica.

    STATE MACHINE (gauge ``replica_health_state{replica="i"}``):

    - HEALTHY (0): every :meth:`step`, the replica is checked two ways.
      STALENESS — if it holds work (queue depth + busy lanes > 0) but
      its progress counters (tokens emitted, prefill dispatches, i.e.
      the facts behind the decode-step EWMA) have not advanced for
      ``stall_s``, the decode loop is wedged: one failure.  PROBE — an
      IDLE replica gets a synthetic 1-token decode
      (``probe_timeout``-bounded, withdrawn on timeout so a wedged
      queue cannot accumulate probes): a failed or timed-out probe is
      one failure.  Any success resets the count; ``fail_threshold``
      consecutive failures OPEN the circuit.
    - OPEN (1): the replica was auto-quarantined through
      :meth:`Router.unregister` — out of rotation, pending work drained
      onto the survivors (``circuit_open_total`` incremented).  After
      ``cooldown_s`` (doubling per consecutive re-open, capped at
      ``cooldown_cap_s``) the circuit goes half-open.
    - HALF-OPEN (2): ONE synthetic probe, straight to the engine (it is
      out of rotation, so no client traffic is at risk).  Success →
      :meth:`Router.reregister`, state HEALTHY, cooldown reset.
      Failure → back to OPEN with the doubled cooldown.

    A replica an OPERATOR unregistered (router not-live while this
    checker still holds state HEALTHY) is left alone — the checker never
    fights a manual drain.

    SIZING ``stall_s``: on a megastep engine the progress counters move
    once a replay (K decode steps at once), so ``stall_s`` must exceed
    one K-step replay.  ``LMEngine.start()`` captures every CUDA graph
    before it returns, so no capture happens while the checker watches;
    :meth:`start` runs :meth:`warm_probes` first all the same, which
    absorbs the probe's first prompt chunk (its first dispatch of the
    probe's shape) before the monitoring clock starts (drive
    :meth:`step` by hand without :meth:`start`?  call
    ``warm_probes()`` yourself first).

    ``step()`` is public and synchronous: tests drive the state machine
    deterministically without the thread; ``start()`` runs it every
    ``interval_s`` in the background.

    THREADING: the prober thread is not alone — the SLO monitor's
    ``note_slo_page`` / ``note_slo_ok`` hooks arrive on the telemetry
    sampler thread, and ``states()`` is read by other threads.  The
    circuit state (``_state``, ``_fails``, ``_slo_fails``,
    ``_cooldown``, ``_reopen_at``) therefore lives under ``_lock``;
    probes and quarantine side effects (router drains) run OUTSIDE it,
    so the lock is never held across an engine submit or the router's
    own lock.  The progress clocks (``_last_progress``,
    ``_last_counts``, ``_warmed``) stay unguarded: only the prober
    thread (or the test driving ``step()`` in its place) touches them.
    Everything here is host work (metrics, futures): a probe's tokens
    come back through the engine's own read-back."""

    HEALTHY, OPEN, HALF_OPEN = 0, 1, 2

    #: lock-discipline map
    _guarded_by = {
        "_state": "_lock",
        "_fails": "_lock",
        "_slo_fails": "_lock",
        "_cooldown": "_lock",
        "_reopen_at": "_lock",
    }

    def __init__(self, router, interval_s=1.0, probe_timeout_s=5.0,
                 fail_threshold=3, cooldown_s=5.0, cooldown_cap_s=60.0,
                 stall_s=None, probe_token=1, name="lm_health"):
        if fail_threshold < 1:
            raise ValueError("fail_threshold must be >= 1")
        self.name = name
        self.router = router
        self.metrics = router.metrics
        self.interval_s = float(interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.fail_threshold = int(fail_threshold)
        self.cooldown_s = float(cooldown_s)
        self.cooldown_cap_s = float(cooldown_cap_s)
        self.stall_s = float(stall_s) if stall_s is not None \
            else 3.0 * self.interval_s
        self.probe_token = int(probe_token)
        n = len(router.replicas)
        now = time.monotonic()
        self._lock = lockcheck.make_lock("health._lock")
        self._state = [self.HEALTHY] * n
        self._fails = [0] * n
        self._cooldown = [self.cooldown_s] * n
        self._reopen_at = [0.0] * n
        self._last_progress = [now] * n
        self._last_counts = [None] * n
        #: consecutive SLO page signals per replica — kept SEPARATE from
        #: the probe loop's _fails: a slow-but-responsive replica keeps
        #: answering synthetic probes (which reset _fails), so page
        #: signals accumulate on their own counter; the SLO monitor
        #: clears it through note_slo_ok when the burn stops
        self._slo_fails = [0] * n
        self._warmed = False
        self._stop = threading.Event()
        self._thread = None
        for i in range(n):
            self._set_state(i, self.HEALTHY)

    # ------------------------------------------------------------ lifecycle
    def warm_probes(self, timeout_s=60.0):
        """Run one synthetic probe against every replica BEFORE
        monitoring begins, so the probe's first prompt chunk is served
        here instead of inside a ``probe_timeout_s`` window.  Failures
        are logged, never counted; the progress clocks reset afterwards
        so warm-up wall time cannot read as a stall."""
        for i, engine in enumerate(self.router.replicas):
            fut = None
            try:
                fut = engine.submit([self.probe_token], 1)
                fut.result(timeout=timeout_s)
            except Exception as e:   # noqa: BLE001 — warm-up only
                try:
                    if fut is not None:
                        engine._cancel(fut.request)
                except Exception:   # noqa: BLE001 — best-effort
                    pass
                self.warning("probe warm-up failed on replica %d: %s",
                             i, e)
        now = time.monotonic()
        for i in range(len(self.router.replicas)):
            self._last_progress[i] = now
            self._last_counts[i] = None
        self._warmed = True
        self.metrics.inc("health_probe_warmups")
        return self

    def start(self):
        """Start the background monitor.  Returns at once: the warm-up
        probes run as the checker THREAD's first act (before any scan),
        so a wedged-at-boot replica delays its own quarantine, never the
        server's startup."""
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="health-%s" % self.name)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(10.0, 2 * self.probe_timeout_s))
            self._thread = None

    def _loop(self):
        if not self._warmed:
            try:
                self.warm_probes()
            except Exception as e:   # noqa: BLE001 — warm-up only
                self.warning("probe warm-up failed: %s", e)
        while not self._stop.wait(self.interval_s):
            try:
                self.step()
            except Exception as e:   # noqa: BLE001 — prober must survive
                self.warning("health step failed: %s", e)

    # ----------------------------------------------------------- the check
    def states(self):
        """Per-replica circuit state (the gauge's source of truth)."""
        with self._lock:
            return list(self._state)

    def step(self, now=None):
        """One synchronous scan of every replica (see the class
        docstring for the state machine)."""
        now = time.monotonic() if now is None else now
        for i, engine in enumerate(self.router.replicas):
            with self._lock:
                state = self._state[i]
                reopen_at = self._reopen_at[i]
            if state == self.OPEN:
                if now >= reopen_at:
                    self._half_open_probe(i, engine, now)
                continue
            if state == self.HALF_OPEN:
                # a half-open probe is decided synchronously, so landing
                # here means an exception left the state mid-flight —
                # re-probe
                self._half_open_probe(i, engine, now)
                continue
            with self.router._lock:
                router_live = self.router._live[i]
            if not router_live:
                continue        # operator drain — not ours to manage
            m = engine.metrics
            progress = (m.counter("tokens_out")
                        + m.counter("prefill_dispatches"))
            if self._last_counts[i] is None \
                    or progress != self._last_counts[i]:
                self._last_counts[i] = progress
                self._last_progress[i] = now
            busy = (m.gauge("queue_depth", 0)
                    + m.gauge("slots_busy", 0)) > 0
            if busy:
                # staleness: work pending but the decode loop is not
                # advancing (the EWMA's underlying facts are stale)
                failed = (now - self._last_progress[i]) > self.stall_s
            else:
                failed = not self._probe(engine)
            with self._lock:
                if failed:
                    self._fails[i] += 1
                    quarantine = self._fails[i] >= self.fail_threshold
                else:
                    self._fails[i] = 0
                    quarantine = False
            if quarantine:
                self._quarantine(i, now)

    def note_slo_page(self, i, reason="slo page", now=None):
        """An EXTERNAL page-level signal against replica ``i``: the SLO
        monitor reports a replica whose error budget burns at page
        rate; ``fail_threshold`` consecutive paging scans open the
        circuit through the same quarantine / cooldown / half-open path
        a failed probe takes.  Counted on a DEDICATED counter: a
        slow-but-responsive replica still answers the synthetic probes,
        and those successes must not reset the page streak
        (``note_slo_ok`` does, when the burn stops).  Ignored for a
        replica already OPEN/HALF_OPEN or operator-drained."""
        now = time.monotonic() if now is None else now
        if not 0 <= i < len(self.router.replicas):
            raise ValueError("no replica %r" % (i,))
        with self._lock:
            if self._state[i] != self.HEALTHY:
                return
        with self.router._lock:
            router_live = self.router._live[i]
        if not router_live:
            return
        self.metrics.inc("slo_page_signals")
        with self._lock:
            # this hook runs on the TELEMETRY thread while step() runs
            # on the prober's — the streak counter must not tear
            self._slo_fails[i] += 1
            streak = self._slo_fails[i]
            quarantine = streak >= self.fail_threshold
            if quarantine:
                self._slo_fails[i] = 0
        self.warning("replica %d: external SLO page signal (%s) — "
                     "%d/%d toward quarantine", i, reason,
                     streak, self.fail_threshold)
        if quarantine:
            self._quarantine(i, now)

    def note_slo_ok(self, i):
        """Clear replica ``i``'s SLO page streak — the monitor calls
        this for every mapped source NOT paging on a scan, so two pages
        separated by a healthy stretch never sum to a quarantine."""
        with self._lock:
            if 0 <= i < len(self._slo_fails):
                self._slo_fails[i] = 0

    def _probe(self, engine):
        """Synthetic 1-token greedy decode against ``engine`` — bounded,
        and withdrawn on timeout so probes never pile up in a wedged
        queue.  Lane-isolated: a probe never perturbs a client lane."""
        self.metrics.inc("health_probes")
        fut = None
        try:
            fut = engine.submit([self.probe_token], 1)
            fut.result(timeout=self.probe_timeout_s)
            return True
        except Exception:   # noqa: BLE001 — any failure is the signal
            try:
                if fut is not None:
                    engine._cancel(fut.request)
            except Exception:   # noqa: BLE001 — best-effort withdrawal
                pass
            self.metrics.inc("health_probe_failures")
            return False

    # ------------------------------------------------------ state changes
    def _set_state(self, i, state):
        with self._lock:
            self._state[i] = state
        self.metrics.set_gauge("replica_health_state", state,
                               labels={"replica": str(i)})

    def _quarantine(self, i, now):
        with self._lock:
            # CLAIM the transition: the prober's step() and the
            # telemetry thread's note_slo_page() can both decide to
            # quarantine in the same window — exactly one may act, or
            # circuit_open_total double-counts one outage
            if self._state[i] != self.HEALTHY:
                return
            self._state[i] = self.OPEN
            self._fails[i] = 0
            self._reopen_at[i] = now + self._cooldown[i]
            cooldown = self._cooldown[i]
        self.metrics.set_gauge("replica_health_state", self.OPEN,
                               labels={"replica": str(i)})
        self.metrics.inc("circuit_open_total")
        self.warning("replica %d failed %d consecutive health checks: "
                     "circuit OPEN for %.1fs", i, self.fail_threshold,
                     cooldown)
        self.router.unregister(i, reason="health circuit open")

    def _half_open_probe(self, i, engine, now):
        self._set_state(i, self.HALF_OPEN)
        if self._probe(engine):
            with self._lock:
                self._cooldown[i] = self.cooldown_s
                self._fails[i] = 0
                self._slo_fails[i] = 0
            self._set_state(i, self.HEALTHY)
            self._last_counts[i] = None
            self._last_progress[i] = now
            self.info("replica %d passed the half-open probe: "
                      "re-registered", i)
            self.router.reregister(i)
        else:
            with self._lock:
                self._cooldown[i] = min(self.cooldown_cap_s,
                                        2 * self._cooldown[i])
                self._reopen_at[i] = now + self._cooldown[i]
                cooldown = self._cooldown[i]
            self._set_state(i, self.OPEN)
            self.metrics.inc("circuit_open_total")
            self.warning("replica %d failed the half-open probe: "
                         "circuit re-OPEN for %.1fs", i, cooldown)
