"""Serving tier of the port — the paged LM engine (with its radix prefix
cache and prompt-lookup drafts, hot weight swap and crash-safe
checkpoint/restore), the micro-batcher of the REST predict path, the
deterministic fault plans that arm their failure paths, the span tracer
(flight recorder, Chrome-trace export, per-op cost ledger), the
time-series store and SLO burn-rate monitor over the serving metrics,
the lock-order witness and the transfer guard that check them at run
time, and their host-side bookkeeping (allocator, metrics, admission
exceptions).

The serving fleet (``router.py``): N engine replicas, each on its own
device (``replica_device_slices``), behind a :class:`Router` that places
each request on one replica by the replicas' live metrics (or round
robin), answers 429 with the minimum ``Retry-After`` only when every
live replica refuses (:class:`NoLiveReplicas` when none is live),
drains a hot-unregistered replica's requests onto the others exactly
once, and meters the fleet in :class:`RouterMetrics` (every replica's
snapshot under ``"replicas"``).  Its resilience layer retries a faulted
request on another replica after a seeded backoff (``retries=``), hedges
a slow one onto a second replica and cancels the loser
(``hedge_after_s=``), and :class:`HealthChecker` quarantines a wedged or
failing replica and re-admits it through a half-open probe, fed also by
the SLO monitor's page signals.  Deploy is not ported yet (ROADMAP
Queue 1 item 9(c))."""

from veles_tpu_torch.serving.batcher import (DeadlineExceeded, MicroBatcher,
                                             Overloaded, PoolExhausted,
                                             batch_buckets)
from veles_tpu_torch.serving.faults import (FaultPlan, InjectedFault,
                                            InjectedHTTPError)
from veles_tpu_torch.serving.kv_pool import KVPagePool
from veles_tpu_torch.serving.lockcheck import (LockOrderViolation,
                                               LockOrderWitness)
from veles_tpu_torch.serving.lm_engine import (LMEngine, RadixPrefixCache,
                                               propose_draft)
from veles_tpu_torch.serving.metrics import (Histogram, ServingMetrics, get,
                                             render_prometheus)
from veles_tpu_torch.serving.router import (HealthChecker, NoLiveReplicas,
                                            Router, RouterMetrics,
                                            replica_device_slices)
from veles_tpu_torch.serving.slo import Objective, SLOMonitor
from veles_tpu_torch.serving.timeseries import (TimeSeriesStore,
                                                decode_flops_per_token,
                                                peak_flops_estimate,
                                                runtime_probe,
                                                telemetry_for)
from veles_tpu_torch.serving.tracing import (SpanTracer, TraceContext,
                                             cost_ledger, format_waterfall,
                                             verify_integrity)

__all__ = ["DeadlineExceeded", "FaultPlan", "HealthChecker", "Histogram",
           "InjectedFault",
           "InjectedHTTPError", "KVPagePool", "LMEngine", "LockOrderViolation",
           "LockOrderWitness", "MicroBatcher", "NoLiveReplicas", "Objective",
           "Overloaded", "PoolExhausted", "RadixPrefixCache", "Router",
           "RouterMetrics", "SLOMonitor", "ServingMetrics", "SpanTracer",
           "TimeSeriesStore", "TraceContext", "batch_buckets", "cost_ledger",
           "decode_flops_per_token", "format_waterfall", "get",
           "peak_flops_estimate", "propose_draft", "render_prometheus",
           "replica_device_slices", "runtime_probe", "telemetry_for",
           "verify_integrity"]
