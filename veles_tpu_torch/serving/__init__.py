"""Serving tier of the port — the paged LM engine (with its radix prefix
cache and prompt-lookup drafts, hot weight swap and crash-safe
checkpoint/restore), the micro-batcher of the REST predict path, the
deterministic fault plans that arm their failure paths, the span tracer
(flight recorder, Chrome-trace export, per-op cost ledger), the
time-series store and SLO burn-rate monitor over the serving metrics,
the lock-order witness and the transfer guard that check them at run
time, and their host-side bookkeeping (allocator, metrics, admission
exceptions)."""

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
from veles_tpu_torch.serving.slo import Objective, SLOMonitor
from veles_tpu_torch.serving.timeseries import (TimeSeriesStore,
                                                decode_flops_per_token,
                                                peak_flops_estimate,
                                                runtime_probe,
                                                telemetry_for)
from veles_tpu_torch.serving.tracing import (SpanTracer, TraceContext,
                                             cost_ledger, format_waterfall,
                                             verify_integrity)

__all__ = ["DeadlineExceeded", "FaultPlan", "Histogram", "InjectedFault",
           "InjectedHTTPError", "KVPagePool", "LMEngine", "LockOrderViolation",
           "LockOrderWitness", "MicroBatcher",
           "Objective", "Overloaded", "PoolExhausted", "RadixPrefixCache",
           "SLOMonitor", "ServingMetrics", "SpanTracer", "TimeSeriesStore",
           "TraceContext", "batch_buckets", "cost_ledger",
           "decode_flops_per_token", "format_waterfall", "get",
           "peak_flops_estimate", "propose_draft", "render_prometheus",
           "runtime_probe", "telemetry_for", "verify_integrity"]
