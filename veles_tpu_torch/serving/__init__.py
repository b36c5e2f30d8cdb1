"""Serving tier of the port — the paged LM engine (with its radix prefix
cache and prompt-lookup drafts, hot weight swap and crash-safe
checkpoint/restore), the micro-batcher of the REST predict path, the
deterministic fault plans that arm their failure paths, and their
host-side bookkeeping (allocator, metrics, admission exceptions)."""

from veles_tpu_torch.serving.batcher import (DeadlineExceeded, MicroBatcher,
                                             Overloaded, PoolExhausted,
                                             batch_buckets)
from veles_tpu_torch.serving.faults import (FaultPlan, InjectedFault,
                                            InjectedHTTPError)
from veles_tpu_torch.serving.kv_pool import KVPagePool
from veles_tpu_torch.serving.lm_engine import (LMEngine, RadixPrefixCache,
                                               propose_draft)
from veles_tpu_torch.serving.metrics import (Histogram, ServingMetrics,
                                             render_prometheus)

__all__ = ["DeadlineExceeded", "FaultPlan", "Histogram", "InjectedFault",
           "InjectedHTTPError", "KVPagePool", "LMEngine", "MicroBatcher",
           "Overloaded", "PoolExhausted", "RadixPrefixCache",
           "ServingMetrics", "batch_buckets", "propose_draft",
           "render_prometheus"]
