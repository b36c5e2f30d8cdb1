"""Serving tier of the port — the paged LM engine (with its radix prefix
cache and prompt-lookup drafts), the micro-batcher of the REST predict
path, and their host-side bookkeeping (allocator, metrics, admission
exceptions)."""

from veles_tpu_torch.serving.batcher import (DeadlineExceeded, MicroBatcher,
                                             Overloaded, PoolExhausted,
                                             batch_buckets)
from veles_tpu_torch.serving.kv_pool import KVPagePool
from veles_tpu_torch.serving.lm_engine import (LMEngine, RadixPrefixCache,
                                               propose_draft)
from veles_tpu_torch.serving.metrics import (Histogram, ServingMetrics,
                                             render_prometheus)

__all__ = ["DeadlineExceeded", "Histogram", "KVPagePool", "LMEngine",
           "MicroBatcher", "Overloaded", "PoolExhausted", "RadixPrefixCache",
           "ServingMetrics", "batch_buckets", "propose_draft",
           "render_prometheus"]
