"""Serving tier of the port — the paged LM engine, the micro-batcher of
the REST predict path, and their host-side bookkeeping (allocator,
metrics, admission exceptions)."""

from veles_tpu_torch.serving.batcher import (DeadlineExceeded, MicroBatcher,
                                             Overloaded, PoolExhausted,
                                             batch_buckets)
from veles_tpu_torch.serving.kv_pool import KVPagePool
from veles_tpu_torch.serving.lm_engine import LMEngine
from veles_tpu_torch.serving.metrics import (Histogram, ServingMetrics,
                                             render_prometheus)

__all__ = ["DeadlineExceeded", "Histogram", "KVPagePool", "LMEngine",
           "MicroBatcher", "Overloaded", "PoolExhausted", "ServingMetrics",
           "batch_buckets", "render_prometheus"]
