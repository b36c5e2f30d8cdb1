"""Dynamic micro-batching — coalesce concurrent requests into one call.

Port of ``veles_tpu/serving/batcher.py``.  The direct REST path pays one
forward per HTTP request, so concurrent clients on the
ThreadingHTTPServer serialize on the card.  :class:`MicroBatcher` puts a
bounded queue and a worker thread between the handler threads and the
forward:

- handler threads :meth:`~MicroBatcher.submit` their rows and block on a
  future;
- the worker drains whatever is queued (waiting ``batch_wait_s`` for
  stragglers while the batch is short), concatenates the rows, pads to
  the next power-of-two bucket, runs ONE forward, and scatters the
  result rows back to the futures.

Buckets keep the set of batch shapes the forward sees bounded
(log2(max_batch) of them) and are warmed at start.  Admission control is
explicit: a full queue raises :class:`Overloaded` (HTTP 429 +
``Retry-After`` upstream) and a request queued past its deadline is shed
with :class:`DeadlineExceeded` instead of wasting a forward on a client
that has long since timed out.

The forward takes numpy arrays and returns numpy arrays or tensors;
where its work runs (the CPU or the card) is its own affair.  It is user
code (REST's predict path and the exported program take numpy, and the
port has no process-wide default device), so unlike the reference's
batcher, which uploads the chunk itself, the port hands it the host
chunk; the call runs inside a declared ``xfer.boundary()`` and its
result is read back through ``xfer.to_host``.  With a transfer guard
armed on a machine with a card, each dispatch (never the wait for a
batch) runs under ``xfer.guard``.  ``faults=`` arms a
:class:`~veles_tpu_torch.serving.faults.FaultPlan`'s ``batcher.submit``
and ``batcher.dispatch`` sites (an injected dispatch error fails that
batch's clients, never the worker).  ``tracer=`` takes a
:class:`~veles_tpu_torch.serving.tracing.SpanTracer`: each request
roots a ``batch.request`` trace (or joins its caller's), its
``queue.wait`` span closes at dispatch (or with ``error="shed"``), and
one ``batch.dispatch`` span a forward is shared by the batch's items
under one dispatch id (``backend`` ``"forward"``: the caller's forward,
its result read back as numpy, so the span closes after its work).
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future

import numpy
import torch

from veles_tpu_torch.logger import Logger
from veles_tpu_torch.serving import lockcheck, tracing, xfer
from veles_tpu_torch.serving.metrics import ServingMetrics


class Overloaded(RuntimeError):
    """Admission refused: the queue is full (serve as HTTP 429)."""

    def __init__(self, retry_after=0.1):
        super().__init__("serving queue full, retry after %.3fs"
                         % retry_after)
        self.retry_after = retry_after


class PoolExhausted(Overloaded):
    """Admission refused on RESOURCE pressure, not queue length: the
    paged KV pool (serving/kv_pool.py) cannot cover the page demand
    already queued ahead of this request, so admitting it would only
    let it sit until its deadline.  An :class:`Overloaded` subclass —
    upstream handlers serve the same HTTP 429 + ``Retry-After`` — but
    distinguishable, so clients and tests can tell "queue full" from
    "KV memory full".  A request admitted BEFORE the pool tightened
    still queues (the engine retries its page reservation every tick)
    and sheds 503 at its deadline: pressure never wedges a lane."""

    def __init__(self, needed, budget, retry_after=0.25):
        RuntimeError.__init__(
            self, "kv page pool exhausted: request needs %d pages but "
                  "the queued demand already covers the %d-page budget; "
                  "retry after %.3fs" % (needed, budget, retry_after))
        self.needed = needed
        self.budget = budget
        self.retry_after = retry_after


class DeadlineExceeded(RuntimeError):
    """Request spent longer than its deadline queued (serve as 503)."""


class _Item:
    __slots__ = ("rows", "future", "t_enq", "deadline", "trace",
                 "tspan")

    def __init__(self, rows, deadline_s):
        self.rows = rows
        self.future = Future()
        self.t_enq = time.monotonic()
        self.deadline = self.t_enq + deadline_s
        #: tracing: request context + open queue-wait span
        self.trace = None
        self.tspan = None


def batch_buckets(max_batch):
    """The power-of-two bucket ladder up to (and including) max_batch."""
    buckets, b = [], 1
    while b < max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch)
    return buckets


class MicroBatcher(Logger):
    """Coalesce concurrent ``forward`` calls into padded batched calls.

    ``forward``: batch ndarray (b, *sample_shape) -> ndarray (b, ...);
    rows beyond the real count are zero padding and their outputs are
    discarded.  ``sample_shape`` (when known) lets :meth:`start` warm
    every bucket before traffic arrives.
    """

    def __init__(self, forward, max_batch=64, queue_depth=128,
                 batch_wait_s=0.002, deadline_s=2.0, sample_shape=None,
                 dtype=numpy.float32, metrics=None, name="predict",
                 faults=None, tracer=None):
        #: the armed fault plan (None: each site is one is-None check)
        self._faults = faults
        #: the span tracer (None: each site is one is-None check)
        self._tracer = tracer
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        self.name = name
        self.forward = forward
        self.max_batch = int(max_batch)
        self.buckets = batch_buckets(self.max_batch)
        self.queue_depth = int(queue_depth)
        self.batch_wait_s = float(batch_wait_s)
        self.deadline_s = float(deadline_s)
        #: guarded-by: _cond (the worker adopts it after a forward; the
        #: admission path reads it)
        self.sample_shape = (tuple(sample_shape)
                             if sample_shape is not None else None)
        self.dtype = dtype
        self.metrics = metrics or ServingMetrics(name)
        self._queue = collections.deque()       # guarded-by: _cond
        self._cond = lockcheck.make_condition("batcher._cond")
        self._thread = None
        self._stop = False                      # guarded-by: _cond
        #: EWMA of forward seconds — the Retry-After estimate
        self._dispatch_ewma = 0.05              # guarded-by: _cond

    # --------------------------------------------------------------- lifecycle
    def start(self):
        shape = self.sample_shape     # no worker thread exists yet
        if shape is not None:
            for b in self.buckets:
                self.forward(numpy.zeros((b,) + shape, self.dtype))
            self.debug("warmed %d batch buckets %s", len(self.buckets),
                       self.buckets)
        with self._cond:
            self._stop = False
        self._thread = threading.Thread(target=self._serve_batches,
                                        daemon=True,
                                        name="micro-batcher-%s" % self.name)
        self._thread.start()
        return self

    def stop(self):
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    # ------------------------------------------------------------------ client
    def submit(self, rows):
        """Block until ``rows`` (n, *sample) are served; returns the n
        output rows.  Raises :class:`Overloaded` when the queue is full
        and :class:`DeadlineExceeded` when the request was shed."""
        rows = numpy.asarray(rows, self.dtype)
        if rows.ndim < 1 or len(rows) < 1:
            raise ValueError("submit needs at least one row")
        if self._faults is not None:
            self._faults.fire("batcher.submit")
        tctx, own_root = None, False
        if self._tracer is not None:
            tctx, own_root = tracing.join_or_root(
                self._tracer, "batch.request", "batch",
                attrs={"engine": self.name})
            if tctx is tracing.SAMPLED_OUT:
                tctx = None
        try:
            item = self._admit(rows, tctx, own_root)
        except Exception as e:
            if own_root:
                tctx.tracer.finish_request(tctx, error=e)
            raise
        return item.future.result()

    def _admit(self, rows, tctx, own_root):
        with self._cond:
            if self._stop or self._thread is None:
                raise RuntimeError("micro-batcher is not running")
            # shape-check here, per request: one malformed request must
            # fail alone (400), never poison the batch it would have
            # been coalesced into.  The canonical shape comes from
            # warmup or is adopted after the first successful forward
            # (a bad first request must not poison the server either);
            # until then _take_batch keeps batches shape-homogeneous.
            if self.sample_shape is not None \
                    and rows.shape[1:] != self.sample_shape:
                raise ValueError(
                    "input rows shaped %r do not match the served "
                    "sample shape %r"
                    % (tuple(rows.shape[1:]), self.sample_shape))
            if len(self._queue) >= self.queue_depth:
                self.metrics.record_reject()
                raise Overloaded(retry_after=max(
                    0.01, self._dispatch_ewma))
            item = _Item(rows, self.deadline_s)
            if tctx is not None:
                item.trace = tctx
                item.tspan = tctx.tracer.begin(
                    tctx, "queue.wait", cat="queue",
                    attrs={"engine": self.name})
                if own_root:
                    item.future.add_done_callback(
                        lambda f, ctx=tctx:
                        tracing.finish_from_future(ctx, f))
            self._queue.append(item)
            self.metrics.record_enqueue()
            self.metrics.set_gauge("queue_depth", len(self._queue))
            self._cond.notify()
        return item

    # ------------------------------------------------------------------ worker
    def _take_batch(self):
        """Pop a coalescible batch: the oldest request plus whatever else
        fits within max_batch, lingering ``batch_wait_s`` for stragglers
        while short.  Returns (items, expired) — expired are already past
        their deadline and must be shed, not run."""
        items, expired, n = [], [], 0
        with self._cond:
            while not self._queue and not self._stop:
                self._cond.wait()
            if self._stop and not self._queue:
                return items, expired
            t_close = time.monotonic() + self.batch_wait_s
            while True:
                while self._queue and n < self.max_batch:
                    head = self._queue[0]
                    size = len(head.rows)
                    if items and n + size > self.max_batch:
                        break
                    if items and head.rows.shape[1:] != \
                            items[0].rows.shape[1:]:
                        # before a shape is adopted only: never coalesce
                        # mixed shapes — the odd one out runs alone and
                        # fails alone
                        break
                    self._queue.popleft()
                    if time.monotonic() > head.deadline:
                        expired.append(head)
                        continue
                    items.append(head)
                    n += size
                remaining = t_close - time.monotonic()
                if n >= self.max_batch or remaining <= 0 or self._stop:
                    break
                self._cond.wait(remaining)
            # shed every expired queued item at the batch boundary, not
            # only those this batch's pops happen to reach
            if self._queue:
                now = time.monotonic()
                if any(now > it.deadline for it in self._queue):
                    keep = collections.deque()
                    for it in self._queue:
                        (expired if now > it.deadline
                         else keep).append(it)
                    self._queue = keep
            self.metrics.set_gauge("queue_depth", len(self._queue))
        return items, expired

    def _dispatch(self, items):
        """Concatenate, pad to a bucket, forward once, scatter rows back.
        A single oversized request (rows > max_batch) is chunked over
        several max_batch forwards."""
        now = time.monotonic()
        for it in items:
            # close queue-wait spans BEFORE the fault site: an injected
            # dispatch error fails these clients, and their finished
            # trees must carry no unclosed spans
            if it.tspan is not None:
                it.trace.tracer.end(it.tspan, attrs={
                    "wait_s": round(now - it.t_enq, 6)})
                it.tspan = None
        if self._faults is not None:
            # inside the worker's dispatch try: an injected error takes
            # the real fault-isolation path
            self._faults.fire("batcher.dispatch")
        if lockcheck._witness is not None:
            lockcheck._witness.dispatch("batcher.dispatch")
        x = numpy.concatenate([it.rows for it in items]) \
            if len(items) > 1 else items[0].rows
        outs = []
        for lo in range(0, len(x), self.max_batch):
            chunk = x[lo:lo + self.max_batch]
            real = len(chunk)
            bucket = next(b for b in self.buckets if b >= real)
            if bucket > real:
                pad = numpy.zeros((bucket - real,) + chunk.shape[1:],
                                  chunk.dtype)
                chunk = numpy.concatenate([chunk, pad])
            t0 = time.monotonic()
            # the forward is user code whose transfers are its own: a
            # declared boundary, its result read back explicitly
            with xfer.boundary():
                out = xfer.to_host(self.forward(chunk))
            with self._cond:
                self._dispatch_ewma = (0.8 * self._dispatch_ewma
                                       + 0.2 * (time.monotonic() - t0))
            if self._tracer is not None:
                # xfer.to_host above read the result back: no fence
                self._tracer.add_many(
                    [it.trace for it in items], "batch.dispatch",
                    "batch", t0, time.monotonic(),
                    attrs={"rows": real, "bucket": bucket,
                           "backend": "forward"})
            outs.append(out[:real])
            # histogram the real coalesced rows, not the bucket padding
            self.metrics.record_dispatch(
                real, queue_waits=[now - it.t_enq for it in items]
                if lo == 0 else ())
        out = numpy.concatenate(outs) if len(outs) > 1 else outs[0]
        with self._cond:
            if self.sample_shape is None:
                # adopt the canonical shape only once the forward proved
                # it
                self.sample_shape = x.shape[1:]
        offset = 0
        for it in items:
            n = len(it.rows)
            it.future.set_result(out[offset:offset + n])
            offset += n

    def _serve_batches(self):   # hot-path
        # each dispatch runs under the transfer guard on a machine with
        # a card (the forward's device is the user's); the wait for a
        # batch does not: the guard's mode is process-wide
        card = "cuda" if torch.cuda.is_available() else "cpu"
        while True:
            items, expired = self._take_batch()
            for it in expired:
                self.metrics.record_shed()
                if it.tspan is not None:
                    it.trace.tracer.end(it.tspan, error="shed")
                    it.tspan = None
                it.future.set_exception(DeadlineExceeded(
                    "request shed after %.3fs in queue (deadline %.3fs)"
                    % (time.monotonic() - it.t_enq, self.deadline_s)))
            if not items:
                with self._cond:
                    stopping = self._stop
                if stopping:
                    return
                continue
            try:
                with xfer.guard(card):
                    self._dispatch(items)
            except Exception as e:   # noqa: BLE001 — delivered to clients
                self.metrics.record_error()
                self.warning("dispatch failed: %s", e)
                for it in items:
                    if not it.future.done():
                        it.future.set_exception(e)
