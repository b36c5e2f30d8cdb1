"""Paged KV-cache allocator — host-side page bookkeeping.

Port of ``veles_tpu/serving/kv_pool.py``: pure host integers, the same
semantics verbatim (scratch page 0, ref counts, pins, FIFO free list).

The memory half of the paged serving refactor: device KV storage is ONE
pool of fixed-size pages per transformer block (``(n_pages, kv_heads,
page, head_dim)``, see ``ops/attention.py::paged_view``), and THIS
class decides which lane (or prefix-cache entry) owns which page.  All
state is host-side integers — allocation never touches the device, so
a prefix-cache hit that installs page REFERENCES into a lane's page
table is zero-copy and zero-dispatch by construction (the contiguous
path's row-copy install, docs/PERF.md's "correctness crutch", simply
has no paged equivalent to pay).

Three invariants the engine leans on:

- REF-COUNTED sharing: a page lives until its last referent (lanes
  and/or the radix prefix cache) releases it; ``alloc`` never hands
  out a page with live references, so one lane's decode can never
  scribble on rows another lane still attends.
- PINS mark in-flight use: a lane pins every page in its table while
  active.  Pins don't keep a page alive (refs do) — they make
  "eviction" (the trie dropping its reference under pool pressure)
  refuse pages a lane still reads, and releasing a still-pinned page
  is an engine bug this class turns into a loud error instead of a
  silent use-after-free.
- COPY-ON-WRITE discipline: writers must own their page exclusively.
  :meth:`shared` is the check; the engine's write paths consult it and
  copy the page before appending — the OTHER referents keep the
  original rows bit-identical.

Single-threaded by design: every call happens on the engine worker
thread, so there is
no lock to contend on the per-token path.
"""

from __future__ import annotations

import collections


class KVPagePool:
    """Allocator over page ids ``1..num_pages`` (id 0 is the reserved
    SCRATCH page: free lanes park their page tables on it and warmup
    writes land there — it is never allocated, so its garbage content
    is never attended by a live mask)."""

    SCRATCH = 0

    #: the allocator is deliberately lock-free —
    #: every mutation happens on the engine worker thread (the engine
    #: lock is the module docstring's "single-threaded by design"
    #: rule), so the per-token path pays no contention.
    _synchronized_externally = "LMEngine worker thread (single owner)"

    def __init__(self, num_pages, page_size):
        if num_pages < 1:
            raise ValueError("kv pool needs at least one page")
        if page_size < 1:
            raise ValueError("page size must be >= 1")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._refs = [0] * (self.num_pages + 1)
        self._pins = [0] * (self.num_pages + 1)
        self._free = collections.deque(range(1, self.num_pages + 1))

    # ------------------------------------------------------------ queries
    @property
    def free_pages(self):
        return len(self._free)

    @property
    def used_pages(self):
        return self.num_pages - len(self._free)

    @property
    def pinned_pages(self):
        """Pages held by an active lane (the gauge /metrics exposes)."""
        return sum(1 for p in self._pins[1:] if p > 0)

    @property
    def occupancy(self):
        """Used fraction of the pool (0..1) — the resident-KV pressure
        signal behind the ``kv_pages_free``/``kv_pages_total`` gauges
        the serving router weighs when placing requests."""
        return self.used_pages / float(self.num_pages)

    def refs(self, page):
        return self._refs[page]

    def snapshot(self):
        """JSON-safe copy of the full allocator bookkeeping — what
        ``LMEngine.checkpoint`` embeds so a crash leaves a
        post-mortem record of who owned what."""
        return {"num_pages": self.num_pages,
                "page_size": self.page_size,
                "refs": list(self._refs),
                "pins": list(self._pins),
                "free": list(self._free)}

    def verify(self):
        """Self-consistency audit: the free list holds
        exactly the zero-ref pages (each once, never the scratch
        page), no negative counts, and no pinned page without a
        referent.  Raises RuntimeError naming the first violation;
        returns a summary dict when sound — the crash-recovery path
        runs this before re-admitting any work."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise RuntimeError("free list holds duplicate pages")
        if self.SCRATCH in free:
            raise RuntimeError("scratch page entered the free list")
        for p in range(1, self.num_pages + 1):
            refs, pins = self._refs[p], self._pins[p]
            if refs < 0 or pins < 0:
                raise RuntimeError(
                    "page %d has negative bookkeeping (refs=%d, "
                    "pins=%d)" % (p, refs, pins))
            if (refs == 0) != (p in free):
                raise RuntimeError(
                    "page %d refs=%d but free-list membership is %s "
                    "— leaked or double-freed" % (p, refs, p in free))
            if pins and not refs:
                raise RuntimeError(
                    "page %d pinned (%d) with no referent" % (p, pins))
        return {"free": len(free), "used": self.used_pages,
                "pinned": self.pinned_pages}

    def shared(self, page):
        """True when appending into ``page`` needs copy-on-write."""
        return self._refs[page] > 1

    # --------------------------------------------------------- allocation
    def alloc(self, n=1):
        """Take ``n`` pages (refs=1 each) — ALL-OR-NOTHING: returns the
        page-id list, or None leaving the pool untouched when fewer
        than ``n`` are free (the engine then presses the prefix cache
        for evictions or requeues the request; partial grants would
        strand pages on a request that cannot run)."""
        if n < 0:
            raise ValueError("alloc(%d)" % n)
        if len(self._free) < n:
            return None
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def retain(self, page):
        """One more referent (a sharing lane, or the prefix cache)."""
        if not 1 <= page <= self.num_pages or self._refs[page] < 1:
            raise RuntimeError("retain of unallocated page %d" % page)
        self._refs[page] += 1

    def release(self, page):
        """Drop one reference; the page returns to the free list at
        zero.  Returns True when this release freed it.  Releasing an
        unallocated page, or freeing one that is still PINNED, is an
        engine bug — fail loudly, never recycle rows a lane reads."""
        if not 1 <= page <= self.num_pages or self._refs[page] < 1:
            raise RuntimeError("release of unallocated page %d" % page)
        self._refs[page] -= 1
        if self._refs[page] == 0:
            if self._pins[page]:
                self._refs[page] += 1
                raise RuntimeError(
                    "page %d freed while still pinned by a lane" % page)
            self._free.append(page)
            return True
        return False

    # --------------------------------------------------------------- pins
    def pin(self, page):
        if not 1 <= page <= self.num_pages or self._refs[page] < 1:
            raise RuntimeError("pin of unallocated page %d" % page)
        self._pins[page] += 1

    def unpin(self, page):
        if self._pins[page] < 1:
            raise RuntimeError("unpin of unpinned page %d" % page)
        self._pins[page] -= 1

    def pinned(self, page):
        return self._pins[page] > 0
