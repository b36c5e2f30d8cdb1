"""Continuous LM decode — slot-based batching over one paged KV pool.

Port of ``veles_tpu/serving/lm_engine.py``, the paged greedy per-tick
engine.  :class:`LMEngine` keeps a fixed set of ``slots`` decode lanes
over one shared KV POOL per transformer block, (n_pages + 1, kv_heads,
page, head_dim) with page 0 the reserved scratch page, indexed through a
per-lane page table (``serving/kv_pool.py`` owns the bookkeeping):

- an arriving prompt RESERVES the pages its ``len(prompt) + n_new``
  span needs (a request the pool cannot cover waits at the queue head
  and is shed at its deadline) and runs as page-sized prompt chunks,
  one chunk per engine tick, interleaved with decode (chunked prefill —
  a long prompt never head-of-line-blocks the decode lanes);
- every tick advances ALL decode lanes by one token in ONE batched step
  through their page tables, each lane at its own position (free lanes
  step too, parked on the scratch page at position 0, so the step never
  respecializes on the active set); the table is sliced to the live
  width ladder (``_live_width``) so a step reads only the pages the
  batch occupies;
- a finished lane releases its pages and slot at once, and the next
  queued prompt takes them.

Two fast-path knobs, each leaving the greedy tokens unchanged:

- ``prefix_cache=N`` — a chunk-granular RADIX PREFIX CACHE
  (:class:`RadixPrefixCache`, N chunks) over prompt tokens.  A full
  prompt chunk already computed under the same token prefix is a page
  REFERENCE (ref count plus pin, no device work); a lane admitted
  beside a sibling prefilling the same prompt picks up its chunks as
  LATE HITS; entries are LRU-evicted leaf-first at capacity and under
  pool pressure (eviction releases the page).  Writers own their page
  exclusively: a write into a shared page copies it first
  (copy-on-write, one page-copy program).
- ``spec_k=K`` — PROMPT-LOOKUP SPECULATIVE DECODING: the lane's own
  prompt+output proposes up to K draft tokens (:func:`propose_draft`),
  verified for every lane in ONE batched dispatch of ``K + 1`` query
  rows (``paged_flash_decode`` with ``c = K + 1``); a draft token is
  accepted only where it equals the verifier's own argmax, then the
  correction or bonus token follows, so a dispatch yields 1 to K + 1
  greedy tokens a lane.

And one that changes only how often the host steps in:

- ``megastep=K`` (K >= 2) — the FUSED K-STEP DECODE: one program runs
  K decode iterations (or K propose → verify → accept iterations under
  ``spec_k``, the drafts found on the device by
  ``ops/transformer.py::propose_draft_in_graph``) for every lane, and
  the host works only at the boundaries (admission, prompt chunks,
  finishing, shedding).  A lane that finishes inside the program
  freezes: its writes go to the scratch page (``write_mask``) and its
  tokens read -1.  On the card the program is one CUDA graph per
  live-width ladder entry, captured at :meth:`start`; on the CPU the
  same body runs as a host loop of K iterations.
- ``megastep_mode="while"`` (``megastep="while"`` is K = 16) — the
  EARLY-EXIT form: K becomes a cap, and the program stops after the
  first iteration that leaves no lane live and no published ring entry
  unarmed.  With ``refill_ring=R`` up to R queued requests are
  prefilled into STANDBY lanes (:class:`_Standby`) outside the slot
  array while every slot is busy; each dispatch publishes the ready
  ones, and a slot that drains inside the program takes the next one
  in the same iteration (page-table row, frontier and history swapped
  in on the device).  On the card the K iterations are K conditional
  graph nodes (``csrc/graph_while.cu``), so the skipped ones cost one
  tiny launch each; on the CPU the host loop stops.

Attention runs through the hand-written Hopper kernels
(``ops/hopper_kernels.py``): the decode step through
``paged_flash_decode`` (the page table walked inside the kernel, no
gathered cache view) and the prompt chunk through
``paged_flash_prefill`` (history attended and the chunk's K/V installed
into its page by the same kernel).  There is no other route: on the
card every dispatch launches the kernels, and on the CPU
(``device="cpu"``) the same wrappers run their plain PyTorch versions.

Decoding is GREEDY by default — the same tokens as the reference's
``ops/transformer.py::generate`` and its paged engine on the same
weights, which is the serving contract.  ``temperature > 0`` (with
``top_k`` and a ``sample_seed``) SAMPLES instead, as the reference's
in-graph seeded sampling does: the token after position p of a request
is drawn under the key fold_in(fold_in(base, seed), p), with ``base``
the ``"lm-sample"`` stream's root key for ``sample_seed`` and ``seed``
the request's admission id, so the per-tick, chunked, speculative, scan
and while paths all draw the same token at the same position.  The
draw is one launch of ``hopper_kernels.sample_token`` (the keys made on
the device, inside the captured graphs too); greedy programs stay as
they were, with no key threaded.

Operations (the reference's crash-safe serving and hot weight swap):

- ``faults=`` takes a :class:`~veles_tpu_torch.serving.faults.FaultPlan`
  whose sites (``engine.submit``, ``engine.tick``, ``engine.chunk``,
  ``engine.cow``, ``engine.step``, ``engine.verify``, ``engine.swap``)
  sit where the reference's do; unarmed, each is one is-None check.
- ``tracer=`` takes a :class:`~veles_tpu_torch.serving.tracing.
  SpanTracer`: each request's ``engine.request`` root (or the caller's,
  joined), its ``queue.wait``, ``prefix.hit`` marks, every
  ``prefill.chunk`` (the standby ring's too), ``cow.copy``,
  ``decode.step`` / ``decode.verify``, ONE ``decode.megastep`` span a
  replay of a captured graph (or a while launch, with its realised
  ``iters``) shared by its lanes under one dispatch id, and the
  ``swap.apply`` / ``swap.refused`` events, with the reference's
  attributes (``backend`` names the kernel route: ``cuda``, or
  ``plain`` on the CPU).  The decode spans close after their read-back;
  the prompt chunk, page copy and swap apply run in place, so a traced
  one synchronizes the stream before its span closes — only when a
  sampled request takes part.  No span site sits inside a captured
  body; unarmed, each site is one is-None check.
- Every admitted request is JOURNALED until its future settles:
  :meth:`checkpoint` gives the reference's format-1 JSON (the unresolved
  requests, the slot frontiers, the pool's books, no tensors) and
  :meth:`restore` re-admits it into a fresh engine.
- :meth:`swap_weights` hot-installs a new tree of the same structure:
  staged on the caller's thread, applied by the worker at a tick
  boundary once the active lanes finish on the old weights (or, with
  ``drain=True``, after they and the standby ring are requeued whole);
  every result is stamped with the ``weights_version`` that served it.
  Unlike the reference's pointer assignment, the apply COPIES the new
  values into the live tensors in place, because the captured scan and
  while graphs read the weights by address; and it FLUSHES the prefix
  cache, whose pages hold K/V the old weights computed.

PyTorch idiom: the pools are updated IN PLACE (the reference threads
functional pool copies through each jitted program), the programs are
plain methods run eagerly, and the worker thread enters
``torch.inference_mode()`` itself (grad mode is thread-local).

Knobs of the reference engine that this port does not carry yet raise
``NotImplementedError`` naming the ROADMAP item that will port them.
"""

from __future__ import annotations

import collections
import functools
import gc
import threading
import time
from concurrent.futures import Future

import numpy
import torch

from veles_tpu_torch import prng
from veles_tpu_torch.device import resolve_device
from veles_tpu_torch.logger import Logger
from veles_tpu_torch.ops import functional as F
from veles_tpu_torch.ops.hopper_kernels import serving_kernels_supported
from veles_tpu_torch.ops.transformer import (TransformerLM, head_logits,
                                             paged_chunk_apply,
                                             params_from_jax,
                                             propose_draft_in_graph,
                                             tree_map)
from veles_tpu_torch.serving import lockcheck, tracing, xfer
from veles_tpu_torch.serving.batcher import (DeadlineExceeded, Overloaded,
                                             PoolExhausted)
from veles_tpu_torch.serving.kv_pool import KVPagePool
from veles_tpu_torch.serving.metrics import ServingMetrics

#: where each unported knob of the reference engine is queued
_ROADMAP = {
    "tp": "Queue 1 item 4 (tensor-parallel serving)",
    "devices": "Queue 1 item 4 (tensor-parallel serving)",
    "paged_kv": "Queue 1 item 8 (contiguous KV layout)",
}


def _unported(knob):
    return NotImplementedError(
        "LMEngine %s is not ported yet: ROADMAP %s" % (knob, _ROADMAP[knob]))


def _owned_tree(params, device):
    """``params`` (the reference's portable tree, a tree of tensors, or a
    :class:`TransformerLM`) as a tree of tensors on ``device`` that the
    engine OWNS: a swap copies into the live tree in place, so no leaf
    may share memory with the caller's.  Only a leaf that would is
    cloned: on the CPU ``params_from_jax`` shares a numpy array's
    memory, and a tensor already on the device comes back as itself;
    anything else it copied onto the device already."""
    if isinstance(params, TransformerLM):
        params = params.tree()

    def own(src, t):
        shared = t.device.type == "cpu" or t is src
        return t.detach().clone() if shared else t.detach()
    return tree_map(own, params, params_from_jax(params, device))


def _leaf_specs(tree, path=""):
    """``{path: (shape, dtype)}`` for the leaves of a param tree of
    tensors, keyed by path, so two trees compare equal whatever order
    their dicts hold their keys in."""
    if isinstance(tree, dict):
        items = (("%s[%r]" % (path, k), v) for k, v in tree.items())
    elif isinstance(tree, (list, tuple)):
        items = (("%s[%d]" % (path, i), v) for i, v in enumerate(tree))
    else:
        return {path: (tuple(tree.shape), tree.dtype)}
    return {p: spec for sub, v in items
            for p, spec in _leaf_specs(v, sub).items()}


def propose_draft(history, k, max_ngram=3):
    """Prompt-lookup draft: find the most recent earlier occurrence of
    the sequence's final n-gram (n = ``max_ngram`` down to 1) and
    propose the (up to ``k``) tokens that followed it.  Returns (m,)
    int32 with 1 <= m <= k — exactly the continuation found, unpadded,
    so callers can meter real draft tokens — or None when no n-gram
    recurs.

    Draft quality only affects SPEED: the verifier accepts a draft
    token only when it equals its own greedy argmax."""
    history = numpy.asarray(history, numpy.int32).reshape(-1)
    n = len(history)
    for g in range(min(max_ngram, n - 1), 0, -1):
        # candidate windows END strictly before the final position (the
        # tail is not a match for itself)
        tail = history[n - g:]
        windows = numpy.lib.stride_tricks.sliding_window_view(
            history[:n - 1], g)
        hits = numpy.flatnonzero((windows == tail).all(axis=1))
        if not len(hits):
            continue
        s = int(hits[-1])               # most recent occurrence
        cont = history[s + g:s + g + k]
        if len(cont):
            return numpy.asarray(cont, numpy.int32)
    return None


class _PrefixNode:
    __slots__ = ("key", "rows", "children", "refs", "last_use", "parent")

    def __init__(self, key, rows, parent):
        self.key = key                # tuple of the chunk's tokens
        self.rows = rows              # the page id holding its K/V
        self.children = {}
        self.refs = 0
        self.last_use = 0
        self.parent = parent


class RadixPrefixCache:
    """Radix trie over prompt tokens at CHUNK granularity.

    A node stands for exactly ``chunk`` tokens at absolute positions
    [depth·chunk, (depth+1)·chunk): their K/V rows are valid for ANY
    prompt sharing that token prefix, because causal attention makes a
    position's K/V depend only on the tokens at and before it.  Keys
    are the chunk's literal tokens, so two prompts diverging mid-chunk
    have different keys and never share a chunk.

    Entries are PINNED (ref-counted) while a lane uses them and
    LRU-evicted leaf-first at ``capacity`` chunks.  Every call runs on
    the engine's worker thread — no locking.

    ``rows`` is opaque to the trie; the engine stores a PAGE ID, and
    ``on_evict(rows)`` — the pool's ``release`` — fires whenever an
    entry is dropped, so eviction IS the pool's reclamation path under
    pressure (pinned entries refusing eviction keep lane-held pages
    safe)."""

    def __init__(self, capacity, chunk, on_evict=None):
        if capacity < 1:
            raise ValueError("prefix cache capacity must be >= 1")
        self.capacity = int(capacity)
        self.chunk = int(chunk)
        self.on_evict = on_evict
        self.root = _PrefixNode(None, None, None)
        self.size = 0
        self._tick = 0

    def match(self, keys):
        """Longest cached prefix along ``keys`` (chunk-token tuples);
        returns the matched nodes in order, each pinned — pass them to
        :meth:`release` when the lane finishes."""
        self._tick += 1
        node, out = self.root, []
        for key in keys:
            child = node.children.get(key)
            if child is None:
                break
            child.refs += 1
            child.last_use = self._tick
            out.append(child)
            node = child
        return out

    def insert(self, parent, key, rows):
        """Add one computed chunk under ``parent`` (root or the lane's
        previous node); returns the PINNED node — an existing node is
        reused (first writer wins; identical content by construction) —
        or None when every entry is pinned and nothing can be evicted."""
        self._tick += 1
        node = parent.children.get(key)
        if node is None:
            while self.size >= self.capacity:
                if not self._evict_one():
                    return None
            node = _PrefixNode(key, rows, parent)
            parent.children[key] = node
            self.size += 1
        node.refs += 1
        node.last_use = self._tick
        return node

    def lookup_child(self, parent, key):
        """The one-chunk extension of ``parent`` by ``key``, PINNED, or
        None.  Asked per pending chunk right before computing it: a
        sibling lane prefilling the same prompt may have inserted the
        chunk since this lane was admitted (a LATE HIT), so concurrent
        shared-prefix arrivals converge on one prefill."""
        node = parent.children.get(key)
        if node is None:
            return None
        self._tick += 1
        node.refs += 1
        node.last_use = self._tick
        return node

    def release(self, nodes):
        for node in nodes:
            node.refs -= 1

    def evict_one(self):
        """Drop the LRU unpinned leaf now (pool-pressure reclamation).
        Returns True when an entry was dropped."""
        return self._evict_one()

    def evictable(self):
        """Upper bound on the entries eviction can reclaim: the
        UNPINNED count (an unpinned interior node above a pinned child
        is counted but unreachable; lanes pin whole root-anchored
        paths).  Checked BEFORE evicting, so a hopeless reservation
        cannot flush the whole cache for nothing."""
        count, stack = 0, [self.root]
        while stack:
            for child in stack.pop().children.values():
                if child.refs == 0:
                    count += 1
                stack.append(child)
        return count

    def live_pins(self):
        """Total outstanding pin count across the trie — 0 whenever no
        lane is active (a nonzero value at idle means a path forgot to
        release a lane's pins)."""
        total, stack = 0, [self.root]
        while stack:
            for child in stack.pop().children.values():
                total += child.refs
                stack.append(child)
        return total

    def _evict_one(self):
        """Evict the least-recently-used unpinned LEAF (interior nodes
        keep their children's prefix reachable; they become leaves —
        and evictable — once their subtree ages out)."""
        best = None
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            elif node.refs == 0 and (best is None
                                     or node.last_use < best.last_use):
                best = node
        if best is None:
            return False
        del best.parent.children[best.key]
        self.size -= 1
        if self.on_evict is not None:
            self.on_evict(best.rows)
        return True


class _Request:
    __slots__ = ("prompt", "true_len", "n_new", "future", "t_enq",
                 "deadline", "cancelled", "pages", "t_first", "seed",
                 "trace", "tspan")

    def __init__(self, prompt, n_new, deadline_s, pages=0):
        self.prompt = prompt          # (s,) int32, unpadded
        self.true_len = len(prompt)
        self.n_new = n_new
        self.future = Future()
        self.future.request = self    # cancellation handle
        self.t_enq = time.monotonic()
        self.deadline = self.t_enq + deadline_s
        self.cancelled = False
        #: worst-case page demand (admission reservation)
        self.pages = pages
        #: when the first token came out (time-to-first-token)
        self.t_first = None
        #: the sampling lane seed: the admission id
        self.seed = 0
        #: tracing: the request's TraceContext (None: not traced) and
        #: its open queue-wait span
        self.trace = None
        self.tspan = None


class _Slot:
    """Host-side lane state; device state lives in the shared pools."""

    __slots__ = ("request", "emitted", "remaining", "pending", "pinned",
                 "cursor", "pages")

    def __init__(self, request):
        self.request = request
        self.emitted = []
        self.remaining = request.n_new
        #: chunked prefill still to run: [(tokens (C,), start, is_tail)]
        self.pending = []
        #: prefix-cache nodes pinned by this lane (released at finish)
        self.pinned = []
        #: trie node of the last matched/inserted chunk (None once the
        #: cache refused an insert — this lane's path stops extending)
        self.cursor = None
        #: page ids backing this lane's table row, in lane-local order
        self.pages = []


class _Standby:
    """One standby-ring entry: a lane prefilled on the host OUTSIDE the
    slot array, waiting to be published into the while megastep's
    inputs so that a slot draining inside the program takes it there.
    It owns its pages (reserved and pinned as a lane's are, never
    shared) and its request's first token is already out: the entry is
    admitted work, never shed at its deadline."""

    __slots__ = ("lane", "table", "pos", "last", "ready")

    def __init__(self, lane, table):
        self.lane = lane
        #: (max_pages,) int32 page-table row backing this entry
        self.table = table
        #: decode frontier after the last prompt chunk run
        self.pos = 0
        self.last = 0
        #: tail chunk done: publishable into the program's inputs
        self.ready = False


class LMEngine(Logger):
    """Slot-based continuous batching over ``params`` — the reference's
    portable param tree (nested dicts of numpy arrays), the same tree
    of tensors, or a :class:`TransformerLM` — on ``device`` (None = the
    CUDA card; raises without one; ``"cpu"`` runs the plain versions of
    the kernels).

    One worker thread owns the device state; clients :meth:`submit`
    single prompts (or :meth:`generate` a batch) and block on futures.
    ``max_len`` pins the lane span: every request must satisfy
    ``len(prompt) + n_new + spec_k <= max_len`` (a verify dispatch
    writes up to ``spec_k`` positions past the committed front).
    ``paged_kv=True`` sizes the pool at ``slots × max_len / page``
    pages, an int sets it; the page is ``prefill_chunk`` tokens
    (default the largest divisor of ``max_len`` up to 32).
    ``prefix_cache=N`` keeps up to N prompt chunks in the radix prefix
    cache; ``spec_k=K`` verifies prompt-lookup drafts of up to K tokens
    found by matching ``spec_ngram``-grams.  ``megastep=K`` (K >= 2)
    fuses K decode iterations into one program (``megastep_mode``
    ``"scan"``, the default; 0 and 1 keep the per-tick path);
    ``megastep_mode="while"`` (or ``megastep="while"``, K = 16) exits
    the program once nothing is left live, and ``refill_ring=R`` then
    keeps R prefilled standby lanes that re-arm drained slots inside
    it.
    ``queue_tokens=T`` budgets admission by queued prompt tokens.
    ``faults`` arms a :class:`~veles_tpu_torch.serving.faults.FaultPlan`'s
    ``engine.*`` sites; ``tracer`` a
    :class:`~veles_tpu_torch.serving.tracing.SpanTracer`'s spans;
    ``version`` is the first ``weights_version``.
    ``temperature > 0`` samples (``top_k`` > 0 keeps the k most likely
    tokens, ties at the cutoff included) under ``sample_seed``, which it
    needs; 0 decodes greedily.
    Attention always runs through the kernel wrappers; a geometry they
    cannot carry raises ValueError here.
    """

    #: the CROSS-THREAD state — client admission vs the worker loop —
    #: lives under ``_cond``; everything else is owned by the worker
    _guarded_by = {
        "_queue": "_cond",
        "_rid": "_cond",
        "_queued_tokens": "_cond",
        "_queued_pages": "_cond",
        "_journal": "_cond",
        "_pending_swap": "_cond",
        "_stop": "_cond",
    }

    def __init__(self, params, n_heads, max_len, slots=4, rope=False,
                 window=None, sinks=0, queue_depth=64, deadline_s=30.0,
                 metrics=None, name="lm", prefill_chunk=0,
                 prefix_cache=0, spec_k=0, spec_ngram=3, queue_tokens=0,
                 paged_kv=True, tp=0, devices=None, faults=None,
                 version=0, tracer=None, megastep=0, megastep_mode=None,
                 refill_ring=0, temperature=0.0, top_k=0, sample_seed=None,
                 device=None):
        if megastep == "while":
            # the while mode's shorthand: K = 16 as its iteration cap
            megastep, megastep_mode = 16, "while"
        if megastep_mode not in (None, "scan", "while"):
            raise ValueError("megastep_mode must be 'scan' or 'while' "
                             "(got %r)" % (megastep_mode,))
        for knob, value in (("tp", tp), ("devices", devices)):
            if value:
                raise _unported(knob)
        #: the armed fault plan (None: every site is one is-None check)
        self._faults = faults
        #: the span tracer (None: every site is one is-None check)
        self._tracer = tracer
        #: seeded sampling: temperature > 0 draws each token under a key
        #: of (lane seed, position); 0 keeps the greedy argmax programs
        self.temperature = float(temperature or 0.0)
        self.top_k = int(top_k or 0)
        if self.temperature < 0 or self.top_k < 0:
            raise ValueError("temperature and top_k must be >= 0")
        self._sampling = self.temperature > 0
        if self._sampling and sample_seed is None:
            raise ValueError("temperature > 0 needs sample_seed — "
                             "seeded reproducibility is the contract")
        self.sample_seed = (None if sample_seed is None
                            else int(sample_seed))
        #: the draws' base key: a FIXED stream name, so sampled tokens
        #: depend on sample_seed alone, never on the engine's name
        self._sample_key = (prng.RandomGenerator(
            "lm-sample", self.sample_seed).base_key()
            if self._sampling else None)
        if not paged_kv:
            raise _unported("paged_kv")
        #: fused decode: K >= 2 iterations a dispatch; 0 and 1 are the
        #: per-tick path, and no fused program is built
        self.megastep = int(megastep or 0)
        self.megastep_mode = megastep_mode or "scan"
        if self.megastep < 0:
            raise ValueError("megastep must be >= 0 (got %d)"
                             % self.megastep)
        if self.megastep_mode == "while" and self.megastep < 2:
            raise ValueError("megastep_mode='while' needs megastep >= 2 "
                             "(the iteration cap)")
        #: standby refill ring: prefilled lanes the while program
        #: re-arms drained slots from
        self.refill_ring = int(refill_ring or 0)
        if self.refill_ring < 0:
            raise ValueError("refill_ring must be >= 0 (got %d)"
                             % self.refill_ring)
        if self.refill_ring and self.megastep_mode != "while":
            raise ValueError("refill_ring needs paged_kv and "
                             "megastep_mode='while' (the ring is "
                             "published into the while program's inputs "
                             "as page-table rows)")
        if slots < 1:
            raise ValueError("slots must be >= 1")
        self.name = name
        self.device = resolve_device(device)
        #: the traced device spans' ``backend``: the kernels' route
        self._backend = "cuda" if self.device.type == "cuda" else "plain"
        self.n_heads = int(n_heads)
        self.max_len = int(max_len)
        self.slots = int(slots)
        self.rope = bool(rope)
        self.window = window
        self.sinks = int(sinks)
        self.queue_depth = int(queue_depth)
        self.deadline_s = float(deadline_s)
        self.queue_tokens = int(queue_tokens)
        if not prefill_chunk:
            # the page size must divide max_len — default to the
            # largest divisor up to 32
            prefill_chunk = min(32, self.max_len)
            while self.max_len % prefill_chunk:
                prefill_chunk -= 1
        self.prefill_chunk = int(prefill_chunk)
        self.spec_k = int(spec_k)
        self.spec_ngram = int(spec_ngram)
        if self.prefill_chunk < 0 or self.prefill_chunk > self.max_len:
            raise ValueError("prefill_chunk %d out of range (max_len %d)"
                             % (self.prefill_chunk, self.max_len))
        if self.spec_k < 0 or self.spec_k + 1 >= self.max_len:
            raise ValueError("spec_k %d out of range (max_len %d)"
                             % (self.spec_k, self.max_len))
        if self.spec_k and self.spec_k + 1 > self.prefill_chunk:
            # a prefilling lane parks its step position at the chunk
            # frontier; its next chunk overwrites the verify dispatch's
            # k+1 garbage writes only when they fit inside one chunk
            raise ValueError("spec_k + 1 (%d) must not exceed "
                             "prefill_chunk (%d)"
                             % (self.spec_k + 1, self.prefill_chunk))
        if self.spec_ngram < 1:
            raise ValueError("spec_ngram must be >= 1")
        if self.max_len % self.prefill_chunk:
            # the paged lane view must tile max_len exactly, and the
            # chunk program relies on page-aligned starts
            raise ValueError(
                "paged_kv needs max_len (%d) divisible by the page size "
                "(prefill_chunk, %d)" % (self.max_len, self.prefill_chunk))
        self.metrics = metrics or ServingMetrics(name)
        self.metrics.set_gauge("slots_total", self.slots)
        self.metrics.set_gauge("slots_busy", 0)
        #: the checkpoint generation serving; stamped on every result
        self.weights_version = int(version)
        self.metrics.set_gauge("weights_version", self.weights_version)
        #: the swap_weights request the worker applies at a tick
        #: boundary (None almost always)
        self._pending_swap = None

        if F.get_matmul_precision() == "float32":
            # the parity mode: fp32 products stay fp32 in cuBLAS/cuDNN
            F.pin_fp32_matmul()
        self.params = _owned_tree(params, self.device)
        embed = self.params["embed"]
        d_model = embed.shape[1]
        if self.top_k > embed.shape[0]:
            raise ValueError("top_k %d out of range (vocab %d)"
                             % (self.top_k, embed.shape[0]))
        head_dim = d_model // self.n_heads
        kv_heads = self.params["blocks"][0]["attn"]["wk"].shape[1] \
            // head_dim

        ok, reason = serving_kernels_supported(
            True, self.n_heads, kv_heads, head_dim, self.prefill_chunk)
        if not ok:
            raise ValueError("the serving kernels cannot carry this "
                             "engine: %s" % reason)

        self._max_pages = self.max_len // self.prefill_chunk
        # decode table-width ladder: a step only needs pages up to the
        # batch's live frontier — the table is sliced to the smallest
        # power-of-two width covering every lane
        self._width_ladder = []
        w = 1
        while w < self._max_pages:
            self._width_ladder.append(w)
            w *= 2
        self._width_ladder.append(self._max_pages)
        num_pages = (self.slots * self._max_pages
                     if paged_kv is True else int(paged_kv))
        if num_pages < 1:
            raise ValueError("paged_kv pool must hold >= 1 page")
        self._pool = KVPagePool(num_pages, self.prefill_chunk)
        pool_shape = (num_pages + 1, kv_heads, self.prefill_chunk,
                      head_dim)              # +1: the scratch page
        self._kv_pools = [
            (torch.zeros(pool_shape, dtype=embed.dtype, device=self.device),
             torch.zeros(pool_shape, dtype=embed.dtype, device=self.device))
            for _ in self.params["blocks"]]
        self._page_tables = numpy.zeros((self.slots, self._max_pages),
                                        numpy.int32)
        self.metrics.set_gauge("kv_pages_total", num_pages)
        #: the trie's entries hold page references; evicting one
        #: releases its page
        self._trie = (RadixPrefixCache(prefix_cache, self.prefill_chunk,
                                       on_evict=self._pool.release)
                      if prefix_cache else None)
        #: per-slot device-facing scalars, host-owned between ticks
        self._pos = numpy.zeros(self.slots, numpy.int32)
        self._last = numpy.zeros(self.slots, numpy.int32)
        self._lanes = [None] * self.slots
        self._free = list(range(self.slots))
        #: the standby ring (``refill_ring``), in arrival order
        self._ring = []

        self._queue = collections.deque()
        #: admission ids, in submission order (the sampling lane seeds)
        self._rid = 0
        #: the admission journal: rid -> _Request for every request not
        #: resolved yet (what :meth:`checkpoint` snapshots)
        self._journal = {}
        self._queued_tokens = 0
        self._queued_pages = 0
        self._pool_blocked = False
        #: the fused programs, one a ladder width ({w: callable}, built
        #: by :meth:`start`); None without ``megastep``
        self._megastep_programs = None
        #: kernel launches a replay of each width's graph, and the
        #: seconds each capture took (the card only)
        self.megastep_launches = {}
        self.megastep_capture_s = {}
        #: the card's while programs ({w: compiled.WhileGraph})
        self._while_graphs = {}
        if self.megastep >= 2:
            self._megastep_buffers()
        self._cond = lockcheck.make_condition("lm_engine._cond")
        self._thread = None
        self._stop = False
        self._update_pool_gauges()

    def _fault(self, site):
        """Fault-injection hook: free when no plan is attached — one
        attribute-is-None check on the hot path.  The lock-order witness
        piggybacks here: every dispatch-class site doubles as a
        lock-held-across-dispatch probe, one module-global None-check
        when unarmed."""
        if self._faults is not None:
            self._faults.fire(site)
        if lockcheck._witness is not None:
            lockcheck._witness.dispatch(site)

    # -------------------------------------------------------------- tracing
    def _tfence(self, traced=True):
        """Dispatch fencing: the prompt chunk, the page copy and the swap
        apply return before the card finishes them, so a traced span
        synchronizes the current stream — the one every program runs on
        — before it closes, to time the card's work and not its
        enqueue.  Only when tracing is armed AND the dispatch serves a
        sampled request (``traced``); the CPU has nothing to wait for,
        but reports the fence to the lock-order witness all the same.
        The synchronize is a declared transfer boundary.  The decode
        paths read their output back and need no fence."""
        if self._tracer is not None and traced:
            if lockcheck._witness is not None:
                lockcheck._witness.dispatch("engine.fence")
            if self.device.type == "cuda":
                with xfer.boundary():
                    torch.cuda.current_stream(self.device).synchronize()

    def _trace_admitted(self, req):
        """Close the request's queue-wait span at slot assignment."""
        if req.tspan is not None:
            req.trace.tracer.end(req.tspan, attrs={
                "wait_s": round(time.monotonic() - req.t_enq, 6)})
            req.tspan = None

    def _trace_queue_end(self, req, error):
        """Close the queue-wait span on a non-admission exit (shed,
        cancel, stop) so the finished tree carries no unclosed spans."""
        if req.tspan is not None:
            req.trace.tracer.end(req.tspan, error=error)
            req.tspan = None

    # ------------------------------------------------------------- programs
    def _tensor(self, arr):
        """One host int32 array (or int) on the engine's device, through
        the explicit upload."""
        return xfer.to_device(arr, numpy.int32, self.device)

    def _pick(self, logits, seeds, pos):
        """The token after each row of ``logits`` (slots, c, vocab) or
        (slots, vocab), fed at ``pos`` (slots,) by lanes of sampling
        seed ``seeds`` (slots,): the greedy argmax, or with
        ``temperature`` the seeded draw — row (s, j) at position
        pos[s] + 1 + j under lane s's seed, one launch of
        ``hopper_kernels.sample_token`` with the keys made on the
        device.  int32, the rows' shape."""
        if not self._sampling:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        from veles_tpu_torch.ops import hopper_kernels as HK
        if logits.dim() == 3:
            c = logits.shape[1]
            cols = torch.arange(1, c + 1, dtype=torch.int32,
                                device=pos.device)
            seeds = seeds[:, None].expand(-1, c).contiguous()
            at = (pos[:, None] + cols).contiguous()
        else:
            at = pos + 1
        return HK.sample_token(logits.contiguous(), self.temperature,
                               self._sample_key, self.top_k, seeds, at)

    def _chunk_program(self, ptab_row, tokens, start, last_idx, seed=0):
        """One lane's prompt chunk through its page table (the K/V rows
        land in the pools); returns the pick after chunk offset
        ``last_idx`` as a device scalar (read on the tail chunk only;
        sampled under the lane's ``seed``)."""
        h, _ = paged_chunk_apply(
            self.params, self._tensor(tokens[None]), self._kv_pools,
            self._tensor(ptab_row[None]), self._tensor([start]),
            self.n_heads, rope=self.rope, window=self.window,
            sinks=self.sinks, attn_kernel="prefill")
        logits = head_logits(self.params, h[:, last_idx])
        if not self._sampling:
            return torch.argmax(logits[0])
        # the pick after position start + last_idx
        keys = self._tensor([seed, start + last_idx])
        return self._pick(logits, keys[:1], keys[1:])[0]

    def _seeds(self, active):
        """(slots,) host int32: each ``active`` slot's lane seed, 0
        elsewhere (a free or prefilling slot's pick is discarded)."""
        seeds = numpy.zeros(self.slots, numpy.int32)
        for slot in active:
            seeds[slot] = self._lanes[slot].request.seed
        return seeds

    def _seed_args(self, active):
        """The trailing seed argument of a batched program call: empty
        when greedy, so the greedy calls stay exactly as they were."""
        return (self._seeds(active),) if self._sampling else ()

    def _lane_seed(self, req):
        """The trailing seed argument of a prompt-chunk call."""
        return (req.seed,) if self._sampling else ()

    def _seed_buffer(self, bufs):
        """The trailing seed argument of an iteration inside the fused
        program: the seeds buffer of ``bufs`` when sampling."""
        return (bufs["seeds"],) if self._sampling else ()

    def _step_program(self, ptabs, toks, pos, seeds=None):
        """ONE dispatch advances every lane by one token at its own
        position through its own page table; returns (slots,) picks as
        a host array (sampled under ``seeds``, zeros when None)."""
        at = self._tensor(pos)
        h, _ = paged_chunk_apply(
            self.params, self._tensor(toks)[:, None], self._kv_pools,
            self._tensor(ptabs), at, self.n_heads,
            rope=self.rope, window=self.window, sinks=self.sinks,
            attn_kernel="decode")
        return self._host_picks(head_logits(self.params, h[:, 0]), seeds, at)

    def _verify_program(self, ptabs, toks, pos, seeds=None):
        """ONE dispatch feeds every lane's (k+1,) tokens — [last
        committed, draft...] — at its own position (one
        ``paged_flash_decode`` launch a layer with ``c = k + 1`` query
        rows); returns the (slots, k+1) picks AFTER each fed position
        as a host array (sampled under ``seeds``, zeros when None)."""
        at = self._tensor(pos)
        h, _ = paged_chunk_apply(
            self.params, self._tensor(toks), self._kv_pools,
            self._tensor(ptabs), at, self.n_heads,
            rope=self.rope, window=self.window, sinks=self.sinks,
            attn_kernel="decode")
        # logits (slots, k+1, vocab)
        return self._host_picks(head_logits(self.params, h), seeds, at)

    def _host_picks(self, logits, seeds, at):
        """:meth:`_pick` of a per-tick program's logits, read back: the
        host ``seeds`` (zeros when None) uploaded when sampling."""
        if self._sampling:
            seeds = self._tensor(numpy.zeros(self.slots, numpy.int32)
                                 if seeds is None else seeds)
        return xfer.to_host(self._pick(logits, seeds, at))

    def _page_copy_program(self, src, dst):
        """Copy-on-write: duplicate page ``src`` into ``dst`` in every
        block's K and V pool (in place), so the writer owns ``dst``
        exclusively and the other referents of ``src`` keep
        bit-identical rows."""
        for kp, vp in self._kv_pools:
            kp[dst].copy_(kp[src])
            vp[dst].copy_(vp[src])

    # ------------------------------------------------------------ megastep
    def _megastep_buffers(self):
        """The fused program's static inputs and packed output: one
        int32 staging buffer the host fills (pinned on the card), its
        device copy the program reads — page table (slots, max_pages),
        ``last``, ``pos``, ``left`` and with ``spec_k`` the token
        history (slots, max_len) and its lengths, when sampling the
        lanes' seeds; in the while mode with
        a ring also the published entries' rows of the same (R of each,
        zero-padded, padding tables on the scratch page) and their
        ``count`` — and one host buffer the program's output is read
        back into."""
        S, K, k = self.slots, self.megastep, self.spec_k
        R, M, L = self.refill_ring, self._max_pages, self.max_len
        sizes = [("ptab", (S, M)), ("last", (S,)), ("pos", (S,)),
                 ("left", (S,))]
        if k:
            sizes += [("hist", (S, L)), ("hlen", (S,))]
        if self._sampling:
            sizes.append(("seeds", (S,)))
        if R:
            sizes += [("ring_tab", (R, M)), ("ring_last", (R,)),
                      ("ring_pos", (R,)), ("ring_left", (R,))]
            if k:
                sizes += [("ring_hist", (R, L)), ("ring_hlen", (R,))]
            if self._sampling:
                sizes.append(("ring_seeds", (R,)))
            sizes.append(("count", (1,)))
        total = sum(int(numpy.prod(shape)) for _, shape in sizes)
        card = self.device.type == "cuda"
        self._ms_stage = torch.zeros(total, dtype=torch.int32,
                                     pin_memory=card)
        self._ms_in = (self._ms_stage.to(self.device) if card
                       else self._ms_stage)
        self._ms_host, self._ms_dev, at = {}, {}, 0
        stage_np = self._ms_stage.numpy()
        for name, shape in sizes:
            n = int(numpy.prod(shape))
            self._ms_host[name] = stage_np[at:at + n].reshape(shape)
            self._ms_dev[name] = self._ms_in[at:at + n].view(shape)
            at += n
        # packed output: last, pos, emitted (K, S, k+1 or 1), accs (K, S),
        # and in the while mode iters (1) and assign (R)
        size = 2 * S + K * S * (k + 1) + (K * S if k else 0)
        if self.megastep_mode == "while":
            size += 1 + R
            self._while_state(size)
        self._ms_out = torch.zeros(size, dtype=torch.int32,
                                   pin_memory=card)

    def _while_state(self, size):
        """The while program's state on the engine's device, allocated
        once and updated IN PLACE by every piece of the program (a
        skipped iteration on the card writes nothing, so nothing may
        live in memory a piece allocates): the carry — the page table
        (a flat buffer whose first slots × w entries are width w's
        table), ``last``, ``pos``, ``left`` (and ``hist``/``hlen``) —,
        the emitted rows (and accepted counts), ``iters`` (int64, the
        next emitted row), the ring's ``head`` and ``assign``, the
        one-byte ``flag`` that says whether the next iteration runs,
        and the packed output; when sampling, the slots' seeds (a ring
        entry armed into a slot brings its own)."""
        S, K, k, R = self.slots, self.megastep, self.spec_k, \
            self.refill_ring
        i32 = functools.partial(torch.zeros, dtype=torch.int32,
                                device=self.device)
        st = {"ptab": i32(S * self._max_pages), "last": i32(S),
              "pos": i32(S), "left": i32(S),
              "emitted": i32((K, S, k + 1) if k else (K, S)),
              "iters": torch.zeros(1, dtype=torch.int64,
                                   device=self.device),
              "flag": torch.zeros(1, dtype=torch.uint8, device=self.device),
              "out": i32(size)}
        if k:
            st.update(hist=i32((S, self.max_len)), hlen=i32(S),
                      accs=i32((K, S)))
        if R:
            st.update(head=i32(1), assign=i32(R))
        if self._sampling:
            st["seeds"] = i32(S)
        self._wl = st

    def _plain_iter(self, ptabs, carry, seeds=None):
        """One decode iteration of every lane inside the megastep:
        returns (carry, emitted (slots,)).  A lane with nothing left
        is frozen: it writes to the scratch page, keeps its carry and
        emits -1.  ``seeds``: the lanes' sampling seeds (sampling
        only)."""
        last, pos, left = carry
        active = left > 0
        h, _ = paged_chunk_apply(
            self.params, last[:, None], self._kv_pools, ptabs, pos,
            self.n_heads, rope=self.rope, window=self.window,
            sinks=self.sinks, attn_kernel="decode", write_mask=active)
        toks = self._pick(head_logits(self.params, h[:, 0]), seeds, pos)
        carry = (torch.where(active, toks, last),
                 torch.where(active, pos + 1, pos),
                 left - active.to(torch.int32))
        return carry, torch.where(active, toks, -1)

    def _spec_iter(self, ptabs, carry, seeds=None):
        """One propose → verify → accept iteration of every lane inside
        the megastep: the draft found in the lane's history on the
        device, [last, draft] verified at c = k + 1, the longest prefix
        of draft tokens equal to the verifier's pick (its argmax, or
        its seeded sample at that position) accepted plus the token
        after it.  Returns (carry, (emitted (slots, k+1), accepted
        (slots,))), -1 where a lane is frozen."""
        k, L = self.spec_k, self.max_len
        last, pos, left, hist, hlen = carry
        active = left > 0
        draft, _ = propose_draft_in_graph(hist, hlen, k, self.spec_ngram)
        h, _ = paged_chunk_apply(
            self.params, torch.cat([last[:, None], draft], dim=1),
            self._kv_pools, ptabs, pos, self.n_heads, rope=self.rope,
            window=self.window, sinks=self.sinks, attn_kernel="decode",
            write_mask=active)
        out = self._pick(head_logits(self.params, h), seeds,
                         pos)                                # (slots, k+1)
        # accepted drafts ARE out[:acc], so the emit window is out[:take]
        acc = self._accepted(draft, out)
        take = torch.minimum(acc + 1, left)
        cols = torch.arange(k + 1, device=out.device)
        emit = torch.where(active[:, None] & (cols < take[:, None]), out,
                           -1)
        # the whole (k+1) window lands at hlen, its start clamped so it
        # stays inside the row; rows past ``take`` are overwritten by the
        # next append or never read
        at = hlen.clamp(max=L - (k + 1)).long()
        grown = hist.scatter(1, at[:, None] + cols, out)
        carry = (
            torch.where(active, out.gather(1, acc.long()[:, None])[:, 0],
                        last),
            # a finished lane's next (garbage) window [pos, pos + k]
            # stays inside the table
            torch.where(active, (pos + acc + 1).clamp(max=L - 1 - k), pos),
            left - torch.where(active, take, 0),
            torch.where(active[:, None], grown, hist),
            torch.where(active, (hlen + take).clamp(max=L), hlen))
        return carry, (emit, torch.where(active, acc, -1))

    def _accepted(self, draft, out):
        """(slots,) int32: how many leading draft tokens equal the
        verifier's argmax at their position (the first mismatch ends
        the run)."""
        matches = (draft == out[:, :self.spec_k]).to(torch.int32)
        return torch.cumprod(matches, dim=1, dtype=torch.int32).sum(
            dim=1, dtype=torch.int32)

    def _megastep_body(self, w):
        """THE fused program: K iterations of every lane over the static
        inputs, the page table sliced to width ``w``.  Reads nothing on
        the host, so the card captures it as a graph.  Returns the
        packed output (int32): the final ``last`` and ``pos``, the
        emitted tokens (K, slots[, k+1]) and with ``spec_k`` the
        accepted counts (K, slots)."""
        inp = self._ms_dev
        # the kernels take a contiguous table: a copy inside the program
        ptabs = inp["ptab"][:, :w].contiguous()
        carry = (inp["last"], inp["pos"], inp["left"])
        if self.spec_k:
            carry += (inp["hist"], inp["hlen"])
        step = self._spec_iter if self.spec_k else self._plain_iter
        emitted, accs = [], []
        for _ in range(self.megastep):
            carry, out = step(ptabs, carry, *self._seed_buffer(inp))
            if self.spec_k:
                out, acc = out
                accs.append(acc)
            emitted.append(out)
        parts = [carry[0], carry[1], torch.stack(emitted).reshape(-1)]
        if accs:
            parts.append(torch.stack(accs).reshape(-1))
        return torch.cat(parts)

    # --------------------------------------------------- while megastep
    def _while_carry(self):
        """The carry buffers in the order the iteration takes them."""
        st = self._wl
        carry = (st["last"], st["pos"], st["left"])
        if self.spec_k:
            carry += (st["hist"], st["hlen"])
        return carry

    def _while_live(self):
        """``flag`` := some lane has tokens left, or a published ring
        entry is not armed yet."""
        st = self._wl
        live = (st["left"] > 0).any()
        if self.refill_ring:
            live = live | (st["head"] < self._ms_dev["count"]).any()
        st["flag"].copy_(live.view(1))

    def _while_pre(self, w):
        """The program's set-up at width ``w``: the carry from the staged
        inputs, the emitted rows at -1, no iteration run, no ring entry
        armed, and the first ``flag``."""
        st, inp, S = self._wl, self._ms_dev, self.slots
        st["ptab"][:S * w].view(S, w).copy_(inp["ptab"][:, :w])
        for name, buf in zip(("last", "pos", "left", "hist", "hlen"),
                             self._while_carry()):
            buf.copy_(inp[name])
        st["emitted"].fill_(-1)
        if self.spec_k:
            st["accs"].fill_(-1)
        st["iters"].zero_()
        if self._sampling:
            st["seeds"].copy_(inp["seeds"])
        if self.refill_ring:
            st["head"].zero_()
            st["assign"].fill_(-1)
        self._while_live()

    def _while_arm(self, ptabs, w):
        """THE in-program re-arm: every drained slot (``left == 0``),
        in slot order, takes the next published ring entry while any is
        left — its table row (sliced to ``w``), frontier, last token,
        tokens left (and history, and seed) swapped in by masked
        selects, and
        ``assign[entry]`` set to the slot.  Vectorised: the drained
        slots are numbered by a running sum, and slot s takes entry
        ``head + its number`` when that is below ``count``.  Equal to
        the reference's loop over slots, where no slot's take depends
        on another slot's swap (a taking slot's own ``left`` turns
        positive; only ``head`` carries over)."""
        st, inp = self._wl, self._ms_dev
        R = self.refill_ring
        drained = st["left"] == 0
        at = st["head"] + torch.cumsum(drained, 0, dtype=torch.int32) - 1
        take = drained & (at < inp["count"])
        idx = at.clamp(0, R - 1).long()
        ptabs.copy_(torch.where(take[:, None], inp["ring_tab"][idx, :w],
                                ptabs))
        for name, buf in zip(("last", "pos", "left", "hist", "hlen"),
                             self._while_carry()):
            src = inp["ring_" + name][idx]
            mask = take if buf.dim() == 1 else take[:, None]
            buf.copy_(torch.where(mask, src, buf))
        if self._sampling:
            st["seeds"].copy_(torch.where(take, inp["ring_seeds"][idx],
                                          st["seeds"]))
        entries = torch.arange(R, device=idx.device)
        hit = take[:, None] & (idx[:, None] == entries)          # (S, R)
        slots = torch.arange(self.slots, device=idx.device,
                             dtype=torch.int32)
        st["assign"].copy_(torch.where(
            hit.any(0), (hit.to(torch.int32) * slots[:, None]).sum(
                0, dtype=torch.int32), st["assign"]))
        st["head"].add_(take.sum(dtype=torch.int32))

    def _while_iter(self, w):
        """ONE iteration of the while program at width ``w``, in place on
        its state: the ring's arm, one plain (or speculative) iteration
        of every lane, its emitted row (and accepted counts) at row
        ``iters``, ``iters`` + 1, and the next ``flag``."""
        st, S = self._wl, self.slots
        ptabs = st["ptab"][:S * w].view(S, w)
        if self.refill_ring:
            self._while_arm(ptabs, w)
        carry = self._while_carry()
        if self.spec_k:
            new, (emit, acc) = self._spec_iter(ptabs, carry,
                                               *self._seed_buffer(st))
            st["accs"].index_copy_(0, st["iters"], acc[None])
        else:
            new, emit = self._plain_iter(ptabs, carry,
                                         *self._seed_buffer(st))
        for buf, value in zip(carry, new):
            buf.copy_(value)
        st["emitted"].index_copy_(0, st["iters"], emit[None])
        st["iters"].add_(1)
        self._while_live()

    def _while_post(self):
        """The packed output: last, pos, emitted, (accs,) iters,
        (assign)."""
        st = self._wl
        parts = [st["last"], st["pos"], st["emitted"].view(-1)]
        if self.spec_k:
            parts.append(st["accs"].view(-1))
        parts.append(st["iters"].to(torch.int32))
        if self.refill_ring:
            parts.append(st["assign"])
        torch.cat(parts, out=st["out"])
        return st["out"]

    def _while_body(self, w):
        """The while program on the host: the set-up, iterations while
        ``flag`` holds (K at most), the packed output."""
        self._while_pre(w)
        for _ in range(self.megastep):
            if not int(self._wl["flag"][0]):
                break
            self._while_iter(w)
        return self._while_post()

    def _megastep_program(self, w):
        """Run the fused program of width ``w`` over the staged inputs;
        returns its packed output (on the engine's device)."""
        return self._megastep_programs[w]()

    def _capture_megastep(self, w, pool):
        """The card's program of width ``w``: the body captured as one
        CUDA graph (``compiled.capture``: warmed up first with every
        lane frozen, so each write lands on the scratch page; the graph
        memory ``pool`` shared across the ladder).  A replay runs no
        Python for its launches, so they are added to the wrappers'
        counts at every replay.  A capture that fails raises: there is
        no eager fallback."""
        from veles_tpu_torch.compiled import capture
        from veles_tpu_torch.ops import hopper_kernels as HK
        began = time.perf_counter()
        self._ms_in.zero_()
        graph, out, per_replay = capture(
            functools.partial(self._megastep_body, w), self.device, pool)
        self.megastep_launches[w] = {fn.__name__: n
                                     for fn, n in per_replay.items()}
        self.megastep_capture_s[w] = time.perf_counter() - began

        def replay():
            graph.replay()
            HK.add_launches(per_replay)
            return out
        return replay

    def _capture_while(self, w, pool):
        """The card's while program of width ``w``: its set-up, ONE
        iteration and its packing captured as graphs and joined into K
        conditional nodes (``compiled.WhileGraph``), so the iterations
        after ``flag`` reads false are skipped on the card.  A launch's
        kernel launches are counted once its ``iters`` is read back
        (:meth:`_count_while_launches`)."""
        from veles_tpu_torch.compiled import WhileGraph
        began = time.perf_counter()
        self._ms_in.zero_()
        loop = WhileGraph(functools.partial(self._while_pre, w),
                          functools.partial(self._while_iter, w),
                          self._while_post, self.megastep,
                          self._wl["flag"], self.device, pool)
        self._while_graphs[w] = loop
        self.megastep_launches[w] = {fn.__name__: n for fn, n in
                                     loop.per_iteration.items()}
        self.megastep_capture_s[w] = time.perf_counter() - began

        def launch():
            loop.launch()
            return self._wl["out"]
        return launch

    def _count_while_launches(self, w, iters):
        """Add one while launch's kernel launches (per iteration ×
        ``iters``) on the card; the CPU's plain versions count none."""
        loop = self._while_graphs.get(w)
        if loop is not None:
            loop.add_launches(iters)

    def _build_megastep(self):
        """One fused program a live-width ladder entry, so no shape is
        first seen under traffic: on the card a captured graph (the
        while mode's a loop of conditional nodes), on the CPU the body
        itself.  No garbage collection while the ladder is captured:
        freeing an earlier graph inside a capture would end it."""
        body = (self._while_body if self.megastep_mode == "while"
                else self._megastep_body)
        if self.device.type != "cuda":
            self._megastep_programs = {
                w: functools.partial(body, w) for w in self._width_ladder}
            return
        grab = (self._capture_while if self.megastep_mode == "while"
                else self._capture_megastep)
        pool = torch.cuda.graph_pool_handle()
        gc.collect()
        gc.disable()
        try:
            # a capture synchronizes the card before and after: set-up,
            # not a turn's work, so a declared transfer boundary
            with xfer.boundary():
                self._megastep_programs = {w: grab(w, pool)
                                           for w in self._width_ladder}
        finally:
            gc.enable()

    def _warmup(self):
        """Run every program shape once before traffic (on the card
        this builds the kernels): the chunk program, the page copy, and
        the step (and with ``spec_k`` the verify) at every live-width
        ladder entry — or, with ``megastep``, the fused program at
        every entry.  All writes land on the scratch page (zero
        tables, position 0, every fused lane frozen)."""
        ptabs = numpy.zeros((self.slots, self._max_pages), numpy.int32)
        self._chunk_program(ptabs[0], numpy.zeros(self.prefill_chunk,
                                                  numpy.int32), 0, 0)
        self._page_copy_program(KVPagePool.SCRATCH, KVPagePool.SCRATCH)
        if self.megastep >= 2:
            self._build_megastep()
            return
        zeros = numpy.zeros(self.slots, numpy.int32)
        drafts = numpy.zeros((self.slots, self.spec_k + 1), numpy.int32)
        for w in self._width_ladder:
            if self.spec_k:
                self._verify_program(ptabs[:, :w], drafts, zeros)
            self._step_program(ptabs[:, :w], zeros, zeros)

    def start(self):
        # the discarded warmup writes land on the scratch page, which
        # no live mask ever covers; it runs under the transfer guard
        # (its arguments go through the explicit shims, like a turn's)
        with torch.inference_mode(), xfer.guard(self.device):
            self._warmup()
        with self._cond:
            self._stop = False
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="lm-engine-%s" % self.name)
        self._thread.start()
        return self

    def stop(self):
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=60)
            self._thread = None

    # ------------------------------------------------------------ hot swap
    def _stage_params(self, params):
        """The new tree on the engine's device, on the CALLER's thread
        (off the decode loop), its copies finished before the worker
        may read it.  A tree whose paths, shapes or dtypes differ from
        the serving tree's is refused LOUDLY here, before the live
        weights are touched — dict order aside, since the apply copies
        by key."""
        def spec(shape_dtype):
            if shape_dtype is None:
                return "absent"
            return "%s %s" % (shape_dtype[0],
                              str(shape_dtype[1]).replace("torch.", ""))
        # the uploads and their wait run on the caller's thread, outside
        # the worker's guard; the guard's mode is process-wide, so they
        # are a declared transfer boundary
        with xfer.boundary():
            staged = _owned_tree(params, self.device)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        live, new = _leaf_specs(self.params), _leaf_specs(staged)
        for path in sorted(live.keys() | new.keys()):
            if live.get(path) != new.get(path):
                raise ValueError(
                    "swap refused: param %s is %s in the new tree but %s "
                    "in the serving tree — old weights keep serving"
                    % (path or "the root", spec(new.get(path)),
                       spec(live.get(path))))
        return staged

    def _load_params(self, staged):
        """THE apply: copy ``staged`` into the live weight tensors IN
        PLACE, key by key, on the current stream — the one the captured
        scan and while graphs are replayed on — so the copies are
        ordered before their next replay, which reads the tensors by
        address.  Reassigning ``self.params`` instead would leave every
        captured graph decoding on the old weights."""
        with torch.no_grad():
            tree_map(lambda live, new: live.copy_(new), self.params, staged)

    def _flush_prefix_cache(self):
        """Drop every prefix-cache entry (each eviction sends its page
        home): their K/V rows were computed by the weights being
        replaced.  Called with no lane active and the ring empty, so no
        entry is pinned and the trie empties."""
        if self._trie is None:
            return
        while self._trie.evict_one():
            pass
        self.metrics.set_gauge("prefix_cache_chunks", self._trie.size)
        self._update_pool_gauges()

    def _install(self, staged, version):
        """Apply a staged tree: the weights copied in place, the prefix
        cache flushed, the version set."""
        self._load_params(staged)
        self._flush_prefix_cache()
        self._set_version(version)

    def swap_weights(self, params, version=None, drain=False,
                     timeout_s=120.0):
        """Hot-install ``params`` (the same structure, shapes and dtypes
        as the serving tree) into this LIVE engine without dropping
        lanes.

        The tree is validated and staged on the engine's device HERE, on
        the caller's thread; the worker applies it at a tick boundary.
        By default in-flight lanes FINISH on the old weights first —
        admission holds while they do, and the standby ring neither
        grows, advances, installs nor arms.  With ``drain=True`` the
        active lanes are withdrawn whole and requeued at the head with a
        fresh deadline instead, re-decoding from scratch on the new
        weights (their futures resolve exactly once).  Either way the
        standby ring's entries, prefilled on the old weights, go back to
        the queue head whole.  The apply copies the new values into the
        live tensors in place (so the captured graphs serve them at
        their next replay) and flushes the prefix cache.

        ``version`` (int; default: current + 1) becomes
        :attr:`weights_version`, stamped on every result served by the
        new weights.  Returns the installed version; raises ValueError
        on a structural mismatch and re-raises an apply-time fault (the
        ``engine.swap`` site), in both cases leaving the old weights
        serving.  Blocks until applied (``timeout_s`` bounds a wedged
        worker: an unclaimed swap is withdrawn).  ``params`` may also be
        a :class:`TransformerLM`."""
        staged = self._stage_params(params)
        if version is None:
            version = self.weights_version + 1
        version = int(version)
        with self._cond:
            if self._pending_swap is not None:
                raise RuntimeError("a weight swap is already in flight")
            if self._stop and self._thread is not None:
                # the worker may still be replaying a graph on the live
                # tensors: refuse as the stop drain refuses a pending
                # swap
                raise RuntimeError("LM engine stopped before the swap "
                                   "applied")
            if self._thread is None:
                # not serving: apply here (start() warms the programs
                # on the live tensors, whatever they hold)
                self._install(staged, version)
                self.metrics.inc("weight_swaps")
                return version
            swap = {"params": staged, "version": version,
                    "drain": bool(drain), "done": threading.Event(),
                    "exc": None, "t0": time.monotonic()}
            self._pending_swap = swap
            self._cond.notify_all()
        if not swap["done"].wait(timeout_s):
            with self._cond:
                withdrawn = self._pending_swap is swap
                if withdrawn:
                    self._pending_swap = None
            if not withdrawn:
                # the worker claimed the swap right at the deadline:
                # give the apply a moment rather than report a state
                # about to be wrong
                swap["done"].wait(5.0)
            if not swap["done"].is_set():
                raise RuntimeError(
                    "weight swap did not apply within %.0fs (worker "
                    "wedged or lanes never finished); %s"
                    % (timeout_s,
                       "old weights keep serving" if withdrawn else
                       "swap state INDETERMINATE — the worker claimed "
                       "it but never finished applying"))
        if swap["exc"] is not None:
            raise swap["exc"]
        return version

    def _set_version(self, version):
        self.weights_version = int(version)
        self.metrics.set_gauge("weights_version", self.weights_version)

    def _peek_swap(self):
        """Racy worker peek at the pending weight swap.  Read-only: the
        holds in :meth:`_admit`, :meth:`_admit_ring`,
        :meth:`_advance_ring` and :meth:`_step_while` only keep work
        back for a turn, and :meth:`_maybe_apply_swap` re-checks under
        ``_cond`` before claiming."""
        return self._pending_swap

    def _maybe_apply_swap(self):
        """Worker-side swap application, once a loop turn (one is-None
        check).  Finish-on-old waits for the lanes (admission holds, so
        the wait is bounded by their remaining tokens); drain mode
        requeues them whole first; the standby ring is requeued either
        way.  Then the ``engine.swap`` fault site and the in-place
        apply."""
        swap = self._peek_swap()
        if swap is None:
            return
        active = [i for i, lane in enumerate(self._lanes)
                  if lane is not None]
        if active and not swap["drain"]:
            return           # lanes finish on the OLD weights first
        with self._cond:
            # claim before mutating anything: a timed-out caller may
            # have withdrawn the swap
            if self._pending_swap is not swap:
                return
            self._pending_swap = None
        if active:
            self._requeue_active(active)
        if self._ring:
            # standby prefill ran on the OLD weights
            self._requeue_ring()
        t0a = time.monotonic()
        try:
            self._fault("engine.swap")
        except Exception as e:   # noqa: BLE001 — refuse, keep serving
            swap["exc"] = e
            self.metrics.record_error()
            self.metrics.inc("weight_swap_failures")
            self.warning("weight swap refused at apply: %s (old weights "
                         "keep serving)", e)
            if self._tracer is not None:
                self._tracer.event(
                    "swap.refused", cat="swap", t0=t0a,
                    attrs={"engine": self.name, "error": str(e)})
        else:
            # staging checked every leaf against the live tree's, so
            # the keyed copy cannot stop partway on a shape or dtype
            self._install(swap["params"], swap["version"])
            self.metrics.inc("weight_swaps")
            self.metrics.set_gauge("swap_quiesce_s",
                                   time.monotonic() - swap["t0"])
            if self._tracer is not None:
                # the in-place copies are queued, not done: fenced
                self._tfence()
                self._tracer.event(
                    "swap.apply", cat="swap", t0=t0a,
                    attrs={"engine": self.name,
                           "version": swap["version"],
                           "drain": swap["drain"],
                           "quiesce_s": round(
                               time.monotonic() - swap["t0"], 4)})
        swap["params"] = None             # the staged tree is freed
        swap["done"].set()

    def _requeue_reqs(self, reqs):
        """Put ``reqs`` back at the queue head, in order, each with a
        fresh deadline: its wait was spent on work a swap threw away,
        and shedding it for that would turn a deploy into errors."""
        fresh_deadline = time.monotonic() + self.deadline_s
        for req in reqs:
            req.deadline = max(req.deadline, fresh_deadline)
            if req.trace is not None:
                # back in the queue: a fresh queue-wait span, ended by
                # the re-admission
                req.trace.tracer.instant(req.trace, "swap.requeue",
                                         cat="engine")
                req.tspan = req.trace.tracer.begin(
                    req.trace, "queue.wait", cat="queue",
                    attrs={"engine": self.name, "requeued": True})
        with self._cond:
            for req in reversed(reqs):
                self._queue.appendleft(req)
                self._queued_tokens += req.true_len
                self._queued_pages += req.pages
            self.metrics.set_gauge("queue_depth", len(self._queue))
            self.metrics.set_gauge("queue_tokens", self._queued_tokens)
            self.metrics.set_gauge("queue_pages", self._queued_pages)
        self.metrics.inc("requests_requeued_for_swap", len(reqs))

    def _requeue_active(self, active):
        """Drain-mode swap: withdraw every active lane WHOLE (pages home,
        slot parked on scratch) and requeue its request at the head in
        admission order.  The futures are untouched: each request
        re-decodes from scratch and resolves exactly once."""
        order = sorted(active, key=lambda s: self._lanes[s].request.t_enq)
        reqs = []
        for slot in order:
            lane = self._lanes[slot]
            self._vacate_slot(slot, lane)
            reqs.append(lane.request)
        self._requeue_reqs(reqs)

    def _requeue_ring(self):
        """Swap application: the standby entries were prefilled on the
        OLD weights, so they go back to the queue head whole (pages
        home) and re-prefill on the new ones; a withdrawn entry is
        cancelled."""
        reqs = []
        for entry in self._ring:
            self._release_lane(entry.lane)
            req = entry.lane.request
            if req.cancelled:
                req.future.cancel()
                continue
            reqs.append(req)
        self._ring = []
        self.metrics.set_gauge("standby_ring_occupancy", 0)
        self._requeue_reqs(reqs)

    # -------------------------------------------------- crash-safe recovery
    def _journal_pop(self, rid):
        with self._cond:
            self._journal.pop(rid, None)

    def checkpoint(self):
        """JSON-safe snapshot of the HOST-side serving state (the
        reference's format 1): every admitted but unresolved request
        (the admission journal), the slot frontiers, the pool's
        ref/pin/free books, the page tables and the prefix cache's size.
        Taken under the engine lock, so the request set is consistent.

        A crash loses the device state (the KV pages) unconditionally,
        so the checkpoint carries no tensors: :meth:`restore` re-admits
        the journaled work on a fresh engine and prefill derives the KV
        again.  The pool and page-table sections are post-mortem
        evidence: the worker mutates them without this lock, so on a
        live engine they may be torn mid-turn; :meth:`restore` never
        reads them.  Only the request set is exact."""
        with self._cond:
            entries = [{"rid": rid,
                        "prompt": [int(t) for t in req.prompt],
                        "n_new": int(req.n_new)}
                       for rid, req in sorted(self._journal.items())
                       if not req.future.done() and not req.cancelled]
            state = {
                "format": 1,
                "config": {"max_len": self.max_len,
                           "slots": self.slots,
                           "prefill_chunk": self.prefill_chunk,
                           "spec_k": self.spec_k,
                           "paged_kv": True,
                           "pool_pages": self._pool.num_pages},
                "requests": entries,
                "slot_frontiers": {
                    "pos": [int(x) for x in self._pos],
                    "last": [int(x) for x in self._last]},
                "pool": self._pool.snapshot(),
                "page_tables": self._page_tables.tolist(),
            }
            if self._trie is not None:
                state["prefix_cache_chunks"] = self._trie.size
        return state

    def restore(self, state):
        """Re-admit a :meth:`checkpoint`'s unresolved requests into THIS
        (fresh, started) engine after a crash: the pool's invariants are
        verified first, every entry is validated against this engine's
        geometry before any is admitted (all or nothing), then each is
        submitted afresh, retrying on ``Overloaded`` for up to 30 s.
        Returns ``{rid: Future}`` keyed by the checkpoint's ids.

        In-flight work resumes AT LEAST ONCE from the engine's side (a
        request that finished between the checkpoint and the crash runs
        again).  The checkpoint journals no sampling seed: a restored
        sampled request draws under its NEW admission id in this engine,
        as the reference's restore does, so its tokens equal the
        reference's restore of the same state, not the crashed run's."""
        if not isinstance(state, dict) or state.get("format") != 1:
            raise ValueError("not an LMEngine checkpoint (format %r)"
                             % (state.get("format")
                                if isinstance(state, dict) else state))
        cfg = state.get("config", {})
        if int(cfg.get("max_len", self.max_len)) > self.max_len:
            raise ValueError(
                "checkpoint was taken at max_len %d but this engine holds "
                "%d — journaled prompts may not fit"
                % (cfg["max_len"], self.max_len))
        self.verify_pool_invariants()
        entries = list(state.get("requests", ()))
        for entry in entries:
            span = len(entry["prompt"]) + int(entry["n_new"]) + self.spec_k
            if span > self.max_len:
                raise ValueError(
                    "journaled request rid=%s needs %d cache positions but "
                    "this engine holds %d"
                    % (entry.get("rid"), span, self.max_len))
            pages = -(-span // self.prefill_chunk)
            if pages > self._pool.num_pages:
                raise ValueError(
                    "journaled request rid=%s needs %d KV pages but this "
                    "engine's pool holds %d — restore into a pool at "
                    "least as large as the checkpoint's (pool_pages=%s)"
                    % (entry.get("rid"), pages, self._pool.num_pages,
                       cfg.get("pool_pages")))
        futures = {}
        stop = time.monotonic() + 30.0
        for entry in entries:
            while True:
                try:
                    futures[entry["rid"]] = self.submit(entry["prompt"],
                                                        entry["n_new"])
                    break
                except Overloaded as e:
                    if time.monotonic() > stop:
                        raise RuntimeError(
                            "restore stalled: %d/%d journaled requests "
                            "re-admitted before the engine stopped "
                            "accepting" % (len(futures), len(entries)))
                    time.sleep(min(getattr(e, "retry_after", 0.05), 0.05))
        self.metrics.inc("engine_restores")
        self.metrics.inc("requests_restored", len(futures))
        return futures

    # -------------------------------------------------------------- clients
    def submit(self, prompt, n_new):
        """Queue one prompt ((s,) ints) for ``n_new`` tokens (greedy, or
        sampled under the request's admission id); returns a Future
        resolving to the (n_new,) continuation."""
        prompt = numpy.asarray(prompt, numpy.int32).reshape(-1)
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        if n_new < 1:
            raise ValueError("n_new must be >= 1")
        if len(prompt) + n_new + self.spec_k > self.max_len:
            extra = (" (+%d speculative headroom, spec_k)" % self.spec_k
                     if self.spec_k else "")
            raise ValueError("prompt %d + n_new %d%s exceeds the engine "
                             "cache length %d"
                             % (len(prompt), n_new, extra, self.max_len))
        demand = -(-(len(prompt) + n_new + self.spec_k)
                   // self.prefill_chunk)
        if demand > self._pool.num_pages:
            raise ValueError(
                "prompt %d + n_new %d needs %d KV pages but the pool "
                "holds %d — this request can never be placed"
                % (len(prompt), n_new, demand, self._pool.num_pages))
        self._fault("engine.submit")
        # tracing: join the caller's request context (HTTP) or root one
        # here — whoever STARTED the trace finishes it, so own_root
        # marks ours; a sampled-out decision above sticks
        tctx, own_root = None, False
        if self._tracer is not None:
            tctx, own_root = tracing.join_or_root(
                self._tracer, "engine.request", "engine",
                attrs={"engine": self.name})
            if tctx is tracing.SAMPLED_OUT:
                tctx = None
        try:
            return self._submit_admit(prompt, n_new, demand, tctx,
                                      own_root)
        except Exception as e:
            if own_root:
                tctx.tracer.finish_request(tctx, error=e)
            raise

    def _submit_admit(self, prompt, n_new, demand, tctx, own_root):
        with self._cond:
            if self._stop or self._thread is None:
                raise RuntimeError("LM engine is not running")
            if len(self._queue) >= self.queue_depth:
                self.metrics.record_reject()
                raise Overloaded()
            if self.queue_tokens and self._queue and \
                    self._queued_tokens + len(prompt) > self.queue_tokens:
                # queued PREFILL WORK is bounded, not just request count
                self.metrics.record_reject()
                self.metrics.inc("rejected_tokens", len(prompt))
                raise Overloaded()
            if self._queue and \
                    self._queued_pages + demand > 2 * self._pool.num_pages:
                # two full pools' worth of page demand already queued: a
                # new arrival would only sit until its deadline — 429 it
                # now, naming the resource (the head request always
                # enqueues, so one large request cannot wedge the queue)
                self.metrics.record_reject()
                self.metrics.inc("rejected_pages", demand)
                raise PoolExhausted(demand, 2 * self._pool.num_pages)
            req = _Request(prompt, int(n_new), self.deadline_s,
                           pages=demand)
            if tctx is not None:
                req.trace = tctx
                req.tspan = tctx.tracer.begin(
                    tctx, "queue.wait", cat="queue",
                    attrs={"engine": self.name})
                if own_root:
                    req.future.add_done_callback(
                        lambda f, ctx=tctx:
                        tracing.finish_from_future(ctx, f))
            # the sampling lane seed: the admission id, deterministic in
            # submission order, so the same traffic on any engine mode
            # folds the same (seed, position) into its draws
            self._rid += 1
            req.seed = self._rid
            # the journal entry lives until the future settles (result,
            # exception or cancel); the pop re-takes the (re-entrant)
            # lock, so a checkpoint never iterates a changing dict
            self._journal[self._rid] = req
            req.future.add_done_callback(
                lambda f, rid=self._rid: self._journal_pop(rid))
            self._queue.append(req)
            self._queued_tokens += req.true_len
            self._queued_pages += req.pages
            self.metrics.record_enqueue()
            self.metrics.set_gauge("queue_depth", len(self._queue))
            self.metrics.set_gauge_max("queue_depth_peak",
                                       len(self._queue))
            self.metrics.set_gauge("queue_tokens", self._queued_tokens)
            self.metrics.set_gauge("queue_pages", self._queued_pages)
            self._cond.notify()
        return req.future

    def generate(self, prompts, n_new, return_versions=False):
        """Decode a whole (b, s) prompt batch; returns (b, s + n_new)
        int32 — prompt plus continuation per row (with
        ``return_versions`` also the ``weights_version`` that served
        each row).  All-or-nothing: if a row is refused or fails, the
        rows already queued are cancelled."""
        prompts = numpy.asarray(prompts, numpy.int32)
        futures = []
        try:
            for row in prompts:
                futures.append(self.submit(row, n_new))
            news = numpy.stack([f.result() for f in futures])
        except Exception:
            for f in futures:
                self._cancel(f.request)
            raise
        out = numpy.concatenate([prompts, news], axis=1)
        if return_versions:
            return out, [getattr(f, "version", None) for f in futures]
        return out

    def _cancel(self, req):
        """Withdraw a request: dequeue it if still queued; if already in
        a slot, flag it so the worker frees the slot at the next tick."""
        req.cancelled = True
        with self._cond:
            try:
                self._queue.remove(req)
                self._queued_tokens -= req.true_len
                self._queued_pages -= req.pages
            except ValueError:
                return           # admitted (or done) — worker handles it
        self._trace_queue_end(req, "cancelled")
        req.future.cancel()

    # ---------------------------------------------------------- accounting
    def verify_pool_invariants(self):
        """Cross-check the allocator against the engine's own references:
        every page's refcount must equal the lanes holding it (each also
        pinned) plus the trie nodes storing it, and the pool's
        free-list/ref/pin bookkeeping must be self-consistent.  Raises
        RuntimeError naming the first violated page; returns a summary
        dict when sound.  Call quiesced."""
        self._pool.verify()
        n = self._pool.num_pages
        want_refs = [0] * (n + 1)
        want_pins = [0] * (n + 1)
        for lane in self._lanes:
            if lane is not None:
                for p in lane.pages:
                    want_refs[p] += 1
                    want_pins[p] += 1
        for entry in self._ring:
            # a standby entry holds its pages as a lane does
            for p in entry.lane.pages:
                want_refs[p] += 1
                want_pins[p] += 1
        if self._trie is not None:
            stack = list(self._trie.root.children.values())
            while stack:
                node = stack.pop()
                stack.extend(node.children.values())
                want_refs[node.rows] += 1
        for p in range(1, n + 1):
            if self._pool.refs(p) != want_refs[p]:
                raise RuntimeError(
                    "page %d holds %d refs but lanes+trie account for %d "
                    "— leaked or double-released"
                    % (p, self._pool.refs(p), want_refs[p]))
            if self._pool._pins[p] != want_pins[p]:
                raise RuntimeError(
                    "page %d holds %d pins but active lanes account for "
                    "%d" % (p, self._pool._pins[p], want_pins[p]))
        return {"paged": True, "free_pages": self._pool.free_pages,
                "used_pages": self._pool.used_pages,
                "pinned_pages": self._pool.pinned_pages}

    def _update_pool_gauges(self):
        self.metrics.set_gauge("kv_pages_free", self._pool.free_pages)
        self.metrics.set_gauge("kv_pages_pinned", self._pool.pinned_pages)

    def _live_width(self, span, floor=0):
        """Ladder-bucketed page-table width for a step writing ``span``
        positions per lane: the smallest ladder entry covering EVERY
        slot's frontier — ``_pos`` includes prefilling lanes' parked
        frontiers and free lanes' 0, so every write of the batched step
        lands inside the sliced table.  ``floor`` raises the covered
        frontier past the slots' own: the while program passes its
        published ring entries' frontiers, so an entry armed inside the
        program writes inside the sliced table too."""
        need = -(-(max(int(self._pos.max()), floor) + span)
                 // self.prefill_chunk)
        for w in self._width_ladder:
            if w >= need:
                return w
        return self._max_pages

    def kv_bytes_resident(self):
        """Device bytes held by the KV pools."""
        return sum(t.numel() * t.element_size()
                   for pair in self._kv_pools for t in pair)

    # ---------------------------------------------------------------- worker
    def _admit(self):   # hot-path
        """Move queued prompts into free slots, each RESERVING its
        worst-case pages; when the pool cannot cover them the request
        goes BACK to the queue head (retried next tick, shed at its
        deadline) instead of wedging or being skipped.  A pending
        finish-on-old swap holds admission: admitting now would extend
        the old weights' serving without bound."""
        if self._peek_swap() is not None:
            return
        self._pool_blocked = False
        while self._free:
            with self._cond:
                req = self._queue.popleft() if self._queue else None
                if req is not None:
                    self._queued_tokens -= req.true_len
                    self._queued_pages -= req.pages
                self.metrics.set_gauge("queue_depth", len(self._queue))
                self.metrics.set_gauge("queue_tokens", self._queued_tokens)
                self.metrics.set_gauge("queue_pages", self._queued_pages)
            if req is None:
                return
            if req.cancelled:            # raced _cancel's dequeue
                self._trace_queue_end(req, "cancelled")
                req.future.cancel()
                continue
            if time.monotonic() > req.deadline:
                self.metrics.record_shed()
                self._trace_queue_end(req, "shed")
                req.future.set_exception(DeadlineExceeded(
                    "prompt shed after %.3fs in queue" % (
                        time.monotonic() - req.t_enq)))
                continue
            slot = self._free.pop()
            if not self._admit_paged(slot, req):
                self._free.append(slot)
                self._pool_blocked = True
                with self._cond:
                    self._queue.appendleft(req)
                    self._queued_tokens += req.true_len
                    self._queued_pages += req.pages
                    self.metrics.set_gauge("queue_depth", len(self._queue))
                    self.metrics.set_gauge("queue_tokens",
                                           self._queued_tokens)
                    self.metrics.set_gauge("queue_pages",
                                           self._queued_pages)
                return

    def _chunk_key(self, tokens):
        """The prefix cache's key of one prompt chunk: its literal
        tokens."""
        return tuple(int(t) for t in tokens)

    def _admit_paged(self, slot, req):   # hot-path
        """Reserve the lane's WORST-CASE page span up front (no
        mid-decode allocation, so decode can never deadlock on pages),
        with prefix-cache hits substituting page REFERENCES (ref count
        and pin, no device work) for fresh pages, and queue the rest of
        its prompt as per-tick chunks.  Returns False — nothing
        committed — when the pool cannot cover it even after pressing
        the prefix cache."""
        C = self.prefill_chunk
        # the tail chunk (the last prompt token's) is never cached
        n_full = (req.true_len - 1) // C
        nodes = []
        if self._trie is not None:
            nodes = self._trie.match(
                [self._chunk_key(req.prompt[i * C:(i + 1) * C])
                 for i in range(n_full)])
        fresh = self._alloc_pages(req.pages - len(nodes))
        if fresh is None:
            if nodes:            # nothing committed — undo the pins
                self._trie.release(nodes)
            return False
        lane = _Slot(req)
        lane.pinned.extend(nodes)
        if self._trie is not None:
            lane.cursor = nodes[-1] if nodes else self._trie.root
        for node in nodes:
            self._pool.retain(node.rows)     # the lane's reference
            self._pool.pin(node.rows)
            lane.pages.append(node.rows)
        for p in fresh:
            self._pool.pin(p)
        lane.pages.extend(fresh)
        self._page_tables[slot, :len(lane.pages)] = lane.pages
        self._page_tables[slot, len(lane.pages):] = KVPagePool.SCRATCH
        if nodes:
            self.metrics.inc("prefix_hit_chunks", len(nodes))
            self.metrics.inc("prefix_hit_tokens", len(nodes) * C)
            self.metrics.inc("kv_pages_referenced", len(nodes))
            self.metrics.set_gauge("prefix_cache_chunks", self._trie.size)
        for i in range(len(nodes), n_full):
            lane.pending.append((req.prompt[i * C:(i + 1) * C], i * C,
                                 False))
        tail = req.prompt[n_full * C:]
        if len(tail) < C:
            tail = numpy.pad(tail, (0, C - len(tail)))
        lane.pending.append((tail, n_full * C, True))
        self.metrics.record_queue_wait(time.monotonic() - req.t_enq)
        self._trace_admitted(req)
        if nodes and req.trace is not None:
            req.trace.tracer.instant(
                req.trace, "prefix.hit", cat="prefill",
                attrs={"chunks": len(nodes), "tokens": len(nodes) * C,
                       "paged": True})
        self._lanes[slot] = lane
        # park the step position at the chunk frontier: the batched
        # decode steps EVERY slot, and a prefilling lane's garbage write
        # must land where its own next chunk overwrites it
        self._pos[slot] = lane.pending[0][1]
        self._update_pool_gauges()
        return True

    def _alloc_pages(self, n):
        """``n`` pages from the pool, pressing the prefix cache to drop
        LRU unpinned entries (each eviction releases its page) until
        the allocation fits or nothing more can be evicted.  Returns
        the page list or None; never blocks."""
        if n <= 0:
            return []
        pages = self._pool.alloc(n)
        if pages is None and self._trie is not None:
            # each eviction frees at most ONE page — when even a full
            # flush cannot cover the deficit, keep the cache warm (only
            # lanes finishing can place the request anyway)
            if self._pool.free_pages + self._trie.evictable() < n:
                return None
            while pages is None and self._trie.evict_one():
                self.metrics.set_gauge("prefix_cache_chunks",
                                       self._trie.size)
                pages = self._pool.alloc(n)
        return pages

    def _cow_guard(self, slot, lane, lo, hi):   # hot-path
        """COPY-ON-WRITE: before a device write covering linear
        positions [lo, hi), replace any SHARED page in that range with
        a private copy (one page-copy program) so the other referents —
        sibling lanes, the prefix cache — keep their rows
        bit-identical.  Structurally rare (shared pages are full prompt
        chunks; appends land past the prompt), kept as the safety net
        that makes sharing unconditionally sound.  Raises on pool
        exhaustion — the caller fails THIS lane, never wedges.  ``hi``
        is clamped to the lane's reservation (pages past it are never
        written by a live lane)."""
        P = self.prefill_chunk
        hi = min(hi, len(lane.pages) * P)
        if hi <= lo:
            return
        for j in range(lo // P, (hi - 1) // P + 1):
            p = lane.pages[j]
            if not self._pool.shared(p):
                continue
            fresh = self._alloc_pages(1)
            if fresh is None:
                raise Overloaded()
            q = fresh[0]
            t0c = time.monotonic()
            try:
                self._fault("engine.cow")
                self._page_copy_program(p, q)
                self._tfence(lane.request.trace is not None)
            except Exception:
                # nobody owns q yet (not in lane.pages) — hand it back
                # or a faulting device shrinks the pool for good
                self._pool.release(q)
                raise
            if lane.request.trace is not None:
                lane.request.trace.tracer.add(
                    lane.request.trace, "cow.copy", "kv", t0c,
                    time.monotonic(),
                    attrs={"page": int(p), "bucket": self.prefill_chunk,
                           "backend": self._backend})
            self._pool.pin(q)
            self._pool.unpin(p)
            self._pool.release(p)
            lane.pages[j] = q
            self._page_tables[slot, j] = q
            self.metrics.inc("kv_cow_copies")
            self._update_pool_gauges()

    def _cow_guard_active(self, active, span):
        """:meth:`_cow_guard` over every active lane's next
        ``span``-position write, BEFORE the batched dispatch: a lane
        whose copy cannot be made is torn down ALONE — its siblings keep
        decoding.  Returns the surviving active list (a torn-down lane's
        table row parks on scratch, so the batched step stays safe)."""
        alive = []
        for slot in active:
            lane = self._lanes[slot]
            try:
                self._cow_guard(slot, lane, int(self._pos[slot]),
                                int(self._pos[slot]) + span)
            except Exception as e:   # noqa: BLE001 — fails THIS lane
                self.metrics.record_error()
                self.warning("copy-on-write failed: %s", e)
                self._teardown_slot(slot, lane, e)
                continue
            alive.append(slot)
        return alive

    def _advance_prefill(self, slot):   # hot-path
        """Run ONE pending prompt chunk for this lane (a tick's worth of
        prefill — decode lanes step in between)."""
        lane = self._lanes[slot]
        req = lane.request
        if req.cancelled:
            # withdrawn mid-prefill: free the slot now
            self._teardown_slot(slot, lane)
            return
        self._advance_prefill_paged(slot, lane, req)

    def _advance_prefill_paged(self, slot, lane, req):   # hot-path
        """One pending prompt chunk through the lane's page table: a
        LATE HIT swaps the lane's reserved page for a REFERENCE to the
        sibling's page (release one, retain the other — no device
        work); a computed full chunk SHARES the lane's own page with the
        trie (retain — the insert copies nothing).  The tail chunk
        yields the first generated token."""
        C = self.prefill_chunk
        tokens, start, is_tail = lane.pending.pop(0)
        page_idx = start // C
        cached = (not is_tail and self._trie is not None
                  and lane.cursor is not None)
        if cached:
            node = self._trie.lookup_child(lane.cursor,
                                           self._chunk_key(tokens))
            if node is not None:
                own = lane.pages[page_idx]
                self._pool.unpin(own)
                self._pool.release(own)
                self._pool.retain(node.rows)
                self._pool.pin(node.rows)
                lane.pages[page_idx] = node.rows
                self._page_tables[slot, page_idx] = node.rows
                lane.pinned.append(node)
                lane.cursor = node
                self.metrics.inc("prefix_hit_chunks")
                self.metrics.inc("prefix_hit_tokens", len(tokens))
                self.metrics.inc("kv_pages_referenced")
                if req.trace is not None:
                    req.trace.tracer.instant(
                        req.trace, "prefix.hit", cat="prefill",
                        attrs={"late": True, "start": int(start),
                               "paged": True})
                self._update_pool_gauges()
                self._pos[slot] = lane.pending[0][1]
                return
        last_idx = (req.true_len - 1 - start) if is_tail else 0
        t0 = time.monotonic()
        try:
            self._fault("engine.chunk")
            self._cow_guard(slot, lane, start, start + C)
            tok = self._chunk_program(self._page_tables[slot], tokens,
                                      start, last_idx, *self._lane_seed(req))
            self._tfence(req.trace is not None)
            if is_tail:
                tok = int(xfer.to_host(tok))
            if cached:
                page = lane.pages[page_idx]
                node = self._trie.insert(lane.cursor,
                                         self._chunk_key(tokens), page)
                if node is not None:
                    lane.pinned.append(node)
                    if node.rows == page:
                        # a fresh entry: the trie now references the
                        # lane's own page (released on eviction)
                        self._pool.retain(page)
                lane.cursor = node
                self.metrics.set_gauge("prefix_cache_chunks",
                                       self._trie.size)
                self._update_pool_gauges()
        except Exception as e:   # noqa: BLE001 — fails THIS request
            self.metrics.record_error()
            self.warning("paged chunk prefill failed: %s", e)
            if req.trace is not None:
                # the FAILED dispatch is part of the timeline (no backend
                # attr: failed spans stay out of the ledger)
                req.trace.tracer.add(
                    req.trace, "prefill.chunk", "prefill", t0,
                    time.monotonic(),
                    attrs={"start": int(start), "paged": True,
                           "error": str(e)})
            self._teardown_slot(slot, lane, e)
            return
        self.metrics.inc("prefill_dispatches")
        self.metrics.inc("prefill_tokens",
                         (req.true_len - start) if is_tail else len(tokens))
        self.metrics.record_decode_step(time.monotonic() - t0)
        if req.trace is not None:
            req.trace.tracer.add(
                req.trace, "prefill.chunk", "prefill", t0,
                time.monotonic(),
                attrs={"start": int(start), "tail": is_tail,
                       "bucket": self.prefill_chunk, "paged": True,
                       "backend": self._backend})
        if is_tail:
            self._emit_first(slot, lane, tok)
        else:
            self._pos[slot] = lane.pending[0][1]

    def _emit_first(self, slot, lane, tok):
        """First generated token (prefill just finished): the lane
        becomes a decode lane (or finishes outright at n_new=1)."""
        req = lane.request
        req.t_first = time.monotonic()
        lane.emitted.append(tok)
        lane.remaining -= 1
        self.metrics.inc("tokens_out")
        self.metrics.record_ttft(req.t_first - req.t_enq)
        self._pos[slot] = req.true_len
        self._last[slot] = tok
        self._lanes[slot] = lane
        if lane.remaining == 0 or req.cancelled:
            self._finish(slot)

    def _release_lane(self, lane):
        """Ref-count release on lane finish: the lane's trie pins go
        first, then its pages — owned pages return to the free list,
        shared (trie- or sibling-referenced) ones just lose this lane's
        reference."""
        if self._trie is not None and lane.pinned:
            self._trie.release(lane.pinned)
            lane.pinned = []
        for p in lane.pages:
            self._pool.unpin(p)
            self._pool.release(p)
        lane.pages = []
        self._update_pool_gauges()

    def _vacate_slot(self, slot, lane):
        """Release a lane's pages and free its slot WITHOUT touching the
        request future.  The step position parks at 0 and the table on
        the scratch page (a free slot's garbage writes land there)."""
        self._release_lane(lane)
        self._lanes[slot] = None
        if slot not in self._free:
            self._free.append(slot)
        self._pos[slot] = 0
        self._last[slot] = 0
        self._page_tables[slot, :] = KVPagePool.SCRATCH

    def _teardown_slot(self, slot, lane, exc=None):
        """THE failure/cancellation teardown: vacate the slot and fail
        — or, when ``exc`` is None, cancel — the request's future."""
        self._vacate_slot(slot, lane)
        fut = lane.request.future
        if exc is None:
            fut.cancel()
        elif not fut.cancelled():
            fut.set_exception(exc)

    def _finish(self, slot):
        lane = self._lanes[slot]
        self._vacate_slot(slot, lane)
        req = lane.request
        fut = req.future
        if not fut.cancelled():          # withdrawn mid-decode
            fut.version = self.weights_version
            fut.ttft_s = req.t_first - req.t_enq
            fut.set_result(numpy.asarray(lane.emitted, numpy.int32))

    def _fail_active(self, active, exc):
        """A step fault poisons every in-flight decode lane; fail them
        to their clients and keep serving."""
        self.metrics.record_error()
        self.warning("decode step failed: %s", exc)
        for slot in active:
            self._teardown_slot(slot, self._lanes[slot], exc)

    def _step_plain(self, active):   # hot-path
        """ONE dispatch advances every active lane by one token;
        inactive lanes step too (their writes land on the scratch page
        or at a frontier the next chunk overwrites before it is
        attended), so the step never respecializes on the active set."""
        active = self._cow_guard_active(active, 1)
        if not active:
            return
        tctxs = ()
        if self._tracer is not None:
            # only the sampled lanes carry a context: an all-None batch
            # records nothing
            tctxs = [self._lanes[s].request.trace for s in active]
        t0 = time.monotonic()
        try:
            self._fault("engine.step")
            w = self._live_width(1)
            # read back in the call: the span closes after the card's work
            toks = self._step_program(self._page_tables[:, :w],
                                      self._last, self._pos,
                                      *self._seed_args(active))
        except Exception as e:   # noqa: BLE001 — fails the lanes
            if self._tracer is not None:
                self._tracer.add_many(
                    tctxs, "decode.step", "decode", t0, time.monotonic(),
                    attrs={"batch": len(active), "error": str(e)})
            self._fail_active(active, e)
            return
        self.metrics.record_dispatch(len(active))
        self.metrics.record_decode_step(time.monotonic() - t0)
        self.metrics.inc("decode_dispatches")
        if self._tracer is not None:
            self._tracer.add_many(
                tctxs, "decode.step", "decode", t0, time.monotonic(),
                attrs={"batch": len(active), "bucket": w,
                       "backend": self._backend})
        for slot in active:
            lane = self._lanes[slot]
            lane.emitted.append(int(toks[slot]))
            lane.remaining -= 1
            self.metrics.inc("tokens_out")
            self._pos[slot] += 1
            self._last[slot] = int(toks[slot])
            if lane.remaining == 0 or lane.request.cancelled:
                self._finish(slot)

    def _step_speculative(self, active):   # hot-path
        """ONE verify dispatch advances every active lane by 1..k+1
        tokens: each lane feeds [last, draft...] (the prompt-lookup
        draft, zeros when none) and accepts the longest draft prefix
        equal to the verifier's own pick (greedy, or seeded at its
        position), plus the correction or bonus token after it — the
        plain path's tokens by construction."""
        k = self.spec_k
        active = self._cow_guard_active(active, k + 1)
        if not active:
            return
        toks_in = numpy.zeros((self.slots, k + 1), numpy.int32)
        drafts = [None] * self.slots
        real_lens = [0] * self.slots
        for slot in active:
            lane = self._lanes[slot]
            toks_in[slot, 0] = self._last[slot]
            history = numpy.concatenate(
                [lane.request.prompt,
                 numpy.asarray(lane.emitted, numpy.int32)])
            draft = propose_draft(history, k, self.spec_ngram)
            if draft is not None:
                # zero-padded to the program's fixed k (a pad is only
                # accepted where it IS the greedy token), but only the
                # real continuation is metered
                padded = numpy.zeros(k, numpy.int32)
                padded[:len(draft)] = draft
                toks_in[slot, 1:] = padded
                drafts[slot] = padded
                real_lens[slot] = len(draft)
                self.metrics.inc("draft_tokens", len(draft))
        tctxs = ()
        if self._tracer is not None:
            tctxs = [self._lanes[s].request.trace for s in active]
        t0 = time.monotonic()
        try:
            self._fault("engine.verify")
            w = self._live_width(k + 1)
            out = self._verify_program(self._page_tables[:, :w], toks_in,
                                       self._pos, *self._seed_args(active))
        except Exception as e:   # noqa: BLE001 — fails the lanes
            if self._tracer is not None:
                self._tracer.add_many(
                    tctxs, "decode.verify", "decode", t0, time.monotonic(),
                    attrs={"batch": len(active), "error": str(e)})
            self._fail_active(active, e)
            return
        self.metrics.record_dispatch(len(active))
        self.metrics.record_decode_step(time.monotonic() - t0)
        self.metrics.inc("decode_dispatches")
        if self._tracer is not None:
            self._tracer.add_many(
                tctxs, "decode.verify", "decode", t0, time.monotonic(),
                attrs={"batch": len(active), "k": k, "bucket": w,
                       "backend": self._backend})
        for slot in active:
            lane = self._lanes[slot]
            draft = drafts[slot]
            accepted = 0
            if draft is not None:
                while accepted < k and \
                        out[slot, accepted] == draft[accepted]:
                    accepted += 1
                self.metrics.inc("draft_accepted",
                                 min(accepted, real_lens[slot]))
            # accepted drafts ARE greedy tokens (they matched the
            # verifier's argmax); out[accepted] is the greedy token
            # after them (correction on a miss, bonus on a full hit)
            emit = ([] if draft is None
                    else [int(t) for t in draft[:accepted]])
            emit.append(int(out[slot, accepted]))
            take = min(len(emit), lane.remaining)
            lane.emitted.extend(emit[:take])
            lane.remaining -= take
            self.metrics.inc("tokens_out", take)
            self._pos[slot] += accepted + 1
            self._last[slot] = int(out[slot, accepted])
            if lane.remaining == 0 or lane.request.cancelled:
                self._finish(slot)

    def _step_megastep(self, active):   # hot-path
        """ONE fused dispatch advances every active lane by up to K
        tokens (up to K·(k+1) under ``spec_k``).  The host stages the
        inputs (with ``spec_k`` each lane's history rebuilt from its
        prompt and emitted tokens), runs the width's program, reads its
        packed output back in one copy, and settles every lane at the
        boundary."""
        K, k = self.megastep, self.spec_k
        # the most positions a lane can write in this dispatch: the copy-
        # on-write guard and the table width must cover every write
        span = K * (k + 1) + k if k else K
        active = self._cow_guard_active(active, span)
        if not active:
            return
        stage = self._ms_host
        stage["ptab"][:] = self._page_tables
        stage["last"][:] = self._last
        stage["pos"][:] = self._pos
        stage["left"][:] = 0
        for slot in active:
            stage["left"][slot] = self._lanes[slot].remaining
        if k:
            self._stage_histories(active)
        if self._sampling:
            stage["seeds"][:] = self._seeds(active)
        tctxs = ()
        if self._tracer is not None:
            tctxs = [self._lanes[s].request.trace for s in active]
        t0 = time.monotonic()
        try:
            self._fault("engine.step")
            w = self._live_width(span)
            res = self._run_fused(w)
        except Exception as e:   # noqa: BLE001 — fails the lanes
            if self._tracer is not None:
                self._tracer.add_many(
                    tctxs, "decode.megastep", "decode", t0,
                    time.monotonic(),
                    attrs={"batch": len(active), "K": K, "error": str(e)})
            self._fail_active(active, e)
            return
        # the packed output is read back: the card's work is done
        t1 = time.monotonic()
        S, c = self.slots, k + 1
        # the final carry: frozen lanes (prefilling or free ones too)
        # return what they came in with
        self._last = res[:S].copy()
        self._pos = res[S:2 * S].copy()
        emitted = res[2 * S:2 * S + K * S * c].reshape(K, S, c)
        wasted, total, lane_tokens = 0, 0, {}
        for slot in active:
            lane = self._lanes[slot]
            rows = emitted[:, slot, :]
            toks = rows[rows >= 0]          # iteration-major real tokens
            wasted += int((rows[:, 0] < 0).sum())
            lane.emitted.extend(int(t) for t in toks)
            lane.remaining -= len(toks)
            lane_tokens[slot] = len(toks)
            total += len(toks)
            self.metrics.inc("tokens_out", len(toks))
        if k:
            # in-graph drafts are always k wide: k proposed a live
            # iteration
            accs = res[2 * S + K * S * c:].reshape(K, S)
            self.metrics.inc("draft_tokens", k * int((accs >= 0).sum()))
            self.metrics.inc("draft_accepted",
                             int(numpy.clip(accs, 0, k).sum()))
        self.metrics.record_dispatch(len(active))
        self.metrics.record_decode_step(t1 - t0)
        self.metrics.inc("decode_dispatches")
        self.metrics.record_megastep(K, len(active), total, wasted)
        if self._tracer is not None:
            # ONE span a replay, recorded here on the host (a call in
            # the captured body would run at capture only), one dispatch
            # id shared by its lanes: the ledger counts the program once
            self._tracer.add_many(
                tctxs, "decode.megastep", "decode", t0, t1,
                attrs={"batch": len(active), "K": K, "tokens": total,
                       "bucket": "%sxK%d" % (w, K),
                       "backend": self._backend},
                each_attrs=[{"lane_tokens": lane_tokens[s]}
                            for s in active])
        for slot in active:
            lane = self._lanes[slot]
            if lane.remaining == 0 or lane.request.cancelled:
                self._finish(slot)

    def _stage_history(self, hist, hlen, row, lane):
        """Stage one lane's token history (prompt + emitted) at ``row``."""
        tokens = numpy.concatenate(
            [lane.request.prompt, numpy.asarray(lane.emitted, numpy.int32)])
        hist[row, :len(tokens)] = tokens
        hlen[row] = len(tokens)

    def _stage_histories(self, active):
        """Stage every active lane's history in its slot's row, the
        other rows zero."""
        stage = self._ms_host
        stage["hist"][:] = 0
        stage["hlen"][:] = 0
        for slot in active:
            self._stage_history(stage["hist"], stage["hlen"], slot,
                                self._lanes[slot])

    def _run_fused(self, w):
        """Upload the staged inputs, run width ``w``'s fused program and
        read its packed output back, one copy each way; returns the
        host array.  The copies are asynchronous (pinned both ways); the
        wait for the read-back is a declared transfer boundary, after
        which the pinned output is host data."""
        if self._ms_in is self._ms_stage:
            return self._megastep_program(w).numpy()
        self._ms_in.copy_(self._ms_stage, non_blocking=True)
        self._ms_out.copy_(self._megastep_program(w), non_blocking=True)
        with xfer.boundary():
            torch.cuda.current_stream(self.device).synchronize()
        return self._ms_out.numpy()

    def _stage_ring(self, pub):
        """Publish ``pub`` (the ready standby entries) into the staged
        inputs, zero-padded to the ring size R; padding table rows park
        on the scratch page as a free slot's do.  The program does not
        depend on how many are published: ``count`` 0 arms nothing."""
        stage = self._ms_host
        stage["ring_tab"][:] = KVPagePool.SCRATCH
        for name in ("ring_last", "ring_pos", "ring_left", "count"):
            stage[name][:] = 0
        if self.spec_k:
            stage["ring_hist"][:] = 0
            stage["ring_hlen"][:] = 0
        if self._sampling:
            stage["ring_seeds"][:] = 0
        for j, entry in enumerate(pub):
            stage["ring_tab"][j] = entry.table
            stage["ring_last"][j] = entry.last
            stage["ring_pos"][j] = entry.pos
            stage["ring_left"][j] = entry.lane.remaining
            if self.spec_k:
                self._stage_history(stage["ring_hist"], stage["ring_hlen"],
                                    j, entry.lane)
            if self._sampling:
                stage["ring_seeds"][j] = entry.lane.request.seed
        stage["count"][0] = len(pub)

    def _step_while(self, active):   # hot-path
        """ONE early-exit fused dispatch: the while program advances
        every active lane until all are drained and every published
        ring entry is armed — or K iterations, the cap — and arms the
        published standby entries into slots that drain inside it.
        The host's boundary work is :meth:`_step_megastep`'s plus: the
        REALISED iteration count read back (the books quote it, not the
        cap), each slot's emitted stream split between the outgoing lane
        and the entries armed into it (in arm order: a lane stops
        emitting only once drained, and entries arm in ring order),
        replacements that finished inside the program resolved, and the
        last unfinished one installed as the slot's lane."""
        K, k, S = self.megastep, self.spec_k, self.slots
        span = K * (k + 1) + k if k else K
        active = self._cow_guard_active(active, span)
        if not active:
            return
        stage = self._ms_host
        stage["ptab"][:] = self._page_tables
        stage["last"][:] = self._last
        stage["pos"][:] = self._pos
        # idle and prefilling slots enter at -1, so the arm never
        # touches a lane the host is prefilling
        stage["left"][:] = -1
        for slot in active:
            stage["left"][slot] = self._lanes[slot].remaining
        pub = []
        if self.refill_ring:
            # a free slot enters at 0: armable from the first iteration
            for slot in self._free:
                stage["left"][slot] = 0
            if self._peek_swap() is None:
                # nothing is published while a swap quiesces: an entry
                # prefilled on the old weights must not decode past it
                pub = [e for e in self._ring
                       if e.ready and not e.lane.request.cancelled]
            self._stage_ring(pub)
        if k:
            self._stage_histories(active)
        if self._sampling:
            stage["seeds"][:] = self._seeds(active)
        tctxs = ()
        if self._tracer is not None:
            # the published standby entries take part in this launch:
            # the span lands in their trees too
            tctxs = [self._lanes[s].request.trace for s in active] \
                + [e.lane.request.trace for e in pub]
        t0 = time.monotonic()
        try:
            self._fault("engine.step")
            w = self._live_width(span, max([e.pos for e in pub] or [0]))
            res = self._run_fused(w)
        except Exception as e:   # noqa: BLE001 — fails the participants
            if self._tracer is not None:
                self._tracer.add_many(
                    tctxs, "decode.megastep", "decode", t0,
                    time.monotonic(),
                    attrs={"batch": len(active) + len(pub), "K": K,
                           "error": str(e)})
            self._fail_active(active, e)
            for entry in pub:
                # ring occupants took part: they fail too, pages home
                self._fail_standby(entry, e)
            return
        t1 = time.monotonic()
        c = k + 1
        at = 2 * S + K * S * c + (K * S if k else 0)
        iters = int(res[at])
        self._count_while_launches(w, iters)
        self._last = res[:S].copy()
        self._pos = res[S:2 * S].copy()
        emitted = res[2 * S:2 * S + K * S * c].reshape(K, S, c)[:iters]
        armed = {}                      # slot -> entries, in arm order
        if self.refill_ring:
            for entry, s in zip(pub, res[at + 1:at + 1 + len(pub)]):
                if s >= 0:
                    armed.setdefault(int(s), []).append(entry)
                    self._ring.remove(entry)
        participants = sorted(set(active) | set(armed))
        wasted, total, lane_tokens = 0, 0, {}
        for slot in participants:
            rows = emitted[:, slot, :]
            toks = [int(t) for t in rows[rows >= 0]]
            wasted += int((rows[:, 0] < 0).sum())
            lane_tokens[slot] = len(toks)
            total += len(toks)
            self.metrics.inc("tokens_out", len(toks))
            owners = ([self._lanes[slot]] if slot in active else []) \
                + [e.lane for e in armed.get(slot, ())]
            for lane in owners:
                take = min(lane.remaining, len(toks))
                lane.emitted.extend(toks[:take])
                lane.remaining -= take
                toks = toks[take:]
        if k:
            accs = res[2 * S + K * S * c:at].reshape(K, S)[:iters]
            # in-graph drafts are always k wide: k proposed a live
            # iteration
            self.metrics.inc("draft_tokens", k * int((accs >= 0).sum()))
            self.metrics.inc("draft_accepted",
                             int(numpy.clip(accs, 0, k).sum()))
        n_armed = sum(len(v) for v in armed.values())
        if n_armed:
            self.metrics.inc("megastep_refills", n_armed)
        self.metrics.set_gauge("standby_ring_occupancy", len(self._ring))
        self.metrics.record_dispatch(len(participants))
        self.metrics.record_decode_step(t1 - t0)
        self.metrics.inc("decode_dispatches")
        # REALISED iterations, not the cap
        self.metrics.record_megastep(iters, len(participants), total,
                                     wasted)
        if self._tracer is not None:
            # one span a launch, with the iterations it realised
            self._tracer.add_many(
                tctxs, "decode.megastep", "decode", t0, t1,
                attrs={"batch": len(participants), "K": K,
                       "iters": iters, "tokens": total,
                       "bucket": "%sxK%d" % (w, K),
                       "backend": self._backend},
                each_attrs=[{"lane_tokens": lane_tokens.get(s, 0)}
                            for s in active]
                + [{"standby": True} for _ in pub])
        for slot in participants:
            if slot in active:
                lane = self._lanes[slot]
                if lane.remaining == 0 or lane.request.cancelled:
                    self._finish(slot)
            for entry in armed.get(slot, ()):
                lane = entry.lane
                if lane.remaining == 0 or lane.request.cancelled:
                    self._resolve_standby(entry)
                    continue
                # still decoding at the cap: the entry BECOMES the
                # slot's lane, with its full table row and the frontier
                # the program left
                self._lanes[slot] = lane
                if slot in self._free:
                    self._free.remove(slot)
                self._page_tables[slot] = entry.table
                self._pos[slot] = int(res[S + slot])
                self._last[slot] = int(res[slot])
            if self._lanes[slot] is None:
                # every owner drained: the slot parks on scratch at 0
                self._pos[slot] = 0
                self._last[slot] = 0
                self._page_tables[slot, :] = KVPagePool.SCRATCH

    # ---------------------------------------------------------- standby ring
    def _admit_ring(self):   # hot-path
        """Install READY standby entries into free slots on the host: the
        in-program arm is the ring's fast path, but a slot that frees at
        a boundary (or lanes that drained while the ring was still
        prefilling) must not wait for a drain inside a program that may
        never come.  Held while a swap quiesces."""
        if not self.refill_ring or self._peek_swap() is not None:
            return
        while self._free and self._ring:
            entry = next((e for e in self._ring if e.ready), None)
            if entry is None:
                return
            self._ring.remove(entry)
            lane = entry.lane
            if lane.request.cancelled:
                self._drop_standby(entry)
                continue
            slot = self._free.pop()
            self._lanes[slot] = lane
            self._page_tables[slot] = entry.table
            self._pos[slot] = entry.pos
            self._last[slot] = entry.last
            self.metrics.set_gauge("standby_ring_occupancy",
                                   len(self._ring))

    def _advance_ring(self):   # hot-path
        """One turn of standby-ring work: run ONE pending standby prompt
        chunk, or — when every slot is busy and the ring has room — take
        the queue head into a fresh standby entry.  Its pages are
        reserved all-or-nothing as :meth:`_admit_paged` reserves a
        lane's, with NO prefix-cache interaction: a standby page is
        never shared, so the in-program arm needs no copy-on-write."""
        if not self.refill_ring:
            return
        for entry in list(self._ring):
            # withdrawn entries give their pages home now
            if entry.lane.request.cancelled:
                self._drop_standby(entry)
        if self._peek_swap() is not None:
            # a quiescing swap: no standby prefill on the old weights
            return
        entry = next((e for e in self._ring if not e.ready), None)
        if entry is not None:
            self._advance_standby_chunk(entry)
            return
        if self._free or len(self._ring) >= self.refill_ring:
            return
        with self._cond:
            req = self._queue.popleft() if self._queue else None
            if req is not None:
                self._queued_tokens -= req.true_len
                self._queued_pages -= req.pages
                self.metrics.set_gauge("queue_depth", len(self._queue))
                self.metrics.set_gauge("queue_tokens", self._queued_tokens)
                self.metrics.set_gauge("queue_pages", self._queued_pages)
        if req is None:
            return
        if req.cancelled:
            self._trace_queue_end(req, "cancelled")
            req.future.cancel()
            return
        if time.monotonic() > req.deadline:
            self.metrics.record_shed()
            self._trace_queue_end(req, "shed")
            req.future.set_exception(DeadlineExceeded(
                "prompt shed after %.3fs in queue" % (
                    time.monotonic() - req.t_enq)))
            return
        pages = self._alloc_pages(req.pages)
        if pages is None:
            # pool pressure: back to the HEAD, as in _admit
            with self._cond:
                self._queue.appendleft(req)
                self._queued_tokens += req.true_len
                self._queued_pages += req.pages
                self.metrics.set_gauge("queue_depth", len(self._queue))
                self.metrics.set_gauge("queue_tokens", self._queued_tokens)
                self.metrics.set_gauge("queue_pages", self._queued_pages)
            return
        lane = _Slot(req)
        for p in pages:
            self._pool.pin(p)
        lane.pages.extend(pages)
        table = numpy.full(self._max_pages, KVPagePool.SCRATCH, numpy.int32)
        table[:len(pages)] = pages
        C = self.prefill_chunk
        n_full = (req.true_len - 1) // C
        for i in range(n_full):
            lane.pending.append((req.prompt[i * C:(i + 1) * C], i * C,
                                 False))
        tail = req.prompt[n_full * C:]
        if len(tail) < C:
            tail = numpy.pad(tail, (0, C - len(tail)))
        lane.pending.append((tail, n_full * C, True))
        self.metrics.record_queue_wait(time.monotonic() - req.t_enq)
        self._trace_admitted(req)
        entry = _Standby(lane, table)
        self._ring.append(entry)
        self._update_pool_gauges()
        self.metrics.set_gauge("standby_ring_occupancy", len(self._ring))
        self.metrics.set_gauge_max("standby_ring_peak", len(self._ring))
        # the creating turn runs the first chunk too, so a one-chunk
        # prompt is publishable at the very next dispatch
        self._advance_standby_chunk(entry)

    def _advance_standby_chunk(self, entry):   # hot-path
        """One prompt chunk of a standby lane (kernel 6, through
        :meth:`_chunk_program`) into its own pages; the tail chunk
        yields its first token and makes the entry ready."""
        lane = entry.lane
        req = lane.request
        tokens, start, is_tail = lane.pending.pop(0)
        last_idx = (req.true_len - 1 - start) if is_tail else 0
        t0 = time.monotonic()
        try:
            self._fault("engine.chunk")
            tok = self._chunk_program(entry.table, tokens, start, last_idx,
                                      *self._lane_seed(req))
            self._tfence(req.trace is not None)
            if is_tail:
                tok = int(xfer.to_host(tok))
        except Exception as e:   # noqa: BLE001 — fails THIS request
            self.metrics.record_error()
            self.warning("standby prefill failed: %s", e)
            if req.trace is not None:
                req.trace.tracer.add(
                    req.trace, "prefill.chunk", "prefill", t0,
                    time.monotonic(),
                    attrs={"start": int(start), "standby": True,
                           "error": str(e)})
            self._fail_standby(entry, e)
            return
        self.metrics.inc("prefill_dispatches")
        self.metrics.inc("prefill_tokens",
                         (req.true_len - start) if is_tail else len(tokens))
        self.metrics.record_decode_step(time.monotonic() - t0)
        if req.trace is not None:
            req.trace.tracer.add(
                req.trace, "prefill.chunk", "prefill", t0,
                time.monotonic(),
                attrs={"start": int(start), "tail": is_tail,
                       "standby": True, "bucket": self.prefill_chunk,
                       "paged": True, "backend": self._backend})
        if not is_tail:
            entry.pos = lane.pending[0][1]
            return
        lane.emitted.append(tok)
        lane.remaining -= 1
        req.t_first = time.monotonic()
        self.metrics.inc("tokens_out")
        self.metrics.record_ttft(req.t_first - req.t_enq)
        entry.pos = req.true_len
        entry.last = tok
        if lane.remaining == 0 or req.cancelled:
            self._ring.remove(entry)
            self._resolve_standby(entry)
            self.metrics.set_gauge("standby_ring_occupancy",
                                   len(self._ring))
            return
        entry.ready = True

    def _resolve_standby(self, entry):
        """A standby lane that FINISHED without holding a slot at a
        boundary (n_new 1 at its prefill tail, or armed and drained
        inside one program): pages home, future resolved — the ring's
        :meth:`_finish`."""
        self._release_lane(entry.lane)
        req = entry.lane.request
        fut = req.future
        if not fut.cancelled():
            fut.version = self.weights_version
            fut.ttft_s = req.t_first - req.t_enq
            fut.set_result(numpy.asarray(entry.lane.emitted, numpy.int32))

    def _drop_standby(self, entry):
        """A withdrawn standby entry: pages home, future cancelled."""
        if entry in self._ring:
            self._ring.remove(entry)
        self._release_lane(entry.lane)
        entry.lane.request.future.cancel()
        self.metrics.set_gauge("standby_ring_occupancy", len(self._ring))

    def _fail_standby(self, entry, exc):
        """Fail one standby entry to its client: pages home, future
        failed — ring occupants take part in a faulted dispatch as
        lanes do."""
        if entry in self._ring:
            self._ring.remove(entry)
        self._release_lane(entry.lane)
        fut = entry.lane.request.future
        if not fut.cancelled():
            fut.set_exception(exc)
        self.metrics.set_gauge("standby_ring_occupancy", len(self._ring))

    def _boundary_shed(self):   # hot-path
        """Deadline shedding at the loop's boundary: one sweep of the
        whole queue a turn (a megastep with ``megastep``), so a request
        whose deadline passes while every slot is busy gets its answer
        then, not when a slot frees.  A request already in a lane keeps
        decoding: its deadline governs only its wait in the queue.  A
        standby ring entry is admitted work too: its deadline is pushed
        forward at every sweep, so it is never shed.  The window quoted
        is the iteration cap (the while mode may realise fewer)."""
        now = time.monotonic()
        for entry in self._ring:
            entry.lane.request.deadline = max(entry.lane.request.deadline,
                                              now + self.deadline_s)
        shed = []
        with self._cond:
            if all(now <= req.deadline or req.cancelled
                   for req in self._queue):
                return
            keep = collections.deque()
            for req in self._queue:
                if not req.cancelled and now > req.deadline:
                    shed.append(req)
                    self._queued_tokens -= req.true_len
                    self._queued_pages -= req.pages
                else:
                    keep.append(req)
            self._queue = keep
            self.metrics.set_gauge("queue_depth", len(self._queue))
            self.metrics.set_gauge("queue_tokens", self._queued_tokens)
            self.metrics.set_gauge("queue_pages", self._queued_pages)
        window = self.megastep if self.megastep >= 2 else 1
        for req in shed:
            self.metrics.record_shed()
            self._trace_queue_end(req, "shed")
            req.future.set_exception(DeadlineExceeded(
                "prompt shed after %.3fs in queue (boundary sweep, "
                "window <= %d iterations)"
                % (time.monotonic() - req.t_enq, window)))

    def _worker(self):
        # grad mode is thread-local: the worker enters inference mode
        # itself
        with torch.inference_mode():
            self._serve_loop()

    def _serve_loop(self):
        rr = 0
        while True:
            if self._faults is not None:
                try:
                    self._faults.fire("engine.tick")
                except Exception as e:   # noqa: BLE001 — injected
                    # a raised tick fault poisons this turn: fail the
                    # busy lanes and keep serving
                    self._fail_active(
                        [i for i, ln in enumerate(self._lanes)
                         if ln is not None], e)
            # the transfer guard covers a turn's work, never the tick
            # fault's freeze or the idle wait below: its mode is
            # process-wide, and a caller's thread may read its own card
            # tensors while the engine idles
            with xfer.guard(self.device):
                busy, rr = self._serve_turn(rr)
            if busy:
                continue
            with self._cond:
                if self._stop:
                    break
                if self._ring:
                    # standby prefill still has host work: keep
                    # turning so the ring drains and installs
                    pass
                elif not self._queue:
                    self._cond.wait(0.5)
                elif self._pool_blocked:
                    # head request waiting on pages with no lane
                    # running to free any: only its deadline can
                    # resolve it — poll briefly so the shed is on time
                    self._cond.wait(0.05)
        # drain: a stopping engine fails whatever is still queued or in
        # a lane, and hands every page back to the pool
        with self._cond:
            pending = list(self._queue)
            self._queue.clear()
            self._queued_tokens = 0
            self._queued_pages = 0
            swap, self._pending_swap = self._pending_swap, None
        if swap is not None:
            # never strand a swap_weights caller on a stopping engine
            swap["exc"] = RuntimeError("LM engine stopped before the "
                                       "swap applied")
            swap["done"].set()
        for req in pending:
            self._trace_queue_end(req, "engine stopped")
            req.future.set_exception(RuntimeError("LM engine stopped"))
        for entry in list(self._ring):
            self._fail_standby(entry, RuntimeError("LM engine stopped"))
        for slot, lane in enumerate(self._lanes):
            if lane is not None:
                self._teardown_slot(slot, lane,
                                    RuntimeError("LM engine stopped"))

    def _serve_turn(self, rr):   # hot-path
        """One loop turn's work: a pending swap, the boundary sweep,
        admission and the ring, then at most ONE prompt chunk
        (round-robin over the prefilling lanes, ``rr`` the turn counter)
        and one decode dispatch for the lanes past prefill.  Returns
        (whether any lane is busy, the counter)."""
        self._maybe_apply_swap()
        # every expired queued request is shed now, not only those
        # the admission loop happens to pop
        self._boundary_shed()
        self._admit_ring()
        self._admit()
        self._advance_ring()
        busy = [i for i, lane in enumerate(self._lanes)
                if lane is not None]
        self.metrics.set_gauge("slots_busy", len(busy))
        self.metrics.set_gauge_max("slots_busy_peak", len(busy))
        if not busy:
            return False, rr
        prefilling = [i for i in busy if self._lanes[i].pending]
        if prefilling:
            rr += 1
            self._advance_prefill(prefilling[rr % len(prefilling)])
        active = [i for i, lane in enumerate(self._lanes)
                  if lane is not None and not lane.pending]
        if active:
            if self.megastep_mode == "while":
                self._step_while(active)
            elif self.megastep >= 2:
                self._step_megastep(active)
            elif self.spec_k:
                self._step_speculative(active)
            else:
                self._step_plain(active)
        return True, rr
