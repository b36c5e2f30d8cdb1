"""Explicit host↔card transfer shims and the transfer-guard witness.

Port of ``veles_tpu/serving/xfer.py`` over
``torch.cuda.set_sync_debug_mode``.  The serving hot path must never
move data between the host and the card IMPLICITLY: a blocking
``torch.as_tensor(..., device=...)`` upload, a ``.cpu()`` / ``.item()``
/ ``int()`` read of a card tensor or a stream synchronize is a round
trip the host waits on that no span names.  Every legitimate boundary
is made explicit here, and the witness makes everything else fail:

- :func:`to_device` — a host value (python scalar, list or numpy array)
  → a tensor on the card, copied with ``non_blocking=True``
  (a contiguous pinned source is a DMA; a pageable one CUDA stages
  before the call returns, so the source may be reused at once).  THE
  way a hot-path method builds a dispatch argument.
- :func:`to_host` — a card tensor (or a dict/list/tuple tree of them) →
  numpy, read inside :func:`boundary`.  THE way a hot-path method reads
  a program's output back.
- :func:`arm` / :func:`disarm` / :func:`guard` / :func:`boundary` — the
  RUNTIME WITNESS (the ``lockcheck`` discipline): tests and the card
  script arm a mode, the engine's worker enters ``guard(device)`` around
  the work of each loop turn (and around ``start()``'s warm-up), and the
  batcher's worker around each dispatch on a machine with a card.  While a
  guard is open and no boundary is, the card's sync debug mode is
  ``"error"`` (``"disallow"``) or ``"warn"`` (``"log"``): a synchronizing
  copy or stream synchronize outside a boundary raises, through the
  failing request's future.  Unarmed, ``guard()`` and ``boundary()``
  are one module-global None-check and a shared null context.

Three ways this differs from jax's ``transfer_guard``:

- the sync debug mode is PROCESS-WIDE, not thread-local.  The module
  keeps a raw-lock-guarded count of open guards and open boundaries;
  the mode is the armed one exactly while at least one guard is open
  and no boundary is, and the last guard to close puts back the mode
  that was set before the first opened.  A boundary on any thread
  (the caller's swap staging, a fence) lifts the mode for every thread
  while it is open;
- the guard is entered around the work of a loop turn, never around
  the worker's idle ``wait``, so a caller's thread reading its own card
  tensors while the engine idles is not caught;
- ``set_sync_debug_mode`` initializes CUDA, so a guard on a CPU device
  is a null context and never touches the mode (the CPU has nothing to
  synchronize).

A device→device copy is free under the mode, as under the reference's
host-edge-only guard.
"""

from __future__ import annotations

import contextlib
import threading

import numpy
import torch

#: the armed modes and the sync debug mode each sets while a guard is
#: open (``torch.cuda.get_sync_debug_mode`` reads 0 / 1 / 2)
MODES = {"allow": 0, "log": 1, "disallow": 2}

#: armed transfer-guard mode ("disallow" / "log" / "allow") or None
#: (unarmed); written by arm()/disarm() before the workers start, read
#: once per guard()/boundary() entry
_mode = None

_NULL = contextlib.nullcontext()

#: the open guards and boundaries and the mode to put back, guarded by
#: a RAW lock (the lock-order witness never sees it)
_state = threading.Lock()
_guards = 0
_boundaries = 0
#: the sync debug mode before the first open guard, and the mode this
#: module last set (None while no guard is open)
_prior = None
_applied = None


def arm(mode="disallow"):
    """Arm the transfer-guard witness: every ``guard()`` entered after
    this (engine worker turns, warm-up, the batcher's dispatches) sets the
    card's sync debug mode for ``mode``.  Call before
    ``LMEngine.start()``.  Anything but disallow / log / allow raises
    ValueError and leaves the module as it was."""
    global _mode
    if mode not in MODES:
        raise ValueError("transfer-guard mode must be disallow/log/"
                         "allow (got %r)" % (mode,))
    _mode = mode


def disarm():
    global _mode
    _mode = None


def armed():
    return _mode is not None


def _set_mode(mode):
    """Set the card's sync debug mode and read it back: an armed guard
    whose mode did not take raises (no fallback hides the card)."""
    global _applied
    torch.cuda.set_sync_debug_mode(mode)
    got = torch.cuda.get_sync_debug_mode()
    if got != mode:
        raise RuntimeError("the transfer guard set the sync debug mode to "
                           "%r but the card reads %r" % (mode, got))
    _applied = mode


def _apply():
    """The mode the open guards and boundaries call for (``_state``
    held, at least one guard open)."""
    want = (MODES[_mode] if _mode is not None and not _boundaries
            else _prior)
    if want != _applied:
        _set_mode(want)


def _enter_guard():
    global _guards, _prior, _applied
    with _state:
        if _guards == 0:
            _prior = _applied = torch.cuda.get_sync_debug_mode()
        _guards += 1
        try:
            _apply()
        except BaseException:
            _guards -= 1
            raise


def _leave_guard():
    global _guards, _applied
    with _state:
        _guards -= 1
        if _guards:
            _apply()
        else:
            if _applied != _prior:
                _set_mode(_prior)
            _applied = None


def _enter_boundary():
    global _boundaries
    with _state:
        _boundaries += 1
        if _guards:
            _apply()


def _leave_boundary():
    global _boundaries
    with _state:
        _boundaries -= 1
        if _guards:
            _apply()


@contextlib.contextmanager
def _guarded():
    _enter_guard()
    try:
        yield
    finally:
        _leave_guard()


@contextlib.contextmanager
def _bounded():
    _enter_boundary()
    try:
        yield
    finally:
        _leave_boundary()


def _card(device):
    """Whether ``device`` (None: the card, by the port's rule) is a card."""
    return device is None or torch.device(device).type == "cuda"


def guard(device=None):
    """The context a worker's turn runs under: the armed sync debug mode
    while it is open on a card (``device``; None means the card), a null
    context when unarmed or on the CPU."""
    if _mode is None or not _card(device):
        return _NULL
    return _guarded()


def boundary():
    """A DECLARED transfer boundary: within it the card may be read and
    the stream synchronized even under an open guard — the engine's one
    read-back a dispatch, its fences, the swap's staging, the batcher's
    ``forward`` (user code whose transfers are its own).  Unarmed: a
    null context."""
    if _mode is None:
        return _NULL
    return _bounded()


def to_device(x, dtype=None, device=None):
    """EXPLICIT host→card transfer: ``x`` (scalar, list or numpy array)
    as a contiguous host tensor of numpy ``dtype`` (None: its own),
    copied to ``device`` (None: the card) with ``non_blocking=True``.
    On the CPU the host tensor itself (sharing ``x``'s memory where
    numpy would)."""
    arr = numpy.asarray(x, dtype)
    # ascontiguousarray makes a scalar (1,): keep the shape
    host = torch.as_tensor(numpy.ascontiguousarray(arr).reshape(arr.shape))
    return host.to(torch.device("cuda" if device is None else device),
                   non_blocking=True)


def _numpy_tree(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _numpy_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_numpy_tree(v) for v in x)
    return numpy.asarray(x)


def to_host(x):
    """EXPLICIT card→host transfer: a tensor (or a dict/list/tuple tree
    of them) as numpy, read inside :func:`boundary`; a leaf that is no
    tensor goes through ``numpy.asarray``.  Blocks until the values are
    ready — the fence a span that ends after it may credit."""
    with boundary():
        return _numpy_tree(x)
