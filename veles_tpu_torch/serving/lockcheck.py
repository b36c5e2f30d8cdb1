"""Lock-order witness — runtime concurrency checking for the serving
tier.

Port of ``veles_tpu/serving/lockcheck.py``, whole.  The serving stack
holds its locks across several modules (the engine's and the batcher's
``_cond``; the metrics', fault plans', tracer's, time-series store's
and SLO monitor's ``_lock``), and the rules that keep them
deadlock-free ("never hold a lock across a card dispatch") live in
docstrings.  This module makes them checkable at runtime, the
``faults.py`` way:

- UNARMED IS ONE NONE-CHECK.  Serving locks are built through
  :func:`make_lock` / :func:`make_condition`, thin wrappers whose
  acquire/release cost, when no witness is armed, is a module-global
  ``_witness is None`` check on top of the real ``threading``
  primitive.
- ARMED IN TESTS.  ``tests/torch_witness.py`` arms a
  :class:`LockOrderWitness` around the port's serving suites: every
  acquisition records an edge ``held-lock → acquired-lock`` in a
  global lock-order graph, every NEW edge runs a cycle check, and the
  engines' dispatch sites report to the witness so a lock held while a
  program runs on the device (or while a fence synchronizes the
  stream) is caught too.  Violations carry BOTH stacks — where the
  held lock was taken and where the conflict happened — and the arming
  fixture fails the test loudly on any.

Lock IDENTITY is two-level: edges are keyed by ROLE (the name passed
to the factory, e.g. ``"lm_engine._cond"``), so the order rule learned
from one engine protects the next; re-entrancy is tracked per
INSTANCE, so holding two engines' ``_cond`` at once is a self-edge
cycle (a real hazard) while a Condition's internal re-acquire after
``wait()`` is not.
"""

from __future__ import annotations

import sys
import threading

#: the armed witness (None = every shim is a single None-check)
_witness = None

#: sites that put work on the DEVICE: a tracked lock held while one of
#: these runs serializes every other thread behind device wall time —
#: the lock-held-across-dispatch class of bug the witness flags
#: (``engine.prefill`` is the contiguous layout's whole-prompt site,
#: kept with the reference's set though the port has only the paged one)
DISPATCH_SITES = frozenset((
    "engine.prefill", "engine.chunk", "engine.cow", "engine.step",
    "engine.verify", "engine.fence", "batcher.dispatch",
))


class LockOrderViolation(AssertionError):
    """A lock-order cycle or a lock held across a device dispatch —
    raised by tests that opt in, and always recorded on the witness's
    ``violations`` list (the arming fixture asserts it empty)."""


def arm(witness):
    """Install ``witness`` globally; returns it.  Tracked locks start
    reporting on their next acquisition — arm BEFORE building the
    engines under test only if you want construction covered too."""
    global _witness
    _witness = witness
    return witness


def disarm():
    """Remove the armed witness (shims fall back to the None-check)."""
    global _witness
    _witness = None


def armed():
    return _witness


def note_dispatch(site):
    """Device-dispatch hook for code not using the engines' built-in
    ``_fault`` sites — one None-check when unarmed.  (The serving hot
    paths — ``lm_engine._fault``/``_tfence``, ``batcher._dispatch`` —
    inline the ``lockcheck._witness is not None`` check instead of
    calling here: an attribute test with no function call is the
    unarmed-is-free discipline those sites are bound to.)"""
    w = _witness
    if w is not None:
        w.dispatch(site)


def _stack(skip=2, limit=8):
    """A compact (file, line, function) stack for violation evidence —
    ``sys._getframe`` walk, formatted lazily (armed-path cost only)."""
    frames = []
    try:
        f = sys._getframe(skip)
    except ValueError:
        return ()
    while f is not None and len(frames) < limit:
        code = f.f_code
        frames.append((code.co_filename, f.f_lineno, code.co_name))
        f = f.f_back
    return tuple(frames)


def _fmt_stack(frames):
    if not frames:
        return "    <no stack captured>"
    return "\n".join("    %s:%d in %s" % fr for fr in frames)


class LockOrderWitness:
    """Records the per-thread lock-acquisition graph and flags
    ordering cycles (potential deadlocks) and locks held across device
    dispatches; see the module docstring.  ``raise_on_violation``
    additionally raises :class:`LockOrderViolation` at the detection
    point (tests asserting a deliberate inversion); either way every
    violation lands on ``violations`` with both stacks."""

    def __init__(self, name="lock-witness", raise_on_violation=False,
                 max_violations=32):
        self.name = name
        self.raise_on_violation = bool(raise_on_violation)
        self.max_violations = int(max_violations)
        #: formatted violation reports (the arming fixture's assert)
        self.violations = []
        self.acquisitions = 0
        self.dispatch_checks = 0
        self._tls = threading.local()
        #: role -> set of roles acquired while holding it, plus the
        #: first-observed stacks per edge (evidence for the report).
        #: Guarded by _meta — a RAW lock, deliberately outside the
        #: tracked system (the witness must never witness itself).
        self._edges = {}         # role -> {role}
        self._edge_ev = {}       # (a, b) -> (stack_holding_a, stack_b)
        self._meta = threading.Lock()

    # -------------------------------------------------------------- held
    def _held(self):
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def held_roles(self):
        """The calling thread's held lock roles, outermost first."""
        return [role for _, role, _ in self._held()]

    # -------------------------------------------------------- violations
    def _violate(self, report):
        with self._meta:
            if len(self.violations) < self.max_violations:
                self.violations.append(report)
        if self.raise_on_violation:
            raise LockOrderViolation(report)

    # ------------------------------------------------------ acquisition
    def before_acquire(self, lock):
        """Called by a tracked lock before blocking on the primitive:
        adds ``held → lock`` edges and cycle-checks every new one (the
        potential deadlock is flagged even when this run's interleaving
        never actually deadlocks)."""
        held = self._held()
        self.acquisitions += 1
        if not held:
            return
        stk = None
        for inst, role, inst_stk in held:
            if inst is lock:
                if not lock._reentrant:
                    self._violate(
                        "re-acquire of non-reentrant lock %r already "
                        "held by this thread (self-deadlock)\n"
                        "  first acquired at:\n%s\n  re-acquired at:\n%s"
                        % (lock.name, _fmt_stack(inst_stk),
                           _fmt_stack(_stack(3))))
                continue
            if role == lock.name:
                # two INSTANCES of one role held together (two engines'
                # _cond, two metrics' _lock): a self-edge cycle
                self._violate(
                    "two %r instances held by one thread (instance "
                    "self-cycle)\n  first acquired at:\n%s\n"
                    "  second acquired at:\n%s"
                    % (lock.name, _fmt_stack(inst_stk),
                       _fmt_stack(_stack(3))))
                continue
            edge = (role, lock.name)
            with self._meta:
                known = lock.name in self._edges.get(role, ())
                if not known:
                    if stk is None:
                        stk = _stack(3)
                    self._edges.setdefault(role, set()).add(lock.name)
                    self._edge_ev[edge] = (inst_stk, stk)
                    cycle = self._find_path(lock.name, role)
                else:
                    cycle = None
            if cycle:
                path = [lock.name] + cycle
                ev = []
                for a, b in zip(path, path[1:]):
                    ha, hb = self._edge_ev.get(
                        (a, b), ((), ()))
                    ev.append("  edge %s -> %s:\n   holding %s at:\n%s"
                              "\n   acquiring %s at:\n%s"
                              % (a, b, a, _fmt_stack(ha), b,
                                 _fmt_stack(hb)))
                self._violate(
                    "lock-order cycle: %s (acquiring %r while holding "
                    "%r closes the loop)\n"
                    "  holding %s at:\n%s\n  acquiring %s at:\n%s\n%s"
                    % (" -> ".join(path + [path[0]]), lock.name, role,
                       role, _fmt_stack(inst_stk), lock.name,
                       _fmt_stack(stk if stk is not None
                                  else _stack(3)),
                       "\n".join(ev)))

    def _find_path(self, src, dst):
        """DFS ``src -> ... -> dst`` over the edge graph (meta lock
        held).  Returns the role path src..dst, or None."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            for nxt in self._edges.get(node, ()):
                if nxt == dst:
                    return path + [dst]
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def after_acquire(self, lock, reacquire=False):
        """The primitive is now held: push it on the thread's stack.
        ``reacquire`` marks a Condition re-taking its lock after
        ``wait()`` — no new edges (they were recorded at the original
        acquire).  The held-entry evidence is ONE caller frame — full
        stacks are captured only at violation/new-edge time, so the
        armed per-acquisition cost stays a getframe + an append (the
        serving suites cross this millions of times per run)."""
        if reacquire:
            self._held().append((lock, lock.name, ()))
            return
        f = sys._getframe(2)
        code = f.f_code
        self._held().append((lock, lock.name,
                             ((code.co_filename, f.f_lineno,
                               code.co_name),)))

    def on_release(self, lock):
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is lock:
                del held[i]
                return

    # ---------------------------------------------------------- dispatch
    def dispatch(self, site):
        """A device dispatch (or fence) at ``site``: no tracked lock
        may be held — a held lock would serialize every other thread
        behind device wall time, and on a wedged device, forever."""
        if site not in DISPATCH_SITES:
            return
        self.dispatch_checks += 1
        held = self._held()
        if held:
            inst, role, stk = held[-1]
            self._violate(
                "lock %r held across device dispatch %r\n"
                "  lock acquired at:\n%s\n  dispatch at:\n%s"
                % (role, site, _fmt_stack(stk),
                   _fmt_stack(_stack(3))))

    # ------------------------------------------------------------ report
    def report(self):
        with self._meta:
            return {"name": self.name,
                    "acquisitions": self.acquisitions,
                    "dispatch_checks": self.dispatch_checks,
                    "edges": {a: sorted(bs)
                              for a, bs in sorted(self._edges.items())},
                    "violations": list(self.violations)}


class TrackedLock:
    """``threading.Lock`` with the witness shim — non-reentrant, so a
    same-thread re-acquire is itself reported (it would deadlock)."""

    __slots__ = ("_lock", "name")
    _reentrant = False

    def __init__(self, name):
        self._lock = threading.Lock()
        self.name = name

    def acquire(self, blocking=True, timeout=-1):
        w = _witness
        if w is not None:
            w.before_acquire(self)
        got = self._lock.acquire(blocking, timeout)
        if got and _witness is not None:
            _witness.after_acquire(self)
        return got

    def release(self):
        if _witness is not None:
            _witness.on_release(self)
        self._lock.release()

    def locked(self):
        return self._lock.locked()

    def __enter__(self):
        w = _witness
        if w is not None:
            w.before_acquire(self)
        self._lock.acquire()
        if _witness is not None:
            _witness.after_acquire(self)
        return self

    def __exit__(self, *exc):
        if _witness is not None:
            _witness.on_release(self)
        self._lock.release()
        return False


class TrackedCondition:
    """``threading.Condition`` with the witness shim.  The underlying
    lock is the Condition's own RLock, so the wrapper is re-entrant
    like the primitive; ``wait()`` pops the held entry for its sleep
    and re-pushes on wake (edge-free — the order was recorded at the
    original acquire)."""

    __slots__ = ("_cond", "name")
    _reentrant = True

    def __init__(self, name):
        self._cond = threading.Condition()
        self.name = name

    def __enter__(self):
        w = _witness
        if w is not None:
            w.before_acquire(self)
        self._cond.__enter__()
        if _witness is not None:
            _witness.after_acquire(self)
        return self

    def __exit__(self, *exc):
        if _witness is not None:
            _witness.on_release(self)
        return self._cond.__exit__(*exc)

    def wait(self, timeout=None):
        w = _witness
        if w is not None:
            w.on_release(self)
        try:
            return self._cond.wait(timeout)
        finally:
            if _witness is not None:
                _witness.after_acquire(self, reacquire=True)

    def wait_for(self, predicate, timeout=None):
        w = _witness
        if w is not None:
            w.on_release(self)
        try:
            return self._cond.wait_for(predicate, timeout)
        finally:
            if _witness is not None:
                _witness.after_acquire(self, reacquire=True)

    def notify(self, n=1):
        self._cond.notify(n)

    def notify_all(self):
        self._cond.notify_all()


def make_lock(name):
    """A serving-tier mutex: witness-tracked under ``name`` when a
    witness is armed, a plain fast lock otherwise (the wrapper's
    unarmed cost is one module-global None-check per operation)."""
    return TrackedLock(name)


def make_condition(name):
    """A serving-tier condition variable, same discipline."""
    return TrackedCondition(name)
