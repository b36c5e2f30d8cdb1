"""Workflow — the Unit container and host-side graph scheduler.

Port of ``veles_tpu/workflow.py``.  ``initialize(device=None)`` resolves
the device once (the CUDA card, or raise without one; the CPU only when
the caller passes ``device="cpu"``) and hands it to every unit.  The
scheduler below is the reference's, unchanged: PyTorch dispatches CUDA
work asynchronously just as XLA did, so the host loop races ahead the
same way.

Ref: veles/workflow.py::Workflow/StartPoint/EndPoint/Repeater [H] and
veles/thread_pool.py::ThreadPool [H] (SURVEY §2.1).

Scheduler design note (TPU-first, not a port): the reference executed each
``Unit.run`` on a Twisted thread pool, but the graph's control edges serialize
the critical path anyway (SURVEY §3.1).  On TPU all heavy work happens inside
asynchronously-dispatched XLA computations, so a deterministic sequential
event loop on the host is both simpler and faster (no GIL ping-pong): the
host thread races ahead queueing device work while XLA executes.  The hot
cycle additionally gets a fused compiled path (one jitted train_step traced
from the unit chain) used by the standard workflows; this event loop is the
general scheduler every graph (including arbitrary user graphs) runs under.
"""

from __future__ import annotations

import time
from collections import deque

from veles_tpu_torch.device import resolve_device
from veles_tpu_torch.units import Unit, TrivialUnit


class StartPoint(TrivialUnit):
    """The unique entry node; firing it starts the graph."""


class EndPoint(TrivialUnit):
    """The unique exit node; running it finishes the workflow."""

    def run(self):
        if self.workflow is not None:
            self.workflow.on_end_point()


class Repeater(TrivialUnit):
    """Control node that closes the training cycle.

    OR gate semantics: fires when ANY incoming link fires (the start point
    once, then the tail of the backward chain every iteration) — this is what
    makes the loader→forwards→decision→gds cycle loop (ref:
    veles/workflow.py::Repeater [H]).
    """

    def open_gate(self, src):
        for unit in self._links_from:
            self._links_from[unit] = False
        return True


class Workflow(Unit):
    """A Unit that contains units and runs them as a dataflow graph."""

    def __init__(self, workflow=None, name=None, **kwargs):
        self._units = []
        super().__init__(workflow, name=name, **kwargs)
        self.start_point = StartPoint(self, name="start_point")
        self.end_point = EndPoint(self, name="end_point")
        self._stopped = False
        self._finished = False
        self.iteration_limit = kwargs.get("iteration_limit", None)
        self.device = None

    # ------------------------------------------------------------- containers
    @property
    def units(self):
        return list(self._units)

    def add_ref(self, unit):
        if unit not in self._units:
            # Unit names key snapshot state and get_unit lookups, so they
            # must be unique within a workflow; suffix duplicates.
            base = unit.name
            taken = {u.name for u in self._units}
            if base in taken:
                n = 1
                while "%s_%d" % (base, n) in taken:
                    n += 1
                unit.name = "%s_%d" % (base, n)
            self._units.append(unit)
        unit.workflow = self

    def del_ref(self, unit):
        if unit in self._units:
            self._units.remove(unit)
        unit.workflow = None

    def __iter__(self):
        return iter(self._units)

    def __len__(self):
        return len(self._units)

    def get_unit(self, name):
        for unit in self._units:
            if unit.name == name:
                return unit
        raise KeyError(name)

    # -------------------------------------------------------------- lifecycle
    def initialize(self, device=None, **kwargs):
        """Initialize every unit.

        Units may raise :class:`DeferredInitError` (or return ``False``) to be
        retried after their producers initialize — mirrors the reference's
        deferred-initialization loop (ref: veles/workflow.py [M]).
        ``device`` None means the CUDA card (RuntimeError without one).
        """
        device = resolve_device(device)
        self.device = device
        pending = [u for u in self._units if u is not self]
        for _ in range(len(pending) + 1):
            deferred = []
            for unit in pending:
                try:
                    result = unit.initialize(device=device, **kwargs)
                except DeferredInitError:
                    deferred.append(unit)
                    continue
                if result is False:
                    deferred.append(unit)
            if not deferred:
                break
            if len(deferred) == len(pending):
                raise RuntimeError(
                    "initialization deadlock: %s" %
                    ", ".join(u.name for u in deferred))
            pending = deferred
        super().initialize(device=device, **kwargs)
        return self

    def run(self):
        """Fire the start point and pump the event loop until the end point.

        This is the reference's reactor + thread-pool execution collapsed
        into a deterministic host loop (see module docstring).
        """
        self._stopped = False
        self._finished = False
        iterations = 0
        queue = deque([self.start_point])
        self.start_point.run()
        while queue and not self._stopped and not self._finished:
            unit = queue.popleft()
            for succ in unit.links_to:
                if not succ.open_gate(unit):
                    continue
                if bool(succ.gate_block):
                    continue
                if not bool(succ.gate_skip):
                    begin = time.perf_counter()
                    succ.run()
                    succ.run_time += time.perf_counter() - begin
                    succ.run_count += 1
                if self._stopped or self._finished:
                    break
                queue.append(succ)
            iterations += 1
            if self.iteration_limit and iterations > self.iteration_limit:
                raise RuntimeError("workflow iteration limit exceeded")
        for unit in self._units:
            unit.stop()
        return self

    def on_end_point(self):
        self._finished = True

    def stop(self):
        self._stopped = True

    @property
    def is_finished(self):
        return self._finished

    # -------------------------------------------------------------- reporting
    def print_stats(self):
        """Per-unit wall-time accounting (ref: veles/timeit2.py [M]).  The
        reference's device time of one fused train step
        (``measure_device_step_time``) is not ported (ROADMAP Queue 2a,
        item 3), so fused workflows say so instead of printing it."""
        rows = sorted(self._units, key=lambda u: -u.run_time)
        total = sum(u.run_time for u in self._units)
        self.info("unit run-time breakdown (total %.3fs):", total)
        for unit in rows:
            if unit.run_count == 0:
                continue
            self.info("  %-30s %8d runs %10.3fs", unit.name, unit.run_count,
                      unit.run_time)
        if getattr(self, "_fused_runner", None) is not None:
            self.info("  fused train step (device): not measured in the "
                      "port (ROADMAP Queue 2a, item 3)")

    def graph_data(self):
        """(node_labels, edge_index_pairs) of the unit graph — the one
        structural source both the dot renderer below and the web-status
        SVG view consume."""
        units = list(self._units)
        ids = {u: i for i, u in enumerate(units)}
        edges = [(ids[u], ids[s]) for u in units
                 for s in u.links_to if s in ids]
        return [u.name for u in units], edges

    def generate_graph(self, filename=None):
        """Render the unit graph as graphviz dot text.

        Ref: veles/workflow.py::Workflow.generate_graph [M] — used by docs
        and the web status view.
        """
        nodes, edges = self.graph_data()
        lines = ["digraph %s {" % self.name.replace(" ", "_")]
        for i, label in enumerate(nodes):
            lines.append('  u%d [label="%s"];' % (i, label))
        for src, dst in edges:
            lines.append("  u%d -> u%d;" % (src, dst))
        lines.append("}")
        text = "\n".join(lines)
        if filename:
            with open(filename, "w", encoding="utf-8") as f:
                f.write(text)
        return text

    # --------------------------------------------------------------- snapshot
    def snapshot_state(self):
        """Collect the restorable state of every unit (SURVEY §5.4)."""
        from veles_tpu_torch import prng
        return {
            "workflow_class": type(self).__name__,
            "units": {u.name: u.state_dict() for u in self._units},
            "prng": prng.state_dict(),
        }

    def load_snapshot_state(self, state):
        from veles_tpu_torch import prng
        for name, d in state["units"].items():
            try:
                unit = self.get_unit(name)
            except KeyError:
                self.warning("snapshot has state for unknown unit %r", name)
                continue
            unit.load_state_dict(d)
        prng.load_state_dict(state.get("prng", {}))


class DeferredInitError(Exception):
    """Raised by Unit.initialize to request retry after producers init."""
