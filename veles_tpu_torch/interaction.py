"""Interactive shell unit: drop into a REPL mid-graph.

Port of ``veles_tpu/interaction.py`` (ref: veles/interaction.py::Shell
[M]): a unit that opens an IPython session inside the running graph.
IPython when importable, the standard library's ``code.interact``
otherwise; a process without a tty skips with a warning instead of
blocking, so graphs with a Shell unit still run in batch jobs.
"""

from __future__ import annotations

import sys

from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.units import Unit


class Shell(Unit):
    """Gate with ``shell.gate_skip = <Bool>``, or keep ``once=True`` (the
    default) to break only on the first pass."""

    def __init__(self, workflow, once=True, banner=None, **kwargs):
        super().__init__(workflow, **kwargs)
        self.once = once
        self.banner = banner or (
            "veles_tpu_torch shell — `wf` is the workflow, `unit` this "
            "unit; Ctrl-D resumes the graph.")
        self.fired = Bool(False)

    def interact(self, local):
        """Runs the REPL (tests replace it)."""
        try:
            from IPython import embed
            embed(user_ns=local, banner1=self.banner)
        except ImportError:
            import code
            code.interact(banner=self.banner, local=local)

    def run(self):
        if self.once and bool(self.fired):
            return
        if not sys.stdin.isatty():
            self.warning("no tty — skipping interactive shell")
            self.fired.set(True)
            return
        self.fired.set(True)
        self.interact({"wf": self.workflow, "unit": self,
                       "workflow": self.workflow})
