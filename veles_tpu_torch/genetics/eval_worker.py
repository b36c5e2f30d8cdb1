"""Subprocess fitness evaluator for population-parallel genetics.

Port of ``veles_tpu/genetics/eval_worker.py`` (ref: veles/genetics
forked one process per individual, SURVEY §3.5): reads a JSON spec on
stdin (config tree, gene values, sample module, seed, device, the
parent's process-wide settings), trains the sample to its stopping
criterion on the spec's device, and prints the fitness as one JSON line
on stdout.  A spec asking for the card in a process without one raises.

    python -m veles_tpu_torch.genetics.eval_worker < spec.json
"""

from __future__ import annotations

import importlib
import json
import sys


def main():
    spec = json.load(sys.stdin)
    from veles_tpu_torch.config import root
    from veles_tpu_torch.genetics import set_leaf
    from veles_tpu_torch.samples import run_sample
    from veles_tpu_torch.subproc import apply_process_state, worker_device

    device = worker_device(spec["device"])
    apply_process_state(spec["process"])
    root.update(spec["config"])
    for path, value in spec["genes"].items():
        set_leaf(path, value)
    module = importlib.import_module(spec["module"])
    wf = run_sample(module, seed=spec["seed"],
                    build_kwargs=spec.get("build_kwargs"), device=device)
    metric = wf.decision.best_metric
    print(json.dumps(
        {"fitness": None if metric is None else float(metric)}))


if __name__ == "__main__":
    main()
