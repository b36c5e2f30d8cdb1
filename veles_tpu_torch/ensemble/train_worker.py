"""Subprocess member trainer for parallel ensembles.

Port of ``veles_tpu/ensemble/train_worker.py`` (ref: veles/ensemble
evaluated member runs across slaves, SURVEY §2.1/§3.5): one member.
Reads a JSON spec on stdin (config tree, sample module, seed, device,
the parent's process-wide settings, snapshot path), trains on the
spec's device, saves the workflow's snapshot in the port's format
(``snapshotter.save``) to ``snapshot_path`` and prints the member
summary as one JSON line.  The parent restores the snapshot into its
own workflow instance (``snapshotter.restore``).

    python -m veles_tpu_torch.ensemble.train_worker < spec.json
"""

from __future__ import annotations

import importlib
import json
import sys


def main():
    spec = json.load(sys.stdin)
    from veles_tpu_torch import snapshotter
    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples import run_sample
    from veles_tpu_torch.subproc import apply_process_state, worker_device

    device = worker_device(spec["device"])
    apply_process_state(spec["process"])
    root.update(spec["config"])
    module = importlib.import_module(spec["module"])
    wf = run_sample(module, seed=spec["seed"],
                    build_kwargs=spec.get("build_kwargs"), device=device)
    snapshotter.save(wf, spec["snapshot_path"])
    print(json.dumps({"seed": spec["seed"],
                      "best_metric": wf.decision.best_metric,
                      "best_epoch": wf.decision.best_epoch}))


if __name__ == "__main__":
    main()
