"""Ensemble training and combined evaluation.

Port of ``veles_tpu/ensemble/__init__.py`` (ref: veles/ensemble/ [M]):
train N instances of a workflow (seed variations), collect per-model
results, then evaluate the combined model.  Combination averages the
members' softmax outputs over the validation set through ONE eval
forward (``FusedRunner.eval_forward``) shared by every member.

``train(workers=N)`` trains members across N worker subprocesses, each
on the device the parent resolved (the CUDA card unless the caller
passes ``device="cpu"``): each worker trains one member and saves a
snapshot in the port's format; the parent builds the member and
restores it through ``snapshotter.restore``, so parallel members are
bit-equal to sequential ones.  ``workers=0`` (default) trains members
sequentially in-process.
"""

from __future__ import annotations

import numpy

from veles_tpu_torch.loader.base import VALID
from veles_tpu_torch.logger import Logger


class EnsembleTrainer(Logger):
    """Train ``size`` members of a sample module (``run(load, main)``
    convention), seeds base_seed+i, on ``device`` (None: the CUDA card,
    raising without one), and combine them."""

    def __init__(self, module, size=4, base_seed=1, build_kwargs=None,
                 device=None):
        from veles_tpu_torch.device import resolve_device
        self.module = module
        self.size = size
        self.base_seed = base_seed
        self.build_kwargs = dict(build_kwargs or {})
        self.device = str(resolve_device(device))
        self.members = []       # (seed, workflow, summary)

    def train(self, workers=0):
        if workers > 0:
            return self._train_parallel(workers)
        from veles_tpu_torch.samples import run_sample
        for i in range(self.size):
            seed = self.base_seed + i
            wf = run_sample(self.module, seed=seed,
                            build_kwargs=self.build_kwargs,
                            device=self.device)
            summary = {"seed": seed,
                       "best_metric": wf.decision.best_metric,
                       "best_epoch": wf.decision.best_epoch}
            self.members.append((seed, wf, summary))
            self.info("member %d/%d (seed %d): best %s", i + 1, self.size,
                      seed, summary["best_metric"])
        return self

    def _build_member(self, seed):
        """Build + initialize (but do not train) one member workflow —
        the restore target for a worker-trained snapshot."""
        from veles_tpu_torch import prng
        prng.reset()
        prng.seed_all(seed)
        holder = {}

        def load(workflow_cls, **kwargs):
            kwargs.update(self.build_kwargs)
            wf = workflow_cls(None, **kwargs)
            holder["wf"] = wf
            return wf

        def main():
            holder["wf"].initialize(device=self.device)

        self.module.run(load, main)
        return holder["wf"]

    def _train_parallel(self, workers):
        import os
        import tempfile

        from veles_tpu_torch import snapshotter
        from veles_tpu_torch.config import root
        from veles_tpu_torch.subproc import (plain_config, process_state,
                                             run_workers)

        config_snapshot = plain_config(root.as_dict())
        state = process_state()
        with tempfile.TemporaryDirectory(prefix="ensemble_") as tmp:
            seeds = [self.base_seed + i for i in range(self.size)]
            specs = [{
                "config": config_snapshot,
                "module": self.module.__name__,
                "seed": seed,
                "build_kwargs": self.build_kwargs,
                "device": self.device, "process": state,
                "snapshot_path": os.path.join(tmp, "member_%d.pickle"
                                              % seed),
            } for seed in seeds]
            summaries = run_workers("veles_tpu_torch.ensemble.train_worker",
                                    specs, workers)
            for seed, spec, summary in zip(seeds, specs, summaries):
                wf = self._build_member(seed)
                snapshotter.restore(wf, spec["snapshot_path"])
                self.members.append((seed, wf, {
                    "seed": seed,
                    "best_metric": summary["best_metric"],
                    "best_epoch": summary["best_epoch"]}))
                self.info("member (seed %d): best %s [worker]", seed,
                          summary["best_metric"])
        return self

    # -- combined evaluation -------------------------------------------------
    def _eval_fn(self):
        """ONE eval forward for all members: topologies are identical and
        the state is an argument, so member 0's serves every member."""
        return self.members[0][1]._fused_runner.eval_forward()

    def evaluate_combined(self):
        """Average member probabilities on the validation set → n_err.

        All members must share the loader layout (same seed-independent
        dataset, e.g. real MNIST or a fixed-stream synthetic set).
        """
        if not self.members:
            raise ValueError("train() first")
        _, wf0, _ = self.members[0]
        loader = wf0.loader
        begin, end = loader.class_offsets()[VALID]
        if end <= begin:
            raise ValueError("no validation samples to combine on")
        data = loader.original_data.devmem[begin:end]
        labels = numpy.asarray(loader.original_labels.mem[begin:end])
        total = None
        per_member_err = []
        eval_fn = self._eval_fn()
        for _, wf, _ in self.members:
            probs = eval_fn(wf._fused_runner.state, data)
            per_member_err.append(int(
                (probs.argmax(1).cpu().numpy() != labels).sum()))
            total = probs if total is None else total + probs
        ens_err = int((total.argmax(1).cpu().numpy() != labels).sum())
        return {"members": per_member_err, "ensemble_n_err": ens_err,
                "count": len(labels)}


def train_ensemble(module, size=4, base_seed=1, build_kwargs=None,
                   workers=0, device=None):
    """One-call convenience: train + combined evaluation."""
    trainer = EnsembleTrainer(module, size=size, base_seed=base_seed,
                              build_kwargs=build_kwargs,
                              device=device).train(workers=workers)
    return trainer, trainer.evaluate_combined()
