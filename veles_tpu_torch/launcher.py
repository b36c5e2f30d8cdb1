"""Launcher — runs a workflow: initialize → (restore) → run → report.

Port of ``veles_tpu/launcher.py`` (ref: veles/launcher.py::Launcher [H],
SURVEY §2.1, §3.1).  ``boot`` initializes the workflow on the device
(the CUDA card unless the caller passes ``device="cpu"``), restores a
snapshot (a path, or ``"auto"``: the latest ``*_current`` one of the
workflow's snapshotter), gates an evaluation-only run, then trains
through the epoch-scan driver (``epoch_scan`` > 0 or ``stream_window``
> 0) or the unit-graph loop, and prints the run's statistics.

``distributed=True`` (``veles_tpu/launcher.py:80-130``) first joins the
run (:func:`veles_tpu_torch.parallel.initialize_multihost`: rank r on
``cuda:(r % device_count)``, NCCL when every rank has a card of its own,
gloo otherwise), shards the loader with ``shard_spmd`` from the mesh,
and drives the fused step through a data-parallel ``ShardedTrainer``
(every rank plans the same global minibatches and trains on its rows;
the gradient sums are all-reduced).  A restore is pushed back out to the
trainer (``reload_from_runner``).
"""

from __future__ import annotations

import time

from veles_tpu_torch.logger import Logger


class Launcher(Logger):
    """Owns the workflow lifecycle.

    Parameters
    ----------
    workflow: a built (not yet initialized) Workflow.
    snapshot: a snapshot path to resume from, or ``"auto"``.
    device: where to run (None: the CUDA card; raises without one).
    stats: print the per-unit run-time table at the end.
    profile: a directory; the run's ``torch.profiler`` trace is written
        there as a Chrome trace (``trace.json``).
    evaluate: one scoring pass over every set with every update gated
        off.
    epoch_scan: > 0 trains through the epoch-scan driver in chunks of
        this many epochs; ``stream_window`` > 0 streams the dataset in
        windows of this many minibatches (implies ``epoch_scan``), with
        ``stage_ahead`` windows staged ahead.
    distributed: join a multi-process data-parallel run at
        ``coordinator_address`` (``host:port``) as process
        ``process_id`` of ``num_processes``.
    """

    def __init__(self, workflow, snapshot=None, distributed=False,
                 stats=True, profile=None, evaluate=False, epoch_scan=0,
                 stream_window=0, stage_ahead=1, device=None,
                 coordinator_address=None, num_processes=None,
                 process_id=None):
        self.workflow = workflow
        self.snapshot = snapshot
        self.device = device
        self.epoch_scan = int(epoch_scan or 0)
        self.stream_window = int(stream_window or 0)
        if self.stream_window and not self.epoch_scan:
            self.epoch_scan = 1
        self.stage_ahead = int(stage_ahead or 1)
        self.evaluate = evaluate
        self.distributed = distributed
        self.coordinator_address = coordinator_address
        self.num_processes = num_processes
        self.process_id = process_id
        #: the backend the distributed run joined with (None otherwise)
        self.backend = None
        self.stats = stats
        self.profile = profile
        self.restored_payload = None
        self.run_seconds = None
        #: the epoch-scan driver of the last boot (None for the loop)
        self.driver = None

    def boot(self, **kwargs):
        """Bring everything up and run; returns the workflow."""
        wf = self.workflow
        device, mesh = self.device, None
        if self.distributed:
            from veles_tpu_torch import parallel
            index, count, self.backend = parallel.initialize_multihost(
                self.coordinator_address, self.num_processes,
                self.process_id, device)
            # lock-step data parallelism over every rank of the run:
            # each plans the same global minibatches and feeds its rows
            mesh = parallel.make_mesh()
            if mesh.device is not None:
                device = mesh.device
            loader = getattr(wf, "loader", None)
            if loader is not None:
                loader.shard_spmd(*parallel.spmd_loader_shard(mesh))
            self.info("joined distributed run as process %d/%d (%d-rank "
                      "mesh, %s)", index, count, mesh.size, self.backend)
        wf.initialize(device=device, **kwargs)
        if mesh is not None:
            runner = getattr(wf, "_fused_runner", None)
            if runner is None:
                raise ValueError("--distributed training needs a fused "
                                 "workflow (drop --no-fused)")
            from veles_tpu_torch.parallel import ShardedTrainer
            wf._sharded_trainer = ShardedTrainer(runner, mesh)
        snapshot = self.snapshot
        if snapshot == "auto":
            # resume from the latest published snapshot of this
            # workflow's snapshotter directory, or start fresh
            from veles_tpu_torch import snapshotter
            snap_unit = getattr(wf, "snapshotter", None)
            if snap_unit is None:
                raise ValueError("--snapshot auto needs a workflow with a "
                                 "snapshotter (set --snapshot-dir)")
            snapshot = snapshotter.find_current(snap_unit.directory,
                                                snap_unit.prefix)
            if snapshot is None:
                self.info("no snapshot in %s — starting fresh",
                          snap_unit.directory)
        if snapshot:
            from veles_tpu_torch import snapshotter
            self.restored_payload = snapshotter.restore(wf, snapshot)
            self.info("resumed from %s (epoch %s)", snapshot,
                      self.restored_payload.get("epoch"))
            trainer = getattr(wf, "_sharded_trainer", None)
            if trainer is not None:
                # the restore rewrote the units and the runner's state:
                # push it back out to this rank's trainer
                trainer.reload_from_runner()
        if self.evaluate:
            self._gate_evaluation(wf)
        if self.epoch_scan and self.evaluate:
            raise ValueError("--epoch-scan is a TRAINING driver; "
                             "--evaluate already runs one scoring pass")
        run = wf.run
        if self.epoch_scan:
            from veles_tpu_torch.epoch_driver import EpochScanDriver
            self.driver = EpochScanDriver(
                wf, chunk=self.epoch_scan, stream_window=self.stream_window,
                stage_ahead=self.stage_ahead)
            run = self.driver.run
        begin = time.perf_counter()
        if self.profile:
            self._profiled(run)
        else:
            run()
        self.run_seconds = time.perf_counter() - begin
        self.info("workflow %r finished in %.2fs", wf.name, self.run_seconds)
        if self.stats:
            wf.print_stats()
        return wf

    def _gate_evaluation(self, wf):
        """Evaluation only: every minibatch takes the eval path (no
        dropout, no backward, no key drawn), the snapshotter skips, and
        the Decision runs exactly one more pass with its best-so-far
        bookkeeping frozen."""
        from veles_tpu_torch.mutable import Bool
        always = Bool(True)
        wf.eval_only = True
        for gd in getattr(wf, "gds", []):
            gd.gate_skip = always
        commit = getattr(wf, "fused_commit", None)
        if commit is not None:
            commit.gate_skip = always
        snap = getattr(wf, "snapshotter", None)
        if snap is not None:
            snap.skip.set(True)
        dec = getattr(wf, "decision", None)
        if dec is None:
            raise ValueError("--evaluate needs a Decision-driven workflow")
        dec.max_epochs = int(wf.loader.epoch_number) + 1
        dec.fail_iterations = None
        dec.freeze_best = True
        dec.complete.set(False)

    def _profiled(self, run):
        """``run`` under ``torch.profiler`` (the card's activity too when
        the workflow runs there), its Chrome trace written to
        ``<self.profile>/trace.json``."""
        import os
        import torch
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if getattr(self.workflow, "device", None) is not None and \
                self.workflow.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            run()
            if ProfilerActivity.CUDA in activities:
                torch.cuda.synchronize()
        os.makedirs(self.profile, exist_ok=True)
        path = os.path.join(self.profile, "trace.json")
        prof.export_chrome_trace(path)
        self.info("profiler trace written to %s", path)

    def result_summary(self):
        """JSON-friendly run summary (the reference's --result-file)."""
        wf = self.workflow
        decision = getattr(wf, "decision", None)
        out = {"workflow": wf.name, "run_seconds": self.run_seconds}
        if decision is not None:
            out["best_metric"] = decision.best_metric
            out["best_epoch"] = decision.best_epoch
            if decision.epoch_metrics:
                out["last_epoch_metrics"] = {
                    set_name: {k: v for k, v in metrics.items()
                               if isinstance(v, (int, float))}
                    for set_name, metrics in
                    decision.epoch_metrics[-1].items()}
        snap = getattr(wf, "snapshotter", None)
        if snap is not None and snap.destination:
            out["snapshot"] = snap.destination
        return out
