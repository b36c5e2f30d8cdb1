"""Decision — the stopping/bookkeeping brain of a training workflow.

Port of ``veles_tpu/ops/decision.py`` (ref: veles/znicz/decision.py::
DecisionGD/DecisionMSE [H]): tracks per-set epoch
metrics and the best-so-far validation result, decides
``improved``/``complete``, and gates the backward pass off for
validation/test minibatches (``gd_skip``).

Per-minibatch metrics arrive as DEVICE tensors from the evaluator; they
are kept on the device, summed there at the set's boundary, and read to
the host in ONE transfer per set (no ``.item()`` per minibatch).
"""

from __future__ import annotations

import torch

from veles_tpu_torch.memory import numpy_dtype
from veles_tpu_torch.units import Unit
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.loader.base import TRAIN, CLASS_NAME


class DecisionBase(Unit):
    """Epoch bookkeeping common to all decisions."""

    snapshot_attrs = ("best_metric", "best_epoch", "epoch_metrics",
                      "complete", "improved")

    def __init__(self, workflow, max_epochs=None, fail_iterations=100,
                 **kwargs):
        super().__init__(workflow, **kwargs)
        self.max_epochs = max_epochs
        #: stop after this many epochs without validation improvement
        self.fail_iterations = fail_iterations
        #: evaluation-only runs: report metrics but never update
        #: best_metric/best_epoch/improved (a scoring pass must not
        #: rewrite the training run's bookkeeping)
        self.freeze_best = False
        self.complete = Bool(False)
        self.improved = Bool(False)
        #: True while the current minibatch must not update weights
        self.gd_skip = Bool(False)
        self.best_metric = None
        self.best_epoch = -1
        #: list of dicts: epoch -> {set_name: {metric: value}}
        self.epoch_metrics = []
        self._acc = {}           # class -> list of device metric dicts
        self._seen = {}          # class -> sample count
        self._last_class = None
        # linked from loader: minibatch_class, minibatch_size, last_minibatch,
        # class_lengths, epoch_number; from evaluator: metrics

    def initialize(self, device=None, **kwargs):
        self._reset_epoch()
        super().initialize(device=device, **kwargs)

    def _reset_epoch(self):
        self._acc = {}
        self._seen = {}
        self._last_class = None
        self._current = {}

    # -- per-minibatch -------------------------------------------------------
    def should_skip_gd(self, cls):
        """Gate the weight update off for this minibatch class (unsupervised
        decisions override: their trainers have no backward to gate)."""
        return cls != TRAIN

    def run(self):
        cls = self.minibatch_class
        if self._last_class is not None and cls != self._last_class:
            self._finalize_class(self._last_class)
        self._last_class = cls
        self.gd_skip.set(self.should_skip_gd(cls))
        acc = self._acc.setdefault(cls, [])
        acc.append(self.metrics)
        self._seen[cls] = self._seen.get(cls, 0) + int(self.minibatch_size)
        if self.last_minibatch:
            self._finalize_class(cls)
            self._on_epoch_end()
            self._reset_epoch()

    # -- boundaries ----------------------------------------------------------
    def _finalize_class(self, cls):
        """Sum one set's device metrics on the device and read them to
        the host in one transfer (every metric, int or float, fits a
        float64 exactly at these counts)."""
        batches = self._acc.get(cls)
        if not batches:
            return
        keys = list(batches[0])
        totals = [torch.stack([m[k] for m in batches]).sum(dim=0)
                  for k in keys]
        flat = torch.cat([t.reshape(-1).double() for t in totals]).cpu()
        host, at = {}, 0
        for key, total in zip(keys, totals):
            part = flat[at:at + total.numel()].numpy()
            at += total.numel()
            if total.dim() == 0:
                host[key] = float(part[0])
            else:
                host[key] = part.reshape(tuple(total.shape)).astype(
                    numpy_dtype(batches[0][key].dtype))
        host["count"] = self._seen.get(cls, 0)
        self._current[CLASS_NAME[cls]] = self.reduce_metrics(host)

    def reduce_metrics(self, host_totals):
        """Turn summed metrics into per-epoch numbers; subclasses extend."""
        count = max(host_totals.get("count", 1), 1)
        out = dict(host_totals)
        if "loss_sum" in out:
            out["loss"] = out.pop("loss_sum") / count
        return out

    def epoch_metric(self, set_metrics):
        """The scalar to minimize for improvement tracking."""
        raise NotImplementedError

    def _on_epoch_end(self):
        # the loader has already bumped epoch_number on the last minibatch,
        # so it equals the number of COMPLETED epochs here
        epoch = int(self.epoch_number)
        self.epoch_metrics.append(self._current)
        key_set = ("validation" if "validation" in self._current else
                   "train" if "train" in self._current else "test")
        key_metrics = self._current.get(key_set, {})
        # an empty set (0 live samples — e.g. an exhausted stream loader)
        # must not register as a perfect-score improvement
        metric = (self.epoch_metric(key_metrics)
                  if key_metrics.get("count", 0) > 0 else None)
        self.improved.set(
            not self.freeze_best and metric is not None and
            (self.best_metric is None or metric < self.best_metric))
        if bool(self.improved):
            self.best_metric = metric
            self.best_epoch = epoch
        self.log_epoch(epoch)
        done = False
        if self.max_epochs is not None and epoch >= self.max_epochs:
            done = True
        if (self.best_epoch >= 0 and self.fail_iterations is not None and
                epoch - self.best_epoch >= self.fail_iterations):
            done = True
        if done:
            self.complete.set(True)

    def reevaluate_complete(self, epoch):
        """Would this decision (with its CURRENT limits) still be complete at
        ``epoch``?  Used by snapshot resume: fine-tuning may raise
        max_epochs, reopening a completed run.  Kept next to _on_epoch_end so
        the two stopping rules stay in lockstep; subclasses with different
        stopping logic override both."""
        out_of_epochs = (self.max_epochs is not None
                         and epoch >= self.max_epochs)
        stalled = (self.best_epoch >= 0 and self.fail_iterations is not None
                   and epoch - self.best_epoch >= self.fail_iterations)
        return out_of_epochs or stalled

    def log_epoch(self, epoch):
        parts = []
        for set_name, metrics in self._current.items():
            parts.append("%s: %s" % (set_name, self.format_metrics(metrics)))
        self.info("epoch %d — %s%s", epoch, "; ".join(parts),
                  " *" if bool(self.improved) else "")

    def format_metrics(self, metrics):
        return ", ".join("%s=%.6g" % (k, v) for k, v in metrics.items()
                         if isinstance(v, (int, float)))


class DecisionGD(DecisionBase):
    """Classification decision: minimizes validation error count %.

    Ref: veles/znicz/decision.py::DecisionGD [H].
    """

    def reduce_metrics(self, host_totals):
        out = super().reduce_metrics(host_totals)
        count = max(out.get("count", 1), 1)
        if "n_err" in out:
            out["n_err"] = int(out["n_err"])
            out["err_pct"] = 100.0 * out["n_err"] / count
        return out

    def epoch_metric(self, set_metrics):
        return set_metrics.get("n_err")


class DecisionMSE(DecisionBase):
    """Regression/autoencoder decision: minimizes validation RMSE.

    Ref: veles/znicz/decision.py::DecisionMSE [H].
    """

    def reduce_metrics(self, host_totals):
        out = super().reduce_metrics(host_totals)
        count = max(out.get("count", 1), 1)
        if "mse_sum" in out:
            out["rmse"] = (out.pop("mse_sum") / count) ** 0.5
        return out

    def epoch_metric(self, set_metrics):
        return set_metrics.get("rmse")
