"""Kohonen self-organizing map units (unsupervised).

Port of ``veles_tpu/ops/kohonen.py`` (ref: veles/znicz/kohonen.py::
KohonenForward/KohonenTrainer [H]): the trainer owns a non-gradient
update rule, one batch update per train minibatch
(:func:`veles_tpu_torch.ops.functional.kohonen_update`), with the
learning-rate and neighbourhood-radius decay schedules on the host.  Its
metrics stay on the device until the decision reads a set's sum.
"""

from __future__ import annotations

import numpy
import torch

from veles_tpu_torch import prng
from veles_tpu_torch.accel import AcceleratedUnit
from veles_tpu_torch.memory import Vector
from veles_tpu_torch.workflow import DeferredInitError
from veles_tpu_torch.ops import functional as F
from veles_tpu_torch.ops.decision import DecisionBase


def grid_coords(sy, sx):
    """(sy*sx, 2) float32 grid coordinates, row-major like the reference's
    rectangular SOM layout."""
    yy, xx = numpy.mgrid[0:sy, 0:sx]
    return numpy.stack([yy.ravel(), xx.ravel()], axis=1).astype(numpy.float32)


class KohonenTrainer(AcceleratedUnit):
    """SOM trainer: shape (sy, sx) codebook over the input features.

    Decay schedules, as the reference's: ``lr(t) = lr0 / (1 + t/T)`` and
    ``σ(t) = max(σ0 / (1 + t/T), σ_min)``, t counted in train minibatches
    and T = ``decay_steps``; each value reaches the device as one fp32
    fill, never read back.
    """

    snapshot_attrs = ("weights", "time")

    def __init__(self, workflow, shape=(8, 8), learning_rate=0.2,
                 sigma=None, sigma_min=0.5, decay_steps=1000,
                 weights_filling="uniform", weights_stddev=0.1, **kwargs):
        super().__init__(workflow, **kwargs)
        self.shape = tuple(shape)
        self.learning_rate0 = float(learning_rate)
        self.sigma0 = float(sigma) if sigma else max(self.shape) / 2.0
        self.sigma_min = float(sigma_min)
        self.decay_steps = int(decay_steps)
        self.weights_filling = weights_filling
        self.weights_stddev = weights_stddev
        self.weights = Vector()
        self.grid = Vector()
        self.time = 0
        self.metrics = {}
        # self.input linked from the loader's minibatch_data; self.mask from
        # minibatch_mask

    @property
    def n_neurons(self):
        return self.shape[0] * self.shape[1]

    def initialize(self, device=None, **kwargs):
        if not hasattr(self, "input") or self.input.is_empty:
            raise DeferredInitError(self.name)
        n_in = int(numpy.prod(self.input.shape[1:]))
        if self.weights.is_empty:
            stream = prng.get("init")
            w = numpy.zeros((self.n_neurons, n_in), self.dtype)
            if self.weights_filling == "uniform":
                stream.fill(w, -self.weights_stddev, self.weights_stddev)
            else:
                stream.fill_normal(w, 0.0, self.weights_stddev)
            self.weights.reset(w)
        self.grid.reset(grid_coords(*self.shape))
        super().initialize(device=device, **kwargs)

    def _is_train_minibatch(self):
        """Update only on TRAIN minibatches (and never in eval-only
        runs): evaluation sets must not leak into the codebook."""
        return self.is_train_minibatch()

    def schedules(self):
        t = self.time / max(self.decay_steps, 1)
        lr = self.learning_rate0 / (1.0 + t)
        sigma = max(self.sigma0 / (1.0 + t), self.sigma_min)
        return lr, sigma

    def evaluate(self, weights, x, mask):
        _, dmin = F.kohonen_winners(x, weights)
        qe = (torch.sqrt(torch.clamp_min(dmin, 0.0)) * mask).sum()
        return {"qe_sum": qe, "loss_sum": qe}

    def run(self):
        if not self._is_train_minibatch():
            self.metrics = self.evaluate(self.weights.devmem,
                                         self.input.devmem, self.mask.devmem)
            return
        lr, sigma = self.schedules()
        new_w, metrics = F.kohonen_update(
            self.weights.devmem, self.input.devmem, self.mask.devmem,
            self.grid.devmem, lr, sigma)
        self.weights.assign_device(new_w)
        self.metrics = metrics
        self.time += 1


class KohonenForward(AcceleratedUnit):
    """SOM forward: winner index (+ min distance) per sample.

    ``weights`` is link_attrs'd from the trainer; ``output`` holds the
    int32 winner indices and ``distances`` the per-sample quantization
    errors; ``hits`` accumulates per-neuron win counts of the live rows
    across calls.  Each call reads the winners and the mask back in one
    transfer (it runs on demand, outside the training cycle).
    """

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.output = Vector()
        self.distances = Vector()
        self.hits = None

    def initialize(self, device=None, **kwargs):
        if not hasattr(self, "input") or self.input.is_empty:
            raise DeferredInitError(self.name)
        if not hasattr(self, "weights") or self.weights.is_empty:
            raise DeferredInitError(self.name)
        mb = self.input.shape[0]
        self.output.reset(numpy.zeros(mb, numpy.int32))
        self.distances.reset(numpy.zeros(mb, self.dtype))
        self.hits = numpy.zeros(self.weights.shape[0], numpy.int64)
        super().initialize(device=device, **kwargs)

    def reset_hits(self):
        self.hits[:] = 0

    def run(self):
        winners, dmin = F.kohonen_winners(self.input.devmem,
                                          self.weights.devmem)
        self.output.assign_device(winners.to(torch.int32))
        self.distances.assign_device(dmin)
        # short minibatches are padded with duplicates of row 0 (masked
        # dead) — counting them would inflate that row's winner
        if hasattr(self, "mask") and not self.mask.is_empty:
            host = torch.stack([winners.to(dmin.dtype),
                                self.mask.devmem]).cpu().numpy()
            live = host[0][host[1] > 0].astype(numpy.int64)
        else:
            live = winners.cpu().numpy()
        numpy.add.at(self.hits, live, 1)


class KohonenDecision(DecisionBase):
    """Tracks the epoch quantization error; improvement = lower mean QE.

    The SOM update runs on every train minibatch (there is no backward
    pass to gate), so gd_skip stays False.
    """

    def should_skip_gd(self, cls):
        return False

    def reduce_metrics(self, host_totals):
        out = super().reduce_metrics(host_totals)
        count = max(out.get("count", 1), 1)
        if "qe_sum" in out:
            out["qerr"] = out.pop("qe_sum") / count
        return out

    def epoch_metric(self, set_metrics):
        return set_metrics.get("qerr")
