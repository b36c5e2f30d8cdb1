"""Restricted Boltzmann machine units (contrastive-divergence training).

Port of ``veles_tpu/ops/rbm.py`` (ref: veles/znicz/rbm_units.py [M]): the
whole CD-k step is one function per train minibatch
(:func:`veles_tpu_torch.ops.functional.rbm_cd_step`), in the same
training-cycle shape as the Kohonen trainer.  Every random draw is
``jax.random.bernoulli``'s stream bit for bit, through the hand-written
Bernoulli kernel on the card (one launch a draw: the visible
binarization, then one a Gibbs step).  The keys are host words: a train
step takes ``prng.get("rbm").key()``, the binarization draws with
``fold_in(key, 0xB1)`` and Gibbs step i with ``fold_in(fold_in(key, 1),
i)``; validation minibatches draw nothing and leave the stream alone.
"""

from __future__ import annotations

import numpy
import torch

from veles_tpu_torch import prng
from veles_tpu_torch.accel import AcceleratedUnit
from veles_tpu_torch.memory import Vector
from veles_tpu_torch.workflow import DeferredInitError
from veles_tpu_torch.ops import functional as F
from veles_tpu_torch.ops.kohonen import KohonenDecision


class RBMTrainer(AcceleratedUnit):
    """CD-k trainer owning (weights, vbias, hbias).

    ``input`` is expected in [0, 1] (probability scale).
    """

    snapshot_attrs = ("weights", "vbias", "hbias", "time")

    def __init__(self, workflow, n_hidden=128, learning_rate=0.05, cd_k=1,
                 weights_stddev=0.01, binarize_input=True, **kwargs):
        super().__init__(workflow, **kwargs)
        self.n_hidden = int(n_hidden)
        self.learning_rate = float(learning_rate)
        self.cd_k = int(cd_k)
        self.weights_stddev = float(weights_stddev)
        #: Bernoulli-sample the visible layer per step (the reference's
        #: Binarization unit)
        self.binarize_input = binarize_input
        self.weights = Vector()
        self.vbias = Vector()
        self.hbias = Vector()
        self.time = 0
        self.metrics = {}

    def initialize(self, device=None, **kwargs):
        if not hasattr(self, "input") or self.input.is_empty:
            raise DeferredInitError(self.name)
        n_vis = int(numpy.prod(self.input.shape[1:]))
        if self.weights.is_empty:
            stream = prng.get("init")
            w = numpy.zeros((n_vis, self.n_hidden), self.dtype)
            stream.fill_normal(w, 0.0, self.weights_stddev)
            self.weights.reset(w)
            self.vbias.reset(numpy.zeros(n_vis, self.dtype))
            self.hbias.reset(numpy.zeros(self.n_hidden, self.dtype))
        super().initialize(device=device, **kwargs)

    def _is_train_minibatch(self):
        """CD updates only on TRAIN minibatches (never in eval-only
        runs) — held-out sets are scored without touching parameters."""
        return self.is_train_minibatch()

    def step(self, w, vb, hb, v, mask, key):
        """One CD-k update from the host key ``key``."""
        v = v.reshape(v.shape[0], -1)
        if self.binarize_input:
            v = F.bernoulli(prng.fold_in(key, 0xB1), v)
        return F.rbm_cd_step(w, vb, hb, v, mask, prng.fold_in(key, 1),
                             self.learning_rate, self.cd_k)

    def evaluate(self, w, vb, hb, v, mask):
        v = v.reshape(v.shape[0], -1)
        h = F.rbm_hidden(v, w, hb)
        recon = F.rbm_visible(h, w, vb)
        err = torch.sqrt((((v - recon) * mask[:, None]) ** 2).sum(dim=1)).sum()
        return {"recon_sum": err, "loss_sum": err}

    def run(self):
        if not self._is_train_minibatch():
            self.metrics = self.evaluate(
                self.weights.devmem, self.vbias.devmem, self.hbias.devmem,
                self.input.devmem, self.mask.devmem)
            return
        key = prng.get("rbm").key()
        new_w, new_vb, new_hb, metrics = self.step(
            self.weights.devmem, self.vbias.devmem, self.hbias.devmem,
            self.input.devmem, self.mask.devmem, key)
        self.weights.assign_device(new_w)
        self.vbias.assign_device(new_vb)
        self.hbias.assign_device(new_hb)
        self.metrics = metrics
        self.time += 1


class RBMForward(AcceleratedUnit):
    """Hidden-probability forward: output = P(h=1 | input).

    ``weights``/``hbias`` link_attrs'd from the trainer.
    """

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.output = Vector()

    def initialize(self, device=None, **kwargs):
        if not hasattr(self, "input") or self.input.is_empty:
            raise DeferredInitError(self.name)
        if not hasattr(self, "weights") or self.weights.is_empty:
            raise DeferredInitError(self.name)
        mb = self.input.shape[0]
        self.output.reset(numpy.zeros((mb, self.weights.shape[1]),
                                      self.dtype))
        super().initialize(device=device, **kwargs)

    def run(self):
        self.output.assign_device(F.rbm_hidden(
            self.input.devmem, self.weights.devmem, self.hbias.devmem))


class RBMDecision(KohonenDecision):
    """Epoch bookkeeping on the reconstruction error."""

    def reduce_metrics(self, host_totals):
        out = super().reduce_metrics(host_totals)
        count = max(out.get("count", 1), 1)
        if "recon_sum" in out:
            out["recon_err"] = out.pop("recon_sum") / count
        return out

    def epoch_metric(self, set_metrics):
        return set_metrics.get("recon_err")
