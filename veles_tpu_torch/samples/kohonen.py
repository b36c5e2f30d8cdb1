"""Kohonen SOM sample — BASELINE.json configs[3] (the Kohonen part).

Port of ``veles_tpu/samples/kohonen.py`` (ref: veles/znicz/samples/
Kohonen/kohonen.py [H]): an unsupervised SOM on a 2-D point cloud, in a
NON-SGD training cycle — Repeater → Loader → KohonenTrainer →
KohonenDecision — with the forward outside the cycle, run once at
completion.  The synthetic cloud is bit-equal to the reference's (one
pinned host stream).  Runs on the CUDA card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import numpy

from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.ops.kohonen import (KohonenTrainer, KohonenForward,
                                         KohonenDecision)
from veles_tpu_torch.ops.nn_units import NNWorkflow
from veles_tpu_torch.samples import make_trainer_sample
from veles_tpu_torch.workflow import Repeater


class KohonenLoader(FullBatchLoader):
    """Synthetic 2-D point cloud: a few Gaussian blobs (stream
    "kohonen_synth"), train-set only — the SOM is unsupervised."""

    def __init__(self, workflow, n_train=2000, n_blobs=5, **kwargs):
        super().__init__(workflow, **kwargs)
        self.n_train = n_train
        self.n_blobs = n_blobs
        self.has_labels = False

    def load_data(self):
        stream = prng.get("kohonen_synth", pinned=True)
        centers = stream.uniform(-1.0, 1.0, (self.n_blobs, 2)).astype(
            numpy.float32)
        which = numpy.arange(self.n_train) % self.n_blobs
        noise = stream.normal(0.0, 0.15, (self.n_train, 2)).astype(
            numpy.float32)
        self.original_data.reset(centers[which] + noise)
        self.class_lengths = [0, 0, self.n_train]


class KohonenWorkflow(NNWorkflow):
    """The unsupervised SOM training cycle."""

    def __init__(self, workflow=None, name=None, loader_config=None,
                 trainer_config=None, decision_config=None, **kwargs):
        super().__init__(workflow, name=name, **kwargs)
        self.repeater = Repeater(self, name="repeater")
        self.repeater.link_from(self.start_point)

        self.loader = KohonenLoader(self, name="loader",
                                    **(loader_config or {}))
        self.loader.link_from(self.repeater)

        self.trainer = KohonenTrainer(self, name="trainer",
                                      **(trainer_config or {}))
        self.trainer.link_from(self.loader)
        self.trainer.link_attrs(self.loader, ("input", "minibatch_data"),
                                ("mask", "minibatch_mask"),
                                "minibatch_class")

        self.decision = KohonenDecision(self, name="decision",
                                        **(decision_config or {}))
        self.decision.link_from(self.trainer)
        self.decision.link_attrs(self.loader, "minibatch_class",
                                 "minibatch_size", "last_minibatch",
                                 "class_lengths", "epoch_number")
        self.decision.link_attrs(self.trainer, "metrics")

        self.forward = KohonenForward(self, name="forward")
        self.forward.link_attrs(self.loader, ("input", "minibatch_data"),
                                ("mask", "minibatch_mask"))
        self.forward.link_attrs(self.trainer, "weights")
        # forward sits OUTSIDE the cycle: it classifies on demand after
        # training, gated by the decision's completion
        self.forward.link_from(self.decision)
        self.forward.gate_skip = ~self.decision.complete

        self.repeater.link_from(self.decision)
        self.end_point.link_from(self.forward)
        self.end_point.gate_block = ~self.decision.complete


def default_config():
    root.kohonen.defaults({
        "loader": {"minibatch_size": 100, "n_train": 2000},
        "trainer": {"shape": (8, 8), "learning_rate": 0.2,
                    "decay_steps": 200},
        "decision": {"max_epochs": 10, "fail_iterations": 20},
    })
    return root.kohonen


build, train, run = make_trainer_sample("kohonen", KohonenWorkflow,
                                        default_config)
