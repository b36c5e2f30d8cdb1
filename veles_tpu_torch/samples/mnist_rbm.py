"""MNIST RBM sample — CD-1 feature learning on binarized digits.

Port of ``veles_tpu/samples/mnist_rbm.py`` (ref: veles/znicz samples
exercising rbm_units [M]): the Kohonen sample's non-SGD cycle shape —
Repeater → Loader → RBMTrainer → RBMDecision — over the port's MNIST
loader rescaled to [0, 1].  Every step's Bernoulli draws run on the
card's Bernoulli kernel; entry points run on the CUDA card unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

from veles_tpu_torch.config import root
from veles_tpu_torch.ops.nn_units import NNWorkflow
from veles_tpu_torch.ops.rbm import RBMTrainer, RBMForward, RBMDecision
from veles_tpu_torch.samples import make_trainer_sample
from veles_tpu_torch.samples.mnist import MnistLoader
from veles_tpu_torch.workflow import Repeater


class MnistRBMLoader(MnistLoader):
    """MNIST rescaled from [-1, 1] to [0, 1] (Bernoulli probability scale)."""

    def load_data(self):
        super().load_data()
        self.original_data.reset((self.original_data.mem + 1.0) / 2.0)


class MnistRBMWorkflow(NNWorkflow):
    def __init__(self, workflow=None, name=None, loader_config=None,
                 trainer_config=None, decision_config=None, **kwargs):
        super().__init__(workflow, name=name, **kwargs)
        self.repeater = Repeater(self, name="repeater")
        self.repeater.link_from(self.start_point)

        self.loader = MnistRBMLoader(self, name="loader",
                                     **(loader_config or {}))
        self.loader.link_from(self.repeater)

        self.trainer = RBMTrainer(self, name="trainer",
                                  **(trainer_config or {}))
        self.trainer.link_from(self.loader)
        self.trainer.link_attrs(self.loader, ("input", "minibatch_data"),
                                ("mask", "minibatch_mask"),
                                "minibatch_class")

        self.decision = RBMDecision(self, name="decision",
                                    **(decision_config or {}))
        self.decision.link_from(self.trainer)
        self.decision.link_attrs(self.loader, "minibatch_class",
                                 "minibatch_size", "last_minibatch",
                                 "class_lengths", "epoch_number")
        self.decision.link_attrs(self.trainer, "metrics")

        self.forward = RBMForward(self, name="forward")
        self.forward.link_attrs(self.loader, ("input", "minibatch_data"))
        self.forward.link_attrs(self.trainer, "weights", "hbias")
        self.forward.link_from(self.decision)
        self.forward.gate_skip = ~self.decision.complete

        self.repeater.link_from(self.decision)
        self.end_point.link_from(self.forward)
        self.end_point.gate_block = ~self.decision.complete


def default_config():
    root.mnist_rbm.defaults({
        "loader": {"minibatch_size": 100, "n_train": 60000, "n_valid": 0},
        "trainer": {"n_hidden": 256, "learning_rate": 0.05, "cd_k": 1},
        "decision": {"max_epochs": 10, "fail_iterations": 20},
    })
    return root.mnist_rbm


build, train, run = make_trainer_sample("mnist_rbm", MnistRBMWorkflow,
                                        default_config)
