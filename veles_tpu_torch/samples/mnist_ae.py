"""MNIST convolutional autoencoder sample — BASELINE.json configs[3] (AE).

Port of ``veles_tpu/samples/mnist_ae.py`` (ref: veles/znicz/samples/
MnistAE/mnist_ae.py [H]): a conv encoder mirrored by depooling + deconv,
trained with the MSE evaluator against the input image itself (the
target aliases the loader's minibatch_data, the reference's wiring).
"""

from __future__ import annotations

from veles_tpu_torch.config import root
from veles_tpu_torch.standard_workflow import StandardWorkflow
from veles_tpu_torch.samples.mnist import MnistLoader


class MnistAELoader(MnistLoader):
    """MNIST as NHWC images (N, 28, 28, 1) in [-1, 1] for the conv stack."""

    def load_data(self):
        super().load_data()
        data = self.original_data.mem
        self.original_data.reset(data.reshape(len(data), 28, 28, 1))


class MnistAEWorkflow(StandardWorkflow):
    """conv(tanh) → avg_pool ∥ depool → deconv, MSE on the input."""


def default_config():
    root.mnist_ae.defaults({
        "loader": {"minibatch_size": 100, "n_train": 60000, "n_valid": 10000},
        "decision": {"max_epochs": 10, "fail_iterations": 20},
        "layers": [
            {"type": "conv_tanh", "n_kernels": 16, "kx": 5, "ky": 5,
             "padding": "SAME", "learning_rate": 0.0001, "momentum": 0.9},
            {"type": "avg_pooling", "kx": 2, "ky": 2},
            {"type": "depooling", "kx": 2, "ky": 2},
            {"type": "deconv", "n_kernels": 1, "kx": 5, "ky": 5,
             "padding": "SAME", "learning_rate": 0.0001, "momentum": 0.9},
        ],
    })
    return root.mnist_ae


from veles_tpu_torch.samples import make_sample  # noqa: E402

build, train, run = make_sample("mnist_ae", MnistAEWorkflow, MnistAELoader,
                                default_config, loss_function="mse")
