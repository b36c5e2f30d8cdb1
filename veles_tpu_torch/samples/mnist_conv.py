"""MNIST convolutional sample — the reference's deep MNIST variant.

Port of ``veles_tpu/samples/mnist_conv.py`` (ref: veles/znicz/samples/
MNIST/mnist_conv.py(-ish) [M]): a LeNet-style conv + pooling topology
over 28x28x1 MNIST images, on the port's :class:`MnistLoader` (real IDX
files when present, the bit-equal synthetic stand-in otherwise) in its
NHWC layout.
"""

from __future__ import annotations

from veles_tpu_torch.config import root
from veles_tpu_torch.samples.mnist import MnistLoader
from veles_tpu_torch.standard_workflow import StandardWorkflow


class MnistConvLoader(MnistLoader):
    """MNIST in the conv layout (N, 28, 28, 1)."""

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("sample_shape", (28, 28, 1))
        super().__init__(workflow, **kwargs)


class MnistConvWorkflow(StandardWorkflow):
    """28x28x1 → conv32 → pool → conv64 → pool → 100 tanh → 10 softmax."""


def default_config():
    root.mnist_conv.defaults({
        "loader": {"minibatch_size": 100, "n_train": 60000,
                   "n_valid": 10000},
        "decision": {"max_epochs": 10, "fail_iterations": 50},
        # strict-relu convs with explicit gaussian init, as the
        # reference's conv sample configs pin weights_filling/stddev
        "layers": [
            {"type": "conv_str", "n_kernels": 32, "kx": 5, "ky": 5,
             "padding": "SAME", "learning_rate": 0.02, "momentum": 0.9,
             "weights_filling": "gaussian", "weights_stddev": 0.05},
            {"type": "max_pooling", "kx": 2, "ky": 2},
            {"type": "conv_str", "n_kernels": 64, "kx": 5, "ky": 5,
             "padding": "SAME", "learning_rate": 0.02, "momentum": 0.9,
             "weights_filling": "gaussian", "weights_stddev": 0.05},
            {"type": "max_pooling", "kx": 2, "ky": 2},
            {"type": "all2all_tanh", "output_sample_shape": 100,
             "learning_rate": 0.02, "momentum": 0.9},
            {"type": "softmax", "output_sample_shape": 10,
             "learning_rate": 0.02, "momentum": 0.9},
        ],
    })
    return root.mnist_conv


from veles_tpu_torch.samples import make_sample  # noqa: E402

build, train, run = make_sample("mnist_conv", MnistConvWorkflow,
                                MnistConvLoader, default_config)
