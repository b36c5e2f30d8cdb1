"""CIFAR-10 residual conv net — the ``residual`` layer types in the zoo.

Port of ``veles_tpu/samples/cifar_resnet.py``: a stem, an identity block
(conv-conv-add, SAME padding keeps shapes skip-compatible), a
downsampling block with a projected skip (``residual_proj``), another
identity block, then avg-pool and softmax, on the CIFAR loader.  The
skip edges ride the fused engine (``compiled.py``).
"""

from __future__ import annotations

from veles_tpu_torch.config import root
from veles_tpu_torch.samples.cifar import CifarLoader
from veles_tpu_torch.standard_workflow import StandardWorkflow


class CifarResNetWorkflow(StandardWorkflow):
    """Small residual conv net (two identity blocks, one projected)."""


def _conv(channels, lr, stride=1):
    return {"type": "conv_str", "n_kernels": channels, "kx": 3, "ky": 3,
            "sliding": stride, "padding": "SAME", "learning_rate": lr,
            "momentum": 0.9, "weights_filling": "gaussian",
            "weights_stddev": 0.05}


def _block(channels, lr):
    """conv -> conv -> add-input: one identity residual block."""
    return [_conv(channels, lr), _conv(channels, lr),
            {"type": "residual", "skip": 2}]


def _down_block(channels, lr):
    """Downsampling block: the main path strides 2 and widens; the skip
    path is a 1x1/stride-2 projection (``residual_proj``)."""
    return [_conv(channels, lr, stride=2), _conv(channels, lr),
            {"type": "residual_proj", "skip": 2, "n_kernels": channels,
             "sliding": 2, "learning_rate": lr, "momentum": 0.9,
             "weights_filling": "gaussian", "weights_stddev": 0.05}]


def default_config():
    lr = 0.02
    root.cifar_resnet.defaults({
        "loader": {"minibatch_size": 100, "n_train": 50000,
                   "n_valid": 10000},
        "decision": {"max_epochs": 20, "fail_iterations": 100},
        "layers": [
            # the stem sets the channel width the identity blocks keep
            {"type": "conv_str", "n_kernels": 32, "kx": 5, "ky": 5,
             "padding": "SAME", "learning_rate": lr, "momentum": 0.9,
             "weights_filling": "gaussian", "weights_stddev": 0.05},
            {"type": "max_pooling", "kx": 2, "ky": 2},
            *_block(32, lr),
            *_down_block(64, lr),      # 16x16x32 -> 8x8x64, projected skip
            *_block(64, lr),
            {"type": "avg_pooling", "kx": 2, "ky": 2},
            {"type": "softmax", "output_sample_shape": 10,
             "learning_rate": lr, "momentum": 0.9},
        ],
    })
    return root.cifar_resnet


from veles_tpu_torch.samples import make_sample  # noqa: E402

build, train, run = make_sample("cifar_resnet", CifarResNetWorkflow,
                                CifarLoader, default_config)
