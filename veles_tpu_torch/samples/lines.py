"""Lines sample — generated geometric images, orientation classification.

Port of ``veles_tpu/samples/lines.py`` (ref: veles/znicz/samples Lines
demo [H]): images of straight lines in four orientation classes
(horizontal, /, vertical, \\), each with a random center, angle jitter,
thickness and background noise, classified by a small conv net
(conv_str, max pool, conv_str, max pool, softmax) through the port's
StandardWorkflow — one fused-SGD launch a train step on the card.  The
generated set is bit-equal to the reference's (one pinned host stream,
vectorized numpy).  Runs on the CUDA card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import numpy

from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.samples import make_sample
from veles_tpu_torch.standard_workflow import StandardWorkflow

#: class angle centers (radians): 0=horizontal, 1=/, 2=vertical, 3=\
ANGLES = numpy.array([0.0, 0.25, 0.5, 0.75]) * numpy.pi
N_CLASSES = len(ANGLES)


def draw_lines(stream, n, hw=32, jitter=0.12, noise=0.25):
    """(n, hw, hw, 1) float32 images in [-1, 1] + (n,) int32 labels.

    Each image is exp(-d²/2σ²) of the distance field to a random line of
    the class's orientation — vectorized over samples and pixels.
    """
    labels = numpy.arange(n, dtype=numpy.int32) % N_CLASSES
    stream.shuffle(labels)
    theta = (ANGLES[labels]
             + stream.uniform(-jitter, jitter, n) * numpy.pi)
    # line through a random interior point, direction (cos t, sin t);
    # normal distance d = |(p - c) · (-sin t, cos t)|
    cx = stream.uniform(hw * 0.3, hw * 0.7, n)
    cy = stream.uniform(hw * 0.3, hw * 0.7, n)
    sigma = stream.uniform(0.6, 1.6, n)
    ys, xs = numpy.mgrid[0:hw, 0:hw].astype(numpy.float32)
    d = ((xs[None] - cx[:, None, None]) * (-numpy.sin(theta))[:, None, None]
         + (ys[None] - cy[:, None, None]) * numpy.cos(theta)[:, None, None])
    img = numpy.exp(-(d * d) / (2.0 * (sigma ** 2)[:, None, None]))
    img += stream.normal(0.0, noise, (n, hw, hw))
    img = numpy.clip(img, 0.0, 1.0) * 2.0 - 1.0
    return img[..., None].astype(numpy.float32), labels


class LinesLoader(FullBatchLoader):
    """Generated line-orientation dataset (stream "lines_synth")."""

    def __init__(self, workflow, n_train=2000, n_valid=500, hw=32,
                 **kwargs):
        super().__init__(workflow, **kwargs)
        self.n_train = n_train
        self.n_valid = n_valid
        self.hw = hw

    def load_data(self):
        stream = prng.get("lines_synth", pinned=True)
        total = self.n_train + self.n_valid
        data, labels = draw_lines(stream, total, hw=self.hw)
        self.original_data.reset(data)
        self.original_labels.reset(labels)
        self.class_lengths = [0, self.n_valid, self.n_train]
        self.info("generated %d line images (%dx%d, %d classes)",
                  total, self.hw, self.hw, N_CLASSES)


class LinesWorkflow(StandardWorkflow):
    """Small conv net over generated line images."""


def default_config():
    root.lines.defaults({
        "loader": {"minibatch_size": 100, "n_train": 2000, "n_valid": 500},
        "decision": {"max_epochs": 10, "fail_iterations": 20},
        "layers": [
            {"type": "conv_str", "n_kernels": 16, "kx": 5, "ky": 5,
             "padding": "SAME", "learning_rate": 0.02, "momentum": 0.9,
             "weights_filling": "gaussian", "weights_stddev": 0.05},
            {"type": "max_pooling", "kx": 2, "ky": 2},
            {"type": "conv_str", "n_kernels": 32, "kx": 5, "ky": 5,
             "padding": "SAME", "learning_rate": 0.02, "momentum": 0.9,
             "weights_filling": "gaussian", "weights_stddev": 0.05},
            {"type": "max_pooling", "kx": 2, "ky": 2},
            {"type": "softmax", "output_sample_shape": N_CLASSES,
             "learning_rate": 0.02, "momentum": 0.9},
        ],
    })
    return root.lines


build, train, run = make_sample("lines", LinesWorkflow, LinesLoader,
                                default_config)
