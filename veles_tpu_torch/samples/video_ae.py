"""VideoAE sample — autoencoder over synthetic video frames.

Port of ``veles_tpu/samples/video_ae.py`` (ref: veles/znicz/samples
VideoAE demo [H]): the deconv autoencoder stack — conv(tanh) → avg pool
∥ depooling → deconv, MSE on the input frame — over generated
"footage": sequences of frames in which a bright blob moves along a
per-sequence linear trajectory over a fixed textured background, so
adjacent frames share structure.  The frames are bit-equal to the
reference's (one pinned host stream, one numpy broadcast); the whole set
lives on the device (FullBatchLoader) and each train step is one fused
step with one fused-SGD launch on the card.  Runs on the CUDA card
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy

from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.samples import make_sample
from veles_tpu_torch.standard_workflow import StandardWorkflow


def synth_video(stream, n_sequences, frames_per_seq, hw=24):
    """(n_sequences*frames_per_seq, hw, hw, 1) float32 frames in [-1, 1].

    Each sequence: a gaussian blob travels start→end across a fixed
    per-sequence background texture; frame order is preserved so the
    dataset has real temporal structure.
    """
    n = n_sequences * frames_per_seq
    t = numpy.tile(numpy.linspace(0.0, 1.0, frames_per_seq),
                   n_sequences)                       # (n,) progress
    start = stream.uniform(hw * 0.15, hw * 0.85, (n_sequences, 2))
    end = stream.uniform(hw * 0.15, hw * 0.85, (n_sequences, 2))
    t_seq = t.reshape(n_sequences, frames_per_seq, 1)
    pos = (start[:, None] * (1 - t_seq)
           + end[:, None] * t_seq).reshape(n, 2)
    background = stream.normal(0.0, 0.08,
                               (n_sequences, hw, hw)).astype(numpy.float32)
    background = numpy.repeat(background, frames_per_seq, axis=0)
    ys, xs = numpy.mgrid[0:hw, 0:hw].astype(numpy.float32)
    d2 = ((xs[None] - pos[:, 0, None, None]) ** 2
          + (ys[None] - pos[:, 1, None, None]) ** 2)
    frames = numpy.exp(-d2 / (2.0 * 2.0 ** 2)) + background
    frames = numpy.clip(frames, 0.0, 1.0) * 2.0 - 1.0
    return frames[..., None].astype(numpy.float32)


class VideoAELoader(FullBatchLoader):
    """Synthetic video frames (stream "video_synth"); targets = inputs."""

    def __init__(self, workflow, n_train=1600, n_valid=400,
                 frames_per_seq=8, hw=24, **kwargs):
        super().__init__(workflow, **kwargs)
        if n_train % frames_per_seq or n_valid % frames_per_seq:
            raise ValueError("set sizes must be whole sequences")
        self.n_train = n_train
        self.n_valid = n_valid
        self.frames_per_seq = frames_per_seq
        self.hw = hw

    def load_data(self):
        stream = prng.get("video_synth", pinned=True)
        total_seqs = (self.n_train + self.n_valid) // self.frames_per_seq
        frames = synth_video(stream, total_seqs, self.frames_per_seq,
                             hw=self.hw)
        self.original_data.reset(frames)
        # labels unused by the MSE evaluator; sequence ids keep the
        # bookkeeping meaningful
        seq_ids = numpy.repeat(numpy.arange(total_seqs, dtype=numpy.int32),
                               self.frames_per_seq)
        self.original_labels.reset(seq_ids)
        self.class_lengths = [0, self.n_valid, self.n_train]
        self.info("generated %d frames (%d sequences of %d, %dx%d)",
                  len(frames), total_seqs, self.frames_per_seq,
                  self.hw, self.hw)


class VideoAEWorkflow(StandardWorkflow):
    """conv(tanh) → avg_pool ∥ depool → deconv, MSE on the input frame."""


def default_config():
    root.video_ae.defaults({
        "loader": {"minibatch_size": 100, "n_train": 1600, "n_valid": 400},
        "decision": {"max_epochs": 10, "fail_iterations": 20},
        "layers": [
            {"type": "conv_tanh", "n_kernels": 12, "kx": 5, "ky": 5,
             "padding": "SAME", "learning_rate": 1e-5, "momentum": 0.9},
            {"type": "avg_pooling", "kx": 2, "ky": 2},
            {"type": "depooling", "kx": 2, "ky": 2},
            {"type": "deconv", "n_kernels": 1, "kx": 5, "ky": 5,
             "padding": "SAME", "learning_rate": 1e-5, "momentum": 0.9},
        ],
    })
    return root.video_ae


build, train, run = make_sample("video_ae", VideoAEWorkflow, VideoAELoader,
                                default_config, loss_function="mse")
