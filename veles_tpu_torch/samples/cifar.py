"""CIFAR-10 small-conv sample — BASELINE.json configs[1].

Port of ``veles_tpu/samples/cifar.py`` (ref: veles/znicz/samples/
CIFAR10/cifar.py [H]): conv + pooling + fully-connected topology over
32x32x3 images, trained through the port's StandardWorkflow.

Data: real CIFAR-10 python-pickle batches are used when found
(``data_dir`` config, ``root.common.dirs.datasets`` or $VELES_DATASETS,
each under ``cifar-10-batches-py``); otherwise a deterministic synthetic
stand-in (class prototypes + noise, stream "cifar_synth"), bit-equal to
the reference's for the same seed and sizes.
"""

from __future__ import annotations

import os
import pickle

import numpy

from veles_tpu_torch import prng
from veles_tpu_torch.config import root, get
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.standard_workflow import StandardWorkflow


class CifarLoader(FullBatchLoader):
    """CIFAR-10 (or synthetic stand-in), NHWC float32 in [-1, 1]."""

    def __init__(self, workflow, n_train=50000, n_valid=10000,
                 data_dir=None, **kwargs):
        super().__init__(workflow, **kwargs)
        self.n_train = n_train
        self.n_valid = n_valid
        self.data_dir = data_dir

    def _dataset_dir(self):
        if self.data_dir:
            return self.data_dir
        configured = get(root.common.dirs.datasets)
        if configured:
            return os.path.join(configured, "cifar-10-batches-py")
        env = os.environ.get("VELES_DATASETS")
        return (os.path.join(env, "cifar-10-batches-py") if env else None)

    def load_data(self):
        data_dir = self._dataset_dir()
        if data_dir and os.path.exists(os.path.join(data_dir, "data_batch_1")):
            self._load_real(data_dir)
        else:
            self._load_synthetic()

    @staticmethod
    def _read_batch(path):
        with open(path, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        data = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return data, numpy.array(d[b"labels"], numpy.int32)

    def _load_real(self, data_dir):
        xs, ys = [], []
        for i in range(1, 6):
            x, y = self._read_batch(os.path.join(data_dir,
                                                 "data_batch_%d" % i))
            xs.append(x)
            ys.append(y)
        train_x = numpy.concatenate(xs)[:self.n_train]
        train_y = numpy.concatenate(ys)[:self.n_train]
        test_x, test_y = self._read_batch(os.path.join(data_dir,
                                                       "test_batch"))
        test_x, test_y = test_x[:self.n_valid], test_y[:self.n_valid]
        # layout [test | validation | train]: the test batch validates
        data = numpy.concatenate([test_x, train_x])
        labels = numpy.concatenate([test_y, train_y])
        self.original_data.reset(
            (data.astype(numpy.float32) / 127.5) - 1.0)
        self.original_labels.reset(labels.astype(numpy.int32))
        self.class_lengths = [0, len(test_x), len(train_x)]
        self.info("loaded real CIFAR-10 from %s", data_dir)

    def _load_synthetic(self):
        stream = prng.get("cifar_synth", pinned=True)
        total = self.n_train + self.n_valid
        protos = stream.uniform(-1.0, 1.0, (10, 32, 32, 3)).astype(
            numpy.float32)
        labels = numpy.arange(total, dtype=numpy.int32) % 10
        stream.shuffle(labels)
        noise = stream.normal(0.0, 0.6, (total, 32, 32, 3)).astype(
            numpy.float32)
        self.original_data.reset(protos[labels] + noise)
        self.original_labels.reset(labels)
        self.class_lengths = [0, self.n_valid, self.n_train]
        self.info("generated synthetic CIFAR-shaped data (%d train / %d "
                  "valid)", self.n_train, self.n_valid)


class CifarWorkflow(StandardWorkflow):
    """Small conv net (the reference sample's topology class)."""


def default_config():
    root.cifar.defaults({
        "loader": {"minibatch_size": 100, "n_train": 50000,
                   "n_valid": 10000},
        "decision": {"max_epochs": 20, "fail_iterations": 100},
        # strict-relu convs with explicit gaussian init, as the
        # reference's cifar configs pin weights_filling/stddev
        "layers": [
            {"type": "conv_str", "n_kernels": 32, "kx": 5, "ky": 5,
             "padding": "SAME", "learning_rate": 0.02, "momentum": 0.9,
             "weights_filling": "gaussian", "weights_stddev": 0.05},
            {"type": "max_pooling", "kx": 2, "ky": 2},
            {"type": "conv_str", "n_kernels": 32, "kx": 5, "ky": 5,
             "padding": "SAME", "learning_rate": 0.02, "momentum": 0.9,
             "weights_filling": "gaussian", "weights_stddev": 0.05},
            {"type": "avg_pooling", "kx": 2, "ky": 2},
            {"type": "conv_str", "n_kernels": 64, "kx": 5, "ky": 5,
             "padding": "SAME", "learning_rate": 0.02, "momentum": 0.9,
             "weights_filling": "gaussian", "weights_stddev": 0.05},
            {"type": "avg_pooling", "kx": 2, "ky": 2},
            {"type": "softmax", "output_sample_shape": 10,
             "learning_rate": 0.02, "momentum": 0.9},
        ],
    })
    return root.cifar


from veles_tpu_torch.samples import make_sample  # noqa: E402

build, train, run = make_sample("cifar", CifarWorkflow, CifarLoader,
                                default_config)
