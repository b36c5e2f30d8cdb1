"""MNIST fully-connected sample — BASELINE.json config[0].

Port of ``veles_tpu/samples/mnist.py``: the same loader, data (the
synthetic set is bit-equal for the same sizes), topology and defaults,
trained through the port's StandardWorkflow (ref: veles/znicz/samples/
MNIST/mnist.py [H]): 784→100(tanh)→10(softmax), the canonical end-to-end
slice.

Data: real MNIST IDX files are used when found (``data_dir`` config,
``root.common.dirs.datasets``, or $VELES_DATASETS); otherwise a deterministic
synthetic MNIST-shaped dataset is generated from the named PRNG stream
"mnist_synth" (class prototypes + gaussian noise) so the sample and its
convergence tests run hermetically — the repository ships no datasets.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy

from veles_tpu_torch import prng
from veles_tpu_torch.config import root, get
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.standard_workflow import StandardWorkflow


def _read_idx(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, = struct.unpack(">I", f.read(4))
        ndim = magic & 0xFF
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return numpy.frombuffer(f.read(), numpy.uint8).reshape(shape)


def _find_idx(data_dir, stem):
    for suffix in ("", ".gz"):
        path = os.path.join(data_dir, stem + suffix)
        if os.path.exists(path):
            return path
    return None


class MnistLoader(FullBatchLoader):
    """MNIST (or synthetic stand-in) in [-1, 1].

    ``sample_shape`` picks the layout: (784,) flat for the FC sample
    (default), (28, 28, 1) NHWC for the conv sample.
    """

    def __init__(self, workflow, n_train=60000, n_valid=10000,
                 data_dir=None, sample_shape=(784,), **kwargs):
        super().__init__(workflow, **kwargs)
        self.n_train = n_train
        self.n_valid = n_valid
        self.data_dir = data_dir
        self.sample_shape = tuple(sample_shape)

    def _dataset_dir(self):
        if self.data_dir:
            return self.data_dir
        configured = get(root.common.dirs.datasets)
        if configured:
            return os.path.join(configured, "mnist")
        env = os.environ.get("VELES_DATASETS")
        return os.path.join(env, "mnist") if env else None

    def load_data(self):
        data_dir = self._dataset_dir()
        if data_dir and _find_idx(data_dir, "train-images-idx3-ubyte"):
            self._load_real(data_dir)
        else:
            self._load_synthetic()

    def _load_real(self, data_dir):
        train_x = _read_idx(_find_idx(data_dir, "train-images-idx3-ubyte"))
        train_y = _read_idx(_find_idx(data_dir, "train-labels-idx1-ubyte"))
        test_x = _read_idx(_find_idx(data_dir, "t10k-images-idx3-ubyte"))
        test_y = _read_idx(_find_idx(data_dir, "t10k-labels-idx1-ubyte"))
        n_train = min(self.n_train, len(train_x))
        n_valid = min(self.n_valid, len(test_x))
        # layout [test | validation | train]: MNIST's 10k set is validation
        data = numpy.concatenate([test_x[:n_valid], train_x[:n_train]])
        labels = numpy.concatenate([test_y[:n_valid], train_y[:n_train]])
        self.original_data.reset(
            (data.astype(numpy.float32) / 127.5 - 1.0)
            .reshape((len(data),) + self.sample_shape))
        self.original_labels.reset(labels.astype(numpy.int32))
        self.class_lengths = [0, n_valid, n_train]
        self.info("loaded real MNIST from %s (%d train / %d valid)",
                  data_dir, n_train, n_valid)

    def _load_synthetic(self):
        stream = prng.get("mnist_synth", pinned=True)
        n_train, n_valid = self.n_train, self.n_valid
        total = n_train + n_valid
        protos = stream.uniform(-1.0, 1.0, (10, 784)).astype(numpy.float32)
        labels = numpy.arange(total, dtype=numpy.int32) % 10
        stream.shuffle(labels)
        noise = stream.normal(0.0, 0.8, (total, 784)).astype(numpy.float32)
        data = protos[labels] + noise
        # layout [test | validation | train]
        self.original_data.reset(
            data.reshape((total,) + self.sample_shape))
        self.original_labels.reset(labels)
        self.class_lengths = [0, n_valid, n_train]
        self.info("generated synthetic MNIST-shaped data "
                  "(%d train / %d valid)", n_train, n_valid)


class MnistWorkflow(StandardWorkflow):
    """784 → 100 tanh → 10 softmax (ref sample topology)."""


def default_config():
    """Install the sample's defaults into ``root.mnist`` (config-file role,
    ref: veles/znicz/samples/MNIST/mnist_config.py [H])."""
    root.mnist.defaults({
        "loader": {"minibatch_size": 100, "n_train": 60000, "n_valid": 10000},
        "decision": {"max_epochs": 10, "fail_iterations": 50},
        "layers": [
            {"type": "all2all_tanh", "output_sample_shape": 100,
             "learning_rate": 0.03, "momentum": 0.9},
            {"type": "softmax", "output_sample_shape": 10,
             "learning_rate": 0.03, "momentum": 0.9},
        ],
    })
    return root.mnist


from veles_tpu_torch.samples import make_sample  # noqa: E402

build, train, run = make_sample("mnist", MnistWorkflow, MnistLoader,
                                default_config)
