"""Wine — the hello-world FC sample.

Port of ``veles_tpu/samples/wine.py``: the same loader, data (the
synthetic set is bit-equal for the same seed), topology and defaults,
trained through the port's StandardWorkflow on the CUDA card unless the
caller passes ``device="cpu"``.  Ref: veles/znicz/samples/Wine/wine.py
[H] (SURVEY §2.3): the UCI Wine dataset (178 samples × 13 chemical
features, 3 cultivars), a tiny all2all_tanh(8) → softmax(3) net; the
reference's smoke-test sample.

Data: the real ``wine.data`` CSV is used when found under the datasets
dir; otherwise a deterministic synthetic 3-cluster stand-in with the
same shape/scale is generated (the repository ships no datasets).
"""

from __future__ import annotations

import os

import numpy

from veles_tpu_torch import prng
from veles_tpu_torch.config import root, get
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.standard_workflow import StandardWorkflow


class WineLoader(FullBatchLoader):
    """(178, 13) features in 3 classes; linear-normalized to [-1, 1]."""

    def __init__(self, workflow, data_path=None, validation_ratio=0.15,
                 **kwargs):
        kwargs.setdefault("normalization_type", "linear")
        super().__init__(workflow, **kwargs)
        self.data_path = data_path
        self.validation_ratio = validation_ratio

    def _find_csv(self):
        if self.data_path:
            return self.data_path
        configured = get(root.common.dirs.datasets)
        for base in (configured, os.environ.get("VELES_DATASETS")):
            if base:
                path = os.path.join(base, "wine", "wine.data")
                if os.path.exists(path):
                    return path
        return None

    def load_data(self):
        path = self._find_csv()
        if path and os.path.exists(path):
            raw = numpy.loadtxt(path, delimiter=",", dtype=numpy.float32)
            labels = raw[:, 0].astype(numpy.int32) - 1   # classes are 1..3
            data = raw[:, 1:]
            self.info("loaded real wine data from %s", path)
        else:
            stream = prng.get("wine_synth", pinned=True)
            n, features = 178, 13
            labels = numpy.arange(n, dtype=numpy.int32) % 3
            stream.shuffle(labels)
            centers = stream.uniform(-2.0, 2.0, (3, features))
            scales = stream.uniform(0.5, 3.0, (1, features))
            data = ((centers[labels] +
                     stream.normal(0.0, 0.6, (n, features))) *
                    scales).astype(numpy.float32)
            self.info("generated synthetic wine-shaped data")
        # deterministic strided validation split, layout [test|valid|train]
        idx = numpy.arange(len(data))
        if self.validation_ratio > 0:
            valid = idx[::int(round(1.0 / self.validation_ratio))]
        else:
            valid = idx[:0]
        train = numpy.setdiff1d(idx, valid)
        order = numpy.concatenate([valid, train])
        self.original_data.reset(data[order])
        self.original_labels.reset(labels[order])
        self.class_lengths = [0, len(valid), len(train)]


class WineWorkflow(StandardWorkflow):
    """13 → 8 tanh → 3 softmax (ref sample topology)."""


def default_config():
    root.wine.defaults({
        "loader": {"minibatch_size": 10},
        "decision": {"max_epochs": 100, "fail_iterations": 30},
        "layers": [
            {"type": "all2all_tanh", "output_sample_shape": 8,
             "learning_rate": 0.5, "momentum": 0.0},
            {"type": "softmax", "output_sample_shape": 3,
             "learning_rate": 0.5, "momentum": 0.0},
        ],
    })
    return root.wine


from veles_tpu_torch.samples import make_sample  # noqa: E402

build, train, run = make_sample("wine", WineWorkflow, WineLoader,
                                default_config)
