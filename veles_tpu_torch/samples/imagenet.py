"""ImageNet AlexNet-class sample — BASELINE.json configs[2].

Port of ``veles_tpu/samples/imagenet.py`` (ref: veles/znicz/samples/
imagenet/ [M]): the AlexNet-era pipeline — 256×256 images, random
227-crop + mirror, five conv blocks with LRN and max-pooling, two
dropout-FC layers, softmax-1000 — trained through the port's
StandardWorkflow.  Augmentation is a stochastic layer inside the step
(``ops/augmentation.py``).  The data comes from a record file
(``loader/records.py``, memmap gathered by the native library, the mean
image subtracted at fill time, uploaded through pinned staging buffers
on the card) when ``loader.records_path`` names one — and then
``default_config`` picks the full ``alexnet_layers()`` — or else from
the sample's synthetic stand-in (bit-equal to the reference's for the
same sizes) at the tiny shape.
"""

from __future__ import annotations

import os

import numpy

from veles_tpu_torch import native, prng
from veles_tpu_torch.config import root, get
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.loader.records import RecordsLoader
from veles_tpu_torch.standard_workflow import StandardWorkflow


def alexnet_layers(n_classes=1000, crop=(227, 227), lr=0.01, momentum=0.9,
                   weight_decay=0.0005):
    """The canonical AlexNet topology as a layers config list."""
    conv = lambda n, k, s, pad, lrn: (  # noqa: E731
        [{"type": "conv_str", "n_kernels": n, "kx": k, "ky": k,
          "sliding": (s, s), "padding": pad, "learning_rate": lr,
          "momentum": momentum, "weight_decay": weight_decay}] +
        ([{"type": "norm"}] if lrn else []))
    fc = lambda n: [  # noqa: E731
        {"type": "dropout", "dropout_ratio": 0.5},
        {"type": "all2all_str", "output_sample_shape": n,
         "learning_rate": lr, "momentum": momentum,
         "weight_decay": weight_decay}]
    return (
        [{"type": "random_crop_flip", "crop": list(crop)}] +
        conv(96, 11, 4, "VALID", True) +
        [{"type": "max_pooling", "kx": 3, "ky": 3, "sliding": (2, 2)}] +
        conv(256, 5, 1, "SAME", True) +
        [{"type": "max_pooling", "kx": 3, "ky": 3, "sliding": (2, 2)}] +
        conv(384, 3, 1, "SAME", False) +
        conv(384, 3, 1, "SAME", False) +
        conv(256, 3, 1, "SAME", False) +
        [{"type": "max_pooling", "kx": 3, "ky": 3, "sliding": (2, 2)}] +
        fc(4096) + fc(4096) +
        [{"type": "softmax", "output_sample_shape": n_classes,
          "learning_rate": lr, "momentum": momentum,
          "weight_decay": weight_decay}])


def tiny_layers(n_classes=10, crop=(28, 28), lr=0.01, momentum=0.9):
    """Scaled-down AlexNet shape (same block structure) for tests/CI."""
    return (
        [{"type": "random_crop_flip", "crop": list(crop)}] +
        [{"type": "conv_str", "n_kernels": 16, "kx": 5, "ky": 5,
          "sliding": (2, 2), "padding": "VALID", "learning_rate": lr,
          "momentum": momentum},
         {"type": "norm"},
         {"type": "max_pooling", "kx": 3, "ky": 3, "sliding": (2, 2)},
         {"type": "conv_str", "n_kernels": 32, "kx": 3, "ky": 3,
          "padding": "SAME", "learning_rate": lr, "momentum": momentum},
         {"type": "max_pooling", "kx": 2, "ky": 2},
         {"type": "dropout", "dropout_ratio": 0.5},
         {"type": "all2all_str", "output_sample_shape": 64,
          "learning_rate": lr, "momentum": momentum},
         {"type": "softmax", "output_sample_shape": n_classes,
          "learning_rate": lr, "momentum": momentum}])


class ImagenetRecordsLoader(RecordsLoader):
    """Record-file ImageNet with mean-image subtraction at fill time.

    The mean is subtracted in place right after the gather, on the host
    (in the pinned staging buffer on the card), so the prefetch worker
    and ``gather_window`` see the same pixels as the reference's
    per-minibatch path."""

    def __init__(self, workflow, mean_path=None, **kwargs):
        super().__init__(workflow, **kwargs)
        self.mean_path = mean_path
        self._mean = None

    def load_data(self):
        super().load_data()
        if self.mean_path and os.path.exists(self.mean_path):
            self._mean = numpy.load(self.mean_path).astype(numpy.float32)

    def _gather(self, indices, batch=None, labels=None):
        batch, labels = super()._gather(indices, batch, labels)
        if self._mean is not None:
            batch = native.subtract_mean(batch, self._mean)
        return batch, labels


class ImagenetSyntheticLoader(FullBatchLoader):
    """Synthetic ImageNet-shaped stand-in (stream "imagenet_synth") so the
    sample and its tests run hermetically; shape/classes configurable."""

    def __init__(self, workflow, n_train=512, n_valid=128, image_hw=(32, 32),
                 n_classes=10, **kwargs):
        super().__init__(workflow, **kwargs)
        self.n_train = n_train
        self.n_valid = n_valid
        self.image_hw = tuple(image_hw)
        self.n_classes = n_classes

    def load_data(self):
        stream = prng.get("imagenet_synth", pinned=True)
        h, w = self.image_hw
        total = self.n_train + self.n_valid
        protos = stream.uniform(-1.0, 1.0,
                                (self.n_classes, h, w, 3)).astype(
                                    numpy.float32)
        labels = numpy.arange(total, dtype=numpy.int32) % self.n_classes
        stream.shuffle(labels)
        noise = stream.normal(0.0, 0.5, (total, h, w, 3)).astype(
            numpy.float32)
        self.original_data.reset(protos[labels] + noise)
        self.original_labels.reset(labels)
        self.class_lengths = [0, self.n_valid, self.n_train]


def make_loader(workflow, records_path=None, **kwargs):
    """Real records when available, synthetic otherwise (cifar convention)."""
    if records_path and os.path.exists(records_path):
        for synth_only in ("image_hw", "n_classes", "n_train", "n_valid"):
            kwargs.pop(synth_only, None)
        return ImagenetRecordsLoader(workflow, path=records_path, **kwargs)
    kwargs.pop("mean_path", None)
    return ImagenetSyntheticLoader(workflow, **kwargs)


class ImagenetWorkflow(StandardWorkflow):
    """AlexNet-class supervised workflow."""


def default_config():
    # pick the topology by data source: real record file → the full
    # 227×227 1000-class AlexNet; synthetic stand-in → the tiny shape
    # matching its 32×32 images (explicit root.imagenet.layers always wins)
    records = get(root.imagenet.loader.records_path)
    use_full = bool(records) and os.path.exists(records)
    root.imagenet.defaults({
        "loader": {"minibatch_size": 128, "records_path": None,
                   "n_train": 512, "n_valid": 128, "image_hw": (32, 32),
                   "n_classes": 10},
        "decision": {"max_epochs": 10, "fail_iterations": 10},
        "layers": alexnet_layers() if use_full else tiny_layers(),
    })
    return root.imagenet


from veles_tpu_torch.samples import make_sample  # noqa: E402

build, train, run = make_sample("imagenet", ImagenetWorkflow, make_loader,
                                default_config)
