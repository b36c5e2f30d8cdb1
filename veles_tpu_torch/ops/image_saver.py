"""ImageSaver — dump mispredicted samples as image files.

Port of ``veles_tpu/ops/image_saver.py`` (ref: veles/znicz/
image_saver.py::ImageSaver [M]): on validation/test minibatches, write
wrongly classified inputs as ``<true>_as_<predicted>_<index>.png`` for
error analysis.  Host-side and off the hot path; PIL is imported inside
``run``, so a machine without it can still import the port.
"""

from __future__ import annotations

import os

import numpy

from veles_tpu_torch.loader.base import TRAIN
from veles_tpu_torch.units import Unit


class ImageSaver(Unit):
    """Links: input (minibatch_data), output (last forward's probs), labels
    (minibatch_labels), indices (minibatch_indices), minibatch_class,
    minibatch_size."""

    def __init__(self, workflow, directory="image_saver", limit=100,
                 denormalizer=None, **kwargs):
        super().__init__(workflow, **kwargs)
        self.directory = directory
        self.limit = int(limit)
        #: optional normalizer whose ``denormalize`` recovers pixel scale
        self.denormalizer = denormalizer
        self.saved = 0

    def initialize(self, device=None, **kwargs):
        os.makedirs(self.directory, exist_ok=True)
        super().initialize(device=device, **kwargs)

    def _to_image(self, sample):
        arr = numpy.asarray(sample, numpy.float32)
        if self.denormalizer is not None:
            arr = self.denormalizer.denormalize(arr[None])[0]
        else:
            lo, hi = arr.min(), arr.max()
            arr = (arr - lo) / (hi - lo if hi > lo else 1.0) * 255.0
        arr = arr.astype(numpy.uint8)
        if arr.ndim == 1:  # flat vector: square it if possible
            side = int(round(arr.size ** 0.5))
            if side * side == arr.size:
                arr = arr.reshape(side, side)
            else:
                arr = arr[None, :]
        if arr.ndim == 3 and arr.shape[-1] == 1:
            arr = arr[:, :, 0]
        return arr

    def run(self):
        if self.minibatch_class == TRAIN or self.saved >= self.limit:
            return
        probs = self.output.to_numpy()
        labels = self.labels.to_numpy()
        indices = self.indices.to_numpy()
        data = self.input.to_numpy()
        pred = probs.reshape(len(probs), -1).argmax(axis=1)
        live = int(self.minibatch_size)
        from PIL import Image
        for i in range(live):
            if self.saved >= self.limit:
                break
            if pred[i] == labels[i]:
                continue
            arr = self._to_image(data[i])
            name = "%d_as_%d_%d.png" % (labels[i], pred[i], indices[i])
            Image.fromarray(arr).save(os.path.join(self.directory, name))
            self.saved += 1
