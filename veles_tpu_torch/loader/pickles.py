"""PicklesLoader — datasets stored as pickle files.

Port of ``veles_tpu/loader/pickles.py``.  Ref: veles/loader/pickles.py::
PicklesLoader [M] (SURVEY §2.2): one pickle per set (test/validation/
train), each holding the samples (and labels) for that set.  Accepted
per-file payloads: ``(data, labels)`` tuples,
``{"data":…, "labels":…}`` dicts, or a bare array (label-less).
"""

from __future__ import annotations

import pickle

import numpy

from veles_tpu_torch.loader.fullbatch import FullBatchLoader


def _unpack(payload):
    if isinstance(payload, dict):
        return numpy.asarray(payload["data"]), (
            numpy.asarray(payload["labels"])
            if payload.get("labels") is not None else None)
    if isinstance(payload, tuple) and len(payload) == 2:
        data, labels = payload
        return numpy.asarray(data), (
            numpy.asarray(labels) if labels is not None else None)
    return numpy.asarray(payload), None


class PicklesLoader(FullBatchLoader):
    """test/validation/train pickles → one full-batch dataset."""

    def __init__(self, workflow, test_path=None, validation_path=None,
                 train_path=None, **kwargs):
        super().__init__(workflow, **kwargs)
        self.paths = [test_path, validation_path, train_path]

    def load_data(self):
        datas, labels, lengths = [], [], []
        labelless = []
        for path in self.paths:
            if not path:
                lengths.append(0)
                continue
            with open(path, "rb") as f:
                data, lbls = _unpack(pickle.load(f))
            lengths.append(len(data))
            datas.append(data.astype(numpy.float32))
            if lbls is None:
                labelless.append(path)
            else:
                if len(lbls) != len(data):
                    raise ValueError("%s: %d labels for %d samples in %s" %
                                     (self.name, len(lbls), len(data), path))
                labels.append(lbls.astype(numpy.int32))
        if not datas:
            raise ValueError("%s: no pickle paths given" % self.name)
        # labels are all-or-none across sets: a partial concat would silently
        # misalign the [test|valid|train] global index space
        if labels and labelless:
            raise ValueError(
                "%s: mixed labeled/label-less pickles (%s have no labels)" %
                (self.name, ", ".join(labelless)))
        self.original_data.reset(numpy.concatenate(datas))
        self.has_labels = bool(labels)
        if self.has_labels:
            self.original_labels.reset(numpy.concatenate(labels))
        self.class_lengths = lengths
        self.info("loaded %s samples from pickles", lengths)
