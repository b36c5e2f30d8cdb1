"""NN-specific plotting units.

Port of ``veles_tpu/nn_plotting_units.py`` (ref: veles/znicz/
nn_plotting_units.py::Weights2D/KohonenHits/MSEHistogram [H]).
"""

from __future__ import annotations

import numpy

from veles_tpu_torch.plotter import Plotter, host_array


class Weights2D(Plotter):
    """First-layer weights as a grid of images.

    Link ``input`` to a forward unit; its (n_in, n_out) weights are
    transposed and reshaped to ``sample_shape`` (inferred square when not
    given), up to ``limit`` images.  The weights are the ones committed
    so far: a fused workflow's unit Vectors lag its runner's state, so
    the workflow's units are synced first (``sync_units``, what a
    snapshot does).
    """

    def __init__(self, workflow, sample_shape=None, limit=64, **kwargs):
        super().__init__(workflow, **kwargs)
        self.sample_shape = sample_shape
        self.limit = int(limit)

    def plot_spec(self):
        sync = getattr(self.workflow, "sync_units", None)
        if sync is not None:
            sync()
        weights = self.input.weights.to_numpy()
        if weights.ndim == 4:       # conv HWIO -> one image a kernel
            imgs = numpy.moveaxis(weights, -1, 0)
            if imgs.shape[-1] not in (1, 3):
                imgs = imgs[..., :1]
        else:                       # dense (n_in, n_out) -> an output a row
            w = weights.T[:self.limit]
            shape = self.sample_shape
            if shape is None:
                side = int(round(w.shape[1] ** 0.5))
                if side * side != w.shape[1]:
                    return None
                shape = (side, side)
            imgs = w.reshape(len(w), *shape)
        return {"kind": "image_grid", "images": imgs[:self.limit],
                "title": "%s weights" % self.input.name}


class KohonenHits(Plotter):
    """SOM win-count map.  Link ``input`` to a KohonenForward."""

    def plot_spec(self):
        hits = host_array(self.input.hits)
        trainer = getattr(self, "trainer", None)
        shape = trainer.shape if trainer is not None else (
            int(round(len(hits) ** 0.5)),) * 2
        return {"kind": "matrix", "matrix": hits.reshape(shape),
                "cmap": "hot", "title": "SOM hits"}


class MSEHistogram(Plotter):
    """Distribution of per-sample reconstruction errors.

    Link ``input`` to an EvaluatorMSE (the per-sample norms of its
    ``err_output``).
    """

    def __init__(self, workflow, bins=30, **kwargs):
        super().__init__(workflow, **kwargs)
        self.bins = bins

    def plot_spec(self):
        err = self.input.err_output.to_numpy()
        if err is None:
            return None
        per_sample = numpy.sqrt(
            (err.reshape(len(err), -1) ** 2).sum(axis=1))
        return {"kind": "hist", "values": per_sample, "bins": self.bins,
                "title": "per-sample RMSE"}
