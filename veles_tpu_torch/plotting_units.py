"""Generic plotting units.

Port of ``veles_tpu/plotting_units.py`` (ref: veles/plotting_units.py::
AccumulatingPlotter/MatrixPlotter/... [M]): epoch metric curves, matrix
images and histograms as graph units.  Each builds a picklable spec of
numpy arrays (see ``veles_tpu_torch.plotter``).
"""

from __future__ import annotations

import numpy

from veles_tpu_torch.plotter import Plotter, host_array


class AccumulatingPlotter(Plotter):
    """Accumulates one scalar a redraw and plots the running curve.

    Link ``input`` (an attribute holder) and set ``input_field``; with
    the decision as input and the field "epoch_metrics", it plots the
    named metric per set (the classic error curve).
    """

    def __init__(self, workflow, input_field="epoch_metrics",
                 metric="err_pct", **kwargs):
        super().__init__(workflow, **kwargs)
        self.input_field = input_field
        self.metric = metric

    def plot_spec(self):
        source = getattr(self.input, self.input_field, None)
        if not source:
            return None
        series = {}
        for epoch in source:   # list of {set: {metric: value}}
            for set_name, metrics in epoch.items():
                if self.metric in metrics:
                    series.setdefault(set_name, []).append(
                        metrics[self.metric])
        if not series:
            return None
        return {"kind": "curve", "series": series, "ylabel": self.metric,
                "title": "%s over epochs" % self.metric}


class MatrixPlotter(Plotter):
    """Plots a matrix attribute (the confusion matrix by default).

    Link ``input`` to the decision (or an evaluator) and set
    ``input_field``.
    """

    def __init__(self, workflow, input_field="confusion_matrix", **kwargs):
        super().__init__(workflow, **kwargs)
        self.input_field = input_field

    def plot_spec(self):
        matrix = getattr(self.input, self.input_field, None)
        if matrix is None:
            return None
        return {"kind": "matrix", "matrix": host_array(matrix),
                "title": self.input_field}


class Histogram(Plotter):
    """Histogram of a vector attribute (per-sample losses, weights)."""

    def __init__(self, workflow, input_field="values", bins=30, **kwargs):
        super().__init__(workflow, **kwargs)
        self.input_field = input_field
        self.bins = bins

    def plot_spec(self):
        values = getattr(self.input, self.input_field, None)
        if values is None:
            return None
        return {"kind": "hist", "values": host_array(values).ravel(),
                "bins": self.bins, "title": self.input_field}
