"""Plotter base unit and headless spec rendering.

Port of ``veles_tpu/plotter.py`` (ref: veles/plotter.py::Plotter and
veles/graphics_server.py's transport [H]).  Plotters emit small
picklable spec dicts (a ``kind`` and numpy arrays, never a tensor: the
values are copied off the card when a spec is built); one renderer
function turns a spec into a PNG.  The same spec feeds three sinks:
direct headless file output (the default), the ZeroMQ graphics server
(a separate renderer process, the reference's topology) or tests that
read specs without matplotlib.
"""

from __future__ import annotations

import os

import numpy

from veles_tpu_torch.units import Unit


def _spec_snapshot(v):
    """Deep-copy a spec's arrays: ``plot_spec`` may return views of live
    buffers (SOM hit counts mutated in place), and a stored spec that
    aliased its source would corrupt the history and defeat ``stop()``'s
    changed-since-the-last-redraw comparison."""
    if type(v) is dict:
        return {k: _spec_snapshot(x) for k, x in v.items()}
    if isinstance(v, numpy.ndarray):
        return v.copy()
    if isinstance(v, (list, tuple)):
        return type(v)(_spec_snapshot(x) for x in v)
    return v


def _spec_equal(a, b):
    """Deep equality over spec values (dicts, lists, arrays, scalars)."""
    if type(a) is dict or type(b) is dict:
        return (type(a) is dict and type(b) is dict
                and a.keys() == b.keys()
                and all(_spec_equal(v, b[k]) for k, v in a.items()))
    if isinstance(a, (list, tuple, numpy.ndarray)) or \
            isinstance(b, (list, tuple, numpy.ndarray)):
        a, b = numpy.asarray(a), numpy.asarray(b)
        return a.shape == b.shape and a.dtype == b.dtype \
            and numpy.array_equal(a, b)
    return a == b


def host_array(value):
    """``value`` as a numpy array on the host: a ``Vector`` or a tensor
    is copied off its device (a spec never holds a tensor: it is
    pickled to another process)."""
    from veles_tpu_torch.memory import Vector
    if isinstance(value, Vector):
        return value.to_numpy()
    if hasattr(value, "detach"):
        return value.detach().cpu().numpy()
    return numpy.asarray(value)


def render_spec(spec, path):
    """Render one plot spec to ``path`` (matplotlib Agg, headless;
    matplotlib is imported here, never when the module is)."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    kind = spec["kind"]
    fig, ax = plt.subplots(figsize=spec.get("figsize", (6, 4)))
    try:
        if kind == "curve":
            for label, ys in spec["series"].items():
                ax.plot(spec.get("x", range(len(ys))), ys, label=label)
            ax.legend(loc="best")
            ax.set_xlabel(spec.get("xlabel", "epoch"))
            ax.set_ylabel(spec.get("ylabel", ""))
        elif kind == "matrix":
            im = ax.imshow(spec["matrix"], cmap=spec.get("cmap", "viridis"),
                           interpolation="nearest")
            fig.colorbar(im, ax=ax)
        elif kind == "hist":
            ax.hist(spec["values"], bins=spec.get("bins", 30))
            ax.set_xlabel(spec.get("xlabel", ""))
        elif kind == "image_grid":
            images = numpy.asarray(spec["images"])
            n = len(images)
            cols = spec.get("cols") or max(1, int(numpy.ceil(n ** 0.5)))
            rows = -(-n // cols)
            fig.clf()
            for i in range(n):
                sub = fig.add_subplot(rows, cols, i + 1)
                img = images[i]
                if img.ndim == 3 and img.shape[-1] == 1:
                    img = img[:, :, 0]
                sub.imshow(img, cmap=spec.get("cmap", "gray"))
                sub.axis("off")
        else:
            raise ValueError("unknown plot kind %r" % kind)
        if spec.get("title"):
            fig.suptitle(spec["title"])
        fig.savefig(path, bbox_inches="tight")
    finally:
        plt.close(fig)
    return path


class Plotter(Unit):
    """Base plotter: builds a spec each redraw and hands it to the sink.

    Sinks, in priority order: the workflow's ``graphics_server``
    attribute (ZeroMQ PUB, the reference's topology) when present, else
    a PNG under ``output_dir``.  ``specs`` keeps the history for tests
    and publishing.
    """

    def __init__(self, workflow, output_dir="plots", redraw_interval=1,
                 only_on_epoch_end=True, **kwargs):
        super().__init__(workflow, **kwargs)
        self.output_dir = output_dir
        self.redraw_interval = int(redraw_interval)
        #: redraw only on epoch boundaries (the reference gated its
        #: plotters off the decision's epoch-end flags the same way)
        self.only_on_epoch_end = only_on_epoch_end
        self.specs = []
        self._runs = 0

    def plot_spec(self):
        """Return the current spec dict (or None to skip)."""
        raise NotImplementedError

    def run(self):
        if self.only_on_epoch_end and not getattr(
                getattr(self.workflow, "loader", None), "epoch_ended", True):
            return
        self._runs += 1
        if self._runs % self.redraw_interval:
            return
        self.redraw()

    def redraw(self, spec=None):
        if spec is None:
            spec = self.plot_spec()
        if spec is None:
            return
        spec.setdefault("name", self.name)
        spec = _spec_snapshot(spec)
        self.specs.append(spec)
        server = getattr(self.workflow, "graphics_server", None)
        if server is not None:
            server.send(spec)
        else:
            os.makedirs(self.output_dir, exist_ok=True)
            render_spec(spec, os.path.join(
                self.output_dir, "%s_%04d.png" % (self.name,
                                                  len(self.specs))))

    def stop(self):
        # the completion wave can end the run before the last epoch-end
        # redraw fires: capture the final state, unless it equals the
        # last emitted spec (run counts are no proxy: new state can
        # accumulate without this unit firing again)
        spec = self.plot_spec()
        if spec is None:
            return
        spec.setdefault("name", self.name)
        if self.specs and _spec_equal(spec, self.specs[-1]):
            return
        self.redraw(spec)
