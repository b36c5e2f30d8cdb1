"""Feature normalization strategies for loaders.

Copy of ``veles_tpu/normalization.py`` (jax-free, numpy only).

Ref: veles/normalization.py::NoneNormalizer/LinearNormalizer/
MeanDispersionNormalizer + pointwise/exp variants [H] (SURVEY §2.1).
Contract preserved: a normalizer ``analyze()``s the training data to fit its
statistics, then ``apply()``s the same transform to every set; it is
picklable so snapshots (and served models) reproduce the exact input
transform.  Statistics are computed with numpy at load time (host-side, once
per dataset) — the per-minibatch path stays on device untouched.
"""

from __future__ import annotations

import numpy

#: registry: name -> normalizer class (ref: the reference's class registry
#: keyed by the loader's ``normalization_type`` config string)
NORMALIZERS = {}


def register(name):
    def deco(cls):
        NORMALIZERS[name] = cls
        return cls
    return deco


def from_spec(name, **kwargs):
    """Instantiate a normalizer by config name."""
    cls = NORMALIZERS.get(name)
    if cls is None:
        raise ValueError("unknown normalization_type %r (known: %s)" %
                         (name, ", ".join(sorted(NORMALIZERS))))
    return cls(**kwargs)


class NormalizerBase:
    """analyze() fits statistics; apply()/denormalize() use them."""

    #: attributes persisted through pickling (all plain numpy/python)
    state_attrs = ()

    def analyze(self, data):
        """Fit statistics from (train) data of shape (N, ...features)."""

    def apply(self, data):
        """Return the normalized copy of ``data`` (never in-place)."""
        raise NotImplementedError

    def denormalize(self, data):
        raise NotImplementedError

    @property
    def is_fitted(self):
        """True once analyze() has produced every statistic (stateless
        normalizers are always fitted)."""
        return all(getattr(self, attr) is not None
                   for attr in self.state_attrs)


@register("none")
class NoneNormalizer(NormalizerBase):
    """Identity (ref: NoneNormalizer [H])."""

    def apply(self, data):
        return numpy.asarray(data)

    def denormalize(self, data):
        return numpy.asarray(data)


@register("linear")
class LinearNormalizer(NormalizerBase):
    """Per-feature min/max mapping onto [interval_min, interval_max]
    (default [-1, 1]) — ref: LinearNormalizer [H]."""

    state_attrs = ("vmin", "vmax", "interval")

    def __init__(self, interval=(-1.0, 1.0)):
        self.interval = tuple(interval)
        self.vmin = None
        self.vmax = None

    def analyze(self, data):
        data = numpy.asarray(data, numpy.float32)
        flat = data.reshape(len(data), -1)
        self.vmin = flat.min(axis=0)
        self.vmax = flat.max(axis=0)

    def _scales(self):
        lo, hi = self.interval
        span = numpy.where(self.vmax > self.vmin, self.vmax - self.vmin, 1.0)
        return lo, (hi - lo) / span

    def apply(self, data):
        data = numpy.asarray(data, numpy.float32)
        lo, scale = self._scales()
        flat = data.reshape(len(data), -1)
        out = lo + (flat - self.vmin) * scale
        return out.reshape(data.shape).astype(numpy.float32)

    def denormalize(self, data):
        data = numpy.asarray(data, numpy.float32)
        lo, scale = self._scales()
        flat = data.reshape(len(data), -1)
        out = self.vmin + (flat - lo) / scale
        return out.reshape(data.shape).astype(numpy.float32)


@register("mean_disp")
class MeanDispersionNormalizer(NormalizerBase):
    """(x - mean) / (max - min), per feature — ref:
    MeanDispersionNormalizer [H] (mean subtraction with dispersion scaling,
    the AlexNet-era input pipeline default)."""

    state_attrs = ("mean", "disp")

    def __init__(self):
        self.mean = None
        self.disp = None

    def analyze(self, data):
        data = numpy.asarray(data, numpy.float32)
        flat = data.reshape(len(data), -1)
        self.mean = flat.mean(axis=0)
        span = flat.max(axis=0) - flat.min(axis=0)
        self.disp = numpy.where(span > 0, span, 1.0)

    def apply(self, data):
        data = numpy.asarray(data, numpy.float32)
        flat = data.reshape(len(data), -1)
        return ((flat - self.mean) / self.disp).reshape(
            data.shape).astype(numpy.float32)

    def denormalize(self, data):
        data = numpy.asarray(data, numpy.float32)
        flat = data.reshape(len(data), -1)
        return (flat * self.disp + self.mean).reshape(
            data.shape).astype(numpy.float32)


@register("pointwise")
class PointwiseNormalizer(NormalizerBase):
    """Per-feature linear map fitted so each feature lands in [-1, 1],
    stored as explicit (add, mul) arrays — ref: pointwise normalizer [M]."""

    state_attrs = ("add", "mul")

    def __init__(self):
        self.add = None
        self.mul = None

    def analyze(self, data):
        data = numpy.asarray(data, numpy.float32)
        flat = data.reshape(len(data), -1)
        vmin, vmax = flat.min(axis=0), flat.max(axis=0)
        span = numpy.where(vmax > vmin, vmax - vmin, 1.0)
        self.mul = 2.0 / span
        self.add = -1.0 - vmin * self.mul

    def apply(self, data):
        data = numpy.asarray(data, numpy.float32)
        flat = data.reshape(len(data), -1)
        return (flat * self.mul + self.add).reshape(
            data.shape).astype(numpy.float32)

    def denormalize(self, data):
        data = numpy.asarray(data, numpy.float32)
        flat = data.reshape(len(data), -1)
        return ((flat - self.add) / self.mul).reshape(
            data.shape).astype(numpy.float32)


@register("exp")
class ExponentNormalizer(NormalizerBase):
    """Stable softmax-style squash per sample: exp(x - max) / sum —
    ref: ExponentNormalizer [M].  Stateless; not invertible (denormalize
    raises)."""

    def analyze(self, data):
        pass

    def apply(self, data):
        data = numpy.asarray(data, numpy.float32)
        flat = data.reshape(len(data), -1)
        shifted = numpy.exp(flat - flat.max(axis=1, keepdims=True))
        out = shifted / shifted.sum(axis=1, keepdims=True)
        return out.reshape(data.shape).astype(numpy.float32)

    def denormalize(self, data):
        raise NotImplementedError("exp normalization is not invertible")


@register("external_mean")
class ExternalMeanNormalizer(NormalizerBase):
    """Subtract a caller-provided mean sample (ref: external mean / mean
    image subtraction used by the ImageNet pipeline [M])."""

    state_attrs = ("mean",)

    def __init__(self, mean=None):
        self.mean = None if mean is None else numpy.asarray(
            mean, numpy.float32)

    def analyze(self, data):
        if self.mean is None:  # fall back to the dataset mean image
            self.mean = numpy.asarray(data, numpy.float32).mean(axis=0)

    def apply(self, data):
        data = numpy.asarray(data, numpy.float32)
        return (data - self.mean).astype(numpy.float32)

    def denormalize(self, data):
        return (numpy.asarray(data, numpy.float32) +
                self.mean).astype(numpy.float32)
