"""Residual (skip) connections for the fused chain.

Port of ``veles_tpu/ops/residual.py``.  A weightless ``residual`` layer
adds an earlier activation: ``output = input + acts[this - skip]``,
where ``acts[i]`` is the INPUT of layer ``i`` in the fused chain's
activation list, so a classic two-layer block is

    {"type": "conv", ...}, {"type": "conv", ...},
    {"type": "residual", "skip": 2}        # adds the first conv's input

and ``residual_proj`` adds a bias-free 1x1 strided conv of it instead
(the ResNet downsampling block's projection shortcut).  Both carry
``HAS_SKIP_EDGE``: the fused chain (``compiled.py``) calls their
``chain_forward``/``chain_backward`` with the whole activation list; the
backward passes the error on to the main path unchanged and returns the
skip source's error, which the chain stashes and adds when its walk
reaches the source.

Fused mode only: the unit graph's one-err_input-per-unit linking cannot
route the skip error, so ``fused=False`` builds reject these layer types
(StandardWorkflowBase), and ``run`` raises as a backstop.
"""

from __future__ import annotations

import numpy

from veles_tpu_torch.accel import AcceleratedUnit
from veles_tpu_torch.workflow import DeferredInitError
from veles_tpu_torch.ops.conv import Conv
from veles_tpu_torch.ops.nn_units import (TransformUnit, TransformGD,
                                          register_layer_type,
                                          register_gd_for)
from veles_tpu_torch.ops import functional as F


def _source(kind, position, skip):
    src = position - skip
    if src < 0:
        raise ValueError(
            "%s at layer %d skips %d back — before the chain input"
            % (kind, position, skip))
    return src


@register_layer_type("residual")
class Residual(TransformUnit):
    """output = input + acts[position - skip] (fused chain only)."""

    HAS_SKIP_EDGE = True
    IS_RESIDUAL = True

    def __init__(self, workflow, skip=2, **kwargs):
        super().__init__(workflow, **kwargs)
        if int(skip) < 1:
            raise ValueError("residual skip must be >= 1, got %r" % (skip,))
        self.skip = int(skip)

    def apply_fused(self, x, entry, rng=None, train=False):
        raise RuntimeError(
            "Residual.apply_fused: the skip add needs the fused chain's "
            "activation list (compiled.py handles HAS_SKIP_EDGE layers); "
            "route this workflow through the fused runner")

    def check_source(self, position, acts):
        """The skip source's activation, after checking that it exists
        and that its shape equals the main path's."""
        src = _source("residual", position, self.skip)
        if acts[src].shape != acts[position].shape:
            raise ValueError(
                "residual at layer %d: input shape %s != skip source "
                "shape %s (acts[%d]) — residual needs equal shapes"
                % (position, tuple(acts[position].shape),
                   tuple(acts[src].shape), src))
        return acts[src]

    # -- fused-chain hooks (compiled.py HAS_SKIP_EDGE protocol) ----------
    def chain_forward(self, position, acts, entry, rng=None, train=False):
        """output = input + skip source."""
        return acts[position] + self.check_source(position, acts)

    def chain_backward(self, position, acts, entry, err, rng=None):
        """(error to the main path, source index, error to stash there,
        grads): both consumers see the identity cotangent."""
        return err, position - self.skip, err, None

    def run(self):
        raise RuntimeError(
            "the 'residual' layer needs the fused engine (its skip adds "
            "a second data edge the per-unit graph cannot route) — build "
            "the workflow with fused=True")


@register_gd_for(Residual)
class GDResidual(TransformGD):
    """Pairing placeholder: the fused backward routes residual layers
    through ``chain_backward``; unit mode is rejected at build time."""


@register_layer_type("residual_proj")
class ResidualProjection(Conv):
    """output = input + conv1x1(acts[position - skip]), bias-free, its
    stride ``sliding`` — the ResNet downsampling block's skip path.
    Config::

        {"type": "conv_str", "n_kernels": 64, "kx": 3, "ky": 3,
         "sliding": 2, "padding": "SAME", ...},
        {"type": "conv_str", "n_kernels": 64, "kx": 3, "ky": 3,
         "padding": "SAME", ...},
        {"type": "residual_proj", "skip": 2, "n_kernels": 64,
         "sliding": 2, "learning_rate": ...}

    The projection's weights ride the per-layer update like any conv's
    (its gd is GradientDescentConv, through the Conv mro); the fused
    backward takes its weight gradient and the skip source's error from
    one convolution backward.  ``skip_input`` is wired by the builder to
    the source unit's output (the loader's data for source 0), so the
    weights' shape comes from the true source.  Fused engine only.
    """

    HAS_SKIP_EDGE = True
    IS_RESIDUAL_PROJ = True

    def __init__(self, workflow, skip=2, n_kernels=32, sliding=(1, 1),
                 **kwargs):
        if kwargs.setdefault("include_bias", False):
            raise ValueError("residual_proj is bias-free "
                             "(include_bias=True unsupported)")
        fixed = {k: kwargs.pop(k) for k in ("kx", "ky", "padding")
                 if k in kwargs}
        if fixed:
            raise ValueError(
                "residual_proj fixes kx=ky=1 and padding=VALID (a 1x1 "
                "projection); drop %s from the layer config"
                % sorted(fixed))
        super().__init__(workflow, n_kernels=n_kernels, kx=1, ky=1,
                         sliding=sliding, padding="VALID", **kwargs)
        if int(skip) < 1:
            raise ValueError("residual_proj skip must be >= 1, got %r"
                             % (skip,))
        self.skip = int(skip)

    def initialize(self, device=None, **kwargs):
        if not hasattr(self, "input") or self.input.is_empty or \
                not hasattr(self, "skip_input") or self.skip_input.is_empty:
            raise DeferredInitError(self.name)
        batch, src_h, src_w, src_c = self.skip_input.shape
        if self.weights.is_empty:
            self.weights.reset(self._init_weights(
                (1, 1, src_c, self.n_kernels), src_c, self.n_kernels))
        proj = (batch,) + self.output_hw((src_h, src_w)) + (self.n_kernels,)
        if proj != tuple(self.input.shape):
            raise ValueError(
                "residual_proj %r: projected skip shape %s != main-path "
                "shape %s — match n_kernels/sliding to the main path's "
                "downsampling" % (self.name, proj, tuple(self.input.shape)))
        self.output_sample_shape = tuple(self.input.shape[1:])
        self.output.reset(numpy.zeros(tuple(self.input.shape), self.dtype))
        AcceleratedUnit.initialize(self, device=device, **kwargs)

    def check_source(self, position, acts):
        return acts[_source("residual_proj", position, self.skip)]

    # -- fused-chain hooks (compiled.py HAS_SKIP_EDGE protocol) ----------
    def chain_forward(self, position, acts, entry, rng=None, train=False):
        """output = input + conv1x1(skip source)."""
        return acts[position] + self.preact(
            self.check_source(position, acts), entry["w"], None)

    def chain_backward(self, position, acts, entry, err, rng=None):
        """One convolution backward gives the projection's weight
        gradient and the skip source's error; the main path's error
        passes unchanged."""
        src = position - self.skip
        d_src, d_w, _ = F.conv2d_backward(
            acts[src], err, err, entry["w"], self.sliding, "VALID",
            "linear", None, False, True)
        return err, src, d_src, (d_w, None)

    def apply_fused(self, x, entry, rng=None, train=False):
        raise RuntimeError(
            "ResidualProjection.apply_fused: the skip branch needs the "
            "fused chain's activation list (compiled.py handles "
            "HAS_SKIP_EDGE layers)")

    def run(self):
        raise RuntimeError(
            "the 'residual_proj' layer needs the fused engine — build "
            "the workflow with fused=True")
