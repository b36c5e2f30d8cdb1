"""Learning-rate adjustment policies.

Port of ``veles_tpu/ops/lr_adjust.py`` (ref: veles/znicz/lr_adjust.py::
LearningRateAdjust + policy classes [M]).  A policy is a pure function
``lr(lr0, t)`` of the global train step ``t`` (a Python int).  The
reference traces it into its jitted step; here it runs on the host, once
a step, and its value reaches the update kernel as an operand: by value
in the graph loop, through the step-operand table in the epoch scan
(``veles_tpu_torch/compiled.py``), so both drivers feed the kernel the
same number.

Each policy computes in fp32 as the reference's ``jnp`` code does: ``t``
cast to float32, Python-float constants folded in double where the
reference's weak-typed arithmetic folds them and rounded to fp32 where
they meet an fp32 value, then ``power``, ``cos``, ``where`` in fp32 (numpy
fp32 scalars; libm's ``powf``/``cosf`` may differ from XLA's by one ulp).
Every policy returns a ``numpy.float32``.

Config: a GD unit (or layer config) takes ``lr_policy={"policy": <name>,
...params}``; every policy below mirrors a reference policy class.
"""

from __future__ import annotations

import math

import numpy

_F32 = numpy.float32


def make_policy(spec):
    """Build ``fn(lr0, t) -> lr`` from a policy spec dict (or pass through
    a callable, which gets ``t`` as an int and may return any number)."""
    if spec is None:
        return None
    if callable(spec):
        return spec
    spec = dict(spec)
    name = spec.pop("policy")
    maker = _POLICIES.get(name)
    if maker is None:
        raise ValueError("unknown lr policy %r (known: %s)" %
                         (name, ", ".join(sorted(_POLICIES))))
    return maker(**spec)


_POLICIES = {}


def _register(name):
    def deco(fn):
        _POLICIES[name] = fn
        return fn
    return deco


def _tf(t):
    """``t.astype(jnp.float32)``."""
    return _F32(int(t))


@_register("fixed")
def fixed():
    """Constant lr (ref: FixedAjustPolicy)."""
    def fn(lr0, t):
        return _F32(lr0)
    return fn


@_register("exp")
def exp(gamma=0.999):
    """lr0 * gamma^t (ref: ExpPolicy)."""
    def fn(lr0, t):
        return _F32(lr0) * numpy.power(_F32(gamma), _tf(t))
    return fn


@_register("step_exp")
def step_exp(gamma=0.5, step=1000):
    """lr0 * gamma^(t // step) — staircase decay (ref: StepExpPolicy)."""
    def fn(lr0, t):
        return _F32(lr0) * numpy.power(_F32(gamma),
                                       _F32(int(t) // int(step)))
    return fn


@_register("inv")
def inv(gamma=0.0001, power=0.75):
    """lr0 * (1 + gamma t)^-power — Caffe-style inv decay (ref: InvPolicy)."""
    def fn(lr0, t):
        base = _F32(1.0) + _F32(gamma) * _tf(t)
        return _F32(lr0) * numpy.power(base, _F32(-power))
    return fn


@_register("linear")
def linear(final=0.0, steps=10000):
    """Linear ramp from lr0 to ``final`` over ``steps``, then flat."""
    def fn(lr0, t):
        frac = numpy.clip(_tf(t) / _F32(float(steps)), _F32(0.0),
                          _F32(1.0))
        return _F32(lr0) + _F32(final - lr0) * frac
    return fn


@_register("warmup_cosine")
def warmup_cosine(warmup=1000, steps=10000, final_scale=0.0):
    """Linear warmup 0 -> lr0 over ``warmup`` steps, then cosine decay to
    ``final_scale * lr0`` by step ``steps`` (flat after)."""
    if not 0 <= warmup < steps:
        raise ValueError("warmup %d must be in [0, total steps %d)"
                         % (warmup, steps))

    def fn(lr0, t):
        tf = _tf(t)
        ramp = tf / _F32(max(float(warmup), 1.0))
        frac = numpy.clip((tf - _F32(warmup)) / _F32(float(steps - warmup)),
                          _F32(0.0), _F32(1.0))
        cos = _F32(final_scale) + _F32((1.0 - final_scale) * 0.5) * (
            _F32(1.0) + numpy.cos(_F32(math.pi) * frac))
        return _F32(lr0) * (ramp if tf < _F32(warmup) else cos)
    return fn


@_register("warmup_rsqrt")
def warmup_rsqrt(warmup=4000):
    """The original Transformer ("Noam") schedule: linear warmup then
    inverse-square-root decay, normalized so lr peaks at lr0 at step
    ``warmup``."""
    def fn(lr0, t):
        tf = numpy.maximum(_tf(t), _F32(1.0))
        w = _F32(float(max(warmup, 1)))
        return _F32(lr0) * numpy.minimum(tf / w, numpy.sqrt(w / tf))
    return fn


@_register("arbitrary")
def arbitrary(points=()):
    """Piecewise-constant: ``points`` is a sequence of (t_from, lr_scale);
    the scale of the last point whose t_from <= t applies (scale multiplies
    lr0) — ref: ArbitraryStepPolicy."""
    points = sorted(points)

    def fn(lr0, t):
        scale = _F32(1.0)
        for t_from, s in points:
            # an int32 step meets an int t_from as ints, a float one in
            # fp32 (jnp's weak-type promotion)
            hit = (int(t) >= t_from if isinstance(t_from, int)
                   else _tf(t) >= _F32(t_from))
            if hit:
                scale = _F32(s)
        return _F32(lr0) * scale
    return fn


class LearningRateAdjust:
    """Build-time helper with the reference unit's name: assigns a policy
    to a set of GD units.  Usage: ``LearningRateAdjust(spec).apply_to(
    workflow.gds)`` before ``initialize``."""

    def __init__(self, lr_policy=None, bias_lr_policy=None):
        self.lr_policy = lr_policy
        self.bias_lr_policy = bias_lr_policy

    def apply_to(self, gds):
        for gd in gds:
            gd.set_lr_policy(self.lr_policy, self.bias_lr_policy)
        return gds
