"""Gradient units for the fully-connected family.

Port of ``veles_tpu/ops/gd.py`` (ref: veles/znicz/gd.py::
GradientDescent/GDTanh/GDRELU/GDSoftmax [H]).  The per-activation math lives in
``functional.activation_derivative_from_output``; these classes are the
graph-node / pairing layer.
"""

from __future__ import annotations

from veles_tpu_torch.ops.nn_units import GradientDescentBase, register_gd_for
from veles_tpu_torch.ops import all2all


@register_gd_for(all2all.All2All)
class GradientDescent(GradientDescentBase):
    """Backward + momentum-SGD update for the linear dense layer."""


@register_gd_for(all2all.All2AllTanh)
class GDTanh(GradientDescentBase):
    """Backward for dense+tanh (derivative from output: b*(a - y^2/a))."""


@register_gd_for(all2all.All2AllRELU)
class GDRELU(GradientDescentBase):
    """Backward for the smooth relu (derivative 1 - exp(-y))."""


@register_gd_for(all2all.All2AllStrictRELU)
class GDStrictRELU(GradientDescentBase):
    """Backward for max(0, z)."""


@register_gd_for(all2all.All2AllSigmoid)
class GDSigmoid(GradientDescentBase):
    """Backward for sigmoid (derivative y*(1-y))."""


@register_gd_for(all2all.All2AllSoftmax)
class GDSoftmax(GradientDescentBase):
    """Backward for softmax: err_output already is dL/dlogits (softmax+NLL
    fusion in EvaluatorSoftmax), so the activation derivative is identity."""
