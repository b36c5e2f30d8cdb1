"""Fully-connected forward units.

Port of ``veles_tpu/ops/all2all.py`` (ref: veles/znicz/all2all.py::
All2All/All2AllTanh/All2AllRELU/All2AllSigmoid/All2AllSoftmax [H]).
One GEMM (cuBLAS, fp32) plus the activation; activation semantics (LeCun tanh, smooth relu) documented in
``veles_tpu_torch.ops.functional``.
"""

from __future__ import annotations

from veles_tpu_torch.ops.nn_units import ForwardBase, register_layer_type


@register_layer_type("all2all")
class All2All(ForwardBase):
    """Linear dense layer: y = x @ W + b."""

    ACTIVATION = "linear"


@register_layer_type("all2all_tanh")
class All2AllTanh(ForwardBase):
    """Dense + LeCun-scaled tanh (1.7159 * tanh(2/3 z))."""

    ACTIVATION = "tanh"


@register_layer_type("all2all_relu")
class All2AllRELU(ForwardBase):
    """Dense + smooth relu log(1 + exp(z)) (the reference's 'RELU')."""

    ACTIVATION = "relu"


@register_layer_type("all2all_str")
class All2AllStrictRELU(ForwardBase):
    """Dense + max(0, z)."""

    ACTIVATION = "strict_relu"


@register_layer_type("all2all_sigmoid")
class All2AllSigmoid(ForwardBase):
    ACTIVATION = "sigmoid"


@register_layer_type("softmax")
class All2AllSoftmax(ForwardBase):
    """Dense + softmax; pairs with EvaluatorSoftmax which emits the fused
    softmax+NLL gradient w.r.t. the logits."""

    ACTIVATION = "softmax"
