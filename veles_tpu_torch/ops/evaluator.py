"""Loss evaluators — they seed the backward chain and emit metrics.

Port of ``veles_tpu/ops/evaluator.py`` (ref: veles/znicz/evaluator.py::
EvaluatorSoftmax/EvaluatorMSE [H]).  Metrics stay ON THE DEVICE as
tensors; the Decision unit sums them there and reads them to the host
once per set at the epoch's end, so no minibatch waits on the host.
"""

from __future__ import annotations

import numpy

from veles_tpu_torch.accel import AcceleratedUnit
from veles_tpu_torch.memory import Vector
from veles_tpu_torch.workflow import DeferredInitError
from veles_tpu_torch.ops import functional as F


class EvaluatorBase(AcceleratedUnit):
    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.err_output = Vector()
        self.metrics = {}        # name -> device tensor, per minibatch

    def initialize(self, device=None, **kwargs):
        if not hasattr(self, "output") or self.output.is_empty:
            raise DeferredInitError(self.name)
        self.err_output.reset(numpy.zeros(self.output.shape, self.dtype))
        self._eval = self.jit("eval", self.loss_fn)
        super().initialize(device=device, **kwargs)


class EvaluatorSoftmax(EvaluatorBase):
    """Softmax+NLL with error count and confusion matrix.

    Linked attrs: ``output`` (last forward's probs), ``labels`` (loader's
    minibatch_labels), ``mask`` (loader's minibatch_mask).  Produces
    ``err_output`` = dL/dlogits and device metrics ``n_err``,
    ``loss_sum``, ``confusion``.
    """

    def loss_fn(self, probs, labels, mask):
        return F.softmax_loss(probs, labels, mask)

    def run(self):
        err, metrics = self._eval(self.output.devmem, self.labels.devmem,
                                  self.mask.devmem)
        self.err_output.assign_device(err)
        self.metrics = metrics


class EvaluatorMSE(EvaluatorBase):
    """Mean-squared-error evaluator (autoencoders, regression).  Linked
    attrs: ``output``, ``target``, ``mask``."""

    def loss_fn(self, output, target, mask):
        return F.mse_loss(output, target, mask)

    def run(self):
        err, metrics = self._eval(self.output.devmem, self.target.devmem,
                                  self.mask.devmem)
        self.err_output.assign_device(err)
        self.metrics = metrics
