"""ResizableAll2All — a dense layer whose output width can change.

Port of ``veles_tpu/ops/resizable_all2all.py`` (ref: veles/znicz/
resizable_all2all.py::ResizableAll2All [M]): grow or shrink the output
dimension mid-experiment while keeping the learned weights of surviving
units (incremental class addition).  New columns draw from the ``init``
stream as the reference's do.
"""

from __future__ import annotations

import numpy

from veles_tpu_torch.ops.nn_units import ForwardBase, register_layer_type


@register_layer_type("resizable_all2all")
class ResizableAll2All(ForwardBase):
    """All2All with ``resize(n_output)``; call before (re-)initialize."""

    ACTIVATION = "linear"

    def resize(self, n_output):
        """Change the output width, preserving overlapping weights/bias.

        New columns get fresh init from the "init" stream; the unit (and
        any paired gd's velocities) must be re-initialized afterwards —
        in a fused workflow, rebuild the runner so it takes the new
        shapes.
        """
        n_output = int(n_output)
        old_n = self.n_output if self.output_sample_shape else 0
        self.output_sample_shape = (n_output,)
        if self.weights.is_empty or n_output == old_n:
            return self
        old_w = self.weights.to_numpy()
        n_in = old_w.shape[0]
        new_w = self._init_weights((n_in, n_output), n_in, n_output)
        keep = min(old_n, n_output)
        new_w[:, :keep] = old_w[:, :keep]
        self.weights.reset(new_w.astype(self.dtype))
        if self.include_bias:
            old_b = self.bias.to_numpy()
            new_b = numpy.zeros(n_output, self.dtype)
            new_b[:keep] = old_b[:keep]
            self.bias.reset(new_b)
        # the output buffer re-allocates on the next initialize
        self.output.reset(numpy.zeros(
            (self.output.shape[0], n_output), self.dtype))
        self._jitted.pop("fwd", None)
        return self
