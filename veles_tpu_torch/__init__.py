"""veles_tpu_torch — the PyTorch/CUDA port of ``veles_tpu``.

A second package beside the JAX one, with the same module names so each
counterpart is easy to find.  It imports ``torch`` and never ``jax`` or
``veles_tpu``; the kernels the JAX package wrote in Pallas for the TPU
are hand-written CUDA for Hopper (``csrc/``), built at first use.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (see :func:`veles_tpu_torch.device.resolve_device`).
Ported so far: the paged LM serving path (``serving.LMEngine`` over
``ops.transformer`` / ``ops.attention`` and the two paged attention
kernels), MNIST-FC training through the Unit/Workflow graph (the fused
SGD kernel) and AlexNet training through ``samples.imagenet`` (the LRN
and dropout kernels); the kernels' wrappers are ``ops.hopper_kernels``.
``python -m veles_tpu_torch <sample>`` runs a sample through the
Launcher (snapshots, lr policies, ``grad_accum``), on the graph loop or
the epoch scan's captured CUDA-graph steps (``--epoch-scan``).
"""

__version__ = "0.1.0"
