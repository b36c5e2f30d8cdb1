"""Numeric ops of the port: the pure functions (``functional``), the
units built on them (the non-SGD trainers ``kohonen`` and ``rbm``
among them), attention, transformer and the hand-written Hopper
kernels.  Importing the package imports every unit module, which
registers its layer types and forward↔gd pairs (as the reference's
``veles_tpu/ops/__init__.py`` does)."""

from veles_tpu_torch.ops import all2all, gd  # noqa: F401,E402
from veles_tpu_torch.ops import conv, gd_conv  # noqa: F401,E402
from veles_tpu_torch.ops import pooling, activation  # noqa: F401,E402
from veles_tpu_torch.ops import (normalization, dropout,  # noqa: F401,E402
                                 cutter)
from veles_tpu_torch.ops import deconv, gd_deconv, depooling  # noqa: F401,E402
from veles_tpu_torch.ops import (weights_zerofilling,  # noqa: F401,E402
                                 resizable_all2all, image_saver,
                                 mean_disp_normalizer)
from veles_tpu_torch.ops import augmentation  # noqa: F401,E402
from veles_tpu_torch.ops import residual  # noqa: F401,E402
from veles_tpu_torch.ops import kohonen, rbm  # noqa: F401,E402
