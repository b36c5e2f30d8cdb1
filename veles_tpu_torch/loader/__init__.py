"""Data layer — minibatch engines (ref: veles/loader/ [H], SURVEY §2.2)."""

from veles_tpu_torch.loader.base import (  # noqa: F401
    Loader, TEST, VALID, TRAIN, CLASS_NAME)
from veles_tpu_torch.loader.fullbatch import FullBatchLoader  # noqa: F401
