"""Hand-written CUDA kernels and their plain PyTorch versions.

``KERNELS`` lists every kernel wrapper of the port; each has a ``launches``
counter (see ``chip_smoke.py``)."""

from .fused_sgd import fused_sgd_apply, fused_sgd_plain  # noqa: F401

KERNELS = {"fused_sgd_apply": fused_sgd_apply}
