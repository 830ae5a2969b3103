"""Hand-written CUDA kernels and their plain PyTorch versions.

``KERNELS`` lists every kernel wrapper of the port; each has a ``launches``
counter (see ``chip_smoke.py``)."""

from .flash_attention import flash_dkv, flash_dq, flash_fwd  # noqa: F401
from .fused_sgd import fused_sgd_apply, fused_sgd_plain  # noqa: F401
from .gaussian_noise import (fused_gaussian_noise,  # noqa: F401
                             gaussian_noise_plain)
from .quant_bin import quant_bin_plain, quant_bin_sparsify  # noqa: F401

KERNELS = {"fused_sgd_apply": fused_sgd_apply,
           "fused_gaussian_noise": fused_gaussian_noise,
           "quant_bin_sparsify": quant_bin_sparsify,
           "flash_attention_fwd": flash_fwd,
           "flash_attention_dq": flash_dq,
           "flash_attention_dkv": flash_dkv}
