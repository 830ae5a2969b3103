"""Device resolution for the port's entry points.

Every entry point runs on ``cuda`` unless its caller asks for the CPU
(``device="cpu"``, CLI ``-device cpu``).  A default of ``cuda`` on a host
without a usable card raises: the port never falls back to the CPU on its
own, so a number measured by it always names the device it ran on.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``.  Raises when CUDA is asked for (or
    defaulted to) and ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (CLI: -device cpu) to "
            "run the port on the CPU")
    # The JAX reference computes in full float32.  cuBLAS matmuls already
    # default to f32 here, but cuDNN convolutions default to TF32 (about
    # three decimal digits), so both are pinned off for the whole process.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # Under model_config.dtype bfloat16 / float16, XLA sums a 16-bit GEMM
    # in float32; cuBLAS may otherwise reduce in the 16-bit type.
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    # The JAX package replays a run bit for bit (a resumed run equals an
    # uninterrupted one).  cuDNN otherwise picks convolution algorithms
    # that sum with atomics, and two runs of one config then differ.
    torch.backends.cudnn.deterministic = True
    return dev


def host_to_device(values, device: torch.device,
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Host values (a list or an array) as a tensor on ``device``.  To a
    card they go from pinned memory with a ``non_blocking`` copy: a copy
    from pageable memory waits for every kernel queued before it, a hidden
    sync.  The pinned block is not reused until its copy has run (the
    caching host allocator records the copy's stream)."""
    host = torch.as_tensor(values, dtype=dtype)
    if torch.device(device).type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


@contextlib.contextmanager
def cpu16_guard(device: DeviceLike,
                *dtypes: Optional[torch.dtype]) -> Iterator[None]:
    """The context a model's forward and backward run in.  On the CPU, a
    step that computes in bfloat16 or float16 (any of ``dtypes``) runs
    with oneDNN off: oneDNN's 16-bit convolution weight gradient returns
    garbage, NaN at times, at the taps that see only padding (``x [4, 256,
    1, 1]``, ``w [512, 256, 3, 3]``, stride 2, padding 1, under ``vmap``:
    in most calls with torch 2.13 on a CPU with AMX), where those taps'
    gradient is exactly 0 (``tests/test_torch_conv16_cpu.py``).  float32
    steps, and every step on CUDA (cuDNN runs its convolutions), keep the
    library's defaults.  The flag is set around the caller's whole
    forward and backward: autograd runs the backward inside the call of
    ``vmap(grad(...))``, not inside the layer."""
    if (torch.device(device).type != "cpu" or
            not any(dt in (torch.bfloat16, torch.float16) for dt in dtypes)):
        yield
        return
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = prev


#: the cards whose rates the device-truth layer knows (NVIDIA's data
#: sheet, SXM part, dense): peak FLOP/s by compute dtype (float32 outside
#: the tensor cores, as the port runs with TF32 off; bfloat16 and float16
#: on them) and the memory's bytes a second, keyed on
#: ``torch.cuda.get_device_name``
CARD_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"float32": 67e12, "bfloat16": 989e12,
                              "float16": 989e12, "bytes_per_s": 3.35e12},
}

#: the JAX package's nominal CPU rates (``utils/compat.py``): CPU MFU
#: values compare across CPU runs, never against a card's
CPU_NOMINAL_PEAK_FLOPS = 1e11
CPU_NOMINAL_BYTES_PER_SEC = 5e10


def chip_peak_flops(device: torch.device, compute_dtype: str = "float32"
                    ) -> tuple:
    """``(kind, peak FLOP/s)`` of ``device`` in ``compute_dtype``: a card
    of :data:`CARD_PEAKS` by its name, the CPU's nominal peak, and for any
    other card its name and None (no peak is guessed; its MFU is None)."""
    if device.type != "cuda":
        return "cpu", CPU_NOMINAL_PEAK_FLOPS
    name = torch.cuda.get_device_name(device)
    return name, CARD_PEAKS.get(name, {}).get(str(compute_dtype))


def chip_bytes_per_sec(device: torch.device) -> tuple:
    """``(kind, memory bytes a second)``, as :func:`chip_peak_flops`."""
    if device.type != "cuda":
        return "cpu", CPU_NOMINAL_BYTES_PER_SEC
    name = torch.cuda.get_device_name(device)
    return name, CARD_PEAKS.get(name, {}).get("bytes_per_s")
