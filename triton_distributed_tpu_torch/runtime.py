"""Device and dtype bootstrap (counterpart of
triton_distributed_tpu/runtime.py).

The JAX runtime picks a backend and builds a device mesh. The port runs
on one CUDA device: entry points take an explicit `device`, default to
the GPU, and never carry on silently on the CPU — the CPU is used only
when the caller asks for it (the tests do).
"""

from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def default_device() -> torch.device:
    """The GPU. Raises RuntimeError when there is none: a caller that
    wants the CPU passes device="cpu" explicitly."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    return default_device() if device is None else torch.device(device)


def resolve_dtype(dtype) -> torch.dtype:
    """torch dtype from a torch dtype or one of the names in DTYPES."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in DTYPES:
        raise ValueError(f"dtype {dtype!r} not in {sorted(DTYPES)}")
    return DTYPES[dtype]


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b
