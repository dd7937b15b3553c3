"""Small shared helpers of the port's ops (counterpart of the parts of
triton_distributed_tpu/ops/_common.py that the ported ops use)."""

from __future__ import annotations

import collections
import dataclasses

import torch

# ---------------------------------------------------------------------------
# Dispatch log: which path each fused op took, "kernel" (the CUDA kernel on a
# GPU, its plain version on the CPU) or "xla" (the plain collective path),
# with the reason for the latter ("n==1", "requested"). The JAX package
# records at trace time, once per compiled shape; eager PyTorch records
# every call.
# ---------------------------------------------------------------------------

_DISPATCH: collections.Counter = collections.Counter()


def record_dispatch(op: str, path: str, reason: str = "") -> None:
    _DISPATCH[(op, path, reason)] += 1


def dispatch_counts(op: str | None = None) -> dict:
    """Counts of (op, path, reason) since the last reset."""
    if op is None:
        return dict(_DISPATCH)
    return {k: v for k, v in _DISPATCH.items() if k[0] == op}


def reset_dispatch() -> None:
    _DISPATCH.clear()


def resolve_block_m(block_m, gemm):
    """One source of truth for the MoE row-tile size. An explicit outer
    `block_m` (not None) propagates into the grouped-GEMM config and
    wins; `block_m=None` adopts the gemm config's value. Returns the
    resolved (block_m, gemm) pair — after resolution the two agree."""
    if block_m is None:
        return gemm.block_m, gemm
    return block_m, dataclasses.replace(gemm, block_m=block_m)


# ---------------------------------------------------------------------------
# The fused tensor-parallel ops (ag_gemm, gemm_rs, gemm_ar): their dispatch
# rule and the port's shape limits.
# ---------------------------------------------------------------------------

TP_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
TP_MAX_RANKS = 8        # csrc/gemm_ar.cu MAX_RANKS


def tp_dispatch(op: str, n: int, a, b, use_xla: bool = False) -> bool:
    """True for the kernel path. The plain collective path when requested
    (`use_xla`) or at one rank, as in the JAX op (ag_gemm.py:176,
    gemm_rs.py:340, gemm_ar.py:302). The JAX op's other rules are the
    TPU's: its tile divisibility (the CUDA kernels mask ragged row and
    column tiles) and its VMEM limit, which the port replaces by its own
    limits: bf16 or f32 operands of one dtype, K and N multiples of 8
    (16-byte rows), at most 8 ranks. Operands outside them raise, on every
    device. Every call is logged."""
    reason = "requested" if use_xla else "n==1" if n == 1 else ""
    if not reason:
        K, N = b.shape[-2], b.shape[-1]
        if a.dtype not in TP_KERNEL_DTYPES or a.dtype != b.dtype \
                or K % 8 or N % 8 or n > TP_MAX_RANKS:
            raise ValueError(
                f"{op}: the kernel takes bf16 or f32 operands of one dtype, "
                f"K and N multiples of 8 and at most {TP_MAX_RANKS} ranks; "
                f"got {a.dtype} / {b.dtype}, K {K}, N {N}, {n} ranks")
    record_dispatch(op, "xla" if reason else "kernel", reason)
    return not reason


def tp_block_m(rows: int) -> int:
    """Row tile of the tensor-parallel kernels: 16 for a product of at most
    16 rows (decode), else 64."""
    return 16 if rows <= 16 else 64


def check_tp_cuda(op: str, *tensors) -> None:
    """A tensor-parallel kernel takes contiguous, 16-byte aligned CUDA
    operands on one device."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{op}: no kernel for device {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{op}: operands on {t.device} and {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{op}: the CUDA kernel takes contiguous, "
                             f"16-byte aligned operands")
