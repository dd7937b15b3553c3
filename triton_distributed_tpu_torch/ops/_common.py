"""Small shared helpers of the port's ops (counterpart of the parts of
triton_distributed_tpu/ops/_common.py that the ported ops use)."""

from __future__ import annotations

import collections
import dataclasses

import torch

from . import wire

# ---------------------------------------------------------------------------
# Dispatch log: which path each fused op took, "kernel" (the CUDA kernel on a
# GPU, its plain version on the CPU) or "xla" (the plain collective path),
# with the reason for the latter ("n==1", "requested"). The quantized wire
# adds JAX's records (gemm_rs.py:331-360, gemm_ar.py:295-317): ("kernel",
# "wire") for the quant arm, ("xla", "wire") beside the plain path's record
# when that path quantizes, and ("kernel", "wire-fallback:n==1" |
# "wire-fallback:block-divisibility") when a wire was asked for but the mesh
# or the row width has no usable block, so the op runs full width. The JAX
# package records at trace time, once per compiled shape; eager PyTorch
# records every call.
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


def wire_dispatch(op: str, n: int, width: int, wire_dtype,
                  wire_block: int | None):
    """(wire dtype name, scaling block) for a quantized epilogue of
    `width` columns, or (None, None) for full width: when no wire was
    asked for, or, logged as JAX's "wire-fallback" (gemm_rs.py:331-337),
    at one rank or where no block divides the row."""
    name = wire.resolve_wire_dtype(wire_dtype)
    if name is None:
        return None, None
    blk = wire.effective_block(width, wire_block)
    if blk is None or n == 1:
        record_dispatch(op, "kernel", "wire-fallback:" + (
            "n==1" if n == 1 else "block-divisibility"))
        return None, None
    return name, blk


# The quant arms' CTA quantizes a strip of whole scaling blocks: blocks of
# at most 128 columns that tile the kernels' 128-column tile, or strips of
# one block, a multiple of 128 columns up to 512 (the f32 strip is staged
# in shared memory: 64 rows x 512 x 4 bytes at most).
WIRE_MAX_STRIP = 512


def check_wire_block(op: str, blk: int) -> None:
    """The quant arms' block rule (csrc/tdt_wire.cuh), on every device: a
    scaling block that is a multiple of 8 and divides 128, or a multiple
    of 128 of at most WIRE_MAX_STRIP."""
    if blk % 8 or (128 % blk and (blk % 128 or blk > WIRE_MAX_STRIP)):
        raise ValueError(
            f"{op}: the quantized wire's kernel takes a scaling block that "
            f"is a multiple of 8 dividing 128, or a multiple of 128 up to "
            f"{WIRE_MAX_STRIP}; got {blk}")


def tp_dispatch(op: str, n: int, a, b, use_xla: bool = False,
                wire_blk: int | None = None) -> bool:
    """True for the kernel path. The plain collective path when requested
    (`use_xla`) or at one rank, as in the JAX op (ag_gemm.py:176,
    gemm_rs.py:340, gemm_ar.py:302). The JAX op's other rules are the
    TPU's: its tile divisibility (the CUDA kernels mask ragged row and
    column tiles) and its VMEM limit, which the port replaces by its own
    limits: bf16 or f32 operands of one dtype, K and N multiples of 8
    (16-byte rows), at most 8 ranks. Operands outside them raise, on every
    device. A quantized wire (`wire_blk`, its scaling block) adds the
    quant arms' block rule (`check_wire_block`) and logs the kernel path
    as ("kernel", "wire"). Every call is logged."""
    reason = "requested" if use_xla else "n==1" if n == 1 else ""
    if not reason:
        K, N = b.shape[-2], b.shape[-1]
        if a.dtype not in TP_KERNEL_DTYPES or a.dtype != b.dtype \
                or K % 8 or N % 8 or n > TP_MAX_RANKS:
            raise ValueError(
                f"{op}: the kernel takes bf16 or f32 operands of one dtype, "
                f"K and N multiples of 8 and at most {TP_MAX_RANKS} ranks; "
                f"got {a.dtype} / {b.dtype}, K {K}, N {N}, {n} ranks")
        if wire_blk is not None:
            check_wire_block(op, wire_blk)
    record_dispatch(op, "xla" if reason else "kernel",
                    reason or ("wire" if wire_blk is not None else ""))
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


# ---------------------------------------------------------------------------
# The collective library (ops/collectives): its kernels' operand rule.
# ---------------------------------------------------------------------------

COLL_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def check_coll_cuda(op: str, x, n: int, dtypes=COLL_KERNEL_DTYPES) -> None:
    """A collective kernel takes one contiguous CUDA tensor of `dtypes`
    (None: any) at most 8 ranks."""
    from ..shmem.primitives import COLL_MAX_RANKS

    if x.device.type != "cuda":
        raise ValueError(f"{op}: no kernel for device {x.device}")
    if dtypes is not None and x.dtype not in dtypes:
        raise TypeError(f"{op}: the CUDA kernel takes "
                        f"{[str(d) for d in dtypes]}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{op}: the CUDA kernel takes a contiguous tensor")
    if n > COLL_MAX_RANKS:
        raise ValueError(f"{op}: the CUDA kernel takes at most "
                         f"{COLL_MAX_RANKS} ranks, got {n}")

