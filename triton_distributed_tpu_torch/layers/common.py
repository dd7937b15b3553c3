"""Mode validation and the row-parallel output projection (counterpart of
triton_distributed_tpu/layers/common.py).

The JAX package's modes pick the collective behind each tensor-parallel
epilogue: "xla" (psum_scatter), "fused" (GEMM+ReduceScatter kernel),
"ar" (psum), "gemm_ar" (GEMM+AllReduce kernel). At one rank every one of
them is the plain matmul, which is all the port runs so far.
"""

from __future__ import annotations

MODES = ("xla", "fused", "ar", "gemm_ar")


def check_mode(mode: str) -> str:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    return mode


def check_one_rank(num_ranks: int) -> int:
    if num_ranks != 1:
        raise NotImplementedError(
            f"num_ranks={num_ranks}: the PyTorch port runs one rank only; "
            f"the multi-rank layer is ROADMAP.md Queue A, slice 6")
    return num_ranks


def row_parallel_out(rows, w, *, mode, num_ranks: int = 1):
    """Row-parallel projection epilogue: rows (M, K) @ w (K, N), summed
    across ranks — at one rank, the matmul itself."""
    check_mode(mode)
    check_one_rank(num_ranks)
    return rows @ w
