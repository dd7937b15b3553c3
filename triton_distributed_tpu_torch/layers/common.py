"""Mode validation and the row-parallel output projection (counterpart of
triton_distributed_tpu/layers/common.py).

The JAX package's modes pick the collective behind each tensor-parallel
epilogue: "xla" (psum_scatter), "fused" (GEMM+ReduceScatter kernel),
"ar" (psum), "gemm_ar" (GEMM+AllReduce kernel). At one rank every one of
them is the plain matmul. At n ranks the rows are rank-stacked (n, M,
K_shard) and the weight (n, K_shard, N) (parallel/mesh.py).
"""

from __future__ import annotations

from ..ops.gemm_ar import gemm_ar_shard
from ..ops.gemm_rs import gemm_rs_shard
from ..parallel.mesh import RankGroup

MODES = ("xla", "fused", "ar", "gemm_ar")
QUANT_WIRE = ("the quantized wire (wire_dtype, the JAX _kernel_quant arms "
              "of ops/gemm_rs.py:176 and ops/gemm_ar.py:156) is not ported "
              "yet: ROADMAP.md Queue B, the quant arms")


def check_mode(mode: str) -> str:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    return mode


def check_one_rank(num_ranks: int, what: str) -> int:
    """Refuse n > 1 where the port has only the one-rank form: the perf
    model's multi-rank arms (its EP estimators and step estimators at
    tp_ranks > 1 need H100 figures that are not measured yet)."""
    if num_ranks != 1:
        raise NotImplementedError(
            f"num_ranks={num_ranks}: {what} run at one rank only in the "
            f"PyTorch port; the multi-rank arms of perf_model.py wait for "
            f"their H100 figures (ROADMAP.md Queue A, slice 6)")
    return num_ranks


def row_parallel_out(rows, w, *, mode, num_ranks: int = 1, wire_dtype=None):
    """Row-parallel projection epilogue: rows @ w summed across ranks. At
    one rank the matmul itself. At n ranks rows (n, M, K_shard) and w (n,
    K_shard, N): "fused" / "xla" return rank r's row chunk (n, M / n, N);
    "ar" / "gemm_ar" the replicated sum (M, N), kept once. `wire_dtype`
    (the quantized wire) raises: not ported yet."""
    check_mode(mode)
    if wire_dtype is not None:
        raise NotImplementedError(QUANT_WIRE)
    n = num_ranks
    if n == 1:
        return rows @ w
    if mode == "fused":
        return gemm_rs_shard(rows, w, num_ranks=n)
    if mode == "xla":
        return RankGroup(n).psum_scatter(rows @ w)
    if mode == "gemm_ar":
        return gemm_ar_shard(rows, w, num_ranks=n)[0]
    return RankGroup(n).psum(rows @ w)
