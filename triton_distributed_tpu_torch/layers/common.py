"""Mode validation and the row-parallel output projection (counterpart of
triton_distributed_tpu/layers/common.py).

The JAX package's modes pick the collective behind each tensor-parallel
epilogue: "xla" (psum_scatter), "fused" (GEMM+ReduceScatter kernel),
"ar" (psum), "gemm_ar" (GEMM+AllReduce kernel). At one rank every one of
them is the plain matmul. At n ranks the rows are rank-stacked (n, M,
K_shard) and the weight (n, K_shard, N) (parallel/mesh.py).
"""

from __future__ import annotations

from ..ops import wire
from ..ops.gemm_ar import gemm_ar_shard
from ..ops.gemm_rs import gemm_rs_shard
from ..parallel.mesh import RankGroup

MODES = ("xla", "fused", "ar", "gemm_ar")


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
    "ar" / "gemm_ar" the replicated sum (M, N), kept once.

    `wire_dtype` ("int8" / "float8_e4m3fn") quantizes the epilogue's
    collective wire (JAX common.py:35-62): "fused" and "gemm_ar" take
    their kernels' quant arms, "ar" becomes `wire.quant_psum` when a
    scaling block divides N, and "xla" stays full width, the golden the
    others are held to."""
    check_mode(mode)
    wire.resolve_wire_dtype(wire_dtype)             # loud on a typo
    n = num_ranks
    if n == 1:                  # no wire to quantize
        return rows @ w
    if mode == "fused":
        return gemm_rs_shard(rows, w, num_ranks=n, wire_dtype=wire_dtype)
    if mode == "xla":
        return RankGroup(n).psum_scatter(rows @ w)
    if mode == "gemm_ar":
        return gemm_ar_shard(rows, w, num_ranks=n, wire_dtype=wire_dtype)[0]
    partial = rows @ w
    if wire_dtype is not None and \
            wire.effective_block(partial.shape[-1]) is not None:
        return wire.quant_psum(partial, wire_dtype)
    return RankGroup(n).psum(partial)
