"""Fused GEMM + ReduceScatter, the row-parallel epilogue of tensor-parallel
prefill (counterpart of triton_distributed_tpu/ops/gemm_rs.py).

`gemm_rs_shard(a, b)` takes rank-stacked operands (parallel/mesh.py): a
(n, M, K_shard), rank r's activations with K sharded, and b (n, K_shard,
N); it returns (n, M / n, N), rank r's row chunk of sum_s a[s] @ b[s].
The dispatch rule is ops/_common.tp_dispatch: the plain collective path
(a matmul, then `psum_scatter`) is logged as "xla"; the kernel path
launches csrc/gemm_rs.cu (`GEMM_RS`) on a CUDA tensor or raises. Both
plain forms, the collective path and the CPU tensor's kernel path, run
`_gemm_rs_plain`. Kernel and plain version round each rank's partial to
the dtype and sum the n partials in rank order in f32, rounded once, as
the TPU kernel does.

`wire_dtype` ("int8" / "float8_e4m3fn") quantizes the wire, as the JAX op
does (its `_kernel_quant` :176 and dispatch :331-360): the kernel path
launches the quant arm of csrc/gemm_rs.cu (`GEMM_RS_QUANT`), whose plain
version is `_gemm_rs_quant_plain`: each rank's f32 partial, not rounded,
is block-quantized (one f32 scale per `wire_block` columns) and the owner
sums its n dequantized chunks in rank order in f32, rounding once. The
plain collective path quantizes the partial rounded to the dtype
(`wire.quant_psum_scatter`), as JAX's XLA fallback does. At one rank, or
where no block divides N, the op runs full width and logs why
(`ops/_common.wire_dispatch`).
"""

from __future__ import annotations

import torch

from .. import shmem
from ..parallel.mesh import RankGroup
from . import wire
from ._build import CudaKernel
from ._common import (check_tp_cuda, record_dispatch, tp_block_m,
                      tp_dispatch, wire_dispatch)

GEMM_RS = CudaKernel("gemm_rs", "tdt_gemm_rs", shmem.primitives.TP_ARGTYPES)
GEMM_RS_QUANT = CudaKernel("gemm_rs", "tdt_gemm_rs_quant",
                           shmem.primitives.TP_QUANT_ARGTYPES)


def _gemm_rs_plain(a, b):
    """Plain version of the kernel, and the plain collective path: each
    rank's partial summed in f32 and rounded to the dtype, then
    psum_scatter (the n partials summed in rank order in f32 and rounded
    once, rank r keeping row chunk r). (n, M / n, N)."""
    partial = (a.float() @ b.float()).to(a.dtype)
    return RankGroup(a.shape[0]).psum_scatter(partial)


def _gemm_rs_quant_plain(a, b, wire_dtype, blk):
    """Plain version of the quant arm: each rank's f32 partial (n, M, N)
    block-quantized as it is (`wire.quant_value_blocks`), row chunk p of
    every source landing on rank p, which dequantizes its n chunks and sums
    them in rank order in f32, rounded once (`wire.dequant_accumulate`).
    (n, M / n, N)."""
    n, M, _ = a.shape
    N = b.shape[2]
    acc = (a.float() @ b.float()).reshape(n * M, N)
    q, s = wire.quant_value_blocks(acc, wire_dtype, blk)
    return wire.dequant_accumulate(q.view(n, n, M // n, N),
                                   s.view(n, n, M // n, N // blk), a.dtype,
                                   blk)


def _describe(m_tiles, n_tiles, what="tile"):
    def name(sig):
        if sig == 0:
            return "barrier_all"
        s, t = divmod(sig - 1, m_tiles * n_tiles)
        return f"source {s}'s partial {what} {divmod(t, n_tiles)}"
    return name


def gemm_rs_shard(a, b, *, num_ranks: int, use_xla: bool = False,
                  wire_dtype=None, wire_block: int = wire.WIRE_BLOCK):
    """Row chunk r of sum_s a[s] @ b[s] for every rank r. a: (n, M,
    K_shard); b: (n, K_shard, N); M % n == 0. Returns (n, M / n, N).
    `wire_dtype` / `wire_block`: the quantized wire (module docstring)."""
    n = num_ranks
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != n or b.shape[0] != n \
            or a.shape[2] != b.shape[1] or a.shape[1] % n:
        raise ValueError(f"gemm_rs: a {tuple(a.shape)} and b {tuple(b.shape)} "
                         f"are not rank-stacked (n, M, K) / (n, K, N) with "
                         f"n = {n} and M % n == 0")
    wd, blk = wire_dispatch("gemm_rs", n, b.shape[2], wire_dtype, wire_block)
    if not tp_dispatch("gemm_rs", n, a, b, use_xla, wire_blk=blk):
        if wd is None:
            return _gemm_rs_plain(a, b)
        record_dispatch("gemm_rs", "xla", "wire")
        partial = (a.float() @ b.float()).to(a.dtype)
        return wire.quant_psum_scatter(partial, wd, blk)
    if a.device.type == "cpu":
        return (_gemm_rs_plain(a, b) if wd is None
                else _gemm_rs_quant_plain(a, b, wd, blk))
    check_tp_cuda("gemm_rs", a, b)
    return _launch(a, b) if wd is None else _launch_quant(a, b, wd, blk)


def _workspace(a, b):
    """(workspace, row tile) of the kernel at a's shape."""
    n, M, _ = a.shape
    N = b.shape[2]
    bm = tp_block_m(M // n)
    m_tiles, n_tiles = -(-(M // n) // bm), -(-N // 128)
    return shmem.workspace("gemm_rs", a.device, n, (n, M // n, N), a.dtype,
                           1 + n * m_tiles * n_tiles,
                           _describe(m_tiles, n_tiles)), bm


def _launch(a, b, *, budget_s=shmem.WAIT_BUDGET_S, **kw):
    """Launch csrc/gemm_rs.cu on checked CUDA operands (kw: launch_tp's
    epoch / grid / rank_lo / rank_cnt)."""
    n, M, K = a.shape
    N = b.shape[2]
    ws, bm = _workspace(a, b)
    out = torch.empty((n, M // n, N), dtype=a.dtype, device=a.device)
    shmem.launch_tp(GEMM_RS, ws, a, b, out, M, K, N, bm, budget_s=budget_s,
                    **kw)
    return out


def _quant_workspace(a, b, blk):
    """(workspace, row tile) of the quant arm at a's shape and block."""
    n, M, _ = a.shape
    N = b.shape[2]
    bm = tp_block_m(M // n)
    return shmem.wire_workspace("gemm_rs", a.device, n, M // n, N, blk,
                                bm), bm


def _launch_quant(a, b, wire_dtype, blk, *, budget_s=shmem.WAIT_BUDGET_S,
                  **kw):
    """Launch the quant arm of csrc/gemm_rs.cu on checked CUDA operands
    (kw: launch_tp's epoch / grid / rank_lo / rank_cnt)."""
    n, M, K = a.shape
    N = b.shape[2]
    ws, bm = _quant_workspace(a, b, blk)
    out = torch.empty((n, M // n, N), dtype=a.dtype, device=a.device)
    shmem.launch_tp(GEMM_RS_QUANT, ws, a, b, out, M, K, N, bm,
                    wire=(shmem.WIRE_CODES[wire_dtype], blk),
                    budget_s=budget_s, **kw)
    return out
