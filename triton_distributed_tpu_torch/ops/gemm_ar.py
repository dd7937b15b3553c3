"""Fused GEMM + AllReduce, the row-parallel epilogue of tensor-parallel
decode (counterpart of triton_distributed_tpu/ops/gemm_ar.py).

`gemm_ar_shard(a, b)` takes rank-stacked operands (parallel/mesh.py): a
(n, M, K_shard) and b (n, K_shard, N); it returns (n, M, N), every rank's
replica of sum_s a[s] @ b[s]. The dispatch rule is ops/_common.tp_dispatch: the plain collective path
(a matmul, then `psum`) is logged as "xla"; the kernel path launches
csrc/gemm_ar.cu (`GEMM_AR`, a one-shot push of every partial tile to
every rank) on a CUDA tensor or raises. Both plain forms, the collective
path and the CPU tensor's kernel path, run `_gemm_ar_plain`. Kernel and
plain version round each rank's partial to the dtype and sum the n
partials in rank order in f32, rounded once, so the replicas agree bit
for bit.

`wire_dtype` ("int8" / "float8_e4m3fn") quantizes the wire, as the JAX op
does (its `_kernel_quant` :156 and dispatch :295-317): the kernel path
launches the quant arm of csrc/gemm_ar.cu (`GEMM_AR_QUANT`), whose plain
version is `_gemm_ar_quant_plain`: each rank's f32 partial, not rounded,
is block-quantized once and broadcast, and every rank sums the n
dequantized partials in rank order in f32, rounding once. The plain
collective path quantizes the partial rounded to the dtype
(`wire.quant_psum`), as JAX's XLA fallback does. At one rank, or where no
block divides N, the op runs full width and logs why
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
from .gemm_rs import _describe

GEMM_AR = CudaKernel("gemm_ar", "tdt_gemm_ar", shmem.primitives.TP_ARGTYPES)
GEMM_AR_QUANT = CudaKernel("gemm_ar", "tdt_gemm_ar_quant",
                           shmem.primitives.TP_QUANT_ARGTYPES)


def _gemm_ar_plain(a, b):
    """Plain version of the kernel, and the plain collective path: the
    partials rounded to the dtype, then psum (summed in rank order in f32
    and rounded once); every rank's replica, a broadcast view of one
    copy."""
    n = a.shape[0]
    partial = (a.float() @ b.float()).to(a.dtype)
    return RankGroup(n).psum(partial).expand(n, -1, -1)


def _gemm_ar_quant_plain(a, b, wire_dtype, blk):
    """Plain version of the quant arm: each rank's f32 partial (n, M, N)
    block-quantized as it is (`wire.quant_value_blocks`), the n partials
    dequantized and summed in rank order in f32, rounded once
    (`wire.dequant_accumulate`); every rank's replica, a broadcast view of
    one copy."""
    n, M, _ = a.shape
    N = b.shape[2]
    acc = (a.float() @ b.float()).reshape(n * M, N)
    q, s = wire.quant_value_blocks(acc, wire_dtype, blk)
    out = wire.dequant_accumulate(q.view(n, M, N), s.view(n, M, N // blk),
                                  a.dtype, blk)
    return out.expand(n, -1, -1)


def gemm_ar_shard(a, b, *, num_ranks: int, use_xla: bool = False,
                  wire_dtype=None, wire_block: int = wire.WIRE_BLOCK):
    """sum_s a[s] @ b[s], replicated on every rank. a: (n, M, K_shard); b:
    (n, K_shard, N). Returns (n, M, N) (a broadcast view of one copy on
    the plain paths, n written replicas from the kernel). `wire_dtype` /
    `wire_block`: the quantized wire (module docstring)."""
    n = num_ranks
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != n or b.shape[0] != n \
            or a.shape[2] != b.shape[1]:
        raise ValueError(f"gemm_ar: a {tuple(a.shape)} and b {tuple(b.shape)} "
                         f"are not rank-stacked (n, M, K) / (n, K, N) with "
                         f"n = {n}")
    wd, blk = wire_dispatch("gemm_ar", n, b.shape[2], wire_dtype, wire_block)
    if not tp_dispatch("gemm_ar", n, a, b, use_xla, wire_blk=blk):
        if wd is None:
            return _gemm_ar_plain(a, b)
        record_dispatch("gemm_ar", "xla", "wire")
        partial = (a.float() @ b.float()).to(a.dtype)
        return wire.quant_psum(partial, wd, blk).expand(n, -1, -1)
    if a.device.type == "cpu":
        return (_gemm_ar_plain(a, b) if wd is None
                else _gemm_ar_quant_plain(a, b, wd, blk))
    check_tp_cuda("gemm_ar", a, b)
    return _launch(a, b) if wd is None else _launch_quant(a, b, wd, blk)


def _workspace(a, b):
    """(workspace, row tile) of the kernel at a's shape."""
    n, M, _ = a.shape
    N = b.shape[2]
    bm = tp_block_m(M)
    m_tiles, n_tiles = -(-M // bm), -(-N // 128)
    return shmem.workspace("gemm_ar", a.device, n, (n, M, N), a.dtype,
                           1 + n * m_tiles * n_tiles,
                           _describe(m_tiles, n_tiles)), bm


def _launch(a, b, *, budget_s=shmem.WAIT_BUDGET_S, **kw):
    """Launch csrc/gemm_ar.cu on checked CUDA operands (kw: launch_tp's
    epoch / grid / rank_lo / rank_cnt)."""
    n, M, K = a.shape
    N = b.shape[2]
    ws, bm = _workspace(a, b)
    out = torch.empty((n, M, N), dtype=a.dtype, device=a.device)
    shmem.launch_tp(GEMM_AR, ws, a, b, out, M, K, N, bm, budget_s=budget_s,
                    **kw)
    return out


def _quant_workspace(a, b, blk):
    """(workspace, row tile) of the quant arm at a's shape and block."""
    n, M, _ = a.shape
    bm = tp_block_m(M)
    return shmem.wire_workspace("gemm_ar", a.device, n, M, b.shape[2], blk,
                                bm), bm


def _launch_quant(a, b, wire_dtype, blk, *, budget_s=shmem.WAIT_BUDGET_S,
                  **kw):
    """Launch the quant arm of csrc/gemm_ar.cu on checked CUDA operands
    (kw: launch_tp's epoch / grid / rank_lo / rank_cnt)."""
    n, M, K = a.shape
    N = b.shape[2]
    ws, bm = _quant_workspace(a, b, blk)
    out = torch.empty((n, M, N), dtype=a.dtype, device=a.device)
    shmem.launch_tp(GEMM_AR_QUANT, ws, a, b, out, M, K, N, bm,
                    wire=(shmem.WIRE_CODES[wire_dtype], blk),
                    budget_s=budget_s, **kw)
    return out
