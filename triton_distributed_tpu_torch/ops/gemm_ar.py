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
for bit. The quantized wire (the JAX `_kernel_quant` :156) is not ported
yet: layers/common.row_parallel_out raises on `wire_dtype`.
"""

from __future__ import annotations

import torch

from .. import shmem
from ..parallel.mesh import RankGroup
from ._build import CudaKernel
from ._common import check_tp_cuda, tp_block_m, tp_dispatch
from .gemm_rs import _describe

GEMM_AR = CudaKernel("gemm_ar", "tdt_gemm_ar", shmem.primitives.TP_ARGTYPES)


def _gemm_ar_plain(a, b):
    """Plain version of the kernel, and the plain collective path: the
    partials rounded to the dtype, then psum (summed in rank order in f32
    and rounded once); every rank's replica, a broadcast view of one
    copy."""
    n = a.shape[0]
    partial = (a.float() @ b.float()).to(a.dtype)
    return RankGroup(n).psum(partial).expand(n, -1, -1)


def gemm_ar_shard(a, b, *, num_ranks: int, use_xla: bool = False):
    """sum_s a[s] @ b[s], replicated on every rank. a: (n, M, K_shard); b:
    (n, K_shard, N). Returns (n, M, N) (a broadcast view of one copy on
    the plain paths, n written replicas from the kernel)."""
    n = num_ranks
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != n or b.shape[0] != n \
            or a.shape[2] != b.shape[1]:
        raise ValueError(f"gemm_ar: a {tuple(a.shape)} and b {tuple(b.shape)} "
                         f"are not rank-stacked (n, M, K) / (n, K, N) with "
                         f"n = {n}")
    if not tp_dispatch("gemm_ar", n, a, b, use_xla) or a.device.type == "cpu":
        return _gemm_ar_plain(a, b)
    check_tp_cuda("gemm_ar", a, b)
    return _launch(a, b)


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
