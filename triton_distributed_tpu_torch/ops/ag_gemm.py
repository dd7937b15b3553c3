"""Fused AllGather + GEMM, the column-parallel projection of tensor-parallel
prefill (counterpart of triton_distributed_tpu/ops/ag_gemm.py).

`ag_gemm_shard(a, b)` takes rank-stacked operands (parallel/mesh.py): a
(n, m_per, K), rank r's row shard of A, and b (n, K, N), rank r's column
shard of B; it returns (n, n * m_per, N), rank r's all_gather(A) @ B_r.
The dispatch rule is ops/_common.tp_dispatch: at one rank, or with
`use_xla`, the plain collective path (`all_gather` then a matmul), logged
as "xla"; otherwise, logged as "kernel", a CUDA tensor launches
csrc/ag_gemm.cu (`AG_GEMM`, with a `launches` count) or raises. Both plain
forms, the collective path and the CPU tensor's kernel path, run
`_ag_gemm_plain`, the kernel's plain version, with the same rounding
points (f32 sums, rounded once). Nothing falls back from the kernel to
anything else.
"""

from __future__ import annotations

import torch

from .. import shmem
from ._build import CudaKernel
from ._common import check_tp_cuda, tp_block_m, tp_dispatch

AG_GEMM = CudaKernel("ag_gemm", "tdt_ag_gemm", shmem.primitives.TP_ARGTYPES)


def _ag_gemm_plain(a, b):
    """Plain version of the kernel, and the plain collective path: the
    gathered A (all_gather, tiled) against every rank's B, summed in f32
    and rounded once. (n, n * m_per, N)."""
    n, m_per, K = a.shape
    return (a.reshape(n * m_per, K).float() @ b.float()).to(a.dtype)


def _describe(m_tiles):
    def name(sig):
        if sig == 0:
            return "barrier_all"
        s, c = divmod(sig - 1, m_tiles)
        return f"the landing of source {s}'s row chunk {c}"
    return name


def ag_gemm_shard(a, b, *, num_ranks: int, use_xla: bool = False):
    """all_gather(A) @ B_r for every rank r. a: (n, m_per, K) rank-stacked
    row shards; b: (n, K, N) rank-stacked column shards. Returns (n, n *
    m_per, N) in a's dtype, rows in source-rank order."""
    n = num_ranks
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != n or b.shape[0] != n \
            or a.shape[2] != b.shape[1]:
        raise ValueError(f"ag_gemm: a {tuple(a.shape)} and b {tuple(b.shape)} "
                         f"are not rank-stacked (n, m, K) / (n, K, N) with "
                         f"n = {n}")
    if not tp_dispatch("ag_gemm", n, a, b, use_xla) or a.device.type == "cpu":
        return _ag_gemm_plain(a, b)
    check_tp_cuda("ag_gemm", a, b)
    return _launch(a, b)


def _workspace(a, b):
    """(workspace, row tile) of the kernel at a's shape."""
    n, m_per, K = a.shape
    bm = tp_block_m(m_per)
    m_tiles = -(-m_per // bm)
    return shmem.workspace("ag_gemm", a.device, n, (n, m_per, K), a.dtype,
                           1 + n * m_tiles, _describe(m_tiles)), bm


def _launch(a, b, *, budget_s=shmem.WAIT_BUDGET_S, **kw):
    """Launch csrc/ag_gemm.cu on checked CUDA operands (kw: launch_tp's
    epoch / grid / rank_lo / rank_cnt)."""
    n, m_per, K = a.shape
    N = b.shape[2]
    ws, bm = _workspace(a, b)
    out = torch.empty((n, n * m_per, N), dtype=a.dtype, device=a.device)
    shmem.launch_tp(AG_GEMM, ws, a, b, out, m_per, K, N, bm,
                    budget_s=budget_s, **kw)
    return out
