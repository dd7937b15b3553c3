"""Fused AllGather + flash attention for sequence-parallel prefill
(counterpart of triton_distributed_tpu/ops/sp_ag_attention.py).

One kernel runs every rank's producer and consumer (csrc/sp_ag_attention.cu,
`SP_AG_ATTENTION`): each rank pushes its K / V shard into its peers'
landing slots and attends its query rows to every shard, its own first,
waiting on a chunk of a peer's rows only when it reaches it; the softmax
state of one (rank, head, q tile) persists across the shards, so there is
no cross-shard merge. Rank-stacked operands (parallel/mesh.py); the n ranks
run in one cooperative launch.

Dispatch is JAX's (:236-:284): the kernel takes B == 1 and a shard length
that JAX's q / k tiles (bq = min(block_q, round_up(s_loc, 8)), bk likewise)
divide; otherwise, on `force_ring`, or at one rank without `force_kernel`,
the op logs ("ring", reason) and runs the ring (`ring_attention_shard`,
or `ring_attention_varlen_shard` over the sideband re-padded to bq rows).
`force_kernel` on an unsupported shape raises. JAX's VMEM gate has no
counterpart: the kernel's state lives in registers, so a shape JAX sends to
the ring for its VMEM (its reason "vmem_state", which also names the tile
divisibility) runs the kernel here when the tiles divide. block_q / block_k
set the dispatch, not the CUDA tile (64 x 64).

On a CPU tensor the kernel route runs `_sp_ag_attention_plain`: the same
online recurrence over the shards in the kernel's order, the state carried
across shards; on a CUDA tensor it launches the kernel or raises (bf16, head
dim 64 or 128, at most 8 ranks).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from .. import shmem
from ..runtime import round_up
from ..parallel.mesh import shard, unshard
from . import _common
from ._build import CudaKernel
from .attention import (_KERNEL_HEAD_DIMS, _NEG_INF, _check_cuda, _on_cpu,
                        segment_sideband)
from .sp_attention import (pad_sideband, ring_attention_shard,
                           ring_attention_varlen_shard)

SP_AG_ATTENTION = CudaKernel("sp_ag_attention", "tdt_sp_ag_attention",
                             shmem.primitives.SP_AG_ARGTYPES)
SP_AG_RESIDENT = CudaKernel("sp_ag_attention", "tdt_sp_ag_attention_resident",
                            [ctypes.c_int])
SP_AG_CHUNK_ROWS = CudaKernel("sp_ag_attention", "tdt_sp_ag_chunk_rows",
                              [ctypes.c_int])


@dataclasses.dataclass(frozen=True)
class SpAgAttnConfig:
    block_q: int = 128
    block_k: int = 128
    # force the ring fallback / the fused kernel (tests)
    force_ring: bool = False
    force_kernel: bool = False


def _sp_ag_attention_plain(q, k, v, qmeta, *, causal, scale):
    """Plain version of the kernel. q (n, S, H, D), k / v (n, S, Hkv, D)
    rank-stacked, qmeta (n, >= S, 128) int32 or None. Rank r walks the
    shards r, r + 1, ..., r - 1 (the kernel's order), each in one step of
    the online softmax: scores in f32 times the scale, masked to -1e30 and
    p to 0 (causal: global column <= global row; varlen: the row's own
    sequence), the state (m, l, acc) carried from shard to shard; out =
    acc / max(l, 1e-30) in q's dtype. A shard wholly in a row's future or
    outside its sequence leaves its state bit for bit. The q rows go in
    chunks (rows are independent) that keep one step's f32 scores near 1
    GiB."""
    n, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    dev = q.device
    chunk_rows = max(1, 2**28 // (n * H * S))
    ranks = torch.arange(n, device=dev)
    cols = torch.arange(S, device=dev)
    seg = None if qmeta is None else \
        qmeta[:, :S, :2].to(device=dev, dtype=torch.int64)
    out = torch.empty_like(q)
    for a in range(0, S, chunk_rows):
        e = min(S, a + chunk_rows)
        qg = q[:, a:e].reshape(n, e - a, Hkv, G, D).float()
        rows = (ranks[:, None] * S + torch.arange(a, e, device=dev))[..., None]
        m = torch.full((n, Hkv, G, e - a, 1), _NEG_INF, device=dev)
        lsum = torch.zeros_like(m)
        acc = torch.zeros((n, Hkv, G, e - a, D), device=dev)
        for step in range(n):
            src = (ranks + step) % n
            colg = (src[:, None] * S + cols)[:, None, :]     # (n, 1, S)
            seen = torch.ones((n, e - a, S), dtype=torch.bool, device=dev)
            if causal:
                seen = seen & (colg <= rows)
            if seg is not None:
                seen = seen & (colg >= seg[:, a:e, 0:1]) \
                    & (colg < seg[:, a:e, 1:2])
            seen = seen[:, None, None]
            s = torch.einsum("nqkgd,nskd->nkgqs", qg, k[src].float()) * scale
            s = torch.where(seen, s, _NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.where(seen, torch.exp(s - m_new), 0.0)
            alpha = torch.exp(m - m_new)
            lsum = alpha * lsum + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum(
                "nkgqs,nskd->nkgqd", p.to(v.dtype).float(), v[src].float())
            m = m_new
        o = acc / lsum.clamp_min(1e-30)
        out[:, a:e] = o.permute(0, 3, 1, 2, 4).reshape(n, e - a, H, D).to(
            q.dtype)
    return out


def resident_ctas(head_dim: int = 128) -> int:
    """CTAs of the kernel that fit on the current GPU at once (its
    persistent grid's size at most)."""
    return SP_AG_RESIDENT._load()(head_dim)


def chunk_rows(s_loc: int) -> int:
    """KV rows one signal of the kernel guards at shard length s_loc."""
    return SP_AG_CHUNK_ROWS._load()(s_loc)


def workspace(device, n: int, s_loc: int, hkv: int, d: int, dtype,
              causal: bool) -> shmem.Workspace:
    """The kernel's workspace at this shape (shmem.sp_ag_workspace with
    the kernel's signal chunk)."""
    return shmem.sp_ag_workspace(device, n, s_loc, hkv, d, dtype, causal,
                                 chunk_rows(s_loc))


def _fused(q, k, v, qmeta, *, causal, scale, wait_budget):
    """The kernel route on rank-stacked q (n, S, H, D), k / v (n, S, Hkv,
    D), qmeta (n, rows >= S, 128) or None. Returns (n, S, H, D)."""
    n, S, H, D = q.shape
    if _on_cpu(q):
        return _sp_ag_attention_plain(q, k, v, qmeta, causal=causal,
                                      scale=scale)
    q, k, v = (t.contiguous() for t in (q, k, v))
    _check_cuda("sp_ag_attention", (q, k, v))
    if qmeta is not None:
        qmeta = qmeta.to(q.device).contiguous()
        _check_cuda("sp_ag_attention", (qmeta,), torch.int32)
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"sp_ag_attention: head_dim {D} not in "
                         f"{_KERNEL_HEAD_DIMS}")
    if n > shmem.primitives.SP_AG_MAX_RANKS:
        raise ValueError(f"sp_ag_attention: at most "
                         f"{shmem.primitives.SP_AG_MAX_RANKS} ranks, got {n}")
    ws = workspace(q.device, n, S, k.shape[2], D, q.dtype, causal)
    out = torch.empty_like(q)
    shmem.launch_sp_ag(SP_AG_ATTENTION, ws, q, k, v, qmeta, out,
                       causal=causal, scale=scale, budget_s=wait_budget)
    return out


def sp_ag_attention_shard(q, k, v, *, num_ranks: int, causal: bool = True,
                          scale: float | None = None,
                          config: SpAgAttnConfig | None = None, qmeta=None,
                          wait_budget: float = shmem.WAIT_BUDGET_S):
    """Fused AG + attention over the n ranks' shards (JAX :220). q: (n, B,
    s_loc, H, D) rank-stacked query rows (rank r's at global rows [r s_loc,
    (r + 1) s_loc)); k / v: (n, B, s_loc, Hkv, D) the ranks' KV shards.
    Returns (n, B, s_loc, H, D). `qmeta` (n, s_loc, 128) int32, each rank's
    rows' GLOBAL (seq_start, seq_end) in lanes 0 / 1, makes the batch a
    packed varlen one (B == 1). Falls back to the ring as JAX does (module
    docstring). `wait_budget` (seconds) bounds each wait of the kernel."""
    cfg = config or SpAgAttnConfig()
    n = num_ranks
    if q.dim() != 5 or q.shape[0] != n or k.shape[0] != n \
            or v.shape != k.shape:
        raise ValueError(f"sp_ag_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         f"rank-stacked (n, B, s_loc, heads, D) over {n} "
                         f"ranks")
    _, B, s_loc, H, D = q.shape
    scale = 1.0 / math.sqrt(D) if scale is None else scale

    bq = min(cfg.block_q, round_up(s_loc, 8))
    bk = min(cfg.block_k, round_up(s_loc, 8))
    nq = s_loc // bq if s_loc % bq == 0 else 0
    supported = B == 1 and nq > 0 and s_loc % bk == 0
    if cfg.force_kernel and not supported:
        raise ValueError(
            f"fused kernel requires B==1 and tile-divisible shard length "
            f"with VMEM-resident state (B={B}, s_loc={s_loc}, bq={bq}, "
            f"bk={bk})")
    use_ring = (cfg.force_ring or not supported
                or (n == 1 and not cfg.force_kernel))
    if use_ring and not cfg.force_kernel:
        reason = ("requested" if cfg.force_ring else
                  "n==1" if n == 1 else
                  "batch" if B != 1 else "vmem_state")
        _common.record_dispatch("sp_ag_attention", "ring", reason)
        if qmeta is not None:
            if B != 1:
                raise ValueError("varlen packs the batch into B == 1 rows")
            meta = pad_sideband(qmeta[:, :s_loc].to(q.device),
                                round_up(s_loc, bq))
            out = ring_attention_varlen_shard(
                q[:, 0], k[:, 0], v[:, 0], meta, num_ranks=n, causal=causal,
                scale=scale, block_q=bq, block_k=bk)
            return out[:, None]
        return ring_attention_shard(q, k, v, num_ranks=n, causal=causal,
                                    scale=scale)
    _common.record_dispatch("sp_ag_attention", "kernel")
    out = _fused(q[:, 0], k[:, 0], v[:, 0], qmeta, causal=causal,
                 scale=scale, wait_budget=wait_budget)
    return out[:, None]


def sp_ag_attention(q, k, v, *, num_ranks: int, causal: bool = True,
                    scale: float | None = None,
                    config: SpAgAttnConfig | None = None, cu_seqlens=None):
    """Host-level fused AG + attention (JAX :320). q: (B, S, H, D), k / v:
    (B, S, Hkv, D), the sequence split into num_ranks contiguous shards.
    Returns (B, S, H, D). With `cu_seqlens` ((num_seqs + 1,) global row
    bounds, B == 1) the rows form a packed varlen batch: attention is
    block-diagonal per sequence, sequences may cross shard boundaries, and
    rows past cu_seqlens[-1] come out zero."""
    n = num_ranks
    qs, ks, vs = shard(q, 1, n), shard(k, 1, n), shard(v, 1, n)
    meta = None
    if cu_seqlens is not None:
        S = q.shape[1]
        if S % n:
            raise ValueError(f"sp_ag_attention: {S} rows do not split over "
                             f"{n} ranks")
        meta = segment_sideband(torch.as_tensor(cu_seqlens).to(q.device),
                                S).view(n, S // n, 128)
    out = sp_ag_attention_shard(qs, ks, vs, num_ranks=n, causal=causal,
                                scale=scale, config=config, qmeta=meta)
    return unshard(out, 1)
