"""Tensor-parallel MoE ops: AG + grouped GEMM and grouped GEMM + RS / AR
(counterpart of triton_distributed_tpu/ops/moe_parallel.py).

Tokens stay in block-aligned expert-sorted order between the two grouped
GEMMs; a `MoEDispatch` plan carries the index maps, and the top-k
weighted combine happens inside the reduce op. Every rank holds a column
(gate_up) or row (down) slice of every expert. At n ranks the operands
are rank-stacked (parallel/mesh.py) and the collectives are the rank
group's: `ag_group_gemm_shard` all-gathers the sequence-sharded tokens
(`all_gather` in both methods: the JAX ring's n - 1 `ppermute` hops only
overlap transfers with GEMMs, and deliver the same rows), and the
reductions end in `psum_scatter` ("xla"), the JAX ring's running sum over
`ppermute` hops ("ring", its order of partial sums) or `psum`.

One difference from the JAX ops: the gathered tokens are sorted into one
plan, where JAX sorts each source shard's tokens on its own and runs a
grouped GEMM per shard. Every rank's grouped GEMM is then one launch over
all the gathered rows against its own weight slice (n launches a
projection, one a rank); each token's rows and products are the same.
"""

from __future__ import annotations

import dataclasses

import torch

from ..parallel.mesh import RankGroup
from . import moe_utils
from ._common import resolve_block_m
from .grouped_gemm import GroupedGemmConfig, gmm


@dataclasses.dataclass(frozen=True)
class MoEParallelConfig:
    # row-tile size; None adopts gemm.block_m, an int overrides it
    block_m: int | None = None
    gemm: GroupedGemmConfig = GroupedGemmConfig()
    # "ring": the JAX package's ppermute reduce-scatter order; "xla":
    # plain collectives around the grouped GEMM
    method: str = "ring"

    def __post_init__(self):
        bm, gemm = resolve_block_m(self.block_m, self.gemm)
        object.__setattr__(self, "block_m", bm)
        object.__setattr__(self, "gemm", gemm)


def gmm_per_rank(xs, w, disp, cfg: MoEParallelConfig):
    """Every rank's grouped GEMM over one plan's rows: xs (P, K) shared by
    the ranks or (n, P, K) their own; w (n, E, K, N) their weight slices
    (one rank's (E, K, N) at one rank). One launch a rank. Returns (n, P,
    N)."""
    if w.dim() == 3:
        w = w[None]
    return torch.stack([
        gmm(xs if xs.dim() == 2 else xs[r], w[r], disp.tile_expert,
            config=cfg.gemm, group_sizes=disp.group_sizes)
        for r in range(w.shape[0])])


def ag_group_gemm_shard(x, experts, w, *, num_ranks: int, num_experts: int,
                        config: MoEParallelConfig | None = None):
    """All-gather tokens + grouped GEMM (MoE layer 0).

    x: (n, m_per, H) rank-stacked tokens; experts: (n, m_per, top_k); w:
    (n, E, H, N_shard) each rank's column slice (at one rank also (m_per,
    H), (m_per, top_k) and (E, H, N)). Returns (ys (n, P, N_shard): rank
    r's sorted-layout outputs over all n * m_per gathered tokens, plan:
    the one MoEDispatch of those tokens, in source-shard order)."""
    cfg = config or MoEParallelConfig()
    n = num_ranks
    if x.dim() == 2:
        x, experts = x[None], experts[None]
    group = RankGroup(n)
    # routing metadata is tiny: always a plain all_gather
    experts_full = group.all_gather(experts, axis=0, tiled=True)
    x_full = group.all_gather(x, axis=0, tiled=True)         # (n*m_per, H)
    disp = moe_utils.sort_tokens_by_expert(experts_full, num_experts,
                                           cfg.block_m)
    xs = moe_utils.gather_sorted(x_full, disp)               # (P, H)
    return gmm_per_rank(xs, w, disp, cfg), disp


def _down_partials(ys, weights_full, w2, disp, cfg):
    """Down-proj grouped GEMM + top-k weighted combine, every rank over
    every gathered token: (n, n * m_per, H) f32 partial sums over each
    rank's intermediate slice."""
    zs = gmm_per_rank(ys, w2, disp, cfg)                     # (n, P, H)
    weights = weights_full.reshape(-1, weights_full.shape[-1])
    return torch.stack([moe_utils.combine_sorted(z, disp, weights)
                        for z in zs])


def moe_reduce_rs_shard(ys, weights_full, w2, disp, *, num_ranks: int,
                        config: MoEParallelConfig | None = None):
    """Grouped GEMM + top-k weighted combine + ReduceScatter (MoE layer
    1). ys: (n, P, N_shard) activations of `ag_group_gemm_shard`'s plan;
    weights_full: (n, m_per, top_k) every source shard's routing weights;
    w2: (n, E, N_shard, H). Returns (n, m_per, H): rank r's token rows,
    reduced over the ranks' partials in f32 and rounded once to ys's
    dtype ("xla": in rank order; "ring": from rank r + 1 around to r, the
    order the JAX ring's running sum takes). At one rank (m_per, H)."""
    cfg = config or MoEParallelConfig()
    n = num_ranks
    parts = _down_partials(ys, weights_full, w2, disp, cfg)
    parts = parts.reshape(n, n, -1, parts.shape[-1])   # (rank, shard, m, H)
    if n == 1:
        return parts[0, 0].to(ys.dtype)
    group = RankGroup(n)
    if cfg.method == "xla":
        return group.psum_scatter(parts.flatten(1, 2), tiled=True) \
            .reshape(n, -1, parts.shape[-1]).to(ys.dtype)
    # the ring: at step r rank q adds its partial of shard q - 1 - r to the
    # running sum that hopped in from rank q - 1; each sum ends at home
    me = torch.arange(n, device=parts.device)
    acc = parts[me, (me - 1) % n]
    for r in range(1, n):
        acc = group.ppermute_ring(acc) + parts[me, (me - 1 - r) % n]
    return acc.to(ys.dtype)


def moe_reduce_ar_shard(ys, weights_full, w2, disp, *, num_ranks: int,
                        config: MoEParallelConfig | None = None):
    """Grouped GEMM + weighted combine + AllReduce (decode MoE; always
    `psum`, as JAX). Returns (n * m_per, H) replicated in ys's dtype."""
    cfg = config or MoEParallelConfig()
    parts = _down_partials(ys, weights_full, w2, disp, cfg)
    return RankGroup(num_ranks).psum(parts).to(ys.dtype)
