"""Tensor-parallel MoE ops: AG + grouped GEMM and grouped GEMM + RS / AR,
at one rank (counterpart of triton_distributed_tpu/ops/moe_parallel.py).

Tokens stay in block-aligned expert-sorted order between the two grouped
GEMMs; `MoEDispatch` plans (one per source shard) carry the index maps,
and the top-k weighted combine happens inside the reduce op. At one rank
the all-gathers, psums and psum_scatters of the JAX functions are
identities, so each function here is its n = 1 form; `num_ranks > 1`
raises (the multi-rank layer is slice 6).
"""

from __future__ import annotations

import dataclasses

import torch

from ..layers.common import check_one_rank
from . import moe_utils
from ._common import resolve_block_m
from .grouped_gemm import GroupedGemmConfig, gmm


@dataclasses.dataclass(frozen=True)
class MoEParallelConfig:
    # row-tile size; None adopts gemm.block_m, an int overrides it
    block_m: int | None = None
    gemm: GroupedGemmConfig = GroupedGemmConfig()
    # "ring": the JAX package's ppermute pipeline; "xla": plain
    # collectives around the grouped GEMM. One route at one rank.
    method: str = "ring"

    def __post_init__(self):
        bm, gemm = resolve_block_m(self.block_m, self.gemm)
        object.__setattr__(self, "block_m", bm)
        object.__setattr__(self, "gemm", gemm)


def plan_shards(experts_full, num_experts: int, block_m: int):
    """Per-source-shard dispatch plans from (n, m_per, top_k) choices,
    stacked on a leading shard dimension."""
    plans = [moe_utils.sort_tokens_by_expert(e, num_experts, block_m)
             for e in experts_full]
    return dataclasses.replace(
        plans[0], **{f: torch.stack([getattr(p, f) for p in plans])
                     for f in ("sorted_assignment", "gather_token",
                               "dest_row", "tile_expert", "group_sizes")})


def _shard_gemm(x_shard, w, plans, sid, cfg):
    disp = moe_utils.dispatch_at(plans, sid)
    xs = moe_utils.gather_sorted(x_shard, disp)              # (P, H)
    return gmm(xs, w, disp.tile_expert, config=cfg.gemm,
               group_sizes=disp.group_sizes)


def ag_group_gemm_shard(x, experts, w, *, num_ranks: int, num_experts: int,
                        config: MoEParallelConfig | None = None):
    """All-gather tokens + per-shard grouped GEMM (MoE layer 0).

    x: (m_per, H) local tokens. experts: (m_per, top_k) local expert
    choices. w: (E, H, N_shard) per-expert weights. Returns (ys (n, P,
    N_shard) sorted-layout outputs, plans (stacked MoEDispatch))."""
    cfg = config or MoEParallelConfig()
    n = check_one_rank(num_ranks)
    experts_full = experts[None]                 # all_gather at one rank
    plans = plan_shards(experts_full, num_experts, cfg.block_m)
    x_full = x[None]
    ys = torch.stack([_shard_gemm(x_full[s], w, plans, s, cfg)
                      for s in range(n)])
    return ys, plans


def _shard_down_proj(ys, weights_full, w2, plans, cfg, sid):
    """Down-proj grouped GEMM + top-k weighted combine for source shard
    `sid` (shared body of the RS and AR reductions). Returns (m_per, H)
    f32 partial sums."""
    disp = moe_utils.dispatch_at(plans, sid)
    zs = gmm(ys[sid], w2, disp.tile_expert, config=cfg.gemm,
             group_sizes=disp.group_sizes)                   # (P, H)
    return moe_utils.combine_sorted(zs, disp, weights_full[sid])


def moe_reduce_rs_shard(ys, weights_full, w2, plans, *, num_ranks: int,
                        config: MoEParallelConfig | None = None):
    """Grouped GEMM + top-k weighted combine + ReduceScatter (MoE layer
    1). ys: (n, P, N_shard) activations; weights_full: (n, m_per, top_k);
    w2: (E, N_shard, H). Returns (m_per, H) in ys's dtype."""
    cfg = config or MoEParallelConfig()
    n = check_one_rank(num_ranks)
    outs = torch.stack([_shard_down_proj(ys, weights_full, w2, plans, cfg, s)
                        for s in range(n)])
    return outs[0].to(ys.dtype)                  # psum_scatter at one rank


def moe_reduce_ar_shard(ys, weights_full, w2, plans, *, num_ranks: int,
                        config: MoEParallelConfig | None = None):
    """Grouped GEMM + weighted combine + AllReduce (decode MoE). Returns
    (n * m_per, H) in ys's dtype."""
    cfg = config or MoEParallelConfig()
    n = check_one_rank(num_ranks)
    outs = torch.stack([_shard_down_proj(ys, weights_full, w2, plans, cfg, s)
                        for s in range(n)])
    return outs.reshape(-1, outs.shape[-1]).to(ys.dtype)   # psum at one rank
