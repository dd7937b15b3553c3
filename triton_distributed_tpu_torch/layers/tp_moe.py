"""Tensor-parallel MoE layer (router + grouped-GEMM pipeline) (counterpart
of triton_distributed_tpu/layers/tp_moe.py).

Every rank holds a slice of every expert's gate_up (columns, each rank's
[gate_i | up_i], `fuse_expert_gate_up`) and down (rows) weights; at one
rank that slice is the whole expert. At n ranks they are rank-stacked
(parallel/mesh.py): w_gate_up (n, E, H, 2I / n), w_down (n, E, I / n, H).
The modes keep the JAX package's two routes:

- "xla" / "fused": sequence-sharded rows (n, m, H); ag_group_gemm ->
  SwiGLU -> moe_reduce_rs ("xla" with plain collectives, "fused" with the
  ring's order);
- "ar" / "gemm_ar": the decode route — replicated rows (M, H), each
  rank's grouped GEMM pipeline over its intermediate slice, then an
  AllReduce (psum) of the ranks' f32 partials.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops import moe_utils
from ..ops.moe_parallel import (MoEParallelConfig, ag_group_gemm_shard,
                                gmm_per_rank, moe_reduce_ar_shard,
                                moe_reduce_rs_shard)
from ..parallel.mesh import RankGroup, shard
from .common import check_mode
from .tp_mlp import silu


def fuse_expert_gate_up(w_gate, w_up, num_ranks: int):
    """Per-expert column-parallel fusion: (E, H, I) x2 -> (E, H, 2I) with
    each rank's column shard = [gate_i | up_i]."""
    e, h, i = w_gate.shape
    n = num_ranks
    i_sh = i // n
    gs = w_gate.reshape(e, h, n, i_sh)
    us = w_up.reshape(e, h, n, i_sh)
    return torch.cat([gs, us], dim=3).reshape(e, h, 2 * i)


class TPMoE(nn.Module):
    """params: {"router": (hidden, E) f32, "w_gate_up": (E, hidden,
    2*moe_inter) fused, "w_down": (E, moe_inter, hidden)} at one rank;
    rank-stacked at n (w_gate_up (n, E, hidden, 2*moe_inter / n), w_down
    (n, E, moe_inter / n, hidden))."""

    def __init__(self, hidden: int, moe_intermediate: int, num_experts: int,
                 top_k: int, *, mode: str = "fused",
                 norm_topk_prob: bool = True,
                 config: MoEParallelConfig | None = None, num_ranks: int = 1):
        super().__init__()
        self.hidden = hidden
        self.moe_intermediate = moe_intermediate
        self.num_experts = num_experts
        self.top_k = top_k
        self.mode = check_mode(mode)
        self.norm_topk_prob = norm_topk_prob
        self.n = RankGroup(num_ranks).n
        if moe_intermediate % self.n:
            raise ValueError(f"moe intermediate {moe_intermediate} does not "
                             f"split into {self.n} ranks")
        self.config = config or MoEParallelConfig()

    # -- parameters --------------------------------------------------------
    def init_params(self, generator: torch.Generator, dtype=torch.bfloat16,
                    device=None):
        e, h, i = self.num_experts, self.hidden, self.moe_intermediate
        s = h ** -0.5

        def normal(shape, scale, dt):
            return torch.randn(shape, generator=generator, dtype=dt,
                               device=device).mul_(scale)

        return self.shard_params(normal((h, e), s, torch.float32),
                                 normal((e, h, i), s, dtype),
                                 normal((e, h, i), s, dtype),
                                 normal((e, i, h), i ** -0.5, dtype))

    def shard_params(self, router, w_gate, w_up, w_down):
        gu = fuse_expert_gate_up(w_gate, w_up, self.n)
        if self.n == 1:
            return {"router": router, "w_gate_up": gu, "w_down": w_down}
        return {"router": router, "w_gate_up": shard(gu, 2, self.n),
                "w_down": shard(w_down, 1, self.n)}

    # -- forward -----------------------------------------------------------
    def forward(self, params, x):
        """x: (M, hidden) tokens: row-sharded over the ranks in "xla" /
        "fused" (rank r holds rows [r * M / n, (r + 1) * M / n)),
        replicated in "ar" / "gemm_ar". Returns (M, hidden)."""
        if self.n > 1 and self.mode in ("xla", "fused"):
            x = x.reshape(self.n, -1, x.shape[-1])
        y = self._shard_fwd(x, params["router"], params["w_gate_up"],
                            params["w_down"], mode=self.mode)
        return y.reshape(-1, self.hidden)

    def _shard_fwd(self, x, router, w_gu, w_dn, *, mode):
        """One rank: x (M, H). n ranks: x (n, m, H) rank-stacked in "xla" /
        "fused" (returns (n, m, H)), (M, H) replicated in "ar" / "gemm_ar"
        (returns (M, H))."""
        n = self.n
        i_sh = self.moe_intermediate // n
        # the router in f32 (TF32 stays off: torch's default for matmul)
        logits = x.reshape(-1, x.shape[-1]).float() @ router
        weights, experts = moe_utils.route_topk(
            logits, self.top_k, renormalize=self.norm_topk_prob)
        cfg = self.config
        if mode in ("xla", "fused"):
            cfg = dataclasses.replace(
                cfg, method="xla" if mode == "xla" else "ring")
            if n > 1:
                weights = weights.reshape(n, -1, self.top_k)
                experts = experts.reshape(n, -1, self.top_k)
            ys, disp = ag_group_gemm_shard(
                x, experts, w_gu, num_ranks=n,
                num_experts=self.num_experts, config=cfg)  # (n, P, 2*i_sh)
            act = silu(ys[..., :i_sh]) * ys[..., i_sh:]
            weights_full = weights[None] if n == 1 else \
                RankGroup(n).all_gather(weights)
            return moe_reduce_rs_shard(act, weights_full, w_dn, disp,
                                       num_ranks=n, config=cfg)
        # decode ("ar" / "gemm_ar"): every rank's grouped GEMM pipeline over
        # its intermediate slice, then an AllReduce of the ranks' f32
        # partials (the identity at one rank)
        disp = moe_utils.sort_tokens_by_expert(
            experts, self.num_experts, cfg.block_m)
        xs = moe_utils.gather_sorted(x, disp)
        h = gmm_per_rank(xs, w_gu, disp, cfg)               # (n, P, 2*i_sh)
        act = silu(h[..., :i_sh]) * h[..., i_sh:]
        return moe_reduce_ar_shard(act, weights[None], w_dn, disp,
                                   num_ranks=n, config=cfg)

    # -- golden ------------------------------------------------------------
    def reference_forward(self, params, x):
        """Dense golden: every token through its top-k experts one by
        one, in f32 sums (one-rank params: the unsharded weights)."""
        logits = x.float() @ params["router"]
        weights, experts = moe_utils.route_topk(
            logits, self.top_k, renormalize=self.norm_topk_prob)
        w_gu, w_dn = params["w_gate_up"], params["w_down"]
        n, i = self.n, self.moe_intermediate
        i_sh = i // n
        out = torch.zeros((x.shape[0], self.hidden), dtype=torch.float32,
                          device=x.device)
        for k in range(self.top_k):
            e = experts[:, k].long()
            h = torch.einsum("mh,mhi->mi", x, w_gu[e])
            # fused layout: shard s columns are [gate_s | up_s]
            hs = h.reshape(h.shape[0], n, 2 * i_sh)
            a = silu(hs[:, :, :i_sh]) * hs[:, :, i_sh:]
            a = a.reshape(h.shape[0], i)
            y = torch.einsum("mi,mih->mh", a, w_dn[e])
            out = out + weights[:, k:k + 1] * y.float()
        return out.to(x.dtype)
