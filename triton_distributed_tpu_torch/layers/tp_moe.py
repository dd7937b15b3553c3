"""Tensor-parallel MoE layer (router + grouped-GEMM pipeline) at one
rank (counterpart of triton_distributed_tpu/layers/tp_moe.py).

Every rank would hold a slice of every expert's gate_up / down weights;
at one rank that slice is the whole expert. The modes keep the JAX
package's two routes, which compute the same thing at one rank:

- "xla" / "fused": ag_group_gemm -> SwiGLU -> moe_reduce_rs;
- "ar" / "gemm_ar": the decode route — one local grouped GEMM pipeline
  over the intermediate shard and an AllReduce combine.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops import moe_utils
from ..ops.grouped_gemm import gmm
from ..ops.moe_parallel import (MoEParallelConfig, ag_group_gemm_shard,
                                moe_reduce_rs_shard)
from .common import check_mode, check_one_rank
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
    2*moe_inter) fused, "w_down": (E, moe_inter, hidden)}."""

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
        self.n = check_one_rank(num_ranks)
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
        return {"router": router,
                "w_gate_up": fuse_expert_gate_up(w_gate, w_up, self.n),
                "w_down": w_down}

    # -- forward -----------------------------------------------------------
    def forward(self, params, x):
        """x: (M, hidden) tokens. Returns (M, hidden)."""
        return self._shard_fwd(x, params["router"], params["w_gate_up"],
                               params["w_down"], mode=self.mode)

    def _shard_fwd(self, x, router, w_gu, w_dn, *, mode):
        n = self.n
        i_sh = self.moe_intermediate // n
        # the router in f32 (TF32 stays off: torch's default for matmul)
        logits = x.float() @ router
        weights, experts = moe_utils.route_topk(
            logits, self.top_k, renormalize=self.norm_topk_prob)
        cfg = self.config
        if mode in ("xla", "fused"):
            cfg = dataclasses.replace(
                cfg, method="xla" if mode == "xla" else "ring")
            ys, plans = ag_group_gemm_shard(
                x, experts, w_gu, num_ranks=n,
                num_experts=self.num_experts, config=cfg)  # (n, P, 2*i_sh)
            act = silu(ys[..., :i_sh]) * ys[..., i_sh:]
            return moe_reduce_rs_shard(act, weights[None], w_dn, plans,
                                       num_ranks=n, config=cfg)
        # decode ("ar" / "gemm_ar"): one local grouped GEMM pipeline over
        # the intermediate shard + AllReduce combine (identity at one rank)
        disp = moe_utils.sort_tokens_by_expert(
            experts, self.num_experts, cfg.block_m)
        xs = moe_utils.gather_sorted(x, disp)
        h = gmm(xs, w_gu, disp.tile_expert, config=cfg.gemm,
                group_sizes=disp.group_sizes)
        act = silu(h[:, :i_sh]) * h[:, i_sh:]
        z = gmm(act, w_dn, disp.tile_expert, config=cfg.gemm,
                group_sizes=disp.group_sizes)
        out = moe_utils.combine_sorted(z, disp, weights)
        return out.to(x.dtype)

    # -- golden ------------------------------------------------------------
    def reference_forward(self, params, x):
        """Dense golden: every token through its top-k experts one by
        one, in f32 sums."""
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
