"""Expert-parallel MoE layer: dispatch, grouped expert MLP, combine
(counterpart of triton_distributed_tpu/layers/ep_moe.py).

Experts are range-sharded over n ranks: rank r owns the E / n whole
experts [r * E / n, (r + 1) * E / n). The shard-level forward, every rank
at once on rank-stacked tensors (parallel/mesh.py):

1. top-k routing (moe_utils.route_topk);
2. `ep_dispatch_shard`: the tokens ride the ragged all-to-all
   (csrc/ep_a2a.cu on the GPU) to their experts' ranks;
3. the received rows go through the fused gate_up / down grouped GEMMs
   (ops/grouped_gemm.gmm);
4. `ep_combine_shard`: the outputs ride the inverse all-to-all home and
   the source rank takes the top-k weighted sum.

Two choices differ from the JAX layer and leave every token's result
as it is:

- One `gmm` launch a projection for all ranks. Rank r's local expert e
  is the global expert r * E / n + e, and the rank-stacked expert
  weights (n, E / n, ...) are a view of the global (E, ...) tensor, so
  the n ranks' received rows are sorted by global expert in one plan
  and run in one launch over the global view (JAX: one gmm per rank).
- The sentinel group is padding. JAX sorts the slots past each source's
  count into a sentinel group and runs its tiles on the last expert (of
  zero rows). Here that group lies past every real group and `gmm` gets
  the real groups' sizes only, so the kernel writes its rows as zeros
  without a product: at the ep-engine cell ~12 000 of ~16 000 slots a
  rank are such rows. They are never read at combine either way.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import moe_utils
from ..ops._common import resolve_block_m
from ..ops.ep_a2a import default_capacity
from ..ops.ep_pipeline import (TUNE_LATER, ep_moe_pipeline_shard,
                               resolve_num_chunks)
from ..ops.grouped_gemm import GroupedGemmConfig, gmm
from ..parallel.mesh import RankGroup
from .tp_mlp import silu

AUTO_LATER = ('EPMoE(pipeline="auto") needs perf_model.choose_ep_num_chunks '
              "and the EP estimators of perf_model.py on H100 figures, "
              "which are not ported yet (ROADMAP.md Queue A, slice 6)")


class EPMoE(nn.Module):
    """params: {"router": (hidden, E) f32, "w_gate_up": (n, E / n, hidden,
    2 * intermediate) with each expert's [gate | up] columns, "w_down":
    (n, E / n, intermediate, hidden)}: rank r's experts at [r], a view of
    the global (E, ...) tensors."""

    def __init__(self, num_experts: int, hidden: int, intermediate: int,
                 top_k: int, *, num_ranks: int = 1, method: str = "ragged",
                 capacity: int | None = None, block_m: int | None = None,
                 chunk: int = 128, wire_dtype=None, pipeline: int | str = 1,
                 norm_topk_prob: bool = True,
                 gemm: GroupedGemmConfig = GroupedGemmConfig()):
        super().__init__()
        self.n = RankGroup(num_ranks).n
        if num_experts % self.n:
            raise ValueError(f"{num_experts} experts do not split into "
                             f"{self.n} ranks")
        if method not in ("ragged", "xla"):
            raise ValueError(f"method {method!r}: choose 'ragged' or 'xla'")
        self.num_experts = num_experts
        self.hidden = hidden
        self.intermediate = intermediate
        self.top_k = top_k
        self.method = method
        self.capacity = capacity
        self.chunk = chunk
        self.wire_dtype = wire_dtype
        self.pipeline = pipeline
        self.norm_topk_prob = norm_topk_prob
        self.e_per = num_experts // self.n
        self.block_m, self.gemm = resolve_block_m(block_m, gemm)

    # -- parameters --------------------------------------------------------
    def init_params(self, generator: torch.Generator, dtype=torch.bfloat16,
                    device=None):
        e, h, i = self.num_experts, self.hidden, self.intermediate

        def normal(shape, scale, dt):
            return torch.randn(shape, generator=generator, dtype=dt,
                               device=device).mul_(scale)

        return self.shard_params(normal((h, e), h ** -0.5, torch.float32),
                                 normal((e, h, 2 * i), h ** -0.5, dtype),
                                 normal((e, i, h), i ** -0.5, dtype))

    def shard_params(self, router, w_gate_up, w_down):
        """Global (E, ...) expert tensors -> rank-stacked views (n, E / n,
        ...) (JAX shard_params :93: sharded on the expert dimension)."""
        n, ep = self.n, self.e_per
        return {"router": router,
                "w_gate_up": w_gate_up.unflatten(0, (n, ep)),
                "w_down": w_down.unflatten(0, (n, ep))}

    # -- forward -----------------------------------------------------------
    def forward(self, params, x):
        """x: (M, hidden) tokens row-sharded over the n ranks (rank r holds
        rows [r * M / n, (r + 1) * M / n)). Returns (M, hidden)."""
        if self.pipeline == "tune":
            raise NotImplementedError(TUNE_LATER)
        y = self._shard_fwd(x.reshape(self.n, -1, x.shape[-1]),
                            params["router"], params["w_gate_up"],
                            params["w_down"])
        return y.reshape(x.shape)

    def _route(self, x, router):
        """Top-k routing of rows x (..., H) in f32: (weights, experts),
        each (..., top_k)."""
        rows = x.reshape(-1, x.shape[-1])
        weights, experts = moe_utils.route_topk(
            rows.float() @ router, self.top_k,
            renormalize=self.norm_topk_prob)
        lead = x.shape[:-1]
        return (weights.reshape(*lead, self.top_k),
                experts.reshape(*lead, self.top_k))

    def _shard_fwd(self, x, router, w_gu, w_dn):
        """x: (n, m, H) every rank's sequence-sharded rows. Returns (n, m,
        H)."""
        m_tokens = x.shape[1]
        # the chunk count first: a batch that cannot split runs as one
        # chunk, whose capacity covers the whole batch
        s = resolve_num_chunks(m_tokens, self._num_chunks())
        c = self.capacity or default_capacity(m_tokens // s, self.top_k,
                                              self.chunk)
        weights, experts = self._route(x, router)
        return ep_moe_pipeline_shard(
            x, experts, weights,
            lambda recv, ids: self._expert_mlp(recv, ids, w_gu, w_dn),
            num_ranks=self.n, num_experts=self.num_experts, num_chunks=s,
            capacity=c, method=self.method, chunk=self.chunk,
            wire_dtype=self.wire_dtype)

    def _num_chunks(self) -> int:
        if self.pipeline == "tune":
            raise ValueError(
                'pipeline="tune" resolves on the host-level EPMoE call; '
                'shard-level callers (Qwen3MoE._mlp_rows) take an int')
        if self.pipeline == "auto":
            raise NotImplementedError(AUTO_LATER)
        return int(self.pipeline)

    def _grouped_mlp(self, rows, disp, tile_e, group_sizes, w_gu, w_dn):
        """The SwiGLU expert MLP over expert-sorted rows, against the global
        (E, ...) view of the rank-stacked weights: (P, H)."""
        e, i = self.num_experts, self.intermediate
        w_gu = w_gu.reshape(e, self.hidden, 2 * i)
        w_dn = w_dn.reshape(e, i, self.hidden)
        xs = moe_utils.gather_sorted(rows, disp)
        h = gmm(xs, w_gu, tile_e, config=self.gemm, group_sizes=group_sizes)
        act = silu(h[:, :i]) * h[:, i:]
        return gmm(act, w_dn, tile_e, config=self.gemm,
                   group_sizes=group_sizes)

    def _expert_mlp(self, recv, recv_ids, w_gu, w_dn):
        """Grouped SwiGLU over every rank's received rows. recv: (n, n, C,
        H); recv_ids: (n, n, C) destination-local expert ids (e_per past a
        source's count). Returns (n, n, C, H) in receive-slot order."""
        n, _, c, h = recv.shape
        e = self.num_experts
        ids = recv_ids.reshape(n, n * c)
        live = ids < self.e_per
        # landing rows past a source's count hold an earlier call's data:
        # zero them, so the grouped MLP never reads it
        flat = torch.where(live.reshape(-1, 1), recv.reshape(-1, h),
                           torch.zeros((), dtype=recv.dtype,
                                       device=recv.device))
        ranks = torch.arange(n, device=recv.device)[:, None]
        gid = torch.where(live, ids + ranks * self.e_per, e)   # e: sentinel
        disp = moe_utils.sort_tokens_by_expert(gid.reshape(-1, 1), e + 1,
                                               self.block_m)
        tile_e = disp.tile_expert.clamp_max(e - 1)
        ys = self._grouped_mlp(flat, disp, tile_e, disp.group_sizes[:e],
                               w_gu, w_dn)
        return ys[disp.dest_row.long()].reshape(n, n, c, h)

    def decode_rows_shard(self, x, router, w_gu, w_dn):
        """Replicated rows (M, H), every rank computing its own experts'
        share with no all-to-all, then a psum. All ranks' shares come from
        one grouped MLP over the global expert view (each assignment runs
        on its owner's expert); rank r's partial is the weighted sum of
        the assignments it owns, and the partials are summed in rank order
        in f32 and rounded once, as JAX's psum of per-rank f32 partials.
        Returns (M, H)."""
        weights, experts = self._route(x, router)
        disp = moe_utils.sort_tokens_by_expert(experts, self.num_experts,
                                               self.block_m)
        z = self._grouped_mlp(x, disp, disp.tile_expert, disp.group_sizes,
                              w_gu, w_dn)
        m = x.shape[0]
        per_slot = z[disp.dest_row.long()].reshape(m, self.top_k, -1)
        owner = experts.long() // self.e_per                    # (M, k)
        ranks = torch.arange(self.n, device=x.device)[:, None, None]
        w = torch.where(owner[None] == ranks, weights[None], 0.0)  # (n, M, k)
        parts = (per_slot.float()[None] * w[..., None]).sum(dim=2)
        return RankGroup(self.n).psum(parts).to(x.dtype)

    # -- golden ------------------------------------------------------------
    def reference_forward(self, params, x):
        """Dense golden: every token through its top-k experts, no
        parallelism, in f32 sums. x: (M, hidden)."""
        weights, experts = self._route(x, params["router"])
        e, i = self.num_experts, self.intermediate
        w_gu = params["w_gate_up"].reshape(e, self.hidden, 2 * i)
        w_dn = params["w_down"].reshape(e, i, self.hidden)
        out = torch.zeros((x.shape[0], self.hidden), dtype=torch.float32,
                          device=x.device)
        for k in range(self.top_k):
            ek = experts[:, k].long()
            h = torch.einsum("mh,mhi->mi", x, w_gu[ek])
            a = silu(h[:, :i]) * h[:, i:]
            y = torch.einsum("mi,mih->mh", a, w_dn[ek])
            out = out + weights[:, k:k + 1] * y.float()
        return out.to(x.dtype)
