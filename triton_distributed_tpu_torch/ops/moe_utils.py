"""MoE token routing, sort-by-expert and block alignment (counterpart of
triton_distributed_tpu/ops/moe_utils.py).

Everything is shaped for `grouped_gemm.gmm`: tokens sorted by expert and
padded so that each expert's group starts on a `block_m` boundary;
`tile_expert` maps each row tile of the padded buffer to its expert.

Shapes are static, as in the JAX package: the padded row count P =
`aligned_capacity(M * top_k, E, block_m)` is a host int that depends on
the shapes only. Nothing here synchronises with the host, so a CUDA
decode step routes without waiting on the device: no `.item()`, no
boolean-mask indexing, no `nonzero`, and no `torch.bincount` (on CUDA it
reads its maximum back); counts are a `scatter_add_` into zeros(E).
"""

from __future__ import annotations

import dataclasses

import torch


def route_topk(router_logits, top_k: int, *, renormalize: bool = True):
    """Softmax routing + top-k expert choice: full softmax over the
    experts in f32, then the top_k largest probabilities with ties to
    the lowest expert index (the rule of `jax.lax.top_k`, which the
    megakernel's GROUPED_GEMM replays; `torch.topk` promises no order
    among ties, so this takes a stable descending sort), optionally
    renormalised. Returns (weights (M, top_k) f32, experts (M, top_k)
    int32)."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    weights, experts = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
    weights, experts = weights[:, :top_k], experts[:, :top_k]
    if renormalize:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    return weights, experts.to(torch.int32)


def aligned_capacity(num_assignments: int, num_experts: int,
                     block_m: int) -> int:
    """Static row bound of the block-aligned sorted buffer: every group
    padded up to a block_m multiple (worst case block_m-1 pad rows per
    expert), total rounded to block_m."""
    cap = num_assignments + num_experts * (block_m - 1)
    return (cap + block_m - 1) // block_m * block_m


@dataclasses.dataclass
class MoEDispatch:
    """Index plan for one routed batch (static shapes throughout).

    T = M * top_k token->expert assignments, P = aligned_capacity rows."""
    # (P,) source assignment id per padded sorted row; T for pad rows.
    sorted_assignment: torch.Tensor
    # (P,) source token id per padded sorted row; M (zero pad row) for pad.
    gather_token: torch.Tensor
    # (T,) padded-buffer destination row of assignment j = m*top_k + k.
    dest_row: torch.Tensor
    # (P // block_m,) expert id owning each row tile of the padded buffer.
    tile_expert: torch.Tensor
    # (E,) true tokens per expert.
    group_sizes: torch.Tensor
    top_k: int
    block_m: int


def sort_tokens_by_expert(experts, num_experts: int,
                          block_m: int) -> MoEDispatch:
    """Build the sorted / aligned index plan from (M, top_k) expert
    choices. Rows of the padded buffer are grouped by expert in
    ascending id, each group starts at a block_m-aligned offset, and
    every row tile therefore belongs to exactly one expert. Trailing pad
    tiles resolve to the last expert; their rows are zero."""
    m_tokens, top_k = experts.shape
    t = m_tokens * top_k
    p = aligned_capacity(t, num_experts, block_m)
    dev = experts.device
    i32 = torch.int32
    flat_e = experts.reshape(t).to(torch.int64)

    order = torch.argsort(flat_e, stable=True)          # (T,) assignment ids
    sorted_e = flat_e[order]
    group_sizes = torch.zeros(num_experts, dtype=i32, device=dev).scatter_add_(
        0, flat_e, torch.ones(t, dtype=i32, device=dev))
    group_start = torch.cumsum(group_sizes, 0, dtype=i32) - group_sizes
    aligned_sizes = (group_sizes + block_m - 1) // block_m * block_m
    aligned_start = torch.cumsum(aligned_sizes, 0, dtype=i32) - aligned_sizes

    # aligned destination of sorted position i: its group's aligned start
    # plus its rank within the group
    rank_in_group = torch.arange(t, dtype=i32, device=dev) - group_start[sorted_e]
    dest_of_sorted = (aligned_start[sorted_e] + rank_in_group).to(torch.int64)

    # scatter: padded row -> assignment id (T sentinel on pad rows)
    sorted_assignment = torch.full((p,), t, dtype=i32, device=dev).scatter_(
        0, dest_of_sorted, order.to(i32))
    gather_token = torch.where(sorted_assignment == t, m_tokens,
                               sorted_assignment // top_k).to(i32)

    # assignment j -> padded row (inverse of order o dest)
    dest_row = torch.zeros(t, dtype=i32, device=dev).scatter_(
        0, order, dest_of_sorted.to(i32))

    # tile -> expert: the last group whose aligned start <= the tile's
    # first row; pad tiles past the live region resolve to the last expert
    tile_starts = torch.arange(p // block_m, dtype=i32, device=dev) * block_m
    tile_expert = torch.searchsorted(aligned_start, tile_starts,
                                     right=True, out_int32=True) - 1
    tile_expert = tile_expert.clamp(0, num_experts - 1)

    return MoEDispatch(sorted_assignment=sorted_assignment,
                       gather_token=gather_token, dest_row=dest_row,
                       tile_expert=tile_expert, group_sizes=group_sizes,
                       top_k=top_k, block_m=block_m)


def gather_sorted(x, disp: MoEDispatch):
    """(M, H) tokens -> (P, H) expert-sorted aligned rows (pad rows 0)."""
    x_pad = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    return x_pad[disp.gather_token]


def combine_sorted(y_sorted, disp: MoEDispatch, weights):
    """(P, N) expert outputs + (M, top_k) weights -> (M, N) token
    outputs: the top-k weighted sum, returned in f32 (the JAX function
    rounds it to y's dtype; every caller there first casts y to f32).
    Only the M * top_k live rows are gathered before the cast to f32, so
    all P rows are never copied."""
    m_tokens = weights.shape[0]
    per_slot = y_sorted[disp.dest_row].reshape(m_tokens, disp.top_k,
                                               y_sorted.shape[1])
    w = weights.float()[..., None]
    return (per_slot.float() * w).sum(dim=1)
