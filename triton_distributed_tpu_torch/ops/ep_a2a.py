"""Expert-parallel AllToAll: token dispatch and combine (counterpart of
triton_distributed_tpu/ops/ep_a2a.py).

Experts are range-sharded over n ranks (E / n whole experts a rank). A
rank's tokens go to the ranks owning their top-k experts and come back
for the weighted sum, through a static-capacity layout: every (source,
destination) pair has `capacity` slots, assignments past it are dropped.

- **Plan** (`ep_dispatch_plan`): static-shape index arithmetic as torch
  ops on the device, with the JAX function's stable argsort, sentinels and
  drop rule: no `.item()`, no `nonzero`, no shape that depends on the
  data; counts are a `scatter_add_` into zeros(n), the drops land in an
  (n * C + 1)-slot buffer whose last slot is cut off.
- **Transport**: `method="ragged"` moves only each pair's counted rows
  with csrc/ep_a2a.cu on a CUDA tensor (its plain version on a CPU
  tensor: the same copy of the counted rows, zeros past them);
  `method="xla"` is `RankGroup.all_to_all` of the padded buffer.
- **Combine** is the inverse transport, then the source rank's top-k
  weighted sum.

Everything is rank-stacked (parallel/mesh.py): the `*_shard` functions
take every rank's operands at once, with a leading rank dimension, where
the JAX ones run inside `shard_map` on one rank's. The kernel's output is
its workspace's landing region (shmem.a2a_workspace), as the TPU kernel's
output is the symmetric buffer the peers write: it holds until the next
call with the same `collective_id`, and rows past a source's count hold
what an earlier call left. Dispatch and combine, and each chunk of the
EP pipeline (ops/ep_pipeline.py), use their own ids, as in JAX.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import shmem
from ..parallel.mesh import RankGroup
from ._build import CudaKernel
from .wire import (TORCH_WIRE_DTYPES, resolve_wire_dtype, wire_dequant,
                   wire_quant)

EP_A2A = CudaKernel("ep_a2a", "tdt_ep_a2a", shmem.primitives.A2A_ARGTYPES)

# collective ids of the flat dispatch and combine (JAX
# shmem.collective_id("ep_a2a", 0 / 1)); ops/ep_pipeline.py takes its own
DISPATCH_ID, COMBINE_ID = 0, 1

# scale-field width of the packed wire row, in wire elements (one byte
# each): the f32 scale and 124 bytes of pad (JAX _SCALE_BLOCK)
_SCALE_BLOCK = 128


def default_capacity(m_tokens: int, top_k: int, chunk: int = 128) -> int:
    """Static per-destination slot count: every assignment of every local
    token on one rank, rounded up to the transport chunk."""
    cap = m_tokens * top_k
    return -(-cap // chunk) * chunk


@dataclasses.dataclass
class EPDispatchPlan:
    """Source-rank index plan for one routed batch (static shapes). n =
    num_ranks, C = capacity, T = m_tokens * top_k assignments. A plan of
    rank-stacked choices carries the leading rank dimension on every
    tensor."""
    # (n*C,) local token id feeding each send slot; m_tokens on pad slots.
    send_gather: torch.Tensor
    # (n*C,) destination-local expert id per send slot; e_per on pads.
    send_local_expert: torch.Tensor
    # (T,) flat send slot of assignment j = t*top_k + k; n*C if dropped.
    slot_of_assignment: torch.Tensor
    # (n,) assignments per destination rank, at most C.
    counts: torch.Tensor
    capacity: int
    top_k: int


def ep_dispatch_plan(experts, num_experts: int, num_ranks: int,
                     capacity: int) -> EPDispatchPlan:
    """The send layout from (..., m_tokens, top_k) global expert choices
    (any leading dimensions, e.g. the rank's). Assignments past
    `capacity` for a destination are dropped, the earliest kept."""
    *lead, m_tokens, top_k = experts.shape
    t = m_tokens * top_k
    n, c = num_ranks, capacity
    e_per = num_experts // n
    dev = experts.device
    flat_e = experts.reshape(*lead, t).long()
    dst = flat_e // e_per                                    # dest rank

    order = torch.argsort(dst, dim=-1, stable=True)          # assignment ids
    sorted_dst = dst.gather(-1, order)
    counts = torch.zeros((*lead, n), dtype=torch.long, device=dev)
    counts.scatter_add_(-1, dst, torch.ones_like(dst))
    start = torch.cumsum(counts, -1) - counts                # exclusive
    rank_in_dst = (torch.arange(t, device=dev)
                   - start.gather(-1, sorted_dst))
    slot_of_sorted = torch.where(rank_in_dst < c,
                                 sorted_dst * c + rank_in_dst, n * c)

    def scatter(fill, values):
        """values into an (n*C + 1)-slot buffer at slot_of_sorted; the last
        slot takes the drops and is cut off (JAX .at[].set(mode="drop"))."""
        buf = torch.full((*lead, n * c + 1), fill, dtype=torch.long,
                         device=dev)
        return buf.scatter_(-1, slot_of_sorted, values)[..., :n * c]

    send_gather = scatter(m_tokens, order // top_k)
    send_local_expert = scatter(e_per, flat_e.gather(-1, order) % e_per)
    slot_of_assignment = torch.full((*lead, t), n * c, dtype=torch.long,
                                    device=dev).scatter_(-1, order,
                                                         slot_of_sorted)
    i32 = torch.int32
    return EPDispatchPlan(send_gather=send_gather.to(i32),
                          send_local_expert=send_local_expert.to(i32),
                          slot_of_assignment=slot_of_assignment.to(i32),
                          counts=counts.clamp_max(c).to(i32),
                          capacity=c, top_k=top_k)


# ---------------------------------------------------------------------------
# The ragged transport
# ---------------------------------------------------------------------------

def _ragged_a2a_plain(x, send_counts):
    """Plain version of the kernel: out[d, s, i] = x[s, d, i] for i <
    send_counts[s, d], zeros past the count. x (n, n, C, ...) of any
    dtype; send_counts (n, n)."""
    moved = x.transpose(0, 1)                                # (d, s, C, ...)
    live = (torch.arange(x.shape[2], device=x.device)
            < send_counts.t()[..., None].to(x.device))       # (d, s, C)
    live = live.reshape(*live.shape, *([1] * (x.dim() - 3)))
    return torch.where(live, moved, torch.zeros((), dtype=x.dtype,
                                                device=x.device))


def _ragged_a2a(x, send_counts, *, num_ranks: int, chunk: int,
                collective_id: int = DISPATCH_ID,
                wait_budget: float = shmem.WAIT_BUDGET_S):
    """x: (n, n, C, ...) rank-stacked padded send buffers (rank s's slab d
    bound for rank d); send_counts (n, n) int32 rows each pair really
    sends. Returns (n, n, C, ...): rank d's slab s the rows from rank s;
    rows past a source's count are undefined. The TPU kernel also takes
    the receive counts, for its DMA waits; this kernel's receivers wait
    for one notification a source instead. On a CUDA tensor the kernel
    runs (or raises); on a CPU tensor its plain version."""
    n = num_ranks
    if x.dim() < 3 or x.shape[0] != n or x.shape[1] != n:
        raise ValueError(f"_ragged_a2a: x {tuple(x.shape)} is not (n, n, C, "
                         f"...) with n = {n}")
    c = x.shape[2]
    if c % chunk:
        raise ValueError(f"_ragged_a2a: capacity {c} is not a multiple of "
                         f"chunk {chunk}")
    if x.device.type == "cpu":
        return _ragged_a2a_plain(x, send_counts)
    if x.device.type != "cuda":
        raise ValueError(f"_ragged_a2a: no kernel for device {x.device}")
    if send_counts.device != x.device or send_counts.dtype != torch.int32 \
            or tuple(send_counts.shape) != (n, n):
        raise ValueError(f"_ragged_a2a: send_counts must be an ({n}, {n}) "
                         f"int32 tensor on {x.device}")
    xb = x.contiguous().view(torch.uint8).reshape(n, n, c, -1)
    row_bytes = xb.shape[-1]
    if row_bytes % 16 or xb.data_ptr() % 16:
        raise ValueError(f"_ragged_a2a: the kernel moves 16-byte aligned "
                         f"rows; a row here is {row_bytes} bytes")
    ws = shmem.a2a_workspace(f"ep_a2a[{collective_id}]", x.device, n, c,
                             row_bytes)
    shmem.launch_a2a(EP_A2A, ws, xb, send_counts.contiguous(), chunk,
                     budget_s=wait_budget)
    return ws.land.view(x.dtype).reshape(x.shape)


def _transport(buf, send_counts, *, num_ranks: int, method: str,
               chunk: int, collective_id: int = DISPATCH_ID):
    """buf (n, n, C, ...) through the chosen transport: "xla" (or one
    rank) the padded buffer as a whole (RankGroup.all_to_all), "ragged"
    the counted rows (csrc/ep_a2a.cu)."""
    n = num_ranks
    if method == "xla" or n == 1:
        return RankGroup(n).all_to_all(buf)
    if method != "ragged":
        raise ValueError(f"EP transport {method!r}: choose 'ragged' or 'xla'")
    return _ragged_a2a(buf, send_counts, num_ranks=n, chunk=chunk,
                       collective_id=collective_id)


# ---------------------------------------------------------------------------
# The quantized wire: one f32 scale a row, packed into the same row on the
# ragged transport (bytes [H, H + 4) of an (H + 128)-byte row), moved beside
# it by a second all_to_all on the "xla" transport
# ---------------------------------------------------------------------------

def _byte_view(t):
    return t.contiguous().view(torch.uint8)


def _pack_scale(q, scale):
    """(..., H) wire payload and (...,) f32 scales -> (..., H + 128) bytes:
    the payload's bytes, then the scale's 4 bytes and 124 zero bytes."""
    sb = _byte_view(scale.float()[..., None])                # (..., 4)
    pad = torch.zeros((*sb.shape[:-1], _SCALE_BLOCK - 4), dtype=torch.uint8,
                      device=q.device)
    return torch.cat([_byte_view(q), sb, pad], dim=-1)


def _unpack_scale(recv, h: int, wire_dtype: str):
    """Inverse of _pack_scale: (payload (..., h) in the wire dtype, scale
    (...,) f32)."""
    q = recv[..., :h].contiguous().view(TORCH_WIRE_DTYPES[wire_dtype])
    scale = recv[..., h:h + 4].contiguous().view(torch.float32)[..., 0]
    return q, scale


def _transport_quant(buf, send_counts, *, num_ranks: int, method: str,
                     chunk: int, collective_id: int, wire_dtype=None):
    """_transport with an optional quantized wire: the payload crosses in
    `wire_dtype` ("int8" / "float8_e4m3fn", one byte an element) and lands
    back in buf's dtype."""
    kw = dict(num_ranks=num_ranks, method=method, chunk=chunk,
              collective_id=collective_id)
    if wire_dtype is None:
        return _transport(buf, send_counts, **kw)
    name = resolve_wire_dtype(wire_dtype)
    q, scale = wire_quant(buf, name)
    h = q.shape[-1]
    if method == "xla" or num_ranks == 1:
        recv_q = _transport(_byte_view(q), send_counts, **kw)
        recv_scale = RankGroup(num_ranks).all_to_all(scale)
        return wire_dequant(recv_q.view(TORCH_WIRE_DTYPES[name]), recv_scale,
                            buf.dtype)
    recv = _transport(_pack_scale(q, scale), send_counts, **kw)
    recv_q, recv_scale = _unpack_scale(recv, h, name)
    return wire_dequant(recv_q, recv_scale, buf.dtype)


# ---------------------------------------------------------------------------
# Dispatch / combine, every rank at once
# ---------------------------------------------------------------------------

def _per_rank_rows(t, idx):
    """t (n, R, ...) gathered per rank at idx (n, K) -> (n, K, ...)."""
    return t[torch.arange(t.shape[0], device=t.device)[:, None],
             idx.long()]


def ep_dispatch_shard(x, experts, *, num_ranks: int, num_experts: int,
                      capacity: int | None = None, method: str = "ragged",
                      chunk: int = 128, collective_id: int = DISPATCH_ID,
                      wire_dtype=None):
    """Dispatch every rank's tokens to their experts' ranks.

    x: (n, m_tokens, H) rank-stacked tokens; experts: (n, m_tokens, top_k)
    global expert ids. Returns (recv (n, n, C, H): rank d's slab s the rows
    from rank s; recv_ids (n, n, C) int32 destination-local expert ids,
    e_per on slots past the count; recv_counts (n, n): rank d's rows from
    each source; plan, rank-stacked)."""
    n = num_ranks
    _, m_tokens, top_k = experts.shape
    c = capacity or default_capacity(m_tokens, top_k, chunk)
    if c % chunk:
        raise ValueError(f"capacity {c} is not a multiple of chunk {chunk}")
    plan = ep_dispatch_plan(experts, num_experts, n, c)
    group = RankGroup(n)
    # the counts exchange: every rank learns the (n, n) traffic matrix
    counts_mat = group.all_gather(plan.counts)               # (src, dst)
    recv_counts = counts_mat.t().contiguous()                # (me, src)

    # pack the payload into the (n, C) slot layout; pad slots read a zero row
    x_pad = torch.cat([x, x.new_zeros((n, 1, x.shape[-1]))], dim=1)
    send_buf = _per_rank_rows(x_pad, plan.send_gather).reshape(n, n, c, -1)
    recv = _transport_quant(send_buf, plan.counts, num_ranks=n,
                            method=method, chunk=chunk,
                            collective_id=collective_id,
                            wire_dtype=wire_dtype)
    recv_ids = group.all_to_all(plan.send_local_expert.reshape(n, n, c))
    slot = torch.arange(c, device=x.device)
    recv_ids = torch.where(slot < recv_counts[..., None], recv_ids,
                           num_experts // n)
    return recv, recv_ids.to(torch.int32), recv_counts, plan


def ep_combine_shard(y, plan: EPDispatchPlan, weights, recv_counts, *,
                     num_ranks: int, method: str = "ragged", chunk: int = 128,
                     collective_id: int = COMBINE_ID, wire_dtype=None):
    """Return expert outputs to their tokens' ranks and take the top-k
    weighted sum. y: (n, n, C, H) outputs in receive-slot order; weights:
    (n, m_tokens, top_k). Returns (n, m_tokens, H) in y's dtype (the sum in
    f32, rounded once; dropped assignments add zero)."""
    n = num_ranks
    _, m_tokens, top_k = weights.shape
    c = plan.capacity
    # the reverse traffic: rank d sends recv_counts[d, s] rows back to s
    ret = _transport_quant(y, recv_counts, num_ranks=n, method=method,
                           chunk=chunk, collective_id=collective_id,
                           wire_dtype=wire_dtype)
    ret = ret.reshape(n, n * c, -1)
    ret_pad = torch.cat([ret, ret.new_zeros((n, 1, ret.shape[-1]))], dim=1)
    per_slot = _per_rank_rows(ret_pad, plan.slot_of_assignment).reshape(
        n, m_tokens, top_k, -1)
    w = weights.float()[..., None]
    return (per_slot.float() * w).sum(dim=2).to(y.dtype)


# ---------------------------------------------------------------------------
# Host-level entry points: global row-sharded tensors
# ---------------------------------------------------------------------------

def ep_dispatch(x, experts, *, num_ranks: int, num_experts: int,
                capacity: int | None = None, method: str = "ragged",
                chunk: int = 128, wire_dtype=None):
    """Host-level dispatch. x: (M, H) tokens and experts (M, top_k), both
    row-sharded over n ranks (rank r holds rows [r*M/n, (r+1)*M/n)).
    Returns ep_dispatch_shard's (recv, recv_ids, recv_counts, plan), each
    with its leading rank dimension (JAX ep_dispatch :411)."""
    n = num_ranks
    return ep_dispatch_shard(x.reshape(n, -1, x.shape[-1]),
                             experts.reshape(n, -1, experts.shape[-1]),
                             num_ranks=n, num_experts=num_experts,
                             capacity=capacity, method=method, chunk=chunk,
                             wire_dtype=wire_dtype)


def ep_combine(y, plan, weights, recv_counts, *, num_ranks: int,
               method: str = "ragged", chunk: int = 128, wire_dtype=None):
    """Host-level combine, the inverse of `ep_dispatch`: (M, H) row-sharded
    outputs (JAX ep_combine :437)."""
    n = num_ranks
    out = ep_combine_shard(y, plan, weights.reshape(n, -1, weights.shape[-1]),
                           recv_counts, num_ranks=n, method=method,
                           chunk=chunk, wire_dtype=wire_dtype)
    return out.reshape(-1, out.shape[-1])
