"""Ulysses sequence parallelism: the all-to-alls that re-shard attention
between sequence-sharded and head-sharded, fused with the adjacent
projections (counterpart of triton_distributed_tpu/ops/ulysses.py).

The JAX package writes these with XLA collectives only (no Pallas kernel),
so here they are torch ops over the rank dimension (parallel/mesh.py):
rank-stacked operands, n ranks in one process. Both of JAX's methods are
kept:

- "xla": one projection for every peer's head block, then the all-to-all
  (`RankGroup.all_to_all`, a transpose of the first two dimensions);
- "ring": round r projects each rank's rows onto the head block of peer
  (me + r) and moves the chunk with a shift-r collective permute, here a
  roll of the rank dimension by r (rank i's chunk lands on rank i + r); in
  the o direction each rank sums its own block's product first, then those
  of the chunks from sources me - 1, me - 2, ..., in f32, rounded once
  (JAX :108-:123).

The host-level functions take global tensors and `num_ranks` in place of
JAX's mesh and axis.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import RankGroup, shard, unshard

METHODS = ("ring", "xla")


def _check_method(method: str) -> str:
    if method not in METHODS:
        raise ValueError(f"method={method!r}: expected 'ring' or 'xla'")
    return method


def ulysses_qkv_a2a_shard(x, w_qkv, *, num_ranks: int, method: str = "ring"):
    """Fused qkv projection + seq -> head all-to-all (JAX :45). x: (n,
    S_loc, hidden) rank-stacked sequence rows; w_qkv: (hidden, n, C), kept
    once, [:, p, :] the columns of peer p's head block. Returns (n, n *
    S_loc, C): each rank's head block over the FULL sequence, rows in
    source-rank (global) order."""
    n = RankGroup(num_ranks).n
    _check_method(method)
    _, s_loc, _ = x.shape
    if method == "xla" or n == 1:
        qkv = torch.einsum("rsh,hpc->rpsc", x, w_qkv)     # (n, n, S_loc, C)
        got = RankGroup(n).all_to_all(qkv)
        return got.reshape(n, n * s_loc, -1)
    me = torch.arange(n, device=x.device)
    chunks = []
    for r in range(n):
        dst = (me + r) % n
        # mine[i] = rank i's rows projected onto rank (i + r)'s head block
        mine = torch.einsum("rsh,rhc->rsc", x, w_qkv.permute(1, 0, 2)[dst])
        # shift-r permute: rank i's chunk lands on rank i + r, so rank me
        # receives the chunk of source me - r
        chunks.append(mine if r == 0 else torch.roll(mine, r, dims=0))
    stacked = torch.stack(chunks, dim=1)     # (n, round, S_loc, C)
    # round r's chunk came from source me - r: restore source order
    order = (me[:, None] - torch.arange(n, device=x.device)[None]) % n
    got = torch.empty_like(stacked)
    got.scatter_(1, order[:, :, None, None].expand_as(stacked), stacked)
    return got.reshape(n, n * s_loc, -1)


def ulysses_o_a2a_shard(y, w_o, *, num_ranks: int, method: str = "ring"):
    """Fused head -> seq all-to-all + o projection (JAX :86). y: (n, n *
    S_loc, C) each rank's head block of the attention output over the full
    sequence; w_o: (n, C, hidden), kept once, [p] the rows of peer p's head
    block. Returns (n, S_loc, hidden): each rank's sequence rows, summed
    over every head block."""
    n = RankGroup(num_ranks).n
    _check_method(method)
    s_loc = y.shape[1] // n
    ys = y.reshape(n, n, s_loc, -1)                        # by seq owner
    if method == "xla" or n == 1:
        got = RankGroup(n).all_to_all(ys)                  # (n, n, S_loc, C)
        return torch.einsum("rpsc,pch->rsh", got, w_o)
    me = torch.arange(n, device=y.device)
    acc = torch.einsum("rsc,rch->rsh", ys[me, me].float(), w_o.float())
    for r in range(1, n):
        dst = (me + r) % n
        # rank i ships its rows owned by rank i + r; rank me receives those
        # of source me - r, which it multiplies by that source's w_o rows
        buf = torch.roll(ys[me, dst], r, dims=0)
        src = (me - r) % n
        acc = acc + torch.einsum("rsc,rch->rsh", buf.float(),
                                 w_o[src].float())
    return acc.to(y.dtype)


def arrange_qkv_for_ulysses(w_q, w_k, w_v, num_ranks: int):
    """(hidden, Hq*D), (hidden, Hkv*D), (hidden, Hkv*D) -> (hidden, n, C)
    with [:, p, :] = [q_p | k_p | v_p], peer p's head block (JAX :130)."""
    n = num_ranks
    hidden = w_q.shape[0]

    def blocks(w):
        if w.shape[1] % n:
            raise ValueError(f"{w.shape[1]} columns do not split into {n} "
                             f"head blocks")
        return w.reshape(hidden, n, w.shape[1] // n)

    return torch.cat([blocks(w_q), blocks(w_k), blocks(w_v)], dim=2)


def arrange_o_for_ulysses(w_o, num_ranks: int):
    """(Hq*D, hidden) -> (n, C, hidden), [p] = rows of peer p's heads
    (JAX :146)."""
    n = num_ranks
    return w_o.reshape(n, w_o.shape[0] // n, w_o.shape[1])


def ulysses_qkv_a2a(x, w_qkv, *, num_ranks: int, method: str = "ring"):
    """Host-level fused qkv + a2a (JAX :154). x: (S, hidden), its rows
    split over num_ranks; w_qkv: (hidden, n, C). Returns (S, n * C): rank
    p's C columns hold its head block over the full sequence."""
    n = num_ranks
    out = ulysses_qkv_a2a_shard(shard(x, 0, n), w_qkv, num_ranks=n,
                                method=method)          # (n, S, C)
    return unshard(out, 1)


def ulysses_o_a2a(y, w_o, *, num_ranks: int, method: str = "ring"):
    """Host-level fused a2a + o projection (JAX :168). y: (S, n * C), rank
    p's head block in its C columns; w_o: (n, C, hidden). Returns (S,
    hidden)."""
    n = num_ranks
    out = ulysses_o_a2a_shard(shard(y, 1, n), w_o, num_ranks=n,
                              method=method)            # (n, S_loc, hidden)
    return unshard(out, 0)
