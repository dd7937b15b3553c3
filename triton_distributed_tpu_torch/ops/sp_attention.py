"""Sequence-parallel attention: ring-attention prefill and distributed
split-KV flash decode (counterpart of
triton_distributed_tpu/ops/sp_attention.py, its `ring_attention_shard`,
`sp_flash_decode_shard` and `sp_flash_decode_paged_shard`).

Everything is rank-stacked (parallel/mesh.py): the n ranks' shards carry
a leading rank dimension and run in one process on one device, each
function taking every rank's operands at once where the JAX one runs
inside `shard_map` on one rank's. A replicated value (the decode queries,
the combined output) is kept once.

- **Ring attention** keeps JAX's hop order: in round r rank me attends
  its query rows to the KV shard that started on rank (me - r) mod n and
  folds the (out, lse) partial into a running f32 accumulator with
  `merge_two_partials`. One `flash_attention_partial` launch a round
  runs every rank's shard at once. Under the causal mask a round-r shard
  is wholly in the past of ranks r .. n-1 (the query and key offsets
  differ by r shards) and wholly in the future of ranks 0 .. r-1, whose
  partial is all masked: lse -1e30, merge weight exactly 0, so those
  ranks are left out of the launch and their accumulators keep their
  bits, as the merge with that partial would.
- **Decode** runs every rank's split-KV partial in one launch over the n
  ranks' B queries (n * B sequences), then combines the (out, lse)
  partials: "xla" gathers them (`RankGroup.all_gather`) and merges with
  `combine_partials`; "ll" runs the one-shot kernel
  (ops/ll_gather.ll_combine_shard).
"""

from __future__ import annotations

import torch

from ..parallel.mesh import RankGroup
from .attention import (combine_partials, flash_attention_partial,
                        flash_decode_paged_partial, flash_decode_partial,
                        merge_two_partials)
from .ll_gather import ll_combine_shard

COMBINES = ("xla", "ll")


def _check_combine(combine: str) -> str:
    if combine not in COMBINES:
        raise ValueError(f"combine={combine!r}: expected 'xla' or 'll'")
    return combine


def ring_attention_shard(q, k, v, *, num_ranks: int, causal: bool = True,
                         scale: float | None = None,
                         return_lse: bool = False):
    """Ring attention over a sequence-sharded batch. q: (n, B, S_loc, H,
    D), rank r's query rows at global rows [r S_loc, (r + 1) S_loc); k / v:
    (n, B, S_loc, Hkv, D) the ranks' KV shards. Returns (n, B, S_loc, H,
    D) in q's dtype, or with `return_lse` the (out f32, lse (n, B, S_loc,
    H)) partial pair, so the result can keep merging against more KV."""
    n = num_ranks
    if q.shape[0] != n or k.shape[0] != n or v.shape != k.shape:
        raise ValueError(f"ring_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         f"rank-stacked over {n} ranks")
    _, B, s_loc, H, D = q.shape
    acc = lse = None
    for r in range(n):
        # round r: rank me holds the shard of rank me - r; under the causal
        # mask only ranks r .. n - 1 see any of it (and see it offset by r
        # shards), so they alone run, with q_offset - kv_offset = r S_loc
        lo = r if causal else 0
        src = (torch.arange(lo, n) - r) % n
        qs = q[lo:].reshape((n - lo) * B, s_loc, H, D)
        ks, vs = (t[src].reshape((n - lo) * B, s_loc, *t.shape[3:])
                  for t in (k, v))
        o, l = flash_attention_partial(
            qs, ks, vs, q_offset=r * s_loc if causal else 0, kv_offset=0,
            causal=causal, scale=scale)
        o = o.view(n - lo, B, s_loc, H, D)
        l = l.view(n - lo, B, s_loc, H)
        if acc is None:
            acc, lse = o.float(), l
        else:
            acc[lo:], lse[lo:] = merge_two_partials(acc[lo:], lse[lo:], o, l)
    if return_lse:
        return acc, lse
    return acc.to(q.dtype)


def _combine(out, lse, n: int, combine: str):
    """(n, B, H, D) / (n, B, H) rank partials -> the replicated (B, H, D)."""
    if combine == "ll":
        return ll_combine_shard(out, lse, num_ranks=n)
    group = RankGroup(n)
    return combine_partials(group.all_gather(out), group.all_gather(lse))


def sp_flash_decode_shard(q, k_shard, v_shard, kv_len_local, *,
                          num_ranks: int, scale: float | None = None,
                          combine: str = "xla"):
    """One decode step against a sequence-sharded contiguous KV cache. q:
    (B, H, D) replicated single-position queries; k_shard / v_shard: (n,
    B, Skv_loc, Hkv, D) the ranks' cache shards, of which the first
    kv_len_local[r, b] positions are valid (n, B) (0 on a rank past the
    frontier: its partial combines at zero weight). Returns (B, H, D),
    replicated."""
    n = num_ranks
    _check_combine(combine)
    B, H, D = q.shape
    qn = q.expand(n, B, H, D).reshape(n * B, H, D)
    out, lse = flash_decode_partial(
        qn, k_shard.reshape(n * B, *k_shard.shape[2:]),
        v_shard.reshape(n * B, *v_shard.shape[2:]),
        kv_len_local.reshape(n * B), scale=scale)
    return _combine(out.view(n, B, H, D), lse.view(n, B, H), n, combine)


def sp_flash_decode_paged_shard(q, k_pool, v_pool, block_table,
                                kv_len_local, *, num_ranks: int,
                                scale: float | None = None,
                                combine: str = "xla"):
    """One decode step against a sequence-sharded PAGED cache. q: (B, H,
    D) replicated; k_pool / v_pool: (nb, Hkv, block, D) ONE layer's pool,
    the n ranks' partitions one after another (rank r's pages are ids [r
    nb / n, (r + 1) nb / n)); block_table: (n, B, bpr) each rank's table
    columns for its own position range, holding GLOBAL page ids (-1 =
    unassigned; the JAX shard takes partition-local ids into its
    partition); kv_len_local: (n, B) valid tokens of each rank's range.
    Every rank's partial runs in one paged-decode launch over n * B
    queries. Returns (B, H, D), replicated."""
    n = num_ranks
    _check_combine(combine)
    B, H, D = q.shape
    qn = q.expand(n, B, H, D).reshape(n * B, H, D)
    out, lse = flash_decode_paged_partial(
        qn, k_pool, v_pool, block_table.reshape(n * B, -1),
        kv_len_local.reshape(n * B), scale=scale)
    return _combine(out.view(n, B, H, D), lse.view(n, B, H), n, combine)
