"""Sequence-parallel attention: ring-attention prefill (dense and over a
packed varlen batch) and distributed split-KV flash decode (counterpart of
triton_distributed_tpu/ops/sp_attention.py: `ring_attention[_shard]`,
`ring_attention_varlen[_shard]`, `sp_flash_decode[_shard]` and
`sp_flash_decode_paged_shard`; `ring_attention_2d[_shard]` waits for a
two-axis RankGroup, ROADMAP Queue A 5.5).

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
- **The varlen ring** keeps the same hop order over a packed batch
  whose sequences may cross shard boundaries: one launch of the varlen
  kernel a round runs all n ranks (a batch row each), reading each rank's
  (q_offset, kv_offset, kv_valid) from an int32 table on the device, and
  every rank's partial is merged, as JAX merges them (a partial that sees
  nothing has lse ~ -1e30 and weight 0).
- **Decode** runs every rank's split-KV partial in one launch over the n
  ranks' B queries (n * B sequences), then combines the (out, lse)
  partials: "xla" gathers them (`RankGroup.all_gather`) and merges with
  `combine_partials`; "ll" runs the one-shot kernel
  (ops/ll_gather.ll_combine_shard).
- **The host-level functions** (`ring_attention`, `ring_attention_varlen`,
  `sp_flash_decode`) take global tensors and `num_ranks` in place of JAX's
  mesh and axis, shard the sequence over the ranks (parallel.shard) and
  return the global result.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import RankGroup, shard, unshard
from .attention import (SIDEBAND_PAD_START, _check_blocks, _fa_varlen_call,
                        _varlen_rows, combine_partials,
                        flash_attention_partial, flash_decode_paged_partial,
                        flash_decode_partial, merge_two_partials,
                        segment_sideband)
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


def ring_attention(q, k, v, *, num_ranks: int, causal: bool = True,
                   scale: float | None = None, block_q: int = 128,
                   block_k: int = 128):
    """Host-level ring attention (JAX :96). q: (B, S, H, D), k/v: (B, S,
    Hkv, D), the sequence split into num_ranks contiguous shards. Returns
    (B, S, H, D). block_q / block_k are JAX's tile sizes, checked; the
    kernel tiles by its own."""
    _check_blocks(block_q, block_k)
    n = num_ranks
    out = ring_attention_shard(
        shard(q, 1, n), shard(k, 1, n), shard(v, 1, n), num_ranks=n,
        causal=causal, scale=scale)
    return unshard(out, 1)


def pad_sideband(meta, rows: int):
    """The ranks' sidebands meta (n, s_loc, 128) int32 padded to `rows`
    rows each, the padding rows in the cull-neutral (INT32_MAX, 0)
    encoding (JAX :170-:173, sp_ag_attention.py:273-:276)."""
    n, s_loc, _ = meta.shape
    out = torch.zeros((n, rows, 128), dtype=torch.int32, device=meta.device)
    out[:, :, 0] = SIDEBAND_PAD_START
    out[:, :s_loc] = meta
    return out


def ring_attention_varlen_shard(q, k, v, qmeta, *, num_ranks: int,
                                causal: bool = True,
                                scale: float | None = None,
                                block_q: int = 128, block_k: int = 128):
    """Varlen ring attention over the n ranks' shards of a globally packed
    batch (JAX :117). q: (n, s_loc, H, D), k/v: (n, s_loc, Hkv, D); qmeta:
    (n, round_up(s_loc, bq), 128) int32, each rank's rows' GLOBAL (seq_start,
    seq_end) (`segment_sideband` layout), bq = min(block_q, round_up(s_loc,
    8)). Round r attends rank me to the shard of rank (me - r) mod n, every
    rank in one varlen launch, and merges the partial into a running f32
    accumulator. Returns (n, s_loc, H, D) in q's dtype."""
    _check_blocks(block_q, block_k)
    n = num_ranks
    if q.shape[0] != n or k.shape[0] != n or v.shape != k.shape:
        raise ValueError(f"ring_attention_varlen: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         f"rank-stacked over {n} ranks")
    s_loc = q.shape[1]
    want = (n, _varlen_rows(s_loc, block_q), 128)
    if tuple(qmeta.shape) != want:
        raise ValueError(f"qmeta {tuple(qmeta.shape)} is not {want}")
    qmeta = qmeta.to(q.device).contiguous()
    q = q.contiguous()
    me = torch.arange(n)
    acc = lse = None
    for r in range(n):
        src = (me - r) % n
        # rank me holds the shard that started on rank me - r
        offs = torch.stack([me * s_loc, src * s_loc,
                            torch.full((n,), s_loc)], dim=1)
        ks, vs = (t[src.to(t.device)].contiguous() for t in (k, v))
        o, l = _fa_varlen_call(q, ks, vs, qmeta, offs, causal=causal,
                               scale=scale, need_lse=True)
        acc, lse = (o.float(), l) if acc is None else \
            merge_two_partials(acc, lse, o, l)
    return acc.to(q.dtype)


def ring_attention_varlen(q, k, v, cu_seqlens, *, num_ranks: int,
                          causal: bool = True, scale: float | None = None,
                          block_q: int = 128, block_k: int = 128):
    """Ring attention over a PACKED variable-length batch (JAX :147). q:
    (T, H, D), k/v: (T, Hkv, D), rows split contiguously over num_ranks (T
    % n == 0); cu_seqlens: (B+1,) global row boundaries. Sequences may
    cross shard boundaries: masking is by global (seq_start, seq_end).
    Returns (T, H, D)."""
    _check_blocks(block_q, block_k)
    n = num_ranks
    T = q.shape[0]
    if T % n:
        raise ValueError(f"ring_attention_varlen: {T} rows do not split "
                         f"over {n} ranks")
    s_loc = T // n
    meta = segment_sideband(torch.as_tensor(cu_seqlens).to(q.device), T)
    qmeta = pad_sideband(meta.view(n, s_loc, 128),
                         _varlen_rows(s_loc, block_q))
    out = ring_attention_varlen_shard(
        shard(q, 0, n), shard(k, 0, n), shard(v, 0, n), qmeta, num_ranks=n,
        causal=causal, scale=scale, block_q=block_q, block_k=block_k)
    return unshard(out, 0)


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


def sp_flash_decode(q, k, v, kv_len, *, num_ranks: int,
                    scale: float | None = None, block_k: int = 256,
                    combine: str = "xla"):
    """Host-level distributed decode (JAX :347). q: (B, H, D) replicated;
    k/v: (B, Skv, Hkv, D) caches whose positions split over num_ranks
    contiguous ranges; kv_len: (B,) (or an int) total valid length per
    batch row, global. Each rank's valid prefix is kv_len - r Skv_loc,
    clipped to [0, Skv_loc]. A kv_len past the cache raises, as JAX's
    host path does (a silent clip would drop positions). block_k is the
    JAX kernel's tile; the CUDA kernel splits by its own. Returns (B, H,
    D)."""
    n = num_ranks
    if k.shape[1] % n:
        raise ValueError(
            f"sp_flash_decode: cache length {k.shape[1]} does not split "
            f"over {n} ranks")
    skv_loc = k.shape[1] // n
    kvl = torch.as_tensor(kv_len).to(device=q.device, dtype=torch.int32)
    kvl = kvl.expand(q.shape[0])
    top = int(kvl.max()) if kvl.numel() else 0
    if top > k.shape[1]:
        raise ValueError(
            f"sp_flash_decode: kv_len {top} exceeds the sharded KV extent "
            f"{k.shape[1]} ({n} ranks x {skv_loc})")
    me = torch.arange(n, device=q.device, dtype=torch.int32)[:, None]
    local = (kvl[None] - me * skv_loc).clamp(0, skv_loc)
    return sp_flash_decode_shard(q, shard(k, 1, n), shard(v, 1, n), local,
                                 num_ranks=n, scale=scale, combine=combine)


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
