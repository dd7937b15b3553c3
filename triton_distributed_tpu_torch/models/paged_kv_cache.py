"""Ragged paged KV cache: block pool, free-list allocator with refcounts,
per-slot block tables and lengths (counterpart of
triton_distributed_tpu/models/paged_kv_cache.py).

The pool is (L, num_blocks, Hkv, block, D), block-row-major inside each
page, the JAX layout, so the paged decode kernel reads one (block, D)
tile per page straight from the table. A quantized pool ("int8" /
"float8_e4m3fn") stores rows at wire width with one f32 scale per
(layer, block, head, row) in the `k_scales` / `v_scales` sidecars; a
block off the `in_use` list has all-zero scale rows.

Two multi-rank layouts, n ranks in one process on one device
(parallel/mesh.py):
- head-sharded (`num_ranks=n`, tensor-parallel serving): rank r holds
  Hkv / n kv heads of every page, rank-stacked after the layer
  dimension, (L, n, num_blocks, Hkv / n, block, D) (JAX `part_spec`,
  scales `scale_part_spec`). Page ids are global: one allocator serves
  every rank. The model views a layer's n ranks as one (n * num_blocks,
  Hkv / n, block, D) pool whose rank-r pages are rows r * num_blocks ..
  (r + 1) * num_blocks - 1 (`rank_table` offsets each rank's copy of the
  table so), so one paged-decode launch runs all n ranks as n * B
  sequences.
- sequence-sharded (`sp_ranks=n`, sequence-parallel serving, JAX
  `sp_part_spec`): rank r's pool partition is pool ids [r nb / n, (r + 1)
  nb / n), and `assign_slot(sp_ranks=n)` places table column j in the
  partition of rank j // (max_blocks / n), so rank r owns positions [r
  rank_tokens, (r + 1) rank_tokens) of every slot. The partitions lie one
  after another in the one-rank layout, so the pool keeps it, and rank
  r's part of the table (`sp_tables`) holds global ids into it. A write
  lands only where its position's owner holds the page (the JAX shard
  helpers' drops); `sp_owner` is the loud host guard against a prefill
  chunk that crosses an ownership boundary.

Unlike the JAX cache, which is immutable and relies on buffer donation,
this one is updated IN PLACE: every allocator call and every append
mutates the object and its pools (a functional copy would move the
whole pool per token). The allocator state — `block_table`,
`seq_lens`, `in_use`, `ref_counts` — lives on the host as numpy arrays,
because admission is host-driven; the kernels read a device copy of the
table (`device_table`), uploaded once after the host has changed it,
and the step's lengths, which the model uploads with the step. Grants
follow the JAX order exactly: the lowest free block ids first.

Writes that the JAX helpers drop with `mode="drop"` (inactive slot,
unassigned page, pad row past the valid length, a verify row past its
slot's count, a sequence-sharded row outside its owner's partition) are
filtered on the host (`append_at`, `verify_at`, `chunk_at`), so no index
ever leaves the pool. A speculative rollback is a block-table edit
(`truncate_slot`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import wire
from ..ops.attention import paged_rows
from ..ops.wire import byte_view


def quant_kv(x, wire_dtype):
    """KV rows at wire width: the per-block codec with block = head_dim,
    one f32 scale per (…, head) row. (…, D) -> (q (…, D) wire dtype,
    scales (…,) f32)."""
    q, s = wire.quant_blockwise(x, wire_dtype, x.shape[-1])
    return q, s[..., 0]


def dequant_kv(q, scales, dtype=torch.float32):
    """Inverse of `quant_kv`: q (…, D) + scales (…,) f32 -> (…, D)."""
    return (q.float() * scales[..., None]).to(dtype)


# -- where a step's new rows land -------------------------------------------

@dataclasses.dataclass
class RowsAt:
    """Destinations of a step's new K/V rows, as index tensors on the
    pool's device: row `src[i]` of the step's values goes to
    (page `pages[i]`, row `rows[i]`). Only rows that land are listed."""
    src: torch.Tensor
    pages: torch.Tensor
    rows: torch.Tensor

    @staticmethod
    def of(src, table_row_pages, pos, block: int, device,
           sp=None) -> "RowsAt":
        """Host arrays in: `table_row_pages[i]` is the block-table row
        that position `pos[i]` (of source row `src[i]`) indexes. `sp` =
        (rank_tokens, nb_loc, rank) keeps only the rows a sequence-sharded
        pool takes: the page lies in the partition of the rank that owns
        the position (and, unless rank is None, that rank is `rank`)."""
        pos = np.asarray(pos, np.int64)
        col = pos // block
        rows_tbl = np.asarray(table_row_pages)
        ok = col < rows_tbl.shape[-1]
        pages = np.where(ok, np.take_along_axis(
            rows_tbl, np.minimum(col, rows_tbl.shape[-1] - 1)[:, None],
            axis=-1)[:, 0], -1)
        ok &= pages >= 0
        if sp is not None:
            rank_tokens, nb_loc, rank = sp
            owner = pos // rank_tokens
            ok &= pages // nb_loc == owner
            if rank is not None:
                ok &= owner == rank
        return RowsAt(*(torch.from_numpy(np.ascontiguousarray(a[ok],
                                                              np.int64))
                        .to(device)
                        for a in (np.asarray(src), pages, pos % block)))

    def shifted(self, pages: int) -> "RowsAt":
        """The same rows with every page id moved by `pages`."""
        return RowsAt(self.src, self.pages + pages, self.rows)

    def over_ranks(self, n: int, num_blocks: int, per_rank: int) -> "RowsAt":
        """These rows on every rank of a head-sharded pool viewed as (n *
        num_blocks, Hkv / n, block, D): rank r's copy reads source row r *
        per_rank + src and writes page r * num_blocks + page."""
        r = torch.arange(n, device=self.src.device)[:, None]
        return RowsAt((self.src + r * per_rank).reshape(-1),
                      (self.pages + r * num_blocks).reshape(-1),
                      self.rows.repeat(n))


def append_rows_at(block_table, seq_lens, active, block: int,
                   device, sp=None) -> RowsAt:
    """Destinations of one decode step's rows: slot b appends at
    seq_lens[b] when `active[b]` (None: every slot) and its page is
    assigned (`sp`: RowsAt.of's ownership filter). Host arrays in."""
    lens = np.asarray(seq_lens)
    keep = (np.ones(len(lens), bool) if active is None
            else np.asarray(active, bool))
    return RowsAt.of(np.flatnonzero(keep), np.asarray(block_table)[keep],
                     lens[keep], block, device, sp)


def verify_rows_at(block_table, seq_lens, counts, active, block: int,
                   device, width: int | None = None) -> RowsAt:
    """Destinations of one verify step's rows: slot b's `counts[b]`
    candidate rows land at positions [seq_lens[b], seq_lens[b] +
    counts[b]) when `active[b]` (None: every slot); source row
    b * width + j is candidate j of slot b (`width` defaults to the
    largest count). Rows past a slot's count, inactive slots and
    unassigned pages are not listed. Host arrays in."""
    lens = np.asarray(seq_lens, np.int64)
    cnt = np.asarray(counts, np.int64).reshape(-1)
    keep = (np.ones(len(lens), bool) if active is None
            else np.asarray(active, bool))
    K = max(1, int(cnt.max(initial=1))) if width is None else int(width)
    b, j = np.nonzero((np.arange(K)[None, :] < cnt[:, None]) & keep[:, None])
    return RowsAt.of(b * K + j, np.asarray(block_table)[b], lens[b] + j,
                     block, device)


def chunk_rows_at(block_table, slot: int, off: int, valid_len: int,
                  block: int, device, sp=None) -> RowsAt:
    """Destinations of a prefill chunk's rows: positions [off, off +
    valid_len) of sequence `slot`; rows past valid_len are pad (`sp`:
    RowsAt.of's ownership filter)."""
    n = int(valid_len)
    tbl = np.asarray(block_table)[int(slot)]
    return RowsAt.of(np.arange(n), np.broadcast_to(tbl, (n, tbl.size)),
                     int(off) + np.arange(n), block, device, sp)


def scatter_rows(pool, vals, at: RowsAt, *, scales=None):
    """pool[at.pages, :, at.rows] = vals[at.src], in place. pool:
    (nb, Hkv, block, D) one layer; vals: (n, Hkv, D). With `scales`
    (the layer's (nb, Hkv, block) f32 sidecar) the rows are quantized at
    the pool's wire dtype on the way in and their scales stored at the
    same (page, row)."""
    vals = vals[at.src]
    if scales is None:
        pool[at.pages, :, at.rows] = vals.to(pool.dtype)
        return
    q, s = quant_kv(vals, pool.dtype)
    byte_view(pool)[at.pages, :, at.rows] = byte_view(q)
    scales[at.pages, :, at.rows] = s


# -- functional helpers on one layer's pool (the JAX shard helpers) ----------

def append_step_shard(k_pool, v_pool, k_new, v_new, block_table, seq_lens,
                      active=None, *, k_scales=None, v_scales=None):
    """Write one decode step's K/V rows at each sequence's own (block,
    row) position, in place. k_pool/v_pool: (nb, Hkv, block, D) ONE
    layer's pool; k_new/v_new: (B, Hkv, D); block_table (B, max_blocks)
    and seq_lens (B,) on the host. Inactive slots and unassigned pages
    are not written. Returns (k_pool, v_pool), or with the scale
    sidecars of a quantized pool the 4-tuple, as the JAX helper does."""
    at = append_rows_at(block_table, seq_lens, active, k_pool.shape[2],
                        k_pool.device)
    scatter_rows(k_pool, k_new, at, scales=k_scales)
    scatter_rows(v_pool, v_new, at, scales=v_scales)
    if k_scales is not None:
        return k_pool, v_pool, k_scales, v_scales
    return k_pool, v_pool


def append_rows_shard(k_pool, v_pool, k_new, v_new, block_table, seq_lens,
                      counts, active=None, *, k_scales=None, v_scales=None):
    """Write one verify step's K/V rows, in place: slot b's `counts[b]`
    candidate rows land at positions [seq_lens[b], seq_lens[b] +
    counts[b]); counts == 1 writes exactly `append_step_shard`'s row.
    k_pool/v_pool: (nb, Hkv, block, D) ONE layer's pool; k_new/v_new:
    (B, K, Hkv, D); block_table (B, max_blocks) and seq_lens / counts
    (B,) on the host. Rows past counts[b], inactive slots and unassigned
    pages are not written. The caller advances seq_lens and rolls
    rejected rows back (`PagedKVCache.truncate_slot`). Returns (k_pool,
    v_pool), or with the scale sidecars of a quantized pool the
    4-tuple."""
    B, K = k_new.shape[:2]
    at = verify_rows_at(block_table, seq_lens, counts, active,
                        k_pool.shape[2], k_pool.device, width=K)
    kf, vf = (t.reshape(B * K, *t.shape[2:]) for t in (k_new, v_new))
    scatter_rows(k_pool, kf, at, scales=k_scales)
    scatter_rows(v_pool, vf, at, scales=v_scales)
    if k_scales is not None:
        return k_pool, v_pool, k_scales, v_scales
    return k_pool, v_pool


def write_rows_shard(pool, rows, block_table, slot, off, valid_len,
                     *, scales=None):
    """Scatter a prefill chunk's rows into ONE slot's pages, in place.
    pool: (nb, Hkv, block, D) one layer; rows: (C, Hkv, D) for positions
    [off, off + valid_len) of sequence `slot` (rows past valid_len are
    pad and not written). Returns pool, or (pool, scales)."""
    at = chunk_rows_at(block_table, slot, off, valid_len, pool.shape[2],
                       pool.device)
    scatter_rows(pool, rows, at, scales=scales)
    return pool if scales is None else (pool, scales)


def gather_rows_shard(pool, block_table, b, max_blocks: int, *,
                      scales=None):
    """Contiguous (max_blocks * block, Hkv, D) view of the first
    `max_blocks` pages of sequence `b` from ONE layer's pool. Unassigned
    pages clamp to page 0; callers mask positions >= seq_lens[b]. With
    `scales` the view comes back dequantized float32."""
    row = np.clip(np.asarray(block_table)[int(b), :max_blocks], 0, None)
    pages = torch.from_numpy(row.astype(np.int64)).to(pool.device)
    return paged_rows(pool, pages, scales=scales)


# -- sequence-sharded (SP) shard helpers, on ONE rank's pool partition -------
# The partition-local forms of the helpers above (JAX sp_* :228-:300): a
# partition is (nb_loc, Hkv, block, D), pages [rank nb_loc, (rank + 1)
# nb_loc) of the global pool (a view of it here, so writes land in the
# pool); writes outside the rank's ownership range are not made, reads
# translate the global ids of the rank's table columns to partition-local
# ones. The model writes every rank at once through the same filter
# (PagedKVCache.append_at / chunk_at).

def sp_local_table(block_table, rank, *, bpr: int, nb_loc: int):
    """(B, bpr) PARTITION-LOCAL page ids of `rank`'s position range: table
    columns [rank bpr, (rank + 1) bpr) rebased to the partition (-1 stays
    -1). Host arrays in and out."""
    cols = np.asarray(block_table)[:, rank * bpr:(rank + 1) * bpr]
    return np.where(cols >= 0, cols - rank * nb_loc, -1).astype(np.int32)


def sp_append_step_shard(k_pool, v_pool, k_new, v_new, block_table,
                         seq_lens, rank, *, rank_tokens: int, active=None):
    """`append_step_shard` against ONE rank's pool partition, in place:
    slot b's row lands only on the rank that owns position seq_lens[b],
    and only in a page of its partition. Returns (k_pool, v_pool)."""
    nb_loc, _, blk, _ = k_pool.shape
    at = append_rows_at(block_table, seq_lens, active, blk, k_pool.device,
                        sp=(rank_tokens, nb_loc, rank))
    at = at.shifted(-rank * nb_loc)
    scatter_rows(k_pool, k_new, at)
    scatter_rows(v_pool, v_new, at)
    return k_pool, v_pool


def sp_write_rows_shard(pool, rows, block_table, slot, off, valid_len,
                        rank, *, rank_tokens: int):
    """`write_rows_shard` against ONE rank's pool partition, in place:
    chunk rows for positions outside the rank's ownership range are not
    written. Returns pool."""
    nb_loc, _, blk, _ = pool.shape
    at = chunk_rows_at(block_table, slot, off, valid_len, blk, pool.device,
                       sp=(rank_tokens, nb_loc, rank))
    scatter_rows(pool, rows, at.shifted(-rank * nb_loc))
    return pool


def sp_gather_rows_shard(pool, block_table, b, rank, *, bpr: int,
                         count: int | None = None):
    """Contiguous (count * block, Hkv, D) view of the first `count` pages
    (default bpr) of `rank`'s position range of sequence `b`, from its
    pool partition. Unassigned pages clamp to partition page 0; callers
    mask by the rank-local valid length."""
    nb_loc = pool.shape[0]
    count = bpr if count is None else count
    cols = np.asarray(block_table)[int(b), rank * bpr:rank * bpr + count]
    loc = np.clip(cols.astype(np.int64) - rank * nb_loc, 0, nb_loc - 1)
    return paged_rows(pool, torch.from_numpy(loc).to(pool.device))


class PagedKVCache:
    """The pool, its scale sidecars and the allocator; see the module
    docstring. Built by `create`."""

    def __init__(self, k_pool, v_pool, block_table, seq_lens, in_use,
                 ref_counts, k_scales=None, v_scales=None, *,
                 num_ranks: int = 1, sp_ranks: int = 1):
        self.k_pool = k_pool            # (L, [n,] nb, Hkv [/ n], block, D)
        self.v_pool = v_pool
        self.block_table = block_table  # (B, max_blocks) int32, -1 free
        self.seq_lens = seq_lens        # (B,) int32 tokens cached
        self.in_use = in_use            # (nb,) bool: not grantable
        self.ref_counts = ref_counts    # (nb,) int32 slot-row references
        self.k_scales = k_scales        # (L, [n,] nb, Hkv, block) f32 / None
        self.v_scales = v_scales
        self.num_ranks = num_ranks      # head-sharded ranks (rank dim at 1)
        self.sp_ranks = sp_ranks        # sequence-sharded ranks
        self._dev_tables = {}           # device copies of block_table

    @staticmethod
    def create(num_layers: int, batch: int, max_len: int,
               num_kv_heads: int, head_dim: int, *, block: int = 128,
               num_blocks: int | None = None, dtype=torch.bfloat16,
               kv_dtype=None, device=None, num_ranks: int = 1,
               sp_ranks: int = 1) -> "PagedKVCache":
        """Empty pool + free allocator: `batch` slots of at most
        `max_len` tokens, `num_blocks` pool blocks (default: every slot
        can fill). `kv_dtype` ("int8" / "float8_e4m3fn") stores the
        pool at wire width with f32 scale sidecars. `num_ranks` > 1
        head-shards the pool (and its sidecars) over that many ranks;
        `sp_ranks` > 1 is the sequence-sharded layout, which needs
        max_len's blocks and the pool to split evenly over the ranks and
        takes no wire-width pool (see the module docstring)."""
        kvd = wire.resolve_wire_dtype(kv_dtype)
        if kvd is not None and sp_ranks > 1:
            raise ValueError(
                f"kv_dtype={kvd!r} does not compose with the "
                f"sequence-sharded layout (sp_ranks={sp_ranks}) — the "
                f"SP cross-rank combine would ship wire payloads "
                f"without their scale rows; quantize or shard, not "
                f"both")
        if num_ranks > 1 and sp_ranks > 1:
            raise ValueError("a pool is head-sharded (num_ranks) or "
                             "sequence-sharded (sp_ranks), not both")
        max_blocks = -(-max_len // block)
        nb = num_blocks if num_blocks is not None else batch * max_blocks
        if sp_ranks > 1:
            if max_blocks % sp_ranks:
                raise ValueError(
                    f"sp_ranks={sp_ranks}: max_len={max_len} spans "
                    f"{max_blocks} blocks of {block}, which does not "
                    f"split over {sp_ranks} ranks — pad max_len to a "
                    f"multiple of sp_ranks*block")
            if nb % sp_ranks:
                raise ValueError(
                    f"sp_ranks={sp_ranks}: pool of {nb} blocks does "
                    f"not split over {sp_ranks} ranks")
        if num_kv_heads % num_ranks:
            raise ValueError(f"{num_kv_heads} kv heads do not split into "
                             f"{num_ranks} ranks")
        shape = (num_layers, nb, num_kv_heads, block, head_dim)
        if num_ranks > 1:
            shape = (num_layers, num_ranks, nb, num_kv_heads // num_ranks,
                     block, head_dim)
        pool_dtype = wire.TORCH_WIRE_DTYPES[kvd] if kvd else dtype
        scales = (None, None)
        if kvd is not None:
            scales = tuple(torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device) for _ in range(2))
        return PagedKVCache(
            k_pool=torch.zeros(shape, dtype=pool_dtype, device=device),
            v_pool=torch.zeros(shape, dtype=pool_dtype, device=device),
            block_table=np.full((batch, max_blocks), -1, np.int32),
            seq_lens=np.zeros((batch,), np.int32),
            in_use=np.zeros((nb,), bool),
            ref_counts=np.zeros((nb,), np.int32),
            k_scales=scales[0], v_scales=scales[1], num_ranks=num_ranks,
            sp_ranks=sp_ranks)

    # -- shape and state views ------------------------------------------
    @property
    def block(self) -> int:
        return self.k_pool.shape[-2]

    @property
    def _bdim(self) -> int:
        """The pool's block dimension (after the layer and rank ones)."""
        return 2 if self.num_ranks > 1 else 1

    def layer_pools(self, i: int):
        """Layer i's pools and scale sidecars (None for an unquantized
        pool), a head-sharded layer's n ranks viewed as one (n * nb, Hkv
        / n, block, D) pool: (k_pool, v_pool, k_scales, v_scales)."""
        ts = [self.k_pool[i], self.v_pool[i]]
        ts += ([self.k_scales[i], self.v_scales[i]] if self.quantized
               else [None, None])
        if self.num_ranks > 1:
            ts = [t if t is None else t.flatten(0, 1) for t in ts]
        return tuple(ts)

    @property
    def quantized(self) -> bool:
        return self.k_scales is not None

    @property
    def kv_dtype(self) -> str | None:
        """Wire-dtype name of a quantized pool, else None."""
        return wire.resolve_wire_dtype(self.k_pool.dtype) \
            if self.quantized else None

    @property
    def batch(self) -> int:
        return self.block_table.shape[0]

    @property
    def num_blocks(self) -> int:
        return self.k_pool.shape[self._bdim]

    @property
    def max_blocks(self) -> int:
        return self.block_table.shape[1]

    @property
    def max_len(self) -> int:
        return self.max_blocks * self.block

    @property
    def num_free_blocks(self) -> int:
        return self.num_blocks - int(self.in_use.sum())

    def held_blocks(self) -> int:
        """Blocks the slot table currently accounts for."""
        return int((self.block_table >= 0).sum())

    def block_nbytes(self) -> int:
        """Bytes ONE pool block costs across all layers: K+V payload at
        the pool dtype plus the f32 scale rows when quantized."""
        L, hkv = self.k_pool.shape[0], self.num_kv_heads
        blk, d = self.k_pool.shape[-2:]
        n = 2 * L * hkv * blk * d * self.k_pool.element_size()
        if self.quantized:
            n += 2 * L * hkv * blk * 4
        return n

    @property
    def num_kv_heads(self) -> int:
        return self.k_pool.shape[-3] * self.num_ranks

    # -- the device copies of the table ----------------------------------------
    def _touch(self):
        self._dev_tables = {}

    def _device(self, key, make) -> torch.Tensor:
        """A device array derived from the host table, uploaded again only
        after the allocator changed the table."""
        t = self._dev_tables.get(key)
        if t is None:
            t = self._dev_tables[key] = torch.from_numpy(
                np.ascontiguousarray(make(self.block_table), np.int32)).to(
                self.k_pool.device)
        return t

    @property
    def device_table(self) -> torch.Tensor:
        """(B, max_blocks) int32 block table on the pool's device."""
        return self._device("table", lambda t: t)

    @property
    def rank_table(self) -> torch.Tensor:
        """The head-sharded pool's table for its (n * nb, ...) view: (n, B,
        max_blocks), rank r's copy offset by r * num_blocks (-1 stays
        -1). The one-rank table at n = 1."""
        n, nb = self.num_ranks, self.num_blocks
        return self._device("ranks", lambda t: np.where(
            t[None] >= 0, t[None] + np.arange(n)[:, None, None] * nb, -1))

    @property
    def sp_tables(self) -> torch.Tensor:
        """The sequence-sharded pool's per-rank tables: (n, B, bpr), rank
        r's columns [r bpr, (r + 1) bpr) of the table, global ids."""
        n = self.sp_ranks
        bpr = self.max_blocks // n
        return self._device("sp", lambda t: t.reshape(
            t.shape[0], n, bpr).transpose(1, 0, 2))

    def advance(self, b, n):
        """seq_lens[b] += n: a step cached n more rows of the slot(s)."""
        self.seq_lens[b] += np.asarray(n, np.int32)

    # -- where a step's rows land ------------------------------------------
    def _sp(self):
        """RowsAt.of's ownership filter of a sequence-sharded pool."""
        if self.sp_ranks == 1:
            return None
        return (self.sp_rank_tokens(self.sp_ranks),
                self.num_blocks // self.sp_ranks, None)

    def append_at(self, active=None) -> RowsAt:
        """`append_rows_at` over this cache's table and lengths."""
        return append_rows_at(self.block_table, self.seq_lens, active,
                              self.block, self.k_pool.device, self._sp())

    def verify_at(self, counts, active=None, width: int | None = None
                  ) -> RowsAt:
        """`verify_rows_at` over this cache's table and lengths."""
        return verify_rows_at(self.block_table, self.seq_lens, counts,
                              active, self.block, self.k_pool.device, width)

    def chunk_at(self, slot: int, off: int, valid_len: int) -> RowsAt:
        """`chunk_rows_at` over this cache's table."""
        return chunk_rows_at(self.block_table, slot, off, valid_len,
                             self.block, self.k_pool.device, self._sp())

    def prefix_pages(self, slot: int, n_tokens: int) -> torch.Tensor:
        """Device ids of the ceil(n_tokens / block) pages holding
        positions [0, n_tokens) of `slot` (unassigned pages clamp to
        page 0, as the JAX gather does)."""
        n = -(-n_tokens // self.block)
        row = np.clip(self.block_table[slot, :n], 0, None).astype(np.int64)
        return torch.from_numpy(row).to(self.k_pool.device)

    # -- sequence-sharded (SP) ownership ----------------------------------
    def sp_rank_tokens(self, sp_ranks: int) -> int:
        """Tokens of every sequence one rank owns under sequence sharding.
        Raises when the geometry does not split evenly."""
        if self.max_blocks % sp_ranks or self.num_blocks % sp_ranks:
            raise ValueError(
                f"sp_rank_tokens: max_blocks={self.max_blocks} / "
                f"num_blocks={self.num_blocks} do not split over "
                f"{sp_ranks} ranks — create the cache with "
                f"sp_ranks={sp_ranks}")
        return (self.max_blocks // sp_ranks) * self.block

    def sp_owner(self, off, length, *, sp_ranks: int) -> int:
        """Owning rank of positions [off, off + length) under sequence
        sharding. A range that crosses a rank ownership boundary or runs
        past the sharded extent raises: its foreign-rank half would not
        be written."""
        rt = self.sp_rank_tokens(sp_ranks)
        off = int(off)
        last = off + max(int(length), 1) - 1
        if off < 0 or last >= self.max_len:
            raise ValueError(
                f"sp_owner: positions [{off}, {last}] fall outside the "
                f"sharded extent {self.max_len} "
                f"({sp_ranks} ranks x {rt})")
        if off // rt != last // rt:
            raise ValueError(
                f"sp_owner: write [{off}, {last}] crosses the rank "
                f"ownership boundary at {(off // rt + 1) * rt} "
                f"(rank_tokens={rt}) — chunk writes must stay inside "
                f"one rank's slice; size prefill chunks so "
                f"rank_tokens % chunk == 0")
        return off // rt

    def check_conservation_sp(self, sp_ranks: int, *, external: int = 0,
                              cached: int = 0):
        """`check_conservation` plus the sequence-sharded placement: table
        column j's block lives in the partition of the rank that owns
        position range j, and (with nothing cached or held elsewhere)
        each rank's in-use blocks are exactly its referenced ones.
        Raises ValueError."""
        self.check_conservation(external=external, cached=cached)
        rt = self.sp_rank_tokens(sp_ranks)
        bpr = rt // self.block
        nb_loc = self.num_blocks // sp_ranks
        tbl = self.block_table
        col_owner = np.arange(self.max_blocks) // bpr
        blk_owner = np.where(tbl >= 0, tbl // nb_loc, col_owner)
        if not np.array_equal(blk_owner, np.broadcast_to(
                col_owner, blk_owner.shape)):
            bad = np.argwhere(blk_owner != col_owner)[:4]
            detail = ", ".join(
                f"slot {b} col {j}: block {tbl[b, j]} (rank "
                f"{tbl[b, j] // nb_loc}) placed in rank {j // bpr}'s "
                f"range" for b, j in bad)
            raise ValueError(
                f"sp placement violated ({sp_ranks} ranks, "
                f"{bpr} blocks/rank): {detail}")
        if not cached and not external:
            held_r = (self.ref_counts.reshape(sp_ranks, nb_loc) > 0).sum(1)
            used_r = self.in_use.reshape(sp_ranks, nb_loc).sum(axis=1)
            if not np.array_equal(held_r, used_r):
                r = int(np.flatnonzero(held_r != used_r)[0])
                raise ValueError(
                    f"per-rank free-list conservation violated: rank "
                    f"{r} has {int(used_r[r])} blocks in_use but "
                    f"{int(held_r[r])} referenced — "
                    f"{'leaked' if held_r[r] < used_r[r] else 'aliased'}"
                    f" blocks in its partition")

    # -- free-list allocator -------------------------------------------------
    def _require_empty(self, b, op):
        row = self.block_table[b]
        if (row >= 0).any():
            raise ValueError(
                f"{op}({b}): slot still holds {int((row >= 0).sum())} "
                f"block(s) — assigning over it would leak them from the "
                f"free list; call free_slot first")

    def assign_slot(self, b: int, num_blocks: int, *,
                    sp_ranks: int = 1) -> bool:
        """Grant `num_blocks` free blocks, lowest ids first, to empty slot
        `b`, all or nothing. Returns ok; False leaves the pool unchanged
        (the admission queue keeps the request). The slot's length
        becomes 0 either way.

        `sp_ranks` > 1 is the sequence-sharded form: table column j draws
        from the partition of rank j // bpr (the lowest free ids of that
        partition first), and the grant is all or nothing ACROSS RANKS:
        False unless every rank whose range the row touches can grant its
        share from its own partition, however many blocks the pool has
        free."""
        b = int(b)
        self._require_empty(b, "assign_slot")
        mb = self.max_blocks
        self.seq_lens[b] = 0
        if sp_ranks > 1:
            if mb % sp_ranks or self.num_blocks % sp_ranks:
                raise ValueError(
                    f"assign_slot(sp_ranks={sp_ranks}): geometry "
                    f"max_blocks={mb} / num_blocks={self.num_blocks} "
                    f"does not split over the ranks")
            nb_loc, bpr = self.num_blocks // sp_ranks, mb // sp_ranks
            free = [np.flatnonzero(~part) + r * nb_loc for r, part in
                    enumerate(self.in_use.reshape(sp_ranks, nb_loc))]
            need = [min(max(num_blocks - r * bpr, 0), bpr)
                    for r in range(sp_ranks)]
            ok = num_blocks <= mb and all(
                k <= f.size for k, f in zip(need, free))
            if ok:
                got = np.concatenate([f[:k] for k, f in zip(need, free)])
                self.block_table[b, :num_blocks] = got
                self.in_use[got] = True
                self.ref_counts[got] = 1
            self._touch()
            return bool(ok)
        free = np.flatnonzero(~self.in_use)
        ok = num_blocks <= free.size and num_blocks <= mb
        if ok:
            got = free[:num_blocks]
            self.block_table[b, :num_blocks] = got
            self.in_use[got] = True
            self.ref_counts[got] = 1
        self._touch()
        return bool(ok)

    def assign_slot_prefixed(self, b: int, *, shared=(), n_new: int,
                             cow_src=None, seq_len: int = 0):
        """Radix-prefix grant: the `shared` blocks, already holding the
        matched prefix's KV, map into the head of slot `b`'s table with
        refcount bumps; `n_new` fresh blocks (lowest free ids) fill the
        tail, all or nothing. `cow_src` names a shared block the slot
        must privately rewrite (a full-prompt hit): the first fresh
        block becomes its copy-on-write clone — pages and scale rows
        copied on the device — in place of a refcount bump. `seq_len`
        sets the slot's cached length at the match boundary.

        Returns (ok, fresh_block_ids); ok False leaves the cache
        untouched. Mapping a block that is not resident raises (the
        radix tree referencing a reclaimed block)."""
        b = int(b)
        self._require_empty(b, "assign_slot_prefixed")
        shared = tuple(int(x) for x in shared)
        if cow_src is not None and n_new < 1:
            raise ValueError("copy-on-write needs a fresh destination "
                             "block (n_new >= 1)")
        bad = [x for x in shared if not self.in_use[x]] \
            + ([int(cow_src)] if cow_src is not None
               and not self.in_use[int(cow_src)] else [])
        if bad:
            raise ValueError(
                f"assign_slot_prefixed({b}): shared block(s) {bad} are "
                f"not resident — the radix cache references a reclaimed "
                f"block (cached-aliasing)")
        free = np.flatnonzero(~self.in_use)
        if n_new > free.size or len(shared) + n_new > self.max_blocks:
            return False, ()
        fresh = [int(x) for x in free[:n_new]]
        rest = list(fresh)
        row = list(shared)
        if cow_src is not None:
            dst = rest.pop(0)
            row.append(dst)
            pools = [self.k_pool, self.v_pool]
            if self.quantized:
                pools += [self.k_scales, self.v_scales]
            at = (slice(None),) * self._bdim
            for t in pools:
                byte_view(t)[at + (dst,)].copy_(
                    byte_view(t)[at + (int(cow_src),)])
        row += rest
        self.block_table[b] = -1
        self.block_table[b, :len(row)] = row
        self.seq_lens[b] = seq_len
        if shared:
            np.add.at(self.ref_counts, list(shared), 1)
        if fresh:
            self.ref_counts[fresh] = 1
            self.in_use[fresh] = True
        self._touch()
        return True, tuple(fresh)

    def reclaim_blocks(self, ids):
        """Return refcount-0 radix-cached blocks to the free list (the
        LRU reclaim path), zeroing their scale rows. Reclaiming a
        referenced or already-free block raises."""
        ids = tuple(int(x) for x in ids)
        if not ids:
            return
        live = [x for x in ids if self.ref_counts[x] > 0]
        if live:
            raise ValueError(
                f"reclaim_blocks: block(s) {live} still referenced "
                f"(refcounts {[int(self.ref_counts[x]) for x in live]})")
        loose = [x for x in ids if not self.in_use[x]]
        if loose:
            raise ValueError(f"reclaim_blocks: block(s) {loose} already "
                             f"free — double reclaim")
        self.in_use[list(ids)] = False
        self._zero_scales(ids)

    def _zero_scales(self, ids):
        """Zero the scale rows of now-free blocks (the lockstep that
        `check_conservation` enforces). No-op on unquantized pools."""
        if not self.quantized or not len(ids):
            return
        idx = torch.as_tensor(list(ids), dtype=torch.int64,
                              device=self.k_scales.device)
        at = (slice(None),) * self._bdim + (idx,)
        self.k_scales[at] = 0.0
        self.v_scales[at] = 0.0

    def free_slot(self, b: int, cached=()):
        """Release slot `b`'s references: refcounts decrement, and a
        block leaves `in_use` only when its last reference drops AND the
        radix cache is not retaining it (`cached`, the tree's membership
        set). Live neighbours are untouched. Freeing a slot that holds
        no blocks raises (double free)."""
        b = int(b)
        row = self.block_table[b]
        mine = row[row >= 0]
        if not mine.size:
            raise ValueError(
                f"free_slot({b}): slot holds no blocks — double-free or "
                f"free of an unassigned slot would corrupt the free list")
        self.ref_counts[mine] = np.maximum(self.ref_counts[mine] - 1, 0)
        keep = {int(c) for c in cached}
        gone = [int(x) for x in mine
                if self.ref_counts[x] <= 0 and int(x) not in keep]
        self.in_use[gone] = False
        self._zero_scales(gone)
        self.block_table[b] = -1
        self.seq_lens[b] = 0
        self._touch()

    def truncate_slot(self, b: int, new_len: int, *, cached=(),
                      min_blocks: int = 0, sp_ranks: int = 1) -> tuple:
        """Speculative-decode rollback as a block-table edit: trim slot
        `b`'s cached length to `new_len` tokens (rows past it become
        garbage that every reader bounds off by seq_lens and later
        appends rewrite) and free the now-empty TAIL table columns,
        those at or past max(ceil(new_len / block), min_blocks), through
        the refcount path of `free_slot`: a block leaves `in_use` only at
        its last reference unless the radix cache retains it (`cached`).
        `min_blocks` keeps a serving slot's upfront grant. Raises
        ValueError on a slot that holds no blocks, on growing a slot, and
        on an append boundary left inside a copy-on-write-shared or
        radix-cached block (future appends would rewrite storage that
        other readers map). Returns the freed block ids. `sp_ranks > 1`
        raises: only a speculative rollback truncates, and sequence-
        parallel serving refuses speculation (as the JAX engine does)."""
        if int(sp_ranks) > 1:
            raise NotImplementedError(
                "truncate_slot(sp_ranks > 1) is not ported yet: no serving "
                "path reaches it (sequence-parallel serving refuses "
                "speculation); it is queued with the rest of slice 6, the "
                "off-path modules (ROADMAP.md Queue A)")
        b, new_len, blk = int(b), int(new_len), self.block
        row = self.block_table[b]
        held = [int(x) for x in row if x >= 0]
        if not held:
            raise ValueError(
                f"truncate_slot({b}): slot holds no blocks — rollback of "
                f"an unassigned/evicted slot")
        cur = int(self.seq_lens[b])
        if new_len < 0 or new_len > cur:
            raise ValueError(
                f"truncate_slot({b}): new_len {new_len} outside "
                f"[0, {cur}] — rollback can only trim cached tokens")
        keep_cols = min(max(-(-new_len // blk), int(min_blocks)), len(held))
        cached = {int(c) for c in cached}
        for col in range(new_len // blk, keep_cols):
            blk_id = held[col]
            if self.ref_counts[blk_id] >= 2 or blk_id in cached:
                raise ValueError(
                    f"truncate_slot({b}): new_len {new_len} leaves the "
                    f"append boundary inside block {blk_id} (column {col}) "
                    f"which is "
                    f"{'CoW-shared' if self.ref_counts[blk_id] >= 2 else 'radix-cached'}"
                    f" — rolling back below the shared prefix boundary "
                    f"would rewrite storage other readers still map")
        tail = held[keep_cols:]
        self.block_table[b] = -1
        self.block_table[b, :keep_cols] = held[:keep_cols]
        self.seq_lens[b] = new_len
        freed = []
        if tail:
            self.ref_counts[tail] = np.maximum(self.ref_counts[tail] - 1, 0)
            freed = [x for x in tail
                     if self.ref_counts[x] == 0 and x not in cached]
            self.in_use[freed] = False
            self._zero_scales(freed)
        self._touch()
        return tuple(freed)

    def check_conservation(self, *, external: int = 0, cached: int = 0):
        """Refcount conservation: every block's refcount equals its
        slot-table membership count, and the in-use population is
        exactly the referenced blocks plus `cached` radix-retained blocks
        plus `external` blocks held elsewhere. A quantized pool's free
        blocks must carry all-zero scale rows. Raises ValueError."""
        tbl, refs = self.block_table, self.ref_counts
        member = np.bincount(tbl[tbl >= 0].reshape(-1),
                             minlength=self.num_blocks)
        if not np.array_equal(member, refs):
            bad = np.flatnonzero(member != refs)[:8]
            raise ValueError(
                f"refcount conservation violated: block(s) "
                f"{bad.tolist()} held by {member[bad].tolist()} slot "
                f"row(s) but refcounted {refs[bad].tolist()} — "
                f"{'aliased' if (member[bad] > refs[bad]).any() else 'leaked'}"
                f" blocks")
        in_use = int(self.in_use.sum())
        held = int((refs > 0).sum())
        if held + cached + external != in_use:
            raise ValueError(
                f"free-list conservation violated: {in_use} blocks in_use "
                f"but {held} referenced (+{cached} radix-cached, "
                f"+{external} externally held) of {self.num_blocks} — "
                f"{'leaked' if held + cached + external < in_use else 'aliased'}"
                f" blocks")
        if self.quantized:
            free = ~self.in_use
            other = tuple(d for d in range(self.k_scales.dim())
                          if d != self._bdim)
            for name, sc in (("k", self.k_scales), ("v", self.v_scales)):
                mag = sc.abs().amax(dim=other).cpu().numpy()
                stale = np.flatnonzero(free & (mag > 0))
                if stale.size:
                    raise ValueError(
                        f"scale-sidecar lockstep violated: free block(s) "
                        f"{stale.tolist()[:8]} still carry nonzero "
                        f"{name}-scale rows")

    def gather_shard(self, pool, layer: int, b: int, *,
                     max_blocks: int | None = None, scales=None):
        """Contiguous (max_blocks * block, Hkv, D) view of sequence `b` at
        `layer` (default: the full table width). Pass the matching
        scale sidecar of a quantized pool for a dequantized f32 view. A
        head-sharded pool passes one rank's pool, `k_pool[:, r]`."""
        mb = self.max_blocks if max_blocks is None else max_blocks
        return gather_rows_shard(
            pool[layer], self.block_table, b, mb,
            scales=None if scales is None else scales[layer])
