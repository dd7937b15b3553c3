"""MegaServe: the megakernel as ServeEngine's batched decode step
(counterpart of triton_distributed_tpu/megakernel/serve.py).

`build_qwen3_serve_batched` (for a Qwen3MoE,
`build_qwen3_moe_serve_batched`) gives one program for the whole
`b_max` batch over a paged KV pool: the per-slot cache lengths and the block
table are run-time data of each launch, so admission, eviction and
ragged lengths never rebuild it. `MegaServe` wraps it with what
ServeEngine (models/serve.py, mode="megakernel") needs:

- the weights as views of the model's parameters (`dense_weight_map`,
  nothing copied; `moe_weight_map` copies only the router, cast to the
  model dtype);
- `decode(...)`: embed into the slots' rows, ONE launch of
  csrc/megakernel.cu for the whole batch (paged attention and the paged
  appends inside it), lm_head on each slot's live row, then the engine
  path's greedy or sampled pick, so greedy tokens equal the engine's;
- `handoff(cache, slot)`: prefill stays on the engine path; at the
  prefill->decode transition a slot's pages are copied once from the
  engine's PagedKVCache pool into the megakernel's pool at the SAME page
  ids (int8 / fp8 pages dequantized with their f32 scales);
- `kernel_table(...)`: the table the kernel walks, in which every slot
  that does not decode this tick, and every unassigned column, points at
  the slot's own trash page (pool page num_blocks + b), so an inactive
  slot rides the launch at length 0 and writes only its trash page. Its
  live width is 0 (a decoding slot's is 1), so in a MoE program its
  rows route to no expert and read no expert slab: an idle slot, and
  one that the expert-capacity budget defers, cost no expert bytes.

Page ids are shared with the engine's allocator, so admission, eviction
and the free list need to know nothing of the megakernel.

- `verify(...)`: the speculative verify step, the same program at
  per-slot widths up to `slot_rows`: a slot's candidate rows fill the
  first rows of its tile, ONE launch scores them all (ATTN_P causal over
  the candidates, the paged append of every candidate row, GROUPED_GEMM
  on every live row), then lm_head and argmax on the live rows.

With `tp_ranks=n > 1` (a DenseLLM(num_ranks=n)) the program is one
rank's trunk at the local widths (heads / n, kv heads / n, intermediate /
n) with an all_reduce after every o and down projection
(`build_qwen3_serve_batched(tp_shards=True)`), its weights the model's own
rank shards (`dense_weight_map_tp`, views). ONE launch runs all n ranks'
programs, their AR tasks pushing the partials between the ranks' arenas
on the card. Each rank has a pool of its own kv heads, (L, n, pages x
block, Hkv / n x D), with its own trash pages; the handoff copies each
rank's kv-head slice of the engine's head-sharded pool (L, n, nb, Hkv / n,
block, D) at the shared page ids. The trunk's output is alike on every
rank after the last all_reduce; lm_head and the pick run on rank 0's copy
with the model's rank-stacked lm_head, as the engine path's steps do at n
ranks. `ar_bytes_per_step` is JAX's count of the bytes a rank pushes a
launch.

The slot's trunk tile is `slot_rows` rows (its token, or its verify
candidates, in the first, zero pad in the rest). The JAX package uses
the TPU's 8 / 16-row sublane tile; here the default is 1, which keeps a
b_max <= 8 trunk on the kernel's skinny LINEAR body (each weight read
once per step); a verify step takes at most slot_rows candidates a
slot (ServeEngine picks 8 under speculation when it is given none).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..models.dense import greedy_token, sample_token
from ..ops.wire import byte_view
from ..parallel.mesh import RankGroup
from .decoder import dense_weight_map, dense_weight_map_tp, moe_weight_map
from .executor_cuda import indexed
from .models import build_qwen3_moe_serve_batched, build_qwen3_serve_batched


class MegaServe:
    """Batched megakernel decode for ServeEngine(mode="megakernel") on
    a one-rank dense model or Qwen3MoE (tensor-parallel experts), or a
    dense model at `tp_ranks` = its n ranks. On a model on the CPU its
    program runs the plain queue walk (the tests); on a CUDA model it
    launches the kernel."""

    def __init__(self, model, params, *, b_max: int, max_len: int,
                 block: int, num_blocks: int, slot_rows: int = 1,
                 tp_ranks: int = 1):
        # the JAX constructor's guards, in its order (serve.py:85-140)
        if isinstance(tp_ranks, bool) \
                or not isinstance(tp_ranks, (int, np.integer)) \
                or tp_ranks < 1:
            raise ValueError(f"tp_ranks must be a positive integer, got "
                             f"{tp_ranks!r}")
        n = self.n = int(tp_ranks)
        if n > 1 and model.n != n:
            raise ValueError(
                f"tp_ranks={n} needs a model sharded over the same ranks "
                f"(model.n={model.n}): the per-rank weight shards come from "
                f"the model's own column/row-parallel layout")
        if n == 1 and model.n != 1:
            raise ValueError(
                "MegaServe with tp_ranks=1 drives one-rank models; pass "
                "tp_ranks=model.n for tensor-parallel batched serving")
        c = model.config
        if n > 1 and (c.num_heads % n or c.num_kv_heads % n
                      or c.intermediate_size % n):
            raise ValueError(
                f"tp_ranks={n} does not divide the model: heads "
                f"{c.num_heads}, kv heads {c.num_kv_heads}, intermediate "
                f"{c.intermediate_size} must all split evenly across ranks")
        if c.is_moe and n > 1:
            raise ValueError(
                "tp_ranks > 1 is dense-only: the MoE serving program's "
                "grouped-GEMM slabs are not rank-sharded; EP serving rides "
                "the engine path")
        if slot_rows < 1:
            raise ValueError(f"slot_rows must be >= 1, got {slot_rows}")
        common = dict(
            b_slots=b_max, slot_rows=slot_rows, hidden=c.hidden_size,
            num_layers=c.num_layers, num_heads=c.num_heads // n,
            num_kv_heads=c.num_kv_heads // n, head_dim=c.head_dim,
            num_blocks=num_blocks, block=block,
            max_pages=-(-max_len // block), rope_theta=c.rope_theta,
            qk_norm=c.qk_norm, rms_eps=c.rms_norm_eps, dtype=model.dtype)
        if c.is_moe:
            if getattr(model, "moe_parallel", "tp") != "tp":
                raise ValueError(
                    "MegaServe maps the tensor-parallel expert layout; "
                    "expert-parallel serving rides the engine path")
            weights, self.embed, self.lm_head = moe_weight_map(model,
                                                               params)
            mb = build_qwen3_moe_serve_batched(
                moe_intermediate=c.moe_intermediate_size,
                num_experts=c.num_experts, top_k=c.num_experts_per_tok,
                norm_topk=c.norm_topk_prob, **common)
        elif n > 1:
            weights, self.embed, self.lm_head = dense_weight_map_tp(model,
                                                                    params)
            mb = build_qwen3_serve_batched(
                intermediate=c.intermediate_size // n, mesh=RankGroup(n),
                tp_shards=True, **common)
        else:
            weights, self.embed, self.lm_head = dense_weight_map(model,
                                                                 params)
            mb = build_qwen3_serve_batched(
                intermediate=c.intermediate_size, **common)
        self.device = indexed(model.device)
        self.b_max, self.num_blocks = b_max, num_blocks
        self.slot_rows = slot_rows
        self.prog = mb.compile("kernel", device=self.device)
        self.prog.bind_weights(weights)
        # JAX's count (serve.py:189-193): 2 ARs a layer push the (b_max x
        # slot_rows, hidden) trunk to each of the n - 1 peers, per rank
        self.ar_bytes_per_step = (
            2 * c.num_layers * (n - 1) * b_max * slot_rows * c.hidden_size
            * torch.finfo(model.dtype).bits // 8) if n > 1 else 0
        # the pool of every layer in one tensor per part (a rank
        # dimension after the layer's at n ranks), so the handoff is one
        # scatter; the program binds each layer's view
        rows = (num_blocks + b_max) * block
        kvw = c.num_kv_heads // n * c.head_dim
        ranks = (n,) if n > 1 else ()
        self.k_pool, self.v_pool = (
            torch.zeros((c.num_layers, *ranks, rows, kvw), dtype=model.dtype,
                        device=self.device) for _ in range(2))
        self.prog.bind_caches(
            {f"l{i}.{part}": pool[i] for i in range(c.num_layers)
             for part, pool in (("k_pool", self.k_pool),
                                ("v_pool", self.v_pool))})

    def reset(self):
        """Empty pools for a new ServeEngine.run (the program and the
        weight views are kept)."""
        self.k_pool.zero_()
        self.v_pool.zero_()

    # -- block-table mapping ---------------------------------------------
    def kernel_table(self, block_table, decode_mask):
        """The (b_max, max_pages) int32 table the kernel walks, with
        torch ops on the device of `block_table`: decoding slots keep
        their allocator pages; every other slot, and every unassigned
        (-1) column, points at the slot's own trash page
        (num_blocks + b)."""
        tbl = torch.as_tensor(block_table, dtype=torch.int32)
        mask = torch.as_tensor(decode_mask, dtype=torch.bool,
                               device=tbl.device)
        trash = self.num_blocks + torch.arange(
            self.b_max, dtype=torch.int32, device=tbl.device)[:, None]
        return torch.where(mask[:, None] & (tbl >= 0), tbl, trash)

    # -- chunked-prefill handoff -----------------------------------------
    def handoff(self, cache, slot: int):
        """Copy slot `slot`'s pages from the engine pool
        (L, nb, Hkv, block, D) into the megakernel pool at the same page
        ids, every layer at once; unassigned columns land on the slot's
        trash page. At n ranks the engine pool is head-sharded, (L, n, nb,
        Hkv / n, block, D), and each rank's kv-head slice lands in that
        rank's pool. A quantized pool's pages are dequantized with their
        f32 scales (wire.dequant_blockwise's arithmetic) to the model
        dtype. Call once, at the slot's prefill->decode transition."""
        row = np.asarray(cache.block_table[slot], np.int64)
        src = torch.from_numpy(np.clip(row, 0, None)).to(self.device)
        dst = torch.from_numpy(np.where(row >= 0, row, self.num_blocks + slot)
                               ).to(self.device)
        one = self.n == 1       # the one-rank pools, seen with n = 1
        for pool, scales, out in ((cache.k_pool, cache.k_scales, self.k_pool),
                                  (cache.v_pool, cache.v_scales, self.v_pool)):
            if one:
                pool, out = pool[:, None], out[:, None]
                scales = None if scales is None else scales[:, None]
            L, n, _, hkv, blk, d = pool.shape
            # (L, n, max_pages, Hkv / n, blk, D)
            pages = byte_view(pool)[:, :, src].view(pool.dtype)
            if scales is not None:
                pages = pages.float() * scales[:, :, src][..., None]
            pages = pages.to(out.dtype).permute(0, 1, 2, 4, 3, 5)
            out.view(L, n, -1, blk, hkv * d)[:, :, dst] = pages.reshape(
                L, n, len(row), blk, hkv * d)

    def _trunk(self, **step):
        """One launch; the trunk's output rows (rank 0's at n ranks, where
        the last all_reduce leaves every rank's alike)."""
        out = self.prog.step(**step)[0]
        return out[0] if self.n > 1 else out

    # -- the batched decode step -----------------------------------------
    def decode(self, toks, cache_lens, block_table, decode_mask,
               generator: torch.Generator | None = None, *,
               sampling: bool = False, temperature: float = 0.0,
               top_k: int = 50):
        """Advance every decoding slot one token in ONE megakernel
        launch. toks, cache_lens, decode_mask: (b_max,) host arrays;
        block_table: the allocator's (b_max, max_pages) host table.
        Returns (b_max,) int32 next tokens on the device (slots that do
        not decode carry garbage the caller masks). Sampling draws from
        `generator` as DenseLLM.decode_step_paged does, over the same
        (b_max, top_k) shape, so a stream sampled here equals the engine
        path's for the same generator state."""
        mask = np.asarray(decode_mask, bool)
        lens = np.where(mask, np.asarray(cache_lens, np.int32), 0)
        tbl = self.kernel_table(torch.from_numpy(
            np.asarray(block_table, np.int32)), torch.from_numpy(mask))
        ids = torch.as_tensor(np.asarray(toks, np.int32), device=self.device)
        x = self.prog.inputs["x"]                 # (n, rows, H) at n ranks
        x[..., ::self.slot_rows, :] = F.embedding(ids, self.embed)
        hid = self._trunk(cache_lens=lens, block_table=tbl,
                          widths=mask.astype(np.int32))
        hid = hid[::self.slot_rows]                    # the live rows
        if sampling:
            return sample_token(hid, self.lm_head, generator,
                                temperature=temperature, top_k=top_k)
        return greedy_token(hid, self.lm_head)

    # -- the batched speculative verify step -------------------------------
    def page_room(self, cache_len: int) -> int:
        """The verify-width budget of a slot at `cache_len`: at most
        slot_rows - cache_len % slot_rows candidate rows this tick (the
        JAX rule, tile_m - cache_len % tile_m, with slot_rows as the
        tile, so the port's ticks equal the JAX engine's when the tiles
        match; the port's row-wise append itself would need no clamp)."""
        return self.slot_rows - int(cache_len) % self.slot_rows

    def verify(self, cands, counts, cache_lens, block_table, decode_mask):
        """Score every decoding slot's candidate rows in ONE megakernel
        launch: cands (b_max, K) ints, row 0 the slot's last real token
        and rows 1..counts[b]-1 its drafts; counts, cache_lens,
        decode_mask (b_max,) and the allocator's block table, host
        arrays. Candidate j of slot b rides trunk row b * slot_rows + j
        at position cache_lens[b] + j; rows past the count are zero and
        the slot's width is counts[b] (0 for a slot that does not
        decode), so ATTN_P attends the prefix plus candidates 0..j, the
        paged append writes the counts[b] rows and a MoE layer routes
        only them. Then lm_head and argmax on the live rows. Returns
        (b_max, K) int32 greedy predictions on the host (pred[b, j] is
        the model's next token after candidate j; 0 where no row ran).
        Refused: K > slot_rows, and a count past the slot's page room
        (`page_room`)."""
        cands = np.asarray(cands, np.int32)
        B, K = cands.shape
        R = self.slot_rows
        if K > R:
            raise ValueError(
                f"verify width {K} exceeds the slot tile (slot_rows={R}): "
                f"candidate rows live in the slot's own trunk rows")
        cnt = np.asarray(counts, np.int32).reshape(-1)
        lens = np.asarray(cache_lens, np.int32).reshape(-1)
        mask = np.asarray(decode_mask, bool).reshape(-1)
        bad = [int(b) for b in np.flatnonzero(mask)
               if cnt[b] > self.page_room(lens[b])]
        if bad:
            raise ValueError(
                f"verify width exceeds the page-room budget for slot(s) "
                f"{bad}: counts {cnt[bad].tolist()} at cache_lens "
                f"{lens[bad].tolist()} (slot_rows={R}) — clamp with "
                f"serve_state.spec_clamp(room=slot_rows - cache_len % "
                f"slot_rows)")
        wid = np.where(mask, cnt, 0).astype(np.int32)
        live = np.arange(K)[None, :] < wid[:, None]              # (B, K)
        tbl = self.kernel_table(torch.from_numpy(
            np.asarray(block_table, np.int32)), torch.from_numpy(mask))
        ids = torch.from_numpy(np.where(live, cands, 0)).to(self.device)
        emb = F.embedding(ids, self.embed)                     # (B, K, H)
        x = self.prog.inputs["x"]
        x = x.view(*x.shape[:-2], B, R, x.shape[-1])
        x[..., :K, :] = torch.where(torch.from_numpy(live).to(self.device)[
            ..., None], emb, 0)
        hid = self._trunk(cache_lens=np.where(mask, lens, 0),
                          block_table=tbl, widths=wid)
        rows = torch.from_numpy((np.arange(B)[:, None] * R
                                 + np.arange(K)[None, :])[live]).to(
                                     self.device)
        pred = np.zeros((B, K), np.int32)
        pred[live] = greedy_token(hid[rows], self.lm_head).cpu().numpy()
        return pred
