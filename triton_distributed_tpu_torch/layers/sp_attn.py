"""Sequence-parallel attention layers (counterpart of
triton_distributed_tpu/layers/sp_attn.py): `SPPagedAttn` over the
sequence-sharded paged KV cache, `SpFlashDecodeAttention` over a
sequence-sharded contiguous cache, and `UlyssesAttn`, attention re-sharded
from sequence to heads and back around one flash-attention launch.

`SpFlashDecodeAttention` takes activations only: q replicated, the caches
global with their positions split over the ranks, as `sp_flash_decode`
takes them. `UlyssesAttn` keeps JAX's parameter layouts ({"w_qkv":
(hidden, n, C), "w_o": (n, C, hidden)}, replicated, kept once; JAX params
come across through `ulysses_params_from_jax`) and runs on global
activations: its qkv all-to-all hands each rank its heads over the whole
sequence, every rank's RoPE'd q / k / v go through one flash-attention
launch (the ranks as its batch), and the o all-to-all sums the head blocks
back onto each rank's rows.

The rest of this docstring is `SPPagedAttn`'s.

Rank r's pool partition holds the pages of positions [r rank_tokens, (r +
1) rank_tokens) of every slot (models/paged_kv_cache.py, `sp_ranks`).
Weights are replicated, kept once, but arrive in the fused column layout
the tensor-parallel layers use at n ranks ([q_r | k_r | v_r] groups, rank
by rank), so one parameter dict serves either parallelism; the layer
regroups the fused projection's output columns back to the original head
order (`_unfuse`, the same product as un-fusing the weight, without a
copy of it). Per step the only cross-rank traffic is the decode partial
combine and the prefill's partial gathers; the projections and the MLP
run replicated.

The n ranks run in one process on one device, rank-stacked
(parallel/mesh.py), with the module's arguments laid out by the model
(DenseLLM, attn_parallelism="sp"): the decode step's per-rank tables
(PagedKVCache.sp_tables) and local lengths, the row destinations the
ownership filter kept (PagedKVCache.append_at / chunk_at), and the
chunk's prefix pages (`SPPrefix`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from .. import runtime
from ..models.convert import _leaf
from ..ops.attention import (apply_rope, combine_partials_with_lse,
                             flash_attention, flash_attention_partial,
                             merge_two_partials, mha_reference, paged_rows,
                             rope_cos_sin)
from ..ops.sp_attention import (_check_combine, ring_attention_shard,
                                sp_flash_decode, sp_flash_decode_paged_shard)
from ..ops.ulysses import (_check_method, arrange_o_for_ulysses,
                           arrange_qkv_for_ulysses, ulysses_o_a2a_shard,
                           ulysses_qkv_a2a_shard)
from ..parallel.mesh import RankGroup, shard, unshard
from .norm import rms_norm


@dataclasses.dataclass
class SPPrefix:
    """The cached prefix [0, off) of a prefill chunk's slot, by owner: the
    `full` ranks 0 .. full - 1 hold all rank_tokens of their ranges, in
    `full_pages` ((full * bpr,) device ids, rank by rank); rank `full`
    holds the first `part` tokens of its range in `part_pages`."""
    full: int
    full_pages: torch.Tensor | None
    part: int
    part_pages: torch.Tensor | None

    @staticmethod
    def of(table_row, off: int, rank_tokens: int, block: int, device):
        """From the slot's host table row (global ids) and the prefix
        length `off`."""
        full, part = divmod(int(off), rank_tokens)
        bpr = rank_tokens // block
        row = np.clip(np.asarray(table_row), 0, None).astype(np.int64)

        def dev(a):
            return torch.from_numpy(a).to(device) if a.size else None

        return SPPrefix(full, dev(row[:full * bpr]), part,
                        dev(row[full * bpr:full * bpr + -(-part // block)]))


class SPPagedAttn(nn.Module):
    """Sequence-parallel attention of a DenseLLM(attn_parallelism="sp")
    over n ranks. params as TPAttn's at n ranks, replicated: {"w_qkv":
    (hidden, (H + 2 Hkv) D) in the n-rank fused layout, "w_o": (H D,
    hidden), optional "q_norm" / "k_norm": (D,)}. `combine` is the decode
    partials' transport, "xla" or "ll"."""

    def __init__(self, hidden: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, *, num_ranks: int, rope_theta: float = 1e6,
                 qk_norm: bool = False, combine: str = "xla"):
        super().__init__()
        self.hidden = hidden
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.n = RankGroup(num_ranks).n
        self.rope_theta = rope_theta
        self.qk_norm = qk_norm
        self.combine = _check_combine(combine)
        if num_heads % self.n or num_kv_heads % self.n:
            raise ValueError(f"{num_heads} q / {num_kv_heads} kv heads do not "
                             f"split into {self.n} ranks")

    # -- fused-layout helpers ---------------------------------------------
    def _unfuse(self, y, widths):
        """Undo `fuse_column_parallel` on the last axis: y's columns are
        laid out [m0_0|m1_0|..|m0_1|..] over n shard groups; return each
        matrix's columns in their original order."""
        g = y.reshape(*y.shape[:-1], self.n, sum(widths))
        outs, o = [], 0
        for width in widths:
            outs.append(g[..., o:o + width].reshape(*y.shape[:-1], -1))
            o += width
        return outs

    def _project_qkv(self, params, x, w_qkv):
        D = self.head_dim
        nq = (self.num_heads // self.n) * D
        nkv = (self.num_kv_heads // self.n) * D
        q, k, v = self._unfuse(x @ w_qkv, (nq, nkv, nkv))
        T = x.shape[0]
        q = q.reshape(T, self.num_heads, D)
        k = k.reshape(T, self.num_kv_heads, D)
        v = v.reshape(T, self.num_kv_heads, D)
        if self.qk_norm:
            q = rms_norm(q, params["q_norm"])
            k = rms_norm(k, params["k_norm"])
        return q, k, v

    # -- decode ------------------------------------------------------------
    def _decode_shard_paged(self, params, x, w_qkv, w_o, k_pool, v_pool,
                            tables, kv_local, rope, at):
        """One decode step over ONE layer's pool (nb, Hkv, block, D), the n
        partitions one after another, in place. x: (B, hidden)
        replicated; tables: (n, B, bpr) each rank's columns of the table
        (global ids); kv_local: (n, B) int32 valid tokens of each rank's
        range, seq_lens + active clipped to it; rope: (B, 1, D/2) of each
        slot's position; at: the active slots' rows, on their owners'
        pages only (PagedKVCache.append_at). Each rank's split-KV partial
        over its pages, then the partials' combine. Returns y (B, hidden)
        replicated."""
        from ..models.paged_kv_cache import scatter_rows

        B = x.shape[0]
        q, k, v = self._project_qkv(params, x, w_qkv)
        q = apply_rope(q[:, None], *rope)[:, 0]                # (B, H, D)
        k = apply_rope(k[:, None], *rope)[:, 0]
        scatter_rows(k_pool, k, at)
        scatter_rows(v_pool, v, at)
        out = sp_flash_decode_paged_shard(
            q, k_pool, v_pool, tables, kv_local, num_ranks=self.n,
            combine=self.combine)
        return out.reshape(B, -1).to(x.dtype) @ w_o

    # -- chunked prefill ---------------------------------------------------
    def _prefill_chunk_shard(self, params, x, w_qkv, w_o, k_pool, v_pool,
                             rope, at, prefix: SPPrefix | None,
                             off: int, valid_len: int, *, rank_tokens: int):
        """One prompt chunk of one slot: x (C, hidden) replicated holds
        positions [off, off + valid_len) (C % n == 0; the chunk lies in
        one rank's ownership range, PagedKVCache.sp_owner). Its K/V rows
        land on the owner's pages (`at`). The in-chunk causal attention
        is ring attention over the n ranks' C / n-row slices (pad rows sit
        at the chunk's tail, so causality keeps real rows off them); with
        a cached prefix, each rank attends the whole chunk's q to its own
        prefix pages, the ranks' partials combine
        (`combine_partials_with_lse`, rank order) and merge with each
        rank's ring partial; the rows then gather back. A rank that holds
        none of the prefix has an all-masked partial of merge weight 0
        and is left out. Returns y (C, hidden) replicated."""
        from ..models.paged_kv_cache import scatter_rows

        C = x.shape[0]
        n, D = self.n, self.head_dim
        if C % n:
            raise ValueError(f"chunk of {C} rows does not split over {n} "
                             f"ranks")
        c_loc = C // n
        q, k, v = self._project_qkv(params, x, w_qkv)
        qb = apply_rope(q[None], *rope)                       # (1, C, H, D)
        kb = apply_rope(k[None], *rope)
        scatter_rows(k_pool, kb[0], at)
        scatter_rows(v_pool, v, at)

        def ranks(t):   # (1, C, ...) -> (n, 1, C / n, ...): rank slices
            return t.view(1, n, c_loc, *t.shape[2:]).transpose(0, 1)

        o2, l2 = ring_attention_shard(
            ranks(qb).contiguous(), ranks(kb).contiguous(),
            ranks(v[None]).contiguous(), num_ranks=n, causal=True,
            return_lse=True)                                # (n, 1, c_loc, ..)
        if prefix is not None:
            o1, l1 = self._prefix_partials(qb, k_pool, v_pool, prefix, off,
                                           rank_tokens)
            o1c, l1c = combine_partials_with_lse(o1, l1)  # (1, C, H, D)
            o2 = merge_two_partials(ranks(o1c), ranks(l1c), o2, l2)[0]
        out = o2.transpose(0, 1).reshape(C, -1)           # rows gathered
        return out.to(x.dtype) @ w_o

    def _prefix_partials(self, qb, k_pool, v_pool, prefix: SPPrefix,
                         off: int, rank_tokens: int):
        """The prefix partials of the ranks holding any of [0, off): (R, 1,
        C, H, D) / (R, 1, C, H) in rank order, R = full + (part > 0). The
        full ranks run as one launch over the chunk's q repeated."""
        D, hkv = self.head_dim, self.num_kv_heads
        outs, lses = [], []
        if prefix.full:
            f = prefix.full
            kpre = paged_rows(k_pool, prefix.full_pages).view(f, -1, hkv, D)
            vpre = paged_rows(v_pool, prefix.full_pages).view(f, -1, hkv, D)
            qf = qb.expand(f, *qb.shape[1:]).contiguous()
            # every key of these ranks precedes every query: kv_offset 0
            # gives the same (empty) causal mask as each rank's own offset
            o, l = flash_attention_partial(
                qf, kpre.to(qb.dtype), vpre.to(qb.dtype), q_offset=off,
                kv_offset=0, kv_valid=rank_tokens, causal=True)
            outs.append(o[:, None])
            lses.append(l[:, None])
        if prefix.part:
            kpre = paged_rows(k_pool, prefix.part_pages)[None]
            vpre = paged_rows(v_pool, prefix.part_pages)[None]
            o, l = flash_attention_partial(
                qb, kpre.to(qb.dtype), vpre.to(qb.dtype), q_offset=off,
                kv_offset=prefix.full * rank_tokens, kv_valid=prefix.part,
                causal=True)
            outs.append(o[:, None])
            lses.append(l[:, None])
        return torch.cat(outs), torch.cat(lses)


@dataclasses.dataclass
class SpFlashDecodeAttention:
    """Decode-time attention over a sequence-sharded KV cache (JAX :32):
    each rank owns a contiguous range of positions; a decode step runs
    every rank's split-KV partial in one launch and combines the (out, lse)
    partials, "xla" (gather + merge) or "ll" (the one-shot kernel,
    csrc/ll_combine.cu)."""

    num_heads: int
    num_kv_heads: int
    head_dim: int
    num_ranks: int
    block_k: int = 256
    combine: str = "xla"

    def __post_init__(self):
        self.n = RankGroup(self.num_ranks).n
        _check_combine(self.combine)

    def __call__(self, q, k_cache, v_cache, kv_len):
        """q: (B, H, D) replicated; k / v_cache: (B, Skv, Hkv, D), positions
        split over the ranks; kv_len: an int or (B,) global valid length.
        Returns (B, H, D)."""
        if tuple(q.shape[1:]) != (self.num_heads, self.head_dim):
            raise ValueError(f"q {tuple(q.shape)} != (B, {self.num_heads}, "
                             f"{self.head_dim})")
        if k_cache.shape[2] != self.num_kv_heads:
            raise ValueError(f"k_cache has {k_cache.shape[2]} kv heads, "
                             f"layer configured for {self.num_kv_heads}")
        return sp_flash_decode(q, k_cache, v_cache, kv_len,
                               num_ranks=self.n, block_k=self.block_k,
                               combine=self.combine)


def ulysses_params_from_jax(tree, *, device=None):
    """The JAX UlyssesAttn's params ({"w_qkv": (hidden, n, C), "w_o": (n,
    C, hidden)} as numpy, bf16 arriving as ml_dtypes) as the port's, each
    at its own dtype on `device` (the GPU unless given)."""
    device = runtime.resolve_device(device)
    return {name: _leaf(tree[name], device) for name in ("w_qkv", "w_o")}


class UlyssesAttn(nn.Module):
    """Ulysses SP attention block (JAX :266): fused qkv + all-to-all ->
    RoPE -> causal flash attention over the full sequence on each rank's
    head block -> fused all-to-all + o projection. Activations enter and
    leave as global (S, hidden) tensors whose rows the ranks split; num_heads
    and num_kv_heads must split over the ranks."""

    def __init__(self, hidden: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, *, num_ranks: int, rope_theta: float = 1e6,
                 method: str = "ring"):
        super().__init__()
        self.hidden = hidden
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.n = RankGroup(num_ranks).n
        self.rope_theta = rope_theta
        self.method = _check_method(method)
        if num_heads % self.n or num_kv_heads % self.n:
            raise ValueError(f"{num_heads} q / {num_kv_heads} kv heads do not "
                             f"split into {self.n} ranks")

    # -- parameters --------------------------------------------------------
    def init_params(self, generator=None, dtype=torch.bfloat16, device=None):
        """Random weights (normal, scaled by fan-in) in the layer's layout,
        on `device` (the GPU unless given)."""
        device = runtime.resolve_device(device)
        h, d = self.hidden, self.head_dim

        def draw(rows, cols, fan):
            w = torch.randn((rows, cols), generator=generator, device=device,
                            dtype=torch.float32)
            return (w * fan ** -0.5).to(dtype)

        return self.shard_params(draw(h, self.num_heads * d, h),
                                 draw(h, self.num_kv_heads * d, h),
                                 draw(h, self.num_kv_heads * d, h),
                                 draw(self.num_heads * d, h,
                                      self.num_heads * d))

    def shard_params(self, w_q, w_k, w_v, w_o):
        """Pre-arrange the weights into the per-peer block layouts the
        all-to-alls consume (replicated: Ulysses shards the sequence, not
        the weights)."""
        return {"w_qkv": arrange_qkv_for_ulysses(w_q, w_k, w_v, self.n),
                "w_o": arrange_o_for_ulysses(w_o, self.n)}

    # -- forward -----------------------------------------------------------
    def forward(self, params, x):
        """x: (S, hidden), rows split over the ranks (S % n == 0). Returns
        (S, hidden)."""
        n, d = self.n, self.head_dim
        hq, hkv = self.num_heads // n, self.num_kv_heads // n
        s_full = x.shape[0]
        qkv = ulysses_qkv_a2a_shard(shard(x, 0, n), params["w_qkv"],
                                    num_ranks=n, method=self.method)
        q = qkv[..., :hq * d].reshape(n, s_full, hq, d)
        k = qkv[..., hq * d:(hq + hkv) * d].reshape(n, s_full, hkv, d)
        v = qkv[..., (hq + hkv) * d:].reshape(n, s_full, hkv, d)
        cos, sin = rope_cos_sin(torch.arange(s_full, device=x.device), d,
                                self.rope_theta)
        q = apply_rope(q, cos, sin).contiguous()
        k = apply_rope(k, cos, sin).contiguous()
        o = flash_attention(q, k, v.contiguous(), causal=True)
        y = ulysses_o_a2a_shard(o.reshape(n, s_full, hq * d), params["w_o"],
                                num_ranks=n, method=self.method)
        return unshard(y, 0)

    # -- golden ------------------------------------------------------------
    def reference_forward(self, params, x):
        """One-device golden: the plain qkv projection, RoPE, causal
        attention in f32 and the o projection over the full sequence."""
        n, d = self.n, self.head_dim
        s_full = x.shape[0]
        w_qkv, w_o = params["w_qkv"], params["w_o"]
        hq, hkv = self.num_heads // n, self.num_kv_heads // n
        qs, ks, vs = [], [], []
        for p in range(n):
            blk = x @ w_qkv[:, p]
            qs.append(blk[:, :hq * d].reshape(s_full, hq, d))
            ks.append(blk[:, hq * d:(hq + hkv) * d].reshape(s_full, hkv, d))
            vs.append(blk[:, (hq + hkv) * d:].reshape(s_full, hkv, d))
        q = torch.cat(qs, dim=1)[None]
        k = torch.cat(ks, dim=1)[None]
        v = torch.cat(vs, dim=1)[None]
        cos, sin = rope_cos_sin(torch.arange(s_full, device=x.device), d,
                                self.rope_theta)
        o = mha_reference(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v,
                          causal=True)[0]
        blocks = o.reshape(s_full, n, hq * d)
        out = sum(blocks[:, p] @ w_o[p] for p in range(n))
        return out.to(x.dtype)
