"""Tensor-parallel attention: fused qkv projection, optional Qwen3
qk-norm, RoPE, flash attention (prefill) or one-query decode against the
KV cache, o projection (counterpart of
triton_distributed_tpu/layers/tp_attn.py).

The cache buffers passed in — contiguous (B, Smax, Hkv, D) or one
layer's paged pool (num_blocks, Hkv, block, D) — are written in place:
JAX returns updated copies, PyTorch need not hold two caches.

At n ranks (`_prefill_ranks`, `_decode_ranks`) the heads are sharded: rank
r holds H / n query and Hkv / n kv heads, its weights rank-stacked
(parallel/mesh.py: w_qkv (n, hidden, (H + 2 Hkv) D / n), w_o (n, H D / n,
hidden)) and its cache slice ck[r] of a (n, B, Smax, Hkv / n, D) buffer.
Prefill activations are sequence-major, as in the JAX layer, so the
AllGather and ReduceScatter row chunks are sequence chunks. The n ranks'
attention runs as one call of the attention kernels over n * B
sequences. The paged decode, verify and chunked-prefill shards do the
same over the head-sharded paged pool (models/paged_kv_cache.py): a
layer's n rank pools viewed as one, each rank's table offset to its own
pages, one launch for the n ranks. `wire_dtype` ("int8" /
"float8_e4m3fn") quantizes the o projection's collective wire on every
epilogue (row_parallel_out).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.attention import (apply_rope, flash_attention,
                             flash_attention_partial, flash_decode,
                             flash_decode_paged, merge_two_partials,
                             paged_rows, rope_cos_sin)
from ..ops import wire
from ..ops.ag_gemm import ag_gemm_shard
from ..parallel.mesh import RankGroup, shard
from .common import check_mode, row_parallel_out
from .norm import rms_norm
from .tp_mlp import fuse_column_parallel


class TPAttn(nn.Module):
    """params: {"w_qkv": (hidden, (H+2*Hkv)*D) fused column-parallel,
    "w_o": (H*D, hidden) row-parallel, optional "q_norm"/"k_norm": (D,)}."""

    def __init__(self, hidden: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, *, mode: str = "fused",
                 rope_theta: float = 1e6, qk_norm: bool = False,
                 num_ranks: int = 1, wire_dtype=None):
        super().__init__()
        self.hidden = hidden
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.mode = check_mode(mode)
        self.rope_theta = rope_theta
        self.qk_norm = qk_norm
        self.wire_dtype = wire.resolve_wire_dtype(wire_dtype)
        self.n = RankGroup(num_ranks).n
        if num_heads % self.n or num_kv_heads % self.n:
            raise ValueError(f"{num_heads} q / {num_kv_heads} kv heads do not "
                             f"split into {self.n} ranks (replicate kv heads "
                             f"first, as the JAX layer asks)")
        self.h_loc = num_heads // self.n
        self.hkv_loc = num_kv_heads // self.n

    # -- parameters --------------------------------------------------------
    def shard_params(self, wq, wk, wv, wo, q_norm=None, k_norm=None):
        """The fused param dict from plain (in, out) projection matrices,
        rank-stacked at n ranks."""
        qkv = fuse_column_parallel([wq, wk, wv], self.n)
        if self.n > 1:
            qkv, wo = shard(qkv, 1, self.n), shard(wo, 0, self.n)
        params = {"w_qkv": qkv, "w_o": wo}
        if self.qk_norm:
            ones = torch.ones(self.head_dim, dtype=wq.dtype, device=wq.device)
            params["q_norm"] = ones if q_norm is None else q_norm
            params["k_norm"] = ones.clone() if k_norm is None else k_norm
        return params

    def new_kv_cache(self, batch: int, max_len: int, *, dtype, device):
        shape = (batch, max_len, self.num_kv_heads, self.head_dim)
        if self.n > 1:
            shape = (self.n, batch, max_len, self.hkv_loc, self.head_dim)
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))

    def _split_qkv(self, qkv, lead_shape):
        D = self.head_dim
        nq, nkv = self.h_loc * D, self.hkv_loc * D
        q = qkv[..., :nq].reshape(*lead_shape, self.h_loc, D)
        k = qkv[..., nq:nq + nkv].reshape(*lead_shape, self.hkv_loc, D)
        v = qkv[..., nq + nkv:].reshape(*lead_shape, self.hkv_loc, D)
        return q, k, v

    def _maybe_qk_norm(self, params, q, k):
        # rms_norm's own eps (1e-6), not the model's, as in the JAX layer
        if self.qk_norm:
            q = rms_norm(q, params["q_norm"])
            k = rms_norm(k, params["k_norm"])
        return q, k

    # -- prefill -----------------------------------------------------------
    def prefill(self, params, x, kv_cache=None, *, max_len: int | None = None):
        """x: (B, S, hidden), the global activations (at n ranks in the
        "xla" / "fused" modes S % n == 0: rank r takes sequence chunk r).
        Returns (y (B, S, hidden), (k_cache, v_cache)) with positions [0,
        S) filled; the cache is created at `max_len` (default S) when not
        supplied."""
        B, S, _ = x.shape
        if kv_cache is None:
            kv_cache = self.new_kv_cache(B, max_len or S, dtype=x.dtype,
                                         device=x.device)
        if kv_cache[0].shape[-3] < S:
            raise ValueError(f"KV cache length {kv_cache[0].shape[-3]} < "
                             f"prefill length {S}")
        if self.n == 1:
            y, ck, cv = self._prefill_shard(params, x, params["w_qkv"],
                                            params["w_o"], *kv_cache,
                                            seq_len=S)
            return y, (ck, cv)
        xs = x.transpose(0, 1)                            # (S, B, hidden)
        seq = self.mode in ("xla", "fused")
        if seq:
            xs = shard(xs, 0, self.n)                     # (n, S / n, B, .)
        y, ck, cv = self._prefill_ranks(params, xs, params["w_qkv"],
                                        params["w_o"], *kv_cache, seq_len=S)
        if seq:
            y = y.reshape(S, B, self.hidden)
        return y.transpose(0, 1), (ck, cv)

    def _prefill_ranks(self, params, x, w_qkv, w_o, ck, cv, *, seq_len):
        """The n-rank prefill (JAX _prefill_shard :154), sequence-major: x
        is (n, S / n, B, hidden), rank r holding positions [r S / n, (r +
        1) S / n), in the "xla" / "fused" modes, and the replicated (S, B,
        hidden) in "ar" / "gemm_ar"; y comes back in the same layout. ck /
        cv: (n, B, Smax, Hkv / n, D), positions [0, S) written in place."""
        n, D, S, mode = self.n, self.head_dim, seq_len, self.mode
        B = x.shape[-2]
        if mode == "fused":
            qkv = ag_gemm_shard(x.reshape(n, -1, self.hidden), w_qkv,
                                num_ranks=n)
        elif mode == "xla":
            qkv = RankGroup(n).all_gather(x.reshape(n, -1, self.hidden),
                                          tiled=True) @ w_qkv
        else:  # replicated rows
            qkv = x.reshape(-1, self.hidden) @ w_qkv     # (n, S * B, C)
        q, k, v = self._split_qkv(qkv.view(n, S, B, -1), (n, S, B))
        q, k = self._maybe_qk_norm(params, q, k)
        # batch-major (n * B, S, heads, D): the n ranks' sequences in one call
        q, k, v = (t.transpose(1, 2).reshape(n * B, S, -1, D)
                   for t in (q, k, v))
        cos, sin = rope_cos_sin(torch.arange(S, device=x.device), D,
                                theta=self.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        out = flash_attention(q, k, v, causal=True)      # (n * B, S, Hl, D)
        ck[:, :, :S] = k.view(n, B, S, self.hkv_loc, D)
        cv[:, :, :S] = v.view(n, B, S, self.hkv_loc, D)
        om = out.view(n, B, S, -1).transpose(1, 2).reshape(n, S * B, -1)
        y = row_parallel_out(om, w_o, mode=mode, num_ranks=n,
                             wire_dtype=self.wire_dtype)
        return y.view(x.shape), ck, cv

    def _prefill_shard(self, params, x, w_qkv, w_o, ck, cv, *, seq_len):
        B, S = x.shape[0], seq_len
        qkv = x @ w_qkv                                   # (B, S, C)
        q, k, v = self._split_qkv(qkv, (B, S))
        q, k = self._maybe_qk_norm(params, q, k)
        cos, sin = rope_cos_sin(torch.arange(S, device=x.device),
                                self.head_dim, theta=self.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        v = v.contiguous()
        out = flash_attention(q, k, v, causal=True)      # (B, S, Hl, D)
        ck[:, :S] = k
        cv[:, :S] = v
        y = row_parallel_out(out.reshape(B * S, -1), w_o, mode=self.mode,
                             num_ranks=self.n, wire_dtype=self.wire_dtype)
        return y.reshape(B, S, self.hidden), ck, cv

    # -- decode ------------------------------------------------------------
    def decode(self, params, x, kv_cache, kv_len: int):
        """One decode step. x: (B, hidden); kv_cache: pair of
        (B, Smax, Hkv, D) buffers ((n, B, Smax, Hkv / n, D) at n ranks);
        kv_len: tokens already in the cache. Returns (y (B, hidden), cache
        with row kv_len written)."""
        fwd = self._decode_shard if self.n == 1 else self._decode_ranks
        y, ck, cv = fwd(params, x, params["w_qkv"], params["w_o"], *kv_cache,
                        kv_len)
        return y, (ck, cv)

    def _decode_ranks(self, params, x, w_qkv, w_o, ck, cv, kv_len: int):
        """The n-rank decode step (JAX _decode_shard :214): x (B, hidden)
        replicated; ck / cv (n, B, Smax, Hkv / n, D), row kv_len written in
        place; the o projection ends in psum, or gemm_ar in that mode."""
        n, D = self.n, self.head_dim
        B = x.shape[0]
        qkv = x @ w_qkv                                   # (n, B, C)
        q, k, v = self._split_qkv(qkv, (n, B))
        q, k = self._maybe_qk_norm(params, q, k)
        pos = torch.full((1,), kv_len, device=x.device)   # position = kv_len
        cos, sin = rope_cos_sin(pos, D, theta=self.rope_theta)
        q = apply_rope(q[:, :, None], cos, sin)[:, :, 0]  # (n, B, Hl, D)
        k = apply_rope(k[:, :, None], cos, sin)[:, :, 0]
        ck[:, :, kv_len] = k
        cv[:, :, kv_len] = v
        smax = ck.shape[2]
        out = flash_decode(q.reshape(n * B, self.h_loc, D),
                           ck.view(n * B, smax, self.hkv_loc, D),
                           cv.view(n * B, smax, self.hkv_loc, D), kv_len + 1)
        y = row_parallel_out(
            out.view(n, B, -1), w_o,
            mode="gemm_ar" if self.mode == "gemm_ar" else "ar", num_ranks=n,
            wire_dtype=self.wire_dtype)
        return y, ck, cv

    def _decode_shard(self, params, x, w_qkv, w_o, ck, cv, kv_len: int):
        B = x.shape[0]
        qkv = x @ w_qkv                                   # (B, (Hl+2Hkvl)D)
        q, k, v = self._split_qkv(qkv, (B,))
        q, k = self._maybe_qk_norm(params, q, k)
        pos = torch.full((1,), kv_len, device=x.device)   # position = kv_len
        cos, sin = rope_cos_sin(pos, self.head_dim, theta=self.rope_theta)
        q = apply_rope(q[:, None], cos, sin)[:, 0]        # (B, Hl, D)
        k = apply_rope(k[:, None], cos, sin)[:, 0]
        ck[:, kv_len] = k
        cv[:, kv_len] = v
        out = flash_decode(q, ck, cv, kv_len + 1)         # (B, Hl, D)
        y = row_parallel_out(out.reshape(B, -1), w_o, mode=self.mode,
                             num_ranks=self.n, wire_dtype=self.wire_dtype)
        return y, ck, cv

    # -- paged decode and chunked prefill (models/paged_kv_cache.py) -------
    # At n ranks the model hands these one layer's head-sharded pool
    # viewed as (n * nb, Hkv / n, block, D) (PagedKVCache.layer_pools) with
    # its tables, lengths and row destinations laid out for that view
    # (rank r's sequences r * B .. (r + 1) * B - 1), so each attention runs
    # as one kernel launch over the n ranks; the projections end in psum,
    # or gemm_ar in that mode (JAX tp_attn.py:274, :336, :403).

    def _ranks(self):
        """The leading rank dimension of per-rank activations: () at one
        rank."""
        return () if self.n == 1 else (self.n,)

    def _paged_out(self, rows, w_o):
        return row_parallel_out(
            rows, w_o, mode="gemm_ar" if self.mode == "gemm_ar" else "ar",
            num_ranks=self.n, wire_dtype=self.wire_dtype)

    def _decode_shard_paged(self, params, x, w_qkv, w_o, k_pool, v_pool,
                            table, kv_len, rope, at, *, attn_method=None,
                            k_scales=None, v_scales=None):
        """One decode step over ONE layer's paged pool, in place. x:
        (B, hidden) replicated; k_pool/v_pool: (nb, Hkv, block, D) ((n *
        nb, Hkv / n, block, D) at n ranks); table: (B, max_blocks) int32
        and kv_len = seq_lens + active (B,) int32 on the pool's device
        (each (n * B, ...), rank by rank, at n); rope: the (cos, sin) of
        each slot's position (its cached length), (B, 1, D/2) ((n * B, 1,
        D/2)); at: where the active slots' rows land
        (PagedKVCache.append_at, RowsAt.over_ranks at n). Quantized pools
        take their scale sidecars. Returns y (B, hidden)."""
        from ..models.paged_kv_cache import scatter_rows

        B, D, rl = x.shape[0], self.head_dim, self._ranks()
        qkv = x @ w_qkv
        q, k, v = self._split_qkv(qkv, qkv.shape[:-1])
        q, k = self._maybe_qk_norm(params, q, k)
        q = apply_rope(q.reshape(-1, 1, self.h_loc, D), *rope)[:, 0]
        k = apply_rope(k.reshape(-1, 1, self.hkv_loc, D), *rope)[:, 0]
        scatter_rows(k_pool, k, at, scales=k_scales)
        scatter_rows(v_pool, v.reshape(-1, self.hkv_loc, D), at,
                     scales=v_scales)
        out = flash_decode_paged(q, k_pool, v_pool, table, kv_len,
                                 method=attn_method, k_scales=k_scales,
                                 v_scales=v_scales)
        return self._paged_out(out.reshape(*rl, B, -1), w_o)

    def _verify_shard_paged(self, params, x, w_qkv, w_o, k_pool, v_pool,
                            table, kv_len, rope, at, *, attn_method=None,
                            k_scales=None, v_scales=None):
        """One speculative verify step over ONE layer's paged pool, in
        place: slot b feeds K candidate rows (x: (B, K, hidden); rows
        past its count are pad). Row j ropes and appends at position
        seq_lens[b] + j (rope: the (B, K, D/2) cos / sin of those
        positions, (n * B, K, D/2) at n ranks; at: where the live rows
        land, PagedKVCache.verify_at) and attends the slot's prefix plus
        candidates 0..j: every (b, j) is its own paged-decode query over
        the slot's table row (table: (B * K, max_blocks), each row
        repeated K times) with kv_len[b * K + j] = seq_lens[b] + j + 1
        when live, else 0 (a dead row reads no page and gives zeros); at
        n ranks the tables and lengths of the n ranks follow one another.
        counts == 1 everywhere is the decode step. Returns y (B, K,
        hidden)."""
        from ..models.paged_kv_cache import scatter_rows

        B, K, _ = x.shape
        D, rl = self.head_dim, self._ranks()
        qkv = x.reshape(B * K, self.hidden) @ w_qkv
        q, k, v = self._split_qkv(qkv, qkv.shape[:-1])
        q, k = self._maybe_qk_norm(params, q, k)
        q = apply_rope(q.reshape(-1, K, self.h_loc, D), *rope)
        k = apply_rope(k.reshape(-1, K, self.hkv_loc, D), *rope)
        scatter_rows(k_pool, k.reshape(-1, self.hkv_loc, D), at,
                     scales=k_scales)
        scatter_rows(v_pool, v.reshape(-1, self.hkv_loc, D), at,
                     scales=v_scales)
        out = flash_decode_paged(q.reshape(-1, self.h_loc, D),
                                 k_pool, v_pool, table, kv_len,
                                 method=attn_method, k_scales=k_scales,
                                 v_scales=v_scales)
        y = self._paged_out(out.reshape(*rl, B * K, -1), w_o)
        return y.reshape(B, K, self.hidden)

    def _prefill_chunk_shard(self, params, x, w_qkv, w_o, k_pool, v_pool,
                             rope, at, prefix, off: int, valid_len: int, *,
                             k_scales=None, v_scales=None):
        """One prompt chunk of one slot against ONE layer's paged pool:
        x (C, hidden) holds positions [off, off + valid_len) (rows past
        valid_len are pad); its K/V rows land at `at`
        (PagedKVCache.chunk_at, RowsAt.over_ranks at n). Attention merges
        two (out, lse) partials by lse: the causal in-chunk partial over
        the chunk's own (unquantized) K/V, and, when off > 0, a partial
        over the `prefix` pages (device page ids holding positions [0,
        off), rank by rank at n), dequantized and cast to the compute
        dtype for a quantized pool. Each runs as one launch over the n
        ranks. Returns y (C, hidden)."""
        from ..models.paged_kv_cache import scatter_rows

        C, D, rl = x.shape[0], self.head_dim, self._ranks()
        qkv = x @ w_qkv
        q, k, v = self._split_qkv(qkv, qkv.shape[:-1])
        q, k = self._maybe_qk_norm(params, q, k)
        qb = apply_rope(q.reshape(-1, C, self.h_loc, D), *rope)  # (R, C, Hl, D)
        kb = apply_rope(k.reshape(-1, C, self.hkv_loc, D), *rope)
        vb = v.reshape(-1, C, self.hkv_loc, D).contiguous()
        scatter_rows(k_pool, kb.reshape(-1, self.hkv_loc, D), at,
                     scales=k_scales)
        scatter_rows(v_pool, vb.reshape(-1, self.hkv_loc, D), at,
                     scales=v_scales)
        out, lse = flash_attention_partial(
            qb, kb, vb, q_offset=0, kv_offset=0, kv_valid=valid_len,
            causal=True)
        if off:
            # kv_valid = off masks the tail of the last prefix page,
            # which may hold this chunk's own just-written rows
            R = qb.shape[0]
            kpre = paged_rows(k_pool, prefix, scales=k_scales)
            vpre = paged_rows(v_pool, prefix, scales=v_scales)
            o1, l1 = flash_attention_partial(
                qb, kpre.view(R, -1, self.hkv_loc, D).to(qb.dtype),
                vpre.view(R, -1, self.hkv_loc, D).to(qb.dtype),
                q_offset=off, kv_offset=0, kv_valid=off, causal=True)
            out = merge_two_partials(o1, l1, out, lse)[0]
        return self._paged_out(out.reshape(*rl, C, -1).to(x.dtype), w_o)
