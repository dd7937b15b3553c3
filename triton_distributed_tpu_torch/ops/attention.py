"""Attention: prefill flash attention, one-query decode with (out, lse)
partials, rotary embeddings, and the partial merges (counterpart of
triton_distributed_tpu/ops/attention.py).

Layouts follow the JAX package: q (B, Sq, H, D), k/v (B, Skv, Hkv, D),
GQA with kv head h // (H // Hkv); decode q (B, H, D) against a cache
(B, Smax, Hkv, D).

The paged decode reads K/V pages (num_blocks, Hkv, block, D) of one
layer's pool through a (B, max_blocks) block table.

The varlen entries take a PACKED ragged batch, q (T, H, D) and k/v (T,
Hkv, D), whose per-row global segment bounds ride the JAX package's
(T_pad, 128) int32 sideband (`segment_sideband`, bit for bit JAX's).

The kernel-bearing entries (`flash_attention[_partial]`,
`flash_attention_varlen[_partial]`, `flash_decode[_partial]`,
`flash_decode_paged[_partial]`) dispatch on where their tensors lie: a
CPU tensor goes through the plain PyTorch version beside the kernel
(`_flash_attention_plain`, `_flash_attention_varlen_plain`,
`_flash_decode_plain`, `_flash_decode_paged_plain`); a CUDA tensor
launches the hand-written kernel in csrc/ (FLASH_ATTENTION,
FLASH_ATTENTION_VARLEN, FLASH_DECODE, FLASH_DECODE_PAGED[arm], each with
a `launches` count) or raises on a dtype, shape or layout the kernel does
not take. Nothing falls back from one to the other.

Numerical contract, the same for a kernel and its plain version and the
JAX kernels': scores accumulate in f32; masked scores are -1e30 (not
-inf) and contribute nothing, and the denominator is clamped at 1e-30,
so a row that sees no column gives out = 0 and lse ~ -1e30; p is
rounded to the value dtype before the PV product. The prefill kernel
takes q multiplied by the scale in q's dtype; the varlen and decode
kernels scale the f32 scores. The quantized paged decode folds the per-row f32 scales
into the scores (s = q.k_q * k_scale * scale) and the probabilities
(acc += (p * v_scale) v_q) and keeps p in f32, as the JAX kernel does.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..runtime import round_up
from . import wire
from ._build import CudaKernel, ptr, stream_of

_NEG_INF = -1e30

FLASH_ATTENTION = CudaKernel(
    "flash_attention", "tdt_flash_attention_fwd",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
    + [ctypes.c_float, ctypes.c_void_p])
FLASH_ATTENTION_VARLEN = CudaKernel(
    "flash_attention", "tdt_flash_attention_varlen_fwd",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
    + [ctypes.c_float, ctypes.c_void_p])
FLASH_DECODE = CudaKernel(
    "flash_decode", "tdt_flash_decode",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_void_p])
# one entry point per pool dtype (arm) of csrc/flash_decode_paged.cu,
# each with its own launch count
FLASH_DECODE_PAGED = {
    arm: CudaKernel("flash_decode_paged", f"tdt_flash_decode_paged_{sym}",
                    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                    + [ctypes.c_float, ctypes.c_void_p])
    for arm, sym in (("bfloat16", "bf16"), ("int8", "int8"),
                     ("float8_e4m3fn", "fp8"))}

_KERNEL_HEAD_DIMS = (64, 128)
_DECODE_GROUPS = (1, 2, 4, 5, 8, 10)
_PAGED_BLOCKS = tuple(range(32, 257, 32))


def _check_cuda(name, tensors, dtype=torch.bfloat16):
    """Raise unless every tensor is a contiguous, 16-byte aligned
    `dtype` tensor on one CUDA device — what the kernel takes."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: the CUDA kernel takes {dtype}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel takes contiguous "
                             f"tensors")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor not 16-byte aligned")


def _on_cpu(t) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return False


# ---------------------------------------------------------------------------
# Flash attention (prefill)
# ---------------------------------------------------------------------------

def _flash_attention_plain(q, k, v, q_offset, kv_offset, kv_valid, *,
                           causal, scale):
    """Plain PyTorch version of the prefill kernel: the whole score
    matrix at once. Returns (out (B, Sq, H, D) q.dtype, lse (B, Sq, H)
    f32), both contiguous, as the kernel writes them."""
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = H // Hkv
    qs = q * torch.tensor(scale, dtype=q.dtype, device=q.device)
    qg = qs.reshape(B, Sq, Hkv, G, D).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    rows = q_offset + torch.arange(Sq, device=q.device)[:, None]
    cols = torch.arange(Skv, device=q.device)[None, :]
    seen = cols < kv_valid
    if causal:
        seen = seen & (kv_offset + cols <= rows)
    s = torch.where(seen, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(seen, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    out = (o / l.permute(0, 3, 1, 2, 4)).reshape(B, Sq, H, D).to(q.dtype)
    lse = (m + torch.log(l))[..., 0].permute(0, 3, 1, 2).reshape(B, Sq, H)
    return out.contiguous(), lse.contiguous()


def _fa_call(q, k, v, q_offset, kv_offset, kv_valid, *, causal, scale,
             need_lse):
    B, Sq, H, D = q.shape
    Bk, Skv, Hkv, Dk = k.shape
    if (Bk, Dk) != (B, D) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if H % Hkv:
        raise ValueError(f"{H} q heads not a multiple of {Hkv} kv heads")
    kv_valid = Skv if kv_valid is None else int(kv_valid)
    if not 0 <= kv_valid <= Skv:
        raise ValueError(f"kv_valid {kv_valid} outside [0, {Skv}]")
    q_offset, kv_offset = int(q_offset), int(kv_offset)
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    if _on_cpu(q):
        return _flash_attention_plain(q, k, v, q_offset, kv_offset, kv_valid,
                                      causal=causal, scale=scale)
    _check_cuda("flash_attention", (q, k, v))
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in "
                         f"{_KERNEL_HEAD_DIMS}")
    out = torch.empty_like(q)
    lse = (torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
           if need_lse else None)
    if B * Sq * H == 0:
        return out, lse
    # the scale is applied to q in q's dtype (JAX _fa_call :159-161)
    q_scale = float(torch.tensor(scale, dtype=q.dtype))
    FLASH_ATTENTION.launch(
        ptr(q), ptr(k), ptr(v), ptr(out),
        ctypes.c_void_p(lse.data_ptr() if need_lse else 0),
        B, Sq, Skv, H, Hkv, D, q_offset, kv_offset, kv_valid, int(causal),
        q_scale, stream_of(q))
    return out, lse


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None):
    """Flash attention forward. q: (B, Sq, H, D); k, v: (B, Skv, Hkv, D).

    GQA when Hkv divides H. With Sq < Skv (continuation on a cache), the
    causal mask offsets q rows to the *end* of the KV sequence."""
    Sq, Skv = q.shape[1], k.shape[1]
    out, _ = _fa_call(q, k, v, Skv - Sq, 0, Skv, causal=causal, scale=scale,
                      need_lse=False)
    return out


def flash_attention_partial(q, k, v, *, q_offset, kv_offset, kv_valid=None,
                            causal: bool = True, scale: float | None = None):
    """Flash attention over one KV shard of a longer sequence, returning
    (out, lse) partials for a merge.

    q: (B, Sq, H, D), first row at global index `q_offset`. k/v:
    (B, Skv, Hkv, D), first column at global index `kv_offset`; only the
    first `kv_valid` columns are real. Returns out (B, Sq, H, D),
    normalised within the shard, and lse (B, Sq, H) f32."""
    return _fa_call(q, k, v, q_offset, kv_offset, kv_valid, causal=causal,
                    scale=scale, need_lse=True)


# ---------------------------------------------------------------------------
# Varlen (cu_seqlens) flash attention over packed batches
# ---------------------------------------------------------------------------

SIDEBAND_PAD_START = 2**31 - 1  # i32 max: neutral in the min-cull


def row_segments(cu_seqlens, total: int):
    """Per-row (start, end) global bounds from cu_seqlens (B+1,), int32
    (total,) each. Rows past cu_seqlens[-1] get (INT32_MAX, 0): fully
    masked by the per-element mask and neutral in the block culling's
    min(start) / max(end) (JAX attention.py:365)."""
    cu = torch.as_tensor(cu_seqlens).to(torch.int32)
    rows = torch.arange(total, dtype=torch.int32, device=cu.device)
    idx = (torch.searchsorted(cu, rows, right=True) - 1).clamp(
        0, cu.shape[0] - 2)
    start, end = cu[idx], cu[idx + 1]
    valid = rows < cu[-1]
    return (torch.where(valid, start, SIDEBAND_PAD_START).to(torch.int32),
            torch.where(valid, end, 0).to(torch.int32))


def segment_sideband(cu_seqlens, total: int, rows_pad: int | None = None):
    """The (rows_pad, 128) int32 per-row sideband every varlen kernel
    reads: lane 0 = seq_start, lane 1 = seq_end (global rows); padding
    rows get (INT32_MAX, 0). One layout for flash_attention_varlen,
    ring_attention_varlen and the fused sp_ag_attention (JAX :386). On
    cu_seqlens' device (the CPU for a list)."""
    rows_pad = total if rows_pad is None else rows_pad
    start, end = row_segments(cu_seqlens, total)
    meta = torch.zeros((rows_pad, 128), dtype=torch.int32,
                       device=start.device)
    meta[:, 0] = SIDEBAND_PAD_START
    meta[:total, 0] = start
    meta[:total, 1] = end
    return meta


def _varlen_rows(T: int, block_q: int) -> int:
    """JAX's sideband rows for T packed q rows at block_q: round_up(T, bq)
    with bq = min(block_q, round_up(T, 8)) (_fa_varlen_call :404-406)."""
    return round_up(T, min(block_q, round_up(T, 8)))


def _check_blocks(block_q, block_k):
    """block_q / block_k are JAX's Pallas tile sizes. The port takes them
    for the sideband's padding and the dispatch rules they set there; the
    CUDA kernels tile by 64 whatever they are."""
    for name, b in (("block_q", block_q), ("block_k", block_k)):
        if isinstance(b, bool) or int(b) != b or b < 8 or b % 8:
            raise ValueError(f"{name}={b!r}: expected a positive multiple "
                             f"of 8")


def _flash_attention_varlen_plain(q, k, v, qmeta, offs, *, causal, scale):
    """Plain PyTorch version of the varlen kernel: the masked softmax of
    each q row over all its columns at once, in chunks of q rows that keep
    the f32 scores near 1 GiB (a row's softmax needs no other row, so
    chunking leaves every value as it is).
    q (B, T, H, D), k/v (B, Tk, Hkv, D), qmeta (B, >= T, 128) int32, offs
    (B, 3) int (q_offset, kv_offset, kv_valid). Returns (out (B, T, H, D)
    in q's dtype, lse (B, T, H) f32), contiguous."""
    B, T, H, D = q.shape
    _, Tk, Hkv, _ = k.shape
    G = H // Hkv
    dev = q.device
    offs = torch.as_tensor(offs).to(device=dev, dtype=torch.int64)
    q_off, kv_off, kv_valid = (offs[:, i].view(B, 1, 1) for i in range(3))
    seg = qmeta[:, :T, :2].to(device=dev, dtype=torch.int64)
    kf, vf = k.float(), v.float()
    cols = torch.arange(Tk, device=dev).view(1, 1, Tk)
    chunk_rows = max(1, 2**28 // max(1, B * H * Tk))
    out = torch.empty_like(q)
    lse = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    for a in range(0, T, chunk_rows):
        e = min(T, a + chunk_rows)
        rows = q_off + torch.arange(a, e, device=dev).view(1, -1, 1)
        colg = kv_off + cols
        seen = (cols < kv_valid) & (colg >= seg[:, a:e, 0:1]) \
            & (colg < seg[:, a:e, 1:2])
        if causal:
            seen = seen & (colg <= rows)
        seen = seen[:, None, None]                   # (B, 1, 1, rows, Tk)
        qg = q[:, a:e].reshape(B, e - a, Hkv, G, D).float()
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kf) * scale
        s = torch.where(seen, s, _NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(seen, torch.exp(s - m), 0.0)
        lsum = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), vf)
        out[:, a:e] = (o / lsum.permute(0, 3, 1, 2, 4)).reshape(
            B, e - a, H, D).to(q.dtype)
        lse[:, a:e] = (m + torch.log(lsum))[..., 0].permute(
            0, 3, 1, 2).reshape(B, e - a, H)
    return out, lse


def _fa_varlen_call(q, k, v, qmeta, offs, *, causal, scale, need_lse):
    """q (B, T, H, D), k/v (B, Tk, Hkv, D), qmeta (B, >= T, 128) int32
    sideband, offs (B, 3) per-batch-row (q_offset, kv_offset, kv_valid),
    an int32 tensor (on q's device for the kernel) or nested lists."""
    B, T, H, D = q.shape
    Bk, Tk, Hkv, Dk = k.shape
    if (Bk, Dk) != (B, D) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if H % Hkv:
        raise ValueError(f"{H} q heads not a multiple of {Hkv} kv heads")
    if qmeta.dim() != 3 or qmeta.shape[0] != B or qmeta.shape[1] < T \
            or qmeta.shape[2] != 128 or qmeta.dtype != torch.int32:
        raise ValueError(f"qmeta {tuple(qmeta.shape)} {qmeta.dtype} is not "
                         f"a ({B}, >= {T}, 128) int32 sideband")
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    offs = torch.as_tensor(offs, dtype=torch.int32, device=q.device)
    if tuple(offs.shape) != (B, 3):
        raise ValueError(f"offs {tuple(offs.shape)} is not ({B}, 3)")
    if _on_cpu(q):
        out, lse = _flash_attention_varlen_plain(
            q, k, v, qmeta, offs, causal=causal, scale=scale)
        return out, (lse if need_lse else None)
    _check_cuda("flash_attention_varlen", (q, k, v))
    _check_cuda("flash_attention_varlen", (qmeta, offs), torch.int32)
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention_varlen: head_dim {D} not in "
                         f"{_KERNEL_HEAD_DIMS}")
    out = torch.empty_like(q)
    lse = (torch.empty((B, T, H), dtype=torch.float32, device=q.device)
           if need_lse else None)
    if B * T * H == 0 or Tk == 0:
        out.zero_()
        if lse is not None:
            lse.fill_(_NEG_INF)
        return out, lse
    FLASH_ATTENTION_VARLEN.launch(
        ptr(q), ptr(k), ptr(v), ptr(qmeta), ptr(offs), ptr(out),
        ctypes.c_void_p(lse.data_ptr() if need_lse else 0),
        B, T, Tk, H, Hkv, D, qmeta.shape[1], int(causal), float(scale),
        stream_of(q))
    return out, lse


def flash_attention_varlen(q, k, v, cu_seqlens, *, causal: bool = True,
                           scale: float | None = None, block_q: int = 128,
                           block_k: int = 128):
    """Flash attention over a PACKED variable-length batch (JAX :465).

    q: (T, H, D), k/v: (T, Hkv, D): sequences packed back to back;
    cu_seqlens: (B+1,) int row boundaries (cu[0] = 0, cu[B] <= T; rows
    past cu[B] come out 0). Attention is block-diagonal per sequence
    (causal within each when `causal`). block_q / block_k are JAX's tile
    sizes, taken and checked as JAX takes them (they pad the sideband);
    the CUDA kernel's tile is its own 64 x 64. Returns (T, H, D)."""
    _check_blocks(block_q, block_k)
    T = q.shape[0]
    cu = torch.as_tensor(cu_seqlens).to(device=q.device)
    qmeta = segment_sideband(cu, T, _varlen_rows(T, block_q))
    out, _ = _fa_varlen_call(q[None], k[None], v[None], qmeta[None],
                             [[0, 0, k.shape[0]]], causal=causal,
                             scale=scale, need_lse=False)
    return out[0]


def flash_attention_varlen_partial(q, k, v, qmeta, *, q_offset, kv_offset,
                                   kv_valid=None, causal: bool = True,
                                   scale: float | None = None,
                                   block_q: int = 128, block_k: int = 128):
    """Varlen flash attention over ONE KV shard of a globally packed
    sharded batch, returning (out, lse) partials for the cross-shard
    combine (JAX :489). q: (T_loc, H, D), k/v: (Tk, Hkv, D); qmeta:
    (round_up(T_loc, bq), 128) int32 with per-row GLOBAL (seq_start,
    seq_end), bq = min(block_q, round_up(T_loc, 8)) as in JAX. Returns out
    (T_loc, H, D), normalised within the shard, and lse (T_loc, H) f32."""
    _check_blocks(block_q, block_k)
    T, Tk = q.shape[0], k.shape[0]
    want = (_varlen_rows(T, block_q), 128)
    if tuple(qmeta.shape) != want:
        raise ValueError(f"qmeta {tuple(qmeta.shape)} is not {want}")
    kv_valid = Tk if kv_valid is None else int(kv_valid)
    if not 0 <= kv_valid <= Tk:
        raise ValueError(f"kv_valid {kv_valid} outside [0, {Tk}]")
    out, lse = _fa_varlen_call(
        q[None], k[None], v[None], qmeta.to(q.device)[None],
        [[int(q_offset), int(kv_offset), kv_valid]], causal=causal,
        scale=scale, need_lse=True)
    return out[0], lse[0]


# ---------------------------------------------------------------------------
# One-query decode with (out, lse) partials
# ---------------------------------------------------------------------------

def _flash_decode_plain(q, k, v, kv_len, *, scale):
    """Plain PyTorch version of the decode kernel. kv_len: int32 (B,)."""
    B, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * scale
    cols = torch.arange(Skv, device=q.device)
    seen = (cols[None, :] < kv_len[:, None].to(cols.dtype))[:, None, None, :]
    s = torch.where(seen, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(seen, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype).float(), v.float())
    out = (o / l).reshape(B, H, D).to(q.dtype)
    lse = (m + torch.log(l)).reshape(B, H)
    return out, lse


def flash_decode_partial(q, k, v, kv_len, *, scale: float | None = None):
    """One decode step over a (shard of a) KV cache, returning partials.

    q: (B, H, D) single-position queries. k, v: (B, Skv, Hkv, D) cache
    buffers of which the first `kv_len[b]` positions are valid (kv_len
    an int or an int tensor broadcast to (B,)). Returns (out (B, H, D),
    normalised within this shard, lse (B, H) f32)."""
    B, H, D = q.shape
    Bk, Skv, Hkv, Dk = k.shape
    if (Bk, Dk) != (B, D) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if H % Hkv:
        raise ValueError(f"{H} q heads not a multiple of {Hkv} kv heads")
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    if isinstance(kv_len, torch.Tensor):
        kv_len = kv_len.to(device=q.device, dtype=torch.int32).expand(B)
    else:
        kv_len = torch.full((B,), int(kv_len), dtype=torch.int32,
                            device=q.device)
    if _on_cpu(q):
        return _flash_decode_plain(q, k, v, kv_len.clamp(0, Skv),
                                   scale=scale)
    _check_cuda("flash_decode", (q, k, v))
    if D not in _KERNEL_HEAD_DIMS or H // Hkv not in _DECODE_GROUPS:
        raise ValueError(f"flash_decode: head_dim {D} / group {H // Hkv} "
                         f"not in {_KERNEL_HEAD_DIMS} / {_DECODE_GROUPS}")
    kv_len = kv_len.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device)
    if B == 0:
        return out, lse
    FLASH_DECODE.launch(ptr(q), ptr(k), ptr(v), ptr(kv_len), ptr(out),
                        ptr(lse), B, Skv, H, Hkv, D, float(scale),
                        stream_of(q))
    return out, lse


def flash_decode(q, k, v, kv_len, **kwargs):
    """Single-shard decode step: q (B, H, D) against cache k/v. Returns
    (B, H, D)."""
    out, _ = flash_decode_partial(q, k, v, kv_len, **kwargs)
    return out


# ---------------------------------------------------------------------------
# Paged decode: K/V pages read in place through a block table
# ---------------------------------------------------------------------------

def paged_rows(pool, pages, *, scales=None):
    """Contiguous (len(pages) * block, Hkv, D) rows of the given pages of
    ONE layer's pool (nb, Hkv, block, D). With `scales` ((nb, Hkv,
    block) f32) the wire-width pages are dequantized against their
    sidecar rows and come back float32."""
    p = wire.byte_view(pool)[pages].view(pool.dtype)   # (n, Hkv, blk, D)
    if scales is not None:
        p = p.float() * scales[pages][..., None]
    p = p.transpose(1, 2)                              # (n, blk, Hkv, D)
    return p.reshape(-1, *p.shape[2:]).contiguous()   # a view when n = 1


def _flash_decode_paged_plain(q, k_pool, v_pool, block_table, kv_lens, *,
                              scale, k_scales=None, v_scales=None):
    """Plain PyTorch version of the paged decode kernel, the math of the
    JAX `flash_decode_paged_xla`: gather every page of the table (-1
    reads page 0), dequantize a wire-width pool, then a masked f32
    softmax."""
    B, H, D = q.shape
    _, Hkv, blk, _ = k_pool.shape
    G = H // Hkv
    mb = block_table.shape[1]
    pages = block_table.clamp_min(0).reshape(-1).long()
    k = paged_rows(k_pool, pages, scales=k_scales).float()
    v = paged_rows(v_pool, pages, scales=v_scales).float()
    k = k.reshape(B, mb * blk, Hkv, D)
    v = v.reshape(B, mb * blk, Hkv, D)
    qf = q.reshape(B, Hkv, G, D).float() * scale
    s = torch.einsum("bhgd,bshd->bhgs", qf, k)
    cols = torch.arange(mb * blk, device=q.device)
    seen = (cols[None, :] < kv_lens[:, None].to(cols.dtype))[:, None, None]
    s = torch.where(seen, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(seen, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhgs,bshd->bhgd", p / l, v)
    lse = (m + torch.log(l)).reshape(B, H)
    return out.reshape(B, H, D).to(q.dtype), lse


def flash_decode_paged_partial(q, k_pool, v_pool, block_table, kv_lens, *,
                               scale: float | None = None, k_scales=None,
                               v_scales=None):
    """One decode step against a PAGED cache, reading pages in place.

    q: (B, H, D) single-position queries. k_pool/v_pool: (num_blocks,
    Hkv, block, D) ONE layer's pool (the models/paged_kv_cache.py
    layout). block_table: (B, max_blocks) int pool indices (-1 =
    unassigned; inside kv_len it reads page 0, as the JAX index map
    clamps); kv_lens: (B,) valid tokens per sequence, or an int. Pages
    past a sequence's end are never read. `k_scales`/`v_scales`
    ((num_blocks, Hkv, block) f32) make it the quantized form over an
    int8 / float8_e4m3fn pool. Returns (out (B, H, D), lse (B, H) f32).

    On CUDA tensors it launches the kernel of the pool's dtype
    (FLASH_DECODE_PAGED: bf16, int8 or fp8 arm) and raises on what the
    kernel does not take: head_dim outside (64, 128), a group size
    outside _DECODE_GROUPS, a block not a multiple of 32 in [32, 256]."""
    B, H, D = q.shape
    nbp, Hkv, blk, Dk = k_pool.shape
    if v_pool.shape != k_pool.shape or Dk != D or H % Hkv \
            or tuple(block_table.shape[:1]) != (B,):
        raise ValueError(f"q {tuple(q.shape)}, pools {tuple(k_pool.shape)} "
                         f"/ {tuple(v_pool.shape)}, table "
                         f"{tuple(block_table.shape)} do not match")
    quant = k_scales is not None
    if quant != (v_scales is not None) \
            or quant != (k_pool.dtype in wire.TORCH_WIRE_DTYPES.values()):
        raise ValueError("a wire-dtype pool takes both scale sidecars, "
                         "any other pool neither")
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    if isinstance(kv_lens, torch.Tensor):
        kv_lens = kv_lens.to(device=q.device, dtype=torch.int32).expand(B)
    else:
        kv_lens = torch.full((B,), int(kv_lens), dtype=torch.int32,
                             device=q.device)
    block_table = block_table.to(device=q.device, dtype=torch.int32)
    if _on_cpu(q):
        return _flash_decode_paged_plain(
            q, k_pool, v_pool, block_table, kv_lens, scale=scale,
            k_scales=k_scales, v_scales=v_scales)
    arm = str(k_pool.dtype).removeprefix("torch.")
    if arm not in FLASH_DECODE_PAGED:
        raise TypeError(f"flash_decode_paged: no kernel for a "
                        f"{k_pool.dtype} pool")
    _check_cuda("flash_decode_paged", (q,))
    _check_cuda("flash_decode_paged", (k_pool, v_pool), k_pool.dtype)
    if quant:
        _check_cuda("flash_decode_paged", (k_scales, v_scales),
                    torch.float32)
    kv_lens = kv_lens.contiguous()
    block_table = block_table.contiguous()
    if D not in _KERNEL_HEAD_DIMS or H // Hkv not in _DECODE_GROUPS \
            or blk not in _PAGED_BLOCKS:
        raise ValueError(
            f"flash_decode_paged: head_dim {D} / group {H // Hkv} / block "
            f"{blk} not in {_KERNEL_HEAD_DIMS} / {_DECODE_GROUPS} / "
            f"multiples of 32 up to 256")
    out = torch.empty_like(q)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device)
    if B == 0:
        return out, lse
    null = ctypes.c_void_p(0)
    FLASH_DECODE_PAGED[arm].launch(
        ptr(q), ptr(k_pool), ptr(v_pool),
        ptr(k_scales) if quant else null, ptr(v_scales) if quant else null,
        ptr(block_table), ptr(kv_lens), ptr(out), ptr(lse),
        B, nbp, H, Hkv, D, blk, block_table.shape[1], float(scale),
        stream_of(q))
    return out, lse


def flash_decode_paged(q, k_pool, v_pool, block_table, kv_lens, *,
                       scale: float | None = None,
                       method: str | None = None, k_scales=None,
                       v_scales=None):
    """Paged decode step; returns out (B, H, D). `method` None or
    "kernel" reads pages in place (the kernel on CUDA, its plain version
    on the CPU); "xla", the JAX package's gather path, is the plain
    version, which the port runs on the CPU only (on the card it is the
    watchdog's demotion rung, ROADMAP Queue A slice 2c)."""
    if method not in (None, "kernel", "xla"):
        raise ValueError(f"method {method!r}: choose 'kernel' or 'xla'")
    if method == "xla" and not _on_cpu(q):
        raise NotImplementedError(
            "flash_decode_paged(method='xla') on a CUDA device is the "
            "demotion rung of the serving watchdog (ROADMAP Queue A, "
            "slice 2c)")
    return flash_decode_paged_partial(
        q, k_pool, v_pool, block_table, kv_lens, scale=scale,
        k_scales=k_scales, v_scales=v_scales)[0]


# ---------------------------------------------------------------------------
# Partial merges
# ---------------------------------------------------------------------------

def merge_two_partials(o1, l1, o2, l2):
    """Merge two (out, lse) partials into one. Returns the merged out in
    f32 (cast once after the last merge) and the merged lse."""
    m = torch.maximum(l1, l2)
    w1 = torch.exp(l1 - m)
    w2 = torch.exp(l2 - m)
    denom = (w1 + w2).clamp_min(1e-30)
    out = (w1[..., None] * o1.float()
           + w2[..., None] * o2.float()) / denom[..., None]
    return out, m + torch.log(denom)


def combine_partials(outs, lses):
    """Combine per-shard (out, lse) partials stacked on axis 0: outs
    (R, ..., D), lses (R, ...)."""
    m = lses.amax(dim=0, keepdim=True)
    w = torch.exp(lses - m)
    denom = w.sum(dim=0).clamp_min(1e-30)
    num = (w[..., None] * outs.float()).sum(dim=0)
    return (num / denom[..., None]).to(outs.dtype)


def combine_partials_with_lse(outs, lses):
    """`combine_partials` that also returns the combined lse, so the
    result can keep folding into further merges (the sequence-parallel
    prefill combines the ranks' prefix partials, then merges the result
    with the in-chunk partial). Returns (out f32, lse)."""
    m = lses.amax(dim=0)
    w = torch.exp(lses - m[None])
    denom = w.sum(dim=0).clamp_min(1e-30)
    num = (w[..., None] * outs.float()).sum(dim=0)
    return num / denom[..., None], m + torch.log(denom)


# ---------------------------------------------------------------------------
# Rotary embeddings and the naive reference
# ---------------------------------------------------------------------------

def rope_cos_sin(positions, head_dim: int, theta: float = 1e6,
                 dtype=torch.float32):
    """cos/sin tables for rotate-half RoPE. positions: (...,) int tensor.
    Returns (cos, sin) of shape (..., head_dim // 2)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv_freq
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x, cos, sin):
    """Rotate-half RoPE. x: (B, S, H, D); cos/sin: (S, D/2) or (B, S, D/2),
    cast to x.dtype before the rotation."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 2:          # (S, D/2) -> broadcast over batch and heads
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:                      # (B, S, D/2)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    cos = cos.to(x.dtype)
    sin = sin.to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def mha_reference(q, k, v, *, causal: bool = True, scale=None):
    """Naive attention in f32 (test golden)."""
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = H // Hkv
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    if causal:
        rows = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
        cols = torch.arange(Skv, device=q.device)[None, :]
        s = torch.where(cols <= rows, s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)
