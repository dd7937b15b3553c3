"""Attention: prefill flash attention, one-query decode with (out, lse)
partials, rotary embeddings, and the partial merges (counterpart of
triton_distributed_tpu/ops/attention.py).

Layouts follow the JAX package: q (B, Sq, H, D), k/v (B, Skv, Hkv, D),
GQA with kv head h // (H // Hkv); decode q (B, H, D) against a cache
(B, Smax, Hkv, D).

The two kernel-bearing entries (`flash_attention[_partial]`,
`flash_decode[_partial]`) dispatch on where their tensors lie: a CPU
tensor goes through the plain PyTorch version beside the kernel
(`_flash_attention_plain`, `_flash_decode_plain`); a CUDA tensor
launches the hand-written kernel in csrc/ (FLASH_ATTENTION,
FLASH_DECODE, each with a `launches` count) or raises on a dtype, shape
or layout the kernel does not take. Nothing falls back from one to the
other.

Numerical contract, the same for a kernel and its plain version and the
JAX kernels': scores accumulate in f32; masked scores are -1e30 (not
-inf) and contribute nothing, and the denominator is clamped at 1e-30,
so a row that sees no column gives out = 0 and lse ~ -1e30; p is
rounded to the value dtype before the PV product. The prefill kernel
takes q multiplied by the scale in q's dtype; the decode kernel scales
the f32 scores.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ._build import CudaKernel, ptr, stream_of

_NEG_INF = -1e30

FLASH_ATTENTION = CudaKernel(
    "flash_attention", "tdt_flash_attention_fwd",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
    + [ctypes.c_float, ctypes.c_void_p])
FLASH_DECODE = CudaKernel(
    "flash_decode", "tdt_flash_decode",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_void_p])

_KERNEL_HEAD_DIMS = (64, 128)
_DECODE_GROUPS = (1, 2, 4, 5, 8, 10)


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
    f32)."""
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
    return out, lse


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
