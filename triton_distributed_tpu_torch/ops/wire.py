"""The wire codecs as torch ops (counterpart of the per-row and per-block
parts of triton_distributed_tpu/ops/wire.py).

Per row (`wire_quant` / `wire_dequant`): each row of the last dim is
scaled by its own absmax into the wire dtype with one f32 scale, the
codec of the expert-parallel all-to-all's quantized wire (ops/ep_a2a.py).

Per block: a (…, H) float tensor is cut into `block`-wide slices of its last dim;
each slice is scaled by its own absmax into a wire dtype ("int8",
symmetric round-half-to-even, or "float8_e4m3fn") and carries one f32
scale. The paged KV pool stores K/V rows this way with block = head_dim
(models/paged_kv_cache.py::quant_kv). Payload bytes and scales equal the
JAX codec's exactly: the same f32 division, `torch.round` rounds half to
even as `jnp.round` does, and fp8 conversion rounds to nearest even
(in range; the codec never leaves it).
"""

from __future__ import annotations

import torch

# Max representable magnitude per wire dtype (int8 symmetric keeps -128
# unused).
WIRE_MAX = {"float8_e4m3fn": 448.0, "int8": 127.0}

# Per-element quantization error as a fraction of the scaling block's
# absmax (round-to-nearest): int8 scale/2 = amax / 254; e4m3 has 3
# mantissa bits, so |err| <= |v| * 2^-4 <= amax * 2^-4.
QUANT_EPS = {"int8": 0.5 / 127.0, "float8_e4m3fn": 2.0 ** -4}

# Default scaling-block width (last-dim elements per f32 scale).
WIRE_BLOCK = 256

TORCH_WIRE_DTYPES = {"int8": torch.int8,
                     "float8_e4m3fn": torch.float8_e4m3fn}


def resolve_wire_dtype(wire_dtype) -> str | None:
    """Canonical wire-dtype name ("int8" / "float8_e4m3fn") or None, from
    a name or a torch dtype."""
    if wire_dtype is None:
        return None
    if isinstance(wire_dtype, torch.dtype):
        name = str(wire_dtype).removeprefix("torch.")
    else:
        name = str(wire_dtype)
    if name not in WIRE_MAX:
        raise ValueError(f"unsupported wire dtype {name!r}; choose from "
                         f"{sorted(WIRE_MAX)}")
    return name


def resolve_block(width: int, block: int | None = None) -> int:
    """The scaling block for a `width`-wide row: min(block, width),
    raising when it does not divide the row (quantizing anyway would
    mis-scale the ragged tail)."""
    blk = min(block or WIRE_BLOCK, width)
    if width % blk:
        raise ValueError(
            f"scaling block {block} does not divide row width {width}; "
            f"pick a divisor (or None for min({WIRE_BLOCK}, width))")
    return blk


def wire_quant(buf, wire_dtype):
    """(..., H) payload -> (quantized payload in the wire dtype, (...,) f32
    per-row scale): symmetric per-row scaling (JAX wire_quant :100)."""
    name = resolve_wire_dtype(wire_dtype)
    f = buf.float()
    amax = f.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp_min(1e-30) / WIRE_MAX[name]
    q = f / scale
    if name == "int8":
        q = torch.round(q)
    return q.to(TORCH_WIRE_DTYPES[name]), scale[..., 0]


def wire_dequant(q, scale, dtype):
    """Inverse of `wire_quant` (JAX wire_dequant :115)."""
    return (q.float() * scale[..., None]).to(dtype)


def quant_blockwise(x, wire_dtype, block: int | None = None):
    """(…, H) -> (q (…, H) wire dtype, scales (…, H/block) f32), scaling
    each `block`-wide slice of the last dim by its own absmax."""
    name = resolve_wire_dtype(wire_dtype)
    blk = resolve_block(x.shape[-1], block)
    f = x.float().reshape(*x.shape[:-1], -1, blk)
    amax = f.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp_min(1e-30) / WIRE_MAX[name]
    q = f / scale
    if name == "int8":
        q = torch.round(q)
    return (q.to(TORCH_WIRE_DTYPES[name]).reshape(x.shape),
            scale[..., 0])


def dequant_blockwise(q, scales, dtype, block: int | None = None):
    """Inverse of `quant_blockwise`; `scales` is (…, H/block) f32."""
    blk = q.shape[-1] // scales.shape[-1]
    if q.shape[-1] != scales.shape[-1] * blk or block not in (None, blk):
        raise ValueError(f"payload {tuple(q.shape)} and scales "
                         f"{tuple(scales.shape)} disagree (block {block})")
    f = q.float().reshape(*q.shape[:-1], scales.shape[-1], blk)
    return (f * scales[..., None]).reshape(q.shape).to(dtype)


def checksum_blocks(q, block: int | None = None):
    """(…, H) wire payload -> (…, H/block) int32 per-block byte-sum
    checksum (payload bytes read as int8, summed in int32)."""
    blk = resolve_block(q.shape[-1], block)
    b = q.contiguous().view(torch.int8).to(torch.int32)
    return b.reshape(*q.shape[:-1], -1, blk).sum(dim=-1, dtype=torch.int32)


def byte_view(t):
    """Byte view of an fp8 tensor, so copies and indexing of a payload do
    not depend on an op's fp8 support; any other tensor as it is."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t
