"""The wire codecs as torch ops (counterpart of
triton_distributed_tpu/ops/wire.py, all but its checksum ladder).

Per row (`wire_quant` / `wire_dequant`): each row of the last dim is
scaled by its own absmax into the wire dtype with one f32 scale, the
codec of the expert-parallel all-to-all's quantized wire (ops/ep_a2a.py).

Per block: a (…, H) float tensor is cut into `block`-wide slices of its last dim;
each slice is scaled by its own absmax into a wire dtype ("int8",
symmetric round-half-to-even, or "float8_e4m3fn") and carries one f32
scale. The paged KV pool stores K/V rows this way with block = head_dim
(models/paged_kv_cache.py::quant_kv). Payload bytes and scales equal the
JAX codec's exactly: the same f32 division (IEEE on the CPU and on a
CUDA tensor alike), `torch.round` rounds half to even as `jnp.round`
does, and fp8 conversion rounds to nearest even (in range; the codec
never leaves it).

The quantized collective wire of the tensor-parallel epilogues (the
quant arms of ops/gemm_rs.py and ops/gemm_ar.py, `quant_psum`,
`quant_psum_scatter`) and of the collective library's quant arms
(ops/collectives) uses the per-block codec on 2-D values
(`quant_value_blocks` / `dequant_value_blocks`, the plain versions of the
device codec in csrc/tdt_wire.cuh) and accumulates the dequantized parts
in f32 in rank order (`dequant_accumulate`), rounding once.
`sum_error_bound` is the bound the tests derive their tolerances from.
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


def quant_eps(wire_dtype) -> float:
    """Per-element quantization error of the wire dtype, as a fraction of
    its scaling block's absmax."""
    return QUANT_EPS[resolve_wire_dtype(wire_dtype)]


def effective_block(width: int, block: int | None = None) -> int | None:
    """The scaling block usable for a `width`-wide row: min(block, width)
    when it divides the row, else None (the caller runs full width and
    records why)."""
    blk = min(block or WIRE_BLOCK, width)
    return blk if width % blk == 0 else None


def resolve_block(width: int, block: int | None = None) -> int:
    """The scaling block for a `width`-wide row: min(block, width),
    raising when it does not divide the row (quantizing anyway would
    mis-scale the ragged tail)."""
    blk = effective_block(width, block)
    if blk is None:
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
    # divided by a tensor on amax's device: a CUDA tensor divided by a
    # Python number is multiplied by its reciprocal, which can put a scale
    # an ulp off the IEEE quotient the device codec and the CPU compute
    scale = amax.clamp_min(1e-30) / torch.full_like(amax, WIRE_MAX[name])
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


def dequant_accumulate(qs, scales, dtype, block: int | None = None):
    """Sum stacked quantized parts: qs (n, …, H), scales (n, …, H/block)
    -> (…, H). Each part is dequantized in f32 and the parts are added in
    rank order 0..n-1 in f32, rounded once to `dtype`."""
    acc = None
    for q, s in zip(qs, scales):
        part = dequant_blockwise(q, s, torch.float32, block)
        acc = part if acc is None else acc + part
    return acc.to(dtype)


def quant_value_blocks(val, wire_dtype, block: int):
    """Quantize a 2-D (rows, cols) value (any float dtype, taken in f32) ->
    (q (rows, cols) wire dtype, scales (rows, cols / block) f32); `cols %
    block == 0` is the caller's contract. The plain version of the device
    codec (csrc/tdt_wire.cuh `tdt_wire::quant`)."""
    if val.dim() != 2 or val.shape[1] % block:
        raise ValueError(f"quant_value_blocks takes (rows, cols) with cols a "
                         f"multiple of {block}, got {tuple(val.shape)}")
    return quant_blockwise(val, wire_dtype, block)


def dequant_value_blocks(q, scales, block: int):
    """Inverse of `quant_value_blocks`, in f32 (the caller accumulates in
    f32 and rounds once)."""
    return dequant_blockwise(q, scales, torch.float32, block)


def quant_psum(x, wire_dtype, block: int | None = None, *,
               checksum: bool = False, tamper=None):
    """AllReduce (sum) of rank-stacked x (n, …, H) over a quantized wire
    (JAX quant_psum :291, the one-shot wire): each rank's part is
    block-quantized once, every receiver dequantizes the n parts and sums
    them in f32 in rank order, rounding once to x's dtype. Returns the
    replicated (…, H), kept once. The checksum-guarded form (`checksum`,
    `tamper`) belongs to the chaos harness and comes with slice 2c."""
    if checksum or tamper is not None:
        raise NotImplementedError(
            "quant_psum(checksum=True / tamper=) is the chaos harness's "
            "guarded wire (tools/chaos.py): it comes with slice 2c "
            "(ROADMAP.md, Queue A)")
    blk = effective_block(x.shape[-1], block)
    q, s = quant_blockwise(x, wire_dtype, blk)
    return dequant_accumulate(q, s, x.dtype, blk)


def quant_psum_scatter(x, wire_dtype, block: int | None = None):
    """ReduceScatter of rank-stacked partials x (n, rows, cols) over a
    quantized wire (JAX quant_psum_scatter :331, the fullmesh wire): row
    chunk p of every rank's part is quantized and lands on rank p, which
    sums its n landed chunks in f32 in rank order and rounds once.
    Returns (n, rows / n, cols)."""
    n, rows, cols = x.shape
    blk = effective_block(cols, block)
    q, s = quant_blockwise(x.reshape(n, n, rows // n, cols), wire_dtype, blk)
    # slab p of every source lands on rank p: (source, owner, ...) summed
    # over the sources
    return dequant_accumulate(q, s, x.dtype, blk)


def sum_error_bound(parts, wire_dtype, block: int | None = None,
                    quantizations: int = 1):
    """Elementwise bound on |quantized sum - exact sum| for a reduction of
    stacked `parts` (n, …, H) (JAX sum_error_bound :354): per scaling
    block eps(wire) * quantizations * sum over the parts of their absmax,
    spread back to the elements. A float32 numpy array broadcastable
    against the reduced output (…, H)."""
    import numpy as np

    if isinstance(parts, torch.Tensor):
        parts = parts.detach().float().cpu().numpy()
    parts = np.asarray(parts, np.float32)
    blk = effective_block(parts.shape[-1], block)
    if blk is None:
        raise ValueError(f"no scaling block divides width {parts.shape[-1]}")
    amax = np.abs(parts).reshape(*parts.shape[:-1], -1, blk).max(-1)
    per_block = quant_eps(wire_dtype) * quantizations * amax.sum(0)
    return np.repeat(per_block, blk, axis=-1)


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
