"""ReduceScatter over n ranks (counterpart of
triton_distributed_tpu/ops/collectives/reduce_scatter.py: its kernel arms,
full width and with a quantized wire, and its XLA path with or without a
wire).

Rank-stacked (parallel/mesh.py): `reduce_scatter_shard(x)` takes every
rank's partials at once, x (n, n * rows, cols), and returns (n, rows,
cols), rank r holding chunk r of the sum; the host-level
`reduce_scatter(x)` takes the same (n, n * rows, cols), as JAX's, and
returns the global (n * rows, cols), rank r's chunk at rows [r * rows, (r
+ 1) * rows).

Methods, as in JAX:
- RING: n - 1 dependent hops; at hop k a rank sends chunk (r - 1 - k) mod
  n of its partials plus what landed at hop k - 1, rounded to the dtype,
  to rank r + 1 (csrc/reduce_scatter.cu, arm 0);
- FULLMESH: chunk p pushed to rank p, which sums the n partials in rank
  order (arm 1);
- XLA, or one rank: `RankGroup.psum_scatter`; with `wire_dtype`, the port's
  `wire.quant_psum_scatter` (JAX :250-253);
- AUTO: `choose_method`, the faster of the full mesh and the ring by the
  port's perf_model (the JAX estimators on the H100's figures). JAX's VMEM
  gate (:248) is the TPU kernel's limit; the port's kernels stream HBM and
  keep no such gate.

Arithmetic: sums in f32. A ring hop's message is rounded to the dtype (the
JAX ring's `acc` has x's dtype); the full mesh sums the n landed partials
in rank order in f32 and rounds once (`parallel.mesh.sum_in_rank_order`).
JAX adds in the working dtype, so in bf16 the two packages differ by a
rounding or two.

With `wire_dtype` ("int8" / "float8_e4m3fn", scaling block `wire_block`,
`wire.effective_block`: any divisor of cols) the kernel routes take the
quant arms, as JAX's (logged ("kernel", "wire")):
- RING (arm 2, JAX `_ring_quant_kernel` :132): hop k block-quantizes acc =
  chunk (r - 1 - k) mod n in f32 plus the hop k - 1 landing dequantized;
  acc stays f32 between hops (never rounded to x's dtype, unlike the
  full-width ring's message); the result, chunk r in f32 plus the last
  landing dequantized, is rounded once (`ring_quant_plain`);
- FULLMESH (arm 3, JAX `_fullmesh_quant_kernel` :178): every chunk of
  every rank quantized once, its own included; rank p dequantizes its n
  landed chunks and adds them in rank order in f32, rounding once
  (`wire.quant_psum_scatter`).
The quantize is fused into the arms' pushes (JAX's full mesh quantizes on
the host, :287): the bytes and scales are `wire.quant_blockwise`'s, bit for
bit (csrc/tdt_coll_wire.cuh). A wire with no usable block runs full width
("wire-fallback:block-divisibility"). The dispatch log is JAX's ("kernel",
"xla", "n==1", "wire", "wire-fallback:block-divisibility"). On a CUDA
tensor the kernel runs or raises; on a CPU tensor its plain version, the
same steps in the same order and rounding.

JAX's `collective_id` is dropped: the port's workspaces are per op, arm and
shape, so the argument would select nothing. `wait_budget` is in seconds
(the device clock); None is the transport's default, `shmem.WAIT_BUDGET_S`.
"""

from __future__ import annotations

import enum

import torch

from ... import shmem
from ...parallel.mesh import RankGroup, sum_in_rank_order
from .. import wire
from .._build import CudaKernel
from .._common import check_coll_cuda, record_dispatch

REDUCE_SCATTER = CudaKernel("reduce_scatter", "tdt_reduce_scatter",
                            shmem.primitives.COLL_ARGTYPES)
# the quant arms, one launch counter each: arm 2 (ring), arm 3 (full mesh)
REDUCE_SCATTER_QUANT = {
    m: CudaKernel("reduce_scatter", "tdt_reduce_scatter_quant",
                  shmem.primitives.COLL_QUANT_ARGTYPES)
    for m in ("ring", "fullmesh")}
_ARMS = {"ring": (0, "ring"), "fullmesh": (1, "fullmesh")}


class ReduceScatterMethod(enum.Enum):
    AUTO = "auto"
    RING = "ring"
    FULLMESH = "fullmesh"
    XLA = "xla"


def choose_method(nbytes_chunk: int, num_ranks: int, *, wire_dtype=None,
                  itemsize: int = 2, spec=None) -> ReduceScatterMethod:
    """JAX's rule (:48) on the port's perf_model: XLA at one rank, else the
    full mesh when its modeled time is at most the ring's."""
    from ... import perf_model

    if num_ranks == 1:
        return ReduceScatterMethod.XLA
    wire_dtype = wire.resolve_wire_dtype(wire_dtype)
    t_fm = perf_model.estimate_fullmesh_reduce_scatter_time_s(
        nbytes_chunk, num_ranks, spec, wire_dtype=wire_dtype,
        itemsize=itemsize)
    t_ring = perf_model.estimate_ring_reduce_scatter_time_s(
        nbytes_chunk, num_ranks, spec, wire_dtype=wire_dtype,
        itemsize=itemsize)
    return (ReduceScatterMethod.FULLMESH if t_fm <= t_ring
            else ReduceScatterMethod.RING)


def _round_add(a, b):
    """a + b in f32, rounded to a's dtype: one ring hop's message."""
    return (a.float() + b.float()).to(a.dtype)


def ring_plain(xs):
    """Plain version of arm 0 on xs (n, n, rows, cols), rank r's chunk q at
    xs[r, q]: the ring's steps, every rank at once. Returns (n, rows,
    cols)."""
    n = xs.shape[0]
    ranks = torch.arange(n)
    land = None
    for k in range(n - 1):
        acc = xs[ranks, (ranks - 1 - k) % n]
        if k:
            acc = _round_add(acc, land)
        land = torch.roll(acc, 1, dims=0)     # rank r's acc lands on r + 1
    return _round_add(xs[ranks, ranks], land)


def fullmesh_plain(xs):
    """Plain version of arm 1 on xs (n, n, rows, cols): rank p sums the n
    ranks' chunk p in rank order in f32, rounding once."""
    return sum_in_rank_order(xs)


def ring_quant_plain(xs, wire_dtype, blk: int):
    """Plain version of arm 2 on xs (n, n, rows, cols): at hop k every
    rank r block-quantizes acc = chunk (r - 1 - k) mod n in f32, plus the
    hop k - 1 landing dequantized, and the bytes and scales land on r + 1;
    the result is chunk r in f32 plus the last landing dequantized, rounded
    once to x's dtype. Returns (n, rows, cols)."""
    n = xs.shape[0]
    ranks = torch.arange(n)
    land = None
    for k in range(n - 1):
        acc = xs[ranks, (ranks - 1 - k) % n].float()
        if k:
            acc = acc + wire.dequant_blockwise(*land, torch.float32, blk)
        q, s = wire.quant_blockwise(acc, wire_dtype, blk)
        land = (torch.roll(wire.byte_view(q), 1, dims=0).view(q.dtype),
                torch.roll(s, 1, dims=0))
    own = xs[ranks, ranks].float()
    return (own + wire.dequant_blockwise(*land, torch.float32, blk)).to(
        xs.dtype)


def fullmesh_quant_plain(xs, wire_dtype, blk: int):
    """Plain version of arm 3 on xs (n, n, rows, cols): every chunk of
    every rank quantized once, rank p's n landed chunks dequantized and
    added in rank order in f32, rounded once (`wire.quant_psum_scatter`)."""
    n, _, rows, cols = xs.shape
    return wire.quant_psum_scatter(xs.reshape(n, n * rows, cols), wire_dtype,
                                   blk)


def reduce_scatter_shard(x, *, num_ranks: int,
                         method: ReduceScatterMethod = ReduceScatterMethod.AUTO,
                         wire_dtype=None, wire_block: int | None = None,
                         wait_budget: float | None = None):
    """ReduceScatter of every rank's (n * rows, cols) partials, x (n, n *
    rows, cols) rank-stacked, along dim 0: (n, rows, cols), rank r's chunk
    of the sum at [r]. `wire_dtype` quantizes the wire per `wire_block`
    (ops/wire.py; the kernel routes take the quant arms)."""
    n = num_ranks
    if x.dim() != 3 or x.shape[0] != n or x.shape[1] % n:
        raise ValueError(f"reduce_scatter: x {tuple(x.shape)} is not (n, n "
                         f"* rows, cols) with n = {n}")
    _, rows_total, cols = x.shape
    chunk_rows = rows_total // n
    wire_dtype = wire.resolve_wire_dtype(wire_dtype)
    blk = wire.effective_block(cols, wire_block) if wire_dtype else None
    if wire_dtype is not None and blk is None:
        record_dispatch("reduce_scatter", "kernel",
                        "wire-fallback:block-divisibility")
        wire_dtype = None
    if method == ReduceScatterMethod.AUTO:
        method = choose_method(chunk_rows * cols * x.element_size(), n,
                               wire_dtype=wire_dtype,
                               itemsize=x.element_size())
    if method == ReduceScatterMethod.XLA or n == 1:
        if wire_dtype is not None and n > 1:
            record_dispatch("reduce_scatter", "xla", "wire")
            return wire.quant_psum_scatter(x, wire_dtype, blk)
        record_dispatch("reduce_scatter", "xla", "n==1" if n == 1 else "")
        return RankGroup(n).psum_scatter(x)
    arm, name = _ARMS[method.value]
    c = chunk_rows * cols
    if wire_dtype is not None:
        record_dispatch("reduce_scatter", "kernel", "wire")
        if x.device.type == "cpu":
            return (ring_quant_plain if arm == 0 else fullmesh_quant_plain)(
                x.reshape(n, n, chunk_rows, cols), wire_dtype, blk)
        check_coll_cuda("reduce_scatter", x, n)
        out = torch.empty((n, chunk_rows, cols), dtype=x.dtype,
                          device=x.device)
        gblk = shmem.coll_wire_group(c * x.element_size(),
                                     blk * x.element_size())
        ws = shmem.coll_wire_workspace("reduce_scatter", name, x.device, n,
                                       n - 1 if arm == 0 else n, c, blk, gblk)
        shmem.launch_coll(REDUCE_SCATTER_QUANT[name], ws, arm + 2,
                          shmem.primitives.DTYPE_CODES[x.dtype], x, out,
                          n * c, gblk,
                          wire=(shmem.WIRE_CODES[wire_dtype], blk),
                          budget_s=wait_budget or shmem.WAIT_BUDGET_S)
        return out
    record_dispatch("reduce_scatter", "kernel")
    if x.device.type == "cpu":
        xs = x.reshape(n, n, chunk_rows, cols)
        return ring_plain(xs) if arm == 0 else fullmesh_plain(xs)
    check_coll_cuda("reduce_scatter", x, n)
    out = torch.empty((n, chunk_rows, cols), dtype=x.dtype, device=x.device)
    step = shmem.coll_block(c * x.element_size()) // x.element_size()
    region = (n - 1 if arm == 0 else n, c)
    ws = shmem.coll_workspace("reduce_scatter", name, x.device, n,
                              -(-c // step), region, x.dtype)
    shmem.launch_coll(REDUCE_SCATTER, ws, arm,
                      shmem.primitives.DTYPE_CODES[x.dtype], x, out, n * c,
                      step, budget_s=wait_budget or shmem.WAIT_BUDGET_S)
    return out


def reduce_scatter(x, *, num_ranks: int,
                   method: ReduceScatterMethod = ReduceScatterMethod.AUTO,
                   wire_dtype=None, wire_block: int | None = None):
    """Host-level ReduceScatter of every rank's partials x (n, n * rows,
    cols) (JAX's input: the per-device partials stacked on dim 0): the
    global (n * rows, cols), rank r's chunk of the sum at rows [r * rows,
    (r + 1) * rows)."""
    out = reduce_scatter_shard(x, num_ranks=num_ranks, method=method,
                               wire_dtype=wire_dtype, wire_block=wire_block)
    return out.reshape(-1, out.shape[-1])
