"""AllGather over n ranks (counterpart of
triton_distributed_tpu/ops/collectives/all_gather.py).

Rank-stacked (parallel/mesh.py): `all_gather_shard(x)` takes every rank's
shard at once, x (n, rows, cols), and returns (n, n * rows, cols), every
rank's copy of the gathered tensor; the host-level `all_gather(x)` takes
the global (n * rows, cols), the layout of JAX's P("tp", None) input, and
returns the replicated (n * rows, cols), kept once.

Methods, as in JAX:
- FULLMESH_PUSH: each rank copies its shard into slot r of every rank's
  output, one round (csrc/all_gather.cu, arm 0);
- RING: n - 1 dependent hops, each forwarding the slot that landed at the
  hop before (arm 1);
- XLA, or one rank: `RankGroup.all_gather(tiled=True)`;
- AUTO: `choose_method`, JAX's rule (full mesh up to 1 MiB a shard).

On a CUDA tensor the kernel runs (any dtype: it copies bytes) or raises; on
a CPU tensor its plain version, the same copies in the same order (the
ring relays slot by slot). Every call is logged (`_common.record_dispatch`,
"kernel" or "xla" with "n==1"); JAX's op logs nothing.

JAX's `collective_id` is dropped: the port's workspaces are per op, arm
and shape, so the argument would select nothing. `wait_budget` is in
seconds (the device clock); None is the transport's default,
`shmem.WAIT_BUDGET_S`.

`quant_all_gather_shard` gathers at wire width, as JAX's (:163-184): x is
block-quantized once (`wire.quant_blockwise`), the payload bytes go
through the kernel (any method; the gather copies bytes), the f32 scales
through `RankGroup.all_gather` (JAX's XLA all_gather), and every rank
dequantizes the gathered tensor to x's dtype (one quantization; no sum).
It is the all-gather half of the quantized two-shot AllReduce
(all_reduce.py).
"""

from __future__ import annotations

import enum

import torch

from ... import shmem
from ...parallel.mesh import RankGroup
from .. import wire
from .._build import CudaKernel
from .._common import check_coll_cuda, record_dispatch

ALL_GATHER = CudaKernel("all_gather", "tdt_all_gather",
                        shmem.primitives.COLL_ARGTYPES)
_ARMS = {"fullmesh_push": (0, "fullmesh"), "ring": (1, "ring")}


class AllGatherMethod(enum.Enum):
    AUTO = "auto"
    FULLMESH_PUSH = "fullmesh_push"
    RING = "ring"
    XLA = "xla"


def choose_method(nbytes_shard: int, num_ranks: int) -> AllGatherMethod:
    """JAX's rule (:50): XLA at one rank, the full-mesh push up to 1 MiB a
    shard, the ring above."""
    if num_ranks == 1:
        return AllGatherMethod.XLA
    if nbytes_shard <= (1 << 20):
        return AllGatherMethod.FULLMESH_PUSH
    return AllGatherMethod.RING


def _fullmesh_plain(x):
    """Plain version of arm 0: rank r's shard into slot r of every rank's
    output."""
    n, rows, cols = x.shape
    out = x.new_empty((n, n, rows, cols))
    for r in range(n):
        out[:, r] = x[r]
    return out.view(n, n * rows, cols)


def _ring_plain(x):
    """Plain version of arm 1: the own shard into slot r, then at hop k
    every rank r forwards slot (r - k) mod n of its output to rank r + 1."""
    n, rows, cols = x.shape
    out = x.new_empty((n, n, rows, cols))
    ranks = torch.arange(n)
    out[ranks, ranks] = x
    for k in range(n - 1):
        s = (ranks - k) % n
        out[(ranks + 1) % n, s] = out[ranks, s]
    return out.view(n, n * rows, cols)


def all_gather_shard(x, *, num_ranks: int,
                     method: AllGatherMethod = AllGatherMethod.AUTO,
                     wait_budget: float | None = None):
    """AllGather of every rank's (rows, cols) shard along dim 0. x: (n,
    rows, cols) rank-stacked. Returns (n, n * rows, cols): rank d's copy at
    [d] (n written copies from the kernel, a broadcast view of one on the
    "xla" path)."""
    n = num_ranks
    if x.dim() != 3 or x.shape[0] != n:
        raise ValueError(f"all_gather: x {tuple(x.shape)} is not (n, rows, "
                         f"cols) with n = {n}")
    if method == AllGatherMethod.AUTO:
        method = choose_method(x[0].numel() * x.element_size(), n)
    if method == AllGatherMethod.XLA or n == 1:
        record_dispatch("all_gather", "xla", "n==1" if n == 1 else "")
        return RankGroup(n).all_gather(x, tiled=True).expand(n, -1, -1)
    record_dispatch("all_gather", "kernel")
    arm, name = _ARMS[method.value]
    if x.device.type == "cpu":
        return _fullmesh_plain(x) if arm == 0 else _ring_plain(x)
    check_coll_cuda("all_gather", x, n, dtypes=None)
    _, rows, cols = x.shape
    out = torch.empty((n, n * rows, cols), dtype=x.dtype, device=x.device)
    S = x[0].numel() * x.element_size()
    step = shmem.coll_block(S)
    ws = shmem.coll_workspace("all_gather", name, x.device, n, -(-S // step),
                              None, torch.uint8)
    shmem.launch_coll(ALL_GATHER, ws, arm, shmem.primitives.COLL_BYTES, x,
                      out, S, step,
                      budget_s=wait_budget or shmem.WAIT_BUDGET_S)
    return out


def all_gather(x, *, num_ranks: int,
               method: AllGatherMethod = AllGatherMethod.AUTO):
    """Host-level AllGather of a global (n * rows, cols) tensor sharded on
    dim 0 over n ranks: the replicated (n * rows, cols), kept once."""
    n = num_ranks
    if x.dim() != 2 or x.shape[0] % n:
        raise ValueError(f"all_gather: x {tuple(x.shape)} is not (n * rows, "
                         f"cols) with n = {n}")
    return all_gather_shard(x.reshape(n, -1, x.shape[1]), num_ranks=n,
                            method=method)[0]


def _quant_gather(x, wire_dtype, block: int, gather):
    """x (n, rows, cols) quantized once, its payload bytes gathered by
    `gather` ((n, rows, cols) -> (n, n * rows, cols)), its scales by the
    rank group, and the gathered tensor dequantized to x's dtype."""
    q, s = wire.quant_blockwise(x, wire_dtype, block)
    full_q = gather(wire.byte_view(q)).view(q.dtype)
    full_s = RankGroup(x.shape[0]).all_gather(s, tiled=True)
    return wire.dequant_blockwise(full_q, full_s, x.dtype, block)


def quant_all_gather_shard(x, *, num_ranks: int, wire_dtype, block: int,
                           method: AllGatherMethod = AllGatherMethod.RING,
                           wait_budget: float | None = None):
    """AllGather at wire width of every rank's (rows, cols) shard, x (n,
    rows, cols) rank-stacked (JAX :163): (n, n * rows, cols) in x's dtype,
    every rank's copy of the gathered, dequantized tensor. `block` is the
    scaling block (it divides cols)."""
    return _quant_gather(x, wire_dtype, block, lambda q: all_gather_shard(
        q, num_ranks=num_ranks, method=method, wait_budget=wait_budget))
