"""AllReduce (sum) over n ranks (counterpart of
triton_distributed_tpu/ops/collectives/all_reduce.py: its kernel arms,
full width and with a quantized wire, and its XLA path with or without a
wire).

Rank-stacked (parallel/mesh.py): `all_reduce_shard(x)` takes every rank's
buffer at once, x (n, rows, cols), and returns (n, rows, cols), every
rank's replica of the sum, as `ops/gemm_ar.py::gemm_ar_shard` does; the
host-level `all_reduce(x)` takes the same (n, rows, cols), as JAX's, and
returns the replicated (rows, cols), kept once.

Methods, as in JAX:
- ONE_SHOT: every rank pushes its buffer to every peer, each sums the n
  buffers in rank order (csrc/all_reduce.cu, arm 0);
- TWO_SHOT: the ring reduce-scatter of ops/collectives/reduce_scatter.py,
  then a ring all-gather of the reduced chunks, in one launch (arm 1);
  rows % n != 0 takes XLA (JAX :275-277);
- XLA, or one rank: `RankGroup.psum`; with `wire_dtype`, the port's
  `wire.quant_psum` (JAX :284-287);
- AUTO: `choose_method`, the fastest of the three by the port's perf_model
  (the JAX estimators on the H100's figures). JAX's VMEM gates (the 3/4
  VMEM budget of its `choose_method` :70, `fits_vmem` :266-277) are the TPU
  kernels' limits; the port's kernels stream HBM and keep none.

Arithmetic: sums in f32. One-shot sums the n buffers in rank order and
rounds once (`parallel.mesh.sum_in_rank_order`), so every replica holds
the same bits; two-shot rounds each ring hop's message to the dtype, as
the JAX ring's `acc` does. JAX adds in the working dtype, so in bf16 the
two packages differ by a rounding or two.

With `wire_dtype` ("int8" / "float8_e4m3fn", scaling block `wire_block`,
`wire.effective_block`: any divisor of cols) the kernel routes go over the
wire, as JAX's (logged ("kernel", "wire")):
- ONE_SHOT (arm 2, JAX `_one_shot_quant_kernel` :175): every rank's
  buffer quantized once, its own included, and every rank dequantizes the
  n buffers and adds them in rank order in f32, rounding once
  (`wire.quant_psum`); the quantize is fused into the push (JAX quantizes
  on the host, :302), with `wire.quant_blockwise`'s bytes and scales, bit
  for bit;
- TWO_SHOT (JAX `_two_shot_quant_shard` :214), a composition: the ring
  ReduceScatter's quant arm (reduce_scatter.py, logged there too: its acc
  stays f32 between hops), then `all_gather.quant_all_gather_shard` over
  the ring (the reduced chunk quantized once more, its bytes gathered by
  the kernel, its scales by the rank group). So each value crosses n
  quantizations.
A wire with no usable block runs full width
("wire-fallback:block-divisibility").

`return_fault=True` (JAX :278-283) is allowed only with an explicit
`wait_budget` on the unquantized ONE_SHOT route, and else raises
ValueError; the call then returns (out, fault), `fault` an (n,) int32 of
the ranks' fault words (synchronising: the rank whose wait timed out
carries the code), and a faulted workspace resets, so the next call runs
clean. Without it a fault raises at the next call of the op or at
`shmem.check_faults()`, naming the rank and the signal. On a CUDA tensor
the kernel runs or raises; on a CPU tensor its plain version, the same
steps in the same order and rounding. The dispatch log is JAX's.

JAX's `collective_id` is dropped: the port's workspaces are per op, arm and
shape, so the argument would select nothing. `wait_budget` is in seconds
(the device clock); None is the transport's default, `shmem.WAIT_BUDGET_S`
(the port's waits are always bounded).
"""

from __future__ import annotations

import enum

import torch

from ... import shmem
from ...parallel.mesh import RankGroup, sum_in_rank_order
from .. import wire
from .._build import CudaKernel
from .._common import check_coll_cuda, record_dispatch
from .all_gather import AllGatherMethod, _quant_gather, quant_all_gather_shard
from .all_gather import _ring_plain as _ag_ring_plain
from .reduce_scatter import ReduceScatterMethod, reduce_scatter_shard
from .reduce_scatter import ring_plain as _rs_ring_plain
from .reduce_scatter import ring_quant_plain as _rs_ring_quant_plain

ALL_REDUCE = CudaKernel("all_reduce", "tdt_all_reduce",
                        shmem.primitives.COLL_ARGTYPES)
ALL_REDUCE_QUANT = CudaKernel("all_reduce", "tdt_all_reduce_quant",
                              shmem.primitives.COLL_QUANT_ARGTYPES)  # arm 2
_ARMS = {"one_shot": (0, "one_shot"), "two_shot": (1, "two_shot")}


class AllReduceMethod(enum.Enum):
    AUTO = "auto"
    ONE_SHOT = "one_shot"
    TWO_SHOT = "two_shot"
    XLA = "xla"


def choose_method(nbytes: int, num_ranks: int, *, wire_dtype=None,
                  itemsize: int = 2, spec=None) -> AllReduceMethod:
    """JAX's rule (:51) on the port's perf_model, without its VMEM gates:
    the least modeled time of one-shot, two-shot (at the wire's bytes) and
    XLA (full width); a tie goes to the earlier, a kernel."""
    from ... import perf_model

    if num_ranks == 1:
        return AllReduceMethod.XLA
    n = num_ranks
    wire_dtype = wire.resolve_wire_dtype(wire_dtype)
    kw = dict(wire_dtype=wire_dtype, itemsize=itemsize)
    cands = [
        (perf_model.estimate_one_shot_all_reduce_time_s(nbytes, n, spec, **kw),
         AllReduceMethod.ONE_SHOT),
        (perf_model.estimate_two_shot_all_reduce_time_s(nbytes, n, spec, **kw),
         AllReduceMethod.TWO_SHOT),
        (perf_model.estimate_all_reduce_time_s(nbytes, n, spec),
         AllReduceMethod.XLA)]
    return min(cands, key=lambda c: c[0])[1]


def one_shot_plain(x):
    """Plain version of arm 0: every rank's replica of the rank-order f32
    sum, rounded once (a broadcast view of one copy)."""
    return sum_in_rank_order(x).expand(x.shape[0], -1, -1)


def two_shot_plain(x):
    """Plain version of arm 1: the ring reduce-scatter's steps, then the
    ring all-gather's relay of the reduced chunks."""
    n, rows, cols = x.shape
    chunks = _rs_ring_plain(x.reshape(n, n, rows // n, cols))
    return _ag_ring_plain(chunks)


def one_shot_quant_plain(x, wire_dtype, blk: int):
    """Plain version of arm 2: every rank's buffer quantized once, the n
    dequantized in rank order in f32, rounded once (`wire.quant_psum`);
    every rank's replica (a broadcast view of one copy)."""
    return wire.quant_psum(x, wire_dtype, blk).expand(x.shape[0], -1, -1)


def two_shot_quant_plain(x, wire_dtype, blk: int):
    """Plain version of the quantized two-shot: the ring ReduceScatter's
    quant arm, then the wire-width ring AllGather of the reduced chunks."""
    n, rows, cols = x.shape
    chunks = _rs_ring_quant_plain(x.reshape(n, n, rows // n, cols),
                                  wire_dtype, blk)
    return _quant_gather(chunks, wire_dtype, blk, _ag_ring_plain)


def _two_shot_quant_shard(x, *, num_ranks: int, wire_dtype, block: int,
                          wait_budget=None):
    """The quantized two-shot as JAX's decomposition (:214): the ring
    ReduceScatter with a wire, then `quant_all_gather_shard` over the
    ring."""
    n = num_ranks
    chunk = reduce_scatter_shard(x, num_ranks=n,
                                 method=ReduceScatterMethod.RING,
                                 wire_dtype=wire_dtype, wire_block=block,
                                 wait_budget=wait_budget)
    return quant_all_gather_shard(chunk, num_ranks=n, wire_dtype=wire_dtype,
                                  block=block, method=AllGatherMethod.RING,
                                  wait_budget=wait_budget)


def all_reduce_shard(x, *, num_ranks: int,
                     method: AllReduceMethod = AllReduceMethod.AUTO,
                     wire_dtype=None, wire_block: int | None = None,
                     wait_budget: float | None = None,
                     return_fault: bool = False):
    """AllReduce (sum) of every rank's (rows, cols) buffer, x (n, rows,
    cols) rank-stacked: (n, rows, cols), rank d's replica at [d] (n written
    replicas from the kernel, a broadcast view of one copy on the plain
    paths). `wire_dtype` quantizes the wire per `wire_block` (ops/wire.py;
    the kernel routes go over the quant arms). With `return_fault`: (out,
    fault) (module docstring)."""
    n = num_ranks
    if x.dim() != 3 or x.shape[0] != n:
        raise ValueError(f"all_reduce: x {tuple(x.shape)} is not (n, rows, "
                         f"cols) with n = {n}")
    _, rows, cols = x.shape
    wire_dtype = wire.resolve_wire_dtype(wire_dtype)
    blk = wire.effective_block(cols, wire_block) if wire_dtype else None
    if wire_dtype is not None and blk is None:
        record_dispatch("all_reduce", "kernel",
                        "wire-fallback:block-divisibility")
        wire_dtype = None
    if method == AllReduceMethod.AUTO:
        method = choose_method(x[0].numel() * x.element_size(), n,
                               wire_dtype=wire_dtype,
                               itemsize=x.element_size())
    if method == AllReduceMethod.TWO_SHOT and rows % n:
        method = AllReduceMethod.XLA
    if return_fault and not (
            wait_budget is not None and method == AllReduceMethod.ONE_SHOT
            and wire_dtype is None):
        raise ValueError(
            "return_fault requires wait_budget and the unquantized "
            f"ONE_SHOT kernel route (resolved method: {method})")
    if method == AllReduceMethod.XLA or n == 1:
        if wire_dtype is not None and n > 1:
            record_dispatch("all_reduce", "xla", "wire")
            out = wire.quant_psum(x, wire_dtype, blk)
        else:
            record_dispatch("all_reduce", "xla", "n==1" if n == 1 else "")
            out = RankGroup(n).psum(x)
        out = out.expand(n, -1, -1)
        return (out, _no_fault(x)) if return_fault else out
    arm, name = _ARMS[method.value]
    if wire_dtype is not None:
        record_dispatch("all_reduce", "kernel", "wire")
        if arm == 1:
            return _two_shot_quant_shard(x, num_ranks=n, wire_dtype=wire_dtype,
                                         block=blk, wait_budget=wait_budget)
        if x.device.type == "cpu":
            return one_shot_quant_plain(x, wire_dtype, blk)
        check_coll_cuda("all_reduce", x, n)
        out = torch.empty_like(x)
        E = rows * cols
        gblk = shmem.coll_wire_group(E * x.element_size(),
                                     blk * x.element_size())
        ws = shmem.coll_wire_workspace("all_reduce", name, x.device, n, n, E,
                                       blk, gblk)
        shmem.launch_coll(ALL_REDUCE_QUANT, ws, 2,
                          shmem.primitives.DTYPE_CODES[x.dtype], x, out, E,
                          gblk, wire=(shmem.WIRE_CODES[wire_dtype], blk),
                          budget_s=wait_budget or shmem.WAIT_BUDGET_S)
        return out
    record_dispatch("all_reduce", "kernel")
    if x.device.type == "cpu":
        out = one_shot_plain(x) if arm == 0 else two_shot_plain(x)
        return (out, _no_fault(x)) if return_fault else out
    check_coll_cuda("all_reduce", x, n)
    out = torch.empty_like(x)
    E = rows * cols
    unit = E if arm == 0 else E // n
    step = shmem.coll_block(unit * x.element_size()) // x.element_size()
    region = (n, E) if arm == 0 else (n - 1, E // n)
    ws = shmem.coll_workspace("all_reduce", name, x.device, n,
                              -(-unit // step), region, x.dtype)
    shmem.launch_coll(ALL_REDUCE, ws, arm,
                      shmem.primitives.DTYPE_CODES[x.dtype], x, out, E, step,
                      budget_s=wait_budget or shmem.WAIT_BUDGET_S)
    return (out, ws.fault_flags()) if return_fault else out


def _no_fault(x):
    return torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)


def all_reduce(x, *, num_ranks: int,
               method: AllReduceMethod = AllReduceMethod.AUTO,
               wire_dtype=None, wire_block: int | None = None):
    """Host-level AllReduce of every rank's partials x (n, rows, cols) (JAX's
    input: the per-device partials stacked on dim 0): the replicated sum
    (rows, cols), kept once."""
    return all_reduce_shard(x, num_ranks=num_ranks, method=method,
                            wire_dtype=wire_dtype, wire_block=wire_block)[0]
