"""Host side of the port's one-sided transport (counterpart of
triton_distributed_tpu/shmem/primitives.py; the device side is
csrc/tdt_shmem.cuh, which maps each JAX primitive to its device helper).

A communication op at one shape owns a `Workspace`, its symmetric
heap: n landing regions (one per rank, rank-stacked like every per-rank
tensor of the port, parallel/mesh.py), n signal pads of u32 counters, and
a fault word. It is allocated once per (op, device, ranks, region shape,
dtype, pad length) and kept: its signals are counters compared against a
per-call epoch, so nothing is cleared between calls. The kernels get the
regions and pads as device arrays of n addresses, the form symmetric
memory hands out on a multi-GPU box.

Faults. A kernel's wait that outlasts its budget (`WAIT_BUDGET_S` of the
device's %globaltimer) sets the fault word, naming the waiting rank, the
signal and the value it saw, and the launch gives up; later launches that
find the word set return at once. The host never blocks on the word in
the middle of a step: after each launch it queues a copy of the word to
pinned memory, and the next call reads that copy once it has landed.
`check_faults()` reads every workspace's word at once (synchronising);
the Engine calls it before `serve`, `start` or `step` hands tokens back,
so a fault seen only by a later call's poll never lets a token computed
from a faulted launch's unwritten output out. On a fault the workspace's
pads, word and epoch are reset, so the next call runs clean, and a
RuntimeError names the op, the rank and the signal.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops._build import ptr, stream_of

WAIT_BUDGET_S = 1.0     # a wait longer than this (device clock) is a fault
FAULT_NONE = 0
FAULT_TIMEOUT = 1

# the C entry points of csrc/ag_gemm.cu, gemm_rs.cu and gemm_ar.cu share
# one signature: dtype, bm, a, b, out, land, pads, fault, epoch, budget_ns,
# rank_lo, rank_cnt, n, m, K, N, grid, stream
TP_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
               + [ctypes.c_uint, ctypes.c_longlong] + [ctypes.c_int] * 7
               + [ctypes.c_void_p])
DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
# the quant arms of csrc/gemm_rs.cu and gemm_ar.cu add the wire dtype and
# the scaling block after bm: dtype, bm, wire, blk, a, b, out, ...
TP_QUANT_ARGTYPES = TP_ARGTYPES[:2] + [ctypes.c_int] * 2 + TP_ARGTYPES[2:]
WIRE_CODES = {"int8": 0, "float8_e4m3fn": 1}
# the C entry point of csrc/ep_a2a.cu: x, send_cnt, land, pads, fault,
# epoch, budget_ns, n, C, row_bytes, chunk, grid, stream
A2A_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_uint, ctypes.c_longlong]
                + [ctypes.c_int] * 5 + [ctypes.c_void_p])
# the C entry point of csrc/ll_combine.cu: dtype, out, lse, merged, land,
# pads, fault, epoch, budget_ns, n, rows, D, W, grid, stream
LL_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 6
               + [ctypes.c_uint, ctypes.c_longlong] + [ctypes.c_int] * 5
               + [ctypes.c_void_p])
LL_ROWS = 16            # rows a work item of csrc/ll_combine.cu packs/merges
LL_MAX_RANKS = 8        # csrc/ll_combine.cu MAX_RANKS
# the C entry points of csrc/all_gather.cu, reduce_scatter.cu and
# all_reduce.cu: arm, dtype, x, out, land, pads, fault, epoch, budget_ns, n,
# count, blk, grid, stream (count and blk in elements; in bytes, with dtype
# COLL_BYTES, for the gather)
COLL_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                 + [ctypes.c_uint, ctypes.c_longlong, ctypes.c_int]
                 + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
COLL_BYTES = 2          # the gather's dtype code: it copies bytes
# the quant arms of csrc/reduce_scatter.cu and all_reduce.cu
# (tdt_reduce_scatter_quant, tdt_all_reduce_quant) add the wire dtype and
# the scaling block after dtype, and take the scaling blocks a work item
# for blk: arm, dtype, wire, sblk, x, out, ...
COLL_QUANT_ARGTYPES = COLL_ARGTYPES[:2] + [ctypes.c_int] * 2 \
    + COLL_ARGTYPES[2:]
COLL_MAX_RANKS = 8      # csrc/tdt_coll.cuh MAX_RANKS
# the C entry point of csrc/sp_ag_attention.cu: q, k, v, qmeta, out, land,
# pads, fault, epoch, budget_ns, n, S, H, Hkv, D, meta_rows, causal, scale,
# grid, stream
SP_AG_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_uint, ctypes.c_longlong]
                  + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                          ctypes.c_void_p])
SP_AG_MAX_RANKS = 8     # csrc/sp_ag_attention.cu MAX_RANKS


class Workspace:
    """One fused op's symmetric heap at one shape on one device.

    land: (n, *region) — rank r's landing region is land[r]. pads: (n,
    pad_len) int32 used as u32 counters, slot 0 of each the barrier's.
    `describe(sig)` names a pad slot for fault messages."""

    def __init__(self, op: str, n: int, region, dtype, pad_len: int, device,
                 describe=None):
        self.op = op
        self.n = n
        self.land = self.land_ptrs = None      # region None: signals only
        if region is not None:
            self.land = torch.empty((n, *region), dtype=dtype, device=device)
            self.land_ptrs = torch.tensor(
                [self.land[r].data_ptr() for r in range(n)],
                dtype=torch.int64, device=device)
        self.pads = torch.zeros((n, pad_len), dtype=torch.int32, device=device)
        self.fault = torch.zeros(4, dtype=torch.int32, device=device)
        self.pad_ptrs = torch.tensor(
            [self.pads[r].data_ptr() for r in range(n)], dtype=torch.int64,
            device=device)
        self.epoch = 0
        self.describe = describe or (lambda sig: f"pad slot {sig}")
        self._seen = None
        self._event = None

    def launched(self) -> None:
        """After a launch: queue a copy of the fault word to pinned memory
        (read by the next call's `poll`, without waiting)."""
        if self._seen is None:
            self._seen = torch.zeros(4, dtype=torch.int32, pin_memory=True)
            self._event = torch.cuda.Event()
        self._seen.copy_(self.fault, non_blocking=True)
        self._event.record()

    def poll(self) -> None:
        """Raise if the copy of the fault word from an earlier call has
        landed and shows a fault (never waits)."""
        if self._event is not None and self._event.query() \
                and int(self._seen[0]) != FAULT_NONE:
            self.check()

    def check(self) -> None:
        """Read the fault word (synchronises) and raise on a fault, after
        resetting the pads, the word and the epoch."""
        code, rank, sig, seen = self.fault.cpu().tolist()
        if code == FAULT_NONE:
            return
        epoch = self.epoch
        self.reset()
        what = "timed out" if code == FAULT_TIMEOUT else f"fault {code}"
        raise RuntimeError(
            f"{self.op}: rank {rank} {what} waiting on signal {sig} "
            f"({self.describe(sig)}) of its pad (the counter read "
            f"{seen & 0xFFFFFFFF}; calls up to epoch {epoch}); the workspace "
            f"was reset")

    def fault_flags(self) -> torch.Tensor:
        """The per-rank fault words of the calls so far, (n,) int32 on the
        workspace's device (synchronises): the code of a timed-out wait at
        the rank that waited, 0 elsewhere (a launch records its first
        fault). After a fault the workspace resets, as `check` does,
        without raising."""
        code, rank, _, _ = self.fault.cpu().tolist()
        flags = torch.zeros(self.n, dtype=torch.int32)
        if code != FAULT_NONE:
            flags[rank] = code
            self.reset()
        return flags.to(self.fault.device)

    def reset(self) -> None:
        self.pads.zero_()
        self.fault.zero_()
        self.epoch = 0
        if self._seen is not None:
            self._seen.zero_()


_WORKSPACES: dict = {}


def workspace(op: str, device, n: int, region, dtype, pad_len: int,
              describe=None) -> Workspace:
    """The op's workspace at this shape, allocated on first use."""
    key = (op, str(device), n, region and tuple(region), dtype, pad_len)
    ws = _WORKSPACES.get(key)
    if ws is None:
        ws = _WORKSPACES[key] = Workspace(op, n, region, dtype, pad_len,
                                          device, describe)
    return ws


def check_faults() -> None:
    """Raise if any workspace's kernel recorded a fault (synchronises)."""
    for ws in list(_WORKSPACES.values()):
        if ws.fault.device.type == "cuda":
            ws.check()


def release_workspaces() -> None:
    """Drop every workspace (their device memory goes back to the
    allocator); the next call of an op allocates its own again."""
    _WORKSPACES.clear()


def wire_workspace(op: str, device, n: int, rows: int, N: int, blk: int,
                   bm: int) -> Workspace:
    """The workspace of a quant arm (csrc/gemm_rs.cu, gemm_ar.cu) with its
    own collective id ("<op>[wire]"): rank r's landing region is bytes, the
    quantized partials q (n, rows, N), one byte an element, then at the
    next 16-byte boundary their scales (n, rows, N / blk) f32; its pad
    holds the barrier counter and one signal per (source, row tile, strip
    of max(128, blk) columns)."""
    sw = max(128, blk)
    m_tiles, n_strips = -(-rows // bm), -(-N // sw)
    soff = -(-(n * rows * N) // 16) * 16
    name = f"{op}[wire]"

    def describe(sig):
        if sig == 0:
            return "barrier_all"
        s, t = divmod(sig - 1, m_tiles * n_strips)
        return f"source {s}'s quantized strip {divmod(t, n_strips)}"

    size = -(-(soff + n * rows * (N // blk) * 4) // 16) * 16
    return workspace(name, device, n, (size,), torch.uint8,
                     1 + n * m_tiles * n_strips, describe)


def launch_tp(kernel, ws: Workspace, a, b, out, m: int, K: int, N: int,
              bm: int, *, wire=(), budget_s: float = WAIT_BUDGET_S,
              epoch=None, grid: int = 0, rank_lo: int = 0,
              rank_cnt=None) -> None:
    """Launch one of the tensor-parallel kernels (CudaKernel over
    TP_ARGTYPES, or TP_QUANT_ARGTYPES with `wire` = (WIRE_CODES[dtype],
    blk)) on rank-stacked a, b, out through `ws`. `epoch` defaults to the
    workspace's next (u32, from 1 after a reset), taken only once the
    launch went in; an explicit epoch leaves the workspace's alone.
    `grid` 0 lets the kernel size its persistent grid; ranks [rank_lo,
    rank_lo + rank_cnt) run (default all)."""
    nxt = epoch is None
    if nxt:
        ws.poll()
        epoch = (ws.epoch + 1) & 0xFFFFFFFF
    rank_cnt = ws.n - rank_lo if rank_cnt is None else rank_cnt
    kernel.launch(DTYPE_CODES[a.dtype], bm, *wire, ptr(a), ptr(b), ptr(out),
                  ptr(ws.land_ptrs), ptr(ws.pad_ptrs), ptr(ws.fault),
                  epoch & 0xFFFFFFFF, int(budget_s * 1e9), rank_lo, rank_cnt,
                  ws.n, m, K, N, grid, stream_of(a))
    if nxt:            # a refused launch moved no signal: keep the epoch
        ws.epoch = epoch
    ws.launched()


def a2a_workspace(op: str, device, n: int, capacity: int,
                  row_bytes: int) -> Workspace:
    """The ragged all-to-all's workspace (csrc/ep_a2a.cu): rank r's landing
    region is (n, capacity, row_bytes) bytes, slab s the rows from source
    s; its pad holds the barrier counter (slot 0), one arrival counter per
    source (1 + s) and the tally of its own chunks to each destination
    (1 + n + d). `op` names one in-flight transport (a dispatch or a
    combine of one pipeline chunk), so transports in flight never share
    one."""
    def describe(sig):
        if sig == 0:
            return "barrier_all"
        if sig <= n:
            return f"the rows from source rank {sig - 1}"
        return f"the chunk tally toward rank {sig - 1 - n}"

    return workspace(op, device, n, (n, capacity, row_bytes), torch.uint8,
                     1 + 2 * n, describe)


def launch_a2a(kernel, ws: Workspace, x, send_cnt, chunk: int, *,
               budget_s: float = WAIT_BUDGET_S, grid: int = 0) -> None:
    """Launch csrc/ep_a2a.cu (a CudaKernel over A2A_ARGTYPES) on the
    rank-stacked byte buffer x (n, n, C, row_bytes) and counts send_cnt
    (n, n) int32 through `ws`, whose landing regions receive the rows, at
    the workspace's next epoch (kept only when the launch went in)."""
    ws.poll()
    epoch = (ws.epoch + 1) & 0xFFFFFFFF
    n, _, C, row_bytes = x.shape
    kernel.launch(ptr(x), ptr(send_cnt), ptr(ws.land_ptrs), ptr(ws.pad_ptrs),
                  ptr(ws.fault), epoch, int(budget_s * 1e9), n, C, row_bytes,
                  chunk, grid, stream_of(x))
    ws.epoch = epoch
    ws.launched()


def ll_workspace(device, n: int, rows: int, width: int) -> Workspace:
    """The one-shot combine's workspace (csrc/ll_combine.cu): rank r's
    landing region is (n, rows, width) f32, slot s the packed partial rows
    of source s; its pad holds the barrier counter (slot 0) and one
    arrival counter per (source s, row block b) at 1 + s * nblk + b, nblk
    = ceil(rows / LL_ROWS)."""
    nblk = -(-rows // LL_ROWS)

    def describe(sig):
        if sig == 0:
            return "barrier_all"
        s, b = divmod(sig - 1, nblk)
        return f"row block {b} from source rank {s}"

    return workspace("ll_combine", device, n, (n, rows, width),
                     torch.float32, 1 + n * nblk, describe)


def launch_ll(kernel, ws: Workspace, out, lse, merged, *,
              budget_s: float = WAIT_BUDGET_S, grid: int = 0) -> None:
    """Launch csrc/ll_combine.cu (a CudaKernel over LL_ARGTYPES) on the
    rank-stacked partials out (n, rows, D) and lse (n, rows) into the one
    kept result merged (rows, D) through `ws`, at the workspace's next
    epoch (kept only when the launch went in)."""
    ws.poll()
    epoch = (ws.epoch + 1) & 0xFFFFFFFF
    n, rows, D = out.shape
    kernel.launch(DTYPE_CODES[out.dtype], ptr(out), ptr(lse), ptr(merged),
                  ptr(ws.land_ptrs), ptr(ws.pad_ptrs), ptr(ws.fault), epoch,
                  int(budget_s * 1e9), n, rows, D, ws.land.shape[-1], grid,
                  stream_of(out))
    ws.epoch = epoch
    ws.launched()


# ---------------------------------------------------------------------------
# The collective library (ops/collectives): csrc/all_gather.cu,
# reduce_scatter.cu, all_reduce.cu
# ---------------------------------------------------------------------------

COLL_BLOCK_MIN, COLL_BLOCK_MAX = 2048, 65536    # bytes a work item moves


def coll_block(unit_bytes: int) -> int:
    """Bytes of one block, the data one work item moves and one signal
    guards: a 32nd of the unit a rank moves (its shard, buffer or chunk),
    2-64 KiB, a multiple of 32 bytes (so 16-byte vectors in bf16 and
    f32)."""
    b = -(-unit_bytes // 32)
    return max(COLL_BLOCK_MIN, min(COLL_BLOCK_MAX, -(-b // 32) * 32))


def coll_workspace(op: str, arm: str, device, n: int, nblk: int, region,
                   dtype, sblocks: int | None = None) -> Workspace:
    """The workspace of one arm of a collective ("<op>[<arm>]"): landing
    regions (n, *region) of `dtype` (None: the outputs are the regions, as
    for the gather); its pad holds the barrier counter (slot 0) and one
    signal per block: of each source s at 1 + s * nblk + b for "fullmesh"
    and "one_shot", of each hop k at 1 + k * nblk + b for "ring" (n - 1
    hops) and "two_shot" (the reduce-scatter's n - 1 hops, then the
    all-gather's). A quant arm ("<arm>/wire", `coll_wire_workspace`) has the
    same layout over its work items of `sblocks` scaling blocks."""
    if arm.split("/")[0] in ("fullmesh", "one_shot"):
        groups = n

        def what(g):
            return f"from source rank {g}"
    else:
        groups = (n - 1) * (2 if arm == "two_shot" else 1)

        def what(g):
            phase = ("reduce-scatter " if g < n - 1 else "all-gather ") \
                if arm == "two_shot" else ""
            return (f"of {phase}hop {g % (n - 1)} from the left "
                    f"neighbour")

    def describe(sig):
        if sig == 0:
            return "barrier_all"
        g, b = divmod(sig - 1, nblk)
        sb = ("" if sblocks is None else
              f" (scaling blocks {b * sblocks}..{(b + 1) * sblocks - 1})")
        return f"block {b}{sb} {what(g)}"

    return workspace(f"{op}[{arm}]", device, n, region, dtype,
                     1 + groups * nblk, describe)


def coll_wire_group(unit_bytes: int, sblk_bytes: int) -> int:
    """Scaling blocks a work item of a quant arm holds: whole blocks of
    about `coll_block(unit_bytes)` input bytes, at least one (a block is
    never split: its absmax comes before its first byte)."""
    return max(1, coll_block(unit_bytes) // sblk_bytes)


def coll_wire_workspace(op: str, arm: str, device, n: int, slots: int,
                        unit: int, sblk: int, gblk: int) -> Workspace:
    """The workspace of a collective's quant arm ("<op>[<arm>/wire]",
    csrc/tdt_coll_wire.cuh): rank r's landing region is bytes, `slots`
    slots of `unit` quantized elements (one byte each), then from the next
    16-byte boundary their scales (slots, unit / sblk) f32; its pad is
    `coll_workspace`'s over work items of `gblk` scaling blocks."""
    soff = -(-(slots * unit) // 16) * 16
    size = -(-(soff + slots * (unit // sblk) * 4) // 16) * 16
    nitem = -(-(unit // sblk) // gblk)
    return coll_workspace(op, f"{arm}/wire", device, n, nitem, (size,),
                          torch.uint8, sblocks=gblk)


def launch_coll(kernel, ws: Workspace, arm: int, dtype_code: int, x, out,
                count: int, blk: int, *, wire=(),
                budget_s: float = WAIT_BUDGET_S, grid: int = 0) -> None:
    """Launch one of the collective kernels (a CudaKernel over
    COLL_ARGTYPES, or COLL_QUANT_ARGTYPES with `wire` = (WIRE_CODES[dtype],
    scaling block) and `blk` the scaling blocks a work item) on
    rank-stacked x and out through `ws`, at the workspace's next epoch
    (kept only when the launch went in)."""
    ws.poll()
    epoch = (ws.epoch + 1) & 0xFFFFFFFF
    land = ptr(ws.land_ptrs) if ws.land_ptrs is not None \
        else ctypes.c_void_p(None)
    kernel.launch(arm, dtype_code, *wire, ptr(x), ptr(out), land,
                  ptr(ws.pad_ptrs), ptr(ws.fault), epoch, int(budget_s * 1e9),
                  ws.n, count, blk, grid, stream_of(x))
    ws.epoch = epoch
    ws.launched()


# ---------------------------------------------------------------------------
# The fused AllGather + attention (csrc/sp_ag_attention.cu)
# ---------------------------------------------------------------------------

def sp_ag_workspace(device, n: int, s_loc: int, hkv: int, d: int, dtype,
                    causal: bool, chunk: int) -> Workspace:
    """The fused AG + attention's workspace ("sp_ag_attention[causal]" or
    "[full]": a causal call pushes only to later ranks, so the two keep
    their own counters): rank r's landing region is (2, n, s_loc, hkv, d),
    slot [0, s] the K shard of source s and [1, s] its V shard, row-major
    so a chunk of whole rows of all heads is contiguous; its pad holds the
    barrier counter (slot 0) and one signal per (source s, chunk c) of
    `chunk` rows (the kernel's `tdt_sp_ag_chunk_rows(s_loc)`) at 1 + s *
    nchunk + c."""
    nchunk = -(-s_loc // chunk)

    def describe(sig):
        if sig == 0:
            return "barrier_all"
        s, c = divmod(sig - 1, nchunk)
        return (f"kv rows {c * chunk}..{min((c + 1) * chunk, s_loc) - 1} "
                f"(chunk {c}) from source rank {s}")

    op = f"sp_ag_attention[{'causal' if causal else 'full'}]"
    return workspace(op, device, n, (2, n, s_loc, hkv, d), dtype,
                     1 + n * nchunk, describe)


def launch_sp_ag(kernel, ws: Workspace, q, k, v, qmeta, out, *, causal: bool,
                 scale: float, budget_s: float = WAIT_BUDGET_S,
                 grid: int = 0) -> None:
    """Launch csrc/sp_ag_attention.cu (a CudaKernel over SP_AG_ARGTYPES) on
    the rank-stacked q (n, S, H, D), k / v (n, S, Hkv, D), the optional
    sideband qmeta (n, >= S, 128) int32 and out (n, S, H, D) through `ws`,
    at the workspace's next epoch (kept only when the launch went in)."""
    ws.poll()
    epoch = (ws.epoch + 1) & 0xFFFFFFFF
    n, S, H, D = q.shape
    meta = ctypes.c_void_p(None) if qmeta is None else ptr(qmeta)
    kernel.launch(ptr(q), ptr(k), ptr(v), meta, ptr(out), ptr(ws.land_ptrs),
                  ptr(ws.pad_ptrs), ptr(ws.fault), epoch, int(budget_s * 1e9),
                  n, S, H, k.shape[2], D,
                  0 if qmeta is None else qmeta.shape[1], int(causal),
                  float(scale), grid, stream_of(q))
    ws.epoch = epoch
    ws.launched()
