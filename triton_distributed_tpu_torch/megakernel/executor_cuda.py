"""The persistent CUDA megakernel's host side, and its plain version
(counterpart of the host side of
triton_distributed_tpu/megakernel/executor_pallas.py::ExecutorPallas).

A graph compiles into:

- a task per compute node (the scheduler's "task"), cut into tiles by
  the Hopper decomposition of `_tiling`: LINEAR in 32-column tiles for a
  decode row block (<= 8 rows) and 64x64 tiles above that; RMS_NORM,
  SILU_MUL, ADD and the cache appends KVA_K / KVA_V in row tiles of
  ceil(S / n_sm) rows; ATTN in (row tile, kv head) tiles whose G q heads
  share every K/V row; the paged serving ops ATTN_P in (slot, kv head)
  tiles and the paged appends KVA_PK / KVA_PV in one tile per slot, each
  over the slot's run-time width of rows (one when decoding, the
  candidates of a speculative verify step); a
  `moe_ffn` node becomes TWO GROUPED_GEMM tasks: phase 0 (routing and the
  gate / up dots) in (row, k, 64-column strip of I) tiles, writing the
  routed activations to an arena scratch of (S, top_k * I), and phase 1
  (the down projection and the combine, after phase 0) in (row,
  32-column strip of H) tiles;
- one descriptor row per task (`desc`, int64 (n_tasks, NF)): op code,
  tile count, the task's slice of the flat dependency list (`deps`: the
  producer tasks of its inputs), device addresses of its operands, their
  leading dimensions, its tile geometry and the attention constants;
- with `fuse_elementwise` / `fuse_kv_append` (a decode-depth program of
  at most SKINNY_ROWS rows), the fused program of `_fusion_plan`: an
  RMS_NORM or SILU_MUL feeding only LINEAR A operands becomes that
  LINEAR's prologue, an ADD of a LINEAR's sole output and an earlier
  residual becomes its epilogue, and an attention_kv's two kv_append
  nodes become its append. A fused-away node has no task; its readers
  wait on the task that writes its rows;
- per-SM queues from `scheduler.schedule` over `n_sm` cores (the
  card's SM count; on the CPU, where only the plain walk runs, `n_sm`
  may be given and defaults to the H100's 132) and a scoreboard of one
  counter per task;
- a persistent device arena holding every activation (and the graph's
  non-cache inputs), the per-layer caches, and the RoPE cos/sin table
  of `rope_cos_sin` (f32, one row per position).

An n-rank program (a graph with `all_reduce` nodes, built over a
`RankGroup` of n ranks) keeps one task per node and gives it n times the
tiles of one rank: tile t of rank r is r * tiles_per_rank + t, and every
descriptor carries a rank stride for each operand (the rank-stacked
weight shards, the arena, whose activations are held once a rank, the
caches or pools of each rank), by which the kernel moves the operand
pointers to rank r's before it runs the tile. So the scheduler, the
scoreboard and the deadlock argument are those of one rank, dependencies
stay node-level across the ranks (rank r's tile waits for every rank's
producer tiles), and one launch runs all n ranks' programs. An
all_reduce node is two AR tasks: phase 0, tile (r, row tile), pushes
rank r's rows of the partial into this node's landing block of every
peer (each rank's arena holds an (n x rows, cols) landing block per AR
node: no buffer is reused within a launch, so no parity chain) and
signals each peer; phase 1, after every phase-0 tile, waits each
source's signal (bounded: a lost signal records a fault naming the
task and the ranks) and sums the n partials in rank order in f32,
rounding once (RankGroup.psum's order). The signals are u32 counters
`signals` (AR nodes, n dst, n src, row tiles), never cleared: launch
`epoch` waits for the value epoch.

The descriptor table is built once per binding of weights and caches;
the run-time data of a launch is `cache_len`, or for a paged serving
program the per-slot lengths, the per-slot live widths (the rows of the
slot's tile that decode: a GROUPED_GEMM row past its slot's width routes
to no expert and reads no slab) and the (b_slots, max_pages) block
table, which one small host-to-device copy per step writes into a
persistent device buffer (and the scoreboard epoch, below). A program keeps one
cache_len or the per-slot vector, never both. On a CUDA device `step`
launches csrc/megakernel.cu (one cooperative launch, one CTA per SM) and
counts it in `MEGAKERNEL.launches`; on the CPU it runs the plain
version.

The plain version (`plain_walk`) reads the same descriptor rows and the
same queues and computes each task's tile with torch ops, taking at each
step the head of a queue, chosen by a seeded generator among those whose
producers are all complete; it raises if no head can run. So on the CPU
it checks what the kernel's correctness rests on — the decomposition,
the descriptors, the dependency lists and the deadlock argument — as
well as its arithmetic. It mirrors the kernel's rounding points (see
csrc/megakernel.cu), with one difference: its attention softmax is one
pass over all keys where the kernel's is online over 64-key chunks.

Scoreboard reset: counters are never cleared between launches. Launch
number `epoch` (1, 2, ...) waits until a producer's counter reaches
epoch x its tile count (wrapping u32 arithmetic). After a fault the host
zeroes them and restarts at epoch 1.
"""

from __future__ import annotations

import ctypes
import math
import random

import numpy as np
import torch

from .. import runtime
from ..ops._build import CudaKernel, ptr, stream_of
from ..ops.attention import rope_cos_sin
from ..ops.moe_utils import route_topk
from . import scheduler
from .builder import later_slice
from .executor_torch import (PAGED_OPS, as_tensor, check_ops,
                             has_all_reduce, identity_table, matmul_f32,
                             paged_geometry, slot_lengths)
from .graph import (TASK_ADD, TASK_AR, TASK_ATTN, TASK_ATTN_P,
                    TASK_GROUPED_GEMM, TASK_KVA_K, TASK_KVA_PK, TASK_KVA_PV,
                    TASK_KVA_V, TASK_LINEAR, TASK_RMS_NORM, TASK_SILU_MUL)

MEGAKERNEL = CudaKernel(
    "megakernel", "tdt_megakernel",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
    + [ctypes.c_uint, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])

H100_SMS = 132          # queues for the CPU walk default to the H100's SMs
SKINNY_ROWS = 8         # LINEAR: up to this many rows, 32-column tiles
SKINNY_TN = 32
TILED_TM = TILED_TN = 64
QR_MAX = 64             # ATTN: q rows (G x rows per tile) of one task
KERNEL_HEAD_DIMS = (64, 128)
MOE_STRIP = 64          # GROUPED_GEMM phase 0: columns of I per tile
MOE_OUT_TN = 32         # GROUPED_GEMM phase 1: columns of H per tile
MOE_MAX_EXPERTS = 256   # the routing warp holds 8 experts a lane
MOE_MAX_TOPK = 32
STAGED_FLOATS = 16384   # the kernel stages an x or act row as f32 floats
WAIT_BUDGET_S = 1.0     # a scoreboard wait longer than this is a fault

# descriptor fields (csrc/megakernel.cu keeps the same numbering). The
# fused LINEAR's prologue (F_PRO: PRO_NONE, PRO_RMS with the norm weight
# at F_P and its eps at F_EPS, PRO_SILU with the up rows at F_P, F_LDP)
# and epilogue residual (F_R, F_LDR; 0: none); F_APPEND: an ATTN that
# appends its rows' K / V to its caches. An n-rank program: F_NR ranks of
# F_TPR tiles each, the kernel's copy of the row for rank r holds r at
# F_RANK and each operand pointer moved by r x its rank stride (elements;
# F_RS_OUT .. F_RS_R, in the order of RANKED); an AR task's signal block at
# F_SIG.
(F_OP, F_TILES, F_DEP_LO, F_DEP_HI, F_OUT, F_A, F_B, F_C, F_D, F_E, F_M,
 F_N, F_K, F_LDA, F_LDB, F_LDO, F_TR, F_NCT, F_TN, F_H, F_HKV, F_HD,
 F_QKN, F_CACHED, F_CAUSAL, F_EPS, F_SCALE, F_COS, F_SIN, F_LDC,
 F_MODE, F_BLOCK, F_SROWS, F_MAXP, F_NE, F_TOPK, F_INTER, F_NORMK,
 F_PHASE, F_LDD, F_LDE, F_PRO, F_P, F_LDP, F_R, F_LDR,
 F_APPEND, F_NR, F_TPR, F_RANK, F_RS_OUT, F_RS_A, F_RS_B, F_RS_C, F_RS_D,
 F_RS_E, F_RS_P, F_RS_R, F_SIG) = range(59)
NF = 59
PRO_NONE, PRO_RMS, PRO_SILU = 0, 1, 2
# the operand slots that move with the rank, and their pointer fields
RANKED = ("out", "a", "b", "c", "d", "e", "p", "r")
_PTR = dict(zip(RANKED, (F_OUT, F_A, F_B, F_C, F_D, F_E, F_P, F_R)))

_FAULTS = {1: "a scoreboard wait passed its budget",
           2: "a descriptor names an op the kernel does not have",
           3: "an all_reduce signal wait passed its budget"}


def indexed(device) -> torch.device:
    """`device` with its index filled in (cuda -> cuda:N), so that it
    compares equal to a tensor's device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _f32_bits(x: float) -> int:
    return int(np.array(x, np.float32).view(np.int32))


def _bits_f32(b: int) -> float:
    return float(np.array(b, np.int64).astype(np.int32).view(np.float32))


class ExecutorCuda:
    """Compile a builder graph into the persistent CUDA megakernel."""

    def __init__(self, builder, *, device=None, n_sm: int | None = None,
                 fuse_elementwise: bool = False,
                 fuse_kv_append: bool = False,
                 fuse_collective: bool = False):
        g = builder.graph
        check_ops(g)
        if fuse_collective:
            raise later_slice(
                "compile('kernel', fuse_collective=True)", "6",
                " (the TASK_GEMM_AR body, ROADMAP Queue B 17: the JAX "
                "MegaServe keeps it off at n ranks)")
        self.builder = builder
        self.graph = g
        self.device = indexed(runtime.resolve_device(device))
        self.dtype = runtime.resolve_dtype(builder.dtype)
        if self.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"the megakernel takes float32 or bfloat16 "
                            f"graphs, got {self.dtype}")
        cuda = self.device.type == "cuda"
        if cuda and n_sm is not None:
            raise ValueError(
                "n_sm sets the queues of the plain walk on the CPU; on a "
                "GPU the kernel runs one CTA on every SM of the card")
        if cuda:
            n_sm = torch.cuda.get_device_properties(
                self.device).multi_processor_count
        self.n_sm = int(H100_SMS if n_sm is None else n_sm)
        self.wait_budget_ns = int(WAIT_BUDGET_S * 1e9)
        self.eps = float(builder.rms_eps)
        # an n-rank program: every operand rank-stacked, n x the tiles
        self.sharded = has_all_reduce(g)
        self.n_ranks = builder.num_ranks if self.sharded else 1
        if self.sharded and (fuse_elementwise or fuse_kv_append):
            raise ValueError("fuse_elementwise / fuse_kv_append: the fused "
                             "decode arms run one-rank programs")

        # one task per compute node that is not fused away, two for a
        # moe_ffn or all_reduce node (its phases; the node's output is
        # phase 1's, which depends on phase 0)
        nodes = [nd for nd in g.nodes if nd.op not in ("input", "weight")]
        self.fusion, away = self._fusion_plan(nodes, fuse_elementwise,
                                              fuse_kv_append)
        self.fused_away = [nd for nd in nodes if nd.out.idx in away]
        self.tasks, self.phases = [], []
        for nd in nodes:
            if nd.out.idx in away:
                continue
            two = nd.op in ("moe_ffn", "all_reduce")
            for ph in ((0, 1) if two else (0,)):
                self.tasks.append(nd)
                self.phases.append(ph)
        # the task that writes each tensor's rows: its own output, and a
        # fused task's also the ADD's output or the appended caches'
        writer = {}
        for t, nd in enumerate(self.tasks):
            fz = self.fusion.get(nd.out.idx, {})
            for h in (nd.out, *(x.out for x in (fz.get("add"),
                                               *fz.get("kv", ())) if x)):
                writer[h.idx] = t
        self.deps = []
        for t, nd in enumerate(self.tasks):
            dep = {writer[i] for i in self._reads(nd) if i in writer}
            self.deps.append(sorted(dep | {t - 1} if self.phases[t] else dep))
        self.tiling = []
        for nd, ph in zip(self.tasks, self.phases):
            til = self._tiling(nd, ph)
            til["tpr"] = til["tiles"]
            til["tiles"] *= self.n_ranks
            self.tiling.append(til)
        self.n_tiles = np.asarray([t["tiles"] for t in self.tiling], np.int32)
        self.queues, self.qlen = scheduler.schedule(self.n_tiles, self.n_sm)
        self._scalar_names = {nd.attrs["cache_len_name"] for nd in nodes
                              if nd.op in ("attention_kv", "kv_append")}
        if len(self._scalar_names) > 1:
            raise ValueError(f"one cache_len per program, got "
                             f"{sorted(self._scalar_names)}")
        self.paged = paged_geometry(g)       # a PagedGeometry, or None
        if self.paged is not None:
            self._scalar_names = {f"{self.paged.cache_len_name}{b}"
                                  for b in range(self.paged.b_slots)}
        # the largest cache_len whose S appended rows fit every cache
        self.max_cache_len = min(
            (nd.inputs[1].rows - nd.inputs[0].rows for nd in nodes
             if nd.op in ("attention_kv", "kv_append")), default=0)
        # a kv_append output is its cache: return the cache handle
        kv_out = {nd.out.idx: nd.inputs[1] for nd in nodes
                  if nd.op in ("kv_append", "kv_append_paged")}
        self._out_handles = [kv_out.get(h.idx, h) for h in g.outputs]
        if cuda:
            self._check_kernel_shapes()

        # persistent arena: every activation, and the non-cache inputs;
        # an n-rank program's holds them once a rank, (n, per rank)
        dt, dev, n = self.dtype, self.device, self.n_ranks
        self._views = {}
        acts = [(h.idx, h.shape) for name, h in g.inputs.items()
                if name not in g.caches]
        acts += [(nd.out.idx, nd.out.shape) for nd in nodes
                 if nd.out.idx not in kv_out]
        # a moe_ffn node's routed activations, (S, top_k * I): phase 0
        # writes them, phase 1 reads them
        acts += [(("moe", nd.out.idx),
                  (nd.out.rows, nd.attrs["top_k"] * nd.attrs["intermediate"]))
                 for nd in nodes if nd.op == "moe_ffn"]
        # an all_reduce node's landing block, (n x S, cols): source s's
        # rows at [s * S, (s + 1) * S)
        ars = [nd for nd in nodes if nd.op == "all_reduce"]
        acts += [(("land", nd.out.idx), (n * nd.out.rows, nd.out.cols))
                 for nd in ars]
        offs, total = [], 0
        for key, (r, c) in acts:
            offs.append(total)
            total += runtime.round_up(r * c, 8)
        total = max(total, 8)
        if self.sharded:
            self.arena = torch.zeros((n, total), dtype=dt, device=dev)
            for (key, (r, c)), o in zip(acts, offs):
                self._views[key] = self.arena[:, o:o + r * c].view(n, r, c)
        else:
            self.arena = torch.zeros(total, dtype=dt, device=dev)
            for (key, (r, c)), o in zip(acts, offs):
                self._views[key] = self.arena[o:o + r * c].view(r, c)
        self.inputs = {name: self._views[h.idx]
                       for name, h in g.inputs.items() if name not in g.caches}
        # the AR signals: (AR nodes, n dst, n src, row tiles of a rank)
        self._ar_index = {nd.out.idx: i for i, nd in enumerate(ars)}
        tpr = max((til["tpr"] for nd, til in zip(self.tasks, self.tiling)
                   if nd.op == "all_reduce"), default=1)
        self.signals = torch.zeros((max(len(ars), 1), n, n, tpr),
                                   dtype=torch.int32, device=dev)

        # RoPE tables, one per (head_dim, theta): row p = position p, for
        # every position a program can reach (cache rows, or S rows)
        lengths = {}
        for nd in self.tasks:
            if nd.op in ("attention", "attention_kv", "kv_append") \
                    or nd.op in PAGED_OPS:
                key = (nd.attrs["head_dim"], float(nd.attrs["rope_theta"]))
                rows = (nd.attrs["max_pages"] * nd.attrs["block"]
                        if nd.op in PAGED_OPS
                        else max(h.rows for h in nd.inputs[:2]))
                lengths[key] = max(lengths.get(key, 0), rows)
        self._rope = {(d, th): rope_cos_sin(torch.arange(rows, device=dev), d,
                                            th)
                      for (d, th), rows in lengths.items()}
        self.weights: dict = {}
        self.caches: dict = {}
        self.counts = torch.zeros(len(self.tasks), dtype=torch.int32,
                                  device=dev)
        self.fault = torch.zeros(4, dtype=torch.int32, device=dev)
        self.epoch = 0
        self._desc = None
        # a paged program's run-time data: the per-slot lengths and live
        # widths, then the block table, in one device buffer that one
        # asynchronous copy per step fills from a pinned host buffer; the
        # host rewrites that buffer once the previous step's copy has
        # left it
        self._rt = None
        if self.paged is not None and cuda:
            nb, mp = self.paged.b_slots, self.paged.max_pages
            self._rt = torch.zeros(nb * (2 + mp), dtype=torch.int32,
                                   device=dev)
            self._rt_host = torch.zeros(nb * (2 + mp), dtype=torch.int32,
                                        pin_memory=True)
            self._rt_copied = torch.cuda.Event()

    def _shape(self, shape) -> tuple:
        """An operand's shape as bound: with the leading rank dimension in
        an n-rank program."""
        return ((self.n_ranks,) if self.sharded else ()) + tuple(shape)

    # -- fusion ----------------------------------------------------------
    def _fusion_plan(self, nodes, fuse_elementwise, fuse_kv_append):
        """The fused decode program (ExecutorPallas's selection rules at
        one core, executor_pallas.py:2214-2245, :2470-2545). Returns
        ({linear / attention_kv output index: {"rms": norm node, "silu":
        silu node, "add": add node, "kv": (k node, v node)}}, the output
        indices of the nodes fused away).

        fuse_elementwise: an rms_norm that is not a graph output and
        whose consumers are all LINEARs reading it as A (JAX folds these
        at one core whatever the flag; the port only under it, so its
        default program stays node-level); a silu_mul likewise, both of
        its sources activations; an add(linear_out, resid) whose linear
        is not a graph output and has the add as its sole consumer, the
        resid an input or the output of a node before the linear.
        fuse_kv_append: an attention_kv with exactly one kv_append of
        each part on its qkv and caches (and its k_norm and RoPE).
        Either flag needs a decode-depth program: every row block within
        one skinny LINEAR tile (SKINNY_ROWS rows); the 64x64 LINEAR and
        a multi-chunk prefill have no fused arm."""
        if not (fuse_elementwise or fuse_kv_append):
            return {}, set()
        rows = max((nd.inputs[0].rows for nd in nodes), default=0)
        if rows > SKINNY_ROWS:
            raise ValueError(
                f"fuse_elementwise / fuse_kv_append: a program of {rows} "
                f"rows; the fused LINEAR arms are the skinny decode form "
                f"(at most {SKINNY_ROWS} rows)")
        g = self.graph
        consumers = g.consumers()
        out_ids = {h.idx for h in g.outputs}
        order = {nd.out.idx: i for i, nd in enumerate(nodes)}
        arena = {h.idx for n, h in g.inputs.items() if n not in g.caches} \
            | {nd.out.idx for nd in nodes}
        plan, away = {}, set()

        def only_linear_a(nd):
            cons = consumers.get(nd.out.idx, [])
            return nd.out.idx not in out_ids and bool(cons) and all(
                c.op == "linear" and c.inputs[0].idx == nd.out.idx
                for c in cons)

        if fuse_elementwise:
            for nd in nodes:
                pro = None
                if nd.op == "rms_norm" and only_linear_a(nd):
                    pro = "rms"
                elif nd.op == "silu_mul" and only_linear_a(nd) and all(
                        h.idx in arena for h in nd.inputs):
                    pro = "silu"
                if pro:
                    for c in consumers[nd.out.idx]:
                        plan.setdefault(c.out.idx, {})[pro] = nd
                    away.add(nd.out.idx)
                elif nd.op == "add":
                    for lin_h, other in (nd.inputs, nd.inputs[::-1]):
                        prod = g.producer(lin_h)
                        if (prod is None or prod.op != "linear"
                                or other.idx not in arena
                                or prod.out.idx in out_ids
                                or "add" in plan.get(prod.out.idx, {})
                                or len(consumers.get(lin_h.idx, [])) != 1
                                or order.get(other.idx, -1)
                                >= order[prod.out.idx]):
                            continue
                        plan.setdefault(prod.out.idx, {})["add"] = nd
                        plan[prod.out.idx]["resid"] = other
                        away.add(nd.out.idx)
                        break
        if fuse_kv_append:
            for nd in nodes:
                if nd.op != "attention_kv":
                    continue
                qkv, kc, vc = nd.inputs[:3]
                kn = nd.inputs[4].idx if len(nd.inputs) > 4 else None
                parts = {}
                for a in nodes:
                    if a.op == "kv_append" and a.inputs[0].idx == qkv.idx \
                            and a.inputs[1].idx in (kc.idx, vc.idx):
                        parts.setdefault(a.attrs["part"], []).append(a)
                ks, vs = parts.get("k", []), parts.get("v", [])
                if not (len(ks) == 1 and len(vs) == 1
                        and ks[0].inputs[1].idx == kc.idx
                        and vs[0].inputs[1].idx == vc.idx
                        and (ks[0].inputs[2].idx if len(ks[0].inputs) > 2
                             else None) == kn
                        and all(a.attrs["rope_theta"] == nd.attrs["rope_theta"]
                                for a in (ks[0], vs[0]))):
                    continue
                plan.setdefault(nd.out.idx, {})["kv"] = (ks[0], vs[0])
                away |= {ks[0].out.idx, vs[0].out.idx}
        return plan, away

    def _reads(self, nd):
        """The tensor indices a task of node `nd` reads: its inputs, with
        a fused prologue's source in place of the norm / silu output and
        a fused epilogue's residual."""
        fz = self.fusion.get(nd.out.idx, {})
        ins = list(nd.inputs)
        pro = fz.get("rms") or fz.get("silu")
        if pro is not None:
            ins[0:1] = pro.inputs
        if "resid" in fz:
            ins.append(fz["resid"])
        return [h.idx for h in ins]

    # -- decomposition ---------------------------------------------------
    def _tiling(self, nd, phase: int = 0) -> dict:
        """The Hopper task decomposition of one node (of one phase of a
        moe_ffn node): rows per tile (tr), and for LINEAR columns per
        tile (tn), column tiles (nct) and the body's mode (0: <= 8 rows,
        32-column tiles; 1: 64x64 tiles). A GROUPED_GEMM tile is one
        row: in phase 0 a (row, k, strip of I) tile, in phase 1 a (row,
        strip of H) tile; nct counts the strips. An AR tile (either
        phase) is a row tile at full width. The tiles are one rank's."""
        S = nd.inputs[0].rows
        rows_tile = runtime.cdiv(S, self.n_sm)
        if nd.op == "moe_ffn":
            at = nd.attrs
            if phase == 0:
                nct = runtime.cdiv(at["intermediate"], MOE_STRIP)
                return dict(op=TASK_GROUPED_GEMM, tr=1, tn=MOE_STRIP,
                            nct=nct, tiles=S * at["top_k"] * nct)
            nct = runtime.cdiv(nd.out.cols, MOE_OUT_TN)
            return dict(op=TASK_GROUPED_GEMM, tr=1, tn=MOE_OUT_TN, nct=nct,
                        tiles=S * nct)
        if nd.op == "linear":
            N = nd.out.cols
            if S <= SKINNY_ROWS:
                tr, tn, mode = S, SKINNY_TN, 0
            else:
                tr, tn, mode = TILED_TM, TILED_TN, 1
            nct = runtime.cdiv(N, tn)
            return dict(op=TASK_LINEAR, tr=tr, tn=tn, nct=nct, mode=mode,
                        tiles=runtime.cdiv(S, tr) * nct)
        if nd.op in ("attention", "attention_kv", "attention_paged"):
            at = nd.attrs
            G = at["num_heads"] // at["num_kv_heads"]
            if at["num_heads"] % at["num_kv_heads"] or G > QR_MAX:
                raise ValueError(
                    f"attention: {at['num_heads']} q heads over "
                    f"{at['num_kv_heads']} kv heads; the ATTN body takes "
                    f"groups of 1..{QR_MAX} q heads")
            if nd.op == "attention_paged":   # one tile per (slot, kv head)
                R = at["slot_rows"]
                return dict(op=TASK_ATTN_P, tr=R,
                            tiles=S // R * at["num_kv_heads"])
            tr = min(S, max(1, QR_MAX // G))
            return dict(op=TASK_ATTN, tr=tr,
                        tiles=runtime.cdiv(S, tr) * at["num_kv_heads"])
        if nd.op == "kv_append_paged":       # one tile per slot
            R = nd.attrs["slot_rows"]
            op = TASK_KVA_PK if nd.attrs["part"] == "k" else TASK_KVA_PV
            return dict(op=op, tr=R, tiles=S // R)
        if nd.op == "all_reduce":            # either phase: row tiles
            return dict(op=TASK_AR, tr=rows_tile,
                        tiles=runtime.cdiv(S, rows_tile))
        op = {"rms_norm": TASK_RMS_NORM, "silu_mul": TASK_SILU_MUL,
              "add": TASK_ADD}.get(nd.op)
        if nd.op == "kv_append":
            op = TASK_KVA_K if nd.attrs["part"] == "k" else TASK_KVA_V
        return dict(op=op, tr=rows_tile, tiles=runtime.cdiv(S, rows_tile))

    def _check_kernel_shapes(self):
        """Refuse, before anything runs, what the CUDA kernel does not
        take: a head_dim other than 64 or 128, widths that are not a
        multiple of 8 (16-byte weight vectors), a paged attention whose
        group x slot_rows q rows exceed one tile's QR_MAX, and a moe_ffn
        with more experts than the routing warp reaches, a top_k over
        MOE_MAX_TOPK, an I or H that is not a multiple of its strip, or
        an x row or act row larger than the staged floats; and a LINEAR
        with a fused RMS prologue whose rows do not fit the staged x
        rows at once (the norm needs each whole row; the kernel stages
        XS_FLOATS / R floats a row for R = tr rounded up to 1, 2, 4, 8)."""
        for t, nd in enumerate(self.tasks):
            if "rms" in self.fusion.get(nd.out.idx, {}):
                tr = self.tiling[t]["tr"]
                cap = STAGED_FLOATS // next(r for r in (1, 2, 4, 8)
                                            if tr <= r or r == 8)
                if nd.inputs[0].cols > cap:
                    raise ValueError(
                        f"megakernel: a LINEAR with a fused RMS_NORM of "
                        f"width {nd.inputs[0].cols} at {tr} rows exceeds "
                        f"the {cap} staged floats a row")
            if nd.op == "moe_ffn":
                at = nd.attrs
                E, k, inter = at["num_experts"], at["top_k"], \
                    at["intermediate"]
                H = nd.out.cols
                for bad, what in (
                        (E > MOE_MAX_EXPERTS,
                         f"{E} experts: the routing warp reaches "
                         f"{MOE_MAX_EXPERTS}"),
                        (k > MOE_MAX_TOPK,
                         f"top_k {k}: at most {MOE_MAX_TOPK}"),
                        (inter % MOE_STRIP,
                         f"intermediate {inter} is not a multiple of "
                         f"{MOE_STRIP}"),
                        (H % MOE_OUT_TN,
                         f"hidden {H} is not a multiple of {MOE_OUT_TN}"),
                        (max(H, k * inter) > STAGED_FLOATS,
                         f"hidden {H} or top_k x intermediate {k * inter} "
                         f"exceeds the {STAGED_FLOATS} staged floats")):
                    if bad:
                        raise ValueError(f"megakernel moe_ffn: {what}")
            if nd.op == "attention_paged":
                at = nd.attrs
                G = at["num_heads"] // at["num_kv_heads"]
                if G * at["slot_rows"] > QR_MAX:
                    raise ValueError(
                        f"megakernel attention_paged: {G} q heads a kv head "
                        f"x slot_rows {at['slot_rows']} exceeds the "
                        f"{QR_MAX} q rows of one ATTN_P tile (a verify step "
                        f"runs up to slot_rows rows a slot)")
            if nd.op in ("attention", "attention_kv", "kv_append",
                         *PAGED_OPS) \
                    and nd.attrs["head_dim"] not in KERNEL_HEAD_DIMS:
                raise ValueError(
                    f"megakernel: head_dim {nd.attrs['head_dim']} not in "
                    f"{KERNEL_HEAD_DIMS}")
            for h in (nd.out,) + tuple(nd.inputs):
                if h.cols % 8:
                    raise ValueError(
                        f"megakernel: tensor width {h.cols} of a "
                        f"{nd.op} node is not a multiple of 8")

    # -- binding ---------------------------------------------------------
    def _check_operand(self, name, t, shape):
        shape = self._shape(shape)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, the graph "
                             f"declares {tuple(shape)}")
        if t.dtype != self.dtype or t.device != self.device:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, the program "
                             f"runs {self.dtype} on {self.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: rows must be contiguous")
        if self.device.type == "cuda" and (t.data_ptr() % 16 or any(
                (st * t.element_size()) % 16 and sz > 1
                for st, sz in zip(t.stride()[:-1], t.shape[:-1]))):
            raise ValueError(f"{name}: the kernel needs 16-byte aligned "
                             f"rows (and ranks)")

    def bind_weights(self, weights: dict):
        """Use these tensors (views are fine: rows contiguous, any row
        stride) as the program's weights, without copying them. An n-rank
        program takes them rank-stacked, (n, *shape), any rank stride (0
        for a weight every rank holds alike)."""
        g = self.graph
        missing = set(g.weights) - set(weights)
        if missing:
            raise KeyError(f"missing weights {sorted(missing)}")
        for n, h in g.weights.items():
            self._check_operand(n, weights[n], h.shape)
        self.weights = {n: weights[n] for n in g.weights}
        self._desc = None

    def bind_caches(self, caches: dict | None = None):
        """Use these (max_cache, Hkv*D) tensors as the caches, updated in
        place by the kv_append tasks (an n-rank program's rank-stacked, one
        cache a rank); None allocates zeroed ones. Two programs given the
        same tensors share one cache."""
        g = self.graph
        if caches is None:
            caches = {n: torch.zeros(self._shape(h.shape), dtype=self.dtype,
                                     device=self.device)
                      for n, h in g.caches.items()}
        for n, h in g.caches.items():
            self._check_operand(n, caches[n], h.shape)
        self.caches = {n: caches[n] for n in g.caches}
        self._desc = None
        return self.caches

    def _tensor(self, h):
        """The bound tensor behind a handle."""
        g = self.graph
        if h.idx in self._views:
            return self._views[h.idx]
        for table, src in ((g.weights, self.weights), (g.caches, self.caches)):
            for n, hh in table.items():
                if hh.idx == h.idx:
                    return src[n]
        raise KeyError(h)

    # -- descriptor table --------------------------------------------------
    def descriptors(self):
        """(desc int64 (n_tasks, NF), deps int32) as numpy, and the
        per-task tensors behind each address (the plain walk's view of
        the same table; an n-rank program's rank-stacked). Built once per
        binding."""
        if self._desc is not None:
            return self._desc
        g = self.graph
        if set(self.weights) != set(g.weights):
            raise RuntimeError("bind_weights before running the program")
        if set(self.caches) != set(g.caches):
            self.bind_caches()
        sharded = self.sharded

        def loc(t):             # rank 0's operand
            return t[0] if sharded else t

        desc = np.zeros((len(self.tasks), NF), np.int64)
        flat, views = [], []
        for t, nd in enumerate(self.tasks):
            row, til, at = desc[t], self.tiling[t], nd.attrs
            row[F_OP], row[F_TILES], row[F_TR] = til["op"], til["tiles"], \
                til["tr"]
            row[F_NR], row[F_TPR] = self.n_ranks, til["tpr"]
            row[F_DEP_LO] = len(flat)
            flat += self.deps[t]
            row[F_DEP_HI] = len(flat)
            full = [self._tensor(h) for h in nd.inputs]
            if nd.op in ("kv_append", "kv_append_paged"):
                # a = qkv, e = k_norm; the output is the cache itself
                out = full[1]
                slots = {"a": full[0]}
                if len(full) > 2:
                    slots["e"] = full[2]
            else:
                out = self._views[nd.out.idx]
                slots = dict(zip("abcde", full))
            if nd.op == "moe_ffn":      # e: the routed activations
                slots["e"] = self._views[("moe", nd.out.idx)]
            if nd.op == "all_reduce":   # c: the node's landing block
                slots["c"] = self._views[("land", nd.out.idx)]
                sig = self.signals[self._ar_index[nd.out.idx]]
                row[F_SIG] = sig.data_ptr()
            fz = self.fusion.get(nd.out.idx, {})
            pro = fz.get("rms") or fz.get("silu")
            if pro is not None:         # a: the prologue's first source
                slots["a"] = full[0] = self._tensor(pro.inputs[0])
            if "add" in fz:             # out: the ADD's rows
                out = self._views[fz["add"].out.idx]
            v = {"out": out, **slots}
            if nd.op == "linear":
                if pro is not None:     # p: the norm weight / the up rows
                    v["p"] = self._tensor(pro.inputs[1])
                    row[F_LDP] = loc(v["p"]).stride(0)
                    row[F_PRO] = PRO_RMS if "rms" in fz else PRO_SILU
                    if "rms" in fz:
                        row[F_EPS] = _f32_bits(pro.attrs["eps"])
                if "resid" in fz:       # r: the residual rows
                    v["r"] = self._tensor(fz["resid"])
                    row[F_LDR] = loc(v["r"]).stride(0)
            for name, t_ in v.items():
                row[_PTR[name]] = loc(t_).data_ptr()
                if sharded:
                    row[F_RS_OUT + RANKED.index(name)] = t_.stride(0)
            ins = [loc(x) for x in full]
            o = loc(out)
            row[F_M] = nd.inputs[0].rows
            row[F_N] = nd.out.cols
            row[F_LDA] = ins[0].stride(0)
            row[F_LDO] = o.stride(0)
            if nd.op == "linear":
                row[F_K] = nd.inputs[0].cols
                row[F_LDB] = ins[1].stride(0)
                row[F_NCT], row[F_TN], row[F_MODE] = til["nct"], til["tn"], \
                    til["mode"]
            elif nd.op == "rms_norm":
                row[F_EPS] = _f32_bits(at["eps"])
            elif nd.op in ("silu_mul", "add"):
                row[F_LDB] = ins[1].stride(0)
            elif nd.op == "all_reduce":
                row[F_LDC] = loc(slots["c"]).stride(0)
                row[F_PHASE] = self.phases[t]
            elif nd.op == "moe_ffn":
                row[F_K] = nd.inputs[0].cols
                row[F_LDB], row[F_LDC], row[F_LDD], row[F_LDE] = (
                    t_.stride(0) for t_ in (ins[1], ins[2], ins[3],
                                            loc(slots["e"])))
                row[F_NCT], row[F_TN] = til["nct"], til["tn"]
                row[F_NE], row[F_TOPK], row[F_INTER] = \
                    at["num_experts"], at["top_k"], at["intermediate"]
                row[F_NORMK] = int(at.get("norm_topk", True))
                row[F_PHASE] = self.phases[t]
                # a paged program's rows are live up to their slot's
                # width (F_SROWS rows a slot); another program's all are
                if self.paged is not None:
                    row[F_SROWS] = self.paged.slot_rows
            else:  # attention / attention_kv / kv_append, and the paged ops
                d = at["head_dim"]
                row[F_H], row[F_HKV], row[F_HD] = at["num_heads"], \
                    at["num_kv_heads"], d
                row[F_QKN] = int(at.get("qk_norm", False))
                row[F_CACHED] = int(nd.op != "attention")
                row[F_CAUSAL] = int(at.get("causal", True))
                row[F_EPS] = _f32_bits(self.eps)
                row[F_SCALE] = _f32_bits(1.0 / math.sqrt(d))
                cos, sin = self._rope[(d, float(at["rope_theta"]))]
                row[F_COS], row[F_SIN] = cos.data_ptr(), sin.data_ptr()
                v["cos"], v["sin"] = cos, sin
                cache = o if nd.op in ("kv_append", "kv_append_paged") \
                    else ins[1] if nd.op != "attention" else None
                if cache is not None:
                    row[F_LDC] = cache.stride(0)
                if nd.op in ("attention_kv", "attention_paged") \
                        and ins[2].stride(0) != ins[1].stride(0):
                    raise ValueError(f"{nd.op}: the K and V caches must "
                                     f"share a row stride")
                row[F_APPEND] = int("kv" in fz)
                if nd.op in PAGED_OPS:
                    row[F_BLOCK], row[F_SROWS], row[F_MAXP] = \
                        at["block"], at["slot_rows"], at["max_pages"]
            views.append(v)
        deps = np.asarray(flat if flat else [0], np.int32)
        dev = self.device
        self._desc = (desc, deps, views,
                      torch.from_numpy(desc).to(dev),
                      torch.from_numpy(deps).to(dev),
                      torch.from_numpy(self.queues).to(dev),
                      torch.from_numpy(self.qlen).to(dev))
        return self._desc

    # -- running ---------------------------------------------------------
    def step(self, inputs: dict | None = None, cache_len: int = 0, *,
             cache_lens=None, block_table=None, widths=None,
             plain: bool = False, seed: int = 0):
        """Copy `inputs` into the arena, run the program once, and return
        the graph outputs as views of the arena (overwritten by the next
        step; a kv_append output is its cache). A program runs at
        `cache_len`; a paged serving program at the per-slot
        `cache_lens` (b_slots,) through `block_table` (b_slots,
        max_pages), with the per-slot live `widths` (b_slots,) in
        [0, slot_rows] (default 1: each slot's first row), all host
        arrays, uploaded to the device together in one copy. A slot of
        width w > 1 is a verify step: its rows 0..w-1 sit at positions
        cache_len_b + j, attend the prefix and rows 0..j, and append all
        w rows; width 0 (an idle slot) still runs its first row against
        its own pages, as width 1, while a moe_ffn row at or past its
        slot's width routes to no expert and gives 0.
        On a CUDA device this is one kernel launch, with no host sync;
        `plain=True` runs the plain walk instead (for comparisons). An
        n-rank program's inputs and outputs are rank-stacked (an input
        given without the rank dimension is copied to every rank; the
        outputs that all_reduce nodes leave alike on every rank are
        rank 0's `[0]`); one launch runs every rank."""
        cache_len = int(cache_len)
        lens = btab = wid = None
        if self.paged is not None:
            if cache_len:
                raise ValueError("a paged program runs at the per-slot "
                                 "cache_lens, not at one cache_len")
            wid = self._slot_widths(widths)
            lens, btab = self._paged_run_data(cache_lens, block_table, wid)
        elif cache_lens is not None or block_table is not None \
                or widths is not None:
            raise ValueError("cache_lens / block_table / widths: this "
                             "program has no paged node")
        elif not 0 <= cache_len <= self.max_cache_len:
            raise ValueError(f"cache_len {cache_len}: the step's rows must "
                             f"fit the caches (0 <= cache_len <= "
                             f"{self.max_cache_len})")
        for n, v in (inputs or {}).items():
            self.inputs[n].copy_(v)
        desc, deps, views, d_desc, d_deps, d_q, d_qlen = self.descriptors()
        if plain or self.device.type == "cpu":
            plain_walk(self, cache_len, seed=seed, lens=lens, btab=btab,
                       widths=wid)
        else:
            lens_p = wid_p = btab_p = ld_btab = 0
            if lens is not None:
                nb = lens.shape[0]
                self._rt_copied.synchronize()
                host = self._rt_host.numpy()
                host[:nb] = lens
                host[nb:2 * nb] = wid
                host[2 * nb:] = btab.reshape(-1)
                self._rt.copy_(self._rt_host, non_blocking=True)
                self._rt_copied.record()
                base = self._rt.data_ptr()
                lens_p = ctypes.c_void_p(base)
                wid_p = ctypes.c_void_p(base + 4 * nb)
                btab_p = ctypes.c_void_p(base + 8 * nb)
                ld_btab = btab.shape[1]
            self.epoch += 1
            MEGAKERNEL.launch(
                ptr(d_desc), ptr(d_deps), ptr(d_q), ptr(d_qlen),
                ptr(self.counts), ptr(self.fault), lens_p, wid_p, btab_p,
                self.n_sm, self.queues.shape[1], cache_len, ld_btab,
                ctypes.c_uint(self.epoch & 0xFFFFFFFF),
                ctypes.c_longlong(self.wait_budget_ns),
                int(self.dtype == torch.bfloat16), stream_of(self.arena))
        return self.outputs()

    def _paged_run_data(self, cache_lens, block_table, widths=None):
        """Check a paged step's lengths and table on the host and return
        them as int32 numpy arrays. Slot b appends max(1, widths[b]) rows
        (default one) at positions [cache_lens[b], + that). Refused: an
        append row past the slot's max_pages pages, a page id outside the
        pool among the pages a slot reads or appends to, and a table
        whose appends would land on one pool row twice or on a row that
        a slot of the same launch reads (the kernel reads the pool
        through the read-only cache; see csrc/megakernel.cu)."""
        nb, _, blk, mp, _ = self.paged
        if cache_lens is None or block_table is None:
            raise ValueError("a paged program needs cache_lens and "
                             "block_table")
        lens = np.asarray(torch.as_tensor(cache_lens).cpu(),
                          np.int32).reshape(-1)
        btab = np.ascontiguousarray(
            np.asarray(torch.as_tensor(block_table).cpu(), np.int32))
        if lens.shape != (nb,) or btab.shape != (nb, mp):
            raise ValueError(f"cache_lens {lens.shape} / block_table "
                             f"{btab.shape}: the program takes ({nb},) / "
                             f"{(nb, mp)}")
        w = np.maximum(np.ones(nb, np.int64) if widths is None
                       else np.asarray(widths, np.int64), 1)
        if not ((lens >= 0) & (lens + w <= mp * blk)).all():
            raise ValueError(f"cache_lens {lens.tolist()} with widths "
                             f"{w.tolist()}: each slot's appended rows must "
                             f"lie in [0, {mp * blk}) (max_pages x block)")
        pool_pages = self.graph.caches[next(iter(self.graph.caches))].rows \
            // blk
        cols = np.arange(mp)[None, :]
        used = cols <= ((lens + w - 1) // blk)[:, None]   # read or appended
        if ((btab < 0) | (btab >= pool_pages))[used].any():
            raise ValueError(f"block_table names a page outside the pool "
                             f"[0, {pool_pages}) among the pages a slot "
                             f"uses")
        # rows of each column a slot reads, and where each appended row
        # of each slot lands
        read = np.clip(lens[:, None] - cols * blk, 0, blk)        # (nb, mp)
        pos = lens[:, None] + np.arange(int(w.max()))[None, :]   # (nb, W)
        live = pos < (lens + w)[:, None]
        ap = btab[np.arange(nb)[:, None], np.minimum(pos // blk, mp - 1)]
        ar = pos % blk
        clash = (btab[None, None] == ap[:, :, None, None]) \
            & (ar[:, :, None, None] < read[None, None]) \
            & live[:, :, None, None]
        dest = (ap.astype(np.int64) * blk + ar)[live]
        if clash.any() or np.unique(dest).size < dest.size:
            raise ValueError("block_table: a slot's append lands on a pool "
                             "row that another slot reads or appends to "
                             "in the same step")
        return lens, btab

    def _slot_widths(self, widths):
        """A paged step's per-slot live widths as int32 numpy (default:
        one live row a slot), each in [0, slot_rows]."""
        nb, R = self.paged.b_slots, self.paged.slot_rows
        if widths is None:
            return np.ones(nb, np.int32)
        if isinstance(widths, torch.Tensor):
            widths = widths.cpu()
        wid = np.asarray(widths, np.int32).reshape(-1)
        if wid.shape != (nb,) or not ((wid >= 0) & (wid <= R)).all():
            raise ValueError(f"widths {wid.tolist()}: one per slot "
                             f"({nb}), each in [0, {R}] (slot_rows)")
        return wid

    def outputs(self):
        return tuple(self._tensor(h) for h in self._out_handles)

    def check_fault(self):
        """Raise if a launch since the last check recorded a fault
        (reads a device flag: synchronises). The message names the
        waiting task and the first unfinished task of the order (the one
        that could not run); when that is an AR sum, also the push it
        never saw, read from the signal counters (whichever wait ran out
        of budget first: the sum's, or a later task's on the
        scoreboard). The scoreboard and the signals are reset so the
        program can run again."""
        if self.device.type != "cuda":
            return
        code, task, dep, dst = self.fault.cpu().tolist()
        if code == 0:
            return
        # the first task of the topological order left unfinished is the
        # one that could not run (every task before it did)
        left = (self.counts.cpu().numpy().astype(np.int64)
                - self.epoch * self.n_tiles.astype(np.int64)) % 2 ** 32
        first = int(np.flatnonzero(left)[0]) if left.any() else -1
        lost = ""
        if first >= 0 and self.tasks[first].op == "all_reduce":
            sig = self.signals[self._ar_index[self.tasks[first].out.idx]]
            miss = (sig.cpu().numpy().astype(np.int64) - self.epoch) % 2 ** 32
            for d, s_, t in zip(*np.nonzero(miss)):
                if d != s_:
                    lost = (f"; its sum on rank {d} never saw rank {s_}'s "
                            f"push (row tile {t})")
                    break
        self.counts.zero_()
        self.fault.zero_()
        self.signals.zero_()
        self.epoch = 0

        def name(t):
            return f"task {t} ({self.tasks[t].op})" \
                if 0 <= t < len(self.tasks) else f"task {t}"

        what = name(task)
        if code == 1:
            what += f" waiting on {name(dep)}"
        elif code == 3:
            what += f" (AR phase 1) on rank {dst} never saw rank {dep}'s push"
        raise RuntimeError(f"megakernel: {_FAULTS.get(code, code)}: {what}; "
                           f"the first unfinished task is {name(first)}{lost}")

    def run(self, inputs: dict, weights: dict,
            scalars: dict | None = None, block_table=None):
        """Execute the program once (compat path): weights and caches are
        bound from the dicts (cache tensors already on the device in the
        graph dtype are updated in place), `scalars` carries cache_len
        (or a paged program's `{cache_len_name}{b}`), `block_table` a
        paged program's table (default: slot b owns pages
        [b*max_pages, (b+1)*max_pages)); every slot's first row is
        live. Returns the outputs (activations copied out of the
        arena). An n-rank program takes rank-stacked operands and runs as
        `run_sharded` (as the JAX ExecutorPallas.run does)."""
        if self.sharded:
            return self.run_sharded(inputs, weights, scalars, block_table)
        return self._run(inputs, weights, scalars, block_table)

    def _run(self, inputs, weights, scalars, block_table):
        scalars = dict(scalars or {})
        unknown = set(scalars) - self._scalar_names
        if unknown:
            raise ValueError(
                f"unknown scalars {sorted(unknown)}; this program "
                f"expects {sorted(self._scalar_names) or 'none'}")
        g = self.graph
        dt, dev = self.dtype, self.device
        self.bind_weights({n: as_tensor(weights[n], dt, dev)
                           for n in g.weights})
        if g.caches:
            self.bind_caches({n: as_tensor(inputs[n], dt, dev)
                              for n in g.caches})
        acts = {n: as_tensor(v, dt, dev) for n, v in inputs.items()
                if n not in g.caches}
        if self.paged is not None:
            outs = self.step(acts, cache_lens=slot_lengths(self.paged,
                                                           scalars),
                             block_table=identity_table(self.paged)
                             if block_table is None else block_table)
        else:
            outs = self.step(acts, next(iter(scalars.values()), 0),
                             block_table=block_table)
        self.check_fault()
        cache_ids = {id(t) for t in self.caches.values()}
        return tuple(o if id(o) in cache_ids else
                     (o[0] if self.sharded else o).clone() for o in outs)

    def _require_sharded(self, what):
        if not self.sharded:
            raise ValueError(f"{what} requires all_reduce nodes (per-rank "
                             f"partial-sum semantics); use run() / step() "
                             f"otherwise")

    def run_sharded(self, inputs: dict, weights: dict,
                    scalars: dict | None = None, block_table=None):
        """run() of per-rank operands (JAX ExecutorXLA.run_sharded /
        ExecutorPallas.run with AR nodes): every input, cache and weight
        with a leading rank dimension. Returns the cache outputs
        rank-stacked and the activations, which the all_reduce nodes leave
        alike on every rank, once (rank 0's, copied out)."""
        self._require_sharded("run_sharded")
        return self._run(inputs, weights, scalars, block_table)

    def step_fn_sharded(self):
        """The n-rank step (JAX ExecutorPallas.step_fn_sharded): a
        function of step()'s arguments that runs one launch for every rank
        and returns the outputs with the replicated activations once
        (rank 0's views) and the caches rank-stacked."""
        self._require_sharded("step_fn_sharded")
        cache_ids = {h.idx for h in self.graph.caches.values()}

        def stepper(inputs=None, cache_len=0, **kwargs):
            outs = self.step(inputs, cache_len, **kwargs)
            return tuple(o if h.idx in cache_ids else o[0]
                         for o, h in zip(outs, self._out_handles))

        return stepper

    def profile_tasks(self, *args, **kwargs):
        raise later_slice("profile_tasks", "7", " (tools and verification)")

    # -- cost model ------------------------------------------------------
    def live_rows(self, S: int, widths=None) -> np.ndarray:
        """Which of a moe_ffn node's S rows its tasks compute: a paged
        program's rows below their slot's width (default: one a slot),
        every row of another program."""
        if self.paged is None:
            return np.arange(S)
        R = self.paged.slot_rows
        wid = self._slot_widths(widths)
        r = np.arange(S)
        return r[r % R < wid[r // R]]

    def routed_experts(self, widths=None) -> dict:
        """{moe_ffn output index: the distinct experts its live rows
        route to} from the router-logit rows in the arena, so after a
        launch they are that launch's routing (route_topk on the logits
        the kernel routed; a near-tie may fall the other way there)."""
        out = {}
        for nd in self.tasks:
            if nd.op == "moe_ffn" and nd.out.idx not in out:
                rows = torch.from_numpy(self.live_rows(
                    nd.out.rows, widths)).to(self.device)
                logits = self._views[nd.inputs[1].idx][rows]
                _, ex = route_topk(logits, nd.attrs["top_k"])
                out[nd.out.idx] = sorted(set(ex.flatten().tolist()))
        return out

    def task_costs(self, cache_len: int = 0, cache_lens=None, widths=None,
                   experts: dict | None = None):
        """(flops, bytes) per task at `cache_len` (a paged program: at the
        per-slot `cache_lens` and live `widths`): each input read once,
        each output written once (a LINEAR's weight once, a cache prefix
        row once per kv head's K and V), as ExecutorPallas.task_costs
        counts each task. ATTN_P counts the cache_len_b prefix rows each
        slot reads (the CUDA body reads exactly those; the Pallas body
        reads whole pages, round_up(cache_len_b, block)) once for all of
        the slot's w = max(1, width) rows, those rows' q, k and v, and
        its output tile, pad rows included (written as zeros); its
        operations are the w rows' scores and PV products over the
        prefix and the causal candidates before them. KVA_P* counts the
        w rows a slot appends. A moe_ffn counts its live rows (`live_rows`): phase 0
        their x and logits rows, the gate / up slabs of the distinct
        experts they route to and the routed activations written; phase
        1 those activations read, the same experts' down slabs and the
        whole output tile. `experts` ({moe_ffn output index: distinct
        expert ids}, from `routed_experts` after the measured launch)
        gives the routing; without it each live row counts top_k slabs
        of its own, capped at E: an upper bound. A fused task counts
        what it absorbed once: a LINEAR's norm weight or up rows and its
        residual, the norm's operations once per consumer; an ATTN's
        appended rows. In an n-rank program every task's cost is the sum
        over the ranks (each reads its own shards; a weight every rank
        holds alike counts once a rank); an AR task of a rank reads its S
        partial rows and writes them to its n - 1 peers (phase 0), then
        reads the n partials, adds n - 1 times a value and writes S rows
        (phase 1)."""
        item = torch.finfo(self.dtype).bits // 8
        if self.paged is not None:
            lens = np.asarray(cache_lens if cache_lens is not None
                              else np.zeros(self.paged.b_slots), np.int64)
            # the rows ATTN_P and KVA_P* run a slot (at least one)
            wq = np.maximum(self._slot_widths(widths), 1).astype(np.int64)
        costs = []
        n = self.n_ranks
        for nd, phase in zip(self.tasks, self.phases):
            S = nd.inputs[0].rows
            if nd.op == "all_reduce":
                rows = S * nd.out.cols
                flops = (n - 1) * rows if phase else 0
                bytes_ = (n * rows + rows if phase else n * rows) * item
            elif nd.op == "moe_ffn":
                at = nd.attrs
                E, k, inter = at["num_experts"], at["top_k"], \
                    at["intermediate"]
                H = nd.out.cols
                live = len(self.live_rows(S, widths))
                n_e = len(experts[nd.out.idx]) if experts is not None \
                    else min(E, live * k)
                act = live * k * inter
                if phase == 0:
                    flops = 4 * live * k * H * inter + 8 * act
                    bytes_ = (live * (H + E) + n_e * H * 2 * inter
                              + act) * item
                else:
                    flops = 2 * live * k * inter * H
                    bytes_ = (act + n_e * inter * H + S * H) * item
            elif nd.op == "linear":
                K, N = nd.inputs[0].cols, nd.out.cols
                fz = self.fusion.get(nd.out.idx, {})
                # a fused prologue reads the norm weight / the up rows
                # once, an epilogue the residual: each operand once,
                # however many tiles recompute the norm
                flops = 2 * S * K * N + (4 * S * K if "rms" in fz else
                                         8 * S * K if "silu" in fz else 0) \
                    + (S * N if "add" in fz else 0)
                bytes_ = (S * K + K * N + S * N
                          + (K if "rms" in fz else S * K if "silu" in fz
                             else 0)
                          + (S * N if "add" in fz else 0)) * item
            elif nd.op == "rms_norm":
                N = nd.out.cols
                flops = 4 * S * N
                bytes_ = (2 * S * N + N) * item
            elif nd.op in ("silu_mul", "add"):
                flops = (8 if nd.op == "silu_mul" else 1) * S * nd.out.cols
                bytes_ = 3 * S * nd.out.cols * item
            elif nd.op in ("attention", "attention_kv"):
                at = nd.attrs
                H, Hkv, D = at["num_heads"], at["num_kv_heads"], at["head_dim"]
                cl = cache_len if nd.op == "attention_kv" else 0
                causal = at.get("causal", True)
                pairs = S * cl + (S * (S + 1) // 2 if causal else S * S)
                flops = 4 * pairs * H * D
                bytes_ = (S * nd.inputs[0].cols + 2 * cl * Hkv * D
                          + S * H * D) * item
                if "kv" in self.fusion.get(nd.out.idx, {}):
                    # the appended K / V rows, written (their qkv rows
                    # are read above), and the K rows' norm and RoPE
                    flops += 10 * S * Hkv * D
                    bytes_ += 2 * S * Hkv * D * item
            elif nd.op == "attention_paged":
                at = nd.attrs
                H, Hkv, D = at["num_heads"], at["num_kv_heads"], at["head_dim"]
                pairs = int((wq * lens + wq * (wq + 1) // 2).sum())
                flops = 4 * pairs * H * D
                bytes_ = (int(wq.sum()) * nd.inputs[0].cols
                          + 2 * int(lens.sum()) * Hkv * D + S * H * D) * item
            else:   # kv_append(_paged): read the part, write the rows
                at = nd.attrs
                w = at["num_kv_heads"] * at["head_dim"]
                rows = int(wq.sum()) if nd.op in PAGED_OPS else S
                flops = 10 * rows * w if at["part"] == "k" else 0
                bytes_ = 2 * rows * w * item
            costs.append({"flops": n * int(flops), "bytes": n * int(bytes_)})
        return costs


# ---------------------------------------------------------------------------
# The plain version: the same table and queues, each tile in torch
# ---------------------------------------------------------------------------

def _round(x, dt):
    return x.to(dt).float()


def _rms_rows(x, w, eps, dt):
    """RMS_NORM of whole rows in f32 with the (1, cols) weight, rounded
    to dt (the task's, and a fused LINEAR prologue's)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()[0]).to(dt)


def _silu_mul_rows(a, b, dt):
    """silu(a) * b in f32, rounded to dt (SILU_MUL, and a fused LINEAR
    prologue)."""
    af = a.float()
    return (af * torch.sigmoid(af) * b.float()).to(dt)


def prep_rows(x, norm_w, pos, cos, sin, eps, dt):
    """Qwen3 per-head RMSNorm (f32, rounded to dt) then rotate-half RoPE
    in f32 with the f32 table rows of `pos` (rounded to dt): the
    kernel's prep_row. x: (rows, heads, D). Returns f32 values that are
    exactly representable in dt."""
    xf = x.float()
    if norm_w is not None:
        var = (xf * xf).mean(dim=-1, keepdim=True)
        xf = _round(xf * torch.rsqrt(var + eps) * norm_w.float()[0], dt)
    half = xf.shape[-1] // 2
    c, s = cos[pos][:, None, :], sin[pos][:, None, :]
    x1, x2 = xf[..., :half], xf[..., half:]
    return _round(torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1), dt)


def _softmax_pv(q, keys, vals, seen, scale, dt):
    """The ATTN bodies' softmax and PV product over all keys at once:
    q (rows, G, D), keys / vals (keys, D) f32, `seen` (rows, keys). f32
    scores and softmax, p rounded to dt for the PV product and summed in
    f32 for the denominator. Returns (rows, G, D) f32."""
    s = torch.einsum("rgd,kd->rgk", q, keys) * scale
    s = torch.where(seen[:, None, :], s, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(seen[:, None, :], torch.exp(s - m), 0.0)
    return torch.einsum("rgk,kd->rgd", _round(p, dt), vals) \
        / p.sum(dim=-1, keepdim=True)


def _page_rows(btab_row, n, blk, device):
    """Pool rows of positions [0, n) of a slot with table row
    `btab_row`: row c lies in page btab_row[c // blk], at c % blk."""
    c = np.arange(n)
    return torch.from_numpy(btab_row[c // blk].astype(np.int64) * blk
                            + c % blk).to(device)


def _slot_width(widths, b) -> int:
    """The rows ATTN_P and KVA_P* run for slot b: its width, at least one
    (an idle slot's first row runs against its own pages)."""
    return max(1, int(widths[b]))


def _moe_live(row, r, widths) -> bool:
    R = int(row[F_SROWS])
    return R == 0 or r % R < int(widths[r // R])


def _plain_moe(dt, row, v, tile, widths):
    """One GROUPED_GEMM tile. Phase 0, tile (r, k, strip): route row r
    on its logits, then act[r, k, strip] = round(silu(g) * u * w_k) from
    f32 dots of the x row with expert e_k's gate and up columns. Phase
    1, tile (r, strip of H): out[r, strip] = round(sum over k of
    act[r, k] @ the strip of expert e_k's down slab, in f32). A dead row
    (past its slot's width) reads no slab and gives zeros."""
    E, K, inter = int(row[F_NE]), int(row[F_TOPK]), int(row[F_INTER])
    H, nct, tn = int(row[F_N]), int(row[F_NCT]), int(row[F_TN])
    x, logits, act = v["a"], v["b"], v["e"]
    if row[F_PHASE] == 0:
        r, rem = divmod(tile, K * nct)
        k, st = divmod(rem, nct)
        c0, c1 = st * tn, min(inter, (st + 1) * tn)
        if not _moe_live(row, r, widths):
            act[r, k * inter + c0:k * inter + c1] = 0
            return
        w, e = route_topk(logits[r:r + 1], K,
                          renormalize=bool(row[F_NORMK]))
        slab = v["c"][int(e[0, k]) * H:(int(e[0, k]) + 1) * H]
        g = matmul_f32(x[r:r + 1], slab[:, c0:c1])
        u = matmul_f32(x[r:r + 1], slab[:, inter + c0:inter + c1])
        act[r:r + 1, k * inter + c0:k * inter + c1] = (
            g * torch.sigmoid(g) * u * w[0, k]).to(dt)
        return
    r, ct = divmod(tile, nct)
    cols = slice(ct * tn, min(H, (ct + 1) * tn))
    if not _moe_live(row, r, widths):
        v["out"][r, cols] = 0
        return
    _, e = route_topk(logits[r:r + 1], K)
    acc = 0.0
    for k in range(K):
        ek = int(e[0, k])
        acc = acc + matmul_f32(act[r:r + 1, k * inter:(k + 1) * inter],
                               v["d"][ek * inter:(ek + 1) * inter, cols])
    v["out"][r:r + 1, cols] = acc.to(dt)


def _plain_ar(ex, row, v, r, tile, signals):
    """One AR tile of rank r. Phase 0: rank r's rows of the partial
    copied into slot r of every peer's landing block, one signal each
    (`signals`, a host count by (dst, src, tile)). Phase 1: the peers'
    signals checked, then the n partials (rank r's own from its partial,
    the others from its landing block) summed in rank order in f32 and
    rounded once."""
    n, M, tr = int(row[F_NR]), int(row[F_M]), int(row[F_TR])
    r0, r1 = tile * tr, min(M, tile * tr + tr)
    part, land = v["a"], v["c"]
    if row[F_PHASE] == 0:
        for q in range(n):
            if q != r:
                land[q, r * M + r0:r * M + r1] = part[r, r0:r1]
                signals[q, r, tile] += 1
        return
    lost = [s_ for s_ in range(n) if s_ != r and signals[r, s_, tile] != 1]
    if lost:
        raise RuntimeError(f"megakernel plain walk: an all_reduce tile of "
                           f"rank {r} never saw the push of rank(s) {lost}")
    acc = None
    for s_ in range(n):
        src = (part[r, r0:r1] if s_ == r
               else land[r, s_ * M + r0:s_ * M + r1]).float()
        acc = src if acc is None else acc + src
    v["out"][r, r0:r1] = acc.to(ex.dtype)


def _plain_tile(ex, row, v, tile, cache_len, lens=None, btab=None,
                widths=None):
    """Compute one tile of one task from its descriptor row."""
    dt = ex.dtype
    op = int(row[F_OP])
    M, tr = int(row[F_M]), int(row[F_TR])
    if op == TASK_GROUPED_GEMM:
        _plain_moe(dt, row, v, tile, widths)
        return
    if op == TASK_ATTN_P:
        H, Hkv, D = int(row[F_H]), int(row[F_HKV]), int(row[F_HD])
        G, blk = H // Hkv, int(row[F_BLOCK])
        b, j = divmod(tile, Hkv)
        r0, cl, w = b * tr, int(lens[b]), _slot_width(widths, b)
        eps, scale = _bits_f32(row[F_EPS]), _bits_f32(row[F_SCALE])
        qkv, dev = v["a"], v["a"].device
        pos = cl + torch.arange(w, device=dev)
        q = prep_rows(qkv[r0:r0 + w, j * G * D:(j + 1) * G * D].reshape(
            w, G, D), v.get("d") if row[F_QKN] else None, pos, v["cos"],
            v["sin"], eps, dt)                                # (w, G, D)
        kcur = prep_rows(qkv[r0:r0 + w, (H + j) * D:(H + j + 1) * D]
                         .reshape(w, 1, D), v.get("e") if row[F_QKN]
                         else None, pos, v["cos"], v["sin"], eps, dt)[:, 0]
        vcur = qkv[r0:r0 + w, (H + Hkv + j) * D:(H + Hkv + j + 1) * D]
        rows = _page_rows(btab[b], cl, blk, dev)
        keys = torch.cat([v["b"][rows, j * D:(j + 1) * D].float(), kcur])
        vals = torch.cat([v["c"][rows, j * D:(j + 1) * D].float(),
                          vcur.float()])
        # candidate i sees the prefix and candidates 0..i
        cols = torch.arange(cl + w, device=dev)[None, :]
        seen = cols <= cl + torch.arange(w, device=dev)[:, None]
        o = _softmax_pv(q, keys, vals, seen, scale, dt)
        cols = slice(j * G * D, (j + 1) * G * D)
        v["out"][r0:r0 + w, cols] = o.reshape(w, G * D).to(dt)
        v["out"][r0 + w:r0 + tr, cols] = 0      # pad rows are exactly 0
        return
    if op in (TASK_KVA_PK, TASK_KVA_PV):
        H, Hkv, D = int(row[F_H]), int(row[F_HKV]), int(row[F_HD])
        blk, b = int(row[F_BLOCK]), tile
        r0, cl, w = b * tr, int(lens[b]), _slot_width(widths, b)
        lo = H if op == TASK_KVA_PK else H + Hkv
        part = v["a"][r0:r0 + w, lo * D:(lo + Hkv) * D]
        pos = cl + np.arange(w)
        if op == TASK_KVA_PK:
            part = prep_rows(part.reshape(w, Hkv, D),
                             v.get("e") if row[F_QKN] else None,
                             torch.from_numpy(pos).to(part.device),
                             v["cos"], v["sin"], _bits_f32(row[F_EPS]), dt)
            part = part.reshape(w, Hkv * D)
        dest = btab[b, pos // blk].astype(np.int64) * blk + pos % blk
        v["out"][torch.from_numpy(dest).to(part.device)] = part.to(dt)
        return
    if op == TASK_LINEAR:
        nct, tn = int(row[F_NCT]), int(row[F_TN])
        rt, ct = divmod(tile, nct)
        r0, c0 = rt * tr, ct * tn
        x = v["a"][r0:r0 + tr]
        if row[F_PRO] == PRO_RMS:        # the fused RMS_NORM, whole rows
            x = _rms_rows(x, v["p"], _bits_f32(row[F_EPS]), dt)
        elif row[F_PRO] == PRO_SILU:     # the fused SILU_MUL
            x = _silu_mul_rows(x, v["p"][r0:r0 + tr], dt)
        y = matmul_f32(x, v["b"][:, c0:c0 + tn]).to(dt)
        if row[F_R]:                     # the fused ADD, after rounding
            y = v["r"][r0:r0 + tr, c0:c0 + tn] + y
        v["out"][r0:r0 + tr, c0:c0 + tn] = y
        return
    if op == TASK_ATTN:
        H, Hkv, D = int(row[F_H]), int(row[F_HKV]), int(row[F_HD])
        G = H // Hkv
        rt, j = divmod(tile, Hkv)
        r0 = rt * tr
        r1 = min(M, r0 + tr)
        cl = cache_len if row[F_CACHED] else 0
        eps, scale = _bits_f32(row[F_EPS]), _bits_f32(row[F_SCALE])
        qkv = v["a"]
        qn = v.get("d") if row[F_QKN] else None
        kn = v.get("e") if row[F_QKN] else None
        dev = qkv.device
        q = qkv[r0:r1, j * G * D:(j + 1) * G * D].reshape(r1 - r0, G, D)
        q = prep_rows(q, qn, cl + torch.arange(r0, r1, device=dev),
                      v["cos"], v["sin"], eps, dt)            # (rows, G, D)
        ncur = r1 if row[F_CAUSAL] else M
        kcur = qkv[:ncur, (H + j) * D:(H + j + 1) * D].reshape(ncur, 1, D)
        kcur = prep_rows(kcur, kn, cl + torch.arange(ncur, device=dev),
                         v["cos"], v["sin"], eps, dt)[:, 0]
        vcur = qkv[:ncur, (H + Hkv + j) * D:(H + Hkv + j + 1) * D].float()
        if cl:
            keys = torch.cat([v["b"][:cl, j * D:(j + 1) * D].float(), kcur])
            vals = torch.cat([v["c"][:cl, j * D:(j + 1) * D].float(), vcur])
        else:
            keys, vals = kcur, vcur
        cols = torch.arange(cl + ncur, device=dev)[None, :]
        rows = torch.arange(r0, r1, device=dev)[:, None]
        seen = (cols < cl) | (cols - cl <= rows)
        if not row[F_CAUSAL]:
            seen = torch.ones_like(seen)
        o = _softmax_pv(q, keys, vals, seen, scale, dt)
        v["out"][r0:r1, j * G * D:(j + 1) * G * D] = \
            o.reshape(r1 - r0, G * D).to(dt)
        if row[F_APPEND]:   # the fused KVA_K / KVA_V of the tile's rows
            heads = slice(j * D, (j + 1) * D)
            v["b"][cl + r0:cl + r1, heads] = kcur[r0:r1].to(dt)
            v["c"][cl + r0:cl + r1, heads] = vcur[r0:r1].to(dt)
        return
    r0 = tile * tr
    r1 = min(M, r0 + tr)
    if op == TASK_RMS_NORM:
        v["out"][r0:r1] = _rms_rows(v["a"][r0:r1], v["b"],
                                    _bits_f32(row[F_EPS]), dt)
    elif op == TASK_SILU_MUL:
        v["out"][r0:r1] = _silu_mul_rows(v["a"][r0:r1], v["b"][r0:r1], dt)
    elif op == TASK_ADD:
        v["out"][r0:r1] = v["a"][r0:r1] + v["b"][r0:r1]
    elif op in (TASK_KVA_K, TASK_KVA_V):
        H, Hkv, D = int(row[F_H]), int(row[F_HKV]), int(row[F_HD])
        lo = H if op == TASK_KVA_K else H + Hkv
        part = v["a"][r0:r1, lo * D:(lo + Hkv) * D]
        if op == TASK_KVA_K:
            dev = part.device
            part = prep_rows(part.reshape(r1 - r0, Hkv, D),
                             v.get("e") if row[F_QKN] else None,
                             cache_len + torch.arange(r0, r1, device=dev),
                             v["cos"], v["sin"], _bits_f32(row[F_EPS]), dt)
            part = part.reshape(r1 - r0, Hkv * D)
        v["out"][cache_len + r0:cache_len + r1] = part.to(dt)
    else:
        raise RuntimeError(f"descriptor names op {op}, which the kernel "
                           f"does not have")


def plain_walk(ex: ExecutorCuda, cache_len: int, *, seed: int = 0,
               lens=None, btab=None, widths=None):
    """Run the program's queues with torch ops: at each step the head of
    a queue chosen by `random.Random(seed)` among those whose producer
    tasks have all finished every tile. Raises if no head can run (a
    missing or cyclic dependency), which on the card would be a
    deadlock. A paged program runs at the per-slot `lens` and live
    `widths` through `btab` (host int32 arrays). An n-rank program's tile
    runs rank r's operands; its AR tiles keep the signals a rank pushes
    as host counts and raise if a sum finds one missing."""
    desc, _, views, *_ = ex.descriptors()
    n = ex.n_ranks
    # host signal counts of each all_reduce node, shared by its phases
    signals = {nd.out.idx: np.zeros((n, n, ex.tiling[t]["tpr"]), np.int64)
               for t, nd in enumerate(ex.tasks) if nd.op == "all_reduce"}
    rank_views = {}

    def rank_view(task, r):
        if (task, r) not in rank_views:
            rank_views[task, r] = {k: t if k in ("cos", "sin") else t[r]
                                   for k, t in views[task].items()}
        return rank_views[task, r]

    queues, qlen = ex.queues, ex.qlen
    rng = random.Random(seed)
    done = np.zeros(len(ex.tasks), np.int64)
    ready = np.zeros(len(ex.tasks), bool)
    heads = np.zeros(ex.n_sm, np.int64)
    live = [c for c in range(ex.n_sm) if qlen[c] > 0]
    deps = ex.deps
    tiles = ex.n_tiles

    def runnable(task):
        if not ready[task]:
            ready[task] = all(done[p] == tiles[p] for p in deps[task])
        return ready[task]

    while live:
        start = rng.randrange(len(live))
        for k in range(len(live)):
            c = live[(start + k) % len(live)]
            task, tile = scheduler.unpack(queues[c, heads[c]])
            if runnable(task):
                break
        else:
            stuck = {live_c: scheduler.unpack(queues[live_c, heads[live_c]])
                     for live_c in live}
            raise RuntimeError(
                f"megakernel plain walk: no queue head can run (a "
                f"dependency is missing or cyclic); heads (sm: task, tile) "
                f"{stuck}")
        if not ex.sharded:
            _plain_tile(ex, desc[task], views[task], tile, cache_len, lens,
                        btab, widths)
        else:
            r, lt = divmod(tile, int(desc[task, F_TPR]))
            nd = ex.tasks[task]
            if nd.op == "all_reduce":
                _plain_ar(ex, desc[task], views[task], r, lt,
                          signals[nd.out.idx])
            else:
                _plain_tile(ex, desc[task], rank_view(task, r), lt,
                            cache_len, lens, btab, widths)
        done[task] += 1
        heads[c] += 1
        if heads[c] == qlen[c]:
            live.remove(c)
    if not (done == tiles).all():
        raise RuntimeError("megakernel plain walk: tiles left unrun")
