"""Op graph captured by the ModelBuilder (the JAX package's
megakernel/graph.py carried over unchanged; a test compares the syntax
trees).

Analog of reference mega_triton_kernel/core/graph.py (`Node`/`Graph`
:59,:101, producer tracking per tensor, `to_tasks` :134 resolving
tile-level dependencies) and core/task_base.py's task model. Tensors are
2-D (rows, cols) handles; ops are the supported task types. Tasks are
emitted in graph (topological) order; the port's executor
(executor_cuda.py) derives each task's producer list from the handles.
`OPS` and the `TASK_*` codes are the JAX package's, so task rows keep
their op codes across the two packages. The port's kernel runs
LINEAR, RMS_NORM, SILU_MUL, ADD, ATTN, KVA_K, KVA_V, the paged ATTN_P,
KVA_PK and KVA_PV, GROUPED_GEMM, and AR, the cross-rank sum of an
`all_reduce` node; its builder raises on `all_to_all` (A2A), and
GEMM_AR (the fused LINEAR + AR of `fuse_collective`) is not built.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


OPS = ("input", "weight", "linear", "rms_norm", "silu_mul", "add",
       "all_reduce", "attention", "attention_kv", "kv_append",
       "attention_paged", "kv_append_paged", "moe_ffn", "all_to_all")
# task type codes of a megakernel queue row (the same in both packages)
TASK_LINEAR, TASK_RMS_NORM, TASK_SILU_MUL, TASK_ADD = 0, 1, 2, 3
TASK_ATTN, TASK_AR, TASK_KVA_K, TASK_KVA_V = 4, 5, 6, 7
# no-op row: matches no kernel branch (only the prelude drains run).
# The composed-run profiler masks queue suffixes with it to time task
# PREFIXES of one compiled kernel — the queue is data, so no recompile.
TASK_NOP = 8
# batched-serving task families: per-slot paged attention /
# paged cache appends reading the block table in-kernel, and the fused
# GEMM+AllReduce tile-push rows (linear + all_reduce folded into one
# collective task). TASK_NOP keeps its value — the profiler's and the
# family ledger's mask code is pinned on it.
TASK_ATTN_P, TASK_KVA_PK, TASK_KVA_PV, TASK_GEMM_AR = 9, 10, 11, 12
# MoE serving task families: a fused expert-FFN task per
# row tile — router read + in-kernel top-k + grouped expert GEMMs over
# the stacked expert slabs, its runtime verify width riding the SAME
# patched queue column as paged attention — and the EP dispatch/combine
# tile-push rows (TASK_AR-shape peer pushes on the allocator-audited
# collective id, byte-counting recv waits, self-draining)
TASK_GROUPED_GEMM, TASK_A2A = 13, 14


@dataclasses.dataclass(frozen=True)
class TensorHandle:
    """A (rows, cols) logical tensor in the graph."""
    idx: int
    shape: tuple
    dtype: object

    @property
    def rows(self):
        return self.shape[0]

    @property
    def cols(self):
        return self.shape[1]


@dataclasses.dataclass
class Node:
    op: str
    inputs: tuple          # TensorHandle inputs
    out: TensorHandle
    attrs: dict


class Graph:
    """Reference core/graph.py Graph analog: append-only op list with
    single-producer tensors."""

    def __init__(self):
        self.nodes: list[Node] = []
        self.tensors: list[TensorHandle] = []
        self.inputs: dict[str, TensorHandle] = {}
        self.weights: dict[str, TensorHandle] = {}
        # KV caches: a subset of `inputs` (so the XLA executor and the
        # compat `run()` path treat them like any input) that the Pallas
        # executor places in its persistent cache buffer and `kv_append`
        # nodes update in place
        self.caches: dict[str, TensorHandle] = {}
        self.outputs: list[TensorHandle] = []
        # tensor idx -> producing node, maintained at add_node time.
        # Lookups are per-span in the sanitizer's megakernel verifier
        # (sanitizer/mk.py), so a linear scan per call would be
        # quadratic on deep programs.
        self._producer_by_idx: dict[int, Node] = {}

    def new_tensor(self, shape, dtype) -> TensorHandle:
        assert len(shape) == 2, shape
        h = TensorHandle(len(self.tensors), tuple(shape), dtype)
        self.tensors.append(h)
        return h

    def add_node(self, op: str, inputs, out_shape, dtype,
                 **attrs) -> TensorHandle:
        assert op in OPS, op
        out = self.new_tensor(out_shape, dtype)
        node = Node(op, tuple(inputs), out, attrs)
        self.nodes.append(node)
        self._producer_by_idx.setdefault(out.idx, node)
        return out

    def producer(self, h: TensorHandle) -> Optional[Node]:
        return self._producer_by_idx.get(h.idx)

    def consumers(self) -> dict:
        """tensor idx -> [consuming nodes], one pass over the graph —
        the executor's fusion passes need the full map, not per-tensor
        scans."""
        out: dict = {}
        for n in self.nodes:
            for h in n.inputs:
                out.setdefault(h.idx, []).append(n)
        return out

    # ------------------------------------------------------------------
    def task_tiles(self, tile_m: int, tile_n: int | None = None,
                   lin_whole: bool = False) -> np.ndarray:
        """(n_compute_tasks,) tile counts per compute node, the
        scheduler's input (reference Graph.to_tasks + TaskBase tiling).

        With `tile_n` given, counts follow the panelized executor's task
        decomposition: every op emits one task per ROW tile covering the
        node's whole output width (linear/silu_mul/add walk their column
        panels inside the task — whole-node tasks keep the weight DMA
        stream continuous and amortize the fixed per-task cost, measured
        ~1.5us each on v5e); all_reduce is a single task per node (one
        image push + reduce). `lin_whole` makes linear nodes a SINGLE
        task covering every row tile too (prefill-depth programs: one
        B-weight stream amortized over all row tiles instead of
        re-streamed per tile)."""
        counts = []
        for n in self.nodes:
            if n.op in ("input", "weight"):
                continue
            mtiles = -(-n.out.rows // tile_m)
            if tile_n is None:
                counts.append(mtiles)
            elif n.op in ("all_reduce", "all_to_all"):
                counts.append(1)
            elif n.op == "linear" and lin_whole:
                counts.append(1)
            elif n.op in ("kv_append", "kv_append_paged"):
                # one task per row tile of the APPENDED rows (qkv rows)
                counts.append(-(-n.inputs[0].rows // tile_m))
            else:  # whole-node per row tile (linear/silu/add/rms/attn)
                counts.append(mtiles)
        return np.asarray(counts, np.int32)
