"""Analytic serving models of the port on an NVIDIA H100: the decode
step's roofline, the megakernel and engine verify-step estimators and
the speculative-width chooser `choose_spec_k` that
`ServeEngine(speculative=SpecConfig(adapt=True))` runs every tick
(counterparts of triton_distributed_tpu/perf_model.py:24-677); the
decode-path health ladder the serving control plane reads (JAX :811-852)
and the per-tick EP plan (`ep_tick_plan`, JAX :989; at n ranks the plan
the layer is built with).

The formulas are the JAX package's, set to the work the port's kernels
do; none of its TPU figures is here. `CHIP_SPECS` holds the H100 alone
(bf16 989 TFLOP/s and 3.35 TB/s from NVIDIA's data sheet; the SM count
read from the card when one is present), and every other default below
is a figure that chip_smoke.py measured on an NVIDIA H100 80GB HBM3 at a
700 W power limit (PERF.md lists each with its run). Where the port's
kernels differ from the TPU kernels the model follows the port: the
megakernel's ATTN_P reads exactly a slot's cached rows (the TPU body
reads whole pages), its program is node-level, `MK_STAGES_PER_LAYER`
dependent stages a layer whatever the occupancy (the TPU walk's task
count grows with it), and the paged decode kernel splits no slot across
CTAs (the TPU kernel chooses a split-KV count), so only the KV stream
runs on its B x Hkv CTAs while cuBLAS streams the weights on every SM.
The collective estimators that the AUTO choosers of ops/collectives read
(JAX :81-230) price a push at the HBM rate, the n ranks sharing one card,
with `PEER_LATENCY_S` a dependent hop. Other multi-rank arms (the step
estimators at `tp_ranks > 1`, the EP estimators and choosers) wait for
H100 figures (ROADMAP.md Queue A, slice 6); the other choosers
(`choose_kv_tier`, `choose_admission`, `choose_decode_path`,
`choose_moe_decode_path`) with slice 2c.
"""

from __future__ import annotations

import dataclasses

import torch

from .layers.common import check_one_rank
from .ops import wire


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Per-card capability figures for the models below."""
    name: str
    bf16_flops: float          # peak dense bf16 tensor-core FLOP/s
    hbm_bw: float              # device-memory bytes/s
    num_sms: int               # streaming multiprocessors


# NVIDIA's data sheet, H100 SXM (dense rates, 700 W)
CHIP_SPECS = {"h100": ChipSpec("h100", 989e12, 3.35e12, 132)}

# Measured by chip_smoke.py (its "perf_model constants" line) on an NVIDIA
# H100 80GB HBM3 at 700 W, at the Qwen3-8B serve cell's first all-slots
# verify tick (PERF.md §6 names the run)
STAGE_LATENCY_S = 4.32629e-06  # one dependent megakernel stage
MK_BOUND_SHARE = 0.0294609     # megakernel verify step: bound / measured
ATTN_ELEMS_PER_S = 5.43763e+11  # megakernel attention: 4 x q rows x keys x
                               # H x D per second, all CTAs
ENGINE_BOUND_SHARE = 0.386198  # engine verify step: bound / device-busy
ENGINE_HOST_S = 0.0394677      # engine verify step: wall - device-busy
SKINNY_MM_SHARE = 1.0          # torch.mm: 12 extra rows cost no time (0.8
                               # us of 67 us), so the share clamps at peak
# the port's serving megakernel program (build_qwen3_serve_batched): 13
# dependent stages a layer, one more for the final norm
MK_STAGES_PER_LAYER = 13


# One dependent hop of the one-sided transport (csrc/tdt_shmem.cuh): a
# producer's release, its signal and the consumer's acquire spin. Fitted by
# chip_smoke.py's collectives phase (its "perf_model constants" line) on an
# NVIDIA H100 80GB HBM3 at 700 W: the slope of the six collective arms'
# times at 1 row x 4096 over their dependent hops, beside a fixed ~28 us a
# launch (PERF.md §6 names the run)
PEER_LATENCY_S = 4.70478e-06


def chip_spec(name: str | None = None) -> ChipSpec:
    """The H100's figures, with the SM count of the card in use when one
    is present."""
    spec = CHIP_SPECS[name or "h100"]
    if name is None and torch.cuda.is_available():
        spec = dataclasses.replace(
            spec, num_sms=torch.cuda.get_device_properties(
                torch.cuda.current_device()).multi_processor_count)
    return spec

# The serving decode ladder, fastest-but-most-fragile first: one
# persistent megakernel -> the per-op engine step (paged decode kernel)
# -> the plain-attention gather path. The last rung is never
# health-gated: it is the always-works floor.
DECODE_PATH_LADDER = ("megakernel", "engine", "xla")


class DecodePathHealth:
    """Per-slot health state: a tripped watchdog demotes the slot one
    rung down the ladder (megakernel -> engine -> xla) instead of
    dropping the batch. `trips` counts faults per path; a path with any
    trip is avoided until `reset()`."""

    def __init__(self):
        self.trips = {p: 0 for p in DECODE_PATH_LADDER}

    def trip(self, path: str):
        """Record a watchdog fault on `path` (unknown paths — e.g. a
        prefill-stage fault — count against the engine rung)."""
        self.trips[path if path in self.trips else "engine"] += 1

    def healthy(self, path: str) -> bool:
        return path == DECODE_PATH_LADDER[-1] or \
            self.trips.get(path, 0) == 0

    def resolve(self, preferred: str) -> str:
        """The first rung at/below `preferred` that is healthy; the
        floor always qualifies."""
        start = DECODE_PATH_LADDER.index(preferred)
        for path in DECODE_PATH_LADDER[start:]:
            if self.healthy(path):
                return path
        return DECODE_PATH_LADDER[-1]

    def reset(self):
        for p in self.trips:
            self.trips[p] = 0

    def describe(self) -> dict:
        return dict(self.trips)


def ep_tick_plan(occupancy: int, *, hidden: int, moe_intermediate: int,
                 top_k: int, num_ranks: int, method: str = "ragged",
                 pipeline: int | str = 1) -> dict:
    """The per-tick EP dispatch plan for a live decode batch (JAX :989).

    At one rank: the dict the JAX function returns at `num_ranks=1`, which
    reads no chip figure there. One rank has one transport ("flat") and no
    all-to-all (`a2a_round_s` 0.0). Its chunk count is 1: with no
    transfer to overlap, S chunks cost the grouped MLP S times over
    ceil(rows / S) rows, and a roofline time max(a*m, b*m + c) with a
    weight term c >= 0 gives S * t(m / S) >= t(m), so the JAX chooser's
    first candidate, 1, is its least.

    At n ranks the JAX arm chooses a transport and a chunk count from
    interconnect figures (`choose_ep_transport`,
    `estimate_ep_dispatch_time_s`), which one card cannot give (slice 2c).
    The port records the plan the layer is built with instead: the model's
    `method` ("ragged" | "xla") as the transport, its integer `pipeline`
    as the chunk count, and `a2a_round_s` None (not modeled).
    `pipeline="auto"` / `"tune"` raise, as EPMoE does (AUTO_LATER,
    TUNE_LATER)."""
    occ = max(1, int(occupancy))
    if num_ranks == 1:
        return {"occupancy": occ, "transport": "flat", "num_chunks": 1,
                "a2a_round_s": 0.0}
    if isinstance(pipeline, str):
        from .layers.ep_moe import AUTO_LATER
        from .ops.ep_pipeline import TUNE_LATER
        raise NotImplementedError(AUTO_LATER if pipeline == "auto"
                                  else TUNE_LATER)
    return {"occupancy": occ, "transport": method,
            "num_chunks": int(pipeline), "a2a_round_s": None}


# ---------------------------------------------------------------------------
# Serving decode model: decode is bytes-bound, the step time is the KV
# stream plus the weight read
# ---------------------------------------------------------------------------

def decode_kv_token_bytes(num_kv_heads: int, head_dim: int,
                          num_layers: int, *, itemsize: int = 2,
                          kv_dtype: str | None = None) -> int:
    """Device bytes ONE cached token costs a decode step: K + V across
    layers at the pool dtype; a quantized pool streams byte-wide rows
    plus one f32 scale per row (PagedKVCache's sidecar layout)."""
    if kv_dtype is not None:
        wire.resolve_wire_dtype(kv_dtype)       # loud on typos
        per_row = head_dim + 4
    else:
        per_row = head_dim * itemsize
    return 2 * num_layers * num_kv_heads * per_row


def estimate_decode_step_s(total_kv_tokens: int, num_kv_heads: int,
                           head_dim: int, num_layers: int, *,
                           param_bytes: int = 0, itemsize: int = 2,
                           kv_dtype: str | None = None,
                           spec: ChipSpec | None = None) -> float:
    """Bytes-bound decode step: K + V of every cached token once (the
    paged decode kernel reads exactly sum(seq_len) rows) plus the
    per-step parameter read, over the card's memory rate."""
    spec = spec or chip_spec()
    kv_bytes = total_kv_tokens * decode_kv_token_bytes(
        num_kv_heads, head_dim, num_layers, itemsize=itemsize,
        kv_dtype=kv_dtype)
    return (kv_bytes + param_bytes) / spec.hbm_bw


def _decode_param_bytes(num_layers: int, hidden: int, intermediate: int,
                        num_heads: int, num_kv_heads: int, head_dim: int,
                        itemsize: int = 2) -> int:
    """Per-step trunk weight read (qkv, o, gate, up, down)."""
    qkvd = (num_heads + 2 * num_kv_heads) * head_dim
    per_layer = (hidden * qkvd + num_heads * head_dim * hidden
                 + 2 * hidden * intermediate + intermediate * hidden)
    return num_layers * per_layer * itemsize


def estimate_mk_step_s(occupancy: int, cache_len: int, *,
                       num_layers: int, hidden: int, intermediate: int,
                       num_heads: int, num_kv_heads: int, head_dim: int,
                       itemsize: int = 2, verify_tokens: int = 1,
                       tp_ranks: int = 1,
                       task_overhead_s: float = STAGE_LATENCY_S,
                       mk_hbm_frac: float = MK_BOUND_SHARE,
                       vpu_elems_per_s: float = ATTN_ELEMS_PER_S,
                       spec: ChipSpec | None = None) -> float:
    """Modeled batched megakernel step: one launch advancing `occupancy`
    slots, each `cache_len` deep, by `verify_tokens` (k) candidate rows.
    The larger of (a) the weight + KV stream (the `cache_len` rows ATTN_P
    reads) at `mk_hbm_frac` of the memory rate and (b) the attention
    arithmetic, 4 x L x occupancy x k x (cache + k) x H x D at
    `vpu_elems_per_s`; plus `task_overhead_s` for each of the program's
    L x MK_STAGES_PER_LAYER + 1 dependent stages. A verify step of width
    k reads the weights and the cache once, so only (b) grows with k.
    `tp_ranks > 1` comes with slice 6."""
    check_one_rank(tp_ranks, "the step estimators")
    spec = spec or chip_spec()
    k = max(1, int(verify_tokens))
    param = _decode_param_bytes(num_layers, hidden, intermediate,
                                num_heads, num_kv_heads, head_dim,
                                itemsize)
    kv_ctx = max(cache_len, 0)
    kv_bytes = (2 * num_layers * occupancy * kv_ctx * num_kv_heads
                * head_dim * itemsize)
    stream_s = (param + kv_bytes) / (spec.hbm_bw * mk_hbm_frac)
    attn_s = (4.0 * num_layers * occupancy * k * (kv_ctx + k) * num_heads
              * head_dim) / vpu_elems_per_s
    n_stages = num_layers * MK_STAGES_PER_LAYER + 1
    return max(stream_s, attn_s) + n_stages * task_overhead_s


def estimate_engine_decode_step_s(occupancy: int, cache_len: int, *,
                                  num_layers: int, hidden: int,
                                  intermediate: int, num_heads: int,
                                  num_kv_heads: int, head_dim: int,
                                  itemsize: int = 2,
                                  verify_tokens: int = 1,
                                  engine_hbm_frac: float = ENGINE_BOUND_SHARE,
                                  engine_dispatch_s: float = ENGINE_HOST_S,
                                  num_cores: int | None = None,
                                  mxu_efficiency: float = SKINNY_MM_SHARE,
                                  spec: ChipSpec | None = None) -> float:
    """Modeled engine-mode verify (or decode) step: the weight read at the
    memory rate, plus the KV stream of `estimate_decode_step_s` over the
    paged decode kernel's SM utilisation (B x Hkv CTAs, one a slot and KV
    head, over `num_cores` SMs), together at `engine_hbm_frac`; plus the
    eager step's host time `engine_dispatch_s` and the k - 1 extra
    candidate rows' GEMM operations at `mxu_efficiency` of the bf16
    peak."""
    spec = spec or chip_spec()
    num_cores = spec.num_sms if num_cores is None else num_cores
    k = max(1, int(verify_tokens))
    param = _decode_param_bytes(num_layers, hidden, intermediate,
                                num_heads, num_kv_heads, head_dim,
                                itemsize)
    util = min(1.0, max(occupancy, 1) * num_kv_heads / num_cores)
    kv_s = estimate_decode_step_s(occupancy * cache_len, num_kv_heads,
                                  head_dim, num_layers, itemsize=itemsize,
                                  spec=spec)
    device_s = (param / spec.hbm_bw + kv_s / util) / engine_hbm_frac
    extra_rows_s = (2.0 * (k - 1) * max(occupancy, 1) * (param / itemsize)
                    / (spec.bf16_flops * mxu_efficiency))
    return device_s + engine_dispatch_s + extra_rows_s


def expected_spec_tokens(acceptance_rate: float, k: int) -> float:
    """Expected tokens ONE verify step of width k emits when each draft
    matches with probability `acceptance_rate`: sum_{j<k} alpha^j (the
    accepted prefix plus the always-emitted bonus token)."""
    a = min(max(float(acceptance_rate), 0.0), 1.0)
    return float(sum(a ** j for j in range(max(1, int(k)))))


def choose_spec_k(acceptance_rate: float, cache_len: int,
                  occupancy: int, *, k_max: int = 8,
                  draft_cost_s: float = 0.0, path: str = "megakernel",
                  num_layers: int, hidden: int, intermediate: int,
                  num_heads: int, num_kv_heads: int, head_dim: int,
                  itemsize: int = 2, spec: ChipSpec | None = None) -> int:
    """The acceptance-aware verify width: the k in [1, k_max] with the
    most expected tokens per second, expected_spec_tokens(alpha, k) over
    the modeled step (`estimate_mk_step_s` on the megakernel path,
    `estimate_engine_decode_step_s` otherwise, at verify_tokens=k) plus
    k - 1 drafts at `draft_cost_s`; ties go to the smaller k, and 1 is
    plain decode."""
    kw = dict(num_layers=num_layers, hidden=hidden,
              intermediate=intermediate, num_heads=num_heads,
              num_kv_heads=num_kv_heads, head_dim=head_dim,
              itemsize=itemsize, spec=spec)
    best_k, best_rate = 1, 0.0
    for k in range(1, max(1, int(k_max)) + 1):
        if path == "megakernel":
            step = estimate_mk_step_s(occupancy, cache_len,
                                      verify_tokens=k, **kw)
        else:
            step = estimate_engine_decode_step_s(
                occupancy, cache_len, verify_tokens=k, **kw)
        rate = expected_spec_tokens(acceptance_rate, k) \
            / (step + (k - 1) * max(0.0, draft_cost_s))
        if rate > best_rate * (1.0 + 1e-9):   # ties -> smaller k
            best_k, best_rate = k, rate
    return best_k


# ---------------------------------------------------------------------------
# Collective models (JAX perf_model.py:81-230), read by the AUTO choosers of
# ops/collectives. The JAX models price a push over the chip's ICI links
# and a ring over two of them; here the n ranks share one card, so a peer's
# landing region lies in the same HBM and every push is priced at
# `hbm_bw`, with `PEER_LATENCY_S` for each dependent hop. The formulas are
# otherwise JAX's: a rank's wire bytes over the rate.
# ---------------------------------------------------------------------------

def wire_nbytes(nbytes: int, itemsize: int = 2, wire_dtype=None,
                block: int | None = None) -> int:
    """Bytes a `nbytes` payload of the working dtype takes on the wire
    (JAX :81): unchanged without a wire; else one byte an element (int8 /
    float8_e4m3fn) and one f32 scale per `block` elements (ops/wire.py)."""
    if wire_dtype is None:
        return nbytes
    name = wire.resolve_wire_dtype(wire_dtype)
    blk = block or wire.WIRE_BLOCK
    elems = nbytes // itemsize
    return elems * wire.TORCH_WIRE_DTYPES[name].itemsize + (elems // blk) * 4


def estimate_one_shot_all_reduce_time_s(
        nbytes: int, num_ranks: int, spec: ChipSpec | None = None, *,
        wire_dtype=None, itemsize: int = 2,
        block: int | None = None) -> float:
    """One-shot AR (JAX :128): a rank pushes its whole (wire-encoded)
    buffer to the n - 1 peers in one round."""
    spec = spec or chip_spec()
    if num_ranks <= 1:
        return 0.0
    wb = wire_nbytes(nbytes, itemsize, wire_dtype, block)
    return (num_ranks - 1) * wb / spec.hbm_bw + PEER_LATENCY_S


def estimate_two_shot_all_reduce_time_s(
        nbytes: int, num_ranks: int, spec: ChipSpec | None = None, *,
        wire_dtype=None, itemsize: int = 2,
        block: int | None = None) -> float:
    """Two-shot AR (JAX :143): a ring reduce-scatter, then a ring
    all-gather, each moving (n - 1) / n of the buffer, one hop at a
    time."""
    spec = spec or chip_spec()
    if num_ranks <= 1:
        return 0.0
    wb = wire_nbytes(nbytes, itemsize, wire_dtype, block)
    moved = 2 * wb * (num_ranks - 1) // num_ranks
    return moved / spec.hbm_bw + 2 * (num_ranks - 1) * PEER_LATENCY_S


def estimate_fullmesh_reduce_scatter_time_s(
        nbytes_chunk: int, num_ranks: int, spec: ChipSpec | None = None, *,
        wire_dtype=None, itemsize: int = 2,
        block: int | None = None) -> float:
    """Fullmesh RS (JAX :159): a rank pushes one chunk to each of the n - 1
    owners in one round."""
    spec = spec or chip_spec()
    if num_ranks <= 1:
        return 0.0
    wb = wire_nbytes(nbytes_chunk, itemsize, wire_dtype, block)
    return (num_ranks - 1) * wb / spec.hbm_bw + PEER_LATENCY_S


def estimate_ring_reduce_scatter_time_s(
        nbytes_chunk: int, num_ranks: int, spec: ChipSpec | None = None, *,
        wire_dtype=None, itemsize: int = 2,
        block: int | None = None) -> float:
    """Ring RS (JAX :173): n - 1 dependent hops of one chunk each."""
    spec = spec or chip_spec()
    if num_ranks <= 1:
        return 0.0
    wb = wire_nbytes(nbytes_chunk, itemsize, wire_dtype, block)
    return ((num_ranks - 1) * wb / spec.hbm_bw
            + (num_ranks - 1) * PEER_LATENCY_S)


def estimate_all_gather_time_s(bytes_per_rank: int, num_ranks: int,
                               spec: ChipSpec | None = None) -> float:
    """Ring all-gather (JAX :197): n - 1 shards cross to each rank."""
    spec = spec or chip_spec()
    if num_ranks <= 1:
        return 0.0
    moved = bytes_per_rank * (num_ranks - 1)
    return moved / spec.hbm_bw + (num_ranks - 1) * PEER_LATENCY_S


def estimate_reduce_scatter_time_s(bytes_per_rank: int, num_ranks: int,
                                   spec: ChipSpec | None = None) -> float:
    """Ring reduce-scatter (JAX :207): the all-gather's wire profile."""
    return estimate_all_gather_time_s(bytes_per_rank, num_ranks, spec)


def estimate_all_reduce_time_s(nbytes: int, num_ranks: int,
                               spec: ChipSpec | None = None) -> float:
    """The plain AR the "xla" method stands for (JAX :213): a ring RS and a
    ring AG over per-rank shards."""
    per = -(-nbytes // max(1, num_ranks))
    return (estimate_reduce_scatter_time_s(per, num_ranks, spec)
            + estimate_all_gather_time_s(per, num_ranks, spec))
