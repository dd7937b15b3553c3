"""The decode-path health ladder the serving control plane reads
(counterpart of triton_distributed_tpu/perf_model.py:811-852), and the
one-rank form of the per-tick EP plan the MoE serving loop records
(`ep_tick_plan`, JAX perf_model.py:989).

Only these are here: `DECODE_PATH_LADDER` and `DecodePathHealth` are
what models/serve_state.py imports, `ep_tick_plan` what
models/serve.py reads. The JAX module's cost models and choosers are
built on TPU figures (`CHIP_SPECS`); their H100 counterparts wait for a
slice that measures the card's own.
"""

from __future__ import annotations

from .layers.common import check_one_rank

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
                 top_k: int, num_ranks: int) -> dict:
    """The per-tick EP dispatch plan for a live decode batch, at one rank:
    the dict the JAX function returns at `num_ranks=1`, which reads no
    chip figure there. One rank has one transport ("flat") and no
    all-to-all (`a2a_round_s` 0.0). Its chunk count is 1: with no
    transfer to overlap, S chunks cost the grouped MLP S times over
    ceil(rows / S) rows, and a roofline time max(a*m, b*m + c) with a
    weight term c >= 0 gives S * t(m / S) >= t(m), so the JAX chooser's
    first candidate, 1, is its least. `num_ranks > 1` raises (slice
    6)."""
    check_one_rank(num_ranks)
    return {"occupancy": max(1, int(occupancy)), "transport": "flat",
            "num_chunks": 1, "a2a_round_s": 0.0}
