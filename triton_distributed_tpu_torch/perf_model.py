"""The decode-path health ladder the serving control plane reads
(counterpart of triton_distributed_tpu/perf_model.py:811-852).

Only `DECODE_PATH_LADDER` and `DecodePathHealth` are here: they are what
models/serve_state.py imports. The JAX module's cost models and choosers
are built on TPU figures (`CHIP_SPECS`); their H100 counterparts wait for
a slice that measures the card's own.
"""

from __future__ import annotations

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
