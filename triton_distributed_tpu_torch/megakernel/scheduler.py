"""Task scheduler: (task, tile) work items onto per-SM queues.

The port's copy of the JAX package's `native.schedule` (:148, numpy form
`_schedule_np`) and `scoreboard_offsets` (:194), which carry the
semantics of the C++ `tdt_schedule` in the repo's root
csrc/task_scheduler.cc (reference mega_triton_kernel/core/scheduler.py
:31-100). numpy only: the queues are built once per graph on the host.

Tiles are dealt to cores in task order with one rolling cursor that is
not reset between tasks (ROUND_ROBIN), or sweeping the cores forward
then backward (ZIG_ZAG). Each queue therefore lists its items in the
global (topological) order — the property the megakernel's deadlock
argument rests on (csrc/megakernel.cu).
"""

from __future__ import annotations

import numpy as np

ROUND_ROBIN = 0
ZIG_ZAG = 1

TILE_BITS = 20  # queue entries pack task << TILE_BITS | tile
MAX_TASKS = (2 ** 31 - 1) >> TILE_BITS  # task id must fit an i32 entry


def schedule(n_tiles, n_cores: int, strategy: int = ROUND_ROBIN):
    """Assign (task, tile) work items to per-core queues.

    n_tiles: (n_tasks,) tiles per task. Returns (queues (n_cores,
    capacity) int32 packed task << 20 | tile, queue_len (n_cores,)
    int32), capacity = ceil(total / n_cores) + 1 as in the JAX
    package."""
    n_tiles = np.ascontiguousarray(n_tiles, np.int32)
    if n_cores < 1:
        raise ValueError(f"n_cores must be >= 1, got {n_cores}")
    if strategy not in (ROUND_ROBIN, ZIG_ZAG):
        raise ValueError(f"unknown strategy {strategy}")
    if len(n_tiles) > MAX_TASKS:
        raise ValueError(f"{len(n_tiles)} tasks exceeds the {MAX_TASKS} "
                         "that fit int32 queue entries")
    if len(n_tiles) and (n_tiles.min() < 0
                         or n_tiles.max() >= 1 << TILE_BITS):
        raise ValueError(
            f"tile counts must be in [0, 2^{TILE_BITS}) per task")
    total = int(n_tiles.sum())
    capacity = max(1, -(-total // n_cores) + 1)
    task = np.repeat(np.arange(len(n_tiles), dtype=np.int64), n_tiles)
    starts = np.cumsum(n_tiles, dtype=np.int64) - n_tiles
    tile = np.arange(total, dtype=np.int64) - np.repeat(starts, n_tiles)
    cursor = np.arange(total, dtype=np.int64)
    if strategy == ZIG_ZAG:
        sweep = cursor % (2 * n_cores)
        core = np.where(sweep < n_cores, sweep, 2 * n_cores - 1 - sweep)
    else:
        core = cursor % n_cores
    qlen = np.bincount(core, minlength=n_cores).astype(np.int32)
    # position of each item in its core's queue: items keep their global
    # order within a core (a stable sort by core)
    order = np.argsort(core, kind="stable")
    slot = np.empty(total, np.int64)
    firsts = np.cumsum(qlen, dtype=np.int64) - qlen
    slot[order] = np.arange(total) - np.repeat(firsts, qlen)
    queues = np.zeros((n_cores, capacity), np.int32)
    queues[core, slot] = (task << TILE_BITS | tile).astype(np.int32)
    return queues, qlen


def scoreboard_offsets(n_tiles):
    """Per-task scoreboard slot bases; slot(task, tile) = base + tile.
    Returns (offsets (n_tasks,) int32, total slots), as the C++
    `tdt_scoreboard_offsets` (no offset for an empty task list)."""
    n_tiles = np.ascontiguousarray(n_tiles, np.int32)
    offs = (np.cumsum(n_tiles, dtype=np.int64) - n_tiles).astype(np.int32)
    return offs, int(n_tiles.sum())


def unpack(entry: int):
    """(task, tile) of one packed queue entry."""
    return int(entry) >> TILE_BITS, int(entry) & ((1 << TILE_BITS) - 1)
