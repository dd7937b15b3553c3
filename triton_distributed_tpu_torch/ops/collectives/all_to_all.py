"""Dense AllToAll over n ranks (counterpart of
triton_distributed_tpu/ops/collectives/all_to_all.py).

Rank-stacked (parallel/mesh.py): `all_to_all_shard(x)` takes every rank's
(n * rows, cols) buffer at once, x (n, n * rows, cols): chunk d of rank
r's buffer becomes chunk r of rank d's output, (n, n * rows, cols); the
host-level `all_to_all(x)` takes and returns the global (n * n * rows,
cols) sharded on dim 0 (JAX's P("tp", None) in and out).

Methods, as in JAX:
- FULLMESH (AUTO at n > 1): the ragged all-to-all of expert parallelism
  (ops/ep_a2a.py::_ragged_a2a, csrc/ep_a2a.cu) at counts == capacity, one
  round of n - 1 direct pushes, exactly as JAX's op runs its
  `_ragged_a2a` (:52-57); on a CPU tensor its plain version;
- XLA, or one rank: `RankGroup.all_to_all`.

No new kernel. The ragged kernel's output is its workspace's landing
region, which the next call overwrites, so the op returns a copy of it.
The kernel moves 16-byte rows (row bytes a multiple of 16), and its work
items are chunks of gcd(rows, 128) rows (JAX ships one chunk a peer: the
chunk is a transport setting, no part of the result). JAX's op logs no
dispatch, nor does this one; `collective_id` is dropped, as in the other
collectives (the op's transport is its own, `A2A_ID`).
"""

from __future__ import annotations

import enum
import math

import torch

from ...parallel.mesh import RankGroup
from ..ep_a2a import _ragged_a2a

# the dense op's transport id (ops/ep_a2a.py: EP dispatch 0, combine 1, the
# EP pipeline's chunks from 16)
A2A_ID = 2


class AllToAllMethod(enum.Enum):
    AUTO = "auto"
    FULLMESH = "fullmesh"
    XLA = "xla"


def all_to_all_shard(x, *, num_ranks: int,
                     method: AllToAllMethod = AllToAllMethod.AUTO):
    """AllToAll of every rank's (n * rows, cols) buffer, x (n, n * rows,
    cols) rank-stacked: out[d, r * rows:(r + 1) * rows] = x[r, d * rows:(d
    + 1) * rows]."""
    n = num_ranks
    if x.dim() != 3 or x.shape[0] != n or x.shape[1] % n:
        raise ValueError(f"all_to_all: x {tuple(x.shape)} is not (n, n * "
                         f"rows, cols) with n = {n}")
    _, rows_total, cols = x.shape
    chunk = rows_total // n
    if method == AllToAllMethod.AUTO:
        method = AllToAllMethod.FULLMESH if n > 1 else AllToAllMethod.XLA
    xs = x.reshape(n, n, chunk, cols)
    if method == AllToAllMethod.XLA or n == 1:
        return RankGroup(n).all_to_all(xs).reshape(n, rows_total, cols)
    full = torch.full((n, n), chunk, dtype=torch.int32, device=x.device)
    out = _ragged_a2a(xs, full, num_ranks=n, chunk=math.gcd(chunk, 128),
                      collective_id=A2A_ID)
    return out.reshape(n, rows_total, cols).clone()


def all_to_all(x, *, num_ranks: int,
               method: AllToAllMethod = AllToAllMethod.AUTO):
    """Host-level AllToAll of a global (n * n * rows, cols) tensor sharded on
    dim 0 over n ranks; the result sharded the same way."""
    n = num_ranks
    if x.dim() != 2 or x.shape[0] % (n * n):
        raise ValueError(f"all_to_all: x {tuple(x.shape)} is not (n * n * "
                         f"rows, cols) with n = {n}")
    out = all_to_all_shard(x.reshape(n, -1, x.shape[1]), num_ranks=n,
                           method=method)
    return out.reshape(-1, x.shape[1])
