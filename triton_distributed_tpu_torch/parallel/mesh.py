"""n tensor-parallel ranks in one process, on one device (counterpart of
triton_distributed_tpu/parallel/mesh.py).

The JAX package runs a tensor-parallel model as one `shard_map` over a
device mesh: each device holds its shard, and XLA collectives
(`all_gather`, `psum`, `psum_scatter`, `axis_index`) move data between
them. The port runs the n ranks in one process on one device. A per-rank
tensor carries a leading rank dimension: rank r's shard is `t[r]`, the
port's view of what `shard_map` hands device r. That one layout is also
the symmetric heap the communication kernels index (rank r's region at
`base + r * stride`, shmem/primitives.py). A value every rank holds
alike (the replicated activations of the "ar" modes, the tokens) is kept
once, without a rank dimension, and broadcasts against rank-stacked
weights: `x (M, K) @ w (n, K, N)` gives the n ranks' (M, N) products.

The collectives here are plain torch ops over the rank dimension, on any
device. They stand for XLA's collectives, which are not kernels in the
JAX package either; the fused GEMM+communication ops
(ops/ag_gemm.py, gemm_rs.py, gemm_ar.py) and the ragged all-to-all of
expert parallelism (ops/ep_a2a.py) have hand-written kernels.
`shard` / `unshard` move between a global array (the layout of a JAX
array under its PartitionSpec) and the rank-stacked one.
"""

from __future__ import annotations

import torch


def shard(t: torch.Tensor, dim: int, n: int, *, at: int = 0) -> torch.Tensor:
    """Split dimension `dim` of a global tensor into n equal contiguous
    shards and stack them on a new rank dimension at position `at`
    (counted in the result). Contiguous: a view of a contiguous t when the
    rank dimension stays where the split was (at == dim), as for experts
    split on their expert dimension, else a copy."""
    d = dim % t.dim()
    if t.shape[d] % n:
        raise ValueError(f"dimension {d} of {tuple(t.shape)} does not split "
                         f"into {n} ranks")
    parts = t.reshape(*t.shape[:d], n, t.shape[d] // n, *t.shape[d + 1:])
    return parts.movedim(d, at).contiguous()


def unshard(t: torch.Tensor, dim: int, *, at: int = 0) -> torch.Tensor:
    """Inverse of `shard`: the global tensor whose dimension `dim` holds
    the n shards of the rank dimension at `at`, in rank order."""
    n = t.shape[at]
    rest = t.movedim(at, 0)                       # (n, *shard_shape)
    d = dim % (t.dim() - 1)
    parts = rest.movedim(0, d)                    # rank dim before dim d
    shape = list(parts.shape)
    return parts.reshape(*shape[:d], n * shape[d + 1], *shape[d + 2:])


def sum_in_rank_order(parts: torch.Tensor) -> torch.Tensor:
    """parts (n, ...) summed over the rank dimension in rank order 0, 1,
    ..., n - 1 in f32, rounded once to parts' dtype: the reduction order of
    the fused kernels' plain versions and of `psum`."""
    acc = parts[0].float()
    for r in range(1, parts.shape[0]):
        acc = acc + parts[r].float()
    return acc.to(parts.dtype)


class RankGroup:
    """n tensor-parallel ranks in one process on one device: the port's
    mesh axis ("tp"). The collectives take rank-stacked tensors (n, ...)
    and name the JAX axis ops they stand for."""

    def __init__(self, n: int):
        if isinstance(n, bool) or int(n) != n or n < 1:
            raise ValueError(f"num_ranks must be a positive integer, got "
                             f"{n!r}")
        self.n = int(n)

    def __repr__(self):
        return f"RankGroup(n={self.n})"

    def _check(self, x):
        if x.shape[0] != self.n:
            raise ValueError(f"expected a rank-stacked tensor of {self.n} "
                             f"ranks, got shape {tuple(x.shape)}")

    def axis_index(self, device=None) -> torch.Tensor:
        """lax.axis_index: each rank's index, (n,) int32."""
        return torch.arange(self.n, dtype=torch.int32, device=device)

    def all_gather(self, x, *, axis: int = 0, tiled: bool = False):
        """lax.all_gather of rank-stacked x (n, *s): the replicated result,
        kept once. tiled: the n shards concatenated along `axis` of s;
        otherwise stacked on a new dimension `axis`."""
        self._check(x)
        if not tiled:
            return x.movedim(0, axis)
        return unshard(x, axis, at=0)

    def psum(self, x):
        """lax.psum of rank-stacked x: the replicated sum, kept once,
        summed in rank order in f32 and rounded once."""
        self._check(x)
        return sum_in_rank_order(x)

    def psum_scatter(self, x, *, scatter_dimension: int = 0,
                     tiled: bool = True):
        """lax.psum_scatter(tiled=True) of rank-stacked x (n, *s): rank r
        keeps chunk r of the sum along `scatter_dimension` of s."""
        if not tiled:
            raise NotImplementedError("psum_scatter(tiled=False) is not "
                                      "used by the ported layers")
        return shard(self.psum(x), scatter_dimension, self.n)

    def all_to_all(self, x):
        """lax.all_to_all(x, axis, split_axis=0, concat_axis=0,
        tiled=False) of rank-stacked x (n, n, *s): rank r's slab d goes to
        rank d, where it becomes slab r. A transpose of the first two
        dimensions, copied (the padded buffer moves as a whole)."""
        self._check(x)
        if x.dim() < 2 or x.shape[1] != self.n:
            raise ValueError(f"all_to_all takes (n, n, ...) with n = "
                             f"{self.n}, got shape {tuple(x.shape)}")
        return x.transpose(0, 1).contiguous()

    def ppermute_ring(self, x):
        """lax.ppermute of rank-stacked x over the ring perm [(i, (i + 1) %
        n)]: rank i's value lands on rank i + 1."""
        self._check(x)
        return torch.roll(x, 1, dims=0)
