"""Low-latency fused combine of decode partials (counterpart of
triton_distributed_tpu/ops/ll_gather.py, its `ll_combine_shard`,
`pack_partials`, `ll_merge_packed`, `ll_merge` and `AllGatherLayer`).

`ll_combine_shard(out, lse)` is the sequence-parallel flash-decode
combine as ONE kernel: each rank packs its (out, lse) partial into one
message, pushes it to every peer in one shot and lse-merges the n
partials it received (csrc/ll_combine.cu, `LL_COMBINE`). Rank-stacked
operands (parallel/mesh.py): out (n, B, H, D), lse (n, B, H); the
replicated result (B, H, D) is kept once. `ll_merge` is the merge half
alone over already-stacked partials (`LL_MERGE`, one row block a CTA),
reached by no model path.

The wire layout is the port's own: a packed row is W = round_up(D + 1, 4)
f32 lanes, [out | lse | zeros], with no pad rows. The JAX message gives
the lse a whole 128-lane tile and pads rows to 8 because Mosaic tiles f32
buffers so (its `_LSE_LANES` note); the kernel here needs one lane and
16-byte rows.

`AllGatherLayer` is the method-cached AllGather of the collective library
(ops/collectives/all_gather.py), taking `num_ranks` in place of the mesh.

On a CPU tensor both take their plain version (`_ll_combine_plain`,
`_ll_merge_packed_plain`): the partials stacked, then `combine_partials`'
math in f32 rank by rank in order, as `_merge_packed` does; on a CUDA
tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from .. import shmem
from ._build import CudaKernel, ptr, stream_of
from .collectives.all_gather import (AllGatherMethod, all_gather,
                                     all_gather_shard, choose_method)

_NEG_INF = -1e30
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)

LL_COMBINE = CudaKernel("ll_combine", "tdt_ll_combine",
                        shmem.primitives.LL_ARGTYPES)
LL_MERGE = CudaKernel("ll_combine", "tdt_ll_merge",
                      [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                      + [ctypes.c_void_p])


def packed_width(d: int) -> int:
    """f32 lanes of one packed row: the D payload lanes, the lse lane,
    zeros up to a multiple of 4 (16-byte rows)."""
    return -(-(d + 1) // 4) * 4


def pack_partials(out, lse):
    """One (B, H, D) partial and its (B, H) lse in the wire layout: (B * H,
    packed_width(D)) f32, [out | lse | zeros]."""
    B, H, D = out.shape
    rows = out.reshape(B * H, D).float()
    pad = torch.zeros((B * H, packed_width(D) - D - 1), dtype=torch.float32,
                      device=out.device)
    return torch.cat([rows, lse.reshape(B * H, 1).float(), pad], dim=1)


def _merge(outs, lses):
    """The lse-merge of n stacked partials, outs (n, ..., D) and lses (n,
    ...): max from -1e30, exp(l - m) weights and the weighted sum rank by
    rank in f32, num / max(den, 1e-30). Returns f32."""
    lf = lses.float()
    m = torch.full_like(lf[0], _NEG_INF)
    for s in range(lf.shape[0]):
        m = torch.maximum(m, lf[s])
    num = torch.zeros(outs.shape[1:], dtype=torch.float32, device=outs.device)
    den = torch.zeros_like(m)
    for s in range(lf.shape[0]):
        w = torch.exp(lf[s] - m)
        num = num + w[..., None] * outs[s].float()
        den = den + w
    return num / den.clamp_min(1e-30)[..., None]


def _ll_combine_plain(out, lse):
    """Plain version of the combine kernel: (B, H, D) in out's dtype."""
    return _merge(out, lse).to(out.dtype)


def _ll_merge_packed_plain(packed, d: int):
    """Plain version of the merge kernel: (rows, d) f32."""
    return _merge(packed[..., :d], packed[..., d])


def ll_combine_shard(out, lse, *, num_ranks: int,
                     wait_budget: float = shmem.WAIT_BUDGET_S):
    """Fused one-shot gather + lse-combine of the n ranks' decode
    partials. out: (n, B, H, D) rank-stacked, each normalised within its
    rank's KV range; lse: (n, B, H) their log-sum-exps. Returns (B, H, D)
    in out's dtype, the merge every rank holds (kept once). At one rank
    the partial itself."""
    n = num_ranks
    if out.dim() != 4 or out.shape[0] != n \
            or tuple(lse.shape) != tuple(out.shape[:3]):
        raise ValueError(f"ll_combine: out {tuple(out.shape)} / lse "
                         f"{tuple(lse.shape)} are not (n, B, H, D) / (n, B, "
                         f"H) with n = {n}")
    if n == 1:
        return out[0]
    if out.device.type == "cpu":
        return _ll_combine_plain(out, lse)
    _, B, H, D = out.shape
    _check_cuda(D, out, lse)
    if n > shmem.primitives.LL_MAX_RANKS:
        raise ValueError(f"ll_combine: at most "
                         f"{shmem.primitives.LL_MAX_RANKS} ranks, got {n}")
    rows = B * H
    o = out.contiguous().view(n, rows, D)
    ls = lse.float().contiguous().view(n, rows)
    ws = shmem.ll_workspace(out.device, n, rows, packed_width(D))
    merged = torch.empty((rows, D), dtype=out.dtype, device=out.device)
    shmem.launch_ll(LL_COMBINE, ws, o, ls, merged, budget_s=wait_budget)
    return merged.view(B, H, D)


def _check_cuda(d, first, *rest):
    """The kernels take CUDA tensors on one device, bf16 or f32 partials
    and a head_dim that is a multiple of 8."""
    if first.device.type != "cuda" or any(t.device != first.device
                                          for t in rest):
        raise ValueError(f"ll_gather: no kernel for tensors on "
                         f"{[str(t.device) for t in (first, *rest)]}")
    if first.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"ll_gather: the CUDA kernel takes bf16 or f32, got "
                        f"{first.dtype}")
    if d % 8:
        raise ValueError(f"ll_gather: head_dim {d} is not a multiple of 8")


def ll_merge_packed(packed, d: int):
    """The merge kernel over already-packed partials (n, rows,
    packed_width(d)) f32, the work buffer's layout after the one-shot
    push. Returns (rows, d) f32."""
    n, rows, width = packed.shape
    if width != packed_width(d):
        raise ValueError(f"ll_merge_packed: rows of {width} lanes are not the "
                         f"packed layout of d = {d} ({packed_width(d)})")
    if packed.device.type == "cpu":
        return _ll_merge_packed_plain(packed, d)
    _check_cuda(d, packed)
    if packed.dtype != torch.float32:
        raise TypeError(f"ll_merge_packed: packed rows are f32, got "
                        f"{packed.dtype}")
    packed = packed.contiguous()
    merged = torch.empty((rows, d), dtype=torch.float32, device=packed.device)
    LL_MERGE.launch(ptr(packed), ptr(merged), n, rows, d, width,
                    stream_of(packed))
    return merged


def ll_merge(outs, lses):
    """Merge n stacked decode partials (outs (n, B, H, D), lses (n, B, H))
    with the merge kernel: the consumer half of `ll_combine_shard` without
    the one-shot push. Returns (B, H, D) in outs' dtype."""
    n, B, H, D = outs.shape
    packed = torch.stack([pack_partials(outs[s], lses[s]) for s in range(n)])
    return ll_merge_packed(packed, D).view(B, H, D).to(outs.dtype)


class AllGatherLayer:
    """Method-cached AllGather (JAX :218): AUTO resolves the method per
    shard byte size (`choose_method`: the full-mesh push up to 1 MiB, the
    ring above), so one layer serving a decode message and a prefill
    message picks each its own method; an explicit method is kept."""

    def __init__(self, *, num_ranks: int,
                 method: AllGatherMethod = AllGatherMethod.AUTO):
        self.n = num_ranks
        self._method = method
        self._by_bytes: dict[int, AllGatherMethod] = {}

    def _resolve_bytes(self, shard_bytes: int) -> AllGatherMethod:
        if self._method != AllGatherMethod.AUTO:
            return self._method
        m = self._by_bytes.get(shard_bytes)
        if m is None:
            m = self._by_bytes[shard_bytes] = choose_method(shard_bytes,
                                                            self.n)
        return m

    def resolve(self, x) -> AllGatherMethod:
        """The method for rank-stacked shards x (n, rows, cols)."""
        return self._resolve_bytes(x.numel() // self.n * x.element_size())

    def shard(self, x):
        """x (n, rows, cols) rank-stacked -> (n, n * rows, cols), every
        rank's copy (`all_gather_shard`)."""
        return all_gather_shard(x, num_ranks=self.n, method=self.resolve(x))

    def __call__(self, x):
        """The global (n * rows, cols), sharded on dim 0 -> the replicated
        (n * rows, cols) (`all_gather`)."""
        return all_gather(x, num_ranks=self.n, method=self.resolve(x))
