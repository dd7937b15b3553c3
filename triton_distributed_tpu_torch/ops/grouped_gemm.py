"""Grouped (per-expert) GEMM for MoE (counterpart of
triton_distributed_tpu/ops/grouped_gemm.py).

Tokens arrive sorted by expert and block-aligned (ops/moe_utils.py), so
every `block_m`-row tile of the LHS belongs to exactly one expert, named
by `tile_expert`. `gmm` dispatches on where its tensors lie: a CPU tensor
goes through the plain PyTorch version (`_gmm_plain`); a CUDA tensor
launches the hand-written kernel csrc/grouped_gemm.cu (`GMM`, with a
`launches` count) or raises on what the kernel does not take. Nothing
falls back from one to the other. `ragged_dot_aligned` is a second plain
form of the same function (the JAX package's XLA `ragged_dot` path).

`group_sizes` (the plan's true tokens per expert, a device tensor) is a
port-side argument of `gmm`, required on a CUDA tensor: the kernel reads
the live row count of each tile from it on the device and writes zeros
for rows past it without reading a weight, which is the result the JAX
kernel computes from the zero pad rows of `moe_utils.gather_sorted`. The
caller promises that those rows are zero. The plain version computes
every row and ignores it.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ._build import CudaKernel, ptr, stream_of

GMM = CudaKernel("grouped_gemm", "tdt_gmm_bf16",
                 [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                 + [ctypes.c_void_p])

_SLICE_7 = ("config='auto' (the grouped-GEMM autotuner, resolve_gmm_config "
            "and AUTO_BASES) is not ported yet: it comes with slice 7 "
            "(ROADMAP.md, Queue A)")


@dataclasses.dataclass(frozen=True)
class GroupedGemmConfig:
    """`block_m` is the row-tile size of the aligned layout (the
    granularity of `tile_expert`). `block_n` / `block_k` are the JAX
    kernel's VMEM tile sizes; the CUDA kernel picks its own CTA tile and
    ignores them. `use_xla` asks for the `ragged_dot_aligned` form, which
    the port has on the CPU only."""
    block_m: int = 128
    block_n: int = 256
    block_k: int = 1024
    use_xla: bool = False


def _gmm_plain(lhs, rhs, tile_expert, block_m: int):
    """Plain PyTorch version of the kernel: one batched product over the
    row tiles, each against its expert's slab, accumulated in f32."""
    P, K = lhs.shape
    T = P // block_m
    out = torch.bmm(lhs.reshape(T, block_m, K).float(),
                    rhs[tile_expert.long()].float())
    return out.reshape(P, rhs.shape[2]).to(lhs.dtype)


def gmm(lhs, rhs, tile_expert, *, config: GroupedGemmConfig | str | None = None,
        group_sizes=None):
    """Block-aligned grouped GEMM: out[t] = lhs[t] @ rhs[tile_expert[t]]
    for each row tile t of `block_m` rows.

    lhs: (P, K) expert-sorted aligned rows (moe_utils.gather_sorted).
    rhs: (E, K, N) per-expert weights. tile_expert: (P // block_m,)
    int32. group_sizes: (E,) int32 true rows per expert of the same
    plan, required on a CUDA tensor (see the module docstring). Returns
    (P, N) in lhs's dtype, accumulated in f32."""
    if config == "auto":
        raise NotImplementedError(_SLICE_7)
    cfg = config or GroupedGemmConfig()
    P, K = lhs.shape
    E, K2, N = rhs.shape
    bm = cfg.block_m
    if K != K2:
        raise ValueError(f"lhs {tuple(lhs.shape)} and rhs {tuple(rhs.shape)} "
                         f"disagree on K")
    if P % bm or tuple(tile_expert.shape) != (P // bm,):
        raise ValueError(f"lhs rows {P}, tile_expert {tuple(tile_expert.shape)}"
                         f" and block_m {bm} do not match")
    if lhs.device.type == "cpu":
        if cfg.use_xla:
            return ragged_dot_aligned(lhs, rhs, tile_expert, block_m=bm)
        return _gmm_plain(lhs, rhs, tile_expert, bm)
    if lhs.device.type != "cuda":
        raise ValueError(f"no kernel for device {lhs.device}")
    if cfg.use_xla:
        raise ValueError("gmm: use_xla selects the plain ragged_dot form, "
                         "which runs on the CPU only; a CUDA tensor goes "
                         "through the kernel")
    for name, t, dt in (("lhs", lhs, torch.bfloat16),
                        ("rhs", rhs, torch.bfloat16),
                        ("tile_expert", tile_expert, torch.int32)):
        if t.device != lhs.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"gmm: the CUDA kernel takes {name} as a "
                             f"contiguous {dt} tensor on {lhs.device}, got "
                             f"{t.dtype} on {t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"gmm: {name} not 16-byte aligned")
    if group_sizes is None or (
            group_sizes.device != lhs.device
            or group_sizes.dtype != torch.int32
            or tuple(group_sizes.shape) != (E,)
            or not group_sizes.is_contiguous()):
        raise ValueError(f"gmm: the CUDA kernel needs group_sizes, a "
                         f"contiguous ({E},) int32 tensor on {lhs.device}")
    if bm % 16 or K % 16 or N % 8:
        raise ValueError(f"gmm: the CUDA kernel takes block_m % 16 == 0, "
                         f"K % 16 == 0 and N % 8 == 0; got block_m {bm}, "
                         f"K {K}, N {N}")
    out = torch.empty((P, N), dtype=lhs.dtype, device=lhs.device)
    if P == 0 or N == 0:
        return out
    GMM.launch(ptr(lhs), ptr(rhs), ptr(tile_expert), ptr(group_sizes),
               ptr(out), P, K, N, E, bm, stream_of(lhs))
    return out


def resolve_gmm_config(lhs, rhs, tile_expert, *, allow_coarsen: bool = False):
    """The config="auto" resolution: waits for the autotuner (slice 7)."""
    raise NotImplementedError(_SLICE_7)


def ragged_dot_aligned(lhs, rhs, tile_expert, *, block_m: int):
    """The grouped GEMM over the aligned layout in the form of a ragged
    dot: consecutive per-expert row counts rebuilt from the tile->expert
    map (tiles are expert-sorted, so counts = tile occurrences *
    block_m), trailing pad tiles folded into the last expert's count (their
    rows are zero), then each row against its group's expert."""
    E = rhs.shape[0]
    P = lhs.shape[0]
    counts = torch.zeros(E, dtype=torch.int64, device=lhs.device).scatter_add_(
        0, tile_expert.long(), torch.ones_like(tile_expert, dtype=torch.int64))
    counts = counts * block_m
    counts[E - 1] += P - counts.sum()
    row_expert = torch.repeat_interleave(
        torch.arange(E, device=lhs.device), counts, output_size=P)
    x = lhs.float()
    out = torch.zeros((P, rhs.shape[2]), dtype=torch.float32,
                      device=lhs.device)
    for e in range(E):
        out += torch.where((row_expert == e)[:, None], x @ rhs[e].float(), 0.0)
    return out.to(lhs.dtype)
