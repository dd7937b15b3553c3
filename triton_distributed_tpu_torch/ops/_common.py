"""Small shared helpers of the port's ops (counterpart of the parts of
triton_distributed_tpu/ops/_common.py that the ported ops use)."""

from __future__ import annotations

import dataclasses


def resolve_block_m(block_m, gemm):
    """One source of truth for the MoE row-tile size. An explicit outer
    `block_m` (not None) propagates into the grouped-GEMM config and
    wins; `block_m=None` adopts the gemm config's value. Returns the
    resolved (block_m, gemm) pair — after resolution the two agree."""
    if block_m is None:
        return gemm.block_m, gemm
    return block_m, dataclasses.replace(gemm, block_m=block_m)
