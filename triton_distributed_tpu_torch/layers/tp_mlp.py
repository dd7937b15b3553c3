"""Tensor-parallel gated MLP (SwiGLU) at one rank (counterpart of
triton_distributed_tpu/layers/tp_mlp.py).

The gate and up projections are fused into one matrix whose columns are
ordered so each rank's shard is [gate_i | up_i] (`fuse_column_parallel`);
one matmul feeds both halves.
"""

from __future__ import annotations

import torch
from torch import nn

from .common import check_mode, check_one_rank, row_parallel_out


def fuse_column_parallel(mats, num_ranks: int):
    """Fuse column-parallel matrices so each rank's shard is the concat
    of each matrix's shard: columns ordered [m0_0|m1_0|..|m0_1|m1_1|..].
    mats: list of (K, Ni) tensors, each Ni divisible by num_ranks."""
    shards = []
    for i in range(num_ranks):
        for m in mats:
            ni = m.shape[1] // num_ranks
            shards.append(m[:, i * ni:(i + 1) * ni])
    return torch.cat(shards, dim=1)


def silu(x):
    return x * torch.sigmoid(x.float()).to(x.dtype)


class TPMLP(nn.Module):
    """params: {"w_gate_up": (hidden, 2*inter) fused column-parallel,
    "w_down": (inter, hidden) row-parallel}."""

    def __init__(self, hidden: int, intermediate: int, *, mode: str = "fused",
                 num_ranks: int = 1):
        super().__init__()
        self.hidden = hidden
        self.intermediate = intermediate
        self.mode = check_mode(mode)
        self.n = check_one_rank(num_ranks)

    def shard_params(self, w_gate, w_up, w_down):
        """The fused param dict from plain (in, out) matrices."""
        return {"w_gate_up": fuse_column_parallel([w_gate, w_up], self.n),
                "w_down": w_down}

    def forward(self, params, x):
        """x: (tokens, hidden). Returns (tokens, hidden)."""
        return self._shard_fwd(x, params["w_gate_up"], params["w_down"])

    def _shard_fwd(self, x, w_gu, w_down):
        inter_per = self.intermediate // self.n
        h = x @ w_gu
        act = silu(h[..., :inter_per]) * h[..., inter_per:]
        return row_parallel_out(act, w_down, mode=self.mode,
                                num_ranks=self.n)
