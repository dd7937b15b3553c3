"""Tensor-parallel gated MLP (SwiGLU) (counterpart of
triton_distributed_tpu/layers/tp_mlp.py).

The gate and up projections are fused into one matrix whose columns are
ordered so each rank's shard is [gate_i | up_i] (`fuse_column_parallel`);
one matmul feeds both halves. At n ranks the weights are rank-stacked
(parallel/mesh.py): w_gate_up (n, hidden, 2 * inter / n) column shards,
w_down (n, inter / n, hidden) row shards. The modes are the JAX layer's:
"fused" runs ag_gemm, SiLU x up, gemm_rs on sequence-sharded rows; "xla"
the same with plain collectives; "ar" / "gemm_ar" take replicated rows
and end in psum / gemm_ar. `wire_dtype` ("int8" / "float8_e4m3fn")
quantizes the down projection's collective wire (row_parallel_out);
compute stays full precision.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import wire
from ..ops.ag_gemm import ag_gemm_shard
from ..parallel.mesh import RankGroup, shard
from .common import check_mode, row_parallel_out


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
    """params: {"w_gate_up": fused column-parallel, "w_down": row-parallel}:
    (hidden, 2*inter) and (inter, hidden) at one rank, rank-stacked at n."""

    def __init__(self, hidden: int, intermediate: int, *, mode: str = "fused",
                 num_ranks: int = 1, wire_dtype=None):
        super().__init__()
        self.hidden = hidden
        self.intermediate = intermediate
        self.mode = check_mode(mode)
        self.wire_dtype = wire.resolve_wire_dtype(wire_dtype)
        self.n = RankGroup(num_ranks).n
        if intermediate % self.n:
            raise ValueError(f"intermediate {intermediate} does not split "
                             f"into {self.n} ranks")

    def shard_params(self, w_gate, w_up, w_down):
        """The fused param dict from plain (in, out) matrices, rank-stacked
        at n ranks (JAX shard_params :92)."""
        gu = fuse_column_parallel([w_gate, w_up], self.n)
        if self.n == 1:
            return {"w_gate_up": gu, "w_down": w_down}
        return {"w_gate_up": shard(gu, 1, self.n),
                "w_down": shard(w_down, 0, self.n)}

    def forward(self, params, x):
        """x: (tokens, hidden) at one rank; at n ranks rank-stacked (n,
        tokens / n, hidden) for "xla" / "fused", replicated (tokens,
        hidden) for "ar" / "gemm_ar". Returns the same layout."""
        return self._shard_fwd(x, params["w_gate_up"], params["w_down"])

    def _shard_fwd(self, x, w_gu, w_down, *, mode=None):
        mode = mode or self.mode
        n = self.n
        inter_per = self.intermediate // n
        if n > 1 and mode == "fused":
            h = ag_gemm_shard(x, w_gu, num_ranks=n)
        elif n > 1 and mode == "xla":
            h = RankGroup(n).all_gather(x, tiled=True) @ w_gu
        else:  # one rank, or "ar" / "gemm_ar": x replicated
            h = x @ w_gu
        act = silu(h[..., :inter_per]) * h[..., inter_per:]
        return row_parallel_out(act, w_down, mode=mode, num_ranks=n,
                                wire_dtype=self.wire_dtype)
