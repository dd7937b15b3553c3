"""RMSNorm (counterpart of triton_distributed_tpu/layers/norm.py)."""

from __future__ import annotations

import torch


def rms_norm(x, weight, eps: float = 1e-6):
    """Normalise in f32, cast back to x's dtype, then scale by the weight
    in that dtype: the JAX function's rounding points."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.reciprocal(torch.sqrt(var + eps))).to(x.dtype) * weight
