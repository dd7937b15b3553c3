"""Counterparts of the JAX package's tensor-parallel layers (the dense
ones at n ranks, the MoE layer at one)."""

from .norm import rms_norm  # noqa: F401
from .tp_attn import TPAttn  # noqa: F401
from .tp_mlp import TPMLP  # noqa: F401
