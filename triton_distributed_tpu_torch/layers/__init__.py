"""One-rank counterparts of the JAX package's tensor-parallel layers."""

from .norm import rms_norm  # noqa: F401
from .tp_attn import TPAttn  # noqa: F401
from .tp_mlp import TPMLP  # noqa: F401
