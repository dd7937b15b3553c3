"""Counterparts of the JAX package's tensor-, sequence- and
expert-parallel layers, at one rank or n."""

from .ep_moe import EPMoE  # noqa: F401
from .norm import rms_norm  # noqa: F401
from .sp_attn import (SpFlashDecodeAttention, SPPagedAttn,  # noqa: F401
                      UlyssesAttn)
from .tp_attn import TPAttn  # noqa: F401
from .tp_mlp import TPMLP  # noqa: F401
from .tp_moe import TPMoE  # noqa: F401
