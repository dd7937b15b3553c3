"""Kernel library of the port: each op with a hand-written CUDA kernel
(csrc/) and a plain PyTorch version beside it."""

from . import sp_ag_attention  # noqa: F401
from . import sp_attention  # noqa: F401
from . import ulysses  # noqa: F401
