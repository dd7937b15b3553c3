"""triton_distributed_tpu_torch — the PyTorch + CUDA port of
`triton_distributed_tpu`, for NVIDIA Hopper (H100).

The layout mirrors the JAX package (`ops/`, `layers/`, `models/`,
`runtime.py`) so each module's counterpart is easy to find. Plain tensor
code is PyTorch; every Pallas kernel on a ported path is a CUDA C++
kernel under `csrc/`, built with `nvcc` at first use and loaded with
ctypes (`ops/_build.py`). Dense Qwen3 / Llama and Qwen3-MoE generation
through `models.Engine`, continuous batching through
`models.ServeEngine`, and the megakernel decode path through
`MegaDecoder` (megakernel/), at one rank; generation through `Engine`
also over n ranks in one process on one card: dense tensor-parallel
(`DenseLLM(num_ranks=n)`) and Qwen3-MoE with tensor- or expert-parallel
experts (`Qwen3MoE(num_ranks=n, moe_parallel="tp" | "ep")`), over
`parallel/` and `shmem/`; the collective and sequence-parallel attention
libraries (`ops/collectives`, `ops/sp_attention.py`,
`ops/sp_ag_attention.py`, `ops/ulysses.py`) at n ranks too.
"""

__version__ = "0.1.0"

from . import runtime  # noqa: F401
from .runtime import default_device  # noqa: F401
from .megakernel import MegaDecoder  # noqa: F401
from .models import Engine  # noqa: F401
