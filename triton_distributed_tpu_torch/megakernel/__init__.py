"""Megakernel: a whole decode step (or prefill chunk) as one persistent
CUDA kernel (counterpart of triton_distributed_tpu/megakernel/).

The reference MegaTritonKernel (SURVEY.md §2.7) captures the model as
tile-granular tasks (`ModelBuilder`, graph.py), packs per-SM work queues
with a dependency scoreboard (scheduler.py) and runs ONE persistent
kernel whose SMs walk their queues. The port keeps the JAX package's
graph and builder API and runs them two ways:

- `ExecutorTorch` (backend "graph"): the golden executor, node by node
  in torch — the counterpart of the JAX `ExecutorXLA`;
- `ExecutorCuda` (backend "kernel"): csrc/megakernel.cu, one CTA per SM
  walking its queue and spinning on the scoreboard — the counterpart of
  the JAX `ExecutorPallas` — with its plain queue walk on the CPU.

`MegaDecoder` serves one sequence over contiguous caches through them;
`MegaServe` is ServeEngine's batched decode step (mode="megakernel")
over the paged KV pool.
"""

from .builder import ModelBuilder  # noqa: F401
from .decoder import MegaDecoder  # noqa: F401
from .graph import Graph, TensorHandle  # noqa: F401
from .serve import MegaServe  # noqa: F401
