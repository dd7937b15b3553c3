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

`MegaDecoder` serves one sequence over contiguous caches through them.
Paged serving (`MegaServe`, ServeEngine mode="megakernel") is the next
slice.
"""

from .builder import ModelBuilder  # noqa: F401
from .decoder import MegaDecoder  # noqa: F401
from .graph import Graph, TensorHandle  # noqa: F401


def __getattr__(name):
    if name == "MegaServe":
        from .builder import later_slice
        raise later_slice("MegaServe", "3b", " (paged serving)")
    raise AttributeError(name)
