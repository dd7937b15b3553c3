"""The collective kernel library (counterpart of
triton_distributed_tpu/ops/collectives): AllGather, ReduceScatter and
AllReduce with hand-written kernels (csrc/all_gather.cu,
reduce_scatter.cu, all_reduce.cu), full width and, with `wire_dtype`,
over quantized-wire arms that block-quantize each pushed value once (the
ring each hop's f32 running sum) and sum the dequantized values in f32
in rank order, rounding once; `all_gather.quant_all_gather_shard` gathers
at wire width. The dense AllToAll runs over the ragged all-to-all of
ops/ep_a2a.py. `hierarchical.py` (two-tier AllReduce) comes with a
two-axis rank group."""

from .all_gather import (  # noqa: F401
    AllGatherMethod,
    all_gather,
    all_gather_shard,
)
from .all_reduce import (  # noqa: F401
    AllReduceMethod,
    all_reduce,
    all_reduce_shard,
)
from .all_to_all import (  # noqa: F401
    AllToAllMethod,
    all_to_all,
    all_to_all_shard,
)
from .reduce_scatter import (  # noqa: F401
    ReduceScatterMethod,
    reduce_scatter,
    reduce_scatter_shard,
)
