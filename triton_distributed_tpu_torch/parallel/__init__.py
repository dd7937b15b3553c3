"""n tensor-parallel ranks in one process (counterpart of
triton_distributed_tpu/parallel)."""

from .mesh import RankGroup, shard, unshard  # noqa: F401
