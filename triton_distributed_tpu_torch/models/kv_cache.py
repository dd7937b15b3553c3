"""Contiguous KV cache (counterpart of
triton_distributed_tpu/models/kv_cache.py).

Two stacked buffers (L, B, Smax, Hkv, D) and a host int `offset`, the
number of positions already cached. Layers write the buffers in place;
a step returns a new KVCache over the same buffers with the offset
advanced. At n ranks the cache is head-sharded (JAX `KVCache.part_spec`
:36, heads on the tensor-parallel axis): (L, n, B, Smax, Hkv / n, D),
rank r's heads at [:, r]; `HEAD_DIM` names the dimension of the global
(L, B, Smax, Hkv, D) layout that the ranks split.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor       # (L, B, S_max, H_kv, D)
    v: torch.Tensor       # (L, B, S_max, H_kv, D)
    offset: int           # tokens already cached

    HEAD_DIM = 3          # of the global layout; the rank dimension is 1

    @property
    def max_len(self) -> int:
        return self.k.shape[-3]

    @staticmethod
    def create(num_layers: int, batch: int, max_len: int, num_kv_heads: int,
               head_dim: int, *, dtype, device,
               num_ranks: int = 1) -> "KVCache":
        n = num_ranks
        if num_kv_heads % n:
            raise ValueError(f"{num_kv_heads} kv heads do not split into {n} "
                             f"ranks")
        shape = ((num_layers, batch, max_len, num_kv_heads, head_dim)
                 if n == 1 else
                 (num_layers, n, batch, max_len, num_kv_heads // n, head_dim))
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device),
                       offset=0)
