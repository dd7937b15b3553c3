"""Contiguous KV cache (counterpart of
triton_distributed_tpu/models/kv_cache.py).

Two stacked buffers (L, B, Smax, Hkv, D) and a host int `offset`, the
number of positions already cached. Layers write the buffers in place;
a step returns a new KVCache over the same buffers with the offset
advanced.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor       # (L, B, S_max, H_kv, D)
    v: torch.Tensor       # (L, B, S_max, H_kv, D)
    offset: int           # tokens already cached

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @staticmethod
    def create(num_layers: int, batch: int, max_len: int, num_kv_heads: int,
               head_dim: int, *, dtype, device) -> "KVCache":
        shape = (num_layers, batch, max_len, num_kv_heads, head_dim)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device),
                       offset=0)
