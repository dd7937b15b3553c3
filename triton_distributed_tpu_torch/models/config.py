"""Model configuration + registry (a copy of the JAX package's
triton_distributed_tpu/models/config.py).

Qwen3-{0.6,1.7,8,14,32}B dense, Qwen3-30B-A3B / 235B-A22B (MoE),
Llama-3-70B, Seed-OSS-36B, with the public HF `config.json` values for
those checkpoints. The port keeps its own copy so that it imports
nothing of the JAX package; tests/test_torch_models.py holds the two
registries equal field by field.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    qk_norm: bool = True          # Qwen3-style per-head q/k RMSNorm
    tie_word_embeddings: bool = False
    # MoE fields (num_experts == 0 -> dense model)
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    norm_topk_prob: bool = True

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def tiny(self, **overrides) -> "ModelConfig":
        """A structurally-identical miniature for tests/dry-runs."""
        small = dict(
            vocab_size=256, hidden_size=128, intermediate_size=256,
            num_layers=2, num_heads=8,
            num_kv_heads=min(8, self.num_kv_heads), head_dim=64)
        if self.is_moe:
            small.update(num_experts=8, num_experts_per_tok=2,
                         moe_intermediate_size=128)
        small.update(overrides)
        return dataclasses.replace(self, **small)


def _qwen3(name, hidden, inter, layers, heads, kv, tie=False):
    return ModelConfig(
        name=name, vocab_size=151936, hidden_size=hidden,
        intermediate_size=inter, num_layers=layers, num_heads=heads,
        num_kv_heads=kv, head_dim=128, rope_theta=1e6, qk_norm=True,
        tie_word_embeddings=tie)


def _qwen3_moe(name, hidden, layers, heads, kv, experts, topk, moe_inter):
    return ModelConfig(
        name=name, vocab_size=151936, hidden_size=hidden,
        intermediate_size=0, num_layers=layers, num_heads=heads,
        num_kv_heads=kv, head_dim=128, rope_theta=1e6, qk_norm=True,
        num_experts=experts, num_experts_per_tok=topk,
        moe_intermediate_size=moe_inter)


MODEL_CONFIGS: dict[str, ModelConfig] = {
    "Qwen/Qwen3-0.6B": _qwen3("Qwen/Qwen3-0.6B", 1024, 3072, 28, 16, 8,
                              tie=True),
    "Qwen/Qwen3-1.7B": _qwen3("Qwen/Qwen3-1.7B", 2048, 6144, 28, 16, 8,
                              tie=True),
    "Qwen/Qwen3-8B": _qwen3("Qwen/Qwen3-8B", 4096, 12288, 36, 32, 8),
    "Qwen/Qwen3-14B": _qwen3("Qwen/Qwen3-14B", 5120, 17408, 40, 40, 8),
    "Qwen/Qwen3-32B": _qwen3("Qwen/Qwen3-32B", 5120, 25600, 64, 64, 8),
    "Qwen/Qwen3-30B-A3B": _qwen3_moe("Qwen/Qwen3-30B-A3B", 2048, 48, 32, 4,
                                     128, 8, 768),
    "Qwen/Qwen3-235B-A22B": _qwen3_moe("Qwen/Qwen3-235B-A22B", 4096, 94, 64,
                                       4, 128, 8, 1536),
    "meta-llama/Meta-Llama-3-70B": ModelConfig(
        name="meta-llama/Meta-Llama-3-70B", vocab_size=128256,
        hidden_size=8192, intermediate_size=28672, num_layers=80,
        num_heads=64, num_kv_heads=8, head_dim=128, rms_norm_eps=1e-5,
        rope_theta=5e5, qk_norm=False),
    "ByteDance-Seed/Seed-OSS-36B-Instruct": ModelConfig(
        name="ByteDance-Seed/Seed-OSS-36B-Instruct", vocab_size=155136,
        hidden_size=5120, intermediate_size=27648, num_layers=64,
        num_heads=80, num_kv_heads=8, head_dim=128, rope_theta=1e7,
        qk_norm=False),
}


def get_config(name: str) -> ModelConfig:
    if name in MODEL_CONFIGS:
        return MODEL_CONFIGS[name]
    # allow short names: "Qwen3-8B" -> "Qwen/Qwen3-8B"
    for full, cfg in MODEL_CONFIGS.items():
        if full.split("/")[-1] == name:
            return cfg
    raise KeyError(f"unknown model {name!r}; known: {sorted(MODEL_CONFIGS)}")
