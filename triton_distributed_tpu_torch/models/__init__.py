"""Model zoo + AutoLLM registry (counterpart of
triton_distributed_tpu/models/__init__.py): dense models and Qwen3-MoE,
with the per-request `Engine` and the continuous-batching
`ServeEngine` and its speculative-decode drafters."""

from __future__ import annotations

from .config import MODEL_CONFIGS, ModelConfig, get_config
from .convert import params_from_jax
from .dense import DenseLLM
from .engine import Engine
from .kv_cache import KVCache
from .paged_kv_cache import PagedKVCache
from .qwen_moe import Qwen3MoE
from .serve import ServeEngine
from .serve_state import BlockAlloc, Request, SchedCfg, SchedulerState
from .spec import NGramDrafter, OracleDrafter, SpecConfig

__all__ = ["AutoLLM", "BlockAlloc", "DenseLLM", "Engine", "KVCache",
           "ModelConfig", "MODEL_CONFIGS", "NGramDrafter", "OracleDrafter",
           "PagedKVCache", "Qwen3MoE", "Request", "SchedCfg",
           "SchedulerState", "ServeEngine", "SpecConfig", "get_config",
           "params_from_jax"]


class AutoLLM:

    @staticmethod
    def model_class(config: ModelConfig):
        if config.is_moe:
            return Qwen3MoE
        return DenseLLM

    @staticmethod
    def from_config(name_or_config, **kw):
        cfg = (name_or_config if isinstance(name_or_config, ModelConfig)
               else get_config(name_or_config))
        return AutoLLM.model_class(cfg)(cfg, **kw)
