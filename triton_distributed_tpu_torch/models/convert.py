"""Carry weights across from the JAX package.

`params_from_jax` takes the JAX DenseLLM params pytree after
`jax.device_get` / `np.asarray` (nested dicts of numpy arrays) and
returns the port's params dict with the same names and layout. A bf16
JAX array arrives as an `ml_dtypes.bfloat16` numpy array, which
`torch.from_numpy` rejects: every leaf goes through float32, which is
exact for bf16 and f16, and is cast back to its own width.

The JAX params of an n-rank DenseLLM are global arrays already in the
n-rank fused layout (its `init_params` / `load_state_dict` lay the [q|k|v]
and [gate|up] column groups out for n). `params_from_jax(tree,
num_ranks=n)` splits them into the port's rank-stacked shards by
`dense.PARAM_SPECS`: w_qkv / w_gate_up / lm_head by columns, w_o / w_down
by rows, the rest replicated; a Qwen3MoE's experts by
`qwen_moe.moe_param_specs` of its layout. The tree of a sequence-parallel
DenseLLM (attn_parallelism="sp") has the same n-rank fused layout with the
trunk replicated: `params_from_jax(tree, num_ranks=n,
attn_parallelism="sp")` keeps every layer leaf whole, once, and splits
only the lm_head (`dense.SP_PARAM_SPECS`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import runtime

_TORCH_FLOATS = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                 "float32": torch.float32}


def _leaf(a, device):
    a = np.asarray(a)
    if a.dtype.name not in _TORCH_FLOATS:
        raise TypeError(f"params_from_jax: unexpected leaf dtype {a.dtype}")
    t = torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
    return t.to(device=device, dtype=_TORCH_FLOATS[a.dtype.name])


def params_from_jax(tree, *, device=None, num_ranks: int = 1,
                    moe_parallel: str = "tp", attn_parallelism: str = "tp"):
    """JAX params pytree of numpy arrays -> the port's params dict
    ({"embed", "layers": {ln1, ln2, w_qkv, w_o, w_gate_up, w_down,
    q_norm, k_norm}, "norm", "lm_head"}; a Qwen3MoE tree has router
    (f32), w_moe_gate_up and w_moe_down in place of the MLP) on
    `device`, each leaf at its own dtype; rank-stacked for a model of
    `num_ranks` ranks. A Qwen3MoE tree's experts are split as its
    `moe_parallel` says (the JAX arrays of the two layouts have the same
    shapes): "ep" on the expert dimension, as views of the converted
    global tensors. `attn_parallelism="sp"`: the dense trunk replicated,
    the lm_head vocab-sharded."""
    from .dense import PARAM_SPECS, SP_PARAM_SPECS, place_params
    from .qwen_moe import moe_param_specs

    device = runtime.resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _leaf(node, device)

    params = conv(tree)
    moe = "w_moe_gate_up" in params["layers"]
    if moe:
        specs = moe_param_specs(moe_parallel)
    else:
        specs = SP_PARAM_SPECS if attn_parallelism == "sp" else PARAM_SPECS
    return place_params(params, num_ranks, specs)
