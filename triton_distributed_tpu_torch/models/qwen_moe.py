"""Qwen3-MoE transformer at one rank, tensor-parallel experts
(counterpart of triton_distributed_tpu/models/qwen_moe.py).

A DenseLLM whose MLP is the MoE layer (`layers/tp_moe.TPMoE`): the
router picks top-k experts per token and the block-aligned grouped GEMM
(csrc/grouped_gemm.cu on the GPU) runs them. Everything else —
attention, norms, caches, the contiguous and the paged steps, and so
`Engine` and `ServeEngine` — is inherited; every step routes its rows
through `_mlp_rows`.

Parameters add, per layer: "router" (L, H, E) f32, "w_moe_gate_up"
(L, E, H, 2I) with each expert's [gate | up] columns fused, and
"w_moe_down" (L, E, I, H); the dense "w_gate_up" / "w_down" are absent.

Only `moe_parallel="tp"`: the expert-parallel path rides the EP
all-to-all, a multi-rank kernel (slice 6).
"""

from __future__ import annotations

import numpy as np
import torch

from ..layers.tp_moe import TPMoE, fuse_expert_gate_up
from ..layers.tp_mlp import fuse_column_parallel
from .dense import DenseLLM


class Qwen3MoE(DenseLLM):

    def __init__(self, config, *, moe_config=None, moe_parallel: str = "tp",
                 **kw):
        super().__init__(config, **kw)
        c = config
        if not c.is_moe:
            raise ValueError(f"{c.name}: Qwen3MoE requires a MoE config "
                             f"(num_experts > 0)")
        if moe_parallel == "ep":
            raise NotImplementedError(
                "moe_parallel='ep' (whole experts per rank over the EP "
                "all-to-all: layers/ep_moe.py, ops/ep_a2a.py) is not ported "
                "yet: it comes with slice 6 (ROADMAP.md, Queue A)")
        if moe_parallel != "tp":
            raise ValueError(f"moe_parallel={moe_parallel!r}: choose 'tp'")
        self.moe_parallel = moe_parallel
        self.moe = TPMoE(c.hidden_size, c.moe_intermediate_size,
                         c.num_experts, c.num_experts_per_tok,
                         mode=self.mode, norm_topk_prob=c.norm_topk_prob,
                         config=moe_config, num_ranks=self.n)

    # ------------------------------------------------------------------
    # Serving-capacity guard
    # ------------------------------------------------------------------
    def check_serving_capacity(self, b_max: int, *, prefill_chunk: int = 0,
                               spec_k: int = 0, ep_capacity: int = 0):
        """ServeEngine's construction-time guard against an explicit EP
        expert capacity too small for one engine step. Tensor-parallel
        experts have no capacity (every routed row is computed), so it
        returns at once, as the JAX model does under "tp"."""
        return

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------
    def init_params(self, generator: torch.Generator):
        """Random parameters with the JAX package's scales. The fused
        (L, E, H, 2I) expert tensor is filled layer by layer in place
        (gate columns, then up columns), so no unfused copy ever
        exists: at Qwen3-30B-A3B's size that copy would need ~38 GiB
        more. `generator` lives on the model's device."""
        c, dt, dev = self.config, self.dtype, self.device
        L, H, D = c.num_layers, c.hidden_size, c.head_dim
        E, I = c.num_experts, c.moe_intermediate_size
        qkv_n = (c.num_heads + 2 * c.num_kv_heads) * D
        s = H ** -0.5

        def normal(shape, scale, dtype=dt):
            return torch.randn(shape, generator=generator, dtype=dtype,
                               device=dev).mul_(scale)

        gu = torch.empty((L, E, H, 2 * I), dtype=dt, device=dev)
        down = torch.empty((L, E, I, H), dtype=dt, device=dev)
        for i in range(L):
            for part in (gu[i, ..., :I], gu[i, ..., I:]):
                part.normal_(generator=generator).mul_(s)
            down[i].normal_(generator=generator).mul_(I ** -0.5)
        layers = {
            "ln1": torch.ones((L, H), dtype=dt, device=dev),
            "ln2": torch.ones((L, H), dtype=dt, device=dev),
            "w_qkv": normal((L, H, qkv_n), s),
            "w_o": normal((L, c.num_heads * D, H), s),
            "router": normal((L, H, E), s, torch.float32),
            "w_moe_gate_up": gu,
            "w_moe_down": down,
        }
        if c.qk_norm:
            layers["q_norm"] = torch.ones((L, D), dtype=dt, device=dev)
            layers["k_norm"] = torch.ones((L, D), dtype=dt, device=dev)
        embed = normal((c.vocab_size, H), s)
        lm = embed.t() if c.tie_word_embeddings else normal((H, c.vocab_size),
                                                            s)
        return {"embed": embed, "layers": layers,
                "norm": torch.ones((H,), dtype=dt, device=dev),
                "lm_head": lm}

    def load_state_dict(self, sd):
        """Parameters from HF Qwen3-MoE names: per layer the router
        `mlp.gate.weight` (kept in f32 after a round trip through the
        model dtype, as the JAX loader does) and
        `mlp.experts.{j}.{gate,up,down}_proj.weight`."""
        c, dt, dev = self.config, self.dtype, self.device

        def get(name):
            t = sd[name]
            if not isinstance(t, torch.Tensor):
                t = torch.from_numpy(np.asarray(t, dtype=np.float32))
            return t.detach().to(device=dev, dtype=dt)

        def lin(name):
            return get(name).t()

        names = ["ln1", "ln2", "w_qkv", "w_o", "router", "w_moe_gate_up",
                 "w_moe_down"]
        if c.qk_norm:
            names += ["q_norm", "k_norm"]
        layers = {k: [] for k in names}
        for i in range(c.num_layers):
            pre = f"model.layers.{i}."
            layers["ln1"].append(get(pre + "input_layernorm.weight"))
            layers["ln2"].append(get(pre + "post_attention_layernorm.weight"))
            layers["w_qkv"].append(fuse_column_parallel(
                [lin(pre + "self_attn.q_proj.weight"),
                 lin(pre + "self_attn.k_proj.weight"),
                 lin(pre + "self_attn.v_proj.weight")], self.n))
            layers["w_o"].append(lin(pre + "self_attn.o_proj.weight"))
            if c.qk_norm:
                layers["q_norm"].append(get(pre + "self_attn.q_norm.weight"))
                layers["k_norm"].append(get(pre + "self_attn.k_norm.weight"))
            layers["router"].append(lin(pre + "mlp.gate.weight").float())

            def experts(proj):
                return torch.stack([lin(f"{pre}mlp.experts.{j}.{proj}.weight")
                                    for j in range(c.num_experts)])

            layers["w_moe_gate_up"].append(self._fuse_gate_up(
                experts("gate_proj"), experts("up_proj")))
            layers["w_moe_down"].append(experts("down_proj"))
        embed = get("model.embed_tokens.weight")
        lm = embed.t() if c.tie_word_embeddings else lin("lm_head.weight")
        return {"embed": embed,
                "layers": {k: torch.stack(v) for k, v in layers.items()},
                "norm": get("model.norm.weight"), "lm_head": lm}

    def _fuse_gate_up(self, gate, up):
        """Tensor-parallel experts fuse per-shard [gate_i | up_i]
        columns."""
        return fuse_expert_gate_up(gate, up, self.n)

    # ------------------------------------------------------------------
    # Forward: the MoE block in place of the MLP
    # ------------------------------------------------------------------
    def _mlp_rows(self, h, p, *, mode):
        def moe(rows):
            return self.moe._shard_fwd(rows, p["router"], p["w_moe_gate_up"],
                                       p["w_moe_down"], mode=mode)

        if h.ndim == 2:
            return moe(h)
        # (B, S, H): seq-major rows, as the JAX model flattens them
        B, S, H = h.shape
        y = moe(h.transpose(0, 1).reshape(-1, H))
        return y.reshape(S, B, H).transpose(0, 1)
