"""Qwen3-MoE transformer, tensor- or expert-parallel experts (counterpart
of triton_distributed_tpu/models/qwen_moe.py).

A DenseLLM whose MLP is the MoE layer. `moe_parallel="tp"` (the default)
gives every rank a slice of every expert (`layers/tp_moe.TPMoE`);
`moe_parallel="ep"` gives each rank whole experts and sends the tokens
to them over the ragged all-to-all (`layers/ep_moe.EPMoE`, csrc/ep_a2a.cu
on the GPU), with `ep_method` ("ragged" | "xla"), `ep_chunk` (its rows a
chunk) and `ep_pipeline` (token chunks of the EP forward). Everything
else — attention, norms, caches, the contiguous and the paged steps, and
so `Engine` and `ServeEngine` — is inherited; every step routes its rows
through `_mlp_rows`. At n ranks, sequence-sharded prefill ("xla" /
"fused") takes the layer's forward (the all-to-all under EP); decode and
prefill in "ar" / "gemm_ar" take replicated rows (`decode_rows_shard`
under EP: no all-to-all, a psum of the ranks' shares).

Parameters add, per layer: "router" (L, H, E) f32, "w_moe_gate_up"
(L, E, H, 2I) with each expert's gate and up columns fused, and
"w_moe_down" (L, E, I, H); the dense "w_gate_up" / "w_down" are absent.
At n ranks (`param_specs`): tensor-parallel experts split gate_up by
columns (each rank's [gate_i | up_i], re-fused for n) and down by rows;
expert-parallel ones split both on the expert dimension, rank r's
experts at [:, r] of (L, n, E / n, ...), a view of the one-rank tensor:
the same storage, no copy (`shard_params`, `params_from_jax`).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..layers.ep_moe import EPMoE
from ..layers.tp_moe import TPMoE, fuse_expert_gate_up
from ..layers.tp_mlp import fuse_column_parallel
from ..ops.grouped_gemm import GroupedGemmConfig
from ..parallel.mesh import shard
from .dense import PARAM_SPECS, DenseLLM, place_params, refuse_column_groups


def moe_param_specs(moe_parallel: str) -> dict:
    """PARAM_SPECS for a Qwen3MoE (JAX Qwen3MoE.param_specs :128): the
    dense MLP's entries out, the router replicated, the experts split by
    columns / rows ("tp") or on the expert dimension ("ep")."""
    specs = copy.deepcopy(PARAM_SPECS)
    layers = specs["layers"]
    del layers["w_gate_up"], layers["w_down"]
    layers["router"] = None
    if moe_parallel == "tp":
        layers["w_moe_gate_up"], layers["w_moe_down"] = 3, 2
    else:
        layers["w_moe_gate_up"], layers["w_moe_down"] = 1, 1
    return specs


class Qwen3MoE(DenseLLM):

    def __init__(self, config, *, moe_config=None, moe_parallel: str = "tp",
                 ep_method: str = "ragged", ep_chunk: int = 128,
                 ep_pipeline: int | str = 1, **kw):
        super().__init__(config, **kw)
        c = config
        if not c.is_moe:
            raise ValueError(f"{c.name}: Qwen3MoE requires a MoE config "
                             f"(num_experts > 0)")
        if moe_parallel not in ("tp", "ep"):
            raise ValueError(f"moe_parallel={moe_parallel!r}: choose 'tp' "
                             f"or 'ep'")
        self.moe_parallel = moe_parallel
        if moe_parallel == "tp":
            self.moe = TPMoE(c.hidden_size, c.moe_intermediate_size,
                             c.num_experts, c.num_experts_per_tok,
                             mode=self.mode, norm_topk_prob=c.norm_topk_prob,
                             config=moe_config, num_ranks=self.n)
            return
        # the shared MoE config carries its gemm tiling and block_m over to
        # EP; its method="xla" asks for the XLA transport
        mc = moe_config
        method = "xla" if mc is not None and mc.method == "xla" else ep_method
        self.moe = EPMoE(
            c.num_experts, c.hidden_size, c.moe_intermediate_size,
            c.num_experts_per_tok, num_ranks=self.n, method=method,
            chunk=ep_chunk, pipeline=ep_pipeline,
            norm_topk_prob=c.norm_topk_prob,
            gemm=mc.gemm if mc is not None else GroupedGemmConfig(),
            block_m=mc.block_m if mc is not None else None)

    # ------------------------------------------------------------------
    # Serving-capacity guard
    # ------------------------------------------------------------------
    def check_serving_capacity(self, b_max: int, *, prefill_chunk: int = 0,
                               spec_k: int = 0, ep_capacity: int = 0):
        """ServeEngine's construction-time guard (JAX :90): refuse an
        explicit EP `capacity` smaller than the assignments one engine step
        can route, which would drop the overflow silently. The worst step
        is the larger of a prefill chunk's rank-local rows and B_max rows
        (masked slots still enter the router) times the verify width, or
        the scheduler's `ep_capacity` row budget when one is armed.
        Tensor-parallel experts (and capacity=None) have nothing to
        check."""
        if self.moe_parallel != "ep" or self.moe.capacity is None:
            return
        k = self.config.num_experts_per_tok
        decode_rows = (int(ep_capacity) if ep_capacity
                       else b_max * max(1, int(spec_k)))
        rows = max(-(-max(1, int(prefill_chunk)) // self.n), decode_rows)
        need = rows * k
        if self.moe.capacity < need:
            raise ValueError(
                f"EPMoE.capacity={self.moe.capacity} cannot cover the "
                f"{need} assignments ({rows} rows x top_k={k}) one engine "
                f"step can route: over-capacity assignments would be "
                f"dropped silently (zero contribution) on the serving path. "
                f"Raise capacity to >= {need}, leave it None (sized per "
                f"batch), or arm SchedCfg.ep_capacity so the scheduler "
                f"defers the overflow")

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------
    def param_specs(self) -> dict:
        return moe_param_specs(self.moe_parallel)

    def init_params(self, generator: torch.Generator):
        """Random parameters with the JAX package's scales, drawn at one
        rank and laid out for n (`shard_params`), so every n and both
        layouts hold the same logical model. The fused (L, E, H, 2I)
        expert tensor is filled layer by layer in place (gate columns,
        then up columns), so no unfused copy ever exists: at
        Qwen3-30B-A3B's size that copy would need ~38 GiB more.
        `generator` lives on the model's device."""
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
        return self.shard_params({"embed": embed, "layers": layers,
                                  "norm": torch.ones((H,), dtype=dt,
                                                     device=dev),
                                  "lm_head": lm})

    def shard_params(self, params):
        """One-rank parameters re-laid for this model's n ranks: the dense
        part as DenseLLM's, tensor-parallel experts re-fused for n
        (`refuse_column_groups`) and split by columns / rows (copies),
        expert-parallel experts split on the expert dimension (views of
        the one-rank tensors). Identity at one rank."""
        if self.n == 1:
            return params
        if self.moe_parallel == "ep":
            return super().shard_params(params)
        # tensor-parallel experts a layer at a time, into the result, so no
        # copy of every layer's experts exists beside it
        n, I = self.n, self.config.moe_intermediate_size
        layers = dict(params["layers"])
        gu, dn = layers.pop("w_moe_gate_up"), layers.pop("w_moe_down")
        out = super().shard_params({**params, "layers": layers})
        L, E, H, _ = gu.shape
        gu_r = gu.new_empty((L, n, E, H, 2 * I // n))
        dn_r = dn.new_empty((L, n, E, I // n, H))
        for i in range(L):
            gu_r[i] = shard(refuse_column_groups(gu[i], (I, I), n), 2, n)
            dn_r[i] = shard(dn[i], 1, n)
        out["layers"].update(w_moe_gate_up=gu_r, w_moe_down=dn_r)
        return out

    def load_state_dict(self, sd):
        """Parameters from HF Qwen3-MoE names: per layer the router
        `mlp.gate.weight` (kept in f32 after a round trip through the
        model dtype, as the JAX loader does) and
        `mlp.experts.{j}.{gate,up,down}_proj.weight`; rank-stacked at n."""
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
        return place_params(
            {"embed": embed,
             "layers": {k: torch.stack(v) for k, v in layers.items()},
             "norm": get("model.norm.weight"), "lm_head": lm}, self.n,
            self.param_specs())

    def _fuse_gate_up(self, gate, up):
        """Tensor-parallel experts fuse per-shard [gate_i | up_i] columns;
        expert-parallel ones keep the plain [gate | up] (each rank holds
        whole experts)."""
        if self.moe_parallel == "tp":
            return fuse_expert_gate_up(gate, up, self.n)
        return torch.cat([gate, up], dim=-1)

    # ------------------------------------------------------------------
    # Forward: the MoE block in place of the MLP
    # ------------------------------------------------------------------
    def _moe_rows(self, rows, p, mode):
        """The MoE block on rows: (n, m, H) sequence-sharded or (M, H)
        replicated (at one rank always (M, H))."""
        args = (p["router"], p["w_moe_gate_up"], p["w_moe_down"])
        if self.moe_parallel == "tp":
            return self.moe._shard_fwd(rows, *args, mode=mode)
        if mode in ("ar", "gemm_ar"):     # EP decode: replicated rows
            return self.moe.decode_rows_shard(rows, *args)
        if rows.dim() == 2:               # EP prefill at one rank
            return self.moe._shard_fwd(rows[None], *args)[0]
        return self.moe._shard_fwd(rows, *args)

    def _mlp_rows(self, h, p, *, mode):
        H = h.shape[-1]
        if self.n == 1 and h.dim() == 3:
            # (B, S, H): seq-major rows, as the JAX model flattens them
            B, S, _ = h.shape
            y = self._moe_rows(h.transpose(0, 1).reshape(-1, H), p, mode)
            return y.reshape(S, B, H).transpose(0, 1)
        # n ranks: (n, S / n, B, H) sequence-sharded in "xla" / "fused",
        # (S, B, H) or (B, H) replicated otherwise; seq-major already
        seq = self.n > 1 and mode in ("xla", "fused")
        rows = h.reshape(self.n, -1, H) if seq else h.reshape(-1, H)
        return self._moe_rows(rows, p, mode).reshape(h.shape)
