"""Dense transformer LLM (Qwen3 / Llama / Seed-OSS family), at one rank or
tensor-parallel over n ranks in one process (counterpart of
triton_distributed_tpu/models/dense.py).

Parameters are a plain dict with the JAX package's layout and names:
{"embed": (V, H), "layers": {name: (L, ...)}, "norm": (H,),
"lm_head": (H, V)}, projection matrices stored (in, out) and stacked over
layers. The forward is an eager Python loop over the layers in place of
the JAX `lax.scan`; the KV cache is written in place, the contiguous
one (`prefill`, `decode_step`) and the paged pool of continuous
batching (`prefill_chunk_paged`, `decode_step_paged` and the
speculative `verify_step_paged`) alike.

At n ranks (`num_ranks=n`) each sharded parameter is rank-stacked
(parallel/mesh.py) by `PARAM_SPECS`, the JAX `param_specs`: w_qkv /
w_gate_up / lm_head split by columns, w_o / w_down by rows, with the rank
dimension after the layer dimension (lm_head: first); the rest is
replicated and kept once. The fused column groups are laid out for n
(`refuse_column_groups`), so the same draw of `init_params` is the same
logical model at every n. The contiguous cache is head-sharded, (L, n,
B, Smax, Hkv / n, D). Prefill runs sequence-sharded ("xla" / "fused",
padding the prompt to a multiple of n) or replicated ("ar" / "gemm_ar");
decode steps are replicated and end each projection in psum, or gemm_ar
in that mode; tokens come back as (B,), not per rank. The paged paths of
continuous batching run at n ranks the same way over a head-sharded pool
(models/paged_kv_cache.py), the n ranks' attention one launch.

`attn_parallelism="sp"` shards the SEQUENCE instead (JAX dense.py:106):
the weights are replicated (`SP_PARAM_SPECS`, still in the n-rank fused
column layout, so one parameter draw serves both parallelisms; the
lm_head stays vocab-sharded), the paged pool is sequence-sharded, and
only the paged serving paths exist: decode appends on the owner rank,
runs every rank's split-KV partial and combines them (`sp_combine`
"xla" | "ll", the one-shot kernel of ops/ll_gather.py); a prefill chunk
runs ring attention over the ranks' slices merged with their prefix
partials; the MLP runs full width, replicated (`_mlp_full`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import runtime
from ..ops.attention import rope_cos_sin
from ..layers.common import check_mode
from ..layers.norm import rms_norm
from ..layers.sp_attn import SPPagedAttn, SPPrefix
from ..layers.tp_attn import TPAttn
from ..layers.tp_mlp import TPMLP, fuse_column_parallel, silu
from ..parallel.mesh import RankGroup, shard
from .config import ModelConfig
from .kv_cache import KVCache
from .paged_kv_cache import PagedKVCache


def _logits(x, lm_head):
    """x (B, hidden) @ lm_head (hidden, V), accumulated and returned in
    f32 without a rounding to x's dtype (JAX: preferred_element_type). A
    rank-stacked lm_head (n, hidden, V / n) gives (n, B, V / n)."""
    if lm_head.dim() == 3:
        return torch.stack([_logits(x, w) for w in lm_head])
    if x.device.type == "cuda" and x.dtype != torch.float32:
        return torch.mm(x, lm_head, out_dtype=torch.float32)
    return x.float() @ lm_head.float()


def greedy_token(x, lm_head):
    """Greedy next token. x: (B, hidden). Returns (B,) int32; on ties the
    first maximum, as jnp.argmax. With a rank-stacked lm_head (n, hidden,
    V / n): the global argmax from the ranks' (max, argmax) pairs, the
    lowest rank winning ties (JAX greedy_token :68)."""
    logits = _logits(x, lm_head)
    if lm_head.dim() == 2:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    n, _, v_loc = logits.shape
    mx = logits.amax(dim=-1)                                  # (n, B)
    ix = logits.argmax(dim=-1) + torch.arange(
        n, device=x.device)[:, None] * v_loc
    best = torch.argmax(mx, dim=0)                            # first max
    return ix.gather(0, best[None])[0].to(torch.int32)


def sample_token(x, lm_head, generator: torch.Generator, *,
                 temperature: float, top_k: int):
    """Top-k temperature sampling by the Gumbel-max trick over the top-k
    logits (the JAX function's method; the noise comes from `generator`,
    so the draws differ from jax.random's). With a rank-stacked lm_head,
    each rank's top-k first, then the top-k of the gathered candidates
    (JAX sample_token :44). Returns (B,) int32."""
    logits = _logits(x, lm_head) / temperature
    if lm_head.dim() == 3:
        n, _, v_loc = logits.shape
        vals, idx = torch.topk(logits, min(top_k, v_loc), dim=-1)
        idx = idx + torch.arange(n, device=x.device)[:, None, None] * v_loc
        group = RankGroup(n)
        logits = group.all_gather(vals, axis=1, tiled=True)  # (B, n * k)
        idx_all = group.all_gather(idx, axis=1, tiled=True)
    vals, pos = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1)
    idx = pos if lm_head.dim() == 2 else idx_all.gather(-1, pos)
    u = torch.rand(vals.shape, generator=generator, device=vals.device)
    gumbel = -torch.log(-torch.log(
        u.clamp_min(torch.finfo(torch.float32).tiny)))
    choice = torch.argmax(vals + gumbel, dim=-1, keepdim=True)
    return idx.gather(-1, choice)[:, 0].to(torch.int32)


def refuse_column_groups(w, widths, n: int):
    """Re-pack a globally fused column-parallel tensor (last-axis column
    groups of the given widths, e.g. [q|k|v]) into the n-rank layout of
    `fuse_column_parallel`: [g0_0|g1_0|..|g0_1|g1_1|..]. Identity at n ==
    1 (JAX refuse_column_groups :84)."""
    if n == 1:
        return w
    parts = [p.chunk(n, dim=-1) for p in torch.split(w, list(widths), -1)]
    return torch.cat([p[r] for r in range(n) for p in parts], dim=-1)


# The global dimension each parameter is split along at n ranks (JAX
# DenseLLM.param_specs :145); None is replicated. The rank dimension goes
# right after the layer dimension for layer parameters, first for lm_head.
PARAM_SPECS = {"embed": None, "norm": None, "lm_head": 1,
               "layers": {"ln1": None, "ln2": None, "q_norm": None,
                          "k_norm": None, "w_qkv": 2, "w_o": 1,
                          "w_gate_up": 2, "w_down": 1}}
# attn_parallelism="sp": the trunk replicated (in the n-rank fused layout),
# the lm_head vocab-sharded as under "tp" (JAX param_specs :150)
SP_PARAM_SPECS = {"embed": None, "norm": None, "lm_head": 1,
                  "layers": dict.fromkeys(PARAM_SPECS["layers"])}


def place_params(params, n: int, specs=None):
    """Global parameters, laid out for n ranks (the JAX arrays' layout),
    to the port's rank-stacked dict by `specs` (default PARAM_SPECS; a
    Qwen3MoE passes its `param_specs()`). Identity at n == 1."""
    if n == 1:
        return params
    specs = specs or PARAM_SPECS

    def place(t, dim, at):
        return t if dim is None else shard(t, dim, n, at=at)

    return {"embed": params["embed"], "norm": params["norm"],
            "lm_head": place(params["lm_head"], specs["lm_head"], 0),
            "layers": {k: place(t, specs["layers"][k], 1)
                       for k, t in params["layers"].items()}}


class DenseLLM(nn.Module):
    """Dense LLM at `num_ranks` tensor-parallel ranks (default one). `mode`
    takes the JAX package's names ("xla" | "fused" | "ar" | "gemm_ar");
    at one rank they are the same math. `attn_parallelism` "tp" (heads
    sharded, the default) or "sp" (sequences sharded, paged serving only,
    the decode partials combined by `sp_combine`, "xla" or "ll"). Runs on
    `device` (default: the GPU, see runtime.default_device) in `dtype`
    ("bfloat16" | "float32" or a torch dtype)."""

    def __init__(self, config: ModelConfig, *, mode: str = "fused",
                 dtype=torch.bfloat16, device=None, num_ranks: int = 1,
                 attn_parallelism: str = "tp", sp_combine: str = "xla"):
        super().__init__()
        self.config = config
        self.mode = check_mode(mode)
        if attn_parallelism not in ("tp", "sp"):
            raise ValueError(f"attn_parallelism={attn_parallelism!r}: "
                             f"expected 'tp' or 'sp'")
        self.attn_parallelism = attn_parallelism
        self.sp_combine = sp_combine
        self.dtype = runtime.resolve_dtype(dtype)
        self.device = runtime.resolve_device(device)
        self.n = RankGroup(num_ranks).n
        c = config
        if c.vocab_size % self.n:
            raise ValueError(f"vocab {c.vocab_size} does not split into "
                             f"{self.n} ranks")
        self.attn = TPAttn(c.hidden_size, c.num_heads, c.num_kv_heads,
                           c.head_dim, mode=mode, rope_theta=c.rope_theta,
                           qk_norm=c.qk_norm, num_ranks=num_ranks)
        self.mlp = TPMLP(c.hidden_size, c.intermediate_size, mode=mode,
                         num_ranks=num_ranks)
        # decode steps run the MLP in the AllReduce modes (JAX dense.py:133)
        self._decode_mlp_mode = "gemm_ar" if mode == "gemm_ar" else "ar"
        self.sp_attn = None
        if attn_parallelism == "sp":
            self.sp_attn = SPPagedAttn(
                c.hidden_size, c.num_heads, c.num_kv_heads, c.head_dim,
                num_ranks=num_ranks, rope_theta=c.rope_theta,
                qk_norm=c.qk_norm, combine=sp_combine)

    @property
    def _sp(self) -> bool:
        return self.attn_parallelism == "sp"

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------
    def init_params(self, generator: torch.Generator):
        """Random parameters with the JAX package's scales (tied
        lm_head = embed.T, a view). `generator` lives on the model's
        device."""
        c, dt, dev = self.config, self.dtype, self.device
        L, H, D = c.num_layers, c.hidden_size, c.head_dim
        qkv_n = (c.num_heads + 2 * c.num_kv_heads) * D
        s = H ** -0.5

        def normal(shape, scale):
            return torch.randn(shape, generator=generator, dtype=dt,
                               device=dev).mul_(scale)

        layers = {
            "ln1": torch.ones((L, H), dtype=dt, device=dev),
            "ln2": torch.ones((L, H), dtype=dt, device=dev),
            "w_qkv": normal((L, H, qkv_n), s),
            "w_o": normal((L, c.num_heads * D, H), s),
            "w_gate_up": normal((L, H, 2 * c.intermediate_size), s),
            "w_down": normal((L, c.intermediate_size, H),
                             c.intermediate_size ** -0.5),
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

    def param_specs(self) -> dict:
        """The global dimension each parameter splits along at n ranks
        (PARAM_SPECS, or SP_PARAM_SPECS under "sp"; JAX param_specs
        :145)."""
        return SP_PARAM_SPECS if self._sp else PARAM_SPECS

    def shard_params(self, params):
        """One-rank parameters (the layout `init_params` and
        `load_state_dict` give at n = 1) re-laid for this model's n ranks:
        the fused column groups re-packed (`refuse_column_groups`), then
        rank-stacked (`place_params`). Identity at one rank."""
        if self.n == 1:
            return params
        c, D = self.config, self.config.head_dim
        kvw = c.num_kv_heads * D
        widths = {"w_qkv": (c.num_heads * D, kvw, kvw),
                  "w_gate_up": (c.intermediate_size, c.intermediate_size)}
        layers = {k: refuse_column_groups(t, widths[k], self.n)
                  if k in widths else t
                  for k, t in params["layers"].items()}
        return place_params({**params, "layers": layers}, self.n,
                            self.param_specs())

    def load_state_dict(self, sd):
        """Parameters from an HF-style name -> array mapping (torch
        tensors or numpy arrays). HF stores projections (out, in); the
        port keeps (in, out). Unlike nn.Module.load_state_dict this
        returns the params dict: the model itself holds no weights."""
        c, dt, dev = self.config, self.dtype, self.device

        def get(name):
            t = sd[name]
            if not isinstance(t, torch.Tensor):
                t = torch.from_numpy(np.asarray(t, dtype=np.float32))
            return t.detach().to(device=dev, dtype=dt)

        def lin(name):
            return get(name).t()

        names = ["ln1", "ln2", "w_qkv", "w_o", "w_gate_up", "w_down"]
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
            layers["w_gate_up"].append(fuse_column_parallel(
                [lin(pre + "mlp.gate_proj.weight"),
                 lin(pre + "mlp.up_proj.weight")], self.n))
            layers["w_down"].append(lin(pre + "mlp.down_proj.weight"))
            if c.qk_norm:
                layers["q_norm"].append(get(pre + "self_attn.q_norm.weight"))
                layers["k_norm"].append(get(pre + "self_attn.k_norm.weight"))
        embed = get("model.embed_tokens.weight")
        lm = embed.t() if c.tie_word_embeddings else lin("lm_head.weight")
        return place_params(
            {"embed": embed,
             "layers": {k: torch.stack(v) for k, v in layers.items()},
             "norm": get("model.norm.weight"), "lm_head": lm}, self.n,
            self.param_specs())

    # ------------------------------------------------------------------
    # Cache
    # ------------------------------------------------------------------
    def new_kv_cache(self, batch: int, max_len: int) -> KVCache:
        c = self.config
        return KVCache.create(c.num_layers, batch, max_len, c.num_kv_heads,
                              c.head_dim, dtype=self.dtype,
                              device=self.device, num_ranks=self.n)

    def _require_tp(self, op: str):
        if self._sp:
            raise ValueError(
                f"{op}: only the paged serving paths "
                f"(decode_step_paged / prefill_chunk_paged) exist "
                f"under attn_parallelism='sp' — the contiguous KVCache "
                f"is head-sharded, which SP replaces with sequence "
                f"sharding")

    def new_paged_kv_cache(self, batch: int, max_len: int, *,
                           block: int = 128, num_blocks: int | None = None,
                           kv_dtype: str | None = None) -> PagedKVCache:
        """Ragged paged cache for continuous batching (models/serve.py):
        `batch` slots of at most `max_len` tokens, blocks from a shared
        free-list pool, head-sharded over this model's ranks (under "sp":
        sequence-sharded). kv_dtype="int8" | "float8_e4m3fn" stores the
        pool at wire width with per-row f32 scale sidecars."""
        c = self.config
        return PagedKVCache.create(
            c.num_layers, batch, max_len, c.num_kv_heads, c.head_dim,
            block=block, num_blocks=num_blocks, dtype=self.dtype,
            kv_dtype=kv_dtype, device=self.device,
            num_ranks=1 if self._sp else self.n,
            sp_ranks=self.n if self._sp else 1)

    # ------------------------------------------------------------------
    # Forward
    # ------------------------------------------------------------------
    def _attn_layer_params(self, p):
        if self.config.qk_norm:
            return {"q_norm": p["q_norm"], "k_norm": p["k_norm"]}
        return {}

    def _mlp_rows(self, h, p, *, mode):
        """The MLP of one layer on (B, S, H) or (B, H) rows: the hook a
        subclass swaps (Qwen3MoE routes rows through its experts). At one
        rank every mode is the same dense math. At n ranks h is rank-
        stacked (n, ..., H) in "xla" / "fused" and replicated in "ar" /
        "gemm_ar"; the rows keep their order (sequence-major at prefill)."""
        if self.n == 1:
            return self.mlp._shard_fwd(h, p["w_gate_up"], p["w_down"])
        H = h.shape[-1]
        rows = (h.reshape(self.n, -1, H) if mode in ("xla", "fused")
                else h.reshape(-1, H))
        y = self.mlp._shard_fwd(rows, p["w_gate_up"], p["w_down"], mode=mode)
        return y.view(h.shape)

    def _layers(self, params):
        lp = params["layers"]
        for i in range(self.config.num_layers):
            yield i, {k: t[i] for k, t in lp.items()}

    def prefill(self, params, input_ids, cache: KVCache, true_len=None):
        """input_ids: (B, S) int. `true_len` (<= S) marks the real prompt
        length when the caller padded S up to a bucket: the next token
        comes from row true_len - 1 and the cache offset becomes
        true_len (pad rows fill cache positions >= true_len, which decode
        masks and overwrites). Returns (next_token (B,) int32, cache)."""
        last, cache = self._prefill_hidden(params, input_ids, cache,
                                           true_len)
        return greedy_token(last, params["lm_head"]), cache

    def _prefill_hidden(self, params, input_ids, cache: KVCache,
                        true_len=None):
        """Prefill up to the final norm: (last real row (B, hidden),
        cache)."""
        self._require_tp("prefill")
        ids = torch.as_tensor(input_ids, dtype=torch.int32,
                              device=self.device)
        B, S = ids.shape
        if S > cache.max_len:
            raise ValueError(f"prefill length {S} exceeds cache max_len "
                             f"{cache.max_len}")
        true_len = S if true_len is None else int(true_len)
        if self.n > 1:
            return self._prefill_hidden_ranks(params, ids, cache, true_len)
        eps = self.config.rms_norm_eps
        x = F.embedding(ids, params["embed"])              # (B, S, H)
        for i, p in self._layers(params):
            h = rms_norm(x, p["ln1"], eps)
            a, _, _ = self.attn._prefill_shard(
                self._attn_layer_params(p), h, p["w_qkv"], p["w_o"],
                cache.k[i], cache.v[i], seq_len=S)
            x = x + a
            h = rms_norm(x, p["ln2"], eps)
            x = x + self._mlp_rows(h, p, mode=self.mode)
        last = rms_norm(x[:, true_len - 1], params["norm"], eps)
        return last, KVCache(k=cache.k, v=cache.v, offset=true_len)

    def _prefill_hidden_ranks(self, params, ids, cache: KVCache,
                              true_len: int):
        """The n-rank prefill (JAX prefill :332) up to the final norm. In
        "xla" / "fused" the prompt is padded to a multiple of n (pad rows
        only fill cache positions >= true_len, which decode masks and
        overwrites) and rank r takes sequence chunk r; the last real row
        comes from the rank that holds position true_len - 1."""
        n, eps = self.n, self.config.rms_norm_eps
        B, S = ids.shape
        seq = self.mode in ("xla", "fused")
        s_pad = runtime.round_up(S, n) if seq else S
        if s_pad > cache.max_len:
            raise ValueError(f"padded prefill length {s_pad} exceeds cache "
                             f"max_len {cache.max_len}")
        if s_pad != S:
            ids = F.pad(ids, (0, s_pad - S))
        rows = ids.t()                                     # (S, B) seq-major
        if seq:
            rows = rows.reshape(n, s_pad // n, B)          # sequence chunks
        x = F.embedding(rows, params["embed"])
        for i, p in self._layers(params):
            h = rms_norm(x, p["ln1"], eps)
            a, _, _ = self.attn._prefill_ranks(
                self._attn_layer_params(p), h, p["w_qkv"], p["w_o"],
                cache.k[i], cache.v[i], seq_len=s_pad)
            x = x + a
            h = rms_norm(x, p["ln2"], eps)
            x = x + self._mlp_rows(h, p, mode=self.mode)
        t = true_len - 1
        last = x[t // (s_pad // n), t % (s_pad // n)] if seq else x[t]
        last = rms_norm(last, params["norm"], eps)
        return last, KVCache(k=cache.k, v=cache.v, offset=true_len)

    def decode_step(self, params, tok, cache: KVCache,
                    generator: torch.Generator | None = None, *,
                    sampling: bool | None = None, temperature: float = 0.0,
                    top_k: int = 50):
        """One decode step. tok: (B,) int. sampling=False (or temperature
        0) = greedy; otherwise top-k temperature sampling drawing from
        `generator`. Returns (next_token (B,) int32, cache advanced by
        one)."""
        if sampling is None:
            sampling = temperature > 0.0
        if sampling and generator is None:
            raise ValueError("sampling requires a torch.Generator")
        x, cache = self._decode_hidden(params, tok, cache)
        if sampling:
            nxt = sample_token(x, params["lm_head"], generator,
                               temperature=temperature, top_k=top_k)
        else:
            nxt = greedy_token(x, params["lm_head"])
        return nxt, cache

    def _decode_hidden(self, params, tok, cache: KVCache):
        """One decode step up to the final norm: (x (B, hidden), cache)."""
        self._require_tp("decode_step")
        if cache.offset >= cache.max_len:
            raise ValueError(f"KV cache full at {cache.max_len} positions")
        tok = torch.as_tensor(tok, dtype=torch.int32, device=self.device)
        eps = self.config.rms_norm_eps
        x = F.embedding(tok, params["embed"])              # (B, H)
        attn = self.attn._decode_shard if self.n == 1 \
            else self.attn._decode_ranks
        for i, p in self._layers(params):
            h = rms_norm(x, p["ln1"], eps)
            a, _, _ = attn(
                self._attn_layer_params(p), h, p["w_qkv"], p["w_o"],
                cache.k[i], cache.v[i], cache.offset)
            x = x + a
            h = rms_norm(x, p["ln2"], eps)
            x = x + self._mlp_rows(h, p, mode=self._decode_mlp_mode)
        x = rms_norm(x, params["norm"], eps)
        return x, KVCache(k=cache.k, v=cache.v, offset=cache.offset + 1)

    # ------------------------------------------------------------------
    # Paged forward (continuous batching, models/serve.py)
    # ------------------------------------------------------------------
    def _pool_layer(self, cache: PagedKVCache, i: int):
        """Layer i's pools and, for a quantized pool, its scale sidecars
        as keyword arguments (a head-sharded layer's ranks as one pool)."""
        kp, vp, ks, vs = cache.layer_pools(i)
        return kp, vp, ({} if ks is None
                        else {"k_scales": ks, "v_scales": vs})

    def _mlp_paged(self, h, p):
        """The MLP of the paged steps: full width and replicated under
        "sp", else the AllReduce modes."""
        if self._sp:
            return self._mlp_full(h, p)
        return self._mlp_rows(h, p, mode=self._decode_mlp_mode)

    def _mlp_full(self, h, p):
        """The replicated full-width SwiGLU of "sp" (JAX _mlp_full :720):
        the fused [gate_r | up_r] columns regrouped to the original order,
        no collective."""
        i_loc = self.config.intermediate_size // self.n
        gate, up = self.sp_attn._unfuse(h @ p["w_gate_up"], (i_loc, i_loc))
        return (silu(gate) * up) @ p["w_down"]

    def _next_token(self, x, params, generator, *, sampling, temperature,
                    top_k):
        if sampling:
            if generator is None:
                raise ValueError("sampling requires a torch.Generator")
            return sample_token(x, params["lm_head"], generator,
                                temperature=temperature, top_k=top_k)
        return greedy_token(x, params["lm_head"])

    def _ranks_rope(self, rope):
        """A head-sharded step's (cos, sin), one copy a rank."""
        if self.n == 1:
            return rope
        return tuple(t.repeat(self.n, *([1] * (t.dim() - 1))) for t in rope)

    def decode_step_paged(self, params, tok, cache: PagedKVCache, active,
                          generator: torch.Generator | None = None, *,
                          sampling: bool | None = None,
                          temperature: float = 0.0, top_k: int = 50,
                          attn_method: str | None = None):
        """One decode step over the RAGGED paged cache: every slot
        advances at its own length, inactive slots are masked (their
        pages are not written, their length does not move and their
        token carries through unchanged). Shapes stay at (B_max, ...)
        as in the JAX step. tok: (B,) ints; active: (B,) bools (host).
        The pool is updated in place. Returns (next_token (B,) int32,
        cache advanced by `active`).

        At n ranks every layer's attention runs the n ranks' heads in one
        launch over the head-sharded pool; under "sp" the step appends on
        the owner rank, runs every rank's split-KV partial over its pages
        and combines them (`attn_method` is the head-sharded path's)."""
        if sampling is None:
            sampling = temperature > 0.0
        tok = torch.as_tensor(tok, dtype=torch.int32, device=self.device)
        act = np.asarray(active, bool).reshape(-1)
        lens = cache.seq_lens.copy()
        dev, n = self.device, self.n
        kv_np = lens + act.astype(np.int32)
        rope = rope_cos_sin(torch.from_numpy(lens).to(dev)[:, None],
                            self.config.head_dim,
                            theta=self.config.rope_theta)     # (B, 1, D/2)
        at = cache.append_at(act)
        if self._sp:
            rt = cache.sp_rank_tokens(n)
            local = np.clip(kv_np[None] - np.arange(n)[:, None] * rt, 0, rt)
            args = (cache.sp_tables,
                    torch.from_numpy(local.astype(np.int32)).to(dev), rope,
                    at)
        else:
            kv_len = torch.from_numpy(kv_np).to(dev)
            args = (cache.rank_table.view(-1, cache.max_blocks),
                    kv_len.repeat(n), self._ranks_rope(rope),
                    at.over_ranks(n, cache.num_blocks, len(act))
                    if n > 1 else at)
        eps = self.config.rms_norm_eps
        x = F.embedding(tok, params["embed"])              # (B, H)
        for i, p in self._layers(params):
            h = rms_norm(x, p["ln1"], eps)
            kp, vp, scales = self._pool_layer(cache, i)
            if self._sp:
                a = self.sp_attn._decode_shard_paged(
                    self._attn_layer_params(p), h, p["w_qkv"], p["w_o"], kp,
                    vp, *args)
            else:
                a = self.attn._decode_shard_paged(
                    self._attn_layer_params(p), h, p["w_qkv"], p["w_o"], kp,
                    vp, *args, attn_method=attn_method, **scales)
            x = x + a
            h = rms_norm(x, p["ln2"], eps)
            x = x + self._mlp_paged(h, p)
        x = rms_norm(x, params["norm"], eps)
        nxt = self._next_token(x, params, generator, sampling=sampling,
                               temperature=temperature, top_k=top_k)
        cache.advance(slice(None), act.astype(np.int32))
        mask = torch.from_numpy(act).to(dev)
        return torch.where(mask, nxt, tok), cache

    def verify_step_paged(self, params, cand_toks, cache: PagedKVCache,
                          active, counts, *, attn_method: str | None = None):
        """One speculative-decode VERIFY step over the paged cache: slot b
        feeds `counts[b]` candidate tokens (cand_toks: (B, K) ints, row
        0 its last real token, rows 1..counts-1 the drafts, the rest
        pad) through ONE walk of the trunk; candidate j ropes and appends
        at position seq_lens[b] + j and attends the slot's prefix plus
        the candidates before it (TPAttn._verify_shard_paged). Returns
        (pred (B, K) int32 — the greedy next token after each candidate
        row: pred[b, j] verifies draft j + 1 and pred[b, accepted] is the
        bonus token — and the cache with counts[b] rows appended and
        seq_lens advanced by counts * active). The caller rolls rejected
        rows back with `PagedKVCache.truncate_slot`. counts == 1
        everywhere is exactly the greedy decode step. Greedy only: the
        accept rule is argmax == draft. The pool is updated in place;
        active / counts are host arrays. Not under "sp" (as in JAX)."""
        if self._sp:
            raise ValueError(
                "verify_step_paged: speculative decoding is not "
                "supported under attn_parallelism='sp' — serve with "
                "speculative=None (ServeEngine enforces this)")
        ids = torch.as_tensor(np.asarray(cand_toks), dtype=torch.int32,
                              device=self.device)
        B, K = ids.shape
        act = np.asarray(active, bool).reshape(-1)
        cnt = np.asarray(counts, np.int32).reshape(-1)
        lens = cache.seq_lens.astype(np.int64)
        dev, n = self.device, self.n
        pos = lens[:, None] + np.arange(K)[None, :]               # (B, K)
        live = (np.arange(K)[None, :] < cnt[:, None]) & act[:, None]
        kv_len = torch.from_numpy(
            np.where(live, pos + 1, 0).reshape(-1).astype(np.int32)).to(dev)
        rope = rope_cos_sin(torch.from_numpy(pos).to(dev),
                            self.config.head_dim,
                            theta=self.config.rope_theta)     # (B, K, D/2)
        at = cache.verify_at(cnt, act, K)
        if n > 1:
            at = at.over_ranks(n, cache.num_blocks, B * K)
        table = cache.rank_table.repeat_interleave(K, dim=1).view(
            -1, cache.max_blocks)
        args = (table, kv_len.repeat(n), self._ranks_rope(rope), at)
        eps = self.config.rms_norm_eps
        x = F.embedding(ids, params["embed"])              # (B, K, H)
        for i, p in self._layers(params):
            h = rms_norm(x, p["ln1"], eps)
            kp, vp, scales = self._pool_layer(cache, i)
            x = x + self.attn._verify_shard_paged(
                self._attn_layer_params(p), h, p["w_qkv"], p["w_o"], kp, vp,
                *args, attn_method=attn_method, **scales)
            h = rms_norm(x, p["ln2"], eps)
            x = x + self._mlp_rows(h, p, mode=self._decode_mlp_mode)
        x = rms_norm(x, params["norm"], eps)
        pred = greedy_token(x.reshape(B * K, -1), params["lm_head"])
        cache.advance(slice(None), np.where(act, cnt, 0).astype(np.int32))
        return pred.reshape(B, K), cache

    def prefill_chunk_paged(self, params, chunk_ids, cache: PagedKVCache,
                            slot: int, off: int, valid_len: int, *,
                            generator: torch.Generator | None = None,
                            sampling: bool = False, temperature: float = 0.0,
                            top_k: int = 50):
        """One prompt CHUNK of one slot: positions [off, off + valid_len)
        of sequence `slot` enter the paged pool in place (chunk_ids: (C,)
        ints, pad past valid_len arbitrary). Attention is the in-chunk
        causal partial merged with a partial over the ceil(off / block)
        pages holding the cached prefix (under "sp": ring attention over
        the ranks' chunk slices merged with each rank's prefix partial;
        the chunk must lie in one rank's ownership range, which
        `PagedKVCache.sp_owner` checks). Returns (next_token () int32 —
        meaningful when this is the prompt's final chunk, cache with
        seq_lens[slot] advanced by valid_len)."""
        slot, off, valid_len = int(slot), int(off), int(valid_len)
        ids = torch.as_tensor(chunk_ids, dtype=torch.int32,
                              device=self.device).reshape(-1)
        C, n = ids.shape[0], self.n
        if not 0 < valid_len <= C:
            raise ValueError(f"valid_len {valid_len} outside [1, {C}]")
        if self._sp:
            cache.sp_owner(off, valid_len, sp_ranks=n)
        rope = rope_cos_sin(off + torch.arange(C, device=self.device),
                            self.config.head_dim,
                            theta=self.config.rope_theta)     # (C, D/2)
        at = cache.chunk_at(slot, off, valid_len)
        if self._sp:
            rt = cache.sp_rank_tokens(n)
            prefix = SPPrefix.of(cache.block_table[slot], off, rt,
                                 cache.block, self.device) if off else None
        else:
            prefix = cache.prefix_pages(slot, off) if off else None
            if n > 1:
                at = at.over_ranks(n, cache.num_blocks, C)
                if prefix is not None:
                    prefix = (prefix[None] + torch.arange(
                        n, device=prefix.device)[:, None]
                        * cache.num_blocks).reshape(-1)
        eps = self.config.rms_norm_eps
        x = F.embedding(ids, params["embed"])              # (C, H)
        for i, p in self._layers(params):
            h = rms_norm(x, p["ln1"], eps)
            kp, vp, scales = self._pool_layer(cache, i)
            if self._sp:
                a = self.sp_attn._prefill_chunk_shard(
                    self._attn_layer_params(p), h, p["w_qkv"], p["w_o"], kp,
                    vp, rope, at, prefix, off, valid_len, rank_tokens=rt)
            else:
                a = self.attn._prefill_chunk_shard(
                    self._attn_layer_params(p), h, p["w_qkv"], p["w_o"], kp,
                    vp, rope, at, prefix, off, valid_len, **scales)
            x = x + a
            h = rms_norm(x, p["ln2"], eps)
            x = x + self._mlp_paged(h, p)
        last = rms_norm(x[valid_len - 1], params["norm"], eps)
        tok = self._next_token(last[None], params, generator,
                               sampling=sampling,
                               temperature=max(temperature, 1e-6),
                               top_k=top_k)
        cache.advance(slot, valid_len)
        return tok[0], cache
