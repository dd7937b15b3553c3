"""MegaDecoder: end-to-end token generation on the megakernel path
(counterpart of triton_distributed_tpu/megakernel/decoder.py).

embed -> ONE kernel launch per step for the whole trunk -> lm_head. Two
programs serve a generation: a prefill-chunk program (seq_len = C) run
ceil(P / C) times at cache_len = i*C, and a decode program (seq_len = 1)
run once per token. Both share one set of weights (views of the
DenseLLM params, never copied) and one set of per-layer caches, which
the kernel's kv_append tasks update in place, so K/V never leave the
device. `fuse_elementwise` / `fuse_kv_append` build the decode program
fused (with both, 6 tasks a layer instead of 13: the norms, SiLU and
residual adds folded into the LINEARs, the appends into attention); the
prefill program stays node-level. Between launches the host does only the embed lookup, the
lm_head matmul and argmax (or Gumbel top-k sampling); the token stays on
the device and `serve` reads the tokens once, at the end.

`from_dense` maps a single-rank DenseLLM's parameters onto the
megakernel weight naming, which gives a token-exact cross-check against
the port's Engine and the JAX MegaDecoder (tests/test_torch_megakernel.py).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import runtime
from ..models.dense import greedy_token, sample_token
from .builder import later_slice
from .executor_cuda import indexed
from .models import build_qwen3_decode


def dense_weight_map(model, params):
    """Map a single-rank DenseLLM's parameters onto the megakernel
    weight naming. Every value is a VIEW of `params` (stored (in, out)
    as in JAX): `w_gate` / `w_up` are the column halves of `w_gate_up`,
    with row stride 2 x intermediate. Returns (weights, embed,
    lm_head)."""
    if model.n != 1:
        raise ValueError(f"dense_weight_map maps one-rank parameters; a "
                         f"{model.n}-rank model's shards map through "
                         f"dense_weight_map_tp")
    c = model.config
    if c.is_moe:
        raise ValueError(
            f"{c.name} is a MoE model: MegaDecoder and dense_weight_map "
            f"take dense models only; a MoE model serves on the megakernel "
            f"through ServeEngine(mode='megakernel') (moe_weight_map)")
    lay = params["layers"]
    inter = c.intermediate_size
    weights = {"final_norm": params["norm"][None]}
    for i in range(c.num_layers):
        pre = f"l{i}."
        weights[pre + "ln1"] = lay["ln1"][i][None]
        weights[pre + "ln2"] = lay["ln2"][i][None]
        weights[pre + "w_qkv"] = lay["w_qkv"][i]
        weights[pre + "w_o"] = lay["w_o"][i]
        weights[pre + "w_gate"] = lay["w_gate_up"][i][:, :inter]
        weights[pre + "w_up"] = lay["w_gate_up"][i][:, inter:]
        weights[pre + "w_down"] = lay["w_down"][i]
        if c.qk_norm:
            weights[pre + "q_norm"] = lay["q_norm"][i][None]
            weights[pre + "k_norm"] = lay["k_norm"][i][None]
    return weights, params["embed"], params["lm_head"]


def dense_weight_map_tp(model, params):
    """Map an n-rank DenseLLM's parameters onto the megakernel weight
    naming as rank stacks (JAX dense_weight_map_tp, decoder.py:64): every
    value has a leading (n,) rank dimension, rank r's shard in the model's
    own layout (`fuse_column_parallel`): w_qkv columns [q_r | k_r | v_r],
    w_o / w_down row slices, w_gate / w_up the column halves of rank r's
    [gate_r | up_r]. The sharded ones are views of `params`; the norms,
    which every rank holds alike, are views expanded over the rank
    dimension (rank stride 0), so nothing is copied. The per-rank graph is
    the local-width trunk with an all_reduce after w_o and w_down. Returns
    (weights, embed, lm_head): the lm_head stays rank-stacked (n, hidden,
    V / n), as `greedy_token` / `sample_token` take it at n ranks."""
    n = model.n
    if n < 2:
        raise ValueError("dense_weight_map_tp maps an n-rank model's shards; "
                         "a one-rank model maps through dense_weight_map")
    c = model.config
    if c.is_moe:
        raise ValueError(f"{c.name} is a MoE model: the megakernel serves "
                         f"MoE at one rank only")
    if c.num_heads % n or c.num_kv_heads % n or c.intermediate_size % n:
        raise ValueError(
            f"dense_weight_map_tp: heads {c.num_heads} / kv heads "
            f"{c.num_kv_heads} / intermediate {c.intermediate_size} must "
            f"all divide over {n} ranks")
    lay = params["layers"]
    i_loc = c.intermediate_size // n

    def rep(t):
        return t[None].expand(n, 1, *t.shape)

    weights = {"final_norm": rep(params["norm"])}
    for i in range(c.num_layers):
        pre = f"l{i}."
        weights[pre + "ln1"] = rep(lay["ln1"][i])
        weights[pre + "ln2"] = rep(lay["ln2"][i])
        weights[pre + "w_qkv"] = lay["w_qkv"][i]
        weights[pre + "w_o"] = lay["w_o"][i]
        weights[pre + "w_gate"] = lay["w_gate_up"][i][:, :, :i_loc]
        weights[pre + "w_up"] = lay["w_gate_up"][i][:, :, i_loc:]
        weights[pre + "w_down"] = lay["w_down"][i]
        if c.qk_norm:
            weights[pre + "q_norm"] = rep(lay["q_norm"][i])
            weights[pre + "k_norm"] = rep(lay["k_norm"][i])
    return weights, params["embed"], params["lm_head"]


def moe_weight_map(model, params):
    """Map a single-rank Qwen3MoE's parameters onto the MoE serving
    program's weight naming. The attention and norm tensors follow
    `dense_weight_map`; each layer's MLP becomes the router and the
    stacked expert slabs, `w_moe_gate_up` (E, H, 2I) as (E*H, 2I) and
    `w_moe_down` (E, I, H) as (E*I, H): VIEWS of the model's tensors,
    nothing copied. The one copy is the router: the model keeps it in
    f32, the program runs it as a LINEAR in the model dtype (as the JAX
    program does), so it is cast, L x H x E elements (24 MiB for
    Qwen3-30B-A3B in bf16; none in f32). Returns (weights, embed,
    lm_head)."""
    if model.n != 1:
        raise later_slice("moe_weight_map of a multi-rank model", "6",
                          " (the multi-rank layer)")
    c = model.config
    if not c.is_moe:
        raise ValueError(f"{c.name} is not a MoE model: use "
                         f"dense_weight_map")
    lay = params["layers"]
    E, H, inter = c.num_experts, c.hidden_size, c.moe_intermediate_size
    weights = {"final_norm": params["norm"][None]}
    for i in range(c.num_layers):
        pre = f"l{i}."
        weights[pre + "ln1"] = lay["ln1"][i][None]
        weights[pre + "ln2"] = lay["ln2"][i][None]
        weights[pre + "w_qkv"] = lay["w_qkv"][i]
        weights[pre + "w_o"] = lay["w_o"][i]
        weights[pre + "router"] = lay["router"][i].to(model.dtype)
        weights[pre + "w_moe_gate_up"] = lay["w_moe_gate_up"][i].view(
            E * H, 2 * inter)
        weights[pre + "w_moe_down"] = lay["w_moe_down"][i].view(
            E * inter, H)
        if c.qk_norm:
            weights[pre + "q_norm"] = lay["q_norm"][i][None]
            weights[pre + "k_norm"] = lay["k_norm"][i][None]
    return weights, params["embed"], params["lm_head"]


class MegaDecoder:

    def __init__(self, *, hidden, intermediate, num_layers, num_heads,
                 num_kv_heads, head_dim, max_cache, prompt_len,
                 rope_theta=1e6, qk_norm=False, rms_eps=1e-6,
                 embed=None, lm_head=None, weights=None,
                 backend="kernel", dtype=None, prefill_chunk=None,
                 device=None, fuse_elementwise=False,
                 fuse_kv_append=False):
        if backend not in ("kernel", "graph"):
            raise ValueError(f"backend {backend!r}: choose 'kernel' (the "
                             f"CUDA megakernel) or 'graph' (the golden "
                             f"executor)")
        self.device = indexed(runtime.resolve_device(device))
        if embed.device != self.device:
            raise ValueError(f"the weights lie on {embed.device}, the "
                             f"decoder runs on {self.device}")
        self.cfg = dict(hidden=hidden, intermediate=intermediate,
                        num_layers=num_layers, num_heads=num_heads,
                        num_kv_heads=num_kv_heads, head_dim=head_dim,
                        max_cache=max_cache, rope_theta=rope_theta,
                        qk_norm=qk_norm)
        self.rms_eps = rms_eps
        self.backend = backend
        self.fuse_elementwise = bool(fuse_elementwise)
        self.fuse_kv_append = bool(fuse_kv_append)
        self.dtype = embed.dtype if dtype is None else \
            runtime.resolve_dtype(dtype)
        self.embed = embed
        self.lm_head = lm_head
        self.weights = dict(weights)
        self.prompt_len = prompt_len
        # prefill in chunks of C rows; the padded prompt's K/V rows
        # [0, nc*C) must fit the cache
        C = min(prompt_len, prefill_chunk if prefill_chunk is not None
                else 256)
        nc = -(-prompt_len // C)
        if nc * C > max_cache:
            raise ValueError(
                f"padded prompt rows {nc}*{C}={nc * C} exceed "
                f"max_cache={max_cache}; shrink prefill_chunk or grow "
                f"max_cache")
        self.prefill_chunk, self._n_prefill_chunks = C, nc

        def build(seq_len, **fuse):
            mb = build_qwen3_decode(
                seq_len=seq_len, hidden=hidden, intermediate=intermediate,
                num_layers=num_layers, num_heads=num_heads,
                num_kv_heads=num_kv_heads, head_dim=head_dim,
                max_cache=max_cache, rope_theta=rope_theta,
                qk_norm=qk_norm, rms_eps=rms_eps, kv_append=True,
                dtype=self.dtype)
            if backend == "graph":
                # expose the new cache values so the loop can thread them
                for nd in mb.graph.nodes:
                    if nd.op == "kv_append":
                        mb.graph.outputs.append(nd.out)
                return mb, mb.compile(backend="graph")
            return mb, mb.compile(backend="kernel", device=self.device,
                                  **fuse)

        # the fusion options shape the decode program alone: a prefill
        # chunk has more rows than the skinny LINEAR that carries them
        self._mb_prefill, self._prog_prefill = build(C)
        self._mb_decode, self._prog_decode = build(
            1, fuse_elementwise=self.fuse_elementwise,
            fuse_kv_append=self.fuse_kv_append)
        self._cache_names = list(self._mb_decode.graph.caches)
        if backend == "kernel":
            # one weight set and one cache set serve both programs
            for prog in (self._prog_prefill, self._prog_decode):
                prog.bind_weights(self.weights)
            caches = self._prog_prefill.bind_caches()
            self._prog_decode.bind_caches(caches)
            assert all(self._prog_prefill.caches[n] is
                       self._prog_decode.caches[n] for n in caches)
            assert all(self._prog_prefill.weights[n] is
                       self._prog_decode.weights[n] for n in self.weights)

    # ------------------------------------------------------------------
    @classmethod
    def from_dense(cls, model, params, *, max_cache, prompt_len,
                   backend="kernel", prefill_chunk=None, device=None,
                   fuse_elementwise=False, fuse_kv_append=False):
        """A decoder over a single-rank DenseLLM's parameters
        (dense_weight_map: views, nothing copied). The fusion options
        fold the decode program's elementwise tasks and cache appends
        into their neighbours (ExecutorCuda); the kernel backend alone
        reads them, as the JAX decoder's Pallas backend alone does."""
        c = model.config
        weights, embed, lm_head = dense_weight_map(model, params)
        return cls(hidden=c.hidden_size, intermediate=c.intermediate_size,
                   num_layers=c.num_layers, num_heads=c.num_heads,
                   num_kv_heads=c.num_kv_heads, head_dim=c.head_dim,
                   max_cache=max_cache, prompt_len=prompt_len,
                   rope_theta=c.rope_theta, qk_norm=c.qk_norm,
                   rms_eps=c.rms_norm_eps, embed=embed, lm_head=lm_head,
                   weights=weights, backend=backend,
                   prefill_chunk=prefill_chunk, device=device,
                   fuse_elementwise=fuse_elementwise,
                   fuse_kv_append=fuse_kv_append)

    # ------------------------------------------------------------------
    def _pick(self, hidden_row, generator, temperature, *, sampling, top_k):
        """Next token (1,) int32 from one hidden row: greedy argmax, or
        top-k temperature sampling by the Gumbel-max trick with noise
        from `generator` (models.dense.sample_token, the Engine's
        form)."""
        x = hidden_row.reshape(1, -1)
        if not sampling:
            return greedy_token(x, self.lm_head)
        return sample_token(x, self.lm_head, generator,
                            temperature=temperature, top_k=top_k)

    def _trunk(self, prog, x, cache_len, caches):
        """One run of a program: (hidden rows, caches)."""
        if self.backend == "kernel":
            return prog.step({"x": x}, cache_len)[0], caches
        outs = prog.run({"x": x, **caches}, self.weights,
                        {"cache_len": cache_len})
        return outs[0], dict(zip(self._cache_names_of(prog), outs[1:]))

    def _cache_names_of(self, prog):
        g = prog.graph
        names = {h.idx: n for n, h in g.caches.items()}
        return [names[nd.inputs[1].idx] for nd in g.nodes
                if nd.op == "kv_append"]

    def _check_prompt(self, prompt_ids, gen_len):
        if gen_len < 1:
            raise ValueError(f"gen_len must be >= 1, got {gen_len}")
        ids = torch.as_tensor(np.asarray(prompt_ids), dtype=torch.int32,
                              device=self.device).reshape(-1)
        if ids.shape[0] != self.prompt_len:
            raise ValueError(f"prompt of {ids.shape[0]} tokens; this "
                             f"decoder was built for {self.prompt_len}")
        if self.prompt_len + gen_len > self.cfg["max_cache"]:
            raise ValueError("kv_append writes every step's K/V; need "
                             "prompt + gen <= max_cache")
        return ids

    def _prefill(self, ids):
        """Run the chunk program over the (padded) prompt. Returns (the
        final hidden row of position P-1, caches)."""
        c = self.cfg
        caches = None
        if self.backend == "graph":
            caches = {n: torch.zeros((c["max_cache"], c["num_kv_heads"]
                                      * c["head_dim"]), dtype=self.dtype,
                                     device=self.device)
                      for n in self._cache_names}
        P, C, nc = self.prompt_len, self.prefill_chunk, \
            self._n_prefill_chunks
        x0 = F.embedding(ids, self.embed)
        if nc * C != P:
            # pad rows append K/V at positions [P, nc*C): a decode step at
            # position p attends only [0, p) and overwrites row p first,
            # so they are never read
            x0 = torch.cat([x0, x0.new_zeros((nc * C - P, x0.shape[1]))])
        for i in range(nc):
            hs, caches = self._trunk(self._prog_prefill,
                                     x0[i * C:(i + 1) * C], i * C, caches)
        return hs[(P - 1) % C], caches

    def _decode_hidden(self, tok, pos, caches):
        """One decode launch for token `tok` ((1,) int32 on the device)
        at position `pos`: (final hidden row (1, hidden), caches)."""
        return self._trunk(self._prog_decode, F.embedding(tok, self.embed),
                           pos, caches)

    def _finish(self, toks):
        out = torch.cat(toks).cpu().numpy().astype(np.int32)
        if self.backend == "kernel":
            self._prog_prefill.check_fault()
            self._prog_decode.check_fault()
        return out

    def serve(self, prompt_ids, gen_len: int, *,
              temperature: float = 0.0, top_k: int = 50, seed: int = 0):
        """Generation (Engine-parity surface): temperature 0 = greedy;
        > 0 = top-k temperature sampling from a torch.Generator on the
        decoder's device seeded with `seed`. prompt_ids: (prompt_len,)
        ints. Returns (gen_len,) int32 generated ids (prompt
        excluded)."""
        ids = self._check_prompt(prompt_ids, gen_len)
        sampling = temperature > 0.0
        if sampling and top_k < 1:
            raise ValueError(f"top_k must be >= 1 when sampling, got "
                             f"{top_k}")
        temp = max(temperature, 1e-6)
        gen = None
        if sampling:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
        pick = dict(sampling=sampling, top_k=top_k)
        h, caches = self._prefill(ids)
        tok = self._pick(h, gen, temp, **pick)
        toks = [tok]
        for i in range(gen_len - 1):
            h, caches = self._decode_hidden(tok, self.prompt_len + i, caches)
            tok = self._pick(h, gen, temp, **pick)
            toks.append(tok)
        return self._finish(toks)

    def teacher_forced(self, prompt_ids, tokens):
        """The final hidden rows of a generation that is fed `tokens`
        instead of its own picks: (len(tokens) + 1, hidden) f32, row 0
        from the prefill, row i + 1 after token i."""
        ids = self._check_prompt(prompt_ids, len(tokens))
        h, caches = self._prefill(ids)
        rows = [h.reshape(1, -1).float().clone()]
        forced = torch.as_tensor(np.asarray(tokens), dtype=torch.int32,
                                 device=self.device)
        for i in range(len(tokens)):
            h, caches = self._decode_hidden(forced[i:i + 1],
                                            self.prompt_len + i, caches)
            rows.append(h.reshape(1, -1).float().clone())
        out = torch.cat(rows)
        self._finish([forced[:0]])
        return out
