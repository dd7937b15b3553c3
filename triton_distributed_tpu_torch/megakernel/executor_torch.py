"""The golden graph executor: the captured graph node by node in torch
(counterpart of triton_distributed_tpu/megakernel/executor_xla.py).

It keeps the JAX executor's rounding points — every node's output is
cast to the graph dtype; `linear` accumulates in f32; `rms_norm`,
`silu_mul` and `head_rms` compute in f32 — and its attention form: RoPE
at positions cache_len + i, a partial over the cache prefix
[0, cache_len), a causal partial over the current rows, and
`merge_two_partials`; the paged ops do the same per slot, over the
slot's pages gathered through the block table at its own length, for
the slot's live rows (one, or a verify step's candidates, causally),
and leave the pad rows of each slot's tile exactly 0. `moe_ffn` routes every
row, pad rows and idle slots included, as the JAX executor does (a zero
row's expert output is exactly 0 under any routing). The attention
partials go through the port's
`flash_attention_partial` (the prefill kernel on a CUDA tensor, its
plain version on a CPU one). An n-rank graph (with `all_reduce`
nodes) runs through `run_sharded`: every rank's operands node by node,
the all_reduce as `RankGroup.psum` (the n partials summed in rank order
in f32, rounded once; JAX `lax.psum` in executor_xla.py:276). It is the
reference the megakernel (executor_cuda.py) is held to; it is not on
MegaDecoder's kernel path.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.attention import (apply_rope, flash_attention,
                             flash_attention_partial, merge_two_partials,
                             rope_cos_sin)
from ..ops.moe_utils import route_topk
from ..parallel.mesh import RankGroup
from .builder import later_slice


def head_rms(x, w, eps):
    """Per-head q/k RMSNorm (f32 math, cast back to x's dtype)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def matmul_f32(x, w):
    """x @ w accumulated in f32 (JAX: preferred_element_type=f32),
    returned in f32."""
    if x.device.type == "cuda" and x.dtype != torch.float32:
        return torch.mm(x, w, out_dtype=torch.float32)
    return x.float() @ w.float()


def as_tensor(v, dtype, device):
    """A torch tensor of `dtype` on `device` from a tensor or a float
    array (a bf16 array from JAX goes through f32, which is exact)."""
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
    return v.to(device=device, dtype=dtype)


_LATER = {"all_to_all": ("6", " (the TASK_A2A body, ROADMAP Queue B 18: "
                               "off every model path)")}


def check_ops(graph):
    for n in graph.nodes:
        if n.op in _LATER:
            raise later_slice(f"op {n.op!r}", *_LATER[n.op])


PAGED_OPS = ("attention_paged", "kv_append_paged")


class PagedGeometry(NamedTuple):
    b_slots: int
    slot_rows: int
    block: int
    max_pages: int
    cache_len_name: str


def has_all_reduce(graph) -> bool:
    """Whether the graph is an n-rank program (has all_reduce nodes)."""
    return any(n.op == "all_reduce" for n in graph.nodes)


def paged_geometry(graph):
    """The PagedGeometry shared by every paged node of a graph, or None
    for a graph without one. A program keeps one cache_len or the
    per-slot vector, never both."""
    geo = {PagedGeometry(n.inputs[0].rows // n.attrs["slot_rows"],
                         n.attrs["slot_rows"], n.attrs["block"],
                         n.attrs["max_pages"], n.attrs["cache_len_name"])
           for n in graph.nodes if n.op in PAGED_OPS}
    if not geo:
        return None
    if len(geo) > 1:
        raise ValueError(f"the paged nodes of one program must share "
                         f"(b_slots, slot_rows, block, max_pages, "
                         f"cache_len_name), got {sorted(geo)}")
    if any(n.op in ("attention_kv", "kv_append") for n in graph.nodes):
        raise ValueError("a program takes one cache_len or the per-slot "
                         "lengths of paged serving, not both")
    return geo.pop()


def slot_lengths(geo, scalars: dict) -> np.ndarray:
    """The per-slot lengths of a paged program from its run-time scalars
    `{cache_len_name}{b}` (0 where one is absent)."""
    return np.asarray([int(scalars.get(f"{geo.cache_len_name}{b}", 0))
                       for b in range(geo.b_slots)], np.int32)


def identity_table(geo) -> np.ndarray:
    """The default block table: slot b owns pages [b*max_pages,
    (b+1)*max_pages) (the JAX executors' default)."""
    return np.arange(geo.b_slots * geo.max_pages, dtype=np.int32).reshape(
        geo.b_slots, geo.max_pages)


class ExecutorTorch:

    def __init__(self, builder):
        self.builder = builder
        self.graph = builder.graph
        check_ops(self.graph)
        self.dtype = builder.dtype
        self._scalar_names = {n.attrs["cache_len_name"]
                              for n in self.graph.nodes
                              if n.op in ("attention_kv", "kv_append")}
        self.paged = paged_geometry(self.graph)
        if self.paged is not None:
            self._scalar_names |= {f"{self.paged.cache_len_name}{b}"
                                   for b in range(self.paged.b_slots)}

    def _eval_graph(self, envs_inputs, envs_weights, scalars, btab=None,
                    widths=None):
        """Evaluate the graph over a list of per-rank (inputs, weights)
        (one entry for a one-rank graph); an all_reduce node sums the
        ranks' values. Returns rank 0's outputs."""
        n = len(envs_inputs)
        envs = [{} for _ in range(n)]
        for node in self.graph.nodes:
            if node.op == "all_reduce":
                s = RankGroup(n).psum(torch.stack(
                    [e[node.inputs[0].idx] for e in envs]))
                for e in envs:
                    e[node.out.idx] = s
                continue
            for e, ins, ws in zip(envs, envs_inputs, envs_weights):
                self._eval_node(node, e, ins, ws, scalars, btab, widths)
        return tuple(envs[0][o.idx] for o in self.graph.outputs)

    def _eval_node(self, node, env, env_inputs, env_weights, scalars, btab,
                   widths):
        eps_h = self.builder.rms_eps
        at = node.attrs
        dt = node.out.dtype
        if node.op == "input":
            env[node.out.idx] = env_inputs[at["name"]]
        elif node.op == "weight":
            env[node.out.idx] = env_weights[at["name"]]
        elif node.op == "linear":
            x, w = (env[i.idx] for i in node.inputs)
            env[node.out.idx] = matmul_f32(x, w).to(dt)
        elif node.op == "rms_norm":
            x, w = (env[i.idx] for i in node.inputs)
            xf = x.float()
            var = (xf * xf).mean(dim=-1, keepdim=True)
            env[node.out.idx] = (xf * torch.rsqrt(var + at["eps"])
                                 * w.float()[0]).to(dt)
        elif node.op == "silu_mul":
            a, b = (env[i.idx] for i in node.inputs)
            af = a.float()
            env[node.out.idx] = (af * torch.sigmoid(af)
                                 * b.float()).to(dt)
        elif node.op == "add":
            a, b = (env[i.idx] for i in node.inputs)
            env[node.out.idx] = a + b
        elif node.op == "attention":
            (qkv,) = (env[i.idx] for i in node.inputs)
            h, hkv, d = at["num_heads"], at["num_kv_heads"], at["head_dim"]
            s = qkv.shape[0]
            q = qkv[:, :h * d].reshape(1, s, h, d)
            k = qkv[:, h * d:(h + hkv) * d].reshape(1, s, hkv, d)
            v = qkv[:, (h + hkv) * d:].reshape(1, s, hkv, d)
            cos, sin = rope_cos_sin(torch.arange(s, device=qkv.device),
                                    d, at["rope_theta"])
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
            o = flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=at["causal"])
            env[node.out.idx] = o.reshape(s, h * d).to(dt)
        elif node.op == "attention_kv":
            qkv, kc, vc = (env[i.idx] for i in node.inputs[:3])
            h, hkv, d = at["num_heads"], at["num_kv_heads"], at["head_dim"]
            s = qkv.shape[0]
            maxc = kc.shape[0]
            cache_len = int(scalars.get(at["cache_len_name"], 0))
            q = qkv[:, :h * d].reshape(1, s, h, d)
            k = qkv[:, h * d:(h + hkv) * d].reshape(1, s, hkv, d)
            v = qkv[:, (h + hkv) * d:].reshape(1, s, hkv, d)
            if at.get("qk_norm", False):
                qn = env[node.inputs[3].idx].float()[0]
                kn = env[node.inputs[4].idx].float()[0]
                q = head_rms(q, qn, eps_h)
                k = head_rms(k, kn, eps_h)
            pos = cache_len + torch.arange(s, device=qkv.device)
            cos, sin = rope_cos_sin(pos, d, at["rope_theta"])
            q = apply_rope(q, cos, sin).contiguous()
            k = apply_rope(k, cos, sin).contiguous()
            # cache prefix (already roped, fully visible up to
            # cache_len) + causal current rows, merged by lse
            o1, l1 = flash_attention_partial(
                q, kc.reshape(1, maxc, hkv, d),
                vc.reshape(1, maxc, hkv, d), q_offset=0, kv_offset=0,
                kv_valid=cache_len, causal=False)
            o2, l2 = flash_attention_partial(
                q, k, v.contiguous(), q_offset=0, kv_offset=0,
                causal=True)
            o, _ = merge_two_partials(o1, l1, o2, l2)
            env[node.out.idx] = o.reshape(s, h * d).to(dt)
        elif node.op == "kv_append":
            h, hkv, d = at["num_heads"], at["num_kv_heads"], at["head_dim"]
            qkv, cache = (env[i.idx] for i in node.inputs[:2])
            s = qkv.shape[0]
            cache_len = int(scalars.get(at["cache_len_name"], 0))
            if at["part"] == "k":
                rows = qkv[:, h * d:(h + hkv) * d].reshape(s, hkv, d)
                if at.get("qk_norm", False):
                    kn = env[node.inputs[2].idx].float()[0]
                    rows = head_rms(rows, kn, eps_h)
                pos = cache_len + torch.arange(s, device=qkv.device)
                cos, sin = rope_cos_sin(pos, d, at["rope_theta"])
                rows = apply_rope(rows[None], cos, sin)[0]
            else:
                rows = qkv[:, (h + hkv) * d:].reshape(s, hkv, d)
            new = cache.clone()
            new[cache_len:cache_len + s] = rows.reshape(
                s, hkv * d).to(cache.dtype)
            env[node.out.idx] = new
        elif node.op == "attention_paged":
            qkv, kc, vc = (env[i.idx] for i in node.inputs[:3])
            h, hkv, d = at["num_heads"], at["num_kv_heads"], at["head_dim"]
            R, blk, mp = at["slot_rows"], at["block"], at["max_pages"]
            out = torch.zeros((qkv.shape[0], h * d), dtype=torch.float32,
                              device=qkv.device)
            lens = slot_lengths(self.paged, scalars)
            for b, cl in enumerate(lens.tolist()):
                w = int(widths[b])
                row = qkv[b * R:b * R + w]     # the slot's candidates
                q = row[:, :h * d].reshape(1, w, h, d)
                k = row[:, h * d:(h + hkv) * d].reshape(1, w, hkv, d)
                v = row[:, (h + hkv) * d:].reshape(1, w, hkv, d)
                if at.get("qk_norm", False):
                    q = head_rms(q, env[node.inputs[3].idx].float()[0],
                                 eps_h)
                    k = head_rms(k, env[node.inputs[4].idx].float()[0],
                                 eps_h)
                cos, sin = rope_cos_sin(
                    cl + torch.arange(w, device=qkv.device), d,
                    at["rope_theta"])
                q = apply_rope(q, cos, sin).contiguous()
                k = apply_rope(k, cos, sin).contiguous()
                # the slot's pages gathered into a contiguous view
                # (unassigned -1 entries clamp to page 0, as in JAX)
                pages = torch.from_numpy(
                    np.clip(btab[b, :mp], 0, None).astype(np.int64))
                idx = (pages[:, None] * blk
                       + torch.arange(blk)[None, :]).reshape(-1)
                idx = idx.to(qkv.device)
                kg = kc[idx].reshape(1, mp * blk, hkv, d)
                vg = vc[idx].reshape(1, mp * blk, hkv, d)
                o1, l1 = flash_attention_partial(
                    q, kg, vg, q_offset=0, kv_offset=0, kv_valid=cl,
                    causal=False)
                o2, l2 = flash_attention_partial(
                    q, k, v.contiguous(), q_offset=0, kv_offset=0,
                    causal=True)
                o, _ = merge_two_partials(o1, l1, o2, l2)
                out[b * R:b * R + w] = o.reshape(w, h * d).float()
            env[node.out.idx] = out.to(dt)
        elif node.op == "kv_append_paged":
            h, hkv, d = at["num_heads"], at["num_kv_heads"], at["head_dim"]
            R, blk = at["slot_rows"], at["block"]
            qkv, cache = (env[i.idx] for i in node.inputs[:2])
            new = cache.clone()
            lens = slot_lengths(self.paged, scalars)
            for b, cl in enumerate(lens.tolist()):
                w = int(widths[b])
                row = qkv[b * R:b * R + w]
                if at["part"] == "k":
                    rows = row[:, h * d:(h + hkv) * d].reshape(w, hkv, d)
                    if at.get("qk_norm", False):
                        kn = env[node.inputs[2].idx].float()[0]
                        rows = head_rms(rows, kn, eps_h)
                    cos, sin = rope_cos_sin(
                        cl + torch.arange(w, device=qkv.device), d,
                        at["rope_theta"])
                    rows = apply_rope(rows[None], cos, sin)[0]
                else:
                    rows = row[:, (h + hkv) * d:].reshape(w, hkv, d)
                p = cl + np.arange(w)
                pos = np.maximum(btab[b, p // blk], 0) * blk + p % blk
                new[torch.from_numpy(pos.astype(np.int64)).to(
                    new.device)] = rows.reshape(w, hkv * d).to(new.dtype)
            env[node.out.idx] = new
        elif node.op == "moe_ffn":
            # JAX executor_xla's expert loop: f32 gate/up dots,
            # silu(g) * u * w_e rounded once to dt, the down
            # projection accumulated in f32 and rounded once. An
            # expert no row routes to adds w_e = 0 times finite
            # values, exactly +0, so only the routed experts run.
            x, logits, w_gu, w_dn = (env[i.idx] for i in node.inputs)
            E, inter = at["num_experts"], at["intermediate"]
            H = x.shape[1]
            rw, ex = route_topk(logits, at["top_k"],
                                renormalize=at.get("norm_topk", True))
            gu = w_gu.reshape(E, H, 2 * inter)
            dn = w_dn.reshape(E, inter, H)
            out = torch.zeros((x.shape[0], H), dtype=torch.float32,
                              device=x.device)
            for e in torch.unique(ex).tolist():
                w_e = (rw * (ex == e)).sum(dim=-1, keepdim=True)
                h2 = matmul_f32(x, gu[e])
                gate, up = h2[:, :inter], h2[:, inter:]
                act = (gate * torch.sigmoid(gate) * up * w_e).to(dt)
                out = out + matmul_f32(act, dn[e])
            env[node.out.idx] = out.to(dt)
        else:  # pragma: no cover - check_ops refused it
            raise NotImplementedError(node.op)

    def run(self, inputs: dict, weights: dict, scalars: dict | None = None,
            block_table=None, widths=None):
        """Evaluate the graph. `inputs` carries activations and cache
        values (tensors or arrays); `scalars` the run-time cache
        lengths (`cache_len`, or a paged program's per-slot
        `{cache_len_name}{b}`); `block_table` a paged program's
        (b_slots, max_pages) table (default: slot b owns pages
        [b*max_pages, (b+1)*max_pages)); `widths` a paged program's
        per-slot rows (b_slots,) in [1, slot_rows] (default one a slot:
        a slot of width w > 1 verifies w candidate rows at positions
        cache_len_b + i, causally, and appends all of them). Returns the
        graph outputs as
        torch tensors (a `kv_append` / `kv_append_paged` output is a new
        cache tensor: the inputs are not changed). Tensors land on the
        device of `inputs["x"]` when it is a tensor, else on the CPU.
        A graph with all_reduce nodes runs through `run_sharded`."""
        if has_all_reduce(self.graph):
            raise ValueError("this graph has all_reduce nodes: it runs "
                             "per-rank operands through run_sharded")
        return self._run(inputs, weights, scalars, block_table, widths, 0)

    def _run(self, inputs, weights, scalars, block_table, widths, ranks):
        """run() of operands stacked over `ranks` ranks (0: unstacked)."""
        scalars = dict(scalars or {})
        unknown = set(scalars) - self._scalar_names
        if unknown:
            raise ValueError(
                f"unknown scalars {sorted(unknown)}; this program "
                f"expects {sorted(self._scalar_names) or 'none'}")
        for n in self.graph.nodes:
            if n.op == "kv_append":
                cl = int(scalars.get(n.attrs["cache_len_name"], 0))
                if not 0 <= cl <= n.out.rows - n.inputs[0].rows:
                    raise ValueError(
                        f"cache_len {cl} + {n.inputs[0].rows} rows "
                        f"outside the cache's {n.out.rows} rows")
        btab = None
        if self.paged is not None:
            btab = identity_table(self.paged) if block_table is None \
                else np.asarray(torch.as_tensor(block_table).cpu(), np.int32)
            nb, _, blk, mp, _ = self.paged
            lens = slot_lengths(self.paged, scalars)
            if btab.shape != (nb, mp):
                raise ValueError(f"block_table {btab.shape}, the program "
                                 f"takes {(nb, mp)}")
            widths = (np.ones(nb, np.int64) if widths is None
                      else np.asarray(widths, np.int64).reshape(-1))
            if widths.shape != (nb,) or not (
                    (widths >= 1) & (widths <= self.paged.slot_rows)).all():
                raise ValueError(f"widths {widths.tolist()}: one per slot, "
                                 f"each in [1, {self.paged.slot_rows}]")
            if not ((lens >= 0) & (lens + widths <= mp * blk)).all():
                raise ValueError(f"per-slot lengths {lens.tolist()} with "
                                 f"widths {widths.tolist()} outside "
                                 f"[0, {mp * blk})")
        elif block_table is not None or widths is not None:
            raise ValueError("block_table / widths: this program has no "
                             "paged node")
        x0 = next(iter(inputs.values()))
        dev = x0.device if isinstance(x0, torch.Tensor) else \
            torch.device("cpu")
        ins = {k: as_tensor(v, self.dtype, dev) for k, v in inputs.items()}
        ws = {k: as_tensor(v, self.dtype, dev) for k, v in weights.items()}
        if not ranks:
            return self._eval_graph([ins], [ws], scalars, btab, widths)
        for k, v in {**ins, **ws}.items():
            if v.shape[0] != ranks:
                raise ValueError(f"{k}: shape {tuple(v.shape)}, not "
                                 f"rank-stacked over {ranks} ranks")
        return self._eval_graph([{k: v[r] for k, v in ins.items()}
                                 for r in range(ranks)],
                                [{k: v[r] for k, v in ws.items()}
                                 for r in range(ranks)],
                                scalars, btab, widths)

    def run_sharded(self, inputs: dict, weights: dict,
                    scalars: dict | None = None, block_table=None,
                    widths=None):
        """run() of per-rank operands (JAX ExecutorXLA.run_sharded): every
        input and weight carries a leading rank dimension of the builder's
        ranks (rank r's value at index r), all_reduce nodes sum the
        ranks' partials. Returns the outputs, which the all_reduce nodes
        leave alike on every rank, once (rank 0's)."""
        if not has_all_reduce(self.graph):
            raise ValueError("run_sharded requires all_reduce nodes (per-"
                             "rank partial-sum semantics); use run() "
                             "otherwise")
        return self._run(inputs, weights, scalars, block_table, widths,
                         self.builder.num_ranks)
