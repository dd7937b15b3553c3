"""The golden graph executor: the captured graph node by node in torch
(counterpart of triton_distributed_tpu/megakernel/executor_xla.py).

It keeps the JAX executor's rounding points — every node's output is
cast to the graph dtype; `linear` accumulates in f32; `rms_norm`,
`silu_mul` and `head_rms` compute in f32 — and its attention form: RoPE
at positions cache_len + i, a partial over the cache prefix
[0, cache_len), a causal partial over the current rows, and
`merge_two_partials`. The attention partials go through the port's
`flash_attention_partial` (the prefill kernel on a CUDA tensor, its
plain version on a CPU one). It is the reference the megakernel
(executor_cuda.py) is held to; it is not on MegaDecoder's kernel path.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.attention import (apply_rope, flash_attention,
                             flash_attention_partial, merge_two_partials,
                             rope_cos_sin)
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


_LATER = {"attention_paged": ("3b", " (paged serving: MegaServe)"),
          "kv_append_paged": ("3b", " (paged serving: MegaServe)"),
          "moe_ffn": ("3c", " (the megakernel's MoE program)"),
          "all_to_all": ("6", " (the multi-rank layer)"),
          "all_reduce": ("6", " (the multi-rank layer)")}


def check_ops(graph):
    for n in graph.nodes:
        if n.op in _LATER:
            raise later_slice(f"op {n.op!r}", *_LATER[n.op])


class ExecutorTorch:

    def __init__(self, builder):
        self.builder = builder
        self.graph = builder.graph
        check_ops(self.graph)
        self.dtype = builder.dtype
        self._scalar_names = {n.attrs["cache_len_name"]
                              for n in self.graph.nodes
                              if n.op in ("attention_kv", "kv_append")}

    def _eval_graph(self, env_inputs, env_weights, scalars):
        g = self.graph
        eps_h = self.builder.rms_eps
        env = {}
        for node in g.nodes:
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
            else:  # pragma: no cover - check_ops refused it
                raise NotImplementedError(node.op)
        return tuple(env[o.idx] for o in g.outputs)

    def run(self, inputs: dict, weights: dict, scalars: dict | None = None):
        """Evaluate the graph. `inputs` carries activations and cache
        values (tensors or arrays); `scalars` the run-time cache
        lengths. Returns the graph outputs as torch tensors (a
        `kv_append` output is a new cache tensor: the inputs are not
        changed). Tensors land on the device of `inputs["x"]` when it is
        a tensor, else on the CPU."""
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
        x0 = next(iter(inputs.values()))
        dev = x0.device if isinstance(x0, torch.Tensor) else \
            torch.device("cpu")
        ins = {k: as_tensor(v, self.dtype, dev) for k, v in inputs.items()}
        ws = {k: as_tensor(v, self.dtype, dev) for k, v in weights.items()}
        return self._eval_graph(ins, ws, scalars)

    def run_sharded(self, *args, **kwargs):
        raise later_slice("run_sharded", "6", " (the multi-rank layer)")
