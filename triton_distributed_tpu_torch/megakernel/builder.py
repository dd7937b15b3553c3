"""ModelBuilder: the user-facing megakernel construction API
(counterpart of triton_distributed_tpu/megakernel/builder.py).

Analog of reference mega_triton_kernel/models/model_builder.py:86
`ModelBuilder` — `make_*` op methods building the graph, `compile()`
(:508) and `run()` (:547). The ops, their assertions and their attrs are
the JAX builder's, so one build gives the same graph node for node in
both packages. `compile()` picks the executor: "graph" (the torch golden
executor, the counterpart of JAX "xla") or "kernel" (the persistent CUDA
megakernel, the counterpart of JAX "pallas"; on a CPU device its plain
queue walk).

`mesh` is a `parallel.mesh.RankGroup`: a graph with `all_reduce` nodes
is then an n-rank program, which runs every rank's operands (a leading
rank dimension on each) in one launch. Ops of later slices
(`all_to_all`, `verify`) raise NotImplementedError naming the slice.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import RankGroup
from .graph import Graph, TensorHandle


def later_slice(what: str, slice_: str, detail: str = "") -> NotImplementedError:
    return NotImplementedError(
        f"{what}: the PyTorch port's megakernel does not run this yet; it "
        f"comes with ROADMAP.md Queue A, slice {slice_}{detail}")


class ModelBuilder:

    def __init__(self, *, mesh: RankGroup | None = None, axis: str = "tp",
                 dtype=torch.float32, rms_eps: float = 1e-6):
        if mesh is not None and not isinstance(mesh, RankGroup):
            raise TypeError(f"mesh: the port's ranks are a "
                            f"parallel.mesh.RankGroup, got "
                            f"{type(mesh).__name__}")
        self.graph = Graph()
        self.mesh = mesh
        self.axis = axis
        self.dtype = dtype
        self.rms_eps = rms_eps

    # -- tensor declaration ------------------------------------------------
    def input(self, name: str, shape) -> TensorHandle:
        h = self.graph.add_node("input", (), tuple(shape), self.dtype,
                                name=name)
        self.graph.inputs[name] = h
        return h

    def weight(self, name: str, shape) -> TensorHandle:
        h = self.graph.add_node("weight", (), tuple(shape), self.dtype,
                                name=name)
        self.graph.weights[name] = h
        return h

    def cache(self, name: str, shape) -> TensorHandle:
        """A KV-cache tensor: an input that the kernel executor keeps in
        a persistent device buffer and `kv_append` nodes update in
        place."""
        h = self.input(name, shape)
        self.graph.caches[name] = h
        return h

    # -- ops (reference make_* APIs) ---------------------------------------
    def linear(self, x: TensorHandle, w: TensorHandle) -> TensorHandle:
        """(m, k) @ (k, n) -> (m, n). Reference make_linear."""
        assert x.cols == w.rows, (x.shape, w.shape)
        return self.graph.add_node("linear", (x, w), (x.rows, w.cols),
                                   self.dtype)

    def rms_norm(self, x: TensorHandle, w: TensorHandle) -> TensorHandle:
        """Row-wise RMSNorm with a (1, cols) weight. Reference make_norm."""
        assert w.shape == (1, x.cols), (x.shape, w.shape)
        return self.graph.add_node("rms_norm", (x, w), x.shape, self.dtype,
                                   eps=self.rms_eps)

    def silu_mul(self, a: TensorHandle, b: TensorHandle) -> TensorHandle:
        """silu(a) * b. Reference make_activation (SwiGLU form)."""
        assert a.shape == b.shape
        return self.graph.add_node("silu_mul", (a, b), a.shape, self.dtype)

    def add(self, a: TensorHandle, b: TensorHandle) -> TensorHandle:
        assert a.shape == b.shape
        return self.graph.add_node("add", (a, b), a.shape, self.dtype)

    def attention(self, qkv: TensorHandle, *, num_heads: int,
                  num_kv_heads: int, head_dim: int,
                  rope_theta: float = 1e6,
                  causal: bool = True) -> TensorHandle:
        """Fused-qkv self-attention with rope at positions 0..S-1:
        (S, (H+2Hkv)*D) -> (S, H*D). In the kernel this is the ATTN body
        with an empty cache."""
        d = head_dim
        assert qkv.cols == (num_heads + 2 * num_kv_heads) * d, qkv.shape
        return self.graph.add_node(
            "attention", (qkv,), (qkv.rows, num_heads * d), self.dtype,
            num_heads=num_heads, num_kv_heads=num_kv_heads,
            head_dim=d, rope_theta=rope_theta, causal=causal)

    def attention_kv(self, qkv: TensorHandle, k_cache: TensorHandle,
                     v_cache: TensorHandle, *, num_heads: int,
                     num_kv_heads: int, head_dim: int,
                     rope_theta: float = 1e6,
                     q_norm: TensorHandle | None = None,
                     k_norm: TensorHandle | None = None,
                     cache_len_name: str = "cache_len") -> TensorHandle:
        """Decode-step attention against a KV-cache prefix: the S current
        rows of `qkv` (packed q|k|v) attend to the caches' first
        `cache_len` rows (fully visible, already roped) plus the current
        rows (causal among themselves, positions cache_len..cache_len+S-1).
        RoPE (and, with `q_norm`/`k_norm`, Qwen3's per-head RMSNorm
        before it) applies to q and the current k. `cache_len` is a
        run-time scalar (`run(..., scalars={cache_len_name: t})`). The
        step does not append its k/v: `kv_append` does."""
        d = head_dim
        assert qkv.cols == (num_heads + 2 * num_kv_heads) * d, qkv.shape
        assert k_cache.shape == v_cache.shape, (k_cache.shape,
                                                v_cache.shape)
        assert k_cache.cols == num_kv_heads * d, k_cache.shape
        assert (q_norm is None) == (k_norm is None), "need both norms"
        inputs = (qkv, k_cache, v_cache)
        if q_norm is not None:
            assert q_norm.shape == (1, d) and k_norm.shape == (1, d)
            inputs = inputs + (q_norm, k_norm)
        return self.graph.add_node(
            "attention_kv", inputs,
            (qkv.rows, num_heads * d), self.dtype,
            num_heads=num_heads, num_kv_heads=num_kv_heads, head_dim=d,
            rope_theta=rope_theta, causal=True,
            qk_norm=q_norm is not None,
            cache_len_name=cache_len_name)

    def kv_append(self, qkv: TensorHandle, k_cache: TensorHandle,
                  v_cache: TensorHandle, *, num_heads: int,
                  num_kv_heads: int, head_dim: int,
                  rope_theta: float = 1e6,
                  k_norm: TensorHandle | None = None,
                  cache_len_name: str = "cache_len"):
        """Append the current rows' K/V into the caches at rows
        [cache_len, cache_len + S): K rows k_norm-ed (if given) and roped
        at positions cache_len + i, V rows as they are. Returns the two
        updated cache handles (the golden executor's new cache values;
        the kernel executor updates its cache buffers in place)."""
        d = head_dim
        assert qkv.cols == (num_heads + 2 * num_kv_heads) * d, qkv.shape
        assert k_cache.shape == v_cache.shape
        assert k_cache.cols == num_kv_heads * d, k_cache.shape
        common = dict(num_heads=num_heads, num_kv_heads=num_kv_heads,
                      head_dim=d, rope_theta=rope_theta,
                      cache_len_name=cache_len_name)
        k_in = (qkv, k_cache) + ((k_norm,) if k_norm is not None else ())
        k_new = self.graph.add_node(
            "kv_append", k_in, k_cache.shape, self.dtype, part="k",
            qk_norm=k_norm is not None, **common)
        v_new = self.graph.add_node(
            "kv_append", (qkv, v_cache), v_cache.shape, self.dtype,
            part="v", qk_norm=False, **common)
        return k_new, v_new

    def attention_paged(self, qkv: TensorHandle, k_pool: TensorHandle,
                        v_pool: TensorHandle, *, num_heads: int,
                        num_kv_heads: int, head_dim: int, block: int,
                        max_pages: int, slot_rows: int,
                        rope_theta: float = 1e6,
                        q_norm: TensorHandle | None = None,
                        k_norm: TensorHandle | None = None,
                        cache_len_name: str = "cache_len_s"):
        """Batched-serving decode attention over a PAGED KV pool. The
        trunk's rows split into `slot_rows`-row tiles, one slot per
        tile: row 0 of tile b is slot b's current token, the rest are
        zero pad (their output rows are exactly 0). Each slot attends
        its own cache prefix [0, cache_len_b), pages resolved through
        the block table, plus its own current row at position
        cache_len_b. The per-slot lengths are the run-time scalars
        `{cache_len_name}{slot}` and the (b_slots, max_pages) block
        table run-time data, so admission, eviction and length changes
        never rebuild the program. `k_pool` / `v_pool` are cache tensors
        of (pool_pages * block, Hkv*D): page p holds rows
        [p*block, (p+1)*block)."""
        d = head_dim
        assert qkv.cols == (num_heads + 2 * num_kv_heads) * d, qkv.shape
        assert qkv.rows % slot_rows == 0, (qkv.shape, slot_rows)
        assert k_pool.shape == v_pool.shape
        assert k_pool.cols == num_kv_heads * d, k_pool.shape
        assert k_pool.rows % block == 0, (k_pool.shape, block)
        assert (q_norm is None) == (k_norm is None), "need both norms"
        inputs = (qkv, k_pool, v_pool)
        if q_norm is not None:
            assert q_norm.shape == (1, d) and k_norm.shape == (1, d)
            inputs = inputs + (q_norm, k_norm)
        return self.graph.add_node(
            "attention_paged", inputs,
            (qkv.rows, num_heads * d), self.dtype,
            num_heads=num_heads, num_kv_heads=num_kv_heads, head_dim=d,
            rope_theta=rope_theta, block=block, max_pages=max_pages,
            slot_rows=slot_rows, qk_norm=q_norm is not None,
            cache_len_name=cache_len_name)

    def kv_append_paged(self, qkv: TensorHandle, k_pool: TensorHandle,
                        v_pool: TensorHandle, *, num_heads: int,
                        num_kv_heads: int, head_dim: int, block: int,
                        max_pages: int, slot_rows: int,
                        rope_theta: float = 1e6,
                        k_norm: TensorHandle | None = None,
                        cache_len_name: str = "cache_len_s"):
        """Per-slot cache append through the block table: slot b's
        current K row (k_norm-ed if given, roped at position
        cache_len_b) and raw V row land at page
        block_table[b, cache_len_b // block], in-page row
        cache_len_b % block. Returns the updated pool handles."""
        d = head_dim
        assert qkv.cols == (num_heads + 2 * num_kv_heads) * d, qkv.shape
        assert k_pool.shape == v_pool.shape
        assert k_pool.cols == num_kv_heads * d, k_pool.shape
        common = dict(num_heads=num_heads, num_kv_heads=num_kv_heads,
                      head_dim=d, rope_theta=rope_theta, block=block,
                      max_pages=max_pages, slot_rows=slot_rows,
                      cache_len_name=cache_len_name)
        k_in = (qkv, k_pool) + ((k_norm,) if k_norm is not None else ())
        k_new = self.graph.add_node(
            "kv_append_paged", k_in, k_pool.shape, self.dtype, part="k",
            qk_norm=k_norm is not None, **common)
        v_new = self.graph.add_node(
            "kv_append_paged", (qkv, v_pool), v_pool.shape, self.dtype,
            part="v", qk_norm=False, **common)
        return k_new, v_new

    def moe_ffn(self, x: TensorHandle, logits: TensorHandle,
                w_gate_up: TensorHandle, w_down: TensorHandle, *,
                num_experts: int, top_k: int,
                norm_topk: bool = True) -> TensorHandle:
        """MoE expert FFN over STACKED expert slabs: each row of `x`
        routes on its `logits` row (an f32 softmax over the experts,
        top-k with the first-max tie-break of `jax.lax.top_k`, optionally
        renormalised), then runs SwiGLU through the chosen experts'
        slabs of `w_gate_up` ((E*H, 2I): expert e owns rows
        [e*H, (e+1)*H), gate columns [:I], up columns [I:]) and
        `w_down` ((E*I, H)), combined by the routing weights. In the
        kernel this is the GROUPED_GEMM body, which reads only the slabs
        that some live row routes to."""
        H = x.cols
        assert logits.rows == x.rows, (logits.shape, x.shape)
        assert logits.cols == num_experts, (logits.shape, num_experts)
        assert w_gate_up.cols % 2 == 0, w_gate_up.shape
        inter = w_gate_up.cols // 2
        assert w_gate_up.rows == num_experts * H, \
            (w_gate_up.shape, num_experts, H)
        assert w_down.shape == (num_experts * inter, H), \
            (w_down.shape, num_experts, inter, H)
        assert 1 <= top_k <= num_experts, (top_k, num_experts)
        return self.graph.add_node(
            "moe_ffn", (x, logits, w_gate_up, w_down), x.shape,
            self.dtype, num_experts=num_experts, top_k=top_k,
            intermediate=inter, norm_topk=norm_topk)

    def all_reduce(self, x: TensorHandle) -> TensorHandle:
        """Cross-rank sum over the builder's ranks (reference
        tasks/allreduce.py): the AR task body in the kernel (each rank
        pushes its partial into its peers' landing blocks, then sums the
        n partials in rank order in f32), `RankGroup.psum` in the golden
        executor."""
        return self.graph.add_node("all_reduce", (x,), x.shape, self.dtype,
                                   axis=self.axis)

    @property
    def num_ranks(self) -> int:
        """The ranks an n-rank program of this graph runs (1 without a
        mesh)."""
        return 1 if self.mesh is None else self.mesh.n

    # -- ops of later slices -----------------------------------------------
    def all_to_all(self, *args, **kwargs):
        raise later_slice("ModelBuilder.all_to_all", "6",
                          " (the TASK_A2A body, ROADMAP Queue B 18: off every "
                          "model path)")

    def verify(self, **kwargs):
        raise later_slice("ModelBuilder.verify", "7",
                          " (tools and verification)")

    def output(self, h: TensorHandle) -> TensorHandle:
        self.graph.outputs.append(h)
        return h

    # -- compile -----------------------------------------------------------
    def compile(self, backend: str = "graph", *, device=None, **kwargs):
        """Returns a program with `.run(inputs, weights, scalars)`.

        backend "graph": the torch golden executor (executor_torch.py),
        node by node on the device of the tensors it is given. "kernel":
        the persistent CUDA megakernel (executor_cuda.py) on `device`
        (default: the GPU; on device="cpu" its plain queue walk).
        On device="cpu", "kernel" also takes `n_sm` (the number of
        queues the plain walk interleaves; default 132); on a GPU the
        queues are the card's SMs and `n_sm` is refused. "kernel" takes
        `fuse_elementwise` / `fuse_kv_append` (default False, as in
        JAX) for a decode-depth program: the fused program of
        ExecutorCuda._fusion_plan."""
        if backend == "graph":
            if kwargs:
                raise TypeError(f"backend 'graph' takes no options, got "
                                f"{sorted(kwargs)}")
            from .executor_torch import ExecutorTorch
            return ExecutorTorch(self)
        if backend == "kernel":
            from .executor_cuda import ExecutorCuda
            return ExecutorCuda(self, device=device, **kwargs)
        if backend in ("xla", "pallas"):
            raise ValueError(
                f"backend {backend!r} is the JAX package's name: the port "
                f"calls it {'graph' if backend == 'xla' else 'kernel'!r}")
        raise ValueError(f"unknown backend {backend!r}")
