"""Megakernel model assembly: Qwen3-style transformer blocks
(counterpart of triton_distributed_tpu/megakernel/models.py).

Analog of reference mega_triton_kernel/models/qwen3.py:202 — the Qwen3
forward assembled as one megakernel program. The builders emit the same
op graph as the JAX package's, node for node, the MoE serving program
included. With `tp_shards=True` the o and down projections are followed
by `all_reduce` nodes: the builder's graph is then one rank's program at
the local widths (heads / n, kv heads / n, intermediate / n), which the
caller runs with rank-stacked weight shards over `mesh` (a RankGroup).
The MoE serving program stays one-rank: the JAX MegaServe refuses MoE at
n ranks too.
"""

from __future__ import annotations

import numpy as np

from .builder import ModelBuilder, later_slice


def _one_rank_moe(mesh, tp_shards):
    if mesh is not None or tp_shards:
        raise later_slice("the MoE serving program over ranks (tp_shards / "
                          "mesh)", "6", " (MoE megakernel serving at n "
                          "ranks; the JAX MegaServe refuses it too)")


def _tp_mlp_tail(mb, x, o, ln2, w_gate, w_up, w_down, tp_shards):
    """The residual add of the o projection, then the SwiGLU MLP and its
    residual add; with `tp_shards` each row-parallel projection (o, down)
    is summed over the ranks by an all_reduce node first."""
    if tp_shards:
        o = mb.all_reduce(o)
    x = mb.add(x, o)
    h = mb.rms_norm(x, ln2)
    a = mb.silu_mul(mb.linear(h, w_gate), mb.linear(h, w_up))
    y = mb.linear(a, w_down)
    if tp_shards:
        y = mb.all_reduce(y)
    return mb.add(x, y)


def build_qwen3_block(mb: ModelBuilder, x, *, layer: int, hidden: int,
                      intermediate: int, num_heads: int,
                      num_kv_heads: int, head_dim: int,
                      rope_theta: float = 1e6, tp_shards: bool = False):
    """Append one transformer block (attn + SwiGLU MLP, pre-norm,
    residuals) to the graph; returns the block output handle."""
    pre = f"l{layer}."
    d = head_dim
    qkv_cols = (num_heads + 2 * num_kv_heads) * d

    ln1 = mb.weight(pre + "ln1", (1, hidden))
    w_qkv = mb.weight(pre + "w_qkv", (hidden, qkv_cols))
    w_o = mb.weight(pre + "w_o", (num_heads * d, hidden))
    ln2 = mb.weight(pre + "ln2", (1, hidden))
    w_gate = mb.weight(pre + "w_gate", (hidden, intermediate))
    w_up = mb.weight(pre + "w_up", (hidden, intermediate))
    w_down = mb.weight(pre + "w_down", (intermediate, hidden))

    h = mb.rms_norm(x, ln1)
    qkv = mb.linear(h, w_qkv)
    attn = mb.attention(qkv, num_heads=num_heads,
                        num_kv_heads=num_kv_heads, head_dim=d,
                        rope_theta=rope_theta)
    return _tp_mlp_tail(mb, x, mb.linear(attn, w_o), ln2, w_gate, w_up,
                        w_down, tp_shards)


def build_qwen3_decode_block(mb: ModelBuilder, x, *, layer: int,
                             hidden: int, intermediate: int,
                             num_heads: int, num_kv_heads: int,
                             head_dim: int, max_cache: int,
                             rope_theta: float = 1e6,
                             qk_norm: bool = False,
                             tp_shards: bool = False,
                             kv_append: bool = False):
    """One transformer block of a DECODE step: attention runs against a
    per-layer KV cache (cache inputs `l{i}.k_cache` / `l{i}.v_cache`,
    valid prefix length = the shared `cache_len` run-time scalar).
    `kv_append=True` also emits the cache-update tasks: the step's new K
    (normed + roped) and raw V rows land in the caches at
    [cache_len, cache_len + S) inside the same launch — the
    device-resident serving form MegaDecoder uses."""
    pre = f"l{layer}."
    d = head_dim
    qkv_cols = (num_heads + 2 * num_kv_heads) * d

    ln1 = mb.weight(pre + "ln1", (1, hidden))
    w_qkv = mb.weight(pre + "w_qkv", (hidden, qkv_cols))
    w_o = mb.weight(pre + "w_o", (num_heads * d, hidden))
    ln2 = mb.weight(pre + "ln2", (1, hidden))
    w_gate = mb.weight(pre + "w_gate", (hidden, intermediate))
    w_up = mb.weight(pre + "w_up", (hidden, intermediate))
    w_down = mb.weight(pre + "w_down", (intermediate, hidden))
    kc = mb.cache(pre + "k_cache", (max_cache, num_kv_heads * d))
    vc = mb.cache(pre + "v_cache", (max_cache, num_kv_heads * d))
    qn = kn = None
    if qk_norm:
        qn = mb.weight(pre + "q_norm", (1, d))
        kn = mb.weight(pre + "k_norm", (1, d))

    h = mb.rms_norm(x, ln1)
    qkv = mb.linear(h, w_qkv)
    attn = mb.attention_kv(qkv, kc, vc, num_heads=num_heads,
                           num_kv_heads=num_kv_heads, head_dim=d,
                           rope_theta=rope_theta, q_norm=qn, k_norm=kn)
    if kv_append:
        mb.kv_append(qkv, kc, vc, num_heads=num_heads,
                     num_kv_heads=num_kv_heads, head_dim=d,
                     rope_theta=rope_theta, k_norm=kn)
    return _tp_mlp_tail(mb, x, mb.linear(attn, w_o), ln2, w_gate, w_up,
                        w_down, tp_shards)


def build_qwen3_decode(*, seq_len: int, hidden: int, intermediate: int,
                       num_layers: int, num_heads: int, num_kv_heads: int,
                       head_dim: int, max_cache: int,
                       rope_theta: float = 1e6, qk_norm: bool = False,
                       rms_eps: float = 1e-6, mesh=None,
                       axis: str = "tp", tp_shards: bool = False,
                       kv_append: bool = False,
                       dtype=None) -> ModelBuilder:
    """Whole decode-step trunk (hidden states of the `seq_len` new tokens
    in -> normalized hidden states out) against per-layer KV caches, as
    one megakernel program. `qk_norm` adds Qwen3's per-head q/k RMSNorm
    weights (`l{i}.q_norm`/`k_norm`)."""
    kwargs = {} if dtype is None else {"dtype": dtype}
    mb = ModelBuilder(mesh=mesh, axis=axis, rms_eps=rms_eps, **kwargs)
    x = mb.input("x", (seq_len, hidden))
    for layer in range(num_layers):
        x = build_qwen3_decode_block(
            mb, x, layer=layer, hidden=hidden, intermediate=intermediate,
            num_heads=num_heads, num_kv_heads=num_kv_heads,
            head_dim=head_dim, max_cache=max_cache,
            rope_theta=rope_theta, qk_norm=qk_norm, tp_shards=tp_shards,
            kv_append=kv_append)
    fn = mb.weight("final_norm", (1, hidden))
    mb.output(mb.rms_norm(x, fn))
    return mb


def build_qwen3_forward(*, seq_len: int, hidden: int, intermediate: int,
                        num_layers: int, num_heads: int, num_kv_heads: int,
                        head_dim: int, rope_theta: float = 1e6,
                        mesh=None, axis: str = "tp",
                        tp_shards: bool = False) -> ModelBuilder:
    """Whole-trunk forward (hidden states in -> hidden states out) as
    one megakernel program; embed/lm_head stay outside like the
    reference's server wrapper."""
    mb = ModelBuilder(mesh=mesh, axis=axis)
    x = mb.input("x", (seq_len, hidden))
    for layer in range(num_layers):
        x = build_qwen3_block(
            mb, x, layer=layer, hidden=hidden, intermediate=intermediate,
            num_heads=num_heads, num_kv_heads=num_kv_heads,
            head_dim=head_dim, rope_theta=rope_theta, tp_shards=tp_shards)
    fn = mb.weight("final_norm", (1, hidden))
    mb.output(mb.rms_norm(x, fn))
    return mb


def init_random_io(mb: ModelBuilder, rng, *, stack: int | None = None,
                   dtype=None):
    """Random (inputs, weights) numpy arrays for a built graph from a
    numpy Generator, with the JAX package's conventions and draw order
    (norm weights positive around 1, small dense weights), so one seed
    gives both packages the same numbers. `stack=n` gives every array a
    leading rank dimension (the operands of an n-rank program): the
    weight of a LINEAR that feeds an all_reduce is drawn on its own for
    each rank, so the cross-rank sum adds different partials; every
    other array is one draw replicated."""
    dtype = dtype or np.float32
    # weights of a LINEAR whose output an all_reduce sums
    vary = set()
    for nd in mb.graph.nodes:
        if nd.op == "all_reduce":
            src = mb.graph.producer(nd.inputs[0])
            if src is not None and src.op == "linear":
                vary.add(src.inputs[1].idx)

    def draw(hdl, scale, positive=False):
        def one():
            w = rng.normal(size=hdl.shape).astype(dtype) * scale
            return (np.abs(w) + 1.0).astype(dtype) if positive else w

        if stack is None:
            return one()
        if hdl.idx in vary:
            return np.stack([one() for _ in range(stack)])
        return np.broadcast_to(one(), (stack,) + hdl.shape).copy()

    inputs, weights = {}, {}
    for name, hdl in mb.graph.inputs.items():
        inputs[name] = draw(hdl, 1.0 if name == "x" else 0.5)
    for name, hdl in mb.graph.weights.items():
        positive = "ln" in name or "norm" in name
        weights[name] = draw(hdl, 0.2, positive=positive)
    return inputs, weights


def build_qwen3_serve_block(mb: ModelBuilder, x, *, layer: int,
                            hidden: int, intermediate: int,
                            num_heads: int, num_kv_heads: int,
                            head_dim: int, pool_pages: int, block: int,
                            max_pages: int, slot_rows: int,
                            rope_theta: float = 1e6,
                            qk_norm: bool = False,
                            tp_shards: bool = False):
    """One transformer block of the batched serving decode step:
    attention and the cache append run per slot against the paged KV
    pool (`l{i}.k_pool` / `v_pool` cache tensors of `pool_pages` pages
    of `block` rows), through the block table. The trunk is
    (b_slots * slot_rows, hidden): slot b's token in row b*slot_rows,
    pad rows zero."""
    pre = f"l{layer}."
    d = head_dim
    qkv_cols = (num_heads + 2 * num_kv_heads) * d

    ln1 = mb.weight(pre + "ln1", (1, hidden))
    w_qkv = mb.weight(pre + "w_qkv", (hidden, qkv_cols))
    w_o = mb.weight(pre + "w_o", (num_heads * d, hidden))
    ln2 = mb.weight(pre + "ln2", (1, hidden))
    w_gate = mb.weight(pre + "w_gate", (hidden, intermediate))
    w_up = mb.weight(pre + "w_up", (hidden, intermediate))
    w_down = mb.weight(pre + "w_down", (intermediate, hidden))
    kp = mb.cache(pre + "k_pool", (pool_pages * block, num_kv_heads * d))
    vp = mb.cache(pre + "v_pool", (pool_pages * block, num_kv_heads * d))
    qn = kn = None
    if qk_norm:
        qn = mb.weight(pre + "q_norm", (1, d))
        kn = mb.weight(pre + "k_norm", (1, d))

    h = mb.rms_norm(x, ln1)
    qkv = mb.linear(h, w_qkv)
    attn = mb.attention_paged(qkv, kp, vp, num_heads=num_heads,
                              num_kv_heads=num_kv_heads, head_dim=d,
                              block=block, max_pages=max_pages,
                              slot_rows=slot_rows, rope_theta=rope_theta,
                              q_norm=qn, k_norm=kn)
    mb.kv_append_paged(qkv, kp, vp, num_heads=num_heads,
                       num_kv_heads=num_kv_heads, head_dim=d,
                       block=block, max_pages=max_pages,
                       slot_rows=slot_rows, rope_theta=rope_theta,
                       k_norm=kn)
    return _tp_mlp_tail(mb, x, mb.linear(attn, w_o), ln2, w_gate, w_up,
                        w_down, tp_shards)


def build_qwen3_serve_batched(*, b_slots: int, slot_rows: int,
                              hidden: int, intermediate: int,
                              num_layers: int, num_heads: int,
                              num_kv_heads: int, head_dim: int,
                              num_blocks: int, block: int,
                              max_pages: int, rope_theta: float = 1e6,
                              qk_norm: bool = False,
                              rms_eps: float = 1e-6, mesh=None,
                              axis: str = "tp", tp_shards: bool = False,
                              dtype=None) -> ModelBuilder:
    """ServeEngine's megakernel decode step: one persistent-kernel
    launch for the whole `b_slots` batch over the paged KV pool. Every
    slot owns one `slot_rows`-row trunk tile (its token in row
    b*slot_rows); per-slot cache lengths and the block table are
    run-time data. The pool carries `num_blocks` shared pages plus
    `b_slots` per-slot trash pages (ids num_blocks + b): the host routes
    an inactive slot's table row there (MegaServe.kernel_table), so an
    empty slot rides the batched walk at cache_len 0 and corrupts
    nothing. With `tp_shards` it is one rank's program at the local
    widths, an all_reduce after every o and down projection; each rank
    has a pool of its own kv heads (and its own trash pages)."""
    kwargs = {} if dtype is None else {"dtype": dtype}
    mb = ModelBuilder(mesh=mesh, axis=axis, rms_eps=rms_eps, **kwargs)
    pool_pages = num_blocks + b_slots
    x = mb.input("x", (b_slots * slot_rows, hidden))
    for layer in range(num_layers):
        x = build_qwen3_serve_block(
            mb, x, layer=layer, hidden=hidden, intermediate=intermediate,
            num_heads=num_heads, num_kv_heads=num_kv_heads,
            head_dim=head_dim, pool_pages=pool_pages, block=block,
            max_pages=max_pages, slot_rows=slot_rows,
            rope_theta=rope_theta, qk_norm=qk_norm, tp_shards=tp_shards)
    fn = mb.weight("final_norm", (1, hidden))
    mb.output(mb.rms_norm(x, fn))
    return mb


def build_qwen3_moe_serve_block(mb: ModelBuilder, x, *, layer: int,
                                hidden: int, moe_intermediate: int,
                                num_experts: int, top_k: int,
                                num_heads: int, num_kv_heads: int,
                                head_dim: int, pool_pages: int,
                                block: int, max_pages: int,
                                slot_rows: int,
                                rope_theta: float = 1e6,
                                qk_norm: bool = False,
                                norm_topk: bool = True,
                                tp_shards: bool = False):
    """One transformer block of the batched MoE serving decode step: the
    attention and paged-append structure of `build_qwen3_serve_block`,
    with the dense SwiGLU replaced by a router LINEAR (`l{i}.router`,
    (H, E)) into `moe_ffn` over the stacked expert slabs
    `l{i}.w_moe_gate_up` ((E*H, 2I)) and `l{i}.w_moe_down`
    ((E*I, H))."""
    _one_rank_moe(None, tp_shards)
    pre = f"l{layer}."
    d = head_dim
    qkv_cols = (num_heads + 2 * num_kv_heads) * d

    ln1 = mb.weight(pre + "ln1", (1, hidden))
    w_qkv = mb.weight(pre + "w_qkv", (hidden, qkv_cols))
    w_o = mb.weight(pre + "w_o", (num_heads * d, hidden))
    ln2 = mb.weight(pre + "ln2", (1, hidden))
    router = mb.weight(pre + "router", (hidden, num_experts))
    w_gu = mb.weight(pre + "w_moe_gate_up",
                     (num_experts * hidden, 2 * moe_intermediate))
    w_dn = mb.weight(pre + "w_moe_down",
                     (num_experts * moe_intermediate, hidden))
    kp = mb.cache(pre + "k_pool", (pool_pages * block, num_kv_heads * d))
    vp = mb.cache(pre + "v_pool", (pool_pages * block, num_kv_heads * d))
    qn = kn = None
    if qk_norm:
        qn = mb.weight(pre + "q_norm", (1, d))
        kn = mb.weight(pre + "k_norm", (1, d))

    h = mb.rms_norm(x, ln1)
    qkv = mb.linear(h, w_qkv)
    attn = mb.attention_paged(qkv, kp, vp, num_heads=num_heads,
                              num_kv_heads=num_kv_heads, head_dim=d,
                              block=block, max_pages=max_pages,
                              slot_rows=slot_rows, rope_theta=rope_theta,
                              q_norm=qn, k_norm=kn)
    mb.kv_append_paged(qkv, kp, vp, num_heads=num_heads,
                       num_kv_heads=num_kv_heads, head_dim=d,
                       block=block, max_pages=max_pages,
                       slot_rows=slot_rows, rope_theta=rope_theta,
                       k_norm=kn)
    o = mb.linear(attn, w_o)
    x = mb.add(x, o)

    h = mb.rms_norm(x, ln2)
    logits = mb.linear(h, router)
    y = mb.moe_ffn(h, logits, w_gu, w_dn, num_experts=num_experts,
                   top_k=top_k, norm_topk=norm_topk)
    return mb.add(x, y)


def build_qwen3_moe_serve_batched(*, b_slots: int, slot_rows: int,
                                  hidden: int, moe_intermediate: int,
                                  num_experts: int, top_k: int,
                                  num_layers: int, num_heads: int,
                                  num_kv_heads: int, head_dim: int,
                                  num_blocks: int, block: int,
                                  max_pages: int,
                                  rope_theta: float = 1e6,
                                  qk_norm: bool = False,
                                  norm_topk: bool = True,
                                  rms_eps: float = 1e-6, mesh=None,
                                  axis: str = "tp",
                                  tp_shards: bool = False,
                                  dtype=None) -> ModelBuilder:
    """ServeEngine's MoE megakernel decode step: the
    `build_qwen3_serve_batched` program with every layer's MLP swapped
    for the router and `moe_ffn`. The same slot-per-tile trunk and paged
    pool with per-slot trash pages; a slot that does not decode
    (idle, or deferred by the expert-capacity budget) rides the launch
    on its trash page at width 0, so its rows route to no expert."""
    _one_rank_moe(mesh, tp_shards)
    kwargs = {} if dtype is None else {"dtype": dtype}
    mb = ModelBuilder(axis=axis, rms_eps=rms_eps, **kwargs)
    pool_pages = num_blocks + b_slots
    x = mb.input("x", (b_slots * slot_rows, hidden))
    for layer in range(num_layers):
        x = build_qwen3_moe_serve_block(
            mb, x, layer=layer, hidden=hidden,
            moe_intermediate=moe_intermediate, num_experts=num_experts,
            top_k=top_k, num_heads=num_heads,
            num_kv_heads=num_kv_heads, head_dim=head_dim,
            pool_pages=pool_pages, block=block, max_pages=max_pages,
            slot_rows=slot_rows, rope_theta=rope_theta, qk_norm=qk_norm,
            norm_topk=norm_topk)
    fn = mb.weight("final_norm", (1, hidden))
    mb.output(mb.rms_norm(x, fn))
    return mb
