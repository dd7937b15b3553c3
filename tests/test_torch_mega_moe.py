"""The port's megakernel MoE program (moe_ffn, the MoE serving graphs,
the golden executor's expert FFN, the two GROUPED_GEMM tasks of the
plain queue walk and `moe_weight_map`) against the JAX package, on the
CPU.

The MoE serving graphs must equal the JAX builder's node for node. On
seeded numpy inputs the golden executor agrees with the JAX
`ExecutorXLA` within 1e-5 of the largest reference value in f32
(summation order), on the JAX test's rms_norm -> router -> moe_ffn graph
of 10 rows and on a one-layer MoE serve graph with trash pages; the
plain walk agrees with the golden executor within the same 1e-5 in any
queue order, and a row past its slot's live width (pad rows, an idle
slot) gives exactly 0 and routes nowhere. Tied router logits pick the
lower expert index, as `jax.lax.top_k` does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_distributed_tpu.megakernel import models as jmodels
from triton_distributed_tpu.megakernel.builder import \
    ModelBuilder as JaxModelBuilder
from triton_distributed_tpu.ops import moe_utils as jmu
import triton_distributed_tpu_torch as port
from triton_distributed_tpu_torch import models
from triton_distributed_tpu_torch.megakernel import decoder as tdecoder
from triton_distributed_tpu_torch.megakernel import executor_cuda as mkx
from triton_distributed_tpu_torch.megakernel import models as tmodels
from triton_distributed_tpu_torch.megakernel.builder import ModelBuilder
from triton_distributed_tpu_torch.ops.moe_utils import route_topk

BLOCK, NUM_BLOCKS = 8, 6
LENS = (0, BLOCK - 1, 2 * BLOCK + 5)     # slot 0 idle on its trash page
DIMS = dict(b_slots=len(LENS), hidden=64, moe_intermediate=64,
            num_experts=4, top_k=2, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, num_blocks=NUM_BLOCKS,
            block=BLOCK, max_pages=4)
TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _graph_key(g):
    nodes = [(n.op, tuple(h.idx for h in n.inputs), n.out.idx, n.out.shape,
              n.attrs) for n in g.nodes]
    names = [{k: h.idx for k, h in d.items()}
             for d in (g.inputs, g.weights, g.caches)]
    return nodes, names, [h.idx for h in g.outputs]


@pytest.mark.parametrize("norm_topk", [True, False])
@pytest.mark.parametrize("qk_norm", [True, False])
@pytest.mark.parametrize("slot_rows", [1, 8])
def test_moe_serve_graphs_match_jax(slot_rows, qk_norm, norm_topk):
    kw = dict(DIMS, slot_rows=slot_rows, qk_norm=qk_norm,
              norm_topk=norm_topk)
    t = tmodels.build_qwen3_moe_serve_batched(**kw).graph
    assert _graph_key(t) == \
        _graph_key(jmodels.build_qwen3_moe_serve_batched(**kw).graph)
    moe = [n for n in t.nodes if n.op == "moe_ffn"]
    assert len(moe) == DIMS["num_layers"]
    assert all(n.attrs == dict(num_experts=4, top_k=2, intermediate=64,
                               norm_topk=norm_topk) for n in moe)


def _moe_ffn_builder(mod, m, h, ne, tk, inter):
    """rms_norm -> router linear -> moe_ffn (the JAX test's
    `_moe_ffn_builder`), in either package."""
    mb = mod(rms_eps=1e-6)
    x = mb.input("x", (m, h))
    wn = mb.weight("wn", (1, h))
    wr = mb.weight("wr", (h, ne))
    wgu = mb.weight("wgu", (ne * h, 2 * inter))
    wd = mb.weight("wd", (ne * inter, h))
    hn = mb.rms_norm(x, wn)
    mb.output(mb.moe_ffn(hn, mb.linear(hn, wr), wgu, wd,
                         num_experts=ne, top_k=tk))
    return mb


def _ffn_io(m, h, ne, inter, seed=13):
    rng = np.random.default_rng(seed)
    ins = {"x": rng.normal(size=(m, h)).astype(np.float32)}
    ws = {"wn": rng.normal(size=(1, h)).astype(np.float32) * 0.2 + 1,
          "wr": rng.normal(size=(h, ne)).astype(np.float32) * 0.3,
          "wgu": rng.normal(size=(ne * h, 2 * inter)).astype(np.float32)
          * 0.2,
          "wd": rng.normal(size=(ne * inter, h)).astype(np.float32) * 0.2}
    return ins, ws


FFN = (10, 32, 4, 2, 64)       # m (not a multiple of 8), h, E, top_k, I


@pytest.fixture(scope="module")
def ffn_ref():
    ins, ws = _ffn_io(FFN[0], FFN[1], FFN[2], FFN[4])
    (gold,) = _moe_ffn_builder(JaxModelBuilder, *FFN).compile(
        backend="xla").run(ins, ws)
    return ins, ws, np.asarray(gold)


def test_golden_moe_ffn_matches_jax(ffn_ref):
    ins, ws, ref = ffn_ref
    (got,) = _moe_ffn_builder(ModelBuilder, *FFN).compile("graph").run(
        ins, ws)
    assert _rel(got.numpy(), ref) <= TOL
    # the routing is not degenerate: top-1 of the same weights differs
    (g1,) = _moe_ffn_builder(ModelBuilder, *FFN[:3], 1, FFN[4]).compile(
        "graph").run(ins, ws)
    assert not np.allclose(g1.numpy(), ref)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n_sm", [3, 132])
def test_plain_walk_of_moe_ffn_matches_golden(ffn_ref, n_sm, seed):
    ins, ws, ref = ffn_ref
    prog = _moe_ffn_builder(ModelBuilder, *FFN).compile(
        "kernel", device="cpu", n_sm=n_sm)
    m, h, ne, tk, inter = FFN
    # one moe_ffn node, two GROUPED_GEMM tasks, phase 1 after phase 0
    t0 = next(t for t, nd in enumerate(prog.tasks) if nd.op == "moe_ffn")
    assert prog.phases[t0:t0 + 2] == [0, 1] and t0 in prog.deps[t0 + 1]
    assert prog.n_tiles[t0:t0 + 2].tolist() == [m * tk * 1,
                                                m * h // mkx.MOE_OUT_TN]
    prog.bind_weights({k: torch.from_numpy(v) for k, v in ws.items()})
    (out,) = prog.step({"x": torch.from_numpy(ins["x"])}, plain=True,
                       seed=seed)
    assert _rel(out.numpy(), ref) <= TOL


def test_routing_ties_pick_the_lowest_expert():
    """Tied router logits: the port's route_topk (the rule of the engine
    path, the golden executor and the plain walk) chooses the lowest
    indices, as JAX route_topk does; the golden moe_ffn and the plain
    walk on tied logits equal JAX's."""
    logits = np.asarray([[1.0, 3.0, 3.0, 0.0, 3.0],
                         [2.0, 2.0, 2.0, 2.0, 2.0],
                         [0.5, -1.0, 0.5, 0.5, 4.0]], np.float32)
    for k in (1, 2, 3):
        jw, je = jmu.route_topk(jnp.asarray(logits), k)
        tw, te = route_topk(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    assert route_topk(torch.from_numpy(logits), 2)[1].tolist() == \
        [[1, 2], [0, 1], [4, 0]]
    # through the whole node: a zero router makes every row a full tie
    m, h, ne, tk, inter = FFN
    ins, ws = _ffn_io(m, h, ne, inter, seed=3)
    ws["wr"][:] = 0.0
    (ref,) = _moe_ffn_builder(JaxModelBuilder, *FFN).compile(
        backend="xla").run(ins, ws)
    (gold,) = _moe_ffn_builder(ModelBuilder, *FFN).compile("graph").run(
        ins, ws)
    prog = _moe_ffn_builder(ModelBuilder, *FFN).compile(
        "kernel", device="cpu", n_sm=5)
    prog.bind_weights({k: torch.from_numpy(v) for k, v in ws.items()})
    (walk,) = prog.step({"x": torch.from_numpy(ins["x"])}, plain=True)
    assert _rel(gold.numpy(), np.asarray(ref)) <= TOL
    assert _rel(walk.numpy(), np.asarray(ref)) <= TOL
    assert prog.routed_experts() == {prog.graph.outputs[0].idx: [0, 1]}


# -- a one-layer MoE serve graph ---------------------------------------------

def _table(rng):
    nb, mp = len(LENS), DIMS["max_pages"]
    perm = iter(rng.permutation(NUM_BLOCKS))
    return np.asarray([[next(perm) if cl and c <= cl // BLOCK
                        else NUM_BLOCKS + b for c in range(mp)]
                       for b, cl in enumerate(LENS)], np.int32)


@pytest.fixture(scope="module")
def serve_ref():
    """JAX ExecutorXLA on the one-layer MoE serve graph (slot_rows 8, pad
    rows of x zero, slot 0 idle), the moe_ffn output exposed too."""
    R = 8
    kw = dict(DIMS, num_layers=1, slot_rows=R, qk_norm=True)
    out = []
    for mod in (tmodels, jmodels):
        mb = mod.build_qwen3_moe_serve_batched(**kw)
        mb.graph.outputs.append(next(nd.out for nd in mb.graph.nodes
                                     if nd.op == "moe_ffn"))
        out.append(mb)
    tmb, jmb = out
    rng = np.random.default_rng(4)
    ins, ws = jmodels.init_random_io(jmb, rng)
    ins["x"][np.arange(len(LENS) * R) % R != 0] = 0.0
    tbl = _table(rng)
    scalars = {f"cache_len_s{b}": cl for b, cl in enumerate(LENS)}
    ref = jmb.compile("xla").run(ins, ws, scalars, block_table=tbl)
    return tmb, ins, ws, tbl, scalars, [np.asarray(jax.device_get(o))
                                        for o in ref]


def test_golden_moe_serve_graph_matches_jax(serve_ref):
    tmb, ins, ws, tbl, scalars, ref = serve_ref
    got = tmb.compile("graph").run(ins, ws, scalars, block_table=tbl)
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert _rel(g.numpy(), r) <= TOL


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n_sm", [3, 132])
def test_plain_walk_of_moe_serve_graph_matches_golden(serve_ref, n_sm, seed):
    """Every slot's first row live: the walk equals the golden executor
    (pad rows are 0 in both). The idle slot at width 0: its row's expert
    output is exactly 0, every other row unchanged."""
    tmb, ins, ws, tbl, scalars, _ = serve_ref
    gold = [g.numpy() for g in tmb.compile("graph").run(
        ins, ws, scalars, block_table=tbl)]
    prog = tmb.compile("kernel", device="cpu", n_sm=n_sm)
    prog.bind_weights({k: torch.from_numpy(v) for k, v in ws.items()})
    R = 8
    runs = []
    for widths in ([1, 1, 1], [0, 1, 1]):
        prog.bind_caches({k: torch.from_numpy(ins[k].copy())
                          for k in tmb.graph.caches})
        outs = prog.step({"x": torch.from_numpy(ins["x"])},
                         cache_lens=np.asarray(LENS), block_table=tbl,
                         widths=np.asarray(widths), plain=True, seed=seed)
        runs.append([o.numpy().copy() for o in outs])
    live = np.arange(len(LENS) * R) % R == 0
    for a, g in zip(runs[0], gold):
        assert _rel(a, g) <= TOL
    out, moe = runs[1]
    assert (moe[~live] == 0).all() and (moe[0] == 0).all()
    assert (moe[0] != gold[1][0]).any()     # the golden routes the idle row
    assert _rel(moe[R:], gold[1][R:]) <= TOL
    assert _rel(out[R:], gold[0][R:]) <= TOL


def test_task_costs_count_the_routed_slabs(serve_ref):
    tmb, ins, ws, tbl, scalars, _ = serve_ref
    prog = tmb.compile("kernel", device="cpu", n_sm=4)
    prog.bind_weights({k: torch.from_numpy(v) for k, v in ws.items()})
    prog.bind_caches({k: torch.from_numpy(ins[k].copy())
                      for k in tmb.graph.caches})
    widths = np.asarray([0, 1, 1])
    prog.step({"x": torch.from_numpy(ins["x"])},
              cache_lens=np.asarray(LENS), block_table=tbl, widths=widths)
    assert prog.live_rows(24, widths).tolist() == [8, 16]
    routed = prog.routed_experts(widths)
    (idx,) = routed
    ne = len(routed[idx])
    assert 2 <= ne <= 4
    H, E, k, inter, item = 64, 4, 2, 64, 4
    costs = prog.task_costs(cache_lens=np.asarray(LENS), widths=widths,
                            experts=routed)
    p0, p1 = (c for nd, c in zip(prog.tasks, costs) if nd.op == "moe_ffn")
    act = 2 * k * inter
    assert p0["bytes"] == (2 * (H + E) + ne * H * 2 * inter + act) * item
    assert p1["bytes"] == (act + ne * inter * H + 24 * H) * item
    assert p1["flops"] == 2 * 2 * k * inter * H
    # without the routing: top_k slabs a live row, capped at E
    bound = prog.task_costs(cache_lens=np.asarray(LENS), widths=widths)
    b0 = [c for nd, c in zip(prog.tasks, bound) if nd.op == "moe_ffn"][0]
    assert b0["bytes"] == (2 * (H + E) + 4 * H * 2 * inter + act) * item


def test_step_refuses_bad_widths(serve_ref):
    tmb, ins, ws, tbl, _, _ = serve_ref
    prog = tmb.compile("kernel", device="cpu", n_sm=4)
    prog.bind_weights({k: torch.from_numpy(v) for k, v in ws.items()})
    lens = np.asarray(LENS)
    for bad in ([1, 1], [0, 9, 1], [-1, 1, 1]):
        with pytest.raises(ValueError, match="widths"):
            prog.step(cache_lens=lens, block_table=tbl, widths=bad)
    ffn = _moe_ffn_builder(ModelBuilder, *FFN).compile("kernel",
                                                       device="cpu")
    with pytest.raises(ValueError, match="no paged node"):
        ffn.step(widths=[1])


@pytest.mark.parametrize("change,what", [
    (dict(num_experts=264), "264 experts"),
    (dict(top_k=33, num_experts=64), "top_k 33"),
    (dict(moe_intermediate=96), "intermediate 96"),
    (dict(hidden=80), "hidden 80"),
    (dict(top_k=8, num_experts=16, moe_intermediate=2112),
     "staged floats"),
])
def test_kernel_refuses_moe_shapes_it_does_not_take(change, what):
    kw = dict(DIMS, num_layers=1, slot_rows=1, head_dim=64, num_heads=2,
              num_kv_heads=1, num_experts=8)
    kw.update(change)
    prog = tmodels.build_qwen3_moe_serve_batched(**kw).compile(
        "kernel", device="cpu", n_sm=4)
    with pytest.raises(ValueError, match=what):
        prog._check_kernel_shapes()
    ok = tmodels.build_qwen3_moe_serve_batched(
        **dict(kw, hidden=2048, num_experts=128, top_k=8,
               moe_intermediate=768, num_layers=1))
    ok.compile("kernel", device="cpu", n_sm=4)._check_kernel_shapes()


# -- the weight map -----------------------------------------------------------

SHRINK = dict(hidden_size=64, intermediate_size=96, num_heads=4,
              num_kv_heads=2, head_dim=16, vocab_size=128, num_experts=4,
              num_experts_per_tok=2, moe_intermediate_size=64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_weight_map_gives_views(dtype):
    cfg = models.get_config("Qwen/Qwen3-30B-A3B").tiny(**SHRINK)
    m = models.Qwen3MoE(cfg, dtype=dtype, device="cpu")
    p = m.init_params(torch.Generator().manual_seed(0))
    w, embed, lm = tdecoder.moe_weight_map(m, p)
    lay = p["layers"]
    assert embed is p["embed"] and lm is p["lm_head"]
    for i in range(cfg.num_layers):
        gu, dn = w[f"l{i}.w_moe_gate_up"], w[f"l{i}.w_moe_down"]
        assert gu.shape == (4 * 64, 128) and dn.shape == (4 * 64, 64)
        assert gu.data_ptr() == lay["w_moe_gate_up"][i].data_ptr()
        assert dn.data_ptr() == lay["w_moe_down"][i].data_ptr()
        assert gu._base is not None and dn._base is not None
        for name in ("w_qkv", "w_o"):
            assert w[f"l{i}.{name}"].data_ptr() == lay[name][i].data_ptr()
        r = w[f"l{i}.router"]
        assert r.dtype == m.dtype
        # the router is the one copy, made only where the dtype differs
        assert (r.data_ptr() == lay["router"][i].data_ptr()) \
            == (dtype == "float32")
        torch.testing.assert_close(r.float(),
                                   lay["router"][i].to(m.dtype).float())
    tmb = tmodels.build_qwen3_moe_serve_batched(
        b_slots=1, slot_rows=1, hidden=64, moe_intermediate=64,
        num_experts=4, top_k=2, num_layers=cfg.num_layers, num_heads=4,
        num_kv_heads=2, head_dim=16, num_blocks=2, block=4, max_pages=8,
        qk_norm=cfg.qk_norm, dtype=m.dtype)
    assert set(w) == set(tmb.graph.weights)


def test_dense_paths_refuse_a_moe_model():
    """MegaDecoder is dense-only, as in the JAX package: a plain error,
    naming no slice."""
    cfg = models.get_config("Qwen/Qwen3-30B-A3B").tiny(**SHRINK)
    m = models.Qwen3MoE(cfg, dtype="float32", device="cpu")
    p = m.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="MoE model"):
        tdecoder.dense_weight_map(m, p)
    with pytest.raises(ValueError, match="MoE model"):
        port.MegaDecoder.from_dense(m, p, max_cache=16, prompt_len=4,
                                    device="cpu")
    dense = models.DenseLLM(models.get_config("Qwen/Qwen3-0.6B").tiny(
        **{k: v for k, v in SHRINK.items() if "expert" not in k
           and k != "moe_intermediate_size"}), dtype="float32",
        device="cpu")
    with pytest.raises(ValueError, match="not a MoE model"):
        tdecoder.moe_weight_map(dense, None)
    with pytest.raises(NotImplementedError, match="slice 6"):
        tdecoder.moe_weight_map(
            dataclasses.make_dataclass("M", [("n", int)])(2), None)
