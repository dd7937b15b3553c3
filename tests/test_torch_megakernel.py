"""The port's megakernel (triton_distributed_tpu_torch/megakernel) against
the JAX package's, on the CPU.

Graphs, schedules and greedy tokens must be exactly equal; the golden
executor's f32 outputs and updated caches agree with the JAX
`ExecutorXLA` within 1e-5 of the largest reference value (f32 summation
order), and so does the kernel's plain queue walk, which must also give
bit-identical outputs whatever order it interleaves the per-SM queues
in. The JAX side runs jitted on a 1-device CPU mesh; its attention
partials go through the Pallas kernels in interpret mode.
"""

import ast
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_distributed_tpu import native as jnative
from triton_distributed_tpu.megakernel import MegaDecoder as JaxMegaDecoder
from triton_distributed_tpu.megakernel import graph as jgraph
from triton_distributed_tpu.megakernel import models as jmodels
from triton_distributed_tpu.models import DenseLLM as JaxDenseLLM
from triton_distributed_tpu.models import config as jax_config
import triton_distributed_tpu_torch as port
from triton_distributed_tpu_torch import models
from triton_distributed_tpu_torch import megakernel as mk
from triton_distributed_tpu_torch.megakernel import builder as tbuilder
from triton_distributed_tpu_torch.megakernel import decoder as tdecoder
from triton_distributed_tpu_torch.megakernel import executor_cuda as mkx
from triton_distributed_tpu_torch.megakernel import graph as tgraph
from triton_distributed_tpu_torch.megakernel import models as tmodels
from triton_distributed_tpu_torch.megakernel import scheduler
from triton_distributed_tpu_torch.parallel import mesh as mk_mesh

SHRINK = dict(hidden_size=64, num_heads=4, num_kv_heads=2, head_dim=16,
              vocab_size=128)
TINY = dict(hidden=64, intermediate=128, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, max_cache=32)
P, GEN, CHUNK, MAX_CACHE = 13, 4, 8, 32


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


# -- (a) graph, (b) scheduler, (c) builders -----------------------------------

def test_graph_is_the_jax_module():
    """graph.py is the JAX module carried over: the same syntax tree
    once docstrings are dropped."""
    def tree(mod):
        t = ast.parse(inspect.getsource(mod))
        for node in ast.walk(t):
            body = getattr(node, "body", None)
            if isinstance(body, list) and body \
                    and isinstance(body[0], ast.Expr) \
                    and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                node.body = body[1:] or [ast.Pass()]
        return ast.dump(t)

    assert tree(tgraph) == tree(jgraph)
    assert tgraph.OPS == jgraph.OPS


@pytest.mark.parametrize("n_cores", [1, 2, 4, 132])
@pytest.mark.parametrize("strategy", [scheduler.ROUND_ROBIN,
                                      scheduler.ZIG_ZAG])
def test_schedule_matches_jax(n_cores, strategy):
    rng = np.random.default_rng(n_cores)
    cases = [np.array([3, 0, 5, 1], np.int32), np.array([1], np.int32),
             np.array([], np.int32), np.full(7, 132, np.int32),
             rng.integers(0, 300, 60).astype(np.int32)]
    for n_tiles in cases:
        q, ql = scheduler.schedule(n_tiles, n_cores, strategy)
        jq, jql = jnative.schedule(n_tiles, n_cores, strategy)
        np.testing.assert_array_equal(q, jq)
        np.testing.assert_array_equal(ql, jql)
        offs, total = scheduler.scoreboard_offsets(n_tiles)
        assert total == int(n_tiles.sum()) and len(offs) == len(n_tiles)
        if len(n_tiles):   # (JAX's numpy fallback gives [0] for no task)
            joffs, jtotal = jnative.scoreboard_offsets(n_tiles)
            np.testing.assert_array_equal(offs, joffs)
            assert total == jtotal
    with pytest.raises(ValueError):
        scheduler.schedule(np.array([1 << 20], np.int32), n_cores)


def _graph_key(g):
    nodes = [(n.op, tuple(h.idx for h in n.inputs), n.out.idx, n.out.shape,
              n.attrs) for n in g.nodes]
    names = [{k: h.idx for k, h in d.items()}
             for d in (g.inputs, g.weights, g.caches)]
    return nodes, names, [h.idx for h in g.outputs]


@pytest.mark.parametrize("qk_norm", [True, False])
@pytest.mark.parametrize("seq_len", [1, 8])
def test_builders_match_jax(qk_norm, seq_len):
    kw = dict(seq_len=seq_len, **TINY, qk_norm=qk_norm, kv_append=True)
    assert _graph_key(tmodels.build_qwen3_decode(**kw).graph) == \
        _graph_key(jmodels.build_qwen3_decode(**kw).graph)
    kw = dict(seq_len=seq_len, **{k: v for k, v in TINY.items()
                                  if k != "max_cache"})
    assert _graph_key(tmodels.build_qwen3_forward(**kw).graph) == \
        _graph_key(jmodels.build_qwen3_forward(**kw).graph)


def test_init_random_io_matches_jax():
    kw = dict(seq_len=1, **TINY, qk_norm=True, kv_append=True)
    ti, tw = tmodels.init_random_io(tmodels.build_qwen3_decode(**kw),
                                    np.random.default_rng(4))
    ji, jw = jmodels.init_random_io(jmodels.build_qwen3_decode(**kw),
                                    np.random.default_rng(4))
    for a, b in ((ti, ji), (tw, jw)):
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


# -- (d) the golden executor, (e) the plain queue walk -----------------------

def _decode_graphs(seq_len, qk_norm=True):
    """The same decode graph in both packages, with the kv_append outputs
    exposed (as the JAX MegaDecoder's xla form does)."""
    out = []
    for mod in (tmodels, jmodels):
        mb = mod.build_qwen3_decode(seq_len=seq_len, **TINY, qk_norm=qk_norm,
                                    kv_append=True)
        for nd in mb.graph.nodes:
            if nd.op == "kv_append":
                mb.graph.outputs.append(nd.out)
        out.append(mb)
    return out


@pytest.fixture(scope="module")
def jax_runs():
    """JAX ExecutorXLA outputs at (S=8, cache_len 0) and (S=1,
    cache_len 11), on random inputs and caches."""
    runs = {}
    for S, cl in ((8, 0), (1, 11)):
        tmb, jmb = _decode_graphs(S)
        ins, ws = jmodels.init_random_io(jmb, np.random.default_rng(S))
        outs = jmb.compile("xla").run(ins, ws, {"cache_len": cl})
        runs[S, cl] = (tmb, ins, ws, [np.asarray(o) for o in outs])
    return runs


@pytest.mark.parametrize("S,cl", [(8, 0), (1, 11)])
def test_golden_executor_matches_jax(jax_runs, S, cl):
    tmb, ins, ws, ref = jax_runs[S, cl]
    got = tmb.compile("graph").run(ins, ws, {"cache_len": cl})
    assert len(got) == len(ref) == 1 + 2 * TINY["num_layers"]
    for g, r in zip(got, ref):
        assert _rel(g.numpy(), r) <= 1e-5
    # the cache rows outside [cl, cl + S) are the inputs', untouched
    k0 = got[1].numpy()
    np.testing.assert_array_equal(k0[:cl], ins["l0.k_cache"][:cl])
    np.testing.assert_array_equal(k0[cl + S:], ins["l0.k_cache"][cl + S:])


@pytest.mark.parametrize("n_sm", [4, 132])
@pytest.mark.parametrize("S,cl", [(8, 0), (1, 11)])
def test_plain_walk_matches_golden_in_any_order(jax_runs, S, cl, n_sm):
    tmb, ins, ws, ref = jax_runs[S, cl]
    prog = tmb.compile("kernel", device="cpu", n_sm=n_sm)
    assert prog.queues.shape[0] == n_sm
    gold = tmb.compile("graph").run(ins, ws, {"cache_len": cl})
    runs = []
    for seed in (0, 1, 2):
        prog.bind_weights({k: torch.from_numpy(v) for k, v in ws.items()})
        prog.bind_caches({k: torch.from_numpy(ins[k].copy())
                          for k in tmb.graph.caches})
        outs = prog.step({"x": torch.from_numpy(ins["x"])}, cl, seed=seed)
        runs.append([o.clone() for o in outs])
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b)
    for a, g, r in zip(runs[0], gold, ref):
        assert _rel(a.numpy(), g.numpy()) <= 1e-5
        assert _rel(a.numpy(), r) <= 1e-5


def test_plain_walk_raises_where_the_kernel_would_deadlock():
    mb = tmodels.build_qwen3_decode(seq_len=1, **TINY, kv_append=True)
    ins, ws = tmodels.init_random_io(mb, np.random.default_rng(0))
    prog = mb.compile("kernel", device="cpu", n_sm=4)
    prog.deps[5] = prog.deps[5] + [5]          # a task that waits on itself
    with pytest.raises(RuntimeError, match="no queue head can run"):
        prog.run(ins, ws, {"cache_len": 3})


def test_program_tiling_and_queues():
    """The decode program's decomposition at the tiny widths: 32-column
    LINEAR tiles, one ATTN tile per kv head, one row tile elsewhere; the
    queues hold every (task, tile) once, in task order."""
    mb = tmodels.build_qwen3_decode(seq_len=1, **TINY, qk_norm=True,
                                    kv_append=True)
    prog = mb.compile("kernel", device="cpu", n_sm=4)
    tiles = dict(zip((nd.op for nd in prog.tasks), prog.n_tiles))
    assert tiles["attention_kv"] == TINY["num_kv_heads"]
    assert [t for nd, t in zip(prog.tasks, prog.n_tiles)
            if nd.op == "linear"][:5] == [128 // 32, 64 // 32, 128 // 32,
                                          128 // 32, 64 // 32]
    items = [scheduler.unpack(e) for c in range(4)
             for e in prog.queues[c, :prog.qlen[c]]]
    assert sorted(items) == [(t, i) for t, n in enumerate(prog.n_tiles)
                             for i in range(n)]
    for c in range(4):
        tasks = [scheduler.unpack(e)[0] for e in
                 prog.queues[c, :prog.qlen[c]]]
        assert tasks == sorted(tasks)
    _, ws = tmodels.init_random_io(mb, np.random.default_rng(0))
    prog.bind_weights({k: torch.from_numpy(v) for k, v in ws.items()})
    desc, deps, *_ = prog.descriptors()
    for t, nd in enumerate(prog.tasks):
        lo, hi = desc[t, mkx.F_DEP_LO], desc[t, mkx.F_DEP_HI]
        assert list(deps[lo:hi]) == prog.deps[t]
        assert all(p < t for p in prog.deps[t])


# -- (f) greedy tokens, (g) sampling --------------------------------------------

@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.asarray(jax.devices()[:1]), ("tp",))


def _models(mesh, name):
    jm = JaxDenseLLM(jax_config.get_config(name).tiny(**SHRINK), mesh=mesh,
                     mode="xla", dtype=jnp.float32)
    jp = jm.init_params(jax.random.PRNGKey(0))
    pm = models.DenseLLM(models.get_config(name).tiny(**SHRINK), mode="xla",
                         dtype="float32", device="cpu")
    pp = models.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, pm, pp


def _prompt():
    return np.random.default_rng(5).integers(0, 128, P).astype(np.int32)


@pytest.mark.parametrize("name", ["Qwen/Qwen3-0.6B",
                                  "meta-llama/Meta-Llama-3-70B"])
def test_megadecoder_greedy_matches_engine_and_jax(mesh1, name):
    jm, jp, pm, pp = _models(mesh1, name)
    prompt = _prompt()
    ref = JaxMegaDecoder.from_dense(jm, jp, max_cache=MAX_CACHE,
                                    prompt_len=P, backend="xla").serve(
        prompt, GEN)
    eng = models.Engine(pm, pp, max_len=MAX_CACHE).serve(prompt[None],
                                                          GEN)[0]
    np.testing.assert_array_equal(eng, ref)
    for backend, fuse in (("kernel", False), ("graph", False),
                          ("kernel", True)):
        md = port.MegaDecoder.from_dense(
            pm, pp, max_cache=MAX_CACHE, prompt_len=P,
            prefill_chunk=CHUNK, backend=backend, device="cpu",
            fuse_elementwise=fuse, fuse_kv_append=fuse)
        assert md._n_prefill_chunks == 2 and md.prefill_chunk == CHUNK
        got = md.serve(prompt, GEN)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, ref)


def test_megadecoder_shares_weights_and_caches():
    cfg = models.get_config("Qwen/Qwen3-0.6B").tiny(**SHRINK)
    pm = models.DenseLLM(cfg, dtype="float32", device="cpu")
    pp = pm.init_params(torch.Generator().manual_seed(0))
    md = port.MegaDecoder.from_dense(pm, pp, max_cache=MAX_CACHE,
                                     prompt_len=P, prefill_chunk=CHUNK,
                                     device="cpu")
    w = md._prog_decode.weights
    gu = pp["layers"]["w_gate_up"][1]
    inter = cfg.intermediate_size
    assert w["l1.w_gate"].data_ptr() == gu.data_ptr()
    assert w["l1.w_up"].data_ptr() == gu[:, inter:].data_ptr()
    assert w["l1.w_up"].stride(0) == 2 * inter
    for n, c in md._prog_prefill.caches.items():
        assert md._prog_decode.caches[n] is c
    with pytest.raises(ValueError, match="max_cache"):
        port.MegaDecoder.from_dense(pm, pp, max_cache=15, prompt_len=13,
                                    prefill_chunk=8, device="cpu")


def test_megadecoder_sampling_in_top_k_and_reproducible():
    cfg = models.get_config("Qwen/Qwen3-0.6B").tiny(**SHRINK)
    pm = models.DenseLLM(cfg, dtype="float32", device="cpu")
    pp = pm.init_params(torch.Generator().manual_seed(1))
    md = port.MegaDecoder.from_dense(pm, pp, max_cache=MAX_CACHE,
                                     prompt_len=P, prefill_chunk=CHUNK,
                                     device="cpu")
    seen = []
    real = md._pick

    def spy(row, gen, temp, **kw):
        tok = real(row, gen, temp, **kw)
        seen.append((row.reshape(-1).float() @ pp["lm_head"].float(), tok))
        return tok

    md._pick = spy
    k = 3
    a = md.serve(_prompt(), 8, temperature=1.5, top_k=k, seed=7)
    for logits, tok in seen:
        assert int(tok) in logits.topk(k).indices.tolist()
    del md._pick
    np.testing.assert_array_equal(
        a, md.serve(_prompt(), 8, temperature=1.5, top_k=k, seed=7))
    greedy = md.serve(_prompt(), 8)
    np.testing.assert_array_equal(
        greedy, md.serve(_prompt(), 8, temperature=1.0, top_k=1, seed=3))
    with pytest.raises(ValueError, match="top_k"):
        md.serve(_prompt(), 2, temperature=1.0, top_k=0)
    with pytest.raises(ValueError, match="gen_len"):
        md.serve(_prompt(), 0)


# -- (h) what this slice does not run -------------------------------------------

_MS = dict(b_max=1, max_len=16, block=8, num_blocks=2)


def _tiny_dense():
    m = models.DenseLLM(models.get_config("Qwen/Qwen3-0.6B").tiny(**SHRINK),
                        dtype="float32", device="cpu")
    return m, m.init_params(torch.Generator().manual_seed(0))


def _tiny_moe():
    return models.Qwen3MoE(models.get_config("Qwen/Qwen3-30B-A3B").tiny(
        num_layers=2), dtype="float32", device="cpu")


_MOE_SERVE = dict(b_slots=1, slot_rows=1, hidden=64, moe_intermediate=64,
                  num_experts=4, top_k=2, num_layers=1, num_heads=4,
                  num_kv_heads=2, head_dim=16, num_blocks=2, block=8,
                  max_pages=2)


@pytest.mark.parametrize("call,slice_", [
    (lambda mb, h: mb.all_to_all(h), "6"),
    (lambda mb, h: tmodels.build_qwen3_moe_serve_batched(
        **_MOE_SERVE, tp_shards=True), "6"),
    (lambda mb, h: tmodels.build_qwen3_moe_serve_batched(
        **_MOE_SERVE, mesh=object()), "6"),
    (lambda mb, h: tdecoder.moe_weight_map(
        dataclasses.make_dataclass("M", [("n", int)])(2), None), "6"),
    (lambda mb, h: mb.compile("kernel", device="cpu", fuse_collective=True),
     "6"),
    (lambda mb, h: mb.verify(), "7"),
    (lambda mb, h: mb.compile("kernel", device="cpu").profile_tasks({}, {}),
     "7"),
    (lambda mb, h: __import__(
        "triton_distributed_tpu_torch.tools.mk_ledger",
        fromlist=["main"]).main([]), "7"),
])
def test_out_of_scope_raises_naming_its_slice(call, slice_):
    mb = tbuilder.ModelBuilder()
    h = mb.input("x", (1, 64))
    with pytest.raises(NotImplementedError, match=f"slice {slice_}"):
        call(mb, h)


def test_megakernel_at_n_ranks_is_built_or_refused_by_jaxs_rules():
    """What slice 6d runs (the cases tests/test_torch_mega_tp*.py hold to
    JAX): an all_reduce node, the tp_shards builders over a RankGroup,
    and MegaServe / ServeEngine(mode="megakernel") at n ranks; and the JAX
    ValueErrors where the rank counts disagree or the model is MoE."""
    mb = tbuilder.ModelBuilder(mesh=mk_mesh.RankGroup(2))
    h = mb.all_reduce(mb.input("x", (1, 64)))
    assert mb.graph.nodes[-1].op == "all_reduce" and h.shape == (1, 64)
    dec = tmodels.build_qwen3_decode(seq_len=1, **TINY, tp_shards=True)
    assert sum(nd.op == "all_reduce" for nd in dec.graph.nodes) == \
        2 * TINY["num_layers"]
    with pytest.raises(ValueError, match="sharded over the same ranks"):
        mk.MegaServe(*_tiny_dense(), **_MS, tp_ranks=2)
    with pytest.raises(ValueError, match="sharded over the same ranks"):
        mk.MegaServe(_tiny_moe(), None, **_MS, tp_ranks=2)
    with pytest.raises(ValueError, match="mesh rank"):
        models.ServeEngine(_tiny_moe(), None, mode="megakernel", tp_ranks=2)
    with pytest.raises(ValueError, match="dense_weight_map_tp"):
        tdecoder.dense_weight_map(
            dataclasses.make_dataclass("M", [("n", int)])(2), None)


def test_refusals_and_devices():
    cfg = models.get_config("Qwen/Qwen3-0.6B").tiny(**SHRINK)
    pm = models.DenseLLM(cfg, dtype="float32", device="cpu")
    pp = pm.init_params(torch.Generator().manual_seed(0))
    kw = dict(max_cache=MAX_CACHE, prompt_len=P)
    for bad in ({"tile_m": 8}, {"tile_n": 128}, {"n_cores": 2}):
        with pytest.raises(TypeError):
            port.MegaDecoder.from_dense(pm, pp, device="cpu", **kw, **bad)
    # the fusion flags build a fused decode program (the prefill program
    # stays unfused), and from_dense passes them on
    md = port.MegaDecoder.from_dense(pm, pp, device="cpu", **kw,
                                     fuse_elementwise=True)
    assert md.fuse_elementwise and not md.fuse_kv_append
    assert {nd.op for nd in md._prog_decode.fused_away} == \
        {"rms_norm", "silu_mul", "add"}
    assert md._prog_prefill.fused_away == []
    assert len(md._prog_decode.tasks) == 8 * cfg.num_layers + 1
    with pytest.raises(ValueError, match="'kernel'"):
        port.MegaDecoder.from_dense(pm, pp, device="cpu", backend="pallas",
                                    **kw)
    mb = tmodels.build_qwen3_decode(seq_len=1, **TINY, kv_append=True)
    with pytest.raises(ValueError, match="'graph'"):
        mb.compile("xla")
    with pytest.raises(TypeError):
        mb.compile("kernel", device="cpu", tile_m=8)
    with pytest.raises(ValueError, match="cache_len"):
        mb.compile("kernel", device="cpu").run(
            *tmodels.init_random_io(mb, np.random.default_rng(0)),
            {"cache_len": 32})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port.MegaDecoder.from_dense(pm, pp, **kw)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mb.compile("kernel")
    assert port.MegaDecoder is mk.MegaDecoder
    assert port.Engine is models.Engine


def test_teacher_forced_rows_give_the_greedy_tokens():
    cfg = models.get_config("Qwen/Qwen3-0.6B").tiny(**SHRINK)
    pm = models.DenseLLM(cfg, dtype="float32", device="cpu")
    pp = pm.init_params(torch.Generator().manual_seed(2))
    md = port.MegaDecoder.from_dense(pm, pp, max_cache=MAX_CACHE,
                                     prompt_len=P, prefill_chunk=CHUNK,
                                     device="cpu")
    toks = md.serve(_prompt(), 6)
    rows = md.teacher_forced(_prompt(), toks[:-1])
    assert rows.shape == (6, SHRINK["hidden_size"])
    picked = (rows @ pp["lm_head"].float()).argmax(-1).numpy()
    np.testing.assert_array_equal(picked, toks)


def test_task_costs_count_each_operand_once():
    mb = tmodels.build_qwen3_decode(seq_len=1, **TINY, qk_norm=True,
                                    kv_append=True)
    prog = mb.compile("kernel", device="cpu", n_sm=4)
    cl, item = 11, 4
    costs = prog.task_costs(cl)
    lin = [(nd, c) for nd, c in zip(prog.tasks, costs) if nd.op == "linear"]
    w_bytes = sum(nd.inputs[1].rows * nd.inputs[1].cols * item
                  for nd, _ in lin)
    assert w_bytes == sum(h.rows * h.cols * item
                          for n, h in mb.graph.weights.items()
                          if n.split(".")[-1].startswith("w_"))
    assert sum(c["flops"] for _, c in lin) == 2 * w_bytes // item
    att = [c for nd, c in zip(prog.tasks, costs)
           if nd.op == "attention_kv"]
    H, Hkv, D = TINY["num_heads"], TINY["num_kv_heads"], TINY["head_dim"]
    assert all(c["flops"] == 4 * (cl + 1) * H * D for c in att)
    assert all(c["bytes"] == ((H + 2 * Hkv) * D + 2 * cl * Hkv * D
                              + H * D) * item for c in att)


def test_plain_walk_of_the_forward_graph_matches_golden():
    """The cacheless `attention` op through the kernel's descriptors:
    the whole-forward graph's plain queue walk equals the golden
    executor."""
    kw = {k: v for k, v in TINY.items() if k != "max_cache"}
    mb = tmodels.build_qwen3_forward(seq_len=8, **kw)
    ins, ws = tmodels.init_random_io(mb, np.random.default_rng(6))
    got = mb.compile("kernel", device="cpu", n_sm=4).run(ins, ws)[0]
    ref = mb.compile("graph").run(ins, ws)[0]
    assert _rel(got.numpy(), ref.numpy()) <= 1e-5
