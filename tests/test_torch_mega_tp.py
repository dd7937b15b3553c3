"""The port's n-rank megakernel programs (a graph with all_reduce nodes over
a RankGroup of n ranks, megakernel/executor_cuda.py and executor_torch.py)
against the JAX package's `compile(backend="xla").run_sharded` on 2- and
4-device CPU meshes, f32, at a tiny width with 4 kv heads (so it splits at
n = 4):

- the `tp_shards=True` builders give the JAX graphs node for node, and
  `init_random_io(stack=n)` the JAX arrays;
- the decode and forward graphs through the golden `run_sharded` and the
  kernel program's plain walk at n ranks agree with JAX within 1e-5 of the
  largest value, and the walk gives the same bits in any queue order;
- an all_reduce-only graph at n = 2, 4 and 8: the plain walk equal to the
  golden `RankGroup.psum` bit for bit in f32 and bf16;
- `dense_weight_map_tp` equal to JAX's array for array;
- Qwen3-8B's serve program at n = 4 fits the scheduler's packing;
- the refusals: run_sharded / step_fn_sharded of a one-rank graph, the
  rank group's type, the fused arms and `fuse_collective` on an n-rank
  program, and MegaServe's guards at n ranks (JAX's ValueErrors, MoE
  included).

The JAX side runs jitted in a module fixture; its attention partials run
in the plain Pallas interpreter (no DMA or semaphore in them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_distributed_tpu import runtime as jruntime
from triton_distributed_tpu.megakernel import decoder as jdecoder
from triton_distributed_tpu.megakernel import models as jmodels
from triton_distributed_tpu.models import DenseLLM as JaxDenseLLM
from triton_distributed_tpu.models import config as jax_config
from triton_distributed_tpu.ops import attention as jattn
from triton_distributed_tpu_torch import models
from triton_distributed_tpu_torch import megakernel as mk
from triton_distributed_tpu_torch.megakernel import builder as tbuilder
from triton_distributed_tpu_torch.megakernel import decoder as tdecoder
from triton_distributed_tpu_torch.megakernel import models as tmodels
from triton_distributed_tpu_torch.megakernel import scheduler
from triton_distributed_tpu_torch.parallel.mesh import RankGroup

TP_TINY = dict(hidden=64, intermediate=128, num_layers=2, num_heads=4,
               num_kv_heads=4, head_dim=16)
TP_SHRINK = dict(hidden_size=64, intermediate_size=96, num_heads=4,
                 num_kv_heads=4, head_dim=16, vocab_size=128)


class PlainInterpreter:
    """The JAX package's runtime module, with the plain Pallas interpreter
    for the kernels of ops/attention.py (no DMA or semaphore in them)."""

    def __getattr__(self, name):
        return getattr(jruntime, name)

    @staticmethod
    def interpret_params(**kwargs):
        return True


@pytest.fixture(scope="module", autouse=True)
def plain_attention_interpreter():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jattn, "runtime", PlainInterpreter())
        yield
    jax.clear_caches()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _graph_key(g):
    nodes = [(n.op, tuple(h.idx for h in n.inputs), n.out.idx, n.out.shape,
              n.attrs) for n in g.nodes]
    names = [{k: h.idx for k, h in d.items()}
             for d in (g.inputs, g.weights, g.caches)]
    return nodes, names, [h.idx for h in g.outputs]


def _build(mod, kind, n, mesh=None):
    local = dict(TP_TINY, num_heads=4 // n, num_kv_heads=4 // n,
                 intermediate=128 // n)
    if kind == "decode":
        return mod.build_qwen3_decode(seq_len=1, **local, max_cache=32,
                                      qk_norm=True, mesh=mesh,
                                      tp_shards=True)
    if kind == "forward":
        return mod.build_qwen3_forward(seq_len=8, **local, mesh=mesh,
                                       tp_shards=True)
    local.pop("intermediate")
    return mod.build_qwen3_serve_batched(
        b_slots=2, slot_rows=1, intermediate=128 // n, num_blocks=4,
        block=8, max_pages=2, qk_norm=True, mesh=mesh, tp_shards=True,
        **local)


@pytest.mark.parametrize("kind", ["decode", "forward", "serve"])
@pytest.mark.parametrize("n", [2, 4])
def test_tp_builders_match_jax(kind, n):
    tmb = _build(tmodels, kind, n, RankGroup(n))
    jmb = _build(jmodels, kind, n)
    assert _graph_key(tmb.graph) == _graph_key(jmb.graph)
    ars = [nd for nd in tmb.graph.nodes if nd.op == "all_reduce"]
    assert len(ars) == 2 * TP_TINY["num_layers"]
    assert tmb.num_ranks == n and tmb.mesh.n == n


@pytest.mark.parametrize("n", [2, 4])
def test_init_random_io_stack_matches_jax(n):
    ti, tw = tmodels.init_random_io(_build(tmodels, "decode", n),
                                    np.random.default_rng(3), stack=n)
    ji, jw = jmodels.init_random_io(_build(jmodels, "decode", n),
                                    np.random.default_rng(3), stack=n)
    for a, b in ((ti, ji), (tw, jw)):
        assert list(a) == list(b)
        for k in a:
            assert a[k].shape[0] == n
            np.testing.assert_array_equal(a[k], b[k])
    # the row-parallel shards differ by rank, the rest is replicated
    assert not np.array_equal(tw["l0.w_o"][0], tw["l0.w_o"][1])
    np.testing.assert_array_equal(tw["l0.w_qkv"][0], tw["l0.w_qkv"][1])


@pytest.fixture(scope="module")
def jax_sharded():
    """JAX ExecutorXLA.run_sharded of the decode (S 1, cache_len 11) and
    forward (S 8) graphs at n = 2 and 4, on init_random_io(stack=n)."""
    runs = {}
    for n in (2, 4):
        mesh = Mesh(np.asarray(jax.devices()[:n]), ("tp",))
        for kind, scal in (("decode", {"cache_len": 11}), ("forward", None)):
            jmb = _build(jmodels, kind, n, mesh)
            ins, ws = jmodels.init_random_io(jmb, np.random.default_rng(n),
                                             stack=n)
            outs = jmb.compile("xla").run_sharded(ins, ws, scalars=scal)
            runs[kind, n] = (ins, ws, scal, [np.asarray(o) for o in outs])
    return runs


@pytest.mark.parametrize("kind", ["decode", "forward"])
@pytest.mark.parametrize("n", [2, 4])
def test_golden_run_sharded_matches_jax(jax_sharded, kind, n):
    ins, ws, scal, ref = jax_sharded[kind, n]
    tmb = _build(tmodels, kind, n, RankGroup(n))
    got = tmb.compile("graph").run_sharded(ins, ws, scal)
    assert len(got) == len(ref) == 1
    assert got[0].shape == ref[0].shape
    assert _rel(got[0].numpy(), ref[0]) <= 1e-5


@pytest.mark.parametrize("n_sm", [4, 132])
@pytest.mark.parametrize("kind", ["decode", "forward"])
@pytest.mark.parametrize("n", [2, 4])
def test_plain_walk_at_n_ranks_matches_jax(jax_sharded, kind, n, n_sm):
    ins, ws, scal, ref = jax_sharded[kind, n]
    tmb = _build(tmodels, kind, n, RankGroup(n))
    prog = tmb.compile("kernel", device="cpu", n_sm=n_sm)
    # one task a node (two an all_reduce), n x one rank's tiles
    assert prog.sharded and prog.n_ranks == n
    assert all(t["tiles"] == n * t["tpr"] for t in prog.tiling)
    runs = []
    for seed in (0, 1):
        prog.bind_weights({k: torch.from_numpy(v) for k, v in ws.items()})
        prog.bind_caches({k: torch.from_numpy(ins[k].copy())
                          for k in tmb.graph.caches})
        step = prog.step_fn_sharded()
        out = step({"x": torch.from_numpy(ins["x"])},
                   (scal or {}).get("cache_len", 0), seed=seed)[0]
        runs.append(out.clone())
    assert torch.equal(runs[0], runs[1])
    assert _rel(runs[0].numpy(), ref[0]) <= 1e-5
    # run_sharded is the same program once, its outputs copied out
    again = prog.run_sharded(ins, ws, scal)[0]
    assert torch.equal(again, runs[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_all_reduce_graph_plain_walk_equals_psum_bitwise(n, dtype):
    """input -> linear -> all_reduce -> add -> all_reduce at the trunk's
    shapes of 4 slots x 1 and x 8 rows: the plain walk (pushes into the
    landing blocks, then the rank-order sum) equal to the golden psum bit
    for bit."""
    for rows in (4, 32):
        mb = tbuilder.ModelBuilder(mesh=RankGroup(n), dtype=dtype)
        x = mb.input("x", (rows, 64))
        h = mb.all_reduce(mb.linear(x, mb.weight("w", (64, 64))))
        mb.output(mb.all_reduce(mb.add(h, x)))
        ins, ws = tmodels.init_random_io(mb, np.random.default_rng(rows),
                                         stack=n)
        ins["x"] = np.random.default_rng(1).normal(
            size=(n, rows, 64)).astype(np.float32)      # per-rank partials
        gold = mb.compile("graph").run_sharded(ins, ws)[0]
        prog = mb.compile("kernel", device="cpu", n_sm=5)
        got = prog.run_sharded(ins, ws)[0]
        assert got.dtype == dtype and torch.equal(got, gold)
        assert [t["op"] for t in prog.tiling].count(5) == 4   # TASK_AR
        # the landing block of each AR node holds the peers' partials
        land = prog._views[("land", mb.graph.nodes[3].out.idx)]
        assert land.shape == (n, n * rows, 64)


def test_plain_walk_names_a_lost_all_reduce_push():
    """A queue in which an AR sum runs before the pushes it sums (its
    dependency on phase 0 taken out, its tiles moved first): the walk
    finds the peer's signal missing and raises naming it."""
    mb = tbuilder.ModelBuilder(mesh=RankGroup(2))
    mb.output(mb.all_reduce(mb.input("x", (4, 64))))
    prog = mb.compile("kernel", device="cpu", n_sm=1)
    assert [nd.op for nd in prog.tasks] == ["all_reduce"] * 2
    prog.deps[1] = []
    q = prog.queues[0, :prog.qlen[0]]
    prog.queues[0, :prog.qlen[0]] = q[np.argsort((q >> 20) != 1,
                                                 kind="stable")]
    ins, ws = tmodels.init_random_io(mb, np.random.default_rng(0), stack=2)
    with pytest.raises(RuntimeError, match="never saw the push of rank"):
        prog.run_sharded(ins, ws)


@pytest.mark.parametrize("n", [2, 4])
def test_dense_weight_map_tp_equals_jax(n):
    cfg = jax_config.get_config("Qwen/Qwen3-8B").tiny(**TP_SHRINK)
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("tp",))
    jm = JaxDenseLLM(cfg, mesh=mesh, mode="ar", dtype=jnp.float32)
    jp = jm.init_params(jax.random.PRNGKey(0))
    jw, jembed, jlm = jdecoder.dense_weight_map_tp(jm, jp)
    pm = models.DenseLLM(models.get_config("Qwen/Qwen3-8B").tiny(**TP_SHRINK),
                         mode="ar", dtype="float32", device="cpu",
                         num_ranks=n)
    pp = models.params_from_jax(jax.device_get(jp), device="cpu",
                                num_ranks=n)
    tw, tembed, tlm = tdecoder.dense_weight_map_tp(pm, pp)
    assert list(tw) == list(jw)
    for k in tw:
        assert tuple(tw[k].shape) == jw[k].shape, k
        np.testing.assert_array_equal(tw[k].numpy(), jw[k])
    np.testing.assert_array_equal(tembed.numpy(), jembed)
    # the port keeps the lm_head rank-stacked, (n, hidden, V / n)
    np.testing.assert_array_equal(torch.cat(list(tlm), dim=1).numpy(), jlm)
    # views of the model's parameters, the norms expanded (rank stride 0)
    assert tw["l0.w_o"].data_ptr() == pp["layers"]["w_o"][0].data_ptr()
    assert tw["l0.ln1"].stride(0) == 0
    with pytest.raises(ValueError, match="dense_weight_map_tp"):
        tdecoder.dense_weight_map(pm, pp)


def test_qwen3_8b_serve_program_at_4_ranks_fits_the_packing():
    """Qwen3-8B's batched serve program at n = 4 (local widths 8 / 2
    heads, intermediate 3072): one task a node and two an all_reduce, 36
    x (13 + 4) + 1 = 613 tasks of n x one rank's tiles, within the
    scheduler's packing (task << 20 | tile)."""
    for slot_rows in (1, 8):
        mb = tmodels.build_qwen3_serve_batched(
            b_slots=4, slot_rows=slot_rows, hidden=4096, intermediate=3072,
            num_layers=36, num_heads=8, num_kv_heads=2, head_dim=128,
            num_blocks=64, block=128, max_pages=16, qk_norm=True,
            mesh=RankGroup(4), tp_shards=True, dtype=torch.bfloat16)
        prog = mb.compile("kernel", device="cpu")
        assert len(prog.tasks) == 36 * (13 + 4) + 1 == 613
        assert len(prog.tasks) <= scheduler.MAX_TASKS
        assert prog.n_tiles.max() < 1 << scheduler.TILE_BITS
        task, _ = scheduler.unpack(prog.queues[prog.qlen > 0, 0].max())
        assert task < len(prog.tasks)
        ars = [t for t, nd in enumerate(prog.tasks) if nd.op == "all_reduce"]
        assert len(ars) == 4 * 36
        assert all(prog.tiling[t]["tpr"] == 4 * slot_rows for t in ars)
        # phase 1 of an AR node waits on its phase 0
        assert all(t in prog.deps[t + 1] for t in ars[::2])


def test_one_rank_graphs_refuse_the_sharded_entries():
    """What a graph without all_reduce nodes refuses (JAX's ValueError of
    run_sharded), and what a graph with them refuses in the golden
    executor's run()."""
    mb = tbuilder.ModelBuilder()
    mb.output(mb.linear(mb.input("x", (1, 64)), mb.weight("w", (64, 64))))
    with pytest.raises(ValueError, match="requires all_reduce nodes"):
        mb.compile("graph").run_sharded({}, {})
    with pytest.raises(ValueError, match="requires all_reduce nodes"):
        mb.compile("kernel", device="cpu").run_sharded({}, {})
    with pytest.raises(ValueError, match="requires all_reduce nodes"):
        mb.compile("kernel", device="cpu").step_fn_sharded()
    tp = tbuilder.ModelBuilder(mesh=RankGroup(2))
    tp.output(tp.all_reduce(tp.input("x", (1, 64))))
    with pytest.raises(ValueError, match="run_sharded"):
        tp.compile("graph").run({"x": np.zeros((1, 64), np.float32)}, {})
    with pytest.raises(TypeError, match="RankGroup"):
        tbuilder.ModelBuilder(mesh=object())
    assert tbuilder.ModelBuilder().num_ranks == 1
    with pytest.raises(ValueError, match="one-rank programs"):
        tp.compile("kernel", device="cpu", fuse_elementwise=True)
    with pytest.raises(NotImplementedError, match="slice 6"):
        tp.compile("kernel", device="cpu", fuse_collective=True)


def test_megaserve_guards_are_jaxs():
    """MegaServe's constructor guards at n ranks, with JAX's ValueErrors:
    a model on another rank count, a MoE model at n ranks."""
    cfg = models.get_config("Qwen/Qwen3-8B").tiny(**TP_SHRINK)
    kw = dict(b_max=1, max_len=16, block=8, num_blocks=2)
    one = models.DenseLLM(cfg, dtype="float32", device="cpu")
    two = models.DenseLLM(cfg, dtype="float32", device="cpu", num_ranks=2)
    for bad in (True, 0, 2.0):
        with pytest.raises(ValueError, match="positive integer"):
            mk.MegaServe(two, None, **kw, tp_ranks=bad)
    with pytest.raises(ValueError, match="sharded over the same ranks"):
        mk.MegaServe(one, None, **kw, tp_ranks=2)
    with pytest.raises(ValueError, match="tp_ranks=model.n"):
        mk.MegaServe(two, None, **kw)
    moe_cfg = models.get_config("Qwen/Qwen3-30B-A3B").tiny(
        hidden_size=64, num_heads=4, num_kv_heads=2, head_dim=16,
        vocab_size=128, num_experts=4, num_experts_per_tok=2,
        moe_intermediate_size=64)
    moe = models.Qwen3MoE(moe_cfg, mode="xla", dtype="float32", device="cpu",
                          num_ranks=2)
    with pytest.raises(ValueError, match="dense-only"):
        mk.MegaServe(moe, None, **kw, tp_ranks=2)
