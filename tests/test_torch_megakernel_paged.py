"""The port's paged megakernel ops (attention_paged, kv_append_paged) and
MegaServe's pool helpers against the JAX package, on the CPU.

The batched serving graphs must equal the JAX builder's node for node.
On seeded numpy inputs, with a shuffled block table holding per-slot
trash pages and per-slot lengths 0, 1, block - 1, block and
2 * block + 5, the port's golden executor agrees with the JAX
`ExecutorXLA` within 1e-5 of the largest reference value in f32
(summation order), and the kernel's plain queue walk with the golden
executor within the same 1e-5, in any queue order. Every pool row other
than the appended ones is bitwise unchanged. `kernel_table` and
`handoff` must equal a numpy reference exactly, for bf16, int8 and fp8
engine pools (the dequantizing copy through the port's
`wire.dequant_blockwise`).
"""

import jax
import numpy as np
import pytest
import torch

from triton_distributed_tpu.megakernel import models as jmodels
from triton_distributed_tpu_torch import models
from triton_distributed_tpu_torch.megakernel import MegaServe
from triton_distributed_tpu_torch.megakernel import models as tmodels
from triton_distributed_tpu_torch.ops import wire

BLOCK, NUM_BLOCKS = 8, 10
LENS = (0, 1, BLOCK - 1, BLOCK, 2 * BLOCK + 5)
DIMS = dict(b_slots=len(LENS), hidden=64, intermediate=128, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=16,
            num_blocks=NUM_BLOCKS, block=BLOCK, max_pages=4)
SHRINK = dict(hidden_size=64, num_heads=4, num_kv_heads=2, head_dim=16,
              vocab_size=128, intermediate_size=128)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _graph_key(g):
    nodes = [(n.op, tuple(h.idx for h in n.inputs), n.out.idx, n.out.shape,
              n.attrs) for n in g.nodes]
    names = [{k: h.idx for k, h in d.items()}
             for d in (g.inputs, g.weights, g.caches)]
    return nodes, names, [h.idx for h in g.outputs]


@pytest.mark.parametrize("qk_norm", [True, False])
@pytest.mark.parametrize("slot_rows", [1, 8])
def test_serve_graphs_match_jax(slot_rows, qk_norm):
    kw = dict(DIMS, slot_rows=slot_rows, qk_norm=qk_norm)
    t = tmodels.build_qwen3_serve_batched(**kw).graph
    assert _graph_key(t) == \
        _graph_key(jmodels.build_qwen3_serve_batched(**kw).graph)
    paged = [n for n in t.nodes if n.op in ("attention_paged",
                                            "kv_append_paged")]
    assert len(paged) == 3 * DIMS["num_layers"]
    for n in paged:
        assert (n.attrs["block"], n.attrs["max_pages"], n.attrs["slot_rows"],
                n.attrs["cache_len_name"]) == (BLOCK, 4, slot_rows,
                                               "cache_len_s")


def _table(rng):
    """A shuffled table: each slot's needed pages drawn from a permutation
    of the shared pages, its other columns on its own trash page."""
    nb, mp = len(LENS), DIMS["max_pages"]
    perm = iter(rng.permutation(NUM_BLOCKS))
    tbl = np.empty((nb, mp), np.int32)
    for b, cl in enumerate(LENS):
        need = cl // BLOCK + 1 if cl else 0    # length 0: an idle slot
        for c in range(mp):
            tbl[b, c] = next(perm) if c < need else NUM_BLOCKS + b
    return tbl


def _graphs(slot_rows):
    """The one-layer serve graph in both packages with the pool appends
    exposed as outputs (as the JAX executor returns them). One layer:
    the JAX side runs its attention partials as interpret-mode Pallas,
    ~1 s of compile per slot and layer."""
    out = []
    for mod in (tmodels, jmodels):
        mb = mod.build_qwen3_serve_batched(**dict(DIMS, num_layers=1),
                                           slot_rows=slot_rows,
                                           qk_norm=True)
        for nd in mb.graph.nodes:
            if nd.op == "kv_append_paged":
                mb.graph.outputs.append(nd.out)
        out.append(mb)
    return out


@pytest.fixture(scope="module")
def jax_runs():
    """JAX ExecutorXLA outputs of the 1-layer serve graph at slot_rows 1
    and 8 on seeded inputs (pad rows of x zero), one shuffled table."""
    runs = {}
    for R in (1, 8):
        tmb, jmb = _graphs(R)
        rng = np.random.default_rng(R)
        ins, ws = jmodels.init_random_io(jmb, rng)
        pad = np.ones(ins["x"].shape[0], bool)
        pad[::R] = False
        ins["x"][pad] = 0.0
        tbl = _table(rng)
        scalars = {f"cache_len_s{b}": cl for b, cl in enumerate(LENS)}
        outs = jmb.compile("xla").run(ins, ws, scalars, block_table=tbl)
        runs[R] = (tmb, ins, ws, tbl, scalars,
                   [np.asarray(jax.device_get(o)) for o in outs])
    return runs


def _appended_rows(tbl):
    return [int(tbl[b, cl // BLOCK]) * BLOCK + cl % BLOCK
            for b, cl in enumerate(LENS)]


def _check_pools(outs, ins, tbl):
    """Every pool row other than the appended ones equals the input."""
    keep = np.ones(ins["l0.k_pool"].shape[0], bool)
    keep[_appended_rows(tbl)] = False
    pools = [n for n in ins if n.endswith("_pool")]
    for name, got in zip(pools, outs):
        assert np.array_equal(np.asarray(got)[keep], ins[name][keep]), name


@pytest.mark.parametrize("R", [1, 8])
def test_golden_executor_matches_jax(jax_runs, R):
    tmb, ins, ws, tbl, scalars, ref = jax_runs[R]
    got = tmb.compile("graph").run(ins, ws, scalars, block_table=tbl)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert _rel(g.numpy(), r) <= 1e-5
    # the step leaves the pad rows of the trunk exactly 0, and appends
    # nowhere but at each slot's row cache_len_b
    out = got[0].numpy()
    assert (out[np.arange(out.shape[0]) % R != 0] == 0).all()
    _check_pools([o.numpy() for o in got[1:]], ins, tbl)
    _check_pools(ref[1:], ins, tbl)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n_sm", [3, 132])
@pytest.mark.parametrize("R", [1, 8])
def test_plain_walk_matches_golden(jax_runs, R, n_sm, seed):
    tmb, ins, ws, tbl, scalars, ref = jax_runs[R]
    gold = tmb.compile("graph").run(ins, ws, scalars, block_table=tbl)
    prog = tmb.compile("kernel", device="cpu", n_sm=n_sm)
    assert prog.n_tiles[[nd.op == "attention_paged"
                         for nd in prog.tasks]].tolist() == \
        [len(LENS) * DIMS["num_kv_heads"]]
    prog.bind_weights({k: torch.from_numpy(v) for k, v in ws.items()})
    prog.bind_caches({k: torch.from_numpy(ins[k].copy())
                      for k in tmb.graph.caches})
    outs = prog.step({"x": torch.from_numpy(ins["x"])},
                     cache_lens=np.asarray(LENS), block_table=tbl,
                     plain=True, seed=seed)
    assert len(outs) == len(gold)
    for a, g in zip(outs, gold):
        assert _rel(a.numpy(), g.numpy()) <= 1e-5
    assert (outs[0].numpy()[np.arange(len(LENS) * R) % R != 0] == 0).all()
    _check_pools([o.numpy() for o in outs[1:]], ins, tbl)


def test_paged_step_refusals():
    tmb, _ = _graphs(1)
    prog = tmb.compile("kernel", device="cpu", n_sm=4)
    _, ws = tmodels.init_random_io(tmb, np.random.default_rng(0))
    prog.bind_weights({k: torch.from_numpy(v) for k, v in ws.items()})
    tbl = _table(np.random.default_rng(0))
    lens = np.asarray(LENS)
    with pytest.raises(ValueError, match="cache_lens and block_table"):
        prog.step()
    with pytest.raises(ValueError, match="per-slot"):
        prog.step(cache_len=3, cache_lens=lens, block_table=tbl)
    with pytest.raises(ValueError, match=r"\[0, 32\)"):
        prog.step(cache_lens=lens + 11, block_table=tbl)
    bad = tbl.copy()
    bad[4, 1] = -1                      # a page slot 4 reads
    with pytest.raises(ValueError, match="outside the pool"):
        prog.step(cache_lens=lens, block_table=bad)
    bad = tbl.copy()
    bad[2, 0] = bad[4, 2]               # slot 2 reads where slot 4 appends
    with pytest.raises(ValueError, match="another slot"):
        prog.step(cache_lens=lens, block_table=bad)
    with pytest.raises(ValueError, match="no paged node"):
        tmodels.build_qwen3_decode(
            seq_len=1, hidden=64, intermediate=128, num_layers=1,
            num_heads=4, num_kv_heads=2, head_dim=16, max_cache=16,
            kv_append=True).compile("kernel", device="cpu").step(
            block_table=tbl)


def test_task_costs_count_the_rows_each_slot_reads():
    tmb, _ = _graphs(8)
    prog = tmb.compile("kernel", device="cpu", n_sm=4)
    costs = prog.task_costs(cache_lens=np.asarray(LENS))
    H, Hkv, D, item = 4, 2, 16, 4
    att = [c for nd, c in zip(prog.tasks, costs)
           if nd.op == "attention_paged"]
    assert all(c["flops"] == 4 * sum(cl + 1 for cl in LENS) * H * D
               for c in att)
    assert all(c["bytes"] == (len(LENS) * (H + 2 * Hkv) * D
                              + 2 * sum(LENS) * Hkv * D
                              + len(LENS) * 8 * H * D) * item for c in att)
    app = [c for nd, c in zip(prog.tasks, costs)
           if nd.op == "kv_append_paged"]
    assert [c["bytes"] for c in app] == [2 * len(LENS) * Hkv * D * item] * 2


# -- MegaServe's pool helpers -------------------------------------------------

@pytest.fixture(scope="module")
def tiny_model():
    cfg = models.get_config("Qwen/Qwen3-8B").tiny(**SHRINK)
    m = models.DenseLLM(cfg, dtype="float32", device="cpu")
    return m, m.init_params(torch.Generator().manual_seed(0))


def test_kernel_table_routes_idle_slots_and_holes_to_trash(tiny_model):
    ms = MegaServe(*tiny_model, b_max=3, max_len=32, block=8, num_blocks=6)
    tbl = np.asarray([[4, 1, -1, -1], [0, 2, 3, -1], [5, -1, -1, -1]],
                     np.int32)
    mask = np.asarray([True, False, True])
    want = np.where(mask[:, None] & (tbl >= 0), tbl,
                    6 + np.arange(3)[:, None])
    got = ms.kernel_table(torch.from_numpy(tbl), torch.from_numpy(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kv_dtype", [None, "int8", "float8_e4m3fn"])
def test_handoff_matches_numpy_reference(kv_dtype):
    """A bf16 model: a bf16 engine pool copies bit for bit, an int8 or
    fp8 one is dequantized to bf16."""
    cfg = models.get_config("Qwen/Qwen3-8B").tiny(**SHRINK)
    m = models.DenseLLM(cfg, dtype="bfloat16", device="cpu")
    p = m.init_params(torch.Generator().manual_seed(0))
    ms = MegaServe(m, p, b_max=2, max_len=32, block=8, num_blocks=6)
    cache = m.new_paged_kv_cache(2, 32, block=8, num_blocks=6,
                                 kv_dtype=kv_dtype)
    gen = torch.Generator().manual_seed(3)
    for pool, scales in ((cache.k_pool, cache.k_scales),
                         (cache.v_pool, cache.v_scales)):
        vals = torch.randn(pool.shape, generator=gen)
        if kv_dtype is None:
            pool.copy_(vals)
        else:
            q, s = wire.quant_blockwise(vals, kv_dtype, cfg.head_dim)
            pool.copy_(q)
            scales.copy_(s[..., 0])
    cache.block_table[1] = [3, 0, 5, -1]
    assert ms.k_pool.dtype == torch.bfloat16
    ms.k_pool.fill_(7.0)
    ms.v_pool.fill_(7.0)
    ms.handoff(cache, 1)
    L, hkv, d = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    for pool, scales, got in ((cache.k_pool, cache.k_scales, ms.k_pool),
                              (cache.v_pool, cache.v_scales, ms.v_pool)):
        want = np.full(got.shape, 7.0, np.float32).reshape(L, 8, 8, hkv * d)
        for col, page in enumerate([3, 0, 5, -1]):
            src = max(page, 0)
            rows = pool[:, src]                      # (L, Hkv, blk, D)
            if scales is not None:
                rows = wire.dequant_blockwise(
                    rows, scales[:, src][..., None], torch.bfloat16)
            dst = page if page >= 0 else 6 + 1       # slot 1's trash page
            want[:, dst] = rows.float().numpy().transpose(0, 2, 1, 3) \
                .reshape(L, 8, hkv * d)
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.reshape(got.shape))
