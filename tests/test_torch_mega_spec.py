"""The megakernel's speculative verify step (the verify-width arms of
ATTN_P, KVA_PK / KVA_PV and GROUPED_GEMM in executor_cuda.py's plain
walk, MegaServe.verify, ServeEngine(mode="megakernel", speculative=...))
against the JAX package and the port's engine path, on the CPU.

- The serve graphs at slot_rows 8 equal the JAX builder's (a verify step
  runs the decode program at other widths, so it has no graph of its
  own), and the kernel's plain queue walk at per-slot widths {0, 1, 3, 8}
  equals the golden executor within 1e-5 of the largest value (f32,
  summation order), with the pad rows of each slot's tile exactly 0 and
  every pool row outside [cache_len_b, cache_len_b + width) bitwise
  unchanged; one slot's candidates land on a page's last rows, another's
  cross a page.
- MegaServe.verify's plain walk gives the greedy predictions of the JAX
  `DenseLLM.verify_step_paged` on the same cache, and its hidden rows lie
  within 1e-5 of the port's engine verify step.
- ServeEngine(mode="megakernel", speculative=SpecConfig(OracleDrafter(
  spec-off outputs, wrong_every=2), k=3, adapt=False)) gives the JAX
  engine-mode spec-off tokens, dense and Qwen3MoE (with and without
  ep_capacity), each tick's widths clamped by the JAX page-room formula
  tile_m - cache_len % tile_m with slot_rows as tile_m.

The JAX megakernel itself (interpret-mode Pallas) is not run here.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_distributed_tpu.megakernel import models as jmodels
from triton_distributed_tpu.megakernel.serve import MegaServe as JaxMegaServe
from triton_distributed_tpu.models import DenseLLM as JaxDenseLLM
from triton_distributed_tpu.models import ServeEngine as JaxServeEngine
from triton_distributed_tpu.models import config as jax_config
from triton_distributed_tpu.models import paged_kv_cache as jpk
from triton_distributed_tpu.models.qwen_moe import Qwen3MoE as JaxQwen3MoE
from triton_distributed_tpu_torch import models
from triton_distributed_tpu_torch.megakernel import MegaServe
from triton_distributed_tpu_torch.megakernel import models as tmodels
from triton_distributed_tpu_torch.megakernel import serve as tmserve
from triton_distributed_tpu_torch.models import dense as tdense
from triton_distributed_tpu_torch.models import paged_kv_cache as tpk
from triton_distributed_tpu_torch.models import serve as tserve

BLOCK, NUM_BLOCKS, R = 8, 10, 8
LENS = (0, 9, 5, 12)                 # slot 0 idle; slot 2 ends its page
WIDTHS = (0, 1, 3, 8)                # slot 3 crosses into its next page
DIMS = dict(b_slots=len(LENS), hidden=64, intermediate=128, num_layers=1,
            num_heads=4, num_kv_heads=2, head_dim=16,
            num_blocks=NUM_BLOCKS, block=BLOCK, max_pages=4)
MOE_DIMS = dict(DIMS, moe_intermediate=64, num_experts=4, top_k=2)
del MOE_DIMS["intermediate"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _graph_key(g):
    nodes = [(n.op, tuple(h.idx for h in n.inputs), n.out.idx, n.out.shape,
              n.attrs) for n in g.nodes]
    names = [{k: h.idx for k, h in d.items()}
             for d in (g.inputs, g.weights, g.caches)]
    return nodes, names, [h.idx for h in g.outputs]


@pytest.mark.parametrize("moe", [False, True])
def test_verify_graphs_equal_jax_at_slot_rows_8(moe):
    name = "build_qwen3_moe_serve_batched" if moe \
        else "build_qwen3_serve_batched"
    kw = dict(MOE_DIMS if moe else DIMS, slot_rows=R, qk_norm=True)
    assert _graph_key(getattr(tmodels, name)(**kw).graph) == \
        _graph_key(getattr(jmodels, name)(**kw).graph)


# -- (a) the plain walk at verify widths ----------------------------------------

def _rows(b):
    """Positions slot b runs this step: max(1, width) of them."""
    return LENS[b] + np.arange(max(1, WIDTHS[b]))


def _table(rng):
    """Each slot's pages (up to its last appended row) from a permutation
    of the pool, its other columns on its own trash page."""
    perm = iter(rng.permutation(NUM_BLOCKS))
    tbl = np.empty((len(LENS), DIMS["max_pages"]), np.int32)
    for b in range(len(LENS)):
        need = _rows(b)[-1] // BLOCK + 1 if WIDTHS[b] else 0
        for c in range(tbl.shape[1]):
            tbl[b, c] = next(perm) if c < need else NUM_BLOCKS + b
    return tbl


def _appended(tbl):
    return np.concatenate([tbl[b, p // BLOCK].astype(np.int64) * BLOCK
                           + p % BLOCK for b in range(len(LENS))
                           for p in (_rows(b),)])


@pytest.fixture(scope="module", params=[False, True], ids=["dense", "moe"])
def verify_case(request):
    moe = request.param
    build = tmodels.build_qwen3_moe_serve_batched if moe \
        else tmodels.build_qwen3_serve_batched
    mb = build(**(MOE_DIMS if moe else DIMS), slot_rows=R, qk_norm=True)
    for nd in mb.graph.nodes:
        if nd.op == "kv_append_paged":
            mb.graph.outputs.append(nd.out)
    rng = np.random.default_rng(3)
    ins, ws = tmodels.init_random_io(mb, rng)
    live = np.zeros(ins["x"].shape[0], bool)
    for b, w in enumerate(WIDTHS):
        live[b * R:b * R + max(1, w)] = True
    ins["x"][~live] = 0.0                       # rows past a count are 0
    tbl = _table(rng)
    scalars = {f"cache_len_s{b}": cl for b, cl in enumerate(LENS)}
    gold = mb.compile("graph").run(ins, ws, scalars, block_table=tbl,
                                   widths=np.maximum(WIDTHS, 1))
    return mb, ins, ws, tbl, live, gold


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n_sm", [3, 132])
def test_plain_walk_at_verify_widths_matches_golden(verify_case, n_sm, seed):
    mb, ins, ws, tbl, live, gold = verify_case
    prog = mb.compile("kernel", device="cpu", n_sm=n_sm)
    prog.bind_weights({k: torch.from_numpy(v) for k, v in ws.items()})
    prog.bind_caches({k: torch.from_numpy(ins[k].copy())
                      for k in mb.graph.caches})
    outs = prog.step({"x": torch.from_numpy(ins["x"])},
                     cache_lens=np.asarray(LENS), block_table=tbl,
                     widths=np.asarray(WIDTHS), plain=True, seed=seed)
    assert len(outs) == len(gold) == 3
    # the idle slot's row routes to no expert in the kernel and to its
    # top-k in the golden executor (ROADMAP Queue C 8): compare the
    # decoding slots' rows of a MoE trunk
    moe = any(nd.op == "moe_ffn" for nd in mb.graph.nodes)
    rows = np.repeat(np.asarray(WIDTHS) > 0, R) if moe \
        else np.ones(len(live), bool)
    assert _rel(outs[0].numpy()[rows], gold[0].numpy()[rows]) <= 1e-5
    for a, g in zip(outs[1:], gold[1:]):
        assert _rel(a.numpy(), g.numpy()) <= 1e-5
    assert (outs[0].numpy()[~live] == 0).all()       # pad rows exactly 0
    keep = np.ones(ins["l0.k_pool"].shape[0], bool)
    keep[_appended(tbl)] = False
    for name, got in zip(("l0.k_pool", "l0.v_pool"), outs[1:]):
        assert np.array_equal(got.numpy()[keep], ins[name][keep]), name
        assert not np.array_equal(got.numpy()[~keep], ins[name][~keep])


def test_verify_width_costs_and_refusals(verify_case):
    mb, ins, ws, tbl, _, _ = verify_case
    prog = mb.compile("kernel", device="cpu", n_sm=4)
    prog.bind_weights({k: torch.from_numpy(v) for k, v in ws.items()})
    lens, wid = np.asarray(LENS), np.asarray(WIDTHS)
    costs = prog.task_costs(cache_lens=lens, widths=wid)
    H, Hkv, D, item = 4, 2, 16, 4
    w = np.maximum(wid, 1)
    att = [c for nd, c in zip(prog.tasks, costs)
           if nd.op == "attention_paged"]
    pairs = int((w * lens + w * (w + 1) // 2).sum())
    assert att[0]["flops"] == 4 * pairs * H * D
    assert att[0]["bytes"] == (int(w.sum()) * (H + 2 * Hkv) * D
                               + 2 * int(lens.sum()) * Hkv * D
                               + len(LENS) * R * H * D) * item
    app = [c for nd, c in zip(prog.tasks, costs)
           if nd.op == "kv_append_paged"]
    assert [c["bytes"] for c in app] == [2 * int(w.sum()) * Hkv * D * item] * 2
    # an append window past the slot's pages, onto a page the slot does
    # not hold, or onto a row another slot reads
    with pytest.raises(ValueError, match=r"\[0, 32\)"):
        prog.step(cache_lens=lens + np.array([0, 0, 0, 13]), block_table=tbl,
                  widths=wid)
    bad = tbl.copy()
    bad[3, 2] = -1                       # slot 3's window reaches column 2
    with pytest.raises(ValueError, match="outside the pool"):
        prog.step(cache_lens=lens, block_table=bad, widths=wid)
    bad = tbl.copy()
    bad[1, 0] = tbl[3, 2]                # slot 1 reads what slot 3 appends
    with pytest.raises(ValueError, match="another slot"):
        prog.step(cache_lens=lens, block_table=bad, widths=wid)
    with pytest.raises(ValueError, match="slot_rows"):
        prog.step(cache_lens=lens, block_table=tbl, widths=wid + 1)


# -- (b) MegaServe.verify against the JAX verify_step_paged --------------------

SHRINK = dict(hidden_size=64, intermediate_size=96, num_heads=4,
              num_kv_heads=2, head_dim=16, vocab_size=128)
VLENS = np.array([3, 5, 9, 6], np.int32)


@pytest.fixture(scope="module")
def dense_pair():
    mesh1 = Mesh(np.asarray(jax.devices()[:1]), ("tp",))
    name = "Qwen/Qwen3-0.6B"
    jm = JaxDenseLLM(jax_config.get_config(name).tiny(**SHRINK), mesh=mesh1,
                     mode="xla", dtype=jnp.float32)
    jp = jm.init_params(jax.random.PRNGKey(0))
    pm = models.DenseLLM(models.get_config(name).tiny(**SHRINK), mode="xla",
                         dtype="float32", device="cpu")
    return mesh1, jm, jp, pm, models.params_from_jax(jax.device_get(jp),
                                                     device="cpu")


def test_mega_verify_gives_jax_verify_step_predictions(dense_pair,
                                                        monkeypatch):
    mesh1, jm, jp, pm, pp = dense_pair
    L, B, blk, nb = pm.config.num_layers, 4, 4, 16
    jc = jpk.PagedKVCache.create(L, B, 24, 2, 16, mesh=mesh1, block=blk,
                                 num_blocks=nb, dtype=jnp.float32)
    tc = tpk.PagedKVCache.create(L, B, 24, 2, 16, block=blk, num_blocks=nb,
                                 dtype=torch.float32, device="cpu")
    for b in range(B):
        jc, _, _ = jc.assign_slot_prefixed(b, n_new=3,
                                           seq_len=int(VLENS[b]))
        tc.assign_slot_prefixed(b, n_new=3, seq_len=int(VLENS[b]))
    rng = np.random.default_rng(1)
    pools = [rng.normal(size=tc.k_pool.shape).astype(np.float32) * 0.5
             for _ in range(2)]
    jc = dataclasses.replace(jc, k_pool=jnp.asarray(pools[0]),
                             v_pool=jnp.asarray(pools[1]))
    tc.k_pool.copy_(torch.from_numpy(pools[0]))
    tc.v_pool.copy_(torch.from_numpy(pools[1]))
    ms = MegaServe(pm, pp, b_max=B, max_len=24, block=blk, num_blocks=nb,
                   slot_rows=R)
    for b in range(B):
        ms.handoff(tc, b)
    K = 3
    cands = rng.integers(0, 128, (B, K)).astype(np.int32)
    counts = np.array([3, 2, 1, 2], np.int32)   # rooms 5, 3, 7, 2
    mask = np.array([True, False, True, True])
    live = (np.arange(K)[None] < counts[:, None]) & mask[:, None]
    seen = {}
    greedy = tdense.greedy_token

    def spy(where):
        def pick(x, lm_head):
            seen[where] = x.detach().clone()
            return greedy(x, lm_head)
        return pick

    monkeypatch.setattr(tmserve, "greedy_token", spy("mk"))
    monkeypatch.setattr(tdense, "greedy_token", spy("engine"))
    pred = ms.verify(cands, counts, VLENS, tc.block_table, mask)
    jpred, _ = jm.verify_step_paged(jp, jnp.asarray(cands), jc,
                                    jnp.asarray(mask), jnp.asarray(counts),
                                    attn_method="xla")
    np.testing.assert_array_equal(pred[live], np.asarray(jpred)[live])
    assert (pred[~live] == 0).all()
    pm.verify_step_paged(pp, cands, tc, mask, counts)
    eng = seen["engine"].reshape(B, K, -1)[torch.from_numpy(live)]
    assert _rel(seen["mk"].numpy(), eng.numpy()) <= 1e-5
    # the appended rows are the engine verify's, in the megakernel pool
    kmk = ms.k_pool.view(L, -1, blk, 2 * 16)
    for b in np.flatnonzero(mask):
        for j in range(counts[b]):
            p = VLENS[b] + j
            page, row = tc.block_table[b, p // blk], p % blk
            want = tc.k_pool[:, page, :, row].reshape(L, -1)
            assert _rel(kmk[:, page, row].numpy(), want.numpy()) <= 1e-5
    # the width guard and the page-room guard
    with pytest.raises(ValueError, match="slot tile"):
        ms.verify(np.zeros((B, R + 1), np.int32), counts, VLENS,
                  tc.block_table, mask)
    with pytest.raises(ValueError, match="page-room"):
        ms.verify(cands, np.array([3, 2, 1, 3]), VLENS, tc.block_table,
                  mask)
    jfake = types.SimpleNamespace(tm=R)
    assert [ms.page_room(c) for c in range(20)] == \
        [JaxMegaServe.page_room(jfake, c) for c in range(20)]


# -- (c) ServeEngine(mode="megakernel", speculative=...) ----------------------

KW = dict(b_max=2, max_len=32, block=4, prefill_chunk=16)


def _reqs():
    rng = np.random.default_rng(5)
    return [(rng.integers(0, 128, s).astype(np.int32), g)
            for s, g in ((7, 6), (3, 5), (10, 6))]


def _jax_tokens(jm, jp, **kw):
    jse = JaxServeEngine(jm, jp, attn_method="xla", **KW, **kw)
    rids = [jse.submit(p, g) for p, g in _reqs()]
    out = jse.run()
    return {r: list(map(int, np.asarray(out[j]))) for r, j in enumerate(rids)}


def _spec_serve(pm, pp, targets, **kw):
    """The megakernel spec run with a spy on each launch's (lengths,
    widths) and on every page-room clamp."""
    prompts = {r: p for r, (p, _) in enumerate(_reqs())}
    se = models.ServeEngine(pm, pp, mode="megakernel", **KW, **kw,
                            speculative=models.SpecConfig(
                                drafter=models.OracleDrafter(
                                    targets, prompts, wrong_every=2,
                                    vocab=128), k=3, adapt=False))
    launches, rooms = [], []
    step, room = se._mk.prog.step, se._mk.page_room

    def spy_step(*a, **k):
        launches.append((np.asarray(k["cache_lens"]).copy(),
                         np.asarray(k["widths"]).copy()))
        return step(*a, **k)

    def spy_room(cl):
        rooms.append((int(cl), room(cl)))
        return rooms[-1][1]

    se._mk.prog.step, se._mk.page_room = spy_step, spy_room
    rids = [se.submit(p, g) for p, g in _reqs()]
    out = se.run()
    return se, {r: list(map(int, out[r])) for r in rids}, launches, rooms


def _check_spec_run(se, tok, want, launches, rooms):
    assert tok == want
    st = se.stats()
    assert st["spec_accepted"] > 0 and st["spec_rejected"] > 0, st
    assert st["megakernel_steps"] == st["decode_steps"] == len(launches)
    assert se.trace_counts == {"decode": 0, "prefill": 0, "verify": 1}
    assert se._mk.slot_rows == tserve.SPEC_SLOT_ROWS == R
    jfake = types.SimpleNamespace(tm=R)
    assert rooms and all(r == JaxMegaServe.page_room(jfake, cl)
                         for cl, r in rooms)
    assert any(r < 3 for _, r in rooms)      # the clamp bit at some tick
    for lens, wid in launches:
        assert (wid <= np.minimum(3, R - lens % R)).all(), (lens, wid)
    assert max(int(w.max()) for _, w in launches) > 1
    se._cache.check_conservation(cached=st["cached_free_blocks"])


def test_spec_megakernel_serve_dense_equals_jax_spec_off(dense_pair):
    _, jm, jp, pm, pp = dense_pair
    want = _jax_tokens(jm, jp)
    se, tok, launches, rooms = _spec_serve(pm, pp, want)
    _check_spec_run(se, tok, want, launches, rooms)


MOE = dict(SHRINK, num_experts=4, num_experts_per_tok=2,
           moe_intermediate_size=64)


@pytest.fixture(scope="module")
def moe_pair():
    """The port's tiny Qwen3MoE and the JAX engine-mode spec-off tokens
    on the same weights."""
    mesh1 = Mesh(np.asarray(jax.devices()[:1]), ("tp",))
    name = "Qwen/Qwen3-30B-A3B"
    jm = JaxQwen3MoE(jax_config.get_config(name).tiny(**MOE), mesh=mesh1,
                     mode="xla", dtype=jnp.float32)
    jp = jm.init_params(jax.random.PRNGKey(0))
    pm = models.Qwen3MoE(models.get_config(name).tiny(**MOE), mode="xla",
                         dtype="float32", device="cpu")
    return pm, models.params_from_jax(jax.device_get(jp), device="cpu"), \
        _jax_tokens(jm, jp)


@pytest.mark.parametrize("cap", [0, 3])
def test_spec_megakernel_serve_moe_equals_jax_spec_off(moe_pair, cap):
    pm, pp, want = moe_pair
    se, tok, launches, rooms = _spec_serve(pm, pp, want, ep_capacity=cap)
    _check_spec_run(se, tok, want, launches, rooms)
    if cap:
        # a verify tick bills k rows a slot: the budget defers slots, a
        # deferred slot rides the launch at width 0
        assert se.stats()["capacity_drops"] > 0
        assert all(int(w.sum()) <= cap for _, w in launches)
