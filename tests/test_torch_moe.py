"""The port's MoE ops and layer (triton_distributed_tpu_torch ops/moe_utils,
ops/grouped_gemm, ops/moe_parallel, layers/tp_moe, perf_model.ep_tick_plan)
against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
JAX grouped GEMM runs its Pallas kernel in interpret mode (as
tests/test_moe.py runs it) and the JAX layer runs on a 1-device mesh;
the port runs its plain versions on CPU tensors. Index plans must be
exactly equal; f32 results agree within 1e-5 of the largest value
(summation order), bf16 grouped GEMMs within 2e-2 of it (one bf16
rounding of the f32 sum, at other points).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_distributed_tpu import perf_model as jax_perf
from triton_distributed_tpu.layers.tp_moe import TPMoE as JaxTPMoE
from triton_distributed_tpu.ops import grouped_gemm as jgg
from triton_distributed_tpu.ops import moe_parallel as jmp
from triton_distributed_tpu.ops import moe_utils as jmu
from triton_distributed_tpu_torch import perf_model as tperf
from triton_distributed_tpu_torch.layers.tp_moe import TPMoE
from triton_distributed_tpu_torch.ops import grouped_gemm as tgg
from triton_distributed_tpu_torch.ops import moe_parallel as tmp
from triton_distributed_tpu_torch.ops import moe_utils as tmu

F32_TOL = 1e-5
BF16_TOL = 2e-2
PLAN = ("sorted_assignment", "gather_token", "dest_row", "tile_expert",
        "group_sizes")


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


_jax_sort = jax.jit(jmu.sort_tokens_by_expert, static_argnums=(1, 2))


def _experts(kind, m, e, top_k, seed):
    rng = np.random.default_rng(seed)
    if kind == "one":               # every token on the same experts
        cols = [e - 1] if top_k == 1 else list(range(top_k))
        return np.tile(np.asarray(cols, np.int32), (m, 1))
    if kind == "sparse":            # experts 1 and e-1 get nothing
        pool = [x for x in range(e) if x not in (1, e - 1)]
        return np.stack([rng.choice(pool, top_k, replace=False)
                         for _ in range(m)]).astype(np.int32)
    return np.stack([rng.choice(e, top_k, replace=False)
                     for _ in range(m)]).astype(np.int32)


@pytest.mark.parametrize("renormalize", [True, False])
def test_route_topk_matches_jax(renormalize):
    logits = np.random.default_rng(0).standard_normal((37, 16)).astype(
        np.float32)
    jw, je = jmu.route_topk(jnp.asarray(logits), 4, renormalize=renormalize)
    tw, te = tmu.route_topk(torch.from_numpy(logits), 4,
                            renormalize=renormalize)
    assert te.dtype == torch.int32
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)


@pytest.mark.parametrize("m,e,top_k,bm,kind", [
    (16, 4, 2, 8, "random"),
    (33, 7, 3, 8, "random"),
    (8, 3, 1, 16, "random"),
    (20, 8, 2, 16, "sparse"),       # experts with no tokens
    (12, 5, 1, 8, "one"),           # all tokens on one expert
    (9, 6, 3, 16, "one"),           # every token on experts 0..2
    (4, 128, 8, 128, "random"),     # the main path's decode routing
])
def test_sort_tokens_by_expert_matches_jax(m, e, top_k, bm, kind):
    experts = _experts(kind, m, e, top_k, seed=m + e)
    want = _jax_sort(jnp.asarray(experts), e, bm)
    got = tmu.sort_tokens_by_expert(torch.from_numpy(experts), e, bm)
    assert (got.top_k, got.block_m) == (want.top_k, want.block_m)
    assert got.tile_expert.shape[0] * bm == tmu.aligned_capacity(
        m * top_k, e, bm) == jmu.aligned_capacity(m * top_k, e, bm)
    for f in PLAN:
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.dtype == torch.int32, f
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f)


def test_gather_and_combine_match_jax():
    rng = np.random.default_rng(3)
    m, h, n, e, top_k, bm = 13, 24, 40, 6, 2, 8
    x = rng.standard_normal((m, h)).astype(np.float32)
    experts = _experts("sparse", m, e, top_k, 3)
    w = rng.random((m, top_k)).astype(np.float32)
    jd = _jax_sort(jnp.asarray(experts), e, bm)
    td = tmu.sort_tokens_by_expert(torch.from_numpy(experts), e, bm)
    jxs = jmu.gather_sorted(jnp.asarray(x), jd)
    txs = tmu.gather_sorted(torch.from_numpy(x), td)
    np.testing.assert_array_equal(txs.numpy(), np.asarray(jxs))
    y = rng.standard_normal((td.tile_expert.shape[0] * bm, n)).astype(
        np.float32)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        jc = jmu.combine_sorted(jnp.asarray(y, jdt), jd, jnp.asarray(w))
        tc = tmu.combine_sorted(torch.from_numpy(y).to(dt), td,
                                torch.from_numpy(w))
        assert tc.dtype == torch.float32
        np.testing.assert_allclose(tc.to(dt).float().numpy(),
                                   np.asarray(jc, np.float32),
                                   rtol=0, atol=F32_TOL * np.abs(y).max()
                                   if dt == torch.float32 else 0.02)


def test_combine_sorted_of_bf16_rows_equals_that_of_their_f32_copy():
    """combine_sorted over bf16 expert outputs gives the bits it gives
    over an f32 copy of them, so the MoE layer need not copy all P rows
    to f32 first (the JAX layer casts before it combines)."""
    rng = np.random.default_rng(8)
    m, n, e, top_k, bm = 11, 24, 6, 2, 8
    td = tmu.sort_tokens_by_expert(
        torch.from_numpy(_experts("sparse", m, e, top_k, 4)), e, bm)
    y = torch.from_numpy(rng.standard_normal(
        (td.tile_expert.shape[0] * bm, n)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.random((m, top_k)).astype(np.float32))
    got = tmu.combine_sorted(y, td, w)
    assert got.dtype == torch.float32
    assert torch.equal(got, tmu.combine_sorted(y.float(), td, w))


def _gmm_case(dtype, seed=4, m=21, k=48, n=40, e=6, top_k=2, bm=8):
    """Sorted rows of a routed batch with experts 1 and e-1 empty, so the
    plan has empty groups and trailing pad tiles."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((e, k, n)) * k ** -0.5).astype(np.float32)
    experts = _experts("sparse", m, e, top_k, seed)
    td = tmu.sort_tokens_by_expert(torch.from_numpy(experts), e, bm)
    xs = tmu.gather_sorted(torch.from_numpy(x).to(dtype), td)
    return xs, torch.from_numpy(w).to(dtype), td


@pytest.fixture(scope="module")
def jax_gmm():
    return jax.jit(jgg.gmm, static_argnames=("config",))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
def test_gmm_plain_matches_jax_gmm_and_ragged_dot(jax_gmm, dtype, tol):
    xs, w, td = _gmm_case(dtype)
    bm = td.block_m
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jl = jnp.asarray(xs.float().numpy(), jdt)
    jr = jnp.asarray(w.float().numpy(), jdt)
    jte = jnp.asarray(td.tile_expert.numpy())
    cfg = jgg.GroupedGemmConfig(block_m=bm, block_n=128, block_k=16)
    want = np.asarray(jax_gmm(jl, jr, jte, config=cfg), np.float32)
    want_rd = np.asarray(jgg.ragged_dot_aligned(jl, jr, jte, block_m=bm),
                         np.float32)
    tcfg = tgg.GroupedGemmConfig(block_m=bm)
    got = tgg.gmm(xs, w, td.tile_expert, config=tcfg)
    got_gs = tgg.gmm(xs, w, td.tile_expert, config=tcfg,
                     group_sizes=td.group_sizes)
    got_rd = tgg.gmm(xs, w, td.tile_expert,
                     config=dataclasses.replace(tcfg, use_xla=True))
    assert got.dtype == dtype and got.shape == (xs.shape[0], w.shape[2])
    # trailing pad tiles exist, and live rows sit in more than one tile
    assert td.tile_expert.shape[0] > -(-int(td.group_sizes.sum()) // bm)
    for g in (got, got_gs, got_rd):
        assert _rel(g.float().numpy(), want) <= tol
        assert _rel(g.float().numpy(), want_rd) <= tol


def test_gmm_pad_rows_are_zero_in_both(jax_gmm):
    """Rows past each group's live count (gather_sorted's zero rows) come
    out zero in both packages: the property the CUDA kernel's skip of
    all-pad blocks rests on."""
    xs, w, td = _gmm_case(torch.float32, seed=5)
    bm = td.block_m
    live = td.sorted_assignment.numpy() != td.dest_row.shape[0]
    assert (~live).sum() > 2 * bm
    want = np.asarray(jax_gmm(jnp.asarray(xs.numpy()), jnp.asarray(w.numpy()),
                              jnp.asarray(td.tile_expert.numpy()),
                              config=jgg.GroupedGemmConfig(block_m=bm)))
    got = tgg.gmm(xs, w, td.tile_expert,
                  config=tgg.GroupedGemmConfig(block_m=bm))
    assert np.all(want[~live] == 0)
    assert torch.all(got[torch.from_numpy(~live)] == 0)
    assert np.abs(want[live]).min(axis=1).max() > 0


def test_gmm_refuses_what_it_does_not_take():
    xs, w, td = _gmm_case(torch.float32)
    with pytest.raises(NotImplementedError, match="slice 7"):
        tgg.gmm(xs, w, td.tile_expert, config="auto")
    with pytest.raises(NotImplementedError, match="slice 7"):
        tgg.resolve_gmm_config(xs, w, td.tile_expert)
    with pytest.raises(ValueError):     # tile_expert at another block_m
        tgg.gmm(xs, w, td.tile_expert, config=tgg.GroupedGemmConfig(16))
    with pytest.raises(ValueError):     # K mismatch
        tgg.gmm(xs[:, :16], w, td.tile_expert,
                config=tgg.GroupedGemmConfig(td.block_m))


def test_moe_parallel_config_and_one_rank_scope():
    for bm in (None, 16):
        want = jmp.MoEParallelConfig(block_m=bm)
        got = tmp.MoEParallelConfig(block_m=bm)
        assert (got.block_m, got.gemm.block_m, got.method) == \
            (want.block_m, want.gemm.block_m, want.method)
        assert dataclasses.asdict(got.gemm) == dataclasses.asdict(want.gemm)
    # at n ranks the ops take rank-stacked operands: a one-rank operand
    # with num_ranks=2 is refused, and the layer splits its intermediate
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="rank-stacked"):
        tmp.ag_group_gemm_shard(x, torch.zeros((4, 2), dtype=torch.int32),
                                torch.zeros((3, 8, 8)), num_ranks=2,
                                num_experts=3)
    assert TPMoE(8, 8, 4, 2, num_ranks=2).n == 2
    with pytest.raises(ValueError, match="split"):
        TPMoE(8, 9, 4, 2, num_ranks=2)


LAYER = dict(hidden=32, moe_intermediate=16, num_experts=8, top_k=2)


@pytest.fixture(scope="module")
def layer_case():
    """One set of f32 layer weights and tokens, and the JAX golden."""
    rng = np.random.default_rng(6)
    h, i, e = LAYER["hidden"], LAYER["moe_intermediate"], LAYER["num_experts"]
    ws = {"router": rng.standard_normal((h, e)) * h ** -0.5,
          "w_gate": rng.standard_normal((e, h, i)) * h ** -0.5,
          "w_up": rng.standard_normal((e, h, i)) * h ** -0.5,
          "w_down": rng.standard_normal((e, i, h)) * i ** -0.5}
    ws = {k: v.astype(np.float32) for k, v in ws.items()}
    x = rng.standard_normal((24, h)).astype(np.float32)
    return ws, x


@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.asarray(jax.devices()[:1]), ("tp",))


@pytest.mark.parametrize("mode", ["xla", "fused", "ar", "gemm_ar"])
def test_tp_moe_matches_jax_and_reference(mesh1, layer_case, mode):
    ws, x = layer_case
    jcfg = jmp.MoEParallelConfig(gemm=jgg.GroupedGemmConfig(block_m=8))
    jl = JaxTPMoE(mesh=mesh1, mode=mode, config=jcfg, **LAYER)
    jp = jl.shard_params(*(jnp.asarray(ws[k]) for k in
                           ("router", "w_gate", "w_up", "w_down")))
    want = np.asarray(jax.jit(jl.__call__)(jp, jnp.asarray(x)))
    golden = np.asarray(jl.reference_forward(jax.device_get(jp),
                                             jnp.asarray(x)))
    tl = TPMoE(mode=mode, config=tmp.MoEParallelConfig(
        gemm=tgg.GroupedGemmConfig(block_m=8)), **LAYER)
    tp = tl.shard_params(*(torch.from_numpy(ws[k]) for k in
                           ("router", "w_gate", "w_up", "w_down")))
    np.testing.assert_array_equal(tp["w_gate_up"].numpy(),
                                  np.asarray(jp["w_gate_up"]))
    got = tl(tp, torch.from_numpy(x)).numpy()
    ref = tl.reference_forward(tp, torch.from_numpy(x)).numpy()
    for a, b in ((got, want), (got, golden), (ref, golden), (got, ref)):
        assert _rel(a, b) <= F32_TOL


@pytest.mark.parametrize("occupancy", [0, 1, 3, 4, 32, 257])
def test_ep_tick_plan_one_rank_matches_jax(occupancy):
    """One rank: JAX's plan. n ranks: the layer's own transport and chunk
    count, `a2a_round_s` not modeled (ROADMAP Queue C 21); an "auto"
    pipeline raises."""
    kw = dict(hidden=2048, moe_intermediate=768, top_k=8, num_ranks=1)
    assert tperf.ep_tick_plan(occupancy, **kw) == \
        jax_perf.ep_tick_plan(occupancy, **kw)
    for method, chunks in (("ragged", 1), ("xla", 2)):
        assert tperf.ep_tick_plan(
            occupancy, **{**kw, "num_ranks": 2}, method=method,
            pipeline=chunks) == {"occupancy": max(1, occupancy),
                                 "transport": method, "num_chunks": chunks,
                                 "a2a_round_s": None}
    with pytest.raises(NotImplementedError, match="slice 6"):
        tperf.ep_tick_plan(occupancy, **{**kw, "num_ranks": 2},
                           pipeline="auto")
