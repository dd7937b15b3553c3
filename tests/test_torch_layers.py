"""The port's layers (triton_distributed_tpu_torch/layers) against the JAX
package's on the same numpy inputs, on the CPU, at one rank.

The JAX layers run on a 1-device mesh (attention kernels in Pallas
interpret mode); the port's run on CPU tensors (plain attention
versions). Tolerances: f32 1e-5 (summation order); bf16 2e-2 (rounding
points of the bf16 matmuls and of the attention softmax).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_distributed_tpu.layers import norm as jnorm
from triton_distributed_tpu.layers import tp_attn as jtp_attn
from triton_distributed_tpu.layers import tp_mlp as jtp_mlp
from triton_distributed_tpu_torch.layers import common as tcommon
from triton_distributed_tpu_torch.layers import norm as tnorm
from triton_distributed_tpu_torch.layers import tp_attn as ttp_attn
from triton_distributed_tpu_torch.layers import tp_mlp as ttp_mlp

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.asarray(jax.devices()[:1]), ("tp",))


def _arrays(seed, *shapes, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_silu_match_jax(dtype):
    x, w = _arrays(0, (3, 5, 32), (32,))
    w = 1.0 + 0.1 * w
    jx, jw = jnp.asarray(x, JDT[dtype]), jnp.asarray(w, JDT[dtype])
    tx, tw = torch.from_numpy(x).to(TDT[dtype]), torch.from_numpy(w).to(
        TDT[dtype])
    for eps in (1e-6, 1e-5):
        got = tnorm.rms_norm(tx, tw, eps)
        assert got.dtype == tx.dtype
        _close(got, jnorm.rms_norm(jx, jw, eps), TOL[dtype])
    _close(ttp_mlp.silu(tx), jtp_mlp.silu(jx), TOL[dtype])


@pytest.mark.parametrize("n", [1, 2])
def test_fuse_column_parallel_matches_jax(n):
    mats = _arrays(1, (4, 6), (4, 2), (4, 4))
    want = jtp_mlp.fuse_column_parallel([jnp.asarray(m) for m in mats], n)
    got = ttp_mlp.fuse_column_parallel([torch.from_numpy(m) for m in mats],
                                       n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tp_mlp_matches_jax(mesh1, dtype):
    hidden, inter = 32, 64
    x, gate, up, down = _arrays(2, (6, hidden), (hidden, inter),
                                (hidden, inter), (inter, hidden),
                                scale=hidden ** -0.5)
    x = x * hidden ** 0.5
    jl = jtp_mlp.TPMLP(hidden, inter, mesh=mesh1, mode="ar")
    jp = jl.shard_params(*(jnp.asarray(a, JDT[dtype])
                           for a in (gate, up, down)))
    want = jax.jit(lambda p, x: jl(p, x))(jp, jnp.asarray(x, JDT[dtype]))
    tl = ttp_mlp.TPMLP(hidden, inter, mode="ar")
    tp = tl.shard_params(*(torch.from_numpy(a).to(TDT[dtype])
                           for a in (gate, up, down)))
    got = tl(tp, torch.from_numpy(x).to(TDT[dtype]))
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("qk_norm,dtype", [(True, "float32"),
                                           (False, "bfloat16")])
def test_tp_attn_prefill_and_decode_match_jax(mesh1, qk_norm, dtype):
    """Prefill S = 11 rows into a cache of S + 1, then decode row S; the
    output rows and both cache buffers agree after each step."""
    B, S, hidden, H, Hkv, D = 2, 11, 64, 4, 2, 16
    x, wq, wk, wv, wo = _arrays(3, (B, S + 1, hidden), (hidden, H * D),
                                (hidden, Hkv * D), (hidden, Hkv * D),
                                (H * D, hidden), scale=hidden ** -0.5)
    x = x * hidden ** 0.5
    qn, kn = (1.0 + 0.1 * a for a in _arrays(4, (D,), (D,)))
    jdt, tdt, tol = JDT[dtype], TDT[dtype], TOL[dtype]

    jl = jtp_attn.TPAttn(hidden, H, Hkv, D, mesh=mesh1, mode="ar",
                         qk_norm=qk_norm)
    jp = jl.shard_params(*(jnp.asarray(a, jdt) for a in (wq, wk, wv, wo)),
                         q_norm=qn, k_norm=kn)
    jx = jnp.asarray(x, jdt)
    cache = jl.new_kv_cache(B, S + 1, dtype=jdt)
    jy, cache = jax.jit(jl.prefill)(jp, jx[:, :S], cache)
    jyd, jcache = jax.jit(jl.decode)(jp, jx[:, S], cache, S)

    tl = ttp_attn.TPAttn(hidden, H, Hkv, D, mode="ar", qk_norm=qk_norm)
    tp = tl.shard_params(*(torch.from_numpy(a).to(tdt)
                           for a in (wq, wk, wv, wo)),
                         q_norm=torch.from_numpy(qn).to(tdt),
                         k_norm=torch.from_numpy(kn).to(tdt))
    tx = torch.from_numpy(x).to(tdt)
    ty, tcache = tl.prefill(tp, tx[:, :S], max_len=S + 1)
    _close(ty, jy, tol)
    for got, want in zip(tcache, cache):
        _close(got, want, tol)
    tyd, tcache = tl.decode(tp, tx[:, S], tcache, S)
    _close(tyd, jyd, tol)
    for got, want in zip(tcache, jcache):
        _close(got, want, tol)


def test_layers_refuse_more_than_one_rank():
    """What stays one-rank refuses n = 2 (the perf model's step
    estimators); the EP tick plan at n = 2 records the layer's own plan;
    the quantized wire at n = 2 gives the gemm_rs quant arm's plain
    version; the MoE layer builds at n = 2; the dense layers build at n =
    2 and give the one-rank layer's output on the same weights, in every
    mode (layer-level prefill and decode; the model-level checks are
    tests/test_torch_tp_models.py and test_torch_ep_models.py)."""
    from triton_distributed_tpu_torch import perf_model
    from triton_distributed_tpu_torch.layers.tp_moe import TPMoE
    assert TPMoE(8, 8, 4, 2, num_ranks=2).n == 2
    with pytest.raises(NotImplementedError, match="Queue A"):
        perf_model.estimate_mk_step_s(
            1, 1, num_layers=1, hidden=8, intermediate=8, num_heads=1,
            num_kv_heads=1, head_dim=8, tp_ranks=2)
    assert perf_model.ep_tick_plan(
        1, hidden=8, moe_intermediate=8, top_k=2, num_ranks=2) == {
            "occupancy": 1, "transport": "ragged", "num_chunks": 1,
            "a2a_round_s": None}
    from triton_distributed_tpu_torch.ops import gemm_rs
    rows, w = torch.randn(2, 4, 8), torch.randn(2, 8, 8)
    assert torch.equal(
        tcommon.row_parallel_out(rows, w, mode="fused", num_ranks=2,
                                 wire_dtype="int8"),
        gemm_rs._gemm_rs_quant_plain(rows, w, "int8", 8))
    with pytest.raises(ValueError):
        tcommon.check_mode("nccl")
    assert tcommon.MODES == ("xla", "fused", "ar", "gemm_ar")
    g = torch.Generator().manual_seed(0)
    wg, wu, wd = (torch.randn(s, generator=g) / 8
                  for s in ((32, 64), (32, 64), (64, 32)))
    x = torch.randn(6, 32, generator=g)
    one = ttp_mlp.TPMLP(32, 64)
    want = one(one.shard_params(wg, wu, wd), x)
    for mode in tcommon.MODES:
        two = ttp_mlp.TPMLP(32, 64, num_ranks=2, mode=mode)
        xin = x.reshape(2, 3, 32) if mode in ("xla", "fused") else x
        got = two(two.shard_params(wg, wu, wd), xin)
        torch.testing.assert_close(got.reshape(6, 32), want, rtol=1e-5,
                                   atol=1e-5)
    H, D = 32, 8
    wq, wk, wv, wo = (torch.randn(s, generator=g) / 6 for s in
                      ((H, 4 * D), (H, 2 * D), (H, 2 * D), (4 * D, H)))
    xs = torch.randn(2, 4, H, generator=g)
    ref = ttp_attn.TPAttn(H, 4, 2, D, qk_norm=True)
    rp = ref.shard_params(wq, wk, wv, wo)
    y1, c1 = ref.prefill(rp, xs, max_len=5)
    d1, _ = ref.decode(rp, xs[:, 0], c1, 4)
    for mode in tcommon.MODES:
        tl = ttp_attn.TPAttn(H, 4, 2, D, qk_norm=True, mode=mode, num_ranks=2)
        tp = tl.shard_params(wq, wk, wv, wo)
        y2, c2 = tl.prefill(tp, xs, max_len=5)
        d2, c2 = tl.decode(tp, xs[:, 0], c2, 4)
        torch.testing.assert_close(y2, y1, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(d2, d1, rtol=1e-5, atol=1e-5)
        assert c2[0].shape == (2, 2, 5, 1, D)
