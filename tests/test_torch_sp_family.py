"""The port's sequence-parallel family beyond serving against the JAX
package on a 4-device CPU mesh (f32, inputs from numpy seeds, the sizes of
JAX's tests/test_sp_ag_attention.py and tests/test_varlen.py):

- `sp_ag_attention`'s kernel route (`force_kernel=True`; its plain version
  on the CPU), causal and not, dense and over a packed varlen batch whose
  trailing rows come out exactly 0, against JAX's fused Pallas kernel in
  the TPU interpreter;
- the dispatch rows of both fallbacks and of the kernel route equal to
  JAX's (read by `jax.eval_shape`: JAX records while it traces), and the
  fallbacks' outputs equal to the port's rings;
- the host-level `ring_attention` and `sp_flash_decode` under both
  combines through JAX's and the port's `SpFlashDecodeAttention`;
- `ulysses_qkv_a2a` / `ulysses_o_a2a` under both methods and `UlyssesAttn`
  with the JAX layer's weights carried across, against JAX.

Outputs agree within 1e-5. Each JAX call runs once per case
(`functools.lru_cache`); the JAX attention kernels run in the plain Pallas
interpreter, the communication kernels in the TPU interpreter they need.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_distributed_tpu import ops as jops
from triton_distributed_tpu import runtime as jruntime
from triton_distributed_tpu.layers import sp_attn as jlayers
from triton_distributed_tpu.ops import attention as jattn
from triton_distributed_tpu.ops import sp_ag_attention as jag
from triton_distributed_tpu.ops import sp_attention as jsp
from triton_distributed_tpu.ops import ulysses as jul
from triton_distributed_tpu_torch.layers import (SpFlashDecodeAttention,
                                                 UlyssesAttn)
from triton_distributed_tpu_torch.layers.sp_attn import \
    ulysses_params_from_jax
from triton_distributed_tpu_torch.ops import _common as tcommon
from triton_distributed_tpu_torch.ops import attention as tattn
from triton_distributed_tpu_torch.ops import sp_ag_attention as tag
from triton_distributed_tpu_torch.ops import sp_attention as tsp
from triton_distributed_tpu_torch.ops import ulysses as tul
from triton_distributed_tpu_torch.parallel import shard

N = 4
TOL = 1e-5


class PlainInterpreter:
    """The JAX runtime module with the plain Pallas interpreter for the
    attention kernels (as tests/test_torch_sp_ops.py)."""

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


def _t(a):
    return torch.from_numpy(np.array(a))


def _qkv(seed, b, s, h, hkv, d, div=1.0):
    rng = np.random.default_rng(seed)
    return tuple((rng.normal(size=(b, s, hh, d)) / div).astype(np.float32)
                 for hh in (h, hkv, hkv))


def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


# ---------------------------------------------------------------------------
# sp_ag_attention: the kernel route, varlen, the fallbacks
# ---------------------------------------------------------------------------

# name: (seed, S, heads, kv heads, D, block, divisor, lens or None)
AG_CASES = {"dense": (0, 32, 4, 2, 16, 8, 1.0, None),
            "varlen": (4, 64, 4, 2, 8, 16, 3.0, (10, 30, 18))}


def _ag_inputs(case):
    seed, s, h, hkv, d, blk, div, lens = AG_CASES[case]
    q, k, v = _qkv(seed, 1, s, h, hkv, d, div)
    cu = None if lens is None else _cu(lens)
    return q, k, v, cu, blk


@functools.lru_cache(maxsize=None)
def jax_sp_ag(mesh, case, causal):
    q, k, v, cu, blk = _ag_inputs(case)
    cfg = jag.SpAgAttnConfig(block_q=blk, block_k=blk, force_kernel=True)
    fn = jax.jit(functools.partial(
        jag.sp_ag_attention, mesh=mesh, axis="tp", causal=causal, config=cfg,
        cu_seqlens=None if cu is None else jnp.asarray(cu)))
    return np.asarray(fn(q, k, v))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", list(AG_CASES))
def test_sp_ag_attention_kernel_route_equals_jax(mesh4, case, causal):
    q, k, v, cu, blk = _ag_inputs(case)
    cfg = tag.SpAgAttnConfig(block_q=blk, block_k=blk, force_kernel=True)
    tcommon.reset_dispatch()
    got = tag.sp_ag_attention(_t(q), _t(k), _t(v), num_ranks=N,
                              causal=causal, config=cfg,
                              cu_seqlens=None if cu is None else _t(cu))
    assert tcommon.dispatch_counts() == {
        ("sp_ag_attention", "kernel", ""): 1}
    np.testing.assert_allclose(got.numpy(), jax_sp_ag(mesh4, case, causal),
                               rtol=TOL, atol=TOL)
    if cu is not None:
        assert (got[0, int(cu[-1]):] == 0).all()


# name: (seed, B, S, block, config kwargs, lens or None, ranks)
DISPATCH_CASES = {
    "kernel": (1, 1, 32, 8, {}, None, N),
    "requested": (1, 1, 32, 8, {"force_ring": True}, None, N),
    "batch": (1, 2, 32, 8, {}, None, N),
    "vmem_state": (6, 1, 40, 16, {}, (9, 21, 10), N),
    "n==1": (1, 1, 32, 8, {}, None, 1),
}


def _dispatch_inputs(case):
    seed, b, s, blk, kw, lens, n = DISPATCH_CASES[case]
    q, k, v = _qkv(seed, b, s, 4, 2, 16, 3.0)
    return q, k, v, (None if lens is None else _cu(lens)), blk, kw, n


@pytest.mark.parametrize("case", list(DISPATCH_CASES))
def test_sp_ag_attention_dispatch_equals_jax(case):
    """The port logs what JAX logs while it traces, and a fallback's output
    is the port's ring's: `ring_attention_shard`, or
    `ring_attention_varlen_shard` over the sideband re-padded to bq rows."""
    q, k, v, cu, blk, kw, n = _dispatch_inputs(case)
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("tp",))
    jops.reset_dispatch()
    jax.eval_shape(functools.partial(
        jag.sp_ag_attention, mesh=mesh, axis="tp",
        config=jag.SpAgAttnConfig(block_q=blk, block_k=blk, **kw),
        cu_seqlens=None if cu is None else jnp.asarray(cu)), q, k, v)
    want = jops.dispatch_counts("sp_ag_attention")
    tcommon.reset_dispatch()
    got = tag.sp_ag_attention(
        _t(q), _t(k), _t(v), num_ranks=n,
        config=tag.SpAgAttnConfig(block_q=blk, block_k=blk, **kw),
        cu_seqlens=None if cu is None else _t(cu))
    assert tcommon.dispatch_counts("sp_ag_attention") == want == {
        ("sp_ag_attention", *dict(
            kernel=("kernel", "")).get(case, ("ring", case))): 1}
    if cu is not None:
        ring = tsp.ring_attention_varlen(_t(q[0]), _t(k[0]), _t(v[0]),
                                         _t(cu), num_ranks=n, block_q=blk,
                                         block_k=blk)[None]
    elif case != "kernel":
        ring = tsp.ring_attention(_t(q), _t(k), _t(v), num_ranks=n)
    else:
        return
    assert torch.equal(got, ring)


def test_sp_ag_attention_refuses_what_the_kernel_does_not_take():
    q, k, v = (_t(a) for a in _qkv(1, 2, 32, 4, 2, 16))
    with pytest.raises(ValueError, match="B==1"):
        tag.sp_ag_attention(q, k, v, num_ranks=N,
                            config=tag.SpAgAttnConfig(force_kernel=True))
    with pytest.raises(ValueError, match="rank-stacked"):
        tag.sp_ag_attention_shard(q, k, v, num_ranks=N)


# ---------------------------------------------------------------------------
# Host-level ring attention and the SP decode
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_ring(mesh):
    q, k, v = _qkv(7, 2, 32, 4, 2, 16)
    return np.asarray(jax.jit(functools.partial(
        jsp.ring_attention, mesh=mesh, axis="tp", causal=True, block_q=8,
        block_k=8))(q, k, v))


def test_ring_attention_host_level_equals_jax(mesh4):
    q, k, v = _qkv(7, 2, 32, 4, 2, 16)
    got = tsp.ring_attention(_t(q), _t(k), _t(v), num_ranks=N, causal=True,
                             block_q=8, block_k=8)
    np.testing.assert_allclose(got.numpy(), jax_ring(mesh4), rtol=TOL,
                               atol=TOL)


def _decode_inputs():
    """B 3 over a 64-position cache, 16 a rank: one row within rank 0,
    one across ranks 0-2, one over all four."""
    rng = np.random.default_rng(8)
    q = rng.normal(size=(3, 4, 16)).astype(np.float32)
    k = rng.normal(size=(3, 64, 2, 16)).astype(np.float32)
    v = rng.normal(size=(3, 64, 2, 16)).astype(np.float32)
    return q, k, v, np.asarray([9, 40, 64], np.int32)


@functools.lru_cache(maxsize=None)
def jax_sp_decode(mesh, combine):
    q, k, v, kv_len = _decode_inputs()
    layer = jlayers.SpFlashDecodeAttention(4, 2, 16, mesh=mesh, axis="tp",
                                           combine=combine)
    return np.asarray(jax.jit(layer.__call__)(q, k, v, jnp.asarray(kv_len)))


@pytest.mark.parametrize("combine", ["xla", "ll"])
def test_sp_flash_decode_and_its_layer_equal_jax(mesh4, combine):
    q, k, v, kv_len = (_t(a) for a in _decode_inputs())
    want = jax_sp_decode(mesh4, combine)
    got = tsp.sp_flash_decode(q, k, v, kv_len, num_ranks=N, combine=combine)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    layer = SpFlashDecodeAttention(4, 2, 16, num_ranks=N, combine=combine)
    assert torch.equal(layer(q, k, v, kv_len), got)


def test_sp_flash_decode_refusals_follow_jax():
    q, k, v, _ = (_t(a) for a in _decode_inputs())
    with pytest.raises(ValueError, match="exceeds the sharded KV extent"):
        tsp.sp_flash_decode(q, k, v, 65, num_ranks=N)
    with pytest.raises(ValueError, match="does not split"):
        tsp.sp_flash_decode(q, k[:, :63], v[:, :63], 9, num_ranks=N)
    with pytest.raises(ValueError, match="combine"):
        SpFlashDecodeAttention(4, 2, 16, num_ranks=N, combine="nccl")
    with pytest.raises(ValueError, match="kv heads"):
        SpFlashDecodeAttention(4, 4, 16, num_ranks=N)(q, k, v, 9)


# ---------------------------------------------------------------------------
# Ulysses
# ---------------------------------------------------------------------------

U = dict(hidden=32, num_heads=8, num_kv_heads=4, head_dim=8)
S_U = 32


def _ulysses_inputs():
    rng = np.random.default_rng(9)
    n, d = N, U["head_dim"]
    c_qkv = (U["num_heads"] + 2 * U["num_kv_heads"]) * d // n
    c_o = U["num_heads"] * d // n
    return (rng.normal(size=(S_U, U["hidden"])).astype(np.float32),
            rng.normal(size=(U["hidden"], n, c_qkv)).astype(np.float32),
            rng.normal(size=(S_U, n * c_o)).astype(np.float32),
            rng.normal(size=(n, c_o, U["hidden"])).astype(np.float32))


@functools.lru_cache(maxsize=None)
def jax_ulysses_ops(mesh, method):
    def fn(x, w_qkv, y, w_o):
        return (jul.ulysses_qkv_a2a(x, w_qkv, mesh=mesh, axis="tp",
                                    method=method),
                jul.ulysses_o_a2a(y, w_o, mesh=mesh, axis="tp",
                                  method=method))

    return tuple(np.asarray(a) for a in jax.jit(fn)(*_ulysses_inputs()))


@pytest.mark.parametrize("method", ["ring", "xla"])
def test_ulysses_a2a_ops_equal_jax(mesh4, method):
    x, w_qkv, y, w_o = (_t(a) for a in _ulysses_inputs())
    want_qkv, want_o = jax_ulysses_ops(mesh4, method)
    got_qkv = tul.ulysses_qkv_a2a(x, w_qkv, num_ranks=N, method=method)
    got_o = tul.ulysses_o_a2a(y, w_o, num_ranks=N, method=method)
    np.testing.assert_allclose(got_qkv.numpy(), want_qkv, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_o.numpy(), want_o, rtol=TOL, atol=TOL)
    # the rank-stacked forms are the host-level ones, sharded
    assert torch.equal(
        tul.ulysses_qkv_a2a_shard(shard(x, 0, N), w_qkv, num_ranks=N,
                                  method=method), shard(got_qkv, 1, N))


def test_ulysses_weight_arrangement_equals_jax():
    rng = np.random.default_rng(10)
    d = U["head_dim"]
    w_q, w_k, w_v = (rng.normal(size=(U["hidden"], h * d)).astype(np.float32)
                     for h in (8, 4, 4))
    w_o = rng.normal(size=(8 * d, U["hidden"])).astype(np.float32)
    np.testing.assert_array_equal(
        tul.arrange_qkv_for_ulysses(_t(w_q), _t(w_k), _t(w_v), N).numpy(),
        np.asarray(jul.arrange_qkv_for_ulysses(w_q, w_k, w_v, N)))
    np.testing.assert_array_equal(tul.arrange_o_for_ulysses(_t(w_o), N).numpy(),
                                  np.asarray(jul.arrange_o_for_ulysses(w_o, N)))


@functools.lru_cache(maxsize=None)
def jax_ulysses_layer(mesh, method):
    layer = jlayers.UlyssesAttn(**U, mesh=mesh, axis="tp", method=method)
    params = layer.init_params(jax.random.PRNGKey(3), dtype=jnp.float32)
    x = np.random.default_rng(11).normal(
        size=(S_U, U["hidden"])).astype(np.float32)
    out = jax.jit(layer.__call__)(params, x)
    ref = layer.reference_forward(params, x)
    return (jax.device_get(params), x, np.asarray(out), np.asarray(ref))


@pytest.mark.parametrize("method", ["ring", "xla"])
def test_ulysses_attn_with_the_jax_weights_equals_jax(mesh4, method):
    tree, x, want, want_ref = jax_ulysses_layer(mesh4, method)
    layer = UlyssesAttn(**U, num_ranks=N, method=method)
    params = ulysses_params_from_jax(tree, device="cpu")
    got = layer(params, _t(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(layer.reference_forward(params, _t(x)).numpy(),
                               want_ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=1e-4, atol=1e-4)


def test_ulysses_layer_refusals_and_device():
    with pytest.raises(ValueError, match="split"):
        UlyssesAttn(32, 8, 2, 8, num_ranks=N)
    with pytest.raises(ValueError, match="method"):
        UlyssesAttn(**U, num_ranks=N, method="nccl")
    layer = UlyssesAttn(**U, num_ranks=N)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            layer.init_params()
    params = layer.init_params(torch.Generator().manual_seed(0),
                               dtype=torch.float32, device="cpu")
    assert params["w_qkv"].shape == (32, N, 32)
    assert params["w_o"].shape == (N, 16, 32)
