"""The port's quantized collective wire against the JAX package's, on the
CPU: the codec functions of ops/wire.py against JAX's (eager, bit for
bit: ROADMAP Queue C 2), the plain versions of the quant arms of
ops/gemm_rs.py and ops/gemm_ar.py against the JAX `_kernel_quant` Pallas
kernels in interpret mode on a 2- and a 4-device CPU mesh, and the
dispatch log (the wire records and both fallback reasons) against JAX's.

The quant arms use the JAX tests' shapes and tiles (tests/test_gemm_rs.py,
test_gemm_ar.py: (M, K, N) (64, 256, 128) and (16, 256, 128), block_m 16,
block_k 64), at n 2 and 4, f32 and bf16, int8 and fp8 wires. Tolerance:
the JAX tests' own against the JAX kernel (f32 1e-5, bf16 3e-2, rtol and
atol) plus twice `wire.sum_error_bound` of the f32 partials. Both sides
quantize an f32 accumulator summed over K in another order, so an element
that lies on a rounding boundary can land one quantization step away on
each source; a step is twice the per-element bound. Each JAX kernel runs
once a process, when a test first needs it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from triton_distributed_tpu.ops import _common as jax_common
from triton_distributed_tpu.ops import wire as jwire
from triton_distributed_tpu.ops.gemm_ar import GemmARConfig as JaxARConfig
from triton_distributed_tpu.ops.gemm_ar import gemm_ar as jax_gemm_ar
from triton_distributed_tpu.ops.gemm_rs import GemmRSConfig as JaxRSConfig
from triton_distributed_tpu.ops.gemm_rs import gemm_rs as jax_gemm_rs
from triton_distributed_tpu_torch.ops import _common, gemm_ar, gemm_rs, wire
from triton_distributed_tpu_torch.parallel import shard, unshard

WIRES = ("int8", "float8_e4m3fn")
DTYPES = ("float32", "bfloat16")
TILES = dict(block_m=16, block_k=64)
CASES = {"gemm_rs": ((64, 256, 128), 3e-2), "gemm_ar": ((16, 256, 128), 3e-2)}
JAX_FNS = {"gemm_rs": (jax_gemm_rs, JaxRSConfig),
           "gemm_ar": (jax_gemm_ar, JaxARConfig)}
PORT = {"gemm_rs": (gemm_rs.gemm_rs_shard, gemm_rs._gemm_rs_quant_plain),
        "gemm_ar": (gemm_ar.gemm_ar_shard, gemm_ar._gemm_ar_quant_plain)}
SPECS = {"gemm_rs": (P(None, "tp"), P("tp", None), P("tp", None)),
         "gemm_ar": (P(None, "tp"), P("tp", None), P(None, None))}
RUNS = [(op, n, dt, w) for op in CASES for n in (2, 4) for dt in DTYPES
        for w in WIRES]


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("tp",))


def _spec_dim(spec):
    return next((d for d, a in enumerate(spec) if a == "tp"), None)


def _operands(op, seed=0):
    (M, K, N), _ = CASES[op]
    rng = np.random.RandomState(seed)
    return (rng.randn(M, K).astype(np.float32) / np.sqrt(K),
            rng.randn(K, N).astype(np.float32) / np.sqrt(K))


def _torch(x, dtype):
    return torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch,
                                                                  dtype))


# -- the codec ---------------------------------------------------------------

def _values(dtype, shape=(6, 512), seed=0):
    """Values spread over decades, with an all-zero block and one large
    value, in the input dtype (bf16 rounded on both sides alike)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    x *= 10.0 ** rng.randint(-3, 3, (shape[0], 1))
    x[0, :128] = 0.0
    x[1, 5] = 300.0
    t = _torch(x, dtype)
    return t, np.asarray(jnp.asarray(t.float().numpy(), dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("wd", WIRES)
def test_codec_equals_jax_bit_for_bit(dtype, wd):
    """quant_value_blocks / dequant_value_blocks / dequant_accumulate and
    the helpers against the eager JAX codec: the same payload bytes and
    scales, the same f32 dequantized values, the same rank-ordered sums."""
    t, j = _values(dtype)
    for blk in (128, 256, 64):
        q, s = wire.quant_value_blocks(t, wd, blk)
        jq, js = jwire.quant_value_blocks(j, wd, blk)
        np.testing.assert_array_equal(
            q.view(torch.uint8).numpy(),
            np.asarray(jq).view(np.uint8))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            wire.dequant_value_blocks(q, s, blk).numpy(),
            np.asarray(jwire.dequant_value_blocks(jq, js, blk)))
    parts = [_values(dtype, seed=s) for s in range(4)]
    tq = [wire.quant_blockwise(p[0], wd, 256) for p in parts]
    jq = [jwire.quant_blockwise(p[1], wd, 256) for p in parts]
    got = wire.dequant_accumulate(torch.stack([q for q, _ in tq]),
                                  torch.stack([s for _, s in tq]),
                                  torch.float32, 256)
    want = jwire.dequant_accumulate(jnp.stack([q for q, _ in jq]),
                                    jnp.stack([s for _, s in jq]),
                                    jnp.float32, 256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert wire.quant_eps(wd) == jwire.quant_eps(wd)
    for width, blk in ((4096, None), (320, None), (128, None), (96, 32),
                       (100, 8), (512, 512)):
        assert wire.effective_block(width, blk) == \
            jwire.effective_block(width, blk)
    stack = np.stack([p[1].astype(np.float32) for p in parts])
    for blk, qz in ((256, 1), (64, 4)):
        np.testing.assert_array_equal(
            wire.sum_error_bound(torch.from_numpy(stack), wd, blk, qz),
            jwire.sum_error_bound(stack, wd, blk, qz))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("wd", WIRES)
def test_quant_collectives_equal_jax(n, wd):
    """quant_psum and quant_psum_scatter over the rank dimension against
    JAX's under shard_map, in f32, within one f32 rounding of the sum
    (under jit the JAX codec may divide by a reciprocal, Queue C 2), and
    within sum_error_bound of the exact psum / psum_scatter."""
    rng = np.random.RandomState(n)
    x = rng.randn(n * 8, 256).astype(np.float32)
    mesh = _mesh(n)

    def body(xs):
        return (jwire.quant_psum(xs, "tp", wd),
                jwire.quant_psum_scatter(xs, "tp", wd))

    jsum, jscat = jax.jit(shard_map(
        body, mesh=mesh, in_specs=P("tp", None),
        out_specs=(P(), P("tp", None)), check_vma=False))(jnp.asarray(x))
    xs = shard(torch.from_numpy(x), 0, n)                     # (n, 8, 256)
    got_sum = wire.quant_psum(xs, wd)
    got_scat = unshard(wire.quant_psum_scatter(xs, wd), 0)
    exact = x.reshape(n, 8, 256).sum(0)
    np.testing.assert_allclose(got_sum.numpy(), np.asarray(jsum),
                               rtol=2e-6, atol=2e-6 * np.abs(exact).max())
    np.testing.assert_allclose(got_scat.numpy(), np.asarray(jscat),
                               rtol=2e-6, atol=2e-6 * np.abs(exact).max())
    bound = wire.sum_error_bound(xs, wd)
    assert np.all(np.abs(got_sum.numpy() - exact) <= bound + 1e-6)
    bound_s = wire.sum_error_bound(xs.reshape(n, n, 8 // n, 256), wd)
    assert np.all(np.abs(got_scat.numpy() - exact)
                  <= bound_s.reshape(8, 256) + 1e-6)
    with pytest.raises(NotImplementedError, match="slice 2c"):
        wire.quant_psum(xs, wd, checksum=True)


# -- the quant arms' plain versions against the JAX kernels ------------------

@functools.lru_cache(maxsize=None)
def _jax_run(op, n, dt, wd):
    """The JAX quant kernel at (op, n, dtype, wire) in interpret mode, with
    the dispatch it logged; once per process (a worker runs only its own
    cases)."""
    a, b = _operands(op)
    fn, cfg_cls = JAX_FNS[op]
    mesh = _mesh(n)
    sa, sb, _ = SPECS[op]
    a_s = jax.device_put(jnp.asarray(a, dt), NamedSharding(mesh, sa))
    b_s = jax.device_put(jnp.asarray(b, dt), NamedSharding(mesh, sb))
    jax_common.reset_dispatch()
    got = jax.jit(functools.partial(
        fn, mesh=mesh, config=cfg_cls(**TILES, wire_dtype=wd)))(a_s, b_s)
    return np.asarray(got, np.float32), jax_common.dispatch_counts()


@pytest.mark.parametrize("op,n,dtype,wd", RUNS)
def test_quant_plain_matches_the_jax_kernel(op, n, dtype, wd):
    want, jax_log = _jax_run(op, n, dtype, wd)
    assert jax_log == {(op, "kernel", "wire"): 1}
    a, b = _operands(op)
    sa, sb, so = SPECS[op]
    ta = shard(_torch(a, dtype), _spec_dim(sa), n)
    tb = shard(_torch(b, dtype), _spec_dim(sb), n)
    shard_fn, plain = PORT[op]
    _common.reset_dispatch()
    got = shard_fn(ta, tb, num_ranks=n, wire_dtype=wd)
    assert _common.dispatch_counts() == jax_log
    assert torch.equal(got, plain(ta, tb, wd, 128))
    if op == "gemm_ar":          # every rank's replica of the sum
        assert got.shape[0] == n
        got = got[0]
    else:
        got = unshard(got, _spec_dim(so))
    partials = (ta.float() @ tb.float())                   # (n, M, N)
    if op == "gemm_rs":
        bound = wire.sum_error_bound(partials, wd).reshape(want.shape)
    else:
        bound = wire.sum_error_bound(partials, wd)
    tol = 1e-5 if dtype == "float32" else CASES[op][1]
    err = np.abs(got.float().numpy() - want)
    assert np.all(err <= tol + tol * np.abs(want) + 2 * bound), err.max()
    # and the quantized sum stays within the bound of the full-width one
    full = shard_fn(ta, tb, num_ranks=n)
    full = full[0] if op == "gemm_ar" else unshard(full, _spec_dim(so))
    assert np.all(np.abs(got.float().numpy() - full.float().numpy())
                  <= bound + tol * np.abs(want) + tol)


# -- the dispatch log --------------------------------------------------------

@pytest.mark.parametrize("op,n,N,cfg", [
    ("gemm_rs", 4, 1024, dict(block_m=64, block_k=256)),
    ("gemm_ar", 4, 1024, dict(block_m=64, block_k=256)),
    ("gemm_rs", 4, 320, dict(block_m=64, block_k=256)),
    ("gemm_ar", 4, 320, dict(block_m=64, block_k=256)),
    ("gemm_rs", 1, 1024, {}),
    ("gemm_ar", 1, 1024, {}),
    ("gemm_rs", 2, 1024, dict(use_xla=True)),
    ("gemm_ar", 2, 1024, dict(use_xla=True)),
])
def test_wire_dispatch_log_matches_jax(op, n, N, cfg):
    """The wire records of JAX's dispatch (tests/test_dispatch.py's quant
    cases): ("kernel", "wire"), both "wire-fallback" reasons (N 320 fits
    no 256 block; one rank) and the XLA fallback's ("xla", "wire").
    JAX traced only."""
    M = 256 if op == "gemm_rs" else 64
    K = 1024
    fn, cfg_cls = JAX_FNS[op]
    mesh = _mesh(n)
    sa, sb, _ = SPECS[op]
    jax_common.reset_dispatch()
    jax.eval_shape(functools.partial(
        fn, mesh=mesh, config=cfg_cls(**cfg, wire_dtype="int8")),
        jax.ShapeDtypeStruct((M, K), jnp.float32,
                             sharding=NamedSharding(mesh, sa)),
        jax.ShapeDtypeStruct((K, N), jnp.float32,
                             sharding=NamedSharding(mesh, sb)))
    want = jax_common.dispatch_counts()
    _common.reset_dispatch()
    PORT[op][0](shard(torch.zeros(M, K), _spec_dim(sa), n),
                shard(torch.zeros(K, N), _spec_dim(sb), n), num_ranks=n,
                use_xla=cfg.get("use_xla", False), wire_dtype="int8")
    assert _common.dispatch_counts() == want, (want, _common.dispatch_counts())


def test_wire_block_rule_and_refusals():
    """The quant arms' block rule raises on every device, naming it, for a
    block that neither divides 128 nor is a multiple of it (N 192: block
    192); the same call at one rank, or on the plain collective path,
    takes no quant arm and passes; an unknown wire dtype raises."""
    a, b = torch.zeros(2, 16, 64), torch.ones(2, 64, 192)
    _common.reset_dispatch()
    with pytest.raises(ValueError, match="scaling block"):
        gemm_ar.gemm_ar_shard(a, b, num_ranks=2, wire_dtype="int8")
    assert _common.dispatch_counts() == {}
    out = gemm_ar.gemm_ar_shard(a, b, num_ranks=2, wire_dtype="int8",
                                use_xla=True)
    assert out.shape == (2, 16, 192) and not out.any()
    assert gemm_rs.gemm_rs_shard(a, b, num_ranks=2, wire_dtype="int8",
                                 wire_block=64).shape == (2, 8, 192)
    with pytest.raises(ValueError, match="unsupported wire dtype"):
        gemm_rs.gemm_rs_shard(a, b, num_ranks=2, wire_dtype="int4")
    for blk, ok in ((8, True), (64, True), (128, True), (256, True),
                    (512, True), (96, False), (1024, False), (4, False)):
        if ok:
            _common.check_wire_block("op", blk)
        else:
            with pytest.raises(ValueError, match="op: the quantized wire"):
                _common.check_wire_block("op", blk)
