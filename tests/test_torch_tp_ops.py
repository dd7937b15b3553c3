"""The port's tensor-parallel ops against the JAX package's, on the CPU:
the plain versions of the fused kernels (ops/ag_gemm.py, gemm_rs.py,
gemm_ar.py) against the JAX Pallas kernels in interpret mode on a 2- and a
4-device CPU mesh, the rank group's collectives against `lax` under
`shard_map`, and the dispatch log against JAX's (the same but for JAX's
tile-divisibility rule, which is the TPU kernel's and not the port's).

The port's operands are the JAX arrays' shards, rank-stacked
(parallel/mesh.py). Tolerances are the JAX tests' own, against the JAX
kernel: f32 1e-5; bf16 2e-2 for ag_gemm and 3e-2 for gemm_rs / gemm_ar
(rtol and atol). The JAX kernel runs once per (op, n, dtype), in a module
fixture.
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
from triton_distributed_tpu.ops.ag_gemm import AGGemmConfig as JaxAGConfig
from triton_distributed_tpu.ops.ag_gemm import ag_gemm as jax_ag_gemm
from triton_distributed_tpu.ops.gemm_ar import GemmARConfig as JaxARConfig
from triton_distributed_tpu.ops.gemm_ar import gemm_ar as jax_gemm_ar
from triton_distributed_tpu.ops.gemm_rs import GemmRSConfig as JaxRSConfig
from triton_distributed_tpu.ops.gemm_rs import gemm_rs as jax_gemm_rs
from triton_distributed_tpu_torch.ops import _common
from triton_distributed_tpu_torch.ops import ag_gemm, gemm_ar, gemm_rs
from triton_distributed_tpu_torch.parallel import RankGroup, shard, unshard

# (M, K, N) and tiles of the JAX tests (tests/test_ag_gemm.py,
# test_gemm_rs.py, test_gemm_ar.py)
CASES = {"ag_gemm": ((64, 256, 128), dict(block_m=16, block_k=128), 2e-2),
         "gemm_rs": ((64, 256, 128), dict(block_m=16, block_k=64), 3e-2),
         "gemm_ar": ((16, 256, 128), dict(block_m=16, block_k=64), 3e-2)}
JAX_FNS = {"ag_gemm": (jax_ag_gemm, JaxAGConfig),
           "gemm_rs": (jax_gemm_rs, JaxRSConfig),
           "gemm_ar": (jax_gemm_ar, JaxARConfig)}
PORT = {"ag_gemm": ag_gemm.ag_gemm_shard,
        "gemm_rs": gemm_rs.gemm_rs_shard,
        "gemm_ar": gemm_ar.gemm_ar_shard}
# where each op's operands and output are split (JAX PartitionSpecs)
SPECS = {"ag_gemm": (P("tp", None), P(None, "tp"), P(None, "tp")),
         "gemm_rs": (P(None, "tp"), P("tp", None), P("tp", None)),
         "gemm_ar": (P(None, "tp"), P("tp", None), P(None, None))}
RUNS = [(op, n, dt) for op in CASES for n, dt in
        ((2, "float32"), (4, "float32"), (4, "bfloat16"))]


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("tp",))


def _spec_dim(spec):
    return next((d for d, a in enumerate(spec) if a == "tp"), None)


def _operands(op, seed=0):
    (M, K, N), _, _ = CASES[op]
    rng = np.random.RandomState(seed)
    return (rng.randn(M, K).astype(np.float32) / np.sqrt(K),
            rng.randn(K, N).astype(np.float32) / np.sqrt(K))


def _port_stack(x, dtype, spec, n):
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return shard(t, _spec_dim(spec), n)


@pytest.fixture(scope="module")
def jax_runs():
    """Each JAX kernel once per (op, n, dtype) in interpret mode, with the
    dispatch it logged."""
    out = {}
    for op, n, dt in RUNS:
        a, b = _operands(op)
        fn, cfg_cls = JAX_FNS[op]
        mesh = _mesh(n)
        sa, sb, _ = SPECS[op]
        a_s = jax.device_put(jnp.asarray(a, dt), NamedSharding(mesh, sa))
        b_s = jax.device_put(jnp.asarray(b, dt), NamedSharding(mesh, sb))
        jax_common.reset_dispatch()
        got = jax.jit(functools.partial(
            fn, mesh=mesh, config=cfg_cls(**CASES[op][1])))(a_s, b_s)
        out[(op, n, dt)] = (np.asarray(got, np.float32),
                            jax_common.dispatch_counts())
    return out


@pytest.mark.parametrize("op,n,dtype", RUNS)
def test_plain_version_matches_the_jax_kernel(jax_runs, op, n, dtype):
    want, jax_log = jax_runs[(op, n, dtype)]
    assert jax_log == {(op, "kernel", ""): 1}
    a, b = _operands(op)
    sa, sb, so = SPECS[op]
    _common.reset_dispatch()
    got = PORT[op](_port_stack(a, dtype, sa, n), _port_stack(b, dtype, sb, n),
                   num_ranks=n)
    assert _common.dispatch_counts() == jax_log
    if op == "gemm_ar":          # every rank's replica of the sum
        assert got.shape[0] == n and all(torch.equal(g, got[0]) for g in got)
        got = got[0]
    else:
        got = unshard(got, _spec_dim(so))
    tol = 1e-5 if dtype == "float32" else CASES[op][2]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_rank_group_collectives_match_lax():
    """all_gather (tiled on either axis, and stacked), psum, psum_scatter
    and axis_index of the rank group against lax under shard_map."""
    n = 4
    x = np.random.RandomState(0).randn(n * 8, 5).astype(np.float32)
    mesh = _mesh(n)

    def body(xs):
        return (jax.lax.all_gather(xs, "tp", tiled=True),
                jax.lax.all_gather(xs, "tp", axis=1, tiled=True),
                jax.lax.all_gather(xs, "tp"),
                jax.lax.psum(xs, "tp"),
                jax.lax.psum_scatter(xs, "tp", scatter_dimension=0,
                                     tiled=True),
                jax.lax.axis_index("tp")[None])

    want = jax.jit(shard_map(
        body, mesh=mesh, in_specs=P("tp", None),
        out_specs=(P(), P(), P(), P(), P("tp", None), P("tp")),
        check_vma=False))(jnp.asarray(x))
    g = RankGroup(n)
    xs = shard(torch.from_numpy(x), 0, n)               # (n, 8, 5)
    got = (g.all_gather(xs, tiled=True), g.all_gather(xs, axis=1, tiled=True),
           g.all_gather(xs), g.psum(xs),
           unshard(g.psum_scatter(xs), 0), g.axis_index())
    for w, t in zip(want, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="rank-stacked"):
        g.psum(torch.zeros(3, 2))
    with pytest.raises(ValueError):
        RankGroup(0)


@pytest.mark.parametrize("op,n,shape,cfg", [
    ("ag_gemm", 4, (64, 256, 128), dict(block_m=16, block_k=128)),
    ("ag_gemm", 2, (48, 256, 128), dict(block_m=16, block_k=128)),
    ("ag_gemm", 2, (64, 256, 128), dict(use_xla=True)),
    ("ag_gemm", 1, (64, 256, 128), {}),
    ("gemm_rs", 4, (64, 256, 128), dict(block_m=16, block_k=64)),
    ("gemm_rs", 2, (64, 256, 128), dict(block_m=16, block_k=96)),
    ("gemm_rs", 1, (64, 256, 128), {}),
    ("gemm_ar", 2, (16, 256, 128), dict(block_m=16, block_k=64)),
    ("gemm_ar", 4, (24, 256, 128), dict(block_m=16, block_k=64)),
    ("gemm_ar", 4, (16, 256, 128), dict(use_xla=True)),
])
def test_dispatch_log_matches_jax(op, n, shape, cfg):
    """The same shapes and configs take the same path with the same reason
    (kernel, requested, n==1), except where JAX's tile-divisibility rule
    sends the call to its plain path: the CUDA kernels mask ragged tiles,
    so the port's op takes its kernel there. JAX traced only."""
    M, K, N = shape
    fn, cfg_cls = JAX_FNS[op]
    mesh = _mesh(n)
    sa, sb, _ = SPECS[op]
    jax_common.reset_dispatch()
    jax.eval_shape(functools.partial(fn, mesh=mesh, config=cfg_cls(**cfg)),
                   jax.ShapeDtypeStruct((M, K), jnp.float32,
                                        sharding=NamedSharding(mesh, sa)),
                   jax.ShapeDtypeStruct((K, N), jnp.float32,
                                        sharding=NamedSharding(mesh, sb)))
    want = {((o, "kernel", "") if why == "divisibility" else (o, p, why)): c
            for (o, p, why), c in jax_common.dispatch_counts().items()}
    _common.reset_dispatch()
    PORT[op](shard(torch.zeros(M, K), _spec_dim(sa), n),
             shard(torch.zeros(K, N), _spec_dim(sb), n), num_ranks=n,
             use_xla=cfg.get("use_xla", False))
    assert _common.dispatch_counts() == want, (want, _common.dispatch_counts())


def test_port_shape_rule_and_refusals():
    """The port's limits in place of JAX's VMEM rule raise on the kernel
    path, on every device: an N that is not a multiple of 8, a dtype the
    kernel does not take, mixed dtypes; the same operands at one rank take
    the plain path (logged "n==1"). Ragged rows take the kernel.
    Non-rank-stacked operands raise."""
    for a, b in ((torch.zeros(2, 16, 64), torch.ones(2, 64, 12)),
                 (torch.zeros(2, 16, 64, dtype=torch.float16),
                  torch.ones(2, 64, 16, dtype=torch.float16)),
                 (torch.zeros(2, 16, 64), torch.ones(2, 64, 16).bfloat16())):
        _common.reset_dispatch()
        with pytest.raises(ValueError, match="ag_gemm: the kernel takes"):
            ag_gemm.ag_gemm_shard(a, b, num_ranks=2)
        assert _common.dispatch_counts() == {}
        out = ag_gemm.ag_gemm_shard(a[:1], b[:1], num_ranks=1)
        assert out.shape == (1, 16, b.shape[2])
        assert _common.dispatch_counts() == {("ag_gemm", "xla", "n==1"): 1}
    _common.reset_dispatch()
    out = gemm_ar.gemm_ar_shard(torch.ones(4, 3, 24), torch.ones(4, 24, 8),
                                num_ranks=4)
    assert _common.dispatch_counts() == {("gemm_ar", "kernel", ""): 1}
    assert torch.equal(out, torch.full((4, 3, 8), 96.))
    with pytest.raises(ValueError, match="rank-stacked"):
        gemm_ar.gemm_ar_shard(torch.zeros(8, 16), torch.zeros(16, 8),
                              num_ranks=2)
    t = torch.arange(24.).reshape(2, 3, 4)
    for dim in range(3):
        if t.shape[dim] % 2 == 0:
            assert torch.equal(unshard(shard(t, dim, 2, at=1), dim, at=1), t)
