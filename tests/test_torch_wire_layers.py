"""The port's tensor-parallel layers with a quantized wire (`TPMLP` /
`TPAttn(wire_dtype=)`, layers/common.row_parallel_out) against the JAX
package's layers, on the CPU, f32.

- TPMLP forward and TPAttn prefill and decode in the four modes ("fused"
  and "gemm_ar" through the quant arms' plain versions, against the JAX
  `_kernel_quant` kernels in interpret mode; "ar" through
  `wire.quant_psum`; "xla" full width, the golden), at n 2 with an int8
  wire and at n 4 with an fp8 wire.
  Tolerance against the JAX layer: 1e-5 (rtol and atol, the JAX tests'
  f32 tolerance) plus twice `wire.sum_error_bound` of the layer's
  row-parallel partials (an element on a quantization boundary may land
  one step, twice the per-element bound, away on each source).
- Against the layer's own output at `wire_dtype=None`: within
  `sum_error_bound` and within 8 * quant_eps of the largest value (JAX
  tests/test_collectives.py:289-303).

The paged shards with a wire are held to JAX through ServeEngine in
tests/test_torch_wire_serve.py. Each JAX layer runs once a process per
case, when a test first needs it; its attention kernels run in the plain
Pallas interpreter (no DMA or semaphore in them), its communication
kernels in the TPU interpreter.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from triton_distributed_tpu import runtime as jruntime
from triton_distributed_tpu.layers import tp_attn as jtp_attn
from triton_distributed_tpu.layers import tp_mlp as jtp_mlp
from triton_distributed_tpu.ops import attention as jattn
from triton_distributed_tpu_torch.layers import tp_attn as ttp_attn
from triton_distributed_tpu_torch.layers import tp_mlp as ttp_mlp
from triton_distributed_tpu_torch.ops import _common, wire
from triton_distributed_tpu_torch.parallel import shard

MODES = ("fused", "gemm_ar", "ar", "xla")
WIRES = ("int8", "float8_e4m3fn")
# every mode at n 2 with an int8 wire and at n 4 with an fp8 wire
LAYER_CASES = [(n, mode, wd) for n, wd in zip((2, 4), WIRES)
               for mode in MODES]
HIDDEN, INTER, H, HKV, D = 128, 256, 4, 4, 16
B, S = 2, 8


class PlainInterpreter:
    """The JAX package's runtime module, but with the plain Pallas
    interpreter (interpret=True) for the kernels of ops/attention.py."""

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


def _arrays(seed, *shapes, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("tp",))


class Partials:
    """Records every row-parallel epilogue's partials (rows @ w, rank by
    rank) of one port layer, to derive the wire's error bound."""

    def __init__(self, monkeypatch, module):
        self.seen = []
        real = module.row_parallel_out

        def spy(rows, w, **kw):
            self.seen.append((rows.float() @ w.float()).detach())
            return real(rows, w, **kw)

        monkeypatch.setattr(module, "row_parallel_out", spy)

    def bound(self, i, wd, shape):
        return wire.sum_error_bound(self.seen[i], wd).reshape(shape)


def _check(got, want, full, bound, wd, quantized):
    """The port's wire output against the JAX layer's, and against its own
    full-width output."""
    got, full = got.numpy(), full.numpy()
    want = np.asarray(want, np.float32).reshape(got.shape)
    err = np.abs(got - want)
    assert np.all(err <= 1e-5 + 1e-5 * np.abs(want) + 2 * bound), err.max()
    dev = np.abs(got - full)
    assert np.all(dev <= bound + 1e-5 + 1e-5 * np.abs(full)), dev.max()
    scale = max(np.abs(full).max(), 1e-9)
    assert dev.max() / scale < 8 * wire.quant_eps(wd)
    assert (dev.max() > 0) == quantized


# -- TPMLP --------------------------------------------------------------------

def _mlp_weights():
    x, gate, up, down = _arrays(2, (B * S, HIDDEN), (HIDDEN, INTER),
                                (HIDDEN, INTER), (INTER, HIDDEN),
                                scale=HIDDEN ** -0.5)
    return x * HIDDEN ** 0.5, gate, up, down


@functools.lru_cache(maxsize=None)
def _jax_mlp(n, mode, wd):
    """The JAX TPMLP's output at (n, mode, wire)."""
    x, gate, up, down = _mlp_weights()
    mesh = _mesh(n)
    jl = jtp_mlp.TPMLP(HIDDEN, INTER, mesh=mesh, mode=mode, wire_dtype=wd)
    jp = jl.shard_params(*(jnp.asarray(a) for a in (gate, up, down)))
    spec = P("tp", None) if mode in ("xla", "fused") else P()
    jx = jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))
    return np.asarray(jax.jit(jl.__call__)(jp, jx))


@pytest.mark.parametrize("n,mode,wd", LAYER_CASES)
def test_tp_mlp_wire_equals_jax(monkeypatch, n, mode, wd):
    x, gate, up, down = (torch.from_numpy(a) for a in _mlp_weights())
    seq = mode in ("xla", "fused")
    xin = shard(x, 0, n) if seq else x
    full_l = ttp_mlp.TPMLP(HIDDEN, INTER, mode=mode, num_ranks=n)
    full = full_l(full_l.shard_params(gate, up, down), xin)
    tl = ttp_mlp.TPMLP(HIDDEN, INTER, mode=mode, num_ranks=n, wire_dtype=wd)
    spy = Partials(monkeypatch, ttp_mlp)
    _common.reset_dispatch()
    got = tl(tl.shard_params(gate, up, down), xin)
    want_log = {"fused": {("ag_gemm", "kernel", ""): 1,
                          ("gemm_rs", "kernel", "wire"): 1},
                "gemm_ar": {("gemm_ar", "kernel", "wire"): 1}}
    assert _common.dispatch_counts() == want_log.get(mode, {})
    _check(got.reshape(B * S, HIDDEN), _jax_mlp(n, mode, wd),
           full.reshape(B * S, HIDDEN), spy.bound(0, wd, (B * S, HIDDEN)),
           wd, quantized=mode != "xla")


# -- TPAttn prefill and decode --------------------------------------------------

def _attn_weights():
    x, wq, wk, wv, wo = _arrays(3, (B, S + 1, HIDDEN), (HIDDEN, H * D),
                                (HIDDEN, HKV * D), (HIDDEN, HKV * D),
                                (H * D, HIDDEN), scale=HIDDEN ** -0.5)
    qn, kn = (1.0 + 0.1 * a for a in _arrays(4, (D,), (D,)))
    return x * HIDDEN ** 0.5, (wq, wk, wv, wo), qn, kn


@functools.lru_cache(maxsize=None)
def _jax_attn(n, mode, wd):
    """The JAX TPAttn's prefill of S rows and decode of row S at (n, mode,
    wire)."""
    x, ws, qn, kn = _attn_weights()
    jl = jtp_attn.TPAttn(HIDDEN, H, HKV, D, mesh=_mesh(n), mode=mode,
                         qk_norm=True, wire_dtype=wd)
    jp = jl.shard_params(*(jnp.asarray(a) for a in ws), q_norm=qn,
                         k_norm=kn)
    jx = jnp.asarray(x)
    cache = jl.new_kv_cache(B, S + 1, dtype=jnp.float32)
    y, cache = jax.jit(jl.prefill)(jp, jx[:, :S], cache)
    yd, _ = jax.jit(jl.decode)(jp, jx[:, S], cache, S)
    return np.asarray(y), np.asarray(yd)


@pytest.mark.parametrize("n,mode,wd", LAYER_CASES)
def test_tp_attn_wire_equals_jax(monkeypatch, n, mode, wd):
    x, ws, qn, kn = _attn_weights()
    x = torch.from_numpy(x)
    ws = [torch.from_numpy(a) for a in ws]
    norms = dict(q_norm=torch.from_numpy(qn), k_norm=torch.from_numpy(kn))
    runs = []
    for wire_dtype in (None, wd):
        tl = ttp_attn.TPAttn(HIDDEN, H, HKV, D, mode=mode, qk_norm=True,
                             num_ranks=n, wire_dtype=wire_dtype)
        tp = tl.shard_params(*ws, **norms)
        spy = Partials(monkeypatch, ttp_attn)
        y, cache = tl.prefill(tp, x[:, :S], max_len=S + 1)
        yd, _ = tl.decode(tp, x[:, S], cache, S)
        runs.append((y, yd, spy))
    (fy, fyd, _), (y, yd, spy) = runs
    jy, jyd = _jax_attn(n, mode, wd)
    # prefill rows are sequence-major at the epilogue: (S * B, hidden)
    b_pre = spy.bound(0, wd, (S, B, HIDDEN)).transpose(1, 0, 2)
    _check(y, jy, fy, b_pre, wd, quantized=mode != "xla")
    # decode ends in "gemm_ar" in that mode, else "ar": quantized always
    _check(yd, jyd, fyd, spy.bound(1, wd, (B, HIDDEN)), wd, quantized=True)


def test_tp_attn_prefill_at_n_ranks_without_gqa():
    """A fault found here and repaired: with one q head per kv head (no
    GQA) the plain prefill attention returned a non-contiguous output,
    and the n-rank prefill's `view` of it raised. The n-rank layer in
    every mode now equals the one-rank layer on the same weights."""
    g = torch.Generator().manual_seed(0)
    ws = [torch.randn(s, generator=g) / 6 for s in
          ((32, 32), (32, 32), (32, 32), (32, 32))]
    x = torch.randn(2, 4, 32, generator=g)
    one = ttp_attn.TPAttn(32, 4, 4, 8)
    want, _ = one.prefill(one.shard_params(*ws), x)
    for mode in MODES:
        tl = ttp_attn.TPAttn(32, 4, 4, 8, mode=mode, num_ranks=2)
        got, _ = tl.prefill(tl.shard_params(*ws), x)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
