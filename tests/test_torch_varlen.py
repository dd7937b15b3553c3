"""The port's varlen attention against the JAX package, on the CPU (f32,
inputs from numpy seeds, the sizes of JAX's tests/test_varlen.py):

- `row_segments` / `segment_sideband` bit for bit;
- `flash_attention_varlen` (ragged lengths, both masks; a trailing pad past
  cu_seqlens[-1], whose rows must come out exactly 0) and
  `flash_attention_varlen_partial` at nonzero offsets and a short kv_valid,
  out and lse, against JAX's Pallas kernel;
- `ring_attention_varlen` at n = 4 with a sequence across three shards,
  against JAX's ring on the 4-device mesh;
- the checks the port keeps from JAX: block_q / block_k, the sideband's
  shape.

Outputs and lse agree within 1e-5. The JAX attention kernels (no DMA, no
semaphore) run in the plain Pallas interpreter; each JAX call runs once per
case (`functools.lru_cache`).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_distributed_tpu import runtime as jruntime
from triton_distributed_tpu.ops import attention as jattn
from triton_distributed_tpu.ops import sp_attention as jsp
from triton_distributed_tpu_torch.ops import attention as tattn
from triton_distributed_tpu_torch.ops import sp_attention as tsp

TOL = 1e-5
H, HKV, D = 4, 2, 8


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


def _packed(seed, total):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(total, h, D)).astype(np.float32)
                 for h in (H, HKV, HKV))


def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("lens,total,rows_pad", [
    ((5, 17, 2, 9), 33, None), ((5, 17, 2, 9), 33, 40),
    ((6, 8), 18, 24), ((64,), 64, None)])
def test_segment_sideband_equals_jax_bit_for_bit(lens, total, rows_pad):
    cu = _cu(lens)
    want = np.asarray(jattn.segment_sideband(jnp.asarray(cu), total,
                                             rows_pad))
    got = tattn.segment_sideband(_t(cu), total, rows_pad)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for a, b in zip(tattn.row_segments(_t(cu), total),
                    jattn.row_segments(jnp.asarray(cu), total)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tattn.SIDEBAND_PAD_START == jattn.SIDEBAND_PAD_START


# lens, rows past cu_seqlens[-1], causal
VARLEN_CASES = {"ragged_causal": ((5, 17, 2, 9), 0, True),
                "ragged_full": ((5, 17, 2, 9), 0, False),
                "trailing_pad": ((6, 8), 4, True)}


@functools.lru_cache(maxsize=None)
def jax_varlen(case):
    lens, pad, causal = VARLEN_CASES[case]
    q, k, v = _packed(0, sum(lens) + pad)
    fn = jax.jit(functools.partial(jattn.flash_attention_varlen,
                                   causal=causal, block_q=8, block_k=8))
    return np.asarray(fn(q, k, v, jnp.asarray(_cu(lens))))


@pytest.mark.parametrize("case", list(VARLEN_CASES))
def test_flash_attention_varlen_equals_jax(case):
    lens, pad, causal = VARLEN_CASES[case]
    q, k, v = _packed(0, sum(lens) + pad)
    got = tattn.flash_attention_varlen(_t(q), _t(k), _t(v), _t(_cu(lens)),
                                       causal=causal, block_q=8, block_k=8)
    want = jax_varlen(case)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    if pad:
        assert (got[sum(lens):] == 0).all()


@functools.lru_cache(maxsize=None)
def jax_varlen_partial():
    q, k, v, meta, kw = _partial_inputs()
    fn = jax.jit(functools.partial(jattn.flash_attention_varlen_partial,
                                   block_q=8, block_k=8, **kw))
    out, lse = fn(q, k, v, jnp.asarray(meta))
    return np.asarray(out), np.asarray(lse)


def _partial_inputs():
    """A 16-row q shard at global rows [16, 32) against a 16-row kv shard
    at [8, 24), 13 of them valid, of a packed batch [0, 10), [10, 30),
    [30, 40): rows that see nothing (the first of a sequence at the
    causal edge) and rows cut by kv_valid."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(16, H, D)).astype(np.float32)
    k = rng.normal(size=(16, HKV, D)).astype(np.float32)
    v = rng.normal(size=(16, HKV, D)).astype(np.float32)
    meta = np.asarray(jattn.segment_sideband(
        jnp.asarray(_cu((10, 20, 10))), 40))[16:32]
    return q, k, v, meta, dict(q_offset=16, kv_offset=8, kv_valid=13,
                               causal=True)


def test_flash_attention_varlen_partial_equals_jax():
    q, k, v, meta, kw = _partial_inputs()
    out, lse = tattn.flash_attention_varlen_partial(
        _t(q), _t(k), _t(v), _t(meta), block_q=8, block_k=8, **kw)
    want_out, want_lse = jax_varlen_partial()
    np.testing.assert_allclose(out.numpy(), want_out, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=TOL, atol=TOL)


@functools.lru_cache(maxsize=None)
def jax_ring_varlen(mesh):
    q, k, v = _packed(2, 64)
    fn = jax.jit(functools.partial(jsp.ring_attention_varlen, mesh=mesh,
                                   axis="tp", causal=True, block_q=8,
                                   block_k=8))
    return np.asarray(fn(q, k, v, jnp.asarray(_cu((10, 30, 24)))))


def test_ring_attention_varlen_equals_jax(mesh4):
    """Packed lens [10, 30, 24] over 4 ranks of 16 rows: the 30-row
    sequence crosses ranks 0-2, the 24-row one ranks 2-3."""
    q, k, v = _packed(2, 64)
    got = tsp.ring_attention_varlen(_t(q), _t(k), _t(v),
                                    _t(_cu((10, 30, 24))), num_ranks=4,
                                    causal=True, block_q=8, block_k=8)
    np.testing.assert_allclose(got.numpy(), jax_ring_varlen(mesh4),
                               rtol=TOL, atol=TOL)


def test_the_varlen_checks_follow_jax():
    q, k, v = (_t(a) for a in _packed(0, 16))
    cu = _t(_cu((16,)))
    for bad in (0, 12, 7.5):
        with pytest.raises(ValueError, match="block_q"):
            tattn.flash_attention_varlen(q, k, v, cu, block_q=bad)
    with pytest.raises(ValueError, match="block_k"):
        tattn.flash_attention_varlen(q, k, v, cu, block_k=4)
    # the partial takes JAX's sideband shape, (round_up(T, bq), 128)
    meta = tattn.segment_sideband(cu, 16, 16)
    with pytest.raises(ValueError, match="qmeta"):
        tattn.flash_attention_varlen_partial(q, k, v, meta[:8], q_offset=0,
                                             kv_offset=0, block_q=8)
    with pytest.raises(ValueError, match="do not split"):
        tsp.ring_attention_varlen(q[:15], k[:15], v[:15],
                                  _t(_cu((15,))), num_ranks=4)
    # block_q 128 pads the sideband to round_up(T, min(128, round_up(T, 8)))
    assert tattn._varlen_rows(10, 128) == 16
    assert tattn._varlen_rows(40, 16) == 48
