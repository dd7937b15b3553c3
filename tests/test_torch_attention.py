"""The port's attention ops (triton_distributed_tpu_torch/ops/attention.py)
against the JAX package's on the same numpy inputs, on the CPU.

The JAX kernels run as the JAX tests run them here (Pallas in interpret
mode, jitted so that cases of one shape share one compile); the port's
wrappers take their plain PyTorch versions because the tensors lie on
the CPU. Tolerances: f32 1e-5 (summation order: the JAX
kernel's blocked online softmax against the port's one-shot softmax);
bf16 2e-2 (rounding points: p and the output are rounded to bf16 at
different points of the two softmaxes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_distributed_tpu.ops import attention as jattn
from triton_distributed_tpu_torch.ops import attention as tattn

F32_TOL = 1e-5
BF16_TOL = 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


_jax_flash_attention = jax.jit(jattn.flash_attention,
                               static_argnames=("causal",))
_jax_flash_attention_partial = jax.jit(jattn.flash_attention_partial,
                                       static_argnames=("causal",))
_jax_flash_decode_partial = jax.jit(jattn.flash_decode_partial)


def _inputs(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("causal,Sq,Skv,dtype", [
    (True, 12, 20, "float32"),
    (False, 16, 16, "bfloat16"),
])
def test_flash_attention_matches_jax(causal, Sq, Skv, dtype):
    B, H, Hkv, D = 2, 4, 2, 16          # GQA: two q heads per kv head
    (jq, jk, jv), (q, k, v) = _both(
        _inputs(0, (B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)), dtype)
    want = _jax_flash_attention(jq, jk, jv, causal=causal)
    got = tattn.flash_attention(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("q_off,kv_off,kv_valid,causal", [
    (24, 8, 14, True),       # partly visible shard, ragged valid prefix
    (0, 40, 24, True),       # shard entirely in the future: all rows masked
    (5, 0, 0, True),         # empty shard
])
def test_flash_attention_partial_matches_jax(q_off, kv_off, kv_valid,
                                             causal):
    B, Sq, Skv, H, Hkv, D = 2, 16, 24, 4, 2, 16
    (jq, jk, jv), (q, k, v) = _both(
        _inputs(1, (B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)),
        "float32")
    want, want_lse = _jax_flash_attention_partial(
        jq, jk, jv, q_offset=q_off, kv_offset=kv_off, kv_valid=kv_valid,
        causal=causal)
    got, lse = tattn.flash_attention_partial(
        q, k, v, q_offset=q_off, kv_offset=kv_off, kv_valid=kv_valid,
        causal=causal)
    _close(got, want, F32_TOL)
    assert lse.dtype == torch.float32 and lse.shape == (B, Sq, H)
    _close(lse, want_lse, F32_TOL)


def test_flash_attention_partial_fully_masked_rows():
    """Rows 0..5 (global 4..9) see no column of a shard starting at 10,
    while later rows of the same q block do. Both packages give
    lse ~ -1e30 there, so a merge weights those rows to zero; the port's
    out is 0 there, the JAX kernel's is the block's mean of v (its p is
    exp(0) = 1 for a row whose running max is still -1e30), which no
    merge reads. Every other row agrees."""
    B, Sq, Skv, H, Hkv, D = 2, 16, 24, 4, 2, 16
    (jq, jk, jv), (q, k, v) = _both(
        _inputs(2, (B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)),
        "float32")
    want, want_lse = _jax_flash_attention_partial(
        jq, jk, jv, q_offset=4, kv_offset=10, kv_valid=Skv, causal=True)
    got, lse = tattn.flash_attention_partial(q, k, v, q_offset=4,
                                             kv_offset=10)
    masked = 6
    _close(lse, want_lse, F32_TOL)
    assert torch.all(lse[:, :masked] < -1e29)
    assert torch.all(got[:, :masked] == 0)
    _close(got[:, masked:], np.asarray(want)[:, masked:], F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_partial_matches_jax(dtype):
    B, Skv, H, Hkv, D = 4, 24, 4, 2, 16
    (jq, jk, jv), (q, k, v) = _both(
        _inputs(3, (B, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)), dtype)
    lens = np.array([0, 1, 9, 24], np.int32)   # ragged, one empty row
    want, want_lse = _jax_flash_decode_partial(jq, jk, jv,
                                               jnp.asarray(lens))
    got, lse = tattn.flash_decode_partial(q, k, v, torch.from_numpy(lens))
    tol = DTYPES[dtype][2]
    _close(got, want, tol)
    _close(lse, want_lse, tol)
    assert torch.all(got[0] == 0) and lse[0].max() < -1e29
    _close(tattn.flash_decode(q, k, v, torch.from_numpy(lens)), want, tol)


def test_partial_merges_match_jax():
    o1, o2, outs = _inputs(4, (3, 5, 8), (3, 5, 8), (4, 3, 5, 8))
    l1, l2, lses = _inputs(5, (3, 5), (3, 5), (4, 3, 5))
    l2[0, 0] = -1e30                      # an empty partial
    jm, jl = jattn.merge_two_partials(*(jnp.asarray(a)
                                        for a in (o1, l1, o2, l2)))
    tm, tl = tattn.merge_two_partials(*(torch.from_numpy(a)
                                        for a in (o1, l1, o2, l2)))
    _close(tm, jm, F32_TOL)
    _close(tl, jl, F32_TOL)
    want = jattn.combine_partials(jnp.asarray(outs), jnp.asarray(lses))
    _close(tattn.combine_partials(torch.from_numpy(outs),
                                  torch.from_numpy(lses)), want, F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_jax(dtype):
    B, S, H, D = 2, 10, 3, 16
    (jx,), (x,) = _both(_inputs(6, (B, S, H, D)), dtype)
    pos = np.arange(S, dtype=np.int32) + 1000
    jc, js = jattn.rope_cos_sin(jnp.asarray(pos), D, theta=1e6)
    c, s = tattn.rope_cos_sin(torch.from_numpy(pos), D, theta=1e6)
    _close(c, jc, F32_TOL)
    _close(s, js, F32_TOL)
    tol = DTYPES[dtype][2]
    _close(tattn.apply_rope(x, c, s), jattn.apply_rope(jx, jc, js), tol)
    bpos = np.stack([pos, pos + 7])             # (B, S) positions
    jc3, js3 = jattn.rope_cos_sin(jnp.asarray(bpos), D)
    c3, s3 = tattn.rope_cos_sin(torch.from_numpy(bpos), D)
    _close(tattn.apply_rope(x, c3, s3), jattn.apply_rope(jx, jc3, js3), tol)


def test_mha_reference_matches_jax():
    (jq, jk, jv), (q, k, v) = _both(
        _inputs(7, (2, 6, 4, 8), (2, 9, 2, 8), (2, 9, 2, 8)), "float32")
    for causal in (True, False):
        _close(tattn.mha_reference(q, k, v, causal=causal),
               jattn.mha_reference(jq, jk, jv, causal=causal), F32_TOL)


def test_cpu_tensors_take_the_plain_path():
    q, k, v = (torch.randn(1, 8, 2, 64, dtype=torch.bfloat16)
               for _ in range(3))
    before = (tattn.FLASH_ATTENTION.launches, tattn.FLASH_DECODE.launches)
    tattn.flash_attention(q, k, v)
    tattn.flash_decode(q[:, 0], k, v, 5)
    assert (tattn.FLASH_ATTENTION.launches,
            tattn.FLASH_DECODE.launches) == before
    with pytest.raises(ValueError):           # no kernel for this device
        tattn.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


def test_attention_rejects_bad_shapes():
    q = torch.zeros(1, 8, 3, 16)
    kv = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError):           # 3 q heads over 2 kv heads
        tattn.flash_attention(q, kv, kv)
    with pytest.raises(ValueError):           # kv_valid past the shard
        tattn.flash_attention_partial(q[:, :, :2], kv, kv, q_offset=0,
                                      kv_offset=0, kv_valid=9)
