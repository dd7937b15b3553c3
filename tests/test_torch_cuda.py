"""The port's CUDA kernels against their plain PyTorch versions, on the
GPU. Every test here needs an NVIDIA GPU with nvcc and skips without one.
The file imports neither jax nor the JAX package, so it runs on a GPU
box without them:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: outputs are bf16, compared at 2e-2 absolute (bf16 rounding
of p and of the output at different points of a blocked vs one-shot
softmax); lse is f32 from f32 scores, compared at 1e-3 (summation order
and the exp2-based exponential).
"""

import pytest
import torch

from triton_distributed_tpu_torch.ops import attention as attn

pytestmark = pytest.mark.cuda

OUT_TOL = 2e-2
LSE_TOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _rand(shape, gen, device):
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32).to(torch.bfloat16)


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,causal", [
    (2, 100, 100, 4, 2, 64, True),
    (1, 70, 130, 8, 8, 128, True),
    (2, 64, 64, 4, 1, 128, False),
    (1, 33, 200, 10, 2, 128, False),
    (4, 512, 512, 32, 8, 128, True),
])
def test_flash_attention_kernel_matches_plain(cuda, B, Sq, Skv, H, Hkv, D,
                                              causal):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _rand((B, Sq, H, D), gen, cuda)
    k = _rand((B, Skv, Hkv, D), gen, cuda)
    v = _rand((B, Skv, Hkv, D), gen, cuda)
    before = attn.FLASH_ATTENTION.launches
    out = attn.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert attn.FLASH_ATTENTION.launches == before + 1
    ref, _ = attn._flash_attention_plain(
        q, k, v, Skv - Sq, 0, Skv, causal=causal, scale=D ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), atol=OUT_TOL,
                               rtol=0)


@pytest.mark.parametrize("q_off,kv_off,kv_valid,causal", [
    (96, 32, 90, True),      # partly visible shard, ragged valid prefix
    (0, 100, 128, True),     # shard entirely in the future: all masked
    (10, 0, 0, False),       # empty shard
    (40, 50, 100, True),     # first rows see nothing, later rows do
])
def test_flash_attention_partial_kernel_matches_plain(cuda, q_off, kv_off,
                                                      kv_valid, causal):
    gen = torch.Generator(device=cuda).manual_seed(1)
    B, Sq, Skv, H, Hkv, D = 2, 80, 128, 8, 2, 128
    q = _rand((B, Sq, H, D), gen, cuda)
    k = _rand((B, Skv, Hkv, D), gen, cuda)
    v = _rand((B, Skv, Hkv, D), gen, cuda)
    out, lse = attn.flash_attention_partial(
        q, k, v, q_offset=q_off, kv_offset=kv_off, kv_valid=kv_valid,
        causal=causal)
    ref, ref_lse = attn._flash_attention_plain(
        q, k, v, q_off, kv_off, kv_valid, causal=causal, scale=D ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), atol=OUT_TOL,
                               rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=LSE_TOL, rtol=1e-6)


@pytest.mark.parametrize("G,D", [(1, 64), (2, 128), (4, 128), (5, 128),
                                 (8, 64), (10, 128)])
def test_flash_decode_kernel_matches_plain(cuda, G, D):
    gen = torch.Generator(device=cuda).manual_seed(2)
    B, Skv, Hkv = 5, 300, 2
    H = G * Hkv
    q = _rand((B, H, D), gen, cuda)
    k = _rand((B, Skv, Hkv, D), gen, cuda)
    v = _rand((B, Skv, Hkv, D), gen, cuda)
    kv_len = torch.tensor([0, 1, 31, 257, 300], dtype=torch.int32,
                          device=cuda)
    before = attn.FLASH_DECODE.launches
    out, lse = attn.flash_decode_partial(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert attn.FLASH_DECODE.launches == before + 1
    ref, ref_lse = attn._flash_decode_plain(q, k, v, kv_len,
                                            scale=D ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), atol=OUT_TOL,
                               rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=LSE_TOL, rtol=1e-6)
    assert torch.all(out[0] == 0)


def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros((1, 8, 2, 64), device=cuda)
    with pytest.raises(TypeError):
        attn.flash_attention(q, q, q)
    qb = torch.zeros((1, 8, 4, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        attn.flash_attention(qb[:, :, ::2], qb[:, :, ::2], qb[:, :, ::2])
    q32 = torch.zeros((2, 4, 32), device=cuda, dtype=torch.bfloat16)
    kv32 = torch.zeros((2, 8, 1, 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):    # head_dim 32 has no kernel
        attn.flash_decode(q32, kv32, kv32, 4)
