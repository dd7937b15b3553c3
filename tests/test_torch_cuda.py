"""The port's CUDA kernels (prefill flash attention, decode, and the paged
decode over bf16, int8 and fp8 pools) against their plain PyTorch
versions, on the GPU. Every test here needs an NVIDIA GPU with nvcc and skips without one.
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


def _paged_case(gen, device, G, D, kv_dtype, blk=64):
    """A ragged paged batch: a shuffled table with a page shared by
    slots 0 and 2, a -1 hole inside slot 1's range (it reads page 0),
    -1 past each end, an empty slot 3, and lengths that end mid-page."""
    from triton_distributed_tpu_torch.models.paged_kv_cache import quant_kv
    B, Hkv, nb, mb = 4, 2, 12, 5
    table = torch.tensor([[7, 2, -1, -1, -1], [9, -1, 11, 3, 4],
                          [7, 0, 5, -1, -1], [-1] * 5], dtype=torch.int32,
                         device=device)
    kv_len = torch.tensor([blk + 5, 4 * blk + 1, 3 * blk, 0],
                          dtype=torch.int32, device=device)
    q = _rand((B, G * Hkv, D), gen, device)
    k, v = (torch.randn((nb, Hkv, blk, D), generator=gen, device=device)
            for _ in range(2))
    if kv_dtype is None:
        return q, k.bfloat16(), v.bfloat16(), table, kv_len, {}
    (kq, ks), (vq, vs) = quant_kv(k, kv_dtype), quant_kv(v, kv_dtype)
    return q, kq, vq, table, kv_len, {"k_scales": ks, "v_scales": vs}


@pytest.mark.parametrize("arm", ["bfloat16", "int8", "float8_e4m3fn"])
@pytest.mark.parametrize("G,D,blk", [(1, 64, 32), (4, 128, 128),
                                     (8, 128, 64), (4, 64, 256)])
def test_flash_decode_paged_kernel_matches_plain(cuda, arm, G, D, blk):
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, table, kv_len, kw = _paged_case(
        gen, cuda, G, D, None if arm == "bfloat16" else arm, blk)
    kernel = attn.FLASH_DECODE_PAGED[arm]
    before = kernel.launches
    out, lse = attn.flash_decode_paged_partial(q, k, v, table, kv_len, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ref, ref_lse = attn._flash_decode_paged_plain(q, k, v, table, kv_len,
                                                  scale=D ** -0.5, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=OUT_TOL,
                               rtol=0)
    torch.testing.assert_close(lse[:3], ref_lse[:3], atol=LSE_TOL, rtol=1e-6)
    assert torch.all(out[3] == 0) and torch.all(lse[3] < -1e29)


def test_flash_decode_paged_refuses_what_it_does_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v, table, kv_len, _ = _paged_case(gen, cuda, 4, 128, None)
    for bad in (k[:, :, :48], k[..., :32]):      # block 48, head_dim 32
        qq = q if bad.shape[-1] == 128 else q[..., :32].contiguous()
        with pytest.raises(ValueError):
            attn.flash_decode_paged_partial(qq, bad.contiguous(),
                                            bad.contiguous(), table, kv_len)
    with pytest.raises(ValueError):              # group 3
        attn.flash_decode_paged_partial(q[:, :6].contiguous(), k, v, table,
                                        kv_len)
    with pytest.raises(TypeError):               # f32 queries
        attn.flash_decode_paged_partial(q.float(), k, v, table, kv_len)
    with pytest.raises(TypeError):               # an fp16 pool
        attn.flash_decode_paged_partial(q, k.half(), v.half(), table, kv_len)
    with pytest.raises(NotImplementedError, match="slice 2b"):
        attn.flash_decode_paged(q, k, v, table, kv_len, method="xla")


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
