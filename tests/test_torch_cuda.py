"""The port's CUDA kernels (prefill flash attention, decode, the paged
decode over bf16, int8 and fp8 pools, the megakernel with its paged
serving bodies, and the MoE grouped GEMM) against their plain PyTorch
versions, on the GPU. Every test here needs an NVIDIA GPU with nvcc and skips without one.
The file imports neither jax nor the JAX package, so it runs on a GPU
box without them:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: outputs are bf16, compared at 2e-2 absolute (bf16 rounding
of p and of the output at different points of a blocked vs one-shot
softmax); lse is f32 from f32 scores, compared at 1e-3 (summation order
and the exp2-based exponential). The megakernel's outputs and appended
cache rows are compared as a fraction of the largest reference value:
1e-4 in f32 (summation order over two layers), 2e-2 in bf16 (a value
that rounds to the other side of a bf16 step in one task carries into
the next); so are the paged serving program's outputs and appends, and
every other pool row must be bitwise unchanged; so are the MoE serving
program's (its GROUPED_GEMM tasks sum the same products in other orders),
whose rows past a slot's live width must be exactly 0 and which must
give the same bits when every slab no live row routes to is NaN. The
grouped GEMM's bf16
outputs are compared at 2e-2 of the largest value: the kernel and the
plain version sum the same bf16 products in f32 in other orders and
round once to bf16, so they differ by at most a bf16 step or two of
each value. The small megakernel ServeEngine runs bf16 (the engine
path's prefill kernel takes bf16 only): its logits agree with the CPU's
within 5e-2 of the largest, its picks wherever the margin allows. The
megakernel's AR body (the cross-rank sum of an n-rank program) sums the
same f32 values in the same rank order as its plain walk and rounds
once, so it is held to it bit for bit. The quantized-wire arms of
gemm_rs / gemm_ar quantize an f32 accumulator that their plain versions
sum over K in another order, so a value on a rounding boundary may land
one quantization step away on a source: they are held within twice
wire.sum_error_bound of the partials and, in bf16, 99% of the elements
bit for bit. The collective kernels (all_gather, reduce_scatter,
all_reduce) copy bytes, or sum in f32 in their plain versions' order and
round at the same points, so each is held to its plain version bit for
bit; so are their quantized-wire arms and the quantized two-shot, which
quantize with the torch codec's IEEE divisions and add the dequantized
values in their plain versions' order. The varlen arm of the prefill kernel
and the fused AG + attention (csrc/sp_ag_attention.cu) are held to their
plain versions as the prefill kernel is (2e-2 / 1e-3: a blocked vs one-shot
softmax), rows outside the packed sequences exactly 0.
"""

import numpy as np
import pytest
import torch

from triton_distributed_tpu_torch.megakernel import executor_cuda as mkx
from triton_distributed_tpu_torch.megakernel.models import (
    build_qwen3_decode, build_qwen3_forward, build_qwen3_moe_serve_batched,
    build_qwen3_serve_batched, init_random_io)
from triton_distributed_tpu_torch.ops import attention as attn
from triton_distributed_tpu_torch.ops import grouped_gemm as gg
from triton_distributed_tpu_torch.ops import moe_utils

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
    (2, 300, 300, 32, 4, 128, True),     # GQA group 8 (Qwen3-30B-A3B)
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
                                 (8, 64), (8, 128), (10, 128)])
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


@pytest.mark.parametrize("arm", ["bfloat16", "int8", "float8_e4m3fn"])
def test_flash_decode_paged_zero_length_reads_no_page(cuda, arm):
    """A verify step's dead rows run at kv_len 0 over a table repeated K
    times: with every page (or, int8, every scale) NaN, such a row must
    still give exactly 0 and lse ~ -1e30, so no page was read; the live
    rows beside them see the NaN."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v, table, _, kw = _paged_case(
        gen, cuda, 4, 128, None if arm == "bfloat16" else arm, 64)
    if arm == "int8":
        kw = {n: torch.full_like(t, float("nan")) for n, t in kw.items()}
    else:
        k = torch.full_like(k.float(), float("nan")).to(k.dtype)
        v = k.clone()
    K = 3
    table = table.repeat_interleave(K, dim=0)
    kv_len = torch.zeros(table.shape[0], dtype=torch.int32, device=cuda)
    kv_len[0] = 5
    out, lse = attn.flash_decode_paged_partial(
        q.repeat_interleave(K, dim=0), k, v, table, kv_len, **kw)
    torch.cuda.synchronize()
    assert torch.isnan(out[0].float()).any()
    assert torch.all(out[1:] == 0) and torch.all(lse[1:] < -1e29)


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
    with pytest.raises(NotImplementedError, match="slice 2c"):
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


# -- the megakernel -----------------------------------------------------------

MK_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _mk_case(device, dtype, S, qk_norm, D, G=4, Hkv=2, layers=2,
             max_cache=160):
    mb = build_qwen3_decode(
        seq_len=S, hidden=256, intermediate=384, num_layers=layers,
        num_heads=G * Hkv, num_kv_heads=Hkv, head_dim=D,
        max_cache=max_cache, qk_norm=qk_norm, kv_append=True, dtype=dtype)
    ins, ws = init_random_io(mb, np.random.default_rng(S + D))
    prog = mb.compile("kernel", device=device)
    return mb, prog, ins, ws


def _mk_kernel_and_plain(prog, ins, cache_len):
    """Kernel outputs and caches, then the plain walk's from the same
    starting caches."""
    dt, dev = prog.dtype, prog.device
    start = {n: torch.as_tensor(ins[n]).to(dev, dt) for n in prog.graph.caches}
    x = torch.as_tensor(ins["x"]).to(dev, dt)
    runs = []
    for plain in (False, True):
        prog.bind_caches({n: t.clone() for n, t in start.items()})
        before = mkx.MEGAKERNEL.launches
        outs = prog.step({"x": x}, cache_len, plain=plain)
        torch.cuda.synchronize()
        prog.check_fault()
        assert mkx.MEGAKERNEL.launches == before + (0 if plain else 1)
        runs.append(([o.float().clone() for o in outs],
                     {n: t.float().clone() for n, t in prog.caches.items()}))
    return runs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,cache_len,qk_norm,D", [
    (1, 0, True, 128), (1, 37, True, 128), (1, 101, False, 64),
    (24, 0, True, 128), (24, 37, False, 128), (70, 13, True, 64),
])
def test_megakernel_matches_plain(cuda, dtype, S, cache_len, qk_norm, D):
    mb, prog, ins, ws = _mk_case(cuda, dtype, S, qk_norm, D)
    prog.bind_weights({n: torch.as_tensor(w).to(cuda, dtype)
                       for n, w in ws.items()})
    (ko, kc), (po, pc) = _mk_kernel_and_plain(prog, ins, cache_len)
    tol = MK_TOL[dtype]
    for a, b in zip(ko, po):
        assert torch.isfinite(a).all()
        err = (a - b).abs().max().item()
        assert err <= tol * b.abs().max().item(), err
    rows = slice(cache_len, cache_len + S)
    for n in kc:
        a, b = kc[n][rows], pc[n][rows]
        assert (a - b).abs().max().item() <= tol * b.abs().max().item(), n
        assert torch.equal(kc[n][:cache_len], pc[n][:cache_len])


def test_megakernel_attention_without_cache(cuda):
    """The `attention` op (no cache, positions from 0) through the ATTN
    body, in a whole-forward graph."""
    mb = build_qwen3_forward(seq_len=20, hidden=256, intermediate=384,
                             num_layers=2, num_heads=8, num_kv_heads=2,
                             head_dim=128)
    ins, ws = init_random_io(mb, np.random.default_rng(3))
    got = mb.compile("kernel", device=cuda).run(ins, ws)[0]
    ref = mb.compile("kernel", device="cpu").run(ins, ws)[0]
    err = (got.cpu() - ref).abs().max().item()
    assert err <= 1e-4 * ref.abs().max().item(), err


def test_megakernel_bounded_wait_names_the_task(cuda):
    """A task made to wait on itself never becomes ready: a wait passes
    its budget, the launch ends, and the host raises naming the first
    unfinished task; the program then runs again."""
    mb, prog, ins, ws = _mk_case(cuda, torch.float32, 1, True, 128)
    prog.wait_budget_ns = int(0.05e9)
    prog.bind_weights({n: torch.as_tensor(w).to(cuda) for n, w in
                       ws.items()})
    t = 5
    prog.deps[t] = prog.deps[t] + [t]
    prog._desc = None
    x = torch.as_tensor(ins["x"]).to(cuda)
    prog.step({"x": x}, 3)
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match=f"first unfinished task is task "
                                           f"{t} "):
        prog.check_fault()
    prog.deps[t] = prog.deps[t][:-1]
    prog._desc = None
    prog.step({"x": x}, 3)
    torch.cuda.synchronize()
    prog.check_fault()


def test_megakernel_refuses_what_it_does_not_take(cuda):
    mb = build_qwen3_decode(seq_len=1, hidden=256, intermediate=384,
                            num_layers=1, num_heads=4, num_kv_heads=2,
                            head_dim=32, max_cache=16, kv_append=True)
    with pytest.raises(ValueError, match="head_dim 32"):
        mb.compile("kernel", device=cuda)
    mb = build_qwen3_decode(seq_len=1, hidden=260, intermediate=384,
                            num_layers=1, num_heads=4, num_kv_heads=2,
                            head_dim=64, max_cache=16, kv_append=True)
    with pytest.raises(ValueError, match="multiple of 8"):
        mb.compile("kernel", device=cuda)
    mb = build_qwen3_decode(seq_len=1, hidden=256, intermediate=384,
                            num_layers=1, num_heads=4, num_kv_heads=2,
                            head_dim=64, max_cache=16, kv_append=True,
                            dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        mb.compile("kernel", device=cuda)
    mb = build_qwen3_decode(seq_len=1, hidden=256, intermediate=384,
                            num_layers=1, num_heads=4, num_kv_heads=2,
                            head_dim=64, max_cache=16, kv_append=True)
    with pytest.raises(ValueError, match="n_sm"):
        mb.compile("kernel", device=cuda, n_sm=4)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert mb.compile("kernel", device=cuda).n_sm == sms


# -- the megakernel's fused decode arms ----------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,cache_len,qk_norm,D", [
    (1, 0, True, 128), (1, 37, True, 128), (1, 101, False, 64),
    (8, 13, True, 128),
])
def test_megakernel_fused_matches_plain_and_unfused(cuda, dtype, S,
                                                    cache_len, qk_norm, D):
    """Both fusion flags: the fused kernel against its plain walk (MK_TOL),
    and against the unfused kernel bit for bit, outputs and every cache
    (the fused arms keep the unfused tasks' reduction orders and rounding
    points)."""
    mb, unfused, ins, ws = _mk_case(cuda, dtype, S, qk_norm, D)
    fused = mb.compile("kernel", device=cuda, fuse_elementwise=True,
                       fuse_kv_append=True)
    assert len(fused.tasks) == 6 * 2 + 1 and len(unfused.tasks) == 13 * 2 + 1
    w = {n: torch.as_tensor(v).to(cuda, dtype) for n, v in ws.items()}
    runs = {}
    for name, prog in (("unfused", unfused), ("fused", fused)):
        prog.bind_weights(w)
        runs[name] = _mk_kernel_and_plain(prog, ins, cache_len)
    (ko, kc), (po, pc) = runs["fused"]
    tol = MK_TOL[dtype]
    for a, b in zip(ko, po):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= tol * b.abs().max().item()
    rows = slice(cache_len, cache_len + S)
    for n in kc:
        a, b = kc[n][rows], pc[n][rows]
        assert (a - b).abs().max().item() <= tol * b.abs().max().item(), n
    uo, uc = runs["unfused"][0]
    for a, b in zip(ko, uo):
        assert torch.equal(a, b)
    for n in kc:
        assert torch.equal(kc[n], uc[n]), n


def test_megakernel_fused_refusals(cuda):
    """A fused program past the skinny LINEAR's rows, and a fused RMS
    prologue wider than the staged floats, are refused on the host; a
    fused field on a tiled LINEAR's descriptor is an op the kernel does
    not have: the launch records the fault and the host names the task."""
    mb = build_qwen3_decode(seq_len=24, hidden=256, intermediate=384,
                            num_layers=1, num_heads=8, num_kv_heads=2,
                            head_dim=128, max_cache=64, kv_append=True)
    for kw in ({"fuse_elementwise": True}, {"fuse_kv_append": True}):
        with pytest.raises(ValueError, match="at most 8 rows"):
            mb.compile("kernel", device=cuda, **kw)
    wide = build_qwen3_decode(seq_len=8, hidden=2056, intermediate=384,
                              num_layers=1, num_heads=8, num_kv_heads=2,
                              head_dim=128, max_cache=64, kv_append=True)
    with pytest.raises(ValueError, match="staged floats"):
        wide.compile("kernel", device=cuda, fuse_elementwise=True)
    ins, ws = init_random_io(mb, np.random.default_rng(0))
    prog = mb.compile("kernel", device=cuda)
    prog.wait_budget_ns = int(0.05e9)
    prog.bind_weights({n: torch.as_tensor(v).to(cuda) for n, v in ws.items()})
    prog.bind_caches({n: torch.as_tensor(ins[n]).to(cuda)
                      for n in mb.graph.caches})
    x = torch.as_tensor(ins["x"]).to(cuda)
    t = next(i for i, nd in enumerate(prog.tasks) if nd.op == "linear")
    d_desc = prog.descriptors()[3]
    d_desc[t, mkx.F_R] = x.data_ptr()
    prog.step({"x": x}, 3)
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match=f"op the kernel does not have: "
                                           f"task {t} "):
        prog.check_fault()
    prog._desc = None
    prog.step({"x": x}, 3)
    torch.cuda.synchronize()
    prog.check_fault()


# -- the megakernel's paged serving bodies (ATTN_P, KVA_PK, KVA_PV) ------------

def _mk_paged_case(device, dtype, R, D, blk, seed=0):
    """A 2-layer serve program over five slots: slot 0 idle (length 0, a
    table row of its trash page), the others at lengths 1, blk - 1, blk
    and 2 blk + 5 (page boundaries), their pages drawn from a shuffled
    pool, unassigned columns on their trash pages."""
    lens = np.asarray([0, 1, blk - 1, blk, 2 * blk + 5], np.int32)
    nb, mp, num_blocks = len(lens), 4, 12
    mb = build_qwen3_serve_batched(
        b_slots=nb, slot_rows=R, hidden=256, intermediate=384, num_layers=2,
        num_heads=8, num_kv_heads=2, head_dim=D, num_blocks=num_blocks,
        block=blk, max_pages=mp, qk_norm=True, dtype=dtype)
    rng = np.random.default_rng(seed)
    ins, ws = init_random_io(mb, rng)
    pad = np.arange(nb * R) % R != 0
    ins["x"][pad] = 0.0
    perm = iter(rng.permutation(num_blocks))
    tbl = np.asarray([[next(perm) if 0 < cl and c <= cl // blk
                       else num_blocks + b for c in range(mp)]
                      for b, cl in enumerate(lens)], np.int32)
    prog = mb.compile("kernel", device=device)
    prog.bind_weights({n: torch.as_tensor(w).to(device, dtype)
                       for n, w in ws.items()})
    return prog, ins, lens, tbl, pad


def _mk_paged_runs(prog, ins, lens, tbl):
    dt, dev = prog.dtype, prog.device
    start = {n: torch.as_tensor(ins[n]).to(dev, dt) for n in prog.graph.caches}
    x = torch.as_tensor(ins["x"]).to(dev, dt)
    runs = []
    for plain in (False, True):
        prog.bind_caches({n: t.clone() for n, t in start.items()})
        before = mkx.MEGAKERNEL.launches
        out = prog.step({"x": x}, cache_lens=lens, block_table=tbl,
                        plain=plain)[0]
        torch.cuda.synchronize()
        prog.check_fault()
        assert mkx.MEGAKERNEL.launches == before + (0 if plain else 1)
        runs.append((out.float().clone(),
                     {n: t.float().clone() for n, t in prog.caches.items()}))
    return start, runs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,D,blk", [(1, 128, 16), (8, 64, 32),
                                     (1, 128, 128)])
def test_megakernel_paged_matches_plain(cuda, dtype, R, D, blk):
    prog, ins, lens, tbl, pad = _mk_paged_case(cuda, dtype, R, D, blk)
    start, ((ko, kc), (po, pc)) = _mk_paged_runs(prog, ins, lens, tbl)
    tol = MK_TOL[dtype]
    assert torch.isfinite(ko).all()
    assert (ko - po).abs().max().item() <= tol * po.abs().max().item()
    assert (ko[torch.from_numpy(pad).to(cuda)] == 0).all()
    rows = torch.as_tensor(tbl[np.arange(len(lens)), lens // blk] * blk
                           + lens % blk, device=cuda)
    keep = torch.ones(next(iter(kc.values())).shape[0], dtype=torch.bool,
                      device=cuda)
    keep[rows] = False
    for n in kc:
        a, b = kc[n][rows], pc[n][rows]
        assert (a - b).abs().max().item() <= tol * b.abs().max().item(), n
        ref = start[n].float()
        assert torch.equal(kc[n][keep], ref[keep]), n
        assert torch.equal(pc[n][keep], ref[keep]), n
    # the idle slot wrote row 0 of its trash page and nothing else
    assert rows[0].item() == tbl[0, 0] * blk == (12 + 0) * blk


def test_megakernel_paged_broken_descriptor_raises(cuda):
    """A descriptor whose op code the kernel does not have: the launch
    records the fault, check_fault raises naming the task, and the
    program runs again once the table is rebuilt."""
    prog, ins, lens, tbl, _ = _mk_paged_case(cuda, torch.float32, 1, 128, 16)
    prog.wait_budget_ns = int(0.05e9)
    prog.bind_caches({n: torch.as_tensor(ins[n]).to(cuda)
                      for n in prog.graph.caches})
    x = torch.as_tensor(ins["x"]).to(cuda)
    t = next(i for i, nd in enumerate(prog.tasks)
             if nd.op == "attention_paged")
    d_desc = prog.descriptors()[3]
    d_desc[t, mkx.F_OP] = 99
    prog.step({"x": x}, cache_lens=lens, block_table=tbl)
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match=f"op the kernel does not have: "
                                           f"task {t} "):
        prog.check_fault()
    prog._desc = None
    prog.step({"x": x}, cache_lens=lens, block_table=tbl)
    torch.cuda.synchronize()
    prog.check_fault()


def test_mega_serve_gpu_matches_cpu(cuda):
    """A small model's ServeEngine(mode="megakernel") on the GPU (the
    kernel) against the same engine on the CPU (the plain walk), one
    megakernel launch per decode tick. bf16: the engine path's prefill
    kernel takes bf16 only. Every greedy pick's logits (the prefill's
    first tokens and each decode tick's) agree within 5e-2 of the
    largest, and the picks are equal wherever the CPU's top-2 gap
    exceeds twice that call's error, up to the first pick where they
    may differ and differ (the streams part there)."""
    from triton_distributed_tpu_torch import models
    from triton_distributed_tpu_torch.megakernel import serve as mserve
    from triton_distributed_tpu_torch.models import dense
    cfg = models.get_config("Qwen/Qwen3-8B").tiny(
        hidden_size=256, num_heads=8, num_kv_heads=2, head_dim=128,
        intermediate_size=512, vocab_size=512, num_layers=2)
    cpu = models.DenseLLM(cfg, dtype="bfloat16", device="cpu")
    params = cpu.init_params(torch.Generator().manual_seed(0))
    gpu = models.DenseLLM(cfg, dtype="bfloat16", device=cuda)
    gparams = {"embed": params["embed"].to(cuda),
               "norm": params["norm"].to(cuda),
               "lm_head": params["lm_head"].to(cuda),
               "layers": {k: t.to(cuda) for k, t in params["layers"].items()}}
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, 512, n).astype(np.int32), g)
            for n, g in ((37, 6), (5, 9), (20, 4), (16, 5))]
    real = dense.greedy_token
    runs = []
    for m, p in ((cpu, params), (gpu, gparams)):
        seen = []

        def spy(x, lm_head):
            seen.append((x.float() @ lm_head.float()).cpu())
            return real(x, lm_head)

        dense.greedy_token = mserve.greedy_token = spy
        try:
            se = models.ServeEngine(m, p, mode="megakernel", b_max=2,
                                    max_len=64, block=16, prefill_chunk=8)
            before = mkx.MEGAKERNEL.launches
            se.serve([r for r, _ in reqs], [g for _, g in reqs])
        finally:
            dense.greedy_token = mserve.greedy_token = real
        st = se.stats()
        assert st["megakernel_steps"] == st["decode_steps"] > 0
        runs.append(seen)
    assert mkx.MEGAKERNEL.launches - before == st["decode_steps"]
    compared = 0
    for c, g in zip(*runs):
        err = (g - c).abs().max().item()
        assert err <= 5e-2 * max(1.0, c.abs().max().item()), err
        top2 = c.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * err
        assert torch.equal(g.argmax(-1)[sure], c.argmax(-1)[sure])
        compared += 1
        if not torch.equal(g.argmax(-1), c.argmax(-1)):
            break
    assert compared >= 4, compared


# -- the megakernel's MoE body (GROUPED_GEMM) ----------------------------------

def _mk_moe_case(device, dtype, seed=0):
    """A 2-layer MoE serve program (hidden 256, 16 experts, top-4,
    intermediate 128, head_dim 64) over three slots of 2 rows: slot 0
    idle (length 0 on its trash page, width 0, its x rows random), the
    others at lengths 5 and 40 with one live row and a zero pad row.
    The moe_ffn outputs are exposed as outputs."""
    lens = np.asarray([0, 5, 40], np.int32)
    widths = np.asarray([0, 1, 1], np.int32)
    nb, R, blk, mp, num_blocks = 3, 2, 16, 4, 8
    mb = build_qwen3_moe_serve_batched(
        b_slots=nb, slot_rows=R, hidden=256, moe_intermediate=128,
        num_experts=16, top_k=4, num_layers=2, num_heads=4, num_kv_heads=2,
        head_dim=64, num_blocks=num_blocks, block=blk, max_pages=mp,
        qk_norm=True, dtype=dtype)
    mb.graph.outputs.extend(nd.out for nd in mb.graph.nodes
                            if nd.op == "moe_ffn")
    rng = np.random.default_rng(seed)
    ins, ws = init_random_io(mb, rng)
    ins["x"][1::R] = 0.0                            # pad rows
    perm = iter(rng.permutation(num_blocks))
    tbl = np.asarray([[next(perm) if 0 < cl and c <= cl // blk
                       else num_blocks + b for c in range(mp)]
                      for b, cl in enumerate(lens)], np.int32)
    prog = mb.compile("kernel", device=device)
    prog.bind_weights({n: torch.as_tensor(w).to(device, dtype)
                       for n, w in ws.items()})
    return prog, ins, lens, widths, tbl


def _mk_moe_run(prog, ins, lens, widths, tbl, plain=False):
    dt, dev = prog.dtype, prog.device
    prog.bind_caches({n: torch.as_tensor(ins[n]).to(dev, dt)
                      for n in prog.graph.caches})
    before = mkx.MEGAKERNEL.launches
    outs = prog.step({"x": torch.as_tensor(ins["x"]).to(dev, dt)},
                     cache_lens=lens, block_table=tbl, widths=widths,
                     plain=plain)
    torch.cuda.synchronize()
    prog.check_fault()
    assert mkx.MEGAKERNEL.launches == before + (0 if plain else 1)
    return [o.float().clone() for o in outs]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_megakernel_moe_matches_plain(cuda, dtype):
    prog, ins, lens, widths, tbl = _mk_moe_case(cuda, dtype)
    got = _mk_moe_run(prog, ins, lens, widths, tbl)
    want = _mk_moe_run(prog, ins, lens, widths, tbl, plain=True)
    tol = MK_TOL[dtype]
    for k, p in zip(got, want):
        assert torch.isfinite(k).all()
        assert (k - p).abs().max().item() <= tol * p.abs().max().item()
    for moe in got[1:]:
        # the idle slot (width 0) and the pad rows route nowhere: zeros
        assert (moe[[0, 1, 3, 5]] == 0).all() and (moe[[2, 4]] != 0).any()


def test_megakernel_moe_never_reads_an_unrouted_slab(cuda):
    """Every expert slab no live row routes to, in each layer, is NaN:
    the kernel gives the same bits as with the real slabs (it reads
    none of them; 0 x NaN would be NaN)."""
    prog, ins, lens, widths, tbl = _mk_moe_case(cuda, torch.float32, 3)
    want = _mk_moe_run(prog, ins, lens, widths, tbl)
    routed = prog.routed_experts(widths)
    E, H, inter = 16, 256, 128
    ws = dict(prog.weights)
    unrouted = 0
    for nd in prog.tasks:
        if nd.op != "moe_ffn" or nd.out.idx not in routed:
            continue
        gu_name = next(n for n, h in prog.graph.weights.items()
                       if h.idx == nd.inputs[2].idx)
        dn_name = next(n for n, h in prog.graph.weights.items()
                       if h.idx == nd.inputs[3].idx)
        gu, dn = ws[gu_name].clone(), ws[dn_name].clone()
        for e in set(range(E)) - set(routed.pop(nd.out.idx)):
            gu[e * H:(e + 1) * H] = float("nan")
            dn[e * inter:(e + 1) * inter] = float("nan")
            unrouted += 1
        ws[gu_name], ws[dn_name] = gu, dn
    assert unrouted > 0
    prog.bind_weights(ws)
    got = _mk_moe_run(prog, ins, lens, widths, tbl)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert torch.equal(g, w)


def test_mega_serve_moe_gpu_matches_cpu(cuda):
    """A small Qwen3MoE's ServeEngine(mode="megakernel") on the GPU (the
    kernel) against the same engine on the CPU (the plain walk), bf16,
    one megakernel launch per decode tick: every greedy pick's logits
    within 5e-2 of the largest, the picks equal wherever the CPU's top-2
    gap exceeds twice that call's error, up to the first pick where
    they differ."""
    from triton_distributed_tpu_torch import models
    from triton_distributed_tpu_torch.megakernel import serve as mserve
    from triton_distributed_tpu_torch.models import dense
    cfg = models.get_config("Qwen/Qwen3-30B-A3B").tiny(
        hidden_size=256, num_heads=8, num_kv_heads=1, head_dim=128,
        vocab_size=512, num_layers=2, num_experts=8, num_experts_per_tok=2,
        moe_intermediate_size=256)
    cpu = models.Qwen3MoE(cfg, dtype="bfloat16", device="cpu")
    params = cpu.init_params(torch.Generator().manual_seed(0))
    gpu = models.Qwen3MoE(cfg, dtype="bfloat16", device=cuda)
    gparams = {"embed": params["embed"].to(cuda),
               "norm": params["norm"].to(cuda),
               "lm_head": params["lm_head"].to(cuda),
               "layers": {k: t.to(cuda) for k, t in params["layers"].items()}}
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, 512, n).astype(np.int32), g)
            for n, g in ((37, 6), (5, 9), (20, 4), (16, 5))]
    real = dense.greedy_token
    runs = []
    for m, p in ((cpu, params), (gpu, gparams)):
        seen = []

        def spy(x, lm_head):
            seen.append((x.float() @ lm_head.float()).cpu())
            return real(x, lm_head)

        dense.greedy_token = mserve.greedy_token = spy
        try:
            se = models.ServeEngine(m, p, mode="megakernel", b_max=2,
                                    max_len=64, block=16, prefill_chunk=8)
            before = mkx.MEGAKERNEL.launches
            se.serve([r for r, _ in reqs], [g for _, g in reqs])
        finally:
            dense.greedy_token = mserve.greedy_token = real
        st = se.stats()
        assert st["megakernel_steps"] == st["decode_steps"] > 0
        runs.append(seen)
    assert mkx.MEGAKERNEL.launches - before == st["decode_steps"]
    compared = 0
    for c, g in zip(*runs):
        err = (g - c).abs().max().item()
        assert err <= 5e-2 * max(1.0, c.abs().max().item()), err
        top2 = c.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * err
        assert torch.equal(g.argmax(-1)[sure], c.argmax(-1)[sure])
        compared += 1
        if not torch.equal(g.argmax(-1), c.argmax(-1)):
            break
    assert compared >= 4, compared


# -- the MoE grouped GEMM -------------------------------------------------------

GMM_TOL = 2e-2


def _gmm_case(device, M, K, N, E, top_k, bm, skip=(), seed=0):
    """A routed batch through moe_utils: sorted rows, the (E, K, N) slabs
    and the plan. Experts in `skip` get no token."""
    gen = torch.Generator(device=device).manual_seed(seed)
    logits = torch.randn((M, E), generator=gen, device=device)
    if skip:
        logits[:, list(skip)] = -1e9
    _, experts = moe_utils.route_topk(logits, top_k)
    disp = moe_utils.sort_tokens_by_expert(experts, E, bm)
    x = _rand((M, K), gen, device)
    w = (torch.randn((E, K, N), generator=gen, device=device)
         * K ** -0.5).to(torch.bfloat16)
    return moe_utils.gather_sorted(x, disp), w, disp


def _gmm_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.parametrize("M,K,N,E,top_k,bm", [
    (4, 2048, 1536, 128, 8, 128),     # Qwen3-30B-A3B decode, gate_up
    (4, 768, 2048, 128, 8, 128),      # ... down
    (300, 256, 200, 8, 2, 16),        # ragged N (200 = 128 + 72)
    (37, 144, 64, 6, 2, 32),          # K % 32 == 16
    (64, 128, 256, 4, 1, 64),
])
def test_gmm_kernel_matches_plain(cuda, M, K, N, E, top_k, bm):
    xs, w, disp = _gmm_case(cuda, M, K, N, E, top_k, bm, skip=(1,))
    assert int(disp.group_sizes[1]) == 0                   # an empty group
    cfg = gg.GroupedGemmConfig(block_m=bm)
    before = gg.GMM.launches
    got = gg.gmm(xs, w, disp.tile_expert, config=cfg,
                 group_sizes=disp.group_sizes)
    torch.cuda.synchronize()
    assert gg.GMM.launches == before + 1
    want = gg._gmm_plain(xs, w, disp.tile_expert, bm)
    assert _gmm_err(got, want) <= GMM_TOL
    pad = disp.sorted_assignment == M * top_k              # pad rows
    assert bool(pad[-bm:].all())                           # a pad tile
    assert torch.all(got[pad] == 0)


def test_gmm_never_reads_an_idle_expert(cuda):
    """Expert E-1 (which every trailing pad tile maps to) and expert 2
    get no token, and their slabs are NaN: with group_sizes the kernel
    reads no weight for a pad row, so the output is finite and equal to
    the plain version on finite weights."""
    E, bm = 16, 128
    xs, w, disp = _gmm_case(cuda, 6, 512, 384, E, 4, bm, skip=(2, E - 1),
                            seed=1)
    idle = disp.group_sizes == 0
    assert bool(idle[E - 1]) and int(idle.sum()) >= 2
    want = gg._gmm_plain(xs, w, disp.tile_expert, bm)
    w_nan = w.clone()
    w_nan[idle] = float("nan")
    got = gg.gmm(xs, w_nan, disp.tile_expert,
                 config=gg.GroupedGemmConfig(block_m=bm),
                 group_sizes=disp.group_sizes)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert _gmm_err(got, want) <= GMM_TOL


def test_gmm_refuses_what_it_does_not_take(cuda):
    xs, w, disp = _gmm_case(cuda, 8, 64, 64, 4, 2, 16)
    cfg = gg.GroupedGemmConfig(block_m=16)
    gs = disp.group_sizes
    with pytest.raises(ValueError, match="group_sizes"):   # not given
        gg.gmm(xs, w, disp.tile_expert, config=cfg)
    with pytest.raises(ValueError):          # f32 operands
        gg.gmm(xs.float(), w.float(), disp.tile_expert, config=cfg,
               group_sizes=gs)
    with pytest.raises(ValueError, match="block_m"):       # block_m 8
        d8 = moe_utils.sort_tokens_by_expert(
            torch.zeros((8, 2), dtype=torch.int32, device=cuda), 4, 8)
        gg.gmm(torch.zeros((d8.tile_expert.shape[0] * 8, 64), device=cuda,
                           dtype=torch.bfloat16), w, d8.tile_expert,
               config=gg.GroupedGemmConfig(block_m=8),
               group_sizes=d8.group_sizes)
    with pytest.raises(ValueError, match="N % 8"):         # N % 8 != 0
        gg.gmm(xs, w[..., :60].contiguous(), disp.tile_expert, config=cfg,
               group_sizes=gs)
    with pytest.raises(ValueError):          # use_xla is the CPU form
        gg.gmm(xs, w, disp.tile_expert,
               config=gg.GroupedGemmConfig(block_m=16, use_xla=True),
               group_sizes=gs)


def test_moe_layer_decode_forward_never_waits_on_the_host(cuda):
    """The MoE layer's decode forward (routing, sort, gather, two grouped
    GEMMs, combine) at Qwen3-30B-A3B widths with a 4-row batch makes no
    call that synchronises with the device, and matches its dense
    golden."""
    from triton_distributed_tpu_torch.layers.tp_moe import TPMoE
    layer = TPMoE(2048, 768, 128, 8, mode="ar")
    params = layer.init_params(torch.Generator(device=cuda).manual_seed(0),
                               device=cuda)
    x = _rand((4, 2048), torch.Generator(device=cuda).manual_seed(1), cuda)
    layer(params, x)                                      # builds, warms up
    torch.cuda.synchronize()
    before = gg.GMM.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = layer(params, x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert gg.GMM.launches == before + 2
    ref = layer.reference_forward(params, x)
    assert _gmm_err(out, ref) <= GMM_TOL


# -- speculative decoding: the verify-width arms and the verify steps ---------

VERIFY_LENS = np.asarray([0, 20, 13, 44], np.int32)
VERIFY_WIDTHS = np.asarray([0, 1, 3, 8], np.int32)


def _mk_verify_case(device, dtype, moe=False, seed=0):
    """A 2-layer serve program (dense at hidden 256, or MoE with 16
    experts, top-4, its router logits exposed as outputs; unit-gain
    weights as chip_smoke.py draws them) at slot_rows 8
    over four slots at the verify widths {0, 1, 3, 8}: slot 0 idle on its
    trash page, slot 2's three rows the last rows of its page (block
    16), slot 3's eight rows crossing into its next page; rows past a
    slot's width zero. Returns the program, inputs, table, the live-row
    mask, the appended pool rows and the slot of each."""
    R, blk, mp, num_blocks = 8, 16, 4, 12
    nb = len(VERIFY_LENS)
    common = dict(b_slots=nb, slot_rows=R, hidden=256, num_layers=2,
                  num_heads=8, num_kv_heads=2, head_dim=128,
                  num_blocks=num_blocks, block=blk, max_pages=mp,
                  qk_norm=True, dtype=dtype)
    if moe:
        mb = build_qwen3_moe_serve_batched(moe_intermediate=128,
                                           num_experts=16, top_k=4, **common)
        mb.graph.outputs.extend(nd.inputs[1] for nd in mb.graph.nodes
                                if nd.op == "moe_ffn")
    else:
        mb = build_qwen3_serve_batched(intermediate=384, **common)
    rng = np.random.default_rng(seed)
    ins, ws = init_random_io(mb, rng)
    # unit-gain projections, N(0, 1 / fan-in) (an expert slab's fan-in is
    # its own rows), so activations and router logits keep the scale of
    # a model's at both layers
    for n, h in mb.graph.weights.items():
        if "ln" not in n and "norm" not in n:
            fan_in = h.rows // (16 if "w_moe" in n else 1)
            ws[n] = ws[n] * (fan_in ** -0.5 / 0.2)
    run = np.maximum(VERIFY_WIDTHS, 1)
    live = np.arange(nb * R) % R < np.repeat(run, R)
    ins["x"][~live] = 0.0
    perm = iter(rng.permutation(num_blocks))
    last = VERIFY_LENS + run - 1
    tbl = np.asarray([[next(perm) if VERIFY_WIDTHS[b] and c <= last[b] // blk
                       else num_blocks + b for c in range(mp)]
                      for b in range(nb)], np.int32)
    pos = [VERIFY_LENS[b] + np.arange(run[b]) for b in range(nb)]
    rows = np.concatenate([tbl[b, p // blk].astype(np.int64) * blk + p % blk
                           for b, p in enumerate(pos)])
    slot_of = np.concatenate([np.full(len(p), b) for b, p in enumerate(pos)])
    prog = mb.compile("kernel", device=device)
    prog.bind_weights({n: torch.as_tensor(w).to(device, dtype)
                       for n, w in ws.items()})
    return prog, ins, tbl, live, rows, slot_of


def _routing_divergence(logits_k, logits_p, top_k, R, tol):
    """Slots in which some row routes differently in the kernel and in
    the plain walk (any layer), from each side's own router logits: its
    top-k expert set differs, or a routing weight differs by more than
    one bf16 step at 1.0 (the softmax turns a bf16 difference of the
    logits into a larger one of the weights). The logits must agree
    within `tol` of the largest everywhere, and a set that differs must
    be a near-tie: its k-th and (k+1)-th plain logits no further apart
    than the row's largest logit difference plus one bf16 step."""
    bf16_step = torch.finfo(torch.bfloat16).eps
    diverged = set()
    for lk, lp in zip(logits_k, logits_p):
        assert (lk - lp).abs().max().item() <= tol * lp.abs().max().item()
        wk, ek = moe_utils.route_topk(lk, top_k)
        wp, ep = moe_utils.route_topk(lp, top_k)
        for r in range(lk.shape[0]):
            same = set(ek[r].tolist()) == set(ep[r].tolist())
            if same:
                order = ek[r].argsort()
                if (wk[r][order] - wp[r][ep[r].argsort()]).abs().max() \
                        <= bf16_step:
                    continue
            else:
                srt = lp[r].sort(descending=True).values
                gap = (srt[top_k - 1] - srt[top_k]).item()
                ulp = bf16_step * 2.0 ** np.floor(
                    np.log2(srt[top_k - 1].abs().item()))
                assert gap <= (lk[r] - lp[r]).abs().max().item() + ulp, \
                    (r, gap)
            diverged.add(r // R)
    return diverged


@pytest.mark.parametrize("moe", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_megakernel_verify_widths_match_plain(cuda, dtype, moe):
    """The ATTN_P / KVA_PK / KVA_PV verify arms (and GROUPED_GEMM at
    width > 1): one launch against the plain walk, pad rows exactly 0,
    the appended rows within tolerance and every other pool row bitwise
    unchanged. A MoE row whose routing differs between the two (a
    near-tie, or routing weights that the softmax moved by more than a
    bf16 step) has its slot left out of the comparison, its router
    logits held within tolerance; at most one slot goes, so a slot of
    width > 1 is always compared."""
    prog, ins, tbl, live, rows, slot_of = _mk_verify_case(cuda, dtype, moe)
    dt, R = prog.dtype, 8
    start = {n: torch.as_tensor(ins[n]).to(cuda, dt)
             for n in prog.graph.caches}
    x = torch.as_tensor(ins["x"]).to(cuda, dt)
    runs = []
    for plain in (False, True):
        prog.bind_caches({n: t.clone() for n, t in start.items()})
        before = mkx.MEGAKERNEL.launches
        outs = prog.step({"x": x}, cache_lens=VERIFY_LENS, block_table=tbl,
                         widths=VERIFY_WIDTHS, plain=plain)
        torch.cuda.synchronize()
        prog.check_fault()
        assert mkx.MEGAKERNEL.launches == before + (0 if plain else 1)
        runs.append(([o.float().clone() for o in outs],
                     {n: t.float().clone() for n, t in prog.caches.items()}))
    (ko, kc), (po, pc) = runs
    tol = MK_TOL[dtype]
    flipped = _routing_divergence(ko[1:], po[1:], 4, R, tol) if moe \
        else set()
    assert len(flipped) <= 1, flipped
    keep_slots = [b for b in range(len(VERIFY_LENS)) if b not in flipped]
    assert any(VERIFY_WIDTHS[b] > 1 for b in keep_slots), keep_slots
    trunk = torch.from_numpy(np.isin(np.arange(len(live)) // R,
                                     keep_slots)).to(cuda)
    for k, p in zip(ko, po):
        assert torch.isfinite(k).all()
        assert (k[trunk] - p[trunk]).abs().max().item() \
            <= tol * p[trunk].abs().max().item()
    assert (ko[0][torch.from_numpy(~live).to(cuda)] == 0).all()
    idx = torch.from_numpy(rows).to(cuda)
    cmp = torch.from_numpy(rows[np.isin(slot_of, keep_slots)]).to(cuda)
    keep = torch.ones(next(iter(kc.values())).shape[0], dtype=torch.bool,
                      device=cuda)
    keep[idx] = False
    for n in kc:
        a, b = kc[n][cmp], pc[n][cmp]
        assert (a - b).abs().max().item() <= tol * b.abs().max().item(), n
        assert torch.equal(kc[n][keep], start[n].float()[keep]), n


def _small_pair(cuda, moe):
    from triton_distributed_tpu_torch import models
    if moe:
        cfg = models.get_config("Qwen/Qwen3-30B-A3B").tiny(
            hidden_size=256, num_heads=8, num_kv_heads=1, head_dim=128,
            vocab_size=512, num_layers=2, num_experts=8,
            num_experts_per_tok=2, moe_intermediate_size=256)
        cls = models.Qwen3MoE
    else:
        cfg = models.get_config("Qwen/Qwen3-8B").tiny(
            hidden_size=256, num_heads=8, num_kv_heads=2, head_dim=128,
            intermediate_size=512, vocab_size=512, num_layers=2)
        cls = models.DenseLLM
    cpu = cls(cfg, dtype="bfloat16", device="cpu")
    params = cpu.init_params(torch.Generator().manual_seed(0))
    gpu = cls(cfg, dtype="bfloat16", device=cuda)
    gparams = {"embed": params["embed"].to(cuda),
               "norm": params["norm"].to(cuda),
               "lm_head": params["lm_head"].to(cuda),
               "layers": {k: t.to(cuda) for k, t in params["layers"].items()}}
    return (cpu, params), (gpu, gparams)


def _compare_picks(runs, at_least):
    """Every greedy call's logits within 5e-2 of the largest, the picks
    equal wherever the CPU's top-2 gap exceeds twice that call's error,
    up to the first call whose picks differ (the streams part there)."""
    compared = 0
    for c, g in zip(*runs):
        assert c.shape == g.shape
        err = (g - c).abs().max().item()
        assert err <= 5e-2 * max(1.0, c.abs().max().item()), err
        top2 = c.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * err
        assert torch.equal(g.argmax(-1)[sure], c.argmax(-1)[sure])
        compared += 1
        if not torch.equal(g.argmax(-1), c.argmax(-1)):
            break
    assert compared >= at_least, compared


def test_engine_verify_step_gpu_matches_cpu(cuda):
    """DenseLLM.verify_step_paged on the GPU (the paged decode kernel over
    B x K queries, once a layer) against the CPU on equal caches, bf16:
    counts mixing 1..4, an idle slot, a window crossing a page."""
    from triton_distributed_tpu_torch.models import dense
    from triton_distributed_tpu_torch.models.paged_kv_cache import \
        PagedKVCache
    (cpu, params), (gpu, gparams) = _small_pair(cuda, moe=False)
    c = cpu.config
    lens = np.asarray([30, 12, 0, 62], np.int32)
    counts = np.asarray([4, 2, 1, 3], np.int32)
    active = np.asarray([True, True, False, True])
    cands = np.random.default_rng(2).integers(0, 512, (4, 4)).astype(
        np.int32)
    gen = torch.Generator().manual_seed(3)
    pools = [torch.randn((c.num_layers, 12, c.num_kv_heads, 32, c.head_dim),
                         generator=gen).to(torch.bfloat16) for _ in range(2)]
    real = dense.greedy_token
    runs, lens_after = [], []
    for m, p, dev in ((cpu, params, "cpu"), (gpu, gparams, cuda)):
        cache = PagedKVCache.create(c.num_layers, 4, 128, c.num_kv_heads,
                                    c.head_dim, block=32, num_blocks=12,
                                    dtype=torch.bfloat16, device=dev)
        for b in range(4):
            cache.assign_slot(b, 3)
            cache.seq_lens[b] = lens[b]
        cache.k_pool.copy_(pools[0])
        cache.v_pool.copy_(pools[1])
        seen = []

        def spy(x, lm_head):
            seen.append((x.float() @ lm_head.float()).cpu())
            return real(x, lm_head)

        dense.greedy_token = spy
        before = attn.FLASH_DECODE_PAGED["bfloat16"].launches
        try:
            m.verify_step_paged(p, cands, cache, active, counts)
        finally:
            dense.greedy_token = real
        torch.cuda.synchronize()
        if dev != "cpu":
            assert attn.FLASH_DECODE_PAGED["bfloat16"].launches \
                == before + c.num_layers
        live = (np.arange(4)[None] < counts[:, None]) & active[:, None]
        runs.append([seen[0][torch.from_numpy(live.reshape(-1))]])
        lens_after.append(cache.seq_lens.copy())
    np.testing.assert_array_equal(*lens_after)
    _compare_picks(runs, 1)


@pytest.mark.parametrize("moe", [False, True])
def test_mega_serve_spec_gpu_matches_cpu(cuda, moe):
    """ServeEngine(mode="megakernel", speculative=...) of a small model
    on the GPU (one verify launch a tick) against the same engine on the
    CPU (the plain walk), bf16, with an oracle drafter from the CPU's
    spec-off run (every third draft wrong)."""
    from triton_distributed_tpu_torch import models
    from triton_distributed_tpu_torch.megakernel import serve as mserve
    from triton_distributed_tpu_torch.models import dense
    (cpu, params), (gpu, gparams) = _small_pair(cuda, moe)
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, 512, n).astype(np.int32), g)
            for n, g in ((37, 9), (5, 12), (20, 6), (16, 8))]
    kw = dict(mode="megakernel", b_max=2, max_len=64, block=16,
              prefill_chunk=8)
    off = models.ServeEngine(cpu, params, **kw).serve(
        [r for r, _ in reqs], [g for _, g in reqs])
    real = dense.greedy_token
    runs = []
    for m, p in ((cpu, params), (gpu, gparams)):
        seen = []

        def spy(x, lm_head):
            seen.append((x.float() @ lm_head.float()).cpu())
            return real(x, lm_head)

        oracle = models.OracleDrafter(
            dict(enumerate(off)), {r: q for r, (q, _) in enumerate(reqs)},
            wrong_every=3, vocab=512)
        dense.greedy_token = mserve.greedy_token = spy
        try:
            se = models.ServeEngine(m, p, **kw, speculative=models.SpecConfig(
                drafter=oracle, k=4, adapt=False))
            before = mkx.MEGAKERNEL.launches
            se.serve([r for r, _ in reqs], [g for _, g in reqs])
        finally:
            dense.greedy_token = mserve.greedy_token = real
        st = se.stats()
        assert st["megakernel_steps"] == st["decode_steps"] > 0
        assert st["spec_accepted"] > 0
        runs.append(seen)
    assert mkx.MEGAKERNEL.launches - before == st["decode_steps"]
    _compare_picks(runs, 4)


# -- tensor-parallel kernels: ag_gemm, gemm_rs, gemm_ar at n ranks ----------

TP_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}   # of the largest value


def _tp_ops():
    from triton_distributed_tpu_torch.ops import ag_gemm, gemm_ar, gemm_rs
    return {"ag_gemm": (ag_gemm, ag_gemm.ag_gemm_shard,
                        ag_gemm._ag_gemm_plain, ag_gemm.AG_GEMM),
            "gemm_rs": (gemm_rs, gemm_rs.gemm_rs_shard,
                        gemm_rs._gemm_rs_plain, gemm_rs.GEMM_RS),
            "gemm_ar": (gemm_ar, gemm_ar.gemm_ar_shard,
                        gemm_ar._gemm_ar_plain, gemm_ar.GEMM_AR)}


def _tp_case(op, n, dtype, M, K, N, dev, seed):
    """Rank-stacked operands: ag_gemm's a holds M / n rows a rank."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = M // n if op == "ag_gemm" else M
    a = torch.randn((n, rows, K), generator=gen, device=dev) / K ** 0.5
    b = torch.randn((n, K, N), generator=gen, device=dev)
    return a.to(dtype), b.to(dtype)


def _tp_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.parametrize("op", ["ag_gemm", "gemm_rs", "gemm_ar"])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N", [(192, 512, 200), (8, 256, 1024)])
def test_tp_kernel_matches_plain(cuda, op, n, dtype, M, K, N):
    """Each kernel against its plain version, two calls back to back with
    different data (the second must not pass on the first's signals);
    ragged row and column tiles (96 / 48 rows a rank or chunk, 192 rows of
    gemm_ar, N 200); gemm_ar's n replicas bit for bit equal."""
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import _common
    _, fn, plain, kern = _tp_ops()[op]
    for seed in (0, 1):
        a, b = _tp_case(op, n, dtype, M, K, N, cuda, seed)
        before = kern.launches
        _common.reset_dispatch()
        got = fn(a, b, num_ranks=n)
        torch.cuda.synchronize()
        shmem.check_faults()
        assert kern.launches == before + 1
        assert _common.dispatch_counts() == {(op, "kernel", ""): 1}
        assert _tp_err(got, plain(a, b)) <= TP_TOL[dtype]
        if op == "gemm_ar":
            assert all(torch.equal(got[r], got[0]) for r in range(n))


@pytest.mark.parametrize("op", ["ag_gemm", "gemm_rs", "gemm_ar"])
def test_tp_kernel_planted_fault_raises_and_the_next_call_is_clean(cuda, op):
    """A signal target one epoch ahead, then a rank that never arrives at
    barrier_all (so no rank's pushes start, and whichever wait times out
    first is named): the fault word is set within the budget (50 ms), the
    check raises naming the rank and the signal, and the next normal call
    runs clean."""
    import time
    from triton_distributed_tpu_torch import shmem
    mod, fn, plain, _ = _tp_ops()[op]
    n = 4
    a, b = _tp_case(op, n, torch.bfloat16, 256, 512, 384, cuda, 0)
    fn(a, b, num_ranks=n)
    ws, _ = mod._workspace(a, b)
    for planted, what in (({"epoch": ws.epoch + 2}, "signal"),
                          ({"rank_cnt": n - 1}, "signal")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod._launch(a, b, budget_s=0.05, **planted)
        torch.cuda.synchronize()
        assert time.perf_counter() - t0 < 5.0
        assert int(ws.fault[0]) == shmem.FAULT_TIMEOUT
        with pytest.raises(RuntimeError,
                           match=rf"{op}: rank [0-3] timed out .*({what})"):
            shmem.check_faults()
        assert ws.epoch == 0 and int(ws.pads.abs().sum()) == 0
        got = fn(a, b, num_ranks=n)
        torch.cuda.synchronize()
        shmem.check_faults()
        assert _tp_err(got, plain(a, b)) <= TP_TOL[torch.bfloat16]


@pytest.mark.parametrize("op", ["ag_gemm", "gemm_rs", "gemm_ar"])
def test_tp_kernel_refuses_a_grid_that_cannot_be_resident(cuda, op):
    """One CTA more than can be resident is refused before launch (and the
    workspace keeps its epoch); one CTA alone walks every item in the
    global order and finishes."""
    import ctypes
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import _build
    mod, fn, plain, _ = _tp_ops()[op]
    n = 2
    a, b = _tp_case(op, n, torch.bfloat16, 256, 512, 384, cuda, 0)
    resident = getattr(_build.load_library(op), f"tdt_{op}_resident")
    resident.argtypes = [ctypes.c_int, ctypes.c_int]
    resident.restype = ctypes.c_int
    ws, bm = mod._workspace(a, b)
    most = resident(0, bm)
    assert most >= torch.cuda.get_device_properties(0).multi_processor_count
    epoch = ws.epoch
    with pytest.raises(RuntimeError, match="CUDA error"):
        mod._launch(a, b, grid=most + 1)
    assert ws.epoch == epoch
    got = mod._launch(a, b, grid=1)
    torch.cuda.synchronize()
    shmem.check_faults()
    assert _tp_err(got, plain(a, b)) <= TP_TOL[torch.bfloat16]


# -- the quantized wire: the quant arms of gemm_rs and gemm_ar ---------------

WIRES = ("int8", "float8_e4m3fn")


def _quant_ops():
    from triton_distributed_tpu_torch.ops import gemm_ar, gemm_rs
    return {"gemm_rs": (gemm_rs, gemm_rs.gemm_rs_shard,
                        gemm_rs._gemm_rs_quant_plain, gemm_rs.GEMM_RS_QUANT),
            "gemm_ar": (gemm_ar, gemm_ar.gemm_ar_shard,
                        gemm_ar._gemm_ar_quant_plain, gemm_ar.GEMM_AR_QUANT)}


def _quant_close(got, want, a, b, wd, blk):
    """The quant arm against its plain version: both quantize an f32
    accumulator summed over K in another order, so a value on a rounding
    boundary may land one quantization step (twice the per-element bound)
    away on a source; then one rounding to the dtype. In bf16 almost every
    element is bit for bit equal (in f32 a block whose absmax differs by an
    ulp moves every dequantized value of the block by an ulp)."""
    from triton_distributed_tpu_torch.ops import wire
    bound = torch.from_numpy(wire.sum_error_bound(
        (a.float() @ b.float()).cpu(), wd, blk)).to(got.device)
    if got.shape[-2] != bound.shape[-2]:          # gemm_rs: the row chunks
        bound = bound.reshape(got.shape)
    ulp = 2.0 ** -7 if got.dtype == torch.bfloat16 else 1e-6
    err = (got.float() - want.float()).abs()
    assert bool((err <= 2 * bound + ulp * want.float().abs()).all()), \
        err.max().item()
    if got.dtype == torch.bfloat16:
        assert (got != want).float().mean().item() < 1e-2


@pytest.mark.parametrize("op", ["gemm_rs", "gemm_ar"])
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("wd", WIRES)
@pytest.mark.parametrize("M,K,N,block", [(192, 512, 768, 256),
                                         (8, 256, 1024, 256),
                                         (64, 256, 192, 64),
                                         (96, 128, 64, 256)])
def test_quant_arm_matches_plain(cuda, op, n, dtype, wd, M, K, N, block):
    """Each quant arm against its plain version, two calls back to back
    with new data: strips of one 256-column block (3 a row), decode rows,
    64-column blocks on 128-column strips with a half-live last strip,
    and a row narrower than a tile (N 64, block 64); gemm_ar's n replicas
    bit for bit equal; every call logged ("kernel", "wire")."""
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import _common
    _, fn, plain, kern = _quant_ops()[op]
    blk = min(block, N)
    for seed in (0, 1):
        a, b = _tp_case(op, n, dtype, M, K, N, cuda, seed)
        before = kern.launches
        _common.reset_dispatch()
        got = fn(a, b, num_ranks=n, wire_dtype=wd, wire_block=block)
        torch.cuda.synchronize()
        shmem.check_faults()
        assert kern.launches == before + 1
        assert _common.dispatch_counts() == {(op, "kernel", "wire"): 1}
        want = plain(a, b, wd, blk)
        if op == "gemm_ar":
            assert all(torch.equal(got[r], got[0]) for r in range(n))
            got, want = got[0], want[0]
        _quant_close(got, want, a, b, wd, blk)


@pytest.mark.parametrize("op", ["gemm_rs", "gemm_ar"])
def test_quant_arm_lost_signal_raises_and_the_next_call_is_clean(cuda, op):
    """A signal target one epoch ahead, then a rank that never arrives at
    barrier_all: the fault word is set within the budget (50 ms), the
    check raises naming the quant arm's workspace, the rank and the
    signal, and the next normal call runs clean."""
    import time
    from triton_distributed_tpu_torch import shmem
    mod, fn, plain, _ = _quant_ops()[op]
    n, wd = 4, "int8"
    a, b = _tp_case(op, n, torch.bfloat16, 256, 512, 512, cuda, 0)
    fn(a, b, num_ranks=n, wire_dtype=wd)
    ws, _ = mod._quant_workspace(a, b, 256)
    for planted in ({"epoch": ws.epoch + 2}, {"rank_cnt": n - 1}):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod._launch_quant(a, b, wd, 256, budget_s=0.05, **planted)
        torch.cuda.synchronize()
        assert time.perf_counter() - t0 < 5.0
        assert int(ws.fault[0]) == shmem.FAULT_TIMEOUT
        with pytest.raises(RuntimeError,
                           match=rf"{op}\[wire\]: rank [0-3] timed out "
                                 rf"waiting on signal"):
            shmem.check_faults()
        assert ws.epoch == 0 and int(ws.pads.abs().sum()) == 0
        got = fn(a, b, num_ranks=n, wire_dtype=wd)
        torch.cuda.synchronize()
        shmem.check_faults()
        want = plain(a, b, wd, 256)
        if op == "gemm_ar":
            got, want = got[0], want[0]
        _quant_close(got, want, a, b, wd, 256)


@pytest.mark.parametrize("op", ["gemm_rs", "gemm_ar"])
def test_quant_arm_refuses_a_grid_that_cannot_be_resident(cuda, op):
    """One CTA more than can be resident (with the strip's dynamic shared
    memory) is refused before launch; one CTA alone walks every item."""
    import ctypes
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import _build
    mod, fn, plain, _ = _quant_ops()[op]
    n, wd = 2, "float8_e4m3fn"
    a, b = _tp_case(op, n, torch.bfloat16, 256, 512, 512, cuda, 0)
    resident = getattr(_build.load_library(op), f"tdt_{op}_quant_resident")
    resident.argtypes = [ctypes.c_int] * 3
    resident.restype = ctypes.c_int
    ws, bm = mod._quant_workspace(a, b, 256)
    most = resident(0, bm, 256)
    assert most >= torch.cuda.get_device_properties(0).multi_processor_count
    epoch = ws.epoch
    with pytest.raises(RuntimeError, match="CUDA error"):
        mod._launch_quant(a, b, wd, 256, grid=most + 1)
    assert ws.epoch == epoch
    got = mod._launch_quant(a, b, wd, 256, grid=1)
    torch.cuda.synchronize()
    shmem.check_faults()
    want = plain(a, b, wd, 256)
    if op == "gemm_ar":
        got, want = got[0], want[0]
    _quant_close(got, want, a, b, wd, 256)


@pytest.mark.parametrize("mode", ["fused", "gemm_ar", "ar"])
def test_tp_layers_with_a_wire_gpu_match_cpu(cuda, mode):
    """TPMLP and TPAttn (prefill, then decode) at n = 4 with an int8 wire
    on the GPU against the CPU, bf16: within 2e-2 of the largest value;
    the quant arms launched as the calls imply."""
    from triton_distributed_tpu_torch.layers import tp_attn, tp_mlp
    from triton_distributed_tpu_torch.ops import gemm_ar, gemm_rs
    g = torch.Generator().manual_seed(0)
    n, hidden, inter, H, Hkv, D = 4, 512, 1024, 8, 4, 64
    w = [torch.randn(s, generator=g) / s[0] ** 0.5 for s in
         ((hidden, inter), (hidden, inter), (inter, hidden),
          (hidden, H * D), (hidden, Hkv * D), (hidden, Hkv * D),
          (H * D, hidden))]
    x = torch.randn(2, 65, hidden, generator=g)
    outs = {}
    for dev in ("cpu", cuda):
        before = (gemm_rs.GEMM_RS_QUANT.launches,
                  gemm_ar.GEMM_AR_QUANT.launches)
        wb = [t.to(dev, torch.bfloat16) for t in w]
        mlp = tp_mlp.TPMLP(hidden, inter, mode=mode, num_ranks=n,
                           wire_dtype="int8")
        xm = x[:, :64].reshape(-1, hidden).to(dev, torch.bfloat16)
        if mode == "fused":
            xm = xm.reshape(n, -1, hidden)
        ym = mlp(mlp.shard_params(*wb[:3]), xm)
        att = tp_attn.TPAttn(hidden, H, Hkv, D, mode=mode, num_ranks=n,
                             qk_norm=True, wire_dtype="int8")
        ap = att.shard_params(*wb[3:])
        xa = x.to(dev, torch.bfloat16)
        ya, cache = att.prefill(ap, xa[:, :64], max_len=65)
        yd, _ = att.decode(ap, xa[:, 64], cache, 64)
        torch.cuda.synchronize()
        outs[str(dev)] = [t.float().cpu() for t in (ym, ya, yd)]
        launched = (gemm_rs.GEMM_RS_QUANT.launches - before[0],
                    gemm_ar.GEMM_AR_QUANT.launches - before[1])
    # decode ends in "ar" (quant_psum) in "fused" mode
    assert launched == {"fused": (2, 0), "gemm_ar": (0, 3),
                        "ar": (0, 0)}[mode], launched
    for c, gpu in zip(outs["cpu"], outs[str(cuda)]):
        err = (gpu - c).abs().max().item()
        assert err <= 2e-2 * c.abs().max().item(), err


@pytest.mark.parametrize("par", ["ep", "tp"])
def test_nrank_moe_serve_gpu_matches_cpu(cuda, par):
    """A small Qwen3MoE at n = 2 (EP or TP experts) behind
    ServeEngine(tp_ranks=2), mode "gemm_ar", on the GPU against the CPU in
    bf16: the logits of every greedy pick within 5e-2 of the largest, the
    picks equal where the margin allows; the paged decode once a layer a
    decode tick, gmm twice a layer a step (EP: one launch a projection for
    every rank's experts; TP: one a rank), no all-to-all."""
    from triton_distributed_tpu_torch import models, shmem
    from triton_distributed_tpu_torch.models import dense
    from triton_distributed_tpu_torch.ops import ep_a2a
    cfg = models.get_config("Qwen/Qwen3-30B-A3B").tiny(
        hidden_size=256, num_heads=8, num_kv_heads=2, head_dim=128,
        vocab_size=512, num_layers=2, num_experts=8, num_experts_per_tok=2,
        moe_intermediate_size=256)
    n = 2
    params = models.Qwen3MoE(cfg, dtype="bfloat16", device="cpu") \
        .init_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(6)
    reqs = [(rng.integers(0, 512, s).astype(np.int32), 6)
            for s in (40, 70, 20)]
    serve_kw = dict(b_max=2, max_len=256, block=32, prefill_chunk=32,
                    tp_ranks=n)
    real = dense.greedy_token
    runs = []
    for dev in ("cpu", cuda):
        m = models.Qwen3MoE(cfg, dtype="bfloat16", device=dev, mode="gemm_ar",
                            num_ranks=n, moe_parallel=par)
        p = m.shard_params(
            {"embed": params["embed"].to(dev), "norm": params["norm"].to(dev),
             "lm_head": params["lm_head"].to(dev),
             "layers": {k: t.to(dev) for k, t in params["layers"].items()}})
        seen = []

        def spy(x, lm_head):
            lg = dense._logits(x, lm_head)
            if lg.dim() == 3:
                lg = lg.permute(1, 0, 2).reshape(x.shape[0], -1)
            seen.append(lg.float().cpu())
            return real(x, lm_head)

        before = (attn.FLASH_DECODE_PAGED["bfloat16"].launches,
                  gg.GMM.launches, ep_a2a.EP_A2A.launches)
        dense.greedy_token = spy
        try:
            se = models.ServeEngine(m, p, **serve_kw)
            se.serve([r for r, _ in reqs], [g for _, g in reqs])
        finally:
            dense.greedy_token = real
        torch.cuda.synchronize()
        shmem.check_faults()
        runs.append(seen)
        counts = [a - b for a, b in zip(
            (attn.FLASH_DECODE_PAGED["bfloat16"].launches, gg.GMM.launches,
             ep_a2a.EP_A2A.launches), before)]
    st = se.stats()
    steps = st["decode_steps"] + st["prefill_chunks"]
    per_step = 2 * (1 if par == "ep" else n)
    assert counts == [cfg.num_layers * st["decode_steps"],
                      per_step * cfg.num_layers * steps, 0], (counts, st)
    _compare_picks(runs, 4)


def test_tp_engine_step_raises_on_a_planted_fault(cuda):
    """The fault word of the gemm_ar workspace a decode step uses, set:
    the step's launches return at once without writing their outputs,
    and Engine.step raises before it hands a token back; start and the
    next step after the reset run clean."""
    from triton_distributed_tpu_torch import models, shmem
    cfg = models.get_config("Qwen/Qwen3-8B").tiny(
        hidden_size=256, num_heads=8, num_kv_heads=2, head_dim=128,
        intermediate_size=512, vocab_size=512, num_layers=2)
    m = models.DenseLLM(cfg, mode="gemm_ar", dtype="bfloat16", device=cuda,
                        num_ranks=2)
    eng = models.Engine(m, m.init_params(
        torch.Generator(device=cuda).manual_seed(0)), max_len=64)
    ids = np.random.RandomState(0).randint(0, 512, (2, 16))
    tok, cache = eng.start(ids)
    shmem.release_workspaces()
    tok, cache = eng.step(tok, cache)      # allocates the decode workspace
    (ws,) = shmem.primitives._WORKSPACES.values()
    ws.fault[0] = shmem.FAULT_TIMEOUT
    with pytest.raises(RuntimeError, match="gemm_ar: rank .* timed out"):
        eng.step(tok, cache)
    tok, cache = eng.start(ids)
    got, _ = eng.step(tok, cache)
    assert got.shape == (2,) and int(got.max()) < 512


# -- the ragged all-to-all of expert parallelism (csrc/ep_a2a.cu) -----------

def _a2a_case(n, C, W, dtype, dev, seed, counts=None):
    """Rank-stacked send buffers (n, n, C, W) and counts (n, n) int32
    (random in [0, C] unless given)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if dtype == torch.uint8:           # packed wire rows: any bytes
        x = torch.randint(0, 256, (n, n, C, W), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    else:
        x = torch.randn((n, n, C, W), generator=gen, device=dev).to(dtype)
    if counts is None:
        counts = torch.randint(0, C + 1, (n, n), generator=gen, device=dev,
                               dtype=torch.int32)
    return x, counts.to(device=dev, dtype=torch.int32)


def _a2a_valid_equal(got, want, counts):
    c = counts.cpu()
    n = got.shape[0]
    for d in range(n):
        for s in range(n):
            k = int(c[s, d])
            assert torch.equal(got[d, s, :k], want[d, s, :k]), (s, d)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype,W", [(torch.bfloat16, 256),
                                     (torch.float32, 24),
                                     (torch.uint8, 16 + 128)])
def test_ep_a2a_kernel_matches_plain(cuda, n, dtype, W):
    """The kernel against its plain version, bit for bit on the valid rows,
    two calls back to back with new data and counts (the second must not
    pass on the first's signals), then a zero-count and a full-capacity
    pair; one launch a call."""
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import ep_a2a as tep
    C, chunk = 64, 16
    edge = torch.randint(1, C, (n, n), dtype=torch.int32)
    edge[0, n - 1], edge[n - 1, 0], edge[1, 1] = 0, C, C
    for seed, counts in ((0, None), (1, None), (2, edge)):
        x, cnt = _a2a_case(n, C, W, dtype, cuda, seed, counts)
        before = tep.EP_A2A.launches
        got = tep._ragged_a2a(x, cnt, num_ranks=n, chunk=chunk).clone()
        torch.cuda.synchronize()
        shmem.check_faults()
        assert tep.EP_A2A.launches == before + 1
        _a2a_valid_equal(got, tep._ragged_a2a_plain(x, cnt), cnt)


def test_ep_a2a_planted_lost_signal_raises_and_the_next_call_is_clean(cuda):
    """One notification of the pair 1 -> 2 taken out of rank 2's pad: the
    wait times out within the budget (50 ms), the check raises naming rank
    2 and the source, and the next call runs clean."""
    import time
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import ep_a2a as tep
    n, C, W = 4, 32, 64
    x, cnt = _a2a_case(n, C, W, torch.bfloat16, cuda, 0)
    tep._ragged_a2a(x, cnt, num_ranks=n, chunk=8, collective_id=99)
    torch.cuda.synchronize()
    (ws,) = [w for w in shmem.primitives._WORKSPACES.values()
             if w.op == "ep_a2a[99]"]
    ws.pads[2, 1 + 1] -= 1
    t0 = time.perf_counter()
    tep._ragged_a2a(x, cnt, num_ranks=n, chunk=8, collective_id=99,
                    wait_budget=0.05)
    torch.cuda.synchronize()
    assert time.perf_counter() - t0 < 5.0
    with pytest.raises(RuntimeError, match=r"rank 2 timed out .*source rank "
                                           r"1"):
        shmem.check_faults()
    assert ws.epoch == 0 and int(ws.pads.abs().sum()) == 0
    got = tep._ragged_a2a(x, cnt, num_ranks=n, chunk=8, collective_id=99)
    torch.cuda.synchronize()
    shmem.check_faults()
    _a2a_valid_equal(got, tep._ragged_a2a_plain(x, cnt), cnt)


def test_ep_a2a_refuses_a_grid_that_cannot_be_resident(cuda):
    """One CTA more than can be resident is refused; one CTA alone walks
    every item in the global order and finishes."""
    import ctypes
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import _build
    from triton_distributed_tpu_torch.ops import ep_a2a as tep
    n, C, W = 4, 64, 128
    x, cnt = _a2a_case(n, C, W, torch.bfloat16, cuda, 3)
    resident = _build.load_library("ep_a2a").tdt_ep_a2a_resident
    resident.restype = ctypes.c_int
    most = resident()
    assert most >= torch.cuda.get_device_properties(0).multi_processor_count
    xb = x.view(torch.uint8)
    ws = shmem.a2a_workspace("ep_a2a[98]", cuda, n, C, xb.shape[-1])
    with pytest.raises(RuntimeError, match="CUDA error"):
        shmem.launch_a2a(tep.EP_A2A, ws, xb, cnt, 16, grid=most + 1)
    assert ws.epoch == 0
    shmem.launch_a2a(tep.EP_A2A, ws, xb, cnt, 16, grid=1)
    torch.cuda.synchronize()
    shmem.check_faults()
    _a2a_valid_equal(ws.land.view(torch.bfloat16).reshape(x.shape),
                     tep._ragged_a2a_plain(x, cnt), cnt)


@pytest.mark.parametrize("wire", [None, "int8", "float8_e4m3fn"])
def test_ep_layer_on_the_gpu_matches_the_cpu(cuda, wire):
    """A small EPMoE at 4 ranks in bf16 on the GPU (the a2a and gmm
    kernels) against the same weights on the CPU (plain versions), within
    2e-2 of the largest value, and with a quantized wire one quantization
    step more for each of its two quantizations (ops/wire.QUANT_EPS: a
    bf16 step of difference before the quantizer can move its output by a
    whole step); NaN planted in every landing region then changes no
    output bit."""
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.layers.ep_moe import EPMoE
    from triton_distributed_tpu_torch.ops import ep_a2a as tep
    from triton_distributed_tpu_torch.ops.wire import QUANT_EPS
    layer = EPMoE(16, 64, 32, 2, num_ranks=4, block_m=16, chunk=16,
                  wire_dtype=wire)
    params = layer.init_params(torch.Generator().manual_seed(0),
                               dtype=torch.bfloat16)
    x = torch.randn(4 * 24, 64, generator=torch.Generator().manual_seed(1))
    x = x.bfloat16()
    want = layer(params, x)
    gp = {k: t.to(cuda) for k, t in params.items()}
    a2a, g = tep.EP_A2A.launches, gg.GMM.launches
    got = layer(gp, x.to(cuda))
    torch.cuda.synchronize()
    shmem.check_faults()
    assert tep.EP_A2A.launches == a2a + 2 and gg.GMM.launches == g + 2
    err = (got.float().cpu() - want.float()).abs().max()
    tol = 2e-2 + (2 * QUANT_EPS[wire] if wire else 0.0)
    assert err <= tol * want.float().abs().max()
    for ws in shmem.primitives._WORKSPACES.values():
        if ws.op.startswith("ep_a2a["):
            ws.land.fill_(0xFF)             # NaN in bf16, f32 and fp8
    again = layer(gp, x.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(again, got)


# ---------------------------------------------------------------------------
# The one-shot LL combine (csrc/ll_combine.cu) and multi-rank serving
# ---------------------------------------------------------------------------

def _ll_case(n, B, H, D, dtype, dev, seed, empty_rank=None):
    """Rank-stacked decode partials (n, B, H, D) and their lse (n, B, H)
    f32; `empty_rank` holds no token (out 0, lse -1e30)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = torch.randn((n, B, H, D), generator=gen, device=dev).to(dtype)
    lse = 3 * torch.randn((n, B, H), generator=gen, device=dev)
    if empty_rank is not None:
        out[empty_rank], lse[empty_rank] = 0, -1e30
    return out, lse


def _ll_close(got, want):
    """Bit for bit in either dtype: the kernel runs the plain version's f32
    operations in its order with no contraction, rounding once at the
    end."""
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,D", [(4, 32, 128), (1, 3, 16)])
def test_ll_combine_kernel_matches_plain(cuda, n, dtype, B, H, D):
    """The kernel against its plain version, two calls back to back with
    new data (the second must not pass on the first's signals), one rank
    empty in the second; one launch a call; NaN planted in the landing
    regions changes no output bit of the next call."""
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import ll_gather as tll
    for seed, empty in ((0, None), (1, n - 1)):
        out, lse = _ll_case(n, B, H, D, dtype, cuda, seed, empty)
        before = tll.LL_COMBINE.launches
        got = tll.ll_combine_shard(out, lse, num_ranks=n)
        torch.cuda.synchronize()
        shmem.check_faults()
        assert tll.LL_COMBINE.launches == before + 1
        assert got.shape == (B, H, D) and got.dtype == dtype
        _ll_close(got, tll._ll_combine_plain(out, lse))
    (ws,) = [w for w in shmem.primitives._WORKSPACES.values()
             if w.op == "ll_combine" and w.n == n
             and w.land.shape[2] == B * H]
    ws.land.fill_(float("nan"))
    again = tll.ll_combine_shard(out, lse, num_ranks=n)
    torch.cuda.synchronize()
    assert torch.equal(again, got)


@pytest.mark.parametrize("n,B,H,D", [(4, 4, 32, 128), (2, 101, 8, 8)])
def test_ll_merge_kernel_matches_plain(cuda, n, B, H, D):
    from triton_distributed_tpu_torch.ops import ll_gather as tll
    out, lse = _ll_case(n, B, H, D, torch.float32, cuda, 2)
    before = tll.LL_MERGE.launches
    got = tll.ll_merge(out, lse)
    torch.cuda.synchronize()
    assert tll.LL_MERGE.launches == before + 1
    _ll_close(got, tll._ll_combine_plain(out, lse))


def test_ll_combine_planted_lost_signal_raises_and_the_next_call_is_clean(
        cuda):
    """One notification of source 1's row block 0 taken out of rank 2's
    pad: the wait times out within the budget (50 ms), the check raises
    naming rank 2, the block and the source, and the next call runs
    clean."""
    import time
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import ll_gather as tll
    n = 4
    out, lse = _ll_case(n, 2, 8, 128, torch.bfloat16, cuda, 3)
    tll.ll_combine_shard(out, lse, num_ranks=n)
    torch.cuda.synchronize()
    (ws,) = [w for w in shmem.primitives._WORKSPACES.values()
             if w.op == "ll_combine" and w.n == n
             and w.land.shape[2] == 16]
    ws.pads[2, 1 + 1] -= 1             # source 1, block 0 (one block)
    t0 = time.perf_counter()
    tll.ll_combine_shard(out, lse, num_ranks=n, wait_budget=0.05)
    torch.cuda.synchronize()
    assert time.perf_counter() - t0 < 5.0
    with pytest.raises(RuntimeError, match=r"rank 2 timed out .*row block 0 "
                                           r"from source rank 1"):
        shmem.check_faults()
    assert ws.epoch == 0 and int(ws.pads.abs().sum()) == 0
    got = tll.ll_combine_shard(out, lse, num_ranks=n)
    torch.cuda.synchronize()
    shmem.check_faults()
    _ll_close(got, tll._ll_combine_plain(out, lse))


def test_ll_combine_refuses_a_grid_that_cannot_be_resident(cuda):
    """One CTA more than can be resident is refused; one CTA alone walks
    every item in the global order and finishes."""
    import ctypes
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import _build
    from triton_distributed_tpu_torch.ops import ll_gather as tll
    n, B, H, D = 4, 4, 32, 128
    out, lse = _ll_case(n, B, H, D, torch.bfloat16, cuda, 4)
    resident = _build.load_library("ll_combine").tdt_ll_combine_resident
    resident.restype = ctypes.c_int
    most = resident(0)
    assert most >= torch.cuda.get_device_properties(0).multi_processor_count
    ws = shmem.ll_workspace(cuda, n, B * H, tll.packed_width(D))
    o, ls = out.view(n, B * H, D), lse.view(n, B * H)
    merged = torch.empty_like(o[0])
    with pytest.raises(RuntimeError, match="CUDA error"):
        shmem.launch_ll(tll.LL_COMBINE, ws, o, ls, merged, grid=most + 1)
    shmem.launch_ll(tll.LL_COMBINE, ws, o, ls, merged, grid=1)
    torch.cuda.synchronize()
    shmem.check_faults()
    _ll_close(merged.view(B, H, D), tll._ll_combine_plain(out, lse))


@pytest.mark.parametrize("par", ["tp", "tp-spec", "sp-xla", "sp-ll"])
def test_multi_rank_serve_gpu_matches_cpu(cuda, par):
    """A small model at n = 2 behind ServeEngine, tensor-parallel in mode
    "gemm_ar" (tp_ranks=2; "tp-spec" with speculative decoding, an oracle
    drafter over the CPU's spec-off tokens, every third draft wrong, so
    the n-rank verify step runs) or sequence-parallel under both
    combines, on the GPU against the CPU in bf16: the logits of every
    greedy pick within 5e-2 of the largest, the picks equal where the
    margin allows; prompts crossing the 128-token ownership boundary; the
    kernels of the path launched (paged decode, gemm_ar or ll_combine)."""
    from triton_distributed_tpu_torch import models, shmem
    from triton_distributed_tpu_torch.models import dense
    from triton_distributed_tpu_torch.ops import gemm_ar as tar
    from triton_distributed_tpu_torch.ops import ll_gather as tll
    (cpu, params), _ = _small_pair(cuda, moe=False)
    cfg, n = cpu.config, 2
    if par.startswith("tp"):
        mk = dict(mode="gemm_ar", num_ranks=n)
        kw = dict(tp_ranks=n)
    else:
        mk = dict(mode="ar", num_ranks=n, attn_parallelism="sp",
                  sp_combine=par[3:])
        kw = {}
    rng = np.random.default_rng(6)
    reqs = [(rng.integers(0, 512, s).astype(np.int32), 6)
            for s in (40, 150, 20)]
    serve_kw = dict(b_max=2, max_len=256, block=32, prefill_chunk=32, **kw)
    if par == "tp-spec":
        m = models.DenseLLM(cfg, dtype="bfloat16", device="cpu", **mk)
        off = models.ServeEngine(m, m.shard_params(params), **serve_kw).serve(
            [r for r, _ in reqs], [g for _, g in reqs])
    real = dense.greedy_token
    runs, counts = [], {}
    for dev in ("cpu", cuda):
        m = models.DenseLLM(cfg, dtype="bfloat16", device=dev, **mk)
        p = m.shard_params(
            {"embed": params["embed"].to(dev), "norm": params["norm"].to(dev),
             "lm_head": params["lm_head"].to(dev),
             "layers": {k: t.to(dev) for k, t in params["layers"].items()}})
        seen = []

        def spy(x, lm_head):
            lg = dense._logits(x, lm_head)
            if lg.dim() == 3:
                lg = lg.permute(1, 0, 2).reshape(x.shape[0], -1)
            seen.append(lg.float().cpu())
            return real(x, lm_head)

        before = (attn.FLASH_DECODE_PAGED["bfloat16"].launches,
                  tar.GEMM_AR.launches, tll.LL_COMBINE.launches)
        spec = None
        if par == "tp-spec":
            spec = models.SpecConfig(drafter=models.OracleDrafter(
                dict(enumerate(off)),
                {r: q for r, (q, _) in enumerate(reqs)}, wrong_every=3,
                vocab=512), k=4, adapt=False)
        dense.greedy_token = spy
        try:
            se = models.ServeEngine(m, p, **serve_kw, speculative=spec)
            se.serve([r for r, _ in reqs], [g for _, g in reqs])
        finally:
            dense.greedy_token = real
        torch.cuda.synchronize()
        shmem.check_faults()
        if par == "tp-spec":
            st = se.stats()
            assert st["spec_accepted"] > 0 and st["spec_rejected"] > 0, st
        counts[str(dev)] = [a - b for a, b in zip(
            (attn.FLASH_DECODE_PAGED["bfloat16"].launches,
             tar.GEMM_AR.launches, tll.LL_COMBINE.launches), before)]
        runs.append(seen)
        if par.startswith("sp"):
            se._cache.check_conservation_sp(n)
    decode_steps = se.stats()["decode_steps"]
    paged, gemm_ar, ll = counts["cuda"]
    assert paged == cfg.num_layers * decode_steps
    assert gemm_ar > 0 if par.startswith("tp") else gemm_ar == 0
    assert ll == (cfg.num_layers * decode_steps if par == "sp-ll" else 0)
    _compare_picks(runs, 4)


# -- the megakernel at n ranks: the AR body ------------------------------------

def _ar_graph(n, rows, cols, dtype):
    """x -> all_reduce -> add(., x) -> all_reduce over n ranks: two AR
    nodes and an elementwise add, so kernel and plain agree bit for bit."""
    from triton_distributed_tpu_torch.megakernel.builder import ModelBuilder
    from triton_distributed_tpu_torch.parallel.mesh import RankGroup
    mb = ModelBuilder(mesh=RankGroup(n), dtype=dtype)
    x = mb.input("x", (rows, cols))
    mb.output(mb.all_reduce(mb.add(mb.all_reduce(x), x)))
    xs = torch.randn((n, rows, cols), generator=torch.Generator(
        device="cpu").manual_seed(n * rows), dtype=torch.float32)
    return mb, xs.to(dtype)


def _ar_runs(prog, x):
    """The kernel's output, then the plain walk's, on the same input."""
    out = []
    for plain in (False, True):
        before = mkx.MEGAKERNEL.launches
        got = prog.step({"x": x}, plain=plain)[0]
        torch.cuda.synchronize()
        prog.check_fault()
        assert mkx.MEGAKERNEL.launches == before + (0 if plain else 1)
        out.append(got.clone())
    return out


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [4, 32])
def test_megakernel_all_reduce_matches_plain_bitwise(cuda, n, dtype, rows):
    """The AR body against the plain walk at the trunk's shapes (4 slots
    x 1 and x 8 rows, hidden 4096): the same f32 sums in rank order,
    rounded once, so equal bit for bit, every rank's copy of the output
    alike; and twice in a row (the epoch-counted signals)."""
    mb, x = _ar_graph(n, rows, 4096, dtype)
    prog = mb.compile("kernel", device=cuda)
    prog.bind_weights({})
    x = x.to(cuda)
    for _ in range(2):
        got, want = _ar_runs(prog, x)
        assert torch.equal(got, want)
        assert all(torch.equal(got[r], got[0]) for r in range(n))
    # AR(AR(x) + x_r) = (n + 1) x the sum of the ranks' x
    ref = x.float().sum(0) * (n + 1)
    assert (got[0].float() - ref).abs().max() <= 4e-2 * ref.abs().max()


def test_megakernel_all_reduce_lost_signal_names_the_task(cuda):
    """A planted lost signal: one push notification taken out of rank 2's
    counter for source rank 1. A bounded wait passes its 50 ms budget
    (the sum's on the signal, or a later task's on the scoreboard), the
    host raises naming the AR sum as the first unfinished task and the
    push it never saw, and the next launch runs clean."""
    mb, x = _ar_graph(4, 4, 4096, torch.bfloat16)
    prog = mb.compile("kernel", device=cuda)
    prog.bind_weights({})
    prog.wait_budget_ns = int(0.05e9)
    x = x.to(cuda)
    want = _ar_runs(prog, x)[1]
    prog.signals[0, 2, 1, 0] -= 1
    prog.step({"x": x})
    torch.cuda.synchronize()
    first_ar = [nd.op for nd in prog.tasks].index("all_reduce")
    with pytest.raises(RuntimeError, match=(
            rf"passed its budget: .* the first unfinished task is task "
            rf"{first_ar + 1} \(all_reduce\); its sum on rank 2 never saw "
            rf"rank 1's push \(row tile 0\)")):
        prog.check_fault()
    got = prog.step({"x": x})[0]
    torch.cuda.synchronize()
    prog.check_fault()
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind,dtype", [("decode", torch.float32),
                                        ("decode", torch.bfloat16),
                                        ("forward", torch.float32)])
def test_megakernel_tp_shards_graphs_match_plain(cuda, kind, dtype):
    """The tp_shards decode (S 1, cache_len 37) and forward (S 20, f32)
    graphs at n = 2: the kernel against its plain walk at MK_TOL, every
    rank's copy of the output."""
    from triton_distributed_tpu_torch.parallel.mesh import RankGroup
    n, common = 2, dict(hidden=256, intermediate=192, num_layers=2,
                        num_heads=4, num_kv_heads=1, head_dim=128,
                        mesh=RankGroup(2), tp_shards=True)
    if kind == "decode":
        mb = build_qwen3_decode(seq_len=1, max_cache=64, qk_norm=True,
                                kv_append=True, dtype=dtype, **common)
        cl = 37
    else:
        mb = build_qwen3_forward(seq_len=20, **common)
        cl = 0
    ins, ws = init_random_io(mb, np.random.default_rng(9), stack=n)
    prog = mb.compile("kernel", device=cuda)
    prog.bind_weights({k: torch.as_tensor(v).to(cuda, prog.dtype)
                       for k, v in ws.items()})
    runs = _mk_kernel_and_plain(prog, ins, cl)
    (ko, _), (po, _) = runs
    tol = MK_TOL[prog.dtype]
    err = (ko[0] - po[0]).abs().max().item()
    assert torch.isfinite(ko[0]).all()
    assert err <= tol * po[0].abs().max().item(), err


def test_mega_tp_serve_gpu_matches_cpu(cuda):
    """ServeEngine(DenseLLM(num_ranks=2), tp_ranks=2, mode="megakernel")
    on the GPU (one launch of both ranks' programs a tick) against the
    same engine on the CPU (the plain walk), bf16: every greedy pick's
    logits within 5e-2 of the largest, the picks equal wherever the
    margin allows, and the counters (ticks, launches, per-rank AR bytes
    and blocks) equal."""
    from triton_distributed_tpu_torch import models
    from triton_distributed_tpu_torch.megakernel import serve as mserve
    from triton_distributed_tpu_torch.models import dense
    (cpu, params), _ = _small_pair(cuda, moe=False)
    cfg = cpu.config
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, 512, s).astype(np.int32), g)
            for s, g in ((37, 6), (5, 9), (20, 4), (16, 5))]
    real = dense.greedy_token
    runs, stats = [], []
    for dev in ("cpu", cuda):
        m = models.DenseLLM(cfg, dtype="bfloat16", device=dev, mode="gemm_ar",
                            num_ranks=2)
        p = m.shard_params(
            {"embed": params["embed"].to(dev), "norm": params["norm"].to(dev),
             "lm_head": params["lm_head"].to(dev),
             "layers": {k: t.to(dev) for k, t in params["layers"].items()}})
        seen = []

        def spy(x, lm_head):
            lg = dense._logits(x, lm_head)
            if lg.dim() == 3:
                lg = lg.permute(1, 0, 2).reshape(x.shape[0], -1)
            seen.append(lg.float().cpu())
            return real(x, lm_head)

        dense.greedy_token = mserve.greedy_token = spy
        try:
            se = models.ServeEngine(m, p, mode="megakernel", b_max=2,
                                    max_len=64, block=16, prefill_chunk=8,
                                    tp_ranks=2)
            before = mkx.MEGAKERNEL.launches
            se.serve([r for r, _ in reqs], [g for _, g in reqs])
        finally:
            dense.greedy_token = mserve.greedy_token = real
        torch.cuda.synchronize()
        st = se.stats()
        assert st["megakernel_steps"] == st["decode_steps"] > 0
        stats.append({k: st[k] for k in ("ticks", "decode_steps",
                                         "megakernel_steps", "per_rank",
                                         "prefill_chunks")})
        runs.append(seen)
    assert mkx.MEGAKERNEL.launches - before == st["decode_steps"]
    assert stats[0] == stats[1]
    assert st["per_rank"][0]["ar_bytes_pushed"] == \
        st["decode_steps"] * se._mk.ar_bytes_per_step > 0
    _compare_picks(runs, 4)


# ---------------------------------------------------------------------------
# The collective library (csrc/all_gather.cu, reduce_scatter.cu,
# all_reduce.cu): each arm bit for bit against its plain version (the
# gather copies; the sums run the plain versions' f32 additions in their
# order and round at their points)
# ---------------------------------------------------------------------------

_COLL_ARMS = [("all_gather", "FULLMESH_PUSH"), ("all_gather", "RING"),
              ("reduce_scatter", "RING"), ("reduce_scatter", "FULLMESH"),
              ("all_reduce", "ONE_SHOT"), ("all_reduce", "TWO_SHOT")]


def _coll(op):
    """(shard-level op, its methods, its kernel, its plain versions by
    method name) of one collective."""
    import importlib
    from triton_distributed_tpu_torch.ops import collectives as tc
    mod = importlib.import_module(
        f"triton_distributed_tpu_torch.ops.collectives.{op}")
    if op == "all_gather":
        return (tc.all_gather_shard, tc.AllGatherMethod, mod.ALL_GATHER,
                {"FULLMESH_PUSH": mod._fullmesh_plain,
                 "RING": mod._ring_plain})
    if op == "reduce_scatter":
        def split(f):
            return lambda x: f(x.reshape(x.shape[0], x.shape[0], -1,
                                         x.shape[-1]))
        return (tc.reduce_scatter_shard, tc.ReduceScatterMethod,
                mod.REDUCE_SCATTER, {"RING": split(mod.ring_plain),
                                     "FULLMESH": split(mod.fullmesh_plain)})
    return (tc.all_reduce_shard, tc.AllReduceMethod, mod.ALL_REDUCE,
            {"ONE_SHOT": mod.one_shot_plain, "TWO_SHOT": mod.two_shot_plain})


def _coll_input(op, n, rows, cols, dtype, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = n * rows if op == "reduce_scatter" else rows
    return torch.randn((n, r, cols), generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,cols", [(64, 4096), (8, 37), (5, 3)])
@pytest.mark.parametrize("op,method", _COLL_ARMS)
def test_collective_arm_matches_plain(cuda, op, method, n, dtype, rows,
                                      cols):
    """Two calls back to back with new data (the second must not pass on
    the first's signals), each one launch logged "kernel", bit for bit
    against the plain version; every rank's copy alike; odd widths take
    the element-wise tail (and misaligned slots)."""
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import _common
    fn, methods, kernel, plains = _coll(op)
    if method == "TWO_SHOT":
        rows = rows - rows % n or n
    for seed in (0, 1):
        x = _coll_input(op, n, rows, cols, dtype, cuda, seed)
        before = kernel.launches
        _common.reset_dispatch()
        got = fn(x, num_ranks=n, method=methods[method])
        torch.cuda.synchronize()
        shmem.check_faults()
        assert kernel.launches == before + 1
        assert _common.dispatch_counts() == {(op, "kernel", ""): 1}
        want = plains[method](x)
        assert got.shape == want.shape and got.dtype == dtype
        assert torch.equal(got, want), \
            (got.float() - want.float()).abs().max()
        if op != "reduce_scatter":
            assert all(torch.equal(g, got[0]) for g in got)


def test_collective_all_to_all_matches_plain(cuda):
    """The dense all_to_all through the ragged a2a kernel at counts ==
    capacity, twice, bit for bit against the rank group's transpose."""
    from triton_distributed_tpu_torch.ops import collectives as tc
    from triton_distributed_tpu_torch.ops import ep_a2a
    n = 4
    for seed in (0, 1):
        x = _coll_input("all_to_all", n, n * 24, 64, torch.bfloat16, cuda,
                        seed)
        before = ep_a2a.EP_A2A.launches
        got = tc.all_to_all_shard(x, num_ranks=n)
        want = tc.all_to_all_shard(x, num_ranks=n,
                                   method=tc.AllToAllMethod.XLA)
        torch.cuda.synchronize()
        assert ep_a2a.EP_A2A.launches == before + 1
        assert torch.equal(got, want)


def test_all_reduce_planted_lost_signal(cuda):
    """One notification of source 1's block 0 taken out of rank 2's pad of
    the one-shot: without return_fault the check raises within the budget
    naming rank 2, the block and the source; with it the call returns rank
    2's flag; each time the next call runs clean."""
    import time
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import collectives as tc
    n = 4
    x = _coll_input("all_reduce", n, 4, 4096, torch.bfloat16, cuda, 5)
    one = tc.AllReduceMethod.ONE_SHOT
    want = tc.all_reduce_shard(x, num_ranks=n, method=one)
    torch.cuda.synchronize()
    (ws,) = [w for w in shmem.primitives._WORKSPACES.values()
             if w.op == "all_reduce[one_shot]" and w.land.shape[2] == 4 * 4096]
    nblk = (ws.pads.shape[1] - 1) // n
    for return_fault in (False, True):
        ws.pads[2, 1 + 1 * nblk] -= 1
        t0 = time.perf_counter()
        out = tc.all_reduce_shard(x, num_ranks=n, method=one,
                                  wait_budget=0.05, return_fault=return_fault)
        torch.cuda.synchronize()
        assert time.perf_counter() - t0 < 5.0
        if return_fault:
            out, fault = out
            assert fault.tolist() == [0, 0, shmem.FAULT_TIMEOUT, 0]
        else:
            with pytest.raises(RuntimeError,
                               match=r"all_reduce\[one_shot\]: rank 2 timed "
                                     r"out .*block 0 from source rank 1"):
                shmem.check_faults()
        assert ws.epoch == 0 and int(ws.pads.abs().sum()) == 0
        got = tc.all_reduce_shard(x, num_ranks=n, method=one)
        torch.cuda.synchronize()
        shmem.check_faults()
        assert torch.equal(got, want)


@pytest.mark.parametrize("op,arm", [("all_gather", 1), ("reduce_scatter", 0),
                                    ("all_reduce", 1)])
def test_collective_refuses_a_grid_that_cannot_be_resident(cuda, op, arm,
                                                           monkeypatch):
    """One CTA more than can be resident is refused; one CTA alone walks
    every item of a ring arm in the global order and finishes."""
    import ctypes
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import _build
    fn, methods, _, plains = _coll(op)
    method = list(plains)[arm]
    n = 4
    x = _coll_input(op, n, 64, 4096, torch.float32, cuda, 6)
    resident = getattr(_build.load_library(op), f"tdt_{op}_resident")
    resident.restype = ctypes.c_int
    most = resident(arm) if op == "all_gather" else resident(arm, 1)
    assert most >= torch.cuda.get_device_properties(0).multi_processor_count
    launch = shmem.launch_coll
    for grid in (most + 1, 1):
        monkeypatch.setattr(shmem, "launch_coll", lambda *a, **kw: launch(
            *a, **{**kw, "grid": grid}))
        if grid > 1:
            with pytest.raises(RuntimeError, match="CUDA error"):
                fn(x, num_ranks=n, method=methods[method])
            continue
        got = fn(x, num_ranks=n, method=methods[method])
        torch.cuda.synchronize()
        shmem.check_faults()
        assert torch.equal(got, plains[method](x))


# ---------------------------------------------------------------------------
# The collectives' quantized wire (csrc/reduce_scatter.cu arms 2 and 3,
# all_reduce.cu arm 2, and the two-shot composition): the arms quantize
# with the torch codec's IEEE divisions and add the dequantized values in
# their plain versions' order, rounding at the same points, so each is held
# to its plain version bit for bit
# ---------------------------------------------------------------------------

_QUANT_ARMS = [("reduce_scatter", "RING"), ("reduce_scatter", "FULLMESH"),
               ("all_reduce", "ONE_SHOT"), ("all_reduce", "TWO_SHOT")]


def _quant_coll(op, method):
    """(shard-level op, its methods, the kernels a call launches, its plain
    version (x, wire, blk) -> out) of one quantized route."""
    import importlib
    from triton_distributed_tpu_torch.ops import collectives as tc
    rs = importlib.import_module(
        "triton_distributed_tpu_torch.ops.collectives.reduce_scatter")
    ar = importlib.import_module(
        "triton_distributed_tpu_torch.ops.collectives.all_reduce")
    ag = importlib.import_module(
        "triton_distributed_tpu_torch.ops.collectives.all_gather")
    if op == "reduce_scatter":
        plain = {"RING": rs.ring_quant_plain,
                 "FULLMESH": rs.fullmesh_quant_plain}[method]
        return (tc.reduce_scatter_shard, tc.ReduceScatterMethod,
                [rs.REDUCE_SCATTER_QUANT[method.lower()]],
                lambda x, wd, blk: plain(x.reshape(x.shape[0], x.shape[0], -1,
                                                   x.shape[-1]), wd, blk))
    if method == "ONE_SHOT":
        return (tc.all_reduce_shard, tc.AllReduceMethod, [ar.ALL_REDUCE_QUANT],
                ar.one_shot_quant_plain)
    return (tc.all_reduce_shard, tc.AllReduceMethod,
            [rs.REDUCE_SCATTER_QUANT["ring"], ag.ALL_GATHER],
            ar.two_shot_quant_plain)


def _quant_log(op, method):
    if op == "reduce_scatter":
        return {("reduce_scatter", "kernel", "wire"): 1}
    if method == "ONE_SHOT":
        return {("all_reduce", "kernel", "wire"): 1}
    return {("all_reduce", "kernel", "wire"): 1,
            ("reduce_scatter", "kernel", "wire"): 1,
            ("all_gather", "kernel", ""): 1}


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("wd", ["int8", "float8_e4m3fn"])
@pytest.mark.parametrize("rows,cols,blk", [(16, 4096, 256), (8, 1024, 128),
                                           (6, 4095, 315)])
@pytest.mark.parametrize("op,method", _QUANT_ARMS)
def test_collective_quant_arm_matches_plain(cuda, op, method, n, dtype, wd,
                                            rows, cols, blk):
    """Two calls back to back with new data, each launching its arm (the
    two-shot: the ring arm and the gather) once, logged as JAX logs, bit
    for bit against the plain version, every replica alike; the odd width
    (4095, block 315) takes the one-value-a-lane path."""
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import _common
    fn, methods, kernels, plain = _quant_coll(op, method)
    if method == "TWO_SHOT":
        rows = rows - rows % n or n
    for seed in (0, 1):
        x = _coll_input(op, n, rows, cols, dtype, cuda, seed)
        before = [k.launches for k in kernels]
        _common.reset_dispatch()
        got = fn(x, num_ranks=n, method=methods[method], wire_dtype=wd,
                 wire_block=blk)
        torch.cuda.synchronize()
        shmem.check_faults()
        assert [k.launches - b for k, b in zip(kernels, before)] == \
            [1] * len(kernels)
        assert _common.dispatch_counts() == _quant_log(op, method)
        want = plain(x, wd, blk)
        assert got.shape == want.shape and got.dtype == dtype
        assert torch.equal(got, want), \
            (got.float() - want.float()).abs().max()
        if op == "all_reduce":
            assert all(torch.equal(g, got[0]) for g in got)


def test_collective_quant_planted_lost_signal(cuda):
    """One notification of source 1's first work item taken out of rank
    2's pad of the quantized one-shot: the check raises within the budget
    naming rank 2, the block and the source; the next call runs clean."""
    import time
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import collectives as tc
    n = 4
    x = _coll_input("all_reduce", n, 4, 4096, torch.bfloat16, cuda, 5)
    one = tc.AllReduceMethod.ONE_SHOT
    want = tc.all_reduce_shard(x, num_ranks=n, method=one, wire_dtype="int8")
    torch.cuda.synchronize()
    gblk = shmem.coll_wire_group(4 * 4096 * 2, 256 * 2)
    ws = shmem.coll_wire_workspace("all_reduce", "one_shot", x.device, n, n,
                                   4 * 4096, 256, gblk)  # the call's own
    nitem = (ws.pads.shape[1] - 1) // n
    assert ws.epoch >= 1 and nitem == 64 // gblk
    ws.pads[2, 1 + 1 * nitem] -= 1
    t0 = time.perf_counter()
    tc.all_reduce_shard(x, num_ranks=n, method=one, wire_dtype="int8",
                        wait_budget=0.05)
    torch.cuda.synchronize()
    assert time.perf_counter() - t0 < 5.0
    with pytest.raises(RuntimeError,
                       match=r"all_reduce\[one_shot/wire\]: rank 2 timed out "
                             r".*block 0 \(scaling blocks 0\.\..*\) from "
                             r"source rank 1"):
        shmem.check_faults()
    assert ws.epoch == 0 and int(ws.pads.abs().sum()) == 0
    got = tc.all_reduce_shard(x, num_ranks=n, method=one, wire_dtype="int8")
    torch.cuda.synchronize()
    shmem.check_faults()
    assert torch.equal(got, want)


@pytest.mark.parametrize("op,method,arm", [("reduce_scatter", "RING", 2),
                                           ("reduce_scatter", "FULLMESH", 3),
                                           ("all_reduce", "ONE_SHOT", 2)])
def test_collective_quant_refuses_a_grid_that_cannot_be_resident(
        cuda, op, method, arm, monkeypatch):
    """The occupancy entry points cover the quant arms: one CTA more than
    can be resident is refused; one CTA alone walks every item in the
    global order and finishes, bit for bit."""
    import ctypes
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import _build
    fn, methods, _, plain = _quant_coll(op, method)
    n = 4
    x = _coll_input(op, n, 64, 4096, torch.float32, cuda, 6)
    resident = getattr(_build.load_library(op), f"tdt_{op}_resident")
    resident.restype = ctypes.c_int
    most = resident(arm, 1)
    assert most >= torch.cuda.get_device_properties(0).multi_processor_count
    launch = shmem.launch_coll
    for grid in (most + 1, 1):
        monkeypatch.setattr(shmem, "launch_coll", lambda *a, **kw: launch(
            *a, **{**kw, "grid": grid}))
        if grid > 1:
            with pytest.raises(RuntimeError, match="CUDA error"):
                fn(x, num_ranks=n, method=methods[method],
                   wire_dtype="float8_e4m3fn")
            continue
        got = fn(x, num_ranks=n, method=methods[method],
                 wire_dtype="float8_e4m3fn")
        torch.cuda.synchronize()
        shmem.check_faults()
        assert torch.equal(got, plain(x, "float8_e4m3fn", 256))


@pytest.mark.parametrize("wd", ["int8", "float8_e4m3fn"])
def test_codec_on_the_card_equals_the_cpu_codec(cuda, wd):
    """`wire.quant_blockwise` on a CUDA tensor gives the CPU's bytes and
    scales bit for bit (a CUDA tensor divided by a Python number is
    multiplied by its reciprocal, an ulp off the IEEE quotient in some
    blocks: the codec divides by a tensor)."""
    from triton_distributed_tpu_torch.ops import wire
    gen = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn((64, 4096), generator=gen, device=cuda) * 3
    q, s = wire.quant_blockwise(x, wd, 128)
    qc, sc = wire.quant_blockwise(x.cpu(), wd, 128)
    assert torch.equal(s.cpu(), sc)
    assert torch.equal(wire.byte_view(q).cpu(), wire.byte_view(qc))


# ---------------------------------------------------------------------------
# Slice 6h: the varlen arm of csrc/flash_attention.cu and the fused AG +
# attention of csrc/sp_ag_attention.cu against their plain versions
# ---------------------------------------------------------------------------

def _cu_of(lens, device):
    return torch.tensor([0, *np.cumsum(lens)], dtype=torch.int32,
                        device=device)


# of each output row's RMS: one bf16 step of an element up to 5x its row's
# RMS is 2^-7 x 5 = 0.039; twice that (chip_smoke.py SP_ROW_TOL)
ROW_TOL = 8e-2


def _row_err(got, want):
    """The largest |got - want| over the RMS of want's last axis at that
    element: the error against the scale of an attention row, whose RMS
    falls as it sees more columns."""
    g, w = got.float(), want.float()
    rms = w.pow(2).mean(-1, keepdim=True).sqrt().clamp_min(1e-30)
    return ((g - w).abs() / rms).max().item()


def _varlen_close(got, want, live, got_lse=None, want_lse=None):
    """bf16 outputs within OUT_TOL and within ROW_TOL of each row's RMS on
    the live rows (p and out rounded at other points of a blocked vs
    one-shot softmax), rows past them exactly 0; lse within LSE_TOL where a
    row sees a column."""
    assert got.shape == want.shape and got.dtype == want.dtype
    e = (got[..., :live, :, :].float() - want[..., :live, :, :].float())
    assert e.abs().max().item() <= OUT_TOL, e.abs().max().item()
    r = _row_err(got[..., :live, :, :], want[..., :live, :, :])
    assert r <= ROW_TOL, r
    assert (got[..., live:, :, :] == 0).all()
    if got_lse is not None:
        seen = want_lse > -1e29
        assert ((got_lse - want_lse).abs()[seen] <= LSE_TOL).all()
        assert (got_lse[~seen] < -1e29).all()


@pytest.mark.parametrize("H,Hkv,D", [(8, 8, 64), (8, 2, 128), (32, 4, 128),
                                     (32, 8, 128), (16, 2, 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("lens,pad", [((5, 170, 2, 90, 64, 1), 0),
                                      ((300, 41), 23), ((64, 64, 128), 0)])
def test_flash_attention_varlen_kernel_matches_plain(cuda, H, Hkv, D, causal,
                                                     lens, pad):
    """flash_attention_varlen on ragged packed batches (sequences shorter
    than, equal to and across the 64-row tile, a trailing pad past
    cu_seqlens[-1]), GQA groups 1 / 4 / 8, head_dim 64 / 128: one launch a
    call, the out of its plain version, trailing rows exactly 0."""
    gen = torch.Generator(device=cuda).manual_seed(31)
    T = sum(lens) + pad
    q = _rand((T, H, D), gen, cuda)
    k, v = (_rand((T, Hkv, D), gen, cuda) for _ in range(2))
    cu = _cu_of(lens, cuda)
    before = attn.FLASH_ATTENTION_VARLEN.launches
    got = attn.flash_attention_varlen(q, k, v, cu, causal=causal)
    torch.cuda.synchronize()
    assert attn.FLASH_ATTENTION_VARLEN.launches == before + 1
    meta = attn.segment_sideband(cu, T)[None]
    want, _ = attn._flash_attention_varlen_plain(
        q[None], k[None], v[None], meta, [[0, 0, T]], causal=causal,
        scale=D ** -0.5)
    _varlen_close(got[None], want, sum(lens))


@pytest.mark.parametrize("D,G", [(128, 4), (64, 1), (128, 8)])
def test_flash_attention_varlen_offsets_table_matches_plain(cuda, D, G):
    """The per-batch-row (q_offset, kv_offset, kv_valid) table of the
    varlen ring: four batch rows, each a rank's 200-row shard of a packed
    batch of 800 rows against another rank's kv shard, kv_valid cut short
    on one; out and lse against the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(32)
    n, s, Hkv = 4, 200, 2
    H = Hkv * G
    lens = (130, 333, 7, 250, 40)          # 760 of 800 rows live
    meta = attn.segment_sideband(_cu_of(lens, cuda), n * s).view(n, s, 128)
    q = _rand((n, s, H, D), gen, cuda)
    k, v = (_rand((n, s, Hkv, D), gen, cuda) for _ in range(2))
    offs = torch.tensor([[0, 600, 200], [200, 0, 200], [400, 200, 150],
                         [600, 400, 200]], dtype=torch.int32, device=cuda)
    for causal in (True, False):
        got, lse = attn._fa_varlen_call(q, k, v, meta, offs, causal=causal,
                                        scale=D ** -0.5, need_lse=True)
        want, want_lse = attn._flash_attention_varlen_plain(
            q, k, v, meta, offs, causal=causal, scale=D ** -0.5)
        torch.cuda.synchronize()
        e = (got.float() - want.float()).abs().max().item()
        assert e <= OUT_TOL and _row_err(got, want) <= ROW_TOL, e
        seen = want_lse > -1e29
        assert ((lse - want_lse).abs()[seen] <= LSE_TOL).all()
        assert (lse[~seen] < -1e29).all() and (got[~seen] == 0).all()


def test_flash_attention_varlen_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((64, 4, 96), dtype=torch.bfloat16, device=cuda)
    kv = torch.zeros((64, 2, 96), dtype=torch.bfloat16, device=cuda)
    cu = _cu_of((64,), cuda)
    with pytest.raises(ValueError, match="head_dim"):
        attn.flash_attention_varlen(q, kv, kv, cu)
    with pytest.raises(ValueError, match="contiguous"):
        attn.flash_attention_varlen(q[..., :64], kv[..., :64], kv[..., :64],
                                    cu)
    qf, kvf = q[..., :64].float().contiguous(), kv[..., :64].float()
    with pytest.raises(TypeError, match="bfloat16"):
        attn.flash_attention_varlen(qf, kvf.contiguous(), kvf.contiguous(),
                                    cu)


def _ag_case(n, s, H, Hkv, D, seed, device, lens=None):
    gen = torch.Generator(device=device).manual_seed(seed)
    q = _rand((n, 1, s, H, D), gen, device)
    k, v = (_rand((n, 1, s, Hkv, D), gen, device) for _ in range(2))
    meta = None
    if lens is not None:
        meta = attn.segment_sideband(_cu_of(lens, device),
                                     n * s).view(n, s, 128)
    return q, k, v, meta


def _ag_plain(q, k, v, meta, causal):
    from triton_distributed_tpu_torch.ops import sp_ag_attention as tag
    return tag._sp_ag_attention_plain(q[:, 0], k[:, 0], v[:, 0], meta,
                                      causal=causal,
                                      scale=q.shape[-1] ** -0.5)[:, None]


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("varlen", [False, True])
def test_sp_ag_attention_kernel_matches_plain(cuda, n, causal, varlen):
    """The fused kernel against its plain version at n = 2, 4, 8: two
    calls back to back with new data (the second must not pass on the
    first's signals), one launch a call logged "kernel"; with varlen a
    packed batch whose sequences cross shard boundaries and whose last
    rows are past cu_seqlens[-1] (exactly 0)."""
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import _common
    from triton_distributed_tpu_torch.ops import sp_ag_attention as tag
    s, H, Hkv, D = 256, 8, 2, 128
    T = n * s
    lens = (s // 2 + 3, s + 40, 7, T - 3 * s // 2 - 90) if varlen else None
    cfg = tag.SpAgAttnConfig(force_kernel=True)
    for seed in (41, 42):
        q, k, v, meta = _ag_case(n, s, H, Hkv, D, seed, cuda, lens)
        before = tag.SP_AG_ATTENTION.launches
        _common.reset_dispatch()
        got = tag.sp_ag_attention_shard(q, k, v, num_ranks=n, causal=causal,
                                        config=cfg, qmeta=meta)
        torch.cuda.synchronize()
        shmem.check_faults()
        assert tag.SP_AG_ATTENTION.launches == before + 1
        assert _common.dispatch_counts() == {
            ("sp_ag_attention", "kernel", ""): 1}
        want = _ag_plain(q, k, v, meta, causal)
        live = sum(lens) if varlen else T
        _varlen_close(got.reshape(1, T, H, D), want.reshape(1, T, H, D),
                      live)


@pytest.mark.parametrize("s,H,Hkv,D", [(100, 8, 2, 64), (64, 32, 8, 128),
                                       (72, 4, 4, 128)])
def test_sp_ag_attention_ragged_tiles_match_plain(cuda, s, H, Hkv, D):
    """Shard lengths that are no multiple of the kernel's 64-row tile (the
    dispatch takes them with block 4 or 8), GQA 4 and 1, both masks."""
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import sp_ag_attention as tag
    n = 4
    cfg = tag.SpAgAttnConfig(block_q=4, block_k=4, force_kernel=True)
    for causal in (True, False):
        q, k, v, _ = _ag_case(n, s, H, Hkv, D, 43, cuda)
        got = tag.sp_ag_attention_shard(q, k, v, num_ranks=n, causal=causal,
                                        config=cfg)
        torch.cuda.synchronize()
        shmem.check_faults()
        want = _ag_plain(q, k, v, None, causal)
        e = (got.float() - want.float()).abs().max().item()
        assert e <= OUT_TOL and _row_err(got, want) <= ROW_TOL, e


def test_sp_ag_attention_planted_lost_signal_raises_and_the_next_call_is_clean(
        cuda):
    """One notification of source 1's chunk 1 taken out of rank 2's pad:
    the wait times out within the budget (50 ms), the check raises naming
    rank 2, the chunk's rows and source rank 1, and the next call runs
    clean."""
    import time
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import sp_ag_attention as tag
    n, s, H, Hkv, D = 4, 512, 8, 2, 128
    q, k, v, _ = _ag_case(n, s, H, Hkv, D, 44, cuda)
    cfg = tag.SpAgAttnConfig(force_kernel=True)
    tag.sp_ag_attention_shard(q, k, v, num_ranks=n, config=cfg)
    torch.cuda.synchronize()
    # the workspace of the call's own device ("cuda:0", not "cuda")
    ws = tag.workspace(q.device, n, s, Hkv, D, torch.bfloat16, True)
    chunk = tag.chunk_rows(s)
    nchunk = -(-s // chunk)
    assert ws.epoch == 1 and nchunk > 1
    ws.pads[2, 1 + 1 * nchunk + 1] -= 1
    t0 = time.perf_counter()
    tag.sp_ag_attention_shard(q, k, v, num_ranks=n, config=cfg,
                              wait_budget=0.05)
    torch.cuda.synchronize()
    assert time.perf_counter() - t0 < 5.0
    with pytest.raises(RuntimeError, match=(
            rf"sp_ag_attention\[causal\]: rank 2 timed out .*kv rows "
            rf"{chunk}\.\.{2 * chunk - 1} \(chunk 1\) from source rank 1")):
        shmem.check_faults()
    assert ws.epoch == 0 and int(ws.pads.abs().sum()) == 0
    got = tag.sp_ag_attention_shard(q, k, v, num_ranks=n, config=cfg)
    torch.cuda.synchronize()
    shmem.check_faults()
    want = _ag_plain(q, k, v, None, True)
    e = (got.float() - want.float()).abs().max()
    assert e.item() <= OUT_TOL and _row_err(got, want) <= ROW_TOL


def test_sp_ag_attention_refuses_a_grid_that_cannot_be_resident(cuda):
    """One CTA more than can be resident is refused; one CTA alone walks
    every item in the global order (barrier arrivals, pushes, consumers)
    and finishes with the plain version's result."""
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import sp_ag_attention as tag
    n, s, H, Hkv, D = 4, 128, 4, 2, 128
    q, k, v, _ = _ag_case(n, s, H, Hkv, D, 45, cuda)
    most = tag.resident_ctas(D)
    assert most >= torch.cuda.get_device_properties(0).multi_processor_count
    ws = tag.workspace(q.device, n, s, Hkv, D, q.dtype, True)
    qs, ks, vs = (t[:, 0].contiguous() for t in (q, k, v))
    out = torch.empty_like(qs)
    with pytest.raises(RuntimeError, match="CUDA error"):
        shmem.launch_sp_ag(tag.SP_AG_ATTENTION, ws, qs, ks, vs, None, out,
                           causal=True, scale=D ** -0.5, grid=most + 1)
    shmem.launch_sp_ag(tag.SP_AG_ATTENTION, ws, qs, ks, vs, None, out,
                       causal=True, scale=D ** -0.5, grid=1)
    torch.cuda.synchronize()
    shmem.check_faults()
    want = _ag_plain(q, k, v, None, True)[:, 0]
    e = (out.float() - want.float()).abs()
    assert e.max().item() <= OUT_TOL and _row_err(out, want) <= ROW_TOL


def test_sp_ag_attention_refuses_what_the_kernel_does_not_take(cuda):
    from triton_distributed_tpu_torch.ops import sp_ag_attention as tag
    cfg = tag.SpAgAttnConfig(force_kernel=True)
    q = torch.zeros((4, 1, 64, 4, 96), dtype=torch.bfloat16, device=cuda)
    kv = torch.zeros((4, 1, 64, 2, 96), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tag.sp_ag_attention_shard(q, kv, kv, num_ranks=4, config=cfg)
    q = torch.zeros((16, 1, 64, 4, 64), dtype=torch.bfloat16, device=cuda)
    kv = torch.zeros((16, 1, 64, 2, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="at most 8 ranks"):
        tag.sp_ag_attention_shard(q, kv, kv, num_ranks=16, config=cfg)
