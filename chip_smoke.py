"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N] [--profile]

Phases, in order; any failure raises and exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from triton_distributed_tpu_torch/csrc;
  3. each kernel against its plain PyTorch version at the main path's
     shapes, in bf16, with times for the kernel, the plain version and
     torch's scaled_dot_product_attention (a yardstick only);
  4. a small model on the GPU (kernels) against the same model on the
     CPU (plain versions);
  5. the main path: Qwen3-8B at full width and depth with random bf16
     weights, Engine.serve on 4 prompts of 500 tokens, 32 tokens each;
     the launch counts show both kernels ran; start + step reproduce
     serve's tokens and give prefill ms and decode tokens/s; the aten
     ops one decode step dispatches on the host are counted;
  6. with --profile, torch.profiler over a few decode steps: device-busy
     ms per step, the device's idle share, the top kernels;
  7. one JSON line of per-kernel numbers, then the device JSON line.
Without a GPU it exits non-zero before printing anything.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 rate
OUT_TOL = 2e-2             # bf16 outputs: p and out rounded at other points
LSE_TOL = 1e-3             # f32 lse from f32 scores: summation order, exp2
COLD_COPIES = 4            # input copies rotated so each launch finds L2 cold


class OpCount(TorchDispatchMode):
    """Counts the aten ops dispatched on the host while it is active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def time_ms(fns, reps=20, rounds=5):
    """Median device ms of one call, cycling through `fns` (closures over
    distinct input copies). A sleep kernel queued first lets all `reps`
    launches be enqueued before the device reaches them, so host work
    between launches does not count."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        start.record()
        for i in range(reps):
            fns[i % len(fns)]()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def bound(nbytes, flops):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def check_flash_attention(attn, dev, gen):
    """Prefill kernel at the main path's shape (bucket 512), causal, and
    the partial form with offsets and a ragged valid prefix."""
    import torch.nn.functional as F
    B, S, H, Hkv, D = 4, 512, 32, 8, 128
    sets = [tuple(torch.randn(shape, generator=gen, device=dev).bfloat16()
                  for shape in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
            for _ in range(COLD_COPIES)]
    q, k, v = sets[0]
    out = attn.flash_attention(q, k, v, causal=True)
    ref, _ = attn._flash_attention_plain(q, k, v, 0, 0, S, causal=True,
                                         scale=D ** -0.5)
    err = (out.float() - ref.float()).abs().max().item()
    print(f"flash_attention causal {tuple(q.shape)}: max_abs_err {err:.3e}")
    assert err <= OUT_TOL, err
    out, lse = attn.flash_attention_partial(q, k, v, q_offset=300,
                                            kv_offset=200, kv_valid=400)
    ref, ref_lse = attn._flash_attention_plain(q, k, v, 300, 200, 400,
                                               causal=True, scale=D ** -0.5)
    perr = (out.float() - ref.float()).abs().max().item()
    lerr = (lse - ref_lse).abs().max().item()
    print(f"flash_attention_partial q_off 300 kv_off 200 kv_valid 400: "
          f"max_abs_err {perr:.3e}, lse {lerr:.3e}")
    assert perr <= OUT_TOL and lerr <= LSE_TOL, (perr, lerr)

    ms = time_ms([lambda s=s: attn.flash_attention(*s, causal=True)
                  for s in sets])
    plain_ms = time_ms([lambda s=s: attn._flash_attention_plain(
        *s, 0, 0, S, causal=True, scale=D ** -0.5) for s in sets], reps=5)
    lib_ms = time_ms([lambda s=s: F.scaled_dot_product_attention(
        s[0].transpose(1, 2), s[1].transpose(1, 2), s[2].transpose(1, 2),
        is_causal=True, enable_gqa=True) for s in sets])
    pairs = B * H * S * (S + 1) // 2          # causal (row, col) pairs seen
    bms, by = bound(nbytes(q, k, v, out), 4 * pairs * D)
    print(f"flash_attention: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    return {"name": "flash_attention", "route": "cuda",
            "source": "triton_distributed_tpu_torch/csrc/flash_attention.cu",
            "replaces": "triton_distributed_tpu/ops/attention.py:42",
            "max_abs_err": max(err, perr), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}


def check_flash_decode(attn, dev, gen):
    """Decode kernel at the main path's shape (cache 1024, kv_len in the
    range the 31 decode steps walk), plus a ragged batch with an empty
    row."""
    import torch.nn.functional as F
    B, Smax, H, Hkv, D = 4, 1024, 32, 8, 128
    sets = [tuple(torch.randn(shape, generator=gen, device=dev).bfloat16()
                  for shape in ((B, H, D), (B, Smax, Hkv, D),
                                (B, Smax, Hkv, D)))
            for _ in range(COLD_COPIES)]
    q, k, v = sets[0]
    err = 0.0
    for lens in ([501, 511, 521, 531], [0, 17, 300, 532]):
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        out, lse = attn.flash_decode_partial(q, k, v, kv_len)
        ref, ref_lse = attn._flash_decode_plain(q, k, v, kv_len,
                                                scale=D ** -0.5)
        e = (out.float() - ref.float()).abs().max().item()
        le = (lse - ref_lse).abs().max().item()
        print(f"flash_decode_partial kv_len {lens}: max_abs_err {e:.3e}, "
              f"lse {le:.3e}")
        assert e <= OUT_TOL and le <= LSE_TOL, (e, le)
        err = max(err, e)
    lens = [501, 511, 521, 531]
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    mask = (torch.arange(Smax, device=dev)[None, :] < kv_len[:, None])
    mask = mask[:, None, None, :]
    ms = time_ms([lambda s=s: attn.flash_decode_partial(*s, kv_len)
                  for s in sets])
    plain_ms = time_ms([lambda s=s: attn._flash_decode_plain(
        *s, kv_len, scale=D ** -0.5) for s in sets])
    lib_ms = time_ms([lambda s=s: F.scaled_dot_product_attention(
        s[0][:, :, None], s[1].transpose(1, 2), s[2].transpose(1, 2),
        attn_mask=mask, enable_gqa=True) for s in sets])
    rows = sum(lens)
    moved = nbytes(q, kv_len, out, lse) + 2 * rows * Hkv * D * 2
    bms, by = bound(moved, 4 * rows * H * D)
    print(f"flash_decode: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    return {"name": "flash_decode", "route": "cuda",
            "source": "triton_distributed_tpu_torch/csrc/flash_decode.cu",
            "replaces": "triton_distributed_tpu/ops/attention.py:513",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}


def check_small_model(models, seed):
    """A small Qwen3-shaped model (head_dim 128, 4 q heads per kv head,
    as the main path) on the GPU through the kernels against the same
    weights on the CPU through the plain versions, in bf16: prefill
    logits within a bound, and the greedy token equal wherever the CPU's
    top-2 gap exceeds twice the logit error."""
    cfg = models.get_config("Qwen/Qwen3-8B").tiny(
        hidden_size=256, num_heads=8, num_kv_heads=2, head_dim=128,
        intermediate_size=512, vocab_size=512, num_layers=2)
    cpu = models.DenseLLM(cfg, dtype="bfloat16", device="cpu")
    params = cpu.init_params(torch.Generator().manual_seed(seed))
    gpu = models.DenseLLM(cfg, dtype="bfloat16", device="cuda")
    gparams = {"embed": params["embed"].cuda(), "norm": params["norm"].cuda(),
               "lm_head": params["lm_head"].cuda(),
               "layers": {k: t.cuda() for k, t in params["layers"].items()}}
    ids = np.random.RandomState(seed).randint(0, cfg.vocab_size, (2, 37))
    logits = []
    for m, p in ((cpu, params), (gpu, gparams)):
        last, _ = m._prefill_hidden(p, ids, m.new_kv_cache(2, 64))
        logits.append((last.float() @ p["lm_head"].float()).cpu())
    ref, got = logits
    assert torch.isfinite(got).all()
    diff = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"small model prefill logits GPU vs CPU: max_abs_err {diff:.3e} "
          f"(max |logit| {scale:.3e})")
    assert diff <= 5e-2 * max(1.0, scale), diff
    top2 = ref.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 2 * diff
    assert torch.equal(got.argmax(-1)[sure], ref.argmax(-1)[sure])


def profile_decode(engine, tok, cache, step_ms, steps=3):
    """Device-busy time of a decode step from a profiler trace, against
    the step's wall time measured without the profiler (`step_ms`)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            tok, cache = engine.step(tok, cache)
        torch.cuda.synchronize()
    rows = [(getattr(e, "self_device_time_total", 0) / 1e3 / steps, e.key,
             e.count // steps) for e in prof.key_averages()]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"profile: decode step device-busy {busy:.3f} ms of {step_ms:.3f} "
          f"ms wall: idle share {1 - busy / step_ms:.3f}")
    for ms, name, count in rows[:8]:
        print(f"profile:   {ms:8.3f} ms/step  {count:5d}/step  {name[:70]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace decode steps with torch.profiler")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(1)

    from triton_distributed_tpu_torch import models
    from triton_distributed_tpu_torch.ops import _build
    from triton_distributed_tpu_torch.ops import attention as attn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(smi)

    t0 = time.perf_counter()
    build_s = _build.build_all()
    print(f"build: {build_s:.1f} s for {len(_build.sources())} sources "
          f"(phase {time.perf_counter() - t0:.1f} s)")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    kernels = [check_flash_attention(attn, dev, gen),
               check_flash_decode(attn, dev, gen)]
    torch.cuda.empty_cache()
    check_small_model(models, args.seed)

    cfg = models.get_config("Qwen/Qwen3-8B")
    model = models.DenseLLM(cfg, dtype="bfloat16", device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(
        args.seed))
    torch.cuda.synchronize()
    print(f"Qwen3-8B: {cfg.num_layers} layers, hidden {cfg.hidden_size}, "
          f"heads {cfg.num_heads}/{cfg.num_kv_heads}, vocab "
          f"{cfg.vocab_size}; weights "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    B, S, GEN = 4, 500, 32
    ids = np.random.RandomState(args.seed).randint(0, cfg.vocab_size, (B, S))
    engine = models.Engine(model, params, max_len=1024)

    for k in (attn.FLASH_ATTENTION, attn.FLASH_DECODE):
        k.launches = 0
    t0 = time.perf_counter()
    toks = engine.serve(ids, GEN)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {"flash_attention": attn.FLASH_ATTENTION.launches,
                "flash_decode": attn.FLASH_DECODE.launches}
    print(f"serve: tokens {toks.shape}, {serve_s * 1e3:.1f} ms (first call), "
          f"launches {launches}")
    assert toks.shape == (B, GEN) and toks.dtype == np.int32
    assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
    assert launches == {"flash_attention": cfg.num_layers,
                        "flash_decode": cfg.num_layers * (GEN - 1)}, launches

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok, cache = engine.start(ids)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    steps = [tok]
    for _ in range(GEN - 1):
        tok, cache = engine.step(tok, cache)
        steps.append(tok)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    stepwise = torch.stack(steps, dim=1).cpu().numpy()
    assert np.array_equal(stepwise, toks), "start+step differ from serve"
    prefill_ms = (t1 - t0) * 1e3
    decode_tps = B * (GEN - 1) / (t2 - t1)
    print(f"prefill ms {prefill_ms:.2f} (B={B}, S={S}, bucket 512) | "
          f"decode tokens/s {decode_tps:.1f} (B={B}, {GEN - 1} steps, "
          f"{(t2 - t1) / (GEN - 1) * 1e3:.2f} ms/step) | {smi}")
    with OpCount() as ops:
        engine.step(tok, cache)
    torch.cuda.synchronize()
    print(f"decode step: {ops.n} aten ops dispatched on the host "
          f"({ops.n / cfg.num_layers:.1f} per layer) and "
          f"{cfg.num_layers} flash_decode launches")
    if args.profile:
        profile_decode(engine, tok, cache, (t2 - t1) / (GEN - 1) * 1e3)

    for k in kernels:
        k["launches"] = launches[k["name"]]
    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in order}
                                  for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
