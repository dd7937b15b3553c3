"""Times the one-rank megakernel's steps on the card, for comparing two
checkouts of the port on one card: the batched serve step (4 slots x 1
row), the verify step (4 slots x 8 rows, widths 5 / 5 / 1 / 5) and the
decode step, all 36 layers at Qwen3-8B widths, and the MoE serve step at
Qwen3-30B-A3B widths cut to 16 of its 48 layers, bf16, random weights
from a seed. Each time is the median of 5 rounds of 20 launches, timed
by CUDA events.

    python triton_distributed_tpu_torch/tools/mk_steps.py [--root DIR]

times the package under DIR (default: the checkout holding this file),
so running it with the root of another checkout, then this one, then
this one, then the other, gives paired readings."""

from __future__ import annotations

import argparse
import os
import statistics
import sys

import numpy as np

DENSE = dict(hidden=4096, intermediate=12288, num_layers=36, num_heads=32,
             num_kv_heads=8, head_dim=128, qk_norm=True)
MOE = dict(hidden=2048, moe_intermediate=768, num_experts=128, top_k=8,
           num_layers=16, num_heads=32, num_kv_heads=4, head_dim=128,
           qk_norm=True)
LENS = np.asarray([620, 263, 1501, 64], np.int32)
WIDTHS = np.asarray([5, 5, 1, 5], np.int32)
PAGED = dict(b_slots=4, num_blocks=64, block=128, max_pages=16)


def time_ms(torch, fn, reps=20, rounds=5):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def table(widths):
    """Each slot's pages up to its last appended row from a permutation
    of the shared pages, every other column on its own trash page."""
    blk, mp, nb = PAGED["block"], PAGED["max_pages"], PAGED["num_blocks"]
    last = LENS + widths - 1
    perm = np.random.RandomState(7).permutation(nb)
    return np.asarray([[perm[b * mp + c] if c <= last[b] // blk else nb + b
                        for c in range(mp)] for b in range(len(LENS))],
                      np.int32)


def draw(torch, graph, gen, dev, experts=None):
    """bf16 weights: norms 1 + |N(0, 0.04)|, the rest N(0, 1 / rows) (an
    expert slab's rows those of one expert)."""
    ws = {}
    for n, h in graph.weights.items():
        t = torch.randn(h.shape, generator=gen, device=dev)
        if "ln" in n or "norm" in n:
            t = (t * 0.2).abs() + 1
        else:
            t = t * h.rows ** -0.5
            if experts and "w_moe" in n:
                t = t * experts ** 0.5
        ws[n] = t.to(torch.bfloat16)
    return ws


def program(torch, mb, ws, gen, dev):
    p = mb.compile("kernel", device=dev)
    p.bind_weights({n: ws[n] for n in mb.graph.weights})
    for c in p.bind_caches().values():
        c.normal_(generator=gen)
    p.inputs["x"].normal_(generator=gen)
    return p


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    root = os.path.abspath(ap.parse_args(argv).root)
    sys.path.insert(0, root)
    import torch
    from triton_distributed_tpu_torch.megakernel.models import (
        build_qwen3_decode, build_qwen3_moe_serve_batched,
        build_qwen3_serve_batched)
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    ms = {}
    serve = build_qwen3_serve_batched(slot_rows=1, dtype=bf16, **PAGED,
                                      **DENSE)
    ws = draw(torch, serve.graph, gen, dev)
    p = program(torch, serve, ws, gen, dev)
    tbl = table(np.ones(4, np.int32))
    ms["serve"] = time_ms(torch, lambda: p.step(cache_lens=LENS,
                                                block_table=tbl))
    p.check_fault()
    del p
    verify = build_qwen3_serve_batched(slot_rows=8, dtype=bf16, **PAGED,
                                       **DENSE)
    p = program(torch, verify, ws, gen, dev)
    tbl = table(WIDTHS)
    ms["verify"] = time_ms(torch, lambda: p.step(
        cache_lens=LENS, block_table=tbl, widths=WIDTHS))
    p.check_fault()
    del p
    dec = build_qwen3_decode(seq_len=1, max_cache=1024, kv_append=True,
                             dtype=bf16, **DENSE)
    p = program(torch, dec, ws, gen, dev)
    ms["decode"] = time_ms(torch, lambda: p.step(cache_len=500))
    p.check_fault()
    del p, ws
    torch.cuda.empty_cache()
    moe = build_qwen3_moe_serve_batched(slot_rows=1, dtype=bf16, **PAGED,
                                        **MOE)
    ws = draw(torch, moe.graph, gen, dev, MOE["num_experts"])
    p = program(torch, moe, ws, gen, dev)
    tbl, live = table(np.ones(4, np.int32)), np.ones(4, np.int32)
    ms["moe-serve"] = time_ms(torch, lambda: p.step(
        cache_lens=LENS, block_table=tbl, widths=live))
    p.check_fault()
    print(f"mk_steps {root}: " + ", ".join(f"{k} {v:.4f} ms"
                                           for k, v in ms.items()))


if __name__ == "__main__":
    main()
