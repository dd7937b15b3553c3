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
  7. the paged decode kernel, each arm (bf16, int8 and fp8 pools)
     against its plain version at the serving shape (4 slots, 8 kv
     heads, 4 q heads per kv head, head_dim 128, 128-token pages) on a
     shuffled block table with a shared page and -1 holes, with times;
  8. a small model's paged steps (a prefill chunk over a cached prefix
     and a decode step) on the GPU against the CPU, bf16 and int8 pools;
  9. the slice-2 main path: Qwen3-8B (the same weights) behind
     ServeEngine(b_max=4, max_len=2048, block=128, prefill_chunk=256),
     a 64-block pool, 8 requests with a shared 512-token prefix and a
     repeated block-aligned prompt; the bf16 run is checked (lengths,
     prefix hits, copy-on-write, exact launch counts, conservation,
     a rerun with identical tokens), then the int8 and fp8 pools; with
     --profile, the device's idle share over a short serve run;
 10. the megakernel (csrc/megakernel.cu) against its plain queue walk on
     2-layer decode graphs: f32 at hidden 256 (1e-4 of the largest
     value), and at Qwen3-8B widths for the main path's two programs
     (one decode row and a 256-row chunk at cache_len 500) in f32
     (1e-4) and bf16 (2e-2);
 11. a small model's MegaDecoder on the GPU (kernel) against the same
     model on the CPU (plain walk), f32: greedy tokens equal;
 12. the slice-3 main path: MegaDecoder.from_dense over the same Qwen3-8B
     weights, max_cache 1024, a 500-token prompt (two 256-row chunks),
     32 greedy tokens: exactly 2 + 31 megakernel launches and no other
     kernel's, identical tokens on a rerun, the first token equal to
     Engine.serve's, teacher-forced hidden rows within 5e-2 of the
     engine's; prefill ms, decode ms per step and tokens/s, aten ops per
     decode step; with --profile, the device's idle share over decode
     steps;
 13. the main path's Qwen3-8B programs on copies of the caches it
     filled, the 256-row prefill chunk at cache_len 256 and the decode
     step at cache_len 500: the kernel against its plain walk and the
     golden executor (5e-2 of the largest value), outputs and appended
     K/V rows of every layer; the decode step's times and bound; with
     --profile, a breakdown of the step's time;
 14. the MoE grouped GEMM (csrc/grouped_gemm.cu) against its plain
     version at Qwen3-30B-A3B shapes in bf16 (2e-2 of the largest value):
     gate_up (K 2048, N 1536) and down (K 768, N 2048) over 128 experts,
     each under the decode routing (4 rows x top-8) and the prefill
     routing (2048 rows x top-8) of a seeded router; pad rows exactly 0;
     times for the kernel, the plain version, torch._grouped_mm over the
     same aligned rows (a yardstick only) and gather_sorted;
 15. GQA group 8 (Qwen3-30B-A3B's 32 q heads over 4 kv heads) through
     the three attention kernels against their plain versions;
 16. a small Qwen3MoE (head_dim 128, group 8, block_m 16) on the GPU
     against the same model on the CPU, bf16: prefill logits and the
     logits of one decode step from the CPU's greedy tokens within 5e-2
     of the largest, the first greedy token equal;
 17. the slice-4 main path: the Qwen3-8B weights, caches and decoders are
     released (device memory under 1 GiB), then Qwen3-30B-A3B at full
     width and depth (48 layers, 128 experts, top-8) with random bf16
     weights behind Engine.serve on 4 prompts of 500 tokens, 32 tokens
     each: exact launch counts (flash_attention 48, flash_decode 48 x 31,
     gmm 2 x 48 x 32), start + step reproduce serve's tokens, prefill ms,
     decode tokens/s, aten ops per decode step, one MoE layer's decode
     forward under torch.cuda.set_sync_debug_mode("error"); with
     --profile, the device's idle share over decode steps;
 18. ServeEngine over the same MoE weights with the serve cell's stream
     and settings (bf16 pool): the checks of step 9 with exact gmm
     launch counts, then ep_capacity=2: slots deferred, every request at
     its length, ep_rows equal to the rows decode routed;
 19. the megakernel's paged serving bodies (ATTN_P, KVA_PK, KVA_PV) on
     2-layer serve graphs at Qwen3-8B widths and the serve cell's pool
     (four slots at lengths 0 (idle, on its trash page), 128, 777, 1500,
     a shuffled table): the kernel against its plain walk, f32 (1e-4)
     and bf16 (2e-2), and in bf16 against the golden executor, with
     every pool row outside the appends bitwise unchanged;
 20. a small model's ServeEngine(mode="megakernel") on the GPU against
     the CPU (bf16: logits of every pick within 5e-2, picks equal where
     the margin allows);
 21. the slice-3b main path: ServeEngine(mode="megakernel") over the
     Qwen3-8B weights with step 9's stream and settings, bf16 pool:
     step 9's checks (no prefix hits: megakernel slots plan fresh),
     exactly one megakernel launch per decode tick and no
     flash_decode_paged launch, the median decode tick and its aten ops,
     token agreement with step 9's engine-mode run (information), a
     second run with identical tokens whose first all-slots-decoding
     tick's logits are held within 5e-2 of the largest against
     decode_step_paged on the same state, the batched step's time
     against its bound; then the int8 pool; with --profile, the device's
     idle share over a short megakernel serve run;
 22. the megakernel's MoE body (GROUPED_GEMM, two tasks a layer) on
     2-layer MoE serve graphs at Qwen3-30B-A3B widths (hidden 2048, 128
     experts, top-8, intermediate 768, 32/4 heads, head_dim 128) and the
     serve cell's pool, step 19's four slots (the idle one at width 0):
     the kernel against its plain walk, f32 (1e-4) and bf16 (2e-2), and
     in bf16 against the golden executor, outputs, each layer's expert
     output and the appended rows; the idle slot's rows 0, other pool
     rows unchanged; then every slab no live row routes to is NaN and the
     outputs keep their bits; the bf16 step's time against its bound;
 23. a small Qwen3MoE's ServeEngine(mode="megakernel") on the GPU against
     the CPU, as step 20;
 24. the slice-3c main path: ServeEngine(mode="megakernel") over the
     Qwen3-30B-A3B weights of step 17 with step 9's stream and settings,
     bf16 pool: step 9's checks, exactly one megakernel launch per
     decode tick, no flash_decode_paged launch and gmm only in the
     engine-path prefill chunks, the median decode tick and its aten
     ops, a rerun with identical tokens whose first all-slots tick is
     held against the golden executor on the same state (5e-2 of the
     largest; every layer's top-8 sets equal but at near-ties, which are
     counted) and, as information, against decode_step_paged; the
     batched step's time against its bound (the routed slabs); then the
     int8 pool, then ep_capacity=2 (slots deferred, every request at its
     length, ep_rows the rows decode routed); token agreement with step
     18 as information; the peak device memory; with --profile, a
     breakdown of the step (every slot idle, rows live at length 0) and
     the device's idle share over a short megakernel serve run;
 25. the megakernel's verify-width arms (ATTN_P, KVA_PK / KVA_PV and
     GROUPED_GEMM at widths > 1) on 2-layer serve graphs at Qwen3-8B and
     Qwen3-30B-A3B widths, slot_rows 8, widths 0 / 1 / 3 / 8, against
     the plain walk: f32 (1e-4) and bf16 (2e-2), pad rows exactly 0,
     every pool row outside the appended windows bitwise unchanged;
 26. a small model's speculative ServeEngine on the GPU against the CPU
     in engine and megakernel mode, bf16, an oracle drafter: every
     greedy pick and the spec counters equal, spec-on tokens equal to
     spec-off;
 27. the slice-2b main path: Qwen3-8B behind step 9's stream with an
     oracle drafter (k 4, every third draft wrong), in engine mode and in
     megakernel mode (slot_rows 8), then `speculative=True` and an int8
     pool: exact launch counts a verify tick, conservation, accepts and
     rejects; at the first all-slots verify the teacher-forced check of
     both verify steps against 4 sequential decode steps (2.5e-2 of the
     largest logit, greedy differences only at near-ties) and the same
     check failing a planted fault (the candidate rows roped one position
     late); the verify step's time against its bound and plain walk, and
     the perf_model constants;
 28. the Qwen3-30B-A3B megakernel spec runs (k 4, then k 2 under
     ep_capacity=2): GROUPED_GEMM at widths > 1, every request at its
     length, the verify step against its routed-slab bound;
 29. the megakernel's fused decode arms (both fusion flags: LINEAR with
     an RMS_NORM or SILU_MUL prologue and a residual epilogue, ATTN that
     appends its K / V) on 2-layer decode graphs of one row, at hidden
     256 (f32, bf16, qk_norm on and off) and at Qwen3-8B widths (f32,
     bf16): against the plain walk (1e-4 / 2e-2 of the largest value)
     and bit for bit against the unfused kernel, outputs and appended
     rows;
 30. the slice-3d main path: MegaDecoder.from_dense(..., fuse_elementwise=
     True, fuse_kv_append=True) over step 12's weights and prompt, 32
     greedy tokens: exactly 2 + 31 megakernel launches, 217 tasks a
     decode launch against 469, tokens and teacher-forced hidden rows bit
     for bit equal to step 12's decoder (the largest logit difference and
     the smallest top-2 margin printed); the decode step at cache_len 500
     against its plain walk and bit for bit against the unfused kernel;
     the fused and unfused steps by CUDA events in turns, each flag
     alone, the fused step's bound and the latency of a dependent stage;
     the fused decoder's caches are then freed;
 31. the tensor-parallel kernels (csrc/ag_gemm.cu, gemm_rs.cu, gemm_ar.cu)
     against their plain versions at the tp-engine cell's shapes (Qwen3-8B,
     4 x 512 rows: qkv and gate_up through ag_gemm, o and down through
     gemm_rs, gemm_ar at decode M 1 and 4 and at prefill M 2048), at n = 2
     and 4 ranks, bf16 (2e-2 of the largest value) and f32 (1e-5): two
     calls back to back with new data, gemm_ar's replicas bit for bit
     equal, every call logged "kernel"; at n = 4 in bf16 the times of the
     kernel, its plain version and the library call (one torch.matmul of
     the gathered A for ag_gemm, one einsum over the ranks for gemm_rs /
     gemm_ar) against the bound; then, at n = 4 in bf16, one call each at
     Qwen3-14B's widths (K 1280 and 4352, no multiple of the JAX op's
     512-deep tile, and gemm_ar at 192 rows), which the kernels take too;
 32. a planted fault in each: the C entry called with a signal target one
     epoch ahead sets the fault word within the wait budget, the check
     raises naming the rank, and the next call runs clean;
 33. a small model at n = 2 ranks on the GPU against the CPU in all four
     modes, bf16 (as step 4, with the fused modes' launches counted); then
     a fault planted in its "gemm_ar" decode step's workspace makes
     Engine.step raise before a token leaves, and start + step run clean;
 34. the slice-6a main path, the tp-engine cell: step 5's weights re-laid
     into 4 rank shards behind Engine(max_len=1024), step 5's prompts, in
     the modes "fused", "gemm_ar" and "xla": step 5's checks with exact
     launch counts (ag_gemm and gemm_rs 72 a prefill in "fused", gemm_ar
     72 a prefill and 72 a decode step in "gemm_ar"), every fused-op call
     logged "kernel", the teacher-forced logits of the prefill and 8
     decode steps within TP_LOGIT_TOL of the largest against the one-rank
     engine's and the "xla" mode's, greedy tokens printed; the rank-stacked
     weights are then freed;
 35. the ragged all-to-all of expert parallelism (csrc/ep_a2a.cu) against
     its plain version, bit for bit on the valid rows, at the ep-engine
     cell's dispatch (n = 4, 500 rows a rank routed top-8 over 128
     experts, C 4096, 2048-wide bf16 rows) twice, then its packed int8
     and fp8 wire rows, then at n = 2 with a zero-count and a full pair;
     the kernel, its plain version and the library transpose of the
     padded buffer timed against the bound of the real rows;
 36. a planted lost signal (one notification taken out of a receiver's
     pad): the check raises within the wait budget naming the rank and
     the source, and the next call runs clean;
 37. a small Qwen3MoE at n = 2 and 4 in mode "fused", EP over both
     transports and TP experts, GPU vs CPU in bf16 (as step 33), the
     ragged runs launching the a2a twice a prefill layer;
 38. the slice-6c main path, the ep-engine cell: step 17's weights with
     the experts as views and the attention re-laid for n = 4 ranks,
     Engine(max_len=1024), step 17's prompts, mode "fused" with ep_method
     "ragged", "xla" and "ragged" at ep_pipeline=2: step 5's checks with
     exact launch counts, tokens equal across the three, peak device
     memory, teacher-forced logits with the one-rank engine's routing
     forced within TP_LOGIT_TOL of its logits and every routing the model
     would choose equal to it but at near-ties, one EP layer's prefill
     forward under set_sync_debug_mode("error"), then the same forward
     with NaN planted in every a2a landing row (the rows past the counts
     must change no output bit); then TP experts at n = 4 on the first 8
     layers, checked the same way;
 39. the one-shot LL combine of the sequence-parallel decode
     (csrc/ll_combine.cu) against its plain version at n = 2, 4 and 8, at
     the sp-serve cell's rows (4 slots x 32 heads of 128) and odd rows, in
     bf16 and f32, bit for bit, a rank past the frontier, NaN in the
     landing regions changing no bit; its merge half alone (`ll_merge`);
     both timed at the cell against their bounds;
 40. a planted lost signal in it: the check raises within the wait budget
     naming the rank, the row block and the source; the next call runs
     clean;
 41. a small model at n = 2 behind ServeEngine, tensor-parallel
     ("gemm_ar", tp_ranks=2) and sequence-parallel under both combines,
     GPU against CPU in bf16 (as step 20), with its kernels' launches;
 42. the slice-6b main path, the tp-serve cell: step 5's weights re-laid
     into 4 rank shards behind ServeEngine(tp_ranks=4) with step 9's
     stream and settings, mode "gemm_ar" with a bf16 then an int8 pool,
     then mode "fused", then "gemm_ar" with speculative decoding (an
     oracle drafter, the n-rank verify step): step 9's checks with exact
     launch counts (gemm_ar twice a layer a tick and a prefill chunk,
     ll_merge never), accepts and rejects under speculation, the rank
     ledgers, tokens/s, the median decode tick and its aten ops; then the
     teacher-forced paged logits of 4 prompts and 8 decode steps against
     the one-rank model's within TP_LOGIT_TOL;
 43. the SP main path, the sp-serve cell: the same weights replicated for
     4 sequence-parallel ranks, the same stream with prefix caching off
     (512 tokens a rank, so prompts cross ownership boundaries),
     sp_combine "ll" then "xla": exact launch counts (ll_combine once a
     layer a decode tick, ll_merge never), check_conservation_sp, the
     metrics of step 42;
     then the teacher-forced paged logits of "ll" against "xla" and the
     one-rank model within TP_LOGIT_TOL;
 44. the megakernel's AR body (the cross-rank sum of an n-rank program)
     alone: an input -> all_reduce -> output program at n = 2, 4 and 8,
     4 slots x 1 and x 8 rows of hidden 4096, f32 and bf16, the kernel
     twice against its plain walk bit for bit; at n = 4, 4 rows, bf16 its
     time, the plain walk's and x.sum(0)'s against the bound, and a chain
     of 72 AR nodes (Qwen3-8B's) timed;
 45. a planted lost signal in it (one push notification taken out of a
     rank's counter): the check raises within the wait budget naming the
     AR task and both ranks; the next launch runs clean;
 46. the tp_shards=True decode and serve graphs, 2 layers at Qwen3-8B's
     local widths for n = 4, every operand drawn per rank: the kernel
     against its plain walk, f32 (1e-4) and bf16 (2e-2), every rank's
     output alike;
 47. the slice-6d main path, the mk-tp-serve cell: step 42's rank shards
     behind ServeEngine(tp_ranks=4, mode="megakernel") with step 9's
     stream and settings: step 9's checks, exactly one megakernel launch
     per decode tick, no paged decode launch, gemm_ar only in prefill
     chunks, the AR tiles counted on the scoreboard (zeroed before the
     run), the per-rank AR bytes; the first all-slots tick's logits
     against the 4-rank decode_step_paged on the same state within 2.5e-2
     of the largest; the batched step's time against its bound and
     against step 21's one-rank step; then with speculative decoding (an
     oracle drafter, k 4, slot_rows 8: the verify width at n ranks);
 48. the tp-wire cell, the quantized wire of the tensor-parallel layers
     (the quant arms of csrc/gemm_rs.cu and gemm_ar.cu): one Qwen3-8B
     layer's TPMLP and TPAttn at n = 4, bf16, prefill of 4 x 512 rows in
     "fused", decode of 4 rows in "gemm_ar" and in "ar", each with an int8
     and an fp8 wire: the quant arms' launches held to the calls (counts
     set to 0 before each run), each output against the layer's
     full-width output within wire.sum_error_bound of its partials; then
     each quant arm at the layers' shapes against its plain version
     (within twice the bound, 99% of the elements bit for bit), its time
     next to its bound, the plain version's and the full-width arm's;
 49. the ep-serve cell: step 18's stream behind ServeEngine(Qwen3MoE(
     num_ranks=4, moe_parallel="ep", ep_method="ragged"), tp_ranks=4) at
     full depth, the experts as views of step 17's, a bf16 pool, then
     ep_capacity=2: step 9's checks with exact launch counts (gmm twice a
     layer a step, the paged decode once a layer a decode tick, ep_a2a
     never: every paged step takes replicated rows), no request cut, the
     rank ledgers, tokens/s, ticks, aten ops a tick, peak memory; the
     teacher-forced paged logits with the one-rank model's routing forced
     within TP_LOGIT_TOL; then TP experts on the first 8 layers (step
     38's cut), checked the same way;
 50. the collective library (csrc/all_gather.cu, reduce_scatter.cu,
     all_reduce.cu; the dense all_to_all over csrc/ep_a2a.cu) at Qwen3-8B's
     widths (hidden 4096, bf16, n = 4): each of the six arms bit for bit
     against its plain version at the row-parallel epilogues' shapes and at
     an odd width, and at n = 2 and 8 with fewer rows; the main path (every
     count set to 0, the host-level entry points and AllGatherLayer with
     AUTO and each method, launches read back, outputs against the XLA
     route's); each arm's time against its bound, plain version and library
     call, AUTO's pick against the fastest arm; PEER_LATENCY_S fitted from
     each arm at 1 row; then a planted lost signal in the one-shot
     AllReduce, raised and returned (return_fault), the next call clean;
 51. the collectives' quantized wire (csrc/reduce_scatter.cu arms 2 and 3,
     all_reduce.cu arm 2, the two-shot composition over them and
     all_gather.cu): each quant arm and the two-shot bit for bit against
     its plain version at n = 2, 4, 8, bf16 and f32, int8 and fp8, blocks
     128, 256 and 315 of a 4095-wide row; the main path (every count set to
     0, reduce_scatter and all_reduce with each method and AUTO and
     quant_all_gather_shard, both wires, launches read back, each output
     within wire.sum_error_bound of the full-width XLA route's); each
     route's time at n = 4, bf16, block 256 beside the full-width arm's,
     its plain version's and its bound; then a planted lost signal in the
     quantized one-shot, raised naming the rank, the block and the source;
 52. the sp-family cell, the SP family beyond serving (the varlen arm of
     csrc/flash_attention.cu, csrc/sp_ag_attention.cu) at Qwen3-8B's
     attention (32 / 8 heads of 128, bf16) over n = 4 ranks: each kernel
     against its plain version on the cell's shapes (the fused one causal
     and full, dense and varlen); the main path (every count set to 0): a
     causal prefill of 8192 rows through sp_ag_attention, ring_attention
     and UlyssesAttn(4096, 32, 8, 128), a packed varlen batch of 8192 rows
     (lengths drawn from 64-1500, some across shard boundaries, a trailing
     pad) through flash_attention_varlen, ring_attention_varlen and
     sp_ag_attention(cu_seqlens=), a decode step of SpFlashDecodeAttention
     over 4 x 2048 positions under "xla" and "ll", the launches read back
     (varlen 1 + one a ring round, sp_ag one a call) and every output
     against the one-device golden within OUT_TOL and within SP_ROW_TOL of
     each row's RMS; each kernel's time against its bound, its plain
     version and the library yardstick;
 53. two planted faults in the fused kernel: a chunk read before it landed
     (the plain version on another draw's rows of that chunk), which the
     row check must refuse; then a lost signal: the check raises naming
     the rank, the chunk's kv rows and the source; the next call runs
     clean;
 54. one line of wall seconds per phase, one JSON line of per-kernel
     numbers, then the device JSON line.
Steps 14-16, 31-32, 48, 35-36, 39-40, 50-51 and 52-53 run with the other
kernel checks, before step 4, steps 33, 37 and 41 after step 16 and step 34 right
after step 5; steps 42-43 and 47 right after step 9; steps 29, 19-20, 22-23,
25-26 and 44-46 run after step 10, steps 30 and 21 after step 13 and step
27 after step 21; steps 17, 18, 24, 28, 38 and 49 run last.
Without a GPU it exits non-zero before printing anything.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_8BIT_OPS = 1979e12    # H100 SXM dense int8 / fp8 tensor-core rate
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 rate
OUT_TOL = 2e-2             # bf16 outputs: p and out rounded at other points
MK_F32_TOL = 1e-4          # megakernel f32, of max |ref|: summation order
MK_BF16_TOL = 5e-2         # megakernel bf16 x 36 layers, of max |ref|: a
                           # bf16 rounding step in one layer carries on
MK_BF16_2L_TOL = 2e-2      # megakernel bf16 x 2 layers, of max |ref|: one-
                           # ulp flips of a bf16 rounding (as the 2-layer
                           # GPU tests, tests/test_torch_cuda.py MK_TOL)
LSE_TOL = 1e-3             # f32 lse from f32 scores: summation order, exp2
GMM_TOL = 2e-2             # gmm bf16, of max |plain|: the same f32 sums in
                           # other orders, each rounded once to bf16
COLD_COPIES = 4            # input copies rotated so each launch finds L2 cold
TP_TOL = {torch.bfloat16: 2e-2,    # tensor-parallel kernels vs plain, of the
          torch.float32: 1e-5}     # largest value: the same f32 sums in other
                                   # orders, rounded at the same points
TP_LOGIT_TOL = 5e-2                # tp-engine vs one-rank engine, of the
                                   # largest logit: bf16 partials of n ranks
                                   # rounded and summed over 36 layers
TP_RANKS = 4                       # the tp-engine cell
EP_RANKS = 4                       # the ep-engine cell


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


def bound(nbytes, flops, peak=PEAK_BF16_FLOPS):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _to_device(params, dev):
    return {"embed": params["embed"].to(dev), "norm": params["norm"].to(dev),
            "lm_head": params["lm_head"].to(dev),
            "layers": {k: t.to(dev) for k, t in params["layers"].items()}}


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
    gparams = _to_device(params, "cuda")
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


def _paged_table(rng, counts, nb, mb):
    """(B, mb) int32 table: each slot's pages drawn from a shuffled
    pool, -1 past its end, and slot 2's first page shared with slot 0."""
    perm = rng.permutation(nb)
    table = np.full((len(counts), mb), -1, np.int32)
    at = 0
    for b, n in enumerate(counts):
        table[b, :n] = perm[at:at + n]
        at += n
    table[2, 0] = table[0, 0]
    return table


def distinct_rows(table, kv_len, blk):
    """Rows of K (or V) the slots' kv_len reach through the table,
    counting a page that slots share once: for each page id, the most
    rows any slot reads there (a -1 inside kv_len reads page 0)."""
    most = {}
    for b, n in enumerate(kv_len):
        for j in range(-(-n // blk)):
            page = max(int(table[b, j]), 0)
            most[page] = max(most.get(page, 0), min(blk, n - j * blk))
    return sum(most.values())


def check_flash_decode_paged(attn, dev, gen):
    """The paged decode kernel, one entry per arm, at the serving shape:
    kv_len [130, 700, 1500, 0] and a set that ends mid-page, on a
    shuffled table with a shared page and -1 holes past each end.
    Times use kv_len [130, 700, 1500, 0]; flash_decode's time on the
    same rows laid out contiguously is printed beside it."""
    from triton_distributed_tpu_torch.models.paged_kv_cache import quant_kv
    B, H, Hkv, D, blk, nb, mb = 4, 32, 8, 128, 128, 64, 16
    rng = np.random.RandomState(1)
    tab = _paged_table(rng, [2, 7, 12, 1], nb, mb)
    table = torch.from_numpy(tab).to(dev)
    q_sets = [torch.randn((B, H, D), generator=gen, device=dev).bfloat16()
              for _ in range(COLD_COPIES)]
    raw = [tuple(torch.randn((nb, Hkv, blk, D), generator=gen, device=dev)
                 for _ in range(2)) for _ in range(COLD_COPIES)]
    rows_lens = [130, 700, 1500, 0]
    entries = []
    for arm, wire in (("bfloat16", None), ("int8", "int8"),
                      ("float8_e4m3fn", "float8_e4m3fn")):
        sets = []
        for q, (k, v) in zip(q_sets, raw):
            if wire is None:
                sets.append((q, k.bfloat16(), v.bfloat16(), {}))
            else:
                (kq, ks), (vq, vs) = quant_kv(k, wire), quant_kv(v, wire)
                sets.append((q, kq, vq, {"k_scales": ks, "v_scales": vs}))
        q, k, v, kw = sets[0]
        kernel = attn.FLASH_DECODE_PAGED[arm]
        before = kernel.launches
        err = 0.0
        for lens in (rows_lens, [200, 777, 1333, 50]):
            kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
            out, lse = attn.flash_decode_paged_partial(q, k, v, table,
                                                       kv_len, **kw)
            ref, ref_lse = attn._flash_decode_paged_plain(
                q, k, v, table, kv_len, scale=D ** -0.5, **kw)
            e = (out.float() - ref.float()).abs().max().item()
            live = kv_len > 0
            le = (lse[live] - ref_lse[live]).abs().max().item()
            print(f"flash_decode_paged[{arm}] kv_len {lens}: max_abs_err "
                  f"{e:.3e}, lse {le:.3e}")
            assert e <= OUT_TOL and le <= LSE_TOL, (arm, e, le)
            assert torch.all(out[~live] == 0)
            err = max(err, e)
        assert kernel.launches == before + 2, (arm, kernel.launches)
        kv_len = torch.tensor(rows_lens, dtype=torch.int32, device=dev)
        ms = time_ms([lambda s=s: attn.flash_decode_paged_partial(
            s[0], s[1], s[2], table, kv_len, **s[3]) for s in sets])
        plain_ms = time_ms([lambda s=s: attn._flash_decode_paged_plain(
            s[0], s[1], s[2], table, kv_len, scale=D ** -0.5, **s[3])
            for s in sets], reps=5)
        per_row = Hkv * D * k.element_size() + (Hkv * 4 if wire else 0)
        moved = (2 * distinct_rows(tab, rows_lens, blk) * per_row
                 + nbytes(q, table, kv_len) + B * H * D * 2 + B * H * 4)
        bms, by = bound(moved, 4 * sum(rows_lens) * H * D,
                        PEAK_8BIT_OPS if wire else PEAK_BF16_FLOPS)
        print(f"flash_decode_paged[{arm}]: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bms:.4f} ms ({by}), no library "
              f"call reads pages through a table")
        entries.append({
            "name": f"flash_decode_paged[{arm}]", "route": "cuda",
            "source": "triton_distributed_tpu_torch/csrc/flash_decode_paged.cu",
            "replaces": ("triton_distributed_tpu/ops/attention.py:685"
                         if wire is None else
                         "triton_distributed_tpu/ops/attention.py:715"),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None})
    # the same rows, contiguous, through flash_decode (a comparison line)
    smax = mb * blk
    pages = table.clamp_min(0).long()
    cont = [tuple(t.bfloat16()[pages].permute(0, 1, 3, 2, 4).reshape(
        B, smax, Hkv, D).contiguous() for t in kv) for kv in raw]
    ms_c = time_ms([lambda q=q, c=c: attn.flash_decode_partial(
        q, c[0], c[1], kv_len) for q, c in zip(q_sets, cont)])
    print(f"flash_decode on the same rows, contiguous (B, {smax}, {Hkv}, "
          f"{D}): {ms_c:.4f} ms")
    return entries


def _spy_logits(model, params):
    """Wrap `model._next_token` to keep the f32 logits of every call."""
    seen = []
    real = model._next_token

    def spy(x, p, generator, **kw):
        seen.append((x.float() @ p["lm_head"].float()).cpu())
        return real(x, p, generator, **kw)

    model._next_token = spy
    return seen


def _agree(name, ref, got):
    """Logits within 5e-2 of the largest; greedy tokens equal wherever
    the CPU's top-2 gap exceeds twice the error."""
    assert torch.isfinite(got).all(), name
    diff = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"{name} logits GPU vs CPU: max_abs_err {diff:.3e} (max |logit| "
          f"{scale:.3e})")
    assert diff <= 5e-2 * max(1.0, scale), (name, diff)
    top2 = ref.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 2 * diff
    assert torch.equal(got.argmax(-1)[sure], ref.argmax(-1)[sure]), name


def check_small_model_paged(models, seed):
    """The paged steps of a small Qwen3-shaped model on the GPU (kernels)
    against the CPU (plain versions), bf16 and int8 pools: a second
    prefill chunk (prefix partial + in-chunk partial, merged), then a
    decode step from the same pool contents on both devices."""
    cfg = models.get_config("Qwen/Qwen3-8B").tiny(
        hidden_size=256, num_heads=8, num_kv_heads=2, head_dim=128,
        intermediate_size=512, vocab_size=512, num_layers=2)
    cpu = models.DenseLLM(cfg, dtype="bfloat16", device="cpu")
    params = cpu.init_params(torch.Generator().manual_seed(seed))
    gpu = models.DenseLLM(cfg, dtype="bfloat16", device="cuda")
    gparams = _to_device(params, "cuda")
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, 200),
               rng.randint(0, cfg.vocab_size, 70)]
    C = 128
    for kv in (None, "int8"):
        runs = []
        for m, p in ((cpu, params), (gpu, gparams)):
            seen = _spy_logits(m, p)
            cache = m.new_paged_kv_cache(2, 512, block=128, kv_dtype=kv)
            assert cache.assign_slot(0, 2) and cache.assign_slot(1, 1)
            for slot, ids in enumerate(prompts):
                for off in range(0, len(ids), C):
                    chunk = np.zeros(C, np.int32)
                    part = ids[off:off + C]
                    chunk[:len(part)] = part
                    tok, cache = m.prefill_chunk_paged(p, chunk, cache, slot,
                                                       off, len(part))
            runs.append((m, p, seen, cache))
        (_, _, cseen, ccache), (gm, gp, gseen, gcache) = runs
        _agree(f"small model prefill chunk over a prefix ({kv or 'bf16'} "
               f"pool)", cseen[1], gseen[1])
        # decode from the same pool contents on both devices
        names = ["k_pool", "v_pool"] + (["k_scales", "v_scales"] if kv else [])
        for n in names:
            getattr(gcache, n).copy_(getattr(ccache, n))
        toks = [int(cseen[1].argmax()), int(cseen[2].argmax())]
        for m, p, cache in ((cpu, params, ccache), (gm, gp, gcache)):
            m.decode_step_paged(p, toks, cache, [True, True])
        _agree(f"small model paged decode step ({kv or 'bf16'} pool)",
               cseen[3], gseen[3])
        for m in (cpu, gpu):
            del m._next_token


def serve_stream(rng, vocab):
    """8 requests, prompts 64-1500 tokens, gen 16-64: request 6 shares
    request 0's 512-token prefix and request 7 repeats request 1's
    block-aligned 256-token prompt; both are admitted after the request
    they reuse has finished, while its blocks are cached (the stream
    needs 42 of the pool's 64 blocks, so nothing is reclaimed)."""
    def ids(n):
        return rng.randint(0, vocab, n).astype(np.int32)

    pre, b = ids(512), ids(256)
    return [(np.concatenate([pre, ids(100)]), 16), (b, 16), (ids(1500), 64),
            (ids(64), 32), (ids(900), 48), (ids(300), 24),
            (np.concatenate([pre, ids(200)]), 40), (b.copy(), 20)]


def run_serve(models, attn, engine, stream, L, gg, extra=None,
              extra_want=None):
    """One ServeEngine run of the stream with the launch counts set to 0
    just before it; returns (tokens by rid, stats, launches, decode tick
    ms list, aten ops one decode tick dispatched). The sixth decode tick
    is counted, not timed. A MoE model launches two grouped GEMMs per
    layer per prefill chunk and per decode step, a dense one none; a
    megakernel tick launches the megakernel once and nothing else.
    `extra` names more kernels to count and `extra_want(stats)` gives the
    counts expected of them and of any kernel whose count it overrides
    (the multi-rank cells)."""
    from triton_distributed_tpu_torch.megakernel import executor_cuda as mkx
    for rid_ids, gen_len in stream:
        engine.submit(rid_ids, gen_len)
    tick_ms, tick_ops = [], []
    real = engine._decode_tick

    def timed(stream_cb):
        steps = engine.stats()["decode_steps"]
        if len(tick_ms) == 5 and not tick_ops:
            with OpCount() as ops:
                real(stream_cb)
            if engine.stats()["decode_steps"] > steps:
                tick_ops.append(ops.n)
            return
        t0 = time.perf_counter()
        real(stream_cb)
        if engine.stats()["decode_steps"] > steps:
            tick_ms.append((time.perf_counter() - t0) * 1e3)

    engine._decode_tick = timed
    kernels = {"flash_attention": attn.FLASH_ATTENTION,
               "flash_decode": attn.FLASH_DECODE}
    kernels.update({f"flash_decode_paged[{a}]": k
                    for a, k in attn.FLASH_DECODE_PAGED.items()})
    kernels["gmm"] = gg.GMM
    kernels["megakernel"] = mkx.MEGAKERNEL
    kernels.update(extra or {})
    for k in kernels.values():
        k.launches = 0
    out = engine.run()
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in kernels.items()}
    del engine._decode_tick
    st = engine.stats()
    arm = engine.kv_dtype or "bfloat16"
    want = {n: 0 for n in kernels}
    want["flash_attention"] = L * (st["prefill_chunks"] + st["prefix_chunks"])
    # one megakernel launch per megakernel decode tick, the paged decode
    # kernel once per layer on the others
    want["megakernel"] = st["megakernel_steps"]
    want[f"flash_decode_paged[{arm}]"] = L * (st["decode_steps"]
                                             - st["megakernel_steps"])
    if engine.model.config.is_moe:
        # two per layer per engine-path prefill chunk and decode step; a
        # megakernel decode tick launches none
        want["gmm"] = 2 * L * (st["prefill_chunks"] + st["decode_steps"]
                               - st["megakernel_steps"])
    if extra_want is not None:
        want.update(extra_want(st))
    assert launches == want, (launches, want)
    return out, st, launches, tick_ms, tick_ops[0]


def profile_serve(models, model, params, vocab, seed, mode="engine"):
    """Device-busy time of a short ServeEngine run (4 requests) from a
    torch.profiler trace, against the wall time of the same run made
    without the profiler (as profile_decode does)."""
    from torch.profiler import ProfilerActivity, profile

    def engine():
        rng = np.random.RandomState(seed + 1)
        se = models.ServeEngine(model, params, b_max=4, max_len=2048,
                                block=128, prefill_chunk=256, num_blocks=64,
                                mode=mode)
        for n, g in ((300, 8), (100, 8), (700, 8), (64, 8)):
            se.submit(rng.randint(0, vocab, n).astype(np.int32), g)
        return se

    se = engine()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    se.run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    se = engine()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        se.run()
        torch.cuda.synchronize()
    rows = sorted(((getattr(e, "self_device_time_total", 0) / 1e3, e.key,
                    e.count) for e in prof.key_averages()), reverse=True)
    busy = sum(r[0] for r in rows if r[0] > 0)
    st = se.stats()
    print(f"profile serve[{mode}]: {st['ticks']} ticks, "
          f"{st['decode_steps']} decode "
          f"steps, {st['prefill_chunks']} chunks: device-busy {busy:.1f} ms "
          f"of {wall:.1f} ms wall (unprofiled run): idle share "
          f"{1 - busy / wall:.3f}")
    for ms, name, count in rows[:8]:
        print(f"profile serve[{mode}]:   {ms:9.3f} ms  {count:6d}  "
              f"{name[:70]}")


def check_serve(models, attn, gg, model, params, cfg, seed, smi, profile):
    """The slice-2 main path at full width: ServeEngine over Qwen3-8B,
    bf16 pool checked in full, then int8 and fp8 pools."""
    L = cfg.num_layers
    rng = np.random.RandomState(seed)
    stream = serve_stream(rng, cfg.vocab_size)
    total = {}
    results = {}
    for kv in (None, None, "int8", "float8_e4m3fn"):
        se = models.ServeEngine(model, params, b_max=4, max_len=2048,
                                block=128, prefill_chunk=256, num_blocks=64,
                                kv_dtype=kv)
        out, st, launches, tick_ms, ops = run_serve(models, attn, se, stream,
                                                    L, gg)
        pool_gib = se._cache.block_nbytes() * 64 / 2**30
        for n, c in launches.items():
            total[n] = total.get(n, 0) + c
        name = kv or "bf16"
        print(f"serve[{name}]: {st['tokens']} tokens in {st['wall_s']:.3f} s "
              f"({st['tokens_per_s']} tokens/s), {st['ticks']} ticks, "
              f"{st['decode_steps']} decode steps at "
              f"{statistics.median(tick_ms):.2f} ms median "
              f"({min(tick_ms):.2f}-{max(tick_ms):.2f}; {ops} aten ops "
              f"on the host, {ops / L:.1f} per layer), "
              f"{st['prefill_chunks']} chunks ({st['prefix_chunks']} over a "
              f"cached prefix), prefix hits {st['prefix_hit_blocks']} blocks, "
              f"CoW {st['cow_copies']}, launches "
              f"{ {n: c for n, c in launches.items() if c} }"
              + f", pool {pool_gib:.3f} GiB | {smi}")
        assert sorted(out) == list(range(len(stream)))
        for rid, (_, gen_len) in enumerate(stream):
            toks = out[rid]
            assert len(toks) == gen_len, (rid, len(toks))
            assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
        cache = se._cache
        cache.check_conservation(cached=st["cached_free_blocks"])
        assert st["free_blocks"] + st["cached_free_blocks"] == 64, st
        if kv is None and None not in results:
            assert st["prefix_hit_blocks"] > 0 and st["cow_copies"] > 0, st
            results[None] = out
        elif kv is None:
            for rid in out:
                assert np.array_equal(out[rid], results[None][rid]), rid
            print("serve[bf16]: a second run gives identical tokens")
        else:
            results[kv] = out
            rep = models.serve.banded_token_identity(results[None], out,
                                                     band=1.0)
            print(f"serve[{name}] vs bf16 (information only, random "
                  f"weights): agreed {rep['agreed_steps']}/"
                  f"{rep['total_steps']} steps ({rep['agreed_frac']}; "
                  f"TOKEN_BAND floor {1 - models.serve.TOKEN_BAND[kv]})")
    if profile:
        profile_serve(models, model, params, cfg.vocab_size, seed)
    return total, results[None]


def profile_steps(name, step, steps, step_ms):
    """Device-busy ms per step of `steps` calls of `step()` from a
    profiler trace, against the step's wall time measured without the
    profiler (`step_ms`). Returns the busy ms."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    rows = [(getattr(e, "self_device_time_total", 0) / 1e3 / steps, e.key,
             e.count // steps) for e in prof.key_averages()]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"profile{name}: decode step device-busy {busy:.3f} ms of "
          f"{step_ms:.3f} ms wall: idle share {1 - busy / step_ms:.3f}")
    for ms, key, count in rows[:8]:
        print(f"profile{name}:   {ms:8.3f} ms/step  {count:5d}/step  "
              f"{key[:70]}")
    return busy


def profile_decode(engine, tok, cache, step_ms, steps=3):
    """Device-busy time of an Engine decode step (profile_steps)."""
    state = [tok, cache]

    def step():
        state[0], state[1] = engine.step(state[0], state[1])

    return profile_steps("", step, steps, step_ms)


def _mk_kernel_vs_plain(prog, x, cache_len, start=None):
    """One step of a megakernel program through the kernel, then through
    its plain queue walk, each from its own copy of the caches (`start`,
    or the bound ones, which are bound again afterwards). Returns
    ((kernel out, plain out), (kernel rows, plain rows)) with the
    appended rows [cache_len, +S) of every cache, in prog.caches order."""
    S = x.shape[0]
    bound = prog.caches
    start = bound if start is None else start
    outs, rows = [], []
    for plain in (False, True):
        prog.bind_caches({n: t.clone() for n, t in start.items()})
        out = prog.step({"x": x}, cache_len, plain=plain)[0]
        torch.cuda.synchronize()
        prog.check_fault()
        outs.append(out.float().clone())
        rows.append(torch.cat([c[cache_len:cache_len + S].float()
                               for c in prog.caches.values()]))
    if bound:
        prog.bind_caches(bound)
    return outs, rows


def _rel_err(a, b):
    return (a - b).abs().max().item() / b.abs().max().item()


def _device_io(mb, dev, seed, ranks=None):
    """Random f32 inputs and weights on the device for a built graph:
    x ~ N(0, 1), caches ~ N(0, 0.25), norm weights 1 + |N(0, 0.04)|,
    dense weights N(0, 1 / rows) so that activations keep their scale
    at any width; with `ranks`, rank-stacked operands of an n-rank
    program: x and the norm weights one draw every rank holds alike, the
    caches and dense weights (the shards) drawn for each rank."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(h, scale, shared=False):
        one = ranks is None or shared
        t = torch.randn(h.shape if one else (ranks, *h.shape), generator=gen,
                        device=dev) * scale
        return t.expand(ranks, *h.shape) if ranks and shared else t

    g = mb.graph
    ins = {n: draw(h, 1.0, True) if n == "x" else draw(h, 0.5)
           for n, h in g.inputs.items()}
    ws = {n: draw(h, 0.2, True).abs() + 1.0 if "ln" in n or "norm" in n
          else draw(h, h.rows ** -0.5) for n, h in g.weights.items()}
    return ins, ws


def check_megakernel_graphs(dev):
    """2-layer decode graphs, the kernel against its plain walk on the
    card: in f32 (MK_F32_TOL) at hidden 256 (head_dim 128, G 4), one
    decode row at cache_len 37 and a 24-row chunk at cache_len 13; in
    f32 and in bf16 (MK_BF16_2L_TOL) at Qwen3-8B widths (hidden 4096,
    32/8 heads, head_dim 128, intermediate 12288, max_cache 1024), the
    main path's two programs, one decode row and a 256-row chunk, at
    cache_len 500."""
    from triton_distributed_tpu_torch.megakernel.models import (
        build_qwen3_decode)
    small = dict(hidden=256, intermediate=512, num_heads=8, num_kv_heads=2,
                 max_cache=128)
    wide = dict(hidden=4096, intermediate=12288, num_heads=32,
                num_kv_heads=8, max_cache=1024, rope_theta=1e6)
    f32, bf16 = torch.float32, torch.bfloat16
    tol = {f32: MK_F32_TOL, bf16: MK_BF16_2L_TOL}
    for S, cl, dims, dt in ((1, 37, small, f32), (24, 13, small, f32),
                            (1, 500, wide, f32), (256, 500, wide, f32),
                            (1, 500, wide, bf16), (256, 500, wide, bf16)):
        mb = build_qwen3_decode(seq_len=S, num_layers=2, head_dim=128,
                                qk_norm=True, kv_append=True, dtype=dt,
                                **dims)
        ins, ws = ({n: t.to(dt) for n, t in d.items()}
                   for d in _device_io(mb, dev, S))
        prog = mb.compile("kernel", device=dev)
        prog.bind_weights(ws)
        start = {n: ins[n] for n in mb.graph.caches}
        (ko, po), (kr, pr) = _mk_kernel_vs_plain(prog, ins["x"], cl, start)
        e, er = _rel_err(ko, po), _rel_err(kr, pr)
        print(f"megakernel {str(dt)[6:]} 2 layers, hidden {dims['hidden']} "
              f"S={S} cache_len {cl}: out {e:.3e}, appended rows {er:.3e} "
              f"of max |plain|")
        assert e <= tol[dt] and er <= tol[dt], (dt, S, e, er)
        del prog, ins, ws, start
        torch.cuda.empty_cache()


def check_megadecoder_small(models, seed):
    """A small Qwen3-shaped model's MegaDecoder in f32 on the GPU (the
    kernel) against the same weights on the CPU (the plain walk): a
    37-token prompt in 16-row chunks (11 pad rows), 8 greedy tokens."""
    from triton_distributed_tpu_torch.megakernel import MegaDecoder
    cfg = models.get_config("Qwen/Qwen3-8B").tiny(
        hidden_size=256, num_heads=8, num_kv_heads=2, head_dim=128,
        intermediate_size=512, vocab_size=512, num_layers=2)
    cpu = models.DenseLLM(cfg, dtype="float32", device="cpu")
    params = cpu.init_params(torch.Generator().manual_seed(seed))
    gpu = models.DenseLLM(cfg, dtype="float32", device="cuda")
    gparams = _to_device(params, "cuda")
    prompt = np.random.RandomState(seed).randint(0, cfg.vocab_size, 37)
    toks = [MegaDecoder.from_dense(m, p, max_cache=64, prompt_len=37,
                                   prefill_chunk=16, device=d).serve(prompt, 8)
            for m, p, d in ((cpu, params, "cpu"), (gpu, gparams, "cuda"))]
    print(f"small MegaDecoder f32 GPU (kernel) vs CPU (plain walk): "
          f"{toks[1].tolist()} vs {toks[0].tolist()}")
    assert np.array_equal(toks[0], toks[1])


def check_megadecoder(attn, model, params, cfg, prompt, engine_toks, smi,
                      profile):
    """The slice-3 main path: MegaDecoder over the engine cell's weights
    and its first prompt. Returns (decoder, tokens, launches)."""
    from triton_distributed_tpu_torch.megakernel import MegaDecoder
    from triton_distributed_tpu_torch.megakernel import executor_cuda as mkx
    P, GEN = len(prompt), engine_toks.shape[0]
    md = MegaDecoder.from_dense(model, params, max_cache=1024, prompt_len=P)
    others = [attn.FLASH_ATTENTION, attn.FLASH_DECODE,
              *attn.FLASH_DECODE_PAGED.values()]
    for k in [mkx.MEGAKERNEL, *others]:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = md.serve(prompt, GEN)
    first_s = time.perf_counter() - t0
    launches = mkx.MEGAKERNEL.launches
    print(f"megadecoder: {toks.shape[0]} tokens, {first_s * 1e3:.1f} ms "
          f"(first call), megakernel launches {launches} "
          f"({md._n_prefill_chunks} prefill chunks + {GEN - 1} decode steps)")
    assert toks.shape == (GEN,) and toks.dtype == np.int32
    assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
    assert launches == md._n_prefill_chunks + GEN - 1 == 2 + 31, launches
    assert all(k.launches == 0 for k in others), [k.launches for k in others]
    again = md.serve(prompt, GEN)
    assert np.array_equal(again, toks), "a second serve gave other tokens"
    print("megadecoder: a second serve gives identical tokens")
    # timing: prefill alone (serve of one token), then the whole serve
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    md.serve(prompt, 1)
    t1 = time.perf_counter()
    md.serve(prompt, GEN)
    t2 = time.perf_counter()
    prefill_ms = (t1 - t0) * 1e3
    step_ms = ((t2 - t1) - (t1 - t0)) / (GEN - 1) * 1e3
    print(f"megadecoder prefill ms {prefill_ms:.2f} (S={P}, 2 chunks of "
          f"256) | decode {step_ms:.3f} ms/step, tokens/s "
          f"{1e3 / step_ms:.1f} (batch 1, {GEN - 1} steps) | {smi}")
    tok = torch.as_tensor(toks[-1:], device=model.device)
    with OpCount() as ops:
        h, _ = md._decode_hidden(tok, P + GEN - 1, None)
        md._pick(h, None, 1.0, sampling=False, top_k=1)
    torch.cuda.synchronize()
    print(f"megadecoder decode step: {ops.n} aten ops dispatched on the "
          f"host and 1 megakernel launch")
    # against the engine: the first token, then teacher forcing
    ref_first = int(engine_toks[0])
    print(f"megadecoder first token {int(toks[0])}, Engine.serve's "
          f"{ref_first}; greedy agreement over {GEN} tokens (information "
          f"only, random weights): "
          f"{int((toks == engine_toks).sum())}/{GEN}")
    assert int(toks[0]) == ref_first
    forced = md.teacher_forced(prompt, engine_toks[:-1])
    eng = []
    last, cache = model._prefill_hidden(params, prompt[None],
                                        model.new_kv_cache(1, 1024))
    eng.append(last.float())
    for t in engine_toks[:-1]:
        x, cache = model._decode_hidden(
            params, torch.tensor([int(t)], device=model.device), cache)
        eng.append(x.float())
    eng = torch.cat(eng)
    errs = [_rel_err(forced[i], eng[i]) for i in range(GEN)]
    print(f"megadecoder teacher-forced hidden rows vs the engine's: max "
          f"{max(errs):.3e} of max |engine row| (steps 0..{GEN - 1}: "
          f"{' '.join(f'{e:.2e}' for e in errs)})")
    assert max(errs) <= MK_BF16_TOL, errs
    if profile:
        state = [tok]

        def step():
            h, _ = md._decode_hidden(state[0], P + GEN - 1, None)
            state[0] = md._pick(h, None, 1.0, sampling=False, top_k=1)

        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(8):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 8 * 1e3
        profile_steps(" megadecoder", step, 8, wall)
    return md, toks, launches


def megakernel_breakdown(prog, ms, cl):
    """Where a decode step's time goes, from launches of the same kernel:
    the step at cache_len 0 (the attention over the prefix is the
    difference), one graph per projection shape on the model's own
    weight views (torch.mm beside it as a yardstick), and the latency of
    a dependent single-tile stage (a chain of 72 adds less one add)."""
    from triton_distributed_tpu_torch.megakernel.builder import ModelBuilder
    x = prog.inputs["x"].clone()
    ms0 = time_ms([lambda: prog.step({"x": x}, 0)])
    # host time of a step call while earlier launches are still running:
    # near the kernel's time if a cooperative launch waits for them
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        prog.step({"x": x}, cl)
    host_ms = (time.perf_counter() - t0) / 10 * 1e3
    torch.cuda.synchronize()
    print(f"megakernel breakdown: host ms per step call, 10 calls without "
          f"a sync: {host_ms:.3f}")
    print(f"megakernel breakdown: step at cache_len 0 {ms0:.4f} ms, so the "
          f"attention over {cl} cached rows costs ~{ms - ms0:.4f} ms")
    dt, dev = prog.dtype, prog.device
    line = []
    for name in ("w_qkv", "w_o", "w_gate", "w_down"):
        w = prog.weights[f"l0.{name}"]
        K, N = w.shape
        mb = ModelBuilder(dtype=dt)
        mb.output(mb.linear(mb.input("x", (1, K)), mb.weight("w", (K, N))))
        p = mb.compile("kernel", device=dev)
        p.bind_weights({"w": w})
        xx = torch.randn((1, K), device=dev).to(dt)
        us = time_ms([lambda: p.step({"x": xx}, 0)], reps=50) * 1e3
        mm = time_ms([lambda: torch.mm(xx, w)], reps=50) * 1e3
        p.check_fault()
        line.append(f"{name} {K}x{N} {us:.1f} us ({K * N * 2 / us / 1e6:.2f} "
                    f"TB/s; torch.mm {mm:.1f} us)")
    print("megakernel breakdown: one linear per launch: " + "; ".join(line))
    us = []
    for n in (1, 73):
        mb = ModelBuilder(dtype=dt)
        h0 = h = mb.input("x", (1, 4096))
        for _ in range(n):
            h = mb.add(h, h0)
        mb.output(h)
        p = mb.compile("kernel", device=dev)
        p.bind_weights({})
        xx = torch.randn((1, 4096), device=dev).to(dt)
        us.append(time_ms([lambda: p.step({"x": xx}, 0)], reps=50) * 1e3)
        p.check_fault()
    print(f"megakernel breakdown: a launch of one add task {us[0]:.2f} us; "
          f"each further dependent single-tile stage {(us[1] - us[0]) / 72:.2f}"
          f" us")


def _mk_golden(md, cfg, x, cl):
    """The golden executor on a fresh build of the decoder's program of
    x.shape[0] rows, from its bound caches and weights at cache_len
    `cl`: (output, the appended rows of every cache in prog.caches
    order)."""
    from triton_distributed_tpu_torch.megakernel.models import (
        build_qwen3_decode)
    S = x.shape[0]
    prog = md._prog_decode if S == 1 else md._prog_prefill
    mb = build_qwen3_decode(
        seq_len=S, hidden=cfg.hidden_size,
        intermediate=cfg.intermediate_size, num_layers=cfg.num_layers,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, max_cache=md.cfg["max_cache"],
        rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
        rms_eps=cfg.rms_norm_eps, kv_append=True, dtype=md.dtype)
    g = mb.graph
    kv = [nd for nd in g.nodes if nd.op == "kv_append"]
    g.outputs.extend(nd.out for nd in kv)
    names = {h.idx: n for n, h in g.caches.items()}
    gold = mb.compile("graph").run({"x": x, **prog.caches}, prog.weights,
                                   {"cache_len": cl})
    new = {names[nd.inputs[1].idx]: c for nd, c in zip(kv, gold[1:])}
    return gold[0].float(), torch.cat([new[n][cl:cl + S].float()
                                       for n in prog.caches])


def check_megakernel_main(md, cfg, prompt, smi, profile):
    """The main path's two programs on the caches its serve filled, each
    from copies of them: the 256-row prefill chunk at cache_len 256 (the
    prompt's second chunk with its 12 pad rows) and the decode step at
    cache_len 500, through the kernel, its plain walk and the golden
    executor; then the decode step's times and bound."""
    P, C = len(prompt), md.prefill_chunk
    ids = torch.as_tensor(prompt, device=md.device)
    x_pre = md.embed[ids[C:]]
    x_pre = torch.cat([x_pre, x_pre.new_zeros((2 * C - P, x_pre.shape[1]))])
    gen = torch.Generator(device=md.device).manual_seed(5)
    x = md.embed[torch.randint(0, cfg.vocab_size, (1,), generator=gen,
                               device=md.device)]
    cl = P
    abs_err = 0.0
    for what, prog, xx, c0 in (("prefill chunk", md._prog_prefill, x_pre, C),
                               ("decode step", md._prog_decode, x, cl)):
        (ko, po), (kr, pr) = _mk_kernel_vs_plain(prog, xx, c0)
        go, gr = _mk_golden(md, cfg, xx, c0)
        err_p, rows_p = _rel_err(ko, po), _rel_err(kr, pr)
        err_g, rows_g = _rel_err(ko, go), _rel_err(kr, gr)
        ab = max((ko - po).abs().max().item(), (kr - pr).abs().max().item())
        abs_err = max(abs_err, ab)
        print(f"megakernel {str(md.dtype)[6:]} Qwen3-8B {what} "
              f"({xx.shape[0]} rows), cache_len {c0}: vs plain walk out "
              f"{err_p:.3e}, appended rows {rows_p:.3e}; vs golden out "
              f"{err_g:.3e}, appended rows {rows_g:.3e} (of max |ref|; max "
              f"abs vs plain {ab:.3e})")
        assert torch.isfinite(ko).all() and torch.isfinite(kr).all()
        assert max(err_p, rows_p, err_g, rows_g) <= MK_BF16_TOL, what
        del ko, po, kr, pr, go, gr
    prog = md._prog_decode
    ms = time_ms([lambda: prog.step({"x": x}, cl)])
    prog.check_fault()
    plain_ms = time_ms([lambda: prog.step({"x": x}, cl, plain=True)],
                       reps=1, rounds=1)
    costs = prog.task_costs(cl)
    moved = sum(c["bytes"] for c in costs)
    flops = sum(c["flops"] for c in costs)
    bms, by = bound(moved, flops)
    tiles = int(prog.n_tiles.sum())
    print(f"megakernel: kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, bound "
          f"{bms:.4f} ms ({by}: {moved / 1e9:.3f} GB, {flops / 1e9:.2f} "
          f"GFLOP), {len(prog.tasks)} tasks in {tiles} tiles on "
          f"{prog.n_sm} SMs; no single library call computes the step | "
          f"{smi}")
    if profile:
        megakernel_breakdown(prog, ms, cl)
    return {"name": "megakernel", "route": "cuda",
            "source": "triton_distributed_tpu_torch/csrc/megakernel.cu",
            "replaces": "triton_distributed_tpu/megakernel/executor_pallas.py:106",
            "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None}


def check_megakernel_fused_graphs(dev):
    """The fused decode arms (both fusion flags) on 2-layer decode graphs
    of one row: at hidden 256, cache_len 37, f32 and bf16, qk_norm on and
    off; at Qwen3-8B widths, cache_len 500, f32 and bf16. The fused kernel
    against its plain walk (MK_F32_TOL / MK_BF16_2L_TOL of the largest
    value) and against the unfused kernel bit for bit, outputs and
    appended rows, from the same caches. Returns the largest absolute
    difference from the plain walk."""
    from triton_distributed_tpu_torch.megakernel.models import (
        build_qwen3_decode)
    small = dict(hidden=256, intermediate=512, num_heads=8, num_kv_heads=2,
                 max_cache=128)
    wide = dict(hidden=4096, intermediate=12288, num_heads=32,
                num_kv_heads=8, max_cache=1024, rope_theta=1e6)
    f32, bf16 = torch.float32, torch.bfloat16
    tol = {f32: MK_F32_TOL, bf16: MK_BF16_2L_TOL}
    abs_err = 0.0
    for dims, cl, qk, dt in ((small, 37, True, f32), (small, 37, False, f32),
                             (small, 37, True, bf16), (small, 37, False, bf16),
                             (wide, 500, True, f32), (wide, 500, True, bf16)):
        mb = build_qwen3_decode(seq_len=1, num_layers=2, head_dim=128,
                                qk_norm=qk, kv_append=True, dtype=dt, **dims)
        ins, ws = ({n: t.to(dt) for n, t in d.items()}
                   for d in _device_io(mb, dev, 3))
        start = {n: ins[n] for n in mb.graph.caches}
        runs, tasks = {}, {}
        for fused in (False, True):
            prog = mb.compile("kernel", device=dev, fuse_elementwise=fused,
                              fuse_kv_append=fused)
            prog.bind_weights(ws)
            runs[fused] = _mk_kernel_vs_plain(prog, ins["x"], cl, start)
            tasks[fused] = len(prog.tasks)
            del prog
        (ko, po), (kr, pr) = runs[True]
        (uo, _), (ur, _) = runs[False]
        e, er = _rel_err(ko, po), _rel_err(kr, pr)
        abs_err = max(abs_err, (ko - po).abs().max().item(),
                      (kr - pr).abs().max().item())
        same = torch.equal(ko, uo) and torch.equal(kr, ur)
        print(f"megakernel fused {str(dt)[6:]} 2 layers, hidden "
              f"{dims['hidden']}, qk_norm {qk}, cache_len {cl}: "
              f"{tasks[True]} tasks (unfused {tasks[False]}); vs plain walk "
              f"out {e:.3e}, appended rows {er:.3e} of max |plain|; vs the "
              f"unfused kernel: {'bit for bit' if same else 'DIFFERENT'} "
              f"(max abs {(ko - uo).abs().max().item():.3e} out, "
              f"{(kr - ur).abs().max().item():.3e} rows)")
        assert tasks == {False: 27, True: 13}, tasks
        assert e <= tol[dt] and er <= tol[dt], (dt, qk, e, er)
        assert same, (dt, qk, dims["hidden"])
        del ins, ws, start, runs
        torch.cuda.empty_cache()
    return abs_err


def check_megadecoder_fused(attn, md, toks, model, params, cfg, prompt, smi):
    """The slice-3d main path: MegaDecoder.from_dense(..., fuse_elementwise=
    True, fuse_kv_append=True) over the megadecoder cell's weights (views:
    nothing copied) and prompt, 32 greedy tokens: exactly 2 + 31
    megakernel launches, 6 tasks a layer, the unfused decoder's tokens and
    teacher-forced hidden rows bit for bit; the decode step at cache_len
    500 from copies of the unfused decoder's caches against its plain walk
    and bit for bit against the unfused kernel; the fused, unfused,
    elementwise-only and append-only steps by CUDA events in turns, the
    fused step's bound, and the latency of a dependent stage. The fused
    decoder's caches are freed on return. Returns the kernels-line entry."""
    from triton_distributed_tpu_torch.megakernel import MegaDecoder
    from triton_distributed_tpu_torch.megakernel import executor_cuda as mkx
    P, GEN, L = len(prompt), toks.shape[0], cfg.num_layers
    mf = MegaDecoder.from_dense(model, params, max_cache=1024, prompt_len=P,
                                fuse_elementwise=True, fuse_kv_append=True)
    pu, pf = md._prog_decode, mf._prog_decode
    assert all(pf.weights[n].data_ptr() == pu.weights[n].data_ptr()
               for n in pu.weights)
    assert (len(pf.tasks), len(pu.tasks)) == (6 * L + 1, 13 * L + 1), \
        (len(pf.tasks), len(pu.tasks))
    assert mf._prog_prefill.fusion == {} and \
        len(mf._prog_prefill.tasks) == 13 * L + 1
    others = [attn.FLASH_ATTENTION, attn.FLASH_DECODE,
              *attn.FLASH_DECODE_PAGED.values()]
    for k in [mkx.MEGAKERNEL, *others]:
        k.launches = 0
    got = mf.serve(prompt, GEN)
    launches = mkx.MEGAKERNEL.launches
    print(f"megadecoder fused: {got.shape[0]} tokens, megakernel launches "
          f"{launches} ({mf._n_prefill_chunks} prefill chunks + {GEN - 1} "
          f"decode steps); decode program {len(pf.tasks)} tasks in "
          f"{int(pf.n_tiles.sum())} tiles (unfused {len(pu.tasks)} in "
          f"{int(pu.n_tiles.sum())}); greedy tokens equal to the unfused "
          f"decoder's: {int((got == toks).sum())}/{GEN}")
    assert launches == mf._n_prefill_chunks + GEN - 1 == 2 + 31, launches
    assert all(k.launches == 0 for k in others), [k.launches for k in others]
    # host-clock decode ms per step, as check_megadecoder times it
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mf.serve(prompt, 1)
    t1 = time.perf_counter()
    mf.serve(prompt, GEN)
    t2 = time.perf_counter()
    step_ms = ((t2 - t1) - (t1 - t0)) / (GEN - 1) * 1e3
    print(f"megadecoder fused prefill ms {(t1 - t0) * 1e3:.2f} | decode "
          f"{step_ms:.3f} ms/step, tokens/s {1e3 / step_ms:.1f} (batch 1, "
          f"{GEN - 1} steps) | {smi}")
    forced = [d.teacher_forced(prompt, toks[:-1]) for d in (md, mf)]
    logits = [f @ params["lm_head"].float() for f in forced]
    dlog = (logits[0] - logits[1]).abs().max().item()
    top2 = logits[0].topk(2, dim=-1).values
    print(f"megadecoder fused teacher-forced hidden rows vs unfused: "
          f"{'bit for bit' if torch.equal(*forced) else 'DIFFERENT'}; "
          f"largest logit difference {dlog:.3e}; smallest top-2 margin of "
          f"the unfused logits {(top2[:, 0] - top2[:, 1]).min().item():.3e}")
    assert np.array_equal(got, toks), (got, toks)
    assert torch.equal(*forced)
    # the decode step at cache_len 500, from copies of the unfused
    # decoder's caches (its serve and teacher forcing filled them)
    gen = torch.Generator(device=md.device).manual_seed(5)
    x = md.embed[torch.randint(0, cfg.vocab_size, (1,), generator=gen,
                               device=md.device)]
    cl, start = P, md._prog_decode.caches
    (ko, po), (kr, pr) = _mk_kernel_vs_plain(pf, x, cl, start)
    pu.bind_caches({n: t.clone() for n, t in start.items()})
    uo = pu.step({"x": x}, cl)[0].float()
    ur = torch.cat([c[cl:cl + 1].float() for c in pu.caches.values()])
    pu.bind_caches(start)
    torch.cuda.synchronize()
    pu.check_fault()
    abs_err = max((ko - po).abs().max().item(), (kr - pr).abs().max().item())
    same = torch.equal(ko, uo) and torch.equal(kr, ur)
    print(f"megakernel fused Qwen3-8B decode step, cache_len {cl}: vs plain "
          f"walk out {_rel_err(ko, po):.3e}, appended rows "
          f"{_rel_err(kr, pr):.3e} of max |plain| (max abs {abs_err:.3e}); "
          f"vs the unfused kernel {'bit for bit' if same else 'DIFFERENT'}")
    assert torch.isfinite(ko).all() and torch.isfinite(kr).all()
    assert max(_rel_err(ko, po), _rel_err(kr, pr)) <= MK_BF16_TOL
    assert same
    # the steps in turns (unfused, fused, fused, unfused), then each flag
    # alone, all on the same weights and the fused decoder's caches
    progs = {"unfused": pu, "fused": pf}
    for ew, kv in ((True, False), (False, True)):
        p = mf._mb_decode.compile("kernel", device=md.device,
                                  fuse_elementwise=ew, fuse_kv_append=kv)
        p.bind_weights(mf.weights)
        p.bind_caches(pf.caches)
        progs["elementwise only" if ew else "append only"] = p
    ms = {}
    for name in ("unfused", "fused", "fused", "unfused", "elementwise only",
                 "append only"):
        prog = progs[name]
        ms.setdefault(name, []).append(
            time_ms([lambda: prog.step({"x": x}, cl)]))
        prog.check_fault()
    plain_ms = time_ms([lambda: pf.step({"x": x}, cl, plain=True)], reps=1,
                       rounds=1)
    costs = pf.task_costs(cl)
    moved = sum(c["bytes"] for c in costs)
    flops = sum(c["flops"] for c in costs)
    bms, by = bound(moved, flops)
    ubms, _ = bound(sum(c["bytes"] for c in pu.task_costs(cl)),
                    sum(c["flops"] for c in pu.task_costs(cl)))
    stage_s = _stage_latency_s(md.device, md.dtype)
    # the dependent single-tile stages gone: RMS_NORM, SILU_MUL and ADD
    # (the appends waited only on the qkv LINEAR and ran beside ATTN)
    removed = sum(nd.op in ("rms_norm", "silu_mul", "add")
                  for nd in pf.fused_away)
    f_ms, u_ms = statistics.mean(ms["fused"]), statistics.mean(ms["unfused"])
    turns = {k: " / ".join(f"{t:.4f}" for t in v) for k, v in ms.items()}
    print(f"megakernel fused decode step {turns['fused']} ms, unfused "
          f"{turns['unfused']} ms (in turns), elementwise only {ms['elementwise only'][0]:.4f}, "
          f"append only {ms['append only'][0]:.4f}; plain walk "
          f"{plain_ms:.1f} ms; bound {bms:.4f} ms ({by}: {moved / 1e9:.3f} "
          f"GB, {flops / 1e9:.2f} GFLOP; unfused {ubms:.4f}); "
          f"{len(pu.tasks) - len(pf.tasks)} tasks fewer, of them {removed} "
          f"dependent stages x the stage latency "
          f"{stage_s * 1e6:.3f} us = {removed * stage_s * 1e3:.4f} ms "
          f"against {u_ms - f_ms:.4f} ms measured | {smi}")
    return {"name": "megakernel[fused]", "route": "cuda",
            "source": "triton_distributed_tpu_torch/csrc/megakernel.cu",
            "replaces": "triton_distributed_tpu/megakernel/"
                        "executor_pallas.py:2488, :2214",
            "launches": launches, "max_abs_err": abs_err, "ms": f_ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None}


def _slot_table(lens, blk, mp, num_blocks, seed):
    """A shuffled table for slots at `lens`: each slot's pages up to its
    append page drawn from a permutation of the shared pages, an idle
    slot (length 0) and every other column on the slot's own trash page
    (num_blocks + b)."""
    perm = iter(np.random.RandomState(seed).permutation(num_blocks))
    return np.asarray([[next(perm) if cl and c <= cl // blk
                        else num_blocks + b for c in range(mp)]
                       for b, cl in enumerate(lens)], np.int32)


def check_megakernel_paged_graphs(dev):
    """2-layer paged serve graphs at Qwen3-8B widths and the serve cell's
    pool (64 + 4 pages of 128 rows, 16 pages a slot): four slots, one
    idle (length 0 on its trash page), the others at 128 (a page
    boundary), 777 and 1500, on a shuffled table; the kernel against its
    plain walk, f32 (MK_F32_TOL) and bf16 (MK_BF16_2L_TOL), and in bf16
    against the golden executor too (its attention partials go through
    the bf16-only prefill kernel on the card), outputs and appended rows;
    every pool row outside the appends bitwise unchanged."""
    from triton_distributed_tpu_torch.megakernel.models import (
        build_qwen3_serve_batched)
    lens = np.asarray([0, 128, 777, 1500], np.int32)
    blk, mp, nbk = 128, 16, 64
    tbl = _slot_table(lens, blk, mp, nbk, 7)
    rows = torch.as_tensor(tbl[np.arange(4), lens // blk] * blk + lens % blk,
                           device=dev)
    scalars = {f"cache_len_s{b}": int(cl) for b, cl in enumerate(lens)}
    f32, bf16 = torch.float32, torch.bfloat16
    tol = {f32: MK_F32_TOL, bf16: MK_BF16_2L_TOL}
    for dt in (f32, bf16):
        mb = build_qwen3_serve_batched(
            b_slots=4, slot_rows=1, hidden=4096, intermediate=12288,
            num_layers=2, num_heads=32, num_kv_heads=8, head_dim=128,
            num_blocks=nbk, block=blk, max_pages=mp, rope_theta=1e6,
            qk_norm=True, dtype=dt)
        g = mb.graph
        kv = [nd for nd in g.nodes if nd.op == "kv_append_paged"]
        names = {h.idx: n for n, h in g.caches.items()}
        ins, ws = ({n: t.to(dt) for n, t in d.items()}
                   for d in _device_io(mb, dev, 11))
        start = {n: ins[n] for n in g.caches}
        prog = mb.compile("kernel", device=dev)
        prog.bind_weights(ws)
        got = []
        for plain in (False, True):
            prog.bind_caches({n: t.clone() for n, t in start.items()})
            out = prog.step({"x": ins["x"]}, cache_lens=lens,
                            block_table=tbl, plain=plain)[0]
            torch.cuda.synchronize()
            prog.check_fault()
            keep = torch.ones(start[names[kv[0].inputs[1].idx]].shape[0],
                              dtype=torch.bool, device=dev)
            keep[rows] = False
            for n, c in prog.caches.items():
                assert torch.equal(c[keep], start[n][keep]), (plain, n)
            got.append((out.float().clone(),
                        torch.cat([c[rows].float()
                                   for c in prog.caches.values()])))
        (ko, kr), (po, pr) = got
        errs = [_rel_err(ko, po), _rel_err(kr, pr)]
        line = ""
        if dt == bf16:
            g.outputs.extend(nd.out for nd in kv)
            gold = mb.compile("graph").run({"x": ins["x"], **start}, ws,
                                           scalars, block_table=tbl)
            new = {names[nd.inputs[1].idx]: c for nd, c in zip(kv, gold[1:])}
            errs += [_rel_err(ko, gold[0].float()),
                     _rel_err(kr, torch.cat([new[n][rows].float()
                                             for n in prog.caches]))]
            line = f"; vs golden {errs[2]:.3e} / {errs[3]:.3e}"
            del gold, new
        print(f"megakernel paged {str(dt)[6:]} 2 layers at Qwen3-8B widths, "
              f"lengths {lens.tolist()}: vs plain walk out {errs[0]:.3e}, "
              f"appended rows {errs[1]:.3e}{line} (of max |ref|); other "
              f"pool rows unchanged")
        assert torch.isfinite(ko).all() and max(errs) <= tol[dt], (dt, errs)
        del prog, ins, ws, start, got
        torch.cuda.empty_cache()


MOE_WIDTHS = dict(hidden=2048, moe_intermediate=768, num_experts=128,
                  top_k=8, num_heads=32, num_kv_heads=4, head_dim=128)


def _moe_weight_names(g, nd):
    """The weight names of a moe_ffn node's gate/up and down slabs."""
    by_idx = {h.idx: n for n, h in g.weights.items()}
    return by_idx[nd.inputs[2].idx], by_idx[nd.inputs[3].idx]


def check_megakernel_moe_graphs(dev):
    """2-layer MoE serve graphs at Qwen3-30B-A3B widths (hidden 2048, 128
    experts, top-8, intermediate 768, 32/4 heads, head_dim 128, qk-norm)
    on the serve cell's pool (64 + 4 pages of 128 rows, 16 pages a slot):
    four slots, one idle (length 0 on its trash page, width 0, x row 0),
    the others at 128, 777 and 1500 on a shuffled table. The kernel
    against its plain walk, f32 (MK_F32_TOL) and bf16 (MK_BF16_2L_TOL),
    and in bf16 against the golden executor too: the outputs, each
    layer's moe_ffn output and the appended rows; the idle slot's rows
    exactly 0; every pool row outside the appends bitwise unchanged.
    Then every expert slab that no live row routes to (each layer's, from
    the launch's router logits) is NaN: the outputs must be finite and
    bitwise the first launch's. Returns the bf16 step's numbers."""
    from triton_distributed_tpu_torch.megakernel.models import (
        build_qwen3_moe_serve_batched)
    lens = np.asarray([0, 128, 777, 1500], np.int32)
    widths = (lens > 0).astype(np.int32)
    blk, mp, nbk, E = 128, 16, 64, MOE_WIDTHS["num_experts"]
    H, inter = MOE_WIDTHS["hidden"], MOE_WIDTHS["moe_intermediate"]
    tbl = _slot_table(lens, blk, mp, nbk, 7)
    rows = torch.as_tensor(tbl[np.arange(4), lens // blk] * blk + lens % blk,
                           device=dev)
    scalars = {f"cache_len_s{b}": int(cl) for b, cl in enumerate(lens)}
    f32, bf16 = torch.float32, torch.bfloat16
    tol = {f32: MK_F32_TOL, bf16: MK_BF16_2L_TOL}
    for dt in (f32, bf16):
        mb = build_qwen3_moe_serve_batched(
            b_slots=4, slot_rows=1, num_layers=2, num_blocks=nbk, block=blk,
            max_pages=mp, rope_theta=1e6, qk_norm=True, dtype=dt,
            **MOE_WIDTHS)
        g = mb.graph
        moe = [nd for nd in g.nodes if nd.op == "moe_ffn"]
        kv = [nd for nd in g.nodes if nd.op == "kv_append_paged"]
        names = {h.idx: n for n, h in g.caches.items()}
        g.outputs.extend(nd.out for nd in moe)
        ins, ws = _device_io(mb, dev, 13)
        for n in ws:       # N(0, 1 / rows) of one expert's slab
            if "w_moe" in n:
                ws[n] *= E ** 0.5
        ins, ws = ({n: t.to(dt) for n, t in d.items()} for d in (ins, ws))
        ins["x"][0] = 0                   # the idle slot
        start = {n: ins[n] for n in g.caches}
        prog = mb.compile("kernel", device=dev)
        prog.bind_weights(ws)
        keep = torch.ones(start[names[kv[0].inputs[1].idx]].shape[0],
                          dtype=torch.bool, device=dev)
        keep[rows] = False

        def launch(plain=False):
            prog.bind_caches({n: t.clone() for n, t in start.items()})
            outs = prog.step({"x": ins["x"]}, cache_lens=lens,
                             block_table=tbl, widths=widths, plain=plain)
            torch.cuda.synchronize()
            prog.check_fault()
            for n, c in prog.caches.items():
                assert torch.equal(c[keep], start[n][keep]), (plain, n)
            return ([o.float().clone() for o in outs],
                    torch.cat([c[rows].float() for c in prog.caches.values()]))

        ko, kr = launch()
        routed = prog.routed_experts(widths)
        t0 = time.perf_counter()
        po, pr = launch(plain=True)
        plain_ms = (time.perf_counter() - t0) * 1e3
        assert all((o[0] == 0).all() for o in ko), "idle slot rows"
        errs = [max(_rel_err(a, b) for a, b in zip(ko, po)),
                _rel_err(kr, pr)]
        line = ""
        if dt == bf16:
            g.outputs.extend(nd.out for nd in kv)
            gold = mb.compile("graph").run({"x": ins["x"], **start}, ws,
                                           scalars, block_table=tbl)
            new = {names[nd.inputs[1].idx]: c
                   for nd, c in zip(kv, gold[len(ko):])}
            errs += [max(_rel_err(a, b.float()) for a, b in zip(ko, gold)),
                     _rel_err(kr, torch.cat([new[n][rows].float()
                                             for n in prog.caches]))]
            line = f"; vs golden {errs[2]:.3e} / {errs[3]:.3e}"
            del gold, new
        # the slabs no live row routes to, NaN: the kernel never reads them
        nan_ws, n_nan = dict(ws), 0
        for nd in moe:
            gu_n, dn_n = _moe_weight_names(g, nd)
            gu, dn = ws[gu_n].clone(), ws[dn_n].clone()
            for e in set(range(E)) - set(routed[nd.out.idx]):
                gu[e * H:(e + 1) * H] = float("nan")
                dn[e * inter:(e + 1) * inter] = float("nan")
                n_nan += 1
            nan_ws[gu_n], nan_ws[dn_n] = gu, dn
        prog.bind_weights(nan_ws)
        no, nr = launch()
        assert all(torch.isfinite(o).all() and torch.equal(o, k)
                   for o, k in zip(no, ko)) and torch.equal(nr, kr), "NaN"
        print(f"megakernel moe {str(dt)[6:]} 2 layers at Qwen3-30B-A3B "
              f"widths, lengths {lens.tolist()} widths {widths.tolist()}: "
              f"vs plain walk out {errs[0]:.3e}, appended rows "
              f"{errs[1]:.3e}{line} (of max |ref|); idle slot rows 0, other "
              f"pool rows unchanged; routed experts a layer "
              f"{[len(v) for v in routed.values()]}, {n_nan} unrouted slabs "
              f"NaN: same bits; plain walk {plain_ms:.1f} ms")
        assert max(errs) <= tol[dt], (dt, errs)
        step = None
        if dt == bf16:
            prog.bind_weights(ws)
            prog.bind_caches({n: t.clone() for n, t in start.items()})
            ms = time_ms([lambda: prog.step(cache_lens=lens, block_table=tbl,
                                            widths=widths)])
            prog.check_fault()
            costs = prog.task_costs(cache_lens=lens, widths=widths,
                                    experts=routed)
            moved = sum(c["bytes"] for c in costs)
            bms, by = bound(moved, sum(c["flops"] for c in costs))
            mb_moe = sum(c["bytes"] for nd, c in zip(prog.tasks, costs)
                         if nd.op == "moe_ffn")
            print(f"megakernel moe bf16 2-layer step: {ms:.4f} ms, bound "
                  f"{bms:.4f} ms ({by}: {moved / 1e9:.3f} GB, of it "
                  f"{mb_moe / 1e9:.3f} GB in the GROUPED_GEMM tasks)")
            step = {"ms": ms, "bound_ms": bms, "plain_ms": plain_ms,
                    "err": max(errs)}
        del prog, ins, ws, nan_ws, start
        torch.cuda.empty_cache()
    return step


def check_mega_serve_small(models, seed, moe=False):
    """A small model's ServeEngine(mode="megakernel") on the GPU (the
    kernel) against the same weights on the CPU (the plain walk): four
    requests through two slots, 16-token pages, 8-token chunks; bf16
    (the engine path's prefill kernel takes bf16 only). Every greedy
    pick's logits agree within 5e-2 of the largest and the picks are
    equal where the CPU's top-2 gap exceeds twice the error, up to the
    first pick that differs (the streams part there). `moe`: a small
    Qwen3MoE (head_dim 128, group 8, 8 experts, top-2) instead of the
    dense model."""
    from triton_distributed_tpu_torch.megakernel import serve as mserve
    from triton_distributed_tpu_torch.models import dense
    if moe:
        cls = models.Qwen3MoE
        cfg = models.get_config("Qwen/Qwen3-30B-A3B").tiny(
            hidden_size=256, num_heads=8, num_kv_heads=1, head_dim=128,
            vocab_size=512, num_layers=2, num_experts=8,
            num_experts_per_tok=2, moe_intermediate_size=256)
    else:
        cls = models.DenseLLM
        cfg = models.get_config("Qwen/Qwen3-8B").tiny(
            hidden_size=256, num_heads=8, num_kv_heads=2, head_dim=128,
            intermediate_size=512, vocab_size=512, num_layers=2)
    cpu = cls(cfg, dtype="bfloat16", device="cpu")
    params = cpu.init_params(torch.Generator().manual_seed(seed))
    gpu = cls(cfg, dtype="bfloat16", device="cuda")
    rng = np.random.RandomState(seed)
    reqs = [(rng.randint(0, 512, n).astype(np.int32), g)
            for n, g in ((37, 6), (5, 9), (20, 4), (16, 5))]
    real = dense.greedy_token
    runs = []
    for m, p in ((cpu, params), (gpu, _to_device(params, "cuda"))):
        seen = []

        def spy(x, lm_head):
            seen.append((x.float() @ lm_head.float()).cpu())
            return real(x, lm_head)

        dense.greedy_token = mserve.greedy_token = spy
        try:
            se = models.ServeEngine(m, p, mode="megakernel", b_max=2,
                                    max_len=64, block=16, prefill_chunk=8)
            se.serve([r for r, _ in reqs], [g for _, g in reqs])
        finally:
            dense.greedy_token = mserve.greedy_token = real
        runs.append(seen)
    errs, parted = [], None
    for k, (c, g) in enumerate(zip(*runs)):
        err = (g - c).abs().max().item()
        errs.append(err / c.abs().max().item())
        assert err <= 5e-2 * max(1.0, c.abs().max().item()), (k, err)
        top2 = c.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * err
        assert torch.equal(g.argmax(-1)[sure], c.argmax(-1)[sure]), k
        if not torch.equal(g.argmax(-1), c.argmax(-1)):
            parted = k
            break
    print(f"small {cls.__name__} ServeEngine(mode='megakernel') bf16 GPU "
          f"(kernel) vs CPU (plain walk): {len(errs)} of {len(runs[0])} "
          f"picks compared, "
          f"logits max {max(errs):.3e} of max |logit|, streams "
          + ("equal" if parted is None else f"part at pick {parted}"))
    assert len(errs) >= 4


def _mk_snapshot(se, raw=False):
    """Wrap `se._decode_tick` to keep, at the first tick where every slot
    decodes, the state before its launch (tokens, lengths, tables and
    the megakernel's pools in the engine pool's layout) and the hidden
    rows the launch gave; with `raw`, also the pools as the megakernel
    holds them and, after the launch, every layer's router-logit rows
    (a MoE program)."""
    snap = {}
    real = se._decode_tick
    mk = se._mk
    logit_handles = [nd.inputs[1] for nd in mk.prog.graph.nodes
                     if nd.op == "moe_ffn"]

    def layout(pool, like):
        L, nb, hkv, blk, d = like.shape
        return pool.view(L, -1, blk, hkv, d)[:, :nb].permute(
            0, 1, 3, 2, 4).contiguous()

    def tick(stream_cb):
        from triton_distributed_tpu_torch.models import serve_state
        if snap or len(serve_state.decode_live(se.sched)) < se.b_max:
            return real(stream_cb)
        c = se._cache
        snap.update(toks=[s.last_tok for s in se._slots],
                    lens=c.seq_lens.copy(), table=c.block_table.copy(),
                    k=layout(mk.k_pool, c.k_pool),
                    v=layout(mk.v_pool, c.v_pool))
        snap["ktab"] = mk.kernel_table(torch.from_numpy(snap["table"]),
                                       torch.ones(se.b_max, dtype=torch.bool))
        if raw:
            snap.update(kpool=mk.k_pool.clone(), vpool=mk.v_pool.clone())
        real(stream_cb)
        snap["hid"] = mk.prog.outputs()[0][::mk.slot_rows].float().clone()
        if raw:
            snap["logits"] = [mk.prog._tensor(h)[::mk.slot_rows].float()
                              .clone() for h in logit_handles]

    se._decode_tick = tick
    return snap


def mk_serve_breakdown(prog, ms, lens):
    """Where the batched serve step's time goes, from launches of the same
    kernel: the step with every slot idle (length 0 on its trash page),
    so the attention over the slots' prefixes is the difference; then
    each projection shape alone at the step's rows and at one row, on
    the program's own weight views."""
    from triton_distributed_tpu_torch.megakernel.builder import ModelBuilder
    nb, R, blk, mp, _ = prog.paged
    idle = prog.graph.caches["l0.k_pool"].rows // blk - nb \
        + np.arange(nb, dtype=np.int32)[:, None] + np.zeros((1, mp), np.int32)
    ms0 = time_ms([lambda: prog.step(cache_lens=np.zeros(nb, np.int32),
                                     block_table=idle)])
    prog.check_fault()
    print(f"mk-serve breakdown: the step with every slot idle {ms0:.4f} ms, "
          f"so the attention over lengths {lens.tolist()} costs "
          f"~{ms - ms0:.4f} ms")
    dt, dev = prog.dtype, prog.device
    line = []
    for name in ("w_qkv", "w_o", "w_gate", "w_down"):
        w = prog.weights[f"l0.{name}"]
        K, N = w.shape
        us = []
        for rows in (nb * R, 1):
            mb = ModelBuilder(dtype=dt)
            mb.output(mb.linear(mb.input("x", (rows, K)),
                                mb.weight("w", (K, N))))
            p = mb.compile("kernel", device=dev)
            p.bind_weights({"w": w})
            xx = torch.randn((rows, K), device=dev).to(dt)
            us.append(time_ms([lambda: p.step({"x": xx}, 0)], reps=50) * 1e3)
            p.check_fault()
        line.append(f"{name} {K}x{N} {us[0]:.1f} us at {nb * R} rows, "
                    f"{us[1]:.1f} us at 1")
    print("mk-serve breakdown: one linear per launch: " + "; ".join(line))


def check_mega_serve(models, attn, gg, model, params, cfg, seed, smi, profile,
                     engine_out):
    """The slice-3b main path at full width: ServeEngine(mode="megakernel")
    over the Qwen3-8B weights with the serve cell's stream and settings.
    The bf16 pool run is counted (exactly one megakernel launch and no
    flash_decode_paged launch per decode tick) and checked as step 9's
    runs are, then run again for identical tokens and a teacher-forced
    check; then the batched step's time against its bound; then the int8
    pool. Returns the launch counts."""
    from triton_distributed_tpu_torch.megakernel import executor_cuda as mkx
    L = cfg.num_layers
    stream = serve_stream(np.random.RandomState(seed), cfg.vocab_size)
    total = {}
    first = None
    for kv in (None, "int8"):
        se = models.ServeEngine(model, params, mode="megakernel", b_max=4,
                                max_len=2048, block=128, prefill_chunk=256,
                                num_blocks=64, kv_dtype=kv)
        out, st, launches, tick_ms, ops = run_serve(models, attn, se, stream,
                                                    L, gg)
        for n, c in launches.items():
            total[n] = total.get(n, 0) + c
        name = kv or "bf16"
        assert launches["megakernel"] == st["decode_steps"] > 0, launches
        print(f"mk-serve[{name}]: {st['tokens']} tokens in {st['wall_s']:.3f} "
              f"s ({st['tokens_per_s']} tokens/s), {st['ticks']} ticks, "
              f"{st['decode_steps']} decode ticks at "
              f"{statistics.median(tick_ms):.2f} ms median "
              f"({min(tick_ms):.2f}-{max(tick_ms):.2f}; {ops} aten ops on "
              f"the host), {st['prefill_chunks']} chunks, launches "
              f"{ {n: c for n, c in launches.items() if c} }, megakernel "
              f"pool {2 * se._mk.k_pool.numel() * 2 / 2**30:.3f} GiB | {smi}")
        assert sorted(out) == list(range(len(stream)))
        for rid, (_, gen_len) in enumerate(stream):
            toks = out[rid]
            assert len(toks) == gen_len, (rid, len(toks))
            assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
        se._cache.check_conservation(cached=st["cached_free_blocks"])
        assert st["free_blocks"] + st["cached_free_blocks"] == 64, st
        # megakernel slots are admitted without prefix sharing
        assert st["prefix_hit_blocks"] == 0 and st["cow_copies"] == 0, st
        rep = models.serve.banded_token_identity(engine_out, out, band=1.0)
        print(f"mk-serve[{name}] vs engine mode bf16 (information only, "
              f"random weights): agreed {rep['agreed_steps']}/"
              f"{rep['total_steps']} steps ({rep['agreed_frac']})")
        if kv is not None:
            continue
        first = out
        snap = _mk_snapshot(se)
        for rid_ids, gen_len in stream:
            se.submit(rid_ids, gen_len)
        again = se.run()
        del se._decode_tick
        se._mk.prog.check_fault()
        assert all(np.array_equal(again[r + len(stream)], first[r])
                   for r in first), "a second run gave other tokens"
        print("mk-serve[bf16]: a second run gives identical tokens")
        # teacher forcing: the engine's decode step on the same state
        ref = model.new_paged_kv_cache(4, 2048, block=128, num_blocks=64)
        ref.k_pool.copy_(snap["k"])
        ref.v_pool.copy_(snap["v"])
        ref.block_table[:] = snap["table"]
        ref.seq_lens[:] = snap["lens"]
        seen = _spy_logits(model, params)
        model.decode_step_paged(params, snap["toks"], ref, [True] * 4)
        del model._next_token
        want = seen[0].to(snap["hid"].device)
        got = snap["hid"] @ params["lm_head"].float()
        err = _rel_err(got, want)
        print(f"mk-serve teacher forcing: the first all-slots tick (lengths "
              f"{snap['lens'].tolist()}) logits vs decode_step_paged on the "
              f"same state {err:.3e} of max |logit|; greedy tokens "
              f"{got.argmax(-1).tolist()} vs {want.argmax(-1).tolist()}")
        assert torch.isfinite(got).all() and err <= MK_BF16_TOL, err
        del ref, seen
        # the batched step at that state, against its bound
        prog = se._mk.prog
        lens, ktab = snap["lens"], snap["ktab"]
        ms = time_ms([lambda: prog.step(cache_lens=lens, block_table=ktab)])
        prog.check_fault()
        costs = prog.task_costs(cache_lens=lens)
        moved = sum(c["bytes"] for c in costs)
        flops = sum(c["flops"] for c in costs)
        bms, by = bound(moved, flops)
        print(f"mk-serve batched step (4 live rows, lengths "
              f"{lens.tolist()}): kernel {ms:.4f} ms, bound {bms:.4f} ms "
              f"({by}: {moved / 1e9:.3f} GB, {flops / 1e9:.2f} GFLOP), "
              f"{len(prog.tasks)} tasks in {int(prog.n_tiles.sum())} tiles "
              f"| {smi}")
        plain_ms = time_ms([lambda: prog.step(
            cache_lens=lens, block_table=ktab, plain=True)], reps=1, rounds=1)
        print(f"mk-serve batched step: plain walk {plain_ms:.1f} ms (paced "
              f"by the host)")
        step = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                "bound_by": by}
        if profile:
            mk_serve_breakdown(prog, ms, lens)
        del snap
        torch.cuda.empty_cache()
    if profile:
        profile_serve(models, model, params, cfg.vocab_size, seed,
                      mode="megakernel")
    return total, step


def _bf16_ulp(m):
    """The spacing of bf16 values at magnitude m."""
    return torch.finfo(torch.bfloat16).eps * 2.0 ** np.floor(np.log2(m))


def _mk_moe_tick_checks(se, snap, model, params):
    """The first all-slots tick of a MoE megakernel serve run against the
    golden executor on the same state (the megakernel's pools, the
    kernel's table, the slots' tokens): hidden rows within MK_BF16_TOL of
    the largest, and every layer's router-logit rows compared: a row
    whose top-k set differs between the two must be a near-tie, its k-th
    and (k+1)-th largest golden logits no further apart than the row's
    largest logit difference between the two plus one bf16 step (the
    rounding that can swap them); any other difference fails. Then
    against decode_step_paged (f32 router) as information. Returns
    (flips, layers x rows compared)."""
    from triton_distributed_tpu_torch.ops.moe_utils import route_topk
    mk = se._mk
    prog = mk.prog
    g = prog.graph
    c = model.config
    k = c.num_experts_per_tok
    lens = snap["lens"]
    ids = torch.as_tensor(np.asarray(snap["toks"]), device=prog.device)
    ins = {"x": mk.embed[ids]}
    for i in range(c.num_layers):
        ins[f"l{i}.k_pool"] = snap["kpool"][i]
        ins[f"l{i}.v_pool"] = snap["vpool"][i]
    logit_handles = [nd.inputs[1] for nd in g.nodes if nd.op == "moe_ffn"]
    n_out = len(g.outputs)
    g.outputs.extend(logit_handles)
    try:
        gold = prog.builder.compile("graph").run(
            ins, prog.weights, {f"cache_len_s{b}": int(cl)
                                for b, cl in enumerate(lens)},
            block_table=snap["ktab"])
    finally:
        del g.outputs[n_out:]
    err = _rel_err(snap["hid"], gold[0].float())
    flips, n = 0, 0
    for layer, (kl, gl) in enumerate(zip(snap["logits"], gold[1:])):
        gl = gl.float()
        _, ke = route_topk(kl, k)
        _, ge = route_topk(gl, k)
        for r in range(kl.shape[0]):
            n += 1
            if set(ke[r].tolist()) == set(ge[r].tolist()):
                continue
            srt = gl[r].sort(descending=True).values
            gap = (srt[k - 1] - srt[k]).item()
            slack = (kl[r] - gl[r]).abs().max().item() \
                + _bf16_ulp(srt[k - 1].abs().item())
            assert gap <= slack, ("a routing difference that is no near-tie",
                                  layer, r, gap, slack)
            flips += 1
    lm = params["lm_head"].float()
    gerr = _rel_err(snap["hid"] @ lm, gold[0].float() @ lm)
    print(f"mk-moe-serve golden check: the first all-slots tick (lengths "
          f"{lens.tolist()}): hidden rows {err:.3e} of max |ref|, logits "
          f"{gerr:.3e} of max |logit| against the golden executor on the "
          f"same state; top-{k} sets of {n} (layer, row) routings differ in "
          f"{flips}, each a near-tie")
    assert torch.isfinite(snap["hid"]).all() and err <= MK_BF16_TOL, err
    del gold
    ref = model.new_paged_kv_cache(4, 2048, block=128, num_blocks=64)
    ref.k_pool.copy_(snap["k"])
    ref.v_pool.copy_(snap["v"])
    ref.block_table[:] = snap["table"]
    ref.seq_lens[:] = lens
    seen = _spy_logits(model, params)
    model.decode_step_paged(params, snap["toks"], ref, [True] * 4)
    del model._next_token
    want = seen[0].to(snap["hid"].device)
    got = snap["hid"] @ lm
    print(f"mk-moe-serve vs decode_step_paged on the same state (information "
          f"only: its router runs in f32): logits "
          f"{_rel_err(got, want):.3e} of max |logit|; greedy tokens "
          f"{got.argmax(-1).tolist()} vs {want.argmax(-1).tolist()}")
    return flips, n


def mk_moe_breakdown(prog, ms, lens):
    """Where the MoE batched step's time goes, from launches of the same
    program: every slot idle (length 0 on its trash page, width 0: no
    expert slab read, no prefix), then the rows live at length 0 (the
    routed slabs read, no prefix); the differences are the expert FFN's
    and the attention's shares."""
    nb, R, blk, mp, _ = prog.paged
    trash = prog.graph.caches["l0.k_pool"].rows // blk - nb \
        + np.arange(nb, dtype=np.int32)[:, None] + np.zeros((1, mp), np.int32)
    zero = np.zeros(nb, np.int32)
    ms0 = time_ms([lambda: prog.step(cache_lens=zero, block_table=trash,
                                     widths=zero)])
    ms1 = time_ms([lambda: prog.step(cache_lens=zero, block_table=trash,
                                     widths=np.ones(nb, np.int32))])
    prog.check_fault()
    print(f"mk-moe-serve breakdown: every slot idle {ms0:.4f} ms; the rows "
          f"live at length 0 {ms1:.4f} ms, so the expert FFN costs "
          f"~{ms1 - ms0:.4f} ms and the attention over lengths "
          f"{lens.tolist()} ~{ms - ms1:.4f} ms")


def check_mega_serve_moe(models, attn, gg, model, params, cfg, seed, smi,
                         profile, engine_out):
    """The slice-3c main path: ServeEngine(mode="megakernel") over the
    Qwen3-30B-A3B weights with the serve cell's stream and settings. The
    bf16 pool run is counted (one megakernel launch per decode tick, no
    flash_decode_paged launch, gmm only in the engine-path prefill
    chunks) and checked as step 9's runs are; run again for identical
    tokens, its first all-slots tick held against the golden executor
    (`_mk_moe_tick_checks`); the batched step against its bound, routed
    slabs counted from the launch's router logits; then the int8 pool,
    then ep_capacity=2 (slots deferred, every request at its length,
    ep_rows the rows decode routed). Returns (launch totals, the step's
    numbers, the bf16 run's tokens)."""
    L = cfg.num_layers
    stream = serve_stream(np.random.RandomState(seed), cfg.vocab_size)
    total, step, first = {}, None, None
    torch.cuda.reset_peak_memory_stats()
    for kv, cap in ((None, 0), ("int8", 0), (None, 2)):
        se = models.ServeEngine(model, params, mode="megakernel", b_max=4,
                                max_len=2048, block=128, prefill_chunk=256,
                                num_blocks=64, kv_dtype=kv, ep_capacity=cap)
        out, st, launches, tick_ms, ops = run_serve(models, attn, se, stream,
                                                    L, gg)
        for n, c in launches.items():
            total[n] = total.get(n, 0) + c
        name = (kv or "bf16") + (f", ep_capacity={cap}" if cap else "")
        assert launches["megakernel"] == st["decode_steps"] > 0, launches
        print(f"mk-moe-serve[{name}]: {st['tokens']} tokens in "
              f"{st['wall_s']:.3f} s ({st['tokens_per_s']} tokens/s), "
              f"{st['ticks']} ticks, {st['decode_steps']} decode ticks at "
              f"{statistics.median(tick_ms):.2f} ms median "
              f"({min(tick_ms):.2f}-{max(tick_ms):.2f}; {ops} aten ops on "
              f"the host), {st['prefill_chunks']} chunks, capacity_drops "
              f"{st['capacity_drops']}, ep_rows {st['ep_rows']}, launches "
              f"{ {n: c for n, c in launches.items() if c} } | {smi}")
        assert sorted(out) == list(range(len(stream)))
        for rid, (_, gen_len) in enumerate(stream):
            toks = out[rid]
            assert len(toks) == gen_len, (rid, len(toks))
            assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
        se._cache.check_conservation(cached=st["cached_free_blocks"])
        assert st["free_blocks"] + st["cached_free_blocks"] == 64, st
        assert st["prefix_hit_blocks"] == 0 and st["cow_copies"] == 0, st
        rep = models.serve.banded_token_identity(engine_out, out, band=1.0)
        print(f"mk-moe-serve[{name}] vs engine mode bf16 (information only, "
              f"random weights): agreed {rep['agreed_steps']}/"
              f"{rep['total_steps']} steps ({rep['agreed_frac']})")
        if cap:
            assert st["capacity_drops"] > 0, st
            assert st["ep_rows"] == sum(g - 1 for _, g in stream), st
            continue
        assert st["capacity_drops"] == 0 and st["ep_rows"] == 0, st
        if kv is not None:
            continue
        snap = _mk_snapshot(se, raw=True)
        for rid_ids, gen_len in stream:
            se.submit(rid_ids, gen_len)
        again = se.run()
        del se._decode_tick
        se._mk.prog.check_fault()
        assert all(np.array_equal(again[r + len(stream)], out[r])
                   for r in out), "a second run gave other tokens"
        print("mk-moe-serve[bf16]: a second run gives identical tokens")
        flips, n_routings = _mk_moe_tick_checks(se, snap, model, params)
        prog = se._mk.prog
        lens, ktab = snap["lens"], snap["ktab"]
        live = np.ones(4, np.int32)
        ms = time_ms([lambda: prog.step(cache_lens=lens, block_table=ktab,
                                        widths=live)])
        prog.check_fault()
        routed = prog.routed_experts(live)
        costs = prog.task_costs(cache_lens=lens, widths=live, experts=routed)
        moved = sum(c["bytes"] for c in costs)
        flops = sum(c["flops"] for c in costs)
        bms, by = bound(moved, flops)
        upper = sum(c["bytes"] for c in prog.task_costs(cache_lens=lens,
                                                        widths=live))
        per_layer = [len(v) for v in routed.values()]
        print(f"mk-moe-serve batched step (4 live rows, lengths "
              f"{lens.tolist()}): kernel {ms:.4f} ms, bound {bms:.4f} ms "
              f"({by}: {moved / 1e9:.3f} GB with the {sum(per_layer)} routed "
              f"slabs, {min(per_layer)}-{max(per_layer)} a layer, mean "
              f"{statistics.mean(per_layer):.1f}; {upper / 1e9:.3f} GB at "
              f"top-8 slabs a row), {len(prog.tasks)} tasks in "
              f"{int(prog.n_tiles.sum())} tiles | {smi}")
        step = {"ms": ms, "bound_ms": bms, "bound_by": by,
                "gb": moved / 1e9, "flips": flips, "routings": n_routings}
        if profile:
            mk_moe_breakdown(prog, ms, lens)
        first = out
        del snap
        torch.cuda.empty_cache()
    print(f"mk-moe-serve: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (weights, "
          f"the engine and megakernel pools, the golden check)")
    if profile:
        profile_serve(models, model, params, cfg.vocab_size, seed,
                      mode="megakernel")
    return total, step, first


# -- speculative decoding: the megakernel's verify-width arms and the spec
#    serving paths -------------------------------------------------------------

SPEC_K = 4                 # verify width of the spec serve cells
# Teacher forcing, of max |logit|: a verify step's rows against k
# sequential decode_step_paged calls, bf16 x 36 layers, where M=1 and
# M=K GEMMs round differently. Each limit sits just above its reading on
# an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6), and the check
# fails a verify step whose rows are roped one position off (planted in
# every run, `_planted_rope_fault`).
SPEC_TF_TOL_MK = 2.5e-2      # MegaServe.verify: read 1.985e-2
SPEC_TF_TOL_ENGINE = 2.5e-2  # DenseLLM.verify_step_paged: read 2.059e-2
VERIFY_LENS = np.asarray([0, 128, 381, 1500], np.int32)
VERIFY_WIDTHS = np.asarray([0, 1, 3, 8], np.int32)


def _verify_rows(lens, widths, tbl, blk):
    """Pool rows a verify launch appends: max(1, width) rows a slot from
    its length, through its table row."""
    return np.concatenate([tbl[b, p // blk].astype(np.int64) * blk + p % blk
                           for b in range(len(lens))
                           for p in (lens[b] + np.arange(max(1, widths[b])),)])


def check_megakernel_verify_graphs(dev):
    """The verify-width arms (ATTN_P, KVA_PK / KVA_PV, and GROUPED_GEMM at
    widths > 1) on 2-layer serve graphs at slot_rows 8, at Qwen3-8B
    widths and (MoE) at Qwen3-30B-A3B widths, on the serve cell's pool:
    four slots at widths 0 (idle, on its trash page), 1, 3 and 8 and
    lengths 0, 128, 381 (its three rows are its page's last rows) and
    1500, on a shuffled table; rows past a slot's width zero. The kernel
    against its plain walk, f32 (MK_F32_TOL) and bf16 (MK_BF16_2L_TOL),
    outputs and appended rows; pad rows exactly 0; every pool row outside
    [cache_len_b, cache_len_b + width) bitwise unchanged. Returns the
    largest absolute bf16 difference."""
    from triton_distributed_tpu_torch.megakernel.models import (
        build_qwen3_moe_serve_batched, build_qwen3_serve_batched)
    lens, widths, R = VERIFY_LENS, VERIFY_WIDTHS, 8
    blk, mp, nbk = 128, 16, 64
    run = np.maximum(widths, 1)
    last = lens + run - 1
    perm = iter(np.random.RandomState(9).permutation(nbk))
    tbl = np.asarray([[next(perm) if widths[b] and c <= last[b] // blk
                       else nbk + b for c in range(mp)] for b in range(4)],
                     np.int32)
    rows = torch.as_tensor(_verify_rows(lens, widths, tbl, blk), device=dev)
    live = torch.as_tensor(np.arange(4 * R) % R < np.repeat(run, R),
                           device=dev)
    f32, bf16 = torch.float32, torch.bfloat16
    tol = {f32: MK_F32_TOL, bf16: MK_BF16_2L_TOL}
    worst = 0.0
    for moe in (False, True):
        for dt in (f32, bf16):
            common = dict(b_slots=4, slot_rows=R, num_layers=2,
                          num_blocks=nbk, block=blk, max_pages=mp,
                          rope_theta=1e6, qk_norm=True, dtype=dt)
            if moe:
                mb = build_qwen3_moe_serve_batched(**common, **MOE_WIDTHS)
            else:
                mb = build_qwen3_serve_batched(
                    hidden=4096, intermediate=12288, num_heads=32,
                    num_kv_heads=8, head_dim=128, **common)
            ins, ws = _device_io(mb, dev, 17)
            for n in ws:       # N(0, 1 / rows) of one expert's slab
                if "w_moe" in n:
                    ws[n] *= MOE_WIDTHS["num_experts"] ** 0.5
            ins, ws = ({n: t.to(dt) for n, t in d.items()}
                       for d in (ins, ws))
            ins["x"][~live] = 0
            start = {n: ins[n] for n in mb.graph.caches}
            prog = mb.compile("kernel", device=dev)
            prog.bind_weights(ws)
            keep = torch.ones(next(iter(start.values())).shape[0],
                              dtype=torch.bool, device=dev)
            keep[rows] = False
            got = []
            for plain in (False, True):
                prog.bind_caches({n: t.clone() for n, t in start.items()})
                out = prog.step({"x": ins["x"]}, cache_lens=lens,
                                block_table=tbl, widths=widths,
                                plain=plain)[0]
                torch.cuda.synchronize()
                prog.check_fault()
                for n, c in prog.caches.items():
                    assert torch.equal(c[keep], start[n][keep]), (plain, n)
                got.append((out.float().clone(),
                            torch.cat([c[rows].float()
                                       for c in prog.caches.values()])))
            (ko, kr), (po, pr) = got
            assert torch.isfinite(ko).all() and (ko[~live] == 0).all()
            errs = [_rel_err(ko, po), _rel_err(kr, pr)]
            if dt == bf16:
                worst = max(worst, (ko - po).abs().max().item(),
                            (kr - pr).abs().max().item())
            print(f"megakernel verify {'moe ' if moe else ''}{str(dt)[6:]} "
                  f"2 layers at "
                  f"{'Qwen3-30B-A3B' if moe else 'Qwen3-8B'} widths, "
                  f"slot_rows {R}, lengths {lens.tolist()} widths "
                  f"{widths.tolist()}: vs plain walk out {errs[0]:.3e}, "
                  f"appended rows {errs[1]:.3e} (of max |ref|); pad rows 0, "
                  f"pool rows outside the windows unchanged")
            assert max(errs) <= tol[dt], (moe, dt, errs)
            del prog, ins, ws, start, got
            torch.cuda.empty_cache()
    return worst


def _oracle_spec(models, targets, stream, vocab, k=SPEC_K, wrong_every=3):
    """SpecConfig with an OracleDrafter over `targets` (a spec-off run's
    tokens by rid), every `wrong_every`-th draft wrong, no adaptation."""
    prompts = {r: ids for r, (ids, _) in enumerate(stream)}
    return models.SpecConfig(drafter=models.OracleDrafter(
        targets, prompts, wrong_every=wrong_every, vocab=vocab), k=k,
        adapt=False)


def _verify_snapshot(se, widths_seen=None):
    """Wrap the megakernel's verify to keep, at the first launch where
    every slot decodes and some slot verifies drafts, its arguments and
    the megakernel pools before it; `widths_seen` collects every
    launch's widths."""
    snap = {}
    mk = se._mk
    real = mk.verify
    step = mk.prog.step

    def spy_step(*a, **kw):
        if widths_seen is not None:
            widths_seen.append(np.asarray(kw["widths"]).copy())
        return step(*a, **kw)

    def verify(cands, counts, lens, table, mask):
        if not snap and np.all(mask) and np.max(counts) > 1:
            snap.update(cands=np.array(cands), counts=np.array(counts),
                        lens=np.array(lens), table=np.array(table),
                        mask=np.array(mask), kpool=mk.k_pool.clone(),
                        vpool=mk.v_pool.clone())
        return real(cands, counts, lens, table, mask)

    mk.verify = verify
    mk.prog.step = spy_step
    return snap


def _engine_layout(pool, like):
    """A megakernel pool (L, pages x block, Hkv x D) in the engine pool's
    (L, nb, Hkv, block, D) layout."""
    L, nb, hkv, blk, d = like.shape
    return pool.view(L, -1, blk, hkv, d)[:, :nb].permute(0, 1, 3, 2, 4)


def _tf_err(got, want):
    """The largest logit difference, of the largest |logit|."""
    return (got - want).abs().max().item() / want.abs().max().item()


def _near_tie_rule(name, got, want, tol):
    """Logits within `tol` of the largest; a row whose greedy pick
    differs must be a near-tie: its top-2 gap no more than the row's
    largest logit difference plus one bf16 step."""
    diff = (got - want).abs()
    err = _tf_err(got, want)
    flips = 0
    for r in torch.nonzero(got.argmax(-1) != want.argmax(-1)).flatten():
        top2 = want[r].topk(2).values
        gap = (top2[0] - top2[1]).item()
        slack = diff[r].max().item() + _bf16_ulp(top2[0].abs().item())
        assert gap <= slack, (name, int(r), gap, slack)
        flips += 1
    print(f"spec teacher forcing: {name}: {got.shape[0]} candidate rows, "
          f"logits {err:.3e} of max |logit| against {SPEC_K} sequential "
          f"decode_step_paged calls on a copy of the same cache; "
          f"{flips} greedy picks differ, each a near-tie (limit {tol:.1e})")
    assert torch.isfinite(got).all() and err <= tol, (name, err)


def _planted_rope_fault(mk_verify, engine_verify, mk_rope, want, live,
                        smi):
    """The teacher-forced check against a wrong verify arm: each verify
    again with its candidate rows (q and the appended k) roped one
    position late, the megakernel's by shifting its RoPE tables one row
    for the launch (the kernel reads row cache_len + j), the engine's by
    handing verify_step_paged the cos / sin of position + 1. Both must
    fail the limits."""
    from triton_distributed_tpu_torch.models import dense
    saved = [t.clone() for pair in mk_rope for t in pair]
    for pair in mk_rope:
        for t in pair:
            t[:-1] = t[1:].clone()
    try:
        mk = _tf_err(mk_verify(), want)
    finally:
        for t, s in zip((t for pair in mk_rope for t in pair), saved):
            t.copy_(s)
    real = dense.rope_cos_sin
    dense.rope_cos_sin = lambda pos, *a, **kw: real(pos + 1, *a, **kw)
    try:
        eng = _tf_err(engine_verify()[live.reshape(-1)], want)
    finally:
        dense.rope_cos_sin = real
    print(f"spec teacher forcing, planted fault (the verify rows roped one "
          f"position late): megakernel verify {mk:.3e}, engine verify "
          f"{eng:.3e} of max |logit| against limits {SPEC_TF_TOL_MK:.1e} / "
          f"{SPEC_TF_TOL_ENGINE:.1e}: both fail the check | {smi}")
    assert mk > SPEC_TF_TOL_MK and eng > SPEC_TF_TOL_ENGINE, (mk, eng)


def _stage_latency_s(dev, dt):
    """The latency of one dependent single-tile megakernel stage: a chain
    of 73 adds against one add, as megakernel_breakdown measures it."""
    from triton_distributed_tpu_torch.megakernel.builder import ModelBuilder
    us = []
    for n in (1, 73):
        mb = ModelBuilder(dtype=dt)
        h0 = h = mb.input("x", (1, 4096))
        for _ in range(n):
            h = mb.add(h, h0)
        mb.output(h)
        p = mb.compile("kernel", device=dev)
        p.bind_weights({})
        xx = torch.randn((1, 4096), device=dev).to(dt)
        us.append(time_ms([lambda: p.step({"x": xx}, 0)], reps=50) * 1e3)
        p.check_fault()
    return (us[1] - us[0]) / 72 * 1e-6


def _spec_verify_checks(se, snap, model, params, cfg, smi):
    """At the snapshot's verify (every slot decoding, drafts to verify):
    the teacher-forced check of the megakernel's verify and of the
    engine's verify_step_paged against SPEC_K sequential decode steps on
    copies of the same state, and against the same verifies with a
    planted RoPE fault, which it must fail; the verify step's kernel
    time against its
    task_costs bound, its plain walk's time and difference; and the
    perf_model constants (perf_model.py) measured at that state.
    Returns the megakernel[verify] entry's numbers."""
    from triton_distributed_tpu_torch import perf_model as pm
    from triton_distributed_tpu_torch.megakernel import serve as mserve
    from triton_distributed_tpu_torch.models import dense
    mk, prog = se._mk, se._mk.prog
    del mk.verify, prog.step                   # the snapshot's spies
    cands, counts, lens, table, mask = (snap[k] for k in (
        "cands", "counts", "lens", "table", "mask"))
    B, K = cands.shape
    L, H, Hkv, D = (cfg.num_layers, cfg.num_heads, cfg.num_kv_heads,
                    cfg.head_dim)
    live = torch.from_numpy(
        (np.arange(K)[None] < counts[:, None]) & mask[:, None])

    def ref_cache():
        c = model.new_paged_kv_cache(B, 2048, block=128, num_blocks=64)
        c.k_pool.copy_(_engine_layout(snap["kpool"], c.k_pool))
        c.v_pool.copy_(_engine_layout(snap["vpool"], c.v_pool))
        c.block_table[:] = snap["table"]
        c.seq_lens[:] = lens
        return c

    ref = ref_cache()
    seen = _spy_logits(model, params)
    for j in range(K):
        model.decode_step_paged(params, cands[:, j], ref, mask & (counts > j))
    del model._next_token
    want = torch.stack(seen[:K], dim=1)[live]
    del ref
    real = dense.greedy_token
    got = {}

    def spy(where):
        def pick(x, lm_head):
            got[where] = (x.float() @ lm_head.float()).cpu()
            return real(x, lm_head)
        return pick

    def mk_verify():
        mk.k_pool.copy_(snap["kpool"])
        mk.v_pool.copy_(snap["vpool"])
        mserve.greedy_token = spy("mk")
        try:
            mk.verify(cands, counts, lens, table, mask)
        finally:
            mserve.greedy_token = real
        torch.cuda.synchronize()
        prog.check_fault()
        return got["mk"]

    def engine_verify():
        ref = ref_cache()
        dense.greedy_token = spy("engine")
        try:
            model.verify_step_paged(params, cands, ref, mask, counts)
        finally:
            dense.greedy_token = real
        return got["engine"]

    _near_tie_rule("megakernel verify (MegaServe.verify, one launch)",
                   mk_verify(), want, SPEC_TF_TOL_MK)
    _near_tie_rule("engine verify (verify_step_paged)",
                   engine_verify()[live.reshape(-1)], want,
                   SPEC_TF_TOL_ENGINE)
    _planted_rope_fault(mk_verify, engine_verify, prog._rope.values(), want,
                        live, smi)
    # the verify step: kernel, bound, plain walk
    wid = np.where(mask, counts, 0).astype(np.int32)
    ktab = mk.kernel_table(torch.from_numpy(table), torch.from_numpy(mask))
    ms = time_ms([lambda: prog.step(cache_lens=lens, block_table=ktab,
                                    widths=wid)])
    prog.check_fault()
    costs = prog.task_costs(cache_lens=lens, widths=wid)
    moved = sum(c["bytes"] for c in costs)
    flops = sum(c["flops"] for c in costs)
    bms, by = bound(moved, flops)
    ko = prog.step(cache_lens=lens, block_table=ktab,
                   widths=wid)[0].float().clone()
    torch.cuda.synchronize()
    prog.check_fault()
    t0 = time.perf_counter()
    po = prog.step(cache_lens=lens, block_table=ktab, widths=wid,
                   plain=True)[0].float().clone()
    plain_ms = (time.perf_counter() - t0) * 1e3
    abs_err = (ko - po).abs().max().item()
    print(f"spec verify step (widths {wid.tolist()}, lengths "
          f"{lens.tolist()}): kernel {ms:.4f} ms, bound {bms:.4f} ms ({by}: "
          f"{moved / 1e9:.3f} GB, {flops / 1e9:.2f} GFLOP), plain walk "
          f"{plain_ms:.1f} ms (paced by the host), kernel vs plain "
          f"{_rel_err(ko, po):.3e} of max |ref| ({abs_err:.3e} abs) | {smi}")
    assert _rel_err(ko, po) <= MK_BF16_TOL
    # perf_model constants at this state
    nb, _, blk, mp, _ = prog.paged
    trash = (prog.graph.caches["l0.k_pool"].rows // blk - nb
             + np.arange(nb)[:, None] + np.zeros((1, mp), np.int64)
             ).astype(np.int32)
    ms0 = time_ms([lambda: prog.step(cache_lens=np.zeros(nb, np.int32),
                                     block_table=trash, widths=wid)])
    prog.check_fault()
    attn_elems = 4 * L * int((wid * lens).sum()) * H * D
    stage_s = _stage_latency_s(prog.device, prog.dtype)
    ref = ref_cache()

    def eng_step():
        ref.seq_lens[:] = lens
        model.verify_step_paged(params, cands, ref, mask, counts)

    for _ in range(2):
        eng_step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        eng_step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(walls)
    busy_ms = profile_steps("[spec engine verify]", eng_step, 3, wall_ms)
    with OpCount() as ops:
        eng_step()
    torch.cuda.synchronize()
    del ref
    param = pm._decode_param_bytes(L, cfg.hidden_size, cfg.intermediate_size,
                                   H, Hkv, D)
    kv_s = pm.estimate_decode_step_s(int(lens.sum()), Hkv, D, L)
    util = min(1.0, B * Hkv / prog.n_sm)
    w = params["layers"]["w_gate_up"][0]
    xs = [torch.randn((n, w.shape[0]), device=w.device).to(w.dtype)
          for n in (B, B * K)]
    mm = [time_ms([lambda: torch.mm(x, w)], reps=50) for x in xs]
    extra = 2.0 * B * (K - 1) * w.shape[0] * w.shape[1]
    consts = {
        "STAGE_LATENCY_S": stage_s,
        "MK_BOUND_SHARE": bms / ms,
        "ATTN_ELEMS_PER_S": attn_elems / ((ms - ms0) * 1e-3),
        "ENGINE_BOUND_SHARE": (param / PEAK_BYTES + kv_s / util)
        / (busy_ms * 1e-3),
        "ENGINE_HOST_S": (wall_ms - busy_ms) * 1e-3,
        "SKINNY_MM_SHARE": min(1.0, extra / max(mm[1] - mm[0], 1e-6)
                               / 1e-3 / PEAK_BF16_FLOPS),
    }
    print(f"spec engine verify step: {wall_ms:.2f} ms wall, {busy_ms:.3f} ms "
          f"device-busy, {ops.n} aten ops; megakernel verify step at lengths "
          f"0 {ms0:.4f} ms (the prefix attention ~{ms - ms0:.4f} ms); "
          f"torch.mm at {B} / {B * K} rows of w_gate_up {mm[0] * 1e3:.1f} / "
          f"{mm[1] * 1e3:.1f} us")
    print("perf_model constants (" + smi + "): " + ", ".join(
        f"{k}={v:.6g}" for k, v in consts.items()))
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "abs_err": abs_err}


def _serve_line(tag, st, tick_ms, ops, launches, stream, smi):
    dec = st["tokens"] - len(stream)
    print(f"{tag}: {st['tokens']} tokens in {st['wall_s']:.3f} s "
          f"({st['tokens_per_s']} tokens/s), {st['ticks']} ticks, "
          f"{st['decode_steps']} decode ticks at "
          f"{statistics.median(tick_ms):.2f} ms median "
          f"({min(tick_ms):.2f}-{max(tick_ms):.2f}; {ops} aten ops), "
          f"{dec / st['decode_steps']:.3f} tokens a decode tick, spec "
          f"proposed / accepted / rejected {st['spec_proposed']} / "
          f"{st['spec_accepted']} / {st['spec_rejected']} (acceptance "
          f"{st['acceptance_rate']}), rollback blocks "
          f"{st['rollback_blocks']}, fallbacks {st['spec_fallbacks']}, "
          f"launches {({n: c for n, c in launches.items() if c})} | {smi}")


def _check_stream_run(models, se, out, st, stream, vocab):
    assert sorted(out) == list(range(len(stream)))
    for rid, (_, gen_len) in enumerate(stream):
        assert len(out[rid]) == gen_len, (rid, len(out[rid]))
        assert ((out[rid] >= 0) & (out[rid] < vocab)).all()
    se._cache.check_conservation(cached=st["cached_free_blocks"])
    assert st["free_blocks"] + st["cached_free_blocks"] == 64, st


def check_spec_serve(models, attn, gg, model, params, cfg, seed, smi):
    """Slice 2b's main path at full width: the serve cell's stream behind
    speculative decoding over the Qwen3-8B weights. In engine mode, then
    in megakernel mode (slot_rows 8): a spec-off run; a spec-on run with
    an OracleDrafter over its tokens (every third draft wrong, k 4, no
    adaptation), whose stream may part from the spec-off one at a bf16
    near-tie (M=1 and M=K GEMMs round differently), after which its
    drafts miss; then the same oracle over that spec-on run's own tokens,
    which keeps its dialed acceptance; in megakernel mode then
    speculative=True (the n-gram drafter, the H100 width chooser) and the
    second oracle over an int8 pool. Each run: every request at its
    length, block conservation, exact launch counts (run_serve: a
    megakernel verify tick is one launch and no flash_decode_paged; an
    engine verify tick one flash_decode_paged a layer), accepts and
    rejects for the oracle runs; tokens against the spec-off run as
    information; the teacher-forced and timing checks of
    `_spec_verify_checks` at the first all-slots verify of the first
    megakernel oracle run. Returns (launch totals of the spec-on runs,
    megakernel verify launches, the verify entry's numbers)."""
    L, V = cfg.num_layers, cfg.vocab_size
    stream = serve_stream(np.random.RandomState(seed), V)
    kw = dict(b_max=4, max_len=2048, block=128, prefill_chunk=256,
              num_blocks=64)
    total, mk_launches, entry = {}, 0, None
    runs = [("engine", "off"), ("engine", "oracle"), ("engine", "again"),
            ("megakernel", "off"), ("megakernel", "oracle"),
            ("megakernel", "again"), ("megakernel", "ngram"),
            ("megakernel", "int8")]
    for mode, kind in runs:
        if kind == "off":
            se = models.ServeEngine(model, params, mode=mode, **kw)
            off, st0, _, tick0, _ = run_serve(models, attn, se, stream, L, gg)
            _check_stream_run(models, se, off, st0, stream, V)
            print(f"spec serve[{mode}, spec-off]: {st0['tokens_per_s']} "
                  f"tokens/s, median decode tick "
                  f"{statistics.median(tick0):.2f} ms | {smi}")
            targets = off
            continue
        spec = True if kind == "ngram" else _oracle_spec(models, targets,
                                                         stream, V)
        se = models.ServeEngine(
            model, params, mode=mode, **kw, speculative=spec,
            kv_dtype="int8" if kind == "int8" else None,
            mk_opts={"slot_rows": 8} if mode == "megakernel" else None)
        snap = _verify_snapshot(se) if (mode, kind) == ("megakernel",
                                                        "oracle") else None
        out, st, launches, tick_ms, ops = run_serve(models, attn, se, stream,
                                                    L, gg)
        for n, c in launches.items():
            total[n] = total.get(n, 0) + c
        tag = f"spec serve[{mode}, " + {
            "oracle": "oracle over spec-off", "again": "oracle over spec-on",
            "ngram": "speculative=True",
            "int8": "oracle over spec-on, int8"}[kind] + "]"
        _serve_line(tag, st, tick_ms, ops, launches, stream, smi)
        _check_stream_run(models, se, out, st, stream, V)
        if mode == "megakernel":
            assert launches["megakernel"] == st["decode_steps"] > 0
            mk_launches += launches["megakernel"]
        else:
            assert launches["flash_decode_paged[bfloat16]"] \
                == L * st["decode_steps"] > 0
        if kind != "ngram":
            assert st["spec_accepted"] > 0 and st["spec_rejected"] > 0, st
        rep = models.serve.banded_token_identity(off, out, band=1.0)
        print(f"{tag} vs spec-off (information only, bf16 random weights): "
              f"agreed {rep['agreed_steps']}/{rep['total_steps']} steps "
              f"({rep['agreed_frac']}); tokens/s spec-on "
              f"{st['tokens_per_s']} vs spec-off {st0['tokens_per_s']}; "
              f"median decode tick {statistics.median(tick_ms):.2f} vs "
              f"{statistics.median(tick0):.2f} ms")
        if kind == "oracle":
            targets = out
        if snap is not None:
            assert snap, "no all-slots verify tick"
            entry = _spec_verify_checks(se, snap, model, params, cfg, smi)
        del se
        torch.cuda.empty_cache()
    return total, mk_launches, entry


def check_spec_serve_moe(models, attn, gg, model, params, cfg, seed, smi,
                         targets):
    """Speculative megakernel serving over the Qwen3-30B-A3B weights: the
    serve cell's stream with an OracleDrafter over the megakernel
    spec-off tokens (`targets`), k 4, then over that run's tokens with k 2
    under ep_capacity=2 (the budget must be at least k). The GROUPED_GEMM tasks run at widths
    > 1, every request gets its full length, one launch a verify tick;
    the verify step at the first all-slots verify against its bound
    with the launch's routed slabs. Returns (launch totals, megakernel
    launches)."""
    L, V = cfg.num_layers, cfg.vocab_size
    stream = serve_stream(np.random.RandomState(seed), V)
    total, mk_launches = {}, 0
    for cap, k in ((0, SPEC_K), (2, 2)):
        se = models.ServeEngine(
            model, params, mode="megakernel", b_max=4, max_len=2048,
            block=128, prefill_chunk=256, num_blocks=64, ep_capacity=cap,
            speculative=_oracle_spec(models, targets, stream, V, k=k))
        widths = []
        snap = _verify_snapshot(se, widths)
        out, st, launches, tick_ms, ops = run_serve(models, attn, se, stream,
                                                    L, gg)
        for n, c in launches.items():
            total[n] = total.get(n, 0) + c
        mk_launches += launches["megakernel"]
        tag = f"spec mk-moe-serve[k {k}" + (f", ep_capacity={cap}]" if cap
                                             else "]")
        _serve_line(tag, st, tick_ms, ops, launches, stream, smi)
        _check_stream_run(models, se, out, st, stream, V)
        assert launches["megakernel"] == st["decode_steps"] == len(widths)
        assert st["spec_accepted"] > 0 and st["spec_rejected"] > 0, st
        wmax = max(int(w.max()) for w in widths)
        print(f"{tag}: GROUPED_GEMM widths up to {wmax}, "
              f"{sum(int((w > 1).sum()) for w in widths)} slot-launches at "
              f"width > 1, capacity_drops {st['capacity_drops']}")
        assert wmax > 1
        if cap:
            assert st["capacity_drops"] > 0 and all(
                int(w.sum()) <= cap for w in widths), st
        else:
            assert snap, "no all-slots verify tick"
            targets = out         # the capacity run drafts from these
            mk, prog = se._mk, se._mk.prog
            del mk.verify, prog.step
            lens, mask = snap["lens"], snap["mask"]
            wid = np.where(mask, snap["counts"], 0).astype(np.int32)
            ktab = mk.kernel_table(torch.from_numpy(snap["table"]),
                                   torch.from_numpy(mask))
            ms = time_ms([lambda: prog.step(cache_lens=lens, block_table=ktab,
                                            widths=wid)])
            prog.check_fault()
            routed = prog.routed_experts(wid)
            costs = prog.task_costs(cache_lens=lens, widths=wid,
                                    experts=routed)
            moved = sum(c["bytes"] for c in costs)
            bms, by = bound(moved, sum(c["flops"] for c in costs))
            per_layer = [len(v) for v in routed.values()]
            print(f"spec mk-moe-serve verify step (widths {wid.tolist()}, "
                  f"lengths {lens.tolist()}): kernel {ms:.4f} ms, bound "
                  f"{bms:.4f} ms ({by}: {moved / 1e9:.3f} GB with "
                  f"{min(per_layer)}-{max(per_layer)} routed slabs a layer, "
                  f"mean {statistics.mean(per_layer):.1f}) | {smi}")
        del se, snap
        torch.cuda.empty_cache()
    return total, mk_launches


def check_spec_small(models, seed):
    """A small model's speculative serving on the GPU against the same
    engine on the CPU, in engine and in megakernel mode (bf16: the
    engine path's prefill and paged decode kernels take bf16 only), with
    an OracleDrafter over the CPU's spec-off tokens: every greedy call's
    logits within 5e-2 of the largest, every greedy pick equal (the
    streams do not part at this seed), the spec counters equal to the
    CPU run's, and the GPU's spec-on tokens equal to its spec-off
    tokens."""
    from triton_distributed_tpu_torch.megakernel import serve as mserve
    from triton_distributed_tpu_torch.models import dense
    cfg = models.get_config("Qwen/Qwen3-8B").tiny(
        hidden_size=256, num_heads=8, num_kv_heads=2, head_dim=128,
        intermediate_size=512, vocab_size=512, num_layers=2)
    cpu = models.DenseLLM(cfg, dtype="bfloat16", device="cpu")
    params = cpu.init_params(torch.Generator().manual_seed(seed))
    gpu = models.DenseLLM(cfg, dtype="bfloat16", device="cuda")
    gparams = _to_device(params, "cuda")
    rng = np.random.RandomState(seed)
    stream = [(rng.randint(0, 512, n).astype(np.int32), g)
              for n, g in ((37, 9), (5, 12), (20, 6), (16, 8))]
    kw = dict(b_max=2, max_len=64, block=32, prefill_chunk=8)
    real = dense.greedy_token
    for mode in ("engine", "megakernel"):
        off = models.ServeEngine(cpu, params, mode=mode, **kw).serve(
            [r for r, _ in stream], [g for _, g in stream])
        gpu_off = models.ServeEngine(gpu, gparams, mode=mode, **kw).serve(
            [r for r, _ in stream], [g for _, g in stream])
        runs, stats, toks = [], [], []
        for m, p in ((cpu, params), (gpu, gparams)):
            seen = []

            def spy(x, lm_head):
                seen.append((x.float() @ lm_head.float()).cpu())
                return real(x, lm_head)

            dense.greedy_token = mserve.greedy_token = spy
            try:
                se = models.ServeEngine(m, p, mode=mode, **kw,
                                        speculative=_oracle_spec(
                                            models, dict(enumerate(off)),
                                            stream, 512))
                toks.append(se.serve([r for r, _ in stream],
                                     [g for _, g in stream]))
            finally:
                dense.greedy_token = mserve.greedy_token = real
            runs.append(seen)
            stats.append(se.stats())
        assert len(runs[0]) == len(runs[1]), (len(runs[0]), len(runs[1]))
        for k, (c, g) in enumerate(zip(*runs)):
            assert c.shape == g.shape, k
            err = (g - c).abs().max().item()
            assert err <= 5e-2 * max(1.0, c.abs().max().item()), (k, err)
            assert torch.equal(g.argmax(-1), c.argmax(-1)), k
        keys = ("spec_proposed", "spec_accepted", "spec_rejected",
                "rollback_blocks", "decode_steps")
        assert all(stats[0][k] == stats[1][k] for k in keys), stats
        assert stats[1]["spec_accepted"] > 0 and stats[1]["spec_rejected"] > 0
        assert all(np.array_equal(a, b) for a, b in zip(toks[1], toks[0]))
        assert all(np.array_equal(a, b) for a, b in zip(toks[1], gpu_off))
        print(f"small spec ServeEngine[{mode}] bf16 GPU vs CPU: "
              f"{len(runs[1])} greedy calls, streams equal, spec counters "
              f"equal { {k: stats[1][k] for k in keys} }; GPU spec-on "
              f"tokens equal GPU spec-off in all {len(stream)} requests")


def check_attention_group8(attn, dev, gen, entries):
    """GQA group 8 (32 q heads over 4 kv heads, Qwen3-30B-A3B) through
    the three attention kernels against their plain versions; the
    errors join each kernel's max_abs_err."""
    B, H, Hkv, D = 4, 32, 4, 128
    rnd = lambda *shape: torch.randn(shape, generator=gen,   # noqa: E731
                                     device=dev).bfloat16()
    q, k, v = rnd(B, 512, H, D), rnd(B, 512, Hkv, D), rnd(B, 512, Hkv, D)
    out = attn.flash_attention(q, k, v, causal=True)
    ref, _ = attn._flash_attention_plain(q, k, v, 0, 0, 512, causal=True,
                                         scale=D ** -0.5)
    errs = {"flash_attention": (out.float() - ref.float()).abs().max().item()}
    q1, kc, vc = rnd(B, H, D), rnd(B, 1024, Hkv, D), rnd(B, 1024, Hkv, D)
    kv_len = torch.tensor([501, 0, 17, 531], dtype=torch.int32, device=dev)
    out, lse = attn.flash_decode_partial(q1, kc, vc, kv_len)
    ref, ref_lse = attn._flash_decode_plain(q1, kc, vc, kv_len,
                                            scale=D ** -0.5)
    errs["flash_decode"] = (out.float() - ref.float()).abs().max().item()
    le = (lse - ref_lse).abs().max().item()
    nb, mb, blk = 64, 16, 128
    tab = torch.from_numpy(_paged_table(np.random.RandomState(2),
                                        [2, 7, 12, 1], nb, mb)).to(dev)
    kp, vp = rnd(nb, Hkv, blk, D), rnd(nb, Hkv, blk, D)
    kv_len = torch.tensor([130, 700, 1500, 0], dtype=torch.int32, device=dev)
    out, lse = attn.flash_decode_paged_partial(q1, kp, vp, tab, kv_len)
    ref, ref_lse = attn._flash_decode_paged_plain(q1, kp, vp, tab, kv_len,
                                                  scale=D ** -0.5)
    errs["flash_decode_paged[bfloat16]"] = (
        out.float() - ref.float()).abs().max().item()
    le = max(le, (lse[:3] - ref_lse[:3]).abs().max().item())
    print(f"attention at GQA group 8 (H {H}, Hkv {Hkv}): max_abs_err "
          + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
          + f"; lse {le:.3e}")
    assert max(errs.values()) <= OUT_TOL and le <= LSE_TOL, (errs, le)
    for e in entries:
        if e["name"] in errs:
            e["max_abs_err"] = max(e["max_abs_err"], errs[e["name"]])


def _grouped_mm_ms(lhs, ws, disp, bm):
    """torch._grouped_mm over the same aligned rows (groups ending at the
    aligned offsets), a yardstick only: (ms, None) or (None, reason)."""
    if not hasattr(torch, "_grouped_mm"):
        return None, "this torch has no torch._grouped_mm"
    offs = torch.cumsum((disp.group_sizes + bm - 1) // bm * bm, 0,
                        dtype=torch.int32)
    fns = [lambda w=w: torch._grouped_mm(lhs, w, offs=offs) for w in ws]
    try:
        fns[0]()
        torch.cuda.synchronize()
    except RuntimeError as e:     # refused shapes or layouts: no yardstick
        return None, f"torch._grouped_mm refused: {str(e)[:160]}"
    return time_ms(fns), None


def check_gmm(dev, gen):
    """The grouped GEMM kernel against its plain version at Qwen3-30B-A3B
    shapes (E 128, top-8, block_m 128), bf16, for both projections under
    the decode (4 rows) and prefill (2048 rows) routing of a seeded
    router over random rows. Returns the kernels-line entry, timed on
    the decode gate_up call (31 of every 32 main-path calls are decode
    calls)."""
    from triton_distributed_tpu_torch.ops import grouped_gemm as gg
    from triton_distributed_tpu_torch.ops import moe_utils as mu
    E, top_k, H, I, bm = 128, 8, 2048, 768, 128
    cfg = gg.GroupedGemmConfig(block_m=bm)
    router = torch.randn((H, E), generator=gen, device=dev) * H ** -0.5

    def slabs(K, N):      # two copies: the live slabs exceed L2 between runs
        return [torch.randn((E, K, N), generator=gen, device=dev,
                            dtype=torch.bfloat16).mul_(K ** -0.5)
                for _ in range(2)]

    w_gu, w_dn = slabs(H, 2 * I), slabs(I, H)
    entry, err_all = None, 0.0
    for route, M in (("decode", 4), ("prefill", 2048)):
        x = torch.randn((M, H), generator=gen, device=dev).bfloat16()
        weights, experts = mu.route_topk(x.float() @ router, top_k)
        disp = mu.sort_tokens_by_expert(experts, E, bm)
        gs = disp.group_sizes
        P = disp.gather_token.shape[0]
        pad = disp.sorted_assignment == M * top_k
        live_e, rows = int((gs > 0).sum()), M * top_k
        xs = mu.gather_sorted(x, disp)
        g_ms = time_ms([lambda: mu.gather_sorted(x, disp)])
        live_t = int(((gs + bm - 1) // bm).sum())
        print(f"gmm {route}: {M} rows x top-{top_k} -> {rows} rows on "
              f"{live_e} experts, P {P} ({P // bm} tiles, {live_t} live); "
              f"gather_sorted (P, {H}) {g_ms:.4f} ms")
        act = torch.randn((P, I), generator=gen, device=dev).bfloat16()
        act[pad] = 0                            # pad rows are zero rows
        for proj, lhs, ws in (("gate_up", xs, w_gu), ("down", act, w_dn)):
            K, N = ws[0].shape[1:]
            out = gg.gmm(lhs, ws[0], disp.tile_expert, config=cfg,
                         group_sizes=gs)
            ref = gg._gmm_plain(lhs, ws[0], disp.tile_expert, bm)
            err = (out.float() - ref.float()).abs().max().item()
            rel = err / ref.float().abs().max().item()
            assert torch.isfinite(out.float()).all() and \
                torch.all(out[pad] == 0), (route, proj)
            assert rel <= GMM_TOL, (route, proj, rel)
            err_all = max(err_all, err)
            ms = time_ms([lambda w=w: gg.gmm(lhs, w, disp.tile_expert,
                                             config=cfg, group_sizes=gs)
                          for w in ws])
            plain_ms = time_ms([lambda w=w: gg._gmm_plain(
                lhs, w, disp.tile_expert, bm) for w in ws], reps=3, rounds=3)
            lib_ms, why = _grouped_mm_ms(lhs, ws, disp, bm)
            moved = (live_e * K * N + rows * K + P * N) * 2
            bms, by = bound(moved, 2 * rows * K * N)
            lib = f"{lib_ms:.4f} ms" if lib_ms is not None else why
            print(f"gmm {route} {proj} (K {K}, N {N}): max_abs_err {err:.3e}"
                  f" ({rel:.3e} of max |plain|); kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, torch._grouped_mm {lib}, bound "
                  f"{bms:.4f} ms ({by}: {moved / 1e9:.3f} GB, "
                  f"{2 * rows * K * N / 1e9:.1f} GFLOP)")
            if route == "decode" and proj == "gate_up":
                entry = {"name": "gmm", "route": "cuda",
                         "source": "triton_distributed_tpu_torch/csrc/"
                                   "grouped_gemm.cu",
                         "replaces": "triton_distributed_tpu/ops/"
                                     "grouped_gemm.py:41",
                         "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                         "bound_by": by, "library_ms": lib_ms}
            del out, ref
    entry["max_abs_err"] = err_all
    return entry


def check_small_moe(models, gg, seed):
    """A small Qwen3MoE (hidden 256, 8 q heads over 1 kv head, head_dim
    128, 8 experts, top-2, block_m 16) on the GPU through the kernels
    against the same weights on the CPU through the plain versions, in
    bf16: prefill logits of the last rows, then one decode step from the
    CPU's greedy tokens."""
    from triton_distributed_tpu_torch.ops.moe_parallel import (
        MoEParallelConfig)
    cfg = models.get_config("Qwen/Qwen3-30B-A3B").tiny(
        hidden_size=256, num_heads=8, num_kv_heads=1, head_dim=128,
        vocab_size=512, num_layers=2, num_experts=8, num_experts_per_tok=2,
        moe_intermediate_size=256)
    mc = MoEParallelConfig(gemm=gg.GroupedGemmConfig(block_m=16))
    cpu = models.Qwen3MoE(cfg, dtype="bfloat16", device="cpu", moe_config=mc)
    params = cpu.init_params(torch.Generator().manual_seed(seed))
    gpu = models.Qwen3MoE(cfg, dtype="bfloat16", device="cuda",
                          moe_config=mc)
    gparams = _to_device(params, "cuda")
    ids = np.random.RandomState(seed).randint(0, cfg.vocab_size, (2, 37))
    before = gg.GMM.launches
    logits, tok = [], None
    for m, p in ((cpu, params), (gpu, gparams)):
        last, cache = m._prefill_hidden(p, ids, m.new_kv_cache(2, 64))
        pre = (last.float() @ p["lm_head"].float()).cpu()
        tok = pre.argmax(-1) if tok is None else tok
        x, _ = m._decode_hidden(p, tok.to(m.device), cache)
        logits.append((pre, (x.float() @ p["lm_head"].float()).cpu()))
    torch.cuda.synchronize()
    assert gg.GMM.launches == before + 2 * 2 * cfg.num_layers
    (cpre, cdec), (gpre, gdec) = logits
    _agree("small Qwen3MoE prefill", cpre, gpre)
    _agree("small Qwen3MoE decode step", cdec, gdec)
    assert torch.equal(gpre.argmax(-1), cpre.argmax(-1)), "first token"


def run_engine(models, kernels, model, params, cfg, ids, gen_len, smi,
               profile, name):
    """Engine(max_len=1024).serve with the launch counts of `kernels` set
    to 0 just before it and read just after; then start + step must
    reproduce its tokens, with prefill ms, decode tokens/s and the aten
    ops of one decode step. Returns (engine, tokens, launches)."""
    from triton_distributed_tpu_torch.models.engine import prompt_bucket
    B, S = ids.shape
    engine = models.Engine(model, params, max_len=1024)
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    toks = engine.serve(ids, gen_len)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {n: k.launches for n, k in kernels.items()}
    print(f"{name} Engine.serve: tokens {toks.shape}, {serve_s * 1e3:.1f} ms "
          f"(first call), launches {launches}")
    assert toks.shape == (B, gen_len) and toks.dtype == np.int32
    assert ((toks >= 0) & (toks < cfg.vocab_size)).all()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok, cache = engine.start(ids)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    steps = [tok]
    for _ in range(gen_len - 1):
        tok, cache = engine.step(tok, cache)
        steps.append(tok)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    stepwise = torch.stack(steps, dim=1).cpu().numpy()
    assert np.array_equal(stepwise, toks), "start+step differ from serve"
    prefill_ms = (t1 - t0) * 1e3
    decode_tps = B * (gen_len - 1) / (t2 - t1)
    print(f"{name} prefill ms {prefill_ms:.2f} (B={B}, S={S}, bucket "
          f"{prompt_bucket(S, 1024)}) | "
          f"decode tokens/s {decode_tps:.1f} (B={B}, {gen_len - 1} steps, "
          f"{(t2 - t1) / (gen_len - 1) * 1e3:.2f} ms/step) | {smi}")
    with OpCount() as ops:
        engine.step(tok, cache)
    torch.cuda.synchronize()
    print(f"{name} decode step: {ops.n} aten ops dispatched on the host "
          f"({ops.n / cfg.num_layers:.1f} per layer)")
    if profile:
        profile_decode(engine, tok, cache, (t2 - t1) / (gen_len - 1) * 1e3)
    return engine, toks, launches


def check_moe_engine(models, kernels, seed, smi, profile):
    """The slice-4 main path: Qwen3-30B-A3B at full width and depth with
    random bf16 weights behind Engine.serve. Returns (model, params,
    launches)."""
    cfg = models.get_config("Qwen/Qwen3-30B-A3B")
    model = models.Qwen3MoE(cfg, dtype="bfloat16", device="cuda")
    torch.cuda.reset_peak_memory_stats()
    params = model.init_params(torch.Generator(device="cuda").manual_seed(
        seed))
    torch.cuda.synchronize()
    print(f"Qwen3-30B-A3B: {cfg.num_layers} layers, hidden "
          f"{cfg.hidden_size}, heads {cfg.num_heads}/{cfg.num_kv_heads}, "
          f"{cfg.num_experts} experts top-{cfg.num_experts_per_tok} (moe "
          f"intermediate {cfg.moe_intermediate_size}), vocab "
          f"{cfg.vocab_size}; weights "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, peak while "
          f"drawing them {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    B, S, GEN, L = 4, 500, 32, cfg.num_layers
    ids = np.random.RandomState(seed + 7).randint(0, cfg.vocab_size, (B, S))
    torch.cuda.reset_peak_memory_stats()
    _, toks, launches = run_engine(models, kernels, model, params, cfg, ids,
                                   GEN, smi, profile, "moe")
    assert launches == {"flash_attention": L, "flash_decode": L * (GEN - 1),
                        "gmm": 2 * L * GEN}, launches
    print(f"moe: peak device memory of the engine runs "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # one MoE layer's decode forward never waits on the device
    p = {k: t[0] for k, t in params["layers"].items()}
    x = torch.randn((B, cfg.hidden_size), device="cuda").bfloat16()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = model.moe._shard_fwd(x, p["router"], p["w_moe_gate_up"],
                                 p["w_moe_down"], mode="ar")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(y.float()).all()
    print("moe: one MoE layer decode forward ran under "
          "set_sync_debug_mode('error'): no host synchronisation")
    return model, params, launches, ids, toks


def check_moe_serve(models, attn, gg, model, params, cfg, seed, smi):
    """ServeEngine over the Qwen3-30B-A3B weights with the serve cell's
    stream and settings (bf16 pool): checked as the Qwen3-8B bf16 run,
    then with ep_capacity=2. Returns the launch totals."""
    L = cfg.num_layers
    stream = serve_stream(np.random.RandomState(seed), cfg.vocab_size)
    total, first = {}, None
    for cap in (0, 0, 2):
        se = models.ServeEngine(model, params, b_max=4, max_len=2048,
                                block=128, prefill_chunk=256, num_blocks=64,
                                ep_capacity=cap)
        out, st, launches, tick_ms, ops = run_serve(models, attn, se, stream,
                                                    L, gg)
        for n, c in launches.items():
            total[n] = total.get(n, 0) + c
        print(f"moe serve[ep_capacity={cap}]: {st['tokens']} tokens in "
              f"{st['wall_s']:.3f} s ({st['tokens_per_s']} tokens/s), "
              f"{st['ticks']} ticks, {st['decode_steps']} decode steps at "
              f"{statistics.median(tick_ms):.2f} ms median "
              f"({min(tick_ms):.2f}-{max(tick_ms):.2f}; {ops} aten ops "
              f"on the host, {ops / L:.1f} per layer), "
              f"{st['prefill_chunks']} chunks ({st['prefix_chunks']} over a "
              f"cached prefix), prefix hits {st['prefix_hit_blocks']} blocks, "
              f"CoW {st['cow_copies']}, capacity_drops "
              f"{st['capacity_drops']}, ep_rows {st['ep_rows']}, ep_plan "
              f"{st['ep_plan']}, launches "
              f"{ {n: c for n, c in launches.items() if c} } | {smi}")
        assert sorted(out) == list(range(len(stream)))
        for rid, (_, gen_len) in enumerate(stream):
            assert len(out[rid]) == gen_len, (rid, len(out[rid]))
            assert ((out[rid] >= 0) & (out[rid] < cfg.vocab_size)).all()
        se._cache.check_conservation(cached=st["cached_free_blocks"])
        assert st["free_blocks"] + st["cached_free_blocks"] == 64, st
        if cap:
            assert st["capacity_drops"] > 0, st
            assert st["ep_rows"] == sum(g - 1 for _, g in stream), st
            rep = models.serve.banded_token_identity(first, out, band=1.0)
            print(f"moe serve[ep_capacity={cap}] vs unbudgeted (information "
                  f"only: bf16, other batch compositions): agreed "
                  f"{rep['agreed_steps']}/{rep['total_steps']} steps")
        elif first is None:
            assert st["prefix_hit_blocks"] > 0 and st["cow_copies"] > 0, st
            assert st["capacity_drops"] == 0 and st["ep_rows"] == 0, st
            first = out
        else:
            for rid in out:
                assert np.array_equal(out[rid], first[rid]), rid
            print("moe serve: a second run gives identical tokens")
    return total, first


def _tp_shapes(n):
    """The tp-engine cell's calls at n ranks (Qwen3-8B, 4 prompts bucketed
    to 512 tokens: 2048 rows): (op, name, M, K, N) with M the rows of the
    product (ag_gemm: all ranks' rows), K and N per rank where sharded."""
    rows, H, qkv, inter = 2048, 4096, (32 + 2 * 8) * 128, 12288
    return [("ag_gemm", "qkv", rows, H, qkv // n),
            ("ag_gemm", "gate_up", rows, H, 2 * inter // n),
            ("gemm_rs", "o", rows, 32 * 128 // n, H),
            ("gemm_rs", "down", rows, inter // n, H),
            ("gemm_ar", "o decode M 1", 1, 32 * 128 // n, H),
            ("gemm_ar", "o decode M 4", 4, 32 * 128 // n, H),
            ("gemm_ar", "down decode M 4", 4, inter // n, H),
            ("gemm_ar", "down prefill", rows, inter // n, H)]


def _tp_shapes_14b(n):
    """Qwen3-14B's calls at n ranks (hidden 5120, 40 q / 8 kv heads,
    intermediate 17408), whose K (1280 and 4352 at n = 4) is no multiple of
    the JAX op's 512-deep tile, and gemm_ar at 192 rows, no multiple of its
    128-row tile: the CUDA kernels mask ragged tiles and take them all."""
    rows, H, qkv, inter = 2048, 5120, (40 + 2 * 8) * 128, 17408
    return [("ag_gemm", "14B qkv", rows, H, qkv // n),
            ("gemm_rs", "14B o", rows, 40 * 128 // n, H),
            ("gemm_rs", "14B down", rows, inter // n, H),
            ("gemm_ar", "14B down decode M 4", 4, inter // n, H),
            ("gemm_ar", "14B o M 192", 192, 40 * 128 // n, H)]


def _tp_operands(op, n, M, K, N, dtype, gen, dev):
    rows = M // n if op == "ag_gemm" else M
    a = torch.randn((n, rows, K), generator=gen, device=dev).div_(K ** 0.5)
    b = torch.randn((n, K, N), generator=gen, device=dev)
    return a.to(dtype), b.to(dtype)


def _tp_bound(op, n, M, K, N, itemsize):
    """(bytes, flops) the call needs: each input read once, each output
    written once, the landing writes and reads counted once each."""
    if op == "ag_gemm":
        m = M // n
        moved = (n * m * K + n * K * N + n * M * N
                 + 2 * n * (n - 1) * m * K)
        return moved * itemsize, 2 * n * M * K * N
    out = M * N if op == "gemm_rs" else n * M * N
    land = n * M * N if op == "gemm_rs" else n * n * M * N
    return (n * M * K + n * K * N + out + 2 * land) * itemsize, \
        2 * n * M * K * N


def _tp_library_ms(op, a, b):
    """One PyTorch call computing the same function (a yardstick only)."""
    if op == "ag_gemm":
        full = a.reshape(-1, a.shape[-1])
        return time_ms([lambda: torch.matmul(full, b)])
    return time_ms([lambda: torch.einsum("rmk,rkn->mn", a, b)])


def check_tp_kernels(dev, gen):
    """The tensor-parallel kernels (csrc/ag_gemm.cu, gemm_rs.cu,
    gemm_ar.cu) against their plain versions at the tp-engine cell's
    shapes, at n = 2 and 4, bf16 and f32: two calls back to back with
    different data (the second must not pass on stale signals), gemm_ar's
    replicas bit for bit equal, every call logged "kernel"; at n = 4 in
    bf16 the kernel's, the plain version's and the library call's times
    against the bound; then one call each at Qwen3-14B's widths
    (_tp_shapes_14b). Returns the kernels-line entries (timed on the call
    each kernel makes most on the main path's cell: gate_up, down, and the
    decode down projection at M 4)."""
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import _common
    from triton_distributed_tpu_torch.ops import ag_gemm as ag
    from triton_distributed_tpu_torch.ops import gemm_ar as ar
    from triton_distributed_tpu_torch.ops import gemm_rs as rs
    ops = {"ag_gemm": (ag.ag_gemm_shard, ag._ag_gemm_plain, ag.AG_GEMM,
                       "triton_distributed_tpu/ops/ag_gemm.py:65"),
           "gemm_rs": (rs.gemm_rs_shard, rs._gemm_rs_plain, rs.GEMM_RS,
                       "triton_distributed_tpu/ops/gemm_rs.py:68"),
           "gemm_ar": (ar.gemm_ar_shard, ar._gemm_ar_plain, ar.GEMM_AR,
                       "triton_distributed_tpu/ops/gemm_ar.py:60")}
    timed = {"ag_gemm": "gate_up", "gemm_rs": "down",
             "gemm_ar": "down decode M 4"}
    entries = {op: {"name": op, "route": "cuda",
                    "source": f"triton_distributed_tpu_torch/csrc/{op}.cu",
                    "replaces": ops[op][3], "max_abs_err": 0.0}
               for op in ops}
    t0 = time.perf_counter()

    def call(op, name, n, M, K, N, dtype):
        """One call of the op on new data, held against its plain version:
        launched once, logged "kernel", within TP_TOL."""
        fn, plain, kern, _ = ops[op]
        a, b = _tp_operands(op, n, M, K, N, dtype, gen, dev)
        _common.reset_dispatch()
        before = kern.launches
        got = fn(a, b, num_ranks=n)
        torch.cuda.synchronize()
        shmem.check_faults()
        assert kern.launches == before + 1, (op, name)
        assert _common.dispatch_counts() == {
            (op, "kernel", ""): 1}, _common.dispatch_counts()
        want = plain(a, b)
        err = (got.float() - want.float()).abs().max().item()
        rel = err / want.float().abs().max().item()
        assert torch.isfinite(got.float()).all(), (op, name)
        assert rel <= TP_TOL[dtype], (op, name, n, dtype, rel)
        if op == "gemm_ar":
            assert all(torch.equal(got[r], got[0])
                       for r in range(n)), (name, n)
        if dtype == torch.bfloat16:
            entries[op]["max_abs_err"] = max(entries[op]["max_abs_err"], err)
        return a, b, got, want, err, rel

    for n in (2, TP_RANKS):
        for dtype in (torch.bfloat16, torch.float32):
            for op, name, M, K, N in _tp_shapes(n):
                fn, plain, kern, _ = ops[op]
                for _ in range(2):          # new data each call
                    a, b, got, want, err, rel = call(op, name, n, M, K, N,
                                                     dtype)
                print(f"tp {op} {name} n {n} {str(dtype)[6:]} (M {M}, K {K}, "
                      f"N {N}): kernel vs plain {err:.3e} ({rel:.3e} of the "
                      f"largest), two calls back to back")
                if n != TP_RANKS or dtype != torch.bfloat16:
                    continue
                ms = time_ms([lambda: fn(a, b, num_ranks=n)])
                plain_ms = time_ms([lambda: plain(a, b)], reps=3, rounds=3)
                lib_ms = _tp_library_ms(op, a, b)
                if op == "ag_gemm":      # information: the tile's k order
                    same = torch.equal(got, torch.matmul(
                        a.reshape(-1, K), b))
                    print(f"tp {op} {name}: kernel bit for bit equal to "
                          f"torch.matmul of the gathered A: {same}")
                nb, fl = _tp_bound(op, n, M, K, N, 2)
                bms, by = bound(nb, fl)
                print(f"tp {op} {name} n {n} bf16: kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
                      f"{bms:.4f} ms ({by}: {nb / 1e9:.3f} GB, "
                      f"{fl / 1e9:.1f} GFLOP; {fl / ms / 1e9:.1f} TFLOP/s)")
                if name == timed[op]:
                    entries[op].update(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                       bound_by=by, library_ms=lib_ms)
                del got, want
    for op, name, M, K, N in _tp_shapes_14b(TP_RANKS):
        *_, err, rel = call(op, name, TP_RANKS, M, K, N, torch.bfloat16)
        print(f"tp {op} {name} n {TP_RANKS} bf16 (M {M}, K {K}, N {N}): "
              f"kernel vs plain {err:.3e} ({rel:.3e} of the largest)")
    print(f"tp kernels: phase {time.perf_counter() - t0:.1f} s")
    return [entries[op] for op in ops]


def check_tp_fault(dev, gen):
    """A planted fault in each tensor-parallel kernel: its C entry called
    with a signal target one epoch ahead. The fault word must be set
    within the wait budget (plus launch and copy time), the check must
    raise naming the rank, and the next normal call must run clean."""
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import ag_gemm as ag
    from triton_distributed_tpu_torch.ops import gemm_ar as ar
    from triton_distributed_tpu_torch.ops import gemm_rs as rs
    n = TP_RANKS
    for op, mod, fn, plain in (
            ("ag_gemm", ag, ag.ag_gemm_shard, ag._ag_gemm_plain),
            ("gemm_rs", rs, rs.gemm_rs_shard, rs._gemm_rs_plain),
            ("gemm_ar", ar, ar.gemm_ar_shard, ar._gemm_ar_plain)):
        a, b = _tp_operands(op, n, 512, 1024, 512, torch.bfloat16, gen, dev)
        fn(a, b, num_ranks=n)
        ws, _ = mod._workspace(a, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod._launch(a, b, epoch=ws.epoch + 2)
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        assert int(ws.fault[0]) == shmem.FAULT_TIMEOUT, op
        assert took < shmem.WAIT_BUDGET_S + 2.0, (op, took)
        try:
            shmem.check_faults()
            raise AssertionError(f"{op}: the planted fault did not raise")
        except RuntimeError as e:
            msg = str(e)
        assert msg.startswith(f"{op}: rank ") and "timed out" in msg, msg
        got = fn(a, b, num_ranks=n)
        torch.cuda.synchronize()
        shmem.check_faults()
        assert _rel_err(got.float(), plain(a, b).float()) <= \
            TP_TOL[torch.bfloat16], op
        print(f"tp {op} planted fault: raised after {took:.3f} s (budget "
              f"{shmem.WAIT_BUDGET_S} s): {msg}; the next call ran clean")


def check_small_tp_model(models, seed):
    """A small Qwen3-shaped model at n = 2 (head_dim 128, 8 q / 2 kv heads:
    4 / 1 a rank) on the GPU through the kernels against the same weights
    on the CPU through the plain versions, in every mode, bf16 (the
    engine path's attention kernels take bf16 only): prefill logits and
    one decode step's logits (from the CPU's greedy tokens) within 5e-2 of
    the largest, greedy tokens equal wherever the margin allows; the fused
    modes launch their kernels."""
    from triton_distributed_tpu_torch.ops import ag_gemm as ag
    from triton_distributed_tpu_torch.ops import gemm_ar as ar
    from triton_distributed_tpu_torch.ops import gemm_rs as rs
    cfg = models.get_config("Qwen/Qwen3-8B").tiny(
        hidden_size=256, num_heads=8, num_kv_heads=2, head_dim=128,
        intermediate_size=512, vocab_size=512, num_layers=2)
    one = models.DenseLLM(cfg, dtype="bfloat16", device="cpu")
    base = one.init_params(torch.Generator().manual_seed(seed))
    ids = np.random.RandomState(seed).randint(0, cfg.vocab_size, (2, 37))
    kernels = (ag.AG_GEMM, rs.GEMM_RS, ar.GEMM_AR)
    for mode in ("xla", "fused", "ar", "gemm_ar"):
        cpu = models.DenseLLM(cfg, mode=mode, dtype="bfloat16", device="cpu",
                              num_ranks=2)
        gpu = models.DenseLLM(cfg, mode=mode, dtype="bfloat16", device="cuda",
                              num_ranks=2)
        params = cpu.shard_params(base)
        before = [k.launches for k in kernels]
        logits, tok = [], None
        for m in (cpu, gpu):
            p = params if m is cpu else _to_device_tree(params, "cuda")
            last, cache = m._prefill_hidden(p, ids, m.new_kv_cache(2, 64))
            pre = _full_logits(last, p["lm_head"]).cpu()
            tok = pre.argmax(-1) if tok is None else tok
            x, _ = m._decode_hidden(p, tok.to(m.device), cache)
            logits.append((pre, _full_logits(x, p["lm_head"]).cpu()))
        torch.cuda.synchronize()
        ran = [k.launches - b for k, b in zip(kernels, before)]
        want = {"fused": [4, 4, 0], "gemm_ar": [0, 0, 8]}.get(mode, [0, 0, 0])
        assert ran == want, (mode, ran)
        for which, ref, got in zip(("prefill", "decode"), logits[0],
                                   logits[1]):
            _agree(f"small TP model n 2 {mode} {which}", ref, got)
    # a fault in the "gemm_ar" decode step's workspace: Engine.step raises
    # before a token leaves; start + step run clean after the reset
    from triton_distributed_tpu_torch import shmem
    eng = models.Engine(gpu, _to_device_tree(params, "cuda"), max_len=128)
    tok, cache = eng.start(ids)
    shmem.release_workspaces()
    tok, cache = eng.step(tok, cache)        # allocates the decode workspace
    (ws,) = shmem.primitives._WORKSPACES.values()
    ws.fault[0] = shmem.FAULT_TIMEOUT
    try:
        eng.step(tok, cache)
        raise AssertionError("Engine.step handed back a token after a fault")
    except RuntimeError as e:
        msg = str(e)
    assert msg.startswith("gemm_ar: rank ") and "timed out" in msg, msg
    tok, cache = eng.start(ids)
    tok, _ = eng.step(tok, cache)
    assert tok.shape == (2,) and int(tok.max()) < cfg.vocab_size
    print(f"small TP model n 2 gemm_ar: Engine.step raised on a fault planted "
          f"in its decode workspace ({msg}); start + step then ran clean")


def _to_device_tree(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device_tree(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _full_logits(x, lm_head):
    """f32 logits (B, V) from the last hidden rows, against a one-rank
    (H, V) or a rank-stacked (n, H, V / n) lm_head."""
    if lm_head.dim() == 3:
        lm_head = torch.cat(list(lm_head), dim=1)
    return x.float() @ lm_head.float()


def _forced_logits(model, params, ids, toks, steps):
    """Prefill logits of the last real row, then `steps` decode steps fed
    the given tokens (teacher forcing): a list of (B, V) f32 on the CPU."""
    from triton_distributed_tpu_torch.models.engine import prompt_bucket
    B, S = ids.shape
    padded = np.pad(ids, ((0, 0), (0, prompt_bucket(S, 1024) - S)))
    last, cache = model._prefill_hidden(params, padded,
                                        model.new_kv_cache(B, 1024), S)
    out = [_full_logits(last, params["lm_head"]).cpu()]
    for i in range(steps):
        tok = torch.as_tensor(toks[:, i], device=model.device)
        x, cache = model._decode_hidden(params, tok, cache)
        out.append(_full_logits(x, params["lm_head"]).cpu())
    return out


def check_tp_engine(models, attn, model, params, cfg, ids, engine_toks, smi,
                    profile):
    """The tp-engine cell: the Qwen3-8B weights re-laid into n = 4 rank
    shards behind Engine(max_len=1024), 4 prompts of 500 tokens, 32 out, in
    the modes "fused", "gemm_ar" and "xla" (the plain-collective golden on
    the card): exact launch counts, every fused-op call logged "kernel",
    start + step reproducing serve, prefill ms, decode tokens/s, aten ops
    per decode step (and with --profile the idle share); then the
    teacher-forced logits of the prefill and 8 decode steps (fed the
    one-rank engine's tokens) against the one-rank engine's and the "xla"
    mode's, within TP_LOGIT_TOL of the largest. Returns each kernel's
    launches over the cell's serve runs."""
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import _common
    from triton_distributed_tpu_torch.ops import ag_gemm as ag
    from triton_distributed_tpu_torch.ops import gemm_ar as ar
    from triton_distributed_tpu_torch.ops import gemm_rs as rs
    n, L, GEN, FORCED = TP_RANKS, cfg.num_layers, engine_toks.shape[1], 8
    t0 = time.perf_counter()
    tp = models.DenseLLM(cfg, mode="fused", dtype="bfloat16", device="cuda",
                         num_ranks=n)
    tparams = tp.shard_params(params)
    torch.cuda.synchronize()
    print(f"tp-engine: Qwen3-8B re-laid into {n} rank shards in "
          f"{time.perf_counter() - t0:.1f} s; device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    kernels = {"flash_attention": attn.FLASH_ATTENTION,
               "flash_decode": attn.FLASH_DECODE, "ag_gemm": ag.AG_GEMM,
               "gemm_rs": rs.GEMM_RS, "gemm_ar": ar.GEMM_AR}
    want = {"fused": {"ag_gemm": 2 * L, "gemm_rs": 2 * L, "gemm_ar": 0},
            "gemm_ar": {"ag_gemm": 0, "gemm_rs": 0, "gemm_ar": 2 * L * GEN},
            "xla": {"ag_gemm": 0, "gemm_rs": 0, "gemm_ar": 0}}
    totals = {k: 0 for k in kernels}
    ref = _forced_logits(model, params, ids, engine_toks, FORCED)
    forced, toks = {}, {}
    for mode in ("fused", "gemm_ar", "xla"):
        m = models.DenseLLM(cfg, mode=mode, dtype="bfloat16", device="cuda",
                            num_ranks=n)
        _common.reset_dispatch()
        _, toks[mode], launches = run_engine(
            models, kernels, m, tparams, cfg, ids, GEN, smi, profile,
            f"tp-engine {mode}")
        shmem.check_faults()
        assert launches == {"flash_attention": L,
                            "flash_decode": L * (GEN - 1), **want[mode]}, \
            (mode, launches)
        log = _common.dispatch_counts()
        assert all(path == "kernel" for _, path, _ in log), log
        print(f"tp-engine {mode}: dispatch log of the serve run and the "
              f"start + step rerun {log}")
        for k in totals:
            totals[k] += launches[k]
        forced[mode] = _forced_logits(m, tparams, ids, engine_toks, FORCED)
        shmem.check_faults()
        print(f"tp-engine {mode} greedy tokens (prompt 0): "
              f"{toks[mode][0].tolist()}")
    print(f"one-rank engine greedy tokens (prompt 0): "
          f"{engine_toks[0].tolist()}")
    for mode in ("fused", "gemm_ar", "xla"):
        errs = [_rel_err(g, r) for g, r in zip(forced[mode], ref)]
        vs_xla = [_rel_err(g, r) for g, r in zip(forced[mode], forced["xla"])]
        same = float((toks[mode] == engine_toks).mean())
        print(f"tp-engine {mode}: teacher-forced logits (prefill + {FORCED} "
              f"steps) vs the one-rank engine max {max(errs):.3e} of the "
              f"largest (per step {', '.join(f'{e:.2e}' for e in errs)}); vs "
              f"xla {max(vs_xla):.3e}; greedy tokens equal to the one-rank "
              f"engine's {same:.3f} (free-running, information)")
        assert max(errs) <= TP_LOGIT_TOL and max(vs_xla) <= TP_LOGIT_TOL, mode
        top2 = ref[0].topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * max(errs) * ref[0].abs().max()
        assert torch.equal(forced[mode][0].argmax(-1)[sure],
                           ref[0].argmax(-1)[sure]), mode
    del tp, tparams, m, forced
    shmem.release_workspaces()
    gc.collect()
    torch.cuda.empty_cache()
    return totals


# ---------------------------------------------------------------------------
# Slice 6c: expert-parallel Qwen3-MoE at n ranks (csrc/ep_a2a.cu)
# ---------------------------------------------------------------------------

def _ep_send(n, m, gen, dev, H=2048, E=128, k=8, chunk=128):
    """The ep-engine cell's dispatch at n ranks of m rows: random bf16
    tokens routed top-k over E experts by a seeded router, packed into the
    (n, n, C, H) send buffers. Returns (send, counts (n, n) int32)."""
    from triton_distributed_tpu_torch.ops import ep_a2a as tep
    from triton_distributed_tpu_torch.ops import moe_utils as mu
    x = torch.randn((n, m, H), generator=gen, device=dev).bfloat16()
    router = torch.randn((H, E), generator=gen, device=dev) * H ** -0.5
    _, experts = mu.route_topk(x.reshape(-1, H).float() @ router, k)
    c = tep.default_capacity(m, k, chunk)
    plan = tep.ep_dispatch_plan(experts.reshape(n, m, k), E, n, c)
    x_pad = torch.cat([x, x.new_zeros((n, 1, H))], dim=1)
    send = tep._per_rank_rows(x_pad, plan.send_gather).reshape(n, n, c, H)
    return send, plan.counts


def _a2a_check(tep, send, counts, chunk, name):
    """One kernel call against the plain version, bit for bit on the
    valid rows. Returns (the kernel's output, max abs difference)."""
    got = tep._ragged_a2a(send, counts, num_ranks=send.shape[0], chunk=chunk)
    want = tep._ragged_a2a_plain(send, counts)
    torch.cuda.synchronize()
    live = (torch.arange(send.shape[2], device=counts.device)
            < counts.t()[..., None])             # slab (d, s): counts[s, d]
    same = torch.equal(got[live], want[live])
    err = ((got[live].float() - want[live].float()).abs().max().item()
           if send.dtype != torch.uint8 else float(not same))
    print(f"ep_a2a {name}: {int(counts.sum())} rows of {tuple(send.shape)} "
          f"{str(send.dtype)[6:]}, kernel vs plain bit for bit on the valid "
          f"rows: {same}")
    assert same, name
    return got, err


def check_ep_a2a_kernel(dev, gen):
    """The ragged all-to-all kernel (csrc/ep_a2a.cu) against its plain
    version, bit for bit on the valid rows, at the ep-engine cell's
    dispatch (n = 4, 500 rows a rank, C 4096, H 2048, the counts of a
    seeded top-8 routing over 128 experts): bf16 twice (new data), then
    the packed int8 and fp8 wire rows (H + 128 bytes); at n = 2 with a
    pair of count 0 and a pair at full capacity. Timed on the bf16 call:
    the kernel, its plain version and one torch call moving the padded
    buffer (`transpose(0, 1).contiguous()`), against the bound of the
    real rows read once and written once. Returns the kernels-line
    entry."""
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import ep_a2a as tep
    from triton_distributed_tpu_torch.ops import wire
    t0 = time.perf_counter()
    n, chunk = EP_RANKS, 128
    before = tep.EP_A2A.launches
    err = 0.0
    for i in range(2):
        send, counts = _ep_send(n, 500, gen, dev)
        _, e = _a2a_check(tep, send, counts, chunk, f"bf16 n {n} call {i}")
        err = max(err, e)
    for wd in ("int8", "float8_e4m3fn"):
        q, s = wire.wire_quant(send, wd)
        _a2a_check(tep, tep._pack_scale(q, s), counts, chunk,
                   f"{wd} packed wire rows n {n}")
    c = send.shape[2]
    edge = torch.tensor([[0, c], [1234, 77]], dtype=torch.int32, device=dev)
    x2 = torch.randn((2, 2, c, 2048), generator=gen, device=dev).bfloat16()
    _a2a_check(tep, x2, edge, chunk, "bf16 n 2, counts [[0, C], [1234, 77]]")
    shmem.check_faults()
    assert tep.EP_A2A.launches == before + 5
    del x2
    rows = int(counts.sum())
    nb = 2 * rows * send.shape[-1] * send.element_size()
    bms, by = bound(nb, 0)
    ms = time_ms([lambda: tep._ragged_a2a(send, counts, num_ranks=n,
                                          chunk=chunk)])
    plain_ms = time_ms([lambda: tep._ragged_a2a_plain(send, counts)],
                       reps=3, rounds=3)
    lib_ms = time_ms([lambda: send.transpose(0, 1).contiguous()])
    shmem.check_faults()
    print(f"ep_a2a bf16 n {n} (C {c}, {rows} real rows of {n * n * c}): "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
          f"(transpose of the padded buffer) {lib_ms:.4f} ms, bound "
          f"{bms:.4f} ms ({by}: {nb / 2**20:.1f} MiB; "
          f"{nb / ms / 1e9:.2f} TB/s); phase "
          f"{time.perf_counter() - t0:.1f} s")
    return {"name": "ep_a2a", "route": "cuda",
            "source": "triton_distributed_tpu_torch/csrc/ep_a2a.cu",
            "replaces": "triton_distributed_tpu/ops/ep_a2a.py:137",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}


def check_ep_fault(dev, gen):
    """A planted lost signal: one notification of the pair 1 -> 2 taken
    out of rank 2's pad. The wait must time out within the budget (plus
    launch and copy time), the check must raise naming rank 2 and source
    rank 1, and the next call must run clean."""
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import ep_a2a as tep
    n = EP_RANKS
    send, counts = _ep_send(n, 64, gen, dev, chunk=64)
    tep._ragged_a2a(send, counts, num_ranks=n, chunk=64, collective_id=90)
    torch.cuda.synchronize()
    ws = next(w for w in shmem.primitives._WORKSPACES.values()
              if w.op == "ep_a2a[90]")
    ws.pads[2, 1 + 1] -= 1
    t0 = time.perf_counter()
    tep._ragged_a2a(send, counts, num_ranks=n, chunk=64, collective_id=90)
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    assert int(ws.fault[0]) == shmem.FAULT_TIMEOUT
    assert took < shmem.WAIT_BUDGET_S + 2.0, took
    try:
        shmem.check_faults()
        raise AssertionError("ep_a2a: the planted fault did not raise")
    except RuntimeError as e:
        msg = str(e)
    assert msg.startswith("ep_a2a[90]: rank 2 timed out") \
        and "source rank 1" in msg, msg
    _a2a_check(tep, send, counts, 64, "the call after the fault")
    shmem.check_faults()
    print(f"ep_a2a planted lost signal: raised after {took:.3f} s (budget "
          f"{shmem.WAIT_BUDGET_S} s): {msg}; the next call ran clean")


def check_small_ep_model(models, seed):
    """A small Qwen3MoE (hidden 256, 8 q over 4 kv heads, head_dim 128, 8
    experts top-2, block_m 16) at n = 2 and 4 ranks in mode "fused", EP
    over the ragged and the xla transports and TP experts, on the GPU
    through the kernels against the same weights on the CPU through the
    plain versions, bf16: prefill logits and one decode step's logits
    within 5e-2 of the largest, greedy tokens equal wherever the margin
    allows; the ragged runs launch the a2a twice a prefill layer."""
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import ep_a2a as tep
    from triton_distributed_tpu_torch.ops.grouped_gemm import (
        GroupedGemmConfig)
    from triton_distributed_tpu_torch.ops.moe_parallel import (
        MoEParallelConfig)
    cfg = models.get_config("Qwen/Qwen3-30B-A3B").tiny(
        hidden_size=256, num_heads=8, num_kv_heads=4, head_dim=128,
        vocab_size=512, num_layers=2, num_experts=8, num_experts_per_tok=2,
        moe_intermediate_size=256)
    mc = MoEParallelConfig(gemm=GroupedGemmConfig(block_m=16))
    one = models.Qwen3MoE(cfg, dtype="bfloat16", device="cpu", moe_config=mc)
    base = one.init_params(torch.Generator().manual_seed(seed))
    ids = np.random.RandomState(seed).randint(0, cfg.vocab_size, (2, 37))
    for n in (2, EP_RANKS):
        for par, kw in (("ep", {"ep_method": "ragged"}),
                        ("ep", {"ep_method": "xla"}), ("tp", {})):
            cpu, gpu = (models.Qwen3MoE(
                cfg, mode="fused", dtype="bfloat16", device=d, num_ranks=n,
                moe_parallel=par, moe_config=mc, **kw) for d in ("cpu",
                                                                "cuda"))
            params = cpu.shard_params(base)
            before = tep.EP_A2A.launches
            logits, tok = [], None
            for m in (cpu, gpu):
                p = params if m is cpu else _to_device_tree(params, "cuda")
                last, cache = m._prefill_hidden(p, ids,
                                                m.new_kv_cache(2, 64))
                pre = _full_logits(last, p["lm_head"]).cpu()
                tok = pre.argmax(-1) if tok is None else tok
                x, _ = m._decode_hidden(p, tok.to(m.device), cache)
                logits.append((pre, _full_logits(x, p["lm_head"]).cpu()))
            torch.cuda.synchronize()
            shmem.check_faults()
            ran = tep.EP_A2A.launches - before
            want = 2 * cfg.num_layers if kw.get("ep_method") == "ragged" \
                else 0
            assert ran == want, (n, par, kw, ran)
            for which, ref, got in zip(("prefill", "decode"), logits[0],
                                       logits[1]):
                _agree(f"small Qwen3MoE n {n} {par} {kw} {which}", ref, got)
    shmem.release_workspaces()


def _forced_routes(model, params, ids, toks, steps, routes=None,
                   paged=False):
    """_forced_logits (with `paged`, _paged_forced_logits over the prompts
    `ids`) with every routing of the model's MoE layers recorded: (logits,
    [(router logits (rows, E) f32 on the CPU, weights, experts)] in call
    order). Given `routes`, another model's record over the same calls and
    rows (the MoE layers route seq-major (S, B) rows at prefill, a chunk's
    rows and (B,) at decode at every rank count), each call returns that
    record's choice in place of its own: teacher forcing of the routing
    as well as of the tokens. Its own router logits are still recorded."""
    from triton_distributed_tpu_torch.ops import moe_utils
    real = moe_utils.route_topk
    seen = []

    def spy(logits, top_k, *, renormalize=True):
        w, e = real(logits, top_k, renormalize=renormalize)
        seen.append((logits.float().cpu(), w, e))
        if routes is not None:
            _, w, e = routes[len(seen) - 1]
        return w, e

    moe_utils.route_topk = spy
    try:
        out = (_paged_forced_logits(model, params, ids, toks) if paged
               else _forced_logits(model, params, ids, toks, steps))
    finally:
        moe_utils.route_topk = real
    assert routes is None or len(seen) == len(routes), (len(seen),
                                                        len(routes))
    return out, seen


def _routing_flips(ref, got, k):
    """Every recorded routing (router logits of the same rows): a row whose
    top-k sets differ must be a near-tie: for each expert i that left the
    set and each j that joined it, ref[i] - ref[j] (at least the gap
    between the k-th and (k+1)-th reference logits) no more than |got -
    ref| at i plus at j plus one bf16 step, the most two moved logits can
    close. The rule of _mk_moe_tick_checks bounds that gap by the row's
    largest difference plus one bf16 step, which is too tight when the
    two logits move in opposite directions; the flips it also admits are
    counted. Returns (flips, rows compared, flips within the single-
    difference rule, the widest swapped pair)."""
    from triton_distributed_tpu_torch.ops.moe_utils import route_topk
    flips, n, single, worst = 0, 0, 0, 0.0
    for call, ((rl, _, _), (gl, _, _)) in enumerate(zip(ref, got)):
        _, re = route_topk(rl, k)
        _, ge = route_topk(gl, k)
        differ = (torch.sort(re, -1).values != torch.sort(ge, -1).values
                  ).any(-1)
        n += rl.shape[0]
        for r in differ.nonzero().flatten().tolist():
            d = (gl[r] - rl[r]).abs()
            srt = rl[r].sort(descending=True).values
            ulp = _bf16_ulp(srt[k - 1].abs().item())
            single += int((srt[k - 1] - srt[k]).item()
                          <= d.max().item() + ulp)
            left = set(re[r].tolist()) - set(ge[r].tolist())
            joined = set(ge[r].tolist()) - set(re[r].tolist())
            for i in left:
                for j in joined:
                    gap = (rl[r, i] - rl[r, j]).item()
                    assert gap <= (d[i] + d[j]).item() + ulp, (
                        "a routing difference that is no near-tie", call, r,
                        i, j, gap, d[i].item(), d[j].item())
                    worst = max(worst, gap)
            flips += 1
    return flips, n, single, worst


def _forced_checks(name, one, one_params, model, params, ids, toks, steps,
                   k, paged=False):
    """Teacher forcing of `model` against the one-rank `one` on the same
    prompts and tokens: first with the routing forced to the one-rank
    model's too, where the logits of the prefill and every step must be
    within TP_LOGIT_TOL of the largest and every routing the model would
    have chosen must equal the one-rank model's or be a near-tie
    (`_routing_flips`); then with its own routing (information: a
    near-tie flip changes a token's expert, and the change carries
    through the layers after it). `paged`: through the paged serving
    steps (_paged_forced_logits over the prompts `ids`). Returns the forced
    maximum error."""
    ref, ref_routes = _forced_routes(one, one_params, ids, toks, steps,
                                     paged=paged)
    got, own = _forced_routes(model, params, ids, toks, steps, ref_routes,
                              paged=paged)
    errs = [_rel_err(g, r) for g, r in zip(got, ref)]
    flips, rows, single, worst = _routing_flips(ref_routes, own, k)
    free, free_routes = _forced_routes(model, params, ids, toks, steps,
                                       paged=paged)
    free_errs = [_rel_err(g, r) for g, r in zip(free, ref)]
    free_flips, _, _, _ = _routing_flips(ref_routes, free_routes, k)
    print(f"{name}: teacher-forced logits (prefill + {steps} steps, the "
          f"one-rank model's routing forced) vs the one-rank engine max "
          f"{max(errs):.3e} of the largest (per step "
          f"{', '.join(f'{e:.2e}' for e in errs)}); of {rows} (layer, row) "
          f"routings the model's own top-{k} differs in {flips}, each a "
          f"near-tie ({single} within the single-difference rule; widest "
          f"swapped pair {worst:.3e} apart). With its own routing "
          f"(information): max {max(free_errs):.3e} (per step "
          f"{', '.join(f'{e:.2e}' for e in free_errs)}), {free_flips} "
          f"routings differ")
    assert max(errs) <= TP_LOGIT_TOL, (name, errs)
    top2 = ref[0].topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 2 * max(errs) * ref[0].abs().max()
    assert torch.equal(got[0].argmax(-1)[sure], ref[0].argmax(-1)[sure])
    return max(errs)


def check_ep_engine(models, kernels, moe, moe_params, cfg, ids, one_toks, smi,
                    profile):
    """The ep-engine cell: Qwen3-30B-A3B at full width and depth, n = 4,
    experts as views of the one-rank model's (the attention and lm_head
    re-laid into rank shards), Engine(max_len=1024), the moe cell's
    prompts, mode "fused": ep_method "ragged", then "xla", then "ragged"
    with ep_pipeline=2. Each run: exact launch counts, prefill ms, decode
    tokens/s, aten ops a decode step, peak device memory. Ragged tokens
    equal the xla transport's, pipeline 2's equal pipeline 1's;
    teacher-forced logits (prefill + 8 steps fed the one-rank engine's
    tokens and routing) within TP_LOGIT_TOL of the largest of the one-rank
    engine's, every routing the model would choose equal to the one-rank
    engine's but at near-ties (counted; `_forced_checks`); one EP layer's
    prefill forward under set_sync_debug_mode("error"), and again,
    bit for bit, with NaN in every a2a landing row. Then TP experts at
    n = 4 on the first 8 layers (their rank shards of all 48 layers, ~54
    GiB, do not fit beside the one-rank model), checked the same way
    against a one-rank model over views of those 8 layers. Returns each
    kernel's launches over the cell's serve runs."""
    import dataclasses
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import ep_a2a as tep
    n, L, GEN, FORCED = EP_RANKS, cfg.num_layers, one_toks.shape[1], 8
    B, S = ids.shape
    t0 = time.perf_counter()
    base = torch.cuda.memory_allocated()
    ep = models.Qwen3MoE(cfg, mode="fused", dtype="bfloat16", device="cuda",
                         num_ranks=n, moe_parallel="ep")
    eparams = ep.shard_params(moe_params)
    torch.cuda.synchronize()
    for k in ("w_moe_gate_up", "w_moe_down"):
        assert eparams["layers"][k].data_ptr() == \
            moe_params["layers"][k].data_ptr(), k
    print(f"ep-engine: Qwen3-30B-A3B re-laid for {n} ranks in "
          f"{time.perf_counter() - t0:.1f} s, experts as views of the "
          f"one-rank model's; {(torch.cuda.memory_allocated() - base) / 2**30:.2f}"
          f" GiB more, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"allocated")
    totals = {k: 0 for k in kernels}
    toks, models_run = {}, {}
    for method, pipe in (("ragged", 1), ("xla", 1), ("ragged", 2)):
        name = f"ep-engine {method} ep_pipeline={pipe}"
        m = models.Qwen3MoE(cfg, mode="fused", dtype="bfloat16",
                            device="cuda", num_ranks=n, moe_parallel="ep",
                            ep_method=method, ep_pipeline=pipe)
        torch.cuda.reset_peak_memory_stats()
        _, toks[(method, pipe)], launches = run_engine(
            models, kernels, m, eparams, cfg, ids, GEN, smi,
            profile and pipe == 1 and method == "ragged", name)
        shmem.check_faults()
        a2a = 2 * L * pipe if method == "ragged" else 0
        want = {"flash_attention": L, "flash_decode": L * (GEN - 1),
                "gmm": 2 * L * (pipe + GEN - 1), "ep_a2a": a2a, "ag_gemm": L,
                "gemm_rs": L, "gemm_ar": 0}
        assert launches == want, (name, launches, want)
        print(f"{name}: launches a run {launches} (a2a {a2a // 2} dispatch + "
              f"{a2a // 2} combine a prefill); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; greedy "
              f"tokens (prompt 0) {toks[(method, pipe)][0].tolist()}")
        for k in totals:
            totals[k] += launches[k]
        models_run[(method, pipe)] = m
    assert np.array_equal(toks[("ragged", 1)], toks[("xla", 1)])
    assert np.array_equal(toks[("ragged", 2)], toks[("ragged", 1)])
    print("ep-engine: ragged tokens equal the xla transport's, "
          "ep_pipeline=2's equal ep_pipeline=1's")
    print(f"one-rank engine greedy tokens (prompt 0): {one_toks[0].tolist()}")

    _forced_checks("ep-engine ragged", moe, moe_params,
                   models_run[("ragged", 1)], eparams, ids, one_toks, FORCED,
                   cfg.num_experts_per_tok)
    same = float((toks[("ragged", 1)] == one_toks).mean())
    print(f"ep-engine ragged: greedy tokens equal to the one-rank engine's "
          f"{same:.3f} (free-running, information)")

    # one EP layer's prefill forward never waits on the host
    m = models_run[("ragged", 1)]
    p = {k: t[0] for k, t in eparams["layers"].items()}
    rows = torch.randn((n, S * B // n, cfg.hidden_size),
                       device="cuda").bfloat16()
    m.moe._shard_fwd(rows, p["router"], p["w_moe_gate_up"],
                     p["w_moe_down"])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = m.moe._shard_fwd(rows, p["router"], p["w_moe_gate_up"],
                             p["w_moe_down"])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    shmem.check_faults()
    assert torch.isfinite(y.float()).all()
    print(f"ep-engine: one EP layer's prefill forward ({n} x {rows.shape[1]} "
          f"rows) ran under set_sync_debug_mode('error'): no host "
          f"synchronisation")
    # landing rows past the counts hold an earlier call's data: NaN planted
    # in every landing row changes no output bit
    lands = [ws.land for ws in shmem.primitives._WORKSPACES.values()
             if ws.op.startswith("ep_a2a[")]
    assert lands
    for land in lands:
        land.fill_(0xFF)                # NaN in bf16, f32 and fp8
    y2 = m.moe._shard_fwd(rows, p["router"], p["w_moe_gate_up"],
                          p["w_moe_down"])
    torch.cuda.synchronize()
    shmem.check_faults()
    stale = [f"{int((land == 0xFF).all(-1).sum())} of "
             f"{land[..., 0].numel()} (C {land.shape[2]})" for land in lands]
    assert torch.equal(y2, y)
    print(f"ep-engine: NaN planted in every landing row of the {len(lands)} "
          f"a2a workspaces, the same forward again: output bit for bit "
          f"unchanged; slots left stale by the call: {', '.join(stale)}")
    del ep, eparams, models_run, m, p, rows, y, y2, lands
    shmem.release_workspaces()
    gc.collect()
    torch.cuda.empty_cache()

    # TP experts at n = 4, the first 8 layers (the cell's only cut)
    L8 = 8
    cfg8 = dataclasses.replace(cfg, num_layers=L8)
    p8 = {**moe_params,
          "layers": {k: t[:L8] for k, t in moe_params["layers"].items()}}
    one8 = models.Qwen3MoE(cfg8, dtype="bfloat16", device="cuda")
    tp8 = models.Qwen3MoE(cfg8, mode="fused", dtype="bfloat16",
                          device="cuda", num_ranks=n)
    t0 = time.perf_counter()
    tparams = tp8.shard_params(p8)
    torch.cuda.synchronize()
    print(f"ep-engine TP experts: the first {L8} layers re-laid into {n} "
          f"rank shards in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    one8_toks = models.Engine(one8, p8, max_len=1024).serve(ids, GEN)
    torch.cuda.reset_peak_memory_stats()
    _, tp_toks, launches = run_engine(models, kernels, tp8, tparams, cfg8,
                                      ids, GEN, smi, False,
                                      f"ep-engine TP experts ({L8} layers)")
    shmem.check_faults()
    want = {"flash_attention": L8, "flash_decode": L8 * (GEN - 1),
            "gmm": 2 * n * L8 * GEN, "ep_a2a": 0, "ag_gemm": L8,
            "gemm_rs": L8, "gemm_ar": 0}
    assert launches == want, (launches, want)
    for k in totals:
        totals[k] += launches[k]
    print(f"ep-engine TP experts ({L8} layers): launches {launches}; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB; greedy tokens equal to the one-rank {L8}-layer engine's "
          f"{float((tp_toks == one8_toks).mean()):.3f} (information)")
    _forced_checks(f"ep-engine TP experts ({L8} layers)", one8, p8, tp8,
                   tparams, ids, one8_toks, FORCED, cfg.num_experts_per_tok)
    del tp8, tparams, one8, p8
    shmem.release_workspaces()
    gc.collect()
    torch.cuda.empty_cache()
    return totals


# ---------------------------------------------------------------------------
# Slice 6b + SP serving: ServeEngine at n ranks (csrc/ll_combine.cu)
# ---------------------------------------------------------------------------

SERVE_RANKS = 4            # the tp-serve and sp-serve cells
LL_ROWS = (4, 32, 128)     # (B, H, D) of the sp-serve cell's combine
FP32_FLOPS = 67e12         # H100 SXM f32 rate outside the tensor cores


def _ll_partials(n, B, H, D, dtype, gen, dev, empty=None):
    out = torch.randn((n, B, H, D), generator=gen, device=dev).to(dtype)
    lse = 3 * torch.randn((n, B, H), generator=gen, device=dev)
    if empty is not None:
        out[empty], lse[empty] = 0, -1e30
    return out, lse


def check_ll_combine_kernel(dev, gen):
    """The one-shot combine (csrc/ll_combine.cu) against its plain version
    at n = 2, 4 and 8 ranks, at the sp-serve cell's rows (4 slots x 32
    heads of 128) and at odd rows (1 x 3), in bf16 and f32, bit for bit,
    two calls back to back, the second with its last rank empty (lse
    -1e30); every call one launch; NaN in the landing regions changes no
    bit of the next call. Then the merge kernel alone (`ll_merge`) the
    same way. Timed at the cell (n = 4, bf16): the kernel and its plain
    version, against the function's bound (the n partials and their lse
    read once, the one result written once); the protocol's own traffic
    (the n^2 packed partials written and read once on top) is printed
    beside it. Likewise the merge over the packed buffer. No single
    library call computes either. Returns the two kernels-line
    entries."""
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import ll_gather as tll
    t0 = time.perf_counter()
    err = {"ll_combine": 0.0, "ll_merge": 0.0}

    def close(name, got, want):
        e = (got.float() - want.float()).abs().max().item()
        assert got.dtype == want.dtype and torch.equal(got, want), (name, e)
        err[name] = max(err[name], e)
        return e

    for n in (2, SERVE_RANKS, 8):
        for B, H, D in (LL_ROWS, (1, 3, 128)):
            for dtype in (torch.bfloat16, torch.float32):
                e = []
                for empty in (None, n - 1):
                    out, lse = _ll_partials(n, B, H, D, dtype, gen, dev,
                                            empty)
                    before = tll.LL_COMBINE.launches
                    got = tll.ll_combine_shard(out, lse, num_ranks=n)
                    torch.cuda.synchronize()
                    assert tll.LL_COMBINE.launches == before + 1
                    e.append(close("ll_combine", got,
                                   tll._ll_combine_plain(out, lse)))
                for ws in shmem.primitives._WORKSPACES.values():
                    if ws.op == "ll_combine":
                        ws.land.fill_(float("nan"))
                again = tll.ll_combine_shard(out, lse, num_ranks=n)
                torch.cuda.synchronize()
                assert torch.equal(again, got), (n, B, H, D, dtype)
                shmem.check_faults()
                print(f"ll_combine n {n} rows {B}x{H} D {D} "
                      f"{str(dtype)[6:]}: kernel vs plain max_abs_err "
                      f"{max(e):.3e} (bit for bit), NaN in the landing "
                      f"regions changed no bit")
            out, lse = _ll_partials(n, *LL_ROWS, torch.float32, gen, dev)
            before = tll.LL_MERGE.launches
            got = tll.ll_merge(out, lse)
            torch.cuda.synchronize()
            assert tll.LL_MERGE.launches == before + 1
            close("ll_merge", got, tll._ll_combine_plain(out, lse))
    n, (B, H, D) = SERVE_RANKS, LL_ROWS
    rows, W = B * H, tll.packed_width(D)
    out, lse = _ll_partials(n, B, H, D, torch.bfloat16, gen, dev, n - 1)
    nb = out.numel() * 2 + lse.numel() * 4 + rows * D * 2
    wire = nb + 2 * n * n * rows * W * 4
    bms, by = bound(nb, 3 * n * rows * D, FP32_FLOPS)
    wire_ms, _ = bound(wire, 3 * n * rows * D, FP32_FLOPS)
    ms = time_ms([lambda: tll.ll_combine_shard(out, lse, num_ranks=n)])
    plain_ms = time_ms([lambda: tll._ll_combine_plain(out, lse)], reps=5,
                       rounds=3)
    packed = torch.stack([tll.pack_partials(out[s], lse[s])
                          for s in range(n)])
    mnb = packed.numel() * 4 + rows * D * 4
    mbms, mby = bound(mnb, 3 * n * rows * D, FP32_FLOPS)
    mms = time_ms([lambda: tll.ll_merge_packed(packed, D)])
    mplain = time_ms([lambda: tll._ll_merge_packed_plain(packed, D)],
                     reps=5, rounds=3)
    shmem.check_faults()
    print(f"ll_combine bf16 n {n} ({rows} rows of {D}, packed rows of {W} "
          f"f32): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bms:.5f} ms ({by}: {nb / 2**20:.3f} MiB; with the protocol's "
          f"n^2 packed partials written and read {wire_ms:.5f} ms, "
          f"{wire / 2**20:.3f} MiB), no single library call; the launch, "
          f"barrier and signals set its time")
    print(f"ll_merge f32 n {n} ({rows} rows): kernel {mms:.4f} ms, plain "
          f"{mplain:.4f} ms, bound {mbms:.5f} ms ({mby}); phase "
          f"{time.perf_counter() - t0:.1f} s")
    src = "triton_distributed_tpu_torch/csrc/ll_combine.cu"
    return ({"name": "ll_combine", "route": "cuda", "source": src,
             "replaces": "triton_distributed_tpu/ops/ll_gather.py:66",
             "max_abs_err": err["ll_combine"], "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
             "library_ms": None},
            {"name": "ll_merge", "route": "cuda", "source": src,
             "replaces": "triton_distributed_tpu/ops/ll_gather.py:51",
             "max_abs_err": err["ll_merge"], "ms": mms, "plain_ms": mplain,
             "bound_ms": mbms, "bound_by": mby, "library_ms": None})


def check_ll_fault(dev, gen):
    """A planted lost signal: one notification of source 1's row block 0
    taken out of rank 2's pad. The wait must time out within the budget
    (plus launch and copy time), the check must raise naming rank 2, the
    block and source rank 1, and the next call must run clean."""
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import ll_gather as tll
    n = SERVE_RANKS
    out, lse = _ll_partials(n, 2, 8, 128, torch.bfloat16, gen, dev)
    tll.ll_combine_shard(out, lse, num_ranks=n)
    torch.cuda.synchronize()
    ws = next(w for w in shmem.primitives._WORKSPACES.values()
              if w.op == "ll_combine" and w.n == n and w.land.shape[2] == 16)
    ws.pads[2, 1 + 1] -= 1
    t0 = time.perf_counter()
    tll.ll_combine_shard(out, lse, num_ranks=n)
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    assert int(ws.fault[0]) == shmem.FAULT_TIMEOUT
    assert took < shmem.WAIT_BUDGET_S + 2.0, took
    try:
        shmem.check_faults()
        raise AssertionError("ll_combine: the planted fault did not raise")
    except RuntimeError as e:
        msg = str(e)
    assert msg.startswith("ll_combine: rank 2 timed out") \
        and "row block 0 from source rank 1" in msg, msg
    got = tll.ll_combine_shard(out, lse, num_ranks=n)
    torch.cuda.synchronize()
    shmem.check_faults()
    e = (got.float() - tll._ll_combine_plain(out, lse).float()).abs().max()
    assert e <= 2.0 ** -7 * max(1.0, got.float().abs().max().item())
    print(f"ll_combine planted lost signal: raised after {took:.3f} s "
          f"(budget {shmem.WAIT_BUDGET_S} s): {msg}; the next call ran clean")


# ---------------------------------------------------------------------------
# Slice 6f: the collective library (csrc/all_gather.cu, reduce_scatter.cu,
# all_reduce.cu; the dense all_to_all over csrc/ep_a2a.cu)
# ---------------------------------------------------------------------------

COLL_RANKS = 4                 # the tp-engine cell's n
COLL_H = 4096                  # Qwen3-8B's hidden width
COLL_PREFILL = 2048            # rows of the row-parallel epilogues (4 x 512)
COLL_DECODE = 4                # rows at decode (4 slots)


def _coll_mods():
    """The three op modules, keyed by op (each package __init__ binds the
    names to the functions)."""
    import importlib
    return {op: importlib.import_module(
        f"triton_distributed_tpu_torch.ops.collectives.{op}")
        for op in ("all_gather", "reduce_scatter", "all_reduce")}


def _coll_arms():
    """(op, method name, shard-level fn, methods enum, kernel, plain) of the
    six kernel arms."""
    from triton_distributed_tpu_torch.ops import collectives as tc
    m = _coll_mods()
    ag, rs, ar = m["all_gather"], m["reduce_scatter"], m["all_reduce"]

    def split(f):
        return lambda x: f(x.reshape(x.shape[0], x.shape[0], -1,
                                     x.shape[-1]))

    return [
        ("all_gather", "FULLMESH_PUSH", tc.all_gather_shard,
         tc.AllGatherMethod, ag.ALL_GATHER, ag._fullmesh_plain),
        ("all_gather", "RING", tc.all_gather_shard, tc.AllGatherMethod,
         ag.ALL_GATHER, ag._ring_plain),
        ("reduce_scatter", "RING", tc.reduce_scatter_shard,
         tc.ReduceScatterMethod, rs.REDUCE_SCATTER, split(rs.ring_plain)),
        ("reduce_scatter", "FULLMESH", tc.reduce_scatter_shard,
         tc.ReduceScatterMethod, rs.REDUCE_SCATTER,
         split(rs.fullmesh_plain)),
        ("all_reduce", "ONE_SHOT", tc.all_reduce_shard, tc.AllReduceMethod,
         ar.ALL_REDUCE, ar.one_shot_plain),
        ("all_reduce", "TWO_SHOT", tc.all_reduce_shard, tc.AllReduceMethod,
         ar.ALL_REDUCE, ar.two_shot_plain)]


def _coll_x(op, n, rows, gen, dev, dtype=torch.bfloat16, cols=COLL_H):
    """Rank-stacked input of `op` whose per-rank unit has `rows` rows: the
    shard (all_gather), the chunk (reduce_scatter: n chunks a rank), the
    buffer (all_reduce)."""
    r = n * rows if op == "reduce_scatter" else rows
    return torch.randn((n, r, cols), generator=gen, device=dev).to(dtype)


def _coll_bound(op, x):
    """The function's bound: its inputs read once, its outputs written once
    (all_gather: n x n shards; reduce_scatter: n chunks; all_reduce: n
    replicas), the sums' f32 additions at the f32 rate. Returns (ms, by,
    bytes)."""
    n = x.shape[0]
    inp = x.numel() * x.element_size()
    out = {"all_gather": n * inp, "reduce_scatter": inp // n,
           "all_reduce": inp}[op]
    adds = 0 if op == "all_gather" else (n - 1) * out // x.element_size()
    ms, by = bound(inp + out, adds, FP32_FLOPS)
    return ms, by, inp + out


def _coll_protocol_bytes(op, method, x):
    """Bytes the arm's protocol moves through HBM on top of the function's
    (its landing stores and reads, the ring's relays)."""
    n = x.shape[0]
    u = x[0].numel() * x.element_size()          # a rank's input
    return {("all_gather", "FULLMESH_PUSH"): 0,
            ("all_gather", "RING"): 2 * (n - 2) * n * u,
            ("reduce_scatter", "FULLMESH"): 2 * (n - 1) * u,
            ("reduce_scatter", "RING"): 2 * (n - 1) * u,
            ("all_reduce", "ONE_SHOT"): 2 * n * (n - 1) * u,
            ("all_reduce", "TWO_SHOT"): (3 * n - 4) * u}[(op, method)]


def check_collectives(dev, gen):
    """The collective library at Qwen3-8B's widths (hidden 4096, bf16, the
    row-parallel epilogues' shapes at n = 4): each of the six kernel arms
    against its plain version, bit for bit, one launch a call logged
    "kernel", every rank's copy alike, at n = 4 (all_gather of 512-row
    shards, reduce_scatter of 2048-row partials, all_reduce of 4 and 2048
    rows; back to back with new data; an odd width), and at n = 2 and 8 with
    fewer rows. Then the main path: every count set to 0, the host-level
    entry points a user calls (`all_gather`, `reduce_scatter`, `all_reduce`
    at the decode and prefill rows, `all_to_all` of 2048 rows a rank,
    `AllGatherLayer` at the decode and the prefill shard) with AUTO and each
    method, the launches read back (each kernel launched as often as its op
    logged "kernel"), every output against the XLA route's (copies bit for
    bit, sums within two bf16 steps of the largest). Then each arm timed at
    n = 4 against its bound, its plain version and the library call
    (`x.sum(0)` for the sums, one contiguous copy of the gathered tensor
    for all_gather), AUTO's pick against the faster arm measured; one call
    of each arm at 1 row x 4096 fits PEER_LATENCY_S (time = fixed +
    dependent hops x PEER_LATENCY_S, least squares). Returns (the three
    kernels-line entries, the all_to_all's ep_a2a launches)."""
    from triton_distributed_tpu_torch import perf_model, shmem
    from triton_distributed_tpu_torch.ops import _common, ep_a2a
    from triton_distributed_tpu_torch.ops import collectives as tc
    from triton_distributed_tpu_torch.ops.ll_gather import AllGatherLayer
    from triton_distributed_tpu_torch.parallel import unshard
    t0 = time.perf_counter()
    arms = _coll_arms()
    kernels = {op: k for op, _, _, _, k, _ in arms}
    err = {op: 0.0 for op in kernels}

    def check(op, method, fn, methods, kernel, plain, x):
        n = x.shape[0]
        before = kernel.launches
        _common.reset_dispatch()
        got = fn(x, num_ranks=n, method=methods[method])
        torch.cuda.synchronize()
        shmem.check_faults()
        assert kernel.launches == before + 1, (op, method)
        assert _common.dispatch_counts() == {(op, "kernel", ""): 1}
        want = plain(x)
        e = (got.float() - want.float()).abs().max().item()
        assert got.shape == want.shape and torch.equal(got, want), \
            (op, method, tuple(x.shape), e)
        if op != "reduce_scatter":
            assert all(torch.equal(g, got[0]) for g in got), (op, method)
        err[op] = max(err[op], e)

    for n, small in ((2, 64), (COLL_RANKS, None), (8, 64)):
        for op, method, fn, methods, kernel, plain in arms:
            rows = {"all_gather": 512, "reduce_scatter": 512,
                    "all_reduce": COLL_PREFILL}[op] if small is None \
                else small
            cases = [rows] + ([COLL_DECODE] if op == "all_reduce" else [])
            for r in cases:
                if method == "TWO_SHOT":     # whole chunks (else XLA)
                    r = -(-r // n) * n
                for _ in range(2 if small is None else 1):
                    check(op, method, fn, methods, kernel, plain,
                          _coll_x(op, n, r, gen, dev))
            if small is None:       # an odd width: the element-wise tail
                odd = _coll_x(op, n, 4, gen, dev, cols=COLL_H - 1)
                check(op, method, fn, methods, kernel, plain, odd)
        print(f"collectives n {n}: the six arms bit for bit against their "
              f"plain versions, one launch a call logged 'kernel'")

    # the main path, through the entry points a user calls
    n, H = COLL_RANKS, COLL_H
    x_dec = _coll_x("all_reduce", n, COLL_DECODE, gen, dev)
    x_pre = _coll_x("all_reduce", n, COLL_PREFILL, gen, dev)
    x_rs = _coll_x("reduce_scatter", n, COLL_PREFILL // n, gen, dev)
    x_ag = _coll_x("all_gather", n, COLL_PREFILL // n, gen, dev)
    x_a2a = _coll_x("all_gather", n, COLL_PREFILL, gen, dev)
    layer = AllGatherLayer(num_ranks=n)
    for k in (*kernels.values(), ep_a2a.EP_A2A):
        k.launches = 0
    _common.reset_dispatch()
    mains, a2a_calls = [], 0
    for methods, fn, xs, ref in (
            (tc.AllReduceMethod, tc.all_reduce, (x_dec, x_pre), "XLA"),
            (tc.ReduceScatterMethod, tc.reduce_scatter, (x_rs,), "XLA"),
            (tc.AllGatherMethod, tc.all_gather,
             (unshard(x_ag, 0),), "XLA"),
            (tc.AllToAllMethod, tc.all_to_all,
             (x_a2a.reshape(-1, H),), "XLA")):
        for x in xs:
            want = fn(x, num_ranks=n, method=methods[ref])
            for m in methods:
                got = fn(x, num_ranks=n, method=m)
                mains.append((fn.__name__, m.name, got, want))
                a2a_calls += fn is tc.all_to_all and m.name != "XLA"
    for rows in (COLL_DECODE, COLL_PREFILL // n):
        x = _coll_x("all_gather", n, rows, gen, dev)
        mains.append(("layer", layer.resolve(x).name, layer(unshard(x, 0)),
                      unshard(x, 0)))
    torch.cuda.synchronize()
    shmem.check_faults()
    launches = {op: k.launches for op, k in kernels.items()}
    log = _common.dispatch_counts()
    for op in kernels:
        assert launches[op] == log.get((op, "kernel", ""), 0) > 0, \
            (op, launches, log)
    assert ep_a2a.EP_A2A.launches == a2a_calls > 0
    assert {b: m.name for b, m in layer._by_bytes.items()} == {
        COLL_DECODE * H * 2: "FULLMESH_PUSH",
        COLL_PREFILL // n * H * 2: "RING"}, layer._by_bytes
    for name, m, got, want in mains:
        assert got.shape == want.shape and bool(got.isfinite().all()), name
        if name in ("all_gather", "all_to_all", "layer"):
            assert torch.equal(got, want), (name, m)
        else:
            e = (got.float() - want.float()).abs().max().item()
            assert e <= 2.0 ** -6 * want.float().abs().max().item(), \
                (name, m, e)
    print(f"collectives main path (n {n}, hidden {H}, bf16; AUTO and every "
          f"method of all_reduce at {COLL_DECODE} and {COLL_PREFILL} rows, "
          f"reduce_scatter of {COLL_PREFILL} rows, all_gather of "
          f"{COLL_PREFILL // n}-row shards, all_to_all of {COLL_PREFILL} "
          f"rows a rank, AllGatherLayer at {COLL_DECODE} and "
          f"{COLL_PREFILL // n} rows): launches {launches}, ep_a2a "
          f"{ep_a2a.EP_A2A.launches}; the layer's cache "
          f"{ {b: m.name for b, m in layer._by_bytes.items()} }; outputs "
          f"equal the XLA route's (sums within 2^-6 of the largest)")

    # times at n = 4 against the bound, the plain version and the library
    timed, entries = {}, {}
    lib = {"all_reduce": lambda x: x.sum(0),
           "reduce_scatter": lambda x: x.sum(0),
           "all_gather": lambda x: x.reshape(1, -1, x.shape[-1]).expand(
               x.shape[0], -1, -1).contiguous()}
    shapes = {"all_gather": (x_ag,), "reduce_scatter": (x_rs,),
              "all_reduce": (x_dec, x_pre)}
    for op, method, fn, methods, kernel, plain in arms:
        for x in shapes[op]:
            ms = time_ms([lambda: fn(x, num_ranks=n,
                                     method=methods[method])])
            plain_ms = time_ms([lambda: plain(x)], reps=5, rounds=3)
            bms, by, nb = _coll_bound(op, x)
            proto = _coll_protocol_bytes(op, method, x)
            timed[(op, method, x.shape[1])] = (ms, plain_ms, bms, by)
            print(f"{op} {method} n {n} {tuple(x.shape[1:])} bf16: kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.5f} ms "
                  f"({by}: {nb / 2**20:.2f} MiB; with the protocol's "
                  f"{proto / 2**20:.2f} MiB of landing stores, reads and "
                  f"relays {(nb + proto) / PEAK_BYTES * 1e3:.5f} ms)")
    lib_ms = {}
    for op, xs in shapes.items():
        for x in xs:
            lib_ms[(op, x.shape[1])] = time_ms([lambda: lib[op](x)])
    picks = []
    for op, xs in shapes.items():
        methods = {"all_gather": tc.AllGatherMethod,
                   "reduce_scatter": tc.ReduceScatterMethod,
                   "all_reduce": tc.AllReduceMethod}[op]
        for x in xs:
            unit = x[0].numel() * 2 // (n if op == "reduce_scatter" else 1)
            pick = (_coll_mods()[op].choose_method(unit, n) if op ==
                    "all_gather" else _coll_mods()[op].choose_method(
                        unit, n, itemsize=2))
            arm_ms = {m: timed[(op, m, x.shape[1])][0] for (o, m, r) in timed
                      if o == op and r == x.shape[1]}
            best = min(arm_ms, key=arm_ms.get)
            picks.append((op, x.shape[1], pick.name, best))
            print(f"{op} AUTO at {tuple(x.shape[1:])}: picks {pick.name}; "
                  f"measured fastest {best} "
                  f"({', '.join(f'{m} {t:.4f}' for m, t in arm_ms.items())} "
                  f"ms); library {lib_ms[(op, x.shape[1])]:.4f} ms")
            if op == "all_reduce" and x.shape[1] == COLL_DECODE:
                continue
            ms, plain_ms, bms, by = timed[(op, pick.name, x.shape[1])]
            entries[op] = {
                "name": op, "route": "cuda",
                "source": f"triton_distributed_tpu_torch/csrc/{op}.cu",
                "replaces": {"all_gather": "triton_distributed_tpu/ops/"
                             "collectives/all_gather.py:64",
                             "reduce_scatter": "triton_distributed_tpu/ops/"
                             "collectives/reduce_scatter.py:68",
                             "all_reduce": "triton_distributed_tpu/ops/"
                             "collectives/all_reduce.py:89"}[op],
                "launches": launches[op], "max_abs_err": err[op], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                "library_ms": lib_ms[(op, x.shape[1])]}

    # the transport's per-hop latency: each arm at 1 row x 4096
    hops = {"FULLMESH_PUSH": 1, "RING": n - 1, "FULLMESH": 1,
            "ONE_SHOT": 1, "TWO_SHOT": 2 * (n - 1)}
    pts = []
    for op, method, fn, methods, kernel, plain in arms:
        x = _coll_x(op, n, n if method == "TWO_SHOT" else 1, gen, dev)
        t = time_ms([lambda: fn(x, num_ranks=n, method=methods[method])],
                    rounds=3)
        pts.append((hops[method], t))
        print(f"{op} {method} n {n} {tuple(x.shape[1:])}: {t:.4f} ms "
              f"({hops[method]} dependent hops)")
    h = np.array([p[0] for p in pts], float)
    t = np.array([p[1] for p in pts], float)
    slope, fixed = np.polyfit(h, t, 1)
    shmem.check_faults()
    print(f"perf_model constants: PEER_LATENCY_S = {slope * 1e-3:.6g} "
          f"(fixed {fixed * 1e-3:.6g} s a call; the model holds "
          f"{perf_model.PEER_LATENCY_S:.6g}); AUTO picks vs fastest: "
          f"{picks}; phase {time.perf_counter() - t0:.1f} s")
    return [entries[op] for op in ("all_gather", "reduce_scatter",
                                   "all_reduce")], ep_a2a.EP_A2A.launches


def check_collectives_fault(dev, gen):
    """A planted lost signal in the one-shot AllReduce at decode (4 x 4096
    bf16, n = 4): one notification of source 1's block 0 taken out of rank
    2's pad. Without return_fault the check raises within the budget naming
    rank 2, the block and the source; with return_fault=True the call
    returns rank 2's flag; each time the next call runs clean."""
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import collectives as tc
    n, one = COLL_RANKS, tc.AllReduceMethod.ONE_SHOT
    x = _coll_x("all_reduce", n, COLL_DECODE, gen, dev)
    want = tc.all_reduce_shard(x, num_ranks=n, method=one)
    torch.cuda.synchronize()
    ws = next(w for w in shmem.primitives._WORKSPACES.values()
              if w.op == "all_reduce[one_shot]" and w.n == n
              and w.land.shape[2] == COLL_DECODE * COLL_H)
    nblk = (ws.pads.shape[1] - 1) // n
    budget = 0.1
    for return_fault in (False, True):
        ws.pads[2, 1 + 1 * nblk] -= 1
        t0 = time.perf_counter()
        out = tc.all_reduce_shard(x, num_ranks=n, method=one,
                                  wait_budget=budget,
                                  return_fault=return_fault)
        torch.cuda.synchronize()
        if return_fault:
            out, fault = out
            took = time.perf_counter() - t0
            assert fault.tolist() == [0, 0, shmem.FAULT_TIMEOUT, 0], fault
            msg = f"returned the flags {fault.tolist()}"
        else:
            took = time.perf_counter() - t0
            try:
                shmem.check_faults()
                raise AssertionError("all_reduce: the planted fault did not "
                                     "raise")
            except RuntimeError as e:
                msg = str(e)
            assert msg.startswith("all_reduce[one_shot]: rank 2 timed out") \
                and "block 0 from source rank 1" in msg, msg
        assert took < budget + 2.0, took
        assert ws.epoch == 0 and int(ws.pads.abs().sum()) == 0
        got = tc.all_reduce_shard(x, num_ranks=n, method=one)
        torch.cuda.synchronize()
        shmem.check_faults()
        assert torch.equal(got, want)
        print(f"all_reduce one-shot planted lost signal (return_fault="
              f"{return_fault}): after {took:.3f} s (budget {budget} s) "
              f"{msg}; the next call ran clean")


# ---------------------------------------------------------------------------
# Slice 6g: the collectives' quantized wire (csrc/reduce_scatter.cu arms 2
# and 3, all_reduce.cu arm 2, the two-shot composition, the wire-width
# all_gather)
# ---------------------------------------------------------------------------

COLL_WIRE_BLK = 256            # the wire's default scaling block
COLL_ODD = (4095, 315)         # an odd width and an odd divisor of it


def _coll_wire_routes():
    """(name, op, method name, shard-level fn, methods enum, kernels a call
    launches, plain (x, wire, blk) -> out, quantizations (None: n)) of the
    four quantized routes."""
    from triton_distributed_tpu_torch.ops import collectives as tc
    m = _coll_mods()
    ag, rs, ar = m["all_gather"], m["reduce_scatter"], m["all_reduce"]

    def split(f):
        return lambda x, wd, blk: f(x.reshape(x.shape[0], x.shape[0], -1,
                                              x.shape[-1]), wd, blk)

    return [
        ("reduce_scatter_quant[ring]", "reduce_scatter", "RING",
         tc.reduce_scatter_shard, tc.ReduceScatterMethod,
         [rs.REDUCE_SCATTER_QUANT["ring"]], split(rs.ring_quant_plain), None),
        ("reduce_scatter_quant[fullmesh]", "reduce_scatter", "FULLMESH",
         tc.reduce_scatter_shard, tc.ReduceScatterMethod,
         [rs.REDUCE_SCATTER_QUANT["fullmesh"]],
         split(rs.fullmesh_quant_plain), 1),
        ("all_reduce_quant[one_shot]", "all_reduce", "ONE_SHOT",
         tc.all_reduce_shard, tc.AllReduceMethod, [ar.ALL_REDUCE_QUANT],
         ar.one_shot_quant_plain, 1),
        ("all_reduce[two_shot/wire]", "all_reduce", "TWO_SHOT",
         tc.all_reduce_shard, tc.AllReduceMethod,
         [rs.REDUCE_SCATTER_QUANT["ring"], ag.ALL_GATHER],
         ar.two_shot_quant_plain, None)]


def _coll_wire_bound(name, op, x, quants):
    """The quantized op's bound: the full-width function's bytes (inputs
    read once, outputs written once) and its operations at the f32 rate
    (each added value's dequantize and add, each quantized value's absmax,
    divide and round); and the wire's traffic on top (bytes and scales
    written and read once). Returns (ms, by, bytes, wire bytes)."""
    n, e = x.shape[0], x.numel()
    _, _, nb = _coll_bound(op, x)
    adds = (n - 1) * (e // n if op == "reduce_scatter" else e)
    ms, by = bound(nb, 2 * adds + 3 * e * quants, FP32_FLOPS)
    payload = {"reduce_scatter_quant[ring]": (n - 1) * e // n,
               "reduce_scatter_quant[fullmesh]": e,
               "all_reduce_quant[one_shot]": n * e,
               "all_reduce[two_shot/wire]": (n - 1) * e // n + e}[name]
    return ms, by, nb, 2 * payload * (COLL_WIRE_BLK + 4) // COLL_WIRE_BLK


def _sum_bound(parts, wd, blk, quantizations):
    """`wire.sum_error_bound` of stacked parts, on their device."""
    from triton_distributed_tpu_torch.ops import wire
    a = parts.float().abs().reshape(*parts.shape[:-1], -1, blk).amax(-1)
    return (wire.quant_eps(wd) * quantizations * a.sum(0)).repeat_interleave(
        blk, -1)


def check_collectives_wire(dev, gen):
    """The collectives' quantized wire at Qwen3-8B's widths: each quant arm
    and the two-shot composition bit for bit against its plain version at
    n = 2, 4, 8, bf16 and f32, int8 and fp8, blocks 128, 256 and 315 of a
    4095-wide row (one launch of each of its kernels a call, logged as
    JAX logs, every replica alike); the main path (every count set to 0,
    the host-level `reduce_scatter` and `all_reduce` with each method and
    AUTO and `quant_all_gather_shard`, both wires, at n = 4 and the
    row-parallel epilogues' shapes, launches read back; each output within
    `wire.sum_error_bound` of the full-width XLA route's, quantizations n
    for the ring and the two-shot, 1 for the others, plus a bf16 step);
    then each route timed at n = 4, bf16, block 256 (reduce_scatter of
    2048-row partials, all_reduce of 4 and 2048 rows) beside the
    full-width arm at the same shape, its plain version and its bound.
    Returns the three kernels-line entries."""
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import _common
    from triton_distributed_tpu_torch.ops import collectives as tc
    t0 = time.perf_counter()
    routes = _coll_wire_routes()
    mods = _coll_mods()
    err = {r[0]: 0.0 for r in routes}
    logs = {("reduce_scatter", "RING"): {("reduce_scatter", "kernel",
                                          "wire"): 1},
            ("reduce_scatter", "FULLMESH"): {("reduce_scatter", "kernel",
                                              "wire"): 1},
            ("all_reduce", "ONE_SHOT"): {("all_reduce", "kernel", "wire"): 1},
            ("all_reduce", "TWO_SHOT"): {("all_reduce", "kernel", "wire"): 1,
                                         ("reduce_scatter", "kernel",
                                          "wire"): 1,
                                         ("all_gather", "kernel", ""): 1}}

    def check(route, x, wd, blk):
        name, op, method, fn, methods, kernels, plain, _ = route
        n = x.shape[0]
        before = [k.launches for k in kernels]
        _common.reset_dispatch()
        got = fn(x, num_ranks=n, method=methods[method], wire_dtype=wd,
                 wire_block=blk)
        torch.cuda.synchronize()
        shmem.check_faults()
        assert [k.launches - b for k, b in zip(kernels, before)] == \
            [1] * len(kernels), name
        assert _common.dispatch_counts() == logs[(op, method)], name
        want = plain(x, wd, blk)
        e = (got.float() - want.float()).abs().max().item()
        assert got.shape == want.shape and torch.equal(got, want), \
            (name, n, tuple(x.shape), x.dtype, wd, blk, e)
        if op == "all_reduce":
            assert all(torch.equal(g, got[0]) for g in got), name
        err[name] = max(err[name], e)

    checked = 0
    for n in (2, COLL_RANKS, 8):
        for route in routes:
            op, method = route[1], route[2]
            for dtype in (torch.bfloat16, torch.float32):
                for wd in WIRES.values():
                    for blk, cols in ((128, COLL_H), (COLL_WIRE_BLK, COLL_H),
                                      (COLL_ODD[1], COLL_ODD[0])):
                        rows = 16 if method != "TWO_SHOT" else 2 * n
                        check(route, _coll_x(op, n, rows, gen, dev, dtype,
                                             cols), wd, blk)
                        checked += 1
            if n == COLL_RANKS:       # the timed shapes
                full = {"reduce_scatter": (COLL_PREFILL // n,),
                        "all_reduce": (COLL_DECODE, COLL_PREFILL)}[op]
                for rows in full:
                    if method == "TWO_SHOT" and rows % n:
                        continue
                    for wd in WIRES.values():
                        check(route, _coll_x(op, n, rows, gen, dev), wd,
                              COLL_WIRE_BLK)
                        checked += 1
        print(f"collectives wire n {n}: the three quant arms and the "
              f"two-shot bit for bit against their plain versions (bf16, "
              f"f32; int8, fp8; blocks 128, 256, {COLL_ODD[1]} of "
              f"{COLL_ODD[0]})")

    # the main path, through the entry points a user calls
    n, H = COLL_RANKS, COLL_H
    x_rs = _coll_x("reduce_scatter", n, COLL_PREFILL // n, gen, dev)
    xs_ar = (_coll_x("all_reduce", n, COLL_DECODE, gen, dev),
             _coll_x("all_reduce", n, COLL_PREFILL, gen, dev))
    x_ag = _coll_x("all_gather", n, COLL_PREFILL // n, gen, dev)
    rs_quant = mods["reduce_scatter"].REDUCE_SCATTER_QUANT
    counted = {"reduce_scatter_quant[ring]": rs_quant["ring"],
               "reduce_scatter_quant[fullmesh]": rs_quant["fullmesh"],
               "all_reduce_quant[one_shot]":
               mods["all_reduce"].ALL_REDUCE_QUANT,
               "all_gather": mods["all_gather"].ALL_GATHER}
    for k in counted.values():
        k.launches = 0
    _common.reset_dispatch()
    mains = []
    for wd in WIRES.values():
        for fn, methods, xs, op in (
                (tc.reduce_scatter, tc.ReduceScatterMethod, (x_rs,),
                 "reduce_scatter"),
                (tc.all_reduce, tc.AllReduceMethod, xs_ar, "all_reduce")):
            for x in xs:
                for m in methods:
                    if m.name == "XLA":
                        continue
                    picked = m
                    if m.name == "AUTO":
                        unit = x[0].numel() * 2 // (n if op ==
                                                     "reduce_scatter" else 1)
                        picked = mods[op].choose_method(
                            unit, n, wire_dtype=wd, itemsize=2)
                    mains.append((op, m.name, picked.name, wd, x,
                                  fn(x, num_ranks=n, method=m, wire_dtype=wd)))
        mains.append(("all_gather", "RING", "RING", wd, x_ag,
                      mods["all_gather"].quant_all_gather_shard(
                          x_ag, num_ranks=n, wire_dtype=wd,
                          block=COLL_WIRE_BLK)))
    torch.cuda.synchronize()
    shmem.check_faults()
    launches = {k: c.launches for k, c in counted.items()}
    log = _common.dispatch_counts()
    for k in launches:
        assert launches[k] > 0, (k, launches)
    assert launches["all_reduce_quant[one_shot]"] == sum(
        1 for r in mains if r[0] == "all_reduce" and r[2] == "ONE_SHOT")
    two_shots = sum(1 for r in mains if r[0] == "all_reduce"
                    and r[2] == "TWO_SHOT")
    assert launches["reduce_scatter_quant[ring]"] == two_shots + sum(
        1 for r in mains if r[0] == "reduce_scatter" and r[2] == "RING")
    assert launches["reduce_scatter_quant[fullmesh]"] == sum(
        1 for r in mains if r[0] == "reduce_scatter" and r[2] == "FULLMESH")
    assert launches["all_gather"] == two_shots + 2, launches
    assert log[("reduce_scatter", "kernel", "wire")] == \
        launches["reduce_scatter_quant[ring]"] \
        + launches["reduce_scatter_quant[fullmesh]"], log
    worst = 0.0
    for op, m, picked, wd, x, got in mains:
        quants = n if picked in ("RING", "TWO_SHOT") else 1
        if op == "all_gather":
            full = x.reshape(-1, H).expand(n, -1, -1)
            bnd = _sum_bound(x.reshape(1, -1, H), wd, COLL_WIRE_BLK, 1)
        elif op == "reduce_scatter":     # rank p's parts: chunk p of each
            full = tc.reduce_scatter(x, num_ranks=n,
                                     method=tc.ReduceScatterMethod.XLA)
            bnd = torch.cat([_sum_bound(c, wd, COLL_WIRE_BLK, quants)
                             for c in x.chunk(n, dim=1)])
        else:
            full = tc.all_reduce(x, num_ranks=n,
                                 method=tc.AllReduceMethod.XLA)
            bnd = _sum_bound(x, wd, COLL_WIRE_BLK, quants)
        full = full.float()
        assert got.shape == full.shape and bool(got.isfinite().all()), \
            (op, m, wd)
        lim = bnd + 2.0 ** -7 * full.abs() + 1e-5
        ratio = ((got.float() - full).abs() / lim).max().item()
        assert ratio <= 1.0, (op, m, wd, ratio)
        worst = max(worst, ratio)
    autos = sorted({(op, wd, x.shape[1], picked)
                    for op, m, picked, wd, x, _ in mains if m == "AUTO"})
    print(f"collectives wire main path (n {n}, hidden {H}, bf16, block "
          f"{COLL_WIRE_BLK}; int8 and fp8; reduce_scatter of "
          f"{COLL_PREFILL} rows, all_reduce of {COLL_DECODE} and "
          f"{COLL_PREFILL} rows, each method and AUTO; quant_all_gather_shard "
          f"of {COLL_PREFILL // n}-row shards): launches {launches}; AUTO "
          f"picked (op, wire, rows, method) {autos}; every output within "
          f"wire.sum_error_bound (+ a bf16 step) of the full-width XLA "
          f"route's, at most {worst:.3f} of it")

    # times at n = 4, bf16, block 256, beside the full-width arm
    timed, entries = {}, {}
    shapes = {"reduce_scatter": (x_rs,), "all_reduce": xs_ar}
    for route in routes:
        name, op, method, fn, methods, kernels, plain, quants = route
        q = quants or n
        for x in shapes[op]:
            if method == "TWO_SHOT" and x.shape[1] % n:
                continue
            fw = time_ms([lambda: fn(x, num_ranks=n, method=methods[method])])
            bms, by, nb, wb = _coll_wire_bound(name, op, x, q)
            for tag, wd in WIRES.items():
                ms = time_ms([lambda: fn(x, num_ranks=n,
                                         method=methods[method],
                                         wire_dtype=wd,
                                         wire_block=COLL_WIRE_BLK)])
                plain_ms = time_ms([lambda: plain(x, wd, COLL_WIRE_BLK)],
                                   reps=3, rounds=3)
                timed[(name, x.shape[1], tag)] = (ms, plain_ms, bms, by, fw)
                print(f"{name} n {n} {tuple(x.shape[1:])} bf16 {tag} block "
                      f"{COLL_WIRE_BLK}: kernel {ms:.4f} ms (full-width arm "
                      f"{fw:.4f} ms, {ms / fw:.2f}x), plain {plain_ms:.4f} "
                      f"ms, bound {bms:.5f} ms ({by}: {nb / 2**20:.2f} MiB; "
                      f"the wire's {wb / 2**20:.2f} MiB on top "
                      f"{(nb + wb) / PEAK_BYTES * 1e3:.5f} ms)")
    replaces = {"reduce_scatter_quant[ring]": "reduce_scatter.py:132",
                "reduce_scatter_quant[fullmesh]": "reduce_scatter.py:178",
                "all_reduce_quant[one_shot]": "all_reduce.py:175"}
    for name, where in replaces.items():
        op = name.split("_quant")[0]
        rows = shapes[op][-1].shape[1]
        ms, plain_ms, bms, by, _ = timed[(name, rows, "int8")]
        entries[name] = {
            "name": name, "route": "cuda",
            "source": f"triton_distributed_tpu_torch/csrc/{op}.cu",
            "replaces": "triton_distributed_tpu/ops/collectives/" + where,
            "launches": launches[name], "max_abs_err": err[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None}
    shmem.check_faults()
    print(f"collectives wire: {checked} bit-for-bit checks; no single "
          f"library call computes a quantized collective; phase "
          f"{time.perf_counter() - t0:.1f} s")
    return list(entries.values())


def check_collectives_wire_fault(dev, gen):
    """A planted lost signal in the quantized one-shot AllReduce at decode
    (4 x 4096 bf16, n = 4, int8): one notification of source 1's first work
    item taken out of rank 2's pad; the check raises within the budget
    naming rank 2, the block (with its scaling blocks) and the source; the
    next call runs clean."""
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import collectives as tc
    n, one = COLL_RANKS, tc.AllReduceMethod.ONE_SHOT
    x = _coll_x("all_reduce", n, COLL_DECODE, gen, dev)
    want = tc.all_reduce_shard(x, num_ranks=n, method=one, wire_dtype="int8")
    torch.cuda.synchronize()
    E = COLL_DECODE * COLL_H
    gblk = shmem.coll_wire_group(E * 2, COLL_WIRE_BLK * 2)
    ws = shmem.coll_wire_workspace("all_reduce", "one_shot", x.device, n, n,
                                   E, COLL_WIRE_BLK, gblk)   # the call's own
    assert ws.epoch >= 1
    nitem = (ws.pads.shape[1] - 1) // n
    budget = 0.1
    ws.pads[2, 1 + 1 * nitem] -= 1
    t0 = time.perf_counter()
    tc.all_reduce_shard(x, num_ranks=n, method=one, wire_dtype="int8",
                        wait_budget=budget)
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    try:
        shmem.check_faults()
        raise AssertionError("all_reduce wire: the planted fault did not "
                             "raise")
    except RuntimeError as e:
        msg = str(e)
    assert msg.startswith("all_reduce[one_shot/wire]: rank 2 timed out") \
        and "block 0 (scaling blocks 0.." in msg \
        and "from source rank 1" in msg, msg
    assert took < budget + 2.0, took
    assert ws.epoch == 0 and int(ws.pads.abs().sum()) == 0
    got = tc.all_reduce_shard(x, num_ranks=n, method=one, wire_dtype="int8")
    torch.cuda.synchronize()
    shmem.check_faults()
    assert torch.equal(got, want)
    print(f"all_reduce one-shot int8 planted lost signal: after {took:.3f} s "
          f"(budget {budget} s) {msg}; the next call ran clean")


def check_small_sp_tp_serve(models, seed):
    """A small Qwen3-shaped model at n = 2 behind ServeEngine, tensor-
    parallel in mode "gemm_ar" (tp_ranks=2) and sequence-parallel under
    both combines, on the GPU (kernels) against the same weights on the
    CPU (plain versions), bf16: the logits of every greedy pick within
    5e-2 of the largest, the picks equal wherever the margin allows, up to
    the first pick that differs; prompts crossing the 128-token ownership
    boundary; the paged decode kernel once a layer a decode tick, gemm_ar
    or ll_combine on their paths."""
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.models import dense
    from triton_distributed_tpu_torch.ops import attention as attn
    from triton_distributed_tpu_torch.ops import gemm_ar as ar
    from triton_distributed_tpu_torch.ops import ll_gather as tll
    cfg = models.get_config("Qwen/Qwen3-8B").tiny(
        hidden_size=256, num_heads=8, num_kv_heads=2, head_dim=128,
        intermediate_size=512, vocab_size=512, num_layers=2)
    base = models.DenseLLM(cfg, dtype="bfloat16", device="cpu").init_params(
        torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    reqs = [(rng.randint(0, 512, s).astype(np.int32), 6)
            for s in (40, 150, 20)]
    real = dense.greedy_token
    for par in ("tp", "sp-xla", "sp-ll"):
        mk = (dict(mode="gemm_ar", num_ranks=2) if par == "tp" else
              dict(mode="ar", num_ranks=2, attn_parallelism="sp",
                   sp_combine=par[3:]))
        kernels = (attn.FLASH_DECODE_PAGED["bfloat16"], ar.GEMM_AR,
                   tll.LL_COMBINE)
        seen = {}
        for dev in ("cpu", "cuda"):
            m = models.DenseLLM(cfg, dtype="bfloat16", device=dev, **mk)
            p = m.shard_params(_to_device_tree(base, dev))
            seen[dev] = []

            def spy(x, lm_head, dev=dev):
                seen[dev].append(_full_logits(x, lm_head).cpu())
                return real(x, lm_head)

            before = [k.launches for k in kernels]
            dense.greedy_token = spy
            try:
                se = models.ServeEngine(
                    m, p, b_max=2, max_len=256, block=32, prefill_chunk=32,
                    **({"tp_ranks": 2} if par == "tp" else {}))
                se.serve([r for r, _ in reqs], [g for _, g in reqs])
            finally:
                dense.greedy_token = real
            torch.cuda.synchronize()
            shmem.check_faults()
            ran = [k.launches - b for k, b in zip(kernels, before)]
            if par != "tp":
                se._cache.check_conservation_sp(2)
        L, steps = cfg.num_layers, se.stats()["decode_steps"]
        assert ran[0] == L * steps and (ran[1] > 0) == (par == "tp") \
            and ran[2] == (L * steps if par == "sp-ll" else 0), (par, ran)
        compared, worst = 0, 0.0
        for ref, got in zip(seen["cpu"], seen["cuda"]):
            assert torch.isfinite(got).all(), par
            diff = (got - ref).abs().max().item()
            scale = max(1.0, ref.abs().max().item())
            assert diff <= 5e-2 * scale, (par, compared, diff)
            top2 = ref.topk(2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > 2 * diff
            assert torch.equal(got.argmax(-1)[sure], ref.argmax(-1)[sure])
            worst = max(worst, diff / scale)
            compared += 1
            if not torch.equal(ref.argmax(-1), got.argmax(-1)):
                break
        assert compared >= 4, (par, compared)
        print(f"small serve n 2 {par}: {compared} greedy calls GPU vs CPU, "
              f"logits within {worst:.3e} of the largest, launches paged / "
              f"gemm_ar / ll_combine {ran}")
    shmem.release_workspaces()


def _paged_forced_logits(model, params, prompts, toks):
    """Teacher forcing through the paged serving steps: each prompt
    prefilled into its own slot of a fresh pool in 256-token chunks, then
    decode steps of every slot fed `toks` (B, steps). Returns a list of
    (B, V) f32 logits on the CPU: the prompts' last rows, then one per
    step."""
    from triton_distributed_tpu_torch.models import dense
    B, steps = toks.shape
    sp = model.n if model.attn_parallelism == "sp" else 1
    cache = model.new_paged_kv_cache(B, 2048, block=128, num_blocks=64)
    seen, real = [], dense.greedy_token

    def spy(x, lm_head):
        seen.append(_full_logits(x, lm_head).cpu())
        return real(x, lm_head)

    dense.greedy_token = spy
    try:
        last = []
        for b, ids in enumerate(prompts):
            assert cache.assign_slot(b, -(-(len(ids) + steps) // 128),
                                     sp_ranks=sp)
            for off in range(0, len(ids), 256):
                chunk = np.zeros(256, np.int32)
                valid = min(256, len(ids) - off)
                chunk[:valid] = ids[off:off + valid]
                model.prefill_chunk_paged(params, chunk, cache, b, off, valid)
            last.append(seen[-1])
        out = [torch.cat(last)]
        del seen[:]
        for i in range(steps):
            model.decode_step_paged(params, toks[:, i], cache, [True] * B)
        torch.cuda.synchronize()
    finally:
        dense.greedy_token = real
    return out + seen


def _serve_cell(models, attn, se, stream, L, tag, smi, extra, extra_want,
                vocab):
    """One run of a multi-rank serve cell: the run_serve checks with the
    extra kernels counted, every request at its length, one line of
    metrics. Returns (tokens, stats, launches)."""
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import grouped_gemm as gg
    out, st, launches, tick_ms, ops = run_serve(models, attn, se, stream, L,
                                                gg, extra, extra_want)
    shmem.check_faults()
    assert sorted(out) == list(range(len(stream)))
    for rid, (_, gen_len) in enumerate(stream):
        assert len(out[rid]) == gen_len, (rid, len(out[rid]))
        assert ((out[rid] >= 0) & (out[rid] < vocab)).all()
    print(f"{tag}: {st['tokens']} tokens in {st['wall_s']:.3f} s "
          f"({st['tokens_per_s']} tokens/s), {st['ticks']} ticks, "
          f"{st['decode_steps']} decode ticks at "
          f"{statistics.median(tick_ms):.2f} ms median "
          f"({min(tick_ms):.2f}-{max(tick_ms):.2f}; {ops} aten ops a tick), "
          f"{st['prefill_chunks']} chunks ({st['prefix_chunks']} over a "
          f"cached prefix), grant refusals {st['grant_refusals']}, launches "
          f"{ {n: c for n, c in launches.items() if c} } | {smi}")
    return out, st, launches


def check_tp_serve(models, attn, model, params, cfg, seed, smi):
    """The tp-serve cell: the Qwen3-8B weights re-laid into n = 4 rank
    shards behind ServeEngine(tp_ranks=4) with the serve cell's stream and
    settings: mode "gemm_ar" with a bf16 pool, then an int8 pool, then
    mode "fused" (whose paged steps end in psum), then "gemm_ar" with
    speculative decoding (an OracleDrafter over the first run's tokens,
    every third draft wrong, k 4: the n-rank verify step, the paged
    decode kernel over 4 x B x K queries and gemm_ar at M = B x K; accepts
    and rejects both seen). Exact launch counts (the paged decode kernel
    once a layer a decode or verify tick over all 4 ranks, gemm_ar twice
    a layer a tick and a prefill chunk in "gemm_ar"),
    every request at its length, the rank ledgers drained and equal,
    conservation; then the teacher-forced logits of 4 prompts' paged
    prefill and 8 decode steps against the one-rank model's within
    TP_LOGIT_TOL of the largest; then, on the same shards, the
    mk-tp-serve cell (check_mk_tp_serve). Returns the launches over the
    runs and the mk-tp-serve numbers."""
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import gemm_ar as ar
    from triton_distributed_tpu_torch.ops import ll_gather as tll
    n, L = SERVE_RANKS, cfg.num_layers
    t0 = time.perf_counter()
    tp = models.DenseLLM(cfg, mode="gemm_ar", dtype="bfloat16",
                         device="cuda", num_ranks=n)
    tparams = tp.shard_params(params)
    torch.cuda.synchronize()
    print(f"tp-serve: Qwen3-8B re-laid into {n} rank shards in "
          f"{time.perf_counter() - t0:.1f} s")
    stream = serve_stream(np.random.RandomState(seed), cfg.vocab_size)
    extra = {"gemm_ar": ar.GEMM_AR, "ll_merge": tll.LL_MERGE}
    totals, targets = {}, None
    runs = (("gemm_ar", None, False), ("gemm_ar", "int8", False),
            ("fused", None, False), ("gemm_ar", None, True))
    for mode, kv, spec in runs:
        m = models.DenseLLM(cfg, mode=mode, dtype="bfloat16", device="cuda",
                            num_ranks=n)
        se = models.ServeEngine(
            m, tparams, b_max=4, max_len=2048, block=128, prefill_chunk=256,
            num_blocks=64, kv_dtype=kv, tp_ranks=n,
            speculative=_oracle_spec(models, targets, stream, cfg.vocab_size)
            if spec else None)

        def want(st, mode=mode):
            per = 2 * L * (st["decode_steps"] + st["prefill_chunks"])
            return {"gemm_ar": per if mode == "gemm_ar" else 0,
                    "ll_merge": 0}

        tag = f"tp-serve[{mode}, {kv or 'bf16'}{', spec' if spec else ''}]"
        out, st, launches = _serve_cell(models, attn, se, stream, L, tag,
                                        smi, extra, want, cfg.vocab_size)
        targets = targets or out
        if spec:
            assert st["spec_accepted"] > 0 and st["spec_rejected"] > 0, st
            print(f"{tag}: drafts accepted {st['spec_accepted']}, rejected "
                  f"{st['spec_rejected']} over {st['decode_steps']} verify "
                  f"ticks")
        se._cache.check_conservation(cached=st["cached_free_blocks"])
        pr = st["per_rank"]
        assert st["tp_ranks"] == n and len(pr) == n \
            and all(r == {**pr[0], "rank": i} for i, r in enumerate(pr)) \
            and pr[0]["held_blocks"] == 0, pr
        for k, c in launches.items():
            totals[k] = totals.get(k, 0) + c
    rng = np.random.RandomState(seed + 7)
    prompts = [stream[i][0] for i in range(4)]
    toks = rng.randint(0, cfg.vocab_size, (4, 8)).astype(np.int32)
    ref = _paged_forced_logits(model, params, prompts, toks)
    got = _paged_forced_logits(tp, tparams, prompts, toks)
    shmem.check_faults()
    errs = [_rel_err(g, r) for g, r in zip(got, ref)]
    print(f"tp-serve gemm_ar: teacher-forced paged logits (4 prompts' last "
          f"rows + 8 decode steps) vs the one-rank model max {max(errs):.3e} "
          f"of the largest (per step {', '.join(f'{e:.2e}' for e in errs)})")
    assert max(errs) <= TP_LOGIT_TOL, errs
    del m, se
    mk_tp = check_mk_tp_serve(models, attn, tp, tparams, cfg, seed, smi,
                              targets)
    del tp, tparams
    shmem.release_workspaces()
    gc.collect()
    torch.cuda.empty_cache()
    return totals, mk_tp


# -- slice 6d: the megakernel at n ranks (the AR body, mk-tp-serve) ----------

AR_CHAIN = 72                  # the AR nodes of Qwen3-8B's program (2 x 36)


def _ar_program(dev, n, rows, dt, nodes=1):
    """An n-rank program of `nodes` chained all_reduce nodes over an
    input of (rows, 4096): the AR body alone at the trunk's shape."""
    from triton_distributed_tpu_torch.megakernel.builder import ModelBuilder
    from triton_distributed_tpu_torch.parallel.mesh import RankGroup
    mb = ModelBuilder(mesh=RankGroup(n), dtype=dt)
    h = mb.input("x", (rows, 4096))
    for _ in range(nodes):
        h = mb.all_reduce(h)
    mb.output(h)
    prog = mb.compile("kernel", device=dev)
    prog.bind_weights({})
    return prog


def check_megakernel_ar(dev):
    """Step 44: the AR body alone. An input -> all_reduce -> output
    program at n = 2, 4 and 8 ranks, at the trunk's shapes (4 slots x 1
    row and 4 x 8 rows, hidden 4096), f32 and bf16: the kernel twice (the
    epoch-counted signals) against its plain walk with torch.equal, every
    rank's copy alike. At the mk-tp-serve cell's shape (n 4, 4 rows,
    bf16): the kernel's, the plain walk's and x.sum(0)'s times against the
    function's bound (the n partials read once, the n replicated outputs
    written once); the protocol's own traffic (each partial pushed to n -
    1 peers and read back) is printed beside it. Then a chain of 72 AR
    nodes (the step's) timed. Returns the AR arm's kernel entry."""
    gen = torch.Generator(device=dev).manual_seed(44)
    entry, worst = None, 0.0
    for n in (2, 4, 8):
        for rows in (4, 32):
            for dt in (torch.float32, torch.bfloat16):
                prog = _ar_program(dev, n, rows, dt)
                x = torch.randn((n, rows, 4096), generator=gen,
                                device=dev).to(dt)
                outs = []
                for plain in (False, True, False):
                    outs.append(prog.step({"x": x}, plain=plain)[0].clone())
                    torch.cuda.synchronize()
                    prog.check_fault()
                assert all(torch.equal(o, outs[1]) for o in outs), \
                    (n, rows, dt)
                assert all(torch.equal(outs[0][r], outs[0][0])
                           for r in range(n)), (n, rows, dt)
                worst = max(worst, (outs[0].float() - outs[1].float())
                            .abs().max().item())
                if (n, rows, dt) != (SERVE_RANKS, 4, torch.bfloat16):
                    continue
                prog.inputs["x"].copy_(x)
                ms = time_ms([lambda: prog.step()])
                plain_ms = time_ms([lambda: prog.step(plain=True)], reps=1,
                                   rounds=3)
                lib_ms = time_ms([lambda: x.sum(0)])
                prog.check_fault()
                # the function's own bytes: the n partials read once and
                # the n replicated outputs written once; task_costs
                # counts the protocol's (pushes, landing reads) on top
                own = 2 * x.numel() * x.element_size()
                adds = (n - 1) * x[0].numel()
                bms, by = bound(own, adds, FP32_FLOPS)
                wire = sum(c["bytes"] for c in prog.task_costs())
                wire_ms, _ = bound(wire, adds, FP32_FLOPS)
                entry = {"name": "megakernel[AR]", "route": "cuda",
                         "source": "triton_distributed_tpu_torch/csrc/"
                                   "megakernel.cu",
                         "replaces": "triton_distributed_tpu/megakernel/"
                                     "executor_pallas.py:1600",
                         "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                         "bound_by": by, "library_ms": lib_ms}
                print(f"megakernel AR at n {n}, {rows} x 4096 bf16: kernel "
                      f"{ms:.4f} ms (one launch, push then sum), plain "
                      f"{plain_ms:.3f} ms, x.sum(0) {lib_ms:.4f} ms, bound "
                      f"{bms:.5f} ms ({by}: {own / 2**20:.3f} MiB, the n "
                      f"partials read and the n outputs written; with the "
                      f"protocol's pushes and landing reads {wire_ms:.5f} "
                      f"ms, {wire / 2**20:.3f} MiB)")
        print(f"megakernel AR at n {n}: kernel == plain bit for bit at rows "
              f"4 and 32, f32 and bf16, twice")
    chain = _ar_program(dev, SERVE_RANKS, 4, torch.bfloat16, AR_CHAIN)
    chain.inputs["x"].copy_(torch.randn(chain.inputs["x"].shape,
                                        generator=gen, device=dev))
    chain_ms = time_ms([lambda: chain.step()])
    chain.check_fault()
    print(f"megakernel AR chain: {AR_CHAIN} dependent AR nodes ({2 * AR_CHAIN}"
          f" tasks) at n {SERVE_RANKS}, 4 x 4096 bf16: {chain_ms:.4f} ms a "
          f"launch, {chain_ms / AR_CHAIN * 1e3:.1f} us a node")
    entry["max_abs_err"] = worst
    entry["chain_ms"] = chain_ms
    return entry


def check_megakernel_ar_fault(dev):
    """Step 45: a planted lost signal. One push notification is taken
    out of rank 2's counter for source rank 1 (row tile 0). The program
    has two tasks (push, sum) and no task after the sum, so only the
    sum's signal wait can pass its budget: the kernel records
    FAULT_SIGNAL with the sum task, source rank 1 and waiting rank 2, the
    launch ends, the check raises naming the AR sum and the push it never
    saw, and the next launch runs clean, equal to the plain walk."""
    from triton_distributed_tpu_torch.megakernel import executor_cuda as mkx
    prog = _ar_program(dev, SERVE_RANKS, 4, torch.bfloat16)
    x = torch.randn((SERVE_RANKS, 4, 4096), device=dev).to(torch.bfloat16)
    want = prog.step({"x": x}, plain=True)[0].clone()
    prog.step({"x": x})
    torch.cuda.synchronize()
    prog.check_fault()
    prog.signals[0, 2, 1, 0] -= 1
    t0 = time.perf_counter()
    prog.step({"x": x})
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    assert [t.op for t in prog.tasks] == ["all_reduce"] * 2, prog.tasks
    assert prog.fault.tolist() == [3, 1, 1, 2], prog.fault
    assert took < mkx.WAIT_BUDGET_S + 2.0, took
    try:
        prog.check_fault()
        raise AssertionError("megakernel AR: the planted fault did not raise")
    except RuntimeError as e:
        msg = str(e)
    assert "the first unfinished task is task 1 (all_reduce); its sum on " \
        "rank 2 never saw rank 1's push (row tile 0)" in msg, msg
    got = prog.step({"x": x})[0]
    torch.cuda.synchronize()
    prog.check_fault()
    assert torch.equal(got, want)
    print(f"megakernel AR planted lost signal: raised after {took:.3f} s "
          f"(budget {mkx.WAIT_BUDGET_S} s): {msg}; the next launch ran clean")


def check_megakernel_tp_graphs(dev):
    """Step 46: the tp_shards=True decode and serve graphs, 2 layers at
    Qwen3-8B's local widths for n = 4 (8 / 2 heads, intermediate 3072),
    every operand drawn for each rank: one decode row at cache_len 500
    (max_cache 1024) and the serve cell's 4 slots at lengths 0 (idle),
    128, 777 and 1500 on a shuffled table; the kernel against its plain
    walk, f32 (MK_F32_TOL) and bf16 (MK_BF16_2L_TOL) of the largest
    value, every rank's output and appended rows."""
    from triton_distributed_tpu_torch.megakernel.models import (
        build_qwen3_decode, build_qwen3_serve_batched)
    from triton_distributed_tpu_torch.parallel.mesh import RankGroup
    n = SERVE_RANKS
    local = dict(hidden=4096, intermediate=12288 // n, num_layers=2,
                 num_heads=32 // n, num_kv_heads=8 // n, head_dim=128,
                 qk_norm=True, mesh=RankGroup(n), tp_shards=True)
    lens = np.asarray([0, 128, 777, 1500], np.int32)
    tbl = _slot_table(lens, 128, 16, 64, 7)
    rows = torch.as_tensor(tbl[np.arange(4), lens // 128] * 128 + lens % 128,
                           device=dev)
    f32, bf16 = torch.float32, torch.bfloat16
    tol = {f32: MK_F32_TOL, bf16: MK_BF16_2L_TOL}
    for kind in ("decode", "serve"):
        for dt in (f32, bf16):
            if kind == "decode":
                mb = build_qwen3_decode(seq_len=1, max_cache=1024,
                                        kv_append=True, dtype=dt, **local)
                run = dict(cache_len=500)
                app = slice(500, 501)
            else:
                mb = build_qwen3_serve_batched(
                    b_slots=4, slot_rows=1, num_blocks=64, block=128,
                    max_pages=16, dtype=dt, **local)
                run = dict(cache_lens=lens, block_table=tbl)
                app = rows
            ins, ws = ({k: t.to(dt) for k, t in d.items()}
                       for d in _device_io(mb, dev, 46, ranks=n))
            prog = mb.compile("kernel", device=dev)
            prog.bind_weights(ws)
            got = []
            for plain in (False, True):
                prog.bind_caches({k: ins[k].clone() for k in mb.graph.caches})
                out = prog.step({"x": ins["x"]}, plain=plain, **run)[0]
                torch.cuda.synchronize()
                prog.check_fault()
                got.append((out.float().clone(),
                            torch.cat([c[:, app].float()
                                       for c in prog.caches.values()])))
            (ko, kr), (po, pr) = got
            errs = (_rel_err(ko, po), _rel_err(kr, pr))
            print(f"megakernel tp_shards {kind} {str(dt)[6:]}, 2 layers at "
                  f"Qwen3-8B widths over {n} ranks ({len(prog.tasks)} tasks, "
                  f"{int(prog.n_tiles.sum())} tiles): vs plain walk out "
                  f"{errs[0]:.3e}, appended rows {errs[1]:.3e} of max |ref|")
            assert torch.isfinite(ko).all() and max(errs) <= tol[dt], errs
            assert all(torch.equal(ko[r], ko[0]) for r in range(n))
            del prog, ins, ws, got
            torch.cuda.empty_cache()


def _tp_layout(pool, like):
    """An n-rank megakernel pool (L, n, pages x block, Hkv / n x D) in the
    engine's head-sharded layout (L, n, nb, Hkv / n, block, D)."""
    L, n, nb, hkv, blk, d = like.shape
    return pool.view(L, n, -1, blk, hkv, d)[:, :, :nb].permute(
        0, 1, 2, 4, 3, 5).contiguous()


def check_mk_tp_serve(models, attn, tp, tparams, cfg, seed, smi, targets):
    """Step 47, the slice-6d main path: the mk-tp-serve cell. The tp-serve
    cell's 4 rank shards behind ServeEngine(tp_ranks=4, mode="megakernel")
    ("gemm_ar" prefill) with step 9's stream and settings, bf16 pool, the
    program's scoreboard counters zeroed first: every request at its
    length, exactly one megakernel launch per decode tick and no paged
    decode launch, gemm_ar only in the prefill chunks (2 a layer), the AR
    tiles the counters show equal to 2 phases x 72 nodes x 4 ranks x the
    row tiles x the launches, the rank ledgers and AR bytes; the first
    all-slots tick's logits against the n-rank engine's decode_step_paged
    on the same state within 2.5e-2 of the largest; the batched step's
    time against its bound. Then speculative decoding (an oracle drafter
    over the tp-serve run's tokens, k 4, slot_rows 8): accepts and
    rejects, the verify width at n ranks launched. Returns its numbers."""
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import gemm_ar as ar
    from triton_distributed_tpu_torch.ops import grouped_gemm as gg
    from triton_distributed_tpu_torch.ops import ll_gather as tll
    n, L = SERVE_RANKS, cfg.num_layers
    stream = serve_stream(np.random.RandomState(seed), cfg.vocab_size)
    extra = {"gemm_ar": ar.GEMM_AR, "ll_merge": tll.LL_MERGE}
    res = {}
    for spec in (False, True):
        se = models.ServeEngine(
            tp, tparams, mode="megakernel", b_max=4, max_len=2048, block=128,
            prefill_chunk=256, num_blocks=64, tp_ranks=n,
            speculative=_oracle_spec(models, targets, stream, cfg.vocab_size)
            if spec else None)
        mk = se._mk
        prog = mk.prog
        assert prog.sharded and prog.n_ranks == n
        ar_tasks = [t for t, nd in enumerate(prog.tasks)
                    if nd.op == "all_reduce"]
        assert len(ar_tasks) == 2 * 2 * L and len(prog.tasks) == 17 * L + 1
        prog.counts.zero_()
        prog.signals.zero_()
        prog.epoch = 0
        snap = {}
        if not spec:
            real = se._decode_tick

            def tick(stream_cb, real=real):
                from triton_distributed_tpu_torch.models import serve_state
                if snap or len(serve_state.decode_live(se.sched)) < se.b_max:
                    return real(stream_cb)
                c = se._cache
                snap.update(toks=[s_.last_tok for s_ in se._slots],
                            lens=c.seq_lens.copy(),
                            table=c.block_table.copy(),
                            k=_tp_layout(mk.k_pool, c.k_pool),
                            v=_tp_layout(mk.v_pool, c.v_pool))
                snap["ktab"] = mk.kernel_table(
                    torch.from_numpy(snap["table"]),
                    torch.ones(se.b_max, dtype=torch.bool))
                real(stream_cb)
                snap["hid"] = prog.outputs()[0][0][::mk.slot_rows].float(
                    ).clone()

            se._decode_tick = tick      # run_serve wraps it, then drops both

        def want(st):
            return {"gemm_ar": 2 * L * st["prefill_chunks"], "ll_merge": 0}

        tag = f"mk-tp-serve[bf16{', spec' if spec else ''}]"
        out, st, launches, tick_ms, ops = run_serve(models, attn, se, stream,
                                                    L, gg, extra, want)
        shmem.check_faults()
        prog.check_fault()
        assert launches["megakernel"] == st["megakernel_steps"] \
            == st["decode_steps"] > 0, launches
        _check_stream_run(models, se, out, st, stream, cfg.vocab_size)
        counts = prog.counts.cpu().numpy().astype(np.int64)
        ar_tiles = int(counts[ar_tasks].sum())
        want_tiles = int(prog.n_tiles[ar_tasks].sum()) * st["decode_steps"]
        assert ar_tiles == want_tiles > 0, (ar_tiles, want_tiles)
        pr = st["per_rank"]
        assert len(pr) == n and all(
            r == {**pr[0], "rank": i} for i, r in enumerate(pr)) \
            and pr[0]["held_blocks"] == 0 and pr[0]["ar_bytes_pushed"] == \
            st["decode_steps"] * mk.ar_bytes_per_step, pr
        print(f"{tag}: {st['tokens']} tokens in {st['wall_s']:.3f} s "
              f"({st['tokens_per_s']} tokens/s), {st['ticks']} ticks, "
              f"{st['decode_steps']} decode ticks at "
              f"{statistics.median(tick_ms):.2f} ms median "
              f"({min(tick_ms):.2f}-{max(tick_ms):.2f}; {ops} aten ops a "
              f"tick), {st['prefill_chunks']} chunks, launches "
              f"{ {k: c for k, c in launches.items() if c} }, AR tiles "
              f"{ar_tiles} from the scoreboard ({len(ar_tasks)} AR tasks), "
              f"AR bytes a rank {pr[0]['ar_bytes_pushed']} | {smi}")
        if spec:
            assert st["spec_accepted"] > 0 and st["spec_rejected"] > 0, st
            assert mk.slot_rows == 8
            print(f"{tag}: drafts proposed / accepted / rejected "
                  f"{st['spec_proposed']} / {st['spec_accepted']} / "
                  f"{st['spec_rejected']} over {st['decode_steps']} verify "
                  f"launches at slot_rows {mk.slot_rows}")
            res["verify_launches"] = st["decode_steps"]
            res["spec_tokens_per_s"] = st["tokens_per_s"]
            continue
        res.update(decode_launches=st["decode_steps"],
                   tokens_per_s=st["tokens_per_s"],
                   tick_ms=statistics.median(tick_ms), ops=ops)
        # teacher forcing: the n-rank engine's decode step on that state
        ref = tp.new_paged_kv_cache(4, 2048, block=128, num_blocks=64)
        ref.k_pool.copy_(snap["k"])
        ref.v_pool.copy_(snap["v"])
        ref.block_table[:] = snap["table"]
        ref.seq_lens[:] = snap["lens"]
        seen, real_next = [], tp._next_token

        def spy(x, p, generator, **kw):
            seen.append(_full_logits(x, p["lm_head"]).cpu())
            return real_next(x, p, generator, **kw)

        tp._next_token = spy
        try:
            tp.decode_step_paged(tparams, snap["toks"], ref, [True] * 4)
        finally:
            del tp._next_token
        shmem.check_faults()
        want_lg = seen[0].to(snap["hid"].device)
        got_lg = _full_logits(snap["hid"], tparams["lm_head"])
        err = _rel_err(got_lg, want_lg)
        print(f"mk-tp-serve teacher forcing: the first all-slots tick "
              f"(lengths {snap['lens'].tolist()}) logits vs the {n}-rank "
              f"decode_step_paged on the same state {err:.3e} of max "
              f"|logit|; greedy {got_lg.argmax(-1).tolist()} vs "
              f"{want_lg.argmax(-1).tolist()}")
        assert torch.isfinite(got_lg).all() and err <= 2.5e-2, err
        del ref, seen
        lens, ktab = snap["lens"], snap["ktab"]
        ms = time_ms([lambda: prog.step(cache_lens=lens, block_table=ktab)])
        prog.check_fault()
        costs = prog.task_costs(cache_lens=lens)
        moved = sum(c["bytes"] for c in costs)
        flops = sum(c["flops"] for c in costs)
        ar_moved = sum(c["bytes"] for t, c in enumerate(costs)
                       if t in ar_tasks)
        bms, by = bound(moved, flops)
        print(f"mk-tp-serve batched step ({n} ranks in one launch, 4 live "
              f"rows, lengths {lens.tolist()}): kernel {ms:.4f} ms, bound "
              f"{bms:.4f} ms ({by}: {moved / 1e9:.3f} GB, of which the AR "
              f"tasks {ar_moved / 2**20:.2f} MiB; {flops / 1e9:.2f} GFLOP), "
              f"{len(prog.tasks)} tasks in {int(prog.n_tiles.sum())} tiles, "
              f"teacher forcing {err:.3e} | {smi}")
        res.update(step_ms=ms, bound_ms=bms, bound_by=by, tf_err=err)
        del snap
        torch.cuda.empty_cache()
    del se, mk, prog
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _sp_attention_launches(stream, n, chunk, rank_tokens):
    """flash_attention launches of one layer over the stream's prefill
    chunks under "sp": the n ring hops of every chunk, one more for the
    prefix ranks a chunk's offset fills and one for a rank it fills in
    part."""
    total = 0
    for ids, _ in stream:
        for off in range(0, len(ids), chunk):
            full, part = divmod(off, rank_tokens)
            total += n + (full > 0) + (part > 0)
    return total


def check_sp_serve(models, attn, model, params, cfg, seed, smi):
    """The sp-serve cell: the Qwen3-8B weights replicated in the 4-rank
    fused layout behind ServeEngine(DenseLLM(num_ranks=4,
    attn_parallelism="sp")) with the serve cell's stream and settings,
    prefix caching off (so the 612- and 1500-token prompts cross the
    512-token ownership boundaries), sp_combine "ll" then "xla": exact
    launch counts (the paged decode kernel and, under "ll", the combine
    once a layer a decode tick; flash_attention the ring's n hops and the
    prefix partials a prefill chunk), every request at its length,
    check_conservation_sp; then the teacher-forced paged logits of "ll"
    against "xla" and against the one-rank model within TP_LOGIT_TOL.
    Returns the launches over the runs."""
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import ll_gather as tll
    n, L = SERVE_RANKS, cfg.num_layers
    t0 = time.perf_counter()
    sp = {c: models.DenseLLM(cfg, mode="ar", dtype="bfloat16", device="cuda",
                             num_ranks=n, attn_parallelism="sp",
                             sp_combine=c) for c in ("ll", "xla")}
    sparams = sp["ll"].shard_params(params)
    torch.cuda.synchronize()
    print(f"sp-serve: Qwen3-8B re-laid for {n} sequence-parallel ranks in "
          f"{time.perf_counter() - t0:.1f} s")
    stream = serve_stream(np.random.RandomState(seed), cfg.vocab_size)
    fa = _sp_attention_launches(stream, n, 256, 2048 // n)
    extra = {"ll_combine": tll.LL_COMBINE, "ll_merge": tll.LL_MERGE}
    totals, outs = {}, {}
    for comb in ("ll", "xla"):
        se = models.ServeEngine(sp[comb], sparams, b_max=4, max_len=2048,
                                block=128, prefill_chunk=256, num_blocks=64)
        assert se.attn_parallelism == "sp" and se.sp_combine == comb

        def want(st, comb=comb):
            return {"flash_attention": L * fa,
                    "ll_combine": L * st["decode_steps"] if comb == "ll"
                    else 0, "ll_merge": 0}

        outs[comb], st, launches = _serve_cell(
            models, attn, se, stream, L, f"sp-serve[{comb}]", smi, extra,
            want, cfg.vocab_size)
        se._cache.check_conservation_sp(n)
        assert st["free_blocks"] == 64 and st["prefix_hit_blocks"] == 0, st
        for k, c in launches.items():
            totals[k] = totals.get(k, 0) + c
    same = np.mean([np.mean(outs["ll"][r] == outs["xla"][r])
                    for r in outs["ll"]])
    print(f"sp-serve: ll vs xla greedy tokens equal {same:.3f} "
          f"(free-running, information)")
    rng = np.random.RandomState(seed + 7)
    prompts = [stream[i][0] for i in range(4)]
    toks = rng.randint(0, cfg.vocab_size, (4, 8)).astype(np.int32)
    forced = {c: _paged_forced_logits(sp[c], sparams, prompts, toks)
              for c in ("ll", "xla")}
    ref = _paged_forced_logits(model, params, prompts, toks)
    shmem.check_faults()
    vs_xla = [_rel_err(g, r) for g, r in zip(forced["ll"], forced["xla"])]
    vs_one = [_rel_err(g, r) for g, r in zip(forced["ll"], ref)]
    print(f"sp-serve ll: teacher-forced paged logits (4 prompts' last rows + "
          f"8 decode steps) vs xla max {max(vs_xla):.3e} of the largest "
          f"(per step {', '.join(f'{e:.2e}' for e in vs_xla)}); vs the "
          f"one-rank model max {max(vs_one):.3e}")
    assert max(vs_xla) <= TP_LOGIT_TOL and max(vs_one) <= TP_LOGIT_TOL
    del sp, sparams, se
    shmem.release_workspaces()
    gc.collect()
    torch.cuda.empty_cache()
    return totals


# ---------------------------------------------------------------------------
# Slice 6e: the quantized wire on the TP layers (the quant arms of
# csrc/gemm_rs.cu and gemm_ar.cu), and n-rank MoE serving
# ---------------------------------------------------------------------------

WIRE_RANKS = 4                 # the tp-wire and ep-serve cells
WIRES = {"int8": "int8", "fp8": "float8_e4m3fn"}
# one Qwen3-8B layer (hidden, intermediate, q / kv heads, head_dim), 4
# prompts of 512 rows at prefill, 4 rows at decode over 500 cached rows
WIRE_LAYER = dict(H=4096, I=12288, NH=32, NKV=8, D=128, B=4, S=512, KV=500)


class _Partials:
    """Records the row-parallel epilogues' f32 partials (rows @ w, rank by
    rank) of the TP layers while active, for the wire's error bound."""

    def __init__(self):
        from triton_distributed_tpu_torch.layers import tp_attn, tp_mlp
        self.mods, self.seen = (tp_attn, tp_mlp), []

    def __enter__(self):
        real = self.mods[0].row_parallel_out
        self.real = real

        def spy(rows, w, **kw):
            self.seen.append((rows.float() @ w.float()))
            return real(rows, w, **kw)

        for m in self.mods:
            m.row_parallel_out = spy
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m.row_parallel_out = self.real


def _wire_layer_check(tag, wd, got, full, parts):
    """A wired layer's output against its full-width output: within
    wire.sum_error_bound of the partials plus the full-width path's own
    bf16 roundings (each partial and the sum), and nonzero (it really
    quantized). Returns the largest difference over the largest value."""
    from triton_distributed_tpu_torch.ops import wire
    bound = torch.from_numpy(wire.sum_error_bound(parts, wd)).to(got.device)
    bound = bound.reshape(full.shape)
    ulp = 2.0 ** -8
    slack = ulp * parts.abs().sum(0).reshape(full.shape) \
        + ulp * full.float().abs()
    dev = (got.float() - full.float()).abs()
    assert bool((dev <= bound + slack).all()), (tag, dev.max().item())
    assert dev.max().item() > 0, tag
    rel = (dev.max() / full.float().abs().max()).item()
    assert rel < 8 * wire.quant_eps(wd), (tag, rel)
    return rel, (bound.max() / full.float().abs().max()).item()


def _quant_bound(op, n, M, K, N, blk):
    """(bytes, operations) a quant arm's call needs: A and B read once, the
    output written once (gemm_ar: n replicas), the landing bytes and
    scales written and read once each (gemm_ar: n destinations)."""
    out = M * N if op == "gemm_rs" else n * M * N
    fan = 1 if op == "gemm_rs" else n
    land = fan * n * M * N + fan * n * M * (N // blk) * 4
    return (n * M * K + n * K * N + out) * 2 + 2 * land, 2 * n * M * K * N


def check_tp_wire(dev, gen, smi):
    """The tp-wire cell: one Qwen3-8B layer's TPMLP and TPAttn at n = 4,
    bf16, with an int8 and an fp8 wire: prefill of 4 x 512 rows in
    "fused" (the gemm_rs quant arm, o and down), decode of 4 rows in
    "gemm_ar" (the gemm_ar quant arm) and in "ar" (quant_psum). The layers
    run first with the quant arms' launch counts set to 0, held to the
    calls they imply (two a setting in "fused" and "gemm_ar", none in
    "ar"), each output against its full-width output (_wire_layer_check).
    Then each quant arm at the layers' shapes against its plain version,
    and its time next to its bound, the plain version's and the
    full-width arm's. Returns the kernels-line entries."""
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.layers import tp_attn, tp_mlp
    from triton_distributed_tpu_torch.ops import _common
    from triton_distributed_tpu_torch.ops import gemm_ar as ar
    from triton_distributed_tpu_torch.ops import gemm_rs as rs
    from triton_distributed_tpu_torch.ops import wire
    n = WIRE_RANKS
    H, I, NH, NKV, D, B, S, KV = (WIRE_LAYER[k] for k in (
        "H", "I", "NH", "NKV", "D", "B", "S", "KV"))
    t0 = time.perf_counter()

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=dev)
                / shape[0] ** 0.5).bfloat16()

    mlp_w = (w(H, I), w(H, I), w(I, H))
    attn_w = (w(H, NH * D), w(H, NKV * D), w(H, NKV * D), w(NH * D, H))
    x = torch.randn((B, S, H), generator=gen, device=dev).bfloat16()
    xd = torch.randn((B, H), generator=gen, device=dev).bfloat16()
    kern = {"gemm_rs": rs.GEMM_RS_QUANT, "gemm_ar": ar.GEMM_AR_QUANT}
    launches = {(op, wl): 0 for op in kern for wl in WIRES}
    shapes = {}                 # (op, name) -> (M, K, N) the layers gave
    for wl, wd in WIRES.items():
        for mode in ("fused", "gemm_ar", "ar"):
            outs = {}
            cache = None
            if mode != "fused":     # one cache of 500 rows for both runs
                cache = tp_attn.TPAttn(H, NH, NKV, D, num_ranks=n) \
                    .new_kv_cache(B, KV + 1, dtype=torch.bfloat16, device=dev)
                for c in cache:
                    c.normal_(generator=gen)
            for wire_dtype in (None, wd):
                mlp = tp_mlp.TPMLP(H, I, mode=mode, num_ranks=n,
                                   wire_dtype=wire_dtype)
                att = tp_attn.TPAttn(H, NH, NKV, D, mode=mode, num_ranks=n,
                                     qk_norm=True, wire_dtype=wire_dtype)
                mp, ap = mlp.shard_params(*mlp_w), att.shard_params(*attn_w)
                for k in kern.values():
                    k.launches = 0
                _common.reset_dispatch()
                with _Partials() as parts:
                    if mode == "fused":     # prefill, sequence-sharded rows
                        ym = mlp(mp, x.reshape(n, -1, H))
                        ya, _ = att.prefill(ap, x)
                        got = (ym.reshape(-1, H), ya.transpose(0, 1)
                               .reshape(-1, H))
                    else:                   # decode on 4 replicated rows
                        ym = mlp(mp, xd)
                        ya, _ = att.decode(ap, xd, cache, KV)
                        got = (ym, ya)
                    torch.cuda.synchronize()
                shmem.check_faults()
                outs[wire_dtype] = (got, parts.seen,
                                    {o: k.launches for o, k in kern.items()},
                                    _common.dispatch_counts())
            (full, _, _, _), (got, seen, count, log) = outs[None], outs[wd]
            op = {"fused": "gemm_rs", "gemm_ar": "gemm_ar"}.get(mode)
            want = {o: (2 if o == op else 0) for o in kern}
            assert count == want, (mode, wl, count, want)
            if op is not None:
                assert log.get((op, "kernel", "wire")) == 2, log
                for o in kern:
                    launches[(o, wl)] += count[o]
            for (name, g, f), part in zip(
                    (("mlp", got[0], full[0]), ("attn", got[1], full[1])),
                    seen):
                rel, brel = _wire_layer_check(f"tp-wire {mode} {wl} {name}",
                                              wd, g, f, part)
                M, N = part.shape[1], part.shape[2]
                if op is not None:
                    K = (I if name == "mlp" else NH * D) // n
                    shapes[(op, "down" if name == "mlp" else "o")] = (M, K, N)
                print(f"tp-wire {mode} {wl} {name} ({n} ranks, {M} rows): "
                      f"output vs wire_dtype=None {rel:.3e} of the largest "
                      f"(sum_error_bound {brel:.3e}); quant arm launches "
                      f"{count}")
    print(f"tp-wire: layer runs {time.perf_counter() - t0:.1f} s | {smi}")

    # each quant arm at the layers' shapes, against its plain version, and
    # timed next to its bound, the plain version and the full-width arm
    ops = {"gemm_rs": (rs.gemm_rs_shard, rs._gemm_rs_quant_plain,
                       "triton_distributed_tpu/ops/gemm_rs.py:176"),
           "gemm_ar": (ar.gemm_ar_shard, ar._gemm_ar_quant_plain,
                       "triton_distributed_tpu/ops/gemm_ar.py:156")}
    timed = {"gemm_rs": "down", "gemm_ar": "down"}
    entries = {}
    for (op, name), (M, K, N) in sorted(shapes.items()):
        fn, plain, where = ops[op]
        blk = 256
        a = (torch.randn((n, M, K), generator=gen, device=dev)
             / K ** 0.5).bfloat16()
        b = torch.randn((n, K, N), generator=gen, device=dev).bfloat16()
        full_ms = time_ms([lambda: fn(a, b, num_ranks=n)])
        for wl, wd in WIRES.items():
            got = fn(a, b, num_ranks=n, wire_dtype=wd)
            torch.cuda.synchronize()
            shmem.check_faults()
            want = plain(a, b, wd, blk)
            if op == "gemm_ar":
                assert all(torch.equal(got[r], got[0]) for r in range(n))
                got, want = got[0], want[0]
            parts = a.float() @ b.float()
            bnd = torch.from_numpy(wire.sum_error_bound(parts, wd)).to(dev)
            bnd = bnd.reshape(want.shape)
            err = (got.float() - want.float()).abs()
            assert bool((err <= 2 * bnd + 2.0 ** -7 * want.float().abs())
                        .all()), (op, name, wl, err.max().item())
            same = (got == want).float().mean().item()
            assert same > 0.99, (op, name, wl, same)
            ms = time_ms([lambda: fn(a, b, num_ranks=n, wire_dtype=wd)])
            plain_ms = time_ms([lambda: plain(a, b, wd, blk)], reps=3,
                               rounds=3)
            nb, fl = _quant_bound(op, n, M, K, N, blk)
            bms, by = bound(nb, fl)
            print(f"tp-wire {op}[{wl}] {name} n {n} (M {M}, K {K}, N {N}, "
                  f"block {blk}): kernel vs plain {err.max().item():.3e} "
                  f"({same:.5f} of the elements bit for bit); kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, full-width arm "
                  f"{full_ms:.4f} ms, bound {bms:.4f} ms ({by}: "
                  f"{nb / 1e9:.3f} GB, {fl / 1e9:.1f} GFLOP; "
                  f"{fl / ms / 1e9:.1f} TFLOP/s) | {smi}")
            key = f"{op}[{wl}]"
            e = entries.setdefault(key, {
                "name": key, "route": "cuda",
                "source": f"triton_distributed_tpu_torch/csrc/{op}.cu",
                "replaces": where, "launches": launches[(op, wl)],
                "max_abs_err": 0.0, "library_ms": None})
            e["max_abs_err"] = max(e["max_abs_err"], err.max().item())
            if name == timed[op]:
                e.update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
        del a, b
    shmem.release_workspaces()
    torch.cuda.empty_cache()
    for e in entries.values():
        assert e["launches"] > 0, e["name"]
    print(f"tp-wire: launches on the layer runs "
          f"{ {k: e['launches'] for k, e in entries.items()} }; phase "
          f"{time.perf_counter() - t0:.1f} s")
    return [entries[f"{op}[{wl}]"] for op in ops for wl in WIRES]


def check_ep_serve(models, attn, moe, moe_params, cfg, seed, smi):
    """The ep-serve cell: the moe serve stream behind
    ServeEngine(Qwen3MoE(num_ranks=4, moe_parallel="ep",
    ep_method="ragged"), tp_ranks=4) at full depth (48 layers), the
    experts as views of the one-rank model's, with a bf16 pool, then again
    with ep_capacity=2. Each run: tokens/s, ticks, aten ops a tick, peak
    memory, launch counts held to the ticks (flash_attention a layer a
    chunk, the paged decode a layer a decode tick, gmm twice a layer a
    step: decode_rows_shard's one launch a projection for every rank's
    experts; ep_a2a never: every paged step takes replicated rows, as in
    JAX), every request at its length (none cut under the budget), the
    rank ledgers. Then the teacher-forced paged logits of 4 prompts and 8
    decode steps, the one-rank model's routing forced, against the
    one-rank model's within TP_LOGIT_TOL. Then TP experts on the first 8
    layers (the cut of the ep-engine cell), checked the same way. Returns
    the launches over the runs."""
    import dataclasses
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import ep_a2a as tep
    from triton_distributed_tpu_torch.ops import gemm_ar as ar
    n, L, k = WIRE_RANKS, cfg.num_layers, cfg.num_experts_per_tok
    t0 = time.perf_counter()
    stream = serve_stream(np.random.RandomState(seed), cfg.vocab_size)
    rng = np.random.RandomState(seed + 11)
    prompts = [stream[i][0] for i in range(4)]
    toks = rng.randint(0, cfg.vocab_size, (4, 8)).astype(np.int32)
    extra = {"ep_a2a": tep.EP_A2A, "gemm_ar": ar.GEMM_AR}
    totals = {}

    def serve_runs(tag, model, params, L, gmm_per_step):
        for cap in (0, 2):
            se = models.ServeEngine(model, params, b_max=4, max_len=2048,
                                    block=128, prefill_chunk=256,
                                    num_blocks=64, ep_capacity=cap,
                                    tp_ranks=n)

            def want(st):
                steps = st["prefill_chunks"] + st["decode_steps"]
                return {"ep_a2a": 0, "gemm_ar": 0,
                        "gmm": gmm_per_step * L * steps}

            torch.cuda.reset_peak_memory_stats()
            name = f"{tag}[ep_capacity={cap}]"
            out, st, launches = _serve_cell(models, attn, se, stream, L,
                                            name, smi, extra, want,
                                            cfg.vocab_size)
            print(f"{name}: peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
                  f"capacity_drops {st['capacity_drops']}, ep_rows "
                  f"{st['ep_rows']}, ep_plan {st['ep_plan']}")
            se._cache.check_conservation(cached=st["cached_free_blocks"])
            pr = st["per_rank"]
            assert st["tp_ranks"] == n and len(pr) == n \
                and all(r == {**pr[0], "rank": i} for i, r in enumerate(pr)) \
                and pr[0]["held_blocks"] == 0, pr
            if cap:
                assert st["capacity_drops"] > 0, st
                assert st["ep_rows"] == sum(g - 1 for _, g in stream), st
            for key, c in launches.items():
                totals[key] = totals.get(key, 0) + c
            del se

    ep = models.Qwen3MoE(cfg, dtype="bfloat16", device="cuda", num_ranks=n,
                         moe_parallel="ep", ep_method="ragged")
    eparams = ep.shard_params(moe_params)
    torch.cuda.synchronize()
    for key in ("w_moe_gate_up", "w_moe_down"):
        assert eparams["layers"][key].data_ptr() == \
            moe_params["layers"][key].data_ptr(), key
    serve_runs("ep-serve", ep, eparams, L, 2)
    _forced_checks("ep-serve", moe, moe_params, ep, eparams, prompts, toks,
                   toks.shape[1], k, paged=True)
    del ep, eparams
    shmem.release_workspaces()
    gc.collect()
    torch.cuda.empty_cache()

    L8 = 8                      # TP experts: the ep-engine cell's cut
    cfg8 = dataclasses.replace(cfg, num_layers=L8)
    p8 = {**moe_params,
          "layers": {key: t[:L8] for key, t in moe_params["layers"].items()}}
    one8 = models.Qwen3MoE(cfg8, dtype="bfloat16", device="cuda")
    tp8 = models.Qwen3MoE(cfg8, dtype="bfloat16", device="cuda", num_ranks=n)
    tparams = tp8.shard_params(p8)
    serve_runs(f"ep-serve TP experts ({L8} layers)", tp8, tparams, L8, 2 * n)
    _forced_checks(f"ep-serve TP experts ({L8} layers)", one8, p8, tp8,
                   tparams, prompts, toks, toks.shape[1], k, paged=True)
    del tp8, tparams, one8, p8
    shmem.release_workspaces()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"ep-serve: phase {time.perf_counter() - t0:.1f} s")
    return totals


# ---------------------------------------------------------------------------
# Slice 6h: the SP family beyond serving (csrc/flash_attention.cu's varlen
# arm, csrc/sp_ag_attention.cu)
# ---------------------------------------------------------------------------

SP_RANKS = 4                   # the sp-family cell's n
SP_SEQ = 8192                  # rows of the long prefill / the packed batch
SP_SHAPE = (32, 8, 128)        # Qwen3-8B's attention: heads, kv heads, D
SP_DECODE = (4, 2048)          # decode slots, cache positions a rank
SP_ROW_TOL = 8e-2              # sp family, of each output row's RMS: one
                               # bf16 step of an element up to 5x its row's
                               # RMS is 2^-7 x 5 = 0.039; twice that


def _sp_lens(seed, total, lo=64, hi=1500):
    """Sequence lengths drawn from the serve cell's prompt range, packed
    until the next would reach `total`: cu_seqlens[-1] < total."""
    rng = np.random.default_rng(seed)
    lens = []
    while True:
        L = int(rng.integers(lo, hi + 1))
        if sum(lens) + L >= total:
            return lens
        lens.append(L)


def _sp_pairs(lens, causal=True):
    """(row, column) pairs a packed batch's rows see."""
    return sum(L * (L + 1) // 2 if causal else L * L for L in lens)


def sp_errs(got, want):
    """(max |got - want|, the largest |got - want| over the RMS of want's
    last axis at that element). The second holds the error against the
    scale of what it compares: an attention row over N keys of unit-
    variance values has an RMS near sqrt(e / N), 0.018 at N = 8192."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    rms = w.pow(2).mean(-1, keepdim=True).sqrt().clamp_min(1e-30)
    return d.max().item(), (d / rms).max().item()


def check_sp_family(dev, gen):
    """The sp-family cell: Qwen3-8B's attention (32 / 8 heads of 128, bf16)
    at n = 4 sequence-parallel ranks. First each kernel against its plain
    version at the cell's shapes (the plain versions chunked over q rows):
    the varlen arm of csrc/flash_attention.cu on the packed batch (out and
    lse), csrc/sp_ag_attention.cu causal and full, dense and varlen. Then
    the main path, every count set to 0: a causal prefill of 8192 rows
    (2048 a rank) through sp_ag_attention (logged "kernel"), ring_attention
    and UlyssesAttn(4096, 32, 8, 128) on an (8192, 4096) activation; a
    packed varlen batch of 8192 rows (lengths drawn from 64-1500, some
    crossing shard boundaries, rows past cu_seqlens[-1] exactly 0) through
    flash_attention_varlen, ring_attention_varlen and sp_ag_attention(
    cu_seqlens=); one decode step of SpFlashDecodeAttention (4 slots, a
    cache of 4 x 2048 positions) under "xla" and "ll". The launches are
    read back against what the steps imply, and each result is held
    against the one-device golden over the gathered sequence (the port's
    flash_attention per sequence, flash_attention_varlen, flash_decode)
    within OUT_TOL (OUT_TOL of the value above 1: the goldens round at
    other points) and within SP_ROW_TOL of each row's RMS (`close`). Every call of a kernel against its plain version takes
    new data, so a consumer that read a landing slot before its signal
    would find another call's rows there. Then each kernel timed at the
    cell against its bound, its plain version and the library yardstick.
    Returns (the two kernels-line entries, the main path's launches by
    kernel name)."""
    import torch.nn.functional as F
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.layers import (SpFlashDecodeAttention,
                                                     UlyssesAttn)
    from triton_distributed_tpu_torch.ops import _common, ll_gather
    from triton_distributed_tpu_torch.ops import attention as attn
    from triton_distributed_tpu_torch.ops import sp_ag_attention as tag
    from triton_distributed_tpu_torch.ops import sp_attention as tsp
    t0 = time.perf_counter()
    n, T = SP_RANKS, SP_SEQ
    H, Hkv, D = SP_SHAPE
    s_loc = T // n
    scale = D ** -0.5

    def draw(*lead):
        return tuple(torch.randn((*lead, h, D), generator=gen,
                                 device=dev).bfloat16() for h in (H, Hkv, Hkv))

    q, k, v = draw(1, T)            # the causal prefill
    qp, kp, vp = draw(1, T)         # the packed batch
    lens = _sp_lens(7, T)
    cu = torch.tensor([0, *np.cumsum(lens)], dtype=torch.int32, device=dev)
    live = int(cu[-1])
    starts = np.cumsum([0, *lens[:-1]])
    crossing = sum(1 for a, L in zip(starts, lens)
                   if a // s_loc != (a + L - 1) // s_loc)
    assert live < T and crossing > 0, (live, crossing)
    meta = attn.segment_sideband(cu, T)
    err = {"flash_attention_varlen": 0.0, "sp_ag_attention": 0.0}

    def close(name, got, want, rows=None, tol=OUT_TOL, golden=False):
        """Within tol of want on the first `rows` rows and within
        SP_ROW_TOL of each row's RMS (`sp_errs`), the rest exactly 0. Returns (max abs error, max error
        of the row's RMS). Against a golden that rounds q * scale to bf16
        where the kernel scales the f32 scores, two bf16 results may sit a
        step apart, and a step grows with the value: there tol also scales
        with |want| above 1."""
        rows = got.shape[-3] if rows is None else rows
        assert got.shape == want.shape and bool(got.isfinite().all()), name
        g, w = (t[..., :rows, :, :].float() for t in (got, want))
        lim = tol * (w.abs().clamp_min(1.0) if golden else 1.0)
        e, r = sp_errs(g, w)
        assert bool(((g - w).abs() <= lim).all()), (name, e)
        assert r <= SP_ROW_TOL, (name, r)
        assert (got[..., rows:, :, :] == 0).all(), name
        if name in err and not golden:
            err[name] = max(err[name], e)
        return e, r

    def fmt(errs):
        return {k_: (round(e_, 6), round(r_, 4)) for k_, (e_, r_) in
                errs.items()}

    # 1. each kernel against its plain version at the cell
    offs = torch.tensor([[0, 0, T]], dtype=torch.int32, device=dev)
    got, lse = attn._fa_varlen_call(qp, kp, vp, meta[None], offs,
                                    causal=True, scale=scale, need_lse=True)
    want, want_lse = attn._flash_attention_varlen_plain(
        qp, kp, vp, meta[None], offs, causal=True, scale=scale)
    e_var = close("flash_attention_varlen", got, want, live)
    want_var = want
    e_lse = (lse[:, :live] - want_lse[:, :live]).abs().max().item()
    assert e_lse <= LSE_TOL, e_lse
    metas = meta.view(n, s_loc, 128)
    cfg = tag.SpAgAttnConfig(force_kernel=True)
    e_ag = {}
    for causal in (True, False):
        for varlen in (False, True):
            m = metas if varlen else None
            qn, kn, vn = draw(n, 1, s_loc)
            got = tag.sp_ag_attention_shard(qn, kn, vn, num_ranks=n,
                                            causal=causal, config=cfg,
                                            qmeta=m)
            want = tag._sp_ag_attention_plain(
                qn[:, 0], kn[:, 0], vn[:, 0], m, causal=causal,
                scale=scale)[:, None]
            torch.cuda.synchronize()
            shmem.check_faults()
            e_ag[(causal, varlen)] = close(
                "sp_ag_attention", got.reshape(1, T, H, D),
                want.reshape(1, T, H, D), live if varlen else T)
    print(f"sp family kernels vs plain (n {n}, {T} rows, {H} / {Hkv} heads "
          f"of {D}, bf16): flash_attention_varlen causal over {len(lens)} "
          f"packed sequences ({live} rows live, {crossing} across shard "
          f"boundaries) (max_abs_err, of the row RMS) ({e_var[0]:.3e}, "
          f"{e_var[1]:.4f}), lse {e_lse:.3e}; sp_ag_attention (causal, "
          f"varlen), each call on new data: {fmt(e_ag)}")

    # 2. the main path, every count set to 0
    kernels = {"flash_attention": attn.FLASH_ATTENTION,
               "flash_attention_varlen": attn.FLASH_ATTENTION_VARLEN,
               "sp_ag_attention": tag.SP_AG_ATTENTION,
               "flash_decode": attn.FLASH_DECODE,
               "ll_combine": ll_gather.LL_COMBINE}
    layer = UlyssesAttn(4096, H, Hkv, D, num_ranks=n)
    uparams = layer.init_params(gen, device=dev)
    x = (torch.randn((T, 4096), generator=gen, device=dev) * 0.5).bfloat16()
    B, S_rank = SP_DECODE
    qd = torch.randn((B, H, D), generator=gen, device=dev).bfloat16()
    kc, vc = (torch.randn((B, n * S_rank, Hkv, D), generator=gen,
                          device=dev).bfloat16() for _ in range(2))
    kv_len = torch.tensor([n * S_rank, n * S_rank * 5 // 8, S_rank + 1, 100],
                          dtype=torch.int32, device=dev)
    decoders = {c: SpFlashDecodeAttention(H, Hkv, D, num_ranks=n, combine=c)
                for c in ("xla", "ll")}
    torch.cuda.synchronize()
    for kern in kernels.values():
        kern.launches = 0
    _common.reset_dispatch()
    t_main = time.perf_counter()
    outs = {
        "sp_ag_attention": tag.sp_ag_attention(q, k, v, num_ranks=n),
        "ring_attention": tsp.ring_attention(q, k, v, num_ranks=n),
        "UlyssesAttn": layer(uparams, x),
        "flash_attention_varlen": attn.flash_attention_varlen(
            qp[0], kp[0], vp[0], cu),
        "ring_attention_varlen": tsp.ring_attention_varlen(
            qp[0], kp[0], vp[0], cu, num_ranks=n),
        "sp_ag_attention(cu_seqlens)": tag.sp_ag_attention(
            qp, kp, vp, num_ranks=n, cu_seqlens=cu)}
    for c, dec in decoders.items():
        outs[f"SpFlashDecodeAttention[{c}]"] = dec(qd, kc, vc, kv_len)
    torch.cuda.synchronize()
    shmem.check_faults()
    main_s = time.perf_counter() - t_main
    launches = {name: kern.launches for name, kern in kernels.items()}
    want_launches = {"flash_attention": n + 1, "flash_attention_varlen": 1 + n,
                     "sp_ag_attention": 2, "flash_decode": 2, "ll_combine": 1}
    assert launches == want_launches, (launches, want_launches)
    assert _common.dispatch_counts("sp_ag_attention") == {
        ("sp_ag_attention", "kernel", ""): 2}, _common.dispatch_counts()

    # the one-device goldens over the gathered sequence
    gdense = attn.flash_attention(q, k, v, causal=True)
    gvar = torch.zeros_like(qp[0])
    for a, L in zip(starts, lens):
        gvar[a:a + L] = attn.flash_attention(
            qp[:, a:a + L], kp[:, a:a + L], vp[:, a:a + L], causal=True)[0]
    gdec = attn.flash_decode(qd, kc, vc, kv_len)
    wq, wkv = H * D // n, Hkv * D // n
    w = uparams["w_qkv"]
    w_q = w[:, :, :wq].reshape(4096, H * D)
    w_k = w[:, :, wq:wq + wkv].reshape(4096, Hkv * D)
    w_v = w[:, :, wq + wkv:].reshape(4096, Hkv * D)
    cos, sin = attn.rope_cos_sin(torch.arange(T, device=dev), D)
    uq = attn.apply_rope((x @ w_q).view(1, T, H, D), cos, sin)
    uk = attn.apply_rope((x @ w_k).view(1, T, Hkv, D), cos, sin)
    uo = attn.flash_attention(uq.contiguous(), uk.contiguous(),
                              (x @ w_v).view(1, T, Hkv, D), causal=True)
    gul = uo.view(T, H * D) @ uparams["w_o"].reshape(H * D, 4096)
    errs = {}
    for name, got in outs.items():
        if name.startswith("SpFlash"):
            errs[name] = close(name, got[:, None], gdec[:, None],
                               golden=True)
        elif name == "UlyssesAttn":
            errs[name] = close(name, got[None, :, None], gul[None, :, None],
                               golden=True)
        elif "varlen" in name or "cu_seqlens" in name:
            g = got[0] if got.dim() == 4 else got
            errs[name] = close(name, g, gvar, live, golden=True)
        else:
            errs[name] = close(name, got, gdense, golden=True)
    errs["flash_attention_varlen vs plain"] = close(
        "flash_attention_varlen", outs["flash_attention_varlen"][None],
        want_var, live)
    print(f"sp family main path (n {n}: a causal prefill of {T} rows, the "
          f"packed batch, a decode step over {B} x {n * S_rank} positions; "
          f"{main_s:.2f} s with the host): launches {launches}; "
          f"(max_abs_err, of the row RMS) against the one-device goldens "
          f"{fmt(errs)}")

    # 3. times at the cell against the bound, the plain version, the library
    pairs_var = _sp_pairs(lens)
    pairs_ag = T * (T + 1) // 2
    nb_var = nbytes(qp, kp, vp, qp) + T * 8   # the sideband's two lanes
    bms_var, by_var = bound(nb_var, 4 * H * D * pairs_var)
    ms_var = time_ms([lambda: attn._fa_varlen_call(
        qp, kp, vp, meta[None], offs, causal=True, scale=scale,
        need_lse=False)])
    plain_var = time_ms([lambda: attn._flash_attention_varlen_plain(
        qp, kp, vp, meta[None], offs, causal=True, scale=scale)], reps=2,
        rounds=2)
    api_var = time_ms([lambda: attn.flash_attention_varlen(
        qp[0], kp[0], vp[0], cu)])
    # the yardstick: SDPA with the block-diagonal causal mask over the live
    # rows
    seq = torch.repeat_interleave(torch.arange(len(lens), device=dev),
                                  torch.tensor(lens, device=dev))
    pos = torch.arange(live, device=dev)
    mask = (seq[:, None] == seq[None, :]) & (pos[None, :] <= pos[:, None])
    qt, kt, vt = (t[:, :live].transpose(1, 2) for t in (qp, kp, vp))
    lib_var = time_ms([lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)], reps=3, rounds=3)
    del mask
    qs, ks, vs = (t.view(n, 1, s_loc, *t.shape[2:]) for t in (q, k, v))
    ms_ag = time_ms([lambda: tag.sp_ag_attention_shard(
        qs, ks, vs, num_ranks=n, causal=True, config=cfg)])
    ms_ag_var = time_ms([lambda: tag.sp_ag_attention_shard(
        qs, ks, vs, num_ranks=n, causal=True, config=cfg, qmeta=metas)])
    plain_ag = time_ms([lambda: tag._sp_ag_attention_plain(
        qs[:, 0], ks[:, 0], vs[:, 0], None, causal=True, scale=scale)],
        reps=2, rounds=2)
    lib_ag = time_ms([lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True)])
    bms_ag, by_ag = bound(nbytes(q, k, v, q), 4 * H * D * pairs_ag)
    # the pushes: rank r's K and V shards land on the n - 1 - r later ranks
    push = n * (n - 1) // 2 * 2 * s_loc * Hkv * D * 2
    shmem.check_faults()
    print(f"flash_attention_varlen at the cell ({live} live rows, "
          f"{pairs_var} visible pairs a head): kernel {ms_var:.4f} ms "
          f"(through flash_attention_varlen, the sideband built each call, "
          f"{api_var:.4f} ms), plain {plain_var:.4f} ms, sdpa with the "
          f"block-diagonal causal mask {lib_var:.4f} ms, bound {bms_var:.4f} ms ({by_var}: "
          f"{nb_var / 2**20:.2f} MiB, "
          f"{4 * H * D * pairs_var / 1e9:.2f} GFLOP)")
    print(f"sp_ag_attention at the cell (n {n}, causal, {T} rows): kernel "
          f"{ms_ag:.4f} ms (varlen {ms_ag_var:.4f} ms), plain {plain_ag:.4f} "
          f"ms, sdpa over the gathered sequence {lib_ag:.4f} ms, bound "
          f"{bms_ag:.4f} ms ({by_ag}: {4 * H * D * pairs_ag / 1e9:.1f} GFLOP, "
          f"{nbytes(q, k, v, q) / 2**20:.0f} MiB); the pushes' "
          f"{push / 2**20:.0f} MiB of landing stores and reads on top "
          f"{2 * push / PEAK_BYTES * 1e3:.4f} ms; resident CTAs "
          f"{tag.resident_ctas(D)}; phase {time.perf_counter() - t0:.1f} s")
    entries = [
        {"name": "flash_attention_varlen", "route": "cuda",
         "source": "triton_distributed_tpu_torch/csrc/flash_attention.cu",
         "replaces": "triton_distributed_tpu/ops/attention.py:284",
         "launches": launches["flash_attention_varlen"],
         "max_abs_err": err["flash_attention_varlen"], "ms": ms_var,
         "plain_ms": plain_var, "bound_ms": bms_var, "bound_by": by_var,
         "library_ms": lib_var},
        {"name": "sp_ag_attention", "route": "cuda",
         "source": "triton_distributed_tpu_torch/csrc/sp_ag_attention.cu",
         "replaces": "triton_distributed_tpu/ops/sp_ag_attention.py:63",
         "launches": launches["sp_ag_attention"],
         "max_abs_err": err["sp_ag_attention"], "ms": ms_ag,
         "plain_ms": plain_ag, "bound_ms": bms_ag, "bound_by": by_ag,
         "library_ms": lib_ag}]
    return entries, launches


def check_sp_fault(dev, gen):
    """Two planted faults in the fused kernel. First a chunk read before it
    landed, at the cell: the plain version with source 1's chunk 1 of K and
    V taken from another draw for the ranks that read it from their landing
    slots (2 and 3 under the causal mask), the output a consumer that did
    not wait would give; the row check of check_sp_family must pass the
    kernel's output against the plain version and refuse it against this
    one. Then a lost signal: one notification of source 1's chunk 1 taken
    out of rank 2's pad. The wait must time out within the budget, the
    check must raise naming rank 2, the chunk's kv rows and source rank 1,
    and the next call must run clean."""
    from triton_distributed_tpu_torch import shmem
    from triton_distributed_tpu_torch.ops import sp_ag_attention as tag
    H, Hkv, D = SP_SHAPE
    n, s = SP_RANKS, SP_SEQ // SP_RANKS
    q, k, v, k2, v2 = (torch.randn((n, s, h, D), generator=gen,
                                   device=dev).bfloat16()
                       for h in (H, Hkv, Hkv, Hkv, Hkv))
    cfg = tag.SpAgAttnConfig(force_kernel=True)
    got = tag.sp_ag_attention_shard(q[:, None], k[:, None], v[:, None],
                                    num_ranks=n, config=cfg)[:, 0]
    torch.cuda.synchronize()
    shmem.check_faults()
    want = tag._sp_ag_attention_plain(q, k, v, None, causal=True,
                                      scale=D ** -0.5)
    c = tag.chunk_rows(s)
    kf, vf = k.clone(), v.clone()
    kf[1, c:2 * c], vf[1, c:2 * c] = k2[1, c:2 * c], v2[1, c:2 * c]
    bad = tag._sp_ag_attention_plain(q, kf, vf, None, causal=True,
                                     scale=D ** -0.5)
    bad[:2] = want[:2]
    ok, off = sp_errs(got, want), sp_errs(got, bad)
    print(f"sp_ag_attention planted stale chunk (source 1's kv rows "
          f"{c}..{2 * c - 1} of another draw on ranks 2 and 3, n {n}, {s} "
          f"rows a rank): (max_abs_err, of the row RMS) against the plain "
          f"version {ok[0]:.3e}, {ok[1]:.4f}; against the faulted one "
          f"{off[0]:.3e}, {off[1]:.4f} (SP_ROW_TOL {SP_ROW_TOL}, OUT_TOL "
          f"{OUT_TOL})")
    assert ok[0] <= OUT_TOL and ok[1] <= SP_ROW_TOL, ok
    assert off[1] > SP_ROW_TOL, off
    del q, k, v, k2, v2, kf, vf, got, want, bad

    n, s = SP_RANKS, 512
    q, k, v = (torch.randn((n, 1, s, h, D), generator=gen,
                           device=dev).bfloat16() for h in (H, Hkv, Hkv))
    tag.sp_ag_attention_shard(q, k, v, num_ranks=n, config=cfg)
    torch.cuda.synchronize()
    ws = tag.workspace(q.device, n, s, Hkv, D, torch.bfloat16, True)
    nchunk = -(-s // tag.chunk_rows(s))
    ws.pads[2, 1 + nchunk + 1] -= 1
    t0 = time.perf_counter()
    tag.sp_ag_attention_shard(q, k, v, num_ranks=n, config=cfg)
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    assert int(ws.fault[0]) == shmem.FAULT_TIMEOUT
    assert took < shmem.WAIT_BUDGET_S + 2.0, took
    try:
        shmem.check_faults()
        raise AssertionError("sp_ag_attention: the planted fault did not "
                             "raise")
    except RuntimeError as e:
        msg = str(e)
    assert msg.startswith("sp_ag_attention[causal]: rank 2 timed out") \
        and "(chunk 1) from source rank 1" in msg, msg
    got = tag.sp_ag_attention_shard(q, k, v, num_ranks=n, config=cfg)
    torch.cuda.synchronize()
    shmem.check_faults()
    want = tag._sp_ag_attention_plain(q[:, 0], k[:, 0], v[:, 0], None,
                                      causal=True, scale=D ** -0.5)
    e = (got[:, 0].float() - want.float()).abs().max().item()
    assert e <= OUT_TOL, e
    print(f"sp_ag_attention planted lost signal: raised after {took:.3f} s "
          f"(budget {shmem.WAIT_BUDGET_S} s): {msg}; the next call ran clean")


class Phases:
    """Wall seconds of each phase of the run (a call of `ph(name, fn,
    ...)` runs fn and adds its time to `name`), printed on one line before
    the kernels line."""

    def __init__(self):
        self.s = {}

    def __call__(self, name, fn, *args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            self.s[name] = self.s.get(name, 0.0) + time.perf_counter() - t0

    def line(self):
        return "phase seconds: " + json.dumps(
            {k: round(v, 1) for k, v in self.s.items()})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace decode steps with torch.profiler")
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(1)

    from triton_distributed_tpu_torch import models, shmem
    from triton_distributed_tpu_torch.ops import _build
    from triton_distributed_tpu_torch.ops import ag_gemm, ep_a2a, gemm_ar
    from triton_distributed_tpu_torch.ops import gemm_rs
    from triton_distributed_tpu_torch.ops import attention as attn
    from triton_distributed_tpu_torch.ops import grouped_gemm as gg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(smi)
    ph = Phases()

    t0 = time.perf_counter()
    build_s = ph("build", _build.build_all)
    print(f"build: {build_s:.1f} s for {len(_build.sources())} sources "
          f"(phase {time.perf_counter() - t0:.1f} s)")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    kernels = [ph("attention kernels", check_flash_attention, attn, dev, gen),
               ph("attention kernels", check_flash_decode, attn, dev, gen)]
    kernels += ph("attention kernels", check_flash_decode_paged, attn, dev,
                  gen)
    ph("attention kernels", check_attention_group8, attn, dev, gen, kernels)
    torch.cuda.empty_cache()
    gmm_entry = ph("gmm", check_gmm, dev, gen)
    torch.cuda.empty_cache()
    tp_entries = ph("tp kernels", check_tp_kernels, dev, gen)
    ph("tp kernels", check_tp_fault, dev, gen)
    torch.cuda.empty_cache()
    wire_entries = ph("tp-wire", check_tp_wire, dev, gen, smi)
    ep_entry = ph("ep_a2a", check_ep_a2a_kernel, dev, gen)
    ph("ep_a2a", check_ep_fault, dev, gen)
    ll_entries = ph("ll_combine", check_ll_combine_kernel, dev, gen)
    ph("ll_combine", check_ll_fault, dev, gen)
    coll_entries, coll_a2a = ph("collectives", check_collectives, dev, gen)
    ph("collectives", check_collectives_fault, dev, gen)
    coll_wire = ph("collectives", check_collectives_wire, dev, gen)
    ph("collectives", check_collectives_wire_fault, dev, gen)
    shmem.release_workspaces()
    torch.cuda.empty_cache()
    sp_entries, sp_launches = ph("sp family", check_sp_family, dev, gen)
    ph("sp family", check_sp_fault, dev, gen)
    shmem.release_workspaces()
    torch.cuda.empty_cache()
    for check in (check_small_model, check_small_model_paged):
        ph("small models", check, models, args.seed)
    ph("small models", check_small_moe, models, gg, args.seed)
    for check in (check_small_tp_model, check_small_ep_model,
                  check_small_sp_tp_serve):
        ph("small models", check, models, args.seed)

    cfg = models.get_config("Qwen/Qwen3-8B")
    model = models.DenseLLM(cfg, dtype="bfloat16", device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(
        args.seed))
    torch.cuda.synchronize()
    print(f"Qwen3-8B: {cfg.num_layers} layers, hidden {cfg.hidden_size}, "
          f"heads {cfg.num_heads}/{cfg.num_kv_heads}, vocab "
          f"{cfg.vocab_size}; weights "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    B, S, GEN, L = 4, 500, 32, cfg.num_layers
    ids = np.random.RandomState(args.seed).randint(0, cfg.vocab_size, (B, S))
    engine_kernels = {"flash_attention": attn.FLASH_ATTENTION,
                      "flash_decode": attn.FLASH_DECODE, "gmm": gg.GMM}
    engine, toks, launches = ph("engine", run_engine, models, engine_kernels,
                                model, params, cfg, ids, GEN, smi,
                                args.profile, "Qwen3-8B")
    assert launches == {"flash_attention": L, "flash_decode": L * (GEN - 1),
                        "gmm": 0}, launches
    tp_launches = ph("tp-engine", check_tp_engine, models, attn, model,
                     params, cfg, ids, toks, smi, args.profile)

    serve_launches, engine_out = ph("serve", check_serve, models, attn, gg,
                                    model, params, cfg, args.seed, smi,
                                    args.profile)
    tp_serve, mk_tp = ph("tp-serve + mk-tp-serve", check_tp_serve, models,
                         attn, model, params, cfg, args.seed, smi)
    sp_serve = ph("sp-serve", check_sp_serve, models, attn, model, params,
                  cfg, args.seed, smi)

    ph("megakernel graphs", check_megakernel_graphs, dev)
    fused_graph_err = ph("megakernel graphs", check_megakernel_fused_graphs,
                         dev)
    ph("megakernel graphs", check_megakernel_paged_graphs, dev)
    moe_graph_step = ph("megakernel graphs", check_megakernel_moe_graphs, dev)
    verify_err = ph("megakernel graphs", check_megakernel_verify_graphs, dev)
    ar_entry = ph("megakernel AR", check_megakernel_ar, dev)
    ph("megakernel AR", check_megakernel_ar_fault, dev)
    ph("megakernel graphs", check_megakernel_tp_graphs, dev)
    ph("small models", check_megadecoder_small, models, args.seed)
    ph("small models", check_mega_serve_small, models, args.seed)
    ph("small models", check_mega_serve_small, models, args.seed, moe=True)
    ph("small models", check_spec_small, models, args.seed)
    md, md_toks, mk_launches = ph("megadecoder", check_megadecoder, attn,
                                  model, params, cfg, ids[0], toks[0], smi,
                                  args.profile)
    mk = ph("megadecoder", check_megakernel_main, md, cfg, ids[0], smi,
            args.profile)
    mk_fused = ph("megadecoder", check_megadecoder_fused, attn, md, md_toks,
                  model, params, cfg, ids[0], smi)
    mk_fused["max_abs_err"] = max(mk_fused["max_abs_err"], fused_graph_err)
    gc.collect()
    torch.cuda.empty_cache()
    mk_serve, mk_step = ph("mk-serve", check_mega_serve, models, attn, gg,
                           model, params, cfg, args.seed, smi, args.profile,
                           engine_out)
    assert all(c == 0 for n, c in mk_serve.items()
               if n.startswith("flash_decode_paged")), mk_serve
    mk["launches"] = mk_launches + mk_serve["megakernel"]
    spec_serve, verify_launches, verify = ph(
        "spec", check_spec_serve, models, attn, gg, model, params, cfg,
        args.seed, smi)

    # the slice-4 main path needs the card to itself: release every
    # Qwen3-8B weight, cache, pool and program first
    del md, engine, model, params
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    print(f"released Qwen3-8B: {held / 2**20:.1f} MiB still allocated")
    assert held < 2**30, held
    moe, moe_params, moe_launches, moe_ids, moe_toks = ph(
        "moe engine", check_moe_engine, models, engine_kernels, args.seed,
        smi, args.profile)
    moe_serve, moe_engine_out = ph("moe serve", check_moe_serve, models, attn,
                                   gg, moe, moe_params, moe.config,
                                   args.seed, smi)
    mk_moe, mk_moe_step, mk_moe_out = ph(
        "mk-moe-serve", check_mega_serve_moe, models, attn, gg, moe,
        moe_params, moe.config, args.seed, smi, args.profile, moe_engine_out)
    assert mk_moe["gmm"] > 0 and all(
        c == 0 for n, c in mk_moe.items()
        if n.startswith("flash_decode_paged")), mk_moe
    spec_moe, moe_verify_launches = ph(
        "spec-moe", check_spec_serve_moe, models, attn, gg, moe, moe_params,
        moe.config, args.seed, smi, mk_moe_out)
    ep_kernels = {**engine_kernels, "ep_a2a": ep_a2a.EP_A2A,
                  "ag_gemm": ag_gemm.AG_GEMM, "gemm_rs": gemm_rs.GEMM_RS,
                  "gemm_ar": gemm_ar.GEMM_AR}
    ep_launches = ph("ep-engine", check_ep_engine, models, ep_kernels, moe,
                     moe_params, moe.config, moe_ids, moe_toks, smi,
                     args.profile)
    ep_serve = ph("ep-serve", check_ep_serve, models, attn, moe, moe_params,
                  moe.config, args.seed, smi)

    counts = (launches, tp_launches, serve_launches, mk_serve, moe_launches,
              moe_serve, mk_moe, spec_serve, spec_moe, ep_launches, tp_serve,
              sp_serve, ep_serve, sp_launches)
    for k in kernels:
        k["launches"] = sum(c.get(k["name"], 0) for c in counts)
        assert k["launches"] > 0, k["name"]
    gmm_entry["launches"] = (moe_launches["gmm"] + moe_serve["gmm"]
                             + mk_moe["gmm"] + spec_moe["gmm"]
                             + ep_launches["gmm"] + ep_serve["gmm"])
    mk["launches"] += mk_moe["megakernel"] + verify_launches \
        + moe_verify_launches + mk_tp["decode_launches"]
    mk_verify = {
        "name": "megakernel[verify]", "route": "cuda",
        "source": "triton_distributed_tpu_torch/csrc/megakernel.cu",
        "replaces": "triton_distributed_tpu/megakernel/executor_pallas.py:1192",
        "launches": verify_launches + moe_verify_launches
        + mk_tp["verify_launches"],
        "max_abs_err": max(verify_err, verify["abs_err"]),
        "ms": verify["ms"], "plain_ms": verify["plain_ms"],
        "bound_ms": verify["bound_ms"], "bound_by": verify["bound_by"],
        "library_ms": None}
    print(f"megakernel launches: {mk_launches} (MegaDecoder) + "
          f"{mk_serve['megakernel']} (ServeEngine mode='megakernel') + "
          f"{mk_moe['megakernel']} (the same, Qwen3MoE) + {verify_launches} "
          f"+ {moe_verify_launches} (speculative verify, Qwen3-8B and "
          f"Qwen3MoE); the Qwen3-8B verify step {verify['ms']:.4f} ms "
          f"against {verify['bound_ms']:.4f} ms ({verify['bound_by']}); "
          f"the batched serve "
          f"step {mk_step['ms']:.4f} ms against {mk_step['bound_ms']:.4f} "
          f"ms ({mk_step['bound_by']}), plain walk "
          f"{mk_step['plain_ms']:.1f} ms; the MoE batched step "
          f"{mk_moe_step['ms']:.4f} ms against {mk_moe_step['bound_ms']:.4f} "
          f"ms ({mk_moe_step['bound_by']}); the 2-layer MoE step "
          f"{moe_graph_step['ms']:.4f} ms against "
          f"{moe_graph_step['bound_ms']:.4f} ms, plain walk "
          f"{moe_graph_step['plain_ms']:.1f} ms")
    for e in tp_entries:
        e["launches"] = (tp_launches[e["name"]] + ep_launches[e["name"]]
                         + tp_serve.get(e["name"], 0))
        assert e["launches"] > 0, e["name"]
    assert tp_serve["gemm_ar"] > 0
    ep_entry["launches"] = ep_launches["ep_a2a"] + coll_a2a
    assert ep_entry["launches"] > coll_a2a > 0
    print(f"collectives launches (their main path): "
          f"{ {e['name']: e['launches'] for e in coll_entries} }, ep_a2a "
          f"{coll_a2a} (the dense all_to_all); the quant arms "
          f"{ {e['name']: e['launches'] for e in coll_wire} } (their main "
          f"path); no model path reaches them")
    # ll_combine runs on the sp-serve cell's path; ll_merge on no path
    # (counted over both multi-rank serve cells, held to 0 by run_serve)
    ll_entries[0]["launches"] = sp_serve["ll_combine"] \
        + sp_launches["ll_combine"]
    ll_entries[1]["launches"] = sp_serve["ll_merge"] + tp_serve["ll_merge"]
    assert ll_entries[0]["launches"] > 0
    print(f"ll_combine launches: {sp_serve['ll_combine']} (sp-serve, "
          f"{cfg.num_layers} a decode tick under sp_combine='ll'); gemm_ar "
          f"on the tp-serve path: {tp_serve['gemm_ar']}")
    ar_entry["launches"] = mk_tp["decode_launches"] + mk_tp["verify_launches"]
    assert ar_entry["launches"] > 0
    print(f"mk-tp-serve: the batched step at {SERVE_RANKS} ranks "
          f"{mk_tp['step_ms']:.4f} ms against {mk_tp['bound_ms']:.4f} ms "
          f"({mk_tp['bound_by']}), {mk_tp['step_ms'] / mk_step['ms']:.3f}x "
          f"the one-rank mk-serve step ({mk_step['ms']:.4f} ms, this run); "
          f"{mk_tp['tokens_per_s']} tokens/s, {mk_tp['ops']} aten ops a "
          f"tick; {AR_CHAIN} AR nodes alone {ar_entry['chain_ms']:.4f} ms; "
          f"AR launches {ar_entry['launches']} ({mk_tp['decode_launches']} "
          f"decode + {mk_tp['verify_launches']} verify)")
    print(f"sp family launches (its main path): {sp_launches}")
    print(f"ep-serve launches over its runs: "
          f"{ {n: c for n, c in ep_serve.items() if c} }")
    kernels += [mk, mk_verify, mk_fused, gmm_entry, ar_entry] + tp_entries \
        + wire_entries + [ep_entry] + list(ll_entries) + coll_entries \
        + coll_wire + sp_entries
    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    print(ph.line())
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the "
          f"kernels' build included | {smi}")
    print(json.dumps({"kernels": [{key: k[key] for key in order}
                                  for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
