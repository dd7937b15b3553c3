// AllReduce (sum) over n ranks, bf16 or f32: one-shot and two-shot.
//
// Replaces: triton_distributed_tpu/ops/collectives/all_reduce.py::
// _one_shot_kernel (:89) and _two_shot_kernel (:128), launched by
// all_reduce_shard (:233); with a quantized wire, _one_shot_quant_kernel
// (:175) (arm 2, tdt_all_reduce_quant). The quantized two-shot
// (_two_shot_quant_shard :214) is a composition on the host: the ring arm
// of reduce_scatter.cu with a wire, then an all-gather of quantized bytes
// (all_gather.cu).
//
// Contract (all_reduce_shard's): rank r holds x_r (E elements); every rank
// d gets out_d, the sum of the n buffers, replicated. Rank-stacked
// operands: x_r = x + r E, out_d = out + d E. Buffers are cut into nblk
// blocks of `blk` elements (one-shot: of E; two-shot: of each chunk of c =
// E / n).
//
// One-shot, per rank r, as the TPU kernel's: barrier_all; each block of x_r
// pushed into slot r of every peer's landing region (n, E) (ring order r +
// 1, r + 2, ...), one notification each at pad slot 1 + r * nblk + b; rank
// d waits on its n - 1 sources and sums the n buffers in rank order 0 ..
// n - 1 in f32 (its own read from x_d), rounding once: the port's
// `sum_in_rank_order`, so all n replicas hold the same bits. Items: the n
// barrier arrivals, the n * nblk pushes, the n * nblk sums.
//
// Two-shot, per rank r: a ring reduce-scatter (reduce_scatter.cu's ring:
// hop k sends chunk (r - 1 - k) mod n plus what landed at hop k - 1,
// rounded, into slot k of rank r + 1's landing region (n - 1, c), signal 1
// + k * nblk + b), whose result, chunk r of the sum, is stored into slot r
// of out_r and of out_{r+1} at once (the all-gather's hop 0); then a ring
// all-gather over the outputs: hop k = 1 .. n - 2 forwards slot (r - k) mod
// n of out_r to out_{r+1} after hop k - 1's signal of that block. The
// all-gather's signals are distinct from the reduce-scatter's: 1 + (n - 1
// + k) * nblk + b. A final item waits for the last hop. Items in one
// global order: arrivals, the n - 1 RS hops, the RS result with AG hop 0,
// the AG hops 1 .. n - 2, the final waits (n * nblk each).
//
// One-shot with a wire (arm 2), per rank r: barrier_all; each scaling
// block of x_r quantized once (the quantize fused into the push) and its
// bytes and scale stored into slot r of every rank's landing region, its
// own included (JAX's land_q[me] = q_ref: the own buffer crosses the codec
// too), one notification each at 1 + r * nitem + g; rank d waits on its n
// sources and dequantizes and adds the n slots in rank order in f32,
// rounding once, so all n replicas hold the same bits. Work items of whole
// scaling blocks (tdt_coll_wire.cuh).
//
// One launch runs every rank's body on a persistent cooperative grid
// (tdt_tp.cuh).
//
// What bounds it on the H100: bytes at prefill (n = 4, 2048 x 4096 bf16,
// 16 MiB a rank: the function reads the n buffers and writes the n
// replicas, 128 MiB, ~40 us at 3.35 TB/s; one-shot's protocol lands n - 1
// copies of every buffer and reads them back, ~3.4x that again; two-shot's
// ~1.2x); the launch, the barrier and the dependent signals at decode (4 x
// 4096 bf16: 32 KiB a rank). The design: 2-64 KiB blocks, one CTA of 256
// threads a block, 16-byte vectors summed in f32 registers; the one-shot
// push stores each vector to the n - 1 peers at once.

#include "tdt_coll_wire.cuh"

using namespace tdt_coll;

namespace {

struct Params {
  const void* x;  // (n, E), T
  void* out;      // (n, E), T
  TdtPeers peers;
  long long E, blk;
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS) one_shot_kernel(Params p) {
  if (tdt_faulted(p.peers)) return;
  const int n = p.peers.n;
  const long long nblk = (p.E + p.blk - 1) / p.blk;
  const long long n_push = n * nblk, total = n + 2 * n_push;
  const unsigned epoch = p.peers.epoch;
  const T* x = static_cast<const T*>(p.x);
  for (long long it = blockIdx.x; it < total; it += gridDim.x) {
    if (it < n) {
      if (threadIdx.x == 0) tdt_barrier_arrive(p.peers);
      continue;
    }
    const bool push = it < n + n_push;
    const long long j = push ? it - n : it - n - n_push;
    const int me = static_cast<int>(j / nblk);
    const long long b = j % nblk;
    const Block blk = block_of(b, p.blk, p.E);
    if (push) {
      if (!tdt_cta_wait(p.peers, me, TDT_PAD_BARRIER, 0, 1, epoch * n))
        return;
      unsigned char* dst[MAX_RANKS];
      for (int i = 0; i < n - 1; ++i)
        dst[i] = reinterpret_cast<unsigned char*>(
            p.peers.region<T>((me + 1 + i) % n) + me * p.E + blk.off);
      copy_bytes(dst, n - 1,
                 reinterpret_cast<const unsigned char*>(x + me * p.E +
                                                        blk.off),
                 blk.len * sizeof(T));
      tdt_cta_release();
      if (threadIdx.x == 0)
        for (int i = 0; i < n - 1; ++i)
          tdt_signal(p.peers, (me + 1 + i) % n,
                     static_cast<int>(1 + me * nblk + b));
      continue;
    }
    if (!wait_sources(p.peers, me, nblk, b, epoch)) return;
    const T* land = p.peers.region<T>(me);
    const T* src[MAX_RANKS];
    for (int s = 0; s < n; ++s)
      src[s] = (s == me ? x + me * p.E : land + s * p.E) + blk.off;
    T* dst[1] = {static_cast<T*>(p.out) + me * p.E + blk.off};
    reduce_store(dst, 1, src, n, blk.len);
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) two_shot_kernel(Params p) {
  if (tdt_faulted(p.peers)) return;
  const int n = p.peers.n;
  const long long c = p.E / n;
  const long long nblk = (c + p.blk - 1) / p.blk;
  const long long per_hop = n * nblk;
  // stages: RS hops 0 .. n - 2, the RS result (+ AG hop 0), AG hops 1 ..
  // n - 2, the final waits
  const long long total = n + 2 * n * per_hop - per_hop;
  const unsigned epoch = p.peers.epoch;
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  for (long long it = blockIdx.x; it < total; it += gridDim.x) {
    if (it < n) {
      if (threadIdx.x == 0) tdt_barrier_arrive(p.peers);
      continue;
    }
    const long long j = it - n;
    const int stage = static_cast<int>(j / per_hop);
    const int me = static_cast<int>(j % per_hop / nblk);
    const long long b = j % nblk;
    const int right = (me + 1) % n;
    const Block blk = block_of(b, p.blk, c);
    T* const land = p.peers.region<T>(me);
    // the signal this stage waits on (stage 0: the barrier)
    bool ok;
    if (stage == 0)
      ok = tdt_cta_wait(p.peers, me, TDT_PAD_BARRIER, 0, 1, epoch * n);
    else
      ok = tdt_cta_wait(p.peers, me, static_cast<int>(1 + (stage - 1) * nblk + b),
                        0, 1, epoch);
    if (!ok) return;
    if (stage == 2 * n - 2) continue;  // the final wait: all slots landed
    if (stage < n - 1) {               // RS hop k = stage
      const int k = stage, send = (me - 1 - k + 2 * n) % n;
      T* dst[1] = {p.peers.region<T>(right) + k * c + blk.off};
      const T* own = x + me * p.E + send * c + blk.off;
      if (k == 0) {
        copy_bytes(reinterpret_cast<unsigned char* const*>(dst), 1,
                   reinterpret_cast<const unsigned char*>(own),
                   blk.len * sizeof(T));
      } else {
        const T* src[2] = {own, land + (k - 1) * c + blk.off};
        reduce_store(dst, 1, src, 2, blk.len);
      }
    } else if (stage == n - 1) {  // chunk me reduced: into out_me, out_right
      const T* src[2] = {x + me * p.E + me * c + blk.off,
                         land + (n - 2) * c + blk.off};
      T* dst[2] = {out + me * p.E + me * c + blk.off,
                   out + right * p.E + me * c + blk.off};
      reduce_store(dst, 2, src, 2, blk.len);
    } else {  // AG hop k = stage - (n - 1): forward slot (me - k)
      const int s = (me - (stage - (n - 1)) + n) % n;
      unsigned char* dst[1] = {reinterpret_cast<unsigned char*>(
          out + right * p.E + s * c + blk.off)};
      copy_bytes(dst, 1,
                 reinterpret_cast<const unsigned char*>(out + me * p.E +
                                                        s * c + blk.off),
                 blk.len * sizeof(T));
    }
    tdt_cta_release();
    if (threadIdx.x == 0)
      tdt_signal(p.peers, right, static_cast<int>(1 + stage * nblk + b));
  }
}

// Arm 2: one-shot with a wire. Items: the n arrivals, the n * nitem
// pushes, the n * nitem sums.
template <typename T, int W>
__global__ void __launch_bounds__(NTHREADS) one_shot_quant_kernel(QParams p) {
  if (tdt_faulted(p.peers)) return;
  const int n = p.peers.n;
  const long long nitem = p.nitem();
  const long long n_push = n * nitem, total = n + 2 * n_push;
  const unsigned epoch = p.peers.epoch;
  const bool vec = vec_ok<T>(p);
  const int warp = threadIdx.x >> 5;
  for (long long it = blockIdx.x; it < total; it += gridDim.x) {
    if (it < n) {
      if (threadIdx.x == 0) tdt_barrier_arrive(p.peers);
      continue;
    }
    const bool push = it < n + n_push;
    const long long j = push ? it - n : it - n - n_push;
    const int me = static_cast<int>(j / nitem);
    const long long g = j % nitem;
    const Items its = item_blocks(p, g);
    if (push) {
      if (!tdt_cta_wait(p.peers, me, TDT_PAD_BARRIER, 0, 1, epoch * n))
        return;
      const T* x = static_cast<const T*>(p.x) + me * p.unit;
      for (long long b = its.first + warp; b < its.last; b += NWARPS) {
        const long long off = b * p.sblk;
        uint8_t* dq[MAX_RANKS];
        float* ds[MAX_RANKS];
        for (int i = 0; i < n; ++i) {
          const int d = (me + 1 + i) % n;
          dq[i] = p.q(d, me) + off;
          ds[i] = p.s(d, me) + b;
        }
        if (vec)
          quant_block<W, 4, 0>(Src<T, W, 4>{x + off, nullptr, 0.f}, p.sblk, dq,
                               ds, n);
        else
          quant_block<W, 1, 0>(Src<T, W, 1>{x + off, nullptr, 0.f}, p.sblk, dq,
                               ds, n);
      }
      tdt_cta_release();
      if (threadIdx.x == 0)
        for (int i = 0; i < n; ++i)
          tdt_signal(p.peers, (me + 1 + i) % n,
                     static_cast<int>(1 + me * nitem + g));
      continue;
    }
    if (!tdt_cta_wait(p.peers, me, static_cast<int>(1 + g),
                      static_cast<int>(nitem), n, epoch))
      return;
    T* out = static_cast<T*>(p.out) + me * p.unit;
    for (long long b = its.first + warp; b < its.last; b += NWARPS) {
      const long long off = b * p.sblk;
      const uint8_t* q[MAX_RANKS];
      const float* sc[MAX_RANKS];
      for (int s = 0; s < n; ++s) {
        q[s] = p.q(me, s) + off;
        sc[s] = p.s(me, s) + b;
      }
      if (vec)
        dequant_sum_block<W, 4>(out + off, q, sc, n, p.sblk);
      else
        dequant_sum_block<W, 1>(out + off, q, sc, n, p.sblk);
    }
  }
}

template <typename T, int W>
int launch_quant(const QParams& p, int grid, cudaStream_t st) {
  const int n = p.peers.n;
  const long long nitem = (p.unit / p.sblk + p.gblk - 1) / p.gblk;
  return coop_launch(one_shot_quant_kernel<T, W>, p, n + 2 * n * nitem, grid,
                     st);
}

template <typename T>
int launch(int arm, const Params& p, int grid, cudaStream_t st) {
  const int n = p.peers.n;
  if (arm == 0) {
    const long long nblk = (p.E + p.blk - 1) / p.blk;
    return coop_launch(one_shot_kernel<T>, p, n + 2 * n * nblk, grid, st);
  }
  const long long nblk = (p.E / n + p.blk - 1) / p.blk;
  return coop_launch(two_shot_kernel<T>, p,
                     n + (2 * n - 1) * n * nblk, grid, st);
}

}  // namespace

// arm 0 = one-shot, 1 = two-shot; dtype 0 = bf16, 1 = f32. x and out (n,
// E) rank-stacked (two-shot: E % n == 0); land / pads: device arrays of n
// addresses (landing regions of (n, E) for one-shot, (n - 1, E / n) for
// two-shot; u32 pads of 1 + n * nblk or 1 + 2 (n - 1) nblk slots); fault: 4
// int32; blk a multiple of 8. grid 0 sizes the persistent grid by
// occupancy; a grid that could not be co-resident is refused.
extern "C" int tdt_all_reduce(int arm, int dtype, const void* x, void* out,
                              const void* land, const void* pads, void* fault,
                              unsigned epoch, long long budget_ns, int n,
                              long long E, long long blk, int grid,
                              void* stream) {
  if (arm < 0 || arm > 1 || dtype < 0 || dtype > 1 || n < 2 ||
      n > MAX_RANKS || E < 1 || (arm == 1 && E % n) || blk < 8 || blk % 8 ||
      grid < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{x, out,
                 TdtPeers{static_cast<const unsigned long long*>(land),
                          static_cast<const unsigned long long*>(pads),
                          static_cast<int*>(fault), epoch, budget_ns, n},
                 E, blk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<__nv_bfloat16>(arm, p, grid, st)
                    : launch<float>(arm, p, grid, st);
}

// arm 2 = one-shot with a wire; dtype as above; wire 0 = int8, 1 = fp8
// e4m3; sblk: the scaling block (elements, any divisor of the buffer's
// width); x and out (n, E) rank-stacked; land: byte regions of n slots of E
// bytes, then from the next 16-byte boundary their (n, E / sblk) f32
// scales; pads of 1 + n * nitem slots, nitem = ceil(E / sblk / gblk);
// gblk: scaling blocks a work item.
extern "C" int tdt_all_reduce_quant(int arm, int dtype, int wire, int sblk,
                                    const void* x, void* out,
                                    const void* land, const void* pads,
                                    void* fault, unsigned epoch,
                                    long long budget_ns, int n, long long E,
                                    long long gblk, int grid, void* stream) {
  if (arm != 2 || dtype < 0 || dtype > 1 || wire < 0 || wire > 1 || n < 2 ||
      n > MAX_RANKS || E < 1 || sblk < 1 || E % sblk || gblk < 1 || grid < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const QParams p{x, out,
                  TdtPeers{static_cast<const unsigned long long*>(land),
                           static_cast<const unsigned long long*>(pads),
                           static_cast<int*>(fault), epoch, budget_ns, n},
                  E, gblk, sblk, n};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using tdt_wire::WIRE_FP8, tdt_wire::WIRE_INT8;
  using bf16 = __nv_bfloat16;
  if (dtype == 0)
    return wire == 0 ? launch_quant<bf16, WIRE_INT8>(p, grid, st)
                     : launch_quant<bf16, WIRE_FP8>(p, grid, st);
  return wire == 0 ? launch_quant<float, WIRE_INT8>(p, grid, st)
                   : launch_quant<float, WIRE_FP8>(p, grid, st);
}

// Co-resident CTAs of an arm (2: the least over the two wires).
extern "C" int tdt_all_reduce_resident(int arm, int dtype) {
  if (arm == 2) {
    const int a = dtype == 0 ? resident(one_shot_quant_kernel<__nv_bfloat16, 0>)
                             : resident(one_shot_quant_kernel<float, 0>);
    const int b = dtype == 0 ? resident(one_shot_quant_kernel<__nv_bfloat16, 1>)
                             : resident(one_shot_quant_kernel<float, 1>);
    return a < b ? a : b;
  }
  if (dtype == 0)
    return arm == 0 ? resident(one_shot_kernel<__nv_bfloat16>)
                    : resident(two_shot_kernel<__nv_bfloat16>);
  return arm == 0 ? resident(one_shot_kernel<float>)
                  : resident(two_shot_kernel<float>);
}
