// ReduceScatter over n ranks, bf16 or f32: the ring and the full mesh.
//
// Replaces: triton_distributed_tpu/ops/collectives/reduce_scatter.py::
// _ring_kernel (:68) and _fullmesh_kernel (:100), launched by
// reduce_scatter_shard (:219); with a quantized wire, _ring_quant_kernel
// (:132) and _fullmesh_quant_kernel (:178) (arms 2 and 3,
// tdt_reduce_scatter_quant).
//
// Contract (reduce_scatter_shard's): rank r holds partials x_r of n chunks
// of c elements (chunk p at x_r + p c); rank p gets out_p (c elements), the
// sum over the ranks of their chunk p. Rank-stacked operands: x_r = x + r n
// c, out_p = out + p c. Each chunk is cut into nblk blocks of `blk`
// elements.
//
// Ring, per rank r, as the TPU kernel's: barrier_all; at hop k = 0 .. n - 2
// it sends acc = chunk (r - 1 - k) mod n of x_r, plus (k > 0) what landed
// at hop k - 1, rounded to the dtype (the TPU kernel's acc has x's dtype,
// so its wire carries the rounded value), into slot k of rank r + 1's
// landing region, and notifies r + 1 at pad slot 1 + k * nblk + b; a hop
// k > 0 of a block first waits for hop k - 1's signal of it. The result is
// chunk r of x_r plus the last landed slot, rounded once. So chunk p is
// summed in ring order p + 1, p + 2, ..., p. Rank r's landing region is
// (n - 1, c).
//
// Full mesh, per rank r: barrier_all; chunk p of x_r pushed into slot r of
// rank p's landing region (n, c), for every p != r, one notification each
// at 1 + r * nblk + b; rank p waits on its n - 1 sources and sums the n
// partials in rank order 0 .. n - 1 in f32 (its own read from x_p), rounding
// once: the port's `sum_in_rank_order`.
//
// One launch runs every rank's body on a persistent cooperative grid
// (tdt_tp.cuh): items in one global order, every waiting item after the
// items that signal it.
//
// Ring with a wire (arm 2), per rank r: barrier_all; at hop k it takes acc
// = chunk (r - 1 - k) mod n of x_r in f32, plus (k > 0) the hop k - 1
// landing dequantized, block-quantizes acc (the f32 running sum, never
// rounded to the dtype) and stores bytes and scales into slot k of rank r
// + 1's landing region; the result is chunk r in f32 plus the last landing
// dequantized, rounded once. Full mesh with a wire (arm 3): chunk p of x_r
// is quantized once and stored into slot r of rank p's region, p = r
// included (its own partial crosses the codec too, as JAX's land_q[me] =
// q_ref does); rank p dequantizes its n slots and adds them in rank order
// in f32, rounding once. The quantize is fused into the push (no host
// quantize). Work items of whole scaling blocks, one signal each
// (tdt_coll_wire.cuh); the same signal layouts as arms 0 and 1.
//
// What bounds it on the H100: bytes. At the full-width shape (n = 4,
// partials of 2048 x 4096 bf16, 16 MiB a rank) the function reads the n
// partials once and writes the n chunks (80 MiB, ~25 us at 3.35 TB/s); the
// protocol lands (n - 1) / n of the partials and reads them back. The
// design: 2-64 KiB blocks, one CTA of 256 threads a block, 16-byte vectors
// summed in f32 registers, one signal a block and hop (or source).

#include "tdt_coll_wire.cuh"

using namespace tdt_coll;

namespace {

struct Params {
  const void* x;  // (n, n, c) partials, T
  void* out;      // (n, c), T
  TdtPeers peers;
  long long c, blk;  // chunk and block elements
};

template <typename T>
__device__ __forceinline__ const T* chunk(const Params& p, int r, int q) {
  return static_cast<const T*>(p.x) +
         (static_cast<long long>(r) * p.peers.n + q) * p.c;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) ring_kernel(Params p) {
  if (tdt_faulted(p.peers)) return;
  const int n = p.peers.n;
  const long long nblk = (p.c + p.blk - 1) / p.blk;
  const long long per_hop = n * nblk;
  const long long total = n + n * per_hop;
  const unsigned epoch = p.peers.epoch;
  for (long long it = blockIdx.x; it < total; it += gridDim.x) {
    if (it < n) {
      if (threadIdx.x == 0) tdt_barrier_arrive(p.peers);
      continue;
    }
    const long long j = it - n;
    const int k = static_cast<int>(j / per_hop);  // n - 1: the result
    const int me = static_cast<int>(j % per_hop / nblk);
    const long long b = j % nblk;
    const Block blk = block_of(b, p.blk, p.c);
    T* const land = p.peers.region<T>(me);
    const bool ok =
        k == 0 ? tdt_cta_wait(p.peers, me, TDT_PAD_BARRIER, 0, 1, epoch * n)
               : tdt_cta_wait(p.peers, me,
                              static_cast<int>(1 + (k - 1) * nblk + b), 0, 1,
                              epoch);
    if (!ok) return;
    if (k == n - 1) {  // chunk me of x_me + the last landed slot
      const T* src[2] = {chunk<T>(p, me, me) + blk.off,
                         land + (n - 2) * p.c + blk.off};
      T* dst[1] = {static_cast<T*>(p.out) + me * p.c + blk.off};
      reduce_store(dst, 1, src, 2, blk.len);
      continue;
    }
    const int right = (me + 1) % n, send = (me - 1 - k + 2 * n) % n;
    T* dst[1] = {p.peers.region<T>(right) + k * p.c + blk.off};
    const T* own = chunk<T>(p, me, send) + blk.off;
    if (k == 0) {
      copy_bytes(reinterpret_cast<unsigned char* const*>(dst), 1,
                 reinterpret_cast<const unsigned char*>(own),
                 blk.len * sizeof(T));
    } else {
      const T* src[2] = {own, land + (k - 1) * p.c + blk.off};
      reduce_store(dst, 1, src, 2, blk.len);
    }
    tdt_cta_release();
    if (threadIdx.x == 0)
      tdt_signal(p.peers, right, static_cast<int>(1 + k * nblk + b));
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) fullmesh_kernel(Params p) {
  if (tdt_faulted(p.peers)) return;
  const int n = p.peers.n;
  const long long nblk = (p.c + p.blk - 1) / p.blk;
  const long long n_push = static_cast<long long>(n) * (n - 1) * nblk;
  const long long total = n + n_push + n * nblk;
  const unsigned epoch = p.peers.epoch;
  for (long long it = blockIdx.x; it < total; it += gridDim.x) {
    if (it < n) {
      if (threadIdx.x == 0) tdt_barrier_arrive(p.peers);
      continue;
    }
    if (it < n + n_push) {  // rank me's chunk q into rank q's slot me
      const long long j = it - n;
      const int me = static_cast<int>(j / ((n - 1) * nblk));
      const int q = (me + 1 + static_cast<int>(j / nblk % (n - 1))) % n;
      const long long b = j % nblk;
      if (!tdt_cta_wait(p.peers, me, TDT_PAD_BARRIER, 0, 1, epoch * n))
        return;
      const Block blk = block_of(b, p.blk, p.c);
      unsigned char* dst[1] = {reinterpret_cast<unsigned char*>(
          p.peers.region<T>(q) + me * p.c + blk.off)};
      copy_bytes(dst, 1,
                 reinterpret_cast<const unsigned char*>(chunk<T>(p, me, q) +
                                                        blk.off),
                 blk.len * sizeof(T));
      tdt_cta_release();
      if (threadIdx.x == 0)
        tdt_signal(p.peers, q, static_cast<int>(1 + me * nblk + b));
      continue;
    }
    const long long j = it - n - n_push;  // rank me sums its block b
    const int me = static_cast<int>(j / nblk);
    const long long b = j % nblk;
    if (!wait_sources(p.peers, me, nblk, b, epoch)) return;
    const Block blk = block_of(b, p.blk, p.c);
    const T* land = p.peers.region<T>(me);
    const T* src[MAX_RANKS];
    for (int s = 0; s < n; ++s)
      src[s] = (s == me ? chunk<T>(p, me, me) : land + s * p.c) + blk.off;
    T* dst[1] = {static_cast<T*>(p.out) + me * p.c + blk.off};
    reduce_store(dst, 1, src, n, blk.len);
  }
}

// Arm 2: the ring with a wire. Items: the n arrivals, then hops k = 0 ..
// n - 2 and the result (k = n - 1), n * nitem each, in that order.
template <typename T, int W>
__global__ void __launch_bounds__(NTHREADS) ring_quant_kernel(QParams p) {
  if (tdt_faulted(p.peers)) return;
  const int n = p.peers.n;
  const long long nitem = p.nitem(), per_hop = n * nitem;
  const long long total = n + n * per_hop;
  const unsigned epoch = p.peers.epoch;
  const bool vec = vec_ok<T>(p);
  const int warp = threadIdx.x >> 5;
  for (long long it = blockIdx.x; it < total; it += gridDim.x) {
    if (it < n) {
      if (threadIdx.x == 0) tdt_barrier_arrive(p.peers);
      continue;
    }
    const long long j = it - n;
    const int k = static_cast<int>(j / per_hop);  // n - 1: the result
    const int me = static_cast<int>(j % per_hop / nitem);
    const long long g = j % nitem;
    const bool ok =
        k == 0 ? tdt_cta_wait(p.peers, me, TDT_PAD_BARRIER, 0, 1, epoch * n)
               : tdt_cta_wait(p.peers, me,
                              static_cast<int>(1 + (k - 1) * nitem + g), 0, 1,
                              epoch);
    if (!ok) return;
    const Items its = item_blocks(p, g);
    const T* x = static_cast<const T*>(p.x);
    if (k == n - 1) {  // chunk me of x_me + the last landing, rounded once
      const T* own = x + (static_cast<long long>(me) * n + me) * p.unit;
      T* out = static_cast<T*>(p.out) + me * p.unit;
      for (long long b = its.first + warp; b < its.last; b += NWARPS) {
        const long long off = b * p.sblk;
        const uint8_t* lq = p.q(me, n - 2) + off;
        const float sc = __ldcg(p.s(me, n - 2) + b);
        if (vec)
          store_block<4>(out + off, Src<T, W, 4>{own + off, lq, sc}, p.sblk);
        else
          store_block<1>(out + off, Src<T, W, 1>{own + off, lq, sc}, p.sblk);
      }
      continue;
    }
    const int right = (me + 1) % n, send = (me - 1 - k + 2 * n) % n;
    const T* own = x + (static_cast<long long>(me) * n + send) * p.unit;
    for (long long b = its.first + warp; b < its.last; b += NWARPS) {
      const long long off = b * p.sblk;
      const uint8_t* lq = k > 0 ? p.q(me, k - 1) + off : nullptr;
      const float sc = k > 0 ? __ldcg(p.s(me, k - 1) + b) : 0.f;
      uint8_t* dq[1] = {p.q(right, k) + off};
      float* ds[1] = {p.s(right, k) + b};
      if (vec)
        quant_block<W, 4, 4>(Src<T, W, 4>{own + off, lq, sc}, p.sblk, dq, ds,
                             1);
      else
        quant_block<W, 1, 4>(Src<T, W, 1>{own + off, lq, sc}, p.sblk, dq, ds,
                             1);
    }
    tdt_cta_release();
    if (threadIdx.x == 0)
      tdt_signal(p.peers, right, static_cast<int>(1 + k * nitem + g));
  }
}

// Arm 3: the full mesh with a wire. Items: the n arrivals, the n * n *
// nitem pushes (rank me's chunk q, its own last), the n * nitem sums.
template <typename T, int W>
__global__ void __launch_bounds__(NTHREADS) fullmesh_quant_kernel(QParams p) {
  if (tdt_faulted(p.peers)) return;
  const int n = p.peers.n;
  const long long nitem = p.nitem();
  const long long n_push = static_cast<long long>(n) * n * nitem;
  const long long total = n + n_push + n * nitem;
  const unsigned epoch = p.peers.epoch;
  const bool vec = vec_ok<T>(p);
  const int warp = threadIdx.x >> 5;
  const T* x = static_cast<const T*>(p.x);
  for (long long it = blockIdx.x; it < total; it += gridDim.x) {
    if (it < n) {
      if (threadIdx.x == 0) tdt_barrier_arrive(p.peers);
      continue;
    }
    if (it < n + n_push) {  // rank me's chunk q into rank q's slot me
      const long long j = it - n;
      const int me = static_cast<int>(j / (n * nitem));
      const int q = (me + 1 + static_cast<int>(j / nitem % n)) % n;
      const long long g = j % nitem;
      if (!tdt_cta_wait(p.peers, me, TDT_PAD_BARRIER, 0, 1, epoch * n))
        return;
      const Items its = item_blocks(p, g);
      const T* src = x + (static_cast<long long>(me) * n + q) * p.unit;
      for (long long b = its.first + warp; b < its.last; b += NWARPS) {
        const long long off = b * p.sblk;
        uint8_t* dq[1] = {p.q(q, me) + off};
        float* ds[1] = {p.s(q, me) + b};
        if (vec)
          quant_block<W, 4, 0>(Src<T, W, 4>{src + off, nullptr, 0.f}, p.sblk,
                               dq, ds, 1);
        else
          quant_block<W, 1, 0>(Src<T, W, 1>{src + off, nullptr, 0.f}, p.sblk,
                               dq, ds, 1);
      }
      tdt_cta_release();
      if (threadIdx.x == 0)
        tdt_signal(p.peers, q, static_cast<int>(1 + me * nitem + g));
      continue;
    }
    const long long j = it - n - n_push;  // rank me sums its item g
    const int me = static_cast<int>(j / nitem);
    const long long g = j % nitem;
    if (!tdt_cta_wait(p.peers, me, static_cast<int>(1 + g),
                      static_cast<int>(nitem), n, epoch))
      return;
    const Items its = item_blocks(p, g);
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
int launch_quant(int arm, const QParams& p, int grid, cudaStream_t st) {
  const int n = p.peers.n;
  const long long nitem = (p.unit / p.sblk + p.gblk - 1) / p.gblk;
  return arm == 2 ? coop_launch(ring_quant_kernel<T, W>, p,
                                n + static_cast<long long>(n) * n * nitem,
                                grid, st)
                  : coop_launch(fullmesh_quant_kernel<T, W>, p,
                                n + static_cast<long long>(n) * (n + 1) * nitem,
                                grid, st);
}

template <typename T, int W>
int resident_quant(int arm) {
  return arm == 2 ? resident(ring_quant_kernel<T, W>)
                  : resident(fullmesh_quant_kernel<T, W>);
}

template <typename T>
int launch(int arm, const Params& p, int grid, cudaStream_t st) {
  const int n = p.peers.n;
  const long long nblk = (p.c + p.blk - 1) / p.blk;
  return arm == 0
             ? coop_launch(ring_kernel<T>, p, n + n * n * nblk, grid, st)
             : coop_launch(fullmesh_kernel<T>, p,
                           n + static_cast<long long>(n) * n * nblk, grid,
                           st);
}

}  // namespace

// arm 0 = ring, 1 = fullmesh; dtype 0 = bf16, 1 = f32. x (n, n, c) and out
// (n, c) rank-stacked; elems = n c, a rank's partials; land / pads: device
// arrays of n addresses (landing regions of (n - 1, c) for the ring, (n,
// c) for the full mesh; u32 pads of 1 + (n - 1) * nblk or 1 + n * nblk
// slots, nblk = ceil(c / blk)); fault: 4 int32; blk a multiple of 8. grid
// 0 sizes the persistent grid by occupancy; a grid that could not be
// co-resident is refused.
extern "C" int tdt_reduce_scatter(int arm, int dtype, const void* x,
                                  void* out, const void* land,
                                  const void* pads, void* fault,
                                  unsigned epoch, long long budget_ns, int n,
                                  long long elems, long long blk, int grid,
                                  void* stream) {
  if (arm < 0 || arm > 1 || dtype < 0 || dtype > 1 || n < 2 ||
      n > MAX_RANKS || elems < n || elems % n || blk < 8 || blk % 8 ||
      grid < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{x, out,
                 TdtPeers{static_cast<const unsigned long long*>(land),
                          static_cast<const unsigned long long*>(pads),
                          static_cast<int*>(fault), epoch, budget_ns, n},
                 elems / n, blk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<__nv_bfloat16>(arm, p, grid, st)
                    : launch<float>(arm, p, grid, st);
}

// arm 2 = ring, 3 = fullmesh, with a wire; dtype as above; wire 0 = int8,
// 1 = fp8 e4m3; sblk: the scaling block (elements, any divisor of the
// chunk's width); x (n, n, c), out (n, c) rank-stacked, elems = n c; land:
// byte regions of `slots` (n - 1 ring, n full mesh) slots of c bytes, then
// from the next 16-byte boundary their (slots, c / sblk) f32 scales; pads
// of 1 + slots * nitem slots, nitem = ceil(c / sblk / gblk); gblk: scaling
// blocks a work item.
extern "C" int tdt_reduce_scatter_quant(int arm, int dtype, int wire,
                                        int sblk, const void* x, void* out,
                                        const void* land, const void* pads,
                                        void* fault, unsigned epoch,
                                        long long budget_ns, int n,
                                        long long elems, long long gblk,
                                        int grid, void* stream) {
  if (arm < 2 || arm > 3 || dtype < 0 || dtype > 1 || wire < 0 || wire > 1 ||
      n < 2 || n > MAX_RANKS || elems < n || elems % n || sblk < 1 ||
      (elems / n) % sblk || gblk < 1 || grid < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const QParams p{x, out,
                  TdtPeers{static_cast<const unsigned long long*>(land),
                           static_cast<const unsigned long long*>(pads),
                           static_cast<int*>(fault), epoch, budget_ns, n},
                  elems / n, gblk, sblk, arm == 2 ? n - 1 : n};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using tdt_wire::WIRE_FP8, tdt_wire::WIRE_INT8;
  using bf16 = __nv_bfloat16;
  if (dtype == 0)
    return wire == 0 ? launch_quant<bf16, WIRE_INT8>(arm, p, grid, st)
                     : launch_quant<bf16, WIRE_FP8>(arm, p, grid, st);
  return wire == 0 ? launch_quant<float, WIRE_INT8>(arm, p, grid, st)
                   : launch_quant<float, WIRE_FP8>(arm, p, grid, st);
}

// Co-resident CTAs of an arm (2 and 3: the least over the two wires).
extern "C" int tdt_reduce_scatter_resident(int arm, int dtype) {
  if (arm >= 2) {
    const int a = dtype == 0 ? resident_quant<__nv_bfloat16, 0>(arm)
                             : resident_quant<float, 0>(arm);
    const int b = dtype == 0 ? resident_quant<__nv_bfloat16, 1>(arm)
                             : resident_quant<float, 1>(arm);
    return a < b ? a : b;
  }
  if (dtype == 0)
    return arm == 0 ? resident(ring_kernel<__nv_bfloat16>)
                    : resident(fullmesh_kernel<__nv_bfloat16>);
  return arm == 0 ? resident(ring_kernel<float>)
                  : resident(fullmesh_kernel<float>);
}
