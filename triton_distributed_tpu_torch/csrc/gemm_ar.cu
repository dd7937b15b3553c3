// Fused GEMM + AllReduce (one-shot) over n tensor-parallel ranks, bf16 or
// f32, full width or over a quantized wire (int8 or fp8 e4m3).
//
// Replaces: triton_distributed_tpu/ops/gemm_ar.py::_kernel (:60) and its
// quantized-wire arm _kernel_quant (:156), launched by gemm_ar_shard
// (:271). The quant arm is described after the full-width one, below.
//
// Contract (gemm_ar_shard's): rank r holds A_r (M, K) with K sharded and
// B_r (K, N); every rank gets out_r (M, N) = sum_s A_s @ B_s, replicated.
// Each partial tile is summed in f32 over K and rounded to the dtype; each
// rank sums the n rounded partials in rank order 0, 1, ..., n - 1 in f32
// and rounds once, so all n replicas hold the same bits. Rank-stacked
// operands: A_r = a + r * M * K, B_r = b + r * K * N, out_r = out + r * M *
// N. Rank r's landing region is (n, M, N): slot s holds source s's
// partial. Its signal pad has the barrier counter at slot 0 and, at 1 +
// (s * m_tiles + mi) * n_tiles + ni, the signal of source s's tile (mi, ni).
//
// The protocol, per rank r, as the TPU kernel's: barrier_all at entry;
// each partial tile, from the epilogue, into slot r of every peer (ring
// order r + 1, r + 2, ...) and of itself, then one notify each; then wait
// for all n partials of each tile and sum them. One launch runs ranks
// [rank_lo, rank_lo + rank_cnt) as one list of work items (tdt_tp.cuh):
// the arrivals, the GEMM tiles, then the reductions.
//
// What bounds it on the H100: the decode shapes (Qwen3-8B, n = 4, A (4,
// 1024) / (4, 3072), B_r (., 4096)) read 8 / 25 MB of weights a rank for
// ~0.1 GFLOP: bound by bytes, far below the ridge; the landing traffic is
// KBs. The prefill shapes of the "gemm_ar" mode (M = 2048) are bound by
// the tensor cores. The design: one CTA per 16 x 128 tile at decode (32
// column tiles a rank for N = 4096, 128 CTAs for 4 ranks), each streaming
// its K x 128 weight strip through the cp.async ring; split-K would put
// more CTAs on the weight stream and is later work.

#include "tdt_tp.cuh"
#include "tdt_wire.cuh"

using namespace tdt_tp;

namespace {

constexpr int MAX_RANKS = 8;

struct Params {
  const void* a;
  const void* b;
  void* out;
  TdtPeers peers;
  int rank_lo, rank_cnt, M, K, N;
};

template <typename T, int BM>
__global__ void __launch_bounds__(NTHREADS) gemm_ar_kernel(Params p) {
  __shared__ __align__(16) typename Smem<T, BM>::type sm;
  if (tdt_faulted(p.peers)) return;
  const int n = p.peers.n, R = p.rank_cnt;
  const int M = p.M, K = p.K, N = p.N;
  const int m_tiles = (M + BM - 1) / BM;
  const int n_tiles = (N + BN - 1) / BN;
  const long long per_rank = static_cast<long long>(m_tiles) * n_tiles;
  const long long n_arrive = R;
  const long long total = n_arrive + 2 * R * per_rank;
  const unsigned epoch = p.peers.epoch;
  const T* a = static_cast<const T*>(p.a);
  const T* b = static_cast<const T*>(p.b);
  T* out = static_cast<T*>(p.out);

  for (long long it = blockIdx.x; it < total; it += gridDim.x) {
    if (it < n_arrive) {  // barrier_all: arrive
      if (threadIdx.x == 0) tdt_barrier_arrive(p.peers);
      continue;
    }
    long long j = it - n_arrive;
    const bool produce = j < R * per_rank;
    if (!produce) j -= R * per_rank;
    const int me = p.rank_lo + static_cast<int>(j / per_rank);
    const int mi = static_cast<int>((j % per_rank) / n_tiles);
    const int ni = static_cast<int>(j % n_tiles);
    const int live = min(BM, M - mi * BM);
    const int sig = 1 + (me * m_tiles + mi) * n_tiles + ni;
    if (produce) {  // one partial tile, broadcast to every rank's slot me
      if (!tdt_cta_wait(p.peers, me, TDT_PAD_BARRIER, 0, 1, epoch * n))
        return;
      T* dst[MAX_RANKS];
      for (int i = 0; i < n; ++i)
        dst[i] = p.peers.region<T>((me + 1 + i) % n) +
                 (static_cast<size_t>(me) * M + mi * BM) * N;
      gemm_tile<BM>(a + (static_cast<size_t>(me) * M + mi * BM) * K, K, live,
                    b + static_cast<size_t>(me) * K * N, N, K, N, ni * BN, sm,
                    [&](int row, int col, float v0, float v1) {
                      const size_t off = static_cast<size_t>(row) * N + col;
                      for (int i = 0; i < n; ++i) store2(dst[i] + off, v0, v1);
                    });
      tdt_cta_release();
      if (threadIdx.x == 0)
        for (int i = 0; i < n; ++i) tdt_signal(p.peers, (me + 1 + i) % n, sig);
      continue;
    }
    // reduce tile (mi, ni): the n partials in rank order
    if (!tdt_cta_wait(p.peers, me, 1 + mi * n_tiles + ni, m_tiles * n_tiles,
                      n, epoch))
      return;
    reduce_tile(out + (static_cast<size_t>(me) * M + mi * BM) * N,
                p.peers.region<T>(me) + static_cast<size_t>(mi) * BM * N,
                static_cast<size_t>(M) * N, n, N, live, BM, ni * BN, N);
  }
}

template <typename T, int BM>
int run(const Params& p, int grid, cudaStream_t st) {
  const long long per_rank = static_cast<long long>((p.M + BM - 1) / BM) *
                             ((p.N + BN - 1) / BN);
  const long long items = p.rank_cnt * (1 + 2 * per_rank);
  return launch_persistent(gemm_ar_kernel<T, BM>, items, grid, st, p);
}

template <typename T>
int resident(int bm) {
  return bm == 16 ? max_resident(gemm_ar_kernel<T, 16>)
                  : max_resident(gemm_ar_kernel<T, 64>);
}

// The quantized-wire arm (_kernel_quant :156). The same contract and
// protocol, but each partial strip is pushed at one byte an element with
// one f32 scale per blk columns (csrc/tdt_wire.cuh): the f32 accumulator
// is quantized as it is (gemm_ar.py:205), once, and the same bytes and
// scales are stored into slot r of every rank's landing region. Every rank
// waits for the n sources of a strip, dequantizes each and sums them in
// rank order in f32, rounding once, so all n replicas hold the same bits.
// The strip, its staging in dynamic shared memory, the block rule and the
// landing layout (q (n, M, N) bytes, then scales (n, M, N / blk) f32 at the
// next 16-byte boundary; signal 1 + (s * m_tiles + mi) * n_strips + si)
// are gemm_rs.cu's quant arm's.
//
// What bounds it: at decode the weight bytes, as the full-width arm; the
// n pushes of a strip carry one byte an element and one f32 per blk,
// against 2 (bf16) or 4 (f32) bytes.

struct QParams {
  const void* a;
  const void* b;
  void* out;
  TdtPeers peers;
  int rank_lo, rank_cnt, M, K, N, blk, sw;
};

template <typename T, int BM, int W>
__global__ void __launch_bounds__(NTHREADS) gemm_ar_quant_kernel(QParams p) {
  __shared__ __align__(16) typename Smem<T, BM>::type sm;
  extern __shared__ __align__(16) float stage[];  // BM x sw, then scales
  if (tdt_faulted(p.peers)) return;
  const int n = p.peers.n, R = p.rank_cnt;
  const int M = p.M, K = p.K, N = p.N, blk = p.blk, sw = p.sw;
  const int nb = N / blk;
  const int m_tiles = (M + BM - 1) / BM;
  const int n_strips = (N + sw - 1) / sw;
  const long long per_rank = static_cast<long long>(m_tiles) * n_strips;
  const long long n_arrive = R;
  const long long total = n_arrive + 2 * R * per_rank;
  const unsigned epoch = p.peers.epoch;
  const size_t soff = tdt_wire::scale_offset(n, M, N);
  const T* a = static_cast<const T*>(p.a);
  const T* b = static_cast<const T*>(p.b);
  T* out = static_cast<T*>(p.out);
  float* const strip = stage;
  float* const scales = stage + BM * sw;

  for (long long it = blockIdx.x; it < total; it += gridDim.x) {
    if (it < n_arrive) {  // barrier_all: arrive
      if (threadIdx.x == 0) tdt_barrier_arrive(p.peers);
      continue;
    }
    long long j = it - n_arrive;
    const bool produce = j < R * per_rank;
    if (!produce) j -= R * per_rank;
    const int me = p.rank_lo + static_cast<int>(j / per_rank);
    const int mi = static_cast<int>((j % per_rank) / n_strips);
    const int si = static_cast<int>(j % n_strips);
    const int live = min(BM, M - mi * BM);
    const int s0 = si * sw, width = min(sw, N - s0);
    if (produce) {  // one quantized strip, broadcast to every rank's slot me
      if (!tdt_cta_wait(p.peers, me, TDT_PAD_BARRIER, 0, 1, epoch * n))
        return;
      const T* src = a + (static_cast<size_t>(me) * M + mi * BM) * K;
      for (int t0 = 0; t0 < width; t0 += BN)
        gemm_tile<BM>(src, K, live, b + static_cast<size_t>(me) * K * N, N,
                      K, N, s0 + t0, sm,
                      [&](int row, int col, float v0, float v1) {
                        float* d = strip + row * sw + (col - s0);
                        d[0] = v0;
                        d[1] = v1;
                      });
      __syncthreads();
      uint8_t* qd[MAX_RANKS];
      float* sd[MAX_RANKS];
      const size_t row0 = static_cast<size_t>(me) * M + mi * BM;
      for (int i = 0; i < n; ++i) {
        uint8_t* region = p.peers.region<uint8_t>((me + 1 + i) % n);
        qd[i] = region + row0 * N + s0;
        sd[i] = reinterpret_cast<float*>(region + soff) + row0 * nb +
                s0 / blk;
      }
      tdt_wire::quant_strip<W>(strip, sw, live, width, blk, qd, sd, n, N, nb,
                               scales);
      tdt_cta_release();
      if (threadIdx.x == 0)
        for (int i = 0; i < n; ++i)
          tdt_signal(p.peers, (me + 1 + i) % n,
                     1 + (me * m_tiles + mi) * n_strips + si);
      continue;
    }
    // reduce strip (mi, si): the n quantized partials in rank order
    if (!tdt_cta_wait(p.peers, me, 1 + mi * n_strips + si,
                      m_tiles * n_strips, n, epoch))
      return;
    const uint8_t* region = p.peers.region<uint8_t>(me);
    const size_t row0 = static_cast<size_t>(mi) * BM;
    tdt_wire::dequant_sum<W>(
        out + (static_cast<size_t>(me) * M + row0) * N + s0, N,
        region + row0 * N + s0, static_cast<size_t>(M) * N, N,
        reinterpret_cast<const float*>(region + soff) + row0 * nb + s0 / blk,
        static_cast<size_t>(M) * nb, nb, n, live, width, blk);
  }
}

template <typename T, int BM, int W>
int run_quant(const QParams& p, int grid, cudaStream_t st) {
  const long long per_rank = static_cast<long long>((p.M + BM - 1) / BM) *
                             ((p.N + p.sw - 1) / p.sw);
  const long long items = p.rank_cnt * (1 + 2 * per_rank);
  return launch_persistent_smem(gemm_ar_quant_kernel<T, BM, W>, items, grid,
                                tdt_wire::strip_smem(BM, p.blk), st, p);
}

template <typename T, int W>
int run_quant_bm(int bm, const QParams& p, int grid, cudaStream_t st) {
  return bm == 16 ? run_quant<T, 16, W>(p, grid, st)
                  : run_quant<T, 64, W>(p, grid, st);
}

}  // namespace

// dtype 0 = bf16, 1 = f32; bm = 16 or 64. land / pads: device arrays of n
// addresses. fault: 4 int32.
extern "C" int tdt_gemm_ar(int dtype, int bm, const void* a, const void* b,
                           void* out, const void* land, const void* pads,
                           void* fault, unsigned epoch, long long budget_ns,
                           int rank_lo, int rank_cnt, int n, int M, int K,
                           int N, int grid, void* stream) {
  if (dtype < 0 || dtype > 1 || (bm != 16 && bm != 64) || n < 1 ||
      n > MAX_RANKS || rank_lo < 0 || rank_cnt < 1 || rank_lo + rank_cnt > n ||
      M < 1 || K < 8 || K % 8 || N < 8 || N % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{a, b, out,
           TdtPeers{static_cast<const unsigned long long*>(land),
                    static_cast<const unsigned long long*>(pads),
                    static_cast<int*>(fault), epoch, budget_ns, n},
           rank_lo, rank_cnt, M, K, N};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bm == 16 ? run<__nv_bfloat16, 16>(p, grid, st)
                    : run<__nv_bfloat16, 64>(p, grid, st);
  return bm == 16 ? run<float, 16>(p, grid, st) : run<float, 64>(p, grid, st);
}

extern "C" int tdt_gemm_ar_resident(int dtype, int bm) {
  return dtype == 0 ? resident<__nv_bfloat16>(bm) : resident<float>(bm);
}

// The quantized-wire arm: wire 0 = int8, 1 = fp8 e4m3; blk the scaling
// block (a multiple of 8 dividing 128, or a multiple of 128 up to 512,
// dividing N). land: the n byte regions (q, then the scales at the next
// 16-byte boundary).
extern "C" int tdt_gemm_ar_quant(int dtype, int bm, int wire, int blk,
                                 const void* a, const void* b, void* out,
                                 const void* land, const void* pads,
                                 void* fault, unsigned epoch,
                                 long long budget_ns, int rank_lo,
                                 int rank_cnt, int n, int M, int K, int N,
                                 int grid, void* stream) {
  if (dtype < 0 || dtype > 1 || (bm != 16 && bm != 64) || wire < 0 ||
      wire > 1 || !tdt_wire::block_ok(blk) || n < 1 || n > MAX_RANKS ||
      rank_lo < 0 || rank_cnt < 1 || rank_lo + rank_cnt > n || M < 1 ||
      K < 8 || K % 8 || N < 8 || N % blk)
    return static_cast<int>(cudaErrorInvalidValue);
  QParams p{a, b, out,
            TdtPeers{static_cast<const unsigned long long*>(land),
                     static_cast<const unsigned long long*>(pads),
                     static_cast<int*>(fault), epoch, budget_ns, n},
            rank_lo, rank_cnt, M, K, N, blk, tdt_wire::strip_width(blk)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return wire == 0
               ? run_quant_bm<__nv_bfloat16, tdt_wire::WIRE_INT8>(bm, p, grid,
                                                                   st)
               : run_quant_bm<__nv_bfloat16, tdt_wire::WIRE_FP8>(bm, p, grid,
                                                                  st);
  return wire == 0
             ? run_quant_bm<float, tdt_wire::WIRE_INT8>(bm, p, grid, st)
             : run_quant_bm<float, tdt_wire::WIRE_FP8>(bm, p, grid, st);
}

extern "C" int tdt_gemm_ar_quant_resident(int dtype, int bm, int blk) {
  const size_t smem = tdt_wire::strip_smem(bm, blk);
  auto pick = [&](auto k16, auto k64) {
    return bm == 16 ? max_resident(k16, smem) : max_resident(k64, smem);
  };
  return dtype == 0
             ? pick(gemm_ar_quant_kernel<__nv_bfloat16, 16, 0>,
                    gemm_ar_quant_kernel<__nv_bfloat16, 64, 0>)
             : pick(gemm_ar_quant_kernel<float, 16, 0>,
                    gemm_ar_quant_kernel<float, 64, 0>);
}
