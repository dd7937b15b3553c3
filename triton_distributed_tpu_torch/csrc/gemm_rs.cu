// Fused GEMM + ReduceScatter over n tensor-parallel ranks, bf16 or f32,
// full width or over a quantized wire (int8 or fp8 e4m3).
//
// Replaces: triton_distributed_tpu/ops/gemm_rs.py::_kernel (:68) and its
// quantized-wire arm _kernel_quant (:176), launched by gemm_rs_shard
// (:305). The quant arm is described after the full-width one, below.
//
// Contract (gemm_rs_shard's): rank r holds A_r (M, K) with K sharded and
// B_r (K, N); out_r (M / n, N) is row chunk r of sum_s A_s @ B_s. Each
// partial tile is summed in f32 over K and rounded to the dtype (the TPU
// kernel's send tile); the owner sums the n rounded partials of its chunk
// in rank order 0, 1, ..., n - 1 in f32 and rounds once. Rank-stacked
// operands: A_r = a + r * M * K, B_r = b + r * K * N, out_r = out + r *
// m_per * N with m_per = M / n. Rank r's landing region is (n, m_per, N):
// slot s holds source s's partial of chunk r. Its signal pad has the
// barrier counter at slot 0 and, at 1 + (s * m_tiles + mi) * n_tiles + ni,
// the signal of source s's tile (mi, ni).
//
// The protocol, per rank r, as the TPU kernel's: barrier_all at entry;
// compute the partial tile by tile, peers' chunks first (chunk r + 1,
// r + 2, ..., own chunk last), each tile stored from the epilogue straight
// into the owner's slot r and notified; then wait for the n partials of
// each tile of its own chunk and reduce them. One launch runs ranks
// [rank_lo, rank_lo + rank_cnt) as one list of work items (tdt_tp.cuh):
// the arrivals, the GEMM tiles by chunk step (every rank's first peer
// chunk first), then the reductions, so every wait follows what it waits
// for.
//
// What bounds it on the H100: at the chip cell's shapes (Qwen3-8B, n = 4,
// A (2048, 1024) for o and (2048, 3072) for down, B (., 4096)) the
// products are ~69 / ~206 GFLOP, above the ridge: the tensor cores bound
// it, and the landing traffic (n x 16 MB written, read once) is small
// beside them. The design: grouped_gemm.cu's mma.sync tile, the pushes
// from the epilogue (no staging copy), a reduction of 64 x 128 tiles
// through L2.

#include "tdt_tp.cuh"
#include "tdt_wire.cuh"

using namespace tdt_tp;

namespace {

struct Params {
  const void* a;
  const void* b;
  void* out;
  TdtPeers peers;
  int rank_lo, rank_cnt, M, K, N;
};

template <typename T, int BM>
__global__ void __launch_bounds__(NTHREADS) gemm_rs_kernel(Params p) {
  __shared__ __align__(16) typename Smem<T, BM>::type sm;
  if (tdt_faulted(p.peers)) return;
  const int n = p.peers.n, R = p.rank_cnt;
  const int K = p.K, N = p.N, m_per = p.M / n;
  const int m_tiles = (m_per + BM - 1) / BM;
  const int n_tiles = (N + BN - 1) / BN;
  const long long per_chunk = static_cast<long long>(m_tiles) * n_tiles;
  const long long n_arrive = R;
  const long long n_gemm = static_cast<long long>(n) * R * per_chunk;
  const long long total = n_arrive + n_gemm + R * per_chunk;
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
    if (j < n_gemm) {  // one partial tile of chunk c, pushed to its owner
      const int step = 1 + static_cast<int>(j / (R * per_chunk));
      const long long q = j % (R * per_chunk);
      const int me = p.rank_lo + static_cast<int>(q / per_chunk);
      const int mi = static_cast<int>((q % per_chunk) / n_tiles);
      const int ni = static_cast<int>(q % n_tiles);
      const int c = (me + step) % n;  // step n: the own chunk
      if (c != me &&
          !tdt_cta_wait(p.peers, me, TDT_PAD_BARRIER, 0, 1, epoch * n))
        return;
      const int live = min(BM, m_per - mi * BM);
      const T* src = a + static_cast<size_t>(me) * p.M * K +
                     (static_cast<size_t>(c) * m_per + mi * BM) * K;
      T* dst = p.peers.region<T>(c) +
               (static_cast<size_t>(me) * m_per + mi * BM) * N;
      gemm_tile<BM>(src, K, live, b + static_cast<size_t>(me) * K * N, N, K,
                    N, ni * BN, sm, [&](int row, int col, float v0, float v1) {
                      store2(dst + static_cast<size_t>(row) * N + col, v0, v1);
                    });
      tdt_cta_release();
      if (threadIdx.x == 0)
        tdt_signal(p.peers, c, 1 + (me * m_tiles + mi) * n_tiles + ni);
      continue;
    }
    j -= n_gemm;  // reduce tile (mi, ni) of the own chunk, sources in order
    const int me = p.rank_lo + static_cast<int>(j / per_chunk);
    const int mi = static_cast<int>((j % per_chunk) / n_tiles);
    const int ni = static_cast<int>(j % n_tiles);
    if (!tdt_cta_wait(p.peers, me, 1 + mi * n_tiles + ni,
                      m_tiles * n_tiles, n, epoch))
      return;
    const int live = min(BM, m_per - mi * BM);
    reduce_tile(out + (static_cast<size_t>(me) * m_per + mi * BM) * N,
                p.peers.region<T>(me) + static_cast<size_t>(mi) * BM * N,
                static_cast<size_t>(m_per) * N, n, N, live, BM, ni * BN, N);
  }
}

template <typename T, int BM>
int run(const Params& p, int grid, cudaStream_t st) {
  const int n = p.peers.n;
  const long long per_chunk = static_cast<long long>((p.M / n + BM - 1) / BM) *
                              ((p.N + BN - 1) / BN);
  const long long items = p.rank_cnt * (1 + (n + 1) * per_chunk);
  return launch_persistent(gemm_rs_kernel<T, BM>, items, grid, st, p);
}

template <typename T>
int resident(int bm) {
  return bm == 16 ? max_resident(gemm_rs_kernel<T, 16>)
                  : max_resident(gemm_rs_kernel<T, 64>);
}

// The quantized-wire arm (_kernel_quant :176). The same contract and
// protocol, but each partial is pushed at one byte an element with one f32
// scale per blk columns (csrc/tdt_wire.cuh): the f32 accumulator is
// quantized as it is, not first rounded to the dtype (the TPU kernel's
// quant_value_blocks(acc), gemm_rs.py:221). Its work unit is a strip of SW
// = max(128, blk) columns, a whole number of scaling blocks (blk divides
// 128 or is a multiple of it, up to 512: ops/_common.check_wire_block):
// the CTA runs the strip's 128-column GEMM tiles one after another into
// an f32 strip in dynamic shared memory (BM x SW floats), takes each row
// block's absmax over its warp, and stores the bytes and scales straight
// into the owner's landing slot r, then notifies. The owner waits for the
// n sources of a strip, dequantizes each and sums them in rank order in
// f32, rounding once (JAX red_body). Rank r's landing region is bytes:
// q (n, m_per, N), then at the next 16-byte boundary scales (n, m_per, N /
// blk) f32; its pad holds the barrier counter and, at 1 + (s * m_tiles +
// mi) * n_strips + si, source s's strip (mi, si).
//
// What bounds it: the same products as the full-width arm, so the tensor
// cores at prefill and the weight bytes at decode; the wire is a quarter
// (f32) or half (bf16) of the full-width landing bytes, plus one f32 per
// blk. The strip staged in shared memory (64 KB at BM 64, SW 256) lowers
// occupancy to two CTAs an SM at prefill.

struct QParams {
  const void* a;
  const void* b;
  void* out;
  TdtPeers peers;
  int rank_lo, rank_cnt, M, K, N, blk, sw;
};

template <typename T, int BM, int W>
__global__ void __launch_bounds__(NTHREADS) gemm_rs_quant_kernel(QParams p) {
  __shared__ __align__(16) typename Smem<T, BM>::type sm;
  extern __shared__ __align__(16) float stage[];  // BM x sw, then scales
  if (tdt_faulted(p.peers)) return;
  const int n = p.peers.n, R = p.rank_cnt;
  const int K = p.K, N = p.N, m_per = p.M / n, blk = p.blk, sw = p.sw;
  const int nb = N / blk;
  const int m_tiles = (m_per + BM - 1) / BM;
  const int n_strips = (N + sw - 1) / sw;
  const long long per_chunk = static_cast<long long>(m_tiles) * n_strips;
  const long long n_arrive = R;
  const long long n_gemm = static_cast<long long>(n) * R * per_chunk;
  const long long total = n_arrive + n_gemm + R * per_chunk;
  const unsigned epoch = p.peers.epoch;
  const size_t soff = tdt_wire::scale_offset(n, m_per, N);
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
    if (j < n_gemm) {  // one quantized strip of chunk c, pushed to its owner
      const int step = 1 + static_cast<int>(j / (R * per_chunk));
      const long long q = j % (R * per_chunk);
      const int me = p.rank_lo + static_cast<int>(q / per_chunk);
      const int mi = static_cast<int>((q % per_chunk) / n_strips);
      const int si = static_cast<int>(q % n_strips);
      const int c = (me + step) % n;  // step n: the own chunk
      if (c != me &&
          !tdt_cta_wait(p.peers, me, TDT_PAD_BARRIER, 0, 1, epoch * n))
        return;
      const int live = min(BM, m_per - mi * BM);
      const int s0 = si * sw, width = min(sw, N - s0);
      const T* src = a + static_cast<size_t>(me) * p.M * K +
                     (static_cast<size_t>(c) * m_per + mi * BM) * K;
      for (int t0 = 0; t0 < width; t0 += BN)
        gemm_tile<BM>(src, K, live, b + static_cast<size_t>(me) * K * N, N,
                      K, N, s0 + t0, sm,
                      [&](int row, int col, float v0, float v1) {
                        float* d = strip + row * sw + (col - s0);
                        d[0] = v0;
                        d[1] = v1;
                      });
      __syncthreads();
      uint8_t* region = p.peers.region<uint8_t>(c);
      const size_t row0 = static_cast<size_t>(me) * m_per + mi * BM;
      uint8_t* qd = region + row0 * N + s0;
      float* sd = reinterpret_cast<float*>(region + soff) + row0 * nb +
                  s0 / blk;
      tdt_wire::quant_strip<W>(strip, sw, live, width, blk, &qd, &sd, 1, N,
                               nb, scales);
      tdt_cta_release();
      if (threadIdx.x == 0)
        tdt_signal(p.peers, c, 1 + (me * m_tiles + mi) * n_strips + si);
      continue;
    }
    j -= n_gemm;  // reduce strip (mi, si) of the own chunk, sources in order
    const int me = p.rank_lo + static_cast<int>(j / per_chunk);
    const int mi = static_cast<int>((j % per_chunk) / n_strips);
    const int si = static_cast<int>(j % n_strips);
    if (!tdt_cta_wait(p.peers, me, 1 + mi * n_strips + si,
                      m_tiles * n_strips, n, epoch))
      return;
    const int live = min(BM, m_per - mi * BM);
    const int s0 = si * sw, width = min(sw, N - s0);
    const uint8_t* region = p.peers.region<uint8_t>(me);
    const size_t row0 = static_cast<size_t>(mi) * BM;
    tdt_wire::dequant_sum<W>(
        out + (static_cast<size_t>(me) * m_per + row0) * N + s0, N,
        region + row0 * N + s0, static_cast<size_t>(m_per) * N, N,
        reinterpret_cast<const float*>(region + soff) + row0 * nb + s0 / blk,
        static_cast<size_t>(m_per) * nb, nb, n, live, width, blk);
  }
}

template <typename T, int BM, int W>
int run_quant(const QParams& p, int grid, cudaStream_t st) {
  const int n = p.peers.n;
  const long long per_chunk = static_cast<long long>((p.M / n + BM - 1) / BM) *
                              ((p.N + p.sw - 1) / p.sw);
  const long long items = p.rank_cnt * (1 + (n + 1) * per_chunk);
  return launch_persistent_smem(gemm_rs_quant_kernel<T, BM, W>, items, grid,
                                tdt_wire::strip_smem(BM, p.blk), st, p);
}

template <typename T, int W>
int run_quant_bm(int bm, const QParams& p, int grid, cudaStream_t st) {
  return bm == 16 ? run_quant<T, 16, W>(p, grid, st)
                  : run_quant<T, 64, W>(p, grid, st);
}

}  // namespace

// dtype 0 = bf16, 1 = f32; bm = 16 or 64. M % n == 0. land / pads: device
// arrays of n addresses. fault: 4 int32.
extern "C" int tdt_gemm_rs(int dtype, int bm, const void* a, const void* b,
                           void* out, const void* land, const void* pads,
                           void* fault, unsigned epoch, long long budget_ns,
                           int rank_lo, int rank_cnt, int n, int M, int K,
                           int N, int grid, void* stream) {
  if (dtype < 0 || dtype > 1 || (bm != 16 && bm != 64) || n < 1 || n > 8 ||
      rank_lo < 0 || rank_cnt < 1 || rank_lo + rank_cnt > n || M < n ||
      M % n || K < 8 || K % 8 || N < 8 || N % 8)
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

extern "C" int tdt_gemm_rs_resident(int dtype, int bm) {
  return dtype == 0 ? resident<__nv_bfloat16>(bm) : resident<float>(bm);
}

// The quantized-wire arm: wire 0 = int8, 1 = fp8 e4m3; blk the scaling
// block (a multiple of 8 dividing 128, or a multiple of 128 up to 512,
// dividing N). land: the n byte regions (q, then the scales at the next
// 16-byte boundary).
extern "C" int tdt_gemm_rs_quant(int dtype, int bm, int wire, int blk,
                                 const void* a, const void* b, void* out,
                                 const void* land, const void* pads,
                                 void* fault, unsigned epoch,
                                 long long budget_ns, int rank_lo,
                                 int rank_cnt, int n, int M, int K, int N,
                                 int grid, void* stream) {
  if (dtype < 0 || dtype > 1 || (bm != 16 && bm != 64) || wire < 0 ||
      wire > 1 || !tdt_wire::block_ok(blk) || n < 1 || n > 8 ||
      rank_lo < 0 || rank_cnt < 1 || rank_lo + rank_cnt > n || M < n ||
      M % n || K < 8 || K % 8 || N < 8 || N % blk)
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

extern "C" int tdt_gemm_rs_quant_resident(int dtype, int bm, int blk) {
  const size_t smem = tdt_wire::strip_smem(bm, blk);
  auto pick = [&](auto k16, auto k64) {
    return bm == 16 ? max_resident(k16, smem) : max_resident(k64, smem);
  };
  return dtype == 0
             ? pick(gemm_rs_quant_kernel<__nv_bfloat16, 16, 0>,
                    gemm_rs_quant_kernel<__nv_bfloat16, 64, 0>)
             : pick(gemm_rs_quant_kernel<float, 16, 0>,
                    gemm_rs_quant_kernel<float, 64, 0>);
}
