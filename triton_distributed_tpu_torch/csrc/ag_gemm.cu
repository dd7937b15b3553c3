// Fused AllGather + GEMM over n tensor-parallel ranks, bf16 or f32.
//
// Replaces: triton_distributed_tpu/ops/ag_gemm.py::_kernel (:65), launched
// by ag_gemm_shard (:144).
//
// Contract (ag_gemm_shard's): rank r holds a row shard A_r (m_per, K) and a
// column shard B_r (K, N); out_r (n * m_per, N) = all_gather(A) @ B_r,
// row block s being A_s @ B_r, summed in f32 and rounded once to the
// dtype. Rank-stacked operands: A_r = a + r * m_per * K, B_r = b + r * K *
// N, out_r = out + r * n * m_per * N. Rank r's landing region holds the n
// source shards, (n, m_per, K); its signal pad has the barrier counter at
// slot 0 and, at 1 + s * m_tiles + c, the landing signal of source s's
// BM-row chunk c.
//
// The protocol, per rank r, as the TPU kernel's: barrier_all at entry
// (every peer has entered, so its landing region is free); push A_r into
// every peer's slot r, chunk by chunk, each chunk followed by a notify on
// the peer's signal; multiply its own shard first with no wait, then the
// others in ring order r + 1, r + 2, ..., each row tile as soon as its
// chunk has landed. One launch runs the bodies of ranks [rank_lo, rank_lo
// + rank_cnt) as one list of work items (tdt_tp.cuh): the arrivals, then
// every push, then the GEMM tiles by ring step (all ranks' own tiles
// first), so every wait follows what it waits for. On one card rank_lo = 0
// and rank_cnt = n; a multi-GPU box would launch one rank a device.
//
// What bounds it on the H100: at the chip cell's shapes (Qwen3-8B, n = 4,
// A shards (512, 4096), B_r (4096, 1536) for qkv and (4096, 6144) for
// gate_up) the products are ~100 / ~400 GFLOP in all, ~100x above the
// ridge: bound by the tensor cores, with the pushes (3 x 4 MB a rank)
// hidden behind the own-shard tiles. What the design does about it: the
// GEMM is grouped_gemm.cu's mma.sync tile (64 x 128, 3-stage cp.async),
// at about a third of the card's peak; wgmma/TMA tiles are later work.

#include "tdt_tp.cuh"

using namespace tdt_tp;

namespace {

struct Params {
  const void* a;
  const void* b;
  void* out;
  TdtPeers peers;
  int rank_lo, rank_cnt, m_per, K, N;
};

template <typename T, int BM>
__global__ void __launch_bounds__(NTHREADS) ag_gemm_kernel(Params p) {
  __shared__ __align__(16) typename Smem<T, BM>::type sm;
  if (tdt_faulted(p.peers)) return;
  const int n = p.peers.n, R = p.rank_cnt;
  const int m_per = p.m_per, K = p.K, N = p.N;
  const int m_tiles = (m_per + BM - 1) / BM;
  const int n_tiles = (N + BN - 1) / BN;
  const long long per_rank = static_cast<long long>(m_tiles) * n_tiles;
  const long long n_arrive = R;
  const long long n_push = static_cast<long long>(R) * m_tiles;
  const long long total = n_arrive + n_push + n * R * per_rank;
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
    if (j < n_push) {  // push chunk c of A_me into every peer's slot me
      const int me = p.rank_lo + static_cast<int>(j / m_tiles);
      const int c = static_cast<int>(j % m_tiles);
      if (!tdt_cta_wait(p.peers, me, TDT_PAD_BARRIER, 0, 1, epoch * n))
        return;
      const int rows = min(BM, m_per - c * BM);
      const T* src = a + (static_cast<size_t>(me) * m_per + c * BM) * K;
      for (int i = 1; i < n; ++i) {
        const int peer = (me + i) % n;
        T* dst = p.peers.region<T>(peer) +
                 (static_cast<size_t>(me) * m_per + c * BM) * K;
        tdt_cta_copy(dst, src, static_cast<size_t>(rows) * K * sizeof(T));
      }
      tdt_cta_release();
      if (threadIdx.x == 0)
        for (int i = 1; i < n; ++i)
          tdt_signal(p.peers, (me + i) % n, 1 + me * m_tiles + c);
      continue;
    }
    j -= n_push;  // a GEMM tile: ring step, rank, (row tile, column tile)
    const int step = static_cast<int>(j / (R * per_rank));
    const long long q = j % (R * per_rank);
    const int me = p.rank_lo + static_cast<int>(q / per_rank);
    const int mi = static_cast<int>((q % per_rank) / n_tiles);
    const int ni = static_cast<int>(q % n_tiles);
    const int s = (me + step) % n;
    const T* src;
    if (step == 0) {
      src = a + (static_cast<size_t>(me) * m_per + mi * BM) * K;
    } else {
      if (!tdt_cta_wait(p.peers, me, 1 + s * m_tiles + mi, 0, 1, epoch))
        return;
      src = p.peers.region<T>(me) +
            (static_cast<size_t>(s) * m_per + mi * BM) * K;
    }
    const int live = min(BM, m_per - mi * BM);
    T* dst = out + (static_cast<size_t>(me) * n * m_per +
                    static_cast<size_t>(s) * m_per + mi * BM) * N;
    gemm_tile<BM>(src, K, live, b + static_cast<size_t>(me) * K * N, N, K, N,
                  ni * BN, sm, [&](int row, int col, float v0, float v1) {
                    store2(dst + static_cast<size_t>(row) * N + col, v0, v1);
                  });
  }
}

template <typename T, int BM>
int run(const Params& p, int grid, cudaStream_t st) {
  const long long m_tiles = (p.m_per + BM - 1) / BM;
  const long long items = p.rank_cnt * (1 + m_tiles) +
                          static_cast<long long>(p.peers.n) * p.rank_cnt *
                              m_tiles * ((p.N + BN - 1) / BN);
  return launch_persistent(ag_gemm_kernel<T, BM>, items, grid, st, p);
}

template <typename T>
int resident(int bm) {
  return bm == 16 ? max_resident(ag_gemm_kernel<T, 16>)
                  : max_resident(ag_gemm_kernel<T, 64>);
}

}  // namespace

// dtype 0 = bf16, 1 = f32; bm = 16 or 64 (rows of a tile and of a pushed
// chunk). land / pads: device arrays of n addresses. fault: 4 int32.
extern "C" int tdt_ag_gemm(int dtype, int bm, const void* a, const void* b,
                           void* out, const void* land, const void* pads,
                           void* fault, unsigned epoch, long long budget_ns,
                           int rank_lo, int rank_cnt, int n, int m_per, int K,
                           int N, int grid, void* stream) {
  if (dtype < 0 || dtype > 1 || (bm != 16 && bm != 64) || n < 1 || n > 8 ||
      rank_lo < 0 || rank_cnt < 1 || rank_lo + rank_cnt > n || m_per < 1 ||
      K < 8 || K % 8 || N < 8 || N % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{a, b, out,
           TdtPeers{static_cast<const unsigned long long*>(land),
                    static_cast<const unsigned long long*>(pads),
                    static_cast<int*>(fault), epoch, budget_ns, n},
           rank_lo, rank_cnt, m_per, K, N};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bm == 16 ? run<__nv_bfloat16, 16>(p, grid, st)
                    : run<__nv_bfloat16, 64>(p, grid, st);
  return bm == 16 ? run<float, 16>(p, grid, st) : run<float, 64>(p, grid, st);
}

// CTAs of one launch that can be resident at once (the largest grid).
extern "C" int tdt_ag_gemm_resident(int dtype, int bm) {
  return dtype == 0 ? resident<__nv_bfloat16>(bm) : resident<float>(bm);
}
