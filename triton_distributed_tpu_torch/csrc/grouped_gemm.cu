// Block-aligned grouped GEMM for MoE, bf16 in, f32 accumulate, bf16 out.
//
// Replaces: triton_distributed_tpu/ops/grouped_gemm.py::_kernel (:41),
// launched by gmm (:70).
//
// Contract (gmm's): lhs (P, K) holds expert-sorted, block_m-aligned rows;
// rhs (E, K, N) the experts' weights, read as (E*K, N) row-major;
// tile_expert (P / block_m,) int32 names the expert of each row tile.
// out[t*bm : (t+1)*bm] = lhs[t*bm : (t+1)*bm] @ rhs[tile_expert[t]],
// summed in f32 and rounded once to bf16. block_m % 16 == 0, K % 16 == 0,
// N % 8 == 0, all pointers 16-byte aligned (the wrapper checks).
//
// group_sizes (E,) int32: the true rows per expert of the plan that
// built tile_expert (moe_utils.sort_tokens_by_expert). From it each CTA
// computes, on the device, how many rows of its tile are live: the
// tile's rank inside its expert's group is t minus the tiles of the
// experts before it (sum of ceil(gs / bm)), and the live rows are
// gs[e] - rank * bm, clamped to [0, bm]. Rows past that are pad rows
// whose lhs is zero (gather_sorted's zero row), so their output is zero
// and is written as zero without a weight being read. Every trailing pad
// tile (all mapped to expert E-1) and every all-pad 64-row block of a live
// tile is such a block. The host never reads the count.
//
// What bounds it on the H100: at the main path's shapes (Qwen3-30B-A3B,
// E 128, K 2048 / 768, N 1536 / 2048) a decode step routes 32 rows to
// ~28 experts, so the call reads each live expert's 3-6 MB slab once for
// a few rows: bound by bytes, far below the ridge (~295 flops per byte).
// A 2048-row prefill routes 16k rows, ~128 per expert, ~128 flops per
// weight byte: still bytes-bound on paper, within 3x of the tensor cores.
//
// What the design does about it: the TPU kernel walks a sequential
// (n, m, k) grid and carries the f32 sum in VMEM across k; its index map
// re-fetches an expert's panel only when the expert changes. Here one CTA
// owns one (64-row block, 128-column block) output tile and loops over K
// itself, so nothing carries over between CTAs. The grid's x is the row
// block, so consecutive CTAs of one column block work on the same
// expert's weight panel and find it in L2. The tile is tdt_mma.cuh's
// gemm_tile, which the tensor-parallel kernels share: four warps of bf16
// mma.sync m16n8k16 with f32 accumulators (fewer rows and more column
// warps when block_m is 16 or 32), fed by a 3-stage cp.async ring; pad
// rows are zero-filled without a global read and warps with no live row
// skip their products. Not done yet (later work): wgmma/TMA, split-K for
// the few-row decode tiles, persistent tiles, and fusing the row gather
// into the A-tile load.

#include "tdt_mma.cuh"

namespace {

using tdt_mma::BN;
using tdt_mma::NTHREADS;
using tdt_mma::NWARPS;

// Sum of v over the CTA (every thread gets it). `red` holds NWARPS ints.
__device__ __forceinline__ int block_sum(int v, int* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) s += red[w];
  __syncthreads();
  return s;
}

// BM rows per CTA (64, 32 or 16), one tdt_mma::gemm_tile each.
template <int BM>
__global__ void __launch_bounds__(NTHREADS)
gmm_bf16_kernel(const __nv_bfloat16* __restrict__ lhs,
                const __nv_bfloat16* __restrict__ rhs,
                const int* __restrict__ tile_expert,
                const int* __restrict__ group_sizes,
                __nv_bfloat16* __restrict__ out, int K, int N, int E,
                int block_m) {
  __shared__ __align__(16) tdt_mma::SmemBf16<BM> sm;
  __shared__ int red[NWARPS];

  const int m0 = blockIdx.x * BM;           // x varies fastest: row blocks
  const int n0 = blockIdx.y * BN;
  const int t = m0 / block_m;
  const int e = min(max(tile_expert[t], 0), E - 1);

  // live rows of this row block
  int before = 0, mine = 0;
  for (int j = threadIdx.x; j < E; j += NTHREADS) {
    const int gs = group_sizes[j];
    if (j < e) before += (gs + block_m - 1) / block_m;
    if (j == e) mine = gs;
  }
  before = block_sum(before, red);
  mine = block_sum(mine, red);
  const int tile_rows = min(max(mine - (t - before) * block_m, 0), block_m);
  const int live = min(max(tile_rows - (m0 - t * block_m), 0), BM);

  // pad rows [live, BM): zeros, no weight read (the whole block when it
  // is all pad)
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (int i = live * (BN / 8) + threadIdx.x; i < BM * (BN / 8);
       i += NTHREADS) {
    const int r = i / (BN / 8), c = n0 + (i % (BN / 8)) * 8;
    if (c < N)
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(m0 + r) * N + c) = z;
  }
  if (live == 0) return;

  __nv_bfloat16* o = out + static_cast<size_t>(m0) * N;
  tdt_mma::gemm_tile<BM>(
      lhs + static_cast<size_t>(m0) * K, K, live,
      rhs + static_cast<size_t>(e) * K * N, N, K, N, n0, sm,
      [&](int row, int col, float v0, float v1) {
        *reinterpret_cast<__nv_bfloat162*>(o + static_cast<size_t>(row) * N +
                                           col) = __floats2bfloat162_rn(v0, v1);
      });
}

template <int BM>
int launch(const void* lhs, const void* rhs, const void* tile_expert,
           const void* group_sizes, void* out, int P, int K, int N, int E,
           int block_m, cudaStream_t st) {
  const dim3 grid(P / BM, (N + BN - 1) / BN);
  gmm_bf16_kernel<BM><<<grid, NTHREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(lhs),
      static_cast<const __nv_bfloat16*>(rhs),
      static_cast<const int*>(tile_expert),
      static_cast<const int*>(group_sizes), static_cast<__nv_bfloat16*>(out),
      K, N, E, block_m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lhs (P, K), rhs (E, K, N), out (P, N) bf16; tile_expert (P / block_m,)
// int32; group_sizes (E,) int32. Contiguous, 16-byte aligned.
extern "C" int tdt_gmm_bf16(const void* lhs, const void* rhs,
                            const void* tile_expert, const void* group_sizes,
                            void* out, int P, int K, int N, int E, int block_m,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block_m <= 0 || block_m % 16 || P % block_m || K % 16 || N % 8 ||
      E <= 0 || group_sizes == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (block_m % 64 == 0)
    return launch<64>(lhs, rhs, tile_expert, group_sizes, out, P, K, N, E,
                      block_m, st);
  if (block_m % 32 == 0)
    return launch<32>(lhs, rhs, tile_expert, group_sizes, out, P, K, N, E,
                      block_m, st);
  return launch<16>(lhs, rhs, tile_expert, group_sizes, out, P, K, N, E,
                    block_m, st);
}
