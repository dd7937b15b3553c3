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
// expert's weight panel and find it in L2. Four warps, 16 rows x 128
// columns each (fewer rows and more column warps when block_m is 16 or
// 32), run bf16 mma.sync m16n8k16 with f32 accumulators; A and B tiles
// stream through a 3-stage cp.async ring in shared memory (32-deep K
// steps, rows padded by 8 elements so the ldmatrix loads, plain for A and
// transposed for B, are free of bank conflicts). Pad rows are zero-filled
// by cp.async without a global read and warps with no live row skip their
// products. Not done yet (later work): wgmma/TMA, split-K for the few-row
// decode tiles, persistent tiles, and fusing the row gather into the
// A-tile load.

#include "tdt_common.cuh"

namespace {

constexpr int BN = 128;      // output columns per CTA
constexpr int BK = 32;       // K step
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int STAGES = 3;    // cp.async ring depth
constexpr int LDA = BK + 8;  // padded shared-memory rows, in elements
constexpr int LDB = BN + 8;

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// 16 bytes global -> shared, asynchronously; zero-fills without reading
// when !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(a), "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

// BM rows per CTA (64, 32 or 16): WM = BM / 16 warps down the rows and
// WN = NWARPS / WM across the columns, each warp 16 rows x BN / WN columns.
template <int BM>
__global__ void __launch_bounds__(NTHREADS)
gmm_bf16_kernel(const __nv_bfloat16* __restrict__ lhs,
                const __nv_bfloat16* __restrict__ rhs,
                const int* __restrict__ tile_expert,
                const int* __restrict__ group_sizes,
                __nv_bfloat16* __restrict__ out, int K, int N, int E,
                int block_m) {
  constexpr int WM = BM / 16;
  constexpr int WN = NWARPS / WM;
  constexpr int WNT = BN / WN;     // columns per warp
  constexpr int NT = WNT / 8;      // n8 tiles per warp
  static_assert(NT % 2 == 0, "two n8 tiles per transposed ldmatrix");
  __shared__ __align__(16) __nv_bfloat16 As[STAGES][BM * LDA];
  __shared__ __align__(16) __nv_bfloat16 Bs[STAGES][BK * LDB];
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

  const int tid = threadIdx.x;
  if (live == 0) {
    // an all-pad block: zeros, no weight read
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < BM * (BN / 8); i += NTHREADS) {
      const int r = i / (BN / 8), c = n0 + (i % (BN / 8)) * 8;
      if (c < N)
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(m0 + r) * N + c) = z;
    }
    return;
  }

  const __nv_bfloat16* a_base = lhs + static_cast<size_t>(m0) * K;
  const __nv_bfloat16* b_base = rhs + static_cast<size_t>(e) * K * N;
  const int k_tiles = (K + BK - 1) / BK;

  auto load_tile = [&](int kt, int stage) {
    const int k0 = kt * BK;
    for (int i = tid; i < BM * (BK / 8); i += NTHREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const bool ok = r < live && k0 + c < K;
      cp_async16(&As[stage][r * LDA + c],
                 a_base + (ok ? static_cast<size_t>(r) * K + k0 + c : 0), ok);
    }
    for (int i = tid; i < BK * (BN / 8); i += NTHREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const bool ok = k0 + r < K && n0 + c < N;
      cp_async16(&Bs[stage][r * LDB + c],
                 b_base + (ok ? static_cast<size_t>(k0 + r) * N + n0 + c : 0),
                 ok);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) load_tile(s, s);
    cp_async_commit();
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp % WM, wn = warp / WM;
  const int g = lane >> 2, t4 = lane & 3;          // mma fragment coordinates
  const int lm_row = lane & 7, lm_mat = lane >> 3; // ldmatrix addressing
  const bool warp_live = wm * 16 < live;

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<STAGES - 2>();   // tile kt has landed
    __syncthreads();               // ... for every thread; stage kt-1 is free
    const int pre = kt + STAGES - 1;
    if (pre < k_tiles) load_tile(pre, pre % STAGES);
    cp_async_commit();
    if (!warp_live) continue;
    const __nv_bfloat16* as = As[kt % STAGES];
    const __nv_bfloat16* bs = Bs[kt % STAGES];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, &as[(wm * 16 + (lm_mat & 1) * 8 + lm_row) * LDA + kk * 16 +
                     (lm_mat >> 1) * 8]);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, &bs[(kk * 16 + (lm_mat & 1) * 8 + lm_row) * LDB +
                             wn * WNT + (nt + (lm_mat >> 1)) * 8]);
        mma_16816(acc[nt], a, b);
        mma_16816(acc[nt + 1], a, b + 2);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wm * 16 + g + r * 8;      // inside the block
    __nv_bfloat16* orow = out + static_cast<size_t>(m0 + row) * N;
    const bool row_live = row < live;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = n0 + wn * WNT + nt * 8 + t4 * 2;
      if (col < N)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            row_live ? __floats2bfloat162_rn(acc[nt][r * 2], acc[nt][r * 2 + 1])
                     : __floats2bfloat162_rn(0.f, 0.f);
    }
  }
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
