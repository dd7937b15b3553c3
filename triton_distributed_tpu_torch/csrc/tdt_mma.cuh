// The bf16 tensor-core GEMM tile shared by the port's GEMM kernels
// (grouped_gemm.cu, and the tensor-parallel kernels through tdt_tp.cuh),
// with its building blocks: mma.sync m16n8k16 with f32 accumulators,
// ldmatrix loads (plain and transposed) and the 16-byte cp.async with its
// group fences.
//
// One CTA of 128 threads computes a BM x 128 output tile (BM = 16, 32 or
// 64): WM = BM / 16 warps down the rows and WN = 4 / WM across the
// columns, each warp 16 rows x 128 / WN columns. A and B tiles stream
// through a 3-stage cp.async ring in shared memory (32-deep K steps, rows
// padded by 8 elements so the ldmatrix loads, plain for A and transposed
// for B, are free of bank conflicts). Rows past `live` are zero-filled by
// cp.async without a global read, and warps with no live row skip their
// products.
#pragma once

#include "tdt_common.cuh"

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

// 16 bytes global -> shared, asynchronously, through L2 only (.cg: never
// a stale L1 line, so data another SM wrote in the same launch is safe to
// load after an acquire); zero-fills without reading when !pred.
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

namespace tdt_mma {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int BN = 128;

constexpr int BK = 32;
constexpr int STAGES = 3;
constexpr int LDA = BK + 8;
constexpr int LDB = BN + 8;

template <int BM>
struct SmemBf16 {
  __nv_bfloat16 a[STAGES][BM * LDA];
  __nv_bfloat16 b[STAGES][BK * LDB];
};

// Rows [0, live) of A (row stride lda) times columns [n0, n0 + BN) of B
// (row stride ldb, N columns in all), K deep; epi(row, col, v0, v1) gets
// every live (row, col), (row, col + 1) pair with col < N. K % 8 == 0,
// N % 8 == 0, 16-byte aligned rows.
template <int BM, typename Epi>
__device__ void gemm_tile(const __nv_bfloat16* A, int lda, int live,
                          const __nv_bfloat16* B, int ldb, int K, int N,
                          int n0, SmemBf16<BM>& sm, Epi epi) {
  constexpr int WM = BM / 16;
  constexpr int WN = NWARPS / WM;
  constexpr int WNT = BN / WN;
  constexpr int NT = WNT / 8;
  static_assert(NT % 2 == 0, "two n8 tiles per transposed ldmatrix");
  const int tid = threadIdx.x;
  const int k_tiles = (K + BK - 1) / BK;
  __syncthreads();  // the previous tile's readers are done with sm

  auto load_tile = [&](int kt, int stage) {
    const int k0 = kt * BK;
    for (int i = tid; i < BM * (BK / 8); i += NTHREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const bool ok = r < live && k0 + c < K;
      cp_async16(&sm.a[stage][r * LDA + c],
                 A + (ok ? static_cast<size_t>(r) * lda + k0 + c : 0), ok);
    }
    for (int i = tid; i < BK * (BN / 8); i += NTHREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const bool ok = k0 + r < K && n0 + c < N;
      cp_async16(&sm.b[stage][r * LDB + c],
                 B + (ok ? static_cast<size_t>(k0 + r) * ldb + n0 + c : 0),
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
  const int g = lane >> 2, t4 = lane & 3;
  const int lm_row = lane & 7, lm_mat = lane >> 3;
  const bool warp_live = wm * 16 < live;

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int pre = kt + STAGES - 1;
    if (pre < k_tiles) load_tile(pre, pre % STAGES);
    cp_async_commit();
    if (!warp_live) continue;
    const __nv_bfloat16* as = sm.a[kt % STAGES];
    const __nv_bfloat16* bs = sm.b[kt % STAGES];
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
    const int row = wm * 16 + g + r * 8;
    if (row >= live) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = n0 + wn * WNT + nt * 8 + t4 * 2;
      if (col < N) epi(row, col, acc[nt][r * 2], acc[nt][r * 2 + 1]);
    }
  }
}

}  // namespace tdt_mma
