// The GEMM tile and the persistent launch shared by the tensor-parallel
// kernels (ag_gemm.cu, gemm_rs.cu, gemm_ar.cu, and the quantized-wire arms
// of the last two, which add dynamic shared memory for their f32 strip).
//
// One CTA of 128 threads computes one BM x BN output tile (BN = 128; BM =
// 64, or 16 when the product has at most 16 rows) of A (rows, K) times
// B (K, N), with the f32 sum in registers, and hands each thread's
// results, two adjacent columns at a time, to an epilogue that rounds and
// stores them wherever the kernel needs them (the output, a peer's landing
// slot, or every rank's). bf16 runs tdt_mma.cuh's tensor-core tile, the
// one grouped_gemm.cu runs: mma.sync m16n8k16 fed by a 3-stage cp.async
// ring. f32 runs a plain FMA tile (16-deep K steps, each
// thread BM / 4 rows x 4 columns), kept for the f32 checks against the
// CPU. A and B are loaded through L2 (cp.async.cg / ld.global.cg), so an A
// that another CTA landed earlier in the launch is read after its acquire.
//
// The persistent launch. A kernel's work is a list of items in one global
// order, where every item that waits on a signal comes after all the items
// that produce it. Item i runs on CTA i mod G, each CTA in order, on a
// cooperative launch of G = min(items, co-resident CTAs) blocks (sized by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor), so every CTA is resident.
// Then nothing can deadlock: the first unfinished item in the global order
// has all its producers finished (they come earlier) and its CTA has
// finished everything before it in its own list (earlier too), so that
// resident CTA runs it; by induction every item finishes. A grid that
// could not be co-resident is refused (cudaErrorCooperativeLaunchTooLarge)
// rather than launched.
#pragma once

#include "tdt_mma.cuh"
#include "tdt_shmem.cuh"

namespace tdt_tp {

using tdt_mma::BN;
using tdt_mma::gemm_tile;
using tdt_mma::NTHREADS;
using tdt_mma::NWARPS;
using tdt_mma::SmemBf16;

// The f32 tile, with the bf16 tile's contract (tdt_mma.cuh).
constexpr int BKF = 16;
template <int BM>
struct SmemF32 {
  float a[BKF][BM];      // A transposed: a[k][row]
  float b[BKF][BN];
};

template <typename T, int BM>
struct Smem;
template <int BM>
struct Smem<__nv_bfloat16, BM> {
  using type = SmemBf16<BM>;
};
template <int BM>
struct Smem<float, BM> {
  using type = SmemF32<BM>;
};

template <int BM, typename Epi>
__device__ void gemm_tile(const float* A, int lda, int live, const float* B,
                          int ldb, int K, int N, int n0, SmemF32<BM>& sm,
                          Epi epi) {
  constexpr int RPT = BM / NWARPS;       // rows per thread
  const int tid = threadIdx.x;
  const int tx = tid & 31, ty = tid >> 5;  // columns tx*4.., rows ty*RPT..
  float acc[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BKF) {
    __syncthreads();
    for (int i = tid; i < BM * (BKF / 4); i += NTHREADS) {
      const int r = i / (BKF / 4), c = (i % (BKF / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < live && k0 + c < K)
        v = __ldcg(reinterpret_cast<const float4*>(
            A + static_cast<size_t>(r) * lda + k0 + c));
      sm.a[c][r] = v.x;
      sm.a[c + 1][r] = v.y;
      sm.a[c + 2][r] = v.z;
      sm.a[c + 3][r] = v.w;
    }
    for (int i = tid; i < BKF * (BN / 4); i += NTHREADS) {
      const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < K && n0 + c < N)
        v = __ldcg(reinterpret_cast<const float4*>(
            B + static_cast<size_t>(k0 + r) * ldb + n0 + c));
      *reinterpret_cast<float4*>(&sm.b[r][c]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BKF; ++kk) {
      const float4 bv = *reinterpret_cast<const float4*>(&sm.b[kk][tx * 4]);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float av = sm.a[kk][ty * RPT + i];
        acc[i][0] = fmaf(av, bv.x, acc[i][0]);
        acc[i][1] = fmaf(av, bv.y, acc[i][1]);
        acc[i][2] = fmaf(av, bv.z, acc[i][2]);
        acc[i][3] = fmaf(av, bv.w, acc[i][3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = ty * RPT + i;
    if (row >= live) continue;
    const int col = n0 + tx * 4;
    if (col < N) epi(row, col, acc[i][0], acc[i][1]);
    if (col + 2 < N) epi(row, col + 2, acc[i][2], acc[i][3]);
  }
}

// Two adjacent values rounded to T and stored at p (4- or 8-byte aligned).
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ float from_f32(float v) {
  return v;
}

// out[rows, cols] = sum over s = 0..n-1, in that order, of src_s[rows,
// cols] in f32, rounded once to T; src_s = base + s * src_stride, row
// stride ld for sources and output alike. The reduction of gemm_rs and
// gemm_ar, over a BM x BN tile (live rows, columns < N).
template <typename T>
__device__ void reduce_tile(T* out, const T* base, size_t src_stride, int n,
                            int ld, int live, int BM_, int n0, int N) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  const int per_row = BN / V;
  for (int i = threadIdx.x; i < BM_ * per_row; i += NTHREADS) {
    const int r = i / per_row, c = n0 + (i % per_row) * V;
    if (r >= live || c >= N) continue;
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
    for (int s = 0; s < n; ++s) {
      const uint4 raw = __ldcg(reinterpret_cast<const uint4*>(
          base + s * src_stride + static_cast<size_t>(r) * ld + c));
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] += to_f32(v[j]);
    }
    uint4 packed;
    T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = from_f32<T>(acc[j]);
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(r) * ld + c) = packed;
  }
}

// Cooperative launch of `kernel` on min(items, co-resident) CTAs, or on
// `grid` CTAs when grid > 0 (refused when they could not all be resident),
// each with `smem` bytes of dynamic shared memory.
template <typename Kernel, typename... Args>
int launch_persistent_smem(Kernel kernel, long long items, int grid,
                           size_t smem, cudaStream_t st, Args... args) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && smem > 0)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      NTHREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long resident = static_cast<long long>(per_sm) * sms;
  if (resident == 0) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  long long g = grid > 0 ? grid : (items < resident ? items : resident);
  if (g > resident) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  if (g < 1) g = 1;
  void* argv[] = {static_cast<void*>(&args)...};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                  dim3(static_cast<unsigned>(g)),
                                  dim3(NTHREADS), argv, smem, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename Kernel, typename... Args>
int launch_persistent(Kernel kernel, long long items, int grid,
                      cudaStream_t st, Args... args) {
  return launch_persistent_smem(kernel, items, grid, 0, st, args...);
}

// How many CTAs of `kernel` (with `smem` bytes of dynamic shared memory
// each) can be resident on the current device.
template <typename Kernel>
int max_resident(Kernel kernel, size_t smem = 0) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      (smem > 0 &&
       cudaFuncSetAttribute(kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(smem)) != cudaSuccess) ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    NTHREADS, smem) !=
          cudaSuccess)
    return -1;
  return per_sm * sms;
}

}  // namespace tdt_tp
