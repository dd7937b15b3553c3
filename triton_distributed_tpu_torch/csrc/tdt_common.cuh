// Shared helpers of the port's CUDA kernels (sm_90a, bf16 tensor cores).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Masked scores are -1e30, not -inf: the value `_NEG_INF` of the JAX
// package (ops/attention.py:30). A fully masked row then keeps a finite
// running max, its lse comes out near -1e30, and the (out, lse) partial
// merges weight it to zero without producing a NaN.
constexpr float TDT_NEG_INF = -1e30f;
constexpr float TDT_LOG2E = 1.4426950408889634f;

// Every library exports this so the ctypes wrapper can name an error.
extern "C" const char* tdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// 2^x on the special-function unit (max relative error ~2^-22; results
// below 2^-126 flush to zero, far under anything a bf16 p can hold).
__device__ __forceinline__ float tdt_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float tdt_exp(float x) {
  return tdt_exp2(x * TDT_LOG2E);
}

__device__ __forceinline__ uint32_t tdt_pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float tdt_warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float tdt_warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
