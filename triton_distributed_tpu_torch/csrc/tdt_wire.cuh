// The device side of the quantized collective wire (counterpart of
// triton_distributed_tpu/ops/wire.py's in-kernel codec,
// `quant_value_blocks` :172 and `dequant_value_blocks` :193; the plain
// versions are the port's ops/wire.py functions of the same names).
//
// A (rows, cols) f32 value is cut into `blk`-wide blocks of each row; a
// block is scaled by its own absmax into the wire dtype, one byte an
// element, with one f32 scale:
//   scale = max(amax, 1e-30) / qmax        (qmax 127 for int8, 448 for fp8)
//   q     = x / scale,  int8: rounded half to even; fp8 e4m3: the
//           conversion rounds to nearest even, saturating at 448.
// Both divisions are IEEE (__fdiv_rn: no reciprocal multiply, whatever the
// flags), so the bytes and scales equal the torch and the eager JAX codec
// bit for bit (ROADMAP Queue C 2). The receiver dequantizes each source's
// block as q * scale (__fmul_rn) and adds the sources in rank order
// 0..n-1 in f32 (__fadd_rn, no fused multiply-add), rounding once to the
// output dtype: JAX's `red_body` and the port's `wire.dequant_accumulate`.
//
// Used by the quant arms of gemm_rs.cu and gemm_ar.cu, which stage a CTA's
// f32 accumulator strip (BM rows x SW columns, a whole number of blocks)
// in shared memory and quantize it here before pushing it.
#pragma once

#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "tdt_common.cuh"

namespace tdt_wire {

constexpr int WIRE_INT8 = 0;
constexpr int WIRE_FP8 = 1;
constexpr int MAX_STRIP = 512;  // ops/_common.WIRE_MAX_STRIP

// The quant arms' shape rule and layouts (ops/_common.check_wire_block and
// shmem.wire_workspace on the host). A CTA quantizes a strip of
// strip_width(blk) columns, a whole number of blocks: a block of at most
// 128 columns that divides the 128-column GEMM tile, or one block of a
// multiple of 128 columns up to MAX_STRIP.
__host__ __device__ inline bool block_ok(int blk) {
  return blk >= 8 && blk % 8 == 0 &&
         (128 % blk == 0 || (blk % 128 == 0 && blk <= MAX_STRIP));
}
__host__ __device__ inline int strip_width(int blk) {
  return blk > 128 ? blk : 128;
}
// Dynamic shared memory of a strip of BM rows: the f32 values, then one
// scale per block.
inline size_t strip_smem(int bm, int blk) {
  const int sw = strip_width(blk);
  return static_cast<size_t>(bm) * (sw + sw / blk) * sizeof(float);
}
// A landing region holds q (n, rows, N) bytes, then the scales (n, rows,
// N / blk) f32 from the next 16-byte boundary.
__host__ __device__ inline size_t scale_offset(int n, int rows, int N) {
  return (static_cast<size_t>(n) * rows * N + 15) / 16 * 16;
}

template <int W>
struct Codec;

template <>
struct Codec<WIRE_INT8> {
  static constexpr float qmax = 127.f;
  __device__ __forceinline__ static uint32_t encode(float q) {
    return static_cast<uint32_t>(static_cast<uint8_t>(
        static_cast<int8_t>(__float2int_rn(q))));
  }
  __device__ __forceinline__ static float decode(uint32_t byte) {
    return static_cast<float>(static_cast<int8_t>(byte & 0xFFu));
  }
};

template <>
struct Codec<WIRE_FP8> {
  static constexpr float qmax = 448.f;
  __device__ __forceinline__ static uint32_t encode(float q) {
    return static_cast<uint32_t>(
        __nv_cvt_float_to_fp8(q, __NV_SATFINITE, __NV_E4M3));
  }
  __device__ __forceinline__ static float decode(uint32_t byte) {
    const __half_raw h = __nv_cvt_fp8_to_halfraw(
        static_cast<__nv_fp8_storage_t>(byte & 0xFFu), __NV_E4M3);
    return __half2float(__half(h));
  }
};

// Quantize the staged strip stage[row * ld + col], rows [0, live), cols
// [0, width) (width a multiple of blk, blk a multiple of 8), and store it
// to each of the `ndst` destinations: bytes at q[d] + row * ldq + col and
// scales at s[d] + row * lds + col / blk. `scales` is shared scratch of at
// least live * (width / blk) floats. Every thread of the CTA calls it.
template <int W>
__device__ void quant_strip(const float* stage, int ld, int live, int width,
                            int blk, uint8_t* const* q, float* const* s,
                            int ndst, int ldq, int lds, float* scales) {
  using C = Codec<W>;
  const int nbk = width / blk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int p = warp; p < live * nbk; p += nwarps) {
    const int row = p / nbk, k = p % nbk;
    const float* v = stage + static_cast<size_t>(row) * ld + k * blk;
    float amax = 0.f;
    for (int e = lane; e < blk; e += 32) amax = fmaxf(amax, fabsf(v[e]));
    amax = tdt_warp_max(amax);
    if (lane == 0) {
      const float scale = __fdiv_rn(fmaxf(amax, 1e-30f), C::qmax);
      scales[p] = scale;
      for (int d = 0; d < ndst; ++d)
        s[d][static_cast<size_t>(row) * lds + k] = scale;
    }
  }
  __syncthreads();
  const int per_row = width / 4;
  for (int i = threadIdx.x; i < live * per_row; i += blockDim.x) {
    const int row = i / per_row, col = (i % per_row) * 4;
    const float scale = scales[row * nbk + col / blk];
    const float4 x = *reinterpret_cast<const float4*>(
        stage + static_cast<size_t>(row) * ld + col);
    const uint32_t word = C::encode(__fdiv_rn(x.x, scale)) |
                          C::encode(__fdiv_rn(x.y, scale)) << 8 |
                          C::encode(__fdiv_rn(x.z, scale)) << 16 |
                          C::encode(__fdiv_rn(x.w, scale)) << 24;
    for (int d = 0; d < ndst; ++d)
      *reinterpret_cast<uint32_t*>(q[d] + static_cast<size_t>(row) * ldq +
                                   col) = word;
  }
}

// Four values rounded to T and stored at p (8- or 16-byte aligned).
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  uint2 w;
  w.x = tdt_pack_bf16(v[0], v[1]);
  w.y = tdt_pack_bf16(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = w;
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// out[row * ldo + col] for rows [0, live), cols [0, width): the n landed
// sources dequantized and summed in rank order in f32, rounded once to T.
// Source s's bytes at q + s * qstride + row * ldq + col, its scales at
// sc + s * sstride + row * lds + col / blk; read through L2 (after the
// acquire of their signals). Every thread of the CTA calls it.
template <int W, typename T>
__device__ void dequant_sum(T* out, int ldo, const uint8_t* q,
                            size_t qstride, int ldq, const float* sc,
                            size_t sstride, int lds, int n, int live,
                            int width, int blk) {
  using C = Codec<W>;
  const int per_row = width / 4;
  for (int i = threadIdx.x; i < live * per_row; i += blockDim.x) {
    const int row = i / per_row, col = (i % per_row) * 4;
    float acc[4];
    for (int s = 0; s < n; ++s) {
      const uint32_t word = __ldcg(reinterpret_cast<const unsigned*>(
          q + s * qstride + static_cast<size_t>(row) * ldq + col));
      const float scale =
          __ldcg(sc + s * sstride + static_cast<size_t>(row) * lds +
                 col / blk);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = __fmul_rn(C::decode(word >> (8 * j)), scale);
        acc[j] = s == 0 ? v : __fadd_rn(acc[j], v);
      }
    }
    store4(out + static_cast<size_t>(row) * ldo + col, acc);
  }
}

}  // namespace tdt_wire
