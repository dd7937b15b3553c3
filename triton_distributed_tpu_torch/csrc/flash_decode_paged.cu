// One-query decode attention against a PAGED KV pool, reading each
// sequence's pages in place through its block table; returns (out, lse)
// partials.
//
// Replaces: triton_distributed_tpu/ops/attention.py::_paged_decode_kernel
// (:685, pages chosen by the index map paged_kv_block_map :660) and
// ::_paged_decode_quant_kernel (:715, scale rows by paged_kv_scale_map
// :695), both launched by flash_decode_paged_partial (:781). One template
// covers both: T is the pool's element type, __nv_bfloat16 (the bf16 arm)
// or int8_t / __nv_fp8_e4m3 (the quantized arms).
//
// Contract (flash_decode_paged_partial's): q (B, H, D) bf16; one layer's
// pools k/v (nb, Hkv, block, D) of T; for the quantized arms f32 scale
// sidecars k_scales/v_scales (nb, Hkv, block), one scale per row; table
// (B, mb) int32 page ids, -1 unassigned; kv_len (B,) int32. Sequence b's
// row t lives in page table[b, t / block], row t % block. Rows past
// kv_len[b] (clamped to [0, mb * block]) are never read; a -1 inside
// kv_len reads page 0, as the JAX index map clamps (:679), and page ids
// clamp to [0, nb), so no address outside the pool is formed.
// bf16 arm: s = q.k * scale in f32, p rounded to bf16 for the PV product
// (the JAX kernel's p.astype(v.dtype)). Quantized arms: s = (q.k_q) *
// k_scale * scale, acc += (p * v_scale) * v_q with p in f32, so no
// dequantized copy of a page is made. out (B, H, D) bf16, lse (B, H) f32;
// kv_len 0 gives out = 0 and lse ~ -1e30.
//
// What bounds it on the H100: bytes. The work is sum(kv_len) rows of K
// and V at the pool's width (plus two f32 scales per row when quantized)
// for ~G flops per byte, far below the ridge; the least time is those
// bytes over 3.35 TB/s. Only B x Hkv CTAs run (32 at the main path's
// shape, on 132 SMs), the limit measured for flash_decode; splitting
// the pages of a sequence across CTAs and merging the partials with
// combine_partials is later work.
//
// What the design does about it, as flash_decode.cu: one CTA per (slot,
// kv head), so the G q heads of a kv head share every row read. The
// TPU kernel gets page ids by scalar prefetch into its index map; here
// the CTA reads each page id from the table itself. Eight warps take
// 32-row blocks in turn; block is a multiple of 32, so a warp's rows lie
// in one page and its page id is one load. Each lane loads one whole K
// row (16-byte vectors) and its D/32 dims of the block's 32 V rows before
// computing, so a block costs one memory round trip. Wire-width elements
// convert to f32 in registers (fp8 through cuda_fp8.h).

#include "tdt_common.cuh"

#include <cuda_fp8.h>

#include <type_traits>

namespace {

constexpr int NW = 8;   // warps per CTA

// a lane's D/32 elements of one V row, loaded as one vector
template <int BYTES> struct VecOf;
template <> struct VecOf<2> { using type = uint16_t; };
template <> struct VecOf<4> { using type = uint32_t; };
template <> struct VecOf<8> { using type = uint2; };

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

template <int D, int G, class T>
__global__ void __launch_bounds__(NW * 32)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const T* __restrict__ k_pool, const T* __restrict__ v_pool,
                    const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales,
                    const int* __restrict__ table,
                    const int* __restrict__ kv_len,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                    int nb, int H, int Hkv, int block, int mb, float scale) {
  constexpr bool QUANT = !std::is_same<T, __nv_bfloat16>::value;
  constexpr int DPL = D / 32;                  // V dims per lane
  constexpr int EPV = 16 / sizeof(T);          // elements per 16 bytes
  constexpr int VECS = D / EPV;                // 16-byte vectors per K row
  using VRow = typename VecOf<DPL * sizeof(T)>::type;
  __shared__ __align__(16) float qs[G][D];
  __shared__ float red_m[NW][G];
  __shared__ float red_l[NW][G];
  __shared__ float red_o[NW][G][D];

  const int hk = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = min(max(kv_len[b], 0), mb * block);
  const int* trow = table + static_cast<size_t>(b) * mb;

  for (int i = threadIdx.x; i < G * D; i += NW * 32)
    qs[i / D][i % D] = __bfloat162float(
        q[(static_cast<size_t>(b) * H + hk * G + i / D) * D + i % D]);
  __syncthreads();

  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int gg = 0; gg < G; ++gg) {
    m[gg] = TDT_NEG_INF;
    l[gg] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[gg][e] = 0.f;
  }

  for (int base = warp * 32; base < n; base += NW * 32) {
    const int t = base + lane;
    const bool valid = t < n;
    const int rows = min(32, n - base);
    const int col = base / block;
    const int page = min(max(trow[col], 0), nb - 1);
    // first row of this warp's 32-row block, counted in rows of D
    const size_t row0 =
        (static_cast<size_t>(page) * Hkv + hk) * block + (base - col * block);
    // start every load of the block at once: this lane's K row and
    // scales, and its D/32 dims of each of the block's V rows
    uint4 raw[VECS];
    float ksc = 0.f, vsc = 0.f;
    if (valid) {
      const uint4* kr =
          reinterpret_cast<const uint4*>(k_pool + (row0 + lane) * D);
#pragma unroll
      for (int c = 0; c < VECS; ++c) raw[c] = kr[c];
      if constexpr (QUANT) {
        ksc = k_scales[row0 + lane];
        vsc = v_scales[row0 + lane];
      }
    }
    VRow vrow[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      if (r < rows)
        vrow[r] = *reinterpret_cast<const VRow*>(
            v_pool + (row0 + r) * D + lane * DPL);
    }
    float s[G];
#pragma unroll
    for (int gg = 0; gg < G; ++gg) s[gg] = 0.f;
    if (valid) {
#pragma unroll
      for (int c = 0; c < VECS; ++c) {
        const T* e = reinterpret_cast<const T*>(&raw[c]);
#pragma unroll
        for (int j = 0; j < EPV; ++j) {
          const float kf = to_f32(e[j]);
#pragma unroll
          for (int gg = 0; gg < G; ++gg)
            s[gg] = fmaf(qs[gg][c * EPV + j], kf, s[gg]);
        }
      }
    }

    float pv[G];   // the PV operand: p rounded to bf16, or p * v_scale
#pragma unroll
    for (int gg = 0; gg < G; ++gg) {
      float x = TDT_NEG_INF;
      if (valid) x = QUANT ? s[gg] * ksc * scale : s[gg] * scale;
      const float m_new = fmaxf(m[gg], tdt_warp_max(x));
      const float alpha = tdt_exp(m[gg] - m_new);
      const float p = valid ? tdt_exp(x - m_new) : 0.f;
      l[gg] = l[gg] * alpha + p;   // per-lane partial, reduced at the end
      m[gg] = m_new;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[gg][e] *= alpha;
      pv[gg] = QUANT ? p * vsc : __bfloat162float(__float2bfloat16_rn(p));
    }

#pragma unroll
    for (int r = 0; r < 32; ++r) {
      if (r < rows) {
        const T* ve = reinterpret_cast<const T*>(&vrow[r]);
        float vf[DPL];
#pragma unroll
        for (int e = 0; e < DPL; ++e) vf[e] = to_f32(ve[e]);
#pragma unroll
        for (int gg = 0; gg < G; ++gg) {
          const float pr = __shfl_sync(0xffffffffu, pv[gg], r);
#pragma unroll
          for (int e = 0; e < DPL; ++e)
            acc[gg][e] = fmaf(pr, vf[e], acc[gg][e]);
        }
      }
    }
  }

#pragma unroll
  for (int gg = 0; gg < G; ++gg) {
    const float lw = tdt_warp_sum(l[gg]);
    if (lane == 0) {
      red_m[warp][gg] = m[gg];
      red_l[warp][gg] = lw;
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e) red_o[warp][gg][lane * DPL + e] = acc[gg][e];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < G * D; i += NW * 32) {
    const int gg = i / D, d = i % D;
    float M = TDT_NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, red_m[w][gg]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float sc = tdt_exp(red_m[w][gg] - M);
      L = fmaf(red_l[w][gg], sc, L);
      O = fmaf(red_o[w][gg][d], sc, O);
    }
    L = fmaxf(L, 1e-30f);
    const size_t row = static_cast<size_t>(b) * H + hk * G + gg;
    out[row * D + d] = __float2bfloat16_rn(O / L);
    if (d == 0) lse[row] = M + logf(L);
  }
}

struct Args {
  const void *q, *k, *v, *ks, *vs, *table, *kv_len;
  void *out, *lse;
  int B, nb, H, Hkv, block, mb;
  float scale;
  cudaStream_t st;
};

template <class T, int D, int G>
void launch(const Args& a) {
  paged_decode_kernel<D, G, T><<<dim3(a.Hkv, a.B), NW * 32, 0, a.st>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.table),
      static_cast<const int*>(a.kv_len), static_cast<__nv_bfloat16*>(a.out),
      static_cast<float*>(a.lse), a.nb, a.H, a.Hkv, a.block, a.mb, a.scale);
}

template <class T, int D>
bool launch_g(int G, const Args& a) {
  switch (G) {
    case 1: launch<T, D, 1>(a); return true;
    case 2: launch<T, D, 2>(a); return true;
    case 4: launch<T, D, 4>(a); return true;
    case 5: launch<T, D, 5>(a); return true;
    case 8: launch<T, D, 8>(a); return true;
    case 10: launch<T, D, 10>(a); return true;
    default: return false;
  }
}

template <class T>
int run(const void* q, const void* k, const void* v, const void* ks,
        const void* vs, const void* table, const void* kv_len, void* out,
        void* lse, int B, int nb, int H, int Hkv, int D, int block, int mb,
        float scale, void* stream) {
  const Args a{q,  k,  v,     ks,  vs,    table, kv_len, out, lse,
               B,  nb, H,     Hkv, block, mb,    scale,
               static_cast<cudaStream_t>(stream)};
  const int G = H / Hkv;
  bool ok = block % 32 == 0 && block > 0 && G * Hkv == H;
  if (ok) {
    if (D == 128)
      ok = launch_g<T, 128>(G, a);
    else if (D == 64)
      ok = launch_g<T, 64>(G, a);
    else
      ok = false;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: (B, H, D) bf16; k/v: (nb, Hkv, block, D) of the arm's type;
// ks/vs: (nb, Hkv, block) f32 for the int8 and fp8 arms (unused, may be
// null, for bf16); table (B, mb) int32; kv_len (B,) int32; lse (B, H)
// f32. All contiguous, 16-byte aligned. D in {64, 128}, G = H / Hkv in
// {1, 2, 4, 5, 8, 10}, block a multiple of 32.
#define TDT_PAGED_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const void* q, const void* k, const void* v,           \
                      const void* ks, const void* vs, const void* table,     \
                      const void* kv_len, void* out, void* lse, int B,       \
                      int nb, int H, int Hkv, int D, int block, int mb,      \
                      float scale, void* stream) {                           \
    return run<T>(q, k, v, ks, vs, table, kv_len, out, lse, B, nb, H, Hkv,   \
                  D, block, mb, scale, stream);                              \
  }

TDT_PAGED_ENTRY(tdt_flash_decode_paged_bf16, __nv_bfloat16)
TDT_PAGED_ENTRY(tdt_flash_decode_paged_int8, int8_t)
TDT_PAGED_ENTRY(tdt_flash_decode_paged_fp8, __nv_fp8_e4m3)
