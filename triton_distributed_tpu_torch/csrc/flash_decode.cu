// One-query decode attention against a contiguous KV cache, returning
// (out, lse) partials.
//
// Replaces: triton_distributed_tpu/ops/attention.py::_decode_kernel
// (:513), launched by flash_decode_partial (:560) for flash_decode (:648).
//
// Contract (the same as flash_decode_partial's): q (B, H, D) bf16, cache
// k/v (B, Skv, Hkv, D) bf16 of which the first kv_len[b] rows are real
// (kv_len int32 (B,), clamped to [0, Skv]). Scores are q.k in f32 times
// the scale (the JAX kernel scales the f32 scores, attention.py:534);
// p is rounded to bf16 for the PV product, the denominator sums the f32
// p. Returns out (B, H, D) bf16 and lse (B, H) f32 in natural log; a
// sequence with kv_len 0 gives out = 0 and lse ~ -1e30.
//
// What bounds it on the H100: bytes. Each query row does 4*D flops per
// cache row it reads, against 4*D bytes of K and V shared by the G = H/Hkv
// q heads of its kv head: ~G flops per byte, far below the bf16 ridge
// (~295). The least time is the K/V bytes up to kv_len over 3.35 TB/s.
//
// What the design does about it: the TPU kernel walks kv blocks on a
// sequential grid axis with a block index clamped at kv_len so the DMA of
// blocks past the end is elided. Here one CTA owns one (batch, kv head)
// and reads K/V only up to kv_len[b]; the G q heads of that kv head share
// every K/V row it reads, so the cache is read once per kv head, not once
// per q head. Eight warps take 32-row blocks in turn: for Q.K each lane
// streams one whole K row (16-byte loads) against q held in shared
// memory, for P.V each lane owns D/32 output dims of every V row. A lane
// starts the loads of its K row and of its slice of the block's 32 V rows
// (coalesced across the warp) before it computes anything, so a block
// costs one memory round trip, not one per V row. The eight warps' (m, l, acc)
// merge through shared memory at the end. With one CTA per (batch, kv head) only B*Hkv CTAs
// run (32 at the main path's shapes, on 132 SMs), so the card's bandwidth
// is not reached: splitting the cache across CTAs and merging the
// partials with combine_partials is later work.

#include "tdt_common.cuh"

namespace {

constexpr int NW = 8;   // warps per CTA

// a lane's D/32 bf16 dims of one V row, loaded as one vector
template <int DPL> struct VRowOf;
template <> struct VRowOf<2> { using type = uint32_t; };
template <> struct VRowOf<4> { using type = uint2; };

template <int D, int G>
__global__ void __launch_bounds__(NW * 32)
decode_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const int* __restrict__ kv_len, __nv_bfloat16* __restrict__ out,
              float* __restrict__ lse, int Skv, int H, int Hkv, float scale) {
  constexpr int DPL = D / 32;   // output dims per lane
  constexpr int VECS = D / 8;   // 16-byte vectors per K row
  using VRow = typename VRowOf<DPL>::type;
  __shared__ __align__(16) float qs[G][D];
  __shared__ float red_m[NW][G];
  __shared__ float red_l[NW][G];
  __shared__ float red_o[NW][G][D];

  const int hk = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = min(max(kv_len[b], 0), Skv);
  const size_t row_stride = static_cast<size_t>(Hkv) * D;
  const __nv_bfloat16* kb =
      k + static_cast<size_t>(b) * Skv * row_stride + static_cast<size_t>(hk) * D;
  const __nv_bfloat16* vb =
      v + static_cast<size_t>(b) * Skv * row_stride + static_cast<size_t>(hk) * D;

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

  for (int blk = warp * 32; blk < n; blk += NW * 32) {
    const int t = blk + lane;
    const bool valid = t < n;
    const int rows = min(32, n - blk);
    // start every load of the block at once: this lane's K row, and its
    // D/32 dims of each of the block's V rows
    uint4 raw[VECS];
    if (valid) {
      const uint4* kr = reinterpret_cast<const uint4*>(
          kb + static_cast<size_t>(t) * row_stride);
#pragma unroll
      for (int c = 0; c < VECS; ++c) raw[c] = kr[c];
    }
    VRow vrow[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      if (r < rows)
        vrow[r] = *reinterpret_cast<const VRow*>(
            vb + static_cast<size_t>(blk + r) * row_stride + lane * DPL);
    }
    float s[G];
#pragma unroll
    for (int gg = 0; gg < G; ++gg) s[gg] = 0.f;
    if (valid) {
#pragma unroll
      for (int c = 0; c < VECS; ++c) {
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw[c]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 kf = __bfloat1622float2(h2[e]);
#pragma unroll
          for (int gg = 0; gg < G; ++gg) {
            s[gg] = fmaf(qs[gg][c * 8 + 2 * e], kf.x, s[gg]);
            s[gg] = fmaf(qs[gg][c * 8 + 2 * e + 1], kf.y, s[gg]);
          }
        }
      }
    }

    float pb[G];   // p rounded to bf16: the PV operand
#pragma unroll
    for (int gg = 0; gg < G; ++gg) {
      const float x = valid ? s[gg] * scale : TDT_NEG_INF;
      const float m_new = fmaxf(m[gg], tdt_warp_max(x));
      const float alpha = tdt_exp(m[gg] - m_new);
      const float p = valid ? tdt_exp(x - m_new) : 0.f;
      l[gg] = l[gg] * alpha + p;   // per-lane partial, reduced at the end
      m[gg] = m_new;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[gg][e] *= alpha;
      pb[gg] = __bfloat162float(__float2bfloat16_rn(p));
    }

#pragma unroll
    for (int r = 0; r < 32; ++r) {
      if (r < rows) {
        const __nv_bfloat162* v2 =
            reinterpret_cast<const __nv_bfloat162*>(&vrow[r]);
        float vf[DPL];
#pragma unroll
        for (int e = 0; e < DPL; e += 2) {
          const float2 f = __bfloat1622float2(v2[e / 2]);
          vf[e] = f.x;
          vf[e + 1] = f.y;
        }
#pragma unroll
        for (int gg = 0; gg < G; ++gg) {
          const float pr = __shfl_sync(0xffffffffu, pb[gg], r);
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

template <int D, int G>
void launch(const void* q, const void* k, const void* v, const void* kv_len,
            void* out, void* lse, int B, int Skv, int H, int Hkv, float scale,
            cudaStream_t st) {
  decode_kernel<D, G><<<dim3(Hkv, B), NW * 32, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(kv_len),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), Skv, H, Hkv,
      scale);
}

template <int D>
bool launch_g(int G, const void* q, const void* k, const void* v,
              const void* kv_len, void* out, void* lse, int B, int Skv, int H,
              int Hkv, float scale, cudaStream_t st) {
  switch (G) {
    case 1: launch<D, 1>(q, k, v, kv_len, out, lse, B, Skv, H, Hkv, scale, st); return true;
    case 2: launch<D, 2>(q, k, v, kv_len, out, lse, B, Skv, H, Hkv, scale, st); return true;
    case 4: launch<D, 4>(q, k, v, kv_len, out, lse, B, Skv, H, Hkv, scale, st); return true;
    case 5: launch<D, 5>(q, k, v, kv_len, out, lse, B, Skv, H, Hkv, scale, st); return true;
    case 8: launch<D, 8>(q, k, v, kv_len, out, lse, B, Skv, H, Hkv, scale, st); return true;
    case 10: launch<D, 10>(q, k, v, kv_len, out, lse, B, Skv, H, Hkv, scale, st); return true;
    default: return false;
  }
}

}  // namespace

// q (B, H, D), k/v (B, Skv, Hkv, D), out (B, H, D): bf16, contiguous,
// 16-byte aligned. kv_len int32 (B,); lse f32 (B, H). D in {64, 128},
// G = H / Hkv in {1, 2, 4, 5, 8, 10}.
extern "C" int tdt_flash_decode(const void* q, const void* k, const void* v,
                                const void* kv_len, void* out, void* lse,
                                int B, int Skv, int H, int Hkv, int D,
                                float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / Hkv;
  bool ok = false;
  if (D == 128)
    ok = launch_g<128>(G, q, k, v, kv_len, out, lse, B, Skv, H, Hkv, scale, st);
  else if (D == 64)
    ok = launch_g<64>(G, q, k, v, kv_len, out, lse, B, Skv, H, Hkv, scale, st);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
