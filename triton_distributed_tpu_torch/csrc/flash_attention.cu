// Prefill flash attention forward, bf16 in, f32 softmax, optional lse.
//
// Replaces: triton_distributed_tpu/ops/attention.py::_fa_kernel (:42),
// launched by _fa_call (:143) for flash_attention (:223) and
// flash_attention_partial (:251).
//
// Contract (the same as _fa_call's): q (B, Sq, H, D), k/v (B, Skv, Hkv, D),
// GQA with kv head = h / (H / Hkv). Row r of q sits at global position
// q_offset + r, column c of k/v at kv_offset + c, and only columns
// c < kv_valid are real. Causal masking keeps kv_offset + c <= q_offset + r.
// q is multiplied by the softmax scale in bf16 before the product (the
// JAX wrapper's rounding point, attention.py:159-161); p is rounded to
// bf16 before the PV product and the denominator sums the f32 p, as in
// the Pallas body. Masked scores are -1e30 and contribute p = 0, so a
// row that sees no column gives out = 0 and lse ~ -1e30.
//
// What bounds it on the H100: at the prefill shapes of the main path
// (S = 512, D = 128, H = 32, Hkv = 8) the causal work is ~2*B*H*S^2*D
// flops against (2*Sq*H + 2*Skv*Hkv)*D*2 bytes per batch row, about 200
// flops per byte: just under the ridge point of the bf16 tensor cores
// (~295), so the least time is set by the bytes, with the flops within
// 1.5x of it. The kernel has to both stream and keep the tensor cores
// busy; scalar f32 arithmetic (67 TFLOP/s) would be 15x off.
//
// What the design does about it: the TPU kernel walks kv blocks as a
// sequential grid axis and keeps (m, l, acc) in VMEM scratch between grid
// steps. Here one CTA owns one (batch, head, 64-row q tile) and loops over
// 64-column kv tiles itself, only up to the causal / kv_valid limit, so
// nothing carries over between CTAs. Four warps each own 16 q rows; the
// QK^T and PV products run on the tensor cores with mma.sync m16n8k16
// (bf16 in, f32 accumulate). S stays in registers and its accumulator
// fragment is reused directly as the A operand of PV; the running max,
// denominator and output accumulator live in registers for the whole
// loop. K and V tiles stream through a 2-stage cp.async ring in shared
// memory (tile t+1 loads while tile t computes), rows padded by 8
// elements so the ldmatrix fragment loads (plain for K, transposed for
// V; one instruction feeds two mma's) are free of bank conflicts. Tiles
// every row of a warp sees in full skip the mask arithmetic. Not done
// yet (later work): TMA and wgmma.

#include "tdt_common.cuh"

namespace {

constexpr int BQ = 64;      // q rows per CTA: 16 per warp
constexpr int BK = 64;      // kv columns per tile
constexpr int NWARPS = 4;
constexpr int STAGES = 2;   // cp.async ring depth

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 b16 matrices from shared memory; lane L gives the address of
// row L % 8 of matrix L / 8. Register i holds matrix i's elements
// (lane / 4, 2 * (lane % 4) + {0, 1}), or with .trans those of its
// transpose.
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

// 16 bytes global -> shared, asynchronously; zero-fills when !pred.
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

// One kv tile of the online softmax for this thread's two rows (global
// positions row_glob and row_glob + 8): with MASK, scores the row must
// not see become -1e30 and give p = 0. Turns s into p in place, folds
// the tile into the running max and this thread's partial denominator,
// and rescales the output accumulator.
template <bool MASK, int NT>
__device__ __forceinline__ void softmax_tile(
    float (&s)[BK / 8][4], float (&o)[NT][4], float (&m_run)[2],
    float (&l_run)[2], int kv0, int row_glob, int t4, int kv_valid,
    int kv_offset, int causal) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_glob + r * 8;
    auto seen = [&](int j, int e) {
      const int col = kv0 + j * 8 + t4 * 2 + e;
      return col < kv_valid && (!causal || kv_offset + col <= row);
    };
    float mx = TDT_NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[j][r * 2 + e];
        if (MASK && !seen(j, e)) x = TDT_NEG_INF;
        mx = fmaxf(mx, x);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[r], mx);
    const float alpha = tdt_exp(m_run[r] - m_new);
    const float m_scaled = m_new * TDT_LOG2E;
    m_run[r] = m_new;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[j][r * 2 + e];
        x = tdt_exp2(fmaf(x, TDT_LOG2E, -m_scaled));
        if (MASK && !seen(j, e)) x = 0.f;
        psum += x;
      }
    }
    l_run[r] = l_run[r] * alpha + psum;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      o[nt][r * 2] *= alpha;
      o[nt][r * 2 + 1] *= alpha;
    }
  }
}

template <int D>
constexpr int smem_bytes() {
  return STAGES * 2 * BK * (D + 8) * 2;
}

template <int D>
__global__ void __launch_bounds__(NWARPS * 32)
fa_fwd_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
              int Sq, int Skv, int H, int Hkv, int q_offset, int kv_offset,
              int kv_valid, int causal, float q_scale) {
  constexpr int LD = D + 8;        // padded shared-memory row, in elements
  constexpr int KSTEPS = D / 16;   // k-steps of Q K^T
  constexpr int NT = D / 8;        // n-tiles of the output row block
  constexpr int VECS = D / 8;      // 16-byte vectors per K/V row
  constexpr int TILE = BK * LD;    // elements of one K or V tile
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  // stage s: K tile at smem + 2*s*TILE, V tile right after it

  // latest q tiles first: under causal masking they have the most work
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;   // mma fragment coordinates
  const int q0 = qt * BQ;
  const int row0 = q0 + warp * 16 + g;      // this thread's rows: row0, row0+8
  const size_t q_stride = static_cast<size_t>(H) * D;
  const size_t kv_stride = static_cast<size_t>(Hkv) * D;
  const __nv_bfloat16* kbase =
      k + static_cast<size_t>(b) * Skv * kv_stride + static_cast<size_t>(hk) * D;
  const __nv_bfloat16* vbase =
      v + static_cast<size_t>(b) * Skv * kv_stride + static_cast<size_t>(hk) * D;

  // kv columns this q tile can see at all
  const int q_last = min(q0 + BQ, Sq) - 1;
  int kv_end = kv_valid;
  if (causal) kv_end = min(kv_end, q_offset + q_last - kv_offset + 1);
  const int n_tiles = kv_end > 0 ? (kv_end + BK - 1) / BK : 0;

  auto load_tile = [&](int tile, int stage) {
    __nv_bfloat16* ks = smem + 2 * stage * TILE;
    __nv_bfloat16* vs = ks + TILE;
    for (int i = threadIdx.x; i < BK * VECS; i += NWARPS * 32) {
      const int r = i / VECS, c = (i % VECS) * 8;
      const int t = tile * BK + r;
      const bool ok = t < Skv;
      const size_t off = static_cast<size_t>(ok ? t : 0) * kv_stride + c;
      cp_async16(&ks[r * LD + c], kbase + off, ok);
      cp_async16(&vs[r * LD + c], vbase + off, ok);
    }
    cp_async_commit();
  };
  if (n_tiles > 0) load_tile(0, 0);

  // Q fragments (A operand, row-major 16x16 per k-step), scaled in bf16
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + (i & 1) * 8;
      const int c = kk * 16 + (i >> 1) * 8 + t4 * 2;
      uint32_t val = 0;
      if (r < Sq) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(
                q + (static_cast<size_t>(b) * Sq + r) * q_stride +
                static_cast<size_t>(h) * D + c));
        val = tdt_pack_bf16(f.x * q_scale, f.y * q_scale);
      }
      qa[kk][i] = val;
    }
  }

  float o[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m_run[2] = {TDT_NEG_INF, TDT_NEG_INF};
  float l_run[2] = {0.f, 0.f};   // per-thread partial sums over its columns

  // ldmatrix row addresses: lane L feeds row L % 8 of matrix L / 8
  const int lm_row = lane & 7, lm_mat = lane >> 3;

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) {
      load_tile(tile + 1, (tile + 1) % STAGES);
      cp_async_wait<1>();      // this tile's group has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = smem + 2 * (tile % STAGES) * TILE;
    const __nv_bfloat16* vs = ks + TILE;
    const int kv0 = tile * BK;

    // S = Q K^T: 16 rows x BK columns for this warp, f32 accumulators.
    // One ldmatrix.x4 gives the B fragments of k-steps kk and kk+1.
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; kk += 2) {
        uint32_t bf[4];
        ldsm_x4(bf, &ks[(j * 8 + lm_row) * LD + kk * 16 + lm_mat * 8]);
        mma_16816(s[j], qa[kk], bf);
        mma_16816(s[j], qa[kk + 1], bf + 2);
      }
    }

    // online softmax; s becomes p in place. Only tiles some row of this
    // warp does not fully see pay for the mask.
    const bool full = kv0 + BK <= kv_valid &&
                      (!causal || kv_offset + kv0 + BK - 1 <=
                                      q_offset + q0 + warp * 16);
    if (full)
      softmax_tile<false>(s, o, m_run, l_run, kv0, q_offset + row0, t4,
                          kv_valid, kv_offset, causal);
    else
      softmax_tile<true>(s, o, m_run, l_run, kv0, q_offset + row0, t4,
                         kv_valid, kv_offset, causal);

    // O += P V: the S accumulator layout is the A fragment layout of PV.
    // One ldmatrix.x4.trans gives the B fragments of n-tiles nt and nt+1.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {
          tdt_pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          tdt_pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          tdt_pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          tdt_pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, &vs[(kk * 16 + (lm_mat & 1) * 8 + lm_row) * LD +
                              (nt + (lm_mat >> 1)) * 8]);
        mma_16816(o[nt], pa, bf);
        mma_16816(o[nt + 1], pa, bf + 2);
      }
    }
    __syncthreads();   // the next iteration's loads reuse this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    const int row = row0 + r * 8;
    if (row < Sq) {
      __nv_bfloat16* orow = out + (static_cast<size_t>(b) * Sq + row) * q_stride +
                            static_cast<size_t>(h) * D;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8 + t4 * 2) =
            __floats2bfloat162_rn(o[nt][r * 2] / l, o[nt][r * 2 + 1] / l);
      if (lse != nullptr && t4 == 0)
        lse[(static_cast<size_t>(b) * Sq + row) * H + h] = m_run[r] + logf(l);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int Sq, int Skv, int H, int Hkv, int q_offset,
           int kv_offset, int kv_valid, int causal, float q_scale,
           cudaStream_t st) {
  constexpr int bytes = smem_bytes<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      fa_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fa_fwd_kernel<D><<<grid, NWARPS * 32, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), Sq, Skv, H, Hkv, q_offset, kv_offset, kv_valid,
      causal, q_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/k/v/out bf16, contiguous, 16-byte aligned; lse f32 (B, Sq, H) or null.
extern "C" int tdt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* out, void* lse,
                                       int B, int Sq, int Skv, int H, int Hkv,
                                       int D, int q_offset, int kv_offset,
                                       int kv_valid, int causal, float q_scale,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<128>(q, k, v, out, lse, B, Sq, Skv, H, Hkv, q_offset,
                       kv_offset, kv_valid, causal, q_scale, st);
  if (D == 64)
    return launch<64>(q, k, v, out, lse, B, Sq, Skv, H, Hkv, q_offset,
                      kv_offset, kv_valid, causal, q_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
