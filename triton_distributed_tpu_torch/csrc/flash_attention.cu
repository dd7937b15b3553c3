// Prefill flash attention forward, bf16 in, f32 softmax, optional lse: the
// dense arm (tdt_flash_attention_fwd) and the varlen arm over a packed
// ragged batch (tdt_flash_attention_varlen_fwd, described after the first).
//
// Replaces: triton_distributed_tpu/ops/attention.py::_fa_kernel (:42),
// launched by _fa_call (:143) for flash_attention (:223) and
// flash_attention_partial (:251); and _fa_varlen_kernel (:284), launched by
// _fa_varlen_call (:399) for flash_attention_varlen (:465) and
// flash_attention_varlen_partial (:489).
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
// yet (later work): TMA and wgmma. The tile (loads, products, online
// softmax) is csrc/tdt_flash.cuh's, shared with the varlen arm and
// csrc/sp_ag_attention.cu.
//
// The varlen arm. Contract (_fa_varlen_call's, with a batch dimension so
// the varlen ring runs its n ranks in one launch): q (B, T, H, D), k/v (B,
// Tk, Hkv, D); qmeta (B, meta_rows, 128) int32, lanes 0 / 1 of row t the
// global (seq_start, seq_end) of q row t (rows past the live sequences
// (INT32_MAX, 0)); offs (B, 3) int32, batch row b's (q_offset, kv_offset,
// kv_valid), read on the device. Row t of batch row b sits at global
// q_offset + t, column c at kv_offset + c; it sees column c when c <
// kv_valid, seq_start <= kv_offset + c < seq_end and, causal, kv_offset + c
// <= q_offset + t. The f32 scores are multiplied by the scale (JAX :323-325;
// the dense arm scales q in bf16 instead), p is masked explicitly (:345),
// and a row that sees nothing comes out 0 with lse ~ -1e30. Its design:
// one CTA owns one (batch row, head, 64-row q tile), reads its rows'
// segment bounds once and walks only the kv tiles in [min start, max end)
// of its rows, within [0, kv_valid) and the causal limit: the block culling
// of JAX :311-316 done once a CTA rather than tested block by block. Tiles
// a warp's 16 rows see in full skip the mask. Its bound is the dense arm's
// per visible (row, column) pair: a packed batch of short sequences is far
// below the ridge point, so bytes bound it.

#include "tdt_flash.cuh"

namespace {

using namespace tdt_flash;

template <int D>
__global__ void __launch_bounds__(NTHREADS)
fa_fwd_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
              int Sq, int Skv, int H, int Hkv, int q_offset, int kv_offset,
              int kv_valid, int causal, float q_scale) {
  constexpr int NT = D / 8;        // n-tiles of the output row block
  constexpr int TILE = BK * (D + 8);  // elements of one K or V tile
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

  if (n_tiles > 0) load_kv_tile<D>(smem, 0, kbase, vbase, kv_stride, 0, Skv);

  // Q fragments, scaled in bf16
  auto qrow = [&](int r) -> const __nv_bfloat16* {
    return r < Sq ? q + (static_cast<size_t>(b) * Sq + r) * q_stride +
                        static_cast<size_t>(h) * D
                  : nullptr;
  };
  uint32_t qa[D / 16][4];
  load_q<D>(qa, qrow(row0), qrow(row0 + 8), t4, q_scale);

  float o[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m_run[2] = {TDT_NEG_INF, TDT_NEG_INF};
  float l_run[2] = {0.f, 0.f};   // per-thread partial sums over its columns

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) {
      load_kv_tile<D>(smem, (tile + 1) % STAGES, kbase, vbase, kv_stride,
                      tile + 1, Skv);
      cp_async_wait<1>();      // this tile's group has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = smem + 2 * (tile % STAGES) * TILE;
    const __nv_bfloat16* vs = ks + TILE;
    const int kv0 = tile * BK;

    float s[BK / 8][4];
    qk_tile<D>(s, qa, ks, lane);

    // online softmax; s becomes p in place. Only tiles some row of this
    // warp does not fully see pay for the mask.
    const int row_glob = q_offset + row0;
    auto seen = [&](int r, int c) {
      const int col = kv0 + c;
      return col < kv_valid &&
             (!causal || kv_offset + col <= row_glob + r * 8);
    };
    const bool full = kv0 + BK <= kv_valid &&
                      (!causal || kv_offset + kv0 + BK - 1 <=
                                      q_offset + q0 + warp * 16);
    if (full)
      softmax_tile<false>(s, o, m_run, l_run, t4, seen);
    else
      softmax_tile<true>(s, o, m_run, l_run, t4, seen);

    pv_tile<D>(o, s, vs, lane);
    __syncthreads();   // the next iteration's loads reuse this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = row_denominator(l_run[r]);
    const int row = row0 + r * 8;
    if (row < Sq) {
      store_row<D>(out + (static_cast<size_t>(b) * Sq + row) * q_stride +
                       static_cast<size_t>(h) * D,
                   o, r, l, t4);
      if (lse != nullptr && t4 == 0)
        lse[(static_cast<size_t>(b) * Sq + row) * H + h] = m_run[r] + logf(l);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
fa_varlen_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ qmeta, const int* __restrict__ offs,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int T, int Tk, int H, int Hkv, int meta_rows, int causal,
                 float scale) {
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = qt * BQ;
  const int row0 = q0 + warp * 16 + g;
  const size_t q_stride = static_cast<size_t>(H) * D;
  const size_t kv_stride = static_cast<size_t>(Hkv) * D;
  const int q_off = offs[3 * b], kv_off = offs[3 * b + 1];
  const int kv_valid = offs[3 * b + 2];
  const __nv_bfloat16* kbase =
      k + static_cast<size_t>(b) * Tk * kv_stride + static_cast<size_t>(hk) * D;
  const __nv_bfloat16* vbase =
      v + static_cast<size_t>(b) * Tk * kv_stride + static_cast<size_t>(hk) * D;

  const RowSegments rs = row_segments(
      qmeta + static_cast<size_t>(b) * meta_rows * 128, row0, T);
  // the local kv columns some row of the tile can see: [c_lo, c_hi)
  const int q_last = min(q0 + BQ, T) - 1;
  long long c_lo = max(0LL, static_cast<long long>(rs.lo) - kv_off);
  long long c_hi = min(static_cast<long long>(kv_valid),
                       static_cast<long long>(rs.hi) - kv_off);
  if (causal)
    c_hi = min(c_hi, static_cast<long long>(q_off) + q_last - kv_off + 1);
  const int t0 = static_cast<int>(c_lo / BK);
  const int t1 = c_hi > c_lo ? static_cast<int>((c_hi + BK - 1) / BK) : t0;

  auto qrow = [&](int r) -> const __nv_bfloat16* {
    return r < T ? q + (static_cast<size_t>(b) * T + r) * q_stride +
                       static_cast<size_t>(h) * D
                 : nullptr;
  };
  uint32_t qa[D / 16][4];
  load_q<D>(qa, qrow(row0), qrow(row0 + 8), t4, 1.f);

  float o[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m_run[2] = {TDT_NEG_INF, TDT_NEG_INF};
  float l_run[2] = {0.f, 0.f};

  auto seen = [&](int r, int c) {
    const int col = kv_off + c;
    return c < kv_valid && col >= rs.seg[r].start && col < rs.seg[r].end &&
           (!causal || col <= q_off + row0 + r * 8);
  };
  auto full = [&](int c0) {
    return c0 + BK <= kv_valid && rs.wlo <= kv_off + c0 &&
           rs.whi >= kv_off + c0 + BK &&
           (!causal || kv_off + c0 + BK - 1 <= q_off + q0 + warp * 16);
  };
  walk_tiles<D, true>(qa, o, m_run, l_run, smem, kbase, vbase, kv_stride, Tk,
                      t0, t1, scale, seen, full, [](int) { return true; });

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = row_denominator(l_run[r]);
    const int row = row0 + r * 8;
    if (row < T) {
      store_row<D>(out + (static_cast<size_t>(b) * T + row) * q_stride +
                       static_cast<size_t>(h) * D,
                   o, r, l, t4);
      if (lse != nullptr && t4 == 0)
        lse[(static_cast<size_t>(b) * T + row) * H + h] = m_run[r] + logf(l);
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
  fa_fwd_kernel<D><<<grid, NTHREADS, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), Sq, Skv, H, Hkv, q_offset, kv_offset, kv_valid,
      causal, q_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_varlen(const void* q, const void* k, const void* v,
                  const void* qmeta, const void* offs, void* out, void* lse,
                  int B, int T, int Tk, int H, int Hkv, int meta_rows,
                  int causal, float scale, cudaStream_t st) {
  constexpr int bytes = smem_bytes<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      fa_varlen_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  fa_varlen_kernel<D><<<grid, NTHREADS, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(qmeta),
      static_cast<const int*>(offs), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), T, Tk, H, Hkv, meta_rows, causal, scale);
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

// The varlen arm. q (B, T, H, D), k/v (B, Tk, Hkv, D), out like q: bf16,
// contiguous, 16-byte aligned; qmeta (B, meta_rows, 128) int32 with
// meta_rows >= T; offs (B, 3) int32 (q_offset, kv_offset, kv_valid <= Tk);
// lse f32 (B, T, H) or null; scale multiplies the f32 scores.
extern "C" int tdt_flash_attention_varlen_fwd(
    const void* q, const void* k, const void* v, const void* qmeta,
    const void* offs, void* out, void* lse, int B, int T, int Tk, int H,
    int Hkv, int D, int meta_rows, int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || T < 1 || Tk < 1 || H % Hkv || meta_rows < T)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D == 128)
    return launch_varlen<128>(q, k, v, qmeta, offs, out, lse, B, T, Tk, H, Hkv,
                              meta_rows, causal, scale, st);
  if (D == 64)
    return launch_varlen<64>(q, k, v, qmeta, offs, out, lse, B, T, Tk, H, Hkv,
                             meta_rows, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
