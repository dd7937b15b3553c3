// The flash-attention tile shared by csrc/flash_attention.cu (the dense and
// the varlen arm) and csrc/sp_ag_attention.cu.
//
// One CTA of four warps owns 64 q rows (16 a warp) of one head and walks
// 64-column K / V tiles: S = Q K^T on the tensor cores (mma.sync m16n8k16,
// bf16 in, f32 accumulate), an online softmax whose running max, partial
// denominator and output accumulator stay in registers, then O += P V with
// the S accumulator fragment reused as the A operand. K and V tiles stream
// through a 2-stage cp.async ring in shared memory, rows padded by 8
// elements so the ldmatrix loads (plain for K, transposed for V) are free
// of bank conflicts; the loads go through L2 (cp.async.cg), so a tile that
// another CTA landed in the same launch is read after its acquire.
//
// Fragment coordinates: lane L of a warp holds rows g = L / 4 and g + 8 of
// the warp's 16 (its "row 0" and "row 1"), and columns 2 (L % 4) + {0, 1}
// of every 8-column n-tile.
//
// Masking: a score the row must not see becomes -1e30 and its p is set to
// 0 explicitly, so a row that sees no column of a tile keeps its state bit
// for bit, and a row that sees no column at all comes out 0 with lse ~
// -1e30 (JAX ops/attention.py:345, sp_ag_attention.py:158-164).
#pragma once

#include "tdt_mma.cuh"

namespace tdt_flash {

constexpr int BQ = 64;      // q rows per CTA: 16 per warp
constexpr int BK = 64;      // kv columns per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int STAGES = 2;   // cp.async ring depth

template <int D>
constexpr int smem_bytes() {
  return STAGES * 2 * BK * (D + 8) * 2;
}

// Loads K / V tile `tile` (rows tile * BK ..) into ring stage `stage`; K
// and V row t lie at kbase / vbase + t * kv_stride, rows >= `rows` are
// zero-filled without a read.
template <int D>
__device__ __forceinline__ void load_kv_tile(__nv_bfloat16* smem, int stage,
                                             const __nv_bfloat16* kbase,
                                             const __nv_bfloat16* vbase,
                                             size_t kv_stride, int tile,
                                             int rows) {
  constexpr int LD = D + 8;
  constexpr int VECS = D / 8;      // 16-byte vectors per K/V row
  constexpr int TILE = BK * LD;
  __nv_bfloat16* ks = smem + 2 * stage * TILE;
  __nv_bfloat16* vs = ks + TILE;
  for (int i = threadIdx.x; i < BK * VECS; i += NTHREADS) {
    const int r = i / VECS, c = (i % VECS) * 8;
    const int t = tile * BK + r;
    const bool ok = t < rows;
    const size_t off = static_cast<size_t>(ok ? t : 0) * kv_stride + c;
    cp_async16(&ks[r * LD + c], kbase + off, ok);
    cp_async16(&vs[r * LD + c], vbase + off, ok);
  }
  cp_async_commit();
}

// Q fragments (A operand, row-major 16x16 per k-step) of this thread's two
// rows, each element multiplied by q_scale in f32 and rounded to bf16 (1.0
// leaves them as they are); a null row gives zeros.
template <int D>
__device__ __forceinline__ void load_q(uint32_t (&qa)[D / 16][4],
                                       const __nv_bfloat16* row_lo,
                                       const __nv_bfloat16* row_hi, int t4,
                                       float q_scale) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat16* row = (i & 1) ? row_hi : row_lo;
      const int c = kk * 16 + (i >> 1) * 8 + t4 * 2;
      uint32_t val = 0;
      if (row != nullptr) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(row + c));
        val = tdt_pack_bf16(f.x * q_scale, f.y * q_scale);
      }
      qa[kk][i] = val;
    }
  }
}

// S = Q K^T: 16 rows x BK columns for this warp, f32 accumulators. One
// ldmatrix.x4 gives the B fragments of k-steps kk and kk+1.
template <int D>
__device__ __forceinline__ void qk_tile(float (&s)[BK / 8][4],
                                        uint32_t (&qa)[D / 16][4],
                                        const __nv_bfloat16* ks, int lane) {
  constexpr int LD = D + 8;
  const int lm_row = lane & 7, lm_mat = lane >> 3;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; kk += 2) {
      uint32_t bf[4];
      ldsm_x4(bf, &ks[(j * 8 + lm_row) * LD + kk * 16 + lm_mat * 8]);
      mma_16816(s[j], qa[kk], bf);
      mma_16816(s[j], qa[kk + 1], bf + 2);
    }
  }
}

// One kv tile of the online softmax for this thread's two rows: with MASK,
// scores for which seen(r, c) is false (r: the thread's row 0 or 1, c: the
// column in the tile) become -1e30 and give p = 0. Turns s into p in place,
// folds the tile into the running max and this thread's partial
// denominator, and rescales the output accumulator.
template <bool MASK, int NT, typename Seen>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 8][4],
                                             float (&o)[NT][4],
                                             float (&m_run)[2],
                                             float (&l_run)[2], int t4,
                                             Seen seen) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = TDT_NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[j][r * 2 + e];
        if (MASK && !seen(r, j * 8 + t4 * 2 + e)) x = TDT_NEG_INF;
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
        if (MASK && !seen(r, j * 8 + t4 * 2 + e)) x = 0.f;
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

// O += P V: p (the S accumulator, rounded to bf16) is the A fragment of PV.
// One ldmatrix.x4.trans gives the B fragments of n-tiles nt and nt+1.
template <int D>
__device__ __forceinline__ void pv_tile(float (&o)[D / 8][4],
                                        float (&s)[BK / 8][4],
                                        const __nv_bfloat16* vs, int lane) {
  constexpr int LD = D + 8;
  const int lm_row = lane & 7, lm_mat = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t pa[4] = {
        tdt_pack_bf16(s[2 * kk][0], s[2 * kk][1]),
        tdt_pack_bf16(s[2 * kk][2], s[2 * kk][3]),
        tdt_pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
        tdt_pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int nt = 0; nt < D / 8; nt += 2) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, &vs[(kk * 16 + (lm_mat & 1) * 8 + lm_row) * LD +
                            (nt + (lm_mat >> 1)) * 8]);
      mma_16816(o[nt], pa, bf);
      mma_16816(o[nt + 1], pa, bf + 2);
    }
  }
}

// The denominator of one of this thread's rows: its partial sums over the
// quad that shares the row, clamped at 1e-30.
__device__ __forceinline__ float row_denominator(float l) {
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  return fmaxf(l, 1e-30f);
}

// Stores row r of this thread's accumulator divided by l, rounded once to
// bf16, at orow (the row's D values of one head).
template <int D>
__device__ __forceinline__ void store_row(__nv_bfloat16* orow,
                                          float (&o)[D / 8][4], int r,
                                          float l, int t4) {
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
    *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8 + t4 * 2) =
        __floats2bfloat162_rn(o[nt][r * 2] / l, o[nt][r * 2 + 1] / l);
}

// Folds kv tiles [t0, t1) of one K / V source into the running state of
// this thread's two rows: S = Q K^T in f32, multiplied by s_scale when
// SCALE_S (the rounding point of the varlen and fused kernels, JAX
// attention.py:323-325, sp_ag_attention.py:141), the online softmax, then
// O += P V. Row t of the source lies at kbase / vbase + t * kv_stride; rows
// >= `rows` are zero-filled. seen(r, col) says whether this thread's row r
// sees source column col; full(col0) whether every row of this warp sees
// all BK columns from col0 (the tile then skips the mask arithmetic).
// ready(tile) is called by every thread before the tile's loads are queued
// and may wait for the tile to land; false abandons the walk, and the
// function returns false. The ring stage of a tile is tile % STAGES.
template <int D, bool SCALE_S, typename Seen, typename Full, typename Ready>
__device__ __forceinline__ bool walk_tiles(
    uint32_t (&qa)[D / 16][4], float (&o)[D / 8][4], float (&m_run)[2],
    float (&l_run)[2], __nv_bfloat16* smem, const __nv_bfloat16* kbase,
    const __nv_bfloat16* vbase, size_t kv_stride, int rows, int t0, int t1,
    float s_scale, Seen seen, Full full, Ready ready) {
  constexpr int TILE = BK * (D + 8);
  const int lane = threadIdx.x & 31, t4 = lane & 3;
  if (t0 >= t1) return true;
  if (!ready(t0)) return false;
  load_kv_tile<D>(smem, t0 % STAGES, kbase, vbase, kv_stride, t0, rows);
  for (int tile = t0; tile < t1; ++tile) {
    if (tile + 1 < t1) {
      if (!ready(tile + 1)) {
        cp_async_wait<0>();
        return false;
      }
      load_kv_tile<D>(smem, (tile + 1) % STAGES, kbase, vbase, kv_stride,
                      tile + 1, rows);
      cp_async_wait<1>();      // this tile's group has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = smem + 2 * (tile % STAGES) * TILE;
    const __nv_bfloat16* vs = ks + TILE;
    float s[BK / 8][4];
    qk_tile<D>(s, qa, ks, lane);
    if (SCALE_S) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] *= s_scale;
    }
    const int c0 = tile * BK;
    auto seen_tile = [&](int r, int c) { return seen(r, c0 + c); };
    if (full(c0))
      softmax_tile<false>(s, o, m_run, l_run, t4, seen_tile);
    else
      softmax_tile<true>(s, o, m_run, l_run, t4, seen_tile);
    pv_tile<D>(o, s, vs, lane);
    __syncthreads();   // the next loads reuse this stage
  }
  return true;
}

// The segment bounds of a packed varlen batch's row from its 128-lane
// sideband row (lane 0 the global sequence start, lane 1 its end); a row
// past the live rows gets the padding encoding (INT32_MAX, 0): it sees no
// column and is neutral in the culling's min / max (JAX
// attention.py:365-384).
struct Segment {
  int start, end;
};

__device__ __forceinline__ Segment segment_of(const int* meta_row, bool live) {
  if (!live) return {0x7fffffff, 0};
  return {meta_row[0], meta_row[1]};
}

// Warp-wide min and max over 32 lanes.
__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// The segment bounds of this thread's two rows, and their reductions:
// `wlo` / `whi` the latest start / earliest end over the warp's 16 rows
// (a tile is full for the warp only inside both), `lo` / `hi` the earliest
// start / latest end over the CTA's 64 rows (the culling's bounds, JAX
// attention.py:311-316). Every thread of the CTA calls it.
struct RowSegments {
  Segment seg[2];
  int wlo, whi;   // warp: max start, min end
  int lo, hi;     // CTA: min start, max end
};

__device__ __forceinline__ RowSegments row_segments(const int* meta,
                                                    int row0, int rows) {
  __shared__ int s_lo[NWARPS], s_hi[NWARPS];
  RowSegments rs;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    rs.seg[r] = segment_of(meta + static_cast<size_t>(row < rows ? row : 0) * 128,
                           row < rows);
  }
  rs.wlo = warp_max(max(rs.seg[0].start, rs.seg[1].start));
  rs.whi = warp_min(min(rs.seg[0].end, rs.seg[1].end));
  const int lo = warp_min(min(rs.seg[0].start, rs.seg[1].start));
  const int hi = warp_max(max(rs.seg[0].end, rs.seg[1].end));
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  rs.lo = s_lo[0];
  rs.hi = s_hi[0];
#pragma unroll
  for (int w = 1; w < NWARPS; ++w) {
    rs.lo = min(rs.lo, s_lo[w]);
    rs.hi = max(rs.hi, s_hi[w]);
  }
  __syncthreads();   // s_lo / s_hi are rewritten by the next call
  return rs;
}

}  // namespace tdt_flash
