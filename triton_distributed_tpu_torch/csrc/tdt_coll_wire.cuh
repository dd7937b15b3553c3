// Shared pieces of the collectives' quantized-wire arms (reduce_scatter.cu
// arms 2 and 3, all_reduce.cu arm 2): the warp codec of one scaling block,
// the landing layout and the parameters.
//
// A rank's unit (its buffer, or one chunk of its partials) is `unit`
// elements of rows x cols, cols a multiple of the scaling block `sblk`, so
// scaling block i is the contiguous run [i sblk, (i + 1) sblk) and the unit
// holds nsb = unit / sblk of them. A work item is `gblk` consecutive
// scaling blocks (the last item ragged) and one signal guards it: no byte
// of a block is encoded before its absmax is known, so an item never
// splits a block. Within an item each warp takes one scaling block at a
// time: its lanes read the block's values (4 at a time when sblk % 4 == 0
// and the operands allow it, else 1), reduce the absmax with shuffles, and
// encode the block with tdt_wire.cuh's codec and IEEE division, so the
// bytes and scales equal the torch codec (ops/wire.py `quant_blockwise`)
// bit for bit.
//
// A landing region (shmem.coll_wire_workspace) holds `slots` slots of
// `unit` bytes (one byte an element), then from the next 16-byte boundary
// the slots' scales, (slots, nsb) f32.
//
// A receiver dequantizes as q * scale (__fmul_rn) and adds in f32 with
// __fadd_rn (no contraction), rounding once to the output dtype.
#pragma once

#include "tdt_coll.cuh"
#include "tdt_wire.cuh"

namespace tdt_coll {

constexpr int NWARPS = NTHREADS / 32;

struct QParams {
  const void* x;  // the ranks' inputs, T
  void* out;      // the ranks' outputs, T
  TdtPeers peers;
  long long unit;  // elements a slot holds (a chunk, or the buffer)
  long long gblk;  // scaling blocks a work item
  int sblk;        // scaling block, elements
  int slots;       // slots of a landing region

  __device__ __forceinline__ long long nsb() const { return unit / sblk; }
  __device__ __forceinline__ long long nitem() const {
    return (nsb() + gblk - 1) / gblk;
  }
  __device__ __forceinline__ uint8_t* q(int rank, int slot) const {
    return peers.region<uint8_t>(rank) + slot * unit;
  }
  __device__ __forceinline__ float* s(int rank, int slot) const {
    const long long soff = (slots * unit + 15) / 16 * 16;
    return reinterpret_cast<float*>(peers.region<uint8_t>(rank) + soff) +
           slot * nsb();
  }
};

// V consecutive values at p (V = 4: 4 V-aligned elements) as f32.
template <int V>
__device__ __forceinline__ void load_vals(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 f = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
    v[0] = __ldcg(p);
  }
}
template <int V>
__device__ __forceinline__ void load_vals(const __nv_bfloat16* p, float* v) {
  if constexpr (V == 4) {
    const uint2 u = __ldcg(reinterpret_cast<const uint2*>(p));
    v[0] = __uint_as_float(u.x << 16);
    v[1] = __uint_as_float(u.x & 0xFFFF0000u);
    v[2] = __uint_as_float(u.y << 16);
    v[3] = __uint_as_float(u.y & 0xFFFF0000u);
  } else {
    v[0] = Elem<__nv_bfloat16>::load(p);
  }
}

// V values rounded to T and stored at p.
template <int V, typename T>
__device__ __forceinline__ void store_vals(T* p, const float* v) {
  if constexpr (V == 4)
    tdt_wire::store4(p, v);
  else
    Elem<T>::store(p, v[0]);
}

// V wire bytes at p, packed little-endian into a word.
template <int V>
__device__ __forceinline__ uint32_t load_bytes(const uint8_t* p) {
  if constexpr (V == 4)
    return __ldcg(reinterpret_cast<const unsigned*>(p));
  else
    return __ldcg(p);
}
template <int V>
__device__ __forceinline__ void store_bytes(uint8_t* p, uint32_t w) {
  if constexpr (V == 4)
    *reinterpret_cast<uint32_t*>(p) = w;
  else
    *p = static_cast<uint8_t>(w);
}

// The values a block is quantized from: x's, plus, when q is set, the
// landed bytes dequantized with `scale` (x + q * scale, in f32): a ring
// hop's running sum.
template <typename T, int W, int V>
struct Src {
  const T* x;
  const uint8_t* q;
  float scale;
  __device__ __forceinline__ void get(long long e, float* v) const {
    load_vals<V>(x + e, v);
    if (q != nullptr) {
      const uint32_t w = load_bytes<V>(q + e);
#pragma unroll
      for (int j = 0; j < V; ++j)
        v[j] = __fadd_rn(v[j], __fmul_rn(tdt_wire::Codec<W>::decode(
                                             w >> (8 * j)),
                                         scale));
    }
  }
};

// One warp: quantize the `len`-element block `src` and store its bytes to
// q[0..nd) and its scale to *s[0..nd). A lane keeps its first CACHE groups
// of V values in registers between the absmax and the encode and
// recomputes the rest: the ring's values (x plus a dequantized landing) are
// worth keeping (4 groups: a block of up to 512 values at V = 4, about 100
// registers); the pushes' plain reads of x are not (0: 64 registers, more
// CTAs an SM).
template <int W, int V, int CACHE, typename S>
__device__ void quant_block(const S& src, int len, uint8_t* const* q,
                            float* const* s, int nd) {
  using C = tdt_wire::Codec<W>;
  const int lane = threadIdx.x & 31;
  float v[CACHE > 0 ? CACHE : 1][V];
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < CACHE; ++k) {
    const int e = (lane + 32 * k) * V;
    if (e < len) {
      src.get(e, v[k]);
#pragma unroll
      for (int j = 0; j < V; ++j) amax = fmaxf(amax, fabsf(v[k][j]));
    }
  }
  for (int e = (lane + 32 * CACHE) * V; e < len; e += 32 * V) {
    float t[V];
    src.get(e, t);
#pragma unroll
    for (int j = 0; j < V; ++j) amax = fmaxf(amax, fabsf(t[j]));
  }
  amax = tdt_warp_max(amax);
  const float scale = __fdiv_rn(fmaxf(amax, 1e-30f), C::qmax);
  if (lane == 0)
    for (int d = 0; d < nd; ++d) *s[d] = scale;
  auto encode = [&](int e, const float* t) {
    uint32_t w = 0;
#pragma unroll
    for (int j = 0; j < V; ++j)
      w |= C::encode(__fdiv_rn(t[j], scale)) << (8 * j);
    for (int d = 0; d < nd; ++d) store_bytes<V>(q[d] + e, w);
  };
#pragma unroll
  for (int k = 0; k < CACHE; ++k) {
    const int e = (lane + 32 * k) * V;
    if (e < len) encode(e, v[k]);
  }
  for (int e = (lane + 32 * CACHE) * V; e < len; e += 32 * V) {
    float t[V];
    src.get(e, t);
    encode(e, t);
  }
}

// One warp: out[e] = the ns sources' blocks (bytes q[s], scale *sc[s])
// dequantized and added in order in f32, rounded once to T.
template <int W, int V, typename T>
__device__ void dequant_sum_block(T* out, const uint8_t* const* q,
                                  const float* const* sc, int ns, int len) {
  using C = tdt_wire::Codec<W>;
  const int lane = threadIdx.x & 31;
  float scale[MAX_RANKS];
  for (int s = 0; s < ns; ++s) scale[s] = __ldcg(sc[s]);
  for (int e = lane * V; e < len; e += 32 * V) {
    float acc[V];
    for (int s = 0; s < ns; ++s) {
      const uint32_t w = load_bytes<V>(q[s] + e);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float v = __fmul_rn(C::decode(w >> (8 * j)), scale[s]);
        acc[j] = s == 0 ? v : __fadd_rn(acc[j], v);
      }
    }
    store_vals<V>(out + e, acc);
  }
}

// One warp: out[e] = round(src's values), a ring's last hop.
template <int V, typename T, typename S>
__device__ void store_block(T* out, const S& src, int len) {
  const int lane = threadIdx.x & 31;
  for (int e = lane * V; e < len; e += 32 * V) {
    float v[V];
    src.get(e, v);
    store_vals<V>(out + e, v);
  }
}

// The 4-wide path: whole groups of 4 in a block, every base V-aligned
// (the landing regions are: their slots and blocks start at multiples of
// sblk).
template <typename T>
__device__ __forceinline__ bool vec_ok(const QParams& p) {
  constexpr uintptr_t a = 4 * sizeof(T) - 1;
  return p.sblk % 4 == 0 && (reinterpret_cast<uintptr_t>(p.x) & a) == 0 &&
         (reinterpret_cast<uintptr_t>(p.out) & a) == 0;
}

// The scaling blocks [first, last) of work item g.
struct Items {
  long long first, last;
};
__device__ __forceinline__ Items item_blocks(const QParams& p, long long g) {
  const long long f = g * p.gblk, l = f + p.gblk;
  return Items{f, l < p.nsb() ? l : p.nsb()};
}

}  // namespace tdt_coll
