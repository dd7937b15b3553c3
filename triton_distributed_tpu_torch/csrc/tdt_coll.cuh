// Shared pieces of the collective kernels (all_gather.cu, reduce_scatter.cu,
// all_reduce.cu): the block movers, the element rule of their sums and the
// cooperative launch.
//
// A collective moves flat units (a rank's shard, a rank's buffer, or one
// chunk of it) cut into blocks of `blk` elements (bytes for the gather),
// the last one ragged; a work item moves one block, and a signal guards one
// block of one source (fullmesh) or one hop (ring). A block is copied or
// summed in 16-byte vectors when every address it touches is 16-byte
// aligned (the host cuts blocks at multiples of 32 bytes, so that rests on
// the units' bases), else element by element: any width works.
//
// Sums: every source converted to f32, added in the order given with no
// contraction, rounded once to the dtype (bf16 round to nearest even). So
// a one-shot / fullmesh sum of the n ranks in rank order is the port's
// `sum_in_rank_order`, and one ring hop's `acc = chunk + landed` rounds
// its message to the dtype, as the plain versions do.
//
// Reads go through L2 (ld.global.cg): a block another CTA landed earlier in
// the launch is read only after the acquire of its signal and a
// __syncthreads (tdt_shmem.cuh).
#pragma once

#include "tdt_shmem.cuh"

namespace tdt_coll {

constexpr int NTHREADS = 256;
constexpr int MAX_RANKS = 8;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int VEC = 4;  // values in 16 bytes
  static __device__ __forceinline__ float load(const float* p) {
    return __ldcg(p);
  }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int VEC = 8;
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    const unsigned short b = __ldcg(reinterpret_cast<const unsigned short*>(p));
    return __uint_as_float(static_cast<unsigned>(b) << 16);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(tdt_pack_bf16(f[0], f[1]), tdt_pack_bf16(f[2], f[3]),
                      tdt_pack_bf16(f[4], f[5]), tdt_pack_bf16(f[6], f[7]));
  }
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Every thread of the CTA: dst[0..nd) = round(sum over src[0..ns) in
// order, in f32), `len` elements.
template <typename T>
__device__ void reduce_store(T* const* dst, int nd, const T* const* src,
                             int ns, size_t len) {
  using E = Elem<T>;
  bool vec = true;
  for (int d = 0; d < nd; ++d) vec = vec && aligned16(dst[d]);
  for (int s = 0; s < ns; ++s) vec = vec && aligned16(src[s]);
  size_t i0 = 0;
  if (vec) {
    const size_t nv = len / E::VEC;
    for (size_t v = threadIdx.x; v < nv; v += blockDim.x) {
      float acc[E::VEC], t[E::VEC];
      E::unpack(__ldcg(reinterpret_cast<const uint4*>(src[0]) + v), acc);
      for (int s = 1; s < ns; ++s) {
        E::unpack(__ldcg(reinterpret_cast<const uint4*>(src[s]) + v), t);
#pragma unroll
        for (int j = 0; j < E::VEC; ++j) acc[j] = __fadd_rn(acc[j], t[j]);
      }
      const uint4 out = E::pack(acc);
      for (int d = 0; d < nd; ++d) reinterpret_cast<uint4*>(dst[d])[v] = out;
    }
    i0 = nv * E::VEC;
  }
  for (size_t i = i0 + threadIdx.x; i < len; i += blockDim.x) {
    float acc = E::load(src[0] + i);
    for (int s = 1; s < ns; ++s) acc = __fadd_rn(acc, E::load(src[s] + i));
    for (int d = 0; d < nd; ++d) E::store(dst[d] + i, acc);
  }
}

template <typename V>
__device__ __forceinline__ void copy_units(unsigned char* const* dst, int nd,
                                           const unsigned char* src,
                                           size_t bytes) {
  const V* s = reinterpret_cast<const V*>(src);
  const size_t nu = bytes / sizeof(V);
  for (size_t i = threadIdx.x; i < nu; i += blockDim.x) {
    const V v = __ldcg(s + i);
    for (int d = 0; d < nd; ++d) reinterpret_cast<V*>(dst[d])[i] = v;
  }
}

// Every thread of the CTA: `bytes` bytes of src into dst[0..nd), in the
// widest unit (16, 8, 4, 2 or 1 bytes) that every address and the length
// allow.
__device__ __forceinline__ void copy_bytes(unsigned char* const* dst, int nd,
                                           const unsigned char* src,
                                           size_t bytes) {
  uintptr_t a = reinterpret_cast<uintptr_t>(src) | bytes;
  for (int d = 0; d < nd; ++d) a |= reinterpret_cast<uintptr_t>(dst[d]);
  if ((a & 15) == 0)
    copy_units<uint4>(dst, nd, src, bytes);
  else if ((a & 7) == 0)
    copy_units<uint2>(dst, nd, src, bytes);
  else if ((a & 3) == 0)
    copy_units<unsigned>(dst, nd, src, bytes);
  else if ((a & 1) == 0)
    copy_units<unsigned short>(dst, nd, src, bytes);
  else
    copy_units<unsigned char>(dst, nd, src, bytes);
}

// Block b of a unit of `len` elements cut into blocks of `blk`: its offset
// and length.
struct Block {
  size_t off, len;
};
__device__ __forceinline__ Block block_of(long long b, long long blk,
                                          long long len) {
  const long long off = b * blk;
  return Block{static_cast<size_t>(off),
               static_cast<size_t>(len - off < blk ? len - off : blk)};
}

// The persistent launch of tdt_tp.cuh: `items` work items in one global
// order on a cooperative grid of min(items, co-resident CTAs) blocks (or
// `grid`, refused past co-residency).
template <typename P>
int coop_launch(void (*kernel)(P), const P& params, long long items, int grid,
                cudaStream_t st) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      NTHREADS, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long resident = static_cast<long long>(per_sm) * sms;
  const long long g = grid > 0 ? grid : (items < resident ? items : resident);
  if (resident == 0 || g > resident)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  P q = params;
  void* argv[] = {&q};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                  dim3(static_cast<unsigned>(g)),
                                  dim3(NTHREADS), argv, 0, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Co-resident CTAs of `kernel` on the current device, or -1.
template <typename P>
int resident(void (*kernel)(P)) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    NTHREADS, 0) !=
          cudaSuccess)
    return -1;
  return per_sm * sms;
}

// Thread 0 of every CTA waits on source signals 1 + s * nblk + b of rank
// `me`'s pad for every s != me (the fullmesh / one-shot layout).
__device__ __forceinline__ bool wait_sources(const TdtPeers& p, int me,
                                             long long nblk, long long b,
                                             unsigned target) {
  const int n = p.n;
  return tdt_cta_wait(p, me, static_cast<int>(1 + b), static_cast<int>(nblk),
                      me, target) &&
         tdt_cta_wait(p, me, static_cast<int>(1 + (me + 1) * nblk + b),
                      static_cast<int>(nblk), n - 1 - me, target);
}

}  // namespace tdt_coll
