// Device side of the port's one-sided transport (counterpart of
// triton_distributed_tpu/shmem/primitives.py; the host side is
// triton_distributed_tpu_torch/shmem/primitives.py).
//
// A rank r owns, in the symmetric heap, a landing region and a signal pad
// (u32 counters). Every kernel gets the n peers' landing bases and pad
// bases as device arrays of addresses, so a store to a peer's region is a
// plain store through its pointer: on one card the regions lie in the
// card's memory, on a multi-GPU box they would be peer-mapped memory.
//
// | JAX primitive (shmem/primitives.py)      | here                        |
// |------------------------------------------|-----------------------------|
// | rank :332, num_ranks :339                | kernel arguments            |
// | notify :382                              | tdt_cta_release, then       |
// |                                          | tdt_signal (red.release.sys)|
// | wait :402                                | tdt_cta_wait (ld.acquire.sys|
// |                                          | spin against a target)      |
// | wait_bounded :125, set_fault_flag :98    | the spin's %globaltimer     |
// |                                          | budget and the fault word   |
// | remote_put :451, remote_put_start :474   | tdt_cta_copy into the peer's|
// |                                          | region, then a notify       |
// | local_copy :481                          | tdt_cta_copy into the own   |
// | barrier_all :501                         | tdt_barrier_arrive on every |
// |                                          | pad, tdt_cta_wait on its own|
//
// Signals are counters that are never cleared: call e of a workspace (an
// epoch, passed by the host) waits until a counter reaches e times the
// notifications one call makes to it, compared by signed difference in
// u32 arithmetic. So nothing is memset between calls. After a fault the
// host zeroes the pads and restarts the epochs.
//
// Memory ordering. A producer CTA's threads store their data; then
// __syncthreads(); then thread 0 issues a system-scope fence and a
// red.release.sys on the consumer's counter. The consumer's thread 0 spins
// with ld.acquire.sys, then __syncthreads(), and only then do its threads
// read the data, through L2 (cp.async.cg / ld.global.cg), never through
// the non-coherent path. System scope is what NVLink peers need; on one
// card it costs more than .gpu would, which the timings carry.
//
// Bounded waits. A spin longer than the budget (about a second of
// %globaltimer) CASes the fault word from 0 to TDT_FAULT_TIMEOUT and
// records the waiting rank, the signal index and the value it saw; the
// CTA then abandons its work. Every spin also polls the fault word, so the
// other CTAs leave as soon as one has faulted, and a launch that finds the
// word set returns at once. The host reads the word and raises naming the
// rank and the signal.
#pragma once

#include "tdt_common.cuh"

constexpr int TDT_FAULT_TIMEOUT = 1;
constexpr int TDT_PAD_BARRIER = 0;  // pad slot 0: barrier_all's counter

__device__ __forceinline__ unsigned tdt_ld_acquire_sys(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void tdt_red_release_sys(unsigned* p,
                                                    unsigned v) {
  asm volatile("red.release.sys.global.add.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ int tdt_ld_volatile(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

__device__ __forceinline__ unsigned long long tdt_globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The peers of one launch: n landing bases and n pad bases (addresses),
// the fault word, the epoch and the wait budget.
struct TdtPeers {
  const unsigned long long* land;  // (n,) landing region of each rank
  const unsigned long long* pads;  // (n,) u32 signal pad of each rank
  int* fault;                      // [code, rank, signal, value seen]
  unsigned epoch;
  long long budget_ns;
  int n;

  __device__ __forceinline__ unsigned* pad(int rank) const {
    return reinterpret_cast<unsigned*>(__ldg(pads + rank));
  }
  template <typename T>
  __device__ __forceinline__ T* region(int rank) const {
    return reinterpret_cast<T*>(__ldg(land + rank));
  }
};

// Thread 0 only: spin until pad(rank)[sig] reaches `target`, bounded.
// Returns false (after recording a fault, or on finding one) when the CTA
// must stop.
__device__ __noinline__ bool tdt_wait_bounded(const TdtPeers& p, int rank,
                                              int sig, unsigned target) {
  const unsigned* addr = p.pad(rank) + sig;
  unsigned long long t0 = 0;
  while (true) {
    const unsigned v = tdt_ld_acquire_sys(addr);
    if (static_cast<int>(v - target) >= 0) return true;
    if (tdt_ld_volatile(p.fault) != 0) return false;
    const unsigned long long now = tdt_globaltimer();
    if (t0 == 0) {
      t0 = now;
    } else if (now - t0 > static_cast<unsigned long long>(p.budget_ns)) {
      if (atomicCAS(p.fault, 0, TDT_FAULT_TIMEOUT) == 0) {
        p.fault[1] = rank;
        p.fault[2] = sig;
        p.fault[3] = static_cast<int>(v);
        __threadfence_system();
      }
      return false;
    }
    __nanosleep(64);
  }
}

// Every thread of the CTA: thread 0 waits on each of `count` signals
// pad(rank)[sig0 + i * stride] for `target`; the others learn the outcome.
// After a true return every thread may read what those signals guard.
__device__ __forceinline__ bool tdt_cta_wait(const TdtPeers& p, int rank,
                                             int sig0, int stride, int count,
                                             unsigned target) {
  __shared__ int s_ok;
  if (threadIdx.x == 0) {
    int ok = 1;
    for (int i = 0; i < count && ok; ++i)
      ok = tdt_wait_bounded(p, rank, sig0 + i * stride, target);
    s_ok = ok;
  }
  __syncthreads();
  const bool ok = s_ok != 0;
  __syncthreads();  // s_ok is rewritten by the next wait
  return ok;
}

// Every thread of the CTA, after its stores: make them visible at system
// scope before thread 0 signals (tdt_signal, thread 0 only).
__device__ __forceinline__ void tdt_cta_release() {
  __syncthreads();
  if (threadIdx.x == 0) __threadfence_system();
}

__device__ __forceinline__ void tdt_signal(const TdtPeers& p, int rank,
                                           int sig) {
  tdt_red_release_sys(p.pad(rank) + sig, 1u);
}

// barrier_all, arrive half (thread 0): one notification on every rank's
// barrier counter. The wait half is tdt_cta_wait(p, me, TDT_PAD_BARRIER,
// 0, 1, epoch * n) before the first store into a peer's region.
__device__ __forceinline__ void tdt_barrier_arrive(const TdtPeers& p) {
  __threadfence_system();
  for (int r = 0; r < p.n; ++r) tdt_signal(p, r, TDT_PAD_BARRIER);
}

// remote_put / local_copy body: the CTA copies `bytes` (a multiple of 16,
// both ends 16-byte aligned) from src to dst in 16-byte vectors read
// through L2, four loads in flight a thread before their stores.
__device__ __forceinline__ void tdt_cta_copy(void* dst, const void* src,
                                             size_t bytes) {
  constexpr int kUnroll = 4;
  const uint4* s = static_cast<const uint4*>(src);
  uint4* d = static_cast<uint4*>(dst);
  const size_t n16 = bytes / 16, step = blockDim.x;
  size_t i = threadIdx.x;
  for (; i + (kUnroll - 1) * step < n16; i += kUnroll * step) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldcg(s + i + u * step);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) d[i + u * step] = v[u];
  }
  for (; i < n16; i += step) d[i] = __ldcg(s + i);
}

// A launch that finds the fault word set does nothing (every thread).
__device__ __forceinline__ bool tdt_faulted(const TdtPeers& p) {
  __shared__ int s_f;
  if (threadIdx.x == 0) s_f = tdt_ld_volatile(p.fault);
  __syncthreads();
  return s_f != 0;
}
