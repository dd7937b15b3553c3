// AllGather over n ranks: the full-mesh push and the ring relay.
//
// Replaces: triton_distributed_tpu/ops/collectives/all_gather.py::
// _fullmesh_kernel (:64) and _ring_kernel (:97), launched by
// all_gather_shard (:122).
//
// Contract (all_gather_shard's): rank r holds a shard x_r of S bytes (rows
// x cols of any dtype: the kernel copies bytes); every rank d gets out_d =
// [x_0 | x_1 | ... | x_{n-1}] (n S bytes), bit for bit. Rank-stacked
// operands: x_r = x + r S, out_d = out + d n S, slot s of out_d at out_d +
// s S. The outputs are the landing regions (the TPU kernel's output is the
// buffer its peers write): the rank-stacked layout is the port's symmetric
// heap (parallel/mesh.py). Each shard is cut into nblk blocks of `blk`
// bytes.
//
// Full mesh, per rank r, as the TPU kernel's: barrier_all at entry; each
// block of x_r copied into slot r of every rank's output, its own included
// (the local copy; ring order r + 1, r + 2, ...), and one notification to
// each of the n - 1 peers at pad slot 1 + r * nblk + b; then rank d waits,
// block by block, on the n - 1 sources. Items in one global order: the n
// barrier arrivals, the n * nblk pushes, the n * nblk receive waits.
//
// Ring, per rank r: barrier_all; hop k = 0 .. n - 2 forwards slot (r - k)
// mod n of its output to rank r + 1's output (hop 0 reads x_r and also
// writes its own slot r), block by block, and notifies r + 1 at pad slot 1
// + k * nblk + b; hop k > 0 of a block first waits for hop k - 1's signal
// of that block, which says the slot has landed in r's output (forwarded
// in place: it is read only after that signal). A receiver's last hop is
// waited by a final item. Items: the arrivals, then the hops in order
// (n * nblk each), then the n * nblk final waits; blocks pipeline through
// the hops.
//
// One launch runs every rank's body on a persistent cooperative grid
// (tdt_tp.cuh's argument against deadlock: every item that waits comes
// after the items that signal it).
//
// What bounds it on the H100: bytes. At the full-width shape (n = 4, a
// 512 x 4096 bf16 shard of 4 MiB) the function reads the n shards once
// and writes n x n slots (80 MiB, ~25 us at 3.35 TB/s); the ring relays
// each slot through its hops and so reads n - 1 slots a rank more. The
// design: 2-64 KiB blocks (32 a shard), one CTA of 256 threads a block,
// 16-byte vectors read through L2 and stored to every destination at
// once; TMA bulk copies are later work.

#include "tdt_coll.cuh"

using namespace tdt_coll;

namespace {

struct Params {
  const unsigned char* x;  // (n, S)
  unsigned char* out;      // (n, n, S)
  TdtPeers peers;
  long long S, blk;        // shard bytes, block bytes
};

__device__ __forceinline__ unsigned char* slot(const Params& p, int d,
                                               int s) {
  return p.out + (static_cast<long long>(d) * p.peers.n + s) * p.S;
}

__global__ void __launch_bounds__(NTHREADS) fullmesh_kernel(Params p) {
  if (tdt_faulted(p.peers)) return;
  const int n = p.peers.n;
  const long long nblk = (p.S + p.blk - 1) / p.blk;
  const long long n_push = n * nblk, total = n + 2 * n_push;
  const unsigned epoch = p.peers.epoch;
  for (long long it = blockIdx.x; it < total; it += gridDim.x) {
    if (it < n) {  // barrier_all: rank `it` arrives
      if (threadIdx.x == 0) tdt_barrier_arrive(p.peers);
      continue;
    }
    const bool push = it < n + n_push;
    const long long j = push ? it - n : it - n - n_push;
    const int me = static_cast<int>(j / nblk);
    const long long b = j % nblk;
    if (!push) {  // rank me's block b: the n - 1 sources have landed
      if (!wait_sources(p.peers, me, nblk, b, epoch)) return;
      continue;
    }
    if (!tdt_cta_wait(p.peers, me, TDT_PAD_BARRIER, 0, 1, epoch * n))
      return;
    const Block k = block_of(b, p.blk, p.S);
    unsigned char* dst[MAX_RANKS];
    for (int i = 0; i < n; ++i) dst[i] = slot(p, (me + 1 + i) % n, me) + k.off;
    copy_bytes(dst, n, p.x + me * p.S + k.off, k.len);
    tdt_cta_release();
    if (threadIdx.x == 0)
      for (int i = 0; i < n - 1; ++i)
        tdt_signal(p.peers, (me + 1 + i) % n,
                   static_cast<int>(1 + me * nblk + b));
  }
}

__global__ void __launch_bounds__(NTHREADS) ring_kernel(Params p) {
  if (tdt_faulted(p.peers)) return;
  const int n = p.peers.n;
  const long long nblk = (p.S + p.blk - 1) / p.blk;
  const long long per_hop = n * nblk;
  const long long total = n + (n - 1) * per_hop + per_hop;
  const unsigned epoch = p.peers.epoch;
  for (long long it = blockIdx.x; it < total; it += gridDim.x) {
    if (it < n) {
      if (threadIdx.x == 0) tdt_barrier_arrive(p.peers);
      continue;
    }
    const long long j = it - n;
    const int k = static_cast<int>(j / per_hop);  // n - 1: the final waits
    const int me = static_cast<int>(j % per_hop / nblk);
    const long long b = j % nblk;
    if (k == n - 1) {  // the last hop's block has landed in my output
      if (!tdt_cta_wait(p.peers, me, static_cast<int>(1 + (n - 2) * nblk + b),
                        0, 1, epoch))
        return;
      continue;
    }
    const int right = (me + 1) % n, s = (me - k + n) % n;
    const Block blk = block_of(b, p.blk, p.S);
    unsigned char* dst[2];
    const unsigned char* src;
    int nd = 1;
    if (k == 0) {
      if (!tdt_cta_wait(p.peers, me, TDT_PAD_BARRIER, 0, 1, epoch * n))
        return;
      src = p.x + me * p.S + blk.off;
      dst[1] = slot(p, me, me) + blk.off;  // the local copy
      nd = 2;
    } else {
      if (!tdt_cta_wait(p.peers, me, static_cast<int>(1 + (k - 1) * nblk + b),
                        0, 1, epoch))
        return;
      src = slot(p, me, s) + blk.off;
    }
    dst[0] = slot(p, right, s) + blk.off;
    copy_bytes(dst, nd, src, blk.len);
    tdt_cta_release();
    if (threadIdx.x == 0)
      tdt_signal(p.peers, right, static_cast<int>(1 + k * nblk + b));
  }
}

}  // namespace

// arm 0 = fullmesh, 1 = ring; dtype must be 2 (bytes: the gather copies
// bytes of any dtype). x (n, S) and out (n, n, S) bytes, rank-stacked;
// land unused (the outputs are the regions); pads: a device array of n
// addresses of u32 pads of 1 + n * nblk (fullmesh) or 1 + (n - 1) * nblk
// (ring) slots, nblk = ceil(S / blk); fault: 4 int32; blk a multiple of
// 16. grid 0 sizes the persistent grid by occupancy; a grid that could not
// be co-resident is refused.
extern "C" int tdt_all_gather(int arm, int dtype, const void* x, void* out,
                              const void* land, const void* pads, void* fault,
                              unsigned epoch, long long budget_ns, int n,
                              long long S, long long blk, int grid,
                              void* stream) {
  (void)land;
  if (arm < 0 || arm > 1 || dtype != 2 || n < 2 || n > MAX_RANKS || S < 1 ||
      blk < 16 || blk % 16 || grid < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const unsigned char*>(x),
                 static_cast<unsigned char*>(out),
                 TdtPeers{nullptr, static_cast<const unsigned long long*>(pads),
                          static_cast<int*>(fault), epoch, budget_ns, n},
                 S, blk};
  const long long nblk = (S + blk - 1) / blk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return arm == 0 ? coop_launch(fullmesh_kernel, p, n + 2 * n * nblk, grid, st)
                  : coop_launch(ring_kernel, p, n + n * n * nblk, grid, st);
}

// How many CTAs of an arm can be resident on the current device.
extern "C" int tdt_all_gather_resident(int arm) {
  return arm == 0 ? resident(fullmesh_kernel) : resident(ring_kernel);
}
