// Ragged all-to-all of the expert-parallel dispatch and combine, over n
// ranks, for rows of any dtype.
//
// Replaces: triton_distributed_tpu/ops/ep_a2a.py::_ragged_a2a_kernel
// (:137), launched by _ragged_a2a (:212).
//
// Contract (_ragged_a2a's): rank s holds a send buffer x_s (n, C, W)
// whose slab d holds the rows bound for rank d, and send_cnt_s (n,). Rank
// d's output (its landing region) is (n, C, W), slab s the rows from
// rank s: rows [0, send_cnt_s[d]) of x_s[d]. Rows past a source's count
// are undefined (they hold whatever an earlier call left). W is the row's
// width in bytes: the kernel copies bytes, so bf16, f32 and the packed
// int8 / fp8 wire rows (payload and a trailing f32 scale field) share one
// code path. Rank-stacked operands: x_s = x + s * n * C * W, send_cnt_s =
// send_cnt + s * n; the landing regions come from the workspace.
//
// The protocol, per rank r, as the TPU kernel's: barrier_all at entry
// (no rank stores into a peer's region before every rank has arrived, so
// a region a peer still reads from the call before is never overwritten
// on a box where the ranks are not ordered by one stream); then its rows
// for every destination, itself included (ring order r + 1, r + 2, ...),
// `chunk` rows a work item, only the chunks its count needs; then a wait
// for one notification from every source. The TPU kernel waits for
// exactly as many chunk DMAs as the count says. Here the number of chunks
// a pair moves changes from call to call, and the signals are counters
// compared against the call's epoch (tdt_shmem.cuh), so every (source,
// destination) pair notifies exactly once a call, even at count 0: the
// CTA that finishes the pair's last chunk does it. It learns that it is
// the last from a tally in the source's pad (slot 1 + n + d), an
// acquire-release atomic that every chunk CTA bumps after its stores and
// that the last one resets to 0. Rank d's pad slot 1 + s counts the
// notifications of source s; the receiver waits, bounded, until it reaches
// the epoch, and a lost notification sets the fault word naming d and
// the slot.
//
// One launch runs every rank's body on a persistent cooperative grid
// (tdt_tp.cuh's argument against deadlock): the items in one global order
// are the n barrier arrivals, then the n * n * (C / chunk) chunk items
// (source, destination, chunk), then the n receive waits. The grid is
// sized by C / chunk, not by the counts, which the host never reads:
// chunk items past their pair's count exit at once.
//
// What bounds it on the H100: bytes. At the ep-engine cell (Qwen3-30B-
// A3B, n = 4, C 4096, 2048-wide bf16 rows) a call moves ~16 000 real rows
// a direction, ~62 MiB read and ~62 MiB written, where the padded buffer
// is 256 MiB. The design: every chunk of 128 rows (512 KiB) is one CTA of
// 256 threads moving 16-byte vectors (tdt_cta_copy: four loads in flight
// a thread before their stores, read through L2, since the send buffer
// was written by the kernel before). TMA bulk copies (cp.async.bulk) and
// the send-side row gather fused into the copy are later work.

#include "tdt_shmem.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_RANKS = 8;

struct Params {
  const unsigned char* x;  // (n, n, C, row_bytes)
  const int* send_cnt;     // (n, n)
  TdtPeers peers;
  int C, row_bytes, chunk;
};

__device__ __forceinline__ unsigned atom_add_acq_rel_sys(unsigned* p,
                                                         unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.sys.global.add.u32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

__global__ void __launch_bounds__(NTHREADS) ep_a2a_kernel(Params p) {
  if (tdt_faulted(p.peers)) return;
  const int n = p.peers.n;
  const int per_pair = p.C / p.chunk;
  const long long n_push = static_cast<long long>(n) * n * per_pair;
  const long long total = n + n_push + n;
  const unsigned epoch = p.peers.epoch;
  const size_t rb = static_cast<size_t>(p.row_bytes);

  for (long long it = blockIdx.x; it < total; it += gridDim.x) {
    if (it < n) {  // barrier_all: rank `it` arrives
      if (threadIdx.x == 0) tdt_barrier_arrive(p.peers);
      continue;
    }
    if (it < n + n_push) {  // chunk c of pair (src -> dst)
      const long long j = it - n;
      const int src = static_cast<int>(j / (static_cast<long long>(n) *
                                            per_pair));
      const int dst = (src + 1 + static_cast<int>((j / per_pair) % n)) % n;
      const int c = static_cast<int>(j % per_pair);
      const int cnt = min(max(__ldg(p.send_cnt + src * n + dst), 0), p.C);
      const int parts = max((cnt + p.chunk - 1) / p.chunk, 1);
      if (c >= parts) continue;
      if (!tdt_cta_wait(p.peers, src, TDT_PAD_BARRIER, 0, 1, epoch * n))
        return;
      const int r0 = c * p.chunk;
      const int rows = min(p.chunk, cnt - r0);  // <= 0 only at count 0
      if (rows > 0)
        tdt_cta_copy(p.peers.region<unsigned char>(dst) +
                         (static_cast<size_t>(src) * p.C + r0) * rb,
                     p.x + ((static_cast<size_t>(src) * n + dst) * p.C + r0) *
                               rb,
                     static_cast<size_t>(rows) * rb);
      tdt_cta_release();
      if (threadIdx.x == 0) {
        unsigned* tally = p.peers.pad(src) + 1 + n + dst;
        if (atom_add_acq_rel_sys(tally, 1u) ==
            static_cast<unsigned>(parts - 1)) {
          *tally = 0u;  // no other CTA of this call touches it again
          tdt_signal(p.peers, dst, 1 + src);
        }
      }
      continue;
    }
    // receive: one notification from every source, bounded
    const int me = static_cast<int>(it - n - n_push);
    if (!tdt_cta_wait(p.peers, me, 1, 1, n, epoch)) return;
  }
}

int resident_ctas(long long* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ep_a2a_kernel,
                                                      NTHREADS, 0);
  *out = static_cast<long long>(per_sm) * sms;
  return static_cast<int>(e);
}

}  // namespace

// x (n, n, C, row_bytes) and send_cnt (n, n) int32, rank-stacked; land /
// pads: device arrays of n addresses (landing regions of (n, C,
// row_bytes), u32 pads of 1 + 2n slots); fault: 4 int32. grid 0 sizes the
// persistent grid by occupancy; a grid that could not be co-resident is
// refused.
extern "C" int tdt_ep_a2a(const void* x, const void* send_cnt,
                          const void* land, const void* pads, void* fault,
                          unsigned epoch, long long budget_ns, int n, int C,
                          int row_bytes, int chunk, int grid, void* stream) {
  if (n < 1 || n > MAX_RANKS || C < 1 || chunk < 1 || C % chunk ||
      row_bytes < 16 || row_bytes % 16 || grid < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  long long resident = 0;
  int e = resident_ctas(&resident);
  if (e != 0) return e;
  const long long items =
      2LL * n + static_cast<long long>(n) * n * (C / chunk);
  long long g = grid > 0 ? grid : (items < resident ? items : resident);
  if (resident == 0 || g > resident)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  Params p{static_cast<const unsigned char*>(x),
           static_cast<const int*>(send_cnt),
           TdtPeers{static_cast<const unsigned long long*>(land),
                    static_cast<const unsigned long long*>(pads),
                    static_cast<int*>(fault), epoch, budget_ns, n},
           C, row_bytes, chunk};
  void* argv[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(ep_a2a_kernel),
      dim3(static_cast<unsigned>(g)), dim3(NTHREADS), argv, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many CTAs of the kernel can be resident on the current device.
extern "C" int tdt_ep_a2a_resident() {
  long long r = 0;
  return resident_ctas(&r) == 0 ? static_cast<int>(r) : -1;
}
