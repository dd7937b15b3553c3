// One-shot low-latency combine of split-KV decode partials over n ranks
// (the sequence-parallel flash-decode combine), and its merge half alone.
//
// Replaces: triton_distributed_tpu/ops/ll_gather.py::_ll_combine_kernel
// (:66), launched by ll_combine_shard (:91), and _merge_packed (:51) as
// its own call, ll_merge_packed (:154) under ll_merge (:205).
//
// Contract (ll_combine_shard's): rank r holds a decode partial out_r
// (rows, D), normalised within its KV range, and its log-sum-exp lse_r
// (rows,) f32; every rank gets the lse-merge of the n partials, rows x D
// in out's dtype. The merge is _merge_packed's math in f32, rank by rank
// in order 0, 1, ..., n - 1: m = max(-1e30, lse_0, ..., lse_{n-1}),
// w_s = exp(lse_s - m), result = (sum_s w_s out_s) / max(sum_s w_s,
// 1e-30), rounded once to the dtype. A row whose lse is -1e30 on every
// rank (a slot no rank holds a token of) gives the mean of its partials,
// which the decode kernels write as 0: 0, never NaN. Rank-stacked operands:
// out_r = out + r * rows * D, lse_r = lse + r * rows. The replicated result
// is kept once: every rank waits for its n sources and could merge, but
// only rank 0's merge is stored, into merged (rows, D).
//
// The wire layout (the LL packed message, the port's own): a row of W =
// round_up(D + 1, 4) f32 lanes, [out (D) | lse | zeros]. The TPU kernel
// gives the lse a whole 128-lane tile because Mosaic tiles f32 buffers
// to 128 lanes; here one lane and 16-byte row alignment are enough. Rank
// r's landing region is (n, rows, W): slot s holds source s's rows. Its
// signal pad has the barrier counter at slot 0 and, at 1 + s * nblk + b,
// the signal of source s's row block b (ROWS rows).
//
// The protocol, per rank r, as the TPU kernel's: barrier_all at entry;
// each row block packed from out_r / lse_r once and pushed into slot r of
// every rank's region, itself included (ring order r + 1, r + 2, ...),
// then one notification each; then, for each row block, a bounded wait
// for the n sources' notifications, and (rank 0) the merge from its own
// region.
// One launch runs every rank's body on a persistent cooperative grid
// (tdt_tp.cuh's argument against deadlock): in one global order the n
// barrier arrivals, the n * nblk push items, the n * nblk merge items.
//
// What bounds it on the H100: at the sp-serve cell (Qwen3-8B decode, 4
// slots x 32 heads = 128 rows of D 128, n = 4) the function needs the n
// partials read and one result written (~0.16 MiB) and the protocol moves
// ~2.2 MiB (n^2 packed partials of 66 KiB written and read once), both
// well under a microsecond of HBM time: the launch, the barrier and the
// system-scope signals bound it. The design keeps that fixed cost to one
// cooperative launch of 2 n nblk + n small CTAs (68 at the cell), each
// moving 16-byte vectors, one signal a row block and destination.

#include "tdt_shmem.cuh"

namespace {

constexpr int NTHREADS = 128;
constexpr int MAX_RANKS = 8;
constexpr int ROWS = 16;  // rows a work item packs or merges

struct Params {
  const void* out;    // (n, rows, D) partials, T
  const float* lse;   // (n, rows)
  void* merged;       // (rows, D), T: rank 0's merge
  TdtPeers peers;
  int rows, D, W;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  uint2 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
  h[0] = __floats2bfloat162_rn(v.x, v.y);
  h[1] = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Rows [r0, r0 + nr) of the n packed partials src_s = base + s *
// slot_stride (rows of W lanes), merged into out (rows of D), in rank
// order with no contraction of the multiply-adds (the plain version's
// roundings).
template <typename T>
__device__ void merge_rows(const float* base, size_t slot_stride, T* out,
                           int r0, int nr, int n, int D, int W) {
  const int per_row = D / 4;
  for (int i = threadIdx.x; i < nr * per_row; i += blockDim.x) {
    const int r = r0 + i / per_row, c = (i % per_row) * 4;
    const size_t row = static_cast<size_t>(r) * W;
    float m = TDT_NEG_INF;
    for (int s = 0; s < n; ++s)
      m = fmaxf(m, __ldcg(base + s * slot_stride + row + D));
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
    float den = 0.f;
    for (int s = 0; s < n; ++s) {
      const float* src = base + s * slot_stride + row;
      const float w = expf(__fsub_rn(__ldcg(src + D), m));
      const float4 v = __ldcg(reinterpret_cast<const float4*>(src + c));
      num.x = __fadd_rn(num.x, __fmul_rn(w, v.x));
      num.y = __fadd_rn(num.y, __fmul_rn(w, v.y));
      num.z = __fadd_rn(num.z, __fmul_rn(w, v.z));
      num.w = __fadd_rn(num.w, __fmul_rn(w, v.w));
      den = __fadd_rn(den, w);
    }
    const float d = fmaxf(den, 1e-30f);
    store4(out + static_cast<size_t>(r) * D + c,
           make_float4(num.x / d, num.y / d, num.z / d, num.w / d));
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) ll_combine_kernel(Params p) {
  if (tdt_faulted(p.peers)) return;
  const int n = p.peers.n, rows = p.rows, D = p.D, W = p.W;
  const int nblk = (rows + ROWS - 1) / ROWS;
  const long long n_push = static_cast<long long>(n) * nblk;
  const long long total = n + 2 * n_push;
  const unsigned epoch = p.peers.epoch;
  const size_t slot = static_cast<size_t>(rows) * W;  // one source's rows

  for (long long it = blockIdx.x; it < total; it += gridDim.x) {
    if (it < n) {  // barrier_all: rank `it` arrives
      if (threadIdx.x == 0) tdt_barrier_arrive(p.peers);
      continue;
    }
    const bool push = it < n + n_push;
    const long long j = push ? it - n : it - n - n_push;
    const int me = static_cast<int>(j / nblk);
    const int b = static_cast<int>(j % nblk);
    const int r0 = b * ROWS, nr = min(ROWS, rows - r0);
    if (push) {  // pack row block b once, push it into every rank's slot me
      if (!tdt_cta_wait(p.peers, me, TDT_PAD_BARRIER, 0, 1, epoch * n))
        return;
      const T* src = static_cast<const T*>(p.out) +
                     (static_cast<size_t>(me) * rows + r0) * D;
      const float* lse = p.lse + static_cast<size_t>(me) * rows + r0;
      float* dst[MAX_RANKS];
      for (int i = 0; i < n; ++i)
        dst[i] = p.peers.region<float>((me + 1 + i) % n) + me * slot +
                 static_cast<size_t>(r0) * W;
      const int per_row = W / 4;
      for (int i = threadIdx.x; i < nr * per_row; i += blockDim.x) {
        const int r = i / per_row, c = (i % per_row) * 4;
        const float4 v =
            c < D ? load4(src + static_cast<size_t>(r) * D + c)
                  : make_float4(c == D ? lse[r] : 0.f, 0.f, 0.f, 0.f);
        for (int d = 0; d < n; ++d)
          store4(dst[d] + static_cast<size_t>(r) * W + c, v);
      }
      tdt_cta_release();
      if (threadIdx.x == 0)
        for (int i = 0; i < n; ++i)
          tdt_signal(p.peers, (me + 1 + i) % n, 1 + me * nblk + b);
      continue;
    }
    // row block b on rank me: wait for the n sources' rows; rank 0
    // merges them, in rank order, into the one kept result
    if (!tdt_cta_wait(p.peers, me, 1 + b, nblk, n, epoch)) return;
    if (me == 0)
      merge_rows(p.peers.region<float>(0), slot, static_cast<T*>(p.merged),
                 r0, nr, n, D, W);
  }
}

__global__ void __launch_bounds__(NTHREADS)
    ll_merge_kernel(const float* packed, float* out, int n, int rows, int D,
                    int W) {
  const int r0 = blockIdx.x * ROWS;
  merge_rows(packed, static_cast<size_t>(rows) * W, out, r0,
             min(ROWS, rows - r0), n, D, W);
}

template <typename T>
int resident_ctas(long long* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ll_combine_kernel<T>, NTHREADS, 0);
  *out = static_cast<long long>(per_sm) * sms;
  return static_cast<int>(e);
}

template <typename T>
int launch(const Params& p, int grid, cudaStream_t st) {
  long long resident = 0;
  const int e = resident_ctas<T>(&resident);
  if (e != 0) return e;
  const int n = p.peers.n;
  const long long items =
      n + 2LL * n * ((p.rows + ROWS - 1) / ROWS);
  long long g = grid > 0 ? grid : (items < resident ? items : resident);
  if (resident == 0 || g > resident)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  Params q = p;
  void* argv[] = {&q};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(ll_combine_kernel<T>),
      dim3(static_cast<unsigned>(g)), dim3(NTHREADS), argv, 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype 0 = bf16, 1 = f32 (out and merged); out (n, rows, D) and lse (n,
// rows) f32, rank-stacked; merged (rows, D); land / pads: device arrays of n
// addresses (landing regions of (n, rows, W) f32, u32 pads of 1 + n *
// ceil(rows / 16) slots); fault: 4 int32. grid 0 sizes the persistent grid
// by occupancy; a grid that could not be co-resident is refused.
extern "C" int tdt_ll_combine(int dtype, const void* out, const void* lse,
                              void* merged, const void* land,
                              const void* pads, void* fault, unsigned epoch,
                              long long budget_ns, int n, int rows, int D,
                              int W, int grid, void* stream) {
  if (dtype < 0 || dtype > 1 || n < 1 || n > MAX_RANKS || rows < 1 ||
      D < 8 || D % 8 || W != ((D + 1 + 3) / 4) * 4 || grid < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{out, static_cast<const float*>(lse), merged,
           TdtPeers{static_cast<const unsigned long long*>(land),
                    static_cast<const unsigned long long*>(pads),
                    static_cast<int*>(fault), epoch, budget_ns, n},
           rows, D, W};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<__nv_bfloat16>(p, grid, st)
                    : launch<float>(p, grid, st);
}

// packed (n, rows, W) f32 in the wire layout above; out (rows, D) f32.
extern "C" int tdt_ll_merge(const void* packed, void* out, int n, int rows,
                            int D, int W, void* stream) {
  if (n < 1 || rows < 1 || D < 8 || D % 8 || W != ((D + 1 + 3) / 4) * 4)
    return static_cast<int>(cudaErrorInvalidValue);
  ll_merge_kernel<<<(rows + ROWS - 1) / ROWS, NTHREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(packed), static_cast<float*>(out), n, rows,
      D, W);
  return static_cast<int>(cudaGetLastError());
}

// How many CTAs of the combine kernel can be resident on the current
// device (dtype as tdt_ll_combine).
extern "C" int tdt_ll_combine_resident(int dtype) {
  long long r = 0;
  const int e = dtype == 0 ? resident_ctas<__nv_bfloat16>(&r)
                           : resident_ctas<float>(&r);
  return e == 0 ? static_cast<int>(r) : -1;
}
