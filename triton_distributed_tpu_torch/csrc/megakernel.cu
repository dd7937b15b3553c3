// The megakernel: one persistent kernel that walks per-SM task queues over
// a whole transformer trunk (a decode step, or one prefill chunk).
//
// Replaces: triton_distributed_tpu/megakernel/executor_pallas.py::_kernel
// (:106, launched by ExecutorPallas._pallas :3046) — TPU kernel row 5 of
// PERF.md. It carries the task bodies LINEAR (:328), RMS_NORM (:598),
// SILU_MUL and ADD (:640), ATTN (:885; with rope_cs :797, head_prep :819,
// attn_step :834, head_rms :879), KVA_K / KVA_V (:1512 / :1559), the
// paged serving bodies ATTN_P (:1189) and KVA_PK / KVA_PV (:1351), and the
// MoE expert FFN GROUPED_GEMM (:673-766), each at the run-time verify width
// of queue column 10 (1..slot_rows candidate rows a slot), the fused arms of
// a decode program (below), and the cross-rank sum AR (:1597-1636) of an
// n-rank program (below). A2A (:1651) and GEMM_AR (:1712) are not built.
//
// The host side is megakernel/executor_cuda.py: one descriptor row per
// task (a graph node cut into tiles), a flat list of each task's producer
// tasks, and per-SM queues of packed (task << 20 | tile) entries from
// scheduler.schedule — a round-robin deal of ONE topological order of all
// (task, tile) items, so each queue lists its items in that order. A MoE
// node is two tasks, phase 0 then phase 1 (below), and phase 1 lists phase 0
// among its producers, so the order has every phase-0 item before any
// phase-1 item of the node and the argument below covers it unchanged.
//
// Persistent walk. One CTA per SM, launched with cudaLaunchCooperativeKernel
// so that every CTA is resident at once (or the launch fails with
// cudaErrorCooperativeLaunchTooLarge, which the wrapper raises). Each CTA
// walks its own queue in order. A scoreboard keeps one counter per task,
// counting its finished tiles. Before a tile, thread 0 spins with
// ld.acquire.gpu until every producer task's counter reaches its tile count
// (node-level dependencies), then __syncthreads(). After a tile, all threads
// have stored, __syncthreads(), and thread 0 does __threadfence() +
// atomicAdd on its task's counter (a release).
//
// Why it cannot deadlock. Take the first unfinished item of the global
// order. Its producers' items come earlier in that order, so they are
// finished. The items before it in its own queue come earlier too, so its
// CTA has reached it; the CTA is resident, so it runs it. Every item
// therefore finishes, by induction along the order. A missing dependency
// edge breaks no wait but gives a wrong answer, which the plain walk and
// the comparisons catch; a wait that still does not end (a broken table)
// is bounded: after the budget (about a second, on %globaltimer) thread 0
// records (code, task, producer) in a device flag and every CTA returns.
// The host reads the flag after the stream syncs and raises naming the
// task. A launch that finds the flag set returns at once.
//
// Scoreboard reset: an epoch passed by each launch. Counters are never
// cleared; launch e waits for e x tiles (u32 arithmetic, compared by signed
// difference), so no memset runs between launches. After a fault the host
// zeroes the counters and restarts the epochs.
//
// Coherence. Activations written inside the launch are read by other SMs
// only through plain ld.global (never ld.global.nc / __ldg / const
// __restrict__), after the acquire. Weights, the RoPE table and the cache
// prefix [0, cache_len) (written by earlier launches) go through __ldg. The
// cache appends of a launch write rows [cache_len, cache_len + S), which no
// task of the same launch reads from the cache.
//
// n-rank programs and AR. A tensor-parallel program is one rank's graph at
// the local widths with an AR node after each row-parallel projection; one
// launch runs all n ranks' programs on the card. A task keeps one descriptor
// row and n x its one-rank tiles: tile t of rank r is r x F_TPR + t. Every
// tile runs from a copy of its task's row in shared memory (one load a
// field); for rank r the copy has every operand pointer moved by r x its
// rank stride (F_RS_*: rank-stacked weight shards, the arena's activations
// held once a rank, each rank's cache or pool) and r at F_RANK, and the body
// runs it as it would run one rank. So the queues,
// the scoreboard and the argument below are one rank's; a dependency is on
// every rank's tiles of the producer, which is more than a rank needs and
// correct. An AR node is two tasks:
//   phase 0, tile (r, row tile): copy rank r's rows of the partial into slot
//     r of this node's landing block in every peer's arena (16-byte vectors
//     read through L2), then, after a system-scope fence, signal each peer:
//     red.release.sys on the u32 counter (node, peer, r, tile) of F_SIG;
//   phase 1, tile (r, row tile), which lists phase 0 among its producers:
//     thread 0 waits each source's counter to reach the epoch with
//     ld.acquire.sys, bounded by the budget (a lost signal sets the fault
//     word to FAULT_SIGNAL with the task and both ranks; the host raises
//     naming the AR task), then the CTA sums the n partials in rank order
//     0..n-1 in f32, rank r's own from its partial and the others from its
//     landing block, and rounds once to T (RankGroup.psum's order and
//     rounding point), into rank r's copy of the output.
// Because phase 1 waits on phase 0's tiles through the scoreboard, every push
// of the node has finished before any sum starts: the signal wait never
// spins in a sound launch and the argument below covers it unchanged (its
// order has every phase-0 item before any phase-1 item). Each AR node has
// its own landing block, so no launch reuses one (the TPU kernel alternates
// two parities instead), and the counters are never cleared (epoch
// targets, as the scoreboard). The landing rows and partials are
// activations of this launch: plain / L2 loads after the acquire.
//
// Paged serving (ATTN_P, KVA_PK, KVA_PV). Slot b's length, live width w and
// block-table row are run-time data, copied to the device before the launch
// (stream-ordered) and read through __ldg. A decode step has w = 1; a
// speculative verify step w = 1 + drafts (up to slot_rows), its candidate
// rows taken causally in one sweep of the prefix. Its append writes w rows:
// positions cache_len_b + i of the slot, each at page
// btab[b][(cache_len_b + i) / block], row (cache_len_b + i) % block. No task
// of the same launch reads those rows from the pool: ATTN_P of slot b reads
// rows [0, cache_len_b) and takes its own current rows from the qkv
// activation, and the host refuses a table in which any slot reads, or
// another append writes, one of those pool rows
// (ExecutorCuda._paged_run_data). The prefix rows a slot reads were written
// by earlier launches or by MegaServe.handoff's copy, stream-ordered before
// the launch. So the __ldg rule above holds for the pool too. An inactive
// slot arrives with length 0, width 0 (run as 1) and a table row of its own
// trash page, so it writes only row 0 of that page. Unlike the TPU body,
// which moves an aligned tile of rows through a read-modify-write because
// its DMAs move whole tiles, the CUDA append writes its w rows and nothing
// else, so a window may cross a page.
//
// GROUPED_GEMM (the MoE expert FFN over stacked expert slabs). The TPU body
// is one task per row tile that loops statically over ALL E experts, so its
// sanitizer can certify the reads; at Qwen3-30B-A3B's widths that reads
// 1.2 GB of slabs a layer, nearly all of them under routing weight 0. Here a
// node is two tasks, and only the slabs some live row routes to are read:
//   phase 0, tile (row, k, 64 columns of I): a warp replays the row's routing
//     from its logits row (f32 softmax over E, iterative first-max top-k,
//     optional renormalisation), then the tile dots the x row with the strip
//     of expert e_k's gate and up columns and writes
//     round_T(silu(g) * u * w_k) to an arena scratch (S, top_k x I);
//   phase 1, tile (row, 32 columns of H), after every phase-0 tile: the same
//     replay gives the same experts; the tile sums act[row, k, :] times the
//     strip of e_k's down slab over k and I in f32 and rounds once.
// A row is live unless its slot's width (run-time data beside the lengths)
// is at or below its place in the slot's tile: a dead row (pad rows, idle
// and capacity-deferred slots) reads no slab and writes zeros. The numbers
// are the TPU body's: an unrouted expert adds w_e = 0 times a finite value,
// exactly +0, to its f32 sum. Coherence: the x and logits rows and the
// scratch are activations of this launch, read with plain loads after the
// acquire; the slabs are weights (__ldg).
//
// Numerics (the plain walk in executor_cuda.py rounds at the same points):
// LINEAR accumulates in f32 and rounds to the graph dtype T once; RMS_NORM
// and SILU_MUL compute in f32; ADD rounds the f32 sum. ATTN and KVA_K prepare
// each q / k head row as the golden executor does: per-head RMSNorm in f32
// rounded to T, then rotate-half RoPE in f32 from the (positions, D/2) f32
// table of rope_cos_sin (no sinf in the kernel), rounded to T, with the
// products and differences not contracted into FMAs. Scores are f32 dots
// times 1/sqrt(D); an online softmax in f32 over 64-key chunks of the cache
// prefix then of the current rows (causal); p is rounded to T for the PV
// product and summed in f32 for the denominator.
//
// Fused decode arms (ExecutorPallas fuse_elementwise :2488, with the rms
// fold :2470, and fuse_kv_append :2214; the host's plan is
// ExecutorCuda._fusion_plan). A fused-away node has no task; the fused
// task's dependency list names the producers of every row it reads.
//   - The skinny LINEAR's A prologue: PRO_RMS stages the norm's input rows
//     (the whole row: the host refuses a width past the staged floats),
//     sums each row's squares in rms_norm_task's order (a thread's strided
//     FMAs, then block_sum), and normalises the staged row in place,
//     rounded to T as RMS_NORM writes it. Every tile of the LINEAR redoes
//     this for its rows (8-48 KB of reads a tile). PRO_SILU stages
//     round_T(silu(g) * u) from the two source rows, as SILU_MUL does.
//   - Its epilogue: with a residual, the output column is
//     round_T(resid + round_T(acc)), written to the ADD's rows: the ADD's
//     own rounding points, and rows of their own in the arena, so no
//     reader of the old residual can see the new one.
//   - ATTN with F_APPEND: after the tile's attention, one warp per (row,
//     part) writes the tile's rows of its kv head at cache_len + row
//     through kv_append_row, K normed and roped as KVA_K writes it, V raw.
//     No task of the launch reads those cache rows (the prefix reads stop
//     at cache_len), so the __ldg rule below holds as for KVA_K.
// The tiled LINEAR has no fused arm: a fused descriptor in mode 1 is an op
// the kernel does not have (a fault); the host refuses such a program.
//
// What bounds it on the H100: bytes. A decode step (S = 1) reads every
// trunk weight once: 13.9 GB for Qwen3-8B (36 layers), 4.15 ms at
// 3.35 TB/s, plus the cache rows up to cache_len and a few MB of
// activations. A 256-row prefill chunk does ~2.9 TFLOP; its SIMT f32 FMAs
// (no tensor cores yet) bound it by operations.
//
// A paged serving step (b_slots live rows) reads the same weights once, plus
// each slot's cache_len_b prefix rows: ATTN_P resolves the page of each
// prefix row through the table as it loads it, so a 64-key chunk may span
// pages and `block` need not be a multiple of 64. A MoE serving step reads,
// for each layer, the slabs of the distinct experts its live rows route to
// (~29 of 128 at 4 rows and top-8: ~275 MB a layer at Qwen3-30B-A3B's
// widths), so its bound is the routed slabs plus ~38 MB of attention and
// router weights a layer; GROUPED_GEMM reads a slab once per (row, k) that
// routes to it, so two rows sharing an expert read its slab twice.
//
// What the design does about it: the decode LINEAR gives each SM a
// 32-column tile (128-384 tiles per projection at Qwen3-8B) and keeps eight
// 16-byte weight loads per thread in flight; ATTN reads the cache prefix in
// 16-byte vectors, 64 rows per chunk; the whole trunk is one launch, so no
// host dispatch sits between its ~470 tasks (217 fused). It is the simple
// form: node-level dependencies stall each SM at every layer's stage
// boundary (5 of the 13 a layer go with fuse_elementwise), a decode step's
// ATTN runs on only Hkv CTAs per layer, and nothing uses TMA or the tensor
// cores. Those are later work (PERF.md §7).

#include "tdt_shmem.cuh"

namespace {

constexpr int NT = 256;           // threads per CTA
constexpr int NW = NT / 32;
constexpr int NF = 59;            // descriptor fields (executor_cuda.NF)
enum : int {
  F_OP = 0, F_TILES, F_DEP_LO, F_DEP_HI, F_OUT, F_A, F_B, F_C, F_D, F_E,
  F_M, F_N, F_K, F_LDA, F_LDB, F_LDO, F_TR, F_NCT, F_TN, F_H, F_HKV, F_HD,
  F_QKN, F_CACHED, F_CAUSAL, F_EPS, F_SCALE, F_COS, F_SIN, F_LDC, F_MODE,
  F_BLOCK, F_SROWS, F_MAXP, F_NE, F_TOPK, F_INTER, F_NORMK, F_PHASE, F_LDD,
  F_LDE, F_PRO, F_P, F_LDP, F_R, F_LDR, F_APPEND, F_NR, F_TPR, F_RANK,
  F_RS_OUT, F_RS_A, F_RS_B, F_RS_C, F_RS_D, F_RS_E, F_RS_P, F_RS_R, F_SIG
};
// the pointer field each rank stride F_RS_OUT + i moves (executor_cuda.RANKED)
__constant__ int RANKED_PTR[8] = {F_OUT, F_A, F_B, F_C, F_D, F_E, F_P, F_R};
// a fused LINEAR's A prologue (executor_cuda.PRO_*)
enum : int { PRO_NONE = 0, PRO_RMS = 1, PRO_SILU = 2 };
// op codes of megakernel/graph.py
enum : int {
  OP_LINEAR = 0, OP_RMS_NORM = 1, OP_SILU_MUL = 2, OP_ADD = 3, OP_ATTN = 4,
  OP_AR = 5, OP_KVA_K = 6, OP_KVA_V = 7, OP_ATTN_P = 9, OP_KVA_PK = 10,
  OP_KVA_PV = 11, OP_GROUPED_GEMM = 13
};
enum : int { FAULT_TIMEOUT = 1, FAULT_BAD_OP = 2, FAULT_SIGNAL = 3 };
// what a task body returns to the walk
enum : int { TASK_DONE = 1, TASK_UNKNOWN = 0, TASK_STOP = -1 };

// shared memory plan, in floats
constexpr int QR_MAX = 64;        // q rows of one ATTN task (G x row tile)
constexpr int KCH = 64;           // keys per attention chunk
constexpr int DMAX = 128;
constexpr int ATTN_FLOATS = QR_MAX * DMAX + KCH * (DMAX + 1) + KCH * DMAX +
                            QR_MAX * KCH + 3 * QR_MAX;
constexpr int XS_FLOATS = 16384;  // skinny LINEAR: staged x rows
constexpr int SKINNY_TN = 32;
constexpr int RED_FLOATS = NT * 8;
constexpr int LIN_FLOATS = XS_FLOATS + RED_FLOATS;
constexpr int SMEM_FLOATS = ATTN_FLOATS > LIN_FLOATS ? ATTN_FLOATS : LIN_FLOATS;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;
constexpr int UNROLL = 8;         // skinny LINEAR: weight loads in flight
// GROUPED_GEMM (executor_cuda.MOE_*): phase 0 tiles take 64 columns of I,
// phase 1 tiles 32 columns of H; the routing warp holds 8 experts a lane
constexpr int MOE_STRIP = 64;
constexpr int MOE_OUT_TN = 32;
constexpr int MOE_EPL = 8;
constexpr int MOE_MAX_TOPK = 32;
static_assert(XS_FLOATS + RED_FLOATS + 2 * MOE_MAX_TOPK <= SMEM_FLOATS,
              "GROUPED_GEMM's staged row, partial sums and routing fit");

struct Params {
  const long long* desc;
  const int* deps;
  const int* queues;
  const int* qlen;
  unsigned* counts;
  int* fault;
  const int* lens;     // paged serving: per-slot cache lengths (b_slots,)
  const int* widths;   // paged serving: per-slot live rows (b_slots,)
  const int* btab;     // paged serving: block table (b_slots, btab_ld)
  long long budget_ns;
  int qcap;
  int cache_len;
  int btab_ld;
  unsigned epoch;
};

// -- element helpers ---------------------------------------------------------
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}
template <typename T> __device__ __forceinline__ float round_t(float x) {
  return to_f(from_f<T>(x));
}

// 16 bytes of weights -> floats
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <typename T> __device__ __forceinline__ const T* cptr(long long a) {
  return reinterpret_cast<const T*>(a);
}
template <typename T> __device__ __forceinline__ T* mptr(long long a) {
  return reinterpret_cast<T*>(a);
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ int ld_volatile(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}
__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// block-wide sum; every thread gets the result. `red` holds NW floats.
__device__ __forceinline__ float block_sum(float x, float* red) {
  x = tdt_warp_sum(x);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) s += red[w];
  return s;
}

// The elementwise arithmetic of RMS_NORM, SILU_MUL and ADD, shared by their
// tasks and the fused LINEAR arms so both round at the same points.
__device__ __forceinline__ float rms_inv(float ss, int n, float eps) {
  return 1.0f / sqrtf(ss / n + eps);
}
__device__ __forceinline__ float rms_elem(float x, float inv, float w) {
  return __fmul_rn(__fmul_rn(x, inv), w);
}
__device__ __forceinline__ float silu_mul_elem(float a, float b) {
  const float sig = 1.0f / (1.0f + expf(-a));
  return __fmul_rn(__fmul_rn(a, sig), b);
}

// -- scoreboard ----------------------------------------------------------------
// Thread 0 only. Returns false (after recording a fault, or on finding one)
// when the CTA must stop.
__device__ bool wait_deps(const Params& p, const long long* d, int task) {
  const int lo = static_cast<int>(d[F_DEP_LO]);
  const int hi = static_cast<int>(d[F_DEP_HI]);
  for (int i = lo; i < hi; ++i) {
    const int dep = p.deps[i];
    const unsigned target =
        p.epoch * static_cast<unsigned>(p.desc[static_cast<long long>(dep) * NF +
                                               F_TILES]);
    unsigned long long t0 = 0;
    while (static_cast<int>(ld_acquire(p.counts + dep) - target) < 0) {
      if (ld_volatile(p.fault) != 0) return false;
      const unsigned long long now = globaltimer();
      if (t0 == 0) {
        t0 = now;
      } else if (now - t0 > static_cast<unsigned long long>(p.budget_ns)) {
        if (atomicCAS(p.fault, 0, FAULT_TIMEOUT) == 0) {
          p.fault[1] = task;
          p.fault[2] = dep;
          __threadfence();
        }
        return false;
      }
      __nanosleep(100);
    }
  }
  return true;
}

// -- LINEAR, decode form: rows <= 8, 32-column tiles -------------------------
// The fused RMS_NORM prologue: normalise the nr staged rows of K floats in
// place, each rounded to T, with rms_norm_task's arithmetic in its order.
// `red` holds NW floats. Ends with a barrier.
template <typename T>
__device__ void rms_prologue(float* xs, int nr, int K, const T* w, float eps,
                             float* red) {
  for (int r = 0; r < nr; ++r) {
    float* xr = xs + r * K;
    float ss = 0.f;
    for (int c = threadIdx.x; c < K; c += NT) ss = fmaf(xr[c], xr[c], ss);
    ss = block_sum(ss, red);
    const float inv = rms_inv(ss, K, eps);
    for (int c = threadIdx.x; c < K; c += NT)
      xr[c] = round_t<T>(rms_elem(xr[c], inv, to_f(__ldg(w + c))));
  }
  __syncthreads();
}

// Threads split as CV column vectors (16 bytes) x RL row lanes over K; x rows
// are staged in shared memory as f32 (through a fused prologue: the normed
// row, or silu(g) * u); the RL partial sums of each output meet in shared
// memory at the end, where a fused residual is added.
template <typename T, int R>
__device__ void linear_skinny(const long long* d, int tile, float* sm) {
  constexpr int VEC = Vec<T>::N;
  constexpr int CV = SKINNY_TN / VEC;
  constexpr int RL = NT / CV;
  const int M = static_cast<int>(d[F_M]), N = static_cast<int>(d[F_N]);
  const int K = static_cast<int>(d[F_K]);
  const long long lda = d[F_LDA], ldb = d[F_LDB], ldo = d[F_LDO];
  const int nct = static_cast<int>(d[F_NCT]), tr = static_cast<int>(d[F_TR]);
  const int rt = tile / nct, ct = tile % nct;
  const int r0 = rt * tr, nr = min(tr, M - r0);
  const T* x = cptr<T>(d[F_A]);           // activation: coherent loads
  const T* w = cptr<T>(d[F_B]);
  T* out = mptr<T>(d[F_OUT]);
  const int pro = static_cast<int>(d[F_PRO]);
  const T* up = cptr<T>(d[F_P]);          // PRO_SILU: activation rows
  const long long ldp = d[F_LDP], ldr = d[F_LDR];
  const T* res = d[F_R] ? cptr<T>(d[F_R]) : nullptr;   // activation rows
  const int tid = threadIdx.x, cv = tid % CV, rl = tid / CV;
  const int col = ct * SKINNY_TN + cv * VEC;
  const bool live = col < N;
  float acc[R][VEC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;
  float* xs = sm;
  const int kcap = XS_FLOATS / R;
  for (int k0 = 0; k0 < K; k0 += kcap) {
    const int kc = min(kcap, K - k0);
    __syncthreads();
    for (int i = tid; i < nr * kc; i += NT) {
      const int r = i / kc, k = i - r * kc;
      const float a = to_f(x[(r0 + r) * lda + k0 + k]);
      xs[r * kc + k] =
          pro == PRO_SILU
              ? round_t<T>(silu_mul_elem(a, to_f(up[(r0 + r) * ldp + k0 + k])))
              : a;
    }
    __syncthreads();
    if (pro == PRO_RMS)   // kc == K: the host stages whole rows
      rms_prologue<T>(xs, nr, kc, cptr<T>(d[F_P]),
                      __int_as_float(static_cast<int>(d[F_EPS])),
                      sm + XS_FLOATS);
    if (!live) continue;
    const T* wp = w + static_cast<long long>(k0) * ldb + col;
    int k = rl;
    for (; k + (UNROLL - 1) * RL < kc; k += UNROLL * RL) {
      uint4 u[UNROLL];
#pragma unroll
      for (int j = 0; j < UNROLL; ++j)
        u[j] = __ldg(reinterpret_cast<const uint4*>(
            wp + static_cast<long long>(k + j * RL) * ldb));
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        float wf[VEC];
        Vec<T>::unpack(u[j], wf);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < nr) {
            const float xv = xs[r * kc + k + j * RL];
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[r][e] = fmaf(xv, wf[e], acc[r][e]);
          }
        }
      }
    }
    for (; k < kc; k += RL) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(
          wp + static_cast<long long>(k) * ldb));
      float wf[VEC];
      Vec<T>::unpack(u, wf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < nr) {
          const float xv = xs[r * kc + k];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[r][e] = fmaf(xv, wf[e], acc[r][e]);
        }
      }
    }
  }
  float* red = sm + XS_FLOATS;   // [RL][SKINNY_TN]
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= nr) break;
    __syncthreads();
#pragma unroll
    for (int e = 0; e < VEC; ++e) red[rl * SKINNY_TN + cv * VEC + e] = acc[r][e];
    __syncthreads();
    if (tid < SKINNY_TN) {
      float s = 0.f;
      for (int l = 0; l < RL; ++l) s += red[l * SKINNY_TN + tid];
      const int c = ct * SKINNY_TN + tid;
      if (c < N)
        out[(r0 + r) * ldo + c] = from_f<T>(
            res == nullptr ? s
                           : __fadd_rn(to_f(res[(r0 + r) * ldr + c]),
                                       round_t<T>(s)));
    }
  }
}

// -- LINEAR, prefill form: 64 x 64 output tiles, SIMT f32 FMA ----------------
template <typename T>
__device__ void linear_tiled(const long long* d, int tile, float* sm) {
  constexpr int BM = 64, BN = 64, BK = 32;
  const int M = static_cast<int>(d[F_M]), N = static_cast<int>(d[F_N]);
  const int K = static_cast<int>(d[F_K]);
  const long long lda = d[F_LDA], ldb = d[F_LDB], ldo = d[F_LDO];
  const int nct = static_cast<int>(d[F_NCT]);
  const int m0 = (tile / nct) * BM, n0 = (tile % nct) * BN;
  const T* x = cptr<T>(d[F_A]);
  const T* w = cptr<T>(d[F_B]);
  T* out = mptr<T>(d[F_OUT]);
  float* As = sm;             // [BK][BM]
  float* Bs = sm + BK * BM;   // [BK][BN]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();
    for (int i = tid; i < BM * BK; i += NT) {
      const int m = i / BK, k = i % BK;
      const int gm = m0 + m, gk = k0 + k;
      As[k * BM + m] = (gm < M && gk < K) ? to_f(x[gm * lda + gk]) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int k = i / BN, n = i % BN;
      const int gk = k0 + k, gn = n0 + n;
      Bs[k * BN + n] =
          (gk < K && gn < N) ? to_f(__ldg(w + gk * ldb + gn)) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(As + k * BM + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(Bs + k * BN + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) out[gm * ldo + gn] = from_f<T>(acc[i][j]);
    }
  }
}

// -- RMS_NORM, SILU_MUL, ADD: row tiles at full width -------------------------
template <typename T>
__device__ void rms_norm_task(const long long* d, int tile, float* sm) {
  const int M = static_cast<int>(d[F_M]), N = static_cast<int>(d[F_N]);
  const int tr = static_cast<int>(d[F_TR]);
  const long long lda = d[F_LDA], ldo = d[F_LDO];
  const float eps = __int_as_float(static_cast<int>(d[F_EPS]));
  const T* x = cptr<T>(d[F_A]);
  const T* w = cptr<T>(d[F_B]);
  T* out = mptr<T>(d[F_OUT]);
  const int r0 = tile * tr, r1 = min(M, r0 + tr);
  for (int r = r0; r < r1; ++r) {
    const T* xr = x + r * lda;
    float ss = 0.f;
    for (int c = threadIdx.x; c < N; c += NT) {
      const float v = to_f(xr[c]);
      ss = fmaf(v, v, ss);
    }
    ss = block_sum(ss, sm);
    const float inv = rms_inv(ss, N, eps);
    for (int c = threadIdx.x; c < N; c += NT)
      out[r * ldo + c] =
          from_f<T>(rms_elem(to_f(xr[c]), inv, to_f(__ldg(w + c))));
  }
}

template <typename T, bool SILU>
__device__ void elementwise_task(const long long* d, int tile) {
  const int M = static_cast<int>(d[F_M]), N = static_cast<int>(d[F_N]);
  const int tr = static_cast<int>(d[F_TR]);
  const long long lda = d[F_LDA], ldb = d[F_LDB], ldo = d[F_LDO];
  const T* a = cptr<T>(d[F_A]);
  const T* b = cptr<T>(d[F_B]);
  T* out = mptr<T>(d[F_OUT]);
  const int r0 = tile * tr, r1 = min(M, r0 + tr);
  for (int r = r0; r < r1; ++r)
    for (int c = threadIdx.x; c < N; c += NT) {
      const float av = to_f(a[r * lda + c]), bv = to_f(b[r * ldb + c]);
      out[r * ldo + c] =
          from_f<T>(SILU ? silu_mul_elem(av, bv) : __fadd_rn(av, bv));
    }
}

// -- head-row prep: per-head RMSNorm, then RoPE (one warp per row) ----------
// src: D elements of one head of one row (an activation); nw: the (1, D)
// norm weight or null; cs/sn: the table row of its position. Writes the
// prepared row as f32 values exactly representable in T.
template <typename T, int D>
__device__ __forceinline__ void prep_row(const T* src, const T* nw, float eps,
                                         const float* cs, const float* sn,
                                         float* x) {
  constexpr int P = D / 32;   // dims per lane: d = lane + 32 u
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < P; ++u) x[u] = to_f(src[lane + 32 * u]);
  if (nw != nullptr) {
    float ss = 0.f;
#pragma unroll
    for (int u = 0; u < P; ++u) ss = fmaf(x[u], x[u], ss);
    ss = tdt_warp_sum(ss);
    const float inv = 1.0f / sqrtf(ss / D + eps);
#pragma unroll
    for (int u = 0; u < P; ++u)
      x[u] = round_t<T>(
          __fmul_rn(__fmul_rn(x[u], inv), to_f(__ldg(nw + lane + 32 * u))));
  }
  // rotate-half: lane's u < P/2 pairs with u + P/2 (d and d + D/2)
#pragma unroll
  for (int u = 0; u < P / 2; ++u) {
    const int dd = lane + 32 * u;
    const float c = __ldg(cs + dd), s = __ldg(sn + dd);
    const float a = x[u], b = x[u + P / 2];
    x[u] = round_t<T>(__fsub_rn(__fmul_rn(a, c), __fmul_rn(b, s)));
    x[u + P / 2] = round_t<T>(__fadd_rn(__fmul_rn(b, c), __fmul_rn(a, s)));
  }
}

// -- KVA_K / KVA_V / KVA_PK / KVA_PV: one head row of a step's K or V --------
// K rows are normed (with k_norm) and roped at their position; V rows copied.
// `cache`: the destination (an append task's output; a fused ATTN's caches).
template <typename T, int D, bool K_PART>
__device__ __forceinline__ void kv_append_row(const long long* d, T* cache,
                                              int r, int j, int pos,
                                              long long dst_row) {
  constexpr int P = D / 32;
  const int H = static_cast<int>(d[F_H]), Hkv = static_cast<int>(d[F_HKV]);
  const long long lda = d[F_LDA], ldc = d[F_LDC];
  const T* qkv = cptr<T>(d[F_A]);
  T* dst = cache + dst_row * ldc + j * D;
  const int lane = threadIdx.x & 31;
  if (K_PART) {
    const T* kn = d[F_QKN] ? cptr<T>(d[F_E]) : nullptr;
    const float eps = __int_as_float(static_cast<int>(d[F_EPS]));
    const float* cos_t = cptr<float>(d[F_COS]);
    const float* sin_t = cptr<float>(d[F_SIN]);
    float x[P];
    prep_row<T, D>(qkv + r * lda + (H + j) * D, kn, eps,
                   cos_t + static_cast<long long>(pos) * (D / 2),
                   sin_t + static_cast<long long>(pos) * (D / 2), x);
#pragma unroll
    for (int u = 0; u < P; ++u) dst[lane + 32 * u] = from_f<T>(x[u]);
  } else {
    const T* src = qkv + r * lda + (H + Hkv + j) * D;
#pragma unroll
    for (int u = 0; u < P; ++u) dst[lane + 32 * u] = src[lane + 32 * u];
  }
}

// -- ATTN / ATTN_P: one kv head over a group of q rows; the G q heads share
// every K/V row --------------------------------------------------------------
// The rows of one attention tile. q rows: trunk rows qrow0 .. qrow0 + nr - 1
// at positions pos0 + i. Keys: the cache prefix, positions [0, cl), then the
// current rows: trunk rows krow0 .. krow0 + ncur - 1 at positions kpos0 + i,
// causal by trunk row when `causal`. Prefix row c lies at cache row c, or,
// through a block-table row `trow`, at row c % blk of page trow[c / blk].
// `pad` rows after the q rows get zeros in the tile's output columns.
struct AttnRows {
  int qrow0, nr, pos0, krow0, ncur, kpos0, cl, blk, pad;
  bool causal;
  const int* trow;
};

template <typename T, int D>
__device__ void attn_task(const long long* d, int j, const AttnRows& g_,
                          float* sm) {
  constexpr int P = D / 32;
  constexpr int RS = NT / D;            // PV: rows between a thread's rows
  constexpr int RPT = QR_MAX / RS;      // PV: rows per thread
  const int H = static_cast<int>(d[F_H]), Hkv = static_cast<int>(d[F_HKV]);
  const int G = H / Hkv;
  const int nr = g_.nr, cl = g_.cl;
  const int QR = G * nr;                // q row it = g * nr + rr
  const long long lda = d[F_LDA], ldo = d[F_LDO], ldc = d[F_LDC];
  const T* qkv = cptr<T>(d[F_A]);
  const T* kc = cptr<T>(d[F_B]);
  const T* vc = cptr<T>(d[F_C]);
  const T* qn = d[F_QKN] ? cptr<T>(d[F_D]) : nullptr;
  const T* kn = d[F_QKN] ? cptr<T>(d[F_E]) : nullptr;
  const float eps = __int_as_float(static_cast<int>(d[F_EPS]));
  const float scale = __int_as_float(static_cast<int>(d[F_SCALE]));
  const float* cos_t = cptr<float>(d[F_COS]);
  const float* sin_t = cptr<float>(d[F_SIN]);
  T* out = mptr<T>(d[F_OUT]);

  float* qs = sm;                        // [QR_MAX][D]
  float* ks = qs + QR_MAX * DMAX;        // [KCH][D + 1]
  float* vs = ks + KCH * (DMAX + 1);     // [KCH][D]
  float* ss = vs + KCH * DMAX;           // [QR_MAX][KCH]
  float* mrow = ss + QR_MAX * KCH;
  float* lrow = mrow + QR_MAX;
  float* arow = lrow + QR_MAX;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int it = warp; it < QR; it += NW) {
    const int g = it / nr, r = g_.qrow0 + it % nr;
    const int pos = g_.pos0 + it % nr;
    float x[P];
    prep_row<T, D>(qkv + r * lda + (j * G + g) * D, qn, eps,
                   cos_t + static_cast<long long>(pos) * (D / 2),
                   sin_t + static_cast<long long>(pos) * (D / 2), x);
#pragma unroll
    for (int u = 0; u < P; ++u) qs[it * D + lane + 32 * u] = x[u];
  }
  for (int it = tid; it < QR; it += NT) {
    mrow[it] = TDT_NEG_INF;
    lrow[it] = 0.f;
  }
  float acc[RPT];
#pragma unroll
  for (int u = 0; u < RPT; ++u) acc[u] = 0.f;

  for (int phase = 0; phase < 2; ++phase) {
    const int nk = phase == 0 ? cl : g_.ncur;
    for (int c0 = 0; c0 < nk; c0 += KCH) {
      const int kn_ = min(KCH, nk - c0);
      __syncthreads();   // q prep done / previous chunk consumed
      if (phase == 0) {
        constexpr int VEC = Vec<T>::N;
        constexpr int RV = D / VEC;      // 16-byte vectors per head row
        for (int i = tid; i < kn_ * RV; i += NT) {
          const int jj = i / RV, dd = (i % RV) * VEC;
          const int c = c0 + jj;
          const long long crow =
              g_.trow == nullptr
                  ? c
                  : static_cast<long long>(__ldg(g_.trow + c / g_.blk)) *
                            g_.blk + c % g_.blk;
          const long long off = crow * ldc + j * D + dd;
          float kf[VEC], vf[VEC];
          Vec<T>::unpack(__ldg(reinterpret_cast<const uint4*>(kc + off)), kf);
          Vec<T>::unpack(__ldg(reinterpret_cast<const uint4*>(vc + off)), vf);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            ks[jj * (D + 1) + dd + e] = kf[e];
            vs[jj * D + dd + e] = vf[e];
          }
        }
      } else {
        for (int jj = warp; jj < kn_; jj += NW) {
          const int row = g_.krow0 + c0 + jj, pos = g_.kpos0 + c0 + jj;
          float x[P];
          prep_row<T, D>(qkv + row * lda + (H + j) * D, kn, eps,
                         cos_t + static_cast<long long>(pos) * (D / 2),
                         sin_t + static_cast<long long>(pos) * (D / 2), x);
#pragma unroll
          for (int u = 0; u < P; ++u) {
            ks[jj * (D + 1) + lane + 32 * u] = x[u];
            vs[jj * D + lane + 32 * u] =
                to_f(qkv[row * lda + (H + Hkv + j) * D + lane + 32 * u]);
          }
        }
      }
      __syncthreads();
      {   // scores: thread -> key jj, q rows it = tid / KCH + 4 u
        const int jj = tid % KCH;
        for (int it = tid / KCH; it < QR; it += NT / KCH) {
          float s = TDT_NEG_INF;
          const bool seen =
              jj < kn_ && (phase == 0 || !g_.causal ||
                           g_.krow0 + c0 + jj <= g_.qrow0 + it % nr);
          if (seen) {
            float a = 0.f;
#pragma unroll 16
            for (int dd = 0; dd < D; ++dd)
              a = fmaf(qs[it * D + dd], ks[jj * (D + 1) + dd], a);
            s = a * scale;
          }
          ss[it * KCH + jj] = s;
        }
      }
      __syncthreads();
      for (int it = warp; it < QR; it += NW) {   // online softmax, f32
        const float s0 = ss[it * KCH + lane], s1 = ss[it * KCH + lane + 32];
        const float m_old = mrow[it];
        const float m_new = fmaxf(m_old, tdt_warp_max(fmaxf(s0, s1)));
        const float p0 = s0 > 0.5f * TDT_NEG_INF ? expf(s0 - m_new) : 0.f;
        const float p1 = s1 > 0.5f * TDT_NEG_INF ? expf(s1 - m_new) : 0.f;
        ss[it * KCH + lane] = round_t<T>(p0);
        ss[it * KCH + lane + 32] = round_t<T>(p1);
        const float psum = tdt_warp_sum(p0 + p1);
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          mrow[it] = m_new;
          lrow[it] = alpha * lrow[it] + psum;
          arow[it] = alpha;
        }
      }
      __syncthreads();
      {   // PV: thread -> dim dd, q rows it = tid / D + RS u
        const int dd = tid % D;
#pragma unroll
        for (int u = 0; u < RPT; ++u) {
          const int it = tid / D + RS * u;
          if (it < QR) {
            float a = acc[u] * arow[it];
            for (int jj = 0; jj < kn_; ++jj)
              a = fmaf(ss[it * KCH + jj], vs[jj * D + dd], a);
            acc[u] = a;
          }
        }
      }
    }
  }
  __syncthreads();
  {
    const int dd = tid % D;
#pragma unroll
    for (int u = 0; u < RPT; ++u) {
      const int it = tid / D + RS * u;
      if (it < QR) {
        const int g = it / nr, r = g_.qrow0 + it % nr;
        out[r * ldo + (j * G + g) * D + dd] =
            from_f<T>(acc[u] / fmaxf(lrow[it], 1e-30f));
      }
    }
  }
  const int r_pad = g_.qrow0 + nr;       // pad rows: zeros, G heads wide
  for (int i = tid; i < g_.pad * G * D; i += NT)
    out[(r_pad + i / (G * D)) * ldo + j * G * D + i % (G * D)] = from_f<T>(0.f);
}

// ATTN: tile = (row tile, kv head) of the step's rows against the cache
// prefix [0, cache_len) and the causal current rows. With F_APPEND (the
// fused KVA_K / KVA_V) it then writes its rows' K and V of head j to the
// caches at cache_len + row, one warp per (row, part).
template <typename T, int D>
__device__ void attn_rows_task(const long long* d, int tile, float* sm,
                               int cache_len) {
  const int Hkv = static_cast<int>(d[F_HKV]);
  const int M = static_cast<int>(d[F_M]), tr = static_cast<int>(d[F_TR]);
  const int rt = tile / Hkv, j = tile % Hkv;
  const int r0 = rt * tr, nr = min(tr, M - r0);
  const int cl = d[F_CACHED] ? cache_len : 0;
  const bool causal = d[F_CAUSAL] != 0;
  const AttnRows g{r0, nr, cl + r0, 0, causal ? r0 + nr : M, cl, cl, 0, 0,
                   causal, nullptr};
  attn_task<T, D>(d, j, g, sm);
  if (d[F_APPEND] == 0) return;
  for (int item = threadIdx.x >> 5; item < 2 * nr; item += NW) {
    const int r = r0 + item / 2, pos = cl + r;
    if (item % 2 == 0)
      kv_append_row<T, D, true>(d, mptr<T>(d[F_B]), r, j, pos, pos);
    else
      kv_append_row<T, D, false>(d, mptr<T>(d[F_C]), r, j, pos, pos);
  }
}

// The rows ATTN_P and KVA_PK / KVA_PV run for slot b: its run-time width
// (1 when decoding, 1 + drafts when verifying), at least one, so an idle
// slot (width 0) runs its first row against its own trash page.
__device__ __forceinline__ int slot_width(const Params& p, int b) {
  return max(1, __ldg(p.widths + b));
}

// ATTN_P: tile = (slot b, kv head). The slot's w live rows (trunk rows
// b * slot_rows + i, i < w, at positions cache_len_b + i) attend the slot's
// pages up to cache_len_b, then its candidate rows 0..i (causal inside the
// tile: the verify arm, executor_pallas.py:1189-1335 with queue column 10);
// its slot_rows - w pad rows get zeros. w = 1 is the decode step.
template <typename T, int D>
__device__ void attn_paged_task(const long long* d, int tile, float* sm,
                                const Params& p) {
  const int Hkv = static_cast<int>(d[F_HKV]);
  const int R = static_cast<int>(d[F_SROWS]), blk = static_cast<int>(d[F_BLOCK]);
  const int b = tile / Hkv, j = tile % Hkv;
  const int cl = __ldg(p.lens + b), w = slot_width(p, b);
  const AttnRows g{b * R, w, cl, b * R, w, cl, cl, blk, R - w, true,
                   p.btab + static_cast<long long>(b) * p.btab_ld};
  attn_task<T, D>(d, j, g, sm);
}

// KVA_K / KVA_V: the step's rows into cache rows [cache_len, +S), one warp
// per (row, kv head) of the tile's rows.
template <typename T, int D, bool K_PART>
__device__ void kv_append_task(const long long* d, int tile, int cache_len) {
  const int Hkv = static_cast<int>(d[F_HKV]);
  const int M = static_cast<int>(d[F_M]), tr = static_cast<int>(d[F_TR]);
  const int r0 = tile * tr, r1 = min(M, r0 + tr);
  for (int item = threadIdx.x >> 5; item < (r1 - r0) * Hkv; item += NW) {
    const int r = r0 + item / Hkv, pos = cache_len + r;
    kv_append_row<T, D, K_PART>(d, mptr<T>(d[F_OUT]), r, item % Hkv, pos,
                                pos);
  }
}

// KVA_PK / KVA_PV: tile = slot b. Its w live rows land at positions
// cache_len_b + i, i < w: row (cache_len_b + i) % block of page
// btab[b][(cache_len_b + i) / block], one warp per (row, kv head), and
// nothing else of the pool (the verify arm, executor_pallas.py:1340-1430).
template <typename T, int D, bool K_PART>
__device__ void kv_append_paged_task(const long long* d, int tile,
                                     const Params& p) {
  const int Hkv = static_cast<int>(d[F_HKV]);
  const int R = static_cast<int>(d[F_SROWS]), blk = static_cast<int>(d[F_BLOCK]);
  const int cl = __ldg(p.lens + tile), w = slot_width(p, tile);
  const int* trow = p.btab + static_cast<long long>(tile) * p.btab_ld;
  for (int item = threadIdx.x >> 5; item < w * Hkv; item += NW) {
    const int i = item / Hkv, pos = cl + i;
    const long long dst_row =
        static_cast<long long>(__ldg(trow + pos / blk)) * blk + pos % blk;
    kv_append_row<T, D, K_PART>(d, mptr<T>(d[F_OUT]), tile * R + i,
                                item % Hkv, pos, dst_row);
  }
}

// -- GROUPED_GEMM: the MoE expert FFN, in two tasks -------------------------
// Row r is live unless the program is paged (F_SROWS rows a slot) and r lies
// at or past its slot's width. A dead row reads no expert slab and writes
// zeros.
__device__ __forceinline__ bool moe_live(const long long* d, int r,
                                         const Params& p) {
  const int R = static_cast<int>(d[F_SROWS]);
  return R == 0 || r % R < __ldg(p.widths + r / R);
}

// One warp routes one row: an f32 softmax over the E experts of its logits
// row, then top-k by iterative first-max (ties to the lower expert index,
// the rule of jax.lax.top_k), renormalised to sum 1 if `norm`. Writes the
// experts to sel_e and their weights to sel_w. Both phases route a row with
// this code on the same logits, so they choose the same experts.
template <typename T>
__device__ void moe_route(const T* lg, int E, int topk, bool norm,
                          float* sel_w, int* sel_e) {
  const int lane = threadIdx.x & 31;
  float v[MOE_EPL];
  float m = TDT_NEG_INF;
#pragma unroll
  for (int u = 0; u < MOE_EPL; ++u) {
    v[u] = lane + 32 * u < E ? to_f(lg[lane + 32 * u]) : TDT_NEG_INF;
    m = fmaxf(m, v[u]);
  }
  m = tdt_warp_max(m);
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < MOE_EPL; ++u) {
    v[u] = lane + 32 * u < E ? expf(v[u] - m) : 0.f;
    s += v[u];
  }
  s = tdt_warp_sum(s);
  // probabilities; -1 (below every probability) marks absent and taken
#pragma unroll
  for (int u = 0; u < MOE_EPL; ++u)
    v[u] = lane + 32 * u < E ? v[u] / s : -1.f;
  float tot = 0.f;
  for (int k = 0; k < topk; ++k) {
    float best = -2.f;
    int bi = 0x7fffffff;
#pragma unroll
    for (int u = 0; u < MOE_EPL; ++u)
      if (v[u] > best) {
        best = v[u];
        bi = lane + 32 * u;
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ob > best || (ob == best && oi < bi)) {
        best = ob;
        bi = oi;
      }
    }
#pragma unroll
    for (int u = 0; u < MOE_EPL; ++u)
      if (lane + 32 * u == bi) v[u] = -1.f;
    if (lane == 0) {
      sel_e[k] = bi;
      sel_w[k] = best;
    }
    tot += best;
  }
  if (norm && lane == 0)
    for (int k = 0; k < topk; ++k) sel_w[k] = sel_w[k] / tot;
}

// Phase 0: tile = (row r, k, 64-column strip of I). Routes row r, then
// act[r, k, strip] = round_T(silu(g) * u * w_k) with g and u the f32 dots of
// the x row (staged in shared memory) with the strip's gate and up columns
// of expert e_k's slab. Threads split as CV column vectors (16 bytes; the
// first half gate, the second up) x RL row lanes over H, as linear_skinny.
template <typename T>
__device__ void moe_gate_up_task(const long long* d, int tile, float* sm,
                                 const Params& p) {
  constexpr int VEC = Vec<T>::N;
  constexpr int CVP = MOE_STRIP / VEC;
  constexpr int CV = 2 * CVP;
  constexpr int RL = NT / CV;
  const int H = static_cast<int>(d[F_K]), E = static_cast<int>(d[F_NE]);
  const int K = static_cast<int>(d[F_TOPK]), I = static_cast<int>(d[F_INTER]);
  const int nct = static_cast<int>(d[F_NCT]);
  const int r = tile / (K * nct), rem = tile % (K * nct);
  const int k = rem / nct, st = rem % nct;
  const int tid = threadIdx.x;
  T* act = mptr<T>(d[F_E]) + r * d[F_LDE] + k * I + st * MOE_STRIP;
  if (!moe_live(d, r, p)) {
    for (int c = tid; c < MOE_STRIP; c += NT) act[c] = from_f<T>(0.f);
    return;
  }
  float* xs = sm;
  float* red = sm + XS_FLOATS;           // [RL][2 * MOE_STRIP]
  float* sel_w = red + RED_FLOATS;
  int* sel_e = reinterpret_cast<int*>(sel_w + MOE_MAX_TOPK);
  const T* x = cptr<T>(d[F_A]) + r * d[F_LDA];   // activations: coherent
  for (int i = tid; i < H; i += NT) xs[i] = to_f(x[i]);
  if (tid < 32)
    moe_route<T>(cptr<T>(d[F_B]) + r * d[F_LDB], E, K, d[F_NORMK] != 0,
                 sel_w, sel_e);
  __syncthreads();
  const long long ldc = d[F_LDC];
  const int cv = tid % CV, rl = tid / CV;
  const int col = (cv < CVP ? 0 : I) + st * MOE_STRIP + (cv % CVP) * VEC;
  const T* wp = cptr<T>(d[F_C]) + static_cast<long long>(sel_e[k]) * H * ldc +
                col;
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  int kk = rl;
  for (; kk + (UNROLL - 1) * RL < H; kk += UNROLL * RL) {
    uint4 u[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j)
      u[j] = __ldg(reinterpret_cast<const uint4*>(
          wp + static_cast<long long>(kk + j * RL) * ldc));
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      float wf[VEC];
      Vec<T>::unpack(u[j], wf);
      const float xv = xs[kk + j * RL];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fmaf(xv, wf[e], acc[e]);
    }
  }
  for (; kk < H; kk += RL) {
    float wf[VEC];
    Vec<T>::unpack(__ldg(reinterpret_cast<const uint4*>(
                       wp + static_cast<long long>(kk) * ldc)),
                   wf);
    const float xv = xs[kk];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = fmaf(xv, wf[e], acc[e]);
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) red[rl * 2 * MOE_STRIP + cv * VEC + e] = acc[e];
  __syncthreads();
  if (tid < MOE_STRIP) {
    float g = 0.f, u = 0.f;
    for (int l = 0; l < RL; ++l) {
      g += red[l * 2 * MOE_STRIP + tid];
      u += red[l * 2 * MOE_STRIP + MOE_STRIP + tid];
    }
    const float sig = 1.0f / (1.0f + expf(-g));
    act[tid] = from_f<T>(__fmul_rn(__fmul_rn(__fmul_rn(g, sig), u), sel_w[k]));
  }
}

// Phase 1: tile = (row r, 32-column strip of H). Routes row r again (the
// same experts as phase 0), stages its top_k x I activations, and sums
// act[r, k, :] . (the strip of expert e_k's down slab) over k and I in f32,
// rounded once. Threads split as CV column vectors x RL lanes over I.
template <typename T>
__device__ void moe_down_task(const long long* d, int tile, float* sm,
                              const Params& p) {
  constexpr int VEC = Vec<T>::N;
  constexpr int CV = MOE_OUT_TN / VEC;
  constexpr int RL = NT / CV;
  const int E = static_cast<int>(d[F_NE]), K = static_cast<int>(d[F_TOPK]);
  const int I = static_cast<int>(d[F_INTER]), nct = static_cast<int>(d[F_NCT]);
  const int r = tile / nct, ct = tile % nct;
  const int tid = threadIdx.x;
  T* out = mptr<T>(d[F_OUT]) + r * d[F_LDO] + ct * MOE_OUT_TN;
  if (!moe_live(d, r, p)) {
    for (int c = tid; c < MOE_OUT_TN; c += NT) out[c] = from_f<T>(0.f);
    return;
  }
  float* xs = sm;
  float* red = sm + XS_FLOATS;           // [RL][MOE_OUT_TN]
  float* sel_w = red + RED_FLOATS;
  int* sel_e = reinterpret_cast<int*>(sel_w + MOE_MAX_TOPK);
  const T* act = cptr<T>(d[F_E]) + r * d[F_LDE];  // phase 0's: coherent
  for (int i = tid; i < K * I; i += NT) xs[i] = to_f(act[i]);
  if (tid < 32)
    moe_route<T>(cptr<T>(d[F_B]) + r * d[F_LDB], E, K, d[F_NORMK] != 0,
                 sel_w, sel_e);
  __syncthreads();
  const long long ldd = d[F_LDD];
  const int cv = tid % CV, rl = tid / CV;
  const T* wd = cptr<T>(d[F_D]) + ct * MOE_OUT_TN + cv * VEC;
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  for (int k = 0; k < K; ++k) {
    const T* wp = wd + static_cast<long long>(sel_e[k]) * I * ldd;
    const float* a = xs + k * I;
    int i = rl;
    for (; i + (UNROLL - 1) * RL < I; i += UNROLL * RL) {
      uint4 u[UNROLL];
#pragma unroll
      for (int j = 0; j < UNROLL; ++j)
        u[j] = __ldg(reinterpret_cast<const uint4*>(
            wp + static_cast<long long>(i + j * RL) * ldd));
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        float wf[VEC];
        Vec<T>::unpack(u[j], wf);
        const float av = a[i + j * RL];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(av, wf[e], acc[e]);
      }
    }
    for (; i < I; i += RL) {
      float wf[VEC];
      Vec<T>::unpack(__ldg(reinterpret_cast<const uint4*>(
                         wp + static_cast<long long>(i) * ldd)),
                     wf);
      const float av = a[i];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fmaf(av, wf[e], acc[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) red[rl * MOE_OUT_TN + cv * VEC + e] = acc[e];
  __syncthreads();
  if (tid < MOE_OUT_TN) {
    float s = 0.f;
    for (int l = 0; l < RL; ++l) s += red[l * MOE_OUT_TN + tid];
    out[tid] = from_f<T>(s);
  }
}

// -- AR: the cross-rank sum of a row-parallel partial (two phases) ---------
// d is rank r's copy of the row: F_A rank r's partial (M, N), F_C rank r's
// landing block (n x M, N) (a peer q's lies (q - r) x F_RS_C elements away),
// F_OUT rank r's output; F_SIG the node's u32 counters (n dst, n src, F_TPR).
template <typename T>
__device__ __noinline__ void ar_push_task(const long long* d, int tile) {
  const int M = static_cast<int>(d[F_M]), N = static_cast<int>(d[F_N]);
  const int tr = static_cast<int>(d[F_TR]), tpr = static_cast<int>(d[F_TPR]);
  const int n = static_cast<int>(d[F_NR]), r = static_cast<int>(d[F_RANK]);
  const long long lda = d[F_LDA], ldc = d[F_LDC], rs = d[F_RS_C];
  const int r0 = tile * tr, r1 = min(M, r0 + tr);
  const T* part = cptr<T>(d[F_A]);
  T* land = mptr<T>(d[F_C]);
  for (int q = 0; q < n; ++q) {
    if (q == r) continue;
    T* dst = land + (q - r) * rs + (static_cast<long long>(r) * M) * ldc;
    for (int row = r0; row < r1; ++row)
      tdt_cta_copy(dst + row * ldc, part + row * lda, N * sizeof(T));
  }
  tdt_cta_release();
  if (threadIdx.x == 0) {
    unsigned* sig = reinterpret_cast<unsigned*>(d[F_SIG]);
    for (int q = 0; q < n; ++q)
      if (q != r) tdt_red_release_sys(sig + (q * n + r) * tpr + tile, 1u);
  }
}

// Thread 0 only: wait until source s's counter of this tile reaches the
// epoch, bounded. False (after recording a fault, or on finding one) when
// the CTA must stop.
__device__ bool ar_wait(const Params& p, const long long* d, int task,
                        int tile) {
  const int n = static_cast<int>(d[F_NR]), r = static_cast<int>(d[F_RANK]);
  const int tpr = static_cast<int>(d[F_TPR]);
  const unsigned* sig = reinterpret_cast<const unsigned*>(d[F_SIG]);
  for (int s = 0; s < n; ++s) {
    if (s == r) continue;
    const unsigned* addr = sig + (r * n + s) * tpr + tile;
    unsigned long long t0 = 0;
    while (static_cast<int>(tdt_ld_acquire_sys(addr) - p.epoch) < 0) {
      if (ld_volatile(p.fault) != 0) return false;
      const unsigned long long now = globaltimer();
      if (t0 == 0) {
        t0 = now;
      } else if (now - t0 > static_cast<unsigned long long>(p.budget_ns)) {
        if (atomicCAS(p.fault, 0, FAULT_SIGNAL) == 0) {
          p.fault[1] = task;
          p.fault[2] = s;
          p.fault[3] = r;
          __threadfence();
        }
        return false;
      }
      __nanosleep(100);
    }
  }
  return true;
}

template <typename T>
__device__ __noinline__ int ar_sum_task(const long long* d, int tile,
                                        const Params& p, int task) {
  __shared__ int s_ok;
  if (threadIdx.x == 0) s_ok = ar_wait(p, d, task, tile);
  __syncthreads();
  if (!s_ok) return TASK_STOP;
  const int M = static_cast<int>(d[F_M]), N = static_cast<int>(d[F_N]);
  const int tr = static_cast<int>(d[F_TR]);
  const int n = static_cast<int>(d[F_NR]), r = static_cast<int>(d[F_RANK]);
  const long long lda = d[F_LDA], ldc = d[F_LDC], ldo = d[F_LDO];
  const int r0 = tile * tr, r1 = min(M, r0 + tr);
  const T* part = cptr<T>(d[F_A]);
  const T* land = cptr<T>(d[F_C]);
  T* out = mptr<T>(d[F_OUT]);
  for (int row = r0; row < r1; ++row)
    for (int c = threadIdx.x; c < N; c += NT) {
      float acc = 0.f;
      for (int s = 0; s < n; ++s) {
        const float v = to_f(s == r ? part[row * lda + c]
                                    : land[(static_cast<long long>(s) * M +
                                            row) * ldc + c]);
        acc = s == 0 ? v : __fadd_rn(acc, v);
      }
      out[row * ldo + c] = from_f<T>(acc);
    }
  return TASK_DONE;
}

// Returns false on a fused descriptor it cannot run: any fused arm in the
// tiled form, or an RMS prologue whose rows exceed the staged floats.
template <typename T>
__device__ int linear_task(const long long* d, int tile, float* sm) {
  const bool fused = d[F_PRO] != PRO_NONE || d[F_R] != 0;
  if (d[F_MODE] == 1) {
    if (fused) return TASK_UNKNOWN;
    linear_tiled<T>(d, tile, sm);
    return TASK_DONE;
  }
  const int tr = static_cast<int>(d[F_TR]);
  const int R = tr <= 1 ? 1 : tr <= 2 ? 2 : tr <= 4 ? 4 : 8;
  if (d[F_PRO] == PRO_RMS && d[F_K] > XS_FLOATS / R) return TASK_UNKNOWN;
  if (R == 1) linear_skinny<T, 1>(d, tile, sm);
  else if (R == 2) linear_skinny<T, 2>(d, tile, sm);
  else if (R == 4) linear_skinny<T, 4>(d, tile, sm);
  else linear_skinny<T, 8>(d, tile, sm);
  return TASK_DONE;
}

// TASK_DONE, TASK_UNKNOWN on an op the kernel does not have, or TASK_STOP
// when a wait inside the body recorded or found a fault
template <typename T>
__device__ int run_task(const long long* d, int tile, float* sm,
                        const Params& p, int task) {
  const bool d128 = d[F_HD] == 128;
  const int cl = p.cache_len;
  switch (static_cast<int>(d[F_OP])) {
    case OP_LINEAR: return linear_task<T>(d, tile, sm);
    case OP_RMS_NORM: rms_norm_task<T>(d, tile, sm); return TASK_DONE;
    case OP_SILU_MUL: elementwise_task<T, true>(d, tile); return TASK_DONE;
    case OP_ADD: elementwise_task<T, false>(d, tile); return TASK_DONE;
    case OP_ATTN:
      if (d128) attn_rows_task<T, 128>(d, tile, sm, cl);
      else attn_rows_task<T, 64>(d, tile, sm, cl);
      return TASK_DONE;
    case OP_KVA_K:
      if (d128) kv_append_task<T, 128, true>(d, tile, cl);
      else kv_append_task<T, 64, true>(d, tile, cl);
      return TASK_DONE;
    case OP_KVA_V:
      if (d128) kv_append_task<T, 128, false>(d, tile, cl);
      else kv_append_task<T, 64, false>(d, tile, cl);
      return TASK_DONE;
    case OP_ATTN_P:
      if (p.lens == nullptr || p.widths == nullptr) return TASK_UNKNOWN;
      if (d128) attn_paged_task<T, 128>(d, tile, sm, p);
      else attn_paged_task<T, 64>(d, tile, sm, p);
      return TASK_DONE;
    case OP_KVA_PK:
      if (p.lens == nullptr || p.widths == nullptr) return TASK_UNKNOWN;
      if (d128) kv_append_paged_task<T, 128, true>(d, tile, p);
      else kv_append_paged_task<T, 64, true>(d, tile, p);
      return TASK_DONE;
    case OP_KVA_PV:
      if (p.lens == nullptr || p.widths == nullptr) return TASK_UNKNOWN;
      if (d128) kv_append_paged_task<T, 128, false>(d, tile, p);
      else kv_append_paged_task<T, 64, false>(d, tile, p);
      return TASK_DONE;
    case OP_GROUPED_GEMM:
      if (d[F_SROWS] != 0 && p.widths == nullptr) return TASK_UNKNOWN;
      if (d[F_PHASE] == 0) moe_gate_up_task<T>(d, tile, sm, p);
      else moe_down_task<T>(d, tile, sm, p);
      return TASK_DONE;
    case OP_AR:
      if (d[F_SIG] == 0) return TASK_UNKNOWN;
      if (d[F_PHASE] != 0) return ar_sum_task<T>(d, tile, p, task);
      ar_push_task<T>(d, tile);
      return TASK_DONE;
    default: return TASK_UNKNOWN;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 1) megakernel(Params p) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int s_go;
  __shared__ long long s_desc[NF];   // the tile's copy of its task's row
  const int* queue = p.queues + static_cast<long long>(blockIdx.x) * p.qcap;
  const int n = p.qlen[blockIdx.x];
  if (threadIdx.x == 0) s_go = ld_volatile(p.fault) == 0;
  __syncthreads();
  if (!s_go) return;
  for (int i = 0; i < n; ++i) {
    const int e = queue[i];
    const int task = e >> 20;
    int tile = e & 0xfffff;
    const long long* gd = p.desc + static_cast<long long>(task) * NF;
    // the row in shared memory, as rank r's in an n-rank program (each
    // operand pointer moved by r x its rank stride, r at F_RANK); the
    // barrier after the wait below publishes it
    int r = 0;
    if (__ldg(gd + F_NR) > 1) {
      r = tile / static_cast<int>(__ldg(gd + F_TPR));
      tile -= r * static_cast<int>(__ldg(gd + F_TPR));
    }
    for (int f = threadIdx.x; f < NF; f += NT) {
      long long v = __ldg(gd + f);
      if (r != 0)
        for (int k = 0; k < 8; ++k)
          if (RANKED_PTR[k] == f)
            v += r * __ldg(gd + F_RS_OUT + k) *
                 static_cast<long long>(sizeof(T));
      s_desc[f] = f == F_RANK ? r : v;
    }
    const long long* d = s_desc;
    if (threadIdx.x == 0) s_go = wait_deps(p, gd, task);
    __syncthreads();
    if (!s_go) return;
    const int done = run_task<T>(d, tile, sm, p, task);
    __syncthreads();
    if (threadIdx.x == 0) {
      if (done == TASK_UNKNOWN) {
        if (atomicCAS(p.fault, 0, FAULT_BAD_OP) == 0) p.fault[1] = task;
      } else if (done == TASK_DONE) {
        __threadfence();
        atomicAdd(p.counts + task, 1u);
      }
    }
    if (done != TASK_DONE) return;
  }
}

template <typename T>
int launch(const Params& prm, int n_sm, cudaStream_t st) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        megakernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  Params p = prm;
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(megakernel<T>), dim3(n_sm), dim3(NT), args,
      SMEM_BYTES, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// desc int64 (n_tasks, 47), deps int32, queues int32 (n_sm, qcap) packed
// task << 20 | tile, qlen int32 (n_sm,), counts u32 (n_tasks,) (the
// scoreboard, never cleared: launch `epoch` waits for epoch x tiles),
// fault int32 (4,) = (code, task, producer, -); a paged serving program's
// per-slot lengths lens int32 (b_slots,), live widths int32 (b_slots,)
// and block table btab int32 (b_slots, btab_ld), all null for other
// programs. dtype 0 = float32, 1 = bfloat16. One CTA per SM for n_sm SMs,
// cooperative.
extern "C" int tdt_megakernel(const void* desc, const void* deps,
                              const void* queues, const void* qlen,
                              void* counts, void* fault, const void* lens,
                              const void* widths, const void* btab,
                              int n_sm, int qcap,
                              int cache_len, int btab_ld, unsigned epoch,
                              long long budget_ns, int dtype, void* stream) {
  Params p;
  p.desc = static_cast<const long long*>(desc);
  p.deps = static_cast<const int*>(deps);
  p.queues = static_cast<const int*>(queues);
  p.qlen = static_cast<const int*>(qlen);
  p.counts = static_cast<unsigned*>(counts);
  p.fault = static_cast<int*>(fault);
  p.lens = static_cast<const int*>(lens);
  p.widths = static_cast<const int*>(widths);
  p.btab = static_cast<const int*>(btab);
  p.btab_ld = btab_ld;
  p.budget_ns = budget_ns;
  p.qcap = qcap;
  p.cache_len = cache_len;
  p.epoch = epoch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, n_sm, st);
  if (dtype == 1) return launch<__nv_bfloat16>(p, n_sm, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
