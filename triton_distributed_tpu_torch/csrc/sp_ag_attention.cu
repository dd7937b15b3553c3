// Fused AllGather + flash attention over n sequence-parallel ranks: each
// rank pushes its K / V shard into its peers' landing slots and attends its
// query rows to every shard, its own first, waiting on a shard's rows only
// when it reaches them.
//
// Replaces: triton_distributed_tpu/ops/sp_ag_attention.py::_kernel (:63),
// launched by sp_ag_attention_shard (:220) for sp_ag_attention (:320).
//
// Contract (sp_ag_attention_shard's kernel route, rank-stacked): rank r
// holds q_r (S, H, D) at global rows [r S, (r + 1) S) and its K / V shard
// k_r, v_r (S, Hkv, D), bf16; out_r (S, H, D) is softmax(q_r K^T * scale)
// V over the gathered sequence, GQA kv head h / (H / Hkv), causal when
// asked (global column <= global row). With a sideband qmeta_r (rows of 128
// int32, lanes 0 / 1 each local row's GLOBAL seq_start / seq_end) the batch
// is packed varlen: a row sees only its own sequence's columns, and a row
// outside every sequence comes out 0. The scale multiplies the f32 scores
// (JAX :141); p is masked explicitly; out = acc / max(l, 1e-30), rounded
// once (:204-216); there is no lse.
//
// The protocol, per rank, as JAX's: barrier_all at entry (:87); the pushes
// (:93-:106), each chunk of whole rows of all Hkv heads of k_r and v_r
// stored into slot r of a peer's landing region, then a release signal at
// the peer's pad slot 1 + r * nchunk + c (under the causal mask only to
// later ranks, the ones that read it); the consumer walks its own shard
// first, read in place, then ring order s = r + 1, ..., r - 1, skipping s >
// r under the causal mask (:191-:201), and before loading a kv tile of a
// peer's shard waits (bounded, acquire) on that tile's chunk signal. The
// (m, l, acc) state of one (rank, head, 64-row q tile) work item stays in
// the registers of the CTA that owns it across every shard: what JAX's VMEM
// `state` / `acc` scratch (:302-:304) stands for.
//
// One cooperative launch runs every rank's body on a persistent grid of
// co-resident CTAs (tdt_tp.cuh's launch and its argument against deadlock):
// the items in one global order are the n barrier arrivals, then every
// push, then the consumer items, so a consumer never waits on a push that
// a CTA has not already finished or is not about to run. Consumer items go
// heaviest first (the last rank's last q tiles: under the causal mask rank
// r attends r + 1 shards), as flash_attention.cu takes its latest q tiles
// first. With varlen, each q tile walks only the kv tiles between the
// earliest start and the latest end of its rows' sequences (JAX :126-:132),
// and a shard outside that range is neither waited on nor read.
//
// What bounds it on the H100: at the full-width cell (n = 4, S = 2048 a
// rank, 32 / 8 heads of 128, causal) the attention's tensor-core work, 4 H
// D per visible (row, column) pair (550 GFLOP, 0.56 ms at 989 TFLOP/s),
// against 160 MiB of q, k, v and out (0.05 ms); the pushes' 48 MiB of
// landing stores and their reads ride on top. The design keeps the work on
// mma.sync (csrc/tdt_flash.cuh's tile) and overlaps the pushes of the early
// items with the attention of the own shards. On one card the pushes are
// stores into the same HBM: no NVLink time is measured. Not done yet:
// wgmma, TMA, copy engines for the pushes.

#include "tdt_flash.cuh"
#include "tdt_tp.cuh"

namespace {

using namespace tdt_flash;

constexpr int MAX_RANKS = 8;
constexpr int MAX_CHUNKS = 16;   // signals a source, at most

// KV rows one signal guards: whole BK-row tiles, at most MAX_CHUNKS chunks
// a source.
int chunk_rows_of(int S) {
  const int tiles = (S + BK - 1) / BK;
  return BK * ((tiles + MAX_CHUNKS - 1) / MAX_CHUNKS);
}

struct Params {
  const __nv_bfloat16* q;   // (n, S, H, D)
  const __nv_bfloat16* k;   // (n, S, Hkv, D)
  const __nv_bfloat16* v;
  const int* qmeta;         // (n, meta_rows, 128) or null
  __nv_bfloat16* out;       // (n, S, H, D)
  TdtPeers peers;           // rank r's region: (2, n, S, Hkv, D)
  int S, H, Hkv, meta_rows, causal, chunk_rows;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS) sp_ag_kernel(Params p) {
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  if (tdt_faulted(p.peers)) return;
  const int n = p.peers.n;
  const int S = p.S, H = p.H, Hkv = p.Hkv;
  const unsigned epoch = p.peers.epoch;
  const int nchunk = (S + p.chunk_rows - 1) / p.chunk_rows;
  const int nqt = (S + BQ - 1) / BQ;
  const size_t shard = static_cast<size_t>(S) * Hkv * D;   // elements
  const long long n_push = static_cast<long long>(n) * (n - 1) * nchunk;
  const long long n_cons = static_cast<long long>(n) * H * nqt;
  const long long total = n + n_push + n_cons;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;

  for (long long it = blockIdx.x; it < total; it += gridDim.x) {
    if (it < n) {   // barrier_all: rank `it` arrives
      if (threadIdx.x == 0) tdt_barrier_arrive(p.peers);
      continue;
    }
    if (it < n + n_push) {
      // push of rank me's chunk c to peer me + 1 + i
      const long long j = it - n;
      const int me = static_cast<int>(j / ((n - 1) * nchunk));
      const int i = static_cast<int>(j / nchunk % (n - 1));
      const int c = static_cast<int>(j % nchunk);
      const int peer = (me + 1 + i) % n;
      if (p.causal && peer < me) continue;   // it never reads my shard
      if (!tdt_cta_wait(p.peers, me, TDT_PAD_BARRIER, 0, 1, epoch * n))
        return;
      const int r0 = c * p.chunk_rows;
      const int rows = min(p.chunk_rows, S - r0);
      const size_t off = static_cast<size_t>(r0) * Hkv * D;
      const size_t bytes = static_cast<size_t>(rows) * Hkv * D * 2;
      __nv_bfloat16* land = p.peers.region<__nv_bfloat16>(peer);
      tdt_cta_copy(land + me * shard + off, p.k + me * shard + off, bytes);
      tdt_cta_copy(land + (n + me) * shard + off, p.v + me * shard + off,
                   bytes);
      tdt_cta_release();
      if (threadIdx.x == 0) tdt_signal(p.peers, peer, 1 + me * nchunk + c);
      continue;
    }
    // consumer item, heaviest first: key = r * nqt + qt descending
    const long long j = it - n - n_push;
    const long long key = static_cast<long long>(n) * nqt - 1 - j / H;
    const int h = static_cast<int>(j % H);
    const int r = static_cast<int>(key / nqt), qt = static_cast<int>(key % nqt);
    const int hk = h / (H / Hkv);
    const int q0 = qt * BQ;
    const int row0 = q0 + warp * 16 + g;
    const int q_off = r * S;
    const int q_last = min(q0 + BQ, S) - 1;
    const size_t q_stride = static_cast<size_t>(H) * D;
    const size_t kv_stride = static_cast<size_t>(Hkv) * D;
    const bool varlen = p.qmeta != nullptr;
    RowSegments rs{};
    if (varlen)
      rs = row_segments(p.qmeta + static_cast<size_t>(r) * p.meta_rows * 128,
                        row0, S);

    const __nv_bfloat16* qr = p.q + static_cast<size_t>(r) * S * q_stride;
    auto qrow = [&](int row) -> const __nv_bfloat16* {
      return row < S ? qr + row * q_stride + static_cast<size_t>(h) * D
                     : nullptr;
    };
    uint32_t qa[D / 16][4];
    load_q<D>(qa, qrow(row0), qrow(row0 + 8), t4, 1.f);
    float o[D / 8][4];
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
    float m_run[2] = {TDT_NEG_INF, TDT_NEG_INF};
    float l_run[2] = {0.f, 0.f};

    bool ok = true;
    for (int step = 0; step < n && ok; ++step) {
      const int s = (r + step) % n;
      if (p.causal && s > r) continue;   // wholly in the future: never sent
      const int kv_off = s * S;
      long long c_lo = 0, c_hi = S;
      if (varlen) {
        c_lo = max(0LL, static_cast<long long>(rs.lo) - kv_off);
        c_hi = min(c_hi, static_cast<long long>(rs.hi) - kv_off);
      }
      if (p.causal)
        c_hi = min(c_hi, static_cast<long long>(q_off) + q_last - kv_off + 1);
      if (c_hi <= c_lo) continue;
      const int t0 = static_cast<int>(c_lo / BK);
      const int t1 = static_cast<int>((c_hi + BK - 1) / BK);
      const __nv_bfloat16 *kb, *vb;
      if (s == r) {
        kb = p.k + r * shard;
        vb = p.v + r * shard;
      } else {
        const __nv_bfloat16* land = p.peers.region<__nv_bfloat16>(r);
        kb = land + s * shard;
        vb = land + (n + s) * shard;
      }
      int waited = -1;
      auto ready = [&](int tile) {
        if (s == r) return true;
        const int chunk = tile * BK / p.chunk_rows;
        if (chunk == waited) return true;
        waited = chunk;
        return tdt_cta_wait(p.peers, r, 1 + s * nchunk + chunk, 0, 1, epoch);
      };
      auto seen = [&](int rr, int c) {
        const int col = kv_off + c;
        return c < S && (!p.causal || col <= q_off + row0 + rr * 8) &&
               (!varlen ||
                (col >= rs.seg[rr].start && col < rs.seg[rr].end));
      };
      auto full = [&](int c0) {
        return c0 + BK <= S &&
               (!p.causal || kv_off + c0 + BK - 1 <= q_off + q0 + warp * 16) &&
               (!varlen ||
                (rs.wlo <= kv_off + c0 && rs.whi >= kv_off + c0 + BK));
      };
      ok = walk_tiles<D, true>(qa, o, m_run, l_run, smem, kb + hk * D,
                               vb + hk * D, kv_stride, S, t0, t1, p.scale,
                               seen, full, ready);
    }
    if (!ok) return;   // a lost signal: the fault word names it

    __nv_bfloat16* outr = p.out + static_cast<size_t>(r) * S * q_stride;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float l = row_denominator(l_run[rr]);
      const int row = row0 + rr * 8;
      if (row < S)
        store_row<D>(outr + row * q_stride + static_cast<size_t>(h) * D, o, rr,
                     l, t4);
    }
  }
}

template <int D>
int launch(const Params& p, int grid, cudaStream_t st) {
  const long long nchunk = (p.S + p.chunk_rows - 1) / p.chunk_rows;
  const long long items = p.peers.n + static_cast<long long>(p.peers.n) *
                                          (p.peers.n - 1) * nchunk +
                          static_cast<long long>(p.peers.n) * p.H *
                              ((p.S + BQ - 1) / BQ);
  return tdt_tp::launch_persistent_smem(sp_ag_kernel<D>, items, grid,
                                        smem_bytes<D>(), st, p);
}

}  // namespace

// q / out (n, S, H, D), k / v (n, S, Hkv, D): bf16, contiguous, 16-byte
// aligned; qmeta (n, meta_rows, 128) int32 with meta_rows >= S, or null;
// land / pads: device arrays of n addresses of the ranks' (2, n, S, Hkv, D)
// bf16 landing regions and u32 pads of 1 + n * ceil(S / chunk_rows) slots,
// chunk_rows = tdt_sp_ag_chunk_rows(S); fault: 4 int32. grid 0 sizes the
// persistent grid by occupancy; a grid that could not be co-resident is
// refused.
extern "C" int tdt_sp_ag_attention(
    const void* q, const void* k, const void* v, const void* qmeta, void* out,
    const void* land, const void* pads, void* fault, unsigned epoch,
    long long budget_ns, int n, int S, int H, int Hkv, int D, int meta_rows,
    int causal, float scale, int grid, void* stream) {
  if (n < 1 || n > MAX_RANKS || S < 1 || H < 1 || Hkv < 1 || H % Hkv ||
      grid < 0 || (qmeta != nullptr && meta_rows < S))
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunk_rows = chunk_rows_of(S);
  const Params p{static_cast<const __nv_bfloat16*>(q),
                 static_cast<const __nv_bfloat16*>(k),
                 static_cast<const __nv_bfloat16*>(v),
                 static_cast<const int*>(qmeta),
                 static_cast<__nv_bfloat16*>(out),
                 TdtPeers{static_cast<const unsigned long long*>(land),
                          static_cast<const unsigned long long*>(pads),
                          static_cast<int*>(fault), epoch, budget_ns, n},
                 S, H, Hkv, meta_rows, causal, chunk_rows, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch<128>(p, grid, st);
  if (D == 64) return launch<64>(p, grid, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// KV rows one signal of the kernel guards at shard length S (the pad's
// layout, for the host's workspace and its fault messages).
extern "C" int tdt_sp_ag_chunk_rows(int S) { return chunk_rows_of(S); }

// How many CTAs of the kernel at head_dim D can be resident on the current
// device (-1 on an error).
extern "C" int tdt_sp_ag_attention_resident(int D) {
  if (D == 128) return tdt_tp::max_resident(sp_ag_kernel<128>, smem_bytes<128>());
  if (D == 64) return tdt_tp::max_resident(sp_ag_kernel<64>, smem_bytes<64>());
  return -1;
}
