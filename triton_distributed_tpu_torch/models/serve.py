"""Continuous-batching serving engine over the ragged paged KV cache
(counterpart of triton_distributed_tpu/models/serve.py).

A fixed array of `b_max` SLOTS, an admission queue, and one decode step
shaped (b_max, ...) with occupancy as an active mask, so sequences
enter and leave the batch independently. One `_tick`:
  1. admit — the QoS pick (SLO class > priority > weighted tenant
     fairness > FIFO by arrival id) takes a free slot, preempting a
     strictly-lower-class resident when none is free, with its radix
     prefix match mapped in (refcount bumps; a full-prompt hit clones
     its last block copy-on-write; LRU reclaim of refcount-0 cached
     blocks relieves pool pressure before the queue backpressures);
  2. prefill — one chunk (`prefill_chunk` tokens) of one admitted
     prompt (DenseLLM.prefill_chunk_paged); the final chunk emits the
     request's first token;
  3. decode — every in-flight sequence advances one token in one call
     (DenseLLM.decode_step_paged), each at its own length; finished
     sequences release their pages into the prefix cache or the free
     list.

Every scheduling decision is a transition of serve_state.py, the JAX
package's control plane carried over unchanged; this class executes
those decisions against the real allocator (`PagedKVCache`, through
`_CachePool`) and the model's steps. The same submit stream therefore
gives the same admissions, grants, block tables and (greedy) tokens as
the JAX engine.

Sampling (temperature > 0) draws from a torch.Generator re-seeded from
(`seed`, step) at every prefill chunk and decode tick, as the JAX
engine folds the step into its key: a request's sampled stream depends
on the batch composition, and differs from the JAX engine's by
construction (another RNG).

`mode="megakernel"` (a one-rank dense model or Qwen3MoE, or a dense
model at `tp_ranks` = its n ranks) moves decode
onto the persistent megakernel (megakernel/serve.py::MegaServe): each
decode tick is ONE launch of csrc/megakernel.cu for the whole active
batch, with paged attention and the paged appends reading and writing
each slot's pages through the block table inside it. Prefill stays on
the engine path; on a slot's final prefill chunk its pages are handed
off into the megakernel's pool at the same page ids. The scheduler runs
with `base_path="megakernel"`, so megakernel slots are admitted without
prefix sharing and retain only their prefill-written blocks in the
prefix cache (their decode rows live in the megakernel's pool). On a
CUDA model the tick launches the kernel or raises (a scoreboard fault
raises through `check_fault`); on a CPU model the same program runs
its plain queue walk. `mk_opts` passes MegaServe's options (`slot_rows`).

A Qwen3MoE model serves unchanged (its steps route rows through the
experts; in megakernel mode the program's GROUPED_GEMM tasks do).
`ep_capacity` > 0 arms the per-tick expert-dispatch row budget:
`serve_state.partition_capacity` defers whole slots past it (oldest
progress first), so a routing storm becomes an explicit deferral, never
a silent drop; `stats()` counts the deferred slot-ticks
(`capacity_drops`), the rows dispatched (`ep_rows`) and the last tick's
live-occupancy EP plan (`ep_plan`). The partition runs before the
decode paths split, so a deferred megakernel slot leaves the launch's
mask and rides it on its trash page at width 0, routing to no expert.

`speculative=True | dict | SpecConfig(...)` (greedy only) turns each
decode tick into draft-verify-rollback: a drafter (models/spec.py)
proposes up to k-1 tokens a slot, ONE verify step scores every slot's
candidates (DenseLLM.verify_step_paged: the paged decode kernel over
B x K queries; in megakernel mode MegaServe.verify: one launch at
per-slot widths), the host keeps the greedy-accepted prefix plus the
bonus token, and `serve_state.rollback_spec` trims the rejected rows
through `PagedKVCache.truncate_slot`, a block-table edit. Width 1 is the
decode step, so spec-on tokens equal spec-off tokens. `adapt=True` picks
each slot's width per tick with perf_model.choose_spec_k. In megakernel
mode the width is also clamped to the page room, slot_rows - cache_len %
slot_rows (the JAX rule), and MegaServe gets slot_rows 8 unless mk_opts
names it. There every tick runs b_max x slot_rows trunk rows whatever
the widths, on the SIMT LINEAR tiles, so megakernel-mode speculation is
at present 3 to 4 times slower than spec-off on Qwen3-8B (NVIDIA H100
80GB HBM3, 700 W; PERF.md §5, ROADMAP Queue A 7), k=1 ticks included.

Multi-rank serving, n ranks in one process on one device:
- `tp_ranks=n` over a DenseLLM(num_ranks=n): the model's own steps span
  the ranks (head-sharded pool, one attention launch for the n ranks,
  each projection ending in psum or, in mode "gemm_ar", the gemm_ar
  kernel). The control plane stays one SchedulerState: every decision is
  applied once, to the one allocator (page ids are global), and mirrored
  as the same edit on each rank's `serve_state.RankLedger`; the ledgers'
  divergence check runs at the end of every tick, and `stats()["per_rank"]`
  reports each rank's row (JAX serve.py:359-395, :1205-1234).
  At n ranks every model step's tokens pass the communication kernels'
  fault check (shmem.check_faults) before they are emitted, as Engine's
  do. With `mode="megakernel"` the decode and verify ticks are one launch
  of every rank's program (MegaServe at tp_ranks=n), prefill stays on the
  model's own n-rank steps, and each rank's row of `per_rank` counts the
  bytes its AR tasks pushed (`ar_bytes_pushed`, JAX serve.py:1078-1090).
- A DenseLLM(num_ranks=n, attn_parallelism="sp", sp_combine=...) serves
  sequence-parallel: the pool is sequence-sharded, a grant is all or
  nothing per rank, and the scheduler runs with `sp_ranks=n`. The engine
  inherits the model's parallelism and combine and keeps the JAX engine's
  refusals: the megakernel, speculation and the prefix cache under "sp",
  and geometry that does not split over the ranks (ValueError).

- A Qwen3MoE(num_ranks=n) serves at `tp_ranks=n` on the head-sharded
  pool like a dense model, its experts tensor- or expert-parallel. Every
  paged step takes replicated rows, so EP experts run
  `EPMoE.decode_rows_shard` (each rank its own experts' share, then a
  psum; no all-to-all), as the JAX model's `_mlp_rows` does under its
  decode MLP mode. `ep_plan` at n records the plan the layer takes
  (perf_model.ep_tick_plan). The megakernel refuses MoE at n, as in JAX.

Not in this slice (each raises NotImplementedError): the watchdog
(`slo_ticks`) and fault injection (`chaos`), the host spill tier
(`host_blocks`) and the plain ("xla") attention rung on a CUDA device
(slice 2c).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import perf_model
from ..ops import wire
from ..shmem import check_faults
from . import serve_state
from .engine import pow2_bucket
from .paged_kv_cache import PagedKVCache
from .serve_state import SLO_CLASSES, Request, SchedCfg, SchedulerState
from .spec import SpecConfig

# MegaServe's slot_rows under speculation when mk_opts names none: the
# JAX package's f32 tile (megakernel/serve.py:100), so the page-room
# clamp, slot_rows - cache_len % slot_rows, gives the JAX engine's widths
SPEC_SLOT_ROWS = 8


class _CachePool:
    """The pool protocol the serve_state transitions drive (grant /
    release / reclaim / refcnts / free_count / row), landing on the
    engine's `PagedKVCache`, with each edit mirrored on the per-rank
    ledgers at tp_ranks > 1. The allocator state lives on the host, so
    none of these calls waits on the device."""

    def __init__(self, eng):
        self._e = eng

    def grant(self, i, plan):
        e = self._e
        n = e.sched.cfg.sp_ranks
        if n > 1:
            # the sequence-sharded pool grants all or nothing per rank;
            # prefix plans never come here (refused at construction)
            return () if e._cache.assign_slot(i, plan.n_new, sp_ranks=n) \
                else None
        ok, new = e._cache.assign_slot_prefixed(
            i, shared=plan.shared, n_new=plan.n_new, cow_src=plan.cow_src,
            seq_len=plan.start)
        if not ok:
            return None                # the request stays queued
        if e._rledger is not None:
            # page ids are global: the same row on every rank's ledger
            e._rledger.set_row(i, self.row(i), plan.start)
        return new

    def release(self, i, quarantining=False, cached=()):
        # nothing quarantines without the watchdog (slice 2c), which
        # brings back the JAX engine's conservation check on that path
        e = self._e
        e._cache.free_slot(i, cached=cached)
        if e._rledger is not None:
            e._rledger.release(i)

    def reclaim(self, ids):
        self._e._cache.reclaim_blocks(ids)

    def truncate(self, i, new_len):
        """The speculative rollback: trim slot i's cached length to
        new_len as a block-table edit. The slot keeps its upfront grant
        (min_blocks: the request still owes tokens into those columns),
        and the radix cache's membership rides along as in free_slot."""
        e = self._e
        s = e.sched.slots[i]
        keep = (serve_state.blocks_for(e.sched.cfg, s.req)
                if s.req is not None else 0)
        pfx = e.sched.prefix
        cached = tuple(pfx.blocks) if pfx is not None else ()
        freed = e._cache.truncate_slot(i, new_len, cached=cached,
                                       min_blocks=keep)
        if e._rledger is not None:
            e._rledger.set_row(i, self.row(i), new_len)
        return freed

    def refcnts(self):
        return self._e._cache.ref_counts.copy()

    def free_count(self):
        return self._e._cache.num_free_blocks

    def row(self, i):
        return tuple(int(b) for b in self._e._cache.block_table[i] if b >= 0)

    def _cached_only(self):
        """Radix-retained blocks currently at refcount 0."""
        pfx = self._e.sched.prefix
        if pfx is None or not pfx.blocks:
            return 0
        refs = self._e._cache.ref_counts
        return sum(1 for b in pfx.blocks if refs[b] == 0)


def prefix_bucket(off: int, block: int, cap: int) -> int:
    """The JAX engine's static gather size for an `off`-token cached
    prefix (pow-2 bucket, block floor, block multiple, clamped to the
    slot ceiling). The port compiles nothing per shape and gathers
    exactly ceil(off / block) pages; the rule is kept so tests can
    drive both packages' chunked prefill alike."""
    if off <= 0:
        return 0
    b = pow2_bucket(off, block, cap)
    return min(-(-b // block) * block, cap)


# -- tolerance-banded token identity -----------------------------------------
# A quantized KV pool cannot claim bit-identical greedy streams: where the
# top-2 logit margin sits below the quantization noise the argmax flips,
# and past a flip two runs decode different contexts. The claimable form:
# streams agree exactly up to each request's first divergence, and the
# agreed fraction of steps clears a per-dtype floor.
TOKEN_BAND = {"int8": 0.25, "float8_e4m3fn": 0.5}


def banded_token_identity(ref: dict, got: dict,
                          kv_dtype: str | None = None,
                          band: float | None = None) -> dict:
    """Assert greedy-token identity between two run() result dicts
    under the tolerance-band policy; returns the agreement report.
    kv_dtype=None (or band=0) demands exact identity."""
    if set(ref) != set(got):
        raise ValueError(
            f"banded_token_identity: request sets differ — "
            f"ref {sorted(ref)} vs got {sorted(got)}")
    if band is None:
        band = TOKEN_BAND[kv_dtype] if kv_dtype is not None else 0.0
    agreed = total = 0
    diverged = {}
    for rid in sorted(ref):
        a, b = np.asarray(ref[rid]), np.asarray(got[rid])
        if a.shape != b.shape:
            raise ValueError(
                f"banded_token_identity: request {rid} stream length "
                f"{b.shape} != reference {a.shape} — divergence never "
                f"changes how many tokens a request owes")
        ne = np.flatnonzero(a != b)
        d = int(ne[0]) if ne.size else len(a)
        agreed += d
        total += len(a)
        if d < len(a):
            diverged[rid] = d
    frac = agreed / total if total else 1.0
    if frac < 1.0 - band:
        raise ValueError(
            f"banded_token_identity: agreed {agreed}/{total} steps "
            f"({frac:.3f}) below the {kv_dtype or 'exact'} band floor "
            f"{1.0 - band:.3f}; first divergences {diverged}")
    return {"agreed_steps": agreed, "total_steps": total,
            "agreed_frac": round(frac, 4), "band": band,
            "diverged": diverged}


def _not_in_slice(what: str, where: str):
    raise NotImplementedError(
        f"{what} is not ported yet: it comes with {where} (ROADMAP.md, "
        f"Queue A)")


class ServeEngine:
    """Continuous batching over `b_max` slots for a `DenseLLM` (one rank,
    n tensor-parallel ranks, or n sequence-parallel ranks) or a `Qwen3MoE`
    (one rank, or n ranks with tensor- or expert-parallel experts). Decode
    attention reads the pages in place through the block table
    (ops/attention.flash_decode_paged: the CUDA kernel on the GPU, its
    plain version on the CPU), or, with mode="megakernel", inside the
    megakernel's one launch per tick."""

    def __init__(self, model, params, *, b_max: int = 4,
                 max_len: int = 2048, block: int = 128,
                 num_blocks: int | None = None, prefill_chunk: int = 256,
                 attn_method: str | None = None,
                 temperature: float = 0.0, top_k: int = 50,
                 seed: int = 0, mode: str | None = None,
                 mk_opts: dict | None = None,
                 slo_ticks: int | None = None, max_faults: int = 3,
                 backoff_ticks: int = 2, backoff_cap: int = 16,
                 chaos=None, prefix_cache: bool | None = None,
                 tenant_weights: dict | None = None,
                 preemption: bool = True, speculative=None,
                 attn_parallelism: str | None = None,
                 sp_combine: str | None = None,
                 ep_capacity: int = 0,
                 kv_dtype: str | None = None,
                 host_blocks: int = 0,
                 tp_ranks: int = 1):
        if chaos is not None or slo_ticks is not None \
                or (max_faults, backoff_ticks, backoff_cap) != (3, 2, 16):
            _not_in_slice("the serving watchdog (slo_ticks, chaos, "
                          "max_faults, backoff_ticks, backoff_cap)",
                          "slice 2c")
        if host_blocks:
            _not_in_slice("the host spill tier (host_blocks)", "slice 2c")
        if mode not in (None, "engine", "megakernel"):
            raise ValueError(f"mode={mode!r}: choose 'engine' or "
                             f"'megakernel'")
        self.mode = mode or "engine"
        if mk_opts is not None and self.mode != "megakernel":
            raise ValueError("mk_opts configures mode='megakernel'")
        # the engine inherits the model's parallelism and combine: naming
        # another one cannot re-shard the model, so it is refused
        model_ap = getattr(model, "attn_parallelism", "tp")
        if attn_parallelism is None:
            attn_parallelism = model_ap
        if attn_parallelism not in ("tp", "sp"):
            raise ValueError(
                f"attn_parallelism={attn_parallelism!r}: choose 'tp' "
                f"(head-sharded) or 'sp' (sequence-sharded)")
        if attn_parallelism != model_ap:
            raise ValueError(
                f"attn_parallelism={attn_parallelism!r} but the model "
                f"was built with {model_ap!r} — the engine inherits "
                f"the model's parallelism; rebuild the model or drop "
                f"the kwarg")
        self.attn_parallelism = attn_parallelism
        model_comb = getattr(model, "sp_combine", "xla")
        if sp_combine is not None and sp_combine != model_comb:
            raise ValueError(
                f"sp_combine={sp_combine!r} but the model was built "
                f"with sp_combine={model_comb!r} — the combine kernel "
                f"is compiled into the model's decode step")
        self.sp_combine = model_comb
        if isinstance(tp_ranks, bool) \
                or not isinstance(tp_ranks, (int, np.integer)) \
                or tp_ranks < 1:
            raise ValueError(f"tp_ranks must be a positive integer, got "
                             f"{tp_ranks!r}")
        tp_ranks = int(tp_ranks)
        if tp_ranks > 1:
            if attn_parallelism != "tp":
                raise ValueError(
                    "tp_ranks > 1 is the head-sharded deployment; "
                    "attn_parallelism='sp' shards sequences (sp_ranks) "
                    "instead — the two cannot compose")
            if int(model.n) != tp_ranks:
                raise ValueError(
                    f"tp_ranks={tp_ranks} but the model spans "
                    f"{int(model.n)} mesh rank(s) — build the model on "
                    f"{tp_ranks} ranks (the engine deploys the model's "
                    f"own ranks)")
        self.tp_ranks = tp_ranks
        if attn_parallelism == "sp":
            # the sequence-sharded layout fixes the geometry: every rank
            # owns an equal slice of each slot's positions, and a prefill
            # chunk stays inside one rank's slice
            n = int(model.n)
            if self.mode == "megakernel":
                raise ValueError(
                    "mode='megakernel' is tp-only: the persistent "
                    "kernel's pool is not sequence-sharded; use "
                    "mode='engine' with attn_parallelism='sp'")
            if speculative is not None:
                raise ValueError(
                    "speculative decoding is tp-only: multi-token "
                    "verify/rollback is not supported under "
                    "attn_parallelism='sp'; set speculative=None")
            if prefix_cache:
                raise ValueError(
                    "prefix_cache=True is tp-only: a radix hit would "
                    "map cached blocks into table columns another rank "
                    "owns; serve attn_parallelism='sp' with "
                    "prefix_cache=False (or leave it unset)")
            if max_len % (n * block):
                raise ValueError(
                    f"max_len={max_len} does not split over {n} ranks "
                    f"of {block}-token pages — pad max_len to a "
                    f"multiple of sp_ranks*block={n * block}")
            rank_tokens = (max_len // block // n) * block
            if prefill_chunk % n:
                raise ValueError(
                    f"prefill_chunk={prefill_chunk} does not split "
                    f"over {n} ranks — the SP chunk runs {n} "
                    f"rank-local slices through the ring")
            if rank_tokens % prefill_chunk:
                raise ValueError(
                    f"prefill_chunk={prefill_chunk} does not divide "
                    f"rank_tokens={rank_tokens}: a chunk would cross "
                    f"a rank ownership boundary mid-write")
            pool_blocks = (num_blocks if num_blocks is not None
                           else b_max * (max_len // block))
            if pool_blocks % n:
                raise ValueError(
                    f"num_blocks={pool_blocks} does not split over "
                    f"{n} ranks — each rank holds an equal pool slice")
            # the radix tree is tp-only: "auto" is off under sp
            prefix_cache = False if prefix_cache is None else prefix_cache
        if attn_method not in (None, "kernel", "xla"):
            raise ValueError(f"attn_method={attn_method!r}: choose "
                             f"'kernel' or 'xla'")
        if attn_method == "xla" and model.device.type != "cpu":
            _not_in_slice("attn_method='xla' on a CUDA device (the "
                          "watchdog's plain-attention rung)", "slice 2c")
        for t, w in (tenant_weights or {}).items():
            if not isinstance(t, str) or not t:
                raise ValueError(
                    f"tenant_weights keys must be non-empty strings, "
                    f"got {type(t).__name__} {t!r}")
            if isinstance(w, bool) or not isinstance(
                    w, (int, float, np.integer, np.floating)) or w <= 0:
                raise ValueError(
                    f"tenant_weights[{t!r}] must be a positive "
                    f"number, got {w!r}")
        self.model = model
        self.params = params
        self.b_max = b_max
        self.max_len = max_len
        self.block = block
        self.num_blocks = num_blocks
        self.prefill_chunk = prefill_chunk
        self.attn_method = attn_method
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.seed = seed
        self.kv_dtype = wire.resolve_wire_dtype(kv_dtype)
        # speculative decoding: every decode tick feeds each slot's last
        # token plus up to k-1 drafts through ONE verify step
        # (DenseLLM.verify_step_paged, or MegaServe.verify), emits the
        # greedy-accepted prefix plus the bonus token and rolls rejected
        # rows back as a block-table edit; greedy only
        if speculative is True:
            speculative = SpecConfig()
        elif isinstance(speculative, dict):
            speculative = SpecConfig(**speculative)
        elif speculative is not None \
                and not isinstance(speculative, SpecConfig):
            raise ValueError(
                f"speculative must be None/True/dict/SpecConfig, got "
                f"{type(speculative).__name__}")
        if speculative is not None and self.temperature > 0.0:
            raise ValueError(
                "speculative decoding is greedy-only (the accept rule "
                "is argmax == draft); set temperature=0")
        self.spec = speculative
        self._spec_ewma: dict = {}      # rid -> acceptance EWMA
        self._spec_ctx: dict = {}       # rid -> (context buffer, filled)
        # MoE continuous batching: ep_capacity > 0 arms the per-tick
        # expert-dispatch row budget; the model's guard refuses at
        # construction what one engine step could route past an explicit
        # expert capacity
        self._is_moe = bool(getattr(model.config, "is_moe", False))
        if ep_capacity and not self._is_moe:
            raise ValueError(
                f"ep_capacity={ep_capacity} needs a MoE model: dense "
                f"decode routes no experts, so the budget would only "
                f"defer slots for nothing")
        cap_guard = getattr(model, "check_serving_capacity", None)
        if cap_guard is not None:
            cap_guard(b_max, prefill_chunk=prefill_chunk,
                      spec_k=(self.spec.k if self.spec is not None else 0),
                      ep_capacity=int(ep_capacity))
        self._cap_ledger = (serve_state.CapacityLedger(int(ep_capacity))
                            if ep_capacity else None)
        self.ep_plan: dict | None = None    # last tick's live EP plan
        self.sched = SchedulerState.create(SchedCfg(
            b_max=b_max, block=block, prefill_chunk=prefill_chunk,
            base_path=self.mode,
            prefix_caching=True if prefix_cache is None
            else bool(prefix_cache),
            tenant_weights=tuple(sorted((tenant_weights or {}).items())),
            preemption=bool(preemption),
            spec_k=(self.spec.k if self.spec is not None else 0),
            sp_ranks=(int(model.n) if attn_parallelism == "sp" else 1),
            ep_capacity=int(ep_capacity), tp_ranks=tp_ranks))
        # the per-rank block ledgers and their divergence check (fresh
        # each run)
        self._rledger = (serve_state.RankLedger(tp_ranks, b_max)
                         if tp_ranks > 1 else None)
        # the megakernel path's AR bytes a rank has pushed (tp_ranks > 1)
        self._ar_bytes = [0] * tp_ranks
        self._pool = _CachePool(self)
        self._cache: PagedKVCache | None = None
        self._running = False
        self._budget_extra = 0
        self._next_rid = 0
        self._run_wall_s = 0.0
        self._run_t0 = 0.0
        self._pool_blocks = (num_blocks if num_blocks is not None
                             else b_max * (-(-max_len // block)))
        self._steps = {"decode": 0, "prefill_prefix": 0, "megakernel": 0}
        self._mk = None
        if self.mode == "megakernel":
            from ..megakernel.serve import MegaServe
            mk_opts = dict(mk_opts or {})
            if self.spec is not None:
                # the verify candidates ride the slot's own trunk rows
                mk_opts.setdefault("slot_rows", SPEC_SLOT_ROWS)
            self._mk = MegaServe(model, params, b_max=b_max,
                                 max_len=max_len, block=block,
                                 num_blocks=self._pool_blocks,
                                 tp_ranks=tp_ranks, **mk_opts)
        # programs built per role (the JAX engine's jit traces): the
        # megakernel program once per engine, for decode or, with
        # speculation, for verify; the engine path builds none
        mk = self._mk is not None
        self.trace_counts = {"decode": int(mk and self.spec is None),
                             "prefill": 0,
                             "verify": int(mk and self.spec is not None)}

    # -- control-plane views (the SchedulerState is the truth) -----------
    @property
    def queue(self):
        return self.sched.queue

    @property
    def _slots(self):
        return self.sched.slots

    # -- request intake ---------------------------------------------------
    def submit(self, prompt_ids, gen_len: int, *,
               tenant: str = "default", slo_class: str = "batch",
               priority: int = 0, rid: int | None = None) -> int:
        """Queue one request; returns its arrival id. Malformed requests
        are refused here, before they reach the scheduler."""
        raw = np.asarray(prompt_ids)
        if raw.size == 0:
            raise ValueError("empty prompt: at least one token id is "
                             "required")
        if not np.issubdtype(raw.dtype, np.integer):
            raise ValueError(
                f"prompt_ids must be integer token ids, got dtype "
                f"{raw.dtype}")
        ids = raw.astype(np.int32).reshape(-1)
        if isinstance(gen_len, bool) \
                or not isinstance(gen_len, (int, np.integer)):
            raise ValueError(
                f"gen_len must be an integer, got "
                f"{type(gen_len).__name__} {gen_len!r}")
        if gen_len < 1:
            raise ValueError(f"gen_len must be >= 1, got {gen_len}")
        total = len(ids) + gen_len
        if total > self.max_len:
            raise ValueError(f"{len(ids)}+{gen_len} exceeds per-slot "
                             f"max_len={self.max_len}")
        need = -(-total // self.block)
        if need > self._pool_blocks:
            raise ValueError(
                f"request needs {need} blocks but the pool only has "
                f"{self._pool_blocks}; raise num_blocks or max_len")
        sp = self.sched.cfg.sp_ranks
        if sp > 1:
            # the per-rank form of the same guard: rank 0 serves the first
            # bpr table columns, so its share of the request is the largest
            bpr = (self.max_len // self.block) // sp
            nb_loc = self._pool_blocks // sp
            if min(need, bpr) > nb_loc:
                raise ValueError(
                    f"request needs {min(need, bpr)} blocks from rank "
                    f"0's slice but each rank only holds {nb_loc}; "
                    f"raise num_blocks or shorten the request")
        if not isinstance(tenant, str) or not tenant:
            raise ValueError(
                f"tenant must be a non-empty string, got "
                f"{type(tenant).__name__} {tenant!r}")
        if slo_class not in SLO_CLASSES:
            raise ValueError(
                f"unknown slo_class {slo_class!r}; choose from "
                f"{SLO_CLASSES}")
        if isinstance(priority, bool) \
                or not isinstance(priority, (int, np.integer)):
            raise ValueError(
                f"priority must be an integer, got "
                f"{type(priority).__name__} {priority!r}")
        if rid is None:
            rid = self._next_rid
        else:
            if isinstance(rid, bool) \
                    or not isinstance(rid, (int, np.integer)):
                raise ValueError(
                    f"rid must be an integer, got "
                    f"{type(rid).__name__} {rid!r}")
            rid = int(rid)
            if rid < self._next_rid:
                raise ValueError(
                    f"duplicate or non-monotone rid {rid}: arrival "
                    f"ids must be fresh and increasing (next free is "
                    f"{self._next_rid}) — requeue ordering is FIFO by "
                    f"arrival id")
        self._next_rid = rid + 1
        self.sched.queue.append(Request(
            rid, ids, int(gen_len), tenant=tenant, slo=slo_class,
            priority=int(priority)))
        if self._running:
            # a mid-run arrival (from a stream_cb) extends the drain
            # loop's progress budget
            self._budget_extra += 16 * (
                len(ids) // self.prefill_chunk + int(gen_len) + 2)
        return rid

    # -- scheduler --------------------------------------------------------
    def _emit(self, i: int, tok: int, stream_cb):
        s = self._slots[i]
        serve_state.emit(self.sched, i, tok)
        if self._rledger is not None:
            self._rledger.emit(i)
        if stream_cb is not None:
            stream_cb(s.req.rid, tok, len(s.out) - 1)

    def _admit(self):
        pre = self.sched.counters["preempted"]
        serve_state.admit(self.sched, self._pool)
        for _ in range(self.sched.counters["preempted"] - pre):
            # a preempted request re-runs from its cached prefix; the
            # drain budget must cover the retry's ticks
            self._budget_extra += 16 * (
                self.max_len // self.prefill_chunk
                + self.max_len // self.block + 2)

    def _checked(self, out):
        """`out`, once no communication kernel has recorded a fault (a
        fault raises here; synchronises at n > 1 ranks)."""
        if self.model.n > 1:
            check_faults()
        return out

    def _generator(self):
        """The step's generator, re-seeded from (seed, step) when
        sampling; None for greedy."""
        self._step += 1
        if self.temperature <= 0.0:
            return None
        return self._gen.manual_seed(
            (self.seed * 1_000_003 + self._step) % (1 << 62))

    def _prefill_tick(self, stream_cb):
        i = serve_state.pick_prefill(self.sched)
        if i is None:
            return
        s = self._slots[i]
        C = self.prefill_chunk
        off, valid = serve_state.prefill_args(self.sched, i)
        chunk = np.zeros((C,), np.int32)
        chunk[:valid] = s.req.ids[off:off + valid]
        tok, self._cache = self.model.prefill_chunk_paged(
            self.params, chunk, self._cache, i, off, valid,
            generator=self._generator(),
            sampling=self.temperature > 0.0, temperature=self.temperature,
            top_k=self.top_k)
        tok = self._checked(tok)
        self._steps["prefill_prefix"] += off > 0
        if serve_state.prefill_advance(self.sched, i, valid):
            # final chunk: the first generated token; a megakernel slot's
            # pages move into the megakernel's pool once, at the same ids
            if self._mk is not None and s.path == "megakernel":
                self._mk.handoff(self._cache, i)
            self._emit(i, int(tok), stream_cb)
            self._maybe_finish(i, stream_cb)

    def _decode_tick(self, stream_cb):
        live = serve_state.decode_live(self.sched)
        if not live:
            return
        # the expert-capacity budget partitions the live batch first:
        # deferred slots vanish from this tick's mask with their state,
        # pages and stream untouched (they sort first next tick); the
        # first slot always fits, so a non-empty batch serves someone
        if self.sched.cfg.ep_capacity:
            live, _deferred = serve_state.partition_capacity(
                self.sched, live, self._cap_ledger)
        if self._is_moe:
            # the EP plan at the rows this tick routes (live occupancy),
            # recorded for stats()
            c = self.model.config
            rows = sum(serve_state.capacity_rows(self.sched, i)
                       for i in live)
            ep = self.model.moe_parallel == "ep"
            self.ep_plan = perf_model.ep_tick_plan(
                rows, hidden=c.hidden_size,
                moe_intermediate=c.moe_intermediate_size,
                top_k=c.num_experts_per_tok,
                num_ranks=int(self.model.n) if ep else 1,
                method=self.model.moe.method if ep else "ragged",
                pipeline=self.model.moe.pipeline if ep else 1)
        if self.spec is not None:
            return self._spec_decode_tick(live, stream_cb)
        # slots on the megakernel path take its one launch, the others
        # (none without the watchdog's demotions) the engine's step
        mk_live, eng_live = serve_state.partition_decode(
            self.sched, live, self._mk is not None)
        toks = [s.last_tok for s in self._slots]
        sampling = self.temperature > 0.0
        got = np.zeros((self.b_max,), np.int64)
        gen = self._generator()
        if eng_live:
            active = [i in eng_live for i in range(self.b_max)]
            out, self._cache = self.model.decode_step_paged(
                self.params, toks, self._cache, active, gen,
                sampling=sampling, temperature=self.temperature,
                top_k=self.top_k, attn_method=self.attn_method)
            got[eng_live] = self._checked(out).cpu().numpy()[eng_live]
        if mk_live:
            mask = np.asarray([i in mk_live for i in range(self.b_max)])
            out = self._mk.decode(
                toks, self._cache.seq_lens, self._cache.block_table, mask,
                gen, sampling=sampling, temperature=self.temperature,
                top_k=self.top_k)
            got[mk_live] = out.cpu().numpy()[mk_live]
            self._mk_launched()
            self._cache.advance(slice(None), mask.astype(np.int32))
        self._steps["decode"] += 1
        for i in live:
            self._emit(i, int(got[i]), stream_cb)
            self._maybe_finish(i, stream_cb)

    # -- speculative decode tick ---------------------------------------------
    def _choose_k(self, i: int, room: int | None, cache_len: int) -> int:
        """Slot i's verify width this tick: serve_state.spec_clamp (the
        tokens the request still owes, the megakernel page room), then,
        with `adapt`, perf_model.choose_spec_k over the request's
        acceptance EWMA. Returns >= 1; a modeled 1 where more was
        possible counts in `spec_fallbacks` (the JAX counter). In engine
        mode such a slot verifies one row, as the decode step does; in
        megakernel mode the launch still runs every slot_rows row."""
        s = self._slots[i]
        cap = serve_state.spec_clamp(self.sched, i, self.spec.k, room)
        if cap <= 1 or not self.spec.adapt:
            return cap
        c = self.model.config
        k = perf_model.choose_spec_k(
            self._spec_ewma.get(s.req.rid, self.spec.ewma_init),
            int(cache_len), max(1, self.sched.occupancy()),
            k_max=cap, draft_cost_s=self.spec.draft_cost_s,
            path=s.path if s.path in ("megakernel", "engine")
            else "engine",
            num_layers=c.num_layers, hidden=c.hidden_size,
            intermediate=c.intermediate_size, num_heads=c.num_heads,
            num_kv_heads=c.num_kv_heads, head_dim=c.head_dim)
        if k < cap and k <= 1:
            self.sched.counters["spec_fallbacks"] += 1
        return max(1, k)

    def _slot_context(self, i: int):
        """The request's visible stream (prompt + emitted tokens), the
        drafter's `context`, as a view into a per-request buffer that
        grows by the new tokens only (so drafting costs no concatenate
        of the whole stream a tick); kept across eviction and
        re-admission, dropped at finish."""
        s = self._slots[i]
        rid = s.req.rid
        ids = np.asarray(s.req.ids, np.int64).reshape(-1)
        need = ids.size + len(s.out)
        buf, filled = self._spec_ctx.get(rid, (None, 0))
        if buf is None:
            buf = np.empty(need + s.gen_left, np.int64)
            buf[:ids.size] = ids
            filled = ids.size
        if filled < need:
            buf[filled:need] = s.out[filled - ids.size:]
            filled = need
        self._spec_ctx[rid] = (buf, filled)
        return buf[:filled]

    def _spec_decode_tick(self, live, stream_cb):
        """One draft-verify-rollback tick: ONE verify step per decode path
        (the engine's `verify_step_paged`, or the megakernel's one
        launch), the greedy accept on the host, then the rollback as a
        block-table edit (serve_state.rollback_spec -> _CachePool.truncate
        -> PagedKVCache.truncate_slot). A slot of width 1 rides the same
        step: width 1 is the decode step, so spec-on tokens equal
        spec-off tokens."""
        mk_live, eng_live = serve_state.partition_decode(
            self.sched, live, self._mk is not None)
        # the candidate array's width: a megakernel slot's candidates
        # ride its own slot_rows trunk rows
        K = self.spec.k if self._mk is None \
            else min(self.spec.k, self._mk.slot_rows)
        cands = np.zeros((self.b_max, K), np.int32)
        counts = np.ones((self.b_max,), np.int32)
        lens0 = self._cache.seq_lens.astype(np.int64)
        for i in live:
            s = self._slots[i]
            room = (self._mk.page_room(lens0[i]) if i in mk_live
                    else None)
            k_i = min(self._choose_k(i, room, lens0[i]), K)
            drafts = []
            if k_i > 1:
                drafts = list(self.spec.drafter.propose(
                    s.req.rid, self._slot_context(i), k_i - 1))[:k_i - 1]
            serve_state.propose_spec(self.sched, i, drafts)
            cands[i, 0] = s.last_tok
            cands[i, 1:1 + len(drafts)] = drafts
            counts[i] = 1 + len(drafts)
        pred = np.zeros((self.b_max, K), np.int64)
        if eng_live:
            active = [i in eng_live for i in range(self.b_max)]
            got, self._cache = self.model.verify_step_paged(
                self.params, cands, self._cache, active, counts,
                attn_method=self.attn_method)
            pred[eng_live] = self._checked(got).cpu().numpy()[eng_live]
        if mk_live:
            mask = np.asarray([i in mk_live for i in range(self.b_max)])
            got = self._mk.verify(cands, counts, lens0,
                                  self._cache.block_table, mask)
            self._mk_launched()
            self._cache.advance(slice(None),
                                np.where(mask, counts, 0).astype(np.int32))
            pred[mk_live] = got[mk_live]
        self._steps["decode"] += 1
        for i in live:
            s = self._slots[i]
            c = int(counts[i])
            drafts = cands[i, 1:c]
            accepted = 0
            while accepted < c - 1 \
                    and int(drafts[accepted]) == int(pred[i, accepted]):
                accepted += 1
            n_emit = serve_state.verify_outcome(self.sched, i, accepted)
            toks = [int(t) for t in drafts[:accepted]] \
                + [int(pred[i, accepted])]
            rid = s.req.rid
            for tok in toks[:n_emit]:
                self._emit(i, tok, stream_cb)
            serve_state.rollback_spec(self.sched, i, int(lens0[i]),
                                      n_emit, c, self._pool)
            if c > 1:   # acceptance EWMA: only ticks that drafted
                a = self.spec.ewma_alpha
                prev = self._spec_ewma.get(rid, self.spec.ewma_init)
                self._spec_ewma[rid] = \
                    (1 - a) * prev + a * (accepted / (c - 1))
            self._maybe_finish(i, stream_cb)

    def _maybe_finish(self, i: int, stream_cb):
        if not serve_state.finish_ready(self.sched, i):
            return
        s = self._slots[i]
        self._results[s.req.rid] = np.asarray(s.out, np.int64)
        self._spec_ewma.pop(s.req.rid, None)   # bound at b_max entries
        self._spec_ctx.pop(s.req.rid, None)
        serve_state.finish(self.sched, i, self._pool)

    def _rank_sync_check(self):
        """End-of-tick rank-consistency tripwire (JAX serve.py:1091): each
        resident slot's cache length lands on every rank's ledger as one
        edit, then the ledgers must agree; a divergence is a scheduler
        bug and raises."""
        if self._rledger is None:
            return
        for i, s in enumerate(self.sched.slots):
            if s.req is not None:
                self._rledger.set_len(i, int(self._cache.seq_lens[i]))
        div = self._rledger.divergence()
        if div is not None:
            raise RuntimeError(f"ServeEngine rank divergence: {div}")

    def _tick(self, stream_cb=None):
        self.sched.tick += 1
        self._admit()
        self._prefill_tick(stream_cb)
        self._decode_tick(stream_cb)
        self._rank_sync_check()

    # -- observability ----------------------------------------------------
    def stats(self) -> dict:
        """Counter snapshot of the control plane for the most recent
        run(), with live gauges (queue, occupancy, free blocks), so a
        snapshot from a stream_cb reads the current state. The keys
        are the JAX engine's for what this slice serves, plus the
        model steps the run took (`decode_steps`, `prefill_chunks`,
        and `prefix_chunks`: chunks that merged a cached-prefix
        partial)."""
        c = self.sched.counters
        cache = self._cache
        free = (cache.num_free_blocks if cache is not None
                else self._pool_blocks)
        toks = c["tokens"]
        wall = (self._run_wall_s if self._run_wall_s > 0
                else (time.perf_counter() - self._run_t0
                      if self._run_t0 > 0 else 0.0))
        return {
            "ticks": self.sched.tick,
            "queue_depth": len(self.sched.queue),
            "occupancy": self.sched.occupancy(),
            "b_max": self.b_max,
            "free_blocks": free,
            "total_blocks": self._pool_blocks,
            "admitted": c["admitted"],
            "finished": c["finished"],
            "evictions": c["evicted"],
            "requeued": c["requeued"],
            "prefill_chunks": c["prefill_chunks"],
            "quarantined": len(self.sched.quarantined),
            "faults": len(self.sched.fault_log),
            "tokens": toks,
            "wall_s": round(wall, 6),
            "tokens_per_s": round(toks / wall, 1) if wall > 0 else 0.0,
            "prefix_hit_blocks": c["prefix_hit_blocks"],
            "prefix_miss_blocks": c["prefix_miss_blocks"],
            "cow_copies": c["cow_copies"],
            "cached_free_blocks": (self._pool._cached_only()
                                   if cache is not None else 0),
            "reclaimed_blocks": c["reclaimed_blocks"],
            "preemptions": c["preempted"],
            "grant_refusals": c["grant_refusals"],
            # speculative decoding: drafts proposed / accepted / rejected,
            # the realised acceptance rate, tail blocks rollbacks emptied
            # and the ticks where the adaptive width chose 1 (a one-row
            # verify in engine mode, a full launch in megakernel mode)
            "spec_proposed": c["spec_proposed"],
            "spec_accepted": c["spec_accepted"],
            "spec_rejected": c["spec_rejected"],
            "acceptance_rate": round(
                c["spec_accepted"] / c["spec_proposed"], 4)
            if c["spec_proposed"] else 0.0,
            "rollback_blocks": c["rollback_blocks"],
            "spec_fallbacks": c["spec_fallbacks"],
            "kv_dtype": self.kv_dtype,
            "quant_kv_bytes_saved": self._quant_kv_bytes_saved(),
            "decode_steps": self._steps["decode"],
            "prefix_chunks": self._steps["prefill_prefix"],
            # the decode path, and the ticks that took the one megakernel
            # launch; the deployment's ranks and one row each (empty at
            # tp_ranks 1)
            "mode": self.mode,
            "megakernel_steps": self._steps["megakernel"],
            "tp_ranks": self.tp_ranks,
            "per_rank": self._per_rank_stats(),
            # slot-ticks the expert-capacity budget deferred, routed rows
            # dispatched, and the last tick's live-occupancy EP plan
            "capacity_drops": c["capacity_drops"],
            "ep_rows": c["ep_rows"],
            "ep_capacity": self.sched.cfg.ep_capacity,
            "ep_plan": self.ep_plan,
        }

    def _mk_launched(self):
        """After a megakernel launch: its fault check, the launch count,
        and each rank's AR bytes (JAX _note_mk_launch: the analytic bytes
        a rank pushes a launch)."""
        self._mk.prog.check_fault()
        self._steps["megakernel"] += 1
        for r in range(self.tp_ranks):
            self._ar_bytes[r] += self._mk.ar_bytes_per_step

    def _per_rank_stats(self) -> list:
        """One row a rank at tp_ranks > 1 (JAX _per_rank_stats): the
        blocks its ledger holds, the pool's free blocks (page ids are
        global, so every rank's count is the same), the bytes its AR
        tasks pushed on the megakernel path (0 on the engine path), and
        the bounded-drain launches, which the port does not have (0)."""
        if self._rledger is None:
            return []
        cache = self._cache
        free = (cache.num_free_blocks if cache is not None
                else self._pool_blocks)
        return [{"rank": r, "held_blocks": self._rledger.held_blocks(r),
                 "free_blocks": free, "ar_bytes_pushed": self._ar_bytes[r],
                 "drain_budget_trips": 0} for r in range(self.tp_ranks)]

    def _quant_kv_bytes_saved(self) -> int:
        """Device bytes the wire-width pool saves against an f32 pool
        over the blocks in use."""
        cache = self._cache
        if cache is None or not cache.quantized:
            return 0
        L, hkv = cache.k_pool.shape[0], cache.num_kv_heads
        blk, d = cache.k_pool.shape[-2:]
        fp32 = 2 * L * hkv * blk * d * 4
        in_use = cache.num_blocks - cache.num_free_blocks
        return (fp32 - cache.block_nbytes()) * in_use

    # -- run loop ---------------------------------------------------------
    def run(self, stream_cb=None) -> dict:
        """Drive the scheduler until the queue and every slot drain.
        Returns {rid: np.ndarray generated tokens}; `stream_cb(rid,
        token, index)` fires per token as it is produced. Each run
        starts from a fresh pool and prefix cache."""
        self._cache = self.model.new_paged_kv_cache(
            self.b_max, self.max_len, block=self.block,
            num_blocks=self.num_blocks, kv_dtype=self.kv_dtype)
        if self._mk is not None:
            self._mk.reset()
        if self._rledger is not None:
            self._rledger = serve_state.RankLedger(self.tp_ranks, self.b_max)
        self._ar_bytes = [0] * self.tp_ranks
        self.sched.reset_run()
        self._spec_ewma, self._spec_ctx = {}, {}
        if self._cap_ledger is not None:
            # fresh run, fresh budget clock (reset_run rewound the tick)
            self._cap_ledger = serve_state.CapacityLedger(
                self.sched.cfg.ep_capacity)
        self.ep_plan = None
        self._results: dict = {}
        self._gen = torch.Generator(device=self.model.device)
        self._step = 0
        self._steps = dict.fromkeys(self._steps, 0)
        self._budget_extra = 0
        # every tick makes progress (a chunk, a token or an admission),
        # so hitting this bound means a scheduler or allocator bug
        budget = 16 * (sum(len(r.ids) // self.prefill_chunk + r.gen_len + 2
                           for r in self.queue) + 1)
        used = 0
        self._run_t0 = time.perf_counter()
        self._run_wall_s = 0.0
        self._running = True
        try:
            while serve_state.pending(self.sched):
                used += 1
                if used > budget + self._budget_extra:
                    raise RuntimeError(
                        "ServeEngine scheduler made no progress "
                        "(slot/allocator bug)")
                self._tick(stream_cb)
        finally:
            self._running = False
            self._run_wall_s = time.perf_counter() - self._run_t0
        return self._results

    def serve(self, prompts, gen_lens) -> list:
        """Submit every (prompt, gen_len) pair, run to completion, and
        return the outputs in submission order."""
        rids = [self.submit(p, g) for p, g in zip(prompts, gen_lens)]
        results = self.run()
        return [results[r] for r in rids]
