"""The serving control plane as an explicit state machine, grown into
a QoS scheduler over a refcounted radix prefix cache.

This is the JAX package's triton_distributed_tpu/models/serve_state.py
carried over unchanged: numpy only, the same transition functions
statement for statement (tests/test_torch_serve.py compares the two
modules' syntax trees with docstrings removed), so the port's
`ServeEngine` makes the decisions the JAX model checker certifies. Its
text below speaks of the JAX engine's parts (jitted steps, the
megakernel, sanitizer/serve_model.py) as that package has them.

Every control-plane
DECISION lives here as a transition function over an explicit
:class:`SchedulerState`:

    admit            free slots take eligible queue entries — QoS pick
                     (SLO class, priority, weighted tenant fairness,
                     FIFO by arrival id), radix prefix match, LRU
                     reclaim under block pressure, preemption of
                     lower-class residents, allocator-gated
    watchdog         no-progress / failed slots fault out
    fault_slot       evict + requeue with capped exponential backoff,
                     or quarantine past max_faults; demotes the slot's
                     decode-path health one ladder rung
    preempt          evict a lower-class request to make room: its
                     computed blocks enter the prefix cache (cheap
                     re-admission), no fault penalty, FIFO requeue
    requeue          deterministic FIFO-by-arrival-id re-insertion
    pick_prefill / prefill_args / prefill_advance
                     the chunked-prefill scheduler
    emit / finish    decode progress + slot recycling
    release_to_cache full computed blocks transfer into the radix
                     cache (refcount -> 0 but retained) instead of the
                     free list
    decode_live / partition_decode
                     the per-slot degradation-ladder partition

`ServeEngine` drives these functions against the REAL allocator and
jitted model steps (its pool adapter wraps `PagedKVCache`); the serving
model checker (sanitizer/serve_model.py) drives the SAME functions
against the pure :class:`BlockAlloc` below and exhaustively explores
every bounded interleaving of scheduler events and fault transitions.
One implementation, two harnesses — the checker certifies the code the
engine ships, not a drift-prone parallel model.

Prefix-cache ownership model. Every pool block is in
exactly ONE of four states:

    free        on the free list, grantable
    held        refcount >= 1: referenced by that many slot table rows
                (shared prefixes bump the count; writes require sole
                ownership — the first divergent write copies-on-write)
    cached      refcount == 0 but retained by the radix tree
                (PrefixCache): the KV stays warm for future prefix
                hits until LRU pressure reclaims it
    stolen      chaos block-exhaustion holds it hostage

The functions mutate the state they are handed (engine-style) and are
deterministic given the state and pool results; the checker clones
states before branching.
"""

from __future__ import annotations

import bisect
import dataclasses

import numpy as np

from .. import perf_model


SLO_CLASSES = ("interactive", "batch")


@dataclasses.dataclass
class Request:
    rid: int
    ids: np.ndarray          # (S,) int32 prompt
    gen_len: int
    # watchdog state: fault count drives backoff + quarantine
    faults: int = 0
    not_before: int = 0      # earliest re-admission tick (capped backoff)
    # QoS class: latency class, fairness tenant, priority
    tenant: str = "default"
    slo: str = "batch"       # one of SLO_CLASSES
    priority: int = 0        # higher admits first within its SLO class


@dataclasses.dataclass
class _Slot:
    state: str = "free"      # "free" | "prefill" | "decode"
    req: Request | None = None
    pos: int = 0             # prefill progress (tokens cached); starts
    #                          at the prefix-match boundary on a hit
    gen_left: int = 0
    last_tok: int = 0
    out: list = dataclasses.field(default_factory=list)
    # watchdog state
    start_tick: int = 0
    last_progress: int = 0   # last tick this slot emitted/prefilled
    stalled_until: int = -1  # chaos-injected stall horizon
    failed: bool = False     # chaos-injected mid-stream slot failure
    path: str = "engine"     # decode path chosen at admission (ladder)
    # speculative decode: draft tokens pending verification
    # this tick (cleared by verify_outcome). LAST field on purpose —
    # the checker's hot-path positional _Slot copies stay valid.
    drafted: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class SchedCfg:
    """The scheduler's static knobs — everything a transition needs
    besides the state itself."""
    b_max: int
    block: int
    prefill_chunk: int
    slo_ticks: int | None = None
    max_faults: int = 3
    backoff_ticks: int = 2
    backoff_cap: int = 16
    base_path: str = "engine"   # "megakernel" when the fast path exists
    # -- QoS + prefix cache ----------------------------------
    prefix_caching: bool = False
    tenant_weights: tuple = ()  # ((tenant, weight), ...): fairness shares
    preemption: bool = True     # interactive may evict batch residents
    # -- speculative decode ----------------------------------
    # 0 disables; k >= 2 arms multi-token verify: a decode tick feeds a
    # slot's last token plus up to k-1 draft tokens through ONE verify
    # step, emits the accepted prefix plus the first corrected token,
    # and rolls the rejected rows back as a block-table edit
    spec_k: int = 0
    # -- sequence-parallel serving ---------------------------
    # > 1 when the model shards each sequence's KV across sp_ranks mesh
    # ranks (attn_parallelism="sp"): every grant must then land
    # all-or-nothing PER RANK — table column j draws from rank
    # (j // blocks_per_rank)'s local pool slice, so admission succeeds
    # only when EVERY rank can cover its share of the request
    sp_ranks: int = 1
    # -- EP continuous batching ------------------------------
    # > 0 when the model routes tokens through experts with a per-tick
    # dispatch budget of that many ROWS (decode tokens; a spec-armed
    # slot contributes 1 + len(drafted)). A tick whose live batch
    # routes more rows than the budget DEFERS whole slots — the
    # capacity drop the reference handles by silently zeroing routed
    # tokens becomes an explicit scheduler decision partition_capacity
    # makes and the model checker certifies (deferred slots keep their
    # state/pages/stream untouched: requeued-in-place, never lost)
    ep_capacity: int = 0
    # -- tiered KV: host-DRAM spill pool ---------------------
    # > 0 arms the second tier: under block pressure, cold radix-cached
    # blocks SPILL to a host-DRAM pool of this many block slots (KV
    # retained at block granularity) instead of being dropped; a later
    # prefix hit streams them back via DMA at admission
    # (`stage_readbacks`). 0 disables — reclaim drops cold blocks as
    # before.
    host_blocks: int = 0
    # -- multi-rank TP serving -------------------------------
    # > 1 when the megakernel decode step runs sharded over tp_ranks
    # mesh ranks (per-rank weight/cbuf shards, TASK_GEMM_AR pushes, the
    # paged pool head-sharded). The control plane stays ONE logical
    # SchedulerState: every decision is computed once and applied as
    # identical per-rank grant/release edits, mirrored through a
    # :class:`RankLedger` whose divergence detector the model checker
    # proves live
    tp_ranks: int = 1

    def __post_init__(self):
        if self.tp_ranks < 1:
            raise ValueError(
                f"tp_ranks {self.tp_ranks} < 1: the TP rank count is "
                f"a mesh size (1 disables the rank ledger)")
        if self.tp_ranks > 1 and self.sp_ranks > 1:
            raise ValueError(
                "tp_ranks > 1 and sp_ranks > 1 cannot compose: the "
                "pool is head-sharded across TP ranks OR block-sharded "
                "across SP ranks, never both")
        if self.host_blocks < 0:
            raise ValueError(
                f"host_blocks {self.host_blocks} < 0: the host-DRAM "
                f"spill pool is a block count (0 disables tiering)")
        if self.host_blocks and not self.prefix_caching:
            raise ValueError(
                "host_blocks > 0 requires prefix_caching: the spill "
                "candidates are cold radix-cached blocks, so without "
                "the radix tree there is nothing to tier")
        if self.ep_capacity < 0:
            raise ValueError(
                f"ep_capacity {self.ep_capacity} < 0: the per-tick EP "
                f"dispatch budget is a row count (0 disables)")
        if self.ep_capacity and self.spec_k > self.ep_capacity:
            raise ValueError(
                f"spec_k {self.spec_k} > ep_capacity "
                f"{self.ep_capacity}: one spec verify routes spec_k "
                f"rows, so such a slot could never be served — raise "
                f"the capacity or lower spec_k")
        # the sequence-sharded pool has no cross-rank block mobility, so
        # the features that remap/rewrite arbitrary pages are tp-only —
        # refuse the combination at construction, not mid-admission
        if self.sp_ranks > 1:
            if self.host_blocks:
                raise ValueError(
                    "tiered KV (host_blocks > 0) is tp-only: a "
                    "readback would land a host block in a table "
                    "column another rank owns; serve sp_ranks>1 with "
                    "host_blocks=0")
            if self.prefix_caching:
                raise ValueError(
                    "prefix_caching is tp-only: a radix hit would map "
                    "cached blocks into table columns another rank "
                    "owns; serve sp_ranks>1 with prefix_caching=False")
            if self.spec_k:
                raise ValueError(
                    "speculative decoding is tp-only: multi-token "
                    "verify/rollback is not supported under sp_ranks>1")
            if self.base_path == "megakernel":
                raise ValueError(
                    "the megakernel decode path is tp-only: its pool "
                    "is not sequence-sharded; use mode='engine' with "
                    "sp_ranks>1")


def _fresh_counters() -> dict:
    return {"admitted": 0, "finished": 0, "evicted": 0, "requeued": 0,
            "tokens": 0, "prefill_chunks": 0,
            # prefix cache + QoS observability
            "prefix_hit_blocks": 0, "prefix_miss_blocks": 0,
            "cow_copies": 0, "preempted": 0, "grant_refusals": 0,
            "reclaimed_blocks": 0,
            # speculative-decode observability — drafts
            # proposed/accepted/rejected (token currency), tail blocks
            # a rollback emptied (the waste currency choose_spec_k
            # amortizes), and ticks the adaptive policy fell back to
            # plain decode
            "spec_proposed": 0, "spec_accepted": 0, "spec_rejected": 0,
            "rollback_blocks": 0, "spec_fallbacks": 0,
            # EP continuous batching — slot-ticks deferred by
            # the expert-capacity budget (every one of these is a drop
            # the scheduler chose and the checker can see) and routed
            # rows actually dispatched
            "capacity_drops": 0, "ep_rows": 0,
            # tiered KV — blocks spilled to the host-DRAM
            # pool (KV retained instead of dropped) and blocks streamed
            # back at admission
            "spilled_blocks": 0, "readback_blocks": 0,
            # host-tier LRU eviction — spilled blocks whose
            # host slots were reclaimed (coldest-first) to make room
            # for a newer spill once the host pool filled
            "host_evicted_blocks": 0}


# ---------------------------------------------------------------------------
# Radix prefix cache: block-granular trie over token ids
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _PrefixNode:
    key: tuple               # this node's block-sized token chunk
    block: int               # pool block id holding the chunk's KV
    #                          (-1 while spilled to the host tier)
    path: tuple              # chunk path from the root (canonical id;
    #                          the deterministic LRU tiebreak)
    last_used: int           # arrival id (rid) of the last toucher
    children: dict = dataclasses.field(default_factory=dict)
    parent: object = None
    # tiered KV — "hbm" (device-resident) | "host" (spilled;
    # `host_slot` names the host-DRAM pool slot holding the KV)
    tier: str = "hbm"
    host_slot: int = -1


class PrefixCache:
    """Radix tree mapping block-sized token-id chunks to pool block
    ids: the longest cached prefix of a new prompt is found by walking
    full-block chunks from the root. The tree OWNS refcount-0 blocks
    (they stay resident, off the free list) and releases them
    leaf-first under LRU pressure — ordered by (last_used arrival id,
    chunk path), so reclaim replays identically across storms (the
    FIFO-by-arrival-id convention of the requeue)."""

    def __init__(self, block: int):
        self.block = block
        self.root: dict = {}        # first chunk -> node
        self.blocks: dict = {}      # DEVICE block id -> resident node
        self.hosted: dict = {}      # host slot -> spilled node

    def clone(self) -> "PrefixCache":
        new = PrefixCache(self.block)

        def copy(node: _PrefixNode, parent) -> _PrefixNode:
            n2 = _PrefixNode(node.key, node.block, node.path,
                             node.last_used, {}, parent,
                             node.tier, node.host_slot)
            n2.children = {k: copy(c, n2)
                           for k, c in node.children.items()}
            if n2.tier == "host":
                new.hosted[n2.host_slot] = n2
            else:
                new.blocks[n2.block] = n2
            return n2

        new.root = {k: copy(n, None) for k, n in self.root.items()}
        return new

    def _chunks(self, ids, n: int):
        blk = self.block
        return [tuple(int(t) for t in ids[j * blk:(j + 1) * blk])
                for j in range(n)]

    def match(self, ids, rid: int) -> list:
        """Longest cached prefix of `ids`, in full-block chunks: the
        matched nodes root-first. Touches each matched node's LRU clock
        with the requester's arrival id."""
        out = []
        kids = self.root
        for key in self._chunks(ids, len(ids) // self.block):
            node = kids.get(key)
            if node is None:
                break
            node.last_used = max(node.last_used, rid)
            out.append(node)
            kids = node.children
        return out

    def insert(self, tokens, block_ids, rid: int) -> list:
        """Register a released slot's full blocks: `block_ids[j]` holds
        the KV of chunk j of `tokens`. A chunk already present keeps
        its existing block (the duplicate block id is NOT retained —
        the caller frees it); new chunks chain in as children. Returns
        the block ids the tree newly took ownership of."""
        kids = self.root
        parent = None
        kept = []
        for j, key in enumerate(self._chunks(tokens, len(block_ids))):
            node = kids.get(key)
            if node is None:
                path = (parent.path if parent is not None else ()) \
                    + (key,)
                node = _PrefixNode(key, int(block_ids[j]), path, rid,
                                   {}, parent)
                kids[key] = node
                self.blocks[node.block] = node
                kept.append(node.block)
            else:
                node.last_used = max(node.last_used, rid)
            parent = node
            kids = node.children
        return kept

    def evict_lru(self, n: int, refcnt, keep=frozenset()) -> list:
        """Evict up to `n` LEAF blocks with refcount 0, LRU-first with
        the deterministic (last_used, path) order; a parent becomes
        evictable the moment its last child goes (promoted into the
        sorted candidate list in place — ONE pass over the tree, not a
        rescan per evicted block). ``keep`` protects blocks an
        in-flight admission plan references (its shared prefix / CoW
        source are refcount 0 until granted). Returns the evicted
        block ids (the caller returns them to the allocator)."""

        def evictable(nd):
            return (nd.tier == "hbm" and not nd.children
                    and nd.block not in keep and refcnt(nd.block) == 0)

        # (last_used, path) keys are unique (path is), so nodes are
        # never compared
        cands = sorted(((nd.last_used, nd.path), nd)
                       for nd in self.blocks.values() if evictable(nd))
        out = []
        while cands and len(out) < n:
            _, nd = cands.pop(0)
            kids = nd.parent.children if nd.parent is not None \
                else self.root
            del kids[nd.key]
            del self.blocks[nd.block]
            out.append(nd.block)
            p = nd.parent
            if p is not None and evictable(p):
                bisect.insort(cands, ((p.last_used, p.path), p))
        return out

    # -- tiered KV: resident <-> spilled transitions ---------
    def spill_candidates(self, n: int, refcnt, keep=frozenset()) -> list:
        """Up to ``n`` device-RESIDENT cached nodes eligible to spill
        to the host tier, coldest first — the same deterministic
        (last_used, path) LRU order as `evict_lru`, but WITHOUT the
        leaf-first constraint (a spilled node keeps its tree position;
        nothing is orphaned). Returns the nodes; the caller moves the
        payload (pool.spill) and flips them with `mark_spilled`."""
        cands = sorted(
            ((nd.last_used, nd.path), nd)
            for nd in self.blocks.values()
            if nd.block not in keep and refcnt(nd.block) == 0)
        return [nd for _, nd in cands[:n]]

    def mark_spilled(self, node: _PrefixNode, host_slot: int):
        """Flip a resident node to the host tier: its device block id
        is surrendered (the pool freed it) and the node now names the
        host-DRAM slot holding its KV."""
        del self.blocks[node.block]
        node.block = -1
        node.tier = "host"
        node.host_slot = host_slot
        self.hosted[host_slot] = node

    def mark_resident(self, host_slot: int, block: int) -> _PrefixNode:
        """Flip a spilled node back to the device tier: the readback
        landed its KV in pool block ``block``."""
        node = self.hosted.pop(host_slot)
        node.block = int(block)
        node.tier = "hbm"
        node.host_slot = -1
        self.blocks[node.block] = node
        return node

    def host_evict_candidates(self, keep=frozenset()) -> list:
        """Spilled LEAF nodes eligible for host-tier eviction, coldest
        first — the same deterministic (last_used, path)
        LRU order every other reclaim in this file replays. Leaf-only,
        like `evict_lru`: dropping a mid-tree node would orphan its
        descendants' chunks (unreachable but still charged). ``keep``
        protects host slots an in-flight admission plan is about to
        read back."""
        cands = sorted(((nd.last_used, nd.path), nd)
                       for nd in self.hosted.values()
                       if not nd.children and nd.host_slot not in keep)
        return [nd for _, nd in cands]

    def drop_hosted(self, node: _PrefixNode):
        """Remove a spilled leaf node from the tree (host-tier LRU
        eviction): its KV is gone — the next hit on that prefix
        recomputes from the prompt, exactly the `evict_lru` drop
        semantics one tier down."""
        if node.children:
            raise ValueError(
                f"drop_hosted: node {node.path!r} still has children — "
                f"host eviction is leaf-only")
        kids = node.parent.children if node.parent is not None \
            else self.root
        del kids[node.key]
        del self.hosted[node.host_slot]

    def signature(self) -> tuple:
        """Canonical content signature (model-checker state dedup)."""
        sig = tuple(sorted((nd.path, nd.block, nd.last_used)
                           for nd in self.blocks.values()))
        if not self.hosted:
            return sig
        return sig + tuple(sorted(
            ("host", nd.path, nd.host_slot, nd.last_used)
            for nd in self.hosted.values()))


@dataclasses.dataclass(frozen=True)
class AdmitPlan:
    """One admission's allocator plan, decided by `plan_admission`:
    `shared` cached blocks map into the head of the slot's table with
    refcount bumps; `cow_src` (full-prompt hit) names the shared block
    whose KV the slot must privately rewrite — the first fresh block
    becomes its copy-on-write clone; `n_new` fresh blocks fill the
    tail; prefill resumes at token `start`. ``readback`` names matched
    prefix blocks currently SPILLED to the host tier: each entry is
    (idx, host_slot) — idx >= 0 is the `shared` position the block
    lands in (a -1 placeholder sits there until `stage_readbacks`
    streams it home), idx == -1 is the CoW source. A plan with
    pending readbacks must be staged before it can be granted."""
    shared: tuple = ()
    cow_src: object = None
    n_new: int = 0
    start: int = 0
    hit_blocks: int = 0
    miss_blocks: int = 0
    readback: tuple = ()


@dataclasses.dataclass
class SchedulerState:
    """The serving control plane: slot table, admission queue, watchdog
    clocks, degradation-ladder health, fault log, quarantine set,
    radix prefix cache, tenant fairness ledger, and structured
    counters. The allocator is NOT here — it is reached through the
    pool protocol so the engine can use the real `PagedKVCache` and
    the checker the pure `BlockAlloc`."""
    cfg: SchedCfg
    tick: int = 0
    slots: list = dataclasses.field(default_factory=list)
    queue: list = dataclasses.field(default_factory=list)
    health: list = dataclasses.field(default_factory=list)
    fault_log: list = dataclasses.field(default_factory=list)
    quarantined: dict = dataclasses.field(default_factory=dict)
    finished: list = dataclasses.field(default_factory=list)
    counters: dict = dataclasses.field(default_factory=_fresh_counters)
    prefix: PrefixCache | None = None
    tenant_served: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def create(cls, cfg: SchedCfg) -> "SchedulerState":
        return cls(cfg=cfg,
                   slots=[_Slot() for _ in range(cfg.b_max)],
                   health=[perf_model.DecodePathHealth()
                           for _ in range(cfg.b_max)],
                   prefix=(PrefixCache(cfg.block)
                           if cfg.prefix_caching else None))

    def reset_run(self):
        """Fresh run: slots, clocks, logs, results-side bookkeeping.
        The queue (submitted-but-unserved requests) and the per-slot
        HEALTH ladder survive — a tripped path stays demoted until the
        operator re-admits it (DecodePathHealth.reset). The prefix
        cache does NOT survive: each run builds a fresh block pool, so
        cached block ids from the last run are meaningless."""
        self.tick = 0
        self.slots = [_Slot() for _ in range(self.cfg.b_max)]
        self.fault_log = []
        self.quarantined = {}
        self.finished = []
        self.counters = _fresh_counters()
        self.prefix = (PrefixCache(self.cfg.block)
                       if self.cfg.prefix_caching else None)
        self.tenant_served = {}

    def occupancy(self) -> int:
        return sum(1 for s in self.slots if s.state != "free")


# ---------------------------------------------------------------------------
# Transition functions (shared by ServeEngine and the model checker)
# ---------------------------------------------------------------------------

def blocks_for(cfg: SchedCfg, req: Request) -> int:
    return -(-(len(req.ids) + req.gen_len) // cfg.block)


def sidelined(st: SchedulerState, i: int) -> bool:
    """Chaos/fault-injected failure or stall: the slot cannot be
    scheduled this tick."""
    s = st.slots[i]
    return s.failed or s.stalled_until > st.tick


def preferred_path(st: SchedulerState, i: int) -> str:
    """The slot's decode path at admission: the configured fast path,
    demoted down the megakernel -> engine -> xla ladder past any rung
    this slot's health has tripped on."""
    return st.health[i].resolve(st.cfg.base_path)


def pending(st: SchedulerState) -> bool:
    return bool(st.queue) or any(s.state != "free" for s in st.slots)


def requeue(st: SchedulerState, req: Request):
    """Deterministic FIFO re-insertion by ARRIVAL id: a retried request
    rejoins the queue at its original position relative to everyone
    else, regardless of which slot faulted first or what order a
    watchdog storm swept the slot table in. Fresh submissions get
    monotone rids, so the whole queue is always rid-sorted — the
    canonical schedule the model checker (and a replayed storm)
    depends on."""
    rids = [r.rid for r in st.queue]
    st.queue.insert(bisect.bisect_left(rids, req.rid), req)
    st.counters["requeued"] += 1


def _slo_rank(slo: str) -> int:
    return SLO_CLASSES.index(slo) if slo in SLO_CLASSES \
        else len(SLO_CLASSES)


def _class_key(req: Request) -> tuple:
    """Total order on QoS class: interactive before batch, then higher
    priority first. Strictly smaller = strictly more urgent."""
    return (_slo_rank(req.slo), -req.priority)


def pick_admission(st: SchedulerState) -> int | None:
    """The QoS admission pick among queue entries past their backoff
    horizon: interactive before batch, higher priority first, then
    weighted tenant fairness (least COMPLETIONS-per-weight-share —
    charged at finish, so fault retries and preemption re-admissions
    never double-bill a tenant for one request's service), then FIFO
    by arrival id. With one class and one tenant this reduces exactly
    to the plain FIFO pick."""
    cands = [(j, r) for j, r in enumerate(st.queue)
             if r.not_before <= st.tick]
    if not cands:
        return None
    w = dict(st.cfg.tenant_weights)

    def key(jr):
        _j, r = jr
        fair = st.tenant_served.get(r.tenant, 0) / w.get(r.tenant, 1)
        return _class_key(r) + (fair, r.tenant, r.rid)

    return min(cands, key=key)[0]


def plan_admission(st: SchedulerState, i: int, req: Request) -> AdmitPlan:
    """The radix-cache admission plan for `req` landing in slot `i`:
    the longest cached block-aligned prefix maps in shared (refcount
    bumps), prefill resumes at the match boundary. A FULL-prompt hit
    still needs the last prompt token recomputed (its logits emit the
    first generated token), so the final matched block is planned as a
    copy-on-write clone and prefill resumes one token early — the
    write lands in the private copy, never in the shared block.

    Megakernel-path slots plan fresh: their decode appends land in the
    megakernel's own pool, and their kernel tables must never share a
    page (sanitizer paged_hazard invariant)."""
    cfg = st.cfg
    need = blocks_for(cfg, req)
    if st.prefix is None or preferred_path(st, i) == "megakernel":
        return AdmitPlan(n_new=need, miss_blocks=need)
    nodes = st.prefix.match(req.ids, req.rid)
    if not nodes:
        return AdmitPlan(n_new=need, miss_blocks=need)
    m = len(nodes) * cfg.block

    def ids_of(nds):
        # spilled nodes enter as -1 placeholders plus a
        # readback entry; stage_readbacks streams them home pre-grant
        sh, rb = [], []
        for nd in nds:
            if nd.tier == "hbm":
                sh.append(nd.block)
            else:
                rb.append((len(sh), nd.host_slot))
                sh.append(-1)
        return tuple(sh), tuple(rb)

    if m == len(req.ids):
        shared, rb = ids_of(nodes[:-1])
        cow = nodes[-1].block
        if nodes[-1].tier == "host":
            cow = -1
            rb += ((-1, nodes[-1].host_slot),)
        return AdmitPlan(shared=shared, cow_src=cow,
                         n_new=need - len(shared), start=m - 1,
                         hit_blocks=len(nodes),
                         miss_blocks=need - len(nodes), readback=rb)
    shared, rb = ids_of(nodes)
    return AdmitPlan(shared=shared, n_new=need - len(shared), start=m,
                     hit_blocks=len(nodes),
                     miss_blocks=need - len(nodes), readback=rb)


def stage_readbacks(st: SchedulerState, plan: AdmitPlan, pool):
    """Stream a plan's spilled prefix blocks back from the host tier.
    Atomic: the DMA-complete and free-device-block checks run for ALL
    entries BEFORE any slot is consumed, so a half-staged plan cannot
    exist (the model checker's tier_lost detector would catch one).
    Returns the staged plan (readback=(), placeholders resolved) or
    None when staging cannot proceed — the caller degrades to the
    resident prefix."""
    if not plan.readback:
        return plan
    if pool.free_count() < plan.n_new + len(plan.readback):
        return None
    if any(not pool.readback_ready(hs) for _, hs in plan.readback):
        return None
    shared, cow = list(plan.shared), plan.cow_src
    for idx, hs in plan.readback:
        nb = pool.readback(hs)
        st.prefix.mark_resident(hs, nb)
        st.counters["readback_blocks"] += 1
        if idx < 0:
            cow = nb
        else:
            shared[idx] = nb
    return dataclasses.replace(plan, shared=tuple(shared), cow_src=cow,
                               readback=())


def _resident_prefix_plan(cfg: SchedCfg, plan: AdmitPlan,
                          req: Request) -> AdmitPlan:
    """Degrade a plan with unstageable readbacks to its RESIDENT
    prefix: keep the shared run up to the first spilled placeholder,
    recompute the rest from the prompt (the perf model's
    `choose_kv_tier` crossover is exactly this recompute cost)."""
    sh = []
    for b in plan.shared:
        if b < 0:
            break
        sh.append(b)
    m = len(sh)
    need = blocks_for(cfg, req)
    return AdmitPlan(shared=tuple(sh), n_new=need - m, start=m * cfg.block,
                     hit_blocks=m, miss_blocks=need - m)


def reclaim_for(st: SchedulerState, plan: AdmitPlan, pool) -> bool:
    """Block-pressure reclaim: evict LRU cached (refcount-0) leaves
    from the radix tree and return their blocks to the free list until
    the plan's `n_new` fresh blocks are grantable. The blocks the plan
    itself references (shared prefix, CoW source — refcount 0 until
    the grant lands) are protected from eviction. With a host tier
    configured, cold cached blocks SPILL (block stays reusable via
    readback) before the LRU drop path runs — spill beats drop.
    Refcounts are snapshotted ONCE: evictions cannot change them, and
    a per-leaf device query would put O(cached blocks) transfers on
    the admission hot path. Returns True when the grant can
    proceed."""
    if st.prefix is None:
        return False
    short = plan.n_new - pool.free_count()
    if short <= 0:
        return True
    refs = pool.refcnts()
    keep = frozenset(b for b in plan.shared if b >= 0) | (
        frozenset() if plan.cow_src is None or plan.cow_src < 0
        else {plan.cow_src})
    if st.cfg.host_blocks:
        nspill = min(short, pool.host_free_count())
        if nspill < short:
            # host pool full: LRU-evict spilled leaves to
            # make room instead of refusing the spill — KV retention
            # prefers evicting the COLDEST host block over dropping a
            # warmer device block. In-flight slots (staged this tick)
            # and slots this plan is about to read back are protected.
            keep_hosted = frozenset(hs for _, hs in plan.readback)
            for nd in st.prefix.host_evict_candidates(
                    keep=keep_hosted)[:short - nspill]:
                if not pool.readback_ready(nd.host_slot):
                    continue
                pool.host_evict(nd.host_slot)
                st.prefix.drop_hosted(nd)
                st.counters["host_evicted_blocks"] += 1
            nspill = min(short, pool.host_free_count())
        if nspill > 0:
            nodes = st.prefix.spill_candidates(
                nspill, lambda b: refs[b], keep=keep)
            for nd in nodes:
                hs = pool.spill(nd.block)
                st.prefix.mark_spilled(nd, hs)
                st.counters["spilled_blocks"] += 1
            short = plan.n_new - pool.free_count()
            if short <= 0:
                return True
    ids = st.prefix.evict_lru(short, lambda b: refs[b], keep=keep)
    if ids:
        pool.reclaim(ids)
        st.counters["reclaimed_blocks"] += len(ids)
    return pool.free_count() >= plan.n_new


def preempt_victim(st: SchedulerState, req: Request) -> int | None:
    """Deterministic preemption victim for a blocked request: the
    YOUNGEST (highest arrival id — least sunk work by FIFO admission)
    busy slot whose request is in a STRICTLY lower SLO class than
    `req`. Preemption crosses latency-class boundaries only —
    priority orders the queue within a class but never evicts a
    resident, and same-class requests never preempt each other (no
    livelock)."""
    if not st.cfg.preemption:
        return None
    best = None
    for i, s in enumerate(st.slots):
        if s.state == "free":
            continue
        if _slo_rank(s.req.slo) <= _slo_rank(req.slo):
            continue
        if best is None or s.req.rid > st.slots[best].req.rid:
            best = i
    return best


def preempt(st: SchedulerState, i: int, pool):
    """Evict a lower-class resident to make room (QoS): its computed
    blocks enter the prefix cache (so re-admission resumes from the
    cached prefix instead of re-prefilling), the request requeues at
    its FIFO arrival position with NO fault penalty and NO backoff —
    preemption is scheduling, not failure. A preempted request is
    never dropped (the request-accounting invariant the model checker
    certifies). Returns the preempted request."""
    s = st.slots[i]
    req = s.req
    release_to_cache(st, i, pool)
    st.slots[i] = _Slot()
    st.counters["preempted"] += 1
    req.not_before = st.tick
    requeue(st, req)
    return req


def admit(st: SchedulerState, pool, *, plan_fn=None, pick_fn=None,
          preempt_fn=None, reclaim_fn=None) -> list:
    """The admission transition: while an eligible request exists, the
    QoS pick takes the first free slot — preempting a strictly
    lower-class resident when none is free — with its radix-matched
    plan granted all-or-nothing (LRU reclaim relieves block pressure
    first). A grant refusal backpressures the WHOLE queue (nothing
    overtakes the waiting pick; `grant_refusals` is the admission
    backpressure signal). Returns the admitted slot indices. The
    `*_fn` hooks exist for the model checker's seeded mutations; the
    engine always runs the defaults."""
    plan_fn = plan_fn or plan_admission
    pick_fn = pick_fn or pick_admission
    preempt_fn = preempt_fn or preempt
    reclaim_fn = reclaim_fn or reclaim_for
    admitted = []
    while st.queue:
        j = pick_fn(st)
        if j is None:
            break
        req = st.queue[j]
        i = next((k for k, s in enumerate(st.slots)
                  if s.state == "free"), None)
        if i is None:
            v = preempt_victim(st, req)
            if v is None:
                break
            preempt_fn(st, v, pool)
            i = v
        plan = plan_fn(st, i, req)
        if plan.readback:
            # readbacks consume free device blocks: reclaim for the
            # full footprint (fresh + staged) before staging, and when
            # staging still cannot proceed fall back to the resident
            # prefix — a spilled hit never wedges an admission
            need = plan.n_new + len(plan.readback)
            staged = None
            if reclaim_fn(st, dataclasses.replace(plan, n_new=need),
                          pool):
                staged = stage_readbacks(st, plan, pool)
            plan = staged or _resident_prefix_plan(st.cfg, plan, req)
        new = pool.grant(i, plan)
        if new is None and reclaim_fn(st, plan, pool):
            new = pool.grant(i, plan)
        if new is None and (plan.shared or plan.cow_src is not None):
            # block pressure beats prefix reuse: the request's OWN
            # cached blocks may be most of the pool (they are
            # reclaim-protected while the plan references them), so a
            # serveable request must never wedge behind its hit —
            # degrade to a fresh full-recompute plan and reclaim for
            # that instead
            need = blocks_for(st.cfg, req)
            plan = AdmitPlan(n_new=need, miss_blocks=need)
            if reclaim_fn(st, plan, pool):
                new = pool.grant(i, plan)
        if new is None:         # pool exhausted: request stays queued
            st.counters["grant_refusals"] += 1
            break
        # delete by IDENTITY, not by the picked index: the preemption
        # above requeued its victim, which may have shifted `j`
        for k, r in enumerate(st.queue):
            if r is req:
                del st.queue[k]
                break
        st.slots[i] = _Slot(
            state="prefill", req=req, pos=plan.start,
            gen_left=req.gen_len, start_tick=st.tick,
            last_progress=st.tick, path=preferred_path(st, i))
        st.counters["admitted"] += 1
        st.counters["prefix_hit_blocks"] += plan.hit_blocks
        st.counters["prefix_miss_blocks"] += plan.miss_blocks
        if plan.cow_src is not None:
            st.counters["cow_copies"] += 1
        admitted.append(i)
    return admitted


def watchdog(st: SchedulerState, fault):
    """Sweep the slot table: failed slots fault immediately, slots with
    no progress past the SLO deadline trip the timeout. ``fault(i,
    reason)`` is the engine's `_fault_slot` (or `fault_slot` below).
    ``slo_ticks=None`` is the DISARMED mode: no sweep at all — a
    wedged slot is left for the run loop's no-progress tripwire (the
    detectable form of the hang the watchdog exists to prevent)."""
    if st.cfg.slo_ticks is None:
        return
    for i, s in enumerate(st.slots):
        if s.state == "free":
            continue
        if s.failed:
            fault(i, "slot_failure")
        elif st.tick - s.last_progress > st.cfg.slo_ticks:
            fault(i, "slo_timeout")


def cached_len(st: SchedulerState, i: int) -> int:
    """Tokens resident in slot `i`'s pages, derived purely from
    control-plane state: prefill progress plus one append per decode
    tick (the first token emits from the final prefill chunk and is
    appended by the NEXT decode step, so the last emitted token is
    never resident)."""
    s = st.slots[i]
    return s.pos + max(0, len(s.out) - 1)


def release_to_cache(st: SchedulerState, i: int, pool, *,
                     quarantining: bool = False):
    """Release slot `i`'s pages with the radix-cache retention rule:
    every FULL block of computed KV (prompt and generated tokens both)
    registers in the prefix tree and stays resident at refcount 0;
    everything else returns to the free list as refcounts drop. A
    block whose token chunk is already cached is a duplicate and is
    freed, not double-cached. Megakernel-path slots retain only their
    prefill-written blocks — their decode appends live in the
    megakernel pool, so the engine-pool copies of generated rows are
    stale and must never be shared."""
    s = st.slots[i]
    cached = ()
    if st.prefix is not None and s.req is not None:
        row = pool.row(i)       # once: the engine's row() is a
        #                         device->host block-table read
        n_rows = cached_len(st, i)
        if s.path == "megakernel":
            n_rows = min(n_rows, s.pos)
        n_full = n_rows // st.cfg.block
        if n_full:
            p = min(s.pos, n_rows)
            toks = [int(t) for t in s.req.ids[:p]] \
                + [int(t) for t in s.out[:max(0, n_rows - p)]]
            st.prefix.insert(toks, row[:n_full], s.req.rid)
        cached = tuple(b for b in row if b in st.prefix.blocks)
    pool.release(i, quarantining=quarantining, cached=cached)


def fault_slot(st: SchedulerState, i: int, reason: str, pool):
    """Recovery path for a faulted slot: demote the slot's decode-path
    health one rung, release its pages into the prefix cache (the
    retry's re-admission starts from the cached prefix), and requeue
    the request with capped exponential backoff — or quarantine it
    after max_faults attempts. The rest of the batch never stops.
    Returns ("requeue", req, delay) or ("quarantine", req, 0) so the
    engine can top up its progress budget for the retry."""
    cfg = st.cfg
    s = st.slots[i]
    req = s.req
    st.health[i].trip(s.path)
    st.fault_log.append((st.tick, req.rid, reason, s.path))
    st.counters["evicted"] += 1
    will_quarantine = req.faults + 1 > cfg.max_faults
    release_to_cache(st, i, pool, quarantining=will_quarantine)
    st.slots[i] = _Slot()
    req.faults += 1
    if will_quarantine:
        st.quarantined[req.rid] = reason
        return "quarantine", req, 0
    delay = min(cfg.backoff_cap,
                cfg.backoff_ticks * (2 ** (req.faults - 1)))
    req.not_before = st.tick + delay
    requeue(st, req)
    return "requeue", req, delay


def pick_prefill(st: SchedulerState) -> int | None:
    """The prefill slot served this tick: lowest arrival id among
    schedulable prefill slots (round-robin fairness falls out of FIFO
    admission + one chunk per tick)."""
    best = None
    for i, s in enumerate(st.slots):
        if s.state != "prefill" or sidelined(st, i):
            continue
        if best is None or s.req.rid < st.slots[best].req.rid:
            best = i
    return best


def prefill_args(st: SchedulerState, i: int) -> tuple:
    """(offset, valid) of slot ``i``'s next prefill chunk."""
    s = st.slots[i]
    return s.pos, min(len(s.req.ids) - s.pos, st.cfg.prefill_chunk)


def prefill_advance(st: SchedulerState, i: int, valid: int) -> bool:
    """Record one cached prefill chunk; the final chunk flips the slot
    to decode (its first token emits from that chunk's logits). Returns
    True when prefill completed."""
    s = st.slots[i]
    s.pos += valid
    s.last_progress = st.tick
    st.counters["prefill_chunks"] += 1
    if s.pos >= len(s.req.ids):
        s.state = "decode"
        return True
    return False


def emit(st: SchedulerState, i: int, tok: int = 0):
    """Control-plane half of emitting one token from slot ``i``. The
    token value rides into the slot's `out` trail — the prefix cache
    keys generated blocks by it (the checker emits 0s; its invariants
    never depend on token values)."""
    s = st.slots[i]
    s.out.append(tok)
    s.last_tok = tok
    s.gen_left -= 1
    s.last_progress = st.tick
    st.counters["tokens"] += 1


# ---------------------------------------------------------------------------
# Speculative decode transitions: propose / verify / rollback
# ---------------------------------------------------------------------------

def spec_clamp(st: SchedulerState, i: int, k: int,
               room: int | None = None) -> int:
    """The verify width slot ``i`` may actually use this tick: at most
    ``k`` candidate rows (the slot's last token plus k-1 drafts),
    clamped to the tokens the request still owes (`gen_left` — rows
    past the final emission would land outside the slot's block grant)
    and to ``room`` (the megakernel path's page-window budget: the
    single-panel RMW append must not cross its page, so k is bounded by
    tile_m - cache_len % tile_m; engine-path appends scatter per row
    and pass None). Always >= 1: width 1 IS the plain decode step."""
    s = st.slots[i]
    k = max(1, min(int(k), s.gen_left))
    if room is not None:
        k = max(1, min(k, int(room)))
    return k


def propose_spec(st: SchedulerState, i: int, drafts) -> int:
    """Record slot ``i``'s pending draft tokens for this tick's verify
    step. Returns the verify width (1 + len(drafts)); `verify_outcome`
    consumes the drafts. Counters bill proposals here — the drafter ran
    whether or not verification accepts anything."""
    s = st.slots[i]
    s.drafted = [int(t) for t in drafts]
    st.counters["spec_proposed"] += len(s.drafted)
    return 1 + len(s.drafted)


def verify_outcome(st: SchedulerState, i: int, accepted: int) -> int:
    """Commit one verify step's host-side greedy verdict: ``accepted``
    drafts matched the model's own predictions, so the slot emits
    accepted + 1 tokens (the accepted prefix plus the first corrected
    token) — clamped to `gen_left`, because a request never emits past
    its grant (the no-double-emit half of the token-conservation
    invariant `sanitizer --serve` certifies). Clears the pending
    drafts and updates the acceptance counters. Returns n_emit >= 1;
    the CALLER emits (the engine through its stream callback, the
    checker through `emit`) and then rolls the data plane back with
    `rollback_spec`."""
    s = st.slots[i]
    drafts = len(s.drafted)
    accepted = max(0, min(int(accepted), drafts))
    st.counters["spec_accepted"] += accepted
    st.counters["spec_rejected"] += drafts - accepted
    s.drafted = []
    return max(1, min(accepted + 1, s.gen_left))


def rollback_spec(st: SchedulerState, i: int, lens0: int, n_emit: int,
                  k_eff: int, pool) -> int:
    """The rollback half of a verify step: the data plane appended
    ``k_eff`` candidate rows at [lens0, lens0 + k_eff) but only
    ``n_emit`` became real tokens — trim the slot back to lens0 +
    n_emit through the pool's truncate (a block-table edit on the real
    `PagedKVCache`, a lens trim on the checker's `BlockAlloc`; both
    guard the CoW-shared/cached prefix boundary). Rejected rows past
    the new length are invisible garbage future appends rewrite.
    Counts the tail blocks the rollback emptied (`rollback_blocks` —
    the waste currency perf_model.choose_spec_k amortizes). Returns
    the new resident length."""
    new_len = lens0 + n_emit
    if n_emit < k_eff:
        blk = st.cfg.block
        st.counters["rollback_blocks"] += (
            -(-(lens0 + k_eff) // blk) - (-(-new_len // blk)))
        pool.truncate(i, new_len)
    return new_len


def finish_ready(st: SchedulerState, i: int) -> bool:
    return st.slots[i].gen_left <= 0


def finish(st: SchedulerState, i: int, pool):
    """Mid-stream eviction of a COMPLETED request: full computed
    blocks stay warm in the prefix cache, the rest go back to the free
    list, the slot admits the next request on the following tick, live
    neighbors never notice."""
    req = st.slots[i].req
    st.finished.append(req.rid)
    release_to_cache(st, i, pool)
    st.slots[i] = _Slot()
    st.counters["finished"] += 1
    # the fairness ledger bills SERVICE DELIVERED: one completion per
    # request, however many admissions its retries/preemptions took
    st.tenant_served[req.tenant] = \
        st.tenant_served.get(req.tenant, 0) + 1


def decode_live(st: SchedulerState) -> list:
    return [i for i, s in enumerate(st.slots)
            if s.state == "decode" and not sidelined(st, i)]


def partition_decode(st: SchedulerState, live: list, has_mk: bool):
    """The degradation-ladder partition of one decode tick: slots whose
    path is the persistent megakernel ride it, demoted slots ride the
    engine/XLA step in the SAME tick — a demotion moves a slot between
    the two lists, it never drops it (the ladder-completeness invariant
    the model checker certifies)."""
    mk_live = [i for i in live
               if has_mk and st.slots[i].path == "megakernel"]
    eng_live = [i for i in live if i not in mk_live]
    return mk_live, eng_live


def capacity_rows(st: SchedulerState, i: int) -> int:
    """Routed rows slot ``i`` contributes to this tick's EP dispatch:
    one decode token, plus the draft tokens a spec verify carries
    (verify width x expert routing — every candidate row routes).
    When spec is armed but drafts are not proposed yet — the engine
    partitions BEFORE drafting — the budget charges the full verify
    width spec_k: a conservative, deterministic admission rule (the
    adaptive policy may draft fewer, never more; SchedCfg refuses
    spec_k > ep_capacity at construction so the charge always fits)."""
    s = st.slots[i]
    return max(1 + len(s.drafted),
               st.cfg.spec_k if st.cfg.spec_k else 1)


def partition_capacity(st: SchedulerState, live: list, ledger=None):
    """The EP continuous-batching partition of one decode tick: serve
    live decode slots oldest-progress-first —
    ordered by (last_progress, rid), the same deterministic
    FIFO-by-arrival convention as requeue — until the per-tick
    expert-capacity budget (`SchedCfg.ep_capacity`, in routed rows) is
    spent; the rest are DEFERRED. A deferred slot simply does not
    appear in this tick's decode masks: its state, pages, and emitted
    stream are untouched, so "requeued, never lost" and
    prefix-consistency are structural, not recovered. Because a
    deferred slot's last_progress stays old, it sorts first next tick
    — the starvation bound (ceil(live rows / capacity) ticks) the
    model checker certifies. A single slot routing more rows than the
    whole budget could never be served; that is a loud error, the
    over-capacity silent drop models/qwen_moe.py guards against.

    ``ledger`` is the pure :class:`CapacityLedger` twin (the checker
    always passes one; the engine may for stats) — charges/deferrals
    go through it so overcommit and starvation are loud."""
    cap = st.cfg.ep_capacity
    if cap <= 0:
        return list(live), []
    if ledger is not None:
        ledger.open_tick(st.tick)
    order = sorted(live, key=lambda i: (st.slots[i].last_progress,
                                        st.slots[i].req.rid))
    served, deferred, used = [], [], 0
    for i in order:
        rows = capacity_rows(st, i)
        if rows > cap:
            raise ValueError(
                f"partition_capacity: slot {i} routes {rows} rows but "
                f"ep_capacity is {cap} — this slot can never be "
                f"served (over-capacity drop would be silent)")
        if used + rows <= cap:
            used += rows
            served.append(i)
            if ledger is not None:
                ledger.charge(i, rows)
        else:
            deferred.append(i)
            if ledger is not None:
                ledger.defer(i)
    served.sort()
    deferred.sort()
    st.counters["capacity_drops"] += len(deferred)
    st.counters["ep_rows"] += used
    return served, deferred


# ---------------------------------------------------------------------------
# Pure free-list allocator: the PagedKVCache block allocator's twin
# ---------------------------------------------------------------------------

class BlockAlloc:
    """Explicit-block-id refcounted allocator implementing EXACTLY the
    `PagedKVCache` policy (paged_kv_cache.py): a stable argsort over
    the in-use mask hands out free blocks lowest-index-first, grants
    are all-or-nothing, prefix grants bump shared refcounts and clone
    the copy-on-write source, and a release decrements — blocks
    reaching refcount 0 return to the free list unless the radix cache
    retains them (``cached``), in which case ``reclaim`` is the only
    way back. The model checker allocates through this (block ids make
    refcount conservation and cross-slot aliasing directly checkable)
    and tests/test_serve_model.py cross-checks it step-for-step
    against the real cache so the two can never drift."""

    def __init__(self, total: int, b_max: int, *, sp_ranks: int = 1,
                 bpr: int = 0, host_blocks: int = 0):
        if sp_ranks > 1:
            if total % sp_ranks:
                raise ValueError(
                    f"BlockAlloc(sp_ranks={sp_ranks}): pool of {total} "
                    f"blocks does not split over {sp_ranks} ranks")
            if bpr <= 0:
                raise ValueError(
                    "BlockAlloc(sp_ranks>1) needs bpr (table columns "
                    "per rank) to map column -> owning rank")
            if host_blocks:
                raise ValueError(
                    "BlockAlloc(sp_ranks>1): the host spill tier is "
                    "tp-only — the sequence-sharded pool cannot remap "
                    "readbacks across rank slices")
        self.total = total
        self.sp_ranks = sp_ranks
        self.bpr = bpr                      # table columns per rank
        self.free = list(range(total))      # ascending == argsort order
        self.held = {i: () for i in range(b_max)}
        self.lens = [0] * b_max             # seq_lens twin (append walk)
        self.refs = [0] * total             # per-block reference counts
        self.cached = set()                 # refcount-0, radix-retained
        # --- host spill tier ---
        self.host_total = host_blocks
        self.hfree = list(range(host_blocks))
        self.hosted = {}        # host slot -> "inflight" | "ready"
        self.tainted = set()    # device blocks read back mid-DMA
        self.scaled = set()     # scale-sidecar lockstep twin: blocks
        # whose sidecar rows hold live (nonzero) scales — must never
        # intersect the free list (the cache zeroes on free)

    def clone(self) -> "BlockAlloc":
        new = BlockAlloc.__new__(BlockAlloc)
        new.total = self.total
        new.sp_ranks = self.sp_ranks
        new.bpr = self.bpr
        new.free = list(self.free)
        new.held = dict(self.held)
        new.lens = list(self.lens)
        new.refs = list(self.refs)
        new.cached = set(self.cached)
        new.host_total = self.host_total
        new.hfree = list(self.hfree)
        new.hosted = dict(self.hosted)
        new.tainted = set(self.tainted)
        new.scaled = set(self.scaled)
        return new

    def free_count(self) -> int:
        return len(self.free)

    def host_free_count(self) -> int:
        return len(self.hfree)

    def spill(self, b: int) -> int:
        """Move cached refcount-0 device block ``b`` to the host tier:
        the device block returns to the free list (its sidecar scales
        zero with it) and a host slot starts its DMA ("inflight" until
        the next tick's `complete_dma`). Returns the host slot.
        Spilling a referenced, non-cached, or tier-full block is a
        loud error."""
        if self.refs[b] > 0:
            raise ValueError(
                f"spill({b}): block still referenced "
                f"(refcount {self.refs[b]})")
        if b not in self.cached:
            raise ValueError(
                f"spill({b}): block is not cached — only radix-"
                f"retained blocks spill")
        if not self.hfree:
            raise ValueError("spill: host tier full")
        self.cached.discard(b)
        bisect.insort(self.free, b)
        self.scaled.discard(b)
        slot = self.hfree.pop(0)
        self.hosted[slot] = "inflight"
        return slot

    def complete_dma(self):
        """Tick boundary: every in-flight spill DMA lands."""
        for slot, state in self.hosted.items():
            if state == "inflight":
                self.hosted[slot] = "ready"

    def readback_ready(self, slot: int) -> bool:
        return self.hosted.get(slot) == "ready"

    def host_evict(self, slot: int):
        """Host-tier LRU eviction: drop host slot ``slot``'s
        KV so a newer spill can take it. Evicting a free slot is a
        double-free; evicting an in-flight slot is a loud error too —
        it was staged THIS tick, so it is never the LRU pick."""
        if slot not in self.hosted:
            raise ValueError(
                f"host_evict({slot}): host slot not occupied")
        if self.hosted[slot] != "ready":
            raise ValueError(
                f"host_evict({slot}): spill DMA still in flight")
        del self.hosted[slot]
        bisect.insort(self.hfree, slot)

    def readback(self, slot: int) -> int:
        """Stream host slot ``slot`` back into the lowest-index free
        device block, which re-enters the radix-cached state (refcount
        0, retained — the admission grant bumps it like any shared
        block). Reading back a free or in-flight slot is a loud
        error."""
        if slot not in self.hosted:
            raise ValueError(f"readback({slot}): host slot not occupied")
        if self.hosted[slot] != "ready":
            raise ValueError(
                f"readback({slot}): spill DMA still in flight")
        if not self.free:
            raise ValueError("readback: no free device block")
        b = self.free.pop(0)
        del self.hosted[slot]
        bisect.insort(self.hfree, slot)
        self.refs[b] = 0
        self.cached.add(b)
        self.scaled.add(b)
        return b

    def refcnt(self, b: int) -> int:
        return self.refs[b]

    def refcnts(self):
        """Refcount snapshot (the reclaim path reads it once)."""
        return list(self.refs)

    def row(self, slot: int) -> tuple:
        return self.held[slot]

    def assign(self, slot: int, n: int) -> bool:
        """All-or-nothing grant of the ``n`` lowest-index free blocks
        (the stable-argsort free list), refcount 1 each. Mirrors
        assign_slot's host guard: granting over a held slot is a loud
        error."""
        got = self.grant(slot, AdmitPlan(n_new=n))
        return got is not None

    def grant(self, slot: int, plan: AdmitPlan):
        """Execute an AdmitPlan: map ``plan.shared`` with refcount
        bumps, grant ``plan.n_new`` fresh blocks lowest-index-first
        (the first replaces the CoW source in the row when
        ``plan.cow_src`` is set), start the length twin at
        ``plan.start``. Returns the fresh block ids, or None when the
        free list cannot cover them (all-or-nothing)."""
        if self.held[slot]:
            raise ValueError(
                f"assign({slot}): slot still holds {len(self.held[slot])}"
                f" block(s) — call release first")
        if self.sp_ranks > 1:
            return self._grant_sp(slot, plan)
        if plan.n_new > len(self.free):
            return None
        if plan.cow_src is not None and plan.n_new < 1:
            raise ValueError("copy-on-write needs a fresh destination "
                             "block (n_new >= 1)")
        fresh = tuple(self.free[:plan.n_new])
        del self.free[:plan.n_new]
        rest = list(fresh)
        row = list(plan.shared)
        if plan.cow_src is not None:
            row.append(rest.pop(0))
        row += rest
        for b in plan.shared:
            self.refs[b] += 1
            self.cached.discard(b)      # referenced again: held, not cached
        for b in fresh:
            self.refs[b] = 1
            self.scaled.add(b)          # appends will write scale rows
        self.held[slot] = tuple(row)
        self.lens[slot] = plan.start
        return fresh

    def _grant_sp(self, slot: int, plan: AdmitPlan):
        """Sequence-sharded grant twin of `PagedKVCache.assign_slot(
        sp_ranks=n)`: table column j draws from rank (j // bpr)'s slice
        of the pool ([r*nb_loc, (r+1)*nb_loc)), lowest local index
        first, all-or-nothing ACROSS RANKS — one exhausted rank refuses
        the whole grant even with free blocks elsewhere (the rank-local
        admission rule the checker certifies). Prefix plans are
        tp-only and refuse loudly."""
        if plan.shared or plan.cow_src is not None:
            raise ValueError(
                "prefix/CoW plans are tp-only: the sequence-sharded "
                "pool cannot remap cached blocks across rank slices")
        n, bpr = self.sp_ranks, self.bpr
        nb_loc = self.total // n
        if plan.n_new > n * bpr:
            return None
        picks = []
        for r in range(n):
            need_r = min(max(plan.n_new - r * bpr, 0), bpr)
            lo = r * nb_loc
            avail = [b for b in self.free if lo <= b < lo + nb_loc]
            if need_r > len(avail):
                return None         # one short rank refuses the grant
            picks.append(avail[:need_r])
        fresh = tuple(b for rank_blocks in picks for b in rank_blocks)
        for b in fresh:
            self.free.remove(b)
            self.refs[b] = 1
            self.scaled.add(b)
        self.held[slot] = fresh
        self.lens[slot] = plan.start
        return fresh

    def release(self, slot: int, quarantining: bool = False,
                cached=()):
        """Decrement the slot's block refcounts; blocks reaching 0
        return to the sorted free list unless ``cached`` (the radix
        tree's membership set) retains them."""
        if not self.held[slot]:
            raise ValueError(
                f"release({slot}): slot holds no blocks — double-free "
                f"or release of an unassigned slot")
        for b in self.held[slot]:
            self.refs[b] -= 1
            if self.refs[b] > 0:
                continue
            if b in cached:
                self.cached.add(b)      # content (and scales) retained
            else:
                bisect.insort(self.free, b)
                self.scaled.discard(b)  # free_slot zeroes the sidecar
        self.held[slot] = ()
        self.lens[slot] = 0

    def truncate(self, slot: int, new_len: int, cached=(),
                 min_blocks: int = 0, block: int | None = None):
        """Speculative-rollback twin of `PagedKVCache.truncate_slot`:
        trim the slot's length to ``new_len`` and drop tail table
        columns past max(ceil(new_len / block), min_blocks) through
        the refcount path (``cached`` retains, like release). Guards
        mirror the cache exactly: non-resident slot, growing, or an
        append boundary left inside a shared/cached block are loud
        errors. ``block`` defaults to inferring nothing — pass the
        page size when tail trimming is wanted; with min_blocks >=
        held (the serving scheduler's form) only the length trims.
        Returns the freed block ids."""
        if not self.held[slot]:
            raise ValueError(
                f"truncate({slot}): slot holds no blocks — rollback "
                f"of an unassigned/evicted slot")
        if new_len < 0 or new_len > self.lens[slot]:
            raise ValueError(
                f"truncate({slot}): new_len {new_len} outside "
                f"[0, {self.lens[slot]}] — rollback can only trim")
        held = list(self.held[slot])
        blk = block if block is not None else 0
        keep_cols = len(held) if blk <= 0 else min(
            len(held), max(-(-new_len // blk), int(min_blocks)))
        cached = set(cached)
        if blk > 0:
            for col in range(new_len // blk, keep_cols):
                b = held[col]
                if self.refs[b] >= 2 or b in self.cached \
                        or b in cached:
                    raise ValueError(
                        f"truncate({slot}): new_len {new_len} leaves "
                        f"the append boundary inside shared/cached "
                        f"block {b} (column {col})")
        freed = []
        for b in held[keep_cols:]:
            self.refs[b] -= 1
            if self.refs[b] > 0:
                continue
            if b in cached:
                self.cached.add(b)
            else:
                bisect.insort(self.free, b)
                self.scaled.discard(b)  # truncate_slot zeroes the tail
                freed.append(b)
        self.held[slot] = tuple(held[:keep_cols])
        self.lens[slot] = new_len
        return tuple(freed)

    def reclaim(self, ids):
        """Return refcount-0 cached blocks to the free list (the LRU
        pressure path). Reclaiming a live or already-free block is a
        loud error — the misuse the cached-aliasing detector exists
        for."""
        for b in ids:
            if self.refs[b] > 0:
                raise ValueError(
                    f"reclaim({b}): block still referenced "
                    f"(refcount {self.refs[b]})")
            if b not in self.cached:
                raise ValueError(
                    f"reclaim({b}): block is not cached — double "
                    f"reclaim or reclaim of a free block")
            self.cached.discard(b)
            bisect.insort(self.free, b)
            self.scaled.discard(b)      # reclaim_blocks zeroes the sidecar

    def append(self, slot: int):
        """Advance the slot's sequence one token (the decode append's
        allocator-visible effect)."""
        self.lens[slot] += 1

    def steal(self, n: int) -> tuple:
        """Chaos block-exhaustion: ``n`` free blocks vanish behind the
        allocator's back (marked in-use with no owner). Returns the
        stolen ids for the paired un-steal."""
        take = tuple(self.free[:n])
        del self.free[:len(take)]
        return take

    def unsteal(self, ids):
        for b in ids:
            bisect.insort(self.free, b)


# ---------------------------------------------------------------------------
# Pure expert-capacity ledger: the EP dispatch budget's BlockAlloc twin
# ---------------------------------------------------------------------------

class CapacityLedger:
    """Per-tick expert-capacity accounting with the same role
    :class:`BlockAlloc` plays for blocks: the model checker
    routes every `partition_capacity` decision through this pure twin
    so overcommit (charging past the budget), double-charging a slot,
    and starvation (a slot deferred more than ``starve_bound``
    consecutive ticks) are LOUD errors inside the explored state, not
    properties asserted after the fact. The engine may carry one too —
    the charge/defer trace it records is the per-tick EP plan's
    ground truth (stats()["ep"])."""

    def __init__(self, capacity: int, starve_bound: int | None = None):
        if capacity <= 0:
            raise ValueError(
                f"CapacityLedger(capacity={capacity}): the ledger "
                f"models an armed budget; 0 disables at SchedCfg")
        self.capacity = capacity
        self.starve_bound = starve_bound
        self.tick = -1
        self.used = 0
        self.charged: dict = {}   # slot -> rows, this tick
        self.deferred: tuple = ()
        self.starve: dict = {}    # slot -> consecutive deferrals

    def clone(self) -> "CapacityLedger":
        new = CapacityLedger.__new__(CapacityLedger)
        new.capacity = self.capacity
        new.starve_bound = self.starve_bound
        new.tick = self.tick
        new.used = self.used
        new.charged = dict(self.charged)
        new.deferred = self.deferred
        new.starve = dict(self.starve)
        return new

    def open_tick(self, tick: int):
        if tick < self.tick:
            raise ValueError(
                f"open_tick({tick}): ledger already at tick "
                f"{self.tick} — the budget clock only moves forward")
        self.tick = tick
        self.used = 0
        self.charged = {}
        self.deferred = ()

    def charge(self, slot: int, rows: int):
        if rows <= 0:
            raise ValueError(f"charge({slot}, {rows}): rows must be "
                             f"positive")
        if slot in self.charged:
            raise ValueError(
                f"charge({slot}): slot already charged "
                f"{self.charged[slot]} row(s) this tick — a slot "
                f"dispatches at most once per tick")
        if self.used + rows > self.capacity:
            raise ValueError(
                f"charge({slot}, {rows}): {self.used} of "
                f"{self.capacity} rows already spent this tick — "
                f"overcommit (the silent-drop budget violation)")
        self.used += rows
        self.charged[slot] = rows
        self.starve.pop(slot, None)

    def defer(self, slot: int):
        if slot in self.charged:
            raise ValueError(
                f"defer({slot}): slot was charged this tick — a slot "
                f"is served or deferred, never both")
        self.deferred += (slot,)
        n = self.starve.get(slot, 0) + 1
        self.starve[slot] = n
        if self.starve_bound is not None and n > self.starve_bound:
            raise ValueError(
                f"defer({slot}): deferred {n} consecutive ticks, past "
                f"the starvation bound {self.starve_bound} — "
                f"oldest-progress-first ordering was violated")


# ---------------------------------------------------------------------------
# Multi-rank TP consistency ledger: the distributed control plane's twin
# ---------------------------------------------------------------------------

class RankLedger:
    """Per-rank consistency ledger for multi-rank TP serving. The
    control plane computes every scheduling decision ONCE and
    applies it as identical edits on all `tp_ranks` ranks; this ledger
    mirrors, per rank, exactly the slot-table state the data plane
    reads on that rank — the block-table row (block ownership: the
    pool is head-sharded, so block IDS are global and must match
    everywhere), the sequence length (the decode queue's cache_len
    patch column), and the emitted-token count. `divergence()` is the
    detector: any rank whose view differs from rank 0's is a
    split-brain control plane, the failure mode the tp2 checker config
    exhaustively certifies against (a seeded skip-rank mutation proves
    the detector live). The engine carries one too — its per-rank
    stats() counters are this ledger's rows, so divergence is
    observable from the first deploy, not just under the checker."""

    def __init__(self, n_ranks: int, b_max: int):
        if n_ranks < 1:
            raise ValueError(
                f"RankLedger(n_ranks={n_ranks}): need >= 1 rank")
        self.n_ranks = n_ranks
        self.b_max = b_max
        self.rows = [[() for _ in range(b_max)] for _ in range(n_ranks)]
        self.lens = [[0] * b_max for _ in range(n_ranks)]
        self.emitted = [[0] * b_max for _ in range(n_ranks)]

    def clone(self) -> "RankLedger":
        new = RankLedger.__new__(RankLedger)
        new.n_ranks = self.n_ranks
        new.b_max = self.b_max
        new.rows = [list(r) for r in self.rows]
        new.lens = [list(r) for r in self.lens]
        new.emitted = [list(r) for r in self.emitted]
        return new

    def _ranks(self, ranks):
        return range(self.n_ranks) if ranks is None else ranks

    # Every mutator takes ``ranks=None`` (all ranks — the correct
    # control plane). A subset is the checker's seeded-mutation surface:
    # "the edit reached only these ranks", the bug class the divergence
    # detector exists for.

    def set_row(self, slot: int, row, length: int, ranks=None):
        """A grant/truncate landed: slot's table row becomes exactly
        ``row`` with ``length`` tokens resident."""
        row = tuple(int(b) for b in row)
        for r in self._ranks(ranks):
            self.rows[r][slot] = row
            self.lens[r][slot] = int(length)

    def release(self, slot: int, ranks=None):
        for r in self._ranks(ranks):
            self.rows[r][slot] = ()
            self.lens[r][slot] = 0
            self.emitted[r][slot] = 0

    def set_len(self, slot: int, length: int, ranks=None):
        """Prefill advance / append / rollback: only the cache_len
        patch column moves."""
        for r in self._ranks(ranks):
            self.lens[r][slot] = int(length)

    def append(self, slot: int, n: int = 1, ranks=None):
        for r in self._ranks(ranks):
            self.lens[r][slot] += n

    def emit(self, slot: int, n: int = 1, ranks=None):
        for r in self._ranks(ranks):
            self.emitted[r][slot] += n

    def rank_view(self, r: int) -> tuple:
        return (tuple(self.rows[r]), tuple(self.lens[r]),
                tuple(self.emitted[r]))

    def signature(self) -> tuple:
        """Canonical content signature (model-checker state dedup):
        rank 0's full view plus each other rank's DIFF from it —
        identical ranks (the steady state) collapse to a single view's
        worth of signature."""
        base = self.rank_view(0)
        sig = (base,)
        for r in range(1, self.n_ranks):
            v = self.rank_view(r)
            sig += (() if v == base else (r, v),)
        return sig

    def held_blocks(self, r: int) -> int:
        """Distinct blocks rank ``r`` believes are table-mapped."""
        return len({b for row in self.rows[r] for b in row})

    def divergence(self) -> str | None:
        """None when every rank agrees with rank 0, else a message
        naming the first diverging (rank, slot, field) — block
        ownership, queue patch (cache_len), or emitted tokens."""
        for r in range(1, self.n_ranks):
            for i in range(self.b_max):
                if self.rows[r][i] != self.rows[0][i]:
                    return (f"rank {r} slot {i} block ownership "
                            f"diverged: {self.rows[r][i]} vs rank 0's "
                            f"{self.rows[0][i]}")
                if self.lens[r][i] != self.lens[0][i]:
                    return (f"rank {r} slot {i} cache_len patch "
                            f"diverged: {self.lens[r][i]} vs rank 0's "
                            f"{self.lens[0][i]}")
                if self.emitted[r][i] != self.emitted[0][i]:
                    return (f"rank {r} slot {i} emitted tokens "
                            f"diverged: {self.emitted[r][i]} vs rank "
                            f"0's {self.emitted[0][i]}")
        return None
