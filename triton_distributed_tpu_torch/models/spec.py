"""Speculative-decode drafters (counterpart of
triton_distributed_tpu/models/spec.py; pure numpy, carried over as is).

The tentpole's division of labor: a cheap DRAFTER proposes up to k-1
tokens per decode tick, the batched serving step VERIFIES them all in
one cache sweep (DenseLLM.verify_step_paged on the engine path,
MegaServe.verify on the megakernel path), and the host's greedy accept
rule keeps exactly the prefix the model itself would have generated —
so spec-on output is token-identical to spec-off by construction, and
the only variable is throughput (tokens per HBM sweep).

The drafter interface is one method::

    propose(rid, context, k) -> sequence of <= k int token ids

`context` is the request's full visible stream (prompt + emitted
tokens, the LAST element being the token the verify step re-feeds as
row 0). Returning fewer than k tokens (or none) narrows that slot's
verify width for the tick — width 1 is the plain decode step. Drafters
must be deterministic given (rid, context): storm replays and the A/B
benches depend on it.

Shipped drafters:

- :class:`NGramDrafter` — the self-drafter: proposes the continuation
  of the most recent earlier occurrence of the longest suffix n-gram.
  Free (no model), surprisingly strong on repetitive serving traffic
  (few-shot prompts, code, templated output).
- :class:`OracleDrafter` — testing/bench instrument: replays a known
  target stream with every `wrong_every`-th token corrupted, so the
  ACCEPTANCE RATE is a controlled parameter of the spec-on arm
  (chip_smoke.py's spec-on serve runs).

A draft MODEL rides the same interface: wrap its greedy continuation
in `propose` (the engine never sees the difference) — the megakernel
fast path then amortizes the big model's weight stream over k
verified tokens per launch.
"""

from __future__ import annotations

import dataclasses

import numpy as np


class NGramDrafter:
    """Suffix n-gram self-drafter: find the most recent PRIOR position
    where the longest (up to ``max_n``-token) suffix of the context
    also occurred, and propose the tokens that followed it there.
    Deterministic, zero parameters — the cheapest member of the
    drafter interface. ``window`` bounds the scan to the most recent
    tokens so per-tick draft cost stays O(window), not O(context) —
    drafting runs host-side BETWEEN device launches, and an unbounded
    rescan of a long stream would grow quadratic over a request's
    life, eating the very verify amortization it exists to buy."""

    def __init__(self, max_n: int = 3, window: int = 1024):
        if max_n < 1:
            raise ValueError(f"max_n must be >= 1, got {max_n}")
        if window < 2:
            raise ValueError(f"window must be >= 2, got {window}")
        self.max_n = int(max_n)
        self.window = int(window)

    def propose(self, rid, context, k):
        ctx = np.asarray(context).reshape(-1)[-self.window:]
        L = ctx.size
        if k <= 0 or L < 2:
            return []
        win = np.lib.stride_tricks.sliding_window_view
        for n in range(min(self.max_n, L - 1), 0, -1):
            suf = ctx[L - n:]
            # most recent prior match wins (locality beats frequency
            # on serving traffic): one vectorized compare over every
            # n-window ending before the suffix itself, then the last
            # hit — i is the match END (exclusive)
            hits = np.flatnonzero(
                (win(ctx, n)[:L - n] == suf).all(axis=1))
            if hits.size:
                i = int(hits[-1]) + n
                return [int(t) for t in ctx[i:i + k]]
        return []


class OracleDrafter:
    """Bench/test drafter with a DIALED acceptance rate: proposes the
    known target continuation (`targets`: {rid: token array} — e.g. a
    spec-off run's outputs) with every ``wrong_every``-th STREAM
    POSITION corrupted (token + 1 mod vocab), so roughly
    (wrong_every - 1) / wrong_every of drafts verify. Corruption keys
    on the per-request position, not call order, so the drafter honors
    the determinism contract (same (rid, context) -> same drafts)
    across tick interleavings, preemptions, and replays. wrong_every=0
    proposes the exact stream (acceptance 1.0). Requests absent from
    `targets` draft nothing (plain decode)."""

    def __init__(self, targets, prompts, *, wrong_every: int = 0,
                 vocab: int = 1 << 30):
        self.targets = {r: np.asarray(t).reshape(-1)
                        for r, t in targets.items()}
        self.prompts = {r: int(np.asarray(p).size)
                        for r, p in prompts.items()}
        self.wrong_every = int(wrong_every)
        self.vocab = int(vocab)

    def propose(self, rid, context, k):
        tgt = self.targets.get(rid)
        if tgt is None or k <= 0:
            return []
        done = len(np.asarray(context).reshape(-1)) - self.prompts[rid]
        out = []
        for pos in range(done, min(done + k, len(tgt))):
            t = int(tgt[pos])
            if self.wrong_every and (pos + 1) % self.wrong_every == 0:
                t = (t + 1) % self.vocab
            out.append(t)
        return out


@dataclasses.dataclass
class SpecConfig:
    """ServeEngine's speculative-decode knobs (``speculative=`` —
    True means SpecConfig() with the n-gram self-drafter). ``k`` is
    the verify width ceiling (candidate rows per slot per tick: the
    last real token plus up to k-1 drafts). ``adapt=True`` runs the
    acceptance-aware policy every tick: a per-request acceptance-rate
    EWMA (``ewma_alpha``, seeded at ``ewma_init``) feeds
    perf_model.choose_spec_k (draft cost vs verify amortization vs
    rollback waste) and the slot's width shrinks — down to 1
    (`spec_fallbacks` counter; one verify row in engine mode, while a
    megakernel launch still runs every slot_rows row) — when drafts
    stop paying for themselves. ``draft_cost_s`` is the modeled
    per-draft-token cost handed to the chooser (0 = free, the n-gram
    drafter's truth; a draft model would pass its step estimate)."""
    drafter: object = None
    k: int = 4
    adapt: bool = True
    ewma_alpha: float = 0.3
    ewma_init: float = 0.5
    draft_cost_s: float = 0.0

    def __post_init__(self):
        if self.drafter is None:
            self.drafter = NGramDrafter()
        if not isinstance(self.k, int) or isinstance(self.k, bool) \
                or self.k < 1:
            raise ValueError(f"spec k must be an int >= 1, got "
                             f"{self.k!r}")
        if not callable(getattr(self.drafter, "propose", None)):
            raise ValueError(
                f"drafter {type(self.drafter).__name__} does not "
                f"implement propose(rid, context, k)")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1], got "
                             f"{self.ewma_alpha}")
