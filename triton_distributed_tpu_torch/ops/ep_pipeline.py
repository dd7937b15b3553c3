"""Chunked EP MoE forward: dispatch, grouped expert MLP and combine over S
token chunks (counterpart of triton_distributed_tpu/ops/ep_pipeline.py).

The local batch is split into S chunks; `issue="pipelined"` issues chunk
i + 1's dispatch before chunk i's expert MLP, `issue="sequential"` runs
the chunks back to back. On one CUDA stream the two orders are the same
math in the same order of kernels but for where the dispatches sit; a
later change that puts transports on their own streams needs no change
to the protocol, because every in-flight chunk's dispatch and combine
own their workspace (their own collective id, as the JAX kernels get
their own `collective_id`).
"""

from __future__ import annotations

import torch

from ._common import record_dispatch
from .ep_a2a import default_capacity, ep_combine_shard, ep_dispatch_shard

# collective ids of the pipeline's transports: chunk i dispatches on
# EP_PIPELINE_COLLECTIVE_ID + 2 i and combines on + 2 i + 1 (the flat
# dispatch and combine of ops/ep_a2a.py take 0 and 1)
EP_PIPELINE_COLLECTIVE_ID = 16

TUNE_LATER = ('EPMoE(pipeline="tune") (resolve_pipeline_chunks, the '
              "measured chunk count) waits for the autotuner: ROADMAP.md "
              "Queue A, slice 7")


def resolve_num_chunks(m_tokens: int, num_chunks: int) -> int:
    """The chunk count that runs: `num_chunks` when it splits the local
    batch into equal non-empty chunks, else 1 (logged as a fallback)."""
    s = max(1, int(num_chunks))
    if s > 1 and (m_tokens % s != 0 or m_tokens // s == 0):
        record_dispatch("ep_pipeline", "sequential",
                        f"m_indivisible:{m_tokens}%{s}")
        return 1
    return s


def ep_moe_pipeline_shard(x, experts, weights, compute_fn, *, num_ranks: int,
                          num_experts: int, num_chunks: int = 1,
                          capacity: int | None = None,
                          method: str = "ragged", chunk: int = 128,
                          wire_dtype=None, issue: str = "pipelined"):
    """Chunked EP MoE forward, every rank at once.

    x: (n, M, H) rank-stacked tokens; experts / weights: (n, M, top_k).
    compute_fn(recv (n, n, C, H), recv_ids (n, n, C)) -> (n, n, C, H)
    expert outputs in receive-slot order. `capacity` is per chunk; None
    sizes each chunk's worst case. Returns (n, M, H)."""
    if issue not in ("pipelined", "sequential"):
        raise ValueError(f"issue {issue!r}: choose 'pipelined' or "
                         f"'sequential'")
    n, m_tokens, top_k = experts.shape
    s = resolve_num_chunks(m_tokens, num_chunks)
    if s == 1:
        record_dispatch("ep_pipeline", "sequential", "chunks=1")
    else:
        record_dispatch("ep_pipeline", issue, f"chunks={s}")
    mc = m_tokens // s
    cap = capacity or default_capacity(mc, top_k, chunk)
    xs = x.reshape(n, s, mc, x.shape[-1])
    es = experts.reshape(n, s, mc, top_k)
    ws = weights.reshape(n, s, mc, top_k)

    def dispatch(i):
        return ep_dispatch_shard(
            xs[:, i], es[:, i], num_ranks=n, num_experts=num_experts,
            capacity=cap, method=method, chunk=chunk, wire_dtype=wire_dtype,
            collective_id=EP_PIPELINE_COLLECTIVE_ID + 2 * i)

    def combine(i, y, plan, cnts):
        return ep_combine_shard(
            y, plan, ws[:, i], cnts, num_ranks=n, method=method, chunk=chunk,
            wire_dtype=wire_dtype,
            collective_id=EP_PIPELINE_COLLECTIVE_ID + 2 * i + 1)

    outs = []
    if issue == "sequential" or s == 1:
        for i in range(s):
            recv, ids, cnts, plan = dispatch(i)
            outs.append(combine(i, compute_fn(recv, ids), plan, cnts))
    else:
        pending = dispatch(0)
        for i in range(s):
            nxt = dispatch(i + 1) if i + 1 < s else None
            recv, ids, cnts, plan = pending
            outs.append(combine(i, compute_fn(recv, ids), plan, cnts))
            pending = nxt
    return torch.cat(outs, dim=1) if s > 1 else outs[0]


def resolve_pipeline_chunks(layer, params, x, candidates=(1, 2, 4, 8)):
    """The measured chunk count (EPMoE(pipeline="tune")): not ported."""
    raise NotImplementedError(TUNE_LATER)
