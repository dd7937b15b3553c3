"""ServeEngine(speculative=...) of the port in engine mode (models/
serve.py's draft-verify-rollback tick over DenseLLM.verify_step_paged and
PagedKVCache.truncate_slot) against the JAX package's ServeEngine, on
the CPU.

The dense stream is the port's serving test's (tests/test_torch_serve.py)
on a 6-block pool: five requests through two slots on 4-token pages, a
shared prefix, a block-aligned duplicate prompt (copy-on-write), a pool
small enough to force LRU reclaim and grant refusals, and an interactive
request submitted from the stream callback that preempts a batch
resident; so eviction, re-admission from
the prefix cache, backpressure and preemption all happen while slots
speculate. The drafter is `OracleDrafter(spec-off outputs,
wrong_every=2)` at k = 3 without adaptation, on the shrunken tiny Qwen3
in f32 with the same weights in both packages. Greedy tokens, the block
table, lengths and free count after every tick, and every stats()
counter (the spec counters included) must equal the JAX engine's, and
the tokens the spec-off run's. The MoE case is the JAX package's
(tests/test_serve.py:937): two speculating slots against ep_capacity=2,
which defers a slot every tick. An int8 pool agrees within TOKEN_BAND.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from triton_distributed_tpu.models import DenseLLM as JaxDenseLLM
from triton_distributed_tpu.models import ServeEngine as JaxServeEngine
from triton_distributed_tpu.models import config as jax_config
from triton_distributed_tpu.models import spec as jspec
from triton_distributed_tpu.models.qwen_moe import Qwen3MoE as JaxQwen3MoE
from triton_distributed_tpu_torch import models
from triton_distributed_tpu_torch.models import serve as tserve

SHRINK = dict(hidden_size=64, num_heads=4, num_kv_heads=2, head_dim=16,
              vocab_size=128, intermediate_size=128)
ENGINE = dict(b_max=2, max_len=32, block=4, prefill_chunk=4, num_blocks=6)
COUNTERS = ("ticks", "admitted", "finished", "evictions", "requeued",
            "prefill_chunks", "tokens", "prefix_hit_blocks",
            "prefix_miss_blocks", "cow_copies", "reclaimed_blocks",
            "preemptions", "grant_refusals", "free_blocks",
            "cached_free_blocks", "total_blocks", "queue_depth",
            "occupancy", "spec_proposed", "spec_accepted", "spec_rejected",
            "acceptance_rate", "rollback_blocks", "spec_fallbacks")


def _stream():
    rng = np.random.default_rng(0)
    pre = rng.integers(0, 128, 8)
    reqs = [(np.concatenate([pre, rng.integers(0, 128, 3)]), 5),
            (rng.integers(0, 128, 6), 4),
            (np.concatenate([pre, rng.integers(0, 128, 2)]), 6),
            (pre.copy(), 4),                    # block-aligned duplicate
            (rng.integers(0, 128, 9), 3)]
    late = (rng.integers(0, 128, 5), 3)         # interactive, mid-stream
    return [(r.astype(np.int32), g) for r, g in reqs], \
        (late[0].astype(np.int32), late[1])


def _drive(se, table_of, lens_of, free_of):
    """Submit the stream, run with the mid-stream interactive submit (rid
    5, at request 3's second token), and record (block table, lengths,
    free count) after every tick."""
    reqs, late = _stream()
    for r, g in reqs:
        se.submit(r, g)
    ticks = []
    cls_tick = type(se)._tick

    def tick(stream_cb=None):
        cls_tick(se, stream_cb)
        c = se._cache
        ticks.append((table_of(c).copy(), lens_of(c).copy(), free_of(c)))

    se._tick = tick
    sent = []

    def cb(rid, tok, i):
        if rid == 3 and i == 1 and not sent:
            sent.append(se.submit(late[0], late[1], slo_class="interactive",
                                  tenant="chat"))

    out = se.run(stream_cb=cb)
    del se._tick
    return {k: list(map(int, v)) for k, v in out.items()}, ticks, se.stats()


def _oracle(pkg, targets, wrong_every=2):
    reqs, late = _stream()
    prompts = {r: p for r, (p, _) in enumerate(reqs + [late])}
    return pkg.OracleDrafter(targets, prompts, wrong_every=wrong_every,
                             vocab=128)


def _port_drive(se):
    return _drive(se, lambda c: c.block_table, lambda c: c.seq_lens,
                  lambda c: c.num_free_blocks)


def _jax_drive(se):
    return _drive(se, lambda c: np.asarray(c.block_table),
                  lambda c: np.asarray(c.seq_lens),
                  lambda c: int(c.num_free_blocks))


@pytest.fixture(scope="module")
def dense():
    mesh1 = Mesh(np.asarray(jax.devices()[:1]), ("tp",))
    cfg = jax_config.get_config("Qwen/Qwen3-8B").tiny(**SHRINK)
    jm = JaxDenseLLM(cfg, mesh=mesh1, mode="xla", dtype=jnp.float32)
    jp = jm.init_params(jax.random.PRNGKey(0))
    pm = models.DenseLLM(models.get_config("Qwen/Qwen3-8B").tiny(**SHRINK),
                         mode="xla", dtype="float32", device="cpu")
    pp = models.params_from_jax(jax.device_get(jp), device="cpu")
    off = _port_drive(models.ServeEngine(pm, pp, **ENGINE))
    return (jm, jp), (pm, pp), off


@pytest.fixture(scope="module")
def spec_runs(dense):
    (jm, jp), (pm, pp), (off, _, _) = dense
    jse = JaxServeEngine(jm, jp, attn_method="xla", **ENGINE,
                         speculative=jspec.SpecConfig(
                             drafter=_oracle(jspec, off), k=3, adapt=False))
    tse = models.ServeEngine(pm, pp, **ENGINE,
                             speculative=models.SpecConfig(
                                 drafter=_oracle(models, off), k=3,
                                 adapt=False))
    return _jax_drive(jse), _port_drive(tse), tse


def test_spec_engine_matches_jax_tick_for_tick(dense, spec_runs):
    _, _, (off, _, off_st) = dense
    (jtok, jticks, jst), (ttok, tticks, tst), tse = spec_runs
    assert ttok == jtok == off and sorted(ttok) == list(range(6))
    assert len(tticks) == len(jticks) < len(dense[2][1])
    for n, (t, j) in enumerate(zip(tticks, jticks)):
        for a, b, name in zip(t, j, ("table", "lens", "free")):
            np.testing.assert_array_equal(a, b, err_msg=f"{name}, tick {n}")
    for k in COUNTERS:
        assert tst[k] == jst[k], k
    # every mechanism ran while slots speculated
    assert tst["spec_accepted"] > 0 and tst["spec_rejected"] > 0, tst
    assert tst["rollback_blocks"] > 0 and tst["preemptions"] > 0, tst
    assert tst["prefix_hit_blocks"] > 0 and tst["grant_refusals"] > 0, tst
    assert tst["evictions"] + tst["finished"] > ENGINE["b_max"]
    # fewer decode steps than the spec-off run: verify amortized sweeps
    assert tst["decode_steps"] < off_st["decode_steps"]
    assert tst["spec_fallbacks"] == 0 and tse.trace_counts["verify"] == 0
    tse._cache.check_conservation(cached=tst["cached_free_blocks"])
    assert not tse._spec_ctx and not tse._spec_ewma   # pruned at finish


def test_spec_int8_pool_within_token_band(dense):
    """An int8 pool's spec-on stream against the f32 spec-off stream,
    under the int8 TOKEN_BAND (greedy flips below the quantization noise
    are allowed, and past a flip the streams may part)."""
    _, (pm, pp), (off, _, _) = dense
    se = models.ServeEngine(pm, pp, **ENGINE, kv_dtype="int8",
                            speculative=models.SpecConfig(
                                drafter=_oracle(models, off), k=3,
                                adapt=False))
    tok, _, st = _port_drive(se)
    rep = tserve.banded_token_identity(off, tok, kv_dtype="int8")
    assert rep["agreed_frac"] >= 1 - tserve.TOKEN_BAND["int8"]
    assert st["spec_proposed"] > 0 and st["quant_kv_bytes_saved"] >= 0
    se._cache.check_conservation(cached=st["cached_free_blocks"])


def test_spec_adapt_true_tokens_equal_spec_off(dense):
    """speculative=True (the n-gram drafter, the H100 width chooser) and
    an exact oracle under adaptation: tokens equal the spec-off run's;
    the exact oracle is accepted in full, so the chooser verifies wide."""
    _, (pm, pp), (off, _, _) = dense
    tok, _, st = _port_drive(models.ServeEngine(pm, pp, **ENGINE,
                                                speculative=True))
    assert tok == off
    tok, _, st = _port_drive(models.ServeEngine(
        pm, pp, **ENGINE, speculative={"drafter": _oracle(models, off, 0),
                                       "k": 3}))
    assert tok == off
    assert st["spec_accepted"] == st["spec_proposed"] > 0, st
    assert st["acceptance_rate"] == 1.0


def test_spec_guards_equal_jax(dense):
    (jm, jp), (pm, pp), _ = dense
    for kw in ({"temperature": 0.7, "speculative": True},
               {"speculative": "yes"}):
        with pytest.raises(ValueError) as want:
            JaxServeEngine(jm, jp, **ENGINE, **kw)
        with pytest.raises(ValueError) as got:
            models.ServeEngine(pm, pp, **ENGINE, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="propose"):
        models.ServeEngine(pm, pp, **ENGINE,
                           speculative={"drafter": object()})


MOE = dict(hidden_size=64, intermediate_size=96, num_heads=4, num_kv_heads=2,
           head_dim=16, vocab_size=128, num_experts=4, num_experts_per_tok=2,
           moe_intermediate_size=64)
MOE_KW = dict(b_max=2, max_len=32, block=4, prefill_chunk=4)


def test_spec_moe_under_ep_capacity_matches_jax():
    """Two speculating MoE slots against ep_capacity=2: a verify tick
    bills k rows a slot, so a slot is deferred every tick; tokens equal
    spec-off, and the tables, lengths and capacity / spec counters equal
    the JAX engine's."""
    mesh1 = Mesh(np.asarray(jax.devices()[:1]), ("tp",))
    name = "Qwen/Qwen3-30B-A3B"
    jm = JaxQwen3MoE(jax_config.get_config(name).tiny(**MOE), mesh=mesh1,
                     mode="xla", dtype=jnp.float32)
    jp = jm.init_params(jax.random.PRNGKey(0))
    pm = models.Qwen3MoE(models.get_config(name).tiny(**MOE), mode="xla",
                         dtype="float32", device="cpu")
    pp = models.params_from_jax(jax.device_get(jp), device="cpu")
    rng = np.random.default_rng(9)
    reqs = [(rng.integers(0, 128, s).astype(np.int32), g)
            for s, g in ((5, 4), (4, 4))]

    def drive(se, table_of, lens_of):
        for p, g in reqs:
            se.submit(p, g)
        ticks, cls_tick = [], type(se)._tick

        def tick(stream_cb=None):
            cls_tick(se, stream_cb)
            ticks.append((table_of(se._cache).copy(),
                          lens_of(se._cache).copy()))

        se._tick = tick
        out = se.run()
        return {k: list(map(int, v)) for k, v in out.items()}, ticks, \
            se.stats()

    off, _, _ = drive(models.ServeEngine(pm, pp, **MOE_KW),
                      lambda c: c.block_table, lambda c: c.seq_lens)
    prompts = {r: p for r, (p, _) in enumerate(reqs)}

    def spec(pkg):
        return pkg.SpecConfig(drafter=pkg.OracleDrafter(
            off, prompts, wrong_every=2, vocab=128), k=2, adapt=False)

    jtok, jticks, jst = drive(
        JaxServeEngine(jm, jp, ep_capacity=2, attn_method="xla", **MOE_KW,
                       speculative=spec(jspec)),
        lambda c: np.asarray(c.block_table), lambda c: np.asarray(c.seq_lens))
    ttok, tticks, tst = drive(
        models.ServeEngine(pm, pp, ep_capacity=2, **MOE_KW,
                           speculative=spec(models)),
        lambda c: c.block_table, lambda c: c.seq_lens)
    assert ttok == jtok == off
    assert len(tticks) == len(jticks)
    for n, (t, j) in enumerate(zip(tticks, jticks)):
        for a, b, nm in zip(t, j, ("table", "lens")):
            np.testing.assert_array_equal(a, b, err_msg=f"{nm}, tick {n}")
    for k in ("capacity_drops", "ep_rows", "spec_proposed", "spec_accepted",
              "spec_rejected", "rollback_blocks", "tokens"):
        assert tst[k] == jst[k], k
    assert tst["capacity_drops"] > 0, tst
    assert tst["spec_accepted"] > 0 and tst["spec_rejected"] > 0, tst
