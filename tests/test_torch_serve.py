"""The port's continuous-batching server (triton_distributed_tpu_torch
models/serve.py, serve_state.py and DenseLLM's paged steps) against the
JAX package's `ServeEngine`, on the CPU.

Both engines serve one submit stream on the shrunken tiny Qwen3 config
in f32 with the same weights: two slots, 4-token pages and prefill
chunks, a shared prefix, a block-aligned duplicate prompt (a full-prompt
hit and its copy-on-write), a pool small enough to force LRU reclaim,
and an interactive request submitted from the stream callback, which
preempts a batch resident. The JAX runs are module-scoped fixtures, one
per pool dtype. Greedy tokens must be identical in f32 and within
`TOKEN_BAND` for int8 and fp8 pools; the control plane — block tables,
lengths and free counts after every tick, and the stats counters — must
be identical for every dtype.
"""

import ast
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_distributed_tpu.models import DenseLLM as JaxDenseLLM
from triton_distributed_tpu.models import ServeEngine as JaxServeEngine
from triton_distributed_tpu.models import config as jax_config
from triton_distributed_tpu.models import serve as jserve
from triton_distributed_tpu.models import serve_state as jserve_state
from triton_distributed_tpu_torch import models
from triton_distributed_tpu_torch.models import serve as tserve
from triton_distributed_tpu_torch.models import serve_state as tserve_state

SHRINK = dict(hidden_size=64, num_heads=4, num_kv_heads=2, head_dim=16,
              vocab_size=128, intermediate_size=128)
ENGINE = dict(b_max=2, max_len=32, block=4, prefill_chunk=4, num_blocks=10)
COUNTERS = ("ticks", "admitted", "finished", "evictions", "requeued",
            "prefill_chunks", "tokens", "prefix_hit_blocks",
            "prefix_miss_blocks", "cow_copies", "reclaimed_blocks",
            "preemptions", "grant_refusals", "free_blocks",
            "cached_free_blocks", "total_blocks", "queue_depth",
            "occupancy", "quant_kv_bytes_saved")


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
    """Submit the stream, run with the mid-stream interactive submit,
    and record (block table, lengths, free count) after every tick."""
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
        if rid == 1 and i == 1 and not sent:
            sent.append(se.submit(late[0], late[1], slo_class="interactive",
                                  tenant="chat"))

    out = se.run(stream_cb=cb)
    del se._tick
    return {k: list(map(int, v)) for k, v in out.items()}, ticks, se.stats()


@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.asarray(jax.devices()[:1]), ("tp",))


@pytest.fixture(scope="module")
def jax_model(mesh1):
    cfg = jax_config.get_config("Qwen/Qwen3-8B").tiny(**SHRINK)
    m = JaxDenseLLM(cfg, mesh=mesh1, mode="xla", dtype=jnp.float32)
    return m, m.init_params(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def port_model(jax_model):
    m = models.DenseLLM(models.get_config("Qwen/Qwen3-8B").tiny(**SHRINK),
                        mode="xla", dtype="float32", device="cpu")
    return m, models.params_from_jax(jax.device_get(jax_model[1]),
                                     device="cpu")


def test_serve_engine_matches_per_request_engine(port_model):
    """Greedy f32 ServeEngine streams equal the port's own Engine.serve
    run one request at a time (chunked prefill, paging and preemption
    change no token)."""
    toks, _, stats = _drive(models.ServeEngine(*port_model, **ENGINE),
                            lambda c: c.block_table, lambda c: c.seq_lens,
                            lambda c: c.num_free_blocks)
    assert stats["preemptions"] > 0
    reqs, late = _stream()
    eng = models.Engine(*port_model, max_len=32)
    for rid, (ids, gen) in enumerate(reqs + [late]):
        want = eng.serve(ids[None], gen)[0]
        assert toks[rid] == want.tolist(), rid


def test_serve_is_rerunnable_and_serve_api(port_model):
    se = models.ServeEngine(*port_model, **ENGINE)
    reqs, _ = _stream()
    outs = se.serve([r for r, _ in reqs], [g for _, g in reqs])
    assert [len(o) for o in outs] == [g for _, g in reqs]
    again = se.serve([r for r, _ in reqs], [g for _, g in reqs])
    for a, b in zip(outs, again):
        np.testing.assert_array_equal(a, b)
    st = se.stats()
    assert st["decode_steps"] > 0 and st["prefix_chunks"] > 0
    assert st["prefill_chunks"] >= st["prefix_chunks"]


def test_sampled_stream_reproducible_and_in_top_k(port_model):
    model, params = port_model
    reqs, _ = _stream()
    top_k = 5
    seen = []
    real = model._next_token

    def spy(x, p, generator, **kw):
        tok = real(x, p, generator, **kw)
        top = torch.topk(x.float() @ p["lm_head"].float(), top_k).indices
        seen.append(all(int(t) in row.tolist() for t, row in zip(tok, top)))
        return tok

    def run(seed, k=top_k):
        se = models.ServeEngine(model, params, temperature=0.8, top_k=k,
                                seed=seed, **ENGINE)
        return se.serve([r for r, _ in reqs], [g for _, g in reqs])

    model._next_token = spy
    try:
        a = run(3)
    finally:
        del model._next_token
    assert seen and all(seen)
    for x, y in zip(a, run(3)):
        np.testing.assert_array_equal(x, y)
    greedy = models.ServeEngine(model, params, **ENGINE).serve(
        [r for r, _ in reqs], [g for _, g in reqs])
    for x, y in zip(run(4, k=1), greedy):           # top_k = 1 is greedy
        np.testing.assert_array_equal(x, y)


_OUT_OF_SCOPE = [
    ({"slo_ticks": 8}, NotImplementedError, "slice 2c"),
    ({"chaos": object()}, NotImplementedError, "slice 2c"),
    ({"max_faults": 5}, NotImplementedError, "slice 2c"),
    ({"backoff_ticks": 1}, NotImplementedError, "slice 2c"),
    ({"backoff_cap": 32}, NotImplementedError, "slice 2c"),
    ({"host_blocks": 4}, NotImplementedError, "slice 2c"),
    # multi-rank, megakernel multi-rank (slice 6d) and sequence-parallel
    # serving are ported: over this one-rank tensor-parallel model they are
    # the JAX engine's ValueErrors
    ({"mode": "megakernel", "tp_ranks": 2}, ValueError, "mesh rank"),
    ({"attn_parallelism": "sp"}, ValueError, "rebuild the model"),
    ({"sp_combine": "ll"}, ValueError, "compiled into"),
    ({"tp_ranks": 2}, ValueError, "mesh rank"),
]


@pytest.mark.parametrize(
    "kw,exc,match", _OUT_OF_SCOPE,
    ids=[f"kw{i}-{'slice 2c' if i < 6 else 'slice 6'}"
         for i in range(len(_OUT_OF_SCOPE))])
def test_out_of_scope_arguments_raise(port_model, kw, exc, match):
    with pytest.raises(exc, match=match):
        models.ServeEngine(*port_model, **kw)


def test_argument_and_submit_guards(port_model):
    for kw in ({"mode": "turbo"}, {"attn_parallelism": "dp"},
               {"attn_method": "pallas"}, {"tp_ranks": 0},
               {"tenant_weights": {"a": 0}}, {"kv_dtype": "int4"},
               {"ep_capacity": 8}):     # a dense model routes no experts
        with pytest.raises(ValueError):
            models.ServeEngine(*port_model, **kw)
    se = models.ServeEngine(*port_model, **ENGINE)
    for args, kw in ((([],), {}), (([1.5],), {}), (([1], 0), {}),
                     (([1], True), {}), ((list(range(30)), 4), {}),
                     (([1], 2), {"slo_class": "gold"}),
                     (([1], 2), {"tenant": ""}),
                     (([1], 2), {"priority": 1.0})):
        if len(args) == 1:
            args = args + (2,)
        with pytest.raises(ValueError):
            se.submit(*args, **kw)
    assert se.submit([1, 2], 2, rid=5) == 5
    with pytest.raises(ValueError, match="non-monotone"):
        se.submit([1, 2], 2, rid=5)


def test_chunked_prefill_matches_single_chunk(port_model):
    """Splitting a prompt across chunks (prefix partial + in-chunk
    partial, merged by lse) gives the same first token and the same
    cached rows as one whole-prompt chunk (tests/test_serve.py:101)."""
    model, params = port_model
    rng = np.random.default_rng(7)
    S = 10
    ids = rng.integers(0, 128, S).astype(np.int32)

    def run(chunk, kv):
        cache = model.new_paged_kv_cache(1, 16, block=4, kv_dtype=kv)
        assert cache.assign_slot(0, 4)
        off = 0
        while off < S:
            valid = min(S - off, chunk)
            c = np.zeros((chunk,), np.int32)
            c[:valid] = ids[off:off + valid]
            tok, cache = model.prefill_chunk_paged(params, c, cache, 0, off,
                                                   valid)
            off += valid
        return int(tok), cache

    for kv in (None, "int8"):
        tok1, c1 = run(16, kv)
        tok4, c4 = run(4, kv)
        assert tok1 == tok4 and c1.seq_lens[0] == c4.seq_lens[0] == S
        for layer in range(model.config.num_layers):
            for pool, sc in (("k_pool", "k_scales"), ("v_pool", "v_scales")):
                kw = {"scales": getattr(c1, sc)} if kv else {}
                a = c1.gather_shard(getattr(c1, pool), layer, 0, **kw)[:S]
                kw = {"scales": getattr(c4, sc)} if kv else {}
                b = c4.gather_shard(getattr(c4, pool), layer, 0, **kw)[:S]
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                           atol=2e-5 if kv is None else 0.05)


def test_decode_step_paged_inactive_slots_carry_through(port_model):
    model, params = port_model
    cache = model.new_paged_kv_cache(2, 16, block=4)
    assert cache.assign_slot(0, 3)
    ids = np.arange(6, dtype=np.int32)
    tok, cache = model.prefill_chunk_paged(params, ids, cache, 0, 0, 6)
    toks = torch.tensor([int(tok), 77], dtype=torch.int32)
    k_before = cache.k_pool.clone()
    for method in ("kernel", "xla"):
        nxt, cache = model.decode_step_paged(params, toks, cache,
                                             [True, False],
                                             attn_method=method)
        assert int(nxt[1]) == 77
    assert cache.seq_lens.tolist() == [8, 0]
    # slot 1 holds no page, so only slot 0's rows 6 and 7 changed
    changed = (cache.k_pool != k_before).any(dim=(0, 2, 4))
    assert changed.nonzero().tolist() == [[int(cache.block_table[0, 1]), 2],
                                          [int(cache.block_table[0, 1]), 3]]


def test_serve_state_is_the_jax_control_plane():
    """serve_state.py is the JAX module carried over: the same syntax
    tree once docstrings are dropped, bar its perf_model import."""
    def tree(mod):
        t = ast.parse(inspect.getsource(mod))
        for node in ast.walk(t):
            body = getattr(node, "body", None)
            if isinstance(body, list) and body \
                    and isinstance(body[0], ast.Expr) \
                    and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                node.body = body[1:] or [ast.Pass()]
        return ast.dump(t)

    assert tree(tserve_state) == tree(jserve_state)
    for name in ("AdmitPlan", "BlockAlloc", "PrefixCache", "SchedCfg"):
        assert getattr(models, name, getattr(tserve_state, name)) is \
            getattr(tserve_state, name)


def test_serve_helpers_match_jax():
    assert tserve.TOKEN_BAND == jserve.TOKEN_BAND
    for off in (0, 1, 4, 5, 17, 100, 500):
        for blk, cap in ((4, 32), (128, 2048), (16, 512)):
            assert tserve.prefix_bucket(off, blk, cap) == \
                jserve.prefix_bucket(off, blk, cap)
    ref = {0: np.arange(8), 1: np.arange(4)}
    got = {0: np.r_[np.arange(6), 0, 0], 1: np.arange(4)}
    assert tserve.banded_token_identity(ref, got, "int8") == \
        jserve.banded_token_identity(ref, got, "int8")
    for mod in (tserve, jserve):
        with pytest.raises(ValueError, match="band floor"):
            mod.banded_token_identity(ref, got)
        with pytest.raises(ValueError, match="differ"):
            mod.banded_token_identity(ref, {0: ref[0]})


# The JAX engine runs last, so that the model fixtures above are set up
# (and timed) by the cheaper tests.
@pytest.fixture(scope="module", params=[None, "int8", "float8_e4m3fn"])
def both_runs(request, jax_model, port_model):
    kv = request.param
    jrun = _drive(JaxServeEngine(*jax_model, kv_dtype=kv, **ENGINE),
                  lambda c: np.asarray(c.block_table),
                  lambda c: np.asarray(c.seq_lens),
                  lambda c: int(c.num_free_blocks))
    tse = models.ServeEngine(*port_model, kv_dtype=kv, **ENGINE)
    trun = _drive(tse, lambda c: c.block_table, lambda c: c.seq_lens,
                  lambda c: c.num_free_blocks)
    return kv, jrun, trun, tse


def test_serve_engine_matches_jax(both_runs):
    kv, (jtok, jticks, jstats), (ttok, tticks, tstats), tse = both_runs
    assert len(tticks) == len(jticks)
    for n, (t, j) in enumerate(zip(tticks, jticks)):
        for a, b, name in zip(t, j, ("table", "lens", "free")):
            np.testing.assert_array_equal(a, b, err_msg=f"{name}, tick {n}")
    assert {k: tstats[k] for k in COUNTERS} == \
        {k: jstats[k] for k in COUNTERS}
    assert tstats["kv_dtype"] == jstats["kv_dtype"] == kv
    # the stream exercised what it was built for
    assert jstats["prefix_hit_blocks"] > 0 and jstats["cow_copies"] > 0
    assert jstats["preemptions"] > 0 and jstats["reclaimed_blocks"] > 0
    assert sorted(ttok) == list(range(6))
    if kv is None:
        assert ttok == jtok
    else:
        tserve.banded_token_identity(jtok, ttok, kv_dtype=kv)
    # after the run every block is free or radix-cached, and conserved
    cache = tse._cache
    cache.check_conservation(cached=tstats["cached_free_blocks"])
    assert tstats["free_blocks"] + tstats["cached_free_blocks"] == \
        tstats["total_blocks"]
