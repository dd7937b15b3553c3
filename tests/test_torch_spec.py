"""The port's speculative-decoding parts (triton_distributed_tpu_torch
models/spec.py, perf_model's spec-width chooser, paged_kv_cache's
verify append and rollback, DenseLLM.verify_step_paged) against the JAX
package's, on the CPU.

Drafters, the chooser and the allocator are compared exactly (the
chooser given one step-time function for both, since the port's
estimators model the port's kernels on H100 figures); pools
written by the verify append exactly, int8 / fp8 bytes and scales
included (the JAX writes run eagerly, ROADMAP Queue C 2); the verify
step's greedy predictions exactly and its f32 pools within 1e-5 of the
largest value (the same f32 math in another summation order). The JAX
verify step reads the pool through its XLA gather path, as the port's
plain paged decode does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_distributed_tpu import perf_model as jperf
from triton_distributed_tpu.models import DenseLLM as JaxDenseLLM
from triton_distributed_tpu.models import config as jax_config
from triton_distributed_tpu.models import paged_kv_cache as jpk
from triton_distributed_tpu.models import spec as jspec
from triton_distributed_tpu_torch import models
from triton_distributed_tpu_torch import perf_model as tperf
from triton_distributed_tpu_torch.models import paged_kv_cache as tpk
from triton_distributed_tpu_torch.models import spec as tspec
from triton_distributed_tpu_torch.ops import wire as twire

NAME = "Qwen/Qwen3-8B"
SHRINK = dict(hidden_size=64, num_heads=4, num_kv_heads=2, head_dim=16,
              vocab_size=128, intermediate_size=128)
HKV, D, BLK = 2, 16, 4


@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.asarray(jax.devices()[:1]), ("tp",))


def _t(a):
    """A JAX or numpy array as a CPU tensor (fp8 through its bytes)."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _same_bytes(got, want):
    g = twire.byte_view(got).contiguous().view(torch.uint8).numpy() \
        if got.element_size() == 1 else got.numpy()
    w = np.asarray(want)
    w = w.view(np.uint8) if w.dtype.itemsize == 1 else w
    np.testing.assert_array_equal(g, w)


# -- (a) drafters and SpecConfig ----------------------------------------------

def test_drafters_propose_what_jax_proposes():
    rng = np.random.default_rng(0)
    for _ in range(40):
        base = rng.integers(0, 6, int(rng.integers(1, 12)))
        ctx = np.concatenate([base, base[:int(rng.integers(0, base.size + 1))],
                              rng.integers(0, 6, int(rng.integers(0, 4)))])
        for max_n, window in ((1, 1024), (3, 1024), (2, 5)):
            for k in (0, 1, 3):
                assert tspec.NGramDrafter(max_n, window).propose(0, ctx, k) \
                    == jspec.NGramDrafter(max_n, window).propose(0, ctx, k)
    targets = {3: rng.integers(0, 50, 9), 5: rng.integers(0, 50, 4)}
    prompts = {3: np.zeros(4, np.int32), 5: np.zeros(2, np.int32)}
    for wrong in (0, 2, 3):
        t = tspec.OracleDrafter(targets, prompts, wrong_every=wrong, vocab=50)
        j = jspec.OracleDrafter(targets, prompts, wrong_every=wrong, vocab=50)
        for rid in (3, 5, 9):
            for done in range(0, 10):
                ctx = np.zeros(prompts.get(rid, np.zeros(0)).size + done)
                for k in (0, 1, 3, 8):
                    assert t.propose(rid, ctx, k) == j.propose(rid, ctx, k)
    assert models.SpecConfig is tspec.SpecConfig
    assert isinstance(tspec.SpecConfig().drafter, tspec.NGramDrafter)
    assert tspec.SpecConfig().__dict__.keys() == \
        jspec.SpecConfig().__dict__.keys()


@pytest.mark.parametrize("kw", [
    {"k": 0}, {"k": True}, {"k": 2.0}, {"drafter": object()},
    {"ewma_alpha": 0.0}, {"ewma_alpha": 1.5}])
def test_spec_config_errors_equal_jax(kw):
    with pytest.raises(ValueError) as want:
        jspec.SpecConfig(**kw)
    with pytest.raises(ValueError) as got:
        tspec.SpecConfig(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [{"max_n": 0}, {"window": 1}])
def test_ngram_drafter_errors_equal_jax(kw):
    with pytest.raises(ValueError) as want:
        jspec.NGramDrafter(**kw)
    with pytest.raises(ValueError) as got:
        tspec.NGramDrafter(**kw)
    assert str(got.value) == str(want.value)


# -- (b) the width chooser: what the port's model shares with JAX's ---------
# The step estimators model different kernels (the port's ATTN_P reads exact
# rows, its program is node-level, its paged decode splits no slot), so the
# chooser is held to JAX's given one step-time function for both, and the
# byte accounting under the JAX spec's numbers.

JAX_SPEC = jperf.CHIP_SPECS["v5e"]
PORT_SPEC = tperf.ChipSpec("v5e", JAX_SPEC.bf16_flops, JAX_SPEC.hbm_bw, 8)
CFG = dict(num_layers=28, hidden=1024, intermediate=3072, num_heads=16,
           num_kv_heads=8, head_dim=128)


def _toy_step_s(occupancy, cache_len, *, verify_tokens=1, **_):
    """A step time with JAX's crossovers: a fixed weight stream, a KV
    stream, and attention work that grows with the width."""
    k = verify_tokens
    return (2e-3 + 1e-8 * occupancy * cache_len
            + 2e-11 * occupancy * k * (cache_len + k) * 16 * 128)


@pytest.mark.parametrize("path", ["megakernel", "engine"])
def test_choose_spec_k_equals_jax_over_its_crossover_grid(path, monkeypatch):
    for mod in (jperf, tperf):
        monkeypatch.setattr(mod, "estimate_mk_step_s", _toy_step_s)
        monkeypatch.setattr(mod, "estimate_engine_decode_step_s",
                            _toy_step_s)
    ks = set()
    for a in (0.0, 0.3, 0.6, 0.9):
        for cl in (128, 2048, 16384, 65536):
            for occ in (1, 8):
                for cost in (0.0, 1e-3):
                    want = jperf.choose_spec_k(
                        a, cl, occ, k_max=8, path=path, draft_cost_s=cost,
                        spec=JAX_SPEC, **CFG)
                    got = tperf.choose_spec_k(
                        a, cl, occ, k_max=8, path=path, draft_cost_s=cost,
                        spec=PORT_SPEC, **CFG)
                    assert got == want, (a, cl, occ, cost)
                    ks.add(got)
    assert len(ks) >= 3, ks             # the grid crosses over
    for a in (0.0, 0.5, 0.9, 1.0, 1.5):
        for k in (0, 1, 4, 8):
            assert tperf.expected_spec_tokens(a, k) == \
                jperf.expected_spec_tokens(a, k)


def test_step_estimators_equal_jax():
    """The byte accounting both models share equals JAX's; the port's
    estimators add to it what the port's kernels do."""
    for kvd in (None, "int8", "float8_e4m3fn"):
        assert tperf.decode_kv_token_bytes(8, 128, 36, kv_dtype=kvd) == \
            jperf.decode_kv_token_bytes(8, 128, 36, kv_dtype=kvd)
        for n in (0, 100, 4096):
            assert tperf.estimate_decode_step_s(
                n, 8, 128, 36, param_bytes=12345, kv_dtype=kvd,
                spec=PORT_SPEC) == pytest.approx(jperf.estimate_decode_step_s(
                    n, 8, 128, 36, param_bytes=12345, kv_dtype=kvd,
                    spec=JAX_SPEC), rel=1e-12)
    args = (CFG["num_layers"], CFG["hidden"], CFG["intermediate"],
            CFG["num_heads"], CFG["num_kv_heads"], CFG["head_dim"])
    param = tperf._decode_param_bytes(*args)
    assert param == jperf._decode_param_bytes(*args)
    L, H, Hkv, D = 28, 16, 8, 128
    for occ, cl, k in ((1, 512, 1), (8, 2048, 4), (4, 100, 3), (2, 0, 1)):
        kv = 2 * L * occ * cl * Hkv * D * 2
        stream = (param + kv) / (PORT_SPEC.hbm_bw * 0.9)
        attn = 4.0 * L * occ * k * (cl + k) * H * D / 2.5e11
        got = tperf.estimate_mk_step_s(
            occ, cl, verify_tokens=k, task_overhead_s=1.5e-6,
            mk_hbm_frac=0.9, vpu_elems_per_s=2.5e11, spec=PORT_SPEC, **CFG)
        assert got == pytest.approx(
            max(stream, attn) + (13 * L + 1) * 1.5e-6, rel=1e-12)
        util = min(1.0, occ * Hkv / 8)
        got = tperf.estimate_engine_decode_step_s(
            occ, cl, verify_tokens=k, engine_hbm_frac=0.5,
            engine_dispatch_s=6e-5, num_cores=8, mxu_efficiency=0.5,
            spec=PORT_SPEC, **CFG)
        want = ((param / PORT_SPEC.hbm_bw + kv / PORT_SPEC.hbm_bw / util)
                / 0.5 + 6e-5 + 2.0 * (k - 1) * occ * param / 2
                / (PORT_SPEC.bf16_flops * 0.5))
        assert got == pytest.approx(want, rel=1e-12)


def test_port_defaults_are_the_h100s():
    """No TPU figure is a default: the spec is the H100's, the estimators
    run on their own defaults, zero acceptance falls back to plain
    decode and a full acceptance at a shallow cache verifies wide."""
    spec = tperf.chip_spec("h100")
    assert (spec.bf16_flops, spec.hbm_bw, spec.num_sms) == (989e12, 3.35e12,
                                                            132)
    assert set(tperf.CHIP_SPECS) == {"h100"}
    q8 = dict(num_layers=36, hidden=4096, intermediate=12288, num_heads=32,
              num_kv_heads=8, head_dim=128, spec=spec)
    for path in ("megakernel", "engine"):
        assert tperf.choose_spec_k(0.0, 500, 4, k_max=4, path=path,
                                   **q8) == 1
        assert tperf.choose_spec_k(1.0, 500, 4, k_max=4, path=path,
                                   **q8) == 4
        ks = [tperf.choose_spec_k(a, 500, 4, k_max=4, path=path, **q8)
              for a in (0.0, 0.3, 0.6, 0.9)]
        assert ks == sorted(ks), (path, ks)
    with pytest.raises(NotImplementedError, match="slice 6"):
        tperf.estimate_mk_step_s(1, 1, tp_ranks=2, **q8)


# -- (c) the verify append and the rollback -----------------------------------

@pytest.mark.parametrize("kv_dtype", [None, "int8", "float8_e4m3fn"])
def test_append_rows_shard_equals_jax(kv_dtype):
    rng = np.random.default_rng(3)
    table = np.array([[3, 0, -1], [1, -1, -1], [4, 2, 5], [6, 7, -1]],
                     np.int32)
    lens = np.array([3, 2, 8, 1], np.int32)
    counts = np.array([3, 2, 2, 1], np.int32)
    active = np.array([True, False, True, True])
    K = 3
    base = rng.normal(size=(8, HKV, BLK, D)).astype(np.float32)
    if kv_dtype:
        jq, js = jpk.quant_kv(jnp.asarray(base), kv_dtype)
        jpool = (jq, js)
    else:
        jpool = (jnp.asarray(base), None)
    tpool = tuple(None if a is None else _t(a) for a in jpool)
    new_k = rng.normal(size=(4, K, HKV, D)).astype(np.float32)
    new_v = rng.normal(size=(4, K, HKV, D)).astype(np.float32)
    extra = {} if not kv_dtype else {"k_scales": jpool[1],
                                     "v_scales": jpool[1]}
    # slot 0 crosses from page 3 into page 0; slot 1 is inactive; slot
    # 2 writes row 8 (page 5) and row 9; slot 3 one row
    jout = jpk.append_rows_shard(
        jpool[0], jpool[0], jnp.asarray(new_k), jnp.asarray(new_v),
        jnp.asarray(table), jnp.asarray(lens), jnp.asarray(counts),
        jnp.asarray(active), **extra)
    tout = tpk.append_rows_shard(
        tpool[0].clone(), tpool[0].clone(), torch.from_numpy(new_k),
        torch.from_numpy(new_v), table, lens, counts, active,
        k_scales=None if not kv_dtype else tpool[1].clone(),
        v_scales=None if not kv_dtype else tpool[1].clone())
    assert len(tout) == len(jout)
    for g, w in zip(tout, jout):
        _same_bytes(g, w)
    # counts == 1 is the decode step's append
    one = np.ones(4, np.int32)
    a = tpk.append_rows_shard(tpool[0].clone(), tpool[0].clone(),
                              torch.from_numpy(new_k),
                              torch.from_numpy(new_v), table, lens, one,
                              active, **({} if not kv_dtype else {
                                  "k_scales": tpool[1].clone(),
                                  "v_scales": tpool[1].clone()}))
    b = tpk.append_step_shard(tpool[0].clone(), tpool[0].clone(),
                              torch.from_numpy(new_k[:, 0]),
                              torch.from_numpy(new_v[:, 0]), table, lens,
                              active, **({} if not kv_dtype else {
                                  "k_scales": tpool[1].clone(),
                                  "v_scales": tpool[1].clone()}))
    for g, w in zip(a, b):
        assert torch.equal(twire.byte_view(g), twire.byte_view(w))


def _state_equal(tc, jc, where):
    for name in ("block_table", "seq_lens", "in_use", "ref_counts"):
        np.testing.assert_array_equal(getattr(tc, name),
                                      np.asarray(getattr(jc, name)),
                                      err_msg=f"{name} at {where}")
    np.testing.assert_array_equal(tc.k_scales.numpy(),
                                  np.asarray(jc.k_scales), err_msg=where)


def test_truncate_slot_walk_equals_jax(mesh1):
    """A seeded walk of prefixed grants (shared blocks) and rollbacks to
    random lengths with random grant floors and radix-cached sets, on an
    int8 pool with written scale rows: tables, lengths, in_use,
    refcounts, scale rows and freed ids equal the JAX cache's after every
    step, and every refusal is the JAX ValueError, word for word."""
    rng = np.random.default_rng(7)
    L, B, MAX_LEN, NB = 2, 3, 24, 12
    jc = jpk.PagedKVCache.create(L, B, MAX_LEN, HKV, D, mesh=mesh1, block=BLK,
                                 num_blocks=NB, dtype=jnp.float32,
                                 kv_dtype="int8")
    tc = tpk.PagedKVCache.create(L, B, MAX_LEN, HKV, D, block=BLK,
                                 num_blocks=NB, dtype=torch.float32,
                                 kv_dtype="int8", device="cpu")
    sc = rng.uniform(0.5, 1.0, size=(L, NB, HKV, BLK)).astype(np.float32)
    jc = dataclasses.replace(jc, k_scales=jnp.asarray(sc))
    tc.k_scales.copy_(torch.from_numpy(sc))
    seen = dict.fromkeys(("grant", "truncate", "freed", "error"), 0)
    for step in range(160):
        busy = [b for b in range(B) if (tc.block_table[b] >= 0).any()]
        idle = [b for b in range(B) if b not in busy]
        op = rng.choice(["grant", "truncate", "free"], p=[0.3, 0.55, 0.15])
        if op == "grant" and idle:
            b = int(rng.choice(idle))
            resident = np.flatnonzero(tc.in_use)
            n_sh = int(rng.integers(0, min(2, resident.size) + 1))
            shared = tuple(int(x) for x in rng.choice(resident, n_sh,
                                                      replace=False)) \
                if n_sh else ()
            n_new = int(rng.integers(1, 4))
            seq = int(rng.integers(0, (len(shared) + n_new) * BLK + 1))
            jc, jok, jfresh = jc.assign_slot_prefixed(
                b, shared=shared, n_new=n_new, seq_len=seq)
            tok_, tfresh = tc.assign_slot_prefixed(
                b, shared=shared, n_new=n_new, seq_len=seq)
            assert (tok_, tfresh) == (bool(jok), tuple(jfresh)), step
            seen["grant"] += tok_
        elif op == "truncate":
            b = int(rng.integers(0, B))
            cur = int(tc.seq_lens[b])
            new_len = int(rng.integers(-1, cur + 3))
            min_blocks = int(rng.integers(0, 5))
            held = [int(x) for x in tc.block_table[b] if x >= 0]
            cached = tuple(int(x) for x in held if rng.random() < 0.2)
            try:
                jc2, jfreed = jc.truncate_slot(b, new_len, cached=cached,
                                               min_blocks=min_blocks)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    tc.truncate_slot(b, new_len, cached=cached,
                                     min_blocks=min_blocks)
                assert str(got.value) == str(e), step
                seen["error"] += 1
            else:
                jc = jc2
                freed = tc.truncate_slot(b, new_len, cached=cached,
                                         min_blocks=min_blocks)
                assert freed == tuple(jfreed), step
                seen["truncate"] += 1
                seen["freed"] += len(freed)
        elif op == "free" and busy:
            b = int(rng.choice(busy))
            jc = jc.free_slot(b)
            tc.free_slot(b)
        _state_equal(tc, jc, step)
    assert min(seen.values()) > 0, seen
    with pytest.raises(NotImplementedError, match="slice 6"):
        tc.truncate_slot(0, 0, sp_ranks=2)


# -- (d) the verify step --------------------------------------------------------

@pytest.fixture(scope="module")
def pair(mesh1):
    jm = JaxDenseLLM(jax_config.get_config(NAME).tiny(**SHRINK), mesh=mesh1,
                     mode="xla", dtype=jnp.float32)
    jp = jm.init_params(jax.random.PRNGKey(1))
    pm = models.DenseLLM(models.get_config(NAME).tiny(**SHRINK), mode="xla",
                         dtype="float32", device="cpu")
    return jm, jp, pm, models.params_from_jax(jax.device_get(jp),
                                              device="cpu")


B_, MAXL, NBL = 4, 24, 16
LENS = np.array([3, 5, 9, 6], np.int32)


def _caches(jm, pm, mesh1, kv_dtype, seed=0):
    """Equal JAX and port caches: four slots granted three pages each,
    at LENS, with seeded pool contents."""
    L = pm.config.num_layers
    jc = jpk.PagedKVCache.create(L, B_, MAXL, HKV, D, mesh=mesh1, block=BLK,
                                 num_blocks=NBL, dtype=jnp.float32,
                                 kv_dtype=kv_dtype)
    tc = tpk.PagedKVCache.create(L, B_, MAXL, HKV, D, block=BLK,
                                 num_blocks=NBL, dtype=torch.float32,
                                 kv_dtype=kv_dtype, device="cpu")
    for b in range(B_):
        jc, ok, _ = jc.assign_slot_prefixed(b, n_new=3,
                                            seq_len=int(LENS[b]))
        tc.assign_slot_prefixed(b, n_new=3, seq_len=int(LENS[b]))
    rng = np.random.default_rng(seed)
    pools = [rng.normal(size=tc.k_pool.shape).astype(np.float32) * 0.5
             for _ in range(2)]
    if kv_dtype:
        (kq, ks), (vq, vs) = (jpk.quant_kv(jnp.asarray(p), kv_dtype)
                              for p in pools)
        jc = dataclasses.replace(jc, k_pool=kq, v_pool=vq, k_scales=ks,
                                 v_scales=vs)
        for name in ("k_pool", "v_pool", "k_scales", "v_scales"):
            twire.byte_view(getattr(tc, name)).copy_(twire.byte_view(
                _t(getattr(jc, name))))
    else:
        jc = dataclasses.replace(jc, k_pool=jnp.asarray(pools[0]),
                                 v_pool=jnp.asarray(pools[1]))
        tc.k_pool.copy_(torch.from_numpy(pools[0]))
        tc.v_pool.copy_(torch.from_numpy(pools[1]))
    return jc, tc


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_verify_step_paged_equals_jax(pair, mesh1, kv_dtype):
    """Counts mixing 1..K, an inactive slot, and slot 0's candidates
    crossing from its first page into its second: the same greedy
    predictions, the same lengths, and pools equal to JAX's (f32 within
    1e-5 of the largest value; int8 bytes within one step, scales within
    1e-5 relative)."""
    jm, jp, pm, pp = pair
    jc, tc = _caches(jm, pm, mesh1, kv_dtype)
    rng = np.random.default_rng(4)
    K = 3
    cands = rng.integers(0, 128, (B_, K)).astype(np.int32)
    counts = np.array([3, 2, 1, 2], np.int32)
    active = np.array([True, False, True, True])
    jpred, jc = jm.verify_step_paged(jp, jnp.asarray(cands), jc,
                                     jnp.asarray(active),
                                     jnp.asarray(counts), attn_method="xla")
    tpred, tc = pm.verify_step_paged(pp, cands, tc, active, counts)
    live = (np.arange(K)[None] < counts[:, None]) & active[:, None]
    np.testing.assert_array_equal(tpred.numpy()[live],
                                  np.asarray(jpred)[live])
    np.testing.assert_array_equal(tc.seq_lens, np.asarray(jc.seq_lens))
    assert tc.seq_lens.tolist() == [6, 5, 10, 8]
    for name in ("k_pool", "v_pool"):
        got, want = getattr(tc, name), np.asarray(getattr(jc, name))
        if kv_dtype is None:
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
        else:
            diff = np.abs(got.numpy().astype(np.int32)
                          - want.astype(np.int32))
            assert diff.max() <= 1, name
    if kv_dtype:
        for name in ("k_scales", "v_scales"):
            np.testing.assert_allclose(getattr(tc, name).numpy(),
                                       np.asarray(getattr(jc, name)),
                                       rtol=1e-5)


def test_verify_of_width_one_is_the_decode_step(pair, mesh1):
    jm, _, pm, pp = pair
    _, a = _caches(jm, pm, mesh1, None, seed=2)
    _, b = _caches(jm, pm, mesh1, None, seed=2)
    toks = np.array([5, 9, 17, 33], np.int32)
    active = np.array([True, True, False, True])
    cands = np.stack([toks, toks * 0 + 1, toks * 0 + 2], axis=1)
    pred, a = pm.verify_step_paged(pp, cands, a, active,
                                   np.ones(B_, np.int32))
    nxt, b = pm.decode_step_paged(pp, toks, b, active)
    np.testing.assert_array_equal(pred[:, 0].numpy()[active],
                                  nxt.numpy()[active])
    np.testing.assert_array_equal(a.seq_lens, b.seq_lens)
    assert torch.equal(a.k_pool, b.k_pool) and torch.equal(a.v_pool, b.v_pool)


def test_rolled_back_rows_are_rewritten_before_they_are_read(pair, mesh1):
    """A rollback that frees a tail page (min_blocks 0), the page granted
    to another slot at once, and that slot's verify step over it: the
    rejected rows left in the page are overwritten by the new owner's
    appends before any read, so the predictions and the pools' live rows
    equal those of a cache where the page never held them."""
    jm, _, pm, pp = pair
    _, a = _caches(jm, pm, mesh1, None, seed=5)
    _, b = _caches(jm, pm, mesh1, None, seed=5)
    for c in (a, b):
        c.free_slot(1)
    K = 3
    cands = np.array([[7, 8, 9], [0, 0, 0], [1, 2, 3], [4, 5, 6]], np.int32)
    active = np.array([True, False, False, False])
    # slot 0 (length 3) verifies 3 rows: positions 3..5 cross into its
    # second page; all are rejected and rolled back, the tail freed
    pm.verify_step_paged(pp, cands, a, active, np.array([3, 1, 1, 1]))
    p1, p2 = (int(x) for x in a.block_table[0, 1:3])
    assert a.truncate_slot(0, 3, min_blocks=1) == (p1, p2)
    b.truncate_slot(0, 3, min_blocks=1)
    b.k_pool[:, p1] = 0.0
    b.v_pool[:, p1] = 0.0
    for c in (a, b):
        ok, fresh = c.assign_slot_prefixed(1, n_new=2)
        assert ok and int(c.block_table[1, 0]) == p1
    # the new owner's first verify writes its rows 0..2 into p1, over the
    # rejected rows, and reads only those
    act1 = np.array([False, True, False, False])
    got = [pm.verify_step_paged(pp, cands + 11, c, act1,
                                np.array([1, K, 1, 1]))[0] for c in (a, b)]
    assert torch.equal(got[0][1], got[1][1])
    assert torch.equal(a.k_pool[:, p1, :, :K], b.k_pool[:, p1, :, :K])
    assert torch.equal(a.v_pool[:, p1, :, :K], b.v_pool[:, p1, :, :K])
