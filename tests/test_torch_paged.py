"""The port's paged KV cache, its wire codec and the paged decode
(triton_distributed_tpu_torch ops/wire.py, models/paged_kv_cache.py,
ops/attention.py::flash_decode_paged*) against the JAX package's, on
the CPU.

The JAX paged decode runs its Pallas kernels in interpret mode (jitted,
so the cases of one shape share a compile); the port's wrapper runs its
plain version, which is what a CPU tensor takes. Tolerances: the codec,
the allocator and the pools are compared exactly; the f32 decode at
2e-5, the JAX suite's own tolerance for its kernel against its gather
reference (tests/test_paged_kv.py:328).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_distributed_tpu.models import paged_kv_cache as jpk
from triton_distributed_tpu.ops import attention as jattn
from triton_distributed_tpu.ops import wire as jwire
from triton_distributed_tpu_torch.models import paged_kv_cache as tpk
from triton_distributed_tpu_torch.ops import attention as tattn
from triton_distributed_tpu_torch.ops import wire as twire

WIRE = ["int8", "float8_e4m3fn"]
TORCH_WIRE = {"int8": torch.int8, "float8_e4m3fn": torch.float8_e4m3fn}
L, B, MAX_LEN, HKV, D, BLK, NB = 2, 4, 24, 2, 16, 4, 14


@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.asarray(jax.devices()[:1]), ("tp",))


def _t(a):
    """A JAX array or numpy array as a CPU tensor (fp8 through its
    bytes, which numpy cannot name)."""
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


# -- (a) the wire codec -------------------------------------------------------

@pytest.mark.parametrize("name", WIRE)
def test_quant_blockwise_bytes_and_scales_equal_jax(name):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    x[0, 0, :32] = 0.0                     # an all-zero block
    x[1, 2, 5] = 2.5 * 127 / 127           # a half-way point for int8
    for block in (None, 16, 64):
        jq, js = jwire.quant_blockwise(jnp.asarray(x), name, block)
        tq, ts = twire.quant_blockwise(torch.from_numpy(x), name, block)
        assert tq.dtype == TORCH_WIRE[name]
        _same_bytes(tq, jq)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        back = twire.dequant_blockwise(tq, ts, torch.float32, block)
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jwire.dequant_blockwise(
                jq, js, jnp.float32, block)))
        np.testing.assert_array_equal(
            twire.checksum_blocks(tq, block).numpy(),
            np.asarray(jwire.checksum_blocks(jq, block)))
    jq, js = jpk.quant_kv(jnp.asarray(x), name)
    tq, ts = tpk.quant_kv(torch.from_numpy(x), name)
    _same_bytes(tq, jq)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tpk.dequant_kv(tq, ts).numpy(), np.asarray(jpk.dequant_kv(jq, js)))


def test_int8_rounds_half_to_even_and_codec_guards():
    # 0.5 and 1.5 units of the scale round to 0 and 2 in both packages
    x = np.array([[127.0, 0.5, 1.5, -2.5]], np.float32)
    jq, _ = jwire.quant_blockwise(jnp.asarray(x), "int8")
    tq, _ = twire.quant_blockwise(torch.from_numpy(x), "int8")
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq.tolist() == [[127, 0, 2, -2]]
    assert twire.WIRE_MAX == jwire.WIRE_MAX
    assert twire.QUANT_EPS == jwire.QUANT_EPS
    for w in (12, 256, 512, 100):
        for blk in (None, 4, 64):
            try:
                want = jwire.resolve_block(w, blk)
            except ValueError:
                with pytest.raises(ValueError):
                    twire.resolve_block(w, blk)
            else:
                assert twire.resolve_block(w, blk) == want
    assert twire.resolve_wire_dtype(torch.int8) == "int8"
    assert twire.resolve_wire_dtype(None) is None
    with pytest.raises(ValueError):
        twire.resolve_wire_dtype("bfloat16")


# -- (b) the paged decode against the JAX Pallas kernels ----------------------

def _ragged_case(rng, kv_dtype):
    """One layer's pools, a ragged table with a page shared by slots 0
    and 2, -1 holes past each slot's end and inside slot 1's range, an
    empty slot 3, and (quantized) the scale sidecars."""
    table = np.array([[5, 2, 7, -1, -1, -1],
                      [9, -1, 11, 3, -1, -1],
                      [5, 0, 12, 13, 6, -1],
                      [-1, -1, -1, -1, -1, -1]], np.int32)
    lens = np.array([10, 15, 19, 0], np.int32)
    k = rng.normal(size=(NB, HKV, BLK, D)).astype(np.float32)
    v = rng.normal(size=(NB, HKV, BLK, D)).astype(np.float32)
    if kv_dtype is None:
        return table, lens, (k, v, None, None)
    kq, ks = jpk.quant_kv(jnp.asarray(k), kv_dtype)
    vq, vs = jpk.quant_kv(jnp.asarray(v), kv_dtype)
    return table, lens, (kq, vq, ks, vs)


@pytest.fixture(scope="module")
def jax_paged_decode():
    return jax.jit(jattn.flash_decode_paged_partial)


@pytest.mark.parametrize("kv_dtype", [None] + WIRE)
def test_flash_decode_paged_matches_jax_pallas_kernel(jax_paged_decode,
                                                      kv_dtype):
    rng = np.random.default_rng(1)
    table, lens, (k, v, ks, vs) = _ragged_case(rng, kv_dtype)
    H = 4 * HKV                                   # G = 4, the main path's
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    kw = {} if ks is None else {"k_scales": ks, "v_scales": vs}
    want_o, want_l = jax_paged_decode(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(table),
                                      jnp.asarray(lens), **kw)
    tkw = {} if ks is None else {"k_scales": _t(ks), "v_scales": _t(vs)}
    got_o, got_l = tattn.flash_decode_paged_partial(
        torch.from_numpy(q), _t(k), _t(v), torch.from_numpy(table),
        torch.from_numpy(lens), **tkw)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_l.numpy()[:3], np.asarray(want_l)[:3],
                               rtol=2e-5, atol=2e-5)
    # the empty slot: out 0 and lse ~ -1e30 in both
    assert np.all(got_o.numpy()[3] == 0) and np.all(got_l.numpy()[3] < -1e29)
    assert np.all(np.asarray(want_l)[3] < -1e29)
    # flash_decode_paged is the out half; "xla" on the CPU is the same
    for method in (None, "kernel", "xla"):
        np.testing.assert_array_equal(
            tattn.flash_decode_paged(
                torch.from_numpy(q), _t(k), _t(v), torch.from_numpy(table),
                torch.from_numpy(lens), method=method, **tkw).numpy(),
            got_o.numpy())


def test_flash_decode_paged_refusals():
    q = torch.zeros((2, 4, D))
    pool = torch.zeros((NB, HKV, BLK, D))
    table = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="do not match"):
        tattn.flash_decode_paged_partial(q, pool, pool[:, :, :, :8], table, 3)
    with pytest.raises(ValueError, match="scale sidecars"):
        tattn.flash_decode_paged_partial(q, pool, pool, table, 3,
                                         k_scales=pool[..., 0],
                                         v_scales=pool[..., 0])
    with pytest.raises(ValueError, match="method"):
        tattn.flash_decode_paged(q, pool, pool, table, 3, method="pallas")


# -- (c) the allocator walk ---------------------------------------------------

def _assert_state_equal(tc, jc, where):
    for name in ("block_table", "seq_lens", "in_use", "ref_counts"):
        np.testing.assert_array_equal(getattr(tc, name),
                                      np.asarray(getattr(jc, name)),
                                      err_msg=f"{name} at {where}")
    for name in ("k_scales", "v_scales"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)),
                                      err_msg=f"{name} at {where}")
    _same_bytes(tc.k_pool, jc.k_pool)
    _same_bytes(tc.v_pool, jc.v_pool)


def test_allocator_walk_matches_jax(mesh1):
    """A seeded walk of prefixed grants (shared blocks, copy-on-write),
    writes, cached-retention frees and LRU reclaims on an int8 pool:
    tables, lengths, in_use, refcounts, scale rows and pool bytes equal
    the JAX cache's after every step, and so do the misuse errors. The
    JAX writes run eagerly: under jit XLA divides by the wire maximum
    as a multiply by its reciprocal, one ulp off the eager codec."""
    rng = np.random.default_rng(2)
    jc = jpk.PagedKVCache.create(L, B, MAX_LEN, HKV, D, mesh=mesh1,
                                 block=BLK, num_blocks=NB,
                                 dtype=jnp.float32, kv_dtype="int8")
    tc = tpk.PagedKVCache.create(L, B, MAX_LEN, HKV, D, block=BLK,
                                 num_blocks=NB, dtype=torch.float32,
                                 kv_dtype="int8", device="cpu")
    cached = set()                 # blocks the "radix tree" retains
    counts = dict.fromkeys(("grant", "refused", "cow", "free", "reclaim",
                            "write"), 0)
    for step in range(200):
        busy = [b for b in range(B) if (tc.block_table[b] >= 0).any()]
        idle = [b for b in range(B) if b not in busy]
        op = rng.choice(["grant", "write", "free", "reclaim"],
                        p=[0.35, 0.3, 0.25, 0.1])
        if op == "grant" and idle:
            b = int(rng.choice(idle))
            resident = np.flatnonzero(tc.in_use)
            n_sh = int(rng.integers(0, min(3, resident.size) + 1))
            shared = tuple(int(x) for x in
                           rng.choice(resident, n_sh, replace=False)) \
                if n_sh else ()
            cow = None
            rest = [x for x in resident if x not in shared]
            if rest and rng.random() < 0.3:
                cow = int(rng.choice(rest))
            n_new = int(rng.integers(1 if cow is not None else 0, 4))
            seq = int(rng.integers(0, (len(shared) + 1) * BLK))
            jc, jok, jfresh = jc.assign_slot_prefixed(
                b, shared=shared, n_new=n_new, cow_src=cow, seq_len=seq)
            tok_, tfresh = tc.assign_slot_prefixed(
                b, shared=shared, n_new=n_new, cow_src=cow, seq_len=seq)
            assert (tok_, tfresh) == (bool(jok), tuple(jfresh)), step
            counts["grant" if tok_ else "refused"] += 1
            counts["cow"] += tok_ and cow is not None
            if tok_ and (tc.block_table[b] >= 0).any():
                with pytest.raises(ValueError, match="still holds"):
                    tc.assign_slot_prefixed(b, n_new=1)
        elif op == "write" and busy:
            b = int(rng.choice(busy))
            held = int((tc.block_table[b] >= 0).sum()) * BLK
            off = int(rng.integers(0, held))
            n = min(int(rng.integers(1, 6)), MAX_LEN - off)
            rows = rng.normal(size=(L, 6, HKV, D)).astype(np.float32)
            for layer in range(L):
                jk, jks = jpk.write_rows_shard(jc.k_pool[layer], jnp.asarray(rows[layer]),
                                 jc.block_table, b, off, n,
                                 scales=jc.k_scales[layer])
                jc = dataclasses.replace(
                    jc, k_pool=jc.k_pool.at[layer].set(jk),
                    k_scales=jc.k_scales.at[layer].set(jks))
                tpk.write_rows_shard(tc.k_pool[layer],
                                     torch.from_numpy(rows[layer]),
                                     tc.block_table, b, off, n,
                                     scales=tc.k_scales[layer])
            counts["write"] += 1
        elif op == "free" and busy:
            b = int(rng.choice(busy))
            mine = [int(x) for x in tc.block_table[b] if x >= 0]
            keep = {x for x in mine if rng.random() < 0.5} | cached
            jc = jc.free_slot(b, cached=tuple(sorted(keep)))
            tc.free_slot(b, cached=tuple(sorted(keep)))
            cached = {x for x in keep if tc.in_use[x]}
            counts["free"] += 1
            with pytest.raises(ValueError, match="double-free"):
                tc.free_slot(b)
        elif op == "reclaim":
            idle_cached = [x for x in sorted(cached) if tc.ref_counts[x] == 0]
            if idle_cached:
                ids = idle_cached[:int(rng.integers(1, len(idle_cached) + 1))]
                jc = jc.reclaim_blocks(ids)
                tc.reclaim_blocks(ids)
                cached -= set(ids)
                counts["reclaim"] += 1
                with pytest.raises(ValueError, match="double reclaim"):
                    tc.reclaim_blocks(ids[:1])
        _assert_state_equal(tc, jc, step)
        n_cached = sum(1 for x in cached if tc.ref_counts[x] == 0)
        tc.check_conservation(cached=n_cached)
    assert min(counts.values()) > 0, counts
    assert tc.num_free_blocks == int(jc.num_free_blocks)
    assert tc.held_blocks() == int((np.asarray(jc.block_table) >= 0).sum())
    assert tc.block_nbytes() == jc.block_nbytes()


# -- (d) the shard helpers ----------------------------------------------------

@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_shard_helpers_give_equal_pools(kv_dtype):
    rng = np.random.default_rng(3)
    table = np.array([[3, 0, -1], [1, -1, -1], [4, 2, 5]], np.int32)
    lens = np.array([5, 3, 8], np.int32)
    active = np.array([True, False, True])
    shape = (6, HKV, BLK, D)
    base = rng.normal(size=shape).astype(np.float32)
    if kv_dtype:
        jk, jks = jpk.quant_kv(jnp.asarray(base), kv_dtype)
        jpool = (jk, jks)
    else:
        jpool = (jnp.asarray(base), None)
    tpool = tuple(None if a is None else _t(a) for a in jpool)
    new = rng.normal(size=(3, HKV, D)).astype(np.float32)
    # append: slot 0 at row 5 (page 0, row 1), slot 1 inactive, slot 2
    # at row 8 — its third page is 5
    jout = jpk.append_step_shard(
        jpool[0], jpool[0], jnp.asarray(new), jnp.asarray(new),
        jnp.asarray(table), jnp.asarray(lens), jnp.asarray(active),
        **({} if not kv_dtype else {"k_scales": jpool[1],
                                    "v_scales": jpool[1]}))
    tk, tv = tpool[0].clone(), tpool[0].clone()
    tks = None if not kv_dtype else tpool[1].clone()
    tvs = None if not kv_dtype else tpool[1].clone()
    tout = tpk.append_step_shard(
        tk, tv, torch.from_numpy(new), torch.from_numpy(new), table, lens,
        active, k_scales=tks, v_scales=tvs)
    assert len(tout) == len(jout)
    for g, w in zip(tout, jout):
        _same_bytes(g, w)
    # a chunk of 7 rows at positions [2, 7) of slot 2 (pad past 5)
    rows = rng.normal(size=(7, HKV, D)).astype(np.float32)
    jw = jpk.write_rows_shard(jpool[0], jnp.asarray(rows), jnp.asarray(table),
                              2, 2, 5, scales=jpool[1])
    tw = tpk.write_rows_shard(tpool[0].clone(), torch.from_numpy(rows), table,
                              2, 2, 5, scales=None if not kv_dtype
                              else tpool[1].clone())
    for g, w in zip(tw if kv_dtype else (tw,), jw if kv_dtype else (jw,)):
        _same_bytes(g, w)
    # gather: slot 0's two pages, and slot 1 with a -1 page (clamps to 0)
    for b in (0, 1):
        want = jpk.gather_rows_shard(jpool[0], jnp.asarray(table), b, 2,
                                     scales=jpool[1])
        got = tpk.gather_rows_shard(tpool[0], table, b, 2, scales=tpool[1])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cache_create_and_views_match_jax(mesh1):
    for kvd in (None, "float8_e4m3fn"):
        jc = jpk.PagedKVCache.create(L, B, 10, HKV, D, mesh=mesh1, block=BLK,
                                     dtype=jnp.float32, kv_dtype=kvd)
        tc = tpk.PagedKVCache.create(L, B, 10, HKV, D, block=BLK,
                                     dtype=torch.float32, kv_dtype=kvd,
                                     device="cpu")
        assert tuple(tc.k_pool.shape) == jc.k_pool.shape
        assert (tc.max_blocks, tc.num_blocks, tc.max_len, tc.block) == (
            jc.max_blocks, jc.num_blocks, jc.max_len, jc.block)
        assert tc.kv_dtype == jc.kv_dtype and tc.quantized == jc.quantized
        assert tc.block_nbytes() == jc.block_nbytes()
        # grants take the lowest free ids first, all or nothing
        jc, jok = jc.assign_slot(1, 2)
        assert tc.assign_slot(1, 2) == bool(jok)
        jc, jok = jc.assign_slot(0, 99)
        assert tc.assign_slot(0, 99) == bool(jok) is False
        np.testing.assert_array_equal(tc.block_table,
                                      np.asarray(jc.block_table))
        np.testing.assert_array_equal(tc.device_table.numpy(),
                                      tc.block_table)
        dev = tc.device_table
        tc.advance(1, 5)                 # lengths move, the table stays
        assert tc.device_table is dev and tc.seq_lens.tolist() == [0, 5, 0, 0]
        assert tc.assign_slot(2, 1)
        np.testing.assert_array_equal(tc.device_table.numpy(),
                                      tc.block_table)
        got = tc.gather_shard(tc.k_pool, 1, 1, max_blocks=2,
                              scales=tc.k_scales)
        assert tuple(got.shape) == (2 * BLK, HKV, D)
