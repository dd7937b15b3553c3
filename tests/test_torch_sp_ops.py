"""The port's sequence-parallel ops and the multi-rank layouts of its paged
pool against the JAX package, on a 4-device CPU mesh (f32, inputs from
numpy seeds):

- `ll_combine_shard` (plain version here) against JAX `ll_combine_shard`
  inside `shard_map` (its one-shot Pallas kernel in interpret mode), at
  odd rows, at B * H = 4 * 8 and with a rank or a row at lse -1e30;
  `ll_merge` against JAX `ll_merge`;
- `ring_attention_shard` and both combines of `sp_flash_decode_shard` /
  `sp_flash_decode_paged_shard` against their JAX twins;
- the sequence-sharded pool's functions (`sp_local_table`,
  `sp_append_step_shard`, `sp_write_rows_shard`, `sp_gather_rows_shard`,
  `sp_rank_tokens`, `sp_owner`, `check_conservation_sp`, `create` and
  `assign_slot` at `sp_ranks`) and the head-sharded pool's appends
  (`num_ranks`, bf16 / int8 rows) against JAX: pages, tables, lengths,
  owners and free lists exactly equal.

The port's tensors are rank-stacked (parallel/mesh.py); `unshard` puts
them back in the JAX arrays' global layout. The JAX attention kernels (no
DMA, no semaphore) run in the plain Pallas interpreter, its one-shot
combine kernel in the TPU interpreter it needs (see
`plain_attention_interpreter`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from triton_distributed_tpu import runtime as jruntime
from triton_distributed_tpu.models import paged_kv_cache as jpkv
from triton_distributed_tpu.ops import attention as jattn
from triton_distributed_tpu.ops import ll_gather as jll
from triton_distributed_tpu.ops import sp_attention as jsp
from triton_distributed_tpu_torch.models import paged_kv_cache as tpkv
from triton_distributed_tpu_torch.ops import ll_gather as tll
from triton_distributed_tpu_torch.ops import sp_attention as tsp
from triton_distributed_tpu_torch.parallel import unshard

N = 4


class PlainInterpreter:
    """The JAX package's runtime module, but with the plain Pallas
    interpreter (interpret=True) for the kernels of ops/attention.py. They
    hold no DMA or semaphore, so it runs them as the TPU interpreter does,
    at a fraction of its cost on a CPU; the communication kernels keep the
    TPU interpreter."""

    def __getattr__(self, name):
        return getattr(jruntime, name)

    @staticmethod
    def interpret_params(**kwargs):
        return True


@pytest.fixture(scope="module", autouse=True)
def plain_attention_interpreter():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jattn, "runtime", PlainInterpreter())
        yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.asarray(jax.devices()[:N]), ("tp",))


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# ll_combine / ll_merge
# ---------------------------------------------------------------------------

def _partials(seed, b, h, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, b, h, d)).astype(np.float32),
            rng.normal(size=(N, b, h)).astype(np.float32))


def _jax_ll_combine(mesh, outs, lses):
    def fn(o, l):
        return jll.ll_combine_shard(o[0], l[0], axis="tp", num_ranks=N)

    return np.asarray(jax.jit(shard_map(
        fn, mesh=mesh, in_specs=(P("tp"), P("tp")), out_specs=P(),
        check_vma=False))(jnp.asarray(outs), jnp.asarray(lses)))


@pytest.mark.parametrize("case", ["odd_rows", "rows_4x8", "rank_empty",
                                  "row_empty_everywhere"])
def test_ll_combine_plain_equals_jax(mesh, case):
    """B * H = 3 (JAX pads it to 8 rows), 4 * 8, one rank's lse at -1e30
    (a rank past the frontier) and one row at -1e30 on every rank (a
    slot no rank holds a token of: its partials are 0, the merge 0)."""
    b, h, d = (1, 3, 16) if case == "odd_rows" else (4, 8, 16)
    outs, lses = _partials(5, b, h, d)
    if case == "rank_empty":
        outs[2], lses[2] = 0.0, -1e30
    if case == "row_empty_everywhere":
        outs[:, 1, 3], lses[:, 1, 3] = 0.0, -1e30
    want = _jax_ll_combine(mesh, outs, lses)
    got = tll.ll_combine_shard(_t(outs), _t(lses), num_ranks=N).numpy()
    assert got.shape == (b, h, d) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
    if case == "row_empty_everywhere":
        assert (got[1, 3] == 0).all()
    # the combine_partials golden of JAX's own test, at its tolerance
    np.testing.assert_allclose(
        got, np.asarray(jattn.combine_partials(jnp.asarray(outs),
                                               jnp.asarray(lses))),
        rtol=2e-4, atol=2e-4)


def test_ll_combine_one_rank_is_the_partial():
    outs, lses = _partials(1, 2, 3, 8)
    o = _t(outs[:1])
    assert tll.ll_combine_shard(o, _t(lses[:1]), num_ranks=1) \
        .data_ptr() == o.data_ptr()
    with pytest.raises(ValueError, match="not \\(n, B, H, D\\)"):
        tll.ll_combine_shard(o, _t(lses[:1]), num_ranks=2)


@pytest.mark.parametrize("shape", [(4, 2, 3, 16), (2, 101, 8, 8)])
def test_ll_merge_plain_equals_jax(shape):
    """JAX ll_merge (its packed-merge kernel, 128-lane lse tile, 8-row
    pad) and the port's (its own packed rows) on the same partials;
    808 rows is JAX's prime-ish padding case."""
    rng = np.random.default_rng(11)
    outs = rng.standard_normal(shape).astype(np.float32)
    lses = rng.standard_normal(shape[:3]).astype(np.float32)
    want = np.asarray(jax.jit(jll.ll_merge)(jnp.asarray(outs),
                                            jnp.asarray(lses)))
    got = tll.ll_merge(_t(outs), _t(lses)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_pack_partials_is_the_port_wire_layout():
    """[out (D) | lse | zeros to a multiple of 4 lanes], no pad rows; the
    merge of packed rows equals the combine of the partials bit for
    bit."""
    outs, lses = _partials(3, 2, 3, 16)
    o, l = _t(outs), _t(lses)
    p = tll.pack_partials(o[1], l[1])
    assert tll.packed_width(16) == 20 and tll.packed_width(128) == 132
    assert p.shape == (6, 20) and p.dtype == torch.float32
    assert torch.equal(p[:, :16], o[1].reshape(6, 16))
    assert torch.equal(p[:, 16], l[1].reshape(6))
    assert (p[:, 17:] == 0).all()
    packed = torch.stack([tll.pack_partials(o[s], l[s]) for s in range(N)])
    assert torch.equal(tll.ll_merge_packed(packed, 16).view(2, 3, 16),
                       tll.ll_combine_shard(o, l, num_ranks=N))
    with pytest.raises(ValueError, match="packed layout"):
        tll.ll_merge_packed(packed[..., :19], 16)


# ---------------------------------------------------------------------------
# ring attention and the distributed decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_shard_equals_jax(mesh, causal):
    rng = np.random.default_rng(1)
    b, s, h, hkv, d = 1, 32, 4, 2, 16
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    spec = P(None, "tp", None, None)

    def fn(qs, ks, vs):
        o, l = jsp.ring_attention_shard(qs, ks, vs, axis="tp", num_ranks=N,
                                        causal=causal, block_q=8, block_k=8,
                                        return_lse=True)
        return o, l

    jo, jl = jax.jit(shard_map(fn, mesh=mesh, in_specs=(spec,) * 3,
                               out_specs=(spec, P(None, "tp", None)),
                               check_vma=False))(*map(jnp.asarray, (q, k, v)))

    def ranks(a):     # (b, s, ...) -> (n, b, s / n, ...)
        return _t(a).view(b, N, s // N, *a.shape[2:]).transpose(0, 1) \
            .contiguous()

    to, tl = tsp.ring_attention_shard(ranks(q), ranks(k), ranks(v),
                                      num_ranks=N, causal=causal,
                                      return_lse=True)
    np.testing.assert_allclose(unshard(to, 1).numpy(), np.asarray(jo),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(unshard(tl, 1).numpy(), np.asarray(jl),
                               rtol=1e-5, atol=1e-5)
    out = tsp.ring_attention_shard(ranks(q), ranks(k), ranks(v),
                                   num_ranks=N, causal=causal)
    torch.testing.assert_close(out, to.to(out.dtype), rtol=0, atol=0)


@pytest.mark.parametrize("combine", ["xla", "ll"])
def test_sp_flash_decode_shard_equals_jax(mesh, combine):
    """The contiguous twin: JAX's host-level sp_flash_decode, kv_len 41
    (rank 2 partial, rank 3 empty)."""
    rng = np.random.default_rng(2)
    b, skv, h, hkv, d = 2, 64, 4, 2, 16
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    want = np.asarray(jax.jit(lambda *a: jsp.sp_flash_decode(
        *a, 41, mesh=mesh, axis="tp", block_k=8, combine=combine))(
        *map(jnp.asarray, (q, k, v))))
    loc = skv // N
    local = np.clip(41 - np.arange(N) * loc, 0, loc)[:, None].repeat(b, 1)
    ks, vs = (_t(a).view(b, N, loc, hkv, d).transpose(0, 1).contiguous()
              for a in (k, v))
    got = tsp.sp_flash_decode_shard(_t(q), ks, vs, _t(local.astype(np.int32)),
                                    num_ranks=N, combine=combine)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _sp_pool(seed, nb=16, hkv=2, blk=4, d=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(nb, hkv, blk, d)).astype(np.float32),
            rng.normal(size=(nb, hkv, blk, d)).astype(np.float32))


@pytest.mark.parametrize("combine", ["xla", "ll"])
def test_sp_flash_decode_paged_shard_equals_jax(mesh, combine):
    """Two slots over a 16-block pool split 4 ways (bpr 2, 8 tokens a
    rank): slot 0 at 19 tokens (ranks 0-1 full, rank 2 partial, rank 3
    empty), slot 1 at 5 (rank 0 only). JAX takes partition-local tables
    into its partition; the port global ids into the pool."""
    rng = np.random.default_rng(4)
    B, H, D, blk, mb = 2, 4, 16, 4, 8
    kp, vp = _sp_pool(4)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    table = np.full((B, mb), -1, np.int32)
    table[0, :5] = [1, 3, 6, 4, 9]          # column j in rank j // 2's part
    table[1, :2] = [0, 2]
    kv_len = np.asarray([19, 5], np.int32)
    rt, nb_loc, bpr = 8, 4, 2

    def fn(qr, kps, vps, tbl, kvl):
        me = jax.lax.axis_index("tp")
        ltbl = jpkv.sp_local_table(tbl, me, bpr=bpr, nb_loc=nb_loc)
        local = jnp.clip(kvl - me * rt, 0, rt)
        return jsp.sp_flash_decode_paged_shard(
            qr, kps, vps, ltbl, local, axis="tp", num_ranks=N,
            method="xla", combine=combine)

    want = np.asarray(jax.jit(shard_map(
        fn, mesh=mesh,
        in_specs=(P(), P("tp"), P("tp"), P(), P()), out_specs=P(),
        check_vma=False))(*map(jnp.asarray, (q, kp, vp, table, kv_len))))
    local = np.clip(kv_len[None] - np.arange(N)[:, None] * rt, 0, rt)
    tables = table.reshape(B, N, bpr).transpose(1, 0, 2)
    got = tsp.sp_flash_decode_paged_shard(
        _t(q), _t(kp), _t(vp), _t(np.ascontiguousarray(tables)),
        _t(local.astype(np.int32)), num_ranks=N, combine=combine)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="combine"):
        tsp.sp_flash_decode_paged_shard(
            _t(q), _t(kp), _t(vp), _t(np.ascontiguousarray(tables)),
            _t(local.astype(np.int32)), num_ranks=N, combine="ring")


# ---------------------------------------------------------------------------
# the pool's multi-rank layouts
# ---------------------------------------------------------------------------

def _jax_cache(mesh, sp_ranks, num_blocks, kv_dtype=None, n=N):
    m = Mesh(np.asarray(jax.devices()[:n]), ("tp",))
    return jpkv.PagedKVCache.create(2, 3, 32, 4, 8, mesh=m, block=4,
                                    num_blocks=num_blocks,
                                    sp_ranks=sp_ranks, dtype=jnp.float32,
                                    kv_dtype=kv_dtype)


def _port_cache(sp_ranks, num_blocks, kv_dtype=None, num_ranks=1):
    return tpkv.PagedKVCache.create(2, 3, 32, 4, 8, block=4,
                                    num_blocks=num_blocks, sp_ranks=sp_ranks,
                                    dtype=torch.float32, kv_dtype=kv_dtype,
                                    device="cpu", num_ranks=num_ranks)


def _same_allocator(jc, tc):
    np.testing.assert_array_equal(tc.block_table, np.asarray(jc.block_table))
    np.testing.assert_array_equal(tc.seq_lens, np.asarray(jc.seq_lens))
    np.testing.assert_array_equal(tc.in_use, np.asarray(jc.in_use))
    np.testing.assert_array_equal(tc.ref_counts, np.asarray(jc.ref_counts))
    assert tc.num_free_blocks == int(jc.num_free_blocks)


def test_sp_create_and_per_rank_grants_equal_jax(mesh):
    """assign_slot(sp_ranks=4) over 16 blocks (4 a rank, 2 table columns a
    rank): grants, the all-or-nothing refusal when one rank's partition is
    short though the pool has blocks free, free_slot, and the placement
    check; the geometry refusals in JAX's words."""
    jc, tc = _jax_cache(mesh, N, 16), _port_cache(N, 16)
    granted = []
    # slot 2 is refused (rank 0's 4 blocks are taken, 11 of 16 free); after
    # slot 1 leaves it fits, and slot 1 is then refused at 9 free
    for op, slot, blocks in (("grant", 0, 5), ("grant", 1, 2),
                             ("grant", 2, 3), ("free", 1, 0),
                             ("grant", 2, 3), ("grant", 1, 1)):
        if op == "free":
            jc = jc.free_slot(slot)
            tc.free_slot(slot)
        else:
            jc, ok = jc.assign_slot(slot, blocks, sp_ranks=N)
            assert tc.assign_slot(slot, blocks, sp_ranks=N) == bool(ok)
            granted.append(bool(ok))
        _same_allocator(jc, tc)
    assert granted == [True, True, False, True, False]
    jc.check_conservation_sp(N)
    tc.check_conservation_sp(N)
    assert tc.sp_rank_tokens(N) == jc.sp_rank_tokens(N) == 8
    for off, length in ((0, 4), (8, 8), (20, 3), (31, 1)):
        assert tc.sp_owner(off, length, sp_ranks=N) == \
            int(jc.sp_owner(off, length, sp_ranks=N))
    for off, length, match in ((6, 4, "crosses"), (30, 4, "outside"),
                               (-1, 1, "outside")):
        for c in (jc, tc):
            with pytest.raises(ValueError, match=match):
                c.sp_owner(off, length, sp_ranks=N)
    # a block placed in another rank's columns: the placement check names it
    tc.block_table[0, 0], tc.block_table[0, 2] = \
        tc.block_table[0, 2], tc.block_table[0, 0]
    with pytest.raises(ValueError, match="sp placement violated"):
        tc.check_conservation_sp(N)
    for kw, match in ((dict(num_blocks=14), "does not split"),
                      (dict(kv_dtype="int8"), "does not compose")):
        for make in (lambda: _jax_cache(mesh, N, **{"num_blocks": 16, **kw}),
                     lambda: _port_cache(N, **{"num_blocks": 16, **kw})):
            with pytest.raises(ValueError, match=match):
                make()


def test_sp_shard_helpers_equal_jax(mesh):
    """sp_local_table, sp_append_step_shard, sp_write_rows_shard and
    sp_gather_rows_shard on each rank's partition: pages bit for bit (the
    rows are given, not computed), a write past its rank's range not
    made."""
    rng = np.random.default_rng(7)
    nb, hkv, blk, d, mb = 16, 2, 4, 8, 8
    nb_loc, bpr, rt = 4, 2, 8
    table = np.full((3, mb), -1, np.int32)
    table[0, :5] = [0, 2, 5, 6, 9]
    table[1, :3] = [1, 3, 4]
    table[2, :8] = [12, 13, 14, 15, 7, 8, 10, 11]   # rank 2 / 3 misplaced
    lens = np.asarray([17, 9, 3], np.int32)
    active = np.asarray([True, True, False])
    k_new = rng.normal(size=(3, hkv, d)).astype(np.float32)
    rows = rng.normal(size=(4, hkv, d)).astype(np.float32)
    kp0 = rng.normal(size=(nb, hkv, blk, d)).astype(np.float32)
    tpool = _t(kp0)
    tv = tpool.clone()
    for r in range(N):
        np.testing.assert_array_equal(
            tpkv.sp_local_table(table, r, bpr=bpr, nb_loc=nb_loc),
            np.asarray(jpkv.sp_local_table(jnp.asarray(table), r, bpr=bpr,
                                           nb_loc=nb_loc)))
        part = slice(r * nb_loc, (r + 1) * nb_loc)
        jk, _ = jpkv.sp_append_step_shard(
            jnp.asarray(kp0[part]), jnp.asarray(kp0[part]),
            jnp.asarray(k_new), jnp.asarray(k_new), jnp.asarray(table),
            jnp.asarray(lens), r, rank_tokens=rt,
            active=jnp.asarray(active))
        tpkv.sp_append_step_shard(tpool[part], tv[part], _t(k_new),
                                  _t(k_new), table, lens, r, rank_tokens=rt,
                                  active=active)
        np.testing.assert_array_equal(tpool[part].numpy(), np.asarray(jk))
        jw = jpkv.sp_write_rows_shard(
            jnp.asarray(kp0[part]), jnp.asarray(rows), jnp.asarray(table), 0,
            6, 3, r, rank_tokens=rt)
        tw = _t(kp0[part])
        tpkv.sp_write_rows_shard(tw, _t(rows), table, 0, 6, 3, r,
                                 rank_tokens=rt)
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        for count in (None, 1):
            np.testing.assert_array_equal(
                tpkv.sp_gather_rows_shard(tpool[part], table, 0, r, bpr=bpr,
                                          count=count).numpy(),
                np.asarray(jpkv.sp_gather_rows_shard(
                    jnp.asarray(tpool[part].numpy()), jnp.asarray(table), 0,
                    r, bpr=bpr, count=count)))
    # the misplaced slot 2 wrote nowhere; slot 0 at 17 wrote rank 2's page 9
    assert torch.equal(tpool[8], _t(kp0[8])) \
        and not torch.equal(tpool[9], _t(kp0[9]))


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_head_sharded_pool_equals_jax(kv_dtype):
    """The head-sharded pool at n = 2: (L, n, nb, Hkv / n, block, D)
    unshards to the JAX pool after the same appends (JAX append_step_shard
    inside shard_map over part_spec / scale_part_spec; the port one
    scatter over the ranks' view), scales included; a copy-on-write grant
    copies every rank's page."""
    n = 2
    m2 = Mesh(np.asarray(jax.devices()[:n]), ("tp",))
    rng = np.random.default_rng(9)
    jc, tc = _jax_cache(m2, 1, 8, kv_dtype, n=n), _port_cache(
        1, 8, kv_dtype, num_ranks=n)
    assert tc.k_pool.shape == (2, n, 8, 4 // n, 4, 8)
    for slot, blocks in ((0, 3), (2, 2)):
        jc, _ = jc.assign_slot(slot, blocks)
        tc.assign_slot(slot, blocks)
    lens = np.asarray([5, 0, 7], np.int32)
    jc.seq_lens = jnp.asarray(lens)
    tc.seq_lens[:] = lens
    active = np.asarray([True, False, True])
    k_new = rng.normal(size=(3, 4, 8)).astype(np.float32)
    v_new = rng.normal(size=(3, 4, 8)).astype(np.float32)
    quant = kv_dtype is not None
    pool_p = jpkv.PagedKVCache.part_spec("tp")
    scale_p = jpkv.PagedKVCache.scale_part_spec("tp")
    head = P(None, "tp", None)

    def fn(kp, vp, kn, vn, tbl, sl, act, *sc):
        kw = dict(k_scales=sc[0][1], v_scales=sc[1][1]) if sc else {}
        return jpkv.append_step_shard(kp[1], vp[1], kn, vn, tbl, sl, act,
                                      **kw)

    extra = (jc.k_scales, jc.v_scales) if quant else ()
    lay = P(None, "tp", None, None)
    out = jax.jit(shard_map(
        fn, mesh=m2,
        in_specs=(pool_p, pool_p, head, head, P(), P(), P())
        + ((scale_p,) * 2 if quant else ()),
        out_specs=(lay, lay) + ((P(None, "tp", None),) * 2 if quant
                                else ()),
        check_vma=False))(jc.k_pool, jc.v_pool, jnp.asarray(k_new),
                         jnp.asarray(v_new), jc.block_table,
                         jnp.asarray(lens), jnp.asarray(active), *extra)
    kp, vp, ks, vs = tc.layer_pools(1)
    at = tc.append_at(active).over_ranks(n, tc.num_blocks, 3)
    for pool, new, sc in ((kp, k_new, ks), (vp, v_new, vs)):
        per_rank = _t(new).view(3, n, 2, 8).transpose(0, 1).reshape(-1, 2, 8)
        tpkv.scatter_rows(pool, per_rank, at, scales=sc)
    for i, name in enumerate(("k_pool", "v_pool")):
        got = unshard(getattr(tc, name)[1], 1, at=0)
        if quant:
            got = got.view(torch.uint8)
        want = np.asarray(out[i])
        np.testing.assert_array_equal(
            got.numpy(), want.view(np.uint8) if quant else want)
    if quant:
        for i, name in ((2, "k_scales"), (3, "v_scales")):
            np.testing.assert_array_equal(
                unshard(getattr(tc, name)[1], 1, at=0).numpy(),
                np.asarray(out[i]))
    # copy-on-write: the clone carries every rank's page (and scale rows)
    src = int(tc.block_table[0, 1])
    ok, fresh = tc.assign_slot_prefixed(1, shared=(int(tc.block_table[0, 0]),),
                                        n_new=1, cow_src=src, seq_len=4)
    assert ok
    assert torch.equal(tc.k_pool[:, :, fresh[0]], tc.k_pool[:, :, src])
    tc.free_slot(1)
    tc.check_conservation()
    assert tc.block_nbytes() == jc.block_nbytes()
