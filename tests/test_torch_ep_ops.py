"""The port's expert-parallel ops against the JAX package's, on the CPU: the
dispatch plan (exactly, against the eager JAX function), the ragged
all-to-all's plain version against the JAX Pallas kernel in interpret
mode on a 4-device CPU mesh (the valid rows bit for bit), the rank
group's all_to_all and ring ppermute against `lax` under `shard_map`,
and, port only, dispatch -> combine round trips (identity experts, the
capacity drop, the quantized wires within the JAX tests' bounds) and the
tensor-parallel MoE ops at n ranks against their one-rank forms.

The JAX kernel runs once, in a module fixture, at the 4-rank shape of
tests/test_ep_a2a.py (8 tokens a rank, hidden 16, top-2 of 8 experts,
chunk 4); the collectives' shard_map runs once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from triton_distributed_tpu.ops import ep_a2a as jax_ep
from triton_distributed_tpu.ops import ep_pipeline as jax_pipe
from triton_distributed_tpu.ops import wire as jax_wire
from triton_distributed_tpu_torch.layers.tp_moe import TPMoE
from triton_distributed_tpu_torch.ops import _common
from triton_distributed_tpu_torch.ops import ep_a2a as tep
from triton_distributed_tpu_torch.ops import ep_pipeline as tpipe
from triton_distributed_tpu_torch.ops import moe_parallel as tmp
from triton_distributed_tpu_torch.ops import wire as twire
from triton_distributed_tpu_torch.ops.grouped_gemm import GroupedGemmConfig
from triton_distributed_tpu_torch.parallel import RankGroup

N, M_PER, H, TOP_K, N_EXP, CHUNK = 4, 8, 16, 2, 8, 4


def _case(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N * M_PER, H)).astype(np.float32)
    experts = rng.integers(0, N_EXP, (N * M_PER, TOP_K)).astype(np.int32)
    weights = rng.random((N * M_PER, TOP_K)).astype(np.float32)
    return x, experts, weights


def _stack(a):
    """A row-sharded numpy array as the port's rank-stacked tensor."""
    return torch.from_numpy(np.ascontiguousarray(a)).reshape(
        N, -1, *a.shape[1:])


@pytest.fixture(scope="module")
def jax_a2a():
    """One JAX dispatch transport through _ragged_a2a (interpret mode) on
    a 4-device mesh: every rank's send buffer, counts and received
    slabs."""
    mesh = Mesh(np.asarray(jax.devices()[:N]), ("tp",))
    x, experts, _ = _case()
    cap = jax_ep.default_capacity(M_PER, TOP_K, CHUNK)

    def fwd(xs, es):
        plan = jax_ep.ep_dispatch_plan(es, N_EXP, N, cap)
        counts_mat = jax.lax.all_gather(plan.counts, "tp")
        recv_counts = counts_mat[:, jax.lax.axis_index("tp")]
        x_pad = jnp.concatenate([xs, jnp.zeros((1, H), xs.dtype)])
        send = x_pad[plan.send_gather].reshape(N, cap, H)
        recv = jax_ep._ragged_a2a(
            send, plan.counts, recv_counts, axis="tp", num_ranks=N,
            chunk=CHUNK, collective_id=jax_ep.shmem.collective_id(
                "ep_a2a", 0))
        return send[None], plan.counts[None], recv[None]

    out = shard_map(fwd, mesh=mesh, in_specs=(P("tp", None), P("tp", None)),
                    out_specs=(P("tp"), P("tp"), P("tp")),
                    check_vma=False)(jnp.asarray(x), jnp.asarray(experts))
    return [np.array(a) for a in out]


def _plan_routings():
    rng = np.random.default_rng(0)
    return {"random": (rng.integers(0, N_EXP, (16, 2)), 8),
            "one_rank": (np.full((16, 2), 3), 8),            # all to rank 1
            "drops": (rng.integers(0, 2, (16, 3)), 8),       # 48 to rank 0
            "ample": (rng.integers(0, N_EXP, (12, 2)), 32),
            "top1": (rng.integers(0, N_EXP, (9, 1)), 4)}


@pytest.mark.parametrize("name", list(_plan_routings()))
def test_dispatch_plan_equals_jax_exactly(name):
    """Sentinels, the stable order, drops past capacity and the counts,
    on several seeded routings (every assignment to one rank; more than
    the capacity to one rank)."""
    experts, cap = _plan_routings()[name]
    experts = experts.astype(np.int32)
    want = jax_ep.ep_dispatch_plan(jnp.asarray(experts), N_EXP, N, cap)
    got = tep.ep_dispatch_plan(torch.from_numpy(experts), N_EXP, N, cap)
    for f in ("send_gather", "send_local_expert", "slot_of_assignment",
              "counts"):
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.dtype == torch.int32, f
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f)
    assert (got.capacity, got.top_k) == (want.capacity, want.top_k)
    # rank-stacked choices: each rank's plan is its own
    stacked = tep.ep_dispatch_plan(torch.from_numpy(
        np.stack([experts, experts[::-1].copy()])), N_EXP, N, cap)
    np.testing.assert_array_equal(stacked.counts[0].numpy(),
                                  np.asarray(want.counts))
    again = tep.ep_dispatch_plan(torch.from_numpy(experts[::-1].copy()),
                                 N_EXP, N, cap)
    np.testing.assert_array_equal(stacked.slot_of_assignment[1].numpy(),
                                  again.slot_of_assignment.numpy())


def _valid_rows_equal(got, want, counts):
    """got / want (n, n, C, ...) received slabs; counts (n_src, n_dst):
    rows [0, counts[s, d]) of slab (d, s) bit for bit."""
    for d in range(N):
        for s in range(N):
            c = int(counts[s, d])
            np.testing.assert_array_equal(got[d, s, :c], want[d, s, :c],
                                          err_msg=f"pair {s} -> {d}")


def test_ragged_a2a_plain_equals_the_jax_kernel(jax_a2a):
    """The plain version on the JAX kernel's send buffers: every valid row
    bit for bit; rows past the counts are zeros in the plain version."""
    send, counts, recv = jax_a2a
    got = tep._ragged_a2a(torch.from_numpy(send), torch.from_numpy(counts),
                          num_ranks=N, chunk=CHUNK)
    assert got.shape == recv.shape
    _valid_rows_equal(got.numpy(), recv, counts)
    live = np.arange(send.shape[2])[None, None] < counts.T[..., None]
    assert (got.numpy()[~live] == 0).all()
    assert counts.sum() == N * M_PER * TOP_K      # nothing dropped here


@pytest.mark.parametrize("method", ["ragged", "xla"])
def test_dispatch_shard_equals_the_jax_transport(jax_a2a, method):
    """The port's dispatch (plan, counts exchange, packing, transport) on
    the same tokens: the JAX kernel's valid rows bit for bit, the receive
    counts, and the expert ids (sentinel past each count)."""
    _, counts, recv = jax_a2a
    x, experts, _ = _case()
    got, ids, cnts, plan = tep.ep_dispatch_shard(
        _stack(x), _stack(experts), num_ranks=N, num_experts=N_EXP,
        method=method, chunk=CHUNK)
    np.testing.assert_array_equal(cnts.numpy(), counts.T)
    np.testing.assert_array_equal(plan.counts.numpy(), counts)
    _valid_rows_equal(got.numpy(), recv, counts)
    assert ids.dtype == torch.int32
    live = np.arange(ids.shape[2])[None, None] < counts.T[..., None]
    assert (ids.numpy()[~live] == N_EXP // N).all()
    assert (ids.numpy()[live] < N_EXP // N).all()


def test_rank_group_collectives_equal_lax():
    """RankGroup.all_to_all and the ring ppermute against lax.all_to_all
    (split_axis 0, concat_axis 0, tiled=False) and lax.ppermute under
    shard_map."""
    mesh = Mesh(np.asarray(jax.devices()[:N]), ("tp",))
    x = np.random.default_rng(5).normal(size=(N, N, 3, 2)).astype(np.float32)

    def fwd(xs):
        a2a = jax.lax.all_to_all(xs[0], "tp", 0, 0, tiled=False)
        ring = jax.lax.ppermute(xs[0], "tp",
                                [(i, (i + 1) % N) for i in range(N)])
        return a2a[None], ring[None]

    a2a, ring = shard_map(fwd, mesh=mesh, in_specs=P("tp"),
                          out_specs=(P("tp"), P("tp")),
                          check_vma=False)(jnp.asarray(x))
    group = RankGroup(N)
    np.testing.assert_array_equal(
        group.all_to_all(torch.from_numpy(x)).numpy(), np.asarray(a2a))
    np.testing.assert_array_equal(
        group.ppermute_ring(torch.from_numpy(x)).numpy(), np.asarray(ring))
    with pytest.raises(ValueError):
        group.all_to_all(torch.zeros(N, N - 1, 2))


def _roundtrip(method, *, capacity=None, wire_dtype=None, case=None):
    x, experts, weights = case or _case()
    xs, es, ws = _stack(x), _stack(experts), _stack(weights)
    recv, ids, cnts, plan = tep.ep_dispatch_shard(
        xs, es, num_ranks=N, num_experts=N_EXP, capacity=capacity,
        method=method, chunk=capacity or CHUNK, wire_dtype=wire_dtype)
    y = torch.where((ids < N_EXP // N)[..., None], recv, 0.0)
    out = tep.ep_combine_shard(y, plan, ws, cnts, num_ranks=N, method=method,
                               chunk=capacity or CHUNK,
                               wire_dtype=wire_dtype)
    return out.reshape(-1, H).numpy(), x, weights


@pytest.mark.parametrize("method", ["ragged", "xla"])
def test_dispatch_combine_roundtrip_identity_experts(method):
    """combine(dispatch(x)) == x * sum_k w_k (JAX test :51, rtol 1e-5), and
    the host-level ep_dispatch / ep_combine give the same."""
    out, x, weights = _roundtrip(method)
    expect = x * weights.sum(1, keepdims=True)
    np.testing.assert_allclose(out, expect, rtol=1e-5)
    _, experts, _ = _case()
    recv, ids, cnts, plan = tep.ep_dispatch(
        torch.from_numpy(x), torch.from_numpy(experts), num_ranks=N,
        num_experts=N_EXP, method=method, chunk=CHUNK)
    y = torch.where((ids < N_EXP // N)[..., None], recv, 0.0)
    host = tep.ep_combine(y, plan, torch.from_numpy(weights), cnts,
                          num_ranks=N, method=method, chunk=CHUNK)
    np.testing.assert_array_equal(host.numpy(), out)


@pytest.mark.parametrize("method", ["ragged", "xla"])
def test_capacity_drop_keeps_the_earliest_assignments(method):
    """Every token to expert 0 with capacity 8 of 16 a source: the first 8
    tokens of each source come back, the rest add zero (JAX :131)."""
    ones = (np.ones((N * 16, H), np.float32),
            np.zeros((N * 16, 1), np.int32), np.ones((N * 16, 1), np.float32))
    out, _, _ = _roundtrip(method, capacity=8, case=ones)
    out = out.reshape(N, 16, H)
    np.testing.assert_array_equal(out[:, :8], 1.0)
    np.testing.assert_array_equal(out[:, 8:], 0.0)


@pytest.mark.parametrize("wire", ["float8_e4m3fn", "int8"])
@pytest.mark.parametrize("method", ["ragged", "xla"])
def test_wire_dtype_roundtrip(monkeypatch, method, wire):
    """Quantized wires within the JAX test's bounds (:153: fp8 0.12, int8
    0.03); the ragged transport moves one row of H + 128 bytes (payload,
    then the f32 scale's field), the xla transport H bytes."""
    seen = []
    orig = tep._transport

    def probe(buf, *a, **k):
        seen.append((buf.dtype, buf.shape[-1]))
        return orig(buf, *a, **k)

    monkeypatch.setattr(tep, "_transport", probe)
    out, x, weights = _roundtrip(method, wire_dtype=wire)
    width = H + tep._SCALE_BLOCK if method == "ragged" else H
    assert seen == [(torch.uint8, width)] * 2, seen
    tol = 0.12 if wire == "float8_e4m3fn" else 0.03
    np.testing.assert_allclose(out, x * weights.sum(1, keepdims=True),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("wire", ["float8_e4m3fn", "int8"])
def test_wire_codec_equals_jax_eagerly(wire):
    """Per-row quantized bytes and scales equal the eager JAX codec's, and
    the packed row keeps both."""
    x = np.random.default_rng(7).normal(size=(3, 5, 40)).astype(np.float32)
    q, s = twire.wire_quant(torch.from_numpy(x), wire)
    jq, js = jax_wire.wire_quant(jnp.asarray(x), jnp.dtype(wire))
    np.testing.assert_array_equal(q.view(torch.uint8).numpy(),
                                  np.asarray(jq).view(np.uint8))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        twire.wire_dequant(q, s, torch.float32).numpy(),
        np.asarray(jax_wire.wire_dequant(jq, js, jnp.float32)))
    packed = tep._pack_scale(q, s)
    assert packed.shape == (3, 5, 40 + 128) and packed.dtype == torch.uint8
    q2, s2 = tep._unpack_scale(packed, 40, wire)
    assert torch.equal(q2.view(torch.uint8), q.view(torch.uint8))
    assert torch.equal(s2, s)


def test_pipeline_chunks_and_what_is_not_ported():
    for m, s in ((6, 2), (6, 4), (5, 1), (1, 2), (8, 8)):
        _common.reset_dispatch()
        jax_pipe_s = jax_pipe.resolve_num_chunks(m, s)
        assert tpipe.resolve_num_chunks(m, s) == jax_pipe_s
    with pytest.raises(NotImplementedError, match="slice 7"):
        tpipe.resolve_pipeline_chunks(None, None, None)
    with pytest.raises(ValueError, match="issue"):
        tpipe.ep_moe_pipeline_shard(
            torch.zeros(N, 2, H), torch.zeros(N, 2, 1, dtype=torch.int32),
            torch.zeros(N, 2, 1), None, num_ranks=N, num_experts=N_EXP,
            issue="overlapped")


@pytest.mark.parametrize("issue", ["pipelined", "sequential"])
def test_pipeline_chunks_equal_the_flat_chain(issue):
    """S = 2 chunks with identity experts give the flat chain's outputs;
    each chunk's dispatch and combine take their own collective id."""
    x, experts, weights = _case(3)
    xs, es, ws = _stack(x), _stack(experts), _stack(weights)
    ids_seen = []
    orig = tep._transport

    def spy(buf, *a, **k):
        ids_seen.append(k["collective_id"])
        return orig(buf, *a, **k)

    def identity(recv, ids):
        return torch.where((ids < N_EXP // N)[..., None], recv, 0.0)

    flat = tpipe.ep_moe_pipeline_shard(xs, es, ws, identity, num_ranks=N,
                                       num_experts=N_EXP, chunk=CHUNK)
    try:
        tep._transport = spy
        two = tpipe.ep_moe_pipeline_shard(xs, es, ws, identity, num_ranks=N,
                                          num_experts=N_EXP, num_chunks=2,
                                          chunk=CHUNK, issue=issue)
    finally:
        tep._transport = orig
    np.testing.assert_allclose(two.numpy(), flat.numpy(), rtol=1e-6)
    base = tpipe.EP_PIPELINE_COLLECTIVE_ID
    want = ([base, base + 2, base + 1, base + 3] if issue == "pipelined"
            else [base, base + 1, base + 2, base + 3])
    assert ids_seen == want


# ---------------------------------------------------------------------------
# The tensor-parallel MoE ops at n ranks against their one-rank forms
# ---------------------------------------------------------------------------

E, K, I_FULL = 8, 32, 48


def _tp_weights(seed=0):
    g = torch.Generator().manual_seed(seed)
    layer = TPMoE(K, I_FULL, E, TOP_K, num_ranks=1)
    gate, up = (torch.randn(E, K, I_FULL, generator=g) * K ** -0.5
                for _ in range(2))
    down = torch.randn(E, I_FULL, K, generator=g) * I_FULL ** -0.5
    return layer, gate, up, down


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("method", ["xla", "ring"])
def test_tp_moe_ops_at_n_ranks_equal_one_rank(n, method):
    """ag_group_gemm_shard -> SwiGLU -> moe_reduce_rs_shard at n ranks on
    the rank slices of the weights, and moe_reduce_ar_shard, against the
    one-rank forms on the unsharded weights, f32 within 1e-5."""
    from triton_distributed_tpu_torch.layers.tp_mlp import silu
    from triton_distributed_tpu_torch.ops import moe_utils
    _, gate, up, down = _tp_weights()
    m = 6
    g = torch.Generator().manual_seed(1)
    x = torch.randn(n * m, K, generator=g)
    w, experts = moe_utils.route_topk(torch.randn(n * m, E, generator=g),
                                      TOP_K)
    cfg = tmp.MoEParallelConfig(gemm=GroupedGemmConfig(block_m=8),
                                method=method)

    def run(nr):
        layer = TPMoE(K, I_FULL, E, TOP_K, num_ranks=nr)
        p = layer.shard_params(None, gate, up, down)
        i_sh = I_FULL // nr
        xs = x if nr == 1 else x.reshape(nr, m, K)
        es = experts if nr == 1 else experts.reshape(nr, m, TOP_K)
        ys, disp = tmp.ag_group_gemm_shard(xs, es, p["w_gate_up"],
                                           num_ranks=nr, num_experts=E,
                                           config=cfg)
        act = silu(ys[..., :i_sh]) * ys[..., i_sh:]
        wf = w.reshape(nr, -1, TOP_K)
        rs = tmp.moe_reduce_rs_shard(act, wf, p["w_down"], disp,
                                     num_ranks=nr, config=cfg)
        ar = tmp.moe_reduce_ar_shard(act, wf, p["w_down"], disp,
                                     num_ranks=nr, config=cfg)
        return rs.reshape(-1, K), ar

    rs1, ar1 = run(1)
    rsn, arn = run(n)
    np.testing.assert_allclose(rsn.numpy(), rs1.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(arn.numpy(), ar1.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(rs1.numpy(), ar1.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mode", ["xla", "fused", "ar", "gemm_ar"])
def test_tp_moe_layer_at_n_ranks_equals_its_golden(n, mode):
    """TPMoE at n ranks (rank-stacked weights from shard_params) in every
    mode against its dense golden on the unsharded n-fused weights."""
    _, gate, up, down = _tp_weights(2)
    layer = TPMoE(K, I_FULL, E, TOP_K, num_ranks=n, mode=mode,
                  config=tmp.MoEParallelConfig(block_m=8))
    router = torch.randn(K, E, generator=torch.Generator().manual_seed(3))
    p = layer.shard_params(router, gate, up, down)
    assert p["w_gate_up"].shape == (n, E, K, 2 * I_FULL // n)
    assert p["w_down"].shape == (n, E, I_FULL // n, K)
    x = torch.randn(n * 5, K, generator=torch.Generator().manual_seed(4))
    golden = {"router": router, "w_down": down,
              "w_gate_up": torch.cat(list(p["w_gate_up"]), dim=-1)}
    np.testing.assert_allclose(layer(p, x).numpy(),
                               layer.reference_forward(golden, x).numpy(),
                               rtol=1e-5, atol=1e-5)
