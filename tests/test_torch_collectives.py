"""The port's collective library (ops/collectives, AllGatherLayer) against
the JAX package's, on an n-device CPU mesh, inputs from numpy seeds.

Each JAX host-level function (`all_gather`, `reduce_scatter`, `all_reduce`,
`all_to_all`, `AllGatherLayer.__call__`) runs with its Pallas kernels in the
TPU interpreter, as tests/test_collectives.py runs them, at that file's
sizes (a rank's 16 x 128 rows). The calls of one mesh and dtype run inside
one `jax.jit`, once, in a cached helper; the port's host-level functions
run their plain versions on the same inputs (CPU tensors).

Tolerances: all_gather and the dense all_to_all bit for bit (copies);
reduce_scatter and all_reduce in f32 rtol = atol = 1e-5, the JAX tests'
own; in bf16 3e-2, as tests/test_torch_tp_ops.py holds gemm_rs and gemm_ar:
JAX adds the partials in the working dtype, the port in f32 (rounding
once, or once a ring hop). The quantized XLA paths are held to JAX's within
`wire.sum_error_bound` of the partials, and both to the exact sum within it.

The dispatch log equals JAX's for reduce_scatter and all_reduce, on the
executed programs and on traced-only ones (`jax.make_jaxpr` records the
JAX dispatch without running a kernel); the port also logs all_gather,
which JAX does not.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from triton_distributed_tpu import perf_model as jperf
from triton_distributed_tpu.ops import _common as jcommon
from triton_distributed_tpu.ops import collectives as jc
from triton_distributed_tpu.ops import ll_gather as jll
from triton_distributed_tpu_torch import perf_model as tperf
from triton_distributed_tpu_torch.ops import _common as tcommon
from triton_distributed_tpu_torch.ops import collectives as tc
from triton_distributed_tpu_torch.ops import wire as twire
from triton_distributed_tpu_torch.ops.ll_gather import AllGatherLayer

# the op modules (each package's __init__ binds the names to the functions)
jag = importlib.import_module("triton_distributed_tpu.ops.collectives."
                              "all_gather")
tag, tar, trs = (importlib.import_module(
    f"triton_distributed_tpu_torch.ops.collectives.{m}")
    for m in ("all_gather", "all_reduce", "reduce_scatter"))

ROWS, COLS = 16, 128
GROUPS = [(2, "float32"), (4, "float32"), (4, "bfloat16")]
ARMS = [("all_gather", "FULLMESH_PUSH"), ("all_gather", "RING"),
        ("reduce_scatter", "RING"), ("reduce_scatter", "FULLMESH"),
        ("all_reduce", "ONE_SHOT"), ("all_reduce", "TWO_SHOT")]
JAX_OPS = {"all_gather": (jc.all_gather, jc.AllGatherMethod),
           "reduce_scatter": (jc.reduce_scatter, jc.ReduceScatterMethod),
           "all_reduce": (jc.all_reduce, jc.AllReduceMethod),
           "all_to_all": (jc.all_to_all, jc.AllToAllMethod)}
PORT_OPS = {"all_gather": (tc.all_gather, tc.AllGatherMethod),
            "reduce_scatter": (tc.reduce_scatter, tc.ReduceScatterMethod),
            "all_reduce": (tc.all_reduce, tc.AllReduceMethod),
            "all_to_all": (tc.all_to_all, tc.AllToAllMethod)}
# the extras program at n = 4, f32: AUTO and XLA of each op, the dense
# all_to_all, the XLA paths with an int8 wire, one AllGatherLayer call
EXTRAS = ([(op, m, None) for op in ("all_gather", "reduce_scatter",
                                    "all_reduce") for m in ("AUTO", "XLA")]
          + [("all_to_all", m, None) for m in ("FULLMESH", "AUTO", "XLA")]
          + [("reduce_scatter", "XLA", "int8"), ("all_reduce", "XLA", "int8"),
             ("layer", "AUTO", None)])


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("tp",))


def _inputs(n, seed=0):
    """f32 numpy inputs of each op's host-level function."""
    rng = np.random.default_rng(seed + n)
    shapes = {"all_gather": (n * ROWS, COLS),
              "reduce_scatter": (n, n * ROWS, COLS),
              "all_reduce": (n, ROWS, COLS), "all_to_all": (n * n * 4, COLS)}
    return {op: rng.standard_normal(s).astype(np.float32)
            for op, s in shapes.items()}


def _torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch,
                                                                  dtype))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t).astype(np.float32)


def _run_jax(n, dtype, calls):
    """calls: [(op, method name, wire)] of the JAX host-level functions, in
    one jit on an n-device mesh. Returns ({call: f32 numpy}, dispatch
    log)."""
    mesh = _mesh(n)
    xs = {k: jnp.asarray(v, dtype) for k, v in _inputs(n).items()}
    layer = jll.AllGatherLayer(mesh=mesh)

    def prog(xs):
        outs = []
        for op, m, wd in calls:
            if op == "layer":
                outs.append(layer(xs["all_gather"]))
                continue
            fn, methods = JAX_OPS[op]
            kw = {"wire_dtype": wd} if wd else {}
            outs.append(fn(xs[op], mesh=mesh, method=methods[m], **kw))
        return outs

    jcommon.reset_dispatch()
    outs = jax.jit(prog)(xs)
    return ({c: np.asarray(o).astype(np.float32) for c, o in zip(calls, outs)},
            jcommon.dispatch_counts())


@functools.lru_cache(maxsize=None)
def jax_arms(n, dtype):
    return _run_jax(n, dtype, [(op, m, None) for op, m in ARMS])


@functools.lru_cache(maxsize=None)
def jax_extras():
    return _run_jax(4, "float32", EXTRAS)


def _run_port(n, dtype, calls):
    xs = {k: _torch(v, dtype) for k, v in _inputs(n).items()}
    layer = AllGatherLayer(num_ranks=n)
    tcommon.reset_dispatch()
    outs = {}
    for op, m, wd in calls:
        if op == "layer":
            outs[(op, m, wd)] = _np(layer(xs["all_gather"]))
            continue
        fn, methods = PORT_OPS[op]
        kw = {"wire_dtype": wd} if wd else {}
        outs[(op, m, wd)] = _np(fn(xs[op], num_ranks=n, method=methods[m],
                                   **kw))
    return outs, tcommon.dispatch_counts()


def _close(op, dtype, got, want):
    if op in ("all_gather", "all_to_all", "layer"):
        np.testing.assert_array_equal(got, want)
        return
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _rs_ar_log(log):
    return {k: v for k, v in log.items()
            if k[0] in ("reduce_scatter", "all_reduce")}


@pytest.mark.parametrize("n,dtype", GROUPS)
@pytest.mark.parametrize("op,method", ARMS)
def test_kernel_arm_equals_jax(op, method, n, dtype):
    want, _ = jax_arms(n, dtype)
    got, log = _run_port(n, dtype, [(op, method, None)])
    assert log == {(op, "kernel", ""): 1}
    assert got[(op, method, None)].shape == want[(op, method, None)].shape
    _close(op, dtype, got[(op, method, None)], want[(op, method, None)])


@pytest.mark.parametrize("n,dtype", GROUPS)
def test_arms_dispatch_log_equals_jax(n, dtype):
    _, jax_log = jax_arms(n, dtype)
    _, log = _run_port(n, dtype, [(op, m, None) for op, m in ARMS])
    assert _rs_ar_log(log) == jax_log
    assert log[("all_gather", "kernel", "")] == 2     # JAX logs no gather


@pytest.mark.parametrize("call", EXTRAS, ids=lambda c: "-".join(map(str, c)))
def test_auto_xla_a2a_and_layer_equal_jax(call):
    want, _ = jax_extras()
    got, _ = _run_port(4, "float32", [call])
    op, _, wd = call
    if wd is None:
        _close(op, "float32", got[call], want[call])
        return
    # the quantized XLA paths: within the codec's bound of JAX's and of
    # the exact sum (the port's codec is JAX's eager codec bit for bit; a
    # jitted JAX scale may sit an ulp off it)
    x = _inputs(4)[op].astype(np.float32)
    exact = x.sum(0)
    if op == "reduce_scatter":
        parts = x.reshape(4, 4, ROWS, COLS).transpose(1, 0, 2, 3)
        bound = np.concatenate([twire.sum_error_bound(p, wd) for p in parts])
    else:
        bound = twire.sum_error_bound(x, wd)
    assert (np.abs(got[call] - want[call]) <= 2 * bound + 1e-6).all()
    assert (np.abs(got[call] - exact) <= bound + 1e-5).all()


def test_extras_dispatch_log_equals_jax():
    _, jax_log = jax_extras()
    _, log = _run_port(4, "float32", EXTRAS)
    assert _rs_ar_log(log) == jax_log
    assert log[("all_gather", "kernel", "")] == 2     # AUTO and the layer
    assert log[("all_gather", "xla", "")] == 1


# ---------------------------------------------------------------------------
# Dispatch, traced only on the JAX side
# ---------------------------------------------------------------------------

TRACED = [  # (op, method, n, rows, cols, wire)
    ("reduce_scatter", "AUTO", 4, 16, 128, None),
    ("reduce_scatter", "XLA", 4, 16, 128, "int8"),
    ("reduce_scatter", "AUTO", 4, 16, 300, "int8"),    # no block divides
    ("reduce_scatter", "RING", 1, 16, 128, None),
    ("all_reduce", "AUTO", 4, 16, 128, None),
    ("all_reduce", "TWO_SHOT", 4, 6, 128, None),       # rows % n: XLA
    ("all_reduce", "XLA", 4, 16, 128, "float8_e4m3fn"),
    ("all_reduce", "ONE_SHOT", 4, 16, 300, "int8"),    # no block divides
    ("all_reduce", "ONE_SHOT", 1, 16, 128, None),
]


def _jax_traced_log(op, method, n, rows, cols, wd):
    fn, methods = JAX_OPS[op]
    shape = (n, n * rows, cols) if op == "reduce_scatter" else (n, rows, cols)
    jcommon.reset_dispatch()
    jax.make_jaxpr(functools.partial(
        fn, mesh=_mesh(n), method=methods[method], wire_dtype=wd))(
            jnp.zeros(shape, jnp.float32))
    return jcommon.dispatch_counts()


@pytest.mark.parametrize("case", TRACED, ids=lambda c: "-".join(map(str, c)))
def test_dispatch_log_equals_jax_traced(case):
    op, method, n, rows, cols, wd = case
    want = _jax_traced_log(*case)
    fn, methods = PORT_OPS[op]
    shape = (n, n * rows, cols) if op == "reduce_scatter" else (n, rows, cols)
    tcommon.reset_dispatch()
    fn(torch.zeros(shape), num_ranks=n, method=methods[method], wire_dtype=wd)
    assert tcommon.dispatch_counts() == want


# ---------------------------------------------------------------------------
# Routes the port refuses or guards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op,method", [
    ("reduce_scatter", "RING"), ("reduce_scatter", "FULLMESH"),
    ("reduce_scatter", "AUTO"), ("all_reduce", "ONE_SHOT"),
    ("all_reduce", "TWO_SHOT"), ("all_reduce", "AUTO")])
def test_kernel_route_with_a_wire_logs_as_jax(op, method):
    """A kernel route with a wire (AUTO included) runs its quant arm (the
    plain version on the CPU; tests/test_torch_quant_collectives.py holds
    the values to JAX's) and logs as JAX traces it."""
    want = _jax_traced_log(op, method, 4, 64, 256, "int8")
    fn, methods = PORT_OPS[op]
    shape = (4, 4 * 64, 256) if op == "reduce_scatter" else (4, 64, 256)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        shape).astype(np.float32))
    tcommon.reset_dispatch()
    out = fn(x, num_ranks=4, method=methods[method], wire_dtype="int8")
    assert _rs_ar_log(tcommon.dispatch_counts()) == want
    assert (op, "kernel", "wire") in want
    exact = x.sum(0).reshape(out.shape)
    assert (out - exact).abs().max() <= 0.1


RETURN_FAULT = [  # (method, rows, wait_budget given, wire)
    ("XLA", 16, False, None),         # tests/test_chaos.py:186-192
    ("XLA", 16, True, None),
    ("ONE_SHOT", 16, False, None),
    ("ONE_SHOT", 16, True, None),
    ("AUTO", 16, True, None),
    ("TWO_SHOT", 16, True, None),
    ("TWO_SHOT", 6, True, None),
    ("ONE_SHOT", 16, True, "int8"),
]


@pytest.mark.parametrize("case", RETURN_FAULT,
                         ids=lambda c: "-".join(map(str, c)))
def test_return_fault_raises_where_jax_does(case):
    method, rows, budget, wd = case
    n = 4
    x = np.random.default_rng(3).standard_normal((n, rows, 128)).astype(
        np.float32)

    def body(xs):
        return jc.all_reduce_shard(
            xs[0], axis="tp", num_ranks=n, method=jc.AllReduceMethod[method],
            wait_budget=4096 if budget else None, wire_dtype=wd,
            return_fault=True)

    try:
        jax.make_jaxpr(shard_map(
            body, mesh=_mesh(n), in_specs=P("tp", None, None),
            out_specs=(P(None, None), P("tp")), check_vma=False))(
                jnp.asarray(x))
        jax_raises = False
    except ValueError as e:
        assert "return_fault" in str(e)
        jax_raises = True
    call = functools.partial(
        tc.all_reduce_shard, torch.from_numpy(x), num_ranks=n,
        method=tc.AllReduceMethod[method],
        wait_budget=0.05 if budget else None, wire_dtype=wd,
        return_fault=True)
    if jax_raises:
        with pytest.raises(ValueError, match="return_fault"):
            call()
        return
    out, fault = call()
    assert fault.dtype == torch.int32 and torch.equal(
        fault, torch.zeros(n, dtype=torch.int32))
    np.testing.assert_allclose(out[0].numpy(), x.sum(0), rtol=1e-5,
                               atol=1e-5)


def test_shapes_are_checked():
    with pytest.raises(ValueError, match="not \\(n, rows, cols\\)"):
        tc.all_gather_shard(torch.zeros(3, 2, 2), num_ranks=4)
    with pytest.raises(ValueError, match="not \\(n, n \\* rows"):
        tc.reduce_scatter_shard(torch.zeros(4, 6, 2), num_ranks=4)
    with pytest.raises(ValueError, match="not \\(n \\* n \\* rows"):
        tc.all_to_all(torch.zeros(8, 2), num_ranks=4)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tc.all_reduce_shard(torch.zeros((4, 4, 8), device="meta"),
                            num_ranks=4, method=tc.AllReduceMethod.ONE_SHOT)


def test_one_rank_takes_the_plain_path_and_equals_jax():
    x = _inputs(1)
    mesh = _mesh(1)
    want = jax.jit(lambda a, r, g: (
        jc.all_reduce(a, mesh=mesh, method=jc.AllReduceMethod.ONE_SHOT),
        jc.reduce_scatter(r, mesh=mesh), jc.all_gather(g, mesh=mesh)))(
            x["all_reduce"], x["reduce_scatter"], x["all_gather"])
    tcommon.reset_dispatch()
    got = (tc.all_reduce(_torch(x["all_reduce"], "float32"), num_ranks=1,
                         method=tc.AllReduceMethod.ONE_SHOT),
           tc.reduce_scatter(_torch(x["reduce_scatter"], "float32"),
                             num_ranks=1),
           tc.all_gather(_torch(x["all_gather"], "float32"), num_ranks=1))
    assert tcommon.dispatch_counts() == {
        ("all_reduce", "xla", "n==1"): 1, ("reduce_scatter", "xla", "n==1"): 1,
        ("all_gather", "xla", "n==1"): 1}
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Choosers and the perf model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_all_gather_choice_equals_jax(n):
    for nbytes in (2, 4096, 1 << 20, (1 << 20) + 2, 4 << 20):
        assert tag.choose_method(nbytes, n).value == \
            jag.choose_method(nbytes, n).value


def test_all_gather_layer_cache_equals_jax():
    """At Qwen3-8B's decode shard (4 rows of 4096 bf16, 32 KiB) and prefill
    shard (512 rows, 4 MiB) on 4 ranks: the full mesh, then the ring."""
    jl = jll.AllGatherLayer(mesh=_mesh(4))
    tl = AllGatherLayer(num_ranks=4)
    for rows in (4, 512):
        shard = torch.zeros((4, rows, 4096), dtype=torch.bfloat16)
        jl._resolve_bytes(rows * 4096 * 2)
        assert tl.resolve(shard) == tl.resolve(shard.reshape(-1, 4096))
    assert {b: m.value for b, m in tl._by_bytes.items()} == \
        {b: m.value for b, m in jl._by_bytes.items()} == \
        {32768: "fullmesh_push", 4194304: "ring"}
    fixed = AllGatherLayer(num_ranks=4, method=tc.AllGatherMethod.RING)
    assert fixed.resolve(torch.zeros(4, 1, 8)) == tc.AllGatherMethod.RING
    x = _torch(_inputs(4)["all_gather"], "float32").reshape(4, ROWS, COLS)
    tcommon.reset_dispatch()
    got = fixed.shard(x)                 # rank-stacked: every rank's copy
    assert tcommon.dispatch_counts() == {("all_gather", "kernel", ""): 1}
    assert got.shape == (4, 4 * ROWS, COLS)
    assert all(torch.equal(g, x.reshape(-1, COLS)) for g in got)


def test_wire_bytes_equal_jax():
    for nbytes, itemsize, wd, blk in ((8192, 2, None, None),
                                      (8192, 2, "int8", None),
                                      (8192, 4, "float8_e4m3fn", 128)):
        assert tperf.wire_nbytes(nbytes, itemsize, wd, blk) == \
            jperf.wire_nbytes(nbytes, itemsize, wd, blk)


def _ar_crossover_bytes(n):
    """The wire bytes where the modeled two-shot AR overtakes the one-shot:
    (n - 1) wb / bw + L = 2 wb (n - 1) / n / bw + 2 (n - 1) L."""
    spec = tperf.chip_spec("h100")
    return ((2 * n - 3) * tperf.PEER_LATENCY_S * spec.hbm_bw
            / ((n - 1) * (1 - 2 / n)))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_auto_table_on_h100_figures(n):
    """AllReduce and ReduceScatter AUTO on the H100's figures
    (perf_model.CHIP_SPECS["h100"], PEER_LATENCY_S): at Qwen3-8B's decode
    AR (4 x 4096 bf16) one-shot; at two ranks one-shot at every size (the
    two-shot moves as many bytes through more hops); at n > 2 two-shot
    from the crossover on, which at 4 ranks lies above the prefill AR (2048
    x 4096 bf16, 16 MiB) while PEER_LATENCY_S > 1.5 us; the XLA estimate
    never wins (it ties the two-shot's); the full-mesh RS at every size."""
    spec = tperf.chip_spec("h100")
    ar, rs = tar.choose_method, trs.choose_method
    A, R = tc.AllReduceMethod, tc.ReduceScatterMethod
    assert ar(4 * 4096 * 2, n, spec=spec) == A.ONE_SHOT
    sizes = [1 << 10, 1 << 20, 16 << 20, 1 << 30]
    if n == 2:
        assert all(ar(b, n, spec=spec) == A.ONE_SHOT for b in sizes)
    else:
        cross = _ar_crossover_bytes(n)
        assert ar(int(cross / 2), n, spec=spec) == A.ONE_SHOT
        assert ar(int(cross * 2), n, spec=spec) == A.TWO_SHOT
    if n == 4:
        prefill = 2048 * 4096 * 2
        assert (ar(prefill, n, spec=spec) == A.ONE_SHOT) == \
            (prefill < _ar_crossover_bytes(4))
        assert (prefill < _ar_crossover_bytes(4)) == \
            (tperf.PEER_LATENCY_S > 1.5 * prefill / spec.hbm_bw / 5)
    assert all(ar(b, n, spec=spec) != A.XLA for b in sizes)
    assert all(rs(b, n, spec=spec) == R.FULLMESH for b in sizes)
    assert ar(1 << 20, 1) == A.XLA and rs(1 << 20, 1) == R.XLA
