"""The collective library's quantized wire (ops/collectives with
`wire_dtype`) against the JAX package's quant kernels, on an n-device CPU
mesh, inputs from numpy seeds.

Routes: reduce_scatter RING and FULLMESH (JAX `_ring_quant_kernel`,
`_fullmesh_quant_kernel`), all_reduce ONE_SHOT (`_one_shot_quant_kernel`)
and TWO_SHOT (`_two_shot_quant_shard`), and `quant_all_gather_shard`. The
JAX host-level functions run with their Pallas kernels in the TPU
interpreter, as tests/test_collectives.py runs them; the routes of one
(n, dtype, wire) run inside one `jax.jit`, once, in a cached helper (n 2
and 4 with every route, n 8 with the ring alone). The port runs its plain
versions on the same inputs (CPU tensors).

What holds:
- both packages lie within `wire.sum_error_bound` (quantizations n for
  the ring and the two-shot, 1 for the others) of the exact f32 sum, +
  1e-5 as the JAX tests allow; in bf16 also two bf16 roundings of the
  sum (the output's, and the two-shot's reduced chunk's);
- the port lies within twice that bound of JAX (+ 1e-5 in f32, 3e-2 in
  bf16);
- the full mesh, the one-shot and the gather equal JAX bit for bit in
  every output element whose scaling blocks got the same scale on both
  sides (jitted JAX may scale by a reciprocal multiply, one ulp off the
  port's IEEE quotient, ROADMAP Queue C 2); the ring's and the two-shot's
  hop scales are inside the kernels, so those two are held to the bounds
  alone;
- the reduce_scatter / all_reduce entries of the dispatch log equal
  JAX's; the port also logs its all_gather, which JAX does not.
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

from triton_distributed_tpu.ops import _common as jcommon
from triton_distributed_tpu.ops import collectives as jc
from triton_distributed_tpu.ops import wire as jwire
from triton_distributed_tpu_torch.ops import _common as tcommon
from triton_distributed_tpu_torch.ops import collectives as tc
from triton_distributed_tpu_torch.ops import wire as twire

jag = importlib.import_module("triton_distributed_tpu.ops.collectives."
                              "all_gather")
tag = importlib.import_module("triton_distributed_tpu_torch.ops.collectives."
                              "all_gather")

ROWS, COLS, BLK = 8, 256, 128
ROUTES = ("rs_ring", "rs_fullmesh", "ar_one_shot", "ar_two_shot",
          "quant_all_gather")
GROUPS = {(2, "float32", "int8"): ROUTES,
          (4, "bfloat16", "float8_e4m3fn"): ROUTES,
          (8, "float32", "int8"): ("rs_ring",)}
CASES = [(*g, r) for g, routes in GROUPS.items() for r in routes]
QUANTIZATIONS = {"rs_ring": None, "ar_two_shot": None, "rs_fullmesh": 1,
                 "ar_one_shot": 1, "quant_all_gather": 1}   # None: n
OP = {"rs_ring": ("reduce_scatter", "RING"),
      "rs_fullmesh": ("reduce_scatter", "FULLMESH"),
      "ar_one_shot": ("all_reduce", "ONE_SHOT"),
      "ar_two_shot": ("all_reduce", "TWO_SHOT")}


def _inputs(n, dtype):
    """f32 numpy inputs of each route, rounded to `dtype`: reduce_scatter
    (n, n * ROWS, COLS), all_reduce (n, ROWS, COLS), the gather's global
    (n * ROWS, COLS)."""
    rng = np.random.default_rng(100 + n)
    shapes = {"reduce_scatter": (n, n * ROWS, COLS),
              "all_reduce": (n, ROWS, COLS), "all_gather": (n * ROWS, COLS)}
    out = {}
    for k, s in shapes.items():
        a = rng.standard_normal(s).astype(np.float32)
        out[k] = np.asarray(torch.from_numpy(a).to(getattr(torch, dtype))
                            .float())
    return out


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("tp",))


@functools.lru_cache(maxsize=None)
def jax_group(n, dtype, wd):
    """The group's routes through the JAX host-level functions in one jit:
    ({route: f32 numpy}, dispatch log)."""
    mesh = _mesh(n)
    routes = GROUPS[(n, dtype, wd)]
    xs = {k: jnp.asarray(v, dtype) for k, v in _inputs(n, dtype).items()}

    def prog(xs):
        outs = []
        for r in routes:
            if r == "quant_all_gather":
                outs.append(shard_map(
                    lambda a: jag.quant_all_gather_shard(
                        a, axis="tp", num_ranks=n, wire_dtype=wd, block=BLK),
                    mesh=mesh, in_specs=P("tp", None),
                    out_specs=P(None, None), check_vma=False)(
                        xs["all_gather"]))
                continue
            op, m = OP[r]
            fn = jc.reduce_scatter if op == "reduce_scatter" else jc.all_reduce
            methods = (jc.ReduceScatterMethod if op == "reduce_scatter"
                       else jc.AllReduceMethod)
            outs.append(fn(xs[op], mesh=mesh, method=methods[m],
                           wire_dtype=wd, wire_block=BLK))
        return outs

    jcommon.reset_dispatch()
    outs = jax.jit(prog)(xs)
    return ({r: np.asarray(o).astype(np.float32) for r, o in
             zip(routes, outs)}, jcommon.dispatch_counts())


def _port(route, n, dtype, wd):
    """(the port's output as f32 numpy, its dispatch log)."""
    xs = {k: torch.from_numpy(v).to(getattr(torch, dtype))
          for k, v in _inputs(n, dtype).items()}
    tcommon.reset_dispatch()
    if route == "quant_all_gather":
        x = xs["all_gather"].reshape(n, ROWS, COLS)
        out = tag.quant_all_gather_shard(x, num_ranks=n, wire_dtype=wd,
                                         block=BLK)
        assert out.shape == (n, n * ROWS, COLS)
        assert all(torch.equal(o, out[0]) for o in out)
        out = out[0]
    else:
        op, m = OP[route]
        if op == "reduce_scatter":
            out = tc.reduce_scatter(xs[op], num_ranks=n, wire_dtype=wd,
                                    method=tc.ReduceScatterMethod[m],
                                    wire_block=BLK)
        else:
            out = tc.all_reduce(xs[op], num_ranks=n, wire_dtype=wd,
                                method=tc.AllReduceMethod[m], wire_block=BLK)
    assert out.dtype == getattr(torch, dtype)
    return out.float().numpy(), tcommon.dispatch_counts()


def _exact_and_bound(route, n, dtype, wd):
    """The exact f32 result and the elementwise bound around it."""
    x = _inputs(n, dtype)
    if route == "quant_all_gather":
        exact = x["all_gather"]
        bound = twire.sum_error_bound(exact[None], wd, BLK)
    else:
        op, _ = OP[route]
        exact = x[op].sum(0)
        bound = twire.sum_error_bound(x[op], wd, BLK,
                                      quantizations=QUANTIZATIONS[route] or n)
    bound = bound + 1e-5
    if dtype == "bfloat16":
        bound = bound + 2.0 ** -7 * np.abs(exact)
    return exact, bound


def _scales_agree(route, n, dtype, wd):
    """Per output element: True where every scaling block feeding it got
    the same scale from the port's codec and the jitted JAX codec."""
    x = _inputs(n, dtype)
    key = "all_gather" if route == "quant_all_gather" else OP[route][0]
    a = x[key]
    ts = twire.quant_blockwise(torch.from_numpy(a).to(getattr(torch, dtype)),
                               wd, BLK)[1].numpy()
    js = np.asarray(jax.jit(functools.partial(
        jwire.quant_blockwise, wire_dtype=wd, block=BLK))(
            jnp.asarray(a, dtype))[1])
    same = np.repeat(ts == js, BLK, axis=-1)
    return same if route == "quant_all_gather" else same.all(0)


def _rs_ar_log(log):
    return {k: v for k, v in log.items()
            if k[0] in ("reduce_scatter", "all_reduce")}


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_quant_route_equals_jax(case):
    n, dtype, wd, route = case
    want, _ = jax_group(n, dtype, wd)
    want = want[route]
    got, log = _port(route, n, dtype, wd)
    assert got.shape == want.shape
    exact, bound = _exact_and_bound(route, n, dtype, wd)
    assert (np.abs(got - exact) <= bound).all(), np.abs(got - exact).max()
    assert (np.abs(want - exact) <= bound).all(), np.abs(want - exact).max()
    slack = 1e-5 if dtype == "float32" else 3e-2
    assert (np.abs(got - want) <= 2 * (bound - 1e-5) + slack).all()
    if QUANTIZATIONS[route] == 1:
        same = _scales_agree(route, n, dtype, wd)
        assert same.any()
        np.testing.assert_array_equal(got[same], want[same])
    expect = {"rs_ring": {("reduce_scatter", "kernel", "wire"): 1},
              "rs_fullmesh": {("reduce_scatter", "kernel", "wire"): 1},
              "ar_one_shot": {("all_reduce", "kernel", "wire"): 1},
              "ar_two_shot": {("all_reduce", "kernel", "wire"): 1,
                              ("reduce_scatter", "kernel", "wire"): 1},
              "quant_all_gather": {}}[route]
    assert _rs_ar_log(log) == expect
    if route in ("ar_two_shot", "quant_all_gather"):
        assert log[("all_gather", "kernel", "")] == 1   # JAX logs none


@pytest.mark.parametrize("group", list(GROUPS),
                         ids=lambda g: "-".join(map(str, g)))
def test_quant_group_dispatch_log_equals_jax(group):
    """The reduce_scatter / all_reduce log of the whole group equals the
    JAX program's."""
    _, jax_log = jax_group(*group)
    tcommon.reset_dispatch()
    total = {}
    for route in GROUPS[group]:
        _, log = _port(route, *group)
        for k, v in _rs_ar_log(log).items():
            total[k] = total.get(k, 0) + v
    assert total == jax_log


def test_ring_quant_keeps_f32_between_hops():
    """The ring's acc stays f32 between hops: rounding it to bf16 at each
    hop (as the full-width ring's message is) gives another result."""
    rs = importlib.import_module(
        "triton_distributed_tpu_torch.ops.collectives.reduce_scatter")
    n = 4
    x = torch.from_numpy(_inputs(n, "bfloat16")["reduce_scatter"]).to(
        torch.bfloat16).reshape(n, n, ROWS, COLS)
    got = rs.ring_quant_plain(x, "int8", BLK)
    ranks = torch.arange(n)
    land = None
    for k in range(n - 1):
        acc = x[ranks, (ranks - 1 - k) % n].float()
        if k:
            acc = (acc + twire.dequant_blockwise(*land, torch.float32,
                                                 BLK)).to(torch.bfloat16)
        q, s = twire.quant_blockwise(acc, "int8", BLK)
        land = (torch.roll(q, 1, dims=0), torch.roll(s, 1, dims=0))
    rounded = (x[ranks, ranks].float() + twire.dequant_blockwise(
        *land, torch.float32, BLK)).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and not torch.equal(got, rounded)


def test_quant_all_gather_shard_equals_codec_round_trip():
    """`quant_all_gather_shard` over each method (and one rank) gives the
    codec's round trip of the gathered tensor, every rank's copy alike."""
    n = 4
    x = torch.from_numpy(_inputs(n, "float32")["all_gather"]).reshape(
        n, ROWS, COLS)
    q, s = twire.quant_blockwise(x.reshape(-1, COLS), "float8_e4m3fn", BLK)
    want = twire.dequant_blockwise(q, s, torch.float32, BLK)
    for m in tc.AllGatherMethod:
        out = tag.quant_all_gather_shard(x, num_ranks=n, block=BLK,
                                         wire_dtype="float8_e4m3fn",
                                         method=m)
        assert out.shape == (n, n * ROWS, COLS)
        assert all(torch.equal(o, want) for o in out), m
    one = tag.quant_all_gather_shard(x[:1], num_ranks=1, block=BLK,
                                     wire_dtype="int8")
    q1, s1 = twire.quant_blockwise(x[0], "int8", BLK)
    assert torch.equal(one[0], twire.dequant_blockwise(q1, s1, torch.float32,
                                                       BLK))
