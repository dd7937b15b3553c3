"""The port's ServeEngine serving a Qwen3MoE (triton_distributed_tpu_torch
models/serve.py with the expert-capacity budget) against the JAX
package's, on the CPU.

Both engines serve one submit stream on the tiny Qwen3-30B-A3B config
(2 layers, 8 experts, top-2, block_m 8) in f32 with the same weights
(`params_from_jax`): four requests through two slots. The runs must give
equal greedy tokens, equal block tables, lengths and free counts after
every tick, and equal counters, the expert-capacity ones
(`capacity_drops`, `ep_rows`, `ep_capacity`, `ep_plan`) included, once
without a budget and once with one that defers slots.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from triton_distributed_tpu.models import ServeEngine as JaxServeEngine
from triton_distributed_tpu.models import config as jax_config
from triton_distributed_tpu.models.qwen_moe import Qwen3MoE as JaxQwen3MoE
from triton_distributed_tpu.ops import grouped_gemm as jgg
from triton_distributed_tpu.ops import moe_parallel as jmp
from triton_distributed_tpu_torch import models
from triton_distributed_tpu_torch.ops import grouped_gemm as tgg
from triton_distributed_tpu_torch.ops import moe_parallel as tmp

NAME = "Qwen/Qwen3-30B-A3B"
ENGINE = dict(b_max=2, max_len=32, block=4, prefill_chunk=8)
COUNTERS = ("ticks", "admitted", "finished", "evictions", "requeued",
            "prefill_chunks", "tokens", "prefix_hit_blocks",
            "prefix_miss_blocks", "cow_copies", "reclaimed_blocks",
            "preemptions", "grant_refusals", "free_blocks",
            "cached_free_blocks", "total_blocks", "queue_depth",
            "occupancy", "capacity_drops", "ep_rows", "ep_capacity",
            "ep_plan")


@pytest.fixture(scope="module")
def f32_pair():
    mesh1 = Mesh(np.asarray(jax.devices()[:1]), ("tp",))
    jm = JaxQwen3MoE(jax_config.get_config(NAME).tiny(num_layers=2),
                     mesh=mesh1, mode="xla", dtype=jnp.float32,
                     moe_config=jmp.MoEParallelConfig(
                         gemm=jgg.GroupedGemmConfig(block_m=8)))
    jp = jm.init_params(jax.random.PRNGKey(0))
    port = models.Qwen3MoE(
        models.get_config(NAME).tiny(num_layers=2), mode="xla",
        dtype="float32", device="cpu", moe_config=tmp.MoEParallelConfig(
            gemm=tgg.GroupedGemmConfig(block_m=8)))
    return (jm, jp), (port, models.params_from_jax(jax.device_get(jp),
                                                   device="cpu"))


def _stream():
    """Four requests through two slots: mid-stream finish and
    re-admission (one prefill chunk each, so the JAX engine compiles one
    prefill program)."""
    rng = np.random.default_rng(7)
    return [(rng.integers(0, 256, n).astype(np.int32), g)
            for n, g in ((5, 3), (3, 4), (7, 3), (6, 2))]


def _drive(se, table_of, lens_of, free_of):
    for r, g in _stream():
        se.submit(r, g)
    ticks = []
    cls_tick = type(se)._tick

    def tick(stream_cb=None):
        cls_tick(se, stream_cb)
        c = se._cache
        ticks.append((table_of(c).copy(), lens_of(c).copy(), free_of(c)))

    se._tick = tick
    out = se.run()
    del se._tick
    return {k: list(map(int, v)) for k, v in out.items()}, ticks, se.stats()


_JAX_STEPS = {}


@pytest.fixture(scope="module", params=[0, 1])
def serve_runs(request, f32_pair):
    (jm, jp), (port, params) = f32_pair
    cap = request.param
    jse = JaxServeEngine(jm, jp, ep_capacity=cap, **ENGINE)
    # both JAX runs share one compile of the model's jitted steps (pure
    # functions of the model and their inputs)
    if _JAX_STEPS:
        jse._decode, jse._prefill = _JAX_STEPS["decode"], _JAX_STEPS["prefill"]
    else:
        _JAX_STEPS.update(decode=jse._decode, prefill=jse._prefill)
    jrun = _drive(jse, lambda c: np.asarray(c.block_table),
                  lambda c: np.asarray(c.seq_lens),
                  lambda c: int(c.num_free_blocks))
    tse = models.ServeEngine(port, params, ep_capacity=cap, **ENGINE)
    trun = _drive(tse, lambda c: c.block_table, lambda c: c.seq_lens,
                  lambda c: c.num_free_blocks)
    return cap, jrun, trun, tse


def test_serve_engine_matches_jax(serve_runs):
    cap, (jtok, jticks, jstats), (ttok, tticks, tstats), tse = serve_runs
    assert len(tticks) == len(jticks)
    for n, (t, j) in enumerate(zip(tticks, jticks)):
        for a, b, name in zip(t, j, ("table", "lens", "free")):
            np.testing.assert_array_equal(a, b, err_msg=f"{name}, tick {n}")
    assert {k: tstats[k] for k in COUNTERS} == \
        {k: jstats[k] for k in COUNTERS}
    assert ttok == jtok and sorted(ttok) == [0, 1, 2, 3]
    stream = _stream()
    assert [len(ttok[r]) for r in range(4)] == [g for _, g in stream]
    # each request's first token rides its prefill, so decode routes
    # gen - 1 rows per request through the budget
    assert tstats["ep_rows"] == (sum(g - 1 for _, g in stream) if cap else 0)
    assert tstats["ep_plan"]["num_chunks"] == 1
    if cap:
        assert tstats["capacity_drops"] > 0
    else:
        assert tstats["capacity_drops"] == 0
    assert tstats["ep_capacity"] == cap
    tse._cache.check_conservation(cached=tstats["cached_free_blocks"])


def test_serve_tokens_equal_per_request_engine(f32_pair):
    """The deferring budget changes no token: each request's stream
    equals the port's own Engine.serve of it alone."""
    _, (port, params) = f32_pair
    se = models.ServeEngine(port, params, ep_capacity=1, **ENGINE)
    stream = _stream()
    outs = se.serve([r for r, _ in stream], [g for _, g in stream])
    eng = models.Engine(port, params, max_len=32)
    for (ids, gen), got in zip(stream, outs):
        np.testing.assert_array_equal(got, eng.serve(ids[None], gen)[0])
    assert se.stats()["capacity_drops"] > 0
