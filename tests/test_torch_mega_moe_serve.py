"""ServeEngine(Qwen3MoE, mode="megakernel") of the port (MegaServe over
the MoE serving program) against the JAX package's engine-mode
ServeEngine and the port's own engine mode, on the CPU.

The model is the JAX package's tiny MoE serving config (hidden 64, 4
experts, top-2, moe intermediate 64, head_dim 16) in f32 with the same
weights, and the stream its MoE serving test's: three requests through
two slots at 4-token pages (a mid-stream finish and re-admission), one
prefill chunk a prompt (each chunk size is one more JAX compile). On the
CPU the megakernel program runs its plain queue walk. Greedy tokens,
the block table and lengths after every tick, and the expert-capacity
counters (`capacity_drops`, `ep_rows`) must equal the JAX engine's (the
tokens the port's engine mode's too), with no budget and with
`ep_capacity=1` (which defers slots); every decode
tick is one megakernel step, and a deferred slot rides it at width 0.
(The free count may differ: a megakernel slot returns its decode
blocks to the free list where the engine path caches them.) An
int8 pool gives exactly the int8 engine mode's tokens. The JAX
megakernel itself (interpret-mode Pallas) is not run here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from triton_distributed_tpu.models import ServeEngine as JaxServeEngine
from triton_distributed_tpu.models import config as jax_config
from triton_distributed_tpu.models.qwen_moe import Qwen3MoE as JaxQwen3MoE
from triton_distributed_tpu_torch import models
from triton_distributed_tpu_torch.megakernel import MegaServe
from triton_distributed_tpu_torch.models import serve as tserve

NAME = "Qwen/Qwen3-30B-A3B"
SHRINK = dict(hidden_size=64, intermediate_size=96, num_heads=4,
              num_kv_heads=2, head_dim=16, vocab_size=128, num_experts=4,
              num_experts_per_tok=2, moe_intermediate_size=64)
ENGINE = dict(b_max=2, max_len=32, block=4, prefill_chunk=16)


def _reqs():
    rng = np.random.default_rng(7)
    return [(rng.integers(0, 128, s).astype(np.int32), g)
            for s, g in ((5, 3), (3, 4), (9, 3))]


def _drive(se, table_of, lens_of):
    """Run the stream, keeping (table, lengths) after every tick.
    Returns (tokens by rid, ticks, stats)."""
    for r, g in _reqs():
        se.submit(r, g)
    ticks = []
    cls_tick = type(se)._tick

    def tick(stream_cb=None):
        cls_tick(se, stream_cb)
        c = se._cache
        ticks.append((table_of(c).copy(), lens_of(c).copy()))

    se._tick = tick
    out = se.run()
    del se._tick
    return {k: list(map(int, v)) for k, v in out.items()}, ticks, se.stats()


@pytest.fixture(scope="module")
def pair():
    mesh1 = Mesh(np.asarray(jax.devices()[:1]), ("tp",))
    jm = JaxQwen3MoE(jax_config.get_config(NAME).tiny(**SHRINK), mesh=mesh1,
                     mode="xla", dtype=jnp.float32)
    jp = jm.init_params(jax.random.PRNGKey(0))
    pm = models.Qwen3MoE(models.get_config(NAME).tiny(**SHRINK), mode="xla",
                         dtype="float32", device="cpu")
    return (jm, jp), (pm, models.params_from_jax(jax.device_get(jp),
                                                 device="cpu"))


_JAX_STEPS = {}


@pytest.fixture(scope="module", params=[0, 1])
def runs(request, pair):
    (jm, jp), (pm, pp) = pair
    cap = request.param
    jse = JaxServeEngine(jm, jp, ep_capacity=cap, attn_method="xla",
                         **ENGINE)
    # both JAX runs share one compile of the model's jitted steps
    if _JAX_STEPS:
        jse._decode, jse._prefill = _JAX_STEPS["decode"], _JAX_STEPS["prefill"]
    else:
        _JAX_STEPS.update(decode=jse._decode, prefill=jse._prefill)
    jrun = _drive(jse, lambda c: np.asarray(c.block_table),
                  lambda c: np.asarray(c.seq_lens))
    tse = models.ServeEngine(pm, pp, mode="megakernel", ep_capacity=cap,
                             **ENGINE)
    widths = []
    step = tse._mk.prog.step

    def spy(*a, **kw):
        widths.append(np.asarray(kw["widths"]).copy())
        return step(*a, **kw)

    tse._mk.prog.step = spy
    trun = _drive(tse, lambda c: c.block_table, lambda c: c.seq_lens)
    return cap, jrun, trun, tse, widths


def test_megakernel_matches_jax_engine(runs):
    cap, (jtok, jticks, jst), (ttok, tticks, tst), tse, widths = runs
    assert ttok == jtok and sorted(ttok) == [0, 1, 2]
    # and the port's own engine mode under the same budget
    _, eng = _serve(*_port(tse), ep_capacity=cap)
    assert {r: list(map(int, t)) for r, t in eng.items()} == ttok
    assert len(tticks) == len(jticks)
    for n, (t, j) in enumerate(zip(tticks, jticks)):
        for a, b, name in zip(t, j, ("table", "lens")):
            np.testing.assert_array_equal(a, b, err_msg=f"{name}, tick {n}")
    for k in ("capacity_drops", "ep_rows", "ep_capacity", "tokens",
              "prefill_chunks"):
        assert tst[k] == jst[k], k
    assert [len(ttok[r]) for r in range(3)] == [g for _, g in _reqs()]
    # every decode tick took the one megakernel step, a deferred slot at
    # width 0: the widths sum to the rows decode routed
    assert tst["megakernel_steps"] == tst["decode_steps"] == len(widths) > 0
    assert tse.trace_counts["decode"] == 1
    assert sum(int(w.sum()) for w in widths) == sum(g - 1
                                                    for _, g in _reqs())
    if cap:
        assert tst["capacity_drops"] > 0
        assert tst["ep_rows"] == sum(g - 1 for _, g in _reqs())
        assert all(w.sum() <= cap for w in widths)
    else:
        assert (tst["capacity_drops"], tst["ep_rows"]) == (0, 0)
    tse._cache.check_conservation(cached=tst["cached_free_blocks"])


def _port(se):
    return se.model, se.params


def _serve(pm, pp, **kw):
    se = models.ServeEngine(pm, pp, **ENGINE, **kw)
    rids = [se.submit(p, g) for p, g in _reqs()]
    out = se.run()
    return se, {r: out[r] for r in rids}


def test_megakernel_equals_engine_mode_at_slot_rows_8(pair):
    """Seven pad rows a slot, dead to the expert FFN: the same tokens as
    the port's engine mode."""
    _, (pm, pp) = pair
    _, eng = _serve(pm, pp)
    se, mk8 = _serve(pm, pp, mode="megakernel", mk_opts={"slot_rows": 8})
    for r in eng:
        np.testing.assert_array_equal(mk8[r], eng[r])
    assert se._mk.prog.inputs["x"].shape == (2 * 8, SHRINK["hidden_size"])


def test_int8_pool_megakernel_equals_int8_engine(pair):
    _, (pm, pp) = pair
    _, eng = _serve(pm, pp, kv_dtype="int8")
    se, mk = _serve(pm, pp, mode="megakernel", kv_dtype="int8")
    rep = tserve.banded_token_identity(eng, mk)       # no band: exact
    assert rep["agreed_frac"] == 1.0
    assert se.stats()["megakernel_steps"] > 0


def test_mega_serve_refuses_expert_parallel(pair):
    _, (pm, pp) = pair
    pm.moe_parallel = "ep"
    try:
        with pytest.raises(ValueError, match="expert-parallel"):
            MegaServe(pm, pp, b_max=1, max_len=16, block=4, num_blocks=4)
    finally:
        pm.moe_parallel = "tp"
