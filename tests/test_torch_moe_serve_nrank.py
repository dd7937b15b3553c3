"""The port's ServeEngine over an n-rank Qwen3MoE (models/serve.py at
`tp_ranks=n` over `Qwen3MoE(num_ranks=n, moe_parallel="ep" | "tp")`)
against the JAX package's ServeEngine(tp_ranks=n) on 2- and 4-device CPU
meshes, f32, with the same weights (`params_from_jax`).

The config is the tiny Qwen3-30B-A3B of tests/test_torch_tp_models.py
(hidden 64, 8 / 4 heads of 16, 8 experts top-2, expert width 32, 2
layers). Four requests ride two slots (mid-stream finish and
re-admission). Each run must give the JAX engine's greedy tokens, block
tables, lengths and free counts after every tick, its rank ledgers
(`stats()["per_rank"]`) and its capacity counters, once without an
expert budget and once with `ep_capacity=1`, which defers slots: there no
request may be cut. At n = 2 with EP experts, speculative decoding (an
oracle drafter with accepts and rejects, the n-rank verify step routing
its rows through the same `_mlp_rows`) must give the JAX spec engine's
tokens and spec counters, and the plain run's tokens.

Every paged step of both packages takes replicated rows (the models'
decode MLP mode, "ar"), so EP experts run `decode_rows_shard` (each rank
its own experts' share, then a psum) and no step reaches the ragged
all-to-all: `ep_method` does not change a serving step in either package.
The models keep the default "ragged" transport; the JAX grouped GEMM
takes its XLA form (`use_xla`) and the JAX attention kernels run in the
plain Pallas interpreter (they hold no DMA or semaphore), which keeps
each JAX run to a few seconds. Each JAX engine runs once a process per
case, when a test first needs it, each (n, experts) pair sharing one
compile of the steps.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from triton_distributed_tpu import runtime as jruntime
from triton_distributed_tpu.models import OracleDrafter as JaxOracle
from triton_distributed_tpu.models import ServeEngine as JaxServeEngine
from triton_distributed_tpu.models import SpecConfig as JaxSpecConfig
from triton_distributed_tpu.models import config as jax_config
from triton_distributed_tpu.models.qwen_moe import Qwen3MoE as JaxQwen3MoE
from triton_distributed_tpu.ops import attention as jattn
from triton_distributed_tpu.ops.grouped_gemm import \
    GroupedGemmConfig as JaxGemmConfig
from triton_distributed_tpu.ops.moe_parallel import \
    MoEParallelConfig as JaxMoEConfig
from triton_distributed_tpu_torch import models
from triton_distributed_tpu_torch.ops.grouped_gemm import GroupedGemmConfig
from triton_distributed_tpu_torch.ops.moe_parallel import MoEParallelConfig

NAME = "Qwen/Qwen3-30B-A3B"
SHRINK = dict(hidden_size=64, num_heads=8, num_kv_heads=4, head_dim=16,
              vocab_size=128, moe_intermediate_size=32)
ENGINE = dict(b_max=2, max_len=32, block=4, prefill_chunk=8)
COUNTERS = ("ticks", "admitted", "finished", "prefill_chunks", "tokens",
            "free_blocks", "total_blocks", "capacity_drops", "ep_rows",
            "ep_capacity", "per_rank", "tp_ranks")
# (n, experts, ep_capacity): the EP layout at n 2 and 4, TP experts at 2
CASES = [(2, "ep", 0), (2, "ep", 1), (4, "ep", 0), (4, "ep", 1),
         (2, "tp", 0), (2, "tp", 1)]


class PlainInterpreter:
    """The JAX package's runtime module, but with the plain Pallas
    interpreter (interpret=True) for the kernels of ops/attention.py."""

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


def _stream():
    rng = np.random.default_rng(7)
    return [(rng.integers(0, SHRINK["vocab_size"], s).astype(np.int32), g)
            for s, g in ((5, 3), (3, 4), (7, 3), (6, 2))]


def _oracle(pkg_oracle):
    """An oracle drafter with every second stream position wrong; its
    targets are set once the requests have ids (`_spec_drive`)."""
    return pkg_oracle({}, {}, wrong_every=2, vocab=SHRINK["vocab_size"])


def _spec_drive(se, targets):
    rids = [se.submit(p, g) for p, g in _stream()]
    d = se.spec.drafter
    d.targets = {r: np.asarray(targets[i]) for i, r in enumerate(rids)}
    d.prompts = {r: int(p.size) for r, (p, _) in zip(rids, _stream())}
    out = se.run()
    return ({i: np.asarray(out[r]).tolist() for i, r in enumerate(rids)},
            se.stats())


def _drive(se):
    """Submit, run, and record (table, lengths, free blocks) after every
    tick. Returns ({submission index: tokens}, ticks, stats)."""
    rids = [se.submit(p, g) for p, g in _stream()]
    ticks = []
    cls_tick = type(se)._tick

    def tick(stream_cb=None):
        cls_tick(se, stream_cb)
        c = se._cache
        ticks.append((np.asarray(c.block_table).copy(),
                      np.asarray(c.seq_lens).copy(),
                      int(c.num_free_blocks)))

    se._tick = tick
    out = se.run()
    del se._tick
    return ({i: np.asarray(out[r]).tolist() for i, r in enumerate(rids)},
            ticks, se.stats())


@functools.lru_cache(maxsize=None)
def _jax_model(n, par):
    """The JAX Qwen3MoE at n ranks with its params and the engine steps
    (pure functions: every engine over the model shares one compile)."""
    cfg = jax_config.get_config(NAME).tiny(**SHRINK)
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("tp",))
    m = JaxQwen3MoE(cfg, mesh=mesh, mode="ar", dtype=jnp.float32,
                    moe_parallel=par, moe_config=JaxMoEConfig(
                        gemm=JaxGemmConfig(block_m=8, use_xla=True)))
    return m, m.init_params(jax.random.PRNGKey(n)), {}


def _jax_engine(n, par, **kw):
    m, p, steps = _jax_model(n, par)
    se = JaxServeEngine(m, p, **ENGINE, attn_method="xla", tp_ranks=n, **kw)
    if "speculative" not in kw:
        if steps:
            se._decode, se._prefill = steps["decode"], steps["prefill"]
        else:
            steps.update(decode=se._decode, prefill=se._prefill)
    return se


@functools.lru_cache(maxsize=None)
def _jax_serve(n, par, cap):
    """The JAX params (numpy) and its ServeEngine(tp_ranks=n) run, once a
    process per case."""
    se = _jax_engine(n, par, ep_capacity=cap)
    return jax.device_get(_jax_model(n, par)[1]), _drive(se)


@functools.lru_cache(maxsize=None)
def _jax_spec():
    """The JAX speculative run at n 2 with EP experts, the oracle fed the
    plain run's tokens."""
    se = _jax_engine(2, "ep", speculative=JaxSpecConfig(
        drafter=_oracle(JaxOracle), k=3, adapt=False))
    return _spec_drive(se, _jax_serve(2, "ep", 0)[1][0])


def _port(n, par):
    return models.Qwen3MoE(
        models.get_config(NAME).tiny(**SHRINK), mode="ar", dtype="float32",
        device="cpu", num_ranks=n, moe_parallel=par,
        moe_config=MoEParallelConfig(gemm=GroupedGemmConfig(block_m=8)))


@pytest.mark.parametrize("n,par,cap", CASES)
def test_nrank_moe_serve_equals_jax(n, par, cap):
    jparams, (jtoks, jticks, jst) = _jax_serve(n, par, cap)
    model = _port(n, par)
    params = models.params_from_jax(jparams, device="cpu", num_ranks=n,
                                    moe_parallel=par)
    se = models.ServeEngine(model, params, **ENGINE, tp_ranks=n,
                            ep_capacity=cap)
    toks, ticks, st = _drive(se)
    assert toks == jtoks
    assert len(ticks) == len(jticks)
    for i, (t, j) in enumerate(zip(ticks, jticks)):
        for a, b, what in zip(t, j, ("table", "lens", "free")):
            np.testing.assert_array_equal(a, b, err_msg=f"{what}, tick {i}")
    assert {k: st[k] for k in COUNTERS} == {k: jst[k] for k in COUNTERS}
    # no request is cut, with or without the budget
    assert [len(toks[i]) for i in range(4)] == [g for _, g in _stream()]
    assert (st["capacity_drops"] > 0) == (cap > 0)
    assert st["per_rank"] and [r["rank"] for r in st["per_rank"]] == \
        list(range(n))
    # the n-rank plan: the layer's own transport and chunks (EP), the
    # one-rank plan for TP experts, as the JAX engine passes num_ranks
    plan = st["ep_plan"]
    if par == "ep":
        assert plan == {"occupancy": plan["occupancy"],
                        "transport": "ragged", "num_chunks": 1,
                        "a2a_round_s": None}
    else:
        assert plan == jst["ep_plan"]
    se._cache.check_conservation(cached=se._pool._cached_only())


def test_nrank_moe_speculative_equals_jax():
    jparams, (plain, _, _) = _jax_serve(2, "ep", 0)
    jtoks, jst = _jax_spec()
    se = models.ServeEngine(
        _port(2, "ep"), models.params_from_jax(jparams, device="cpu",
                                               num_ranks=2, moe_parallel="ep"),
        **ENGINE, tp_ranks=2,
        speculative=models.SpecConfig(drafter=_oracle(models.OracleDrafter),
                                      k=3, adapt=False))
    toks, st = _spec_drive(se, plain)
    assert toks == jtoks == plain
    assert st["spec_accepted"] > 0 and st["spec_rejected"] > 0
    for key in ("spec_proposed", "spec_accepted", "spec_rejected",
                "rollback_blocks", "ticks", "per_rank", "ep_rows"):
        assert st[key] == jst[key], key
