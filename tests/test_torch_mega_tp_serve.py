"""The port's megakernel tensor-parallel serving (`ServeEngine(
DenseLLM(num_ranks=n), tp_ranks=n, mode="megakernel")`: MegaServe at n
ranks, one launch of every rank's program a decode or verify tick) against
the JAX package's ServeEngine(tp_ranks=n) in engine mode on 2- and
4-device CPU meshes, f32, over the 5-request stream of
tests/test_torch_tp_serve.py (two slots reused by five requests), prefix
caching off on both sides (a megakernel slot keeps only its prefill
blocks cached, so with the cache on the two modes free blocks apart). The
JAX suite's rule for this pair (test_serve.py:1274) needs the JAX
megakernel, whose remote-DMA kernels do not run on this CPU; the port's
program runs its plain queue walk here.

- at n = 2 and 4: greedy tokens, and after every tick the block table,
  lengths, free count and `per_rank` rows equal to the JAX engine's, each
  rank's `ar_bytes_pushed` JAX MegaServe's `ar_bytes_per_step` (slot_rows
  = JAX's f32 tile_m, 8) times the launches (speculation at n = 2 is
  tests/test_torch_mega_tp_spec.py);
- the int8 pool at n = 2 within `TOKEN_BAND` of the JAX f32 tokens, its
  control plane equal tick by tick;
- a sampled stream equal to the port's engine mode at n = 2 (the same
  generator draws), and the guards that stay.

The JAX engines run once, in a module fixture; their attention kernels
run in the plain Pallas interpreter (no DMA or semaphore in them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from triton_distributed_tpu import runtime as jruntime
from triton_distributed_tpu.megakernel.serve import MegaServe as JaxMegaServe
from triton_distributed_tpu.models import DenseLLM as JaxDenseLLM
from triton_distributed_tpu.models import ServeEngine as JaxServeEngine
from triton_distributed_tpu.models import config as jax_config
from triton_distributed_tpu.ops import attention as jattn
from triton_distributed_tpu_torch import models
from triton_distributed_tpu_torch.models import serve as tserve

TP_SHRINK = dict(hidden_size=64, intermediate_size=96, num_heads=4,
                 num_kv_heads=4, head_dim=16, vocab_size=128)
SHAPES = ((7, 4), (3, 2), (10, 5), (5, 3), (2, 4))
KW = dict(b_max=2, max_len=32, block=4, prefill_chunk=4, prefix_cache=False)
TILE_M = 8                     # the JAX MegaServe's f32 tile


class PlainInterpreter:
    """The JAX package's runtime module, with the plain Pallas interpreter
    for the kernels of ops/attention.py (no DMA or semaphore in them)."""

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


def _stream(vocab):
    rng = np.random.default_rng(5)
    return [(rng.integers(0, vocab, s).astype(np.int32), g)
            for s, g in SHAPES]


def _drive(se, reqs):
    """Submit, run, and record (table, lengths, free blocks, per-rank
    stats) after every tick. Returns ({submission index: tokens}, ticks,
    stats)."""
    rids = [se.submit(p, g) for p, g in reqs]
    ticks = []
    cls_tick = type(se)._tick

    def tick(stream_cb=None):
        cls_tick(se, stream_cb)
        c, st = se._cache, se.stats()
        ticks.append((np.asarray(c.block_table).copy(),
                      np.asarray(c.seq_lens).copy(), st["free_blocks"],
                      st["per_rank"]))

    se._tick = tick
    out = se.run()
    del se._tick
    return ({i: np.asarray(out[r]).tolist() for i, r in enumerate(rids)},
            ticks, se.stats())


@pytest.fixture(scope="module")
def jax_tp():
    """Per n: the JAX params (numpy), its engine-mode ServeEngine(
    tp_ranks=n) run and JAX MegaServe(tp_ranks=n)'s ar_bytes_per_step (a
    construction: no kernel runs)."""
    cfg = jax_config.get_config("Qwen/Qwen3-8B").tiny(**TP_SHRINK)
    reqs = _stream(cfg.vocab_size)
    out = {}
    for n in (2, 4):
        mesh = Mesh(np.asarray(jax.devices()[:n]), ("tp",))
        m = JaxDenseLLM(cfg, mesh=mesh, mode="ar", dtype=jnp.float32)
        p = m.init_params(jax.random.PRNGKey(0))
        run = _drive(JaxServeEngine(m, p, **KW, attn_method="xla",
                                    tp_ranks=n), reqs)
        jms = JaxMegaServe(m, p, b_max=KW["b_max"], max_len=KW["max_len"],
                           block=32, num_blocks=4, tp_ranks=n)
        assert jms.tm == TILE_M
        out[n] = {"params": jax.device_get(p), "run": run,
                  "ar_bytes_per_step": jms.ar_bytes_per_step}
    return cfg, reqs, out


def _port(jx, n, **kw):
    cfg = models.get_config("Qwen/Qwen3-8B").tiny(**TP_SHRINK)
    model = models.DenseLLM(cfg, mode="ar", dtype="float32", device="cpu",
                            num_ranks=n)
    params = models.params_from_jax(jx[n]["params"], device="cpu",
                                    num_ranks=n)
    return models.ServeEngine(model, params, **KW, tp_ranks=n,
                              mode="megakernel", **kw)


def _same_control_plane(ticks, jticks, ar_bytes):
    """Tables, lengths, free blocks and per-rank rows equal tick by tick,
    the megakernel's AR bytes aside, which must be `ar_bytes` a launch."""
    assert len(ticks) == len(jticks)
    launches = []
    for (ta, la, fa, pa), (tb, lb, fb, pb) in zip(ticks, jticks):
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(la, lb)
        assert fa == fb
        pushed = {r["ar_bytes_pushed"] for r in pa}
        assert len(pushed) == 1 and pushed.pop() % ar_bytes == 0
        launches.append(pa[0]["ar_bytes_pushed"] // ar_bytes)
        assert [{**r, "ar_bytes_pushed": 0} for r in pa] == pb
    return launches


@pytest.mark.parametrize("n", [2, 4])
def test_megakernel_tp_serve_equals_jax_tp_ranks(jax_tp, n):
    _, reqs, jx = jax_tp
    se = _port(jx, n, mk_opts={"slot_rows": TILE_M})
    toks, ticks, st = _drive(se, reqs)
    jtoks, jticks, jst = jx[n]["run"]
    assert toks == jtoks
    launches = _same_control_plane(ticks, jticks, jx[n]["ar_bytes_per_step"])
    assert se._mk.ar_bytes_per_step == jx[n]["ar_bytes_per_step"]
    # every decode tick is one launch of the n ranks' program
    assert st["megakernel_steps"] == st["decode_steps"] == launches[-1] > 0
    assert st["admitted"] == jst["admitted"] == len(reqs)
    assert st["tp_ranks"] == n and [r["rank"] for r in st["per_rank"]] == \
        list(range(n))
    prog = se._mk.prog
    assert prog.sharded and prog.n_ranks == n
    assert sum(nd.op == "all_reduce" for nd in prog.graph.nodes) == \
        2 * se.model.config.num_layers
    # each rank's pool holds its own kv heads, (L, n, pages, Hkv / n x D)
    L = se.model.config.num_layers
    assert se._mk.k_pool.shape == (L, n, (16 + 2) * 4, 4 // n * 16)
    se._cache.check_conservation()


def test_megakernel_tp2_int8_pool_within_band_of_jax(jax_tp):
    _, reqs, jx = jax_tp
    se = _port(jx, 2, kv_dtype="int8")
    toks, ticks, st = _drive(se, reqs)
    jtoks, jticks, _ = jx[2]["run"]
    tserve.banded_token_identity(jtoks, toks, kv_dtype="int8")
    _same_control_plane(ticks, jticks, se._mk.ar_bytes_per_step)
    assert st["kv_dtype"] == "int8" and st["megakernel_steps"] > 0


def test_megakernel_tp2_sampling_equals_engine_mode(jax_tp):
    """Sampling at n ranks draws as the port's engine path does (the
    rank-stacked lm_head's top-k, then the gathered candidates'), so a
    stream equals the engine mode's for the same seed."""
    _, reqs, jx = jax_tp
    kw = dict(temperature=0.9, top_k=5, seed=11)
    mk_toks, _, _ = _drive(_port(jx, 2, **kw), reqs)
    se = _port(jx, 2, **kw)
    eng = models.ServeEngine(se.model, se.params, **KW, tp_ranks=2, **kw)
    eng_toks, _, _ = _drive(eng, reqs)
    assert mk_toks == eng_toks
    assert mk_toks != jx[2]["run"][0]


def test_megakernel_tp_guards(jax_tp):
    """What stays refused at n ranks: an engine over another rank count,
    and the MoE megakernel (the engine refuses an n-rank MoE first)."""
    _, _, jx = jax_tp
    se = _port(jx, 2)
    with pytest.raises(ValueError, match="mesh rank"):
        models.ServeEngine(se.model, se.params, **KW, tp_ranks=4,
                           mode="megakernel")
    one = models.DenseLLM(se.model.config, dtype="float32", device="cpu")
    with pytest.raises(ValueError, match="mesh rank"):
        models.ServeEngine(one, None, **KW, tp_ranks=2, mode="megakernel")
    with pytest.raises(ValueError, match="tp_ranks=model.n"):
        models.ServeEngine(se.model, se.params, **KW, mode="megakernel")
    moe_cfg = models.get_config("Qwen/Qwen3-30B-A3B").tiny(
        hidden_size=64, num_heads=4, num_kv_heads=2, head_dim=16,
        vocab_size=128, num_experts=4, num_experts_per_tok=2,
        moe_intermediate_size=64)
    moe = models.Qwen3MoE(moe_cfg, mode="xla", dtype="float32", device="cpu",
                          num_ranks=2)
    with pytest.raises(ValueError, match="dense-only"):
        models.ServeEngine(moe, None, **KW, tp_ranks=2, mode="megakernel")
