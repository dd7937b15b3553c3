"""The port's tensor-parallel serving (models/serve.py over
DenseLLM(num_ranks=n), `ServeEngine(tp_ranks=n)`) against the JAX
package's ServeEngine(tp_ranks=n) on 2- and 4-device CPU meshes, f32, over
the 5-request stream of the JAX suite's
`test_serve_tp2_matches_single_rank_e2e` (two slots reused by five
requests):

- at n = 2 and 4, in modes "ar" and "gemm_ar" (the JAX engine runs "ar":
  its paged steps end in psum either way), greedy tokens and, after every
  tick, the block table, lengths, free count and `stats()["per_rank"]`
  equal to the JAX engine's;
- at n = 2, speculation (an oracle drafter, accepts and rejects) with
  tokens and spec counters equal to the JAX spec engine's, and the int8
  and fp8 pools within `TOKEN_BAND` of the f32 tokens (the JAX suite's
  `test_serve_tp2_kv_dtype_identity` rule), their control plane equal;
- the constructor guards of the JAX suite's `test_serve_tp_ranks_guards`,
  with its ValueErrors, and the refusals that stay.

The JAX engines run once, in a module fixture; their attention kernels
run in the plain Pallas interpreter (no DMA or semaphore in them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_distributed_tpu import runtime as jruntime
from triton_distributed_tpu.models import DenseLLM as JaxDenseLLM
from triton_distributed_tpu.models import OracleDrafter as JaxOracle
from triton_distributed_tpu.models import ServeEngine as JaxServeEngine
from triton_distributed_tpu.models import SpecConfig as JaxSpecConfig
from triton_distributed_tpu.models import config as jax_config
from triton_distributed_tpu.ops import attention as jattn
from triton_distributed_tpu_torch import models
from triton_distributed_tpu_torch.models import serve as tserve

# the JAX suite's tp_twin config with 4 kv heads, so it splits at n = 4 too
TP_SHRINK = dict(hidden_size=64, intermediate_size=96, num_heads=4,
                 num_kv_heads=4, head_dim=16, vocab_size=128)
SHAPES = ((7, 4), (3, 2), (10, 5), (5, 3), (2, 4))
KW = dict(b_max=2, max_len=32, block=4, prefill_chunk=4)


class PlainInterpreter:
    """The JAX package's runtime module, but with the plain Pallas
    interpreter (interpret=True) for the kernels of ops/attention.py,
    which hold no DMA or semaphore."""

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


def _same_ticks(a, b):
    assert len(a) == len(b)
    for (ta, la, fa, pa), (tb, lb, fb, pb) in zip(a, b):
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(la, lb)
        assert fa == fb and pa == pb


def _oracle(pkg_oracle):
    """An oracle drafter with every second stream position wrong; its
    targets are set once the requests have ids (`_spec_drive`)."""
    return pkg_oracle({}, {}, wrong_every=2, vocab=TP_SHRINK["vocab_size"])


def _spec_drive(se, reqs, targets):
    """Submit and run, the engine's oracle drafter fed the plain run's
    tokens."""
    rids = [se.submit(p, g) for p, g in reqs]
    d = se.spec.drafter
    d.targets = {r: np.asarray(targets[i]) for i, r in enumerate(rids)}
    d.prompts = {r: int(p.size) for r, (p, _) in zip(rids, reqs)}
    out = se.run()
    return ({i: np.asarray(out[r]).tolist() for i, r in enumerate(rids)},
            se.stats())


@pytest.fixture(scope="module")
def jax_tp():
    """Per n: the JAX params (numpy), its ServeEngine(tp_ranks=n) run; at
    n = 2 also the speculative run."""
    cfg = jax_config.get_config("Qwen/Qwen3-8B").tiny(**TP_SHRINK)
    reqs = _stream(cfg.vocab_size)
    out = {}
    for n in (2, 4):
        mesh = Mesh(np.asarray(jax.devices()[:n]), ("tp",))
        m = JaxDenseLLM(cfg, mesh=mesh, mode="ar", dtype=jnp.float32)
        p = m.init_params(jax.random.PRNGKey(0))
        run = _drive(JaxServeEngine(m, p, **KW, attn_method="xla",
                                    tp_ranks=n), reqs)
        out[n] = {"params": jax.device_get(p), "run": run}
        if n == 2:
            spec = JaxServeEngine(
                m, p, **KW, attn_method="xla", tp_ranks=2,
                speculative=JaxSpecConfig(drafter=_oracle(JaxOracle), k=3,
                                          adapt=False))
            out[n]["spec"] = _spec_drive(spec, reqs, run[0])
    return cfg, reqs, out


def _port_model(n, mode="ar", **kw):
    cfg = models.get_config("Qwen/Qwen3-8B").tiny(**TP_SHRINK)
    return models.DenseLLM(cfg, mode=mode, dtype="float32", device="cpu",
                           num_ranks=n, **kw)


@pytest.mark.parametrize("n,mode", [(2, "ar"), (2, "gemm_ar"), (4, "ar"),
                                    (4, "gemm_ar")])
def test_tp_serve_equals_jax_tp_ranks(jax_tp, n, mode):
    _, reqs, jx = jax_tp
    model = _port_model(n, mode)
    params = models.params_from_jax(jx[n]["params"], device="cpu",
                                    num_ranks=n)
    se = models.ServeEngine(model, params, **KW, tp_ranks=n)
    toks, ticks, st = _drive(se, reqs)
    jtoks, jticks, jst = jx[n]["run"]
    assert toks == jtoks
    _same_ticks(ticks, jticks)
    assert st["admitted"] == jst["admitted"] == len(reqs)  # slots reused
    assert st["tp_ranks"] == jst["tp_ranks"] == n
    assert st["per_rank"] == jst["per_rank"]
    assert any(pr and pr[0]["held_blocks"] > 0 for *_, pr in ticks)
    assert [r["rank"] for r in st["per_rank"]] == list(range(n))
    # the head-sharded pool: (L, n, nb, Hkv / n, block, D), global ids
    assert se._cache.k_pool.shape[1:3] == (n, st["total_blocks"])
    se._cache.check_conservation(cached=se._pool._cached_only())


def test_tp2_speculative_equals_jax(jax_tp):
    """The oracle drafter's accepts and rejects at n = 2 (rollback as a
    table edit mirrored on both ranks' ledgers): tokens equal to the JAX
    spec engine's and to the plain run's, the spec counters equal."""
    _, reqs, jx = jax_tp
    model = _port_model(2)
    params = models.params_from_jax(jx[2]["params"], device="cpu",
                                    num_ranks=2)
    se = models.ServeEngine(
        model, params, **KW, tp_ranks=2,
        speculative=models.SpecConfig(drafter=_oracle(models.OracleDrafter),
                                      k=3, adapt=False))
    toks, st = _spec_drive(se, reqs, jx[2]["run"][0])
    jtoks, jst = jx[2]["spec"]
    assert toks == jtoks == jx[2]["run"][0]
    assert st["spec_accepted"] > 0 and st["spec_rejected"] > 0
    for key in ("spec_proposed", "spec_accepted", "spec_rejected",
                "rollback_blocks", "ticks", "per_rank"):
        assert st[key] == jst[key], key


@pytest.mark.parametrize("kv", ["int8", "float8_e4m3fn"])
def test_tp2_quantized_pool_within_band_of_jax(jax_tp, kv):
    """A wire-width pool head-sharded with its scale sidecars: tokens
    within the dtype's band of the JAX f32 engine's (the JAX suite's
    rule), the control plane (which the pool dtype does not move) equal
    tick by tick."""
    _, reqs, jx = jax_tp
    model = _port_model(2)
    params = models.params_from_jax(jx[2]["params"], device="cpu",
                                    num_ranks=2)
    se = models.ServeEngine(model, params, **KW, tp_ranks=2, kv_dtype=kv)
    toks, ticks, st = _drive(se, reqs)
    jtoks, jticks, _ = jx[2]["run"]
    tserve.banded_token_identity(jtoks, toks, kv_dtype=kv)
    _same_ticks(ticks, jticks)
    assert st["kv_dtype"] == kv and st["tp_ranks"] == 2
    L = model.config.num_layers
    assert se._cache.k_scales.shape[:3] == (L, 2, st["total_blocks"])
    se._cache.check_conservation(cached=se._pool._cached_only())


def test_tp_ranks_guards():
    """JAX test_serve_tp_ranks_guards' engine half, with its errors; the
    megakernel at n ranks builds, and an n-rank MoE stays refused, naming
    what takes it."""
    m1, m2 = _port_model(1), _port_model(2)
    p2 = m2.init_params(torch.Generator().manual_seed(0))
    p1 = m1.init_params(torch.Generator().manual_seed(0))
    kw = dict(b_max=1, max_len=16, block=4)
    for bad in (True, 0, -1, 2.0, "2"):
        with pytest.raises(ValueError, match="positive integer"):
            models.ServeEngine(m2, p2, **kw, tp_ranks=bad)
    with pytest.raises(ValueError, match="mesh rank"):
        models.ServeEngine(m2, p2, **kw, tp_ranks=3)
    with pytest.raises(ValueError, match="mesh rank"):
        models.ServeEngine(m1, p1, **kw, tp_ranks=2)
    sp = _port_model(4, attn_parallelism="sp")
    with pytest.raises(ValueError, match="cannot compose"):
        models.ServeEngine(sp, None, **kw, tp_ranks=4)
    # the megakernel at n ranks builds one program of every rank
    # (tests/test_torch_mega_tp_serve.py runs it)
    mk = models.ServeEngine(m2, p2, **kw, tp_ranks=2, mode="megakernel")._mk
    assert mk.n == 2 and mk.prog.sharded and mk.prog.n_ranks == 2
    moe_cfg = models.get_config("Qwen/Qwen3-30B-A3B").tiny(
        hidden_size=64, num_heads=4, num_kv_heads=2, head_dim=16,
        vocab_size=128, num_experts=4, num_experts_per_tok=2,
        moe_intermediate_size=64)
    moe = models.Qwen3MoE(moe_cfg, mode="xla", dtype="float32", device="cpu",
                          num_ranks=2)
    # an n-rank MoE serves at tp_ranks=n (tests/test_torch_moe_serve_nrank.py
    # holds it to JAX)
    assert models.ServeEngine(moe, None, **kw, tp_ranks=2).stats()[
        "tp_ranks"] == 2
    # tp_ranks defaults to 1 over an n-rank model, as in JAX: no ledgers
    se = models.ServeEngine(m2, p2, **kw)
    assert se.stats()["tp_ranks"] == 1 and se.stats()["per_rank"] == []
