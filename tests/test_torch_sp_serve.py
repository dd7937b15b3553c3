"""The port's sequence-parallel serving (ServeEngine over
DenseLLM(num_ranks=4, attn_parallelism="sp", sp_combine="xla" | "ll"))
against the JAX package's SP ServeEngine on a 4-device CPU mesh, f32, with
the weights of the JAX suite's `sp_tiny_models` and the 5-request stream
of its `test_serve_sp_matches_tp_e2e` (prompts crossing the ranks'
ownership boundaries at 8 tokens a rank, two slots reused):

- greedy tokens, the stream's order, and after every tick the block
  table, lengths and free count equal to the JAX engine's, under both
  combines; then, as the JAX test does, the `num_blocks=8` backpressure
  run (2 blocks a rank partition: grants refused, admissions serialized)
  gives the same tokens, with `check_conservation_sp` after it;
- `params_from_jax(..., attn_parallelism="sp")` carries every leaf
  exactly (the trunk replicated, the lm_head vocab-sharded);
- the constructor guards of the JAX suite's `test_serve_sp_mode_guards`
  with its ValueErrors, and the refusals of what "sp" does not have.

The JAX engines run once, in a module fixture; their attention kernels
run in the plain Pallas interpreter (they hold no DMA or semaphore; under
the TPU interpreter the ring-attention prefill of this stream takes over a
minute on a CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from triton_distributed_tpu import runtime as jruntime
from triton_distributed_tpu.models import DenseLLM as JaxDenseLLM
from triton_distributed_tpu.models import ServeEngine as JaxServeEngine
from triton_distributed_tpu.models import config as jax_config
from triton_distributed_tpu.ops import attention as jattn
from triton_distributed_tpu_torch import models
from triton_distributed_tpu_torch.models import dense as tdense
from triton_distributed_tpu_torch.parallel import unshard

N = 4
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


def _cfg(pkg):
    return pkg.get_config("Qwen/Qwen3-0.6B").tiny()


def _stream(vocab):
    rng = np.random.default_rng(5)
    return [(rng.integers(0, vocab, s).astype(np.int32), g)
            for s, g in SHAPES]


def _drive(se, reqs):
    """Submit, run, and record (table, lengths, free blocks) after every
    tick and the (request, index) order of the stream. Returns
    ({submission index: tokens}, ticks, stream order)."""
    rids = [se.submit(p, g) for p, g in reqs]
    ticks, order = [], []
    cls_tick = type(se)._tick

    def tick(stream_cb=None):
        cls_tick(se, stream_cb)
        c = se._cache
        ticks.append((np.asarray(c.block_table).copy(),
                      np.asarray(c.seq_lens).copy(),
                      se.stats()["free_blocks"]))

    se._tick = tick
    out = se.run(stream_cb=lambda rid, tok, i: order.append(
        (rids.index(rid), i)))
    del se._tick
    return ({i: np.asarray(out[r]).tolist() for i, r in enumerate(rids)},
            ticks, order)


@pytest.fixture(scope="module")
def jax_sp():
    cfg = _cfg(jax_config)
    mesh = Mesh(np.asarray(jax.devices()[:N]), ("tp",))
    m = JaxDenseLLM(cfg, mesh=mesh, mode="ar", dtype=jnp.float32,
                    attn_parallelism="sp")
    p = m.init_params(jax.random.PRNGKey(0))
    reqs = _stream(cfg.vocab_size)
    se = JaxServeEngine(m, p, **KW, attn_method="xla")
    assert se.sched.cfg.sp_ranks == N
    return jax.device_get(p), reqs, _drive(se, reqs)


def _port(params, combine):
    model = models.DenseLLM(_cfg(models), mode="ar", dtype="float32",
                            device="cpu", num_ranks=N,
                            attn_parallelism="sp", sp_combine=combine)
    return model, models.params_from_jax(params, device="cpu", num_ranks=N,
                                         attn_parallelism="sp")


def _same_ticks(a, b):
    assert len(a) == len(b)
    for (ta, la, fa), (tb, lb, fb) in zip(a, b):
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(la, lb)
        assert fa == fb


@pytest.mark.parametrize("combine", ["xla", "ll"])
def test_sp_serve_equals_jax_sp_engine(jax_sp, combine):
    jp, reqs, (jtoks, jticks, jorder) = jax_sp
    model, params = _port(jp, combine)
    se = models.ServeEngine(model, params, **KW)
    assert se.attn_parallelism == "sp" and se.sp_combine == combine
    assert se.sched.cfg.sp_ranks == N and not se.sched.cfg.prefix_caching
    toks, ticks, order = _drive(se, reqs)
    assert toks == jtoks and order == jorder
    assert len(order) == sum(g for _, g in SHAPES)
    _same_ticks(ticks, jticks)
    se._cache.check_conservation_sp(N)
    # per-rank backpressure: 2 blocks a partition serialize the admissions
    se2 = models.ServeEngine(model, params, **KW, num_blocks=8)
    toks2, _, _ = _drive(se2, reqs[:2])
    assert toks2 == {i: jtoks[i] for i in range(2)}
    assert se2.stats()["grant_refusals"] > 0
    se2._cache.check_conservation_sp(N)


def test_sp_params_from_jax_carries_every_leaf_exactly(jax_sp):
    jp = jax_sp[0]
    tp = models.params_from_jax(jp, device="cpu", num_ranks=N,
                                attn_parallelism="sp")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    specs = tdense.SP_PARAM_SPECS
    assert len(flat) == 3 + 8
    for path, leaf in flat:
        keys = [k.key for k in path]
        got, spec = tp, specs
        for k in keys:
            got, spec = got[k], spec[k]
        if spec is not None:
            got = unshard(got, spec, at=0)
        assert got.shape == leaf.shape, keys
        np.testing.assert_array_equal(got.numpy(), leaf)
    # the same draw, re-laid by the port's own shard_params, is the model
    model, _ = _port(jp, "xla")
    assert model.param_specs() is specs


def test_sp_mode_guards():
    """JAX test_serve_sp_mode_guards, with its errors; the paths "sp"
    does not have raise."""
    cfg = _cfg(models)
    sp = models.DenseLLM(cfg, mode="ar", dtype="float32", device="cpu",
                         num_ranks=N, attn_parallelism="sp")
    tp = models.DenseLLM(cfg, mode="ar", dtype="float32", device="cpu",
                         num_ranks=N)
    params = None
    with pytest.raises(ValueError, match="does not split over"):
        models.ServeEngine(sp, params, b_max=2, max_len=30, block=4)
    with pytest.raises(ValueError, match="does not split"):
        models.ServeEngine(sp, params, b_max=2, max_len=32, block=4,
                           prefill_chunk=6)
    for feature in (dict(prefix_cache=True), dict(speculative=True),
                    dict(mode="megakernel")):
        with pytest.raises(ValueError, match="tp-only"):
            models.ServeEngine(sp, params, **KW, **feature)
    with pytest.raises(ValueError, match="rebuild the model"):
        models.ServeEngine(tp, params, **KW, attn_parallelism="sp")
    with pytest.raises(ValueError, match="compiled into"):
        models.ServeEngine(sp, params, **KW, sp_combine="ll")
    assert models.ServeEngine(sp, params, **KW,
                              attn_parallelism="sp").sp_combine == "xla"
    with pytest.raises(ValueError, match="attn_parallelism"):
        models.DenseLLM(cfg, device="cpu", attn_parallelism="dp")
    with pytest.raises(ValueError, match="combine"):
        models.DenseLLM(cfg, device="cpu", num_ranks=N,
                        attn_parallelism="sp", sp_combine="ring")
    # the sequence-sharded pool stores the model dtype only, as in JAX
    se = models.ServeEngine(sp, params, **KW, kv_dtype="int8")
    with pytest.raises(ValueError, match="does not compose"):
        se.run()
    cache = sp.new_paged_kv_cache(2, 32, block=4)
    assert cache.sp_ranks == N and cache.k_pool.shape[1] == 16
    for call, match in (
            (lambda: sp.prefill(None, np.zeros((1, 4), np.int32),
                                sp.new_kv_cache(1, 8)), "only the paged"),
            (lambda: sp.decode_step(None, [0], sp.new_kv_cache(1, 8)),
             "only the paged"),
            (lambda: sp.verify_step_paged(None, [[0]], cache, [True], [1]),
             "speculative decoding"),
            (lambda: sp.prefill_chunk_paged(None, np.zeros(4, np.int32),
                                            cache, 0, 6, 4), "crosses")):
        with pytest.raises(ValueError, match=match):
            call()
    with pytest.raises(NotImplementedError, match="off-path modules"):
        cache.truncate_slot(0, 0, sp_ranks=N)
