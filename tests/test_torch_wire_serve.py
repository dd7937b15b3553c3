"""The paged shards of the port's TPAttn and TPMLP with a quantized wire
(decode, verify and the prefill chunk over the head-sharded pool, their
epilogues through layers/common.row_parallel_out) against the JAX
package's, on the CPU, f32, at n 2 and 4: `ServeEngine(tp_ranks=n)` over a
DenseLLM whose layers carry an int8 wire, in modes "ar" (`quant_psum`)
and "gemm_ar" (the gemm_ar quant arm's plain version), against the JAX
ServeEngine over the same model and wire in mode "ar". In f32 the two
port modes quantize the same values (rounding an f32 partial to f32
changes nothing), so both must give the JAX engine's greedy tokens, block
tables and lengths tick by tick, and its rank ledgers; at n 2 speculation
(an oracle drafter with accepts and rejects) runs the verify shard. The
models take no wire knob, in either package: the test sets the layers'
`wire_dtype` on both. The JAX engines run once a process per n, when a
test first needs them; their attention kernels run in the plain Pallas
interpreter.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from triton_distributed_tpu import runtime as jruntime
from triton_distributed_tpu.models import DenseLLM as JaxDenseLLM
from triton_distributed_tpu.models import OracleDrafter as JaxOracle
from triton_distributed_tpu.models import ServeEngine as JaxServeEngine
from triton_distributed_tpu.models import SpecConfig as JaxSpecConfig
from triton_distributed_tpu.models import config as jax_config
from triton_distributed_tpu.ops import attention as jattn
from triton_distributed_tpu_torch import models
from triton_distributed_tpu_torch.ops import _common


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


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("tp",))


SHRINK = dict(hidden_size=64, intermediate_size=96, num_heads=4,
              num_kv_heads=4, head_dim=16, vocab_size=128)
KW = dict(b_max=2, max_len=32, block=4, prefill_chunk=4)
SHAPES = ((7, 4), (3, 2), (10, 5), (5, 3))


def _stream():
    rng = np.random.default_rng(5)
    return [(rng.integers(0, SHRINK["vocab_size"], s).astype(np.int32), g)
            for s, g in SHAPES]


def _wired(model, wd):
    """The model's layers with a quantized wire on their epilogues."""
    model.attn.wire_dtype = wd
    model.mlp.wire_dtype = wd
    return model


def _drive(se, spec_targets=None):
    rids = [se.submit(p, g) for p, g in _stream()]
    if spec_targets is not None:
        d = se.spec.drafter
        d.targets = {r: np.asarray(spec_targets[i])
                     for i, r in enumerate(rids)}
        d.prompts = {r: int(p.size) for r, (p, _) in zip(rids, _stream())}
    tables = []
    cls_tick = type(se)._tick

    def tick(stream_cb=None):
        cls_tick(se, stream_cb)
        tables.append((np.asarray(se._cache.block_table).copy(),
                       np.asarray(se._cache.seq_lens).copy()))

    se._tick = tick
    out = se.run()
    del se._tick
    return ({i: np.asarray(out[r]).tolist() for i, r in enumerate(rids)},
            tables, se.stats())


def _spec(pkg_oracle):
    return pkg_oracle({}, {}, wrong_every=2, vocab=SHRINK["vocab_size"])


@functools.lru_cache(maxsize=None)
def _jax_paged(n):
    """The JAX params (numpy) and its wired ServeEngine run at n ranks; at
    n 2 also the speculative run. Once a process per n."""
    cfg = jax_config.get_config("Qwen/Qwen3-8B").tiny(**SHRINK)
    m = _wired(JaxDenseLLM(cfg, mesh=_mesh(n), mode="ar",
                           dtype=jnp.float32), "int8")
    p = m.init_params(jax.random.PRNGKey(n))
    run = _drive(JaxServeEngine(m, p, **KW, attn_method="xla", tp_ranks=n))
    out = {"params": jax.device_get(p), "run": run}
    if n == 2:
        se = JaxServeEngine(m, p, **KW, attn_method="xla", tp_ranks=2,
                            speculative=JaxSpecConfig(
                                drafter=_spec(JaxOracle), k=3, adapt=False))
        out["spec"] = _drive(se, run[0])
    return out


@pytest.mark.parametrize("n,mode", [(2, "ar"), (2, "gemm_ar"), (4, "ar"),
                                    (4, "gemm_ar")])
def test_paged_shards_with_a_wire_equal_jax(n, mode):
    jax_paged = {n: _jax_paged(n)}
    cfg = models.get_config("Qwen/Qwen3-8B").tiny(**SHRINK)
    model = _wired(models.DenseLLM(cfg, mode=mode, dtype="float32",
                                   device="cpu", num_ranks=n), "int8")
    params = models.params_from_jax(jax_paged[n]["params"], device="cpu",
                                    num_ranks=n)
    _common.reset_dispatch()
    toks, tables, st = _drive(models.ServeEngine(model, params, **KW,
                                                 tp_ranks=n))
    jtoks, jtables, jst = jax_paged[n]["run"]
    assert toks == jtoks
    assert len(tables) == len(jtables)
    for (t, lens), (jt, jlens) in zip(tables, jtables):
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(lens, jlens)
    assert st["per_rank"] == jst["per_rank"]
    log = _common.dispatch_counts()
    # two wired epilogues a layer a step (o and down), each one quant arm
    # launch in "gemm_ar"; "ar" quantizes through quant_psum (no op logged)
    steps = st["decode_steps"] + st["prefill_chunks"]
    if mode == "gemm_ar":
        assert log == {("gemm_ar", "kernel", "wire"):
                       2 * cfg.num_layers * steps}
    else:
        assert log == {}
    if n == 2:
        se = models.ServeEngine(
            model, params, **KW, tp_ranks=2,
            speculative=models.SpecConfig(drafter=_spec(models.OracleDrafter),
                                          k=3, adapt=False))
        stoks, _, sst = _drive(se, toks)
        jstoks, _, jsst = jax_paged[n]["spec"]
        assert stoks == jstoks == toks
        assert sst["spec_accepted"] > 0 and sst["spec_rejected"] > 0
        for key in ("spec_accepted", "spec_rejected", "ticks"):
            assert sst[key] == jsst[key], key
