"""Speculative decoding on the port's megakernel tensor-parallel serving
(`ServeEngine(DenseLLM(num_ranks=2), tp_ranks=2, mode="megakernel",
speculative=...)`: MegaServe.verify at n ranks, one launch of both ranks'
programs a verify tick) against the JAX package's engine-mode
ServeEngine(tp_ranks=2) with the same oracle drafter, f32, on a 2-device
CPU mesh, over the 5-request stream of tests/test_torch_tp_serve.py with
prefix caching off (as tests/test_torch_mega_tp_serve.py):

- at slot_rows 64, where no page room ever clamps a width (max_len 32),
  the ticks are the JAX spec engine's: tokens and spec counters equal;
- at the default slot_rows 8 (JAX's f32 tile), every width keeps JAX's
  page-room rule (tile_m - cache_len % tile_m) and the tokens stay the
  spec-off tokens.

The JAX engines run once, in a module fixture; their attention kernels
run in the plain Pallas interpreter (no DMA or semaphore in them).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from triton_distributed_tpu import runtime as jruntime
from triton_distributed_tpu.megakernel.serve import MegaServe as JaxMegaServe
from triton_distributed_tpu.models import DenseLLM as JaxDenseLLM
from triton_distributed_tpu.models import OracleDrafter as JaxOracle
from triton_distributed_tpu.models import ServeEngine as JaxServeEngine
from triton_distributed_tpu.models import SpecConfig as JaxSpecConfig
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
    """The JAX params (numpy), the engine-mode ServeEngine(tp_ranks=2)'s
    spec-off tokens and its speculative run."""
    cfg = jax_config.get_config("Qwen/Qwen3-8B").tiny(**TP_SHRINK)
    reqs = _stream(cfg.vocab_size)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("tp",))
    m = JaxDenseLLM(cfg, mesh=mesh, mode="ar", dtype=jnp.float32)
    p = m.init_params(jax.random.PRNGKey(0))
    se = JaxServeEngine(m, p, **KW, attn_method="xla", tp_ranks=2)
    rids = [se.submit(q, g) for q, g in reqs]
    out = se.run()
    off = {i: np.asarray(out[r]).tolist() for i, r in enumerate(rids)}
    spec = JaxServeEngine(
        m, p, **KW, attn_method="xla", tp_ranks=2,
        speculative=JaxSpecConfig(drafter=_oracle(JaxOracle), k=3,
                                  adapt=False))
    return reqs, {2: {"params": jax.device_get(p), "off": off,
                      "spec": _spec_drive(spec, reqs, off)}}


def _port(jx, n, **kw):
    cfg = models.get_config("Qwen/Qwen3-8B").tiny(**TP_SHRINK)
    model = models.DenseLLM(cfg, mode="ar", dtype="float32", device="cpu",
                            num_ranks=n)
    params = models.params_from_jax(jx[n]["params"], device="cpu",
                                    num_ranks=n)
    return models.ServeEngine(model, params, **KW, tp_ranks=n,
                              mode="megakernel", **kw)


def test_megakernel_tp2_speculative_equals_jax(jax_tp):
    """At slot_rows 64 no page room clamps a width (max_len 32), so the
    ticks are the JAX spec engine's: tokens and spec counters equal. At
    the default slot_rows 8 the widths keep JAX's page-room rule and the
    tokens stay the spec-off tokens."""
    reqs, jx = jax_tp
    want = jx[2]["off"]
    for rows in (64, None):
        se = _port(jx, 2, mk_opts=None if rows is None else
                   {"slot_rows": rows},
                   speculative=models.SpecConfig(
                       drafter=_oracle(models.OracleDrafter), k=3,
                       adapt=False))
        rooms = []
        room = se._mk.page_room

        def spy_room(cl, room=room):
            rooms.append((int(cl), room(cl)))
            return rooms[-1][1]

        se._mk.page_room = spy_room
        toks, st = _spec_drive(se, reqs, want)
        assert toks == want
        assert st["spec_accepted"] > 0 and st["spec_rejected"] > 0, st
        assert st["megakernel_steps"] == st["decode_steps"]
        if rows == 64:
            jtoks, jst = jx[2]["spec"]
            assert toks == jtoks
            for key in ("spec_proposed", "spec_accepted", "spec_rejected",
                        "rollback_blocks", "ticks"):
                assert st[key] == jst[key], key
            assert all(r >= 3 for _, r in rooms)
        else:
            assert se._mk.slot_rows == tserve.SPEC_SLOT_ROWS == TILE_M
            jfake = types.SimpleNamespace(tm=TILE_M)
            assert rooms and all(r == JaxMegaServe.page_room(jfake, cl)
                                 for cl, r in rooms)
            assert any(r < 3 for _, r in rooms)
        assert all(r["ar_bytes_pushed"] == st["megakernel_steps"]
                   * se._mk.ar_bytes_per_step for r in st["per_rank"])
        se._cache.check_conservation()
