"""ServeEngine(mode="megakernel") of the port (megakernel/serve.py
MegaServe behind models/serve.py) against the JAX package's engine-mode
ServeEngine and the port's own engine mode, on the CPU.

The stream is the JAX package's megakernel serving test's: three
requests through two slots (a mid-stream finish and re-admission),
32-token pages, 4-token prefill chunks, on the shrunken tiny Qwen3 in
f32 with the same weights. On the CPU the megakernel program runs its
plain queue walk over the same descriptors and queues the CUDA kernel
walks. Greedy tokens must be identical to the JAX engine's and to the
port's engine mode; an int8 pool's megakernel tokens identical to the
port's int8 engine mode (the same pool bits, the same dequantization);
a sampled stream identical to the engine mode's for the same seed. The
JAX megakernel itself (interpret-mode Pallas) is not run here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from triton_distributed_tpu.models import DenseLLM as JaxDenseLLM
from triton_distributed_tpu.models import ServeEngine as JaxServeEngine
from triton_distributed_tpu.models import config as jax_config
from triton_distributed_tpu_torch import models
from triton_distributed_tpu_torch.models import serve as tserve

NAME = "Qwen/Qwen3-0.6B"
SHRINK = dict(hidden_size=64, intermediate_size=96, num_heads=4,
              num_kv_heads=2, head_dim=16, vocab_size=128)
KW = dict(b_max=2, max_len=64, block=32, prefill_chunk=4)


def _reqs():
    rng = np.random.default_rng(5)
    return [(rng.integers(0, 128, s).astype(np.int32), g)
            for s, g in ((7, 4), (3, 2), (10, 3))]


@pytest.fixture(scope="module")
def pair():
    """The JAX engine's greedy tokens, and the port's model on the same
    weights."""
    mesh1 = Mesh(np.asarray(jax.devices()[:1]), ("tp",))
    jm = JaxDenseLLM(jax_config.get_config(NAME).tiny(**SHRINK), mesh=mesh1,
                     mode="xla", dtype=jnp.float32)
    jp = jm.init_params(jax.random.PRNGKey(0))
    jse = JaxServeEngine(jm, jp, attn_method="xla", **KW)
    rids = [jse.submit(p, g) for p, g in _reqs()]
    out = jse.run()
    ref = [np.asarray(out[r]) for r in rids]
    pm = models.DenseLLM(models.get_config(NAME).tiny(**SHRINK), mode="xla",
                         dtype="float32", device="cpu")
    return ref, pm, models.params_from_jax(jax.device_get(jp), device="cpu")


def _serve(model, params, stream_cb=None, **kw):
    se = models.ServeEngine(model, params, **KW, **kw)
    rids = [se.submit(p, g) for p, g in _reqs()]
    out = se.run(stream_cb=stream_cb)
    return se, {r: out[r] for r in rids}


def test_megakernel_greedy_matches_jax_and_engine(pair):
    ref, pm, pp = pair
    _, eng = _serve(pm, pp)
    stream = []
    se, mk = _serve(pm, pp, mode="megakernel",
                    stream_cb=lambda rid, tok, i: stream.append((rid, i)))
    _, mk8 = _serve(pm, pp, mode="megakernel", mk_opts={"slot_rows": 8})
    for r, want in enumerate(ref):
        np.testing.assert_array_equal(mk[r], want)
        np.testing.assert_array_equal(mk8[r], want)   # 7 pad rows a slot
        np.testing.assert_array_equal(eng[r], want)
    st = se.stats()
    # every decode tick took the megakernel, through the one program
    assert st["mode"] == "megakernel"
    assert st["megakernel_steps"] == st["decode_steps"] > 0
    assert se.trace_counts == {"decode": 1, "prefill": 0, "verify": 0}
    assert (st["tp_ranks"], st["per_rank"]) == (1, [])
    # per-slot streaming delivered every token in order
    assert len(stream) == sum(g for _, g in _reqs())
    for rid in mk:
        idxs = [i for r, i in stream if r == rid]
        assert idxs == list(range(len(idxs)))
    # reentrant: a second run starts from empty pools
    for p, g in _reqs()[:2]:
        se.submit(p, g)
    again = se.run()
    np.testing.assert_array_equal(again[3], ref[0])
    np.testing.assert_array_equal(again[4], ref[1])


def test_int8_pool_megakernel_equals_int8_engine(pair):
    _, pm, pp = pair
    _, eng = _serve(pm, pp, kv_dtype="int8")
    se, mk = _serve(pm, pp, mode="megakernel", kv_dtype="int8")
    rep = tserve.banded_token_identity(eng, mk)       # no band: exact
    assert rep["agreed_frac"] == 1.0
    assert se.stats()["megakernel_steps"] > 0


def test_sampled_stream_equals_engine(pair):
    _, pm, pp = pair
    kw = dict(temperature=0.9, top_k=5, seed=11)
    _, eng = _serve(pm, pp, **kw)
    _, mk = _serve(pm, pp, mode="megakernel", **kw)
    for r in eng:
        np.testing.assert_array_equal(mk[r], eng[r])
    _, greedy = _serve(pm, pp)
    assert any(not np.array_equal(mk[r], greedy[r]) for r in mk)


def test_megakernel_slots_retain_only_prefill_blocks(pair):
    """A 9-token prompt generating 9 tokens at 4-token pages: the engine
    path caches every full block of computed rows (4), a megakernel slot
    only the 2 its prefill wrote (its decode rows live in the
    megakernel's pool). A second request with the same prompt hits the
    engine's cache but plans fresh on the megakernel path."""
    _, pm, pp = pair
    prompt = np.arange(9, dtype=np.int32) * 7 % 128
    got = {}
    for mode in ("engine", "megakernel"):
        se = models.ServeEngine(pm, pp, b_max=1, max_len=32, block=4,
                                prefill_chunk=4, mode=mode)
        se.submit(prompt, 9)
        se.submit(prompt, 9)              # admitted when the first ends
        out = se.run()
        np.testing.assert_array_equal(out[1], out[0])
        st = se.stats()
        got[mode] = (out[0], st["cached_free_blocks"],
                     st["prefix_hit_blocks"])
    assert got["engine"][1:] == (4, 2)
    assert got["megakernel"][1:] == (2, 0)
    np.testing.assert_array_equal(got["megakernel"][0], got["engine"][0])


def test_megakernel_mode_arguments(pair):
    _, pm, pp = pair
    with pytest.raises(ValueError, match="mk_opts"):
        models.ServeEngine(pm, pp, mk_opts={"slot_rows": 8})
    with pytest.raises(ValueError, match="'megakernel'"):
        models.ServeEngine(pm, pp, mode="pallas")
    se = models.ServeEngine(pm, pp, mode="megakernel",
                            mk_opts={"slot_rows": 8}, **KW)
    assert se._mk.prog.inputs["x"].shape == (2 * 8, SHRINK["hidden_size"])
    with pytest.raises(TypeError):
        models.ServeEngine(pm, pp, mode="megakernel", mk_opts={"tile_m": 8})
