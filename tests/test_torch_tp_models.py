"""The port's tensor-parallel dense model (DenseLLM(num_ranks=n) behind
Engine) against the JAX package's on a 2- and a 4-device CPU mesh: weights
carried across and loaded from a state dict at n ranks, greedy tokens in
all four modes, tokens equal to the one-rank port's, sampling, the
greedy tie rule, and the refusals of what stays one-rank.

The JAX Engine runs once per n, in the modes whose collectives are XLA's
("xla" at n = 2, "ar" at n = 4; the JAX suite holds "fused" and
"gemm_ar" to them, tests/test_models.py). The port runs all four modes at
both n on the same weights (params_from_jax). Greedy tokens must be equal
in f32. The prompt length (11) divides by neither n, and Engine's bucket
is clamped to it (max_len = S + GEN), so the sequence-sharded modes pad it
to a multiple of n as the JAX prefill does.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_distributed_tpu.models import DenseLLM as JaxDenseLLM
from triton_distributed_tpu.models import Engine as JaxEngine
from triton_distributed_tpu.models import config as jax_config
from triton_distributed_tpu_torch import models
from triton_distributed_tpu_torch.layers import common as tcommon
from triton_distributed_tpu_torch.models import dense as tdense
from triton_distributed_tpu_torch.ops import _common
from triton_distributed_tpu_torch.parallel import unshard

NAME = "Qwen/Qwen3-8B"                     # untied lm_head, qk-norm
SHRINK = dict(hidden_size=64, num_heads=8, num_kv_heads=4, head_dim=16,
              vocab_size=128, intermediate_size=128)
B, S, GEN = 2, 11, 6
MAX_LEN = S + GEN                          # the bucket clamps to S
JAX_MODE = {2: "xla", 4: "ar"}
MODES = ("xla", "fused", "ar", "gemm_ar")


def _cfg(pkg):
    return pkg.get_config(NAME).tiny(**SHRINK)


def _ids(seed=0):
    return np.random.RandomState(seed).randint(0, SHRINK["vocab_size"],
                                               (B, S))


def _global(t, spec, layer):
    """The port's rank-stacked leaf back in the JAX array's layout."""
    return t if spec is None else unshard(t, spec, at=1 if layer else 0)


@pytest.fixture(scope="module")
def jax_runs():
    """Per n: the JAX model's params (numpy) and its Engine's tokens."""
    out = {}
    for n, mode in JAX_MODE.items():
        mesh = Mesh(np.asarray(jax.devices()[:n]), ("tp",))
        m = JaxDenseLLM(_cfg(jax_config), mesh=mesh, mode=mode,
                        dtype=jnp.float32)
        p = m.init_params(jax.random.PRNGKey(0))
        toks = JaxEngine(m, p, max_len=MAX_LEN).serve(_ids(), GEN)
        out[n] = (jax.device_get(p), np.asarray(toks), m)
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_params_from_jax_carries_every_leaf_exactly(jax_runs, n):
    jp, _, _ = jax_runs[n]
    tp = models.params_from_jax(jp, device="cpu", num_ranks=n)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == 3 + 8
    specs = tdense.PARAM_SPECS
    for path, leaf in flat:
        keys = [k.key for k in path]
        got, spec = tp, specs
        for k in keys:
            got, spec = got[k], spec[k]
        if spec is not None:
            assert got.shape[1 if keys[0] == "layers" else 0] == n
        np.testing.assert_array_equal(
            _global(got, spec, keys[0] == "layers").numpy(), leaf)


def _hf_state_dict(cfg, seed=0):
    rng = np.random.RandomState(seed)
    H, D, inter = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    sd = {"model.embed_tokens.weight": w(cfg.vocab_size, H),
          "model.norm.weight": 1 + 0.1 * w(H),
          "lm_head.weight": w(cfg.vocab_size, H)}
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        sd[pre + "input_layernorm.weight"] = 1 + 0.1 * w(H)
        sd[pre + "post_attention_layernorm.weight"] = 1 + 0.1 * w(H)
        sd[pre + "self_attn.q_proj.weight"] = w(cfg.num_heads * D, H)
        sd[pre + "self_attn.k_proj.weight"] = w(cfg.num_kv_heads * D, H)
        sd[pre + "self_attn.v_proj.weight"] = w(cfg.num_kv_heads * D, H)
        sd[pre + "self_attn.o_proj.weight"] = w(H, cfg.num_heads * D)
        sd[pre + "self_attn.q_norm.weight"] = 1 + 0.1 * w(D)
        sd[pre + "self_attn.k_norm.weight"] = 1 + 0.1 * w(D)
        sd[pre + "mlp.gate_proj.weight"] = w(inter, H)
        sd[pre + "mlp.up_proj.weight"] = w(inter, H)
        sd[pre + "mlp.down_proj.weight"] = w(H, inter)
    return sd


@pytest.mark.parametrize("n", [2, 4])
def test_load_state_dict_at_n_ranks_equals_jax(jax_runs, n):
    jm = jax_runs[n][2]
    sd = _hf_state_dict(_cfg(models))
    want = jax.device_get(jm.load_state_dict(sd))
    got = models.DenseLLM(_cfg(models), dtype="float32", device="cpu",
                          num_ranks=n).load_state_dict(sd)
    specs = tdense.PARAM_SPECS
    for k in ("embed", "norm", "lm_head"):
        np.testing.assert_array_equal(
            _global(got[k], specs[k], False).numpy(), want[k])
    for k, leaf in want["layers"].items():
        np.testing.assert_array_equal(
            _global(got["layers"][k], specs["layers"][k], True).numpy(), leaf)


@pytest.mark.parametrize("n", [2, 4])
def test_engine_tokens_in_every_mode_equal_jax(jax_runs, n):
    """All four port modes at n ranks against the JAX Engine's tokens (f32
    greedy), through Engine.serve and through start + step; the fused
    modes go through their ops' kernel path (the plain versions here)."""
    jp, want, _ = jax_runs[n]
    params = models.params_from_jax(jp, device="cpu", num_ranks=n)
    for mode in MODES:
        model = models.DenseLLM(_cfg(models), mode=mode, dtype="float32",
                                device="cpu", num_ranks=n)
        eng = models.Engine(model, params, max_len=MAX_LEN)
        _common.reset_dispatch()
        got = eng.serve(_ids(), GEN)
        np.testing.assert_array_equal(got, want, err_msg=f"{mode} at {n}")
        log = _common.dispatch_counts()
        L = model.config.num_layers
        kernel = {"fused": {("ag_gemm", "kernel", ""): 2 * L,
                            ("gemm_rs", "kernel", ""): 2 * L},
                  "gemm_ar": {("gemm_ar", "kernel", ""): 2 * L * GEN}}
        assert log == kernel.get(mode, {}), (mode, log)
        tok, cache = eng.start(_ids()[:, :S])
        assert cache.k.shape[1] == n and cache.k.shape[4] == 4 // n
        steps = [tok]
        for _ in range(GEN - 1):
            tok, cache = eng.step(tok, cache)
            steps.append(tok)
        assert tok.shape == (B,)
        np.testing.assert_array_equal(torch.stack(steps, 1).numpy(), want)


@pytest.mark.parametrize("n", [2, 4])
def test_n_rank_port_equals_one_rank_port(n):
    """init_params draws the same logical model at every n: the n-rank
    tokens equal the one-rank port's, in a sequence-sharded and a
    replicated mode."""
    ids = _ids(1)
    one = models.DenseLLM(_cfg(models), mode="xla", dtype="float32",
                          device="cpu")
    want = models.Engine(one, one.init_params(
        torch.Generator().manual_seed(3)), max_len=MAX_LEN).serve(ids, GEN)
    for mode in ("fused", "gemm_ar"):
        m = models.DenseLLM(_cfg(models), mode=mode, dtype="float32",
                            device="cpu", num_ranks=n)
        p = m.init_params(torch.Generator().manual_seed(3))
        got = models.Engine(m, p, max_len=MAX_LEN).serve(ids, GEN)
        np.testing.assert_array_equal(got, want, err_msg=mode)


def test_sampling_at_n_ranks_is_seeded_and_legal(jax_runs):
    jp, _, _ = jax_runs[2]
    params = models.params_from_jax(jp, device="cpu", num_ranks=2)
    m = models.DenseLLM(_cfg(models), mode="fused", dtype="float32",
                        device="cpu", num_ranks=2)
    eng = models.Engine(m, params, max_len=MAX_LEN)
    a = eng.serve(_ids(), GEN, temperature=0.9, top_k=5, seed=7)
    b = eng.serve(_ids(), GEN, temperature=0.9, top_k=5, seed=7)
    assert a.shape == (B, GEN) and a.dtype == np.int32
    assert ((a >= 0) & (a < SHRINK["vocab_size"])).all()
    np.testing.assert_array_equal(a, b)
    # top_k 1 is greedy whatever the noise
    greedy = eng.serve(_ids(), GEN)
    np.testing.assert_array_equal(
        eng.serve(_ids(), GEN, temperature=0.9, top_k=1, seed=1), greedy)


def test_greedy_token_ranks_lowest_rank_wins_ties():
    """Per-rank (max, argmax) pairs: the global argmax, a tie going to the
    lowest rank (the first maximum of the full row)."""
    x = torch.tensor([[2.0, 0.0],               # ranks tie at 2.0
                      [0.0, 0.0],               # every logit ties at 0
                      [0.0, 3.0]])              # rank 1's column 7 wins
    lm = torch.zeros(2, 2, 8)                   # (n, hidden, V / n)
    lm[0, 0, 5] = lm[1, 0, 2] = lm[1, 1, 7] = 1.0
    got = tdense.greedy_token(x, lm)
    full = torch.cat(list(lm), dim=1)           # (hidden, V)
    assert torch.equal(got, torch.argmax(x @ full, -1).to(torch.int32))
    assert got.tolist() == [5, 0, 15]


def test_what_stays_one_rank_raises_naming_its_slice():
    """The paged paths build at n ranks now (slice 6b): a head-sharded
    pool, one prefill chunk and one decode step giving the one-rank
    model's tokens, and a ServeEngine. Slice 6e retired the last two
    refusals here: an n-rank Qwen3MoE behind ServeEngine builds (EP and TP
    experts; tests/test_torch_moe_serve_nrank.py holds it to JAX), and
    row_parallel_out takes a quantized wire, "fused" through the gemm_rs
    quant arm and "ar" through quant_psum (tests/test_torch_wire_*.py);
    a model that does not split still raises."""
    cfg = _cfg(models)
    m1 = models.DenseLLM(cfg, dtype="float32", device="cpu")
    m = models.DenseLLM(cfg, dtype="float32", device="cpu", num_ranks=2)
    p1 = m1.init_params(torch.Generator().manual_seed(0))
    p = m.shard_params(p1)
    toks = []
    for model, params in ((m1, p1), (m, p)):
        cache = model.new_paged_kv_cache(2, 32, block=8)
        assert cache.assign_slot(0, 2)
        tok, cache = model.prefill_chunk_paged(params, _ids()[0, :8], cache,
                                               0, 0, 8)
        nxt, cache = model.decode_step_paged(params, [int(tok), 0], cache,
                                             [True, False])
        pred, _ = model.verify_step_paged(params, [[int(nxt[0])], [0]],
                                          cache, [True, False], [1, 1])
        toks.append((int(tok), nxt.tolist(), pred.tolist()))
    assert toks[0] == toks[1]
    assert cache.k_pool.shape[:3] == (cfg.num_layers, 2, 8)
    assert models.ServeEngine(m, p, max_len=32, block=8).stats()[
        "tp_ranks"] == 1
    moe_cfg = models.get_config("Qwen/Qwen3-30B-A3B").tiny(
        hidden_size=64, num_heads=8, num_kv_heads=4, head_dim=16,
        vocab_size=128, moe_intermediate_size=32)
    for par in ("tp", "ep"):
        se = models.ServeEngine(models.Qwen3MoE(
            moe_cfg, dtype="float32", device="cpu", num_ranks=2,
            moe_parallel=par), None, tp_ranks=2)
        assert se.stats()["tp_ranks"] == 2
    from triton_distributed_tpu_torch.ops import gemm_rs, wire
    g = torch.Generator().manual_seed(0)
    rows, w = torch.randn(2, 4, 8, generator=g), torch.randn(2, 8, 16,
                                                             generator=g)
    assert torch.equal(
        tcommon.row_parallel_out(rows, w, mode="fused", num_ranks=2,
                                 wire_dtype="int8"),
        gemm_rs._gemm_rs_quant_plain(rows, w, "int8", 16))
    assert torch.equal(
        tcommon.row_parallel_out(rows, w, mode="ar", num_ranks=2,
                                 wire_dtype="int8"),
        wire.quant_psum(rows @ w, "int8"))
    with pytest.raises(ValueError, match="split"):
        models.DenseLLM(_cfg(models), device="cpu", num_ranks=8)


@pytest.mark.parametrize("n", [1, 2])
def test_engine_checks_faults_before_tokens_leave(monkeypatch, n):
    """serve, start and step read the communication kernels' fault words
    (shmem.check_faults) before they hand tokens back, at n > 1 ranks
    only; a fault there raises instead of returning a token."""
    from triton_distributed_tpu_torch.models import engine as tengine
    calls = []
    monkeypatch.setattr(tengine, "check_faults", lambda: calls.append(1))
    m = models.DenseLLM(_cfg(models), mode="gemm_ar", dtype="float32",
                        device="cpu", num_ranks=n)
    eng = models.Engine(m, m.init_params(torch.Generator().manual_seed(0)),
                        max_len=MAX_LEN)
    tok, cache = eng.start(_ids())
    tok, cache = eng.step(tok, cache)
    eng.serve(_ids(), 2)
    assert len(calls) == (3 if n > 1 else 0)

    def fault():
        raise RuntimeError("gemm_ar: rank 1 timed out")

    monkeypatch.setattr(tengine, "check_faults", fault)
    with pytest.raises(RuntimeError, match="timed out") if n > 1 else \
            contextlib.nullcontext():
        eng.step(tok, cache)
