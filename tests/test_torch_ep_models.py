"""The port's multi-rank Qwen3-MoE (Engine(Qwen3MoE(cfg, num_ranks=n,
moe_parallel="ep" | "tp"))) against the JAX package's on a 4-device CPU
mesh, and its EP layer against its own golden.

The JAX Engine runs twice, in a module fixture, on one HF-named state dict:
expert-parallel (ep_method "xla"; the JAX suite holds "ragged" to it,
tests/test_ep_model.py:78) and tensor-parallel experts, both in mode
"xla" at n = 4, f32. Every port variant loads the same state dict and its
f32 greedy tokens must equal those: both layouts at n = 2 and 4 in all
four modes, EP with both transports and with ep_pipeline 1 and 2, and
the one-rank port (f32 greedy tokens are equal across rank counts). The
prompt length (11) divides by neither n, so the sequence-sharded modes
pad it as the JAX prefill does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_distributed_tpu.models import Engine as JaxEngine
from triton_distributed_tpu.models import config as jax_config
from triton_distributed_tpu.models.qwen_moe import Qwen3MoE as JaxQwen3MoE
from triton_distributed_tpu.ops.grouped_gemm import \
    GroupedGemmConfig as JaxGemmConfig
from triton_distributed_tpu.ops.moe_parallel import \
    MoEParallelConfig as JaxMoEConfig
from triton_distributed_tpu_torch import models
from triton_distributed_tpu_torch.layers.ep_moe import EPMoE
from triton_distributed_tpu_torch.models import qwen_moe as tqwen
from triton_distributed_tpu_torch.ops import _common
from triton_distributed_tpu_torch.ops import ep_a2a as tep
from triton_distributed_tpu_torch.ops.grouped_gemm import GroupedGemmConfig
from triton_distributed_tpu_torch.ops.moe_parallel import MoEParallelConfig
from triton_distributed_tpu_torch.parallel import unshard

NAME = "Qwen/Qwen3-30B-A3B"
SHRINK = dict(hidden_size=64, num_heads=8, num_kv_heads=4, head_dim=16,
              vocab_size=128, moe_intermediate_size=32, num_experts=8,
              num_layers=2)
B, S, GEN = 2, 11, 6
MAX_LEN = S + GEN
MODES = ("xla", "fused", "ar", "gemm_ar")


def _cfg(pkg):
    return pkg.get_config(NAME).tiny(**SHRINK)


def _ids(seed=0):
    return np.random.RandomState(seed).randint(0, SHRINK["vocab_size"],
                                               (B, S))


def _hf_state_dict(cfg, seed=0):
    """Random weights in HF naming, shared by every model here."""
    rng = np.random.default_rng(seed)
    H, D, I = cfg.hidden_size, cfg.head_dim, cfg.moe_intermediate_size

    def w(*shape, scale=0.2):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    sd = {"model.embed_tokens.weight": w(cfg.vocab_size, H),
          "model.norm.weight": 1 + w(H, scale=0.1),
          "lm_head.weight": w(cfg.vocab_size, H)}
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        sd[pre + "input_layernorm.weight"] = 1 + w(H, scale=0.1)
        sd[pre + "post_attention_layernorm.weight"] = 1 + w(H, scale=0.1)
        sd[pre + "self_attn.q_proj.weight"] = w(cfg.num_heads * D, H)
        sd[pre + "self_attn.k_proj.weight"] = w(cfg.num_kv_heads * D, H)
        sd[pre + "self_attn.v_proj.weight"] = w(cfg.num_kv_heads * D, H)
        sd[pre + "self_attn.o_proj.weight"] = w(H, cfg.num_heads * D)
        sd[pre + "self_attn.q_norm.weight"] = 1 + w(D, scale=0.1)
        sd[pre + "self_attn.k_norm.weight"] = 1 + w(D, scale=0.1)
        sd[pre + "mlp.gate.weight"] = w(cfg.num_experts, H, scale=0.5)
        for j in range(cfg.num_experts):
            sd[f"{pre}mlp.experts.{j}.gate_proj.weight"] = w(I, H)
            sd[f"{pre}mlp.experts.{j}.up_proj.weight"] = w(I, H)
            sd[f"{pre}mlp.experts.{j}.down_proj.weight"] = w(H, I)
    return sd


def _jax_moe_config():
    return JaxMoEConfig(gemm=JaxGemmConfig(block_m=8, use_xla=True))


def _port_moe_config():
    return MoEParallelConfig(gemm=GroupedGemmConfig(block_m=8))


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX Engine's tokens at n = 4, mode "xla", f32, for EP (xla
    transport) and TP experts; the EP model's params and the model."""
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("tp",))
    sd = _hf_state_dict(_cfg(models))
    out = {}
    for par in ("ep", "tp"):
        kw = dict(ep_method="xla", ep_chunk=8) if par == "ep" else {}
        m = JaxQwen3MoE(_cfg(jax_config), mesh=mesh, mode="xla",
                        dtype=jnp.float32, moe_config=_jax_moe_config(),
                        moe_parallel=par, **kw)
        p = m.load_state_dict(sd)
        toks = np.asarray(JaxEngine(m, p, max_len=MAX_LEN).serve(_ids(),
                                                                  GEN))
        out[par] = (toks, jax.device_get(p), m)
    return sd, out


def _port(par, n, mode, **kw):
    return models.Qwen3MoE(_cfg(models), mode=mode, dtype="float32",
                           device="cpu", num_ranks=n, moe_parallel=par,
                           moe_config=_port_moe_config(), **kw)


def _serve(model, params):
    return models.Engine(model, params, max_len=MAX_LEN).serve(_ids(), GEN)


def test_jax_layouts_agree(jax_runs):
    """The reference itself: EP and TP experts give the same tokens."""
    _, out = jax_runs
    np.testing.assert_array_equal(out["ep"][0], out["tp"][0])


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("mode", MODES)
def test_ep_engine_tokens_equal_jax(jax_runs, n, mode):
    """EP at n ranks in every mode, both transports (and the one-rank
    port), loaded from the state dict: the JAX Engine's f32 greedy tokens;
    the sequence-sharded prefill dispatches through the all-to-all."""
    sd, out = jax_runs
    want = out["ep"][0]
    for method in ("ragged", "xla"):
        m = _port("ep", n, mode, ep_method=method, ep_chunk=8)
        _common.reset_dispatch()
        got = _serve(m, m.load_state_dict(sd))
        np.testing.assert_array_equal(got, want, err_msg=f"{method} {mode}")
        log = _common.dispatch_counts("ep_pipeline")
        if mode in ("xla", "fused"):      # one chunk a prefill layer
            assert log == {("ep_pipeline", "sequential", "chunks=1"):
                           m.config.num_layers}, log
        else:
            assert log == {}, log


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mode", ["fused", "ar"])
def test_ep_pipeline_tokens_equal_the_flat_chain(jax_runs, n, mode):
    """ep_pipeline=2 on the ragged transport: the same tokens."""
    sd, out = jax_runs
    m = _port("ep", n, mode, ep_method="ragged", ep_chunk=8, ep_pipeline=2)
    np.testing.assert_array_equal(_serve(m, m.load_state_dict(sd)),
                                  out["ep"][0])


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("mode", MODES)
def test_tp_expert_engine_tokens_equal_jax(jax_runs, n, mode):
    """Tensor-parallel experts at n ranks in every mode: the JAX
    Engine's tokens (its run at n = 4 holds every n)."""
    sd, out = jax_runs
    m = _port("tp", n, mode)
    np.testing.assert_array_equal(_serve(m, m.load_state_dict(sd)),
                                  out["tp"][0], err_msg=mode)


@pytest.mark.parametrize("par", ["ep", "tp"])
def test_params_from_jax_at_four_ranks(jax_runs, par):
    """params_from_jax(tree, num_ranks=4, moe_parallel=): every leaf
    exactly, the experts split as the layout says; EP experts are views
    of the converted global tensor (one storage, no copy); the tokens
    equal the JAX Engine's."""
    _, out = jax_runs
    toks, jp, _ = out[par]
    p = models.params_from_jax(jp, device="cpu", num_ranks=4,
                               moe_parallel=par)
    specs = tqwen.moe_param_specs(par)
    for k, leaf in jp["layers"].items():
        t, dim = p["layers"][k], specs["layers"][k]
        got = t if dim is None else unshard(t, dim, at=1)
        np.testing.assert_array_equal(got.numpy(), leaf, err_msg=k)
    gu = p["layers"]["w_moe_gate_up"]
    E = SHRINK["num_experts"]
    if par == "ep":
        assert gu.shape[1:3] == (4, E // 4) and gu._base is not None
        assert gu.untyped_storage().nbytes() == gu.numel() * 4
        assert gu.is_contiguous()
    else:
        assert gu.shape[1:3] == (4, E)
    m = _port(par, 4, "fused")
    np.testing.assert_array_equal(_serve(m, p), toks)


def test_ep_shard_params_are_views_of_the_one_rank_model():
    """The EP model's experts from the one-rank model's parameters share
    their storage; the TP ones are copies; init_params draws the same
    logical model at every n."""
    one = _port("tp", 1, "fused")
    base = one.init_params(torch.Generator().manual_seed(5))
    ep = _port("ep", 4, "fused").shard_params(base)
    for k in ("w_moe_gate_up", "w_moe_down"):
        assert ep["layers"][k].data_ptr() == base["layers"][k].data_ptr()
        assert ep["layers"][k].shape[:3] == (2, 4, SHRINK["num_experts"] // 4)
    tp = _port("tp", 4, "fused").shard_params(base)
    assert tp["layers"]["w_moe_gate_up"].data_ptr() != \
        base["layers"]["w_moe_gate_up"].data_ptr()
    want = _serve(one, base)
    for par in ("ep", "tp"):
        m = _port(par, 2, "gemm_ar")
        np.testing.assert_array_equal(
            _serve(m, m.init_params(torch.Generator().manual_seed(5))), want)


def _capacity_cases():
    return [dict(capacity=None, b_max=4),
            dict(capacity=8, b_max=4),
            dict(capacity=7, b_max=4),
            dict(capacity=8, b_max=2, prefill_chunk=40),
            dict(capacity=16, b_max=2, spec_k=4),
            dict(capacity=16, b_max=8, spec_k=1),
            dict(capacity=4, b_max=8, ep_capacity=2),
            dict(capacity=3, b_max=8, ep_capacity=2)]


@pytest.mark.parametrize("case", range(len(_capacity_cases())))
def test_check_serving_capacity_raises_where_jax_raises(jax_runs, case):
    _, out = jax_runs
    jm = out["ep"][2]
    kw = dict(_capacity_cases()[case])
    cap = kw.pop("capacity")
    tm = _port("ep", 4, "xla")
    jm.moe.capacity, tm.moe.capacity = cap, cap

    def outcome(m):
        try:
            m.check_serving_capacity(**kw)
            return None
        except ValueError as e:
            return str(e).split(" ")[0]

    assert outcome(tm) == outcome(jm), kw
    tp = _port("tp", 4, "xla")
    tp.check_serving_capacity(1, prefill_chunk=10 ** 6)   # nothing to check


# ---------------------------------------------------------------------------
# The EP layer against its own golden (port only; the JAX layer is held
# through the model runs above)
# ---------------------------------------------------------------------------

LAYER = dict(num_experts=8, hidden=32, intermediate=16, top_k=2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("method", ["ragged", "xla"])
@pytest.mark.parametrize("pipeline", [1, 2])
@pytest.mark.parametrize("wire", [None, "int8"])
def test_ep_layer_equals_its_reference(dtype, method, pipeline, wire):
    """EPMoE at 4 ranks against reference_forward: f32 within 2e-2 (the
    JAX test's tolerance, :82), the int8 wire within 0.15 (its quantized
    tolerance, :222), bf16 within 5e-2 of the largest value (bf16 inputs
    and weights, rounded expert outputs)."""
    n = 4
    layer = EPMoE(**LAYER, num_ranks=n, method=method, block_m=8, chunk=8,
                  pipeline=pipeline, wire_dtype=wire)
    params = layer.init_params(torch.Generator().manual_seed(0), dtype=dtype)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(n * 8, LAYER["hidden"])).astype(np.float32)).to(dtype)
    _common.reset_dispatch()
    got = layer(params, x).float()
    want = layer.reference_forward(params, x).float()
    if wire is not None:
        tol = dict(rtol=0.15, atol=0.15)
    elif dtype == torch.float32:
        tol = dict(rtol=2e-2, atol=2e-2)
    else:
        tol = dict(rtol=0, atol=5e-2 * float(want.abs().max()))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)
    issue = "sequential" if pipeline == 1 else "pipelined"
    assert _common.dispatch_counts("ep_pipeline") == {
        ("ep_pipeline", issue, f"chunks={pipeline}"): 1}


def test_ep_layer_ignores_stale_landing_rows(monkeypatch):
    """Rows past a source's count in the received slabs are undefined (on
    the card they hold an earlier call's data): garbage planted there
    changes no output bit."""
    layer = EPMoE(**LAYER, num_ranks=4, method="ragged", block_m=8, chunk=8)
    params = layer.init_params(torch.Generator().manual_seed(1),
                               dtype=torch.float32)
    x = torch.randn(32, LAYER["hidden"], generator=torch.Generator())
    clean = layer(params, x)
    plain = tep._ragged_a2a_plain

    def stale(buf, counts):
        out = plain(buf, counts)
        live = torch.arange(buf.shape[2])[None, None] < counts.t()[..., None]
        return torch.where(live[..., None], out, torch.full_like(out, 1e30))

    monkeypatch.setattr(tep, "_ragged_a2a_plain", stale)
    assert torch.equal(layer(params, x), clean)


def test_ep_layer_decode_rows_equal_the_dispatch_path():
    """decode_rows_shard (replicated rows, no all-to-all) against the
    dispatch path on the same rows, and the one-rank layer."""
    n = 4
    layer = EPMoE(**LAYER, num_ranks=n, block_m=8, chunk=8)
    params = layer.init_params(torch.Generator().manual_seed(3),
                               dtype=torch.float32)
    x = torch.randn(n * 6, LAYER["hidden"], generator=torch.Generator())
    rows = layer.decode_rows_shard(x, params["router"], params["w_gate_up"],
                                   params["w_down"])
    np.testing.assert_allclose(rows.numpy(), layer(params, x).numpy(),
                               rtol=1e-5, atol=1e-6)
    one = EPMoE(**LAYER, num_ranks=1, block_m=8, chunk=8)
    p1 = one.shard_params(params["router"],
                          params["w_gate_up"].flatten(0, 1),
                          params["w_down"].flatten(0, 1))
    np.testing.assert_allclose(one(p1, x).numpy(), rows.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_what_stays_refused():
    """pipeline="tune" / "auto" name their ROADMAP items, the EP tick plan
    of an "auto" pipeline too; ServeEngine over an n-rank MoE (EP
    included) builds at tp_ranks=n since slice 6e
    (tests/test_torch_moe_serve_nrank.py holds it to JAX); shapes that do
    not split raise."""
    layer = EPMoE(**LAYER, num_ranks=2, pipeline="tune")
    with pytest.raises(NotImplementedError, match="slice 7"):
        layer(None, torch.zeros(4, LAYER["hidden"]))
    auto = EPMoE(**LAYER, num_ranks=2, pipeline="auto")
    with pytest.raises(NotImplementedError, match="estimators"):
        auto._shard_fwd(torch.zeros(2, 2, LAYER["hidden"]), None, None, None)
    from triton_distributed_tpu_torch import perf_model
    with pytest.raises(NotImplementedError, match="estimators"):
        perf_model.ep_tick_plan(4, hidden=64, moe_intermediate=32, top_k=2,
                                num_ranks=2, pipeline="auto")
    for par in ("ep", "tp"):
        se = models.ServeEngine(_port(par, 2, "xla"), None, tp_ranks=2)
        assert se.stats()["tp_ranks"] == 2 and se.model.moe_parallel == par
    with pytest.raises(ValueError, match="split"):
        EPMoE(**{**LAYER, "num_experts": 6}, num_ranks=4)
    with pytest.raises(ValueError, match="moe_parallel"):
        _port("dp", 2, "xla")
