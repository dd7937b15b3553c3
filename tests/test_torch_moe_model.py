"""The port's Qwen3MoE (triton_distributed_tpu_torch/models/qwen_moe.py)
behind Engine and ServeEngine against the JAX package's, on the CPU.

Both packages run the tiny Qwen3-30B-A3B config (2 layers, 8 experts,
top-2) with block_m 8; the JAX model runs on a 1-device mesh with its
grouped GEMM and attention kernels in Pallas interpret mode, and its
weights are carried across with `params_from_jax`. Greedy tokens must be
equal in f32; bf16 prefill logits agree within 5e-2 of the largest
logit (rounding points of the bf16 matmuls over two layers) and the
first token is equal. The ServeEngine comparison is
tests/test_torch_moe_serve.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from triton_distributed_tpu.layers.norm import rms_norm as jax_rms_norm
from triton_distributed_tpu.models import DenseLLM as JaxDenseLLM
from triton_distributed_tpu.models import Engine as JaxEngine
from triton_distributed_tpu.models import ServeEngine as JaxServeEngine
from triton_distributed_tpu.models import config as jax_config
from triton_distributed_tpu.models.qwen_moe import Qwen3MoE as JaxQwen3MoE
from triton_distributed_tpu.ops import grouped_gemm as jgg
from triton_distributed_tpu.ops import moe_parallel as jmp
from triton_distributed_tpu_torch import models
from triton_distributed_tpu_torch.ops import grouped_gemm as tgg
from triton_distributed_tpu_torch.ops import moe_parallel as tmp

NAME = "Qwen/Qwen3-30B-A3B"
B, S, GEN, MAX_LEN = 2, 11, 4, 32
JCFG = jmp.MoEParallelConfig(gemm=jgg.GroupedGemmConfig(block_m=8))
TCFG = tmp.MoEParallelConfig(gemm=tgg.GroupedGemmConfig(block_m=8))
ENGINE = dict(b_max=2, max_len=32, block=4, prefill_chunk=8)


def _cfg(pkg):
    return pkg.get_config(NAME).tiny(num_layers=2)


def _port_model(dtype="float32"):
    return models.Qwen3MoE(_cfg(models), mode="xla", dtype=dtype,
                           device="cpu", moe_config=TCFG)


@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.asarray(jax.devices()[:1]), ("tp",))


def _jax_model(mesh, dtype=jnp.float32, seed=0):
    m = JaxQwen3MoE(_cfg(jax_config), mesh=mesh, mode="xla", dtype=dtype,
                    moe_config=JCFG)
    return m, m.init_params(jax.random.PRNGKey(seed))


@pytest.fixture(scope="module")
def f32_pair(mesh1):
    jm, jp = _jax_model(mesh1)
    return (jm, jp), (_port_model(), models.params_from_jax(
        jax.device_get(jp), device="cpu"))


@pytest.fixture(scope="module")
def bf16_jax(mesh1, f32_pair):
    """The bf16 model over the f32 weights rounded to bf16 (the router
    stays f32), so no second random init is compiled."""
    (_, jp), _ = f32_pair
    jm = JaxQwen3MoE(_cfg(jax_config), mesh=mesh1, mode="xla",
                     dtype=jnp.bfloat16, moe_config=JCFG)
    lay = {k: v if k == "router" else v.astype(jnp.bfloat16)
           for k, v in jp["layers"].items()}
    return jm, {**{k: jp[k].astype(jnp.bfloat16)
                   for k in ("embed", "norm", "lm_head")}, "layers": lay}


def _ids(seed=0):
    return np.random.RandomState(seed).randint(0, _cfg(models).vocab_size,
                                               (B, S))


def test_autollm_selects_qwen3moe_and_scope():
    m = models.AutoLLM.from_config(NAME, device="cpu")
    assert isinstance(m, models.Qwen3MoE) and m.moe_parallel == "tp"
    assert models.AutoLLM.model_class(_cfg(models)) is models.Qwen3MoE
    ep = models.Qwen3MoE(_cfg(models), device="cpu", moe_parallel="ep")
    assert ep.moe_parallel == "ep" and ep.moe.n == 1
    with pytest.raises(ValueError, match="moe_parallel"):
        models.Qwen3MoE(_cfg(models), device="cpu", moe_parallel="dp")
    with pytest.raises(ValueError, match="MoE"):
        models.Qwen3MoE(models.get_config("Qwen/Qwen3-8B").tiny(),
                        device="cpu")
    assert m.check_serving_capacity(4, prefill_chunk=256, ep_capacity=2) \
        is None


def test_params_from_jax_carries_the_moe_tree(bf16_jax):
    jm, jp = bf16_jax
    tp = models.params_from_jax(jax.device_get(jp), device="cpu")
    c = _cfg(models)
    L, H, E, I = c.num_layers, c.hidden_size, c.num_experts, \
        c.moe_intermediate_size
    lay = tp["layers"]
    assert "w_gate_up" not in lay and "w_down" not in lay
    assert lay["router"].dtype == torch.float32
    assert tuple(lay["router"].shape) == (L, H, E)
    assert tuple(lay["w_moe_gate_up"].shape) == (L, E, H, 2 * I)
    assert tuple(lay["w_moe_down"].shape) == (L, E, I, H)
    want = jax.tree_util.tree_flatten_with_path(jax.device_get(jp))[0]
    for path, leaf in want:
        got = tp
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(leaf, np.float32))


def test_init_params_layout_and_scales():
    m = _port_model("bfloat16")
    p = m.init_params(torch.Generator().manual_seed(0))
    c = m.config
    gu = p["layers"]["w_moe_gate_up"]
    I, H = c.moe_intermediate_size, c.hidden_size
    assert gu.dtype == torch.bfloat16 and p["layers"]["router"].dtype == \
        torch.float32
    for half in (gu[..., :I], gu[..., I:]):
        assert abs(half.float().std().item() * H ** 0.5 - 1) < 0.1
    assert not torch.equal(gu[..., :I], gu[..., I:])
    down = p["layers"]["w_moe_down"].float()
    assert abs(down.std().item() * I ** 0.5 - 1) < 0.1


def _hf_moe_state_dict(cfg, seed):
    rng = np.random.RandomState(seed)
    H, D, I, E = (cfg.hidden_size, cfg.head_dim, cfg.moe_intermediate_size,
                  cfg.num_experts)

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
        sd[pre + "mlp.gate.weight"] = w(E, H)
        for j in range(E):
            sd[f"{pre}mlp.experts.{j}.gate_proj.weight"] = w(I, H)
            sd[f"{pre}mlp.experts.{j}.up_proj.weight"] = w(I, H)
            sd[f"{pre}mlp.experts.{j}.down_proj.weight"] = w(H, I)
    return sd


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_state_dict_matches_jax(mesh1, dtype):
    sd = _hf_moe_state_dict(_cfg(models), seed=2)
    jm = JaxQwen3MoE(_cfg(jax_config), mesh=mesh1, mode="xla",
                     dtype=getattr(jnp, dtype), moe_config=JCFG)
    want = jax.device_get(jm.load_state_dict(sd))
    got = _port_model(dtype).load_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()})
    flat = {k: got[k] for k in ("embed", "norm", "lm_head")}
    flat.update(got["layers"])
    want_flat = {k: want[k] for k in ("embed", "norm", "lm_head")}
    want_flat.update(want["layers"])
    assert flat.keys() == want_flat.keys()
    assert flat["router"].dtype == torch.float32
    for k, t in flat.items():
        np.testing.assert_array_equal(
            t.float().numpy(), np.asarray(want_flat[k], np.float32),
            err_msg=k)


def test_engine_serve_greedy_tokens_equal_jax_f32(f32_pair):
    (jm, jp), (port, params) = f32_pair
    ids = _ids()
    want = JaxEngine(jm, jp, max_len=MAX_LEN).serve(ids, GEN)
    got = models.Engine(port, params, max_len=MAX_LEN).serve(ids, GEN)
    assert got.shape == (B, GEN) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))
    # the stepwise API gives serve's tokens
    eng = models.Engine(port, params, max_len=MAX_LEN)
    tok, cache = eng.start(ids)
    out = [tok]
    for _ in range(GEN - 1):
        tok, cache = eng.step(tok, cache)
        out.append(tok)
    np.testing.assert_array_equal(torch.stack(out, 1).numpy(), got)


def _jax_prefill_logits(jm, jp, ids):
    """The JAX Qwen3MoE prefill forward up to the f32 logits of the last
    row, composed from the JAX package's own layer calls."""
    c = jm.config

    def fwd(ids, prm):
        x = jnp.take(prm["embed"], ids, axis=0)
        ck = jnp.zeros((ids.shape[0], ids.shape[1], c.num_kv_heads,
                        c.head_dim), x.dtype)
        for i in range(c.num_layers):
            p = jax.tree.map(lambda t: t[i], prm["layers"])
            h = jax_rms_norm(x, p["ln1"], c.rms_norm_eps)
            a, _, _ = jm.attn._prefill_shard(
                jm._attn_layer_params(p), h, p["w_qkv"], p["w_o"], ck, ck,
                seq_len=ids.shape[1])
            x = x + a
            h = jax_rms_norm(x, p["ln2"], c.rms_norm_eps)
            x = x + jm._mlp_rows(h, p, mode=jm.mode)
        last = jax_rms_norm(x[:, -1], prm["norm"], c.rms_norm_eps)
        return jnp.dot(last, prm["lm_head"],
                       preferred_element_type=jnp.float32)

    return np.asarray(jax.jit(shard_map(
        fwd, mesh=jm.mesh, in_specs=(P(), jm.param_specs()), out_specs=P(),
        check_vma=False))(jnp.asarray(ids, jnp.int32), jp))


def test_prefill_bf16_logits_and_first_token_match_jax(bf16_jax):
    jm, jp = bf16_jax
    ids = _ids(1)
    want = _jax_prefill_logits(jm, jp, ids)
    port = _port_model("bfloat16")
    params = models.params_from_jax(jax.device_get(jp), device="cpu")
    last, _ = port._prefill_hidden(params, ids, port.new_kv_cache(B, MAX_LEN))
    got = (last.float() @ params["lm_head"].float()).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=5e-2 * np.abs(want).max())
    tok, cache = port.prefill(params, ids, port.new_kv_cache(B, MAX_LEN))
    np.testing.assert_array_equal(tok.numpy(), want.argmax(-1))
    assert cache.offset == S


def test_ep_capacity_needs_a_moe_model(mesh1):
    dcfg = dict(hidden_size=64, intermediate_size=96, num_heads=4,
                num_kv_heads=2, head_dim=16, vocab_size=128)
    dm = models.DenseLLM(models.get_config("Qwen/Qwen3-0.6B").tiny(**dcfg),
                         mode="xla", dtype="float32", device="cpu")
    dp = dm.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="MoE"):
        models.ServeEngine(dm, dp, ep_capacity=1, **ENGINE)
    jm = JaxDenseLLM(jax_config.get_config("Qwen/Qwen3-0.6B").tiny(**dcfg),
                     mesh=mesh1, mode="xla", dtype=jnp.float32)
    with pytest.raises(ValueError, match="MoE"):   # refused before params
        JaxServeEngine(jm, None, ep_capacity=1, **ENGINE)
    # a dense engine reports the EP keys at rest
    st = models.ServeEngine(dm, dp, **ENGINE).stats()
    assert (st["capacity_drops"], st["ep_rows"], st["ep_capacity"],
            st["ep_plan"]) == (0, 0, 0, None)
