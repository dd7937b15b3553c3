"""The port's models (triton_distributed_tpu_torch/models) against the JAX
package's, on the CPU: configs, weights carried across, HF state-dict
loading, and generation.

The JAX models run on a 1-device mesh (attention kernels in Pallas
interpret mode); the port's on CPU tensors. Greedy tokens must be equal
in f32; bf16 prefill logits agree within 5e-2 of the largest logit
(rounding points of the bf16 matmuls and softmax over two layers).
"""

import dataclasses

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
from triton_distributed_tpu.models import config as jax_config
from triton_distributed_tpu.models import engine as jax_engine
from triton_distributed_tpu_torch import models
from triton_distributed_tpu_torch.models import engine as torch_engine

# shrunken tiny configs: same structure (tying, qk-norm, GQA), small widths
SHRINK = dict(hidden_size=64, num_heads=4, num_kv_heads=2, head_dim=16,
              vocab_size=128, intermediate_size=128)
SERVE_CONFIGS = ["Qwen/Qwen3-0.6B",              # tied embeddings
                 "Qwen/Qwen3-8B",                # untied
                 "meta-llama/Meta-Llama-3-70B"]  # no qk-norm
B, S, GEN, MAX_LEN = 2, 11, 6, 32                # S is not a power of two


@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.asarray(jax.devices()[:1]), ("tp",))


def _jax_model(mesh, name, dtype=jnp.float32, seed=0):
    m = JaxDenseLLM(jax_config.get_config(name).tiny(**SHRINK), mesh=mesh,
                    mode="xla", dtype=dtype)
    return m, m.init_params(jax.random.PRNGKey(seed))


def _port_model(name, dtype="float32"):
    return models.DenseLLM(models.get_config(name).tiny(**SHRINK),
                           mode="xla", dtype=dtype, device="cpu")


def _ids(seed=0):
    return np.random.RandomState(seed).randint(0, SHRINK["vocab_size"],
                                               (B, S))


def test_config_registry_matches_jax():
    assert list(models.MODEL_CONFIGS) == list(jax_config.MODEL_CONFIGS)
    for name, cfg in jax_config.MODEL_CONFIGS.items():
        ours = models.MODEL_CONFIGS[name]
        assert dataclasses.asdict(ours) == dataclasses.asdict(cfg)
        assert dataclasses.asdict(ours.tiny(**SHRINK)) == \
            dataclasses.asdict(cfg.tiny(**SHRINK))
        assert ours.is_moe == cfg.is_moe
    assert models.get_config("Qwen3-8B").hidden_size == 4096
    with pytest.raises(KeyError):
        models.get_config("nope")


def test_prompt_bucket_matches_jax():
    for s in (1, 5, 8, 9, 11, 17, 100, 500):
        for cap in (20, 100, 992):
            if s <= cap:
                assert torch_engine.prompt_bucket(s, cap) == \
                    jax_engine.prompt_bucket(s, cap)
    assert torch_engine.pow2_bucket(3, 16, 64) == \
        jax_engine.pow2_bucket(3, 16, 64)


def test_params_from_jax_carries_weights_exactly(mesh1):
    """bf16 leaves arrive as ml_dtypes arrays; they cross exactly. (The
    model and seed of the bf16 prefill test below, so the two share the
    JAX compiles.)"""
    jm, jp = _jax_model(mesh1, "Qwen/Qwen3-8B", jnp.bfloat16)
    tp = models.params_from_jax(jax.device_get(jp), device="cpu")
    want = jax.tree_util.tree_flatten_with_path(jax.device_get(jp))[0]
    assert len(want) == 3 + 8          # embed, norm, lm_head + 8 layer arrays
    for path, leaf in want:
        got = tp
        for key in path:
            got = got[key.key]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(leaf, np.float32))


def _hf_state_dict(cfg, seed):
    rng = np.random.RandomState(seed)
    H, D, I = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    sd = {"model.embed_tokens.weight": w(cfg.vocab_size, H),
          "model.norm.weight": 1 + 0.1 * w(H)}
    if not cfg.tie_word_embeddings:
        sd["lm_head.weight"] = w(cfg.vocab_size, H)
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        sd[pre + "input_layernorm.weight"] = 1 + 0.1 * w(H)
        sd[pre + "post_attention_layernorm.weight"] = 1 + 0.1 * w(H)
        sd[pre + "self_attn.q_proj.weight"] = w(cfg.num_heads * D, H)
        sd[pre + "self_attn.k_proj.weight"] = w(cfg.num_kv_heads * D, H)
        sd[pre + "self_attn.v_proj.weight"] = w(cfg.num_kv_heads * D, H)
        sd[pre + "self_attn.o_proj.weight"] = w(H, cfg.num_heads * D)
        sd[pre + "mlp.gate_proj.weight"] = w(I, H)
        sd[pre + "mlp.up_proj.weight"] = w(I, H)
        sd[pre + "mlp.down_proj.weight"] = w(H, I)
        if cfg.qk_norm:
            sd[pre + "self_attn.q_norm.weight"] = 1 + 0.1 * w(D)
            sd[pre + "self_attn.k_norm.weight"] = 1 + 0.1 * w(D)
    return sd


@pytest.mark.parametrize("name,dtype", [
    ("Qwen/Qwen3-0.6B", "float32"),             # tied, qk-norm
    ("meta-llama/Meta-Llama-3-70B", "bfloat16"),  # untied, no qk-norm
])
def test_load_state_dict_matches_jax(mesh1, name, dtype):
    cfg = models.get_config(name).tiny(**SHRINK)
    sd = _hf_state_dict(cfg, seed=2)
    jm = JaxDenseLLM(jax_config.get_config(name).tiny(**SHRINK), mesh=mesh1,
                     mode="xla", dtype=getattr(jnp, dtype))
    want = jax.device_get(jm.load_state_dict(sd))
    port = _port_model(name, dtype)
    got = port.load_state_dict(sd)
    got_torch = port.load_state_dict({k: torch.from_numpy(v)
                                      for k, v in sd.items()})
    for tree in (got, got_torch):
        flat = {k: tree[k] for k in ("embed", "norm", "lm_head")}
        flat.update(tree["layers"])
        want_flat = {k: want[k] for k in ("embed", "norm", "lm_head")}
        want_flat.update(want["layers"])
        assert flat.keys() == want_flat.keys()
        for k, t in flat.items():
            np.testing.assert_array_equal(
                t.float().numpy(), np.asarray(want_flat[k], np.float32),
                err_msg=k)


@pytest.mark.parametrize("name", SERVE_CONFIGS)
def test_serve_greedy_tokens_equal_jax_f32(mesh1, name):
    jm, jp = _jax_model(mesh1, name)
    ids = _ids()
    want = JaxEngine(jm, jp, max_len=MAX_LEN).serve(ids, GEN)
    port = _port_model(name)
    params = models.params_from_jax(jax.device_get(jp), device="cpu")
    got = models.Engine(port, params, max_len=MAX_LEN).serve(ids, GEN)
    assert got.shape == (B, GEN) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))


def _jax_prefill_last_hidden(jm, jp, ids):
    """The JAX DenseLLM.prefill forward up to its final norm (what
    greedy_token reads), composed from the JAX package's own layer
    calls, so the logits can be compared and not only their argmax."""
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
        return jax_rms_norm(x[:, -1], prm["norm"], c.rms_norm_eps)

    return jax.jit(shard_map(
        fwd, mesh=jm.mesh, in_specs=(P(), jm.param_specs()), out_specs=P(),
        check_vma=False))(jnp.asarray(ids, jnp.int32), jp)


def test_prefill_bf16_logits_and_first_token_match_jax(mesh1):
    name = "Qwen/Qwen3-8B"
    jm, jp = _jax_model(mesh1, name, jnp.bfloat16)
    ids = _ids(1)
    jlast = _jax_prefill_last_hidden(jm, jp, ids)
    want = np.asarray(jnp.dot(jlast, jp["lm_head"],
                              preferred_element_type=jnp.float32))
    jtok, _ = jax.jit(jm.prefill)(jp, jnp.asarray(ids, jnp.int32),
                                  jm.new_kv_cache(B, MAX_LEN))
    np.testing.assert_array_equal(np.asarray(jtok), want.argmax(-1))

    port = _port_model(name, "bfloat16")
    params = models.params_from_jax(jax.device_get(jp), device="cpu")
    last, _ = port._prefill_hidden(params, ids, port.new_kv_cache(B, MAX_LEN))
    got = (last.float() @ params["lm_head"].float()).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=5e-2 * np.abs(want).max())
    tok, cache = port.prefill(params, ids, port.new_kv_cache(B, MAX_LEN))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    assert cache.offset == S


def _port_engine(name="Qwen/Qwen3-8B", seed=0):
    port = _port_model(name)
    params = port.init_params(torch.Generator().manual_seed(seed))
    return port, params, models.Engine(port, params, max_len=MAX_LEN)


def test_stepwise_matches_serve():
    _, _, eng = _port_engine()
    ids = _ids(2)
    served = eng.serve(ids, GEN)
    tok, cache = eng.start(ids)
    out = [tok]
    for _ in range(GEN - 1):
        tok, cache = eng.step(tok, cache)
        out.append(tok)
    np.testing.assert_array_equal(served, torch.stack(out, 1).numpy())
    assert cache.offset == S + GEN - 1


def test_sampled_serve_draws_from_top_k_and_is_reproducible():
    port, params, eng = _port_engine()
    ids, top_k = _ids(3), 5
    toks = eng.serve(ids, GEN, temperature=0.8, top_k=top_k, seed=3)
    np.testing.assert_array_equal(
        toks, eng.serve(ids, GEN, temperature=0.8, top_k=top_k, seed=3))
    np.testing.assert_array_equal(   # top_k = 1 is greedy
        eng.serve(ids, GEN, temperature=0.8, top_k=1, seed=4),
        eng.serve(ids, GEN))
    # replay the sampled stream: each token is among its step's top-k
    tok, cache = eng.start(ids)
    np.testing.assert_array_equal(tok.numpy(), toks[:, 0])   # greedy first
    for t in range(1, GEN):
        prev = torch.from_numpy(toks[:, t - 1])
        x, cache = port._decode_hidden(params, prev, cache)
        top = torch.topk(x.float() @ params["lm_head"].float(), top_k).indices
        assert all(toks[b, t] in top[b].tolist() for b in range(B))
    with pytest.raises(ValueError, match="Generator"):
        eng.step(tok, cache, temperature=0.5)


def test_init_params_layout_and_scales():
    port, params, _ = _port_engine("Qwen/Qwen3-0.6B")
    c = port.config
    L, H = c.num_layers, c.hidden_size
    assert params["layers"]["w_qkv"].shape == (
        L, H, (c.num_heads + 2 * c.num_kv_heads) * c.head_dim)
    assert params["lm_head"].data_ptr() == params["embed"].data_ptr()  # tied
    torch.testing.assert_close(params["lm_head"], params["embed"].t())
    std = params["layers"]["w_gate_up"].std().item()
    assert abs(std * H ** 0.5 - 1) < 0.1


def test_autollm_and_one_rank_scope():
    assert isinstance(models.AutoLLM.from_config("Qwen3-8B", device="cpu"),
                      models.DenseLLM)
    assert isinstance(models.AutoLLM.from_config("Qwen/Qwen3-30B-A3B",
                                                 device="cpu"),
                      models.Qwen3MoE)
    two = _port_model("Qwen/Qwen3-8B").__class__(
        models.get_config("Qwen3-8B"), device="cpu", num_ranks=2)
    assert two.n == 2 and two.attn.h_loc == 16 and two.attn.hkv_loc == 4
    moe2 = models.Qwen3MoE(models.get_config("Qwen/Qwen3-30B-A3B"),
                           device="cpu", num_ranks=2)
    assert moe2.n == 2 and moe2.moe.n == 2
    # an n-rank MoE serves at tp_ranks=n since slice 6e
    # (tests/test_torch_moe_serve_nrank.py holds it to JAX)
    assert models.ServeEngine(moe2, None, tp_ranks=2).stats()[
        "tp_ranks"] == 2
    with pytest.raises(ValueError):
        models.DenseLLM(models.get_config("Qwen3-8B"), mode="nccl",
                        device="cpu")
