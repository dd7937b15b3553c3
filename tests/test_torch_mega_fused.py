"""The megakernel's fused decode programs (ExecutorCuda(fuse_elementwise=,
fuse_kv_append=), MegaDecoder(fuse_elementwise=, fuse_kv_append=))
against the JAX package's and the port's unfused programs, on the CPU.

- The fusion plan is the JAX ExecutorPallas's: the nodes the port fuses
  away are the ones JAX turns into NOP queue rows (constructing the JAX
  program builds its queue; no kernel runs). One design difference: JAX
  folds every eligible RMS_NORM at one core whatever the flags, the port
  only under `fuse_elementwise`.
- The fused plain walk keeps the unfused tasks' rounding points, so in
  f32 its outputs and updated caches equal the unfused walk's bit for
  bit, under every seeded interleaving of the queues; it agrees with the
  JAX ExecutorXLA within 1e-5 of the largest value (f32 summation order).
- A fused MegaDecoder gives the unfused decoder's greedy tokens and
  teacher-forced hidden rows bit for bit (the JAX MegaDecoder's tokens
  are held in tests/test_torch_megakernel.py, beside its JAX run); its
  prefill program is the unfused one, task for task and descriptor for
  descriptor.
"""

import numpy as np
import pytest
import torch

from triton_distributed_tpu.megakernel import models as jmodels
from triton_distributed_tpu.megakernel.graph import TASK_NOP
import triton_distributed_tpu_torch as port
from triton_distributed_tpu_torch import models
from triton_distributed_tpu_torch.megakernel import executor_cuda as mkx
from triton_distributed_tpu_torch.megakernel import models as tmodels

TINY = dict(hidden=64, intermediate=128, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, max_cache=32)
SHRINK = dict(hidden_size=64, num_heads=4, num_kv_heads=2, head_dim=16,
              vocab_size=128)
FLAGS = [(True, False), (False, True), (True, True)]
CL = 11


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _jax_nops(S, qk_norm, ew, kv):
    """Positions in graph.nodes of the nodes the JAX Pallas program turns
    into TASK_NOP rows (one core, tile_m 8: one queue row a node)."""
    jmb = jmodels.build_qwen3_decode(seq_len=S, **TINY, qk_norm=qk_norm,
                                     kv_append=True)
    q = jmb.compile(backend="pallas", tile_m=8, tile_n=16,
                    fuse_elementwise=ew, fuse_kv_append=kv).queue
    compute = [i for i, nd in enumerate(jmb.graph.nodes)
               if nd.op not in ("input", "weight")]
    assert len(q) == len(compute)
    return {compute[i] for i in range(len(q)) if q[i, 0] == TASK_NOP}


def _port_away(S, qk_norm, ew, kv):
    mb = tmodels.build_qwen3_decode(seq_len=S, **TINY, qk_norm=qk_norm,
                                    kv_append=True)
    prog = mb.compile("kernel", device="cpu", n_sm=4, fuse_elementwise=ew,
                      fuse_kv_append=kv)
    pos = {id(nd): i for i, nd in enumerate(mb.graph.nodes)}
    return {pos[id(nd)] for nd in prog.fused_away}, prog


@pytest.mark.parametrize("qk_norm", [True, False])
@pytest.mark.parametrize("S", [1, 8])
def test_fusion_plan_equals_jax_nop_rows(S, qk_norm):
    g = tmodels.build_qwen3_decode(seq_len=S, **TINY, qk_norm=qk_norm,
                                   kv_append=True).graph
    jax_rms = _jax_nops(S, qk_norm, False, False)   # JAX folds these always
    assert {g.nodes[i].op for i in jax_rms} == {"rms_norm"}
    assert len(jax_rms) == 2 * TINY["num_layers"]
    assert _port_away(S, qk_norm, False, False)[0] == set()
    for ew, kv in FLAGS:
        got, prog = _port_away(S, qk_norm, ew, kv)
        want = _jax_nops(S, qk_norm, ew, kv)
        if not ew:      # the port folds RMS_NORM only under the flag
            assert jax_rms <= want
            want -= jax_rms
        assert got == want, (ew, kv)
        # a layer loses 2 norms, the silu and 2 adds, and 2 appends
        gone = (5 if ew else 0) + (2 if kv else 0)
        assert len(prog.tasks) == (13 - gone) * TINY["num_layers"] + 1
        ops = [nd.op for nd in prog.fused_away]
        assert ops.count("kv_append") == (4 if kv else 0)
        assert ops.count("silu_mul") == (2 if ew else 0)


def test_fused_program_tasks_and_dependencies():
    """Both flags: 6 tasks a layer (qkv, attn, o+add, gate, up, down+add)
    and the final norm. Each fused task waits on the writers of every row
    it reads: the norm's input, both silu sources, the residual (the
    previous down+add's rows)."""
    _, prog = _port_away(1, True, True, True)
    L = TINY["num_layers"]
    assert [nd.op for nd in prog.tasks] == \
        ["linear", "attention_kv", "linear", "linear", "linear",
         "linear"] * L + ["rms_norm"]
    absorbed = [sorted(k for k in prog.fusion.get(nd.out.idx, {})
                       if k != "resid") for nd in prog.tasks]
    assert absorbed == [["rms"], ["kv"], ["add"], ["rms"], ["rms"],
                        ["add", "silu"]] * L + [[]]
    assert prog.deps == [[], [0], [1], [2], [2], [2, 3, 4],
                         [5], [6], [5, 7], [8], [8], [8, 9, 10], [11]]


def test_fused_descriptors_name_their_sources():
    mb = tmodels.build_qwen3_decode(seq_len=1, **TINY, qk_norm=True,
                                    kv_append=True)
    _, ws = tmodels.init_random_io(mb, np.random.default_rng(0))
    prog = mb.compile("kernel", device="cpu", n_sm=4, fuse_elementwise=True,
                      fuse_kv_append=True)
    prog.bind_weights({k: torch.from_numpy(v) for k, v in ws.items()})
    desc, _, views, *_ = prog.descriptors()
    assert desc.shape[1] == mkx.NF
    x_in = prog.inputs["x"]
    qkv, attn, o, gate, up, down = range(6)
    assert desc[qkv, mkx.F_PRO] == mkx.PRO_RMS
    assert desc[qkv, mkx.F_A] == x_in.data_ptr()
    assert desc[qkv, mkx.F_P] == prog.weights["l0.ln1"].data_ptr()
    assert desc[down, mkx.F_PRO] == mkx.PRO_SILU
    assert views[down]["a"].data_ptr() == views[gate]["out"].data_ptr()
    assert views[down]["p"].data_ptr() == views[up]["out"].data_ptr()
    assert desc[o, mkx.F_R] == x_in.data_ptr()
    assert desc[down, mkx.F_R] == desc[o, mkx.F_OUT]
    assert desc[gate, mkx.F_A] == desc[up, mkx.F_A] == desc[o, mkx.F_OUT]
    assert desc[attn, mkx.F_APPEND] == 1
    assert (desc[:, mkx.F_APPEND].sum(), desc[:, mkx.F_R].astype(bool).sum(),
            (desc[:, mkx.F_PRO] != 0).sum()) == (2, 4, 8)


def _walk(prog, ins, ws, seed):
    prog.bind_weights({k: torch.from_numpy(v) for k, v in ws.items()})
    prog.bind_caches({k: torch.from_numpy(ins[k].copy())
                      for k in prog.graph.caches})
    outs = prog.step({"x": torch.from_numpy(ins["x"])}, CL, seed=seed)
    return [o.clone() for o in outs] + [c.clone()
                                        for c in prog.caches.values()]


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX ExecutorXLA's outputs and updated caches of the qk_norm
    decode graph at cache_len CL."""
    jmb = jmodels.build_qwen3_decode(seq_len=1, **TINY, qk_norm=True,
                                     kv_append=True)
    for nd in jmb.graph.nodes:
        if nd.op == "kv_append":
            jmb.graph.outputs.append(nd.out)
    ins, ws = jmodels.init_random_io(jmb, np.random.default_rng(1))
    outs = jmb.compile("xla").run(ins, ws, {"cache_len": CL})
    return ins, ws, [np.asarray(o) for o in outs]


@pytest.mark.parametrize("qk_norm", [True, False])
@pytest.mark.parametrize("ew,kv", FLAGS)
def test_fused_plain_walk_equals_unfused_bit_for_bit(jax_ref, ew, kv,
                                                     qk_norm):
    mb = tmodels.build_qwen3_decode(seq_len=1, **TINY, qk_norm=qk_norm,
                                    kv_append=True)
    ins, ws = (jax_ref[:2] if qk_norm else
               tmodels.init_random_io(mb, np.random.default_rng(2)))
    want = _walk(mb.compile("kernel", device="cpu", n_sm=4), ins, ws, 0)
    for n_sm, seed in ((4, 0), (4, 1), (132, 2), (3, 3)):
        prog = mb.compile("kernel", device="cpu", n_sm=n_sm,
                          fuse_elementwise=ew, fuse_kv_append=kv)
        got = _walk(prog, ins, ws, seed)
        assert len(got) == len(want) == 1 + 2 * TINY["num_layers"]
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    if qk_norm:
        # the graph's outputs: the trunk and the 2 x L updated caches, as
        # the JAX program gives them (kv_append outputs in node order)
        names = {h.idx: n for n, h in mb.graph.caches.items()}
        kv_names = [names[nd.inputs[1].idx] for nd in mb.graph.nodes
                    if nd.op == "kv_append"]
        by_name = dict(zip(prog.caches, got[1:]))
        assert _rel(got[0].numpy(), jax_ref[2][0]) <= 1e-5
        for n, r in zip(kv_names, jax_ref[2][1:]):
            assert _rel(by_name[n].numpy(), r) <= 1e-5


def test_fused_bf16_plain_walk_equals_unfused():
    """The rounding points are the unfused tasks', so bf16 agrees bit for
    bit too."""
    mb = tmodels.build_qwen3_decode(seq_len=1, **TINY, qk_norm=True,
                                    kv_append=True, dtype=torch.bfloat16)
    ins, ws = tmodels.init_random_io(mb, np.random.default_rng(3))

    def walk(**kw):
        prog = mb.compile("kernel", device="cpu", n_sm=4, **kw)
        prog.bind_weights({k: torch.from_numpy(v).bfloat16()
                           for k, v in ws.items()})
        prog.bind_caches({k: torch.from_numpy(ins[k]).bfloat16()
                          for k in mb.graph.caches})
        outs = prog.step({"x": torch.from_numpy(ins["x"]).bfloat16()}, CL)
        return [o.clone() for o in outs] + list(prog.caches.values())

    for a, b in zip(walk(fuse_elementwise=True, fuse_kv_append=True),
                    walk()):
        assert torch.equal(a, b)


def test_fusion_refuses_a_program_past_the_skinny_rows():
    mb = tmodels.build_qwen3_decode(seq_len=9, **TINY, kv_append=True)
    for kw in ({"fuse_elementwise": True}, {"fuse_kv_append": True}):
        with pytest.raises(ValueError, match="at most 8 rows"):
            mb.compile("kernel", device="cpu", **kw)
    mb.compile("kernel", device="cpu")      # unfused: fine


def test_task_costs_count_fused_operands_once():
    """Each operand once: a fused program moves the unfused program's
    bytes less the round trips of the fused-away intermediates, and does
    its operations plus one norm a layer (ln2 is recomputed by both of
    its consumers)."""
    mb = tmodels.build_qwen3_decode(seq_len=1, **TINY, qk_norm=True,
                                    kv_append=True)
    plain = mb.compile("kernel", device="cpu", n_sm=4)
    fused = mb.compile("kernel", device="cpu", n_sm=4,
                       fuse_elementwise=True, fuse_kv_append=True)
    item, H, L = 4, TINY["hidden"], TINY["num_layers"]
    I, Hkv, D = TINY["intermediate"], TINY["num_kv_heads"], TINY["head_dim"]
    cp, cf = plain.task_costs(CL), fused.task_costs(CL)
    fb, pb = sum(c["bytes"] for c in cf), sum(c["bytes"] for c in cp)
    # a layer: each norm's output written and its input read again (ln1
    # 2H; ln2 3H less the weight read by its second consumer), each add's
    # two extra row reads and writes (2H twice), silu's output written
    # and read (2I), and the appends' qkv reads (2 Hkv D)
    saved = L * (2 * H + H + 2 * 2 * H + 2 * I + 2 * Hkv * D) * item
    assert pb - fb == saved, (pb, fb, saved)
    assert sum(c["flops"] for c in cf) \
        == sum(c["flops"] for c in cp) + L * 4 * H


def _dense(seed):
    cfg = models.get_config("Qwen/Qwen3-0.6B").tiny(**SHRINK)
    pm = models.DenseLLM(cfg, dtype="float32", device="cpu")
    return pm, pm.init_params(torch.Generator().manual_seed(seed))


def test_fused_megadecoder_equals_unfused():
    pm, pp = _dense(0)
    prompt = np.random.default_rng(5).integers(0, 128, 13).astype(np.int32)
    kw = dict(max_cache=32, prompt_len=13, prefill_chunk=8, device="cpu")
    base = port.MegaDecoder.from_dense(pm, pp, **kw)
    fused = port.MegaDecoder.from_dense(pm, pp, **kw, fuse_elementwise=True,
                                        fuse_kv_append=True)
    assert (fused.fuse_elementwise, fused.fuse_kv_append) == (True, True)
    L = pm.config.num_layers
    assert len(fused._prog_decode.tasks) == 6 * L + 1
    assert len(base._prog_decode.tasks) == 13 * L + 1
    # the prefill chunk program is the unfused one
    pa, pb = base._prog_prefill, fused._prog_prefill
    assert [nd.op for nd in pa.tasks] == [nd.op for nd in pb.tasks]
    assert pa.deps == pb.deps and pb.fusion == {}
    da, db = pa.descriptors()[0], pb.descriptors()[0]
    ptrs = [mkx.F_OUT, mkx.F_A, mkx.F_B, mkx.F_C, mkx.F_D, mkx.F_E,
            mkx.F_COS, mkx.F_SIN]
    keep = [f for f in range(mkx.NF) if f not in ptrs]
    np.testing.assert_array_equal(da[:, keep], db[:, keep])
    # one cache set, one weight set for both of the fused decoder's
    # programs
    for n, c in fused._prog_prefill.caches.items():
        assert fused._prog_decode.caches[n] is c
    toks = base.serve(prompt, 6)
    np.testing.assert_array_equal(fused.serve(prompt, 6), toks)
    rows = [md.teacher_forced(prompt, toks[:-1]) for md in (base, fused)]
    assert torch.equal(rows[0], rows[1])
    for n, c in base._prog_decode.caches.items():
        assert torch.equal(fused._prog_decode.caches[n], c)
