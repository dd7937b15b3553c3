"""The port's public names against the JAX package's: every name that a
JAX package exports (its `__init__`'s imports) or a JAX module defines (its
public classes and functions), and that the port has ported, imports from
the port's module of the same path; the names still to port are listed
here (ROADMAP.md, Queue A 5). The JAX sources are read, not imported.
"""

import ast
import importlib
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

# module path (under each package) -> the JAX names the port does not have
UNPORTED = {
    "layers": {"PPComm", "gpipe_apply"},
    "ops.attention": {"certify_paged_decode_bytes", "flash_decode_paged_xla",
                      "paged_decode_kv_read_bytes", "paged_kv_block_map",
                      "paged_kv_scale_map"},
    "ops.sp_attention": {"ring_attention_2d", "ring_attention_2d_shard"},
    "ops.sp_ag_attention": set(),
    "ops.ulysses": set(),
    "ops.collectives": set(),
    "ops.collectives.all_gather": set(),
    "ops.collectives.reduce_scatter": set(),
    "ops.collectives.all_reduce": set(),
    "ops.collectives.all_to_all": set(),
}


def _jax_public_names(mod: str) -> set:
    base = REPO / "triton_distributed_tpu" / mod.replace(".", "/")
    if base.is_dir():
        kinds, path = (ast.ImportFrom,), base / "__init__.py"
    else:
        kinds, path = (ast.FunctionDef, ast.ClassDef), base.with_suffix(".py")
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom) and isinstance(node, kinds):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, kinds):
            names.add(node.name)
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("mod", list(UNPORTED))
def test_ported_names_import_from_the_port(mod):
    jax_names = _jax_public_names(mod)
    unported = UNPORTED[mod]
    assert jax_names and unported <= jax_names, unported - jax_names
    port = importlib.import_module(f"triton_distributed_tpu_torch.{mod}")
    missing = sorted(n for n in jax_names - unported if not hasattr(port, n))
    assert not missing, f"{mod}: {missing} not importable from the port"
    stale = sorted(n for n in unported if hasattr(port, n))
    assert not stale, f"{mod}: {stale} are ported; take them off UNPORTED"


def test_tp_moe_is_exported_from_the_layers_package():
    from triton_distributed_tpu_torch.layers import TPMoE
    from triton_distributed_tpu_torch.layers.tp_moe import TPMoE as direct
    assert TPMoE is direct
