"""The PyTorch port stands alone: it imports neither jax nor the JAX
package, and its entry points refuse to run on a CPU they were not given.
"""

import importlib
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import triton_distributed_tpu_torch as port
from triton_distributed_tpu_torch import models, runtime

REPO = pathlib.Path(__file__).resolve().parent.parent

# Blocks `jax`, `jaxlib` and exactly `triton_distributed_tpu` (with its
# submodules), never `triton_distributed_tpu_torch`, then imports every
# module of the port and checks no blocked module was loaded.
_ISOLATED_IMPORT = r"""
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "triton_distributed_tpu")

def blocked(name):
    return name.split(".")[0] in BLOCKED

class Block:
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import triton_distributed_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
assert not [m for m in sys.modules if blocked(m)]
print(len(names))
"""

_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|triton_distributed_tpu)(\.|\s|$)",
    re.MULTILINE)


def test_port_imports_with_jax_and_the_jax_package_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _ISOLATED_IMPORT], cwd=REPO, check=True,
        capture_output=True, text=True, timeout=120)
    assert int(out.stdout.strip()) >= 12    # every module was imported


def test_no_port_source_imports_jax():
    files = sorted((REPO / "triton_distributed_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "tests/test_torch_cuda.py"]
    assert len(files) > 10
    for f in files:
        assert not _FORBIDDEN.search(f.read_text()), f
    # the pattern matches the JAX package's exact name only
    assert _FORBIDDEN.search("from triton_distributed_tpu.ops import x")
    assert not _FORBIDDEN.search("from triton_distributed_tpu_torch import x")


def test_default_device_is_the_gpu_or_raises():
    if torch.cuda.is_available():
        assert runtime.default_device() == torch.device("cuda")
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runtime.default_device()
    with pytest.raises(RuntimeError):
        models.DenseLLM(models.get_config("Qwen3-8B").tiny())
    with pytest.raises(RuntimeError):
        models.params_from_jax({})


def test_runtime_helpers():
    assert runtime.round_up(10, 8) == 16 and runtime.cdiv(17, 8) == 3
    assert runtime.resolve_dtype("bfloat16") is torch.bfloat16
    assert runtime.resolve_dtype(torch.float32) is torch.float32
    with pytest.raises(ValueError):
        runtime.resolve_dtype("float64")
    assert importlib.import_module(port.__name__).__version__
