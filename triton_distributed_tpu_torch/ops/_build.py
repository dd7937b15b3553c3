"""Build the port's hand-written CUDA kernels and load them with ctypes.

Each `csrc/<name>.cu` is compiled by its own `nvcc` process into
`<name>.so`, a shared library with a plain C interface; all sources are
compiled at once, in parallel, at the first launch of any kernel (or by
an explicit `build_all()`). The libraries go to `csrc/build/<hash>/`,
keyed by a hash of every source and of the compiler flags, so an edited
source rebuilds by itself and an unchanged one is reused; nvcc's output
(ptxas register and spill counts) is kept beside each as `<name>.log`.
Delete `csrc/build/` to force a rebuild.

Every C entry point returns `cudaGetLastError()` after its launch; a
`CudaKernel` raises on a non-zero code and counts its launches, so a run
can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(pathlib.Path(os.environ["CUDA_HOME"]) / "bin/nvcc")
    candidates.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found in $CUDA_HOME/bin, /usr/local/cuda/bin or "
            "PATH: the CUDA kernels cannot be built")
    return found


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> float:
    """Compile every source whose library is missing, one nvcc process
    per source, all started together. Returns the seconds spent."""
    out_dir = build_dir()
    todo = [s for s in sources() if not (out_dir / f"{s.stem}.so").exists()]
    if not todo:
        return 0.0
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in todo:
        tmp = out_dir / f"{src.stem}.so.tmp{os.getpid()}"
        log = open(out_dir / f"{src.stem}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((src, tmp, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for src, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{src.name} (rc {rc}):\n"
                          + (out_dir / f"{src.stem}.log").read_text()[-4000:])
        else:
            os.replace(tmp, out_dir / f"{src.stem}.so")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


_LIBS: dict = {}


def load_library(source: str) -> ctypes.CDLL:
    """The ctypes library of `csrc/<source>.cu`, built (with every other
    source) and loaded on first use."""
    if source not in _LIBS:
        build_all()
        _LIBS[source] = ctypes.CDLL(str(build_dir() / f"{source}.so"))
    return _LIBS[source]


class CudaKernel:
    """One C entry point of one `csrc/<source>.cu` library.

    `launch(*args)` builds and loads the library on first use, calls the
    entry point (which launches on the stream passed to it and returns
    `cudaGetLastError()`), raises if that is not 0, and adds one to
    `launches`."""

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._lib = None

    def _load(self):
        if self._fn is None:
            lib = load_library(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            lib.tdt_error_string.argtypes = [ctypes.c_int]
            lib.tdt_error_string.restype = ctypes.c_char_p
            self._lib, self._fn = lib, fn
        return self._fn

    def launch(self, *args) -> None:
        rc = self._load()(*args)
        if rc != 0:
            msg = self._lib.tdt_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {rc}: {msg}")
        self.launches += 1


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
