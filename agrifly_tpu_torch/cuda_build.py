"""Build and load the package's CUDA kernels.

Each kernel is one `csrc/<name>.cu` file with a plain C interface. On first
use `load(name)` compiles it with nvcc for Hopper (sm_90a) into
`agrifly_tpu_torch/_build/lib<name>.so` and opens it with ctypes. A library
newer than its source is reused.

The flags keep float32 arithmetic IEEE-exact: no fast math, and
`-fmad=false` so nvcc does not contract a*b+c into one rounding. The plain
PyTorch versions round every product separately, and a contraction moves a
ray's t by an ulp, which flips depth codes at quantization edges.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

# seconds spent compiling, per kernel, in this process
build_seconds: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(path)


def _compile(src: Path, lib: Path) -> None:
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent load never sees half a file
    build_seconds[src.stem] = time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The compiled kernel library `name`, built on first use."""
    src = CSRC / f"{name}.cu"
    lib = BUILD / f"lib{name}.so"
    if not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime:
        _compile(src, lib)
    return ctypes.CDLL(str(lib))


def check(status: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch function."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {status}")
