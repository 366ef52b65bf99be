"""Build and load the package's CUDA kernels.

Each kernel is one `csrc/<name>.cu` file with a plain C interface (the
tick kernels share the device functions of `csrc/tick.cuh`). On first use
`load(name)` compiles it with nvcc for Hopper (sm_90a) into
`agrifly_tpu_torch/_build/lib<name>.so` and opens it with ctypes. A library
newer than its source and every `csrc/*.cuh` header is reused.
`load(name, defines)` builds a variant of the same source with those
macros defined (`lib<name>-<DEFINE>.so`).

The flags keep float32 arithmetic IEEE-exact: no fast math, and
`-fmad=false` so nvcc does not contract a*b+c into one rounding. The plain
PyTorch versions round every product separately, and a contraction moves a
ray's t by an ulp, which flips depth codes at quantization edges.
`-Xptxas -v` makes ptxas report each kernel's registers, shared memory and
spills; `build_logs` keeps that report per library.
"""

from __future__ import annotations

import ctypes
import functools
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]

# seconds spent compiling, and nvcc's report, per kernel, in this process
build_seconds: dict = {}
build_logs: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(path)


def _compile(src: Path, lib: Path, defines: tuple = ()) -> None:
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent load never sees half a file
    build_seconds[lib.stem[3:]] = time.perf_counter() - t0
    build_logs[lib.stem[3:]] = proc.stderr + proc.stdout


@functools.lru_cache(maxsize=None)
def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """The compiled kernel library `name` (with the macros `defines`
    defined), built on first use."""
    src = CSRC / f"{name}.cu"
    lib = BUILD / f"lib{'-'.join((name, *defines))}.so"
    newest = max(p.stat().st_mtime for p in (src, *CSRC.glob("*.cuh")))
    if not lib.exists() or lib.stat().st_mtime < newest:
        _compile(src, lib, defines)
    return ctypes.CDLL(str(lib))


def check(status: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch function."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {status}")


class LeafSpec(NamedTuple):
    path: tuple  # field names from the state or parameter NamedTuple
    dtype: torch.dtype
    numel: int  # 0 for a 0-d tensor
    written: bool  # the kernel writes it (W); else it passes through (P)


_DTYPES = {"F32": torch.float32, "I32": torch.int32, "BOOL": torch.bool}
_TABLE = re.compile(r"#define (\w+)\(X\)((?:[^\n]*\\\n)*[^\n]*)")
_ENTRY = re.compile(r'X\(\s*\w+,\s*"([\w.]+)",\s*(F32|I32|BOOL),\s*(\d+)\s*(?:,\s*([WP])\s*)?\)')


def leaf_rows(source: str, prefix: tuple = (), uwb: bool = False, wind: bool = False):
    """(state leaves, parameter leaves) that the X-macro tables of
    `csrc/<source>` declare, in order: a state row names W or P, a
    parameter row neither. prefix: field names put before every path.
    uwb / wind: also the rows of the tables whose names hold UWB / WIND
    (the variants' leaves; tick.cuh's ENV_UWB_* and ENV_WIND_* tables)."""
    state, params = [], []
    src = (CSRC / source).read_text()
    for name, body in _TABLE.findall(src):
        if ("UWB" in name and not uwb) or ("WIND" in name and not wind):
            continue
        for path, ty, n, rw in _ENTRY.findall(body):
            spec = LeafSpec(prefix + tuple(path.split(".")), _DTYPES[ty], int(n), rw == "W")
            (state if rw else params).append(spec)
    return state, params


def check_leaves(specs, leaves, device, what, B, source):
    """Every leaf as `source` declares it; B: a leading axis on every leaf
    (a 0-d leaf becomes (B,), an n-element one (B, ...) with B n elements),
    None for unbatched leaves."""
    if len(leaves) != len(specs):
        raise ValueError(f"{what}: {len(leaves)} leaves, {source} declares {len(specs)}")
    lead = 0 if B is None else 1
    for spec, t in zip(specs, leaves):
        if ((B is not None and (t.dim() == 0 or t.shape[0] != B)) or t.dtype != spec.dtype
                or t.device != device or not t.is_contiguous()
                or (t.dim() == lead) != (spec.numel == 0)
                or t.numel() != (B or 1) * max(spec.numel, 1)):
            rows = "" if B is None else f"a leading {B} (the noise's B) and "
            raise ValueError(
                f"{what} leaf {'.'.join(spec.path)}: {t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous: {t.is_contiguous()}); {source} takes {spec.dtype}, "
                f"{rows}{spec.numel} elements, on {device}")
