"""The fused 16-tick block through the hand-written CUDA kernel.

Port of `agrifly_tpu/sim/pallas_frame.py::frame_ticks` and, for a fleet,
`frame_ticks_batched`. `frame_ticks` runs `csrc/frame.cu` on CUDA tensors:
one thread per vehicle advances the whole `OrchardEnvState` through the
ticks of one frame, one launch for all B vehicles of a fleet (state leaves
with a leading B axis, parameters shared). On CPU tensors it runs the plain
version, `orchard_env.frame_ticks_plain` (`frame_ticks_plain_fleet` for a
fleet).

The kernel reads each state and parameter leaf through its own device
pointer and writes the leaves the ticks change into three flat buffers
(float32, int32, bool); the returned leaves are views into them, and the
leaves the ticks never write are the input tensors. `frame.cu` declares
the leaves it reads, in order, in two X-macro tables; `leaf_table()`
parses them and every call is checked against them.
"""

from __future__ import annotations

import ctypes
import functools
import re
from typing import NamedTuple

import torch

from agrifly_tpu_torch import convert, cuda_build

_DTYPES = {"F32": torch.float32, "I32": torch.int32, "BOOL": torch.bool}
_ENTRY = re.compile(r'X\(\s*\w+,\s*"([\w.]+)",\s*(F32|I32|BOOL),\s*(\d+)\s*(?:,\s*([WP])\s*)?\)')
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


class LeafSpec(NamedTuple):
    path: tuple  # field names from OrchardEnvState / OrchardEnvParams
    dtype: torch.dtype
    numel: int  # 0 for a 0-d tensor
    written: bool  # the kernel writes it (W); else it passes through (P)


@functools.lru_cache(maxsize=None)
def leaf_table():
    """(state leaves, parameter leaves) as `frame.cu` declares them."""
    text = (cuda_build.CSRC / "frame.cu").read_text()
    state, params = [], []
    for path, ty, n, rw in _ENTRY.findall(text):
        spec = LeafSpec(tuple(path.split(".")), _DTYPES[ty], int(n), rw == "W")
        (state if rw else params).append(spec)
    return tuple(state), tuple(params)


def param_leaves(params):
    """The parameter tensors the kernel reads, in its table's order."""
    leaves, _ = convert.flatten_tensors(params.base)
    return leaves + [params.start_flight_step, params.takeoff_height, params.track_lookahead]


def _check(specs, leaves, device, what, B=None):
    """Every leaf as frame.cu declares it; B: a leading vehicle axis on
    every leaf (a 0-d leaf becomes (B,), an n-element one (B, ...) with
    B n elements), None for one vehicle's unbatched leaves."""
    if len(leaves) != len(specs):
        raise ValueError(f"{what}: {len(leaves)} leaves, frame.cu declares {len(specs)}")
    for spec, t in zip(specs, leaves):
        row = t if B is None else (t[0] if t.dim() > 0 and t.shape[0] == B else None)
        if (row is None or t.dtype != spec.dtype or t.device != device or not t.is_contiguous()
                or (row.dim() == 0) != (spec.numel == 0) or row.numel() != max(spec.numel, 1)):
            lead = "" if B is None else f"a leading {B} (the noise's B) and "
            raise ValueError(
                f"{what} leaf {'.'.join(spec.path)}: {t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous: {t.is_contiguous()}); frame.cu takes {spec.dtype}, "
                f"{lead}{spec.numel} elements, on {device}")


def _launch(leaves, pleaves, noise):
    """Run the kernel on B vehicles (noise (B, ticks, 2, 3)); returns the
    new state's leaves."""
    lib = cuda_build.load("frame")
    fn = lib.frame_ticks_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    specs, _ = leaf_table()
    dev = noise.device
    B = noise.shape[0]
    sizes = {ty: [B * max(s.numel, 1) for s in specs if s.written and s.dtype == ty]
             for ty in _DTYPES.values()}
    bufs = {ty: torch.empty(sum(n), dtype=ty, device=dev) for ty, n in sizes.items()}
    state_ptrs = (ctypes.c_void_p * len(leaves))(*[t.data_ptr() for t in leaves])
    param_ptrs = (ctypes.c_void_p * len(pleaves))(*[t.data_ptr() for t in pleaves])
    stream = torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else None
    status = fn(state_ptrs, param_ptrs, noise.data_ptr(), bufs[torch.float32].data_ptr(),
                bufs[torch.int32].data_ptr(), bufs[torch.bool].data_ptr(), B, noise.shape[1],
                stream)
    cuda_build.check(status, "frame_ticks_launch")
    frame_ticks.launches += 1
    parts = {ty: iter(bufs[ty].split(n)) for ty, n in sizes.items()}
    return [next(parts[s.dtype]).view(t.shape) if s.written else t
            for s, t in zip(specs, leaves)]


def frame_ticks(params, state, noise):
    """Advance `state` (an `orchard_env.OrchardEnvState`) by the ticks of
    one frame. One vehicle: noise (ticks, 2, 3); a fleet of B: noise
    (B, ticks, 2, 3) and a leading B on every state leaf. float32 unit
    normals (gyro, acc).

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version. Every call is checked against frame.cu's leaf tables."""
    if (noise.dim() not in (3, 4) or tuple(noise.shape[-2:]) != (2, 3)
            or noise.dtype != torch.float32):
        raise ValueError(f"need ([B,] ticks, 2, 3) float32 noise, got {tuple(noise.shape)} "
                         f"{noise.dtype}")
    fleet = noise.dim() == 4
    leaves, rebuild = convert.flatten_tensors(state)
    pleaves = param_leaves(params)
    state_specs, param_specs = leaf_table()
    _check(state_specs, leaves, noise.device, "state", noise.shape[0] if fleet else None)
    _check(param_specs, pleaves, noise.device, "params")
    if not noise.is_cuda:
        from agrifly_tpu_torch.sim import orchard_env

        return orchard_env.frame_ticks(params._replace(fused_ticks=False), state, noise)
    return rebuild(_launch(leaves, pleaves, (noise if fleet else noise[None]).contiguous()))


frame_ticks.launches = 0  # kernel launches since the last reset
