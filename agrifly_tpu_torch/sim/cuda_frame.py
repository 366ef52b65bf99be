"""The fused 16-tick block through the hand-written CUDA kernel.

Port of `agrifly_tpu/sim/pallas_frame.py::frame_ticks` and, for a fleet,
`frame_ticks_batched`. `frame_ticks` runs `csrc/frame.cu` on CUDA tensors:
one warp per vehicle advances the whole `OrchardEnvState` through the
ticks of one frame (its lane 0 runs the tick chain, lanes 1-9 the mocap
replay's per-segment work), one launch for all B vehicles of a fleet
(state leaves with a leading B axis, parameters shared). On CPU tensors it runs the plain
version, `orchard_env.frame_ticks_plain` (`frame_ticks_plain_fleet` for a
fleet).

The kernel reads each state and parameter leaf through its own device
pointer (the warp's lanes copy a vehicle's leaves into shared memory
together) and writes the leaves the ticks change into three flat buffers
(float32, int32, bool); the returned leaves are views into them, and the
leaves the ticks never write are the input tensors. `tick.cuh` (the env's
leaves, under `base`) and `frame.cu` (the orchard's) declare the leaves it
reads, in order, in X-macro tables; `leaf_table()` parses them and every
call is checked against them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from agrifly_tpu_torch import convert, cuda_build

_DTYPES = cuda_build._DTYPES
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def leaf_table():
    """(state leaves, parameter leaves) as `frame.cu` declares them: the
    env's leaves of `tick.cuh` under `base`, then the orchard's own."""
    env_state, env_params = cuda_build.leaf_rows("tick.cuh", ("base",))
    state, params = cuda_build.leaf_rows("frame.cu")
    return tuple(env_state + state), tuple(env_params + params)


def param_leaves(params):
    """The parameter tensors the kernel reads, in its table's order."""
    leaves, _ = convert.flatten_tensors(params.base)
    return leaves + [params.start_flight_step, params.takeoff_height, params.track_lookahead]


def _check(specs, leaves, device, what, B=None):
    """Every leaf as frame.cu declares it; B: a leading vehicle axis on
    every leaf, None for one vehicle's unbatched leaves."""
    cuda_build.check_leaves(specs, leaves, device, what, B, "frame.cu")


def _launch(leaves, pleaves, noise, launcher=None):
    """Run the kernel on B vehicles (noise (B, ticks, 2, 3)) through
    `launcher` (frame.cu's frame_ticks_launch by default, or another build's
    with the same C interface); returns the new state's leaves."""
    fn = launcher
    if fn is None:
        fn = cuda_build.load("frame").frame_ticks_launch
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
