"""The env rollout through the hand-written CUDA kernel K5.

The counterpart of the JAX package's `jax.vmap` of `sim/env.py::rollout_fast`
(jnp under jit, vmap and scan: it reaches no pallas_call), the workload
`bench.py` times. `rollout` runs `csrc/rollout.cu` on CUDA tensors: one
launch advances B envs (a leading B on every state leaf, or one env)
through the noise block's n_steps ticks of `env.step` and writes the final
state and the (B, n_steps, ...) `StepOutputs` trajectory. The kernel takes
each tick's cadences from the accumulators, as `env.rollout` does, so it
serves `env.rollout` and `env.rollout_fast` alike. On CPU tensors it runs
the plain version: `env.rollout_plain`, with `env.fast_flags` for
`rollout_fast`.

The kernel reads each state and parameter leaf through its own device
pointer and writes the state leaves a rollout changes into three flat
buffers (float32, int32, bool); the returned leaves are views into them,
and the leaves it never writes (the GPS-IMU estimator's) are the input
tensors. `tick.cuh` declares the leaves in two X-macro tables; every call
is checked against them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from agrifly_tpu_torch import convert, cuda_build
from agrifly_tpu_torch.sim import env as env_mod

CTRL = {"rates": 0, "position": 1, "idle": 2}
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def leaf_table():
    """(state leaves, parameter leaves) as `tick.cuh` declares them."""
    state, params = cuda_build.leaf_rows("tick.cuh")
    return tuple(state), tuple(params)


def param_leaves(params):
    """The parameter tensors the kernel reads, in its table's order."""
    return convert.flatten_tensors(params)[0]


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = cuda_build.load("rollout").env_rollout_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _written_sizes(B):
    """Elements of each written leaf for B envs, by dtype, in table order."""
    specs, _ = leaf_table()
    return {ty: [B * max(s.numel, 1) for s in specs if s.written and s.dtype == ty]
            for ty in cuda_build._DTYPES.values()}


def _launch(leaves, pleaves, cmd, noise, mocap, ctrl):
    """Run the kernel on B envs (cmd leaves (B, ...), noise (B, n_steps,
    2, 3)); returns (the new state's leaves, the trajectory's leaves)."""
    fn = _launcher()
    specs, _ = leaf_table()
    dev = noise.device
    B, n = noise.shape[:2]
    sizes = _written_sizes(B)
    bufs = {ty: torch.empty(sum(n_), dtype=ty, device=dev) for ty, n_ in sizes.items()}
    traj_f = [torch.empty((B, n, k), dtype=torch.float32, device=dev) for k in (3, 3, 4, 3, 4)]
    traj_i = [torch.empty((B, n), dtype=torch.int32, device=dev) for _ in range(3)]
    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])  # noqa: E731
    stream = torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else None
    status = fn(ptrs(leaves), ptrs(pleaves), ptrs(cmd), noise.data_ptr(),
                bufs[torch.float32].data_ptr(), bufs[torch.int32].data_ptr(),
                bufs[torch.bool].data_ptr(), ptrs(traj_f), ptrs(traj_i), B, n, int(mocap),
                CTRL[ctrl], stream)
    cuda_build.check(status, "env_rollout_launch")
    rollout.launches += 1
    parts = {ty: iter(bufs[ty].split(n_)) for ty, n_ in sizes.items()}
    new = [next(parts[s.dtype]).view(t.shape) if s.written else t for s, t in zip(specs, leaves)]
    return new, traj_f + traj_i


def _check_command(cmd, B, device):
    for name, t, base in zip(env_mod.Command._fields, cmd, env_mod._BASE_DIMS):
        if (t.dtype != torch.float32 or t.device != device or not t.is_contiguous()
                or tuple(t.shape[1:]) != (3,) * base or t.shape[0] != B):
            raise ValueError(f"command leaf {name}: {t.dtype} {tuple(t.shape)} on {t.device}; "
                             f"rollout.cu takes float32 ({B}{', 3' * base}) on {device}")


def rollout(params, state, cmd, noise, use_estimator=False, ctrl_mode="rates", fast=False,
            entry_phase=None):
    """Advance `state` (an `env.EnvState`, one env or a fleet of B) by the
    ticks of `noise` ((n_steps, 2, 3), a fleet (B, n_steps, 2, 3), float32
    unit normals: gyro, acc) under the command `cmd` (leaves shared or with
    a leading B). Returns (state, traj) as `env.rollout` does.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version (fast: `rollout_fast`'s, with entry_phase). Every call is
    checked against tick.cuh's leaf tables."""
    mode = env_mod._check_modes(use_estimator, ctrl_mode)
    B = env_mod._fleet_size(state)
    n_dims = 3 if B is None else 4
    if (noise.dim() != n_dims or tuple(noise.shape[-2:]) != (2, 3)
            or noise.dtype != torch.float32 or (B is not None and noise.shape[0] != B)):
        raise ValueError(f"need {'' if B is None else f'({B}, '}n_steps, 2, 3) float32 noise, "
                         f"got {tuple(noise.shape)} {noise.dtype}")
    leaves, rebuild = convert.flatten_tensors(state)
    pleaves = param_leaves(params)
    state_specs, param_specs = leaf_table()
    device = noise.device
    cuda_build.check_leaves(state_specs, leaves, device, "state", B, "tick.cuh")
    cuda_build.check_leaves(param_specs, pleaves, device, "params", None, "tick.cuh")
    if not noise.is_cuda:
        flags = env_mod.fast_flags(params, state, noise.shape[-3], entry_phase) if fast else None
        return env_mod.rollout_plain(params, state, cmd, noise, use_estimator, ctrl_mode, flags)

    n = 1 if B is None else B
    cmd_b = env_mod._fleet_command(cmd, n)
    cmd_b = [t.contiguous() for t in cmd_b]
    _check_command(cmd_b, n, device)
    rows = leaves if B is not None else [t[None] for t in leaves]
    noise = noise.contiguous()
    new, traj = _launch(rows, pleaves, cmd_b, noise if B is not None else noise[None],
                        mode == "mocap", ctrl_mode)
    if B is None:
        new = [t.view(old.shape) if t is not old_row else old
               for t, old, old_row in zip(new, leaves, rows)]
        traj = [t[0] for t in traj]
    return rebuild(new), env_mod.StepOutputs(*traj)


rollout.launches = 0  # kernel launches since the last reset
