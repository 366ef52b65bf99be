"""The shared-UWB fleet rollout through the hand-written CUDA kernel K6.

The counterpart of the JAX package's `sim/fleet_env.py::uwb_fleet_rollout`
(jnp under jit and scan: it reaches no pallas_call). `rollout` runs
`csrc/fleet_uwb.cu` on CUDA tensors: one launch, one thread block, advances
the N vehicles (N <= `MAX_VEHICLES`, N + anchors <= `MAX_RADIOS`) and their
shared network through the noise block's n_steps ticks of
`fleet_env.uwb_fleet_step` and writes the final `UwbFleetState`. A group of
`GROUP` lanes runs each vehicle (the kernel is built for each of
`cuda_rollout.GROUPS`, and every group size gives the same values bit for
bit), and one more warp steps the network beside them. On CPU tensors it
runs the plain version, `fleet_env.uwb_fleet_rollout_plain`.

The vehicles' state and parameter leaves are `tick.cuh`'s tables (built
with TICK_RANGING and TICK_WIND: the env's leaves without a network of its
own, then the gust velocity and the WindParams); every call checks them in
full (a UWB fleet rollout is a long flight, so the check is not cached).
The network's parameters, the vehicles' radio ids and the anchors'
positions go to the kernel by value, packed on the host from host copies
made once per parameter tree.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from agrifly_tpu_torch import convert, cuda_build
from agrifly_tpu_torch.sim import cuda_rollout
from agrifly_tpu_torch.sim import env as env_mod

MAX_VEHICLES = 32  # fleet_uwb.cu's vehicle slots (one lane group each, one block)
MAX_RADIOS = cuda_rollout.MAX_RADIOS  # tick.cuh's radio table: vehicles and anchors
GROUP = 8  # lanes per vehicle by default
CTRL = cuda_rollout.CTRL
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
             + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_data_ptr = torch.Tensor.data_ptr


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = cuda_build.load("fleet_uwb").fleet_uwb_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*map(_data_ptr, tensors))


_host = {}  # the last parameter tree, its leaves' (pointer, version), and their host copies


def _host_params(params):
    """(vehicle parameter leaves, network parameter leaves with the radio
    table padded to MAX_RADIOS, vehicle ids, anchor positions) copied to the
    host, once per parameter tree (again after an in-place change to it)."""
    stamp = [(t.data_ptr(), t._version) for t in convert.flatten_tensors(params)[0]]
    entry = _host.get("params")
    if entry is not None and entry[0] is params and entry[1] == stamp:
        return entry[2]
    vehicle = convert.flatten_tensors(params.base)[0] + convert.flatten_tensors(params.wind)[0]
    net = [t.cpu() for t in cuda_rollout.param_leaves(params.uwb)]
    copies = ([t.cpu() for t in vehicle], net,
              params.vehicle_ids.to(torch.int32).cpu().contiguous(),
              params.anchor_positions.to(torch.float32).cpu().contiguous())
    _host["params"] = (params, stamp, copies)
    return copies


def _check(params, state, des_pos, noise, wind_noise, uwb_draws, ctrl_mode, device):
    """Every input as K6 takes it; returns (N, A)."""
    env_mod._check_modes(False, ctrl_mode)
    if params.base.uwb is not None or state.envs.uwb is not None:
        raise ValueError("a UWB fleet's vehicles carry no network of their own")
    N = state.wind_vel.shape[0]
    A = params.anchor_positions.shape[0]
    if not 1 <= N <= MAX_VEHICLES or N + A > MAX_RADIOS:
        raise ValueError(f"K6 flies 1..{MAX_VEHICLES} vehicles with at most {MAX_RADIOS} radios "
                         f"in all: got {N} vehicles and {A} anchors")
    if (tuple(params.vehicle_ids.shape) != (N,) or tuple(params.anchor_positions.shape) != (A, 3)
            or params.uwb.radio_ids.numel() > MAX_RADIOS):
        raise ValueError("UWB fleet params: vehicle_ids (N,), anchor_positions (A, 3) and a "
                         f"radio table of at most {MAX_RADIOS}")
    n = noise.shape[1] if noise.dim() == 4 else -1
    for name, t, shape in (("noise", noise, (N, n, 2, 3)), ("wind_noise", wind_noise, (n, N, 3)),
                           ("uwb_draws", uwb_draws, (n, 4)), ("des_pos", des_pos, (N, 3))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != device:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}; K6 takes "
                             f"float32 {shape} on {device}")
    specs, pspecs = cuda_rollout.leaf_table(wind=True)  # K6's vehicles: the wind build's leaves
    cuda_build.check_leaves(specs, convert.flatten_tensors(state.envs)[0] + [state.wind_vel],
                            device, "state", N, "tick.cuh")
    cuda_build.check_leaves(pspecs, convert.flatten_tensors(params.base)[0]
                            + convert.flatten_tensors(params.wind)[0], device, "params", None,
                            "tick.cuh")
    net = list(state.uwb) + [state.latch_start]
    want = [torch.int32, torch.bool, torch.int32, torch.int32, torch.int32]
    if any(t.dtype != d or t.dim() != 0 or t.device != device for t, d in zip(net, want)):
        raise ValueError("the network's state: acc_us, pending (bool), requester_id, "
                         f"responder_id and latch_start, 0-d int32 on {device}")
    return N, A


def rollout(params, state, des_pos, noise, wind_noise, uwb_draws, ctrl_mode="position",
            group=None, launcher=None):
    """Advance a shared-UWB fleet (`fleet_env.UwbFleetParams`,
    `UwbFleetState` of N vehicles) by the ticks of `noise` ((N, n_steps, 2,
    3) float32 IMU normals), `wind_noise` ((n_steps, N, 3) gust normals)
    and `uwb_draws` ((n_steps, 4), the network's draws), the offboard loop
    sending `ctrl_mode` commands to the setpoints des_pos ((N, 3), or a
    shared (3,)). Returns the final state.

    CUDA tensors launch K6 (or raise): one launch, counted in
    `rollout.launches`; `group` picks the lanes per vehicle (GROUP by
    default); `launcher`, another build's fleet_uwb_launch with the same C
    interface (chip_smoke.py's section timers and parent check). CPU tensors
    take `fleet_env.uwb_fleet_rollout_plain`."""
    from agrifly_tpu_torch.sim import fleet_env

    device = noise.device
    des_pos = torch.as_tensor(des_pos, dtype=torch.float32, device=device)
    des_pos = des_pos.expand(state.wind_vel.shape[0], 3).contiguous()
    N, A = _check(params, state, des_pos, noise, wind_noise, uwb_draws, ctrl_mode, device)
    if not noise.is_cuda:
        return fleet_env.uwb_fleet_rollout_plain(params, state, des_pos, noise, wind_noise,
                                                 uwb_draws, ctrl_mode)
    vehicle, net, ids, anchors = _host_params(params)
    leaves_in = convert.flatten_tensors(state.envs)[0] + [state.wind_vel]
    leaves_out = [torch.empty_like(t) for t in leaves_in]
    net_in = list(state.uwb) + [state.latch_start]
    net_out = [torch.empty_like(t) for t in net_in]
    inputs = [des_pos, noise.contiguous(), wind_noise.contiguous(), uwb_draws.contiguous()]
    stream = torch.cuda.current_stream(device).cuda_stream
    status = (launcher or _launcher())(
        _pointers(leaves_in), _pointers(leaves_out), _pointers(net_in), _pointers(net_out),
        _pointers(vehicle), _pointers(net), ids.data_ptr(), anchors.data_ptr(), N, A,
        *map(_data_ptr, inputs), noise.shape[1], CTRL[ctrl_mode],
        GROUP if group is None else group, stream)
    cuda_build.check(status, "fleet_uwb_launch")
    rollout.launches += 1
    envs = convert.flatten_tensors(state.envs)[1](leaves_out[:-1])
    return fleet_env.UwbFleetState(envs=envs, wind_vel=leaves_out[-1],
                                   uwb=type(state.uwb)(*net_out[:4]), latch_start=net_out[4])


rollout.launches = 0  # kernel launches since the last reset
