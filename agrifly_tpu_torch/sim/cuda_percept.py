"""The orchard frame's percept head through a hand-written CUDA kernel.

K9, `percept_head` (`csrc/frame.cu`, beside the tick kernel K3, whose state
and parameter pointer tables it shares): what `orchard_env._frame_percept`
computes before its render and its plan's rounds, which the JAX package
runs as jnp inside the frame's jit call (no `pallas_call`). A block a
vehicle: one thread runs the mocap estimator's prediction (tick.cuh's
`mocap_get_prediction`), the camera attitudes and frame and the waypoint
and landing switch; then a thread a candidate maps the uniform block to
samples and runs `candidates_from_samples`, `exploration_cost` and
`endpoint_seeds`. One launch for all B vehicles of a fleet.
`orchard_env.percept_head_plain` is the plain version.

CUDA tensors launch the kernel (or raise: a failed build or launch is never
replaced by the plain version); CPU tensors run the plain version. The
outputs are views of one float32, one int32 and one bool buffer, each
field contiguous. The launches are counted in `percept_head.launches`.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from agrifly_tpu_torch import convert, cuda_build
from agrifly_tpu_torch.planner import rappids, traj as traj_mod
from agrifly_tpu_torch.render import raycast
from agrifly_tpu_torch.sim import cuda_frame, orchard_env
from agrifly_tpu_torch.sim.mission import MAX_WAYPOINTS, WAYPOINT_RADIUS

_P = ctypes.c_void_p


class _HeadArgs(ctypes.Structure):  # frame.cu HeadArgs
    _fields_ = [("waypoints", _P), ("num_waypoints", _P), ("focal", _P), ("cx", _P),
                ("cy", _P), ("mount", ctypes.c_float * 4), ("waypoint_radius", ctypes.c_float),
                ("px0", ctypes.c_float), ("px_span", ctypes.c_float), ("py0", ctypes.c_float),
                ("py_span", ctypes.c_float), ("max_waypoints", ctypes.c_int),
                ("land", ctypes.c_int)]


_ARGTYPES = [_P, _P, _HeadArgs, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P]

# the per-vehicle float fields, in the kernel's order (frame.cu's kH* offsets)
HEAD_FIELDS = (("cam_att", 4), ("est_pos", 3), ("cam_att_est", 4), ("vel_cam", 3),
               ("acc_cam", 3), ("grav_cam", 3), ("goal_world", 3), ("goal_cam", 3),
               ("land_pos", 3))
HEAD_INTS = ("waypoint_idx", "mstage", "land_start_step")
CAND_VECTORS = ("alpha", "beta", "gamma", "a0", "v0", "p0")
CAND_SCALARS = ("tf", "traj_cost", "cost", "epx", "epy", "endz")


@functools.lru_cache(maxsize=None)
def _bind(lib: ctypes.CDLL):
    """`percept_head_launch` of a `frame.cu` library, its argument types set."""
    fn = lib.percept_head_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _f32(x: float) -> float:
    return float(np.float32(x))


def _head_args(params: orchard_env.OrchardEnvParams, keep):
    """The kernel's HeadArgs: the waypoints, the planner's camera, the mount
    and the sampler's float32 constants (the values torch rounds the
    python numbers of `samples_from_uniform` and the radius to)."""
    cam = params.planner.cam
    dev = params.waypoints.device
    for x, what in ((cam.focal, "cam.focal"), (cam.cx, "cam.cx"), (cam.cy, "cam.cy")):
        if x.dim() != 0 or x.dtype != torch.float32 or x.device != dev:
            raise ValueError(f"{what}: the kernel takes a 0-d float32 tensor on {dev}")
    wp = params.waypoints.contiguous()
    nwp = params.num_waypoints
    if tuple(wp.shape) != (MAX_WAYPOINTS, 3) or wp.dtype != torch.float32 \
            or nwp.dtype != torch.int32 or nwp.dim() != 0 or nwp.device != dev:
        raise ValueError("waypoints: need (MAX_WAYPOINTS, 3) float32 and a 0-d int32 count")
    keep.append(wp)
    mount = (ctypes.c_float * 4)(*(float(v) for v in raycast.DEPTH_CAM_Q))
    return _HeadArgs(wp.data_ptr(), nwp.data_ptr(), cam.focal.data_ptr(), cam.cx.data_ptr(),
                     cam.cy.data_ptr(), mount, _f32(WAYPOINT_RADIUS), _f32(0.1 * cam.width),
                     _f32(0.8 * cam.width), _f32(0.1 * cam.height), _f32(0.8 * cam.height),
                     MAX_WAYPOINTS, int(params.land))


def percept_head(params: orchard_env.OrchardEnvParams, state: orchard_env.OrchardEnvState, u):
    """`orchard_env.percept_head_plain(params, state, u)`: the frame's
    head for a state of leading vehicle shape L and the (*L, 4, N) uniform
    block u. On CUDA tensors one K9 launch, bit for bit the plain version on
    the card."""
    if not u.is_cuda:
        return orchard_env.percept_head_plain(params, state, u)
    return _launch(params, state, u)


def _launch(params, state, u):
    """One K9 launch (`percept_head`'s CUDA route)."""
    lead = tuple(state.base.step.shape)
    dev = u.device
    if len(lead) > 1 or u.dtype != torch.float32 or tuple(u.shape[:-1]) != lead + (4,):
        raise ValueError(f"u: need {lead + (4,)} + (N,) float32 for a state of leading shape "
                         f"{lead}, got {tuple(u.shape)} {u.dtype}")
    B, N = (lead[0] if lead else 1), u.shape[-1]
    leaves, _ = convert.flatten_tensors(state)
    pleaves = cuda_frame.param_leaves(params)
    state_specs, param_specs = cuda_frame.leaf_table()
    cuda_frame._check(state_specs, leaves, dev, "state", B if lead else None)
    cuda_frame._check(param_specs, pleaves, dev, "params")
    keep = []
    args = _head_args(params, keep)
    u = u.contiguous()
    n_f = sum(n for _, n in HEAD_FIELDS)
    out_f = torch.empty(B * n_f, dtype=torch.float32, device=dev)
    out_i = torch.empty(B * len(HEAD_INTS), dtype=torch.int32, device=dev)
    out_b = torch.empty(B, dtype=torch.bool, device=dev)
    cand = torch.empty(B * N * (3 * len(CAND_VECTORS) + len(CAND_SCALARS)), dtype=torch.float32,
                       device=dev)
    state_ptrs = (ctypes.c_void_p * len(leaves))(*[t.data_ptr() for t in leaves])
    param_ptrs = (ctypes.c_void_p * len(pleaves))(*[t.data_ptr() for t in pleaves])
    if N > 0:
        status = _bind(cuda_build.load("frame"))(
            state_ptrs, param_ptrs, args, u.data_ptr(), out_f.data_ptr(), out_i.data_ptr(),
            out_b.data_ptr(), cand.data_ptr(), B, N, torch.cuda.current_stream(dev).cuda_stream)
        cuda_build.check(status, "percept_head_launch")
        percept_head.launches += 1
    del keep
    return _views(out_f, out_i, out_b, cand, lead, B, N)


def _views(out_f, out_i, out_b, cand, lead, B, N):
    """The head's fields as views of the kernel's buffers, field-major."""
    fields, parts = {}, iter(out_f.split([B * n for _, n in HEAD_FIELDS]))
    for name, n in HEAD_FIELDS:
        fields[name] = next(parts).view(lead + (n,))
    for name, part in zip(HEAD_INTS, out_i.split(B)):
        fields[name] = part.view(lead)
    fields["in_flight"] = out_b.view(lead)
    n_vec = B * N * 3
    pieces = cand.split([n_vec] * len(CAND_VECTORS) + [B * N] * len(CAND_SCALARS))
    vec = {name: p.view(lead + (N, 3)) for name, p in zip(CAND_VECTORS, pieces)}
    sc = {name: p.view(lead + (N,)) for name, p in
          zip(CAND_SCALARS, pieces[len(CAND_VECTORS):])}
    tr = traj_mod.Traj(**vec, tf=sc["tf"], cost=sc["traj_cost"])
    fields["candidates"] = rappids.Candidates(tr, sc["cost"], sc["epx"], sc["epy"], sc["endz"])
    return orchard_env.PerceptHead(**fields)


percept_head.launches = 0  # K9 launches since the last reset
