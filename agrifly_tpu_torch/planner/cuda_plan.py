"""The planner's candidate pass through the hand-written CUDA kernels.

`csrc/plan.cu` holds two kernels that the JAX package runs as jnp inside
the frame's jit call (no `pallas_call`):

- K7, `collision_check`: the pyramid collision check of (*L, N) candidates
  against their vehicle's pyramid set (`rappids.collision_check_plain` is
  the plain version): one launch for every vehicle and candidate, a warp a
  candidate (its five monotone sections' chains side by side, replayed in
  order; one face a lane; the pyramid search a ballot).
- K8, `plan_gates`: the input-feasibility bisection and the velocity proof
  (`traj.check_input_feasibility` and `traj.check_velocity_feasibility` are
  the plain versions): one launch gives both masks, four lanes a candidate
  (an axis a lane).

CUDA tensors launch the kernel (or raise: a failed build or launch is never
replaced by the plain version); CPU tensors run the plain versions. Nothing
is read back to the host. Each wrapper counts its launches in `.launches`.
A library's launch functions are bound once (`bind`), and the wrappers pass
a tensor that is already laid out as the kernel reads it without a view.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from agrifly_tpu_torch import cuda_build
from agrifly_tpu_torch.planner import rappids, traj as traj_mod

_P = ctypes.c_void_p


class _Field(ctypes.Structure):  # plan.cu Field
    _fields_ = [("p", _P), ("sv", ctypes.c_longlong), ("sn", ctypes.c_longlong)]


_TRAJ_FIELDS = ("alpha", "beta", "gamma", "a0", "v0", "p0", "tf")


class _Traj(ctypes.Structure):  # plan.cu TrajArgs
    _fields_ = [(name, _Field) for name in _TRAJ_FIELDS]


class _Cam(ctypes.Structure):  # plan.cu CamArgs
    _fields_ = [(name, _P) for name in ("focal", "cx", "cy", "min_check_dist")]


class _Pyr(ctypes.Structure):  # plan.cu PyrArgs
    _fields_ = [(name, _P) for name in ("depth", "bounds", "normals", "valid")]


class _CheckOut(ctypes.Structure):  # plan.cu CheckOut
    _fields_ = [(name, _P) for name in ("free", "fail_px", "fail_py", "fail_depth", "pops")]


class _Gates(ctypes.Structure):  # plan.cu GateArgs
    _fields_ = [("grav", _P), ("grav_sv", ctypes.c_longlong), ("fmin", _P), ("fmax", _P),
                ("wmax", _P), ("vmax", _P), ("min_section_time", ctypes.c_float),
                ("last_level", ctypes.c_int), ("strict", ctypes.c_int)]


class _GateOut(ctypes.Structure):  # plan.cu GateOut
    _fields_ = [(name, _P) for name in ("feas", "vel_ok", "sections")]


_SIGNATURES = {
    "collision_check_launch": [_Traj, _Pyr, _P, _Cam, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               _CheckOut, _P],
    "plan_gates_launch": [_Traj, _Gates, ctypes.c_int, ctypes.c_int, _GateOut, _P],
}


@functools.lru_cache(maxsize=None)
def bind(lib: ctypes.CDLL, name: str):
    """The launch function `name` of a `plan.cu` library with its argument
    types set, bound once per library."""
    fn = getattr(lib, name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def _fn(name: str):
    return bind(cuda_build.load("plan"), name)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _rows(x, lead, inner=()):
    """x broadcast to lead + inner and viewed as (B, *inner) (B the product
    of lead), its last axis contiguous; a copy only where no view exists."""
    x = x.expand(tuple(lead) + tuple(inner))
    shape = (math.prod(lead),) + tuple(inner)
    try:
        v = x.view(shape)
    except RuntimeError:
        v = x.contiguous().view(shape)
    if inner and v.stride(-1) != 1:
        v = v.contiguous()
    return v


def _laid_out(x, lead, inner, contiguous=False):
    """x read as (B, *inner): (the tensor the kernel reads, its element
    strides), x itself where it already is so (a leading shape of one axis
    or none; a vehicle stride 0 where there is none), else `_rows`' view or
    copy: each view costs the launch microseconds of host time. contiguous:
    the kernel takes it contiguous."""
    if (len(lead) <= 1 and x.shape == tuple(lead) + tuple(inner)
            and (x.is_contiguous() if contiguous else not inner or x.stride(-1) == 1)):
        st = x.stride()
        return x, ((st[0],) if lead else (0,)) + st[len(lead):]
    v = _rows(x, lead, inner)
    if contiguous:
        v = v.contiguous()
    return v, v.stride()


def _traj_args(tr: traj_mod.Traj, dev):
    """The kernels' TrajArgs for (*L, N) candidates, and the views it points
    into (kept alive by the caller until the launch is queued)."""
    lead, N = tuple(tr.tf.shape[:-1]), tr.tf.shape[-1]
    keep, fields = [], {}
    for name in _TRAJ_FIELDS:
        x = getattr(tr, name)
        if x.dtype != torch.float32 or x.device != dev:
            raise ValueError(f"traj.{name}: {x.dtype} on {x.device}; the kernels take float32 "
                             f"on {dev}")
        v, st = _laid_out(x, lead, (N,) if name == "tf" else (N, 3))
        fields[name] = _Field(v.data_ptr(), st[0], st[1])
        keep.append(v)
    return _Traj(**fields), keep


def _scalar_ptr(x, what, dev):
    if not (isinstance(x, torch.Tensor) and x.dim() == 0 and x.dtype == torch.float32
            and x.device == dev):
        raise ValueError(f"{what}: the kernel takes a 0-d float32 tensor on {dev}, got "
                         f"{x!r:.80}")
    return x.data_ptr()


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def collision_check(params: rappids.PlannerParams, pyrs: rappids.PyramidSet,
                    tr: traj_mod.Traj, enabled=None, pops=None):
    """`rappids.collision_check_plain`'s contract for (*L, N) candidates
    against pyramid sets of leading shape L: (free, fail_px, fail_py,
    fail_depth), each (*L, N). enabled: (*L, N) bool, None for every
    candidate. On CUDA tensors one K7 launch, bit for bit the plain version
    on the card. pops, an int32 (*L, N) tensor on the tensors' device,
    receives each candidate's popped sections (the work the check did)."""
    if not tr.tf.is_cuda:
        if enabled is None:
            enabled = torch.ones(tr.tf.shape, dtype=torch.bool, device=tr.tf.device)
        return rappids.collision_check_plain(params, pyrs, tr, enabled, pops)
    return _launch_check(params, pyrs, tr, enabled, pops)


def _launch_check(params, pyrs, tr, enabled=None, pops=None, launcher=None):
    """One K7 launch on the tensors' device (`collision_check`'s CUDA route);
    launcher: another build's `collision_check_launch` (`bind`)."""
    dev = tr.tf.device
    lead, N = tuple(tr.tf.shape[:-1]), tr.tf.shape[-1]
    P = pyrs.depth.shape[-1]
    free = torch.empty(lead + (N,), dtype=torch.bool, device=dev)
    fail = torch.empty((3,) + lead + (N,), dtype=torch.float32, device=dev)
    B = math.prod(lead)
    if B == 0 or N == 0:
        return (free, *fail.unbind(0))
    targs, keep = _traj_args(tr, dev)
    pyr = [_laid_out(x, lead, inner, contiguous=True)[0] for x, inner in
           zip(pyrs, ((P,), (P, 4), (P, 4, 3), (P,)))]
    for v, dtype, name in zip(pyr, (torch.float32,) * 3 + (torch.bool,),
                              ("depth", "bounds", "normals", "valid")):
        if v.dtype != dtype or v.device != dev:
            raise ValueError(f"pyrs.{name}: {v.dtype} on {v.device}; the kernel takes {dtype} "
                             f"on {dev}")
    if enabled is not None:
        if enabled.dtype != torch.bool or enabled.device != dev:
            raise ValueError(f"enabled: {enabled.dtype} on {enabled.device}; the kernel takes "
                             f"bool on {dev}")
        enabled = _laid_out(enabled, lead, (N,), contiguous=True)[0]
    if pops is not None and (pops.dtype != torch.int32 or pops.device != dev
                             or tuple(pops.shape) != lead + (N,) or not pops.is_contiguous()):
        raise ValueError(f"pops: need a contiguous int32 {lead + (N,)} tensor on {dev}")
    cam = params.cam
    cargs = _Cam(_scalar_ptr(cam.focal, "cam.focal", dev), _scalar_ptr(cam.cx, "cam.cx", dev),
                 _scalar_ptr(cam.cy, "cam.cy", dev),
                 _scalar_ptr(params.min_check_dist, "min_check_dist", dev))
    f0 = fail.data_ptr()
    out = _CheckOut(free.data_ptr(), f0, f0 + 4 * B * N, f0 + 8 * B * N, _ptr(pops))
    status = (launcher or _fn("collision_check_launch"))(
        targs, _Pyr(*(v.data_ptr() for v in pyr)), _ptr(enabled), cargs, B, N, P, out,
        _stream(dev))
    cuda_build.check(status, "collision_check_launch")
    collision_check.launches += 1
    del keep
    return (free, *fail.unbind(0))


collision_check.launches = 0  # K7 launches since the last reset


def last_level(max_depth: int, static_max_tf, min_section_time: float) -> int:
    """The deepest dyadic level `traj.check_input_feasibility` evaluates:
    max_depth, or the level before the first whose sections are provably
    too narrow (static_max_tf / 2^level < min_section_time; -1 at level 0)."""
    for level in range(max_depth + 1):
        if static_max_tf is not None and static_max_tf / (1 << level) < min_section_time:
            return level - 1
    return max_depth


def plan_gates(tr: traj_mod.Traj, grav, fmin, fmax, wmax, min_section_time, vmax,
               static_max_tf=None, max_depth: int = 9, strict_degenerate: bool = True,
               sections=None):
    """(feas, vel_ok), each (*L, N) bool: `traj.check_input_feasibility(tr,
    grav, fmin, fmax, wmax, min_section_time, max_depth, static_max_tf)` and
    `traj.check_velocity_feasibility(tr, vmax, strict_degenerate)` for
    (*L, N) candidates, grav broadcastable to (*L, 1, 3) (their vectors'
    shape, one gravity a vehicle: (3,), or (*L, 1, 3)). On CUDA tensors one
    K8 launch, bit for bit the plain versions on the card; fmin, fmax, wmax
    and vmax are then 0-d float32 tensors on the card (the planner's
    parameters), min_section_time a python number. sections, an int32
    (*L, N) tensor on the tensors' device, receives each candidate's
    evaluated bisection sections (depth first)."""
    if not tr.tf.is_cuda:
        feas = traj_mod.check_input_feasibility(tr, grav, fmin, fmax, wmax, min_section_time,
                                                max_depth=max_depth, static_max_tf=static_max_tf,
                                                sections=sections)
        return feas, traj_mod.check_velocity_feasibility(tr, vmax, strict_degenerate)
    return _launch_gates(tr, grav, fmin, fmax, wmax, min_section_time, vmax, static_max_tf,
                         max_depth, strict_degenerate, sections)


def _launch_gates(tr, grav, fmin, fmax, wmax, min_section_time, vmax, static_max_tf=None,
                  max_depth=9, strict_degenerate=True, sections=None, launcher=None):
    """One K8 launch on the tensors' device (`plan_gates`' CUDA route);
    launcher: another build's `plan_gates_launch` (`bind`)."""
    dev = tr.tf.device
    lead, N = tuple(tr.tf.shape[:-1]), tr.tf.shape[-1]
    out = torch.empty((2,) + lead + (N,), dtype=torch.bool, device=dev)
    B = math.prod(lead)
    if B == 0 or N == 0:
        return out[0], out[1]
    if not isinstance(strict_degenerate, bool):
        raise ValueError(f"strict_degenerate must be a bool, got {strict_degenerate!r}")
    targs, keep = _traj_args(tr, dev)
    if grav.dtype != torch.float32 or grav.device != dev:
        raise ValueError(f"grav: {grav.dtype} on {grav.device}; the kernel takes float32 on {dev}")
    g = grav.expand(lead + (N, 3))
    if N > 1 and g.stride(-2) != 0:
        raise ValueError(f"grav {tuple(grav.shape)}: the kernel takes one gravity a vehicle, "
                         f"broadcastable to {lead + (1, 3)}")
    g, g_strides = _laid_out(g[..., 0, :], lead, (3,))
    if sections is not None and (sections.dtype != torch.int32 or sections.device != dev
                                 or tuple(sections.shape) != lead + (N,)
                                 or not sections.is_contiguous()):
        raise ValueError(f"sections: need a contiguous int32 {lead + (N,)} tensor on {dev}")
    gargs = _Gates(g.data_ptr(), g_strides[0], _scalar_ptr(fmin, "fmin", dev),
                   _scalar_ptr(fmax, "fmax", dev), _scalar_ptr(wmax, "wmax", dev),
                   _scalar_ptr(vmax, "vmax", dev), float(min_section_time),
                   last_level(max_depth, static_max_tf, min_section_time),
                   int(strict_degenerate))
    status = (launcher or _fn("plan_gates_launch"))(
        targs, gargs, B, N, _GateOut(out[0].data_ptr(), out[1].data_ptr(), _ptr(sections)),
        _stream(dev))
    cuda_build.check(status, "plan_gates_launch")
    plan_gates.launches += 1
    del keep, g
    return out[0], out[1]


plan_gates.launches = 0  # K8 launches since the last reset
