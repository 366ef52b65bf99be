"""The planner's pyramid rounds through the hand-written CUDA kernels.

`csrc/rounds.cu` holds three kernels for what the JAX package runs as jnp
inside the frame's jit call (no `pallas_call`) between the inflation
launches of `rappids._plan_core`:

- K10, `round_seeds`: a pre-planned round's seeds, the stable gated order
  over the candidates, the round's slice of it, the containment test
  against the set so far and the inflation kernel's seed rows
  (`rappids.round_seeds_plain` is the plain version);
- K11, `pyramid_set`: the pyramids of one inflation launch from its output
  rows, the `keep` shallowest, merged by depth into the set so far
  (`rappids.pyramid_set_plain`);
- K12, `lazy_seeds`: a lazy round's seeds, the seedable fail points in
  cost order, containment, the prefilter on the work image, the greedy
  dedupe in its serial order and the kept-first selection, as seed rows
  (`rappids.lazy_seeds_plain`).

Each is one launch for every vehicle of a leading shape L (a block a
vehicle). Every sort is a stable rank by counting: rank i = #{j: d_j <
d_i} + #{j < i: d_j = d_i}, NaN after +inf and -0.0 equal to +0.0, which is
`argsort(stable=True)`'s order. CUDA tensors launch the kernel (or raise: a
failed build or launch is never replaced by the plain version); CPU tensors
run the plain versions. Nothing is read back to the host. Each wrapper
counts its launches in `.launches`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from agrifly_tpu_torch import cuda_build
from agrifly_tpu_torch.planner import rappids

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


class _Vec(ctypes.Structure):  # rounds.cu Vec: a (B, N) array, its vehicle stride
    _fields_ = [("p", _P), ("sv", _L)]


class _Set(ctypes.Structure):  # rounds.cu SetArgs: a (B, C) pyramid set, contiguous
    _fields_ = [("depth", _P), ("bounds", _P), ("normals", _P), ("valid", _P), ("C", _I)]


class _Cam(ctypes.Structure):  # rounds.cu PlanCam: 0-d float32 tensors on the card
    _fields_ = [(name, _P) for name in ("focal", "cx", "cy", "depth_scale", "true_radius",
                                        "plan_radius", "min_check_dist")] + \
               [("width", _I), ("height", _I), ("k", _I), ("shrink_extra", _I)]


_SIGNATURES = {
    "round_seeds_launch": [_Vec, _Vec, _Vec, _Vec, _Vec, _Set, _Cam, _I, _I, _I, _I, _P, _P, _P],
    "pyramid_set_launch": [_P, _P, _I, _I, _Set, _I, _Cam, _P, _P, _P, _P, _I, _I, _P],
    "lazy_seeds_launch": [_Vec, _Vec, _Vec, _Vec, _Vec, _Vec, _P, _P, _Set, _Cam, _I, _I, _I,
                          _I, _I, _P, _P, _P, _P],
}


@functools.lru_cache(maxsize=None)
def _bind(lib: ctypes.CDLL, name: str):
    fn = getattr(lib, name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def _fn(name: str):
    """The launch function `name` of the `rounds.cu` library, its argument
    types set once."""
    return _bind(cuda_build.load("rounds"), name)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _vec(x, lead, n, dtype, dev, what, keep):
    """x read as (B, n) rows with a unit inner stride: a `_Vec` of x itself
    where it already is so (one leading axis or none), else of a copy;
    keep holds what the launch reads."""
    if x.dtype != dtype or x.device != dev:
        raise ValueError(f"{what}: {x.dtype} on {x.device}; the kernel takes {dtype} on {dev}")
    if tuple(x.shape) != tuple(lead) + (n,):
        raise ValueError(f"{what}: shape {tuple(x.shape)}, need {tuple(lead) + (n,)}")
    if len(lead) <= 1 and (n <= 1 or x.stride(-1) == 1):
        sv = x.stride(0) if lead else 0
    else:
        x = x.reshape(math.prod(lead), n).contiguous()
        sv = n
    keep.append(x)
    return _Vec(x.data_ptr(), sv)


def _set_args(pyrs, lead, dev, keep):
    """A `_Set` of a pyramid set of leading shape L (None: no set)."""
    if pyrs is None:
        return _Set(None, None, None, None, 0)
    C = pyrs.depth.shape[-1]
    parts = []
    for x, inner, dtype, name in zip(pyrs, ((C,), (C, 4), (C, 4, 3), (C,)),
                                     (torch.float32,) * 3 + (torch.bool,),
                                     ("depth", "bounds", "normals", "valid")):
        if x.dtype != dtype or x.device != dev or tuple(x.shape) != tuple(lead) + inner:
            raise ValueError(f"pyrs.{name}: {x.dtype} {tuple(x.shape)} on {x.device}; the "
                             f"kernel takes {dtype} {tuple(lead) + inner} on {dev}")
        x = x.contiguous()
        keep.append(x)
        parts.append(x.data_ptr())
    return _Set(*parts, C)


def _scalar_ptr(x, what, dev):
    if not (isinstance(x, torch.Tensor) and x.dim() == 0 and x.dtype == torch.float32
            and x.device == dev):
        raise ValueError(f"{what}: the kernel takes a 0-d float32 tensor on {dev}, got "
                         f"{x!r:.80}")
    return x.data_ptr()


def _cam_args(params: rappids.PlannerParams, work: rappids.Work, dev):
    """The kernels' PlanCam: the work image's camera and the planner's radii."""
    wc = work.params.cam
    ptr = lambda x, what: _scalar_ptr(x, what, dev)  # noqa: E731
    return _Cam(ptr(wc.focal, "work cam.focal"), ptr(wc.cx, "work cam.cx"),
                ptr(wc.cy, "work cam.cy"), ptr(params.cam.depth_scale, "cam.depth_scale"),
                ptr(params.true_radius, "true_radius"), ptr(params.plan_radius, "plan_radius"),
                ptr(params.min_check_dist, "min_check_dist"), wc.width, wc.height, work.k,
                work.shrink_extra)


def round_seeds(work: rappids.Work, gate, cost, epx, epy, endz, pyrs, rnd: int,
                per_round: int):
    """`rappids.round_seeds_plain`'s contract: (seed rows (*L, P, 12) int32
    on the work image, seed mask (*L, P) bool) of round `rnd` for (*L, N)
    candidates; pyrs None in the first round. On CUDA tensors one K10
    launch, bit for bit the plain version on the card."""
    if not cost.is_cuda:
        return rappids.round_seeds_plain(work, gate, cost, epx, epy, endz, pyrs, rnd, per_round)
    return _launch_round(work, gate, cost, epx, epy, endz, pyrs, rnd, per_round)


def _launch_round(work, gate, cost, epx, epy, endz, pyrs, rnd, per_round):
    """One K10 launch (`round_seeds`' CUDA route)."""
    dev = cost.device
    lead, N = tuple(cost.shape[:-1]), cost.shape[-1]
    P = max(0, min(N, (rnd + 1) * per_round) - rnd * per_round)
    B = math.prod(lead)
    rows = torch.empty(lead + (P, 12), dtype=torch.int32, device=dev)
    valid = torch.empty(lead + (P,), dtype=torch.bool, device=dev)
    if B == 0 or P == 0:
        return rows, valid
    keep = []
    vecs = [_vec(x, lead, N, dtype, dev, what, keep) for x, dtype, what in
            ((gate, torch.bool, "gate"), (cost, torch.float32, "cost"),
             (epx, torch.float32, "epx"), (epy, torch.float32, "epy"),
             (endz, torch.float32, "endz"))]
    status = _fn("round_seeds_launch")(
        *vecs, _set_args(pyrs, lead, dev, keep), _cam_args(work.params, work, dev),
        B, N, rnd * per_round, P, rows.data_ptr(), valid.data_ptr(), _stream(dev))
    cuda_build.check(status, "round_seeds_launch")
    round_seeds.launches += 1
    del keep
    return rows, valid


round_seeds.launches = 0  # K10 launches since the last reset


def pyramid_set(params: rappids.PlannerParams, work: rappids.Work, out, seed_valid, keep: int,
                base=None) -> rappids.PyramidSet:
    """`rappids.pyramid_set_plain`'s contract: the pyramids of the (*L, P, 8)
    int32 inflation rows `out` and the seed mask (*L, P), the `keep`
    shallowest, merged into `base` (a PyramidSet of leading shape L, an int:
    an empty set of that capacity, or None: no merge). On CUDA tensors one
    K11 launch, bit for bit the plain version on the card."""
    if not out.is_cuda:
        return rappids.pyramid_set_plain(params, work, out, seed_valid, keep, base)
    return _launch_set(params, work, out, seed_valid, keep, base)


def _launch_set(params, work, out, seed_valid, keep, base=None):
    """One K11 launch (`pyramid_set`'s CUDA route)."""
    dev = out.device
    lead, P = tuple(out.shape[:-2]), out.shape[-2]
    if out.dtype != torch.int32 or out.shape[-1] != 8:
        raise ValueError(f"out: need (..., P, 8) int32 rows, got {tuple(out.shape)} {out.dtype}")
    if seed_valid.dtype != torch.bool or tuple(seed_valid.shape) != lead + (P,) \
            or seed_valid.device != dev:
        raise ValueError(f"seed_valid: need {lead + (P,)} bool on {dev}")
    n_new = min(P, int(keep))
    args = []
    empty_capacity = 0
    if isinstance(base, int):
        empty_capacity, C = base, base
        base_set = _Set(None, None, None, None, 0)
    elif base is None:
        C = n_new
        base_set = _Set(None, None, None, None, 0)
    else:
        base_set = _set_args(base, lead, dev, args)
        C = base_set.C
    B = math.prod(lead)
    depth = torch.empty(lead + (C,), dtype=torch.float32, device=dev)
    bounds = torch.empty(lead + (C, 4), dtype=torch.float32, device=dev)
    normals = torch.empty(lead + (C, 4, 3), dtype=torch.float32, device=dev)
    valid = torch.empty(lead + (C,), dtype=torch.bool, device=dev)
    if B and C:
        out = out.contiguous()
        seed_valid = seed_valid.contiguous()
        status = _fn("pyramid_set_launch")(
            out.data_ptr(), seed_valid.data_ptr(), B, P, base_set, empty_capacity,
            _cam_args(params, work, dev), depth.data_ptr(), bounds.data_ptr(),
            normals.data_ptr(), valid.data_ptr(), n_new, C, _stream(dev))
        cuda_build.check(status, "pyramid_set_launch")
        pyramid_set.launches += 1
    del args
    return rappids.PyramidSet(depth, bounds, normals, valid)


pyramid_set.launches = 0  # K11 launches since the last reset


def lazy_seeds(params: rappids.PlannerParams, work: rappids.Work, img, gate, free, fail_px,
               fail_py, fail_z, cost, pyrs, per_round: int):
    """`rappids.lazy_seeds_plain`'s contract: (seed rows (*L, S, 12) int32,
    seed mask (*L, S) bool, failed (*L, N) bool), S = min(N, 2 per_round),
    for (*L, N) candidates, the full (*L, H, W) int32 depth codes `img` and
    the set `pyrs`. On CUDA tensors one K12 launch, bit for bit the plain
    version on the card."""
    if not cost.is_cuda:
        return rappids.lazy_seeds_plain(params, work, img, gate, free, fail_px, fail_py,
                                        fail_z, cost, pyrs, per_round)
    return _launch_lazy(params, work, img, gate, free, fail_px, fail_py, fail_z, cost, pyrs,
                        per_round)


MAX_LAZY_CONSIDERED = 256  # rounds.cu kMaxConsidered: 4 per_round fail points at most


def _launch_lazy(params, work, img, gate, free, fail_px, fail_py, fail_z, cost, pyrs,
                 per_round):
    """One K12 launch (`lazy_seeds`' CUDA route)."""
    dev = cost.device
    lead, N = tuple(cost.shape[:-1]), cost.shape[-1]
    M = min(N, 4 * per_round)
    S = min(M, 2 * per_round)
    if M > MAX_LAZY_CONSIDERED:
        raise ValueError(f"lazy_seeds: {M} fail points considered, the kernel takes at most "
                         f"{MAX_LAZY_CONSIDERED}")
    H, W = params.cam.height, params.cam.width
    Hw, Ww = work.params.cam.height, work.params.cam.width
    for x, shape, what in ((img, (H, W), "img"), (work.img, (Hw, Ww), "work.img")):
        if x.dtype != torch.int32 or x.device != dev or tuple(x.shape) != lead + shape:
            raise ValueError(f"{what}: need {lead + shape} int32 on {dev}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    B = math.prod(lead)
    rows = torch.empty(lead + (S, 12), dtype=torch.int32, device=dev)
    valid = torch.empty(lead + (S,), dtype=torch.bool, device=dev)
    failed = torch.empty(lead + (N,), dtype=torch.bool, device=dev)
    if B == 0 or N == 0:
        return rows, valid, failed
    keep = []
    vecs = [_vec(x, lead, N, dtype, dev, what, keep) for x, dtype, what in
            ((gate, torch.bool, "gate"), (free, torch.bool, "free"),
             (fail_px, torch.float32, "fail_px"), (fail_py, torch.float32, "fail_py"),
             (fail_z, torch.float32, "fail_z"), (cost, torch.float32, "cost"))]
    img, wimg = img.contiguous(), work.img.contiguous()
    status = _fn("lazy_seeds_launch")(
        *vecs, img.data_ptr(), wimg.data_ptr(), _set_args(pyrs, lead, dev, keep),
        _cam_args(params, work, dev), W, H, B, N, per_round, rows.data_ptr(), valid.data_ptr(),
        failed.data_ptr(), _stream(dev))
    cuda_build.check(status, "lazy_seeds_launch")
    lazy_seeds.launches += 1
    del keep, img, wimg
    return rows, valid, failed


lazy_seeds.launches = 0  # K12 launches since the last reset
