"""RAPPIDS — Rectangular Pyramid Partitioning using Integrated Depth Sensors.

Port of the `plan` path of `agrifly_tpu/planner/rappids.py`: sample N
candidates, gate them by input and velocity feasibility, inflate pyramids
at the endpoints of the cheapest gated candidates in rounds (two seeded,
then lazy rounds seeded where candidates failed for lack of a covering
pyramid), collision-check every candidate against the set and pick the
cheapest free one. The JAX package's module docstring explains how the
reference's anytime loop became this fixed-shape batch.

Pyramid inflation runs from seed rows (`cuda_inflate.inflate_rows`): on a
CUDA tensor through the hand-written kernel (`planner/cuda_inflate.py`), on
a CPU tensor through the plain batched `inflate_pyramid`. The rounds around
it are one plain function a launch, chained by `_plan_core`: each
pre-planned round's seeds (`round_seeds_plain`), the pyramids of an
inflation merged into the set (`pyramid_set_plain`) and the lazy round's
seeds (`lazy_seeds_plain`); on CUDA tensors each is one launch of a round
kernel (`planner/cuda_rounds.py`). The candidate pass does the
same (`planner/cuda_plan.py`): `collision_check` is one launch of the
collision-check kernel on CUDA tensors and `collision_check_plain` on CPU
tensors; the planner's two gates are one launch of the gate kernel
(`cuda_plan.plan_gates`) or the plain `traj` functions.

Every function takes a leading vehicle shape L on its image and vectors:
L = () plans for one vehicle, L = (B,) for a fleet in the same launches
(the counterpart of the JAX package's `jax.vmap` over vehicles, written
as an axis). A (P, ...) set or (N, ...) batch of one vehicle is then
(*L, P, ...) or (*L, N, ...), and every gather and sort works along the
vehicle's own axis.

Every sort is stable (`jnp.argsort` is), since quantized pyramid depths
tie often and the order decides `find_containing_pyramid`. Nothing here
reads a tensor back to the host.
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple

import torch

from agrifly_tpu_torch import card_or_raise
from agrifly_tpu_torch.ops import rootfind
from agrifly_tpu_torch.ops.fmath import cross, dot3, ipow, norm3, scalar
from agrifly_tpu_torch.planner import traj as traj_mod

PIXEL_BUFFER = 2  # _pyramidSearchPixelBuffer
BIG = 1 << 20
EXPAND_ROUNDS = 8
MAX_SECTIONS = 8
MAX_CHECK_ITERS = 24
LAZY_DEDUPE_PX = 8  # seeds closer than this (px, both axes) duplicate
LAZY_DEDUPE_Z_QUANTA = 2.0  # ... when their depths are within this many codes


def _take(x, idx, vec_dims=0):
    """x gathered along its per-vehicle item axis (the one before its
    `vec_dims` trailing axes) at idx (*L, M): x[..., idx, <trailing>]."""
    idx = idx.reshape(idx.shape + (1,) * vec_dims)
    return torch.take_along_dim(x, idx, dim=-1 - vec_dims)


class CameraModel(NamedTuple):
    focal: torch.Tensor  # f32 [px]
    cx: torch.Tensor
    cy: torch.Tensor
    width: int
    height: int
    depth_scale: torch.Tensor  # meters per depth unit


def make_camera(width=640, height=480, focal=None, depth_scale=10.0 / 256.0,
                device="cuda") -> CameraModel:
    """The camera's tensors are built on the card unless `device` names
    another; with no card, the default raises instead of building on the
    CPU. `make_params` builds on the camera's device."""
    device = card_or_raise(device, "make_camera")
    if focal is None:
        focal = width / 2.0
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    return CameraModel(focal=f32(focal), cx=f32(width / 2.0), cy=f32(height / 2.0),
                       width=int(width), height=int(height), depth_scale=f32(depth_scale))


class PlannerParams(NamedTuple):
    cam: CameraModel
    true_radius: torch.Tensor  # physical vehicle radius [m]
    plan_radius: torch.Tensor  # planning radius [m]
    min_check_dist: torch.Tensor  # [m]
    fmin: torch.Tensor
    fmax: torch.Tensor
    wmax: torch.Tensor
    vmax: torch.Tensor
    min_section_time: float  # the float32 value, as a python number


def make_params(cam: CameraModel, true_radius, plan_radius, min_check_dist=0.5,
                fmin=5.0, fmax=30.0, wmax=20.0, vmax=5.0,
                min_section_time=0.02) -> PlannerParams:
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=cam.focal.device)  # noqa: E731
    return PlannerParams(
        cam=cam, true_radius=f32(true_radius), plan_radius=f32(plan_radius),
        min_check_dist=f32(min_check_dist), fmin=f32(fmin), fmax=f32(fmax),
        wmax=f32(wmax), vmax=f32(vmax),
        min_section_time=float(torch.tensor(min_section_time, dtype=torch.float32)),
    )


def deproject(cam: CameraModel, px, py, depth):
    """Pixel + depth -> camera-frame point (DepthImagePlanner.hpp:275-279)."""
    return torch.stack([depth * (px - cam.cx) / cam.focal,
                        depth * (py - cam.cy) / cam.focal,
                        depth * torch.ones_like(px)], dim=-1)


def project(cam: CameraModel, point):
    """Camera-frame point -> pixel (hpp:287-290). Returns (px, py)."""
    z = point[..., 2]
    safe_z = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    return (point[..., 0] * cam.focal / safe_z + cam.cx,
            point[..., 1] * cam.focal / safe_z + cam.cy)


# =============================================================================
# candidates + exploration cost
# =============================================================================


def candidates_from_samples(params: PlannerParams, px, py, depth, tf, vel0, acc0):
    """Rest-to-rest candidates from explicit (pixel, depth, duration) samples,
    starting at the camera origin with the current velocity/acceleration
    (hpp:393-404). Samples (*L, N); vel0, acc0 (*L, 3)."""
    goal = deproject(params.cam, px, py, depth)
    zero = torch.zeros(px.shape + (3,), dtype=torch.float32, device=px.device)
    return traj_mod.generate(zero, vel0[..., None, :].expand_as(zero),
                             acc0[..., None, :].expand_as(zero), tf,
                             goal_pos=goal, goal_vel=zero, goal_acc=zero)


def samples_from_uniform(params: PlannerParams, u, min_depth=1.5, max_depth=3.0,
                         min_time=2.0, max_time=3.0):
    """Map a (*L, 4, N) uniform block to (px, py, depth, tf): pixel uniform
    in the central 80% of the image, depth U(1.5,3) m, duration U(2,3) s
    (hpp:334-427). The JAX package draws u = uniform(key, (4, N))."""
    cam = params.cam
    px = 0.1 * cam.width + u[..., 0, :] * (0.8 * cam.width)
    py = 0.1 * cam.height + u[..., 1, :] * (0.8 * cam.height)
    depth = min_depth + u[..., 2, :] * (max_depth - min_depth)
    tf = min_time + u[..., 3, :] * (max_time - min_time)
    return px, py, depth, tf


def sample_candidates(params: PlannerParams, u, vel0, acc0):
    """N random candidates from the (*L, 4, N) uniform block u."""
    return candidates_from_samples(params, *samples_from_uniform(params, u), vel0, acc0)


def endpoint_seeds(params: PlannerParams, tr: traj_mod.Traj):
    """Each candidate's endpoint as an inflation seed: pixel x, pixel y and
    depth [m], each (*L, N)."""
    end = traj_mod.position(tr, tr.tf)
    px, py = project(params.cam, end)
    return px, py, end[..., 2]


def exploration_cost(tr: traj_mod.Traj, goal_cam):
    """-(progress toward goal)/duration (Rappids_Simulator/main.cpp:95-109),
    for (*L, N) candidates and a (*L, 3) goal."""
    end = traj_mod.position(tr, tr.tf)
    goal = goal_cam[..., None, :]
    sg = norm3(goal)
    pig = norm3(goal - end)
    return -(sg - pig) / tr.tf


# =============================================================================
# pyramid set
# =============================================================================


class PyramidSet(NamedTuple):
    """Fixed-capacity set of depth-sorted pyramids (leading shape L)."""

    depth: torch.Tensor  # (*L, P) base-plane depth [m]; +inf for unused slots
    bounds: torch.Tensor  # (*L, P, 4) f32 pixel bounds [right, top, left, bottom]
    normals: torch.Tensor  # (*L, P, 4, 3) lateral-face unit normals
    valid: torch.Tensor  # (*L, P) bool


def empty_pyramid_set(capacity, device, lead=()) -> PyramidSet:
    shape = tuple(lead) + (capacity,)
    return PyramidSet(
        depth=torch.full(shape, math.inf, dtype=torch.float32, device=device),
        bounds=torch.zeros(shape + (4,), dtype=torch.float32, device=device),
        normals=torch.zeros(shape + (4, 3), dtype=torch.float32, device=device),
        valid=torch.zeros(shape, dtype=torch.bool, device=device),
    )


def _pyramid_from_edges(cam: CameraModel, right, top, left, bottom, depth):
    """Bounds (..., 4) and lateral normals (..., 4, 3) from pixel edges
    (Pyramid.hpp:49-60)."""
    c0 = deproject(cam, right, top, depth)  # top right
    c1 = deproject(cam, left, top, depth)  # top left
    c2 = deproject(cam, left, bottom, depth)  # bottom left
    c3 = deproject(cam, right, bottom, depth)  # bottom right

    def unit_cross(a, b):
        c = cross(a, b)
        n = norm3(c, keepdim=True)
        return c / torch.where(n < 1e-12, torch.ones_like(n), n)

    normals = torch.stack([unit_cross(c0, c1), unit_cross(c1, c2),
                           unit_cross(c2, c3), unit_cross(c3, c0)], dim=-2)
    return torch.stack([right, top, left, bottom], dim=-1), normals


class SeedSetup(NamedTuple):
    """Per-seed integer set-up of one inflation batch (the kernel's prologue)."""

    x0: torch.Tensor  # (*L, P) int32
    y0: torch.Tensor
    min_pyr_depth: torch.Tensor
    left0: torch.Tensor
    right0: torch.Tensor
    top0: torch.Tensor
    bottom0: torch.Tensor
    ok0: torch.Tensor  # (*L, P) bool
    edge_off: torch.Tensor  # () int32
    ignore: torch.Tensor  # () int32
    numer: torch.Tensor  # () int32: shrink_px = numer // max(img, 1) + extra


def seed_setup(params: PlannerParams, x0s, y0s, min_depths, shrink_extra: int) -> SeedSetup:
    """Seed validity, initial rectangle and scalar thresholds, in float32
    tensors exactly as `rappids.inflate_pyramid` computes them (a float64
    product could move a truncation boundary)."""
    cam = params.cam
    W, H = cam.width, cam.height
    scale = cam.depth_scale
    x0i = x0s.to(torch.int32)
    y0i = y0s.to(torch.int32)

    edge_off = (cam.focal * params.true_radius / params.min_check_dist).to(torch.int32) + shrink_extra
    ok = ~((x0i <= edge_off + PIXEL_BUFFER + 1)
           | (x0i > W - edge_off - PIXEL_BUFFER - 1)
           | (y0i <= edge_off + PIXEL_BUFFER + 1)
           | (y0i > H - edge_off - PIXEL_BUFFER - 1))
    min_pyr_depth = ((min_depths + params.plan_radius) / scale).to(torch.int32)
    init_radius = (cam.focal * params.plan_radius
                   / (scale * min_pyr_depth.to(torch.float32))).to(torch.int32)
    ok = ok & (2 * init_radius < min(W, H) - 2 * edge_off)
    ignore = (params.true_radius / scale).to(torch.int32)

    top0 = torch.where(y0i - init_radius < edge_off, edge_off,
                       torch.minimum(H - edge_off - 1, y0i + init_radius) - 2 * init_radius)
    left0 = torch.where(x0i - init_radius < edge_off, edge_off,
                        torch.minimum(W - edge_off - 1, x0i + init_radius) - 2 * init_radius)
    numer = (cam.focal * params.plan_radius / scale).to(torch.int32)
    return SeedSetup(x0i, y0i, min_pyr_depth, left0, left0 + 2 * init_radius,
                     top0, top0 + 2 * init_radius, ok, edge_off, ignore, numer)


def _rmin(x):
    return x.amin(dim=(-2, -1))


def _rmax(x):
    return x.amax(dim=(-2, -1))


def _rany(x):
    return x.flatten(-2).any(dim=-1)


def seed_rows(params: PlannerParams, x0s, y0s, min_depths, shrink_extra: int):
    """The inflation kernel's (*L, P, 12) int32 seed rows: `seed_setup`
    packed as [x0, y0, min_pyr_depth, left0, right0, top0, bottom0, ok0,
    edge_off, ignore, numer, shrink_extra] (the last four equal on every
    row)."""
    s = seed_setup(params, x0s, y0s, min_depths, shrink_extra)
    full = lambda v: v.to(torch.int32).expand(x0s.shape)  # noqa: E731
    return torch.stack(
        [s.x0, s.y0, s.min_pyr_depth, s.left0, s.right0, s.top0, s.bottom0,
         s.ok0.to(torch.int32), full(s.edge_off), full(s.ignore), full(s.numer),
         torch.full(x0s.shape, shrink_extra, dtype=torch.int32, device=x0s.device)],
        dim=-1).contiguous()


def inflate_pyramid(params: PlannerParams, img, x0s, y0s, min_depths, shrink_extra: int = 0):
    """Integer inflation of P seeds (x0s, y0s, min_depths: (*L, P)) on
    (*L, H, W) int32 depth-code images, seed row l on image l: the plain
    version of the inflation kernel (`planner/cuda_inflate.py`,
    `csrc/inflate.cu`).

    Returns (ok (*L, P) bool, maxd (*L, P) int32 expanded-rect min depth,
    edges (*L, P, 4) int32 [right, top, left, bottom]); the maxd and edges
    of seeds that are not ok are unspecified. Batched form of the JAX
    package's `inflate_pyramid`: each reduction is a masked min/max over
    (*L, P, H, W). shrink_extra adds a pixel margin to every shrink
    distance (the pooled-image path)."""
    return _inflate_setup(params, img, seed_setup(params, x0s, y0s, min_depths, shrink_extra),
                          shrink_extra)


def inflate_rows_plain(params: PlannerParams, img, rows):
    """`inflate_pyramid` of the seeds packed in (*L, P, 12) seed rows
    (`seed_rows`), as the kernel's (*L, P, 8) int32 output rows [ok, maxd,
    right, top, left, bottom, 0, 0]."""
    c = rows.unbind(-1)
    first = rows.reshape(-1, 12)[0] if rows.numel() else torch.zeros(12, dtype=torch.int32)
    s = SeedSetup(*c[:7], c[7] != 0, first[8], first[9], first[10])
    ok, maxd, edges = _inflate_setup(params, img, s, first[11])
    z = torch.zeros_like(maxd)
    return torch.cat([torch.stack([ok.to(torch.int32), maxd], dim=-1), edges,
                      torch.stack([z, z], dim=-1)], dim=-1)


def _inflate_setup(params: PlannerParams, img, s: SeedSetup, shrink_extra):
    """`inflate_pyramid` from the seeds' integer set-up."""
    W, H = params.cam.width, params.cam.height
    dev = img.device
    big = torch.tensor(BIG, dtype=torch.int32, device=dev)
    xs = torch.arange(W, dtype=torch.int32, device=dev)[None, None, :]
    ys = torch.arange(H, dtype=torch.int32, device=dev)[None, :, None]
    col = lambda v: v[..., None, None]  # noqa: E731  (*L, P) -> (*L, P, 1, 1)
    x0, y0 = s.x0, s.y0
    img = img[..., None, :, :]
    edge_off = s.edge_off

    blocked = (img > s.ignore) & (img < col(s.min_pyr_depth))
    in_rect0 = ((xs >= col(s.left0)) & (xs <= col(s.right0))
                & (ys >= col(s.top0)) & (ys <= col(s.bottom0)))
    ok = s.ok0 & ~_rany(blocked & in_rect0)

    # max-sweep expansion; a round that changes nothing is a fixpoint, so a
    # fixed number of rounds equals the JAX package's early-exit while_loop
    l, r, t, b = s.left0, s.right0, s.top0, s.bottom0
    for _ in range(EXPAND_ROUNDS):
        in_rows = blocked & (ys >= col(t)) & (ys <= col(b))
        first_r = _rmin(torch.where(in_rows & (xs > col(r)), xs, big))
        r2 = torch.maximum(r, torch.minimum(first_r - 1, W - 1 - edge_off))
        last_l = _rmax(torch.where(in_rows & (xs < col(l)), xs, -big))
        l2 = torch.minimum(l, torch.maximum(last_l + 1, edge_off))
        in_cols = blocked & (xs >= col(l2)) & (xs <= col(r2))
        first_b = _rmin(torch.where(in_cols & (ys > col(b)), ys, big))
        b2 = torch.maximum(b, torch.minimum(first_b - 1, H - 1 - edge_off))
        last_t = _rmax(torch.where(in_cols & (ys < col(t)), ys, -big))
        t2 = torch.minimum(t, torch.maximum(last_t + 1, edge_off))
        l, r, t, b = l2, r2, t2, b2

    # base depth: min unmasked depth inside the expanded rect
    in_rect = (xs >= col(l)) & (xs <= col(r)) & (ys >= col(t)) & (ys <= col(b))
    maxd = torch.clamp(_rmin(torch.where((img > s.ignore) & in_rect, img, big)), max=65535)

    # shrink by vehicle radius: edge bands, then corners
    relevant = (img > s.ignore) & (img < col(maxd))
    shrink_px = torch.div(s.numer, torch.clamp(img, min=1), rounding_mode="floor") + shrink_extra
    s_right, s_left = xs - shrink_px, xs + shrink_px
    s_top, s_bottom = ys + shrink_px, ys - shrink_px
    r_init, l_init = W - 1 - edge_off, edge_off
    t_init, b_init = edge_off, H - 1 - edge_off

    def band_reduce(band, primary, alt_hi, alt_lo, seed_main, seed_alt, init_primary, is_min):
        seed_main, seed_alt = col(seed_main), col(seed_alt)
        if is_min:
            can_primary = seed_main < primary - PIXEL_BUFFER
        else:
            can_primary = seed_main > primary + PIXEL_BUFFER
        can_hi = seed_alt > alt_hi + PIXEL_BUFFER
        can_lo = seed_alt < alt_lo - PIXEL_BUFFER
        fail = band & ~can_primary & ~can_hi & ~can_lo
        use_hi = band & ~can_primary & can_hi & ~can_lo
        use_lo = band & ~can_primary & can_lo & ~can_hi
        both = band & ~can_primary & can_hi & can_lo
        lo_more = (b_init - alt_lo) > (alt_hi - t_init)
        use_hi = use_hi | (both & lo_more)
        use_lo = use_lo | (both & ~lo_more)
        use_primary = band & can_primary
        if is_min:
            edge = torch.minimum(_rmin(torch.where(use_primary, primary, big)), init_primary)
        else:
            edge = torch.maximum(_rmax(torch.where(use_primary, primary, -big)), init_primary)
        hi_val = _rmax(torch.where(use_hi, alt_hi, -big))
        lo_val = _rmin(torch.where(use_lo, alt_lo, big))
        return edge, hi_val, lo_val, _rany(fail)

    rows_tb = (ys >= col(t)) & (ys <= col(b))
    cols_lr = (xs >= col(l)) & (xs <= col(r))
    right_e, rt_hi, rt_lo, f1 = band_reduce(
        relevant & (xs >= col(r)) & rows_tb, s_right, s_top, s_bottom, x0, y0, r_init, True)
    left_e, lt_hi, lt_lo, f2 = band_reduce(
        relevant & (xs <= col(l)) & rows_tb, s_left, s_top, s_bottom, x0, y0, l_init, False)
    top_e, tp_hi, tp_lo, f3 = band_reduce(
        relevant & (ys <= col(t)) & cols_lr, s_top, s_left, s_right, y0, x0, t_init, False)
    bot_e, bt_hi, bt_lo, f4 = band_reduce(
        relevant & (ys >= col(b)) & cols_lr, s_bottom, s_left, s_right, y0, x0, b_init, True)
    ok = ok & ~(f1 | f2 | f3 | f4)

    right_f = torch.minimum(right_e, torch.minimum(tp_lo, bt_lo))
    left_f = torch.maximum(left_e, torch.maximum(tp_hi, bt_hi))
    top_f = torch.maximum(top_e, torch.maximum(rt_hi, lt_hi))
    bottom_f = torch.minimum(bot_e, torch.minimum(rt_lo, lt_lo))

    def corner(band, s_a, a_is_min, a_seed_ok, s_b, b_is_min, b_seed_ok, a_loss, b_loss):
        both_bad = band & ~a_seed_ok & ~b_seed_ok
        use_a = band & a_seed_ok & (~b_seed_ok | (b_loss > a_loss))
        use_b = band & b_seed_ok & ~use_a
        a_val = (_rmin(torch.where(use_a, s_a, big)) if a_is_min
                 else _rmax(torch.where(use_a, s_a, -big)))
        b_val = (_rmin(torch.where(use_b, s_b, big)) if b_is_min
                 else _rmax(torch.where(use_b, s_b, -big)))
        return a_val, b_val, _rany(both_bad)

    h_span = col(torch.clamp(bottom_f - top_f, min=1))
    w_span = col(torch.clamp(right_f - left_f, min=1))
    X0, Y0 = col(x0), col(y0)

    # top-right: right edge (min-type) & top edge (max-type)
    rf, tf_ = col(right_f), col(top_f)
    band = relevant & (xs >= col(r)) & (ys <= col(t)) & (s_right < rf) & (s_top > tf_)
    rv, tv, fbad = corner(band, s_right, True, X0 < s_right - PIXEL_BUFFER,
                          s_top, False, Y0 > s_top + PIXEL_BUFFER,
                          (rf - s_right) * h_span, (s_top - tf_) * w_span)
    right_f, top_f, ok = torch.minimum(right_f, rv), torch.maximum(top_f, tv), ok & ~fbad

    # bottom-right: right (min) & bottom (min)
    rf, bf = col(right_f), col(bottom_f)
    band = relevant & (xs >= col(r)) & (ys >= col(b)) & (s_right < rf) & (s_bottom < bf)
    rv, bv, fbad = corner(band, s_right, True, X0 < s_right - PIXEL_BUFFER,
                          s_bottom, True, Y0 < s_bottom - PIXEL_BUFFER,
                          (rf - s_right) * h_span, (bf - s_bottom) * w_span)
    right_f, bottom_f, ok = torch.minimum(right_f, rv), torch.minimum(bottom_f, bv), ok & ~fbad

    # top-left: left (max) & top (max)
    lf, tf_ = col(left_f), col(top_f)
    band = relevant & (xs <= col(l)) & (ys <= col(t)) & (s_left > lf) & (s_top > tf_)
    lv, tv, fbad = corner(band, s_left, False, X0 > s_left + PIXEL_BUFFER,
                          s_top, False, Y0 > s_top + PIXEL_BUFFER,
                          (s_left - lf) * h_span, (s_top - tf_) * w_span)
    left_f, top_f, ok = torch.maximum(left_f, lv), torch.maximum(top_f, tv), ok & ~fbad

    # bottom-left: left (max) & bottom (min)
    lf, bf = col(left_f), col(bottom_f)
    band = relevant & (xs <= col(l)) & (ys >= col(b)) & (s_left > lf) & (s_bottom < bf)
    lv, bv, fbad = corner(band, s_left, False, X0 > s_left + PIXEL_BUFFER,
                          s_bottom, True, Y0 < s_bottom - PIXEL_BUFFER,
                          (s_left - lf) * h_span, (bf - s_bottom) * w_span)
    left_f, bottom_f, ok = torch.maximum(left_f, lv), torch.minimum(bottom_f, bv), ok & ~fbad

    # final validity: seed strictly inside with buffer, non-degenerate
    ok = ok & (left_f + PIXEL_BUFFER < right_f - PIXEL_BUFFER)
    ok = ok & (top_f + PIXEL_BUFFER < bottom_f - PIXEL_BUFFER)
    ok = ok & (x0 > left_f + PIXEL_BUFFER) & (x0 < right_f - PIXEL_BUFFER)
    ok = ok & (y0 > top_f + PIXEL_BUFFER) & (y0 < bottom_f - PIXEL_BUFFER)
    return ok, maxd, torch.stack([right_f, top_f, left_f, bottom_f], dim=-1)


def _pooled(params: PlannerParams, img, k: int):
    """k x k masked-min pooling (ignored pixels never block) and the camera
    of the pooled image."""
    cam = params.cam
    H, W = cam.height, cam.width
    ignore = (params.true_radius / cam.depth_scale).to(torch.int32)
    masked = torch.where(img > ignore, img, torch.full_like(img, 1 << 17))
    pooled = masked.reshape(img.shape[:-2] + (H // k, k, W // k, k)).amin(dim=(-3, -1))
    cam_small = CameraModel(focal=cam.focal / k, cx=cam.cx / k, cy=cam.cy / k,
                            width=W // k, height=H // k, depth_scale=cam.depth_scale)
    return pooled, cam_small


class Work(NamedTuple):
    """The image the pyramid rounds inflate on: the depth codes as int32, or
    with downsample k > 1 the k x k masked-min pooled image, with its
    camera (in `params`) and the one-pooled-pixel shrink margin."""

    params: PlannerParams  # the planner's parameters with the work image's camera
    img: torch.Tensor  # (*L, Hw, Ww) int32
    k: int
    shrink_extra: int


def work_image(params: PlannerParams, depth_u16, downsample: int = 1) -> Work:
    """The inflation's image and camera for `downsample` (made once a plan)."""
    img = depth_u16.to(torch.int32)
    k = int(downsample)
    if k > 1:
        img, cam_small = _pooled(params, img, k)
        return Work(params._replace(cam=cam_small), img, k, 1)
    return Work(params, img, 1, 0)


def work_rows(work: Work, seed_px, seed_py, seed_depth):
    """Seed rows (`seed_rows`) of full-resolution seeds (*L, P) on the work
    image: pixels divided by k there."""
    if work.k > 1:
        seed_px = seed_px / work.k
        seed_py = seed_py / work.k
    return seed_rows(work.params, seed_px, seed_py, seed_depth, work.shrink_extra)


def build_pyramid_set(params: PlannerParams, depth_u16, seed_px, seed_py,
                      seed_depth, seed_valid, capacity, downsample: int = 1) -> PyramidSet:
    """Inflate pyramids at the seeds (*L, P) on the images (*L, H, W) and
    keep each image's `capacity` shallowest.

    downsample k > 1 inflates on a k x k masked-min-pooled image with a
    scaled camera and a one-pooled-pixel margin (strictly conservative);
    bounds come back in full-resolution pixels. The image's device picks
    the route: on CUDA the inflation kernel and the pyramid-set kernel
    (`cuda_rounds.pyramid_set`), on the CPU their plain versions."""
    from agrifly_tpu_torch.planner import cuda_inflate, cuda_rounds

    work = work_image(params, depth_u16, downsample)
    out = cuda_inflate.inflate_rows(work.params, work.img,
                                    work_rows(work, seed_px, seed_py, seed_depth))
    return cuda_rounds.pyramid_set(params, work, out, seed_valid, capacity)


def pyramid_set_plain(params: PlannerParams, work: Work, out, seed_valid, keep: int,
                      base=None) -> PyramidSet:
    """The pyramids of one inflation launch, from its (*L, P, 8) output rows
    (`cuda_inflate.inflate_rows`) and the seeds' mask (*L, P): the base
    depth, bounds (x k) and unit normals, the `keep` shallowest; then, with
    a `base` set, merged into it by depth at the base's capacity (an int
    base: an empty set of that capacity). The plain version of the
    pyramid-set kernel (`cuda_rounds.pyramid_set`)."""
    pyramid_set_plain.calls += 1
    base_depth = out[..., 1].to(torch.float32) * params.cam.depth_scale - params.plan_radius
    e = out[..., 2:6].to(torch.float32)
    bounds, normals = _pyramid_from_edges(work.params.cam, e[..., 0], e[..., 1], e[..., 2],
                                          e[..., 3], base_depth)
    if work.k > 1:
        bounds = bounds * work.k
    ok = (out[..., 0] > 0) & seed_valid
    depth = torch.where(ok, base_depth, math.inf)
    take = torch.argsort(depth, dim=-1, stable=True)[..., :keep]
    new = PyramidSet(depth=_take(depth, take), bounds=_take(bounds, take, 1),
                     normals=_take(normals, take, 2), valid=_take(ok, take))
    if base is None:
        return new
    if isinstance(base, int):
        base = empty_pyramid_set(base, depth.device, depth.shape[:-1])
    return merge_pyramid_sets(base, new)


pyramid_set_plain.calls = 0  # calls since the last reset


def prefilter_seeds(params: PlannerParams, depth_u16, seed_px, seed_py,
                    seed_depth, seed_valid, downsample: int = 1):
    """Clears the valid bit of seeds inflation is guaranteed to reject: a
    blocker inside the initial rectangle, or a blocker within
    shrink + PIXEL_BUFFER of the seed on both axes. Never kills a seed the
    inflation would accept."""
    return _prefilter(work_image(params, depth_u16, downsample), seed_px, seed_py, seed_depth,
                      seed_valid)


def _prefilter(work: Work, seed_px, seed_py, seed_depth, seed_valid):
    """`prefilter_seeds` on the work image."""
    img = work.img
    if work.k > 1:
        seed_px = seed_px / work.k
        seed_py = seed_py / work.k
    s = seed_setup(work.params, seed_px, seed_py, seed_depth, work.shrink_extra)
    Hd, Wd = work.params.cam.height, work.params.cam.width
    shrink = torch.div(s.numer, torch.clamp(img, min=1), rounding_mode="floor") + work.shrink_extra
    ys = torch.arange(Hd, device=img.device)[None, :, None]
    xs = torch.arange(Wd, device=img.device)[None, None, :]
    col = lambda v: v[..., None, None]  # noqa: E731
    img = img[..., None, :, :]
    shrink = shrink[..., None, :, :]
    blocked = (img > s.ignore) & (img < col(s.min_pyr_depth))
    in_rect0 = ((xs >= col(s.left0)) & (xs <= col(s.right0))
                & (ys >= col(s.top0)) & (ys <= col(s.bottom0)))
    box = ((torch.abs(xs - col(s.x0)) <= shrink + PIXEL_BUFFER)
           & (torch.abs(ys - col(s.y0)) <= shrink + PIXEL_BUFFER))
    doomed = _rany(blocked & (in_rect0 | box))
    return seed_valid & ~doomed


def merge_pyramid_sets(a: PyramidSet, b: PyramidSet) -> PyramidSet:
    """Union of two sets, re-sorted by depth, keeping a's capacity."""
    capacity = a.depth.shape[-1]
    depth = torch.cat([a.depth, b.depth], dim=-1)
    order = torch.argsort(depth, dim=-1, stable=True)[..., :capacity]
    return PyramidSet(
        depth=_take(depth, order),
        bounds=_take(torch.cat([a.bounds, b.bounds], dim=-2), order, 1),
        normals=_take(torch.cat([a.normals, b.normals], dim=-3), order, 2),
        valid=_take(torch.cat([a.valid, b.valid], dim=-1), order),
    )


def find_containing_pyramid(pyrs: PyramidSet, px, py, depth):
    """First (shallowest-base) pyramid deeper than `depth` containing the
    pixel with the search buffer (cpp:356-380), for (*L, M) query points
    against a set of leading shape L. Returns (found, index)."""
    px, py, depth = px[..., None], py[..., None], depth[..., None]
    b = pyrs.bounds[..., None, :, :]  # (*L, 1, P, 4)
    hit = (pyrs.valid[..., None, :] & (pyrs.depth[..., None, :] >= depth)
           & (b[..., 2] + PIXEL_BUFFER < px) & (px < b[..., 0] - PIXEL_BUFFER)
           & (b[..., 1] + PIXEL_BUFFER < py) & (py < b[..., 3] - PIXEL_BUFFER))
    return torch.any(hit, dim=-1), torch.argmax(hit.to(torch.int8), dim=-1)


# =============================================================================
# collision checking
# =============================================================================


def _lift_cubic(roots, valid, quart, r4, v4):
    """Select the quartic's roots where `quart`, else the cubic's padded to 4."""
    r3 = torch.cat([roots, torch.zeros_like(roots[..., :1])], dim=-1)
    v3 = torch.cat([valid, torch.zeros_like(valid[..., :1])], dim=-1)
    return torch.where(quart[..., None], r4, r3), torch.where(quart[..., None], v4, v3)


def _quartic_or_cubic_roots(c0, c1, c2, c3, c4):
    """Roots of c0 t^4 + c1 t^3 + c2 t^2 + c3 t + c4, falling back to the
    cubic when |c0| is tiny. Returns (roots, valid), (..., 4)."""
    quart = torch.abs(c0) > 1e-6
    sc0 = torch.where(quart, c0, torch.ones_like(c0))
    r4, v4 = rootfind.solve_quartic(c1 / sc0, c2 / sc0, c3 / sc0, c4 / sc0)
    sc1 = torch.where(torch.abs(c1) > 0, c1, torch.ones_like(c1))
    r3, v3 = rootfind.solve_cubic(c2 / sc1, c3 / sc1, c4 / sc1)
    return _lift_cubic(r3, v3, quart, r4, v4)


def monotonic_sections(tr: traj_mod.Traj):
    """Split [0, tf] at the roots of zdot (cpp:303-354), for (*L, N)
    candidates.

    Returns (t1s, t2s, valid), each (*L, N, MAX_SECTIONS)."""
    # zdot(t) = v0z + a0z t + gz t^2/2 + bz t^3/6 + az t^4/24
    roots, rvalid = _quartic_or_cubic_roots(
        tr.alpha[..., 2] / scalar(24.0, tr.alpha), tr.beta[..., 2] / scalar(6.0, tr.beta),
        tr.gamma[..., 2] / 2.0,
        tr.a0[..., 2], tr.v0[..., 2])
    tf = tr.tf[..., None]
    interior = rvalid & (roots > 0.0) & (roots < tf)
    bnd = torch.cat([torch.zeros_like(tf), torch.where(interior, roots, tf), tf], dim=-1)
    bnd = torch.sort(bnd, dim=-1, stable=True).values  # (*L, N, 6)
    t1s, t2s = bnd[..., :-1], bnd[..., 1:]
    valid = (t2s - t1s) > 1e-6
    pad = MAX_SECTIONS - t1s.shape[-1]
    zpad = torch.zeros_like(t1s[..., :1]).expand(t1s.shape[:-1] + (pad,))
    return (torch.cat([t1s, zpad], dim=-1), torch.cat([t2s, zpad], dim=-1),
            torch.cat([valid, torch.zeros_like(valid[..., :pad])], dim=-1))


def _poly_at(tr: traj_mod.Traj, axis: int, t):
    """Position along one axis; z and x/y round their t^2 term as the JAX
    package's `_z_at` (a0 t t / 2) and collision_check (a0 t^2 / 2) do."""
    t2 = tr.a0[..., axis] * t * t if axis == 2 else tr.a0[..., axis] * ipow(t, 2)
    return (tr.p0[..., axis] + tr.v0[..., axis] * t + t2 / 2.0
            + tr.gamma[..., axis] * ipow(t, 3) / scalar(6.0, t)
            + tr.beta[..., axis] * ipow(t, 4) / scalar(24.0, t)
            + tr.alpha[..., axis] * ipow(t, 5) / scalar(120.0, t))


def _deepest_collision_time(tr: traj_mod.Traj, normals, t1, t2, increasing):
    """Deepest in-time crossing of the 4 lateral faces (cpp:382-454), for
    (*L, N) candidates against their (*L, N, 4, 3) pyramid normals. Assumes
    p0 == 0 (camera-frame planning), so t = 0 factors out of n.p(t)."""
    def nd(v):  # (*L, N, 4): normals @ v, summed left to right
        v = v[..., None, :]
        return normals[..., 0] * v[..., 0] + normals[..., 1] * v[..., 1] + normals[..., 2] * v[..., 2]

    roots, rvalid = _quartic_or_cubic_roots(
        nd(tr.alpha) / scalar(120.0, t1), nd(tr.beta) / scalar(24.0, t1),
        nd(tr.gamma) / scalar(6.0, t1),
        nd(tr.a0) / 2.0, nd(tr.v0))
    in_window = rvalid & (roots > t1[..., None, None]) & (roots < t2[..., None, None])
    any_hit = _rany(in_window)
    t_inc = torch.where(in_window, roots, -math.inf).flatten(-2).amax(dim=-1)
    t_dec = torch.where(in_window, roots, math.inf).flatten(-2).amin(dim=-1)
    return any_hit, torch.where(increasing, t_inc, t_dec)


def collision_check_plain(params: PlannerParams, pyrs: PyramidSet, tr: traj_mod.Traj, enabled,
                          pops=None):
    """Pyramid-partition collision check of N camera-frame candidates: the
    plain version of the collision-check kernel (`cuda_plan.collision_check`).

    The JAX package runs a per-candidate while_loop (vmapped) that pops
    monotone sections from a fixed stack until none is live, one is
    uncovered, or MAX_CHECK_ITERS pops. Here all candidates run
    MAX_CHECK_ITERS masked steps; a candidate whose loop would have ended
    keeps its state, so the result is identical and nothing syncs.

    enabled: (*L, N) bool, False skips a candidate. Returns (free, fail_px,
    fail_py, fail_depth): the pixel and depth of each candidate's first
    uncovered section's deepest point (0s when none). pops: None, or an
    int32 (*L, N) tensor that receives the steps in which each candidate was
    still running (the JAX package's loop's pops, the kernel's count)."""
    t1s, t2s, valid = monotonic_sections(tr)
    live = valid & enabled[..., None]
    dev = tr.tf.device
    status = torch.zeros(tr.tf.shape, dtype=torch.int32, device=dev)
    zf = torch.zeros(tr.tf.shape, dtype=torch.float32, device=dev)
    fail = (zf, zf, zf)
    slot_iota = torch.arange(MAX_SECTIONS, device=dev)
    two = torch.full_like(status, 2)

    count = torch.zeros_like(status) if pops is not None else None
    for _ in range(MAX_CHECK_ITERS):
        running = torch.any(live, dim=-1) & (status == 0)
        if count is not None:
            count = count + running.to(torch.int32)
        # pop the first live section (order only affects pyramid reuse)
        oh = slot_iota == torch.argmax(live.to(torch.int8), dim=-1, keepdim=True)
        t1 = torch.where(oh, t1s, 0.0).sum(-1)
        t2 = torch.where(oh, t2s, 0.0).sum(-1)

        z1 = _poly_at(tr, 2, t1)
        z2 = _poly_at(tr, 2, t2)
        increasing = z1 < z2
        deep_t = torch.where(increasing, t2, t1)
        deep_z = torch.maximum(z1, z2)
        # skip sections fully closer than the min checking distance
        skip = (z1 < params.min_check_dist) & (z2 < params.min_check_dist)

        pos_deep = torch.stack([_poly_at(tr, 0, deep_t), _poly_at(tr, 1, deep_t), deep_z], dim=-1)
        px, py = project(params.cam, pos_deep)
        found, pidx = find_containing_pyramid(pyrs, px, py, deep_z)

        # no pyramid -> collision (conservative); remember where
        no_cover = ~skip & ~found
        first_fail = running & no_cover & (status == 0)
        fail = tuple(torch.where(first_fail, v, f) for f, v in zip(fail, (px, py, deep_z)))
        status = torch.where(running & no_cover, two, status)

        normals = _take(pyrs.normals, pidx, 2)  # (*L, N, 4, 3)
        hit, t_col = _deepest_collision_time(tr, normals, t1, t2, increasing)

        # remainder section outside the pyramid goes back into the freed slot
        new_t1 = torch.where(increasing, t1, t_col)
        new_t2 = torch.where(increasing, t_col, t2)
        push = ~skip & found & hit & ((new_t2 - new_t1) > 1e-6)
        upd = oh & running[..., None]
        t1s = torch.where(upd & push[..., None], new_t1[..., None], t1s)
        t2s = torch.where(upd & push[..., None], new_t2[..., None], t2s)
        live = torch.where(upd, push[..., None], live)

    free = (status == 0) & ~torch.any(live, dim=-1)
    if count is not None:
        pops.copy_(count)
    collision_check_plain.calls += 1
    return free, fail[0], fail[1], fail[2]


collision_check_plain.calls = 0  # calls since the last reset


def collision_check(params: PlannerParams, pyrs: PyramidSet, tr: traj_mod.Traj, enabled=None):
    """`collision_check_plain`'s result for (*L, N) candidates (enabled
    None: every candidate): on CUDA tensors one launch of the collision-check
    kernel, on CPU tensors the plain version."""
    from agrifly_tpu_torch.planner import cuda_plan

    return cuda_plan.collision_check(params, pyrs, tr, enabled)


def is_collision_free(params: PlannerParams, pyrs: PyramidSet, tr: traj_mod.Traj, enabled=None):
    """(*L, N) bool: the candidates the pyramid set proves free, the first
    output of `collision_check` (enabled None: every candidate)."""
    return collision_check(params, pyrs, tr, enabled)[0]


# =============================================================================
# full planner
# =============================================================================


class PlanResult(NamedTuple):
    found: torch.Tensor  # (*L,) bool
    best_idx: torch.Tensor  # (*L,) int64 into the candidate batch
    best_cost: torch.Tensor
    traj: traj_mod.Traj  # the selected candidate
    num_candidates: int
    num_feasible: torch.Tensor  # input-feasible
    num_velocity_admissible: torch.Tensor
    num_collision_free: torch.Tensor
    num_pyramids: torch.Tensor


def _greedy_seed_dedupe(px, py, z, valid, tol_px, tol_z):
    """Greedy first-wins dedupe of inflation seeds ordered by priority: seed
    j drops when an earlier KEPT seed lies within tol_px pixels on both axes
    and tol_z meters in depth. Seeds (*L, M)."""
    pair = lambda v: torch.abs(v[..., :, None] - v[..., None, :])  # noqa: E731
    close = (pair(px) <= tol_px) & (pair(py) <= tol_px) & (pair(z) <= tol_z)
    idx = torch.arange(px.shape[-1], device=px.device)
    later = idx[None, :] > idx[:, None]
    keep = valid
    for j in range(px.shape[-1]):
        keep = keep & ~(keep[..., j, None] & close[..., j, :] & later[j])
    return keep


def gated_order(gate, cost):
    """The candidates (*L, N) by cost, the gated ones first: the stable
    order of where(gate, cost, inf) that seeds the pyramid rounds."""
    return torch.argsort(torch.where(gate, cost, math.inf), dim=-1, stable=True)


def round_seeds_plain(work: Work, gate, cost, epx, epy, endz, pyrs, rnd: int, per_round: int):
    """Round `rnd`'s seeds: the endpoints (epx, epy, endz: (*L, N)) of the
    gated order's candidates rnd * per_round ... (rnd + 1) * per_round - 1,
    valid where gated and (for a round after the first, `pyrs` the set so
    far) not already inside a pyramid. Returns (seed rows (*L, P, 12) on the
    work image, seed mask (*L, P)). The plain version of the round-seeds
    kernel (`cuda_rounds.round_seeds`)."""
    round_seeds_plain.calls += 1
    take = gated_order(gate, cost)[..., rnd * per_round:(rnd + 1) * per_round]
    seed_valid = _take(gate, take)
    px_t, py_t, z_t = _take(epx, take), _take(epy, take), _take(endz, take)
    if pyrs is not None:
        # skip seeds already covered by an existing pyramid
        f, _ = find_containing_pyramid(pyrs, px_t, py_t, z_t)
        seed_valid = seed_valid & ~f
    return work_rows(work, px_t, py_t, z_t), seed_valid


round_seeds_plain.calls = 0  # calls since the last reset


def lazy_seeds_plain(params: PlannerParams, work: Work, img, gate, free, fail_px, fail_py,
                     fail_z, cost, pyrs: PyramidSet, per_round: int):
    """A lazy round's seeds (DepthImagePlanner.cpp:270-273): the cheapest
    gated candidates that failed for lack of a covering pyramid donate
    their uncovered deepest points; 4 x per_round of them are considered,
    the doomed prefiltered on the work image, near-identical survivors
    deduped, and 2 x per_round inflated, the kept first. img: the full
    (*L, H, W) int32 depth codes. Returns (seed rows (*L, 2 per_round, 12),
    seed mask, failed (*L, N): the candidates the round re-checks). The
    plain version of the lazy-seeds kernel (`cuda_rounds.lazy_seeds`)."""
    lazy_seeds_plain.calls += 1
    scale = params.cam.depth_scale
    ignore_i = (params.true_radius / scale).to(torch.int32)
    failed = gate & ~free & (fail_z > 0)
    # a fail point whose own pixel is blocked shallower than the
    # required pyramid depth can never inflate
    pxi = torch.clamp(fail_px.to(torch.int32), 0, params.cam.width - 1)
    pyi = torch.clamp(fail_py.to(torch.int32), 0, params.cam.height - 1)
    seed_code = _take(img.flatten(-2), pyi.long() * params.cam.width + pxi.long())
    minpyr_i = ((fail_z + scale + params.plan_radius) / scale).to(torch.int32)
    seedable = failed & ((seed_code <= ignore_i) | (seed_code >= minpyr_i))
    # consider 4x more fail points than slots; prefilter the doomed,
    # dedupe near-identical survivors, inflate 2x per_round of them
    take = gated_order(seedable, cost)[..., :4 * per_round]
    px_t, py_t, z_t = _take(fail_px, take), _take(fail_py, take), _take(fail_z, take)
    covered, _ = find_containing_pyramid(pyrs, px_t, py_t, z_t)
    seed_valid = _take(seedable, take) & ~covered
    # one depth-code quantum deeper, so the floored pyramid base clears z
    seed_depth = z_t + scale
    seed_valid = _prefilter(work, px_t, py_t, seed_depth, seed_valid)
    keep = _greedy_seed_dedupe(px_t, py_t, z_t, seed_valid,
                               float(LAZY_DEDUPE_PX), LAZY_DEDUPE_Z_QUANTA * scale)
    sel = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)[..., :2 * per_round]
    return (work_rows(work, _take(px_t, sel), _take(py_t, sel), _take(seed_depth, sel)),
            _take(keep, sel), failed)


lazy_seeds_plain.calls = 0  # calls since the last reset


def plan_debug(params: PlannerParams, depth_u16, samples, vel0, acc0, grav, goal_cam,
               pyramid_capacity=32, rounds=2, inflation_downsample=1, lazy_rounds=1,
               cost_fn=None):
    """Planning internals for explicit samples (px, py, depth, tf): returns
    (tr, cost, feas, vel_ok, gate, collision_free, pyrs)."""
    return _plan_core(params, depth_u16, candidate_pass(params, samples, vel0, acc0, goal_cam,
                                                        cost_fn),
                      grav, pyramid_capacity, rounds, inflation_downsample, lazy_rounds)


class Candidates(NamedTuple):
    """A plan's candidates (*L, N) and what the rounds read of them."""

    tr: traj_mod.Traj
    cost: torch.Tensor  # (*L, N) the plan's cost
    epx: torch.Tensor  # (*L, N) the endpoints' pixels and depth (`endpoint_seeds`)
    epy: torch.Tensor
    endz: torch.Tensor


def candidate_pass(params: PlannerParams, samples, vel0, acc0, goal_cam, cost_fn=None):
    """The candidates of explicit samples (px, py, depth, tf), their costs
    (cost_fn(tr), or `exploration_cost` toward goal_cam) and endpoint seeds."""
    tr = candidates_from_samples(params, *samples, vel0, acc0)
    cost = exploration_cost(tr, goal_cam) if cost_fn is None else cost_fn(tr)
    return Candidates(tr, cost, *endpoint_seeds(params, tr))


def plan(params: PlannerParams, depth_u16, u, vel0, acc0, grav, goal_cam,
         pyramid_capacity=32, rounds=2, inflation_downsample=1, lazy_rounds=1,
         cost_fn=None, candidates=None):
    """One planning call per (H, W) depth-code image of depth_u16
    (*L, H, W): sample from the (*L, 4, N) uniform block u, gate, build
    pyramids, pick the cheapest free candidate. All vectors are
    camera-frame (main.cpp:489-495), (*L, 3). cost_fn maps the candidates
    (a Traj) to (*L, N) costs; None takes `exploration_cost(tr, goal_cam)`.
    candidates: the `Candidates` of u made already (the orchard frame's
    percept head), in place of sampling them here."""
    if candidates is None:
        candidates = candidate_pass(params, samples_from_uniform(params, u), vel0, acc0,
                                    goal_cam, cost_fn)
    tr, cost, feas, vel_ok, gate, collision_free, pyrs = _plan_core(
        params, depth_u16, candidates, grav, pyramid_capacity, rounds, inflation_downsample,
        lazy_rounds)
    ok = gate & collision_free
    best_cost = torch.where(ok, cost, math.inf)
    best = torch.argmin(best_cost, dim=-1, keepdim=True)
    count = lambda m: m.sum(dim=-1, dtype=torch.int32)  # noqa: E731
    return PlanResult(
        found=torch.any(ok, dim=-1),
        best_idx=best[..., 0],
        best_cost=_take(best_cost, best)[..., 0],
        traj=traj_mod.Traj(*(_take(x, best, 1)[..., 0, :] if x.dim() > cost.dim()
                             else _take(x, best)[..., 0] for x in tr)),
        num_candidates=cost.shape[-1],
        num_feasible=count(feas),
        num_velocity_admissible=count(feas & vel_ok),
        num_collision_free=count(ok),
        num_pyramids=count(pyrs.valid),
    )


def _plan_core(params, depth_u16, candidates: Candidates, grav, pyramid_capacity, rounds,
               inflation_downsample, lazy_rounds):
    """Shared planning pipeline: gates, pyramid rounds (pre-planned + lazy
    on-demand), collision labels. On CUDA tensors each step is a kernel
    launch: the gates (K8), each round's seeds (K10, or K12 in a lazy
    round), inflation (K2/K2c) and pyramid set (K11), each collision check
    (K7); on CPU tensors their plain versions."""
    from agrifly_tpu_torch.planner import cuda_inflate, cuda_plan, cuda_rounds

    tr, cost, epx, epy, endz = candidates
    feas, vel_ok = cuda_plan.plan_gates(
        tr, grav[..., None, :], params.fmin, params.fmax, params.wmax, params.min_section_time,
        params.vmax,
        # sampler durations are U(2,3) s: identical verdicts, fewer levels
        static_max_tf=3.0)
    gate = feas & vel_ok

    # pyramid seeds: endpoints of the cheapest gated candidates; the
    # inflation's image pooled once a plan
    work = work_image(params, depth_u16, inflation_downsample)
    per_round = pyramid_capacity // (rounds + lazy_rounds)
    # as in the JAX package, the first round's merge sets the capacity of the
    # set to pyramid_capacity - per_round
    pyrs = None
    for rnd in range(rounds):
        rows, seed_valid = cuda_rounds.round_seeds(work, gate, cost, epx, epy, endz, pyrs, rnd,
                                                   per_round)
        out = cuda_inflate.inflate_rows(work.params, work.img, rows)
        pyrs = cuda_rounds.pyramid_set(params, work, out, seed_valid, per_round,
                                       pyramid_capacity - per_round if pyrs is None else pyrs)
    if pyrs is None:
        pyrs = empty_pyramid_set(pyramid_capacity, tr.tf.device, tr.tf.shape[:-1])

    collision_free, fail_px, fail_py, fail_z = collision_check(params, pyrs, tr)

    # lazy rounds: only the candidates that donated fail points are re-checked
    img = depth_u16.to(torch.int32)
    for _ in range(lazy_rounds):
        rows, seed_valid, failed = cuda_rounds.lazy_seeds(
            params, work, img, gate, collision_free, fail_px, fail_py, fail_z, cost, pyrs,
            per_round)
        out = cuda_inflate.inflate_rows(work.params, work.img, rows)
        pyrs = cuda_rounds.pyramid_set(params, work, out, seed_valid, per_round, pyrs)
        refree, fail_px2, fail_py2, fail_z2 = collision_check(params, pyrs, tr, failed)
        collision_free = torch.where(failed, refree, collision_free)
        fail_px = torch.where(failed, fail_px2, fail_px)
        fail_py = torch.where(failed, fail_py2, fail_py)
        fail_z = torch.where(failed, fail_z2, fail_z)

    return tr, cost, feas, vel_ok, gate, collision_free, pyrs


# =============================================================================
# self-evaluation harnesses (MeasureConservativeness /
# MeasureCollisionCheckingSpeed parity, DepthImagePlanner.cpp:972-1029)
# =============================================================================
#
# Each takes the (*L, 4, N) uniform block u where the JAX package takes a
# key (it draws u = uniform(key, (4, N))), and a leading vehicle shape L.
# Inflation runs through `build_pyramid_set`, so on the card through the
# inflation kernel with one seed per block, as the JAX harnesses inflate.


def _count(mask):
    return mask.sum(dim=-1, dtype=torch.int32)


def _endpoint_pyramids(params, depth_u16, tr, pyramid_limit):
    """A pyramid seeded at every candidate's endpoint, all seeds valid; the
    `pyramid_limit` shallowest kept."""
    return build_pyramid_set(params, depth_u16, *endpoint_seeds(params, tr),
                             torch.ones_like(tr.tf, dtype=torch.bool), pyramid_limit)


def measure_conservativeness(params: PlannerParams, depth_u16, u, vel0, acc0, grav,
                             pyramid_limit=32):
    """Section IV.A of the RAPPIDS paper: how many of the N candidates does
    the pyramid check mislabel as in collision against the ray-sphere
    oracle? Pyramids are seeded at all N endpoints.

    Returns (num_incorrect_in_collision, num_correct_in_collision), (*L,)
    int32. grav is unused, as in the JAX package."""
    from agrifly_tpu_torch.planner import oracle

    tr = sample_candidates(params, u, vel0, acc0)
    pyrs = _endpoint_pyramids(params, depth_u16, tr, pyramid_limit)
    collides_planner = ~is_collision_free(params, pyrs, tr)
    collides_oracle = ~oracle.is_collision_free_ground_truth(params, depth_u16, tr)
    return (_count(collides_planner & ~collides_oracle),
            _count(collides_planner & collides_oracle))


def measure_plan_conservativeness(params: PlannerParams, depth_u16, u, vel0, acc0, grav,
                                  goal_cam, pyramid_capacity=32, rounds=2, lazy_rounds=1,
                                  inflation_downsample=1):
    """`plan`-level conservativeness against the ray-sphere oracle, with the
    planner's own pyramid rounds: candidates the planner mislabels in
    collision because no pyramid covered a section.

    Returns (num_incorrect_in_collision, num_correct_in_collision,
    num_collision_free), (*L,) int32."""
    from agrifly_tpu_torch.planner import oracle

    tr, _, _, _, gate, collision_free, _ = plan_debug(
        params, depth_u16, samples_from_uniform(params, u), vel0, acc0, grav, goal_cam,
        pyramid_capacity, rounds, inflation_downsample, lazy_rounds)
    free_oracle = oracle.is_collision_free_ground_truth(params, depth_u16, tr)
    collides_planner = gate & ~collision_free
    return (_count(collides_planner & free_oracle), _count(collides_planner & ~free_oracle),
            _count(gate & collision_free))


def measure_collision_checking_speed(params: PlannerParams, depth_u16, u, vel0, acc0, grav,
                                     pyramid_limit=32):
    """Section IV.B: wall-clock time of the batched collision check of the
    N candidates against pyramids seeded at their endpoints. The pyramid
    build is outside the timed window, as in the reference; one warm call
    comes first (the JAX package compiles first), and on the card the
    window is synchronised at both ends.

    Returns (seconds, seconds per trajectory over all (*L, N) candidates,
    pyramids used over all vehicles)."""
    tr = sample_candidates(params, u, vel0, acc0)
    pyrs = _endpoint_pyramids(params, depth_u16, tr, pyramid_limit)
    cuda = tr.tf.is_cuda

    def sync():
        if cuda:
            torch.cuda.synchronize(tr.tf.device)

    is_collision_free(params, pyrs, tr)
    sync()
    t0 = time.perf_counter()
    is_collision_free(params, pyrs, tr)
    sync()
    dt = time.perf_counter() - t0
    return dt, dt / tr.tf.numel(), int(pyrs.valid.sum())


def exploration_direction_cost(tr: traj_mod.Traj, direction):
    """Direction cost (DepthImagePlanner.hpp:486-515, the default of
    FindFastestTrajRandomCandidates): minus the distance travelled along
    `direction` (3,) or (*L, 3) per unit time, (*L, N)."""
    d = torch.as_tensor(direction, dtype=torch.float32, device=tr.tf.device)
    d = d / norm3(d, keepdim=True)
    end = traj_mod.position(tr, tr.tf)
    return -dot3(end, d[..., None, :]) / tr.tf


def find_fastest_trajectory(params: PlannerParams, depth_u16, u, vel0, acc0, grav,
                            exploration_direction, pyramid_capacity=32, rounds=2,
                            inflation_downsample=1):
    """FindFastestTrajRandomCandidates parity: `plan` with the direction
    cost and a zero goal."""
    goal = torch.zeros(vel0.shape, dtype=torch.float32, device=vel0.device)
    return plan(params, depth_u16, u, vel0, acc0, grav, goal,
                pyramid_capacity=pyramid_capacity, rounds=rounds,
                inflation_downsample=inflation_downsample,
                cost_fn=lambda tr: exploration_direction_cost(tr, exploration_direction))
