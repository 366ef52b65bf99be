"""Pinhole depth renderer: per-pixel 2-D grid march over the orchard.

Port of `render_depth`, `camera_attitude` and `DEPTH_CAM_YPR` from
`agrifly_tpu/render/raycast.py`. `render_depth` is the plain version of the
raycast kernel (`render/cuda_raycast.py`, `csrc/raycast.cu`): it computes
each pixel with the same float32 operations in the same order, so on the
card the kernel's codes equal it bit for bit. It divides only by tensors
(see `ops.fmath.scalar`) for that reason.

Depth is planar (distance along the optical axis); the output is the
uint8-style code depth / (far/256), 255 = no hit within the far plane.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from agrifly_tpu_torch.ops import rotation as rot
from agrifly_tpu_torch.ops.fmath import scalar, sqrt
from agrifly_tpu_torch.render import orchard as orch

# depth camera mounting (Rappids_Simulator/main.cpp:123-126)
DEPTH_CAM_YPR = (-math.pi / 2.0, 0.0, -math.pi / 2.0)
DEPTH_CAM_Q = rot.from_euler_ypr_np(*DEPTH_CAM_YPR)  # float64 (4,)

BIG = 1e9


class RenderConfig(NamedTuple):
    width: int
    height: int
    focal: float
    far: float
    dda_steps: int  # grid-cell visits per ray


def make_config(width=640, height=480, focal=None, far=10.0, dda_steps=8) -> RenderConfig:
    return RenderConfig(
        width=int(width), height=int(height),
        focal=float(focal if focal is not None else width / 2.0),
        far=float(far), dda_steps=int(dda_steps),
    )


def mount_quaternion(like: torch.Tensor) -> torch.Tensor:
    """The camera mount as a float32 quaternion on `like`'s device."""
    return torch.tensor(DEPTH_CAM_Q, dtype=like.dtype, device=like.device)


def camera_attitude(body_att):
    """World-from-camera quaternion: body attitude composed with the mount."""
    return rot.qmul(body_att, mount_quaternion(body_att).expand_as(body_att))


def _sphere(o, d, cx, cy, cz, radius):
    ox, oy, oz = o
    dx, dy, dz = d
    sx, sy, sz = ox - cx, oy - cy, oz - cz
    a = dx * dx + dy * dy + dz * dz
    b = 2.0 * (sx * dx + sy * dy + sz * dz)
    c = sx * sx + sy * sy + sz * sz - radius * radius
    disc = b * b - 4.0 * a * c
    sq = sqrt(torch.clamp(disc, min=0.0))
    s0 = (-b - sq) / (2.0 * a)
    s1 = (-b + sq) / (2.0 * a)
    s = torch.where(s0 > 0, s0, s1)
    return torch.where((disc >= 0) & (s > 0), s, BIG)


def tree_hit(scene: orch.OrchardParams, ix, iy, o, d):
    """t of the first hit with the tree of cell (ix, iy), BIG for none."""
    f = orch.tree_fields(scene, ix, iy)
    ox, oy, oz = o
    dx, dy, dz = d

    # trunk cylinder
    rx = ox - f["cx"]
    ry = oy - f["cy"]
    a = dx * dx + dy * dy
    b = 2.0 * (rx * dx + ry * dy)
    c = rx * rx + ry * ry - f["trunk_r"] * f["trunk_r"]
    disc = b * b - 4.0 * a * c
    ok = (disc >= 0) & (a > 1e-12)
    sq = sqrt(torch.clamp(disc, min=0.0))
    a_safe = torch.where(a > 1e-12, a, torch.ones_like(a))
    t0 = (-b - sq) / (2.0 * a_safe)
    t1 = (-b + sq) / (2.0 * a_safe)
    t = torch.where(t0 > 0, t0, t1)
    z = oz + t * dz
    t_trunk = torch.where(ok & (t > 0) & (z >= 0.0) & (z <= f["trunk_h"]), t, BIG)

    t_c1 = _sphere(o, d, f["cx"], f["cy"], f["can_h"], f["can_r"])
    t_c2 = _sphere(o, d, f["c2x"], f["c2y"], f["c2z"], f["c2r"])
    t = torch.minimum(t_trunk, torch.minimum(t_c1, t_c2))
    return torch.where(f["present"], t, BIG)


# the early exit's float margins (csrc/raycast.cu kReachRel ... kSlackLin)
_REACH_REL = 1.0 + 2.0 ** -14
_REACH_ABS = 2.0 ** -14
_SLACK_SQRT = 2.0 ** -9
_SLACK_LIN = 2.0 ** -18


def _march(cfg: RenderConfig, scene: orch.OrchardParams, cam_pos, cam_att, early_exit: bool):
    """The ray set-up and the DDA over orchard cells. Returns the codes and,
    with early_exit, which stops a pixel's march as `csrc/raycast.cu` does
    (see `render_depth_exit`), the cells each pixel evaluated (else None)."""
    H, W = cfg.height, cfg.width
    dev = cam_pos.device
    focal = scalar(cfg.focal, cam_pos)
    col = (torch.arange(W, dtype=torch.float32, device=dev) - W / 2.0) / focal
    row = (torch.arange(H, dtype=torch.float32, device=dev) - H / 2.0) / focal
    col = col[None, :]
    row = row[:, None]

    R = rot.to_matrix(cam_att)[..., None, None]  # (..., 3, 3, 1, 1)
    # world ray dir = R @ (col, row, 1), z == 1 in the camera frame so the
    # ray parameter t is planar depth
    dx = R[..., 0, 0, :, :] * col + R[..., 0, 1, :, :] * row + R[..., 0, 2, :, :]
    dy = R[..., 1, 0, :, :] * col + R[..., 1, 1, :, :] * row + R[..., 1, 2, :, :]
    dz = R[..., 2, 0, :, :] * col + R[..., 2, 1, :, :] * row + R[..., 2, 2, :, :]
    shape = dx.shape
    ox, oy, oz = (cam_pos[..., i, None, None].expand(shape) for i in range(3))

    # ground plane z = 0
    dz_safe = torch.where(torch.abs(dz) < 1e-9, 1e-9, dz)
    t_ground = -oz / dz_safe
    best = torch.where((t_ground > 0) & (dz != 0), t_ground, BIG)

    # 2-D DDA over orchard cells in the (x, y) plane
    fx = ox / scene.tree_spacing
    fy = oy / scene.row_spacing
    ix = torch.floor(fx).to(torch.int32)
    iy = torch.floor(fy).to(torch.int32)
    gdx = dx / scene.tree_spacing
    gdy = dy / scene.row_spacing
    one = torch.ones((), dtype=torch.int32, device=dev)
    step_x = torch.where(gdx >= 0, one, -one)
    step_y = torch.where(gdy >= 0, one, -one)
    tiny_x = torch.where(gdx >= 0, 1e-9, -1e-9).to(torch.float32)
    tiny_y = torch.where(gdy >= 0, 1e-9, -1e-9).to(torch.float32)
    inv_dx = 1.0 / torch.where(torch.abs(gdx) < 1e-9, tiny_x, gdx)
    inv_dy = 1.0 / torch.where(torch.abs(gdy) < 1e-9, tiny_y, gdy)
    next_x = (ix.to(torch.float32) + (step_x > 0).to(torch.float32) - fx) * inv_dx
    next_y = (iy.to(torch.float32) + (step_y > 0).to(torch.float32) - fy) * inv_dy
    t_dx = torch.abs(inv_dx)
    t_dy = torch.abs(inv_dy)

    scale = scalar(cfg.far / 256.0, best)
    cells = None
    if early_exit:
        exits = orch.contained(scene)
        far256 = scale * 256.0
        adx = torch.abs(dx) + torch.abs(dy) + torch.abs(dz)
        po = 1.0 + torch.abs(ox) + torch.abs(oy) + torch.abs(oz)
        sr = scene.tree_spacing + scene.row_spacing
        active = torch.ones(shape, dtype=torch.bool, device=dev)
        cells = torch.zeros(shape, dtype=torch.int32, device=dev)

    # one pass is exact: each tree lies inside its own cell
    o, d = (ox, oy, oz), (dx, dy, dz)
    for k in range(cfg.dda_steps):
        hit = torch.minimum(best, tree_hit(scene, ix, iy, o, d))
        if not early_exit:
            best = hit
        else:
            best = torch.where(active, hit, best)
            cells = cells + active.to(torch.int32)
        if early_exit and k + 1 < cfg.dda_steps:
            # csrc/raycast.cu beyond_next_cells, its margins derived there
            lim = torch.where(best < far256, best, far256)
            reach = lim * _REACH_REL + _REACH_ABS * sr
            slack = _SLACK_SQRT * (reach * adx + sr) + _SLACK_LIN * po
            qx = ox + reach * dx
            qy = oy + reach * dy
            bx = (ix + (step_x > 0).to(torch.int32)).to(torch.float32) * scene.tree_spacing
            by = (iy + (step_y > 0).to(torch.int32)).to(torch.float32) * scene.row_spacing
            in_x = torch.where(step_x > 0, qx <= bx - slack, qx >= bx + slack)
            in_y = torch.where(step_y > 0, qy <= by - slack, qy >= by + slack)
            active = active & ~(exits & in_x & in_y)
        go_x = next_x <= next_y
        ix = torch.where(go_x, ix + step_x, ix)
        iy = torch.where(go_x, iy, iy + step_y)
        next_x = torch.where(go_x, next_x + t_dx, next_x)
        next_y = torch.where(go_x, next_y, next_y + t_dy)

    # clip in float before the int cast: a miss is t = 1e9, whose code does
    # not fit an int32
    code = torch.floor(best / scale)
    return torch.clamp(code, 0.0, 255.0).to(torch.int32), cells


def render_depth(cfg: RenderConfig, scene: orch.OrchardParams, cam_pos, cam_att):
    """Render depth frames.

    cam_pos: (..., 3) world camera positions; cam_att: (..., 4) world-from-
    camera quaternions (see camera_attitude). Returns (..., H, W) int32 codes
    in [0, 255], 255 = beyond the far plane.
    """
    return _march(cfg, scene, cam_pos, cam_att, early_exit=False)[0]


def render_depth_exit(cfg: RenderConfig, scene: orch.OrchardParams, cam_pos, cam_att):
    """The plain mirror of the raycast kernel's traversal: render_depth
    with the kernel's exact early exit, in its float32 operations. After
    each cell, a pixel whose ray can no longer reach the next cell before
    min(best, far) stops, where `orchard.contained(scene)`
    holds; later cells could not change its code. Returns (codes, equal to
    render_depth's, and the (..., H, W) int32 number of cells each pixel
    evaluated). The tests and chip_smoke.py use it; the frame does not."""
    return _march(cfg, scene, cam_pos, cam_att, early_exit=True)
