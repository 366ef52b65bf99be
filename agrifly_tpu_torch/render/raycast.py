"""Pinhole renderer of the orchard: per-pixel 2-D grid march, depth and RGB.

Port of `agrifly_tpu/render/raycast.py`. `render_depth` is the plain
version of the raycast kernel and `render_rgb` that of its RGB instance
(`render/cuda_raycast.py`, `csrc/raycast.cu`, K1 and K1-rgb): each
computes a pixel with the same float32 operations in the same order, so on
the card a kernel's output equals it bit for bit. They divide only by
tensors (see `ops.fmath.scalar`) and write every dot product and norm as a
left-to-right sum of three products for that reason.

Depth is planar (distance along the optical axis); the output is the
uint8-style code depth / (far/256), 255 = no hit within the far plane.
The RGB image shades the same geometry: Lambertian light on each
material's colour, a sky, and a haze toward the sky colour with distance
(`shade`, which the imported world's RGB pass shares).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from agrifly_tpu_torch.ops import rotation as rot
from agrifly_tpu_torch.ops.fmath import const, scalar, sqrt
from agrifly_tpu_torch.render import orchard as orch

# depth camera mounting (Rappids_Simulator/main.cpp:123-126)
DEPTH_CAM_YPR = (-math.pi / 2.0, 0.0, -math.pi / 2.0)
DEPTH_CAM_Q = rot.from_euler_ypr_np(*DEPTH_CAM_YPR)  # float64 (4,)

BIG = 1e9

# materials of the RGB pass
MAT_SKY = 0
MAT_GROUND = 1
MAT_TRUNK = 2
MAT_CANOPY = 3

# material base colours (RGB, 0..1), by material id
COLORS = (
    (0.62, 0.78, 0.95),  # sky
    (0.45, 0.38, 0.25),  # orchard soil
    (0.35, 0.22, 0.12),  # trunk bark
    (0.18, 0.45, 0.15),  # canopy leaves
)


def _unit(v):
    """v / |v| in float32, the norm's squares summed left to right."""
    v = np.asarray(v, np.float32)
    n = np.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    return tuple(float(c) for c in v / n)


SUN = _unit((0.45, 0.2, 0.87))  # the unit sun direction (float32 values)


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
    return const(tuple(float(v) for v in DEPTH_CAM_Q), like.device, like.dtype)


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


def tree_hits(scene: orch.OrchardParams, ix, iy, o, d):
    """The tree of cell (ix, iy) (orchard.tree_fields) and the rays' t with
    its trunk and with its nearer canopy sphere, BIG for a miss, whether
    the tree is present or not."""
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
    return f, t_trunk, torch.minimum(t_c1, t_c2)


def tree_hit(scene: orch.OrchardParams, ix, iy, o, d):
    """t of the first hit with the tree of cell (ix, iy), BIG for none."""
    f, t_trunk, t_can = tree_hits(scene, ix, iy, o, d)
    return torch.where(f["present"], torch.minimum(t_trunk, t_can), BIG)


# the early exit's float margins (csrc/raycast.cu kReachRel ... kSlackLin),
# and the RGB pass's clear exit's (kClimb, kClearSqrt, kClearLin)
_REACH_REL = 1.0 + 2.0 ** -14
_REACH_ABS = 2.0 ** -14
_SLACK_SQRT = 2.0 ** -9
_SLACK_LIN = 2.0 ** -18
_CLIMB = 2.0 ** -7
_CLEAR_SQRT = 2.0 ** -8
_CLEAR_LIN = 2.0 ** -17


def _rays(cfg: RenderConfig, cam_pos, cam_att):
    """Each pixel's ray: origins (ox, oy, oz) and world directions (dx, dy,
    dz), each (..., H, W), with z = 1 in the camera frame (so the ray
    parameter t is planar depth), and the ground plane's t (BIG for none)."""
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
    return (ox, oy, oz), (dx, dy, dz), best


class _Dda(NamedTuple):
    """A 2-D DDA over orchard cells in the (x, y) plane: the current cell,
    its steps and the t of the next cell boundary in x and in y."""
    ix: torch.Tensor
    iy: torch.Tensor
    step_x: torch.Tensor
    step_y: torch.Tensor
    next_x: torch.Tensor
    next_y: torch.Tensor
    t_dx: torch.Tensor
    t_dy: torch.Tensor

    def advance(self):
        """The next cell: the neighbour across the nearer boundary."""
        go_x = self.next_x <= self.next_y
        return self._replace(
            ix=torch.where(go_x, self.ix + self.step_x, self.ix),
            iy=torch.where(go_x, self.iy, self.iy + self.step_y),
            next_x=torch.where(go_x, self.next_x + self.t_dx, self.next_x),
            next_y=torch.where(go_x, self.next_y, self.next_y + self.t_dy))


def _dda(scene: orch.OrchardParams, o, d) -> _Dda:
    ox, oy, _ = o
    dx, dy, _ = d
    fx = ox / scene.tree_spacing
    fy = oy / scene.row_spacing
    ix = torch.floor(fx).to(torch.int32)
    iy = torch.floor(fy).to(torch.int32)
    gdx = dx / scene.tree_spacing
    gdy = dy / scene.row_spacing
    one = torch.ones((), dtype=torch.int32, device=ix.device)
    step_x = torch.where(gdx >= 0, one, -one)
    step_y = torch.where(gdy >= 0, one, -one)
    tiny_x = torch.where(gdx >= 0, 1e-9, -1e-9).to(torch.float32)
    tiny_y = torch.where(gdy >= 0, 1e-9, -1e-9).to(torch.float32)
    inv_dx = 1.0 / torch.where(torch.abs(gdx) < 1e-9, tiny_x, gdx)
    inv_dy = 1.0 / torch.where(torch.abs(gdy) < 1e-9, tiny_y, gdy)
    next_x = (ix.to(torch.float32) + (step_x > 0).to(torch.float32) - fx) * inv_dx
    next_y = (iy.to(torch.float32) + (step_y > 0).to(torch.float32) - fy) * inv_dy
    return _Dda(ix, iy, step_x, step_y, next_x, next_y, torch.abs(inv_dx), torch.abs(inv_dy))


class _Exit(NamedTuple):
    """The early exit's per-pixel terms (csrc/raycast.cu render_pixel)."""
    exits: torch.Tensor  # orchard.contained: the scene allows the exit
    adx: torch.Tensor  # |dx| + |dy| + |dz|
    po: torch.Tensor  # 1 + |ox| + |oy| + |oz|
    sr: torch.Tensor  # tree_spacing + row_spacing

    @classmethod
    def of(cls, scene: orch.OrchardParams, o, d):
        (ox, oy, oz), (dx, dy, dz) = o, d
        return cls(orch.contained(scene), torch.abs(dx) + torch.abs(dy) + torch.abs(dz),
                   1.0 + torch.abs(ox) + torch.abs(oy) + torch.abs(oz),
                   scene.tree_spacing + scene.row_spacing)

    def beyond_next_cells(self, scene, g: _Dda, o, d, best, cap):
        """Where no later cell of the march can bring a hit nearer than
        min(best, cap) (csrc/raycast.cu beyond_next_cells, its margins derived
        there)."""
        (ox, oy, _), (dx, dy, _) = o, d
        lim = torch.where(best < cap, best, cap)
        reach = lim * _REACH_REL + _REACH_ABS * self.sr
        slack = _SLACK_SQRT * (reach * self.adx + self.sr) + _SLACK_LIN * self.po
        qx = ox + reach * dx
        qy = oy + reach * dy
        bx = (g.ix + (g.step_x > 0).to(torch.int32)).to(torch.float32) * scene.tree_spacing
        by = (g.iy + (g.step_y > 0).to(torch.int32)).to(torch.float32) * scene.row_spacing
        in_x = torch.where(g.step_x > 0, qx <= bx - slack, qx >= bx + slack)
        in_y = torch.where(g.step_y > 0, qy <= by - slack, qy >= by + slack)
        return self.exits & in_x & in_y

    def clear_after(self, scene, o, d, best):
        """A t past which each ray meets no tree, inf where none is taken
        (csrc/raycast.cu clear_after, its margins derived there)."""
        oz, dz = o[2], d[2]
        z_top = orch.canopy_top(scene)
        t = ((z_top + _CLEAR_SQRT * self.sr + _CLEAR_LIN * (self.po + z_top) - oz)
             / (dz - _CLEAR_SQRT * self.adx))
        t = torch.where(t >= 0, t, torch.where(t < 0, 0.0, math.inf))
        return torch.where((dz > _CLIMB * self.adx) & ~(BIG < best), t, math.inf)


def _march(cfg: RenderConfig, scene: orch.OrchardParams, cam_pos, cam_att, early_exit: bool):
    """The ray set-up and the DDA over orchard cells. Returns the codes and,
    with early_exit, which stops a pixel's march as `csrc/raycast.cu` does
    (see `render_depth_exit`), the cells each pixel evaluated (else None)."""
    o, d, best = _rays(cfg, cam_pos, cam_att)
    shape, dev = best.shape, best.device
    g = _dda(scene, o, d)
    scale = scalar(cfg.far / 256.0, best)
    cells = None
    if early_exit:
        ex = _Exit.of(scene, o, d)
        far256 = scale * 256.0
        active = torch.ones(shape, dtype=torch.bool, device=dev)
        cells = torch.zeros(shape, dtype=torch.int32, device=dev)

    # one pass is exact: each tree lies inside its own cell
    for k in range(cfg.dda_steps):
        hit = torch.minimum(best, tree_hit(scene, g.ix, g.iy, o, d))
        if not early_exit:
            best = hit
        else:
            best = torch.where(active, hit, best)
            cells = cells + active.to(torch.int32)
        if early_exit and k + 1 < cfg.dda_steps:
            active = active & ~ex.beyond_next_cells(scene, g, o, d, best, far256)
        g = g.advance()

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


def render_depth_body(cfg: RenderConfig, scene: orch.OrchardParams, body_pos, body_att):
    """render_depth from vehicle poses (applies the depth-camera mount)."""
    return render_depth(cfg, scene, body_pos, camera_attitude(body_att))


# =============================================================================
# RGB rendering (the image stream beside the depth image)
# =============================================================================


def shade(cfg: RenderConfig, mat, normal, best):
    """The RGB pass's colour tail, shared by both worlds (and `csrc/shade.cuh`):
    Lambertian light 0.35 + 0.65 clip(n . SUN, 0, 1) on the material's
    colour, the sky colour where `mat` is MAT_SKY, then a haze toward the sky
    colour of 0.35 clip(best / far, 0, 1). mat (..., H, W) int32 in 0..3;
    normal (nx, ny, nz), each (..., H, W), unit; best (..., H, W) planar
    depth. Returns (..., H, W, 3) uint8, each channel clipped to [0, 255]
    and truncated."""
    nx, ny, nz = normal
    lam = torch.clamp(nx * SUN[0] + ny * SUN[1] + nz * SUN[2], 0.0, 1.0)
    light = 0.35 + 0.65 * lam
    colors = const(COLORS, best.device)
    sky = colors[MAT_SKY]
    haze = (torch.clamp(best / scalar(cfg.far, best), 0.0, 1.0) * 0.35)[..., None]
    color = torch.where((mat == MAT_SKY)[..., None], sky, colors[mat.long()] * light[..., None])
    color = color * (1 - haze) + sky * haze
    return torch.clamp(color * 255.0, 0.0, 255.0).to(torch.uint8)


def render_rgb(cfg: RenderConfig, scene: orch.OrchardParams, cam_pos, cam_att):
    """Shaded RGB frames of the same geometry as the depth pass.

    The march keeps the nearest cell's tree (strictly nearer, so the
    earlier cell wins a tie), its material (trunk where the trunk's t is at
    most the canopy's) and cell, over all `dda_steps` cells: a tree beyond
    the far plane still shades, hazed. Normals: the ground's +z, the
    trunk's radial direction, and the canopy sphere whose surface the hit
    is relatively nearer. cam_pos (..., 3), cam_att (..., 4) world-from-
    camera. Returns (..., H, W, 3) uint8."""
    return _rgb(cfg, scene, cam_pos, cam_att, None)[0]


def render_rgb_exit(cfg: RenderConfig, scene: orch.OrchardParams, cam_pos, cam_att,
                    clear=True):
    """The plain mirror of the RGB kernel's traversal (K1-rgb): render_rgb
    with the kernel's exact early exit, in its float32 operations. After
    each cell, where `orchard.contained(scene)` holds, a pixel stops whose
    ray can no longer reach the next cell before min(best, T), T the t past
    which a climbing ray runs above every tree (`orchard.canopy_top`; inf
    where the ray does not climb). clear=False leaves T out: the exit on
    best alone, the traversal before the clear exit. Returns (images, equal
    to render_rgb's, and the (..., H, W) int32 cells each pixel evaluated).
    The tests and chip_smoke.py use it; the bridge frame does not."""
    return _rgb(cfg, scene, cam_pos, cam_att, "clear" if clear else "best")[:2]


def _rgb(cfg: RenderConfig, scene: orch.OrchardParams, cam_pos, cam_att, early_exit):
    """render_rgb's march and shading; early_exit None (every cell), "best"
    or "clear" (see render_rgb_exit). Returns (images, cells or None, the
    (..., H, W) int32 winning material of each pixel)."""
    o, d, best = _rays(cfg, cam_pos, cam_att)
    g = _dda(scene, o, d)
    mat = torch.where(best < BIG, MAT_GROUND, MAT_SKY).to(torch.int32)
    hix = torch.zeros_like(g.ix)
    hiy = torch.zeros_like(g.iy)
    active = cells = None
    if early_exit is not None:
        ex = _Exit.of(scene, o, d)
        cap = (ex.clear_after(scene, o, d, best) if early_exit == "clear"
               else torch.full_like(best, math.inf))
        active = torch.ones(best.shape, dtype=torch.bool, device=best.device)
        cells = torch.zeros(best.shape, dtype=torch.int32, device=best.device)
    for k in range(cfg.dda_steps):
        f, t_trunk, t_can = tree_hits(scene, g.ix, g.iy, o, d)
        t_tree = torch.where(f["present"], torch.minimum(t_trunk, t_can), BIG)
        closer = t_tree < best
        if active is not None:
            closer = closer & active
            cells = cells + active.to(torch.int32)
        best = torch.where(closer, t_tree, best)
        mat = torch.where(closer, torch.where(t_trunk <= t_can, MAT_TRUNK, MAT_CANOPY), mat)
        hix = torch.where(closer, g.ix, hix)
        hiy = torch.where(closer, g.iy, hiy)
        if active is not None and k + 1 < cfg.dda_steps:
            active = active & ~ex.beyond_next_cells(scene, g, o, d, best, cap)
        g = g.advance()

    # hit point and the analytic normals of the winning cell's tree
    hx, hy, hz = (oc + best * dc for oc, dc in zip(o, d))
    f = orch.tree_fields(scene, hix, hiy)
    rx, ry = hx - f["cx"], hy - f["cy"]
    rn = sqrt(rx * rx + ry * ry)
    rn = torch.where(rn < 1e-9, 1.0, rn)
    c1 = (hx - f["cx"], hy - f["cy"], hz - f["can_h"])
    c2 = (hx - f["c2x"], hy - f["c2y"], hz - f["c2z"])
    n1 = sqrt(c1[0] * c1[0] + c1[1] * c1[1] + c1[2] * c1[2])
    n2 = sqrt(c2[0] * c2[0] + c2[1] * c2[1] + c2[2] * c2[2])
    use2 = (n2 / torch.clamp(f["c2r"], min=1e-6)) < (n1 / torch.clamp(f["can_r"], min=1e-6))
    nn = torch.where(use2, n2, n1)
    nn = torch.where(nn < 1e-9, 1.0, nn)
    trunk, canopy = mat == MAT_TRUNK, mat == MAT_CANOPY
    zero = torch.zeros_like(best)
    normal = (torch.where(trunk, rx / rn, torch.where(canopy, torch.where(use2, c2[0], c1[0]) / nn,
                                                      zero)),
              torch.where(trunk, ry / rn, torch.where(canopy, torch.where(use2, c2[1], c1[1]) / nn,
                                                      zero)),
              torch.where(trunk, zero, torch.where(canopy, torch.where(use2, c2[2], c1[2]) / nn,
                                                   zero + 1.0)))
    return shade(cfg, mat, normal, best), cells, mat


def render_rgb_body(cfg: RenderConfig, scene: orch.OrchardParams, body_pos, body_att):
    """render_rgb from vehicle poses (applies the camera mount)."""
    return render_rgb(cfg, scene, body_pos, camera_attitude(body_att))
