"""Explicit (imported) scene geometry and its plain renderers, depth and RGB.

Port of `agrifly_tpu/render/meshscene.py`. A scene is a flat table of primitive rows, three kinds:

    sphere    (cx, cy, cz, r)                    canopy blobs
    cylinder  (cx, cy, z0, z1, r), axis +z       trunks, posts
    triangle  (v0, e1, e2)                       arbitrary mesh faces

Loaders: Wavefront OBJ (what Helios' geometry export writes), a one-line-
per-primitive text format, and `from_orchard`, which bakes a rectangle of
the procedural orchard into explicit primitives. They build on the card
unless `device` names another, and raise where there is no card.

Rendering is two-phase: `select_window` picks the <= capacity primitives
within reach of each camera (nearest first), and the renderer intersects
every ray with every window row. `render_depth_window` is the plain version
of the window kernel (K4w) and `render_depth_window_strips` that of the
strip-culled kernel (K4), both in `render/cuda_meshscene.py`: they repeat
the kernels' float32 operations in their order (the JAX kernel's
`_hit_branches`, not the jnp `_hit_row`), so on the card a kernel's codes
equal its plain version's bit for bit. They divide only by tensors (see
`ops.fmath.scalar`) for that reason. The RGB pass (`render_rgb`) tracks
the winning window row through the same scans (`render_rgb_window`,
`render_rgb_strips`: the plain versions of the strip-culled RGB kernel,
K4-rgb) and shades it (`_shade`, then `raycast.shade`).

Everything from the windowing on takes an optional leading vehicle axis:
camera positions (..., 3) and attitudes (..., 4), windows (..., K, 10).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from agrifly_tpu_torch import card_or_raise
from agrifly_tpu_torch.ops import rotation as rot
from agrifly_tpu_torch.ops.fmath import norm3, scalar, sqrt
from agrifly_tpu_torch.render import orchard as orch
from agrifly_tpu_torch.render import raycast as rc
from agrifly_tpu_torch.render.raycast import BIG, RenderConfig, camera_attitude

PRIM_NONE = 0.0
PRIM_SPHERE = 1.0
PRIM_CYLINDER = 2.0
PRIM_TRIANGLE = 3.0

ROW_WIDTH = 10  # [type, p0..p8]

# the per-primitive material defaults of build_scene (raycast.MAT_*)
MAT_TRUNK = rc.MAT_TRUNK
MAT_CANOPY = rc.MAT_CANOPY


class MeshScene(NamedTuple):
    """Flat primitive table + centroid/radius columns for windowing."""

    prims: torch.Tensor  # (S, ROW_WIDTH) f32
    center_xy: torch.Tensor  # (S, 2) XY centroid for distance windowing
    radius: torch.Tensor  # (S,) bounding radius in XY
    count: int  # number of real rows
    material: Optional[torch.Tensor] = None  # (S,) int32 MAT_* ids


# ----------------------------------------------------------------------
# construction
# ----------------------------------------------------------------------


def build_scene(spheres=(), cylinders=(), triangles=(), sphere_mats=None,
                cylinder_mats=None, triangle_mats=None, device="cuda") -> MeshScene:
    """spheres: (cx, cy, cz, r); cylinders: (cx, cy, z0, z1, r);
    triangles: ((v0), (v1), (v2)) vertex triples in world frame.
    *_mats: optional per-primitive material ids (defaults: cylinders are
    trunks, spheres and triangles canopy)."""
    device = card_or_raise(device, "meshscene")
    rows, cxy, rad, mats = [], [], [], []
    for i, (cx, cy, cz, r) in enumerate(spheres):
        rows.append([PRIM_SPHERE, cx, cy, cz, r, 0, 0, 0, 0, 0])
        cxy.append([cx, cy])
        rad.append(r)
        mats.append(sphere_mats[i] if sphere_mats is not None else MAT_CANOPY)
    for i, (cx, cy, z0, z1, r) in enumerate(cylinders):
        rows.append([PRIM_CYLINDER, cx, cy, z0, z1, r, 0, 0, 0, 0])
        cxy.append([cx, cy])
        rad.append(r)
        mats.append(cylinder_mats[i] if cylinder_mats is not None else MAT_TRUNK)
    for i, (v0, v1, v2) in enumerate(triangles):
        v0 = np.asarray(v0, np.float64)
        e1 = np.asarray(v1, np.float64) - v0
        e2 = np.asarray(v2, np.float64) - v0
        rows.append([PRIM_TRIANGLE, *v0, *e1, *e2])
        c = v0 + (e1 + e2) / 3.0
        cxy.append([c[0], c[1]])
        rad.append(max(np.linalg.norm(e1[:2]), np.linalg.norm(e2[:2]),
                       np.linalg.norm((e1 - e2)[:2])))
        mats.append(triangle_mats[i] if triangle_mats is not None else MAT_CANOPY)
    if not rows:
        raise ValueError("empty scene")
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    return MeshScene(prims=f32(rows), center_xy=f32(cxy), radius=f32(rad), count=len(rows),
                     material=torch.from_numpy(np.asarray(mats, np.int32)).to(device))


def load_obj(path, device="cuda") -> MeshScene:
    """Wavefront OBJ triangles (polygon faces are fan-triangulated)."""
    verts, tris = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append(tuple(float(x) for x in parts[1:4]))
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) for p in parts[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    tris.append((verts[idx[0]], verts[idx[k]], verts[idx[k + 1]]))
    if not tris:
        raise ValueError(f"{path}: no faces found")
    return build_scene(triangles=tris, device=device)


def load_primitives(path, device="cuda") -> MeshScene:
    """Analytic-primitive text format, one per line:
        sphere cx cy cz r
        cylinder cx cy z0 z1 r
        tree x y trunk_r trunk_h canopy_cx canopy_cy canopy_cz canopy_r
    '#' comments and blank lines are skipped. `tree` expands to a trunk
    cylinder + canopy sphere."""
    spheres, cylinders = [], []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            kind, vals = parts[0], [float(x) for x in parts[1:]]
            if kind == "sphere" and len(vals) == 4:
                spheres.append(tuple(vals))
            elif kind == "cylinder" and len(vals) == 5:
                cylinders.append(tuple(vals))
            elif kind == "tree" and len(vals) == 8:
                x, y, tr, th, ccx, ccy, ccz, cr = vals
                cylinders.append((x, y, 0.0, th, tr))
                spheres.append((ccx, ccy, ccz, cr))
            else:
                raise ValueError(f"{path}:{lineno}: bad record {line!r}")
    return build_scene(spheres=spheres, cylinders=cylinders, device=device)


def from_orchard(scene: orch.OrchardParams, x_range, y_range, device="cuda") -> MeshScene:
    """Bake a rectangle of the procedural orchard (`scene`, on the CPU)
    into explicit primitives: the same geometry, tree by tree, cell x
    outer and cell y inner, each tree a trunk cylinder and two canopy
    spheres."""
    sx, sy = float(scene.tree_spacing), float(scene.row_spacing)
    ixs = torch.arange(math.floor(x_range[0] / sx), math.ceil(x_range[1] / sx),
                       dtype=torch.int32)
    iys = torch.arange(math.floor(y_range[0] / sy), math.ceil(y_range[1] / sy),
                       dtype=torch.int32)
    ix, iy = torch.meshgrid(ixs, iys, indexing="ij")
    cpu = orch.OrchardParams(*(t.cpu() for t in scene))
    f = {k: v.flatten().tolist() for k, v in orch.tree_fields(cpu, ix, iy).items()}
    spheres, cylinders = [], []
    for i, present in enumerate(f["present"]):
        if not present:
            continue
        cylinders.append((f["cx"][i], f["cy"][i], 0.0, f["trunk_h"][i], f["trunk_r"][i]))
        spheres.append((f["cx"][i], f["cy"][i], f["can_h"][i], f["can_r"][i]))
        spheres.append((f["c2x"][i], f["c2y"][i], f["c2z"][i], f["c2r"][i]))
    return build_scene(spheres=spheres, cylinders=cylinders, device=device)


# ----------------------------------------------------------------------
# windowing
# ----------------------------------------------------------------------


def slant_factor(cfg: RenderConfig) -> float:
    """Max |ray dir| over the image for z-normalized dirs: a hit at planar
    depth `far` can be up to far * slant away euclidean (corner rays)."""
    ex = cfg.width / (2.0 * cfg.focal)
    ey = cfg.height / (2.0 * cfg.focal)
    return math.sqrt(1.0 + ex * ex + ey * ey)


def _gather_rows(table, idx):
    """table (..., K, C) rows picked by idx (..., *M, K'), any M: (..., *M, K', C)."""
    lead = table.shape[:-2]
    mid = idx.shape[len(lead):-1]
    src = table.reshape(lead + (1,) * len(mid) + table.shape[-2:])
    src = src.expand(idx.shape[:-1] + table.shape[-2:])
    return torch.gather(src, -2, idx[..., None].expand(idx.shape + table.shape[-1:]))


def select_window(scene: MeshScene, cam_pos, reach_dist, capacity: int,
                  return_order: bool = False):
    """The <= capacity primitives whose XY footprint lies within
    `reach_dist` of each camera (..., 3), nearest first; rows beyond are
    type NONE. Returns (..., min(S, capacity), ROW_WIDTH), and with
    return_order also the scene rows picked (..., K) and whether each is
    within reach (..., K) (window_materials reads them).

    reach_dist must cover the planar far plane along the most slanted ray:
    use cfg.far * slant_factor(cfg) (render_depth does)."""
    rel = scene.center_xy - cam_pos[..., None, :2]  # (..., S, 2)
    d = sqrt(rel[..., 0] * rel[..., 0] + rel[..., 1] * rel[..., 1])
    reach = d - scene.radius
    visible = reach < reach_dist
    key = torch.where(visible, reach, math.inf)
    order = torch.argsort(key, dim=-1, stable=True)[..., :capacity]
    rows = scene.prims[order]
    ok = torch.gather(visible, -1, order)
    window = torch.where(ok[..., None], rows, torch.zeros_like(rows))
    return (window, order, ok) if return_order else window


def window_materials(scene: MeshScene, window, order, ok):
    """The material id of each window row (select_window with
    return_order): the scene's `material` where it has one (MAT_CANOPY past
    the rows within reach), else cylinders MAT_TRUNK and the rest
    MAT_CANOPY. Returns (..., K) int32."""
    if scene.material is not None:
        mats = torch.where(ok, scene.material[order], MAT_CANOPY)
    else:
        mats = torch.where(window[..., 0] == PRIM_CYLINDER, MAT_TRUNK, MAT_CANOPY)
    return mats.to(torch.int32)


def row_bounding_spheres(window):
    """Conservative world-space bounding sphere per window row.

    window: (..., K, ROW_WIDTH). Returns (center (..., K, 3), radius
    (..., K)); rows of type NONE get radius -1 (never visible)."""
    kind = window[..., 0]
    p = window[..., 1:]
    is_s = kind == PRIM_SPHERE
    is_c = kind == PRIM_CYLINDER
    is_t = kind == PRIM_TRIANGLE

    # cylinder: center (x, y, (z0+z1)/2), r = sqrt(r^2 + ((z1-z0)/2)^2)
    half_h = (p[..., 3] - p[..., 2]) * 0.5
    c_r = sqrt(p[..., 4] * p[..., 4] + half_h * half_h)
    # triangle: centroid v0 + (e1+e2)/3, r = max vertex distance
    g = (p[..., 3:6] + p[..., 6:9]) / scalar(3.0, window)
    t_r = torch.maximum(norm3(g), torch.maximum(norm3(p[..., 3:6] - g), norm3(p[..., 6:9] - g)))

    cx = torch.where(is_t, p[..., 0] + g[..., 0], p[..., 0])
    cy = torch.where(is_t, p[..., 1] + g[..., 1], p[..., 1])
    cz = torch.where(is_s, p[..., 2],
                     torch.where(is_c, (p[..., 2] + p[..., 3]) * 0.5, p[..., 2] + g[..., 2]))
    r = torch.where(is_s, p[..., 3], torch.where(is_c, c_r, t_r))
    r = torch.where(kind == PRIM_NONE, -1.0, r * 1.001 + 1e-3)  # margin
    return torch.stack([cx, cy, cz], dim=-1), r


def strip_windows(cfg: RenderConfig, window, cam_pos, cam_att, tile_h: int,
                  return_order: bool = False, far_clip: bool = True):
    """Per-strip compaction of a frame window for the strip-culled renderer.

    For each tile_h-row strip of the image, conservatively tests every
    window row's bounding sphere against the strip's ray cone (5 halfspace
    tests, a convex superset of the cone, so no possibly-hitting row is
    dropped) and compacts the passing rows to the front, in window order.
    far_clip also drops rows wholly beyond the far plane: right for depth
    codes (255 there anyway), wrong for the RGB pass, where a hit beyond
    it still shades.

    window (..., K, ROW_WIDTH), cam_pos (..., 3), cam_att (..., 4). Returns
    (strips (..., T, K, ROW_WIDTH) with passing rows first and the rest
    zero (type NONE), n_vis (..., T) int32), and with return_order also
    the window row of each compacted slot (..., T, K)."""
    K = window.shape[-2]
    T = cfg.height // tile_h
    center, radius = row_bounding_spheres(window)  # (..., K, 3), (..., K)

    # world -> camera, c[k] = R^T (center_k - cam), three products summed
    # left to right as the JAX package's broadcast-sum does
    R = rot.to_matrix(cam_att)[..., None, :, :]  # (..., 1, 3, 3)
    d = center - cam_pos[..., None, :]  # (..., K, 3)
    ccx, ccy, ccz = (d[..., 0] * R[..., 0, j] + d[..., 1] * R[..., 1, j]
                     + d[..., 2] * R[..., 2, j] for j in range(3))

    ex_min = -cfg.width / (2.0 * cfg.focal)
    ex_max = (cfg.width - 1 - cfg.width / 2.0) / cfg.focal
    focal = scalar(cfg.focal, window)
    ys = torch.arange(T, dtype=torch.float32, device=window.device) * tile_h
    ey_min = (ys - cfg.height / 2.0) / focal  # (T,)
    ey_max = (ys + (tile_h - 1) - cfg.height / 2.0) / focal

    ok = radius >= 0
    ok &= ccz + radius > 0.0  # not fully behind the camera
    if far_clip:
        ok &= ccz - radius <= cfg.far
    ok &= (ccx - ex_min * ccz) >= -radius * math.sqrt(1.0 + ex_min * ex_min)
    ok &= (ex_max * ccz - ccx) >= -radius * math.sqrt(1.0 + ex_max * ex_max)
    # per-strip vertical halfspaces: (..., T, K)
    sy_min = sqrt(1.0 + ey_min * ey_min)[:, None]
    sy_max = sqrt(1.0 + ey_max * ey_max)[:, None]
    ccy, ccz, radius = ccy[..., None, :], ccz[..., None, :], radius[..., None, :]
    vis = ok[..., None, :]
    vis = vis & ((ccy - ey_min[:, None] * ccz) >= -radius * sy_min)
    vis = vis & ((ey_max[:, None] * ccz - ccy) >= -radius * sy_max)

    # stable compaction: passing rows first, window order kept
    order = torch.argsort((~vis).to(torch.int32), dim=-1, stable=True)  # (..., T, K)
    n_vis = vis.sum(-1).to(torch.int32)
    keep = torch.arange(K, device=window.device) < n_vis[..., None]
    strips = torch.where(keep[..., None], _gather_rows(window, order), 0.0)
    return (strips, n_vis, order) if return_order else (strips, n_vis)


# ----------------------------------------------------------------------
# rendering: the plain versions of the kernels
# ----------------------------------------------------------------------


def _rays(cfg: RenderConfig, cam_pos, cam_att):
    """World ray directions (dx, dy, dz), each (..., H, W), with z = 1 in
    the camera frame (t is planar depth), and the ground plane's t (or BIG)."""
    H, W = cfg.height, cfg.width
    dev = cam_pos.device
    focal = scalar(cfg.focal, cam_pos)
    col = ((torch.arange(W, dtype=torch.float32, device=dev) - W / 2.0) / focal)[None, :]
    row = ((torch.arange(H, dtype=torch.float32, device=dev) - H / 2.0) / focal)[:, None]
    R = rot.to_matrix(cam_att)[..., None, None]  # (..., 3, 3, 1, 1)
    dx = R[..., 0, 0, :, :] * col + R[..., 0, 1, :, :] * row + R[..., 0, 2, :, :]
    dy = R[..., 1, 0, :, :] * col + R[..., 1, 1, :, :] * row + R[..., 1, 2, :, :]
    dz = R[..., 2, 0, :, :] * col + R[..., 2, 1, :, :] * row + R[..., 2, 2, :, :]
    # ground plane z = 0
    cz = cam_pos[..., 2, None, None]
    t_ground = -cz / torch.where(torch.abs(dz) < 1e-9, 1e-9, dz)
    best = torch.where((t_ground > 0) & (dz != 0), t_ground, BIG)
    return (dx, dy, dz), best


def _hit(row, cam, dirs):
    """Planar-depth t of every ray with one primitive row, BIG for a miss.

    row: (..., ROW_WIDTH) with the rays' leading shape up to their two
    trailing pixel axes; cam: (cx, cy, cz) broadcastable the same way.
    All three kinds are computed and the row's kind selects one, as the
    kernels' switch does."""
    kind = row[..., 0, None, None].to(torch.int32).clamp(0, 3)
    p = [row[..., 1 + k, None, None] for k in range(9)]
    cx, cy, cz = cam
    dx, dy, dz = dirs

    # sphere (cx, cy, cz, r)
    ox, oy, oz = cx - p[0], cy - p[1], cz - p[2]
    a = dx * dx + dy * dy + dz * dz
    bq = 2.0 * (ox * dx + oy * dy + oz * dz)
    cc = ox * ox + oy * oy + oz * oz - p[3] * p[3]
    disc = bq * bq - 4.0 * a * cc
    sq = sqrt(torch.clamp(disc, min=0.0))
    t0 = (-bq - sq) / (2.0 * a)
    t1 = (-bq + sq) / (2.0 * a)
    ts = torch.where(t0 > 0, t0, t1)
    t_sphere = torch.where((disc >= 0) & (ts > 0), ts, BIG)

    # z-axis cylinder (cx, cy, z0, z1, r)
    ox, oy = cx - p[0], cy - p[1]
    ca = dx * dx + dy * dy
    cb = 2.0 * (ox * dx + oy * dy)
    cc = ox * ox + oy * oy - p[4] * p[4]
    disc = cb * cb - 4.0 * ca * cc
    sq = sqrt(torch.clamp(disc, min=0.0))
    ca_safe = torch.where(ca > 1e-12, ca, 1.0)
    t0 = (-cb - sq) / (2.0 * ca_safe)
    t1 = (-cb + sq) / (2.0 * ca_safe)
    tc = torch.where(t0 > 0, t0, t1)
    z = cz + tc * dz
    ok = (disc >= 0) & (ca > 1e-12) & (tc > 0) & (z >= p[2]) & (z <= p[3])
    t_cyl = torch.where(ok, tc, BIG)

    # triangle (v0, e1, e2), Moller-Trumbore
    e1x, e1y, e1z = p[3], p[4], p[5]
    e2x, e2y, e2z = p[6], p[7], p[8]
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = pvx * e1x + pvy * e1y + pvz * e1z
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1.0, det)
    tvx, tvy, tvz = cx - p[0], cy - p[1], cz - p[2]
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (qvx * dx + qvy * dy + qvz * dz) * inv_det
    tt = (qvx * e2x + qvy * e2y + qvz * e2z) * inv_det
    ok = (torch.abs(det) >= 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1) & (tt > 0)
    t_tri = torch.where(ok, tt, BIG)

    return torch.where(kind == 1, t_sphere, torch.where(
        kind == 2, t_cyl, torch.where(kind == 3, t_tri, BIG)))


def _code(cfg: RenderConfig, best):
    # clip in float before the int cast: a miss is t = 1e9, whose code does
    # not fit an int32
    code = torch.floor(best / scalar(cfg.far / 256.0, best))
    return torch.clamp(code, 0.0, 255.0).to(torch.int32)


def _camera(cam_pos, extra_axes: int):
    return tuple(cam_pos[(..., i) + (None,) * extra_axes] for i in range(3))


def render_depth_window(cfg: RenderConfig, window, cam_pos, cam_att):
    """Depth codes from a primitive window (see select_window): the plain
    version of the window kernel (K4w). window (..., K, ROW_WIDTH),
    cam_pos (..., 3), cam_att (..., 4) world-from-camera. Returns
    (..., H, W) int32 codes in [0, 255], planar depth, far/256 scale,
    ground plane at z = 0."""
    dirs, best = _rays(cfg, cam_pos, cam_att)
    cam = _camera(cam_pos, 2)
    for k in range(window.shape[-2]):
        best = torch.minimum(best, _hit(window[..., k, :], cam, dirs))
    return _code(cfg, best)


def prepare_rows(window, cam_pos):
    """The window's rows in their camera-relative form, as the mesh kernels
    stage them: the terms of `_hit` that depend only on the row and the
    camera, in `_hit`'s float32 operations. window (..., K, ROW_WIDTH),
    cam_pos (..., 3). Returns the clamped kind (..., K) int32 and, each
    (..., K): o = camera - p[0:3] (a sphere's and a cylinder's offset, a
    triangle's tv), the sphere's and the cylinder's cc, the triangle's
    qv = tv x e1 and qv . e2 (the numerator of its t)."""
    kind = window[..., 0].to(torch.int32).clamp(0, 3)
    p = [window[..., 1 + k] for k in range(9)]
    cx, cy, cz = (cam_pos[..., i, None] for i in range(3))
    ox, oy, oz = cx - p[0], cy - p[1], cz - p[2]
    cc_sphere = ox * ox + oy * oy + oz * oz - p[3] * p[3]
    cc_cyl = ox * ox + oy * oy - p[4] * p[4]
    qvx = oy * p[5] - oz * p[4]
    qvy = oz * p[3] - ox * p[5]
    qvz = ox * p[4] - oy * p[3]
    qe2 = qvx * p[6] + qvy * p[7] + qvz * p[8]
    return kind, dict(o=(ox, oy, oz), cc_sphere=cc_sphere, cc_cyl=cc_cyl, qv=(qvx, qvy, qvz),
                      qe2=qe2, z=(p[2], p[3]), e1=tuple(p[3:6]), e2=tuple(p[6:9]))


def _hit_prepared(kind, row, cz, dirs, pix):
    """`_hit` from a prepared row (one entry of prepare_rows, its values
    broadcastable against the rays) and the pixels' own terms `pix`
    (ca, 4a, 2a, 4ca, 2ca of _pixel_terms): the same float32 values."""
    dx, dy, dz = dirs
    ca, a4, a2, ca4, ca2 = pix
    ox, oy, oz = row["o"]

    bq = 2.0 * (ox * dx + oy * dy + oz * dz)
    disc = bq * bq - a4 * row["cc_sphere"]
    sq = sqrt(torch.clamp(disc, min=0.0))
    t0 = (-bq - sq) / a2
    t1 = (-bq + sq) / a2
    ts = torch.where(t0 > 0, t0, t1)
    t_sphere = torch.where((disc >= 0) & (ts > 0), ts, BIG)

    cb = 2.0 * (ox * dx + oy * dy)
    disc = cb * cb - ca4 * row["cc_cyl"]
    sq = sqrt(torch.clamp(disc, min=0.0))
    ca2_safe = torch.where(ca > 1e-12, ca2, 2.0)
    t0 = (-cb - sq) / ca2_safe
    t1 = (-cb + sq) / ca2_safe
    tc = torch.where(t0 > 0, t0, t1)
    z = cz + tc * dz
    z0, z1 = row["z"]
    ok = (disc >= 0) & (ca > 1e-12) & (tc > 0) & (z >= z0) & (z <= z1)
    t_cyl = torch.where(ok, tc, BIG)

    e1x, e1y, e1z = row["e1"]
    e2x, e2y, e2z = row["e2"]
    qvx, qvy, qvz = row["qv"]
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = pvx * e1x + pvy * e1y + pvz * e1z
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1.0, det)
    u = (ox * pvx + oy * pvy + oz * pvz) * inv_det
    v = (qvx * dx + qvy * dy + qvz * dz) * inv_det
    tt = row["qe2"] * inv_det
    ok = (torch.abs(det) >= 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1) & (tt > 0)
    t_tri = torch.where(ok, tt, BIG)

    return torch.where(kind == 1, t_sphere, torch.where(
        kind == 2, t_cyl, torch.where(kind == 3, t_tri, BIG)))


def _pixel_terms(dirs):
    """The terms of `_hit` that depend only on the pixel: ca = dx^2 + dy^2,
    then 4a, 2a, 4ca and 2ca, where a = ca + dz^2 equals _hit's
    dx^2 + dy^2 + dz^2 bit for bit (summed left to right) and `4 * a * cc`
    groups as (4 a) cc."""
    dx, dy, dz = dirs
    ca = dx * dx + dy * dy
    a = ca + dz * dz
    return ca, 4.0 * a, 2.0 * a, 4.0 * ca, 2.0 * ca


def render_depth_window_prepared(cfg: RenderConfig, window, cam_pos, cam_att):
    """render_depth_window in the mesh kernels' operation order since their
    redesign: each row prepared once per camera (prepare_rows), each pixel's
    own terms once (_pixel_terms), then per pixel and row only what is left.
    The same codes as render_depth_window, bit for bit; the tests hold the
    kernels' order to it, the frame does not call it."""
    dirs, best = _rays(cfg, cam_pos, cam_att)
    pix = _pixel_terms(dirs)
    kind, prep = prepare_rows(window, cam_pos)
    at = lambda v, k: v[..., k, None, None]  # noqa: E731  (..., K) -> (..., 1, 1)
    cz = cam_pos[..., 2, None, None]
    for k in range(window.shape[-2]):
        row = {name: tuple(at(x, k) for x in v) if isinstance(v, tuple) else at(v, k)
               for name, v in prep.items()}
        best = torch.minimum(best, _hit_prepared(at(kind, k), row, cz, dirs, pix))
    return _code(cfg, best)


def render_strips(cfg: RenderConfig, strips, cam_pos, cam_att):
    """Depth codes from per-strip tables (see strip_windows): the plain
    version of the strip-culled kernel (K4). strips (..., T, K,
    ROW_WIDTH) with T = H / tile_h. A strip's rows past its n_vis are zero
    (type NONE, t = BIG), so looping all K rows of every strip gives the
    kernel's loop over n_vis rows without reading n_vis back."""
    H, W = cfg.height, cfg.width
    T = strips.shape[-3]
    (dx, dy, dz), best = _rays(cfg, cam_pos, cam_att)
    dirs = tuple(a.reshape(a.shape[:-2] + (T, H // T, W)) for a in (dx, dy, dz))
    best = best.reshape(best.shape[:-2] + (T, H // T, W))
    cam = _camera(cam_pos, 3)
    for k in range(strips.shape[-2]):
        best = torch.minimum(best, _hit(strips[..., k, :], cam, dirs))
    return _code(cfg, best.reshape(best.shape[:-3] + (H, W)))


def render_depth_window_strips(cfg: RenderConfig, window, cam_pos, cam_att,
                               tile_h: int = 16):
    """Strip-culled render_depth_window, the same output: `strip_windows`
    then `render_strips`. Falls back to the unculled scan when the height
    is not a multiple of tile_h."""
    if cfg.height % tile_h:
        return render_depth_window(cfg, window, cam_pos, cam_att)
    strips, _ = strip_windows(cfg, window, cam_pos, cam_att, tile_h)
    return render_strips(cfg, strips, cam_pos, cam_att)


def render_depth(cfg: RenderConfig, scene: MeshScene, cam_pos, cam_att,
                 window_capacity: int = 192, strip_cull: bool = True):
    """select_window + window render in one call; strip_cull picks the
    strip-culled or the plain full-window scan (the same codes)."""
    window = select_window(scene, cam_pos, cfg.far * slant_factor(cfg), window_capacity)
    if strip_cull:
        return render_depth_window_strips(cfg, window, cam_pos, cam_att)
    return render_depth_window(cfg, window, cam_pos, cam_att)


def render_depth_body(cfg: RenderConfig, scene: MeshScene, body_pos, body_att,
                      window_capacity: int = 192):
    """render_depth from vehicle poses (applies the depth-camera mount)."""
    return render_depth(cfg, scene, body_pos, camera_attitude(body_att), window_capacity)


# ----------------------------------------------------------------------
# RGB pass (the imported world's counterpart of raycast.render_rgb)
# ----------------------------------------------------------------------


def _strip_cull_default() -> bool:
    """Which scan render_rgb runs by default. The JAX package picks the
    strip-culled scan on the CPU and the plain one elsewhere; the port
    answers as it does on the CPU (on the card both wrappers launch the
    strip-culled kernel, since the two scans give the same image)."""
    return True


def _gather_window(table, idx):
    """table (..., K, *C) rows picked per pixel by idx (..., H, W): (..., H, W, *C)."""
    H, W = idx.shape[-2:]
    flat = idx.reshape(idx.shape[:-2] + (H * W,))
    if table.dim() == flat.dim():  # one value a row
        return torch.gather(table, -1, flat).reshape(idx.shape)
    return _gather_rows(table, flat).reshape(idx.shape + table.shape[-1:])


def _shade(cfg: RenderConfig, cam_pos, dirs, best, row, mat_prim, hit_prim):
    """The RGB pass's shading tail: the hit point o + best d, the winning
    row's analytic normal by kind (a sphere's radial direction, a
    cylinder's radial in xy, a triangle's face normal turned toward the
    viewer), the ground's +z where no row won, its material (clamped to
    0..3), then raycast.shade. dirs: (dx, dy, dz) and best, each (..., H, W);
    row (..., H, W, ROW_WIDTH) the winning rows; mat_prim (..., H, W) their
    materials; hit_prim (..., H, W) bool, else ground (or sky where best >=
    BIG)."""
    dx, dy, dz = dirs
    cx, cy, cz = _camera(cam_pos, 2)
    hx, hy, hz = cx + best * dx, cy + best * dy, cz + best * dz
    kind = row[..., 0]
    p = [row[..., 1 + k] for k in range(9)]
    # a triangle's face normal e1 x e2, turned toward the viewer
    tx = p[4] * p[8] - p[5] * p[7]
    ty = p[5] * p[6] - p[3] * p[8]
    tz = p[3] * p[7] - p[4] * p[6]
    away = (tx * dx + ty * dy + tz * dz) > 0
    tx, ty, tz = (torch.where(away, -v, v) for v in (tx, ty, tz))
    sphere, cyl = kind == PRIM_SPHERE, kind == PRIM_CYLINDER
    nx = torch.where(sphere | cyl, hx - p[0], tx)
    ny = torch.where(sphere | cyl, hy - p[1], ty)
    nz = torch.where(sphere, hz - p[2], torch.where(cyl, 0.0, tz))
    nn = sqrt(nx * nx + ny * ny + nz * nz)
    nn = torch.where(nn < 1e-9, 1.0, nn)
    zero = torch.zeros_like(best)
    normal = (torch.where(hit_prim, nx / nn, zero), torch.where(hit_prim, ny / nn, zero),
              torch.where(hit_prim, nz / nn, zero + 1.0))
    mat = torch.where(hit_prim, mat_prim.clamp(0, 3),
                      torch.where(best < BIG, rc.MAT_GROUND, rc.MAT_SKY)).to(torch.int32)
    return rc.shade(cfg, mat, normal, best)


def render_rgb_window(cfg: RenderConfig, window, mats, cam_pos, cam_att):
    """The plain RGB scan: every window row against every pixel, keeping
    the nearest row (strictly nearer, so the earlier row wins a tie, and
    the ground before any row), then `_shade`. window (..., K, ROW_WIDTH),
    mats (..., K) int32, cam_pos (..., 3), cam_att (..., 4). Returns
    (..., H, W, 3) uint8."""
    dirs, best = _rays(cfg, cam_pos, cam_att)
    cam = _camera(cam_pos, 2)
    win = torch.full(best.shape, -1, dtype=torch.int64, device=best.device)
    for k in range(window.shape[-2]):
        t = _hit(window[..., k, :], cam, dirs)
        closer = t < best
        best = torch.where(closer, t, best)
        win = torch.where(closer, k, win)
    at = win.clamp(min=0)
    return _shade(cfg, cam_pos, dirs, best, _gather_window(window, at), _gather_window(mats, at),
                  win >= 0)


def render_rgb_strips(cfg: RenderConfig, window, mats, cam_pos, cam_att, tile_h: int = 16):
    """The strip-culled RGB scan (the plain version of K4-rgb): per
    tile_h-row strip, only the window rows that `strip_windows` keeps
    without its far clip, in window order, the nearest kept (strictly
    nearer, as render_rgb_window), then `_shade`. The culling is
    conservative, so the image equals render_rgb_window's. Same arguments
    and result as render_rgb_window; H a multiple of tile_h."""
    H, W = cfg.height, cfg.width
    T = H // tile_h
    strips, n_vis, order = strip_windows(cfg, window, cam_pos, cam_att, tile_h,
                                         return_order=True, far_clip=False)
    (dx, dy, dz), best = _rays(cfg, cam_pos, cam_att)
    dirs = tuple(a.reshape(a.shape[:-2] + (T, tile_h, W)) for a in (dx, dy, dz))
    best = best.reshape(best.shape[:-2] + (T, tile_h, W))
    cam = _camera(cam_pos, 3)
    nv = n_vis[..., None, None]
    slot = torch.full(best.shape, -1, dtype=torch.int64, device=best.device)
    for k in range(strips.shape[-2]):
        t = _hit(strips[..., k, :], cam, dirs)
        closer = (t < best) & (k < nv)
        best = torch.where(closer, t, best)
        slot = torch.where(closer, k, slot)
    # compacted slot -> window row, through each strip's compaction order
    win = torch.gather(order, -1, slot.clamp(min=0).reshape(slot.shape[:-2] + (tile_h * W,)))
    win = win.reshape(win.shape[:-2] + (H, W))
    hit = (slot >= 0).reshape(win.shape)
    return _shade(cfg, cam_pos, (dx, dy, dz), best.reshape(win.shape),
                  _gather_window(window, win), _gather_window(mats, win), hit)


def render_rgb(cfg: RenderConfig, scene: MeshScene, cam_pos, cam_att,
               window_capacity: int = 192, strip_cull: bool | None = None, tile_h: int = 16):
    """Shaded RGB frames of an imported world, the counterpart of
    render_depth: the same window (its rows' materials by
    window_materials), the nearest row tracked through the scan, then
    `_shade`; a baked orchard renders the same picture as the procedural
    one. strip_cull: True the strip-culled scan, False the plain one (the
    same image); None picks `_strip_cull_default()`. cam_pos (..., 3),
    cam_att (..., 4). Returns (..., H, W, 3) uint8."""
    window, order, ok = select_window(scene, cam_pos, cfg.far * slant_factor(cfg),
                                      window_capacity, return_order=True)
    mats = window_materials(scene, window, order, ok)
    if strip_cull is None:
        strip_cull = _strip_cull_default()
    if strip_cull and cfg.height % tile_h == 0:
        return render_rgb_strips(cfg, window, mats, cam_pos, cam_att, tile_h)
    return render_rgb_window(cfg, window, mats, cam_pos, cam_att)


def render_rgb_body(cfg: RenderConfig, scene: MeshScene, body_pos, body_att,
                    window_capacity: int = 192):
    """render_rgb from vehicle poses (applies the camera mount)."""
    return render_rgb(cfg, scene, body_pos, camera_attitude(body_att), window_capacity)
