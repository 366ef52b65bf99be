"""Ground-truth collision oracle: ray-sphere test against every pixel.

Port of `agrifly_tpu/planner/oracle.py` (DepthImagePlanner::
IsCollisionFreeGroundTruth, DepthImagePlanner.cpp:1031-1098): sample the
trajectory every 0.1 s; a sample collides if any depth pixel's
back-projected point lies in front of (or inside) the vehicle sphere along
a ray that pierces the sphere. The FOV margins and the min-checking-distance
skip match the reference, and every expression is the JAX package's. It is
the anchor of the planner's conservativeness: a candidate the pyramid check
frees must be free here.

Batched over (*L, N) candidates and chunked over N, so that no float
temporary of (*L, n, MAX_SAMPLES, H, W) values exceeds CHUNK_BYTES. The JAX
package writes it in jnp and runs no Pallas kernel for it; here it is plain
PyTorch.
"""

from __future__ import annotations

import torch

from agrifly_tpu_torch.ops.fmath import dot3, ipow, sqrt
from agrifly_tpu_torch.planner import rappids
from agrifly_tpu_torch.planner import traj as traj_mod

TIMESTEP = 0.1
MAX_SAMPLES = 31  # ceil(3 s / 0.1 s) + 1
# The largest float temporary a chunk of candidates may make: one value per
# candidate, sample and pixel (at 640x480 a candidate's is 38 MB).
CHUNK_BYTES = 128 << 20


def _pixel_rays(cam: rappids.CameraModel, device):
    """Unit rays e (H, W, 3) of the pixels and their z-depth-to-distance
    factors sqrt(ex^2 + ey^2 + 1) (H, W)."""
    xs = (torch.arange(cam.width, dtype=torch.float32, device=device) - cam.cx) / cam.focal
    ys = (torch.arange(cam.height, dtype=torch.float32, device=device) - cam.cy) / cam.focal
    ey, ex = torch.meshgrid(ys, xs, indexing="ij")
    e = torch.stack([ex, ey, torch.ones_like(ex)], dim=-1)
    e = e / sqrt(dot3(e, e))[..., None]
    return e, sqrt(ex * ex + ey * ey + 1.0)


def _chunk_free(params, img, e, pix_dist, tr: traj_mod.Traj):
    """Verdicts (*L, n) for a chunk of candidates; img (*L, H, W) float."""
    cam = params.cam
    W, H = cam.width, cam.height
    ignore = params.true_radius / cam.depth_scale
    edge_off = cam.focal * params.true_radius / params.min_check_dist

    ts = torch.arange(MAX_SAMPLES, dtype=torch.float32, device=img.device) * TIMESTEP
    t_ok = ts < tr.tf[..., None]  # (*L, n, S)
    # each candidate's leaves against its S sample times: (*L, n, S, 3)
    per_sample = traj_mod.Traj(*(x[..., None, :] if x.dim() > tr.tf.dim() else x[..., None]
                                 for x in tr))
    pos = traj_mod.position(per_sample, ts)
    z = pos[..., 2]
    active = t_ok & (z >= params.min_check_dist)

    px, py = rappids.project(cam, pos)
    fov_bad = active & ((px <= edge_off) | (px > W - edge_off) | (py <= edge_off)
                        | (py > H - edge_off))

    pix_valid = img > ignore  # (*L, H, W)
    r2 = ipow(params.plan_radius, 2)
    p = pos[..., None, None, :]  # (*L, n, S, 1, 1, 3)
    d = e[..., 0] * p[..., 0] + e[..., 1] * p[..., 1] + e[..., 2] * p[..., 2]  # e . pos
    under = d * d - dot3(pos, pos)[..., None, None] + r2
    hits_sphere = under >= 0
    second = d + sqrt(torch.clamp(under, min=0.0))
    expand = (slice(None),) * (img.dim() - 2) + (None, None)
    blocked = pix_valid[expand] & hits_sphere & (pix_dist[expand] < second)
    collides = active & blocked.flatten(-2).any(dim=-1)
    return ~(collides.any(dim=-1) | fov_bad.any(dim=-1))


def is_collision_free_ground_truth(params: rappids.PlannerParams, depth_u16,
                                   tr: traj_mod.Traj):
    """True where a candidate is collision-free by the ray-sphere oracle:
    depth_u16 (*L, H, W) depth codes, tr (*L, N) camera-frame candidates;
    returns (*L, N) bool."""
    cam = params.cam
    img = depth_u16.to(torch.float32)
    e, ray_norm = _pixel_rays(cam, img.device)
    pix_dist = img * cam.depth_scale * ray_norm  # distance of the pixel's point along its ray
    lead = img.shape[:-2]
    per_candidate = MAX_SAMPLES * cam.height * cam.width * 4 * max(1, lead.numel())
    n = max(1, CHUNK_BYTES // per_candidate)
    N = tr.tf.shape[-1]
    take = lambda x, a, b: x[..., a:b, :] if x.dim() > tr.tf.dim() else x[..., a:b]  # noqa: E731
    return torch.cat([_chunk_free(params, img, e, pix_dist,
                                  traj_mod.Traj(*(take(x, a, a + n) for x in tr)))
                      for a in range(0, N, n)], dim=-1)
