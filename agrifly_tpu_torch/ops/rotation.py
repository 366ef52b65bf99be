"""Quaternion attitude ops over `(..., 4)` tensors, w-first.

Port of `agrifly_tpu/ops/rotation.py`: `<vector in world> = q * <vector in
body>`, `qmul(q2, q1)` = rotation q1 followed by q2, and the exp/log maps
with the reference's MIN_ANGLE small-angle guard.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from agrifly_tpu_torch.ops import lin3, trig
from agrifly_tpu_torch.ops.fmath import const, cos, norm3, sin, sqrt

MIN_ANGLE = 4.84813681e-6  # less than one arc second


def identity(device=None, dtype=torch.float32):
    """The identity quaternion (a shared constant: do not write to it)."""
    return const((1.0, 0.0, 0.0, 0.0), device, dtype)


def qinv(q):
    """Inverse (conjugate) of a unit quaternion."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def qnormalize(q, eps=1e-6):
    """Renormalize; falls back to identity for degenerate (near-zero) input."""
    w, x, y, z = q.unbind(-1)
    n = sqrt(w * w + x * x + y * y + z * z)[..., None]
    small = n < eps
    out = q / torch.where(small, torch.ones_like(n), n)
    return torch.where(small, identity(q.device, q.dtype).expand_as(q), out)


def qmul(q2, q1):
    """Hamilton product: rotation q1 followed by rotation q2."""
    w2, x2, y2, z2 = q2.unbind(-1)
    w1, x1, y1, z1 = q1.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            x1 * w2 + w1 * x2 + z1 * y2 - y1 * z2,
            y1 * w2 - z1 * x2 + w1 * y2 + x1 * z2,
            z1 * w2 + y1 * x2 - x1 * y2 + w1 * z2,
        ],
        dim=-1,
    )


def from_axis_angle(unit_axis, angle):
    """Axis must be unit length (no check, like the reference)."""
    half = angle * 0.5
    return torch.cat([cos(half)[..., None], sin(half)[..., None] * unit_axis], dim=-1)


def from_rotation_vector(rotvec):
    """Exp map with the reference's small-angle guard (returns identity)."""
    theta = norm3(rotvec, keepdim=True)
    small = theta < MIN_ANGLE
    safe_theta = torch.where(small, torch.ones_like(theta), theta)
    q = from_axis_angle(rotvec / safe_theta, safe_theta[..., 0])
    return torch.where(small, identity(q.device, q.dtype).expand_as(q), q)


def from_euler_ypr_np(y, p, r):
    """3-2-1 yaw/pitch/roll quaternion of python angles, in float64 numpy.

    Constant mounts are built this way and rounded to float32 once, as the
    JAX package does when the angles are python numbers."""
    cy, sy = math.cos(0.5 * y), math.sin(0.5 * y)
    cp, sp = math.cos(0.5 * p), math.sin(0.5 * p)
    cr, sr = math.cos(0.5 * r), math.sin(0.5 * r)
    return np.array([
        cy * cp * cr + sy * sp * sr,
        cy * cp * sr - sy * sp * cr,
        cy * sp * cr + sy * cp * sr,
        sy * cp * cr - cy * sp * sr,
    ])


def from_euler_ypr(y, p, r):
    """3-2-1 yaw, pitch, roll of tensors (Rotation.hpp:99-110)."""
    cy, sy = cos(0.5 * y), sin(0.5 * y)
    cp, sp = cos(0.5 * p), sin(0.5 * p)
    cr, sr = cos(0.5 * r), sin(0.5 * r)
    return torch.stack(
        [
            cy * cp * cr + sy * sp * sr,
            cy * cp * sr - sy * sp * cr,
            cy * sp * cr + sy * cp * sr,
            sy * cp * cr - cy * sp * sr,
        ],
        dim=-1,
    )


def to_euler_ypr(q):
    """Returns (yaw, pitch, roll), Rotation.hpp:166-176."""
    w, x, y, z = q.unbind(-1)
    yaw = trig.atan2(2 * x * y + 2 * w * z, x * x + w * w - z * z - y * y)
    pitch = -trig.asin(torch.clamp(2 * x * z - 2 * w * y, -1.0, 1.0))
    roll = trig.atan2(2 * y * z + 2 * w * x, z * z - y * y - x * x + w * w)
    return yaw, pitch, roll


def to_vector_part(q):
    """Vector part with the sign flipped so the scalar part is positive."""
    sign = torch.where(q[..., 0:1] > 0, 1.0, -1.0).to(q.dtype)
    return sign * q[..., 1:4]


def to_rotation_vector(q):
    """Log map via asin of the vector-part norm (Rotation.hpp:144-153)."""
    n = to_vector_part(q)
    norm = norm3(n, keepdim=True)
    angle = trig.asin(torch.clamp(norm, 0.0, 1.0)) * 2.0
    small = angle < MIN_ANGLE
    safe_norm = torch.where(small, torch.ones_like(norm), norm)
    return torch.where(small, torch.zeros_like(n), n * (angle / safe_norm))


def to_matrix(q):
    """3x3 rotation matrix R with R @ v_body = v_world (Rotation.hpp:196-220)."""
    w, x, y, z = q.unbind(-1)
    r0, r1, r2, r3 = w * w, x * x, y * y, z * z
    row0 = torch.stack([r0 + r1 - r2 - r3, 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1)
    row1 = torch.stack([2 * (x * y + w * z), r0 - r1 + r2 - r3, 2 * (y * z - w * x)], dim=-1)
    row2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), r0 - r1 - r2 + r3], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def rotate(q, v):
    """Rotate v from body to world frame: R(q) @ v."""
    return lin3.mv3(to_matrix(q), v)


def rotate_back(q, v):
    """Rotate v from world to body frame: R(q)^T @ v."""
    return lin3.mv3t(to_matrix(q), v)


def get_angle(q):
    """Total rotation angle, 2*acos(|w|) (Rotation.hpp:138-142)."""
    return 2.0 * trig.acos(torch.clamp(torch.abs(q[..., 0]), 0.0, 1.0))
