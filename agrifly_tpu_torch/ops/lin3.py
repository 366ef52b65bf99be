"""Closed-form small-matrix linear algebra.

Port of `agrifly_tpu/ops/lin3.py`. The matvecs stay in the broadcast-sum
form (three products summed left to right) rather than `@`, so the sums
associate exactly as in the JAX package.
"""

from __future__ import annotations

import torch


def mv3(m, v):
    """3x3 (or Nx3) matvec m @ v, fully scalar-expanded."""
    v0, v1, v2 = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack(
        [m[..., i, 0] * v0 + m[..., i, 1] * v1 + m[..., i, 2] * v2
         for i in range(m.shape[-2])], dim=-1)


def mv3t(m, v):
    """Transposed matvec m.T @ v (same fully-scalar form as mv3)."""
    v0, v1, v2 = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack(
        [m[..., 0, i] * v0 + m[..., 1, i] * v1 + m[..., 2, i] * v2
         for i in range(m.shape[-1])], dim=-1)


def cross_rows(a, b):
    """Row-wise cross product of (..., 3) x (..., 3)."""
    from agrifly_tpu_torch.ops.fmath import cross

    return cross(a, b)


def assemble_cols3(c0, c1, c2):
    """(..., 3) from three (...,) columns as the JAX package builds it: each
    slot sums one live term and two products with 0.0."""
    e0, e1, e2 = (torch.eye(3, dtype=c0.dtype, device=c0.device)[i] for i in range(3))
    return c0[..., None] * e0 + c1[..., None] * e1 + c2[..., None] * e2


def det3(m):
    """Determinant of (..., 3, 3), by the first row's cofactors."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def inv3(m, det=None):
    """Inverse of (..., 3, 3): the adjugate times 1 / det (the caller makes
    sure m is invertible)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    if det is None:
        det = det3(m)
    inv_det = 1.0 / det
    cof = torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], dim=-1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], dim=-1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], dim=-1),
    ], dim=-2)
    return cof * inv_det[..., None, None]


def diag_from(d):
    """diag(d) over the last axis, zeros elsewhere."""
    n = d.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=d.device)
    return torch.where(eye, d[..., None, :], torch.zeros((), dtype=d.dtype, device=d.device))
