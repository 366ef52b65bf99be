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
