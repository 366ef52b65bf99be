"""Quintic 3-D polynomial trajectories as coefficient tensors.

Port of `agrifly_tpu/ops/poly.py` (Trajectory.hpp:33-171): a trajectory is
a (..., 6, 3) tensor of coefficients c[0] t^5 + ... + c[5], highest power
first, evaluated with Horner's rule in the JAX package's order.
"""

from __future__ import annotations

import torch


def polyval(coeffs, t):
    """sum_k coeffs[..., k, :] * t^(K-1-k) by Horner. coeffs: (..., K, 3);
    t: a number or a tensor broadcastable to (...,). Returns (..., 3)."""
    t = torch.as_tensor(t, dtype=coeffs.dtype, device=coeffs.device)[..., None]
    out = coeffs[..., 0, :]
    for k in range(1, coeffs.shape[-2]):
        out = out * t + coeffs[..., k, :]
    return out


def deriv_coeffs(coeffs):
    """Coefficients of d/dt of the polynomial (Trajectory.hpp:137-144)."""
    K = coeffs.shape[-2]
    powers = torch.arange(K - 1, 0, -1, dtype=coeffs.dtype, device=coeffs.device)
    return coeffs[..., :-1, :] * powers[:, None]


def position(coeffs, t):
    return polyval(coeffs, t)


def velocity(coeffs, t):
    return polyval(deriv_coeffs(coeffs), t)


def acceleration(coeffs, t):
    return polyval(deriv_coeffs(deriv_coeffs(coeffs)), t)


def jerk(coeffs, t):
    return polyval(deriv_coeffs(deriv_coeffs(deriv_coeffs(coeffs))), t)


def axis_polyval(axis_coeffs, t):
    """Scalar Horner over (..., K) coefficient tensors."""
    out = axis_coeffs[..., 0]
    for k in range(1, axis_coeffs.shape[-1]):
        out = out * t + axis_coeffs[..., k]
    return out
