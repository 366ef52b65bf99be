"""Branch-free closed-form quadratic / cubic / quartic real-root solvers.

Port of `agrifly_tpu/ops/rootfind.py` (RootFinder.hpp:60-177): fixed-size
root tensors plus boolean validity masks, so every candidate of a batch is
solved at once.

  solve_quadratic(a, b, c)   solves a x^2 + b x + c = 0 (linear if a ~ 0)
  solve_cubic(a, b, c)       solves x^3 + a x^2 + b x + c = 0
  solve_quartic(a, b, c, d)  solves x^4 + a x^3 + b x^2 + c x + d = 0
"""

from __future__ import annotations

import math

import torch

from agrifly_tpu_torch.ops.fmath import scalar, sqrt

_EPS = 1e-12
_2PI = 6.283185307179586


def _safe_sqrt(x):
    return sqrt(torch.clamp(x, min=0.0))


def _f64(fn, x):
    """fn evaluated in float64 and rounded once to x's dtype: a correctly
    rounded float32 result on every device, within an ulp of XLA's own."""
    return fn(x.double()).to(x.dtype)


_THIRD_F32 = 0.3333333432674408  # float32(1/3): the exponent a float32 pow(x, 1/3) raises to


def _cbrt(x):
    """Real cube root (torch has no cbrt). XLA lowers cbrt to pow(x, 1/3)
    in float32; so does this on the CPU. CUDA's float32 pow is not the
    CPU's, so on the card x ** float32(1/3) is taken in float64 and rounded
    once: the correctly rounded value, which the CPU's float32 pow gives too
    wherever it is itself correctly rounded (`plain_drift.py` reads how
    often it is not)."""
    mag = torch.abs(x)
    if x.is_cuda:
        mag = _f64(lambda v: torch.pow(v, _THIRD_F32), mag)
    else:
        mag = torch.pow(mag, 1.0 / 3.0)
    return torch.sign(x) * mag


def solve_cubic(a, b, c):
    """Real roots of x^3 + a x^2 + b x + c.

    Returns (roots, valid): (..., 3) each. Invalid lanes hold finite
    values, never NaN."""
    a2 = a * a
    q = (a2 - 3.0 * b) / scalar(9.0, a2)
    r = (a * (2.0 * a2 - 9.0 * b) + 27.0 * c) / scalar(54.0, a2)
    r2 = r * r
    q3 = q * q * q
    three_real = r2 < q3

    # three real roots (trigonometric form)
    q3_safe = torch.where(three_real, q3, torch.ones_like(q3))
    t = torch.clamp(r / _safe_sqrt(q3_safe), -1.0, 1.0)
    t = _f64(torch.acos, t)
    third = scalar(3.0, a)
    a3 = a / third
    qq = -2.0 * _safe_sqrt(torch.clamp(q, min=0.0))
    x0_t = qq * _f64(torch.cos, t / third) - a3
    x1_t = qq * _f64(torch.cos, (t + _2PI) / third) - a3
    x2_t = qq * _f64(torch.cos, (t - _2PI) / third) - a3

    # one or two real roots (Cardano)
    disc = _safe_sqrt(torch.clamp(r2 - q3, min=0.0))
    mag = torch.abs(r) + disc
    A = -_cbrt(mag)
    A = torch.where(r < 0, -A, A)
    small_A = torch.abs(A) < _EPS
    B = torch.where(small_A, torch.zeros_like(A),
                    q / torch.where(small_A, torch.ones_like(A), A))
    x0_c = (A + B) - a3
    x1_c = -0.5 * (A + B) - a3
    x2_im = 0.5 * math.sqrt(3.0) * (A - B)  # imaginary part of the pair
    double_root = torch.abs(x2_im) < _EPS

    roots = torch.stack(
        [
            torch.where(three_real, x0_t, x0_c),
            torch.where(three_real, x1_t, x1_c),
            torch.where(three_real, x2_t, x1_c),
        ],
        dim=-1,
    )
    valid = torch.stack(
        [torch.ones_like(three_real), three_real | double_root, three_real],
        dim=-1)
    return roots, valid


def solve_quartic(a, b, c, d):
    """Real roots of x^4 + a x^3 + b x^2 + c x + d.

    Returns (roots, valid): (..., 4) each. Resolvent cubic plus two
    quadratics, picking the resolvent root of maximal |y|."""
    a3 = -b
    b3 = a * c - 4.0 * d
    c3 = -a * a * d - c * c + 4.0 * b * d
    x3, v3 = solve_cubic(a3, b3, c3)

    absx = torch.where(v3, torch.abs(x3), torch.full_like(x3, -math.inf))
    idx = torch.argmax(absx, dim=-1, keepdim=True)
    y = torch.gather(x3, -1, idx)[..., 0]

    # h^2 - y h + d = 0  (h = q1, q2)
    D1 = y * y - 4.0 * d
    D1_zero = torch.abs(D1) < _EPS
    sqD1 = _safe_sqrt(D1)
    q1_a = q2_a = y * 0.5
    q1_b = (y + sqD1) * 0.5
    q2_b = (y - sqD1) * 0.5

    # when D1 == 0: g^2 - a g + (b - y) = 0
    D2 = a * a - 4.0 * (b - y)
    D2_zero = torch.abs(D2) < _EPS
    sqD2 = _safe_sqrt(torch.clamp(D2, min=0.0))
    p1_a = torch.where(D2_zero, a * 0.5, (a + sqD2) * 0.5)
    p2_a = torch.where(D2_zero, a * 0.5, (a - sqD2) * 0.5)

    # when D1 != 0: Cramer. The JAX package's `|denom| < 1e-300` guard rounds
    # its bound to float32 zero, so it never fires; dividing as-is matches.
    denom = q1_b - q2_b
    p1_b = (a * q1_b - c) / denom
    p2_b = (c - a * q2_b) / denom

    q1 = torch.where(D1_zero, q1_a, q1_b)
    q2 = torch.where(D1_zero, q2_a, q2_b)
    p1 = torch.where(D1_zero, p1_a, p1_b)
    p2 = torch.where(D1_zero, p2_a, p2_b)

    Da = p1 * p1 - 4.0 * q1
    va = ~(Da < 0.0)
    sqDa = _safe_sqrt(Da)
    Db = p2 * p2 - 4.0 * q2
    vb = ~(Db < 0.0)
    sqDb = _safe_sqrt(Db)

    roots = torch.stack([(-p1 + sqDa) * 0.5, (-p1 - sqDa) * 0.5,
                         (-p2 + sqDb) * 0.5, (-p2 - sqDb) * 0.5], dim=-1)
    valid = torch.stack([va, va, vb, vb], dim=-1)
    return roots, valid


def solve_quadratic(a, b, c):
    """Real roots of a x^2 + b x + c (|a| < 1e-12: the linear fallback).
    Returns (roots, valid), (..., 2) each."""
    lin = torch.abs(a) < 1e-12
    # quadratic branch
    disc = b * b - 4.0 * a * c
    has = disc >= 0.0
    sq = _safe_sqrt(disc)
    a_safe = torch.where(lin, torch.ones_like(a), a)
    r0 = (-b + sq) / (2.0 * a_safe)
    r1 = (-b - sq) / (2.0 * a_safe)
    # linear branch: b x + c = 0
    tiny_b = torch.abs(b) < 1e-12
    rl = -c / torch.where(tiny_b, torch.ones_like(b), b)
    lin_valid = lin & ~tiny_b
    roots = torch.stack([torch.where(lin, rl, r0), torch.where(lin, rl, r1)], dim=-1)
    valid = torch.stack([torch.where(lin, lin_valid, has), ~lin & has], dim=-1)
    return roots, valid
