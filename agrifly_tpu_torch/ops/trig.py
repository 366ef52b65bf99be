"""Inverse trigonometry as elementwise polynomials.

The Cephes single-precision range reductions and minimax polynomials of
`agrifly_tpu/ops/trig.py`, written in torch. The tick chain, the attitude
math and the trajectory `omega` use these instead of `torch.acos` and
friends so the port rounds like the JAX package does.
"""

from __future__ import annotations

import torch

from agrifly_tpu_torch.ops.fmath import sqrt

_PI = 3.14159265358979323846
_PIO2 = 1.5707963267948966
_PIO4 = 0.7853981633974483
_TAN3PIO8 = 2.414213562373095  # tan(3*pi/8)
_TAN_PIO8 = 0.4142135623730950  # tan(pi/8)


def atan(x):
    """Elementwise arctangent (Cephes atanf reduction + degree-9 minimax)."""
    sign = torch.sign(x)
    a = torch.abs(x)

    big = a > _TAN3PIO8
    mid = (a > _TAN_PIO8) & ~big
    safe_a = torch.where(a == 0.0, torch.ones_like(a), a)
    xr = torch.where(big, -1.0 / safe_a, torch.where(mid, (a - 1.0) / (a + 1.0), a))
    y0 = torch.where(big, _PIO2, torch.where(mid, _PIO4, 0.0)).to(x.dtype)

    z = xr * xr
    p = (((8.05374449538e-2 * z - 1.38776856032e-1) * z
          + 1.99777106478e-1) * z - 3.33329491539e-1) * z * xr + xr
    return sign * (y0 + p)


def atan2(y, x):
    """Elementwise arctan2 with numpy's quadrant/zero conventions."""
    safe_x = torch.where(x == 0.0, torch.ones_like(x), x)
    base = atan(y / safe_x)

    corr = torch.where(y < 0, -_PI, _PI).to(y.dtype)
    out = torch.where(x < 0, base + corr, base)

    pio2 = torch.where(y > 0, _PIO2, -_PIO2).to(y.dtype)
    out = torch.where((x == 0.0) & (y != 0.0), pio2, out)
    return torch.where((x == 0.0) & (y == 0.0), torch.zeros_like(out), out)


def _asin_core(a):
    """asin on [0, 1] (Cephes asinf)."""
    gt_half = a > 0.5
    z = torch.where(gt_half, 0.5 * (1.0 - a), a * a)
    xr = torch.where(gt_half, sqrt(z), a)
    p = ((((4.2163199048e-2 * z + 2.4181311049e-2) * z
           + 4.5470025998e-2) * z + 7.4953002686e-2) * z
         + 1.6666752422e-1) * z * xr + xr
    return torch.where(gt_half, _PIO2 - 2.0 * p, p)


def asin(x):
    """Elementwise arcsine on [-1, 1] (NaN outside, like numpy)."""
    a = torch.abs(x)
    out = torch.sign(x) * _asin_core(torch.clamp(a, max=1.0))
    return torch.where(a > 1.0, torch.full_like(out, float("nan")), out)


def acos(x):
    """Elementwise arccosine on [-1, 1] (Cephes acosf branch structure)."""
    a = torch.abs(x)
    flank = 2.0 * _asin_core(sqrt(torch.clamp(0.5 * (1.0 - a), min=0.0)))
    out = torch.where(
        x < -0.5, _PI - flank,
        torch.where(x > 0.5, flank, _PIO2 - asin(x)),
    )
    return torch.where(a > 1.0, torch.full_like(out, float("nan")), out)
