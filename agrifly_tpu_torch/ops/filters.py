"""Second-order IIR low-pass filter as carried functional state.

Port of the `lp2` part of `agrifly_tpu/ops/filters.py` (the onboard IMU,
temperature and battery filters). The coefficients are computed in numpy
float32 exactly as the JAX package does, and `lp2_apply` keeps the
reference's add-tree (LowPassFilterSecondOrder.hpp:54-58).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class Lp2State(NamedTuple):
    xm0: torch.Tensor
    xm1: torch.Tensor
    ym0: torch.Tensor
    ym1: torch.Tensor


class Lp2Coeffs(NamedTuple):
    a1: torch.Tensor
    a2: torch.Tensor
    b0: torch.Tensor
    b1: torch.Tensor
    b2: torch.Tensor


def lp2_coeffs(sampling_period, cutoff_rad_s, device=None) -> Lp2Coeffs:
    """Bit-exact mirror of LowPassFilterSecondOrder<float>::Initialise:
    every intermediate product rounds to float32, left to right."""
    f = np.float32
    dt = f(sampling_period)
    wc = f(cutoff_rad_s)
    s2 = f(math.sqrt(2.0))
    two, four = f(2), f(4)
    den = dt * dt * wc * wc + two * s2 * dt * wc + four
    a1 = (dt * dt * wc * wc - two * s2 * dt * wc + four) / den
    a2 = two * (dt * dt * wc * wc - four) / den
    b0 = dt * dt * wc * wc / den
    b2 = two * dt * dt * wc * wc / den
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    return Lp2Coeffs(t(a1), t(a2), t(b0), t(b0), t(b2))


def lp2_init(init_value) -> Lp2State:
    return Lp2State(xm0=init_value, xm1=init_value, ym0=init_value, ym1=init_value)


def lp2_apply(coeffs: Lp2Coeffs, state: Lp2State, x):
    # the reference's add-tree: b2*x, += (b0*xm0 + b1*xm1), += (-a1*ym0 - a2*ym1)
    out = coeffs.b2 * x + (coeffs.b0 * state.xm0 + coeffs.b1 * state.xm1)
    out = out + (-(coeffs.a1 * state.ym0) - coeffs.a2 * state.ym1)
    return Lp2State(xm0=state.xm1, xm1=x, ym0=state.ym1, ym1=out), out


def lp2_value(state: Lp2State):
    return state.ym1
