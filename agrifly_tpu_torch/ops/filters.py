"""Discrete IIR low-pass filters as carried functional state.

Port of `agrifly_tpu/ops/filters.py`. First order (`lp1`): y = c*y_prev +
(1-c)*x with c = exp(-dt*wc) (LowPassFilterFirstOrder.hpp), in that
operation order. Second order (`lp2`, the onboard IMU, temperature and
battery filters): the coefficients are computed in numpy float32 exactly as
the JAX package does, and `lp2_apply` keeps the reference's add-tree
(LowPassFilterSecondOrder.hpp:54-58).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class Lp1State(NamedTuple):
    y: torch.Tensor
    coeff: torch.Tensor  # 0-d


def lp1_init(sampling_period, cutoff_rad_s, init_value, device=None) -> Lp1State:
    c = math.exp(-float(sampling_period) * float(cutoff_rad_s))
    return Lp1State(y=torch.as_tensor(init_value, dtype=torch.float32, device=device),
                    coeff=torch.tensor(c, dtype=torch.float32, device=device))


def lp1_apply(state: Lp1State, x):
    c = state.coeff
    y = torch.where(c <= 0.0, x, c * state.y + (1.0 - c) * x)
    return Lp1State(y=y, coeff=c), y


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
