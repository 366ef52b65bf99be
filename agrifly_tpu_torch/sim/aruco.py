"""Aruco-style camera pose sensor: rate-limited pose measurements.

Port of `agrifly_tpu/sim/aruco.py` (ArucoCamera.{hpp,cpp}): a sensor that
re-emits the vehicle's pose every `period`, a stand-in for a camera-marker
pose pipeline. The port has no PRNG key: `step` takes the tick's position
noise as a pre-drawn (3,) unit normal, where the JAX package takes a key.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from agrifly_tpu_torch import card_or_raise


class ArucoParams(NamedTuple):
    period_us: torch.Tensor  # int32 measurement period ("fakeRunTime")
    noise_std_pos: torch.Tensor  # [m]


class ArucoState(NamedTuple):
    acc_us: torch.Tensor  # int32
    meas_pos: torch.Tensor  # (3,) latest measurement
    meas_att: torch.Tensor  # (4,)
    has_new: torch.Tensor  # bool


def make_params(period=0.1, noise_std_pos=0.0, device="cuda") -> ArucoParams:
    """On the card unless `device` names another (with no card the default
    raises)."""
    device = card_or_raise(device, "aruco.make_params")
    return ArucoParams(
        period_us=torch.tensor(round(period * 1e6), dtype=torch.int32, device=device),
        noise_std_pos=torch.tensor(noise_std_pos, dtype=torch.float32, device=device))


def init_state(device=None) -> ArucoState:
    return ArucoState(acc_us=torch.zeros((), dtype=torch.int32, device=device),
                      meas_pos=torch.zeros(3, dtype=torch.float32, device=device),
                      meas_att=torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float32,
                                            device=device),
                      has_new=torch.zeros((), dtype=torch.bool, device=device))


def step(p: ArucoParams, s: ArucoState, true_pos, true_att, dt_us, noise=None) -> ArucoState:
    """Advance dt_us; emits the pose every period. noise: the tick's (3,)
    unit normal for the position noise (None: no noise)."""
    acc = s.acc_us + dt_us
    fire = acc > p.period_us
    acc = torch.where(fire, acc - p.period_us, acc)
    pos = torch.as_tensor(true_pos, dtype=torch.float32)
    if noise is not None:
        pos = pos + noise * p.noise_std_pos
    return ArucoState(acc_us=acc.to(torch.int32),
                      meas_pos=torch.where(fire, pos, s.meas_pos),
                      meas_att=torch.where(fire, torch.as_tensor(true_att, dtype=torch.float32),
                                           s.meas_att),
                      has_new=fire)
