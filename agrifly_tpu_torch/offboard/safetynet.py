"""Offboard safety rules (SafetyNet.hpp:30-141).

Port of `agrifly_tpu/offboard/safetynet.py`: checks over an estimated
state: a geofence box, a vehicle-not-seen timeout (0.5 s),
upside-down-while-low, and a user-set unsafe latch. The default corners
are the reference's lab volume; the RAPPIDS node widens them to +-100 m.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from agrifly_tpu_torch import card_or_raise
from agrifly_tpu_torch.ops import rotation as rot
from agrifly_tpu_torch.ops.fmath import const

VEHICLE_NOT_SEEN_TIMEOUT_US = 500_000


class SafetyNetParams(NamedTuple):
    min_corner: torch.Tensor  # (3,)
    max_corner: torch.Tensor  # (3,)
    min_normal_height: torch.Tensor  # f32


def _params(lo, hi, device, what):
    device = card_or_raise(device, what)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)  # noqa: E731
    return SafetyNetParams(min_corner=f32(lo), max_corner=f32(hi), min_normal_height=f32(1.0))


def lab_params(device="cuda") -> SafetyNetParams:
    """The reference's lab volume, on the card unless `device` names another
    (with no card the default raises)."""
    return _params((-2.4, -3.1, -0.5), (1.8, 3.1, 4.5), device, "safetynet.lab_params")


def wide_params(half_extent=100.0, device="cuda") -> SafetyNetParams:
    """A cube of +-half_extent, on the card unless `device` names another."""
    h = float(half_extent)
    return _params((-h, -h, -h), (h, h, h), device, "safetynet.wide_params")


class SafetyState(NamedTuple):
    vehicle_not_seen: torch.Tensor  # bool
    unsafe_position: torch.Tensor  # bool
    upside_down_and_low: torch.Tensor  # bool
    user_unsafe: torch.Tensor  # bool

    @property
    def is_safe(self):
        return ~(self.vehicle_not_seen | self.unsafe_position
                 | self.upside_down_and_low | self.user_unsafe)


def init_state(device=None) -> SafetyState:
    b = lambda x: torch.tensor(x, dtype=torch.bool, device=device)  # noqa: E731
    return SafetyState(vehicle_not_seen=b(True), unsafe_position=b(False),
                       upside_down_and_low=b(False), user_unsafe=b(False))


def update(p: SafetyNetParams, s: SafetyState, est_pos, est_att,
           us_since_good_meas) -> SafetyState:
    """The checks on the estimate (est_pos (3,), est_att (4,)) and the time
    since the last good measurement [us]."""
    not_seen = torch.as_tensor(us_since_good_meas) > VEHICLE_NOT_SEEN_TIMEOUT_US
    out_of_box = (est_pos < p.min_corner).any(-1) | (est_pos > p.max_corner).any(-1)
    up_z = rot.rotate(est_att, const((0.0, 0.0, 1.0), est_pos.device))[..., 2]
    upside_low = (est_pos[..., 2] < p.min_normal_height) & (up_z < 0)
    return SafetyState(vehicle_not_seen=not_seen, unsafe_position=out_of_box,
                       upside_down_and_low=upside_low, user_unsafe=s.user_unsafe)
