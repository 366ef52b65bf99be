"""Thrust/torque -> per-propeller force allocation and force -> speed map.

Port of `agrifly_tpu/models/mixer.py` ("x" layout, motor 0 front-right,
QuadcopterMixer.hpp:20-114): total-thrust cap first, then per-prop clamps.
"""

from __future__ import annotations

import math

import torch

from agrifly_tpu_torch.ops import lin3
from agrifly_tpu_torch.ops.fmath import const, scalar, sqrt

# allocation signs for (tx/d, ty/d, tz/kt) per motor 0..3
_SIGNS = ((-1.0, -1.0, -1.0), (-1.0, +1.0, +1.0), (+1.0, +1.0, -1.0), (+1.0, -1.0, +1.0))


def motor_forces(params, total_thrust, torque):
    """Per-prop forces [N] from total thrust [N] and body torque [N m]."""
    d = params.arm_length / scalar(math.sqrt(2.0), params.arm_length)
    kt = params.prop0_spin_dir * params.prop_torque_from_thrust
    des_f = torch.minimum(total_thrust, params.max_cmd_total_thrust)
    terms = torch.stack([torque[..., 0] / d, torque[..., 1] / d, torque[..., 2] / kt], dim=-1)
    f = (lin3.mv3(const(_SIGNS, torque.device), terms) + des_f[..., None]) / 4.0
    return torch.minimum(torch.maximum(f, params.min_thrust_per_prop), params.max_thrust_per_prop)


def speeds_from_forces(params, forces, corr_factors):
    """omega_i = sqrt(f_i / (corr_i * kf)), zero for non-positive thrust."""
    pos = forces > 0
    w = sqrt(torch.where(pos, forces, 1.0) / (corr_factors * params.prop_thrust_from_speed_sqr))
    return torch.where(pos, w, 0.0)
