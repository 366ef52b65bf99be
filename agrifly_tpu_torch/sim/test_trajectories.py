"""Built-in test trajectory library for controller validation.

Port of `agrifly_tpu/sim/test_trajectories.py` (the QuadMocapRatesControl
node's command-trajectory menu): fixed point, circle, SHM, fixed-height
circle, circle with sinusoidal height and yaw, and yaw spin, each giving
(pos, vel, acc, yaw) as functions of stage time, with the 2 s
get-into-action blend. As in the JAX package, trajectory 4's z velocity
and acceleration keep the reference's missing 4x chain-rule factor on the
4-omega height sinusoid. sin and cos go through `ops/fmath` (correctly
rounded on the CPU), as the JAX package calls `jnp.sin` / `jnp.cos`.
"""

from __future__ import annotations

import torch

from agrifly_tpu_torch.ops import fmath

TRAJ_FIXED_POINT = 0
TRAJ_CIRCLE = 1
TRAJ_SHM = 2
TRAJ_CIRCLE_LINE = 3
TRAJ_CIRCLE_SIN_HEIGHT_YAW = 4
TRAJ_YAW_SPIN = 5

GET_INTO_ACTION_TIME = 2.0  # [s]


def evaluate(traj_id: int, t, desired_position, desired_yaw=0.0):
    """Command state of test trajectory `traj_id` (a python int) at time t
    [s] (a 0-d tensor or number), on desired_position's device. Returns
    (cmd_pos (3,), cmd_vel (3,), cmd_acc (3,), cmd_yaw) after the
    get-into-action blend from the hover setpoint."""
    des = torch.as_tensor(desired_position, dtype=torch.float32)
    dev = des.device
    t = torch.as_tensor(t, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    z3 = torch.zeros(3, dtype=torch.float32, device=dev)
    yaw0 = torch.as_tensor(desired_yaw, dtype=torch.float32, device=dev)
    v3 = lambda a, b, c: torch.stack([a, b, c])  # noqa: E731

    if traj_id == TRAJ_FIXED_POINT:
        pos, vel, acc, yaw = des, z3, z3, zero
    elif traj_id in (TRAJ_CIRCLE, TRAJ_CIRCLE_LINE, TRAJ_CIRCLE_SIN_HEIGHT_YAW):
        r, w = {TRAJ_CIRCLE: (1.0, 0.5), TRAJ_CIRCLE_LINE: (0.5, 1.0),
                TRAJ_CIRCLE_SIN_HEIGHT_YAW: (0.5, 0.5)}[traj_id]
        center = v3(zero, zero - 2.0 if traj_id == TRAJ_CIRCLE else zero, des[2])
        c, s = fmath.cos(w * t), fmath.sin(w * t)
        if traj_id == TRAJ_CIRCLE_SIN_HEIGHT_YAW:
            # NB: the reference omits the 4x chain-rule factor on z (kept)
            c4, s4 = fmath.cos(w * t * 4), fmath.sin(w * t * 4)
            pos = center + r * v3(c, s, c4)
            vel = r * w * v3(-s, c, -s4)
            acc = r * w * w * v3(-c, -s, -c4)
            yaw = w * t
        else:
            pos = center + r * v3(c, s, zero)
            vel = r * w * v3(-s, c, zero)
            acc = r * w * w * v3(-c, -s, zero)
            yaw = yaw0 + w * t if traj_id == TRAJ_CIRCLE else zero
    elif traj_id == TRAJ_SHM:
        a, w = 1.0, 2.0
        s, c = fmath.sin(w * t), fmath.cos(w * t)
        pos = des + a * v3(zero, s, zero)
        vel = a * w * v3(zero, c, zero)
        acc = a * w * w * v3(zero, -s, zero)
        yaw = yaw0
    elif traj_id == TRAJ_YAW_SPIN:
        pos, vel, acc = des, z3, z3
        yaw = 0.2 * t
    else:
        raise ValueError(f"unknown trajectory id {traj_id}")

    frac = torch.clamp(t / GET_INTO_ACTION_TIME, 0.0, 1.0)
    return (1.0 - frac) * des + frac * pos, frac * vel, frac * acc, yaw
