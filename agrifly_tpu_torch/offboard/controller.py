"""Offboard cascaded controller (ground-station side).

Port of `agrifly_tpu/offboard/controller.py`
(Offboard/QuadcopterController.cpp): `run` flies to a setpoint, and
`run_tracking` follows a trajectory reference. Both are memoryless and
return body-rate and thrust commands.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from agrifly_tpu_torch.models import controllers
from agrifly_tpu_torch.ops import rotation as rot
from agrifly_tpu_torch.ops.fmath import const, dot3, norm3


class OffboardCtrlParams(NamedTuple):
    pos_nat_freq: torch.Tensor
    pos_damping: torch.Tensor
    att_tc_xy: torch.Tensor
    att_tc_z: torch.Tensor
    min_vertical_proper_acc: torch.Tensor  # max-tilt floor [m/s^2]
    max_proper_acc: torch.Tensor
    min_proper_acc: torch.Tensor


def make_params(v, min_vertical_proper_acc=0.5 * 9.81, max_proper_acc=20.0,
                min_proper_acc=-1.0, device=None) -> OffboardCtrlParams:
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)  # noqa: E731
    return OffboardCtrlParams(
        pos_nat_freq=f32(v.pos_control_nat_freq),
        pos_damping=f32(v.pos_control_damping),
        att_tc_xy=f32(v.att_control_tc_xy),
        att_tc_z=f32(max(v.att_control_tc_z, v.att_control_tc_xy)),
        min_vertical_proper_acc=f32(min_vertical_proper_acc),
        max_proper_acc=f32(max_proper_acc),
        min_proper_acc=f32(min_proper_acc),
    )


def run(p: OffboardCtrlParams, cur_pos, cur_vel, cur_att, des_pos, des_vel):
    """Full feedback to a position setpoint with zero yaw. Returns
    (cmd_angvel, cmd_thrust)."""
    dev = cur_pos.device
    e3 = const((0.0, 0.0, 1.0), dev)
    cmd_acc = controllers.position_control(
        p.pos_nat_freq, p.pos_damping, cur_pos, cur_vel, des_pos, des_vel)
    proper = cmd_acc + const((0.0, 0.0, 9.81), dev)

    norm = norm3(proper)
    proper = torch.where(norm > p.max_proper_acc, proper * (p.max_proper_acc / norm), proper)
    proper = torch.stack([proper[..., 0], proper[..., 1],
                          torch.maximum(proper[..., 2], p.min_vertical_proper_acc)], dim=-1)

    norm = norm3(proper)
    thrust_dir = proper / torch.where(norm < 1e-12, torch.ones_like(norm), norm)
    cmd_thrust = norm * dot3(rot.rotate(cur_att, e3), thrust_dir)
    cmd_thrust = torch.maximum(cmd_thrust, p.min_proper_acc)

    # the JAX package composes with the yaw rotation of des_yaw = 0, an
    # exact product with the identity
    cmd_att = controllers.thrust_dir_to_attitude(thrust_dir)
    cmd_angvel = controllers.attitude_control(p.att_tc_xy, p.att_tc_z, cmd_att, cur_att)
    return cmd_angvel, cmd_thrust


def run_tracking(p: OffboardCtrlParams, cur_pos, cur_vel, cur_att,
                 ref_pos, ref_vel, ref_acc, ref_thrust, ref_angvel):
    """Trajectory tracking with zero yaw. Returns (cmd_angvel, cmd_thrust)."""
    dev = cur_pos.device
    acc_err = controllers.position_control(
        p.pos_nat_freq, p.pos_damping, cur_pos, cur_vel, ref_pos, ref_vel)
    cmd_thrust = ref_thrust + dot3(acc_err, rot.rotate(cur_att, const((0.0, 0.0, 1.0), dev)))

    total = ref_acc + acc_err + const((0.0, 0.0, 9.81), dev)
    norm = norm3(total)
    thrust_dir = total / torch.where(norm < 1e-12, torch.ones_like(norm), norm)
    ref_att = controllers.thrust_dir_to_attitude(thrust_dir)
    angvel_err = controllers.attitude_control(p.att_tc_xy, p.att_tc_z, ref_att, cur_att)
    return ref_angvel + angvel_err, cmd_thrust
