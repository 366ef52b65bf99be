"""Cascaded controller stages as plain tensor functions.

Port of `agrifly_tpu/models/controllers.py`: position -> acceleration,
tilt-prioritized attitude -> body rates, body rates -> torques, and the
thrust-direction -> attitude construction.
"""

from __future__ import annotations

import torch

from agrifly_tpu_torch.ops import rotation as rot
from agrifly_tpu_torch.ops import trig
from agrifly_tpu_torch.ops.fmath import const, cross, norm3


def _e3(like):
    return const((0.0, 0.0, 1.0), like.device)


def position_control(nat_freq, damping, est_pos, est_vel, des_pos,
                     des_vel=None, des_acc=None):
    """P-D on position/velocity with acceleration feedforward."""
    if des_vel is None:
        des_vel = torch.zeros_like(est_pos)
    if des_acc is None:
        des_acc = torch.zeros_like(est_pos)
    return ((des_pos - est_pos) * nat_freq * nat_freq
            + (des_vel - est_vel) * 2.0 * nat_freq * damping
            + des_acc)


def attitude_control(tc_xy, tc_z, des_att, est_att):
    """Tilt-prioritized attitude control: separate xy / z time constants."""
    e3 = _e3(est_att)
    err_att = rot.qmul(rot.qinv(des_att), est_att)
    des_rot_vec = rot.to_rotation_vector(err_att)

    e_b = rot.rotate_back(err_att, e3)  # errAtt^-1 * e3
    red_ax = cross(e_b, e3)
    red_angle = trig.acos(torch.clamp((e_b * e3).sum(-1), -1.0, 1.0))

    n = norm3(red_ax)
    small = n < 1e-12
    red_ax = torch.where(small, torch.zeros_like(red_ax),
                         red_ax / torch.where(small, torch.ones_like(n), n))

    k3 = 1.0 / tc_z
    k12 = 1.0 / tc_xy
    return -k3 * des_rot_vec - (k12 - k3) * red_angle * red_ax


def angvel_control(tc_xy, tc_z, inertia, des_angvel, est_angvel):
    """tau = J * (err / tc) + w x (J w)."""
    err = des_angvel - est_angvel
    des_ang_accel = torch.stack(
        [err[..., 0] / tc_xy, err[..., 1] / tc_xy, err[..., 2] / tc_z], dim=-1)
    nonlin = cross(est_angvel, (inertia * est_angvel[..., None, :]).sum(-1))
    return (inertia * des_ang_accel[..., None, :]).sum(-1) + nonlin


def thrust_dir_to_attitude(thrust_dir):
    """Smallest rotation taking e3 to thrust_dir (shared construction)."""
    e3 = _e3(thrust_dir)
    angle = trig.acos(torch.clamp((thrust_dir * e3).sum(-1), -1.0, 1.0))
    ax = cross(e3.expand_as(thrust_dir), thrust_dir)
    n = norm3(ax)
    small = n < 1e-6
    q = rot.from_rotation_vector(ax * (angle / torch.where(small, torch.ones_like(n), n)))
    return torch.where(small, rot.identity(q.device, q.dtype), q)
