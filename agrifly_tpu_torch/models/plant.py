"""6-DOF quadcopter plant with first-order motor dynamics.

Port of `agrifly_tpu/models/plant.py` (Quadcopter_T.cpp:86-156,
Motor.cpp:40-84): four motors as one (4,) state, the reference's integrator
(p += v dt + 0.5 a dt^2; v += a dt; q <- q * exp(w dt); w += alpha dt), the
ground clamp at z = 0, and IMU fabrication from injected unit normals.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from agrifly_tpu_torch.ops import lin3
from agrifly_tpu_torch.ops import rotation as rot
from agrifly_tpu_torch.ops.fmath import const, exp

GRAVITY = (0.0, 0.0, -9.81)
ACC_NOISE_STD = 0.2  # [m/s^2]
GYRO_NOISE_STD = 0.1  # [rad/s]
MOTOR_SPIN_SIGNS = (1.0, -1.0, 1.0, -1.0)  # rotation-axis z signs per motor
# motor position pattern (x, y) / (armLength/sqrt(2))
MOTOR_XY = np.array([[+1.0, -1.0], [-1.0, -1.0], [-1.0, +1.0], [+1.0, +1.0]], np.float32)


class PlantParams(NamedTuple):
    mass: torch.Tensor
    inertia: torch.Tensor  # (3,3)
    inertia_inv: torch.Tensor  # (3,3)
    motor_positions: torch.Tensor  # (4,3) incl. center-of-mass error
    kf: torch.Tensor  # thrust from speed^2
    kt_sqr: torch.Tensor  # torque from speed^2
    motor_time_const: torch.Tensor
    motor_inertia: torch.Tensor
    motor_min_speed: torch.Tensor
    motor_max_speed: torch.Tensor
    lin_drag_b: torch.Tensor  # (3,)
    imu_rot_inv: torch.Tensor  # (3,3) IMU mounting rotation inverse


class PlantState(NamedTuple):
    pos: torch.Tensor  # (3,)
    vel: torch.Tensor  # (3,)
    att: torch.Tensor  # (4,)
    angvel: torch.Tensor  # (3,)
    motor_speeds: torch.Tensor  # (4,)


def _f32(v, device):
    return torch.tensor(np.asarray(v, np.float32), device=device)


def make_params(v, device=None) -> PlantParams:
    """PlantParams from a `models.constants.VehicleParams` preset."""
    d = v.arm_length / np.sqrt(2.0)
    positions = np.concatenate([MOTOR_XY * d, np.zeros((4, 1))], axis=1)
    inertia = np.asarray(v.inertia_matrix, np.float64)
    imu = torch.tensor(rot.from_euler_ypr_np(v.imu_yaw, v.imu_pitch, v.imu_roll))
    imu_rot_inv = rot.to_matrix(rot.qinv(imu)).numpy()
    return PlantParams(
        mass=_f32(v.mass, device),
        inertia=_f32(inertia, device),
        inertia_inv=_f32(np.linalg.inv(inertia), device),
        motor_positions=_f32(positions, device),
        kf=_f32(v.prop_thrust_from_speed_sqr, device),
        kt_sqr=_f32(v.prop_torque_from_speed_sqr, device),
        motor_time_const=_f32(v.motor_time_const, device),
        motor_inertia=_f32(v.motor_inertia, device),
        motor_min_speed=_f32(v.motor_min_speed, device),
        motor_max_speed=_f32(v.motor_max_speed, device),
        lin_drag_b=_f32(v.lin_drag_coeff_b, device),
        imu_rot_inv=_f32(imu_rot_inv, device),
    )


def init_state(pos=(0.0, 0.0, 0.0), device=None) -> PlantState:
    z3 = torch.zeros(3, dtype=torch.float32, device=device)
    return PlantState(pos=_f32(pos, device), vel=z3, att=rot.identity(device),
                      angvel=z3, motor_speeds=torch.zeros(4, dtype=torch.float32, device=device))


def step(p: PlantParams, s: PlantState, motor_cmds, dt):
    """Advance the plant by dt (a 0-d float32 tensor) with no external force
    or torque. Returns (new_state, acc_world_for_imu): the world-frame
    acceleration including gravity, z zeroed on ground contact."""
    dev = s.pos.device
    grav = const(GRAVITY, dev)
    spin = const(MOTOR_SPIN_SIGNS, dev)

    # motors
    cmds = torch.clamp(motor_cmds, min=0.0)
    tc_zero = p.motor_time_const == 0.0
    c = torch.where(tc_zero, 0.0,
                    exp(-dt / torch.where(tc_zero, torch.ones_like(dt), p.motor_time_const)))
    new_speeds = c * s.motor_speeds + (1.0 - c) * cmds
    new_speeds = torch.minimum(torch.maximum(new_speeds, p.motor_min_speed), p.motor_max_speed)
    dspeed = (new_speeds - s.motor_speeds) / dt

    w_abs_w = new_speeds * torch.abs(new_speeds)
    thrusts = p.kf * w_abs_w  # along +z body
    zeros4 = torch.zeros_like(thrusts)
    forces_b = torch.stack([zeros4, zeros4, thrusts], dim=-1)  # (4,3)

    # torque: aero drag, thrust moment, rotor acceleration reaction
    tz_aero = -p.kt_sqr * w_abs_w * spin
    tz_react = -dspeed * p.motor_inertia * spin
    torque_b = lin3.cross_rows(p.motor_positions, forces_b)
    torque_b = torque_b + torch.stack([zeros4, zeros4, tz_aero + tz_react], dim=-1)

    total_force_b = forces_b.sum(0)
    total_torque_b = torque_b.sum(0)
    h_motor_z = (new_speeds * p.motor_inertia * spin).sum()

    # rigid body
    e3 = const((0.0, 0.0, 1.0), dev)
    ang_mom = lin3.mv3(p.inertia, s.angvel) + h_motor_z * e3
    ang_acc = lin3.mv3(p.inertia_inv, total_torque_b - lin3.cross_rows(s.angvel, ang_mom))

    vel_b = rot.rotate_back(s.att, s.vel)
    total_force_b = total_force_b - p.lin_drag_b * vel_b
    acc = grav + rot.rotate(s.att, total_force_b) / p.mass

    new_pos = s.pos + s.vel * dt + 0.5 * acc * dt * dt
    new_vel = s.vel + acc * dt
    new_att = rot.qmul(s.att, rot.from_rotation_vector(s.angvel * dt))
    new_angvel = s.angvel + ang_acc * dt

    # ground contact
    grounded = (new_pos[2] <= 0.0) & (new_vel[2] < 0.0)
    zero_z = grounded & const((False, False, True), dev, torch.bool)
    new_pos = torch.where(zero_z, 0.0, new_pos)
    new_vel = torch.where(zero_z, 0.0, new_vel)
    acc_imu = torch.where(zero_z, 0.0, acc)
    new_angvel = torch.where(grounded, torch.zeros_like(new_angvel), new_angvel)
    return PlantState(pos=new_pos, vel=new_vel, att=new_att, angvel=new_angvel,
                      motor_speeds=new_speeds), acc_imu


def imu_measurements(p: PlantParams, s: PlantState, acc_world, noise):
    """Noisy IMU readings from the post-step plant state (Quadcopter_T.cpp:
    159-183). noise: (gyro_n (3,), acc_n (3,)) unit normals."""
    gyro_n, acc_n = noise
    grav = const(GRAVITY, s.pos.device)
    gyro = lin3.mv3(p.imu_rot_inv, s.angvel) + gyro_n * GYRO_NOISE_STD
    acc_b = rot.rotate_back(s.att, acc_world - grav)
    acc_b = lin3.mv3(p.imu_rot_inv, acc_b) + acc_n * ACC_NOISE_STD
    return gyro, acc_b
