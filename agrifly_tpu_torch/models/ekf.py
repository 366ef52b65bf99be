"""Onboard 9-state EKF (pos, vel, attitude-correction rotation vector).

Port of the prediction half of `agrifly_tpu/models/ekf.py`
(KalmanFilter6DOF.cpp): accelerometer-aligned attitude init on the first
Predict, complementary attitude until the first UWB fix, then the full EKF
mean and block-sparse covariance propagation. The three lifecycle phases
are all computed and selected with `where`. The slice flies without UWB,
so the range update is not ported.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from agrifly_tpu_torch.ops import lin3, trig
from agrifly_tpu_torch.ops import rotation as rot
from agrifly_tpu_torch.ops.fmath import const, cross, dot3, norm3

TIME_CONST_ATT_CORR = 4.0  # [s]

# filter constants (KalmanFilter6DOF.cpp:14-27)
INIT_STD_POS = 3.0
INIT_STD_VEL = 3.0
INIT_STD_ATT_PERP = 10.0 * math.pi / 180.0
INIT_STD_ATT_GRAV = 30.0 * math.pi / 180.0
NOISE_STD_ACC = 5.0
NOISE_STD_GYRO = 0.1


class EkfState(NamedTuple):
    pos: torch.Tensor  # (3,)
    vel: torch.Tensor  # (3,)
    att: torch.Tensor  # (4,) quaternion
    angvel: torch.Tensor  # (3,)
    cov: torch.Tensor  # (9, 9)
    imu_init: torch.Tensor  # bool
    uwb_init: torch.Tensor  # bool
    last_att_corr: torch.Tensor  # (3,)
    num_rejected: torch.Tensor  # int32
    num_rejected_seq: torch.Tensor  # int32
    num_resets: torch.Tensor  # int32


def _diag_cov(stds, device):
    d = torch.tensor(stds, dtype=torch.float32, device=device)
    return torch.diag(d * d)


def init_state(device=None, init_std=None) -> EkfState:
    if init_std is None:
        init_std = ([INIT_STD_POS] * 3 + [INIT_STD_VEL] * 3
                    + [INIT_STD_ATT_PERP, INIT_STD_ATT_PERP, INIT_STD_ATT_GRAV])
    z3 = torch.zeros(3, dtype=torch.float32, device=device)
    i0 = torch.zeros((), dtype=torch.int32, device=device)
    f = torch.zeros((), dtype=torch.bool, device=device)
    return EkfState(pos=z3, vel=z3, att=rot.identity(device).clone(), angvel=z3,
                    cov=_diag_cov(init_std, device), imu_init=f, uwb_init=f,
                    last_att_corr=z3, num_rejected=i0, num_rejected_seq=i0,
                    num_resets=i0)


def _mm3(M, N):
    """3x3 matmul as a broadcast-sum over the inner axis."""
    return (M[..., :, :, None] * N[..., None, :, :]).sum(-2)


def _skew_mul(g, M):
    """skew(g) @ M: each column c of M -> c x g."""
    return cross(M.transpose(-1, -2), g[..., None, :]).transpose(-1, -2)


def cov_predict_block(P, dt, A, g, q_vel, q_att):
    """F P F^T + diag(0, q_vel, q_att) for F = [[I, dt I, 0], [0, I, A],
    [0, 0, I + skew(g)]], block by block (3x3 blocks)."""
    P11, P12, P13 = P[0:3, 0:3], P[0:3, 3:6], P[0:3, 6:9]
    P22, P23, P33 = P[3:6, 3:6], P[3:6, 6:9], P[6:9, 6:9]
    tr = lambda M: M.transpose(-1, -2)  # noqa: E731

    FP11 = P11 + dt * tr(P12)
    FP12 = P12 + dt * P22
    FP13 = P13 + dt * P23
    FP22 = P22 + _mm3(A, tr(P23))
    FP23 = P23 + _mm3(A, P33)
    DP33 = P33 + _skew_mul(g, P33)

    At = tr(A)
    mDt = lambda M: M + tr(_skew_mul(g, tr(M)))  # noqa: E731  (M @ D^T)
    N11 = FP11 + dt * FP12
    N12 = FP12 + _mm3(FP13, At)
    N13 = mDt(FP13)
    N22 = FP22 + _mm3(FP23, At)
    N23 = mDt(FP23)
    N33 = mDt(DP33)

    eye3 = torch.eye(3, dtype=P.dtype, device=P.device)
    top = torch.cat([N11, N12, N13], dim=-1)
    mid = torch.cat([tr(N12), N22 + q_vel * eye3, N23], dim=-1)
    bot = torch.cat([tr(N13), tr(N23), N33 + q_att * eye3], dim=-1)
    return torch.cat([top, mid, bot], dim=-2)


def _gravity_align_correction(att, meas_acc, gain=1.0):
    """Rotation nudging the attitude so predicted gravity matches meas_acc."""
    exp_acc = rot.rotate_back(att, const((0.0, 0.0, 1.0), att.device))
    norm = norm3(meas_acc)
    acc_unit = meas_acc / torch.where(norm < 1e-12, torch.ones_like(norm), norm)
    ax = cross(acc_unit, exp_acc)
    n = norm3(ax)
    big = n > 1e-6
    ax = torch.where(big, ax / torch.where(big, n, torch.ones_like(n)),
                     const((1.0, 0.0, 0.0), att.device))
    angle = trig.acos(torch.clamp(dot3(exp_acc, acc_unit), -1.0, 1.0))
    return rot.qmul(att, rot.from_axis_angle(ax, gain * angle))


def _select(cond, a: EkfState, b: EkfState) -> EkfState:
    return EkfState(*(torch.where(cond, x, y) for x, y in zip(a, b)))


def predict(s: EkfState, gyro, acc, dt) -> EkfState:
    """One prediction step (dt a 0-d float32 tensor); blends the three
    lifecycle phases with selects."""
    # phase A: first-ever IMU sample -> reset + gravity-aligned attitude
    fresh = init_state(s.pos.device)
    sA = fresh._replace(num_resets=s.num_resets + 1, num_rejected=s.num_rejected,
                        imu_init=torch.ones_like(s.imu_init))
    sA = sA._replace(att=_gravity_align_correction(sA.att, acc))

    # phase B: complementary attitude until the first UWB fix
    attB = rot.qmul(s.att, rot.from_rotation_vector(gyro * dt))
    attB = _gravity_align_correction(attB, acc, gain=dt / TIME_CONST_ATT_CORR)
    sB = s._replace(att=attB, angvel=gyro)

    # phase C: full EKF prediction
    acc_w = rot.rotate(s.att, acc) + const((0.0, 0.0, -9.81), s.pos.device)
    posC = s.pos + s.vel * dt
    velC = s.vel + acc_w * dt
    attC = rot.qmul(s.att, rot.from_rotation_vector(gyro * dt))

    R = rot.to_matrix(s.att)
    ax, ay, az = acc[0], acc[1], acc[2]
    # d(vel)/d(att) = dt * R [a]_x (KalmanFilter6DOF.cpp:176-204)
    dva = dt * torch.stack([ay * R[:, 2] - az * R[:, 1],
                            -ax * R[:, 2] + az * R[:, 0],
                            ax * R[:, 1] - ay * R[:, 0]], dim=-1)
    g = gyro * dt + s.last_att_corr / 2.0
    covC = cov_predict_block(s.cov, dt, dva, g,
                             NOISE_STD_ACC ** 2 * dt * dt, NOISE_STD_GYRO ** 2 * dt * dt)
    sC = s._replace(pos=posC, vel=velC, att=attC, angvel=gyro, cov=covC,
                    last_att_corr=torch.zeros_like(s.last_att_corr))

    return _select(s.imu_init, _select(s.uwb_init, sC, sB), sA)
