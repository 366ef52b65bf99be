"""Onboard 9-state EKF (pos, vel, attitude-correction rotation vector).

Port of `agrifly_tpu/models/ekf.py` (KalmanFilter6DOF.cpp):
accelerometer-aligned attitude init on the first Predict, complementary
attitude until the first UWB fix, then the full EKF mean and block-sparse
covariance propagation; the scalar UWB range update with 3-sigma
Mahalanobis gating, a hard reset after 5 sequential rejections, and the
covariance symmetrized by copying its lower triangle up. The lifecycle
phases and the update's branches are all computed and selected with
`where`.
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
NOISE_STD_RANGE = 0.14
OUTLIER_STAT_DIST = 3.0
MAX_SEQ_REJECT = 5


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


INIT_STD = (INIT_STD_POS,) * 3 + (INIT_STD_VEL,) * 3 + (
    INIT_STD_ATT_PERP, INIT_STD_ATT_PERP, INIT_STD_ATT_GRAV)


def _diag_cov(stds, device):
    d = const(tuple(stds), device)  # cached on the device: no copy from the host a tick
    return lin3.diag_from(d * d)


def _init_cov(device=None):
    return _diag_cov(INIT_STD, device)


def init_state(device=None, init_std=INIT_STD) -> EkfState:
    z3 = torch.zeros(3, dtype=torch.float32, device=device)
    i0 = torch.zeros((), dtype=torch.int32, device=device)
    f = torch.zeros((), dtype=torch.bool, device=device)
    return EkfState(pos=z3, vel=z3, att=rot.identity(device).clone(), angvel=z3,
                    cov=_diag_cov(init_std, device), imu_init=f, uwb_init=f,
                    last_att_corr=z3, num_rejected=i0, num_rejected_seq=i0,
                    num_resets=i0)


def _reset(s: EkfState) -> EkfState:
    """A fresh filter that keeps the reset and rejection counts."""
    return init_state(s.pos.device)._replace(num_resets=s.num_resets + 1,
                                              num_rejected=s.num_rejected)


def _mm3(M, N):
    """3x3 matmul, the inner axis summed left to right."""
    return (M[..., :, 0:1] * N[..., 0:1, :] + M[..., :, 1:2] * N[..., 1:2, :]
            + M[..., :, 2:3] * N[..., 2:3, :])


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


def predict(s: EkfState, gyro, acc, dt, *, noise_std_acc=NOISE_STD_ACC,
            noise_std_gyro=NOISE_STD_GYRO, init_cov_diag=None,
            uwb_init_at_reset=False) -> EkfState:
    """One prediction step (dt a 0-d float32 tensor); blends the three
    lifecycle phases with selects. The keywords let the offboard GPS-IMU
    estimator reuse it: its noise, its initial standard deviations, and no
    complementary phase (uwb_init set at the reset)."""
    # phase A: first-ever IMU sample -> reset + gravity-aligned attitude
    sA = _reset(s)._replace(imu_init=torch.ones_like(s.imu_init))
    if init_cov_diag is not None:
        sA = sA._replace(cov=_diag_cov(init_cov_diag, s.pos.device))
    if uwb_init_at_reset:
        sA = sA._replace(uwb_init=torch.ones_like(s.uwb_init))
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
                             noise_std_acc ** 2 * dt * dt, noise_std_gyro ** 2 * dt * dt)
    sC = s._replace(pos=posC, vel=velC, att=attC, angvel=gyro, cov=covC,
                    last_att_corr=torch.zeros_like(s.last_att_corr))

    return _select(s.imu_init, _select(s.uwb_init, sC, sB), sA)


def _sum_terms(terms):
    """The terms added left to right."""
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def update_range(s: EkfState, target_pos, meas_range, apply) -> EkfState:
    """Scalar UWB range update with Mahalanobis gating (cpp:243-309);
    where `apply` (a bool tensor) is False the state passes through."""
    apply = apply & s.imu_init & torch.isfinite(meas_range)
    # the reference marks UWB as initialized before gating (cpp:252), so even
    # a rejected measurement flips the filter into full-EKF mode
    s = s._replace(uwb_init=s.uwb_init | apply)

    diff = s.pos - target_pos
    expected = norm3(diff)
    h = diff / torch.where(expected < 1e-12, torch.ones_like(expected), expected)
    H = torch.cat([h, torch.zeros(6, dtype=h.dtype, device=h.device)])  # dR/dpos
    PHt = _sum_terms([s.cov[..., :, j] * H[j] for j in range(9)])
    innov_cov = _sum_terms([H[j] * PHt[j] for j in range(9)]) + NOISE_STD_RANGE ** 2
    L = PHt / innov_cov
    innov = meas_range - expected
    reject = innov * innov / innov_cov > OUTLIER_STAT_DIST ** 2

    # accepted: the mean and the rank-1 covariance update, symmetrized by
    # copying the lower triangle up
    dx = L * innov
    att_corr = dx[6:9]
    cov_new = s.cov - L[:, None] * PHt[None, :]
    cov_new = torch.tril(cov_new) + torch.tril(cov_new, -1).transpose(-1, -2)
    s_acc = s._replace(pos=s.pos + dx[0:3], vel=s.vel + dx[3:6],
                       att=rot.qmul(s.att, rot.from_rotation_vector(att_corr)),
                       last_att_corr=att_corr, cov=cov_new,
                       num_rejected_seq=torch.zeros_like(s.num_rejected_seq))

    # rejected: count, and hard-reset after MAX_SEQ_REJECT in a row
    nseq = s.num_rejected_seq + 1
    s_rej = s._replace(num_rejected=s.num_rejected + 1, num_rejected_seq=nseq)
    s_rej = _select(nseq >= MAX_SEQ_REJECT, _reset(s_rej), s_rej)

    return _select(apply, _select(reject, s_rej, s_acc), s)
