"""Offboard mocap state estimator (ground-station side).

Port of the mocap path of `agrifly_tpu/offboard/estimators.py`
(MocapStateEstimator.{hpp,cpp}): decoupled 2x2 Kalman filters for position
and attitude, replayed forward through the delayed command stream (the
PredictionPipe) to compensate the control loop's transport delay, 6-sigma
gating and a forced reset after 10 straight rejections. The reference's
quirks the JAX package keeps are kept here too (see its docstrings).

`gpsimu_init` is here because the environment state carries the GPS-IMU
estimator's state; the mocap configuration never updates it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from agrifly_tpu_torch.models import ekf as _ekf
from agrifly_tpu_torch.ops import rotation as rot
from agrifly_tpu_torch.ops.fmath import const, exp, ipow, norm3, sqrt

PIPE_CAPACITY = 8
MAX_CONSECUTIVE_REJECT = 10
MEAS_REJECT_DIST = 6.0

# noise defaults (MocapStateEstimator.cpp:23-31)
MEAS_STD_POS = 0.02
MEAS_STD_ATT = 5.0 * math.pi / 180.0
PROC_STD_POS = 1.0 * 9.81
PROC_STD_ATT = 200.0
TAU_TRACK_ANGVEL = 0.04

GPSIMU_INIT_STD = (3.0,) * 6 + (10.0 * math.pi / 180.0,) * 3


class PredictionPipe(NamedTuple):
    """Ring of delayed (acc, angvel, ballistic) commands, ordered by time."""

    active_us: torch.Tensor  # (K,) int32 activation time
    acc: torch.Tensor  # (K, 3)
    angvel: torch.Tensor  # (K, 3)
    ballistic: torch.Tensor  # (K,) int32 0/1
    head: torch.Tensor  # int32
    count: torch.Tensor  # int32


class MocapEstState(NamedTuple):
    initialized: torch.Tensor  # bool
    pos: torch.Tensor  # (3,)
    vel: torch.Tensor  # (3,)
    att: torch.Tensor  # (4,)
    angvel: torch.Tensor  # (3,)
    var_pos: torch.Tensor  # (2,2)
    var_att: torch.Tensor  # (2,2)
    estimate_us: torch.Tensor  # int32: time at which the estimate is valid
    us_since_good_meas: torch.Tensor  # int32
    num_rejected: torch.Tensor  # int32
    num_rejected_consec: torch.Tensor  # int32
    pipe: PredictionPipe


def _reset_variance(device):
    return (const(((25.0, 0.0), (0.0, 25.0)), device),
            const(((1.0, 0.0), (0.0, 400.0)), device))


def mocap_init(device=None) -> MocapEstState:
    vp, va = _reset_variance(device)
    z3 = torch.zeros(3, dtype=torch.float32, device=device)
    i0 = torch.zeros((), dtype=torch.int32, device=device)
    pipe = PredictionPipe(
        active_us=torch.zeros(PIPE_CAPACITY, dtype=torch.int32, device=device),
        acc=torch.zeros((PIPE_CAPACITY, 3), dtype=torch.float32, device=device),
        angvel=torch.zeros((PIPE_CAPACITY, 3), dtype=torch.float32, device=device),
        ballistic=torch.ones(PIPE_CAPACITY, dtype=torch.int32, device=device),
        head=i0, count=i0)
    return MocapEstState(
        initialized=torch.zeros((), dtype=torch.bool, device=device),
        pos=z3, vel=z3, att=rot.identity(device).clone(), angvel=z3,
        var_pos=vp.clone(), var_att=va.clone(), estimate_us=i0,
        us_since_good_meas=i0, num_rejected=i0, num_rejected_consec=i0, pipe=pipe)


def gpsimu_init(device=None) -> _ekf.EkfState:
    return _ekf.init_state(device, init_std=GPSIMU_INIT_STD)


def pipe_push(p: PredictionPipe, now_us, delay_us, acc, angvel, do_push):
    """AddMessage: activation = now + delay; the oldest entry is evicted if
    the ring is full. Pushed commands are never ballistic."""
    full = p.count >= PIPE_CAPACITY
    evict = do_push & full
    head = torch.where(evict, (p.head + 1) % PIPE_CAPACITY, p.head)
    count = torch.where(evict, p.count - 1, p.count)
    slot = (head + count) % PIPE_CAPACITY
    si = (torch.arange(PIPE_CAPACITY, dtype=torch.int32, device=head.device) == slot) & do_push
    return PredictionPipe(
        active_us=torch.where(si, now_us + delay_us, p.active_us),
        acc=torch.where(si[:, None], acc[None, :], p.acc),
        angvel=torch.where(si[:, None], angvel[None, :], p.angvel),
        ballistic=torch.where(si, torch.zeros_like(p.ballistic), p.ballistic),
        head=head,
        count=count + do_push.to(torch.int32),
    )


def _pipe_ordered(p: PredictionPipe):
    """Pipe contents in logical (push) order; slots >= count get act = 2^30.
    The pipe's leaves may carry a leading vehicle shape."""
    idx = torch.arange(PIPE_CAPACITY, dtype=torch.int32, device=p.head.device)
    src = ((p.head[..., None] + idx) % PIPE_CAPACITY).long()
    act = torch.where(idx < p.count[..., None], torch.take_along_dim(p.active_us, src, -1),
                      2 ** 30)
    return (act, torch.take_along_dim(p.acc, src[..., None], -2),
            torch.take_along_dim(p.angvel, src[..., None], -2),
            torch.take_along_dim(p.ballistic, src, -1))


def pipe_clear_expired(p: PredictionPipe, t_us):
    """Drop leading entries whose successor is already active at t_us (the
    newest active message always stays)."""
    act, _, _, _ = _pipe_ordered(p)
    idx = torch.arange(PIPE_CAPACITY, dtype=torch.int32, device=p.head.device)
    droppable = (idx >= 1) & (idx < p.count) & (act <= t_us)
    advance = torch.where(droppable, idx, 0).amax()
    return p._replace(head=(p.head + advance) % PIPE_CAPACITY, count=p.count - advance)


def _integrate_segment(pos, vel, att, angvel, acc, cmd_angvel, ballistic, dt,
                       v0=None, w0=None):
    """One piecewise-constant-command segment. v0/w0 given: the prediction
    flavor (frozen start velocity and angvel); None: the update replay.
    dt and ballistic have the vehicles' leading shape, the vectors one
    trailing axis more."""
    c = torch.where(ballistic, 1.0, exp(-dt / TAU_TRACK_ANGVEL))[..., None]
    dt = dt[..., None]
    if v0 is not None:
        new_pos = pos + v0 * dt + acc * (dt * dt * 0.5)
        new_att = rot.qmul(att, rot.from_rotation_vector(w0 * dt))
    else:
        new_pos = pos + vel * dt
        new_att = rot.qmul(att, rot.from_rotation_vector(angvel * dt))
    new_vel = vel + acc * dt
    return new_pos, new_vel, new_att, c * angvel + (1.0 - c) * cmd_angvel


def _step_var(p00, p01, p11, proc, dt):
    # the reference puts sigma, not sigma^2, in Q (kept bug-compatible)
    n00 = p00 + dt * (p01 + p01) + (dt * dt) * p11 + ipow(dt, 4) * proc / 4.0
    return n00, p01 + dt * p11, p11 + ipow(dt, 2) * proc


def _replay(s: MocapEstState, t0_us, t1_us, update_variance, frozen=False):
    """Integrate the command stream from t0 to t1 over the pipe's slots,
    bug-compatible with the reference's segmentation (see the JAX package's
    `_replay`), for a state with any leading vehicle shape. Returns (pos,
    vel, att, angvel, var_pos, var_att)."""
    pos, vel, att, angvel = s.pos, s.vel, s.att, s.angvel
    v0 = s.vel if frozen else None
    w0 = s.angvel if frozen else None
    act, accs, angvels, balls = _pipe_ordered(s.pipe)
    vp = (s.var_pos[..., 0, 0], s.var_pos[..., 0, 1], s.var_pos[..., 1, 1])
    va = (s.var_att[..., 0, 0], s.var_att[..., 0, 1], s.var_att[..., 1, 1])

    t = torch.clamp(t0_us, min=0)
    t1 = t1_us
    has = torch.zeros_like(t)
    a_cur = torch.zeros_like(t)
    cur_acc = torch.zeros_like(pos)
    cur_angvel = torch.zeros_like(pos)
    cur_ball = torch.ones((), dtype=torch.bool, device=pos.device)
    for i in range(PIPE_CAPACITY):
        act_i = act[..., i]
        remaining = torch.clamp(t1 - t, min=0)
        window = torch.where(has != 0, act_i - a_cur, 2 ** 30)
        dt_us = torch.where(act_i <= t, 0, torch.minimum(remaining, window))
        dt = dt_us.to(torch.float32) * 1e-6
        pos, vel, att, angvel = _integrate_segment(
            pos, vel, att, angvel, cur_acc, cur_angvel, cur_ball, dt, v0, w0)
        if update_variance:
            vp = _step_var(*vp, PROC_STD_POS, dt)
            va = _step_var(*va, PROC_STD_ATT, dt)
        t = t + dt_us
        adopt = act_i <= t
        cur_acc = torch.where(adopt[..., None], accs[..., i, :], cur_acc)
        cur_angvel = torch.where(adopt[..., None], angvels[..., i, :], cur_angvel)
        cur_ball = torch.where(adopt, balls[..., i] != 0, cur_ball)
        a_cur = torch.where(adopt, act_i, a_cur)
        has = torch.maximum(has, adopt.to(torch.int32))

    # final segment to t1 (the newest message's window is unbounded)
    dt = torch.clamp(t1 - t, min=0).to(torch.float32) * 1e-6
    pos, vel, att, angvel = _integrate_segment(
        pos, vel, att, angvel, cur_acc, cur_angvel, cur_ball, dt, v0, w0)
    if update_variance:
        vp = _step_var(*vp, PROC_STD_POS, dt)
        va = _step_var(*va, PROC_STD_ATT, dt)
    var_pos = torch.stack([torch.stack([vp[0], vp[1]], -1), torch.stack([vp[1], vp[2]], -1)], -2)
    var_att = torch.stack([torch.stack([va[0], va[1]], -1), torch.stack([va[1], va[2]], -1)], -2)
    return pos, vel, att, angvel, var_pos, var_att


def mocap_set_predicted_values(s: MocapEstState, now_us, delay_us, cmd_angvel,
                               cmd_acc, do_push) -> MocapEstState:
    return s._replace(pipe=pipe_push(s.pipe, now_us, delay_us, cmd_acc, cmd_angvel, do_push))


def mocap_get_prediction(s: MocapEstState, now_us, latency_us):
    """Forward-simulate the latency: estimate at now + latency (cpp:61-118)."""
    pos, vel, att, angvel, _, _ = _replay(s, s.estimate_us, now_us + latency_us,
                                          update_variance=False, frozen=True)
    return pos, vel, att, angvel


def mocap_update(s: MocapEstState, now_us, meas_pos, meas_att, dt_advance_us) -> MocapEstState:
    """UpdateWithMeasurement: replay the pipe to now, 6-sigma gate, 2x2 KF
    corrections, force-accept + reset after 10 straight rejections. The
    adoption of the first measurement leaves estimate_us alone, as the
    reference does."""
    dev = meas_pos.device
    vp0, va0 = _reset_variance(dev)
    z3 = torch.zeros_like(meas_pos)
    s_uninit = s._replace(
        initialized=torch.ones_like(s.initialized), pos=meas_pos, vel=z3, att=meas_att,
        angvel=z3, var_pos=vp0, var_att=va0, us_since_good_meas=torch.zeros_like(s.estimate_us))

    pos, vel, att, angvel, var_pos, var_att = _replay(s, s.estimate_us, now_us,
                                                      update_variance=True)

    innov_pos = var_pos[0, 0] + MEAS_STD_POS ** 2
    innov_att = var_att[0, 0] + MEAS_STD_ATT ** 2
    dist_pos = norm3(meas_pos - pos) / sqrt(3.0 * innov_pos)
    dist_att = rot.get_angle(rot.qmul(rot.qinv(meas_att), att)) / sqrt(innov_att)
    should_reject = (dist_pos > MEAS_REJECT_DIST) | (dist_att > MEAS_REJECT_DIST)
    force_accept = s.num_rejected_consec >= MAX_CONSECUTIVE_REJECT
    reject = should_reject & ~force_accept

    # force-accept zeroes the state and resets the variance before the update
    pos_u = torch.where(force_accept, z3, pos)
    vel_u = torch.where(force_accept, z3, vel)
    att_u = torch.where(force_accept, rot.identity(dev), att)
    angvel_u = torch.where(force_accept, z3, angvel)
    var_pos_u = torch.where(force_accept, vp0, var_pos)
    var_att_u = torch.where(force_accept, va0, var_att)
    gain_pos = var_pos_u[:, 0] / (var_pos_u[0, 0] + MEAS_STD_POS ** 2)
    gain_att = var_att_u[:, 0] / (var_att_u[0, 0] + MEAS_STD_ATT ** 2)

    err_pos = meas_pos - pos_u
    new_pos = pos_u + gain_pos[0] * err_pos
    new_vel = vel_u + gain_pos[1] * err_pos
    err_att = rot.to_rotation_vector(rot.qmul(rot.qinv(att_u), meas_att))
    new_att = rot.qmul(att_u, rot.from_rotation_vector(gain_att[0] * err_att))
    new_angvel = angvel_u + gain_att[1] * err_att

    e0 = const((1.0, 0.0), dev)
    eye2 = const(((1.0, 0.0), (0.0, 1.0)), dev)
    ikh_pos = eye2 - gain_pos[:, None] * e0[None, :]
    ikh_att = eye2 - gain_att[:, None] * e0[None, :]
    new_var_pos = (ikh_pos[:, :, None] * var_pos_u[None, :, :]).sum(1)
    new_var_att = (ikh_att[:, :, None] * var_att_u[None, :, :]).sum(1)

    pick = lambda a, r: torch.where(reject, r, a)  # noqa: E731
    var_pos_f = pick(new_var_pos, var_pos)
    var_att_f = pick(new_var_att, var_att)
    since_good = torch.where(
        reject, torch.clamp(s.us_since_good_meas + dt_advance_us, max=2 ** 30),
        torch.zeros_like(s.us_since_good_meas))
    s_init = MocapEstState(
        # force-accept calls Reset(): the next measurement re-initializes
        initialized=~force_accept,
        pos=pick(new_pos, pos), vel=pick(new_vel, vel), att=pick(new_att, att),
        angvel=pick(new_angvel, angvel),
        var_pos=0.5 * (var_pos_f + var_pos_f.T),
        var_att=0.5 * (var_att_f + var_att_f.T),
        estimate_us=now_us, us_since_good_meas=since_good,
        num_rejected=s.num_rejected + reject.to(torch.int32),
        num_rejected_consec=torch.where(reject, s.num_rejected_consec + 1,
                                        torch.zeros_like(s.num_rejected_consec)),
        pipe=pipe_clear_expired(s.pipe, now_us),
    )
    return select(s.initialized, s_init, s_uninit)


def select(cond, a, b):
    """Leafwise torch.where over two states of the same NamedTuple type."""
    if isinstance(a, tuple):
        return type(a)(*(select(cond, x, y) for x, y in zip(a, b)))
    return torch.where(cond, a, b)
