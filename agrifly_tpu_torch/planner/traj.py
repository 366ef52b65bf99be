"""Closed-form minimum-jerk motion primitives, batched.

Port of `agrifly_tpu/planner/traj.py` as the planner, the tracking
controller and the evaluation use it: `generate` with position, velocity
and acceleration goals, evaluation (`position` ... `omega`,
`to_poly_coeffs`), the dyadic input-feasibility sweep, the velocity- and
the position-feasibility proofs, and the verdict codes.

A trajectory is a NamedTuple of tensors with any leading batch shape:
p(t) = p0 + v0 t + a0 t^2/2 + g t^3/6 + b t^4/24 + a t^5/120 per axis.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from agrifly_tpu_torch.ops import rootfind, trig
from agrifly_tpu_torch.ops.fmath import cross, dot3, ipow, norm3, scalar, sqrt, sum3

# feasibility verdict codes (RapidTrajectoryGenerator.hpp:74-86)
FEASIBLE = 0
INDETERMINABLE = 1
INFEASIBLE_THRUST_HIGH = 2
INFEASIBLE_THRUST_LOW = 3
STATE_FEASIBLE = 0
STATE_INFEASIBLE = 1


class Traj(NamedTuple):
    alpha: torch.Tensor  # (..., 3)
    beta: torch.Tensor  # (..., 3)
    gamma: torch.Tensor  # (..., 3)
    a0: torch.Tensor  # (..., 3)
    v0: torch.Tensor  # (..., 3)
    p0: torch.Tensor  # (..., 3)
    tf: torch.Tensor  # (...)
    cost: torch.Tensor  # (...)  sum of per-axis jerk-integral costs


def generate(p0, v0, a0, tf, goal_pos, goal_vel, goal_acc):
    """Min-jerk primitive to a fixed end position, velocity and acceleration
    (SingleAxisTrajectory.cpp:59-107, the all-constrained case)."""
    T = tf[..., None]
    da = goal_acc - a0
    dv = goal_vel - v0 - a0 * T
    dp = goal_pos - p0 - v0 * T - 0.5 * a0 * T * T

    T2, T3, T4, T5 = T * T, ipow(T, 3), ipow(T, 4), ipow(T, 5)
    al = (60 * T2 * da - 360 * T * dv + 720 * dp) / T5
    be = (-24 * T3 * da + 168 * T2 * dv - 360 * T * dp) / T5
    ga = (3 * T4 * da - 24 * T3 * dv + 60 * T2 * dp) / T5

    cost = sum3(
        ga * ga + be * ga * T + be * be * T2 / scalar(3.0, T2) + al * ga * T2 / scalar(3.0, T2)
        + al * be * T3 / 4.0 + al * al * T4 / scalar(20.0, T4))
    return Traj(alpha=al, beta=be, gamma=ga, a0=a0, v0=v0, p0=p0, tf=tf, cost=cost)


def position(tr: Traj, t):
    t = t[..., None]
    return (
        tr.p0 + tr.v0 * t + tr.a0 * ipow(t, 2) / 2.0 + tr.gamma * ipow(t, 3) / scalar(6.0, t)
        + tr.beta * ipow(t, 4) / scalar(24.0, t) + tr.alpha * ipow(t, 5) / scalar(120.0, t)
    )


def velocity(tr: Traj, t):
    t = t[..., None]
    return (
        tr.v0 + tr.a0 * t + tr.gamma * ipow(t, 2) / 2.0 + tr.beta * ipow(t, 3) / scalar(6.0, t)
        + tr.alpha * ipow(t, 4) / scalar(24.0, t)
    )


def acceleration(tr: Traj, t):
    t = t[..., None]
    return (tr.a0 + tr.gamma * t + tr.beta * ipow(t, 2) / 2.0
            + tr.alpha * ipow(t, 3) / scalar(6.0, t))


def jerk(tr: Traj, t):
    t = t[..., None]
    return tr.gamma + tr.beta * t + tr.alpha * ipow(t, 2) / 2.0


def to_poly_coeffs(tr: Traj):
    """(..., 6, 3) quintic coefficients, highest power first (GetTrajectory)."""
    return torch.stack([tr.alpha / scalar(120.0, tr.alpha), tr.beta / scalar(24.0, tr.beta),
                        tr.gamma / scalar(6.0, tr.gamma), tr.a0 / 2.0,
                        tr.v0, tr.p0], dim=-2)


def normal_vector(tr: Traj, t, grav):
    n = acceleration(tr, t) - grav
    norm = norm3(n, keepdim=True)
    return n / torch.where(norm < 1e-12, torch.ones_like(norm), norm)


def thrust(tr: Traj, t, grav):
    return norm3(acceleration(tr, t) - grav)


def omega(tr: Traj, t, dt: float, grav):
    """Finite-difference world-frame body rates rotating the normal vector."""
    n0 = normal_vector(tr, t, grav)
    n1 = normal_vector(tr, t + dt, grav)
    cr = cross(n0, n1)
    nrm = norm3(cr, keepdim=True)
    ok = nrm[..., 0] > 1e-6
    unit = cr / torch.where(nrm < 1e-12, torch.ones_like(nrm), nrm)
    angle = trig.acos(torch.clamp(dot3(n0, n1), -1.0, 1.0)) / dt
    return torch.where(ok[..., None], unit * angle[..., None], torch.zeros_like(cr))


# -----------------------------------------------------------------------------
# input feasibility: fixed-depth dyadic bisection
# -----------------------------------------------------------------------------

def _axis_minmax_acc(tr: Traj, t1, t2):
    """Per-axis acceleration extrema on [t1, t2] (SingleAxisTrajectory.cpp:118-156)."""
    al, be, ga = tr.alpha, tr.beta, tr.gamma
    zero = torch.zeros_like(al)
    one = torch.ones_like(al)
    det = be * be - 2.0 * ga * al
    has_quad = torch.abs(al) > 0
    sq = sqrt(torch.clamp(det, min=0.0))
    safe_al = torch.where(has_quad, al, one)
    real = has_quad & (det >= 0)
    tq0 = torch.where(real, (-be + sq) / safe_al, zero)
    tq1 = torch.where(real, (-be - sq) / safe_al, zero)
    has_lin = torch.abs(be) > 0
    tl0 = torch.where(has_lin, -ga / torch.where(has_lin, be, one), zero)
    t_0 = torch.where(has_quad, tq0, tl0)
    t_1 = torch.where(has_quad, tq1, zero)

    def acc_at(t):
        return tr.a0 + ga * t + be * ipow(t, 2) / 2.0 + al * ipow(t, 3) / scalar(6.0, t)

    t1b = t1[..., None]
    t2b = t2[..., None]
    a_lo = acc_at(t1b)
    a_hi = acc_at(t2b)
    amin = torch.minimum(a_lo, a_hi)
    amax = torch.maximum(a_lo, a_hi)
    for tc in (t_0, t_1):
        inside = (tc > t1b) & (tc < t2b)
        a_c = acc_at(torch.minimum(torch.maximum(tc, t1b), t2b))
        amin = torch.where(inside, torch.minimum(amin, a_c), amin)
        amax = torch.where(inside, torch.maximum(amax, a_c), amax)
    return amin, amax


def _axis_max_jerk_sq(tr: Traj, t1, t2):
    """Per-axis max jerk^2 on [t1, t2] (cpp:165-177)."""
    al, be = tr.alpha, tr.beta

    def jerk_at(t):
        return tr.gamma + be * t + al * ipow(t, 2) / 2.0

    t1b = t1[..., None]
    t2b = t2[..., None]
    j2 = torch.maximum(ipow(jerk_at(t1b), 2), ipow(jerk_at(t2b), 2))
    has = torch.abs(al) > 0
    tmax = torch.where(has, -be / torch.where(has, al, torch.ones_like(al)), t1b - 1.0)
    inside = (tmax > t1b) & (tmax < t2b)
    j_in = ipow(jerk_at(torch.minimum(torch.maximum(tmax, t1b), t2b)), 2)
    return torch.where(inside, torch.maximum(j2, j_in), j2)


def _section_verdict(tr: Traj, grav, t1, t2, fmin_allowed, fmax_allowed, wmax_allowed):
    """One section's test. Returns (feasible, infeasible, needs_split)."""
    thr1 = thrust(tr, t1, grav)
    thr2 = thrust(tr, t2, grav)
    hard_bad = (torch.maximum(thr1, thr2) > fmax_allowed) | (
        torch.minimum(thr1, thr2) < fmin_allowed)

    amin, amax = _axis_minmax_acc(tr, t1, t2)
    v1 = amin - grav
    v2 = amax - grav
    hard_bad = hard_bad | torch.any(
        torch.maximum(v1 * v1, v2 * v2) > fmax_allowed * fmax_allowed, dim=-1)

    crosses_zero = (v1 * v2) < 0
    fmin_sq_axis = torch.where(crosses_zero, torch.zeros_like(v1),
                               ipow(torch.minimum(torch.abs(v1), torch.abs(v2)), 2))
    fmax_sq_axis = ipow(torch.maximum(torch.abs(v1), torch.abs(v2)), 2)
    fmin_sq = sum3(fmin_sq_axis)
    fmax_sq = sum3(fmax_sq_axis)
    jmax_sq = sum3(_axis_max_jerk_sq(tr, t1, t2))

    fmin = sqrt(fmin_sq)
    fmax = sqrt(fmax_sq)
    wbound = torch.where(fmin_sq > 1e-6,
                         sqrt(jmax_sq / torch.clamp(fmin_sq, min=1e-12)),
                         torch.full_like(fmin_sq, math.inf))

    hard_bad = hard_bad | (fmax < fmin_allowed) | (fmin > fmax_allowed)
    uncertain = (fmin < fmin_allowed) | (fmax > fmax_allowed) | (wbound > wmax_allowed)
    return ~hard_bad & ~uncertain, hard_bad, ~hard_bad & uncertain


def check_input_feasibility(tr: Traj, grav, fmin_allowed=5.0, fmax_allowed=30.0,
                            wmax_allowed=20.0, min_time_section=0.02,
                            max_depth=9, static_max_tf=None, sections=None):
    """Interval-bisection proof that thrust in [fmin, fmax] and |w| <= wmax,
    for trajectories of any batch shape; grav (3,) or broadcastable to
    their (..., 3) vectors.

    The plain version of the gate kernel (`cuda_plan.plan_gates`, which
    the planner calls). True = InputFeasible. A needed section narrower
    than min_time_section rejects (InputIndeterminable); uncertain sections
    recurse into the next dyadic level. static_max_tf: an upper bound on
    every tf, which lets levels that are provably too narrow reject without
    being evaluated. sections: None, or an int32 tensor of the batch shape
    that receives the sections a depth-first walk evaluates before it stops
    (the kernel's count; `_depth_first_sections`)."""
    batch = tr.tf.shape
    ok = torch.ones(batch, dtype=torch.bool, device=tr.tf.device)
    needed = torch.ones(batch + (1,), dtype=torch.bool, device=tr.tf.device)
    walk = [] if sections is not None else None
    for level in range(max_depth + 1):
        n = 1 << level
        if static_max_tf is not None and static_max_tf / n < min_time_section:
            ok = ok & ~torch.any(needed, dim=-1)
            if walk is not None:
                walk.append((level, torch.zeros_like(needed), torch.zeros_like(needed), needed))
            break
        idx = torch.arange(n, dtype=torch.float32, device=tr.tf.device)
        t1 = tr.tf[..., None] * (idx / n)
        t2 = tr.tf[..., None] * ((idx + 1.0) / n)
        too_narrow = tr.tf[..., None] / n < min_time_section
        tr_b = Traj(*(x[..., None, :] if x.dim() == len(batch) + 1 else x[..., None]
                      for x in tr))
        _, infeas, split = _section_verdict(
            tr_b, grav[..., None, :], t1, t2, fmin_allowed, fmax_allowed, wmax_allowed)
        ok = ok & ~torch.any(needed & (too_narrow | infeas), dim=-1)
        if walk is not None:
            evaluated = needed & ~too_narrow
            rejects = infeas | split if level == max_depth else infeas
            walk.append((level, evaluated, evaluated & rejects, needed & too_narrow))
        if level == max_depth:
            ok = ok & ~torch.any(needed & split, dim=-1)
            break
        needed = torch.repeat_interleave(needed & split & ~too_narrow, 2, dim=-1)
    if walk is not None:
        sections.copy_(_depth_first_sections(walk, max_depth))
    check_input_feasibility.calls += 1
    return ok


def _depth_first_sections(walk, max_depth):
    """The sections a depth-first walk of the dyadic tree evaluates, from the
    level sweep's record: walk holds, per level, (level, evaluated, counted
    rejects, uncounted rejects), each (..., 2^level). The walk visits the
    evaluated sections in preorder and stops at the first reject, counting
    it where it was evaluated (a hard verdict or a split at the last level),
    not where it was too narrow or cut. Preorder sorts (idx 2^(D - level),
    level), D = max_depth."""
    first, keys = None, []
    for level, evaluated, counted, uncounted in walk:
        key = (torch.arange(evaluated.shape[-1], device=evaluated.device) << (max_depth - level)) \
            * (max_depth + 2) + level
        keys.append(key)
        big = torch.iinfo(torch.int64).max
        k = torch.where(counted | uncounted, key, big).amin(-1)
        first = k if first is None else torch.minimum(first, k)
    count, counted_first = 0, torch.zeros_like(first, dtype=torch.bool)
    for (_, evaluated, counted, _), key in zip(walk, keys):
        count = count + (evaluated & (key < first[..., None])).sum(-1)
        counted_first = counted_first | (counted & (key == first[..., None])).any(-1)
    return (count + counted_first.to(count.dtype)).to(torch.int32)


check_input_feasibility.calls = 0  # calls since the last reset


def check_velocity_feasibility(tr: Traj, vmax, strict_degenerate: bool = True):
    """Per-axis |v| < vmax proof via cubic acceleration roots
    (RapidTrajectoryGenerator.cpp:163-208). strict_degenerate=True is
    bug-compatible with the reference: an axis whose acceleration cubic
    degenerates is infeasible; False takes such an axis's quadratic
    acceleration roots instead. The plain version of the gate kernel
    (`cuda_plan.plan_gates`, which the planner calls)."""
    c0 = tr.alpha / scalar(6.0, tr.alpha)
    c1 = tr.beta / 2.0
    c2 = tr.gamma
    c3 = tr.a0
    degenerate = torch.abs(c0) <= 1e-6  # (..., 3)

    safe_c0 = torch.where(degenerate, torch.ones_like(c0), c0)
    roots, valid = rootfind.solve_cubic(c1 / safe_c0, c2 / safe_c0, c3 / safe_c0)
    if not strict_degenerate:
        # degenerate axis: acceleration = beta/2 t^2 + gamma t + a0
        qroots, qvalid = rootfind.solve_quadratic(c1, c2, c3)
        qroots3 = torch.cat([qroots, torch.zeros_like(qroots[..., :1])], dim=-1)
        qvalid3 = torch.cat([qvalid, torch.zeros_like(qvalid[..., :1])], dim=-1)
        roots = torch.where(degenerate[..., None], qroots3, roots)
        valid = torch.where(degenerate[..., None], qvalid3, valid)
    tf = tr.tf[..., None, None].expand(roots.shape[:-1] + (1,))
    times = torch.cat([roots, torch.zeros_like(tf), tf], dim=-1)  # (..., 3, 5)
    tvalid = torch.cat([valid, torch.ones_like(valid[..., :2])], dim=-1)
    tvalid = tvalid & (times >= 0) & (times <= tf)

    t = times[..., None]  # (..., 3axis, 5, 1)
    v = (
        tr.v0[..., None, None, :] + tr.a0[..., None, None, :] * t
        + tr.gamma[..., None, None, :] * ipow(t, 2) / 2.0
        + tr.beta[..., None, None, :] * ipow(t, 3) / scalar(6.0, t)
        + tr.alpha[..., None, None, :] * ipow(t, 4) / scalar(24.0, t)
    )  # (..., 3, 5, 3)
    exceeded = torch.any(torch.abs(v) >= vmax, dim=-1) & tvalid
    infeasible = torch.any(exceeded.flatten(-2), dim=-1)
    if strict_degenerate:
        infeasible = infeasible | torch.any(degenerate, dim=-1)
    check_velocity_feasibility.calls += 1
    return ~infeasible


check_velocity_feasibility.calls = 0  # calls since the last reset


def check_position_feasibility(tr: Traj, boundary_point, boundary_normal):
    """Half-plane containment proof (cpp:210-262). True = the trajectory
    stays strictly on the normal's side of the plane through
    boundary_point."""
    n = boundary_normal / norm3(boundary_normal, keepdim=True)

    # velocity along the normal: a quartic in t
    c0 = dot3(n, tr.alpha) / scalar(24.0, tr.alpha)
    c1 = dot3(n, tr.beta) / scalar(6.0, tr.beta)
    c2 = dot3(n, tr.gamma) / 2.0
    c3 = dot3(n, tr.a0)
    c4 = dot3(n, tr.v0)

    quartic = torch.abs(c0) > 1e-6
    safe_c0 = torch.where(quartic, c0, torch.ones_like(c0))
    r4, v4 = rootfind.solve_quartic(c1 / safe_c0, c2 / safe_c0, c3 / safe_c0, c4 / safe_c0)
    safe_c1 = torch.where(torch.abs(c1) > 0, c1, torch.ones_like(c1))
    r3, v3 = rootfind.solve_cubic(c2 / safe_c1, c3 / safe_c1, c4 / safe_c1)
    r3 = torch.cat([r3, torch.zeros_like(r3[..., :1])], dim=-1)
    v3 = torch.cat([v3, torch.zeros_like(v3[..., :1])], dim=-1)
    roots = torch.where(quartic[..., None], r4, r3)
    rvalid = torch.where(quartic[..., None], v4, v3)

    tf = tr.tf[..., None]
    times = torch.cat([roots, torch.zeros_like(tf), tf.expand(roots.shape[:-1] + (1,))], dim=-1)
    tvalid = torch.cat([rvalid, torch.ones_like(rvalid[..., :2])], dim=-1)
    tvalid = tvalid & (times >= 0) & (times <= tf)

    tr_b = Traj(*(x[..., None, :] if x.dim() == tr.tf.dim() + 1 else x[..., None] for x in tr))
    d = dot3(position(tr_b, times) - boundary_point[..., None, :], n[..., None, :])
    return ~torch.any((d <= 0) & tvalid, dim=-1)
