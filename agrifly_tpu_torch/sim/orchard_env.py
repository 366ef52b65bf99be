"""Config #3: depth-camera orchard flight — render + RAPPIDS + tracking.

Port of `agrifly_tpu/sim/orchard_env.py` in the configuration
`make_params(use_pallas=True)`: one `frame_step` renders a depth frame
from the true pose (the raycast kernel on CUDA; in an imported world,
`make_params(mesh_scene=...)`, the strip-culled mesh kernel), runs the
RAPPIDS planner on it (the inflation kernel on CUDA), then advances
`steps_per_frame` 2 ms ticks that track the planned trajectory through the
quantized, delayed radio channel (200 Hz mocap estimator -> RunTracking at
100 Hz -> rates command -> 30 ms delay line -> onboard rates controller). With
`fused_ticks` (the default, as in the JAX package) the ticks run as one
CUDA kernel (`sim/cuda_frame.py`); otherwise as plain torch ops
(`frame_ticks_plain`).

The mission climbs to `takeoff_height` until `start_flight_time`, then
plans toward the waypoints; before a plan exists it hovers at 2 m.

A fleet (`frame_step_fleet`, `fly_fleet`) is B vehicles sharing one
`OrchardEnvParams`, with a leading B axis on every state leaf: the
counterpart of the JAX package's `jax.vmap` over the perception, written
as that axis. The perception code takes any leading shape, so one frame
of a fleet launches the raycast (or mesh) kernel once for all B images, the
inflation kernel once per planner round for all B images, and the tick
kernel once for all B vehicles.

Randomness: `frame_step` draws the planner's (4, N) uniform block and the
(steps_per_frame, 2, 3) IMU normal block from a torch.Generator, or takes
them as `draws` (the parity tests inject the JAX package's draws).
Nothing in a frame reads a tensor back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from agrifly_tpu_torch import card_or_raise
from agrifly_tpu_torch.models import constants as qconst
from agrifly_tpu_torch.convert import flatten_tensors
from agrifly_tpu_torch.io import radio
from agrifly_tpu_torch.offboard import controller as offboard_ctrl
from agrifly_tpu_torch.offboard import estimators
from agrifly_tpu_torch.ops import filters, lin3
from agrifly_tpu_torch.ops import rotation as rot
from agrifly_tpu_torch.ops.fmath import const, norm3
from agrifly_tpu_torch.planner import rappids
from agrifly_tpu_torch.planner import traj as traj_mod
from agrifly_tpu_torch.render import cuda_meshscene, cuda_raycast, raycast
from agrifly_tpu_torch.render import orchard as orch
from agrifly_tpu_torch.render.meshscene import MeshScene
from agrifly_tpu_torch.sim import delayline
from agrifly_tpu_torch.sim import env as env_mod

GRAV_W = (0.0, 0.0, -9.81)

# the mission constants the orchard profile shares with sim/mission.py
from agrifly_tpu_torch.sim.mission import (LANDING_BLEND_TIME, LANDING_SPEED,  # noqa: E402
                                           MAX_WAYPOINTS, WAYPOINT_RADIUS)

# mission sub-stages of the orchard profile
MSTAGE_CRUISE = 0
MSTAGE_LANDING = 1
MSTAGE_COMPLETE = 2


class OrchardEnvParams(NamedTuple):
    base: env_mod.EnvParams
    scene: orch.OrchardParams
    render_cfg: raycast.RenderConfig
    planner: rappids.PlannerParams
    waypoints: torch.Tensor  # (MAX_WAYPOINTS, 3) world-frame goals
    num_waypoints: torch.Tensor  # int32
    takeoff_height: torch.Tensor
    start_flight_step: torch.Tensor  # int32 sim step when planning begins
    steps_per_frame: int
    n_candidates: int
    pyramid_capacity: int
    planner_rounds: int
    inflation_downsample: int  # pooled pyramid inflation factor
    track_lookahead: torch.Tensor  # 0.04 s (main.cpp:571)
    land: bool  # descend + settle after the last waypoint
    fused_ticks: bool  # run the tick block as one kernel (sim/cuda_frame.py)
    mesh: Optional[MeshScene] = None  # an imported world rendered in place of the
    # procedural orchard (render/meshscene.py); None: the procedural orchard


class PlannedTraj(NamedTuple):
    """The currently tracked camera-frame trajectory + world transform."""

    planned: torch.Tensor  # bool
    alpha: torch.Tensor  # (3,)
    beta: torch.Tensor
    gamma: torch.Tensor
    a0: torch.Tensor
    v0: torch.Tensor
    p0: torch.Tensor
    tf: torch.Tensor
    att: torch.Tensor  # (4,) trajAtt = estAtt * camAtt
    offset: torch.Tensor  # (3,) estPos at plan time
    start_step: torch.Tensor  # int32 sim step of trajectory reset
    grav_cam: torch.Tensor  # (3,) gravity at plan time


class OrchardEnvState(NamedTuple):
    base: env_mod.EnvState
    planned: PlannedTraj
    plan_count: torch.Tensor  # int32 successful plans
    frame_count: torch.Tensor  # int32
    waypoint_idx: torch.Tensor  # int32
    mstage: torch.Tensor  # int32 MSTAGE_*
    land_pos: torch.Tensor  # (3,) est position at landing entry
    land_start_step: torch.Tensor  # int32


def make_params(goal_world=(120.0, 0.0, 3.5), takeoff_height=3.5, start_flight_time=5.0,
                steps_per_frame=16, n_candidates=256, pyramid_capacity=32,
                planner_rounds=2, inflation_downsample=2, width=640, height=480,
                seed=0, noise_scale=1.0, waypoints=None, land=False,
                fused_ticks=True, mesh_scene=None, device="cuda") -> OrchardEnvParams:
    """The JAX package's defaults; `waypoints` are flown in order with the
    reference's 1 m switching radius, defaulting to `goal_world`.
    fused_ticks=False runs the tick block as plain torch ops. mesh_scene:
    an imported world (`render/meshscene.py`: an OBJ or primitives file, or
    a baked orchard), moved to `device`, rendered instead of the
    procedural orchard. The tensors are built on the card unless `device`
    names another; with no card, the default raises instead of building on
    the CPU."""
    device = card_or_raise(device, "orchard_env.make_params")
    base = env_mod.make_params(noise_scale=noise_scale, device=device)
    cam = rappids.make_camera(width, height, focal=width / 2.0, depth_scale=10.0 / 256.0,
                              device=device)
    v = qconst.vehicle_params(qconst.QC_TYPE_CF_MINIQUAD)
    planner = rappids.make_params(cam, true_radius=2 * v.arm_length,
                                  plan_radius=3 * v.arm_length, min_check_dist=0.5)
    wps = np.asarray((tuple(goal_world),) if waypoints is None else waypoints, np.float32)
    if len(wps) > MAX_WAYPOINTS:
        raise ValueError(f"{len(wps)} waypoints > {MAX_WAYPOINTS}")
    wp = np.zeros((MAX_WAYPOINTS, 3), np.float32)
    wp[:len(wps)] = wps
    if mesh_scene is not None:
        leaves, rebuild = flatten_tensors(mesh_scene)
        mesh_scene = rebuild([t.to(device) for t in leaves])
    return OrchardEnvParams(
        base=base, scene=orch.make_params(seed=seed, device=device),
        render_cfg=raycast.make_config(width, height, far=10.0, dda_steps=8),
        planner=planner,
        waypoints=torch.tensor(wp, device=device),
        num_waypoints=torch.tensor(len(wps), dtype=torch.int32, device=device),
        takeoff_height=torch.tensor(takeoff_height, dtype=torch.float32, device=device),
        start_flight_step=torch.tensor(round(start_flight_time * 500), dtype=torch.int32,
                                       device=device),
        steps_per_frame=int(steps_per_frame), n_candidates=int(n_candidates),
        pyramid_capacity=int(pyramid_capacity), planner_rounds=int(planner_rounds),
        inflation_downsample=int(inflation_downsample),
        track_lookahead=torch.tensor(0.04, dtype=torch.float32, device=device),
        land=bool(land), fused_ticks=bool(fused_ticks), mesh=mesh_scene,
    )


def _null_planned(device) -> PlannedTraj:
    z3 = torch.zeros(3, dtype=torch.float32, device=device)
    return PlannedTraj(
        planned=torch.zeros((), dtype=torch.bool, device=device), alpha=z3, beta=z3,
        gamma=z3, a0=z3, v0=z3, p0=z3, tf=torch.ones((), device=device),
        att=rot.identity(device).clone(), offset=z3,
        start_step=torch.zeros((), dtype=torch.int32, device=device), grav_cam=z3)


def init_state(params: OrchardEnvParams, pos=(0.0, 0.0, 0.0)) -> OrchardEnvState:
    dev = params.waypoints.device
    i0 = torch.zeros((), dtype=torch.int32, device=dev)
    return OrchardEnvState(
        base=env_mod.init_state(params.base, pos=pos), planned=_null_planned(dev),
        plan_count=i0, frame_count=i0, waypoint_idx=i0, mstage=i0 + MSTAGE_CRUISE,
        land_pos=torch.zeros(3, dtype=torch.float32, device=dev), land_start_step=i0)


def _planned_as_traj(p: PlannedTraj) -> traj_mod.Traj:
    return traj_mod.Traj(alpha=p.alpha, beta=p.beta, gamma=p.gamma, a0=p.a0, v0=p.v0,
                         p0=p.p0, tf=p.tf, cost=torch.zeros_like(p.tf))


def _tracking_refs(params: OrchardEnvParams, pl: PlannedTraj, step):
    """Receding-horizon reference state at sim step (main.cpp:560-605)."""
    tr = _planned_as_traj(pl)
    t = (step - pl.start_step).to(torch.float32) * (
        params.base.dt_us.to(torch.float32) * 1e-6)
    running = t < pl.tf
    t_eval = torch.where(running, torch.minimum(t + params.track_lookahead, pl.tf), pl.tf)

    zero3 = torch.zeros_like(pl.alpha)
    pos_c = traj_mod.position(tr, t_eval)
    vel_c = torch.where(running, traj_mod.velocity(tr, t_eval), zero3)
    acc_c = torch.where(running, traj_mod.acceleration(tr, t_eval), zero3)

    # disallow going backwards through the camera plane (main.cpp:578-597)
    ez = const((False, False, True), step.device, torch.bool)
    z_neg = pos_c[2] < 0
    pos_c = torch.where(ez & z_neg, zero3, pos_c)
    vel_c = torch.where(ez & (z_neg & (vel_c[2] < 0)), zero3, vel_c)
    acc_c = torch.where(ez & (z_neg & (acc_c[2] < 0)), zero3, acc_c)

    R = rot.to_matrix(pl.att)
    t_thr = torch.minimum(torch.clamp(t, min=0.0), pl.tf)
    ref_thrust = traj_mod.thrust(tr, t_thr, pl.grav_cam)
    omega_cam = traj_mod.omega(tr, torch.minimum(t_thr, pl.tf - 0.02), 0.02, pl.grav_cam)
    return (lin3.mv3(R, pos_c) + pl.offset, lin3.mv3(R, vel_c), lin3.mv3(R, acc_c),
            ref_thrust, lin3.mv3(R, omega_cam))


def _sim_tick(params: OrchardEnvParams, s: OrchardEnvState, noise) -> OrchardEnvState:
    """One 2 ms tick with tracking/takeoff offboard control. noise: (2, 3)
    unit normals (gyro, acc) for this tick's IMU."""
    base = s.base
    p = params.base
    dev = base.step.device
    zero3 = const((0.0, 0.0, 0.0), dev)  # no wind
    half = env_mod.physics_tick(base, p, zero3, zero3, True, noise=noise)
    est_pos, est_vel, est_att, _ = half["est"]

    # offboard loop cadence
    acc_us = base.offboard_acc_us + p.dt_us
    fire = acc_us > p.offboard_period_us
    acc_us = torch.where(fire, acc_us - p.offboard_period_us, acc_us)
    in_flight = base.step >= params.start_flight_step

    # takeoff / no-plan hover target
    zero = torch.zeros_like(params.takeoff_height)
    hover_pos = torch.where(in_flight, const((0.0, 0.0, 2.0), dev),
                            torch.stack([zero, zero, params.takeoff_height]))

    # landing descent target (0.5 m/s with a blend-in)
    landing = s.mstage == MSTAGE_LANDING
    t_land = torch.clamp(base.step - s.land_start_step, min=0).to(torch.float32) * (
        p.dt_us.to(torch.float32) * 1e-6)
    frac_ld = torch.clamp(t_land / LANDING_BLEND_TIME, 0.0, 1.0)
    descend = const((0.0, 0.0, -LANDING_SPEED), dev)
    pos_land = s.land_pos + frac_ld * t_land * descend
    not_cruise = landing | (s.mstage == MSTAGE_COMPLETE)
    hover_pos = torch.where(not_cruise, pos_land, hover_pos)
    hover_vel = torch.where(not_cruise, frac_ld * descend, torch.zeros_like(descend))
    angvel_hover, thrust_hover = offboard_ctrl.run(
        p.ctrl, est_pos, est_vel, est_att, hover_pos, hover_vel)

    # touchdown -> complete (motors idled below)
    mstage = torch.where(landing & (pos_land[2] < 0.0), MSTAGE_COMPLETE, s.mstage)

    # tracking control
    ref_pos, ref_vel, ref_acc, ref_thrust, ref_angvel_w = _tracking_refs(
        params, s.planned, base.step)
    angvel_track, thrust_track = offboard_ctrl.run_tracking(
        p.ctrl, est_pos, est_vel, est_att, ref_pos, ref_vel, ref_acc, ref_thrust,
        rot.rotate_back(est_att, ref_angvel_w))

    track = in_flight & s.planned.planned & (mstage == MSTAGE_CRUISE)
    cmd_angvel = torch.where(track, angvel_track, angvel_hover)
    cmd_thrust = torch.where(track, thrust_track, thrust_hover)

    rtype, rflags, rfields = radio.make_rates_command(cmd_thrust, cmd_angvel)
    itype, iflags, ifields = radio.make_idle_command(dev)
    idle = mstage == MSTAGE_COMPLETE
    ring = delayline.push(half["ring"], torch.where(idle, itype, rtype),
                          torch.where(idle, iflags, rflags), torch.where(idle, ifields, rfields),
                          base.step, fire)

    # latency-compensation feedback into the estimator pipe
    pred_acc = (rot.rotate(est_att, const((0.0, 0.0, 1.0), dev)) * cmd_thrust
                + const(GRAV_W, dev))
    mocap = estimators.mocap_set_predicted_values(
        half["mocap"], half["now_us"], p.est_latency_us, cmd_angvel, pred_acc, fire)

    new_base = env_mod.EnvState(
        plant=half["plant"], logic=half["logic"], ring=ring, offboard_acc_us=acc_us,
        step=base.step + 1,
        last_cmd_thrust=torch.where(fire, cmd_thrust, base.last_cmd_thrust),
        last_cmd_angvel=torch.where(fire, cmd_angvel, base.last_cmd_angvel),
        mocap=mocap, mocap_acc_us=half["mocap_acc_us"], gpsimu=half["gpsimu"],
        gps_acc_us=half["gps_acc_us"])
    return s._replace(base=new_base, mstage=mstage)


def frame_ticks_plain(params: OrchardEnvParams, s: OrchardEnvState,
                      noise) -> OrchardEnvState:
    """The physics/tracking ticks of one frame as plain torch ops (the
    counterpart of the JAX package's `frame_ticks_jnp`); noise: (ticks, 2, 3)."""
    frame_ticks_plain.calls += 1
    for i in range(noise.shape[0]):
        s = _sim_tick(params, s, noise[i])
    return s


frame_ticks_plain.calls = 0  # calls since the last reset


def frame_ticks_plain_fleet(params: OrchardEnvParams, s: OrchardEnvState,
                            noise) -> OrchardEnvState:
    """`frame_ticks_plain` for each vehicle of a fleet, stacked: the
    reference for the fleet's tick kernel. noise: (B, ticks, 2, 3)."""
    leaves, rebuild = flatten_tensors(s)
    return stack_states([frame_ticks_plain(params, rebuild([t[b] for t in leaves]), noise[b])
                         for b in range(noise.shape[0])])


def stack_states(states) -> OrchardEnvState:
    """One fleet state from single-vehicle states: row b is states[b]."""
    flat = [flatten_tensors(s) for s in states]
    return flat[0][1]([torch.stack(col) for col in zip(*(leaves for leaves, _ in flat))])


def frame_ticks(params: OrchardEnvParams, s: OrchardEnvState, noise) -> OrchardEnvState:
    """Tick-block dispatch for one vehicle (noise (ticks, 2, 3)) or a fleet
    (noise (B, ticks, 2, 3)): the fused kernel when `params.fused_ticks`
    (`sim/cuda_frame.frame_ticks`, which takes the plain ticks on CPU
    tensors), else the plain ticks."""
    if params.fused_ticks:
        from agrifly_tpu_torch.sim import cuda_frame

        return cuda_frame.frame_ticks(params, s, noise)
    if noise.dim() == 4:
        return frame_ticks_plain_fleet(params, s, noise)
    return frame_ticks_plain(params, s, noise)


def _where(mask, a, b):
    """torch.where with a mask of the state's leading (vehicle) shape,
    broadcast over the leaf's own trailing axes."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim())), a, b)


def _waypoint(params: OrchardEnvParams, idx):
    """The waypoints at idx (any leading shape), gathered on the device: a
    0-d index tensor in [] would be read back to the host."""
    return params.waypoints.index_select(0, idx.reshape(-1).long()).reshape(idx.shape + (3,))


def _frame_percept(params: OrchardEnvParams, s: OrchardEnvState, u):
    """Render -> plan -> mission bookkeeping (everything before the ticks).

    Every state leaf carries the same leading vehicle shape L: () for one
    vehicle, (B,) for a fleet. u: the planner's (*L, 4, n_candidates)
    uniform block. Returns (state, plan_info)."""
    base = s.base
    p = params.base
    dev = base.step.device
    lead = base.step.shape

    # the estimator's view, which the planner gets (main.cpp:469,489-495)
    est_pos, est_vel, est_att, _ = estimators.mocap_get_prediction(
        base.mocap, base.step * p.dt_us, p.est_latency_us)
    est_att_n = rot.qnormalize(est_att)

    # 1. render depth frames from the *true* poses, all vehicles in one call:
    # the imported world when there is one, else the procedural orchard
    cam_att = raycast.camera_attitude(base.plant.att).reshape(-1, 4)
    cfg = params.render_cfg
    pos = base.plant.pos.reshape(-1, 3)
    if params.mesh is not None:
        depth = cuda_meshscene.render_depth_batch(cfg, params.mesh, pos, cam_att)
    else:
        depth = cuda_raycast.render_depth_batch(cfg, params.scene, pos, cam_att)
    depth = depth.reshape(lead + (cfg.height, cfg.width))

    # 2. plan in the camera frame (main.cpp:484-508)
    cam_att_est = raycast.camera_attitude(est_att_n)
    R_wc = rot.to_matrix(cam_att_est)  # world-from-camera
    grav = const(GRAV_W, dev)
    vel_cam = lin3.mv3t(R_wc, est_vel)
    acc_cam = lin3.mv3t(R_wc, rot.rotate(est_att_n, const((0.0, 0.0, 1.0), dev))
                        * base.last_cmd_thrust[..., None] + grav)
    grav_cam = lin3.mv3t(R_wc, grav)

    # waypoint switching at the reference's 1 m radius; after the last
    # waypoint, optionally enter the landing descent
    in_flight = base.step >= params.start_flight_step
    goal_world = _waypoint(params, s.waypoint_idx)
    at_wp = (in_flight & (s.mstage == MSTAGE_CRUISE)
             & (norm3(goal_world - est_pos) < WAYPOINT_RADIUS))
    has_next = s.waypoint_idx + 1 < params.num_waypoints
    waypoint_idx = torch.where(at_wp & has_next, s.waypoint_idx + 1, s.waypoint_idx)
    mstage, land_pos, land_start_step = s.mstage, s.land_pos, s.land_start_step
    if params.land:
        enter_land = at_wp & ~has_next
        mstage = torch.where(enter_land, MSTAGE_LANDING, mstage)
        land_pos = _where(enter_land, est_pos, land_pos)
        land_start_step = torch.where(enter_land, base.step, land_start_step)
    goal_world = _waypoint(params, waypoint_idx)
    goal_cam = lin3.mv3t(R_wc, goal_world - est_pos)

    res = rappids.plan(params.planner, depth, u, vel_cam, acc_cam, grav_cam, goal_cam,
                       pyramid_capacity=params.pyramid_capacity,
                       rounds=params.planner_rounds,
                       inflation_downsample=params.inflation_downsample)

    adopt = res.found & in_flight & (mstage == MSTAGE_CRUISE)
    old = s.planned
    pick = lambda new, prev: _where(adopt, new, prev)  # noqa: E731
    planned = PlannedTraj(
        planned=old.planned | adopt, alpha=pick(res.traj.alpha, old.alpha),
        beta=pick(res.traj.beta, old.beta), gamma=pick(res.traj.gamma, old.gamma),
        a0=pick(res.traj.a0, old.a0), v0=pick(res.traj.v0, old.v0),
        p0=pick(res.traj.p0, old.p0), tf=pick(res.traj.tf, old.tf),
        att=pick(cam_att_est, old.att), offset=pick(est_pos, old.offset),
        start_step=pick(base.step, old.start_step), grav_cam=pick(grav_cam, old.grav_cam))

    s = s._replace(planned=planned, plan_count=s.plan_count + adopt.to(torch.int32),
                   frame_count=s.frame_count + 1, waypoint_idx=waypoint_idx,
                   mstage=mstage, land_pos=land_pos, land_start_step=land_start_step)
    plan_info = dict(
        plan_found=res.found, num_collision_free=res.num_collision_free,
        num_pyramids=res.num_pyramids, best_cost=res.best_cost,
        num_feasible=res.num_feasible, num_velocity_admissible=res.num_velocity_admissible,
        plan_vel_cam=vel_cam, plan_acc_cam=acc_cam, plan_grav_cam=grav_cam,
        goal_world=goal_world)
    return s, plan_info


def draw(params: OrchardEnvParams, gen: torch.Generator, device):
    """One frame's random draws from gen: the planner's (4, N) uniform block
    and the (steps_per_frame, 2, 3) IMU unit normals."""
    u = torch.rand((4, params.n_candidates), generator=gen, device=device)
    noise = torch.randn((params.steps_per_frame, 2, 3), generator=gen, device=device)
    return u, noise


def draw_fleet(params: OrchardEnvParams, gen: torch.Generator, B: int, device):
    """One fleet frame's random draws from gen: u (B, 4, N) and noise
    (B, steps_per_frame, 2, 3)."""
    u = torch.rand((B, 4, params.n_candidates), generator=gen, device=device)
    noise = torch.randn((B, params.steps_per_frame, 2, 3), generator=gen, device=device)
    return u, noise


def frame_step(params: OrchardEnvParams, s: OrchardEnvState, gen=None, draws=None):
    """One 33 ms frame: render -> plan -> steps_per_frame tracked ticks.

    draws: optional (u, noise); otherwise both come from `gen` (a
    torch.Generator on the state's device). Returns (state, outputs dict)."""
    u, noise = draws if draws is not None else draw(params, gen, s.base.step.device)
    s, plan_info = _frame_percept(params, s, u)
    s = frame_ticks(params, s, noise)
    return s, _frame_outputs(s, plan_info)


def _frame_outputs(s: OrchardEnvState, plan_info: dict) -> dict:
    plant = s.base.plant
    return dict(pos=plant.pos, vel=plant.vel, att=plant.att, flight_state=s.base.logic.fs,
                panic=s.base.logic.panic_reason, **plan_info)


def frame_step_fleet(params: OrchardEnvParams, s: OrchardEnvState, gen=None, draws=None):
    """One frame of a B-vehicle fleet (a leading B axis on every state
    leaf; see `init_state_fleet`). draws: optional (u (B, 4, N), noise
    (B, ticks, 2, 3)), else drawn from `gen`. Returns (state, outputs dict,
    each output with a leading B)."""
    if draws is None:
        draws = draw_fleet(params, gen, s.base.step.shape[0], s.base.step.device)
    return frame_step(params, s, draws=draws)


def init_state_fleet(params: OrchardEnvParams, positions) -> OrchardEnvState:
    """The state of a fleet spawned at positions (B, 3): row b is
    `init_state(params, pos=positions[b])`."""
    pos = torch.as_tensor(positions, dtype=torch.float32, device=params.waypoints.device)
    if pos.dim() != 2 or pos.shape[1] != 3:
        raise ValueError(f"need (B, 3) positions, got {tuple(pos.shape)}")
    leaves, rebuild = flatten_tensors(init_state(params))
    s = rebuild([t.expand((pos.shape[0],) + t.shape).clone() for t in leaves])
    return s._replace(base=s.base._replace(plant=s.base.plant._replace(pos=pos.clone())))


def _stack(items):
    """Per-frame outputs stacked along a new leading axis (a NamedTuple
    field by field)."""
    if isinstance(items[0], tuple):
        return type(items[0])(*(_stack([it[i] for it in items]) for i in range(len(items[0]))))
    return torch.stack(items)


def _fly(step, params, s, n_frames, gen):
    outs = []
    for _ in range(n_frames):
        s, out = step(params, s, gen)
        outs.append(out)
    return s, {k: _stack([o[k] for o in outs]) for k in outs[0]}


def fly(params: OrchardEnvParams, s: OrchardEnvState, n_frames: int, gen: torch.Generator):
    """n_frames of frame_step. Returns (state, outputs stacked per frame)."""
    return _fly(frame_step, params, s, n_frames, gen)


def fly_fleet(params: OrchardEnvParams, s: OrchardEnvState, n_frames: int,
              gen: torch.Generator):
    """n_frames of frame_step_fleet. Returns (state, outputs stacked
    (frames, B, ...))."""
    return _fly(frame_step_fleet, params, s, n_frames, gen)


def _diag_extras(params: OrchardEnvParams, s: OrchardEnvState) -> dict:
    """A frame's extras for a topic bridge: what it publishes beyond
    `_frame_outputs`. The planned-trajectory subtree; the sources of the
    telemetry packets (the LogicState fields io/telemetry.encode_from_logic
    reads), so that the wire can be quantized from host rows; the
    controller snapshot (the mocap prediction and the tracking references,
    ExampleVehicleStateMachine.cpp:666-696); and the last command sent.
    One vehicle."""
    p = params.base
    now_us = s.base.step * p.dt_us
    est_pos, est_vel, est_att, _ = estimators.mocap_get_prediction(
        s.base.mocap, now_us, p.est_latency_us)
    ref_pos, ref_vel, ref_acc, ref_thrust, ref_angvel_w = _tracking_refs(
        params, s.planned, s.base.step)
    lg = s.base.logic
    return dict(
        step=s.base.step, planned=s.planned, plan_count=s.plan_count,
        mstage=s.mstage, waypoint_idx=s.waypoint_idx,
        tel_acc=filters.lp2_value(lg.acc_lp), tel_gyro=filters.lp2_value(lg.gyro_lp),
        tel_motor_forces=lg.des_motor_forces,
        tel_kf_pos=lg.kf.pos, tel_kf_vel=lg.kf.vel, tel_kf_att=lg.kf.att,
        tel_batt=lg.batt_voltage, tel_debug=lg.debug, tel_warnings=lg.warnings,
        est_pos=est_pos, est_vel=est_vel, est_att=est_att,
        ref_pos=ref_pos, ref_vel=ref_vel, ref_acc=ref_acc, ref_thrust=ref_thrust,
        ref_angvel_b=rot.rotate_back(est_att, ref_angvel_w),
        last_cmd_thrust=s.base.last_cmd_thrust, last_cmd_angvel=s.base.last_cmd_angvel)


def fly_diag(params: OrchardEnvParams, s: OrchardEnvState, n_frames: int, gen=None, draws=None):
    """fly() with a topic bridge's outputs: each frame's row holds
    `_frame_outputs` and `_diag_extras`, so that a bridge can fly a block of
    frames in one call and publish every frame from the stacked rows. One
    vehicle. draws: optional (u (n_frames, 4, N), noise (n_frames, ticks, 2,
    3)), frame i taking (u[i], noise[i]); otherwise each frame draws from
    `gen`. Returns (state, outputs stacked per frame)."""
    outs = []
    for i in range(n_frames):
        s, out = frame_step(params, s, gen, None if draws is None else (draws[0][i], draws[1][i]))
        outs.append(dict(out, **_diag_extras(params, s)))
    return s, {k: _stack([o[k] for o in outs]) for k in outs[0]}


class OrchardEnv(torch.nn.Module):
    """The orchard environment as a module: its parameters are buffers, so
    `.to(device)` moves them; `frame_step` and `fly` (one vehicle) and
    `frame_step_fleet` and `fly_fleet` (a fleet) take a state and a
    torch.Generator on that device."""

    def __init__(self, params: OrchardEnvParams):
        super().__init__()
        leaves, self._rebuild = flatten_tensors(params)
        for i, leaf in enumerate(leaves):
            self.register_buffer(f"p{i}", leaf)
        self._n = len(leaves)

    @property
    def params(self) -> OrchardEnvParams:
        return self._rebuild([getattr(self, f"p{i}") for i in range(self._n)])

    def init_state(self, pos=(0.0, 0.0, 0.0)) -> OrchardEnvState:
        return init_state(self.params, pos)

    def init_state_fleet(self, positions) -> OrchardEnvState:
        return init_state_fleet(self.params, positions)

    def frame_step(self, state, gen=None, draws=None):
        return frame_step(self.params, state, gen, draws)

    def frame_step_fleet(self, state, gen=None, draws=None):
        return frame_step_fleet(self.params, state, gen, draws)

    def fly(self, state, n_frames: int, gen: torch.Generator):
        return fly(self.params, state, n_frames, gen)

    def fly_fleet(self, state, n_frames: int, gen: torch.Generator):
        return fly_fleet(self.params, state, n_frames, gen)

    def fly_diag(self, state, n_frames: int, gen=None, draws=None):
        return fly_diag(self.params, state, n_frames, gen, draws)
