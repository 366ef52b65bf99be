"""Mission flight-stage state machine (host-level autonomy).

Port of `agrifly_tpu/sim/mission.py` (the RAPPIDS node's
ExampleVehicleStateMachine): WaitForStart -> SpoolUp (0.5 s at 25% hover
thrust) -> Takeoff (2 s position blend) -> Hover (3 s) -> Flight (RAPPIDS
tracking and waypoint switching at 1 m) -> Landing (0.5 m/s descent with a
2 s blend) -> Complete (idle); a SafetyNet violation jumps to Emergency
(kill). The waypoints are a fixed (MAX_WAYPOINTS, 3) table standing in for
trajectory.txt (`load_trajectory_file` reads that format).

Each call produces the radio command of one offboard tick; the stage,
timers and waypoint index live in `MissionState`. The constants are shared
with `sim/orchard_env.py`, whose mission profile uses them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from agrifly_tpu_torch import card_or_raise
from agrifly_tpu_torch.io import radio
from agrifly_tpu_torch.offboard import controller as offboard_ctrl
from agrifly_tpu_torch.ops.fmath import const, norm3

STAGE_WAIT_FOR_START = 0
STAGE_SPOOL_UP = 1
STAGE_TAKEOFF = 2
STAGE_HOVER = 3
STAGE_FLIGHT = 4
STAGE_LANDING = 5
STAGE_COMPLETE = 6
STAGE_EMERGENCY = 7

STAGE_NAMES = {
    STAGE_WAIT_FOR_START: "WaitForStart",
    STAGE_SPOOL_UP: "SpoolUp",
    STAGE_TAKEOFF: "Takeoff",
    STAGE_HOVER: "Hover",
    STAGE_FLIGHT: "Flight",
    STAGE_LANDING: "Landing",
    STAGE_COMPLETE: "Complete",
    STAGE_EMERGENCY: "Emergency",
}

SPOOL_UP_TIME = 0.5  # [s]
SPOOL_UP_THRUST_FRAC = 0.25
TAKEOFF_TIME = 2.0  # [s]
HOVER_TIME = 3.0  # [s]
LANDING_SPEED = 0.5  # [m/s]
LANDING_BLEND_TIME = 2.0  # [s]
COMPLETE_EXIT_TIME = 1.0  # [s]
WAYPOINT_RADIUS = 1.0  # [m]

MAX_WAYPOINTS = 16


class MissionParams(NamedTuple):
    desired_position: torch.Tensor  # (3,) hover / takeoff target
    waypoints: torch.Tensor  # (MAX_WAYPOINTS, 3)
    num_waypoints: torch.Tensor  # int32


class MissionState(NamedTuple):
    stage: torch.Tensor  # int32
    last_stage: torch.Tensor  # int32 (for stage-change detection)
    stage_start_us: torch.Tensor  # int32
    init_position: torch.Tensor  # (3,) recorded at takeoff entry
    last_pos: torch.Tensor  # (3,) recorded at landing entry
    last_vel: torch.Tensor  # (3,)
    waypoint_idx: torch.Tensor  # int32
    goal_world: torch.Tensor  # (3,) current waypoint
    start_plan: torch.Tensor  # bool: RAPPIDS may run
    ready_to_exit: torch.Tensor  # bool


class MissionCommand(NamedTuple):
    """The radio command and tracking request of this tick."""

    msg_type: torch.Tensor
    msg_flags: torch.Tensor
    msg_fields: torch.Tensor  # (10,)
    use_tracking: torch.Tensor  # bool: the caller should use the tracking references


def load_trajectory_file(path):
    """Parse a waypoint file in the reference's trajectory.txt format: one
    "x,y,z" per line; blank lines and '#' comments are skipped. Returns a
    list of 3-tuples."""
    waypoints = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split(",")
            if len(parts) < 3:
                raise ValueError(f"{path}:{lineno}: expected 'x,y,z', got {line!r}")
            waypoints.append(tuple(float(p) for p in parts[:3]))
    if not waypoints:
        raise ValueError(f"{path}: no waypoints found")
    if len(waypoints) > MAX_WAYPOINTS:
        raise ValueError(f"{path}: {len(waypoints)} waypoints > MAX_WAYPOINTS={MAX_WAYPOINTS}")
    return waypoints


def make_params(desired_position=(0.0, 0.0, 2.0), waypoints=((20.0, 0.0, 2.5),),
                device="cuda") -> MissionParams:
    """On the card unless `device` names another (with no card the default
    raises)."""
    device = card_or_raise(device, "mission.make_params")
    wp = np.zeros((MAX_WAYPOINTS, 3), np.float32)
    wps = np.asarray(waypoints, np.float32)
    wp[: len(wps)] = wps
    return MissionParams(
        desired_position=torch.tensor(desired_position, dtype=torch.float32, device=device),
        waypoints=torch.from_numpy(wp).to(device),
        num_waypoints=torch.tensor(len(wps), dtype=torch.int32, device=device))


def init_state(params: MissionParams) -> MissionState:
    dev = params.waypoints.device
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    z3 = torch.zeros(3, dtype=torch.float32, device=dev)
    f = torch.zeros((), dtype=torch.bool, device=dev)
    return MissionState(stage=i32(STAGE_WAIT_FOR_START), last_stage=i32(STAGE_COMPLETE),
                        stage_start_us=i32(0), init_position=z3, last_pos=z3, last_vel=z3,
                        waypoint_idx=i32(0), goal_world=params.waypoints[0].clone(),
                        start_plan=f, ready_to_exit=f)


def step(params: MissionParams, ctrl: offboard_ctrl.OffboardCtrlParams, s: MissionState,
         now_us, est_pos, est_vel, est_att, tracking_ready, track_refs, is_safe, low_battery,
         should_start=True, should_stop=False):
    """One offboard tick of the mission state machine. track_refs: (ref_pos,
    ref_vel, ref_acc, ref_thrust, ref_angvel_body) of the planned RAPPIDS
    trajectory (used in the Flight stage). Returns (new_state,
    MissionCommand)."""
    dev = est_pos.device
    now_us = torch.as_tensor(now_us, dtype=torch.int32, device=dev)
    stage = s.stage
    entered = stage != s.last_stage
    stage_start = torch.where(entered, now_us, s.stage_start_us)
    stage_t = (now_us - stage_start).to(torch.float32) * 1e-6

    # stage-entry latches
    init_position = torch.where(entered & (stage == STAGE_TAKEOFF), est_pos, s.init_position)
    landing_entry = entered & (stage == STAGE_LANDING)
    last_pos = torch.where(landing_entry, est_pos, s.last_pos)
    last_vel = torch.where(landing_entry, est_vel, s.last_vel)

    # the stages' position-control targets: the takeoff blend, the landing
    # descent with its initial blend
    frac_to = torch.clamp(stage_t / TAKEOFF_TIME, 0.0, 1.0)
    pos_takeoff = (1.0 - frac_to) * init_position + frac_to * params.desired_position
    frac_ld = torch.clamp(stage_t / LANDING_BLEND_TIME, 0.0, 1.0)
    descend = const((0.0, 0.0, -LANDING_SPEED), dev)
    pos_land_raw = last_pos + stage_t * descend
    pos_land = (1.0 - frac_ld) * last_pos + frac_ld * pos_land_raw
    vel_land = (1.0 - frac_ld) * last_vel + frac_ld * descend

    pos_target = torch.where(stage == STAGE_TAKEOFF, pos_takeoff, params.desired_position)
    pos_target = torch.where(stage == STAGE_LANDING, pos_land, pos_target)
    vel_target = torch.where(stage == STAGE_LANDING, vel_land,
                             torch.zeros(3, dtype=torch.float32, device=dev))
    cmd_angvel_pc, cmd_thrust_pc = offboard_ctrl.run(ctrl, est_pos, est_vel, est_att,
                                                     pos_target, vel_target)

    # the tracking command (Flight with a planned trajectory)
    ref_pos, ref_vel, ref_acc, ref_thrust, ref_angvel_body = track_refs
    cmd_angvel_tr, cmd_thrust_tr = offboard_ctrl.run_tracking(
        ctrl, est_pos, est_vel, est_att, ref_pos, ref_vel, ref_acc, ref_thrust, ref_angvel_body)
    use_tracking = (stage == STAGE_FLIGHT) & tracking_ready
    cmd_angvel = torch.where(use_tracking, cmd_angvel_tr, cmd_angvel_pc)
    cmd_thrust = torch.where(use_tracking, cmd_thrust_tr, cmd_thrust_pc)

    # the spool-up override
    in_spool = stage == STAGE_SPOOL_UP
    cmd_thrust = torch.where(in_spool, const(9.81 * SPOOL_UP_THRUST_FRAC, dev), cmd_thrust)
    cmd_angvel = torch.where(in_spool, torch.zeros_like(cmd_angvel), cmd_angvel)

    # the radio message
    rtype, rflags, rfields = radio.make_rates_command(cmd_thrust, cmd_angvel)
    itype, iflags, ifields = radio.make_idle_command(dev)
    ktype, kflags, kfields = radio.make_kill_command(dev)
    idle = (stage == STAGE_COMPLETE) | (stage == STAGE_WAIT_FOR_START)
    kill = stage == STAGE_EMERGENCY
    msg_type = torch.where(kill, ktype, torch.where(idle, itype, rtype))
    msg_flags = torch.where(kill, kflags, torch.where(idle, iflags, rflags))
    msg_fields = torch.where(kill, kfields, torch.where(idle, ifields, rfields))

    # waypoint switching (Flight stage)
    at_wp = (stage == STAGE_FLIGHT) & (norm3(s.goal_world - est_pos) < WAYPOINT_RADIUS)
    has_next = s.waypoint_idx + 1 < params.num_waypoints
    advance = at_wp & has_next
    waypoint_idx = torch.where(advance, s.waypoint_idx + 1, s.waypoint_idx)
    goal_world = torch.where(advance,
                             params.waypoints[torch.clamp(waypoint_idx, 0, MAX_WAYPOINTS - 1)],
                             s.goal_world)

    # transitions
    nxt = torch.where((stage == STAGE_WAIT_FOR_START) & should_start, STAGE_SPOOL_UP, stage)
    nxt = torch.where(in_spool & (stage_t > SPOOL_UP_TIME), STAGE_TAKEOFF, nxt)
    nxt = torch.where((stage == STAGE_TAKEOFF) & (frac_to >= 1.0), STAGE_HOVER, nxt)
    nxt = torch.where((stage == STAGE_HOVER) & (stage_t > HOVER_TIME), STAGE_FLIGHT, nxt)
    nxt = torch.where((stage == STAGE_FLIGHT) & should_stop, STAGE_LANDING, nxt)
    nxt = torch.where((stage == STAGE_FLIGHT) & at_wp & ~has_next, STAGE_LANDING, nxt)
    nxt = torch.where((stage == STAGE_LANDING) & (pos_land[..., 2] < 0.0), STAGE_COMPLETE, nxt)

    # low battery in an active stage -> landing; the safety net -> emergency
    # (spool-up through landing)
    active = ((stage == STAGE_SPOOL_UP) | (stage == STAGE_TAKEOFF) | (stage == STAGE_HOVER)
              | (stage == STAGE_FLIGHT))
    nxt = torch.where(active & low_battery, STAGE_LANDING, nxt)
    guarded = active | (stage == STAGE_LANDING)
    nxt = torch.where(guarded & ~is_safe, STAGE_EMERGENCY, nxt)

    start_plan = s.start_plan | ((stage == STAGE_HOVER) & (nxt == STAGE_FLIGHT))
    ready = s.ready_to_exit | ((stage == STAGE_COMPLETE) & (stage_t > COMPLETE_EXIT_TIME))
    new_state = MissionState(stage=nxt.to(torch.int32), last_stage=stage,
                             stage_start_us=stage_start, init_position=init_position,
                             last_pos=last_pos, last_vel=last_vel, waypoint_idx=waypoint_idx,
                             goal_world=goal_world, start_plan=start_plan, ready_to_exit=ready)
    return new_state, MissionCommand(msg_type=msg_type, msg_flags=msg_flags,
                                     msg_fields=msg_fields, use_tracking=use_tracking)
