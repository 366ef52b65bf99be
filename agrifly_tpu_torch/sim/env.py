"""Simulation environment: plant + onboard logic + radio channel + offboard
control, one 2 ms `step`, and the fleet rollouts.

Port of `agrifly_tpu/sim/env.py`. `step(params, state, cmd)` advances one
tick: radio delivery, the 6-DOF plant (with an external force and torque),
IMU fabrication, the UWB ranging network (with anchors, `with_uwb_anchors`),
the onboard logic, the offboard estimator (the true plant state,
`use_estimator=False` or `"true"`; the 200 Hz mocap estimator, `True` or
`"mocap"`; or the GPS-IMU estimator with a 100 Hz GPS fix, `"gpsimu"`)
and the 100 Hz offboard controller, whose command (`ctrl_mode` "rates",
"position" or "idle") enters the 30 ms radio delay line. With anchors and
"position" commands the vehicle flies the onboard-UWB configuration: its
EKF localises from the ranges. Periodic subsystems run on
integer-microsecond accumulators with the reference's `> period, then
subtract` rule. `rollout`, `rollout_fast` and `rollout_sampled` advance a
state, or a fleet of B states (a leading B on every leaf, as the JAX
package's `vmap` gives it), through many ticks: on CUDA tensors in one launch
of the hand-written kernel `csrc/rollout.cu` (`sim/cuda_rollout.py`), on CPU
tensors tick by tick in plain torch (`rollout_plain`, vmapped over a fleet).

Randomness: the port's `EnvState` has no PRNG key. `step` takes the tick's
IMU unit normals `noise` (2, 3) (gyro, then acc) and, with anchors, the UWB
network's four draws `uwb_draws` (4,) (`sim/uwb.py`); the rollouts take
pre-drawn (..., n_steps, 2, 3) and (..., n_steps, 4) blocks or a
`torch.Generator` that draws them on the state's device (the IMU noise
first).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from agrifly_tpu_torch import card_or_raise
from agrifly_tpu_torch.io import radio
from agrifly_tpu_torch.models import constants as qconst
from agrifly_tpu_torch.models import ekf
from agrifly_tpu_torch.models import logic as onboard
from agrifly_tpu_torch.models import plant as plant_mod
from agrifly_tpu_torch.offboard import controller as offboard_ctrl
from agrifly_tpu_torch.offboard import estimators
from agrifly_tpu_torch.ops import lin3
from agrifly_tpu_torch.ops import rotation as rot
from agrifly_tpu_torch.ops.fmath import const
from agrifly_tpu_torch.sim import delayline
from agrifly_tpu_torch.sim import uwb as uwb_mod

CTRL_MODES = ("rates", "position", "idle")
EST_MODES = ("true", "mocap", "gpsimu")  # use_estimator's modes; False / True name the first two
GPS_PERIOD_US = 10000  # the GPS fix's period (100 Hz)


class EnvParams(NamedTuple):
    plant: plant_mod.PlantParams
    logic: onboard.LogicParams
    ctrl: offboard_ctrl.OffboardCtrlParams
    dt_us: torch.Tensor  # int32, physics/onboard period (2000)
    offboard_period_us: torch.Tensor  # int32 (10000 = 100 Hz demo)
    radio_delay_us: torch.Tensor  # int32 (30000 demo)
    noise_scale: torch.Tensor  # f32: 1.0 = reference IMU noise, 0.0 = off
    mocap_period_us: torch.Tensor  # int32 (5000 = 200 Hz demo)
    est_latency_us: torch.Tensor  # int32: latency GetPrediction compensates
    uwb: Optional[uwb_mod.UwbParams] = None  # anchors for onboard navigation


class Command(NamedTuple):
    """Per-step external input: setpoint + disturbances. A fleet's command
    may carry a leading B on any leaf."""

    des_pos: torch.Tensor  # (3,)
    des_vel: torch.Tensor  # (3,)
    des_acc: torch.Tensor  # (3,)
    des_yaw: torch.Tensor  # 0-d
    ext_force: torch.Tensor  # (3,) world-frame wind force [N]
    ext_torque: torch.Tensor  # (3,) world-frame torque [N m]


class EnvState(NamedTuple):
    """The JAX package's EnvState without its PRNG keys (randomness comes
    from a torch.Generator or injected draws)."""

    plant: plant_mod.PlantState
    logic: onboard.LogicState
    ring: delayline.RadioRing
    offboard_acc_us: torch.Tensor  # int32 periodic accumulator
    step: torch.Tensor  # int32
    last_cmd_thrust: torch.Tensor  # f32 (previousThrust in the demo)
    last_cmd_angvel: torch.Tensor  # (3,)
    mocap: estimators.MocapEstState
    mocap_acc_us: torch.Tensor  # int32 periodic accumulator
    gpsimu: ekf.EkfState  # offboard GPS-IMU estimator
    gps_acc_us: torch.Tensor  # int32 periodic accumulator (100 Hz GPS)
    uwb: Optional[uwb_mod.UwbState] = None


class StepOutputs(NamedTuple):
    pos: torch.Tensor
    vel: torch.Tensor
    att: torch.Tensor
    angvel: torch.Tensor
    motor_speeds: torch.Tensor
    flight_state: torch.Tensor
    panic_reason: torch.Tensor
    warnings: torch.Tensor


def make_params(vehicle_type: int = qconst.QC_TYPE_CF_MINIQUAD, dt: float = 1.0 / 500.0,
                offboard_period: float = 1.0 / 100.0, radio_delay: float = 0.03,
                noise_scale: float = 1.0, mocap_period: float = 1.0 / 200.0,
                est_latency: float = 0.03, device="cuda") -> EnvParams:
    """The JAX package's defaults. The tensors are built on the card unless
    `device` names another; with no card, the default raises instead of
    building on the CPU."""
    device = card_or_raise(device, "env.make_params")
    v = qconst.vehicle_params(vehicle_type)
    i32 = lambda x: torch.tensor(round(x * 1e6), dtype=torch.int32, device=device)  # noqa: E731
    return EnvParams(
        plant=plant_mod.make_params(v, device),
        logic=onboard.make_params(v, onboard_period=dt, device=device),
        ctrl=offboard_ctrl.make_params(v, device=device),
        dt_us=i32(dt), offboard_period_us=i32(offboard_period),
        radio_delay_us=i32(radio_delay),
        noise_scale=torch.tensor(noise_scale, dtype=torch.float32, device=device),
        mocap_period_us=i32(mocap_period), est_latency_us=i32(est_latency),
    )


def with_uwb_anchors(params: EnvParams, anchor_ids, anchor_positions, vehicle_id=1,
                     comm_period=0.01, noise_std=0.0, outlier_prob=0.0, outlier_std=0.0,
                     failure_prob=0.0, max_range=math.inf) -> EnvParams:
    """UWB-based onboard navigation: the anchors go into the onboard
    logic's ranging-target table, and the network's radio table is the
    vehicle (row 0), then the anchors."""
    dev = params.dt_us.device
    logic_p = onboard.with_ranging_targets(params.logic, anchor_ids, anchor_positions)
    uwb_p = uwb_mod.make_params([vehicle_id] + list(anchor_ids), comm_period=comm_period,
                                noise_std=noise_std, outlier_prob=outlier_prob,
                                outlier_std=outlier_std, failure_prob=failure_prob,
                                max_range=max_range, device=dev)
    return params._replace(logic=logic_p, uwb=uwb_p)


def hover_command(des_pos=(0.0, 0.0, 1.5), device="cuda") -> Command:
    """Hold des_pos, no feed-forward, no yaw, no disturbance; on the card
    unless `device` names another."""
    device = card_or_raise(device, "env.hover_command")
    z3 = torch.zeros(3, dtype=torch.float32, device=device)
    return Command(des_pos=torch.tensor(des_pos, dtype=torch.float32, device=device),
                   des_vel=z3, des_acc=z3,
                   des_yaw=torch.zeros((), dtype=torch.float32, device=device),
                   ext_force=z3, ext_torque=z3)


def init_state(params: EnvParams, pos=(0.0, 0.0, 0.0)) -> EnvState:
    """One vehicle at rest at `pos`, on the parameters' device."""
    dev = params.dt_us.device
    i0 = torch.zeros((), dtype=torch.int32, device=dev)
    return EnvState(
        plant=plant_mod.init_state(pos, dev),
        logic=onboard.init_state(params.logic),
        ring=delayline.init(dev),
        offboard_acc_us=i0, step=i0,
        last_cmd_thrust=torch.zeros((), dtype=torch.float32, device=dev),
        last_cmd_angvel=torch.zeros(3, dtype=torch.float32, device=dev),
        mocap=estimators.mocap_init(dev), mocap_acc_us=i0,
        gpsimu=estimators.gpsimu_init(dev), gps_acc_us=i0,
        uwb=None if params.uwb is None else uwb_mod.init_state(dev),
    )


def _tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return type(tree)(*(_tree_map(fn, x) for x in tree))


def init_state_fleet(params: EnvParams, positions) -> EnvState:
    """B vehicles at rest at positions (B, 3): row b is `init_state(params,
    pos=positions[b])`."""
    pos = torch.as_tensor(positions, dtype=torch.float32, device=params.dt_us.device)
    if pos.dim() != 2 or pos.shape[1] != 3:
        raise ValueError(f"need (B, 3) positions, got {tuple(pos.shape)}")
    s = _tree_map(lambda t: t.expand((pos.shape[0],) + t.shape).clone(), init_state(params))
    return s._replace(plant=s.plant._replace(pos=pos.clone()))


def _est_mode(use_estimator):
    """The mode's name: False is "true", True is "mocap" (as in the JAX
    package); the names themselves are accepted too."""
    mode = ("mocap" if use_estimator else "true") if isinstance(use_estimator, bool) \
        else use_estimator
    if not isinstance(mode, str) or mode not in EST_MODES:
        raise ValueError(f"unknown use_estimator {use_estimator!r}")
    return mode


def _check_modes(use_estimator, ctrl_mode):
    if ctrl_mode not in CTRL_MODES:
        raise ValueError(f"unknown ctrl_mode {ctrl_mode!r}")
    return _est_mode(use_estimator)


def physics_phase_a(s: EnvState, params: EnvParams, ext_force, ext_torque, noise):
    """Radio delivery, plant integration and IMU fabrication for one tick.
    ext_force / ext_torque: (3,) world frame; noise: the tick's unit
    normals (gyro (3,), acc (3,))."""
    dt = params.dt_us.to(torch.float32) * 1e-6

    # radio delivery (pushed > delay ago becomes visible to the logic now)
    ring, delivered, mtype, mflags, mfields = delayline.pop_due(
        s.ring, s.step, params.dt_us, params.radio_delay_us)

    new_plant, acc_imu = plant_mod.step(params.plant, s.plant, s.logic.des_motor_speeds,
                                        ext_force, ext_torque, dt)

    gyro_meas, acc_meas = plant_mod.imu_measurements(params.plant, new_plant, acc_imu,
                                                     (noise[0], noise[1]))
    grav = const(plant_mod.GRAVITY, dt.device)
    gyro_true = lin3.mv3(params.plant.imu_rot_inv, new_plant.angvel)
    acc_true = lin3.mv3(params.plant.imu_rot_inv, rot.rotate_back(new_plant.att, acc_imu - grav))
    gyro_meas = gyro_true + (gyro_meas - gyro_true) * params.noise_scale
    acc_meas = acc_true + (acc_meas - acc_true) * params.noise_scale
    return dict(ring=ring, delivered=delivered, mtype=mtype, mflags=mflags, mfields=mfields,
                plant=new_plant, gyro_meas=gyro_meas, acc_meas=acc_meas)


def physics_tick(s: EnvState, params: EnvParams, ext_force, ext_torque, use_estimator,
                 uwb_override=None, phase_a=None, static_mocap_fire=None, static_gps_fire=None,
                 noise=None, uwb_draws=None):
    """Radio delivery, plant, IMU, UWB, onboard logic and the estimator
    update of one tick (the JAX package's steps 1-5a). use_estimator: False /
    "true" (the true state), True / "mocap" (the 200 Hz mocap estimator) or "gpsimu" (the
    GPS-IMU estimator: an IMU prediction every tick, a GPS fix every 10 ms).
    uwb_override: (new, range, responder_id, failure) from a network
    stepped outside, in place of the params' own; uwb_draws: the tick's four
    draws for the params' network. phase_a: a `physics_phase_a` result
    computed outside (a fleet moves every plant before its shared network
    steps), in place of computing it from `noise`. static_mocap_fire / static_gps_fire:
    python bools where the cadence is known in advance (rollout_fast), None
    for the accumulators' decisions; a statically silent offboard tick skips
    the prediction (and a silent GPS tick the fix). Returns a dict with the
    partial new state and the estimate `est` = (pos, vel, att, angvel)."""
    est_mode = _est_mode(use_estimator)
    if phase_a is None and noise is None:
        raise ValueError("physics_tick needs the tick's IMU noise (the port has no PRNG key)")
    a = phase_a if phase_a is not None else physics_phase_a(s, params, ext_force, ext_torque,
                                                            noise)
    new_plant = a["plant"]
    dev = new_plant.pos.device

    # the UWB ranging network, where anchors are configured; without one the
    # python False leaves the range update out of the logic's tick
    uwb_state = s.uwb
    uwb_in = {}
    if uwb_override is not None:
        uwb_in = dict(zip(("uwb_new", "uwb_range", "uwb_responder_id", "uwb_failure"),
                          uwb_override))
    elif params.uwb is not None:
        if uwb_draws is None:
            raise ValueError("physics_tick with anchors needs the tick's UWB draws (4,)")
        n_radios = params.uwb.radio_ids.shape[0]
        positions = torch.cat([new_plant.pos[None, :],
                               params.logic.target_positions[: n_radios - 1]], dim=0)
        my_target = torch.where(params.logic.num_targets > 0,
                                params.logic.target_ids[s.logic.next_target_idx],
                                torch.zeros_like(params.logic.num_targets))
        next_ids = torch.where(torch.arange(n_radios, device=dev) == 0, my_target,
                               torch.zeros_like(my_target))
        uwb_state, meas = uwb_mod.step(params.uwb, uwb_state, positions, next_ids,
                                       params.dt_us, uwb_draws)
        uwb_in = dict(uwb_new=meas.valid, uwb_range=meas.range,
                      uwb_responder_id=meas.responder_id, uwb_failure=meas.failure)

    # onboard logic tick (constant battery)
    inputs = onboard.null_inputs(dev)._replace(
        gyro=a["gyro_meas"], acc=a["acc_meas"], batt_voltage=params.logic.batt_critical * 1.2,
        radio_new=a["delivered"], radio_type=a["mtype"], radio_flags=a["mflags"],
        radio_fields=a["mfields"], **uwb_in)
    new_logic, _ = onboard.logic_step(params.logic, s.logic, inputs)

    now_us = (s.step + 1) * params.dt_us  # master time after this tick

    # estimator update streams; the accumulators of the other modes grow on
    mocap = s.mocap
    mocap_acc = s.mocap_acc_us + params.dt_us
    if est_mode == "mocap" and static_mocap_fire is not False:
        mocap_upd = estimators.mocap_update(mocap, now_us, new_plant.pos, new_plant.att,
                                            params.mocap_period_us)
        if static_mocap_fire is None:
            mfire = mocap_acc > params.mocap_period_us
            mocap_acc = torch.where(mfire, mocap_acc - params.mocap_period_us, mocap_acc)
            mocap = estimators.select(mfire, mocap_upd, mocap)
        else:
            mocap_acc = mocap_acc - params.mocap_period_us
            mocap = mocap_upd
    gpsimu = s.gpsimu
    gps_acc = s.gps_acc_us + params.dt_us
    if est_mode == "gpsimu":
        gpsimu = estimators.gpsimu_predict(gpsimu, a["acc_meas"], a["gyro_meas"],
                                           params.dt_us.to(torch.float32) * 1e-6)
        if static_gps_fire is None:
            gfire = gps_acc > GPS_PERIOD_US
            gps_acc = torch.where(gfire, gps_acc - GPS_PERIOD_US, gps_acc)
        elif static_gps_fire:
            gfire = torch.ones((), dtype=torch.bool, device=dev)
            gps_acc = gps_acc - GPS_PERIOD_US
        if static_gps_fire is not False:
            gpsimu = estimators.gps_position_update(gpsimu, new_plant.pos, gfire)

    if static_gps_fire is False:
        # statically silent offboard tick: the estimate is never consumed
        z3 = torch.zeros(3, dtype=torch.float32, device=dev)
        est = (z3, z3, rot.identity(dev), z3)
    elif est_mode == "mocap":
        est = estimators.mocap_get_prediction(mocap, now_us, params.est_latency_us)
    elif est_mode == "gpsimu":
        est = (gpsimu.pos, gpsimu.vel, gpsimu.att, gpsimu.angvel)
    else:
        est = (new_plant.pos, new_plant.vel, new_plant.att, new_plant.angvel)

    return dict(
        plant=new_plant, logic=new_logic, ring=a["ring"], uwb=uwb_state, mocap=mocap,
        mocap_acc_us=mocap_acc, gpsimu=gpsimu, gps_acc_us=gps_acc, now_us=now_us, est=est,
    )


def _outputs(plant, logic) -> StepOutputs:
    return StepOutputs(pos=plant.pos, vel=plant.vel, att=plant.att, angvel=plant.angvel,
                       motor_speeds=plant.motor_speeds, flight_state=logic.fs,
                       panic_reason=logic.panic_reason, warnings=logic.warnings)


def _offboard_and_finish(params: EnvParams, s: EnvState, cmd: Command, half,
                         use_estimator, ctrl_mode: str, static_fire=None):
    """The 100 Hz offboard loop (steps 5b-6): control on the estimate, the
    command into the radio ring and, with the mocap estimator, into its
    prediction pipe. static_fire: a python bool where the cadence is known
    in advance (a silent tick does no offboard work), None for the
    accumulator's decision."""
    new_plant, new_logic, ring, mocap = half["plant"], half["logic"], half["ring"], half["mocap"]
    now_us = half["now_us"]
    est_pos, est_vel, est_att, _ = half["est"]
    dev = new_plant.pos.device

    acc_us = s.offboard_acc_us + params.dt_us
    if static_fire is None:
        fire = acc_us > params.offboard_period_us
        acc_us = torch.where(fire, acc_us - params.offboard_period_us, acc_us)
    elif static_fire:
        fire = torch.ones((), dtype=torch.bool, device=dev)
        acc_us = acc_us - params.offboard_period_us

    last_thrust, last_angvel = s.last_cmd_thrust, s.last_cmd_angvel
    if static_fire is not False:
        cmd_angvel, cmd_thrust = offboard_ctrl.run(
            params.ctrl, est_pos, est_vel, est_att, cmd.des_pos, cmd.des_vel, cmd.des_acc,
            cmd.des_yaw)
        if ctrl_mode == "rates":
            rtype, rflags, rfields = radio.make_rates_command(cmd_thrust, cmd_angvel)
        elif ctrl_mode == "position":
            # CTRL_ONBOARD_UWB path: forward the setpoint, onboard flies it
            rtype, rflags, rfields = radio.make_position_command(
                cmd.des_pos, cmd.des_vel, torch.zeros(3, dtype=torch.float32, device=dev))
        elif ctrl_mode == "idle":
            # keep the vehicle in FS_IDLE (motors off) while the sensors and
            # estimators converge
            rtype, rflags, rfields = radio.make_idle_command(dev)
        else:
            raise ValueError(f"unknown ctrl_mode {ctrl_mode!r}")
        ring = delayline.push(ring, rtype, rflags, rfields, s.step, fire)

        if _est_mode(use_estimator) == "mocap":
            # close the latency-compensation loop: the commanded (angvel,
            # acc) enter the prediction pipe, active after the delay
            pred_acc = (rot.rotate(est_att, const((0.0, 0.0, 1.0), dev)) * cmd_thrust
                        + const((0.0, 0.0, -9.81), dev))
            mocap = estimators.mocap_set_predicted_values(
                mocap, now_us, params.est_latency_us, cmd_angvel, pred_acc, fire)
        last_thrust = torch.where(fire, cmd_thrust, last_thrust)
        last_angvel = torch.where(fire, cmd_angvel, last_angvel)

    new_state = EnvState(
        plant=new_plant, logic=new_logic, ring=ring, offboard_acc_us=acc_us, step=s.step + 1,
        last_cmd_thrust=last_thrust, last_cmd_angvel=last_angvel,
        mocap=mocap, mocap_acc_us=half["mocap_acc_us"], gpsimu=half["gpsimu"],
        gps_acc_us=half["gps_acc_us"], uwb=half["uwb"])
    return new_state, _outputs(new_plant, new_logic)


def _step_one(params, s, cmd, noise, draws, use_estimator, ctrl_mode, mocap_fire=None,
              offboard_fire=None):
    half = physics_tick(s, params, cmd.ext_force, cmd.ext_torque, use_estimator,
                        static_mocap_fire=mocap_fire, static_gps_fire=offboard_fire,
                        noise=noise, uwb_draws=draws)
    return _offboard_and_finish(params, s, cmd, half, use_estimator, ctrl_mode,
                                static_fire=offboard_fire)


def _fleet_size(s: EnvState):
    """B for a fleet state (a leading B on every leaf), None for one vehicle."""
    return None if s.step.dim() == 0 else s.step.shape[0]


_BASE_DIMS = Command(1, 1, 1, 0, 1, 1)


def _fleet_command(cmd: Command, B) -> Command:
    """The command with a leading B on every leaf (a shared leaf expanded)."""
    if B is None:
        return cmd
    out = []
    for name, t, base in zip(Command._fields, cmd, _BASE_DIMS):
        t = torch.as_tensor(t, dtype=torch.float32)
        if t.dim() == base:
            t = t.expand((B,) + t.shape)
        elif t.dim() != base + 1 or t.shape[0] != B:
            raise ValueError(f"command leaf {name}: shape {tuple(t.shape)} for a fleet of {B}")
        out.append(t)
    return Command(*out)


def _stepper(params, use_estimator, ctrl_mode, B, mocap_fire=None, offboard_fire=None):
    """fn(state, cmd, noise, uwb_draws) -> (state, outputs) for one tick;
    vmapped over the fleet axis when B is not None."""
    def one(s, c, n, d):
        return _step_one(params, s, c, n, d, use_estimator, ctrl_mode, mocap_fire,
                         offboard_fire)

    if B is None:
        return one
    # the fleet axis on every tensor of the state (a tree without a UWB
    # network holds a None), on the command, the noise and the UWB draws
    dims = EnvState(*(0,) * (len(EnvState._fields) - 1), uwb=None if params.uwb is None else 0)
    return torch.func.vmap(one, in_dims=(dims, 0, 0, None if params.uwb is None else 0),
                           out_dims=(dims, 0))


def _check_draws(params: EnvParams, uwb_draws, shape):
    """The UWB draws: a float32 tensor of `shape` where the params have a
    network, None where they have none."""
    if params.uwb is None:
        if uwb_draws is not None:
            raise ValueError("UWB draws given, but the params have no UWB network")
        return None
    if uwb_draws is None:
        raise ValueError("the params have a UWB network: pass its draws (uwb_draws)")
    if tuple(uwb_draws.shape) != tuple(shape) or uwb_draws.dtype != torch.float32:
        raise ValueError(f"need {tuple(shape)} float32 UWB draws, got "
                         f"{tuple(uwb_draws.shape)} {uwb_draws.dtype}")
    return uwb_draws


def step(params: EnvParams, s: EnvState, cmd: Command, use_estimator=False,
         ctrl_mode: str = "rates", noise=None, uwb_draws=None):
    """Advance one 2 ms tick. Returns (new_state, outputs).

    use_estimator: False = offboard control sees the true plant state
    (config #1); True = the demo's estimation chain (config #2): perfect
    mocap measurements at 200 Hz -> MocapStateEstimator with delayed-command
    replay -> GetPrediction(latency) feeds the controller, and each command
    enters the prediction pipe; "gpsimu" = the GPS-IMU estimator, its GPS
    fix at 100 Hz, feeds the controller. noise: the tick's IMU unit normals
    (2, 3) (a fleet: (B, 2, 3), a leading B on every state leaf);
    uwb_draws: with anchors, the network's draws (4,) (a fleet: (B, 4))."""
    _check_modes(use_estimator, ctrl_mode)
    if noise is None:
        raise ValueError("step needs the tick's IMU noise (the port has no PRNG key)")
    B = _fleet_size(s)
    draws = _check_draws(params, uwb_draws, noise.shape[:-2] + (uwb_mod.N_DRAWS,))
    return _stepper(params, use_estimator, ctrl_mode, B)(s, _fleet_command(cmd, B), noise,
                                                          draws)


def step_static(params: EnvParams, s: EnvState, cmd: Command, use_estimator, ctrl_mode: str,
                mocap_fire: bool, offboard_fire: bool, noise=None, uwb_draws=None):
    """One tick with statically known cadence decisions (see rollout_fast)."""
    _check_modes(use_estimator, ctrl_mode)
    if noise is None:
        raise ValueError("step_static needs the tick's IMU noise")
    B = _fleet_size(s)
    draws = _check_draws(params, uwb_draws, noise.shape[:-2] + (uwb_mod.N_DRAWS,))
    fn = _stepper(params, use_estimator, ctrl_mode, B, bool(mocap_fire), bool(offboard_fire))
    return fn(s, _fleet_command(cmd, B), noise, draws)


def _cadence_patterns(n=40, dt=2000, mocap=5000, offboard=10000, macc0=0, oacc0=0):
    """Python-simulate the accumulator trigger patterns from the entry
    values macc0 / oacc0. Returns (mocap_flags, offboard_flags, states),
    states[i] the joint (mocap_acc, offboard_acc) AFTER tick i."""
    mpat, opat, states = [], [], []
    macc, oacc = macc0, oacc0
    for _ in range(n):
        macc += dt
        mf = macc > mocap
        if mf:
            macc -= mocap
        oacc += dt
        of = oacc > offboard
        if of:
            oacc -= offboard
        mpat.append(bool(mf))
        opat.append(bool(of))
        states.append((macc, oacc))
    return mpat, opat, states


def fast_flags(params: EnvParams, state: EnvState, n_steps: int, entry_phase=None):
    """The per-tick (mocap_fire, offboard_fire) flags rollout_fast uses:
    the accumulators' decisions simulated in advance from step 0 or from
    entry_phase; None where it falls back to `rollout`: cadences other
    than the default (dt 2 ms, mocap 200 Hz, offboard 100 Hz), or, without
    entry_phase, a vehicle whose step is not 0. (The JAX package lays the
    same flags out as a prologue and a scanned 5-tick block.)"""
    if (int(params.dt_us) != 2000 or int(params.mocap_period_us) != 5000
            or int(params.offboard_period_us) != 10000):
        return None
    if entry_phase is None:
        if bool((state.step != 0).any()):  # eager torch: every step is concrete
            return None
        entry_phase = (0, 0)
    mpat, opat, _ = _cadence_patterns(n_steps, macc0=int(entry_phase[0]),
                                      oacc0=int(entry_phase[1]))
    return list(zip(mpat, opat))


def _noise_blocks(params: EnvParams, state: EnvState, n_steps: int, noise, gen, uwb_draws):
    """The IMU noise block (..., n_steps, 2, 3) and, with anchors, the UWB
    draws (..., n_steps, 4): as given, or drawn from gen (the noise first;
    the draws' uniforms by torch.rand, their normals by torch.randn)."""
    lead = tuple(state.step.shape)
    dev = state.step.device
    if noise is None:
        if gen is None:
            raise ValueError("pass the IMU noise block or a torch.Generator (gen)")
        noise = torch.randn(lead + (n_steps, 2, 3), generator=gen, device=dev)
    if tuple(noise.shape) != lead + (n_steps, 2, 3) or noise.dtype != torch.float32:
        raise ValueError(f"need {lead + (n_steps, 2, 3)} float32 noise, got "
                         f"{tuple(noise.shape)} {noise.dtype}")
    if params.uwb is not None and uwb_draws is None and gen is not None:
        uwb_draws = uwb_mod.draw(lead + (n_steps,), gen, dev)
    return noise, _check_draws(params, uwb_draws, lead + (n_steps, uwb_mod.N_DRAWS))


def _stack_outputs(outs, B) -> StepOutputs:
    return StepOutputs(*(torch.stack(x, dim=0 if B is None else 1) for x in zip(*outs)))


def rollout_plain(params: EnvParams, state: EnvState, cmd: Command, noise,
                  use_estimator=False, ctrl_mode: str = "rates", flags=None, uwb_draws=None):
    """`step` scanned over noise's n_steps ticks in plain torch, on any
    device; a fleet vmaps each tick. uwb_draws: (..., n_steps, 4) with
    anchors, else None. flags: per-tick (mocap_fire,
    offboard_fire) python bools (`fast_flags`), None for the accumulators'
    decisions. Returns (state, traj), traj's leaves (n_steps, ...) or
    (B, n_steps, ...): inference tensors (it runs under
    torch.inference_mode, which halves the host's cost of a tick). The
    reference for the kernel (`cuda_rollout`)."""
    _check_modes(use_estimator, ctrl_mode)
    B = _fleet_size(state)
    cmd = _fleet_command(cmd, B)
    steppers = {}
    outs = []
    with torch.inference_mode():
        for k in range(noise.shape[-3]):
            key = (None, None) if flags is None else flags[k]
            if key not in steppers:
                steppers[key] = _stepper(params, use_estimator, ctrl_mode, B, *key)
            draws = None if uwb_draws is None else uwb_draws[..., k, :]
            state, out = steppers[key](state, cmd, noise[..., k, :, :], draws)
            outs.append(out)
        # vmap may hand back leaves whose fleet axis is not the outermost in memory
        return _tree_map(torch.Tensor.contiguous, state), _stack_outputs(outs, B)


def rollout(params: EnvParams, state: EnvState, cmd: Command, n_steps: int,
            use_estimator=False, ctrl_mode: str = "rates", noise=None, gen=None,
            uwb_draws=None):
    """`step` scanned n_steps times with a fixed command. state: one vehicle
    or a fleet (a leading B on every leaf; cmd leaves shared or with a
    leading B). noise: (..., n_steps, 2, 3) and, with anchors, uwb_draws
    (..., n_steps, 4), or both drawn from gen. CUDA tensors: one launch of
    the rollout kernel; CPU tensors: plain torch. Returns (state, traj)."""
    from agrifly_tpu_torch.sim import cuda_rollout

    noise, draws = _noise_blocks(params, state, n_steps, noise, gen, uwb_draws)
    return cuda_rollout.rollout(params, state, cmd, noise, use_estimator, ctrl_mode,
                                uwb_draws=draws)


def rollout_fast(params: EnvParams, state: EnvState, cmd: Command, n_steps: int,
                 use_estimator=False, ctrl_mode: str = "rates", entry_phase=None,
                 noise=None, gen=None, uwb_draws=None):
    """The cadence-specialized rollout, held to `rollout`'s results. On CPU
    tensors each tick's estimator and offboard cadence is fixed in advance
    (`fast_flags`), so a silent tick skips the measurement update, the
    prediction and the offboard block; it requires step == 0 at entry (or
    the caller's entry_phase, the (mocap_acc_us, offboard_acc_us) the whole
    fleet shares) and the default cadences, and falls back to the plain
    `rollout` otherwise. On CUDA tensors the rollout kernel runs, which
    decides the cadences from the accumulators on its own (the GPS fix's
    too, by the `> 10 ms, then subtract` rule). noise, uwb_draws, gen: as
    `rollout` takes them."""
    from agrifly_tpu_torch.sim import cuda_rollout

    noise, draws = _noise_blocks(params, state, n_steps, noise, gen, uwb_draws)
    return cuda_rollout.rollout(params, state, cmd, noise, use_estimator, ctrl_mode,
                                fast=True, entry_phase=entry_phase, uwb_draws=draws)


def rollout_sampled(params: EnvParams, state: EnvState, cmd: Command, n_steps: int,
                    sample_every: int, noise=None, gen=None, uwb_draws=None):
    """`rollout` over (n_steps // sample_every) * sample_every ticks keeping
    every sample_every-th output (the JAX package's default modes: the
    true state, rates commands). noise: (..., that many ticks, 2, 3) and,
    with anchors, uwb_draws (..., that many ticks, 4), or drawn from gen."""
    n = (n_steps // sample_every) * sample_every
    final, traj = rollout(params, state, cmd, n, noise=noise, gen=gen, uwb_draws=uwb_draws)
    axis = 0 if _fleet_size(state) is None else 1
    keep = torch.arange(sample_every - 1, n, sample_every, device=state.step.device)
    return final, StepOutputs(*(x.index_select(axis, keep) for x in traj))
