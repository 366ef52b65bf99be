"""Simulation environment: plant + onboard logic + radio + mocap estimator.

Port of the single-vehicle tick of `agrifly_tpu/sim/env.py` as the orchard
frame uses it: `physics_phase_a` (radio delivery, plant, IMU) and
`physics_tick` with the mocap estimator (use_estimator=True), pre-drawn IMU
noise, no external force and no UWB. Periodic subsystems run on integer-
microsecond accumulators with the reference's `> period, then subtract`
rule.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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


class EnvState(NamedTuple):
    """The JAX package's EnvState without its PRNG key (randomness comes
    from a torch.Generator or injected draws) and without UWB."""

    plant: plant_mod.PlantState
    logic: onboard.LogicState
    ring: delayline.RadioRing
    offboard_acc_us: torch.Tensor  # int32 periodic accumulator
    step: torch.Tensor  # int32
    last_cmd_thrust: torch.Tensor  # f32 (previousThrust in the demo)
    last_cmd_angvel: torch.Tensor  # (3,)
    mocap: estimators.MocapEstState
    mocap_acc_us: torch.Tensor  # int32 periodic accumulator
    gpsimu: ekf.EkfState  # offboard GPS-IMU estimator (carried, unused here)
    gps_acc_us: torch.Tensor  # int32 periodic accumulator


def make_params(vehicle_type: int = qconst.QC_TYPE_CF_MINIQUAD, dt: float = 1.0 / 500.0,
                offboard_period: float = 1.0 / 100.0, radio_delay: float = 0.03,
                noise_scale: float = 1.0, mocap_period: float = 1.0 / 200.0,
                est_latency: float = 0.03, device=None) -> EnvParams:
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


def init_state(params: EnvParams, pos=(0.0, 0.0, 0.0)) -> EnvState:
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
    )


def physics_phase_a(s: EnvState, params: EnvParams, noise):
    """Radio delivery, plant integration and IMU fabrication for one tick.
    noise: (gyro_n (3,), acc_n (3,)) unit normals for the IMU."""
    dt = params.dt_us.to(torch.float32) * 1e-6

    # radio delivery (pushed > delay ago becomes visible to the logic now)
    ring, delivered, mtype, mflags, mfields = delayline.pop_due(
        s.ring, s.step, params.dt_us, params.radio_delay_us)

    new_plant, acc_imu = plant_mod.step(params.plant, s.plant, s.logic.des_motor_speeds, dt)

    gyro_meas, acc_meas = plant_mod.imu_measurements(params.plant, new_plant, acc_imu, noise)
    grav = const(plant_mod.GRAVITY, dt.device)
    gyro_true = lin3.mv3(params.plant.imu_rot_inv, new_plant.angvel)
    acc_true = lin3.mv3(params.plant.imu_rot_inv, rot.rotate_back(new_plant.att, acc_imu - grav))
    gyro_meas = gyro_true + (gyro_meas - gyro_true) * params.noise_scale
    acc_meas = acc_true + (acc_meas - acc_true) * params.noise_scale
    return dict(ring=ring, delivered=delivered, mtype=mtype, mflags=mflags, mfields=mfields,
                plant=new_plant, gyro_meas=gyro_meas, acc_meas=acc_meas)


def physics_tick(s: EnvState, params: EnvParams, noise):
    """Radio delivery, plant, IMU, onboard logic and the 200 Hz mocap
    estimator for one tick. Returns a dict with the partial new state and
    the estimator's prediction `est` = (pos, vel, att, angvel)."""
    a = physics_phase_a(s, params, noise)
    new_plant = a["plant"]
    dev = new_plant.pos.device

    # onboard logic tick (constant battery)
    inputs = onboard.LogicInputs(
        gyro=a["gyro_meas"], acc=a["acc_meas"],
        temperature=torch.full((), 25.0, device=dev),
        batt_voltage=params.logic.batt_critical * 1.2,
        batt_current=torch.full((), -1.0, device=dev),
        radio_new=a["delivered"], radio_type=a["mtype"], radio_flags=a["mflags"],
        radio_fields=a["mfields"])
    new_logic, _ = onboard.logic_step(params.logic, s.logic, inputs)

    now_us = (s.step + 1) * params.dt_us  # master time after this tick

    # 200 Hz mocap measurement -> estimator update
    mocap_acc = s.mocap_acc_us + params.dt_us
    mfire = mocap_acc > params.mocap_period_us
    mocap_acc = torch.where(mfire, mocap_acc - params.mocap_period_us, mocap_acc)
    mocap_upd = estimators.mocap_update(s.mocap, now_us, new_plant.pos, new_plant.att,
                                        params.mocap_period_us)
    mocap = estimators.select(mfire, mocap_upd, s.mocap)

    return dict(
        plant=new_plant, logic=new_logic, ring=a["ring"], mocap=mocap,
        mocap_acc_us=mocap_acc, gpsimu=s.gpsimu, gps_acc_us=s.gps_acc_us + params.dt_us,
        now_us=now_us,
        est=estimators.mocap_get_prediction(mocap, now_us, params.est_latency_us),
    )
