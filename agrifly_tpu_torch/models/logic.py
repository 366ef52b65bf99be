"""Onboard flight-controller logic as one step function.

Port of `agrifly_tpu/models/logic.py` (QuadcopterLogic.{hpp,cpp}): the
500 Hz onboard loop as `logic_step(params, state, inputs) -> (state,
motor_cmds)` over a NamedTuple state. Every controller branch is computed
and the flight state selects one, as in the JAX package. With UWB ranging
(anchors installed by `with_ranging_targets`, a measurement in the inputs)
each tick also runs the EKF's range update; inputs whose `uwb_new` is the
python `False` (`null_inputs`, the default) leave the update out of the
tick, as the JAX package leaves it out of its trace.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from agrifly_tpu_torch.io import radio
from agrifly_tpu_torch.models import controllers, ekf, mixer
from agrifly_tpu_torch.ops import filters, lin3
from agrifly_tpu_torch.ops import rotation as rot
from agrifly_tpu_torch.ops.fmath import const, norm3

# flight states
FS_UNINITIALIZED = 0
FS_IDLE = 1
FS_FULLY_AUTONOMOUS = 2
FS_PANIC = 3
FS_KILLED = 4
FS_EXTERNAL_ACCELERATION_CONTROL = 5
FS_EXTERNAL_RATES_CONTROL = 6

# panic reasons
PANIC_NO_PANIC = 0
PANIC_ONBOARD_ESTIMATE_CRAZY = 1
PANIC_UWB_TIMEOUT = 2
PANIC_UPSIDE_DOWN = 3
PANIC_RADIO_CMD_TIMEOUT = 4
PANIC_LOW_BATTERY = 5
PANIC_KILLED_INTERNALLY = 6
PANIC_KILLED_EXTERNALLY = 7

PANIC_REASON_NAMES = {
    PANIC_NO_PANIC: "NO_PANIC",
    PANIC_ONBOARD_ESTIMATE_CRAZY: "ONBOARD_ESTIMATE_CRAZY",
    PANIC_UWB_TIMEOUT: "UWB_TIMEOUT",
    PANIC_UPSIDE_DOWN: "UPSIDE_DOWN",
    PANIC_RADIO_CMD_TIMEOUT: "RADIO_CMD_TIMEOUT",
    PANIC_LOW_BATTERY: "LOW_BATTERY",
    PANIC_KILLED_INTERNALLY: "KILLED_INTERNALLY",
    PANIC_KILLED_EXTERNALLY: "KILLED_EXTERNALLY",
}

# telemetry warning bits (TelemetryPacket.hpp:21-30)
WARN_LOW_BATT = 0x01
WARN_CMD_RATE = 0x02
WARN_UWB_RESET = 0x04
WARN_ONBOARD_FREQ = 0x08
WARN_CMD_BATCH_DROP = 0x10

# timeouts / thresholds (QuadcopterLogic.cpp:305-391)
NO_UWB_PANIC_TIMEOUT_US = 1_500_000
NO_RADIO_PANIC_TIMEOUT_US = 1_500_000
MIN_SANE_ESTIMATOR_HEIGHT = -2.0
WARN_BATCH_CMD_DROP_NUM = 3
WARNING_WINDOW_EST_RESET_US = 20_000
RADIO_CMD_PERIOD = 0.02  # [s] expected command period
MAX_RANGING_TARGETS = 32
_US_SAT = 100_000_000  # timers saturate at 100 s


class LogicParams(NamedTuple):
    valid: torch.Tensor  # bool
    mass: torch.Tensor
    arm_length: torch.Tensor
    prop_thrust_from_speed_sqr: torch.Tensor
    prop_torque_from_thrust: torch.Tensor
    prop0_spin_dir: torch.Tensor
    max_thrust_per_prop: torch.Tensor
    min_thrust_per_prop: torch.Tensor
    max_cmd_total_thrust: torch.Tensor
    pos_nat_freq: torch.Tensor
    pos_damping: torch.Tensor
    att_tc_xy: torch.Tensor
    att_tc_z: torch.Tensor
    angvel_tc_xy: torch.Tensor
    angvel_tc_z: torch.Tensor
    inertia: torch.Tensor  # (3,3)
    imu_rot: torch.Tensor  # (3,3) IMU mounting rotation
    batt_critical: torch.Tensor
    batt_warning: torch.Tensor
    onboard_period: torch.Tensor  # [s]
    onboard_period_us: torch.Tensor  # int32
    acc_lp: filters.Lp2Coeffs
    gyro_lp: filters.Lp2Coeffs
    temp_lp: filters.Lp2Coeffs
    batt_lp: filters.Lp2Coeffs
    cmd_rate_lp_coeff: torch.Tensor
    loop_lp_coeff: torch.Tensor
    # UWB ranging targets
    target_positions: torch.Tensor  # (MAX_RANGING_TARGETS, 3)
    target_ids: torch.Tensor  # (MAX_RANGING_TARGETS,) int32
    num_targets: torch.Tensor  # int32


class LogicState(NamedTuple):
    fs: torch.Tensor  # int32 flight state
    cycle_count: torch.Tensor  # int32
    kf: ekf.EkfState
    acc_lp: filters.Lp2State
    gyro_lp: filters.Lp2State
    temp_lp: filters.Lp2State
    batt_lp: filters.Lp2State
    gyro_raw: torch.Tensor  # (3,) after mounting rotation, pre-bias
    gyro_bias: torch.Tensor  # (3,)
    gyro_cal_enabled: torch.Tensor  # bool
    gyro_cal_accum: torch.Tensor  # (3,)
    gyro_cal_count: torch.Tensor  # int32
    radio_new: torch.Tensor  # bool
    radio_type: torch.Tensor  # int32
    radio_flags: torch.Tensor  # int32
    radio_floats: torch.Tensor  # (10,) decoded
    radio_count: torch.Tensor  # int32
    us_since_radio: torch.Tensor  # int32
    us_since_uwb: torch.Tensor  # int32
    next_target_idx: torch.Tensor  # int32
    uwb_meas_count: torch.Tensor  # int32
    cmd_rate_lpdt: torch.Tensor  # f32 [s]
    loop_lpdt: torch.Tensor  # f32 [s]
    us_since_est_reset: torch.Tensor  # int32
    last_check_num_resets: torch.Tensor  # int32
    warnings: torch.Tensor  # int32 bitfield
    panic_reason: torch.Tensor  # int32
    des_motor_speeds: torch.Tensor  # (4,)
    des_motor_forces: torch.Tensor  # (4,)
    prop_cal_running: torch.Tensor  # bool
    prop_cal_factors: torch.Tensor  # (4,)
    prop_cal_accum: torch.Tensor  # (4,)
    prop_cal_count: torch.Tensor  # int32
    should_write_params: torch.Tensor  # bool
    batt_voltage: torch.Tensor
    batt_current: torch.Tensor
    test_motors_on: torch.Tensor  # bool
    test_motors_frac: torch.Tensor  # thrust fraction of hover weight
    tel_counter: torch.Tensor  # int32
    debug: torch.Tensor  # (6,)


class LogicInputs(NamedTuple):
    gyro: torch.Tensor  # (3,) raw rate gyro [rad/s] (IMU frame)
    acc: torch.Tensor  # (3,) raw accelerometer [m/s^2] (IMU frame)
    temperature: torch.Tensor
    batt_voltage: torch.Tensor
    batt_current: torch.Tensor
    radio_new: torch.Tensor  # bool
    radio_type: torch.Tensor  # int32
    radio_flags: torch.Tensor  # int32
    radio_fields: torch.Tensor  # (10,) int32 wire codes
    # a UWB range measurement: a python False uwb_new means none this tick
    # (the range update is left out), a bool tensor a measurement or not
    uwb_new: object = False
    uwb_range: object = 0.0  # f32 [m]
    uwb_responder_id: object = 0  # int32
    uwb_failure: object = False  # bool: the transaction was reported failed


def null_inputs(device=None) -> LogicInputs:
    """Inputs with no sensor reading, no radio message and no UWB."""
    z3 = torch.zeros(3, dtype=torch.float32, device=device)
    i0 = torch.zeros((), dtype=torch.int32, device=device)
    return LogicInputs(
        gyro=z3, acc=z3, temperature=torch.full((), 25.0, device=device),
        batt_voltage=torch.zeros((), device=device),
        batt_current=torch.full((), -1.0, device=device),
        radio_new=torch.zeros((), dtype=torch.bool, device=device), radio_type=i0,
        radio_flags=i0, radio_fields=torch.zeros(10, dtype=torch.int32, device=device))


def make_params(v, onboard_period=1.0 / 500.0, device=None) -> LogicParams:
    """LogicParams from a `models.constants.VehicleParams` preset
    (QuadcopterLogic.cpp:98-162)."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)  # noqa: E731
    imu = torch.tensor(rot.from_euler_ypr_np(v.imu_yaw, v.imu_pitch, v.imu_roll))
    return LogicParams(
        valid=torch.tensor(bool(v.valid), device=device),
        mass=f32(v.mass),
        arm_length=f32(v.arm_length),
        prop_thrust_from_speed_sqr=f32(v.prop_thrust_from_speed_sqr),
        prop_torque_from_thrust=f32(v.prop_torque_from_thrust),
        prop0_spin_dir=f32(v.prop0_spin_dir),
        max_thrust_per_prop=f32(v.max_thrust_per_prop),
        min_thrust_per_prop=f32(v.min_thrust_per_prop),
        max_cmd_total_thrust=f32(v.max_cmd_total_thrust),
        pos_nat_freq=f32(v.pos_control_nat_freq),
        pos_damping=f32(v.pos_control_damping),
        att_tc_xy=f32(v.att_control_tc_xy),
        att_tc_z=f32(max(v.att_control_tc_z, v.att_control_tc_xy)),
        angvel_tc_xy=f32(v.angvel_control_tc_xy),
        angvel_tc_z=f32(v.angvel_control_tc_z),
        inertia=f32(v.inertia_matrix),
        imu_rot=rot.to_matrix(imu).to(torch.float32).to(device),
        batt_critical=f32(v.low_battery_threshold),
        batt_warning=f32(1.05 * v.low_battery_threshold),
        onboard_period=f32(onboard_period),
        onboard_period_us=torch.tensor(round(onboard_period * 1e6), dtype=torch.int32,
                                       device=device),
        acc_lp=filters.lp2_coeffs(onboard_period, 100.0, device),
        gyro_lp=filters.lp2_coeffs(onboard_period, 200.0, device),
        temp_lp=filters.lp2_coeffs(onboard_period, 0.5 * 2 * math.pi, device),
        batt_lp=filters.lp2_coeffs(onboard_period, 0.5 * 2 * math.pi, device),
        cmd_rate_lp_coeff=f32(math.exp(-RADIO_CMD_PERIOD * 1.0)),
        loop_lp_coeff=f32(math.exp(-onboard_period * 50.0)),
        target_positions=torch.zeros((MAX_RANGING_TARGETS, 3), dtype=torch.float32,
                                     device=device),
        target_ids=torch.zeros(MAX_RANGING_TARGETS, dtype=torch.int32, device=device),
        num_targets=torch.zeros((), dtype=torch.int32, device=device),
    )


def with_ranging_targets(p: LogicParams, ids, positions) -> LogicParams:
    """Install UWB anchor targets (AddRangingTargetId): ids (n,), positions
    (n, 3), n <= MAX_RANGING_TARGETS."""
    n = len(ids)
    dev = p.mass.device
    tpos = np.zeros((MAX_RANGING_TARGETS, 3), np.float32)
    tids = np.zeros((MAX_RANGING_TARGETS,), np.int32)
    tpos[:n] = np.asarray(positions, np.float32)
    tids[:n] = np.asarray(ids, np.int32)
    return p._replace(target_positions=torch.from_numpy(tpos).to(dev),
                      target_ids=torch.from_numpy(tids).to(dev),
                      num_targets=torch.tensor(n, dtype=torch.int32, device=dev))


def init_state(p: LogicParams) -> LogicState:
    """Post-Initialise state: IDLE if the vehicle type is valid, else KILLED."""
    dev = p.mass.device
    z3 = torch.zeros(3, dtype=torch.float32, device=dev)
    z4 = torch.zeros(4, dtype=torch.float32, device=dev)
    i0 = torch.zeros((), dtype=torch.int32, device=dev)
    f0 = torch.zeros((), dtype=torch.float32, device=dev)
    b0 = torch.zeros((), dtype=torch.bool, device=dev)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    return LogicState(
        fs=torch.where(p.valid, i32(FS_IDLE), i32(FS_KILLED)),
        cycle_count=i0, kf=ekf.init_state(dev),
        acc_lp=filters.lp2_init(z3), gyro_lp=filters.lp2_init(z3),
        temp_lp=filters.lp2_init(f0 + 25.0),
        batt_lp=filters.lp2_init(p.batt_critical * 1.2),
        gyro_raw=z3, gyro_bias=z3, gyro_cal_enabled=b0, gyro_cal_accum=z3,
        gyro_cal_count=i0, radio_new=b0, radio_type=i0, radio_flags=i0,
        radio_floats=torch.zeros(10, dtype=torch.float32, device=dev),
        radio_count=i0, us_since_radio=i0, us_since_uwb=i0, next_target_idx=i0,
        uwb_meas_count=i0, cmd_rate_lpdt=f0 + RADIO_CMD_PERIOD,
        loop_lpdt=p.onboard_period, us_since_est_reset=i32(_US_SAT),
        last_check_num_resets=i0, warnings=i0,
        panic_reason=torch.where(p.valid, i32(PANIC_NO_PANIC), i32(PANIC_KILLED_INTERNALLY)),
        des_motor_speeds=z4, des_motor_forces=z4, prop_cal_running=b0,
        prop_cal_factors=torch.ones(4, dtype=torch.float32, device=dev),
        prop_cal_accum=z4, prop_cal_count=i0, should_write_params=b0,
        batt_voltage=f0, batt_current=f0 - 1.0, test_motors_on=b0,
        test_motors_frac=f0, tel_counter=i0,
        debug=torch.zeros(6, dtype=torch.float32, device=dev),
    )


def _advance_timer(us, period_us):
    return torch.clamp(us + period_us, max=_US_SAT)


def _lookup_target(p: LogicParams, responder_id):
    """(anchor position, known) for a responder id: the matching rows of
    the target table summed in order."""
    idx = torch.arange(MAX_RANGING_TARGETS, device=p.target_ids.device)
    match = (p.target_ids == responder_id) & (idx < p.num_targets)
    rows = torch.where(match[:, None], p.target_positions, 0.0)
    pos = rows[0]
    for k in range(1, MAX_RANGING_TARGETS):
        pos = pos + rows[k]
    return pos, torch.any(match)


def _bits(cond, bit):
    """int32 `bit` where cond, else 0."""
    return cond.to(torch.int32) * bit


def logic_step(p: LogicParams, s: LogicState, u: LogicInputs):
    """One onboard tick. Returns (new_state, motor_speed_cmds (4,))."""
    dev = s.fs.device
    per_us = p.onboard_period_us
    zero4 = torch.zeros(4, dtype=torch.float32, device=dev)

    # sensor ingestion (the Set* methods)
    gyro_raw = lin3.mv3(p.imu_rot, u.gyro)
    gyro_lp, _ = filters.lp2_apply(p.gyro_lp, s.gyro_lp, gyro_raw - s.gyro_bias)
    acc_raw = lin3.mv3(p.imu_rot, u.acc)
    acc_lp, _ = filters.lp2_apply(p.acc_lp, s.acc_lp, acc_raw)
    temp_lp, _ = filters.lp2_apply(p.temp_lp, s.temp_lp, u.temperature)
    batt_lp, _ = filters.lp2_apply(p.batt_lp, s.batt_lp, u.batt_voltage)

    # radio delivery: decoded floats + cmd-rate monitor
    us_since_radio = _advance_timer(s.us_since_radio, per_us)
    cmd_dt = us_since_radio.to(torch.float32) * 1e-6
    new_lpdt = p.cmd_rate_lp_coeff * s.cmd_rate_lpdt + (1.0 - p.cmd_rate_lp_coeff) * cmd_dt
    cmd_rate_lpdt = torch.where(u.radio_new, new_lpdt, s.cmd_rate_lpdt)
    radio_floats = torch.where(u.radio_new, radio.decode_message(u.radio_type, u.radio_fields),
                               s.radio_floats)
    radio_type = torch.where(u.radio_new, u.radio_type, s.radio_type)
    radio_flags = torch.where(u.radio_new, u.radio_flags, s.radio_flags)
    radio_count = s.radio_count + u.radio_new.to(torch.int32)
    us_since_radio = torch.where(u.radio_new, torch.zeros_like(us_since_radio), us_since_radio)
    us_since_uwb = _advance_timer(s.us_since_uwb, per_us)
    uwb_static_off = isinstance(u.uwb_new, bool) and not u.uwb_new
    if not uwb_static_off:
        us_since_uwb = torch.where(u.uwb_new, torch.zeros_like(us_since_uwb), us_since_uwb)
    radio_pending = s.radio_new | u.radio_new

    # Run()
    cycle = s.cycle_count + 1
    loop_lpdt = p.loop_lp_coeff * s.loop_lpdt + (1.0 - p.loop_lp_coeff) * p.onboard_period
    gyro_f = filters.lp2_value(gyro_lp)
    acc_f = filters.lp2_value(acc_lp)

    # UpdateEstimator
    kf = ekf.predict(s.kf, gyro_f, acc_f, p.onboard_period)
    cal_on = s.gyro_cal_enabled
    gyro_cal_accum = torch.where(cal_on, s.gyro_cal_accum + gyro_raw, s.gyro_cal_accum)
    gyro_cal_count = s.gyro_cal_count + cal_on.to(torch.int32)
    uwb_meas_count, next_target_idx = s.uwb_meas_count, s.next_target_idx
    if not uwb_static_off:  # the range update
        uwb_success = u.uwb_new & ~u.uwb_failure
        target_pos, target_known = _lookup_target(p, u.uwb_responder_id)
        kf = ekf.update_range(kf, target_pos, u.uwb_range, uwb_success & target_known)
        uwb_meas_count = uwb_meas_count + uwb_success.to(torch.int32)
        next_target_idx = torch.where(
            u.uwb_new & (p.num_targets > 0),
            (next_target_idx + 1) % torch.clamp(p.num_targets, min=1), next_target_idx)

    # ParseIncomingCommunications
    sticky = (s.fs == FS_PANIC) | (s.fs == FS_KILLED)
    fs = s.fs
    take = radio_pending & ~sticky
    is_kill = take & (radio_type == radio.TYPE_EMERGENCY_KILL)
    fs = torch.where(is_kill, FS_KILLED, fs)
    panic_reason = torch.where(is_kill & (s.panic_reason == 0), PANIC_KILLED_EXTERNALLY,
                               s.panic_reason)
    for mtype, state in ((radio.TYPE_POSITION_CMD, FS_FULLY_AUTONOMOUS),
                         (radio.TYPE_EXTERNAL_ACC_CMD, FS_EXTERNAL_ACCELERATION_CONTROL),
                         (radio.TYPE_EXTERNAL_RATES_CMD, FS_EXTERNAL_RATES_CONTROL),
                         (radio.TYPE_IDLE_CMD, FS_IDLE)):
        fs = torch.where(take & (radio_type == mtype), state, fs)

    # UpdateWarnings
    batt_filt = filters.lp2_value(batt_lp)
    warnings = (s.warnings
                | _bits(batt_filt <= p.batt_warning, WARN_LOW_BATT)
                | _bits(torch.abs(cmd_rate_lpdt - RADIO_CMD_PERIOD) > 0.1 * RADIO_CMD_PERIOD,
                        WARN_CMD_RATE)
                | _bits(us_since_radio.to(torch.float32) * 1e-6
                        > WARN_BATCH_CMD_DROP_NUM * RADIO_CMD_PERIOD, WARN_CMD_BATCH_DROP)
                | _bits(torch.abs(loop_lpdt - p.onboard_period) > 0.05 * p.onboard_period,
                        WARN_ONBOARD_FREQ))
    was_reset = kf.num_resets != s.last_check_num_resets
    us_since_est_reset = torch.where(was_reset, torch.zeros_like(s.us_since_est_reset),
                                     _advance_timer(s.us_since_est_reset, per_us))
    warnings = warnings | _bits(us_since_est_reset < WARNING_WINDOW_EST_RESET_US, WARN_UWB_RESET)

    # CheckPanicReasons (later rules override earlier ones)
    e3 = const((0.0, 0.0, 1.0), dev)
    motors_running = torch.any(s.des_motor_speeds > 0)
    checks_on = (radio_flags & radio.FLAG_DISABLE_SAFETY_CHECKS) == 0
    unsafe = torch.zeros_like(fs)
    for cond, reason in (
            ((kf.pos[2] < MIN_SANE_ESTIMATOR_HEIGHT) & checks_on, PANIC_ONBOARD_ESTIMATE_CRAZY),
            ((us_since_uwb > NO_UWB_PANIC_TIMEOUT_US) & (fs == FS_FULLY_AUTONOMOUS),
             PANIC_UWB_TIMEOUT),
            ((rot.rotate(kf.att, e3)[2] < 0) & checks_on, PANIC_UPSIDE_DOWN),
            (us_since_radio > NO_RADIO_PANIC_TIMEOUT_US, PANIC_RADIO_CMD_TIMEOUT),
            (batt_filt <= p.batt_critical, PANIC_LOW_BATTERY)):
        unsafe = torch.where(cond, reason, unsafe)
    unsafe = torch.where(motors_running, unsafe, torch.zeros_like(unsafe))
    in_critical = ((fs == FS_FULLY_AUTONOMOUS) | (fs == FS_EXTERNAL_ACCELERATION_CONTROL)
                   | (fs == FS_EXTERNAL_RATES_CONTROL))
    go_panic = (unsafe != 0) & in_critical & (fs != FS_PANIC)
    panic_reason = torch.where(go_panic, unsafe, panic_reason)
    fs = torch.where(go_panic, FS_PANIC, fs)

    debug = torch.cat([filters.lp2_value(temp_lp)[None], s.debug[1:]])

    # controllers
    est_pos, est_vel, est_att, est_angvel = kf.pos, kf.vel, kf.att, kf.angvel
    g_vec = const((0.0, 0.0, 9.81), dev)

    # FULLY_AUTONOMOUS (QuadcopterLogic.cpp:393-457)
    des_acc = controllers.position_control(p.pos_nat_freq, p.pos_damping, est_pos, est_vel,
                                           radio_floats[0:3])
    proper_acc = des_acc + g_vec
    norm_pa = norm3(proper_acc)
    thrust_dir = proper_acc / torch.where(norm_pa < 1e-12, torch.ones_like(norm_pa), norm_pa)
    corr_sat = torch.clamp(rot.rotate(est_att, e3)[2], min=1.0)  # MIN_THRUST_CORR_FAC
    angvel_auto = controllers.attitude_control(
        p.att_tc_xy, p.att_tc_z, controllers.thrust_dir_to_attitude(thrust_dir), est_att)
    torque_auto = controllers.angvel_control(p.angvel_tc_xy, p.angvel_tc_z, p.inertia,
                                             angvel_auto, est_angvel)
    forces_auto = mixer.motor_forces(p, norm_pa / corr_sat * p.mass, torque_auto)

    # EXTERNAL_ACCELERATION (cpp:459-526)
    cmd_acc = radio_floats[0:3]
    pa2 = cmd_acc + g_vec
    thrust_acc = norm3(pa2)
    dir2 = pa2 / torch.where(thrust_acc < 1e-12, torch.ones_like(thrust_acc), thrust_acc)
    _, pitch, roll = rot.to_euler_ypr(est_att)
    att_no_yaw = rot.from_euler_ypr(torch.zeros_like(pitch), pitch, roll)
    angvel2 = controllers.attitude_control(
        p.att_tc_xy, p.att_tc_z, controllers.thrust_dir_to_attitude(dir2), att_no_yaw)
    angvel2 = torch.cat([angvel2[:2], radio_floats[3:4]])
    torque2 = controllers.angvel_control(p.angvel_tc_xy, p.angvel_tc_z, p.inertia,
                                         angvel2, est_angvel)
    acc_cutoff = cmd_acc[2] < (-9.81 / 2)  # "magic number" kill-switch
    forces_acc = torch.where(acc_cutoff, zero4,
                             mixer.motor_forces(p, thrust_acc * p.mass, torque2))

    # EXTERNAL_RATES (cpp:528-541)
    torque3 = controllers.angvel_control(p.angvel_tc_xy, p.angvel_tc_z, p.inertia,
                                         radio_floats[1:4], est_angvel)
    forces_rates = mixer.motor_forces(p, radio_floats[0] * p.mass, torque3)

    forces = torch.where(fs == FS_FULLY_AUTONOMOUS, forces_auto, zero4)
    forces = torch.where(fs == FS_EXTERNAL_ACCELERATION_CONTROL, forces_acc, forces)
    forces = torch.where(fs == FS_EXTERNAL_RATES_CONTROL, forces_rates, forces)

    speeds = mixer.speeds_from_forces(p, forces, s.prop_cal_factors)
    zero_out = ((fs == FS_IDLE) | (fs == FS_PANIC) | (fs == FS_KILLED) | (fs == FS_UNINITIALIZED)
                | ((fs == FS_EXTERNAL_ACCELERATION_CONTROL) & acc_cutoff))
    speeds = torch.where(zero_out, zero4, speeds)
    forces = torch.where(zero_out, zero4, forces)

    # motor test mode overrides the state machine (QuadcopterLogic.cpp:181-191)
    torque_test = controllers.angvel_control(p.angvel_tc_xy, p.angvel_tc_z, p.inertia,
                                             torch.zeros_like(est_angvel), est_angvel)
    forces_test = mixer.motor_forces(p, s.test_motors_frac * 9.81 * p.mass, torque_test)
    speeds_test = mixer.speeds_from_forces(p, forces_test, s.prop_cal_factors)
    forces = torch.where(s.test_motors_on, forces_test, forces)
    speeds = torch.where(s.test_motors_on, speeds_test, speeds)

    # propeller calibration (cpp:543-588)
    in_rates = fs == FS_EXTERNAL_RATES_CONTROL
    cal_flag = in_rates & ((radio_flags & radio.FLAG_CALIBRATE_MOTORS) != 0)
    starting = cal_flag & ~s.prop_cal_running
    accum = torch.where(starting, zero4, s.prop_cal_accum)
    count = torch.where(starting, torch.zeros_like(s.prop_cal_count), s.prop_cal_count)
    accum = torch.where(cal_flag, accum + p.prop_thrust_from_speed_sqr * speeds * speeds, accum)
    count = torch.where(cal_flag, count + 1, count)
    finishing = in_rates & ~cal_flag & s.prop_cal_running
    done = finishing & (count >= 750)
    new_factors = torch.clamp(
        count.to(torch.float32) * (p.mass * 9.81 / 4.0)
        / torch.where(accum != 0, accum, torch.ones_like(accum)), 0.7, 1.0 / 0.7)
    running = torch.where(cal_flag, True, torch.where(finishing, False, s.prop_cal_running))

    new_state = s._replace(
        fs=fs, cycle_count=cycle, kf=kf,
        acc_lp=acc_lp, gyro_lp=gyro_lp, temp_lp=temp_lp, batt_lp=batt_lp, gyro_raw=gyro_raw,
        gyro_cal_accum=gyro_cal_accum, gyro_cal_count=gyro_cal_count,
        radio_new=torch.zeros_like(radio_pending),
        radio_type=radio_type, radio_flags=radio_flags, radio_floats=radio_floats,
        radio_count=radio_count, us_since_radio=us_since_radio, us_since_uwb=us_since_uwb,
        next_target_idx=next_target_idx, uwb_meas_count=uwb_meas_count,
        cmd_rate_lpdt=cmd_rate_lpdt, loop_lpdt=loop_lpdt,
        us_since_est_reset=us_since_est_reset, last_check_num_resets=kf.num_resets,
        warnings=warnings, panic_reason=panic_reason,
        des_motor_speeds=speeds, des_motor_forces=forces,
        prop_cal_running=running,
        prop_cal_factors=torch.where(done, new_factors, s.prop_cal_factors),
        prop_cal_accum=accum, prop_cal_count=count,
        should_write_params=s.should_write_params | done,
        batt_voltage=u.batt_voltage, batt_current=u.batt_current,
        debug=debug,
    )
    return new_state, speeds


def set_gyro_calibration(s: LogicState, enable: bool) -> LogicState:
    """Start or stop the gyro-bias calibration (QuadcopterLogic.hpp:118-146):
    stopping a calibration that gathered samples sets the bias to their mean."""
    enable = torch.as_tensor(enable, dtype=torch.bool, device=s.gyro_cal_enabled.device)
    ending = s.gyro_cal_enabled & ~enable
    n = torch.clamp(s.gyro_cal_count, min=1).to(torch.float32)
    bias = torch.where(ending & (s.gyro_cal_count > 0), s.gyro_cal_accum / n, s.gyro_bias)
    return s._replace(gyro_cal_enabled=enable, gyro_bias=bias)


FS_NAMES = {
    FS_UNINITIALIZED: "FS_UNINITIALIZED",
    FS_IDLE: "FS_IDLE",
    FS_FULLY_AUTONOMOUS: "FS_FULLY_AUTONOMOUS",
    FS_PANIC: "FS_PANIC",
    FS_KILLED: "FS_KILLED",
    FS_EXTERNAL_ACCELERATION_CONTROL: "FS_EXTERNAL_ACCELERATION_CONTROL",
    FS_EXTERNAL_RATES_CONTROL: "FS_EXTERNAL_RATES_CONTROL",
}


def format_status(p: LogicParams, s: LogicState, vehicle_id=0) -> str:
    """Host-side debug dump of one vehicle's onboard state: the
    PrintStatus() report (QuadcopterLogic.cpp:681-826) as a string."""

    def arr(t):
        return t.detach().cpu().numpy()

    acc = arr(filters.lp2_value(s.acc_lp))
    gyro = arr(filters.lp2_value(s.gyro_lp))
    y, pch, r = (float(x) for x in rot.to_euler_ypr(s.kf.att))
    lines = [
        f"Quad logic status over {int(s.cycle_count)} cycles "
        f"(avg dt = {float(s.loop_lpdt):.5f}, expected = {float(p.onboard_period):.5f})",
        f"Vehicle id = {vehicle_id}",
        f"\tState = {FS_NAMES.get(int(s.fs), int(s.fs))}",
        f"\tBattery: {float(s.batt_voltage):.3f}V "
        f"(filtered {float(filters.lp2_value(s.batt_lp)):.3f}V), {float(s.batt_current):.3f}A",
        f"\tAccelerometer = ({acc[0]:.3f}, {acc[1]:.3f}, {acc[2]:.3f}) m/s^2",
        f"\tRate gyro     = ({gyro[0]:.3f}, {gyro[1]:.3f}, {gyro[2]:.3f}) rad/s",
        f"\tGyro bias     = {arr(s.gyro_bias).round(4).tolist()}",
        f"\tEstimator: init imu={bool(s.kf.imu_init)} uwb={bool(s.kf.uwb_init)}",
        f"\t\tpos = {arr(s.kf.pos).round(3).tolist()} m",
        f"\t\tvel = {arr(s.kf.vel).round(3).tolist()} m/s",
        f"\t\tatt YPR = ({y:.3f}, {pch:.3f}, {r:.3f}) rad",
        f"\t\tangVel = {arr(s.kf.angvel).round(3).tolist()} rad/s",
        f"\t\trejected = {int(s.kf.num_rejected)}, resets = {int(s.kf.num_resets)}",
        f"\tUWB: meas = {int(s.uwb_meas_count)}, next target idx = {int(s.next_target_idx)}",
        f"\tDesired motor speeds = {arr(s.des_motor_speeds).round(2).tolist()}",
        f"\tPropeller correction = {arr(s.prop_cal_factors).round(3).tolist()}",
        f"\tRadio: count = {int(s.radio_count)}, type = {int(s.radio_type)}, "
        f"flags = {int(s.radio_flags)}, cmd dt = {float(s.cmd_rate_lpdt):.5f}s",
        f"\tTelemetry sent = {int(s.tel_counter)}",
        f"\tDebug = {arr(s.debug).round(3).tolist()}",
        f"\tPanic = {PANIC_REASON_NAMES.get(int(s.panic_reason), int(s.panic_reason))}",
        f"\tWarnings = {int(s.warnings):#04x}",
    ]
    return "\n".join(lines)
