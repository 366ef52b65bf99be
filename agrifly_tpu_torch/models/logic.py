"""Onboard flight-controller logic as one step function.

Port of `agrifly_tpu/models/logic.py` (QuadcopterLogic.{hpp,cpp}): the
500 Hz onboard loop as `logic_step(params, state, inputs) -> (state,
motor_cmds)` over a NamedTuple state. Every controller branch is computed
and the flight state selects one, as in the JAX package. The slice flies
without UWB ranging, so the range update is not ported.
"""

from __future__ import annotations

import math
from typing import NamedTuple

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
    )


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
    radio_pending = s.radio_new | u.radio_new

    # Run()
    cycle = s.cycle_count + 1
    loop_lpdt = p.loop_lp_coeff * s.loop_lpdt + (1.0 - p.loop_lp_coeff) * p.onboard_period
    gyro_f = filters.lp2_value(gyro_lp)
    acc_f = filters.lp2_value(acc_lp)

    # UpdateEstimator (no UWB in this configuration: no range update)
    kf = ekf.predict(s.kf, gyro_f, acc_f, p.onboard_period)
    cal_on = s.gyro_cal_enabled
    gyro_cal_accum = torch.where(cal_on, s.gyro_cal_accum + gyro_raw, s.gyro_cal_accum)
    gyro_cal_count = s.gyro_cal_count + cal_on.to(torch.int32)

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
