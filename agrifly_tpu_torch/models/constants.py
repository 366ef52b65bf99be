"""Vehicle parameter database: the 5 quadcopter presets.

The port's own copy of `agrifly_tpu/models/constants.py` (the port imports
nothing of the JAX package): a frozen dataclass of python floats with the
reference presets (Components/Components/Logic/QuadcopterConstants.hpp:16-332),
including the derived max motor speeds from the PWM calibration maps
(QuadcopterConstants.hpp:370-406). Plain Python and numpy.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

QC_TYPE_INVALID = 0
QC_TYPE_CF_STANDARD = 1
QC_TYPE_CF_BIGMOTORSPROPS = 2
QC_TYPE_CF_FEEDTHROUGH = 3
QC_TYPE_CF_LARGEQUAD = 4
QC_TYPE_CF_MINIQUAD = 5

CF_BRUSHED_MOTORS = 0
ESC_MOTORS = 1

_PER_CELL_LOW_VOLTAGE = 3.0  # [V]


def _max_cf_speed(k):
    """Max crazyflie prop speed from PWM map at full charge (PWM=255, 4.1V)."""
    max_pwm, max_batt = 255, 4.1
    k1 = k[0][0] + k[0][1] * max_batt
    k2 = k[1][0] + k[1][1] * max_batt
    k3 = k[2][0] + k[2][1] * max_batt
    return (-k2 + math.sqrt(k2 * k2 - 4 * k3 * (k1 - max_pwm))) / (2 * k3)


def _max_esc_speed(k):
    """Max ESC motor speed from the linear speed->PWM map (PWM cap 2000)."""
    return (2000.0 - k[0]) / k[1]


@dataclasses.dataclass(frozen=True)
class VehicleParams:
    """Physical + control constants for one vehicle type (host-side floats)."""

    quad_type: int
    valid: bool
    mass: float
    inertia_xx: float
    inertia_zz: float
    arm_length: float
    prop_thrust_from_speed_sqr: float  # kf [N/(rad/s)^2]
    prop_torque_from_thrust: float  # [N.m/N]
    prop0_spin_dir: int
    max_thrust_per_prop: float
    min_thrust_per_prop: float
    max_cmd_total_thrust: float
    motor_type: int
    motor_time_const: float
    motor_inertia: float
    motor_min_speed: float
    motor_max_speed: float
    lin_drag_coeff_b: tuple  # (bx, by, bz) [N/(m/s)]
    low_battery_threshold: float
    # controller gains
    pos_control_nat_freq: float
    pos_control_damping: float
    angvel_control_tc_xy: float
    att_control_tc_xy: float
    angvel_control_tc_z: float
    att_control_tc_z: float
    # IMU mounting
    imu_yaw: float = 0.0
    imu_pitch: float = 0.0
    imu_roll: float = 0.0

    @property
    def inertia_matrix(self):
        # float64 on purpose: every consumer casts to its working dtype, and
        # the C++-golden f64 teacher-forced tests need the exact double values
        return np.diag([self.inertia_xx, self.inertia_xx, self.inertia_zz])

    @property
    def prop_torque_from_speed_sqr(self):
        # how the apps derive the motor's aero-drag constant
        # (Simulator/Rappids_Simulator/main.cpp:158)
        return self.prop_torque_from_thrust * self.prop_thrust_from_speed_sqr


def _base(**kw):
    defaults = dict(
        pos_control_nat_freq=2.0,
        pos_control_damping=0.7,
        angvel_control_tc_xy=0.03,
        att_control_tc_xy=0.20,
        angvel_control_tc_z=0.5,
        att_control_tc_z=1.0,
        motor_time_const=0.0,
        motor_inertia=0.0,
        motor_min_speed=0.0,
        motor_max_speed=10000.0,
        min_thrust_per_prop=0.0,
        imu_yaw=0.0,
        imu_pitch=0.0,
        imu_roll=0.0,
    )
    defaults.update(kw)
    return VehicleParams(**defaults)


def vehicle_params(quad_type: int) -> VehicleParams:
    """Replicates the 5 presets of QuadcopterConstants.hpp:53-267."""
    if quad_type == QC_TYPE_CF_STANDARD:
        kf = 3.58e-8
        cf_consts = [[-86.19993685, 22.87189816], [0.30208677, -0.07345602],
                     [-1.59346434e-05, 1.53209239e-05]]
        max_speed = _max_cf_speed(cf_consts)
        max_thrust = kf * max_speed**2
        return _base(
            quad_type=quad_type, valid=True, mass=38e-3,
            inertia_xx=16e-6, inertia_zz=29e-6, arm_length=46e-3,
            prop_thrust_from_speed_sqr=kf, prop_torque_from_thrust=0.0006,
            prop0_spin_dir=1, motor_type=CF_BRUSHED_MOTORS,
            motor_max_speed=max_speed, max_thrust_per_prop=max_thrust,
            max_cmd_total_thrust=0.9 * max_thrust * 4,
            angvel_control_tc_xy=0.04, att_control_tc_xy=0.40,
            low_battery_threshold=1 * _PER_CELL_LOW_VOLTAGE,
            lin_drag_coeff_b=(0.0, 0.0, 0.0),
        )
    if quad_type == QC_TYPE_CF_BIGMOTORSPROPS:
        kf = 4.14e-8
        cf_consts = [[-379.31113434, 84.84738207], [0.65309704, -0.13852527],
                     [-1.34462353e-04, 3.57662798e-05]]
        max_speed = _max_cf_speed(cf_consts)
        max_thrust = kf * max_speed**2
        return _base(
            quad_type=quad_type, valid=True, mass=39e-3,
            inertia_xx=30e-6, inertia_zz=60e-6, arm_length=48e-3,
            prop_thrust_from_speed_sqr=kf, prop_torque_from_thrust=0.001,
            prop0_spin_dir=1, motor_type=CF_BRUSHED_MOTORS,
            motor_max_speed=max_speed, max_thrust_per_prop=max_thrust,
            max_cmd_total_thrust=0.8 * max_thrust * 4,
            low_battery_threshold=1 * _PER_CELL_LOW_VOLTAGE,
            lin_drag_coeff_b=(0.0206185, 0.0216621, 0.0),
        )
    if quad_type == QC_TYPE_CF_LARGEQUAD:
        kf = 7.64e-6
        esc = [972.0, 0.742]
        max_speed = _max_esc_speed(esc)
        max_thrust = kf * max_speed**2
        return _base(
            quad_type=quad_type, valid=True, mass=0.760,
            inertia_xx=0.004406, inertia_zz=0.008611, arm_length=0.166,
            prop_thrust_from_speed_sqr=kf, prop_torque_from_thrust=0.0140,
            prop0_spin_dir=1, motor_type=ESC_MOTORS,
            motor_max_speed=max_speed, max_thrust_per_prop=max_thrust,
            max_cmd_total_thrust=4 * max_thrust * 0.8,  # mixer default margin
            angvel_control_tc_xy=0.0457, att_control_tc_xy=0.0914,
            angvel_control_tc_z=0.2545, att_control_tc_z=0.5089,
            low_battery_threshold=3 * _PER_CELL_LOW_VOLTAGE,
            lin_drag_coeff_b=(0.1286181, 0.1286181, 0.1286181),
        )
    if quad_type == QC_TYPE_CF_MINIQUAD:
        kf = 4.32e-8
        esc = [999.0, 0.14]
        max_speed = _max_esc_speed(esc)
        max_thrust = kf * max_speed**2
        tc_xy = 0.04
        tc_z = tc_xy * 5
        return _base(
            quad_type=quad_type, valid=True, mass=0.142,
            inertia_xx=92.7e-6, inertia_zz=158.57e-6, arm_length=58e-3,
            prop_thrust_from_speed_sqr=kf, prop_torque_from_thrust=0.00808,
            prop0_spin_dir=1, motor_type=ESC_MOTORS,
            motor_max_speed=max_speed, max_thrust_per_prop=max_thrust,
            min_thrust_per_prop=0.03, max_cmd_total_thrust=0.7 * max_thrust * 4,
            angvel_control_tc_xy=tc_xy, att_control_tc_xy=tc_xy * 2,
            angvel_control_tc_z=tc_z, att_control_tc_z=tc_z * 2,
            low_battery_threshold=2 * _PER_CELL_LOW_VOLTAGE,
            lin_drag_coeff_b=(0.0, 0.0, 0.0),
        )
    # QC_TYPE_CF_FEEDTHROUGH and anything unknown: invalid placeholder
    return _base(
        quad_type=quad_type, valid=False, mass=1.0,
        inertia_xx=1.0, inertia_zz=1.0, arm_length=1.0,
        prop_thrust_from_speed_sqr=0.0, prop_torque_from_thrust=0.0,
        prop0_spin_dir=0, motor_type=CF_BRUSHED_MOTORS,
        motor_max_speed=0.0, max_thrust_per_prop=0.0,
        max_cmd_total_thrust=0.0,
        low_battery_threshold=1 * _PER_CELL_LOW_VOLTAGE,
        lin_drag_coeff_b=(0.0, 0.0, 0.0),
    )
