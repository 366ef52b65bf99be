// The device functions of one 2 ms tick of sim/env, shared by the tick
// kernels: frame.cu (K3/K3b, the orchard frame's 16 ticks) and rollout.cu
// (K5, the env rollout, in every estimator mode: the true state, mocap, or
// the GPS-IMU estimator). Each section mirrors the torch module of
// agrifly_tpu_torch it is named after, with the same float32 operations in
// the same order (the build flags of cuda_build.py: -fmad=false, no fast
// math, IEEE division and sqrtf; sin, cos and exp through double, sin_r).
// The Cephes polynomials of ops/trig.py stand in for acosf/asinf/atan2f.
// Every branch that torch computes and discards with `where` is computed
// here only when it is selected: the result is the same.
//
// The env state's and parameters' leaves are declared in two X-macro tables
// below, the contract with the Python wrappers, which parse them
// (cuda_build.leaf_rows): the order, dtype and element count (0 for a 0-d
// tensor) of the leaves of sim/env's EnvState (convert.leaves order) and of
// the EnvParams leaves the tick reads. W state leaves are written back; P
// leaves pass through (the wrappers return the input tensors). The paths
// are relative to EnvState / EnvParams; frame.cu nests them under `base`.
//
// UWB is a variant of the build: with TICK_UWB defined, EnvState and
// EnvParams also hold the ENV_UWB_* tables' leaves (the ranging network's
// state and parameters), and the tick steps the network on its four draws
// and runs the onboard EKF's range update. TICK_RANGING alone is the
// onboard half of it (the logic's range update, its 32-target lookup and the
// us_since_uwb reset) for a vehicle whose network is stepped outside
// (fleet_uwb.cu's shared network); TICK_UWB implies it. Wind is another
// variant: with TICK_WIND defined, EnvState holds the ENV_WIND_* state leaf
// (sim/fleet_env.py's per-vehicle gust velocity) and EnvParams its
// WindParams, and wind_force runs the gust process in front of the tick.
// frame.cu builds with none of them.
//
// An including file may define SECTION_BEGIN / SECTION_END (the clock64
// section timers of frame.cu and rollout.cu, over their Section enums)
// before the include; otherwise they are empty.
//
// The mocap replay's nine segments (each one's decay and rotation) are
// independent, and the functions on the way to them take a helper object
// `hp` that spreads them over lanes: K3's Helpers (lane 0 runs the chain;
// lanes 1-9 wait in help() for the segments) or K5's Lanes<G> (a group of G
// lanes runs one vehicle's chain in lockstep and splits the segments over
// its lanes). Every lane computes its segments with the serial loop's
// operations, so a split changes no value.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#ifndef SECTION_BEGIN
#define SECTION_BEGIN(k)
#define SECTION_END(k)
#endif

// clang-format off
#define ENV_STATE_LEAVES(X) \
  X(plant_pos, "plant.pos", F32, 3, W)                                    \
  X(plant_vel, "plant.vel", F32, 3, W)                                    \
  X(plant_att, "plant.att", F32, 4, W)                                    \
  X(plant_angvel, "plant.angvel", F32, 3, W)                              \
  X(plant_motor_speeds, "plant.motor_speeds", F32, 4, W)                  \
  X(fs, "logic.fs", I32, 0, W)                                            \
  X(cycle_count, "logic.cycle_count", I32, 0, W)                          \
  X(kf_pos, "logic.kf.pos", F32, 3, W)                                    \
  X(kf_vel, "logic.kf.vel", F32, 3, W)                                    \
  X(kf_att, "logic.kf.att", F32, 4, W)                                    \
  X(kf_angvel, "logic.kf.angvel", F32, 3, W)                              \
  X(kf_cov, "logic.kf.cov", F32, 81, W)                                   \
  X(kf_imu_init, "logic.kf.imu_init", BOOL, 0, W)                         \
  X(kf_uwb_init, "logic.kf.uwb_init", BOOL, 0, W)                         \
  X(kf_last_att_corr, "logic.kf.last_att_corr", F32, 3, W)                \
  X(kf_num_rejected, "logic.kf.num_rejected", I32, 0, W)                  \
  X(kf_num_rejected_seq, "logic.kf.num_rejected_seq", I32, 0, W)          \
  X(kf_num_resets, "logic.kf.num_resets", I32, 0, W)                      \
  X(acc_lp_xm0, "logic.acc_lp.xm0", F32, 3, W)                            \
  X(acc_lp_xm1, "logic.acc_lp.xm1", F32, 3, W)                            \
  X(acc_lp_ym0, "logic.acc_lp.ym0", F32, 3, W)                            \
  X(acc_lp_ym1, "logic.acc_lp.ym1", F32, 3, W)                            \
  X(gyro_lp_xm0, "logic.gyro_lp.xm0", F32, 3, W)                          \
  X(gyro_lp_xm1, "logic.gyro_lp.xm1", F32, 3, W)                          \
  X(gyro_lp_ym0, "logic.gyro_lp.ym0", F32, 3, W)                          \
  X(gyro_lp_ym1, "logic.gyro_lp.ym1", F32, 3, W)                          \
  X(temp_lp_xm0, "logic.temp_lp.xm0", F32, 0, W)                          \
  X(temp_lp_xm1, "logic.temp_lp.xm1", F32, 0, W)                          \
  X(temp_lp_ym0, "logic.temp_lp.ym0", F32, 0, W)                          \
  X(temp_lp_ym1, "logic.temp_lp.ym1", F32, 0, W)                          \
  X(batt_lp_xm0, "logic.batt_lp.xm0", F32, 0, W)                          \
  X(batt_lp_xm1, "logic.batt_lp.xm1", F32, 0, W)                          \
  X(batt_lp_ym0, "logic.batt_lp.ym0", F32, 0, W)                          \
  X(batt_lp_ym1, "logic.batt_lp.ym1", F32, 0, W)                          \
  X(gyro_raw, "logic.gyro_raw", F32, 3, W)                                \
  X(gyro_bias, "logic.gyro_bias", F32, 3, W)                              \
  X(gyro_cal_enabled, "logic.gyro_cal_enabled", BOOL, 0, W)               \
  X(gyro_cal_accum, "logic.gyro_cal_accum", F32, 3, W)                    \
  X(gyro_cal_count, "logic.gyro_cal_count", I32, 0, W)                    \
  X(radio_new, "logic.radio_new", BOOL, 0, W)                             \
  X(radio_type, "logic.radio_type", I32, 0, W)                            \
  X(radio_flags, "logic.radio_flags", I32, 0, W)                          \
  X(radio_floats, "logic.radio_floats", F32, 10, W)                       \
  X(radio_count, "logic.radio_count", I32, 0, W)                          \
  X(us_since_radio, "logic.us_since_radio", I32, 0, W)                    \
  X(us_since_uwb, "logic.us_since_uwb", I32, 0, W)                        \
  X(next_target_idx, "logic.next_target_idx", I32, 0, W)                  \
  X(uwb_meas_count, "logic.uwb_meas_count", I32, 0, W)                    \
  X(cmd_rate_lpdt, "logic.cmd_rate_lpdt", F32, 0, W)                      \
  X(loop_lpdt, "logic.loop_lpdt", F32, 0, W)                              \
  X(us_since_est_reset, "logic.us_since_est_reset", I32, 0, W)            \
  X(last_check_num_resets, "logic.last_check_num_resets", I32, 0, W)      \
  X(warnings, "logic.warnings", I32, 0, W)                                \
  X(panic_reason, "logic.panic_reason", I32, 0, W)                        \
  X(des_motor_speeds, "logic.des_motor_speeds", F32, 4, W)                \
  X(des_motor_forces, "logic.des_motor_forces", F32, 4, W)                \
  X(prop_cal_running, "logic.prop_cal_running", BOOL, 0, W)               \
  X(prop_cal_factors, "logic.prop_cal_factors", F32, 4, W)                \
  X(prop_cal_accum, "logic.prop_cal_accum", F32, 4, W)                    \
  X(prop_cal_count, "logic.prop_cal_count", I32, 0, W)                    \
  X(should_write_params, "logic.should_write_params", BOOL, 0, W)         \
  X(batt_voltage, "logic.batt_voltage", F32, 0, W)                        \
  X(batt_current, "logic.batt_current", F32, 0, W)                        \
  X(test_motors_on, "logic.test_motors_on", BOOL, 0, W)                   \
  X(test_motors_frac, "logic.test_motors_frac", F32, 0, W)                \
  X(tel_counter, "logic.tel_counter", I32, 0, W)                          \
  X(debug, "logic.debug", F32, 6, W)                                      \
  X(ring_types, "ring.types", I32, 32, W)                                 \
  X(ring_flags, "ring.flags", I32, 32, W)                                 \
  X(ring_fields, "ring.fields", I32, 320, W)                              \
  X(ring_send_step, "ring.send_step", I32, 32, W)                         \
  X(ring_head, "ring.head", I32, 0, W)                                    \
  X(ring_count, "ring.count", I32, 0, W)                                  \
  X(offboard_acc_us, "offboard_acc_us", I32, 0, W)                        \
  X(step, "step", I32, 0, W)                                              \
  X(last_cmd_thrust, "last_cmd_thrust", F32, 0, W)                        \
  X(last_cmd_angvel, "last_cmd_angvel", F32, 3, W)                        \
  X(mc_initialized, "mocap.initialized", BOOL, 0, W)                      \
  X(mc_pos, "mocap.pos", F32, 3, W)                                       \
  X(mc_vel, "mocap.vel", F32, 3, W)                                       \
  X(mc_att, "mocap.att", F32, 4, W)                                       \
  X(mc_angvel, "mocap.angvel", F32, 3, W)                                 \
  X(mc_var_pos, "mocap.var_pos", F32, 4, W)                               \
  X(mc_var_att, "mocap.var_att", F32, 4, W)                               \
  X(mc_estimate_us, "mocap.estimate_us", I32, 0, W)                       \
  X(mc_us_since_good_meas, "mocap.us_since_good_meas", I32, 0, W)         \
  X(mc_num_rejected, "mocap.num_rejected", I32, 0, W)                     \
  X(mc_num_rejected_consec, "mocap.num_rejected_consec", I32, 0, W)       \
  X(pipe_active_us, "mocap.pipe.active_us", I32, 8, W)                    \
  X(pipe_acc, "mocap.pipe.acc", F32, 24, W)                               \
  X(pipe_angvel, "mocap.pipe.angvel", F32, 24, W)                         \
  X(pipe_ballistic, "mocap.pipe.ballistic", I32, 8, W)                    \
  X(pipe_head, "mocap.pipe.head", I32, 0, W)                              \
  X(pipe_count, "mocap.pipe.count", I32, 0, W)                            \
  X(mocap_acc_us, "mocap_acc_us", I32, 0, W)                              \
  X(gps_pos, "gpsimu.pos", F32, 3, P)                                     \
  X(gps_vel, "gpsimu.vel", F32, 3, P)                                     \
  X(gps_att, "gpsimu.att", F32, 4, P)                                     \
  X(gps_angvel, "gpsimu.angvel", F32, 3, P)                               \
  X(gps_cov, "gpsimu.cov", F32, 81, P)                                    \
  X(gps_imu_init, "gpsimu.imu_init", BOOL, 0, P)                          \
  X(gps_uwb_init, "gpsimu.uwb_init", BOOL, 0, P)                          \
  X(gps_last_att_corr, "gpsimu.last_att_corr", F32, 3, P)                 \
  X(gps_num_rejected, "gpsimu.num_rejected", I32, 0, P)                   \
  X(gps_num_rejected_seq, "gpsimu.num_rejected_seq", I32, 0, P)           \
  X(gps_num_resets, "gpsimu.num_resets", I32, 0, P)                       \
  X(gps_acc_us, "gps_acc_us", I32, 0, W)

#define ENV_PARAM_LEAVES(X) \
  X(p_mass, "plant.mass", F32, 0)                                         \
  X(p_inertia, "plant.inertia", F32, 9)                                   \
  X(p_inertia_inv, "plant.inertia_inv", F32, 9)                           \
  X(p_motor_positions, "plant.motor_positions", F32, 12)                  \
  X(p_kf, "plant.kf", F32, 0)                                             \
  X(p_kt_sqr, "plant.kt_sqr", F32, 0)                                     \
  X(p_motor_time_const, "plant.motor_time_const", F32, 0)                 \
  X(p_motor_inertia, "plant.motor_inertia", F32, 0)                       \
  X(p_motor_min_speed, "plant.motor_min_speed", F32, 0)                   \
  X(p_motor_max_speed, "plant.motor_max_speed", F32, 0)                   \
  X(p_lin_drag_b, "plant.lin_drag_b", F32, 3)                             \
  X(p_imu_rot_inv, "plant.imu_rot_inv", F32, 9)                           \
  X(l_valid, "logic.valid", BOOL, 0)                                      \
  X(l_mass, "logic.mass", F32, 0)                                         \
  X(l_arm_length, "logic.arm_length", F32, 0)                             \
  X(l_prop_thrust_from_speed_sqr, "logic.prop_thrust_from_speed_sqr", F32, 0) \
  X(l_prop_torque_from_thrust, "logic.prop_torque_from_thrust", F32, 0)   \
  X(l_prop0_spin_dir, "logic.prop0_spin_dir", F32, 0)                     \
  X(l_max_thrust_per_prop, "logic.max_thrust_per_prop", F32, 0)           \
  X(l_min_thrust_per_prop, "logic.min_thrust_per_prop", F32, 0)           \
  X(l_max_cmd_total_thrust, "logic.max_cmd_total_thrust", F32, 0)         \
  X(l_pos_nat_freq, "logic.pos_nat_freq", F32, 0)                         \
  X(l_pos_damping, "logic.pos_damping", F32, 0)                           \
  X(l_att_tc_xy, "logic.att_tc_xy", F32, 0)                               \
  X(l_att_tc_z, "logic.att_tc_z", F32, 0)                                 \
  X(l_angvel_tc_xy, "logic.angvel_tc_xy", F32, 0)                         \
  X(l_angvel_tc_z, "logic.angvel_tc_z", F32, 0)                           \
  X(l_inertia, "logic.inertia", F32, 9)                                   \
  X(l_imu_rot, "logic.imu_rot", F32, 9)                                   \
  X(l_batt_critical, "logic.batt_critical", F32, 0)                       \
  X(l_batt_warning, "logic.batt_warning", F32, 0)                         \
  X(l_onboard_period, "logic.onboard_period", F32, 0)                     \
  X(l_onboard_period_us, "logic.onboard_period_us", I32, 0)               \
  X(l_acc_lp_a1, "logic.acc_lp.a1", F32, 0)                               \
  X(l_acc_lp_a2, "logic.acc_lp.a2", F32, 0)                               \
  X(l_acc_lp_b0, "logic.acc_lp.b0", F32, 0)                               \
  X(l_acc_lp_b1, "logic.acc_lp.b1", F32, 0)                               \
  X(l_acc_lp_b2, "logic.acc_lp.b2", F32, 0)                               \
  X(l_gyro_lp_a1, "logic.gyro_lp.a1", F32, 0)                             \
  X(l_gyro_lp_a2, "logic.gyro_lp.a2", F32, 0)                             \
  X(l_gyro_lp_b0, "logic.gyro_lp.b0", F32, 0)                             \
  X(l_gyro_lp_b1, "logic.gyro_lp.b1", F32, 0)                             \
  X(l_gyro_lp_b2, "logic.gyro_lp.b2", F32, 0)                             \
  X(l_temp_lp_a1, "logic.temp_lp.a1", F32, 0)                             \
  X(l_temp_lp_a2, "logic.temp_lp.a2", F32, 0)                             \
  X(l_temp_lp_b0, "logic.temp_lp.b0", F32, 0)                             \
  X(l_temp_lp_b1, "logic.temp_lp.b1", F32, 0)                             \
  X(l_temp_lp_b2, "logic.temp_lp.b2", F32, 0)                             \
  X(l_batt_lp_a1, "logic.batt_lp.a1", F32, 0)                             \
  X(l_batt_lp_a2, "logic.batt_lp.a2", F32, 0)                             \
  X(l_batt_lp_b0, "logic.batt_lp.b0", F32, 0)                             \
  X(l_batt_lp_b1, "logic.batt_lp.b1", F32, 0)                             \
  X(l_batt_lp_b2, "logic.batt_lp.b2", F32, 0)                             \
  X(l_cmd_rate_lp_coeff, "logic.cmd_rate_lp_coeff", F32, 0)               \
  X(l_loop_lp_coeff, "logic.loop_lp_coeff", F32, 0)                       \
  X(l_target_positions, "logic.target_positions", F32, 96)               \
  X(l_target_ids, "logic.target_ids", I32, 32)                            \
  X(l_num_targets, "logic.num_targets", I32, 0)                           \
  X(c_pos_nat_freq, "ctrl.pos_nat_freq", F32, 0)                          \
  X(c_pos_damping, "ctrl.pos_damping", F32, 0)                            \
  X(c_att_tc_xy, "ctrl.att_tc_xy", F32, 0)                                \
  X(c_att_tc_z, "ctrl.att_tc_z", F32, 0)                                  \
  X(c_min_vertical_proper_acc, "ctrl.min_vertical_proper_acc", F32, 0)    \
  X(c_max_proper_acc, "ctrl.max_proper_acc", F32, 0)                      \
  X(c_min_proper_acc, "ctrl.min_proper_acc", F32, 0)                      \
  X(dt_us, "dt_us", I32, 0)                                               \
  X(offboard_period_us, "offboard_period_us", I32, 0)                     \
  X(radio_delay_us, "radio_delay_us", I32, 0)                             \
  X(noise_scale, "noise_scale", F32, 0)                                   \
  X(mocap_period_us, "mocap_period_us", I32, 0)                           \
  X(est_latency_us, "est_latency_us", I32, 0)

// The UWB variant's leaves (sim/uwb.py's UwbState and UwbParams, after the
// others in EnvState / EnvParams), in the struct only where TICK_UWB is
// defined. The radio table is padded to kMaxRadios (the vehicle and up to 32
// anchors) on the host.
#define ENV_UWB_STATE_LEAVES(X) \
  X(uwb_acc_us, "uwb.acc_us", I32, 0, W)                                  \
  X(uwb_pending, "uwb.pending", BOOL, 0, W)                               \
  X(uwb_requester_id, "uwb.requester_id", I32, 0, W)                      \
  X(uwb_responder_id, "uwb.responder_id", I32, 0, W)

#define ENV_UWB_PARAM_LEAVES(X) \
  X(u_comm_period_us, "uwb.comm_period_us", I32, 0)                       \
  X(u_noise_std, "uwb.noise_std", F32, 0)                                 \
  X(u_outlier_prob, "uwb.outlier_prob", F32, 0)                           \
  X(u_outlier_std, "uwb.outlier_std", F32, 0)                             \
  X(u_radio_ids, "uwb.radio_ids", I32, 33)                                \
  X(u_num_radios, "uwb.num_radios", I32, 0)                               \
  X(u_failure_prob, "uwb.failure_prob", F32, 0)                           \
  X(u_max_range, "uwb.max_range", F32, 0)

// The wind variant's leaves (sim/fleet_env.py's FleetState.wind_vel and
// WindParams; paths relative to FleetState / FleetParams), after the
// others, in the struct only where TICK_WIND is defined.
#define ENV_WIND_STATE_LEAVES(X) \
  X(wind_vel, "wind_vel", F32, 3, W)

#define ENV_WIND_PARAM_LEAVES(X) \
  X(w_mean, "wind.mean", F32, 3)                                          \
  X(w_gust_std, "wind.gust_std", F32, 0)                                  \
  X(w_gust_tau, "wind.gust_tau", F32, 0)                                  \
  X(w_force_gain, "wind.force_gain", F32, 0)
// clang-format on

#if defined(TICK_UWB) && !defined(TICK_RANGING)
#define TICK_RANGING
#endif

#ifdef TICK_UWB
#define ENV_UWB_STATE_PART(X) ENV_UWB_STATE_LEAVES(X)
#define ENV_UWB_PARAM_PART(X) ENV_UWB_PARAM_LEAVES(X)
#else
#define ENV_UWB_STATE_PART(X)
#define ENV_UWB_PARAM_PART(X)
#endif
#ifdef TICK_WIND
#define ENV_WIND_STATE_PART(X) ENV_WIND_STATE_LEAVES(X)
#define ENV_WIND_PARAM_PART(X) ENV_WIND_PARAM_LEAVES(X)
#else
#define ENV_WIND_STATE_PART(X)
#define ENV_WIND_PARAM_PART(X)
#endif
#define ENV_STATE_ALL(X) ENV_STATE_LEAVES(X) ENV_UWB_STATE_PART(X) ENV_WIND_STATE_PART(X)
#define ENV_PARAM_ALL(X) ENV_PARAM_LEAVES(X) ENV_UWB_PARAM_PART(X) ENV_WIND_PARAM_PART(X)

namespace {

// ---------------------------------------------------------------------------
// the state and parameter structs and their element tables
// ---------------------------------------------------------------------------

typedef float F32_t;
typedef int I32_t;
typedef unsigned char BOOL_t;

template <class T, int N>
struct Leaf { typedef T type[N]; };
template <class T>
struct Leaf<T, 0> { typedef T type; };

#define NUMEL(n) ((n) == 0 ? 1 : (n))

struct EnvState {
#define X(name, path, ty, n, rw) Leaf<ty##_t, n>::type name;
  ENV_STATE_ALL(X)
#undef X
};

struct EnvParams {
#define X(name, path, ty, n) Leaf<ty##_t, n>::type name;
  ENV_PARAM_ALL(X)
#undef X
};

#define COUNT_LEAF(...) +1
#define COUNT_STATE(name, path, ty, n, rw) +NUMEL(n)
#define COUNT_PARAM(name, path, ty, n) +NUMEL(n)
constexpr int kNumEnvState = 0 ENV_STATE_ALL(COUNT_LEAF);
constexpr int kNumEnvParam = 0 ENV_PARAM_ALL(COUNT_LEAF);
constexpr int kEnvStateElems = 0 ENV_STATE_ALL(COUNT_STATE);
constexpr int kEnvParamElems = 0 ENV_PARAM_ALL(COUNT_PARAM);

// One element of a leaf, for the copies between the leaves in device memory
// and a kernel's State and Params structs: its byte offset in the struct,
// its index in the leaf, the leaf's element count, the leaf, its bytes per
// element, and where a written leaf goes (the output buffer kind, and the
// elements of the same kind's written leaves before it).
enum { kOutF32 = 0, kOutI32 = 1, kOutBOOL = 2, kOutNone = 3 };
struct Elem {
  unsigned short dst, i, numel, out_prefix;
  unsigned char leaf, size, out;
};

template <int N>
struct Elems {
  Elem e[N];
};

// Making the tables: inside a constexpr function with locals Elems t and int k,
// leaf and prefix[3], ADD_STATE_ELEMS / ADD_PARAM_ELEMS append one leaf's
// elements at byte `offset` of the struct.
#define IS_WRITTEN_W 1
#define IS_WRITTEN_P 0
#define OUT_OF_F32 kOutF32
#define OUT_OF_I32 kOutI32
#define OUT_OF_BOOL kOutBOOL
#define ADD_STATE_ELEMS(offset, ty, n, rw)                                                    \
  for (int i = 0; i < NUMEL(n); ++i)                                                          \
    t.e[k++] = Elem{static_cast<unsigned short>((offset) + i * sizeof(ty##_t)),               \
                    static_cast<unsigned short>(i), static_cast<unsigned short>(NUMEL(n)),    \
                    static_cast<unsigned short>(IS_WRITTEN_##rw ? prefix[OUT_OF_##ty] : 0),   \
                    static_cast<unsigned char>(leaf), static_cast<unsigned char>(sizeof(ty##_t)), \
                    static_cast<unsigned char>(IS_WRITTEN_##rw ? OUT_OF_##ty : kOutNone)};    \
  if (IS_WRITTEN_##rw) prefix[OUT_OF_##ty] += NUMEL(n);                                       \
  ++leaf;
#define ADD_PARAM_ELEMS(offset, ty, n)                                                        \
  for (int i = 0; i < NUMEL(n); ++i)                                                          \
    t.e[k++] = Elem{static_cast<unsigned short>((offset) + i * sizeof(ty##_t)),               \
                    static_cast<unsigned short>(i), static_cast<unsigned short>(NUMEL(n)), 0, \
                    static_cast<unsigned char>(leaf), static_cast<unsigned char>(sizeof(ty##_t)), \
                    static_cast<unsigned char>(kOutNone)};                                    \
  ++leaf;

// Copies element k, k + stride, ... of row b of the leaves `src` into the
// struct at `dst`, eight elements a round, so each thread keeps eight loads
// in flight.
template <int N>
__device__ void copy_in(char* dst, const void* const* src, const Elems<N>& table, int b, int k,
                        int stride) {
#pragma unroll 8
  for (; k < N; k += stride) {
    const Elem el = table.e[k];
    const char* p = static_cast<const char*>(src[el.leaf]) +
                    (static_cast<int64_t>(b) * el.numel + el.i) * el.size;
    if (el.size == 4)
      *reinterpret_cast<int*>(dst + el.dst) = __ldg(reinterpret_cast<const int*>(p));
    else
      dst[el.dst] = static_cast<char>(__ldg(reinterpret_cast<const unsigned char*>(p)));
  }
}

// Writes the W leaves of row b of the struct at `src` to the three flat
// output buffers, leaf-major by dtype in table order, [B, numel] per leaf;
// element k, k + stride, ... of the table.
template <int N>
__device__ void copy_out(const char* src, const Elems<N>& table, float* out_f, int* out_i,
                         unsigned char* out_b, int B, int b, int k, int stride) {
#pragma unroll 8
  for (; k < N; k += stride) {
    const Elem el = table.e[k];
    if (el.out == kOutNone) continue;
    const int64_t o = static_cast<int64_t>(B) * el.out_prefix + static_cast<int64_t>(b) * el.numel + el.i;
    if (el.out == kOutF32) out_f[o] = *reinterpret_cast<const float*>(src + el.dst);
    else if (el.out == kOutI32) out_i[o] = *reinterpret_cast<const int*>(src + el.dst);
    else out_b[o] = static_cast<unsigned char>(src[el.dst]);
  }
}

// ---------------------------------------------------------------------------
// small vectors; int32 arithmetic that wraps as torch's does
// ---------------------------------------------------------------------------

struct f3 { float x, y, z; };
struct f4 { float w, x, y, z; };
struct m3 { float a[9]; };  // row-major

__device__ __forceinline__ f3 ld3(const float* p) { return f3{p[0], p[1], p[2]}; }
__device__ __forceinline__ void st3(float* p, f3 v) { p[0] = v.x; p[1] = v.y; p[2] = v.z; }
__device__ __forceinline__ f4 ld4(const float* p) { return f4{p[0], p[1], p[2], p[3]}; }
__device__ __forceinline__ void st4(float* p, f4 q) { p[0] = q.w; p[1] = q.x; p[2] = q.y; p[3] = q.z; }
__device__ __forceinline__ m3 ldm(const float* p) {
  m3 m;
  for (int i = 0; i < 9; ++i) m.a[i] = p[i];
  return m;
}

__device__ __forceinline__ f3 add(f3 a, f3 b) { return f3{a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ f3 sub(f3 a, f3 b) { return f3{a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ f3 mul(f3 a, f3 b) { return f3{a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ f3 scl(f3 a, float s) { return f3{a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ f3 dvs(f3 a, float s) { return f3{a.x / s, a.y / s, a.z / s}; }

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}

// torch.minimum / maximum / clamp propagate NaN (fminf/fmaxf do not)
__device__ __forceinline__ float tmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : (a < b ? a : b);
}
__device__ __forceinline__ float tmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : (a > b ? a : b);
}
__device__ __forceinline__ float tclamp(float x, float lo, float hi) { return tmin(tmax(x, lo), hi); }
__device__ __forceinline__ float tsign(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : (isnan(x) ? NAN : 0.0f));
}

// ---------------------------------------------------------------------------
// work split over lanes: out[i] = f(i) for i < N
// ---------------------------------------------------------------------------

// a[i] for an i known only at run time, by selects: a register array indexed
// at run time would go to local memory
template <int N, class T>
__device__ __forceinline__ T pick(const T* a, int i) {
  T v = a[0];
#pragma unroll
  for (int j = 1; j < N; ++j)
    if (i == j) v = a[j];
  return v;
}

// v from lane `src` of the group (`width` lanes, `mask` its lanes in the
// warp), one 32-bit word at a time: T is a float, an int or a struct of them
template <class T>
__device__ __forceinline__ T shfl_group(unsigned mask, T v, int src, int width) {
  static_assert(sizeof(T) % 4 == 0, "shfl_group moves 32-bit words");
  int w[sizeof(T) / 4];
  memcpy(w, &v, sizeof(T));
#pragma unroll
  for (int k = 0; k < static_cast<int>(sizeof(T) / 4); ++k)
    w[k] = __shfl_sync(mask, w[k], src, width);
  memcpy(&v, w, sizeof(T));
  return v;
}

// A group of G lanes (G divides 32; consecutive lanes of a warp) that runs
// one vehicle's tick chain in lockstep: every lane holds the same values, so
// a branch is taken by the whole group, and at a split lane l computes items
// l, l + G, ... and every lane then reads each item from the lane that
// computed it. G = 1 is the serial chain.
template <int G>
struct Lanes {
  int lane;       // this thread's lane in its group
  unsigned mask;  // the group's lanes in the warp

  template <int N, class T, class F>
  __device__ __forceinline__ void map(T (&out)[N], F f) const {
    if constexpr (G == 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) out[i] = f(i);
    } else {
#pragma unroll
      for (int r = 0; r < (N + G - 1) / G; ++r) {
        T v{};
        if (r * G + lane < N) v = f(r * G + lane);
#pragma unroll
        for (int j = 0; j < G; ++j)
          if (r * G + j < N) out[r * G + j] = shfl_group(mask, v, j, G);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// ops/fmath.py: dot3, norm3, cross; ipow in JAX integer_pow's order; sin,
// cos and exp correctly rounded
// ---------------------------------------------------------------------------

__device__ __forceinline__ float dot3(f3 a, f3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ float norm3(f3 a) { return sqrtf(dot3(a, a)); }
__device__ __forceinline__ f3 cross(f3 a, f3 b) {
  return f3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float ipow2(float x) { return x * x; }
__device__ __forceinline__ float ipow3(float x) { return x * (x * x); }
// sin, cos and exp of a float evaluated in double and rounded, as ops/fmath
// computes them on either device: CUDA's sinf, cosf and expf are within 2
// ulp, and the attitude controller's acos of a cosine within ulps of 1 turns
// one ulp into percent of a commanded rate.
__device__ __forceinline__ float sin_r(float x) { return (float)sin((double)x); }
__device__ __forceinline__ float cos_r(float x) { return (float)cos((double)x); }
__device__ __forceinline__ float exp_r(float x) { return (float)exp((double)x); }
__device__ __forceinline__ float ipow4(float x) { float x2 = x * x; return x2 * x2; }
__device__ __forceinline__ float ipow5(float x) { float x2 = x * x; return x * (x2 * x2); }

// ---------------------------------------------------------------------------
// ops/trig.py: Cephes single-precision atan / asin / acos, term for term
// ---------------------------------------------------------------------------

constexpr float kPi = 3.14159265358979323846f;
constexpr float kPio2 = 1.5707963267948966f;
constexpr float kPio4 = 0.7853981633974483f;
constexpr float kTan3Pio8 = 2.414213562373095f;
constexpr float kTanPio8 = 0.4142135623730950f;

__device__ float atan_c(float x) {
  float sign = tsign(x);
  float a = fabsf(x);
  bool big = a > kTan3Pio8;
  bool mid = (a > kTanPio8) && !big;
  float safe_a = a == 0.0f ? 1.0f : a;
  float xr = big ? -(1.0f / safe_a) : (mid ? (a - 1.0f) / (a + 1.0f) : a);
  float y0 = big ? kPio2 : (mid ? kPio4 : 0.0f);
  float z = xr * xr;
  float p = ((((8.05374449538e-2f * z - 1.38776856032e-1f) * z + 1.99777106478e-1f) * z
              - 3.33329491539e-1f) * z) * xr + xr;
  return sign * (y0 + p);
}

__device__ float atan2_c(float y, float x) {
  float safe_x = x == 0.0f ? 1.0f : x;
  float base = atan_c(y / safe_x);
  float corr = y < 0.0f ? -kPi : kPi;
  float out = x < 0.0f ? base + corr : base;
  float pio2 = y > 0.0f ? kPio2 : -kPio2;
  if (x == 0.0f && y != 0.0f) out = pio2;
  if (x == 0.0f && y == 0.0f) out = 0.0f;
  return out;
}

__device__ float asin_core(float a) {
  bool gt_half = a > 0.5f;
  float z = gt_half ? 0.5f * (1.0f - a) : a * a;
  float xr = gt_half ? sqrtf(z) : a;
  float p = (((((4.2163199048e-2f * z + 2.4181311049e-2f) * z + 4.5470025998e-2f) * z
               + 7.4953002686e-2f) * z + 1.6666752422e-1f) * z) * xr + xr;
  return gt_half ? kPio2 - 2.0f * p : p;
}

__device__ float asin_c(float x) {
  float a = fabsf(x);
  float out = tsign(x) * asin_core(tmin(a, 1.0f));
  return a > 1.0f ? NAN : out;
}

__device__ float acos_c(float x) {
  float a = fabsf(x);
  float flank = 2.0f * asin_core(sqrtf(tmax(0.5f * (1.0f - a), 0.0f)));
  float out = x < -0.5f ? kPi - flank : (x > 0.5f ? flank : kPio2 - asin_c(x));
  return a > 1.0f ? NAN : out;
}

// ---------------------------------------------------------------------------
// ops/lin3.py and ops/rotation.py (w-first quaternions)
// ---------------------------------------------------------------------------

constexpr float kMinAngle = 4.84813681e-6f;

__device__ __forceinline__ f3 mv3(const m3& m, f3 v) {
  return f3{m.a[0] * v.x + m.a[1] * v.y + m.a[2] * v.z,
            m.a[3] * v.x + m.a[4] * v.y + m.a[5] * v.z,
            m.a[6] * v.x + m.a[7] * v.y + m.a[8] * v.z};
}

__device__ __forceinline__ f3 mv3t(const m3& m, f3 v) {
  return f3{m.a[0] * v.x + m.a[3] * v.y + m.a[6] * v.z,
            m.a[1] * v.x + m.a[4] * v.y + m.a[7] * v.z,
            m.a[2] * v.x + m.a[5] * v.y + m.a[8] * v.z};
}

// det3 by the first row's cofactors; inv3: the adjugate times 1 / det
__device__ __forceinline__ float det3(const m3& m) {
  const float* q = m.a;
  return q[0] * (q[4] * q[8] - q[5] * q[7]) - q[1] * (q[3] * q[8] - q[5] * q[6]) +
         q[2] * (q[3] * q[7] - q[4] * q[6]);
}
__device__ m3 inv3(const m3& m) {
  const float a = m.a[0], b = m.a[1], c = m.a[2], d = m.a[3], e = m.a[4], f = m.a[5],
              g = m.a[6], h = m.a[7], i = m.a[8];
  const float inv_det = 1.0f / det3(m);
  const float cof[9] = {e * i - f * h, c * h - b * i, b * f - c * e,
                        f * g - d * i, a * i - c * g, c * d - a * f,
                        d * h - e * g, b * g - a * h, a * e - b * d};
  m3 r;
  for (int k = 0; k < 9; ++k) r.a[k] = cof[k] * inv_det;
  return r;
}

__device__ __forceinline__ f4 qidentity() { return f4{1.0f, 0.0f, 0.0f, 0.0f}; }
__device__ __forceinline__ f4 qinv(f4 q) { return f4{q.w, -q.x, -q.y, -q.z}; }

__device__ __forceinline__ f4 qmul(f4 q2, f4 q1) {
  return f4{q1.w * q2.w - q1.x * q2.x - q1.y * q2.y - q1.z * q2.z,
            q1.x * q2.w + q1.w * q2.x + q1.z * q2.y - q1.y * q2.z,
            q1.y * q2.w - q1.z * q2.x + q1.w * q2.y + q1.x * q2.z,
            q1.z * q2.w + q1.y * q2.x - q1.x * q2.y + q1.w * q2.z};
}

__device__ __forceinline__ f4 from_axis_angle(f3 u, float angle) {
  float half = angle * 0.5f;
  float s = sin_r(half);
  return f4{cos_r(half), s * u.x, s * u.y, s * u.z};
}

__device__ f4 from_rotation_vector(f3 rv) {
  float theta = norm3(rv);
  bool small = theta < kMinAngle;
  float safe = small ? 1.0f : theta;
  f4 q = from_axis_angle(dvs(rv, safe), safe);
  return small ? qidentity() : q;
}

__device__ __forceinline__ m3 to_matrix(f4 q) {
  float w = q.w, x = q.x, y = q.y, z = q.z;
  float r0 = w * w, r1 = x * x, r2 = y * y, r3 = z * z;
  m3 m;
  m.a[0] = r0 + r1 - r2 - r3;
  m.a[1] = 2.0f * (x * y - w * z);
  m.a[2] = 2.0f * (x * z + w * y);
  m.a[3] = 2.0f * (x * y + w * z);
  m.a[4] = r0 - r1 + r2 - r3;
  m.a[5] = 2.0f * (y * z - w * x);
  m.a[6] = 2.0f * (x * z - w * y);
  m.a[7] = 2.0f * (y * z + w * x);
  m.a[8] = r0 - r1 - r2 + r3;
  return m;
}

__device__ __forceinline__ f3 rotate(f4 q, f3 v) { return mv3(to_matrix(q), v); }
__device__ __forceinline__ f3 rotate_back(f4 q, f3 v) { return mv3t(to_matrix(q), v); }

__device__ f3 to_rotation_vector(f4 q) {
  float sign = q.w > 0.0f ? 1.0f : -1.0f;
  f3 n = f3{sign * q.x, sign * q.y, sign * q.z};
  float norm = norm3(n);
  float angle = asin_c(tclamp(norm, 0.0f, 1.0f)) * 2.0f;
  bool small = angle < kMinAngle;
  float safe_norm = small ? 1.0f : norm;
  return small ? f3{0.0f, 0.0f, 0.0f} : scl(n, angle / safe_norm);
}

__device__ __forceinline__ float get_angle(f4 q) {
  return 2.0f * acos_c(tclamp(fabsf(q.w), 0.0f, 1.0f));
}

__device__ void to_euler_ypr(f4 q, float* yaw, float* pitch, float* roll) {
  float w = q.w, x = q.x, y = q.y, z = q.z;
  *yaw = atan2_c(2.0f * x * y + 2.0f * w * z, x * x + w * w - z * z - y * y);
  *pitch = -asin_c(tclamp(2.0f * x * z - 2.0f * w * y, -1.0f, 1.0f));
  *roll = atan2_c(2.0f * y * z + 2.0f * w * x, z * z - y * y - x * x + w * w);
}

__device__ f4 from_euler_ypr(float y, float p, float r) {
  float cy = cos_r(0.5f * y), sy = sin_r(0.5f * y);
  float cp = cos_r(0.5f * p), sp = sin_r(0.5f * p);
  float cr = cos_r(0.5f * r), sr = sin_r(0.5f * r);
  return f4{cy * cp * cr + sy * sp * sr, cy * cp * sr - sy * sp * cr,
            cy * sp * cr + sy * cp * sr, sy * cp * cr - cy * sp * sr};
}

// ---------------------------------------------------------------------------
// ops/filters.py: lp2_apply with the reference's add-tree
// ---------------------------------------------------------------------------

struct Lp2c { float a1, a2, b0, b1, b2; };

__device__ __forceinline__ float lp2_apply(const Lp2c& c, float* xm0, float* xm1, float* ym0,
                                           float* ym1, float x) {
  float out = c.b2 * x + (c.b0 * *xm0 + c.b1 * *xm1);
  out = out + (-(c.a1 * *ym0) - c.a2 * *ym1);
  *xm0 = *xm1;
  *xm1 = x;
  *ym0 = *ym1;
  *ym1 = out;
  return out;
}

// ---------------------------------------------------------------------------
// models/plant.py: step and imu_measurements
// ---------------------------------------------------------------------------

constexpr float kGravZ = -9.81f;
__constant__ float kSpin[4] = {1.0f, -1.0f, 1.0f, -1.0f};

// Advances the plant leaves of S in place under the world-frame ext_force
// and ext_torque; returns acc_imu (world frame, gravity included, z zeroed
// on ground contact).
__device__ f3 plant_step(const EnvParams& P, EnvState& S, const float* motor_cmds, float dt,
                         f3 ext_force, f3 ext_torque) {
  const f3 grav = f3{0.0f, 0.0f, kGravZ};
  const f3 pos = ld3(S.plant_pos), vel = ld3(S.plant_vel), angvel = ld3(S.plant_angvel);
  const f4 att = ld4(S.plant_att);

  // motors
  bool tc_zero = P.p_motor_time_const == 0.0f;
  float c = tc_zero ? 0.0f : exp_r(-dt / (tc_zero ? 1.0f : P.p_motor_time_const));
  float new_speeds[4], w_abs_w[4], thrusts[4], tz[4];
  for (int i = 0; i < 4; ++i) {
    float cmd = tmax(motor_cmds[i], 0.0f);
    float ns = c * S.plant_motor_speeds[i] + (1.0f - c) * cmd;
    ns = tmin(tmax(ns, P.p_motor_min_speed), P.p_motor_max_speed);
    float dspeed = (ns - S.plant_motor_speeds[i]) / dt;
    new_speeds[i] = ns;
    w_abs_w[i] = ns * fabsf(ns);
    thrusts[i] = P.p_kf * w_abs_w[i];
    float tz_aero = -P.p_kt_sqr * w_abs_w[i] * kSpin[i];
    float tz_react = -dspeed * P.p_motor_inertia * kSpin[i];
    tz[i] = tz_aero + tz_react;
  }

  // torque: thrust moment + aero drag + rotor acceleration reaction
  f3 total_force_b = f3{0.0f, 0.0f, 0.0f}, total_torque_b = f3{0.0f, 0.0f, 0.0f};
  float h_motor_z = 0.0f;
  for (int i = 0; i < 4; ++i) {
    f3 force = f3{0.0f, 0.0f, thrusts[i]};
    f3 torque = cross(ld3(P.p_motor_positions + 3 * i), force);
    torque = add(torque, f3{0.0f, 0.0f, tz[i]});
    total_force_b = i == 0 ? force : add(total_force_b, force);
    total_torque_b = i == 0 ? torque : add(total_torque_b, torque);
    float h = new_speeds[i] * P.p_motor_inertia * kSpin[i];
    h_motor_z = i == 0 ? h : h_motor_z + h;
  }

  // rigid body
  total_torque_b = add(total_torque_b, rotate_back(att, ext_torque));
  const m3 J = ldm(P.p_inertia), Jinv = ldm(P.p_inertia_inv);
  f3 ang_mom = add(mv3(J, angvel), f3{h_motor_z * 0.0f, h_motor_z * 0.0f, h_motor_z * 1.0f});
  f3 ang_acc = mv3(Jinv, sub(total_torque_b, cross(angvel, ang_mom)));

  f3 vel_b = rotate_back(att, vel);
  total_force_b = sub(total_force_b, mul(ld3(P.p_lin_drag_b), vel_b));
  f3 acc = add(grav, dvs(add(rotate(att, total_force_b), ext_force), P.p_mass));

  f3 new_pos = add(add(pos, scl(vel, dt)), scl(scl(scl(acc, 0.5f), dt), dt));
  f3 new_vel = add(vel, scl(acc, dt));
  f4 new_att = qmul(att, from_rotation_vector(scl(angvel, dt)));
  f3 new_angvel = add(angvel, scl(ang_acc, dt));

  // ground contact
  bool grounded = (new_pos.z <= 0.0f) && (new_vel.z < 0.0f);
  f3 acc_imu = acc;
  if (grounded) {
    new_pos.z = 0.0f;
    new_vel.z = 0.0f;
    acc_imu.z = 0.0f;
    new_angvel = f3{0.0f, 0.0f, 0.0f};
  }
  st3(S.plant_pos, new_pos);
  st3(S.plant_vel, new_vel);
  st4(S.plant_att, new_att);
  st3(S.plant_angvel, new_angvel);
  for (int i = 0; i < 4; ++i) S.plant_motor_speeds[i] = new_speeds[i];
  return acc_imu;
}

// ---------------------------------------------------------------------------
// models/mixer.py and models/controllers.py
// ---------------------------------------------------------------------------

__device__ void motor_forces(const EnvParams& P, float total_thrust, f3 torque, float* f) {
  const float S[4][3] = {{-1.0f, -1.0f, -1.0f}, {-1.0f, 1.0f, 1.0f},
                         {1.0f, 1.0f, -1.0f}, {1.0f, -1.0f, 1.0f}};
  float d = P.l_arm_length / 1.4142135623730951f;
  float kt = P.l_prop0_spin_dir * P.l_prop_torque_from_thrust;
  float des_f = tmin(total_thrust, P.l_max_cmd_total_thrust);
  float t0 = torque.x / d, t1 = torque.y / d, t2 = torque.z / kt;
  for (int i = 0; i < 4; ++i) {
    float v = (S[i][0] * t0 + S[i][1] * t1 + S[i][2] * t2 + des_f) / 4.0f;
    f[i] = tmin(tmax(v, P.l_min_thrust_per_prop), P.l_max_thrust_per_prop);
  }
}

__device__ void speeds_from_forces(const EnvParams& P, const float* forces, const float* corr,
                                   float* w) {
  for (int i = 0; i < 4; ++i) {
    bool pos = forces[i] > 0.0f;
    float s = sqrtf((pos ? forces[i] : 1.0f) / (corr[i] * P.l_prop_thrust_from_speed_sqr));
    w[i] = pos ? s : 0.0f;
  }
}

__device__ __forceinline__ f3 position_control(float nat_freq, float damping, f3 est_pos,
                                               f3 est_vel, f3 des_pos, f3 des_vel, f3 des_acc) {
  // (des_pos - est_pos) w^2 + (des_vel - est_vel) 2 w d + des_acc
  f3 a = scl(scl(sub(des_pos, est_pos), nat_freq), nat_freq);
  f3 b = scl(scl(scl(sub(des_vel, est_vel), 2.0f), nat_freq), damping);
  return add(add(a, b), des_acc);
}

__device__ f3 attitude_control(float tc_xy, float tc_z, f4 des_att, f4 est_att) {
  const f3 e3 = f3{0.0f, 0.0f, 1.0f};
  f4 err_att = qmul(qinv(des_att), est_att);
  f3 des_rot_vec = to_rotation_vector(err_att);
  f3 e_b = rotate_back(err_att, e3);
  f3 red_ax = cross(e_b, e3);
  float red_angle = acos_c(tclamp(e_b.x * e3.x + e_b.y * e3.y + e_b.z * e3.z, -1.0f, 1.0f));
  float n = norm3(red_ax);
  bool small = n < 1e-12f;
  red_ax = small ? f3{0.0f, 0.0f, 0.0f} : dvs(red_ax, small ? 1.0f : n);
  float k3 = 1.0f / tc_z;
  float k12 = 1.0f / tc_xy;
  return sub(scl(des_rot_vec, -k3), scl(red_ax, (k12 - k3) * red_angle));
}

__device__ f3 angvel_control(float tc_xy, float tc_z, const m3& J, f3 des, f3 est) {
  f3 err = sub(des, est);
  f3 dacc = f3{err.x / tc_xy, err.y / tc_xy, err.z / tc_z};
  f3 nonlin = cross(est, mv3(J, est));
  return add(mv3(J, dacc), nonlin);
}

__device__ f4 thrust_dir_to_attitude(f3 thrust_dir) {
  const f3 e3 = f3{0.0f, 0.0f, 1.0f};
  float angle = acos_c(tclamp(thrust_dir.x * e3.x + thrust_dir.y * e3.y + thrust_dir.z * e3.z,
                              -1.0f, 1.0f));
  f3 ax = cross(e3, thrust_dir);
  float n = norm3(ax);
  bool small = n < 1e-6f;
  f4 q = from_rotation_vector(scl(ax, angle / (small ? 1.0f : n)));
  return small ? qidentity() : q;
}

// ---------------------------------------------------------------------------
// models/ekf.py: predict and cov_predict_block on the 9x9 covariance
// ---------------------------------------------------------------------------

// 3x3 blocks of the row-major 9x9 covariance
__device__ __forceinline__ m3 blk(const float* P, int r, int c) {
  m3 m;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) m.a[3 * i + j] = P[9 * (3 * r + i) + 3 * c + j];
  return m;
}
__device__ __forceinline__ void put_blk(float* P, int r, int c, const m3& m) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) P[9 * (3 * r + i) + 3 * c + j] = m.a[3 * i + j];
}
__device__ __forceinline__ m3 tr(const m3& m) {
  m3 t;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) t.a[3 * i + j] = m.a[3 * j + i];
  return t;
}
__device__ __forceinline__ m3 madd(const m3& a, const m3& b) {
  m3 m;
  for (int i = 0; i < 9; ++i) m.a[i] = a.a[i] + b.a[i];
  return m;
}
__device__ __forceinline__ m3 mscl(const m3& a, float s) {
  m3 m;
  for (int i = 0; i < 9; ++i) m.a[i] = s * a.a[i];
  return m;
}
// _mm3: the inner axis summed left to right
__device__ __forceinline__ m3 mm3(const m3& M, const m3& N) {
  m3 m;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      m.a[3 * i + j] = M.a[3 * i] * N.a[j] + M.a[3 * i + 1] * N.a[3 + j] + M.a[3 * i + 2] * N.a[6 + j];
  return m;
}
// _skew_mul: skew(g) @ M, each column c of M -> c x g
__device__ __forceinline__ m3 skew_mul(f3 g, const m3& M) {
  m3 m;
  for (int c = 0; c < 3; ++c) {
    f3 col = cross(f3{M.a[c], M.a[3 + c], M.a[6 + c]}, g);
    m.a[c] = col.x;
    m.a[3 + c] = col.y;
    m.a[6 + c] = col.z;
  }
  return m;
}
// M @ D^T for D = I + skew(g): each row r of M -> r + r x g
__device__ __forceinline__ m3 mDt(const m3& M, f3 g) { return madd(M, tr(skew_mul(g, tr(M)))); }

__device__ void cov_predict_block(float* P, float dt, const m3& A, f3 g, float q_vel,
                                  float q_att) {
  m3 P11 = blk(P, 0, 0), P12 = blk(P, 0, 1), P13 = blk(P, 0, 2);
  m3 P22 = blk(P, 1, 1), P23 = blk(P, 1, 2), P33 = blk(P, 2, 2);

  m3 FP11 = madd(P11, mscl(tr(P12), dt));
  m3 FP12 = madd(P12, mscl(P22, dt));
  m3 FP13 = madd(P13, mscl(P23, dt));
  m3 FP22 = madd(P22, mm3(A, tr(P23)));
  m3 FP23 = madd(P23, mm3(A, P33));
  m3 DP33 = madd(P33, skew_mul(g, P33));

  m3 At = tr(A);
  m3 N11 = madd(FP11, mscl(FP12, dt));
  m3 N12 = madd(FP12, mm3(FP13, At));
  m3 N13 = mDt(FP13, g);
  m3 N22 = madd(FP22, mm3(FP23, At));
  m3 N23 = mDt(FP23, g);
  m3 N33 = mDt(DP33, g);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      N22.a[3 * i + j] = N22.a[3 * i + j] + q_vel * (i == j ? 1.0f : 0.0f);
      N33.a[3 * i + j] = N33.a[3 * i + j] + q_att * (i == j ? 1.0f : 0.0f);
    }
  put_blk(P, 0, 0, N11);
  put_blk(P, 0, 1, N12);
  put_blk(P, 0, 2, N13);
  put_blk(P, 1, 0, tr(N12));
  put_blk(P, 1, 1, N22);
  put_blk(P, 1, 2, N23);
  put_blk(P, 2, 0, tr(N13));
  put_blk(P, 2, 1, tr(N23));
  put_blk(P, 2, 2, N33);
}

__device__ f4 gravity_align_correction(f4 att, f3 meas_acc, float gain) {
  f3 exp_acc = rotate_back(att, f3{0.0f, 0.0f, 1.0f});
  float norm = norm3(meas_acc);
  f3 acc_unit = dvs(meas_acc, norm < 1e-12f ? 1.0f : norm);
  f3 ax = cross(acc_unit, exp_acc);
  float n = norm3(ax);
  bool big = n > 1e-6f;
  ax = big ? dvs(ax, n) : f3{1.0f, 0.0f, 0.0f};
  float angle = acos_c(tclamp(dot3(exp_acc, acc_unit), -1.0f, 1.0f));
  return qmul(att, from_axis_angle(ax, gain * angle));
}

// An EKF's leaves in the state: the onboard filter's kf_* (EKF_OF(S, kf_)) or
// the offboard GPS-IMU estimator's gps_* (EKF_OF(S, gps_)).
struct Ekf {
  float *pos, *vel, *att, *angvel, *cov;
  unsigned char *imu_init, *uwb_init;
  float* last_att_corr;
  int *num_rejected, *num_rejected_seq, *num_resets;
};
#define EKF_OF(S, p)                                                                       \
  Ekf{S.p##pos, S.p##vel, S.p##att, S.p##angvel, S.p##cov, &S.p##imu_init, &S.p##uwb_init, \
      S.p##last_att_corr, &S.p##num_rejected, &S.p##num_rejected_seq, &S.p##num_resets}

// ekf.init_state's leaves (the filter's initial standard deviations: the
// onboard filter's, or with kGps the GPS-IMU estimator's) over k, keeping
// its reset and rejection counts (ekf._reset without the count)
template <bool kGps>
__device__ void ekf_fresh(const Ekf& k) {
  const float std_att_perp = static_cast<float>(10.0 * 3.14159265358979323846 / 180.0);
  const float std_att_grav =
      kGps ? std_att_perp : static_cast<float>(30.0 * 3.14159265358979323846 / 180.0);
  const float stds[9] = {3.0f, 3.0f, 3.0f, 3.0f, 3.0f, 3.0f,
                         std_att_perp, std_att_perp, std_att_grav};
  st3(k.pos, f3{0.0f, 0.0f, 0.0f});
  st3(k.vel, f3{0.0f, 0.0f, 0.0f});
  st4(k.att, qidentity());
  st3(k.angvel, f3{0.0f, 0.0f, 0.0f});
  for (int i = 0; i < 81; ++i) k.cov[i] = 0.0f;
  for (int i = 0; i < 9; ++i) k.cov[10 * i] = stds[i] * stds[i];
  *k.imu_init = 0;
  *k.uwb_init = 0;
  st3(k.last_att_corr, f3{0.0f, 0.0f, 0.0f});
  *k.num_rejected_seq = 0;
}

// One prediction step (the phase the lifecycle flags select: A first IMU
// sample, B complementary, C full EKF). kGps: the GPS-IMU estimator's
// (gpsimu_predict: its initial deviations, and uwb_init set at the reset, so
// no phase B); else the onboard filter's.
template <bool kGps>
__device__ void ekf_predict(const Ekf& k, f3 gyro, f3 acc, float dt) {
  if (!*k.imu_init) {  // phase A: reset + gravity-aligned attitude
    ekf_fresh<kGps>(k);
    st4(k.att, gravity_align_correction(qidentity(), acc, 1.0f));
    *k.imu_init = 1;
    *k.uwb_init = kGps ? 1 : 0;
    *k.num_resets = wadd(*k.num_resets, 1);
    return;
  }
  const f4 att = ld4(k.att);
  if (!*k.uwb_init) {  // phase B: complementary attitude
    f4 attB = qmul(att, from_rotation_vector(scl(gyro, dt)));
    st4(k.att, gravity_align_correction(attB, acc, dt / 4.0f));
    st3(k.angvel, gyro);
    return;
  }
  // phase C: full EKF prediction
  const f3 pos = ld3(k.pos), vel = ld3(k.vel);
  f3 acc_w = add(rotate(att, acc), f3{0.0f, 0.0f, kGravZ});
  st3(k.pos, add(pos, scl(vel, dt)));
  st3(k.vel, add(vel, scl(acc_w, dt)));
  st4(k.att, qmul(att, from_rotation_vector(scl(gyro, dt))));
  st3(k.angvel, gyro);

  m3 R = to_matrix(att);
  float ax = acc.x, ay = acc.y, az = acc.z;
  m3 dva;  // d(vel)/d(att) = dt * R [a]_x
  for (int i = 0; i < 3; ++i) {
    float r0 = R.a[3 * i], r1 = R.a[3 * i + 1], r2 = R.a[3 * i + 2];
    dva.a[3 * i] = dt * (ay * r2 - az * r1);
    dva.a[3 * i + 1] = dt * (-ax * r2 + az * r0);
    dva.a[3 * i + 2] = dt * (ax * r1 - ay * r0);
  }
  f3 g = add(scl(gyro, dt), dvs(ld3(k.last_att_corr), 2.0f));
  SECTION_BEGIN(kSecCovPredict)
  cov_predict_block(k.cov, dt, dva, g, 25.0f * dt * dt, 0.01f * dt * dt);
  SECTION_END(kSecCovPredict)
  st3(k.last_att_corr, f3{0.0f, 0.0f, 0.0f});
}

#ifdef TICK_RANGING
// update_range: the scalar UWB range update with 3-sigma Mahalanobis gating
// and a hard reset after 5 rejections in a row; the covariance symmetrized
// by copying its lower triangle up. Every sum runs left to right over all
// nine terms, as the plain version's.
__device__ void ekf_update_range(const Ekf& k, f3 target, float meas_range, bool apply) {
  apply = apply && *k.imu_init && isfinite(meas_range);
  if (!apply) return;
  *k.uwb_init = 1;  // set before gating (cpp:252)
  f3 diff = sub(ld3(k.pos), target);
  float expected = norm3(diff);
  f3 h = dvs(diff, expected < 1e-12f ? 1.0f : expected);
  const float H[9] = {h.x, h.y, h.z, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float pht[9];
  for (int i = 0; i < 9; ++i) {
    float a = k.cov[9 * i] * H[0];
    for (int j = 1; j < 9; ++j) a = a + k.cov[9 * i + j] * H[j];
    pht[i] = a;
  }
  float innov_cov = H[0] * pht[0];
  for (int j = 1; j < 9; ++j) innov_cov = innov_cov + H[j] * pht[j];
  innov_cov = innov_cov + static_cast<float>(0.14 * 0.14);
  float innov = meas_range - expected;
  bool reject = innov * innov / innov_cov > 9.0f;
  if (!reject) {
    float L[9], dx[9];
    for (int i = 0; i < 9; ++i) {
      L[i] = pht[i] / innov_cov;
      dx[i] = L[i] * innov;
    }
    st3(k.pos, add(ld3(k.pos), f3{dx[0], dx[1], dx[2]}));
    st3(k.vel, add(ld3(k.vel), f3{dx[3], dx[4], dx[5]}));
    const f3 att_corr = f3{dx[6], dx[7], dx[8]};
    st4(k.att, qmul(ld4(k.att), from_rotation_vector(att_corr)));
    st3(k.last_att_corr, att_corr);
    *k.num_rejected_seq = 0;
    for (int i = 0; i < 9; ++i)  // the lower triangle, then copied up
      for (int j = 0; j <= i; ++j) k.cov[9 * i + j] = k.cov[9 * i + j] - L[i] * pht[j];
    for (int i = 0; i < 9; ++i)
      for (int j = 0; j < 9; ++j)
        k.cov[9 * i + j] = j <= i ? k.cov[9 * i + j] + 0.0f : 0.0f + k.cov[9 * j + i];
    return;
  }
  *k.num_rejected = wadd(*k.num_rejected, 1);
  const int nseq = wadd(*k.num_rejected_seq, 1);
  *k.num_rejected_seq = nseq;
  if (nseq >= 5) {  // hard reset
    ekf_fresh<false>(k);
    *k.num_resets = wadd(*k.num_resets, 1);
  }
}
#endif

// gps_position_update (the GPS fix, applied): the 3-D position update with
// H = [I3 0 0]; a singular or non-finite innovation covariance adopts the
// measurement and resets the variance, and so does the first fix of a filter
// that has had no IMU sample. Every product sums its inner axis left to
// right.
__device__ void gps_position_update(const Ekf& k, f3 meas_pos) {
  const float* P = k.cov;
  m3 S;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) S.a[3 * i + j] = P[9 * i + j] + 0.0625f * (i == j ? 1.0f : 0.0f);
  bool finite = true;
  for (int i = 0; i < 9; ++i) finite = finite && isfinite(S.a[i]);
  bool bad = fabsf(det3(S)) < 1e-10f || !finite;
  if (!bad && *k.imu_init) {
    const m3 Si = inv3(S);
    float L[27], dx[9], cn[81];
    const f3 e = sub(meas_pos, ld3(k.pos));
    for (int i = 0; i < 9; ++i) {
      for (int j = 0; j < 3; ++j)
        L[3 * i + j] = P[9 * i] * Si.a[j] + P[9 * i + 1] * Si.a[3 + j] + P[9 * i + 2] * Si.a[6 + j];
      dx[i] = L[3 * i] * e.x + L[3 * i + 1] * e.y + L[3 * i + 2] * e.z;
    }
    for (int i = 0; i < 9; ++i)
      for (int j = 0; j < 9; ++j)
        cn[9 * i + j] = P[9 * i + j] - (L[3 * i] * P[j] + L[3 * i + 1] * P[9 + j] +
                                        L[3 * i + 2] * P[18 + j]);
    for (int i = 0; i < 9; ++i)
      for (int j = 0; j < 9; ++j) k.cov[9 * i + j] = 0.5f * (cn[9 * i + j] + cn[9 * j + i]);
    st3(k.pos, add(ld3(k.pos), f3{dx[0], dx[1], dx[2]}));
    st3(k.vel, add(ld3(k.vel), f3{dx[3], dx[4], dx[5]}));
    const f3 att_corr = f3{dx[6], dx[7], dx[8]};
    st4(k.att, qmul(ld4(k.att), from_rotation_vector(att_corr)));
    st3(k.last_att_corr, att_corr);
    *k.uwb_init = 1;
    return;
  }
  // the bailout, or the first fix
  const float s10 = static_cast<float>(10.0 * 3.14159265358979323846 / 180.0);
  const float stds[9] = {3.0f, 3.0f, 3.0f, 3.0f, 3.0f, 3.0f, s10, s10, s10};
  st3(k.pos, meas_pos);
  st3(k.vel, f3{0.0f, 0.0f, 0.0f});
  st4(k.att, qidentity());
  st3(k.angvel, f3{0.0f, 0.0f, 0.0f});
  for (int i = 0; i < 81; ++i) k.cov[i] = 0.0f;
  for (int i = 0; i < 9; ++i) k.cov[10 * i] = stds[i] * stds[i];
  st3(k.last_att_corr, f3{0.0f, 0.0f, 0.0f});
  if (!*k.imu_init) {
    *k.imu_init = 1;
    *k.uwb_init = 1;
  }
}

// ---------------------------------------------------------------------------
// io/radio.py: the wire codec
// ---------------------------------------------------------------------------

constexpr int kTypeEmergencyKill = 2, kTypePositionCmd = 3, kTypeExternalAccCmd = 4,
              kTypeExternalRatesCmd = 5, kTypeIdleCmd = 6;
constexpr int kFlagCalibrateMotors = 0x01, kFlagDisableSafetyChecks = 0x02;
constexpr int kNumFields = 10;
__constant__ float kLimRates[10] = {35.0f, 35.0f, 35.0f, 35.0f, 35.0f,
                                 35.0f, 35.0f, 35.0f, 35.0f, 35.0f};
__constant__ float kLimPos[10] = {20.0f, 20.0f, 20.0f, 10.0f, 10.0f,
                               10.0f, 30.0f, 30.0f, 30.0f, 1.0f};
__constant__ float kLimAcc[10] = {30.0f, 30.0f, 30.0f, 35.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f};

// encodeToRadioByte; the code truncates toward zero like .to(torch.int32)
__device__ __forceinline__ int encode_field(float val, float limit) {
  bool in_range = (val > -limit) && (val < limit);
  if (in_range) return static_cast<int>(val * 32768.0f / limit + 0.5f) + 32768;
  return val >= limit ? 65535 : 0;
}

__device__ __forceinline__ float decode_field(int code, float limit) {
  return limit * (static_cast<float>(code) - 32768.0f) / 32768.0f;
}

__device__ void decode_message(int msg_type, const int* fields, float* out) {
  for (int i = 0; i < kNumFields; ++i) {
    float limit = msg_type == kTypePositionCmd        ? kLimPos[i]
                  : msg_type == kTypeExternalRatesCmd ? kLimRates[i]
                  : msg_type == kTypeExternalAccCmd   ? kLimAcc[i]
                                                      : 1.0f;
    out[i] = decode_field(fields[i], limit);
  }
}

// ---------------------------------------------------------------------------
// models/logic.py: logic_step (the range update in the UWB variant)
// ---------------------------------------------------------------------------

constexpr int FS_UNINITIALIZED = 0, FS_IDLE = 1, FS_FULLY_AUTONOMOUS = 2, FS_PANIC = 3,
              FS_KILLED = 4, FS_EXTERNAL_ACCELERATION_CONTROL = 5,
              FS_EXTERNAL_RATES_CONTROL = 6;
constexpr int kUsSat = 100000000;
constexpr float kRadioCmdPeriod = 0.02f;

__device__ __forceinline__ int advance_timer(int us, int period_us) {
  return min(wadd(us, period_us), kUsSat);
}

#ifdef TICK_RANGING
// a broadcast of the ranging network this tick (sim/uwb.py's
// UwbMeasurement; the requester is not read). logic_step reads the
// broadcast from a source `uwb` only where the range update needs it:
// uwb.get() returns it, and uwb.used() follows the update. A UwbMeas is its
// own source (K5's network steps before the tick's logic); K6's source
// waits there for the fleet's network, which runs beside the logic.
struct UwbMeas {
  bool valid;
  float range;
  int responder_id;
  bool failure;
  __device__ __forceinline__ UwbMeas get() const { return *this; }
  __device__ __forceinline__ void used() const {}
};
#endif

// gyro, acc: the raw IMU readings; the radio message popped this tick; in
// the ranging variants, the source of the network's broadcast.
#ifdef TICK_RANGING
template <class U>
__device__ void logic_step(const EnvParams& P, EnvState& S, f3 gyro, f3 acc, bool radio_new,
                           int radio_type_in, int radio_flags_in, const int* radio_fields,
                           const U& uwb_source) {
#else
__device__ void logic_step(const EnvParams& P, EnvState& S, f3 gyro, f3 acc, bool radio_new,
                           int radio_type_in, int radio_flags_in, const int* radio_fields) {
#endif
  const int per_us = P.l_onboard_period_us;
  const m3 imu_rot = ldm(P.l_imu_rot);
  const Lp2c gyro_c{P.l_gyro_lp_a1, P.l_gyro_lp_a2, P.l_gyro_lp_b0, P.l_gyro_lp_b1, P.l_gyro_lp_b2};
  const Lp2c acc_c{P.l_acc_lp_a1, P.l_acc_lp_a2, P.l_acc_lp_b0, P.l_acc_lp_b1, P.l_acc_lp_b2};
  const Lp2c temp_c{P.l_temp_lp_a1, P.l_temp_lp_a2, P.l_temp_lp_b0, P.l_temp_lp_b1, P.l_temp_lp_b2};
  const Lp2c batt_c{P.l_batt_lp_a1, P.l_batt_lp_a2, P.l_batt_lp_b0, P.l_batt_lp_b1, P.l_batt_lp_b2};
  const float batt_voltage = P.l_batt_critical * 1.2f;

  // sensor ingestion
  f3 gyro_raw = mv3(imu_rot, gyro);
  f3 gyro_in = sub(gyro_raw, ld3(S.gyro_bias));
  const float gin[3] = {gyro_in.x, gyro_in.y, gyro_in.z};
  f3 acc_raw = mv3(imu_rot, acc);
  const float ain[3] = {acc_raw.x, acc_raw.y, acc_raw.z};
  for (int i = 0; i < 3; ++i) {
    lp2_apply(gyro_c, &S.gyro_lp_xm0[i], &S.gyro_lp_xm1[i], &S.gyro_lp_ym0[i],
              &S.gyro_lp_ym1[i], gin[i]);
    lp2_apply(acc_c, &S.acc_lp_xm0[i], &S.acc_lp_xm1[i], &S.acc_lp_ym0[i], &S.acc_lp_ym1[i],
              ain[i]);
  }
  lp2_apply(temp_c, &S.temp_lp_xm0, &S.temp_lp_xm1, &S.temp_lp_ym0, &S.temp_lp_ym1, 25.0f);
  lp2_apply(batt_c, &S.batt_lp_xm0, &S.batt_lp_xm1, &S.batt_lp_ym0, &S.batt_lp_ym1,
            batt_voltage);

  // radio delivery: decoded floats + cmd-rate monitor
  int us_since_radio = advance_timer(S.us_since_radio, per_us);
  float cmd_dt = static_cast<float>(us_since_radio) * 1e-6f;
  if (radio_new) {
    float c = P.l_cmd_rate_lp_coeff;
    S.cmd_rate_lpdt = c * S.cmd_rate_lpdt + (1.0f - c) * cmd_dt;
    decode_message(radio_type_in, radio_fields, S.radio_floats);
    S.radio_type = radio_type_in;
    S.radio_flags = radio_flags_in;
    us_since_radio = 0;
  }
  S.radio_count = wadd(S.radio_count, radio_new ? 1 : 0);
  S.us_since_radio = us_since_radio;
  S.us_since_uwb = advance_timer(S.us_since_uwb, per_us);  // reset below on a broadcast
  bool radio_pending = S.radio_new || radio_new;

  // Run()
  S.cycle_count = wadd(S.cycle_count, 1);
  S.loop_lpdt = P.l_loop_lp_coeff * S.loop_lpdt + (1.0f - P.l_loop_lp_coeff) * P.l_onboard_period;
  f3 gyro_f = ld3(S.gyro_lp_ym1);
  f3 acc_f = ld3(S.acc_lp_ym1);

  // UpdateEstimator
  int prev_resets = S.last_check_num_resets;
  SECTION_BEGIN(kSecEkfPredict)
  ekf_predict<false>(EKF_OF(S, kf_), gyro_f, acc_f, P.l_onboard_period);
  SECTION_END(kSecEkfPredict)
  if (S.gyro_cal_enabled) {
    st3(S.gyro_cal_accum, add(ld3(S.gyro_cal_accum), gyro_raw));
    S.gyro_cal_count = wadd(S.gyro_cal_count, 1);
  }
#ifdef TICK_RANGING
  {  // the range update, to the anchor the responder id names
    const UwbMeas uwb = uwb_source.get();
    if (uwb.valid) S.us_since_uwb = 0;
    const bool success = uwb.valid && !uwb.failure;
    f3 target = f3{0.0f, 0.0f, 0.0f};
    bool known = false;
    for (int t = 0; t < 32; ++t) {  // the matching rows summed in order
      const bool match = P.l_target_ids[t] == uwb.responder_id && t < P.l_num_targets;
      const f3 row = match ? ld3(P.l_target_positions + 3 * t) : f3{0.0f, 0.0f, 0.0f};
      target = t == 0 ? row : add(target, row);
      known = known || match;
    }
    ekf_update_range(EKF_OF(S, kf_), target, uwb.range, success && known);
    S.uwb_meas_count = wadd(S.uwb_meas_count, success ? 1 : 0);
    if (uwb.valid && P.l_num_targets > 0)
      S.next_target_idx = wadd(S.next_target_idx, 1) % max(P.l_num_targets, 1);
    uwb_source.used();
  }
#endif

  // ParseIncomingCommunications
  int fs = S.fs;
  bool sticky = (fs == FS_PANIC) || (fs == FS_KILLED);
  bool take = radio_pending && !sticky;
  int radio_type = S.radio_type, radio_flags = S.radio_flags;
  bool is_kill = take && radio_type == kTypeEmergencyKill;
  if (is_kill) fs = FS_KILLED;
  int panic_reason = (is_kill && S.panic_reason == 0) ? 7 : S.panic_reason;
  if (take && radio_type == kTypePositionCmd) fs = FS_FULLY_AUTONOMOUS;
  if (take && radio_type == kTypeExternalAccCmd) fs = FS_EXTERNAL_ACCELERATION_CONTROL;
  if (take && radio_type == kTypeExternalRatesCmd) fs = FS_EXTERNAL_RATES_CONTROL;
  if (take && radio_type == kTypeIdleCmd) fs = FS_IDLE;

  // UpdateWarnings
  float batt_filt = S.batt_lp_ym1;
  int warnings = S.warnings;
  if (batt_filt <= P.l_batt_warning) warnings |= 0x01;
  if (fabsf(S.cmd_rate_lpdt - kRadioCmdPeriod) > static_cast<float>(0.1 * 0.02)) warnings |= 0x02;
  if (static_cast<float>(us_since_radio) * 1e-6f > static_cast<float>(3 * 0.02)) warnings |= 0x10;
  if (fabsf(S.loop_lpdt - P.l_onboard_period) > 0.05f * P.l_onboard_period) warnings |= 0x08;
  bool was_reset = S.kf_num_resets != prev_resets;
  S.us_since_est_reset = was_reset ? 0 : advance_timer(S.us_since_est_reset, per_us);
  if (S.us_since_est_reset < 20000) warnings |= 0x04;
  S.warnings = warnings;

  // CheckPanicReasons (later rules override earlier ones)
  const f3 e3 = f3{0.0f, 0.0f, 1.0f};
  const f3 est_pos = ld3(S.kf_pos), est_vel = ld3(S.kf_vel), est_angvel = ld3(S.kf_angvel);
  const f4 est_att = ld4(S.kf_att);
  bool motors_running = false;
  for (int i = 0; i < 4; ++i) motors_running = motors_running || S.des_motor_speeds[i] > 0.0f;
  bool checks_on = (radio_flags & kFlagDisableSafetyChecks) == 0;
  int unsafe = 0;
  if (est_pos.z < -2.0f && checks_on) unsafe = 1;
  if (S.us_since_uwb > 1500000 && fs == FS_FULLY_AUTONOMOUS) unsafe = 2;
  if (rotate(est_att, e3).z < 0.0f && checks_on) unsafe = 3;
  if (us_since_radio > 1500000) unsafe = 4;
  if (batt_filt <= P.l_batt_critical) unsafe = 5;
  if (!motors_running) unsafe = 0;
  bool in_critical = fs == FS_FULLY_AUTONOMOUS || fs == FS_EXTERNAL_ACCELERATION_CONTROL ||
                     fs == FS_EXTERNAL_RATES_CONTROL;
  bool go_panic = unsafe != 0 && in_critical && fs != FS_PANIC;
  if (go_panic) {
    panic_reason = unsafe;
    fs = FS_PANIC;
  }
  S.fs = fs;
  S.panic_reason = panic_reason;
  S.debug[0] = S.temp_lp_ym1;

  // controllers: the branch the flight state selects
  const m3 J = ldm(P.l_inertia);
  const f3 g_vec = f3{0.0f, 0.0f, 9.81f};
  const f3 zero3 = f3{0.0f, 0.0f, 0.0f};
  const float* rf = S.radio_floats;
  float forces[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  bool acc_cutoff = rf[2] < static_cast<float>(-9.81 / 2);
  if (fs == FS_FULLY_AUTONOMOUS) {
    f3 des_acc = position_control(P.l_pos_nat_freq, P.l_pos_damping, est_pos, est_vel,
                                  ld3(rf), zero3, zero3);
    f3 proper_acc = add(des_acc, g_vec);
    float norm_pa = norm3(proper_acc);
    f3 thrust_dir = dvs(proper_acc, norm_pa < 1e-12f ? 1.0f : norm_pa);
    float corr_sat = tmax(rotate(est_att, e3).z, 1.0f);
    f3 angvel_auto = attitude_control(P.l_att_tc_xy, P.l_att_tc_z,
                                      thrust_dir_to_attitude(thrust_dir), est_att);
    f3 torque_auto = angvel_control(P.l_angvel_tc_xy, P.l_angvel_tc_z, J, angvel_auto, est_angvel);
    motor_forces(P, norm_pa / corr_sat * P.l_mass, torque_auto, forces);
  } else if (fs == FS_EXTERNAL_ACCELERATION_CONTROL && !acc_cutoff) {
    f3 pa2 = add(ld3(rf), g_vec);
    float thrust_acc = norm3(pa2);
    f3 dir2 = dvs(pa2, thrust_acc < 1e-12f ? 1.0f : thrust_acc);
    float yaw, pitch, roll;
    to_euler_ypr(est_att, &yaw, &pitch, &roll);
    f4 att_no_yaw = from_euler_ypr(0.0f, pitch, roll);
    f3 angvel2 = attitude_control(P.l_att_tc_xy, P.l_att_tc_z, thrust_dir_to_attitude(dir2),
                                  att_no_yaw);
    angvel2.z = rf[3];
    f3 torque2 = angvel_control(P.l_angvel_tc_xy, P.l_angvel_tc_z, J, angvel2, est_angvel);
    motor_forces(P, thrust_acc * P.l_mass, torque2, forces);
  } else if (fs == FS_EXTERNAL_RATES_CONTROL) {
    f3 torque3 = angvel_control(P.l_angvel_tc_xy, P.l_angvel_tc_z, J, ld3(rf + 1), est_angvel);
    motor_forces(P, rf[0] * P.l_mass, torque3, forces);
  }
  float speeds[4];
  speeds_from_forces(P, forces, S.prop_cal_factors, speeds);
  bool zero_out = fs == FS_IDLE || fs == FS_PANIC || fs == FS_KILLED || fs == FS_UNINITIALIZED ||
                  (fs == FS_EXTERNAL_ACCELERATION_CONTROL && acc_cutoff);
  if (zero_out)
    for (int i = 0; i < 4; ++i) speeds[i] = forces[i] = 0.0f;

  // motor test mode overrides the state machine
  if (S.test_motors_on) {
    f3 torque_test = angvel_control(P.l_angvel_tc_xy, P.l_angvel_tc_z, J, zero3, est_angvel);
    motor_forces(P, S.test_motors_frac * 9.81f * P.l_mass, torque_test, forces);
    speeds_from_forces(P, forces, S.prop_cal_factors, speeds);
  }

  // propeller calibration
  bool in_rates = fs == FS_EXTERNAL_RATES_CONTROL;
  bool cal_flag = in_rates && (radio_flags & kFlagCalibrateMotors) != 0;
  bool starting = cal_flag && !S.prop_cal_running;
  int count = starting ? 0 : S.prop_cal_count;
  if (starting)
    for (int i = 0; i < 4; ++i) S.prop_cal_accum[i] = 0.0f;
  if (cal_flag) {
    for (int i = 0; i < 4; ++i)
      S.prop_cal_accum[i] = S.prop_cal_accum[i] + P.l_prop_thrust_from_speed_sqr * speeds[i] * speeds[i];
    count = wadd(count, 1);
  }
  bool finishing = in_rates && !cal_flag && S.prop_cal_running;
  bool done = finishing && count >= 750;
  if (done) {
    float m = P.l_mass * 9.81f / 4.0f;
    for (int i = 0; i < 4; ++i) {
      float accum = S.prop_cal_accum[i];
      S.prop_cal_factors[i] = tclamp(static_cast<float>(count) * m / (accum != 0.0f ? accum : 1.0f),
                                     0.7f, static_cast<float>(1.0 / 0.7));
    }
  }
  S.prop_cal_running = cal_flag ? 1 : (finishing ? 0 : S.prop_cal_running);
  S.prop_cal_count = count;
  S.should_write_params = S.should_write_params || done;

  for (int i = 0; i < 4; ++i) {
    S.des_motor_speeds[i] = speeds[i];
    S.des_motor_forces[i] = forces[i];
  }
  st3(S.gyro_raw, gyro_raw);
  S.radio_new = 0;
  S.last_check_num_resets = S.kf_num_resets;
  S.batt_voltage = batt_voltage;
  S.batt_current = -1.0f;
}

// ---------------------------------------------------------------------------
// sim/delayline.py: the radio ring (push, pop_due)
// ---------------------------------------------------------------------------

constexpr int kRingCap = 32;

__device__ void ring_push(EnvState& S, int type, int flags, const int* fields, int step,
                          bool do_push) {
  int slot = (S.ring_head + S.ring_count) % kRingCap;
  bool can = do_push && S.ring_count < kRingCap;
  if (!can) return;
  S.ring_types[slot] = type;
  S.ring_flags[slot] = flags;
  for (int i = 0; i < kNumFields; ++i) S.ring_fields[kNumFields * slot + i] = fields[i];
  S.ring_send_step[slot] = step;
  S.ring_count = S.ring_count + 1;
}

// Returns whether the front message is due (its delay elapsed) and copies
// it out; the plain version reads the front slot by a one-hot sum, which is
// zero for a head outside the ring.
__device__ bool ring_pop_due(EnvState& S, int step, int dt_us, int delay_us, int* type, int* flags,
                             int* fields) {
  int h = S.ring_head;
  bool valid = h >= 0 && h < kRingCap;
  bool has = S.ring_count > 0;
  int front_send = valid ? S.ring_send_step[h] : 0;
  bool due = has && wmul(wsub(step, front_send), dt_us) > delay_us;
  *type = valid ? S.ring_types[h] : 0;
  *flags = valid ? S.ring_flags[h] : 0;
  for (int i = 0; i < kNumFields; ++i) fields[i] = valid ? S.ring_fields[kNumFields * h + i] : 0;
  if (due) {
    S.ring_head = (h + 1) % kRingCap;
    S.ring_count = S.ring_count - 1;
  }
  return due;
}

// ---------------------------------------------------------------------------
// offboard/estimators.py: the mocap estimator and its prediction pipe
// ---------------------------------------------------------------------------

constexpr int kPipeCap = 8;
constexpr int kMaxConsecutiveReject = 10;
constexpr float kMeasRejectDist = 6.0f;
constexpr float kProcStdPos = static_cast<float>(1.0 * 9.81);
constexpr float kProcStdAtt = 200.0f;

// the mocap estimate, without the pipe
struct Mocap {
  f3 pos, vel, angvel;
  f4 att;
  float vp[3], va[3];  // (0,0), (0,1), (1,1) of the symmetric 2x2 variances
};

struct PipeView {  // the pipe in logical (push) order
  int act[kPipeCap];
  f3 acc[kPipeCap], angvel[kPipeCap];
  bool ballistic[kPipeCap];
};

__device__ void pipe_ordered(const EnvState& S, PipeView& v) {
  for (int i = 0; i < kPipeCap; ++i) {
    int src = (S.pipe_head + i) % kPipeCap;
    v.act[i] = i < S.pipe_count ? S.pipe_active_us[src] : (1 << 30);
    v.acc[i] = ld3(S.pipe_acc + 3 * src);
    v.angvel[i] = ld3(S.pipe_angvel + 3 * src);
    v.ballistic[i] = S.pipe_ballistic[src] != 0;
  }
}

__device__ void pipe_push(EnvState& S, int now_us, int delay_us, f3 acc, f3 angvel, bool do_push) {
  if (!do_push) return;
  if (S.pipe_count >= kPipeCap) {  // evict the oldest
    S.pipe_head = (S.pipe_head + 1) % kPipeCap;
    S.pipe_count = S.pipe_count - 1;
  }
  int slot = (S.pipe_head + S.pipe_count) % kPipeCap;
  S.pipe_active_us[slot] = wadd(now_us, delay_us);
  st3(S.pipe_acc + 3 * slot, acc);
  st3(S.pipe_angvel + 3 * slot, angvel);
  S.pipe_ballistic[slot] = 0;
  S.pipe_count = S.pipe_count + 1;
}

__device__ void pipe_clear_expired(EnvState& S, int t_us) {
  PipeView v;
  pipe_ordered(S, v);
  int advance = 0;
  for (int i = 1; i < kPipeCap; ++i)
    if (i < S.pipe_count && v.act[i] <= t_us) advance = i;
  S.pipe_head = (S.pipe_head + advance) % kPipeCap;
  S.pipe_count = S.pipe_count - advance;
}

__device__ __forceinline__ void step_var(float* p, float proc, float dt) {
  // the reference puts sigma, not sigma^2, in Q (kept bug-compatible)
  float n00 = p[0] + dt * (p[1] + p[1]) + (dt * dt) * p[2] + ipow4(dt) * proc / 4.0f;
  float n01 = p[1] + dt * p[2];
  float n11 = p[2] + ipow2(dt) * proc;
  p[0] = n00;
  p[1] = n01;
  p[2] = n11;
}

__device__ __forceinline__ Mocap mocap_of(const EnvState& S) {
  Mocap m;
  m.pos = ld3(S.mc_pos);
  m.vel = ld3(S.mc_vel);
  m.att = ld4(S.mc_att);
  m.angvel = ld3(S.mc_angvel);
  m.vp[0] = S.mc_var_pos[0], m.vp[1] = S.mc_var_pos[1], m.vp[2] = S.mc_var_pos[3];
  m.va[0] = S.mc_var_att[0], m.va[1] = S.mc_var_att[1], m.va[2] = S.mc_var_att[3];
  return m;
}

// The replay's segments: one per pipe slot, and the final open one.
constexpr int kSegs = kPipeCap + 1;

// a segment's decay of the angular velocity toward its command
__device__ __forceinline__ float segment_decay(bool ballistic, float dt) {
  return ballistic ? 1.0f : exp_r(-dt / 0.04f);
}

// A vehicle leader's requests to its helper lanes, in shared memory:
// segment i is lane i + 1's. op: kDecay, kRotation or both (bits), or
// kDone.
enum { kDone = 0, kDecay = 1, kRotation = 2 };
struct WarpWork {
  int op;
  float dt[kSegs];
  f3 w[kSegs];
  bool ballistic[kSegs];
  float decay[kSegs];
  f4 rot[kSegs];
};

// Segment i's share of a request: its decay c = segment_decay(ballistic,
// dt) and/or its rotation from_rotation_vector(w dt).
__device__ __forceinline__ void segment_work(int op, bool ballistic, float dt, f3 w, float* c,
                                             f4* rot) {
  if (op & kDecay) *c = segment_decay(ballistic, dt);
  if (op & kRotation) *rot = from_rotation_vector(scl(w, dt));
}

// K3's layout: the lanes 1..kSegs of a vehicle's warp help its leader (lane
// 0) with the replay's per-segment work.
struct Helpers {
  WarpWork* work;

  // segment_work(op, ...) for every segment: c[i] and/or rot[i]
  __device__ void segments(int op, const bool* ballistic, const float* dt, const f3* w, float* c,
                           f4* rot) const {
    for (int i = 0; i < kSegs; ++i) {
      work->ballistic[i] = ballistic[i];
      work->dt[i] = dt[i];
      work->w[i] = w[i];
    }
    work->op = op;
    __syncwarp();  // the helpers compute between these two barriers (help())
    __syncwarp();
    for (int i = 0; i < kSegs; ++i) {
      if (op & kDecay) c[i] = work->decay[i];
      if (op & kRotation) rot[i] = work->rot[i];
    }
  }
  // ends the helpers' loop; the leader calls it once, after its last tick
  __device__ void release() const {
    work->op = kDone;
    __syncwarp();
  }
};

// A helper lane's loop: its segment of each request, until released.
__device__ void help(WarpWork& work, int lane) {
  const int i = lane - 1;
  for (;;) {
    __syncwarp();
    const int op = work.op;
    if (op == kDone) return;
    if (i < kSegs)
      segment_work(op, work.ballistic[i], work.dt[i], work.w[i], &work.decay[i], &work.rot[i]);
    __syncwarp();
  }
}

// a segment's share of a request, as one value for the lanes' exchange
struct SegmentOut { float c; f4 rot; };

// Lanes<G>'s form of Helpers::segments: segment i on lane i % G
template <int G>
__device__ __forceinline__ void segments(const Lanes<G>& hp, int op, const bool* ballistic,
                                         const float* dt, const f3* w, float* c, f4* rot) {
  SegmentOut out[kSegs];
  hp.map(out, [&](int i) {
    SegmentOut o{1.0f, qidentity()};
    segment_work(op, pick<kSegs>(ballistic, i), pick<kSegs>(dt, i), pick<kSegs>(w, i), &o.c,
                 &o.rot);
    return o;
  });
  for (int i = 0; i < kSegs; ++i) {
    if (op & kDecay) c[i] = out[i].c;
    if (op & kRotation) rot[i] = out[i].rot;
  }
}
__device__ __forceinline__ void segments(const Helpers& hp, int op, const bool* ballistic,
                                         const float* dt, const f3* w, float* c, f4* rot) {
  hp.segments(op, ballistic, dt, w, c, rot);
}

// _replay: integrate the command stream from t0 to t1 over the pipe's
// slots and the final open segment; frozen: the prediction flavor (start
// velocity v0 and angvel w0 held). The plain version is one loop that
// integrates a piecewise-constant-command segment per slot. Here the loop's
// integer walk first lays out the segments (length, command); the helpers
// compute each segment's decay and rotation; then the segments are chained
// in order with the plain loop's operations.
template <class H>
__device__ Mocap replay(const EnvState& S, int t0_us, int t1_us, bool update_variance,
                        bool frozen, const H& hp) {
  Mocap m = mocap_of(S);
  const f3 v0 = m.vel, w0 = m.angvel;
  PipeView v;
  pipe_ordered(S, v);
  float dt[kSegs];
  f3 acc[kSegs], cmd[kSegs];
  bool ball[kSegs];
  int t = max(t0_us, 0);
  int has = 0, a_cur = 0;
  f3 cur_acc = f3{0.0f, 0.0f, 0.0f}, cur_angvel = f3{0.0f, 0.0f, 0.0f};
  bool cur_ball = true;
  for (int i = 0; i < kSegs; ++i) {
    int dt_us;
    if (i < kPipeCap) {
      int remaining = max(wsub(t1_us, t), 0);
      int window = has != 0 ? wsub(v.act[i], a_cur) : (1 << 30);
      dt_us = v.act[i] <= t ? 0 : min(remaining, window);
    } else {  // final segment to t1 (the newest message's window is unbounded)
      dt_us = max(wsub(t1_us, t), 0);
    }
    dt[i] = static_cast<float>(dt_us) * 1e-6f;
    acc[i] = cur_acc;
    cmd[i] = cur_angvel;
    ball[i] = cur_ball;
    t = wadd(t, dt_us);
    if (i < kPipeCap && v.act[i] <= t) {
      cur_acc = v.acc[i];
      cur_angvel = v.angvel[i];
      cur_ball = v.ballistic[i];
      a_cur = v.act[i];
      has = 1;
    }
  }
  float c[kSegs];
  f3 w[kSegs];  // the angular velocity each segment's attitude turns by
  f4 rot[kSegs];
  for (int i = 0; i < kSegs; ++i) w[i] = w0;
  if (frozen) {  // w0 throughout: decays and rotations in one request
    segments(hp, kDecay | kRotation, ball, dt, w, c, rot);
  } else {  // each segment turns by the angular velocity the decays leave it
    segments(hp, kDecay, ball, dt, w, c, rot);
    f3 angvel = m.angvel;
    for (int i = 0; i < kSegs; ++i) {
      w[i] = angvel;
      angvel = add(scl(angvel, c[i]), scl(cmd[i], 1.0f - c[i]));
    }
    segments(hp, kRotation, ball, dt, w, c, rot);
  }
  for (int i = 0; i < kSegs; ++i) {
    if (frozen) m.pos = add(add(m.pos, scl(v0, dt[i])), scl(acc[i], dt[i] * dt[i] * 0.5f));
    else m.pos = add(m.pos, scl(m.vel, dt[i]));
    m.att = qmul(m.att, rot[i]);
    m.vel = add(m.vel, scl(acc[i], dt[i]));
    m.angvel = add(scl(m.angvel, c[i]), scl(cmd[i], 1.0f - c[i]));
    if (update_variance) {
      step_var(m.vp, kProcStdPos, dt[i]);
      step_var(m.va, kProcStdAtt, dt[i]);
    }
  }
  return m;
}

__device__ __forceinline__ void mocap_store(EnvState& S, const Mocap& m) {
  st3(S.mc_pos, m.pos);
  st3(S.mc_vel, m.vel);
  st4(S.mc_att, m.att);
  st3(S.mc_angvel, m.angvel);
}

// UpdateWithMeasurement: replay the pipe to now, 6-sigma gate, 2x2 KF
// corrections, force-accept + reset after 10 straight rejections
template <class H>
__device__ void mocap_update(EnvState& S, int now_us, f3 meas_pos, f4 meas_att, int dt_advance_us,
                             const H& hp) {
  const float meas_var_pos = static_cast<float>(0.02 * 0.02);
  const float meas_var_att = static_cast<float>((5.0 * 3.14159265358979323846 / 180.0) *
                                                (5.0 * 3.14159265358979323846 / 180.0));
  if (!S.mc_initialized) {
    S.mc_initialized = 1;
    st3(S.mc_pos, meas_pos);
    st3(S.mc_vel, f3{0.0f, 0.0f, 0.0f});
    st4(S.mc_att, meas_att);
    st3(S.mc_angvel, f3{0.0f, 0.0f, 0.0f});
    const float vp0[4] = {25.0f, 0.0f, 0.0f, 25.0f}, va0[4] = {1.0f, 0.0f, 0.0f, 400.0f};
    for (int i = 0; i < 4; ++i) {
      S.mc_var_pos[i] = vp0[i];
      S.mc_var_att[i] = va0[i];
    }
    S.mc_us_since_good_meas = 0;
    return;
  }
  SECTION_BEGIN(kSecReplayUpdate)
  Mocap r = replay(S, S.mc_estimate_us, now_us, true, false, hp);
  SECTION_END(kSecReplayUpdate)

  float innov_pos = r.vp[0] + meas_var_pos;
  float innov_att = r.va[0] + meas_var_att;
  float dist_pos = norm3(sub(meas_pos, r.pos)) / sqrtf(3.0f * innov_pos);
  float dist_att = get_angle(qmul(qinv(meas_att), r.att)) / sqrtf(innov_att);
  bool should_reject = dist_pos > kMeasRejectDist || dist_att > kMeasRejectDist;
  bool force_accept = S.mc_num_rejected_consec >= kMaxConsecutiveReject;
  bool reject = should_reject && !force_accept;

  // variances as full 2x2 (row-major), replayed ones symmetric
  float vpr[4] = {r.vp[0], r.vp[1], r.vp[1], r.vp[2]};
  float var[4] = {r.va[0], r.va[1], r.va[1], r.va[2]};
  float vp_f[4], va_f[4];
  Mocap out = r;
  if (reject) {
    for (int i = 0; i < 4; ++i) {
      vp_f[i] = vpr[i];
      va_f[i] = var[i];
    }
  } else {
    // force-accept zeroes the state and resets the variance before the update
    const f3 z3 = f3{0.0f, 0.0f, 0.0f};
    f3 pos_u = force_accept ? z3 : r.pos, vel_u = force_accept ? z3 : r.vel;
    f4 att_u = force_accept ? qidentity() : r.att;
    f3 angvel_u = force_accept ? z3 : r.angvel;
    const float vp0[4] = {25.0f, 0.0f, 0.0f, 25.0f}, va0[4] = {1.0f, 0.0f, 0.0f, 400.0f};
    float vpu[4], vau[4];
    for (int i = 0; i < 4; ++i) {
      vpu[i] = force_accept ? vp0[i] : vpr[i];
      vau[i] = force_accept ? va0[i] : var[i];
    }
    float dp = vpu[0] + meas_var_pos, da = vau[0] + meas_var_att;
    float gp0 = vpu[0] / dp, gp1 = vpu[2] / dp;
    float ga0 = vau[0] / da, ga1 = vau[2] / da;

    f3 err_pos = sub(meas_pos, pos_u);
    out.pos = add(pos_u, scl(err_pos, gp0));
    out.vel = add(vel_u, scl(err_pos, gp1));
    f3 err_att = to_rotation_vector(qmul(qinv(att_u), meas_att));
    out.att = qmul(att_u, from_rotation_vector(scl(err_att, ga0)));
    out.angvel = add(angvel_u, scl(err_att, ga1));

    // (I - K e0^T) V
    const float ikp[4] = {1.0f - gp0 * 1.0f, 0.0f - gp0 * 0.0f, 0.0f - gp1 * 1.0f,
                          1.0f - gp1 * 0.0f};
    const float ika[4] = {1.0f - ga0 * 1.0f, 0.0f - ga0 * 0.0f, 0.0f - ga1 * 1.0f,
                          1.0f - ga1 * 0.0f};
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j) {
        vp_f[2 * i + j] = ikp[2 * i] * vpu[j] + ikp[2 * i + 1] * vpu[2 + j];
        va_f[2 * i + j] = ika[2 * i] * vau[j] + ika[2 * i + 1] * vau[2 + j];
      }
  }
  mocap_store(S, out);
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) {
      S.mc_var_pos[2 * i + j] = 0.5f * (vp_f[2 * i + j] + vp_f[2 * j + i]);
      S.mc_var_att[2 * i + j] = 0.5f * (va_f[2 * i + j] + va_f[2 * j + i]);
    }
  // force-accept calls Reset(): the next measurement re-initializes
  S.mc_initialized = force_accept ? 0 : 1;
  S.mc_estimate_us = now_us;
  S.mc_us_since_good_meas =
      reject ? min(wadd(S.mc_us_since_good_meas, dt_advance_us), 1 << 30) : 0;
  S.mc_num_rejected = wadd(S.mc_num_rejected, reject ? 1 : 0);
  S.mc_num_rejected_consec = reject ? wadd(S.mc_num_rejected_consec, 1) : 0;
  pipe_clear_expired(S, now_us);
}

// GetPrediction: forward-simulate the latency (estimate at now + latency)
template <class H>
__device__ __forceinline__ Mocap mocap_get_prediction(const EnvState& S, int now_us, int latency_us,
                                                     const H& hp) {
  return replay(S, S.mc_estimate_us, wadd(now_us, latency_us), false, true, hp);
}

// ---------------------------------------------------------------------------
// offboard/controller.py: run
// ---------------------------------------------------------------------------

__device__ void offboard_run(const EnvParams& P, f3 cur_pos, f3 cur_vel, f4 cur_att, f3 des_pos,
                             f3 des_vel, f3 des_acc, float des_yaw, f3* cmd_angvel,
                             float* cmd_thrust) {
  const f3 e3 = f3{0.0f, 0.0f, 1.0f};
  f3 cmd_acc = position_control(P.c_pos_nat_freq, P.c_pos_damping, cur_pos, cur_vel, des_pos,
                                des_vel, des_acc);
  f3 proper = add(cmd_acc, f3{0.0f, 0.0f, 9.81f});
  float norm = norm3(proper);
  if (norm > P.c_max_proper_acc) proper = scl(proper, P.c_max_proper_acc / norm);
  proper.z = tmax(proper.z, P.c_min_vertical_proper_acc);
  norm = norm3(proper);
  f3 thrust_dir = dvs(proper, norm < 1e-12f ? 1.0f : norm);
  float thrust = norm * dot3(rotate(cur_att, e3), thrust_dir);
  *cmd_thrust = tmax(thrust, P.c_min_proper_acc);
  f4 cmd_att = thrust_dir_to_attitude(thrust_dir);
  cmd_att = qmul(cmd_att, from_rotation_vector(f3{0.0f, 0.0f, des_yaw}));
  *cmd_angvel = attitude_control(P.c_att_tc_xy, P.c_att_tc_z, cmd_att, cur_att);
}

// ---------------------------------------------------------------------------
// sim/env.py: the physics half of one tick
// ---------------------------------------------------------------------------

// a ranging network's radio table: the env's vehicle and up to 32 anchors
// (K5's UWB variant), or a fleet's vehicles and anchors (fleet_uwb.cu)
constexpr int kMaxRadios = 33;

#ifdef TICK_UWB

// sim/uwb.py step for the env's network (the vehicle is radio 0 and ranges
// to its next target, the anchors are radios 1.. at the target table's
// positions); draws: the tick's u_outlier, n_outlier, n_noise, u_fail.
__device__ UwbMeas uwb_step(const EnvParams& P, EnvState& S, const float* draws) {
  const int ti = min(max(S.next_target_idx, 0), 31);
  const int my_target = P.l_num_targets > 0 ? P.l_target_ids[ti] : 0;
  const int acc = min(wadd(S.uwb_acc_us, P.dt_us), 100000000);
  const bool due = acc >= P.u_comm_period_us;

  // phase 1: the vehicle latches a transaction with its target
  const bool any_wants = 0 < P.u_num_radios && my_target != 0;
  const int latch_req = any_wants ? P.u_radio_ids[0] : 0;
  const int latch_res = any_wants ? my_target : 0;

  // phase 2: complete the pending one
  int req = -1, res = -1;
  for (int r = 0; r < kMaxRadios; ++r) {
    const bool used = r < P.u_num_radios;
    if (req < 0 && used && P.u_radio_ids[r] == S.uwb_requester_id) req = r;
    if (res < 0 && used && P.u_radio_ids[r] == S.uwb_responder_id) res = r;
  }
  const bool have_both = req >= 0 && res >= 0;
  req = max(req, 0);
  res = max(res, 0);
  const f3 req_pos = req == 0 ? ld3(S.plant_pos) : ld3(P.l_target_positions + 3 * (req - 1));
  const f3 res_pos = res == 0 ? ld3(S.plant_pos) : ld3(P.l_target_positions + 3 * (res - 1));
  const float true_range = norm3(sub(req_pos, res_pos));
  const float outlier_range = draws[1] * P.u_outlier_std;
  const float noisy_range = true_range + draws[2] * P.u_noise_std;
  const float meas_range = draws[0] < P.u_outlier_prob ? outlier_range : noisy_range;
  const bool failed = draws[3] < P.u_failure_prob;

  const bool pending = S.uwb_pending;
  const bool complete = due && pending && have_both && true_range <= P.u_max_range;
  const bool finish = due && pending;
  const bool latch = due && !pending;
  const UwbMeas m{complete, complete && !failed ? meas_range : 0.0f,
                  complete ? S.uwb_responder_id : 0, complete && failed};
  S.uwb_acc_us = latch ? 0 : acc;
  S.uwb_pending = latch ? any_wants : (pending && !finish);
  S.uwb_requester_id = latch ? latch_req : (finish ? 0 : S.uwb_requester_id);
  S.uwb_responder_id = latch ? latch_res : (finish ? 0 : S.uwb_responder_id);
  return m;
}
#endif

// the offboard estimator modes (sim/env.py use_estimator False, True,
// "gpsimu")
enum { kEstTrue = 0, kEstMocap = 1, kEstGpsimu = 2 };

// physics_phase_a: radio delivery, plant (under ext_force and ext_torque)
// and IMU of one tick, on the tick's noise (gyro, then acc unit normals).
struct PhaseA {
  bool delivered;
  int mtype, mflags, mfields[kNumFields];
  f3 gyro_meas, acc_meas;
};

__device__ PhaseA physics_phase_a(const EnvParams& P, EnvState& S, const float* noise,
                                  f3 ext_force, f3 ext_torque) {
  const f3 grav = f3{0.0f, 0.0f, kGravZ};
  const m3 imu_rot_inv = ldm(P.p_imu_rot_inv);
  float dt = static_cast<float>(P.dt_us) * 1e-6f;
  PhaseA a;
  SECTION_BEGIN(kSecRadio)
  a.delivered = ring_pop_due(S, S.step, P.dt_us, P.radio_delay_us, &a.mtype, &a.mflags,
                             a.mfields);
  SECTION_END(kSecRadio)
  float motor_cmds[4];
  for (int i = 0; i < 4; ++i) motor_cmds[i] = S.des_motor_speeds[i];
  SECTION_BEGIN(kSecPlant)
  f3 acc_imu = plant_step(P, S, motor_cmds, dt, ext_force, ext_torque);
  SECTION_END(kSecPlant)
  SECTION_BEGIN(kSecImu)
  f3 angvel = ld3(S.plant_angvel);
  f4 att = ld4(S.plant_att);
  f3 gyro_true = mv3(imu_rot_inv, angvel);
  f3 acc_true = mv3(imu_rot_inv, rotate_back(att, sub(acc_imu, grav)));
  f3 gyro_meas = add(gyro_true, scl(ld3(noise), 0.1f));
  f3 acc_meas = add(acc_true, scl(ld3(noise + 3), 0.2f));
  a.gyro_meas = add(gyro_true, scl(sub(gyro_meas, gyro_true), P.noise_scale));
  a.acc_meas = add(acc_true, scl(sub(acc_meas, acc_true), P.noise_scale));
  SECTION_END(kSecImu)
  return a;
}

// The rest of physics_tick after phase A: onboard logic (with the source
// `uwb` of the network's broadcast, where ranging is built) and the
// estimator update. est: kEst*. predict: compute the estimate (a tick whose
// offboard loop does not fire never reads it; the mocap prediction has no
// side effect). Returns the estimate (pos, vel, att, angvel; zeros without
// predict) and now_us (master time after this tick).
#ifdef TICK_RANGING
template <class H, class U>
__device__ Mocap physics_finish(const EnvParams& P, EnvState& S, const PhaseA& a, int est,
                                bool predict, int* now_us, const H& hp, const U& uwb) {
#else
template <class H>
__device__ Mocap physics_finish(const EnvParams& P, EnvState& S, const PhaseA& a, int est,
                                bool predict, int* now_us, const H& hp) {
#endif
  float dt = static_cast<float>(P.dt_us) * 1e-6f;
  const f3 angvel = ld3(S.plant_angvel);
  const f4 att = ld4(S.plant_att);

  // onboard logic tick (constant battery)
  SECTION_BEGIN(kSecLogic)
#ifdef TICK_RANGING
  logic_step(P, S, a.gyro_meas, a.acc_meas, a.delivered, a.mtype, a.mflags, a.mfields, uwb);
#else
  logic_step(P, S, a.gyro_meas, a.acc_meas, a.delivered, a.mtype, a.mflags, a.mfields);
#endif
  SECTION_END(kSecLogic)

  *now_us = wmul(wadd(S.step, 1), P.dt_us);

  // 200 Hz mocap measurement -> estimator update; the IMU prediction and
  // the 100 Hz GPS fix of the GPS-IMU estimator; the accumulator of a mode
  // that does not run grows on
  int mocap_acc = wadd(S.mocap_acc_us, P.dt_us);
  if (est == kEstMocap && mocap_acc > P.mocap_period_us) {
    mocap_acc = wsub(mocap_acc, P.mocap_period_us);
    SECTION_BEGIN(kSecMocapUpdate)
    mocap_update(S, *now_us, ld3(S.plant_pos), att, P.mocap_period_us, hp);
    SECTION_END(kSecMocapUpdate)
  }
  S.mocap_acc_us = mocap_acc;
  int gps_acc = wadd(S.gps_acc_us, P.dt_us);
  if (est == kEstGpsimu) {
    ekf_predict<true>(EKF_OF(S, gps_), a.gyro_meas, a.acc_meas, dt);
    if (gps_acc > 10000) {
      gps_acc = wsub(gps_acc, 10000);
      gps_position_update(EKF_OF(S, gps_), ld3(S.plant_pos));
    }
  }
  S.gps_acc_us = gps_acc;
  Mocap est_out{};
  if (!predict) return est_out;
  if (est == kEstMocap) {
    SECTION_BEGIN(kSecPrediction)
    est_out = mocap_get_prediction(S, *now_us, P.est_latency_us, hp);
    SECTION_END(kSecPrediction)
    return est_out;
  }
  if (est == kEstGpsimu) {
    est_out.pos = ld3(S.gps_pos);
    est_out.vel = ld3(S.gps_vel);
    est_out.att = ld4(S.gps_att);
    est_out.angvel = ld3(S.gps_angvel);
    return est_out;
  }
  est_out.pos = ld3(S.plant_pos);
  est_out.vel = ld3(S.plant_vel);
  est_out.att = att;
  est_out.angvel = angvel;
  return est_out;
}

#if defined(TICK_UWB) || !defined(TICK_RANGING)
// physics_tick: phase A, in the UWB variant the env's ranging network (on
// the tick's draws), then physics_finish. (A build with TICK_RANGING alone
// steps its network outside and calls the two halves itself.)
template <class H>
__device__ Mocap physics_tick(const EnvParams& P, EnvState& S, const float* noise,
                              f3 ext_force, f3 ext_torque, int est, bool predict,
                              int* now_us, const H& hp, const float* draws = nullptr) {
  const PhaseA a = physics_phase_a(P, S, noise, ext_force, ext_torque);
#ifdef TICK_UWB
  const UwbMeas uwb = uwb_step(P, S, draws);
  return physics_finish(P, S, a, est, predict, now_us, hp, uwb);
#else
  return physics_finish(P, S, a, est, predict, now_us, hp);
#endif
}
#endif

// ---------------------------------------------------------------------------
// sim/env.py: _offboard_and_finish, the 100 Hz offboard loop of one tick
// ---------------------------------------------------------------------------

// sim/env.py Command, one env's row
struct Cmd {
  f3 des_pos, des_vel, des_acc;
  float des_yaw;
  f3 ext_force, ext_torque;
};

enum { kCtrlRates = 0, kCtrlPosition = 1, kCtrlIdle = 2 };

// The offboard loop after physics_tick: where it fires, control on the
// estimate est_out, the ctrl (kCtrl*) command into the radio ring and, with
// the mocap estimator, into its prediction pipe; then the offboard
// accumulator (acc_us, already advanced) and the step. step: the tick's
// step before physics.
__device__ void offboard_finish(const EnvParams& P, EnvState& S, const Cmd& c,
                                const Mocap& est_out, bool fire, int acc_us, int step,
                                int now_us, int est, int ctrl) {
  if (fire) {
    SECTION_BEGIN(kSecOffboard)
    f3 cmd_angvel;
    float cmd_thrust;
    offboard_run(P, est_out.pos, est_out.vel, est_out.att, c.des_pos, c.des_vel, c.des_acc,
                 c.des_yaw, &cmd_angvel, &cmd_thrust);
    int type = kTypeIdleCmd, fields[kNumFields] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
    if (ctrl == kCtrlRates) {
      type = kTypeExternalRatesCmd;
      fields[0] = encode_field(cmd_thrust, kLimRates[0]);
      fields[1] = encode_field(cmd_angvel.x, kLimRates[1]);
      fields[2] = encode_field(cmd_angvel.y, kLimRates[2]);
      fields[3] = encode_field(cmd_angvel.z, kLimRates[3]);
    } else if (ctrl == kCtrlPosition) {  // forward the setpoint; zero acceleration
      type = kTypePositionCmd;
      const float vals[9] = {c.des_pos.x, c.des_pos.y, c.des_pos.z, c.des_vel.x, c.des_vel.y,
                             c.des_vel.z, 0.0f, 0.0f, 0.0f};
      for (int i = 0; i < 9; ++i) fields[i] = encode_field(vals[i], kLimPos[i]);
    }
    ring_push(S, type, 0, fields, step, true);
    if (est == kEstMocap) {  // the command enters the prediction pipe
      f3 pred_acc = add(scl(rotate(est_out.att, f3{0.0f, 0.0f, 1.0f}), cmd_thrust),
                        f3{0.0f, 0.0f, kGravZ});
      pipe_push(S, now_us, P.est_latency_us, pred_acc, cmd_angvel, true);
    }
    S.last_cmd_thrust = cmd_thrust;
    st3(S.last_cmd_angvel, cmd_angvel);
    SECTION_END(kSecOffboard)
  }
  S.offboard_acc_us = acc_us;
  S.step = wadd(step, 1);
}

// ---------------------------------------------------------------------------
// io/telemetry.py: encode_from_logic (the topic bridge's telemetry packets)
// ---------------------------------------------------------------------------

constexpr int kTelCodes = 14;  // codes a packet

// _encode: x over the range (a, b) to its uint16 wire code, 0 out of range
// (encode_ones truncates toward zero like .to(torch.int32))
__device__ __forceinline__ int tel_code(float x, float a, float b) {
  const float t = ((x - a) / (b - a)) * 2.0f - 1.0f;
  return (t >= -1.0f && t <= 1.0f) ? static_cast<int>(32768.0f + 32767.0f * t) : 0;
}

// Both packets of the logic's state: the packet number, d1 (acc lp, gyro
// lp, desired motor forces, kf.pos, battery) and d2 (kf.vel, kf.att's
// vector part, debug, panic_reason, warnings); then the logic's change as
// the packets are sent: the counter advances and the warnings clear.
__device__ void encode_telemetry(EnvState& S, int& number, int (&d1)[kTelCodes],
                                 int (&d2)[kTelCodes]) {
  const float att_sign = S.kf_att[0] > 0.0f ? 1.0f : -1.0f;  // rotation.to_vector_part
  for (int i = 0; i < 3; ++i) {
    d1[i] = tel_code(S.acc_lp_ym1[i], -30.0f, 30.0f);
    d1[3 + i] = tel_code(S.gyro_lp_ym1[i], -35.0f, 35.0f);
    d1[10 + i] = tel_code(S.kf_pos[i], -30.0f, 30.0f);
    d2[i] = tel_code(S.kf_vel[i], -30.0f, 30.0f);
    d2[3 + i] = tel_code(att_sign * S.kf_att[1 + i], -1.0f, 1.0f);
  }
  for (int i = 0; i < 4; ++i) d1[6 + i] = tel_code(S.des_motor_forces[i], 0.0f, 10.0f);
  d1[13] = tel_code(S.batt_voltage, 0.0f, 15.0f);
  for (int i = 0; i < 6; ++i) d2[6 + i] = tel_code(S.debug[i], -100.0f, 100.0f);
  d2[12] = S.panic_reason;
  d2[13] = S.warnings;
  number = ((S.tel_counter % 256) + 256) % 256;  // torch's %: the divisor's sign
  S.tel_counter = wadd(S.tel_counter, 1);
  S.warnings = 0;
}

#ifdef TICK_WIND
// sim/fleet_env.py's gust process for one vehicle and tick, in front of the
// tick: wind_vel <- wind_vel + dt / tau (mean - wind_vel) + (sqrt(2 dt /
// tau) sigma) n on the tick's three unit normals `gust`; returns the
// force gain (wind_vel - the plant's velocity before the tick).
__device__ f3 wind_force(const EnvParams& P, EnvState& S, const float* gust) {
  const float dt = static_cast<float>(P.dt_us) * 1e-6f;
  const float pull = dt / P.w_gust_tau;
  const float kick = sqrtf(2.0f * dt / P.w_gust_tau) * P.w_gust_std;
  const f3 w = ld3(S.wind_vel);
  const f3 w_new = add(add(w, scl(sub(ld3(P.w_mean), w), pull)), scl(ld3(gust), kick));
  st3(S.wind_vel, w_new);
  return scl(sub(w_new, ld3(S.plant_vel)), P.w_force_gain);
}
#endif

}  // namespace
