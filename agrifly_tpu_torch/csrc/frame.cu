// The fused tick block: 16 ticks of the orchard frame's physics, onboard
// logic, estimator and offboard tracking, one warp per vehicle.
//
// Replaces the TPU kernel agrifly_tpu/sim/pallas_frame.py (frame_ticks,
// the pallas_call built in _get_call), which evaluates the traced jaxpr of
// orchard_env._sim_tick inside one kernel. Here the tick chain is written
// out by hand as device functions: sim/env's tick in tick.cuh (shared with
// the env rollout kernel, rollout.cu, and written as tick.cuh says), the
// orchard's trajectory tracking below.
//
// What bounds it on the card: one vehicle's serial chain of dependent
// float operations. Clock64 section timers on an H100 (chip_smoke.py's
// frame_sections) put ~50k cycles in a tick of a thread that runs
// everything itself: the two mocap replays ~47%, the offboard controller
// ~20%, the onboard logic ~17%, the plant ~5%; and ~18k cycles a launch in
// reading and writing the ~1000 state and parameter values one at a time.
// So the design (a block of kVehicles warps, warp w for vehicle
// blockIdx.x * kVehicles + w):
//   - the vehicle's State and the block's Params live in shared memory; the
//     warp's 32 lanes copy them in and the written leaves out together,
//     walking flat per-element tables built at compile time from the leaf
//     tables below, eight loads in flight per lane;
//   - lane 0 (the leader) runs the tick chain alone, as one thread of a
//     one-thread-per-vehicle kernel would (Helpers is then empty);
//   - the replay's 9 segments are spread over lanes 1-9 (the helpers),
//     which wait at __syncwarp for the leader's requests: each segment's
//     decay exp and its rotation from_rotation_vector, the costly parts of
//     a segment, one segment a lane (one request for the prediction, whose
//     rotations need no decay; two for the measurement update); the leader
//     then chains the segments in the plain loop's order, so every output
//     keeps its operation order and value.
// The covariance predict (cov_predict_block) stays serial: the timers saw
// it run on no tick of the orchard frame, whose estimator gets no UWB fix.
// Nothing is read or written between ticks.
//
// The leaf tables are the contract with sim/cuda_frame.py, which parses
// them: tick.cuh's env tables (OrchardEnvState.base, OrchardEnvParams.base)
// and then the orchard's own below, the order, dtype and element count (0
// for a 0-d tensor) of the state leaves (convert.leaves order) and of the
// parameter leaves the ticks read. W leaves are written to the three flat
// output buffers (by dtype, in table order); P leaves pass through (the
// wrapper returns the input tensors).

// Section timers, compiled only with -DFRAME_SECTIONS (chip_smoke.py's
// frame_sections builds that variant): clock64() cycles and runs of each
// Section of the tick chain on block 0's thread 0 (vehicle 0's leader), read
// and reset by frame_sections_read. Without the define they are empty.
enum Section {
  kSecTicks, kSecPlant, kSecLogic, kSecEkfPredict, kSecCovPredict, kSecMocapUpdate,
  kSecReplayUpdate, kSecPrediction, kSecOffboard, kSecRadio, kSecImu, kNumSections
};
#ifdef FRAME_SECTIONS
__device__ unsigned long long g_sec[kNumSections], g_cnt[kNumSections];
#define SECTION_BEGIN(k) const long long section_start_##k = clock64();
#define SECTION_END(k)                                  \
  if (blockIdx.x == 0 && threadIdx.x == 0) {            \
    g_sec[k] += clock64() - section_start_##k;          \
    g_cnt[k] += 1;                                      \
  }
#else
#define SECTION_BEGIN(k)
#define SECTION_END(k)
#endif

#include "tick.cuh"

// K9's arguments, passed by value from sim/cuda_percept.py (its ctypes
// structure mirrors it); outside the anonymous namespace so the extern "C"
// launch function keeps external linkage.
struct HeadArgs {
  const float* waypoints;    // (max_waypoints, 3)
  const int* num_waypoints;  // 0-d
  const float *focal, *cx, *cy;  // the planner's camera, 0-d
  float mount[4];            // the camera mount quaternion (raycast.DEPTH_CAM_Q)
  float waypoint_radius;
  float px0, px_span, py0, py_span;  // samples_from_uniform's float32 constants
  int max_waypoints;
  int land;
};


// The orchard's state leaves after OrchardEnvState.base, and its parameter
// leaves after OrchardEnvParams.base.
// clang-format off
#define ORCHARD_STATE_LEAVES(X) \
  X(pl_planned, "planned.planned", BOOL, 0, P)                            \
  X(pl_alpha, "planned.alpha", F32, 3, P)                                 \
  X(pl_beta, "planned.beta", F32, 3, P)                                   \
  X(pl_gamma, "planned.gamma", F32, 3, P)                                 \
  X(pl_a0, "planned.a0", F32, 3, P)                                       \
  X(pl_v0, "planned.v0", F32, 3, P)                                       \
  X(pl_p0, "planned.p0", F32, 3, P)                                       \
  X(pl_tf, "planned.tf", F32, 0, P)                                       \
  X(pl_att, "planned.att", F32, 4, P)                                     \
  X(pl_offset, "planned.offset", F32, 3, P)                               \
  X(pl_start_step, "planned.start_step", I32, 0, P)                       \
  X(pl_grav_cam, "planned.grav_cam", F32, 3, P)                           \
  X(plan_count, "plan_count", I32, 0, P)                                  \
  X(frame_count, "frame_count", I32, 0, P)                                \
  X(waypoint_idx, "waypoint_idx", I32, 0, P)                              \
  X(mstage, "mstage", I32, 0, W)                                          \
  X(land_pos, "land_pos", F32, 3, P)                                      \
  X(land_start_step, "land_start_step", I32, 0, P)

#define ORCHARD_PARAM_LEAVES(X) \
  X(start_flight_step, "start_flight_step", I32, 0)                       \
  X(takeoff_height, "takeoff_height", F32, 0)                             \
  X(track_lookahead, "track_lookahead", F32, 0)
// clang-format on

namespace {

// ---------------------------------------------------------------------------
// the per-vehicle state and parameters: the env's (tick.cuh) and the orchard's
// ---------------------------------------------------------------------------

struct State {
  EnvState base;
#define X(name, path, ty, n, rw) Leaf<ty##_t, n>::type name;
  ORCHARD_STATE_LEAVES(X)
#undef X
};

struct Params {
  EnvParams base;
#define X(name, path, ty, n) Leaf<ty##_t, n>::type name;
  ORCHARD_PARAM_LEAVES(X)
#undef X
};

constexpr int kNumState = kNumEnvState ORCHARD_STATE_LEAVES(COUNT_LEAF);
constexpr int kNumParam = kNumEnvParam ORCHARD_PARAM_LEAVES(COUNT_LEAF);
constexpr int kStateElems = kEnvStateElems ORCHARD_STATE_LEAVES(COUNT_STATE);
constexpr int kParamElems = kEnvParamElems ORCHARD_PARAM_LEAVES(COUNT_PARAM);

// the leaves' device pointers, passed to the kernel by value (~1.6 KB of
// the 4 KB parameter space)
struct LeafPtrs {
  const void* state[kNumState];
  const void* params[kNumParam];
};

constexpr Elems<kStateElems> make_state_elems() {
  Elems<kStateElems> t{};
  int k = 0, leaf = 0, prefix[3] = {0, 0, 0};
#define X(name, path, ty, n, rw) \
  ADD_STATE_ELEMS(offsetof(State, base) + offsetof(EnvState, name), ty, n, rw)
  ENV_STATE_LEAVES(X)
#undef X
#define X(name, path, ty, n, rw) ADD_STATE_ELEMS(offsetof(State, name), ty, n, rw)
  ORCHARD_STATE_LEAVES(X)
#undef X
  return t;
}

constexpr Elems<kParamElems> make_param_elems() {
  Elems<kParamElems> t{};
  int k = 0, leaf = 0;
#define X(name, path, ty, n) \
  ADD_PARAM_ELEMS(offsetof(Params, base) + offsetof(EnvParams, name), ty, n)
  ENV_PARAM_LEAVES(X)
#undef X
#define X(name, path, ty, n) ADD_PARAM_ELEMS(offsetof(Params, name), ty, n)
  ORCHARD_PARAM_LEAVES(X)
#undef X
  return t;
}

// in device memory: the lanes read different entries at once
__device__ const Elems<kStateElems> kStateTable = make_state_elems();
__device__ const Elems<kParamElems> kParamTable = make_param_elems();

// ---------------------------------------------------------------------------
// offboard/controller.py: run_tracking (zero yaw)
// ---------------------------------------------------------------------------

__device__ void offboard_run_tracking(const EnvParams& P, f3 cur_pos, f3 cur_vel, f4 cur_att,
                                      f3 ref_pos, f3 ref_vel, f3 ref_acc, float ref_thrust,
                                      f3 ref_angvel, f3* cmd_angvel, float* cmd_thrust) {
  f3 acc_err = position_control(P.c_pos_nat_freq, P.c_pos_damping, cur_pos, cur_vel, ref_pos,
                                ref_vel, f3{0.0f, 0.0f, 0.0f});
  *cmd_thrust = ref_thrust + dot3(acc_err, rotate(cur_att, f3{0.0f, 0.0f, 1.0f}));
  f3 total = add(add(ref_acc, acc_err), f3{0.0f, 0.0f, 9.81f});
  float norm = norm3(total);
  f3 thrust_dir = dvs(total, norm < 1e-12f ? 1.0f : norm);
  f3 angvel_err = attitude_control(P.c_att_tc_xy, P.c_att_tc_z, thrust_dir_to_attitude(thrust_dir),
                                   cur_att);
  *cmd_angvel = add(ref_angvel, angvel_err);
}

// ---------------------------------------------------------------------------
// planner/traj.py: evaluation of the tracked minimum-jerk trajectory
// ---------------------------------------------------------------------------

struct Traj { f3 alpha, beta, gamma, a0, v0, p0; float tf; };

__device__ f3 traj_position(const Traj& tr, float t) {
  float t2 = ipow2(t), t3 = ipow3(t), t4 = ipow4(t), t5 = ipow5(t);
  f3 r;
  float* o = &r.x;
  const float *p0 = &tr.p0.x, *v0 = &tr.v0.x, *a0 = &tr.a0.x, *g = &tr.gamma.x,
              *b = &tr.beta.x, *al = &tr.alpha.x;
  for (int i = 0; i < 3; ++i)
    o[i] = p0[i] + v0[i] * t + a0[i] * t2 / 2.0f + g[i] * t3 / 6.0f + b[i] * t4 / 24.0f +
           al[i] * t5 / 120.0f;
  return r;
}

__device__ f3 traj_velocity(const Traj& tr, float t) {
  float t2 = ipow2(t), t3 = ipow3(t), t4 = ipow4(t);
  f3 r;
  float* o = &r.x;
  const float *v0 = &tr.v0.x, *a0 = &tr.a0.x, *g = &tr.gamma.x, *b = &tr.beta.x,
              *al = &tr.alpha.x;
  for (int i = 0; i < 3; ++i)
    o[i] = v0[i] + a0[i] * t + g[i] * t2 / 2.0f + b[i] * t3 / 6.0f + al[i] * t4 / 24.0f;
  return r;
}

__device__ f3 traj_acceleration(const Traj& tr, float t) {
  float t2 = ipow2(t), t3 = ipow3(t);
  f3 r;
  float* o = &r.x;
  const float *a0 = &tr.a0.x, *g = &tr.gamma.x, *b = &tr.beta.x, *al = &tr.alpha.x;
  for (int i = 0; i < 3; ++i) o[i] = a0[i] + g[i] * t + b[i] * t2 / 2.0f + al[i] * t3 / 6.0f;
  return r;
}

__device__ __forceinline__ float traj_thrust(const Traj& tr, float t, f3 grav) {
  return norm3(sub(traj_acceleration(tr, t), grav));
}

__device__ __forceinline__ f3 traj_normal(const Traj& tr, float t, f3 grav) {
  f3 n = sub(traj_acceleration(tr, t), grav);
  float norm = norm3(n);
  return dvs(n, norm < 1e-12f ? 1.0f : norm);
}

// finite-difference world-frame body rates rotating the normal vector
__device__ f3 traj_omega(const Traj& tr, float t, float dt, f3 grav) {
  f3 n0 = traj_normal(tr, t, grav);
  f3 n1 = traj_normal(tr, t + dt, grav);
  f3 cr = cross(n0, n1);
  float nrm = norm3(cr);
  bool ok = nrm > 1e-6f;
  f3 unit = dvs(cr, nrm < 1e-12f ? 1.0f : nrm);
  float angle = acos_c(tclamp(dot3(n0, n1), -1.0f, 1.0f)) / dt;
  return ok ? scl(unit, angle) : f3{0.0f, 0.0f, 0.0f};
}

// ---------------------------------------------------------------------------
// sim/orchard_env.py: one 2 ms tick
// ---------------------------------------------------------------------------

constexpr int MSTAGE_CRUISE = 0, MSTAGE_LANDING = 1, MSTAGE_COMPLETE = 2;
constexpr float kLandingSpeed = 0.5f, kLandingBlendTime = 2.0f;

// _tracking_refs: receding-horizon reference state at sim step
__device__ void tracking_refs(const Params& P, const State& S, int step, f3* ref_pos,
                              f3* ref_vel, f3* ref_acc, float* ref_thrust, f3* ref_angvel_w) {
  Traj tr{ld3(S.pl_alpha), ld3(S.pl_beta), ld3(S.pl_gamma), ld3(S.pl_a0),
          ld3(S.pl_v0),    ld3(S.pl_p0),   S.pl_tf};
  const f3 zero3 = f3{0.0f, 0.0f, 0.0f};
  const f3 grav_cam = ld3(S.pl_grav_cam);
  float t = static_cast<float>(wsub(step, S.pl_start_step)) * (static_cast<float>(P.base.dt_us) * 1e-6f);
  bool running = t < tr.tf;
  float t_eval = running ? tmin(t + P.track_lookahead, tr.tf) : tr.tf;
  f3 pos_c = traj_position(tr, t_eval);
  f3 vel_c = running ? traj_velocity(tr, t_eval) : zero3;
  f3 acc_c = running ? traj_acceleration(tr, t_eval) : zero3;

  // disallow going backwards through the camera plane
  bool z_neg = pos_c.z < 0.0f;
  if (z_neg) pos_c.z = 0.0f;
  if (z_neg && vel_c.z < 0.0f) vel_c.z = 0.0f;
  if (z_neg && acc_c.z < 0.0f) acc_c.z = 0.0f;

  m3 R = to_matrix(ld4(S.pl_att));
  float t_thr = tmin(tmax(t, 0.0f), tr.tf);
  *ref_thrust = traj_thrust(tr, t_thr, grav_cam);
  f3 omega_cam = traj_omega(tr, tmin(t_thr, tr.tf - 0.02f), 0.02f, grav_cam);
  *ref_pos = add(mv3(R, pos_c), ld3(S.pl_offset));
  *ref_vel = mv3(R, vel_c);
  *ref_acc = mv3(R, acc_c);
  *ref_angvel_w = mv3(R, omega_cam);
}

// _sim_tick: one tick with tracking/takeoff offboard control; noise: the
// tick's (gyro (3,), acc (3,)) unit normals
__device__ void sim_tick(const Params& P, State& S, const float* noise, const Helpers& hp) {
  const f3 zero3 = f3{0.0f, 0.0f, 0.0f};
  EnvState& E = S.base;
  const int step = E.step;  // the tick's step, before physics
  int now_us;
  Mocap est = physics_tick(P.base, E, noise, zero3, zero3, true, true, &now_us, hp);

  // offboard loop cadence
  int acc_us = wadd(E.offboard_acc_us, P.base.dt_us);
  bool fire = acc_us > P.base.offboard_period_us;
  if (fire) acc_us = wsub(acc_us, P.base.offboard_period_us);
  bool in_flight = step >= P.start_flight_step;

  // takeoff / no-plan hover target, or the landing descent (0.5 m/s with a
  // blend-in)
  f3 hover_pos = in_flight ? f3{0.0f, 0.0f, 2.0f} : f3{0.0f, 0.0f, P.takeoff_height};
  bool landing = S.mstage == MSTAGE_LANDING;
  float t_land = static_cast<float>(max(wsub(step, S.land_start_step), 0)) *
                 (static_cast<float>(P.base.dt_us) * 1e-6f);
  float frac_ld = tclamp(t_land / kLandingBlendTime, 0.0f, 1.0f);
  const f3 descend = f3{0.0f, 0.0f, -kLandingSpeed};
  f3 pos_land = add(ld3(S.land_pos), scl(descend, frac_ld * t_land));
  bool not_cruise = landing || S.mstage == MSTAGE_COMPLETE;
  f3 hover_vel = f3{0.0f, 0.0f, 0.0f};
  if (not_cruise) {
    hover_pos = pos_land;
    hover_vel = scl(descend, frac_ld);
  }

  // touchdown -> complete (motors idled below)
  int mstage = (landing && pos_land.z < 0.0f) ? MSTAGE_COMPLETE : S.mstage;

  bool track = in_flight && S.pl_planned && mstage == MSTAGE_CRUISE;
  f3 cmd_angvel;
  float cmd_thrust;
  SECTION_BEGIN(kSecOffboard)
  if (track) {
    f3 ref_pos, ref_vel, ref_acc, ref_angvel_w;
    float ref_thrust;
    tracking_refs(P, S, step, &ref_pos, &ref_vel, &ref_acc, &ref_thrust, &ref_angvel_w);
    offboard_run_tracking(P.base, est.pos, est.vel, est.att, ref_pos, ref_vel, ref_acc, ref_thrust,
                          rotate_back(est.att, ref_angvel_w), &cmd_angvel, &cmd_thrust);
  } else {
    offboard_run(P.base, est.pos, est.vel, est.att, hover_pos, hover_vel, zero3, 0.0f,
                 &cmd_angvel, &cmd_thrust);
  }
  SECTION_END(kSecOffboard)

  // the rates command (or, once complete, the idle command) into the ring
  int fields[kNumFields] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  bool idle = mstage == MSTAGE_COMPLETE;
  if (!idle) {
    fields[0] = encode_field(cmd_thrust, kLimRates[0]);
    fields[1] = encode_field(cmd_angvel.x, kLimRates[1]);
    fields[2] = encode_field(cmd_angvel.y, kLimRates[2]);
    fields[3] = encode_field(cmd_angvel.z, kLimRates[3]);
  }
  ring_push(E, idle ? kTypeIdleCmd : kTypeExternalRatesCmd, 0, fields, step, fire);

  // latency-compensation feedback into the estimator pipe
  f3 pred_acc = add(scl(rotate(est.att, f3{0.0f, 0.0f, 1.0f}), cmd_thrust),
                    f3{0.0f, 0.0f, kGravZ});
  pipe_push(E, now_us, P.base.est_latency_us, pred_acc, cmd_angvel, fire);

  E.offboard_acc_us = acc_us;
  E.step = wadd(step, 1);
  if (fire) {
    E.last_cmd_thrust = cmd_thrust;
    st3(E.last_cmd_angvel, cmd_angvel);
  }
  S.mstage = mstage;
}

// ---------------------------------------------------------------------------
// the kernel: one warp per vehicle, n_ticks ticks
// ---------------------------------------------------------------------------

constexpr int kVehicles = 4;  // vehicles (warps) per block
constexpr int kThreads = 32 * kVehicles;

__global__ void __launch_bounds__(kThreads) frame_kernel(const __grid_constant__ LeafPtrs ptrs,
                                                         const float* __restrict__ noise,
                                                         float* __restrict__ out_f,
                                                         int* __restrict__ out_i,
                                                         unsigned char* __restrict__ out_b, int B,
                                                         int n_ticks) {
  __shared__ Params P;
  __shared__ State states[kVehicles];
  __shared__ WarpWork work[kVehicles];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kVehicles + warp;
  copy_in(reinterpret_cast<char*>(&P), ptrs.params, kParamTable, 0, threadIdx.x, kThreads);
  __syncthreads();
  if (b >= B) return;  // a whole warp: no barrier of the block follows
  State& S = states[warp];
  copy_in(reinterpret_cast<char*>(&S), ptrs.state, kStateTable, b, lane, 32);
  __syncwarp();

  if (lane == 0) {
    const Helpers hp{&work[warp]};
    const float* nz = noise + static_cast<int64_t>(b) * n_ticks * 6;
    SECTION_BEGIN(kSecTicks)
    for (int k = 0; k < n_ticks; ++k) sim_tick(P, S, nz + 6 * k, hp);
    SECTION_END(kSecTicks)
    hp.release();
  } else {
    help(work[warp], lane);
  }
  __syncwarp();
  copy_out(reinterpret_cast<const char*>(&S), kStateTable, out_f, out_i, out_b, B, b, lane,
           32);
}

// ---------------------------------------------------------------------------
// K9: the orchard frame's percept head (sim/orchard_env.py percept_head_plain)
// ---------------------------------------------------------------------------
//
// Replaces no pallas_call: the JAX package runs it as jnp inside the frame's
// jit call (agrifly_tpu/sim/orchard_env.py _frame_percept:348 with
// offboard/estimators.py:354, render/raycast.py:52 and planner/rappids.py
// :937, :150); in eager PyTorch it was ~1.1k launches a frame. A block a
// vehicle: the state and parameters are copied into shared memory as K3
// copies them; thread 0 runs the mocap prediction (the serial chain,
// Lanes<1>), the camera attitudes and frame and the waypoint and landing
// switch; then a thread a candidate maps the uniform block to samples and
// builds the candidate, its cost and its endpoint seed. What bounds it: the
// prediction's chain (~10k dependent operations, a few µs), then a few
// hundred operations a candidate.

constexpr int kHeadThreads = 256;
// the per-vehicle float fields' offsets (cuda_percept.HEAD_FIELDS), of 29
enum { kHCamAtt = 0, kHEstPos = 4, kHCamAttEst = 7, kHVelCam = 11, kHAccCam = 14,
       kHGravCam = 17, kHGoalWorld = 20, kHGoalCam = 23, kHLandPos = 26 };

__device__ __forceinline__ f4 qnormalize(f4 q) {
  const float n = sqrtf(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z);
  if (n < 1e-6f) return qidentity();
  return f4{q.w / n, q.x / n, q.y / n, q.z / n};
}

__device__ __forceinline__ f3 waypoint(const HeadArgs& a, int idx) {
  return ld3(a.waypoints + 3 * min(max(idx, 0), a.max_waypoints - 1));
}

// field f (offset off, n elements a vehicle) of vehicle b, field-major
__device__ __forceinline__ void put(float* out, int B, int off, int n, int b, const float* v) {
  for (int i = 0; i < n; ++i) out[static_cast<int64_t>(B) * off + b * n + i] = v[i];
}

__global__ void __launch_bounds__(kHeadThreads)
    percept_head_kernel(const __grid_constant__ LeafPtrs ptrs, const HeadArgs a,
                        const float* __restrict__ u, float* __restrict__ out_f,
                        int* __restrict__ out_i, unsigned char* __restrict__ out_b,
                        float* __restrict__ cand, int B, int N) {
  __shared__ Params P;
  __shared__ State S;
  __shared__ f3 shared_vel, shared_acc, shared_goal;
  const int b = blockIdx.x;
  copy_in(reinterpret_cast<char*>(&P), ptrs.params, kParamTable, 0, threadIdx.x, kHeadThreads);
  copy_in(reinterpret_cast<char*>(&S), ptrs.state, kStateTable, b, threadIdx.x, kHeadThreads);
  __syncthreads();
  if (threadIdx.x == 0) {
    const EnvState& E = S.base;
    // the estimator's view, which the planner gets (main.cpp:469,489-495)
    const Mocap m = mocap_get_prediction(E, wmul(E.step, P.base.dt_us), P.base.est_latency_us,
                                         Lanes<1>{0, 1u});
    const f4 qn = qnormalize(m.att);
    const f4 mount{a.mount[0], a.mount[1], a.mount[2], a.mount[3]};
    const f4 cam_att = qmul(ld4(E.plant_att), mount);
    const f4 cam_est = qmul(qn, mount);
    const m3 R = to_matrix(cam_est);  // world-from-camera
    const f3 grav{0.0f, 0.0f, -9.81f};
    const f3 vel_cam = mv3t(R, m.vel);
    const f3 acc_cam = mv3t(R, add(scl(rotate(qn, f3{0.0f, 0.0f, 1.0f}), E.last_cmd_thrust), grav));
    const f3 grav_cam = mv3t(R, grav);

    // waypoint switching at the reference's 1 m radius; after the last
    // waypoint, optionally enter the landing descent
    const bool in_flight = E.step >= P.start_flight_step;
    const int idx = S.waypoint_idx;
    const bool at_wp = in_flight && S.mstage == MSTAGE_CRUISE &&
                       norm3(sub(waypoint(a, idx), m.pos)) < a.waypoint_radius;
    const bool has_next = wadd(idx, 1) < *a.num_waypoints;
    const int new_idx = (at_wp && has_next) ? wadd(idx, 1) : idx;
    int mstage = S.mstage, land_start = S.land_start_step;
    f3 land_pos = ld3(S.land_pos);
    if (a.land && at_wp && !has_next) {
      mstage = MSTAGE_LANDING;
      land_pos = m.pos;
      land_start = E.step;
    }
    const f3 goal_world = waypoint(a, new_idx);
    const f3 goal_cam = mv3t(R, sub(goal_world, m.pos));

    put(out_f, B, kHCamAtt, 4, b, &cam_att.w);
    put(out_f, B, kHEstPos, 3, b, &m.pos.x);
    put(out_f, B, kHCamAttEst, 4, b, &cam_est.w);
    put(out_f, B, kHVelCam, 3, b, &vel_cam.x);
    put(out_f, B, kHAccCam, 3, b, &acc_cam.x);
    put(out_f, B, kHGravCam, 3, b, &grav_cam.x);
    put(out_f, B, kHGoalWorld, 3, b, &goal_world.x);
    put(out_f, B, kHGoalCam, 3, b, &goal_cam.x);
    put(out_f, B, kHLandPos, 3, b, &land_pos.x);
    out_i[b] = new_idx;
    out_i[B + b] = mstage;
    out_i[2 * B + b] = land_start;
    out_b[b] = in_flight ? 1 : 0;
    shared_vel = vel_cam;
    shared_acc = acc_cam;
    shared_goal = goal_cam;
  }
  __syncthreads();

  // the candidates: samples_from_uniform, candidates_from_samples (a
  // rest-to-rest minimum-jerk primitive from the camera origin),
  // exploration_cost and endpoint_seeds
  const f3 v0 = shared_vel, a0 = shared_acc, goal = shared_goal;
  const float focal = *a.focal, cx = *a.cx, cy = *a.cy;
  const float* ub = u + static_cast<int64_t>(b) * 4 * N;
  const int64_t BN = static_cast<int64_t>(B) * N;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const float px = a.px0 + ub[n] * a.px_span;
    const float py = a.py0 + ub[N + n] * a.py_span;
    const float depth = 1.5f + ub[2 * N + n] * 1.5f;
    const float T = 2.0f + ub[3 * N + n] * 1.0f;
    const f3 g{depth * (px - cx) / focal, depth * (py - cy) / focal, depth * 1.0f};
    const float T2 = T * T, T3 = ipow3(T), T4 = ipow4(T), T5 = ipow5(T);
    Traj tr;
    tr.a0 = a0;
    tr.v0 = v0;
    tr.p0 = f3{0.0f, 0.0f, 0.0f};
    tr.tf = T;
    float jerk = 0.0f;
    const float *pa = &a0.x, *pv = &v0.x, *pg = &g.x;
    float *al = &tr.alpha.x, *be = &tr.beta.x, *ga = &tr.gamma.x;
    for (int i = 0; i < 3; ++i) {
      const float da = 0.0f - pa[i];
      const float dv = 0.0f - pv[i] - pa[i] * T;
      const float dp = pg[i] - 0.0f - pv[i] * T - pa[i] * 0.5f * T * T;
      al[i] = (T2 * 60.0f * da - T * 360.0f * dv + dp * 720.0f) / T5;
      be[i] = (T3 * -24.0f * da + T2 * 168.0f * dv - T * 360.0f * dp) / T5;
      ga[i] = (T4 * 3.0f * da - T3 * 24.0f * dv + T2 * 60.0f * dp) / T5;
      const float term = ga[i] * ga[i] + be[i] * ga[i] * T + be[i] * be[i] * T2 / 3.0f +
                         al[i] * ga[i] * T2 / 3.0f + al[i] * be[i] * T3 / 4.0f +
                         al[i] * al[i] * T4 / 20.0f;
      jerk = i == 0 ? term : jerk + term;
    }
    const f3 end = traj_position(tr, T);
    const float cost = -(norm3(goal) - norm3(sub(goal, end))) / T;
    const float safe_z = fabsf(end.z) < 1e-9f ? 1e-9f : end.z;
    const f3* vecs[6] = {&tr.alpha, &tr.beta, &tr.gamma, &tr.a0, &tr.v0, &tr.p0};
    const int64_t row = static_cast<int64_t>(b) * N + n;
    for (int f = 0; f < 6; ++f) st3(cand + f * BN * 3 + 3 * row, *vecs[f]);
    float* sc = cand + 18 * BN + row;
    sc[0] = T;
    sc[BN] = jerk;
    sc[2 * BN] = cost;
    sc[3 * BN] = end.x * focal / safe_z + cx;
    sc[4 * BN] = end.y * focal / safe_z + cy;
    sc[5 * BN] = end.z;
  }
}

}  // namespace

// state, params: the device pointers of the leaves, in table order (host
// arrays of kNumState and kNumParam pointers); noise: (B, n_ticks, 2, 3)
// float32; out_f / out_i / out_b: the W leaves by dtype, in table order,
// [B, numel] each. Returns the cudaError_t of the launch.
extern "C" int frame_ticks_launch(const void* const* state, const void* const* params,
                                  const float* noise, float* out_f, int* out_i,
                                  unsigned char* out_b, int B, int n_ticks, void* stream) {
  LeafPtrs ptrs;
  for (int i = 0; i < kNumState; ++i) ptrs.state[i] = state[i];
  for (int i = 0; i < kNumParam; ++i) ptrs.params[i] = params[i];
  int blocks = (B + kVehicles - 1) / kVehicles;
  frame_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ptrs, noise, out_f, out_i, out_b, B, n_ticks);
  return static_cast<int>(cudaGetLastError());
}

// K9, the percept head: state and params as frame_ticks_launch takes them;
// a: the waypoints, camera, mount and sampler constants; u (B, 4, N)
// float32; out_f (29 B floats, field-major), out_i (3 B), out_b (B) and cand
// (24 B N floats: alpha, beta, gamma, a0, v0, p0 as (B, N, 3), then tf, the
// jerk cost, the cost, epx, epy, endz as (B, N)). Returns the cudaError_t.
extern "C" int percept_head_launch(const void* const* state, const void* const* params,
                                   HeadArgs a, const float* u, float* out_f, int* out_i,
                                   unsigned char* out_b, float* cand, int B, int N,
                                   void* stream) {
  LeafPtrs ptrs;
  for (int i = 0; i < kNumState; ++i) ptrs.state[i] = state[i];
  for (int i = 0; i < kNumParam; ++i) ptrs.params[i] = params[i];
  percept_head_kernel<<<B, kHeadThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ptrs, a, u, out_f, out_i, out_b, cand, B, N);
  return static_cast<int>(cudaGetLastError());
}

#ifdef FRAME_SECTIONS
// sec, cnt: kNumSections cycles and runs each, summed since the last read;
// resets them. Returns the cudaError_t of the copies.
extern "C" int frame_sections_read(unsigned long long* sec, unsigned long long* cnt) {
  unsigned long long zero[kNumSections] = {0};
  cudaError_t e = cudaMemcpyFromSymbol(sec, g_sec, sizeof(g_sec));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(cnt, g_cnt, sizeof(g_cnt));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_sec, zero, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_cnt, zero, sizeof(zero));
  return static_cast<int>(e);
}
#endif
