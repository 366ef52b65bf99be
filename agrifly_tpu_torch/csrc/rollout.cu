// K5, the env rollout: one launch advances B envs through n_steps 2 ms ticks
// of sim/env's step (radio delivery, plant with an external force and
// torque, IMU, onboard logic, the true state or the 200 Hz mocap estimator,
// the 100 Hz offboard controller and its rates, position or idle command
// into the radio delay line), writing the StepOutputs trajectory and the
// final state.
//
// Replaces agrifly_tpu/sim/env.py rollout_fast (:214) under vmap, the
// workload bench.py times: jnp under jit, vmap and scan, which reaches no
// pallas_call. It is built from tick.cuh's device functions (the orchard
// frame's kernel, frame.cu, runs the same ones) and holds rollout's
// semantics: each tick's mocap and offboard cadence comes from the integer
// accumulators, so one kernel serves rollout and rollout_fast. As
// rollout_fast does on its statically silent ticks, a tick whose offboard
// loop does not fire skips the estimate (the mocap prediction replay) and
// the controller: nothing reads them there.
//
// What bounds it on the card: each env's serial chain of dependent float
// operations, ~250 ticks of it per call; the bytes (state in and out, the
// noise block, the trajectory) and the operations are far below the chain's
// latency at any B. So one thread runs one env's chain (Helpers empty), 32
// envs (one warp) a block: 4096 envs are 128 blocks, about one warp per SM.
// Each env's EnvState lives in shared memory at an odd-word stride (a warp's
// 32 threads touch 32 distinct banks), the block's EnvParams beside them.
// frame.cu's layout (a warp per env, lane 0 running the chain and lanes 1-9
// the mocap replay's segments) puts ~31 warps' chains on a SM and ran 2.8x
// (true state) and 1.9x (mocap) slower at bench.py's shape (PERF.md).
//
// The leaves are tick.cuh's tables (EnvState, EnvParams). The command is
// per env ((B, ...) leaves), the noise (B, n_steps, 2, 3) unit normals
// (gyro, then acc), the trajectory (B, n_steps, ...) per StepOutputs leaf.

#include "tick.cuh"

namespace {

// the leaves' device pointers, passed to the kernel by value
struct LeafPtrs {
  const void* state[kNumEnvState];
  const void* params[kNumEnvParam];
};

constexpr Elems<kEnvStateElems> make_state_elems() {
  Elems<kEnvStateElems> t{};
  int k = 0, leaf = 0, prefix[3] = {0, 0, 0};
#define X(name, path, ty, n, rw) ADD_STATE_ELEMS(offsetof(EnvState, name), ty, n, rw)
  ENV_STATE_LEAVES(X)
#undef X
  return t;
}

constexpr Elems<kEnvParamElems> make_param_elems() {
  Elems<kEnvParamElems> t{};
  int k = 0, leaf = 0;
#define X(name, path, ty, n) ADD_PARAM_ELEMS(offsetof(EnvParams, name), ty, n)
  ENV_PARAM_LEAVES(X)
#undef X
  return t;
}

__device__ const Elems<kEnvStateElems> kStateTable = make_state_elems();
__device__ const Elems<kEnvParamElems> kParamTable = make_param_elems();

// sim/env.py Command: (B, 3) leaves but des_yaw (B,)
struct CmdPtrs {
  const float *des_pos, *des_vel, *des_acc, *des_yaw, *ext_force, *ext_torque;
};
struct Cmd {
  f3 des_pos, des_vel, des_acc;
  float des_yaw;
  f3 ext_force, ext_torque;
};

// sim/env.py StepOutputs: (B, n_steps, ...) each
struct TrajPtrs {
  float *pos, *vel, *att, *angvel, *motor_speeds;
  int *flight_state, *panic_reason, *warnings;
};

enum { kCtrlRates = 0, kCtrlPosition = 1, kCtrlIdle = 2 };

__device__ Cmd load_cmd(const CmdPtrs& c, int b) {
  return Cmd{ld3(c.des_pos + 3 * b), ld3(c.des_vel + 3 * b), ld3(c.des_acc + 3 * b),
             c.des_yaw[b], ld3(c.ext_force + 3 * b), ld3(c.ext_torque + 3 * b)};
}

// env.step: physics_tick, then _offboard_and_finish. mocap: the mocap
// estimator (use_estimator=True), else the true state; ctrl: kCtrl*.
__device__ void env_step(const EnvParams& P, EnvState& S, const Cmd& c, const float* noise,
                         bool mocap, int ctrl, const Helpers& hp) {
  const int step = S.step;  // the tick's step, before physics
  int acc_us = wadd(S.offboard_acc_us, P.dt_us);
  const bool fire = acc_us > P.offboard_period_us;
  if (fire) acc_us = wsub(acc_us, P.offboard_period_us);

  int now_us;
  const Mocap est = physics_tick(P, S, noise, c.ext_force, c.ext_torque, mocap, fire, &now_us,
                                 hp);
  if (fire) {
    f3 cmd_angvel;
    float cmd_thrust;
    offboard_run(P, est.pos, est.vel, est.att, c.des_pos, c.des_vel, c.des_acc, c.des_yaw,
                 &cmd_angvel, &cmd_thrust);
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
    if (mocap) {  // the command enters the prediction pipe
      f3 pred_acc = add(scl(rotate(est.att, f3{0.0f, 0.0f, 1.0f}), cmd_thrust),
                        f3{0.0f, 0.0f, kGravZ});
      pipe_push(S, now_us, P.est_latency_us, pred_acc, cmd_angvel, true);
    }
    S.last_cmd_thrust = cmd_thrust;
    st3(S.last_cmd_angvel, cmd_angvel);
  }
  S.offboard_acc_us = acc_us;
  S.step = wadd(step, 1);
}

__device__ void run_steps(const EnvParams& P, EnvState& S, const Cmd& c, const float* noise,
                          const TrajPtrs& tr, int b, int n_steps, bool mocap, int ctrl,
                          const Helpers& hp) {
  const float* nz = noise + static_cast<int64_t>(b) * n_steps * 6;
  for (int k = 0; k < n_steps; ++k) {
    env_step(P, S, c, nz + 6 * k, mocap, ctrl, hp);
    const int64_t row = static_cast<int64_t>(b) * n_steps + k;
    for (int i = 0; i < 3; ++i) {
      tr.pos[3 * row + i] = S.plant_pos[i];
      tr.vel[3 * row + i] = S.plant_vel[i];
      tr.angvel[3 * row + i] = S.plant_angvel[i];
    }
    for (int i = 0; i < 4; ++i) {
      tr.att[4 * row + i] = S.plant_att[i];
      tr.motor_speeds[4 * row + i] = S.plant_motor_speeds[i];
    }
    tr.flight_state[row] = S.fs;
    tr.panic_reason[row] = S.panic_reason;
    tr.warnings[row] = S.warnings;
  }
}

struct Outs {
  float* f;
  int* i;
  unsigned char* b;
};

constexpr int kEnvsPerBlock = 32;
constexpr int kStateStride = 4 * (((sizeof(EnvState) + 3) / 4) | 1);  // odd words
constexpr int kParamsBytes = (sizeof(EnvParams) + 15) / 16 * 16;
constexpr int kSmem = kParamsBytes + kEnvsPerBlock * kStateStride;

__global__ void __launch_bounds__(kEnvsPerBlock)
    rollout_kernel(const __grid_constant__ LeafPtrs ptrs, const CmdPtrs cmd,
                   const float* __restrict__ noise, const Outs out, const TrajPtrs tr, int B,
                   int n_steps, int mocap, int ctrl) {
  extern __shared__ __align__(16) char smem[];
  copy_in(smem, ptrs.params, kParamTable, 0, threadIdx.x, kEnvsPerBlock);
  __syncthreads();
  const int b = blockIdx.x * kEnvsPerBlock + threadIdx.x;
  if (b >= B) return;  // no barrier of the block follows
  char* mine = smem + kParamsBytes + threadIdx.x * kStateStride;
  copy_in(mine, ptrs.state, kStateTable, b, 0, 1);
  const EnvParams& P = *reinterpret_cast<const EnvParams*>(smem);
  EnvState& S = *reinterpret_cast<EnvState*>(mine);
  run_steps(P, S, load_cmd(cmd, b), noise, tr, b, n_steps, mocap != 0, ctrl, Helpers{nullptr});
  copy_out(mine, kStateTable, out.f, out.i, out.b, B, b, 0, 1);
}

}  // namespace

// state, params: the device pointers of the leaves, in tick.cuh's table order
// (host arrays of its state and parameter leaf counts); cmd: 6 pointers
// (des_pos (B, 3), des_vel, des_acc, des_yaw (B,), ext_force, ext_torque);
// noise: (B, n_steps, 2, 3) float32; out_f / out_i / out_b: the W state
// leaves by dtype, in table order, [B, numel] each; traj_f: 5 pointers (pos
// (B, n_steps, 3), vel, att (.., 4), angvel, motor_speeds (.., 4)), traj_i: 3
// (flight_state (B, n_steps), panic_reason, warnings). mocap: 0 true state, 1
// mocap estimator; ctrl: 0 rates, 1 position, 2 idle. Returns the
// cudaError_t of the launch.
extern "C" int env_rollout_launch(const void* const* state, const void* const* params,
                                  const float* const* cmd, const float* noise, float* out_f,
                                  int* out_i, unsigned char* out_b, float* const* traj_f,
                                  int* const* traj_i, int B, int n_steps, int mocap, int ctrl,
                                  void* stream) {
  if (B < 0 || n_steps < 0 || ctrl < kCtrlRates || ctrl > kCtrlIdle || mocap < 0 || mocap > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  LeafPtrs ptrs;
  for (int i = 0; i < kNumEnvState; ++i) ptrs.state[i] = state[i];
  for (int i = 0; i < kNumEnvParam; ++i) ptrs.params[i] = params[i];
  const CmdPtrs c{cmd[0], cmd[1], cmd[2], cmd[3], cmd[4], cmd[5]};
  const TrajPtrs t{traj_f[0], traj_f[1], traj_f[2], traj_f[3], traj_f[4],
                   traj_i[0], traj_i[1], traj_i[2]};
  const Outs o{out_f, out_i, out_b};
  cudaError_t e =
      cudaFuncSetAttribute(rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  rollout_kernel<<<(B + kEnvsPerBlock - 1) / kEnvsPerBlock, kEnvsPerBlock, kSmem,
                   static_cast<cudaStream_t>(stream)>>>(ptrs, c, noise, o, t, B, n_steps, mocap,
                                                        ctrl);
  return static_cast<int>(cudaGetLastError());
}
