// K5, the env rollout: one launch advances B envs through n_steps 2 ms ticks
// of sim/env's step (radio delivery, plant with an external force and
// torque, IMU, onboard logic, the offboard estimator: the true state, the
// 200 Hz mocap estimator or the GPS-IMU estimator with its 100 Hz GPS fix,
// the 100 Hz offboard controller and its rates, position or idle command
// into the radio delay line), writing the StepOutputs trajectory and the
// final state. Built with TICK_UWB (tick.cuh), it is the UWB variant: each
// tick also steps the env's ranging network on its four draws, and the
// onboard EKF takes the ranges. Built with TICK_WIND, it is sim/fleet_env's
// wind fleet (fleet_rollout): each env also carries its gust velocity, and
// each tick first advances the gust process on its three normals
// (tick.cuh's wind_force) and flies under the force it gives; the builds
// without TICK_WIND compile that code out.
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
// operations, 250 ticks of it per call at bench.py's shape (~11k cycles a
// tick with the true state: logic ~4.7k, plant ~1.8k, the offboard
// controller ~6k on one tick in five; chip_smoke.py's rollout_sections);
// the bytes (state in and out, the noise block, the trajectory) and the
// operations are far below the chain's latency at any B. So the design keeps
// everything but the chain off it:
//   - a group of G lanes per env (a template parameter: 1, 2, 4 or 8), 32
//     envs a block (32 G threads), so 4096 envs are 128 blocks, one a SM.
//     The group's lanes run the env's chain in lockstep on the one copy of
//     its state, and the mocap replay's nine segments (each one's exp and
//     rotation) are split over them (tick.cuh's Lanes<G>): each lane
//     computes its segments with the serial operations and __shfl_sync
//     hands every segment to every lane, so every G gives G = 1's values bit
//     for bit, and G = 1 is the chain of a thread per env. Every lane writes
//     the same values to the state, and outside the split the group branches
//     only together, so its lanes run each instruction together. Splitting
//     the plant's four motors, the mixer's four propellers, the four motor
//     speeds and the radio's ten fields the same way made the tick slower
//     (the shuffles cost more than the divides they spread) and was dropped;
//   - the env's EnvState stays in shared memory at an odd-word stride (the
//     envs of a warp touch distinct banks); the block's states are copied in
//     and the written leaves out by all its threads, the envs of a leaf
//     element on consecutive threads. A private copy per lane went to local
//     memory whole (3.4 KB a thread) and was slower;
//   - the EnvParams are the kernel's argument (__grid_constant__): the
//     chain reads them from the constant bank, no store can alias them, and
//     the compiler keeps what depends on them alone out of the tick loop;
//   - the trajectory and the noise go through shared memory a chunk of
//     kChunk steps at a time: the warp sends for the next chunk's noise
//     (cp.async) before the chunk's ticks, each tick stages its row, and
//     after the chunk the warp writes each env's contiguous (chunk, k) span
//     of every trajectory leaf with consecutive lanes on consecutive words.
//
// The leaves are tick.cuh's tables (EnvState, EnvParams). A command leaf is
// per env ((B, ...)) or shared (read through a stride of 0); the noise is
// (B, n_steps, 2, 3) unit normals (gyro, then acc); the draws (B, n_steps,
// kDrawWords) are the UWB variant's four network draws, the wind variant's
// three gust normals, or both in that order. The kernel writes every state leaf: one float
// buffer holds the float state leaves and then the float trajectory leaves,
// one int32 buffer the int32 state leaves, the int32 trajectory leaves and
// then the bool leaves' bytes; in each, the leaves are ordered by element
// count (make_state_elems).
//
// The topic bridge's tick block (io/bridge.py SimBridge._dispatch_tick_block,
// whose JAX counterpart is one lax.scan under jit) is another instance of the
// same kernel, env_tick_block_launch: in place of the trajectory it writes
// each tick's wire row (B, n_steps, kRowWords) straight to device memory from
// the env's lane 0, after the tick and, on the ticks the fire_tel mask
// (n_steps) selects, after the telemetry encode (tick.cuh's
// encode_telemetry, which advances the packet counter and clears the
// warnings, as io/telemetry.encode_from_logic does). The rows bypass shared
// memory: staging 64 more words a step would take ~128 KB more a block.
// The bound is the same chain; the row adds 64 stores a tick and, on a fire
// tick, 28 codes. It is built with G = kTickBlockGroup lanes an env, in
// the builds env.step serves for the bridge (not TICK_WIND).

// Section timers, compiled only with -DROLLOUT_SECTIONS (chip_smoke.py's
// rollout_sections builds that variant): clock64() cycles and runs of each
// Section of the tick chain on block 0's thread 0 (env 0's lane 0), read and
// reset by env_rollout_sections_read. Without the define they are empty.
enum Section {
  kSecTicks, kSecRadio, kSecPlant, kSecImu, kSecLogic, kSecEkfPredict, kSecCovPredict,
  kSecMocapUpdate, kSecReplayUpdate, kSecPrediction, kSecOffboard, kSecStore, kSecNoise,
  kNumSections
};
#ifdef ROLLOUT_SECTIONS
// summed in shared memory during the launch (a global add would put its
// load's latency on the chain), added to g_sec / g_cnt at its end
__device__ unsigned long long g_sec[kNumSections], g_cnt[kNumSections];
__shared__ unsigned long long s_sec[kNumSections], s_cnt[kNumSections];
#define SECTION_BEGIN(k) const long long section_start_##k = clock64();
#define SECTION_END(k)                                  \
  if (blockIdx.x == 0 && threadIdx.x == 0) {            \
    s_sec[k] += clock64() - section_start_##k;          \
    s_cnt[k] += 1;                                      \
  }
#define SECTIONS_START()                                \
  if (threadIdx.x == 0)                                 \
    for (int k = 0; k < kNumSections; ++k) s_sec[k] = s_cnt[k] = 0;
#define SECTIONS_FINISH()                               \
  if (blockIdx.x == 0 && threadIdx.x == 0)              \
    for (int k = 0; k < kNumSections; ++k) {            \
      g_sec[k] += s_sec[k];                             \
      g_cnt[k] += s_cnt[k];                             \
    }
#else
#define SECTION_BEGIN(k)
#define SECTION_END(k)
#define SECTIONS_START()
#define SECTIONS_FINISH()
#endif

#include <cuda_pipeline.h>

#include "tick.cuh"

namespace {

// the state leaves' device pointers, passed to the kernel by value
struct LeafPtrs {
  const void* state[kNumEnvState];
};

// The state's elements, every leaf written. A leaf's place in its output
// buffer: the leaves of a kind ordered by element count, table order among
// equals, so that the wrapper makes each run of equal counts with one view.
constexpr Elems<kEnvStateElems> make_state_elems() {
  Elems<kEnvStateElems> t{};
  int k = 0, leaf = 0, prefix[3] = {0, 0, 0};
#define X(name, path, ty, n, rw) ADD_STATE_ELEMS(offsetof(EnvState, name), ty, n, W)
  ENV_STATE_ALL(X)
#undef X
  int first[kNumEnvState] = {}, start[kNumEnvState] = {};  // each leaf's first element
  for (int q = 0; q < kEnvStateElems; ++q)
    if (t.e[q].i == 0) first[t.e[q].leaf] = q;
  for (int a = 0; a < kNumEnvState; ++a)
    for (int b = 0; b < kNumEnvState; ++b) {
      const Elem ea = t.e[first[a]], eb = t.e[first[b]];
      if (eb.out == ea.out && (eb.numel < ea.numel || (eb.numel == ea.numel && b < a)))
        start[a] += eb.numel;
    }
  for (int q = 0; q < kEnvStateElems; ++q) t.e[q].out_prefix = start[t.e[q].leaf];
  return t;
}

constexpr Elems<kEnvParamElems> make_param_elems() {
  Elems<kEnvParamElems> t{};
  int k = 0, leaf = 0;
#define X(name, path, ty, n) ADD_PARAM_ELEMS(offsetof(EnvParams, name), ty, n)
  ENV_PARAM_ALL(X)
#undef X
  return t;
}

__device__ const Elems<kEnvStateElems> kStateTable = make_state_elems();
constexpr Elems<kEnvParamElems> kParamTable = make_param_elems();  // read on the host

// elements per env of the state leaves, by output kind (kOutF32, kOutI32,
// kOutBOOL)
struct OutElems {
  int of[3];
};
constexpr OutElems written_elems() {
  OutElems w{};
#define X(name, path, ty, n, rw) w.of[OUT_OF_##ty] += NUMEL(n);
  ENV_STATE_ALL(X)
#undef X
  return w;
}
constexpr OutElems kWritten = written_elems();

// sim/env.py Command (tick.cuh's Cmd): (3,) leaves but des_yaw (); stride:
// the floats between two envs' rows of a leaf, 0 for a leaf the envs share
struct CmdPtrs {
  const float* leaf[6];  // des_pos, des_vel, des_acc, des_yaw, ext_force, ext_torque
  int stride[6];
};

__device__ Cmd load_cmd(const CmdPtrs& c, int b) {
  const float* p[6];
  for (int k = 0; k < 6; ++k) p[k] = c.leaf[k] + static_cast<int64_t>(c.stride[k]) * b;
  return Cmd{ld3(p[0]), ld3(p[1]), ld3(p[2]), *p[3], ld3(p[4]), ld3(p[5])};
}

// sim/env.py StepOutputs: (B, n_steps, width) each, the float leaves (pos,
// vel, att, angvel, motor_speeds) then the int32 ones (flight_state,
// panic_reason, warnings)
constexpr int kTrajLeaves = 8, kTrajFloatLeaves = 5;
__host__ __device__ constexpr int traj_width(int leaf) {  // 3, 3, 4, 3, 4, 1, 1, 1
  return leaf >= kTrajFloatLeaves ? 1 : (leaf == 2 || leaf == 4 ? 4 : 3);
}
struct Outs {
  float* f;  // written float state leaves, [B, numel] each in table order
  int* i;
  unsigned char* b;
  void* traj[kTrajLeaves];
};

// The bridge's wire row (io/bridge.py's _TB_* layout): the truth state's
// pos, vel, att, angvel; the filtered accelerometer and gyro (acc_lp's and
// gyro_lp's ym1); the body-frame velocity; the mocap estimate's pos, vel,
// att, angvel; the telemetry packet number, d1 and d2 (zeros where the
// telemetry does not fire); word offsets.
constexpr int kRowPos = 0, kRowVel = 3, kRowAtt = 6, kRowAngvel = 10, kRowAccF = 13,
              kRowGyroF = 16, kRowVelB = 19, kRowMocapPos = 22, kRowMocapVel = 25,
              kRowMocapAtt = 28, kRowMocapAngvel = 32, kRowTelNum = 35, kRowTelD1 = 36,
              kRowTelD2 = 50, kRowWords = 64;
constexpr int kTickBlockGroup = 8;  // lanes an env in env_tick_block_launch

struct WireRows {
  float* rows;                  // (B, n_steps, kRowWords)
  const signed char* fire_tel;  // (n_steps,): the telemetry fires after tick k
};

// ---------------------------------------------------------------------------
// shared memory: the block's envs' EnvStates and each env's staging (two
// chunks' noise and draws, then its trajectory rows, leaf by leaf)
// ---------------------------------------------------------------------------

constexpr int kEnvs = 32;   // envs a block
constexpr int kChunk = 16;  // steps staged at a time
#ifdef TICK_UWB
constexpr int kUwbDrawWords = 4;  // a step's UWB draws
#else
constexpr int kUwbDrawWords = 0;
#endif
#ifdef TICK_WIND
constexpr int kWindDrawWords = 3;  // a step's gust normals, after the UWB draws
#else
constexpr int kWindDrawWords = 0;
#endif
constexpr int kDrawWords = kUwbDrawWords + kWindDrawWords;
// a chunk's noise, then its draws; two buffers
constexpr int kNoiseWords = (6 + kDrawWords) * kChunk;
__host__ __device__ constexpr int stage_offset(int leaf) {  // a trajectory leaf's staging words
  int off = 2 * kNoiseWords;
  for (int l = 0; l < leaf; ++l) off += kChunk * traj_width(l);
  return off;
}
constexpr int kStageStride = stage_offset(kTrajLeaves) | 1;  // words, odd
constexpr int kStateStride = 4 * (((sizeof(EnvState) + 3) / 4) | 1);  // bytes, odd words
constexpr int kSmem = kEnvs * kStateStride + kEnvs * kStageStride * 4;
static_assert(kSmem <= 227 * 1024, "a block's shared memory");

// The state elements of a block's nb envs (element k of env e is q = k *
// kEnvs + e: the envs of a leaf element on consecutive threads), thread t of
// T, eight in flight: into the states at `base` / out to the flat buffers.
__device__ void copy_states_in(char* base, const void* const* src, int b0, int nb, int t, int T) {
#pragma unroll 8
  for (int q = t; q < kEnvStateElems * kEnvs; q += T) {
    const int k = q / kEnvs, e = q % kEnvs;
    if (e >= nb) continue;
    const Elem el = kStateTable.e[k];
    const char* p = static_cast<const char*>(src[el.leaf]) +
                    (static_cast<int64_t>(b0 + e) * el.numel + el.i) * el.size;
    char* dst = base + e * kStateStride + el.dst;
    if (el.size == 4)
      *reinterpret_cast<int*>(dst) = __ldg(reinterpret_cast<const int*>(p));
    else
      *dst = static_cast<char>(__ldg(reinterpret_cast<const unsigned char*>(p)));
  }
}

__device__ void copy_states_out(const char* base, const Outs& out, int B, int b0, int nb, int t,
                                int T) {
#pragma unroll 8
  for (int q = t; q < kEnvStateElems * kEnvs; q += T) {
    const int k = q / kEnvs, e = q % kEnvs;
    const Elem el = kStateTable.e[k];
    if (e >= nb || el.out == kOutNone) continue;
    const char* src = base + e * kStateStride + el.dst;
    const int64_t o = static_cast<int64_t>(B) * el.out_prefix +
                      static_cast<int64_t>(b0 + e) * el.numel + el.i;
    if (el.out == kOutF32) out.f[o] = *reinterpret_cast<const float*>(src);
    else if (el.out == kOutI32) out.i[o] = *reinterpret_cast<const int*>(src);
    else out.b[o] = static_cast<unsigned char>(*src);
  }
}

// ---------------------------------------------------------------------------
// the tick and the steps
// ---------------------------------------------------------------------------

// env.step: physics_tick, then _offboard_and_finish (tick.cuh). est: kEst*;
// ctrl: kCtrl*; draws: the tick's draws (kDrawWords). The wind variant
// flies under wind_force's force in place of the command's.
template <class H>
__device__ void env_step(const EnvParams& P, EnvState& S, const Cmd& c, const float* noise,
                         const float* draws, int est, int ctrl, const H& hp) {
  const int step = S.step;  // the tick's step, before physics
  int acc_us = wadd(S.offboard_acc_us, P.dt_us);
  const bool fire = acc_us > P.offboard_period_us;
  if (fire) acc_us = wsub(acc_us, P.offboard_period_us);
#ifdef TICK_WIND
  const f3 ext_force = wind_force(P, S, draws + kUwbDrawWords);
#else
  const f3 ext_force = c.ext_force;
#endif

  int now_us;
  const Mocap est_out = physics_tick(P, S, noise, ext_force, c.ext_torque, est, fire, &now_us,
                                     hp, draws);
  offboard_finish(P, S, c, est_out, fire, acc_us, step, now_us, est, ctrl);
}

// step k's trajectory row into the staging
__device__ __forceinline__ void stage_row(const EnvState& S, float* stage, int k) {
  for (int i = 0; i < 3; ++i) {
    stage[stage_offset(0) + 3 * k + i] = S.plant_pos[i];
    stage[stage_offset(1) + 3 * k + i] = S.plant_vel[i];
    stage[stage_offset(3) + 3 * k + i] = S.plant_angvel[i];
  }
  for (int i = 0; i < 4; ++i) {
    stage[stage_offset(2) + 4 * k + i] = S.plant_att[i];
    stage[stage_offset(4) + 4 * k + i] = S.plant_motor_speeds[i];
  }
  int* ints = reinterpret_cast<int*>(stage);
  ints[stage_offset(5) + k] = S.fs;
  ints[stage_offset(6) + k] = S.panic_reason;
  ints[stage_offset(7) + k] = S.warnings;
}

// The tick's wire row from the state after it (and after the telemetry's
// encode on a fire tick, whose state change it makes), to device memory
__device__ void write_wire_row(EnvState& S, bool fire, float* row) {
  for (int i = 0; i < 3; ++i) {
    row[kRowPos + i] = S.plant_pos[i];
    row[kRowVel + i] = S.plant_vel[i];
    row[kRowAngvel + i] = S.plant_angvel[i];
    row[kRowAccF + i] = S.acc_lp_ym1[i];
    row[kRowGyroF + i] = S.gyro_lp_ym1[i];
    row[kRowMocapPos + i] = S.mc_pos[i];
    row[kRowMocapVel + i] = S.mc_vel[i];
    row[kRowMocapAngvel + i] = S.mc_angvel[i];
  }
  for (int i = 0; i < 4; ++i) {
    row[kRowAtt + i] = S.plant_att[i];
    row[kRowMocapAtt + i] = S.mc_att[i];
  }
  st3(row + kRowVelB, rotate_back(ld4(S.plant_att), ld3(S.plant_vel)));
  int number = 0, d1[kTelCodes] = {}, d2[kTelCodes] = {};
  if (fire) encode_telemetry(S, number, d1, d2);
  row[kRowTelNum] = static_cast<float>(number);
  for (int i = 0; i < kTelCodes; ++i) {
    row[kRowTelD1 + i] = static_cast<float>(d1[i]);
    row[kRowTelD2 + i] = static_cast<float>(d2[i]);
  }
}

// The warp's envs (block envs we0 .. we0 + nw - 1, staged at `stages`):
// their noise (and UWB draw) rows k0 .. k0 + len - 1 into noise buffer `buf`
// of the staging by asynchronous copies (committed as one group, waited for
// before the chunk's first tick), and their staged trajectory rows out; each
// env's span is contiguous in device memory, and the warp's 32 lanes take
// consecutive words of it.
__device__ void prefetch_noise(const float* __restrict__ noise, const float* __restrict__ draws,
                               float* stages, int64_t row0, int n_steps, int we0, int nw, int k0,
                               int len, int buf, int lane) {
  for (int s = 0; s < nw; ++s) {
    const int64_t row = row0 + static_cast<int64_t>(we0 + s) * n_steps + k0;
    const float* src = noise + 6 * row;
    float* dst = stages + (we0 + s) * kStageStride + buf * kNoiseWords;
    for (int j = lane; j < 6 * len; j += 32) __pipeline_memcpy_async(dst + j, src + j, 4);
    if (kDrawWords > 0)
      for (int j = lane; j < kDrawWords * len; j += 32)
        __pipeline_memcpy_async(dst + 6 * kChunk + j, draws + kDrawWords * row + j, 4);
  }
  __pipeline_commit();
}

__device__ void write_rows(const Outs& out, const float* stages, int64_t row0, int n_steps,
                           int we0, int nw, int k0, int len, int lane) {
  for (int s = 0; s < nw; ++s) {
    const int64_t row = row0 + static_cast<int64_t>(we0 + s) * n_steps + k0;
    const float* src = stages + (we0 + s) * kStageStride;
#pragma unroll
    for (int l = 0; l < kTrajLeaves; ++l) {  // leaf l's span (k0 .. k0 + len) x width
      float* dst = static_cast<float*>(out.traj[l]) + traj_width(l) * row;  // int leaves: bits
#pragma unroll
      for (int j = lane; j < traj_width(l) * kChunk; j += 32)
        if (j < traj_width(l) * len) dst[j] = src[stage_offset(l) + j];
    }
  }
}

// kRows: the tick block's instance (the wire rows in place of the
// trajectory)
template <int G, bool kRows>
__global__ void __launch_bounds__(kEnvs * G)
    rollout_kernel(const __grid_constant__ EnvParams P, const __grid_constant__ LeafPtrs ptrs,
                   const CmdPtrs cmd, const float* __restrict__ noise,
                   const float* __restrict__ draws, const Outs out, const WireRows wire, int B,
                   int n_steps, int est, int ctrl) {
  constexpr int T = kEnvs * G;
  extern __shared__ __align__(16) char smem[];
  char* states = smem;
  float* stages = reinterpret_cast<float*>(states + kEnvs * kStateStride);
  const int b0 = blockIdx.x * kEnvs, nb = min(kEnvs, B - b0);
  SECTIONS_START()
  copy_states_in(states, ptrs.state, b0, nb, threadIdx.x, T);
  __syncthreads();

  // env e's group; the warp's envs we0 .. we0 + nw - 1
  const int e = threadIdx.x / G, lane = threadIdx.x & 31;
  const int we0 = (threadIdx.x / 32) * (32 / G), nw = max(0, min(32 / G, nb - we0));
  const bool active = e < nb;
  const Lanes<G> hp{static_cast<int>(threadIdx.x % G),
                    G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (lane & ~(G - 1))};
  EnvState& S = *reinterpret_cast<EnvState*>(states + e * kStateStride);
  const Cmd c = load_cmd(cmd, b0 + min(e, nb - 1));
  float* stage = stages + e * kStageStride;
  const int64_t row0 = static_cast<int64_t>(b0) * n_steps;
  prefetch_noise(noise, draws, stages, row0, n_steps, we0, nw, 0, min(kChunk, n_steps), 0, lane);
  SECTION_BEGIN(kSecTicks)
  for (int k0 = 0, buf = 0; k0 < n_steps; k0 += kChunk, buf ^= 1) {
    const int len = min(kChunk, n_steps - k0);
    SECTION_BEGIN(kSecNoise)  // this chunk's noise has landed; the next one's is sent for
    __pipeline_wait_prior(0);
    __syncwarp();
    if (k0 + kChunk < n_steps)
      prefetch_noise(noise, draws, stages, row0, n_steps, we0, nw, k0 + kChunk,
                     min(kChunk, n_steps - k0 - kChunk), buf ^ 1, lane);
    SECTION_END(kSecNoise)
    const float* nz = stage + buf * kNoiseWords;
    if (active)
      for (int k = 0; k < len; ++k) {
        env_step(P, S, c, nz + 6 * k, nz + 6 * kChunk + kDrawWords * k, est, ctrl, hp);
        if constexpr (kRows) {
          __syncwarp(hp.mask);  // the group's lanes are through the tick
          if (hp.lane == 0)
            write_wire_row(S, wire.fire_tel[k0 + k] != 0,
                           wire.rows + (row0 + static_cast<int64_t>(e) * n_steps + k0 + k) *
                                           kRowWords);
          __syncwarp(hp.mask);  // the encode's state change, before the next tick
        } else {
          SECTION_BEGIN(kSecStore)
          stage_row(S, stage, k);
          SECTION_END(kSecStore)
        }
      }
    __syncwarp();
    SECTION_BEGIN(kSecStore)
    if constexpr (!kRows) write_rows(out, stages, row0, n_steps, we0, nw, k0, len, lane);
    __syncwarp();  // the next chunk reuses the staging
    SECTION_END(kSecStore)
  }
  SECTION_END(kSecTicks)
  __syncthreads();
  copy_states_out(states, out, B, b0, nb, threadIdx.x, T);
  SECTIONS_FINISH()
}

template <int G, bool kRows>
cudaError_t launch(const EnvParams& P, const LeafPtrs& ptrs, const CmdPtrs& c, const float* noise,
                   const float* draws, const Outs& o, const WireRows& w, int B, int n_steps,
                   int est, int ctrl, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(rollout_kernel<G, kRows>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return e;
  rollout_kernel<G, kRows><<<(B + kEnvs - 1) / kEnvs, kEnvs * G, kSmem, stream>>>(
      P, ptrs, c, noise, draws, o, w, B, n_steps, est, ctrl);
  return cudaGetLastError();
}

// The launch's arguments from the C interface's (see env_rollout_launch);
// false for arguments the kernel does not take.
bool prepare(const void* const* state, const void* const* params, const float* const* cmd,
             const int* cmd_stride, const float* draws, int B, int n_steps, int est, int ctrl,
             LeafPtrs& ptrs, EnvParams& P, CmdPtrs& c) {
  if (B < 0 || n_steps < 0 || ctrl < kCtrlRates || ctrl > kCtrlIdle || est < kEstTrue ||
      est > kEstGpsimu || (kDrawWords > 0 && draws == nullptr && B > 0 && n_steps > 0))
    return false;
  for (int i = 0; i < kNumEnvState; ++i) ptrs.state[i] = state[i];
  for (const Elem& el : kParamTable.e)  // the table's copy, on the host
    memcpy(reinterpret_cast<char*>(&P) + el.dst,
           static_cast<const char*>(params[el.leaf]) + el.i * el.size, el.size);
  for (int k = 0; k < 6; ++k) {
    c.leaf[k] = cmd[k];
    c.stride[k] = cmd_stride[k];
  }
  return true;
}

}  // namespace

// state: the state leaves' device pointers, params: the parameter leaves'
// HOST pointers (copies the caller keeps), each in tick.cuh's table order
// (host arrays of its state and parameter leaf counts); cmd: 6 pointers
// (des_pos (B, 3) or (3,), des_vel, des_acc, des_yaw (B,) or (), ext_force,
// ext_torque) and cmd_stride their 6 strides between envs (3 or 1 per env, 0
// shared); noise: (B, n_steps, 2, 3) float32; draws: (B, n_steps,
// kDrawWords) float32 in the UWB and wind variants (else unread); out_f: B x (the float leaves'
// elements), [B, numel] a leaf ordered by numel (make_state_elems), then pos
// (B, n_steps, 3), vel, att (.., 4), angvel, motor_speeds (.., 4); out_i: B x
// (the int32 leaves' elements) as out_f's, then flight_state (B, n_steps),
// panic_reason, warnings, then B x (the bool leaves' elements) bytes as
// out_f's. est: 0 true state, 1 mocap estimator, 2 GPS-IMU estimator; ctrl:
// 0 rates, 1 position, 2 idle; group: lanes per env (1, 2, 4 or 8). The
// parameters go to the kernel by value. Returns the cudaError_t of the
// launch.
extern "C" int env_rollout_launch(const void* const* state, const void* const* params,
                                  const float* const* cmd, const int* cmd_stride,
                                  const float* noise, const float* draws, float* out_f,
                                  int* out_i, int B, int n_steps, int est, int ctrl, int group,
                                  void* stream) {
  LeafPtrs ptrs;
  EnvParams P;
  CmdPtrs c;
  if (!prepare(state, params, cmd, cmd_stride, draws, B, n_steps, est, ctrl, ptrs, P, c))
    return static_cast<int>(cudaErrorInvalidValue);
  if (group != 1 && group != 2 && group != 4 && group != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const int64_t rows = static_cast<int64_t>(B) * n_steps;
  Outs o;
  o.f = out_f;
  o.i = out_i;
  float* tf = out_f + static_cast<int64_t>(B) * kWritten.of[kOutF32];
  int* ti = out_i + static_cast<int64_t>(B) * kWritten.of[kOutI32];
  for (int l = 0; l < kTrajLeaves; ++l) {
    if (l < kTrajFloatLeaves) {
      o.traj[l] = tf;
      tf += rows * traj_width(l);
    } else {
      o.traj[l] = ti;
      ti += rows;
    }
  }
  o.b = reinterpret_cast<unsigned char*>(ti);
  const WireRows w{nullptr, nullptr};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      group == 1   ? launch<1, false>(P, ptrs, c, noise, draws, o, w, B, n_steps, est, ctrl, s)
      : group == 2 ? launch<2, false>(P, ptrs, c, noise, draws, o, w, B, n_steps, est, ctrl, s)
      : group == 4 ? launch<4, false>(P, ptrs, c, noise, draws, o, w, B, n_steps, est, ctrl, s)
                   : launch<8, false>(P, ptrs, c, noise, draws, o, w, B, n_steps, est, ctrl, s);
  return static_cast<int>(e);
}

#if !defined(TICK_WIND) && !defined(ROLLOUT_SECTIONS)
// The topic bridge's tick block: env_rollout_launch's arguments but the
// group (kTickBlockGroup) and the trajectory; fire_tel: (n_steps,) int8, the
// telemetry fires after tick k where it is not 0; out_f / out_i: the state
// leaves alone (out_i's int32 words, then the bool leaves' bytes); out_rows:
// (B, n_steps, kRowWords) float32, the wire rows. Returns the cudaError_t of
// the launch.
extern "C" int env_tick_block_launch(const void* const* state, const void* const* params,
                                     const float* const* cmd, const int* cmd_stride,
                                     const float* noise, const float* draws,
                                     const signed char* fire_tel, float* out_f, int* out_i,
                                     float* out_rows, int B, int n_steps, int est, int ctrl,
                                     void* stream) {
  LeafPtrs ptrs;
  EnvParams P;
  CmdPtrs c;
  if (!prepare(state, params, cmd, cmd_stride, draws, B, n_steps, est, ctrl, ptrs, P, c) ||
      (B > 0 && n_steps > 0 && (fire_tel == nullptr || out_rows == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  Outs o{};
  o.f = out_f;
  o.i = out_i;
  o.b = reinterpret_cast<unsigned char*>(out_i + static_cast<int64_t>(B) * kWritten.of[kOutI32]);
  const WireRows w{out_rows, fire_tel};
  return static_cast<int>(launch<kTickBlockGroup, true>(P, ptrs, c, noise, draws, o, w, B,
                                                        n_steps, est, ctrl,
                                                        static_cast<cudaStream_t>(stream)));
}
#endif

#ifdef ROLLOUT_SECTIONS
// sec, cnt: kNumSections cycles and runs each, summed since the last read;
// resets them. Returns the cudaError_t of the copies.
extern "C" int env_rollout_sections_read(unsigned long long* sec, unsigned long long* cnt) {
  unsigned long long zero[kNumSections] = {0};
  cudaError_t e = cudaMemcpyFromSymbol(sec, g_sec, sizeof(g_sec));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(cnt, g_cnt, sizeof(g_cnt));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_sec, zero, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_cnt, zero, sizeof(zero));
  return static_cast<int>(e);
}
#endif
