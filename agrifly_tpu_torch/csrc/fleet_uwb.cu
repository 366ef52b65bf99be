// K6, the shared-UWB fleet: one launch advances N vehicles (N <= 32) that
// share one ranging network with A fixed anchors (N + A <= kMaxRadios = 33)
// through n_steps 2 ms ticks of sim/fleet_env.py's uwb_fleet_step: each
// vehicle's gust process and wind force, its phase A (radio delivery, plant,
// IMU), ONE step of the shared network over the vehicles' new positions and
// the anchors (the radio table's vehicle rows rotated by latch_start % N,
// the fairness rotation), the range delivered to its requester only, then
// each vehicle's onboard logic with that broadcast and the offboard loop on
// the true state (position, rates or idle commands into the radio delay
// line). It writes the final state: every vehicle's leaves, its gust
// velocity, the network's state and latch_start.
//
// Replaces agrifly_tpu/sim/fleet_env.py uwb_fleet_rollout (:265) and
// uwb_fleet_step (:184): jnp under jit and scan, which reaches no
// pallas_call. Built from tick.cuh's device functions with TICK_RANGING (the
// logic's range update without a per-vehicle network; the vehicles' EnvState
// has no uwb leaves) and TICK_WIND (the gust velocity and WindParams), both
// defined here.
//
// What bounds it on the card: the chain of one tick, every tick depending on
// the last and, through the network, every vehicle on every other. The bytes
// (a few KB of state, 40 bytes of draws a vehicle and tick) and the
// operations are far below it. So the whole fleet is one thread block, and
// the design keeps everything but one vehicle's tick off that chain:
//   - a group of G lanes per vehicle (tick.cuh's Lanes<G>, as in K5; every
//     G gives G = 1's values bit for bit), 32 vehicle slots, 32 G threads;
//     the vehicle's EnvState in shared memory at an odd-word stride, the
//     lanes in lockstep on it. A warp whose vehicle slots are not all flown
//     runs vehicle N - 1's chain in the spare slots (on its own copy of the
//     state and inputs, never written back), so that each of its lanes takes
//     part in every barrier; warps with no vehicle wait at the end;
//   - one more warp steps the network (32 G + 32 threads), so whatever N is,
//     no vehicle's lanes run it. Each tick the vehicles write their new
//     positions and targets after phase A and *arrive* at a named barrier;
//     the network warp waits there, steps the network with a lane per radio
//     slot (ballots find the first vehicle that wants to range and the rows
//     of the requester and responder; the rotation by a conditional
//     subtract), writes the broadcast and arrives at a second barrier. The
//     vehicles run their logic meanwhile (sensors, filters, the EKF predict)
//     and *wait* on the second barrier only where the range update reads the
//     broadcast (tick.cuh's UwbMeas source). The network's state and
//     latch_start live in the network warp's registers; the positions are
//     rewritten only after the vehicles have passed the second barrier,
//     which the network warp reaches after reading them;
//   - the EnvParams and the network's parameters by value
//     (__grid_constant__), read from the constant bank; the radio ids,
//     read a lane per slot, in shared memory;
//   - the noise, gust normals and network draws staged in shared memory
//     kChunk ticks at a time, two buffers: the whole block stages the first
//     chunk, and the network warp, after each tick's broadcast, stages that
//     tick's row of the next chunk into the other buffer, so no tick waits
//     for a staging.

#define TICK_RANGING
#define TICK_WIND

// Section timers, compiled only with -DFLEET_SECTIONS (chip_smoke.py's
// fleet_sections builds that variant): clock64() cycles and runs of each
// Section, on vehicle 0's lane 0 and on the network warp's lane 0, read and
// reset by fleet_uwb_sections_read. Without the define they are empty.
enum Section {
  kSecTick, kSecPhaseA, kSecRadio, kSecPlant, kSecImu, kSecNetWait, kSecNetStep, kSecNetStage,
  kSecWaitBroadcast, kSecLogic, kSecLogicPre, kSecEkfPredict, kSecCovPredict, kSecRange,
  kSecRest, kSecOffboard, kSecMocapUpdate, kSecReplayUpdate, kSecPrediction, kNumSections
};
#ifdef FLEET_SECTIONS
__device__ unsigned long long g_sec[kNumSections], g_cnt[kNumSections];
__shared__ unsigned long long s_sec[kNumSections], s_cnt[kNumSections];
#define SECTION_THREAD() (threadIdx.x == 0 || threadIdx.x == blockDim.x - 32)
#define SECTION_ADD(k, cycles)   \
  if (SECTION_THREAD()) {        \
    s_sec[k] += (cycles);        \
    s_cnt[k] += 1;               \
  }
#define SECTION_BEGIN(k) const long long section_start_##k = clock64();
#define SECTION_END(k) SECTION_ADD(k, clock64() - section_start_##k)
#define SECTION_MARK() clock64()
#else
#define SECTION_ADD(k, cycles)
#define SECTION_BEGIN(k)
#define SECTION_END(k)
#define SECTION_MARK() 0ll
#endif

#include "tick.cuh"

namespace {

constexpr int kMaxVehicles = 32;  // vehicle slots of the block (one a group)
constexpr int kChunk = 16;        // ticks staged at a time
constexpr int kNetState = 5;      // uwb.acc_us, .pending, .requester_id, .responder_id; latch_start
constexpr int kBarPositions = 1, kBarBroadcast = 2;  // named barriers (0 is __syncthreads)

// sim/fleet_env.py UwbFleetParams beyond the vehicles' EnvParams: the
// network's parameters (tick.cuh's ENV_UWB_PARAM_LEAVES, the radio table
// padded to kMaxRadios), the vehicles' radio ids and the anchors' positions
struct Net {
#define X(name, path, ty, n) Leaf<ty##_t, n>::type name;
  ENV_UWB_PARAM_LEAVES(X)
#undef X
  int vehicle_ids[kMaxVehicles];
  float anchor_pos[kMaxRadios][3];
  int n_vehicles;
};

// the leaves' device pointers: every vehicle's state leaves (tick.cuh's
// table order, [N, numel] each) in and out, the network's state in and out,
// and the per-call inputs
struct Ptrs {
  const void* state_in[kNumEnvState];
  void* state_out[kNumEnvState];
  const void* net_in[kNetState];
  void* net_out[kNetState];
  const float* des_pos;  // (N, 3)
  const float* noise;    // (N, n_steps, 2, 3)
  const float* gusts;    // (n_steps, N, 3)
  const float* draws;    // (n_steps, 4)
};

// the network's state (sim/uwb.py UwbState and latch_start), in the
// network warp's registers
struct NetState {
  int acc_us, requester_id, responder_id, latch_start;
  bool pending;
};

// what the vehicles and the network warp share each tick
struct Shared {
  float pos[kMaxVehicles][3];  // the vehicles' positions after phase A
  int next_ids[kMaxVehicles];  // their ranging targets (0 = none)
  int radio_ids[kMaxRadios];   // the radio table's ids
  bool valid, failure;         // the tick's broadcast
  float range;
  int requester, responder;
};

constexpr int kStateStride = 4 * (((sizeof(EnvState) + 3) / 4) | 1);  // bytes, odd words
constexpr int kRowWords = kMaxVehicles * 9 + 4;  // a tick's noise, gusts and draws
constexpr int kStageWords = kChunk * kRowWords;  // a chunk's: [v][k][6], [k][v][3], [k][4]
constexpr int kSharedOffset = kMaxVehicles * kStateStride;
constexpr int kStageOffset = kSharedOffset + ((sizeof(Shared) + 15) / 16) * 16;
constexpr int kSmem = kStageOffset + 2 * kStageWords * 4;
static_assert(kSmem <= 227 * 1024, "a block's shared memory");

// named barriers over `threads` threads (a multiple of 32): every lane of
// each taking part comes to them, its warp converged first
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  __syncwarp();
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int threads) {
  __syncwarp();
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// vehicle v's state leaves between device memory and S: elements lane,
// lane + G, ... of each leaf
__device__ void load_vehicle(EnvState& S, const void* const* in, int v, int lane, int G) {
  int k = 0;
#define X(name, path, ty, n, rw)                                                           \
  for (int i = lane; i < NUMEL(n); i += G)                                                  \
    reinterpret_cast<ty##_t*>(&S.name)[i] =                                                 \
        static_cast<const ty##_t*>(in[k])[static_cast<int64_t>(v) * NUMEL(n) + i];          \
  ++k;
  ENV_STATE_ALL(X)
#undef X
}

__device__ void store_vehicle(const EnvState& S, void* const* out, int v, int lane, int G) {
  int k = 0;
#define X(name, path, ty, n, rw)                                                           \
  for (int i = lane; i < NUMEL(n); i += G)                                                  \
    static_cast<ty##_t*>(out[k])[static_cast<int64_t>(v) * NUMEL(n) + i] =                  \
        reinterpret_cast<const ty##_t*>(&S.name)[i];                                        \
  ++k;
  ENV_STATE_ALL(X)
#undef X
}

// a chunk's staging: tick k's (k < kChunk) IMU noise of vehicle v, its gust
// normals (N vehicles), and the network's draws
__device__ __forceinline__ float* st_noise(float* st, int v, int k) {
  return st + (v * kChunk + k) * 6;
}
__device__ __forceinline__ float* st_gust(float* st, int N, int v, int k) {
  return st + kChunk * kMaxVehicles * 6 + (k * N + v) * 3;
}
__device__ __forceinline__ float* st_draw(float* st, int k) {
  return st + kChunk * kMaxVehicles * 9 + 4 * k;
}

// tick t's row of the inputs into its place (k = t % kChunk) in a chunk's
// staging, words q = q0, q0 + dq, ...: the N vehicles' noise, their gusts,
// the draws
__device__ void stage_row(float* st, const Ptrs& ptrs, int N, int n_steps, int t, int q0,
                          int dq) {
  const int k = t % kChunk;
  for (int q = q0; q < N * 9 + 4; q += dq) {
    if (q < N * 6) {
      const int u = q / 6, j = q - 6 * u;
      st_noise(st, u, k)[j] = ptrs.noise[(static_cast<int64_t>(u) * n_steps + t) * 6 + j];
    } else if (q < N * 9) {
      st_gust(st, N, 0, k)[q - N * 6] = ptrs.gusts[static_cast<int64_t>(t) * N * 3 + q - N * 6];
    } else {
      st_draw(st, k)[q - N * 9] = ptrs.draws[static_cast<int64_t>(t) * 4 + q - N * 9];
    }
  }
}

// sim/uwb.py step on the fleet's rotated radio table (sim/fleet_env.py
// uwb_fleet_step), by the network warp, lane r looking at radio slot r (and
// every lane at slot 32): row r < N is vehicle (r + roll) % N, row r >= N
// anchor r - N; draws: the tick's u_outlier, n_outlier, n_noise, u_fail.
// Steps the network's state `ns` (the same in every lane), writes the
// broadcast to `sh` (lane 0) and advances latch_start on a valid
// measurement. The float work is the serial scan's.
__device__ void network_step(const Net& net, Shared& sh, const float* draws, int dt_us,
                             NetState& ns, int lane) {
  const int N = net.n_vehicles;
  const int roll = ns.latch_start % N;
  auto row = [&](int r) {  // (r + roll) % N for r < N: roll < N
    const int q = r + roll;
    return r < N ? (q >= N ? q - N : q) : r;
  };
  auto pos_of = [&](int r) {
    return r < N ? ld3(sh.pos[row(r)]) : ld3(net.anchor_pos[r - N]);
  };
  const int acc = min(wadd(ns.acc_us, dt_us), 100000000);
  const bool due = acc >= net.u_comm_period_us;

  // phase 1: latch the first radio that wants to range; phase 2: the
  // parties of the pending transaction (the first row of each id)
  const int last = kMaxRadios - 1;  // slot 32: an anchor row (N <= 32)
  const bool used = lane < net.u_num_radios, used_last = last < net.u_num_radios;
  const int id = sh.radio_ids[row(lane)], id_last = sh.radio_ids[last];
  const unsigned all = 0xffffffffu;
  const unsigned wants = __ballot_sync(all, used && lane < N && sh.next_ids[row(lane)] != 0);
  const unsigned reqs = __ballot_sync(all, used && id == ns.requester_id);
  const unsigned ress = __ballot_sync(all, used && id == ns.responder_id);
  const int first = wants != 0 ? __ffs(wants) - 1 : -1;
  const int req = reqs != 0 ? __ffs(reqs) - 1
                            : (used_last && id_last == ns.requester_id ? last : -1);
  const int res = ress != 0 ? __ffs(ress) - 1
                            : (used_last && id_last == ns.responder_id ? last : -1);
  const bool any_wants = first >= 0;
  const int latch_req = any_wants ? sh.radio_ids[row(first)] : 0;
  const int latch_res = any_wants ? sh.next_ids[row(first)] : 0;
  const bool have_both = req >= 0 && res >= 0;
  const float true_range = norm3(sub(pos_of(max(req, 0)), pos_of(max(res, 0))));
  const float outlier_range = draws[1] * net.u_outlier_std;
  const float noisy_range = true_range + draws[2] * net.u_noise_std;
  const float meas_range = draws[0] < net.u_outlier_prob ? outlier_range : noisy_range;
  const bool failed = draws[3] < net.u_failure_prob;

  const bool pending = ns.pending;
  const bool complete = due && pending && have_both && true_range <= net.u_max_range;
  const bool finish = due && pending;
  const bool latch = due && !pending;
  if (lane == 0) {
    sh.valid = complete;
    sh.range = complete && !failed ? meas_range : 0.0f;
    sh.responder = complete ? ns.responder_id : 0;
    sh.requester = complete ? ns.requester_id : 0;
    sh.failure = complete && failed;
  }
  ns.acc_us = latch ? 0 : acc;
  ns.pending = latch ? any_wants : (pending && !finish);
  ns.requester_id = latch ? latch_req : (finish ? 0 : ns.requester_id);
  ns.responder_id = latch ? latch_res : (finish ? 0 : ns.responder_id);
  ns.latch_start = complete ? wadd(ns.latch_start, 1) : ns.latch_start;
}

// The source of the tick's broadcast for a vehicle's logic (tick.cuh's
// UwbMeas interface): the wait on the network warp's second barrier, then
// the broadcast from shared memory, to its requester only. `mark`: the
// section timers' last time stamp.
struct Broadcast {
  const Shared& sh;
  int vehicle_id, threads;
  long long* mark;
  __device__ __forceinline__ UwbMeas get() const {
    SECTION_ADD(kSecLogicPre, SECTION_MARK() - *mark);
    *mark = SECTION_MARK();
    bar_sync(kBarBroadcast, threads);
    SECTION_ADD(kSecWaitBroadcast, SECTION_MARK() - *mark);
    *mark = SECTION_MARK();
    return UwbMeas{sh.valid && vehicle_id == sh.requester, sh.range, sh.responder, sh.failure};
  }
  __device__ __forceinline__ void used() const {
    SECTION_ADD(kSecRange, SECTION_MARK() - *mark);
    *mark = SECTION_MARK();
  }
};

template <int G>
__global__ void __launch_bounds__(kMaxVehicles * G + 32)
    fleet_uwb_kernel(const __grid_constant__ EnvParams P, const __grid_constant__ Net net,
                     const __grid_constant__ Ptrs ptrs, int n_steps, int ctrl) {
  extern __shared__ __align__(16) char smem[];
  Shared& sh = *reinterpret_cast<Shared*>(smem + kSharedOffset);
  float* stage = reinterpret_cast<float*>(smem + kStageOffset);
  const int N = net.n_vehicles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool is_net = warp == kMaxVehicles * G / 32;  // the last warp
  const int vehicle_warps = (N * G + 31) / 32;
  const bool flies = !is_net && warp < vehicle_warps;  // runs a vehicle's chain
  const int v = threadIdx.x / G, gl = threadIdx.x % G;
  const int vr = min(v, N - 1);  // the vehicle it flies: v, or N - 1 in a spare slot
  const bool active = flies && v < N;
  const int threads = 32 * (vehicle_warps + 1);  // at the named barriers
  EnvState& S = *reinterpret_cast<EnvState*>(smem + min(v, kMaxVehicles - 1) * kStateStride);
  if (flies) load_vehicle(S, ptrs.state_in, vr, gl, G);
  NetState ns{};
  if (is_net) {
    ns.acc_us = *static_cast<const int*>(ptrs.net_in[0]);
    ns.pending = *static_cast<const unsigned char*>(ptrs.net_in[1]) != 0;
    ns.requester_id = *static_cast<const int*>(ptrs.net_in[2]);
    ns.responder_id = *static_cast<const int*>(ptrs.net_in[3]);
    ns.latch_start = *static_cast<const int*>(ptrs.net_in[4]);
    for (int r = lane; r < kMaxRadios; r += 32) sh.radio_ids[r] = net.u_radio_ids[r];
  }
  for (int t = 0; t < min(kChunk, n_steps); ++t)  // the first chunk, by the block
    stage_row(stage, ptrs, N, n_steps, t, threadIdx.x, blockDim.x);
  const Lanes<G> hp{gl, G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (lane & ~(G - 1))};
  const f3 zero3 = f3{0.0f, 0.0f, 0.0f};
  const Cmd c{ld3(ptrs.des_pos + 3 * vr), zero3, zero3, 0.0f, zero3, zero3};
  const int vehicle_id = net.vehicle_ids[vr];
#ifdef FLEET_SECTIONS
  if (threadIdx.x == 0)
    for (int q = 0; q < kNumSections; ++q) s_sec[q] = s_cnt[q] = 0;
#endif
  __syncthreads();

  if (flies) {
    for (int t = 0; t < n_steps; ++t) {
      float* st = stage + (t / kChunk % 2) * kStageWords;
      const int k = t % kChunk;
      SECTION_BEGIN(kSecTick)
      SECTION_BEGIN(kSecPhaseA)
      // the gust process and phase A
      const int step = S.step;
      int acc_us = wadd(S.offboard_acc_us, P.dt_us);
      const bool fire = acc_us > P.offboard_period_us;
      if (fire) acc_us = wsub(acc_us, P.offboard_period_us);
      const f3 ext_force = wind_force(P, S, st_gust(st, N, vr, k));
      const PhaseA a = physics_phase_a(P, S, st_noise(st, vr, k), ext_force, zero3);
      if (active && gl == 0) {
        st3(sh.pos[v], ld3(S.plant_pos));
        const int ti = min(max(S.next_target_idx, 0), 31);
        sh.next_ids[v] = P.l_num_targets > 0 ? P.l_target_ids[ti] : 0;
      }
      bar_arrive(kBarPositions, threads);
      SECTION_END(kSecPhaseA)
      // logic (the broadcast read at the range update, to its requester
      // only) and offboard
      long long mark = SECTION_MARK();
      int now_us;
      const Mocap est_out = physics_finish(P, S, a, kEstTrue, fire, &now_us, hp,
                                           Broadcast{sh, vehicle_id, threads, &mark});
      offboard_finish(P, S, c, est_out, fire, acc_us, step, now_us, kEstTrue, ctrl);
      SECTION_ADD(kSecRest, SECTION_MARK() - mark);
      SECTION_END(kSecTick)
    }
  } else if (is_net) {
    for (int t = 0; t < n_steps; ++t) {
      float* st = stage + (t / kChunk % 2) * kStageWords;
      SECTION_BEGIN(kSecNetWait)
      bar_sync(kBarPositions, threads);
      SECTION_END(kSecNetWait)
      SECTION_BEGIN(kSecNetStep)
      network_step(net, sh, st_draw(st, t % kChunk), P.dt_us, ns, lane);
      bar_arrive(kBarBroadcast, threads);
      SECTION_END(kSecNetStep)
      // the next chunk's row t % kChunk into the other buffer: its previous
      // chunk was read before this tick's first barrier
      SECTION_BEGIN(kSecNetStage)
      if (t + kChunk < n_steps)
        stage_row(stage + (t / kChunk % 2 == 0 ? kStageWords : 0), ptrs, N, n_steps,
                  t + kChunk, lane, 32);
      SECTION_END(kSecNetStage)
    }
  }
  __syncthreads();
  if (active) store_vehicle(S, ptrs.state_out, v, gl, G);
  if (is_net && lane == 0) {
    *static_cast<int*>(ptrs.net_out[0]) = ns.acc_us;
    *static_cast<unsigned char*>(ptrs.net_out[1]) = ns.pending ? 1 : 0;
    *static_cast<int*>(ptrs.net_out[2]) = ns.requester_id;
    *static_cast<int*>(ptrs.net_out[3]) = ns.responder_id;
    *static_cast<int*>(ptrs.net_out[4]) = ns.latch_start;
  }
#ifdef FLEET_SECTIONS
  if (threadIdx.x == 0)
    for (int q = 0; q < kNumSections; ++q) {
      g_sec[q] += s_sec[q];
      g_cnt[q] += s_cnt[q];
    }
#endif
}

template <int G>
cudaError_t launch(const EnvParams& P, const Net& net, const Ptrs& ptrs, int n_steps, int ctrl,
                   cudaStream_t stream) {
  cudaError_t e =
      cudaFuncSetAttribute(fleet_uwb_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return e;
  fleet_uwb_kernel<G><<<1, kMaxVehicles * G + 32, kSmem, stream>>>(P, net, ptrs, n_steps, ctrl);
  return cudaGetLastError();
}

constexpr Elems<kEnvParamElems> make_param_elems() {
  Elems<kEnvParamElems> t{};
  int k = 0, leaf = 0;
#define X(name, path, ty, n) ADD_PARAM_ELEMS(offsetof(EnvParams, name), ty, n)
  ENV_PARAM_ALL(X)
#undef X
  return t;
}
constexpr Elems<kEnvParamElems> kParamTable = make_param_elems();  // read on the host

}  // namespace

// state_in / state_out: the vehicles' state leaves' device pointers
// (tick.cuh's table order under TICK_RANGING and TICK_WIND: [N, numel]
// each); net_in / net_out: the network's acc_us (int32), pending (bool),
// requester_id, responder_id and latch_start (int32), 0-d each; params: the
// HOST pointers of the vehicles' parameter leaves (the EnvParams, then the
// WindParams, in the table's order); net_params: the HOST pointers of the
// network's parameter leaves (sim/uwb.py UwbParams' order, the radio table
// padded to 33 with unused slots); vehicle_ids (n_vehicles) and anchor_pos
// (n_anchors, 3): host arrays; des_pos (N, 3), noise (N, n_steps, 2, 3),
// gusts (n_steps, N, 3) and draws (n_steps, 4): float32 on the device. ctrl:
// 0 rates, 1 position, 2 idle; group: lanes per vehicle (1, 2, 4 or 8).
// Returns the cudaError_t of the launch.
extern "C" int fleet_uwb_launch(const void* const* state_in, void* const* state_out,
                                const void* const* net_in, void* const* net_out,
                                const void* const* params, const void* const* net_params,
                                const int* vehicle_ids, const float* anchor_pos,
                                int n_vehicles, int n_anchors, const float* des_pos,
                                const float* noise, const float* gusts, const float* draws,
                                int n_steps, int ctrl, int group, void* stream) {
  if (n_vehicles < 1 || n_vehicles > kMaxVehicles || n_anchors < 0 ||
      n_vehicles + n_anchors > kMaxRadios || n_steps < 0 || ctrl < kCtrlRates ||
      ctrl > kCtrlIdle || (group != 1 && group != 2 && group != 4 && group != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  EnvParams P;
  for (const Elem& el : kParamTable.e)
    memcpy(reinterpret_cast<char*>(&P) + el.dst,
           static_cast<const char*>(params[el.leaf]) + el.i * el.size, el.size);
  Net net{};
  {
    int k = 0;
#define X(name, path, ty, n) \
  memcpy(&net.name, net_params[k++], sizeof(ty##_t) * NUMEL(n));
    ENV_UWB_PARAM_LEAVES(X)
#undef X
  }
  memcpy(net.vehicle_ids, vehicle_ids, sizeof(int) * n_vehicles);
  memcpy(net.anchor_pos, anchor_pos, sizeof(float) * 3 * n_anchors);
  net.n_vehicles = n_vehicles;
  Ptrs ptrs;
  for (int i = 0; i < kNumEnvState; ++i) {
    ptrs.state_in[i] = state_in[i];
    ptrs.state_out[i] = state_out[i];
  }
  for (int i = 0; i < kNetState; ++i) {
    ptrs.net_in[i] = net_in[i];
    ptrs.net_out[i] = net_out[i];
  }
  ptrs.des_pos = des_pos;
  ptrs.noise = noise;
  ptrs.gusts = gusts;
  ptrs.draws = draws;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = group == 1   ? launch<1>(P, net, ptrs, n_steps, ctrl, s)
                  : group == 2 ? launch<2>(P, net, ptrs, n_steps, ctrl, s)
                  : group == 4 ? launch<4>(P, net, ptrs, n_steps, ctrl, s)
                               : launch<8>(P, net, ptrs, n_steps, ctrl, s);
  return static_cast<int>(e);
}

#ifdef FLEET_SECTIONS
// the section sums (kNumSections cycles, then kNumSections runs) since the
// last read, which resets them
extern "C" int fleet_uwb_sections_read(unsigned long long* sec, unsigned long long* cnt) {
  unsigned long long zero[kNumSections] = {0};
  cudaError_t e = cudaMemcpyFromSymbol(sec, g_sec, sizeof(g_sec));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(cnt, g_cnt, sizeof(g_cnt));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_sec, zero, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_cnt, zero, sizeof(zero));
  return static_cast<int>(e);
}
#endif
