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
// the last and, through the network, every vehicle on every other: phase A,
// a barrier, the network's serial scan of the radio table, a barrier, the
// logic and the offboard loop. The bytes (a few KB of state, 40 bytes of
// draws a vehicle and tick) and the operations are far below it. So the
// whole fleet is one thread block:
//   - a group of G lanes per vehicle (tick.cuh's Lanes<G>, as in K5; every
//     G gives G = 1's values bit for bit), 32 vehicle slots, 32 G threads;
//     the vehicle's EnvState in shared memory at an odd-word stride, the
//     lanes in lockstep on it;
//   - the network's state, latch_start, the vehicles' new positions and
//     next targets, and the tick's broadcast in shared memory: two
//     __syncthreads() a tick, and thread 0 steps the network between them;
//   - the EnvParams and the network's parameters by value
//     (__grid_constant__), read from the constant bank;
//   - the noise, gust normals and network draws staged in shared memory
//     kChunk ticks at a time by the whole block.

#define TICK_RANGING
#define TICK_WIND

#include "tick.cuh"

namespace {

constexpr int kMaxVehicles = 32;  // vehicle slots of the block (one a group)
constexpr int kChunk = 16;        // ticks staged at a time
constexpr int kNetState = 5;      // uwb.acc_us, .pending, .requester_id, .responder_id; latch_start

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

// what the block shares each tick
struct Shared {
  int acc_us, requester_id, responder_id, latch_start;
  bool pending;
  float pos[kMaxVehicles][3];     // the vehicles' positions after phase A
  int next_ids[kMaxVehicles];     // their ranging targets (0 = none)
  bool valid, failure;            // the tick's broadcast
  float range;
  int requester, responder;
};

constexpr int kStateStride = 4 * (((sizeof(EnvState) + 3) / 4) | 1);  // bytes, odd words
constexpr int kStageWords = kChunk * (kMaxVehicles * 9 + 4);  // noise, gusts, draws
constexpr int kSharedOffset = kMaxVehicles * kStateStride;
constexpr int kStageOffset = kSharedOffset + ((sizeof(Shared) + 15) / 16) * 16;
constexpr int kSmem = kStageOffset + kStageWords * 4;
static_assert(kSmem <= 227 * 1024, "a block's shared memory");

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

// sim/uwb.py step on the fleet's rotated radio table (sim/fleet_env.py
// uwb_fleet_step): row r < N is vehicle (r + roll) % N, row r >= N anchor
// r - N; draws: the tick's u_outlier, n_outlier, n_noise, u_fail. Steps the
// network in `sh`, writes the broadcast there and advances latch_start on
// a valid measurement.
__device__ void network_step(const Net& net, Shared& sh, const float* draws, int dt_us) {
  const int N = net.n_vehicles;
  const int roll = sh.latch_start % N;
  auto row = [&](int r) { return r < N ? (r + roll) % N : r; };
  auto id_of = [&](int r) { return net.u_radio_ids[row(r)]; };
  auto pos_of = [&](int r) {
    return r < N ? ld3(sh.pos[row(r)]) : ld3(net.anchor_pos[r - N]);
  };
  const int acc = min(wadd(sh.acc_us, dt_us), 100000000);
  const bool due = acc >= net.u_comm_period_us;

  // phase 1: latch the first radio that wants to range; phase 2: the
  // parties of the pending transaction
  int first = -1, req = -1, res = -1;
  for (int r = 0; r < kMaxRadios; ++r) {
    const bool used = r < net.u_num_radios;
    const int id = id_of(r);
    if (first < 0 && used && r < N && sh.next_ids[row(r)] != 0) first = r;
    if (req < 0 && used && id == sh.requester_id) req = r;
    if (res < 0 && used && id == sh.responder_id) res = r;
  }
  const bool any_wants = first >= 0;
  const int latch_req = any_wants ? id_of(first) : 0;
  const int latch_res = any_wants ? sh.next_ids[row(first)] : 0;
  const bool have_both = req >= 0 && res >= 0;
  const float true_range = norm3(sub(pos_of(max(req, 0)), pos_of(max(res, 0))));
  const float outlier_range = draws[1] * net.u_outlier_std;
  const float noisy_range = true_range + draws[2] * net.u_noise_std;
  const float meas_range = draws[0] < net.u_outlier_prob ? outlier_range : noisy_range;
  const bool failed = draws[3] < net.u_failure_prob;

  const bool pending = sh.pending;
  const bool complete = due && pending && have_both && true_range <= net.u_max_range;
  const bool finish = due && pending;
  const bool latch = due && !pending;
  sh.valid = complete;
  sh.range = complete && !failed ? meas_range : 0.0f;
  sh.responder = complete ? sh.responder_id : 0;
  sh.requester = complete ? sh.requester_id : 0;
  sh.failure = complete && failed;
  sh.acc_us = latch ? 0 : acc;
  sh.pending = latch ? any_wants : (pending && !finish);
  sh.requester_id = latch ? latch_req : (finish ? 0 : sh.requester_id);
  sh.responder_id = latch ? latch_res : (finish ? 0 : sh.responder_id);
  sh.latch_start = complete ? wadd(sh.latch_start, 1) : sh.latch_start;
}

template <int G>
__global__ void __launch_bounds__(kMaxVehicles * G)
    fleet_uwb_kernel(const __grid_constant__ EnvParams P, const __grid_constant__ Net net,
                     const __grid_constant__ Ptrs ptrs, int n_steps, int ctrl) {
  extern __shared__ __align__(16) char smem[];
  Shared& sh = *reinterpret_cast<Shared*>(smem + kSharedOffset);
  float* stage = reinterpret_cast<float*>(smem + kStageOffset);
  const int N = net.n_vehicles;
  const int v = threadIdx.x / G, gl = threadIdx.x % G, lane = threadIdx.x & 31;
  const bool active = v < N;
  EnvState& S = *reinterpret_cast<EnvState*>(smem + v * kStateStride);
  if (active) load_vehicle(S, ptrs.state_in, v, gl, G);
  if (threadIdx.x == 0) {
    sh.acc_us = *static_cast<const int*>(ptrs.net_in[0]);
    sh.pending = *static_cast<const unsigned char*>(ptrs.net_in[1]) != 0;
    sh.requester_id = *static_cast<const int*>(ptrs.net_in[2]);
    sh.responder_id = *static_cast<const int*>(ptrs.net_in[3]);
    sh.latch_start = *static_cast<const int*>(ptrs.net_in[4]);
  }
  const Lanes<G> hp{gl, G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (lane & ~(G - 1))};
  const int vr = min(v, N - 1);
  const f3 zero3 = f3{0.0f, 0.0f, 0.0f};
  const Cmd c{ld3(ptrs.des_pos + 3 * vr), zero3, zero3, 0.0f, zero3, zero3};
  float* st_noise = stage;                                // [v][k][6]
  float* st_gust = stage + kChunk * kMaxVehicles * 6;     // [k][v][3]
  float* st_draw = st_gust + kChunk * kMaxVehicles * 3;   // [k][4]

  for (int k0 = 0; k0 < n_steps; k0 += kChunk) {
    const int len = min(kChunk, n_steps - k0);
    __syncthreads();  // the last chunk's staging is read (and the block's state is in)
    for (int q = threadIdx.x; q < N * len * 6; q += blockDim.x) {
      const int u = q / (len * 6), r = q % (len * 6);
      st_noise[u * kChunk * 6 + r] =
          ptrs.noise[(static_cast<int64_t>(u) * n_steps + k0) * 6 + r];
    }
    for (int q = threadIdx.x; q < len * N * 3; q += blockDim.x)
      st_gust[q] = ptrs.gusts[static_cast<int64_t>(k0) * N * 3 + q];
    for (int q = threadIdx.x; q < len * 4; q += blockDim.x)
      st_draw[q] = ptrs.draws[static_cast<int64_t>(k0) * 4 + q];
    __syncthreads();

    for (int k = 0; k < len; ++k) {
      int step = 0, acc_us = 0;
      bool fire = false;
      PhaseA a;
      if (active) {  // the gust process and phase A
        step = S.step;
        acc_us = wadd(S.offboard_acc_us, P.dt_us);
        fire = acc_us > P.offboard_period_us;
        if (fire) acc_us = wsub(acc_us, P.offboard_period_us);
        const f3 ext_force = wind_force(P, S, st_gust + (k * N + v) * 3);
        a = physics_phase_a(P, S, st_noise + (v * kChunk + k) * 6, ext_force, zero3);
        if (gl == 0) {
          st3(sh.pos[v], ld3(S.plant_pos));
          const int ti = min(max(S.next_target_idx, 0), 31);
          sh.next_ids[v] = P.l_num_targets > 0 ? P.l_target_ids[ti] : 0;
        }
      }
      __syncthreads();
      if (threadIdx.x == 0) network_step(net, sh, st_draw + 4 * k, P.dt_us);
      __syncthreads();
      if (active) {  // the broadcast, to its requester only; logic; offboard
        const UwbMeas uwb{sh.valid && net.vehicle_ids[v] == sh.requester, sh.range, sh.responder,
                          sh.failure};
        int now_us;
        const Mocap est_out = physics_finish(P, S, a, kEstTrue, fire, &now_us, hp, uwb);
        offboard_finish(P, S, c, est_out, fire, acc_us, step, now_us, kEstTrue, ctrl);
      }
    }
  }
  __syncthreads();
  if (active) store_vehicle(S, ptrs.state_out, v, gl, G);
  if (threadIdx.x == 0) {
    *static_cast<int*>(ptrs.net_out[0]) = sh.acc_us;
    *static_cast<unsigned char*>(ptrs.net_out[1]) = sh.pending ? 1 : 0;
    *static_cast<int*>(ptrs.net_out[2]) = sh.requester_id;
    *static_cast<int*>(ptrs.net_out[3]) = sh.responder_id;
    *static_cast<int*>(ptrs.net_out[4]) = sh.latch_start;
  }
}

template <int G>
cudaError_t launch(const EnvParams& P, const Net& net, const Ptrs& ptrs, int n_steps, int ctrl,
                   cudaStream_t stream) {
  cudaError_t e =
      cudaFuncSetAttribute(fleet_uwb_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return e;
  fleet_uwb_kernel<G><<<1, kMaxVehicles * G, kSmem, stream>>>(P, net, ptrs, n_steps, ctrl);
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
