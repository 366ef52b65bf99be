// The RAPPIDS planner's candidate pass: the pyramid collision check (K7) and
// the candidates' input and velocity gates (K8), on lanes of a warp.
//
// Neither replaces a TPU kernel: the JAX package runs both as jnp inside the
// frame's one jit call (agrifly_tpu/planner/rappids.py:738 collision_check,
// a lax.while_loop vmapped over candidates; agrifly_tpu/planner/traj.py:264
// check_input_feasibility and :317 check_velocity_feasibility). The port ran
// them as eager PyTorch on the card, about 26k small launches a frame, which
// left the card idle over 90% of the frame. Each kernel computes what its
// plain version computes, bit for bit on the card:
//   K7  agrifly_tpu_torch/planner/rappids.py::collision_check_plain
//   K8  agrifly_tpu_torch/planner/traj.py::check_input_feasibility and
//       ::check_velocity_feasibility (strict_degenerate either way)
// The root solvers are csrc/rootfind.cuh's, whose header says how every
// operation rounds as the plain code's does; the rest follows the plain
// functions' float32 operations in their order (each noted where it is
// easy to get wrong).
//
// K7: a warp a candidate, grid (ceil(N / kCheckWarps), B), block (j, b)
// checking candidates j kCheckWarps .. of vehicle b. The block stages its
// vehicle's pyramid set (depth, 4 bounds, 4 x 3 normals, valid) in shared
// memory once. Lane 0 solves zdot's quartic and broadcasts the sections'
// bounds; lane 4 k + f then works on monotone section k (k < 5) and lateral
// face f, lanes 20-31 only take part in the warp's shuffles and ballots.
// - The sections run side by side. The JAX package's loop pops the first
//   live section and writes a remainder back into the same slot, so it runs
//   section 0's chain to its end, then section 1's, and so on: sections
//   share only the budget of MAX_CHECK_ITERS pops and the stop at the first
//   uncovered point. Each lane group runs its section's chain and counts its
//   pops (a section dropped under min_check_dist costs one, the uncovered
//   pop counts); a chain stops where its pops and the pops of the sections
//   before it reach the budget (those counts only grow, so the sequential
//   loop never makes a later pop of it). The replay then walks the sections
//   in order with a running sum of pops, which gives the sequential loop's
//   free, fail point and pops exactly: the budget spent inside section k
//   (free false, no fail point, MAX_CHECK_ITERS pops), or section k
//   uncovered within it (its fail point; later sections are thrown away).
// - The pyramid search is one ballot a section and chunk of 32 pyramids,
//   one pyramid a lane: __ffs of the first ballot that is not 0 is the
//   plain version's first hit in set order.
// - The four face quartics run on the group's four lanes; hit is a ballot,
//   the deepest time a max / min over shuffles. That is exact in any order:
//   every root kept is finite and lies in (t1, t2) with t1 >= 0, so no NaN
//   and no signed zero is compared.
// What bounds K7: latency, the chain of its slowest section (zdot's quartic,
// then per pop the search's ballots and one face quartic with double
// precision acos / cos or pow); the bytes (~100 a candidate, the pyramid set
// a few KB) and the float operations are microseconds' worth of nothing. A
// warp a candidate puts a frame's 256 candidates on 64 SMs (four warps a
// block, K8's too: the fastest of one, two and four on an H100).
//
// K8: a group of four lanes a candidate, grid (ceil(N / (8 kGateWarps)), B).
// Lane a of the group works on axis min(a, 2) (lane 3 repeats axis 2): the
// velocity proof solves its axis's acceleration cubic and the group ANDs the
// axes with a ballot (the plain proof is an AND over axes and roots, the
// degenerate axis under strict one more false); the input bisection walks
// the plain version's dyadic sections depth first, each section's verdict
// spread over the axes (the thrusts and sums gather the three axes' terms
// by shuffles and add them in the plain order). A section's verdict depends
// only on (level, index), through t1 = tf (idx / n) and t2 = tf ((idx + 1)
// / n), both exact (n a power of two), so the walk reaches the
// level-by-level sweep's boolean; it stops at the first section that
// rejects, and `sections` counts the sections it evaluated. What bounds K8:
// latency, a cubic solve with double precision trigonometry or pow and the
// bisection's verdicts.

#include <cuda_runtime.h>

#include "rootfind.cuh"

// The launch functions' arguments, passed by value from the wrapper
// (planner/cuda_plan.py's ctypes structures mirror them); outside the
// anonymous namespace so the extern "C" functions keep external linkage.

// One per-candidate tensor: element strides between vehicles and between
// candidates; a vector's three components are contiguous.
struct Field {
  const float* p;
  long long sv;
  long long sn;
};

struct TrajArgs {  // traj.Traj's fields, each (B, N, 3) but tf (B, N)
  Field alpha, beta, gamma, a0, v0, p0, tf;
};

struct CamArgs {  // 0-d float32 tensors on the card
  const float* focal;
  const float* cx;
  const float* cy;
  const float* min_check_dist;
};

struct PyrArgs {  // (B, P) depth and valid, (B, P, 4) bounds, (B, P, 4, 3) normals; contiguous
  const float* depth;
  const float* bounds;
  const float* normals;
  const bool* valid;
};

struct CheckOut {  // (B, N) each; pops may be null
  bool* free;
  float* fail_px;
  float* fail_py;
  float* fail_depth;
  int* pops;
};

struct GateArgs {
  const float* grav;  // (B, 3), grav_sv floats between vehicles
  long long grav_sv;
  const float* fmin;  // 0-d float32 tensors on the card
  const float* fmax;
  const float* wmax;
  const float* vmax;
  float min_section_time;
  int last_level;  // the deepest level evaluated; -1: every candidate rejects
  int strict;      // check_velocity_feasibility's strict_degenerate
};

struct GateOut {  // (B, N) each; sections may be null
  bool* feas;
  bool* vel_ok;
  int* sections;
};

namespace {

using namespace rootfind;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kCheckWarps = 4;  // K7's candidates (warps) a block
constexpr int kGateWarps = 4;   // K8's warps a block, eight candidates each
constexpr int kMaxCheckIters = 24;  // rappids.MAX_CHECK_ITERS
// rappids.monotonic_sections sorts six bounds into five sections and pads
// them to MAX_SECTIONS = 8 slots; a padded slot is never live and a pop
// writes back only into its own slot, so five lane groups hold every section.
constexpr int kSections = 5;
constexpr float kPixelBuffer = 2.0f;  // rappids.PIXEL_BUFFER

struct Cand {
  float al[3], be[3], ga[3], a0[3], v0[3], p0[3], tf;
};

__device__ __forceinline__ void load3(const Field& f, int b, int n, float out[3]) {
  const float* p = f.p + b * f.sv + n * f.sn;
  out[0] = p[0];
  out[1] = p[1];
  out[2] = p[2];
}

__device__ __forceinline__ Cand load_cand(const TrajArgs& tr, int b, int n, bool p0) {
  Cand c;
  load3(tr.alpha, b, n, c.al);
  load3(tr.beta, b, n, c.be);
  load3(tr.gamma, b, n, c.ga);
  load3(tr.a0, b, n, c.a0);
  load3(tr.v0, b, n, c.v0);
  if (p0) load3(tr.p0, b, n, c.p0);
  c.tf = tr.tf.p[b * tr.tf.sv + n * tr.tf.sn];
  return c;
}

// ---------------------------------------------------------------------------
// K7: the collision check
// ---------------------------------------------------------------------------

// rappids._poly_at: z rounds its t^2 term as a0 t t, x and y as a0 ipow(t, 2)
// (the JAX package's _z_at and collision_check); ipow(t, n) squares as
// fmath.ipow does: t^3 = t (t t), t^4 = (t t)(t t), t^5 = t ((t t)(t t)).
__device__ __forceinline__ float poly_at(const Cand& c, int k, float t) {
  const float tt = t * t;
  const float t2 = k == 2 ? c.a0[k] * t * t : c.a0[k] * tt;
  return c.p0[k] + c.v0[k] * t + t2 * 0.5f + c.ga[k] * (t * tt) / 6.0f +
         c.be[k] * (tt * tt) / 24.0f + c.al[k] * (t * (tt * tt)) / 120.0f;
}

// rappids._quartic_or_cubic_roots: c0 t^4 + c1 t^3 + c2 t^2 + c3 t + c4,
// the cubic (padded with an invalid fourth root) where |c0| <= 1e-6.
__device__ __forceinline__ void quartic_or_cubic(float c0, float c1, float c2, float c3, float c4,
                                                 float r[4], bool v[4]) {
  if (fabsf(c0) > 1e-6f) {
    solve_quartic(c1 / c0, c2 / c0, c3 / c0, c4 / c0, r, v);
    return;
  }
  const float s = fabsf(c1) > 0.0f ? c1 : 1.0f;
  solve_cubic(c2 / s, c3 / s, c4 / s, r, v);
  r[3] = 0.0f;
  v[3] = false;
}

// Shared memory of one block: the vehicle's P pyramids, field by field.
struct PyrSmem {
  float* depth;
  float* b[4];  // right, top, left, bottom
  float* n;     // (P, 12): face f's normal at 3 f
  int* valid;
  __device__ PyrSmem(float* base, int P) {
    depth = base;
    for (int k = 0; k < 4; ++k) b[k] = base + (1 + k) * P;
    n = base + 5 * P;
    valid = reinterpret_cast<int*>(base + 17 * P);
  }
  static size_t bytes(int P) { return static_cast<size_t>(18) * P * sizeof(float); }
};

// A section's point to place: the deepest point's pixel and depth.
struct Query {
  float px, py, z;
};

// rappids.find_containing_pyramid for every section in `searching` (a
// section's bit at its group's first lane): the first pyramid in set order
// deeper than z whose bounds, narrowed by the pixel buffer, hold (px, py);
// -1 if none. Lane q tests pyramid base + q of each chunk against every
// searching section's point; each section takes __ffs of its first ballot
// that is not 0. Called by the whole warp; returns the lane's section's
// pyramid.
__device__ __forceinline__ int find_pyramid(const PyrSmem& s, int P, Query mine,
                                            unsigned searching, int lane) {
  Query q[kSections];
#pragma unroll
  for (int j = 0; j < kSections; ++j) {
    q[j].px = __shfl_sync(kFull, mine.px, 4 * j);
    q[j].py = __shfl_sync(kFull, mine.py, 4 * j);
    q[j].z = __shfl_sync(kFull, mine.z, 4 * j);
  }
  int found = -1;
  unsigned open = searching;  // the searching sections with no hit yet
  for (int base = 0; base < P && open != 0u; base += 32) {
    const int i = base + lane;
    const bool ok = i < P && s.valid[i];
    const float d = ok ? s.depth[i] : 0.0f;
    const float right = ok ? s.b[0][i] : 0.0f, top = ok ? s.b[1][i] : 0.0f;
    const float left = ok ? s.b[2][i] : 0.0f, bottom = ok ? s.b[3][i] : 0.0f;
#pragma unroll
    for (int j = 0; j < kSections; ++j) {
      if (!(open & (1u << (4 * j)))) continue;  // the same in every lane
      const bool in = ok && d >= q[j].z && left + kPixelBuffer < q[j].px &&
                      q[j].px < right - kPixelBuffer && top + kPixelBuffer < q[j].py &&
                      q[j].py < bottom - kPixelBuffer;
      const unsigned hits = __ballot_sync(kFull, in);
      if (hits != 0u) {
        open &= ~(1u << (4 * j));
        if ((lane >> 2) == j) found = base + __ffs(hits) - 1;
      }
    }
  }
  return found;
}

__global__ void __launch_bounds__(32 * kCheckWarps)
    collision_check_kernel(TrajArgs tr, PyrArgs pyr, const bool* enabled, CamArgs cam, int N,
                           int P, CheckOut out) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kCheckWarps + (threadIdx.x >> 5);
  const PyrSmem s(smem, P);
  for (int i = threadIdx.x; i < P; i += 32 * kCheckWarps) {
    const int g = b * P + i;
    s.depth[i] = pyr.depth[g];
#pragma unroll
    for (int k = 0; k < 4; ++k) s.b[k][i] = pyr.bounds[4 * g + k];
#pragma unroll
    for (int k = 0; k < 12; ++k) s.n[12 * i + k] = pyr.normals[12 * g + k];
    s.valid[i] = pyr.valid[g] ? 1 : 0;
  }
  __syncthreads();
  if (n >= N) return;  // the whole warp

  const Cand c = load_cand(tr, b, n, true);
  const float focal = *cam.focal, cx = *cam.cx, cy = *cam.cy, mcd = *cam.min_check_dist;
  const int k = lane >> 2, f = lane & 3;  // section, face

  // rappids.monotonic_sections: [0, tf] split at zdot's interior roots,
  // zdot(t) = v0z + a0z t + gz t^2/2 + bz t^3/6 + az t^4/24; lane 0 solves
  // and sorts, every lane takes the bounds
  float bnd[6];
  bnd[0] = 0.0f;
  bnd[5] = c.tf;
  if (lane == 0) {
    float r[4];
    bool rv[4];
    quartic_or_cubic(c.al[2] / 24.0f, c.be[2] / 6.0f, c.ga[2] * 0.5f, c.a0[2], c.v0[2], r, rv);
#pragma unroll
    for (int i = 0; i < 4; ++i) bnd[1 + i] = rv[i] && r[i] > 0.0f && r[i] < c.tf ? r[i] : c.tf;
    // the sort's values (equal values are equal bits: +0, roots > 0, tf)
#pragma unroll
    for (int i = 1; i < 6; ++i)
#pragma unroll
      for (int j = i; j > 0; --j) {
        const float lo = fminf(bnd[j - 1], bnd[j]), hi = fmaxf(bnd[j - 1], bnd[j]);
        bnd[j - 1] = lo;
        bnd[j] = hi;
      }
  }
#pragma unroll
  for (int i = 1; i < 5; ++i) bnd[i] = __shfl_sync(kFull, bnd[i], 0);
  float t1 = 0.0f, t2 = 0.0f;
#pragma unroll
  for (int i = 0; i < kSections; ++i) {
    t1 = i == k ? bnd[i] : t1;
    t2 = i == k ? bnd[i + 1] : t2;
  }
  const bool on = enabled == nullptr || enabled[b * N + n];
  const bool live0 = on && k < kSections && (t2 - t1) > 1e-6f;

  // the section's chain: live, uncovered (and where), pops made
  bool live = live0, uncovered = false;
  float fpx = 0.0f, fpy = 0.0f, fz = 0.0f;
  int pops = 0;
  for (int step = 0; step < kMaxCheckIters; ++step) {
    int before = 0;  // the pops of the sections before this lane's
#pragma unroll
    for (int j = 0; j < kSections; ++j) {
      const int pj = __shfl_sync(kFull, pops, 4 * j);
      before += j < k ? pj : 0;
    }
    const bool active = live && !uncovered && before + pops < kMaxCheckIters;
    if (!__any_sync(kFull, active)) break;
    Query mine = {0.0f, 0.0f, 0.0f};
    bool increasing = false, skip = false;
    if (active) {
      const float z1 = poly_at(c, 2, t1), z2 = poly_at(c, 2, t2);
      increasing = z1 < z2;
      skip = z1 < mcd && z2 < mcd;  // wholly closer than min_check_dist: dropped
      const float deep_t = increasing ? t2 : t1;
      mine.z = tmax(z1, z2);
      // rappids.project: x f / z + cx, z kept off 0
      const float safe_z = fabsf(mine.z) < 1e-9f ? 1e-9f : mine.z;
      mine.px = poly_at(c, 0, deep_t) * focal / safe_z + cx;
      mine.py = poly_at(c, 1, deep_t) * focal / safe_z + cy;
    }
    const bool search = active && !skip;
    const int p = find_pyramid(s, P, mine, __ballot_sync(kFull, search) & 0x11111u, lane);

    // rappids._deepest_collision_time against pyramid p's four lateral
    // faces, one a lane: whether a face is crossed inside (t1, t2), and the
    // deepest crossing (the last if z increases on the section, else the
    // first). nd(v), the normal dotted with v, adds left to right.
    bool hit_f = false;
    float t_inc = -INFINITY, t_dec = INFINITY;
    if (search && p >= 0) {
      const float* nf = s.n + 12 * p + 3 * f;
      auto nd = [&](const float v[3]) { return nf[0] * v[0] + nf[1] * v[1] + nf[2] * v[2]; };
      float r[4];
      bool v[4];
      quartic_or_cubic(nd(c.al) / 120.0f, nd(c.be) / 24.0f, nd(c.ga) / 6.0f, nd(c.a0) * 0.5f,
                       nd(c.v0), r, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (v[i] && r[i] > t1 && r[i] < t2) {  // never NaN, and > t1 >= 0
          hit_f = true;
          t_inc = fmaxf(t_inc, r[i]);
          t_dec = fminf(t_dec, r[i]);
        }
      }
    }
#pragma unroll
    for (int m = 1; m < 4; m <<= 1) {
      t_inc = fmaxf(t_inc, __shfl_xor_sync(kFull, t_inc, m));
      t_dec = fminf(t_dec, __shfl_xor_sync(kFull, t_dec, m));
    }
    const bool hit = ((__ballot_sync(kFull, hit_f) >> (4 * k)) & 0xfu) != 0u;

    if (active) {
      ++pops;
      if (skip) {
        live = false;
      } else if (p < 0) {  // no pyramid covers the deepest point: in collision, and here
        uncovered = true;
        fpx = mine.px;
        fpy = mine.py;
        fz = mine.z;
      } else {
        // the remainder outside the pyramid stays the section
        const float t_col = increasing ? t_inc : t_dec;
        const float new_t1 = increasing ? t1 : t_col;
        const float new_t2 = increasing ? t_col : t2;
        if (hit && (new_t2 - new_t1) > 1e-6f) {
          t1 = new_t1;
          t2 = new_t2;
        } else {
          live = false;
        }
      }
    }
  }

  // the replay: the sequential loop over the sections' chains in order
  const unsigned live_bits = __ballot_sync(kFull, live0 && f == 0);  // a section's first lane
  int it = 0;
  bool is_free = true, done = false;
  float opx = 0.0f, opy = 0.0f, oz = 0.0f;
#pragma unroll
  for (int j = 0; j < kSections; ++j) {
    const int nj = __shfl_sync(kFull, pops, 4 * j);
    const bool unc = __shfl_sync(kFull, uncovered ? 1 : 0, 4 * j) != 0;
    const bool still = __shfl_sync(kFull, live && !uncovered ? 1 : 0, 4 * j) != 0;
    const float jx = __shfl_sync(kFull, fpx, 4 * j), jy = __shfl_sync(kFull, fpy, 4 * j);
    const float jz = __shfl_sync(kFull, fz, 4 * j);
    if (done) continue;
    if (it + nj > kMaxCheckIters || (it + nj == kMaxCheckIters && still)) {
      it = kMaxCheckIters;  // the budget ran out inside section j, still live
      is_free = false;
      done = true;
    } else {
      it += nj;
      if (unc) {
        is_free = false;
        opx = jx;
        opy = jy;
        oz = jz;
        done = true;
      } else if (it == kMaxCheckIters) {  // the budget ends with section j
        is_free = (live_bits >> (4 * j + 4)) == 0u;
        done = true;
      }
    }
  }
  if (lane == 0) {
    const int o = b * N + n;
    out.free[o] = is_free;
    out.fail_px[o] = opx;
    out.fail_py[o] = opy;
    out.fail_depth[o] = oz;
    if (out.pops != nullptr) out.pops[o] = it;
  }
}

// ---------------------------------------------------------------------------
// K8: the input and velocity gates
// ---------------------------------------------------------------------------

// traj.acceleration's axis k: a0 + g t + b ipow(t, 2) / 2 + a ipow(t, 3) / 6
__device__ __forceinline__ float acc_at(const Cand& c, int k, float t) {
  return c.a0[k] + c.ga[k] * t + c.be[k] * (t * t) * 0.5f + c.al[k] * (t * (t * t)) / 6.0f;
}

// traj._axis_max_jerk_sq's jerk_at: g + b t + a ipow(t, 2) / 2
__device__ __forceinline__ float jerk_at(const Cand& c, int k, float t) {
  return c.ga[k] + c.be[k] * t + c.al[k] * (t * t) * 0.5f;
}

// The times inside a section that the verdict evaluates on axis k: the
// acceleration's stationary points (traj._axis_minmax_acc's t_0, t_1) and
// the jerk's (_axis_max_jerk_sq's tmax). They do not depend on the section.
struct Stationary {
  float t0, t1, tj;
  bool has_j;
};

__device__ __forceinline__ Stationary stationary(const Cand& c, int k) {
  Stationary st;
  const float al = c.al[k], be = c.be[k], ga = c.ga[k];
  const float det = be * be - 2.0f * ga * al;
  const bool has_quad = fabsf(al) > 0.0f;
  const float sq = sqrtf(clamp_min(det, 0.0f));
  const bool real = has_quad && det >= 0.0f;
  const bool has_lin = fabsf(be) > 0.0f;
  const float tl0 = has_lin ? -ga / be : 0.0f;
  st.t0 = has_quad ? (real ? (-be + sq) / al : 0.0f) : tl0;
  st.t1 = has_quad && real ? (-be - sq) / al : 0.0f;
  st.has_j = has_quad;
  st.tj = has_quad ? -be / al : 0.0f;
  return st;
}

struct Limits {
  float fmin, fmax, wmax;
};

// A candidate's lane group: its four lanes' mask, and lane a's axis.
struct Group {
  unsigned mask;
  int axis;
  // v of the group's lane for axis i (0, 1, 2)
  __device__ __forceinline__ float of(float v, int i) const { return __shfl_sync(mask, v, i, 4); }
};

// traj.thrust: |acceleration(t) - grav|, the squares added left to right;
// d: this lane's axis's acceleration(t) - grav
__device__ __forceinline__ float thrust(const Group& grp, float d) {
  const float x = grp.of(d, 0), y = grp.of(d, 1), z = grp.of(d, 2);
  return sqrtf(x * x + y * y + z * z);
}

// traj._section_verdict on [t1, t2], each lane its axis's terms: hard_bad
// (the section rejects) and split (it is uncertain and needs the next
// level), the same in the group's four lanes.
__device__ __forceinline__ void section_verdict(const Cand& c, const Stationary& st, float gk,
                                                const Limits& lim, const Group& grp, float t1,
                                                float t2, bool& hard_bad, bool& split) {
  const int k = grp.axis;
  const float a_lo = acc_at(c, k, t1), a_hi = acc_at(c, k, t2);
  const float thr1 = thrust(grp, a_lo - gk), thr2 = thrust(grp, a_hi - gk);
  bool hard = tmax(thr1, thr2) > lim.fmax || tmin(thr1, thr2) < lim.fmin;
  const float fmax_sq_allowed = lim.fmax * lim.fmax;
  // _axis_minmax_acc
  float amin = tmin(a_lo, a_hi), amax = tmax(a_lo, a_hi);
  const float tcs[2] = {st.t0, st.t1};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float tc = tcs[i];
    if (tc > t1 && tc < t2) {
      const float a_c = acc_at(c, k, tmin(tmax(tc, t1), t2));
      amin = tmin(amin, a_c);
      amax = tmax(amax, a_c);
    }
  }
  const float v1 = amin - gk, v2 = amax - gk;
  const bool hard_k = tmax(v1 * v1, v2 * v2) > fmax_sq_allowed;
  const float lo = tmin(fabsf(v1), fabsf(v2)), hi = tmax(fabsf(v1), fabsf(v2));
  const float fmin_k = (v1 * v2) < 0.0f ? 0.0f : lo * lo;
  const float fmax_k = hi * hi;
  // _axis_max_jerk_sq
  const float j1 = jerk_at(c, k, t1), j2e = jerk_at(c, k, t2);
  float j2 = tmax(j1 * j1, j2e * j2e);
  if (st.has_j && st.tj > t1 && st.tj < t2) {
    const float jm = jerk_at(c, k, tmin(tmax(st.tj, t1), t2));
    j2 = tmax(j2, jm * jm);
  }
  // the axes' ORs, and sum3: left to right
  hard = hard || __ballot_sync(grp.mask, hard_k) != 0u;
  const float fmin_sq = grp.of(fmin_k, 0) + grp.of(fmin_k, 1) + grp.of(fmin_k, 2);
  const float fmax_sq = grp.of(fmax_k, 0) + grp.of(fmax_k, 1) + grp.of(fmax_k, 2);
  const float jmax_sq = grp.of(j2, 0) + grp.of(j2, 1) + grp.of(j2, 2);
  const float fmin = sqrtf(fmin_sq), fmax = sqrtf(fmax_sq);
  const float wbound =
      fmin_sq > 1e-6f ? sqrtf(jmax_sq / clamp_min(fmin_sq, 1e-12f)) : INFINITY;
  hard = hard || fmax < lim.fmin || fmin > lim.fmax;
  const bool uncertain = fmin < lim.fmin || fmax > lim.fmax || wbound > lim.wmax;
  hard_bad = hard;
  split = !hard && uncertain;
}

// traj.check_input_feasibility, depth first; sections: how many it evaluated.
// The walk is the same in the group's four lanes.
__device__ __forceinline__ bool input_feasible(const Cand& c, float gk, const Limits& lim,
                                               const Group& grp, float min_section_time,
                                               int last_level, int& sections) {
  sections = 0;
  if (last_level < 0) return false;  // static_max_tf cuts level 0 itself
  const Stationary st = stationary(c, grp.axis);
  int level = 0, idx = 0;
  while (true) {
    const float inv = 1.0f / static_cast<float>(1 << level);  // exact: a power of two
    // tf / n, exact: torch divides (CPU) or multiplies by 1 / n (card) alike
    if (c.tf * inv < min_section_time) return false;  // a needed section too narrow
    const float t1 = c.tf * (static_cast<float>(idx) * inv);
    const float t2 = c.tf * ((static_cast<float>(idx) + 1.0f) * inv);
    bool hard, split;
    section_verdict(c, st, gk, lim, grp, t1, t2, hard, split);
    ++sections;
    if (hard) return false;
    if (split) {
      if (level == last_level) return false;  // max_depth, or the static_max_tf cut below
      ++level;
      idx *= 2;
      continue;
    }
    while (level > 0 && (idx & 1)) {  // resolved: on to the next section depth first
      --level;
      idx >>= 1;
    }
    if (level == 0) return true;
    ++idx;
  }
}

// traj.check_velocity_feasibility on axis k: |v| < vmax at the axis's
// acceleration roots in [0, tf] and at 0 and tf.
__device__ __forceinline__ bool velocity_ok(const Cand& c, int k, float vmax, bool strict) {
  const float c0 = c.al[k] / 6.0f, c1 = c.be[k] * 0.5f, c2 = c.ga[k], c3 = c.a0[k];
  const bool degenerate = fabsf(c0) <= 1e-6f;
  if (degenerate && strict) return false;
  float t[5];
  bool v[5];
  if (degenerate) {  // the acceleration's quadratic
    solve_quadratic(c1, c2, c3, t, v);
    t[2] = 0.0f;
    v[2] = false;
  } else {
    solve_cubic(c1 / c0, c2 / c0, c3 / c0, t, v);
  }
  t[3] = 0.0f;
  v[3] = true;
  t[4] = c.tf;
  v[4] = true;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float ti = t[i];
    if (!(v[i] && ti >= 0.0f && ti <= c.tf)) continue;
    const float tt = ti * ti;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float vel = c.v0[j] + c.a0[j] * ti + c.ga[j] * tt * 0.5f +
                        c.be[j] * (ti * tt) / 6.0f + c.al[j] * (tt * tt) / 24.0f;
      if (fabsf(vel) >= vmax) return false;
    }
  }
  return true;
}

__global__ void __launch_bounds__(32 * kGateWarps)
    plan_gates_kernel(TrajArgs tr, GateArgs ga, int N, GateOut out) {
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, a = lane & 3;
  const int n = blockIdx.x * 8 * kGateWarps + (threadIdx.x >> 2);
  if (n >= N) return;  // the whole group
  const Group grp = {0xfu << (lane & ~3), a < 3 ? a : 2};
  const Cand c = load_cand(tr, b, n, false);
  const float gk = ga.grav[b * ga.grav_sv + grp.axis];
  const Limits lim = {*ga.fmin, *ga.fmax, *ga.wmax};
  const bool vel = __ballot_sync(grp.mask, velocity_ok(c, grp.axis, *ga.vmax, ga.strict != 0))
                   == grp.mask;
  int sections;
  const bool feas = input_feasible(c, gk, lim, grp, ga.min_section_time, ga.last_level, sections);
  if (a == 0) {
    const int o = b * N + n;
    out.feas[o] = feas;
    out.vel_ok[o] = vel;
    if (out.sections != nullptr) out.sections[o] = sections;
  }
}

}  // namespace

// B vehicles x N candidates; P >= 0 pyramids a vehicle. enabled (B, N) or null
// (every candidate). The outputs are (B, N); pops, where not null, gets
// each candidate's popped sections.
extern "C" int collision_check_launch(TrajArgs tr, PyrArgs pyr, const bool* enabled, CamArgs cam,
                                      int B, int N, int P, CheckOut out, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || P < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = PyrSmem::bytes(P);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        collision_check_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((N + kCheckWarps - 1) / kCheckWarps, B);
  collision_check_kernel<<<grid, 32 * kCheckWarps, smem, static_cast<cudaStream_t>(stream)>>>(
      tr, pyr, enabled, cam, N, P, out);
  return static_cast<int>(cudaGetLastError());
}

// B vehicles x N candidates; the outputs are (B, N); sections, where not
// null, gets each candidate's evaluated bisection sections.
extern "C" int plan_gates_launch(TrajArgs tr, GateArgs ga, int B, int N, GateOut out,
                                 void* stream) {
  if (B < 1 || B > 65535 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int per_block = 8 * kGateWarps;  // candidates
  const dim3 grid((N + per_block - 1) / per_block, B);
  plan_gates_kernel<<<grid, 32 * kGateWarps, 0, static_cast<cudaStream_t>(stream)>>>(tr, ga, N,
                                                                                      out);
  return static_cast<int>(cudaGetLastError());
}
