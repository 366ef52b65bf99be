// The RAPPIDS planner's candidate pass: the pyramid collision check (K7) and
// the candidates' input and velocity gates (K8), one thread per candidate.
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
// K7: grid (ceil(N / kThreads), B), block (j, b) checks candidates
// j kThreads .. of vehicle b. The block stages its vehicle's pyramid set
// (depth, 4 bounds, 4 x 3 normals, valid) in shared memory once; each
// thread holds its candidate's coefficients and its monotone sections in
// registers and runs the JAX package's loop with its real exit: pop the
// first live section while fewer than MAX_CHECK_ITERS pops were made, some
// section is live and none was found uncovered. The plain version runs
// MAX_CHECK_ITERS masked steps in which a finished candidate keeps its
// state, so the early exit gives the same result. The pyramid search is the
// plain version's first hit in set order.
//
// K8: grid (ceil(N / kThreads), B). The input bisection walks the plain
// version's dyadic sections depth first: a section's verdict depends only on
// (level, index), through t1 = tf (idx / n) and t2 = tf ((idx + 1) / n),
// both exact (n a power of two), so the walk reaches the level-by-level
// sweep's boolean, and it stops at the first section that rejects. The
// velocity proof solves each axis's acceleration cubic.
//
// What bounds them on the card: latency. A frame checks 256 candidates
// (B x 256 in a fleet), a few pops each of five quartic solves with double
// precision acos / cos or pow; the bytes (~100 a candidate, the pyramid set
// a few KB) and the float operations are microseconds' worth of nothing.
// The design keeps every candidate's loop in its own thread with nothing
// shared but the staged pyramids, small blocks (kThreads) so even one
// vehicle's 256 candidates spread over several SMs, and the exits the
// plain version's fixed shapes could not take.

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

constexpr int kThreads = 64;
constexpr int kMaxCheckIters = 24;  // rappids.MAX_CHECK_ITERS
// rappids.monotonic_sections sorts six bounds into five sections and pads
// them to MAX_SECTIONS = 8 slots; a padded slot is never live and a pop
// writes back only into its own slot, so five registers hold every section.
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

__device__ __forceinline__ float pick(const float (&a)[kSections], int i) {
  float out = a[0];
#pragma unroll
  for (int k = 1; k < kSections; ++k) out = k == i ? a[k] : out;
  return out;
}

__device__ __forceinline__ void put(float (&a)[kSections], int i, float x) {
#pragma unroll
  for (int k = 0; k < kSections; ++k) a[k] = k == i ? x : a[k];
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

// rappids.find_containing_pyramid: the first pyramid in set order deeper
// than z whose bounds, narrowed by the pixel buffer, hold (px, py); -1 if none.
__device__ __forceinline__ int find_pyramid(const PyrSmem& s, int P, float px, float py, float z) {
  for (int p = 0; p < P; ++p) {
    if (s.valid[p] && s.depth[p] >= z && s.b[2][p] + kPixelBuffer < px &&
        px < s.b[0][p] - kPixelBuffer && s.b[1][p] + kPixelBuffer < py &&
        py < s.b[3][p] - kPixelBuffer)
      return p;
  }
  return -1;
}

// rappids._deepest_collision_time against pyramid p's four lateral faces:
// whether a face is crossed inside (t1, t2), and the deepest crossing (the
// last if z increases on the section, else the first). nd(v), the normal
// dotted with v, adds left to right.
__device__ __forceinline__ bool deepest_collision_time(const Cand& c, const float* n, float t1,
                                                       float t2, bool increasing, float& t_col) {
  bool hit = false;
  float t_inc = -INFINITY, t_dec = INFINITY;
#pragma unroll 1
  for (int f = 0; f < 4; ++f) {
    const float* nf = n + 3 * f;
    auto nd = [&](const float v[3]) { return nf[0] * v[0] + nf[1] * v[1] + nf[2] * v[2]; };
    float r[4];
    bool v[4];
    quartic_or_cubic(nd(c.al) / 120.0f, nd(c.be) / 24.0f, nd(c.ga) / 6.0f, nd(c.a0) * 0.5f,
                     nd(c.v0), r, v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (v[k] && r[k] > t1 && r[k] < t2) {  // never NaN, and > t1 >= 0
        hit = true;
        t_inc = fmaxf(t_inc, r[k]);
        t_dec = fminf(t_dec, r[k]);
      }
    }
  }
  t_col = increasing ? t_inc : t_dec;
  return hit;
}

__global__ void __launch_bounds__(kThreads)
    collision_check_kernel(TrajArgs tr, PyrArgs pyr, const bool* enabled, CamArgs cam, int N,
                           int P, CheckOut out) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const PyrSmem s(smem, P);
  for (int i = threadIdx.x; i < P; i += kThreads) {
    const int g = b * P + i;
    s.depth[i] = pyr.depth[g];
#pragma unroll
    for (int k = 0; k < 4; ++k) s.b[k][i] = pyr.bounds[4 * g + k];
#pragma unroll
    for (int k = 0; k < 12; ++k) s.n[12 * i + k] = pyr.normals[12 * g + k];
    s.valid[i] = pyr.valid[g] ? 1 : 0;
  }
  __syncthreads();
  if (n >= N) return;

  const Cand c = load_cand(tr, b, n, true);
  const float focal = *cam.focal, cx = *cam.cx, cy = *cam.cy, mcd = *cam.min_check_dist;

  // rappids.monotonic_sections: [0, tf] split at zdot's interior roots,
  // zdot(t) = v0z + a0z t + gz t^2/2 + bz t^3/6 + az t^4/24
  float r[4];
  bool rv[4];
  quartic_or_cubic(c.al[2] / 24.0f, c.be[2] / 6.0f, c.ga[2] * 0.5f, c.a0[2], c.v0[2], r, rv);
  float bnd[6];
  bnd[0] = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) bnd[1 + k] = rv[k] && r[k] > 0.0f && r[k] < c.tf ? r[k] : c.tf;
  bnd[5] = c.tf;
  // the sort's values (equal values are equal bits: +0, roots > 0, tf)
#pragma unroll
  for (int i = 1; i < 6; ++i)
#pragma unroll
    for (int j = i; j > 0; --j) {
      const float lo = fminf(bnd[j - 1], bnd[j]), hi = fmaxf(bnd[j - 1], bnd[j]);
      bnd[j - 1] = lo;
      bnd[j] = hi;
    }
  float t1s[kSections], t2s[kSections];
  unsigned live = 0;
  const bool on = enabled == nullptr || enabled[b * N + n];
#pragma unroll
  for (int k = 0; k < kSections; ++k) {
    t1s[k] = bnd[k];
    t2s[k] = bnd[k + 1];
    if (on && (t2s[k] - t1s[k]) > 1e-6f) live |= 1u << k;
  }

  bool uncovered = false;
  float fpx = 0.0f, fpy = 0.0f, fz = 0.0f;
  int it = 0;
  for (; it < kMaxCheckIters && live != 0u && !uncovered; ++it) {
    const int idx = __ffs(live) - 1;  // the first live section
    const unsigned bit = 1u << idx;
    const float t1 = pick(t1s, idx), t2 = pick(t2s, idx);
    const float z1 = poly_at(c, 2, t1), z2 = poly_at(c, 2, t2);
    const bool increasing = z1 < z2;
    if (z1 < mcd && z2 < mcd) {  // wholly closer than min_check_dist: dropped
      live &= ~bit;
      continue;
    }
    const float deep_t = increasing ? t2 : t1;
    const float deep_z = tmax(z1, z2);
    // rappids.project: x f / z + cx, z kept off 0
    const float safe_z = fabsf(deep_z) < 1e-9f ? 1e-9f : deep_z;
    const float px = poly_at(c, 0, deep_t) * focal / safe_z + cx;
    const float py = poly_at(c, 1, deep_t) * focal / safe_z + cy;
    const int p = find_pyramid(s, P, px, py, deep_z);
    if (p < 0) {  // no pyramid covers the deepest point: in collision, and here
      uncovered = true;
      fpx = px;
      fpy = py;
      fz = deep_z;
      continue;
    }
    float t_col;
    const bool hit = deepest_collision_time(c, s.n + 12 * p, t1, t2, increasing, t_col);
    // the remainder outside the pyramid goes back into the freed slot
    const float new_t1 = increasing ? t1 : t_col;
    const float new_t2 = increasing ? t_col : t2;
    if (hit && (new_t2 - new_t1) > 1e-6f) {
      put(t1s, idx, new_t1);
      put(t2s, idx, new_t2);
    } else {
      live &= ~bit;
    }
  }
  const int o = b * N + n;
  out.free[o] = !uncovered && live == 0u;
  out.fail_px[o] = fpx;
  out.fail_py[o] = fpy;
  out.fail_depth[o] = fz;
  if (out.pops != nullptr) out.pops[o] = it;
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

// The times inside a section that the verdict evaluates, per axis: the
// acceleration's stationary points (traj._axis_minmax_acc's t_0, t_1) and
// the jerk's (_axis_max_jerk_sq's tmax). They do not depend on the section.
struct Stationary {
  float t0[3], t1[3], tj[3];
  bool has_j[3];
};

__device__ __forceinline__ Stationary stationary(const Cand& c) {
  Stationary st;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float al = c.al[k], be = c.be[k], ga = c.ga[k];
    const float det = be * be - 2.0f * ga * al;
    const bool has_quad = fabsf(al) > 0.0f;
    const float sq = sqrtf(clamp_min(det, 0.0f));
    const bool real = has_quad && det >= 0.0f;
    const bool has_lin = fabsf(be) > 0.0f;
    const float tl0 = has_lin ? -ga / be : 0.0f;
    st.t0[k] = has_quad ? (real ? (-be + sq) / al : 0.0f) : tl0;
    st.t1[k] = has_quad && real ? (-be - sq) / al : 0.0f;
    st.has_j[k] = has_quad;
    st.tj[k] = has_quad ? -be / al : 0.0f;
  }
  return st;
}

// traj.thrust: |acceleration(t) - grav|, the squares added left to right
__device__ __forceinline__ float thrust(const Cand& c, const float g[3], float t) {
  const float x = acc_at(c, 0, t) - g[0], y = acc_at(c, 1, t) - g[1], z = acc_at(c, 2, t) - g[2];
  return sqrtf(x * x + y * y + z * z);
}

struct Limits {
  float fmin, fmax, wmax;
};

// traj._section_verdict on [t1, t2]: hard_bad (the section rejects) and
// split (it is uncertain and needs the next level).
__device__ __forceinline__ void section_verdict(const Cand& c, const Stationary& st,
                                                const float g[3], const Limits& lim, float t1,
                                                float t2, bool& hard_bad, bool& split) {
  const float thr1 = thrust(c, g, t1), thr2 = thrust(c, g, t2);
  bool hard = tmax(thr1, thr2) > lim.fmax || tmin(thr1, thr2) < lim.fmin;
  const float fmax_sq_allowed = lim.fmax * lim.fmax;
  float fmin_sq = 0.0f, fmax_sq = 0.0f, jmax_sq = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    // _axis_minmax_acc
    const float a_lo = acc_at(c, k, t1), a_hi = acc_at(c, k, t2);
    float amin = tmin(a_lo, a_hi), amax = tmax(a_lo, a_hi);
    const float tcs[2] = {st.t0[k], st.t1[k]};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float tc = tcs[i];
      if (tc > t1 && tc < t2) {
        const float a_c = acc_at(c, k, tmin(tmax(tc, t1), t2));
        amin = tmin(amin, a_c);
        amax = tmax(amax, a_c);
      }
    }
    const float v1 = amin - g[k], v2 = amax - g[k];
    hard = hard || tmax(v1 * v1, v2 * v2) > fmax_sq_allowed;
    const float lo = tmin(fabsf(v1), fabsf(v2)), hi = tmax(fabsf(v1), fabsf(v2));
    const float fmin_k = (v1 * v2) < 0.0f ? 0.0f : lo * lo;
    const float fmax_k = hi * hi;
    // _axis_max_jerk_sq
    const float j1 = jerk_at(c, k, t1), j2e = jerk_at(c, k, t2);
    float j2 = tmax(j1 * j1, j2e * j2e);
    if (st.has_j[k] && st.tj[k] > t1 && st.tj[k] < t2) {
      const float jm = jerk_at(c, k, tmin(tmax(st.tj[k], t1), t2));
      j2 = tmax(j2, jm * jm);
    }
    // sum3: left to right
    fmin_sq = k == 0 ? fmin_k : fmin_sq + fmin_k;
    fmax_sq = k == 0 ? fmax_k : fmax_sq + fmax_k;
    jmax_sq = k == 0 ? j2 : jmax_sq + j2;
  }
  const float fmin = sqrtf(fmin_sq), fmax = sqrtf(fmax_sq);
  const float wbound =
      fmin_sq > 1e-6f ? sqrtf(jmax_sq / clamp_min(fmin_sq, 1e-12f)) : INFINITY;
  hard = hard || fmax < lim.fmin || fmin > lim.fmax;
  const bool uncertain = fmin < lim.fmin || fmax > lim.fmax || wbound > lim.wmax;
  hard_bad = hard;
  split = !hard && uncertain;
}

// traj.check_input_feasibility, depth first; sections: how many it evaluated.
__device__ __forceinline__ bool input_feasible(const Cand& c, const float g[3], const Limits& lim,
                                               float min_section_time, int last_level,
                                               int& sections) {
  sections = 0;
  if (last_level < 0) return false;  // static_max_tf cuts level 0 itself
  const Stationary st = stationary(c);
  int level = 0, idx = 0;
  while (true) {
    const float inv = 1.0f / static_cast<float>(1 << level);  // exact: a power of two
    // tf / n, exact: torch divides (CPU) or multiplies by 1 / n (card) alike
    if (c.tf * inv < min_section_time) return false;  // a needed section too narrow
    const float t1 = c.tf * (static_cast<float>(idx) * inv);
    const float t2 = c.tf * ((static_cast<float>(idx) + 1.0f) * inv);
    bool hard, split;
    section_verdict(c, st, g, lim, t1, t2, hard, split);
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

// traj.check_velocity_feasibility: |v| < vmax at each axis's acceleration
// roots in [0, tf] and at 0 and tf.
__device__ __forceinline__ bool velocity_ok(const Cand& c, float vmax, bool strict) {
#pragma unroll 1
  for (int k = 0; k < 3; ++k) {
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
  }
  return true;
}

__global__ void __launch_bounds__(kThreads)
    plan_gates_kernel(TrajArgs tr, GateArgs ga, int N, GateOut out) {
  const int b = blockIdx.y;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const Cand c = load_cand(tr, b, n, false);
  const float* gp = ga.grav + b * ga.grav_sv;
  const float g[3] = {gp[0], gp[1], gp[2]};
  const Limits lim = {*ga.fmin, *ga.fmax, *ga.wmax};
  int sections;
  const int o = b * N + n;
  out.feas[o] = input_feasible(c, g, lim, ga.min_section_time, ga.last_level, sections);
  out.vel_ok[o] = velocity_ok(c, *ga.vmax, ga.strict != 0);
  if (out.sections != nullptr) out.sections[o] = sections;
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
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  collision_check_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      tr, pyr, enabled, cam, N, P, out);
  return static_cast<int>(cudaGetLastError());
}

// B vehicles x N candidates; the outputs are (B, N); sections, where not
// null, gets each candidate's evaluated bisection sections.
extern "C" int plan_gates_launch(TrajArgs tr, GateArgs ga, int B, int N, GateOut out,
                                 void* stream) {
  if (B < 1 || B > 65535 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  plan_gates_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(tr, ga, N, out);
  return static_cast<int>(cudaGetLastError());
}
