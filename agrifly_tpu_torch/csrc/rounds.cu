// The planner's pyramid rounds: the glue between the inflation launches of
// planner/rappids.py's _plan_core, as three kernels.
//
// Replaces no pallas_call: the JAX package runs this glue as jnp inside the
// orchard frame's jit call (agrifly_tpu/planner/rappids.py _plan_core:956,
// its rounds :994 and lazy round :1022; build_pyramid_set:470,
// prefilter_seeds:538, merge_pyramid_sets:613, find_containing_pyramid:626,
// _greedy_seed_dedupe:912, _pyramid_from_edges:182). In eager PyTorch it was
// ~1.1k launches a frame; here it is one launch of K10 or K12 before each
// inflation launch and one of K11 after it, for every vehicle at once:
//   - K10 round_seeds_kernel: the stable order of where(gate, cost, inf), a
//     pre-planned round's slice of it, the containment test against the set
//     so far, the inflation kernel's seed rows (rappids.round_seeds_plain);
//   - K11 pyramid_set_kernel: the pyramids of the inflation's output rows
//     (base depth, bounds, unit normals), the `keep` shallowest, merged by
//     depth into the set so far at its capacity (rappids.pyramid_set_plain);
//   - K12 lazy_seeds_kernel: the seedable fail points in cost order,
//     containment, the prefilter on the work image, the greedy dedupe in its
//     serial order and the kept-first selection (rappids.lazy_seeds_plain).
//
// What bounds them on the card: latency. A block a vehicle does a few
// thousand operations in a chain of barriers (the ranks, the dedupe's one
// barrier a considered seed); K12's prefilter tests every pixel of the work
// image (76,800 pooled pixels at 640x480) against every valid considered
// seed, the bulk of its operations, a pixel read once, spread over the
// block's 1024 threads.
//
// Every sort is a stable rank by counting, rank i = #{j: d_j < d_i} +
// #{j < i: d_j = d_i}, with NaN after +inf (NaNs equal) and -0.0 equal to
// +0.0: argsort(stable=True)'s order; four lanes count an element's rank.
// The float operations are the plain versions' in their order (the build flags of cuda_build.py: -fmad=false, no
// fast math, IEEE division and sqrtf); a tensor divided by a python number on
// the card is a product with the float32 reciprocal, and so it is here.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The launch functions' arguments, passed by value from the wrapper
// (planner/cuda_rounds.py's ctypes structures mirror them); outside the
// anonymous namespace so the extern "C" functions keep external linkage.

// a (B, N) array: row b starts at p + b sv elements, its elements contiguous
struct Vec {
  const void* p;
  long long sv;
};

// a (B, C) pyramid set, contiguous: depth (B, C), bounds (B, C, 4), normals
// (B, C, 4, 3), valid (B, C); depth null: no set
struct SetArgs {
  const float* depth;
  const float* bounds;
  const float* normals;
  const unsigned char* valid;
  int C;
};

// the work image's camera (0-d tensors on the card) and the planner's radii
struct PlanCam {
  const float *focal, *cx, *cy, *depth_scale, *true_radius, *plan_radius, *min_check_dist;
  int width, height, k, shrink_extra;
};

namespace {

constexpr int kPixelBuffer = 2;         // rappids.PIXEL_BUFFER
constexpr float kDedupePx = 8.0f;       // rappids.LAZY_DEDUPE_PX
constexpr float kDedupeZQuanta = 2.0f;  // rappids.LAZY_DEDUPE_Z_QUANTA
constexpr int kMaxConsidered = 256;     // cuda_rounds.MAX_LAZY_CONSIDERED
constexpr int kSeedThreads = 1024;  // K10
constexpr int kSetThreads = 256;    // K11
constexpr int kLazyThreads = 1024;

template <class T>
__device__ __forceinline__ const T* row_of(const Vec& v, int b) {
  return static_cast<const T*>(v.p) + static_cast<long long>(b) * v.sv;
}

// int32 arithmetic that wraps as torch's does
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}
// torch.div(a, b, rounding_mode="floor") of int32
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

// Element i's place in the stable ascending order of keys[0, n): #{j: k_j <
// k_i} + #{j < i: k_j = k_i}, NaN after +inf and equal to itself (-0.0 and
// +0.0 compare equal). Counted by the four lanes of i's group (active: i <
// n), lane q over j = q, q + 4, ..., without branches; every lane of the
// warp calls it (the sums are shuffles).
__device__ __forceinline__ int group_rank(const float* keys, int n, int i, bool active) {
  int r = 0;
  if (active) {
    const float ki = keys[i];
    const bool nan_i = isnan(ki);
    for (int j = threadIdx.x & 3; j < n; j += 4) {
      const float kj = keys[j];
      const bool nan_j = isnan(kj);
      const bool lt = (kj < ki) | (nan_i & !nan_j);
      const bool eq = (kj == ki) | (nan_i & nan_j);
      r += (lt | ((j < i) & eq)) ? 1 : 0;
    }
  }
  r += __shfl_xor_sync(0xffffffffu, r, 1);
  r += __shfl_xor_sync(0xffffffffu, r, 2);
  return r;
}

// a tensor divided by a python int k on the card: the product with 1 / k
__device__ __forceinline__ float work_px(const PlanCam& c, float px) {
  return c.k > 1 ? px * (1.0f / static_cast<float>(c.k)) : px;
}

// rappids.seed_setup's scalars: edge_off, ignore, numer
struct SeedConsts {
  int edge_off, ignore, numer;
};

__device__ SeedConsts seed_consts(const PlanCam& c) {
  const float focal = *c.focal, scale = *c.depth_scale, tr = *c.true_radius;
  SeedConsts k;
  k.edge_off = wadd(static_cast<int>(focal * tr / *c.min_check_dist), c.shrink_extra);
  k.ignore = static_cast<int>(tr / scale);
  k.numer = static_cast<int>(focal * *c.plan_radius / scale);
  return k;
}

// rappids.seed_setup of one seed on the work image: [x0, y0, min_pyr_depth,
// left0, right0, top0, bottom0, ok0] (seed_rows' first eight columns)
__device__ void seed_setup(const PlanCam& c, const SeedConsts& k, float x0s, float y0s,
                           float min_depth, int* o) {
  const int W = c.width, H = c.height, eo = k.edge_off;
  const float scale = *c.depth_scale, pr = *c.plan_radius, focal = *c.focal;
  const int x0i = static_cast<int>(x0s), y0i = static_cast<int>(y0s);
  bool ok = !((x0i <= wadd(wadd(eo, kPixelBuffer), 1)) ||
              (x0i > wsub(wsub(wsub(W, eo), kPixelBuffer), 1)) ||
              (y0i <= wadd(wadd(eo, kPixelBuffer), 1)) ||
              (y0i > wsub(wsub(wsub(H, eo), kPixelBuffer), 1)));
  const int mpd = static_cast<int>((min_depth + pr) / scale);
  const int ir = static_cast<int>(focal * pr / (scale * static_cast<float>(mpd)));
  ok = ok && (wmul(2, ir) < wsub(min(W, H), wmul(2, eo)));
  const int top0 =
      wsub(y0i, ir) < eo ? eo : wsub(min(wsub(wsub(H, eo), 1), wadd(y0i, ir)), wmul(2, ir));
  const int left0 =
      wsub(x0i, ir) < eo ? eo : wsub(min(wsub(wsub(W, eo), 1), wadd(x0i, ir)), wmul(2, ir));
  o[0] = x0i;
  o[1] = y0i;
  o[2] = mpd;
  o[3] = left0;
  o[4] = wadd(left0, wmul(2, ir));
  o[5] = top0;
  o[6] = wadd(top0, wmul(2, ir));
  o[7] = ok ? 1 : 0;
}

__device__ __forceinline__ void finish_row(const PlanCam& c, const SeedConsts& k, int* o) {
  o[8] = k.edge_off;
  o[9] = k.ignore;
  o[10] = k.numer;
  o[11] = c.shrink_extra;
}

// rappids.find_containing_pyramid's found for one query point
__device__ bool contained(const SetArgs& s, int b, float px, float py, float z) {
  const long long base = static_cast<long long>(b) * s.C;
  for (int p = 0; p < s.C; ++p) {
    const float* q = s.bounds + 4 * (base + p);
    if (s.valid[base + p] && s.depth[base + p] >= z && q[2] + kPixelBuffer < px &&
        px < q[0] - kPixelBuffer && q[1] + kPixelBuffer < py && py < q[3] - kPixelBuffer)
      return true;
  }
  return false;
}

// ---------------------------------------------------------------------------
// K10: a pre-planned round's seeds
// ---------------------------------------------------------------------------

// Block b: vehicle b. keys (dynamic shared, N floats): where(gate, cost, inf).
// The candidate of rank first + r (r < P) becomes seed row r: its endpoint
// on the work image, valid where gated and not inside a pyramid of `set`.
__global__ void __launch_bounds__(kSeedThreads)
    round_seeds_kernel(Vec gate, Vec cost, Vec epx, Vec epy, Vec endz, SetArgs set, PlanCam cam,
                       int N, int first, int P, int* __restrict__ rows,
                       unsigned char* __restrict__ valid) {
  extern __shared__ float keys[];
  const int b = blockIdx.x;
  const unsigned char* g = row_of<unsigned char>(gate, b);
  const float* c = row_of<float>(cost, b);
  for (int i = threadIdx.x; i < N; i += blockDim.x) keys[i] = g[i] ? c[i] : INFINITY;
  __syncthreads();
  const SeedConsts k = seed_consts(cam);
  for (int i0 = 0; i0 < N; i0 += blockDim.x / 4) {  // the same trips for every lane
    const int i = i0 + (threadIdx.x >> 2);
    const int r = group_rank(keys, N, i, i < N) - first;
    if ((threadIdx.x & 3) != 0 || i >= N || r < 0 || r >= P) continue;
    const float px = row_of<float>(epx, b)[i], py = row_of<float>(epy, b)[i],
                z = row_of<float>(endz, b)[i];
    bool sv = g[i] != 0;
    if (set.depth != nullptr) sv = sv && !contained(set, b, px, py, z);
    int* o = rows + (static_cast<long long>(b) * P + r) * 12;
    seed_setup(cam, k, work_px(cam, px), work_px(cam, py), z, o);
    finish_row(cam, k, o);
    valid[static_cast<long long>(b) * P + r] = sv ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// K11: the pyramids of one inflation launch, merged into the set so far
// ---------------------------------------------------------------------------

struct f3 {
  float x, y, z;
};

// rappids.deproject
__device__ __forceinline__ f3 deproject(float focal, float cx, float cy, float px, float py,
                                        float d) {
  return f3{d * (px - cx) / focal, d * (py - cy) / focal, d * 1.0f};
}

// _pyramid_from_edges' unit_cross: cross(a, b) over its norm (1 below 1e-12)
__device__ __forceinline__ void unit_cross(f3 a, f3 b, float* n) {
  const float c0 = a.y * b.z - a.z * b.y, c1 = a.z * b.x - a.x * b.z, c2 = a.x * b.y - a.y * b.x;
  const float nrm = sqrtf(c0 * c0 + c1 * c1 + c2 * c2);
  const float d = nrm < 1e-12f ? 1.0f : nrm;
  n[0] = c0 / d;
  n[1] = c1 / d;
  n[2] = c2 / d;
}

// Block b: vehicle b. Shared (dynamic): the seeds' depth keys (P), the new
// set's n_new slots (depth, bounds, normals, valid) in depth order, then the
// merge's keys (C + n_new). Output slot r of (B, C) takes the element of
// rank r: of the new set alone (no base), or of [base, new] (a base set, or
// an empty one of capacity C).
__global__ void __launch_bounds__(kSetThreads)
    pyramid_set_kernel(const int* __restrict__ out, const unsigned char* __restrict__ seed_valid,
                       int P, SetArgs base, int empty_capacity, PlanCam cam,
                       float* __restrict__ depth_o, float* __restrict__ bounds_o,
                       float* __restrict__ normals_o, unsigned char* __restrict__ valid_o,
                       int n_new, int C) {
  extern __shared__ float sm[];
  float* dkey = sm;
  float* nd = dkey + P;
  float* nb = nd + n_new;
  float* nn = nb + 4 * n_new;
  float* nv = nn + 12 * n_new;
  float* mkey = nv + n_new;
  const int b = blockIdx.x;
  const float scale = *cam.depth_scale, pr = *cam.plan_radius;
  const int* rows = out + static_cast<long long>(b) * P * 8;
  const unsigned char* sv = seed_valid + static_cast<long long>(b) * P;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const int* o = rows + 8 * i;
    const bool ok = o[0] > 0 && sv[i] != 0;
    dkey[i] = ok ? static_cast<float>(o[1]) * scale - pr : INFINITY;
  }
  __syncthreads();
  const float focal = *cam.focal, cx = *cam.cx, cy = *cam.cy;
  const float kf = static_cast<float>(cam.k);
  for (int i0 = 0; i0 < P; i0 += blockDim.x / 4) {  // the same trips for every lane
    const int i = i0 + (threadIdx.x >> 2);
    const int r = group_rank(dkey, P, i, i < P);
    if ((threadIdx.x & 3) != 0 || i >= P || r >= n_new) continue;
    const int* o = rows + 8 * i;
    const float base_depth = static_cast<float>(o[1]) * scale - pr;
    const float er = static_cast<float>(o[2]), et = static_cast<float>(o[3]),
                el = static_cast<float>(o[4]), eb = static_cast<float>(o[5]);
    const f3 c0 = deproject(focal, cx, cy, er, et, base_depth);  // top right
    const f3 c1 = deproject(focal, cx, cy, el, et, base_depth);  // top left
    const f3 c2 = deproject(focal, cx, cy, el, eb, base_depth);  // bottom left
    const f3 c3 = deproject(focal, cx, cy, er, eb, base_depth);  // bottom right
    float* n = nn + 12 * r;
    unit_cross(c0, c1, n);
    unit_cross(c1, c2, n + 3);
    unit_cross(c2, c3, n + 6);
    unit_cross(c3, c0, n + 9);
    float* q = nb + 4 * r;
    q[0] = er;
    q[1] = et;
    q[2] = el;
    q[3] = eb;
    if (cam.k > 1)
      for (int j = 0; j < 4; ++j) q[j] = q[j] * kf;
    nd[r] = dkey[i];
    nv[r] = (o[0] > 0 && sv[i] != 0) ? 1.0f : 0.0f;
  }
  __syncthreads();
  const long long ob = static_cast<long long>(b) * C;
  const bool merge = base.depth != nullptr || empty_capacity > 0;
  if (!merge) {
    for (int r = threadIdx.x; r < n_new; r += blockDim.x) {
      depth_o[ob + r] = nd[r];
      for (int j = 0; j < 4; ++j) bounds_o[4 * (ob + r) + j] = nb[4 * r + j];
      for (int j = 0; j < 12; ++j) normals_o[12 * (ob + r) + j] = nn[12 * r + j];
      valid_o[ob + r] = nv[r] != 0.0f ? 1 : 0;
    }
    return;
  }
  const int M = C + n_new;
  for (int j = threadIdx.x; j < M; j += blockDim.x)
    mkey[j] = j < C ? (base.depth != nullptr ? base.depth[ob + j] : INFINITY) : nd[j - C];
  __syncthreads();
  for (int j0 = 0; j0 < M; j0 += blockDim.x / 4) {  // the same trips for every lane
    const int j = j0 + (threadIdx.x >> 2);
    const int r = group_rank(mkey, M, j, j < M);
    if ((threadIdx.x & 3) != 0 || j >= M || r >= C) continue;
    const long long d = ob + r;
    depth_o[d] = mkey[j];
    if (j >= C) {
      const int s = j - C;
      for (int t = 0; t < 4; ++t) bounds_o[4 * d + t] = nb[4 * s + t];
      for (int t = 0; t < 12; ++t) normals_o[12 * d + t] = nn[12 * s + t];
      valid_o[d] = nv[s] != 0.0f ? 1 : 0;
    } else if (base.depth != nullptr) {
      const long long s = ob + j;
      for (int t = 0; t < 4; ++t) bounds_o[4 * d + t] = base.bounds[4 * s + t];
      for (int t = 0; t < 12; ++t) normals_o[12 * d + t] = base.normals[12 * s + t];
      valid_o[d] = base.valid[s];
    } else {  // a slot of the empty set
      for (int t = 0; t < 4; ++t) bounds_o[4 * d + t] = 0.0f;
      for (int t = 0; t < 12; ++t) normals_o[12 * d + t] = 0.0f;
      valid_o[d] = 0;
    }
  }
}

// ---------------------------------------------------------------------------
// K12: a lazy round's seeds
// ---------------------------------------------------------------------------

// Block b: vehicle b. Shared: the N keys where(seedable, cost, inf) and
// seedable flags (dynamic), and the M = min(N, 4 per_round) considered fail
// points (static): their pixel, depth, validity and seed set-up on the work
// image. The prefilter reads the work image once with the whole block, each
// pixel tested against every valid considered point; the dedupe runs
// j = 0 ... M - 1 in order, a barrier each, as the plain loop does; then the
// kept points first.
__global__ void __launch_bounds__(kLazyThreads)
    lazy_seeds_kernel(Vec gate, Vec free_, Vec fpx, Vec fpy, Vec fz, Vec cost,
                      const int* __restrict__ img, const int* __restrict__ wimg, SetArgs set,
                      PlanCam cam, int W, int H, int N, int M, int S, int* __restrict__ rows,
                      unsigned char* __restrict__ valid, unsigned char* __restrict__ failed) {
  extern __shared__ float keys[];
  unsigned char* seedable = reinterpret_cast<unsigned char*>(keys + N);
  __shared__ float px_t[kMaxConsidered], py_t[kMaxConsidered], z_t[kMaxConsidered];
  __shared__ int setup[kMaxConsidered][8];
  __shared__ int keep[kMaxConsidered];
  const int b = blockIdx.x, tid = threadIdx.x;
  const float scale = *cam.depth_scale, pr = *cam.plan_radius;
  const SeedConsts k = seed_consts(cam);
  const unsigned char *g = row_of<unsigned char>(gate, b), *fr = row_of<unsigned char>(free_, b);
  const float *xs = row_of<float>(fpx, b), *ys = row_of<float>(fpy, b), *zs = row_of<float>(fz, b),
              *cs = row_of<float>(cost, b);
  const int* im = img + static_cast<long long>(b) * H * W;
  for (int i = tid; i < N; i += blockDim.x) {
    const bool f = g[i] && !fr[i] && zs[i] > 0.0f;
    failed[static_cast<long long>(b) * N + i] = f ? 1 : 0;
    // a fail point whose own pixel is blocked shallower than the required
    // pyramid depth can never inflate
    const int pxi = min(max(static_cast<int>(xs[i]), 0), W - 1);
    const int pyi = min(max(static_cast<int>(ys[i]), 0), H - 1);
    const int code = im[static_cast<long long>(pyi) * W + pxi];
    const int minpyr = static_cast<int>((zs[i] + scale + pr) / scale);
    const bool s = f && (code <= k.ignore || code >= minpyr);
    seedable[i] = s ? 1 : 0;
    keys[i] = s ? cs[i] : INFINITY;
  }
  __syncthreads();
  for (int i0 = 0; i0 < N; i0 += blockDim.x / 4) {  // the same trips for every lane
    const int i = i0 + (tid >> 2);
    const int m = group_rank(keys, N, i, i < N);
    if ((tid & 3) != 0 || i >= N || m >= M) continue;
    const float px = xs[i], py = ys[i], z = zs[i];
    px_t[m] = px;
    py_t[m] = py;
    z_t[m] = z;
    keep[m] = (seedable[i] && !contained(set, b, px, py, z)) ? 1 : 0;
    // one depth-code quantum deeper, so the floored pyramid base clears z
    seed_setup(cam, k, work_px(cam, px), work_px(cam, py), z + scale, setup[m]);
  }
  __syncthreads();

  // the prefilter: a blocker inside the initial rectangle or within shrink +
  // PIXEL_BUFFER of the seed on both axes dooms it. A thread reads each of
  // its pixels once, takes its shrink once and tests it against the valid
  // considered points it blocks (those deeper than the pixel: the live list
  // runs from the deepest min_pyr_depth down, so the test stops at the
  // first that is not), keeping the doomed ones in a bit mask; the masks
  // meet in shared memory.
  __shared__ int live[kMaxConsidered];
  __shared__ int n_live;
  __shared__ unsigned long long doomed[kMaxConsidered / 64];
  if (tid == 0) {
    int n = 0;
    for (int m = 0; m < M; ++m) {
      if (!keep[m]) continue;
      int at = n++;  // insertion by min_pyr_depth, descending
      for (; at > 0 && setup[live[at - 1]][2] < setup[m][2]; --at) live[at] = live[at - 1];
      live[at] = m;
    }
    n_live = n;
  }
  if (tid < kMaxConsidered / 64) doomed[tid] = 0ull;
  __syncthreads();
  const int Ww = cam.width, Hw = cam.height, L = n_live;
  const int* wim = wimg + static_cast<long long>(b) * Hw * Ww;
  unsigned long long mine[kMaxConsidered / 64] = {0ull, 0ull, 0ull, 0ull};
  const int deepest = L > 0 ? setup[live[0]][2] : 0;
  for (int q = tid; L > 0 && q < Hw * Ww; q += blockDim.x) {
    const int v = wim[q];
    if (!(v > k.ignore && v < deepest)) continue;  // blocks no valid point
    const int y = q / Ww, x = q - y * Ww;
    const long long reach =
        static_cast<long long>(wadd(floor_div(k.numer, max(v, 1)), cam.shrink_extra)) +
        kPixelBuffer;
    for (int l = 0; l < L; ++l) {
      const int* s = setup[live[l]];
      if (!(v < s[2])) break;  // not blocked for this point's depth, nor the rest's
      const bool in_rect = x >= s[3] && x <= s[4] && y >= s[5] && y <= s[6];
      const bool box = llabs(static_cast<long long>(x) - s[0]) <= reach &&
                       llabs(static_cast<long long>(y) - s[1]) <= reach;
      if (in_rect || box) mine[l >> 6] |= 1ull << (l & 63);
    }
  }
  for (int w = 0; w < kMaxConsidered / 64; ++w)
    if (mine[w]) atomicOr(&doomed[w], mine[w]);
  __syncthreads();
  if (tid < L && ((doomed[tid >> 6] >> (tid & 63)) & 1ull)) keep[live[tid]] = 0;
  __syncthreads();

  // the greedy dedupe, first kept wins: j drops later points close to it
  const float tol_z = kDedupeZQuanta * scale;
  for (int j = 0; j < M; ++j) {
    if (tid < M && tid > j && keep[j] && fabsf(px_t[j] - px_t[tid]) <= kDedupePx &&
        fabsf(py_t[j] - py_t[tid]) <= kDedupePx && fabsf(z_t[j] - z_t[tid]) <= tol_z)
      keep[tid] = 0;
    __syncthreads();
  }

  // the kept points first, each group in order; S rows
  if (tid < M) {
    int kept_before = 0, kept = 0;
    for (int m = 0; m < M; ++m) {
      kept += keep[m];
      if (m < tid) kept_before += keep[m];
    }
    const int slot = keep[tid] ? kept_before : kept + (tid - kept_before);
    if (slot < S) {
      int* o = rows + (static_cast<long long>(b) * S + slot) * 12;
      for (int t = 0; t < 8; ++t) o[t] = setup[tid][t];
      finish_row(cam, k, o);
      valid[static_cast<long long>(b) * S + slot] = keep[tid] ? 1 : 0;
    }
  }
}

cudaError_t smem_limit(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// gate (B, N) bool, cost / epx / epy / endz (B, N) float32 (Vec rows); set:
// the pyramid set so far (depth null in the first round); rows (B, P, 12)
// int32 and valid (B, P) bool out: candidates first ... first + P - 1 of the
// order. Returns the cudaError_t of the launch.
extern "C" int round_seeds_launch(Vec gate, Vec cost, Vec epx, Vec epy, Vec endz, SetArgs set,
                                  PlanCam cam, int B, int N, int first, int P, int* rows,
                                  unsigned char* valid, void* stream) {
  const size_t bytes = sizeof(float) * N;
  cudaError_t e = smem_limit(reinterpret_cast<const void*>(round_seeds_kernel), bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  round_seeds_kernel<<<B, kSeedThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      gate, cost, epx, epy, endz, set, cam, N, first, P, rows, valid);
  return static_cast<int>(cudaGetLastError());
}

// out (B, P, 8) int32 inflation rows, seed_valid (B, P) bool; base: a (B, C)
// set, or (depth null) an empty one of capacity empty_capacity > 0, or none
// (empty_capacity 0: C = n_new); the (B, C) set out. Returns the cudaError_t.
extern "C" int pyramid_set_launch(const int* out, const unsigned char* seed_valid, int B, int P,
                                  SetArgs base, int empty_capacity, PlanCam cam, float* depth,
                                  float* bounds, float* normals, unsigned char* valid, int n_new,
                                  int C, void* stream) {
  const size_t bytes = sizeof(float) * (P + 18 * n_new + C + n_new);
  cudaError_t e = smem_limit(reinterpret_cast<const void*>(pyramid_set_kernel), bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  pyramid_set_kernel<<<B, kSetThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      out, seed_valid, P, base, empty_capacity, cam, depth, bounds, normals, valid, n_new, C);
  return static_cast<int>(cudaGetLastError());
}

// gate, free (B, N) bool; fail_px / fail_py / fail_z / cost (B, N) float32;
// img (B, H, W) and the work image (B, cam.height, cam.width) int32; set:
// the pyramid set so far; rows (B, S, 12) int32, valid (B, S) bool and
// failed (B, N) bool out, S = min(N, 4 per_round, 2 per_round). Returns the
// cudaError_t of the launch.
extern "C" int lazy_seeds_launch(Vec gate, Vec free_, Vec fpx, Vec fpy, Vec fz, Vec cost,
                                 const int* img, const int* wimg, SetArgs set, PlanCam cam, int W,
                                 int H, int B, int N, int per_round, int* rows,
                                 unsigned char* valid, unsigned char* failed, void* stream) {
  const int M = min(N, 4 * per_round), S = min(M, 2 * per_round);
  if (M > kMaxConsidered) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = (sizeof(float) + 1) * N;
  cudaError_t e = smem_limit(reinterpret_cast<const void*>(lazy_seeds_kernel), bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  lazy_seeds_kernel<<<B, kLazyThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      gate, free_, fpx, fpy, fz, cost, img, wimg, set, cam, W, H, N, M, S, rows, valid, failed);
  return static_cast<int>(cudaGetLastError());
}
