// RAPPIDS pyramid inflation: one thread block per seed and image (K2), or
// per group of S seeds on one image (K2g).
//
// Replaces the TPU kernel agrifly_tpu/planner/pallas_inflate.py, launched by
// inflate_pyramids: _kernel with one seed per program (K2, batched over a
// fleet's images by jax.vmap) and _kernel_grouped with S seeds per program
// (K2g, seeds_per_program > 1). Both compute what
// agrifly_tpu_torch/planner/rappids.py::inflate_pyramid computes for one
// seed, in integers only, so ok, maxd and the four edges are bit-identical to
// the plain version for every seed that ends ok (the edges of a failed seed
// are unspecified; a seed stops as soon as it fails):
//   pass A  the initial rectangle must hold no blocker
//   expand  max-sweep rounds: push right/left to the nearest blocked column
//           within rows [t, b], then bottom/top within the new columns
//   pass B  base depth = min valid depth inside the expanded rectangle
//   pass C  edge-band shrinks, 4 bands x 4 accumulators
//   pass D  corner shrinks, one quadrant at a time, each seeing the edges the
//           previous corner left (the plain version's order)
// Each pass is a block-strided loop over the pixels of its region and a
// block-wide min/max reduction (warp shuffles, then one value per warp in
// shared memory), so every thread ends a pass holding the same scalars.
//
// K2: grid (P, B), block (p, b) inflates seed p of image b.
// K2g: grid (P/S, B), block (g, b) inflates seeds gS .. gS+S-1 of image b.
// Passes A, expand and B run one seed after another with K2's code. Pass C
// is one sweep of the image for all of the group's live seeds: each pixel is
// read and its shrink divided once, into 16 S accumulators and one
// reduction. Pass D keeps K2's corner order: one shared sweep per corner over
// the bounding box of the live seeds' quadrants, so each seed's corner sees
// the edges its previous corner left. A seed that fails leaves the shared
// sweeps; a group with no live seed ends. Unlike the TPU's grouped kernel,
// pass B never skips: it always takes the minimum over the rectangle.
//
// What bounds it on the card: latency. For one vehicle a planning round
// inflates 10-20 seeds, so only 10-20 of the 132 SMs work (a fleet of 16
// fills the card with 160-320 blocks), each sweeping a 240x320 int32
// image (300 KB, resident in L2 after the first pass) about a dozen times
// with a barrier per reduction. The design spends 512 threads per seed (K2)
// or group (K2g) to shorten each sweep. K2g trades parallel blocks for fewer
// image sweeps; measured on an NVIDIA H100 (PERF.md) that pays only where
// about a thousand seeds inflate on one 640x480 image, and loses at 128
// seeds and at the frame's 10-20, so the default is K2. The TPU kernel's
// per-tile skip tables are not used.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBig = 1 << 20;
constexpr int kPixelBuffer = 2;
constexpr int kExpandRounds = 8;
constexpr int kMaxGroup = 8;  // the largest compiled K2g instance (seeds per block)
constexpr int kBandValues = 16;  // pass C accumulators per seed
// min-reduced pass C accumulators: right edge/lo, left lo, top lo, bottom edge/lo
constexpr unsigned kBandMinMask =
    (1u << 0) | (1u << 2) | (1u << 6) | (1u << 10) | (1u << 12) | (1u << 14);

// Block-wide reduction of K values; value k is a min when bit k % Period of
// min_mask is set, else a max. sh has at least K rows.
template <int K, int Period = K>
__device__ void block_reduce(int (&v)[K], unsigned min_mask, int (*sh)[kWarps]) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    bool is_min = (min_mask >> (k % Period)) & 1u;
    for (int off = 16; off > 0; off >>= 1) {
      int o = __shfl_xor_sync(0xffffffffu, v[k], off);
      v[k] = is_min ? min(v[k], o) : max(v[k], o);
    }
  }
  __syncthreads();  // the previous reduction's readers are done with sh
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) sh[k][warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    bool is_min = (min_mask >> (k % Period)) & 1u;
    int r = sh[k][0];
    for (int w = 1; w < kWarps; ++w) r = is_min ? min(r, sh[k][w]) : max(r, sh[k][w]);
    v[k] = r;
  }
}

// Calls f(x, y, pixel) for every pixel of rows [ya, yb] x cols [xa, xb]
// (clipped to the image) this thread owns.
template <typename F>
__device__ void for_region(const int* img, int H, int W, int ya, int yb, int xa,
                           int xb, F f) {
  ya = max(ya, 0);
  yb = min(yb, H - 1);
  xa = max(xa, 0);
  xb = min(xb, W - 1);
  if (yb < ya || xb < xa) return;
  int w = xb - xa + 1;
  int n = (yb - ya + 1) * w;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    int y = ya + i / w;
    int x = xa + i % w;
    f(x, y, img[y * W + x]);
  }
}

// One image and the scalars every seed row of a launch shares.
struct Image {
  const int* img;
  int H, W, edge_off, ignore, numer, extra;
  __device__ int shrink(int p) const { return numer / max(p, 1) + extra; }
  // a pixel nearer than the base depth maxd (the shrink passes' pixels)
  __device__ bool relevant(int p, int maxd) const { return p > ignore && p < maxd; }
};

struct Rect {
  int l, r, t, b;
};

struct Edges {
  int r, t, l, b;  // right, top, left, bottom
};

// --- pass A: the initial rectangle must be free ---
__device__ bool pass_a(const Image& im, int minpyr, const Rect& q, int (*sh)[kWarps]) {
  int v[1] = {0};
  for_region(im.img, im.H, im.W, q.t, q.b, q.l, q.r, [&](int, int, int p) {
    if (p > im.ignore && p < minpyr) v[0] = 1;
  });
  block_reduce<1>(v, 0u, sh);
  return v[0] == 0;
}

// --- max-sweep expansion ---
__device__ void expand(const Image& im, int minpyr, Rect& q, int (*sh)[kWarps]) {
  const int H = im.H, W = im.W, edge_off = im.edge_off;
  auto blocked = [&](int p) { return p > im.ignore && p < minpyr; };
  int l = q.l, r = q.r, t = q.t, b = q.b;
  for (int round = 0; round < kExpandRounds; ++round) {
    int v[2] = {kBig, -kBig};  // first blocked x right of r, last left of l
    for_region(im.img, H, W, t, b, 0, W - 1, [&](int x, int, int p) {
      if (!blocked(p)) return;
      if (x > r) v[0] = min(v[0], x);
      if (x < l) v[1] = max(v[1], x);
    });
    block_reduce<2>(v, 1u, sh);
    int r2 = max(r, min(v[0] - 1, W - 1 - edge_off));
    int l2 = min(l, max(v[1] + 1, edge_off));
    int w[2] = {kBig, -kBig};  // first blocked y below b, last above t
    for_region(im.img, H, W, 0, H - 1, l2, r2, [&](int, int y, int p) {
      if (!blocked(p)) return;
      if (y > b) w[0] = min(w[0], y);
      if (y < t) w[1] = max(w[1], y);
    });
    block_reduce<2>(w, 1u, sh);
    int b2 = max(b, min(w[0] - 1, H - 1 - edge_off));
    int t2 = min(t, max(w[1] + 1, edge_off));
    bool changed = l2 != l || r2 != r || t2 != t || b2 != b;
    l = l2;
    r = r2;
    t = t2;
    b = b2;
    if (!changed) break;
  }
  q = Rect{l, r, t, b};
}

// --- pass B: base depth, the min valid depth inside the rectangle ---
__device__ int pass_b(const Image& im, const Rect& q, int (*sh)[kWarps]) {
  int v[1] = {kBig};
  for_region(im.img, im.H, im.W, q.t, q.b, q.l, q.r, [&](int, int, int p) {
    if (p > im.ignore) v[0] = min(v[0], p);
  });
  block_reduce<1>(v, 1u, sh);
  return min(v[0], 65535);
}

// --- pass C: edge bands ---

// One pixel's contribution to an edge band: a[0] edge, a[1] hi, a[2] lo,
// a[3] fail.
__device__ __forceinline__ void band(int* a, int primary, int alt_hi, int alt_lo,
                                     int seed_main, int seed_alt, bool is_min,
                                     int t_init, int b_init) {
  bool can_primary = is_min ? (seed_main < primary - kPixelBuffer)
                            : (seed_main > primary + kPixelBuffer);
  if (can_primary) {
    a[0] = is_min ? min(a[0], primary) : max(a[0], primary);
    return;
  }
  bool can_hi = seed_alt > alt_hi + kPixelBuffer;
  bool can_lo = seed_alt < alt_lo - kPixelBuffer;
  if (!can_hi && !can_lo) {
    a[3] = 1;
    return;
  }
  bool use_hi = can_hi, use_lo = can_lo;
  if (can_hi && can_lo) {  // both possible: the smaller loss vs the init edges
    bool lo_more = (b_init - alt_lo) > (alt_hi - t_init);
    use_hi = lo_more;
    use_lo = !lo_more;
  }
  if (use_hi) a[1] = max(a[1], alt_hi);
  if (use_lo) a[2] = min(a[2], alt_lo);
}

// One seed's 16 band accumulators before the sweep (the reductions' identities).
__device__ __forceinline__ void bands_init(int* a) {
  for (int k = 0; k < kBandValues; k += 4) {
    bool min_edge = k == 0 || k == 12;  // right and bottom edges are min-type
    a[k] = min_edge ? kBig : -kBig;
    a[k + 1] = -kBig;
    a[k + 2] = kBig;
    a[k + 3] = 0;
  }
}

// A relevant pixel (x, y) with shrink sp, for a seed at (x0, y0) with the
// expanded rectangle q.
__device__ __forceinline__ void bands_pixel(int* a, const Image& im, int x, int y, int sp,
                                            int x0, int y0, const Rect& q) {
  const int t_init = im.edge_off, b_init = im.H - 1 - im.edge_off;
  int s_right = x - sp, s_left = x + sp, s_top = y + sp, s_bottom = y - sp;
  bool rows_tb = y >= q.t && y <= q.b, cols_lr = x >= q.l && x <= q.r;
  if (x >= q.r && rows_tb) band(a + 0, s_right, s_top, s_bottom, x0, y0, true, t_init, b_init);
  if (x <= q.l && rows_tb) band(a + 4, s_left, s_top, s_bottom, x0, y0, false, t_init, b_init);
  if (y <= q.t && cols_lr) band(a + 8, s_top, s_left, s_right, y0, x0, false, t_init, b_init);
  if (y >= q.b && cols_lr) band(a + 12, s_bottom, s_left, s_right, y0, x0, true, t_init, b_init);
}

// The edges from one seed's reduced band accumulators; false when a band failed.
__device__ bool band_edges(const int* a, const Image& im, Edges& e) {
  const int r_init = im.W - 1 - im.edge_off, l_init = im.edge_off;
  const int t_init = im.edge_off, b_init = im.H - 1 - im.edge_off;
  const int right_e = min(a[0], r_init), left_e = max(a[4], l_init);
  const int top_e = max(a[8], t_init), bot_e = min(a[12], b_init);
  e.r = min(right_e, min(a[10], a[14]));
  e.l = max(left_e, max(a[9], a[13]));
  e.t = max(top_e, max(a[1], a[5]));
  e.b = min(bot_e, min(a[2], a[6]));
  return !(a[3] || a[7] || a[11] || a[15]);
}

// --- pass D: corners ---

// One corner pixel: v[0] edge a, v[1] edge b, v[2] both_bad.
__device__ __forceinline__ void corner(int* v, int s_a, bool a_is_min, bool a_seed_ok,
                                       int s_b, bool b_is_min, bool b_seed_ok,
                                       int a_loss, int b_loss) {
  if (!a_seed_ok && !b_seed_ok) v[2] = 1;
  bool use_a = a_seed_ok && (!b_seed_ok || b_loss > a_loss);
  bool use_b = b_seed_ok && !use_a;
  if (use_a) v[0] = a_is_min ? min(v[0], s_a) : max(v[0], s_a);
  if (use_b) v[1] = b_is_min ? min(v[1], s_b) : max(v[1], s_b);
}

// The quadrant right-or-left of the rectangle and above-or-below it: its
// horizontal edge (right: min-type, s = x - shrink; left: max-type,
// s = x + shrink) and its vertical edge (top: max-type, s = y + shrink;
// bottom: min-type, s = y - shrink).
template <bool Right, bool Top>
struct Corner {
  static constexpr unsigned kMinMask = (Right ? 1u : 0u) | (Top ? 0u : 2u);

  __device__ static void init(int* v) {
    v[0] = Right ? kBig : -kBig;
    v[1] = Top ? -kBig : kBig;
    v[2] = 0;
  }
  // rows [ya, yb] x cols [xa, xb] of the quadrant of rectangle q
  __device__ static void region(const Image& im, const Rect& q, int& ya, int& yb, int& xa,
                                int& xb) {
    ya = Top ? 0 : q.b;
    yb = Top ? q.t : im.H - 1;
    xa = Right ? q.r : 0;
    xb = Right ? im.W - 1 : q.l;
  }
  __device__ static bool contains(const Rect& q, int x, int y) {
    return (Top ? y <= q.t : y >= q.b) && (Right ? x >= q.r : x <= q.l);
  }
  __device__ static void pixel(int* v, int x, int y, int sp, int x0, int y0, const Edges& e,
                               int h_span, int w_span) {
    const int eh = Right ? e.r : e.l, ev = Top ? e.t : e.b;
    const int sa = Right ? x - sp : x + sp, sb = Top ? y + sp : y - sp;
    if ((Right ? sa < eh : sa > eh) && (Top ? sb > ev : sb < ev))
      corner(v, sa, Right, Right ? x0 < sa - kPixelBuffer : x0 > sa + kPixelBuffer, sb, !Top,
             Top ? y0 > sb + kPixelBuffer : y0 < sb - kPixelBuffer,
             (Right ? eh - sa : sa - eh) * h_span, (Top ? sb - ev : ev - sb) * w_span);
  }
  // the reduced corner applied to the edges; false when the corner failed
  __device__ static bool apply(const int* v, Edges& e) {
    if (Right) e.r = min(e.r, v[0]);
    else e.l = max(e.l, v[0]);
    if (Top) e.t = max(e.t, v[1]);
    else e.b = min(e.b, v[1]);
    return !v[2];
  }
};

// One seed's corner pass (K2).
template <bool Right, bool Top>
__device__ bool corner_pass(const Image& im, const Rect& q, int x0, int y0, int maxd, Edges& e,
                            int h_span, int w_span, int (*sh)[kWarps]) {
  using C = Corner<Right, Top>;
  int v[3];
  C::init(v);
  int ya, yb, xa, xb;
  C::region(im, q, ya, yb, xa, xb);
  for_region(im.img, im.H, im.W, ya, yb, xa, xb, [&](int x, int y, int p) {
    if (im.relevant(p, maxd)) C::pixel(v, x, y, im.shrink(p), x0, y0, e, h_span, w_span);
  });
  block_reduce<3>(v, C::kMinMask, sh);
  return C::apply(v, e);
}

// final validity: seed strictly inside with buffer, non-degenerate
__device__ bool final_ok(const Edges& e, int x0, int y0) {
  return (e.l + kPixelBuffer < e.r - kPixelBuffer) && (e.t + kPixelBuffer < e.b - kPixelBuffer) &&
         (x0 > e.l + kPixelBuffer) && (x0 < e.r - kPixelBuffer) &&
         (y0 > e.t + kPixelBuffer) && (y0 < e.b - kPixelBuffer);
}

__device__ void write_row(int* o, bool good, int maxd, const Edges& e) {
  o[0] = good ? 1 : 0;
  o[1] = maxd;
  o[2] = e.r;
  o[3] = e.t;
  o[4] = e.l;
  o[5] = e.b;
  o[6] = 0;
  o[7] = 0;
}

// Seed rows: [x0, y0, min_pyr_depth, l0, r0, t0, b0, ok0, edge_off, ignore,
// numer, shrink_extra]; the last four are equal on every row of a launch.
__device__ Image image_of(const int* img_all, const int* s, int H, int W) {
  return Image{img_all + static_cast<int64_t>(blockIdx.y) * H * W, H, W, s[8], s[9], s[10], s[11]};
}

// K2: block (p, b) inflates seed p of image b. img: (B, H, W) int32; seeds:
// (B, P, 12) int32; out: (B, P, 8) int32 [ok, maxd, right, top, left,
// bottom, 0, 0].
__global__ void __launch_bounds__(kThreads)
inflate_kernel(const int* __restrict__ img_all, const int* __restrict__ seeds,
               int* __restrict__ out, int H, int W) {
  __shared__ int sh[kBandValues][kWarps];
  const int64_t row = static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x;
  const int* s = seeds + row * 12;
  const Image im = image_of(img_all, s, H, W);
  const int x0 = s[0], y0 = s[1], minpyr = s[2];
  int* o = out + row * 8;
  auto finish = [&](bool good, int maxd, const Edges& e) {
    if (threadIdx.x == 0) write_row(o, good, maxd, e);
  };

  Rect q{s[3], s[4], s[5], s[6]};
  bool ok = s[7] != 0;
  ok = pass_a(im, minpyr, q, sh) && ok;
  if (!ok) {
    finish(false, 0, Edges{q.r, q.t, q.l, q.b});
    return;
  }
  expand(im, minpyr, q, sh);
  const int maxd = pass_b(im, q, sh);

  int a[kBandValues];
  bands_init(a);
  for_region(im.img, H, W, 0, H - 1, 0, W - 1, [&](int x, int y, int p) {
    if (im.relevant(p, maxd)) bands_pixel(a, im, x, y, im.shrink(p), x0, y0, q);
  });
  block_reduce<kBandValues>(a, kBandMinMask, sh);
  Edges e;
  ok = band_edges(a, im, e);
  if (!ok) {
    finish(false, maxd, e);
    return;
  }

  // corners, in the plain version's order
  const int h_span = max(e.b - e.t, 1), w_span = max(e.r - e.l, 1);
  bool c;
  c = corner_pass<true, true>(im, q, x0, y0, maxd, e, h_span, w_span, sh);
  ok = ok && c;
  c = corner_pass<true, false>(im, q, x0, y0, maxd, e, h_span, w_span, sh);
  ok = ok && c;
  c = corner_pass<false, true>(im, q, x0, y0, maxd, e, h_span, w_span, sh);
  ok = ok && c;
  c = corner_pass<false, false>(im, q, x0, y0, maxd, e, h_span, w_span, sh);
  ok = ok && c;
  finish(ok && final_ok(e, x0, y0), maxd, e);
}

// One seed of a K2g group, as the block's threads share it in shared memory
// (thread 0 writes it between barriers).
struct GroupSeed {
  int x0, y0, maxd, h_span, w_span;
  Rect q;
  Edges e;
  bool live;
};

// One shared corner sweep of a group (K2g): the live seeds' quadrants, in
// their bounding box; each pixel counts for the seeds whose quadrant holds it.
template <bool Right, bool Top, int S>
__device__ void group_corner(const Image& im, GroupSeed* gs, int (*sh)[kWarps]) {
  using C = Corner<Right, Top>;
  int ya = im.H, yb = -1, xa = im.W, xb = -1, maxd_hi = 0;
  for (int s = 0; s < S; ++s) {
    if (!gs[s].live) continue;
    int y0, y1, x0, x1;
    C::region(im, gs[s].q, y0, y1, x0, x1);
    ya = min(ya, y0);
    yb = max(yb, y1);
    xa = min(xa, x0);
    xb = max(xb, x1);
    maxd_hi = max(maxd_hi, gs[s].maxd);
  }
  int v[3 * S];
#pragma unroll
  for (int s = 0; s < S; ++s) C::init(v + 3 * s);
  for_region(im.img, im.H, im.W, ya, yb, xa, xb, [&](int x, int y, int p) {
    if (!im.relevant(p, maxd_hi)) return;
    const int sp = im.shrink(p);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const GroupSeed& g = gs[s];
      if (g.live && p < g.maxd && C::contains(g.q, x, y))
        C::pixel(v + 3 * s, x, y, sp, g.x0, g.y0, g.e, g.h_span, g.w_span);
    }
  });
  block_reduce<3 * S, 3>(v, C::kMinMask, sh);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (gs[s].live) gs[s].live = C::apply(v + 3 * s, gs[s].e);
  }
  __syncthreads();
}

__device__ bool any_live(const GroupSeed* gs, int S) {
  bool any = false;
  for (int s = 0; s < S; ++s) any = any || gs[s].live;
  return any;
}

// K2g: block (g, b) inflates seeds gS .. gS+S-1 of image b. img: (B, H, W)
// int32; seeds: (B, G S, 12) int32; out: (B, G S, 8) int32, as K2.
template <int S>
__global__ void __launch_bounds__(kThreads)
inflate_grouped_kernel(const int* __restrict__ img_all, const int* __restrict__ seeds,
                       int* __restrict__ out, int H, int W) {
  __shared__ int sh[kBandValues * S][kWarps];
  __shared__ GroupSeed gs[S];
  const int64_t row0 = (static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x) * S;
  const Image im = image_of(img_all, seeds + row0 * 12, H, W);

  // passes A, expand and B, one seed after another
  for (int s = 0; s < S; ++s) {
    const int* r = seeds + (row0 + s) * 12;
    Rect q{r[3], r[4], r[5], r[6]};
    bool ok = r[7] != 0;
    ok = ok && pass_a(im, r[2], q, sh);
    int maxd = 0;
    if (ok) {
      expand(im, r[2], q, sh);
      maxd = pass_b(im, q, sh);
    }
    if (threadIdx.x == 0)
      gs[s] = GroupSeed{r[0], r[1], maxd, 0, 0, q, Edges{q.r, q.t, q.l, q.b}, ok};
  }
  __syncthreads();

  if (any_live(gs, S)) {
    // pass C: one sweep for every live seed
    int a[kBandValues * S];
    int maxd_hi = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      bands_init(a + kBandValues * s);
      if (gs[s].live) maxd_hi = max(maxd_hi, gs[s].maxd);
    }
    for_region(im.img, H, W, 0, H - 1, 0, W - 1, [&](int x, int y, int p) {
      if (!im.relevant(p, maxd_hi)) return;
      const int sp = im.shrink(p);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const GroupSeed& g = gs[s];
        if (g.live && p < g.maxd) bands_pixel(a + kBandValues * s, im, x, y, sp, g.x0, g.y0, g.q);
      }
    });
    block_reduce<kBandValues * S, kBandValues>(a, kBandMinMask, sh);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        GroupSeed& g = gs[s];
        if (!g.live) continue;
        g.live = band_edges(a + kBandValues * s, im, g.e);
        g.h_span = max(g.e.b - g.e.t, 1);
        g.w_span = max(g.e.r - g.e.l, 1);
      }
    }
    __syncthreads();

    // pass D: the corners in K2's order, one shared sweep each
    if (any_live(gs, S)) {
      group_corner<true, true, S>(im, gs, sh);
      group_corner<true, false, S>(im, gs, sh);
      group_corner<false, true, S>(im, gs, sh);
      group_corner<false, false, S>(im, gs, sh);
    }
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      const GroupSeed& g = gs[s];
      write_row(out + (row0 + s) * 8, g.live && final_ok(g.e, g.x0, g.y0), g.maxd, g.e);
    }
  }
}

template <int S>
int launch_grouped(const int* img, const int* seeds, int* out, int B, int G, int H, int W,
                   cudaStream_t stream) {
  inflate_grouped_kernel<S><<<dim3(G, B), kThreads, 0, stream>>>(img, seeds, out, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// img: (B, H, W) int32; seeds: (B, P, 12) int32; out: (B, P, 8) int32.
// B, P >= 1; B <= 65535. One block per (seed, image): grid (P, B).
extern "C" int inflate_launch(const int* img, const int* seeds, int* out, int B, int P,
                              int H, int W, void* stream) {
  inflate_kernel<<<dim3(P, B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(img, seeds,
                                                                                out, H, W);
  return static_cast<int>(cudaGetLastError());
}

// The largest S inflate_grouped_launch takes.
extern "C" int inflate_max_group() { return kMaxGroup; }

// img: (B, H, W) int32; seeds: (B, G S, 12) int32 (a ragged P padded to G S
// with ok-cleared rows); out: (B, G S, 8) int32. 2 <= S <= kMaxGroup;
// B, G >= 1; B <= 65535. One block per group of S seeds and image: grid (G, B).
extern "C" int inflate_grouped_launch(const int* img, const int* seeds, int* out, int B, int G,
                                      int S, int H, int W, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 2: return launch_grouped<2>(img, seeds, out, B, G, H, W, st);
    case 3: return launch_grouped<3>(img, seeds, out, B, G, H, W, st);
    case 4: return launch_grouped<4>(img, seeds, out, B, G, H, W, st);
    case 5: return launch_grouped<5>(img, seeds, out, B, G, H, W, st);
    case 6: return launch_grouped<6>(img, seeds, out, B, G, H, W, st);
    case 7: return launch_grouped<7>(img, seeds, out, B, G, H, W, st);
    case 8: return launch_grouped<8>(img, seeds, out, B, G, H, W, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
