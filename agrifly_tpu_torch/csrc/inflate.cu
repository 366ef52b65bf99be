// RAPPIDS pyramid inflation: one thread block per seed and image.
//
// Replaces the TPU kernel agrifly_tpu/planner/pallas_inflate.py (_kernel,
// launched by inflate_pyramids with one seed per program, and batched over a
// fleet's images by jax.vmap): the grid is (seeds, images), and block (p, b)
// inflates seed p of image b. It computes what
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
// What bounds it on the card: latency. For one vehicle a planning round
// inflates 10-20 seeds, so only 10-20 of the 132 SMs work (a fleet of 16
// fills the card with 160-320 blocks), each sweeping a 240x320 int32
// image (300 KB, resident in L2 after the first pass) about a dozen times
// with a barrier per reduction. The design spends 512 threads per seed to
// shorten each sweep; the TPU kernel's per-tile skip tables are not used.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBig = 1 << 20;
constexpr int kPixelBuffer = 2;
constexpr int kExpandRounds = 8;

struct Shared {
  int v[16][kWarps];
};

// Block-wide reduction of K values; bit k of min_mask selects min (else max).
template <int K>
__device__ void block_reduce(int (&v)[K], unsigned min_mask, Shared& sh) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    bool is_min = (min_mask >> k) & 1u;
    for (int off = 16; off > 0; off >>= 1) {
      int o = __shfl_xor_sync(0xffffffffu, v[k], off);
      v[k] = is_min ? min(v[k], o) : max(v[k], o);
    }
  }
  __syncthreads();  // the previous reduction's readers are done with sh
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) sh.v[k][warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    bool is_min = (min_mask >> k) & 1u;
    int r = sh.v[k][0];
    for (int w = 1; w < kWarps; ++w) r = is_min ? min(r, sh.v[k][w]) : max(r, sh.v[k][w]);
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

// Block (p, b) inflates seed p of image b. img: (B, H, W) int32; seeds:
// (B, P, 12) int32 [x0, y0, min_pyr_depth, l0, r0, t0, b0, ok0, edge_off,
// ignore, numer, shrink_extra]; out: (B, P, 8) int32 [ok, maxd, right, top,
// left, bottom, 0, 0].
__global__ void __launch_bounds__(kThreads)
inflate_kernel(const int* __restrict__ img_all, const int* __restrict__ seeds,
               int* __restrict__ out, int H, int W) {
  __shared__ Shared sh;
  const int* img = img_all + static_cast<int64_t>(blockIdx.y) * H * W;
  const int64_t row = static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x;
  const int* s = seeds + row * 12;
  const int x0 = s[0], y0 = s[1], minpyr = s[2];
  const int edge_off = s[8], ignore = s[9], numer = s[10], extra = s[11];
  int* o = out + row * 8;
  bool ok = s[7] != 0;

  auto finish = [&](bool good, int maxd, int rf, int tf, int lf, int bf) {
    if (threadIdx.x == 0) {
      o[0] = good ? 1 : 0;
      o[1] = maxd;
      o[2] = rf;
      o[3] = tf;
      o[4] = lf;
      o[5] = bf;
      o[6] = 0;
      o[7] = 0;
    }
  };
  auto blocked = [&](int p) { return p > ignore && p < minpyr; };

  // --- pass A: initial rectangle must be free ---
  int l = s[3], r = s[4], t = s[5], b = s[6];
  {
    int v[1] = {0};
    for_region(img, H, W, t, b, l, r, [&](int, int, int p) {
      if (blocked(p)) v[0] = 1;
    });
    block_reduce<1>(v, 0u, sh);
    ok = ok && v[0] == 0;
  }
  if (!ok) {
    finish(false, 0, r, t, l, b);
    return;
  }

  // --- max-sweep expansion ---
  for (int round = 0; round < kExpandRounds; ++round) {
    int v[2] = {kBig, -kBig};  // first blocked x right of r, last left of l
    for_region(img, H, W, t, b, 0, W - 1, [&](int x, int, int p) {
      if (!blocked(p)) return;
      if (x > r) v[0] = min(v[0], x);
      if (x < l) v[1] = max(v[1], x);
    });
    block_reduce<2>(v, 1u, sh);
    int r2 = max(r, min(v[0] - 1, W - 1 - edge_off));
    int l2 = min(l, max(v[1] + 1, edge_off));
    int w[2] = {kBig, -kBig};  // first blocked y below b, last above t
    for_region(img, H, W, 0, H - 1, l2, r2, [&](int, int y, int p) {
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

  // --- pass B: base depth ---
  int maxd;
  {
    int v[1] = {kBig};
    for_region(img, H, W, t, b, l, r, [&](int, int, int p) {
      if (p > ignore) v[0] = min(v[0], p);
    });
    block_reduce<1>(v, 1u, sh);
    maxd = min(v[0], 65535);
  }

  // --- pass C: edge bands ---
  const int r_init = W - 1 - edge_off, l_init = edge_off;
  const int t_init = edge_off, b_init = H - 1 - edge_off;
  auto shrink_of = [&](int p) { return numer / max(p, 1) + extra; };
  int a[16] = {kBig, -kBig, kBig, 0, -kBig, -kBig, kBig, 0,
               -kBig, -kBig, kBig, 0, kBig, -kBig, kBig, 0};
  for_region(img, H, W, 0, H - 1, 0, W - 1, [&](int x, int y, int p) {
    if (!(p > ignore && p < maxd)) return;
    int sp = shrink_of(p);
    int s_right = x - sp, s_left = x + sp, s_top = y + sp, s_bottom = y - sp;
    bool rows_tb = y >= t && y <= b, cols_lr = x >= l && x <= r;
    if (x >= r && rows_tb) band(a + 0, s_right, s_top, s_bottom, x0, y0, true, t_init, b_init);
    if (x <= l && rows_tb) band(a + 4, s_left, s_top, s_bottom, x0, y0, false, t_init, b_init);
    if (y <= t && cols_lr) band(a + 8, s_top, s_left, s_right, y0, x0, false, t_init, b_init);
    if (y >= b && cols_lr) band(a + 12, s_bottom, s_left, s_right, y0, x0, true, t_init, b_init);
  });
  // min: right edge/lo, left lo, top lo, bottom edge/lo
  block_reduce<16>(a, (1u << 0) | (1u << 2) | (1u << 6) | (1u << 10) | (1u << 12) | (1u << 14), sh);
  const int right_e = min(a[0], r_init), left_e = max(a[4], l_init);
  const int top_e = max(a[8], t_init), bot_e = min(a[12], b_init);
  ok = ok && !(a[3] || a[7] || a[11] || a[15]);
  int right_f = min(right_e, min(a[10], a[14]));
  int left_f = max(left_e, max(a[9], a[13]));
  int top_f = max(top_e, max(a[1], a[5]));
  int bottom_f = min(bot_e, min(a[2], a[6]));
  if (!ok) {
    finish(false, maxd, right_f, top_f, left_f, bottom_f);
    return;
  }

  // --- pass D: corners, in the plain version's order ---
  const int h_span = max(bottom_f - top_f, 1);
  const int w_span = max(right_f - left_f, 1);
  {  // top-right: right (min) & top (max)
    int v[3] = {kBig, -kBig, 0};
    for_region(img, H, W, 0, t, r, W - 1, [&](int x, int y, int p) {
      if (!(p > ignore && p < maxd)) return;
      int sp = shrink_of(p), s_right = x - sp, s_top = y + sp;
      if (s_right < right_f && s_top > top_f)
        corner(v, s_right, true, x0 < s_right - kPixelBuffer, s_top, false,
               y0 > s_top + kPixelBuffer, (right_f - s_right) * h_span,
               (s_top - top_f) * w_span);
    });
    block_reduce<3>(v, 1u, sh);
    right_f = min(right_f, v[0]);
    top_f = max(top_f, v[1]);
    ok = ok && !v[2];
  }
  {  // bottom-right: right (min) & bottom (min)
    int v[3] = {kBig, kBig, 0};
    for_region(img, H, W, b, H - 1, r, W - 1, [&](int x, int y, int p) {
      if (!(p > ignore && p < maxd)) return;
      int sp = shrink_of(p), s_right = x - sp, s_bottom = y - sp;
      if (s_right < right_f && s_bottom < bottom_f)
        corner(v, s_right, true, x0 < s_right - kPixelBuffer, s_bottom, true,
               y0 < s_bottom - kPixelBuffer, (right_f - s_right) * h_span,
               (bottom_f - s_bottom) * w_span);
    });
    block_reduce<3>(v, 3u, sh);
    right_f = min(right_f, v[0]);
    bottom_f = min(bottom_f, v[1]);
    ok = ok && !v[2];
  }
  {  // top-left: left (max) & top (max)
    int v[3] = {-kBig, -kBig, 0};
    for_region(img, H, W, 0, t, 0, l, [&](int x, int y, int p) {
      if (!(p > ignore && p < maxd)) return;
      int sp = shrink_of(p), s_left = x + sp, s_top = y + sp;
      if (s_left > left_f && s_top > top_f)
        corner(v, s_left, false, x0 > s_left + kPixelBuffer, s_top, false,
               y0 > s_top + kPixelBuffer, (s_left - left_f) * h_span,
               (s_top - top_f) * w_span);
    });
    block_reduce<3>(v, 0u, sh);
    left_f = max(left_f, v[0]);
    top_f = max(top_f, v[1]);
    ok = ok && !v[2];
  }
  {  // bottom-left: left (max) & bottom (min)
    int v[3] = {-kBig, kBig, 0};
    for_region(img, H, W, b, H - 1, 0, l, [&](int x, int y, int p) {
      if (!(p > ignore && p < maxd)) return;
      int sp = shrink_of(p), s_left = x + sp, s_bottom = y - sp;
      if (s_left > left_f && s_bottom < bottom_f)
        corner(v, s_left, false, x0 > s_left + kPixelBuffer, s_bottom, true,
               y0 < s_bottom - kPixelBuffer, (s_left - left_f) * h_span,
               (bottom_f - s_bottom) * w_span);
    });
    block_reduce<3>(v, 2u, sh);
    left_f = max(left_f, v[0]);
    bottom_f = min(bottom_f, v[1]);
    ok = ok && !v[2];
  }

  // final validity: seed strictly inside with buffer, non-degenerate
  ok = ok && (left_f + kPixelBuffer < right_f - kPixelBuffer);
  ok = ok && (top_f + kPixelBuffer < bottom_f - kPixelBuffer);
  ok = ok && (x0 > left_f + kPixelBuffer) && (x0 < right_f - kPixelBuffer);
  ok = ok && (y0 > top_f + kPixelBuffer) && (y0 < bottom_f - kPixelBuffer);
  finish(ok, maxd, right_f, top_f, left_f, bottom_f);
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
