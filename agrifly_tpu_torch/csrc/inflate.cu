// RAPPIDS pyramid inflation: one thread block per seed and image (K2), a
// cluster of blocks per seed (K2c), or a cluster of S blocks per group of S
// seeds on one image (K2g).
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
// Each pass sweeps the pixels of its region and ends in a block-wide
// min/max reduction, so every thread ends a pass holding the same scalars.
//
// K2: grid (P, B), block (p, b) inflates seed p of image b.
// K2g: grid (P, B) in clusters of S blocks, cluster (g, b) inflates seeds
// gS .. gS+S-1 of image b. Block rank s runs seed gS+s's passes A, expand,
// B and C alone with K2's code, all the group's seeds in parallel (a grid of
// P blocks, as K2's), and publishes the seed to every block of the cluster
// through distributed shared memory. Pass D is split over the cluster by
// rows: of every live seed's quadrant block rank k sweeps, with K2's sweep,
// the groups of 16 rows k, k + S, k + 2S, ... counted from the quadrant's
// first row, so each quadrant's work spreads evenly over the S blocks. The
// block keeps each seed's warp partials in shared memory, and one combine
// per corner reduces the group's values over the cluster (a block and a
// cluster barrier), after which every block applies them to its own copy of
// the seeds. The corners keep K2's order, so each seed's corner sees the
// edges its previous corner left. A seed that fails (a padded row, ok
// cleared, fails at once) leaves the shared passes; a group with no live
// seed ends. The accumulators are K2's (16 a thread), so the kernel holds
// K2's registers whatever S. Unlike the TPU's grouped kernel, pass B never
// skips: it always takes the minimum over the rectangle. A cluster runs for
// its slowest seed's own passes: the others wait at the barrier that
// publishes the seeds. Measured on an H100, forms that split pass C over
// the cluster too were slower than this one, since a block that waits does
// no work: a slab of ceil(H / S) rows swept once for a chunk of seeds (each
// pixel read and its shrink looked up once for the chunk, which visits more
// pixels than the seeds' own bands hold and tests every seed at each), each
// seed's bands split by such slabs, and each seed's bands split by
// interleaved row groups as pass D is now. So was the first form, one block
// per group running passes A, expand and B one seed after another.
//
// What bounds it on the card: latency and issued instructions, not bytes.
// A planning round of one vehicle inflates 10-20 seeds, so 10-20 of the 132
// SMs work (a fleet of 16 fills the card with 160-320 blocks); each block
// sweeps a 240x320 int32 image (300 KB, from L2 and L1) several times, with
// a barrier per reduction. Clock64 timers on an H100 put most of a live
// seed's cycles in the per-pixel work of pass C, then the expansion, pass D
// and pass B. The design cuts the instructions per pixel and the pixels:
//   - a region is swept row by row: warp w takes rows w, w + 16, ...; its
//     lanes take 4 neighbouring pixels each with one 16-byte load (rows of a
//     width divisible by 4; else one pixel a lane), so no pixel pays an
//     integer division for its coordinates and neighbouring lanes read
//     neighbouring addresses;
//   - a pixel's shrink quotient numer / p comes from a table in shared
//     memory (numer / d for d < 4096, filled by the block once a seed has
//     passed pass A), not from an integer division;
//   - a reduction is one warp reduction instruction per value
//     (__reduce_min_sync / __reduce_max_sync), one store per warp, one
//     barrier, and one more warp reduction over the 16 warps' slots; the
//     slots alternate between two buffers, so no second barrier guards them;
//   - the expansion searches outward from each edge in chunks of growing
//     width (32 columns, 64, ...; 16 rows, 32, ...) up to the clamp the
//     expansion applies, and stops after the first chunk that holds a
//     blocker: a farther blocked line cannot be the nearest (the TPU
//     kernel's early-exit sweeps, pallas_inflate.py:25-31);
//   - pass C sweeps each edge band over its own region (rows [t, b] right of
//     r and left of l, cols [l, r] above t and below b, each with its edge
//     line) with that band's test alone, not the whole image with all four.
// Skipped pixels would contribute only the reductions' identities, so the
// results are unchanged. Staging the whole image in one block's shared
// memory (as 16-bit codes with an escape code for values past 65535, since a
// pooled 240x320 int32 image exceeds a block's 227 KB) was measured and made
// the launch slower; the TPU kernel's per-tile skip tables are not used.
//
// K2c, the cluster form of K2: a planning round of one vehicle leaves most
// SMs idle, so each seed gets a thread-block cluster of C blocks (2, 4 or 8;
// grid (P C, B)). Block rank k owns the k-th slab of ceil(H / C) rows and
// stages it in its shared memory as int32 with one bulk copy (TMA, completion
// on an mbarrier); every pass sweeps only the block's own slab. A reduction
// reduces each block's warps first, pushes the block's result into every
// block of the cluster (distributed shared memory), and after one cluster
// barrier reads the C results locally; the expansion's first chunks are C
// times wider, since each of its steps costs a cluster barrier. On an H100
// this beat K2 on one image with 10-20 seeds (C = 8; pooled 240x320 and
// 480x640) and lost on 160 seeds or more; pulling the 16 C warp partials
// from the other blocks instead made K2c no faster than K2. The caller picks
// C (cuda_inflate.py's cluster_size, from H x W and the grid); C = 1 is K2.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;  // the largest cluster K2c takes (the portable limit)
// the largest row slab a K2c block stages (cuda_inflate.py's MAX_SLAB_BYTES);
// with the block's other shared memory it stays under the card's 227 KB
constexpr int kMaxSlabBytes = 200 * 1024;
constexpr int kBig = 1 << 20;
constexpr int kPixelBuffer = 2;
constexpr int kExpandRounds = 8;
constexpr int kFirstChunkCols = 32;  // the expansion's first column chunk (K2; K2c: x C); each next is twice as wide
constexpr int kFirstChunkRows = 16;  // the same for rows
// the shrink passes' quotients numer / p for p < kShrinkTable, in shared
// memory (numer = focal * plan_radius / depth_scale: 712 on the pooled
// 240x320 frame, 1425 at 640x480)
constexpr int kShrinkTable = 4096;
constexpr int kMaxGroup = 8;  // the largest K2g group (seeds, and blocks of its cluster)
static_assert(kMaxGroup <= kMaxCluster, "a K2g group is one cluster");
constexpr int kBandValues = 16;  // pass C accumulators per seed
// min-reduced pass C accumulators: right edge/lo, left lo, top lo, bottom edge/lo
constexpr unsigned kBandMinMask =
    (1u << 0) | (1u << 2) | (1u << 6) | (1u << 10) | (1u << 12) | (1u << 14);

// The per-warp partials of the reductions: two buffers of `per_turn` rows in
// shared memory, used in turns (K2c: also the per-block results, `blocks`).
// A warp writes a buffer again only two reductions later, after a barrier
// that every warp (of the cluster, for K2c) reaches once it has read that
// buffer, so one barrier per reduction suffices (K2c: a block barrier and a
// cluster barrier).
struct Slots {
  int (*rows)[kWarps];
  int per_turn;
  int turn;
  int cluster;  // the blocks that share each reduction (1: the block alone)
  int (*blocks)[kMaxCluster];  // K2c: [turn * per_turn + k][rank], each block's result
};

// Block-wide (cluster-wide) reduction of K values; value k is a min when bit
// k % Period of min_mask is set, else a max. Every thread ends holding the K
// results.
template <int K, int Period = K>
__device__ void block_reduce(int (&v)[K], unsigned min_mask, Slots& sl) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int (*sh)[kWarps] = sl.rows + sl.turn * sl.per_turn;
  const int turn = sl.turn;
  sl.turn ^= 1;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool is_min = (min_mask >> (k % Period)) & 1u;
    v[k] = is_min ? __reduce_min_sync(0xffffffffu, v[k]) : __reduce_max_sync(0xffffffffu, v[k]);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) sh[k][warp] = v[k];
  }
  if (sl.cluster == 1) {  // K2, K2g
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool is_min = (min_mask >> (k % Period)) & 1u;
      const int w = sh[k][lane % kWarps];  // lanes past kWarps repeat a slot: min/max ignore repeats
      v[k] = is_min ? __reduce_min_sync(0xffffffffu, w) : __reduce_max_sync(0xffffffffu, w);
    }
    return;
  }
  // K2c (K <= kWarps): warp k reduces value k over the block's warps and
  // stores the block's result into slot [k][rank] of every block of the
  // cluster; after the cluster barrier each thread reduces the C block
  // results from its own shared memory. Few remote stores, no remote loads.
  __syncthreads();
  cg::cluster_group cluster = cg::this_cluster();
  const int C = sl.cluster, rank = static_cast<int>(cluster.block_rank());
  int (*bs)[kMaxCluster] = sl.blocks + turn * sl.per_turn;
  if (warp < K) {
    const bool is_min = (min_mask >> (warp % Period)) & 1u;
    const int w = sh[warp][lane % kWarps];
    const int r = is_min ? __reduce_min_sync(0xffffffffu, w) : __reduce_max_sync(0xffffffffu, w);
    if (lane < C) *cluster.map_shared_rank(&bs[warp][rank], lane) = r;
  }
  cluster.sync();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool is_min = (min_mask >> (k % Period)) & 1u;
    const int w = bs[k][lane % C];
    v[k] = is_min ? __reduce_min_sync(0xffffffffu, w) : __reduce_max_sync(0xffffffffu, w);
  }
}

// One image and the scalars every seed row of a launch shares.
struct Image {
  const int* px;  // rows y_lo .. y_hi, row y at px + (y - y_lo) * W
  int H, W, edge_off, ignore, numer, extra;
  int y_lo, y_hi;  // the rows this block sweeps: all (K2, K2g) or its slab (K2c)
  bool vec;  // every row starts on 16 bytes: four pixels per load
  bool staged;  // px is the block's shared-memory slab (K2c), not the image in device memory
  unsigned short* quot;  // quot[d] = numer / d for d < kShrinkTable (shrink_table)
  // of each region's rows, in groups of kWarps from its first row, this
  // block sweeps group part, part + parts, ... (K2g's blocks split every
  // region so; K2 and K2c sweep every group)
  int part = 0, parts = 1;
  __device__ const int* row(int y) const { return px + (y - y_lo) * W; }
  // the shrink distance of a pixel: numer / max(p, 1) + extra, the quotient
  // looked up where the table holds it (0 wherever d > numer >= 0)
  __device__ int shrink(int p) const {
    const int d = max(p, 1);
    const int q = d > numer ? 0 : (d < kShrinkTable ? quot[d] : numer / d);
    return (numer >= 0 ? q : numer / d) + extra;
  }
  // a pixel nearer than the base depth maxd (the shrink passes' pixels)
  __device__ bool relevant(int p, int maxd) const { return p > ignore && p < maxd; }
};

template <bool Staged, typename F>
__device__ __forceinline__ void sweep(const Image& im, int ya, int yb, int xa, int xb, F& f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (im.vec) {
    const int x_first = (xa & ~3) + 4 * lane;
    for (int y = ya + im.part * kWarps + warp; y <= yb; y += kWarps * im.parts) {
      const int* row = im.row(y);
      for (int x = x_first; x <= xb; x += 128) {
        const int4* at = reinterpret_cast<const int4*>(row + x);
        const int4 q = Staged ? *at : __ldg(at);
        const int px[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (x + j >= xa && x + j <= xb) f(x + j, y, px[j]);
      }
    }
  } else {
    for (int y = ya + im.part * kWarps + warp; y <= yb; y += kWarps * im.parts) {
      const int* row = im.row(y);
      for (int x = xa + lane; x <= xb; x += 32) f(x, y, Staged ? row[x] : __ldg(row + x));
    }
  }
}

// Calls f(x, y, pixel) for every pixel of rows [ya, yb] x cols [xa, xb]
// (clipped to the block's rows) this thread owns: warp w takes rows ya + w,
// ya + w + kWarps, ...; in a row, lane i takes the 4-pixel group i, i + 32,
// ... of the groups that meet [xa, xb] (or pixel i, i + 32, ... where rows
// are not 16-byte aligned).
template <typename F>
__device__ void for_region(const Image& im, int ya, int yb, int xa, int xb, F f) {
  ya = max(ya, im.y_lo);
  yb = min(yb, im.y_hi);
  xa = max(xa, 0);
  xb = min(xb, im.W - 1);
  if (yb < ya || xb < xa) return;
  if (im.staged) sweep<true>(im, ya, yb, xa, xb, f);
  else sweep<false>(im, ya, yb, xa, xb, f);
}

struct Rect {
  int l, r, t, b;
};

struct Edges {
  int r, t, l, b;  // right, top, left, bottom
};

// --- pass A: the initial rectangle must be free ---
__device__ bool pass_a(const Image& im, int minpyr, const Rect& q, Slots& sl) {
  int v[1] = {0};
  for_region(im, q.t, q.b, q.l, q.r, [&](int, int, int p) {
    if (p > im.ignore && p < minpyr) v[0] = 1;
  });
  block_reduce<1>(v, 0u, sl);
  return v[0] == 0;
}

// --- max-sweep expansion ---
//
// A round pushes r to the column before the first blocked one right of it
// within rows [t, b] (at most to W - 1 - edge_off, where the plain version
// clamps it), l likewise leftward (at least to edge_off), then b and t the
// same way within the new columns. Each search walks outward in chunks of
// doubling width and stops after the first chunk that holds a blocker, whose
// minimum (maximum) is then the nearest blocked line. K2c's first chunks are
// C times wider: its pixels spread over C blocks, and each step costs a
// cluster barrier.
__device__ void expand(const Image& im, int minpyr, Rect& q, Slots& sl) {
  const int H = im.H, W = im.W, eo = im.edge_off;
  const int x_hi = W - 1 - eo, y_hi = H - 1 - eo;
  auto blocked = [&](int p) { return p > im.ignore && p < minpyr; };
  int l = q.l, r = q.r, t = q.t, b = q.b;
  for (int round = 0; round < kExpandRounds; ++round) {
    int hit[2] = {kBig, -kBig};  // first blocked x right of r, last left of l
    for (int n = kFirstChunkCols * sl.cluster, xr = r + 1, xl = l - 1;; xr += n, xl -= n, n *= 2) {
      const bool go_r = hit[0] == kBig && xr <= x_hi, go_l = hit[1] == -kBig && xl >= eo;
      if (!go_r && !go_l) break;
      int v[2] = {kBig, -kBig};
      if (go_r)
        for_region(im, t, b, xr, min(xr + n - 1, x_hi), [&](int x, int, int p) {
          if (blocked(p)) v[0] = min(v[0], x);
        });
      if (go_l)
        for_region(im, t, b, max(xl - n + 1, eo), xl, [&](int x, int, int p) {
          if (blocked(p)) v[1] = max(v[1], x);
        });
      block_reduce<2>(v, 1u, sl);
      hit[0] = min(hit[0], v[0]);
      hit[1] = max(hit[1], v[1]);
    }
    const int r2 = max(r, hit[0] != kBig ? hit[0] - 1 : x_hi);
    const int l2 = min(l, hit[1] != -kBig ? hit[1] + 1 : eo);
    int hit_y[2] = {kBig, -kBig};  // first blocked y below b, last above t
    for (int n = kFirstChunkRows * sl.cluster, yb = b + 1, yt = t - 1;; yb += n, yt -= n, n *= 2) {
      const bool go_b = hit_y[0] == kBig && yb <= y_hi, go_t = hit_y[1] == -kBig && yt >= eo;
      if (!go_b && !go_t) break;
      int v[2] = {kBig, -kBig};
      if (go_b)
        for_region(im, yb, min(yb + n - 1, y_hi), l2, r2, [&](int, int y, int p) {
          if (blocked(p)) v[0] = min(v[0], y);
        });
      if (go_t)
        for_region(im, max(yt - n + 1, eo), yt, l2, r2, [&](int, int y, int p) {
          if (blocked(p)) v[1] = max(v[1], y);
        });
      block_reduce<2>(v, 1u, sl);
      hit_y[0] = min(hit_y[0], v[0]);
      hit_y[1] = max(hit_y[1], v[1]);
    }
    const int b2 = max(b, hit_y[0] != kBig ? hit_y[0] - 1 : y_hi);
    const int t2 = min(t, hit_y[1] != -kBig ? hit_y[1] + 1 : eo);
    const bool changed = l2 != l || r2 != r || t2 != t || b2 != b;
    l = l2;
    r = r2;
    t = t2;
    b = b2;
    if (!changed) break;
  }
  q = Rect{l, r, t, b};
}

// --- pass B: base depth, the min valid depth inside the rectangle ---
__device__ int pass_b(const Image& im, const Rect& q, Slots& sl) {
  int v[1] = {kBig};
  for_region(im, q.t, q.b, q.l, q.r, [&](int, int, int p) {
    if (p > im.ignore) v[0] = min(v[0], p);
  });
  block_reduce<1>(v, 1u, sl);
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

// Pass C's sweep for a seed at (x0, y0) with the expanded rectangle q and
// base depth maxd: each band over its own region (rows [t, b] right of r and
// left of l, cols [l, r] above t and below b, each with its edge line) with
// that band's test alone, clipped to the block's rows; into a[16].
__device__ __forceinline__ void bands_sweep(const Image& im, const Rect& q, int maxd, int x0,
                                            int y0, int* a) {
  const int H = im.H, W = im.W;
  const int t_init = im.edge_off, b_init = H - 1 - im.edge_off;
  bands_init(a);
  for_region(im, q.t, q.b, q.r, W - 1, [&](int x, int y, int p) {  // right
    if (!im.relevant(p, maxd)) return;
    const int sp = im.shrink(p);
    band(a + 0, x - sp, y + sp, y - sp, x0, y0, true, t_init, b_init);
  });
  for_region(im, q.t, q.b, 0, q.l, [&](int x, int y, int p) {  // left
    if (!im.relevant(p, maxd)) return;
    const int sp = im.shrink(p);
    band(a + 4, x + sp, y + sp, y - sp, x0, y0, false, t_init, b_init);
  });
  for_region(im, 0, q.t, q.l, q.r, [&](int x, int y, int p) {  // top
    if (!im.relevant(p, maxd)) return;
    const int sp = im.shrink(p);
    band(a + 8, y + sp, x + sp, x - sp, y0, x0, false, t_init, b_init);
  });
  for_region(im, q.b, H - 1, q.l, q.r, [&](int x, int y, int p) {  // bottom
    if (!im.relevant(p, maxd)) return;
    const int sp = im.shrink(p);
    band(a + 12, y - sp, x + sp, x - sp, y0, x0, true, t_init, b_init);
  });
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

// One seed's corner sweep over its quadrant (clipped to the block's rows)
// into v[3].
template <bool Right, bool Top>
__device__ void corner_sweep(const Image& im, const Rect& q, int x0, int y0, int maxd,
                             const Edges& e, int h_span, int w_span, int* v) {
  using C = Corner<Right, Top>;
  C::init(v);
  int ya, yb, xa, xb;
  C::region(im, q, ya, yb, xa, xb);
  for_region(im, ya, yb, xa, xb, [&](int x, int y, int p) {
    if (im.relevant(p, maxd)) C::pixel(v, x, y, im.shrink(p), x0, y0, e, h_span, w_span);
  });
}

// One seed's corner pass (K2, K2c).
template <bool Right, bool Top>
__device__ bool corner_pass(const Image& im, const Rect& q, int x0, int y0, int maxd, Edges& e,
                            int h_span, int w_span, Slots& sl) {
  using C = Corner<Right, Top>;
  int v[3];
  corner_sweep<Right, Top>(im, q, x0, y0, maxd, e, h_span, w_span, v);
  block_reduce<3>(v, C::kMinMask, sl);
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
// quot: the block's shrink table (shrink_table fills it).
__device__ const int* image_at(const int* img_all, int H, int W) {
  return img_all + static_cast<int64_t>(blockIdx.y) * H * W;
}

__device__ bool rows_aligned(const int* img, int W) {
  return W % 4 == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0;
}

__device__ Image image_of(const int* img_all, const int* s, int H, int W,
                          unsigned short* quot) {
  const int* img = image_at(img_all, H, W);
  return Image{img, H, W, s[8], s[9], s[10], s[11], 0, H - 1, rows_aligned(img, W), false, quot};
}

// quot[d] = numer / d for 1 <= d < kShrinkTable (the block's threads
// together; the caller's next barrier publishes it).
__device__ void shrink_table(unsigned short* quot, int numer) {
  for (int d = 1 + threadIdx.x; d < kShrinkTable && d <= numer; d += kThreads)
    quot[d] = static_cast<unsigned short>(numer / d);
}

// One seed (row s) on the image im, by one block (K2) or one cluster (K2c,
// each block over its own rows); thread 0 of `writer` writes the output row o.
__device__ void inflate_seed(const Image& im, const int* s, int* o, bool writer, Slots& sl) {
  const int H = im.H, W = im.W;
  const int x0 = s[0], y0 = s[1], minpyr = s[2];
  auto finish = [&](bool good, int maxd, const Edges& e) {
    if (writer && threadIdx.x == 0) write_row(o, good, maxd, e);
  };

  Rect q{s[3], s[4], s[5], s[6]};
  bool ok = s[7] != 0;
  ok = pass_a(im, minpyr, q, sl) && ok;
  if (!ok) {
    finish(false, 0, Edges{q.r, q.t, q.l, q.b});
    return;
  }
  shrink_table(im.quot, im.numer);  // published by expand's first barrier
  expand(im, minpyr, q, sl);
  const int maxd = pass_b(im, q, sl);

  // pass C: each band over its own region, then one reduction
  int a[kBandValues];
  bands_sweep(im, q, maxd, x0, y0, a);
  block_reduce<kBandValues>(a, kBandMinMask, sl);
  Edges e;
  ok = band_edges(a, im, e);
  if (!ok) {
    finish(false, maxd, e);
    return;
  }

  // corners, in the plain version's order
  const int h_span = max(e.b - e.t, 1), w_span = max(e.r - e.l, 1);
  bool c;
  c = corner_pass<true, true>(im, q, x0, y0, maxd, e, h_span, w_span, sl);
  ok = ok && c;
  c = corner_pass<true, false>(im, q, x0, y0, maxd, e, h_span, w_span, sl);
  ok = ok && c;
  c = corner_pass<false, true>(im, q, x0, y0, maxd, e, h_span, w_span, sl);
  ok = ok && c;
  c = corner_pass<false, false>(im, q, x0, y0, maxd, e, h_span, w_span, sl);
  ok = ok && c;
  finish(ok && final_ok(e, x0, y0), maxd, e);
}

// K2: block (p, b) inflates seed p of image b. img: (B, H, W) int32; seeds:
// (B, P, 12) int32; out: (B, P, 8) int32 [ok, maxd, right, top, left,
// bottom, 0, 0].
__global__ void __launch_bounds__(kThreads)
inflate_kernel(const int* __restrict__ img_all, const int* __restrict__ seeds,
               int* __restrict__ out, int H, int W) {
  __shared__ int sh[2 * kBandValues][kWarps];
  __shared__ unsigned short quot[kShrinkTable];
  Slots sl{sh, kBandValues, 0, 1, nullptr};
  const int64_t row = static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x;
  const int* s = seeds + row * 12;
  inflate_seed(image_of(img_all, s, H, W, quot), s, out + row * 8, true, sl);
}

// --- K2c: a cluster per seed ---

// The shared memory of a K2c block: its row slab, then the mbarrier of the
// slab's bulk copy, the warp slots, the shrink table and the block slots.
struct ClusterSmem {
  int slab_bytes;  // rows * W * 4, rounded up to 16
  __host__ __device__ static int slab_rows(int H, int C) { return (H + C - 1) / C; }
  __host__ __device__ ClusterSmem(int H, int W, int C)
      : slab_bytes((slab_rows(H, C) * W * 4 + 15) / 16 * 16) {}
  __host__ __device__ int bar() const { return slab_bytes; }
  __host__ __device__ int slots() const { return slab_bytes + 16; }
  __host__ __device__ int quot() const { return slots() + 2 * kBandValues * kWarps * 4; }
  __host__ __device__ int blocks() const { return quot() + kShrinkTable * 2; }
  __host__ __device__ int bytes() const { return blocks() + 2 * kBandValues * kMaxCluster * 4; }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// rows [y_lo, y_lo + n) of img into the slab: one bulk copy (TMA) issued by
// thread 0 and awaited on an mbarrier where the rows are 16-byte aligned,
// else the block's plain loads; the block's threads see the slab on return.
__device__ void stage_rows(int* slab, const int* img, int W, int y_lo, int n, bool aligned,
                           uint64_t* bar) {
  const int count = n * W;
  if (count <= 0) return;
  if (!aligned) {
    for (int i = threadIdx.x; i < count; i += kThreads) slab[i] = __ldg(img + y_lo * W + i);
    __syncthreads();
    return;
  }
  const uint32_t b = smem_addr(bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b),
                 "r"(count * 4)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];" ::"r"(smem_addr(slab)),
        "l"(img + y_lo * W), "r"(count * 4), "r"(b)
        : "memory");
  }
  __syncthreads();  // the mbarrier is initialised before anyone waits on it
  asm volatile(
      "{\n\t.reg .pred done;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n\t"
      "@!done bra LAB_WAIT;\n\t}" ::"r"(b)
      : "memory");
}

// K2c: cluster (p, b) of C blocks (grid (P C, B)) inflates seed p of image
// b; block rank k stages and sweeps rows [k R, (k + 1) R) with R =
// ceil(H / C). Same arguments and output as K2.
__global__ void __launch_bounds__(kThreads)
inflate_cluster_kernel(const int* __restrict__ img_all, const int* __restrict__ seeds,
                       int* __restrict__ out, int H, int W, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ClusterSmem lay(H, W, C);
  const int rank = blockIdx.x % C;
  const int64_t row = static_cast<int64_t>(blockIdx.y) * (gridDim.x / C) + blockIdx.x / C;
  const int* s = seeds + row * 12;
  const int* img = image_at(img_all, H, W);
  const int rows = ClusterSmem::slab_rows(H, C);
  const int y_lo = rank * rows, y_hi = min(H, y_lo + rows) - 1;
  int* slab = reinterpret_cast<int*>(smem);
  const bool aligned = rows_aligned(img, W);
  stage_rows(slab, img, W, y_lo, y_hi - y_lo + 1, aligned,
             reinterpret_cast<uint64_t*>(smem + lay.bar()));
  unsigned short* quot = reinterpret_cast<unsigned short*>(smem + lay.quot());
  Slots sl{reinterpret_cast<int(*)[kWarps]>(smem + lay.slots()), kBandValues, 0, C,
           reinterpret_cast<int(*)[kMaxCluster]>(smem + lay.blocks())};
  const Image im{slab, H, W, s[8], s[9], s[10], s[11], y_lo, y_hi, aligned, true, quot};
  inflate_seed(im, s, out + row * 8, rank == 0, sl);
  cg::this_cluster().sync();  // no block leaves while another may read its slots
}

// --- K2g: a cluster of S blocks per group of S seeds ---

// One seed of a K2g group, as every block of the cluster holds it: block
// rank s publishes seed s's after its passes A, expand, B and C; the shared
// corners then update every block's copy alike, from the same combined values.
struct GroupSeed {
  int x0, y0, maxd, h_span, w_span;
  Rect q;
  Edges e;
  bool live;
};

// The dynamic shared memory of a K2g block (the cluster's blocks map one
// another's at the same offsets): the warp slots (the own passes' reductions
// in two turns of 16 values, a corner's kGroupValues partials), the blocks'
// results of a combine in two turns, the combined values, the shrink table
// and the group's seeds.
struct GroupSmem {
  static constexpr int kGroupValues = 3 * kMaxGroup;  // a corner of every seed
  static constexpr int kRows = 2 * kBandValues > kGroupValues ? 2 * kBandValues : kGroupValues;
  __host__ __device__ static constexpr int rows() { return 0; }
  __host__ __device__ static constexpr int blocks() { return kRows * kWarps * 4; }
  __host__ __device__ static constexpr int combined() {
    return blocks() + 2 * kGroupValues * kMaxCluster * 4;
  }
  __host__ __device__ static constexpr int quot() { return combined() + kGroupValues * 4; }
  __host__ __device__ static constexpr int seeds() { return quot() + kShrinkTable * 2; }
  __host__ __device__ static constexpr int bytes() {
    return seeds() + kMaxGroup * static_cast<int>(sizeof(GroupSeed));
  }
};

struct GroupSlots {
  int (*rows)[kWarps];  // [value][warp]: this block's warp partials
  int (*blocks)[kMaxCluster];  // [turn * kGroupValues + value][rank]: the blocks' results
  int* out;  // [value]: the combined values
  int turn;
};

// This warp's reduction of each of the K values into rows[k][warp]: a min
// where bit k % Period of min_mask is set, else a max.
template <int K, int Period = K>
__device__ __forceinline__ void warp_partials(const int* v, unsigned min_mask,
                                              int (*rows)[kWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool is_min = (min_mask >> (k % Period)) & 1u;
    const int r = is_min ? __reduce_min_sync(0xffffffffu, v[k])
                         : __reduce_max_sync(0xffffffffu, v[k]);
    if (lane == 0) rows[k][warp] = r;
  }
}

// Cluster-wide reduction of the n values whose warp partials are in
// sl.rows (value k a min where bit k % period of min_mask is set): warp w
// reduces values w, w + kWarps, ... over the block's warps and stores each
// into slot [k][rank] of every block of the cluster; after the cluster
// barrier it reduces the C blocks' results from its own shared memory into
// sl.out. The block slots alternate between two turns: a block can run at
// most one combine ahead of another, whose next cluster barrier holds it.
__device__ void cluster_combine(GroupSlots& sl, int n, int period, unsigned min_mask, int C) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  int (*bs)[kMaxCluster] = sl.blocks + sl.turn * GroupSmem::kGroupValues;
  sl.turn ^= 1;
  __syncthreads();  // the partials are in
  for (int k = warp; k < n; k += kWarps) {
    const bool is_min = (min_mask >> (k % period)) & 1u;
    const int w = sl.rows[k][lane % kWarps];
    const int r = is_min ? __reduce_min_sync(0xffffffffu, w) : __reduce_max_sync(0xffffffffu, w);
    if (lane < C) *cluster.map_shared_rank(&bs[k][rank], lane) = r;
  }
  cluster.sync();  // every block's results are in; the partials are read
  for (int k = warp; k < n; k += kWarps) {
    const bool is_min = (min_mask >> (k % period)) & 1u;
    const int w = bs[k][lane % C];
    const int r = is_min ? __reduce_min_sync(0xffffffffu, w) : __reduce_max_sync(0xffffffffu, w);
    if (lane == 0) sl.out[k] = r;
  }
  __syncthreads();
}

__device__ bool any_live(const GroupSeed* gs, int S) {
  bool any = false;
  for (int s = 0; s < S; ++s) any = any || gs[s].live;
  return any;
}

// One corner of the group (pass D): the block sweeps its share (im.part of
// im.parts) of each live seed's quadrant (K2's sweep); the seeds' warp
// partials are combined over the cluster at once, and every block applies
// the edges.
template <bool Right, bool Top>
__device__ void group_corner(const Image& im, GroupSeed* gs, int S, GroupSlots& sl) {
  using C = Corner<Right, Top>;
  for (int s = 0; s < S; ++s) {
    const GroupSeed& g = gs[s];
    if (!g.live) continue;
    int v[3];
    corner_sweep<Right, Top>(im, g.q, g.x0, g.y0, g.maxd, g.e, g.h_span, g.w_span, v);
    warp_partials<3>(v, C::kMinMask, sl.rows + 3 * s);
  }
  cluster_combine(sl, 3 * S, 3, C::kMinMask, S);
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s)
      if (gs[s].live) gs[s].live = C::apply(sl.out + 3 * s, gs[s].e);
  }
  __syncthreads();
}

// K2g: cluster (g, b) of S blocks (grid (G S, B)) inflates seeds gS ..
// gS+S-1 of image b. Block rank s runs seed gS+s's passes A, expand, B and
// C alone over the whole image (K2's functions), then publishes it to every
// block of the cluster; pass D is split over the cluster, block rank k
// sweeping the row groups k, k + S, ... of every live seed's quadrants, each
// corner combined over the cluster once. Rank s writes seed gS+s's row.
// img: (B, H, W) int32; seeds: (B, G S, 12) int32; out: (B, G S, 8) int32,
// as K2.
// No minimum of blocks a SM in the bound: ptxas then takes 40 registers,
// spilling five of the expansion's scalars, and three blocks fit a SM. With
// __launch_bounds__(kThreads, 2) it took 59 and spilled nothing, and the
// launch ran slower on an H100 at 1024 seeds (two blocks a SM).
__global__ void __launch_bounds__(kThreads)
inflate_grouped_kernel(const int* __restrict__ img_all, const int* __restrict__ seeds,
                       int* __restrict__ out, int H, int W, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t row0 = (static_cast<int64_t>(blockIdx.y) * (gridDim.x / S) + blockIdx.x / S) * S;
  const int* s = seeds + (row0 + rank) * 12;
  unsigned short* quot = reinterpret_cast<unsigned short*>(smem + GroupSmem::quot());
  GroupSeed* gs = reinterpret_cast<GroupSeed*>(smem + GroupSmem::seeds());
  int (*rows)[kWarps] = reinterpret_cast<int(*)[kWarps]>(smem + GroupSmem::rows());
  const Image whole = image_of(img_all, s, H, W, quot);
  shrink_table(quot, whole.numer);
  // publishes the table, and every block of the cluster runs before any
  // block writes to another's shared memory
  cluster.sync();

  // passes A, expand, B and C of seed rank, this block alone (K2's code);
  // a padded row (ok cleared) fails at once
  Slots own{rows, kBandValues, 0, 1, nullptr};
  Rect q{s[3], s[4], s[5], s[6]};
  GroupSeed mine{s[0], s[1], 0, 0, 0, q, Edges{q.r, q.t, q.l, q.b}, s[7] != 0};
  mine.live = mine.live && pass_a(whole, s[2], q, own);
  if (mine.live) {
    expand(whole, s[2], mine.q, own);
    mine.maxd = pass_b(whole, mine.q, own);
    int a[kBandValues];
    bands_sweep(whole, mine.q, mine.maxd, mine.x0, mine.y0, a);
    block_reduce<kBandValues>(a, kBandMinMask, own);
    mine.live = band_edges(a, whole, mine.e);
    mine.h_span = max(mine.e.b - mine.e.t, 1);
    mine.w_span = max(mine.e.r - mine.e.l, 1);
  }
  if (threadIdx.x < S) *cluster.map_shared_rank(&gs[rank], static_cast<int>(threadIdx.x)) = mine;
  cluster.sync();

  // pass D, split over the cluster: the corners in K2's order, each seed's
  // corner seeing the edges its previous corner left
  if (any_live(gs, S)) {  // a group with no live seed ends
    Image split = whole;  // this block's share of every region's rows
    split.part = rank;
    split.parts = S;
    GroupSlots sl{rows, reinterpret_cast<int(*)[kMaxCluster]>(smem + GroupSmem::blocks()),
                  reinterpret_cast<int*>(smem + GroupSmem::combined()), 0};
    group_corner<true, true>(split, gs, S, sl);
    group_corner<true, false>(split, gs, S, sl);
    group_corner<false, true>(split, gs, S, sl);
    group_corner<false, false>(split, gs, S, sl);
  }

  if (threadIdx.x == 0) {
    const GroupSeed& g = gs[rank];
    write_row(out + (row0 + rank) * 8, g.live && final_ok(g.e, g.x0, g.y0), g.maxd, g.e);
  }
  // every store into another block's shared memory came before a cluster
  // barrier that block waited at too, so a block may leave now
}

}  // namespace

// img: (B, H, W) int32; seeds: (B, P, 12) int32; out: (B, P, 8) int32.
// B, P >= 1; B <= 65535. C = 1: K2, one block per (seed, image), grid (P,
// B). C = 2, 4 or 8: K2c, a cluster of C blocks per (seed, image), grid
// (P C, B), each block's slab of ceil(H / C) rows at most kMaxSlabBytes.
extern "C" int inflate_launch(const int* img, const int* seeds, int* out, int B, int P, int H,
                              int W, int C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 1) {
    inflate_kernel<<<dim3(P, B), kThreads, 0, st>>>(img, seeds, out, H, W);
    return static_cast<int>(cudaGetLastError());
  }
  const ClusterSmem lay(H, W, C);
  if ((C != 2 && C != 4 && C != kMaxCluster) || lay.slab_bytes > kMaxSlabBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(inflate_cluster_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes());
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P * C, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = lay.bytes();
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, inflate_cluster_kernel, img, seeds, out, H, W, C);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The largest S inflate_grouped_launch takes.
extern "C" int inflate_max_group() { return kMaxGroup; }

// img: (B, H, W) int32; seeds: (B, G S, 12) int32 (a ragged P padded to G S
// with ok-cleared rows); out: (B, G S, 8) int32. 2 <= S <= kMaxGroup;
// B, G >= 1; B <= 65535. One cluster of S blocks per group of S seeds and
// image: grid (G S, B). A cluster size the card refuses returns its error.
extern "C" int inflate_grouped_launch(const int* img, const int* seeds, int* out, int B, int G,
                                      int S, int H, int W, void* stream) {
  if (S < 2 || S > kMaxGroup) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G * S, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = GroupSmem::bytes();
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, inflate_grouped_kernel, img, seeds, out, H, W, S);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
