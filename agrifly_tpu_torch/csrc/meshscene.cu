// Imported-world raycasters: the strip-culled depth kernel (K4), the window
// depth kernel (K4w) and the strip-culled RGB kernel (K4-rgb).
//
// Replaces the TPU kernels of agrifly_tpu/render/pallas_meshscene.py:
// _strip_kernel (launched by render_depth_strips_batch, the default of
// render_depth_batch) and _kernel (render_depth_window_batch). Their codes
// equal agrifly_tpu_torch/render/meshscene.py's plain versions bit for bit
// (render_strips after strip_windows, and render_depth_window): every
// intersection uses the same float32 operations in the same order (the JAX
// kernel's _hit_branches), and K4's culling repeats row_bounding_spheres'
// and strip_windows' operations, so it keeps exactly strip_windows' rows.
// That needs the build flags of cuda_build.py: -fmad=false and no fast math
// (IEEE division and sqrt).
//
// Layout: one block per (16 x 32 pixel tile, vehicle), 600 blocks for one
// 640 x 480 image. Its 256 threads are 8 warps of 2 image rows x 16
// columns; a thread owns two pixels, columns x and x + 16 of its row, so the
// block's fixed costs (the camera, the culling) and each staged row's loads
// serve two pixels. Every thread tests the same row in lockstep.
//
// What is shared is computed once: a block stages its rows 256 at a time in
// shared memory (16 KB) in their camera-relative form (prepare_row: the
// offset camera - p0, a sphere's or cylinder's cc, a triangle's
// qv = tv x e1 and qv . e2), thread i preparing row i, and sorted by kind
// (stage_rows), so each kind has its own loop and no row pays a switch;
// kind 0 rows, which give BIG, are left out. A thread computes its pixels'
// own terms (4a, 2a, 4ca, 2ca) once. Per pixel and row a sphere or cylinder
// then costs ~10 float operations to its miss test, a triangle its edge
// vector products, det, the divide and u before its first reject. A miss
// costs no square root, divide or min, nor does a triangle with
// |det| < 1e-12. meshscene.render_depth_window_prepared mirrors these
// operations (in window order: the min over the rows does not depend on it).
//
// K4 does the strip culling itself (one launch from the frame's window, no
// strips table in device memory): for each chunk of the window, thread i
// computes row i's bounding sphere and camera-frame centre and tests it
// against its strip's five halfspaces; the passing rows are staged as
// above, each prepared by the thread that culled it, and the block renders
// only them. Every block of a strip repeats the strip's culling, at most
// one window row a thread. K4w tests every window row against every pixel.
// `nvis`, where it is not null, receives each strip's count of passing rows
// (strip_windows' n_vis).
//
// K4-rgb (meshscene_rgb_kernel) replaces no TPU kernel: the JAX package
// renders an imported world's RGB image with jnp
// (agrifly_tpu/render/meshscene.py render_rgb), which the card would run at
// eager speed. Its bytes equal meshscene.py's plain strip scan's
// (render_rgb_strips) bit for bit, and so the plain window scan's
// (render_rgb_window): K4's culling without the far plane (a row beyond it
// still shades, hazed), K4's row tests, and the shading of csrc/shade.cuh.
// Its own layout:
// - a thread loads its window row and material before anything else and
//   culls the first chunk with the camera in its registers, so that the
//   loads' latency runs beside the camera's;
// - the rows that pass are staged in window order (one ballot a warp), each
//   with its window row, kind, material and, for a sphere or a cylinder,
//   its centre, in words its kind leaves free (prepare_row): a strict `<`
//   then keeps the plain scans' earliest row among equal t, the strip's
//   first row is slot 0, and a pixel keeps only its winner's slot and shades
//   from shared memory (from device memory only a winner of an earlier chunk
//   of a window longer than a chunk);
// - the rays are aimed after the staging, from a table of the tile's
//   image-plane rows and columns (a divide each, not three a thread).
//
// What bounds them on the card: the instructions they run. A pixel reads 7
// camera scalars and its rows from shared memory and writes one int32 (three
// bytes), but runs ~10-35 float operations per row (sphere, z-cylinder,
// Moller-Trumbore triangle) over n_vis rows (K4: a few to a few tens after
// strip culling; K4w: the whole window); every intermediate stays in
// registers. The world-from-camera matrix is built in the kernel from the
// camera quaternion (rotation.py::to_matrix's operations), so the wrapper
// launches nothing before the kernel.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "shade.cuh"

namespace {

constexpr float kBig = 1e9f;
constexpr int kRowWidth = 10;  // [kind, p0..p8]
constexpr int kTileH = 16;     // image rows per strip (pallas_meshscene.TILE_H)
constexpr int kLaneCols = 16;  // a tile's thread columns: a thread owns columns x + 16 j

constexpr int kPixels = 2;     // a thread's pixels, columns x + 16 j (j < kPixels)
constexpr int kTileW = kLaneCols * kPixels;  // image columns per block
constexpr int kThreads = kLaneCols * kTileH;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads;  // rows staged in shared memory at a time, thread i preparing row i

// Section timers, compiled only with -DMESH_SECTIONS (chip_smoke.py's
// mesh_sections builds that variant): clock64() cycles of each Section of a
// block on its thread 0, summed over the blocks of K4 and K4-rgb, read and
// reset by meshscene_sections_read. Each mark waits at a barrier first, so
// that it closes the section for the whole block; kSecBlock is the block
// from its start to its last mark. Without the define they are empty.
enum Section { kSecBlock, kSecSetup, kSecCull, kSecStage, kSecRows, kSecShade, kSecStore,
               kNumSections };
#ifdef MESH_SECTIONS
__device__ unsigned long long g_sec[kNumSections], g_blocks;
#define SECTIONS_START()                        \
  const long long sec_start = clock64();        \
  long long sec_last = sec_start;               \
  unsigned long long sec_sum[kNumSections] = {};
#define SECTION_MARK(k)                         \
  __syncthreads();                              \
  if (threadIdx.x == 0) {                       \
    const long long now = clock64();            \
    sec_sum[k] += now - sec_last;               \
    sec_last = now;                             \
  }
#define SECTIONS_FINISH()                                                    \
  if (threadIdx.x == 0) {                                                    \
    sec_sum[kSecBlock] = sec_last - sec_start;                               \
    for (int k = 0; k < kNumSections; ++k) atomicAdd(&g_sec[k], sec_sum[k]); \
    atomicAdd(&g_blocks, 1ull);                                              \
  }
#else
#define SECTIONS_START()
#define SECTION_MARK(k)
#define SECTIONS_FINISH()
#endif

struct Camera {
  float x, y, z;
  float R[9];  // world-from-camera, row-major
};

struct Dir {
  float x, y, z;
};

// strip_windows' frustum constants, computed in float64 by the wrapper and
// rounded to float32 as PyTorch rounds a python float in a float32 op
struct Frustum {
  float ex_min, ex_max, sx_min, sx_max, far;
};

// strip t's vertical halfspaces (strip_windows' ey_min, ey_max, sy_min, sy_max)
struct StripPlanes {
  float ey_min, ey_max, sy_min, sy_max;
};

__device__ __forceinline__ StripPlanes strip_planes(int t, int H, float focal) {
  float ys = static_cast<float>(t * kTileH);
  float half_h = static_cast<float>(H) * 0.5f;
  float ey_min = (ys - half_h) / focal;
  float ey_max = (ys + static_cast<float>(kTileH - 1) - half_h) / focal;
  return StripPlanes{ey_min, ey_max, sqrtf(1.0f + ey_min * ey_min),
                     sqrtf(1.0f + ey_max * ey_max)};
}

// rotation.py::to_matrix of vehicle b's quaternion, in its operation order
__device__ __forceinline__ Camera camera_of(const float* __restrict__ cam_pos,
                                            const float* __restrict__ cam_att, int b) {
  const float* p = cam_pos + static_cast<int64_t>(b) * 3;
  const float* q = cam_att + static_cast<int64_t>(b) * 4;
  float w = q[0], x = q[1], y = q[2], z = q[3];
  float r0 = w * w, r1 = x * x, r2 = y * y, r3 = z * z;
  return Camera{p[0], p[1], p[2],
                {r0 + r1 - r2 - r3, 2.0f * (x * y - w * z), 2.0f * (x * z + w * y),
                 2.0f * (x * y + w * z), r0 - r1 + r2 - r3, 2.0f * (y * z - w * x),
                 2.0f * (x * z - w * y), 2.0f * (y * z + w * x), r0 - r1 - r2 + r3}};
}

// A window row in its camera-relative form, as a block stages it in shared
// memory: the terms of the plain version's _hit that depend only on the row
// and the camera, in its float32 operations (meshscene.prepare_rows), so
// that per pixel and row only the work left by kind remains. With
// o = camera - p[0:3]:
//   sphere    q[0] = (ox, oy, oz, ox*ox + oy*oy + oz*oz - r*r)
//   cylinder  q[0] = (ox, oy, ox*ox + oy*oy - r*r, z0), q[1].x = z1
//   triangle  q[0] = (tv = o, qv . e2), q[1] = (qv = tv x e1, e1.x),
//             q[2] = (e1.y, e1.z, e2.x, e2.y), q[3].x = e2.z
// The RGB pass (kRgb) also stages, in words the kind leaves free, the
// row's window index k in q[3].w, its kind in q[3].z, and what its shading
// reads: the material m and a sphere's p0..p2 or a cylinder's p0, p1 (a
// triangle's face normal is e1 x e2 of its staged edges):
//   sphere    q[1] = (p0, p1, p2, m)
//   cylinder  q[1] = (z1, p0, p1, m)
//   triangle  q[3].y = m
constexpr int kQuads = 4;  // float4s per prepared row

// A window row held in registers (K4-rgb loads its row once, early); K4
// and K4w read theirs through a pointer. The functions below take either.
struct Row {
  float v[kRowWidth];
  __device__ __forceinline__ float operator[](int i) const { return v[i]; }
};

// window row k of `win` (K4-rgb's thread k - base), or a kind 0 row
__device__ __forceinline__ Row load_row(const float* __restrict__ win, int k, bool valid) {
  Row q{};
  if (valid) {
    const float* p = win + static_cast<int64_t>(k) * kRowWidth;
#pragma unroll
    for (int i = 0; i < kRowWidth; ++i) q.v[i] = p[i];
  }
  return q;
}

// row q's parameters p0..p8
template <class Q>
struct Params {
  const Q& q;
  __device__ __forceinline__ float operator[](int i) const { return q[1 + i]; }
};

template <class Q>
__device__ __forceinline__ int row_kind(const Q& q) {
  return min(max(static_cast<int>(q[0]), 0), 3);
}

// Row q (kind, p0..p8) of kind `kind` (row_kind) prepared for camera c into
// dst; with kRgb also its window row k, kind and material m.
template <bool kRgb, class Q>
__device__ __forceinline__ void prepare_row(const Q& q, int kind, int k, int m,
                                            const Camera& c, float4* dst) {
  if constexpr (kRgb) dst[3].z = __int_as_float(kind), dst[3].w = __int_as_float(k);
  const Params<Q> p{q};
  const float ox = c.x - p[0], oy = c.y - p[1], oz = c.z - p[2];
  if (kind == 1) {
    dst[0] = make_float4(ox, oy, oz, ox * ox + oy * oy + oz * oz - p[3] * p[3]);
    if constexpr (kRgb) dst[1] = make_float4(p[0], p[1], p[2], __int_as_float(m));
  } else if (kind == 2) {
    dst[0] = make_float4(ox, oy, ox * ox + oy * oy - p[4] * p[4], p[2]);
    if constexpr (kRgb) {
      dst[1] = make_float4(p[3], p[0], p[1], __int_as_float(m));
    } else {
      dst[1].x = p[3];
    }
  } else if (kind == 3) {
    const float qvx = oy * p[5] - oz * p[4];
    const float qvy = oz * p[3] - ox * p[5];
    const float qvz = ox * p[4] - oy * p[3];
    dst[0] = make_float4(ox, oy, oz, qvx * p[6] + qvy * p[7] + qvz * p[8]);
    dst[1] = make_float4(qvx, qvy, qvz, p[3]);
    dst[2] = make_float4(p[4], p[5], p[6], p[7]);
    dst[3].x = p[8];
    if constexpr (kRgb) dst[3].y = __int_as_float(m);
  }
}

// One pixel's ray and its own terms of _hit: ca = dx*dx + dy*dy; a = ca +
// dz*dz equals _hit's dx*dx + dy*dy + dz*dz bit for bit (summed left to
// right), and `4 * a * cc` groups as (4 a) cc.
struct Ray {
  float dx, dy, dz;
  float a4, a2;  // 4 a, 2 a
  float ca4, ca2;  // 4 ca, 2 ca
  bool vertical;  // ca <= 1e-12: the cylinder test fails
};

__device__ __forceinline__ Ray ray_of(const Dir& d) {
  const float ca = d.x * d.x + d.y * d.y;
  const float a = ca + d.z * d.z;
  return Ray{d.x, d.y, d.z, 4.0f * a, 2.0f * a, 4.0f * ca, 2.0f * ca, !(ca > 1e-12f)};
}

using Rows = float4 (*)[kQuads];  // the staged rows in shared memory

__device__ __forceinline__ int staged_index(const Rows srow, int i) {
  return __float_as_int(srow[i][3].w);
}

// A pixel's nearest hit so far, offered each hit with its staged slot i.
// The depth pass keeps t alone. The RGB pass also keeps the winner: the
// rows are staged and tested in window order (stage_in_order), so a strict
// `<` keeps the earliest row among the nearest, as the plain scans do (the
// ground before any row).
struct DepthBest {
  float t;
  __device__ __forceinline__ void init(float t0) { t = t0; }
  __device__ __forceinline__ void offer(float tt, int) { t = fminf(t, tt); }
};

struct RgbBest {
  float t;
  // -1 the ground (or nothing); i >= 0 staged slot i of this chunk; w <= -2
  // window row -2 - w, staged in an earlier chunk
  int win;
  __device__ __forceinline__ void init(float t0) { t = t0, win = -1; }
  __device__ __forceinline__ void offer(float tt, int i) {
    if (tt < t) t = tt, win = i;
  }
  // before the next chunk's staging overwrites this chunk's rows
  __device__ __forceinline__ void retire(const Rows srow) {
    if (win >= 0) win = -2 - staged_index(srow, win);
  }
};

// Each hit test lowers `best` where the ray hits nearer; a miss (disc < 0,
// or NaN) returns before the square root, the divides and the min, and the
// far root is taken only where the near one is not ahead: the plain version
// computes all, selects, and takes the min with BIG, with the same result.
// i: the tested row's staged slot (RgbBest keeps it).
template <class Best>
__device__ __forceinline__ void sphere_hit(const float4& s, int i, const Ray& r, Best& best) {
  float bq = 2.0f * (s.x * r.dx + s.y * r.dy + s.z * r.dz);
  float disc = bq * bq - r.a4 * s.w;
  if (!(disc >= 0.0f)) return;
  float sq = sqrtf(disc);
  float t0 = (-bq - sq) / r.a2;
  if (t0 > 0.0f) {
    best.offer(t0, i);
    return;
  }
  float t1 = (-bq + sq) / r.a2;
  if (t1 > 0.0f) best.offer(t1, i);
}

// z-axis cylinder: s = (ox, oy, cc, z0), z1; cz the camera's height
template <class Best>
__device__ __forceinline__ void cylinder_hit(const float4& s, float z1, float cz, int i,
                                             const Ray& r, Best& best) {
  if (r.vertical) return;
  float cb = 2.0f * (s.x * r.dx + s.y * r.dy);
  float disc = cb * cb - r.ca4 * s.z;
  if (!(disc >= 0.0f)) return;
  float sq = sqrtf(disc);
  float tc = (-cb - sq) / r.ca2;
  if (!(tc > 0.0f)) tc = (-cb + sq) / r.ca2;
  float z = cz + tc * r.dz;
  if (tc > 0.0f && z >= s.w && z <= z1) best.offer(tc, i);
}

// Moller-Trumbore from the prepared row q[0..3] (staged slot i). Every
// return is one of the plain version's conditions on a value computed as it
// computes it (det, u, v, t), so the rejects are exact; |det| < 1e-12 skips
// the divide, where the plain version divides by 1 and fails `ok`.
template <class Best>
__device__ __forceinline__ void triangle_hit(const float4* q, int i, const Ray& r, Best& best) {
  const float4 q0 = q[0], q1 = q[1], q2 = q[2];
  const float e1x = q1.w, e1y = q2.x, e1z = q2.y;
  const float e2x = q2.z, e2y = q2.w, e2z = q[3].x;
  float pvx = r.dy * e2z - r.dz * e2y;
  float pvy = r.dz * e2x - r.dx * e2z;
  float pvz = r.dx * e2y - r.dy * e2x;
  float det = pvx * e1x + pvy * e1y + pvz * e1z;
  if (!(fabsf(det) >= 1e-12f)) return;
  float inv_det = 1.0f / det;
  float u = (q0.x * pvx + q0.y * pvy + q0.z * pvz) * inv_det;
  if (!(u >= 0.0f)) return;
  float v = (q1.x * r.dx + q1.y * r.dy + q1.z * r.dz) * inv_det;
  if (!(v >= 0.0f && u + v <= 1.0f)) return;
  float tt = q0.w * inv_det;
  if (tt > 0.0f) best.offer(tt, i);
}

__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf(x * x + y * y + z * z);
}

// Whether window row q (kind, p0..p8) can be seen from strip s:
// meshscene.py row_bounding_spheres, then strip_windows' five halfspace
// tests, in their float32 operations. A kind 0 row (a window's padding,
// often half of it) gets r = -1 there and fails the first test, so it
// returns before the bounding sphere, which it would compute by the
// triangle's branch (three divides and three square roots).
template <class Q>
__device__ __forceinline__ bool strip_visible(const Q& q, const Camera& c, const StripPlanes& s,
                                              const Frustum& f) {
  float kind = q[0];
  if (kind == 0.0f) return false;
  const Params<Q> p{q};
  bool is_s = kind == 1.0f, is_c = kind == 2.0f, is_t = kind == 3.0f;
  float cx, cy, cz, r;
  if (is_s) {
    cx = p[0], cy = p[1], cz = p[2], r = p[3];
  } else if (is_c) {
    float half_h = (p[3] - p[2]) * 0.5f;
    cx = p[0], cy = p[1], cz = (p[2] + p[3]) * 0.5f;
    r = sqrtf(p[4] * p[4] + half_h * half_h);
  } else {
    // the triangle's centroid and largest vertex distance (every other kind
    // takes this branch in row_bounding_spheres too)
    float gx = (p[3] + p[6]) / 3.0f, gy = (p[4] + p[7]) / 3.0f, gz = (p[5] + p[8]) / 3.0f;
    float r_a = norm3(p[3] - gx, p[4] - gy, p[5] - gz);
    float r_b = norm3(p[6] - gx, p[7] - gy, p[8] - gz);
    r = fmaxf(norm3(gx, gy, gz), fmaxf(r_a, r_b));
    cx = is_t ? p[0] + gx : p[0];
    cy = is_t ? p[1] + gy : p[1];
    cz = p[2] + gz;
  }
  r = r * 1.001f + 1e-3f;

  // world -> camera, c = R^T (centre - cam), three products left to right
  float dx = cx - c.x, dy = cy - c.y, dz = cz - c.z;
  float ccx = dx * c.R[0] + dy * c.R[3] + dz * c.R[6];
  float ccy = dx * c.R[1] + dy * c.R[4] + dz * c.R[7];
  float ccz = dx * c.R[2] + dy * c.R[5] + dz * c.R[8];
  float nr = -r;
  return r >= 0.0f && ccz + r > 0.0f && ccz - r <= f.far &&
         ccx - f.ex_min * ccz >= nr * f.sx_min && f.ex_max * ccz - ccx >= nr * f.sx_max &&
         ccy - s.ey_min * ccz >= nr * s.sy_min && s.ey_max * ccz - ccy >= nr * s.sy_max;
}

// A thread's pixels of its block's tile (strip t, column tile tx): columns
// x + 16 j of row y, j < kPixels, their rays with their own terms, and their
// ground-plane t.
template <class Best>
struct Pixels {
  int x, y;
  Ray r[kPixels];
  Best best[kPixels];
};

// the image-plane coordinate of pixel column (or row) v of n: (v - n/2) / focal
__device__ __forceinline__ float plane_coord(int v, int n, float focal) {
  return (static_cast<float>(v) - static_cast<float>(n) * 0.5f) / focal;
}

// px's rays through image-plane row `row` and columns col[j] for camera c
template <class Best, class Cols>
__device__ __forceinline__ void aim(Pixels<Best>& px, const Camera& c, float row,
                                    const Cols& col) {
  const float* R = c.R;
#pragma unroll
  for (int j = 0; j < kPixels; ++j) {
    Dir d{R[0] * col[j] + R[1] * row + R[2], R[3] * col[j] + R[4] * row + R[5],
          R[6] * col[j] + R[7] * row + R[8]};
    // ground plane z = 0
    float dz_safe = fabsf(d.z) < 1e-9f ? 1e-9f : d.z;
    float t_ground = -c.z / dz_safe;
    px.r[j] = ray_of(d);
    px.best[j].init((t_ground > 0.0f && d.z != 0.0f) ? t_ground : kBig);
  }
}

// a thread's columns in a table of the tile's columns: col[j] = p[16 j]
struct LaneCols {
  const float* p;
  __device__ __forceinline__ float operator[](int j) const { return p[j * kLaneCols]; }
};

template <class Best>
__device__ __forceinline__ Pixels<Best> pixels_at(int t, int tx) {
  int tid = static_cast<int>(threadIdx.x);
  Pixels<Best> px;
  px.x = tx * kTileW + (tid & (kLaneCols - 1));
  px.y = t * kTileH + tid / kLaneCols;
  return px;
}

template <class Best>
__device__ __forceinline__ Pixels<Best> pixels_of(const Camera& c, int t, int tx, int H, int W,
                                                  float focal) {
  Pixels<Best> px = pixels_at<Best>(t, tx);
  float col[kPixels];
#pragma unroll
  for (int j = 0; j < kPixels; ++j) col[j] = plane_coord(px.x + j * kLaneCols, W, focal);
  aim(px, c, plane_coord(px.y, H, focal), col);
  return px;
}

// A chunk's rows as K4 and K4w stage them: prepared, sorted by kind
// (spheres, then cylinders, then triangles; window order within a kind),
// kind 0 rows left out (their test gives BIG for every pixel). The min over
// the rows does not depend on their order, so the codes stay the plain
// version's. n[k - 1] is the count of kind k.
struct Staged {
  int n[3];
};

// Stages this thread's row q (window row k) of kind `kind` (0: none) for
// camera c, at most one row a thread: warp ballots and a prefix count over
// the warps give each row its slot. Every thread of the block calls it; on
// return the rows are in shared memory.
template <class Q>
__device__ __forceinline__ Staged stage_rows(const Q& q, int kind, int k, const Camera& c,
                                             Rows srow, int (*warp_rows)[kWarps]) {
  const int tid = static_cast<int>(threadIdx.x), warp = tid >> 5, lane = tid & 31;
  unsigned ballot[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) ballot[k] = __ballot_sync(0xffffffffu, kind == k + 1);
  __syncthreads();  // the previous chunk is consumed
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) warp_rows[k][warp] = __popc(ballot[k]);
  }
  __syncthreads();
  Staged st{{0, 0, 0}};
  int at[3] = {0, 0, 0};
  for (int w = 0; w < kWarps; ++w) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      at[k] += w < warp ? warp_rows[k][w] : 0;
      st.n[k] += warp_rows[k][w];
    }
  }
  if (kind > 0) {
    const unsigned below = (1u << lane) - 1u;
    int i = kind == 1 ? at[0] + __popc(ballot[0] & below)
          : kind == 2 ? st.n[0] + at[1] + __popc(ballot[1] & below)
                      : st.n[0] + st.n[1] + at[2] + __popc(ballot[2] & below);
    prepare_row<false>(q, kind, k, 0, c, srow[i]);
  }
  __syncthreads();
  return st;
}

// both pixels' best over the staged rows, one loop per kind (the same for
// every thread of the block: no switch per row); cz the camera's height
__device__ __forceinline__ void render_rows(const Rows srow, const Staged& st, float cz,
                                            Pixels<DepthBest>& px) {
  const int ns = st.n[0], nc = ns + st.n[1], nt = nc + st.n[2];
  for (int i = 0; i < ns; ++i) {
    const float4 s = srow[i][0];
    sphere_hit(s, i, px.r[0], px.best[0]);
    sphere_hit(s, i, px.r[1], px.best[1]);
  }
  for (int i = ns; i < nc; ++i) {
    const float4 s = srow[i][0];
    const float z1 = srow[i][1].x;
    cylinder_hit(s, z1, cz, i, px.r[0], px.best[0]);
    cylinder_hit(s, z1, cz, i, px.r[1], px.best[1]);
  }
  for (int i = nc; i < nt; ++i) {
    triangle_hit(srow[i], i, px.r[0], px.best[0]);
    triangle_hit(srow[i], i, px.r[1], px.best[1]);
  }
}

__device__ __forceinline__ void write_codes(int* __restrict__ out,
                                            const Pixels<DepthBest>& px, int b, int H, int W,
                                            float scale) {
#pragma unroll
  for (int j = 0; j < kPixels; ++j) {
    int x = px.x + j * kLaneCols;
    if (x < W) {
      float code = fminf(fmaxf(floorf(px.best[j].t / scale), 0.0f), 255.0f);
      out[(static_cast<int64_t>(b) * H + px.y) * W + x] = static_cast<int>(code);
    }
  }
}

// K4-rgb's staging of a chunk: this thread's row q (window row k, material
// m) if it passed the culling (vis), for camera c, compacted in window
// order (a warp ballot and a prefix count over the warps; at most one row a
// thread), prepared with its window row, material and kind (prepare_row's
// kRgb form). Every thread of the block calls it; on return the rows are in
// shared memory; returns their count. wait: whether the rows staged before
// may still be read (a barrier first).
template <class Q>
__device__ __forceinline__ int stage_in_order(const Q& q, bool vis, int k, int m,
                                              const Camera& c, Rows srow, int* warp_rows,
                                              bool wait) {
  const int tid = static_cast<int>(threadIdx.x), warp = tid >> 5, lane = tid & 31;
  const unsigned ballot = __ballot_sync(0xffffffffu, vis);
  if (wait) __syncthreads();
  if (lane == 0) warp_rows[warp] = __popc(ballot);
  __syncthreads();
  int at = 0, n = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int count = warp_rows[w];
    at += w < warp ? count : 0;
    n += count;
  }
  if (vis) {
    prepare_row<true>(q, row_kind(q), k, m, c,
                      srow[at + __popc(ballot & ((1u << lane) - 1u))]);
  }
  __syncthreads();
  return n;
}

// every pixel's best over the n rows staged in window order, a switch on
// each row's kind (the same row for every thread of the block); cz the
// camera's height
__device__ __forceinline__ void render_in_order(const Rows srow, int n, float cz,
                                                Pixels<RgbBest>& px) {
  for (int i = 0; i < n; ++i) {
    const float4* q = srow[i];
    const int kind = __float_as_int(q[3].z);
    if (kind == 1) {
      const float4 s = q[0];
#pragma unroll
      for (int j = 0; j < kPixels; ++j) sphere_hit(s, i, px.r[j], px.best[j]);
    } else if (kind == 2) {
      const float4 s = q[0];
      const float z1 = q[1].x;
#pragma unroll
      for (int j = 0; j < kPixels; ++j) cylinder_hit(s, z1, cz, i, px.r[j], px.best[j]);
    } else {
#pragma unroll
      for (int j = 0; j < kPixels; ++j) triangle_hit(q, i, px.r[j], px.best[j]);
    }
  }
}

// The winner's normal, not yet normalized, and material, as _shade takes
// them (a sphere's radial, a cylinder's radial in xy, a triangle's face
// normal e1 x e2 turned toward the viewer): from its window row q (kind,
// p0..p8) and material m (row_normal), or from its staged row q
// (staged_normal). h: the hit point c + t d.
__device__ __forceinline__ void turn_to_viewer(const Ray& r, float& nx, float& ny, float& nz) {
  if (nx * r.dx + ny * r.dy + nz * r.dz > 0.0f) nx = -nx, ny = -ny, nz = -nz;
}

__device__ __forceinline__ int row_normal(const float* q, int m, float hx, float hy, float hz,
                                          const Ray& r, float& nx, float& ny, float& nz) {
  const float* p = q + 1;
  if (q[0] == 1.0f) {
    nx = hx - p[0], ny = hy - p[1], nz = hz - p[2];
  } else if (q[0] == 2.0f) {
    nx = hx - p[0], ny = hy - p[1], nz = 0.0f;
  } else {
    nx = p[4] * p[8] - p[5] * p[7];
    ny = p[5] * p[6] - p[3] * p[8];
    nz = p[3] * p[7] - p[4] * p[6];
    turn_to_viewer(r, nx, ny, nz);
  }
  return m;
}

__device__ __forceinline__ int staged_normal(const float4* q, float hx, float hy, float hz,
                                             const Ray& r, float& nx, float& ny, float& nz) {
  const int kind = __float_as_int(q[3].z);
  if (kind == 1) {
    const float4 c = q[1];
    nx = hx - c.x, ny = hy - c.y, nz = hz - c.z;
    return __float_as_int(c.w);
  }
  if (kind == 2) {
    const float4 c = q[1];
    nx = hx - c.y, ny = hy - c.z, nz = 0.0f;
    return __float_as_int(c.w);
  }
  // e1 = (q[1].w, q[2].x, q[2].y), e2 = (q[2].z, q[2].w, q[3].x)
  const float4 q1 = q[1], q2 = q[2], q3 = q[3];
  nx = q2.x * q3.x - q2.y * q2.w;
  ny = q2.y * q2.z - q1.w * q3.x;
  nz = q1.w * q2.w - q2.x * q2.z;
  turn_to_viewer(r, nx, ny, nz);
  return __float_as_int(q3.y);
}

// K4-rgb: block (strip t, column tile tx, vehicle b) over
// windows (B, K, 10) with the rows' materials mats (B, K): the strip's rows
// culled without the far plane (f.far is +inf), staged in window order with
// their shading payload, tested, and each pixel shaded (meshscene.py
// _shade, then csrc/shade.cuh) into rgb (B, H, W, 3). A thread loads its
// row and its material before anything else and culls the first chunk with
// the camera in its registers, so that the loads' latency runs beside the
// camera's; thread 0 leaves the camera and the strip's halfspaces in shared
// memory (published by the staging's barriers) for the rays, the shading
// and a later chunk. Where the ground's t exceeds BIG (a ray within 1e-9 of
// horizontal) and no row came nearer, the plain strip scan's first row wins
// with its BIG, and so does `first` here, the strip's first row in window
// order that passed the culling (K if none).
__global__ void __launch_bounds__(kThreads)
meshscene_rgb_kernel(const float* __restrict__ cam_pos, const float* __restrict__ cam_att,
                     const float* __restrict__ windows, const int* __restrict__ mats,
                     unsigned char* __restrict__ rgb, int K, int H, int W, float focal, float far,
                     Frustum f, shade::Sun sun) {
  __shared__ float4 srow[kChunk][kQuads];
  __shared__ int warp_rows[kWarps];
  __shared__ Camera cam;
  __shared__ StripPlanes planes;
  __shared__ float coord[kTileH + kTileW];  // the tile's image-plane rows, then columns
  const int ntx = (W + kTileW - 1) / kTileW;
  const int t = static_cast<int>(blockIdx.x) / ntx;
  const int tx = static_cast<int>(blockIdx.x) % ntx;
  const int b = static_cast<int>(blockIdx.y);
  const int tid = static_cast<int>(threadIdx.x);
  SECTIONS_START()
  const float* win = windows + static_cast<int64_t>(b) * K * kRowWidth;
  const int* mat = mats + static_cast<int64_t>(b) * K;
  int n;
  Pixels<RgbBest> px = pixels_at<RgbBest>(t, tx);
  {
    const Row q = load_row(win, tid, tid < K);
    const int m = tid < K ? mat[tid] : 0;
    const Camera c = camera_of(cam_pos, cam_att, b);
    const StripPlanes pl = strip_planes(t, H, focal);
    if (tid == 0) cam = c, planes = pl;
    // one divide a row and a column of the tile, not one a pixel
    if (tid < kTileH) {
      coord[tid] = plane_coord(t * kTileH + tid, H, focal);
    } else if (tid < kTileH + kTileW) {
      coord[tid] = plane_coord(tx * kTileW + tid - kTileH, W, focal);
    }
    SECTION_MARK(kSecSetup)
    const bool vis = tid < K && strip_visible(q, c, pl, f);
    SECTION_MARK(kSecCull)
    n = stage_in_order(q, vis, tid, m, c, srow, warp_rows, false);
    SECTION_MARK(kSecStage)
    aim(px, c, coord[tid / kLaneCols], LaneCols{coord + kTileH + (tid & (kLaneCols - 1))});
  }
  int first = n > 0 ? staged_index(srow, 0) : K;
  SECTION_MARK(kSecSetup)  // the rays are set-up too
  render_in_order(srow, n, cam.z, px);
  SECTION_MARK(kSecRows)
  // every thread reaches each barrier: the loop bounds are the block's
  for (int base = kChunk; base < K; base += kChunk) {
#pragma unroll
    for (int j = 0; j < kPixels; ++j) px.best[j].retire(srow);
    const bool mine = base + tid < K;
    const Row q = load_row(win, base + tid, mine);
    const int m = mine ? mat[base + tid] : 0;
    const bool vis = mine && strip_visible(q, cam, planes, f);
    SECTION_MARK(kSecCull)
    n = stage_in_order(q, vis, base + tid, m, cam, srow, warp_rows, true);
    if (first == K && n > 0) first = staged_index(srow, 0);
    SECTION_MARK(kSecStage)
    render_in_order(srow, n, cam.z, px);
    SECTION_MARK(kSecRows)
  }

  unsigned char bytes[kPixels][3];
#pragma unroll
  for (int j = 0; j < kPixels; ++j) {
    float t_hit = px.best[j].t;
    int w = px.best[j].win;
    if (kBig < t_hit && first < K) t_hit = kBig, w = -2 - first;
    const Ray& r = px.r[j];
    float nx = 0.0f, ny = 0.0f, nz = 1.0f;
    int m = t_hit < kBig ? shade::kGround : shade::kSky;
    if (w != -1) {
      float hx = cam.x + t_hit * r.dx, hy = cam.y + t_hit * r.dy, hz = cam.z + t_hit * r.dz;
      if (w >= 0) {
        m = staged_normal(srow[w], hx, hy, hz, r, nx, ny, nz);
      } else {
        const int k = -2 - w;
        m = row_normal(win + static_cast<int64_t>(k) * kRowWidth, mat[k], hx, hy, hz, r, nx, ny,
                       nz);
      }
      float nn = sqrtf(nx * nx + ny * ny + nz * nz);
      nn = nn < 1e-9f ? 1.0f : nn;
      nx = nx / nn, ny = ny / nn, nz = nz / nn;
      m = min(max(m, 0), 3);
    }
    shade::shade_pixel(m, nx, ny, nz, t_hit, far, sun, bytes[j]);
  }
  SECTION_MARK(kSecShade)
#pragma unroll
  for (int j = 0; j < kPixels; ++j) {
    const int x = px.x + j * kLaneCols;
    if (x >= W) continue;
    unsigned char* dst = rgb + ((static_cast<int64_t>(b) * H + px.y) * W + x) * 3;
    dst[0] = bytes[j][0], dst[1] = bytes[j][1], dst[2] = bytes[j][2];
  }
  SECTION_MARK(kSecStore)
  SECTIONS_FINISH()
}

// K4: the strip-culled scan of block (t * ntx + tx, b) over windows (B, K,
// 10) into codes `out`, with each strip's n_vis into `nvis` where it is not
// null
__global__ void __launch_bounds__(kThreads)
meshscene_strips_kernel(const float* __restrict__ cam_pos, const float* __restrict__ cam_att,
                        const float* __restrict__ windows, int* __restrict__ out,
                        int* __restrict__ nvis, int T, int K, int H, int W, float focal,
                        float scale, Frustum f) {
  __shared__ float4 srow[kChunk][kQuads];
  __shared__ int warp_rows[3][kWarps];
  int ntx = (W + kTileW - 1) / kTileW;
  int t = static_cast<int>(blockIdx.x) / ntx;
  int tx = static_cast<int>(blockIdx.x) % ntx;
  int b = static_cast<int>(blockIdx.y);
  int tid = static_cast<int>(threadIdx.x);
  SECTIONS_START()
  const Camera c = camera_of(cam_pos, cam_att, b);
  Pixels<DepthBest> px = pixels_of<DepthBest>(c, t, tx, H, W, focal);
  const StripPlanes planes = strip_planes(t, H, focal);
  SECTION_MARK(kSecSetup)

  const float* win = windows + static_cast<int64_t>(b) * K * kRowWidth;
  int total = 0;
  // every thread reaches each barrier: the loop bounds are the block's
  for (int base = 0; base < K; base += kChunk) {
    int m = min(kChunk, K - base);
    const float* q = win + static_cast<int64_t>(base + tid) * kRowWidth;
    bool vis = tid < m && strip_visible(q, c, planes, f);
    SECTION_MARK(kSecCull)
    // the culling thread stages its row if it passes
    Staged st = stage_rows(q, vis ? row_kind(q) : 0, base + tid, c, srow, warp_rows);
    SECTION_MARK(kSecStage)
    render_rows(srow, st, c.z, px);
    if (nvis != nullptr) total += __syncthreads_count(vis);
    SECTION_MARK(kSecRows)
  }
  if (nvis != nullptr && tx == 0 && tid == 0) nvis[static_cast<int64_t>(b) * T + t] = total;
  write_codes(out, px, b, H, W, scale);
  SECTION_MARK(kSecStore)
  SECTIONS_FINISH()
}

// K4w: windows (B, K, 10), every row for every strip
__global__ void __launch_bounds__(kThreads)
meshscene_window_kernel(const float* __restrict__ cam_pos, const float* __restrict__ cam_att,
                        const float* __restrict__ windows, int* __restrict__ out, int K, int H,
                        int W, float focal, float scale) {
  __shared__ float4 srow[kChunk][kQuads];
  __shared__ int warp_rows[3][kWarps];
  int ntx = (W + kTileW - 1) / kTileW;
  int t = static_cast<int>(blockIdx.x) / ntx;
  int tx = static_cast<int>(blockIdx.x) % ntx;
  int b = static_cast<int>(blockIdx.y);
  int tid = static_cast<int>(threadIdx.x);
  const Camera c = camera_of(cam_pos, cam_att, b);
  Pixels<DepthBest> px = pixels_of<DepthBest>(c, t, tx, H, W, focal);
  const float* win = windows + static_cast<int64_t>(b) * K * kRowWidth;
  for (int base = 0; base < K; base += kChunk) {
    int m = min(kChunk, K - base);
    const float* q = win + static_cast<int64_t>(base + tid) * kRowWidth;
    // thread i stages row i of the chunk
    Staged st = stage_rows(q, tid < m ? row_kind(q) : 0, base + tid, c, srow, warp_rows);
    render_rows(srow, st, c.z, px);
  }
  write_codes(out, px, b, H, W, scale);
}

dim3 grid_of(int B, int H, int W) {
  return dim3(static_cast<unsigned>(((W + kTileW - 1) / kTileW) * (H / kTileH)),
              static_cast<unsigned>(B));
}

}  // namespace

// cam_pos: (B, 3) float32; cam_att: (B, 4) float32 world-from-camera
// quaternions (w, x, y, z); windows: (B, K, 10) float32; out: (B, H, W)
// int32 codes; H a multiple of 16; scale = far / 256. K4 also takes nvis
// (null, or (B, H / 16) int32 that receives each strip's n_vis) and the
// frustum constants of meshscene.strip_windows (ex_min, ex_max, their
// sqrt(1 + e^2), far), each rounded to float32.
extern "C" int meshscene_strips_launch(const float* cam_pos, const float* cam_att,
                                       const float* windows, int* out, int* nvis, int B, int K,
                                       int H, int W, float focal, float scale, float ex_min,
                                       float ex_max, float sx_min, float sx_max, float far,
                                       void* stream) {
  if (B == 0) return 0;
  meshscene_strips_kernel<<<grid_of(B, H, W), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      cam_pos, cam_att, windows, out, nvis, H / kTileH, K, H, W, focal, scale,
      Frustum{ex_min, ex_max, sx_min, sx_max, far});
  return static_cast<int>(cudaGetLastError());
}

extern "C" int meshscene_window_launch(const float* cam_pos, const float* cam_att,
                                       const float* windows, int* out, int B, int K, int H,
                                       int W, float focal, float scale, void* stream) {
  if (B == 0) return 0;
  meshscene_window_kernel<<<grid_of(B, H, W), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      cam_pos, cam_att, windows, out, K, H, W, focal, scale);
  return static_cast<int>(cudaGetLastError());
}

// K4-rgb: cam_pos, cam_att and windows as K4's; mats: (B, K) int32 material
// ids of the window rows (raycast.MAT_*); rgb: (B, H, W, 3) uint8; far: the
// far plane (the haze's; the culling has none); the frustum's horizontal
// constants as K4's; sun_*: raycast.SUN, the unit sun direction.
extern "C" int meshscene_rgb_launch(const float* cam_pos, const float* cam_att,
                                    const float* windows, const int* mats, unsigned char* rgb,
                                    int B, int K, int H, int W, float focal, float far,
                                    float ex_min, float ex_max, float sx_min, float sx_max,
                                    float sun_x, float sun_y, float sun_z, void* stream) {
  if (B == 0) return 0;
  meshscene_rgb_kernel<<<grid_of(B, H, W), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cam_pos, cam_att, windows, mats, rgb, K, H, W, focal, far,
      Frustum{ex_min, ex_max, sx_min, sx_max, INFINITY}, shade::Sun{sun_x, sun_y, sun_z});
  return static_cast<int>(cudaGetLastError());
}

// Blocks of each mesh kernel that fit on one SM (K4, K4w, K4-rgb), by the
// occupancy API.
extern "C" int meshscene_occupancy(int* blocks) {
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks[0], meshscene_strips_kernel, kThreads, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks[1], meshscene_window_kernel,
                                                      kThreads, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks[2], meshscene_rgb_kernel,
                                                      kThreads, 0);
  return static_cast<int>(e);
}

#ifdef MESH_SECTIONS
// sec[kNumSections]: the cycles of each Section summed over the blocks of
// the launches since the last read, blocks[0] their count; then resets both
extern "C" int meshscene_sections_read(unsigned long long* sec, unsigned long long* blocks) {
  cudaError_t e = cudaMemcpyFromSymbol(sec, g_sec, sizeof(g_sec));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(blocks, g_blocks, sizeof(g_blocks));
  const unsigned long long zero[kNumSections] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_sec, zero, sizeof(g_sec));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_blocks, zero, sizeof(g_blocks));
  return static_cast<int>(e);
}
#endif
