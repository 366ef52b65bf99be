// Imported-world depth raycaster: the strip-culled kernel (K4) and the
// window kernel (K4w).
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
// K4-rgb (meshscene_rgb_kernel) is a third kernel from K4's strip body.
// It replaces no TPU kernel: the JAX package renders an imported world's
// RGB image with jnp (agrifly_tpu/render/meshscene.py render_rgb), which
// the card would run at eager speed. Its bytes equal meshscene.py's plain
// strip scan's (render_rgb_strips) bit for bit, and so the plain window
// scan's (render_rgb_window): K4's culling without the far plane (a row
// beyond it still shades, hazed), each staged row carrying its window row
// so that a tie on t goes to the earlier row as in the plain scans, and the
// shading of csrc/shade.cuh in the same thread.
//
// What bounds it on the card: the instructions it issues. A pixel reads 7
// camera scalars and its rows from shared memory and writes one int32, but
// runs ~10-35 float operations per row (sphere, z-cylinder,
// Moller-Trumbore triangle) over n_vis rows (K4: a few to a few tens after
// strip culling; K4w: the whole window); every intermediate stays in
// registers. The world-from-camera matrix is built in the kernel from the
// camera quaternion (rotation.py::to_matrix's operations), so the wrapper
// launches nothing before the kernel.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "shade.cuh"

namespace {

constexpr float kBig = 1e9f;
constexpr int kRowWidth = 10;  // [kind, p0..p8]
constexpr int kTileH = 16;     // image rows per strip (pallas_meshscene.TILE_H)
constexpr int kTileW = 32;     // image columns per block
constexpr int kHalfW = kTileW / 2;  // a thread owns columns x and x + 16
constexpr int kThreads = kHalfW * kTileH;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads;  // rows staged in shared memory at a time

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
constexpr int kQuads = 4;  // float4s per prepared row

__device__ __forceinline__ int row_kind(const float* q) {
  return min(max(static_cast<int>(q[0]), 0), 3);
}

// Row q (kind, p0..p8) of kind `kind` (row_kind) prepared for camera c into
// dst; with kIndex also its window row k, in q[3].w (free in every kind).
template <bool kIndex>
__device__ __forceinline__ void prepare_row(const float* q, int kind, int k, const Camera& c,
                                            float4* dst) {
  if constexpr (kIndex) dst[3].w = __int_as_float(k);
  const float* p = q + 1;
  const float ox = c.x - p[0], oy = c.y - p[1], oz = c.z - p[2];
  if (kind == 1) {
    dst[0] = make_float4(ox, oy, oz, ox * ox + oy * oy + oz * oz - p[3] * p[3]);
  } else if (kind == 2) {
    dst[0] = make_float4(ox, oy, ox * ox + oy * oy - p[4] * p[4], p[2]);
    dst[1].x = p[3];
  } else if (kind == 3) {
    const float qvx = oy * p[5] - oz * p[4];
    const float qvy = oz * p[3] - ox * p[5];
    const float qvz = ox * p[4] - oy * p[3];
    dst[0] = make_float4(ox, oy, oz, qvx * p[6] + qvy * p[7] + qvz * p[8]);
    dst[1] = make_float4(qvx, qvy, qvz, p[3]);
    dst[2] = make_float4(p[4], p[5], p[6], p[7]);
    dst[3].x = p[8];
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

// A pixel's nearest hit so far. The depth pass keeps t alone. The RGB pass
// also keeps the hit's window row, and takes the smaller row where two rows
// give the same t: the rows are staged sorted by kind, while the plain
// scans' winner is the earliest row in window order among the nearest (the
// ground, row -1, before any row). offer reads a staged row's index from
// its q[3].w only on that path.
struct DepthBest {
  float t;
  __device__ __forceinline__ void init(float t0) { t = t0; }
  __device__ __forceinline__ void offer(float tt, const float4*) { t = fminf(t, tt); }
};

struct RgbBest {
  float t;
  int row;
  __device__ __forceinline__ void init(float t0) { t = t0, row = -1; }
  __device__ __forceinline__ void offer(float tt, const float4* q) {
    if (tt < t) {
      t = tt;
      row = __float_as_int(q[3].w);
    } else if (tt == t) {
      row = min(row, __float_as_int(q[3].w));
    }
  }
};

// Each hit test lowers `best` where the ray hits nearer; a miss (disc < 0,
// or NaN) returns before the square root, the divides and the min, and the
// far root is taken only where the near one is not ahead: the plain version
// computes all, selects, and takes the min with BIG, with the same result.
// q: the staged row (RgbBest reads its index).
template <class Best>
__device__ __forceinline__ void sphere_hit(const float4& s, const float4* q, const Ray& r,
                                           Best& best) {
  float bq = 2.0f * (s.x * r.dx + s.y * r.dy + s.z * r.dz);
  float disc = bq * bq - r.a4 * s.w;
  if (!(disc >= 0.0f)) return;
  float sq = sqrtf(disc);
  float t0 = (-bq - sq) / r.a2;
  if (t0 > 0.0f) {
    best.offer(t0, q);
    return;
  }
  float t1 = (-bq + sq) / r.a2;
  if (t1 > 0.0f) best.offer(t1, q);
}

// z-axis cylinder: s = (ox, oy, cc, z0), z1; cz the camera's height
template <class Best>
__device__ __forceinline__ void cylinder_hit(const float4& s, float z1, float cz,
                                             const float4* q, const Ray& r, Best& best) {
  if (r.vertical) return;
  float cb = 2.0f * (s.x * r.dx + s.y * r.dy);
  float disc = cb * cb - r.ca4 * s.z;
  if (!(disc >= 0.0f)) return;
  float sq = sqrtf(disc);
  float tc = (-cb - sq) / r.ca2;
  if (!(tc > 0.0f)) tc = (-cb + sq) / r.ca2;
  float z = cz + tc * r.dz;
  if (tc > 0.0f && z >= s.w && z <= z1) best.offer(tc, q);
}

// Moller-Trumbore from the prepared row q[0..3]. Every return is one of the
// plain version's conditions on a value computed as it computes it (det,
// u, v, t), so the rejects are exact; |det| < 1e-12 skips the divide, where
// the plain version divides by 1 and fails `ok`.
template <class Best>
__device__ __forceinline__ void triangle_hit(const float4* q, const Ray& r, Best& best) {
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
  if (tt > 0.0f) best.offer(tt, q);
}

__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf(x * x + y * y + z * z);
}

// Whether window row q (kind, p0..p8) can be seen from strip t:
// meshscene.py row_bounding_spheres, then strip_windows' five halfspace
// tests, in their float32 operations.
__device__ __forceinline__ bool strip_visible(const float* q, const Camera& c, float ey_min,
                                              float ey_max, float sy_min, float sy_max,
                                              const Frustum& f) {
  float kind = q[0];
  const float* p = q + 1;
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
  r = kind == 0.0f ? -1.0f : r * 1.001f + 1e-3f;

  // world -> camera, c = R^T (centre - cam), three products left to right
  float dx = cx - c.x, dy = cy - c.y, dz = cz - c.z;
  float ccx = dx * c.R[0] + dy * c.R[3] + dz * c.R[6];
  float ccy = dx * c.R[1] + dy * c.R[4] + dz * c.R[7];
  float ccz = dx * c.R[2] + dy * c.R[5] + dz * c.R[8];
  float nr = -r;
  return r >= 0.0f && ccz + r > 0.0f && ccz - r <= f.far &&
         ccx - f.ex_min * ccz >= nr * f.sx_min && f.ex_max * ccz - ccx >= nr * f.sx_max &&
         ccy - ey_min * ccz >= nr * sy_min && ey_max * ccz - ccy >= nr * sy_max;
}

// This thread's two pixels of tile (strip t, column tile tx), columns x
// and x + 16 of row y: the camera, the two rays with their own terms, and
// their ground-plane t.
template <class Best>
struct Pixels {
  int x, y;
  Camera c;
  Ray r[2];
  Best best[2];
};

template <class Best>
__device__ __forceinline__ Pixels<Best> pixels_of(const float* __restrict__ cam_pos,
                                            const float* __restrict__ cam_att, int b, int t,
                                            int tx, int H, int W, float focal) {
  int tid = static_cast<int>(threadIdx.x);
  Pixels<Best> px;
  px.x = tx * kTileW + (tid & (kHalfW - 1));
  px.y = t * kTileH + tid / kHalfW;
  px.c = camera_of(cam_pos, cam_att, b);
  const float* R = px.c.R;
  float row = (static_cast<float>(px.y) - static_cast<float>(H) * 0.5f) / focal;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float col = (static_cast<float>(px.x + j * kHalfW) - static_cast<float>(W) * 0.5f) / focal;
    Dir d{R[0] * col + R[1] * row + R[2], R[3] * col + R[4] * row + R[5],
          R[6] * col + R[7] * row + R[8]};
    // ground plane z = 0
    float dz_safe = fabsf(d.z) < 1e-9f ? 1e-9f : d.z;
    float t_ground = -px.c.z / dz_safe;
    px.r[j] = ray_of(d);
    px.best[j].init((t_ground > 0.0f && d.z != 0.0f) ? t_ground : kBig);
  }
  return px;
}

// A chunk's rows as the block stages them: prepared, sorted by kind
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
template <bool kIndex>
__device__ __forceinline__ Staged stage_rows(const float* q, int kind, int k, const Camera& c,
                                             float4 (*srow)[kQuads], int (*warp_rows)[kWarps]) {
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
    prepare_row<kIndex>(q, kind, k, c, srow[i]);
  }
  __syncthreads();
  return st;
}

// both pixels' best over the staged rows, one loop per kind (the same for
// every thread of the block: no switch per row)
template <class Best>
__device__ __forceinline__ void render_rows(float4 (*srow)[kQuads], const Staged& st,
                                            Pixels<Best>& px) {
  const int ns = st.n[0], nc = ns + st.n[1], nt = nc + st.n[2];
  for (int i = 0; i < ns; ++i) {
    const float4 s = srow[i][0];
    sphere_hit(s, srow[i], px.r[0], px.best[0]);
    sphere_hit(s, srow[i], px.r[1], px.best[1]);
  }
  for (int i = ns; i < nc; ++i) {
    const float4 s = srow[i][0];
    const float z1 = srow[i][1].x;
    cylinder_hit(s, z1, px.c.z, srow[i], px.r[0], px.best[0]);
    cylinder_hit(s, z1, px.c.z, srow[i], px.r[1], px.best[1]);
  }
  for (int i = nc; i < nt; ++i) {
    triangle_hit(srow[i], px.r[0], px.best[0]);
    triangle_hit(srow[i], px.r[1], px.best[1]);
  }
}

__device__ __forceinline__ void write_codes(int* __restrict__ out, const Pixels<DepthBest>& px,
                                            int b, int H, int W, float scale) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    int x = px.x + j * kHalfW;
    if (x < W) {
      float code = fminf(fmaxf(floorf(px.best[j].t / scale), 0.0f), 255.0f);
      out[(static_cast<int64_t>(b) * H + px.y) * W + x] = static_cast<int>(code);
    }
  }
}

// The smallest window row staged in this chunk (K where none is): the
// first of each kind's run, since a run keeps window order.
__device__ __forceinline__ int first_staged(float4 (*srow)[kQuads], const Staged& st, int K) {
  int first = K;
  int at = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (st.n[k] > 0) first = min(first, __float_as_int(srow[at][3].w));
    at += st.n[k];
  }
  return first;
}

// The RGB pass's shading of this thread's two pixels (meshscene.py _shade):
// the winner's hit point o + t d, its normal by kind (a sphere's radial, a
// cylinder's radial in xy, a triangle's face normal turned toward the
// viewer), its material from `mats`, then csrc/shade.cuh. `first`: the
// strip's first row in window order that passed the culling (K if none).
// Where the ground's t exceeds BIG (a ray within 1e-9 of horizontal) and no
// row came nearer, the plain strip scan's first row wins with its BIG, and
// so does `first` here.
__device__ __forceinline__ void shade_pixels(const Pixels<RgbBest>& px, const float* win,
                                             const int* __restrict__ mats, int first, int b,
                                             int K, int H, int W, float far,
                                             const shade::Sun& sun,
                                             unsigned char* __restrict__ rgb) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    int x = px.x + j * kHalfW;
    if (x >= W) continue;
    float t = px.best[j].t;
    int k = px.best[j].row;
    if (kBig < t && first < K) t = kBig, k = first;
    const Ray& r = px.r[j];
    float nx = 0.0f, ny = 0.0f, nz = 1.0f;
    int mat = t < kBig ? shade::kGround : shade::kSky;
    if (k >= 0) {
      const float* q = win + static_cast<int64_t>(k) * kRowWidth;
      const float* p = q + 1;
      float hx = px.c.x + t * r.dx, hy = px.c.y + t * r.dy, hz = px.c.z + t * r.dz;
      if (q[0] == 1.0f) {
        nx = hx - p[0], ny = hy - p[1], nz = hz - p[2];
      } else if (q[0] == 2.0f) {
        nx = hx - p[0], ny = hy - p[1], nz = 0.0f;
      } else {
        nx = p[4] * p[8] - p[5] * p[7];
        ny = p[5] * p[6] - p[3] * p[8];
        nz = p[3] * p[7] - p[4] * p[6];
        if (nx * r.dx + ny * r.dy + nz * r.dz > 0.0f) nx = -nx, ny = -ny, nz = -nz;
      }
      float nn = sqrtf(nx * nx + ny * ny + nz * nz);
      nn = nn < 1e-9f ? 1.0f : nn;
      nx = nx / nn, ny = ny / nn, nz = nz / nn;
      mat = min(max(mats[static_cast<int64_t>(b) * K + k], 0), 3);
    }
    shade::shade_pixel(mat, nx, ny, nz, t, far, sun,
                       rgb + ((static_cast<int64_t>(b) * H + px.y) * W + x) * 3);
  }
}

// The strip-culled scan of block (t * ntx + tx, b) over windows (B, K, 10):
// K4's depth pass (out, nvis), or with kRgb the RGB pass (K4-rgb: every
// staged row carries its window row, and the block shades its pixels into
// rgb from mats (B, K)). `scale`: the depth pass's far / 256, the RGB
// pass's far plane (the haze's). The RGB pass culls without the far plane
// (its frustum's far is +inf): a row beyond it still shades, hazed.
template <bool kRgb>
__device__ __forceinline__ void strips_body(const float* __restrict__ cam_pos,
                                            const float* __restrict__ cam_att,
                                            const float* __restrict__ windows,
                                            const int* __restrict__ mats, int* __restrict__ out,
                                            unsigned char* __restrict__ rgb,
                                            int* __restrict__ nvis, int T, int K, int H, int W,
                                            float focal, float scale, const Frustum& f,
                                            const shade::Sun& sun) {
  using Best = std::conditional_t<kRgb, RgbBest, DepthBest>;
  __shared__ float4 srow[kChunk][kQuads];
  __shared__ int warp_rows[3][kWarps];
  int ntx = (W + kTileW - 1) / kTileW;
  int t = static_cast<int>(blockIdx.x) / ntx;
  int tx = static_cast<int>(blockIdx.x) % ntx;
  int b = static_cast<int>(blockIdx.y);
  int tid = static_cast<int>(threadIdx.x);
  Pixels<Best> px = pixels_of<Best>(cam_pos, cam_att, b, t, tx, H, W, focal);

  // strip t's vertical halfspaces (strip_windows' ey_min, ey_max, sy_min, sy_max)
  float ys = static_cast<float>(t * kTileH);
  float half_h = static_cast<float>(H) * 0.5f;
  float ey_min = (ys - half_h) / focal;
  float ey_max = (ys + static_cast<float>(kTileH - 1) - half_h) / focal;
  float sy_min = sqrtf(1.0f + ey_min * ey_min);
  float sy_max = sqrtf(1.0f + ey_max * ey_max);

  const float* win = windows + static_cast<int64_t>(b) * K * kRowWidth;
  int total = 0;
  int first = K;
  // every thread reaches each barrier: the loop bounds are the block's
  for (int base = 0; base < K; base += kChunk) {
    int m = min(kChunk, K - base);
    const float* q = win + static_cast<int64_t>(base + tid) * kRowWidth;
    bool vis = tid < m && strip_visible(q, px.c, ey_min, ey_max, sy_min, sy_max, f);
    // the culling thread stages its row if it passes
    Staged st = stage_rows<kRgb>(q, vis ? row_kind(q) : 0, base + tid, px.c, srow, warp_rows);
    if constexpr (kRgb) {
      if (first == K) first = first_staged(srow, st, K);
    }
    render_rows(srow, st, px);
    if (nvis != nullptr) total += __syncthreads_count(vis);
  }
  if (nvis != nullptr && tx == 0 && tid == 0) nvis[static_cast<int64_t>(b) * T + t] = total;
  if constexpr (kRgb) {
    shade_pixels(px, win, mats, first, b, K, H, W, scale, sun, rgb);
  } else {
    write_codes(out, px, b, H, W, scale);
  }
}

// K4
__global__ void __launch_bounds__(kThreads)
meshscene_strips_kernel(const float* __restrict__ cam_pos, const float* __restrict__ cam_att,
                        const float* __restrict__ windows, int* __restrict__ out,
                        int* __restrict__ nvis, int T, int K, int H, int W, float focal,
                        float scale, Frustum f) {
  strips_body<false>(cam_pos, cam_att, windows, nullptr, out, nullptr, nvis, T, K, H, W, focal,
                     scale, f, shade::Sun{});
}

// K4-rgb
__global__ void __launch_bounds__(kThreads)
meshscene_rgb_kernel(const float* __restrict__ cam_pos, const float* __restrict__ cam_att,
                     const float* __restrict__ windows, const int* __restrict__ mats,
                     unsigned char* __restrict__ rgb, int T, int K, int H, int W, float focal,
                     float far, Frustum f, shade::Sun sun) {
  strips_body<true>(cam_pos, cam_att, windows, mats, nullptr, rgb, nullptr, T, K, H, W, focal,
                    far, f, sun);
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
  Pixels<DepthBest> px = pixels_of<DepthBest>(cam_pos, cam_att, b, t, tx, H, W, focal);
  const float* win = windows + static_cast<int64_t>(b) * K * kRowWidth;
  for (int base = 0; base < K; base += kChunk) {
    int m = min(kChunk, K - base);
    const float* q = win + static_cast<int64_t>(base + tid) * kRowWidth;
    // thread i stages row i of the chunk
    Staged st = stage_rows<false>(q, tid < m ? row_kind(q) : 0, base + tid, px.c, srow,
                                  warp_rows);
    render_rows(srow, st, px);
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
  meshscene_strips_kernel<<<grid_of(B, H, W), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cam_pos, cam_att, windows, out, nvis, H / kTileH, K, H, W, focal, scale,
      Frustum{ex_min, ex_max, sx_min, sx_max, far});
  return static_cast<int>(cudaGetLastError());
}

extern "C" int meshscene_window_launch(const float* cam_pos, const float* cam_att,
                                       const float* windows, int* out, int B, int K, int H,
                                       int W, float focal, float scale, void* stream) {
  if (B == 0) return 0;
  meshscene_window_kernel<<<grid_of(B, H, W), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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
      cam_pos, cam_att, windows, mats, rgb, H / kTileH, K, H, W, focal, far,
      Frustum{ex_min, ex_max, sx_min, sx_max, INFINITY}, shade::Sun{sun_x, sun_y, sun_z});
  return static_cast<int>(cudaGetLastError());
}
