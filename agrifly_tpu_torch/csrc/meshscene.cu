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
// 640 x 480 image: one wave at up to 8 resident blocks a SM. Its 256
// threads are 8 warps of 2 image rows x 16 columns; a thread owns two
// pixels, columns x and x + 16 of its row, so the block's fixed costs (the
// camera, the culling) and each staged row's loads serve two pixels. The
// block's primitive rows are staged in shared memory 256 at a time (10 KB),
// and every thread tests the same row in lockstep, so the switch on the
// row's kind is uniform across the warp, as Pallas's lax.switch is per tile.
// A sphere or cylinder that the ray misses costs no square root or divide.
//
// K4 does the strip culling itself (one launch from the frame's window, no
// strips table in device memory): for each chunk of the window, thread i
// computes row i's bounding sphere and camera-frame centre and tests it
// against its strip's five halfspaces; the passing rows are compacted into
// shared memory in window order by warp ballots and a prefix count over the
// warps, and the block renders only them. Every block of a strip repeats
// the strip's culling, at most one window row a thread.
// `nvis`, where it is not null, receives each strip's count of passing rows
// (strip_windows' n_vis).
//
// What bounds it on the card: arithmetic. A pixel reads 7 camera scalars
// and its rows from shared memory and writes one int32, but runs ~40-60
// float operations per row (sphere, z-cylinder, Moller-Trumbore triangle)
// over n_vis rows (a few to a few tens after strip culling); every
// intermediate stays in registers. The world-from-camera matrix is built in
// the kernel from the camera quaternion (rotation.py::to_matrix's
// operations), so the wrapper launches nothing before the kernel.

#include <cuda_runtime.h>
#include <stdint.h>

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

// A miss (disc < 0, or NaN) returns BIG before the square root and the
// divides, and the far root only where the near one is not ahead: the
// plain version computes all and selects, with the same result.
__device__ __forceinline__ float sphere_hit(const Camera& c, const Dir& d, const float* p) {
  float ox = c.x - p[0], oy = c.y - p[1], oz = c.z - p[2];
  float a = d.x * d.x + d.y * d.y + d.z * d.z;
  float bq = 2.0f * (ox * d.x + oy * d.y + oz * d.z);
  float cc = ox * ox + oy * oy + oz * oz - p[3] * p[3];
  float disc = bq * bq - 4.0f * a * cc;
  if (!(disc >= 0.0f)) return kBig;
  float sq = sqrtf(disc);
  float t0 = (-bq - sq) / (2.0f * a);
  if (t0 > 0.0f) return t0;
  float t1 = (-bq + sq) / (2.0f * a);
  return t1 > 0.0f ? t1 : kBig;
}

// z-axis cylinder (cx, cy, z0, z1, r)
__device__ __forceinline__ float cylinder_hit(const Camera& c, const Dir& d, const float* p) {
  float ox = c.x - p[0], oy = c.y - p[1];
  float ca = d.x * d.x + d.y * d.y;
  float cb = 2.0f * (ox * d.x + oy * d.y);
  float cc = ox * ox + oy * oy - p[4] * p[4];
  float disc = cb * cb - 4.0f * ca * cc;
  if (!(disc >= 0.0f && ca > 1e-12f)) return kBig;
  float sq = sqrtf(disc);
  float tc = (-cb - sq) / (2.0f * ca);
  if (!(tc > 0.0f)) tc = (-cb + sq) / (2.0f * ca);
  float z = c.z + tc * d.z;
  return (tc > 0.0f && z >= p[2] && z <= p[3]) ? tc : kBig;
}

// Moller-Trumbore with v0 = p[0:3], e1 = p[3:6], e2 = p[6:9]
__device__ __forceinline__ float triangle_hit(const Camera& c, const Dir& d, const float* p) {
  float e1x = p[3], e1y = p[4], e1z = p[5];
  float e2x = p[6], e2y = p[7], e2z = p[8];
  float pvx = d.y * e2z - d.z * e2y;
  float pvy = d.z * e2x - d.x * e2z;
  float pvz = d.x * e2y - d.y * e2x;
  float det = pvx * e1x + pvy * e1y + pvz * e1z;
  float inv_det = 1.0f / (fabsf(det) < 1e-12f ? 1.0f : det);
  float tvx = c.x - p[0], tvy = c.y - p[1], tvz = c.z - p[2];
  float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  float qvx = tvy * e1z - tvz * e1y;
  float qvy = tvz * e1x - tvx * e1z;
  float qvz = tvx * e1y - tvy * e1x;
  float v = (qvx * d.x + qvy * d.y + qvz * d.z) * inv_det;
  float tt = (qvx * e2x + qvy * e2y + qvz * e2z) * inv_det;
  bool ok = fabsf(det) >= 1e-12f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && tt > 0.0f;
  return ok ? tt : kBig;
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
// and x + 16 of row y: the camera, the two rays and their ground-plane t.
struct Pixels {
  int x, y;
  Camera c;
  Dir d[2];
  float best[2];
};

__device__ __forceinline__ Pixels pixels_of(const float* __restrict__ cam_pos,
                                            const float* __restrict__ cam_att, int b, int t,
                                            int tx, int H, int W, float focal) {
  int tid = static_cast<int>(threadIdx.x);
  Pixels px;
  px.x = tx * kTileW + (tid & (kHalfW - 1));
  px.y = t * kTileH + tid / kHalfW;
  px.c = camera_of(cam_pos, cam_att, b);
  const float* R = px.c.R;
  float row = (static_cast<float>(px.y) - static_cast<float>(H) * 0.5f) / focal;
  for (int j = 0; j < 2; ++j) {
    float col = (static_cast<float>(px.x + j * kHalfW) - static_cast<float>(W) * 0.5f) / focal;
    Dir d{R[0] * col + R[1] * row + R[2], R[3] * col + R[4] * row + R[5],
          R[6] * col + R[7] * row + R[8]};
    // ground plane z = 0
    float dz_safe = fabsf(d.z) < 1e-9f ? 1e-9f : d.z;
    float t_ground = -px.c.z / dz_safe;
    px.d[j] = d;
    px.best[j] = (t_ground > 0.0f && d.z != 0.0f) ? t_ground : kBig;
  }
  return px;
}

__device__ __forceinline__ float row_hit(int kind, const Camera& c, const Dir& d,
                                         const float* p) {
  switch (kind) {
    case 1: return sphere_hit(c, d, p);
    case 2: return cylinder_hit(c, d, p);
    case 3: return triangle_hit(c, d, p);
    default: return kBig;
  }
}

// both pixels' best over the n staged rows (n is the same for the whole block)
__device__ __forceinline__ void render_rows(const float* srow, int n, Pixels& px) {
  for (int i = 0; i < n; ++i) {
    const float* q = srow + i * kRowWidth;
    int kind = min(max(static_cast<int>(q[0]), 0), 3);
    px.best[0] = fminf(px.best[0], row_hit(kind, px.c, px.d[0], q + 1));
    px.best[1] = fminf(px.best[1], row_hit(kind, px.c, px.d[1], q + 1));
  }
}

__device__ __forceinline__ void write_codes(int* __restrict__ out, const Pixels& px, int b,
                                            int H, int W, float scale) {
  for (int j = 0; j < 2; ++j) {
    int x = px.x + j * kHalfW;
    if (x < W) {
      float code = fminf(fmaxf(floorf(px.best[j] / scale), 0.0f), 255.0f);
      out[(static_cast<int64_t>(b) * H + px.y) * W + x] = static_cast<int>(code);
    }
  }
}

// K4: windows (B, K, 10); block (t * ntx + tx, b)
__global__ void __launch_bounds__(kThreads)
meshscene_strips_kernel(const float* __restrict__ cam_pos, const float* __restrict__ cam_att,
                        const float* __restrict__ windows, int* __restrict__ out,
                        int* __restrict__ nvis, int T, int K, int H, int W, float focal,
                        float scale, Frustum f) {
  __shared__ float srow[kChunk * kRowWidth];
  __shared__ int warp_rows[kWarps];
  int ntx = (W + kTileW - 1) / kTileW;
  int t = static_cast<int>(blockIdx.x) / ntx;
  int tx = static_cast<int>(blockIdx.x) % ntx;
  int b = static_cast<int>(blockIdx.y);
  int tid = static_cast<int>(threadIdx.x), warp = tid >> 5, lane = tid & 31;
  Pixels px = pixels_of(cam_pos, cam_att, b, t, tx, H, W, focal);

  // strip t's vertical halfspaces (strip_windows' ey_min, ey_max, sy_min, sy_max)
  float ys = static_cast<float>(t * kTileH);
  float half_h = static_cast<float>(H) * 0.5f;
  float ey_min = (ys - half_h) / focal;
  float ey_max = (ys + static_cast<float>(kTileH - 1) - half_h) / focal;
  float sy_min = sqrtf(1.0f + ey_min * ey_min);
  float sy_max = sqrtf(1.0f + ey_max * ey_max);

  const float* win = windows + static_cast<int64_t>(b) * K * kRowWidth;
  int total = 0;
  // every thread reaches each barrier: the loop bounds are the block's
  for (int base = 0; base < K; base += kChunk) {
    int m = min(kChunk, K - base);
    const float* q = win + static_cast<int64_t>(base + tid) * kRowWidth;
    bool vis = tid < m && strip_visible(q, px.c, ey_min, ey_max, sy_min, sy_max, f);
    unsigned ballot = __ballot_sync(0xffffffffu, vis);
    __syncthreads();  // the previous chunk is consumed
    if (lane == 0) warp_rows[warp] = __popc(ballot);
    __syncthreads();
    int at = 0, n = 0;
    for (int w = 0; w < kWarps; ++w) {
      at += w < warp ? warp_rows[w] : 0;
      n += warp_rows[w];
    }
    if (vis) {
      float* dst = srow + (at + __popc(ballot & ((1u << lane) - 1u))) * kRowWidth;
      for (int k = 0; k < kRowWidth; ++k) dst[k] = q[k];
    }
    __syncthreads();
    render_rows(srow, n, px);
    total += n;
  }
  if (nvis != nullptr && tx == 0 && tid == 0) nvis[static_cast<int64_t>(b) * T + t] = total;
  write_codes(out, px, b, H, W, scale);
}

// K4w: windows (B, K, 10), every row for every strip
__global__ void __launch_bounds__(kThreads)
meshscene_window_kernel(const float* __restrict__ cam_pos, const float* __restrict__ cam_att,
                        const float* __restrict__ windows, int* __restrict__ out, int K, int H,
                        int W, float focal, float scale) {
  __shared__ float srow[kChunk * kRowWidth];
  int ntx = (W + kTileW - 1) / kTileW;
  int t = static_cast<int>(blockIdx.x) / ntx;
  int tx = static_cast<int>(blockIdx.x) % ntx;
  int b = static_cast<int>(blockIdx.y);
  int tid = static_cast<int>(threadIdx.x);
  Pixels px = pixels_of(cam_pos, cam_att, b, t, tx, H, W, focal);
  const float* win = windows + static_cast<int64_t>(b) * K * kRowWidth;
  for (int base = 0; base < K; base += kChunk) {
    int m = min(kChunk, K - base);
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < m * kRowWidth; i += kThreads) {
      srow[i] = win[static_cast<int64_t>(base) * kRowWidth + i];
    }
    __syncthreads();
    render_rows(srow, m, px);
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
