// Imported-world depth raycaster: the strip-culled kernel (K4) and the
// window kernel (K4w).
//
// Replaces the TPU kernels of agrifly_tpu/render/pallas_meshscene.py:
// _strip_kernel (launched by render_depth_strips_batch, the default of
// render_depth_batch) and _kernel (render_depth_window_batch). They
// compute exactly what agrifly_tpu_torch/render/meshscene.py computes in
// render_strips and render_depth_window, with the same float32 operations
// in the same order (the JAX kernel's _hit_branches), so their int32 codes
// equal the plain versions' bit for bit. That needs the build flags of
// cuda_build.py: -fmad=false and no fast math (IEEE division and sqrt).
//
// Layout: one block per (16 x 32 pixel tile, vehicle). Its 512 threads are
// 16 image rows of one warp each; a thread owns one pixel. The block's
// primitive rows (a strip's n_vis compacted rows for K4, all K window rows
// for K4w) are staged in shared memory, 192 rows (7.5 KB) at a time, and
// every thread tests the same row in lockstep, so the switch on the row's
// kind is uniform across the warp, as Pallas's lax.switch is per tile.
//
// What bounds it on the card: arithmetic. A pixel reads 12 camera scalars
// and its rows from shared memory and writes one int32, but runs ~40-60
// float operations per row (sphere, z-cylinder, Moller-Trumbore triangle)
// over n_vis rows (a few to a few tens after strip culling). At 640x480 the
// 307k threads of one frame fill all 132 SMs; every intermediate stays in
// registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e9f;
constexpr int kRowWidth = 10;  // [kind, p0..p8]
constexpr int kTileH = 16;     // image rows per strip (pallas_meshscene.TILE_H)
constexpr int kTileW = 32;     // image columns per block: one warp per row
constexpr int kChunk = 192;    // rows staged in shared memory at a time

struct Cam {
  float x, y, z;
};

struct Dir {
  float x, y, z;
};

__device__ __forceinline__ float sphere_hit(const Cam& c, const Dir& d, const float* p) {
  float ox = c.x - p[0], oy = c.y - p[1], oz = c.z - p[2];
  float a = d.x * d.x + d.y * d.y + d.z * d.z;
  float bq = 2.0f * (ox * d.x + oy * d.y + oz * d.z);
  float cc = ox * ox + oy * oy + oz * oz - p[3] * p[3];
  float disc = bq * bq - 4.0f * a * cc;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float t0 = (-bq - sq) / (2.0f * a);
  float t1 = (-bq + sq) / (2.0f * a);
  float ts = t0 > 0.0f ? t0 : t1;
  return (disc >= 0.0f && ts > 0.0f) ? ts : kBig;
}

// z-axis cylinder (cx, cy, z0, z1, r)
__device__ __forceinline__ float cylinder_hit(const Cam& c, const Dir& d, const float* p) {
  float ox = c.x - p[0], oy = c.y - p[1];
  float ca = d.x * d.x + d.y * d.y;
  float cb = 2.0f * (ox * d.x + oy * d.y);
  float cc = ox * ox + oy * oy - p[4] * p[4];
  float disc = cb * cb - 4.0f * ca * cc;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float ca_safe = ca > 1e-12f ? ca : 1.0f;
  float t0 = (-cb - sq) / (2.0f * ca_safe);
  float t1 = (-cb + sq) / (2.0f * ca_safe);
  float tc = t0 > 0.0f ? t0 : t1;
  float z = c.z + tc * d.z;
  bool ok = disc >= 0.0f && ca > 1e-12f && tc > 0.0f && z >= p[2] && z <= p[3];
  return ok ? tc : kBig;
}

// Moller-Trumbore with v0 = p[0:3], e1 = p[3:6], e2 = p[6:9]
__device__ __forceinline__ float triangle_hit(const Cam& c, const Dir& d, const float* p) {
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

// One block renders the 16 x 32 tile (strip t, column tile tx) of vehicle b
// against its n rows (row-major, kRowWidth floats each).
__device__ __forceinline__ void render_tile(const float* __restrict__ cam,
                                            const float* __restrict__ rows, int n,
                                            int* __restrict__ out, int b, int t,
                                            int tx, int H, int W, float focal,
                                            float scale) {
  __shared__ float srow[kChunk * kRowWidth];
  int x = tx * kTileW + static_cast<int>(threadIdx.x);
  int y = t * kTileH + static_cast<int>(threadIdx.y);
  int tid = static_cast<int>(threadIdx.y * blockDim.x + threadIdx.x);
  int nthreads = static_cast<int>(blockDim.x * blockDim.y);

  const float* s = cam + static_cast<int64_t>(b) * 12;
  Cam c{s[0], s[1], s[2]};
  float col = (static_cast<float>(x) - static_cast<float>(W) * 0.5f) / focal;
  float row = (static_cast<float>(y) - static_cast<float>(H) * 0.5f) / focal;
  Dir d{s[3] * col + s[4] * row + s[5], s[6] * col + s[7] * row + s[8],
        s[9] * col + s[10] * row + s[11]};

  // ground plane z = 0
  float dz_safe = fabsf(d.z) < 1e-9f ? 1e-9f : d.z;
  float t_ground = -c.z / dz_safe;
  float best = (t_ground > 0.0f && d.z != 0.0f) ? t_ground : kBig;

  // n is the same for the whole block, so every thread reaches each barrier
  for (int base = 0; base < n; base += kChunk) {
    int m = min(kChunk, n - base);
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < m * kRowWidth; i += nthreads) {
      srow[i] = rows[static_cast<int64_t>(base) * kRowWidth + i];
    }
    __syncthreads();
    for (int i = 0; i < m; ++i) {
      const float* q = srow + i * kRowWidth;
      int kind = min(max(static_cast<int>(q[0]), 0), 3);
      float tt;
      switch (kind) {
        case 1: tt = sphere_hit(c, d, q + 1); break;
        case 2: tt = cylinder_hit(c, d, q + 1); break;
        case 3: tt = triangle_hit(c, d, q + 1); break;
        default: tt = kBig; break;
      }
      best = fminf(best, tt);
    }
  }

  if (x < W) {
    float code = fminf(fmaxf(floorf(best / scale), 0.0f), 255.0f);
    out[(static_cast<int64_t>(b) * H + y) * W + x] = static_cast<int>(code);
  }
}

// K4: strips (B, T, K, 10), nvis (B, T); block (t * ntx + tx, b)
__global__ void __launch_bounds__(kTileW * kTileH)
meshscene_strips_kernel(const float* __restrict__ cam, const int* __restrict__ nvis,
                        const float* __restrict__ strips, int* __restrict__ out, int T,
                        int K, int H, int W, float focal, float scale) {
  int ntx = (W + kTileW - 1) / kTileW;
  int t = static_cast<int>(blockIdx.x) / ntx;
  int tx = static_cast<int>(blockIdx.x) % ntx;
  int b = static_cast<int>(blockIdx.y);
  int64_t strip = static_cast<int64_t>(b) * T + t;
  int n = min(max(nvis[strip], 0), K);
  render_tile(cam, strips + strip * K * kRowWidth, n, out, b, t, tx, H, W, focal, scale);
}

// K4w: windows (B, K, 10), every row for every strip
__global__ void __launch_bounds__(kTileW * kTileH)
meshscene_window_kernel(const float* __restrict__ cam, const float* __restrict__ windows,
                        int* __restrict__ out, int K, int H, int W, float focal,
                        float scale) {
  int ntx = (W + kTileW - 1) / kTileW;
  int t = static_cast<int>(blockIdx.x) / ntx;
  int tx = static_cast<int>(blockIdx.x) % ntx;
  int b = static_cast<int>(blockIdx.y);
  render_tile(cam, windows + static_cast<int64_t>(b) * K * kRowWidth, K, out, b, t, tx, H,
              W, focal, scale);
}

dim3 grid_of(int B, int H, int W) {
  return dim3(static_cast<unsigned>(((W + kTileW - 1) / kTileW) * (H / kTileH)),
              static_cast<unsigned>(B));
}

}  // namespace

// cam: (B, 12) float32 [px, py, pz, R00..R22] (world-from-camera R); out:
// (B, H, W) int32 codes; H a multiple of 16; scale = far / 256.
extern "C" int meshscene_strips_launch(const float* cam, const int* nvis, const float* strips,
                                       int* out, int B, int K, int H, int W, float focal,
                                       float scale, void* stream) {
  if (B == 0) return 0;
  meshscene_strips_kernel<<<grid_of(B, H, W), dim3(kTileW, kTileH), 0,
                            static_cast<cudaStream_t>(stream)>>>(
      cam, nvis, strips, out, H / kTileH, K, H, W, focal, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int meshscene_window_launch(const float* cam, const float* windows, int* out, int B,
                                       int K, int H, int W, float focal, float scale,
                                       void* stream) {
  if (B == 0) return 0;
  meshscene_window_kernel<<<grid_of(B, H, W), dim3(kTileW, kTileH), 0,
                            static_cast<cudaStream_t>(stream)>>>(
      cam, windows, out, K, H, W, focal, scale);
  return static_cast<int>(cudaGetLastError());
}
