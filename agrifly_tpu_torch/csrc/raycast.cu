// Orchard depth raycaster: one thread per output pixel.
//
// Replaces the TPU kernel agrifly_tpu/render/pallas_raycast.py
// (_kernel / _tree_hit_tile, launched by render_depth_batch). It computes
// exactly what agrifly_tpu_torch/render/raycast.py::render_depth computes,
// with the same float32 operations in the same order, so its int32 codes
// equal the plain version's bit for bit. That needs the build flags of
// cuda_build.py: -fmad=false and no fast math (IEEE division and sqrt).
//
// What bounds it on the card: arithmetic. A pixel reads 12 camera scalars
// and 10 scene scalars (cached) and writes one int32, but runs 8 DDA cells x
// (5 integer hashes + 1 cylinder + 2 sphere intersections), ~600 float and
// integer operations. At 640x480 that is ~2e8 operations, a few tens of
// microseconds on an H100; the design keeps every intermediate in registers
// and launches one thread per pixel so 300k threads fill all 132 SMs.
//
// Signed overflow is undefined in C++, so the int32 hash multiplies in
// uint32 and reinterprets; >> stays an arithmetic shift on the signed value
// (the JAX package and PyTorch wrap int32 the same way).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e9f;

struct Scene {
  float row_spacing, tree_spacing, presence, jitter, trunk_radius,
      trunk_height, canopy_radius, canopy_height, clear_radius;
  int seed;
};

__device__ __forceinline__ int wrap_mul(int a, uint32_t b) {
  return static_cast<int>(static_cast<uint32_t>(a) * b);
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ float cell_rand(int ix, int iy, int seed, int salt) {
  int h = wrap_add(wrap_mul(ix, 374761393u), wrap_mul(iy, 668265263u));
  h = wrap_add(wrap_add(h, wrap_mul(seed, 974634599u)), salt * 1446648);
  h = h ^ (h >> 13);
  h = wrap_mul(h, 1274126177u);
  h = h ^ (h >> 16);
  return static_cast<float>(h & 0x7FFFFF) / 8388608.0f;
}

__device__ __forceinline__ float sphere_hit(float ox, float oy, float oz,
                                            float dx, float dy, float dz,
                                            float cx, float cy, float cz,
                                            float r) {
  float sx = ox - cx, sy = oy - cy, sz = oz - cz;
  float a = dx * dx + dy * dy + dz * dz;
  float b = 2.0f * (sx * dx + sy * dy + sz * dz);
  float c = sx * sx + sy * sy + sz * sz - r * r;
  float disc = b * b - 4.0f * a * c;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float s0 = (-b - sq) / (2.0f * a);
  float s1 = (-b + sq) / (2.0f * a);
  float s = s0 > 0.0f ? s0 : s1;
  return (disc >= 0.0f && s > 0.0f) ? s : kBig;
}

__device__ __forceinline__ float tree_hit(const Scene& sc, int ix, int iy,
                                          float ox, float oy, float oz,
                                          float dx, float dy, float dz) {
  float r0 = cell_rand(ix, iy, sc.seed, 0);
  float r1 = cell_rand(ix, iy, sc.seed, 1);
  float r2 = cell_rand(ix, iy, sc.seed, 2);
  float r3 = cell_rand(ix, iy, sc.seed, 3);
  float r4 = cell_rand(ix, iy, sc.seed, 4);
  float cx = (static_cast<float>(ix) + 0.5f) * sc.tree_spacing + (r1 - 0.5f) * 2.0f * sc.jitter;
  float cy = (static_cast<float>(iy) + 0.5f) * sc.row_spacing + (r2 - 0.5f) * 2.0f * sc.jitter;
  bool present = (r0 < sc.presence) && (sqrtf(cx * cx + cy * cy) > sc.clear_radius);
  float size = 0.8f + 0.4f * r3;
  float can_r = sc.canopy_radius * size;
  float can_h = sc.canopy_height * size;
  float trunk_r = sc.trunk_radius * size;
  float trunk_h = sc.trunk_height * size;

  // trunk cylinder
  float rx = ox - cx, ry = oy - cy;
  float a = dx * dx + dy * dy;
  float b = 2.0f * (rx * dx + ry * dy);
  float c = rx * rx + ry * ry - trunk_r * trunk_r;
  float disc = b * b - 4.0f * a * c;
  bool ok = (disc >= 0.0f) && (a > 1e-12f);
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float a_safe = a > 1e-12f ? a : 1.0f;
  float t0 = (-b - sq) / (2.0f * a_safe);
  float t1 = (-b + sq) / (2.0f * a_safe);
  float t = t0 > 0.0f ? t0 : t1;
  float z = oz + t * dz;
  float t_trunk = (ok && t > 0.0f && z >= 0.0f && z <= trunk_h) ? t : kBig;

  float t_c1 = sphere_hit(ox, oy, oz, dx, dy, dz, cx, cy, can_h, can_r);
  float t_c2 = sphere_hit(ox, oy, oz, dx, dy, dz,
                          cx + (r4 - 0.5f) * 0.6f, cy + (r2 - 0.5f) * 0.6f,
                          can_h + 0.8f * can_r, can_r * 0.7f);
  float tt = fminf(t_trunk, fminf(t_c1, t_c2));
  return present ? tt : kBig;
}

__global__ void raycast_kernel(const float* __restrict__ cam,
                               const float* __restrict__ scene_f,
                               const int* __restrict__ seed,
                               int* __restrict__ out, int B, int H, int W,
                               float focal, float scale, int dda_steps) {
  int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t n = static_cast<int64_t>(B) * H * W;
  if (idx >= n) return;
  int x = static_cast<int>(idx % W);
  int y = static_cast<int>((idx / W) % H);
  int bi = static_cast<int>(idx / (static_cast<int64_t>(W) * H));

  Scene sc{scene_f[0], scene_f[1], scene_f[2], scene_f[3], scene_f[4],
           scene_f[5], scene_f[6], scene_f[7], scene_f[8], seed[0]};
  const float* s = cam + bi * 12;
  float px = s[0], py = s[1], pz = s[2];
  float R00 = s[3], R01 = s[4], R02 = s[5];
  float R10 = s[6], R11 = s[7], R12 = s[8];
  float R20 = s[9], R21 = s[10], R22 = s[11];

  float col = (static_cast<float>(x) - static_cast<float>(W) * 0.5f) / focal;
  float row = (static_cast<float>(y) - static_cast<float>(H) * 0.5f) / focal;
  float dx = R00 * col + R01 * row + R02;
  float dy = R10 * col + R11 * row + R12;
  float dz = R20 * col + R21 * row + R22;

  // ground plane z = 0
  float dz_safe = fabsf(dz) < 1e-9f ? 1e-9f : dz;
  float t_ground = -pz / dz_safe;
  float best = (t_ground > 0.0f && dz != 0.0f) ? t_ground : kBig;

  // 2-D DDA over orchard cells
  float fx = px / sc.tree_spacing;
  float fy = py / sc.row_spacing;
  int ix = static_cast<int>(floorf(fx));
  int iy = static_cast<int>(floorf(fy));
  float gdx = dx / sc.tree_spacing;
  float gdy = dy / sc.row_spacing;
  int step_x = gdx >= 0.0f ? 1 : -1;
  int step_y = gdy >= 0.0f ? 1 : -1;
  float inv_dx = 1.0f / (fabsf(gdx) < 1e-9f ? (gdx >= 0.0f ? 1e-9f : -1e-9f) : gdx);
  float inv_dy = 1.0f / (fabsf(gdy) < 1e-9f ? (gdy >= 0.0f ? 1e-9f : -1e-9f) : gdy);
  float next_x = (static_cast<float>(ix) + (step_x > 0 ? 1.0f : 0.0f) - fx) * inv_dx;
  float next_y = (static_cast<float>(iy) + (step_y > 0 ? 1.0f : 0.0f) - fy) * inv_dy;
  float t_dx = fabsf(inv_dx);
  float t_dy = fabsf(inv_dy);

  for (int k = 0; k < dda_steps; ++k) {
    best = fminf(best, tree_hit(sc, ix, iy, px, py, pz, dx, dy, dz));
    bool go_x = next_x <= next_y;
    if (go_x) {
      ix += step_x;
      next_x = next_x + t_dx;
    } else {
      iy += step_y;
      next_y = next_y + t_dy;
    }
  }

  float code = fminf(fmaxf(floorf(best / scale), 0.0f), 255.0f);
  out[idx] = static_cast<int>(code);
}

}  // namespace

// cam: (B, 12) float32 [px, py, pz, R00..R22]; scene: 9 float32 (order of
// orchard.FLOAT_FIELDS); seed: 1 int32; out: (B, H, W) int32.
extern "C" int raycast_launch(const float* cam, const float* scene,
                              const int* seed, int* out, int B, int H, int W,
                              float focal, float scale, int dda_steps,
                              void* stream) {
  int64_t n = static_cast<int64_t>(B) * H * W;
  int threads = 256;
  int blocks = static_cast<int>((n + threads - 1) / threads);
  raycast_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      cam, scene, seed, out, B, H, W, focal, scale, dda_steps);
  return static_cast<int>(cudaGetLastError());
}
