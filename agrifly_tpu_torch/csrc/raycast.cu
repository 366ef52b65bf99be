// Orchard depth raycaster: one thread per output pixel, a warp per 8 x 4
// pixel tile, with an exact early exit from the cell march.
//
// Replaces the TPU kernel agrifly_tpu/render/pallas_raycast.py
// (_kernel / _tree_hit_tile, launched by render_depth_batch). Its codes
// equal agrifly_tpu_torch/render/raycast.py::render_depth's bit for bit: the
// ray, the ground plane, the DDA and every tree it evaluates use the plain
// version's float32 operations in their order. That needs the build flags
// of cuda_build.py: -fmad=false and no fast math (IEEE division and sqrt).
// raycast.py::render_depth_exit is the plain mirror of this kernel's
// traversal (the cells it evaluates, and where it stops).
//
// What bounds it on the card: arithmetic. A pixel reads 7 camera scalars
// and 10 scene scalars (cached) and writes one int32; the reference's work
// is 8 DDA cells x (5 integer hashes + 1 cylinder + 2 sphere intersections,
// with IEEE divides and square roots). The design does less of that work:
//
// - Early exit. Every tree lies inside its own grid cell (orchard.py
//   make_params' premise, which the kernel re-checks from the scene table:
//   `contained`), so once the ray cannot reach the next cell before
//   min(best, 256 * scale), no later cell can change the code, and the
//   march stops. A ray crosses ~2-3 cells before its first hit or the far
//   clip instead of 8.
// - A cell whose tree is absent skips the intersections (its hit is BIG in
//   the plain version too).
// - A warp is an 8 x 4 pixel tile, so its lanes walk the same cells and
//   leave the loop together; blocks are 4 warps (a 16 x 8 tile) so that
//   the card's block scheduler balances the tiles' uneven costs over the
//   SMs at a fine grain (2400 blocks an image).
// - The world-from-camera matrix is built in the kernel from the camera
//   quaternion (rotation.py::to_matrix's operations), so the wrapper
//   launches nothing before the kernel.
//
// The RGB pass (K1-rgb, raycast_rgb_kernel) is a second instance of the
// same pixel body. It replaces no TPU kernel: the JAX package renders its
// RGB image with jnp (agrifly_tpu/render/raycast.py render_rgb), which the
// card would run at eager speed, one launch per operation. Its bytes equal
// agrifly_tpu_torch/render/raycast.py::render_rgb's bit for bit: the same
// march, keeping the nearest cell's tree (strictly nearer, so the earlier
// cell wins a tie) with its material and cell, then the normal from that
// cell's tree and the shading of csrc/shade.cuh. It also exits early, once
// no later cell can come nearer than best itself: a tree beyond the far
// plane still shades (hazed), so the depth pass's far cap does not apply.
// In its place a ray that climbs stops once it has cleared the canopy
// (clear_after): past a t where the ray runs above every tree top it can
// meet no tree, so it stops where the march to that t has left the current
// cell behind, as it does at best (a ray that points up and meets nothing
// would otherwise march all cells). It writes a
// pixel's three bytes from its thread: a warp's 8 x 4 tile stores four
// runs of 24 contiguous bytes. Its bound, as K1's, is arithmetic: the
// march, plus a winner (a compare and three selects a cell), one more tree
// evaluation and ~3 square roots and 3 divides a pixel for the shading.
//
// Signed overflow is undefined in C++, so the int32 hash multiplies in
// uint32 and reinterprets; >> stays an arithmetic shift on the signed value
// (the JAX package and PyTorch wrap int32 the same way).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "shade.cuh"

namespace {

constexpr float kBig = 1e9f;
constexpr int kTileW = 16;  // block tile: 2 x 2 warps of 8 x 4 pixels
constexpr int kTileH = 8;
constexpr int kThreads = 128;

// The early exit's float margins (see beyond_next_cells)
constexpr float kReachRel = 1.0f + 0.00006103515625f;  // 1 + 2^-14
constexpr float kReachAbs = 0.00006103515625f;         // 2^-14
constexpr float kSlackSqrt = 0.001953125f;             // 2^-9
constexpr float kSlackLin = 0.000003814697265625f;     // 2^-18

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

// A miss (disc < 0, or NaN) returns BIG before the square root and the
// divides, and the far root only where the near one is not ahead: the
// plain version computes all and selects, with the same result.
__device__ __forceinline__ float sphere_hit(float ox, float oy, float oz,
                                            float dx, float dy, float dz,
                                            float cx, float cy, float cz,
                                            float r) {
  float sx = ox - cx, sy = oy - cy, sz = oz - cz;
  float a = dx * dx + dy * dy + dz * dz;
  float b = 2.0f * (sx * dx + sy * dy + sz * dz);
  float c = sx * sx + sy * sy + sz * sz - r * r;
  float disc = b * b - 4.0f * a * c;
  if (!(disc >= 0.0f)) return kBig;
  float sq = sqrtf(disc);
  float s0 = (-b - sq) / (2.0f * a);
  if (s0 > 0.0f) return s0;
  float s1 = (-b + sq) / (2.0f * a);
  return s1 > 0.0f ? s1 : kBig;
}

// Cell (ix, iy)'s tree: orchard.py::tree_fields' operations. tree_centre
// computes the first three hashes, the trunk's centre and whether the tree
// is present; tree_size the rest, from the same hashes.
struct Tree {
  float cx, cy, r2;  // r2: the third hash, which the second canopy sphere reuses
  float trunk_r, trunk_h, can_r, can_h, c2x, c2y, c2z, c2r;
};

__device__ __forceinline__ bool tree_centre(const Scene& sc, int ix, int iy, Tree& t) {
  float r0 = cell_rand(ix, iy, sc.seed, 0);
  float r1 = cell_rand(ix, iy, sc.seed, 1);
  t.r2 = cell_rand(ix, iy, sc.seed, 2);
  t.cx = (static_cast<float>(ix) + 0.5f) * sc.tree_spacing + (r1 - 0.5f) * 2.0f * sc.jitter;
  t.cy = (static_cast<float>(iy) + 0.5f) * sc.row_spacing + (t.r2 - 0.5f) * 2.0f * sc.jitter;
  return (r0 < sc.presence) && (sqrtf(t.cx * t.cx + t.cy * t.cy) > sc.clear_radius);
}

__device__ __forceinline__ void tree_size(const Scene& sc, int ix, int iy, Tree& t) {
  float r3 = cell_rand(ix, iy, sc.seed, 3);
  float r4 = cell_rand(ix, iy, sc.seed, 4);
  float size = 0.8f + 0.4f * r3;
  t.can_r = sc.canopy_radius * size;
  t.can_h = sc.canopy_height * size;
  t.trunk_r = sc.trunk_radius * size;
  t.trunk_h = sc.trunk_height * size;
  t.c2x = t.cx + (r4 - 0.5f) * 0.6f;
  t.c2y = t.cy + (t.r2 - 0.5f) * 0.6f;
  t.c2z = t.can_h + 0.8f * t.can_r;
  t.c2r = t.can_r * 0.7f;
}

// the trunk cylinder's t, BIG for a miss (which skips the root, as in
// sphere_hit)
__device__ __forceinline__ float trunk_hit(const Tree& tr, float ox, float oy, float oz,
                                           float dx, float dy, float dz) {
  float rx = ox - tr.cx, ry = oy - tr.cy;
  float a = dx * dx + dy * dy;
  float b = 2.0f * (rx * dx + ry * dy);
  float c = rx * rx + ry * ry - tr.trunk_r * tr.trunk_r;
  float disc = b * b - 4.0f * a * c;
  if (disc >= 0.0f && a > 1e-12f) {
    float sq = sqrtf(disc);
    float t = (-b - sq) / (2.0f * a);
    if (!(t > 0.0f)) t = (-b + sq) / (2.0f * a);
    float z = oz + t * dz;
    if (t > 0.0f && z >= 0.0f && z <= tr.trunk_h) return t;
  }
  return kBig;
}

// the two canopy spheres' nearer t
__device__ __forceinline__ float canopy_hit(const Tree& tr, float ox, float oy, float oz,
                                            float dx, float dy, float dz) {
  float t_c1 = sphere_hit(ox, oy, oz, dx, dy, dz, tr.cx, tr.cy, tr.can_h, tr.can_r);
  float t_c2 = sphere_hit(ox, oy, oz, dx, dy, dz, tr.c2x, tr.c2y, tr.c2z, tr.c2r);
  return fminf(t_c1, t_c2);
}

// t of the first hit with the tree of cell (ix, iy), BIG for none or an
// absent tree (whose intersections are skipped: the plain version's BIG).
__device__ __forceinline__ float tree_hit(const Scene& sc, int ix, int iy,
                                          float ox, float oy, float oz,
                                          float dx, float dy, float dz) {
  Tree tr;
  if (!tree_centre(sc, ix, iy, tr)) return kBig;
  tree_size(sc, ix, iy, tr);
  return fminf(trunk_hit(tr, ox, oy, oz, dx, dy, dz), canopy_hit(tr, ox, oy, oz, dx, dy, dz));
}

// Whether every tree lies inside its own cell, from the scene's fields:
// the largest xy reach of a tree from its cell's centre is the jitter plus
// the widest of the trunk (1.2 trunk_radius), the first canopy sphere (1.2
// canopy_radius) and the second (offset up to 0.3 m, radius 0.84
// canopy_radius); 1.2 is the largest size factor. orchard.py::contained is
// its plain version.
__device__ __forceinline__ bool contained(const Scene& sc) {
  float jit = fabsf(sc.jitter), can = fabsf(sc.canopy_radius);
  float half = 0.5f * fminf(sc.tree_spacing, sc.row_spacing);
  // each reach tested alone, so that a NaN field fails the test
  return sc.tree_spacing > 0.0f && sc.row_spacing > 0.0f &&
         jit + 1.2f * fabsf(sc.trunk_radius) <= half && jit + 1.2f * can <= half &&
         jit + (0.3f + 0.84f * can) <= half;
}

// Whether the cells after (ix, iy) can no longer change the code. Each
// later cell of the march lies past the current cell's x boundary bx or its
// y boundary by (the DDA steps each index one way only), and its tree, hence
// any hit with it, lies inside it. So if the ray's xy position at t = reach
// has crossed neither boundary, every later hit has t > reach. reach is
// lim = min(best, 256 scale) widened: a hit beyond lim leaves the code as it
// is (it cannot lower best, and past 256 scale the code is 255 whatever
// the hit).
//
// The margins (u = 2^-24, the float32 unit roundoff). A computed root of the
// quadratic is, to within a relative 8u and an absolute ~u (|s| / |d|), the
// exact root for a tree whose centre moved by ~2u (|o| + |c|) and whose
// radius squared moved by ~6u |s|^2 (the discriminant's b^2 - 4ac rounds
// relative to b^2 ~ 4 |s|^2 |d|^2), s the ray origin less the centre: a
// radius change of at most sqrt(6u) |s| < 2^-10.7 |s|. For a hit at t <=
// reach, |s| <= reach (|dx| + |dy| + |dz|) + the tree's radius, and the
// radius is below half the cell (contained). Hence:
// - reach = lim (1 + 2^-14) + 2^-14 (S + R) covers the relative and absolute
//   error of t itself (8u lim and ~2u (lim + S + R), with room);
// - the boundaries are pulled toward the ray by slack = 2^-9 (reach
//   (|dx| + |dy| + |dz|) + S + R), which covers the radius change (2^-10.7
//   |s|) with room, plus 2^-18 (1 + |px| + |py| + |pz|), which covers the
//   rounding of the centres, the boundaries and px + reach dx (each a few u
//   of the positions, with the positions' own magnitudes).
// The slack is a few centimetres in a 4 x 6 m cell, so the exit comes
// almost as early as the exact geometry allows. A scene that fails
// `contained` never exits early: it marches all cells, as the plain version.
__device__ __forceinline__ bool beyond_next_cells(float best, float far256, float px, float py,
                                                  float dx, float dy, float adx, float po,
                                                  float sr, int ix, int iy, int step_x,
                                                  int step_y, const Scene& sc) {
  float lim = best < far256 ? best : far256;
  float reach = lim * kReachRel + kReachAbs * sr;
  float slack = kSlackSqrt * (reach * adx + sr) + kSlackLin * po;
  float qx = px + reach * dx;
  float qy = py + reach * dy;
  float bx = static_cast<float>(ix + (step_x > 0 ? 1 : 0)) * sc.tree_spacing;
  float by = static_cast<float>(iy + (step_y > 0 ? 1 : 0)) * sc.row_spacing;
  bool in_x = step_x > 0 ? qx <= bx - slack : qx >= bx + slack;
  bool in_y = step_y > 0 ? qy <= by - slack : qy >= by + slack;
  return in_x && in_y;
}

// The canopy's top: every tree's trunk and both canopy spheres lie below
// z_top = 1.2 max(|canopy_height| + 1.5 |canopy_radius|, |trunk_height|)
// (tree_size: the first sphere's top is at most (canopy_height +
// |canopy_radius|) size, the second's (canopy_height + 0.8 canopy_radius) size
// + 0.7 |canopy_radius| size, the trunk's trunk_height size, and size < 1.2).
// orchard.py::canopy_top is its plain version.
__device__ __forceinline__ float canopy_top(const Scene& sc) {
  return 1.2f * fmaxf(fabsf(sc.canopy_height) + 1.5f * fabsf(sc.canopy_radius),
                      fabsf(sc.trunk_height));
}

// The clear exit's constants (see clear_after)
constexpr float kClimb = 0.0078125f;              // 2^-7
constexpr float kClearSqrt = 0.00390625f;         // 2^-8
constexpr float kClearLin = 0.00000762939453125f; // 2^-17

// A t past which the ray (origin p, direction d) meets no tree, for the RGB
// pass's early exit: beyond_next_cells then stops the march once the ray
// cannot reach the next cell before min(best, this t). INFINITY where the
// ray does not climb steeply enough (dz <= 2^-7 (|dx| + |dy| + |dz|)), where
// best exceeds BIG (then a later cell's BIG, a miss, would still win), or
// where a field is NaN.
//
// The margins (u = 2^-24), as beyond_next_cells' for the same quadratic
// roots. A computed hit at t with a canopy sphere is an exact hit with the
// sphere moved by ~4u (|o| + z_top) and grown by sqrt(6u) |s| < 2^-10.7 (t
// adx + S + R) (s the origin less the centre, |s| <= t adx + R, R below
// half a cell), adx = |dx| + |dy| + |dz| >= |d|, and its t moves by 8u t + u
// |s| / |d|; the sphere's top, as tree_size rounds it, lies below z_top (1 +
// 3u). A computed trunk hit needs the rounded z = o_z + t d_z at most the
// rounded trunk height, and that z is within 2u (po + t adx) of the exact
// one. So no tree is met at a t where the exact z of the ray exceeds z_top +
// slack(t), slack(t) = 2^-9 (t adx + S + R) + 2^-18 (po + z_top), po = 1 +
// |px| + |py| + |pz|. That z less slack(t) grows with t where dz > 2^-9 adx,
// so it holds for every t >= T, T solved from the doubled slack: z_top +
// 2^-8 (T adx + S + R) + 2^-17 (po + z_top) = pz + T dz. With dz > 2^-7 adx
// the divisor is at least dz / 2, so T's rounding (a few u of the terms'
// magnitudes over the divisor) moves z(T) by less than the doubled slack's
// excess. T < 0 (the camera already above the top) gives 0. beyond_next_cells
// then shows every later hit to have t > min(best, T): a hit beyond best
// leaves the winner as it is, and there is none beyond T.
__device__ __forceinline__ float clear_after(const Scene& sc, float pz, float dz, float adx,
                                             float po, float sr, float best) {
  if (!(dz > kClimb * adx) || kBig < best) return INFINITY;
  float z_top = canopy_top(sc);
  float t = (z_top + kClearSqrt * sr + kClearLin * (po + z_top) - pz) / (dz - kClearSqrt * adx);
  return t >= 0.0f ? t : (t < 0.0f ? 0.0f : INFINITY);
}

// The RGB pass's march and shading tail (K1-rgb): raycast.py::render_rgb
// in its float32 operations. Each cell's tree is a candidate with its t
// (BIG for a miss or an absent tree) and material, and replaces the best
// only where strictly nearer, so the earlier cell wins a tie, as in the
// plain version's march. An absent tree's geometry is evaluated only where
// best > BIG (a ray within 1e-9 of horizontal whose ground t exceeds BIG):
// only then can its BIG win, and its material is read before the presence
// mask.
struct Winner {
  float t;
  int mat, ix, iy;
};

__device__ __forceinline__ void rgb_visit(const Scene& sc, int ix, int iy, float px, float py,
                                          float pz, float dx, float dy, float dz, Winner& w) {
  Tree tr;
  bool present = tree_centre(sc, ix, iy, tr);
  if (!present && !(kBig < w.t)) return;
  tree_size(sc, ix, iy, tr);
  float t_trunk = trunk_hit(tr, px, py, pz, dx, dy, dz);
  float t_can = canopy_hit(tr, px, py, pz, dx, dy, dz);
  float t = present ? fminf(t_trunk, t_can) : kBig;
  if (t < w.t) {
    w.t = t;
    w.mat = t_trunk <= t_can ? shade::kTrunk : shade::kCanopy;
    w.ix = ix;
    w.iy = iy;
  }
}

// The winner's unit normal: the ground's +z; the trunk's radial direction;
// the canopy sphere's whose surface the hit point is relatively nearer.
__device__ __forceinline__ void rgb_normal(const Scene& sc, const Winner& w, float hx, float hy,
                                           float hz, float& nx, float& ny, float& nz) {
  nx = 0.0f, ny = 0.0f, nz = 1.0f;
  if (w.mat != shade::kTrunk && w.mat != shade::kCanopy) return;
  Tree tr;
  tree_centre(sc, w.ix, w.iy, tr);
  tree_size(sc, w.ix, w.iy, tr);
  if (w.mat == shade::kTrunk) {
    float rx = hx - tr.cx, ry = hy - tr.cy;
    float rn = sqrtf(rx * rx + ry * ry);
    rn = rn < 1e-9f ? 1.0f : rn;
    nx = rx / rn, ny = ry / rn, nz = 0.0f;
    return;
  }
  float ax = hx - tr.cx, ay = hy - tr.cy, az = hz - tr.can_h;
  float bx = hx - tr.c2x, by = hy - tr.c2y, bz = hz - tr.c2z;
  float n1 = sqrtf(ax * ax + ay * ay + az * az);
  float n2 = sqrtf(bx * bx + by * by + bz * bz);
  bool use2 = n2 / fmaxf(tr.c2r, 1e-6f) < n1 / fmaxf(tr.can_r, 1e-6f);
  float nn = use2 ? n2 : n1;
  nn = nn < 1e-9f ? 1.0f : nn;
  nx = (use2 ? bx : ax) / nn, ny = (use2 ? by : ay) / nn, nz = (use2 ? bz : az) / nn;
}

// One pixel of image bi, (x, y): the depth pass (kRgb false) writes its
// code to out, the RGB pass its three bytes to rgb; both write the cells the
// pixel evaluated to cells_out where given.
template <bool kRgb>
__device__ __forceinline__ void render_pixel(const float* __restrict__ cam_pos,
                                             const float* __restrict__ cam_att,
                                             const float* __restrict__ scene_f,
                                             const int* __restrict__ seed, int* __restrict__ out,
                                             int* __restrict__ cells_out,
                                             unsigned char* __restrict__ rgb, int H, int W,
                                             float focal, float scale, int dda_steps,
                                             const shade::Sun& sun) {
  int ntx = (W + kTileW - 1) / kTileW;
  int warp = static_cast<int>(threadIdx.x) >> 5, lane = static_cast<int>(threadIdx.x) & 31;
  int x = (static_cast<int>(blockIdx.x) % ntx) * kTileW + (warp & 1) * 8 + (lane & 7);
  int y = (static_cast<int>(blockIdx.x) / ntx) * kTileH + (warp >> 1) * 4 + (lane >> 3);
  int bi = static_cast<int>(blockIdx.y);
  if (x >= W || y >= H) return;

  Scene sc{scene_f[0], scene_f[1], scene_f[2], scene_f[3], scene_f[4],
           scene_f[5], scene_f[6], scene_f[7], scene_f[8], seed[0]};
  const float* p = cam_pos + bi * 3;
  float px = p[0], py = p[1], pz = p[2];
  // world-from-camera matrix, rotation.py::to_matrix
  const float* q = cam_att + bi * 4;
  float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
  float r0 = qw * qw, r1 = qx * qx, r2 = qy * qy, r3 = qz * qz;
  float R00 = r0 + r1 - r2 - r3, R01 = 2.0f * (qx * qy - qw * qz), R02 = 2.0f * (qx * qz + qw * qy);
  float R10 = 2.0f * (qx * qy + qw * qz), R11 = r0 - r1 + r2 - r3, R12 = 2.0f * (qy * qz - qw * qx);
  float R20 = 2.0f * (qx * qz - qw * qy), R21 = 2.0f * (qy * qz + qw * qx), R22 = r0 - r1 - r2 + r3;

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

  // the early exit's per-pixel terms. The depth pass may stop once no later
  // cell can come nearer than min(best, 256 scale): beyond the far plane
  // every code is 255. The RGB pass shades a tree beyond the far plane too
  // (hazed), so it stops once none can come nearer than best or than the t
  // where the ray has cleared the canopy.
  bool exits = contained(sc);
  float adx = fabsf(dx) + fabsf(dy) + fabsf(dz);
  float po = 1.0f + fabsf(px) + fabsf(py) + fabsf(pz);
  float sr = sc.tree_spacing + sc.row_spacing;
  float far256 = kRgb ? clear_after(sc, pz, dz, adx, po, sr, best) : scale * 256.0f;

  Winner w{best, best < kBig ? shade::kGround : shade::kSky, 0, 0};
  int k = 0;
  while (k < dda_steps) {
    if constexpr (kRgb) {
      rgb_visit(sc, ix, iy, px, py, pz, dx, dy, dz, w);
      best = w.t;
    } else {
      best = fminf(best, tree_hit(sc, ix, iy, px, py, pz, dx, dy, dz));
    }
    ++k;
    if (exits && k < dda_steps &&
        beyond_next_cells(best, far256, px, py, dx, dy, adx, po, sr, ix, iy, step_x, step_y, sc)) {
      break;
    }
    bool go_x = next_x <= next_y;
    if (go_x) {
      ix += step_x;
      next_x = next_x + t_dx;
    } else {
      iy += step_y;
      next_y = next_y + t_dy;
    }
  }

  int64_t idx = (static_cast<int64_t>(bi) * H + y) * W + x;
  if constexpr (kRgb) {
    float nx, ny, nz;
    rgb_normal(sc, w, px + best * dx, py + best * dy, pz + best * dz, nx, ny, nz);
    shade::shade_pixel(w.mat, nx, ny, nz, best, scale, sun, rgb + idx * 3);
  } else {
    float code = fminf(fmaxf(floorf(best / scale), 0.0f), 255.0f);
    out[idx] = static_cast<int>(code);
  }
  if (cells_out != nullptr) cells_out[idx] = k;
}

__global__ void __launch_bounds__(kThreads)
raycast_kernel(const float* __restrict__ cam_pos, const float* __restrict__ cam_att,
               const float* __restrict__ scene_f, const int* __restrict__ seed,
               int* __restrict__ out, int* __restrict__ cells_out, int H, int W,
               float focal, float scale, int dda_steps) {
  render_pixel<false>(cam_pos, cam_att, scene_f, seed, out, cells_out, nullptr, H, W, focal,
                      scale, dda_steps, shade::Sun{});
}

// K1-rgb: `far` takes scale's place (the haze's far plane)
__global__ void __launch_bounds__(kThreads)
raycast_rgb_kernel(const float* __restrict__ cam_pos, const float* __restrict__ cam_att,
                   const float* __restrict__ scene_f, const int* __restrict__ seed,
                   unsigned char* __restrict__ rgb, int* __restrict__ cells_out, int H, int W,
                   float focal, float far, int dda_steps, shade::Sun sun) {
  render_pixel<true>(cam_pos, cam_att, scene_f, seed, nullptr, cells_out, rgb, H, W, focal, far,
                     dda_steps, sun);
}

dim3 grid_of(int B, int H, int W) {
  return dim3(static_cast<unsigned>(((W + kTileW - 1) / kTileW) * ((H + kTileH - 1) / kTileH)),
              static_cast<unsigned>(B));
}

}  // namespace

// cam_pos: (B, 3) float32; cam_att: (B, 4) float32 world-from-camera
// quaternions (w, x, y, z); scene: 9 float32 (order of
// orchard.FLOAT_FIELDS); seed: 1 int32; out: (B, H, W) int32 codes;
// cells: null, or (B, H, W) int32 that receives the cells each pixel
// evaluated.
extern "C" int raycast_launch(const float* cam_pos, const float* cam_att, const float* scene,
                              const int* seed, int* out, int* cells, int B, int H, int W,
                              float focal, float scale, int dda_steps, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  raycast_kernel<<<grid_of(B, H, W), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cam_pos, cam_att, scene, seed, out, cells, H, W, focal, scale, dda_steps);
  return static_cast<int>(cudaGetLastError());
}

// K1-rgb: the same inputs; rgb: (B, H, W, 3) uint8; far: the far plane
// (haze); sun_*: raycast.SUN, the unit sun direction.
extern "C" int raycast_rgb_launch(const float* cam_pos, const float* cam_att, const float* scene,
                                  const int* seed, unsigned char* rgb, int B, int H, int W,
                                  float focal, float far, int dda_steps, float sun_x, float sun_y,
                                  float sun_z, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  raycast_rgb_kernel<<<grid_of(B, H, W), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cam_pos, cam_att, scene, seed, rgb, nullptr, H, W, focal, far, dda_steps,
      shade::Sun{sun_x, sun_y, sun_z});
  return static_cast<int>(cudaGetLastError());
}

// K1-rgb as raycast_rgb_launch, and cells: (B, H, W) int32 that receives
// the cells each pixel evaluated (the measurement's instance; the bridge
// frame's launches pass none)
extern "C" int raycast_rgb_cells_launch(const float* cam_pos, const float* cam_att,
                                        const float* scene, const int* seed, unsigned char* rgb,
                                        int* cells, int B, int H, int W, float focal, float far,
                                        int dda_steps, float sun_x, float sun_y, float sun_z,
                                        void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  raycast_rgb_kernel<<<grid_of(B, H, W), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cam_pos, cam_att, scene, seed, rgb, cells, H, W, focal, far, dda_steps,
      shade::Sun{sun_x, sun_y, sun_z});
  return static_cast<int>(cudaGetLastError());
}
