// Closed-form real roots (quadratic, cubic, quartic) as device functions
// that round as the port's plain PyTorch solvers do on the card,
// agrifly_tpu_torch/ops/rootfind.py (solve_quadratic, solve_cubic,
// solve_quartic), so a kernel built on them equals the plain code bit for bit.
//
// Every float32 operation is the plain code's, in its order, each rounded
// once: the library builds with -fmad=false and no fast math, so nvcc
// contracts nothing and divides and takes square roots IEEE-exact (the
// defaults -prec-div=true, -prec-sqrt=true), as PyTorch's elementwise CUDA
// kernels do. Where the plain code:
//   - divides by fmath.scalar(v, x), a device tensor, the kernel divides;
//   - divides a tensor by a python number, torch multiplies by its float32
//     reciprocal; every such divisor here is a power of two (x / 2.0), where
//     the product and the quotient are the same number, so the kernel
//     multiplies by the exact reciprocal 0.5f;
//   - mixes a tensor with a python number (x * 3.0, x + 2 pi, |x| < 1e-12),
//     torch casts the number to float32 first: the literals below are those
//     float32 values;
//   - takes _f64(torch.acos, ...) / _f64(torch.cos, ...) (the cubic's
//     trigonometric branch), the kernel evaluates acos / cos in double and
//     rounds once (acos_r, cos_r);
//   - takes the card's cube root (rootfind._cbrt on a CUDA tensor), the
//     kernel raises |x| to the double power float32(1/3) =
//     0.3333333432674408, rounds once and multiplies by sign(x) (cbrt_r);
//   - clamps, or takes torch.maximum / minimum, NaN propagates as in
//     PyTorch's CUDA kernels (the value itself when it is NaN, else fmaxf /
//     fminf, which those kernels' ::max / ::min are);
//   - takes argmax, the first of equal maxima wins and a NaN beats any
//     number (torch.argmax).
// The plain code computes every branch and selects with torch.where; these
// functions compute only the branch they return, which gives the same
// values.

#pragma once

#include <math.h>

namespace rootfind {

constexpr float kEps = 1e-12f;  // rootfind._EPS, as float32
constexpr float kTwoPi = 6.283185307179586f;  // rootfind._2PI, as float32
constexpr float kHalfSqrt3 = 0.8660254037844386f;  // 0.5 * math.sqrt(3.0), as float32
constexpr double kThirdF32 = 0.3333333432674408;  // rootfind._THIRD_F32: float32(1/3)

__device__ __forceinline__ float tmax(float a, float b) {  // torch.maximum
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {  // torch.minimum
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float clamp_min(float x, float lo) {  // torch.clamp(x, min=lo)
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {  // torch.clamp(x, lo, hi)
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float safe_sqrt(float x) { return sqrtf(clamp_min(x, 0.0f)); }
__device__ __forceinline__ float sign(float x) {  // torch.sign: 0 for 0 and NaN
  return static_cast<float>(0.0f < x) - static_cast<float>(x < 0.0f);
}
__device__ __forceinline__ float acos_r(float x) { return (float)acos((double)x); }
__device__ __forceinline__ float cos_r(float x) { return (float)cos((double)x); }
// rootfind._cbrt on the card: |x| ** float32(1/3) in double, rounded once
__device__ __forceinline__ float cbrt_r(float x) {
  return sign(x) * (float)pow((double)fabsf(x), kThirdF32);
}

// x^3 + a x^2 + b x + c = 0: roots x[3], valid v[3] (rootfind.solve_cubic).
__device__ __forceinline__ void solve_cubic(float a, float b, float c, float x[3], bool v[3]) {
  const float a2 = a * a;
  const float q = (a2 - 3.0f * b) / 9.0f;
  const float r = (a * (2.0f * a2 - 9.0f * b) + 27.0f * c) / 54.0f;
  const float r2 = r * r;
  const float q3 = q * q * q;
  const float a3 = a / 3.0f;
  if (r2 < q3) {  // three real roots, the trigonometric form (q3_safe = q3)
    const float t = acos_r(clamp(r / safe_sqrt(q3), -1.0f, 1.0f));
    const float qq = -2.0f * safe_sqrt(clamp_min(q, 0.0f));
    x[0] = qq * cos_r(t / 3.0f) - a3;
    x[1] = qq * cos_r((t + kTwoPi) / 3.0f) - a3;
    x[2] = qq * cos_r((t - kTwoPi) / 3.0f) - a3;
    v[0] = v[1] = v[2] = true;
    return;
  }
  // one or two real roots (Cardano)
  const float disc = safe_sqrt(clamp_min(r2 - q3, 0.0f));
  const float mag = fabsf(r) + disc;
  float A = -cbrt_r(mag);
  A = r < 0.0f ? -A : A;
  const bool small_A = fabsf(A) < kEps;
  const float B = small_A ? 0.0f : q / A;
  const float x1 = -0.5f * (A + B) - a3;
  x[0] = (A + B) - a3;
  x[1] = x1;
  x[2] = x1;
  v[0] = true;
  v[1] = fabsf(kHalfSqrt3 * (A - B)) < kEps;  // the pair's imaginary part vanishes
  v[2] = false;
}

// x^4 + a x^3 + b x^2 + c x + d = 0: roots x[4], valid v[4]
// (rootfind.solve_quartic: the resolvent cubic's root of largest |y|, then
// two quadratics).
__device__ __forceinline__ void solve_quartic(float a, float b, float c, float d, float x[4],
                                              bool v[4]) {
  float x3[3];
  bool v3[3];
  solve_cubic(-b, a * c - 4.0f * d, (-a) * a * d - c * c + 4.0f * b * d, x3, v3);
  // argmax over (v3 ? |x3| : -inf): the first maximum, a NaN first of all
  int idx = 0;
  float best = v3[0] ? fabsf(x3[0]) : -INFINITY;
#pragma unroll
  for (int k = 1; k < 3; ++k) {
    const float val = v3[k] ? fabsf(x3[k]) : -INFINITY;
    if (!isnan(best) && (isnan(val) || val > best)) {
      best = val;
      idx = k;
    }
  }
  const float y = idx == 0 ? x3[0] : (idx == 1 ? x3[1] : x3[2]);

  // h^2 - y h + d = 0 (h = q1, q2)
  const float D1 = y * y - 4.0f * d;
  const bool D1_zero = fabsf(D1) < kEps;
  float q1, q2, p1, p2;
  if (D1_zero) {  // g^2 - a g + (b - y) = 0
    const float D2 = a * a - 4.0f * (b - y);
    const float sqD2 = safe_sqrt(clamp_min(D2, 0.0f));
    const bool D2_zero = fabsf(D2) < kEps;
    q1 = q2 = y * 0.5f;
    p1 = D2_zero ? a * 0.5f : (a + sqD2) * 0.5f;
    p2 = D2_zero ? a * 0.5f : (a - sqD2) * 0.5f;
  } else {  // Cramer
    const float sqD1 = safe_sqrt(D1);
    q1 = (y + sqD1) * 0.5f;
    q2 = (y - sqD1) * 0.5f;
    const float denom = q1 - q2;
    p1 = (a * q1 - c) / denom;
    p2 = (c - a * q2) / denom;
  }
  const float Da = p1 * p1 - 4.0f * q1;
  const float Db = p2 * p2 - 4.0f * q2;
  const float sqDa = safe_sqrt(Da);
  const float sqDb = safe_sqrt(Db);
  x[0] = (-p1 + sqDa) * 0.5f;
  x[1] = (-p1 - sqDa) * 0.5f;
  x[2] = (-p2 + sqDb) * 0.5f;
  x[3] = (-p2 - sqDb) * 0.5f;
  v[0] = v[1] = !(Da < 0.0f);
  v[2] = v[3] = !(Db < 0.0f);
}

// a x^2 + b x + c = 0, the linear equation where |a| < 1e-12: roots x[2],
// valid v[2] (rootfind.solve_quadratic).
__device__ __forceinline__ void solve_quadratic(float a, float b, float c, float x[2], bool v[2]) {
  if (fabsf(a) < 1e-12f) {  // b x + c = 0
    const bool tiny_b = fabsf(b) < 1e-12f;
    x[0] = x[1] = -c / (tiny_b ? 1.0f : b);
    v[0] = !tiny_b;
    v[1] = false;
    return;
  }
  const float disc = b * b - 4.0f * a * c;
  const float sq = safe_sqrt(disc);
  x[0] = (-b + sq) / (2.0f * a);
  x[1] = (-b - sq) / (2.0f * a);
  v[0] = v[1] = disc >= 0.0f;
}

}  // namespace rootfind
