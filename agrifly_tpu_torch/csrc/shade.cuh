// The RGB pass's colour tail, shared by the orchard's RGB kernel
// (raycast.cu, K1-rgb) and the imported world's (meshscene.cu, K4-rgb).
//
// It is render/raycast.py::shade in its float32 operations: Lambertian
// light 0.35 + 0.65 max(0, min(1, n . sun)) on the material's base colour,
// the sky colour where nothing was hit, and a haze toward the sky colour of
// 0.35 clip(t / far, 0, 1); the channels are clipped to [0, 255] and
// truncated to bytes. Every product and sum is its own rounding (the build's
// -fmad=false), as in the plain version's separate torch operations.

#pragma once

namespace shade {

constexpr int kSky = 0;  // raycast.py MAT_SKY .. MAT_CANOPY
constexpr int kGround = 1;
constexpr int kTrunk = 2;
constexpr int kCanopy = 3;

// raycast.py COLORS: base colours (RGB, 0..1) by material id
__constant__ float kColors[4][3] = {
    {0.62f, 0.78f, 0.95f},  // sky
    {0.45f, 0.38f, 0.25f},  // orchard soil
    {0.35f, 0.22f, 0.12f},  // trunk bark
    {0.18f, 0.45f, 0.15f},  // canopy leaves
};

// the unit sun direction, raycast.py SUN (normalized on the host in float32)
struct Sun {
  float x, y, z;
};

// The three bytes of a pixel of material `mat` (0..3), unit normal n and
// planar depth t, written to px[0..2].
__device__ __forceinline__ void shade_pixel(int mat, float nx, float ny, float nz, float t,
                                            float far, const Sun& sun,
                                            unsigned char* __restrict__ px) {
  float lam = nx * sun.x + ny * sun.y + nz * sun.z;
  lam = fminf(fmaxf(lam, 0.0f), 1.0f);
  const float light = 0.35f + 0.65f * lam;
  const float haze = fminf(fmaxf(t / far, 0.0f), 1.0f) * 0.35f;
  const float keep = 1.0f - haze;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float sky = kColors[kSky][c];
    float col = mat == kSky ? sky : kColors[mat][c] * light;
    col = col * keep + sky * haze;
    px[c] = static_cast<unsigned char>(fminf(fmaxf(col * 255.0f, 0.0f), 255.0f));
  }
}

}  // namespace shade
