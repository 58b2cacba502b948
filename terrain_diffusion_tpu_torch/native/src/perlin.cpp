// Perlin FBm noise, algorithm-compatible with FastNoiseLite 2D Perlin
// (NoiseType_Perlin + FractalType_FBm), which the reference consumes through
// pyfastnoiselite for the synthetic conditioning map
// (synthetic_map.py:195-229) and the Minecraft-API detail noise.
//
// First-party C++ implementation of the published FastNoiseLite algorithm
// (public domain); replaces the pyfastnoiselite binary dependency with a
// batch-oriented C ABI (a coordinate-list entry point) for ctypes.
#include <cstdint>
#include <cmath>

namespace {

constexpr int32_t kPrimeX = 501125321;
constexpr int32_t kPrimeY = 1136930381;

// 24 base gradient directions at (7.5 + 15k) degrees, cycled to 128 pairs.
struct GradTable {
  float g[256];
  GradTable() {
    const double pi = 3.14159265358979323846;
    for (int i = 0; i < 128; ++i) {
      int k = i % 24;
      double a = (7.5 + 15.0 * k) * pi / 180.0;
      g[2 * i] = static_cast<float>(std::sin(a));
      g[2 * i + 1] = static_cast<float>(std::cos(a));
    }
  }
};
const GradTable kGrad;

inline int32_t hash2(int32_t seed, int32_t xp, int32_t yp) {
  int32_t h = seed ^ xp ^ yp;
  h = static_cast<int32_t>(static_cast<uint32_t>(h) * 0x27d4eb2dU);
  return h;
}

inline float grad_coord(int32_t seed, int32_t xp, int32_t yp, float xd, float yd) {
  int32_t h = hash2(seed, xp, yp);
  h ^= h >> 15;
  h &= 127 << 1;
  return xd * kGrad.g[h] + yd * kGrad.g[h | 1];
}

inline float quintic(float t) { return t * t * t * (t * (t * 6 - 15) + 10); }
inline float lerp(float a, float b, float t) { return a + t * (b - a); }
inline int32_t fast_floor(float f) {
  int32_t i = static_cast<int32_t>(f);
  return (f < i) ? i - 1 : i;
}

float perlin_single(int32_t seed, float x, float y) {
  int32_t x0 = fast_floor(x);
  int32_t y0 = fast_floor(y);
  float xd0 = x - static_cast<float>(x0);
  float yd0 = y - static_cast<float>(y0);
  float xd1 = xd0 - 1;
  float yd1 = yd0 - 1;
  float xs = quintic(xd0);
  float ys = quintic(yd0);
  x0 = static_cast<int32_t>(static_cast<uint32_t>(x0) * static_cast<uint32_t>(kPrimeX));
  y0 = static_cast<int32_t>(static_cast<uint32_t>(y0) * static_cast<uint32_t>(kPrimeY));
  int32_t x1 = static_cast<int32_t>(static_cast<uint32_t>(x0) + static_cast<uint32_t>(kPrimeX));
  int32_t y1 = static_cast<int32_t>(static_cast<uint32_t>(y0) + static_cast<uint32_t>(kPrimeY));
  float xf0 = lerp(grad_coord(seed, x0, y0, xd0, yd0), grad_coord(seed, x1, y0, xd1, yd0), xs);
  float xf1 = lerp(grad_coord(seed, x0, y1, xd0, yd1), grad_coord(seed, x1, y1, xd1, yd1), xs);
  return lerp(xf0, xf1, ys) * 1.4247691104677813f;
}

// FBm octave normalizer 1/(1+g+...+g^(octaves-1)) — exact amplitude sum.
// Must stay bit-identical to ops/perlin.py::fractal_bounding (see its
// docstring for the FastNoiseLite statement-order ambiguity and why the
// conditioning path is made invariant to this constant).
inline float fractal_bounding(int octaves, float gain) {
  float g = std::fabs(gain);
  float amp = g;
  float amp_fractal = 1.0f;
  for (int i = 1; i < octaves; ++i) {
    amp_fractal += amp;
    amp *= g;
  }
  return 1.0f / amp_fractal;
}

inline float fbm(int32_t seed, float x, float y, int octaves, float lacunarity,
                 float gain, float bounding) {
  float sum = 0.0f;
  float amp = bounding;
  for (int i = 0; i < octaves; ++i) {
    float noise = perlin_single(seed++, x, y);
    sum += noise * amp;
    x *= lacunarity;
    y *= lacunarity;
    amp *= gain;
  }
  return sum;
}

}  // namespace

extern "C" {

// Evaluate FBm Perlin at n arbitrary coordinates (matches the
// pyfastnoiselite gen_from_coords batch API shape).
void td_perlin_fbm_coords(int32_t seed, float frequency, int32_t octaves,
                          float lacunarity, float gain, const float* xs,
                          const float* ys, int64_t n, float* out) {
  float bounding = fractal_bounding(octaves, gain);
  for (int64_t i = 0; i < n; ++i) {
    out[i] = fbm(seed, xs[i] * frequency, ys[i] * frequency, octaves,
                 lacunarity, gain, bounding);
  }
}

}  // extern "C"
