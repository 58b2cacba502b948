// Portable RNG: PCG64 (64-bit LCG + XSH-RR 64/32) + Marsaglia polar normals.
//
// C++ twin of terrain_diffusion_tpu_torch/ops/rng_portable.py — the determinism
// contract of the framework's portable noise path.  Stream-compatible with
// the reference's numba implementation (portable_rng.py:45-74), which states
// that C++/Java re-implementation producing identical streams is the design
// goal.  Exposed via a plain C ABI for ctypes.
#include <cstdint>
#include <cmath>

namespace {

constexpr uint64_t kMult = 6364136223846793005ULL;
constexpr uint64_t kInc = 1442695040888963407ULL;

inline uint32_t pcg64_next(uint64_t& state) {
  state = state * kMult + kInc;
  uint32_t x = static_cast<uint32_t>(((state >> 18) ^ state) >> 27);
  uint32_t rot = static_cast<uint32_t>(state >> 59);
  return (x >> rot) | (x << ((32u - rot) & 31u));
}

}  // namespace

extern "C" {

// Fill out[0..n) with standard normals from the (seed)-keyed portable stream.
void td_fill_standard_normal_f32(uint64_t seed, float* out, int64_t n) {
  uint64_t state = seed;
  const double inv_2p32 = 1.0 / 4294967296.0;
  int64_t i = 0;
  while (i < n) {
    uint32_t u1 = pcg64_next(state);
    uint32_t u2 = pcg64_next(state);
    double v1 = 2.0 * (static_cast<double>(u1) + 1.0) * inv_2p32 - 1.0;
    double v2 = 2.0 * (static_cast<double>(u2) + 1.0) * inv_2p32 - 1.0;
    double s = v1 * v1 + v2 * v2;
    if (s > 0.0 && s < 1.0) {
      double f = std::sqrt(-2.0 * std::log(s) / s);
      out[i++] = static_cast<float>(v1 * f);
      if (i < n) out[i++] = static_cast<float>(v2 * f);
    }
  }
}

}  // extern "C"
