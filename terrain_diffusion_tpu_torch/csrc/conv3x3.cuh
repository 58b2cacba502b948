// SAME-padded KS x KS convolution (KS = 3, or 1 for a 1x1 projection) over
// NHWC float32 tensors, as an implicit GEMM on the tensor cores in split
// TF32 (3xTF32), with an optional activation applied to the staged input and
// an optional epilogue.  Shared by the standalone conv (conv3x3.cu) and the
// fused residual block (fused_block.cu).  The end of this file holds the
// 16-bit form of the same core (bf16 operands on mma.sync, float32 sums),
// which the bf16 entry points of both run for the shapes the wgmma core
// (conv_wgmma.cuh) does not take.
//
// Layouts: x (N, H, W, Cin), weight HWIO (KS, KS, Cin, Cout), y (N, H, W,
// Cout), all C-contiguous.
//
// Precision: the JAX kernels compute their float32 dots at
// Precision.HIGHEST, a multi-pass split on the TPU's matrix unit.  The
// counterpart here is 3xTF32: each operand x is split into big = tf32(x)
// (nearest, ties away from zero: cvt.rna's rounding, done on the bits) and
// small = tf32(x - big) (x - big is exact in float32); per k8 step the three
// passes small*big, big*small, big*big go into a fresh fragment (the first
// with a zero accumulator), which is then added into the float32
// accumulator.  Only small*small (~2^-22 relative) is dropped.  The fresh
// fragment matters: the tensor cores truncate when they accumulate, so
// accumulating all of K in them lets the error grow with K, while one
// rounded add per k8 step keeps the conv at least as close to a float64
// conv as cuDNN's float32 conv (chip_smoke.py prints both).  One TF32 pass
// alone keeps about 3 digits.
//
// What bounds it on the H100: at the decoder's widths (64..448 input
// channels, 64..256 output channels) the conv does 9 * Cin * Cout FMAs per
// pixel against 4 * (Cin + Cout) bytes, so it is bound by the tensor cores:
// 3 * FLOPs / 495 TFLOP/s (three TF32 passes).  The 6 -> 64 input conv does
// little arithmetic per byte and is bound by its output bytes.
//
// What the design does:
// - GEMM view: M = pixels, N = output channels, K = taps x input channels.
//   A block owns a tile of 8 x 16 pixels by 64 output channels; each of its
//   8 warps owns 2 rows of 16 pixels (one m16 tile each) by 4 n8 tiles and
//   issues mma.sync.m16n8k8 TF32 with the split done on the fragments.
// - The K loop walks chunks of CK input channels (16, or 8 when Cin <= 8).
//   Per chunk the block stages the (8 + KS - 1) x (16 + KS - 1) input tile
//   with its halo once (zero outside the image: SAME padding) and the
//   chunk's KS*KS x CK x 64 weights; each tap reads its A operand as a
//   shifted window of that tile, so no im2col is materialised.  Row strides
//   are padded (CK + 4 floats, 64 + 8 floats) so the fragment loads hit 32
//   distinct banks.  The staged input gets its silu (conv0) once per
//   element, not once per tap.
// - Staging uses cp.async (16-byte copies, or 4-byte copies for rows that
//   are not a multiple of 4 channels such as the 6-channel input conv, with
//   zero-fill for the halo and the ragged channel edge) into a ring of two
//   stages: the next chunk loads while this one computes.
// - Two blocks of 256 threads share an SM, which caps a thread at 128
//   registers.  The taps are a loop; the two k8 steps of a tap are unrolled
//   for the overlap of their loads and products; the launch's tiling comes
//   in as kernel parameters, which stay in the constant bank.  Together
//   these keep ptxas from spilling.
// - Blocks are persistent: a grid of at most (resident blocks x SMs) walks
//   the (pixel tile, channel block) items, and the ring runs on across item
//   boundaries, so the next tile's first chunk loads during this tile's last
//   chunk.  A block keeps one channel block for all its items; with a single
//   chunk (Cin <= CK: the input conv) its weights are staged once and stay
//   resident while it walks its pixel tiles.
// - Epilogues (gain + silu, residual mix + clip) run on the accumulator
//   fragments in registers and store straight to device memory.
// - The 64 -> 1 head runs a direct conv on the CUDA cores that streams its
//   input once (conv3x3_head_kernel below): it is bound by its input
//   bytes, and the tensor-core tiles measured slower on it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace tdt {

// Largest shared memory a block may take on sm_90 (227 KB).
constexpr size_t kMaxSmem = 232448;

enum InAct { IN_NONE = 0, IN_SILU = 1 };
enum Epilogue { EPI_NONE = 0, EPI_GAIN_SILU = 1, EPI_RESIDUAL = 2 };

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }
// silu with the fast exponential and division (relative error ~1e-7)
__device__ __forceinline__ float fast_silu(float v) { return __fdividef(v, 1.0f + __expf(-v)); }

struct EpiArgs {
  const float* gain;      // EPI_GAIN_SILU: (N, Cout) per-channel gain
  const float* residual;  // EPI_RESIDUAL: (N, H, W, Cout), float32 ...
  const void* residual_h;  // ... or in the 16-bit type of the kernel (16-bit path only)
  float res_a;            // residual weight (1 - t)
  float res_b;            // conv weight t
  float res_norm;         // sqrt((1 - t)^2 + t^2)
  int clip;               // clip the result to +-clip_val
  float clip_val;
};

// float32 and the 16-bit types (bf16, fp16): conversions
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
template <class E>
__device__ __forceinline__ E from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half_rn(v); }

// the float value of a stored element, a 16-bit one loaded as its bits
__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __uint_as_float((uint32_t)*reinterpret_cast<const uint16_t*>(p) << 16);
}
__device__ __forceinline__ float load_f32(const __half* p) {
  return __half2float(__ushort_as_half(*reinterpret_cast<const unsigned short*>(p)));
}

// two floats rounded to E, lo in the low 16 bits (the lower channel)
template <class E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 p = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// the two E values of a 32-bit word as floats (exact)
__device__ __forceinline__ float2 unpack2(uint32_t w, __nv_bfloat16*) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xFFFF0000u));
}
__device__ __forceinline__ float2 unpack2(uint32_t w, __half*) {
  return __half22float2(*reinterpret_cast<__half2*>(&w));
}

// The value an epilogue stores for output element (n, co) at offset off,
// from its float32 sum v: gain + silu, or residual mix + clip (the residual
// is float32, or in E where EpiArgs::residual_h holds it).
// The residual mix + clip of the sum v with the residual value r.
__device__ __forceinline__ float residual_mix(float r, float v, const EpiArgs& epi) {
  v = (r * epi.res_a + v * epi.res_b) / epi.res_norm;
  return epi.clip ? fminf(fmaxf(v, -epi.clip_val), epi.clip_val) : v;
}

template <int EPI, class E>
__device__ __forceinline__ float epilogue(float v, const EpiArgs& epi, int n, int Cout, int co,
                                          size_t off) {
  if (EPI == EPI_GAIN_SILU) {
    v = fast_silu(v * epi.gain[(size_t)n * Cout + co]);
  } else if (EPI == EPI_RESIDUAL) {
    v = residual_mix(epi.residual ? epi.residual[off]
                                  : to_f32(reinterpret_cast<const E*>(epi.residual_h)[off]),
                     v, epi);
  }
  return v;
}

// ---------------------------------------------------------------------------
// 3xTF32 and cp.async primitives
// ---------------------------------------------------------------------------

// The TF32 value nearest to v, ties away from zero (cvt.rna.tf32.f32's
// rounding), by integer arithmetic on the bits: full-rate ALU operations.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// v = big + small (+ a residue of ~2^-22 |v|), both exactly representable in TF32
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = to_tf32(v);
  small = to_tf32(v - __uint_as_float(big));
}

// d += a (16x8, row) * b (8x8, col); fragment layouts of mma.m16n8k8 .tf32:
// a[0] (g, t), a[1] (g + 8, t), a[2] (g, t + 4), a[3] (g + 8, t + 4);
// b[0] (k t, n g), b[1] (k t + 4, n g); d[0..1] (g, 2t..2t+1),
// d[2..3] (g + 8, 2t..2t+1), with g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a * b (the accumulator input is zero: the hardware's zero register)
__device__ __forceinline__ void mma_tf32_first(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.0f));
}

// 16-byte asynchronous copy; copies zeros when !full (src is then not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 16 : 0));
}
// 4-byte asynchronous copy for rows that are not 16-byte aligned
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));  // all but the newest N landed
}

// ---------------------------------------------------------------------------
// Tile geometry
// ---------------------------------------------------------------------------

template <int KS_, int CK_, int WARPS_M_, int WARPS_N_, int WM_, int WN_>
struct ConvTile {
  static constexpr int KS = KS_, CK = CK_, WM = WM_, WN = WN_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int STAGES = 2;  // the ring
  static constexpr int NT = WARPS_M * WARPS_N * 32;
  static_assert(CK % 8 == 0, "K chunks are whole k8 steps");
  static constexpr int TW = 16;                 // tile row = one m16 tile
  static constexpr int TH = WARPS_M * WM;       // tile rows
  static constexpr int BN = WARPS_N * WN * 8;   // output channels per block
  static constexpr int IN_H = TH + KS - 1;
  static constexpr int IN_W = TW + KS - 1;
  // A loads: lane (g, t) reads pixel g, channel t -> bank (g * CIP + t) % 32,
  // all distinct for CIP = 12, 20.  B loads: (t * BNP + g) % 32, distinct
  // for BNP % 32 == 8.
  static constexpr int CIP = CK + 4;
  static constexpr int BNP = BN + 8;
  static_assert(BNP % 32 == 8, "conflict-free B loads");
  static constexpr int IN_FLOATS = IN_H * IN_W * CIP;
  static constexpr int W_FLOATS = KS * KS * CK * BNP;
  static constexpr int STAGE_FLOATS = IN_FLOATS + W_FLOATS;
  static constexpr int SMEM = (int)sizeof(float) * STAGES * STAGE_FLOATS;
};

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// The tiling of one launch, computed by the launcher: kernel parameters stay
// in the constant bank rather than in registers.
struct ConvGrid {
  int tiles_x, tiles_y;  // pixel tiles across and down the map
  int n_nb;              // channel blocks (gridDim.x is a multiple of it)
  int nchunks;           // K chunks
  int n_items;           // N * tiles_y * tiles_x * n_nb
  int vec_in, vec_w;     // 16-byte copies for the input rows / weight rows
};

template <class T, int ACT, int EPI>
__global__ void __launch_bounds__(T::NT, 2)  // two blocks per SM: <= 128 registers
conv_tc_kernel(const float* __restrict__ x, const float* __restrict__ w,
               float* __restrict__ y, int N, int H, int W, int Cin, int Cout,
               const ConvGrid grid, const EpiArgs epi) {
  constexpr int KS = T::KS, CK = T::CK, WM = T::WM, WN = T::WN;
  extern __shared__ __align__(16) float tc_smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
  const int tiles_x = grid.tiles_x, tiles_y = grid.tiles_y;
  const int n_nb = grid.n_nb, nchunks = grid.nchunks;
  const int vec_in = grid.vec_in, vec_w = grid.vec_w;
  // this block's channel block is fixed
  const int co0 = (blockIdx.x % n_nb) * T::BN;
  const int my_items =
      (grid.n_items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int nsteps = my_items * nchunks;

  // (image, tile row, tile column) of this block's item k
  auto item_tile = [&](int k, int& n, int& ty, int& tx) {
    const int tile = ((int)blockIdx.x + k * (int)gridDim.x) / n_nb;
    tx = tile % tiles_x;
    ty = (tile / tiles_x) % tiles_y;
    n = tile / (tiles_x * tiles_y);
  };

  // stage the input tile and the weights of step st (item st / nchunks,
  // chunk st % nchunks) into ring slot st % STAGES
  auto load_step = [&](int st) {
    int n, ty, tx;
    item_tile(st / nchunks, n, ty, tx);
    const int c0 = (st % nchunks) * CK;
    float* s_in = tc_smem + (st % T::STAGES) * T::STAGE_FLOATS;
    float* s_w = s_in + T::IN_FLOATS;
    const int y0 = ty * T::TH - KS / 2, x0 = tx * T::TW - KS / 2;
    const float* xn = x + (size_t)n * H * W * Cin;
    if (vec_in) {
      constexpr int Q = CK / 4;
#pragma unroll 1
      for (int i = tid; i < T::IN_H * T::IN_W * Q; i += T::NT) {
        const int q = i % Q, pos = i / Q;
        const int gy = y0 + pos / T::IN_W, gx = x0 + pos % T::IN_W;
        const int c = c0 + 4 * q;
        const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c < Cin;
        cp_async16(s_in + pos * T::CIP + 4 * q,
                   ok ? xn + ((size_t)gy * W + gx) * Cin + c : x, ok);
      }
    } else {
#pragma unroll 1
      for (int i = tid; i < T::IN_H * T::IN_W * CK; i += T::NT) {
        const int ci = i % CK, pos = i / CK;
        const int gy = y0 + pos / T::IN_W, gx = x0 + pos % T::IN_W;
        const int c = c0 + ci;
        const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c < Cin;
        cp_async4(s_in + pos * T::CIP + ci, ok ? xn + ((size_t)gy * W + gx) * Cin + c : x, ok);
      }
    }
    if (nchunks == 1 && st >= T::STAGES) return;  // resident weights
    if (vec_w) {
      constexpr int Q = T::BN / 4;
#pragma unroll 1
      for (int i = tid; i < KS * KS * CK * Q; i += T::NT) {
        const int q = i % Q, row = i / Q;  // row = tap * CK + ci
        const int c = c0 + row % CK, tap = row / CK;
        const int co = co0 + 4 * q;
        const bool ok = c < Cin && co < Cout;
        cp_async16(s_w + row * T::BNP + 4 * q,
                   ok ? w + ((size_t)tap * Cin + c) * Cout + co : w, ok);
      }
    } else {
#pragma unroll 1
      for (int i = tid; i < KS * KS * CK * T::BN; i += T::NT) {
        const int col = i % T::BN, row = i / T::BN;
        const int c = c0 + row % CK, tap = row / CK;
        const int co = co0 + col;
        const bool ok = c < Cin && co < Cout;
        cp_async4(s_w + row * T::BNP + col, ok ? w + ((size_t)tap * Cin + c) * Cout + co : w, ok);
      }
    }
  };

  float acc[WM][WN][4];
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0f;

  // the ring: STAGES - 1 steps in flight ahead of the one computed
#pragma unroll
  for (int st = 0; st < T::STAGES - 1; ++st) {
    if (st < nsteps) load_step(st);
    cp_async_commit();
  }
  for (int st = 0; st < nsteps; ++st) {
    if (st + T::STAGES - 1 < nsteps) load_step(st + T::STAGES - 1);
    cp_async_commit();
    cp_async_wait<T::STAGES - 1>();
    __syncthreads();
    float* s_in = tc_smem + (st % T::STAGES) * T::STAGE_FLOATS;
    const float* s_w = s_in + T::IN_FLOATS;

    if (ACT == IN_SILU) {  // once per staged element, not once per tap
#pragma unroll 1
      for (int i = tid; i < T::IN_H * T::IN_W * CK; i += T::NT) {
        float* p = s_in + (i / CK) * T::CIP + i % CK;
        *p = fast_silu(*p);
      }
      __syncthreads();
    }

    const float* a_base = s_in + (wm * WM * T::IN_W + g) * T::CIP + t;
    const float* b_base = s_w + t * T::BNP + wn * WN * 8 + g;
#pragma unroll 1
    for (int tap = 0; tap < KS * KS; ++tap) {
      const int dy = tap / KS, dx = tap - dy * KS;
      const float* a_tap = a_base + (dy * T::IN_W + dx) * T::CIP;
      const float* b_tap = b_base + tap * CK * T::BNP;
#pragma unroll
      for (int kk = 0; kk < CK / 8; ++kk) {
        uint32_t bb[WN][2], bs[WN][2];
#pragma unroll
        for (int j = 0; j < WN; ++j) {
          const float* bp = b_tap + kk * 8 * T::BNP + j * 8;
          split_tf32(bp[0], bb[j][0], bs[j][0]);
          split_tf32(bp[4 * T::BNP], bb[j][1], bs[j][1]);
        }
#pragma unroll
        for (int i = 0; i < WM; ++i) {
          const float* ap = a_tap + i * T::IN_W * T::CIP + kk * 8;
          uint32_t ab[4], as[4];
          split_tf32(ap[0], ab[0], as[0]);
          split_tf32(ap[8 * T::CIP], ab[1], as[1]);
          split_tf32(ap[4], ab[2], as[2]);
          split_tf32(ap[8 * T::CIP + 4], ab[3], as[3]);
#pragma unroll
          for (int j = 0; j < WN; ++j) {
            // this k8 step's three passes, the small terms first and big *
            // big last, into a fresh fragment; then one float32 add (round
            // to nearest) into the accumulator
            float d[4];
            mma_tf32_first(d, as, bb[j]);
            mma_tf32(d, ab, bs[j]);
            mma_tf32(d, ab, bb[j]);
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[i][j][v] += d[v];
          }
        }
      }
    }

    if (st % nchunks == nchunks - 1) {  // the item's last chunk: epilogue
      int n, ty, tx;
      item_tile(st / nchunks, n, ty, tx);
      const bool pairs = (Cout % 2) == 0;
#pragma unroll
      for (int i = 0; i < WM; ++i) {
        const int gy = ty * T::TH + wm * WM + i;
#pragma unroll
        for (int j = 0; j < WN; ++j) {
          const int co = co0 + (wn * WN + j) * 8 + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int gx = tx * T::TW + g + 8 * h;
            float v[2] = {acc[i][j][2 * h], acc[i][j][2 * h + 1]};
            acc[i][j][2 * h] = acc[i][j][2 * h + 1] = 0.0f;
            if (gy >= H || gx >= W || co >= Cout) continue;
            const size_t off = (((size_t)n * H + gy) * W + gx) * Cout + co;
            const bool two = co + 1 < Cout;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (e == 1 && !two) break;
              v[e] = epilogue<EPI, float>(v[e], epi, n, Cout, co + e, off + e);
            }
            if (two && pairs) {
              *reinterpret_cast<float2*>(y + off) = make_float2(v[0], v[1]);
            } else {
              y[off] = v[0];
              if (two) y[off + 1] = v[1];
            }
          }
        }
      }
    }
    __syncthreads();  // slot st % STAGES is reloaded at step st + STAGES
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

struct LaunchInfo {
  cudaError_t err;
  int blocks_per_sm;
  int sms;
};

// One-time launch state kept per device: a kernel's shared-memory opt-in
// and its occupancy belong to one device's context, so each device makes
// its own on its first launch there (a process-wide static would leave a
// second card without the opt-in).  get() returns the current device's
// value, or nullptr where the current device cannot be read.
constexpr int kMaxDevices = 64;

template <class V>
struct PerDevice {
  std::once_flag once[kMaxDevices];
  V value[kMaxDevices];

  template <class Init>
  const V* get(Init&& init) {
    int dev = -1;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return nullptr;
    std::call_once(once[dev], [&] { value[dev] = init(); });
    return &value[dev];
  }
};

template <typename Kernel>
LaunchInfo query_launch(Kernel kernel, int threads, int smem) {
  LaunchInfo info = {cudaSuccess, 0, 0};
  int dev = 0;
  info.err = cudaGetDevice(&dev);
  if (info.err == cudaSuccess)
    info.err = cudaDeviceGetAttribute(&info.sms, cudaDevAttrMultiProcessorCount, dev);
  if (info.err == cudaSuccess)
    info.err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (info.err == cudaSuccess)
    info.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info.blocks_per_sm, kernel,
                                                             threads, smem);
  if (info.err == cudaSuccess && info.blocks_per_sm < 1) info.err = cudaErrorInvalidConfiguration;
  return info;
}

// The tiling of a launch of tile T (but vec_in / vec_w, the caller's) and
// its number of persistent blocks, 0 when there is no output.
template <class T>
cudaError_t plan_conv(const LaunchInfo& info, int N, int H, int W, int Cin, int Cout,
                      ConvGrid& grid, unsigned& blocks) {
  blocks = 0;
  if (info.err != cudaSuccess) return info.err;
  grid.tiles_x = (W + T::TW - 1) / T::TW;
  grid.tiles_y = (H + T::TH - 1) / T::TH;
  grid.n_nb = (Cout + T::BN - 1) / T::BN;
  grid.nchunks = (Cin + T::CK - 1) / T::CK;
  const long items = (long)N * grid.tiles_y * grid.tiles_x * grid.n_nb;
  if (items == 0) return cudaSuccess;
  if (items > 0x7fffffffL) return cudaErrorInvalidValue;
  grid.n_items = (int)items;
  long b = (long)info.blocks_per_sm * info.sms;
  b = b < items ? b : items;
  b = b / grid.n_nb * grid.n_nb;  // a multiple of n_nb: one channel block per block
  blocks = (unsigned)(b < grid.n_nb ? grid.n_nb : b);
  return cudaSuccess;
}

template <class T, int ACT, int EPI>
cudaError_t launch_conv_tc(const float* x, const float* w, float* y, int N, int H, int W,
                           int Cin, int Cout, const EpiArgs& epi, cudaStream_t stream) {
  auto kernel = conv_tc_kernel<T, ACT, EPI>;
  static PerDevice<LaunchInfo> state;  // once per kernel and device
  const LaunchInfo* info = state.get([&] { return query_launch(kernel, T::NT, T::SMEM); });
  if (!info) return cudaErrorInvalidDevice;
  ConvGrid grid;
  unsigned blocks;
  const cudaError_t err = plan_conv<T>(*info, N, H, W, Cin, Cout, grid, blocks);
  if (err != cudaSuccess || blocks == 0) return err;
  grid.vec_in = Cin % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  grid.vec_w = Cout % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  kernel<<<blocks, T::NT, T::SMEM, stream>>>(x, w, y, N, H, W, Cin, Cout, grid, epi);
  return cudaGetLastError();
}

// 8 x 16 pixels by 64 channels (8 warps of 32 px x 32 channels), in K
// chunks of 16 channels (8 when Cin <= 8).
template <int KS>
using WideTile = ConvTile<KS, 16, 4, 2, 2, 4>;
template <int KS>
using InTile = ConvTile<KS, 8, 4, 2, 2, 4>;

// ---------------------------------------------------------------------------
// The narrow head: 3x3 convs to at most 8 output channels
// ---------------------------------------------------------------------------
//
// The decoder's 64 -> 1 output conv (32 -> 1 in the 32-channel guide), in
// float32 and in the 16-bit types, and a fused block's convs where Cout <= 8.
// What bounds it on the H100: its input bytes.  It reads Cin values a pixel
// and writes Cout <= 8, and its 9 * Cin FMAs a pixel (one output channel)
// are a small fraction of the CUDA cores' rate, so tensor cores would add
// nothing (an n8 tile of them measured slower on it).
// What the design does:
// - Every input row is read from device memory once: a warp walks a column
//   strip of the map down its rows and keeps three rows of partial sums in
//   registers.  Input row r adds its taps dy = 0, 1, 2 to output rows
//   r + 1, r and r - 1, and output row r - 1 is complete after row r.  The
//   (image, strip, output channel) columns are cut into runs of rows, one
//   run per resident warp, so every warp of the persistent grid walks the
//   same number of rows (the run's first and last rows are its halo).
// - 16-byte words: a group of lp lanes (a power of two, at most 8) owns a
//   pixel's channels, each lane V = 16 / sizeof(E) consecutive channels of
//   it at a time (8 in 16 bits, 4 in float32), and HEAD_P = 4 consecutive
//   output pixels across the row, so a step (one row, one channel word a
//   lane) is HEAD_P + 2 words a lane.
// - Steps stream through a ring in shared memory: each lane copies its own
//   words of the step HEAD_STAGES - 1 ahead with 16-byte cp.async (zero
//   fill outside the image: SAME padding), and reads back only what it
//   copied, so the ring needs no barrier; each SM keeps about 96 KB in
//   flight.  A ragged Cin (no 16-byte words) is staged element by element.
// - Products are float32 FMAs (widened 16-bit values, exact), one channel
//   of the lane's word at a time: its HEAD_P + 2 values times the channel's
//   9 taps, which sit in shared memory as float32 rows of 12 (three 16-byte
//   words, shared by the lanes of one channel word), so only a channel's
//   values and taps are live.  A word's V rows are followed by one spare
//   16-byte word, so that the lp lanes of a group, each on its own channel
//   word, read distinct banks.  A lane sums, for each output pixel, its
//   channels over the three input rows (dy = 0, 1, 2), within a row its
//   channel words, then the word's channels, then dx = 0, 1, 2; the lp
//   lanes of a pixel group then add their sums with a shuffle butterfly
//   (tests/test_torch_narrow_conv.py models this order).
// - The output row is written as whole words where Cout == 1 (HEAD_P
//   values of a group in one 8- or 16-byte store), else element by element.
// Types: E is float32 (weight HWIO, (3, 3, Cin, Cout)) or bf16 / fp16
// (weight K-major, (9, Cout, Cin)); input and output are E; the activation
// (float32 blocks' conv0: silu of the staged input) and the epilogues are
// conv_tc_kernel's.

constexpr int HEAD_NT = 256;         // 8 independent warps
constexpr int HEAD_P = 4;            // output pixels of one lane group, across a row
constexpr int HEAD_LP = 8;           // lanes per pixel group, at most
constexpr int HEAD_MIN_ROWS = 4;     // rows of a warp's run, at least
constexpr int HEAD_STAGES = 4;       // the ring: steps in flight ahead of the one computed
constexpr int HEAD_STEP = (HEAD_P + 2) * 32 * 16;  // bytes of one step of one warp
constexpr int HEAD_RING = HEAD_STAGES * HEAD_STEP * (HEAD_NT / 32);  // bytes of a block's rings
constexpr int HEAD_TAPS = 12;        // floats of a channel's 9 taps in shared memory
// floats of a channel word's taps in shared memory: V rows and a spare 16-byte word
__host__ __device__ constexpr int head_word_floats(int v) { return v * HEAD_TAPS + 4; }

// The tiling of one head launch (conv3x3_head_kernel), from the launcher.
struct HeadGrid {
  int lp, wpl, words;  // lanes per pixel group, channel words per lane, words per pixel
  int span, nstrips;   // output pixels a strip is wide (32 / lp * HEAD_P), strips across
  int rows;            // rows of each warp's run
  long long total;     // N * nstrips * Cout * H: the rows of every column
  int vec, vec_out;    // 16-byte input words; one store of a group's HEAD_P outputs
};

// the first n < V values at p as one 16-byte word of E, zeros after them
// (a ragged Cin, which takes no 16-byte copies)
template <class E>
__device__ __forceinline__ uint4 head_word(const E* p, int n) {
  constexpr int V = 16 / sizeof(E);
  uint32_t b[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (k >= n) break;
    if constexpr (std::is_same<E, float>::value) {
      b[k] = __float_as_uint(p[k]);
    } else {
      b[k / 2] |= (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p + k)) << (16 * (k % 2));
    }
  }
  return make_uint4(b[0], b[1], b[2], b[3]);
}

// value k of a 16-byte word of E as a float (exact); k is a constant after
// unrolling
template <class E>
__device__ __forceinline__ float head_chan(const uint4& q, int k) {
  constexpr int PER = 4 / sizeof(E);  // values per 32-bit part
  const int part = k / PER;
  const uint32_t b = part == 0 ? q.x : part == 1 ? q.y : part == 2 ? q.z : q.w;
  if constexpr (std::is_same<E, float>::value) {
    return __uint_as_float(b);
  } else {
    const float2 v = unpack2(b, static_cast<E*>(nullptr));
    return k % 2 ? v.y : v.x;
  }
}

template <class E, int ACT, int EPI>
__global__ void __launch_bounds__(HEAD_NT, 2)
conv3x3_head_kernel(const E* __restrict__ x, const E* __restrict__ w, E* __restrict__ y, int N,
                    int H, int W, int Cin, int Cout, const HeadGrid hg, const EpiArgs epi) {
  constexpr int V = 16 / sizeof(E), P = HEAD_P, WF = head_word_floats(V);
  // the warps' rings, then the weights (co, word, V x HEAD_TAPS + 4) in float32
  extern __shared__ __align__(16) unsigned char head_smem[];
  float* head_w = reinterpret_cast<float*>(head_smem + HEAD_RING);
  const int lp = hg.lp, wpl = hg.wpl;
  for (int i = threadIdx.x; i < Cout * hg.words * WF; i += HEAD_NT) {
    const int j = i % WF, word = (i / WF) % hg.words, co = i / (WF * hg.words);
    const int tap = j % HEAD_TAPS, c = word * V + j / HEAD_TAPS;
    float v = 0.0f;
    if (j < V * HEAD_TAPS && c < Cin && tap < 9)
      v = std::is_same<E, float>::value ? load_f32(w + ((size_t)tap * Cin + c) * Cout + co)
                                        : load_f32(w + ((size_t)tap * Cout + co) * Cin + c);
    head_w[i] = v;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, grp = lane / lp, gl = lane % lp;
  // this lane's word q of ring stage st
  unsigned char* ring = head_smem + (threadIdx.x / 32) * HEAD_STAGES * HEAD_STEP + lane * 16;
  auto slot = [&](int st, int q) { return ring + (st * (P + 2) + q) * 32 * 16; };
  long long t = ((long long)blockIdx.x * (HEAD_NT / 32) + threadIdx.x / 32) * hg.rows;
  const long long t_end = t + hg.rows < hg.total ? t + hg.rows : hg.total;
  while (t < t_end) {  // the run crosses column boundaries: one band per column
    const long long col = t / H;
    const int y0 = (int)(t - col * H);
    const int y1 = (int)(H - y0 < t_end - t ? H : y0 + (t_end - t));
    t += y1 - y0;
    const int co = (int)(col % Cout);
    const long long sc = col / Cout;
    const int strip = (int)(sc % hg.nstrips), n = (int)(sc / hg.nstrips);
    const int x0 = strip * hg.span + grp * P;  // the group's first output pixel
    const E* xn = x + (size_t)n * H * W * Cin;
    const float* wco = head_w + (size_t)co * hg.words * WF;
    const int steps = (y1 - y0 + 2) * wpl;

    // step s: input row y0 - 1 + s / wpl, channel word gl + (s % wpl) * lp,
    // into ring stage s % HEAD_STAGES
    auto stage = [&](int s) {
      const int r = y0 - 1 + s / wpl, c0 = (gl + (s % wpl) * lp) * V;
      const bool row_ok = r >= 0 && r < H && c0 < Cin;
#pragma unroll
      for (int q = 0; q < P + 2; ++q) {
        const int xx = x0 - 1 + q;
        const bool ok = row_ok && xx >= 0 && xx < W;
        const E* src = ok ? xn + ((size_t)r * W + xx) * Cin + c0 : x;
        unsigned char* dst = slot(s % HEAD_STAGES, q);
        if (hg.vec)
          cp_async16(reinterpret_cast<float*>(dst), reinterpret_cast<const float*>(src), ok);
        else
          *reinterpret_cast<uint4*>(dst) = ok ? head_word(src, Cin - c0)
                                              : make_uint4(0u, 0u, 0u, 0u);
      }
    };

    float acc[3][P];  // output rows r - 1, r, r + 1 of input row r
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int p = 0; p < P; ++p) acc[j][p] = 0.0f;
#pragma unroll
    for (int s = 0; s < HEAD_STAGES - 1; ++s) {
      if (s < steps) stage(s);
      cp_async_commit();
    }
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
      if (s + HEAD_STAGES - 1 < steps) stage(s + HEAD_STAGES - 1);
      cp_async_commit();
      cp_async_wait<HEAD_STAGES - 1>();  // this lane's copies of step s have landed
      const int r = y0 - 1 + s / wpl, wi = s % wpl, c0 = (gl + wi * lp) * V;
      if (r >= 0 && r < H && c0 < Cin) {
        uint4 cur[P + 2];
#pragma unroll
        for (int q = 0; q < P + 2; ++q)
          cur[q] = *reinterpret_cast<const uint4*>(slot(s % HEAD_STAGES, q));
#pragma unroll
        for (int e = 0; e < V; ++e) {  // channel c0 + e
          float f[P + 2];
#pragma unroll
          for (int q = 0; q < P + 2; ++q) {
            f[q] = head_chan<E>(cur[q], e);
            if (ACT == IN_SILU) f[q] = silu(f[q]);
          }
          const float4* wp =
              reinterpret_cast<const float4*>(wco + (c0 / V) * WF + e * HEAD_TAPS);
          const float4 w0 = wp[0], w1 = wp[1], w2 = wp[2];
          const float wt[9] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w, w2.x};
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx)
#pragma unroll
              for (int p = 0; p < P; ++p)
                acc[2 - dy][p] = fmaf(f[p + dx], wt[dy * 3 + dx], acc[2 - dy][p]);
        }
      }
      if (wi == wpl - 1) {  // row r is in: output row r - 1 is complete
        if (r > y0) {
#pragma unroll
          for (int p = 0; p < P; ++p)
            for (int off = lp / 2; off > 0; off /= 2)
              acc[0][p] += __shfl_xor_sync(0xffffffffu, acc[0][p], off);
          const size_t base = ((size_t)n * H + (r - 1)) * W;
          if (hg.vec_out && x0 + P <= W) {  // Cout == 1: the group's P outputs in one store
            if (gl == 0) {
              float v[P];
#pragma unroll
              for (int p = 0; p < P; ++p)
                v[p] = epilogue<EPI, E>(acc[0][p], epi, n, Cout, co, base + x0 + p);
              if constexpr (std::is_same<E, float>::value) {
                *reinterpret_cast<float4*>(y + base + x0) = make_float4(v[0], v[1], v[2], v[3]);
              } else {
                *reinterpret_cast<uint2*>(y + base + x0) =
                    make_uint2(pack2<E>(v[0], v[1]), pack2<E>(v[2], v[3]));
              }
            }
          } else {
#pragma unroll
            for (int p = 0; p < P; ++p) {
              if (p % lp != gl || x0 + p >= W) continue;
              const size_t off = (base + x0 + p) * Cout + co;
              y[off] = from_f32<E>(epilogue<EPI, E>(acc[0][p], epi, n, Cout, co, off));
            }
          }
        }
#pragma unroll
        for (int p = 0; p < P; ++p) {
          acc[0][p] = acc[1][p];
          acc[1][p] = acc[2][p];
          acc[2][p] = 0.0f;
        }
      }
    }
    cp_async_wait<0>();  // the run's tail: no copy outlives it
  }
}

template <class E, int ACT, int EPI>
cudaError_t launch_conv3x3_head(const E* x, const E* w, E* y, int N, int H, int W, int Cin,
                                int Cout, const EpiArgs& epi, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(E);
  auto kernel = conv3x3_head_kernel<E, ACT, EPI>;
  // once per kernel and device: the register-bound blocks per SM, with any
  // shared memory allowed
  static PerDevice<LaunchInfo> state;
  const LaunchInfo* info = state.get([&] {
    LaunchInfo i = query_launch(kernel, HEAD_NT, 0);
    if (i.err == cudaSuccess)
      i.err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)kMaxSmem);
    return i;
  });
  if (!info) return cudaErrorInvalidDevice;
  if (info->err != cudaSuccess) return info->err;
  if (Cout < 1 || Cout > 8 || Cin < 1) return cudaErrorInvalidValue;
  HeadGrid hg;
  hg.words = (Cin + V - 1) / V;
  hg.lp = 1;
  while (hg.lp < HEAD_LP && hg.lp < hg.words) hg.lp *= 2;
  hg.wpl = (hg.words + hg.lp - 1) / hg.lp;
  hg.span = 32 / hg.lp * HEAD_P;
  hg.nstrips = (W + hg.span - 1) / hg.span;
  hg.total = (long long)N * hg.nstrips * Cout * H;
  if (hg.total == 0) return cudaSuccess;
  const size_t smem = HEAD_RING + (size_t)Cout * hg.words * head_word_floats(V) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // resident warps: the register bound, and the shared memory of an SM
  // (228 KB, 1 KB of it reserved per block)
  int per_sm = (int)(233472 / (smem + 1024));
  per_sm = per_sm < info->blocks_per_sm ? per_sm : info->blocks_per_sm;
  per_sm = per_sm > 0 ? per_sm : 1;
  const long long warps = (long long)per_sm * info->sms * (HEAD_NT / 32);
  long long rows = (hg.total + warps - 1) / warps;
  rows = rows > HEAD_MIN_ROWS ? rows : HEAD_MIN_ROWS;
  if (rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  hg.rows = (int)rows;
  const long long runs = (hg.total + rows - 1) / rows;
  const long long blocks = (runs + HEAD_NT / 32 - 1) / (HEAD_NT / 32);
  auto a16 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  hg.vec = Cin % V == 0 && a16(x);
  hg.vec_out = Cout == 1 && W % HEAD_P == 0 && a16(y);
  kernel<<<(unsigned)blocks, HEAD_NT, smem, stream>>>(x, w, y, N, H, W, Cin, Cout, hg, epi);
  return cudaGetLastError();
}

// KS x KS conv, by the output width: the direct head kernel for 3x3 convs
// to at most 8 channels, else the tensor-core core.
template <int KS, int ACT, int EPI>
cudaError_t launch_conv(const float* x, const float* w, float* y, int N, int H, int W,
                        int Cin, int Cout, const EpiArgs& epi, cudaStream_t stream) {
  if (KS == 3 && Cout <= 8)
    return launch_conv3x3_head<float, ACT, EPI>(x, w, y, N, H, W, Cin, Cout, epi, stream);
  if (Cin <= 8)
    return launch_conv_tc<InTile<KS>, ACT, EPI>(x, w, y, N, H, W, Cin, Cout, epi, stream);
  return launch_conv_tc<WideTile<KS>, ACT, EPI>(x, w, y, N, H, W, Cin, Cout, epi, stream);
}

// ---------------------------------------------------------------------------
// The 16-bit operand path (bf16 or fp16 activations and weights)
// ---------------------------------------------------------------------------
//
// Counterpart of the Pallas kernels' native MXU passes on bf16 / fp16 inputs
// (pallas_block.py::_dot_precision: Precision.DEFAULT off float32): the
// operands are the 16-bit type E, the products run on mma.sync.m16n8k16
// (K chunks of 16 channels, zeros past Cin) with float32 accumulators, one
// pass.
// Rounding points, as the JAX kernel's:
// - the operand is E, as it arrives: the block's prep pass (fused_block.cu)
//   writes the rounded operands round(xs) and round(silu(xs));
// - the sums are float32; the epilogue (gain + silu, residual mix + clip)
//   runs in float32 on them and rounds once, where the output is E (the
//   projection's output stays float32, as JAX's preferred_element_type
//   keeps it).
// Layouts: x (N, H, W, Cin) in E, the weight (KS * KS, Cout, Cin) in E, K
// contiguous (the wrapper lays it out), y (N, H, W, Cout) in E or float32.
// conv_wgmma.cuh's launch_conv_h chooses between this core, the wgmma core,
// the in-conv kernel and the head kernel; this core takes the shapes none
// of the others does.
// What bounds it on the H100: the decoder's convs do 9 * Cin * Cout FMAs per
// pixel against 2 * (Cin + Cout) bytes, so the 16-bit tensor cores bound
// them: FLOPs / 989 TFLOP/s.
// What the design does: the tiling, ring, persistent blocks and epilogues of
// conv_tc_kernel, with 16-bit tiles.  Staged rows are padded to 24 halves
// (48 bytes, a multiple of the 16-byte copies): with two neighbouring
// channels in one 32-bit fragment register (NHWC keeps them adjacent), lane
// (g, t) reads word 12 g + t, so every fragment load of A and of B (the
// weight rows are K contiguous) hits 32 distinct banks.

// d += a (16x16, row) * b (16x8, col) in E with float32 accumulators;
// fragments: a[0] (g, 2t..2t+1), a[1] (g + 8, 2t..), a[2] (g, 2t+8..),
// a[3] (g + 8, 2t+8..); b[0] (k 2t..2t+1, n g), b[1] (k 2t+8.., n g).
template <class E>
__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  if constexpr (std::is_same<E, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// 16-byte asynchronous copy of the first `bytes` (0..16) bytes at src, the
// rest zero-filled (src is not read when bytes is 0)
__device__ __forceinline__ void cp_async16_raw(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async4_raw(void* dst, const void* src, bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 4 : 0));
}

__device__ __forceinline__ uint32_t lds32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int KS_, int CK_, int WARPS_M_, int WARPS_N_, int WM_, int WN_>
struct ConvTileH {
  static constexpr int KS = KS_, CK = CK_, WM = WM_, WN = WN_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int STAGES = 2;
  static constexpr int NT = WARPS_M * WARPS_N * 32;
  static_assert(CK == 16, "K chunks are one k16 step");
  static constexpr int TW = 16;
  static constexpr int TH = WARPS_M * WM;
  static constexpr int BN = WARPS_N * WN * 8;
  static constexpr int IN_H = TH + KS - 1;
  static constexpr int IN_W = TW + KS - 1;
  static constexpr int CIP = 24;  // halves per staged pixel: word 12 g + t
  static constexpr int CKP = 24;  // halves per staged weight row
  static constexpr int IN_BYTES = 2 * IN_H * IN_W * CIP;
  static constexpr int W_BYTES = 2 * KS * KS * BN * CKP;
  static constexpr int STAGE = IN_BYTES + W_BYTES;
  static constexpr int SMEM = STAGES * STAGE;
};

// grid.vec_in / vec_w of the 16-bit kernel: 2 = 16-byte copies of 8
// channels, 1 = 4-byte copies of 2 channels, 0 = element by element
template <class T, class E, bool OUT_F32, int EPI>
__global__ void __launch_bounds__(T::NT, 2)
conv_h_kernel(const E* __restrict__ x, const E* __restrict__ w, void* __restrict__ yv,
              int N, int H, int W, int Cin, int Cout, const ConvGrid grid, const EpiArgs epi) {
  constexpr int KS = T::KS, CK = T::CK, WM = T::WM, WN = T::WN;
  constexpr int STAGE = T::STAGE;
  extern __shared__ __align__(16) unsigned char h_smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
  const int tiles_x = grid.tiles_x, tiles_y = grid.tiles_y;
  const int n_nb = grid.n_nb, nchunks = grid.nchunks;
  const int vec_in = grid.vec_in, vec_w = grid.vec_w;
  const int co0 = (blockIdx.x % n_nb) * T::BN;
  const int my_items =
      (grid.n_items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int nsteps = my_items * nchunks;

  auto item_tile = [&](int k, int& n, int& ty, int& tx) {
    const int tile = ((int)blockIdx.x + k * (int)gridDim.x) / n_nb;
    tx = tile % tiles_x;
    ty = (tile / tiles_x) % tiles_y;
    n = tile / (tiles_x * tiles_y);
  };

  auto load_step = [&](int st) {
    int n, ty, tx;
    item_tile(st / nchunks, n, ty, tx);
    const int c0 = (st % nchunks) * CK;
    unsigned char* slot = h_smem + (st % T::STAGES) * STAGE;
    E* s_in = reinterpret_cast<E*>(slot);
    E* s_w = reinterpret_cast<E*>(slot + T::IN_BYTES);
    const int y0 = ty * T::TH - KS / 2, x0 = tx * T::TW - KS / 2;
    const E* xn = x + (size_t)n * H * W * Cin;
    if (vec_in == 2) {
      constexpr int Q = CK / 8;
#pragma unroll 1
      for (int i = tid; i < T::IN_H * T::IN_W * Q; i += T::NT) {
        const int q = i % Q, pos = i / Q;
        const int gy = y0 + pos / T::IN_W, gx = x0 + pos % T::IN_W;
        const int c = c0 + 8 * q;
        const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c < Cin;
        cp_async16_raw(s_in + pos * T::CIP + 8 * q,
                       ok ? xn + ((size_t)gy * W + gx) * Cin + c : xn, ok ? 16 : 0);
      }
    } else if (vec_in == 1) {
      constexpr int Q = CK / 2;
#pragma unroll 1
      for (int i = tid; i < T::IN_H * T::IN_W * Q; i += T::NT) {
        const int q = i % Q, pos = i / Q;
        const int gy = y0 + pos / T::IN_W, gx = x0 + pos % T::IN_W;
        const int c = c0 + 2 * q;
        const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c < Cin;
        cp_async4_raw(s_in + pos * T::CIP + 2 * q,
                      ok ? xn + ((size_t)gy * W + gx) * Cin + c : xn, ok);
      }
    } else {
#pragma unroll 1
      for (int i = tid; i < T::IN_H * T::IN_W * CK; i += T::NT) {
        const int ci = i % CK, pos = i / CK;
        const int gy = y0 + pos / T::IN_W, gx = x0 + pos % T::IN_W;
        const int c = c0 + ci;
        const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c < Cin;
        s_in[pos * T::CIP + ci] = ok ? xn[((size_t)gy * W + gx) * Cin + c] : from_f32<E>(0.0f);
      }
    }
    if (nchunks == 1 && st >= T::STAGES) return;  // resident weights
    // weight rows (tap, output channel), K contiguous: w[(tap * Cout + co) * Cin + c]
    if (vec_w == 2) {
      constexpr int Q = CK / 8;
#pragma unroll 1
      for (int i = tid; i < KS * KS * T::BN * Q; i += T::NT) {
        const int q = i % Q, row = i / Q;  // row = tap * BN + col
        const int co = co0 + row % T::BN, tap = row / T::BN;
        const int c = c0 + 8 * q;
        const bool ok = c < Cin && co < Cout;
        cp_async16_raw(s_w + row * T::CKP + 8 * q,
                       ok ? w + ((size_t)tap * Cout + co) * Cin + c : w, ok ? 16 : 0);
      }
    } else if (vec_w == 1) {
      constexpr int Q = CK / 2;
#pragma unroll 1
      for (int i = tid; i < KS * KS * T::BN * Q; i += T::NT) {
        const int q = i % Q, row = i / Q;
        const int co = co0 + row % T::BN, tap = row / T::BN;
        const int c = c0 + 2 * q;
        const bool ok = c < Cin && co < Cout;
        cp_async4_raw(s_w + row * T::CKP + 2 * q,
                      ok ? w + ((size_t)tap * Cout + co) * Cin + c : w, ok);
      }
    } else {
#pragma unroll 1
      for (int i = tid; i < KS * KS * T::BN * CK; i += T::NT) {
        const int ci = i % CK, row = i / CK;
        const int co = co0 + row % T::BN, tap = row / T::BN;
        const int c = c0 + ci;
        const bool ok = c < Cin && co < Cout;
        s_w[row * T::CKP + ci] = ok ? w[((size_t)tap * Cout + co) * Cin + c] : from_f32<E>(0.0f);
      }
    }
  };

  float acc[WM][WN][4];
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0f;

#pragma unroll
  for (int st = 0; st < T::STAGES - 1; ++st) {
    if (st < nsteps) load_step(st);
    cp_async_commit();
  }
  for (int st = 0; st < nsteps; ++st) {
    if (st + T::STAGES - 1 < nsteps) load_step(st + T::STAGES - 1);
    cp_async_commit();
    cp_async_wait<T::STAGES - 1>();
    __syncthreads();
    unsigned char* slot = h_smem + (st % T::STAGES) * STAGE;
    const E* s_in = reinterpret_cast<const E*>(slot);
    const E* s_w = reinterpret_cast<const E*>(slot + T::IN_BYTES);

    const E* a_base = s_in + (wm * WM * T::IN_W + g) * T::CIP + 2 * t;
    const E* b_base = s_w + (wn * WN * 8 + g) * T::CKP + 2 * t;
#pragma unroll 1
    for (int tap = 0; tap < KS * KS; ++tap) {
      const int dy = tap / KS, dx = tap - dy * KS;
      const E* a_tap = a_base + (dy * T::IN_W + dx) * T::CIP;
      const E* b_tap = b_base + tap * T::BN * T::CKP;
      uint32_t b[WN][2];
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        const E* bp = b_tap + j * 8 * T::CKP;
        b[j][0] = lds32(bp);
        b[j][1] = lds32(bp + 8);
      }
#pragma unroll
      for (int i = 0; i < WM; ++i) {
        const E* ap = a_tap + i * T::IN_W * T::CIP;
        const uint32_t a[4] = {lds32(ap), lds32(ap + 8 * T::CIP), lds32(ap + 8),
                               lds32(ap + 8 * T::CIP + 8)};
#pragma unroll
        for (int j = 0; j < WN; ++j) mma_k16<E>(acc[i][j], a, b[j]);
      }
    }

    if (st % nchunks == nchunks - 1) {  // the item's last chunk: epilogue
      int n, ty, tx;
      item_tile(st / nchunks, n, ty, tx);
      const bool pairs = (Cout % 2) == 0;
#pragma unroll
      for (int i = 0; i < WM; ++i) {
        const int gy = ty * T::TH + wm * WM + i;
#pragma unroll
        for (int j = 0; j < WN; ++j) {
          const int co = co0 + (wn * WN + j) * 8 + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int gx = tx * T::TW + g + 8 * h;
            float v[2] = {acc[i][j][2 * h], acc[i][j][2 * h + 1]};
            acc[i][j][2 * h] = acc[i][j][2 * h + 1] = 0.0f;
            if (gy >= H || gx >= W || co >= Cout) continue;
            const size_t off = (((size_t)n * H + gy) * W + gx) * Cout + co;
            const bool two = co + 1 < Cout;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (e == 1 && !two) break;
              v[e] = epilogue<EPI, E>(v[e], epi, n, Cout, co + e, off + e);
            }
            if (OUT_F32) {
              float* y = reinterpret_cast<float*>(yv);
              if (two && pairs) {
                *reinterpret_cast<float2*>(y + off) = make_float2(v[0], v[1]);
              } else {
                y[off] = v[0];
                if (two) y[off + 1] = v[1];
              }
            } else {
              E* y = reinterpret_cast<E*>(yv);
              if (two && pairs) {
                *reinterpret_cast<uint32_t*>(y + off) = pack2<E>(v[0], v[1]);
              } else {
                y[off] = from_f32<E>(v[0]);
                if (two) y[off + 1] = from_f32<E>(v[1]);
              }
            }
          }
        }
      }
    }
    __syncthreads();  // slot st % STAGES is reloaded at step st + STAGES
  }
}

template <class T, class E, bool OUT_F32, int EPI>
cudaError_t launch_conv_h_tc(const E* x, const E* w, void* y, int N, int H, int W, int Cin,
                             int Cout, const EpiArgs& epi, cudaStream_t stream) {
  auto kernel = conv_h_kernel<T, E, OUT_F32, EPI>;
  static PerDevice<LaunchInfo> state;  // once per kernel and device
  const LaunchInfo* info = state.get([&] { return query_launch(kernel, T::NT, T::SMEM); });
  if (!info) return cudaErrorInvalidDevice;
  ConvGrid grid;
  unsigned blocks;
  const cudaError_t err = plan_conv<T>(*info, N, H, W, Cin, Cout, grid, blocks);
  if (err != cudaSuccess || blocks == 0) return err;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x), wa = reinterpret_cast<uintptr_t>(w);
  grid.vec_in = (Cin % 8 == 0 && (xa & 15) == 0) ? 2 : (Cin % 2 == 0 && (xa & 3) == 0) ? 1 : 0;
  grid.vec_w = (Cin % 8 == 0 && (wa & 15) == 0) ? 2 : (Cin % 2 == 0 && (wa & 3) == 0) ? 1 : 0;
  kernel<<<blocks, T::NT, T::SMEM, stream>>>(x, w, y, N, H, W, Cin, Cout, grid, epi);
  return cudaGetLastError();
}

template <int KS>
using WideTileH = ConvTileH<KS, 16, 4, 2, 2, 4>;

// The entry points' dtype codes (ops/cuda_lib.py DTYPE_CODES).  by_dtype
// calls f(static_cast<E*>(nullptr)) for the 16-bit type E of a code.
constexpr int DT_F32 = 0;
constexpr int DT_BF16 = 1;
constexpr int DT_F16 = 2;
template <class F>
cudaError_t by_dtype(int dtype, F&& f) {
  if (dtype == DT_BF16) return f(static_cast<__nv_bfloat16*>(nullptr));
  if (dtype == DT_F16) return f(static_cast<__half*>(nullptr));
  return cudaErrorInvalidValue;
}

}  // namespace tdt
