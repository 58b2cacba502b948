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
// - The 64 -> 1 head keeps a direct conv on the CUDA cores (see
//   conv3x3_head_kernel below): it is bound by its input bytes, and the
//   tensor-core tiles measured slower on it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tdt {

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
  static const LaunchInfo info = query_launch(kernel, T::NT, T::SMEM);  // once per kernel
  ConvGrid grid;
  unsigned blocks;
  const cudaError_t err = plan_conv<T>(info, N, H, W, Cin, Cout, grid, blocks);
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

// The narrow head (Cout <= 8: the decoder's 64 -> 1 output conv) keeps the
// direct conv on the CUDA cores: it reads 64 values per pixel and writes one,
// so it is bound by its input bytes, and the tensor-core core (n8 tiles,
// staged in 16- and 32-channel chunks) measured slower on it on an H100 at
// 512 x 512.  One block computes a 16 x 32 pixel tile of one output channel;
// the input is staged 8 channels at a time with its 1-pixel halo, and each
// thread accumulates 2 pixels in float32 FMAs, reusing each staged row
// across the three horizontal taps.  Types: the input TI (float32, or the
// 16-bit E), the operand E (a 16-bit operand is rounded to E after the
// activation), the weight in E, HWIO or, with KMAJOR, (tap, Cout, Cin), and
// the output TO; float32 throughout for the float32 conv.
template <class TI, class E, class TO, bool KMAJOR, int ACT, int EPI>
__global__ void __launch_bounds__(256)
conv3x3_head_kernel(const TI* __restrict__ x, const E* __restrict__ w, TO* __restrict__ y,
                    int N, int H, int W, int Cin, int Cout, EpiArgs epi) {
  constexpr int NT = 256, TH = 16, TW = 32, CI = 8, PX = 2;  // NT * PX == TH * TW
  constexpr int CIP = CI + 1;  // padded channel stride: spreads smem banks
  constexpr int IN_W = TW + 2;
  constexpr int IN_ELEMS = (TH + 2) * IN_W;

  __shared__ float s_in[IN_ELEMS * CIP];
  __shared__ float s_w[9 * CI];

  const int tid = threadIdx.x;
  const int row = (tid * PX) / TW;
  const int col0 = (tid * PX) % TW;
  const int n = blockIdx.z / Cout;
  const int co = blockIdx.z % Cout;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const TI* xn = x + (size_t)n * H * W * Cin;

  float acc[PX] = {0.0f, 0.0f};
  for (int c0 = 0; c0 < Cin; c0 += CI) {
    auto stage = [&](int i) {
      const int ci = i % CI;
      const int pos = i / CI;
      const int gy = y0 + pos / IN_W - 1;
      const int gx = x0 + pos % IN_W - 1;
      float v = 0.0f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c0 + ci < Cin) {
        v = load_f32(xn + ((size_t)gy * W + gx) * Cin + c0 + ci);
        if (ACT == IN_SILU) v = silu(v);
        if (ACT == IN_SILU || !std::is_same<TI, E>::value)
          v = to_f32(from_f32<E>(v));  // the operand is E (an input in E already is)
      }
      s_in[pos * CIP + ci] = v;
    };
    if constexpr (std::is_same<TI, float>::value) {
      for (int i = tid; i < IN_ELEMS * CI; i += NT) stage(i);
    } else {
      // a 16-bit input: unrolled, this loop's addresses go to local memory
      // at the 40 registers ptxas picks; rolled, the kernel fits in 32
#pragma unroll 1
      for (int i = tid; i < IN_ELEMS * CI; i += NT) stage(i);
    }
    if (tid < 9 * CI) {  // (tap, ci)
      const int ci = tid % CI, tap = tid / CI, c = c0 + ci;
      s_w[tid] = c >= Cin  ? 0.0f
                 : KMAJOR ? load_f32(w + ((size_t)tap * Cout + co) * Cin + c)
                          : load_f32(w + ((size_t)tap * Cin + c) * Cout + co);
    }
    __syncthreads();

#pragma unroll 2
    for (int ci = 0; ci < CI; ++ci) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float iv[PX + 2];
#pragma unroll
        for (int q = 0; q < PX + 2; ++q)
          iv[q] = s_in[((row + dy) * IN_W + col0 + q) * CIP + ci];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float wv = s_w[(dy * 3 + dx) * CI + ci];
#pragma unroll
          for (int p = 0; p < PX; ++p) acc[p] = fmaf(iv[p + dx], wv, acc[p]);
        }
      }
    }
    __syncthreads();
  }

  const int gy = y0 + row;
  if (gy >= H) return;
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int gx = x0 + col0 + p;
    if (gx >= W) continue;
    const size_t off = (((size_t)n * H + gy) * W + gx) * Cout + co;
    float v = acc[p];
    if (EPI == EPI_GAIN_SILU) {
      v = silu(v * epi.gain[(size_t)n * Cout + co]);
    } else if (EPI == EPI_RESIDUAL) {
      const float r = epi.residual ? epi.residual[off]
                                   : to_f32(reinterpret_cast<const E*>(epi.residual_h)[off]);
      v = (r * epi.res_a + v * epi.res_b) / epi.res_norm;
      if (epi.clip) v = fminf(fmaxf(v, -epi.clip_val), epi.clip_val);
    }
    y[off] = from_f32<TO>(v);
  }
}

template <class TI, class E, class TO, bool KMAJOR, int ACT, int EPI>
cudaError_t launch_conv3x3_head(const TI* x, const E* w, TO* y, int N, int H, int W, int Cin,
                                int Cout, const EpiArgs& epi, cudaStream_t stream) {
  dim3 grid((W + 31) / 32, (H + 15) / 16, N * Cout);
  conv3x3_head_kernel<TI, E, TO, KMAJOR, ACT, EPI><<<grid, 256, 0, stream>>>(
      x, w, y, N, H, W, Cin, Cout, epi);
  return cudaGetLastError();
}

// KS x KS conv, by the output width: the direct head kernel for 3x3 convs
// to at most 8 channels, else the tensor-core core.
template <int KS, int ACT, int EPI>
cudaError_t launch_conv(const float* x, const float* w, float* y, int N, int H, int W,
                        int Cin, int Cout, const EpiArgs& epi, cudaStream_t stream) {
  if (KS == 3 && Cout <= 8)
    return launch_conv3x3_head<float, float, float, false, ACT, EPI>(x, w, y, N, H, W, Cin,
                                                                     Cout, epi, stream);
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
// (m16n8k8 for K chunks of 8 channels) with float32 accumulators, one pass.
// Rounding points, as the JAX kernel's:
// - the operand is E, as it arrives: the block's prep pass (fused_block.cu)
//   writes the rounded operands round(xs) and round(silu(xs));
// - the sums are float32; the epilogue (gain + silu, residual mix + clip)
//   runs in float32 on them and rounds once, where the output is E (the
//   projection's output stays float32, as JAX's preferred_element_type
//   keeps it).
// Layouts: x (N, H, W, Cin) in E, the weight (KS * KS, Cout, Cin) in E, K
// contiguous (the wrapper lays it out), y (N, H, W, Cout) in E or float32.
// conv_wgmma.cuh's launch_conv_h chooses between this core, the wgmma core
// and the head kernel.
// What bounds it on the H100: the decoder's convs do 9 * Cin * Cout FMAs per
// pixel against 2 * (Cin + Cout) bytes, so the 16-bit tensor cores bound
// them: FLOPs / 989 TFLOP/s.  The 6 -> 64 input conv and the 64 -> 1 head
// stay bound by their bytes.
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

// d += a (16x8) * b (8x8): a[0] (g, 2t..2t+1), a[1] (g + 8, 2t..); b (k 2t.., n g)
template <class E>
__device__ __forceinline__ void mma_k8(float (&d)[4], const uint32_t (&a)[2], uint32_t b) {
  if constexpr (std::is_same<E, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(b));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(b));
  }
}

__device__ __forceinline__ void cp_async16_raw(void* dst, const void* src, bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 16 : 0));
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
  static_assert(CK == 8 || CK == 16, "K chunks are one k8 or one k16 step");
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
                       ok ? xn + ((size_t)gy * W + gx) * Cin + c : xn, ok);
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
                       ok ? w + ((size_t)tap * Cout + co) * Cin + c : w, ok);
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
      if constexpr (CK == 16) {
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
      } else {
        uint32_t b[WN];
#pragma unroll
        for (int j = 0; j < WN; ++j) b[j] = lds32(b_tap + j * 8 * T::CKP);
#pragma unroll
        for (int i = 0; i < WM; ++i) {
          const E* ap = a_tap + i * T::IN_W * T::CIP;
          const uint32_t a[2] = {lds32(ap), lds32(ap + 8 * T::CIP)};
#pragma unroll
          for (int j = 0; j < WN; ++j) mma_k8<E>(acc[i][j], a, b[j]);
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
  static const LaunchInfo info = query_launch(kernel, T::NT, T::SMEM);  // once per kernel
  ConvGrid grid;
  unsigned blocks;
  const cudaError_t err = plan_conv<T>(info, N, H, W, Cin, Cout, grid, blocks);
  if (err != cudaSuccess || blocks == 0) return err;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x), wa = reinterpret_cast<uintptr_t>(w);
  grid.vec_in = (Cin % 8 == 0 && (xa & 15) == 0) ? 2 : (Cin % 2 == 0 && (xa & 3) == 0) ? 1 : 0;
  grid.vec_w = (Cin % 8 == 0 && (wa & 15) == 0) ? 2 : (Cin % 2 == 0 && (wa & 3) == 0) ? 1 : 0;
  kernel<<<blocks, T::NT, T::SMEM, stream>>>(x, w, y, N, H, W, Cin, Cout, grid, epi);
  return cudaGetLastError();
}

template <int KS>
using WideTileH = ConvTileH<KS, 16, 4, 2, 2, 4>;
template <int KS>
using InTileH = ConvTileH<KS, 8, 4, 2, 2, 4>;

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
