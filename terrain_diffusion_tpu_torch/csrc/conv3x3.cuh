// Direct SAME-padded 3x3 convolution over NHWC float32 tensors, with an
// optional activation applied to the input as it is staged and an optional
// epilogue.  Shared by the standalone conv (conv3x3.cu) and the fused
// residual block (fused_block.cu).
//
// Layouts: x (N, H, W, Cin), weight HWIO (3, 3, Cin, Cout), y (N, H, W, Cout),
// all C-contiguous.  Accumulation is in float32 FMAs on the CUDA cores: the
// port serves in float32 and holds the JAX package's full-precision f32
// convs, which TF32 tensor cores (10-bit mantissa) cannot match.
//
// Design: one block computes a TH x TW pixel tile for COT = CO * NCO output
// channels.  The input is staged in shared memory one CI-channel chunk at a
// time together with its 1-pixel halo (zero outside the image: SAME
// padding), and the chunk's 3 x 3 x CI x COT weights beside it.  Each thread
// holds PX neighbouring pixels x CO channels of accumulators in registers
// and reuses each staged input row across the three horizontal taps.
#pragma once

#include <cuda_runtime.h>

namespace tdt {

enum InAct { IN_NONE = 0, IN_SILU = 1 };
enum Epilogue { EPI_NONE = 0, EPI_GAIN_SILU = 1, EPI_RESIDUAL = 2 };

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

struct EpiArgs {
  const float* gain;      // EPI_GAIN_SILU: (N, Cout) per-channel gain
  const float* residual;  // EPI_RESIDUAL: (N, H, W, Cout)
  float res_a;            // residual weight (1 - t)
  float res_b;            // conv weight t
  float res_norm;         // sqrt((1 - t)^2 + t^2)
  int clip;               // clip the result to +-clip_val
  float clip_val;
};

template <int TH, int TW, int CI, int CO, int NCO, int PX, int ACT, int EPI>
__global__ void __launch_bounds__(256)
conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
               float* __restrict__ y, int N, int H, int W, int Cin, int Cout,
               EpiArgs epi) {
  constexpr int NT = 256;
  constexpr int COT = CO * NCO;  // output channels per block
  constexpr int NPX = NT / NCO;  // pixel groups per block
  static_assert(NPX * PX == TH * TW, "pixel tiling must cover the tile");
  static_assert(TW % PX == 0, "a thread's pixels lie in one row");
  constexpr int CIP = CI + 1;  // padded channel stride: spreads smem banks
  constexpr int IN_W = TW + 2;
  constexpr int IN_ELEMS = (TH + 2) * IN_W;

  __shared__ float s_in[IN_ELEMS * CIP];
  __shared__ float s_w[9 * CI * COT];

  const int tid = threadIdx.x;
  const int cg = tid % NCO;
  const int pg = tid / NCO;
  const int row = (pg * PX) / TW;
  const int col0 = (pg * PX) % TW;
  const int n_cot = (Cout + COT - 1) / COT;
  const int n = blockIdx.z / n_cot;
  const int co0 = (blockIdx.z % n_cot) * COT;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const float* xn = x + (size_t)n * H * W * Cin;

  float acc[PX][CO];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int k = 0; k < CO; ++k) acc[p][k] = 0.0f;

  for (int c0 = 0; c0 < Cin; c0 += CI) {
    for (int i = tid; i < IN_ELEMS * CI; i += NT) {
      const int ci = i % CI;
      const int pos = i / CI;
      const int gy = y0 + pos / IN_W - 1;
      const int gx = x0 + pos % IN_W - 1;
      float v = 0.0f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c0 + ci < Cin) {
        v = xn[((size_t)gy * W + gx) * Cin + c0 + ci];
        if (ACT == IN_SILU) v = silu(v);
      }
      s_in[pos * CIP + ci] = v;
    }
    for (int i = tid; i < 9 * CI * COT; i += NT) {
      const int co = i % COT;
      const int ci = (i / COT) % CI;
      const int tap = i / (COT * CI);
      float v = 0.0f;
      if (c0 + ci < Cin && co0 + co < Cout)
        v = w[((size_t)tap * Cin + c0 + ci) * Cout + co0 + co];
      s_w[i] = v;
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
          float wv[CO];
#pragma unroll
          for (int k = 0; k < CO; ++k)
            wv[k] = s_w[((dy * 3 + dx) * CI + ci) * COT + cg * CO + k];
#pragma unroll
          for (int p = 0; p < PX; ++p)
#pragma unroll
            for (int k = 0; k < CO; ++k)
              acc[p][k] = fmaf(iv[p + dx], wv[k], acc[p][k]);
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
    const size_t pix = ((size_t)n * H + gy) * W + gx;
#pragma unroll
    for (int k = 0; k < CO; ++k) {
      const int co = co0 + cg * CO + k;
      if (co >= Cout) continue;
      float v = acc[p][k];
      if (EPI == EPI_GAIN_SILU) {
        v = silu(v * epi.gain[(size_t)n * Cout + co]);
      } else if (EPI == EPI_RESIDUAL) {
        const float r = epi.residual[pix * Cout + co];
        v = (r * epi.res_a + v * epi.res_b) / epi.res_norm;
        if (epi.clip) v = fminf(fmaxf(v, -epi.clip_val), epi.clip_val);
      }
      y[pix * Cout + co] = v;
    }
  }
}

// Launch with a tile shape chosen by the output width: 64-channel tiles for
// the U-Net's wide convs, one-channel tiles for narrow heads (Cout = 1).
template <int ACT, int EPI>
inline cudaError_t launch_conv3x3(const float* x, const float* w, float* y,
                                  int N, int H, int W, int Cin, int Cout,
                                  const EpiArgs& epi, cudaStream_t stream) {
  if (Cout >= 32) {
    constexpr int TH = 8, TW = 16, CO = 8, NCO = 8;
    dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH,
              N * ((Cout + CO * NCO - 1) / (CO * NCO)));
    conv3x3_kernel<TH, TW, 8, CO, NCO, 4, ACT, EPI>
        <<<grid, 256, 0, stream>>>(x, w, y, N, H, W, Cin, Cout, epi);
  } else {
    constexpr int TH = 16, TW = 32;
    dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, N * Cout);
    conv3x3_kernel<TH, TW, 8, 1, 1, 2, ACT, EPI>
        <<<grid, 256, 0, stream>>>(x, w, y, N, H, W, Cin, Cout, epi);
  }
  return cudaGetLastError();
}

}  // namespace tdt
