// Magnitude-preserving U-Net residual block at inference, NHWC float32.
//
// Replaces terrain_diffusion_tpu/ops/pallas_block.py::fused_block_apply (the
// Pallas bodies _block_kernel_carry / _block_kernel / _block_body /
// _conv3x3).  The block computes, in order:
//   1. optional mp_concat of a same-shape skip x2 with static scales,
//   2. optional nearest x2 pre-upsample,
//   3. enc mode: optional 1x1 projection, then pixel norm x / (1e-4 + rms),
//   4. silu, conv3x3 w0 (1/0.596 folded into the weight by the caller),
//   5. times the per-channel gain c, silu,
//   6. conv3x3 w1 (1/0.596 folded),
//   7. dec mode: optional 1x1 projection of the residual,
//   8. residual mix (x (1 - t) + y t) / sqrt((1 - t)^2 + t^2),
//   9. clip to +-clip_val unless an attention tail follows.
//
// What bounds it on the H100: the two 3x3 convs.  At the decoder's widths
// (64..448 input and 64..256 output channels at 512..128 px) each does
// 9 * Cin * Cout FMAs per pixel against 4 * (Cin + Cout) bytes, so the block
// is bound by the tensor cores in 3xTF32: 3 * FLOPs / 495 TFLOP/s.
// What the design does: the products (both 3x3 convs and the 1x1
// projection) run on one tensor-core core, conv3x3.cuh (implicit GEMM,
// 3xTF32, the float32 accuracy of the JAX kernel's Precision.HIGHEST dots).
// Up to four launches: the gather (step 1-2, and the pixel norm of step 3)
// is one memory-bound pass over each pixel's channels; the projection is
// the core with one tap; conv0 applies silu to its staged input tile and
// gain + silu in its epilogue (steps 4-5); conv1 applies the residual mix
// and clip in its epilogue (steps 6, 8, 9).  The intermediates xs and h pass
// through device memory; the TPU kernel kept them in VMEM.  The TPU-only
// devices (carried VMEM halo, tile-row picker, MXU tap packing, row masks,
// batch cutover) are gone: halos are staged per block and the image border
// is a bounds check.
//
// bf16 / fp16 (the Pallas kernel with compute_dtype = x.dtype): the same
// four launches on the 16-bit core of conv3x3.cuh, rounding where
// _block_body rounds (see the entry points below).  Bound by the 16-bit
// tensor cores: FLOPs / 989 TFLOP/s, one pass; xs, h and the output move at
// 4, 2 and 2 bytes a value.
#include "conv3x3.cuh"

namespace tdt {

constexpr int PRO_PIX = 8;  // pixels per gather block

// out[p] = norm?(gather(p)) for each output pixel p of (N, H, W).
// gather: x2 == nullptr -> x scaled by s1 (x at half resolution when
// pre_up); else concat(x * s1, x2 * s2) along channels.
// x and x2 are float32 or the 16-bit type of the block (TI); xs is float32
template <class TI>
__global__ void __launch_bounds__(256)
block_gather_kernel(const TI* __restrict__ x, const TI* __restrict__ x2,
                    float s1, float s2, int pre_up, int norm, float* __restrict__ out,
                    int N, int H, int W, int Cx) {
  extern __shared__ float smem[];
  const int Cg = x2 ? 2 * Cx : Cx;    // gathered channels
  float* s_in = smem;                 // [PRO_PIX][Cg]
  float* s_den = s_in + PRO_PIX * Cg;  // [PRO_PIX]
  const long total = (long)N * H * W;
  const long pix0 = (long)blockIdx.x * PRO_PIX;
  const int tid = threadIdx.x;
  const int Hs = pre_up ? H / 2 : H;
  const int Ws = pre_up ? W / 2 : W;

  for (int i = tid; i < PRO_PIX * Cg; i += blockDim.x) {
    const int p = i / Cg;
    const int c = i % Cg;
    const long pix = pix0 + p;
    float v = 0.0f;
    if (pix < total) {
      const int n = (int)(pix / ((long)H * W));
      const int yy = (int)((pix / W) % H);
      const int xx = (int)(pix % W);
      const long src = ((long)n * Hs + (pre_up ? yy / 2 : yy)) * Ws +
                       (pre_up ? xx / 2 : xx);
      v = c < Cx ? to_f32(x[src * Cx + c]) * s1 : to_f32(x2[src * Cx + (c - Cx)]) * s2;
    }
    s_in[i] = v;
  }
  __syncthreads();

  if (norm) {
    const int warp = tid / 32;
    const int lane = tid % 32;
    for (int p = warp; p < PRO_PIX; p += blockDim.x / 32) {
      float ss = 0.0f;
      for (int c = lane; c < Cg; c += 32) ss += s_in[p * Cg + c] * s_in[p * Cg + c];
#pragma unroll
      for (int off = 16; off > 0; off /= 2) ss += __shfl_xor_sync(0xffffffffu, ss, off);
      if (lane == 0) s_den[p] = 1e-4f + sqrtf(ss / (float)Cg);
    }
    __syncthreads();
  }

  for (int i = tid; i < PRO_PIX * Cg; i += blockDim.x) {
    const int p = i / Cg;
    const long pix = pix0 + p;
    if (pix >= total) continue;
    const float v = s_in[i];
    out[pix * Cg + (i % Cg)] = norm ? v / s_den[p] : v;
  }
}

}  // namespace tdt

namespace tdt {

template <class TI>
cudaError_t launch_gather(const TI* x, const TI* x2, float s1, float s2, int pre_up, int norm,
                          float* out, int N, int H, int W, int Cx, cudaStream_t stream) {
  const int Cg = x2 ? 2 * Cx : Cx;
  const size_t smem = sizeof(float) * (PRO_PIX * Cg + PRO_PIX);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        block_gather_kernel<TI>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long total = (long)N * H * W;
  const unsigned blocks = (unsigned)((total + PRO_PIX - 1) / PRO_PIX);
  block_gather_kernel<TI><<<blocks, 256, smem, stream>>>(x, x2, s1, s2, pre_up, norm, out, N,
                                                         H, W, Cx);
  return cudaGetLastError();
}

}  // namespace tdt

// Every entry point takes the block's dtype code (tdt::DT_*).  float32: all
// tensors float32, weights HWIO / (Cin, Cout).  bf16 / fp16, rounding where
// the JAX kernel rounds (pallas_block.py::_block_body with compute_dtype =
// x.dtype): the gather reads the 16-bit x / x2 and writes the float32 xs
// (what JAX keeps in VMEM); the projection rounds its operand to 16 bits and
// writes float32; conv0 rounds silu(xs) and writes h = silu(conv * c)
// rounded to 16 bits; conv1 reads the residual (float32 xs or projection, or
// the 16-bit x itself where the block neither gathers nor projects) and
// rounds the output once.  16-bit weights arrive laid out (taps, Cout, Cin).

// xs (float32) = gather(x, x2): concat / nearest-up / pixel norm
extern "C" int tdt_block_gather(const void* x, const void* x2, float s1, float s2,
                                int pre_up, int norm, float* out, int N, int H, int W,
                                int Cx, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == tdt::DT_F32)
    return (int)tdt::launch_gather<float>(static_cast<const float*>(x),
                                          static_cast<const float*>(x2), s1, s2, pre_up, norm,
                                          out, N, H, W, Cx, s);
  return (int)tdt::by_dtype(dtype, [&](auto* e) {
    using E = std::remove_pointer_t<decltype(e)>;
    return tdt::launch_gather<E>(static_cast<const E*>(x), static_cast<const E*>(x2), s1, s2,
                                 pre_up, norm, out, N, H, W, Cx, s);
  });
}

// out (float32) = x @ wskip: the 1x1 projection on the conv core with one
// tap; x is float32 if x_f32 (always in float32 blocks), else 16-bit
extern "C" int tdt_block_proj(const void* x, int x_f32, const void* wskip, float* out, int N,
                              int H, int W, int Cin, int Cout, int dtype, void* stream) {
  tdt::EpiArgs epi = {};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == tdt::DT_F32)
    return (int)tdt::launch_conv<1, tdt::IN_NONE, tdt::EPI_NONE>(
        static_cast<const float*>(x), static_cast<const float*>(wskip), out, N, H, W, Cin,
        Cout, epi, s);
  return (int)tdt::by_dtype(dtype, [&](auto* e) {
    using E = std::remove_pointer_t<decltype(e)>;
    const E* w = static_cast<const E*>(wskip);
    return x_f32 ? tdt::launch_conv_h<1, E, true, true, tdt::IN_NONE, tdt::EPI_NONE>(
                       x, w, out, N, H, W, Cin, Cout, epi, s)
                 : tdt::launch_conv_h<1, E, false, true, tdt::IN_NONE, tdt::EPI_NONE>(
                       x, w, out, N, H, W, Cin, Cout, epi, s);
  });
}

// h = silu(conv3x3(silu(xs), w0) * c), h in the block's type; xs is float32
// if xs_f32 (always in float32 blocks), else 16-bit; c is float32
extern "C" int tdt_block_conv0(const void* xs, int xs_f32, const void* w0, const float* c,
                               void* h, int N, int H, int W, int Cin, int Cmid, int dtype,
                               void* stream) {
  tdt::EpiArgs epi = {};
  epi.gain = c;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == tdt::DT_F32)
    return (int)tdt::launch_conv<3, tdt::IN_SILU, tdt::EPI_GAIN_SILU>(
        static_cast<const float*>(xs), static_cast<const float*>(w0), static_cast<float*>(h), N,
        H, W, Cin, Cmid, epi, s);
  return (int)tdt::by_dtype(dtype, [&](auto* e) {
    using E = std::remove_pointer_t<decltype(e)>;
    const E* w = static_cast<const E*>(w0);
    return xs_f32 ? tdt::launch_conv_h<3, E, true, false, tdt::IN_SILU, tdt::EPI_GAIN_SILU>(
                        xs, w, h, N, H, W, Cin, Cmid, epi, s)
                  : tdt::launch_conv_h<3, E, false, false, tdt::IN_SILU, tdt::EPI_GAIN_SILU>(
                        xs, w, h, N, H, W, Cin, Cmid, epi, s);
  });
}

// out = clip((xres * res_a + conv3x3(h, w1) * res_b) / res_norm), with
// res_a = 1 - t, res_b = t, res_norm = sqrt((1 - t)^2 + t^2) from the caller;
// h and out in the block's type; xres is float32 if xres_f32 (always in
// float32 blocks), else 16-bit
extern "C" int tdt_block_conv1(const void* h, const void* w1, const void* xres, int xres_f32,
                               void* out, int N, int H, int W, int Cmid, int Cout,
                               float res_a, float res_b, float res_norm, int clip,
                               float clip_val, int dtype, void* stream) {
  tdt::EpiArgs epi = {};
  if (xres_f32 || dtype == tdt::DT_F32)
    epi.residual = static_cast<const float*>(xres);
  else
    epi.residual_h = xres;
  epi.res_a = res_a;
  epi.res_b = res_b;
  epi.res_norm = res_norm;
  epi.clip = clip;
  epi.clip_val = clip_val;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == tdt::DT_F32)
    return (int)tdt::launch_conv<3, tdt::IN_NONE, tdt::EPI_RESIDUAL>(
        static_cast<const float*>(h), static_cast<const float*>(w1), static_cast<float*>(out),
        N, H, W, Cmid, Cout, epi, s);
  return (int)tdt::by_dtype(dtype, [&](auto* e) {
    using E = std::remove_pointer_t<decltype(e)>;
    return tdt::launch_conv_h<3, E, false, false, tdt::IN_NONE, tdt::EPI_RESIDUAL>(
        h, static_cast<const E*>(w1), out, N, H, W, Cmid, Cout, epi, s);
  });
}
