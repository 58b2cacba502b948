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
// (64..256 channels at 512..128 px) each conv does 9 * Cin * Cout FMAs per
// pixel against 4 * (Cin + Cout) bytes of activations, far above the
// card's float32 ridge point, so the block is bound by the float32 FMA rate
// of the CUDA cores (tensor cores would need TF32 or lower precision,
// which breaks float32 parity).
// What the design does: three launches.  The prologue (steps 1-3, or step 7
// when launched on the residual) gathers each pixel's channels into shared
// memory, applies the concat scales and the nearest-up by index
// arithmetic, projects and normalizes.  conv0 applies silu while staging its
// input and the gain + silu in its epilogue (steps 4-5); conv1 applies the
// residual mix and clip in its epilogue (steps 6, 8, 9).  The intermediates
// xs and h pass through device memory; the TPU kernel kept them in VMEM,
// which a later change can mirror by keeping them in shared memory.  The
// TPU-only devices (carried VMEM halo, tile-row picker, MXU tap packing, row
// masks, batch cutover) are gone: halos are staged per block and the image
// border is a bounds check.
#include "conv3x3.cuh"

namespace tdt {

constexpr int PRO_PIX = 8;  // pixels per prologue block

// out[p] = norm?(proj?(gather(p))) for each output pixel p of (N, H, W).
// gather: x2 == nullptr -> x scaled by s1 (x at half resolution when
// pre_up); else concat(x * s1, x2 * s2) along channels.
__global__ void __launch_bounds__(256)
block_prologue_kernel(const float* __restrict__ x, const float* __restrict__ x2,
                      float s1, float s2, int pre_up,
                      const float* __restrict__ wskip, int norm,
                      float* __restrict__ out, int N, int H, int W, int Cx,
                      int Cout) {
  extern __shared__ float smem[];
  const int Cg = x2 ? 2 * Cx : Cx;          // gathered channels
  const int Co = wskip ? Cout : Cg;         // written channels
  float* s_in = smem;                       // [PRO_PIX][Cg]
  float* s_proj = s_in + PRO_PIX * Cg;      // [PRO_PIX][Cout] when wskip
  float* s_den = s_proj + (wskip ? PRO_PIX * Cout : 0);  // [PRO_PIX]
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
      v = c < Cx ? x[src * Cx + c] * s1 : x2[src * Cx + (c - Cx)] * s2;
    }
    s_in[i] = v;
  }
  __syncthreads();

  const float* src = s_in;
  if (wskip) {
    for (int i = tid; i < PRO_PIX * Cout; i += blockDim.x) {
      const int p = i / Cout;
      const int o = i % Cout;
      const float* row = s_in + p * Cg;
      float acc = 0.0f;
      for (int c = 0; c < Cg; ++c) acc = fmaf(row[c], wskip[(long)c * Cout + o], acc);
      s_proj[i] = acc;
    }
    __syncthreads();
    src = s_proj;
  }

  if (norm) {
    const int warp = tid / 32;
    const int lane = tid % 32;
    for (int p = warp; p < PRO_PIX; p += blockDim.x / 32) {
      float ss = 0.0f;
      for (int c = lane; c < Co; c += 32) ss += src[p * Co + c] * src[p * Co + c];
#pragma unroll
      for (int off = 16; off > 0; off /= 2) ss += __shfl_xor_sync(0xffffffffu, ss, off);
      if (lane == 0) s_den[p] = 1e-4f + sqrtf(ss / (float)Co);
    }
    __syncthreads();
  }

  for (int i = tid; i < PRO_PIX * Co; i += blockDim.x) {
    const int p = i / Co;
    const long pix = pix0 + p;
    if (pix >= total) continue;
    const float v = src[i];
    out[pix * Co + (i % Co)] = norm ? v / s_den[p] : v;
  }
}

}  // namespace tdt

extern "C" int tdt_block_prologue(const float* x, const float* x2, float s1,
                                  float s2, int pre_up, const float* wskip,
                                  int norm, float* out, int N, int H, int W,
                                  int Cx, int Cout, void* stream) {
  const int Cg = x2 ? 2 * Cx : Cx;
  const size_t smem =
      sizeof(float) * (tdt::PRO_PIX * Cg + (wskip ? tdt::PRO_PIX * Cout : 0) +
                       tdt::PRO_PIX);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        tdt::block_prologue_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long total = (long)N * H * W;
  const unsigned blocks = (unsigned)((total + tdt::PRO_PIX - 1) / tdt::PRO_PIX);
  tdt::block_prologue_kernel<<<blocks, 256, smem, (cudaStream_t)stream>>>(
      x, x2, s1, s2, pre_up, wskip, norm, out, N, H, W, Cx, Cout);
  return (int)cudaGetLastError();
}

// h = silu(conv3x3(silu(xs), w0) * c)
extern "C" int tdt_block_conv0(const float* xs, const float* w0,
                               const float* c, float* h, int N, int H, int W,
                               int Cin, int Cmid, void* stream) {
  tdt::EpiArgs epi = {};
  epi.gain = c;
  return (int)tdt::launch_conv3x3<tdt::IN_SILU, tdt::EPI_GAIN_SILU>(
      xs, w0, h, N, H, W, Cin, Cmid, epi, (cudaStream_t)stream);
}

// out = clip((xres * res_a + conv3x3(h, w1) * res_b) / res_norm), with
// res_a = 1 - t, res_b = t, res_norm = sqrt((1 - t)^2 + t^2) from the caller
extern "C" int tdt_block_conv1(const float* h, const float* w1,
                               const float* xres, float* out, int N, int H,
                               int W, int Cmid, int Cout, float res_a,
                               float res_b, float res_norm, int clip,
                               float clip_val, void* stream) {
  tdt::EpiArgs epi = {};
  epi.residual = xres;
  epi.res_a = res_a;
  epi.res_b = res_b;
  epi.res_norm = res_norm;
  epi.clip = clip;
  epi.clip_val = clip_val;
  return (int)tdt::launch_conv3x3<tdt::IN_NONE, tdt::EPI_RESIDUAL>(
      h, w1, out, N, H, W, Cmid, Cout, epi, (cudaStream_t)stream);
}
