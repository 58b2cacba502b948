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
// Up to five launches: the prep pass (steps 1-2, and the pixel norm of step
// 3, a second pass after an enc projection) is one memory-bound pass over
// each pixel's channels; the projection is the core with one tap; conv0 applies silu to its staged input tile and
// gain + silu in its epilogue (steps 4-5); conv1 applies the residual mix
// and clip in its epilogue (steps 6, 8, 9).  The intermediates xs and h pass
// through device memory; the TPU kernel kept them in VMEM.  The TPU-only
// devices (carried VMEM halo, tile-row picker, MXU tap packing, row masks,
// batch cutover) are gone: halos are staged per block and the image border
// is a bounds check.
//
// bf16 / fp16 (the Pallas kernel with compute_dtype = x.dtype): the same
// launches, rounding where _block_body rounds (see the entry points below),
// with the products on the 16-bit wgmma core of conv_wgmma.cuh (TMA-fed,
// weights kept in shared memory; conv3x3.cuh's mma.sync core for shapes it
// does not take).  TMA copies without converting, so the prep pass writes
// the 16-bit operands the convs read: round(silu(xs)) for conv0, round(xs)
// where a projection follows, and the float32 xs only where the residual
// needs it.  Bound by the 16-bit tensor cores: FLOPs / 989 TFLOP/s, one
// pass; the prep pass by its bytes (2 or 4 bytes a value read, 2 + 2 + 4
// at most written).
#include "conv_wgmma.cuh"

namespace tdt {

// 8 consecutive channels of a row as floats, from 16-byte words
template <class T>
__device__ __forceinline__ void load8(float (&v)[8], const T* p) {
  if constexpr (std::is_same<T, float>::value) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z,
    v[7] = b.w;
  } else {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = unpack2(w[k], static_cast<T*>(nullptr));
      v[2 * k] = f.x, v[2 * k + 1] = f.y;
    }
  }
}

// the first n of 8 values to consecutive elements, as 16-byte words when vec
template <class E>
__device__ __forceinline__ void store8(E* p, const float (&v)[8], bool vec, int n) {
  if (vec) {
    if constexpr (std::is_same<E, float>::value) {
      reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
      *reinterpret_cast<uint4*>(p) = make_uint4(pack2<E>(v[0], v[1]), pack2<E>(v[2], v[3]),
                                                pack2<E>(v[4], v[5]), pack2<E>(v[6], v[7]));
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (k < n) p[k] = from_f32<E>(v[k]);
}

// For each output pixel of (N, H, W): v = norm?(gather(pixel)); writes xs = v
// (float32), xr = round_E(v) and a = round_E(fast_silu(v)), each where its
// pointer is not null.  gather: x2 == nullptr -> x scaled by s1 (x at half
// resolution when pre_up); else concat(x * s1, x2 * s2) along channels.
// x and x2 are float32 or E (TI).  fast_silu is the silu the 16-bit conv
// core applied to its staged input before the prep pass wrote a.
// A group of lp lanes (a power of two) owns a pixel, each lane 8
// consecutive channels at a time: 16-byte loads and stores
// where vec (Cx % 8 == 0, 16-byte aligned tensors), else element by
// element; the pixel norm sums over the group with shuffles, then the
// second pass re-reads the pixel (from L1) to write.
template <class TI, class E>
__global__ void __launch_bounds__(256)
block_prep_kernel(const TI* __restrict__ x, const TI* __restrict__ x2, float s1, float s2,
                  int pre_up, int norm, float* __restrict__ xs, E* __restrict__ xr,
                  E* __restrict__ a, int N, int H, int W, int Cx, int lp, int vec) {
  const int Cg = x2 ? 2 * Cx : Cx;  // gathered channels
  const int lane = threadIdx.x & 31, sub = lane / lp, gl = lane % lp;
  const int total = N * H * W;
  const int pix = ((int)blockIdx.x * 8 + (int)threadIdx.x / 32) * (32 / lp) + sub;
  const bool live = pix < total;
  const int Hs = pre_up ? H / 2 : H, Ws = pre_up ? W / 2 : W;
  int src = 0;
  if (live) {
    const int n = pix / (H * W), yy = (pix / W) % H, xx = pix % W;
    src = (n * Hs + (pre_up ? yy / 2 : yy)) * Ws + (pre_up ? xx / 2 : xx);
  }
  // channels [c, c + 8) of the gathered pixel (zeros past Cg)
  auto gather8 = [&](float (&v)[8], int c) {
    if (vec) {
      const bool first = c < Cx;
      load8(v, first ? x + (size_t)src * Cx + c : x2 + (size_t)src * Cx + (c - Cx));
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] *= first ? s1 : s2;
      return;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int ck = c + k;
      v[k] = ck >= Cg   ? 0.0f
             : ck < Cx ? load_f32(x + (size_t)src * Cx + ck) * s1
                       : load_f32(x2 + (size_t)src * Cx + (ck - Cx)) * s2;
    }
  };
  float den = 1.0f;
  if (norm) {
    float ss = 0.0f;
    if (live)
      for (int c = gl * 8; c < Cg; c += lp * 8) {
        float v[8];
        gather8(v, c);
#pragma unroll
        for (int k = 0; k < 8; ++k) ss += v[k] * v[k];
      }
    for (int off = lp / 2; off > 0; off /= 2) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    den = 1e-4f + sqrtf(ss / (float)Cg);
  }
  if (!live) return;
  for (int c = gl * 8; c < Cg; c += lp * 8) {
    float v[8];
    gather8(v, c);
    if (norm) {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = v[k] / den;
    }
    const size_t o = (size_t)pix * Cg + c;
    const int n = Cg - c;
    if (xs) store8(xs + o, v, vec, n);
    if (xr) store8(xr + o, v, vec, n);
    if (a) {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = fast_silu(v[k]);
      store8(a + o, v, vec, n);
    }
  }
}

template <class TI, class E>
cudaError_t launch_prep(const TI* x, const TI* x2, float s1, float s2, int pre_up, int norm,
                        float* xs, E* xr, E* a, int N, int H, int W, int Cx,
                        cudaStream_t stream) {
  const long total = (long)N * H * W;
  if (total == 0) return cudaSuccess;
  if (total > 0x7fffffffL) return cudaErrorInvalidValue;
  const int Cg = x2 ? 2 * Cx : Cx;
  // lanes per pixel: the largest power of two up to 32 that divides the
  // pixel's 8-channel groups, so that no lane idles (192 channels: 8 lanes
  // of 3 groups)
  const int groups = (Cg + 7) / 8;
  int lp = 1;
  while (lp < 32 && groups % (2 * lp) == 0) lp *= 2;
  auto a16 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int vec = Cx % 8 == 0 && a16(x) && a16(x2) && a16(xs) && a16(xr) && a16(a);
  const long per_block = 8L * (32 / lp);  // 8 warps of 32 / lp pixels
  const unsigned blocks = (unsigned)((total + per_block - 1) / per_block);
  block_prep_kernel<TI, E><<<blocks, 256, 0, stream>>>(x, x2, s1, s2, pre_up, norm, xs, xr, a,
                                                      N, H, W, Cx, lp, vec);
  return cudaGetLastError();
}

}  // namespace tdt

// Every entry point takes the block's dtype code (tdt::DT_*).  float32: all
// tensors float32, weights HWIO / (Cin, Cout).  bf16 / fp16, rounding where
// the JAX kernel rounds (pallas_block.py::_block_body with compute_dtype =
// x.dtype): the prep pass reads the 16-bit x / x2 (or the float32
// projection) and writes the operands the convs read, round(xs) for the
// projection and a = round(silu(xs)) for conv0, and the float32 xs (what
// JAX keeps in VMEM) where the residual needs it; the projection writes
// float32; conv0 writes h = silu(conv * c) rounded to 16 bits; conv1 reads
// the residual (float32 xs or projection, or the 16-bit x itself where the
// block neither gathers nor projects) and rounds the output once.  The
// convs' 16-bit inputs are never float32 (x_f32 / xs_f32 = 0).  16-bit
// weights arrive laid out (taps, Cout, Cin).

// prep: xs (float32), xr = round(xs) and a = round(silu(xs)) of
// gather(x, x2) (concat / nearest-up / pixel norm), each where its pointer
// is not null; x and x2 are float32 if x_f32 (always in float32 blocks,
// which write xs only), else 16-bit
extern "C" int tdt_block_prep(const void* x, const void* x2, int x_f32, float s1, float s2,
                              int pre_up, int norm, float* xs, void* xr, void* a, int N, int H,
                              int W, int Cx, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == tdt::DT_F32) {
    if (!x_f32 || xr || a) return (int)cudaErrorInvalidValue;
    return (int)tdt::launch_prep<float, float>(static_cast<const float*>(x),
                                               static_cast<const float*>(x2), s1, s2, pre_up,
                                               norm, xs, nullptr, nullptr, N, H, W, Cx, s);
  }
  return (int)tdt::by_dtype(dtype, [&](auto* e) {
    using E = std::remove_pointer_t<decltype(e)>;
    E* r = static_cast<E*>(xr);
    E* o = static_cast<E*>(a);
    if (x_f32)
      return tdt::launch_prep<float, E>(static_cast<const float*>(x),
                                        static_cast<const float*>(x2), s1, s2, pre_up, norm, xs,
                                        r, o, N, H, W, Cx, s);
    return tdt::launch_prep<E, E>(static_cast<const E*>(x), static_cast<const E*>(x2), s1, s2,
                                  pre_up, norm, xs, r, o, N, H, W, Cx, s);
  });
}

// out (float32) = x @ wskip: the 1x1 projection on the conv core with one
// tap; x is float32 if x_f32 (float32 blocks only), else 16-bit
extern "C" int tdt_block_proj(const void* x, int x_f32, const void* wskip, float* out, int N,
                              int H, int W, int Cin, int Cout, int dtype, void* stream) {
  tdt::EpiArgs epi = {};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == tdt::DT_F32)
    return (int)tdt::launch_conv<1, tdt::IN_NONE, tdt::EPI_NONE>(
        static_cast<const float*>(x), static_cast<const float*>(wskip), out, N, H, W, Cin,
        Cout, epi, s);
  if (x_f32) return (int)cudaErrorInvalidValue;
  return (int)tdt::by_dtype(dtype, [&](auto* e) {
    using E = std::remove_pointer_t<decltype(e)>;
    return tdt::launch_conv_h<1, E, true, tdt::EPI_NONE>(
        static_cast<const E*>(x), static_cast<const E*>(wskip), out, N, H, W, Cin, Cout, epi, s);
  });
}

// h = silu(conv3x3(act(xs), w0) * c), h in the block's type; float32
// blocks: xs is the float32 xs (xs_f32 = 1) and act is silu; 16-bit blocks:
// xs is the prep pass's a = round(silu(xs)) (xs_f32 = 0) and act is none;
// c is float32
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
  if (xs_f32) return (int)cudaErrorInvalidValue;
  return (int)tdt::by_dtype(dtype, [&](auto* e) {
    using E = std::remove_pointer_t<decltype(e)>;
    return tdt::launch_conv_h<3, E, false, tdt::EPI_GAIN_SILU>(
        static_cast<const E*>(xs), static_cast<const E*>(w0), h, N, H, W, Cin, Cmid, epi, s);
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
    return tdt::launch_conv_h<3, E, false, tdt::EPI_RESIDUAL>(
        static_cast<const E*>(h), static_cast<const E*>(w1), out, N, H, W, Cmid, Cout, epi, s);
  });
}
