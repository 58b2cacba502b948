// Standalone SAME-padded 3x3 convolution, NHWC float32.
//
// Replaces terrain_diffusion_tpu/ops/pallas_block.py::fused_conv3x3_apply
// (the Pallas bodies _conv_kernel_carry / _conv_kernel), which the JAX
// decoder uses for its 512x512 input conv (6 -> 64) and output conv
// (64 -> 1).  The weight arrives fully prepared (normalized, fan-in scaled,
// gain folded), HWIO.
//
// What bounds it on the H100: the 6 -> 64 input conv reads 6 floats and
// writes 64 per pixel, so it is bound by the store of its output (64 MB for
// one 512x512 tile); the 64 -> 1 head reads 64 floats per pixel and is
// bound by that read.  Neither does enough arithmetic (9 * 6 * 64 and
// 9 * 64 FMAs per pixel) to be bound by the tensor cores, even in 3xTF32.
// What the design does: the input conv runs on the tensor-core core of
// conv3x3.cuh in K chunks of 8 channels, so its 6 channels are one chunk:
// each persistent block stages the 13.8 KB weight once and keeps it
// resident while it walks its pixel tiles, and the halo of the next tile
// loads while this one computes (6-channel rows are 24 bytes, so they take
// 4-byte copies).  The 64 -> 1 head runs the direct conv of conv3x3.cuh on
// the CUDA cores (conv3x3_head_kernel): each warp walks a column strip down
// the map and keeps three rows of partial sums, so every input row is read
// once (the TPU kernel carried its halo between sequential grid steps; here
// a warp's run of rows carries it), through a per-warp ring of 16-byte
// cp.async copies; the image border is zero fill instead of a row mask.
//
// bf16 / fp16 (the Pallas kernel on a 16-bit x: MXU passes at
// Precision.DEFAULT, output in x.dtype): x, the weight and y are 16-bit,
// the sums float32, the output rounded once, each conv on the core
// conv_wgmma.cuh's conv16_path picks.  The input conv runs the in-conv
// kernel there (in_conv16_kernel: one GEMM with K = 9 taps x 8 channels
// padded to 80 on mma.sync, the weights resident, the output tile rounded
// into shared memory and written by one TMA store) and stays bound by its
// output bytes, now 2 bytes a value (33.6 MB for one 512x512 tile); the head
// reads bf16 / fp16, sums float32 FMAs on the CUDA cores and is bound by its
// input bytes; a conv with Cin % 16 == 0 and Cout % 64 == 0 runs on the
// wgmma core.
#include "conv_wgmma.cuh"

// dtype (tdt::DT_*): float32 x, y and HWIO weight; or bf16 / fp16 x, y and
// weight, the weight laid out (9, Cout, Cin) (the 16-bit form above).
extern "C" int tdt_conv3x3(const void* x, const void* w, void* y, int N, int H, int W,
                           int Cin, int Cout, int dtype, void* stream) {
  tdt::EpiArgs epi = {};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == tdt::DT_F32)
    return (int)tdt::launch_conv<3, tdt::IN_NONE, tdt::EPI_NONE>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(y), N,
        H, W, Cin, Cout, epi, s);
  return (int)tdt::by_dtype(dtype, [&](auto* e) {
    using E = std::remove_pointer_t<decltype(e)>;
    return tdt::launch_conv_h<3, E, false, tdt::EPI_NONE>(
        static_cast<const E*>(x), static_cast<const E*>(w), y, N, H, W, Cin, Cout, epi, s);
  });
}

// The core a 16-bit KS x KS conv from Cin to Cout channels takes
// (tdt::Conv16Path; ops/fused_block.py::conv16_path mirrors the rule).
extern "C" int tdt_conv16_path(int ks, int cin, int cout) {
  return tdt::conv16_path(ks, cin, cout);
}
