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
// 9 * 64 FMAs per pixel) to be bound by the CUDA cores.
// What the design does: the 1-pixel halo is staged once per block in shared
// memory (the TPU kernel carried it between sequential grid steps; CUDA
// blocks run in no order, so each block loads its own halo, and the image
// border becomes a bounds check instead of a row mask), and the Cout = 1
// head runs one-channel tiles of 512 pixels so no lane computes a channel
// that does not exist.
#include "conv3x3.cuh"

extern "C" int tdt_conv3x3(const float* x, const float* w, float* y, int N,
                           int H, int W, int Cin, int Cout, void* stream) {
  tdt::EpiArgs epi = {};
  return (int)tdt::launch_conv3x3<tdt::IN_NONE, tdt::EPI_NONE>(
      x, w, y, N, H, W, Cin, Cout, epi, (cudaStream_t)stream);
}
