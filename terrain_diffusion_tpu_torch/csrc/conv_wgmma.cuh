// The 16-bit conv core on Hopper's warpgroup MMA (wgmma), fed by TMA: a
// SAME-padded KS x KS convolution (KS = 3, or 1 for the block's 1x1
// projection) over NHWC bf16 / fp16 tensors, with float32 sums and the
// epilogues of conv3x3.cuh.  Before its end, the 16-bit in conv (Cin <= 8:
// in_conv16_kernel), and at the end launch_conv_h, the one chooser of every
// 16-bit conv, whose rule is conv16_path.
//
// Replaces, with conv3x3.cuh's 16-bit mma.sync core for the shapes it does
// not take: terrain_diffusion_tpu/ops/pallas_block.py::fused_block_apply with
// compute_dtype bf16 / fp16 (its _conv3x3 at :110 and the projection dots of
// _block_body), and fused_conv3x3_apply on a 16-bit x.  It computes what
// conv_h_kernel computes, in the same order and with the same rounding:
// 16-bit operands, float32 sums, one pass, the epilogue (none, gain + silu,
// residual mix + clip) on the float32 sums, the output rounded once to E
// (float32 for the projection, as JAX's preferred_element_type leaves it).
//
// Shapes: Cin % 16 == 0 and Cout % 64 == 0 (every block the decoder sends:
// Cin 64..448, Cout 64..256).  conv16_path below says which core a 16-bit
// conv takes; the wrapper (ops/fused_block.py::conv16_path) mirrors it, and
// the card tests and chip_smoke.py hold the two equal.
//
// What bounds it on the H100: at these widths a 3x3 conv does 9 * Cin * Cout
// FMAs per pixel against 2 * (Cin + Cout) bytes, so it is bound by the 16-bit
// tensor cores, FLOPs / 989 TFLOP/s.  The block's prep pass (fused_block.cu)
// is bound by its bytes.
//
// What the design does about it:
// - GEMM view: M = pixels, N = output channels, K = taps x input channels.
//   wgmma.mma_async m64n64k16 with A from registers and B (the weights) from
//   shared memory.  A from registers is what lets a 3x3 conv run without an
//   im2col: for each tap the A operand is the staged halo tile shifted by
//   (dy, dx), a window no shared-memory descriptor describes but ldmatrix.x4
//   loads (its fragments are the m16n8k16 layout, one warp per 16 rows).
// - TMA in place of cp.async.  The input arrives as a 4-D tiled tensor map
//   over (C, W, H, N) with box (64 channels, TW + KS - 1, TH + KS - 1, 1); its
//   origin (x0 - 1, y0 - 1) may lie outside the image, and TMA fills what lies
//   outside (and channels past Cin) with zeros: SAME padding with no bounds
//   checks.  Swizzle 128B: each pixel's 64 channels are one 128-byte row, and
//   its 16-byte chunk c lands at c ^ (pixel % 8), so ldmatrix of 8
//   consecutive pixels hits 32 distinct banks at every tap shift.  The
//   weights (taps, Cout, Cin), K contiguous as the wrapper lays them out, are
//   a 3-D map with the same swizzle: wgmma's K-major B with no transpose.
//   The maps are encoded on the host (cuTensorMapEncodeTiled, reached
//   through cudaGetDriverEntryPoint: no -lcuda) and passed as
//   __grid_constant__ parameters, so a CUDA graph captures them.
// - Weights stay on chip.  Where a block's 64-channel slice of the weights
//   fits beside the ring (KS * KS * ceil(Cin / 64) <= 18 chunk-taps: Cin <=
//   128 at KS = 3, Cin <= 1152 at KS = 1), a persistent block loads it once
//   and walks its pixel tiles; the ring carries only input tiles.  Wider
//   3x3 convs (Cin >= 192) stream the weights with the input, one 64-channel
//   K chunk per stage, over a 16 x 16 pixel tile that halves the weight
//   traffic per pixel.
// - Schedule: 3 warpgroups.  Warpgroup 0 is the producer: one thread issues
//   every TMA into a ring of full / empty mbarriers (setmaxnreg gives its
//   registers to the consumers).  Warpgroups 1 and 2 are consumers, each
//   owning MT m64 tiles (4 rows of 16 pixels each) of the block's pixel tile;
//   per tap they ldmatrix their A fragments into one of three register
//   buffers and issue four k16 wgmmas, keeping two taps' groups in flight
//   while the next tap's fragments load.  A persistent grid of one block per
//   SM (a multiple of the Cout slices) walks the (pixel tile, Cout slice)
//   items; the producer runs ahead across item boundaries.  (Measured
//   slower on an H100: consumers taking 4 x 16 items in turns, ping-pong,
//   and 16 x 16 tiles with resident weights.)
// - Epilogues run on the accumulator registers and store straight to device
//   memory; on an 8 x 16 tile conv1's residual is loaded before the tile's
//   last products, so it arrives while they run.
//
// Shared memory per block (1024-byte aligned regions; TH x 16 pixel tile):
//   KS = 3, resident (Cin <= 128): tile 8 x 16, ring 3 x 23 KB halo (10 x 18
//     pixels x 128 B) + weights ceil(Cin / 64) x 72 KB: 141 / 213 KB;
//   KS = 3, streamed (Cin >= 192): tile 16 x 16, ring 2 x (72 KB weights +
//     41 KB halo of 18 x 18 pixels): 226 KB;
//   KS = 1, resident: tile 8 x 16, ring 4 x 16 KB + weights ceil(Cin / 64) x
//     8 KB: 72..208 KB.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (header only)

#include "conv3x3.cuh"

namespace tdt {

// Which core a 16-bit KS x KS conv from Cin to Cout channels takes.  The
// wrapper's mirror is ops/fused_block.py::conv16_path (same codes, same rule).
enum Conv16Path { PATH_HEAD = 0, PATH_MMA_SYNC = 1, PATH_WGMMA_RESIDENT = 2,
                  PATH_WGMMA_STREAMED = 3, PATH_IN_CONV = 4 };
constexpr int WG_CK = 64;               // input channels per K chunk
constexpr int WG_BN = 64;               // output channels per block
constexpr int WG_RESIDENT_CHUNK_TAPS = 18;  // weight chunk-taps kept on chip

inline int conv16_path(int ks, int cin, int cout) {
  if (ks == 3 && cout <= 8) return PATH_HEAD;
  if (ks == 3 && cin <= 8 && cin % 2 == 0 && cout % 8 == 0) return PATH_IN_CONV;
  if (cin % 16 != 0 || cout % WG_BN != 0) return PATH_MMA_SYNC;
  const int chunks = (cin + WG_CK - 1) / WG_CK;
  if (ks * ks * chunks <= WG_RESIDENT_CHUNK_TAPS) return PATH_WGMMA_RESIDENT;
  return ks == 3 ? PATH_WGMMA_STREAMED : PATH_MMA_SYNC;
}

constexpr int align1024(int b) { return (b + 1023) / 1024 * 1024; }

template <int KS_, bool STREAM_>
struct WgTile {
  static constexpr int KS = KS_;
  static constexpr bool STREAM = STREAM_;
  static constexpr int MT = STREAM ? 2 : 1;  // m64 tiles per consumer warpgroup
  static constexpr int TW = 16;              // a warp's 16 rows of M: one tile row
  static constexpr int TH = 8 * MT;          // 2 warpgroups x MT x 4 warps
  static constexpr int BN = WG_BN, CK = WG_CK;  // plan_conv's names
  static constexpr int IN_H = TH + KS - 1, IN_W = TW + KS - 1;
  static constexpr int IN_TX = IN_H * IN_W * WG_CK * 2;       // bytes of one input box
  static constexpr int IN_BYTES = align1024(IN_TX);
  static constexpr int W_TX = KS * KS * WG_BN * WG_CK * 2;    // one K chunk of weights
  static constexpr int STAGES = STREAM ? 2 : (KS == 1 ? 4 : 3);
  static constexpr int STAGE_BYTES = IN_BYTES + (STREAM ? W_TX : 0);
  static constexpr int NT = 384;  // producer warpgroup + 2 consumer warpgroups
  // dynamic shared memory for nchunks K chunks: the ring, resident
  // weights, then the barriers (full, empty per stage; the weights')
  __host__ __device__ static constexpr int ring_bytes() { return STAGES * STAGE_BYTES; }
  __host__ __device__ static constexpr int smem(int nchunks) {
    return ring_bytes() + (STREAM ? 0 : nchunks * W_TX) + 8 * (2 * STAGES + 1);
  }
  static constexpr int MAX_CHUNKS = STREAM ? 1 : WG_RESIDENT_CHUNK_TAPS / (KS * KS);
  static constexpr int MAX_SMEM = smem(MAX_CHUNKS);
  static_assert(W_TX % 1024 == 0 && IN_BYTES % 1024 == 0, "1024-byte aligned regions");
  static_assert(MAX_SMEM <= 232448, "fits in a block's shared memory");
};

// ---------------------------------------------------------------------------
// mbarrier, TMA, ldmatrix and wgmma primitives
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// returns once the phase of parity `parity` has completed; a wait that
// outlasts 2^36 clocks (about 40 s) traps, so a broken ring fails its launch
// rather than hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long t0 = 0;
  for (uint32_t spins = 1; !done; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && (spins & 0xFFFF) == 0) {
      if (t0 == 0) t0 = clock64();
      else if (clock64() - t0 > (1LL << 36)) __trap();
    }
  }
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// K-major operand in 128B-swizzled rows of 128 bytes, 8-row groups 1024
// bytes apart: start address, leading offset (unused when swizzled),
// stride offset 1024, layout SWIZZLE_128B
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of the accumulators across the
// wgmma fences and waits
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define TDT_WG_D32                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define TDT_WG_D32_OUT(d)                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),          \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (64 x 64, f32) = a (64 x 16, registers) * b (16 x 64, K-major in shared
// memory) + (scale_d ? d : 0); fragments: d[4j + e] at row 16 warp + g +
// 8 (e / 2), column 8 j + 2 t + e % 2; a as mma.m16n8k16's A per warp
template <class E>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t b, int scale_d) {
  if constexpr (std::is_same<E, __nv_bfloat16>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TDT_WG_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : TDT_WG_D32_OUT(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " TDT_WG_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : TDT_WG_D32_OUT(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <class T, class E, bool OUT_F32, int EPI>
__global__ void __launch_bounds__(T::NT, 1)
conv_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_x,
                  const __grid_constant__ CUtensorMap tmap_w, void* __restrict__ yv, int H, int W,
                  int Cout, const ConvGrid grid, const EpiArgs epi) {
  constexpr int KS = T::KS, MT = T::MT, STAGES = T::STAGES;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = smem_addr(wg_smem);
  const int n_nb = grid.n_nb, nchunks = grid.nchunks;
  const int tiles_x = grid.tiles_x, tiles_y = grid.tiles_y;
  const int co0 = (blockIdx.x % n_nb) * WG_BN;
  const int my_items = (grid.n_items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  // regions: ring stages (STREAM: [weights | input]), resident weights, barriers
  const uint32_t w_res = base + T::ring_bytes();
  const uint32_t bars = w_res + (T::STREAM ? 0 : nchunks * T::W_TX);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const uint32_t wbar = bars + 8 * 2 * STAGES;
  auto stage_in = [&](int s) {
    return base + s * T::STAGE_BYTES + (T::STREAM ? T::W_TX : 0);
  };
  auto item_tile = [&](int k, int& n, int& ty, int& tx) {
    const int tile = ((int)blockIdx.x + k * (int)gridDim.x) / n_nb;
    tx = tile % tiles_x;
    ty = (tile / tiles_x) % tiles_y;
    n = tile / (tiles_x * tiles_y);
  };

  if (threadIdx.x == 0) {
    if (base & 1023) __trap();  // the swizzled regions need 1024-byte alignment
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != 0) return;
    if (!T::STREAM) {  // the block's weights, once
      mbar_expect_tx(wbar, nchunks * T::W_TX);
      for (int c = 0; c < nchunks; ++c)
        tma_load_3d(w_res + c * T::W_TX, &tmap_w, c * WG_CK, co0, 0, wbar);
    }
    const int nsteps = my_items * nchunks;
    for (int st = 0; st < nsteps; ++st) {
      const int s = st % STAGES;
      mbar_wait(empty(s), ((st / STAGES) & 1) ^ 1);
      int n, ty, tx;
      item_tile(st / nchunks, n, ty, tx);
      const int c = st % nchunks;
      mbar_expect_tx(full(s), T::IN_TX + (T::STREAM ? T::W_TX : 0));
      tma_load_4d(stage_in(s), &tmap_x, c * WG_CK, tx * T::TW - KS / 2, ty * T::TH - KS / 2, n,
                  full(s));
      if (T::STREAM) tma_load_3d(base + s * T::STAGE_BYTES, &tmap_w, c * WG_CK, co0, 0, full(s));
    }
    return;
  }

  // consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;                      // consumer warpgroup
  const int warp = (threadIdx.x / 32) & 3;    // warp within it
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix.x4: lane L supplies row L % 16 (a pixel of the warp's tile
  // row) at 16-byte chunk L / 16 of the k16 step
  const int ld_row = lane & 15, ld_chunk = lane >> 4;
  float acc[MT][32];
  uint32_t abuf[3][4][4];  // three taps' A fragments: [buffer][k16 step][register]
  // conv1's residual, loaded before the products, as the accumulators; on
  // one m64 tile only: with two, ptxas spilled at the 168 registers a thread
  // of a 384-thread block gets
  constexpr bool PREFETCH = EPI == EPI_RESIDUAL && MT == 1;
  float res[32];
  // output element (row 16 warp + g + 8 h, column 8 j + 2 t) of m64 tile mt
  // of this item: its row, column and offset; false outside the image
  auto out_at = [&](int n, int ty, int tx, int mt, int j, int h, int& co, size_t& off) {
    const int gy = ty * T::TH + cw * 4 * MT + mt * 4 + warp, gx = tx * T::TW + g + 8 * h;
    co = co0 + 8 * j + 2 * t;
    off = (((size_t)n * H + gy) * W + gx) * Cout + co;
    return gy < H && gx < W;
  };
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mt][i] = 0.0f;
    fence_acc(acc[mt]);
  }

  if (!T::STREAM) mbar_wait(wbar, 0);
  int st = 0;
  for (int k = 0; k < my_items; ++k) {
    int n, ty, tx;
    item_tile(k, n, ty, tx);
    for (int c = 0; c < nchunks; ++c, ++st) {
      const int s = st % STAGES;
      mbar_wait(full(s), (st / STAGES) & 1);
      const uint32_t in_base = stage_in(s);
      const uint32_t w_base = T::STREAM ? base + s * T::STAGE_BYTES : w_res + c * T::W_TX;
      if (PREFETCH && c == nchunks - 1) {
        // the epilogue's residual, loaded now: it arrives while the products run
#pragma unroll
        for (int j = 0; j < WG_BN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            int co;
            size_t off;
            float2 r = make_float2(0.0f, 0.0f);
            if (out_at(n, ty, tx, 0, j, h, co, off)) {
              if (epi.residual) {
                r = __ldg(reinterpret_cast<const float2*>(epi.residual + off));
              } else {
                const E* rh = reinterpret_cast<const E*>(epi.residual_h) + off;
                r = make_float2(load_f32(rh), load_f32(rh + 1));
              }
            }
            res[4 * j + 2 * h] = r.x;
            res[4 * j + 2 * h + 1] = r.y;
          }
      }
#pragma unroll
      for (int tap = 0; tap < KS * KS; ++tap) {
        const int dy = tap / KS, dx = tap % KS;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int grp = tap * MT + mt;
          uint32_t(&a)[4][4] = abuf[grp % 3];
          if (grp >= 3) wg_wait<2>();  // the group that read this buffer is done
          const int row = cw * 4 * MT + mt * 4 + warp;  // output row in the tile
          const int p = (row + dy) * T::IN_W + ld_row + dx;  // halo pixel
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int chunk = 2 * kk + ld_chunk;
            ldmatrix_x4(a[kk], in_base + p * 128 + ((chunk ^ (p & 7)) << 4));
          }
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_m64n64k16<E>(acc[mt], a[kk],
                               desc_sw128(w_base + tap * (WG_BN * 128) + kk * 32),
                               (tap == 0 && kk == 0) ? (c > 0) : 1);
          wg_commit();
        }
      }
      wg_wait<0>();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));  // the stage is free for the producer

      if (c == nchunks - 1) {  // the item's last chunk: epilogue
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int j = 0; j < WG_BN / 8; ++j) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              int co;
              size_t off;
              if (!out_at(n, ty, tx, mt, j, h, co, off)) continue;
              float v0 = acc[mt][4 * j + 2 * h], v1 = acc[mt][4 * j + 2 * h + 1];
              if (PREFETCH) {
                v0 = residual_mix(res[4 * j + 2 * h], v0, epi);
                v1 = residual_mix(res[4 * j + 2 * h + 1], v1, epi);
              } else {
                v0 = epilogue<EPI, E>(v0, epi, n, Cout, co, off);
                v1 = epilogue<EPI, E>(v1, epi, n, Cout, co + 1, off + 1);
              }
              if (OUT_F32)
                *reinterpret_cast<float2*>(reinterpret_cast<float*>(yv) + off) =
                    make_float2(v0, v1);
              else
                *reinterpret_cast<uint32_t*>(reinterpret_cast<E*>(yv) + off) = pack2<E>(v0, v1);
            }
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point query, or nullptr;
// queried once per device, as the rest of the one-time launch state is
inline EncodeTiledFn encode_tiled() {
  static PerDevice<EncodeTiledFn> state;
  const EncodeTiledFn* fn = state.get([] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess) ? (EncodeTiledFn)p : nullptr;
  });
  return fn ? *fn : nullptr;
}

// a tiled, 128B-swizzled map of a K-contiguous 16-bit tensor: dims and box
// innermost first; zeros outside
template <class E, int R>
cudaError_t encode_map(CUtensorMap* map, const void* ptr, const cuuint64_t (&dims)[R],
                       const cuuint32_t (&box)[R]) {
  const EncodeTiledFn encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  cuuint64_t strides[R - 1];
  cuuint64_t s = 2;
  for (int i = 0; i < R - 1; ++i) strides[i] = s *= dims[i];
  cuuint32_t ones[R];
  for (int i = 0; i < R; ++i) ones[i] = 1;
  const CUtensorMapDataType type = std::is_same<E, __nv_bfloat16>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const CUresult r = encode(map, type, R, const_cast<void*>(ptr), dims, strides, box, ones,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <class T, class E, bool OUT_F32, int EPI>
cudaError_t launch_conv_wgmma(const E* x, const E* w, void* y, int N, int H, int W, int Cin,
                              int Cout, const EpiArgs& epi, cudaStream_t stream) {
  auto kernel = conv_wgmma_kernel<T, E, OUT_F32, EPI>;
  static PerDevice<LaunchInfo> state;  // once per kernel and device
  const LaunchInfo* info = state.get([&] { return query_launch(kernel, T::NT, T::MAX_SMEM); });
  if (!info) return cudaErrorInvalidDevice;
  // TMA reads from 16-byte aligned rows (the wrapper checks this first)
  if ((reinterpret_cast<uintptr_t>(x) & 15) || (reinterpret_cast<uintptr_t>(w) & 15) ||
      Cin % 16 || Cout % WG_BN)
    return cudaErrorMisalignedAddress;
  ConvGrid grid;
  unsigned blocks;
  cudaError_t err = plan_conv<T>(*info, N, H, W, Cin, Cout, grid, blocks);
  if (err != cudaSuccess || blocks == 0) return err;
  if (grid.nchunks > T::MAX_CHUNKS && !T::STREAM) return cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  err = encode_map<E, 4>(&tx, x, {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N},
                         {WG_CK, T::IN_W, T::IN_H, 1});
  if (err == cudaSuccess)
    err = encode_map<E, 3>(&tw, w, {(cuuint64_t)Cin, (cuuint64_t)Cout, (cuuint64_t)(T::KS * T::KS)},
                           {WG_CK, WG_BN, T::KS * T::KS});
  if (err != cudaSuccess) return err;
  kernel<<<blocks, T::NT, T::smem(grid.nchunks), stream>>>(tx, tw, y, H, W, Cout, grid, epi);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The 16-bit in conv: 3x3, Cin <= 8 and even, Cout % 8 == 0
// ---------------------------------------------------------------------------
//
// The decoder's 6 -> 64 input conv (6 -> 32 in the 32-channel guide) on a
// bf16 / fp16 x, with conv_h_kernel's rounding: 16-bit operands, float32
// sums, one pass, the output rounded once.
// What bounds it on the H100: its output bytes.  A pixel reads 2 * Cin bytes
// and writes 2 * Cout (33.6 of the 36.7 MB of one 512 x 512 tile at 6 ->
// 64); its 9 * Cin * Cout MACs a pixel, even padded to K = 80, take about a
// quarter of the bytes' time on the tensor cores.
// What the design does:
// - One GEMM: M = pixels, N = a 64-channel slice of Cout, K = 9 taps x 8
//   channels (Cin padded to 8 with zeros), padded to 80: five k16 steps of
//   mma.sync m16n8k16, taps 2s and 2s + 1 in step s.  A block of 4 warps
//   owns a tile of 8 x 16 pixels, a warp two rows of 16 (two m16 tiles) by
//   all 8 n8 tiles of the slice.
// - The weights stay in shared memory for the persistent block's life: its
//   64 x 80 slice in rows of 88 halves, so that ldmatrix.x4 reads the B
//   fragments of two n8 tiles with no bank conflict.
// - The input: each of the tile's 10 halo rows is one contiguous run of
//   18 * Cin halves of the NHWC tensor, copied as the 16-byte words that
//   cover it (cp.async into a ring of IC_STAGES tiles; words past the tensor
//   are zero-filled, so x must be 16-byte aligned).  A fragments are read
//   straight from those runs, one 32-bit word per two channels (6-channel
//   pixels put lane (g, t) on word 3 g + t: no bank conflict), with zero for
//   the channels past Cin, pixels outside the image and the tenth tap:
//   SAME padding by selection, with no fill pass.
// - The output: the epilogue (none, gain + silu, residual mix + clip) runs
//   on the float32 sums, which are rounded once to E and written into an
//   8 x 16 pixel x 64 channel tile in shared memory, 128B-swizzled (lane
//   (g, t) writes chunk j ^ g of pixel row g: 32 distinct banks); one TMA
//   store (cp.async.bulk.tensor, clipped to the map and to Cout) writes the
//   tile as whole 128-byte lines.  Two tiles alternate, so the store of one
//   overlaps the copies and products of the next.
// - Four blocks share an SM (53.6 KB of shared memory each).

constexpr int IC_NT = 128;                    // 4 warps
constexpr int IC_STAGES = 3;                  // input ring
constexpr int IC_ROW = 320;                   // bytes of a staged halo row: 18 * 16 + 12 <= 320
constexpr int IC_KP = 88;                     // halves of a weight row: K = 80, padded
constexpr int IC_OUT = 8 * 16 * 128;          // bytes of an output tile
constexpr int IC_W_BYTES = WG_BN * IC_KP * 2;
constexpr int IC_IN_BYTES = 10 * IC_ROW;      // one ring stage: the tile's 10 halo rows
constexpr int IC_SMEM = 2 * IC_OUT + IC_W_BYTES + IC_STAGES * IC_IN_BYTES;
struct InConvTile {  // plan_conv's names
  static constexpr int TW = 16, TH = 8, BN = WG_BN, CK = 8;
};

__device__ __forceinline__ uint32_t lds32_shared(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {  // all but the newest N stores have read smem
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// orders this thread's shared-memory writes before the async proxy's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <class E, int EPI>
__global__ void __launch_bounds__(IC_NT, 4)
in_conv16_kernel(const E* __restrict__ x, const E* __restrict__ w,
                 const __grid_constant__ CUtensorMap tmap_y, int N, int H, int W, int Cin,
                 int Cout, const ConvGrid grid, const EpiArgs epi) {
  extern __shared__ __align__(1024) unsigned char ic_smem[];
  E* s_w = reinterpret_cast<E*>(ic_smem + 2 * IC_OUT);
  unsigned char* s_in = ic_smem + 2 * IC_OUT + IC_W_BYTES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_nb = grid.n_nb, tiles_x = grid.tiles_x, tiles_y = grid.tiles_y;
  const int co0 = (blockIdx.x % n_nb) * WG_BN;
  const int my_items = (grid.n_items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int pix_bytes = 2 * Cin;
  const long long x_bytes = (long long)N * H * W * pix_bytes;

  // the block's weight slice: row co - co0, column tap * 8 + c; zeros past
  // Cin, Cout and the ninth tap
  for (int i = tid; i < WG_BN * IC_KP; i += IC_NT) {
    const int col = i % IC_KP, co = co0 + i / IC_KP, tap = col / 8, c = col % 8;
    s_w[i] = tap < 9 && c < Cin && co < Cout ? w[((size_t)tap * Cout + co) * Cin + c]
                                             : from_f32<E>(0.0f);
  }

  auto item_tile = [&](int k, int& n, int& ty, int& tx) {
    const int tile = ((int)blockIdx.x + k * (int)gridDim.x) / n_nb;
    tx = tile % tiles_x;
    ty = (tile / tiles_x) % tiles_y;
    n = tile / (tiles_x * tiles_y);
  };
  // byte offset in x of halo row r's first pixel (x0 - 1) in tile (n, ty, tx)
  auto run_start = [&](int n, int ty, int tx, int r) {
    return (((long long)n * H + ty * 8 - 1 + r) * W + tx * 16 - 1) * pix_bytes;
  };
  // stage tile k into ring slot k % IC_STAGES: the 16-byte words covering
  // each halo row inside the image
  auto load_tile = [&](int k) {
    int n, ty, tx;
    item_tile(k, n, ty, tx);
    unsigned char* slot = s_in + (k % IC_STAGES) * IC_IN_BYTES;
    const int run = 18 * pix_bytes;
#pragma unroll 1
    for (int i = tid; i < 10 * (IC_ROW / 16); i += IC_NT) {
      const int r = i / (IC_ROW / 16), q = i % (IC_ROW / 16);
      const int gy = ty * 8 - 1 + r;
      const long long start = run_start(n, ty, tx, r);
      const long long a = (start & ~15LL) + 16 * q;
      if (gy < 0 || gy >= H || a >= start + run) continue;
      const bool in = a >= 0 && a < x_bytes;
      const long long left = x_bytes - a;
      const void* src = in ? static_cast<const void*>(reinterpret_cast<const char*>(x) + a)
                           : static_cast<const void*>(x);
      cp_async16_raw(slot + r * IC_ROW + 16 * q, src, in ? (left < 16 ? (int)left : 16) : 0);
    }
  };

  const uint32_t w_base = smem_addr(s_w);
  // ldmatrix.x4 row of lane: matrices (n8 tile 2jj, k lo / hi), (2jj + 1, lo / hi)
  const uint32_t b_lane =
      w_base + (((lane >> 4) * 8 + (lane & 7)) * IC_KP + ((lane >> 3) & 1) * 8) * 2;
  const int n8 = (Cout - co0 + 7) / 8 < 8 ? (Cout - co0 + 7) / 8 : 8;  // live n8 tiles

#pragma unroll
  for (int k = 0; k < IC_STAGES - 1; ++k) {
    if (k < my_items) load_tile(k);
    cp_async_commit();
  }
#pragma unroll 1
  for (int k = 0; k < my_items; ++k) {
    if (k + IC_STAGES - 1 < my_items) load_tile(k + IC_STAGES - 1);
    cp_async_commit();
    cp_async_wait<IC_STAGES - 1>();
    __syncthreads();  // tile k is in (and, at k = 0, the weights)
    int n, ty, tx;
    item_tile(k, n, ty, tx);
    const uint32_t slot = smem_addr(s_in + (k % IC_STAGES) * IC_IN_BYTES);
    // the warp's halo rows 2 warp .. 2 warp + 3: where this lane's words of
    // each run start in its slot row, and whether the row lies in the image
    uint32_t rowp[4];
    bool row_ok[4];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int r = 2 * warp + rr, gy = ty * 8 - 1 + r;
      row_ok[rr] = gy >= 0 && gy < H;
      rowp[rr] = slot + r * IC_ROW + (int)(run_start(n, ty, tx, r) & 15) + 4 * t + g * pix_bytes;
    }
    // pixel g + 8 h + dx - 1 of the tile row inside the image, for h, dx
    bool col_ok[2][3];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int gx = tx * 16 + g + 8 * h + dx - 1;
        col_ok[h][dx] = 2 * t < Cin && gx >= 0 && gx < W;
      }
    // the 32-bit word of channels 2t, 2t + 1 of tile pixel (row i, column
    // g + 8 h) at tap `tap` (zero outside the image and past the ninth tap)
    auto a_word = [&](int i, int tap, int h) -> uint32_t {
      if (tap >= 9) return 0u;
      const int dy = tap / 3, dx = tap % 3;
      if (!row_ok[i + dy] || !col_ok[h][dx]) return 0u;
      return lds32_shared(rowp[i + dy] + (8 * h + dx) * pix_bytes);
    };

    float acc[2][8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        a[i][0] = a_word(i, 2 * s, 0), a[i][1] = a_word(i, 2 * s, 1);
        a[i][2] = a_word(i, 2 * s + 1, 0), a[i][3] = a_word(i, 2 * s + 1, 1);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {  // n8 tiles 2 jj and 2 jj + 1
        if (2 * jj >= n8) break;
        uint32_t r4[4];
        ldmatrix_x4(r4, b_lane + (16 * jj * IC_KP + 16 * s) * 2);
        const uint32_t b0[2] = {r4[0], r4[1]}, b1[2] = {r4[2], r4[3]};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_k16<E>(acc[i][2 * jj], a[i], b0);
          if (2 * jj + 1 < n8) mma_k16<E>(acc[i][2 * jj + 1], a[i], b1);
        }
      }
    }

    // epilogue: into output tile k % 2, once the store that last read it has
    unsigned char* out = ic_smem + (k & 1) * IC_OUT;
    if (tid == 0) bulk_wait_read<1>();
    __syncthreads();  // that store has read the tile; every warp is done with slot k
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int gy = ty * 8 + 2 * warp + i;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = (2 * warp + i) * 16 + g + 8 * h, gx = tx * 16 + g + 8 * h;  // m % 8 == g
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
          const int co = co0 + 8 * j + 2 * t;
          if (EPI != EPI_NONE && gy < H && gx < W && co < Cout) {  // Cout is even
            const size_t off = (((size_t)n * H + gy) * W + gx) * Cout + co;
            v0 = epilogue<EPI, E>(v0, epi, n, Cout, co, off);
            v1 = epilogue<EPI, E>(v1, epi, n, Cout, co + 1, off + 1);
          }
          *reinterpret_cast<uint32_t*>(out + m * 128 + ((j ^ g) << 4) + 4 * t) = pack2<E>(v0, v1);
        }
      }
    }
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      tma_store_4d(&tmap_y, smem_addr(out), co0, tx * 16, ty * 8, n);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait_all();
}

template <class E, int EPI>
cudaError_t launch_in_conv16(const E* x, const E* w, E* y, int N, int H, int W, int Cin, int Cout,
                             const EpiArgs& epi, cudaStream_t stream) {
  auto kernel = in_conv16_kernel<E, EPI>;
  static PerDevice<LaunchInfo> state;  // once per kernel and device
  const LaunchInfo* info = state.get([&] { return query_launch(kernel, IC_NT, IC_SMEM); });
  if (!info) return cudaErrorInvalidDevice;
  // 16-byte words of x (the wrapper checks this first); y from the wrapper
  if ((reinterpret_cast<uintptr_t>(x) & 15) || (reinterpret_cast<uintptr_t>(y) & 15))
    return cudaErrorMisalignedAddress;
  if (Cin > 8 || Cin % 2 || Cout % 8) return cudaErrorInvalidValue;
  ConvGrid grid;
  unsigned blocks;
  cudaError_t err = plan_conv<InConvTile>(*info, N, H, W, Cin, Cout, grid, blocks);
  if (err != cudaSuccess || blocks == 0) return err;
  CUtensorMap ty;
  err = encode_map<E, 4>(&ty, y, {(cuuint64_t)Cout, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N},
                         {WG_BN, 16, 8, 1});
  if (err != cudaSuccess) return err;
  kernel<<<blocks, IC_NT, IC_SMEM, stream>>>(x, w, ty, N, H, W, Cin, Cout, grid, epi);
  return cudaGetLastError();
}

// KS x KS conv with 16-bit operands: x (N, H, W, Cin) and the weight (KS *
// KS, Cout, Cin) in E, y in E or float32 (OUT_F32), each by conv16_path:
// the direct head kernel for 3x3 convs to at most 8 channels, the in-conv
// kernel for 3x3 convs from at most 8 channels (even) to a multiple of 8,
// the wgmma core for Cin % 16 == 0 and Cout % 64 == 0, else the mma.sync
// core.
template <int KS, class E, bool OUT_F32, int EPI>
cudaError_t launch_conv_h(const E* x, const E* w, void* y, int N, int H, int W, int Cin, int Cout,
                          const EpiArgs& epi, cudaStream_t stream) {
  switch (conv16_path(KS, Cin, Cout)) {
    case PATH_HEAD:
      if constexpr (KS == 3 && !OUT_F32)
        return launch_conv3x3_head<E, IN_NONE, EPI>(x, w, static_cast<E*>(y), N, H, W, Cin, Cout,
                                                    epi, stream);
      return cudaErrorInvalidValue;
    case PATH_IN_CONV:
      if constexpr (KS == 3 && !OUT_F32)
        return launch_in_conv16<E, EPI>(x, w, static_cast<E*>(y), N, H, W, Cin, Cout, epi,
                                        stream);
      return cudaErrorInvalidValue;
    case PATH_WGMMA_RESIDENT:
      return launch_conv_wgmma<WgTile<KS, false>, E, OUT_F32, EPI>(x, w, y, N, H, W, Cin, Cout,
                                                                  epi, stream);
    case PATH_WGMMA_STREAMED:
      if constexpr (KS == 3)
        return launch_conv_wgmma<WgTile<KS, true>, E, OUT_F32, EPI>(x, w, y, N, H, W, Cin, Cout,
                                                                   epi, stream);
      return cudaErrorInvalidValue;
    default:
      return launch_conv_h_tc<WideTileH<KS>, E, OUT_F32, EPI>(x, w, y, N, H, W, Cin, Cout, epi,
                                                             stream);
  }
}

}  // namespace tdt
