// Pixel-norm attention core of the MP U-Net at inference, NHWC float32.
//
// Replaces terrain_diffusion_tpu/ops/pallas_attention.py::
// fused_pixelnorm_attention (Pallas body _attn_kernel).  For each (batch,
// head), with ch channels per head and HW pixels:
//   q, k, v = the head's channels of qkv, laid out (head, channel, qkv) with
//             the qkv index fastest: channel c of head h for slot s sits at
//             qkv[n, p, (h * ch + c) * 3 + s];
//   x <- x / (eps + ||x|| / sqrt(ch)) per pixel, for each of q, k, v;
//   out[n, p, h * ch + c] = sum_j softmax_j(q_p . k_j / sqrt(ch)) v_j[c].
//
// What bounds it on the H100: the base model's midblock attends over 8x8
// maps (HW = 64, 12 heads of 64 channels): 2 * 2 * 64^3 FLOP per (batch,
// head) against 48 KB of qkv read and 16 KB written, so at every batch it is
// bound by its bytes (50 MB at batch 64: 15 us at 3.35 TB/s; the three TF32
// passes of its 0.8 GFLOP take 4.9 us at 495 TFLOP/s).  Eligible shapes
// reach HW = 2048, where the products bound it (3 heads of 64: 3.2 GFLOP).
// The TPU kernel kept a head's whole (HW, HW) logit matrix in VMEM, which
// does not fit a block's 227 KB of shared memory: both paths below walk the
// keys in chunks with an online softmax, so the logits never leave the SM,
// and both read the interleaved NHWC qkv in place (no transpose pass) and
// write the output in its final (N, H, W, C) layout.  The C entry point
// picks the path by the channels per head.
//
// Tensor-core path, ch = 16, 32 or 64 (every shipped and tested width but
// the wide-head test shape): pixelnorm_attention_tc<CH>.
// - One block of 8 warps per (batch x head, 64-query tile).  Keys go in
//   chunks of 64, starting at the block's own tile, so the first chunk's
//   rows are the queries: at HW <= 64 the head is read once, in one chunk,
//   and the own chunk stays resident as the queries' source.  Each of 4
//   query groups of 16 rows (one m16 tile) has two warps, one for each half
//   of every chunk's keys, each with its own online softmax; the two are
//   merged once at the end.  Two warps per row group halve a chunk's chain
//   of dependent work, which bounds the time where the grid is small (one
//   block per SM at HW = 2048).
// - Staging: a pixel's slice of one head is 3 * ch contiguous floats (768 B
//   at ch = 64); neighbouring threads copy neighbouring 16-byte words with
//   cp.async into a raw interleaved tile whose rows are padded to 3 * ch + 4
//   floats.  The fragment loads read q, k and v straight from it at a
//   stride of 3 floats: with that padding every fragment load hits 32
//   distinct banks, so no deinterleave pass is needed.  For HW > 64 a ring
//   of two more tiles loads the next chunk while this one computes.  Rows
//   past HW are zero-filled, their scores masked to -inf and their outputs
//   never stored.
// - Pixel norm: a pass over the tile, 8 lanes per pixel reading whole
//   (q, k, v) triples as float4 words and reducing with shuffles, leaves one
//   scale 1 / (eps + ||x|| / sqrt(ch)) per pixel and slot.  A query's scale,
//   times log2(e) / sqrt(ch) so the softmax runs on exp2f, multiplies its
//   row of scores, a key's scale its column of scores, and a value's scale
//   its column of probabilities: the same products as norming the rows in
//   place, without writing them.
// - S = Q K^T and O += P V on the tensor cores, mma.sync.m16n8k8 TF32 in
//   3xTF32 (conv3x3.cuh's primitives and precision notes): each operand is
//   split into big + small and each k8 step's three passes go into a fresh
//   fragment that is added into the float32 accumulator.  P never leaves the
//   registers: the P V product sums over keys in any order, so its k index t
//   stands for key 2t and t + 4 for key 2t + 1 of each group of 8, which is
//   where the score accumulator already holds them; V's fragments are read
//   in the same order.
// - Online softmax on the accumulator fragments: a row's running max is
//   reduced over its 4 lanes with shuffles, its sum stays per lane until the
//   end; O is rescaled per chunk, merged across the two key halves, divided
//   by the sum and stored from the fragments as float2 words.
// - 256 threads and at most 151 KB of shared memory (ch = 64, three
//   tiles).  ch = 16 and 32 run two blocks per SM (<= 128 registers);
//   ch = 64 needs more registers than that for its 32 output accumulators
//   a lane and runs one block of 8 warps per SM.
//
// CUDA-core path, every other ch (wide heads up to 1812
// channels): pixelnorm_attention_kernel<T, E>.  One block of 256 threads owns
// (batch, head, T queries); it stages its queries pixel-normed in shared
// memory, then per chunk of T keys stages k and v (one pass each over the
// interleaved qkv), scores them with float32 FMAs, folds them into a running
// (max, sum) softmax and accumulates the output in shared memory.  T is 64
// where the shared memory allows it (ch <= 209) and halves down to 8 for
// wider heads.
//
// Precision: the JAX f32 path is exact float32 and the parity bar is 1e-4;
// the tensor-core path's 3xTF32 drops only small * small (~2^-22 relative),
// and tests/test_torch_split_tf32.py models its arithmetic on the CPU.
//
// bf16 / fp16 (the Pallas kernel widens qkv to float32 and writes
// qkv.dtype): pixelnorm_attention_tc<CH, E> loads each chunk as 16-byte
// words of 8 values, widens them to float32 (exact) as it fills the same
// padded tiles, runs the pixel norm, the softmax and both 3xTF32 products as
// for float32, and rounds the output once.  The loads are synchronous
// (cp.async copies bytes and cannot widen).  At the midblock's shapes it
// stays bound by its bytes, now 2 a value (25 MB at batch 64: 7.5 us at
// 3.35 TB/s; the products' three TF32 passes, 4.9 us).  The CUDA-core
// kernel takes a 16-bit qkv the same way: each value is widened to float32
// as it is staged, the norms, softmax and products stay float32, and the
// output is rounded once to the type of qkv (as _attn_kernel's
// out.astype(out_ref.dtype) does), so a 16-bit qkv runs at every width.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "conv3x3.cuh"

namespace tdt {

constexpr int ATTN_THREADS = 256;
constexpr int ATTN_WARPS = ATTN_THREADS / 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Floats of shared memory for a query / key tile of T at ch channels.
__host__ __device__ inline size_t attn_smem_floats(int T, int ch) {
  const size_t ld = (size_t)ch + 1;  // padded rows: no bank conflicts
  return 4 * (size_t)T * ld + (size_t)T * (T + 1) + 3 * (size_t)T;
}

// Stage rows [p0, p0 + rows) of slot s of this head into dst (T x ld),
// widened to float32 (exact), zero-filling rows past the tile, then
// pixel-norm each row.
template <int T, class E>
__device__ void stage_normed(const E* __restrict__ head_base, size_t pix_stride,
                             int p0, int rows, int ch, int slot, float eps,
                             float norm_scale, float* dst) {
  const int ld = ch + 1;
  for (int i = threadIdx.x; i < T * ch; i += ATTN_THREADS) {
    const int p = i / ch, c = i - p * ch;
    dst[p * ld + c] =
        p < rows ? load_f32(head_base + (size_t)(p0 + p) * pix_stride + c * 3 + slot) : 0.f;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int p = warp; p < T; p += ATTN_WARPS) {
    float ss = 0.f;
    for (int c = lane; c < ch; c += 32) ss += dst[p * ld + c] * dst[p * ld + c];
    const float denom = eps + sqrtf(warp_sum(ss)) * norm_scale;
    __syncwarp();
    for (int c = lane; c < ch; c += 32) dst[p * ld + c] /= denom;
  }
}

template <int T, class E>
__global__ void __launch_bounds__(ATTN_THREADS)
pixelnorm_attention_kernel(const E* __restrict__ qkv, E* __restrict__ out,
                           int hw, int heads, int ch, float eps) {
  extern __shared__ float smem[];
  const int ld = ch + 1;
  float* sQ = smem;             // T x ld, pixel-normed queries
  float* sK = sQ + T * ld;      // T x ld, pixel-normed key chunk
  float* sV = sK + T * ld;      // T x ld, pixel-normed value chunk
  float* sO = sV + T * ld;      // T x ld, output accumulator
  float* sS = sO + T * ld;      // T x (T + 1), scores, then probabilities
  float* sM = sS + T * (T + 1); // running max per query
  float* sL = sM + T;           // running sum per query
  float* sA = sL + T;           // rescale of the accumulator for this chunk

  const int head = blockIdx.x % heads, n = blockIdx.x / heads;
  const int q0 = blockIdx.y * T;
  const int nq = min(T, hw - q0);
  const int C = heads * ch;
  const size_t pix_stride = 3 * (size_t)C;
  const E* head_base = qkv + (size_t)n * hw * pix_stride + (size_t)head * ch * 3;
  const float norm_scale = rsqrtf((float)ch);
  const float logit_scale = 1.0f / sqrtf((float)ch);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  stage_normed<T>(head_base, pix_stride, q0, nq, ch, 0, eps, norm_scale, sQ);
  for (int i = tid; i < T * ch; i += ATTN_THREADS) sO[(i / ch) * ld + i % ch] = 0.f;
  for (int i = tid; i < T; i += ATTN_THREADS) {
    sM[i] = -INFINITY;
    sL[i] = 0.f;
  }

  for (int k0 = 0; k0 < hw; k0 += T) {
    const int nk = min(T, hw - k0);
    __syncthreads();  // the previous chunk is consumed
    stage_normed<T>(head_base, pix_stride, k0, nk, ch, 1, eps, norm_scale, sK);
    stage_normed<T>(head_base, pix_stride, k0, nk, ch, 2, eps, norm_scale, sV);
    __syncthreads();
    for (int i = tid; i < T * T; i += ATTN_THREADS) {
      const int qi = i / T, kj = i - qi * T;
      float s = 0.f;
      for (int c = 0; c < ch; ++c) s += sQ[qi * ld + c] * sK[kj * ld + c];
      sS[qi * (T + 1) + kj] = kj < nk ? s * logit_scale : -INFINITY;
    }
    __syncthreads();
    for (int qi = warp; qi < T; qi += ATTN_WARPS) {  // online softmax, a warp per row
      float mx = -INFINITY;
      for (int kj = lane; kj < T; kj += 32) mx = fmaxf(mx, sS[qi * (T + 1) + kj]);
      const float m_old = sM[qi];
      const float m_new = fmaxf(m_old, warp_max(mx));  // finite: nk >= 1
      float sum = 0.f;
      for (int kj = lane; kj < T; kj += 32) {
        const float p = expf(sS[qi * (T + 1) + kj] - m_new);
        sS[qi * (T + 1) + kj] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_old - m_new);  // 0 on the first chunk
        sA[qi] = a;
        sL[qi] = sL[qi] * a + sum;
        sM[qi] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < T * ch; i += ATTN_THREADS) {
      const int qi = i / ch, c = i - qi * ch;
      float acc = sO[qi * ld + c] * sA[qi];
      for (int kj = 0; kj < nk; ++kj) acc += sS[qi * (T + 1) + kj] * sV[kj * ld + c];
      sO[qi * ld + c] = acc;
    }
  }
  __syncthreads();
  E* out_base = out + ((size_t)n * hw + q0) * C + (size_t)head * ch;
  for (int i = tid; i < nq * ch; i += ATTN_THREADS) {
    const int qi = i / ch, c = i - qi * ch;
    out_base[(size_t)qi * C + c] = from_f32<E>(sO[qi * ld + c] / sL[qi]);  // rounded once
  }
}

template <int T, class E>
cudaError_t launch_attention(const E* qkv, E* out, int n, int hw, int heads,
                             int ch, float eps, cudaStream_t stream) {
  const size_t smem = attn_smem_floats(T, ch) * sizeof(float);
  static PerDevice<cudaError_t> state;  // once per instantiation and device
  const cudaError_t* attr = state.get([] {
    return cudaFuncSetAttribute(pixelnorm_attention_kernel<T, E>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  });
  if (!attr) return cudaErrorInvalidDevice;
  if (*attr != cudaSuccess) return *attr;
  dim3 grid(n * heads, (hw + T - 1) / T);
  pixelnorm_attention_kernel<T, E><<<grid, ATTN_THREADS, smem, stream>>>(qkv, out, hw, heads,
                                                                         ch, eps);
  return cudaGetLastError();
}

// The CUDA-core kernel with the largest query tile T (64 down to 8) whose
// shared memory fits, at ch channels a head.
template <class E>
cudaError_t launch_attention_cc(const E* qkv, E* out, int n, int hw, int heads, int ch,
                                float eps, cudaStream_t stream) {
  if (attn_smem_floats(64, ch) * sizeof(float) <= kMaxSmem)
    return launch_attention<64, E>(qkv, out, n, hw, heads, ch, eps, stream);
  if (attn_smem_floats(32, ch) * sizeof(float) <= kMaxSmem)
    return launch_attention<32, E>(qkv, out, n, hw, heads, ch, eps, stream);
  if (attn_smem_floats(16, ch) * sizeof(float) <= kMaxSmem)
    return launch_attention<16, E>(qkv, out, n, hw, heads, ch, eps, stream);
  if (attn_smem_floats(8, ch) * sizeof(float) <= kMaxSmem)
    return launch_attention<8, E>(qkv, out, n, hw, heads, ch, eps, stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Tensor-core path
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 256;  // 8 warps: 4 groups of 16 query rows x 2 key halves
constexpr int TC_KT = 64;        // queries per block = keys per chunk

template <int CH>
struct TcAttn {
  static_assert(CH % 16 == 0 && CH <= 64, "channels per head of the tensor-core path");
  static constexpr int RS = 3 * CH + 4;     // raw tile row: one pixel's q, k, v + pad
  static constexpr int WORDS = 3 * CH / 4;  // 16-byte words of one pixel's slice
  static constexpr int TILE = TC_KT * RS;
  static constexpr int NT = CH / 8;         // k8 steps of Q K^T, n8 tiles of P V
  static constexpr int KN = TC_KT / 16;     // per warp: n8 tiles of Q K^T, k8 steps of P V
  static constexpr int GV = NT < 4 ? NT : 4;  // P V output tiles per group of mma chains
  // tiles of shared memory for nc chunks: the own chunk + a ring of up to 2
  static constexpr __host__ __device__ int slots(int nc) { return nc < 3 ? nc : 3; }
  static constexpr size_t smem_bytes(int nc) {
    return (slots(nc) * (size_t)TILE + 3 * TC_KT) * sizeof(float);
  }
};

// Copies the 64 pixels of chunk c of this head into a raw tile (zeros past HW).
// float32: 16-byte cp.async words.  16-bit E: 16-byte words of 8 values,
// loaded, widened to float32 (exact) and stored as two float4, synchronously
// (cp.async copies bytes and cannot widen).
template <int CH, class E>
__device__ __forceinline__ void load_chunk(const E* __restrict__ head_base, size_t pix,
                                           int hw, int c, float* dst) {
  using A = TcAttn<CH>;
  const int p0 = c * TC_KT;
  if constexpr (std::is_same<E, float>::value) {
#pragma unroll 1
    for (int i = threadIdx.x; i < TC_KT * A::WORDS; i += TC_THREADS) {
      const int r = i / A::WORDS, w = i - r * A::WORDS;
      const bool full = p0 + r < hw;
      cp_async16(dst + r * A::RS + 4 * w,
                 head_base + (size_t)(full ? p0 + r : 0) * pix + 4 * w, full);
    }
  } else {
    constexpr int WORDS8 = 3 * CH / 8;  // 16-byte words of one pixel's slice
#pragma unroll 1
    for (int i = threadIdx.x; i < TC_KT * WORDS8; i += TC_THREADS) {
      const int r = i / WORDS8, w = i - r * WORDS8;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (p0 + r < hw)
        raw = __ldg(reinterpret_cast<const uint4*>(head_base + (size_t)(p0 + r) * pix + 8 * w));
      const float2 a = unpack2(raw.x, (E*)nullptr), b = unpack2(raw.y, (E*)nullptr);
      const float2 c2 = unpack2(raw.z, (E*)nullptr), d = unpack2(raw.w, (E*)nullptr);
      float4* out = reinterpret_cast<float4*>(dst + r * A::RS + 8 * w);
      out[0] = make_float4(a.x, a.y, b.x, b.y);
      out[1] = make_float4(c2.x, c2.y, d.x, d.y);
    }
  }
}

// scale[s * 64 + r] = 1 / (eps + ||x|| / sqrt(ch)) of slot s (k, v) of
// pixel r of the tile; for the block's own chunk (own) also slot 0, the
// query scale times log2(e) / sqrt(ch), which stays for the whole walk.
// 8 lanes per pixel; lane l sums whole triples of float4 words
// (12 floats: 4 x (q, k, v)) 3u..3u + 2 for u = l, l + 8, ...
template <int CH>
__device__ __forceinline__ void pixel_scales(const float* tile, float* scale, float eps,
                                             float norm_scale, bool own) {
  using A = TcAttn<CH>;
  const int l8 = threadIdx.x & 7;
#pragma unroll 1
  for (int r = threadIdx.x >> 3; r < TC_KT; r += TC_THREADS / 8) {
    const float4* row = reinterpret_cast<const float4*>(tile + r * A::RS);
    float sq = 0.f, sk = 0.f, sv = 0.f;
    for (int u = l8; u < CH / 4; u += 8) {
      const float4 a = row[3 * u], b = row[3 * u + 1], c = row[3 * u + 2];
      sq += a.x * a.x + a.w * a.w + b.z * b.z + c.y * c.y;
      sk += a.y * a.y + b.x * b.x + b.w * b.w + c.z * c.z;
      sv += a.z * a.z + b.y * b.y + c.x * c.x + c.w * c.w;
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      sq += __shfl_xor_sync(0xffffffffu, sq, o);
      sk += __shfl_xor_sync(0xffffffffu, sk, o);
      sv += __shfl_xor_sync(0xffffffffu, sv, o);
    }
    if (l8 == 1 || l8 == 2 || (l8 == 0 && own)) {
      const float ss = l8 == 0 ? sq : (l8 == 1 ? sk : sv);
      const float x = 1.0f / (eps + sqrtf(ss) * norm_scale);
      scale[l8 * TC_KT + r] = l8 ? x : x * (1.4426950408889634f / sqrtf((float)CH));
    }
  }
}

// acc[j] += a * b[j] in 3xTF32 for G n8 tiles, each tile's three passes
// in a fresh fragment, issued pass by pass so the G chains are independent.
template <int G>
__device__ __forceinline__ void mma3_add(float (*acc)[4], const uint32_t (&ab)[4],
                                         const uint32_t (&as)[4], const uint32_t (&bb)[G][2],
                                         const uint32_t (&bs)[G][2]) {
  float d[G][4];
#pragma unroll
  for (int j = 0; j < G; ++j) mma_tf32_first(d[j], as, bb[j]);
#pragma unroll
  for (int j = 0; j < G; ++j) mma_tf32(d[j], ab, bs[j]);
#pragma unroll
  for (int j = 0; j < G; ++j) mma_tf32(d[j], ab, bb[j]);
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[j][v] += d[j][v];
}

// Two blocks per SM cap a thread at 128 registers, which ch = 64 (32
// output accumulators a lane) cannot keep without spilling: it runs one
// block of 8 warps per SM.
// E: float32, or the 16-bit type of a bf16 / fp16 qkv and output.
template <int CH, class E>
__global__ void __launch_bounds__(TC_THREADS, CH < 64 ? 2 : 1)
pixelnorm_attention_tc(const E* __restrict__ qkv, E* __restrict__ out, int hw,
                       int heads, float eps) {
  using A = TcAttn<CH>;
  extern __shared__ float4 smem_tc[];
  // Slot 0 holds the block's own chunk (its queries) for the whole walk;
  // the other chunks pass through a ring of slots 1 and 2.
  float* tiles = reinterpret_cast<float*>(smem_tc);
  const int nc = gridDim.y;  // chunks = query tiles
  float* scale = tiles + A::slots(nc) * A::TILE;  // [3][64]: see pixel_scales

  const int head = blockIdx.x % heads, n = blockIdx.x / heads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int C = heads * CH;
  const size_t pix = 3 * (size_t)C;
  const E* head_base = qkv + (size_t)n * hw * pix + (size_t)head * 3 * CH;
  const int y = blockIdx.y;
  const float norm_scale = 1.0f / sqrtf((float)CH);
  const int r0 = (warp & 3) * 16 + g;  // this lane's query rows: r0 and r0 + 8
  const int k0 = (warp >> 2) * 32;     // this warp's half of each chunk's keys

  // step i consumes chunk y + i (mod nc): slot 0 at step 0, then 1, 2, 1, ...
  load_chunk<CH, E>(head_base, pix, hw, y, tiles);
  cp_async_commit();
  if (nc > 1) load_chunk<CH, E>(head_base, pix, hw, y + 1 < nc ? y + 1 : 0, tiles + A::TILE);
  cp_async_commit();

  const float* qt = tiles + r0 * A::RS + 3 * t;  // q of rows r0 / r0 + 8, channel t
  float o[A::NT][4];   // output accumulator fragments
#pragma unroll
  for (int j = 0; j < A::NT; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) o[j][v] = 0.f;
  // over this warp's keys: running max of rows r0, r0 + 8 (log2 units;
  // -inf while none was seen) and this lane's share of their running sums
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int i = 0; i < nc; ++i) {
    const float* tile = tiles + (i == 0 ? 0 : 1 + ((i - 1) & 1)) * A::TILE;
    const int c = y + i < nc ? y + i : y + i - nc;
    const int nk = min(TC_KT, hw - c * TC_KT);
    cp_async_wait<1>();  // chunk i landed (chunk i + 1 may be in flight)
    __syncthreads();
    pixel_scales<CH>(tile, scale, eps, norm_scale, i == 0);
    __syncthreads();

    // S = Q K^T: s[j] holds rows (g, g + 8) x keys k0 + 8j + 2t, + 1
    float s[A::KN][4];
#pragma unroll
    for (int j = 0; j < A::KN; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) s[j][v] = 0.f;
#pragma unroll
    for (int kk = 0; kk < A::NT; ++kk) {
      uint32_t ab[4], as[4], bb[A::KN][2], bs[A::KN][2];
      split_tf32(qt[24 * kk], ab[0], as[0]);
      split_tf32(qt[24 * kk + 8 * A::RS], ab[1], as[1]);
      split_tf32(qt[24 * kk + 12], ab[2], as[2]);
      split_tf32(qt[24 * kk + 8 * A::RS + 12], ab[3], as[3]);
#pragma unroll
      for (int j = 0; j < A::KN; ++j) {
        const float* kp = tile + (k0 + 8 * j + g) * A::RS + 3 * (8 * kk + t) + 1;
        split_tf32(kp[0], bb[j][0], bs[j][0]);
        split_tf32(kp[12], bb[j][1], bs[j][1]);
      }
      mma3_add<A::KN>(s, ab, as, bb, bs);
    }

    // online softmax: query and key scales, mask, running max over the
    // row's 4 lanes
    float mx[2] = {-INFINITY, -INFINITY};
    const float qs[2] = {scale[r0], scale[r0 + 8]};
#pragma unroll
    for (int j = 0; j < A::KN; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * t + e;
        const float ks = scale[TC_KT + key];
        s[j][e] = key < nk ? s[j][e] * qs[0] * ks : -INFINITY;
        s[j][2 + e] = key < nk ? s[j][2 + e] * qs[1] * ks : -INFINITY;
        mx[0] = fmaxf(mx[0], s[j][e]);
        mx[1] = fmaxf(mx[1], s[j][2 + e]);
      }
    float alpha[2], m_sub[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      // -inf only while every key this warp saw was past HW: then O and l
      // are 0 and stay 0, and the offset 0 keeps exp2f off -inf - -inf
      const float m_new = fmaxf(m_run[h], mx[h]);
      m_sub[h] = m_new == -INFINITY ? 0.f : m_new;
      alpha[h] = exp2f(m_run[h] - m_sub[h]);  // 0 at the first chunk
      m_run[h] = m_new;
      l_run[h] *= alpha[h];
    }
    // P in place of S, times each value's scale for the P V product
#pragma unroll
    for (int j = 0; j < A::KN; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float vs = scale[2 * TC_KT + k0 + 8 * j + 2 * t + e];
        const float p0 = exp2f(s[j][e] - m_sub[0]), p1 = exp2f(s[j][2 + e] - m_sub[1]);
        l_run[0] += p0;
        l_run[1] += p1;
        s[j][e] = p0 * vs;
        s[j][2 + e] = p1 * vs;
      }
#pragma unroll
    for (int j = 0; j < A::NT; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V over the key groups; k index t <-> key 2t, t + 4 <-> key 2t + 1
#pragma unroll
    for (int kk = 0; kk < A::KN; ++kk) {
      uint32_t ab[4], as[4];
      split_tf32(s[kk][0], ab[0], as[0]);
      split_tf32(s[kk][2], ab[1], as[1]);
      split_tf32(s[kk][1], ab[2], as[2]);
      split_tf32(s[kk][3], ab[3], as[3]);
      const float* vp = tile + (k0 + 8 * kk + 2 * t) * A::RS + 3 * g + 2;
#pragma unroll
      for (int j0 = 0; j0 < A::NT; j0 += A::GV) {  // GV output tiles at a time
        uint32_t bb[A::GV][2], bs[A::GV][2];
#pragma unroll
        for (int j = 0; j < A::GV; ++j) {
          split_tf32(vp[24 * (j0 + j)], bb[j][0], bs[j][0]);
          split_tf32(vp[24 * (j0 + j) + A::RS], bb[j][1], bs[j][1]);
        }
        mma3_add<A::GV>(o + j0, ab, as, bb, bs);
      }
    }

    __syncthreads();  // every warp is done with this chunk's slot and scales
    if (i + 2 < nc) {  // into the ring slot chunk i leaves (slot 2 after step 0)
      const int c2 = y + i + 2 < nc ? y + i + 2 : y + i + 2 - nc;
      load_chunk<CH, E>(head_base, pix, hw, c2, tiles + (1 + ((i + 1) & 1)) * A::TILE);
    }
    cp_async_commit();
  }

  // merge the two key halves: the second half's warps hand their (max,
  // sum, O) fragments to the first half's through the free tile memory,
  // laid out [value][128 lanes] so each access is one row of banks
  __syncthreads();  // every warp is done with the tiles (the ring is drained)
  float* xch = tiles + (threadIdx.x & 127);
  if (k0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      xch[(4 * A::NT + h) * 128] = m_run[h];
      xch[(4 * A::NT + 2 + h) * 128] = l_run[h];
    }
#pragma unroll
    for (int j = 0; j < A::NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) xch[(4 * j + v) * 128] = o[j][v];
  }
  __syncthreads();
  if (k0) return;
  float a0[2], a1[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m1 = xch[(4 * A::NT + h) * 128];
    const float m = fmaxf(m_run[h], m1);  // finite: the first half saw key 0
    a0[h] = exp2f(m_run[h] - m);
    a1[h] = exp2f(m1 - m);              // 0 for a half that saw no key
    l_run[h] = l_run[h] * a0[h] + xch[(4 * A::NT + 2 + h) * 128] * a1[h];
  }
#pragma unroll
  for (int j = 0; j < A::NT; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) o[j][v] = o[j][v] * a0[v >> 1] + xch[(4 * j + v) * 128] * a1[v >> 1];

  // O / l, stored from the fragments
  const int q0 = y * TC_KT;
  E* out_base = out + ((size_t)n * hw + q0) * C + (size_t)head * CH + 2 * t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = r0 + 8 * h;
    if (q0 + row < hw) {
#pragma unroll
      for (int j = 0; j < A::NT; ++j) {
        E* dst = out_base + (size_t)row * C + 8 * j;
        if constexpr (std::is_same<E, float>::value)
          *reinterpret_cast<float2*>(dst) = make_float2(o[j][2 * h] / l, o[j][2 * h + 1] / l);
        else  // rounded once, to the type of qkv
          *reinterpret_cast<uint32_t*>(dst) = pack2<E>(o[j][2 * h] / l, o[j][2 * h + 1] / l);
      }
    }
  }
}

template <int CH, class E>
cudaError_t launch_attention_tc(const E* qkv, E* out, int n, int hw, int heads,
                                float eps, cudaStream_t stream) {
  using A = TcAttn<CH>;
  static PerDevice<cudaError_t> state;  // once per instantiation and device
  const cudaError_t* attr = state.get([] {
    return cudaFuncSetAttribute(pixelnorm_attention_tc<CH, E>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)A::smem_bytes(3));
  });
  if (!attr) return cudaErrorInvalidDevice;
  if (*attr != cudaSuccess) return *attr;
  if (reinterpret_cast<uintptr_t>(qkv) & 15) return cudaErrorMisalignedAddress;  // 16-byte copies
  const int nc = (hw + TC_KT - 1) / TC_KT;
  if (nc > 65535) return cudaErrorInvalidValue;
  dim3 grid(n * heads, nc);
  pixelnorm_attention_tc<CH, E><<<grid, TC_THREADS, A::smem_bytes(nc), stream>>>(
      qkv, out, hw, heads, eps);
  return cudaGetLastError();
}

}  // namespace tdt

// The dispatch rule: 1 if a head of ch channels takes the tensor-core kernel,
// 0 if it takes the CUDA-core kernel.  ops/attention.py::attention_path states
// the same rule for the CPU; the card tests and chip_smoke.py hold the two equal.
extern "C" int tdt_attention_path(int ch) { return ch == 16 || ch == 32 || ch == 64; }

// dtype (tdt::DT_*): float32, bf16 or fp16 qkv and output, any width (the
// Pallas kernel widens qkv to float32 and writes qkv.dtype).  Each kernel
// widens a 16-bit value to float32 as it stages it, runs the pixel norm, the
// softmax and both products as for float32, and rounds the output once.
extern "C" int tdt_pixelnorm_attention(const void* qkv, void* out, int n, int hw, int heads,
                                       int ch, float eps, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || hw <= 0 || heads <= 0 || ch <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == tdt::DT_F32) {
    const float* q = static_cast<const float*>(qkv);
    float* o = static_cast<float*>(out);
    if (tdt_attention_path(ch)) {
      if (ch == 16) return (int)tdt::launch_attention_tc<16, float>(q, o, n, hw, heads, eps, s);
      if (ch == 32) return (int)tdt::launch_attention_tc<32, float>(q, o, n, hw, heads, eps, s);
      return (int)tdt::launch_attention_tc<64, float>(q, o, n, hw, heads, eps, s);
    }
    return (int)tdt::launch_attention_cc(q, o, n, hw, heads, ch, eps, s);
  }
  return (int)tdt::by_dtype(dtype, [&](auto* e) {
    using E = std::remove_pointer_t<decltype(e)>;
    const E* q = static_cast<const E*>(qkv);
    E* o = static_cast<E*>(out);
    if (!tdt_attention_path(ch)) return tdt::launch_attention_cc(q, o, n, hw, heads, ch, eps, s);
    if (ch == 16) return tdt::launch_attention_tc<16, E>(q, o, n, hw, heads, eps, s);
    if (ch == 32) return tdt::launch_attention_tc<32, E>(q, o, n, hw, heads, eps, s);
    return tdt::launch_attention_tc<64, E>(q, o, n, hw, heads, eps, s);
  });
}
