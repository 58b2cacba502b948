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
// What bounds it on the H100: nothing much at the shapes it serves.  The
// base model's midblock attends over 8x8 maps (HW = 64, 12 heads of 64
// channels): 2 * 2 * 64 * 64 * 64 FLOP per (batch, head), about 0.8 GFLOP at
// batch 64, against 48 KB of qkv read per (batch, head).  Eligible shapes
// reach HW = 2048, where the (HW, HW) logits of one head are 16 MB.
// What the design does: the TPU kernel kept a head's whole (HW, HW) logit
// matrix in VMEM, which does not fit a block's 227 KB of shared memory.
// Here one block owns (batch, head, T queries).  It stages its queries
// (pixel-normed) in shared memory, then walks the keys in chunks of T:
// each chunk of k and v is read straight from the interleaved NHWC qkv (no
// transpose pass), pixel-normed in shared memory, scored against the
// queries, and folded into a running (max, sum) softmax with the output
// accumulator rescaled, so the logits never leave shared memory.  The
// output is written in its final (N, H, W, C) layout.  Arithmetic is float32
// FMAs on the CUDA cores: the JAX f32 path is exact float32 and the parity
// bar is 1e-4.  T is 64 where the shared memory allows it (ch <= 209) and
// halves down to 8 (ch <= 1812) for wider heads.
#include <cuda_runtime.h>
#include <math.h>

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
// zero-filling rows past the tile, then pixel-norm each row.
template <int T>
__device__ void stage_normed(const float* __restrict__ head_base, size_t pix_stride,
                             int p0, int rows, int ch, int slot, float eps,
                             float norm_scale, float* dst) {
  const int ld = ch + 1;
  for (int i = threadIdx.x; i < T * ch; i += ATTN_THREADS) {
    const int p = i / ch, c = i - p * ch;
    dst[p * ld + c] = p < rows ? head_base[(size_t)(p0 + p) * pix_stride + c * 3 + slot] : 0.f;
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

template <int T>
__global__ void __launch_bounds__(ATTN_THREADS)
pixelnorm_attention_kernel(const float* __restrict__ qkv, float* __restrict__ out,
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
  const float* head_base = qkv + (size_t)n * hw * pix_stride + (size_t)head * ch * 3;
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
  float* out_base = out + ((size_t)n * hw + q0) * C + (size_t)head * ch;
  for (int i = tid; i < nq * ch; i += ATTN_THREADS) {
    const int qi = i / ch, c = i - qi * ch;
    out_base[(size_t)qi * C + c] = sO[qi * ld + c] / sL[qi];
  }
}

template <int T>
cudaError_t launch_attention(const float* qkv, float* out, int n, int hw, int heads,
                             int ch, float eps, cudaStream_t stream) {
  const size_t smem = attn_smem_floats(T, ch) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(pixelnorm_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n * heads, (hw + T - 1) / T);
  pixelnorm_attention_kernel<T><<<grid, ATTN_THREADS, smem, stream>>>(qkv, out, hw, heads,
                                                                      ch, eps);
  return cudaGetLastError();
}

}  // namespace tdt

// Largest shared memory a block may take on sm_90 (227 KB).
static const size_t kMaxSmem = 232448;

extern "C" int tdt_pixelnorm_attention(const float* qkv, float* out, int n, int hw,
                                       int heads, int ch, float eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || hw <= 0 || heads <= 0 || ch <= 0) return (int)cudaErrorInvalidValue;
  if (tdt::attn_smem_floats(64, ch) * sizeof(float) <= kMaxSmem)
    return (int)tdt::launch_attention<64>(qkv, out, n, hw, heads, ch, eps, s);
  if (tdt::attn_smem_floats(32, ch) * sizeof(float) <= kMaxSmem)
    return (int)tdt::launch_attention<32>(qkv, out, n, hw, heads, ch, eps, s);
  if (tdt::attn_smem_floats(16, ch) * sizeof(float) <= kMaxSmem)
    return (int)tdt::launch_attention<16>(qkv, out, n, hw, heads, ch, eps, s);
  if (tdt::attn_smem_floats(8, ch) * sizeof(float) <= kMaxSmem)
    return (int)tdt::launch_attention<8>(qkv, out, n, hw, heads, ch, eps, s);
  return (int)cudaErrorInvalidValue;
}
