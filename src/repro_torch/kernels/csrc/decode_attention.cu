// Single-token decode attention over a KV cache, split along the cache
// (flash-decoding), for sm_90a. q is fp32; the cache is fp32 or bf16.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention -> _dec_kernel). Same function: for each batch row b
// and query head h (reading KV head h / G), softmax(q k^T / sqrt(D)) v over
// the cache positions s < lengths[b]; a row of length 0 gives zeros.
//
// What bounds it here: bytes. Each valid cache position is read once (K and
// V rows of D values) for all G query heads that share its KV head, and the
// arithmetic is 4 G D flops a position, far below the card's ridge. At
// RecurrentGemma's decode (B = 4, one KV head, S = 2048) a grid of one CTA
// per (b, kv head), as on the TPU, would be 4 CTAs on 132 SMs.
// Design: split S into blocks of 64 positions, one CTA of 256 threads per
// (block, kv head, b) (128 CTAs at B = 4, S = 2048); a CTA past its row's
// length exits at once. Each CTA keeps the G query rows in shared memory,
// scores its positions a warp per position (coalesced reads of the K row,
// widened to fp32 in registers, then one warp reduction per head), takes the
// block's softmax per head, and accumulates P V a thread per column. It
// writes its partial (max, sum, accumulator); a second kernel combines the
// blocks of each (b, h) with the usual rescaling. The cache is read in place
// through its (B, S, KV, D) strides, never transposed or copied, and the
// lengths are read from device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int CH = 64;     // cache positions per CTA
constexpr int NT = 256;    // threads per CTA
constexpr int MAXG = 16;   // query heads per KV head
constexpr int MAXD = 256;  // head dim

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

struct Cache {
  long long b, s, kv;  // element strides; the head dim is contiguous
};

// Partial results of block `blk`: m, l at [(b KV + kv) G + g] * NS + blk,
// acc at that index times D.
template <typename T>
__global__ void __launch_bounds__(NT)
    decode_split_kernel(const float* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths, float* __restrict__ m_part,
                        float* __restrict__ l_part, float* __restrict__ acc_part,
                        Cache sk, Cache sv, int H, int KV, int S, int D,
                        float scale) {
  __shared__ __align__(16) float q_s[MAXG * MAXD];
  __shared__ float p_s[MAXG][CH];
  const int blk = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int NS = gridDim.x, G = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(lengths[b], S);
  const int s0 = blk * CH, n = min(CH, len - s0);
  const size_t part0 = ((size_t)b * KV + kvh) * G * NS + blk;

  if (n <= 0) {  // nothing of this row in this block
    if (tid < G) {
      m_part[part0 + (size_t)tid * NS] = -INFINITY;
      l_part[part0 + (size_t)tid * NS] = 0.f;
    }
    for (int i = tid; i < G * D; i += NT) {
      const int g = i / D, d = i - g * D;
      acc_part[(part0 + (size_t)g * NS) * D + d] = 0.f;
    }
    return;
  }

  const float* qb = q + ((size_t)b * H + (size_t)kvh * G) * D;
  for (int i = tid; i < G * D; i += NT) q_s[i] = qb[i] * scale;
  __syncthreads();

  // scores: a warp per position, lanes along D
  const T* kb = k + b * sk.b + kvh * sk.kv;
  for (int p = warp; p < n; p += NT / 32) {
    const T* row = kb + (s0 + p) * sk.s;
    float part[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) part[g] = 0.f;
    for (int d = 4 * lane; d < D; d += 128) {
      const float4 kv = load4(row + d);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          const float4 qv = *reinterpret_cast<const float4*>(q_s + g * D + d);
          part[g] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        float s = part[g];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) p_s[g][p] = s;
      }
    }
  }
  __syncthreads();

  // the block's softmax, a warp per head
  for (int g = warp; g < G; g += NT / 32) {
    float mx = -INFINITY;
    for (int p = lane; p < n; p += 32) mx = fmaxf(mx, p_s[g][p]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int p = lane; p < n; p += 32) {
      const float e = expf(p_s[g][p] - mx);
      p_s[g][p] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      m_part[part0 + (size_t)g * NS] = mx;
      l_part[part0 + (size_t)g * NS] = sum;
    }
  }
  __syncthreads();

  // P V, a thread per column
  const T* vb = v + b * sv.b + kvh * sv.kv;
  for (int d = tid; d < D; d += NT) {
    float acc[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) acc[g] = 0.f;
    for (int p = 0; p < n; ++p) {
      const float vv = load1(vb + (s0 + p) * sv.s + d);
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) acc[g] += p_s[g][p] * vv;
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G) acc_part[(part0 + (size_t)g * NS) * D + d] = acc[g];
  }
}

// One CTA per (h, b): out[b, h] = sum_blk e^(m_blk - M) acc_blk /
// sum_blk e^(m_blk - M) l_blk, zeros when no block saw a position.
__global__ void __launch_bounds__(NT)
    decode_combine_kernel(const float* __restrict__ m_part,
                          const float* __restrict__ l_part,
                          const float* __restrict__ acc_part,
                          float* __restrict__ out, int H, int NS, int D) {
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t part0 = ((size_t)b * H + h) * NS;  // (b KV + kv) G + g == b H + h
  float M = -INFINITY;
  for (int j = 0; j < NS; ++j) M = fmaxf(M, m_part[part0 + j]);
  float den = 0.f;
  if (M != -INFINITY)
    for (int j = 0; j < NS; ++j)
      den += expf(m_part[part0 + j] - M) * l_part[part0 + j];
  for (int d = threadIdx.x; d < D; d += NT) {
    float num = 0.f;
    if (M != -INFINITY)
      for (int j = 0; j < NS; ++j)
        num += expf(m_part[part0 + j] - M) * acc_part[(part0 + j) * D + d];
    out[((size_t)b * H + h) * D + d] = den > 0.f ? num / den : 0.f;
  }
}

template <typename T>
int launch(const float* q, const void* k, const void* v, const int* lengths,
           float* m_part, float* l_part, float* acc_part, float* out,
           Cache sk, Cache sv, int B, int H, int KV, int S, int D,
           float scale, cudaStream_t stream) {
  const int NS = (S + CH - 1) / CH;
  decode_split_kernel<T><<<dim3(NS, KV, B), NT, 0, stream>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), lengths, m_part,
      l_part, acc_part, sk, sv, H, KV, S, D, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<<<dim3(H, B), NT, 0, stream>>>(m_part, l_part,
                                                       acc_part, out, H, NS, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int decode_attention_block(void) { return CH; }
int decode_attention_max_group(void) { return MAXG; }
int decode_attention_max_d(void) { return MAXD; }

// q, out: (B,H,D) fp32 contiguous; k, v: (B,S,KV,D) with element strides
// for (b, s, kv) and the head dim contiguous; bf16 != 0 for a bf16 cache.
// m_part, l_part: B*H*NS floats; acc_part: B*H*NS*D, NS = ceil(S / 64).
int decode_attention_fwd(const float* q, const void* k, const void* v,
                         const int* lengths, float* m_part, float* l_part,
                         float* acc_part, float* out, long long skb,
                         long long sks, long long skkv, long long svb,
                         long long svs, long long svkv, int B, int H, int KV,
                         int S, int D, int bf16, float scale,
                         cudaStream_t stream) {
  const Cache sk{skb, sks, skkv}, sv{svb, svs, svkv};
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, lengths, m_part, l_part, acc_part,
                                 out, sk, sv, B, H, KV, S, D, scale, stream);
  return launch<float>(q, k, v, lengths, m_part, l_part, acc_part, out, sk,
                       sv, B, H, KV, S, D, scale, stream);
}

}  // extern "C"
