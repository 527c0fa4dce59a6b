// Flash attention forward with GQA, causal and window masks, fp32, for
// sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention -> _fa_kernel). Same function: for query head h, which
// reads KV head h / G, softmax(q k^T / sqrt(D)) v over the visible keys,
// where key j is visible to query i iff j < Skv, j <= i (causal) and
// j > i - window (window). Online softmax with fp32 accumulation; K blocks
// wholly above the diagonal or left of the window are skipped. A query with
// no visible key gives zeros.
//
// What bounds it here: operations. At RecurrentGemma's prefill (H = 16,
// one KV head, D = 256, S = 4096, window 2048) the visible (q, k) pairs need
// 103 GFLOP against 142 MB of q, k, v and out, far past the card's ridge.
// fp32 inputs have no tensor-core path, so the rate is the SIMT FMA rate,
// and the design aims to keep the FMA pipes fed from shared memory.
// Design: one CTA of 256 threads per (b, h, 64-row query tile). The Q tile
// (64 x D) stays in shared memory for the whole key loop; K and V blocks of
// 32 rows take turns in one buffer (K for S = QK^T, then V for S V), so a
// CTA needs 109 KB at D = 256 and two CTAs share an SM, one loading while
// the other computes. Rows are padded by 4 floats so the 16-byte reads of
// eight rows fall in distinct banks. Each thread owns a 4 x 2 block of S and
// a 4 x D/16 block of the output, kept in registers; four threads own each
// row's running max and sum. Tensors are read in place through their
// strides (the model passes its (B, S, H, D) projections as (B, H, S, D)
// views), the ragged tail is masked, never padded.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;   // query rows per CTA
constexpr int BK = 32;   // key rows per block of the loop
constexpr int NT = 256;  // threads per CTA
constexpr int PAD = 4;   // floats of padding per shared row
constexpr int SP = BK + 4;  // row pitch of the score tile

struct Strides {
  long long b, h, s;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)BQ * (D + PAD) + (size_t)BK * (D + PAD) + BQ * SP + 2 * BQ);
}

// Copies rows [r0, r0 + n) of a (rows x D) tile from global memory into
// shared memory with pitch D + PAD, zero-filling rows at or past `limit`.
template <int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          long long stride, int r0, int n,
                                          int limit) {
  constexpr int V = D / 4;  // float4 per row
  for (int idx = threadIdx.x; idx < n * V; idx += NT) {
    const int r = idx / V, c = idx - r * V;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < limit)
      val = *reinterpret_cast<const float4*>(src + (r0 + r) * stride + 4 * c);
    *reinterpret_cast<float4*>(dst + r * (D + PAD) + 4 * c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 2)
    flash_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           Strides sq, Strides sk, Strides sv, Strides so,
                           int H, int G, int Sq, int Skv, int causal,
                           int window, float scale) {
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // BQ x (D + PAD)
  float* kv_s = q_s + BQ * (D + PAD);            // BK x (D + PAD)
  float* p_s = kv_s + BK * (D + PAD);            // BQ x SP
  float* alpha_s = p_s + BQ * SP;                // BQ
  float* l_s = alpha_s + BQ;                     // BQ

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;  // S and output blocks
  const int srow = tid >> 2, part = tid & 3;  // softmax: 4 threads a row
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / G;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;

  // key blocks that hold a visible key for some row of this tile
  int kb_lo = 0, kb_hi = (Skv + BK - 1) / BK;
  if (causal) kb_hi = min(kb_hi, (q0 + BQ - 1) / BK + 1);
  if (window > 0) kb_lo = max(0, q0 - window + 1) / BK;

  load_tile<D>(q_s, qb, sq.s, q0, BQ, Sq);

  constexpr int CPT = D / 16;  // output columns per thread
  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;  // row srow, held by its 4 threads

  for (int blk = kb_lo; blk < kb_hi; ++blk) {
    const int k0 = blk * BK;
    __syncthreads();  // the previous block's S V is done with kv_s
    load_tile<D>(kv_s, kb, sk.s, k0, BK, Skv);
    __syncthreads();

    // S = Q K^T for rows 4 ty + i, keys tx + 16 j
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_s + (4 * ty + i) * (D + PAD) + d);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        kv[j] = *reinterpret_cast<const float4*>(kv_s + (tx + 16 * j) * (D + PAD) + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y +
                     qv[i].z * kv[j].z + qv[i].w * kv[j].w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kj = k0 + tx + 16 * j;
        bool vis = kj < Skv;
        if (causal) vis = vis && kj <= qi;
        if (window > 0) vis = vis && kj > qi - window;
        p_s[(4 * ty + i) * SP + tx + 16 * j] = vis ? s[i][j] * scale : -INFINITY;
      }
    }
    __syncthreads();

    // V into the buffer K has left, while the rows' softmax is updated
    load_tile<D>(kv_s, vb, sv.s, k0, BK, Skv);
    {
      float pv[BK / 4];
      float mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < BK / 4; ++e) {
        pv[e] = p_s[srow * SP + part + 4 * e];
        mx = fmaxf(mx, pv[e]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      float alpha = 1.f, sum = 0.f;
      if (m_new != -INFINITY) {
        alpha = expf(m_run - m_new);  // 0 while m_run is -inf
#pragma unroll
        for (int e = 0; e < BK / 4; ++e) {
          pv[e] = expf(pv[e] - m_new);  // masked keys: exp(-inf) = 0
          sum += pv[e];
        }
      } else {
#pragma unroll
        for (int e = 0; e < BK / 4; ++e) pv[e] = 0.f;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run = l_run * alpha + sum;
      m_run = m_new;
#pragma unroll
      for (int e = 0; e < BK / 4; ++e) p_s[srow * SP + part + 4 * e] = pv[e];
      if (part == 0) alpha_s[srow] = alpha;
    }
    __syncthreads();

    // O = alpha O + P V for rows 4 ty + i, columns 4 tx + 64 c + e
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = alpha_s[4 * ty + i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = p_s[(4 * ty + i) * SP + kk];
#pragma unroll
      for (int c = 0; c < CPT / 4; ++c) {
        const float4 vv =
            *reinterpret_cast<const float4*>(kv_s + kk * (D + PAD) + 4 * tx + 64 * c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * c + 0] += p[i] * vv.x;
          acc[i][4 * c + 1] += p[i] * vv.y;
          acc[i][4 * c + 2] += p[i] * vv.z;
          acc[i][4 * c + 3] += p[i] * vv.w;
        }
      }
    }
  }

  if (part == 0) l_s[srow] = l_run;
  __syncthreads();
  float* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (q0 + r >= Sq) continue;
    const float l = l_s[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int c = 0; c < CPT / 4; ++c) {
      float4 out = make_float4(acc[i][4 * c] * inv, acc[i][4 * c + 1] * inv,
                               acc[i][4 * c + 2] * inv, acc[i][4 * c + 3] * inv);
      *reinterpret_cast<float4*>(ob + (q0 + r) * so.s + 4 * tx + 64 * c) = out;
    }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o,
           Strides sq, Strides sk, Strides sv, Strides so, int B, int H,
           int G, int Sq, int Skv, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<D><<<grid, NT, smem, stream>>>(
      q, k, v, o, sq, sk, sv, so, H, G, Sq, Skv, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: (B,H,Sq,D); k, v: (B,KV,Skv,D); element strides per tensor for
// (b, head, s), the last dim contiguous. window <= 0 means none.
// Returns a CUDA error code, or -1 for a head dim it was not built for.
int flash_attention_fwd(const float* q, const float* k, const float* v,
                        float* o, long long sqb, long long sqh, long long sqs,
                        long long skb, long long skh, long long sks,
                        long long svb, long long svh, long long svs,
                        long long sob, long long soh, long long sos, int B,
                        int H, int KV, int Sq, int Skv, int D, int causal,
                        int window, float scale, cudaStream_t stream) {
  const Strides sq{sqb, sqh, sqs}, sk{skb, skh, sks}, sv{svb, svh, svs},
      so{sob, soh, sos};
  const int G = H / KV;
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, sq, sk, sv, so, B, H, G, Sq, Skv, causal,
                        window, scale, stream);
    case 128:
      return launch<128>(q, k, v, o, sq, sk, sv, so, B, H, G, Sq, Skv,
                         causal, window, scale, stream);
    case 256:
      return launch<256>(q, k, v, o, sq, sk, sv, so, B, H, G, Sq, Skv,
                         causal, window, scale, stream);
    default:
      return -1;
  }
}

}  // extern "C"
