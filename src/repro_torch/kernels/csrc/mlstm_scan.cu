// Chunkwise mLSTM forward from zero state, fp32, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/mlstm_scan.py
// (mlstm_scan -> _mlstm_kernel). Same function: for each (batch, head) walk
// the sequence in chunks, carrying the matrix memory C (D x D), the
// normaliser n (D) and the running max m; inside a chunk the output is the
// attention-like form  h = ((QK^T * exp(D - m_row)) V + (Q C) exp(b + m_prev
// - m_row)) / max(|n_t|, exp(-m_row)),  q scaled by D^-0.5.
//
// What bounds it here: fp32 FMA work (about 4*D*(L + D) flops per row, with
// L the chunk), not bytes: q, k, v and h are read or written once. The TPU
// kernel holds all of C in VMEM (576 KiB at D = 384); an SM has at most
// 227 KB of shared memory. So C is split by value columns: each CTA owns a
// D x 64 column tile of C (96 KiB at D = 384) and produces those 64 output
// columns. The grid is (D/64, H, B); at B = 8, H = 4, D = 384 that is 192
// CTAs. Each CTA recomputes its chunk's gates, decay and score matrix and
// the n and m terms, which costs 1/(D/64) of redundant QK^T work per CTA.
// The chunk is L = 32 rows so that q and k of a chunk (2 x 48 KiB) sit in
// shared memory beside the C tile; the function does not depend on the
// chunk size beyond rounding. All products are plain fp32 FMA from shared
// memory (no tensor cores yet), with register tiles of 2x4 and 4x4 outputs
// and padded q/k rows to keep shared-memory reads free of bank conflicts.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int L = 32;     // rows per chunk (one warp-wide scan over gates)
constexpr int DV = 64;    // value columns of C owned by one CTA
constexpr int NT = 256;   // threads per CTA

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__global__ void __launch_bounds__(NT)
mlstm_scan_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ ig,
                  const float* __restrict__ fg, float* __restrict__ h,
                  int S, int D) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int e0 = blockIdx.x * DV;
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const float* qb = q + bh * S * D;
  const float* kb = k + bh * S * D;
  const float* vb = v + bh * S * D;
  const float* ib = ig + bh * S;
  const float* fb = fg + bh * S;
  float* hb = h + bh * S * D;
  const float scale = rsqrtf((float)D);
  const int QS = D + 4;   // padded row stride of the q and k tiles
  const int D4 = D / 4;

  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // L x QS, q * D^-0.5
  float* sk = sq + L * QS;                      // L x QS, k (then k*contrib)
  float* sC = sk + L * QS;                      // D x DV, C[:, e0:e0+DV]
  float* sv = sC + D * DV;                      // L x DV
  float* sW = sv + L * DV;                      // L x (L+1), decayed scores
  float* sn = sW + L * (L + 1);                 // D, normaliser n
  float* sb = sn + D;                           // L, cumulative log f
  float* si = sb + L;                           // L, input gate
  float* sm = si + L;                           // L, row stabiliser m_row
  float* sx = sm + L;                           // L, inter scale
  float* sd = sx + L;                           // L, denominator
  float* sc = sd + L;                           // L, state contribution
  __shared__ float s_state_sc;

  for (int idx = tid; idx < D * DV; idx += NT) sC[idx] = 0.f;
  for (int idx = tid; idx < D; idx += NT) sn[idx] = 0.f;
  float m_prev = 0.f;  // kept by warp 0 only
  __syncthreads();

  for (int c0 = 0; c0 < S; c0 += L) {
    // -- load the chunk: q (scaled), k, the v column tile and the gates --
    const float4* q4 = reinterpret_cast<const float4*>(qb + (size_t)c0 * D);
    const float4* k4 = reinterpret_cast<const float4*>(kb + (size_t)c0 * D);
    for (int idx = tid; idx < L * D4; idx += NT) {
      const int r = idx / D4, c = idx - r * D4;
      float4 a = q4[idx];
      a.x *= scale; a.y *= scale; a.z *= scale; a.w *= scale;
      *reinterpret_cast<float4*>(sq + r * QS + 4 * c) = a;
      *reinterpret_cast<float4*>(sk + r * QS + 4 * c) = k4[idx];
    }
    for (int idx = tid; idx < L * (DV / 4); idx += NT) {
      const int r = idx / (DV / 4), c = idx - r * (DV / 4);
      *reinterpret_cast<float4*>(sv + r * DV + 4 * c) =
          *reinterpret_cast<const float4*>(vb + (size_t)(c0 + r) * D + e0 +
                                           4 * c);
    }
    if (warp == 0) {
      // -- gates: warp-wide scans over the chunk's L = 32 rows --
      const float it = ib[c0 + lane];
      float b = log_sigmoid(fb[c0 + lane]);
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, b, off);
        if (lane >= off) b += y;
      }
      // max_{s<=t} (b_t - b_s + i_s) = b_t + prefix max of (i_s - b_s)
      float a = it - b;
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, a, off);
        if (lane >= off) a = fmaxf(a, y);
      }
      const float b_tot = __shfl_sync(0xffffffffu, b, 31);
      const float a_all = __shfl_sync(0xffffffffu, a, 31);
      const float inter_log = b + m_prev;
      const float m_row = fmaxf(fmaxf(b + a, inter_log), 0.f);
      sb[lane] = b;
      si[lane] = it;
      sm[lane] = m_row;
      sx[lane] = expf(inter_log - m_row);
      const float m_new = fmaxf(b_tot + m_prev, b_tot + a_all);
      sc[lane] = expf(b_tot - b + it - m_new);
      if (lane == 0) s_state_sc = expf(b_tot + m_prev - m_new);
      m_prev = m_new;
    }
    __syncthreads();

    // -- decayed scores W[t][s] = (q_t . k_s) exp(b_t - b_s + i_s - m_row_t)
    //    for s <= t, and exactly 0 above the diagonal --
    {
      const int t = tid >> 3, sg = tid & 7;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const float* qr = sq + t * QS;
      for (int d = 0; d < D; d += 4) {
        const float4 qa = *reinterpret_cast<const float4*>(qr + d);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[j] = dot4(qa, *reinterpret_cast<const float4*>(
                                sk + (sg + 8 * j) * QS + d), acc[j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = sg + 8 * j;
        sW[t * (L + 1) + s] =
            s <= t ? acc[j] * expf(sb[t] - sb[s] + si[s] - sm[t]) : 0.f;
      }
    }
    __syncthreads();

    // -- denominator: n_t = (q_t . n_prev) inter_sc_t + sum_s W[t][s] --
    for (int t = warp; t < L; t += NT / 32) {
      float rs = sW[t * (L + 1) + lane];
      float nd = 0.f;
      for (int d = lane; d < D; d += 32) nd = fmaf(sq[t * QS + d], sn[d], nd);
      for (int off = 16; off > 0; off >>= 1) {
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
        nd += __shfl_xor_sync(0xffffffffu, nd, off);
      }
      if (lane == 0) sd[t] = fmaxf(fabsf(nd * sx[t] + rs), expf(-sm[t]));
    }
    __syncthreads();

    // -- output tile: h[t][e] = (W V + (Q C_prev) inter_sc) / denom --
    {
      const int e4 = tid & 15, t0 = 2 * (tid >> 4);
      float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
      for (int d = 0; d < D; d += 4) {
        const float4 x0 = *reinterpret_cast<const float4*>(sq + t0 * QS + d);
        const float4 x1 =
            *reinterpret_cast<const float4*>(sq + (t0 + 1) * QS + d);
        const float4 c0v = *reinterpret_cast<const float4*>(sC + d * DV + 4 * e4);
        const float4 c1v =
            *reinterpret_cast<const float4*>(sC + (d + 1) * DV + 4 * e4);
        const float4 c2v =
            *reinterpret_cast<const float4*>(sC + (d + 2) * DV + 4 * e4);
        const float4 c3v =
            *reinterpret_cast<const float4*>(sC + (d + 3) * DV + 4 * e4);
        fma4(a0, x0.x, c0v); fma4(a0, x0.y, c1v);
        fma4(a0, x0.z, c2v); fma4(a0, x0.w, c3v);
        fma4(a1, x1.x, c0v); fma4(a1, x1.y, c1v);
        fma4(a1, x1.z, c2v); fma4(a1, x1.w, c3v);
      }
      const float g0 = sx[t0], g1 = sx[t0 + 1];
      a0.x *= g0; a0.y *= g0; a0.z *= g0; a0.w *= g0;
      a1.x *= g1; a1.y *= g1; a1.z *= g1; a1.w *= g1;
      for (int s = 0; s < L; ++s) {
        const float4 vv = *reinterpret_cast<const float4*>(sv + s * DV + 4 * e4);
        fma4(a0, sW[t0 * (L + 1) + s], vv);
        fma4(a1, sW[(t0 + 1) * (L + 1) + s], vv);
      }
      const float r0 = 1.f / sd[t0], r1 = 1.f / sd[t0 + 1];
      a0.x *= r0; a0.y *= r0; a0.z *= r0; a0.w *= r0;
      a1.x *= r1; a1.y *= r1; a1.z *= r1; a1.w *= r1;
      *reinterpret_cast<float4*>(hb + (size_t)(c0 + t0) * D + e0 + 4 * e4) = a0;
      *reinterpret_cast<float4*>(hb + (size_t)(c0 + t0 + 1) * D + e0 + 4 * e4) =
          a1;
    }
    __syncthreads();

    // -- state update: k_s *= contrib_s; C = state_sc C + K^T V; n likewise --
    for (int idx = tid; idx < L * D; idx += NT) {
      const int r = idx / D, c = idx - r * D;
      sk[r * QS + c] *= sc[r];
    }
    __syncthreads();
    const float ssc = s_state_sc;
    for (int d = tid; d < D; d += NT) {
      float acc = ssc * sn[d];
      for (int s = 0; s < L; ++s) acc += sk[s * QS + d];
      sn[d] = acc;
    }
    {
      const int e4 = tid & 15, dg = tid >> 4;
      for (int d0 = 4 * dg; d0 < D; d0 += 64) {
        float4 acc[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[u] = *reinterpret_cast<const float4*>(sC + (d0 + u) * DV + 4 * e4);
          acc[u].x *= ssc; acc[u].y *= ssc; acc[u].z *= ssc; acc[u].w *= ssc;
        }
        for (int s = 0; s < L; ++s) {
          const float4 kk = *reinterpret_cast<const float4*>(sk + s * QS + d0);
          const float4 vv =
              *reinterpret_cast<const float4*>(sv + s * DV + 4 * e4);
          fma4(acc[0], kk.x, vv); fma4(acc[1], kk.y, vv);
          fma4(acc[2], kk.z, vv); fma4(acc[3], kk.w, vv);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          *reinterpret_cast<float4*>(sC + (d0 + u) * DV + 4 * e4) = acc[u];
      }
    }
    __syncthreads();
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) *
         ((size_t)2 * L * (D + 4) + (size_t)D * DV + (size_t)L * DV +
          (size_t)L * (L + 1) + D + 6 * L);
}

}  // namespace

extern "C" {

// Largest head dim whose tiles fit in one CTA's shared memory.
int mlstm_scan_max_d(void) {
  int d = 0;
  while (smem_bytes(d + DV) <= 232448) d += DV;
  return d;
}

int mlstm_scan_chunk(void) { return L; }

int mlstm_scan_fwd(const float* q, const float* k, const float* v,
                   const float* ig, const float* fg, float* h, int B, int H,
                   int S, int D, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(D / DV, H, B);
  mlstm_scan_kernel<<<grid, NT, smem, stream>>>(q, k, v, ig, fg, h, S, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
