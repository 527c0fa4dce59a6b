// Chunkwise mLSTM forward from zero state, fp32, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/mlstm_scan.py
// (mlstm_scan -> _mlstm_kernel). Same function: for each (batch, head) walk
// the sequence in chunks, carrying the matrix memory C (D x D), the
// normaliser n (D) and the running max m; inside a chunk the output is the
// attention-like form  h = ((QK^T * exp(D - m_row)) V + (Q C) exp(b + m_prev
// - m_row)) / max(|n_t|, exp(-m_row)),  q scaled by D^-0.5. The function
// does not depend on the chunk size beyond rounding.
//
// What bounds it: fp32 FMA work, about D*(L + D) FMAs a row for the four
// products (QK^T L*D, Q*C D*D, W*V L*D, K^T V D*D), against one read of q,
// k, v and one write of h. All arithmetic is plain fp32 FMA with operands
// from shared memory; no tensor cores. On this card shared memory serves 32
// lanes x 4 bytes a cycle however the addresses repeat (a float4 load of a
// warp takes 4 cycles even when all lanes read one address), and an SM
// issues 128 FMAs a cycle. So a product runs at the FMA rate only when each
// thread does at least 4 FMAs per float it loads: register tiles of 12 x 6
// and 8 x 6 below, 4 x 4 in the small score product.
//
// Geometry: one CTA owns a D x DV column tile of C and walks the whole
// sequence; the grid is (D/DV, H, B). DV (32, 64 or 96) and D are template
// parameters; the host (mlstm_scan.geometry) picks DV: the narrowest tile
// whose grid is resident in one wave. At B=8, H=4, D=384 that is DV=96: 4
// CTAs a (b, h), 128 CTAs, one wave on 132 SMs, each CTA doing 167.5 M
// FMAs. Each CTA recomputes the chunk's gates, scores and denominators (its
// share of the QK^T work is L*D FMAs a row against 2*D*DV for its tile).
//
// Shared memory at L = 16, D = 384, DV = 96 (231,104 B of the 232,448 B a
// block may take, so one CTA per SM):
//   C tile with the chunk's v tile as 16 more rows  (D+16) x DV  153,600 B
//   q, then the decayed scores W, per row           16 x (D+20)   25,856 B
//   two regions that take turns: k of the chunk,
//     and the partial sums, then the next chunk's k  2 x 16 x (D+4) 49,664 B
//   n and the per-row gate terms                                   1,984 B
// Padded rows keep the loads below free of bank conflicts.
//
// The next chunk in flight: no second q/k buffer fits beside the C tile,
// so q and k of chunk c+1 are copied by cp.async straight into shared
// memory as soon as their space is free within chunk c: q into the q rows
// once the readout has read them, k into the region that held chunk c's
// partial sums once they are summed. Both copies run under the state
// update, the last third of the chunk, and are awaited at the top of chunk
// c+1. The v tile and the gates of chunk c+1 (5 floats a thread) are loaded
// into registers at the top of chunk c.
//
// One chunk, on 512 threads, in phases ended by barriers:
//   0. store the staged v tile and load the next; warp 0 runs the gate
//      scans over the 16 rows; wait for the copies of q and k.
//   1. scores QK^T on 8 warps: 16 K-slices x 16 tiles of 4x4; q_t . n_prev
//      on the other 8, two rows a warp.
//   2. W = scores * decay (0 above the diagonal), written beside q; the
//      denominators; q scaled by D^-0.5 and the inter-chunk factor; k
//      scaled by its contribution and n updated.
//   3. the readout [q*inter | W] x [C_prev ; V], one product with K = D+16
//      over 16 K-slices, one a warp, each thread 8 rows x DV/16 columns;
//      the 16 slices are summed into 4 partial tiles, four warps a round.
//   4. h = (sum of the 4 tiles) / denominator; start copying the next q.
//   5. start copying the next k; the state update C = state_sc C +
//      (k*contrib)^T V in place, each half-warp D/32 consecutive rows of C
//      and each thread DV/16 columns of them: 12 x 6 at D=384, DV=96.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int L = 16;           // rows per chunk
constexpr int NT = 512;         // threads per CTA
constexpr int NW = NT / 32;     // warps
constexpr int MAX_D = 512;      // head dims 64, 128, ... MAX_D are built
constexpr int QK_SLICES = 16;   // K-slices of the score product
constexpr int RO_SLOTS = 4;     // partial tiles the readout's slices sum into
constexpr int SMEM_LIMIT = 232448;
static_assert(NW == 16, "the readout takes one K-slice a warp, 16 in all");

// Built with -DMLSTM_PHASE_CLOCKS (scripts/mlstm_phases.py), thread 0 of
// each CTA adds up the clock cycles from one barrier to the next for each
// of the phases of a chunk (the readout's summing rounds as their own);
// mlstm_scan_phase_cycles reads the sums.
constexpr int N_PHASES = 7;
#ifdef MLSTM_PHASE_CLOCKS
__device__ unsigned long long phase_cycles[N_PHASES];
#define PHASE_END(i)                                   \
  if (tid == 0) {                                      \
    const long long now = clock64();                   \
    clocks[i] += now - last_clock;                     \
    last_clock = now;                                  \
  }
#else
#define PHASE_END(i)
#endif

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Floats of each of the two regions that hold k and the partial sums.
__host__ __device__ constexpr int region_floats(int d, int dv) {
  return cmax(L * (d + 4), cmax(RO_SLOTS * L * dv, QK_SLICES * L * L));
}

__host__ __device__ constexpr size_t smem_floats(int d, int dv) {
  return (size_t)(d + L) * dv + (size_t)L * (d + L + 4) +
         2 * (size_t)region_floats(d, dv) + d + 7 * L;
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void st4(float* p, const float4& a) {
  *reinterpret_cast<float4*>(p) = a;
}

__device__ __forceinline__ void scale4(float4& a, float s) {
  a.x *= s; a.y *= s; a.z *= s; a.w *= s;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// N consecutive floats of a row: one thread's columns, as 16- or 8-byte
// accesses, so that the 16 threads of a half-warp read a row without bank
// conflicts.
template <int N>
__device__ __forceinline__ void ld_cols(const float* p, float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 a = ld4(p + i);
      x[i] = a.x; x[i + 1] = a.y; x[i + 2] = a.z; x[i + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 a = ld2(p + i);
      x[i] = a.x; x[i + 1] = a.y;
    }
  }
}

template <int N>
__device__ __forceinline__ void st_cols(float* p, const float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      st4(p + i, make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]));
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 2)
      *reinterpret_cast<float2*>(p + i) = make_float2(x[i], x[i + 1]);
  }
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int DV, int D>
__global__ void __launch_bounds__(NT, 1)
mlstm_scan_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ ig,
                  const float* __restrict__ fg, float* __restrict__ h,
                  int S) {
  constexpr int EPT = DV / 16;       // columns a thread owns (phases 3, 5)
  constexpr int RPH = D / 32;        // rows of C a half-warp updates (even)
  constexpr int D4 = D / 4;
  constexpr int QS = D + L + 4;      // row stride of sq: q, then W
  constexpr int KS = D + 4;          // row stride of k
  constexpr int RS = region_floats(D, DV);
  constexpr int K2 = (D + L) / 2;    // depth of the readout, in pairs
  static_assert(EPT == 2 || EPT == 4 || EPT == 6, "DV is 32, 64 or 96");
  static_assert(D % 64 == 0 && D <= MAX_D && D % DV == 0, "head dim");
  static_assert(L * DV / 4 <= NT, "one float4 of v a thread");

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int half = lane >> 4;
  const int ec = (lane & 15) * EPT;  // first column a thread owns
  const int e0 = blockIdx.x * DV;
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const float* qb = q + bh * S * D;
  const float* kb = k + bh * S * D;
  const float* vb = v + bh * S * D;
  const float* ib = ig + bh * S;
  const float* fb = fg + bh * S;
  float* hb = h + bh * S * D;
  const float scale = rsqrtf((float)D);

  extern __shared__ float4 smem4[];
  float* sC = reinterpret_cast<float*>(smem4);  // D x DV, C[:, e0:e0+DV]
  float* sV = sC + D * DV;                      // L x DV, right below C
  float* sq = sV + L * DV;                      // L x QS
  float* sR = sq + L * QS;                      // 2 x RS: k, partial sums
  float* sn = sR + 2 * RS;                      // D, normaliser n
  float* sb = sn + D;                           // L, cumulative log f
  float* si = sb + L;                           // L, input gate
  float* sm = si + L;                           // L, row stabiliser m_row
  float* sx = sm + L;                           // L, inter-chunk scale
  float* sc = sx + L;                           // L, state contribution
  float* sr = sc + L;                           // L, 1 / denominator
  float* sqn = sr + L;                          // L, q_t . n_prev
  __shared__ float s_state_sc;

  for (int idx = tid; idx < D * DV; idx += NT) sC[idx] = 0.f;
  for (int idx = tid; idx < D; idx += NT) sn[idx] = 0.f;
  float m_prev = 0.f;  // kept by warp 0 only
#ifdef MLSTM_PHASE_CLOCKS
  long long clocks[N_PHASES] = {};
  long long last_clock = clock64();
#endif

  // q and k of the chunk at c0, copied into their padded rows
  auto copy_q = [&](int c0) {
    const float* src = qb + (size_t)c0 * D;
    for (int idx = tid; idx < L * D4; idx += NT) {
      const int r = idx / D4, c = idx - r * D4;
      cp_async16(sq + r * QS + 4 * c, src + 4 * idx);
    }
  };
  auto copy_k = [&](int c0, float* dst) {
    const float* src = kb + (size_t)c0 * D;
    for (int idx = tid; idx < L * D4; idx += NT) {
      const int r = idx / D4, c = idx - r * D4;
      cp_async16(dst + r * KS + 4 * c, src + 4 * idx);
    }
  };
  // the v tile and the gates of the chunk at c0, staged in registers
  float4 rv = make_float4(0.f, 0.f, 0.f, 0.f);
  float rg = 0.f;
  auto fetch = [&](int c0) {
    if (tid < L * DV / 4) {
      const int r = tid / (DV / 4), c = tid - r * (DV / 4);
      rv = __ldg(reinterpret_cast<const float4*>(
                     vb + (size_t)(c0 + r) * D + e0) + c);
    }
    if (tid < 2 * L) rg = __ldg((tid < L ? ib : fb) + c0 + (tid & (L - 1)));
  };
  copy_q(0);
  copy_k(0, sR);
  cp_async_commit();
  fetch(0);

  for (int c0 = 0; c0 < S; c0 += L) {
    float* sk = sR + ((c0 / L) & 1) * RS;        // k of this chunk
    float* sP = sR + (((c0 / L) & 1) ^ 1) * RS;  // partials, then next k

    // -- 0. v tile, gate scans, wait for q and k --------------------------
    if (tid < L * DV / 4) {
      const int r = tid / (DV / 4), c = tid - r * (DV / 4);
      st4(sV + r * DV + 4 * c, rv);
    }
    const float g = rg;
    if (c0 + L < S) fetch(c0 + L);
    if (warp == 0) {
      // lanes 0..15 hold i, lanes 16..31 f; both halves run the same scans
      // over 16-lane segments and the low half writes the results
      const float other = __shfl_xor_sync(0xffffffffu, g, 16);
      const float it = lane < L ? g : other;
      const int row = lane & (L - 1);
      float b = log_sigmoid(lane < L ? other : g);
      for (int off = 1; off < L; off <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, b, off, L);
        if (row >= off) b += y;
      }
      // max_{s<=t} (b_t - b_s + i_s) = b_t + prefix max of (i_s - b_s)
      float a = it - b;
      for (int off = 1; off < L; off <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, a, off, L);
        if (row >= off) a = fmaxf(a, y);
      }
      const float b_tot = __shfl_sync(0xffffffffu, b, L - 1, L);
      const float a_all = __shfl_sync(0xffffffffu, a, L - 1, L);
      const float inter_log = b + m_prev;
      const float m_row = fmaxf(fmaxf(b + a, inter_log), 0.f);
      const float m_new = fmaxf(b_tot + m_prev, b_tot + a_all);
      if (lane < L) {
        sb[lane] = b;
        si[lane] = it;
        sm[lane] = m_row;
        sx[lane] = expf(inter_log - m_row);
        sc[lane] = expf(b_tot - b + it - m_new);
      }
      if (lane == 0) s_state_sc = expf(b_tot + m_prev - m_new);
      m_prev = m_new;
    }
    cp_async_wait_all();
    __syncthreads();
    PHASE_END(0)

    // -- 1. score partials QK^T (raw q); q_t . n_prev ---------------------
    if (warp < 8) {
      const int ks = 2 * warp + half;          // 16 slices of D
      const int tg = (lane >> 2) & 3;          // rows tg + 4i
      const int sg = lane & 3;                 // cols sg + 4j
      constexpr int span = D4 / QK_SLICES;
      float acc[4][4] = {};
      for (int c4 = ks * span; c4 < (ks + 1) * span; ++c4) {
        float4 x[4], y[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = ld4(sq + (tg + 4 * i) * QS + 4 * c4);
#pragma unroll
        for (int j = 0; j < 4; ++j) y[j] = ld4(sk + (sg + 4 * j) * KS + 4 * c4);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = dot4(x[i], y[j], acc[i][j]);
      }
      float* p = sP + ks * L * L;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) p[(tg + 4 * i) * L + sg + 4 * j] = acc[i][j];
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int t = 2 * (warp - 8) + j;
        float nd = 0.f;
        for (int d = lane; d < D; d += 32) nd = fmaf(sq[t * QS + d], sn[d], nd);
        for (int off = 16; off > 0; off >>= 1)
          nd += __shfl_xor_sync(0xffffffffu, nd, off);
        if (lane == 0) sqn[t] = nd * scale;
      }
    }
    __syncthreads();
    PHASE_END(1)

    // -- 2. W beside q, denominators, q * scale * inter, k * contrib, n ---
    const float ssc = s_state_sc;
    if (tid < L * L) {
      const int t = tid >> 4, s = tid & (L - 1);
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < QK_SLICES; ++j) dot += sP[j * L * L + tid];
      const float w =
          s <= t ? dot * scale * expf(sb[t] - sb[s] + si[s] - sm[t]) : 0.f;
      sq[t * QS + D + s] = w;
      float rs = w;
      for (int off = L / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      if (s == 0)
        sr[t] = 1.f / fmaxf(fabsf(sqn[t] * sx[t] + rs), expf(-sm[t]));
    }
    for (int idx = tid; idx < L * D4; idx += NT) {
      const int r = idx / D4, c = idx - r * D4;
      float4 a = ld4(sq + r * QS + 4 * c);
      scale4(a, sx[r] * scale);
      st4(sq + r * QS + 4 * c, a);
    }
    for (int d = tid; d < D; d += NT) {
      float acc = ssc * sn[d];
#pragma unroll
      for (int s = 0; s < L; ++s) {
        const float kw = sk[s * KS + d] * sc[s];
        sk[s * KS + d] = kw;
        acc += kw;
      }
      sn[d] = acc;
    }
    __syncthreads();
    PHASE_END(2)

    // -- 3. readout [q*inter | W] x [C_prev ; V], one K-slice a warp ------
    {
      const float* arow = sq + 8 * half * QS;    // rows 8*half + i
      const int lo = warp * K2 / NW, hi = (warp + 1) * K2 / NW;
      float acc[8][EPT] = {};
      for (int c2 = lo; c2 < hi; ++c2) {
        float2 x[8];
        float y0[EPT], y1[EPT];
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = ld2(arow + i * QS + 2 * c2);
        ld_cols(sC + (2 * c2) * DV + ec, y0);
        ld_cols(sC + (2 * c2 + 1) * DV + ec, y1);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < EPT; ++c) {
            acc[i][c] = fmaf(x[i].x, y0[c], acc[i][c]);
            acc[i][c] = fmaf(x[i].y, y1[c], acc[i][c]);
          }
      }
      // the 16 slices summed into RO_SLOTS tiles, RO_SLOTS warps a round
      float* slot = sP + (warp % RO_SLOTS) * L * DV + 8 * half * DV + ec;
#pragma unroll 1
      for (int rnd = 0; rnd < NW / RO_SLOTS; ++rnd) {
        if (warp / RO_SLOTS == rnd) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (rnd > 0) {
              float o[EPT];
              ld_cols(slot + i * DV, o);
#pragma unroll
              for (int c = 0; c < EPT; ++c) acc[i][c] += o[c];
            }
            st_cols(slot + i * DV, acc[i]);
          }
        }
        __syncthreads();
        if (rnd == 0) { PHASE_END(3) }
      }
    }
    PHASE_END(4)

    // -- 4. h = sum of the tiles / denominator; copy the next q -----------
    for (int idx = tid; idx < L * DV / 4; idx += NT) {
      const int t = idx / (DV / 4), c = idx - t * (DV / 4);
      float4 o = ld4(sP + t * DV + 4 * c);
#pragma unroll
      for (int j = 1; j < RO_SLOTS; ++j) {
        const float4 p = ld4(sP + (j * L + t) * DV + 4 * c);
        o.x += p.x; o.y += p.y; o.z += p.z; o.w += p.w;
      }
      scale4(o, sr[t]);
      st4(hb + (size_t)(c0 + t) * D + e0 + 4 * c, o);
    }
    if (c0 + L < S) copy_q(c0 + L);
    __syncthreads();
    PHASE_END(5)

    // -- 5. copy the next k; C = ssc C + kw^T V ----------------------------
    if (c0 + L < S) copy_k(c0 + L, sP);
    cp_async_commit();
    {
      float* crow = sC + (2 * warp + half) * RPH * DV + ec;
      const float* krow = sk + (2 * warp + half) * RPH;
      float acc[RPH][EPT];
#pragma unroll
      for (int r = 0; r < RPH; ++r) {
        ld_cols(crow + r * DV, acc[r]);
#pragma unroll
        for (int c = 0; c < EPT; ++c) acc[r][c] *= ssc;
      }
#pragma unroll 2
      for (int s = 0; s < L; ++s) {
        float vv[EPT];
        ld_cols(sV + s * DV + ec, vv);
        float kk[RPH];
        ld_cols(krow + s * KS, kk);
#pragma unroll
        for (int r = 0; r < RPH; ++r)
#pragma unroll
          for (int c = 0; c < EPT; ++c) acc[r][c] = fmaf(kk[r], vv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < RPH; ++r) st_cols(crow + r * DV, acc[r]);
    }
    __syncthreads();
    PHASE_END(6)
  }
#ifdef MLSTM_PHASE_CLOCKS
  if (tid == 0)
    for (int i = 0; i < N_PHASES; ++i)
      atomicAdd(&phase_cycles[i], (unsigned long long)clocks[i]);
#endif
}

constexpr bool fits(int d, int dv) {
  return d % dv == 0 && sizeof(float) * smem_floats(d, dv) <= SMEM_LIMIT;
}

bool takes(int d, int dv) {
  return (dv == 32 || dv == 64 || dv == 96) && d >= 64 && d % 64 == 0 &&
         d <= MAX_D && fits(d, dv);
}

template <int V>
using Int = std::integral_constant<int, V>;

// Calls f(Int<DV>, Int<D>) for the built instance; takes(D, DV) holds.
template <typename F>
int dispatch(int D, int DV, F&& f) {
  auto by_d = [&](auto dv) {
    switch (D) {
      case 64: return f(dv, Int<64>{});
      case 128: return f(dv, Int<128>{});
      case 192: return f(dv, Int<192>{});
      case 256: return f(dv, Int<256>{});
      case 320: return f(dv, Int<320>{});
      case 384: return f(dv, Int<384>{});
      case 448: return f(dv, Int<448>{});
      default: return f(dv, Int<512>{});
    }
  };
  switch (DV) {
    case 32: return by_d(Int<32>{});
    case 64: return by_d(Int<64>{});
    default: return by_d(Int<96>{});
  }
}

// Sets the shared memory of the (DV, D) instance; false where the pair is
// not built or the attribute is refused.
template <int DV, int D>
bool prepare(size_t* smem) {
  if constexpr (!fits(D, DV)) {
    return false;
  } else {
    *smem = sizeof(float) * smem_floats(D, DV);
    return cudaFuncSetAttribute(mlstm_scan_kernel<DV, D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)*smem) == cudaSuccess;
  }
}

template <int DV, int D>
int max_active() {
  if constexpr (!fits(D, DV)) {
    return -(int)cudaErrorInvalidValue;
  } else {
    size_t smem = 0;
    if (!prepare<DV, D>(&smem)) return -(int)cudaGetLastError();
    int n = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, mlstm_scan_kernel<DV, D>, NT, smem);
    return err == cudaSuccess ? n : -(int)err;
  }
}

template <int DV, int D>
int launch(const float* q, const float* k, const float* v, const float* ig,
           const float* fg, float* h, int B, int H, int S,
           cudaStream_t stream) {
  if constexpr (!fits(D, DV)) {
    return (int)cudaErrorInvalidValue;
  } else {
    size_t smem = 0;
    if (!prepare<DV, D>(&smem)) return (int)cudaGetLastError();
    dim3 grid(D / DV, H, B);
    mlstm_scan_kernel<DV, D><<<grid, NT, smem, stream>>>(q, k, v, ig, fg, h,
                                                         S);
    return (int)cudaGetLastError();
  }
}

}  // namespace

extern "C" {

int mlstm_scan_chunk(void) { return L; }

int mlstm_scan_threads(void) { return NT; }

// Shared memory of one CTA at head dim d and column tile dv.
int mlstm_scan_smem_bytes(int d, int dv) {
  return (int)(sizeof(float) * smem_floats(d, dv));
}

// Largest head dim that some column tile takes.
int mlstm_scan_max_d(void) {
  int d = 0;
  while (takes(d + 64, 32)) d += 64;
  return d;
}

// Resident CTAs per SM at (d, dv), or minus a CUDA error.
int mlstm_scan_max_active(int d, int dv) {
  if (!takes(d, dv)) return -(int)cudaErrorInvalidValue;
  return dispatch(d, dv, [](auto tile, auto dim) {
    return max_active<decltype(tile)::value, decltype(dim)::value>();
  });
}

int mlstm_scan_fwd(const float* q, const float* k, const float* v,
                   const float* ig, const float* fg, float* h, int B, int H,
                   int S, int D, int DV, cudaStream_t stream) {
  if (!takes(D, DV) || S % L) return (int)cudaErrorInvalidValue;
  return dispatch(D, DV, [&](auto tile, auto dim) {
    return launch<decltype(tile)::value, decltype(dim)::value>(
        q, k, v, ig, fg, h, B, H, S, stream);
  });
}

#ifdef MLSTM_PHASE_CLOCKS
// Copies the phase sums (cycles, over all CTAs) to host memory and zeroes
// them.
int mlstm_scan_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, phase_cycles,
                                         sizeof(phase_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[N_PHASES] = {};
  return (int)cudaMemcpyToSymbol(phase_cycles, zero, sizeof(zero));
}
#endif

}  // extern "C"
