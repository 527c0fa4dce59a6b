// Single-token decode attention over a KV cache, split along the cache
// (flash-decoding), for sm_90a. q is fp32 or bf16 and the output takes its
// type; the cache is fp32 or bf16, whatever q's type.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention -> _dec_kernel). Same function: for each batch row b
// and query head h (reading KV head h / G), softmax(q k^T / sqrt(D)) v over
// the cache positions s < lengths[b]; a row of length 0 gives zeros.
//
// What bounds it here: bytes. Each valid cache position brings a K and a V
// row (2 D elements) for 4 G D flops: G / 2 = 8 flop/B at RecurrentGemma's
// G = 16 with an fp32 cache, below the card's fp32 SIMT ridge of 20 flop/B,
// so tensor cores would buy nothing. The time to beat is the valid rows
// crossing HBM once, and the design keeps as many of them in flight as the
// card takes while doing the arithmetic from shared memory:
//  - a grid fixed on the host: one CTA of 256 threads per chunk of CH = 32
//    cache positions of one (kv head, batch row), (ceil(S / CH), KV, B)
//    CTAs (256 at B = 4, S = 2048, 2 a SM by shared memory, one wave). The
//    lengths stay on the device: a CTA whose chunk starts at or past its
//    row's length exits at once and writes nothing, so the launch needs no
//    host read and replays in a CUDA graph with new lengths;
//  - at entry each CTA issues cp.async copies of all its valid K rows, then
//    all its V rows (two commit groups; 64 KB in fp32), so the launch's
//    whole cache is requested in its first microsecond with no ring of
//    stages. Rows past the length are never copied. fp32 rows are 16-byte
//    copies (the wrapper's strides and bases make every fp32 row 16-byte
//    aligned, and the kernel refuses one that is not); bf16 rows are
//    16-byte copies where D, the strides and the bases allow, 8-byte ones
//    otherwise (D = 4 mod 8), chosen per launch;
//  - scores start when K has landed, while V still arrives. They are a
//    G x CH product over D done as register tiles: a thread owns 4 heads x
//    4 positions (heads gt + 4j, positions pt + 8i, so the lanes of a warp
//    read 8 distinct K rows and 4 distinct q rows, each row padded by 16 B
//    to fall on other banks) over one warp's slice of D; the 8 slices are
//    summed in shared memory once per CTA, with no warp reduction per
//    (position, head);
//  - the chunk's softmax per head, a warp per head with a lane per
//    position (CH = 32; a warp's two heads side by side), writes P as
//    [position][head];
//  - P V as register tiles: a thread owns 4 heads x 4 columns, and each
//    position costs one 16-byte load of V and one broadcast load of P for
//    16 FMAs;
//  - each working CTA writes its partial (max, sum, accumulator) per head;
//    a second kernel, one CTA per (h, b, CC = 64 columns), reads only that
//    row's ceil(min(len, S) / CH) blocks, all in flight at once, and merges
//    them as they come (a running max), zeros where there are none.
// bf16 caches take the same path: the bytes are copied as they are and
// widened to fp32 in registers. q is read once per CTA, widened to fp32,
// scaled by 1/sqrt(D), and kept in shared memory; the partials are fp32
// and the combine rounds its fp32 result to bf16 (to nearest even) for a
// bf16 q, so a bf16 q gives bit for bit the fp32 kernel's result on the
// widened q, rounded.
// What holds it above the byte bound (PERF.md): a fixed chain of two
// launches and their round trips to memory, the shared-memory loads of the
// register tiles (2 B a FMA, twice the FMA time), and the SMs that hold
// two working CTAs when a launch has a few more chunks than SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CH = 32;       // cache positions per CTA, a lane each
constexpr int NT = 256;      // threads per CTA
constexpr int NW = NT / 32;  // warps, one slice of D each in the scores
constexpr int MAXG = 16;     // query heads per KV head (2 a warp)
constexpr int MAXD = 256;    // head dim
constexpr int PAD = 16;      // bytes after each shared K, V and q row
constexpr int RP = CH + 8;   // row pitch of the score slices (floats)
constexpr int CC = 64;       // columns a combine CTA
static_assert(MAXG <= 2 * NW, "the softmax takes two heads a warp");

struct Cache {
  long long b, s, kv;  // element strides; the head dim is contiguous
};

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// Byte offsets of the split kernel's dynamic shared memory: the chunk's K
// and V rows (as stored, pitch D el + PAD), q (fp32, G rows of D + 4), the
// score slices [warp][head][position] (rows of RP) and P [position][head]
// (rows of round4(G) + 4). The pads put the lanes of one store or load on
// distinct banks.
struct Layout {
  int pitch, k, v, q, red, p, total;
};

__host__ __device__ constexpr Layout layout(int G, int D, int el) {
  const int pitch = D * el + PAD;
  const int v = CH * pitch, q = 2 * CH * pitch;
  const int red = q + G * (4 * D + PAD);
  const int p = red + 4 * NW * G * RP;
  return Layout{pitch, 0, v, q, red, p, p + 4 * CH * (round4(G) + 4)};
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
                 "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows 0..n-1 of a chunk, `stride` elements apart in the cache, into
// shared rows `pitch` bytes apart, in BYTES-sized copies spread over the
// CTA.
template <typename T, int BYTES>
__device__ __forceinline__ void copy_rows(char* dst, int pitch, const T* src,
                                          long long stride, int n, int D) {
  const int per_row = D * (int)sizeof(T) / BYTES;
  for (int i = threadIdx.x; i < n * per_row; i += NT) {
    const int r = i / per_row, c = i - r * per_row;
    cp_async<BYTES>(dst + r * pitch + c * BYTES,
                    reinterpret_cast<const char*>(src + r * stride) +
                        c * BYTES);
  }
}

// Four consecutive elements of a shared row, widened to fp32.
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

__device__ __forceinline__ float to_float(float x) { return x; }

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);

template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// Partial results of block `blk` for head h = kv G + g of row b: m, l at
// (b H + h) NS + blk, the accumulator's D values at that index times D.
// Only blocks with a valid position are written.
template <typename TQ, typename T, int BYTES>
__global__ void __launch_bounds__(NT, 2)
    decode_split_kernel(const TQ* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths,
                        float* __restrict__ m_part,
                        float* __restrict__ l_part,
                        float* __restrict__ acc_part, Cache sk, Cache sv,
                        int H, int KV, int S, int D, float scale) {
  extern __shared__ __align__(16) char smem[];
  const int blk = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int len = max(0, min(lengths[b], S));
  const int s0 = blk * CH;
  if (s0 >= len) return;  // nothing of this row here: no read, no write
  const int n = min(CH, len - s0);
  const int NS = gridDim.x, G = H / KV, GP = round4(G), PP = GP + 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Layout L = layout(G, D, (int)sizeof(T));
  const int pitch = L.pitch / (int)sizeof(T);  // in elements
  const T* k_s = reinterpret_cast<const T*>(smem + L.k);
  const T* v_s = reinterpret_cast<const T*>(smem + L.v);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* p_s = reinterpret_cast<float*>(smem + L.p);
  const int qp = D + PAD / 4;

  // 1. every valid K row of the chunk, then every V row, in flight at once
  copy_rows<T, BYTES>(smem + L.k, L.pitch,
                      k + b * sk.b + (long long)s0 * sk.s + kvh * sk.kv,
                      sk.s, n, D);
  cp_async_commit();
  copy_rows<T, BYTES>(smem + L.v, L.pitch,
                      v + b * sv.b + (long long)s0 * sv.s + kvh * sv.kv,
                      sv.s, n, D);
  cp_async_commit();

  // 2. the G query rows of this KV head, scaled, while the copies run
  const TQ* qb = q + ((size_t)b * H + (size_t)kvh * G) * D;
  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D;
    q_s[g * qp + (i - g * D)] = to_float(qb[i]) * scale;
  }
  cp_async_wait<1>();  // this thread's K copies
  __syncthreads();     // everyone's, and q

  // 3. scores: heads gt + 4j x positions pt + 8i a lane, over the float4
  // columns warp, warp + NW, ... of D; rows past n hold stale bytes and
  // are masked below
  {
    const int gt = lane >> 3, pt = lane & 7;
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    for (int c = 4 * warp; c < D; c += 4 * NW) {
      float4 kr[4], qr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) kr[i] = load4(k_s + (pt + 8 * i) * pitch + c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        qr[j] = gt + 4 * j < G ? load4(q_s + (gt + 4 * j) * qp + c)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] += dot4(qr[j], kr[i]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (gt + 4 * j < G)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          red[(warp * G + gt + 4 * j) * RP + pt + 8 * i] = acc[j][i];
  }
  __syncthreads();

  // 4. the chunk's softmax, a warp per head and a lane per position; a
  // warp's two heads (G > 8) side by side, so their chains overlap
  {
    float s[2], mx[2], l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int g = warp + NW * r;
      s[r] = 0.f;
      if (g < G) {
#pragma unroll
        for (int w = 0; w < NW; ++w) s[r] += red[(w * G + g) * RP + lane];
      }
      s[r] = g < G && lane < n ? s[r] : -INFINITY;
      mx[r] = s[r];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], o));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = s[r] == -INFINITY ? 0.f : expf(s[r] - mx[r]);
      const int g = warp + NW * r;
      if (g < GP) p_s[lane * PP + g] = l[r];  // 0 for padding heads
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int g = warp + NW * r;
      if (g < G && lane == 0) {
        const size_t part = ((size_t)b * H + (size_t)kvh * G + g) * NS + blk;
        m_part[part] = mx[r];
        l_part[part] = l[r];
      }
    }
  }
  cp_async_wait<0>();  // this thread's V copies
  __syncthreads();     // everyone's, and P

  // 5. P V: heads 4 hg .. 4 hg + 3 x columns c .. c + 3 a thread
  const int ncol = D / 4, tiles = (GP / 4) * ncol;
  for (int t = tid; t < tiles; t += NT) {
    const int hg = t / ncol, c = 4 * (t - hg * ncol);
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll 4
    for (int p = 0; p < n; ++p) {
      const float4 pr =
          *reinterpret_cast<const float4*>(p_s + p * PP + 4 * hg);
      const float4 vr = load4(v_s + p * pitch + c);
      const float pj[4] = {pr.x, pr.y, pr.z, pr.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[j][0] += pj[j] * vr.x;
        acc[j][1] += pj[j] * vr.y;
        acc[j][2] += pj[j] * vr.z;
        acc[j][3] += pj[j] * vr.w;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int g = 4 * hg + j;
      if (g < G) {
        const size_t part = ((size_t)b * H + (size_t)kvh * G + g) * NS + blk;
        *reinterpret_cast<float4*>(acc_part + part * D + c) =
            make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
      }
    }
  }
}

// One CTA per (h, b, CC columns): out[b, h] = sum_j w_j acc_j /
// sum_j w_j l_j with w_j = e^(m_j - max m) over the row's blocks j that
// the split wrote; zeros for a row of length 0. Thread t takes columns
// c .. c + 3, c = 4 (t mod CC/4), of the blocks j = t div CC/4 (mod NT div
// CC/4), merged as it reads them (a running max, its sum and
// accumulator), so that all of a row's partial loads are in flight at once
// and no pass waits on another; the groups' results meet in shared memory.
// out is in q's type TO.
template <typename TO>
__global__ void __launch_bounds__(NT)
    decode_combine_kernel(const float* __restrict__ m_part,
                          const float* __restrict__ l_part,
                          const float* __restrict__ acc_part,
                          const int* __restrict__ lengths,
                          TO* __restrict__ out, int H, int S, int NS,
                          int D) {
  constexpr int NCOL = CC / 4, NGROUPS = NT / NCOL;
  __shared__ __align__(16) float acc_s[NGROUPS * CC];
  __shared__ float m_s[NGROUPS], l_s[NGROUPS];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int nb = (max(0, min(lengths[b], S)) + CH - 1) / CH;
  const int c0 = blockIdx.z * CC;
  const int c = 4 * (tid % NCOL), grp = tid / NCOL;
  const size_t part0 = ((size_t)b * H + h) * NS;
  TO* o = out + ((size_t)b * H + h) * D + c0;
  const int ncols = min(CC, D - c0);
  if (nb == 0) {
    if (tid < ncols) o[tid] = from_float<TO>(0.f);
    return;
  }
  float m = -INFINITY, l = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c < ncols) {
#pragma unroll 4
    for (int j = grp; j < nb; j += NGROUPS) {
      const float mj = m_part[part0 + j], lj = l_part[part0 + j];
      const float4 x = *reinterpret_cast<const float4*>(
          acc_part + (part0 + j) * D + c0 + c);
      const float mn = fmaxf(m, mj);
      const float so = expf(m - mn), sn = expf(mj - mn);
      l = l * so + lj * sn;
      a = make_float4(a.x * so + x.x * sn, a.y * so + x.y * sn,
                      a.z * so + x.z * sn, a.w * so + x.w * sn);
      m = mn;
    }
  }
  *reinterpret_cast<float4*>(acc_s + grp * CC + c) = a;
  if (c == 0) {
    m_s[grp] = m;
    l_s[grp] = l;
  }
  __syncthreads();
  if (tid < ncols) {
    float mx = -INFINITY;  // group 0 holds block 0, so mx is finite
    for (int g = 0; g < NGROUPS; ++g) mx = fmaxf(mx, m_s[g]);
    float num = 0.f, den = 0.f;
    for (int g = 0; g < NGROUPS; ++g) {
      const float w = expf(m_s[g] - mx);  // 0 for a group without blocks
      num += acc_s[g * CC + tid] * w;
      den += l_s[g] * w;
    }
    o[tid] = from_float<TO>(num / den);
  }
}

// Lets each instance take its largest layout's shared memory, once a
// device.
template <typename TQ, typename T, int BYTES>
cudaError_t prepare() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(decode_split_kernel<TQ, T, BYTES>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             layout(MAXG, MAXD, (int)sizeof(T)).total);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <typename TQ, typename T, int BYTES>
int max_active(int smem) {
  cudaError_t err = prepare<TQ, T, BYTES>();
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, decode_split_kernel<TQ, T, BYTES>, NT, smem);
  return err == cudaSuccess ? n : -(int)err;
}

template <typename TQ>
int max_active(int smem, bool bf16, bool vec16) {
  if (bf16) return vec16 ? max_active<TQ, __nv_bfloat16, 16>(smem)
                         : max_active<TQ, __nv_bfloat16, 8>(smem);
  return max_active<TQ, float, 16>(smem);
}

// One launch: split CTAs along S, KV and B; threads; shared bytes; copy
// bytes; combine CTAs.
struct Plan {
  int ctas_x, ctas_y, ctas_z, threads, smem, copy_bytes, combine_ctas;
};

// fp32 rows always take the 16-byte copies.
Plan plan(int B, int H, int KV, int S, int D, bool bf16, bool vec16) {
  return Plan{(S + CH - 1) / CH, KV, B, NT,
              layout(H / KV, D, bf16 ? 2 : 4).total,
              vec16 || !bf16 ? 16 : 8,
              H * B * ((D + CC - 1) / CC)};
}

Plan last_launch = {};

void put_plan(const Plan& p, int* out) {
  const int v[7] = {p.ctas_x,  p.ctas_y,     p.ctas_z,      p.threads,
                    p.smem,    p.copy_bytes, p.combine_ctas};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (uintptr_t)(bytes - 1)) == 0;
}

// Whether every row start of both caches is a multiple of `bytes`.
bool rows_aligned(const void* k, const void* v, Cache sk, Cache sv, int D,
                  int el, int bytes) {
  const long long s[6] = {sk.b, sk.s, sk.kv, sv.b, sv.s, sv.kv};
  for (long long st : s)
    if ((st * el) % bytes) return false;
  return (D * el) % bytes == 0 && aligned(k, bytes) && aligned(v, bytes);
}

template <typename TQ, typename T, int BYTES>
int launch(const TQ* q, const void* k, const void* v, const int* lengths,
           float* m_part, float* l_part, float* acc_part, TQ* out, Cache sk,
           Cache sv, const Plan& p, int H, int KV, int S, int D, float scale,
           cudaStream_t stream) {
  cudaError_t err = prepare<TQ, T, BYTES>();
  if (err != cudaSuccess) return (int)err;
  decode_split_kernel<TQ, T, BYTES>
      <<<dim3(p.ctas_x, p.ctas_y, p.ctas_z), NT, p.smem, stream>>>(
          q, static_cast<const T*>(k), static_cast<const T*>(v), lengths,
          m_part, l_part, acc_part, sk, sv, H, KV, S, D, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<TQ><<<dim3(H, p.ctas_z, (D + CC - 1) / CC), NT, 0,
                              stream>>>(
      m_part, l_part, acc_part, lengths, out, H, S, p.ctas_x, D);
  return (int)cudaGetLastError();
}

// The checks, then the launch for a q and out of type TQ.
template <typename TQ>
int forward(const TQ* q, const void* k, const void* v, const int* lengths,
            float* m_part, float* l_part, float* acc_part, TQ* out,
            long long skb, long long sks, long long skkv, long long svb,
            long long svs, long long svkv, int B, int H, int KV, int S, int D,
            int bf16, float scale, cudaStream_t stream) {
  const Cache sk{skb, sks, skkv}, sv{svb, svs, svkv};
  const int el = bf16 ? 2 : 4;
  if (B < 1 || S < 1 || KV < 1 || H % KV || H / KV > MAXG || D < 4 ||
      D % 4 || D > MAXD || B > 65535 || KV > 65535 ||
      !rows_aligned(k, v, sk, sv, D, el, bf16 ? 8 : 16))
    return (int)cudaErrorInvalidValue;
  const bool vec16 = !bf16 || rows_aligned(k, v, sk, sv, D, el, 16);
  const Plan p = plan(B, H, KV, S, D, bf16 != 0, vec16);
  int err;
  if (bf16 && vec16)
    err = launch<TQ, __nv_bfloat16, 16>(q, k, v, lengths, m_part, l_part,
                                        acc_part, out, sk, sv, p, H, KV, S,
                                        D, scale, stream);
  else if (bf16)
    err = launch<TQ, __nv_bfloat16, 8>(q, k, v, lengths, m_part, l_part,
                                       acc_part, out, sk, sv, p, H, KV, S, D,
                                       scale, stream);
  else
    err = launch<TQ, float, 16>(q, k, v, lengths, m_part, l_part, acc_part,
                                out, sk, sv, p, H, KV, S, D, scale, stream);
  if (err == 0) last_launch = p;
  return err;
}

}  // namespace

extern "C" {

int decode_attention_block(void) { return CH; }
int decode_attention_threads(void) { return NT; }
int decode_attention_max_group(void) { return MAXG; }
int decode_attention_max_d(void) { return MAXD; }

// The launch at (B, H, KV, S, D) for a bf16 (bf16 != 0) cache on the
// 16-byte copy path (vec16 != 0) or the 8-byte one, or for an fp32 cache
// (always 16-byte copies), into out[7]:
// split CTAs along S, KV, B; threads; shared bytes; copy bytes; combine
// CTAs.
void decode_attention_plan(int B, int H, int KV, int S, int D, int bf16,
                           int vec16, int* out) {
  put_plan(plan(B, H, KV, S, D, bf16 != 0, vec16 != 0), out);
}

// The last launch's plan, laid out as decode_attention_plan's.
void decode_attention_last_launch(int* out) { put_plan(last_launch, out); }

// Resident split CTAs per SM at (H, KV, D) for a bf16 (bf16 != 0) or fp32
// cache and a bf16 (q_bf16 != 0) or fp32 q, or minus a CUDA error.
int decode_attention_max_active(int H, int KV, int D, int bf16, int vec16,
                                int q_bf16) {
  const int smem = layout(H / KV, D, bf16 ? 2 : 4).total;
  return q_bf16 ? max_active<__nv_bfloat16>(smem, bf16 != 0, vec16 != 0)
                : max_active<float>(smem, bf16 != 0, vec16 != 0);
}

// q, out: (B,H,D) fp32 contiguous; k, v: (B,S,KV,D) with element strides
// for (b, s, kv) and the head dim contiguous, rows 16-byte aligned (fp32)
// or 8-byte aligned (bf16); bf16 != 0 for a bf16 cache. m_part, l_part:
// B*H*NS floats; acc_part: B*H*NS*D floats, NS = ceil(S / CH); only the
// blocks with a valid position are written.
int decode_attention_fwd(const float* q, const void* k, const void* v,
                         const int* lengths, float* m_part, float* l_part,
                         float* acc_part, float* out, long long skb,
                         long long sks, long long skkv, long long svb,
                         long long svs, long long svkv, int B, int H, int KV,
                         int S, int D, int bf16, float scale,
                         cudaStream_t stream) {
  return forward(q, k, v, lengths, m_part, l_part, acc_part, out, skb, sks,
                 skkv, svb, svs, svkv, B, H, KV, S, D, bf16, scale, stream);
}

// decode_attention_fwd for a bf16 q and out (the partials stay fp32): bit
// for bit the fp32 result on the widened q, rounded to bf16.
int decode_attention_fwd_bf16_q(const __nv_bfloat16* q, const void* k,
                                const void* v, const int* lengths,
                                float* m_part, float* l_part, float* acc_part,
                                __nv_bfloat16* out, long long skb,
                                long long sks, long long skkv, long long svb,
                                long long svs, long long svkv, int B, int H,
                                int KV, int S, int D, int bf16, float scale,
                                cudaStream_t stream) {
  return forward(q, k, v, lengths, m_part, l_part, acc_part, out, skb, sks,
                 skkv, svb, svs, svkv, B, H, KV, S, D, bf16, scale, stream);
}

}  // extern "C"
