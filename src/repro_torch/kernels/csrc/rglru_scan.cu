// RG-LRU scan with its gate algebra fused in, fp32, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/rglru_scan.py
// (rglru_scan -> _rglru_kernel) together with the elementwise gate algebra
// that the TPU version computes outside its kernel. Same function: over
// (B, S, W), with c = 8,
//   log a_t = a_gate_t * (-c * softplus(-lambda)),  a_t = exp(log a_t),
//   x_hat_t = sqrt(max(1 - exp(2 log a_t), 1e-12)) * i_gate_t * x_t,
//   h_t = a_t h_{t-1} + x_hat_t  from h_0 (zeros when none is given),
// returning every h_t and the last one.
//
// What bounds it here: bytes. Each step is a handful of flops on three
// fp32 inputs and one output, 16 bytes per (b, t, w), so the least time is
// 16 B S W over the HBM rate. But the recurrence is sequential in t: at
// B = 1, W = 4096 there are only 4096 independent chains, 32 warps if each
// chain had one thread, too few to keep enough loads in flight.
// Design: split S into up to 16 chunks, one warp per chunk, and W into tiles
// of 32 channels, one lane per channel, so a warp's loads are 128 B
// coalesced rows of W. A CTA is one channel tile by all chunks (512 threads
// at 16 chunks); at B = 1, W = 4096 that is 128 CTAs of 16 warps. Pass 1:
// each warp scans its chunk from a zero state and keeps the chunk's product
// of a and its end state. The CTA then chains the chunks' summaries in
// shared memory, which gives each chunk its true start state, and pass 2
// rescans the chunk from it and writes y. The inputs are read twice (the
// second time partly from L2), the price of 16x more loads in flight.
// softplus(-lambda) is computed once per channel; the loads of U steps are
// issued before the dependent multiply-adds that consume them.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_CHUNKS = 16;  // warps per CTA, one chunk of S each
constexpr int MIN_CHUNK = 64;   // fewest steps worth a warp of its own
constexpr int U = 8;            // steps whose loads are issued together

__device__ __forceinline__ float softplus(float z) {
  return fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)));
}

// Scans t in [t0, t1) from state h, multiplying the decays into A; writes
// each h_t to y when Y is set.
template <bool Y>
__device__ __forceinline__ float scan_chunk(
    const float* __restrict__ x, const float* __restrict__ ag,
    const float* __restrict__ ig, float* __restrict__ y, size_t W, int t0,
    int t1, float base, float h, float& A) {
  for (int t = t0; t < t1; t += U) {
    float xv[U], av[U], iv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t + u < t1) {
        const size_t o = (size_t)(t + u) * W;
        xv[u] = x[o];
        av[u] = ag[o];
        iv[u] = ig[o];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t + u < t1) {
        const float log_a = av[u] * base;
        const float a = expf(log_a);
        const float xh =
            sqrtf(fmaxf(1.f - expf(2.f * log_a), 1e-12f)) * (iv[u] * xv[u]);
        h = a * h + xh;
        if (Y) {
          y[(size_t)(t + u) * W] = h;
        } else {
          A *= a;
        }
      }
    }
  }
  return h;
}

__global__ void rglru_scan_kernel(const float* __restrict__ x,
                                  const float* __restrict__ ag,
                                  const float* __restrict__ ig,
                                  const float* __restrict__ lam,
                                  const float* __restrict__ h0,
                                  float* __restrict__ y,
                                  float* __restrict__ h_last, int S, int W,
                                  int chunk) {
  __shared__ float s_a[MAX_CHUNKS][32];  // product of a over each chunk
  __shared__ float s_h[MAX_CHUNKS][32];  // each chunk's end state from 0
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nchunk = blockDim.x >> 5;
  const int w = blockIdx.x * 32 + lane;
  const int b = blockIdx.y;
  const bool active = w < W;
  const int t0 = min(S, warp * chunk);
  const int t1 = min(S, t0 + chunk);
  const size_t off = (size_t)b * S * W + w;
  const float base = active ? -8.f * softplus(-lam[w]) : 0.f;

  float A = 1.f, h = 0.f;
  if (active)
    h = scan_chunk<false>(x + off, ag + off, ig + off, nullptr, W, t0, t1,
                          base, 0.f, A);
  s_a[warp][lane] = A;
  s_h[warp][lane] = h;
  __syncthreads();
  if (!active) return;

  float hs = h0 ? h0[(size_t)b * W + w] : 0.f;
  for (int c = 0; c < warp; ++c) hs = s_a[c][lane] * hs + s_h[c][lane];
  h = scan_chunk<true>(x + off, ag + off, ig + off, y + off, W, t0, t1, base,
                       hs, A);
  if (warp == nchunk - 1) h_last[(size_t)b * W + w] = h;
}

}  // namespace

extern "C" {

// y, h_last: (B,S,W), (B,W); h0 may be null (zero state).
int rglru_scan_fwd(const float* x, const float* ag, const float* ig,
                   const float* lam, const float* h0, float* y,
                   float* h_last, int B, int S, int W, cudaStream_t stream) {
  int nchunk = (S + MIN_CHUNK - 1) / MIN_CHUNK;
  nchunk = nchunk < 1 ? 1 : (nchunk > MAX_CHUNKS ? MAX_CHUNKS : nchunk);
  const int chunk = (S + nchunk - 1) / nchunk;
  dim3 grid((W + 31) / 32, B);
  rglru_scan_kernel<<<grid, 32 * nchunk, 0, stream>>>(x, ag, ig, lam, h0, y,
                                                      h_last, S, W, chunk);
  return (int)cudaGetLastError();
}

}  // extern "C"
