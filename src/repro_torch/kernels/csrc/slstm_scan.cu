// Sequential sLSTM forward from zero state, fp32, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/slstm_scan.py
// (slstm_scan -> _slstm_kernel). Same function: per (batch, head) and step
// t, four recurrent matvecs h_{t-1} R_{z,i,f,o} (R indexed [in][out]), then
//   z = tanh, o = sigmoid, log f = log sigmoid, m = max(log f + m, i),
//   c = f' c + i' z,  n = max(f' n + i', exp(-m)),  h = o c / n.
//
// What bounds it here: the recurrence. There are only B * NH independent
// chains (32 at B = 8, NH = 4) of S dependent steps, so at most 32 SMs can
// work, and each step must read the head's four R matrices (4 x HD x HD fp32,
// 576 KiB at HD = 192). Those do not fit in one SM's shared memory or
// registers, so in this version they are read from L2 every step: the four
// heads' R are 2.4 MB in all and stay resident in the 50 MB L2. The bound is
// then the SM's L2 read rate times S, not the card's flops or HBM bytes.
// Design: one launch covers the whole sequence; one CTA per (batch, head)
// with one thread per (gate, unit), 4*HD threads, so each R column is read
// by a thread of its own and the reads of a warp are coalesced. h_{t-1}
// sits in shared memory and is broadcast to every thread; two barriers per
// step separate the matvecs from the cell update. The next step's
// pre-activation is loaded before the matvec loop so its latency hides
// behind it. Holding R across a thread-block cluster (distributed shared
// memory) is the way past the L2 rate.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__global__ void slstm_scan_kernel(const float* __restrict__ z,
                                  const float* __restrict__ i,
                                  const float* __restrict__ f,
                                  const float* __restrict__ o,
                                  const float* __restrict__ rz,
                                  const float* __restrict__ ri,
                                  const float* __restrict__ rf,
                                  const float* __restrict__ ro,
                                  float* __restrict__ h, int S, int HD) {
  extern __shared__ float smem[];
  float* sh = smem;        // HD: h_{t-1}
  float* spre = sh + HD;   // 4 x HD: gate pre-activations of this step
  const int tid = threadIdx.x;
  const int g = tid / HD;  // gate: 0 z, 1 i, 2 f, 3 o
  const int e = tid - g * HD;
  const int head = blockIdx.x;
  const size_t base = ((size_t)blockIdx.y * gridDim.x + head) * S * HD;
  const float* x = (g == 0 ? z : g == 1 ? i : g == 2 ? f : o) + base;
  const float* R =
      (g == 0 ? rz : g == 1 ? ri : g == 2 ? rf : ro) + (size_t)head * HD * HD;
  float* hb = h + base;

  float c = 0.f, n = 0.f, m = 0.f;  // cell state, kept by the g == 0 threads
  if (tid < HD) sh[tid] = 0.f;
  __syncthreads();

  float xt = x[e];
  for (int t = 0; t < S; ++t) {
    const float xnext = t + 1 < S ? x[(size_t)(t + 1) * HD + e] : 0.f;
    float acc = xt;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) acc = fmaf(sh[d], R[(size_t)d * HD + e], acc);
    spre[tid] = acc;
    __syncthreads();
    if (g == 0) {
      const float zz = tanhf(spre[e]);
      const float il = spre[HD + e];
      const float fl = log_sigmoid(spre[2 * HD + e]);
      const float oo = 1.f / (1.f + expf(-spre[3 * HD + e]));
      const float m_new = fmaxf(fl + m, il);
      const float isc = expf(il - m_new);
      const float fsc = expf(fl + m - m_new);
      c = fsc * c + isc * zz;
      n = fmaxf(fsc * n + isc, expf(-m_new));
      m = m_new;
      const float hn = oo * (c / n);
      sh[e] = hn;
      hb[(size_t)t * HD + e] = hn;
    }
    __syncthreads();
    xt = xnext;
  }
}

}  // namespace

extern "C" {

// Largest head dim one CTA serves (one thread per gate and unit).
int slstm_scan_max_hd(void) { return 256; }

int slstm_scan_fwd(const float* z, const float* i, const float* f,
                   const float* o, const float* rz, const float* ri,
                   const float* rf, const float* ro, float* h, int B, int NH,
                   int S, int HD, cudaStream_t stream) {
  dim3 grid(NH, B);
  const size_t smem = sizeof(float) * 5 * (size_t)HD;
  slstm_scan_kernel<<<grid, 4 * HD, smem, stream>>>(z, i, f, o, rz, ri, rf,
                                                     ro, h, S, HD);
  return (int)cudaGetLastError();
}

}  // extern "C"
