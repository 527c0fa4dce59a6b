// Sequential sLSTM forward from zero state, fp32, for sm_90a: one thread
// block cluster per (head, batch rows), R held on chip for the whole launch.
//
// Replaces the Pallas TPU kernel repro/kernels/slstm_scan.py
// (slstm_scan -> _slstm_kernel). Same function: per (batch, head) and step
// t, four recurrent matvecs h_{t-1} R_{z,i,f,o} (R indexed [in][out]), then
//   z = tanh, o = sigmoid, log f = log sigmoid, m = max(log f + m, i),
//   c = f' c + i' z,  n = max(f' n + i', exp(-m)),  h = o c / n.
//
// What bounds it: the recurrence, no longer reads of R. There are B * NH
// chains (32 at B = 8, NH = 4) of S dependent steps, so the floor is S times
// the latency of one step: the matvec, the sum of its parts, the chain of
// transcendentals of the cell update and the exchange of h between the CTAs
// of a cluster. The card's flops (0.288 ms at B = 8, S = 2048, HD = 192) and
// bytes are far below that. On an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py): 2.473 ms at that shape, 1.207 us a step, in 12 clusters
// of eight CTAs with three batch rows each (18.558 ms when one CTA per
// chain read R from L2 every step), and 0.775 us a step for one chain at
// HD = 16, the step's latency with next to no matvec.
//
// Design. A head's four R matrices are 4 x HD x HD fp32, 576 KiB at
// HD = 192: more than one SM holds, so a cluster of CL CTAs splits them by
// output unit. CTA r owns units [r HD/CL, (r+1) HD/CL) of all four gates and
// loads its slice of R into its threads' registers once, before the time
// loop: thread (unit, K chunk) holds the unit's four gates over HD/16 rows
// of K. Nothing in the loop reads R from device memory or L2. Per step:
//   1. each thread reads its K chunk of h_{t-1} (float4 broadcasts from the
//      CTA's own shared memory) and writes the four gates' partial sums for
//      each of the cluster's rb batch rows;
//   2. one thread per (row, gate, unit) adds the 16 partial sums and the
//      pre-activation and activates its gate; the four lanes of a unit swap
//      their gates by shuffle and each updates the unit's c, n, m alike
//      (kept in registers);
//   3. lane g sends h_t into the h buffer of CTAs g and g + 4 with st.async,
//      which completes a transaction count on the receiver's mbarrier, and
//      lane 0 writes h_t to device memory. A CTA starts step t + 1 when its
//      mbarrier has counted rb x HD floats of h_t. The buffer and its
//      mbarrier are doubled by step parity: a CTA writes parity t + 1 only
//      after it has h_{t-1} from every CTA, so after every CTA's reads of
//      that parity in step t - 1, and a barrier is re-armed only once its
//      phase has completed. So no cluster-wide barrier runs in the loop;
//      there is one before the first remote write and one before exit.
// The pre-activations stream through a ring of kRing steps in shared memory
// by cp.async, each thread copying the element it later reads.
// rb and CL come from the wrapper's geometry: the fewest rows per cluster for
// which every cluster is resident at once (cudaOccupancyMaxActiveClusters).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kGates = 4;
constexpr int kSplit = 16;  // K chunks of each unit's four matvecs
constexpr int kRing = 4;   // steps of pre-activations in flight
constexpr int kMaxHD = 256;
constexpr int kMaxRows = 4;  // batch rows per cluster

// CTAs per cluster. Above HD = 128, eight rather than four spread a head's
// matvec over twice the SMs (faster at HD = 192: less work per SM).
__host__ __device__ constexpr int cluster_ctas(int hd) {
  return hd <= 128 ? 4 : 8;
}

template <int HD>
struct Geo {
  static constexpr int CL = cluster_ctas(HD);
  static constexpr int U = HD / CL;           // units per CTA
  static constexpr int NCOL = kGates * U;     // (gate, unit) columns per CTA
  static constexpr int KPT = HD / kSplit;     // K per thread
  static constexpr int NT = U * kSplit;       // threads per CTA
  static_assert(NT == kMaxRows * NCOL, "one cell thread per row and column");
  static_assert(HD % 16 == 0 && HD <= kMaxHD, "HD: a multiple of 16 to 256");
};

size_t smem_bytes(int hd, int rb) {
  const size_t ncol = kGates * hd / cluster_ctas(hd);
  const size_t floats = 2 * rb * hd                // h, by parity [2][rb][HD]
                        + rb * kSplit * ncol         // sums [rb][kSplit][NCOL]
                        + kRing * rb * ncol;         // x ring [kRing][rb][NCOL]
  return floats * sizeof(float) + 2 * sizeof(uint64_t);  // + mbarriers
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The same shared memory address in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arm(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], "
      "%1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n"
      "DONE:\n\t}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void st_async(uint32_t addr, float v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

__device__ __forceinline__ const float* gate_ptr(int g, const float* a,
                                                 const float* b,
                                                 const float* c,
                                                 const float* d) {
  return g == 0 ? a : g == 1 ? b : g == 2 ? c : d;
}

template <int HD>
__global__ void __launch_bounds__(Geo<HD>::NT, 1)
    slstm_cluster_kernel(const float* __restrict__ z,
                         const float* __restrict__ i,
                         const float* __restrict__ f,
                         const float* __restrict__ o,
                         const float* __restrict__ rz,
                         const float* __restrict__ ri,
                         const float* __restrict__ rf,
                         const float* __restrict__ ro,
                         float* __restrict__ h, int B, int NH, int S,
                         int rb) {
  using G = Geo<HD>;
  constexpr int CL = G::CL, U = G::U, NCOL = G::NCOL, KPT = G::KPT;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cid = blockIdx.x / CL;
  const int head = cid % NH;
  const int b0 = (cid / NH) * rb;
  const int rows = min(rb, B - b0);

  extern __shared__ float4 smem4[];
  float* hbuf = reinterpret_cast<float*>(smem4);  // [2][rb][HD], by parity
  float* part = hbuf + 2 * rb * HD;               // [rb][kSplit][NCOL]
  float* ring = part + rb * kSplit * NCOL;        // [kRing][rb][NCOL]
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + kRing * rb * NCOL);
  const int tid = threadIdx.x;

  // -- matvec role: unit mu, K chunk kc; this thread's 4 x KPT of R, once --
  const int mu = tid % U, kc = tid / U;
  float rr[kGates][KPT];
#pragma unroll
  for (int g = 0; g < kGates; ++g) {
    const float* R = gate_ptr(g, rz, ri, rf, ro) + (size_t)head * HD * HD +
                     (size_t)kc * KPT * HD + rank * U + mu;
#pragma unroll
    for (int j = 0; j < KPT; ++j) rr[g][j] = R[(size_t)j * HD];
  }
  for (int idx = tid; idx < rb * HD; idx += G::NT) hbuf[idx] = 0.f;

  // -- cell role: row cr, column col = 4 u + g (gate g of unit u, so the
  // four gates of a unit sit in adjacent lanes). The same thread copies
  // that element's pre-activation of step t into ring slot t % kRing.
  const int cr = tid / NCOL;
  const int col = tid - cr * NCOL;
  const int g = col & 3, u = col >> 2;
  const bool cell = cr < rows;
  const bool cell_warp = (tid & ~31) < rows * NCOL;  // whole warps shuffle
  const size_t hoff = ((size_t)(b0 + cr) * NH + head) * S * HD + rank * U + u;
  const float* xsrc = gate_ptr(g, z, i, f, o) + hoff;
  auto prefetch = [&](int t) {  // cell threads only
    if (t < S)
      cp_async4(ring + ((t % kRing) * rb + cr) * NCOL + col,
                xsrc + (size_t)t * HD);
    cp_async_commit();
  };
  if (cell)
    for (int t = 0; t < kRing; ++t) prefetch(t);
  float c_st = 0.f, n_st = 0.f, m_st = 0.f;

  // bars[p] completes when h of a step has come into hbuf[p] from every CTA
  const uint32_t bar0 = smem_addr(bars);
  const uint32_t tx = rows * HD * sizeof(float);
  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    fence_mbar_init();
    mbar_arm(bar0, tx);
    mbar_arm(bar0 + 8, tx);
  }
  // every CTA has started, zeroed its h and armed its barriers before any
  // remote write
  cluster.sync();

  for (int t = 0; t < S; ++t) {
    if (t > 0) {  // h_{t-1} from every CTA, then re-arm for h_{t+1}
      mbar_wait(bar0 + 8 * (t & 1), ((t - 1) >> 1) & 1);
      if (tid == 0) mbar_arm(bar0 + 8 * (t & 1), tx);
    }

    // 1. K chunk kc of the four gates' matvecs of unit mu, each row
    const float* hc = hbuf + (t & 1) * rb * HD + kc * KPT;
    for (int r = 0; r < rows; ++r) {
      float a[kGates] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (KPT % 4 == 0) {  // h broadcast as float4
#pragma unroll
        for (int j = 0; j < KPT; j += 4) {
          const float4 hv = *reinterpret_cast<const float4*>(hc + r * HD + j);
#pragma unroll
          for (int q = 0; q < kGates; ++q) {
            a[q] = fmaf(hv.x, rr[q][j], a[q]);
            a[q] = fmaf(hv.y, rr[q][j + 1], a[q]);
            a[q] = fmaf(hv.z, rr[q][j + 2], a[q]);
            a[q] = fmaf(hv.w, rr[q][j + 3], a[q]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          const float hv = hc[r * HD + j];
#pragma unroll
          for (int q = 0; q < kGates; ++q) a[q] = fmaf(hv, rr[q][j], a[q]);
        }
      }
      *reinterpret_cast<float4*>(part + (r * kSplit + kc) * NCOL + 4 * mu) =
          make_float4(a[0], a[1], a[2], a[3]);
    }
    __syncthreads();

    // 2. the cell update: each lane sums and activates its gate, the four
    // lanes of a unit swap them and each updates the unit's c, n, m alike
    if (cell_warp) {
      float s = 0.f;
      if (cell) {
        cp_async_wait<kRing - 1>();  // this thread's copy of step t landed
        const float* pr = part + cr * kSplit * NCOL + col;
        float s0 = ring[((t % kRing) * rb + cr) * NCOL + col], s1 = 0.f,
              s2 = 0.f, s3 = 0.f;
#pragma unroll
        for (int q = 0; q < kSplit; q += 4) {
          s0 += pr[q * NCOL];
          s1 += pr[(q + 1) * NCOL];
          s2 += pr[(q + 2) * NCOL];
          s3 += pr[(q + 3) * NCOL];
        }
        s = (s0 + s1) + (s2 + s3);
      }
      // z = tanh = 2 sigmoid(2x) - 1, i as it is, log sigmoid f, sigmoid o
      const float a = g == 0 ? 2.f * s : s;
      const float e = expf(-fabsf(a));
      const float sg = (a >= 0.f ? 1.f : e) / (1.f + e);
      const float act = g == 0   ? 2.f * sg - 1.f
                        : g == 1 ? s
                        : g == 2 ? fminf(a, 0.f) - log1pf(e)
                                 : sg;
      const float zz = __shfl_sync(0xffffffffu, act, 0, 4);
      const float il = __shfl_sync(0xffffffffu, act, 1, 4);
      const float fl = __shfl_sync(0xffffffffu, act, 2, 4);
      const float oo = __shfl_sync(0xffffffffu, act, 3, 4);
      const float mf = fl + m_st;
      const float m_new = fmaxf(mf, il);
      // of exp(i - m_new) and exp(log f + m - m_new), one is exp(0) = 1
      const float ed = expf(-fabsf(mf - il));
      const float isc = mf >= il ? ed : 1.f;
      const float fsc = mf >= il ? 1.f : ed;
      c_st = fsc * c_st + isc * zz;
      n_st = fmaxf(fsc * n_st + isc, expf(-m_new));
      m_st = m_new;
      const float hn = oo * (c_st / n_st);
      if (cell) {
        // 3. lane g sends h_t to CTAs g, g + 4 of the cluster; h_{S-1} is
        // needed by no step, so no CTA writes into a peer after its last wait
        if (t + 1 < S) {
          const uint32_t dst = smem_addr(hbuf + ((t + 1) & 1) * rb * HD +
                                         cr * HD + rank * U + u);
          const uint32_t bar = bar0 + 8 * ((t + 1) & 1);
#pragma unroll
          for (int q = g; q < CL; q += 4)
            st_async(cluster_addr(dst, q), hn, cluster_addr(bar, q));
        }
        if (g == 0) h[hoff + (size_t)t * HD] = hn;
        prefetch(t + kRing);  // into the slot just read (s is used by now)
      }
    }
  }
  cp_async_wait<0>();
  cluster.sync();  // no CTA leaves while a peer may still address it
}

// Calls fn(std::integral_constant<int, HD>) for a supported HD.
template <typename Fn>
int with_hd(int hd, Fn&& fn) {
  switch (hd) {
#define SLSTM_CASE(N) \
  case N:             \
    return fn(std::integral_constant<int, N>{});
    SLSTM_CASE(16) SLSTM_CASE(32) SLSTM_CASE(48) SLSTM_CASE(64)
    SLSTM_CASE(80) SLSTM_CASE(96) SLSTM_CASE(112) SLSTM_CASE(128)
    SLSTM_CASE(144) SLSTM_CASE(160) SLSTM_CASE(176) SLSTM_CASE(192)
    SLSTM_CASE(208) SLSTM_CASE(224) SLSTM_CASE(240) SLSTM_CASE(256)
#undef SLSTM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int HD>
cudaError_t prepare(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                    int n_clusters, int rb, cudaStream_t stream) {
  using G = Geo<HD>;
  const size_t smem = smem_bytes(HD, rb);
  cudaError_t err = cudaFuncSetAttribute(
      slstm_cluster_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = G::CL;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(G::CL * n_clusters);
  cfg->blockDim = dim3(G::NT);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return err;
}

bool valid(int hd, int cl, int rb) {
  return hd >= 16 && hd <= kMaxHD && hd % 16 == 0 &&
         cl == cluster_ctas(hd) && rb >= 1 && rb <= kMaxRows;
}

}  // namespace

extern "C" {

// Largest head dim the kernel takes (HD a multiple of 16 up to this).
int slstm_scan_max_hd(void) { return kMaxHD; }

// Most batch rows one cluster serves.
int slstm_scan_max_rows(void) { return kMaxRows; }

// How many clusters of this geometry the card holds at once, or minus a
// CUDA error code.
int slstm_scan_max_active_clusters(int HD, int CL, int rb) {
  if (!valid(HD, CL, rb)) return -static_cast<int>(cudaErrorInvalidValue);
  return with_hd(HD, [&](auto hd) {
    constexpr int kHD = decltype(hd)::value;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err = prepare<kHD>(&cfg, &attr, 1, rb, nullptr);
    int n = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(
          &n, reinterpret_cast<const void*>(slstm_cluster_kernel<kHD>), &cfg);
    return err == cudaSuccess ? n : -static_cast<int>(err);
  });
}

// One launch over the whole sequence: NH * ceil(B / rb) clusters of CL CTAs,
// cluster c serving head c % NH and batch rows [(c / NH) rb, ... + rb).
// Returns the launch's CUDA error code (0 when it was accepted).
int slstm_scan_fwd(const float* z, const float* i, const float* f,
                   const float* o, const float* rz, const float* ri,
                   const float* rf, const float* ro, float* h, int B, int NH,
                   int S, int HD, int CL, int rb, cudaStream_t stream) {
  if (!valid(HD, CL, rb) || B < 1 || NH < 1 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_clusters = NH * ((B + rb - 1) / rb);
  return with_hd(HD, [&](auto hd) {
    constexpr int kHD = decltype(hd)::value;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err = prepare<kHD>(&cfg, &attr, n_clusters, rb, stream);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, slstm_cluster_kernel<kHD>, z, i, f, o,
                               rz, ri, rf, ro, h, B, NH, S, rb);
    const cudaError_t last = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : last);
  });
}

}  // extern "C"
