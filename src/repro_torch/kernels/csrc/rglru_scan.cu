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
// What bounds it here: bytes. Per (b, t, w) it reads three fp32 inputs and
// writes one output, 16 B, against two exps, a square root and a few FMAs,
// so the least time is 16 B S W over the HBM rate (80 us at B = 1,
// S = W = 4096 on an H100). The recurrence is sequential in t, and at that
// shape there are only 4096 independent chains.
//
// Design: each byte crosses HBM once. A CTA owns a stripe of STRIPE = 32
// channels of one batch row (B * ceil(W / 32) CTAs: 128 at the
// RecurrentGemma shape, one wave on 132 SMs) and walks the whole of S in
// tiles of TILE = 64 steps, carrying h in the registers of its scan warp
// (the TPU kernel's sequential grid axis as a loop inside the block). The
// tiles of x, a_gate and i_gate are copied by 16-byte cp.async into a ring
// of STAGES = 5 shared-memory stages of 24 KB; h_t goes to one of two y
// tiles in shared memory. The CTA is one scan warp and up to 16 worker
// warps (one for every 4 steps of a tile), and one barrier a tile hands
// work between them. While the scan warp runs the FMA chain of tile k in
// order (one lane per channel, its shared-memory loads hoisted in groups
// of U ahead of the chain) into a y tile, the workers
//   1. issue the copies of tile k + STAGES - 1 into the stage tile k - 1
//      left (STAGES - 2 = 3 tiles, 72 KB, stay in flight: about three
//      times what 3.35 TB/s times a microsecond of latency asks of each of
//      132 SMs);
//   2. store tile k - 1's y rows with 16-byte stores;
//   3. compute a and x_hat for tile k + 1 in place, 4 elements at a time
//      so their exp and sqrt chains overlap (softplus(-lambda) once per
//      thread: a thread keeps its channel).
// Why: with the gates and the chain in series, the gates took longest and
// the chain next, all beside idle warps; with the scan warp beside 8
// workers, both paths were still well above the tile's byte time
// (~2,500 cycles for 32 KB at one SM's share of 3.35 TB/s): the gates are
// bound by the latency of their exp and sqrt chains, and the scan warp
// slows among busy workers. 16 workers bring both near the byte time
// (scripts/rglru_phases.py, which builds this kernel with
// -DRGLRU_PHASE_CLOCKS). Storing h_t straight from the scan warp, one
// 128-byte row a step, made one warp issue every store of y and ran no
// faster than reading the inputs twice; the workers' 16-byte stores from
// a y tile do not. The scan is sequential in t per channel, the JAX
// kernel's own order: no chunk summaries are chained, so the error
// does not grow with S. TMA would save the copy instructions (3 a worker a
// tile) but needs a tensor map built on the host and -lcuda; cp.async
// already keeps in flight the bytes that the rate needs.
//
// Edges: a tile past S is cut at S, a stripe past W at W (its lanes neither
// copy nor store). Rows whose byte offsets or base addresses are not 16-byte
// aligned (W not a multiple of 4) take 4-byte copies and stores in the same
// kernel. Short launches (the decode step, S = 1) shrink the tile to S, the
// ring to the tiles there are and the workers to one warp for every 4 steps
// of a tile.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int STRIPE = 32;             // channels a CTA, one lane each
constexpr int TILE = 64;               // steps a tile, at most
constexpr int STAGES = 5;              // tiles in the ring
constexpr int MAX_WORKERS = 16;        // worker warps a CTA, at most
constexpr int STEPS_PER_WORKER = 4;    // steps of a tile per worker warp
constexpr int U = 16;                  // steps whose loads the scan hoists
constexpr int UG = 4;                  // elements a worker gates at once
static_assert(STAGES >= 3, "the ring holds a tile scanned, one gated and "
                           "one being filled");
static_assert(TILE >= 1, "a tile has a step");

// Built with -DRGLRU_PHASE_CLOCKS (scripts/rglru_phases.py), thread 0 (the
// scan warp) and thread 32 (a worker) of each CTA add up the clock cycles
// of each phase of a tile: 0 the barrier (with the workers' wait for the
// copies), 1 the scan, 2 issuing the copies, 3 storing y, 4 the gates,
// 5 the last y tile; rglru_scan_phase_cycles reads the sums.
constexpr int N_PHASES = 6;
#ifdef RGLRU_PHASE_CLOCKS
__device__ unsigned long long phase_cycles[2][N_PHASES];
#define PHASE_END(i)                   \
  if (tid == 0 || tid == 32) {         \
    const long long now = clock64();   \
    clocks[i] += now - last_clock;     \
    last_clock = now;                  \
  }
#else
#define PHASE_END(i)
#endif

// One launch's layout, as rglru_scan.launch_geometry computes it in Python.
struct Plan {
  int ctas_x, ctas_y, threads, smem, tile, stages, vec;
};

Plan plan(int B, int S, int W, bool vec) {
  Plan p;
  p.tile = S < TILE ? S : TILE;
  const int ntiles = (S + p.tile - 1) / p.tile;
  p.stages = ntiles < STAGES ? ntiles : STAGES;
  const int workers = (p.tile + STEPS_PER_WORKER - 1) / STEPS_PER_WORKER;
  p.threads = 32 * (1 + (workers < MAX_WORKERS ? workers : MAX_WORKERS));
  p.ctas_x = (W + STRIPE - 1) / STRIPE;
  p.ctas_y = B;
  // the ring, then two y tiles
  p.smem = (int)sizeof(float) * (p.stages * 3 + 2) * p.tile * STRIPE;
  p.vec = vec ? 1 : 0;
  return p;
}

__device__ __forceinline__ float softplus(float z) {
  return fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// h over `rows` steps of one tile, in order: a and x_hat at [t][lane] in
// shared memory, h_t into the y tile at [t][lane].
__device__ __forceinline__ float scan_tile(const float* __restrict__ sa,
                                           const float* __restrict__ sx,
                                           float* __restrict__ sy, int rows,
                                           float h, int lane) {
  int t = 0;
  for (; t + U <= rows; t += U) {
    float av[U], xv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      av[u] = sa[(t + u) * STRIPE + lane];
      xv[u] = sx[(t + u) * STRIPE + lane];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      h = av[u] * h + xv[u];
      sy[(t + u) * STRIPE + lane] = h;
    }
  }
  for (; t < rows; ++t) {
    h = sa[t * STRIPE + lane] * h + sx[t * STRIPE + lane];
    sy[t * STRIPE + lane] = h;
  }
  return h;
}

// Grid (ceil(W / STRIPE), B); threads: the scan warp, then the workers;
// dynamic shared memory: min(STAGES, tiles) stages of {x, a_gate, i_gate}
// x tile x STRIPE floats, then two y tiles. VEC: rows and bases are
// 16-byte aligned.
template <bool VEC>
__global__ void __launch_bounds__((1 + MAX_WORKERS) * 32)
    rglru_scan_kernel(const float* __restrict__ x,
                      const float* __restrict__ ag,
                      const float* __restrict__ ig,
                      const float* __restrict__ lam,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ h_last, int S, int W, int tile) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const bool scanner = tid < 32;
  const int wid = tid - 32;                 // index among the workers
  const int nworkers = blockDim.x - 32;
  const int w0 = blockIdx.x * STRIPE;
  const int b = blockIdx.y;
  const int width = min(STRIPE, W - w0);   // channels of this stripe
  const bool active = lane < width;        // this thread's channel exists
  const size_t row0 = (size_t)b * S;       // the batch row's first step
  const int ntiles = (S + tile - 1) / tile;
  const int tile_floats = tile * STRIPE;
  float* ybuf = smem + (size_t)min(STAGES, ntiles) * 3 * tile_floats;
#ifdef RGLRU_PHASE_CLOCKS
  long long clocks[N_PHASES] = {};
  long long last_clock = clock64();
#endif

  // stage of tile k: x, then a_gate, then i_gate, each [tile][STRIPE]
  auto stage = [&](int k) {
    return smem + (size_t)(k % STAGES) * 3 * tile_floats;
  };
  auto rows_of = [&](int k) { return min(tile, S - k * tile); };
  // a worker's copies of tile k (none past the last), as one group
  auto load = [&](int k) {
    if (k < ntiles) {
      float* dst = stage(k);
      const int rows = rows_of(k);
#pragma unroll
      for (int in = 0; in < 3; ++in) {
        const float* src = (in == 0 ? x : in == 1 ? ag : ig) +
                           (row0 + (size_t)k * tile) * W + w0;
        float* d = dst + in * tile_floats;
        if (VEC) {   // 8 chunks of 16 B a row
          for (int j = wid; j < rows * (STRIPE / 4); j += nworkers) {
            const int t = j >> 3, c = (j & 7) * 4;
            if (c < width)
              cp_async16(d + t * STRIPE + c, src + (size_t)t * W + c);
          }
        } else {
          for (int j = wid; j < rows * STRIPE; j += nworkers) {
            const int t = j / STRIPE, c = j % STRIPE;
            if (c < width)
              cp_async4(d + t * STRIPE + c, src + (size_t)t * W + c);
          }
        }
      }
    }
    cp_async_commit();   // an empty group past the end keeps the count
  };
  // the workers' stores of tile k's y rows from its y tile
  auto store_y = [&](int k) {
    const float* sy = ybuf + (k & 1) * tile_floats;
    const int rows = rows_of(k);
    float* dst = y + (row0 + (size_t)k * tile) * W + w0;
    if (VEC) {
      for (int j = wid; j < rows * (STRIPE / 4); j += nworkers) {
        const int t = j >> 3, c = (j & 7) * 4;
        if (c < width)
          *reinterpret_cast<float4*>(dst + (size_t)t * W + c) =
              *reinterpret_cast<const float4*>(sy + t * STRIPE + c);
      }
    } else {
      for (int j = wid; j < rows * STRIPE; j += nworkers) {
        const int t = j / STRIPE, c = j % STRIPE;
        if (c < width) dst[(size_t)t * W + c] = sy[t * STRIPE + c];
      }
    }
  };
  // the workers' a and x_hat of tile k, in place over a_gate and x;
  // element e is at [e / STRIPE][e % STRIPE], and e % STRIPE is this
  // thread's lane, since the stride is a whole number of warps
  const float base = active ? -8.f * softplus(-lam[w0 + lane]) : 0.f;
  auto gates = [&](int k) {
    float* sx = stage(k);
    float* sa = sx + tile_floats;
    const float* si = sa + tile_floats;
    const int n = rows_of(k) * STRIPE;
    for (int e0 = wid; e0 < n; e0 += UG * nworkers) {
      float a[UG], xh[UG];
#pragma unroll
      for (int u = 0; u < UG; ++u) {
        const int e = min(e0 + u * nworkers, n - 1);
        const float log_a = sa[e] * base;
        a[u] = expf(log_a);
        xh[u] = sqrtf(fmaxf(1.f - expf(2.f * log_a), 1e-12f)) *
                (si[e] * sx[e]);
      }
#pragma unroll
      for (int u = 0; u < UG; ++u) {
        const int e = e0 + u * nworkers;
        if (e < n) {
          sa[e] = a[u];
          sx[e] = xh[u];
        }
      }
    }
  };

  float h = 0.f;
  if (scanner && active && h0) h = h0[(size_t)b * W + w0 + lane];
  if (!scanner) {
#pragma unroll 1
    for (int k = 0; k < STAGES - 1; ++k) load(k);
    cp_async_wait<STAGES - 2>();   // tile 0 has landed (this thread's part)
  }
  __syncthreads();
  if (!scanner) gates(0);
#pragma unroll 1
  for (int k = 0; k < ntiles; ++k) {
    if (!scanner) cp_async_wait<STAGES - 3>();   // tile k + 1 has landed
    // everyone's copies of tile k + 1, the gates of tile k and the scan of
    // tile k - 1 are done: its stage is free and its y tile full
    __syncthreads();
    PHASE_END(0)
    if (scanner) {
      h = scan_tile(stage(k) + tile_floats, stage(k),
                    ybuf + (k & 1) * tile_floats, rows_of(k), h, lane);
      PHASE_END(1)
    } else {
      load(k + STAGES - 1);
      PHASE_END(2)
      if (k > 0) store_y(k - 1);
      PHASE_END(3)
      if (k + 1 < ntiles) gates(k + 1);
      PHASE_END(4)
    }
  }
  __syncthreads();
  if (!scanner) store_y(ntiles - 1);
  if (scanner && active) h_last[(size_t)b * W + w0 + lane] = h;
  PHASE_END(5)
#ifdef RGLRU_PHASE_CLOCKS
  if (tid == 0 || tid == 32)
    for (int i = 0; i < N_PHASES; ++i)
      atomicAdd(&phase_cycles[tid / 32][i], (unsigned long long)clocks[i]);
#endif
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Lets each instance take the largest ring's shared memory, once a device.
template <bool VEC>
cudaError_t prepare() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      rglru_scan_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(float) * (STAGES * 3 + 2) * TILE * STRIPE);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

Plan last_launch = {};

void put_plan(const Plan& p, int* out) {
  const int v[7] = {p.ctas_x, p.ctas_y, p.threads, p.smem,
                    p.tile,   p.stages, p.vec};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
}

}  // namespace

extern "C" {

int rglru_scan_stripe(void) { return STRIPE; }

int rglru_scan_tile(void) { return TILE; }

int rglru_scan_stages(void) { return STAGES; }

int rglru_scan_max_threads(void) { return (1 + MAX_WORKERS) * 32; }

// The launch for (B, S, W) on the 16-byte path (vec != 0) or the 4-byte
// one, into out[7]: CTAs along W, CTAs along B, threads, shared bytes,
// tile, stages, vec.
void rglru_scan_plan(int B, int S, int W, int vec, int* out) {
  put_plan(plan(B, S, W, vec != 0), out);
}

// The last launch's plan, laid out as rglru_scan_plan's.
void rglru_scan_last_launch(int* out) { put_plan(last_launch, out); }

// Resident CTAs per SM for the launch at (B, S, W, vec), or minus a CUDA
// error.
int rglru_scan_max_active(int B, int S, int W, int vec) {
  if (B < 1 || S < 1 || W < 1) return -(int)cudaErrorInvalidValue;
  const Plan p = plan(B, S, W, vec != 0);
  const cudaError_t err = vec ? prepare<true>() : prepare<false>();
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  const cudaError_t occ =
      vec ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, rglru_scan_kernel<true>, p.threads, p.smem)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, rglru_scan_kernel<false>, p.threads, p.smem);
  return occ == cudaSuccess ? n : -(int)occ;
}

// y, h_last: (B,S,W), (B,W); h0 may be null (zero state).
int rglru_scan_fwd(const float* x, const float* ag, const float* ig,
                   const float* lam, const float* h0, float* y,
                   float* h_last, int B, int S, int W, cudaStream_t stream) {
  if (B < 1 || S < 1 || W < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const bool vec = W % 4 == 0 && aligned16(x) && aligned16(ag) &&
                   aligned16(ig) && aligned16(y);
  const Plan p = plan(B, S, W, vec);
  const cudaError_t err = vec ? prepare<true>() : prepare<false>();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.ctas_x, p.ctas_y);
  if (vec)
    rglru_scan_kernel<true><<<grid, p.threads, p.smem, stream>>>(
        x, ag, ig, lam, h0, y, h_last, S, W, p.tile);
  else
    rglru_scan_kernel<false><<<grid, p.threads, p.smem, stream>>>(
        x, ag, ig, lam, h0, y, h_last, S, W, p.tile);
  last_launch = p;
  return (int)cudaGetLastError();
}

#ifdef RGLRU_PHASE_CLOCKS
// Copies the phase sums (cycles over all CTAs; the scan warp's thread, then
// the worker's) to host memory and zeroes them.
int rglru_scan_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, phase_cycles,
                                         sizeof(phase_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[2][N_PHASES] = {};
  return (int)cudaMemcpyToSymbol(phase_cycles, zero, sizeof(zero));
}
#endif

}  // extern "C"
