// Flash attention forward with GQA, causal and window masks, fp32 or bf16
// in and out (q, k and v of one type), for sm_90a: the fp32 instance on TF32
// tensor cores in split precision (3xTF32), the bf16 instance on bf16 tensor
// cores with P kept as two bf16 parts.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention -> _fa_kernel). Same function: for query head h, which
// reads KV head h / G, softmax(q k^T / sqrt(D)) v over the visible keys,
// where key j is visible to query i iff j < Skv, j <= i (causal) and
// j > i - window (window). Online softmax in fp32; key blocks wholly above
// the diagonal or left of the window are skipped. A query with no visible
// key gives zeros.
//
// What bounds it here: operations. At RecurrentGemma's prefill (H = 16,
// one KV head, D = 256, S = 4096, window 2048) the visible (q, k) pairs
// need 103 GFLOP against 142 MB of q, k, v and out. fp32 SIMT FMAs cap that
// at 67 TFLOP/s; the TF32 tensor cores run 495. TF32 keeps 10 mantissa
// bits, so each fp32 operand x is split into big = tf32(x) and
// small = tf32(x - big), and a product is small.big + big.small + big.big
// with fp32 accumulation (the small.small term, 2^-22 of the product, is
// dropped): three MMAs for each fp32 one, about fp32's accuracy, at
// 3 x 103 / 495 GFLOP/TFLOP/s = 0.625 ms of tensor-core time.
//
// Design. One CTA of 8 warps serves 128 query rows of one head; warp w owns
// rows 16w..16w+15, the M of mma.sync. CTAs are numbered so
// that a q tile's H x B heads come together (the G heads of a KV group read
// the same K and V blocks from L2 back to back) and the tiles with the most
// visible keys come first (the last tiles under a causal mask), so the
// short tiles fill the tail of the last wave.
//  - Shared memory: the Q tile (128 x D) for the whole loop, one K block and
//    one V block of BK = 32 keys. The stream of tiles K0, V0, K1, V1, ... is
//    double-buffered over the two buffers: K_{j+1} is copied by cp.async
//    while PV_j reads V_j, and V_{j+1} while QK^T_{j+1} and the softmax
//    read K_{j+1}. Two buffers of each would need 267,264 B at D = 256
//    against 232,448. Bytes: (160 QP + 32 VP) x 4 with the fp32 row pitches
//    QP = D + 16 and VP = D + 4 at D = 64, 128, 256 (QP = 80, VP = 100 at
//    D = 80; see qk_pitch_f32): 207,360 at D = 256 (1 CTA/SM), 109,056 at
//    128, 64,000 at 80 and 59,904 at 64; in bf16 192 (D + 8) x 2: 101,376,
//    52,224, 33,792 and 27,648.
//  - fp32 operands from shared memory, split on the fly: big rounded as
//    cvt.rna.tf32.f32 rounds (in integer operations), small the same on
//    x - big, on mma.sync.m16n8k8.tf32. The contraction index of each
//    product is permuted, which the sum does not see:
//    QK^T: over d in chunks of 16, lane (g, t) (g = lane / 4, t = lane % 4)
//      reads one float4 at d = 16c + 4t of Q row g, Q row g + 8 and K row g
//      of each 8-key tile; its .x/.y are the fragment's k = t and t + 4 of
//      the first k-step, .z/.w those of the second. Bank check, row pitch
//      QP = 16 mod 32 words (D + 16 at D = 64, 128, 256; D itself at 80): a
//      16-byte load is served a quarter warp (lanes 8i..8i+7, g in
//      {2i, 2i+1}, t = 0..3) at a time; its addresses start at words
//      16 (g mod 2) + 4t, 8 distinct 4-bank groups: no conflict.
//    PV: the keys of k-step n are taken in the order 2t, 2t+1 for lane
//      (g, t), so the S accumulator (c0, c1 at keys 2t, 2t+1 of row g; c2,
//      c3 of row g + 8) already is the A fragment of P (a0 = c0, a1 = c2,
//      a2 = c1, a3 = c3): P never leaves the registers and needs no
//      shuffle. V's columns are interleaved over 4 n-tiles: column g of
//      n-tile j of group c is column 32c + 4g + j, so one float4 of V row
//      2t (b0) and one of row 2t + 1 (b1) feed four n-tiles, and the lane's
//      output row holds the 8 consecutive columns 32c + 8t .. 32c + 8t + 7.
//      Bank check, row pitch VP = 4 mod 32 (D + 4 at D = 64, 128, 256;
//      D + 20 at 80): a quarter warp's loads start at words 8t + 4g mod 32,
//      g in {2i, 2i + 1}: 8 distinct 4-bank groups: no conflict.
//      Where D = 16 mod 32 (D = 80) the last 16 columns are a tail of two
//      n-tiles: column g of tail n-tile j is column 32 NC + 2g + j, so one
//      float2 of V row 2t (b0) and one of row 2t + 1 (b1) feed both, and the
//      lane's output row holds the 4 consecutive columns 32 NC + 4t ..
//      32 NC + 4t + 3, stored as one float4. Its 8-byte loads are served a
//      half warp at a time, at words 8t + 2g mod 32 for 4 values of g: 16
//      distinct pairs of banks, no conflict. The tail costs no product on
//      padding (zero columns carried up to 96 would cost 20% more PV MMAs).
//    The two small products are issued before big.big.
//  - Registers: the 16 x D output accumulator is D / 2 floats a thread
//    (128 at D = 256), the S tile 16, the split fragments of one k-step 24;
//    one CTA a SM, so up to 255 a thread. Splitting takes integer
//    operations, not cvt (see to_tf32).
//  - Online softmax in fp32 in the base-2 domain (scale x log2 e folded into
//    S, exp2f); each lane keeps the row sums of its own columns and the
//    quad adds them once at the end. A warp skips a block that none of its
//    rows sees, and masks only blocks that straddle the diagonal, the
//    window's edge or Skv.
// Tensors are read in place through their strides (the model passes its
// (B, S, H, D) projections as (B, H, S, D) views); ragged tails are
// zero-filled by the copies and masked, never padded in memory.
//
// bf16 inputs (flash_attention_bf16_kernel). At Yi-34B's prefill (H = 56
// over 8 KV heads, D = 128, S = 4096, causal) the function is 240.6 GFLOP,
// 0.243 ms at the bf16 tensor-core rate of 989 TFLOP/s. Both products run on
// mma.sync.m16n8k16.bf16 with fp32 accumulation, operands loaded by
// ldmatrix (x4: four 8 x 8 matrices a warp instruction):
//  - QK^T on q and k as stored: Q rows are the A fragment, K rows already
//    the "col" B fragment (no transpose). bf16 products are exact in fp32,
//    so S is fp32 sums of exact products. Where the registers allow (D =
//    64) a warp's Q fragments stay in registers for the whole key loop
//    (D / 4 a thread); else they are read again from shared memory each
//    key block.
//  - PV with P kept in fp32 as the Pallas kernel keeps it, as two bf16
//    parts: P_hi = rn(P), P_lo = rn(P - P_hi) (the remainder is exact in
//    fp32), so |P - P_hi - P_lo| <= 2^-17 |P|, and O += P_lo V + P_hi V,
//    the small product first. The accumulators of two adjacent 8-key
//    n-tiles of S, packed in pairs, are exactly one A fragment of P
//    ({s[n][0..1], s[n][2..3], s[n+1][0..1], s[n+1][2..3]} as bf16x2): P
//    never leaves the registers. V is read by ldmatrix.trans.
//    So the route is 1 + 2 bf16 products: 1.5 x 240.6 GFLOP, 0.365 ms.
//  - Q, K and V rows at pitch D + 8 bf16, D / 2 + 4 words: an odd multiple
//    of 4 for every D = 0 mod 16 (4 mod 32 at D = 64, 128, 256; 12 at 80),
//    so the 8 rows of 16 bytes that ldmatrix reads at a time fall on 8
//    distinct 4-bank groups, no conflict. At D = 80 QK^T takes 5 k-steps
//    (one ldmatrix.x4 each) and PV 10 n-tiles (in pairs by ldmatrix.x4.trans).
//  - 2 CTAs a SM at D <= 128 (launch bounds of 128 registers a thread; see
//    bf16_min_ctas), 1 at D = 256.
//  - The rest is the fp32 instance's: the CTA and its launch order, the
//    cp.async double buffer of K and V, the masks and the skipped blocks,
//    the online softmax in base 2, zeros for a row with no key. The output
//    is the fp32 result rounded to bf16 once, at the store.
// The bf16 instance is not bit for bit the fp32 instance on the widened
// inputs: its fp32 sums run in another order and P_lo drops the bits below
// 2^-17 |P|. Against that fp32 result it is held elementwise within one
// bf16 ulp of the result plus 2^-14 max|v| (flash_attention.py,
// bf16_limit).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 128;    // query rows a CTA
constexpr int BK = 32;     // keys a block
constexpr int NW = 8;      // warps a CTA, 16 rows each
constexpr int NT = 32 * NW;
constexpr int PAD16 = 8;    // bf16 Q, K and V row pitch D + 8
constexpr int SMEM_LIMIT = 232448;
// bf16 row strides lie below this, so that copy_rows16's 32-bit offsets
// (row x stride, row < BQ) stay below 2^31
constexpr long long BF16_STRIDE_LIMIT = 1LL << 24;
static_assert(BQ * BF16_STRIDE_LIMIT <= (1LL << 31), "32-bit offsets");
static_assert(BQ == 16 * NW, "a warp owns the 16 rows of one MMA tile");
static_assert(BK == 32, "the softmax walks 4 n-tiles of 8 keys");

// The CTAs a SM the bf16 instance's launch bounds ask registers for: 2 at
// D <= 128, 1 at D = 256 (whose accumulator alone takes 128 registers a
// thread). Timed at Yi-34B's prefill against 1 at D = 128
// (scripts/flash_knobs.py; PERF.md): a second CTA's warps hide the copies,
// barriers and softmax of the first, which pays for Q's fragments read
// again from shared memory (128 registers a thread).
__host__ __device__ constexpr int bf16_min_ctas(int d) {
  return d <= 128 ? 2 : 1;
}

struct Strides {
  long long b, h, s;
};

// fp32 row pitches in elements (words): Q and K at 16 mod 32, V at 4 mod
// 32, the least above D (D + 16 and D + 4 at D = 64, 128, 256; 80 and 100
// at D = 80), for the bank checks of the notes at the top.
__host__ __device__ constexpr int qk_pitch_f32(int d) {
  return d + (48 - d % 32) % 32;
}

__host__ __device__ constexpr int v_pitch_f32(int d) {
  return d + (36 - d % 32) % 32;
}

// Shared memory of a CTA. fp32: the Q tile and one K block at pitch
// qk_pitch_f32, one V block at v_pitch_f32; bf16: the Q tile, one K and one
// V block, all at D + PAD16.
__host__ __device__ constexpr size_t smem_bytes_f32(int d) {
  return 4 * ((size_t)(BQ + BK) * qk_pitch_f32(d) +
              (size_t)BK * v_pitch_f32(d));
}

__host__ __device__ constexpr size_t smem_bytes_bf16(int d) {
  return 2 * (size_t)(BQ + 2 * BK) * (d + PAD16);
}

template <typename T>
__host__ __device__ constexpr size_t smem_bytes_of(int d) {
  return std::is_same<T, float>::value ? smem_bytes_f32(d)
                                       : smem_bytes_bf16(d);
}

// Built with -DFLASH_PHASE_CLOCKS (scripts/flash_phases.py), lane 0 of the
// last warp of each CTA (the one with the most keys under a causal mask)
// adds up the clock cycles of each phase of a key block; slot N_PHASES
// counts the blocks. flash_attention_phase_cycles reads the sums.
#ifdef FLASH_PHASE_CLOCKS
constexpr int N_PHASES = 4;  // wait for K/V, QK^T, softmax, PV
constexpr int CLOCK_TID = NT - 32;
__device__ unsigned long long phase_cycles[N_PHASES + 1];
#define PHASE_END(i)                    \
  if (tid == CLOCK_TID) {               \
    const long long now = clock64();    \
    clocks[i] += now - last_clock;      \
    last_clock = now;                   \
  }
#else
#define PHASE_END(i)
#endif

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero), bit for bit, in two integer operations. cvt issues on the
// conversion pipe (16 results a clock an SM, against 64 for integer adds
// and logic), and with it the kernel was slower, with the same output.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small, both TF32 (x - big is exact in fp32)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32, the small products first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t bb0,
                                     uint32_t bb1, uint32_t bs0,
                                     uint32_t bs1) {
  mma(c, as, bb0, bb1);
  mma(c, ab, bs0, bs1);
  mma(c, ab, bb0, bb1);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// c += a b on bf16 tensor cores, fp32 accumulation
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory (a 32-bit shared address),
// lanes 8i..8i+7 giving the row addresses of matrix i; r[i] holds (row
// lane / 4, columns 2 (lane % 4) and + 1) of matrix i, or with .trans (rows
// 2 (lane % 4) and + 1, column lane / 4).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}

// (x, y) as two bf16 pairs, x in the low halves: hi = rn(x, y) and
// lo = rn((x, y) - hi), the remainder exact in fp32
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// 16 bytes, zero-filled where !valid (nothing is read then)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

// The same at a 32-bit shared address
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* gmem,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Key blocks [lo, hi) that q tile `tile` walks: those holding a key
// visible to some row of the tile.
__device__ __forceinline__ int2 key_range(int tile, int Sq, int Skv,
                                          int causal, int window) {
  const int q0 = tile * BQ;
  int lo = 0, hi = (Skv + BK - 1) / BK;
  if (causal) hi = min(hi, (min(q0 + BQ, Sq) - 1) / BK + 1);
  if (window > 0) lo = max(0, q0 - window + 1) / BK;
  return make_int2(lo, max(lo, hi));
}

// The q tile at launch rank `rank`: tiles sorted by the key blocks they
// walk, most first; ties in order, the last tile first under a causal
// mask. Each thread places some tiles (n_tiles steps each); the CTA reads
// its own through shared memory.
__device__ int tile_at_rank(int rank, int n_tiles, int Sq, int Skv,
                            int causal, int window, int* pick) {
  for (int u = threadIdx.x; u < n_tiles; u += NT) {
    const int2 ru = key_range(u, Sq, Skv, causal, window);
    const int bu = ru.y - ru.x;
    int pos = 0;
    for (int w = 0; w < n_tiles; ++w) {
      const int2 rw = key_range(w, Sq, Skv, causal, window);
      const int bw = rw.y - rw.x;
      pos += bw > bu || (bw == bu && (causal ? w > u : w < u));
    }
    if (pos == rank) *pick = u;
  }
  __syncthreads();
  const int tile = *pick;
  __syncthreads();
  return tile;
}

// Starts copying rows [r0, r0 + ROWS) of a (rows x D) tensor of T into
// shared memory with row pitch P, zero-filling rows at or past `limit`.
// Where ROWS x V pieces do not divide over NT threads (a K or V block at
// D = 80: 640 pieces), the last pass is ragged.
template <int D, int P, int ROWS, typename T>
__device__ __forceinline__ void copy_rows(T* dst, const T* src,
                                          long long stride, int r0,
                                          int limit) {
  constexpr int E = 16 / sizeof(T);  // elements a 16-byte piece
  constexpr int V = D / E;           // pieces a row
  static_assert(D % E == 0, "rows of whole 16-byte pieces");
#pragma unroll 4
  for (int idx = threadIdx.x; idx < ROWS * V; idx += NT) {
    const int r = idx / V, c = idx - r * V;
    const bool ok = r0 + r < limit;
    cp_async16(dst + r * P + E * c,
               ok ? src + (long long)(r0 + r) * stride + E * c : src, ok);
  }
}

// copy_rows for bf16 rows less than BF16_STRIDE_LIMIT elements apart into
// shared memory at the 32-bit address dst: the first STEP x V threads each
// copy one column of rows STEP apart (STEP = NT / V rows a pass), so only
// its first piece's offsets are computed, and the others' row x stride
// (row < ROWS <= 128) in 32 bits: registers are scarce at 2 CTAs a SM, and
// 64-bit offsets spill at D = 128. Where V does not divide NT (V = 10 at
// D = 80: 25 rows a pass, 6 threads idle) or STEP does not divide ROWS, the
// last pass is ragged.
template <int D, int P, int ROWS>
__device__ __forceinline__ void copy_rows16(uint32_t dst,
                                            const __nv_bfloat16* src,
                                            int stride, int r0, int limit) {
  constexpr int V = D / 8;        // 16-byte pieces a row
  constexpr int STEP = NT / V;    // rows a pass
  constexpr int PASSES = (ROWS + STEP - 1) / STEP;
  constexpr bool EVEN = NT % V == 0 && ROWS % STEP == 0;
  static_assert(D % 8 == 0 && STEP >= 1, "rows of whole 16-byte pieces");
  const int r = threadIdx.x / V, c = threadIdx.x % V;
  dst += 2 * (r * P + 8 * c);
  const __nv_bfloat16* first = src + (long long)(r0 + r) * stride + 8 * c;
#pragma unroll
  for (int i = 0; i < PASSES; ++i) {
    const int row = i * STEP;
    if (EVEN || (r < STEP && r + row < ROWS)) {
      const bool ok = r0 + r + row < limit;
      cp_async16(dst + 2 * row * P, ok ? first + row * stride : src, ok);
    }
  }
}

// Eight output values of one row (columns col .. col + 7) at p
__device__ __forceinline__ void store8(float* p, float4 lo, float4 hi) {
  *reinterpret_cast<float4*>(p) = lo;
  *reinterpret_cast<float4*>(p + 4) = hi;
}

// The fp32 instance: 3xTF32 on mma.sync.m16n8k8.
template <int D>
__global__ void __launch_bounds__(NT, 1)
    flash_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           Strides sq, Strides sk, Strides sv, Strides so,
                           int H, int G, int B, int Sq, int Skv, int causal,
                           int window, float scale_log2) {
  using T = float;
  constexpr int QP = qk_pitch_f32(D), VP = v_pitch_f32(D);
  constexpr int NC = D / 32;  // groups of 4 output n-tiles
  // D = 16 mod 32: a tail of 2 output n-tiles after the groups
  constexpr bool TAIL = D % 32 == 16;
  static_assert(D % 32 == 0 || TAIL, "D a multiple of 16");
  extern __shared__ float4 smem4[];
  T* q_s = reinterpret_cast<T*>(smem4);  // BQ x QP
  T* k_s = q_s + BQ * QP;                // BK x QP
  T* v_s = k_s + BK * QP;                // BK x VP

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // the H x B heads of a q tile together, the heaviest tiles first
  const int n_tiles = (Sq + BQ - 1) / BQ;
  const int hb = blockIdx.x % (H * B);
  const int tile = tile_at_rank(blockIdx.x / (H * B), n_tiles, Sq, Skv,
                                    causal, window,
                                    reinterpret_cast<int*>(q_s));
  const int h = hb % H, b = hb / H, kvh = h / G;
  const int q0 = tile * BQ;
  const int r_lo = q0 + 16 * warp, r_hi = r_lo + 15;  // this warp's rows
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;

  const int2 range = key_range(tile, Sq, Skv, causal, window);
  const int kb_lo = range.x, kb_hi = range.y;

#ifdef FLASH_PHASE_CLOCKS
  long long clocks[N_PHASES] = {};
  long long last_clock = clock64();
#endif

  copy_rows<D, QP, BQ>(q_s, qb, sq.s, q0, Sq);
  if (kb_lo < kb_hi) copy_rows<D, QP, BK>(k_s, kb, sk.s, kb_lo * BK, Skv);
  cp_async_commit();
  if (kb_lo < kb_hi) copy_rows<D, VP, BK>(v_s, vb, sv.s, kb_lo * BK, Skv);
  cp_async_commit();
  cp_async_wait<1>();  // Q and the first K
  __syncthreads();
  PHASE_END(0)

  float acc[NC][4][4];  // [group][n-tile][c0..c3]
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][j][e] = 0.f;
  float acc_t[TAIL ? 2 : 1][4] = {};  // [tail n-tile][c0..c3]
  // running max (base 2) and this lane's share of the sum, rows g and g+8
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const T* q_row = q_s + (16 * warp + g) * QP + 4 * t;
  const T* k_row = k_s + g * QP + 4 * t;
  const T* v_row = v_s + 2 * t * VP + 4 * g;
  const T* vt_row = v_s + 2 * t * VP + 32 * NC + 2 * g;  // the tail's

  for (int blk = kb_lo; blk < kb_hi; ++blk) {
    const int k0 = blk * BK;
    const bool more = blk + 1 < kb_hi;
    const bool skip = r_lo >= Sq || (causal && k0 > r_hi) ||
                      (window > 0 && k0 + BK - 1 <= r_lo - window);
    const bool edge = (causal && k0 + BK - 1 > r_lo) ||
                      (window > 0 && k0 <= r_hi - window) || k0 + BK > Skv;
    float s[4][4];  // [n-tile of 8 keys][c0..c3]

    if (!skip) {
      // S = Q K^T
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll 1
      for (int c = 0; c < D / 16; ++c) {
        const float4 qa = ld4(q_row + 16 * c);
        const float4 qc = ld4(q_row + 8 * QP + 16 * c);
        uint32_t ab0[4], as0[4], ab1[4], as1[4];
        split(qa.x, ab0[0], as0[0]);
        split(qc.x, ab0[1], as0[1]);
        split(qa.y, ab0[2], as0[2]);
        split(qc.y, ab0[3], as0[3]);
        split(qa.z, ab1[0], as1[0]);
        split(qc.z, ab1[1], as1[1]);
        split(qa.w, ab1[2], as1[2]);
        split(qc.w, ab1[3], as1[3]);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float4 kk = ld4(k_row + 8 * n * QP + 16 * c);
          uint32_t xb, xs, yb, ys, zb, zs, wb, ws;
          split(kk.x, xb, xs);
          split(kk.y, yb, ys);
          split(kk.z, zb, zs);
          split(kk.w, wb, ws);
          mma3(s[n], ab0, as0, xb, yb, xs, ys);
          mma3(s[n], ab1, as1, zb, wb, zs, ws);
        }
      }
      PHASE_END(1)

      // online softmax; lane (g, t) holds keys 8n + 2t, 8n + 2t + 1
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale_log2;
          if (edge) {
            const int row = r_lo + g + (e >> 1) * 8;
            const int key = k0 + 8 * n + 2 * t + (e & 1);
            const bool vis = key < Skv && (!causal || key <= row) &&
                             (window <= 0 || key > row - window);
            x = vis ? x : -INFINITY;
          }
          s[n][e] = x;
        }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      // a row with no visible key yet keeps p = 0 and alpha = 0
      const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
      const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
      const float al0 = exp2f(m0 - mu0), al1 = exp2f(m1 - mu1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        s[n][0] = exp2f(s[n][0] - mu0);
        s[n][1] = exp2f(s[n][1] - mu0);
        s[n][2] = exp2f(s[n][2] - mu1);
        s[n][3] = exp2f(s[n][3] - mu1);
        sum0 += s[n][0] + s[n][1];
        sum1 += s[n][2] + s[n][3];
      }
      l0 = l0 * al0 + sum0;
      l1 = l1 * al1 + sum1;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[c][j][0] *= al0;
          acc[c][j][1] *= al0;
          acc[c][j][2] *= al1;
          acc[c][j][3] *= al1;
        }
      if constexpr (TAIL) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          acc_t[j][0] *= al0;
          acc_t[j][1] *= al0;
          acc_t[j][2] *= al1;
          acc_t[j][3] *= al1;
        }
      }
      PHASE_END(2)
    }

    cp_async_wait<0>();  // V of this block
    __syncthreads();     // every warp is done with K
    if (more) copy_rows<D, QP, BK>(k_s, kb, sk.s, k0 + BK, Skv);
    cp_async_commit();
    PHASE_END(0)

    if (!skip) {
      // O += P V, k-step n over keys 8n .. 8n + 7
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        uint32_t pb[4], ps[4];
        split(s[n][0], pb[0], ps[0]);
        split(s[n][2], pb[1], ps[1]);
        split(s[n][1], pb[2], ps[2]);
        split(s[n][3], pb[3], ps[3]);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 v0 = ld4(v_row + 8 * n * VP + 32 * c);
          const float4 v1 = ld4(v_row + (8 * n + 1) * VP + 32 * c);
          uint32_t b0[4], s0[4], b1[4], s1[4];
          split(v0.x, b0[0], s0[0]);
          split(v0.y, b0[1], s0[1]);
          split(v0.z, b0[2], s0[2]);
          split(v0.w, b0[3], s0[3]);
          split(v1.x, b1[0], s1[0]);
          split(v1.y, b1[1], s1[1]);
          split(v1.z, b1[2], s1[2]);
          split(v1.w, b1[3], s1[3]);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma3(acc[c][j], pb, ps, b0[j], b1[j], s0[j], s1[j]);
          // keeps the compiler from hoisting the next groups' V loads,
          // whose registers would spill beside the 128 of the accumulator
          __syncwarp();
        }
        if constexpr (TAIL) {
          const float2 v0 = ld2(vt_row + 8 * n * VP);
          const float2 v1 = ld2(vt_row + (8 * n + 1) * VP);
          uint32_t xb0, xs0, yb0, ys0, xb1, xs1, yb1, ys1;
          split(v0.x, xb0, xs0);
          split(v0.y, yb0, ys0);
          split(v1.x, xb1, xs1);
          split(v1.y, yb1, ys1);
          mma3(acc_t[0], pb, ps, xb0, xb1, xs0, xs1);
          mma3(acc_t[1], pb, ps, yb0, yb1, ys0, ys1);
        }
      }
      PHASE_END(3)
    }

    cp_async_wait<0>();  // K of the next block
    __syncthreads();     // every warp is done with V
    if (more) copy_rows<D, VP, BK>(v_s, vb, sv.s, k0 + BK, Skv);
    cp_async_commit();
    PHASE_END(0)
  }
  cp_async_wait<0>();

#ifdef FLASH_PHASE_CLOCKS
  if (tid == CLOCK_TID) {
    for (int i = 0; i < N_PHASES; ++i)
      atomicAdd(&phase_cycles[i], (unsigned long long)clocks[i]);
    atomicAdd(&phase_cycles[N_PHASES], (unsigned long long)(kb_hi - kb_lo));
  }
#endif

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  T* ob = o + b * so.b + h * so.h;
  const int row0 = r_lo + g, row1 = row0 + 8;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = 32 * c + 8 * t;
    if (row0 < Sq)
      store8(ob + row0 * so.s + col,
             make_float4(acc[c][0][0] * inv0, acc[c][1][0] * inv0,
                         acc[c][2][0] * inv0, acc[c][3][0] * inv0),
             make_float4(acc[c][0][1] * inv0, acc[c][1][1] * inv0,
                         acc[c][2][1] * inv0, acc[c][3][1] * inv0));
    if (row1 < Sq)
      store8(ob + row1 * so.s + col,
             make_float4(acc[c][0][2] * inv1, acc[c][1][2] * inv1,
                         acc[c][2][2] * inv1, acc[c][3][2] * inv1),
             make_float4(acc[c][0][3] * inv1, acc[c][1][3] * inv1,
                         acc[c][2][3] * inv1, acc[c][3][3] * inv1));
  }
  if constexpr (TAIL) {
    const int col = 32 * NC + 4 * t;
    if (row0 < Sq)
      *reinterpret_cast<float4*>(ob + row0 * so.s + col) =
          make_float4(acc_t[0][0] * inv0, acc_t[1][0] * inv0,
                      acc_t[0][1] * inv0, acc_t[1][1] * inv0);
    if (row1 < Sq)
      *reinterpret_cast<float4*>(ob + row1 * so.s + col) =
          make_float4(acc_t[0][2] * inv1, acc_t[1][2] * inv1,
                      acc_t[0][3] * inv1, acc_t[1][3] * inv1);
  }
}

// The bf16 instance: bf16 products on mma.sync.m16n8k16, P as two bf16
// parts (see the notes at the top). Same phases, masks, skips and softmax
// as the fp32 instance, with key blocks of BK; written apart so that the
// fp32 instance's instructions stay as they were (RecurrentGemma's prefill
// check reads it near its limit).
template <int D>
__global__ void __launch_bounds__(NT, bf16_min_ctas(D))
    flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                __nv_bfloat16* __restrict__ o, Strides sq,
                                Strides sk, Strides sv, Strides so, int H,
                                int G, int B, int Sq, int Skv, int causal,
                                int window, float scale_log2) {
  using T = __nv_bfloat16;
  constexpr int P = D + PAD16;     // row pitch of Q, K and V
  constexpr int KS = D / 16;       // k-steps of QK^T
  constexpr int NS = BK / 8;     // n-tiles of S (8 keys each)
  constexpr int NO = D / 8;        // n-tiles of O (8 columns each)
  // Q's fragments in registers where the launch bounds leave room: D / 4
  // a thread beside the D / 2 of the accumulator
  constexpr bool Q_REGS = D * bf16_min_ctas(D) <= 128;
  extern __shared__ float4 smem4[];
  // Q (BQ x P), then K and V (BK x P each), by 32-bit shared address
  int* pick = reinterpret_cast<int*>(smem4);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = (Sq + BQ - 1) / BQ;
  const int hb = blockIdx.x % (H * B);
  const int tile = tile_at_rank(blockIdx.x / (H * B), n_tiles, Sq,
                                      Skv, causal, window, pick);
  const int h = hb % H, b = hb / H, kvh = h / G;
  const int q0 = tile * BQ;
  const int r_lo = q0 + 16 * warp, r_hi = r_lo + 15;  // this warp's rows
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;

  const int2 range = key_range(tile, Sq, Skv, causal, window);
  const int kb_lo = range.x, kb_hi = range.y;

#ifdef FLASH_PHASE_CLOCKS
  long long clocks[N_PHASES] = {};
  long long last_clock = clock64();
#endif

  const uint32_t q_sa =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem4));
  const uint32_t k_sa = q_sa + 2 * BQ * P, v_sa = k_sa + 2 * BK * P;
  copy_rows16<D, P, BQ>(q_sa, qb, (int)sq.s, q0, Sq);
  if (kb_lo < kb_hi)
    copy_rows16<D, P, BK>(k_sa, kb, (int)sk.s, kb_lo * BK, Skv);
  cp_async_commit();
  if (kb_lo < kb_hi)
    copy_rows16<D, P, BK>(v_sa, vb, (int)sv.s, kb_lo * BK, Skv);
  cp_async_commit();
  cp_async_wait<1>();  // Q and the first K
  __syncthreads();
  PHASE_END(0)

  // ldmatrix row addresses of this lane. Q (A): matrices (rows 0-7, d 0-7),
  // (rows 8-15, d 0-7), (rows 0-7, d 8-15), (rows 8-15, d 8-15) of a
  // k-step: a0..a3. K (B, as stored): (keys 0-7, d 0-7), (keys 0-7,
  // d 8-15), (keys 8-15, d 0-7), (keys 8-15, d 8-15): b0, b1 of two
  // n-tiles. V (B, transposed): (keys 0-7, cols 0-7), (keys 8-15, cols
  // 0-7), (keys 0-7, cols 8-15), (keys 8-15, cols 8-15): b0, b1 of two
  // n-tiles of O. 32-bit shared addresses in bytes (2 an element): the
  // offsets of the unrolled loops below fold into the instructions.
  const uint32_t q_ld =
      q_sa + 2 * ((16 * warp + (lane & 15)) * P + 8 * (lane >> 4));
  const uint32_t k_ld =
      k_sa + 2 * (((lane & 7) + 8 * (lane >> 4)) * P + 8 * ((lane >> 3) & 1));
  const uint32_t v_ld = v_sa + 2 * ((lane & 15) * P + 8 * (lane >> 4));

  uint32_t qf[Q_REGS ? KS : 1][4];
  if constexpr (Q_REGS) {
#pragma unroll
    for (int c = 0; c < KS; ++c) ldsm_x4(qf[c], q_ld + 2 * 16 * c);
  }

  float acc[NO][4];  // [n-tile of 8 columns][c0..c3]
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // running max (base 2) and this lane's share of the sum, rows g and g+8
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int blk = kb_lo; blk < kb_hi; ++blk) {
    const int k0 = blk * BK;
    const bool more = blk + 1 < kb_hi;
    const bool skip = r_lo >= Sq || (causal && k0 > r_hi) ||
                      (window > 0 && k0 + BK - 1 <= r_lo - window);
    const bool edge = (causal && k0 + BK - 1 > r_lo) ||
                      (window > 0 && k0 <= r_hi - window) || k0 + BK > Skv;
    float s[NS][4];  // [n-tile of 8 keys][c0..c3]

    if (!skip) {
      // S = Q K^T (Q from shared memory: unrolled by 2, which 128
      // registers a thread hold without spilling)
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll(Q_REGS ? KS : 2)
      for (int c = 0; c < KS; ++c) {
        uint32_t a[4];
        if constexpr (Q_REGS) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = qf[c][i];
        } else {
          ldsm_x4(a, q_ld + 2 * 16 * c);
        }
#pragma unroll
        for (int n = 0; n < NS; n += 2) {
          uint32_t kf[4];
          ldsm_x4(kf, k_ld + 2 * (8 * n * P + 16 * c));
          mma16(s[n], a, kf[0], kf[1]);
          mma16(s[n + 1], a, kf[2], kf[3]);
        }
      }
      PHASE_END(1)

      // online softmax; lane (g, t) holds keys 8n + 2t, 8n + 2t + 1
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale_log2;
          if (edge) {
            const int row = r_lo + g + (e >> 1) * 8;
            const int key = k0 + 8 * n + 2 * t + (e & 1);
            const bool vis = key < Skv && (!causal || key <= row) &&
                             (window <= 0 || key > row - window);
            x = vis ? x : -INFINITY;
          }
          s[n][e] = x;
        }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      // a row with no visible key yet keeps p = 0 and alpha = 0
      const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
      const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
      const float al0 = exp2f(m0 - mu0), al1 = exp2f(m1 - mu1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        s[n][0] = exp2f(s[n][0] - mu0);
        s[n][1] = exp2f(s[n][1] - mu0);
        s[n][2] = exp2f(s[n][2] - mu1);
        s[n][3] = exp2f(s[n][3] - mu1);
        sum0 += s[n][0] + s[n][1];
        sum1 += s[n][2] + s[n][3];
      }
      l0 = l0 * al0 + sum0;
      l1 = l1 * al1 + sum1;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        acc[j][0] *= al0;
        acc[j][1] *= al0;
        acc[j][2] *= al1;
        acc[j][3] *= al1;
      }
      PHASE_END(2)
    }

    cp_async_wait<0>();  // V of this block
    __syncthreads();     // every warp is done with K
    // the K and V bases are computed again at each refill, not held in
    // registers across the loop
    if (more)
      copy_rows16<D, P, BK>(k_sa, k + b * sk.b + kvh * sk.h, (int)sk.s,
                              k0 + BK, Skv);
    cp_async_commit();
    PHASE_END(0)

    if (!skip) {
      // O += P_lo V + P_hi V, k-step kk over keys 16kk .. 16kk + 15: the S
      // accumulators of n-tiles 2kk and 2kk + 1 are P's A fragment
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        uint32_t ph[4], pl[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int j = 0; j < NO; j += 2) {
          uint32_t vf[4];
          ldsm_x4_trans(vf, v_ld + 2 * (16 * kk * P + 8 * j));
          mma16(acc[j], pl, vf[0], vf[1]);
          mma16(acc[j + 1], pl, vf[2], vf[3]);
          mma16(acc[j], ph, vf[0], vf[1]);
          mma16(acc[j + 1], ph, vf[2], vf[3]);
        }
      }
      PHASE_END(3)
    }

    cp_async_wait<0>();  // K of the next block
    __syncthreads();     // every warp is done with V
    if (more)
      copy_rows16<D, P, BK>(v_sa, v + b * sv.b + kvh * sv.h, (int)sv.s,
                              k0 + BK, Skv);
    cp_async_commit();
    PHASE_END(0)
  }
  cp_async_wait<0>();

#ifdef FLASH_PHASE_CLOCKS
  if (tid == CLOCK_TID) {
    for (int i = 0; i < N_PHASES; ++i)
      atomicAdd(&phase_cycles[i], (unsigned long long)clocks[i]);
    atomicAdd(&phase_cycles[N_PHASES], (unsigned long long)(kb_hi - kb_lo));
  }
#endif

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  T* ob = o + b * so.b + h * so.h;
  const int row0 = r_lo + g, row1 = row0 + 8;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int col = 8 * j + 2 * t;
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * so.s + col) =
          __floats2bfloat162_rn(acc[j][0] * inv0, acc[j][1] * inv0);
    if (row1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row1 * so.s + col) =
          __floats2bfloat162_rn(acc[j][2] * inv1, acc[j][3] * inv1);
  }
}

// The instance for elements of type T at head dim D.
template <int D, typename T>
constexpr auto kernel_of() {
  if constexpr (std::is_same<T, float>::value)
    return flash_attention_kernel<D>;
  else
    return flash_attention_bf16_kernel<D>;
}

template <int D, typename T>
bool prepare(size_t* smem) {
  static_assert(smem_bytes_of<T>(D) <= SMEM_LIMIT,
                "the tiles fit one CTA's shared memory");
  *smem = smem_bytes_of<T>(D);
  return cudaFuncSetAttribute(kernel_of<D, T>(),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem) == cudaSuccess;
}

template <int D, typename T>
int max_active() {
  size_t smem = 0;
  if (!prepare<D, T>(&smem)) return -(int)cudaGetLastError();
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, kernel_of<D, T>(), NT, smem);
  return err == cudaSuccess ? n : -(int)err;
}

// The last launch: CTAs, threads, shared bytes.
int last_launch[3] = {};

template <int D, typename T>
int launch(const T* q, const T* k, const T* v, T* o, Strides sq, Strides sk,
           Strides sv, Strides so, int B, int H, int G, int Sq, int Skv,
           int causal, int window, float scale_log2, cudaStream_t stream) {
  size_t smem = 0;
  if (!prepare<D, T>(&smem)) return (int)cudaGetLastError();
  const long long ctas = (long long)((Sq + BQ - 1) / BQ) * H * B;
  if (ctas < 1 || ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const auto kernel = kernel_of<D, T>();
  kernel<<<(unsigned)ctas, NT, smem, stream>>>(
      q, k, v, o, sq, sk, sv, so, H, G, B, Sq, Skv, causal, window,
      scale_log2);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) {
    last_launch[0] = (int)ctas;
    last_launch[1] = NT;
    last_launch[2] = (int)smem;
  }
  return (int)err;
}

template <typename F>
int dispatch(int D, F&& f) {
  switch (D) {
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return -1;
  }
}

template <typename T>
int forward(const T* q, const T* k, const T* v, T* o, long long sqb,
            long long sqh, long long sqs, long long skb, long long skh,
            long long sks, long long svb, long long svh, long long svs,
            long long sob, long long soh, long long sos, int B, int H, int KV,
            int Sq, int Skv, int D, int causal, int window, float scale,
            cudaStream_t stream) {
  const Strides sq{sqb, sqh, sqs}, sk{skb, skh, sks}, sv{svb, svh, svs},
      so{sob, soh, sos};
  const int G = H / KV;
  const float scale_log2 = scale * 1.4426950408889634f;
  return dispatch(D, [&](auto dim) {
    return launch<decltype(dim)::value, T>(q, k, v, o, sq, sk, sv, so, B, H,
                                           G, Sq, Skv, causal, window,
                                           scale_log2, stream);
  });
}

}  // namespace

extern "C" {

int flash_attention_rows(void) { return BQ; }

int flash_attention_key_block(void) { return BK; }

int flash_attention_threads(void) { return NT; }

// Shared memory of one CTA at head dim d for elements of el bytes (4:
// fp32, 2: bf16).
int flash_attention_smem_bytes(int d, int el) {
  return (int)(el == 2 ? smem_bytes_bf16(d) : smem_bytes_f32(d));
}

// The last launch's CTAs, threads and shared bytes, into out[3].
void flash_attention_last_launch(int* out) {
  for (int i = 0; i < 3; ++i) out[i] = last_launch[i];
}

// Resident CTAs per SM at head dim d for elements of el bytes, or minus a
// CUDA error (-1 for a head dim or an element size it was not built for).
int flash_attention_max_active(int d, int el) {
  if (el != 4 && el != 2) return -1;
  return dispatch(d, [el](auto dim) {
    constexpr int D = decltype(dim)::value;
    return el == 4 ? max_active<D, float>() : max_active<D, __nv_bfloat16>();
  });
}

// q, o: (B,H,Sq,D); k, v: (B,KV,Skv,D), all fp32; element strides per
// tensor for (b, head, s), the last dim contiguous and rows 16-byte
// aligned. window <= 0 means none. Returns a CUDA error code, or -1 for a
// head dim it was not built for.
int flash_attention_fwd(const float* q, const float* k, const float* v,
                        float* o, long long sqb, long long sqh, long long sqs,
                        long long skb, long long skh, long long sks,
                        long long svb, long long svh, long long svs,
                        long long sob, long long soh, long long sos, int B,
                        int H, int KV, int Sq, int Skv, int D, int causal,
                        int window, float scale, cudaStream_t stream) {
  return forward(q, k, v, o, sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, sob,
                 soh, sos, B, H, KV, Sq, Skv, D, causal, window, scale,
                 stream);
}

// flash_attention_fwd on bf16 q, k, v and o, on bf16 tensor cores with P
// in two bf16 parts; the fp32 result rounded to bf16 to nearest even.
int flash_attention_fwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                             const __nv_bfloat16* v, __nv_bfloat16* o,
                             long long sqb, long long sqh, long long sqs,
                             long long skb, long long skh, long long sks,
                             long long svb, long long svh, long long svs,
                             long long sob, long long soh, long long sos,
                             int B, int H, int KV, int Sq, int Skv, int D,
                             int causal, int window, float scale,
                             cudaStream_t stream) {
  // q, k and v rows are copied through 32-bit offsets (copy_rows16)
  if (sqs >= BF16_STRIDE_LIMIT || sks >= BF16_STRIDE_LIMIT ||
      svs >= BF16_STRIDE_LIMIT)
    return (int)cudaErrorInvalidValue;
  return forward(q, k, v, o, sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, sob,
                 soh, sos, B, H, KV, Sq, Skv, D, causal, window, scale,
                 stream);
}

#ifdef FLASH_PHASE_CLOCKS
// Copies the phase sums (cycles over all CTAs, then the key blocks walked)
// to host memory and zeroes them.
int flash_attention_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, phase_cycles,
                                         sizeof(phase_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[N_PHASES + 1] = {};
  return (int)cudaMemcpyToSymbol(phase_cycles, zero, sizeof(zero));
}
#endif

}  // extern "C"
