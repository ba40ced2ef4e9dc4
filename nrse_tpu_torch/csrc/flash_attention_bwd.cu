// Flash gated attention with a Toeplitz position bias, backward (K5's dq
// and dk/dv kernels), on wgmma fed by TMA.
//
// Replaces: nrse_tpu/ops/flash_attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (the Pallas TPU kernels for 384 < T, t_pad <= 3072) and
// their streamed variants ::_bwd_dq_streamed_kernel and
// ::_bwd_dkv_streamed_kernel (t_pad > 3072, K/V blocks streamed from HBM
// because VMEM holds a head's K/V only up to there).  One pair serves every
// T up to 65536 here: the streamed operands always pass through a ring in
// shared memory.
//
// Computes, per (batch b, head h), from K5's saved out and lse, over the
// keys padded as the forward pads them (t_pad = 128 * ceil(T / 128)):
//   delta[i] = sum_d do[i,d] * out[i,d]                (f32, a pre-pass)
//   s[i,j]  = (q[i] . k[j]) * d^-1/2 + gate[b,h,i] * bias[h, min(T-1+j-i,
//             2T-1)] + madd[b,j]
//   p       = exp(s - lse[i]),  dp[i,j] = do[i] . v[j]
//   ds      = p * (dp - delta[i])
//   dv[j]   = sum_i bf16(p[i,j]) * do[i]
//   dq[i]   = sum_j bf16(ds[i,j]) * k[j] * d^-1/2
//   dk[j]   = sum_i bf16(ds[i,j]) * q[i] * d^-1/2
//   dgate[b,h,i] = sum_j ds[i,j] * bias[h, min(T-1+j-i, 2T-1)]
//   dbias[h, min(T-1+j-i, 2T-1)] += gate[b,h,i] * ds[b,h,i,j]  (over b, i
//             and the t_pad keys j: each generator entry sums its diagonal
//             of every batch's [T, t_pad]; the padded keys' entries past
//             the generator's end fold onto its last, as the JAX wrapper's
//             edge pad does)
// as the TPU kernels do: p and ds rounded to bf16 before the products that
// take them, f32 accumulation, dbias in f32 (the wrapper casts it to the
// generator's dtype, as _flash_core_bwd does).  The padded keys change
// nothing for a row with a valid key (its p there is 0); for a row whose
// keys are all padded (lse = -1e9, p = 1) their ds = -delta enters dgate
// and dbias, as in JAX.
//
// What bounds it on the H100: the five T x T x D products (s, dp, dv, dk,
// dq; s and dp are recomputed by both kernels, seven in all) are at the
// trainer's shape (B=32, H=16, T=499, D=64) 82 GFLOP, ~83 us at the tensor
// cores' bf16 rate, against ~65 MB of q, k, v, out, do, dq, dk, dv (~20 us
// of HBM time): compute, growing as T^2.  The elementwise softmax work
// between the products, the diagonal sums of gate * ds and the tile loads
// are what is left to hide.
//
// Design.  The TPU's dq kernel accumulates each (head, query block)'s dbias
// window in one VMEM block revisited along a sequential batch axis; Hopper
// blocks run in no order and the port takes no float atomics (two calls
// give the same bits).  So, as K3 (block_attention_bwd.cu) splits it:
//   * a pre-pass forms delta (8 threads a row, a fixed tree:
//     ops/flash_attention.py::bwd_delta), in the dq entry, before both
//     kernels;
//   * both kernels are persistent (the wrapper's grid, at most one block an
//     SM, walking 128-row tiles of every (b, h): ops/flash_attention.py::
//     k5_plan) and have a producer warpgroup (setmaxnreg 40) and two
//     consumer warpgroups (setmaxnreg 232) of 64 rows each; ptxas still
//     compiles the consumers within the 168 registers a thread of a
//     384-thread block has at launch, so each keeps one stage's products
//     in flight at a time and the two warpgroups' products and softmax
//     work interleave on the SM.  The producer's first thread TMA-loads
//     each tile's resident tiles (once the consumers have released the
//     last tile's) and the streamed tiles into a ring of 4 stages
//     (128-byte swizzle, boxes from [B*H, T, 64] maps whose geometry the
//     wrapper passes, rows past T as zeros); all 128 of its threads fill
//     each stage's per-row vectors and its slice of the bias generator
//     (the 191 entries T - 1 + k - q of the stage's (query, key) pairs, in
//     f32, clamped to the generator), so shared memory does not grow with
//     T, from loads two stages ahead (when loaded as a stage was stored,
//     their latency paced the ring).  Outputs go through staging boxes of
//     their own by TMA stores, so a tile's epilogue overlaps the next
//     tile's loads;
//   * dk/dv kernel: tiles of 128 keys below T, K and V resident, Q and dO
//     tiles of 64 queries (with gate, lse, delta) streamed.  Per stage a
//     consumer starts S^T as the bias (gate * bias + madd, in units of
//     q . k: the scale is 1/8 at D = 64), S^T += K Q^T and dP^T = V dO^T
//     are four wgmma.m64n64k16 each, p^T and ds^T are formed in registers,
//     and bf16(p^T), bf16(ds^T) are the register A operands of dv += p^T .
//     dO and dk += ds^T . Q (dO and Q read MN-major);
//   * dq kernel: tiles of 128 queries, Q and dO resident, K and V tiles of
//     64 keys (with the key mask) streamed over the t_pad keys.  S and dP
//     as above, dgate summed in registers, dq += bf16(ds) . K (K read
//     MN-major).  gate * ds goes to a 64 x 72 f32 tile of the consumer's,
//     and while that dq product runs the consumer sums the tile's 127
//     diagonals: thread 2x + h takes rows 32h .. 32h + 31 of the wrapped
//     diagonal x (column (r + x + 1) % 64), whose wrapped part (diagonal
//     x - 63) completes its window entry with the carry of the last key
//     tile and whose other part (diagonal x + 1) is the next carry, the
//     halves joined by a lane shuffle.  Each entry of the consumer's
//     window of t_pad + 63 sums is written once, in order;
//   * a fold kernel sums those windows over the batch and the 64-query
//     windows, in a fixed order (eight fixed slices, then their sums in
//     order), onto the [H, 2T] generator.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "wgmma_common.cuh"

namespace {

using namespace nrse::wg;
using bf16 = __nv_bfloat16;

constexpr int kD = 64;
constexpr int kMaxT = 65536;
constexpr int kPad = 128;  // keys are padded to a multiple of 128
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kBoxBytes = 64 * kD * 2;     // 64 rows: 8 KB
constexpr int kTileBytes = 2 * kBoxBytes;  // 128 rows: 16 KB
constexpr int kStages = 4;
constexpr int kSliceLd = 192;  // f32 bias slice of a stage (191 used)
constexpr int kGdsLd = 72;     // f32 row of the gate * ds tile
constexpr float kMasked = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;

// dq kernel: Q and dO (128 rows each), the ring (K, V; key masks; bias
// slices), the consumers' gate * ds tiles, dq's staging boxes, the
// barriers (the resident tiles' full and empty, the ring's)
constexpr int kDqQOff = 0;
constexpr int kDqDoOff = kTileBytes;
constexpr int kDqKVOff = 2 * kTileBytes;  // stage s: K, then V
constexpr int kDqMaddOff = kDqKVOff + kStages * kTileBytes;
constexpr int kDqBiasOff = kDqMaddOff + kStages * 64 * 4;
constexpr int kDqGdsOff = kDqBiasOff + kStages * kSliceLd * 4;
constexpr int kDqStgOff = kDqGdsOff + kConsumers * 64 * kGdsLd * 4;
constexpr int kDqBarOff = kDqStgOff + kConsumers * kBoxBytes;
constexpr int kDqSmem = 1024 + kDqBarOff + 8 * (2 + 2 * kStages);
static_assert(kDqSmem == 156752, "ops/flash_attention.py::DQ_SMEM");

// dk/dv kernel: K and V (128 rows each), the ring (Q, dO; gate, lse,
// delta; bias slices), dk's and dv's staging boxes, the barriers
constexpr int kKOff = 0;
constexpr int kVOff = kTileBytes;
constexpr int kDkvQOff = 2 * kTileBytes;  // stage s: Q, then dO
constexpr int kRowsOff = kDkvQOff + kStages * kTileBytes;
constexpr int kDkvBiasOff = kRowsOff + kStages * 3 * 64 * 4;
constexpr int kDkvStgOff = kDkvBiasOff + kStages * kSliceLd * 4;  // dk, dv
constexpr int kDkvBarOff = kDkvStgOff + 2 * kConsumers * kBoxBytes;
constexpr int kDkvSmem = 1024 + kDkvBarOff + 8 * (2 + 2 * kStages);
static_assert(kDkvSmem == 138320, "ops/flash_attention.py::DKV_SMEM");

struct Args {
  const float* gate;   // [B*H, T]
  const bf16* bias;    // [H, 2T]
  const float* madd;   // [B, T]
  const float* lse;    // [B*H, T]
  const float* delta;  // [B*H, T]
  float* dgate;        // [B*H, T]
  float* partial;      // [B*H, t_pad / 64, t_pad + 63] gate * ds windows
  int H, T, t_pad;
  int tiles;   // 128-row tiles of all (b, h): the kernel's work
  int per_bh;  // tiles of one (b, h); tile = bh * per_bh + row tile
  float scale;
};

// The block's n-th tile (persistent blocks take tiles blockIdx.x + n
// gridDim.x): its (b, h) and first row.
struct Tile {
  int bh, row0;
  bool valid;
};

__device__ __forceinline__ Tile tile_of(const Args& a, int n) {
  const int tile = blockIdx.x + n * static_cast<int>(gridDim.x);
  const int bh = tile / a.per_bh;
  return {bh, (tile - bh * a.per_bh) * 128, tile < a.tiles};
}

__device__ __forceinline__ int block_tiles(const Args& a) {
  const int grid = static_cast<int>(gridDim.x);
  return (a.tiles - static_cast<int>(blockIdx.x) + grid - 1) / grid;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ void release(uint64_t* bar) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// acc += A . B over four 16-row steps: A the register fragments, B a
// 64-row tile read MN-major (its rows are the steps' columns); issued, not
// committed.
__device__ __forceinline__ void mma_rs_tile(float (&acc)[32],
                                            const uint32_t (&a)[16],
                                            uint64_t desc_b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t f[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                           a[4 * kk + 3]};
    wgmma_m64n64k16_rs(acc, f, desc_b + 128 * kk, 1);
  }
}

// s += A . B^T and dp += C . D^T over the head dim, all four 64-row
// K-major tiles; issued and committed as one group, after the caller's
// wgmma.fence (every register a batch of products touches is fenced before
// its first product: one defined inside the batch serializes them).
__device__ __forceinline__ void mma_two(float (&s)[32], uint64_t a,
                                        uint64_t b, float (&dp)[32],
                                        uint64_t c, uint64_t d) {
#pragma unroll
  for (int k = 0; k < kD / 16; ++k) wgmma_m64n64k16(s, a + 2 * k, b + 2 * k, 1);
#pragma unroll
  for (int k = 0; k < kD / 16; ++k)
    wgmma_m64n64k16(dp, c + 2 * k, d + 2 * k, 1);
  wgmma_commit();
}

// The thread's 64 rows x 64 columns of an accumulator (scaled, bf16) into
// the warpgroup's 8 KB staging box under the maps' 128-byte swizzle.
__device__ __forceinline__ void stage_rows(uint8_t* box, const float (&x)[32],
                                           float scale, int row0) {
  const int c0 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row0 + 8 * hf;
#pragma unroll
    for (int jd = 0; jd < kD / 8; ++jd) {
      *reinterpret_cast<uint32_t*>(box + row * 128 + ((jd ^ (row & 7)) << 4) +
                                   2 * c0) =
          pack_bf16(x[4 * jd + 2 * hf] * scale,
                    x[4 * jd + 2 * hf + 1] * scale);
    }
  }
}

// resident[0]: the tile's resident tiles arrived; resident[1]: the
// consumers no longer read them (one arrival a consumer warp)
__device__ __forceinline__ void init_barriers(uint64_t* resident,
                                              uint64_t* full,
                                              uint64_t* empty) {
  if (threadIdx.x == 0) {
    mbar_init(&resident[0], 1);
    mbar_init(&resident[1], kConsumers * 4);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 128);  // the producer's threads; + the copies
      mbar_init(&empty[s], kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// ---------------------------------------------------------------------
// delta = rowsum(do * out): 8 threads a row, each 8 columns in order, then
// a fixed tree over the row's lanes.

constexpr int kDeltaThreads = 256;

__global__ void __launch_bounds__(kDeltaThreads)
flash_attention_bwd_delta_kernel(const bf16* __restrict__ dout,
                                 const bf16* __restrict__ out,
                                 float* __restrict__ delta, int rows) {
  const int tid = blockIdx.x * kDeltaThreads + threadIdx.x;
  const int row = tid >> 3;
  const int col = 8 * (tid & 7);
  float sum = 0.f;
  if (row < rows) {
    const size_t idx = static_cast<size_t>(row) * kD + col;
    const uint4 dv = *reinterpret_cast<const uint4*>(dout + idx);
    const uint4 ov = *reinterpret_cast<const uint4*>(out + idx);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 d = __bfloat1622float2(d2[e]);
      const float2 o = __bfloat1622float2(o2[e]);
      sum = fmaf(d.x, o.x, sum);  // bf16 products: exact in f32
      sum = fmaf(d.y, o.y, sum);
    }
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  sum += __shfl_xor_sync(0xffffffffu, sum, 4);
  if (row < rows && col == 0) delta[row] = sum;
}

// ---------------------------------------------------------------------
// The dq kernel: persistent blocks over the (b, h, 128-query tile) tiles.

// A producer thread's share of a dq stage's key mask and bias slice, loaded
// two stages before the producer stores it; f is the block's stage: key
// tile f % nk of its tile f / nk (zeros past its last).
struct DqStageVals {
  float b0, b1, m;
};

__device__ __forceinline__ DqStageVals dq_fetch(const Args& a, int f, int nk,
                                                int pt, float inv) {
  DqStageVals v = {0.f, 0.f, 0.f};
  const Tile tl = tile_of(a, f / nk);
  if (!tl.valid) return v;
  const int T = a.T;
  const int b = tl.bh / a.H;
  const int k0 = (f % nk) * 64;
  // the bias of (query q0 + r, key k0 + c) is slice[c - r + 127]
  const bf16* brow = a.bias + static_cast<size_t>(tl.bh - b * a.H) * 2 * T;
  const int base = T - 1 + k0 - tl.row0 - 127;
  v.b0 = __bfloat162float(brow[min(max(base + pt, 0), 2 * T - 1)]);
  if (pt + 128 < kSliceLd - 1) {
    v.b1 = __bfloat162float(brow[min(max(base + pt + 128, 0), 2 * T - 1)]);
  }
  if (pt < 64) {
    // the key mask in the scores' units; keys T .. t_pad - 1 are JAX's
    // padding
    v.m = (k0 + pt < T ? a.madd[static_cast<size_t>(b) * T + k0 + pt]
                       : kMasked) * inv;
  }
  return v;
}

// Its producer warpgroup: a tile's Q and dO, then each stage's K and V (its
// first thread, by TMA), key mask and bias slice (all 128 threads).
__device__ __forceinline__ void dq_produce(const CUtensorMap* tmq,
                                           const CUtensorMap* tmdo,
                                           const CUtensorMap* tmk,
                                           const CUtensorMap* tmv,
                                           const Args& a, uint8_t* smem,
                                           uint64_t* resident,
                                           uint64_t* full, uint64_t* empty) {
  const int nk = a.t_pad / 64;
  const float inv = 1.f / a.scale;
  const int pt = threadIdx.x - kConsumers * 128;
  const int total = nk * block_tiles(a);
  float* madd_s = reinterpret_cast<float*>(smem + kDqMaddOff);
  float* bias_s = reinterpret_cast<float*>(smem + kDqBiasOff);
  DqStageVals cur = dq_fetch(a, 0, nk, pt, inv);
  DqStageVals nxt = dq_fetch(a, 1, nk, pt, inv);
  for (int f = 0; f < total; ++f) {
    const int n = f / nk;
    const int i = f - n * nk;
    const Tile tl = tile_of(a, n);
    const int s = f % kStages;
    if (i == 0 && pt == 0) {
      mbar_wait(&resident[1], (n & 1) ^ 1);
      mbar_expect_tx(&resident[0], 2 * kTileBytes);
      tma_load_3d(smem + kDqQOff, tmq, 0, tl.row0, tl.bh, &resident[0]);
      tma_load_3d(smem + kDqDoOff, tmdo, 0, tl.row0, tl.bh, &resident[0]);
    }
    mbar_wait(&empty[s], ((f / kStages) & 1) ^ 1);
    if (pt < 64) madd_s[s * 64 + pt] = cur.m;
    bias_s[s * kSliceLd + pt] = cur.b0;
    if (pt + 128 < kSliceLd - 1) bias_s[s * kSliceLd + pt + 128] = cur.b1;
    if (pt == 0) {
      mbar_expect_tx(&full[s], kTileBytes);
      uint8_t* kv = smem + kDqKVOff + s * kTileBytes;
      tma_load_3d(kv, tmk, 0, i * 64, tl.bh, &full[s]);
      tma_load_3d(kv + kBoxBytes, tmv, 0, i * 64, tl.bh, &full[s]);
    } else {
      mbar_arrive(&full[s]);
    }
    cur = nxt;
    nxt = dq_fetch(a, f + 2, nk, pt, inv);
  }
}

// The diagonal sums of a consumer's gate * ds tile: thread 2 x + half takes
// rows 32 half .. 32 half + 31 of the wrapped diagonal x (column (r + x +
// 1) % 64; the halves walk their rows 16 apart, so no two lanes of a pair
// hit one bank), the halves joined by a lane shuffle; its wrapped part
// (diagonal x - 63) completes window entry 64 i + x with the last tile's
// carry, its other part (diagonal x + 1) is the next carry.
__device__ __forceinline__ void diagonal_sums(const float* gds, float* part,
                                              float& carry, int i, int x,
                                              int half) {
  float sa = 0.f, sb = 0.f;
#pragma unroll 8
  for (int st = 0; st < 32; ++st) {
    const int r = half ? 32 + ((st + 16) & 31) : st;
    const int cc = r + x + 1;
    const float v = gds[r * kGdsLd + (cc & 63)];
    if (cc >= 64) {
      sa += v;
    } else {
      sb += v;
    }
  }
  sa += __shfl_xor_sync(0xffffffffu, sa, 1);
  sb += __shfl_xor_sync(0xffffffffu, sb, 1);
  if (half == 0) {
    part[64 * i + x] = carry + sa;
    carry = sb;
  }
}

// A consumer warpgroup: 64 queries of each tile.  A stage's dq product runs
// beside its diagonal sums.  (Summing them beside the next stage's S and dP
// products instead measured no faster.)
__device__ __forceinline__ void dq_consume(const CUtensorMap* tmdq, Args& a,
                                           uint8_t* smem, uint64_t* resident,
                                           uint64_t* full, uint64_t* empty) {
  const int T = a.T;
  const int nk = a.t_pad / 64;
  const float inv = 1.f / a.scale;
  const int c = threadIdx.x / 128;
  const int wtid = threadIdx.x % 128;
  const int lane = threadIdx.x & 31;
  const int wr = (wtid >> 5) * 16 + (lane >> 2);  // row in the warpgroup's 64
  const int r0 = 64 * c + wr;                     // row in the tile's 128
  const int c0 = 2 * (lane & 3);
  const int x = wtid >> 1;    // the wrapped diagonal this thread sums
  const int half = wtid & 1;  // its rows 32 half .. 32 half + 31
  float* gds = reinterpret_cast<float*>(smem + kDqGdsOff) + c * 64 * kGdsLd;
  uint8_t* stg = smem + kDqStgOff + c * kBoxBytes;
  const uint64_t qd = sw128_desc(smem + kDqQOff + c * kBoxBytes);
  const uint64_t dod = sw128_desc(smem + kDqDoOff + c * kBoxBytes);
  int f = 0;  // the block's stage
  for (int n = 0; n < block_tiles(a); ++n) {
    const Tile tl = tile_of(a, n);
    const int q0 = tl.row0;
    // the rows' gate (and in the scores' units), lse (+inf past T: p = 0)
    // and delta
    float gr[2], g[2], lse[2], dl[2], dg[2] = {0.f, 0.f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = q0 + r0 + 8 * hf;
      const bool ok = i < T;
      const size_t r = static_cast<size_t>(tl.bh) * T + i;
      gr[hf] = ok ? a.gate[r] : 0.f;
      g[hf] = gr[hf] * inv;
      lse[hf] = ok ? a.lse[r] : INFINITY;
      dl[hf] = ok ? a.delta[r] : 0.f;
    }
    // the warpgroup's window of gate * ds diagonal sums: entry k0 + c - r +
    // 63 of (row r, key k0 + c)
    float* part = a.partial + (static_cast<size_t>(tl.bh) * (a.t_pad / 64) +
                               q0 / 64 + c) *
                                  (a.t_pad + 63);
    float carry = 0.f;
    float dq[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) dq[e] = 0.f;
    uint32_t da[16];
    mbar_wait(&resident[0], n & 1);
    for (int i = 0; i < nk; ++i, ++f) {
      const int s = f % kStages;
      mbar_wait(&full[s], (f / kStages) & 1);
      const float* sl =
          reinterpret_cast<const float*>(smem + kDqBiasOff) + s * kSliceLd;
      const float* ms =
          reinterpret_cast<const float*>(smem + kDqMaddOff) + s * 64;
      float sc[32], dp[32];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 mj = *reinterpret_cast<const float2*>(ms + 8 * j + c0);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float* bp = sl + 8 * j + c0 - (r0 + 8 * hf) + 127;
          const int xx = 4 * j + 2 * hf;
          sc[xx] = fmaf(g[hf], bp[0], mj.x);
          sc[xx + 1] = fmaf(g[hf], bp[1], mj.y);
          dp[xx] = dp[xx + 1] = 0.f;
        }
      }
      const uint8_t* kv = smem + kDqKVOff + s * kTileBytes;
      const uint64_t kd = sw128_desc(kv);
      fence_acc(sc);
      fence_acc(dp);
      wgmma_fence();
      mma_two(sc, qd, kd, dp, dod, sw128_desc(kv + kBoxBytes));
      wgmma_wait<0>();
      fence_acc(sc);
      fence_acc(dp);
      if (i == nk - 1) release(&resident[1]);  // Q and dO read for good
      if (i > 0) named_sync(3 + c, 128);  // every thread's sums read gds
      // per 8 columns: p = exp(s - lse) (s * scale is exact), ds, dgate
      // (the bias read again), gate * ds into the tile, bf16(ds) into the
      // A fragments, so that s and dp die as the fragments fill
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float* bp = sl + 8 * j + c0 - (r0 + 8 * hf) + 127;
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int xx = 4 * j + 2 * hf + e;
            const float p =
                fast_exp2(fmaf(sc[xx], a.scale, -lse[hf]) * kLog2e);
            ds[e] = p * (dp[xx] - dl[hf]);
            dg[hf] = fmaf(ds[e], bp[e], dg[hf]);
          }
          *reinterpret_cast<float2*>(gds + (wr + 8 * hf) * kGdsLd + 8 * j +
                                     c0) =
              make_float2(gr[hf] * ds[0], gr[hf] * ds[1]);
          da[4 * (j >> 1) + 2 * (j & 1) + hf] = pack_bf16(ds[0], ds[1]);
        }
      }
      // dq += bf16(ds) . K, K read MN-major, while the tile's diagonals
      // are summed
      fence_acc(dq);
      fence_regs(da);
      wgmma_fence();
      mma_rs_tile(dq, da, kd);
      wgmma_commit();
      named_sync(3 + c, 128);  // the gate * ds tile is whole
      diagonal_sums(gds, part, carry, i, x, half);
      // the dq product (an unconditional wait: ptxas pins the products'
      // registers across one it cannot match), then the stage's release
      wgmma_wait<0>();
      fence_acc(dq);
      fence_regs(da);
      release(&empty[s]);
    }
    if (half == 0 && x < 63) part[a.t_pad + x] = carry;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float v = dg[hf];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      const int i = q0 + r0 + 8 * hf;
      if ((lane & 3) == 0 && i < T) {
        a.dgate[static_cast<size_t>(tl.bh) * T + i] = v;
      }
    }
    // dq through the warpgroup's staging box, by TMA (the last tile's store
    // has read it first)
    if (wtid == 0) bulk_wait_read<0>();
    named_sync(3 + c, 128);
    stage_rows(stg, dq, a.scale, wr);
    fence_async_smem();
    named_sync(3 + c, 128);
    if (wtid == 0 && q0 + 64 * c < T) {
      tma_store_3d(tmdq, stg, 0, q0 + 64 * c, tl.bh);
      bulk_commit();
    }
  }
  if (wtid == 0) bulk_wait_read<0>();  // before the block's smem goes
}

__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tmq,
                                    const __grid_constant__ CUtensorMap tmdo,
                                    const __grid_constant__ CUtensorMap tmk,
                                    const __grid_constant__ CUtensorMap tmv,
                                    const __grid_constant__ CUtensorMap tmdq,
                                    Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* resident = reinterpret_cast<uint64_t*>(smem + kDqBarOff);
  uint64_t* full = resident + 2;
  uint64_t* empty = full + kStages;
  init_barriers(resident, full, empty);
  if (threadIdx.x >= kConsumers * 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    dq_produce(&tmq, &tmdo, &tmk, &tmv, a, smem, resident, full, empty);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    dq_consume(&tmdq, a, smem, resident, full, empty);
  }
}

// ---------------------------------------------------------------------
// The dk/dv kernel: persistent blocks over the (b, h, 128-key tile) tiles
// below T.

// A producer thread's share of a dk/dv stage's row vectors (gate in the
// scores' units, lse, +inf past T so that p = 0 there, delta) and bias
// slice, loaded two stages before the producer stores it; f is the
// block's stage: query tile f % nq of its tile f / nq (zeros past its
// last).
struct DkvStageVals {
  float g, l, d, b0, b1;
};

__device__ __forceinline__ DkvStageVals dkv_fetch(const Args& a, int f,
                                                  int nq, int pt,
                                                  float inv) {
  DkvStageVals v = {0.f, 0.f, 0.f, 0.f, 0.f};
  const Tile tl = tile_of(a, f / nq);
  if (!tl.valid) return v;
  const int T = a.T;
  const int q0 = (f % nq) * 64;
  if (pt < 64) {
    const int i_q = q0 + pt;
    const bool ok = i_q < T;
    const size_t r = static_cast<size_t>(tl.bh) * T + i_q;
    v.g = ok ? a.gate[r] * inv : 0.f;
    v.l = ok ? a.lse[r] : INFINITY;
    v.d = ok ? a.delta[r] : 0.f;
  }
  // the bias of (query q0 + c, key k0 + r) is slice[r - c + 63]
  const bf16* brow = a.bias + static_cast<size_t>(tl.bh % a.H) * 2 * T;
  const int base = T - 1 + tl.row0 - q0 - 63;
  v.b0 = __bfloat162float(brow[min(max(base + pt, 0), 2 * T - 1)]);
  if (pt + 128 < kSliceLd - 1) {
    v.b1 = __bfloat162float(brow[min(max(base + pt + 128, 0), 2 * T - 1)]);
  }
  return v;
}

// Its producer warpgroup: a tile's K and V, then each stage's Q and dO (its
// first thread, by TMA), row vectors and bias slice (all 128 threads).
__device__ __forceinline__ void dkv_produce(const CUtensorMap* tmk,
                                            const CUtensorMap* tmv,
                                            const CUtensorMap* tmq,
                                            const CUtensorMap* tmdo,
                                            const Args& a, uint8_t* smem,
                                            uint64_t* resident,
                                            uint64_t* full, uint64_t* empty) {
  const int nq = (a.T + 63) / 64;
  const float inv = 1.f / a.scale;
  const int pt = threadIdx.x - kConsumers * 128;
  const int total = nq * block_tiles(a);
  float* rows_s = reinterpret_cast<float*>(smem + kRowsOff);
  float* bias_s = reinterpret_cast<float*>(smem + kDkvBiasOff);
  DkvStageVals cur = dkv_fetch(a, 0, nq, pt, inv);
  DkvStageVals nxt = dkv_fetch(a, 1, nq, pt, inv);
  for (int f = 0; f < total; ++f) {
    const int n = f / nq;
    const int i = f - n * nq;
    const Tile tl = tile_of(a, n);
    const int s = f % kStages;
    if (i == 0 && pt == 0) {
      mbar_wait(&resident[1], (n & 1) ^ 1);
      mbar_expect_tx(&resident[0], 2 * kTileBytes);
      tma_load_3d(smem + kKOff, tmk, 0, tl.row0, tl.bh, &resident[0]);
      tma_load_3d(smem + kVOff, tmv, 0, tl.row0, tl.bh, &resident[0]);
    }
    mbar_wait(&empty[s], ((f / kStages) & 1) ^ 1);
    if (pt < 64) {
      float* rows = rows_s + s * 3 * 64;
      rows[pt] = cur.g;
      rows[64 + pt] = cur.l;
      rows[128 + pt] = cur.d;
    }
    bias_s[s * kSliceLd + pt] = cur.b0;
    if (pt + 128 < kSliceLd - 1) bias_s[s * kSliceLd + pt + 128] = cur.b1;
    if (pt == 0) {
      mbar_expect_tx(&full[s], kTileBytes);
      uint8_t* qs = smem + kDkvQOff + s * kTileBytes;
      tma_load_3d(qs, tmq, 0, i * 64, tl.bh, &full[s]);
      tma_load_3d(qs + kBoxBytes, tmdo, 0, i * 64, tl.bh, &full[s]);
    } else {
      mbar_arrive(&full[s]);
    }
    cur = nxt;
    nxt = dkv_fetch(a, f + 2, nq, pt, inv);
  }
}

// s^T of a consumer thread's keys r0, r0 + 8 at a stage's queries
// 8 j + c0 + e, started as the bias (slice[r - c + 63], descending with the
// query), and dp^T = 0.
__device__ __forceinline__ void dkv_init(float (&sc)[32], float (&dp)[32],
                                         const float* rows, const float* sl,
                                         const float (&mk)[2], int r0,
                                         int c0) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 gj = *reinterpret_cast<const float2*>(rows + 8 * j + c0);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float* bp = sl + (r0 - c0 + 63) + 8 * (hf - j);
      const int xx = 4 * j + 2 * hf;
      sc[xx] = fmaf(gj.x, bp[0], mk[hf]);
      sc[xx + 1] = fmaf(gj.y, bp[-1], mk[hf]);
      dp[xx] = dp[xx + 1] = 0.f;
    }
  }
}

// p^T = exp(s^T - lse) (s * scale is exact) and ds^T = p^T (dp^T - delta)
// of the thread's 8-column blocks, each packed as bf16 into the A
// fragments pa and da as it is formed, so that s and dp die as they fill.
__device__ __forceinline__ void dkv_probs(const float (&sc)[32],
                                          const float (&dp)[32],
                                          const float* rows, float scale,
                                          int c0, uint32_t (&pa)[16],
                                          uint32_t (&da)[16]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 lj = *reinterpret_cast<const float2*>(rows + 64 + 8 * j + c0);
    const float2 ej =
        *reinterpret_cast<const float2*>(rows + 128 + 8 * j + c0);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int xx = 4 * j + 2 * hf;
      const float p0 = fast_exp2(fmaf(sc[xx], scale, -lj.x) * kLog2e);
      const float p1 = fast_exp2(fmaf(sc[xx + 1], scale, -lj.y) * kLog2e);
      const int f = 4 * (j >> 1) + 2 * (j & 1) + hf;
      pa[f] = pack_bf16(p0, p1);
      da[f] = pack_bf16(p0 * (dp[xx] - ej.x), p1 * (dp[xx + 1] - ej.y));
    }
  }
}

// A consumer warpgroup: 64 keys of each tile.  Per stage: S^T and dP^T,
// then p^T and ds^T, then dv and dk; the other warpgroup's products fill the
// tensor cores meanwhile.  (Keeping a stage's dv and dk products in flight
// beside the next stage's S^T and dP^T needs more registers than the 168 a
// thread of a 384-thread block has.)
__device__ __forceinline__ void dkv_consume(const CUtensorMap* tmdk,
                                            const CUtensorMap* tmdv,
                                            const Args& a, uint8_t* smem,
                                            uint64_t* resident,
                                            uint64_t* full, uint64_t* empty) {
  const int T = a.T;
  const int nq = (T + 63) / 64;
  const float inv = 1.f / a.scale;
  const int c = threadIdx.x / 128;
  const int wtid = threadIdx.x % 128;
  const int lane = threadIdx.x & 31;
  const int wr = (wtid >> 5) * 16 + (lane >> 2);
  const int r0 = 64 * c + wr;  // the thread's keys k0 + r0, + 8
  const int c0 = 2 * (lane & 3);
  const float* rows_s = reinterpret_cast<const float*>(smem + kRowsOff);
  const float* bias_s = reinterpret_cast<const float*>(smem + kDkvBiasOff);
  const uint64_t kd = sw128_desc(smem + kKOff + c * kBoxBytes);
  const uint64_t vd = sw128_desc(smem + kVOff + c * kBoxBytes);
  uint8_t* kbox = smem + kDkvStgOff + 2 * c * kBoxBytes;
  uint8_t* vbox = kbox + kBoxBytes;
  int f = 0;  // the block's stage
  for (int n = 0; n < block_tiles(a); ++n) {
    const Tile tl = tile_of(a, n);
    const int k0 = tl.row0;
    const int b = tl.bh / a.H;
    float mk[2];  // the key mask in the scores' units
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int j = k0 + r0 + 8 * hf;
      mk[hf] =
          (j < T ? a.madd[static_cast<size_t>(b) * T + j] : kMasked) * inv;
    }
    float dk[32], dv[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) dk[e] = dv[e] = 0.f;
    mbar_wait(&resident[0], n & 1);
    for (int i = 0; i < nq; ++i, ++f) {
      const int s = f % kStages;
      mbar_wait(&full[s], (f / kStages) & 1);
      const float* rows = rows_s + s * 3 * 64;
      float sc[32], dp[32];
      dkv_init(sc, dp, rows, bias_s + s * kSliceLd, mk, r0, c0);
      const uint8_t* qs = smem + kDkvQOff + s * kTileBytes;
      const uint64_t qd = sw128_desc(qs);
      const uint64_t dd = sw128_desc(qs + kBoxBytes);
      fence_acc(sc);
      fence_acc(dp);
      wgmma_fence();
      mma_two(sc, kd, qd, dp, vd, dd);
      wgmma_wait<0>();
      fence_acc(sc);
      fence_acc(dp);
      if (i == nq - 1) release(&resident[1]);  // K and V read for good
      uint32_t pa[16], da[16];
      dkv_probs(sc, dp, rows, a.scale, c0, pa, da);
      fence_acc(dv);
      fence_acc(dk);
      fence_regs(pa);
      fence_regs(da);
      wgmma_fence();
      mma_rs_tile(dv, pa, dd);  // dv += p^T . dO, dO read MN-major
      mma_rs_tile(dk, da, qd);  // dk += ds^T . Q
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dv);
      fence_acc(dk);
      fence_regs(pa);
      fence_regs(da);
      release(&empty[s]);
    }
    // dk and dv through the warpgroup's staging boxes, by TMA (the last
    // tile's stores have read them first)
    if (wtid == 0) bulk_wait_read<0>();
    named_sync(3 + c, 128);
    stage_rows(kbox, dk, a.scale, wr);
    stage_rows(vbox, dv, 1.f, wr);
    fence_async_smem();
    named_sync(3 + c, 128);
    if (wtid == 0 && k0 + 64 * c < T) {
      tma_store_3d(tmdk, kbox, 0, k0 + 64 * c, tl.bh);
      tma_store_3d(tmdv, vbox, 0, k0 + 64 * c, tl.bh);
      bulk_commit();
    }
  }
  if (wtid == 0) bulk_wait_read<0>();  // before the block's smem goes
}

__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tmk,
    const __grid_constant__ CUtensorMap tmv,
    const __grid_constant__ CUtensorMap tmq,
    const __grid_constant__ CUtensorMap tmdo,
    const __grid_constant__ CUtensorMap tmdk,
    const __grid_constant__ CUtensorMap tmdv, Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* resident = reinterpret_cast<uint64_t*>(smem + kDkvBarOff);
  uint64_t* full = resident + 2;
  uint64_t* empty = full + kStages;
  init_barriers(resident, full, empty);
  if (threadIdx.x >= kConsumers * 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    dkv_produce(&tmk, &tmv, &tmq, &tmdo, a, smem, resident, full, empty);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    dkv_consume(&tmdk, &tmdv, a, smem, resident, full, empty);
  }
}

// ---------------------------------------------------------------------
// dbias[h, p] = the sum over the (b, w) windows (b the batch, w the
// 64-query window), in order, of window entry p - (T - 64 - 64 w); the
// last entry, p = 2T - 1, also takes each window's entries past it (the
// padded keys' clamped index).  A block folds 32 entries: its 8 warps each
// sum a fixed eighth of the (b, w) list (a lane an entry, 128-byte rows
// of a window), then one warp adds the 8 partial sums in order.

constexpr int kFoldColumns = 32;
constexpr int kFoldSlices = 8;

__global__ void __launch_bounds__(kFoldColumns * kFoldSlices)
flash_dbias_fold_kernel(const float* __restrict__ partial,
                        float* __restrict__ dbias, int B, int H, int T,
                        int t_pad) {
  __shared__ float sums[kFoldSlices][kFoldColumns];
  const int lane = threadIdx.x % kFoldColumns;
  const int slice = threadIdx.x / kFoldColumns;
  const int p = blockIdx.x * kFoldColumns + lane;
  const int h = blockIdx.y;
  const int nw = t_pad / 64;
  const int wl = t_pad + 63;
  const int n = B * nw;
  const int n0 = slice * n / kFoldSlices;
  const int n1 = (slice + 1) * n / kFoldSlices;
  float s = 0.f;
  if (p < 2 * T) {
    for (int k = n0; k < n1; ++k) {
      const int b = k / nw;
      const int w = k - b * nw;
      const float* win =
          partial + ((static_cast<size_t>(b) * H + h) * nw + w) * wl;
      const int j = p - (T - 64 - 64 * w);
      if (j >= 0 && j < wl) s += win[j];
      if (p == 2 * T - 1) {
        for (int jj = max(j + 1, 0); jj < wl; ++jj) s += win[jj];
      }
    }
  }
  sums[slice][lane] = s;
  __syncthreads();
  if (slice == 0 && p < 2 * T) {
    float t = sums[0][lane];
    for (int k = 1; k < kFoldSlices; ++k) t += sums[k][lane];
    dbias[static_cast<size_t>(h) * 2 * T + p] = t;
  }
}

bool bad_shape(int B, int H, int T, int D) {
  return D != kD || T < 1 || T > kMaxT || B < 1 || H < 1 ||
         static_cast<long long>(B) * H > 65535;
}

Args make_args(const void* gate, const void* bias, const void* madd,
               const void* lse, const void* delta, int H, int T,
               float scale) {
  Args a = {};
  a.gate = static_cast<const float*>(gate);
  a.bias = static_cast<const bf16*>(bias);
  a.madd = static_cast<const float*>(madd);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.H = H;
  a.T = T;
  a.t_pad = (T + kPad - 1) / kPad * kPad;
  a.scale = scale;
  return a;
}

}  // namespace

// Both entries: q, k, v, dout, out (and dq, dk, dv): contiguous bf16
// [B, H, T, D], 16-byte aligned; gate, lse, delta (and dgate): f32
// [B, H, T]; bias: bf16 [H, 2T]; madd: f32 [B, T]; `maps` the tensor maps'
// geometry, 9 words each (ops/flash_attention.py::map_geometry of DQ_MAPS
// or DKV_MAPS), `smem` the kernel's shared memory (k5_plan), which must
// agree with this file's.
//
// dq: writes delta (the pre-pass), dq, dgate and dbias (f32 [H, 2T]);
// partial: f32 scratch of B * H * (t_pad / 64) * (t_pad + 63) elements,
// t_pad = 128 * ceil(T / 128).
extern "C" int nrse_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* gate,
    const void* bias, const void* madd, const void* dout, const void* lse,
    const void* out, void* delta, void* dq, void* dgate, void* partial,
    void* dbias, const void* maps, int B, int H, int T, int D, float scale,
    int grid, int smem, void* stream) {
  if (bad_shape(B, H, T, D) || grid < 1 || smem != kDqSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* g = static_cast<const long long*>(maps);
  const int BH = B * H;
  CUtensorMap mq, mdo, mk, mv, mdq;
  cudaError_t err = head_map_words(&mq, q, g, BH, T, 128);
  if (err == cudaSuccess) err = head_map_words(&mdo, dout, g + 9, BH, T, 128);
  if (err == cudaSuccess) err = head_map_words(&mk, k, g + 18, BH, T, 64);
  if (err == cudaSuccess) err = head_map_words(&mv, v, g + 27, BH, T, 64);
  if (err == cudaSuccess) err = head_map_words(&mdq, dq, g + 36, BH, T, 64);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_attention_bwd_dq_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDqSmem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = BH * T;
  flash_attention_bwd_delta_kernel<<<(rows * 8 + kDeltaThreads - 1) /
                                         kDeltaThreads,
                                     kDeltaThreads, 0, s>>>(
      static_cast<const bf16*>(dout), static_cast<const bf16*>(out),
      static_cast<float*>(delta), rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a = make_args(gate, bias, madd, lse, delta, H, T, scale);
  a.dgate = static_cast<float*>(dgate);
  a.partial = static_cast<float*>(partial);
  a.per_bh = a.t_pad / 128;
  a.tiles = BH * a.per_bh;
  flash_attention_bwd_dq_wgmma_kernel<<<grid, kThreads, kDqSmem, s>>>(
      mq, mdo, mk, mv, mdq, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_dbias_fold_kernel<<<dim3((2 * T + kFoldColumns - 1) / kFoldColumns,
                                   H),
                              kFoldColumns * kFoldSlices, 0, s>>>(
      a.partial, static_cast<float*>(dbias), B, H, T, a.t_pad);
  return static_cast<int>(cudaGetLastError());
}

// dk and dv, from the delta the dq entry wrote.
extern "C" int nrse_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* gate,
    const void* bias, const void* madd, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, const void* maps, int B, int H,
    int T, int D, float scale, int grid, int smem, void* stream) {
  if (bad_shape(B, H, T, D) || grid < 1 || smem != kDkvSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* g = static_cast<const long long*>(maps);
  const int BH = B * H;
  CUtensorMap mk, mv, mq, mdo, mdk, mdv;
  cudaError_t err = head_map_words(&mk, k, g, BH, T, 128);
  if (err == cudaSuccess) err = head_map_words(&mv, v, g + 9, BH, T, 128);
  if (err == cudaSuccess) err = head_map_words(&mq, q, g + 18, BH, T, 64);
  if (err == cudaSuccess) err = head_map_words(&mdo, dout, g + 27, BH, T, 64);
  if (err == cudaSuccess) err = head_map_words(&mdk, dk, g + 36, BH, T, 64);
  if (err == cudaSuccess) err = head_map_words(&mdv, dv, g + 45, BH, T, 64);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_attention_bwd_dkv_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDkvSmem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a = make_args(gate, bias, madd, lse, delta, H, T, scale);
  a.per_bh = (T + 127) / 128;
  a.tiles = BH * a.per_bh;
  flash_attention_bwd_dkv_wgmma_kernel<<<grid, kThreads, kDkvSmem,
                                         static_cast<cudaStream_t>(stream)>>>(
      mk, mv, mq, mdo, mdk, mdv, a);
  return static_cast<int>(cudaGetLastError());
}
