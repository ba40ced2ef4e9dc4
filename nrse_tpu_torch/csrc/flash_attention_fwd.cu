// Flash gated attention with a Toeplitz position bias, forward (K5), on
// wgmma fed by TMA.
//
// Replaces: nrse_tpu/ops/flash_attention.py::_fwd_kernel (the Pallas TPU
// kernel for 384 < T, t_pad <= 3072) and ::_fwd_streamed_kernel (the same
// for t_pad > 3072, which streams K/V blocks from HBM by hand).  One kernel
// serves every T here: its K/V tiles always stream through shared memory.
//
// Computes, per (batch b, head h) and for every query row i, over the keys
// padded as the JAX wrapper pads them (t_pad = 128 * ceil(T / 128): keys
// j >= T have zero k and v, madd -1e9, and the bias at the clamped index):
//   s[j]   = (q[i] . k[j]) * d^-1/2 + gate[b,h,i] * bias[h, min(T-1+j-i,
//            2T-1)] + madd[b,j]
//   with the online softmax over key tiles of 128: m' = max(m, max_j s[j]),
//   a = exp(m - m'), p[j] = exp(s[j] - m'), l = l*a + sum_j p[j],
//   acc = acc*a + bf16(p) . v
//   out[i] = acc / max(l, 1e-30)   (bf16)
//   lse[i] = m + log(max(l, 1e-30)) (f32, kept for the backward)
// bias is the [H, 2T] bf16 Toeplitz generator (rel_pos_bias.rel_bias_vector
// of the bucket table in the compute dtype); madd is 0 for a valid key and
// -1e9 for a padded one, so a row whose keys are all padded stays finite:
// the mean of v over the T keys times T / t_pad, as in JAX.  No dropout: in
// training the attention dropout applies outside this kernel.
//
// What bounds it on the H100: at the evaluator's 10 s bucket (B=32, H=16,
// T=499, D=64) the 131 MB of q, k, v and out (39 us at 3.35 TB/s) against
// 32.6 GFLOP of the two T x T x D products (33 us at 989 TFLOP/s); at 30 s
// (T=1499) 294 GFLOP: the products, growing as T^2 while the bytes grow as
// T.  Beside them, the exponentials: MUFU gives 16 ex2 a clock per SM, so
// T = 499's 127.5 M scores take about as long as the products.  The scores
// and probabilities live in registers, never in memory, and the [H, T, T]
// bias is never formed.
//
// Design (FlashAttention-3's, for D = 64).  Persistent blocks of three
// warpgroups walk the (b, h, 128-query tile) tiles (the wrapper's grid,
// ops/flash_attention.py::k5_plan).  The warpgroups take setmaxnreg 40
// and 232 as CUTLASS's do, though ptxas compiles every thread within the
// 168 registers of a 384-thread block (a consumer's 64 + 32 + 32 values of
// S, O and P fit).  The producer warpgroup keeps a ring of 3 stages full:
// its first thread TMA-loads each tile's Q (one box of 128 rows) and each
// stage's K and V (boxes of 128 keys under the 128-byte swizzle, rows past
// T as zeros, from [B*H, T, 64] maps whose geometry the wrapper passes),
// and all 128 of its threads load the stage's key mask and its slice of
// the bias generator: the 255 entries T - 1 + k - q of the tile's
// 128 x 128 (query, key) pairs, in f32, each two stages ahead of its store
// (loaded as a stage was stored, their latency paced the ring).  So shared
// memory does not grow with T.  The two consumer warpgroups own 64 queries
// each.  Per stage, the S accumulator (m64n128, 64 f32 a thread) starts as
// (gate * bias + madd) / scale (the scale is 1/8 at D = 64, so this is
// exact), S += Q K^T is four wgmma.m64n128k16, the online softmax runs in
// registers with exp2 and log2(e) folded into the scale (o and l rescaled
// only when a warp's row max moved), and bf16(p) is the register A operand
// of eight wgmma.m64n64k16 with V read MN-major.  A warpgroup's PV product
// of stage n runs beside its S product of stage n + 1, and the two
// warpgroups issue their products in turn (two named barriers): one's
// softmax runs while the other's products run.  The output goes through a
// staging tile (16 KB) by TMA stores; lse is written per row.  p is
// rounded to bf16 against the running max (the TPU kernel's single-block
// branch, t_pad <= 512, rounds against the row's true max: the two differ
// by bf16 rounding).

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
constexpr int kBlockQ = 128;  // a tile's queries: 64 a consumer warpgroup
constexpr int kBlockK = 128;  // a stage's keys
constexpr int kStages = 3;
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;  // 256 x 232 + 128 x 40 <= 65536
constexpr int kBoxBytes = 64 * kD * 2;       // 64 rows: 8 KB
constexpr int kTileBytes = 2 * kBoxBytes;    // 128 rows: 16 KB
constexpr int kSlice = 2 * kBlockK;          // f32 bias slice (255 used)
constexpr float kMasked = -1e9f;             // the key mask of padded keys
constexpr float kLog2e = 1.4426950408889634f;

// shared memory, after 1024-byte alignment: Q, the output's staging tile,
// the ring's K and V tiles, its bias slices and key masks, the barriers
constexpr int kQOff = 0;
constexpr int kOOff = kTileBytes;
constexpr int kKVOff = 2 * kTileBytes;  // stage s: K, then V
constexpr int kBiasOff = kKVOff + kStages * 2 * kTileBytes;
constexpr int kMaddOff = kBiasOff + kStages * kSlice * 4;
constexpr int kBarOff = kMaddOff + kStages * kBlockK * 4;
constexpr int kSmemBytes = 1024 + kBarOff + 8 * (2 + 2 * kStages);
static_assert(kSmemBytes == 136768, "ops/flash_attention.py::FWD_SMEM");

struct Args {
  const float* gate;  // [B*H, T]
  const bf16* bias;   // [H, 2T]
  const float* madd;  // [B, T]
  float* lse;         // [B*H, T]
  int H, T, q_tiles, tiles;
  float scale;
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// A consumer warp's release of a stage (or of Q): one arrival.
__device__ __forceinline__ void release(uint64_t* bar) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// o += bf16(P) . V over the stage's 128 keys (eight 16-key steps), V read
// MN-major; issued and committed, not waited for, after the caller's
// wgmma.fence (o and pa are fenced before the batch's first product: a
// register defined inside a batch serializes its products).  pa[4 kk + r]
// is register r of step kk's A fragment.
__device__ __forceinline__ void pv_product(float (&o)[32],
                                           const uint32_t (&pa)[32],
                                           uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk) {
    const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                           pa[4 * kk + 3]};
    wgmma_m64n64k16_rs(o, a, dv + 128 * kk, 1);
  }
  wgmma_commit();
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A producer thread's share of a stage's key mask and bias slice, loaded
// from device memory two stages before the producer stores it, so that the
// loads' latency does not pace the ring.  f is the block's stage: key tile
// f % nk of its tile number f / nk (tile blockIdx.x + (f / nk) gridDim.x);
// past the block's last tile it is zeros.
struct StageVals {
  float b0, b1, m;
};

__device__ __forceinline__ StageVals fetch_stage(const Args& a, int f, int nk,
                                                 int pt, float inv) {
  StageVals v = {0.f, 0.f, 0.f};
  const int n = f / nk;
  const int tile = blockIdx.x + n * static_cast<int>(gridDim.x);
  if (tile >= a.tiles) return v;
  const int T = a.T;
  const int bh = tile / a.q_tiles;
  const int q0 = (tile - bh * a.q_tiles) * kBlockQ;
  const int b = bh / a.H;
  const int k0 = (f - n * nk) * kBlockK;
  // the bias of (query q0 + r, key k0 + c) is slice[c - r + 127]: the
  // generator at T - 1 + k0 - q0 - 127 + j, clamped to [0, 2T - 1] (JAX's
  // edge pad, read by padded keys and queries)
  const bf16* brow = a.bias + static_cast<size_t>(bh - b * a.H) * 2 * T;
  const int base = T - 1 + k0 - q0 - (kBlockQ - 1);
  v.b0 = __bfloat162float(brow[min(max(base + pt, 0), 2 * T - 1)]);
  if (pt + 128 < kSlice - 1) {
    v.b1 = __bfloat162float(brow[min(max(base + pt + 128, 0), 2 * T - 1)]);
  }
  // the key mask in the scores' units (of q . k); keys T .. t_pad - 1 are
  // JAX's padding
  v.m = (k0 + pt < T ? a.madd[static_cast<size_t>(b) * T + k0 + pt]
                     : kMasked) * inv;
  return v;
}

// The producer warpgroup: Q once a tile, then each stage's K and V (its
// first thread, by TMA), key mask and bias slice (all 128 threads).
__device__ __forceinline__ void produce(const CUtensorMap* tmq,
                                        const CUtensorMap* tmk,
                                        const CUtensorMap* tmv,
                                        const Args& a, uint8_t* smem,
                                        uint64_t* q_full, uint64_t* q_empty,
                                        uint64_t* full, uint64_t* empty) {
  const int pt = threadIdx.x - kConsumers * 128;
  const int nk = (a.T + kBlockK - 1) / kBlockK;
  const float inv = 1.f / a.scale;
  const int total =
      nk * ((a.tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) /
            gridDim.x);
  float* bias_s = reinterpret_cast<float*>(smem + kBiasOff);
  float* madd_s = reinterpret_cast<float*>(smem + kMaddOff);
  StageVals cur = fetch_stage(a, 0, nk, pt, inv);
  StageVals nxt = fetch_stage(a, 1, nk, pt, inv);
  for (int f = 0; f < total; ++f) {
    const int n = f / nk;
    const int i = f - n * nk;
    const int tile = blockIdx.x + n * static_cast<int>(gridDim.x);
    const int bh = tile / a.q_tiles;
    const int s = f % kStages;
    if (i == 0 && pt == 0) {
      mbar_wait(q_empty, (n & 1) ^ 1);
      mbar_expect_tx(q_full, kTileBytes);
      tma_load_3d(smem + kQOff, tmq, 0, (tile - bh * a.q_tiles) * kBlockQ,
                  bh, q_full);
    }
    mbar_wait(&empty[s], ((f / kStages) & 1) ^ 1);
    bias_s[s * kSlice + pt] = cur.b0;
    if (pt + 128 < kSlice - 1) bias_s[s * kSlice + pt + 128] = cur.b1;
    madd_s[s * kBlockK + pt] = cur.m;
    if (pt == 0) {
      // this thread's arrival; the copies complete the phase
      mbar_expect_tx(&full[s], 2 * kTileBytes);
      uint8_t* kv = smem + kKVOff + s * 2 * kTileBytes;
      tma_load_3d(kv, tmk, 0, i * kBlockK, bh, &full[s]);
      tma_load_3d(kv + kTileBytes, tmv, 0, i * kBlockK, bh, &full[s]);
    } else {
      mbar_arrive(&full[s]);
    }
    cur = nxt;
    nxt = fetch_stage(a, f + 2, nk, pt, inv);
  }
}

// S's start: gate * bias + madd in the scores' units (of q . k),
// sc[4 j + 2 hf + e] at tile row r0 + 8 hf and the stage's key 8 j + c0 + e.
// The bias of row r0 + 8 at key c is row r0's at key c - 8: the two rows
// read 17 pairs of the slice, not 32.
__device__ __forceinline__ void init_scores(float (&sc)[64], const float* sl,
                                            const float* ms,
                                            const float (&g)[2], int r0,
                                            int c0) {
  const float* bp = sl + c0 - r0 + (kBlockQ - 1);  // row r0, key c0
  float lo0 = bp[-8], lo1 = bp[-7];
#pragma unroll
  for (int j = 0; j < kBlockK / 8; ++j) {
    const float2 mj = *reinterpret_cast<const float2*>(ms + 8 * j + c0);
    const float b0 = bp[8 * j], b1 = bp[8 * j + 1];
    sc[4 * j] = fmaf(g[0], b0, mj.x);
    sc[4 * j + 1] = fmaf(g[0], b1, mj.y);
    sc[4 * j + 2] = fmaf(g[1], lo0, mj.x);
    sc[4 * j + 3] = fmaf(g[1], lo1, mj.y);
    lo0 = b0;
    lo1 = b1;
  }
}

// S += Q . K^T: four 16-deep steps, both K-major; issued and committed
// after the caller's wgmma.fence.
__device__ __forceinline__ void s_product(float (&sc)[64], uint64_t dq,
                                          uint64_t dk) {
#pragma unroll
  for (int k = 0; k < kD / 16; ++k) {
    wgmma_m64n128k16(sc, dq + 2 * k, dk + 2 * k, 1);
  }
  wgmma_commit();
}

// The online softmax of a stage: the rows' new max m (and mc = m * cl),
// alpha = exp(old max - new max) (0 on a tile's first stage), p in place
// of the scores and its row sums (this thread's columns) in rs.
__device__ __forceinline__ void softmax_stage(float (&sc)[64], float (&m)[2],
                                              float (&mc)[2],
                                              float (&alpha)[2],
                                              float (&rs)[2], float cl) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], fmaxf(sc[4 * j + 2 * hf], sc[4 * j + 2 * hf + 1]));
    }
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    // 4 lanes share a row
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
    const float mcn = mx[hf] * cl;
    alpha[hf] = fast_exp2(mc[hf] - mcn);
    m[hf] = mx[hf];
    mc[hf] = mcn;
    rs[hf] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * j + 2 * hf + e;
        sc[x] = fast_exp2(fmaf(sc[x], cl, -mc[hf]));
        rs[hf] += sc[x];
      }
    }
  }
}

// bf16(p) as the A fragments: pa[4 kk + 2 (j & 1) + hf] of key step
// kk = j / 2.
__device__ __forceinline__ void pack_p(const float (&sc)[64],
                                       uint32_t (&pa)[32]) {
#pragma unroll
  for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      pa[4 * (j >> 1) + 2 * (j & 1) + hf] =
          pack_bf16(sc[4 * j + 2 * hf], sc[4 * j + 2 * hf + 1]);
    }
  }
}

// A consumer warpgroup: 64 queries of each tile.  A tile's first stage is
// peeled off, so that every wait in the loop is unconditional (ptxas keeps
// the products' registers pinned across a wait it cannot match).
__device__ __forceinline__ void consume(const CUtensorMap* tmo,
                                        const Args& a, uint8_t* smem,
                                        uint64_t* q_full, uint64_t* q_empty,
                                        uint64_t* full, uint64_t* empty) {
  const int c = threadIdx.x / 128;
  const int wtid = threadIdx.x % 128;
  const int lane = threadIdx.x & 31;
  // the thread's rows r0, r0 + 8 of the tile; its columns 8 j + c0 + e
  const int r0 = 64 * c + (wtid >> 5) * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  const int T = a.T;
  const int nk = (T + kBlockK - 1) / kBlockK;
  const float inv = 1.f / a.scale;
  const float cl = a.scale * kLog2e;  // scores' units -> log2
  const uint64_t dq = sw128_desc(smem + kQOff + c * kBoxBytes);
  const float* bias_s = reinterpret_cast<const float*>(smem + kBiasOff);
  const float* madd_s = reinterpret_cast<const float*>(smem + kMaddOff);
  uint8_t* os = smem + kOOff + c * kBoxBytes;
  // the two warpgroups issue their products in turn: warpgroup c waits on
  // barrier 1 + c for the other's arrival; warpgroup 0 goes first
  if (c == 1) named_arrive(1, 256);
  uint32_t it = 0;
  int n = 0;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x, ++n) {
    const bool last_tile = tile + static_cast<int>(gridDim.x) >= a.tiles;
    const int bh = tile / a.q_tiles;
    const int q0 = (tile - bh * a.q_tiles) * kBlockQ;
    float g[2];  // the rows' gate in the scores' units (0 past T)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = q0 + r0 + 8 * hf;
      g[hf] = i < T ? a.gate[static_cast<size_t>(bh) * T + i] * inv : 0.f;
    }
    float m[2] = {-INFINITY, -INFINITY};  // running max, scores' units
    float mc[2] = {-INFINITY, -INFINITY};  // m * cl
    float l[2], alpha[2], rs[2];           // l: this thread's columns
    float o[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) o[x] = 0.f;
    float sc[64];
    uint32_t pa[32];
    mbar_wait(q_full, n & 1);

    // the first stage: S alone
    int s_prev = static_cast<int>(it % kStages);
    mbar_wait(&full[s_prev], (it / kStages) & 1);
    init_scores(sc, bias_s + s_prev * kSlice, madd_s + s_prev * kBlockK, g,
                r0, c0);
    named_sync(1 + c, 256);
    fence_acc(sc);
    wgmma_fence();
    s_product(sc, dq, sw128_desc(smem + kKVOff + s_prev * 2 * kTileBytes));
    named_arrive(2 - c, 256);
    wgmma_wait<0>();
    fence_acc(sc);
    if (nk == 1) release(q_empty);
    softmax_stage(sc, m, mc, alpha, rs, cl);
    l[0] = rs[0];
    l[1] = rs[1];
    pack_p(sc, pa);
    ++it;

    // then S of stage i beside PV of stage i - 1
    for (int i = 1; i < nk; ++i, ++it) {
      const int s = static_cast<int>(it % kStages);
      mbar_wait(&full[s], (it / kStages) & 1);
      init_scores(sc, bias_s + s * kSlice, madd_s + s * kBlockK, g, r0, c0);
      named_sync(1 + c, 256);
      fence_acc(sc);
      fence_acc(o);
      fence_regs(pa);
      wgmma_fence();
      s_product(sc, dq, sw128_desc(smem + kKVOff + s * 2 * kTileBytes));
      pv_product(o, pa,
                 sw128_desc(smem + kKVOff + s_prev * 2 * kTileBytes +
                            kTileBytes));
      named_arrive(2 - c, 256);
      wgmma_wait<1>();
      fence_acc(sc);
      if (i == nk - 1) release(q_empty);  // the tile's S products are done
      softmax_stage(sc, m, mc, alpha, rs, cl);
      wgmma_wait<0>();  // the previous stage's PV product, then its release
      fence_acc(o);
      fence_regs(pa);
      release(&empty[s_prev]);
      // o and l rescaled when a row's max moved
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int jd = 0; jd < kD / 8; ++jd) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            o[4 * jd + 2 * hf] *= alpha[hf];
            o[4 * jd + 2 * hf + 1] *= alpha[hf];
          }
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) l[hf] = fmaf(l[hf], alpha[hf], rs[hf]);
      pack_p(sc, pa);
      s_prev = s;
    }
    // the last stage's PV product
    named_sync(1 + c, 256);
    fence_acc(o);
    fence_regs(pa);
    wgmma_fence();
    pv_product(o, pa,
               sw128_desc(smem + kKVOff + s_prev * 2 * kTileBytes +
                          kTileBytes));
    if (!(c == 1 && last_tile)) named_arrive(2 - c, 256);
    wgmma_wait<0>();
    fence_acc(o);
    fence_regs(pa);
    release(&empty[s_prev]);

    // out = o / l through the staging tile (the map's 128-byte swizzle:
    // 16-byte chunk jd of row r at chunk jd ^ (r % 8)), lse per row
    if (wtid == 0) bulk_wait_read<0>();  // the last tile's store has read it
    named_sync(3 + c, 128);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
      l[hf] = fmaxf(l[hf], 1e-30f);
      const float rl = 1.f / l[hf];
      const int row = r0 - 64 * c + 8 * hf;
      const int i = q0 + r0 + 8 * hf;
      if ((lane & 3) == 0 && i < T) {
        a.lse[static_cast<size_t>(bh) * T + i] = m[hf] * a.scale + logf(l[hf]);
      }
#pragma unroll
      for (int jd = 0; jd < kD / 8; ++jd) {
        *reinterpret_cast<uint32_t*>(os + row * 128 + ((jd ^ (row & 7)) << 4) +
                                     2 * c0) =
            pack_bf16(o[4 * jd + 2 * hf] * rl, o[4 * jd + 2 * hf + 1] * rl);
      }
    }
    fence_async_smem();
    named_sync(3 + c, 128);
    if (wtid == 0 && q0 + 64 * c < T) {
      tma_store_3d(tmo, os, 0, q0 + 64 * c, bh);
      bulk_commit();
    }
  }
  if (wtid == 0) bulk_wait_read<0>();  // before the block's smem goes
}

__global__ void __launch_bounds__(kThreads, 1)
flash_attention_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tmq,
                                 const __grid_constant__ CUtensorMap tmk,
                                 const __grid_constant__ CUtensorMap tmv,
                                 const __grid_constant__ CUtensorMap tmo,
                                 Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* q_empty = q_full + 1;
  uint64_t* full = q_full + 2;
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumers * 4);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 128);  // the producer's threads; + the copies
      mbar_init(&empty[s], kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers * 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    produce(&tmq, &tmk, &tmv, a, smem, q_full, q_empty, full, empty);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    consume(&tmo, a, smem, q_full, q_empty, full, empty);
  }
}

}  // namespace

// q, k, v, out: contiguous bf16 [B, H, T, D], 16-byte aligned; gate, lse:
// f32 [B, H, T]; bias: bf16 [H, 2T]; madd: f32 [B, T].  `maps`: the
// geometry of q's, k's, v's and out's tensor maps, 9 words each
// (ops/flash_attention.py::map_geometry of FWD_MAPS); `grid` persistent
// blocks of `smem` bytes: the wrapper's plan (k5_plan), which must agree
// with this file's.
extern "C" int nrse_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, const void* gate,
                                        const void* bias, const void* madd,
                                        void* out, void* lse,
                                        const void* maps, int B, int H,
                                        int T, int D, float scale, int grid,
                                        int smem, void* stream) {
  if (D != kD || T < 1 || T > kMaxT || B < 1 || H < 1 || grid < 1 ||
      smem != kSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* g = static_cast<const long long*>(maps);
  const int BH = B * H;
  CUtensorMap mq, mk, mv, mo;
  cudaError_t err = head_map_words(&mq, q, g, BH, T, kBlockQ);
  if (err == cudaSuccess) err = head_map_words(&mk, k, g + 9, BH, T, kBlockK);
  if (err == cudaSuccess) err = head_map_words(&mv, v, g + 18, BH, T, kBlockK);
  if (err == cudaSuccess) err = head_map_words(&mo, out, g + 27, BH, T, 64);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_attention_fwd_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.gate = static_cast<const float*>(gate);
  a.bias = static_cast<const bf16*>(bias);
  a.madd = static_cast<const float*>(madd);
  a.lse = static_cast<float*>(lse);
  a.H = H;
  a.T = T;
  a.q_tiles = (T + kBlockQ - 1) / kBlockQ;
  a.tiles = BH * a.q_tiles;
  a.scale = scale;
  flash_attention_fwd_wgmma_kernel<<<grid, kThreads, kSmemBytes,
                                     static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, mo, a);
  return static_cast<int>(cudaGetLastError());
}
