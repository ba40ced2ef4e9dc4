// What the block attention's forward (block_attention_fwd.cu, kernel A)
// and backward (block_attention_bwd.cu, K3) share: the dropout of the
// output, and the tiles and tensor-core products they are built from.
//
// Dropout.  The keep value of output element (b, h, t, d) of a
// [B, H, T, 64] tensor comes from Philox (philox.cuh, site 0) at the
// element's flat index in the merged [B, T, H * 64] layout,
// (b * T + t) * H * 64 + h * 64 + d: the index K1 (fused_dropout.cu) draws
// at when it drops the merged tensor, so the attention kernels' masks are
// K1's mask at the same seed, one draw per four elements (kernel A's
// keep_bits_rows, K3's pre-pass).  Or it comes from an explicit f32
// [B, H, T, 64] mask (the tests' path).
//
// Tiles.  A block of 4 warps works on 64 rows (queries or keys) of one
// (b, h), a warp on 16 of them.  bf16 [64, 64] tiles of q, k, v or do sit
// in shared memory with rows padded by 16 bytes, so that ldmatrix reads
// them without bank conflicts in both orientations (as in mma_gemm.cuh);
// the f32 bias tile [64 queries, 64 keys] rows by 16 bytes.  Products are
// mma.sync.m16n8k16 (bf16 in, f32 accumulation); a warp's f32 accumulator
// of a 16 x 64 product is fed back as the A operand of the next one,
// rounded to bf16, without leaving registers.  Accumulator element e of
// n8 tile j sits at row lane / 4 + 8 * (e / 2) of the warp's 16 and column
// 8 * j + 2 * (lane % 4) + e % 2.
#pragma once

#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_gemm.cuh"
#include "philox.cuh"

namespace nrse {

constexpr int kAttnHeadDim = 64;

struct AttnDrop {
  const float* mask;  // explicit [B, H, T, 64] mask (mode 2), or null
  const uint2* key;   // Philox key (mode 1): the seed pair in device memory
  float p, scale;     // drop probability and keep scale 1 / (1 - p)
  int mode;           // 0 none, 1 Philox, 2 explicit mask
  // K1's merged [B, T, cg] layout that mode 1 indexes: this call's heads
  // are its columns from c0 (cg = H * 64, c0 = 0 unless the heads are a
  // shard of a wider layer's)
  uint32_t cg, c0;

  // The explicit mask's multiplier of element (b, h, t, d) (mode 2).
  __device__ __forceinline__ float mask_at(int b, int h, int t, int d, int H,
                                           int T) const {
    return mask[((static_cast<size_t>(b) * H + h) * T + t) * kAttnHeadDim +
                d];
  }

  // Mode 1 with one draw per group of four (kernel A's output): the keep
  // bits of a thread's rows t0 (word .x) and t0 + 8 (word .y) over the 64
  // head-dim columns, in the m16n8 / m64nN accumulator layout, where the
  // thread holds columns 8 jd + 2 (lane % 4) + e (jd < 8, e < 2).  Lanes
  // 2 m and 2 m + 1 hold the two halves of each group of four columns, so
  // the even lane draws row t0's groups, the odd lane row t0 + 8's, and
  // they swap the words: bit 4 jd + 2 (lane % 2) + e keeps column
  // 8 jd + 2 (lane % 4) + e.  Rows >= T are not drawn.  Every lane of the
  // warp must call it.
  __device__ __forceinline__ uint2 keep_bits_rows(int b, int h, int t0,
                                                  int H, int T,
                                                  int lane) const {
    const int par = lane & 1;
    const int t = t0 + 8 * par;
    uint32_t own = 0u;
    if (t < T) {
      const uint2 k = __ldg(key);
      const uint64_t g0 = (static_cast<uint64_t>(b * T + t) * cg + c0 +
                           static_cast<uint64_t>(h) * kAttnHeadDim +
                           4 * ((lane & 3) >> 1)) >> 2;
#pragma unroll
      for (int jd = 0; jd < kAttnHeadDim / 8; ++jd) {
        own |= philox_keep_bits4(k.x, k.y, g0 + 2 * jd, 0u, p) << (4 * jd);
      }
    }
    const uint32_t other = __shfl_xor_sync(0xffffffffu, own, 1);
    return par ? make_uint2(other, own) : make_uint2(own, other);
  }

  // The keep multiplier of column 8 jd + 2 (lane % 4) + e of row t of a
  // thread's half hf, from keep_bits_rows' words (mode 1) or the explicit
  // mask (mode 2).
  __device__ __forceinline__ float keep_col(const uint2& bits, int hf,
                                            int jd, int e, int lane, int b,
                                            int h, int t, int H,
                                            int T) const {
    if (mode == 1) {
      const uint32_t w = hf ? bits.y : bits.x;
      return (w >> (4 * jd + 2 * (lane & 1) + e)) & 1u ? scale : 0.f;
    }
    return mask_at(b, h, t, 8 * jd + 2 * (lane & 3) + e, H, T);
  }
};

namespace attn {

using bf16 = __nv_bfloat16;
using gemm::ldmatrix_x4;
using gemm::ldmatrix_x4_trans;
using gemm::mma_bf16;

constexpr int kHeadDim = kAttnHeadDim;  // D: WavLM base/large
constexpr int kTile = 64;               // keys or queries of a tile
constexpr int kWarps = 4;               // 16 rows of the tile each
constexpr int kThreads = kWarps * 32;
constexpr int kLd = kHeadDim + 8;       // padded bf16 tile row
constexpr int kBiasLd = kTile + 4;      // padded f32 bias tile row
constexpr int kNT = kTile / 8;          // n8 tiles across 64 columns: 8
constexpr int kKT = kHeadDim / 16;      // k16 steps across D: 4

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void zero(float (&acc)[kNT][4]) {
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// rows row0.. of a head's [T, D] bf16 tensor into a [kTile, kLd] tile;
// rows >= T zero-filled
__device__ __forceinline__ void load_tile(bf16* s, const bf16* head,
                                          int row0, int T) {
  for (int c = threadIdx.x; c < kTile * (kHeadDim / 8); c += kThreads) {
    const int r = c / (kHeadDim / 8);
    const int col = (c % (kHeadDim / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < T) {
      v = *reinterpret_cast<const uint4*>(
          head + static_cast<size_t>(row0 + r) * kHeadDim + col);
    }
    *reinterpret_cast<uint4*>(s + r * kLd + col) = v;
  }
}

// bias[h, q0 + qi, k0 + kj] into bs[qi][kj] (zero outside T x T)
__device__ __forceinline__ void load_bias_tile(float* bs, const float* bias,
                                               int h, int q0, int k0, int T) {
  for (int c = threadIdx.x; c < kTile * kTile; c += kThreads) {
    const int qi = c / kTile;
    const int kj = c % kTile;
    const int q = q0 + qi;
    const int k = k0 + kj;
    bs[qi * kBiasLd + kj] =
        q < T && k < T ? bias[(static_cast<size_t>(h) * T + q) * T + k] : 0.f;
  }
}

// acc[j] += rows . cols^T over D: the warp's 16 rows at `rows` against the
// kTile rows of `cols` (n8 tile j: rows 8j..8j+7), both [row][d] tiles
__device__ __forceinline__ void mma_rows_cols(float (&acc)[kNT][4],
                                              const bf16* rows,
                                              const bf16* cols, int lane) {
#pragma unroll
  for (int kk = 0; kk < kKT; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, rows + (lane % 16) * kLd + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int j = 0; j < kNT; j += 2) {
      uint32_t r[4];
      ldmatrix_x4(r, cols + (j * 8 + (lane % 8) + (lane / 16) * 8) * kLd +
                         kk * 16 + ((lane / 8) % 2) * 8);
      mma_bf16(acc[j], a, r[0], r[1]);
      mma_bf16(acc[j + 1], a, r[2], r[3]);
    }
  }
}

// out[jd] += bf16(p) . vals: p (16 x 64) an f32 accumulator of
// mma_rows_cols, fed back as the A operand; vals the [64 rows][d] tile
// whose rows are p's columns
__device__ __forceinline__ void mma_acc_vals(float (&out)[kNT][4],
                                             const float (&p)[kNT][4],
                                             const bf16* vals, int lane) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int jd = 0; jd < kNT; jd += 2) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, vals + (kk * 16 + ((lane / 8) % 2) * 8 +
                                   (lane % 8)) * kLd +
                               jd * 8 + (lane / 16) * 8);
      mma_bf16(out[jd], a, r[0], r[1]);
      mma_bf16(out[jd + 1], a, r[2], r[3]);
    }
  }
}

}  // namespace attn
}  // namespace nrse
