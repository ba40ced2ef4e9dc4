// Fused stride-2 conv + channel LayerNorm + exact GELU, forward and
// backward (K6), on wgmma + TMA.
//
// Replaces: nrse_tpu/ops/fused_frontend.py::_fwd_kernel and ::_bwd_kernel
// (with the tap-2 shift-add of its _fused_bwd), the Pallas TPU kernels of
// fused_conv_ln_gelu: layers 1-6 of wavlm-large's conv frontend, a Conv1d
// of stride 2, kernel size k in {2, 3}, C = 512 channels in and out, on
// channels-last x [B, T_in, C] bf16.  With T_out = (T_in - k) / 2 + 1:
//
//   z[t]   = sum_j x[2t + j] . W[j] + bias            f32 accumulation
//   x̂[t]   = (z[t] - mean) * rstd                      fast variance, f32
//   out[t] = gelu(x̂[t] * gamma + beta)                 exact erf
//
// Row t's operand is the run x[2t .. 2t + k - 1] = k * C contiguous values
// of the row-major input, read in place (no padded copy, no shifted tap-2
// tensor) through two 3-D tensor maps (channel, t, b) of x:
//   taps 0-1: inner extent 2C, t-stride 2C, b-stride T_in C, t-extent T_out;
//   tap 2:    the same strides from x + 2C, inner extent C.
// Each stops at its own batch's rows (row t's last element is x[b, 2t + k
// - 1], inside the batch), and rows >= T_out read as zeros: with an odd
// T_in a 2-D pair view of the whole tensor would run into the next batch.
// The maps' geometry is the wrapper's (ops/fused_frontend.py::tma_maps),
// handed to the C entries as words (map_geometry there).
//
// What bounds it on the H100: operations.  2 * B * T_out * k * C^2: 0.81
// TFLOP at layer 1 of the SER fine-tune (B = 32, T_out = 15999, k = 3),
// 0.82 ms at 989 TFLOP/s, against ~2.1 GB of bytes (0.63 ms); the backward
// is twice the products.
//
// What the design does about it.  Every kernel has two consumer
// warpgroups running wgmma.m64n256k16 (128 f32 accumulators a thread) and
// a producer whose first thread keeps a ring of K-tiles of 64 bf16 (one
// 128-byte swizzle row) full by TMA, each stage completing on a "full"
// mbarrier and released on an "empty" one by every consumer warp once the
// product that read it is done.  The backward's products have one producer
// warp (288 threads); nine warps put three on one of the SM's four
// register files, so ptxas still caps a thread at 168 registers, which the
// products fit.  The forward's epilogue does not: it has a producer
// warpgroup (384 threads) that gives up registers by setmaxnreg (40 a
// thread), so that the consumers run with 232.  Blocks are persistent
// where tiles are many, so a block's producer fills the next tile's stages
// during the epilogue.
//   * forward, k6_fwd_wgmma_kernel: a block owns 64 rows and all 512
//     channels (warpgroup w: channels 256 w ..), so a row's LayerNorm never
//     leaves the block.  A stage is x's 64 x 64 (8 KB) and W's 512 x 64
//     (64 KB); 3 stages.  x's tiles are copied under an evict-first L2
//     policy and W's under evict-last, so that the stream of x, out and x̂
//     does not push W (1.5 MB at k = 3, read by every block) out of L2.
//     No cluster: W's tiles multicast by TMA across clusters of 2 or 4
//     blocks measured about 40% slower at layer 1 of the fine-tune
//     (PERF.md): L2 serves W's tiles fast enough, and a cluster's coupled
//     pipelines stall on each other.  The epilogue stays in
//     registers: the bias, the row statistics (quad shuffles, then the two
//     warpgroups' partials through shared memory, summed in a fixed order),
//     the LayerNorm and the GELU.  z never goes to HBM.  x̂ and out are
//     staged in W's part of the tile's last two stages (held back from the
//     producer until they are stored) and stored by the warpgroup's
//     threads, 16 bytes each, in whole 128-byte rows; rstd by warpgroup 0.
//     Stored from registers, 4 bytes a thread and 16 a row, they had taken
//     as long as the products.  Only the producer's next loads overlap the
//     epilogue: the tensor cores wait for it, and it is about a third of
//     the kernel's time (tools/k6_breakdown.py times the parts).
//   * backward, four steps, because blocks on this card run in no order and
//     cannot carry sums across a grid as the TPU's sequential grid does in
//     revisited VMEM blocks:
//       1. a row pass (row_layernorm.cuh): gelu'(x̂ gamma + beta) -> the
//          LayerNorm backward -> dz (bf16 [B, T_out, C]), with per-block
//          partials of dgamma, dbeta and dbias (dz in f32), then folded in
//          block order;
//       2. k6_dx_wgmma_kernel: pair row p of dx is [dz[p] W0^T + dz[p-1]
//          W2^T | dz[p] W1^T] (K = 1024 or 512), tiles of 128 pair rows x
//          256 columns, both operands K-major: dz through a per-batch 3-D
//          map, dz[p-1] as the box at t-coordinate p0 - 1 (zeros before
//          row 0 and past T_out), the kernel's taps as B.  One f32
//          accumulation and one rounding; the tile is staged in its last
//          two stages and stored by the threads, rows 2p + half below T_in
//          only, and rows the conv never read (the trailing sample for k =
//          2 and odd T_in) get exactly 0;
//       3. k6_dw_wgmma_kernel: dW [k C, C] = A^T dz over all rows, both
//          operands MN-major (x's tap maps, dz's map), the rows walked batch
//          by batch in 64-row K-tiles (ragged ends zero filled) and split
//          into a fixed number of chunks that fill the card's SMs
//          (ops/fused_frontend.py::bwd_plan); 128 x 256 tiles;
//       4. the f32 partials folded in chunk order.
//     No atomics: two calls give the same bits.  dz still makes one round
//     trip through HBM (the row pass: ~1 ms of layer 1's backward).
//     A staging buffer of the stores' own, so that a tile's stores drain
//     during the next tile's products, measured slower: the room for it
//     leaves the forward a ring of 4 stages of 32-deep K-tiles, on which
//     the products ran far slower than on 3 of 64 (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_gemm.cuh"
#include "row_layernorm.cuh"
#include "wgmma_common.cuh"

namespace {

using nrse::gemm::gelu_erf;
using nrse::gemm::gelu_erf_grad;
using namespace nrse::wg;

constexpr int kC = 512;                // channels: a forward block holds a row
constexpr int kBK = 64;                // K-tile: 64 bf16, one 128-byte row
constexpr int kRowBytes = kBK * 2;
constexpr int kConsumerThreads = 256;  // two warpgroups
constexpr int kThreads = kConsumerThreads + 32;  // and one producer warp
constexpr int kProducerWarp = kConsumerThreads / 32;
// the forward's: a producer warpgroup (its first thread issues the
// copies), so that setmaxnreg can move its registers to the consumers
constexpr int kFThreads = kConsumerThreads + 128;
constexpr int kFProducerRegs = 40;
constexpr int kFConsumerRegs = 232;  // 256 x 232 + 128 x 40 <= 65536
constexpr int kEmptyArrivals = kConsumerThreads / 32;  // per block

// forward: 64 rows x 512 channels a block
constexpr int kFRows = 64;
constexpr int kFStages = 3;
constexpr int kFXBytes = kFRows * kRowBytes;               // 8 KB
constexpr int kFStageBytes = kFXBytes + kC * kRowBytes;    // + 64 KB of W
constexpr int kFSmemBytes = 1024 /* alignment slack */ +
                            kFStages * kFStageBytes + 2 * kFStages * 8 +
                            2 * 2 * kFRows * 4;  // the statistics' partials

// backward products: 128 x 256 output tiles
constexpr int kGM = 128;
constexpr int kGN = 256;
constexpr int kGStages = 4;
constexpr int kGABytes = kGM * kRowBytes;                  // 16 KB
constexpr int kGStageBytes = kGABytes + kGN * kRowBytes;   // + 32 KB
constexpr int kGSmemBytes = 1024 + kGStages * kGStageBytes + 2 * kGStages * 8;
constexpr int kBox = 64 * kRowBytes;  // one 64 x 64 box: 8 KB

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// A barrier of the 128 threads of one consumer warpgroup (ids 2 and 3).
__device__ __forceinline__ void wg_sync() {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + threadIdx.x / 128)
               : "memory");
}

// Byte offset, in a staging tile of 64-row x 64-column bf16 boxes with
// 16-byte chunks swizzled across each row, of a consumer thread's pair of
// columns 8 j + 2 (lane % 4), + 1 at row row0 + 8 h of its warpgroup's 64
// rows, row0 = 16 (warp % 4) + lane / 4: box j / 8, chunk j % 8 of the row
// XOR the row's phase (lane / 4 for both of the thread's rows).  A warp's
// 32 pairs land in 32 different banks.
__device__ __forceinline__ int stage_offset(int j, int h) {
  const int lane = threadIdx.x & 31;
  const int row = (threadIdx.x >> 5 & 3) * 16 + (lane >> 2) + 8 * h;
  return (j >> 3) * kBox + row * kRowBytes +
         (((j & 7) ^ (lane >> 2)) << 4) + 4 * (lane & 3);
}

// A consumer warpgroup's store of its staged tile, 64 rows x 256 columns
// (4 boxes): row r to dst + first + r * row_step + col0 .. for r <
// valid_rows, in whole 128-byte rows, 16 bytes a thread (a warp: 4 rows of
// one box).  Barriers before (the staging is written) and after (it may be
// written again).
__device__ __forceinline__ void store_rows(const uint8_t* tile,
                                           bf16* __restrict__ dst,
                                           size_t first, int row_step,
                                           int valid_rows, int col0) {
  wg_sync();
  const int tid = threadIdx.x % 128;
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    const int idx = tid + 128 * i;  // box idx / 512, row, chunk idx % 8
    const int r = idx / 8 % 64;
    const int c = idx % 8;
    if (r >= valid_rows) continue;
    const int box = idx / 512;
    const uint4 v = *reinterpret_cast<const uint4*>(
        tile + box * kBox + r * kRowBytes + ((c ^ (r % 8)) << 4));
    *reinterpret_cast<uint4*>(dst + first +
                              static_cast<size_t>(r) * row_step + col0 +
                              64 * box + 8 * c) = v;
  }
  wg_sync();
}

__device__ __forceinline__ void put_bf16x2(uint8_t* tile, int off, float x0,
                                           float x1) {
  *reinterpret_cast<__nv_bfloat162*>(tile + off) =
      __floats2bfloat162_rn(x0, x1);
}

// An L2 cache policy for the copies of the forward: x's tiles are read
// about once (evict first), W's by every block (evict last), so that the
// stream of x, out and x̂ does not push W out of L2.
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

// tma_load_3d and tma_load_2d under an L2 cache policy.
__device__ __forceinline__ void tma_load_3d_hint(void* dst,
                                                 const CUtensorMap* map,
                                                 int c0, int c1, int c2,
                                                 uint64_t* bar,
                                                 uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d_hint(void* dst,
                                                 const CUtensorMap* map,
                                                 int c0, int c1,
                                                 uint64_t* bar,
                                                 uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "l"(policy)
      : "memory");
}

// A consumer warp's release of a stage: one arrival on its empty barrier.
__device__ __forceinline__ void release(uint64_t* bar) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// A consumer warpgroup's products over `ktiles` stages of the ring, from
// the ring's iteration `it` on: acc = sum of A . B, A's 64 rows at byte
// `a_off` of a stage and B's 256 at `b_off` (both K-major, or with kMN
// both MN-major: A one 64 x 64 box, B four boxes 8 KB apart).  Each stage
// is released once the product that read it is done, one kept in flight,
// except the last `hold` (<= ktiles) stages: the epilogue stages its
// output tile there and releases them itself.
template <int kMN, int kStagesN, int kStageBytes>
__device__ __forceinline__ void consume(float (&acc)[128], uint8_t* ring,
                                        uint64_t* full, uint64_t* empty,
                                        uint32_t& it, int ktiles, int a_off,
                                        int b_off, int hold) {
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  int prev = 0;
  for (int kt = 0; kt < ktiles; ++kt, ++it) {
    const int s = static_cast<int>(it % kStagesN);
    mbar_wait(&full[s], (it / kStagesN) & 1);
    const uint8_t* st = ring + s * kStageBytes;
    const uint64_t da = sw128_desc(st + a_off);
    const uint64_t db = kMN ? sw128_mn_desc(st + b_off, kBox)
                            : sw128_desc(st + b_off);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kBK / 16; ++k) {
      // a 16-deep step: 32 bytes along a K-major row (2 descriptor units),
      // or 16 rows of 128 bytes of an MN-major box (128 units)
      const int step = kMN ? 128 * k : 2 * k;
      wgmma_m64n256k16<kMN, kMN>(acc, da + step, db + step, 1);
    }
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<1>();
    fence_acc(acc);
    if (kt > 0 && kt - 1 < ktiles - hold) release(&empty[prev]);
    prev = s;
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (ktiles > 0 && hold == 0) release(&empty[prev]);
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
}

// The forward's epilogue of a consumer thread: accumulator element
// acc[4 j + 2 h + e] is row row0 + 8 h of the tile, channel col0 + 8 j + e.
// out and x̂ (when xhat is not null) go through `os` and `xs`, this
// warpgroup's 32 KB of the tile's last two stages.
__device__ __forceinline__ void fwd_epilogue(
    float (&acc)[128], float* red, uint8_t* os, uint8_t* xs,
    const float* __restrict__ bias, const float* __restrict__ gamma,
    const float* __restrict__ beta, bf16* __restrict__ out,
    bf16* __restrict__ xhat, float* __restrict__ rstd, int b, int t0,
    int T_out, float eps) {
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int row0 = (threadIdx.x / 32) % 4 * 16 + lane / 4;
  const int col0 = wg * 256 + 2 * (lane % 4);
  // row sums of z and z^2 over this warpgroup's 256 channels (scalars:
  // arrays indexed by h kept a stack frame)
  float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float2 bv = *reinterpret_cast<const float2*>(bias + col0 + 8 * j);
    float* z = acc + 4 * j;
    z[0] += bv.x;
    z[1] += bv.y;
    z[2] += bv.x;
    z[3] += bv.y;
    s0 += z[0] + z[1];
    q0 += z[0] * z[0] + z[1] * z[1];
    s1 += z[2] + z[3];
    q1 += z[2] * z[2] + z[3] * z[3];
  }
#pragma unroll
  for (int m = 1; m <= 2; m *= 2) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, m);
    s1 += __shfl_xor_sync(0xffffffffu, s1, m);
    q0 += __shfl_xor_sync(0xffffffffu, q0, m);
    q1 += __shfl_xor_sync(0xffffffffu, q1, m);
  }
  // [wg][sum | sum of squares][64 rows]
  float* mine = red + wg * 2 * kFRows;
  if (lane % 4 == 0) {
    mine[row0] = s0;
    mine[row0 + 8] = s1;
    mine[kFRows + row0] = q0;
    mine[kFRows + row0 + 8] = q1;
  }
  consumers_sync();
  // both warpgroups' partials, in a fixed order
  const float mean0 = (red[row0] + red[2 * kFRows + row0]) * (1.f / kC);
  const float mean1 =
      (red[row0 + 8] + red[2 * kFRows + row0 + 8]) * (1.f / kC);
  const float inv0 = rsqrtf(
      fmaxf((red[kFRows + row0] + red[3 * kFRows + row0]) * (1.f / kC) -
                mean0 * mean0,
            0.f) +
      eps);
  const float inv1 = rsqrtf(
      fmaxf((red[kFRows + row0 + 8] + red[3 * kFRows + row0 + 8]) *
                    (1.f / kC) -
                mean1 * mean1,
            0.f) +
      eps);
  consumers_sync();  // the next tile may write the partials again
  if (rstd != nullptr && wg == 0 && lane % 4 == 0) {
    float* r = rstd + static_cast<size_t>(b) * T_out + t0 + row0;
    if (t0 + row0 < T_out) r[0] = inv0;
    if (t0 + row0 + 8 < T_out) r[8] = inv1;
  }
  // x̂ replaces z in the accumulators; x̂ (the training entry's) and then
  // out go through the staging tile, this warpgroup's 4 boxes of 64 rows x
  // 64 channels, rows past T_out left out
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    float* z = acc + 4 * j;
    z[0] = (z[0] - mean0) * inv0;
    z[1] = (z[1] - mean0) * inv0;
    z[2] = (z[2] - mean1) * inv1;
    z[3] = (z[3] - mean1) * inv1;
  }
  // x̂ is staged in `xs` and out in `os`, and both are stored after the
  // GELU, when the accumulators are dead: fewer registers live during the
  // stores
  if (xhat != nullptr) {
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        put_bf16x2(xs, stage_offset(j, h), acc[4 * j + 2 * h],
                   acc[4 * j + 2 * h + 1]);
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float2 g = *reinterpret_cast<const float2*>(gamma + col0 + 8 * j);
    const float2 be = *reinterpret_cast<const float2*>(beta + col0 + 8 * j);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      put_bf16x2(os, stage_offset(j, h),
                 gelu_erf(acc[4 * j + 2 * h] * g.x + be.x),
                 gelu_erf(acc[4 * j + 2 * h + 1] * g.y + be.y));
  }
  const size_t first = (static_cast<size_t>(b) * T_out + t0) * kC;
  if (xhat != nullptr) store_rows(xs, xhat, first, kC, T_out - t0, wg * 256);
  store_rows(os, out, first, kC, T_out - t0, wg * 256);
}

// Forward, persistent: block i walks the 64-row tiles i, i + gridDim.x,
// ... (tile = b * tiles_per_batch + t / 64).
__global__ void __launch_bounds__(kFThreads, 1)
k6_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x01,
                    const __grid_constant__ CUtensorMap tm_x2,
                    const __grid_constant__ CUtensorMap tm_w,
                    const float* __restrict__ bias,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta, bf16* __restrict__ out,
                    bf16* __restrict__ xhat, float* __restrict__ rstd, int B,
                    int T_out, int k, float eps) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kFStages * kFStageBytes);
  uint64_t* empty = full + kFStages;
  float* red = reinterpret_cast<float*>(empty + kFStages);

  const int ktiles = k * kC / kBK;
  const int per_batch = (T_out + kFRows - 1) / kFRows;
  const int tiles = B * per_batch;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kFStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kEmptyArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp >= kProducerWarp) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kFProducerRegs));
    if (threadIdx.x == kConsumerThreads) {
      const uint64_t stream = l2_evict_first(), keep = l2_evict_last();
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int b = tile / per_batch;
        const int t0 = tile % per_batch * kFRows;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = static_cast<int>(it % kFStages);
          mbar_wait(&empty[s], ((it / kFStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], kFStageBytes);
          uint8_t* st = ring + s * kFStageBytes;
          const int c = kt * kBK;
          if (c < 2 * kC) {
            tma_load_3d_hint(st, &tm_x01, c, t0, b, &full[s], stream);
          } else {
            tma_load_3d_hint(st, &tm_x2, c - 2 * kC, t0, b, &full[s],
                             stream);
          }
          // W's 512 rows in two boxes of 256
          for (int r = 0; r < kC; r += 256) {
            tma_load_2d_hint(st + kFXBytes + r * kRowBytes, &tm_w, c, r,
                             &full[s], keep);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kFConsumerRegs));
    const int wg = warp / 4;
    float acc[128];
    uint32_t it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int hold = xhat != nullptr ? 2 : 1;  // the staging stages
      consume<0, kFStages, kFStageBytes>(acc, ring, full, empty, it, ktiles,
                                         0, kFXBytes + wg * 256 * kRowBytes,
                                         hold);
      // W's part (64 KB) of the last stage holds out, of the one before x̂
      const int last = static_cast<int>((it - 1) % kFStages);
      const int before = static_cast<int>((it - 2) % kFStages);
      const int part = kFXBytes + wg * 4 * kBox;
      fwd_epilogue(acc, red, ring + last * kFStageBytes + part,
                   ring + before * kFStageBytes + part, bias, gamma, beta,
                   out, xhat, rstd, tile / per_batch,
                   tile % per_batch * kFRows, T_out, eps);
      // the staging's writes before the producer's next copy into it
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      release(&empty[last]);
      if (hold == 2) release(&empty[before]);
    }
  }
}

// Backward step 1's rows: x̂ given, the cotangent through GELU'.
struct K6RowSource {
  const bf16* xhat;
  const bf16* dout;
  const float* rstd;
  const float* gamma;
  const float* beta;
  __device__ __forceinline__ float load(int row, int c, float (&d)[8],
                                        float (&xh)[8]) const {
    const size_t off = static_cast<size_t>(row) * kC + c;
    load8(xhat + off, xh);
    load8(dout + off, d);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      d[e] *= gelu_erf_grad(xh[e] * gamma[c + e] + beta[c + e]);
    return rstd[row];
  }
};

// Backward step 2, persistent: tile = (b, pair-row tile, nt), nt fastest;
// nt / 2 is the half of the pair (0: x row 2p, 1: x row 2p + 1), nt % 2
// its 256 columns.  tm_dz is dz as (C, T_out, B) in boxes of 64 x 128
// rows, tm_wk the kernel [k C_in, C_out] in boxes of 64 x 256 rows.
__global__ void __launch_bounds__(kThreads, 1)
k6_dx_wgmma_kernel(const __grid_constant__ CUtensorMap tm_dz,
                   const __grid_constant__ CUtensorMap tm_wk,
                   bf16* __restrict__ dx, int B, int T_in, int k) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kGStages * kGStageBytes);
  uint64_t* empty = full + kGStages;
  const int per_batch = ((T_in + 1) / 2 + kGM - 1) / kGM;
  const int tiles = B * per_batch * 4;
  const int per_part = kC / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kGStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kEmptyArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp == kProducerWarp) {
    if (threadIdx.x % 32 != 0) return;
    uint32_t it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int nt = tile % 4;
      const int p0 = tile / 4 % per_batch * kGM;
      const int b = tile / 4 / per_batch;
      const int half = nt / 2;
      const int n0 = nt % 2 * kGN;
      const int parts = (half == 0 && k == 3) ? 2 : 1;
      for (int kt = 0; kt < parts * per_part; ++kt, ++it) {
        const int s = static_cast<int>(it % kGStages);
        const int part = kt / per_part;  // 1: tap 2, dz one row back
        const int o0 = kt % per_part * kBK;
        const int tap = half == 1 ? 1 : (part == 0 ? 0 : 2);
        mbar_wait(&empty[s], ((it / kGStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], kGStageBytes);
        uint8_t* st = ring + s * kGStageBytes;
        tma_load_3d(st, &tm_dz, o0, p0 - part, b, &full[s]);
        tma_load_2d(st + kGABytes, &tm_wk, o0, tap * kC + n0, &full[s]);
      }
    }
    return;
  }
  const int wg = warp / 4;
  float acc[128];
  uint32_t it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int nt = tile % 4;
    const int p0 = tile / 4 % per_batch * kGM;
    const int b = tile / 4 / per_batch;
    const int half = nt / 2;
    const int parts = (half == 0 && k == 3) ? 2 : 1;
    consume<0, kGStages, kGStageBytes>(acc, ring, full, empty, it,
                                       parts * per_part, wg * 64 * kRowBytes,
                                       kGABytes, 2);
    // the last two stages hold the tile's output, warpgroup w's 64 pair
    // rows x 256 columns (32 KB) in the w-th of them: x's rows 2p + half
    // below T_in
    const int mine = static_cast<int>((it - 2 + wg) % kGStages);
    const int other = static_cast<int>((it - 1 - wg) % kGStages);
    consumers_sync();  // both warpgroups' products have read both stages
    release(&empty[other]);
    uint8_t* staging = ring + mine * kGStageBytes;
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        put_bf16x2(staging, stage_offset(j, h), acc[4 * j + 2 * h],
                   acc[4 * j + 2 * h + 1]);
    const int q = 2 * (p0 + wg * 64) + half;  // x's row of the first
    store_rows(staging, dx, (static_cast<size_t>(b) * T_in + q) * kC,
                  2 * kC, (T_in - q + 1) / 2, nt % 2 * kGN);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    release(&empty[mine]);
  }
}

// Backward step 3: one chunk of the split-K product
//   part[chunk][m][n] = sum over rows (b, t) of the chunk of A[m] dz[n],
// A = x[b, 2t .. 2t + k - 1] (k C values).  The rows are walked as 64-row
// K-tiles q = b * per_batch + t / 64, chunk c taking K-tiles [c per, (c +
// 1) per); blockIdx.x is the 128 x 256 output tile (n fastest).  The maps
// are the forward's x maps and dz as (C, T_out, B) in boxes of 64 x 64.
__global__ void __launch_bounds__(kThreads, 1)
k6_dw_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x01,
                   const __grid_constant__ CUtensorMap tm_x2,
                   const __grid_constant__ CUtensorMap tm_dz,
                   float* __restrict__ part, int B, int T_out, int k) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kGStages * kGStageBytes);
  uint64_t* empty = full + kGStages;
  const int n0 = blockIdx.x % 2 * kGN;
  const int m0 = blockIdx.x / 2 * kGM;
  const int per_batch = (T_out + 63) / 64;
  const int total = B * per_batch;
  const int per = (total + gridDim.y - 1) / gridDim.y;
  const int q0 = blockIdx.y * per;
  const int q1 = min(total, q0 + per);
  const int ktiles = q1 > q0 ? q1 - q0 : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kGStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kEmptyArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp == kProducerWarp) {
    if (threadIdx.x % 32 != 0) return;
    const bool tap2 = m0 >= 2 * kC;
    const CUtensorMap* ma = tap2 ? &tm_x2 : &tm_x01;
    const int mc = tap2 ? m0 - 2 * kC : m0;
    uint32_t it = 0;
    for (int q = q0; q < q1; ++q, ++it) {
      const int s = static_cast<int>(it % kGStages);
      const int b = q / per_batch;
      const int t0 = q % per_batch * 64;
      mbar_wait(&empty[s], ((it / kGStages) & 1) ^ 1);
      mbar_expect_tx(&full[s], kGStageBytes);
      uint8_t* st = ring + s * kGStageBytes;
      tma_load_3d(st, ma, mc, t0, b, &full[s]);
      tma_load_3d(st + kBox, ma, mc + 64, t0, b, &full[s]);
#pragma unroll
      for (int i = 0; i < kGN / 64; ++i)
        tma_load_3d(st + kGABytes + i * kBox, &tm_dz, n0 + 64 * i, t0, b,
                    &full[s]);
    }
    return;
  }
  const int wg = warp / 4;
  const int lane = threadIdx.x % 32;
  float acc[128];
  uint32_t it = 0;
  consume<1, kGStages, kGStageBytes>(acc, ring, full, empty, it, ktiles,
                                     wg * kBox, kGABytes, 0);
  float* dst = part + static_cast<size_t>(blockIdx.y) * k * kC * kC;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + wg * 64 + warp % 4 * 16 + lane / 4 + 8 * h;
    float* row = dst + static_cast<size_t>(m) * kC + n0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 32; ++j)
      *reinterpret_cast<float2*>(row + 8 * j) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

bool bad_shape(int B, int T_in, int T_out, int k) {
  return B < 1 || (k != 2 && k != 3) || T_out < 1 ||
         T_out != (T_in - k) / 2 + 1;
}

// The words of one 3-D map's geometry as the wrapper hands it over
// (ops/fused_frontend.py::map_geometry): its first element (an offset into
// the tensor), dims, strides (in elements) and box, each innermost first
// (channel, row, batch).
constexpr int kMapWords = 10;

// The tensor map of a 3-D bf16 view of a channels-last tensor at `base`
// with geometry `g`, in boxes of 64 channels x `box_rows` rows of one
// batch under the 128-byte swizzle; zeros past the end of any dimension
// (or before its start).  A geometry whose box the kernels do not copy
// (their transaction bytes assume it) is refused.
cudaError_t view_map(CUtensorMap* map, const void* base, const long long* g,
                     int box_rows) {
  if (g[0] < 0 || g[4] != 1 || g[7] != kBK || g[8] != box_rows || g[9] != 1)
    return cudaErrorInvalidValue;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(g[1]),
                              static_cast<cuuint64_t>(g[2]),
                              static_cast<cuuint64_t>(g[3])};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(g[5]) * 2,
                                 static_cast<cuuint64_t>(g[6]) * 2};
  const cuuint32_t box[3] = {kBK, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<bf16*>(static_cast<const bf16*>(base) +
                                          g[0]),
                        dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// Forward.  x [B, T_in, 512] bf16; w [512, k * 512] bf16 (row o: tap j's
// column o at j * 512 + c); bias, gamma, beta [512] f32 -> out [B, T_out,
// 512] bf16; xhat (bf16, like out) and rstd ([B, T_out] f32) when not null.
// `maps`: x's tap maps (taps 0-1, tap 2), `kMapWords` each; `grid`
// persistent blocks of `smem` bytes of shared memory: the wrapper's plan
// (ops/fused_frontend.py::fwd_plan), which must agree with this file's.
extern "C" int nrse_fused_frontend_fwd(const void* x, const void* w,
                                       const void* bias, const void* gamma,
                                       const void* beta, void* out,
                                       void* xhat, void* rstd,
                                       const void* maps, int B, int T_in,
                                       int T_out, int k, float eps, int grid,
                                       int smem, void* stream) {
  if (bad_shape(B, T_in, T_out, k) || grid < 1 || smem != kFSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* g = static_cast<const long long*>(maps);
  CUtensorMap x01, x2, wm;
  cudaError_t err = view_map(&x01, x, g, kFRows);
  if (err == cudaSuccess) err = view_map(&x2, x, g + kMapWords, kFRows);
  if (err == cudaSuccess) {
    const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(k * kC), kC};
    const cuuint32_t wbox[2] = {kBK, 256};
    err = make_sw128_map(&wm, w, 2, wdims, wbox);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(k6_fwd_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kFSmemBytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  k6_fwd_wgmma_kernel<<<grid, kFThreads, kFSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      x01, x2, wm, static_cast<const float*>(bias),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<bf16*>(out), static_cast<bf16*>(xhat),
      static_cast<float*>(rstd), B, T_out, k, eps);
  return static_cast<int>(cudaGetLastError());
}

// Backward.  dout [B, T_out, 512], x [B, T_in, 512], xhat [B, T_out, 512]
// bf16, rstd [B, T_out] f32, wk [k, 512, 512] bf16 (the kernel, [tap, C_in,
// C_out]), gamma, beta [512] f32 -> dz [B, T_out, 512] bf16 (scratch kept
// for the products), dx [B, T_in, 512] bf16, dkernel [k, 512, 512] f32 and
// vecs [3, 512] f32 (dgamma, dbeta, dbias).  Scratch: vec_part f32 of
// 3 * row_bwd_blocks(B T_out) * 512, dw_part f32 of chunks * k * 512^2.
// `maps`: dz's map for the dx product, x's tap maps (taps 0-1, tap 2) and
// dz's map for the dW product, `kMapWords` each; dx_grid persistent dx
// blocks, `chunks` row chunks of dW, `smem` bytes a product's block: the
// wrapper's plan (ops/fused_frontend.py::bwd_plan).
extern "C" int nrse_fused_frontend_bwd(
    const void* dout, const void* x, const void* xhat, const void* rstd,
    const void* wk, const void* gamma, const void* beta, void* dz, void* dx,
    void* dkernel, void* vecs, void* vec_part, void* dw_part,
    const void* maps, int B, int T_in, int T_out, int k, int dx_grid,
    int chunks, int smem, void* stream) {
  if (bad_shape(B, T_in, T_out, k) || dx_grid < 1 || chunks < 1 ||
      smem != kGSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = B * T_out;
  const K6RowSource src{static_cast<const bf16*>(xhat),
                        static_cast<const bf16*>(dout),
                        static_cast<const float*>(rstd),
                        static_cast<const float*>(gamma),
                        static_cast<const float*>(beta)};
  float* vp = static_cast<float*>(vec_part);
  cudaError_t err = launch_row_bwd<3>(src, static_cast<const float*>(gamma),
                                      static_cast<bf16*>(dz), vp, rows, kC, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_fold_kernel<<<dim3(kC / 256, 3), 256, 0, s>>>(vp, row_bwd_blocks(rows),
                                                   kC, static_cast<float*>(vecs));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long* g = static_cast<const long long*>(maps);
  CUtensorMap dzx, wkm, x01, x2, dzw;
  err = view_map(&dzx, dz, g, kGM);
  if (err == cudaSuccess) {
    const cuuint64_t dims[2] = {kC, static_cast<cuuint64_t>(k * kC)};
    const cuuint32_t box[2] = {kBK, kGN};
    err = make_sw128_map(&wkm, wk, 2, dims, box);
  }
  if (err == cudaSuccess) err = view_map(&x01, x, g + kMapWords, 64);
  if (err == cudaSuccess) err = view_map(&x2, x, g + 2 * kMapWords, 64);
  if (err == cudaSuccess) err = view_map(&dzw, dz, g + 3 * kMapWords, 64);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(k6_dx_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kGSmemBytes);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(k6_dw_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kGSmemBytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  k6_dx_wgmma_kernel<<<dx_grid, kThreads, kGSmemBytes, s>>>(
      dzx, wkm, static_cast<bf16*>(dx), B, T_in, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  float* wp = static_cast<float*>(dw_part);
  k6_dw_wgmma_kernel<<<dim3(k * kC / kGM * (kC / kGN), chunks), kThreads,
                       kGSmemBytes, s>>>(x01, x2, dzw, wp, B, T_out, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = k * kC * kC;
  ln_fold_kernel<<<dim3((total + 255) / 256, 1), 256, 0, s>>>(
      wp, chunks, total, static_cast<float*>(dkernel));
  return static_cast<int>(cudaGetLastError());
}
