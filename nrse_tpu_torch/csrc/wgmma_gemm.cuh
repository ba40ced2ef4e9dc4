// A persistent, warp-specialised bf16 GEMM for Hopper: TMA loads into a
// ring of 128-byte-swizzled shared-memory tiles, wgmma.mma_async on them,
// and an epilogue given as a template parameter (its users: K2's dx and dW
// kernels, fused_ffn_bwd.cu, and kernel B's two products, fused_ffn_fwd.cu).
//
//   out[m, n] = epilogue(sum_k A[m, k] * B[n, k])   f32 accumulation
//
//   a is [M, K] and b is [N, K], both row-major bf16 ("TN": K contiguous in
//   both, wgmma's native K-major operands).  Rows of A past M read as zero
//   (TMA fills a box past the tensor's end with zeros); the epilogue masks
//   them.  Requirements: N % 128 == 0, K % 64 == 0, 16-byte aligned rows.
//
//   The MN-major mode (template parameter kMN, launch_mn): a is [K, M] and
//   b is [K, N], row-major (M and N contiguous: a product that reduces over
//   the rows of both, as a weight gradient reduces over tokens).  A stage
//   holds each operand as two boxes of 64 K rows x 64 M (or N) columns,
//   read by wgmma with its transpose bits set.  K may be ragged: the last
//   K-tile's rows past K arrive as zeros.  Two products with the same K
//   (the same epilogue type) run in one launch, problem 0's tiles first.
//   Requirements: M, N % 128 == 0, 16-byte aligned rows.
//
// Design.  Output tiles of 128 x 128, K-tiles of 64 bf16 = 128 bytes, which
// is one row of CU_TENSOR_MAP_SWIZZLE_128B: a stage holds A's 128 x 64 and
// B's 128 x 64 tile (32 KB) and the ring has kStages of them.  Three
// warpgroups.  The first is the producer: its first thread issues two TMA
// loads per stage, each completing on the stage's "full" mbarrier; its
// other three warps compute each tile's aux words for the epilogue (the
// dropout keep bits, keep_bits_job below) into shared memory.  The other two are consumers
// that take the block's tiles in turn ("ping-pong"): each owns a whole
// tile, two wgmma.m64n128k16 per 16-deep step (rows 0-63 and 64-127, 128
// f32 accumulators a thread), one group kept in flight, a stage released
// on its "empty" mbarrier when the group that read it is done.  The main
// loops alternate through a "done" mbarrier per consumer, so one
// consumer's main loop runs while the other runs its epilogue: the tensor
// cores do not wait for an epilogue.  Blocks are persistent (one per SM,
// tiles strided by the grid, N tiles fastest so B stays in L2).  No
// setmaxnreg: with 384 threads a block ptxas allots each thread at most
// 168 registers, and raising the consumers' count did not let it use more
// (the highest register it names is R165 either way), so the accumulators,
// the epilogue and the Philox draws are arranged to fit in 168 without
// spilling: the draws run on the producer's spare warps.
//
// The epilogue type Epi provides
//   static constexpr bool kSideTile;     whether it writes its bf16 output
//                                        tile into a side tile of shared
//                                        memory beside the ring (4 stages
//                                        then), TMA-stored after it
//   static constexpr bool kSideLoad;     whether the side tile first holds
//                                        the tile of a bf16 [M, N] tensor,
//                                        TMA-loaded during the main loop,
//                                        which the epilogue reads and
//                                        overwrites in place
//   static constexpr int kScratchFloats; shared f32 scratch per consumer
//   static constexpr int kAuxWords;      32-bit aux words per consumer
//                                        thread (0: none), made in kAuxJobs
//   static constexpr int kAuxJobs;       jobs by the producer's spare warps
//   aux(int mt, int n0, int job, uint32_t* words)   one job of the tile
//                                        (mt, n0) into the consumer's words
//   store(float (&acc)[2][64], const TileCtx&, uint8_t* side,
//         float* scratch, const uint32_t* aux)
// Accumulator element acc[r][4 j + 2 h + e] of a consumer thread sits at
// row ctx.row + 64 r + 8 h and column ctx.col + 8 j + e (j < 16; r, h,
// e < 2), the m64nNk16 layout; side is the tile's side tile in shared
// memory (two boxes of 128 rows x 64 columns, 128-byte swizzle) or null;
// scratch is the consumer's own, for use between wg_barrier(ctx) calls;
// aux the thread's kAuxWords words.  The dropout sites' keep bits come from
// keep_bits_job (kKeepAuxWords, kKeepAuxJobs) and are read with keep_pair.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "wgmma_common.cuh"

namespace nrse {
namespace wg {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;  // bf16: 128 bytes, one swizzle row
constexpr int kStages = 6;      // ring depth without a side tile
constexpr int kStagesSide = 4;  // with one: 4 x 32 KB + 2 x 32 KB
constexpr int kConsumers = 2;  // warpgroups, a whole tile each in turn
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kAuxThreads = 96;  // the producer warpgroup's spare warps
constexpr int kTileBytes = kBM * kBK * 2;  // = kBN * kBK * 2: 16 KB
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kSideBytes = kBM * kBN * 2;  // a bf16 tile of the output

template <class Epi>
struct Smem {
  static constexpr int kRing = Epi::kSideTile ? kStagesSide : kStages;
  static constexpr int kSide = Epi::kSideTile ? kConsumers * kSideBytes : 0;
  static constexpr int kBarriers = 2 * kRing + 5 * kConsumers;
  static constexpr int kBytes = 1024 /* alignment slack */ +
                                kRing * kStageBytes + kSide +
                                kBarriers * 8 +
                                kConsumers * Epi::kScratchFloats * 4 +
                                kConsumers * 128 * Epi::kAuxWords * 4;
};
static_assert(kBM == kBN, "one tensor-map box serves A and B");

struct TileCtx {
  int prob = 0;  // the MN-major mode's problem, 0 or 1
  int mt;   // tile row index (blocks of kBM rows)
  int n0;   // first column of the tile
  int row;  // this thread's first accumulator row
  int col;  // this thread's first accumulator column
  // the thread's place, read again from threadIdx (cheaper than registers
  // held beside 128 accumulators)
  __device__ __forceinline__ int lane() const { return threadIdx.x & 31; }
  __device__ __forceinline__ int warp() const {  // 0 .. 3 in the warpgroup
    return (threadIdx.x >> 5) & 3;
  }
  __device__ __forceinline__ int tid() const {  // 0 .. 127 in it
    return threadIdx.x & 127;
  }
  __device__ __forceinline__ int wg() const {  // consumer 0 or 1
    return (threadIdx.x >> 7) - 1;
  }
};

// A barrier of the 128 threads of one consumer warpgroup (ids 1 and 2).
__device__ __forceinline__ void wg_barrier(const TileCtx& ctx) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + ctx.wg()) : "memory");
}

// The keep bits of a dropout site over an [M, ld] tensor, as aux words:
// 4 words a consumer thread, word 2 r + h for its row ctx.row + 64 r + 8 h,
// bit 2 j + e for column ctx.col + 8 j + e.  256 jobs of 16 Philox draws.
constexpr int kKeepAuxWords = 4;
constexpr int kKeepAuxJobs = 256;

// Job (p, r, h) of the tile (mt, n0): the keep bits of consumer threads
// 2 p and 2 p + 1 at row block r, row half h.  In the accumulator layout
// those two threads hold the two halves of each group of four columns of
// the contract (philox.cuh), so one draw per group serves both: words 0-1
// to the even thread (its two columns), 2-3 to the odd one.  Nothing is
// drawn twice or thrown away.  Only for mode 1 (Philox).
__device__ __forceinline__ void keep_bits_job(const DropSite& site, int ld,
                                              int mt, int n0, int job,
                                              uint32_t* words) {
  if (site.mode != 1) return;
  const int t = 2 * (job >> 2);  // the even consumer thread of the pair
  const int rh = job & 3;
  const int lane = t & 31;
  const int row = mt * kBM + (t >> 5) * 16 + (lane >> 2) + 64 * (rh >> 1) +
                  8 * (rh & 1);
  const uint64_t g0 = (static_cast<uint64_t>(row) * ld + n0 +
                       4 * ((lane & 3) >> 1)) >> 2;
  uint32_t even = 0u, odd = 0u;
#pragma unroll 4
  for (int j = 0; j < 16; ++j) {
    // column chunk j starts 8 j columns, 2 groups, further on
    const uint32_t bits =
        philox_keep_bits4(site.k0, site.k1, g0 + 2 * j, site.site, site.p);
    even |= (bits & 3u) << (2 * j);
    odd |= (bits >> 2) << (2 * j);
  }
  words[t * kKeepAuxWords + rh] = even;
  words[(t + 1) * kKeepAuxWords + rh] = odd;
}

// The keep multipliers of a consumer thread's columns ctx.col + 8 j and
// + 1 at row ctx.row + 64 r + 8 h: from its aux words (mode 1, `bits` the
// thread's four words), from the explicit f32 mask (mode 2, at `index`, the
// pair's flat index), or 1.
__device__ __forceinline__ float2 keep_pair(const DropSite& site,
                                            const uint4& bits, int r, int h,
                                            int j, size_t index) {
  if (site.mode == 1) {
    const uint32_t w = r ? (h ? bits.w : bits.z) : (h ? bits.y : bits.x);
    return make_float2((w >> (2 * j)) & 1u ? site.scale : 0.f,
                       (w >> (2 * j + 1)) & 1u ? site.scale : 0.f);
  }
  if (site.mode == 2) {
    return *reinterpret_cast<const float2*>(site.mask + index);
  }
  return make_float2(1.f, 1.f);
}

// Byte offset in a side tile (two boxes of 128 rows x 64 columns under the
// 128-byte swizzle) of a consumer thread's pair of columns ctx.col + 8 j,
// + 1 at row ctx.row + 64 r + 8 h: box j / 8, 16-byte chunk j % 8 of the
// row, XOR the row's phase, which is lane / 4 for all the thread's rows.
__device__ __forceinline__ int side_offset(const TileCtx& ctx, int r, int h,
                                           int j) {
  const int swz = ctx.lane() >> 2;
  return (j >> 3) * (kSideBytes / 2) +
         (ctx.warp() * 16 + swz + 64 * r + 8 * h) * 128 +
         (((j & 7) ^ swz) << 4) + 4 * (ctx.lane() & 3);
}

// A consumer thread's aux words as one vector (zeros unless mode 1).
__device__ __forceinline__ uint4 keep_words(const DropSite& site,
                                            const uint32_t* aux) {
  return site.mode == 1 ? *reinterpret_cast<const uint4*>(aux)
                        : make_uint4(0u, 0u, 0u, 0u);
}

// The MN-major mode's two products: tile counts along M and N of each.
struct MNProblems {
  int m_tiles[2], n_tiles[2];
};

// The MN-major mode's tile `tile` over both products: (problem, m0, n0).
__device__ __forceinline__ int3 mn_tile(const MNProblems& pr, int tile) {
  // selects, not an index by p: a runtime index would put the kernel
  // parameter's arrays on the stack
  const int t0 = pr.m_tiles[0] * pr.n_tiles[0];
  const bool p = tile >= t0;
  const int local = p ? tile - t0 : tile;
  const int nt = p ? pr.n_tiles[1] : pr.n_tiles[0];
  return make_int3(p ? 1 : 0, local / nt * kBM, local % nt * kBN);
}

template <class Epi, bool kMN = false>
__global__ void __launch_bounds__(kThreads, 1)
gemm_tn_kernel(const __grid_constant__ CUtensorMap tma,
               const __grid_constant__ CUtensorMap tmb,
               const __grid_constant__ CUtensorMap tmc,
               const __grid_constant__ CUtensorMap tmd, int M, int N, int K,
               Epi epi) {
  constexpr int kRing = Smem<Epi>::kRing;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* side = smem + kRing * kStageBytes;  // a tile per consumer
  uint64_t* full = reinterpret_cast<uint64_t*>(side + Smem<Epi>::kSide);
  uint64_t* empty = full + kRing;
  uint64_t* done = empty + kRing;  // consumer c's main loops, one a tile
  uint64_t* side_full = done + kConsumers;
  uint64_t* side_empty = side_full + kConsumers;
  uint64_t* aux_full = side_empty + kConsumers;
  uint64_t* aux_empty = aux_full + kConsumers;
  float* scratch = reinterpret_cast<float*>(aux_empty + kConsumers);
  uint32_t* aux = reinterpret_cast<uint32_t*>(
      scratch + kConsumers * Epi::kScratchFloats);

  const int n_tiles = N / kBN;
  int tiles = (M + kBM - 1) / kBM * n_tiles;
  int kblocks = K / kBK;
  if constexpr (kMN) {
    tiles = epi.probs.m_tiles[0] * epi.probs.n_tiles[0] +
            epi.probs.m_tiles[1] * epi.probs.n_tiles[1];
    kblocks = (K + kBK - 1) / kBK;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);  // one consumer warpgroup reads a stage
    }
    for (int c = 0; c < kConsumers; ++c) {
      mbar_init(&done[c], 128);
      mbar_init(&side_full[c], 1);
      mbar_init(&side_empty[c], 128);
      mbar_init(&aux_full[c], kAuxThreads);
      mbar_init(&aux_empty[c], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warpgroup = threadIdx.x / 128;
  if (warpgroup == 0 && threadIdx.x >= 32) {
    // the producer warpgroup's other three warps: each tile's aux words
    // for the consumer that takes it, once it has read the last ones
    if constexpr (Epi::kAuxWords > 0) {
      const int worker = threadIdx.x - 32;
      for (int j = 0; blockIdx.x + j * gridDim.x < tiles; ++j) {
        const int tile = blockIdx.x + j * gridDim.x;
        const int c = j % kConsumers;
        mbar_wait(&aux_empty[c], ((j / kConsumers) & 1) ^ 1);
        for (int job = worker; job < Epi::kAuxJobs; job += kAuxThreads) {
          epi.aux(tile / n_tiles, tile % n_tiles * kBN, job,
                  aux + c * 128 * Epi::kAuxWords);
        }
        mbar_arrive(&aux_full[c]);
      }
    }
  } else if (warpgroup == 0) {
    // producer: one thread keeps the ring full
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; blockIdx.x + j * gridDim.x < tiles; ++j) {
        const int tile = blockIdx.x + j * gridDim.x;
        int m0 = tile / n_tiles * kBM;
        int n0 = tile % n_tiles * kBN;
        const CUtensorMap* mapa = &tma;
        const CUtensorMap* mapb = &tmb;
        if constexpr (kMN) {
          // problem 1's operands are the maps tmc and tmd
          const int3 t = mn_tile(epi.probs, tile);
          m0 = t.y;
          n0 = t.z;
          if (t.x) {
            mapa = &tmc;
            mapb = &tmd;
          }
        }
        for (int kb = 0; kb < kblocks; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], kStageBytes);
          uint8_t* st = smem + stage * kStageBytes;
          if constexpr (kMN) {
            // boxes of 64 K rows x 64 columns: columns 0-63, then 64-127
            constexpr int kBox = kTileBytes / 2;
            tma_load_2d(st, mapa, m0, kb * kBK, &full[stage]);
            tma_load_2d(st + kBox, mapa, m0 + 64, kb * kBK, &full[stage]);
            tma_load_2d(st + kTileBytes, mapb, n0, kb * kBK, &full[stage]);
            tma_load_2d(st + kTileBytes + kBox, mapb, n0 + 64, kb * kBK,
                        &full[stage]);
          } else {
            tma_load_2d(st, &tma, kb * kBK, m0, &full[stage]);
            tma_load_2d(st + kTileBytes, &tmb, kb * kBK, n0, &full[stage]);
          }
          if (++stage == kRing) {
            stage = 0;
            phase ^= 1;
          }
        }
        if constexpr (Epi::kSideTile && Epi::kSideLoad) {
          // the side tile of tile j, for consumer j % 2's epilogue, once
          // that consumer's epilogue of tile j - 2 has read the buffer
          const int c = j % kConsumers;
          mbar_wait(&side_empty[c], ((j / kConsumers) & 1) ^ 1);
          mbar_expect_tx(&side_full[c], kSideBytes);
          uint8_t* dst = side + c * kSideBytes;
          tma_load_2d(dst, &tmc, n0, m0, &side_full[c]);
          tma_load_2d(dst + kSideBytes / 2, &tmc, n0 + kBK, m0,
                      &side_full[c]);
        }
      }
    }
  } else {
    const int c = warpgroup - 1;
    const int tid = threadIdx.x - 128 * warpgroup;
    const int warp = tid / 32;
    const int lane = tid % 32;
    // Consumer c takes the block's tiles j = c, c + 2, ...: their stages
    // are the ring's iterations j * kblocks onward.  Its main loop of tile
    // j starts when the other consumer's of tile j - 1 has seen all its
    // stages: the main loops alternate (the epilogues overlap them), and a
    // wait on a stage's parity is never more than one round of the ring
    // ahead, where parity alone could not tell the rounds apart.
    for (int j = c; blockIdx.x + j * gridDim.x < tiles; j += kConsumers) {
      if (j > 0) mbar_wait(&done[1 - c], ((j - 1) / 2) & 1);
      const int tile = blockIdx.x + j * gridDim.x;
      TileCtx ctx;
      ctx.mt = tile / n_tiles;
      ctx.n0 = tile % n_tiles * kBN;
      if constexpr (kMN) {
        const int3 t = mn_tile(epi.probs, tile);
        ctx.prob = t.x;
        ctx.mt = t.y / kBM;
        ctx.n0 = t.z;
      }
      ctx.row = ctx.mt * kBM + warp * 16 + lane / 4;
      ctx.col = ctx.n0 + 2 * (lane % 4);

      float acc[2][64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.f;
      uint32_t it = static_cast<uint32_t>(j) * kblocks;
      int prev = 0;
      for (int kb = 0; kb < kblocks; ++kb, ++it) {
        const int stage = static_cast<int>(it % kRing);
        mbar_wait(&full[stage], (it / kRing) & 1);
        const uint8_t* sa = smem + stage * kStageBytes;
        const uint64_t da = sw128_desc(sa);
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        wgmma_fence();
        if constexpr (kMN) {
          // A's rows 64-127 are its second box, 8 KB (512 units) on; B's
          // two boxes are the descriptor's 8 KB-apart column blocks; a
          // 16-deep step is 16 K rows, 2048 bytes (128 units)
          const uint64_t db = sw128_mn_desc(sa + kTileBytes, kTileBytes / 2);
#pragma unroll
          for (int k = 0; k < kBK / 16; ++k) {
            wgmma_m64n128k16<1, 1>(acc[0], da + 128 * k, db + 128 * k, 1);
            wgmma_m64n128k16<1, 1>(acc[1], da + 512 + 128 * k, db + 128 * k,
                                   1);
          }
        } else {
          const uint64_t db = sw128_desc(sa + kTileBytes);
#pragma unroll
          for (int k = 0; k < kBK / 16; ++k) {
            // rows 64-127 of A start 64 rows x 128 bytes on: 512 in the
            // descriptor's 16-byte units
            wgmma_m64n128k16(acc[0], da + 2 * k, db + 2 * k, 1);
            wgmma_m64n128k16(acc[1], da + 512 + 2 * k, db + 2 * k, 1);
          }
        }
        wgmma_commit();
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        wgmma_wait<1>();
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        if (kb > 0) mbar_arrive(&empty[prev]);
        prev = stage;
      }
      mbar_arrive(&done[c]);
      wgmma_wait<0>();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      mbar_arrive(&empty[prev]);
      uint8_t* my_side = nullptr;
      if constexpr (Epi::kSideTile) {
        if constexpr (Epi::kSideLoad) {
          mbar_wait(&side_full[c], (j / kConsumers) & 1);
        }
        my_side = side + c * kSideBytes;
      }
      const uint32_t* my_aux = nullptr;
      if constexpr (Epi::kAuxWords > 0) {
        mbar_wait(&aux_full[c], (j / kConsumers) & 1);
        my_aux = aux + (c * 128 + tid) * Epi::kAuxWords;
      }
      epi.store(acc, ctx, my_side, scratch + c * Epi::kScratchFloats,
                my_aux);
      if constexpr (Epi::kAuxWords > 0) mbar_arrive(&aux_empty[c]);
      if constexpr (Epi::kSideTile) {
        // the output tile the epilogue wrote over the side tile goes out
        // by TMA; the buffer is free once the copy has read it
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        wg_barrier(ctx);
        if (tid == 0) {
          tma_store_2d(&tmd, my_side, ctx.n0, ctx.mt * kBM);
          tma_store_2d(&tmd, my_side + kSideBytes / 2, ctx.n0 + kBK,
                       ctx.mt * kBM);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        }
        if constexpr (Epi::kSideLoad) {
          mbar_arrive(&side_empty[c]);  // the producer may load it again
        } else {
          wg_barrier(ctx);  // the next epilogue may write it again
        }
      }
    }
    if (Epi::kSideTile && tid == 0) {
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    }
  }
}

// The tensor map of a K-major bf16 operand [rows, k] (or of a side tile's
// tensor, k its columns): boxes of 128 rows x 64 k under the 128-byte
// swizzle, zeros past the last row on a load, nothing written past it on a
// store.
inline cudaError_t make_operand_map(CUtensorMap* map, const void* ptr,
                                    int rows, int k) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k),
                              static_cast<cuuint64_t>(rows)};
  const cuuint32_t box[2] = {kBK, kBM};
  return make_sw128_map(map, ptr, 2, dims, box);
}

// out = epilogue(a [M, K] . b [N, K]^T) on `stream`, one persistent block
// per SM.  With Epi::kSideTile, `out` is the bf16 [M, N] tensor the side
// tiles are stored to, and with Epi::kSideLoad `side` the bf16 [M, N]
// tensor they are loaded from (else unused).  Returns the first CUDA
// error.
template <class Epi>
inline cudaError_t launch(const void* a, const void* b, const void* side,
                          void* out, int M, int N, int K, const Epi& epi,
                          cudaStream_t stream) {
  if (M < 1 || N % kBN || K % kBK) return cudaErrorInvalidValue;
  CUtensorMap ma, mb, mc, md;
  cudaError_t err = make_operand_map(&ma, a, M, K);
  if (err == cudaSuccess) err = make_operand_map(&mb, b, N, K);
  if (err == cudaSuccess) {
    err = Epi::kSideTile && Epi::kSideLoad
              ? make_operand_map(&mc, side, M, N)
              : make_operand_map(&mc, a, M, K);
  }
  if (err == cudaSuccess) {
    err = Epi::kSideTile ? make_operand_map(&md, out, M, N)
                         : make_operand_map(&md, a, M, K);
  }
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(gemm_tn_kernel<Epi>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Smem<Epi>::kBytes);
  }
  if (err != cudaSuccess) return err;
  const int tiles = (M + kBM - 1) / kBM * (N / kBN);
  const int grid = tiles < sms ? tiles : sms;
  gemm_tn_kernel<Epi><<<grid, kThreads, Smem<Epi>::kBytes, stream>>>(
      ma, mb, mc, md, M, N, K, epi);
  return cudaGetLastError();
}

// The tensor map of an MN-major operand [k, cols] (cols contiguous):
// boxes of 64 k rows x 64 columns under the 128-byte swizzle, zeros past
// the last row.
inline cudaError_t make_mn_map(CUtensorMap* map, const void* ptr, int k,
                               int cols) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(k)};
  const cuuint32_t box[2] = {64, kBK};
  return make_sw128_map(map, ptr, 2, dims, box);
}

// The MN-major mode: out_p = epilogue(a_p^T . b_p) for p = 0, 1, a_p
// [K, M_p] and b_p [K, N_p], in one persistent launch of `grid` blocks on
// `stream` (the caller's plan: one an SM, at most the tiles); epi.probs
// must hold the problems' tile counts.  Returns the first CUDA error.
template <class Epi>
inline cudaError_t launch_mn(const void* a0, const void* b0, int M0, int N0,
                             const void* a1, const void* b1, int M1, int N1,
                             int K, int grid, const Epi& epi,
                             cudaStream_t stream) {
  static_assert(!Epi::kSideTile && Epi::kAuxWords == 0,
                "the MN-major mode has no side tile and no aux words");
  const int tiles = (M0 / kBM) * (N0 / kBN) + (M1 / kBM) * (N1 / kBN);
  if (K < 1 || grid < 1 || grid > tiles || M0 % kBM || N0 % kBN ||
      M1 % kBM || N1 % kBN ||
      epi.probs.m_tiles[0] != M0 / kBM || epi.probs.n_tiles[0] != N0 / kBN ||
      epi.probs.m_tiles[1] != M1 / kBM || epi.probs.n_tiles[1] != N1 / kBN)
    return cudaErrorInvalidValue;
  CUtensorMap ma, mb, mc, md;
  cudaError_t err = make_mn_map(&ma, a0, K, M0);
  if (err == cudaSuccess) err = make_mn_map(&mb, b0, K, N0);
  if (err == cudaSuccess) err = make_mn_map(&mc, a1, K, M1);
  if (err == cudaSuccess) err = make_mn_map(&md, b1, K, N1);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(gemm_tn_kernel<Epi, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Smem<Epi>::kBytes);
  }
  if (err != cudaSuccess) return err;
  gemm_tn_kernel<Epi, true><<<grid, kThreads, Smem<Epi>::kBytes, stream>>>(
      ma, mb, mc, md, M0, N0, K, epi);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace nrse
