// A persistent, warp-specialised bf16 GEMM for Hopper: TMA loads into a
// ring of 128-byte-swizzled shared-memory tiles, wgmma.mma_async on them,
// and an epilogue given as a template parameter (K2's dx kernel,
// fused_ffn_bwd.cu, is its user).
//
//   out[m, n] = epilogue(sum_k A[m, k] * B[n, k])   f32 accumulation
//
//   a is [M, K] and b is [N, K], both row-major bf16 ("TN": K contiguous in
//   both, wgmma's native K-major operands).  Rows of A past M read as zero
//   (TMA fills a box past the tensor's end with zeros); the epilogue masks
//   them.  Requirements: N % 128 == 0, K % 64 == 0, 16-byte aligned rows.
//
// Design.  Output tiles of 128 x 128, K-tiles of 64 bf16 = 128 bytes, which
// is one row of CU_TENSOR_MAP_SWIZZLE_128B: a stage holds A's 128 x 64 and
// B's 128 x 64 tile (32 KB) and the ring has kStages of them.  Three
// warpgroups.  The first is the producer: its first thread issues two TMA
// loads per stage, each completing on the stage's "full" mbarrier; its
// other three warps compute each tile's aux words for the epilogue (K2's
// dropout keep bits) into shared memory.  The other two are consumers
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
//   static constexpr bool kSideTile;     whether it reads a bf16 tile of a
//                                        [M, N] tensor (TMA-loaded beside
//                                        the ring, 4 stages then) and writes
//                                        its bf16 output tile over it in
//                                        place (TMA-stored after it)
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
// aux the thread's kAuxWords words.
#pragma once

#include <cuda.h>  // CUtensorMap; the driver entry is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Waits for the phase of `bar` with the given parity to complete.  A wait
// of more than ~10^10 cycles (seconds: a pipeline that can never advance)
// traps, so a fault shows as a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done;
  do {
    if (clock64() - start > 10000000000LL) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One box of a 2-D tensor map (c0 the inner coordinate) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// One box of shared memory into a 2-D tensor map (c0 the inner
// coordinate; the part past the tensor's end is not written), in the
// thread's bulk group.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major tile with 128-byte rows
// under the 128-byte swizzle: start address >> 4, leading byte offset 16
// (unused for this layout), stride byte offset 1024 (8 rows), layout
// type 1 (SWIZZLE_128B).  The tile must be 1024-byte aligned; a K step of
// 16 bf16 (32 bytes) inside the row adds 2 to the descriptor.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Keeps the compiler from moving accumulator registers across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T, both from shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// A barrier of the 128 threads of one consumer warpgroup (ids 1 and 2).
__device__ __forceinline__ void wg_barrier(const TileCtx& ctx) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + ctx.wg()) : "memory");
}

template <class Epi>
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
  const int tiles = (M + kBM - 1) / kBM * n_tiles;
  const int kblocks = K / kBK;

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
        const int m0 = tile / n_tiles * kBM;
        const int n0 = tile % n_tiles * kBN;
        for (int kb = 0; kb < kblocks; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], kStageBytes);
          uint8_t* st = smem + stage * kStageBytes;
          tma_load_2d(st, &tma, kb * kBK, m0, &full[stage]);
          tma_load_2d(st + kTileBytes, &tmb, kb * kBK, n0, &full[stage]);
          if (++stage == kRing) {
            stage = 0;
            phase ^= 1;
          }
        }
        if constexpr (Epi::kSideTile) {
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
        const uint64_t db = sw128_desc(sa + kTileBytes);
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kBK / 16; ++k) {
          // rows 64-127 of A start 64 rows x 128 bytes on: 512 in the
          // descriptor's 16-byte units
          wgmma_m64n128k16(acc[0], da + 2 * k, db + 2 * k, 1);
          wgmma_m64n128k16(acc[1], da + 512 + 2 * k, db + 2 * k, 1);
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
        mbar_wait(&side_full[c], (j / kConsumers) & 1);
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
        mbar_arrive(&side_empty[c]);
      }
    }
    if (Epi::kSideTile && tid == 0) {
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a driver-API function, found through the
// runtime so that the library needs no link against libcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// The tensor map of a K-major bf16 operand [rows, k] (or of a side tile's
// tensor, k its columns): boxes of 128 rows x 64 k under the 128-byte
// swizzle, zeros past the last row on a load, nothing written past it on a
// store.
inline cudaError_t make_operand_map(CUtensorMap* map, const void* ptr,
                                    int rows, int k) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k) * 2};
  const cuuint32_t box[2] = {kBK, kBM};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// out = epilogue(a [M, K] . b [N, K]^T) on `stream`, one persistent block
// per SM.  With Epi::kSideTile, `side` is the bf16 [M, N] tensor whose
// tiles the epilogue reads and `out` the bf16 [M, N] tensor it writes
// (else both unused).  Returns the first CUDA error.
template <class Epi>
inline cudaError_t launch(const void* a, const void* b, const void* side,
                          void* out, int M, int N, int K, const Epi& epi,
                          cudaStream_t stream) {
  if (M < 1 || N % kBN || K % kBK) return cudaErrorInvalidValue;
  CUtensorMap ma, mb, mc, md;
  cudaError_t err = make_operand_map(&ma, a, M, K);
  if (err == cudaSuccess) err = make_operand_map(&mb, b, N, K);
  if (err == cudaSuccess) {
    err = Epi::kSideTile ? make_operand_map(&mc, side, M, N)
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

}  // namespace wg
}  // namespace nrse
