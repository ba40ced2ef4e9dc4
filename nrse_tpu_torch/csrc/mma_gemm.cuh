// The warp-level pieces of a tiled bf16 GEMM on mma.sync: K6
// (fused_frontend.cu) runs its products on warp_mma_stage (either operand
// layout) with this block tile, the block attention's mma.sync route
// (attention_common.cuh) uses its ldmatrix and mma wrappers, and kernel B
// and K2 its GELU and bf16 store.
//
// The tile: 128 x 128 x 32, 8 warps of 64 x 32 (2 along M, 4 along N),
// mma.sync.m16n8k16 bf16 -> f32, operands fed by ldmatrix (.trans for an
// M- or N-contiguous tile) from shared-memory rows padded by 16 bytes so
// that ldmatrix is free of bank conflicts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace nrse {
namespace gemm {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kPad = 8;                  // bf16 elements of row padding
constexpr int kRowK = kBK + kPad;        // K-contiguous tile row: 80 bytes
constexpr int kRowMN = kBM + kPad;       // M/N-contiguous tile row: 272 bytes
constexpr int kStages = 2;
constexpr int kThreads = 256;            // 8 warps: 2 along M x 4 along N
constexpr int kWarpM = 64;
constexpr int kWarpN = 32;
constexpr int kMTiles = kWarpM / 16;     // 4 m16 tiles per warp
constexpr int kNTiles = kWarpN / 8;      // 4 n8 tiles per warp

static_assert(kBM == kBN, "one tile row length serves A and B");


__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Exact-erf GELU and its derivative, Phi(x) + x * phi(x).
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ float gelu_erf_grad(float x) {
  const float cdf = 0.5f * (1.f + erff(x * 0.70710678118654752f));
  const float pdf = expf(-0.5f * x * x) * 0.3989422804014327f;
  return cdf + x * pdf;
}

__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* p, float x0,
                                             float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

// One warp's products over one 32-deep stage: acc[i][j] (m16 tile i, n8
// tile j) += A rows m_off + 16 i.. x B rows n_off + 8 j.., read from the
// stage's tiles `at` and `bt` by ldmatrix.  kLdA / kLdB are the tiles' row
// lengths in bf16 elements: kRowK for a K-contiguous tile, the padded
// M/N width for a transposed one.
template <int kMT, int kNT, bool kAT, bool kBT, int kLdA, int kLdB>
__device__ __forceinline__ void warp_mma_stage(float (&acc)[kMT][kNT][4],
                                               const __nv_bfloat16* at,
                                               const __nv_bfloat16* bt,
                                               int m_off, int n_off,
                                               int lane) {
  static_assert(kNT % 2 == 0, "n8 tiles are loaded in pairs");
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t af[kMT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      if (!kAT) {
        const int row = m_off + i * 16 + (lane % 16);
        const int col = kk + (lane / 16) * 8;
        ldmatrix_x4(af[i], at + row * kLdA + col);
      } else {
        // matrices: (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15),
        // (m 8-15, k 8-15), each read transposed from [k][m] rows
        const int krow = kk + (lane / 16) * 8 + (lane % 8);
        const int mcol = m_off + i * 16 + ((lane / 8) % 2) * 8;
        ldmatrix_x4_trans(af[i], at + krow * kLdA + mcol);
      }
    }
    uint32_t bf[kNT][2];
#pragma unroll
    for (int j = 0; j < kNT; j += 2) {
      // matrices: (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7),
      // (n 8-15, k 8-15) -> b0/b1 of n-tile j, then of n-tile j + 1
      uint32_t r[4];
      if (!kBT) {
        const int row = n_off + j * 8 + (lane % 8) + (lane / 16) * 8;
        const int col = kk + ((lane / 8) % 2) * 8;
        ldmatrix_x4(r, bt + row * kLdB + col);
      } else {
        const int krow = kk + ((lane / 8) % 2) * 8 + (lane % 8);
        const int ncol = n_off + j * 8 + (lane / 16) * 8;
        ldmatrix_x4_trans(r, bt + krow * kLdB + ncol);
      }
      bf[j][0] = r[0];
      bf[j][1] = r[1];
      bf[j + 1][0] = r[2];
      bf[j + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j) mma_bf16(acc[i][j], af[i], bf[j][0], bf[j][1]);
  }
}

}  // namespace gemm
}  // namespace nrse
