// One hand-written tiled bf16 GEMM on mma.sync with the epilogue as a
// template parameter: K2's dW kernel (fused_ffn_bwd.cu) runs on it; K6
// (fused_frontend.cu) and the block attention (attention_common.cuh) use
// its warp-level pieces (warp_mma_stage takes either operand layout), and
// kernel B its GELU and bf16 store.
//
//   out[m, n] = epilogue(sum_k A(m, k) * B(n, k))   f32 accumulation
//
//   a is [K, M] row-major (lda = M), b is [K, N] row-major (ldb = N): both
//   operands read transposed; k rows >= K zero-fill.
//
// Requirements: M % 128 == 0, N % 128 == 0.
//
// Design: 128 x 128 x 32 block tile, 8 warps of 64 x 32 (2 along M, 4 along
// N), mma.sync.m16n8k16 bf16 -> f32, operands fed by ldmatrix.trans from a
// two-stage cp.async ring in shared memory whose rows are padded by 16
// bytes so that ldmatrix is free of bank conflicts.  The epilogue functor
// sees each pair of neighbouring columns (row, col), (row, col + 1) of the
// f32 accumulator.
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

// bf16 elements of one stage of a 32 x 128 operand tile (k rows)
constexpr int kTileElems = kBK * kRowMN;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
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

// One stage of an operand tile into shared memory: k rows k0..k0+31 of a
// [K, R] operand, columns r0..r0+127; 512 chunks of 16 bytes, two per
// thread.
__device__ __forceinline__ void load_tile(__nv_bfloat16* s,
                                          const __nv_bfloat16* g, int r0,
                                          int k0, int K, int ld, int tid) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int chunk = tid + c * kThreads;
    const int row = chunk / 16;
    const int col = (chunk % 16) * 8;
    const bool ok = k0 + row < K;
    const __nv_bfloat16* src =
        g + static_cast<size_t>(ok ? k0 + row : 0) * ld + r0 + col;
    cp_async16(s + row * kRowMN + col, src, ok ? 16 : 0);
  }
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

template <class Epi>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const __nv_bfloat16* __restrict__ a,
            const __nv_bfloat16* __restrict__ b, int M, int N, int K,
            Epi epi) {
  __shared__ __align__(16) __nv_bfloat16 as[kStages][kTileElems];
  __shared__ __align__(16) __nv_bfloat16 bs[kStages][kTileElems];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / 4;  // 0..1
  const int wn = warp % 4;  // 0..3
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  auto load_stage = [&](int stage, int k0) {
    load_tile(as[stage], a, m0, k0, K, M, tid);
    load_tile(bs[stage], b, n0, k0, K, N, tid);
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[kMTiles][kNTiles][4];
#pragma unroll
  for (int i = 0; i < kMTiles; ++i)
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int ktiles = (K + kBK - 1) / kBK;
  load_stage(0, 0);
  for (int kt = 0; kt < ktiles; ++kt) {
    const int stage = kt % kStages;
    if (kt + 1 < ktiles) {
      load_stage((kt + 1) % kStages, (kt + 1) * kBK);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();

    warp_mma_stage<kMTiles, kNTiles, true, true, kRowMN, kRowMN>(
        acc, as[stage], bs[stage], wm * kWarpM, wn * kWarpN, lane);
    __syncthreads();  // the stage is overwritten by the next load
  }

  // Epilogue: accumulator element e of tile (i, j) sits at row
  // lane / 4 (+ 8 for e >= 2) and column (lane % 4) * 2 (+ 1 for odd e).
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) {
    const int col = n0 + wn * kWarpN + j * 8 + (lane % 4) * 2;
#pragma unroll
    for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * kWarpM + i * 16 + lane / 4 + half * 8;
        epi(row, col, acc[i][j][2 * half], acc[i][j][2 * half + 1]);
      }
    }
  }
}

// Launch on `stream`; returns cudaGetLastError().
template <class Epi>
inline cudaError_t launch(const __nv_bfloat16* a, const __nv_bfloat16* b,
                          int M, int N, int K, const Epi& epi,
                          cudaStream_t stream) {
  const dim3 grid(N / kBN, M / kBM);
  gemm_kernel<Epi><<<grid, kThreads, 0, stream>>>(a, b, M, N, K, epi);
  return cudaGetLastError();
}

}  // namespace gemm
}  // namespace nrse
