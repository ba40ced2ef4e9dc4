// Fused FFN, forward (kernel B).
//
// Replaces: nrse_tpu/ops/fused_ffn.py::_fwd_kernel (the Pallas TPU kernel
// of the WavLM FFN pair) for the deterministic forward: no dropout, no
// saved h1.
//
// Computes, with the weights in torch [out, in] layout (both products are
// K-major, "NT" GEMMs):
//   h   = bf16(gelu_erf(x . W1^T + b1))     x [N, C], W1 [F, C], h [N, F]
//   out = bf16(h . W2^T + b2)               W2 [C, F], out [N, C]
// Products are bf16 on the tensor cores with f32 accumulation; the bias
// and the exact-erf GELU (erff, not the TPU's A&S rational erf) run on
// the f32 accumulator in the epilogue.
//
// What bounds it on the H100: at N = 32 x 249 = 7968 rows, C = 1024,
// F = 4096 the pair is ~134 GFLOP against ~100 MB of operands, so it is
// bound by the tensor cores.
//
// Design: one hand-written tiled GEMM (128 x 128 x 32 block tile, 8 warps
// of 64 x 32, mma.sync.m16n8k16 bf16 -> f32, operands fed by ldmatrix from
// a two-stage cp.async ring in shared memory whose rows are padded so that
// ldmatrix is free of bank conflicts), launched twice: GEMM1 with a
// bias + GELU epilogue that writes bf16 h [N, F], then GEMM2 with a bias
// epilogue.  Rows beyond N are zero-filled on load and masked on store, so
// N need not be a multiple of the tile.  The TPU kernel's point is that h
// never leaves the chip; here h makes one round trip through device memory
// (65 MB at the serving shape).  Keeping h on chip, and wgmma/TMA in place
// of mma.sync/cp.async, are the first performance items for this kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kPad = 8;                 // bf16 elements of row padding
constexpr int kRow = kBK + kPad;        // 40 bf16 = 80 bytes per smem row
constexpr int kStages = 2;
constexpr int kThreads = 256;           // 8 warps: 2 along M x 4 along N
constexpr int kWarpM = 64;
constexpr int kWarpN = 32;
constexpr int kMTiles = kWarpM / 16;    // 4 m16 tiles per warp
constexpr int kNTiles = kWarpN / 8;     // 4 n8 tiles per warp

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

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

// out[M, N] = epilogue(a[M, K] . w[N, K]^T + bias[N]); K % 32 == 0,
// N % 128 == 0, M arbitrary.
template <bool kGelu>
__global__ void __launch_bounds__(kThreads)
gemm_nt_bias_kernel(const __nv_bfloat16* __restrict__ a,
                    const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) __nv_bfloat16 as[kStages][kBM * kRow];
  __shared__ __align__(16) __nv_bfloat16 ws[kStages][kBN * kRow];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / 4;  // 0..1
  const int wn = warp % 4;  // 0..3
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  // Each thread copies two 16-byte chunks of each tile per stage:
  // a tile row holds kBK / 8 = 4 chunks, so 128 rows x 4 chunks = 512.
  auto load_stage = [&](int stage, int k0) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int chunk = tid + c * kThreads;
      const int row = chunk / 4;
      const int col = (chunk % 4) * 8;
      const int gm = m0 + row;
      const __nv_bfloat16* src =
          a + static_cast<size_t>(gm < M ? gm : 0) * K + k0 + col;
      cp_async16(&as[stage][row * kRow + col], src, gm < M ? 16 : 0);
      const __nv_bfloat16* wsrc =
          w + static_cast<size_t>(n0 + row) * K + k0 + col;
      cp_async16(&ws[stage][row * kRow + col], wsrc, 16);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[kMTiles][kNTiles][4];
#pragma unroll
  for (int i = 0; i < kMTiles; ++i)
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int ktiles = K / kBK;
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

    const __nv_bfloat16* at = as[stage];
    const __nv_bfloat16* wt = ws[stage];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[kMTiles][4];
#pragma unroll
      for (int i = 0; i < kMTiles; ++i) {
        const int row = wm * kWarpM + i * 16 + (lane % 16);
        const int col = kk + (lane / 16) * 8;
        ldmatrix_x4(af[i], at + row * kRow + col);
      }
      uint32_t bf[kNTiles][2];
#pragma unroll
      for (int j = 0; j < kNTiles; j += 2) {
        // matrices: (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7),
        // (n 8-15, k 8-15) -> b0/b1 of n-tile j, then of n-tile j + 1
        const int row = wn * kWarpN + j * 8 + (lane % 8) + (lane / 16) * 8;
        const int col = kk + ((lane / 8) % 2) * 8;
        uint32_t r[4];
        ldmatrix_x4(r, wt + row * kRow + col);
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < kMTiles; ++i)
#pragma unroll
        for (int j = 0; j < kNTiles; ++j)
          mma_bf16(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
    __syncthreads();  // the stage is overwritten by the next load
  }

  // Epilogue: accumulator element e of tile (i, j) sits at row
  // lane / 4 (+ 8 for e >= 2) and column (lane % 4) * 2 (+ 1 for odd e).
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) {
    const int col = n0 + wn * kWarpN + j * 8 + (lane % 4) * 2;
    const float b0 = bias[col];
    const float b1 = bias[col + 1];
#pragma unroll
    for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * kWarpM + i * 16 + lane / 4 + half * 8;
        if (row >= M) continue;
        float x0 = acc[i][j][2 * half] + b0;
        float x1 = acc[i][j][2 * half + 1] + b1;
        if (kGelu) {
          x0 = gelu_erf(x0);
          x1 = gelu_erf(x1);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row) * N +
                                           col) = __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

}  // namespace

// x [N, C], w1 [F, C], b1 [F] f32, w2 [C, F], b2 [C] f32; h [N, F] is
// scratch the caller allocates; out [N, C].  All bf16 unless noted.
extern "C" int nrse_fused_ffn_fwd(const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, void* h, void* out, int N,
                                  int C, int F, void* stream) {
  if (N < 1 || C % kBN || F % kBN || C % kBK || F % kBK)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mblocks = (N + kBM - 1) / kBM;
  gemm_nt_bias_kernel<true><<<dim3(F / kBN, mblocks), kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1),
      static_cast<__nv_bfloat16*>(h), N, F, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gemm_nt_bias_kernel<false><<<dim3(C / kBN, mblocks), kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(h),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),
      static_cast<__nv_bfloat16*>(out), N, C, F);
  return static_cast<int>(cudaGetLastError());
}
