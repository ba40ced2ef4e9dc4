// Fused FFN, backward (K2): the dx kernel and the dW kernel.
//
// Replaces: nrse_tpu/ops/fused_ffn.py::_dx_kernel (dx, db2) and
// ::_dw_kernel (dW1, dW2, db1), the Pallas TPU kernels of the FFN pair's
// VJP.  With the torch layout w1 [F, C], w2 [C, F] and the residuals of
// kernel B's training forward (h1 = bf16(x.W1^T + b1) and
// gd = bf16(gelu(h1) * keep_act), both [N, F]):
//
//   dh2 = dout * keep_hid                      [N, C]   site 1
//   db2 = sum_n dh2                            f32
//   dgd = bf16(dh2) . w2                       [N, F]
//   dh1 = dgd * keep_act * gelu'(h1)           f32      site 0
//   db1 = sum_n dh1                            f32, before the cast
//   dx  = bf16(dh1) . w1                       [N, C]
//   dW1 = bf16(dh1)^T . x                      [F, C]   TN product, f32
//   dW2 = bf16(dh2)^T . gd                     [C, F]   TN product, f32
//
// The masks are regenerated from the seed (philox.cuh: they depend on
// (seed, site, element index) only, so these kernels' tiles need not be
// kernel B's) or read from explicit masks.  gd is kept from the forward
// rather than recomputed from h1 (the TPU kernel recomputes it): one more
// [N, F] bf16 residual per layer, no recompute.
//
// What bounds it on the H100: four products of ~75 GFLOP each at N = 8964,
// C = 1024, F = 4096, against a few hundred MB of operands: tensor-core
// bound.  Blocks on Hopper run in no order and cannot carry a sum from one
// grid step to the next as the TPU grid does, so:
//   * dx: a row-major pass makes bf16 dh2 (8 columns, 16 bytes a thread,
//     two grouped Philox draws) and per-16-row partial column sums of dh2;
//     the dgd product and the dx product run on wgmma fed by TMA
//     (wgmma_gemm.cuh: persistent blocks, a producer warpgroup and two
//     consumer warpgroups, B operands K-major: a first pass casts the
//     weights to bf16 transposed, w2t = w2^T [F, C] and w1t = w1^T [C, F],
//     in the one copy the cast costs anyway).  dgd's epilogue applies
//     keep_act and gelu' (A&S erf, as the TPU kernel), writes bf16 dh1 and
//     one partial column sum of dh1 per 128-row tile, folded over the
//     tile's rows in shared memory in a fixed order; it runs while the
//     other consumer warpgroup's main loop keeps the tensor cores busy.
//     Its keep bits come from the producer warpgroup's three spare warps,
//     one Philox draw per four elements, into shared memory
//     (wgmma_gemm.cuh keep_bits_job).  Two small
//     passes finish db2 and db1 over the partials in a fixed order.
//   * dW: both products in one launch of the same persistent wgmma GEMM in
//     its MN-major mode (wgmma_gemm.cuh launch_mn): dh1, x, dh2 and gd
//     are read by TMA as they lie, [N, F] and [N, C] with the token
//     dimension N as the reduction, and wgmma reads each stage transposed;
//     the last K-tile's rows past N arrive as zeros, so N needs no
//     padding.  dW1 [F, C] and dW2 [C, F] are 256 output tiles of 128 x
//     128 each: 512 tiles over the persistent blocks the wrapper plans
//     (one an SM, ops/fused_ffn.py dw_plan), four each on an H100.  A tile's consumer walks all N in order (no split-K, no
//     atomics), so dW is the same from run to run; its f32 epilogue
//     stores the tile while the block's other consumer warpgroup runs
//     the next tile's main loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_gemm.cuh"
#include "philox.cuh"
#include "wgmma_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;
using nrse::DropSite;
using nrse::gemm::store_bf16x2;
using nrse::wg::TileCtx;
using nrse::wg::kBN;

// GELU'(x) = Phi(x) + x phi(x) on the Abramowitz & Stegun 7.1.26 erf
// (|error| <= 1.5e-7), as the TPU kernel computes it
// (nrse_tpu/ops/tpu_math.py::gelu_grad); the erf's exp(-z^2) at
// z = x / sqrt(2) is phi's exp(-x^2 / 2), so one exponential serves both.
__device__ __forceinline__ float gelu_grad_as(float x) {
  const float z = fabsf(x) * 0.70710678118654752f;
  const float t = __fdividef(1.f, 1.f + 0.3275911f * z);
  const float poly =
      ((((1.061405429f * t - 1.453152027f) * t + 1.421413741f) * t -
        0.284496736f) * t + 0.254829592f) * t;
  const float e = __expf(-0.5f * x * x);
  const float cdf = 0.5f + 0.5f * copysignf(1.f - poly * e, x);
  return cdf + x * e * 0.3989422804014327f;
}

constexpr int kDh2Rows = 16;  // rows per partial column sum of dh2
constexpr int kVec = 8;       // dh2 columns a thread: 16 bytes of bf16

// dh2 = dout * keep_hid over [N, C]: bf16 dh2 and, per kDh2Rows-row chunk,
// the f32 column sums.  Grid ceil(N / kDh2Rows), C / 8 threads a block, a
// thread 8 consecutive columns of each row of its chunk.
__global__ void __launch_bounds__(1024)
dh2_kernel(const bf16* __restrict__ dout, DropSite hid, bf16* __restrict__ dh2,
           float* __restrict__ part, int N, int C) {
  const int col = threadIdx.x * kVec;
  const int r0 = blockIdx.x * kDh2Rows;
  const int r1 = min(r0 + kDh2Rows, N);
  float sum[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) sum[e] = 0.f;
#pragma unroll 4
  for (int row = r0; row < r1; ++row) {
    const size_t idx = static_cast<size_t>(row) * C + col;
    const uint4 v = *reinterpret_cast<const uint4*>(dout + idx);
    const float4 ka = hid.keep4(idx >> 2);
    const float4 kb = hid.keep4((idx >> 2) + 1);
    const float keep[kVec] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
    const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&v);
    uint4 r;
    __nv_bfloat162* rv = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int e = 0; e < kVec / 2; ++e) {
      const float a = __low2float(xv[e]) * keep[2 * e];
      const float b = __high2float(xv[e]) * keep[2 * e + 1];
      sum[2 * e] += a;
      sum[2 * e + 1] += b;
      rv[e] = __floats2bfloat162_rn(a, b);
    }
    *reinterpret_cast<uint4*>(dh2 + idx) = r;
  }
  float4* out = reinterpret_cast<float4*>(
      part + static_cast<size_t>(blockIdx.x) * C + col);
  out[0] = make_float4(sum[0], sum[1], sum[2], sum[3]);
  out[1] = make_float4(sum[4], sum[5], sum[6], sum[7]);
}

constexpr int kTr = 32;  // tile of the transposing cast

// dst [cols, rows] = bf16(src [rows, cols])^T through a padded 32 x 33
// tile of shared memory: both sides read and write whole 32-element runs.
// Grid (cols / 32, rows / 32), 32 x 8 threads; rows, cols % 32 == 0.
__global__ void __launch_bounds__(kTr * 8)
transpose_cast_kernel(const float* __restrict__ src, bf16* __restrict__ dst,
                      int rows, int cols) {
  __shared__ float tile[kTr][kTr + 1];
  const int c0 = blockIdx.x * kTr;
  const int r0 = blockIdx.y * kTr;
#pragma unroll
  for (int i = threadIdx.y; i < kTr; i += 8) {
    tile[i][threadIdx.x] =
        src[static_cast<size_t>(r0 + i) * cols + c0 + threadIdx.x];
  }
  __syncthreads();
#pragma unroll
  for (int i = threadIdx.y; i < kTr; i += 8) {
    dst[static_cast<size_t>(c0 + i) * rows + r0 + threadIdx.x] =
        __float2bfloat16_rn(tile[threadIdx.x][i]);
  }
}

cudaError_t transpose_cast(const void* src, void* dst, int rows, int cols,
                           cudaStream_t s) {
  transpose_cast_kernel<<<dim3(cols / kTr, rows / kTr), dim3(kTr, 8), 0, s>>>(
      static_cast<const float*>(src), static_cast<bf16*>(dst), rows, cols);
  return cudaGetLastError();
}

constexpr int kFoldCols = 32;
constexpr int kFoldSlices = 8;

// out[col] = sum over rows of part[row, col] in a fixed order: slice s of
// a block sums rows s, s + 8, ... in turn, then slice 0 adds the 8 slices
// in turn.  Grid ceil(cols / 32), 256 threads.
__global__ void __launch_bounds__(kFoldCols * kFoldSlices)
colsum_fold_kernel(const float* __restrict__ part, int rows, int cols,
                   float* __restrict__ out) {
  __shared__ float slices[kFoldSlices][kFoldCols];
  const int lane = threadIdx.x % kFoldCols;
  const int slice = threadIdx.x / kFoldCols;
  const int col = blockIdx.x * kFoldCols + lane;
  float sum = 0.f;
  if (col < cols) {
    for (int r = slice; r < rows; r += kFoldSlices) {
      sum += part[static_cast<size_t>(r) * cols + col];
    }
  }
  slices[slice][lane] = sum;
  __syncthreads();
  if (slice == 0 && col < cols) {
    float total = 0.f;
#pragma unroll
    for (int s = 0; s < kFoldSlices; ++s) total += slices[s][lane];
    out[col] = total;
  }
}

// The dgd product's epilogue: dh1 = dgd * keep_act * gelu'(h1) -> bf16
// dh1, and one f32 partial column sum of dh1 per 128-row tile.  h1's tile
// arrives in shared memory by TMA during the main loop (the side tile: two
// boxes of 128 rows x 64 columns under the 128-byte swizzle), so the
// epilogue's reads of it wait on no device-memory latency; dh1 is written
// over it in place and leaves by TMA.
struct EpiDgd {
  static constexpr bool kSideTile = true;
  static constexpr bool kSideLoad = true;
  // per consumer: f32 partial column sums [4 warps][128 columns][4], one
  // per pair of row lanes and column over their 8 rows of the tile
  static constexpr int kScratchFloats = 4 * kBN * 4;
  // keep bits: nrse::wg::keep_bits_job's words, drawn by the producer's
  // spare warps
  static constexpr int kAuxWords = nrse::wg::kKeepAuxWords;
  static constexpr int kAuxJobs = nrse::wg::kKeepAuxJobs;
  float* part;  // [ceil(N / 128), F]
  int M, ld;    // N, F
  DropSite act;

  __device__ __forceinline__ void aux(int mt, int n0, int job,
                                      uint32_t* words) const {
    nrse::wg::keep_bits_job(act, ld, mt, n0, job, words);
  }

  __device__ __forceinline__ void store(float (&acc)[2][64],
                                        const TileCtx& ctx, uint8_t* tile,
                                        float* scratch,
                                        const uint32_t* aux) const {
    uint4 keep = make_uint4(0u, 0u, 0u, 0u);
    if (act.mode == 1) keep = *reinterpret_cast<const uint4*>(aux);
    // the thread's local rows are warp * 16 + lane / 4 (+ 8, + 64): all
    // equal to lane / 4 mod 8, the swizzle's row phase
    const int swz = ctx.lane() >> 2;
    const int byte = 4 * (ctx.lane() & 3);
    const int local0 = ctx.warp() * 16 + swz;
    float* sums = scratch + ctx.warp() * kBN * 4 + (swz >> 1);
    nrse::wg::wg_barrier(ctx);  // the last tile's sums have been read
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = ctx.row + 64 * r + 8 * h;
          if (row >= M) continue;
          // column 8 j + 2 (lane % 4): box j / 8, 16-byte chunk j % 8
          const int off = (j >> 3) * (nrse::wg::kSideBytes / 2) +
                          (local0 + 64 * r + 8 * h) * 128 +
                          (((j & 7) ^ swz) << 4) + byte;
          const __nv_bfloat162 hv =
              *reinterpret_cast<const __nv_bfloat162*>(tile + off);
          float k0 = 1.f, k1 = 1.f;
          if (act.mode == 1) {
            const uint32_t w = r ? (h ? keep.w : keep.z)
                                 : (h ? keep.y : keep.x);
            k0 = (w >> (2 * j)) & 1u ? act.scale : 0.f;
            k1 = (w >> (2 * j + 1)) & 1u ? act.scale : 0.f;
          } else if (act.mode == 2) {
            const float2 m = *reinterpret_cast<const float2*>(
                act.mask + static_cast<size_t>(row) * ld + ctx.col + 8 * j);
            k0 = m.x;
            k1 = m.y;
          }
          const float d0 =
              acc[r][4 * j + 2 * h] * k0 * gelu_grad_as(__low2float(hv));
          const float d1 = acc[r][4 * j + 2 * h + 1] * k1 *
                           gelu_grad_as(__high2float(hv));
          store_bf16x2(reinterpret_cast<bf16*>(tile + off), d0, d1);
          s0 += d0;
          s1 += d1;
        }
      }
      // with the row lane 4 apart (lane ^ 4): 8 rows
      s0 += __shfl_xor_sync(0xffffffffu, s0, 4);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 4);
      if ((swz & 1) == 0) {
        const int col = 8 * j + 2 * (ctx.lane() & 3);
        sums[col * 4] = s0;
        sums[(col + 1) * 4] = s1;
      }
    }
    // each thread one column: the 4 warps' 4 partials, in row order
    nrse::wg::wg_barrier(ctx);
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float4 v = *reinterpret_cast<const float4*>(
          scratch + (w * kBN + ctx.tid()) * 4);
      total += v.x + v.y + v.z + v.w;
    }
    part[static_cast<size_t>(ctx.mt) * ld + ctx.n0 + ctx.tid()] = total;
  }
};

// The dx product's epilogue: bf16 out, rows < M.
struct EpiStoreBf16 {
  static constexpr bool kSideTile = false;
  static constexpr bool kSideLoad = false;
  static constexpr int kScratchFloats = 0;
  static constexpr int kAuxWords = 0;
  static constexpr int kAuxJobs = 0;
  bf16* out;
  int M, ld;

  __device__ __forceinline__ void aux(int, int, int, uint32_t*) const {}

  __device__ __forceinline__ void store(float (&acc)[2][64],
                                        const TileCtx& ctx, uint8_t*, float*,
                                        const uint32_t*) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = ctx.row + 64 * r + 8 * h;
        if (row >= M) continue;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          store_bf16x2(out + static_cast<size_t>(row) * ld + ctx.col + 8 * j,
                       acc[r][4 * j + 2 * h], acc[r][4 * j + 2 * h + 1]);
        }
      }
    }
  }
};

// The dW products' epilogue (the MN-major mode): f32 out, problem 0 into
// dw1 [F, C], problem 1 into dw2 [C, F]; every row is inside M.
struct EpiDw {
  static constexpr bool kSideTile = false;
  static constexpr bool kSideLoad = false;
  static constexpr int kScratchFloats = 0;
  static constexpr int kAuxWords = 0;
  static constexpr int kAuxJobs = 0;
  nrse::wg::MNProblems probs;
  float* out[2];
  int ld[2];

  __device__ __forceinline__ void aux(int, int, int, uint32_t*) const {}

  __device__ __forceinline__ void store(float (&acc)[2][64],
                                        const TileCtx& ctx, uint8_t*, float*,
                                        const uint32_t*) const {
    float* o = ctx.prob ? out[1] : out[0];
    const int l = ctx.prob ? ld[1] : ld[0];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* row = o + static_cast<size_t>(ctx.row + 64 * r + 8 * h) * l +
                     ctx.col;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          *reinterpret_cast<float2*>(row + 8 * j) =
              make_float2(acc[r][4 * j + 2 * h], acc[r][4 * j + 2 * h + 1]);
        }
      }
    }
  }
};

bool bad_shape(int N, int C, int F) {
  return N < 1 || C % kBN || F % kBN ||
         C / kVec > 1024;
}

}  // namespace

// dx half of the backward.  Inputs: dout [N, C] and h1 [N, F] bf16, the
// weights in torch's layout, w1 [F, C] and w2 [C, F], f32; the
// hidden/activation sites as in nrse_fused_ffn_fwd_train (mode 0
// none, 1 Philox under the seed pair at `seed` in device memory, the
// activation site over the window (f_global,
// f0), 2 explicit f32 masks).  Outputs: dh2 [N, C]
// and dh1 [N, F] bf16 (the dW half reads them), dx [N, C] bf16, db1 [F]
// and db2 [C] f32.  Scratch: w1t [C, F] and w2t [F, C] bf16 (the weights
// cast and transposed, K-major for the products), and part, f32 of
// max(ceil(N / 16) * C, ceil(N / 128) * F) elements (ops/fused_ffn.py::
// dx_plan).  Every pointer 16-byte aligned.
extern "C" int nrse_fused_ffn_bwd_dx(
    const void* dout, const void* h1, const void* w1, const void* w2,
    void* w1t, void* w2t, const void* mask_act, const void* mask_hid,
    const void* seed, float p_act, float p_hid,
    float scale_act, float scale_hid, int mode, unsigned f_global,
    unsigned f0, void* dh2, void* dh1, void* dx, void* db1, void* db2,
    void* part, int N, int C, int F, void* stream) {
  if (bad_shape(N, C, F) || f_global < static_cast<unsigned>(F) + f0 ||
      f0 % 4 || f_global % 4 || (mode == 1 && !nrse::seed_ok(seed)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint2* key = static_cast<const uint2*>(seed);
  DropSite act{static_cast<const float*>(mask_act), key, 0u, p_act,
               scale_act, (mode == 1 && p_act == 0.f) ? 0 : mode};
  act.win.wl = static_cast<uint32_t>(F);
  act.win.wg = f_global;
  act.win.c0 = f0;
  const DropSite hid{static_cast<const float*>(mask_hid), key, 1u, p_hid,
                     scale_hid, (mode == 1 && p_hid == 0.f) ? 0 : mode};
  cudaError_t err = transpose_cast(w1, w1t, F, C, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = transpose_cast(w2, w2t, C, F, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (N + kDh2Rows - 1) / kDh2Rows;
  const int tiles = (N + nrse::wg::kBM - 1) / nrse::wg::kBM;
  float* scratch = static_cast<float*>(part);

  dh2_kernel<<<chunks, C / kVec, 0, s>>>(static_cast<const bf16*>(dout), hid,
                                        static_cast<bf16*>(dh2), scratch, N,
                                        C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  colsum_fold_kernel<<<(C + kFoldCols - 1) / kFoldCols,
                       kFoldCols * kFoldSlices, 0, s>>>(
      scratch, chunks, C, static_cast<float*>(db2));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const EpiDgd e1{scratch, N, F, act};
  err = nrse::wg::launch(dh2, w2t, h1, dh1, N, F, C, e1, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  colsum_fold_kernel<<<(F + kFoldCols - 1) / kFoldCols,
                       kFoldCols * kFoldSlices, 0, s>>>(
      scratch, tiles, F, static_cast<float*>(db1));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const EpiStoreBf16 e2{static_cast<bf16*>(dx), N, C};
  return static_cast<int>(
      nrse::wg::launch(dh1, w1t, nullptr, nullptr, N, C, F, e2, s));
}

// dW half: x [N, C], gd [N, F] (kernel B's h), dh1 [N, F], dh2 [N, C]
// bf16 -> dw1 = dh1^T . x [F, C] and dw2 = dh2^T . gd [C, F] f32, torch's
// weight layouts, in one launch.
extern "C" int nrse_fused_ffn_bwd_dw(const void* x, const void* gd,
                                     const void* dh1, const void* dh2,
                                     void* dw1, void* dw2, int N, int C,
                                     int F, int blocks, void* stream) {
  if (bad_shape(N, C, F)) return static_cast<int>(cudaErrorInvalidValue);
  using nrse::wg::kBM;
  const EpiDw epi{{{F / kBM, C / kBM}, {C / kBN, F / kBN}},
                  {static_cast<float*>(dw1), static_cast<float*>(dw2)},
                  {C, F}};
  return static_cast<int>(nrse::wg::launch_mn(
      dh1, x, F, C, dh2, gd, C, F, N, blocks, epi,
      static_cast<cudaStream_t>(stream)));
}
