// Row pieces shared by K7 (channel_layernorm.cu) and K6's backward row
// pass (fused_frontend.cu): one warp per row of C bf16 channels, lane l
// holding channels 8 (32 j + l) .. + 7 of chunk j (one 16-byte load), the
// row's sums reduced by warp shuffles, float32 throughout.
//
// ln_row_bwd_kernel is the LayerNorm backward of rows whose x̂, cotangent
// dy and inv come from a source policy:
//
//   g  = dy * scale
//   dx = inv * (g - mean(g) - x̂ * mean(g * x̂))        -> bf16
//   partial sums over the block's rows of dy * x̂, dy (and, with kSums = 3,
//   of dx in float32), one row of partials per block: part[s][block][c]
//
// The blocks walk the rows grid-stride, so the partials are a fixed
// function of N and the grid; a later pass sums them in block order.  No
// atomics: two calls give the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRowWarps = 8;         // rows in flight per block, one a warp
constexpr int kRowThreads = 32 * kRowWarps;
constexpr int kChunkC = 256;         // channels of one chunk across a warp
constexpr int kMaxRowC = 4 * kChunkC;

__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Src: __device__ float load(int row, int c, float (&dy)[8],
// float (&xh)[8]) const — the cotangent and x̂ of channels c .. c + 7 of
// `row`, returning the row's inv.  kChunks = ceil(C / 256).
template <int kChunks, int kSums, class Src>
__global__ void __launch_bounds__(kRowThreads)
ln_row_bwd_kernel(Src src, const float* __restrict__ scale,
                  bf16* __restrict__ dx, float* __restrict__ part, int N,
                  int C) {
  __shared__ float red[kRowWarps][kMaxRowC];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float acc[kSums][kChunks][8];
#pragma unroll
  for (int s = 0; s < kSums; ++s)
#pragma unroll
    for (int j = 0; j < kChunks; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[s][j][e] = 0.f;
  float sc[kChunks][8];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = (j * 32 + lane) * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) sc[j][e] = c < C ? scale[c + e] : 0.f;
  }
  const float inv_c = 1.f / static_cast<float>(C);

  for (int row = blockIdx.x * kRowWarps + warp; row < N;
       row += gridDim.x * kRowWarps) {
    float dy[kChunks][8], xh[kChunks][8];
    float inv = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = (j * 32 + lane) * 8;
      if (c < C) {
        inv = src.load(row, c, dy[j], xh[j]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) dy[j][e] = xh[j][e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float g = dy[j][e] * sc[j][e];
        s1 += g;
        s2 += g * xh[j][e];
      }
    }
    const float m1 = warp_sum(s1) * inv_c;
    const float m2 = warp_sum(s2) * inv_c;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = (j * 32 + lane) * 8;
      if (c >= C) continue;
      float d[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        d[e] = inv * (dy[j][e] * sc[j][e] - m1 - xh[j][e] * m2);
        acc[0][j][e] += dy[j][e] * xh[j][e];
        acc[1][j][e] += dy[j][e];
        if constexpr (kSums == 3) acc[2][j][e] += d[e];
      }
      store8(dx + static_cast<size_t>(row) * C + c, d);
    }
  }

  // the block's partials: warps summed in order through shared memory
#pragma unroll
  for (int s = 0; s < kSums; ++s) {
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = (j * 32 + lane) * 8;
      if (c < C)
#pragma unroll
        for (int e = 0; e < 8; ++e) red[warp][c + e] = acc[s][j][e];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += kRowThreads) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kRowWarps; ++w) v += red[w][c];
      part[(static_cast<size_t>(s) * gridDim.x + blockIdx.x) * C + c] = v;
    }
    __syncthreads();
  }
}

// Blocks of the backward's grid: one partial row each, a fixed function of
// N (ops/pallas_norm.py::partial_rows gives the same number).
inline int row_bwd_blocks(int N) {
  const int blocks = (N + kRowWarps - 1) / kRowWarps;
  return blocks < 512 ? (blocks < 1 ? 1 : blocks) : 512;
}

template <int kSums, class Src>
cudaError_t launch_row_bwd(const Src& src, const float* scale, bf16* dx,
                           float* part, int N, int C, cudaStream_t s) {
  const dim3 grid(row_bwd_blocks(N));
  switch ((C + kChunkC - 1) / kChunkC) {
    case 1:
      ln_row_bwd_kernel<1, kSums><<<grid, kRowThreads, 0, s>>>(src, scale, dx,
                                                              part, N, C);
      break;
    case 2:
      ln_row_bwd_kernel<2, kSums><<<grid, kRowThreads, 0, s>>>(src, scale, dx,
                                                              part, N, C);
      break;
    case 3:
      ln_row_bwd_kernel<3, kSums><<<grid, kRowThreads, 0, s>>>(src, scale, dx,
                                                              part, N, C);
      break;
    default:
      ln_row_bwd_kernel<4, kSums><<<grid, kRowThreads, 0, s>>>(src, scale, dx,
                                                              part, N, C);
      break;
  }
  return cudaGetLastError();
}

// out[s][c] = sum over rows r of part[s][r][c], rows in order.
__global__ void __launch_bounds__(256)
ln_fold_kernel(const float* __restrict__ part, int rows, int C,
               float* __restrict__ out) {
  const int c = blockIdx.x * 256 + threadIdx.x;
  const int s = blockIdx.y;
  if (c >= C) return;
  const float* p = part + static_cast<size_t>(s) * rows * C + c;
  float v = 0.f;
  for (int r = 0; r < rows; ++r) v += p[static_cast<size_t>(r) * C];
  out[static_cast<size_t>(s) * C + c] = v;
}

}  // namespace
