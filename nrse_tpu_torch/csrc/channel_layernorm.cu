// Channel LayerNorm, forward and backward (K7).
//
// Replaces: nrse_tpu/ops/pallas_norm.py::_fwd_kernel and ::_bwd_kernel,
// the Pallas TPU kernels behind pallas_channel_layernorm (flax LayerNorm
// arithmetic over the last axis of [N, C]: float32 statistics, the fast
// variance max(E[x²] − E[x]², 0), ε inside the rsqrt, the affine in
// float32, the result in x's dtype; mean and inv saved as float32 [N]).
//
// What bounds it on the H100: bytes.  It does ~10 operations per element
// against 4 bytes in and out (forward) or 6 (backward): at layer 0 of the
// SER fine-tune (N = 32 · 31999 rows × 512) ≥ 2.10 GB forward, ≥ 0.63 ms
// at 3.35 TB/s, and ≥ 3.15 GB backward, ≥ 0.94 ms.
//
// What the design does about it: every byte is read once and written
// once.  One warp owns a row (C ≤ 1024: up to four 16-byte bf16 loads a
// lane), keeps it in registers between the statistics and the normalised
// store, and reduces the row's sums by shuffles; 8 rows a block.  The
// backward (row_layernorm.cuh) writes dx in the same pass and keeps each
// lane's dscale/dbias sums in registers over its grid-stride rows; the
// block's partials are summed over its warps in order, then over the ≤ 512
// blocks in order by a fold: no atomics, so two calls give the same bits.
// The TPU accumulates dscale/dbias in a revisited VMEM block across its
// sequential grid, which blocks on this card cannot do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "row_layernorm.cuh"

namespace {

template <int kChunks>
__global__ void __launch_bounds__(kRowThreads)
ln_row_fwd_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, bf16* __restrict__ out,
                  float* __restrict__ mean_out, float* __restrict__ inv_out,
                  int N, int C, float eps) {
  const int row = blockIdx.x * kRowWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= N) return;
  const bf16* xr = x + static_cast<size_t>(row) * C;
  float v[kChunks][8];
  float s = 0.f, q = 0.f;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = (j * 32 + lane) * 8;
    if (c < C) {
      load8(xr + c, v[j]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[j][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s += v[j][e];
      q += v[j][e] * v[j][e];
    }
  }
  const float inv_c = 1.f / static_cast<float>(C);
  const float mean = warp_sum(s) * inv_c;
  const float var = fmaxf(warp_sum(q) * inv_c - mean * mean, 0.f);
  const float inv = rsqrtf(var + eps);
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = (j * 32 + lane) * 8;
    if (c >= C) continue;
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o[e] = (v[j][e] - mean) * inv * scale[c + e] + bias[c + e];
    store8(out + static_cast<size_t>(row) * C + c, o);
  }
  if (lane == 0 && mean_out != nullptr) {
    mean_out[row] = mean;
    inv_out[row] = inv;
  }
}

// K7's backward rows: x̂ recomputed from x, mean and inv.
struct K7RowSource {
  const bf16* x;
  const bf16* dy;
  const float* mean;
  const float* inv;
  int C;
  __device__ __forceinline__ float load(int row, int c, float (&d)[8],
                                        float (&xh)[8]) const {
    const size_t off = static_cast<size_t>(row) * C + c;
    const float m = mean[row];
    const float r = inv[row];
    load8(dy + off, d);
    load8(x + off, xh);
#pragma unroll
    for (int e = 0; e < 8; ++e) xh[e] = (xh[e] - m) * r;
    return r;
  }
};

bool bad_shape(int N, int C) { return N < 1 || C < 8 || C % 8 || C > kMaxRowC; }

}  // namespace

// x [N, C] bf16, scale/bias [C] f32 -> out [N, C] bf16; mean/inv [N] f32
// when not null (the training forward saves them).
extern "C" int nrse_channel_layernorm_fwd(const void* x, const void* scale,
                                          const void* bias, void* out,
                                          void* mean, void* inv, int N, int C,
                                          float eps, void* stream) {
  if (bad_shape(N, C)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kRowWarps - 1) / kRowWarps);
  const bf16* xp = static_cast<const bf16*>(x);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  bf16* op = static_cast<bf16*>(out);
  float* mp = static_cast<float*>(mean);
  float* ip = static_cast<float*>(inv);
  switch ((C + kChunkC - 1) / kChunkC) {
    case 1:
      ln_row_fwd_kernel<1><<<grid, kRowThreads, 0, s>>>(xp, sp, bp, op, mp, ip,
                                                        N, C, eps);
      break;
    case 2:
      ln_row_fwd_kernel<2><<<grid, kRowThreads, 0, s>>>(xp, sp, bp, op, mp, ip,
                                                        N, C, eps);
      break;
    case 3:
      ln_row_fwd_kernel<3><<<grid, kRowThreads, 0, s>>>(xp, sp, bp, op, mp, ip,
                                                        N, C, eps);
      break;
    default:
      ln_row_fwd_kernel<4><<<grid, kRowThreads, 0, s>>>(xp, sp, bp, op, mp, ip,
                                                        N, C, eps);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

// dy, x [N, C] bf16, mean/inv [N] f32, scale [C] f32 -> dx [N, C] bf16 and
// dvec [2, C] f32 (dscale, dbias).  part: f32 scratch of
// 2 * row_bwd_blocks(N) * C.
extern "C" int nrse_channel_layernorm_bwd(const void* dy, const void* x,
                                          const void* mean, const void* inv,
                                          const void* scale, void* dx,
                                          void* dvec, void* part, int N,
                                          int C, void* stream) {
  if (bad_shape(N, C)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const K7RowSource src{static_cast<const bf16*>(x),
                        static_cast<const bf16*>(dy),
                        static_cast<const float*>(mean),
                        static_cast<const float*>(inv), C};
  float* p = static_cast<float*>(part);
  const cudaError_t err = launch_row_bwd<2>(
      src, static_cast<const float*>(scale), static_cast<bf16*>(dx), p, N, C,
      s);
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_fold_kernel<<<dim3((C + 255) / 256, 2), 256, 0, s>>>(
      p, row_bwd_blocks(N), C, static_cast<float*>(dvec));
  return static_cast<int>(cudaGetLastError());
}
