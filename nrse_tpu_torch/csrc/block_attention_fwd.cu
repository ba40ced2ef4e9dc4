// Block gated attention, forward (kernel A).
//
// Replaces: nrse_tpu/ops/block_attention.py::_fwd_kernel (the one-block
// Pallas TPU kernel for T <= 384 frames), without its dropout variants.
//
// Computes, per (batch b, head h) and for every query row i:
//   s[j]   = (q[i] . k[j]) * d^-1/2 + gate[b,h,i] * bias[h,i,j] + madd[b,j]
//   m      = max_j s[j],  p[j] = exp(s[j] - m),  l = max(sum_j p[j], 1e-30)
//   out[i] = (sum_j bf16(p[j]) * v[j]) / l          (stored as bf16)
//   lse[i] = m + log(l)                             (f32, for the backward)
// madd is 0 for a valid key and -1e9 for a padded one, so a row whose keys
// are all padded stays finite (a uniform average), as in the TPU kernel.
// p is rounded to bf16 before the PV product, as the TPU kernel does.
//
// What bounds it on the H100: at the serving shape (B=32, H=16, T=249,
// D=64) QK^T and PV are ~16 MFLOP per (b, h), ~8 GFLOP a layer -- far below
// the tensor-core rate.  q, k, v and out are ~65 MB a layer; the f32 bias
// [H, T, T] is 4 MB and shared by the batch, so it stays in L2.  The kernel
// is bound by memory traffic and latency, not by arithmetic.
//
// Design: one block per (b, h, 64-query tile).  K and V of the head are
// staged once in dynamic shared memory (<= 384 x 64 bf16 each; K rows are
// padded by one 32-bit word so that lanes reading different keys hit
// different banks).  Each warp owns query rows; for a row, lane l owns keys
// l, l+32, ..., so the whole score row lives in registers (12 per lane at
// T = 384) and the softmax max and sum are warp-shuffle reductions in f32.
// For PV, lane l owns output dims 2l and 2l+1 and takes each p[j] from its
// owner lane by shuffle.  The ragged T edge is masked by bounds checks: no
// padding to 128 as on the TPU.  Tensor cores (wgmma), TMA and the backward
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;            // D: WavLM base/large
constexpr int kMaxT = 384;              // MAX_T_PAD of the TPU kernel
constexpr int kKeysPerLane = kMaxT / 32;
constexpr int kQueryTile = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kHalfD = kHeadDim / 2;    // bf16x2 words in a row
constexpr int kKStride = kHalfD + 1;    // padded K row, in bf16x2 words

__global__ void __launch_bounds__(kThreads)
block_attention_fwd_kernel(const __nv_bfloat162* __restrict__ q,
                           const __nv_bfloat162* __restrict__ k,
                           const __nv_bfloat162* __restrict__ v,
                           const float* __restrict__ gate,   // [B, H, T]
                           const float* __restrict__ bias,   // [H, T, T]
                           const float* __restrict__ madd,   // [B, T]
                           __nv_bfloat162* __restrict__ out,
                           float* __restrict__ lse,          // [B, H, T]
                           int H, int T, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat162* ks = reinterpret_cast<__nv_bfloat162*>(smem);
  __nv_bfloat162* vs = ks + T * kKStride;
  float* ms = reinterpret_cast<float*>(vs + T * kHalfD);

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const size_t head = static_cast<size_t>(bh) * T * kHalfD;

  for (int idx = threadIdx.x; idx < T * kHalfD; idx += kThreads) {
    const int r = idx / kHalfD;
    const int c = idx - r * kHalfD;
    ks[r * kKStride + c] = k[head + idx];
    vs[idx] = v[head + idx];
  }
  for (int j = threadIdx.x; j < T; j += kThreads) {
    ms[j] = madd[static_cast<size_t>(b) * T + j];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kQueryTile;

  for (int r = warp; r < kQueryTile; r += kWarps) {
    const int i = q0 + r;
    if (i >= T) break;  // uniform across the warp

    float2 qr[kHalfD];
    const __nv_bfloat162* qrow = q + head + static_cast<size_t>(i) * kHalfD;
#pragma unroll
    for (int c = 0; c < kHalfD; ++c) qr[c] = __bfloat1622float2(qrow[c]);
    const float g = gate[static_cast<size_t>(bh) * T + i];
    const float* brow = bias + (static_cast<size_t>(h) * T + i) * T;

    float s[kKeysPerLane];
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      s[t] = -INFINITY;
      if (j < T) {
        const __nv_bfloat162* krow = ks + j * kKStride;
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < kHalfD; ++c) {
          const float2 kv = __bfloat1622float2(krow[c]);
          acc = fmaf(qr[c].x, kv.x, acc);
          acc = fmaf(qr[c].y, kv.y, acc);
        }
        s[t] = acc * scale + g * brow[j] + ms[j];
        m = fmaxf(m, s[t]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));

    float l = 0.f;
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      float p = 0.f;
      if (j < T) p = expf(s[t] - m);
      l += p;
      s[t] = __bfloat162float(__float2bfloat16(p));  // PV operand is bf16
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    l = fmaxf(l, 1e-30f);

    float2 o = make_float2(0.f, 0.f);
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      if (32 * t >= T) break;
      const int n = min(32, T - 32 * t);
      for (int src = 0; src < n; ++src) {
        const float p = __shfl_sync(0xffffffffu, s[t], src);
        const float2 vv = __bfloat1622float2(vs[(32 * t + src) * kHalfD + lane]);
        o.x = fmaf(p, vv.x, o.x);
        o.y = fmaf(p, vv.y, o.y);
      }
    }
    const float inv = 1.f / l;
    out[head + static_cast<size_t>(i) * kHalfD + lane] =
        __floats2bfloat162_rn(o.x * inv, o.y * inv);
    if (lane == 0) lse[static_cast<size_t>(bh) * T + i] = m + logf(l);
  }
}

}  // namespace

extern "C" int nrse_block_attention_fwd(const void* q, const void* k,
                                        const void* v, const void* gate,
                                        const void* bias, const void* madd,
                                        void* out, void* lse, int B, int H,
                                        int T, int D, float scale,
                                        void* stream) {
  if (D != kHeadDim || T < 1 || T > kMaxT || B < 1 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(T) * kKStride * 4 +
                      static_cast<size_t>(T) * kHalfD * 4 +
                      static_cast<size_t>(T) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      block_attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kQueryTile - 1) / kQueryTile, B * H);
  block_attention_fwd_kernel<<<grid, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat162*>(q),
      static_cast<const __nv_bfloat162*>(k),
      static_cast<const __nv_bfloat162*>(v), static_cast<const float*>(gate),
      static_cast<const float*>(bias), static_cast<const float*>(madd),
      static_cast<__nv_bfloat162*>(out), static_cast<float*>(lse), H, T,
      scale);
  return static_cast<int>(cudaGetLastError());
}
