// Dropout with in-kernel Philox masks (K1), its explicit-mask variant and
// its mask dump.
//
// Replaces: nrse_tpu/ops/fused_dropout.py::_kernel (hw_dropout and
// hw_dropout_masked, forward and backward: the backward is the same kernel
// on dy with the mask regenerated from the saved seed, so no mask tensor
// is ever kept) and the mask-dump kernel of dump_dropout_mask.  The same
// dump also serves nrse_tpu/ops/fused_ffn.py::dump_masks: kernel B's two
// sites are sites 0 and 1 of one seed over [N, F] and [N, C].
//
//   out[i] = bf16(float(x[i]) * keep(i))     keep from philox.cuh or a mask
//
// What bounds it on the H100: at the training shape, [36 x 249, 1024]
// bf16, a forward and its backward move ~37 MB, ~11 us of HBM time at
// 3.35 TB/s.  A Philox4x32-10 draw is ~50 integer instructions: a draw
// per element makes the pass integer-bound (7.6x its byte bound measured
// so on the H100).  Design: one pass, 8 elements (16 bytes of bf16) a thread,
// vector loads and stores, a scalar tail for a ragged end; two grouped
// draws a thread (philox.cuh: one draw per four elements, all four words
// used), keyed on the flat group index, so the mask is the one the plain
// twin (ops/philox.py) draws, whatever the grid.  Fusing the mask into the
// residual add that follows it is a later item.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kVec = 8;
constexpr int kThreads = 256;

// kMode 0: out = x * philox keep (bf16); 1: out = x * mask (bf16);
// 2: out = the philox keep mask itself (f32).
template <int kMode>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const bf16* __restrict__ x, const float* __restrict__ mask,
               void* __restrict__ out, int64_t n,
               const uint2* __restrict__ key, uint32_t site, float p,
               float scale, nrse::Window win) {
  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kVec;
  if (base >= n) return;
  const bool full = base + kVec <= n;
  float keep[kVec];
  if (kMode == 1 && full) {
    const float4 m0 = *reinterpret_cast<const float4*>(mask + base);
    const float4 m1 = *reinterpret_cast<const float4*>(mask + base + 4);
    keep[0] = m0.x; keep[1] = m0.y; keep[2] = m0.z; keep[3] = m0.w;
    keep[4] = m1.x; keep[5] = m1.y; keep[6] = m1.z; keep[7] = m1.w;
  } else if (kMode == 1) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      keep[e] = base + e < n ? mask[base + e] : 0.f;
    }
  } else {
    // base is a multiple of 8: elements base .. base + 7 are groups
    // base / 4 and base / 4 + 1, whole (past n on a ragged end, unused),
    // each within a row of a shard, whose window places it
    const uint64_t g = static_cast<uint64_t>(base) >> 2;
    const uint2 k = __ldg(key);
    const float4 a =
        nrse::philox_keep4(k.x, k.y, win.group(g), site, p, scale);
    const float4 b =
        nrse::philox_keep4(k.x, k.y, win.group(g + 1), site, p, scale);
    keep[0] = a.x; keep[1] = a.y; keep[2] = a.z; keep[3] = a.w;
    keep[4] = b.x; keep[5] = b.y; keep[6] = b.z; keep[7] = b.w;
  }

  if (kMode == 2) {
    float* o = static_cast<float*>(out) + base;
    if (full) {
      reinterpret_cast<float4*>(o)[0] =
          make_float4(keep[0], keep[1], keep[2], keep[3]);
      reinterpret_cast<float4*>(o)[1] =
          make_float4(keep[4], keep[5], keep[6], keep[7]);
    } else {
      for (int e = 0; base + e < n; ++e) o[e] = keep[e];
    }
    return;
  }

  bf16* o = static_cast<bf16*>(out) + base;
  if (full) {
    const uint4 v = *reinterpret_cast<const uint4*>(x + base);
    const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&v);
    uint4 r;
    __nv_bfloat162* rv = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int e = 0; e < kVec / 2; ++e) {
      rv[e] = __floats2bfloat162_rn(__low2float(xv[e]) * keep[2 * e],
                                    __high2float(xv[e]) * keep[2 * e + 1]);
    }
    *reinterpret_cast<uint4*>(o) = r;
  } else {
    for (int e = 0; base + e < n; ++e) {
      o[e] = __float2bfloat16_rn(__bfloat162float(x[base + e]) * keep[e]);
    }
  }
}

}  // namespace

// mode 0: out = dropout(x) under the key at `site`, x/out bf16; mode 1:
// out = x * mask (mask f32, the layout of x); mode 2: out (f32) = the keep
// mask of n elements (x unused).  The key is the seed pair (k0, k1) in
// device memory at `seed` (8-byte aligned, read by the kernel, so a
// captured launch draws whatever pair the table holds when it runs;
// unused in mode 1).  Every other pointer 16-byte aligned; n elements,
// flat.  Modes 0 and 2 draw over the window (wl, wg,
// c0): x as rows of wl columns holding columns [c0, c0 + wl) of rows wg
// long (philox.cuh Window; wl = wg = c0 = 0 for a whole tensor).
extern "C" int nrse_dropout(const void* x, const void* mask, void* out,
                            long long n, const void* seed,
                            unsigned site, float p, float scale, int mode,
                            unsigned wl, unsigned wg, unsigned c0,
                            void* stream) {
  if (n < 1 || mode < 0 || mode > 2 || wl % 4 || wg % 4 || c0 % 4 ||
      wg < wl + c0 || (wg != 0 && (wl == 0 || n % wl != 0)) ||
      (mode != 1 && !nrse::seed_ok(seed)))
    return static_cast<int>(cudaErrorInvalidValue);
  nrse::Window win;
  win.wl = wl;
  win.wg = wg;
  win.c0 = c0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t threads = (n + kVec - 1) / kVec;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) /
                                                kThreads);
  const bf16* xb = static_cast<const bf16*>(x);
  const float* m = static_cast<const float*>(mask);
  const uint2* key = static_cast<const uint2*>(seed);
  if (mode == 0) {
    dropout_kernel<0><<<blocks, kThreads, 0, s>>>(xb, m, out, n, key,
                                                  site, p, scale, win);
  } else if (mode == 1) {
    dropout_kernel<1><<<blocks, kThreads, 0, s>>>(xb, m, out, n, key,
                                                  site, p, scale, win);
  } else {
    dropout_kernel<2><<<blocks, kThreads, 0, s>>>(xb, m, out, n, key,
                                                  site, p, scale, win);
  }
  return static_cast<int>(cudaGetLastError());
}
