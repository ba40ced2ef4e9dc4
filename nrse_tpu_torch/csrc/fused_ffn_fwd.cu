// Fused FFN, forward (kernel B).
//
// Replaces: nrse_tpu/ops/fused_ffn.py::_fwd_kernel (the Pallas TPU kernel
// of the WavLM FFN pair), for serving (no dropout, nothing saved) and for
// training (both dropout sites, h1 saved for the backward, K2 in
// fused_ffn_bwd.cu).
//
// Computes, with the weights in torch [out, in] layout (both products are
// K-major "TN" GEMMs, wgmma's native operands):
//   h1  = x . W1^T + b1                        x [N, C], W1 [F, C], f32
//   h   = bf16(gelu_erf(h1) * keep_act)        h [N, F]  (site 0 over [N, F])
//   out = bf16((h . W2^T + b2) * keep_hid)     W2 [C, F], out [N, C]
//                                              (site 1 over [N, C])
// and, for the training forward, h1 rounded to bf16 [N, F] before the GELU.
// Products are bf16 on the tensor cores with f32 accumulation; the bias,
// the exact-erf GELU (erff, not the TPU's A&S rational erf) and the keep
// masks (philox.cuh, or explicit float32 masks) run on the f32 accumulator
// in the epilogues.  For training, h is the dropped GELU output `gd` that
// K2's dW2 product needs: the wrapper keeps it for the backward instead of
// recomputing it from h1 as the TPU's _dw_kernel does.
//
// What bounds it on the H100: at N = 36 x 249 = 8964 rows, C = 1024,
// F = 4096 the pair is ~150 GFLOP against ~100 MB of operands (plus 73 MB
// for h1 in training): the tensor cores, ~152 us at 989 TFLOP/s.
//
// Design: two launches of the persistent wgmma GEMM of wgmma_gemm.cuh (TMA
// into a ring of 128-byte-swizzled tiles, a producer warpgroup and two
// ping-pong consumer warpgroups, so one tile's epilogue runs while the
// other consumer's main loop keeps the tensor cores busy): GEMM1 x . W1^T
// (M = N, N = F, K = C) with the bias + GELU (+ h1 + activation keep)
// epilogue that writes bf16 h, then GEMM2 h . W2^T (M = N, N = C, K = F)
// with the bias (+ hidden keep) epilogue.  Rows of x or h past N arrive as
// zeros from TMA and are not stored, so every N >= 1 works; C and F are
// multiples of 128.
//
// GEMM1's epilogue, not its 16-step main loop (K = C = 1024), sets its
// time: h leaves through the consumer's side tile in shared memory and a
// TMA store (4 ring stages then) rather than as scattered 4-byte stores,
// which cut the training GEMM1 from 424-472 to 314-356 us; h1 is stored
// straight from the accumulators.  The keep bits of both sites come from
// the producer warpgroup's three spare warps (keep_bits_job: one Philox
// draw per group of four columns, words 0-1 to the even thread of a pair
// and 2-3 to the odd one) into shared memory: drawing in the epilogue
// would spill beside the 128 accumulators a thread holds under ptxas's
// 168-register cap.  That cap is what this epilogue is shaped by: a
// variant that stored h1 from a separate pass before the GELU (GEMM1 at
// N = 8964 in 253 us instead of 356) spilled 72-80 bytes, whatever else
// was tried.  The serving entry instantiates epilogues without the
// training work (no aux words, no h1, no keep).  GEMM2 (K = F = 4096) is
// bound by its main loop and stores directly.
//
// Why h makes a round trip through device memory, where the TPU kernel
// keeps it in VMEM (nrse_tpu/ops/fused_ffn.py:110-160): fusing the two
// products needs an f32 [rows, C] accumulator across all of F, at C = 1024
// 512 KB for 128 rows, twice an SM's register file.  The round trip is
// ~39 us of HBM time at N = 7968 against ~2 x 130 us of products, and the
// training forward must write h (gd) and h1 for K2 anyway.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_gemm.cuh"
#include "philox.cuh"
#include "wgmma_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;
using nrse::DropSite;
using nrse::gemm::gelu_erf;
using nrse::gemm::store_bf16x2;
using nrse::wg::TileCtx;

// Training epilogues draw their sites' keep bits on the producer's spare
// warps; serving ones do nothing there.
template <bool kTrain, bool kSide>
struct KeepAux {
  static constexpr bool kSideTile = kSide;
  static constexpr bool kSideLoad = false;
  static constexpr int kScratchFloats = 0;
  static constexpr int kAuxWords = kTrain ? nrse::wg::kKeepAuxWords : 0;
  static constexpr int kAuxJobs = kTrain ? nrse::wg::kKeepAuxJobs : 0;
};

// GEMM1: h = bf16(gelu(acc + b1) * keep_act), and in training
// h1 = bf16(acc + b1).  h is written into the side tile, which the GEMM
// stores by TMA; h1 goes straight to device memory.
template <bool kTrain>
struct EpiGelu : KeepAux<kTrain, true> {
  const float* bias;
  bf16* h1;  // training: null, or where h1 goes
  int M, ld;
  DropSite drop;

  __device__ __forceinline__ void aux(int mt, int n0, int job,
                                      uint32_t* words) const {
    if (kTrain) nrse::wg::keep_bits_job(drop, ld, mt, n0, job, words);
  }

  __device__ __forceinline__ void store(float (&acc)[2][64],
                                        const TileCtx& ctx, uint8_t* side,
                                        float*, const uint32_t* aux) const {
    uint4 keep = make_uint4(0u, 0u, 0u, 0u);
    if (kTrain) keep = nrse::wg::keep_words(drop, aux);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = ctx.col + 8 * j;
      const float2 b = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = ctx.row + 64 * r + 8 * h;
          if (row >= M) continue;
          const size_t idx = static_cast<size_t>(row) * ld + col;
          const float x0 = acc[r][4 * j + 2 * h] + b.x;
          const float x1 = acc[r][4 * j + 2 * h + 1] + b.y;
          float g0 = gelu_erf(x0);
          float g1 = gelu_erf(x1);
          if (kTrain) {
            if (h1 != nullptr) store_bf16x2(h1 + idx, x0, x1);
            const float2 k = nrse::wg::keep_pair(drop, keep, r, h, j, idx);
            g0 *= k.x;
            g1 *= k.y;
          }
          store_bf16x2(reinterpret_cast<bf16*>(
                           side + nrse::wg::side_offset(ctx, r, h, j)),
                       g0, g1);
        }
      }
    }
  }
};

// GEMM2: out = bf16((acc + b2) * keep_hid), or the same in f32 into out32
// (a column shard's partial sum, rounded only after the shards' sum)
template <bool kTrain>
struct EpiBias : KeepAux<kTrain, false> {
  const float* bias;
  bf16* out;
  float* out32;  // non-null: the f32 output instead of out
  int M, ld;
  DropSite drop;

  __device__ __forceinline__ void aux(int mt, int n0, int job,
                                      uint32_t* words) const {
    if (kTrain) nrse::wg::keep_bits_job(drop, ld, mt, n0, job, words);
  }

  __device__ __forceinline__ void store(float (&acc)[2][64],
                                        const TileCtx& ctx, uint8_t*, float*,
                                        const uint32_t* aux) const {
    uint4 keep = make_uint4(0u, 0u, 0u, 0u);
    if (kTrain) keep = nrse::wg::keep_words(drop, aux);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = ctx.col + 8 * j;
      const float2 b = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = ctx.row + 64 * r + 8 * h;
          if (row >= M) continue;
          const size_t idx = static_cast<size_t>(row) * ld + col;
          float x0 = acc[r][4 * j + 2 * h] + b.x;
          float x1 = acc[r][4 * j + 2 * h + 1] + b.y;
          if (kTrain) {
            const float2 k = nrse::wg::keep_pair(drop, keep, r, h, j, idx);
            x0 *= k.x;
            x1 *= k.y;
          }
          if (out32 != nullptr) {
            *reinterpret_cast<float2*>(out32 + idx) = make_float2(x0, x1);
          } else {
            store_bf16x2(out + idx, x0, x1);
          }
        }
      }
    }
  }
};

bool bad_shape(int N, int C, int F) {
  return N < 1 || C % nrse::wg::kBN || F % nrse::wg::kBN;
}

template <bool kTrain>
int run(const void* x, const void* w1, const void* b1, const void* w2,
        const void* b2, void* h, void* h1, void* out, int out_f32,
        DropSite act, DropSite hid, int N, int C, int F, void* stream) {
  if (bad_shape(N, C, F)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const EpiGelu<kTrain> e1{{}, static_cast<const float*>(b1),
                           static_cast<bf16*>(h1), N, F, act};
  cudaError_t err = nrse::wg::launch(x, w1, nullptr, h, N, F, C, e1, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const EpiBias<kTrain> e2{{}, static_cast<const float*>(b2),
                           out_f32 ? nullptr : static_cast<bf16*>(out),
                           out_f32 ? static_cast<float*>(out) : nullptr, N,
                           C, hid};
  return static_cast<int>(
      nrse::wg::launch(h, w2, nullptr, nullptr, N, C, F, e2, s));
}

}  // namespace

// Serving: x [N, C], w1 [F, C], b1 [F] f32, w2 [C, F], b2 [C] f32; h [N, F]
// is scratch the caller allocates; out [N, C], f32 if out_f32 (a column
// shard's partial sum under tensor parallelism).  All bf16 unless noted,
// 16-byte aligned.
extern "C" int nrse_fused_ffn_fwd(const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, void* h, void* out,
                                  int out_f32, int N, int C, int F,
                                  void* stream) {
  const DropSite none{nullptr, nullptr, 0u, 0.f, 1.f, 0};
  return run<false>(x, w1, b1, w2, b2, h, nullptr, out, out_f32, none, none,
                    N, C, F, stream);
}

// Training: as above (out f32 if out_f32), with h = gd kept by the caller, h1
// [N, F] bf16 (or null: nothing saved), and the two dropout sites.  Mode 0: no
// dropout; 1: Philox under the seed pair at `seed` in device memory (8-byte
// aligned), site 0 = activation over [N, F],
// site 1 = hidden over [N, C]; 2: explicit f32 masks mask_act [N, F] and
// mask_hid [N, C].  A site with p = 0 under mode 1 is not masked.  Under mode
// 1 the activation site's F columns are columns [f0, f0 + F) of an [N,
// f_global] layer (a column shard under tensor parallelism; f_global = F and
// f0 = 0 for a whole layer), whose mask they draw the slice of.
extern "C" int nrse_fused_ffn_fwd_train(
    const void* x, const void* w1, const void* b1, const void* w2,
    const void* b2, void* h, void* h1, void* out, int out_f32,
    const void* mask_act, const void* mask_hid, const void* seed,
    float p_act, float p_hid,
    float scale_act, float scale_hid, int mode, unsigned f_global,
    unsigned f0, int N, int C, int F, void* stream) {
  if (f_global < static_cast<unsigned>(F) + f0 || f0 % 4 || f_global % 4 ||
      (mode == 1 && !nrse::seed_ok(seed)))
    return static_cast<int>(cudaErrorInvalidValue);
  const uint2* key = static_cast<const uint2*>(seed);
  DropSite act{static_cast<const float*>(mask_act), key, 0u, p_act,
               scale_act, (mode == 1 && p_act == 0.f) ? 0 : mode};
  act.win.wl = static_cast<uint32_t>(F);
  act.win.wg = f_global;
  act.win.c0 = f0;
  const DropSite hid{static_cast<const float*>(mask_hid), key, 1u, p_hid,
                     scale_hid, (mode == 1 && p_hid == 0.f) ? 0 : mode};
  return run<true>(x, w1, b1, w2, b2, h, h1, out, out_f32, act, hid, N, C, F,
                   stream);
}
