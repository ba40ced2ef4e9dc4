// Fused FFN, forward (kernel B).
//
// Replaces: nrse_tpu/ops/fused_ffn.py::_fwd_kernel (the Pallas TPU kernel
// of the WavLM FFN pair), for serving (no dropout, nothing saved) and for
// training (both dropout sites, h1 saved for the backward, K2 in
// fused_ffn_bwd.cu).
//
// Computes, with the weights in torch [out, in] layout (both products are
// K-major, "NT" GEMMs):
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
// for h1 in training), so it is bound by the tensor cores; Philox costs
// ~50 integer instructions per draw, one draw per pair of neighbouring
// elements (the two columns of an accumulator pair share a group of the
// contract, philox.cuh).
//
// Design: the tiled GEMM of mma_gemm.cuh, launched twice: GEMM1 with a
// bias + GELU (+ h1 save + activation mask) epilogue that writes bf16 h,
// then GEMM2 with a bias (+ hidden mask) epilogue.  Rows beyond N are
// zero-filled on load and masked on store, so N need not be a multiple of
// the tile.  The serving entry instantiates epilogues without the training
// work, so its code is what it was before dropout existed.  The TPU
// kernel's point is that h never leaves the chip; here h makes one round
// trip through device memory.  Keeping h on chip, and wgmma/TMA in place
// of mma.sync/cp.async, are the first performance items for this kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_gemm.cuh"
#include "philox.cuh"

namespace {

using bf16 = __nv_bfloat16;
using nrse::DropSite;
using namespace nrse::gemm;

// GEMM1: h = bf16(gelu(acc + b1) * keep_act), optionally h1 = bf16(acc + b1)
template <bool kTrain>
struct EpiGelu {
  const float* bias;
  bf16* out;
  bf16* h1;  // training: null, or where h1 goes
  int ld;
  DropSite drop;

  __device__ __forceinline__ void operator()(int row, int col, float x0,
                                             float x1) const {
    x0 += bias[col];
    x1 += bias[col + 1];
    const size_t idx = static_cast<size_t>(row) * ld + col;
    float g0 = gelu_erf(x0);
    float g1 = gelu_erf(x1);
    if (kTrain) {
      if (h1 != nullptr) store_bf16x2(h1 + idx, x0, x1);
      const float2 k = drop.keep2(idx);  // col is even: one draw
      g0 *= k.x;
      g1 *= k.y;
    }
    store_bf16x2(out + idx, g0, g1);
  }
};

// GEMM2: out = bf16((acc + b2) * keep_hid)
template <bool kTrain>
struct EpiBias {
  const float* bias;
  bf16* out;
  int ld;
  DropSite drop;

  __device__ __forceinline__ void operator()(int row, int col, float x0,
                                             float x1) const {
    x0 += bias[col];
    x1 += bias[col + 1];
    const size_t idx = static_cast<size_t>(row) * ld + col;
    if (kTrain) {
      const float2 k = drop.keep2(idx);  // col is even: one draw
      x0 *= k.x;
      x1 *= k.y;
    }
    store_bf16x2(out + idx, x0, x1);
  }
};

bool bad_shape(int N, int C, int F) {
  return N < 1 || C % kBN || F % kBN || C % kBK || F % kBK;
}

template <bool kTrain>
int run(const void* x, const void* w1, const void* b1, const void* w2,
        const void* b2, void* h, void* h1, void* out, DropSite act,
        DropSite hid, int N, int C, int F, void* stream) {
  if (bad_shape(N, C, F)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const EpiGelu<kTrain> e1{static_cast<const float*>(b1),
                           static_cast<bf16*>(h), static_cast<bf16*>(h1), F,
                           act};
  cudaError_t err = launch<false, false>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), N, F, C, e1,
      s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const EpiBias<kTrain> e2{static_cast<const float*>(b2),
                           static_cast<bf16*>(out), C, hid};
  return static_cast<int>(launch<false, false>(static_cast<const bf16*>(h),
                                               static_cast<const bf16*>(w2),
                                               N, C, F, e2, s));
}

}  // namespace

// Serving: x [N, C], w1 [F, C], b1 [F] f32, w2 [C, F], b2 [C] f32; h [N, F]
// is scratch the caller allocates; out [N, C].  All bf16 unless noted.
extern "C" int nrse_fused_ffn_fwd(const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, void* h, void* out, int N,
                                  int C, int F, void* stream) {
  const DropSite none{nullptr, 0u, 0u, 0u, 0.f, 1.f, 0};
  return run<false>(x, w1, b1, w2, b2, h, nullptr, out, none, none, N, C, F,
                    stream);
}

// Training: as above, with h = gd kept by the caller, h1 [N, F] bf16 (or
// null: nothing saved), and the two dropout sites.  mode 0: no dropout;
// 1: Philox under the key (k0, k1), site 0 = activation over [N, F],
// site 1 = hidden over [N, C]; 2: explicit f32 masks mask_act [N, F] and
// mask_hid [N, C].  A site with p = 0 under mode 1 is not masked.
extern "C" int nrse_fused_ffn_fwd_train(
    const void* x, const void* w1, const void* b1, const void* w2,
    const void* b2, void* h, void* h1, void* out, const void* mask_act,
    const void* mask_hid, unsigned k0, unsigned k1, float p_act, float p_hid,
    float scale_act, float scale_hid, int mode, int N, int C, int F,
    void* stream) {
  const DropSite act{static_cast<const float*>(mask_act), k0, k1, 0u, p_act,
                     scale_act, (mode == 1 && p_act == 0.f) ? 0 : mode};
  const DropSite hid{static_cast<const float*>(mask_hid), k0, k1, 1u, p_hid,
                     scale_hid, (mode == 1 && p_hid == 0.f) ? 0 : mode};
  return run<true>(x, w1, b1, w2, b2, h, h1, out, act, hid, N, C, F, stream);
}
