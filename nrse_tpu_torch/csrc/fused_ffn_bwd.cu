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
//   dgd = bf16(dh2) . w2                       [N, F]   NN product
//   dh1 = dgd * keep_act * gelu'(h1)           f32      site 0
//   db1 = sum_n dh1                            f32, before the cast
//   dx  = bf16(dh1) . w1                       [N, C]   NN product
//   dW1 = bf16(dh1)^T . x                      [F, C]   TN product, f32
//   dW2 = bf16(dh2)^T . gd                     [C, F]   TN product, f32
//
// The masks are regenerated from the seed by Philox per element
// (philox.cuh: they depend on (seed, site, element index) only, so these
// kernels' tiles need not be kernel B's) or read from explicit masks.  gd
// is kept from the forward rather than recomputed from h1 (the TPU kernel
// recomputes it): one more [N, F] bf16 residual per layer, no recompute.
//
// What bounds it on the H100: four products of ~75 GFLOP each at N = 8964,
// C = 1024, F = 4096, against a few hundred MB of operands: tensor-core
// bound.  Blocks on Hopper run in no order and cannot carry a sum from one
// grid step to the next as the TPU grid does, so:
//   * dx: a prologue pass makes bf16 dh2 and per-128-row partial column
//     sums of dh2; the dgd GEMM (mma_gemm.cuh, B read transposed with
//     ldmatrix.trans) applies keep_act and gelu' in its epilogue, writes
//     bf16 dh1 and per-(block, warp-row) partial sums of dh1; the dx GEMM
//     follows; two small passes finish db2 and db1 over the partials in a
//     fixed order.
//   * dW: each 128 x 128 output tile is one block that loops over all N
//     rows (both operands read transposed): no split-K and no atomics, so
//     dW is the same from run to run.  1024 x 4096 is 256 tiles, about two
//     blocks on each of the 132 SMs.
// wgmma/TMA in place of mma.sync/cp.async are later performance items.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_gemm.cuh"
#include "philox.cuh"

namespace {

using bf16 = __nv_bfloat16;
using nrse::DropSite;
using namespace nrse::gemm;

constexpr int kChunkRows = 128;  // rows per partial column sum (= kBM)

// dh2 = dout * keep_hid over [N, C]: bf16 dh2 and, per 128-row chunk, the
// f32 column sums.  Grid (C / 256, ceil(N / 128)), one column a thread.
__global__ void __launch_bounds__(256)
dh2_kernel(const bf16* __restrict__ dout, DropSite hid, bf16* __restrict__ dh2,
           float* __restrict__ part, int N, int C) {
  const int col = blockIdx.x * 256 + threadIdx.x;
  const int r0 = blockIdx.y * kChunkRows;
  const int r1 = min(r0 + kChunkRows, N);
  float sum = 0.f;
  for (int row = r0; row < r1; ++row) {
    const size_t idx = static_cast<size_t>(row) * C + col;
    const float v = __bfloat162float(dout[idx]) * hid.keep(idx);
    dh2[idx] = __float2bfloat16_rn(v);
    sum += v;
  }
  part[static_cast<size_t>(blockIdx.y) * C + col] = sum;
}

// out[col] = sum over rows of part[row, col], rows in order.
__global__ void __launch_bounds__(256)
colsum_kernel(const float* __restrict__ part, int rows, int cols,
              float* __restrict__ out) {
  const int col = blockIdx.x * 256 + threadIdx.x;
  if (col >= cols) return;
  float sum = 0.f;
  for (int r = 0; r < rows; ++r) sum += part[static_cast<size_t>(r) * cols + col];
  out[col] = sum;
}

// dgd GEMM epilogue: dh1 = dgd * keep_act * gelu'(h1) -> bf16 dh1, and the
// f32 dh1 into the column partials.
struct EpiDgd {
  static constexpr bool kColSum = true;
  const bf16* h1;
  bf16* dh1;
  float* part;  // [2 * row blocks, F]
  int ld;
  DropSite act;

  __device__ __forceinline__ float2 operator()(int row, int col, float x0,
                                               float x1) const {
    const size_t idx = static_cast<size_t>(row) * ld + col;
    const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(h1 + idx);
    const float d0 = x0 * act.keep(idx) * gelu_erf_grad(__low2float(hv));
    const float d1 = x1 * act.keep(idx + 1) * gelu_erf_grad(__high2float(hv));
    store_bf16x2(dh1 + idx, d0, d1);
    return make_float2(d0, d1);
  }
  __device__ __forceinline__ void colsum(int prow, int col, float s0,
                                         float s1) const {
    part[static_cast<size_t>(prow) * ld + col] = s0;
    part[static_cast<size_t>(prow) * ld + col + 1] = s1;
  }
};

struct EpiStoreBf16 {
  static constexpr bool kColSum = false;
  bf16* out;
  int ld;
  __device__ __forceinline__ float2 operator()(int row, int col, float x0,
                                               float x1) const {
    store_bf16x2(out + static_cast<size_t>(row) * ld + col, x0, x1);
    return make_float2(0.f, 0.f);
  }
  __device__ void colsum(int, int, float, float) const {}
};

struct EpiStoreF32 {
  static constexpr bool kColSum = false;
  float* out;
  int ld;
  __device__ __forceinline__ float2 operator()(int row, int col, float x0,
                                               float x1) const {
    *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * ld + col) =
        make_float2(x0, x1);
    return make_float2(0.f, 0.f);
  }
  __device__ void colsum(int, int, float, float) const {}
};

bool bad_shape(int N, int C, int F) {
  return N < 1 || C % kBN || F % kBN || C % 256;
}

}  // namespace

// dx half of the backward.  Inputs: dout [N, C], h1 [N, F], w1 [F, C],
// w2 [C, F] (bf16); the hidden/activation sites as in
// nrse_fused_ffn_fwd_train (mode 0 none, 1 Philox (k0, k1), 2 explicit f32
// masks).  Outputs: dh2 [N, C] and dh1 [N, F] bf16 (the dW half reads
// them), dx [N, C] bf16, db1 [F] and db2 [C] f32.  part is f32 scratch of
// ceil(N / 128) * max(2 F, C) elements.
extern "C" int nrse_fused_ffn_bwd_dx(
    const void* dout, const void* h1, const void* w1, const void* w2,
    const void* mask_act, const void* mask_hid, unsigned k0, unsigned k1,
    float p_act, float p_hid, float scale_act, float scale_hid, int mode,
    void* dh2, void* dh1, void* dx, void* db1, void* db2, void* part, int N,
    int C, int F, void* stream) {
  if (bad_shape(N, C, F)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DropSite act{static_cast<const float*>(mask_act), k0, k1, 0u, p_act,
                     scale_act, (mode == 1 && p_act == 0.f) ? 0 : mode};
  const DropSite hid{static_cast<const float*>(mask_hid), k0, k1, 1u, p_hid,
                     scale_hid, (mode == 1 && p_hid == 0.f) ? 0 : mode};
  const int chunks = (N + kChunkRows - 1) / kChunkRows;
  float* scratch = static_cast<float*>(part);

  dh2_kernel<<<dim3(C / 256, chunks), 256, 0, s>>>(
      static_cast<const bf16*>(dout), hid, static_cast<bf16*>(dh2), scratch,
      N, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  colsum_kernel<<<(C + 255) / 256, 256, 0, s>>>(scratch, chunks, C,
                                                static_cast<float*>(db2));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const EpiDgd e1{static_cast<const bf16*>(h1), static_cast<bf16*>(dh1),
                  scratch, F, act};
  err = launch<false, true>(static_cast<const bf16*>(dh2),
                            static_cast<const bf16*>(w2), N, F, C, e1, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  colsum_kernel<<<(F + 255) / 256, 256, 0, s>>>(scratch, 2 * chunks, F,
                                                static_cast<float*>(db1));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const EpiStoreBf16 e2{static_cast<bf16*>(dx), C};
  return static_cast<int>(launch<false, true>(static_cast<const bf16*>(dh1),
                                              static_cast<const bf16*>(w1),
                                              N, C, F, e2, s));
}

// dW half: x [N, C], gd [N, F] (kernel B's h), dh1 [N, F], dh2 [N, C]
// bf16 -> dw1 [F, C] and dw2 [C, F] f32, torch's weight layouts.
extern "C" int nrse_fused_ffn_bwd_dw(const void* x, const void* gd,
                                     const void* dh1, const void* dh2,
                                     void* dw1, void* dw2, int N, int C,
                                     int F, void* stream) {
  if (bad_shape(N, C, F)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const EpiStoreF32 e1{static_cast<float*>(dw1), C};
  cudaError_t err = launch<true, true>(static_cast<const bf16*>(dh1),
                                       static_cast<const bf16*>(x), F, C, N,
                                       e1, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const EpiStoreF32 e2{static_cast<float*>(dw2), F};
  return static_cast<int>(launch<true, true>(static_cast<const bf16*>(dh2),
                                             static_cast<const bf16*>(gd), C,
                                             F, N, e2, s));
}
