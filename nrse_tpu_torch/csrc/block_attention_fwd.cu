// Block gated attention, forward (kernel A).
//
// Replaces: nrse_tpu/ops/block_attention.py::_fwd_kernel (the one-block
// Pallas TPU kernel for T <= 384 frames), with its output dropout.
//
// Computes, per (batch b, head h) and for every query row i:
//   s[j]   = (q[i] . k[j]) * d^-1/2 + gate[b,h,i] * bias[h,i,j] + madd[b,j]
//   m      = max_j s[j],  p[j] = exp(s[j] - m),  l = max(sum_j p[j], 1e-30)
//   out[i] = keep[i] * (sum_j bf16(p[j]) * v[j]) / l  (stored as bf16)
//   lse[i] = m + log(l)                             (f32, for the backward)
// keep is 1 without dropout; with dropout it comes from Philox at the
// element's flat index in the merged [B, T, H*D] layout, so it is K1's mask
// at the same seed, or from an explicit f32 [B, H, T, D] mask
// (attention_common.cuh).  The saved out is the output after dropout, which
// is what the backward's rowsum(do * out) needs (block_attention_bwd.cu).
// madd is 0 for a valid key and -1e9 for a padded one, so a row whose keys
// are all padded stays finite (a uniform average), as in the TPU kernel.
// p is rounded to bf16 before the PV product and divided by l after it, as
// the TPU kernel does.
//
// What bounds it on the H100: at the training shape (B=36, H=16, T=249,
// D=64) the three T x T x D products below are ~14 GFLOP a layer, ~15 us at
// the tensor cores' rate; q, k, v and out are ~73 MB a layer (~22 us of
// HBM time) and the f32 bias [H, T, T] 4 MB, read once per query tile
// from L2.  What is left is the elementwise softmax work (exp, the bias
// and masks) between the products, and latency.
//
// Design: one block of 4 warps per (b, h, 64-query tile), a warp owning
// 16 queries; the block's Q tile stays in shared memory and the key tiles
// of 64 stream through it (attention_common.cuh: padded bf16 tiles,
// mma.sync.m16n8k16 fed by ldmatrix).  The TPU kernel holds whole score
// rows and takes one max; to keep its arithmetic (p rounded to bf16
// relative to the row's true max) without holding a row of up to 384
// scores per thread, the block walks the key tiles twice: first for the
// row max m, then for p = exp(s - m), its sum and bf16(p) . V, with the
// p accumulator fed back into the PV product in registers.  q . k^T is
// thus computed twice (3 products instead of 2) and no running rescale is
// needed.  The ragged T edge is zero-filled in shared memory and masked
// where p is formed.  wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using namespace nrse::attn;

constexpr int kMaxT = 384;  // MAX_T_PAD of the TPU kernel

// shared memory: the Q, K and V tiles, the f32 bias tile and madd of the
// key tile
constexpr size_t kSmemBytes = 3 * kTile * kLd * sizeof(bf16) +
                              kTile * kBiasLd * sizeof(float) +
                              kTile * sizeof(float);

struct Args {
  const bf16 *q, *k, *v;
  const float *gate, *bias, *madd;  // [B, H, T], [H, T, T], [B, T]
  bf16* out;
  float* lse;                       // [B, H, T]
  nrse::AttnDrop drop;
  int H, T;
  float scale;
};

__global__ void __launch_bounds__(kThreads)
block_attention_fwd_kernel(Args args) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kTile * kLd;
  bf16* vs = ks + kTile * kLd;
  float* bs = reinterpret_cast<float*>(vs + kTile * kLd);
  float* ms = bs + kTile * kBiasLd;

  const int T = args.T, H = args.H;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kTile;
  const size_t head = static_cast<size_t>(bh) * T * kHeadDim;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bf16* qw = qs + warp * 16 * kLd;

  load_tile(qs, args.q + head, q0, T);
  // this thread's two queries (accumulator rows lane/4 and lane/4 + 8)
  int q_l[2];
  bool q_ok[2];
  float g[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    q_l[hf] = warp * 16 + lane / 4 + hf * 8;
    q_ok[hf] = q0 + q_l[hf] < T;
    g[hf] = q_ok[hf] ? args.gate[static_cast<size_t>(bh) * T + q0 +
                                 q_l[hf]]
                     : 0.f;
  }

  // the scores of key tile k0, in place in s; keys >= T set to -inf
  auto scores = [&](float (&s)[kNT][4], int k0) {
    zero(s);
    mma_rows_cols(s, qw, ks, lane);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = j * 8 + (lane % 4) * 2 + (e % 2);
        const float x = s[j][e] * args.scale +
                        g[e / 2] * bs[q_l[e / 2] * kBiasLd + kj] + ms[kj];
        s[j][e] = k0 + kj < T ? x : -INFINITY;
      }
    }
  };
  auto stage = [&](int k0, bool with_v) {
    __syncthreads();  // the previous tile's readers are done
    load_tile(ks, args.k + head, k0, T);
    if (with_v) load_tile(vs, args.v + head, k0, T);
    load_bias_tile(bs, args.bias, h, q0, k0, T);
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
      ms[j] = k0 + j < T ? args.madd[static_cast<size_t>(b) * T + k0 + j]
                         : 0.f;
    }
    __syncthreads();
  };

  // pass 1: the row max
  float m[2] = {-INFINITY, -INFINITY};
  for (int k0 = 0; k0 < T; k0 += kTile) {
    stage(k0, false);
    float s[kNT][4];
    scores(s, k0);
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) m[e / 2] = fmaxf(m[e / 2], s[j][e]);
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    m[hf] = fmaxf(m[hf], __shfl_xor_sync(0xffffffffu, m[hf], 1));
    m[hf] = fmaxf(m[hf], __shfl_xor_sync(0xffffffffu, m[hf], 2));
  }

  // pass 2: p, its sum, and bf16(p) . V
  float l[2] = {0.f, 0.f};
  float o[kNT][4];
  zero(o);
  for (int k0 = 0; k0 < T; k0 += kTile) {
    stage(k0, true);
    float s[kNT][4];
    scores(s, k0);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e / 2]);  // exp(-inf) = 0
        l[e / 2] += p;
        s[j][e] = p;
      }
    }
    mma_acc_vals(o, s, vs, lane);
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    l[hf] = fmaxf(l[hf], 1e-30f);
    if (!q_ok[hf]) continue;
    const int i = q0 + q_l[hf];
    const size_t row = static_cast<size_t>(bh) * T + i;
    if (lane % 4 == 0) args.lse[row] = m[hf] + logf(l[hf]);
#pragma unroll
    for (int jd = 0; jd < kNT; ++jd) {
      const int d = jd * 8 + (lane % 4) * 2;
      float x0 = o[jd][2 * hf] / l[hf];
      float x1 = o[jd][2 * hf + 1] / l[hf];
      if (args.drop.mode != 0) {
        x0 *= args.drop.keep(b, h, i, d, H, T);
        x1 *= args.drop.keep(b, h, i, d + 1, H, T);
      }
      *reinterpret_cast<__nv_bfloat162*>(args.out + row * kHeadDim + d) =
          __floats2bfloat162_rn(x0, x1);
    }
  }
}

}  // namespace

// Dropout: mode 0 none, 1 Philox under (k0, k1) with probability p and
// keep scale `keep_scale`, 2 the explicit f32 [B, H, T, D] `mask`.  q, k,
// v, out: contiguous bf16 [B, H, T, D], 16-byte aligned; gate, lse: f32
// [B, H, T]; bias: f32 [H, T, T]; madd: f32 [B, T].
extern "C" int nrse_block_attention_fwd(const void* q, const void* k,
                                        const void* v, const void* gate,
                                        const void* bias, const void* madd,
                                        void* out, void* lse,
                                        const void* mask, unsigned k0,
                                        unsigned k1, float p,
                                        float keep_scale, int mode, int B,
                                        int H, int T, int D, float scale,
                                        void* stream) {
  if (D != kHeadDim || T < 1 || T > kMaxT || B < 1 || H < 1 || mode < 0 ||
      mode > 2 || (mode == 2 && mask == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args args;
  args.q = static_cast<const bf16*>(q);
  args.k = static_cast<const bf16*>(k);
  args.v = static_cast<const bf16*>(v);
  args.gate = static_cast<const float*>(gate);
  args.bias = static_cast<const float*>(bias);
  args.madd = static_cast<const float*>(madd);
  args.out = static_cast<bf16*>(out);
  args.lse = static_cast<float*>(lse);
  args.drop = nrse::AttnDrop{static_cast<const float*>(mask), k0, k1, p,
                             keep_scale, mode};
  args.H = H;
  args.T = T;
  args.scale = scale;
  cudaError_t err = cudaFuncSetAttribute(
      block_attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kTile - 1) / kTile, B * H);
  block_attention_fwd_kernel<<<grid, kThreads, kSmemBytes,
                               static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
