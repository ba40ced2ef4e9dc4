// Flash gated attention with a Toeplitz position bias, forward (K5).
//
// Replaces: nrse_tpu/ops/flash_attention.py::_fwd_kernel (the Pallas TPU
// kernel for 384 < T, t_pad <= 3072) and ::_fwd_streamed_kernel (the same
// for t_pad > 3072, which streams K/V blocks from HBM by hand).  One kernel
// serves every T here: its K/V tiles always stream through shared memory.
//
// Computes, per (batch b, head h) and for every query row i:
//   s[j]   = (q[i] . k[j]) * d^-1/2 + gate[b,h,i] * bias[h, T-1+j-i]
//            + madd[b,j]
//   with the online softmax over key tiles of 64 (as the TPU kernel's
//   multi-block branch): m' = max(m, max_j s[j]), a = exp(m - m'),
//   p[j] = exp(s[j] - m'), l = l*a + sum_j p[j], acc = acc*a + bf16(p) . v
//   out[i] = acc / max(l, 1e-30)   (bf16)
//   lse[i] = m + log(max(l, 1e-30)) (f32, kept for the backward)
// bias is the [H, 2T] bf16 Toeplitz generator (rel_pos_bias.rel_bias_vector
// of the bucket table in the compute dtype); madd is 0 for a valid key and
// -1e9 for a padded one, so a row whose keys are all padded stays finite
// (the uniform mean of v over the T keys).  No dropout: in training the
// attention dropout applies outside this kernel.
//
// What bounds it on the H100: at the evaluator's 15 s bucket (B=32, H=16,
// T=749, D=64) the two T x T x D products are 73.5 GFLOP, 74 us at the
// tensor cores' bf16 rate, against 196 MB of q, k, v and out (59 us of HBM
// time at 3.35 TB/s); at 30 s (T=1499) 294 GFLOP against 393 MB: compute,
// growing as T^2 while the bytes grow as T.  The design keeps every byte
// on chip once read: the scores and probabilities live in registers, never
// in memory, and the [H, T, T] bias is never formed.
//
// Design: one block of 4 warps per (b, h, 64-query tile), a warp owning 16
// queries (attention_common.cuh's tiles and mma.sync.m16n8k16 products fed
// by ldmatrix); the Q tile stays in shared memory, K/V tiles of 64 keys
// (and their madd) stream through a two-stage cp.async ring, so tile n+1
// loads while tile n computes.  Running max, running sum and the f32
// output accumulator stay in registers.  The query tile's window of the
// bias generator (64 + T - 1 bf16 values, zero-padded to the last key
// tile's end: 1.6 KB at T=749, 6.5 KB at T=3199) is read into shared
// memory once and indexed at T-1+k-q directly:
// the TPU kernel's shear of a [1, BQ+T] window into [BQ, BK] blocks and the
// host's per-block window gathers have no counterpart.  T is not padded on
// the host: keys >= T are zero-filled in shared memory and set to -inf
// before the softmax, queries >= T are computed and not stored.  p is
// rounded to bf16 against the running max (the TPU kernel's single-block
// branch, t_pad <= 512, rounds against the row's true max: the two differ
// by bf16 rounding, well inside the 1e-2 the card holds them to).  wgmma,
// TMA and a persistent grid are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using namespace nrse::attn;

constexpr int kMaxT = 65536;  // the bias window must fit shared memory
constexpr int kStages = 2;

// shared memory: the Q tile, two stages of K and V tiles and of the key
// tile's madd, then the bias window of win_len(T) entries
constexpr size_t kFixedSmem = (1 + 2 * kStages) * kTile * kLd * sizeof(bf16) +
                              kStages * kTile * sizeof(float);

struct Args {
  const bf16 *q, *k, *v;
  const float* gate;  // [B, H, T]
  const bf16* bias;   // [H, 2T]
  const float* madd;  // [B, T]
  bf16* out;
  float* lse;         // [B, H, T]
  int H, T;
  float scale;
};

__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_kernel(Args args) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kTile * kLd;                // [kStages][kTile][kLd]
  bf16* vs = ks + kStages * kTile * kLd;      // [kStages][kTile][kLd]
  float* ms = reinterpret_cast<float*>(vs + kStages * kTile * kLd);
  bf16* win = reinterpret_cast<bf16*>(ms + kStages * kTile);

  const int T = args.T, H = args.H;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kTile;
  const size_t head = static_cast<size_t>(bh) * T * kHeadDim;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bf16* qw = qs + warp * 16 * kLd;
  const int nk = (T + kTile - 1) / kTile;

  // K, V and madd of key tile k0 into stage st, as one cp.async group
  auto stage = [&](int st, int k0) {
    load_tile_async(ks + st * kTile * kLd, args.k + head, k0, T);
    load_tile_async(vs + st * kTile * kLd, args.v + head, k0, T);
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
      const bool ok = k0 + j < T;
      cp_async4(ms + st * kTile + j,
                args.madd + static_cast<size_t>(b) * T + (ok ? k0 + j : 0),
                ok ? 4 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  load_tile_async(qs, args.q + head, q0, T);  // joins stage 0's group
  stage(0, 0);

  // win[j] = bias[h, w0 + j], w0 = T - 1 - (q0 + kTile - 1): the entries
  // of query rows q0..q0+63 against keys 0..T-1.  The bias of (query
  // q0 + r, key k) is win[k - r + kTile - 1].  The score loop reads it for
  // every key of the last tile, up to k = nk * kTile - 1, so the window
  // holds win_len(T) entries; those past kTile + T - 2 (keys >= T) and
  // those below generator index 0 (queries >= T) are zero-filled.
  const int w0 = T - q0 - kTile;
  const bf16* brow = args.bias + static_cast<size_t>(h) * 2 * T;
  for (int j = threadIdx.x; j < win_len(T); j += kThreads) {
    const int p = w0 + j;
    win[j] = p >= 0 && j < kTile + T - 1 ? brow[p] : __float2bfloat16(0.f);
  }

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

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's columns; summed over the quad
  float o[kNT][4];
  zero(o);
  for (int it = 0; it < nk; ++it) {
    const int k0 = it * kTile;
    const int st = it % kStages;
    if (it + 1 < nk) {
      stage((it + 1) % kStages, k0 + kTile);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // tile it (and Q, the window) visible to every warp
    const bf16* kt = ks + st * kTile * kLd;
    const bf16* vt = vs + st * kTile * kLd;
    const float* mt = ms + st * kTile;

    float s[kNT][4];
    zero(s);
    mma_rows_cols(s, qw, kt, lane);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e / 2;
        const int kj = j * 8 + (lane % 4) * 2 + (e % 2);
        const float bias =
            __bfloat162float(win[k0 + kj - q_l[hf] + kTile - 1]);
        const float x = s[j][e] * args.scale + g[hf] * bias + mt[kj];
        s[j][e] = k0 + kj < T ? x : -INFINITY;
        mx[hf] = fmaxf(mx[hf], s[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      // key 0 of the first tile is valid, so the running max is finite
      // from the first tile on and exp(-inf - m') = 0 starts the sums
      const float m_new = fmaxf(m[hf], mx[hf]);
      alpha[hf] = expf(m[hf] - m_new);
      m[hf] = m_new;
      l[hf] *= alpha[hf];
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e / 2;
        o[j][e] *= alpha[hf];
        const float p = expf(s[j][e] - m[hf]);  // exp(-inf) = 0
        l[hf] += p;
        s[j][e] = p;
      }
    }
    mma_acc_vals(o, s, vt, lane);
    __syncthreads();  // stage st is refilled at the top of iteration it + 1
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    l[hf] = fmaxf(l[hf], 1e-30f);
    if (!q_ok[hf]) continue;
    const size_t row = static_cast<size_t>(bh) * T + q0 + q_l[hf];
    if (lane % 4 == 0) args.lse[row] = m[hf] + logf(l[hf]);
#pragma unroll
    for (int jd = 0; jd < kNT; ++jd) {
      const int d = jd * 8 + (lane % 4) * 2;
      *reinterpret_cast<__nv_bfloat162*>(args.out + row * kHeadDim + d) =
          __floats2bfloat162_rn(o[jd][2 * hf] / l[hf],
                                o[jd][2 * hf + 1] / l[hf]);
    }
  }
}

}  // namespace

// q, k, v, out: contiguous bf16 [B, H, T, D], 16-byte aligned; gate, lse:
// f32 [B, H, T]; bias: bf16 [H, 2T]; madd: f32 [B, T].
extern "C" int nrse_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, const void* gate,
                                        const void* bias, const void* madd,
                                        void* out, void* lse, int B, int H,
                                        int T, int D, float scale,
                                        void* stream) {
  if (D != kHeadDim || T < 1 || T > kMaxT || B < 1 || H < 1 ||
      static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args args;
  args.q = static_cast<const bf16*>(q);
  args.k = static_cast<const bf16*>(k);
  args.v = static_cast<const bf16*>(v);
  args.gate = static_cast<const float*>(gate);
  args.bias = static_cast<const bf16*>(bias);
  args.madd = static_cast<const float*>(madd);
  args.out = static_cast<bf16*>(out);
  args.lse = static_cast<float*>(lse);
  args.H = H;
  args.T = T;
  args.scale = scale;
  const size_t win_bytes = (win_len(T) * sizeof(bf16) + 15) / 16 * 16;
  const size_t smem = kFixedSmem + win_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kTile - 1) / kTile, B * H);
  flash_attention_fwd_kernel<<<grid, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
