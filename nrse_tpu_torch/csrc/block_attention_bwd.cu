// Block gated attention, backward (K3).
//
// Replaces: nrse_tpu/ops/block_attention.py::_bwd_kernel (the one-block
// Pallas TPU kernel's backward for T <= 384 frames), with its dropout.
//
// Computes, per (batch b, head h), from kernel A's saved lse and the
// row sums delta[i] = sum_d do[i,d] * out[i,d] (out after dropout):
//   do'    = bf16(do * keep)          keep regenerated (attention_common.cuh)
//   s[i,j] = (q[i] . k[j]) * d^-1/2 + gate[i] * bias[h,i,j] + madd[b,j]
//   p      = exp(s - lse[i]),  dp[i,j] = do'[i] . v[j]
//   ds     = p * (dp - delta[i])
//   dv[j]  = sum_i bf16(p[i,j]) * do'[i]
//   dq[i]  = sum_j bf16(ds[i,j]) * k[j] * d^-1/2
//   dk[j]  = sum_i bf16(ds[i,j]) * q[i] * d^-1/2
//   dgate[b,h,i] = sum_j ds[i,j] * bias[h,i,j]
//   dbias[h,i,j] = sum_b gate[b,h,i] * ds[b,h,i,j]       (f32, over the batch)
// as the TPU kernel does: p and ds rounded to bf16 before the products that
// take them, f32 accumulation.
//
// What bounds it on the H100: at the training shape (B=36, H=16, T=249,
// D=64) the seven T x T x D products the split below computes are ~32
// GFLOP a layer, ~0.1 ms at the tensor cores' rate; q, k, v, do and the
// outputs are ~110 MB, and the per-batch dbias partials 143 MB written and
// read once, ~0.1 ms of HBM time.  The elementwise softmax work between
// the products (exp, the bias gather, the masks) and the tile loads are
// what is left to hide.
//
// Design.  The TPU kernel walks a sequential grid and accumulates dbias in
// one revisited VMEM block; Hopper blocks run in no order, and the port
// takes no float atomics (the same bits every run).  So the work is split
// as flash attention 2's backward splits it, with every product on
// mma.sync.m16n8k16 (bf16 in, f32 accumulation; operands by ldmatrix from
// shared-memory tiles whose rows are padded by 16 bytes, as in
// mma_gemm.cuh):
//   * dk/dv kernel: one block of 4 warps per (b, h, 64-key tile), a warp
//     owning 16 keys.  K and V of the tile stay in shared memory; the
//     block walks the 64-query tiles in order, staging Q, do' (the keep
//     mask folded in) and the f32 bias tile, computes s^T and dp^T by two
//     products, p^T and ds^T in registers, and adds p^T.do' and ds^T.q
//     into register accumulators: the accumulators of s^T are reused as
//     the A operand of the next product, so p never leaves registers.
//   * dq kernel: one block per (b, h, 64-query tile), a warp owning 16
//     queries, walking the 64-key tiles in order: s and dp as above, dgate
//     summed in registers, dq += ds.k, and gate * ds written to a per-batch
//     partial [B, H, T, T] f32.
//   * a third pass sums the partials over b in a fixed order into dbias.
// Both kernels recompute s and p; no [B, H, T, T] tensor but the f32 dbias
// partials is stored, and no mask.  The ragged T edge is zero-filled in
// shared memory and masked where p is formed.  wgmma and TMA are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using namespace nrse::attn;

constexpr int kMaxT = 384;                    // MAX_T_PAD of the TPU kernel

// shared memory of either kernel: four bf16 tiles, the f32 bias tile and
// four per-row vectors
constexpr size_t kSmemBytes = 4 * kTile * kLd * sizeof(bf16) +
                              kTile * kBiasLd * sizeof(float) +
                              4 * kTile * sizeof(float);

struct Args {
  const bf16 *q, *k, *v, *dout;
  const float *gate, *bias, *madd, *lse, *delta;  // [B,H,T] / [H,T,T] / [B,T]
  nrse::AttnDrop drop;
  bf16 *dq, *dk, *dv;
  float *dgate, *partial;                         // partial: [B, H, T, T]
  int H, T;
  float scale;
};

struct Smem {
  bf16 *t0, *t1, *t2, *t3;
  float *bs, *r0, *r1, *r2, *r3;

  __device__ explicit Smem(unsigned char* base) {
    t0 = reinterpret_cast<bf16*>(base);
    t1 = t0 + kTile * kLd;
    t2 = t1 + kTile * kLd;
    t3 = t2 + kTile * kLd;
    bs = reinterpret_cast<float*>(t3 + kTile * kLd);
    r0 = bs + kTile * kBiasLd;
    r1 = r0 + kTile;
    r2 = r1 + kTile;
    r3 = r2 + kTile;
  }
};

__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_kernel(Args args) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm(smem);
  bf16 *ks = sm.t0, *vs = sm.t1, *qs = sm.t2, *dos = sm.t3;
  float *gs = sm.r0, *ls = sm.r1, *es = sm.r2;

  const int T = args.T, H = args.H;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * kTile;
  const size_t head = static_cast<size_t>(bh) * T * kHeadDim;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  load_tile(ks, args.k + head, k0, T);
  load_tile(vs, args.v + head, k0, T);
  // this thread's two keys (accumulator rows lane/4 and lane/4 + 8)
  int key_l[2];
  float mk[2];
  bool key_ok[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    key_l[hf] = warp * 16 + lane / 4 + hf * 8;
    key_ok[hf] = k0 + key_l[hf] < T;
    mk[hf] = key_ok[hf] ? args.madd[static_cast<size_t>(b) * T + k0 +
                                    key_l[hf]]
                        : 0.f;
  }

  float dka[kNT][4], dva[kNT][4];
  zero(dka);
  zero(dva);
  for (int q0 = 0; q0 < T; q0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile(qs, args.q + head, q0, T);
    load_dout_tile(dos, args.dout + head, q0, T, b, h, H, args.drop);
    load_bias_tile(sm.bs, args.bias, h, q0, k0, T);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool ok = q0 + i < T;
      const size_t row = static_cast<size_t>(bh) * T + q0 + i;
      gs[i] = ok ? args.gate[row] : 0.f;
      ls[i] = ok ? args.lse[row] : 0.f;
      es[i] = ok ? args.delta[row] : 0.f;
    }
    __syncthreads();

    float st[kNT][4], dpt[kNT][4];  // s^T and dp^T: [16 keys, 64 queries]
    zero(st);
    zero(dpt);
    mma_rows_cols(st, ks + warp * 16 * kLd, qs, lane);
    mma_rows_cols(dpt, vs + warp * 16 * kLd, dos, lane);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e / 2;
        const int qi = j * 8 + (lane % 4) * 2 + (e % 2);
        const float s = st[j][e] * args.scale +
                        gs[qi] * sm.bs[qi * kBiasLd + key_l[hf]] + mk[hf];
        const float p = q0 + qi < T && key_ok[hf] ? expf(s - ls[qi]) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - es[qi]);
      }
    }
    mma_acc_vals(dva, st, dos, lane);  // dv += p^T . do'
    mma_acc_vals(dka, dpt, qs, lane);  // dk += ds^T . q
  }

#pragma unroll
  for (int jd = 0; jd < kNT; ++jd) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (!key_ok[hf]) continue;
      const size_t at = head + static_cast<size_t>(k0 + key_l[hf]) * kHeadDim +
                        jd * 8 + (lane % 4) * 2;
      *reinterpret_cast<__nv_bfloat162*>(args.dk + at) =
          __floats2bfloat162_rn(dka[jd][2 * hf] * args.scale,
                                dka[jd][2 * hf + 1] * args.scale);
      *reinterpret_cast<__nv_bfloat162*>(args.dv + at) =
          __floats2bfloat162_rn(dva[jd][2 * hf], dva[jd][2 * hf + 1]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(Args args) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm(smem);
  bf16 *qs = sm.t0, *dos = sm.t1, *ks = sm.t2, *vs = sm.t3;
  float* ms = sm.r0;

  const int T = args.T, H = args.H;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kTile;
  const size_t head = static_cast<size_t>(bh) * T * kHeadDim;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  load_tile(qs, args.q + head, q0, T);
  load_dout_tile(dos, args.dout + head, q0, T, b, h, H, args.drop);
  // this thread's two queries (accumulator rows lane/4 and lane/4 + 8)
  int q_l[2];
  bool q_ok[2];
  float g[2], lse[2], delta[2], dg[2] = {0.f, 0.f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    q_l[hf] = warp * 16 + lane / 4 + hf * 8;
    q_ok[hf] = q0 + q_l[hf] < T;
    const size_t row = static_cast<size_t>(bh) * T + q0 + q_l[hf];
    g[hf] = q_ok[hf] ? args.gate[row] : 0.f;
    lse[hf] = q_ok[hf] ? args.lse[row] : 0.f;
    delta[hf] = q_ok[hf] ? args.delta[row] : 0.f;
  }

  float dqa[kNT][4];
  zero(dqa);
  for (int k0 = 0; k0 < T; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile(ks, args.k + head, k0, T);
    load_tile(vs, args.v + head, k0, T);
    load_bias_tile(sm.bs, args.bias, h, q0, k0, T);
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
      ms[j] = k0 + j < T ? args.madd[static_cast<size_t>(b) * T + k0 + j]
                         : 0.f;
    }
    __syncthreads();

    float s[kNT][4], dp[kNT][4];  // [16 queries, 64 keys]
    zero(s);
    zero(dp);
    mma_rows_cols(s, qs + warp * 16 * kLd, ks, lane);
    mma_rows_cols(dp, dos + warp * 16 * kLd, vs, lane);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e / 2;
        const int kj = j * 8 + (lane % 4) * 2 + (e % 2);
        const float bv = sm.bs[q_l[hf] * kBiasLd + kj];
        const float x = s[j][e] * args.scale + g[hf] * bv + ms[kj];
        const bool ok = q_ok[hf] && k0 + kj < T;
        const float p = ok ? expf(x - lse[hf]) : 0.f;
        const float dsv = p * (dp[j][e] - delta[hf]);
        dg[hf] = fmaf(dsv, bv, dg[hf]);
        if (ok) {
          args.partial[(static_cast<size_t>(bh) * T + q0 + q_l[hf]) * T +
                       k0 + kj] = g[hf] * dsv;
        }
        s[j][e] = dsv;
      }
    }
    mma_acc_vals(dqa, s, ks, lane);  // dq += ds . k
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float v = dg[hf];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (!q_ok[hf]) continue;
    const size_t row = static_cast<size_t>(bh) * T + q0 + q_l[hf];
    if (lane % 4 == 0) args.dgate[row] = v;
#pragma unroll
    for (int jd = 0; jd < kNT; ++jd) {
      *reinterpret_cast<__nv_bfloat162*>(
          args.dq + row * kHeadDim + jd * 8 + (lane % 4) * 2) =
          __floats2bfloat162_rn(dqa[jd][2 * hf] * args.scale,
                                dqa[jd][2 * hf + 1] * args.scale);
    }
  }
}

// dbias[i] = sum over b, in order, of partial[b][i]  (i over H * T * T)
__global__ void __launch_bounds__(256)
dbias_sum_kernel(const float* __restrict__ partial, float* __restrict__ dbias,
                 int B, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += partial[b * n + i];
  dbias[i] = s;
}

}  // namespace

// Dropout as in nrse_block_attention_fwd: mode 0 none, 1 Philox under
// (k0, k1) with probability p and keep scale `keep_scale`, 2 the explicit
// f32 [B, H, T, D] `mask`.  q, k, v, dout, dq, dk, dv: contiguous bf16
// [B, H, T, D], 16-byte aligned; gate, lse, delta, dgate: f32 [B, H, T];
// bias, dbias: f32 [H, T, T]; madd: f32 [B, T]; partial: f32 scratch of
// B * H * T * T elements.
extern "C" int nrse_block_attention_bwd(
    const void* q, const void* k, const void* v, const void* gate,
    const void* bias, const void* madd, const void* dout, const void* lse,
    const void* delta, const void* mask, unsigned k0, unsigned k1, float p,
    float keep_scale, int mode, void* dq, void* dk, void* dv, void* dgate,
    void* dbias, void* partial, int B, int H, int T, int D, float scale,
    void* stream) {
  if (D != kHeadDim || T < 1 || T > kMaxT || B < 1 || H < 1 || mode < 0 ||
      mode > 2 || (mode == 2 && mask == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args args;
  args.q = static_cast<const bf16*>(q);
  args.k = static_cast<const bf16*>(k);
  args.v = static_cast<const bf16*>(v);
  args.dout = static_cast<const bf16*>(dout);
  args.gate = static_cast<const float*>(gate);
  args.bias = static_cast<const float*>(bias);
  args.madd = static_cast<const float*>(madd);
  args.lse = static_cast<const float*>(lse);
  args.delta = static_cast<const float*>(delta);
  args.drop = nrse::AttnDrop{static_cast<const float*>(mask), k0, k1, p,
                             keep_scale, mode};
  args.dq = static_cast<bf16*>(dq);
  args.dk = static_cast<bf16*>(dk);
  args.dv = static_cast<bf16*>(dv);
  args.dgate = static_cast<float*>(dgate);
  args.partial = static_cast<float*>(partial);
  args.H = H;
  args.T = T;
  args.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attention_bwd_dq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kTile - 1) / kTile, B * H);
  attention_bwd_dkdv_kernel<<<grid, kThreads, kSmemBytes, s>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dq_kernel<<<grid, kThreads, kSmemBytes, s>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(H) * T * T;
  dbias_sum_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      args.partial, static_cast<float*>(dbias), B, n);
  return static_cast<int>(cudaGetLastError());
}
