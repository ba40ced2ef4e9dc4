// Flash gated attention with a Toeplitz position bias, backward (K5's dq
// and dk/dv kernels).
//
// Replaces: nrse_tpu/ops/flash_attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (the Pallas TPU kernels for 384 < T, t_pad <= 3072) and
// their streamed variants ::_bwd_dq_streamed_kernel and
// ::_bwd_dkv_streamed_kernel (t_pad > 3072, K/V blocks streamed from HBM
// because VMEM holds a head's K/V only up to there).  One pair serves every
// T up to 65536 here: K/V and Q/dO tiles always stream through shared
// memory.
//
// Computes, per (batch b, head h), from K5's saved out and lse and the row
// sums delta[i] = sum_d do[i,d] * out[i,d] (f32, taken outside):
//   s[i,j]  = (q[i] . k[j]) * d^-1/2 + gate[b,h,i] * bias[h, T-1+j-i]
//             + madd[b,j]
//   p       = exp(s - lse[i]),  dp[i,j] = do[i] . v[j]
//   ds      = p * (dp - delta[i])
//   dv[j]   = sum_i bf16(p[i,j]) * do[i]
//   dq[i]   = sum_j bf16(ds[i,j]) * k[j] * d^-1/2
//   dk[j]   = sum_i bf16(ds[i,j]) * q[i] * d^-1/2
//   dgate[b,h,i] = sum_j ds[i,j] * bias[h, T-1+j-i]
//   dbias[h, T-1+j-i] += gate[b,h,i] * ds[b,h,i,j]  (over b, i, j: each
//             generator entry sums its diagonal of every batch's [T, T])
// as the TPU kernels do: p and ds rounded to bf16 before the products that
// take them, f32 accumulation, dbias in f32 (the wrapper casts it to the
// generator's dtype, as _flash_core_bwd does).
//
// What bounds it on the H100: the five T x T x D products (s, dp, dv, dk,
// dq; s and dp are recomputed by both kernels, seven in all) are at the
// trainer's shape (B=32, H=16, T=499, D=64) 82 GFLOP, ~83 us at the tensor
// cores' bf16 rate, against ~65 MB of q, k, v, out, do, dq, dk, dv (~20 us
// of HBM time): compute, growing as T^2.  The elementwise softmax work
// between the products, the diagonal sums of gate * ds and the tile loads
// are what is left to hide.
//
// Design.  The TPU's dq kernel accumulates each (head, query block)'s dbias
// window in one VMEM block revisited along a sequential batch axis; Hopper
// blocks run in no order and the port takes no float atomics (two calls
// give the same bits).  So, as K3 (block_attention_bwd.cu) splits it, with
// every product on mma.sync.m16n8k16 (bf16 in, f32 accumulation; operands
// by ldmatrix from shared-memory tiles whose rows are padded by 16 bytes):
//   * dk/dv kernel: one block of 4 warps per (b, h, 64-key tile), a warp
//     owning 16 keys.  K and V of the tile stay in shared memory; Q, dO and
//     the query tile's gate, lse and delta stream through a two-stage
//     cp.async ring, so tile n+1 loads while tile n computes.  s^T and dp^T
//     by two products, p^T and ds^T in registers, fed back as the A
//     operands of dv += p^T . dO and dk += ds^T . Q.
//   * dq kernel: one block per (b, h, 64-query tile), a warp owning 16
//     queries; Q and dO stay in shared memory, K, V and madd stream through
//     the same ring.  s and dp as above, dgate summed in registers, dq +=
//     ds . K, and gate * ds staged in shared memory once per key tile,
//     where one thread per diagonal sums it in a fixed order into the
//     block's window of 64 + T - 1 partial sums (kept across the key tiles
//     as a carry of 63 sums, written out as each 64 entries complete).
//   * a fold kernel sums those windows over the batch and the query tiles,
//     in a fixed order, onto the [H, 2T] generator.
// Both attention kernels index the bias generator at T-1+k-q directly:
// each block reads its window of win_len(T) entries (64 query rows or keys
// against every key or query, zero-padded to the last tile's end, so no
// read leaves the [H, 2T] row) into shared memory once.  T is not padded
// on the host: rows >= T are zero-filled in shared memory and masked where
// p is formed, and are never stored.  wgmma, TMA and a persistent grid
// are later work.

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
constexpr int kGdsLd = kTile + 1;  // odd f32 row: diagonal reads hit all banks

// dq kernel: the Q and dO tiles, two stages of K and V tiles and of the key
// tile's madd, the staged gate * ds tile, then the bias window
constexpr size_t kDqFixedSmem =
    (2 + 2 * kStages) * kTile * kLd * sizeof(bf16) +
    kTile * kGdsLd * sizeof(float) + kStages * kTile * sizeof(float);
// dk/dv kernel: the K and V tiles, two stages of Q and dO tiles and of the
// query tile's gate, lse and delta, then the bias window
constexpr size_t kDkvFixedSmem =
    (2 + 2 * kStages) * kTile * kLd * sizeof(bf16) +
    kStages * 3 * kTile * sizeof(float);

size_t smem_bytes(size_t fixed, int T) {
  return fixed + (win_len(T) * sizeof(bf16) + 15) / 16 * 16;
}

struct Args {
  const bf16 *q, *k, *v, *dout;
  const float* gate;   // [B, H, T]
  const bf16* bias;    // [H, 2T]
  const float* madd;   // [B, T]
  const float *lse, *delta;  // [B, H, T]
  bf16 *dq, *dk, *dv;
  float* dgate;        // [B, H, T]
  float* partial;      // [B, H, NQ, win_len(T)] gate * ds diagonal sums
  int H, T;
  float scale;
};

__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(Args args) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + kTile * kLd;
  bf16* ks = dos + kTile * kLd;               // [kStages][kTile][kLd]
  bf16* vs = ks + kStages * kTile * kLd;      // [kStages][kTile][kLd]
  float* gds = reinterpret_cast<float*>(vs + kStages * kTile * kLd);
  float* ms = gds + kTile * kGdsLd;           // [kStages][kTile]
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
  const bf16* dow = dos + warp * 16 * kLd;
  const int nk = (T + kTile - 1) / kTile;
  const int wl = win_len(T);

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

  load_tile_async(qs, args.q + head, q0, T);     // Q and dO join stage 0's
  load_tile_async(dos, args.dout + head, q0, T);  // group
  stage(0, 0);

  // win[j] = bias[h, w0 + j], w0 = T - q0 - kTile: the bias of (query
  // q0 + r, key k) is win[k - r + kTile - 1], and gate * ds of that pair
  // sums into window entry k - r + kTile - 1 too.  Entries past
  // kTile + T - 2 (keys >= T) and below generator index 0 (queries >= T)
  // are zero-filled.
  const int w0 = T - q0 - kTile;
  const bf16* brow = args.bias + static_cast<size_t>(h) * 2 * T;
  for (int j = threadIdx.x; j < wl; j += kThreads) {
    const int p = w0 + j;
    win[j] = p >= 0 && j < kTile + T - 1 ? brow[p] : __float2bfloat16(0.f);
  }

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

  // threads x < kTile sum diagonals x and x + kTile of each key tile; the
  // second runs on into the next tile's diagonal x, so it is carried
  float* part =
      args.partial + (static_cast<size_t>(bh) * gridDim.x + blockIdx.x) * wl;
  float carry = 0.f;
  float dqa[kNT][4];
  zero(dqa);
  for (int it = 0; it < nk; ++it) {
    const int k0 = it * kTile;
    const int st = it % kStages;
    if (it + 1 < nk) {
      stage((it + 1) % kStages, k0 + kTile);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // tile it (and Q, dO, the window) visible to all
    const bf16* kt = ks + st * kTile * kLd;
    const bf16* vt = vs + st * kTile * kLd;
    const float* mt = ms + st * kTile;

    float s[kNT][4], dp[kNT][4];  // [16 queries, 64 keys]
    zero(s);
    zero(dp);
    mma_rows_cols(s, qw, kt, lane);
    mma_rows_cols(dp, dow, vt, lane);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e / 2;
        const int kj = j * 8 + (lane % 4) * 2 + (e % 2);
        const float bv =
            __bfloat162float(win[k0 + kj - q_l[hf] + kTile - 1]);
        const float x = s[j][e] * args.scale + g[hf] * bv + mt[kj];
        const bool ok = q_ok[hf] && k0 + kj < T;
        const float p = ok ? expf(x - lse[hf]) : 0.f;
        const float dsv = p * (dp[j][e] - delta[hf]);
        dg[hf] = fmaf(dsv, bv, dg[hf]);
        gds[q_l[hf] * kGdsLd + kj] = g[hf] * dsv;
        s[j][e] = dsv;
      }
    }
    __syncthreads();  // the gate * ds tile is complete
    if (threadIdx.x < kTile) {
      const int x = threadIdx.x;
      // diagonal x: rows kTile-1-x.., column x - (kTile-1) + r
      float lo = 0.f;
      for (int r = kTile - 1 - x; r < kTile; ++r)
        lo += gds[r * kGdsLd + x - (kTile - 1) + r];
      // diagonal x + kTile: rows ..kTile-2-x, column x + 1 + r
      float hi = 0.f;
      for (int r = 0; r < kTile - 1 - x; ++r)
        hi += gds[r * kGdsLd + x + 1 + r];
      part[k0 + x] = carry + lo;  // entry k0 + x has all its tiles now
      carry = hi;
    }
    mma_acc_vals(dqa, s, kt, lane);  // dq += ds . k
    __syncthreads();  // stage st and the gate * ds tile are rewritten next
  }
  if (threadIdx.x < kTile - 1) part[nk * kTile + threadIdx.x] = carry;

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

__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkv_kernel(Args args) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kTile * kLd;
  bf16* qs = vs + kTile * kLd;                // [kStages][kTile][kLd]
  bf16* dos = qs + kStages * kTile * kLd;     // [kStages][kTile][kLd]
  // [kStages][gate, lse, delta][kTile]
  float* rows = reinterpret_cast<float*>(dos + kStages * kTile * kLd);
  bf16* win = reinterpret_cast<bf16*>(rows + kStages * 3 * kTile);

  const int T = args.T, H = args.H;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * kTile;
  const size_t head = static_cast<size_t>(bh) * T * kHeadDim;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nq = (T + kTile - 1) / kTile;
  const int wl = win_len(T);

  // Q, dO, gate, lse and delta of query tile q0 into stage st, as one
  // cp.async group
  auto stage = [&](int st, int q0) {
    load_tile_async(qs + st * kTile * kLd, args.q + head, q0, T);
    load_tile_async(dos + st * kTile * kLd, args.dout + head, q0, T);
    float* r = rows + st * 3 * kTile;
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool ok = q0 + i < T;
      const size_t row = static_cast<size_t>(bh) * T + (ok ? q0 + i : 0);
      cp_async4(r + i, args.gate + row, ok ? 4 : 0);
      cp_async4(r + kTile + i, args.lse + row, ok ? 4 : 0);
      cp_async4(r + 2 * kTile + i, args.delta + row, ok ? 4 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  load_tile_async(ks, args.k + head, k0, T);  // K and V join stage 0's
  load_tile_async(vs, args.v + head, k0, T);  // group
  stage(0, 0);

  // win[j] = bias[h, w0 + j], w0 = T + k0 - nq * kTile: the bias of (query
  // q, key k0 + c) is win[c - q + nq * kTile - 1], for every query of every
  // tile, padded ones included; entries outside the [0, 2T) generator row
  // are zero-filled
  const int w0 = T + k0 - nq * kTile;
  const bf16* brow = args.bias + static_cast<size_t>(h) * 2 * T;
  for (int j = threadIdx.x; j < wl; j += kThreads) {
    const int p = w0 + j;
    win[j] = p >= 0 && p < 2 * T ? brow[p] : __float2bfloat16(0.f);
  }

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
  for (int it = 0; it < nq; ++it) {
    const int q0 = it * kTile;
    const int st = it % kStages;
    if (it + 1 < nq) {
      stage((it + 1) % kStages, q0 + kTile);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // tile it (and K, V, the window) visible to all
    const bf16* qt = qs + st * kTile * kLd;
    const bf16* dot = dos + st * kTile * kLd;
    const float* gs = rows + st * 3 * kTile;
    const float* ls = gs + kTile;
    const float* es = ls + kTile;

    float sT[kNT][4], dpT[kNT][4];  // s^T and dp^T: [16 keys, 64 queries]
    zero(sT);
    zero(dpT);
    mma_rows_cols(sT, ks + warp * 16 * kLd, qt, lane);
    mma_rows_cols(dpT, vs + warp * 16 * kLd, dot, lane);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e / 2;
        const int qi = j * 8 + (lane % 4) * 2 + (e % 2);
        const float bv = __bfloat162float(
            win[key_l[hf] - (q0 + qi) + nq * kTile - 1]);
        const float x = sT[j][e] * args.scale + gs[qi] * bv + mk[hf];
        const bool ok = q0 + qi < T && key_ok[hf];
        const float p = ok ? expf(x - ls[qi]) : 0.f;
        sT[j][e] = p;
        dpT[j][e] = p * (dpT[j][e] - es[qi]);
      }
    }
    mma_acc_vals(dva, sT, dot, lane);  // dv += p^T . do
    mma_acc_vals(dka, dpT, qt, lane);  // dk += ds^T . q
    __syncthreads();  // stage st is refilled at the top of iteration it + 1
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

// dbias[h, p] = sum over b, then over query tiles i, in order, of
// partial[b, h, i, p - w0_i] with w0_i = T - kTile * (i + 1) (the generator
// index of window i's entry 0), where that index lies in the window
__global__ void __launch_bounds__(256)
flash_dbias_fold_kernel(const float* __restrict__ partial,
                        float* __restrict__ dbias, int B, int H, int T) {
  const int p = blockIdx.x * 256 + threadIdx.x;
  const int h = blockIdx.y;
  if (p >= 2 * T) return;
  const int nq = (T + kTile - 1) / kTile;
  const int wl = win_len(T);
  float s = 0.f;
  for (int b = 0; b < B; ++b) {
    const float* win = partial + (static_cast<size_t>(b) * H + h) * nq * wl;
    for (int i = 0; i < nq; ++i) {
      const int j = p - T + kTile * (i + 1);
      if (j >= 0 && j < wl) s += win[static_cast<size_t>(i) * wl + j];
    }
  }
  dbias[static_cast<size_t>(h) * 2 * T + p] = s;
}

bool bad_shape(int B, int H, int T, int D) {
  return D != kHeadDim || T < 1 || T > kMaxT || B < 1 || H < 1 ||
         static_cast<long long>(B) * H > 65535;
}

Args make_args(const void* q, const void* k, const void* v, const void* gate,
               const void* bias, const void* madd, const void* dout,
               const void* lse, const void* delta, int H, int T,
               float scale) {
  Args args = {};
  args.q = static_cast<const bf16*>(q);
  args.k = static_cast<const bf16*>(k);
  args.v = static_cast<const bf16*>(v);
  args.dout = static_cast<const bf16*>(dout);
  args.gate = static_cast<const float*>(gate);
  args.bias = static_cast<const bf16*>(bias);
  args.madd = static_cast<const float*>(madd);
  args.lse = static_cast<const float*>(lse);
  args.delta = static_cast<const float*>(delta);
  args.H = H;
  args.T = T;
  args.scale = scale;
  return args;
}

}  // namespace

// Both entries: q, k, v, dout (and dq, dk, dv): contiguous bf16
// [B, H, T, D], 16-byte aligned; gate, lse, delta (and dgate): f32
// [B, H, T]; bias: bf16 [H, 2T]; madd: f32 [B, T].
//
// dq, dgate and dbias (f32 [H, 2T]); partial: f32 scratch of
// B * H * ceil(T / 64) * (64 * ceil(T / 64) + 63) elements.
extern "C" int nrse_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* gate,
    const void* bias, const void* madd, const void* dout, const void* lse,
    const void* delta, void* dq, void* dgate, void* partial, void* dbias,
    int B, int H, int T, int D, float scale, void* stream) {
  if (bad_shape(B, H, T, D)) return static_cast<int>(cudaErrorInvalidValue);
  Args args = make_args(q, k, v, gate, bias, madd, dout, lse, delta, H, T,
                        scale);
  args.dq = static_cast<bf16*>(dq);
  args.dgate = static_cast<float*>(dgate);
  args.partial = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(kDqFixedSmem, T);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bwd_dq_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kTile - 1) / kTile, B * H);
  flash_attention_bwd_dq_kernel<<<grid, kThreads, smem, s>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 fold((2 * T + 255) / 256, H);
  flash_dbias_fold_kernel<<<fold, 256, 0, s>>>(
      args.partial, static_cast<float*>(dbias), B, H, T);
  return static_cast<int>(cudaGetLastError());
}

// dk and dv.
extern "C" int nrse_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* gate,
    const void* bias, const void* madd, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, int B, int H, int T, int D,
    float scale, void* stream) {
  if (bad_shape(B, H, T, D)) return static_cast<int>(cudaErrorInvalidValue);
  Args args = make_args(q, k, v, gate, bias, madd, dout, lse, delta, H, T,
                        scale);
  args.dk = static_cast<bf16*>(dk);
  args.dv = static_cast<bf16*>(dv);
  const size_t smem = smem_bytes(kDkvFixedSmem, T);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bwd_dkv_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kTile - 1) / kTile, B * H);
  flash_attention_bwd_dkv_kernel<<<grid, kThreads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
