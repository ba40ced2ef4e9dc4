// Fused stride-2 conv + channel LayerNorm + exact GELU, forward and
// backward (K6).
//
// Replaces: nrse_tpu/ops/fused_frontend.py::_fwd_kernel and ::_bwd_kernel
// (with the tap-2 shift-add of its _fused_bwd), the Pallas TPU kernels of
// fused_conv_ln_gelu: layers 1-6 of wavlm-large's conv frontend, a Conv1d
// of stride 2, kernel size k in {2, 3}, C = 512 channels in and out, on
// channels-last x [B, T_in, C] bf16.  With T_out = (T_in - k) / 2 + 1:
//
//   z[t]   = sum_j x[2t + j] . W[j] + bias            f32 accumulation
//   x̂[t]   = (z[t] - mean) * rstd                      fast variance, f32
//   out[t] = gelu(x̂[t] * gamma + beta)                 exact erf
//
// Row t's operand is the run x[2t .. 2t + k - 1] = k * C contiguous values
// of the row-major input (the TPU's free pair view [B, T/2, 2C], whose
// next pair's first half is tap 2), so every product reads x in place: no
// padded copy and no shifted tap-2 tensor (the TPU wrapper makes both
// because Mosaic slices only statically).
//
// What bounds it on the H100: operations.  2 * B * T_out * k * C^2: 0.81
// TFLOP at layer 1 of the SER fine-tune (B = 32, T_out = 15999, k = 3),
// 0.82 ms at 989 TFLOP/s, against ~2.1 GB of bytes (0.63 ms); the backward
// is twice the products.
//
// What the design does about it:
//   * forward, one kernel: a block owns 64 output rows and all 512 output
//     channels (8 warps of 64 x 64, mma.sync bf16 -> f32), the [512, k C]
//     weight and the rows' operands streaming through a three-stage
//     cp.async ring; the accumulator stays in registers through the bias,
//     the row statistics (quad shuffles, then the 8 warps in order through
//     shared memory), the LayerNorm and the GELU: z never goes to HBM.  The
//     training entry also writes x̂ (bf16) and rstd (f32 [B, T_out]).
//   * backward, four steps, because blocks on this card run in no order
//     and cannot carry sums across a grid as the TPU's sequential grid
//     does in revisited VMEM blocks:
//       1. a row pass (row_layernorm.cuh): gelu'(x̂ gamma + beta) -> the
//          LayerNorm backward -> dz (bf16 [B, T_out, C]), with per-block
//          partials of dgamma, dbeta and dbias (dz in f32), then folded in
//          block order;
//       2. dx: pair row p of dx is [dz[p] W0^T + dz[p-1] W2^T | dz[p] W1^T],
//          one f32 accumulation and one rounding; rows the conv never read
//          (the trailing sample for k = 2 and odd T_in) get exactly 0;
//       3. dW [k C, C] = A^T dz over all rows as a split-K product in a
//          fixed number of row chunks (DW_SPLIT in ops/fused_frontend.py),
//          its f32 partials folded in chunk order.
//     No atomics: two calls give the same bits.  Keeping dz on chip, as
//     the TPU's single kernel does, and wgmma/TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_gemm.cuh"
#include "row_layernorm.cuh"

namespace {

using namespace nrse::gemm;

constexpr int kC = 512;            // channels: a block holds a whole row
constexpr int kFM = 64;            // forward rows per block
constexpr int kFStages = 3;
constexpr int kFWarpN = kC / 8;    // 64 columns a warp
constexpr int kFStageElems = (kFM + kC) * kRowK;
constexpr int kFSmemBytes = kFStages * kFStageElems * 2;

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kN>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kN));
}

__global__ void __launch_bounds__(kThreads, 1)
k6_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
              const float* __restrict__ bias, const float* __restrict__ gamma,
              const float* __restrict__ beta, bf16* __restrict__ out,
              bf16* __restrict__ xhat, float* __restrict__ rstd, int T_in,
              int T_out, int K, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kFM;
  const bf16* xb = x + static_cast<size_t>(b) * T_in * kC;

  auto load_stage = [&](int st, int k0) {
    bf16* as = smem + st * kFStageElems;
    bf16* bs = as + kFM * kRowK;
    {  // A: 64 rows x 32, one 16-byte chunk a thread; rows >= T_out zero
      const int row = tid / 4;
      const int col = (tid % 4) * 8;
      const int t = t0 + row;
      const bool ok = t < T_out;
      cp_async16(as + row * kRowK + col,
                 xb + static_cast<size_t>(ok ? 2 * t : 0) * kC + k0 + col,
                 ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < kC * 4 / kThreads; ++i) {  // B: 512 rows x 32
      const int chunk = tid + i * kThreads;
      const int row = chunk / 4;
      const int col = (chunk % 4) * 8;
      cp_async16(bs + row * kRowK + col,
                 w + static_cast<size_t>(row) * K + k0 + col, 16);
    }
  };

  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int ktiles = K / kBK;
#pragma unroll
  for (int s = 0; s < kFStages - 1; ++s) {
    if (s < ktiles) load_stage(s, s * kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kFStages - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is free everywhere
    const int nk = kt + kFStages - 1;
    if (nk < ktiles) load_stage(nk % kFStages, nk * kBK);
    cp_async_commit();
    const bf16* as = smem + (kt % kFStages) * kFStageElems;
    warp_mma_stage<4, 8, false, false, kRowK, kRowK>(
        acc, as, as + kFM * kRowK, 0, warp * kFWarpN, lane);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring's memory now holds the row statistics

  // z = acc + bias; per-row sums of z and z^2 over this warp's 64 columns
  float* red_s = reinterpret_cast<float*>(smem_raw);  // [8 warps][64 rows]
  float* red_q = red_s + 8 * kFM;
  float* st_mean = red_q + 8 * kFM;                   // [64]
  float* st_inv = st_mean + kFM;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = warp * kFWarpN + j * 8 + (lane % 4) * 2;
    const float2 bv = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[i][j][0] += bv.x;
      acc[i][j][1] += bv.y;
      acc[i][j][2] += bv.x;
      acc[i][j][3] += bv.y;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float z0 = acc[i][j][2 * h], z1 = acc[i][j][2 * h + 1];
        s += z0 + z1;
        q += z0 * z0 + z1 * z1;
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      q += __shfl_xor_sync(0xffffffffu, q, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      q += __shfl_xor_sync(0xffffffffu, q, 2);
      if (lane % 4 == 0) {
        const int row = i * 16 + lane / 4 + h * 8;
        red_s[warp * kFM + row] = s;
        red_q[warp * kFM + row] = q;
      }
    }
  }
  __syncthreads();
  if (tid < kFM) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < 8; ++w8) {
      s += red_s[w8 * kFM + tid];
      q += red_q[w8 * kFM + tid];
    }
    const float mean = s * (1.f / kC);
    const float var = fmaxf(q * (1.f / kC) - mean * mean, 0.f);
    const float inv = rsqrtf(var + eps);
    st_mean[tid] = mean;
    st_inv[tid] = inv;
    const int t = t0 + tid;
    if (rstd != nullptr && t < T_out)
      rstd[static_cast<size_t>(b) * T_out + t] = inv;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = i * 16 + lane / 4 + h * 8;
      const int t = t0 + row;
      if (t >= T_out) continue;
      const float mean = st_mean[row];
      const float inv = st_inv[row];
      const size_t base = (static_cast<size_t>(b) * T_out + t) * kC;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = warp * kFWarpN + j * 8 + (lane % 4) * 2;
        const float2 g = *reinterpret_cast<const float2*>(gamma + col);
        const float2 be = *reinterpret_cast<const float2*>(beta + col);
        const float x0 = (acc[i][j][2 * h] - mean) * inv;
        const float x1 = (acc[i][j][2 * h + 1] - mean) * inv;
        store_bf16x2(out + base + col, gelu_erf(x0 * g.x + be.x),
                     gelu_erf(x1 * g.y + be.y));
        if (xhat != nullptr) store_bf16x2(xhat + base + col, x0, x1);
      }
    }
  }
}

// Backward step 1's rows: x̂ given, the cotangent through GELU'.
struct K6RowSource {
  const bf16* xhat;
  const bf16* dout;
  const float* rstd;
  const float* gamma;
  const float* beta;
  __device__ __forceinline__ float load(int row, int c, float (&d)[8],
                                        float (&xh)[8]) const {
    const size_t off = static_cast<size_t>(row) * kC + c;
    load8(xhat + off, xh);
    load8(dout + off, d);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      d[e] *= gelu_erf_grad(xh[e] * gamma[c + e] + beta[c + e]);
    return rstd[row];
  }
};

// Backward step 2: dx over pair rows p (128 a block) and the 2C columns of
// a pair (128 a block): columns < C are x row 2p (dz[p] W0^T, plus dz[p-1]
// W2^T for k = 3), columns >= C are x row 2p + 1 (dz[p] W1^T).  wk is the
// kernel [k, C_in, C_out]: tap j's [C_in, C_out] is B as [N, K].
__global__ void __launch_bounds__(kThreads)
k6_dx_kernel(const bf16* __restrict__ dz, const bf16* __restrict__ wk,
             bf16* __restrict__ dx, int T_in, int T_out, int k) {
  __shared__ __align__(16) bf16 as[kStages][kBM * kRowK];
  __shared__ __align__(16) bf16 bs[kStages][kBN * kRowK];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / 4;
  const int wn = warp % 4;
  const int half = blockIdx.x * kBN / kC;   // 0: x row 2p, 1: x row 2p + 1
  const int c0 = blockIdx.x * kBN % kC;
  const int p0 = blockIdx.y * kBM;
  const int b = blockIdx.z;
  const int parts = (half == 0 && k == 3) ? 2 : 1;
  const int per_part = kC / kBK;
  const int ktiles = parts * per_part;
  const bf16* dzb = dz + static_cast<size_t>(b) * T_out * kC;

  auto load_stage = [&](int st, int kt) {
    const int part = kt / per_part;
    const int o0 = (kt % per_part) * kBK;
    const int tap = half == 1 ? 1 : (part == 0 ? 0 : 2);
    const bf16* wt = wk + static_cast<size_t>(tap) * kC * kC;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int chunk = tid + c * kThreads;
      const int row = chunk / 4;
      const int col = (chunk % 4) * 8;
      const int src = p0 + row - part;  // dz row: p, or p - 1 for tap 2
      const bool ok = src >= 0 && src < T_out;
      cp_async16(as[st] + row * kRowK + col,
                 dzb + static_cast<size_t>(ok ? src : 0) * kC + o0 + col,
                 ok ? 16 : 0);
      cp_async16(bs[st] + row * kRowK + col,
                 wt + static_cast<size_t>(c0 + row) * kC + o0 + col, 16);
    }
    cp_async_commit();
  };

  float acc[kMTiles][kNTiles][4];
#pragma unroll
  for (int i = 0; i < kMTiles; ++i)
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  load_stage(0, 0);
  for (int kt = 0; kt < ktiles; ++kt) {
    const int st = kt % kStages;
    if (kt + 1 < ktiles) {
      load_stage((kt + 1) % kStages, kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    warp_mma_stage<kMTiles, kNTiles, false, false, kRowK, kRowK>(
        acc, as[st], bs[st], wm * kWarpM, wn * kWarpN, lane);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + wm * kWarpM + i * 16 + lane / 4 + h * 8;
      const int s = 2 * p + half;
      if (s >= T_in) continue;
      bf16* row = dx + (static_cast<size_t>(b) * T_in + s) * kC + c0;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        const int col = wn * kWarpN + j * 8 + (lane % 4) * 2;
        store_bf16x2(row + col, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  }
}

// Backward step 3: one chunk of the split-K product
//   part[chunk][m][n] = sum over rows r of the chunk of A[r][m] dz[r][n],
// A[r] = x[b, 2t .. 2t + k - 1] (k C values) for r = b T_out + t; both
// operands are read K-major (ldmatrix.trans).  M = k C, N = C.
__global__ void __launch_bounds__(kThreads)
k6_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dz,
             float* __restrict__ part, int T_in, int T_out, int rows,
             int rows_per_chunk, int M) {
  __shared__ __align__(16) bf16 as[kStages][kBK * kRowMN];
  __shared__ __align__(16) bf16 bs[kStages][kBK * kRowMN];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / 4;
  const int wn = warp % 4;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int chunk_id = blockIdx.z;
  const int r_begin = chunk_id * rows_per_chunk;
  const int r_end = min(rows, r_begin + rows_per_chunk);
  const int ktiles = r_end > r_begin ? (r_end - r_begin + kBK - 1) / kBK : 0;

  auto load_stage = [&](int st, int r0) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int chunk = tid + c * kThreads;
      const int row = chunk / 16;
      const int col = (chunk % 16) * 8;
      const int r = r0 + row;
      const bool ok = r < r_end;
      const int rr = ok ? r : 0;
      const int bb = rr / T_out;
      const int t = rr - bb * T_out;
      cp_async16(as[st] + row * kRowMN + col,
                 x + (static_cast<size_t>(bb) * T_in + 2 * t) * kC + m0 + col,
                 ok ? 16 : 0);
      cp_async16(bs[st] + row * kRowMN + col,
                 dz + static_cast<size_t>(rr) * kC + n0 + col, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  float acc[kMTiles][kNTiles][4];
#pragma unroll
  for (int i = 0; i < kMTiles; ++i)
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if (ktiles > 0) load_stage(0, r_begin);
  for (int kt = 0; kt < ktiles; ++kt) {
    const int st = kt % kStages;
    if (kt + 1 < ktiles) {
      load_stage((kt + 1) % kStages, r_begin + (kt + 1) * kBK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    warp_mma_stage<kMTiles, kNTiles, true, true, kRowMN, kRowMN>(
        acc, as[st], bs[st], wm * kWarpM, wn * kWarpN, lane);
    __syncthreads();
  }

  float* out = part + static_cast<size_t>(chunk_id) * M * kC;
#pragma unroll
  for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * kWarpM + i * 16 + lane / 4 + h * 8;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        const int n = n0 + wn * kWarpN + j * 8 + (lane % 4) * 2;
        *reinterpret_cast<float2*>(out + static_cast<size_t>(m) * kC + n) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  }
}

bool bad_shape(int B, int T_in, int T_out, int k) {
  return B < 1 || (k != 2 && k != 3) || T_out < 1 ||
         T_out != (T_in - k) / 2 + 1;
}

}  // namespace

// Forward.  x [B, T_in, 512] bf16; w [512, k * 512] bf16 (row o: tap j's
// column o at j * 512 + c); bias, gamma, beta [512] f32 -> out [B, T_out,
// 512] bf16; xhat (bf16, like out) and rstd ([B, T_out] f32) when not null.
extern "C" int nrse_fused_frontend_fwd(const void* x, const void* w,
                                       const void* bias, const void* gamma,
                                       const void* beta, void* out,
                                       void* xhat, void* rstd, int B,
                                       int T_in, int T_out, int k, float eps,
                                       void* stream) {
  if (bad_shape(B, T_in, T_out, k)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      k6_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T_out + kFM - 1) / kFM, B);
  k6_fwd_kernel<<<grid, kThreads, kFSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<bf16*>(out),
      static_cast<bf16*>(xhat), static_cast<float*>(rstd), T_in, T_out,
      k * kC, eps);
  return static_cast<int>(cudaGetLastError());
}

// Backward.  dout [B, T_out, 512], x [B, T_in, 512], xhat [B, T_out, 512]
// bf16, rstd [B, T_out] f32, wk [k, 512, 512] bf16 (the kernel, [tap, C_in,
// C_out]), gamma, beta [512] f32 -> dz [B, T_out, 512] bf16 (scratch kept
// for the products), dx [B, T_in, 512] bf16, dkernel [k, 512, 512] f32 and
// vecs [3, 512] f32 (dgamma, dbeta, dbias).  Scratch: vec_part f32 of
// 3 * row_bwd_blocks(B T_out) * 512, dw_part f32 of split * k * 512^2.
extern "C" int nrse_fused_frontend_bwd(
    const void* dout, const void* x, const void* xhat, const void* rstd,
    const void* wk, const void* gamma, const void* beta, void* dz, void* dx,
    void* dkernel, void* vecs, void* vec_part, void* dw_part, int B,
    int T_in, int T_out, int k, int split, void* stream) {
  if (bad_shape(B, T_in, T_out, k) || split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = B * T_out;
  const K6RowSource src{static_cast<const bf16*>(xhat),
                        static_cast<const bf16*>(dout),
                        static_cast<const float*>(rstd),
                        static_cast<const float*>(gamma),
                        static_cast<const float*>(beta)};
  float* vp = static_cast<float*>(vec_part);
  cudaError_t err = launch_row_bwd<3>(src, static_cast<const float*>(gamma),
                                      static_cast<bf16*>(dz), vp, rows, kC, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_fold_kernel<<<dim3(kC / 256, 3), 256, 0, s>>>(vp, row_bwd_blocks(rows),
                                                   kC, static_cast<float*>(vecs));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int pairs = (T_in + 1) / 2;
  k6_dx_kernel<<<dim3(2 * kC / kBN, (pairs + kBM - 1) / kBM, B), kThreads, 0,
                 s>>>(static_cast<const bf16*>(dz),
                      static_cast<const bf16*>(wk), static_cast<bf16*>(dx),
                      T_in, T_out, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int M = k * kC;
  const int per_chunk = (rows + split - 1) / split;
  float* wp = static_cast<float*>(dw_part);
  k6_dw_kernel<<<dim3(kC / kBN, M / kBM, split), kThreads, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dz), wp, T_in,
      T_out, rows, per_chunk, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = M * kC;
  ln_fold_kernel<<<dim3((total + 255) / 256, 1), 256, 0, s>>>(
      wp, split, total, static_cast<float*>(dkernel));
  return static_cast<int>(cudaGetLastError());
}
