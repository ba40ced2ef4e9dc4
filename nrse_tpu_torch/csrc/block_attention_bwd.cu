// Block gated attention, backward (K3).
//
// Replaces: nrse_tpu/ops/block_attention.py::_bwd_kernel (the one-block
// Pallas TPU kernel's backward for T <= 384 frames), with its dropout.
//
// Computes, per (batch b, head h), from kernel A's saved lse and output
// (after dropout):
//   do'    = bf16(do * keep)          keep regenerated (attention_common.cuh)
//   delta[i] = sum_d do[i,d] * out[i,d]
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
// D=64) the seven T x T x D products the split below computes are ~34
// GFLOP a layer, ~35 us at the tensor cores' rate; q, k, v, do, out and
// the outputs are ~130 MB, ~40 us of HBM time.  What is left is latency:
// each product is a short chain that the elementwise softmax work between
// products waits on, so enough blocks must share an SM to hide it.
//
// A pre-pass forms do' and delta once a layer: 8 threads a row, each 8
// columns, one Philox draw per four elements (K1's groups, so the mask is
// K1's bit for bit), or the explicit mask.  Nothing downstream draws.
//
// The Pallas kernel walks a sequential grid and accumulates dbias in one
// revisited VMEM block; Hopper blocks run in no order, and the port takes
// no float atomics (the same bits every run).  Two routes, by
// T_pad = 64 * ceil(T / 64):
//
// T_pad <= 256 (every main path: 5 s clips are 249 frames), on wgmma fed
// by TMA, two kernels of one warpgroup (128 threads) a block, two blocks
// an SM, all operands by TMA under the 128-byte swizzle from [B*H, T, 64]
// tensor maps (rows past T arrive as zeros):
//   * the dq kernel: a block per (64-query tile, h, group of batches: the
//     fewest, at least kMinGroup, whose blocks fit the card in one wave of
//     two an SM, ops/attention.py::dbias_group; 9 at B = 36, T = 249).  It
//     walks its batches in order; per batch, the query
//     tile's q and do' and the head's whole k and v arrive on one
//     mbarrier, and per 64-key tile the bias (gate * bias + madd, in units
//     of q . k, exact as the scale is 1/8) is loaded into the score
//     accumulator before S = Q K^T (four wgmma.m64n64k16), dP = dO' V^T
//     likewise, p and ds are formed in registers, dgate summed, and
//     bf16(ds) is the register A operand of dq += ds . K (K read MN-major
//     from the same tile).  gate * ds goes through a shared-memory stage
//     tile into the group's dbias partial [H, T, T], coalesced: each
//     element read, added to and written back by the same thread for each
//     batch of the group in order (the reads issued before the products,
//     to hide their latency).  The partial tensor is ceil(B / group)
//     slices (none for one group: the block writes dbias itself), and a
//     last pass sums the slices in order.
//   * the dk/dv kernel: a block per (64-key tile, b, h), the key tile's k
//     and v and the head's whole q and do' by TMA; per 64-query tile
//     S^T = K Q^T and dP^T = V dO'^T (the bias loaded first, as above),
//     and bf16(p^T), bf16(ds^T) the register operands of dv += p^T . do'
//     and dk += ds^T . q (do' and q read MN-major).
// s and dp are computed in both kernels (seven products, not five): a
// block that owned a whole (b, h) and kept ds in shared memory for dq
// would need the head's q, k, v, do' (128 KB) beside ds (128 KB), more
// than the 227 KB a block may have.
//
// 256 < T_pad <= 384 (257-384 frames: no main path sends them; kept
// simple): the flash-attention-2 split on mma.sync.m16n8k16 from padded
// shared-memory tiles (attention_common.cuh), a block of 4 warps a tile:
//   * dk/dv kernel: a block per (b, h, 64-key tile), a warp owning 16
//     keys, walking the 64-query tiles: s^T and dp^T by two products, p^T
//     and ds^T in registers fed back as the A operand of p^T . do' and
//     ds^T . q;
//   * dq kernel: a block per (b, h, 64-query tile) walking the key tiles:
//     dq += ds . k, dgate in registers, gate * ds written to a per-batch
//     partial [B, H, T, T] f32 that the last pass sums over b in order.
// Both routes take do' and delta from the pre-pass and are held to the
// same plain version (ops/attention.py) within the same tolerances.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "wgmma_common.cuh"

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
    load_tile(dos, args.dout + head, q0, T);
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
  load_tile(dos, args.dout + head, q0, T);
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

// ---------------------------------------------------------------------
// The pre-pass: do' = bf16(do * keep) and delta = rowsum(do * out).

constexpr int kPrepThreads = 256;  // 32 rows of 8 threads

__global__ void __launch_bounds__(kPrepThreads)
dout_prep_kernel(const bf16* __restrict__ dout, const bf16* __restrict__ out,
                 nrse::AttnDrop drop, bf16* __restrict__ dop,
                 float* __restrict__ delta, int H, int T, int rows) {
  const int tid = blockIdx.x * kPrepThreads + threadIdx.x;
  const int row = tid >> 3;  // (b * H + h) * T + t
  const int col = 8 * (tid & 7);
  float sum = 0.f;
  if (row < rows) {
    const size_t idx = static_cast<size_t>(row) * kHeadDim + col;
    const uint4 dv = *reinterpret_cast<const uint4*>(dout + idx);
    const uint4 ov = *reinterpret_cast<const uint4*>(out + idx);
    float4 ka = make_float4(1.f, 1.f, 1.f, 1.f), kb = ka;
    if (drop.mode == 1) {
      // the row's elements sit at (b T + t) H 64 + h 64 + d in K1's
      // merged layout; col is a multiple of 8, so two whole groups
      const int t = row % T;
      const int bh = row / T;
      const int b = bh / H;
      const uint64_t g0 =
          ((static_cast<uint64_t>(b) * T + t) *
               (static_cast<uint64_t>(H) * kHeadDim) +
           static_cast<uint64_t>(bh - b * H) * kHeadDim + col) >> 2;
      ka = nrse::philox_keep4(drop.k0, drop.k1, g0, 0u, drop.p, drop.scale);
      kb = nrse::philox_keep4(drop.k0, drop.k1, g0 + 1, 0u, drop.p,
                              drop.scale);
    } else if (drop.mode == 2) {
      const float4* m = reinterpret_cast<const float4*>(drop.mask + idx);
      ka = m[0];
      kb = m[1];
    }
    const float keep[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    uint4 r;
    __nv_bfloat162* r2 = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 d = __bfloat1622float2(d2[e]);
      const float2 o = __bfloat1622float2(o2[e]);
      sum = fmaf(d.x, o.x, sum);
      sum = fmaf(d.y, o.y, sum);
      r2[e] = __floats2bfloat162_rn(d.x * keep[2 * e], d.y * keep[2 * e + 1]);
    }
    *reinterpret_cast<uint4*>(dop + idx) = r;
  }
  // the row's 8 threads are lanes 8 m .. 8 m + 7: a fixed-order tree
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  sum += __shfl_xor_sync(0xffffffffu, sum, 4);
  if (row < rows && col == 0) delta[row] = sum;
}

// ---------------------------------------------------------------------
// The wgmma route (T_pad <= 256).

constexpr int kWgKeys = 256;  // the whole head's rows, as in kernel A
constexpr int kMinGroup = 4;  // batches one dbias partial sums, at least
constexpr int kStageLd = kTile + 8;  // f32 row of the gate * ds stage tile
constexpr int kTileB = kTile * kHeadDim * 2;    // 8 KB: 64 rows
constexpr int kHeadB = kWgKeys * kHeadDim * 2;  // 32 KB: 256 rows
constexpr float kLog2e = 1.4426950408889634f;

// shared memory: the block's 64-row tiles, the head's 256-row tiles, 256
// f32 a vector, one mbarrier
constexpr int kDqSmem = 1024 + 2 * kTileB + 2 * kHeadB + 4 * kWgKeys +
                        4 * kTile * kStageLd + 8;
constexpr int kDkvSmem = 1024 + 2 * kTileB + 2 * kHeadB + 3 * 4 * kWgKeys + 8;

struct WgArgs {
  const float *gate, *bias, *madd, *lse, *delta;  // [B,H,T] / [H,T,T] / [B,T]
  bf16 *dq, *dk, *dv;
  float* dgate;
  float* dbias;  // the group partials [groups, H, T, T], or dbias itself
  int B, H, T, group;
  float scale;
};

__device__ __forceinline__ uint8_t* align1k(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ void init_barrier(uint64_t* bar) {
  if (threadIdx.x == 0) {
    nrse::wg::mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// bf16 pairs of x (an m64n64 accumulator, x[4 j + 2 hf + e] at row
// row0 + 8 hf, column 8 j + 2 (lane % 4) + e) as wgmma's register A
// fragments: a[4 kk + r] is register r of 16-column step kk.
__device__ __forceinline__ void pack_a(const float (&x)[32],
                                       uint32_t (&a)[16]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      a[4 * (j >> 1) + 2 * (j & 1) + hf] =
          pack_bf16(x[4 * j + 2 * hf], x[4 * j + 2 * hf + 1]);
}

// acc += A . B over four 16-column steps: A the register fragments, B a
// 64-row tile read MN-major (its rows are the steps' columns); issued, not
// committed.
__device__ __forceinline__ void mma_rs_tile(float (&acc)[32],
                                            const uint32_t (&a)[16],
                                            uint64_t desc_b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t f[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                           a[4 * kk + 3]};
    nrse::wg::wgmma_m64n64k16_rs(acc, f, desc_b + 128 * kk, 1);
  }
}

// s += A . B^T and dp += C . D^T over the head dim, all four 64-row
// K-major tiles; waited for.
__device__ __forceinline__ void mma_two(float (&s)[32], uint64_t a,
                                        uint64_t b, float (&dp)[32],
                                        uint64_t c, uint64_t d) {
  namespace wg = nrse::wg;
  wg::fence_acc(s);
  wg::fence_acc(dp);
  wg::wgmma_fence();
#pragma unroll
  for (int k = 0; k < kHeadDim / 16; ++k)
    wg::wgmma_m64n64k16(s, a + 2 * k, b + 2 * k, 1);
#pragma unroll
  for (int k = 0; k < kHeadDim / 16; ++k)
    wg::wgmma_m64n64k16(dp, c + 2 * k, d + 2 * k, 1);
  wg::wgmma_commit();
  wg::wgmma_wait<0>();
  wg::fence_acc(s);
  wg::fence_acc(dp);
}

__global__ void __launch_bounds__(128, 2)
block_attention_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tmq,
                                    const __grid_constant__ CUtensorMap tmdo,
                                    const __grid_constant__ CUtensorMap tmk,
                                    const __grid_constant__ CUtensorMap tmv,
                                    WgArgs a) {
  namespace wg = nrse::wg;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1k(smem_raw);
  uint8_t* dos = qs + kTileB;
  uint8_t* ks = dos + kTileB;
  uint8_t* vs = ks + kHeadB;
  float* madd = reinterpret_cast<float*>(vs + kHeadB);
  float* stage = madd + kWgKeys;  // gate * ds of a key tile, [64][kStageLd]
  uint64_t* bar = reinterpret_cast<uint64_t*>(stage + kTile * kStageLd);

  const int T = a.T, H = a.H;
  const int q0 = blockIdx.x * kTile;
  const int grp = blockIdx.y / H;
  const int h = blockIdx.y - grp * H;
  const int b0 = grp * a.group;
  const int b1 = min(b0 + a.group, a.B);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row0 = q0 + (tid >> 5) * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  const int nk = (T + kTile - 1) / kTile;
  const float inv = 1.f / a.scale;
  float* part = a.dbias + static_cast<size_t>(grp) * H * T * T;
  init_barrier(bar);

  for (int b = b0; b < b1; ++b) {
    const int bh = b * H + h;
    __syncthreads();  // the barrier's init; the last batch's readers done
    if (tid == 0) {
      wg::mbar_expect_tx(bar, 2 * kTileB + 2 * kHeadB);
      wg::tma_load_3d(qs, &tmq, 0, q0, bh, bar);
      wg::tma_load_3d(dos, &tmdo, 0, q0, bh, bar);
      wg::tma_load_3d(ks, &tmk, 0, 0, bh, bar);
      wg::tma_load_3d(vs, &tmv, 0, 0, bh, bar);
    }
    // the key mask in units of q . k, -inf past T
    for (int j = tid; j < kWgKeys; j += 128) {
      madd[j] = j < T ? a.madd[static_cast<size_t>(b) * T + j] * inv
                      : -INFINITY;
    }
    // the thread's rows: gate, in the scores' units, lse (+inf past T, so
    // that p = 0 there) and delta
    float gr[2], g[2], lse[2], dl[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = row0 + 8 * hf;
      const bool ok = i < T;
      const size_t r = static_cast<size_t>(bh) * T + i;
      gr[hf] = ok ? a.gate[r] : 0.f;
      g[hf] = gr[hf] * inv;
      lse[hf] = ok ? a.lse[r] : INFINITY;
      dl[hf] = ok ? a.delta[r] : 0.f;
    }
    __syncthreads();  // the key mask
    wg::mbar_wait(bar, (b - b0) & 1);
    const uint64_t dqa = wg::sw128_desc(qs);
    const uint64_t doa = wg::sw128_desc(dos);

    float dq[32], dg[2] = {0.f, 0.f};
#pragma unroll
    for (int x = 0; x < 32; ++x) dq[x] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int kb = kt * kTile;
      // the bias of the thread's rows at keys kb + 8 j + c0 + e (zero past
      // T; a row past T reads row T - 1's), then s = g bias + madd
      float bv[32], s[32], dp[32];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = row0 + 8 * hf;
        const float* brow =
            a.bias + (static_cast<size_t>(h) * T + (i < T ? i : T - 1)) * T +
            kb + c0;
        const int lim = T - kb - c0;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            bv[4 * j + 2 * hf + e] =
                8 * j + e < lim ? __ldg(brow + 8 * j + e) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 mj =
            *reinterpret_cast<const float2*>(madd + kb + 8 * j + c0);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          s[4 * j + 2 * hf] = fmaf(g[hf], bv[4 * j + 2 * hf], mj.x);
          s[4 * j + 2 * hf + 1] = fmaf(g[hf], bv[4 * j + 2 * hf + 1], mj.y);
          dp[4 * j + 2 * hf] = dp[4 * j + 2 * hf + 1] = 0.f;
        }
      }
      // The group's partial of the tile before this batch (nothing before
      // the group's first), read and written coalesced: element it * 128 +
      // tid of the 64 x 64 tile, row 2 it + tid / 64, key tid % 64, by the
      // same thread every batch.  Loaded before the products, so that its
      // latency hides behind them.
      const int kk = tid & (kTile - 1);
      const int r0 = tid >> 6;
      float* pcol = part + (static_cast<size_t>(h) * T + q0 + r0) * T + kb +
                    kk;
      const int rows = kb + kk < T ? T - q0 - r0 : 0;  // valid: 2 it < rows
      float prev[32];
#pragma unroll
      for (int it = 0; it < 32; ++it) {
        prev[it] = b > b0 && 2 * it < rows
                       ? __ldcg(pcol + static_cast<size_t>(2 * it) * T)
                       : 0.f;
      }
      const uint64_t kd = wg::sw128_desc(ks + kt * kTileB);
      const uint64_t vd = wg::sw128_desc(vs + kt * kTileB);
      mma_two(s, dqa, kd, dp, doa, vd);

      // p = exp(s - lse) (s * scale is exact: a power of two), ds in place
      // of dp, dgate, and gate * ds into the stage tile
      __syncthreads();  // the last tile's stage has been read
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float* srow = stage + ((tid >> 5) * 16 + (lane >> 2) + 8 * hf) *
                                  kStageLd + c0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float gd[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * j + 2 * hf + e;
            const float p = exp2f(fmaf(s[x], a.scale, -lse[hf]) * kLog2e);
            const float ds = p * (dp[x] - dl[hf]);
            dg[hf] = fmaf(ds, bv[x], dg[hf]);
            gd[e] = gr[hf] * ds;
            dp[x] = ds;
          }
          *reinterpret_cast<float2*>(srow + 8 * j) = make_float2(gd[0], gd[1]);
        }
      }
      __syncthreads();  // the stage tile is whole
#pragma unroll
      for (int it = 0; it < 32; ++it) {
        if (2 * it < rows) {
          __stcg(pcol + static_cast<size_t>(2 * it) * T,
                 prev[it] + stage[(2 * it + r0) * kStageLd + kk]);
        }
      }

      // dq += bf16(ds) . K, K read MN-major
      uint32_t da[16];
      pack_a(dp, da);
      wg::fence_acc(dq);
      wg::wgmma_fence();
      mma_rs_tile(dq, da, kd);
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_acc(dq);
      wg::fence_regs(da);
    }

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float v = dg[hf];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      const int i = row0 + 8 * hf;
      if (i >= T) continue;
      const size_t r = static_cast<size_t>(bh) * T + i;
      if ((lane & 3) == 0) a.dgate[r] = v;
#pragma unroll
      for (int jd = 0; jd < 8; ++jd) {
        *reinterpret_cast<__nv_bfloat162*>(a.dq + r * kHeadDim + 8 * jd +
                                           c0) =
            __floats2bfloat162_rn(dq[4 * jd + 2 * hf] * a.scale,
                                  dq[4 * jd + 2 * hf + 1] * a.scale);
      }
    }
  }
}

__global__ void __launch_bounds__(128, 2)
block_attention_bwd_dkdv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tmk,
    const __grid_constant__ CUtensorMap tmv,
    const __grid_constant__ CUtensorMap tmq,
    const __grid_constant__ CUtensorMap tmdo, WgArgs a) {
  namespace wg = nrse::wg;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align1k(smem_raw);
  uint8_t* vs = ks + kTileB;
  uint8_t* qs = vs + kTileB;
  uint8_t* dos = qs + kHeadB;
  float* gs = reinterpret_cast<float*>(dos + kHeadB);  // gate / scale
  float* ls = gs + kWgKeys;                            // lse, +inf past T
  float* es = ls + kWgKeys;                            // delta
  uint64_t* bar = reinterpret_cast<uint64_t*>(es + kWgKeys);

  const int T = a.T, H = a.H;
  const int k0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row0 = k0 + (tid >> 5) * 16 + (lane >> 2);  // the thread's keys
  const int c0 = 2 * (lane & 3);
  const int nq = (T + kTile - 1) / kTile;
  const float inv = 1.f / a.scale;

  init_barrier(bar);
  __syncthreads();
  if (tid == 0) {
    wg::mbar_expect_tx(bar, 2 * kTileB + 2 * kHeadB);
    wg::tma_load_3d(ks, &tmk, 0, k0, bh, bar);
    wg::tma_load_3d(vs, &tmv, 0, k0, bh, bar);
    wg::tma_load_3d(qs, &tmq, 0, 0, bh, bar);
    wg::tma_load_3d(dos, &tmdo, 0, 0, bh, bar);
  }
  for (int i = tid; i < kWgKeys; i += 128) {
    const bool ok = i < T;
    const size_t r = static_cast<size_t>(bh) * T + i;
    gs[i] = ok ? a.gate[r] * inv : 0.f;
    ls[i] = ok ? a.lse[r] : INFINITY;
    es[i] = ok ? a.delta[r] : 0.f;
  }
  float mk[2];  // the key mask of the thread's keys, -inf past T
  const float* bcol[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int j = row0 + 8 * hf;
    mk[hf] = j < T ? a.madd[static_cast<size_t>(b) * T + j] * inv : -INFINITY;
    bcol[hf] = a.bias + static_cast<size_t>(h) * T * T + (j < T ? j : T - 1);
  }
  __syncthreads();
  wg::mbar_wait(bar, 0);
  const uint64_t kd = wg::sw128_desc(ks);
  const uint64_t vd = wg::sw128_desc(vs);

  float dk[32], dv[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) dk[x] = dv[x] = 0.f;
  for (int qt = 0; qt < nq; ++qt) {
    const int qb = qt * kTile;
    // s^T of the thread's keys at queries qb + 8 j + c0 + e, started as
    // gate * bias + madd (zero bias past T)
    float s[32], dp[32];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 gj = *reinterpret_cast<const float2*>(gs + qb + 8 * j + c0);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = qb + 8 * j + c0 + e;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float bias =
              i < T ? __ldg(bcol[hf] + static_cast<size_t>(i) * T) : 0.f;
          s[4 * j + 2 * hf + e] = fmaf(e ? gj.y : gj.x, bias, mk[hf]);
          dp[4 * j + 2 * hf + e] = 0.f;
        }
      }
    }
    const uint64_t qd = wg::sw128_desc(qs + qt * kTileB);
    const uint64_t dd = wg::sw128_desc(dos + qt * kTileB);
    mma_two(s, kd, qd, dp, vd, dd);
    // p^T in place of s, ds^T of dp
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 lj = *reinterpret_cast<const float2*>(ls + qb + 8 * j + c0);
      const float2 ej = *reinterpret_cast<const float2*>(es + qb + 8 * j + c0);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * j + 2 * hf + e;
          const float p =
              exp2f(fmaf(s[x], a.scale, -(e ? lj.y : lj.x)) * kLog2e);
          dp[x] = p * (dp[x] - (e ? ej.y : ej.x));
          s[x] = p;
        }
      }
    }
    uint32_t pa[16], da[16];
    pack_a(s, pa);
    pack_a(dp, da);
    wg::fence_acc(dv);
    wg::fence_acc(dk);
    wg::wgmma_fence();
    mma_rs_tile(dv, pa, dd);  // dv += p^T . do', do' read MN-major
    mma_rs_tile(dk, da, qd);  // dk += ds^T . q
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_acc(dv);
    wg::fence_acc(dk);
    wg::fence_regs(pa);
    wg::fence_regs(da);
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int j = row0 + 8 * hf;
    if (j >= T) continue;
    const size_t r = (static_cast<size_t>(bh) * T + j) * kHeadDim;
#pragma unroll
    for (int jd = 0; jd < 8; ++jd) {
      const int x = 4 * jd + 2 * hf;
      *reinterpret_cast<__nv_bfloat162*>(a.dk + r + 8 * jd + c0) =
          __floats2bfloat162_rn(dk[x] * a.scale, dk[x + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(a.dv + r + 8 * jd + c0) =
          __floats2bfloat162_rn(dv[x], dv[x + 1]);
    }
  }
}

// dbias[i] = sum over s, in order, of partial[s][i]  (i over H * T * T;
// a slice per batch group, or per batch on the mma.sync route)
__global__ void __launch_bounds__(256)
dbias_sum_kernel(const float* __restrict__ partial, float* __restrict__ dbias,
                 int slices, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < slices; ++k) s += partial[k * n + i];
  dbias[i] = s;
}

}  // namespace

// Dropout as in nrse_block_attention_fwd: mode 0 none, 1 Philox under
// (k0, k1) with probability p and keep scale `keep_scale`, 2 the explicit
// f32 [B, H, T, D] `mask`.  q, k, v, dout, out (kernel A's, after
// dropout), dq, dk, dv: contiguous bf16 [B, H, T, D], 16-byte aligned;
// gate, lse, dgate: f32 [B, H, T]; bias, dbias: f32 [H, T, T]; madd: f32
// [B, T].  Scratch: dop bf16 [B, H, T, D] and delta f32 [B, H, T] (the
// pre-pass's), and partial, f32 of slices * H * T * T elements, where
// slices = ceil(B / group) on the wgmma route (T_pad <= 256; group >= 4
// batches, or all of them; no scratch, and partial may be null, for one
// group) and B on the mma.sync route, which ignores group
// (ops/block_attention.py::attention_bwd_plan).
extern "C" int nrse_block_attention_bwd(
    const void* q, const void* k, const void* v, const void* gate,
    const void* bias, const void* madd, const void* dout, const void* out,
    const void* lse, const void* mask, unsigned k0, unsigned k1, float p,
    float keep_scale, int mode, void* dq, void* dk, void* dv, void* dgate,
    void* dbias, void* dop, void* delta, void* partial, int group, int B,
    int H, int T, int D, float scale, void* stream) {
  if (D != kHeadDim || T < 1 || T > kMaxT || B < 1 || H < 1 || mode < 0 ||
      mode > 2 || (mode == 2 && mask == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = B * H * T;
  dout_prep_kernel<<<(rows * 8 + kPrepThreads - 1) / kPrepThreads,
                     kPrepThreads, 0, s>>>(
      static_cast<const bf16*>(dout), static_cast<const bf16*>(out),
      nrse::AttnDrop{static_cast<const float*>(mask), k0, k1, p, keep_scale,
                     mode},
      static_cast<bf16*>(dop), static_cast<float*>(delta), H, T, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (T + kTile - 1) / kTile;
  const int64_t n = static_cast<int64_t>(H) * T * T;

  if (tiles * kTile <= kWgKeys) {
    if (group < kMinGroup && group < B)
      return static_cast<int>(cudaErrorInvalidValue);
    const int groups = (B + group - 1) / group;
    if (groups > 1 && partial == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    WgArgs a;
    a.gate = static_cast<const float*>(gate);
    a.bias = static_cast<const float*>(bias);
    a.madd = static_cast<const float*>(madd);
    a.lse = static_cast<const float*>(lse);
    a.delta = static_cast<const float*>(delta);
    a.dq = static_cast<bf16*>(dq);
    a.dk = static_cast<bf16*>(dk);
    a.dv = static_cast<bf16*>(dv);
    a.dgate = static_cast<float*>(dgate);
    a.dbias = static_cast<float*>(groups > 1 ? partial : dbias);
    a.B = B;
    a.H = H;
    a.T = T;
    a.group = group;
    a.scale = scale;
    namespace wg = nrse::wg;
    CUtensorMap q64, q256, do64, do256, k64, k256, v64, v256;
    const int BH = B * H;
    err = wg::head_map(&q64, q, BH, T, kTile);
    if (err == cudaSuccess) err = wg::head_map(&q256, q, BH, T, kWgKeys);
    if (err == cudaSuccess) err = wg::head_map(&do64, dop, BH, T, kTile);
    if (err == cudaSuccess) err = wg::head_map(&do256, dop, BH, T, kWgKeys);
    if (err == cudaSuccess) err = wg::head_map(&k64, k, BH, T, kTile);
    if (err == cudaSuccess) err = wg::head_map(&k256, k, BH, T, kWgKeys);
    if (err == cudaSuccess) err = wg::head_map(&v64, v, BH, T, kTile);
    if (err == cudaSuccess) err = wg::head_map(&v256, v, BH, T, kWgKeys);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(block_attention_bwd_dq_wgmma_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kDqSmem);
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(block_attention_bwd_dkdv_wgmma_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kDkvSmem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    block_attention_bwd_dq_wgmma_kernel<<<dim3(tiles, H * groups), 128,
                                          kDqSmem, s>>>(q64, do64, k256,
                                                        v256, a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    block_attention_bwd_dkdv_wgmma_kernel<<<dim3(tiles, BH), 128, kDkvSmem,
                                            s>>>(k64, v64, q256, do256, a);
    err = cudaGetLastError();
    if (err != cudaSuccess || groups == 1) return static_cast<int>(err);
    dbias_sum_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
        static_cast<const float*>(partial), static_cast<float*>(dbias),
        groups, n);
    return static_cast<int>(cudaGetLastError());
  }

  if (partial == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Args args;
  args.q = static_cast<const bf16*>(q);
  args.k = static_cast<const bf16*>(k);
  args.v = static_cast<const bf16*>(v);
  args.dout = static_cast<const bf16*>(dop);
  args.gate = static_cast<const float*>(gate);
  args.bias = static_cast<const float*>(bias);
  args.madd = static_cast<const float*>(madd);
  args.lse = static_cast<const float*>(lse);
  args.delta = static_cast<const float*>(delta);
  args.dq = static_cast<bf16*>(dq);
  args.dk = static_cast<bf16*>(dk);
  args.dv = static_cast<bf16*>(dv);
  args.dgate = static_cast<float*>(dgate);
  args.partial = static_cast<float*>(partial);
  args.H = H;
  args.T = T;
  args.scale = scale;
  err = cudaFuncSetAttribute(attention_bwd_dkdv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attention_bwd_dq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(tiles, B * H);
  attention_bwd_dkdv_kernel<<<grid, kThreads, kSmemBytes, s>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dq_kernel<<<grid, kThreads, kSmemBytes, s>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dbias_sum_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      args.partial, static_cast<float*>(dbias), B, n);
  return static_cast<int>(cudaGetLastError());
}
