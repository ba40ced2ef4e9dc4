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
// the TPU kernel does.  The bias is added in f32.
//
// What bounds it on the H100: at the training shape (B=36, H=16, T=249,
// D=64) the two T x T x D products are ~9 GFLOP a layer, ~9 us at the
// tensor cores' rate; q, k, v and out are ~73 MB a layer (~22 us of HBM
// time) and the f32 bias [H, T, T] 4 MB, read once per query tile from L2.
// What is left is the elementwise softmax work between the products, and
// latency.
//
// Two routes, by T_pad = 64 * ceil(T / 64):
//
// T_pad <= 256 (every main path: 5 s clips are 249 frames), one pass on
// wgmma: one block of one warpgroup (128 threads) per (b, h, 64-query
// tile).  Thread 0 TMA-loads the query tile and the head's whole K and V
// (boxes of 256 rows under the 128-byte swizzle: 8 + 32 + 32 KB; the
// tensor maps are 3-D, [B*H][T][64], so rows past T arrive as zeros) onto
// one mbarrier.  Meanwhile every thread loads its accumulator's share of
// gate * bias + madd from device memory (L2: the [H, T, T] bias is 4 MB),
// in the units of q . k (divided by the scale, a power of two at D = 64,
// so exact), -inf past T: the accumulator starts as the bias and S = Q K^T
// is one chain of four wgmma.m64n256k16 onto it (128 f32 a thread).  The
// true row max comes from registers (a quad shuffle), p = exp(s - m) is
// formed in place, and bf16(p) is the register A operand of sixteen
// wgmma.m64n64k16 with V read MN-major from the same swizzled tile (o is 32
// f32 a thread).  Nothing is computed twice and no running rescale is
// needed.  Two blocks share an SM (74 KB of shared memory each, and up to
// 255 registers a thread: three blocks, at ptxas's 168-register cap,
// spilled and ran 98-100 us on the card against two blocks' 84-85 us at
// B = 32, T = 249), so one block's loads overlap another's products.  The
// output dropout draws once per four elements (AttnDrop::keep_bits_rows:
// the two lanes holding a group's halves share a draw through one
// shuffle).
//
// 256 < T_pad <= 384 (257-384 frames: no main path sends them; kept
// simple): two passes over 64-key tiles on mma.sync from padded shared
// memory (attention_common.cuh), a block of 4 warps per (b, h, 64-query
// tile), a warp owning 16 queries: the first pass takes the row max m, the
// second forms p = exp(s - m), its sum and bf16(p) . V, so q . k^T is
// computed twice; its output dropout draws as the one-pass route's does.
// Both routes are held to the same plain version within the same tolerance
// (out 1e-2, lse 1e-3 of max|ref|).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "wgmma_common.cuh"

namespace {

using namespace nrse::attn;

constexpr int kMaxT = 384;    // MAX_T_PAD of the TPU kernel
constexpr int kWgKeys = 256;  // the one-pass route's keys: T_pad <= 256

struct Args {
  const bf16 *q, *k, *v;
  const float *gate, *bias, *madd;  // [B, H, T], [H, T, T], [B, T]
  bf16* out;
  float* lse;                       // [B, H, T]
  nrse::AttnDrop drop;
  int H, T;
  float scale;
};

// out = keep * o / l (bf16) and lse = m + log l for a thread's rows
// row0 and row0 + 8 (those < T) of (b, h), o in the accumulator layout of
// 16 x 64 (o[4 jd + 2 hf + e] at row row0 + 8 hf, column 8 jd + 2 (lane %
// 4) + e), m the true row maxima.  Every lane of the warp must call it.
__device__ __forceinline__ void store_rows(const float (&o)[32],
                                           const float (&m)[2],
                                           const float (&l)[2], int row0,
                                           int b, int h, const Args& args) {
  const int lane = threadIdx.x & 31;
  const int T = args.T, H = args.H;
  uint2 bits = make_uint2(0u, 0u);
  if (args.drop.mode == 1) {
    bits = args.drop.keep_bits_rows(b, h, row0, H, T, lane);
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int i = row0 + 8 * hf;
    if (i >= T) continue;
    const size_t row = (static_cast<size_t>(b) * H + h) * T + i;
    if (lane % 4 == 0) args.lse[row] = m[hf] + logf(l[hf]);
#pragma unroll
    for (int jd = 0; jd < kHeadDim / 8; ++jd) {
      const int d = jd * 8 + (lane % 4) * 2;
      float x0 = o[4 * jd + 2 * hf] / l[hf];
      float x1 = o[4 * jd + 2 * hf + 1] / l[hf];
      if (args.drop.mode != 0) {
        x0 *= args.drop.keep_col(bits, hf, jd, 0, lane, b, h, i, H, T);
        x1 *= args.drop.keep_col(bits, hf, jd, 1, lane, b, h, i, H, T);
      }
      *reinterpret_cast<__nv_bfloat162*>(args.out + row * kHeadDim + d) =
          __floats2bfloat162_rn(x0, x1);
    }
  }
}

// ---------------------------------------------------------------------
// The one-pass route (T_pad <= 256).

constexpr int kQBytes = kTile * kHeadDim * 2;       // 8 KB
constexpr int kKVBytes = kWgKeys * kHeadDim * 2;    // 32 KB
constexpr int kMaddOff = kQBytes + 2 * kKVBytes;    // 72 KB
constexpr int kBarOff = kMaddOff + kWgKeys * 4;
constexpr int kWgSmemBytes = 1024 /* alignment slack */ + kBarOff + 8;

// p = exp(s - m) of keys 128 kHalf .. + 127 (s[4 j + 2 hf + e], j of the
// half), its sums into l, and bf16(p) as wgmma's A fragments: pa[4 kk + a]
// is register a of 16-key step kk, a0 (row, keys 0-7 of the step), a1
// (row + 8), a2 (row, keys 8-15), a3 (row + 8).  c = scale * log2(e),
// mc = m * c.
template <int kHalf>
__device__ __forceinline__ void p_half(const float (&s)[128],
                                       uint32_t (&pa)[64], float (&l)[2],
                                       const float (&mc)[2], float c) {
#pragma unroll
  for (int jj = 0; jj < kWgKeys / 16; ++jj) {
    const int j = kHalf * (kWgKeys / 16) + jj;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float p0 = exp2f(fmaf(s[4 * j + 2 * hf], c, -mc[hf]));
      const float p1 = exp2f(fmaf(s[4 * j + 2 * hf + 1], c, -mc[hf]));
      l[hf] += p0 + p1;
      pa[4 * (j >> 1) + 2 * (j & 1) + hf] = pack_bf16(p0, p1);
    }
  }
}

// o += bf16(P) . V over the half's eight 16-key steps, issued and
// committed, not waited for.
template <int kHalf>
__device__ __forceinline__ void pv_half(float (&o)[32],
                                        const uint32_t (&pa)[64],
                                        uint64_t dv) {
  nrse::wg::fence_acc(o);
  nrse::wg::wgmma_fence();
#pragma unroll
  for (int k = 0; k < kWgKeys / 32; ++k) {
    const int kk = kHalf * (kWgKeys / 32) + k;
    const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                           pa[4 * kk + 3]};
    nrse::wg::wgmma_m64n64k16_rs(o, a, dv + 128 * kk, 1);
  }
  nrse::wg::wgmma_commit();
}

__global__ void __launch_bounds__(128, 2)
block_attention_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tmq,
                                 const __grid_constant__ CUtensorMap tmk,
                                 const __grid_constant__ CUtensorMap tmv,
                                 Args args) {
  namespace wg = nrse::wg;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;
  uint8_t* ks = smem + kQBytes;
  uint8_t* vs = ks + kKVBytes;
  float* madd = reinterpret_cast<float*>(smem + kMaddOff);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + kBarOff);

  const int T = args.T, H = args.H;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  if (tid == 0) {
    wg::mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    wg::mbar_expect_tx(bar, kQBytes + 2 * kKVBytes);
    wg::tma_load_3d(qs, &tmq, 0, q0, bh, bar);
    wg::tma_load_3d(ks, &tmk, 0, 0, bh, bar);
    wg::tma_load_3d(vs, &tmv, 0, 0, bh, bar);
  }
  // scores are kept in units of q . k: the key mask divided by the scale,
  // -inf past T
  const float inv = 1.f / args.scale;
  for (int j = tid; j < kWgKeys; j += 128) {
    madd[j] = j < T ? args.madd[static_cast<size_t>(b) * T + j] * inv
                    : -INFINITY;
  }
  __syncthreads();  // the barrier's init and the key mask

  // s starts as (gate * bias + madd) / scale in the m64n256 accumulator
  // layout: s[4 j + 2 hf + e] at row row0 + 8 hf, key 8 j + 2 (lane % 4) + e.
  // The bias is loaded straight into s (all loads in flight at once, no
  // registers beside the accumulators), then scaled and masked.
  const int row0 = q0 + (tid >> 5) * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  float s[128];
  float g[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int i = row0 + 8 * hf;
    const bool ok = i < T;
    g[hf] = ok ? args.gate[static_cast<size_t>(bh) * T + i] * inv : 0.f;
    // a row past T reads row T - 1's bias (its scores are never stored);
    // the thread's keys are c0 + (8 j + e), < T iff 8 j + e < T - c0, so
    // each load is the row pointer plus a constant
    const float* brow =
        args.bias + (static_cast<size_t>(h) * T + (ok ? i : T - 1)) * T + c0;
    const int lim = T - c0;
#pragma unroll
    for (int j = 0; j < kWgKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * j + 2 * hf + e] = 8 * j + e < lim ? __ldg(brow + 8 * j + e)
                                                : 0.f;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kWgKeys / 8; ++j) {
    const float2 mj = *reinterpret_cast<const float2*>(madd + 8 * j + c0);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      s[4 * j + 2 * hf] = fmaf(g[hf], s[4 * j + 2 * hf], mj.x);
      s[4 * j + 2 * hf + 1] = fmaf(g[hf], s[4 * j + 2 * hf + 1], mj.y);
    }
    // a few key-mask reads at a time: hoisted all together they would
    // not fit beside the 128 accumulators
    if (j % 8 == 7) asm volatile("" ::: "memory");
  }

  // S += Q . K^T: four 16-deep steps, K-major tiles
  wg::mbar_wait(bar, 0);
  const uint64_t dq = wg::sw128_desc(qs);
  const uint64_t dk = wg::sw128_desc(ks);
  wg::fence_acc(s);
  wg::wgmma_fence();
#pragma unroll
  for (int k = 0; k < kHeadDim / 16; ++k) {
    wg::wgmma_m64n256k16(s, dq + 2 * k, dk + 2 * k, 1);
  }
  wg::wgmma_commit();
  wg::wgmma_wait<0>();
  wg::fence_acc(s);

  // the true row max (4 lanes share a row), then p = exp(s - m) in place
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kWgKeys / 8; ++j) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      m[hf] = fmaxf(m[hf], fmaxf(s[4 * j + 2 * hf], s[4 * j + 2 * hf + 1]));
    }
  }
  const float c = args.scale * 1.4426950408889634f;  // scale * log2(e)
  float l[2] = {0.f, 0.f};
  float mc[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    m[hf] = fmaxf(m[hf], __shfl_xor_sync(0xffffffffu, m[hf], 1));
    m[hf] = fmaxf(m[hf], __shfl_xor_sync(0xffffffffu, m[hf], 2));
    mc[hf] = m[hf] * c;
  }
  // O = bf16(P) . V, V MN-major, in two halves of 128 keys: the first
  // half's eight 16-key steps run on the tensor cores while the second
  // half's p is formed, so that s, the fragments and o never all live at
  // once.
  uint32_t pa[kWgKeys / 4];
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  const uint64_t dv = wg::sw128_desc(vs);
  p_half<0>(s, pa, l, mc, c);
  pv_half<0>(o, pa, dv);
  p_half<1>(s, pa, l, mc, c);
  pv_half<1>(o, pa, dv);
  wg::wgmma_wait<0>();
  wg::fence_acc(o);
  // the fragments stay untouched until the products that read them are
  // done
  wg::fence_regs(pa);

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    l[hf] = fmaxf(l[hf], 1e-30f);
    m[hf] *= args.scale;
  }
  store_rows(o, m, l, row0, b, h, args);
}

// ---------------------------------------------------------------------
// The two-pass route (256 < T_pad <= 384).

// shared memory: the Q, K and V tiles, the f32 bias tile and madd of the
// key tile
constexpr size_t kSmemBytes = 3 * kTile * kLd * sizeof(bf16) +
                              kTile * kBiasLd * sizeof(float) +
                              kTile * sizeof(float);

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
  float g[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    q_l[hf] = warp * 16 + lane / 4 + hf * 8;
    g[hf] = q0 + q_l[hf] < T ? args.gate[static_cast<size_t>(bh) * T + q0 +
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

  float of[32];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    l[hf] = fmaxf(l[hf], 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) of[4 * j + e] = o[j][e];
  store_rows(of, m, l, q0 + warp * 16 + lane / 4, b, h, args);
}

}  // namespace

// Dropout: mode 0 none, 1 Philox under (k0, k1) with probability p and
// keep scale `keep_scale`, 2 the explicit f32 [B, H, T, D] `mask`.  q, k,
// v, out: contiguous bf16 [B, H, T, D], 16-byte aligned; gate, lse: f32
// [B, H, T]; bias: f32 [H, T, T]; madd: f32 [B, T].  T <= 256 after
// padding to 64 takes the one-pass wgmma route, longer T the two-pass one.
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((T + kTile - 1) / kTile, B * H);
  if (grid.x * kTile <= kWgKeys) {
    CUtensorMap mq, mk, mv;
    namespace wg = nrse::wg;
    cudaError_t err = wg::head_map(&mq, q, B * H, T, kTile);
    if (err == cudaSuccess) err = wg::head_map(&mk, k, B * H, T, kWgKeys);
    if (err == cudaSuccess) err = wg::head_map(&mv, v, B * H, T, kWgKeys);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(block_attention_fwd_wgmma_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kWgSmemBytes);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    block_attention_fwd_wgmma_kernel<<<grid, 128, kWgSmemBytes, s>>>(
        mq, mk, mv, args);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = cudaFuncSetAttribute(
      block_attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  block_attention_fwd_kernel<<<grid, kThreads, kSmemBytes, s>>>(args);
  return static_cast<int>(cudaGetLastError());
}
