// Fused AdamW + BYOL-EMA update (K4), in place over flat buffers.
//
// Replaces: nrse_tpu/ops/fused_optimizer.py::_adamw_kernel and
// ::_adamw_ema_kernel (one Pallas pass per parameter leaf).  Per element,
// with the scalar vector sc = [clip_scale, lr, b1, b2, 1/bc1, 1/bc2, wd,
// eps, ema] (fused_optimizer.py:288-298, read from device memory so the
// clip scale never syncs the host):
//
//   ghat = g * clip_scale
//   mu'  = b1 * mu + (1 - b1) * ghat
//   nu'  = b2 * nu + (1 - b2) * ghat * ghat
//   p'   = p - lr * ((mu' * 1/bc1) / (sqrt(nu' * 1/bc2) + eps) + wd * p)
//   pt'  = ema * pt + (1 - ema) * p'          for the first n_ema elements
//
// p, mu, nu and pt are updated in place (the JAX kernel aliases its inputs
// to its outputs the same way).  The port keeps one flat f32 buffer each
// for the online parameters (encoder, projector, predictor, in that
// order), their gradients, mu and nu, and one for the target (encoder,
// projector), so the EMA covers a prefix and one launch covers every leaf.
// Every operation is an explicitly rounded intrinsic (no FMA contraction),
// so the result is what the same sequence of PyTorch elementwise ops
// gives, and the EMA can be checked exactly.
//
// What bounds it on the H100: memory.  Nine f32 streams (g, p, mu, nu, pt
// in; p, mu, nu, pt out) over ~330 M parameters are ~12 GB, ~3.5 ms at
// 3.35 TB/s; the arithmetic is ~20 operations an element.  Design: 4
// elements a thread with 16-byte loads and stores, a scalar path for the
// ragged end and for the group that straddles n_ema.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Scalars {
  float clip, lr, b1, b2, ibc1, ibc2, wd, eps, ema;
  float omb1, omb2, omema;  // 1 - b1, 1 - b2, 1 - ema
};

__device__ __forceinline__ void update(const Scalars& s, float g, float& p,
                                       float& mu, float& nu) {
  const float ghat = __fmul_rn(g, s.clip);
  mu = __fadd_rn(__fmul_rn(s.b1, mu), __fmul_rn(s.omb1, ghat));
  nu = __fadd_rn(__fmul_rn(s.b2, nu),
                 __fmul_rn(__fmul_rn(s.omb2, ghat), ghat));
  const float upd = __fadd_rn(
      __fdiv_rn(__fmul_rn(mu, s.ibc1),
                __fadd_rn(__fsqrt_rn(__fmul_rn(nu, s.ibc2)), s.eps)),
      __fmul_rn(s.wd, p));
  p = __fsub_rn(p, __fmul_rn(s.lr, upd));
}

__device__ __forceinline__ float ema(const Scalars& s, float pt, float p) {
  return __fadd_rn(__fmul_rn(s.ema, pt), __fmul_rn(s.omema, p));
}

__global__ void __launch_bounds__(kThreads)
adamw_ema_kernel(float* __restrict__ p, const float* __restrict__ g,
                 float* __restrict__ mu, float* __restrict__ nu,
                 float* __restrict__ pt, const float* __restrict__ sc,
                 int64_t n, int64_t n_ema) {
  Scalars s;
  s.clip = sc[0]; s.lr = sc[1]; s.b1 = sc[2]; s.b2 = sc[3];
  s.ibc1 = sc[4]; s.ibc2 = sc[5]; s.wd = sc[6]; s.eps = sc[7];
  s.ema = sc[8];
  s.omb1 = __fsub_rn(1.f, s.b1);
  s.omb2 = __fsub_rn(1.f, s.b2);
  s.omema = __fsub_rn(1.f, s.ema);

  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * 4;
  if (base >= n) return;
  if (base + 4 <= n) {
    float4 gv = *reinterpret_cast<const float4*>(g + base);
    float4 pv = *reinterpret_cast<float4*>(p + base);
    float4 mv = *reinterpret_cast<float4*>(mu + base);
    float4 nv = *reinterpret_cast<float4*>(nu + base);
    update(s, gv.x, pv.x, mv.x, nv.x);
    update(s, gv.y, pv.y, mv.y, nv.y);
    update(s, gv.z, pv.z, mv.z, nv.z);
    update(s, gv.w, pv.w, mv.w, nv.w);
    *reinterpret_cast<float4*>(p + base) = pv;
    *reinterpret_cast<float4*>(mu + base) = mv;
    *reinterpret_cast<float4*>(nu + base) = nv;
    if (base + 4 <= n_ema) {
      float4 tv = *reinterpret_cast<float4*>(pt + base);
      tv.x = ema(s, tv.x, pv.x);
      tv.y = ema(s, tv.y, pv.y);
      tv.z = ema(s, tv.z, pv.z);
      tv.w = ema(s, tv.w, pv.w);
      *reinterpret_cast<float4*>(pt + base) = tv;
    } else if (base < n_ema) {
      const float pn[4] = {pv.x, pv.y, pv.z, pv.w};
      for (int e = 0; base + e < n_ema; ++e)
        pt[base + e] = ema(s, pt[base + e], pn[e]);
    }
    return;
  }
  for (int64_t i = base; i < n; ++i) {
    float pi = p[i], mi = mu[i], ni = nu[i];
    update(s, g[i], pi, mi, ni);
    p[i] = pi;
    mu[i] = mi;
    nu[i] = ni;
    if (i < n_ema) pt[i] = ema(s, pt[i], pi);
  }
}

}  // namespace

// p, g, mu, nu: n f32 each; pt: n_ema f32 (n_ema <= n, may be 0 with pt
// null); sc: 9 f32 on the device.  16-byte aligned buffers.
extern "C" int nrse_adamw_ema(void* p, const void* g, void* mu, void* nu,
                              void* pt, const void* sc, long long n,
                              long long n_ema, void* stream) {
  if (n < 1 || n_ema < 0 || n_ema > n)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t threads = (n + 3) / 4;
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  adamw_ema_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<float*>(mu), static_cast<float*>(nu),
      static_cast<float*>(pt), static_cast<const float*>(sc), n, n_ema);
  return static_cast<int>(cudaGetLastError());
}
