// The dropout-RNG contract of the port's kernels (see ops/philox.py, its
// plain twin, which is bit for bit the same).
//
// Philox4x32-10 (Random123's philox4x32_10) keyed by the seed pair; the
// counter is (element index lo, element index hi, site, 0), with the
// element index flat over the real, unpadded [N, C] or [N, F] tensor, so
// an element's mask never depends on how a kernel tiles the tensor.  The
// first output word gives the bits; keep iff (bits >> 8) * 2^-24 >= p, and
// a kept value is scaled by 1 / (1 - p), computed in float32 on the host.
#pragma once

#include <stdint.h>

namespace nrse {

__device__ __forceinline__ uint32_t philox_bits(uint32_t k0, uint32_t k1,
                                                uint64_t index,
                                                uint32_t site) {
  uint32_t c0 = static_cast<uint32_t>(index);
  uint32_t c1 = static_cast<uint32_t>(index >> 32);
  uint32_t c2 = site;
  uint32_t c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

// The dropout multiplier of one element: `scale` if kept, else 0.
__device__ __forceinline__ float philox_keep(uint32_t k0, uint32_t k1,
                                             uint64_t index, uint32_t site,
                                             float p, float scale) {
  const uint32_t u24 = philox_bits(k0, k1, index, site) >> 8;
  return static_cast<float>(u24) * 5.9604644775390625e-08f >= p ? scale
                                                                : 0.f;
}

// How a kernel gets the keep mask of a dropout site: not at all (p = 0),
// from Philox, or from an explicit float32 {0, 1/(1-p)} mask.
struct DropSite {
  const float* mask;  // explicit mask, same layout as the tensor; or null
  uint32_t k0, k1, site;
  float p, scale;
  int mode;  // 0 none, 1 philox, 2 explicit mask

  __device__ __forceinline__ float keep(uint64_t index) const {
    if (mode == 1) return philox_keep(k0, k1, index, site, p, scale);
    if (mode == 2) return mask[index];
    return 1.f;
  }
};

}  // namespace nrse
