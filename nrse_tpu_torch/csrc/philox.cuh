// The dropout-RNG contract of the port's kernels (see ops/philox.py, its
// plain twin, which is bit for bit the same).
//
// Philox4x32-10 (Random123's philox4x32_10) keyed by the seed pair.  One
// draw serves four consecutive elements: element i of a site takes its
// bits from output word i mod 4 of the draw at the counter
// (g lo, g hi, site, 0), g = floor(i / 4), with the element index i flat
// over the real, unpadded [N, C] or [N, F] tensor, so an element's mask
// never depends on how a kernel tiles the tensor.  Keep iff
// (bits >> 8) * 2^-24 >= p, and a kept value is scaled by 1 / (1 - p),
// computed in float32 on the host.
//
// Two forms: philox_keep4 gives the four keep multipliers of group g
// (K1, K2's dh2 pass, K3's pre-pass), philox_keep_bits4 their four keep
// bits (the wgmma epilogues' keep bits, drawn by a spare warp or by one
// lane of the pair
// that holds the group's two halves in the accumulator layout: K2's dgd
// product, kernel B's two products, kernel A's output): one draw per four
// elements, nothing thrown away.
//
// A shard of a tensor split by columns (tensor parallelism) draws the
// slice of the whole tensor's mask through its Window: its element
// (row, col) takes the index row * wg + c0 + col of the whole [N, wg]
// tensor whose columns [c0, c0 + wl) it holds.
#pragma once

#include <stdint.h>

namespace nrse {

struct Philox4 {
  uint32_t w[4];
};

__device__ __forceinline__ Philox4 philox4(uint32_t k0, uint32_t k1,
                                           uint64_t group, uint32_t site) {
  uint32_t c0 = static_cast<uint32_t>(group);
  uint32_t c1 = static_cast<uint32_t>(group >> 32);
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
  return Philox4{{c0, c1, c2, c3}};
}

// A shard's place in the whole tensor's flat index.  The default (wg = 0)
// and a shard of full width (wl == wg, c0 = 0) keep their own index.  wl,
// wg and c0 are multiples of 4, so a group of four elements of the shard
// is one group of the whole.
struct Window {
  uint32_t wl = 0, wg = 0, c0 = 0;

  // The index of element (row, col) of a shard whose rows are ld long.
  __device__ __forceinline__ uint64_t index(uint64_t row, uint32_t col,
                                            uint32_t ld) const {
    return wg ? row * wg + c0 + col : row * ld + col;
  }

  // The group of the whole that the shard's flat group g is.
  __device__ __forceinline__ uint64_t group(uint64_t g) const {
    if (wg == wl) return g;
    const uint64_t per = wl >> 2;
    const uint64_t row = g / per;
    return row * (wg >> 2) + (c0 >> 2) + (g - row * per);
  }
};

// Whether one output word keeps its element.
__device__ __forceinline__ bool philox_kept(uint32_t bits, float p) {
  return static_cast<float>(bits >> 8) * 5.9604644775390625e-08f >= p;
}

// The four keep bits of group g: bit e for element 4 g + e.
__device__ __forceinline__ uint32_t philox_keep_bits4(uint32_t k0, uint32_t k1,
                                                      uint64_t group,
                                                      uint32_t site, float p) {
  const Philox4 r = philox4(k0, k1, group, site);
  return static_cast<uint32_t>(philox_kept(r.w[0], p)) |
         static_cast<uint32_t>(philox_kept(r.w[1], p)) << 1 |
         static_cast<uint32_t>(philox_kept(r.w[2], p)) << 2 |
         static_cast<uint32_t>(philox_kept(r.w[3], p)) << 3;
}

// The dropout multipliers of elements 4 g .. 4 g + 3: `scale` if kept,
// else 0.
__device__ __forceinline__ float4 philox_keep4(uint32_t k0, uint32_t k1,
                                               uint64_t group, uint32_t site,
                                               float p, float scale) {
  const Philox4 r = philox4(k0, k1, group, site);
  return make_float4(philox_kept(r.w[0], p) ? scale : 0.f,
                     philox_kept(r.w[1], p) ? scale : 0.f,
                     philox_kept(r.w[2], p) ? scale : 0.f,
                     philox_kept(r.w[3], p) ? scale : 0.f);
}

// Whether a kernel can read its seed pair at `seed`: not null, 8-byte
// aligned (one 64-bit load).
inline bool seed_ok(const void* seed) {
  return seed != nullptr && reinterpret_cast<uintptr_t>(seed) % 8 == 0;
}

// How a kernel gets the keep mask of a dropout site: not at all (p = 0),
// from Philox, or from an explicit float32 {0, 1/(1-p)} mask.  The Philox
// key is read from device memory, the seed pair (k0, k1) at `key`, when the
// kernel runs: a launch captured into a CUDA graph draws the pair the
// table holds at each replay.
struct DropSite {
  const float* mask;  // explicit mask, same layout as the tensor; or null
  const uint2* key;   // mode 1: the seed pair in device memory
  uint32_t site;
  float p, scale;
  int mode;  // 0 none, 1 philox, 2 explicit mask
  Window win;  // mode 1: the shard's window (default: a whole tensor)

  // The multipliers of elements 4 g .. 4 g + 3 (one draw in mode 1; the
  // explicit mask is read as one float4, so it must be 16-byte aligned).
  __device__ __forceinline__ float4 keep4(uint64_t group) const {
    if (mode == 1) {
      const uint2 k = __ldg(key);
      return philox_keep4(k.x, k.y, win.group(group), site, p, scale);
    }
    if (mode == 2) return reinterpret_cast<const float4*>(mask)[group];
    return make_float4(1.f, 1.f, 1.f, 1.f);
  }
};

}  // namespace nrse
