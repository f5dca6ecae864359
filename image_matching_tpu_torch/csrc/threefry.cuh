// Threefry-2x32-20 and the uniform residue it draws, shared by K5
// (prng.cu) and K6 (seeded_encrypt.cu).
//
// Bit-exact with image_matching_tpu/ops/prng.py threefry2x32 (:32) and
// uniform_residues (:51), and with the host enroller's tf2x32
// (native/imtpu_native.cpp:232): key = (seed, group), counter =
// (idx, 0) with idx = (b * l + limb) * N + k taken mod 2^32 over the
// requested limb count l, one 64-bit draw (hi, lo) per residue.
#pragma once
#include <stdint.h>

#include "modmath.cuh"

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t x0, uint32_t x1,
                                             uint32_t &y0, uint32_t &y1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  const uint32_t ks[3] = {k1, k2, k0};
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    // rotations 13 15 26 6 on even rounds of four, 17 29 16 24 on odd
    const bool odd = i & 1;
    x0 += x1; x1 = rotl32(x1, odd ? 17 : 13); x1 ^= x0;
    x0 += x1; x1 = rotl32(x1, odd ? 29 : 15); x1 ^= x0;
    x0 += x1; x1 = rotl32(x1, odd ? 16 : 26); x1 ^= x0;
    x0 += x1; x1 = rotl32(x1, odd ? 24 : 6);  x1 ^= x0;
    x0 += ks[i % 3];
    x1 += ks[(i + 1) % 3] + (uint32_t)(i + 1);
  }
  y0 = x0;
  y1 = x1;
}

// (hi * 2^32 + lo) mod q as the JAX code reduces it:
// mod_add(mont_mul(hi, R^2), mont_mul(lo, R)).  A 64-bit % would be a long
// software division on the GPU; this is two Montgomery products.
__device__ __forceinline__ uint32_t uniform_residue(uint32_t seed,
                                                   uint32_t group,
                                                   uint32_t idx, uint32_t q,
                                                   uint32_t qneg, uint32_t r1,
                                                   uint32_t r2) {
  uint32_t hi, lo;
  threefry2x32(seed, group, idx, 0u, hi, lo);
  return mod_add(mont_mul(hi, r2, q, qneg), mont_mul(lo, r1, q, qneg), q);
}
