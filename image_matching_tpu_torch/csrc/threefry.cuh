// Threefry-2x32-20 and the uniform residue it draws, shared by K5
// (prng.cu), K6 (seeded_encrypt.cu, with the key schedule computed once
// per launch) and the seeded contraction (ct_dot.cu, once per thread).
//
// Bit-exact with image_matching_tpu/ops/prng.py threefry2x32 (:32) and
// uniform_residues (:51), and with the host enroller's tf2x32
// (native/imtpu_native.cpp:232): key = (seed, group), counter =
// (idx, 0) with idx = (b * l + limb) * N + k taken mod 2^32 over the
// requested limb count l, one 64-bit draw (hi, lo) per residue.
#pragma once
#include <stdint.h>

#include "modmath.cuh"

__host__ __device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
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

// The key schedule of threefry2x32 for one key (k0, k1), computed once for
// many counters (idx, 0): the first round's key-only terms and the five
// key injections.  Also callable on the host, to pass a launch its key by
// value (K6's c0 pass).
struct ThreefryKey {
  uint32_t k01;                // k0 + k1: x0 after the first add, less idx
  uint32_t rk1;                // rotl(k1, 13): x1 after the first rotation
  uint32_t inj0[5], inj1[5];  // ks[i % 3] and ks[(i + 1) % 3] + i + 1
};

__host__ __device__ __forceinline__ ThreefryKey threefry_key(uint32_t k0, uint32_t k1) {
  const uint32_t ks[3] = {k1, k0 ^ k1 ^ 0x1BD11BDAu, k0};
  ThreefryKey key;
  key.k01 = k0 + k1;
  key.rk1 = rotl32(k1, 13);
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    key.inj0[i] = ks[i % 3];
    key.inj1[i] = ks[(i + 1) % 3] + (uint32_t)(i + 1);
  }
  return key;
}

// threefry2x32(k0, k1, idx, 0) -> (y0, y1), the same bits: x1 starts at
// k1 whatever idx is, so the first add and rotation come from the key.
__device__ __forceinline__ void threefry2x32_keyed(const ThreefryKey &key,
                                                   uint32_t idx, uint32_t &y0,
                                                   uint32_t &y1) {
  uint32_t x0 = idx + key.k01;
  uint32_t x1 = key.rk1 ^ x0;
  x0 += x1; x1 = rotl32(x1, 15); x1 ^= x0;
  x0 += x1; x1 = rotl32(x1, 26); x1 ^= x0;
  x0 += x1; x1 = rotl32(x1, 6);  x1 ^= x0;
  x0 += key.inj0[0];
  x1 += key.inj1[0];
#pragma unroll
  for (int i = 1; i < 5; ++i) {
    const bool odd = i & 1;
    x0 += x1; x1 = rotl32(x1, odd ? 17 : 13); x1 ^= x0;
    x0 += x1; x1 = rotl32(x1, odd ? 29 : 15); x1 ^= x0;
    x0 += x1; x1 = rotl32(x1, odd ? 16 : 26); x1 ^= x0;
    x0 += x1; x1 = rotl32(x1, odd ? 24 : 6);  x1 ^= x0;
    x0 += key.inj0[i];
    x1 += key.inj1[i];
  }
  y0 = x0;
  y1 = x1;
}

// uniform_residue for a precomputed key: the same residue.
__device__ __forceinline__ uint32_t uniform_residue_keyed(
    const ThreefryKey &key, uint32_t idx, uint32_t q, uint32_t qneg,
    uint32_t r1, uint32_t r2) {
  uint32_t hi, lo;
  threefry2x32_keyed(key, idx, hi, lo);
  return mod_add(mont_mul(hi, r2, q, qneg), mont_mul(lo, r1, q, qneg), q);
}
