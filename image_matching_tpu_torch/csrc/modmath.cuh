// Device-side RNS residue arithmetic shared by the kernels.
//
// Replaces image_matching_tpu/ops/modmath.py (mul32_wide, mont_mul,
// shoup_mul, mod_add, mod_sub): the TPU assembles 64-bit products from
// 16-bit halves because it has no 64-bit multiply; Hopper multiplies
// 32x32->64 natively (IMAD.WIDE) and has __umulhi, so each helper is a
// few instructions.  Every residue is uint32 with q < 2^31, Montgomery
// R = 2^32, and every result is fully reduced, so the values are
// bit-identical to the JAX package's.
#pragma once
#include <stdint.h>

// a * b * R^{-1} mod q, for a < 2^32 and b < q (so a*b < R*q).
// qneg = -q^{-1} mod 2^32.  t + m*q < 2^33 * q < 2^64: no overflow.
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b,
                                             uint32_t q, uint32_t qneg) {
  uint64_t t = (uint64_t)a * b;
  uint32_t m = (uint32_t)t * qneg;
  uint32_t r = (uint32_t)((t + (uint64_t)m * q) >> 32);
  return r >= q ? r - q : r;
}

// a * w mod q with the Shoup companion wsh = floor(w * 2^32 / q), a < 2^32.
__device__ __forceinline__ uint32_t shoup_mul(uint32_t a, uint32_t w,
                                              uint32_t wsh, uint32_t q) {
  uint32_t hi = __umulhi(a, wsh);
  uint32_t r = a * w - hi * q;  // wraps mod 2^32; lies in [0, 2q)
  return r >= q ? r - q : r;
}

__device__ __forceinline__ uint32_t mod_add(uint32_t a, uint32_t b, uint32_t q) {
  uint32_t s = a + b;
  return s >= q ? s - q : s;
}

__device__ __forceinline__ uint32_t mod_sub(uint32_t a, uint32_t b, uint32_t q) {
  return a >= b ? a - b : a + (q - b);
}

// 128-bit accumulator (hi:lo) for sums of up to 2^66 products < 2^62.
struct acc128 {
  uint64_t lo, hi;
};

__device__ __forceinline__ void acc_add(acc128 &s, uint64_t p) {
  s.lo += p;
  s.hi += (s.lo < p);
}

// (hi * 2^64 + lo) mod q.
__device__ __forceinline__ uint32_t acc_mod(const acc128 &s, uint32_t q) {
  uint64_t q64 = q;
  uint64_t r64 = (0xFFFFFFFFFFFFFFFFull % q64 + 1) % q64;  // 2^64 mod q
  return (uint32_t)(((s.hi % q64) * r64 + s.lo % q64) % q64);
}
