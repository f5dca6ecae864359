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
#include <cuda_runtime.h>
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

// V consecutive residues from / to p (V = 4: one 16-byte access, p on a
// 16-byte boundary; V = 1: one 4-byte access), for the streaming passes
// (K7, K11) that take V = 1 where an operand is not aligned.
template <int V>
__device__ __forceinline__ void ld_v(const uint32_t *p, uint32_t (&x)[V]) {
  if constexpr (V == 4) {
    const uint4 a = __ldg(reinterpret_cast<const uint4 *>(p));
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  } else {
    x[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void st_v(uint32_t *p, const uint32_t (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint4 *>(p) = make_uint4(x[0], x[1], x[2], x[3]);
  } else {
    p[0] = x[0];
  }
}

// Sum of products of residues below 2^31 (each below 2^62): a 64-bit lo
// word and a 32-bit carry count hi, value hi * 2^64 + lo.  Products are
// first summed four at a time into a 64-bit partial (4 * 2^62 = 2^64: no
// overflow; one mad.wide.u32 each), and each partial is folded in with
// one 64-bit add and a carry: exact for up to 2^32 partials.
struct acc96 {
  uint64_t lo;
  uint32_t hi;
};

__device__ __forceinline__ uint64_t mad_wide(uint32_t a, uint32_t b,
                                             uint64_t c) {
  return (uint64_t)a * b + c;
}

__device__ __forceinline__ void acc_fold(acc96 &s, uint64_t t) {
  s.lo += t;
  s.hi += (s.lo < t);
}

// (hi * 2^64 + lo) * R^{-1} mod q without a 64-bit division:
//   = hi * R + lo_hi + lo_lo * R^{-1}
//   = mont(hi, R^2) + mont(lo_hi, R) + mont(lo_lo, 1)  (mod q),
// with r1 = R mod q and r2 = R^2 mod q = 2^64 mod q; each Montgomery
// product takes a factor below 2^32 and one below q, as mont_mul needs.
__device__ __forceinline__ uint32_t acc_redc(const acc96 &s, uint32_t q,
                                             uint32_t qneg, uint32_t r1,
                                             uint32_t r2) {
  const uint32_t a = mont_mul(s.hi, r2, q, qneg);
  const uint32_t b = mont_mul((uint32_t)(s.lo >> 32), r1, q, qneg);
  const uint32_t c = mont_mul((uint32_t)s.lo, 1u, q, qneg);
  return mod_add(mod_add(a, b, q), c, q);
}
