// Fast base conversion, shared by K3 (basis_convert.cu) and K8
// (decompose.cu): for the g source residues x_i of one coefficient,
//   y_i   = x_i * t_i mod q_i                     (x_i Montgomery, y_i standard)
//   v     = rint(sum_i float32(y_i) * inv_q_i)    (float32, index order)
//   out_p = (sum_i y_i * Qhat_i - v * Q) * R mod p  (Montgomery, canonical)
// for every target prime p.
//
// Exactness: v must equal the JAX package's float32 value bit for bit, or
// rare coefficients move by one multiple of Q.  XLA on the CPU sums the
// axis in index order, each product and sum rounded to float32.  So the
// sum here runs sequentially with __fmul_rn / __fadd_rn (which nvcc never
// contracts into an FMA) and rounds half to even with rintf, as
// jnp.round does.  out_p is the same canonical residue as the JAX code's
// g separately reduced Montgomery products and modular adds: every step
// below is exact integer arithmetic on its representative.
//
// Per target, one 64-bit sum and two Montgomery steps replace g reduced
// products and g + 1 modular adds.  With c_i = Qhat_i R^3 mod p and
// c_v = -Q R^3 mod p (all below p < 2^31, y_i < q_i < 2^31, v <= g <= 8):
//   s0 = v * c_v + sum_{i < min(g, 4)} y_i c_i  <= 4 (2^31-1)^2 + 8 (2^31-1)
//      = 2^64 - 4, and s1 = sum_{4 <= i < g} y_i c_i < 2^64 (mad.wide.u32);
//   a  = redc_step(s0) + redc_step(s1) == (s0 + s1) R^-1 (mod p), each
//        step (s + m p) / 2^32 < 2^32 + p, so a < 3 * 2^32;
//   r  = (a + m p) / 2^32 == (s0 + s1) R^-2 (mod p), r < p + 3: one
//        conditional subtraction leaves the canonical residue.
#pragma once
#include <stdint.h>

#include "modmath.cuh"
#include "passgrid.cuh"

#define FBC_MAXG 8
#define FBC_MAXT 32
#define FBC_TW 12  // words per target: c_0..c_7 (zero past g), c_v, p, qneg_p, 0
// a conversion's packed constants: t target blocks, then q_i, qneg_i, t_i
// and the float32 bits of 1 / q_i (g words each)
#define FBC_WORDS(g, t) (FBC_TW * (t) + 4 * (g))
#define FBC_SMEM (FBC_TW * FBC_MAXT + 4 * FBC_MAXG)
#define FBC_THREADS 128
#define FBC_V 4  // coefficients a thread: one 16-byte load or store per row

// (s + m p) / 2^32 with m = -s p^-1 mod 2^32, for any s < 2^64, without
// the 65-bit sum: the low words of s and m p add to 0 or 2^32.
__device__ __forceinline__ uint64_t redc_step(uint64_t s, uint32_t p,
                                              uint32_t qneg) {
  const uint32_t lo = (uint32_t)s;
  const uint32_t m = lo * qneg;
  return (s >> 32) + __umulhi(m, p) + (lo != 0u);
}

// p: 16-byte aligned (the wrappers check the rows' alignment)
__device__ __forceinline__ void fbc_ld(const uint32_t *p, uint32_t (&r)[FBC_V]) {
  const uint4 a = *reinterpret_cast<const uint4 *>(p);
  r[0] = a.x, r[1] = a.y, r[2] = a.z, r[3] = a.w;
}

__device__ __forceinline__ void fbc_st(uint32_t *p, const uint32_t (&r)[FBC_V]) {
  *reinterpret_cast<uint4 *>(p) = make_uint4(r[0], r[1], r[2], r[3]);
}

// y holds the source residues x of FBC_V coefficients on entry and y = x * t
// on return (after adding pre[i] when pre is not NULL: the centred
// mod-down's +P/2); v their rounded float32 sums.  src: the packed source
// words (q, qneg, t, inv_q; G each) in shared memory.
template <int G>
__device__ __forceinline__ void fbc_prepare(const uint32_t *src,
                                            const uint32_t *pre,
                                            uint32_t (&y)[G][FBC_V],
                                            uint32_t (&v)[FBC_V]) {
  float acc[FBC_V];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const uint32_t q = src[i], qn = src[G + i], t = src[2 * G + i];
    const float inv = __uint_as_float(src[3 * G + i]);
#pragma unroll
    for (int k = 0; k < FBC_V; ++k) {
      uint32_t x = y[i][k];
      if (pre) x = mod_add(x, pre[i], q);
      y[i][k] = mont_mul(x, t, q, qn);
      const float f = __fmul_rn(__uint2float_rn(y[i][k]), inv);
      acc[k] = i == 0 ? f : __fadd_rn(acc[k], f);
    }
  }
#pragma unroll
  for (int k = 0; k < FBC_V; ++k) v[k] = (uint32_t)rintf(acc[k]);
}

// The FBC_V outputs of one target, its FBC_TW words at tb (16-byte aligned,
// shared memory).
template <int G>
__device__ __forceinline__ void fbc_target(const uint32_t (&y)[G][FBC_V],
                                           const uint32_t (&v)[FBC_V],
                                           const uint32_t *tb,
                                           uint32_t (&r)[FBC_V]) {
  const uint4 lo4 = *reinterpret_cast<const uint4 *>(tb);
  const uint4 hi4 = G > 4 ? *reinterpret_cast<const uint4 *>(tb + 4)
                          : make_uint4(0u, 0u, 0u, 0u);
  const uint4 tail = *reinterpret_cast<const uint4 *>(tb + 8);
  const uint32_t c[8] = {lo4.x, lo4.y, lo4.z, lo4.w,
                         hi4.x, hi4.y, hi4.z, hi4.w};
  const uint32_t cv = tail.x, p = tail.y, qn = tail.z;
#pragma unroll
  for (int k = 0; k < FBC_V; ++k) {
    uint64_t s0 = (uint64_t)v[k] * cv;
#pragma unroll
    for (int i = 0; i < (G < 4 ? G : 4); ++i) s0 = mad_wide(y[i][k], c[i], s0);
    uint64_t a = redc_step(s0, p, qn);
    if constexpr (G > 4) {
      uint64_t s1 = 0;
#pragma unroll
      for (int i = 4; i < G; ++i) s1 = mad_wide(y[i][k], c[i], s1);
      a += redc_step(s1, p, qn);
    }
    const uint32_t m = (uint32_t)a * qn;
    const uint32_t o = (uint32_t)((a + (uint64_t)m * p) >> 32);
    r[k] = o >= p ? o - p : o;
  }
}

// Copy a conversion's packed constants into shared memory (cs, FBC_SMEM
// words, 16-byte aligned).
__device__ __forceinline__ void fbc_stage(uint32_t *cs, const uint32_t *consts,
                                          int g, int t) {
  const int nw = FBC_WORDS(g, t);
  for (int i = threadIdx.x; i < nw; i += blockDim.x) cs[i] = consts[i];
}

// Targets per block and target chunks of a launch of `blocks` blocks over
// t targets: split the targets only when the launch would leave SMs idle
// (fewer than PASS_MIN_BLOCKS blocks).
static inline void fbc_split(long long blocks, int t, int *per, int *chunks) {
  long long s = (PASS_MIN_BLOCKS + blocks - 1) / blocks;
  if (s < 1) s = 1;
  if (s > t) s = t;
  *per = (int)((t + s - 1) / s);
  *chunks = (t + *per - 1) / *per;
}
