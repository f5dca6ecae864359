// K6: seeded symmetric encryption of DB groups, the two passes around the
// forward NTT (K1).
//
// Replaces image_matching_tpu/ckks/context.py _encrypt_seeded_dev (:513)
// with _coeffs_from_split (:495), _small_signed_to_rns (:407) and the
// uniform_residues it calls (image_matching_tpu/ops/prng.py:51):
//   pre pass: x = (m + e) * R mod q per limb, with m = hi * 2^24 + lo - 2^47
//             (the compact coefficient transfer form) and e the small
//             signed noise;                            [B, N] -> [B, l, N]
//   K1:       x = NTT(x);
//   c0 pass:  c0 = x - mont_mul(c1, s_eval), c1 drawn in registers from
//             Threefry (threefry.cuh), so at enrollment c1 never reaches
//             device memory; c0 is written over x.
// The JAX code transforms m and e separately and adds them after; the NTT
// is linear over Z_q on canonical residues, so adding first gives the same
// c0 with half the NTT work.
//
// What bounds each pass on the H100, at a streamed group [512, 14, 2^15]:
// - pre pass: device memory.  It reads 12 bytes a coefficient (hi, lo, e:
//   201 MB) and writes 4 a residue (939 MB): 0.34 ms at 3.35 TB/s.  Its
//   integer work, two Montgomery products, an add and a select a residue,
//   is far below that.
// - c0 pass: the integer pipes.  It reads x and writes c0 (939 MB each,
//   0.56 ms) and draws 235 M Threefry residues at about 116 operations
//   each (20 rounds of add, rotate and xor, the key injections, two
//   Montgomery products): 27 G operations, 0.41 ms at the 67 T/s float32
//   rate of the "(o)" bound.  That is not its floor: Hopper issues the
//   Threefry mix (IADD3, LOP3, SHF) at a lower rate, and K5 (prng.cu),
//   which draws the same residues and only writes them, takes 1.18 ms on
//   the H100.  K5's time is the pass's real floor; the design hides the x
//   and c0 streams under the draws.
//
// Design:
// - pre: one thread takes V = 4 consecutive coefficients of one row, reads
//   hi, lo and e once (16-byte loads) and forms the signed value a = hi
//   2^24 + lo + e - 2^47 once per coefficient, in 64 bits.  It then loops
//   over the limbs with one 16-byte store each: with |a| = ah 2^32 + al,
//   |a| R mod q = mont(al, R^2) + mont(ah, R^3), negated where a < 0; two
//   products, an add and a select per residue, no `%`.  A launch of few
//   rows splits the limbs over grid z.
// - c0: the Threefry key schedule (threefry_key) is built once on the
//   host and passed by value.  A thread holds one limb's four s_eval words
//   and walks a stretch of the rows, with four independent draws in flight
//   (counters idx .. idx + 3, idx = (b * l + limb) * N + k mod 2^32: the
//   JAX uniform_residues stream and the host enroller's tf2x32,
//   native/imtpu_native.cpp:232), reading x and writing c0 in place with
//   16-byte accesses.
// - An operand that is not 16-byte aligned (or n not a multiple of four)
//   takes V = 1 in the same kernel.
#include <cuda_runtime.h>
#include <stdint.h>

#include "modmath.cuh"
#include "passgrid.cuh"
#include "threefry.cuh"

// V consecutive residues through the coherent path: for an operand that
// the same kernel overwrites (the c0 pass writes c0 over x), where
// ld_v's read-only path is not allowed.
template <int V>
__device__ __forceinline__ void ld_rw(const uint32_t *p, uint32_t (&x)[V]) {
  if constexpr (V == 4) {
    const uint4 a = *reinterpret_cast<const uint4 *>(p);
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  } else {
    x[0] = p[0];
  }
}

// One thread: coefficients k..k+V-1 of rows b, limbs [i0, i1).
template <int V>
__global__ void __launch_bounds__(PASS_THREADS)
    seeded_pre_kernel(uint32_t *__restrict__ out, const uint32_t *__restrict__ hi,
                      const uint32_t *__restrict__ lo, const uint32_t *__restrict__ e,
                      const uint32_t *__restrict__ qs, const uint32_t *__restrict__ qneg,
                      const uint32_t *__restrict__ r2, const uint32_t *__restrict__ r3,
                      int B, int l, int n, int per) {
  const int k = (blockIdx.x * PASS_THREADS + threadIdx.x) * V;
  if (k >= n) return;
  const int i0 = blockIdx.z * per;
  const int i1 = min(l, i0 + per);
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const size_t src = (size_t)b * n + k;
    uint32_t h[V], w[V], ev[V], ah[V], al[V];
    bool neg[V];
    ld_v<V>(hi + src, h);
    ld_v<V>(lo + src, w);
    ld_v<V>(e + src, ev);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int64_t a =
          ((int64_t)h[v] << 24) + (int64_t)w[v] + (int32_t)ev[v] - ((int64_t)1 << 47);
      neg[v] = a < 0;
      const uint64_t u = neg[v] ? (uint64_t)(-a) : (uint64_t)a;  // < 2^57
      ah[v] = (uint32_t)(u >> 32);
      al[v] = (uint32_t)u;
    }
    uint32_t *o = out + (size_t)b * l * n + k;
#pragma unroll 2
    for (int i = i0; i < i1; ++i) {
      const uint32_t q = __ldg(qs + i), qn = __ldg(qneg + i);
      const uint32_t c2 = __ldg(r2 + i), c3 = __ldg(r3 + i);
      uint32_t r[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const uint32_t x = mod_add(mont_mul(al[v], c2, q, qn), mont_mul(ah[v], c3, q, qn), q);
        r[v] = neg[v] && x != 0u ? q - x : x;
      }
      st_v<V>(o + (size_t)i * n, r);
    }
  }
}

// One thread: coefficients k..k+V-1 of limb blockIdx.y, rows [b0, b1).
template <int V>
__global__ void __launch_bounds__(PASS_THREADS)
    seeded_c0_kernel(uint32_t *c0, const uint32_t *x,  // may alias
                     const uint32_t *__restrict__ s_eval, const uint32_t *__restrict__ qs,
                     const uint32_t *__restrict__ qneg, const uint32_t *__restrict__ r1,
                     const uint32_t *__restrict__ r2, const ThreefryKey key, int B, int l,
                     int n, int stretch) {
  const int k = (blockIdx.x * PASS_THREADS + threadIdx.x) * V;
  if (k >= n) return;
  const int i = blockIdx.y;
  const int b0 = blockIdx.z * stretch;
  const int b1 = min(B, b0 + stretch);
  const uint32_t q = __ldg(qs + i), qn = __ldg(qneg + i);
  const uint32_t c1r = __ldg(r1 + i), c2r = __ldg(r2 + i);
  uint32_t s[V];
  ld_v<V>(s_eval + (size_t)i * n + k, s);
  // the counter of (b, i, k) mod 2^32, stepped by l * n a row
  const uint32_t step = (uint32_t)l * (uint32_t)n;
  uint32_t idx = ((uint32_t)b0 * (uint32_t)l + (uint32_t)i) * (uint32_t)n + (uint32_t)k;
  for (int b = b0; b < b1; ++b, idx += step) {
    const size_t off = ((size_t)b * l + i) * n + k;
    uint32_t xv[V], r[V];
    ld_rw<V>(x + off, xv);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const uint32_t c1 = uniform_residue_keyed(key, idx + (uint32_t)v, q, qn, c1r, c2r);
      r[v] = mod_sub(xv[v], mont_mul(c1, s[v], q, qn), q);
    }
    st_v<V>(c0 + off, r);
  }
}

// hi, lo: [B, n] uint32 (lo < 2^24); e: [B, n] int32 with |e| < q;
// out: [B, l, n]; per-limb constants indexed 0..l-1: r2 = R^2 mod q,
// r3 = R^3 mod q.
extern "C" int imtpu_seeded_pre(void *out, const void *hi, const void *lo,
                                const void *e, const void *qs,
                                const void *qneg, const void *r2,
                                const void *r3, int64_t B, int64_t l,
                                int64_t n, void *stream) {
  if (B == 0 || l == 0) return 0;
  const bool vec = n % 4 == 0 && aligned16(out) && aligned16(hi) &&
                   aligned16(lo) && aligned16(e);
  int per;
  const dim3 grid = limb_split_grid(B, l, n, vec ? 4 : 1, &per);
  if (vec)
    seeded_pre_kernel<4><<<grid, PASS_THREADS, 0, (cudaStream_t)stream>>>(
        (uint32_t *)out, (const uint32_t *)hi, (const uint32_t *)lo,
        (const uint32_t *)e, (const uint32_t *)qs, (const uint32_t *)qneg,
        (const uint32_t *)r2, (const uint32_t *)r3, (int)B, (int)l, (int)n, per);
  else
    seeded_pre_kernel<1><<<grid, PASS_THREADS, 0, (cudaStream_t)stream>>>(
        (uint32_t *)out, (const uint32_t *)hi, (const uint32_t *)lo,
        (const uint32_t *)e, (const uint32_t *)qs, (const uint32_t *)qneg,
        (const uint32_t *)r2, (const uint32_t *)r3, (int)B, (int)l, (int)n, per);
  return (int)cudaGetLastError();
}

// x: [B, l, n] eval-form Montgomery residues of m + e; s_eval: secret key
// rows [>= l, n]; c0 may alias x (c0 = x: the pass runs in place).
extern "C" int imtpu_seeded_c0(void *c0, const void *x, const void *s_eval,
                               const void *qs, const void *qneg,
                               const void *r1, const void *r2, int64_t seed,
                               int64_t group, int64_t B, int64_t l, int64_t n,
                               void *stream) {
  if (B == 0 || l == 0) return 0;
  if (l > PASS_MAX_GRID_Y) return (int)cudaErrorInvalidValue;
  const bool vec = n % 4 == 0 && aligned16(c0) && aligned16(x) &&
                   aligned16(s_eval);
  int stretch;
  const dim3 grid = row_stretch_grid(B, l, n, vec ? 4 : 1, &stretch);
  const ThreefryKey key = threefry_key((uint32_t)seed, (uint32_t)group);
  if (vec)
    seeded_c0_kernel<4><<<grid, PASS_THREADS, 0, (cudaStream_t)stream>>>(
        (uint32_t *)c0, (const uint32_t *)x, (const uint32_t *)s_eval,
        (const uint32_t *)qs, (const uint32_t *)qneg, (const uint32_t *)r1,
        (const uint32_t *)r2, key, (int)B, (int)l, (int)n, stretch);
  else
    seeded_c0_kernel<1><<<grid, PASS_THREADS, 0, (cudaStream_t)stream>>>(
        (uint32_t *)c0, (const uint32_t *)x, (const uint32_t *)s_eval,
        (const uint32_t *)qs, (const uint32_t *)qneg, (const uint32_t *)r1,
        (const uint32_t *)r2, key, (int)B, (int)l, (int)n, stretch);
  return (int)cudaGetLastError();
}
