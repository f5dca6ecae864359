// K6: seeded symmetric encryption of DB groups, the two passes around the
// forward NTT (K1).
//
// Replaces image_matching_tpu/ckks/context.py _encrypt_seeded_dev (:512)
// with _coeffs_from_split (:495) and the expand_c1 it calls (:598):
//   pre pass: x = (m + e) * R mod q per limb, with m = hi * 2^24 + lo - 2^47
//             (the compact coefficient transfer form) and e the small
//             signed noise;                            [B, N] -> [B, l, N]
//   K1:       x = NTT(x);
//   c0 pass:  c0 = x - mont_mul(c1, s_eval), c1 regenerated in-kernel
//             from Threefry (threefry.cuh), so at enrollment c1 never
//             reaches device memory.
// The JAX code transforms m and e separately and adds them after; the NTT
// is linear over Z_q on canonical residues, so adding first gives the same
// c0 with half the NTT work.
//
// What bounds it on the H100: the pre pass writes l residues per 12 bytes
// read (memory bound, 4*l bytes out per coefficient); the c0 pass reads
// and writes 4 bytes per residue and runs 20 Threefry rounds for each, so
// it is integer-ALU bound like K5.  One thread per (b, limb, k): coalesced
// on k; the pre pass's inputs are re-read per limb from L2.
#include <cuda_runtime.h>
#include <stdint.h>

#include "modmath.cuh"
#include "threefry.cuh"

__global__ void seeded_pre_kernel(uint32_t *__restrict__ out,
                                  const uint32_t *__restrict__ hi,
                                  const uint32_t *__restrict__ lo,
                                  const int32_t *__restrict__ e,
                                  const uint32_t *__restrict__ qs,
                                  const uint32_t *__restrict__ qneg,
                                  const uint32_t *__restrict__ r2,
                                  const uint32_t *__restrict__ c24,
                                  const uint32_t *__restrict__ offm, int l,
                                  int n) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int limb = blockIdx.y;
  const size_t b = blockIdx.z;
  const size_t src = b * n + k;
  const uint32_t q = qs[limb], qn = qneg[limb];
  // m = hi * 2^24 + lo - OFFSET mod q; mont_mul(hi, 2^24 * R) = hi * 2^24
  const uint32_t t = mod_add(mont_mul(hi[src], c24[limb], q, qn), lo[src], q);
  const uint32_t m = mod_sub(t, offm[limb], q);
  const int32_t ev = e[src];
  const uint32_t es = ev < 0 ? q - (uint32_t)(-ev) : (uint32_t)ev;
  out[(b * l + limb) * n + k] = mont_mul(mod_add(m, es, q), r2[limb], q, qn);
}

__global__ void seeded_c0_kernel(uint32_t *c0, const uint32_t *x,  // may alias
                                 const uint32_t *__restrict__ s_eval,
                                 const uint32_t *__restrict__ qs,
                                 const uint32_t *__restrict__ qneg,
                                 const uint32_t *__restrict__ r1,
                                 const uint32_t *__restrict__ r2,
                                 uint32_t seed, uint32_t group, int l, int n) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int limb = blockIdx.y;
  const size_t b = blockIdx.z;
  const size_t i = (b * l + limb) * n + k;
  const uint32_t q = qs[limb], qn = qneg[limb];
  const uint32_t c1 =
      uniform_residue(seed, group, (uint32_t)i, q, qn, r1[limb], r2[limb]);
  c0[i] = mod_sub(x[i], mont_mul(c1, s_eval[(size_t)limb * n + k], q, qn), q);
}

// hi, lo: [B, n] uint32 (lo < 2^24); e: [B, n] int32 with |e| < q;
// out: [B, l, n]; per-limb constants indexed 0..l-1: c24 = 2^56 mod q,
// offm = 2^47 mod q.
extern "C" int imtpu_seeded_pre(void *out, const void *hi, const void *lo,
                                const void *e, const void *qs,
                                const void *qneg, const void *r2,
                                const void *c24, const void *offm, int64_t B,
                                int64_t l, int64_t n, void *stream) {
  if (B == 0 || l == 0) return 0;
  const int threads = 256;
  dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)l, (unsigned)B);
  seeded_pre_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t *)out, (const uint32_t *)hi, (const uint32_t *)lo,
      (const int32_t *)e, (const uint32_t *)qs, (const uint32_t *)qneg,
      (const uint32_t *)r2, (const uint32_t *)c24, (const uint32_t *)offm,
      (int)l, (int)n);
  return (int)cudaGetLastError();
}

// x: [B, l, n] eval-form Montgomery residues of m + e; s_eval: secret key
// rows [>= l, n]; c0 may alias x.
extern "C" int imtpu_seeded_c0(void *c0, const void *x, const void *s_eval,
                               const void *qs, const void *qneg,
                               const void *r1, const void *r2, int64_t seed,
                               int64_t group, int64_t B, int64_t l, int64_t n,
                               void *stream) {
  if (B == 0 || l == 0) return 0;
  const int threads = 256;
  dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)l, (unsigned)B);
  seeded_c0_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t *)c0, (const uint32_t *)x, (const uint32_t *)s_eval,
      (const uint32_t *)qs, (const uint32_t *)qneg, (const uint32_t *)r1,
      (const uint32_t *)r2, (uint32_t)seed, (uint32_t)group, (int)l, (int)n);
  return (int)cudaGetLastError();
}
