// K10: public-key encryption, the two passes around one forward NTT (K1).
//
// Replaces image_matching_tpu/ckks/context.py _encrypt_impl (:420) with
// the _small_signed_to_rns it calls (:407):
//   pre pass: X = (m + e0) * R, V = v * R, E1 = e1 * R mod q per limb,
//             from the standard-form message residues m and the small
//             signed noise v (ternary), e0, e1;     -> [3, B, l, N]
//   K1:       the three forward, one launch;
//   MAC pass: c0 = pk_b * V + X, c1 = pk_a * V + E1  -> [B, 2, l, N].
// The JAX code transforms m, v, e0 and e1 separately and adds
// (pk_b v + e0) + m after; the NTT is linear over Z_q on canonical
// residues and the modular adds associate, so adding m + e0 first gives
// the same c0 with three NTTs instead of four.
//
// What bounds it on the H100: device memory.  The pre pass reads 4 + 24
// bytes per coefficient and limb-row (m, plus the three int64 noises
// re-read per limb from L2) and writes 12; the MAC pass reads 12 plus the
// two key rows (shared by every ciphertext, L2-resident) and writes 8.
// Design: one thread per (ciphertext, limb, coefficient), coalesced on
// the coefficient.
#include <cuda_runtime.h>
#include <stdint.h>

#include "modmath.cuh"

__device__ __forceinline__ uint32_t small_residue(int64_t s, uint32_t q) {
  return s < 0 ? (uint32_t)((int64_t)q + s) : (uint32_t)s;
}

__global__ void pk_pre_kernel(uint32_t *__restrict__ out,
                              const uint32_t *__restrict__ m,
                              const int64_t *__restrict__ v,
                              const int64_t *__restrict__ e0,
                              const int64_t *__restrict__ e1,
                              const uint32_t *__restrict__ qs,
                              const uint32_t *__restrict__ qneg,
                              const uint32_t *__restrict__ r2, int B, int l,
                              int n) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  const int i = blockIdx.y;
  const size_t b = blockIdx.z;
  const uint32_t q = qs[i], qn = qneg[i], rr = r2[i];
  const size_t src = b * n + c;
  const size_t o = (b * l + i) * n + c;
  const size_t plane = (size_t)B * l * n;
  const uint32_t x = mod_add(m[o], small_residue(e0[src], q), q);
  out[o] = mont_mul(x, rr, q, qn);
  out[plane + o] = mont_mul(small_residue(v[src], q), rr, q, qn);
  out[2 * plane + o] = mont_mul(small_residue(e1[src], q), rr, q, qn);
}

__global__ void pk_mac_kernel(uint32_t *__restrict__ out,
                              const uint32_t *__restrict__ x,
                              const uint32_t *__restrict__ pk_b,
                              const uint32_t *__restrict__ pk_a,
                              const uint32_t *__restrict__ qs,
                              const uint32_t *__restrict__ qneg, int B, int l,
                              int n) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  const int i = blockIdx.y;
  const size_t b = blockIdx.z;
  const uint32_t q = qs[i], qn = qneg[i];
  const size_t p = (size_t)i * n + c;
  const size_t o = b * l * (size_t)n + p;
  const size_t plane = (size_t)B * l * n;
  const uint32_t V = x[plane + o];
  uint32_t *dst = out + b * 2 * l * (size_t)n + p;
  dst[0] = mod_add(mont_mul(pk_b[p], V, q, qn), x[o], q);
  dst[(size_t)l * n] = mod_add(mont_mul(pk_a[p], V, q, qn), x[2 * plane + o], q);
}

// m: [B, l, n] standard residues; v, e0, e1: [B, n] int64 with |value| <
// q; out: [3, B, l, n] Montgomery residues (X, V, E1); r2 = R^2 mod q.
extern "C" int imtpu_pk_pre(void *out, const void *m, const void *v,
                            const void *e0, const void *e1, const void *qs,
                            const void *qneg, const void *r2, int64_t B,
                            int64_t l, int64_t n, void *stream) {
  if (B == 0 || l == 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)l, (unsigned)B);
  pk_pre_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t *)out, (const uint32_t *)m, (const int64_t *)v,
      (const int64_t *)e0, (const int64_t *)e1, (const uint32_t *)qs,
      (const uint32_t *)qneg, (const uint32_t *)r2, (int)B, (int)l, (int)n);
  return (int)cudaGetLastError();
}

// x: [3, B, l, n] evaluation form (the NTT of the pre pass); pk_b, pk_a:
// public key rows [>= l, n]; out: [B, 2, l, n].
extern "C" int imtpu_pk_mac(void *out, const void *x, const void *pk_b,
                            const void *pk_a, const void *qs, const void *qneg,
                            int64_t B, int64_t l, int64_t n, void *stream) {
  if (B == 0 || l == 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)l, (unsigned)B);
  pk_mac_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t *)out, (const uint32_t *)x, (const uint32_t *)pk_b,
      (const uint32_t *)pk_a, (const uint32_t *)qs, (const uint32_t *)qneg,
      (int)B, (int)l, (int)n);
  return (int)cudaGetLastError();
}
