// K10: public-key encryption, the two passes around one forward NTT (K1).
//
// Replaces image_matching_tpu/ckks/context.py _encrypt_impl (:420) with
// the _small_signed_to_rns it calls (:407):
//   pre pass: X = (m + e0) * R, V = v * R, E1 = e1 * R mod q per limb,
//             from the standard-form message residues m and the small
//             signed int32 noise v (ternary), e0, e1;  -> [3, B, l, N]
//   K1:       the three forward, one launch;
//   MAC pass: c0 = pk_b * V + X, c1 = pk_a * V + E1  -> [B, 2, l, N].
// The JAX code transforms m, v, e0 and e1 separately and adds
// (pk_b v + e0) + m after; the NTT is linear over Z_q on canonical
// residues and the modular adds associate, so adding m + e0 first gives
// the same c0 with three NTTs instead of four.
//
// What bounds each pass on the H100: device memory.  At a chunk of
// B = 128 ciphertexts of l = 14 limbs (N = 2^15):
// - pre pass: reads m (235 MB) and 12 bytes of noise a coefficient
//   (50 MB), writes X, V and E1 (705 MB): 0.30 ms at 3.35 TB/s; two
//   Montgomery products and a select a residue.
// - MAC pass: reads X, V and E1 (705 MB) and the two key rows (3.7 MB),
//   writes c0 and c1 (470 MB): 0.35 ms; two products and two adds a
//   residue.
//
// Design:
// - pre: one thread takes V = 4 consecutive coefficients of one
//   ciphertext, reads v, e0 and e1 once (16-byte loads of int32, where
//   the first design read int64 once per limb) and loops over the limbs,
//   reading m and writing X, V and E1 with 16-byte accesses.  V*R comes
//   from a select on the ternary v among {0, R mod q, q - R mod q}, with
//   no product (a v outside {-1, 0, 1} takes the product, in a branch no
//   lane of a ternary draw enters).  A launch of few ciphertexts (a query
//   of one) splits the limbs over grid z.
//   An operand that is not 16-byte aligned (or n not a multiple of four)
//   takes V = 1 in the same kernel.
// - MAC: one thread a (ciphertext, limb, coefficient), 4-byte accesses
//   coalesced on the coefficient; the key rows, shared by every
//   ciphertext, come from L2.  It reaches 85-87 % of its byte bound at
//   the chunks above (utils/enc_bench.py on the H100).  A variant holding
//   a limb's key words in registers over a stretch of ciphertexts, with
//   16-byte accesses, was no faster: the key rows cost L2 reads, not
//   device-memory bytes.  The ciphertexts run over grid z, looping past
//   its limit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "modmath.cuh"
#include "passgrid.cuh"

__device__ __forceinline__ uint32_t small_residue(int32_t s, uint32_t q) {
  return s < 0 ? q - (uint32_t)(-(int64_t)s) : (uint32_t)s;
}

// v * R mod q for the ternary v by a select; any other |v| < q by a
// Montgomery product with R^2.
__device__ __forceinline__ uint32_t ternary_mont(int32_t v, uint32_t q, uint32_t qn,
                                                 uint32_t r1, uint32_t r2) {
  if (v >= -1 && v <= 1) return v == 0 ? 0u : (v > 0 ? r1 : q - r1);
  return mont_mul(small_residue(v, q), r2, q, qn);
}

// One thread: coefficients k..k+V-1 of ciphertexts b, limbs [i0, i1).
template <int V>
__global__ void __launch_bounds__(PASS_THREADS)
    pk_pre_kernel(uint32_t *__restrict__ out, const uint32_t *__restrict__ m,
                  const uint32_t *__restrict__ v, const uint32_t *__restrict__ e0,
                  const uint32_t *__restrict__ e1, const uint32_t *__restrict__ qs,
                  const uint32_t *__restrict__ qneg, const uint32_t *__restrict__ r1,
                  const uint32_t *__restrict__ r2, int B, int l, int n, int per) {
  const int k = (blockIdx.x * PASS_THREADS + threadIdx.x) * V;
  if (k >= n) return;
  const int i0 = blockIdx.z * per;
  const int i1 = min(l, i0 + per);
  const size_t plane = (size_t)B * l * n;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const size_t src = (size_t)b * n + k;
    uint32_t vv[V], a0[V], a1[V];
    ld_v<V>(v + src, vv);
    ld_v<V>(e0 + src, a0);
    ld_v<V>(e1 + src, a1);
#pragma unroll 2
    for (int i = i0; i < i1; ++i) {
      const uint32_t q = __ldg(qs + i), qn = __ldg(qneg + i);
      const uint32_t c1 = __ldg(r1 + i), c2 = __ldg(r2 + i);
      const size_t o = ((size_t)b * l + i) * n + k;
      uint32_t mv[V], X[V], Vr[V], E[V];
      ld_v<V>(m + o, mv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        X[j] = mont_mul(mod_add(mv[j], small_residue((int32_t)a0[j], q), q), c2, q, qn);
        Vr[j] = ternary_mont((int32_t)vv[j], q, qn, c1, c2);
        E[j] = mont_mul(small_residue((int32_t)a1[j], q), c2, q, qn);
      }
      st_v<V>(out + o, X);
      st_v<V>(out + plane + o, Vr);
      st_v<V>(out + 2 * plane + o, E);
    }
  }
}

// One thread: coefficient c of limb blockIdx.y, ciphertexts blockIdx.z,
// blockIdx.z + gridDim.z, ...
__global__ void pk_mac_kernel(uint32_t *__restrict__ out, const uint32_t *__restrict__ x,
                              const uint32_t *__restrict__ pk_b,
                              const uint32_t *__restrict__ pk_a,
                              const uint32_t *__restrict__ qs,
                              const uint32_t *__restrict__ qneg, int B, int l, int n) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  const int i = blockIdx.y;
  const uint32_t q = qs[i], qn = qneg[i];
  const size_t p = (size_t)i * n + c;
  const size_t plane = (size_t)B * l * n;
  for (size_t b = blockIdx.z; b < (size_t)B; b += gridDim.z) {
    const size_t o = b * l * (size_t)n + p;
    const uint32_t V = x[plane + o];
    uint32_t *dst = out + b * 2 * l * (size_t)n + p;
    dst[0] = mod_add(mont_mul(pk_b[p], V, q, qn), x[o], q);
    dst[(size_t)l * n] = mod_add(mont_mul(pk_a[p], V, q, qn), x[2 * plane + o], q);
  }
}

// m: [B, l, n] standard residues; v, e0, e1: [B, n] int32 with |value| <
// q (v ternary takes the select); out: [3, B, l, n] Montgomery residues
// (X, V, E1); r1 = R mod q, r2 = R^2 mod q.
extern "C" int imtpu_pk_pre(void *out, const void *m, const void *v,
                            const void *e0, const void *e1, const void *qs,
                            const void *qneg, const void *r1, const void *r2,
                            int64_t B, int64_t l, int64_t n, void *stream) {
  if (B == 0 || l == 0) return 0;
  const bool vec = n % 4 == 0 && aligned16(out) && aligned16(m) &&
                   aligned16(v) && aligned16(e0) && aligned16(e1);
  int per;
  const dim3 grid = limb_split_grid(B, l, n, vec ? 4 : 1, &per);
  if (vec)
    pk_pre_kernel<4><<<grid, PASS_THREADS, 0, (cudaStream_t)stream>>>(
        (uint32_t *)out, (const uint32_t *)m, (const uint32_t *)v,
        (const uint32_t *)e0, (const uint32_t *)e1, (const uint32_t *)qs,
        (const uint32_t *)qneg, (const uint32_t *)r1, (const uint32_t *)r2, (int)B,
        (int)l, (int)n, per);
  else
    pk_pre_kernel<1><<<grid, PASS_THREADS, 0, (cudaStream_t)stream>>>(
        (uint32_t *)out, (const uint32_t *)m, (const uint32_t *)v,
        (const uint32_t *)e0, (const uint32_t *)e1, (const uint32_t *)qs,
        (const uint32_t *)qneg, (const uint32_t *)r1, (const uint32_t *)r2, (int)B,
        (int)l, (int)n, per);
  return (int)cudaGetLastError();
}

// x: [3, B, l, n] evaluation form (the NTT of the pre pass); pk_b, pk_a:
// public key rows [>= l, n]; out: [B, 2, l, n].
extern "C" int imtpu_pk_mac(void *out, const void *x, const void *pk_b,
                            const void *pk_a, const void *qs, const void *qneg,
                            int64_t B, int64_t l, int64_t n, void *stream) {
  if (B == 0 || l == 0) return 0;
  if (l > PASS_MAX_GRID_Y) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)l,
                  (unsigned)(B < PASS_MAX_GRID_Y ? B : PASS_MAX_GRID_Y));
  pk_mac_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t *)out, (const uint32_t *)x, (const uint32_t *)pk_b, (const uint32_t *)pk_a,
      (const uint32_t *)qs, (const uint32_t *)qneg, (int)B, (int)l, (int)n);
  return (int)cudaGetLastError();
}
