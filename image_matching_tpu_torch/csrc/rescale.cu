// K7: division by a modulus, the two passes around the NTTs of a rescale
// (divide by the top prime) and of a mod-down (divide by P).
//
// Replaces image_matching_tpu/ckks/context.py rescale (:768) and the tail
// of _moddown (:890), and with them the c0 gather of every rotation
// (_permute, :976; the vmapped bodies of hoisted_rotate_stack and
// rotate_stack, :1056-1085):
//   lift pass (rescale, after K1 inverts the top limb):
//     t_std = REDC(top) mod q_t, centred: t_std <= q_t/2 ? t_std mod q_i
//             : -((q_t - t_std) mod q_i) mod q_i, then t = t_std * R mod q_i
//             for every remaining limb i -- exactly reduce_small, mod_neg
//             and the top_std <= qt // 2 branch of the JAX code;
//   sub-scale pass (after K1 takes t forward):
//     out = (x - t) * c mod q_i with c = q_t^-1 (rescale) or P^-1
//     (mod-down) in Montgomery form; optionally plus add[r, comp] gathered
//     through perm_r, which writes c0 o sigma + d0 (a rotation) or
//     c + d (a relinearization) in the same pass.
//
// What bounds it on the H100: device memory.  The lift pass reads one
// residue per coefficient and writes l - 1 (one integer remainder each);
// the sub-scale pass reads two (three with the addend) and writes one per
// residue, with one or two Montgomery products.  Design: one thread per
// (batch row, limb, coefficient), coalesced on the coefficient; x is read
// in place from its strided parent (the first l limbs of an l + 1 or
// l + S limb tensor), so no slice is copied.  The addend's gather is the
// only uncoalesced read: one permuted row of c0 per rotation, which the
// L2 holds.
#include <cuda_runtime.h>
#include <stdint.h>

#include "modmath.cuh"

__global__ void rescale_lift_kernel(uint32_t *__restrict__ out,
                                    const uint32_t *__restrict__ top,
                                    uint32_t qt, uint32_t qt_neg,
                                    const uint32_t *__restrict__ qs,
                                    const uint32_t *__restrict__ qneg,
                                    const uint32_t *__restrict__ r2, int l,
                                    int n) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int i = blockIdx.y;
  const size_t b = blockIdx.z;
  const uint32_t q = qs[i];
  const uint32_t ts = mont_mul(top[b * n + k], 1u, qt, qt_neg);  // < qt
  uint32_t t;
  if (ts <= qt / 2) {
    t = ts % q;
  } else {
    const uint32_t nv = (qt - ts) % q;
    t = nv == 0 ? 0u : q - nv;
  }
  out[(b * l + i) * n + k] = mont_mul(t, r2[i], q, qneg[i]);
}

__global__ void sub_scale_kernel(uint32_t *__restrict__ out,
                                 const uint32_t *__restrict__ x,
                                 int64_t x_bstride,
                                 const uint32_t *__restrict__ t,
                                 const uint32_t *__restrict__ cinv,
                                 const uint32_t *__restrict__ qs,
                                 const uint32_t *__restrict__ qneg,
                                 const uint32_t *__restrict__ add,
                                 int64_t add_rstride, int64_t add_cstride,
                                 int add_k, const int32_t *__restrict__ perms,
                                 int64_t perm_rstride, int l, int n) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int i = blockIdx.y;
  const size_t b = blockIdx.z;
  const uint32_t q = qs[i], qn = qneg[i];
  const size_t o = (b * l + i) * n + k;
  const uint32_t d = mod_sub(x[b * x_bstride + (size_t)i * n + k], t[o], q);
  uint32_t v = mont_mul(d, cinv[i], q, qn);
  const size_t r = b >> 1;
  const int comp = (int)(b & 1);
  if (comp < add_k) {
    const int src = perms ? perms[r * perm_rstride + k] : k;
    v = mod_add(add[r * add_rstride + comp * add_cstride + (size_t)i * n + src],
                v, q);
  }
  out[o] = v;
}

// top: [B, n] coefficient-domain Montgomery residues mod qt (the inverse
// NTT of the top limb); out: [B, l, n] Montgomery residues of the centred
// top over limbs 0..l-1 (qs, qneg, r2 = R^2 mod q indexed by limb).
extern "C" int imtpu_rescale_lift(void *out, const void *top, int64_t qt,
                                  int64_t qt_neg, const void *qs,
                                  const void *qneg, const void *r2, int64_t B,
                                  int64_t l, int64_t n, void *stream) {
  if (B == 0 || l == 0) return 0;
  const int threads = 256;
  dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)l, (unsigned)B);
  rescale_lift_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t *)out, (const uint32_t *)top, (uint32_t)qt, (uint32_t)qt_neg,
      (const uint32_t *)qs, (const uint32_t *)qneg, (const uint32_t *)r2,
      (int)l, (int)n);
  return (int)cudaGetLastError();
}

// out, t: [B, l, n]; x: B blocks of l rows, block b at x + b * x_bstride;
// cinv [l]: the divisor's inverse in Montgomery form per limb.  With
// add_k > 0 the rows are (r, comp) = (b / 2, b % 2) of a [R, 2, l, n]
// key-switch output, and component comp < add_k gets add[r * add_rstride
// + comp * add_cstride + i * n + perm_r[k]] (perm NULL: k).
extern "C" int imtpu_sub_scale(void *out, const void *x, int64_t x_bstride,
                               const void *t, const void *cinv,
                               const void *qs, const void *qneg,
                               const void *add, int64_t add_rstride,
                               int64_t add_cstride, int64_t add_k,
                               const void *perms, int64_t perm_rstride,
                               int64_t B, int64_t l, int64_t n, void *stream) {
  if (B == 0 || l == 0) return 0;
  if (add_k < 0 || add_k > 2 || (add_k > 0 && (add == nullptr || B % 2 != 0)))
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)l, (unsigned)B);
  sub_scale_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t *)out, (const uint32_t *)x, x_bstride, (const uint32_t *)t,
      (const uint32_t *)cinv, (const uint32_t *)qs, (const uint32_t *)qneg,
      (const uint32_t *)add, add_rstride, add_cstride, (int)add_k,
      (const int32_t *)perms, perm_rstride, (int)l, (int)n);
  return (int)cudaGetLastError();
}
