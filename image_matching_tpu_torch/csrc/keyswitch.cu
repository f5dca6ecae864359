// K4: key-switching multiply-accumulate with the automorphism fused in.
//
// Replaces the digit loop of image_matching_tpu/ckks/context.py
// _keyswitch_digits (:940) and, for hoisted rotations, the digit gather
// of _permute / jnp.take (:976, :1067):
//   out[r, c, i, x] = sum_{j < ndig} digs[r, j, i, perm_r[x]]
//                                    * ksk[r, j, c, row(i), x]   mod p_i
// for the R rotations (or relinearizations) of one call, c in {0, 1}.
// row(i) maps the extended limbs Q_l + P onto the key's rows
// [:l] u [Lq:] (_ksk_rows, :887).  Each term is a Montgomery product and
// the sum uses modular adds, exactly the JAX arithmetic.
//
// What bounds it on the H100: device memory.  Per output pair it reads
// ndig digit residues (through the permutation: a gather, but from a
// digit stack of a few MB that stays in L2 when shared by all R) and
// 2 * ndig key residues (the keys are the bulk: 15.7 MB per rotation at
// N = 32768), for 2 * ndig Montgomery multiplies.  Design: one launch
// covers every rotation, digit and limb, replacing the per-digit Python
// loop of separate mont_mul/mod_add passes with one pass that reads each
// key residue once and writes each output once; the permuted digits are
// never materialised.
//
// The digits' rows may be wider than the output's (src_n >= n): a slot
// shard (parallel/tensor.py) gathers its own n slots of a rotation from
// the all-gathered full-width digit stack, perm_r holding global indices.
#include <cuda_runtime.h>
#include <stdint.h>

#include "modmath.cuh"

__global__ void ks_mac_kernel(uint32_t *__restrict__ out,
                              const uint32_t *__restrict__ digs,
                              int64_t digs_r_stride,
                              const int32_t *__restrict__ perms,
                              const uint32_t *__restrict__ ksk,
                              int64_t ksk_r_stride, int ndig, int E, int l,
                              int Lq, int Ltot, int n, int src_n,
                              const uint32_t *__restrict__ qs,
                              const uint32_t *__restrict__ qneg) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= n) return;
  const int i = blockIdx.y;
  const size_t r = blockIdx.z;
  const int limb = i < l ? i : Lq + (i - l);
  const uint32_t q = qs[limb], qn = qneg[limb];
  const int src = perms ? perms[r * n + x] : x;
  const uint32_t *d = digs + r * digs_r_stride + (size_t)i * src_n + src;
  const uint32_t *k = ksk + r * ksk_r_stride + (size_t)limb * n + x;
  const size_t dstride = (size_t)E * src_n;    // digit stride in digs
  const size_t kstride = (size_t)Ltot * n;     // component stride in ksk
  uint32_t acc0 = 0, acc1 = 0;
  for (int j = 0; j < ndig; ++j) {
    const uint32_t dv = d[j * dstride];
    acc0 = mod_add(acc0, mont_mul(dv, k[(2 * j) * kstride], q, qn), q);
    acc1 = mod_add(acc1, mont_mul(dv, k[(2 * j + 1) * kstride], q, qn), q);
  }
  uint32_t *o = out + (r * 2 * E + i) * n + x;
  o[0] = acc0;
  o[(size_t)E * n] = acc1;
}

// digs: [R or 1, ndig, E, src_n] with r-stride digs_r_stride (0 =
// shared), src_n = n without perms; perms: [R, n] int32 or NULL, entries
// < src_n; ksk: [R or 1, dnum, 2, Ltot, n] with
// r-stride ksk_r_stride (0 = shared); out: [R, 2, E, n], E = l + S.
// qs/qneg indexed by absolute limb 0..Ltot-1.
extern "C" int imtpu_ks_mac(void *out, const void *digs, int64_t digs_r_stride,
                            const void *perms, const void *ksk,
                            int64_t ksk_r_stride, int64_t R, int64_t ndig,
                            int64_t E, int64_t l, int64_t Lq, int64_t Ltot,
                            int64_t n, int64_t src_n, const void *qs,
                            const void *qneg, void *stream) {
  if (R == 0) return 0;
  if (src_n < n || (perms == nullptr && src_n != n)) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)E,
            (unsigned)R);
  ks_mac_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t *)out, (const uint32_t *)digs, digs_r_stride,
      (const int32_t *)perms, (const uint32_t *)ksk, ksk_r_stride, (int)ndig,
      (int)E, (int)l, (int)Lq, (int)Ltot, (int)n, (int)src_n, (const uint32_t *)qs,
      (const uint32_t *)qneg);
  return (int)cudaGetLastError();
}
