// K1: negacyclic NTT over RNS limbs, forward and inverse.
//
// Replaces image_matching_tpu/ops/ntt.py NttPlan.fwd (:231) and
// NttPlan.inv (:260).  Same merged-twiddle wiring as host_ntt_fwd /
// host_ntt_inv (:294, :313): forward is Cooley-Tukey from natural order
// to bit-reversed evaluation order with twiddle psis[m + g]; inverse is
// Gentleman-Sande with ipsis[h + g] and a final 1/N.  All outputs are
// canonical residues, so the result is bit-identical to the JAX plan's.
//
// What bounds it on the H100: each of the log2(N) stages touches the
// whole row, so a row that went back to device memory between stages
// would cost 15 round trips at N = 32768.  Design: one thread block per
// (batch, limb) row keeps the whole row (N * 4 B = 128 KiB) in dynamic
// shared memory for all stages, so device memory sees one read and one
// write of the row plus the twiddle reads (which hit L2: one table row per
// limb is shared by every batch row).  The TPU version instead runs
// uniform roll-and-select stages to keep XLA graphs small; that has no
// use here.  One block per SM fits (128 KiB of 227 KiB); rows >= 132 fill
// the card.  Bank conflicts in the short-stride stages and the
// per-stage __syncthreads are the next costs to attack.
//
// The loads take a batch stride, so a slice of limbs (the top limb of a
// rescale, the special limbs of a mod-down) is read in place, and an
// optional permutation perm[x] of the input coefficients: the Galois
// automorphism gather of image_matching_tpu/ckks/context.py _permute (:976)
// fused into the inverse NTT that starts a rotation's key switch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "modmath.cuh"

template <bool INVERSE>
__global__ void ntt_kernel(uint32_t *__restrict__ out,
                           const uint32_t *__restrict__ in,
                           int64_t in_bstride,
                           const int32_t *__restrict__ perm,
                           int64_t perm_bstride,
                           const int32_t *__restrict__ limb_idx, int L,
                           int logn, const uint32_t *__restrict__ tw,
                           const uint32_t *__restrict__ tw_sh,
                           const uint32_t *__restrict__ qs,
                           const uint32_t *__restrict__ ninv,
                           const uint32_t *__restrict__ ninv_sh) {
  extern __shared__ uint32_t s[];
  const int n = 1 << logn;
  const int half = n >> 1;
  const size_t row = blockIdx.x;
  const int limb = limb_idx[row % L];
  const uint32_t q = qs[limb];
  const uint32_t *w = tw + (size_t)limb * n;
  const uint32_t *wsh = tw_sh + (size_t)limb * n;
  const size_t b = row / L;
  const uint32_t *src = in + b * in_bstride + (row % L) * (size_t)n;
  if (perm) {
    const int32_t *pr = perm + b * perm_bstride;
    for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = src[pr[i]];
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = src[i];
  }
  __syncthreads();
  if (!INVERSE) {
    // stage m = 2^st: t = n / 2m; butterfly k -> group g = k / t
    for (int st = 0; st < logn; ++st) {
      const int lt = logn - 1 - st;  // log2 t
      const int t = 1 << lt;
      const int m = 1 << st;
      for (int k = threadIdx.x; k < half; k += blockDim.x) {
        const int g = k >> lt;
        const int iu = (g << (lt + 1)) + (k & (t - 1));
        const uint32_t u = s[iu];
        const uint32_t v = shoup_mul(s[iu + t], w[m + g], wsh[m + g], q);
        s[iu] = mod_add(u, v, q);
        s[iu + t] = mod_sub(u, v, q);
      }
      __syncthreads();
    }
    uint32_t *dst = out + row * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = s[i];
  } else {
    // stage m = n >> lt (h = m / 2 groups), t = 2^lt
    for (int lt = 0; lt < logn; ++lt) {
      const int t = 1 << lt;
      const int h = half >> lt;
      for (int k = threadIdx.x; k < half; k += blockDim.x) {
        const int g = k >> lt;
        const int iu = (g << (lt + 1)) + (k & (t - 1));
        const uint32_t u = s[iu];
        const uint32_t v = s[iu + t];
        s[iu] = mod_add(u, v, q);
        s[iu + t] = shoup_mul(mod_sub(u, v, q), w[h + g], wsh[h + g], q);
      }
      __syncthreads();
    }
    const uint32_t ni = ninv[limb], nish = ninv_sh[limb];
    uint32_t *dst = out + row * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      dst[i] = shoup_mul(s[i], ni, nish, q);
  }
}

// rows = batch * L rows of n = 2^logn residues; row r = (b, i) reads
// in + b * in_bstride + i * n (through perm + b * perm_bstride when perm
// is not NULL; perm_bstride 0 shares one permutation) and uses table row
// limb_idx[i].  tw/tw_sh are psis/psis_sh (forward) or ipsis/ipsis_sh
// (inverse), [Ltot, n].  out is [rows, n]; it may alias in when in is
// contiguous and perm is NULL.
extern "C" int imtpu_ntt(void *out, const void *in, int64_t in_bstride,
                         const void *perm, int64_t perm_bstride,
                         const void *limb_idx,
                         int64_t rows, int64_t L, int64_t logn, const void *tw,
                         const void *tw_sh, const void *qs, const void *ninv,
                         const void *ninv_sh, int64_t inverse, void *stream) {
  const int n = 1 << logn;
  const size_t smem = (size_t)n * sizeof(uint32_t);
  const int threads = n / 2 < 1024 ? n / 2 : 1024;
  cudaStream_t st = (cudaStream_t)stream;
  if (rows == 0) return 0;
  if (inverse) {
    cudaFuncSetAttribute(ntt_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    ntt_kernel<true><<<(unsigned)rows, threads, smem, st>>>(
        (uint32_t *)out, (const uint32_t *)in, in_bstride,
        (const int32_t *)perm, perm_bstride, (const int32_t *)limb_idx,
        (int)L, (int)logn, (const uint32_t *)tw, (const uint32_t *)tw_sh,
        (const uint32_t *)qs, (const uint32_t *)ninv,
        (const uint32_t *)ninv_sh);
  } else {
    cudaFuncSetAttribute(ntt_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    ntt_kernel<false><<<(unsigned)rows, threads, smem, st>>>(
        (uint32_t *)out, (const uint32_t *)in, in_bstride,
        (const int32_t *)perm, perm_bstride, (const int32_t *)limb_idx,
        (int)L, (int)logn, (const uint32_t *)tw, (const uint32_t *)tw_sh,
        (const uint32_t *)qs, (const uint32_t *)ninv,
        (const uint32_t *)ninv_sh);
  }
  return (int)cudaGetLastError();
}
