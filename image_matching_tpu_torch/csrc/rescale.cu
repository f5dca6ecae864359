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
//             and the top_std <= qt // 2 branch of the JAX code (:782-787);
//   sub-scale pass (after K1 takes t forward):
//     out = (x - t) * c mod q_i with c = q_t^-1 (rescale) or P^-1
//     (mod-down) in Montgomery form; optionally plus add[r, comp] gathered
//     through perm_r, which writes c0 o sigma + d0 (a rotation) or
//     c + d (a relinearization) in the same pass.
//
// What bounds it on the H100: device memory, if the integer work per
// residue stays small.  The lift pass reads one residue per coefficient
// and writes l - 1; the sub-scale pass reads two (three with the addend)
// and writes one per residue, with one Montgomery product.
//
// Design: one thread takes V = 4 consecutive coefficients of one batch row
// (16-byte loads and stores) and loops over the limbs, two limbs' loads in
// flight before either is used.  The lift computes REDC(top) and the
// centring once per coefficient, not once per limb, and has no `%`: for
// s < 2^32, mont_mul(s, R^2 mod q) = s * R mod q, which is reduce_small
// followed by the conversion to Montgomery form, so the limb loop is one
// Montgomery product and a branch-free select per residue.  The sub-scale
// reads each coefficient's permutation index once (one 16-byte load of
// four), not once per limb; the gathered addend stays four 4-byte loads
// from one row of c0, which the L2 holds.  x is read in place from its
// strided parent (the first l limbs of an l + 1 or l + S limb tensor), so
// no slice is copied.  Offsets inside a row are 32-bit.  A launch of few
// rows (one ciphertext) splits the limbs over blockIdx.z until it has
// PASS_MIN_BLOCKS blocks (passgrid.cuh's limb_split_grid, the grid of K6's
// and K10's pre passes too).  An operand that is not 16-byte aligned (or
// a stride that is not a multiple of four) takes V = 1 in the same kernel.
#include <cuda_runtime.h>
#include <stdint.h>

#include "modmath.cuh"
#include "passgrid.cuh"

__device__ __forceinline__ uint32_t lift_one(uint32_t s, bool neg, uint32_t q,
                                             uint32_t qn, uint32_t r2) {
  const uint32_t v = mont_mul(s, r2, q, qn);  // s * R mod q, s < q_t < 2^31
  const uint32_t w = v == 0u ? 0u : q - v;
  return neg ? w : v;
}

// One thread: coefficients k..k+V-1 of rows b, limbs [i0, i1).
template <int V>
__global__ void __launch_bounds__(PASS_THREADS)
    rescale_lift_kernel(uint32_t *__restrict__ out,
                        const uint32_t *__restrict__ top, uint32_t qt,
                        uint32_t qt_neg, const uint32_t *__restrict__ qs,
                        const uint32_t *__restrict__ qneg,
                        const uint32_t *__restrict__ r2, int B, int l, int n,
                        int per) {
  const int k = (blockIdx.x * PASS_THREADS + threadIdx.x) * V;
  if (k >= n) return;
  const int i0 = blockIdx.z * per;
  const int i1 = min(l, i0 + per);
  const uint32_t half = qt >> 1;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    uint32_t s[V];
    bool neg[V];
    ld_v<V>(top + (size_t)b * n + k, s);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const uint32_t ts = mont_mul(s[v], 1u, qt, qt_neg);  // standard, < qt
      neg[v] = ts > half;
      s[v] = neg[v] ? qt - ts : ts;
    }
    uint32_t *o = out + (size_t)b * l * n + k;
#pragma unroll 2
    for (int i = i0; i < i1; ++i) {
      const uint32_t q = __ldg(qs + i), qn = __ldg(qneg + i), c = __ldg(r2 + i);
      uint32_t r[V];
#pragma unroll
      for (int v = 0; v < V; ++v) r[v] = lift_one(s[v], neg[v], q, qn, c);
      st_v<V>(o + i * n, r);
    }
  }
}

struct SubArgs {
  uint32_t *out;
  const uint32_t *x, *t, *cinv, *qs, *qneg, *add;
  const int32_t *perms;
  int64_t x_bstride, add_rstride, add_cstride, add_lstride, perm_rstride;
  int add_k, B, l, n, per;
};

// NL consecutive limbs i..i+NL-1 of one thread's coefficients: every
// operand of every limb loaded first, then each limb computed and stored.
template <int V, bool GATHER, int NL>
__device__ __forceinline__ void sub_limbs(const SubArgs &p,
                                          const uint32_t *__restrict__ xb,
                                          const uint32_t *__restrict__ tb,
                                          const uint32_t *__restrict__ ab,
                                          uint32_t *__restrict__ ob,
                                          const int (&pk)[V], int i) {
  uint32_t xv[NL][V], tv[NL][V], av[NL][V];
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    const int off = (i + j) * p.n;
    ld_v<V>(xb + off, xv[j]);
    ld_v<V>(tb + off, tv[j]);
    if (ab != nullptr) {
      const size_t aoff = (size_t)(i + j) * p.add_lstride;
      if (GATHER) {
#pragma unroll
        for (int v = 0; v < V; ++v) av[j][v] = __ldg(ab + aoff + pk[v]);
      } else {
        ld_v<V>(ab + aoff, av[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    const uint32_t q = __ldg(p.qs + i + j), qn = __ldg(p.qneg + i + j);
    const uint32_t c = __ldg(p.cinv + i + j);
    uint32_t r[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      r[v] = mont_mul(mod_sub(xv[j][v], tv[j][v], q), c, q, qn);
      if (ab != nullptr) r[v] = mod_add(av[j][v], r[v], q);
    }
    st_v<V>(ob + (i + j) * p.n, r);
  }
}

// One thread: coefficients k..k+V-1 of rows b = (r, comp) = (b / 2,
// b % 2), limbs [i0, i1).
template <int V, bool GATHER>
__global__ void __launch_bounds__(PASS_THREADS) sub_scale_kernel(SubArgs p) {
  const int k = (blockIdx.x * PASS_THREADS + threadIdx.x) * V;
  if (k >= p.n) return;
  const int i0 = blockIdx.z * p.per;
  const int i1 = min(p.l, i0 + p.per);
  const size_t plane = (size_t)p.l * p.n;
  for (int b = blockIdx.y; b < p.B; b += gridDim.y) {
    const int r = b >> 1, comp = b & 1;
    const uint32_t *xb = p.x + b * p.x_bstride + k;
    const uint32_t *tb = p.t + b * plane + k;
    uint32_t *ob = p.out + b * plane + k;
    const uint32_t *ab = nullptr;
    int pk[V] = {};
    if (comp < p.add_k) {
      ab = p.add + r * p.add_rstride + comp * p.add_cstride;
      if (GATHER) {
        if constexpr (V == 4) {
          const int4 w = __ldg(reinterpret_cast<const int4 *>(
              p.perms + r * p.perm_rstride + k));
          pk[0] = w.x, pk[1] = w.y, pk[2] = w.z, pk[3] = w.w;
        } else {
          pk[0] = __ldg(p.perms + r * p.perm_rstride + k);
        }
      } else {
        ab += k;
      }
    }
    int i = i0;
    for (; i + 1 < i1; i += 2) sub_limbs<V, GATHER, 2>(p, xb, tb, ab, ob, pk, i);
    if (i < i1) sub_limbs<V, GATHER, 1>(p, xb, tb, ab, ob, pk, i);
  }
}

// top: [B, n] coefficient-domain Montgomery residues mod qt (the inverse
// NTT of the top limb); out: [B, l, n] Montgomery residues of the centred
// top over limbs 0..l-1 (qs, qneg, r2 = R^2 mod q indexed by limb).
extern "C" int imtpu_rescale_lift(void *out, const void *top, int64_t qt,
                                  int64_t qt_neg, const void *qs,
                                  const void *qneg, const void *r2, int64_t B,
                                  int64_t l, int64_t n, void *stream) {
  if (B == 0 || l == 0) return 0;
  if (l * n >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  const bool vec = n % 4 == 0 && aligned16(out) && aligned16(top);
  int per;
  const dim3 grid = limb_split_grid(B, l, n, vec ? 4 : 1, &per);
  if (vec)
    rescale_lift_kernel<4><<<grid, PASS_THREADS, 0, (cudaStream_t)stream>>>(
        (uint32_t *)out, (const uint32_t *)top, (uint32_t)qt, (uint32_t)qt_neg,
        (const uint32_t *)qs, (const uint32_t *)qneg, (const uint32_t *)r2,
        (int)B, (int)l, (int)n, per);
  else
    rescale_lift_kernel<1><<<grid, PASS_THREADS, 0, (cudaStream_t)stream>>>(
        (uint32_t *)out, (const uint32_t *)top, (uint32_t)qt, (uint32_t)qt_neg,
        (const uint32_t *)qs, (const uint32_t *)qneg, (const uint32_t *)r2,
        (int)B, (int)l, (int)n, per);
  return (int)cudaGetLastError();
}

template <int V>
static void launch_sub_scale(const SubArgs &p, dim3 grid, cudaStream_t s) {
  if (p.perms != nullptr)
    sub_scale_kernel<V, true><<<grid, PASS_THREADS, 0, s>>>(p);
  else
    sub_scale_kernel<V, false><<<grid, PASS_THREADS, 0, s>>>(p);
}

// out, t: [B, l, n]; x: B blocks of l rows, block b at x + b * x_bstride;
// cinv [l]: the divisor's inverse in Montgomery form per limb.  With
// add_k > 0 the rows are (r, comp) = (b / 2, b % 2) of a [R, 2, l, n]
// key-switch output, and component comp < add_k gets add[r * add_rstride
// + comp * add_cstride + i * add_lstride + perm_r[k]] (perm NULL: k, and
// add_lstride = n), perm_r at perms + r * perm_rstride.  A gathered
// addend's rows may be wider than the output's (add_lstride > n): a slot
// shard (parallel/tensor.py) gathers its own n slots of a rotation from
// the all-gathered full-width c0, perm_r holding global indices.
extern "C" int imtpu_sub_scale(void *out, const void *x, int64_t x_bstride,
                               const void *t, const void *cinv,
                               const void *qs, const void *qneg,
                               const void *add, int64_t add_rstride,
                               int64_t add_cstride, int64_t add_lstride, int64_t add_k,
                               const void *perms, int64_t perm_rstride,
                               int64_t B, int64_t l, int64_t n, void *stream) {
  if (B == 0 || l == 0) return 0;
  if (add_k < 0 || add_k > 2 || (add_k > 0 && (add == nullptr || B % 2 != 0)) ||
      (perms != nullptr && add_k == 0) || l * n >= (int64_t)1 << 31 ||
      (add_k > 0 && (add_lstride < n || (perms == nullptr && add_lstride != n))))
    return (int)cudaErrorInvalidValue;
  const SubArgs p{(uint32_t *)out, (const uint32_t *)x, (const uint32_t *)t,
                  (const uint32_t *)cinv, (const uint32_t *)qs,
                  (const uint32_t *)qneg, (const uint32_t *)add,
                  (const int32_t *)perms, x_bstride, add_rstride, add_cstride,
                  add_lstride, perm_rstride, (int)add_k, (int)B, (int)l, (int)n, 0};
  // V = 4 needs every row of every operand on a 16-byte boundary; the
  // gathered addend is read one residue at a time either way
  const bool vec =
      n % 4 == 0 && aligned16(out) && aligned16(t) && aligned16(x) &&
      x_bstride % 4 == 0 &&
      (add_k == 0 || perms != nullptr ||
       (aligned16(add) && add_rstride % 4 == 0 && add_cstride % 4 == 0)) &&
      (perms == nullptr || (aligned16(perms) && perm_rstride % 4 == 0));
  SubArgs q = p;
  const dim3 grid = limb_split_grid(B, l, n, vec ? 4 : 1, &q.per);
  if (vec)
    launch_sub_scale<4>(q, grid, (cudaStream_t)stream);
  else
    launch_sub_scale<1>(q, grid, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
