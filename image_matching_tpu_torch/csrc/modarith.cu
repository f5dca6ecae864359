// K11: standalone residue arithmetic between the other kernels.
//
// Replaces image_matching_tpu/ops/modmath.py mod_add, mod_sub, mod_neg and
// mont_mul (:32-153) where the JAX package calls them outside the fused
// operations: ciphertext add/neg, add_scalar, mul_plain, mul_scalar and
// mul_scalar_int (ckks/context.py:643-732), eval_sum's add (:1134), and the
// modular sums of many rows (HyDia's giant steps, the faithful HERS sum,
// the membership sum of flags, the output accumulation of slot packing):
//   elementwise pass: out = a + b, a - b, -a or a * b * R^-1 mod q_i, with
//     b of a's shape, an [l, N] plane broadcast over the leading axes, or a
//     per-limb constant [l]; with a head of h components out of k, each
//     ciphertext's components past its first h pass through unchanged
//     (add_scalar's component 0, or the add of ciphertexts with unequal
//     component counts), over any number of ciphertexts, so no
//     concatenation is needed; a same-shape b then holds h components per
//     ciphertext;
//   row-sum pass: out = sum_r a[r] mod q_i over R rows, summed in 64 bits
//     (R < 2^32 rows of residues < 2^31 cannot overflow) and reduced once:
//     the same canonical residue as the JAX package's chain of mod_adds.
// The limb of flat element i is (i / N) % l: limbs 0..l-1, as every caller
// works on a prefix of the chain.
//
// What bounds it on the H100: device memory.  The elementwise pass reads
// one or two residues and writes one per element with at most one
// Montgomery product; the row sum reads R and writes one.  Design: a
// grid-stride loop, one thread per element, coalesced on the coefficient;
// `a` and a same-shape `b` are read in place through a block stride, so a
// ciphertext dropped to fewer limbs (a view) is not copied.
#include <cuda_runtime.h>
#include <stdint.h>

#include "modmath.cuh"

enum { OP_ADD = 0, OP_SUB = 1, OP_NEG = 2, OP_MUL = 3 };
enum { B_SAME = 0, B_PLANE = 1, B_LIMB = 2 };

__global__ void modarith_kernel(uint32_t *__restrict__ out,
                                const uint32_t *__restrict__ a,
                                int64_t a_bstride,
                                const uint32_t *__restrict__ b,
                                int64_t b_bstride, int b_mode, int op,
                                int kcomp, int headk, int64_t total, int l,
                                int n,
                                const uint32_t *__restrict__ qs,
                                const uint32_t *__restrict__ qneg) {
  const int64_t plane = (int64_t)l * n;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t blk = i / plane, r = i - blk * plane;
    const uint32_t x = a[blk * a_bstride + r];
    const int comp = (int)(blk % kcomp);
    if (comp >= headk) {
      out[i] = x;
      continue;
    }
    const int limb = (int)(r / n);
    const uint32_t q = qs[limb];
    uint32_t y = 0;
    if (op != OP_NEG)
      y = b_mode == B_SAME ? b[((blk / kcomp) * headk + comp) * b_bstride + r]
                           : (b_mode == B_PLANE ? b[r] : b[limb]);
    uint32_t v;
    if (op == OP_ADD)
      v = mod_add(x, y, q);
    else if (op == OP_SUB)
      v = mod_sub(x, y, q);
    else if (op == OP_NEG)
      v = x == 0 ? 0u : q - x;
    else
      v = mont_mul(x, y, q, qneg[limb]);
    out[i] = v;
  }
}

__global__ void mod_sum_kernel(uint32_t *__restrict__ out,
                               const uint32_t *__restrict__ a, int64_t rstride,
                               int R, int64_t total, int l, int n,
                               const uint32_t *__restrict__ qs) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int limb = (int)((i / n) % l);
    uint64_t s = 0;
    for (int r = 0; r < R; ++r) s += a[r * rstride + i];
    out[i] = (uint32_t)(s % qs[limb]);
  }
}

static unsigned grid_for(int64_t total, int threads) {
  const int64_t blocks = (total + threads - 1) / threads;
  return (unsigned)(blocks < 132 * 32 ? blocks : 132 * 32);
}

// a: B blocks of [l, n] residues, block stride a_bstride; b (unused for
// neg): B blocks with stride b_bstride (b_mode 0), one [l, n] plane
// (b_mode 1) or [l] (b_mode 2); op 0 add, 1 sub, 2 neg, 3 Montgomery
// product; out: [B, l, n], B = ciphertexts * kcomp blocks, the op applied
// to the first headk blocks of every kcomp (kcomp = headk = 1: all).
extern "C" int imtpu_modarith(void *out, const void *a, int64_t a_bstride,
                              const void *b, int64_t b_bstride, int64_t b_mode,
                              int64_t op, int64_t kcomp, int64_t headk,
                              int64_t B, int64_t l,
                              int64_t n, const void *qs, const void *qneg,
                              void *stream) {
  const int64_t total = B * l * n;
  if (total == 0) return 0;
  if (op < 0 || op > 3 || b_mode < 0 || b_mode > 2 || kcomp < 1 || headk < 1 ||
      headk > kcomp || B % kcomp != 0)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  modarith_kernel<<<grid_for(total, threads), threads, 0, (cudaStream_t)stream>>>(
      (uint32_t *)out, (const uint32_t *)a, a_bstride, (const uint32_t *)b,
      b_bstride, (int)b_mode, (int)op, (int)kcomp, (int)headk, total, (int)l,
      (int)n,
      (const uint32_t *)qs, (const uint32_t *)qneg);
  return (int)cudaGetLastError();
}

// a: R rows, each B contiguous blocks of [l, n], row stride rstride;
// out: [B, l, n] = their sum mod q.
extern "C" int imtpu_mod_sum(void *out, const void *a, int64_t rstride, int64_t R,
                             int64_t B, int64_t l, int64_t n, const void *qs,
                             void *stream) {
  const int64_t total = B * l * n;
  if (total == 0) return 0;
  if (R < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  mod_sum_kernel<<<grid_for(total, threads), threads, 0, (cudaStream_t)stream>>>(
      (uint32_t *)out, (const uint32_t *)a, rstride, (int)R, total, (int)l,
      (int)n, (const uint32_t *)qs);
  return (int)cudaGetLastError();
}
