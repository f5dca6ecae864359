// K2: ciphertext dot product, sum_k A_k (x) B_k -> 3 components.
//
// Replaces image_matching_tpu/matching/senders.py ct_dot (:53) and the
// mont_dot contraction it calls (image_matching_tpu/ops/modmath.py:122):
//   c0 = sum a0*b0,  c1 = sum (a0*b1 + a1*b0),  c2 = sum a1*b1,
// each returned in Montgomery form, i.e. (sum mod q) * R^{-1} mod q,
// exactly mont_dot's value.
//
// Exactness: a product of two residues reaches 2^62 and K reaches 512
// (the 511-rotation HyDia mode), so a 64-bit sum would overflow.  The
// TPU version sums 16-bit lanes, valid only for K <= 2^16.  Here each
// sum is a 128-bit (hi:lo) accumulator with one carry add per product,
// reduced mod q once per output.
//
// What bounds it on the H100: device memory.  Per output coefficient it
// reads 2K residues of B (the encrypted DB, read once per query) and 2K of
// A (the query's rotations, shared by every block of B), and does 4K
// 32x32->64 multiplies: about 1 multiply per byte, far below the card's
// compute.  Design: one thread per (block, limb, coefficient), so
// neighbouring threads read neighbouring coefficients (coalesced); A is
// indexed without copies (its limb count LA may exceed l, the limbs used)
// and the L2 keeps the re-read A slices.  Keeping A in registers across
// several B blocks is the next step.
#include <cuda_runtime.h>
#include <stdint.h>

#include "modmath.cuh"

__global__ void ct_dot_kernel(uint32_t *__restrict__ out,
                              const uint32_t *__restrict__ A,
                              const uint32_t *__restrict__ B, int K, int l,
                              int n, int LA, int LB,
                              const uint32_t *__restrict__ qs,
                              const uint32_t *__restrict__ qneg) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  const int i = blockIdx.y;
  const size_t blk = blockIdx.z;
  const size_t sa = (size_t)LA * n;  // component stride in A
  const size_t sb = (size_t)LB * n;
  const uint32_t *a = A + (size_t)i * n + c;
  const uint32_t *b = B + blk * K * 2 * sb + (size_t)i * n + c;
  acc128 s0 = {0, 0}, s1 = {0, 0}, s2 = {0, 0};
  for (int k = 0; k < K; ++k) {
    const uint64_t a0 = a[0], a1 = a[sa];
    const uint64_t b0 = b[0], b1 = b[sb];
    acc_add(s0, a0 * b0);
    acc_add(s1, a0 * b1);
    acc_add(s1, a1 * b0);
    acc_add(s2, a1 * b1);
    a += 2 * sa;
    b += 2 * sb;
  }
  const uint32_t q = qs[i], qn = qneg[i];
  uint32_t *o = out + (blk * 3 * l + i) * n + c;
  const size_t so = (size_t)l * n;
  o[0] = mont_mul(acc_mod(s0, q), 1u, q, qn);
  o[so] = mont_mul(acc_mod(s1, q), 1u, q, qn);
  o[2 * so] = mont_mul(acc_mod(s2, q), 1u, q, qn);
}

// A: [K, 2, LA, n]; B: [nb, K, 2, LB, n]; out: [nb, 3, l, n] with
// l <= min(LA, LB); qs/qneg indexed by limb 0..l-1.
extern "C" int imtpu_ct_dot(void *out, const void *A, const void *B, int64_t K,
                            int64_t nb, int64_t l, int64_t n, int64_t LA,
                            int64_t LB, const void *qs, const void *qneg,
                            void *stream) {
  if (nb == 0 || l == 0) return 0;
  const int threads = 256;
  dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)l,
            (unsigned)nb);
  ct_dot_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t *)out, (const uint32_t *)A, (const uint32_t *)B, (int)K,
      (int)l, (int)n, (int)LA, (int)LB, (const uint32_t *)qs,
      (const uint32_t *)qneg);
  return (int)cudaGetLastError();
}
