// K5: seed expansion of the c1 half of seed-compressed DB ciphertexts.
//
// Replaces image_matching_tpu/ops/prng.py uniform_residues (:51) as called
// by ckks/context.py uniform_mont (:464) / expand_c1 (:598): out[b, limb,
// k] = uniform residue of Threefry(seed, group; idx = (b*l + limb)*N + k)
// mod q_limb, the Montgomery/eval-form c1 of ciphertext b of the group.
//
// What bounds it on the H100: integer ALU work, not memory.  Each 4-byte
// output costs 20 Threefry rounds (about 80 32-bit add/rotate/xor) plus
// two Montgomery products, against 4 bytes written.  Design: one thread
// per output coefficient, neighbouring threads on neighbouring k, so the
// single store is coalesced and nothing is read but four per-limb
// constants.  The output may be a strided view: rows of one ciphertext
// are `out_stride` elements apart, so the sender writes c1 straight into
// the c1 half of its [B, 2, l, N] group stack.
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

__global__ void expand_c1_kernel(uint32_t *__restrict__ out,
                                 const uint32_t *__restrict__ qs,
                                 const uint32_t *__restrict__ qneg,
                                 const uint32_t *__restrict__ r1,
                                 const uint32_t *__restrict__ r2,
                                 uint32_t seed, uint32_t group, int l, int n,
                                 size_t out_stride) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int limb = blockIdx.y;
  const size_t b = blockIdx.z;
  const uint32_t idx = (uint32_t)((b * l + limb) * n + k);  // wraps mod 2^32
  out[b * out_stride + (size_t)limb * n + k] = uniform_residue(
      seed, group, idx, qs[limb], qneg[limb], r1[limb], r2[limb]);
}

// out: B rows of [l, n] residues, row b at out + b * out_stride; limb
// constants qs/qneg/r1/r2 (R mod q, R^2 mod q) indexed 0..l-1.
extern "C" int imtpu_expand_c1(void *out, const void *qs, const void *qneg,
                               const void *r1, const void *r2, int64_t seed,
                               int64_t group, int64_t B, int64_t l, int64_t n,
                               int64_t out_stride, void *stream) {
  if (B == 0 || l == 0) return 0;
  const int threads = 256;
  dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)l, (unsigned)B);
  expand_c1_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t *)out, (const uint32_t *)qs, (const uint32_t *)qneg,
      (const uint32_t *)r1, (const uint32_t *)r2, (uint32_t)seed,
      (uint32_t)group, (int)l, (int)n, (size_t)out_stride);
  return (int)cudaGetLastError();
}
