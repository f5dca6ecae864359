// K12: the modular sum of shard partials.
//
// Replaces image_matching_tpu/parallel/sharded.py psum_mod (:37), the
// cross-shard reduction of the membership flags, together with each
// shard's local chain of mod_adds before it (sharded.py:104-111,
// :244-249): out[i] = (sum over buffers p, rows r of buf_p[r][i]) mod
// q_limb(i).  The TPU version psums 16-bit halves (so a uint32 psum
// cannot wrap) and refolds them with Montgomery powers of 2^16; here the
// residues (< q < 2^31, Montgomery form kept: a sum of Montgomery forms is
// the Montgomery form of the sum) are summed in 64 bits and reduced once,
// which gives the same canonical residue.  Fewer than 2^32 rows in all
// cannot overflow.
//
// The P buffers are separate allocations (one per shard, or a partial
// copied from another card), so no single row stride addresses them, as
// K11's row sum needs: a device table of P pointers and P row counts
// (int64) names them, and the kernel reads each in place.  Buffer p holds
// rows[p] contiguous rows of the same [..., l, N] block of `total`
// residues.  Moving data between cards is a copy outside the kernel.
//
// What bounds it on the H100: device memory (each input residue read
// once, one residue written per element).  Design: a grid-stride loop,
// one thread per element, coalesced on the coefficient, as K11's row sum.
#include <cuda_runtime.h>
#include <stdint.h>

#include "modmath.cuh"

__global__ void psum_mod_kernel(uint32_t *__restrict__ out,
                                const int64_t *__restrict__ table, int P,
                                int64_t total, int l, int n,
                                const uint32_t *__restrict__ qs) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int limb = (int)((i / n) % l);
    uint64_t s = 0;
    for (int p = 0; p < P; ++p) {
      const uint32_t *buf = (const uint32_t *)table[p];
      const int64_t rows = table[P + p];
      for (int64_t r = 0; r < rows; ++r) s += buf[r * total + i];
    }
    out[i] = (uint32_t)(s % qs[limb]);
  }
}

// table: int64 [2 * P] on the device, the P buffer addresses then their P
// row counts; total = the elements of one row (a multiple of l * n);
// out: one row, the sum mod q of limbs 0..l-1.
extern "C" int imtpu_psum_mod(void *out, const void *table, int64_t P,
                              int64_t total, int64_t l, int64_t n,
                              const void *qs, void *stream) {
  if (total == 0) return 0;
  if (P < 1 || l < 1 || n < 1 || total % (l * n) != 0)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  psum_mod_kernel<<<(unsigned)(blocks < 132 * 32 ? blocks : 132 * 32), threads,
                    0, (cudaStream_t)stream>>>(
      (uint32_t *)out, (const int64_t *)table, (int)P, total, (int)l, (int)n,
      (const uint32_t *)qs);
  return (int)cudaGetLastError();
}
