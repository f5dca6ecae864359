// K3: fast base conversion (FBC) between RNS bases.
//
// Replaces image_matching_tpu/ckks/context.py _fbc (:837), used by the
// digit decomposition (_decompose_extended) and the mod-down (_moddown):
//   y_i   = x_i * t_i mod q_i                (x_i Montgomery, y_i standard)
//   v     = round(sum_i float32(y_i) * inv_q_i)   in float32
//   out_p = sum_i y_i * Qhat_i - v * Q  mod p     (Montgomery)
// The centred form of the mod-down (context.py:913, :926) adds pre[i]
// (+P/2 in Montgomery form) to each source residue first and subtracts
// post[p] (P/2) from each output, so its two glue passes disappear.
//
// Exactness: fbc.cuh (sequential float32 sum, rintf).
//
// What bounds it on the H100: device memory.  Per coefficient it reads g
// residues and writes t, with g*t + 2t + g modular multiplies: a few
// multiplies per byte.  Design: one thread per (batch row, coefficient)
// keeps its g <= 8 y_i in registers and loops over the t targets; the
// constants (under 1 KiB) are staged in shared memory.  Reads and writes
// are coalesced along the coefficient axis.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fbc.cuh"

__global__ void fbc_kernel(uint32_t *__restrict__ out,
                           const uint32_t *__restrict__ x,
                           const uint32_t *__restrict__ consts,
                           const uint32_t *__restrict__ pre,
                           const uint32_t *__restrict__ post, int g, int t,
                           int n) {
  __shared__ uint32_t cs[FBC_MAXCS];
  const int ncs = 4 * g + 3 * t + g * t;
  for (int i = threadIdx.x; i < ncs; i += blockDim.x) cs[i] = consts[i];
  __syncthreads();
  const FbcView f = fbc_view(cs, g, t);

  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  const size_t b = blockIdx.y;
  uint32_t y[FBC_MAXG];
  const uint32_t v = fbc_load(f, x + b * g * n + c, n, pre, y);
  uint32_t *o = out + b * t * n + c;
  for (int p = 0; p < t; ++p) {
    const uint32_t r = fbc_target(f, y, v, p);
    o[(size_t)p * n] = post ? mod_sub(r, post[p], f.qd[p]) : r;
  }
}

// x: [batch, g, n] coefficient-domain Montgomery residues over the source
// limbs; out: [batch, t, n] over the target limbs; pre [g] / post [t]:
// the centred shift in Montgomery form, or NULL for the plain conversion.
extern "C" int imtpu_fbc(void *out, const void *x, const void *consts,
                         const void *pre, const void *post, int64_t batch,
                         int64_t g, int64_t t, int64_t n, void *stream) {
  if (g < 1 || g > FBC_MAXG || t < 1 || t > FBC_MAXT)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const int threads = 256;
  dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)batch);
  fbc_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t *)out, (const uint32_t *)x, (const uint32_t *)consts,
      (const uint32_t *)pre, (const uint32_t *)post, (int)g, (int)t, (int)n);
  return (int)cudaGetLastError();
}
