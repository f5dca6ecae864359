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
// Exactness: fbc.cuh (sequential float32 sum, rintf; exact integer
// reduction to the canonical residue).
//
// What bounds it on the H100: device memory, with the integer pipes close
// behind.  Per coefficient it reads g residues and writes t; each output
// costs g mad.wide.u32 and two Montgomery steps (fbc.cuh), down from g
// reduced products and g + 1 modular adds.  Design: the kernel is
// specialised on g, so the y_i of four coefficients stay in registers
// (16-byte loads and stores, four independent chains per target); the
// constants sit in shared memory, 12 words a target, read as three
// broadcast 16-byte loads; a launch of few rows splits its targets over
// more blocks (fbc_split) so that every SM has work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fbc.cuh"

template <int G>
__global__ void __launch_bounds__(FBC_THREADS)
    fbc_kernel(uint32_t *__restrict__ out, const uint32_t *__restrict__ x,
               const uint32_t *__restrict__ consts,
               const uint32_t *__restrict__ pre,
               const uint32_t *__restrict__ post, int t, int per, int n) {
  __shared__ __align__(16) uint32_t cs[FBC_SMEM];
  __shared__ uint32_t spre[FBC_MAXG], spost[FBC_MAXT];
  fbc_stage(cs, consts, G, t);
  if (pre && threadIdx.x < G) spre[threadIdx.x] = pre[threadIdx.x];
  if (post)
    for (int i = threadIdx.x; i < t; i += blockDim.x) spost[i] = post[i];
  __syncthreads();

  const int c = (blockIdx.x * blockDim.x + threadIdx.x) * FBC_V;
  if (c >= n) return;
  const size_t b = blockIdx.z;
  const int p0 = blockIdx.y * per;
  const int p1 = min(t, p0 + per);
  uint32_t y[G][FBC_V], v[FBC_V];
  const uint32_t *xr = x + b * G * (size_t)n + c;
#pragma unroll
  for (int i = 0; i < G; ++i) fbc_ld(xr + (size_t)i * n, y[i]);
  fbc_prepare<G>(cs + FBC_TW * t, pre ? spre : nullptr, y, v);
  uint32_t *o = out + b * t * (size_t)n + c;
  for (int p = p0; p < p1; ++p) {
    const uint32_t *tb = cs + FBC_TW * p;
    uint32_t r[FBC_V];
    fbc_target<G>(y, v, tb, r);
    if (post) {
#pragma unroll
      for (int k = 0; k < FBC_V; ++k) r[k] = mod_sub(r[k], spost[p], tb[9]);
    }
    fbc_st(o + (size_t)p * n, r);
  }
}

// x: [batch, g, n] coefficient-domain Montgomery residues over the source
// limbs; out: [batch, t, n] over the target limbs; consts: FBC_WORDS(g, t)
// packed words (fbc.cuh); pre [g] / post [t]: the centred shift in
// Montgomery form, or NULL for the plain conversion.  n is a multiple of
// 4 and x, out start on 16-byte boundaries (the wrapper checks).
extern "C" int imtpu_fbc(void *out, const void *x, const void *consts,
                         const void *pre, const void *post, int64_t batch,
                         int64_t g, int64_t t, int64_t n, void *stream) {
  if (g < 1 || g > FBC_MAXG || t < 1 || t > FBC_MAXT || batch > 65535 ||
      n % FBC_V != 0 || ((uintptr_t)out | (uintptr_t)x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const long long bx = (n + FBC_THREADS * FBC_V - 1) / (FBC_THREADS * FBC_V);
  int per, chunks;
  fbc_split(bx * batch, (int)t, &per, &chunks);
  dim3 grid((unsigned)bx, (unsigned)chunks, (unsigned)batch);
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t *o = (uint32_t *)out;
  const uint32_t *xs = (const uint32_t *)x, *cs = (const uint32_t *)consts,
                 *pr = (const uint32_t *)pre, *po = (const uint32_t *)post;
  switch (g) {
#define FBC_CASE(G)                                                         \
  case G:                                                                   \
    fbc_kernel<G><<<grid, FBC_THREADS, 0, s>>>(o, xs, cs, pr, po, (int)t, \
                                               per, (int)n);              \
    break;
    FBC_CASE(1) FBC_CASE(2) FBC_CASE(3) FBC_CASE(4)
    FBC_CASE(5) FBC_CASE(6) FBC_CASE(7) FBC_CASE(8)
#undef FBC_CASE
  }
  return (int)cudaGetLastError();
}
