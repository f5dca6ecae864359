// K3: fast base conversion (FBC) between RNS bases.
//
// Replaces image_matching_tpu/ckks/context.py _fbc (:837), used by the
// digit decomposition (_decompose_extended) and the mod-down (_moddown):
//   y_i   = x_i * t_i mod q_i                (x_i Montgomery, y_i standard)
//   v     = round(sum_i float32(y_i) * inv_q_i)   in float32
//   out_p = sum_i y_i * Qhat_i - v * Q  mod p     (Montgomery)
//
// Exactness: v must equal the JAX package's float32 value bit for bit, or
// rare coefficients move by one multiple of Q.  XLA on the CPU sums the
// axis in index order, each product and sum rounded to float32.  So the
// sum here runs sequentially with __fmul_rn / __fadd_rn (which nvcc never
// contracts into an FMA) and rounds half to even with rintf, as
// jnp.round does.
//
// What bounds it on the H100: device memory.  Per coefficient it reads g
// residues and writes t, with g*t + 2t + g modular multiplies: a few
// multiplies per byte.  Design: one thread per (batch row, coefficient)
// keeps its g <= 8 y_i in registers and loops over the t targets; the
// constants (under 1 KiB) are staged in shared memory.  Reads and writes
// are coalesced along the coefficient axis.
#include <cuda_runtime.h>
#include <stdint.h>

#include "modmath.cuh"

#define FBC_MAXG 8
#define FBC_MAXT 32

// consts layout (uint32 words): qs[g], qnegs[g], tstd[g], invq[g] (float
// bits), qd[t], qnegd[t], qgr2[t], qhat[g * t] (row i = source limb).
__global__ void fbc_kernel(uint32_t *__restrict__ out,
                           const uint32_t *__restrict__ x,
                           const uint32_t *__restrict__ consts, int g, int t,
                           int n) {
  __shared__ uint32_t cs[4 * FBC_MAXG + 3 * FBC_MAXT + FBC_MAXG * FBC_MAXT];
  const int ncs = 4 * g + 3 * t + g * t;
  for (int i = threadIdx.x; i < ncs; i += blockDim.x) cs[i] = consts[i];
  __syncthreads();
  const uint32_t *qs = cs, *qnegs = cs + g, *tstd = cs + 2 * g;
  const float *invq = reinterpret_cast<const float *>(cs + 3 * g);
  const uint32_t *qd = cs + 4 * g, *qnegd = qd + t, *qgr2 = qd + 2 * t;
  const uint32_t *qhat = qd + 3 * t;

  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  const size_t b = blockIdx.y;
  const uint32_t *xr = x + b * g * n + c;
  uint32_t y[FBC_MAXG];
  float acc = 0.0f;
  for (int i = 0; i < g; ++i) {
    y[i] = mont_mul(xr[(size_t)i * n], tstd[i], qs[i], qnegs[i]);
    const float f = __fmul_rn(__uint2float_rn(y[i]), invq[i]);
    acc = i == 0 ? f : __fadd_rn(acc, f);
  }
  const uint32_t v = (uint32_t)rintf(acc);
  uint32_t *o = out + b * t * n + c;
  for (int p = 0; p < t; ++p) {
    const uint32_t qp = qd[p], qn = qnegd[p];
    uint32_t sum = 0;
    for (int i = 0; i < g; ++i)
      sum = mod_add(sum, mont_mul(y[i], qhat[i * t + p], qp, qn), qp);
    o[(size_t)p * n] = mod_sub(sum, mont_mul(v, qgr2[p], qp, qn), qp);
  }
}

// x: [batch, g, n] coefficient-domain Montgomery residues over the source
// limbs; out: [batch, t, n] over the target limbs.
extern "C" int imtpu_fbc(void *out, const void *x, const void *consts,
                         int64_t batch, int64_t g, int64_t t, int64_t n,
                         void *stream) {
  if (g < 1 || g > FBC_MAXG || t < 1 || t > FBC_MAXT)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const int threads = 256;
  dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)batch);
  fbc_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t *)out, (const uint32_t *)x, (const uint32_t *)consts, (int)g,
      (int)t, (int)n);
  return (int)cudaGetLastError();
}
