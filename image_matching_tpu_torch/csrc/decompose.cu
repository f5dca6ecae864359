// K8: digit decomposition with extension to Q_l + P, between the inverse
// NTT of its input and one forward NTT of the whole digit stack.
//
// Replaces the per-digit loop of image_matching_tpu/ckks/context.py
// _decompose_extended (:859): for each digit j (limbs g_j of Q_l) and
// each row e of the extended basis ext = (0 .. l-1, Lq .. Ltot-1):
//   out[b, j, e] = x[b, e]                      when limb e is in g_j
//                  FBC(x[b, g_j] -> limb ext[e]) otherwise,
// rows in ext order (conversion rows below the digit, the digit's own
// rows copied exactly, then the rest).  Digits whose limbs all lie at or
// above l are not in the launch (the caller passes only live digits).
//
// Exactness: the conversion is fbc.cuh's, K3's arithmetic to the bit.
//
// What bounds it on the H100: device memory.  Per coefficient and digit
// it reads g <= 8 residues and writes l + S; one launch writes the whole
// [B, ndig, l + S, N] stack that the JAX code assembles from ndig
// conversions, concatenations and a stack.  Design: one thread per
// (batch row, digit, coefficient) keeps the digit's y_i in registers and
// walks the ext rows, coalesced on the coefficient; the digit's constants
// (under 1.5 KiB) are staged in shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fbc.cuh"

// dinfo: [ndig, 3] int32 = (first limb a_j, limb count g_j, word offset
// of the digit's FbcView constants in consts).
__global__ void decompose_kernel(uint32_t *__restrict__ out,
                                 const uint32_t *__restrict__ x,
                                 int64_t x_bstride,
                                 const uint32_t *__restrict__ consts,
                                 const int32_t *__restrict__ dinfo, int E,
                                 int n) {
  __shared__ uint32_t cs[FBC_MAXCS];
  const int j = blockIdx.y;
  const int a = dinfo[3 * j], g = dinfo[3 * j + 1], off = dinfo[3 * j + 2];
  const int t = E - g;
  const int ncs = 4 * g + 3 * t + g * t;
  for (int i = threadIdx.x; i < ncs; i += blockDim.x) cs[i] = consts[off + i];
  __syncthreads();
  const FbcView f = fbc_view(cs, g, t);

  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  const size_t b = blockIdx.z;
  const uint32_t *xr = x + b * x_bstride + (size_t)a * n + c;
  uint32_t y[FBC_MAXG];
  const uint32_t v = fbc_load(f, xr, n, nullptr, y);
  uint32_t *o = out + ((b * gridDim.y + j) * E) * (size_t)n + c;
  for (int e = 0; e < E; ++e) {
    uint32_t r;
    if (e >= a && e < a + g)
      r = xr[(size_t)(e - a) * n];
    else
      r = fbc_target(f, y, v, e < a ? e : e - g);
    o[(size_t)e * n] = r;
  }
}

// x: B blocks of l coefficient-domain rows (block b at x + b * x_bstride);
// out: [B, ndig, E, n], E = l + S.
extern "C" int imtpu_decompose(void *out, const void *x, int64_t x_bstride,
                               const void *consts, const void *dinfo,
                               int64_t B, int64_t ndig, int64_t E, int64_t n,
                               void *stream) {
  if (B == 0 || ndig == 0) return 0;
  if (E - 1 > FBC_MAXT || B > 65535) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)ndig,
            (unsigned)B);
  decompose_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t *)out, (const uint32_t *)x, x_bstride,
      (const uint32_t *)consts, (const int32_t *)dinfo, (int)E, (int)n);
  return (int)cudaGetLastError();
}
