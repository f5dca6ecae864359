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
// conversions, concatenations and a stack.  Design: K3's core (fbc.cuh),
// a block per (coefficient tile, digit, target chunk, batch row): the
// block switches once on its digit's g to a body specialised on it, so
// the y_i of four coefficients stay in registers; the first chunk also
// writes the digit's own rows from the registers it loaded them into, and
// every row is written with coalesced 16-byte stores.  A launch of few
// rows (a single relinearization, B = 1) splits each digit's targets over
// more blocks so that every SM has work (fbc_split).
#include <cuda_runtime.h>
#include <stdint.h>

#include "fbc.cuh"

// One block's share: digit rows a..a+G-1 of xr, targets [p0, p1) of t.
template <int G>
__device__ __forceinline__ void decompose_body(uint32_t *o,
                                               const uint32_t *xr,
                                               const uint32_t *cs, int a,
                                               int t, int p0, int p1,
                                               int n) {
  uint32_t y[G][FBC_V], v[FBC_V];
#pragma unroll
  for (int i = 0; i < G; ++i) fbc_ld(xr + (size_t)i * n, y[i]);
  if (p0 == 0) {
#pragma unroll
    for (int i = 0; i < G; ++i) fbc_st(o + (size_t)(a + i) * n, y[i]);
  }
  fbc_prepare<G>(cs + FBC_TW * t, nullptr, y, v);
  for (int p = p0; p < p1; ++p) {
    uint32_t r[FBC_V];
    fbc_target<G>(y, v, cs + FBC_TW * p, r);
    fbc_st(o + (size_t)(p < a ? p : p + G) * n, r);
  }
}

// dinfo: [ndig, 3] int32 = (first limb a_j, limb count g_j, word offset
// of the digit's packed constants in consts).  blockIdx.y = digit *
// chunks + chunk; a chunk covers `per` of the digit's E - g_j targets.
__global__ void __launch_bounds__(FBC_THREADS)
    decompose_kernel(uint32_t *__restrict__ out,
                     const uint32_t *__restrict__ x, int64_t x_bstride,
                     const uint32_t *__restrict__ consts,
                     const int32_t *__restrict__ dinfo, int ndig, int E,
                     int per, int chunks, int n) {
  __shared__ __align__(16) uint32_t cs[FBC_SMEM];
  const int j = blockIdx.y / chunks;
  const int a = dinfo[3 * j], g = dinfo[3 * j + 1], off = dinfo[3 * j + 2];
  const int t = E - g;
  const int p0 = (blockIdx.y % chunks) * per;
  if (p0 >= t) return;  // this digit has fewer targets than the widest
  const int p1 = min(t, p0 + per);
  fbc_stage(cs, consts + off, g, t);
  __syncthreads();

  const int c = (blockIdx.x * blockDim.x + threadIdx.x) * FBC_V;
  if (c >= n) return;
  const size_t b = blockIdx.z;
  const uint32_t *xr = x + b * x_bstride + (size_t)a * n + c;
  uint32_t *o = out + ((b * ndig + j) * E) * (size_t)n + c;
  switch (g) {
#define DEC_CASE(G) \
  case G: decompose_body<G>(o, xr, cs, a, t, p0, p1, n); break;
    DEC_CASE(1) DEC_CASE(2) DEC_CASE(3) DEC_CASE(4)
    DEC_CASE(5) DEC_CASE(6) DEC_CASE(7) DEC_CASE(8)
#undef DEC_CASE
  }
}

// x: B blocks of l coefficient-domain rows (block b at x + b * x_bstride);
// out: [B, ndig, E, n], E = l + S.  Every digit has 1..8 limbs (the
// caller checks), so at most E - 1 targets.  n and x_bstride are multiples
// of 4 and x, out start on 16-byte boundaries (the wrapper checks).
extern "C" int imtpu_decompose(void *out, const void *x, int64_t x_bstride,
                               const void *consts, const void *dinfo,
                               int64_t B, int64_t ndig, int64_t E, int64_t n,
                               void *stream) {
  if (B == 0 || ndig == 0) return 0;
  if (E < 2 || E - 1 > FBC_MAXT || B > 65535 || n % FBC_V != 0 ||
      x_bstride % FBC_V != 0 || ((uintptr_t)out | (uintptr_t)x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long bx = (n + FBC_THREADS * FBC_V - 1) / (FBC_THREADS * FBC_V);
  int per, chunks;
  fbc_split(bx * ndig * B, (int)E - 1, &per, &chunks);
  dim3 grid((unsigned)bx, (unsigned)(ndig * chunks), (unsigned)B);
  decompose_kernel<<<grid, FBC_THREADS, 0, (cudaStream_t)stream>>>(
      (uint32_t *)out, (const uint32_t *)x, x_bstride,
      (const uint32_t *)consts, (const int32_t *)dinfo, (int)ndig, (int)E,
      per, chunks, (int)n);
  return (int)cudaGetLastError();
}
