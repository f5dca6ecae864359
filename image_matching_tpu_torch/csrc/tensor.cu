// K9: the ciphertext tensor product and decryption's multiply-accumulate.
//
// Replaces image_matching_tpu/ckks/context.py mul (:734), square (:750)
// and the MAC of _decrypt_impl (:609):
//   tensor: c0 = x0*y0, c1 = x0*y1 + x1*y0, c2 = x1*y1 (Montgomery
//           products, modular adds); square: c1 = 2 * x0*x1, as
//           mod_add(m, m);
//   decrypt MAC: m = c0 + c1*s (+ c2*s^2), then REDC(m) = m * R^-1.  The
//           JAX code takes REDC after the inverse NTT; both maps are linear
//           over Z_q on canonical residues, so REDC before K1's inverse
//           gives the same residues and saves a pass.
//
// What bounds it on the H100: device memory.  The tensor product reads
// four residues and writes three with four Montgomery products; the
// decrypt MAC reads k residues plus the key and writes one.  Design: one
// thread per (batch row, limb, coefficient), coalesced on the
// coefficient; operands are read in place through their batch and
// component strides, so a ciphertext dropped to fewer limbs (a view) is not
// copied.
#include <cuda_runtime.h>
#include <stdint.h>

#include "modmath.cuh"

__global__ void tensor_kernel(uint32_t *__restrict__ out,
                              const uint32_t *__restrict__ x, int64_t xb,
                              int64_t xc, const uint32_t *__restrict__ y,
                              int64_t yb, int64_t yc, int square,
                              const uint32_t *__restrict__ qs,
                              const uint32_t *__restrict__ qneg, int l, int n) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int i = blockIdx.y;
  const size_t b = blockIdx.z;
  const uint32_t q = qs[i], qn = qneg[i];
  const size_t p = (size_t)i * n + k;
  const size_t so = (size_t)l * n;
  x += b * xb;
  out += b * 3 * so;
  const uint32_t x0 = x[p], x1 = x[xc + p];
  if (square) {
    const uint32_t m = mont_mul(x0, x1, q, qn);
    out[p] = mont_mul(x0, x0, q, qn);
    out[so + p] = mod_add(m, m, q);
    out[2 * so + p] = mont_mul(x1, x1, q, qn);
  } else {
    y += b * yb;
    const uint32_t y0 = y[p], y1 = y[yc + p];
    out[p] = mont_mul(x0, y0, q, qn);
    out[so + p] = mod_add(mont_mul(x0, y1, q, qn), mont_mul(x1, y0, q, qn), q);
    out[2 * so + p] = mont_mul(x1, y1, q, qn);
  }
}

__global__ void decrypt_mac_kernel(uint32_t *__restrict__ out,
                                   const uint32_t *__restrict__ data,
                                   int64_t bstride, int64_t cstride, int k,
                                   const uint32_t *__restrict__ s,
                                   const uint32_t *__restrict__ qs,
                                   const uint32_t *__restrict__ qneg, int l,
                                   int n) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  const int i = blockIdx.y;
  const size_t b = blockIdx.z;
  const uint32_t q = qs[i], qn = qneg[i];
  const size_t p = (size_t)i * n + c;
  const uint32_t *d = data + b * bstride + p;
  const uint32_t sv = s[p];
  uint32_t m = d[0], spow = sv;
  for (int j = 1; j < k; ++j) {
    m = mod_add(m, mont_mul(d[j * cstride], spow, q, qn), q);
    if (j + 1 < k) spow = mont_mul(spow, sv, q, qn);
  }
  out[b * l * (size_t)n + p] = mont_mul(m, 1u, q, qn);
}

// x, y: B ciphertexts [2, >= l, n] with batch strides xb, yb and component
// strides xc, yc (y ignored when square); out: [B, 3, l, n].
extern "C" int imtpu_tensor(void *out, const void *x, int64_t xb, int64_t xc,
                            const void *y, int64_t yb, int64_t yc,
                            int64_t square, const void *qs, const void *qneg,
                            int64_t B, int64_t l, int64_t n, void *stream) {
  if (B == 0 || l == 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)l, (unsigned)B);
  tensor_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t *)out, (const uint32_t *)x, xb, xc, (const uint32_t *)y, yb,
      yc, (int)square, (const uint32_t *)qs, (const uint32_t *)qneg, (int)l,
      (int)n);
  return (int)cudaGetLastError();
}

// data: B ciphertexts of k components [>= l, n] (block stride bstride,
// component stride cstride); s: secret key rows [>= l, n]; out: [B, l, n]
// REDC of c0 + c1 s (+ c2 s^2), evaluation domain.
extern "C" int imtpu_decrypt_mac(void *out, const void *data, int64_t bstride,
                                 int64_t cstride, int64_t k, const void *s,
                                 const void *qs, const void *qneg, int64_t B,
                                 int64_t l, int64_t n, void *stream) {
  if (B == 0 || l == 0) return 0;
  if (k < 1 || k > 3) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)l, (unsigned)B);
  decrypt_mac_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t *)out, (const uint32_t *)data, bstride, cstride, (int)k,
      (const uint32_t *)s, (const uint32_t *)qs, (const uint32_t *)qneg,
      (int)l, (int)n);
  return (int)cudaGetLastError();
}
