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
// decrypt MAC reads k residues plus the key and writes one.
//
// Tensor product: one thread per (batch row, limb, coefficient), coalesced
// on the coefficient; operands are read in place through their batch and
// component strides, so a ciphertext dropped to fewer limbs (a view) is
// not copied.
//
// Decrypt MAC: a receiver decrypts many separate ciphertexts at once (the
// 64 index flags of a streamed 2^20 query), so their addresses go to the
// kernel by value, in one struct parameter of at most K9_CAP (as K12
// passes its buffers): no stacked copy, no device table, no host sync.
// Each ciphertext's [k, l, n] block has unit coefficient stride and limb
// stride n; the list shares k, l and the component stride.  The grid is
// passgrid.cuh's limb_split_grid: coefficients over x (V = 4 residues an
// access, 16 bytes; V = 1 where an operand is not 16-byte aligned),
// ciphertexts over y, the limbs over z in chunks, so a launch of one
// ciphertext still spreads its limbs over the card.  The output is [B, l,
// n], contiguous.
#include <cuda_runtime.h>
#include <stdint.h>

#include "modmath.cuh"
#include "passgrid.cuh"

#define K9_CAP 64  // ciphertexts a decrypt MAC launch

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

struct CtList {
  const uint32_t *ct[K9_CAP];
};

template <int V>
__global__ void __launch_bounds__(PASS_THREADS)
    decrypt_mac_kernel(uint32_t *__restrict__ out, const CtList L, int64_t cstride, int k,
                       const uint32_t *__restrict__ s, const uint32_t *__restrict__ qs,
                       const uint32_t *__restrict__ qneg, int l, int n, int per) {
  const int c = (blockIdx.x * PASS_THREADS + threadIdx.x) * V;
  if (c >= n) return;
  const int b = blockIdx.y;
  const uint32_t *d = L.ct[b];
  const int i1 = min(l, (int)(blockIdx.z + 1) * per);
  for (int i = blockIdx.z * per; i < i1; ++i) {
    const size_t p = (size_t)i * n + c;
    const uint32_t q = __ldg(qs + i), qn = __ldg(qneg + i);
    uint32_t sv[V], m[V], x[V], spow[V];
    ld_v<V>(s + p, sv);
    ld_v<V>(d + p, m);
#pragma unroll
    for (int v = 0; v < V; ++v) spow[v] = sv[v];
    for (int j = 1; j < k; ++j) {
      ld_v<V>(d + j * cstride + p, x);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        m[v] = mod_add(m[v], mont_mul(x[v], spow[v], q, qn), q);
        if (j + 1 < k) spow[v] = mont_mul(spow[v], sv[v], q, qn);
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) m[v] = mont_mul(m[v], 1u, q, qn);
    st_v<V>(out + ((size_t)b * l + i) * n + c, m);
  }
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

// cts: a host array (int64) of the device addresses of B <= K9_CAP
// ciphertexts, each k components [l, n] (limb stride n) cstride apart; s:
// secret key rows [>= l, n]; out: [B, l, n] REDC of c0 + c1 s (+ c2 s^2),
// evaluation domain.
extern "C" int imtpu_decrypt_mac(void *out, const void *cts, int64_t B, int64_t cstride,
                                 int64_t k, const void *s, const void *qs, const void *qneg,
                                 int64_t l, int64_t n, void *stream) {
  if (B == 0 || l == 0) return 0;
  if (B < 0 || B > K9_CAP || k < 1 || k > 3 || l > PASS_MAX_GRID_Y)
    return (int)cudaErrorInvalidValue;
  CtList L;
  const int64_t *a = (const int64_t *)cts;
  bool vec = n % 4 == 0 && (k == 1 || cstride % 4 == 0) && aligned16(out) && aligned16(s);
  for (int b = 0; b < B; ++b) {
    L.ct[b] = (const uint32_t *)a[b];
    vec = vec && aligned16(L.ct[b]);
  }
  int per;
  const dim3 grid = limb_split_grid(B, l, n, vec ? 4 : 1, &per);
  if (vec)
    decrypt_mac_kernel<4><<<grid, PASS_THREADS, 0, (cudaStream_t)stream>>>(
        (uint32_t *)out, L, cstride, (int)k, (const uint32_t *)s, (const uint32_t *)qs,
        (const uint32_t *)qneg, (int)l, (int)n, per);
  else
    decrypt_mac_kernel<1><<<grid, PASS_THREADS, 0, (cudaStream_t)stream>>>(
        (uint32_t *)out, L, cstride, (int)k, (const uint32_t *)s, (const uint32_t *)qs,
        (const uint32_t *)qneg, (int)l, (int)n, per);
  return (int)cudaGetLastError();
}
