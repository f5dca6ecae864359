// Fast base conversion of one coefficient, shared by K3
// (basis_convert.cu) and K8 (decompose.cu).
//
// Exactness: v must equal the JAX package's float32 value bit for bit, or
// rare coefficients move by one multiple of Q.  XLA on the CPU sums the
// axis in index order, each product and sum rounded to float32.  So the
// sum here runs sequentially with __fmul_rn / __fadd_rn (which nvcc never
// contracts into an FMA) and rounds half to even with rintf, as
// jnp.round does.
#pragma once
#include <stdint.h>

#include "modmath.cuh"

#define FBC_MAXG 8
#define FBC_MAXT 32
#define FBC_MAXCS (4 * FBC_MAXG + 3 * FBC_MAXT + FBC_MAXG * FBC_MAXT)

// One conversion's constants (uint32 words, staged in shared memory):
// qs[g], qnegs[g], tstd[g], invq[g] (float bits), qd[t], qnegd[t],
// qgr2[t], qhat[g * t] (row i = source limb).
struct FbcView {
  const uint32_t *qs, *qnegs, *tstd, *qd, *qnegd, *qgr2, *qhat;
  const float *invq;
  int g, t;
};

__device__ __forceinline__ FbcView fbc_view(const uint32_t *cs, int g, int t) {
  FbcView f;
  f.qs = cs;
  f.qnegs = cs + g;
  f.tstd = cs + 2 * g;
  f.invq = reinterpret_cast<const float *>(cs + 3 * g);
  f.qd = cs + 4 * g;
  f.qnegd = f.qd + t;
  f.qgr2 = f.qd + 2 * t;
  f.qhat = f.qd + 3 * t;
  f.g = g;
  f.t = t;
  return f;
}

// Reads the g source residues of one coefficient (xr[i * stride]), adds
// pre[i] when pre is not NULL (the centred mod-down's +P/2), and returns
// v; y[i] = x_i * t_i (standard form).
__device__ __forceinline__ uint32_t fbc_load(const FbcView &f,
                                             const uint32_t *xr, size_t stride,
                                             const uint32_t *pre,
                                             uint32_t *y) {
  float acc = 0.0f;
  for (int i = 0; i < f.g; ++i) {
    uint32_t xi = xr[(size_t)i * stride];
    if (pre) xi = mod_add(xi, pre[i], f.qs[i]);
    y[i] = mont_mul(xi, f.tstd[i], f.qs[i], f.qnegs[i]);
    const float v = __fmul_rn(__uint2float_rn(y[i]), f.invq[i]);
    acc = i == 0 ? v : __fadd_rn(acc, v);
  }
  return (uint32_t)rintf(acc);
}

// Target p: sum_i y_i * Qhat_i - v * Q mod qd[p] (Montgomery).
__device__ __forceinline__ uint32_t fbc_target(const FbcView &f,
                                               const uint32_t *y, uint32_t v,
                                               int p) {
  const uint32_t qp = f.qd[p], qn = f.qnegd[p];
  uint32_t sum = 0;
  for (int i = 0; i < f.g; ++i)
    sum = mod_add(sum, mont_mul(y[i], f.qhat[i * f.t + p], qp, qn), qp);
  return mod_sub(sum, mont_mul(v, f.qgr2[p], qp, qn), qp);
}
