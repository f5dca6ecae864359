// K2: ciphertext dot product, sum_k A_k (x) B_k -> 3 components, and its
// seeded variant, which draws the c1 half of B where it multiplies it.
//
// Replaces image_matching_tpu/matching/senders.py ct_dot (:53) and the
// mont_dot contraction it calls (image_matching_tpu/ops/modmath.py:122)
// (B4):
//   c0 = sum a0*b0,  c1 = sum (a0*b1 + a1*b0),  c2 = sum a1*b1,
// each returned in Montgomery form, i.e. (sum mod q) * R^{-1} mod q,
// exactly mont_dot's value.  The seeded variant also replaces the
// expand_c1 before it in the streamed senders
// (image_matching_tpu/matching/streaming.py _group_compute, :774 and
// :836, through image_matching_tpu/ops/prng.py uniform_residues, :51)
// (B5): B's c1 half is the Threefry stream of threefry.cuh, the bits of
// K5 (prng.cu), drawn in registers; only c0 is read from memory.
//
// Exactness: every residue is below 2^31, so a product is below 2^62 and
// four fit a 64-bit partial (mad.wide.u32); partials fold into a 96-bit
// sum (acc96), reduced once per output by three Montgomery products
// (acc_redc), no 64-bit division.  Any exact order of summation gives the
// same canonical residue, so the result is bit-equal to mont_dot's.
//
// What bounds each on the H100:
// - ct_dot: device memory.  Per output coefficient it reads 2K residues
//   of each of the nb blocks of B and 2K of A, and does 4K multiplies per
//   block: about 0.5 multiplies per byte.  A thread per (block, limb,
//   coefficient) would read A once per block (HyDia: 16 x 117 MB, more
//   than L2 holds): twice the bytes the work needs.  Here one thread owns
//   V coefficients of one limb and loops
//   over the blocks: at the shapes measured on the card, K = 32 (HyDia,
//   V = 1) and K = 4 (Blind-Match, V = 4 coefficients with 16-byte
//   loads), A_k stays in registers (at most 64 words a thread), so A is
//   read once and B streams through; at any other K (HERS: K = 512,
//   nb = 1) A is streamed with B (read once when nb = 1).
// - ct_dot_seeded: the integer ALUs.  Each c1 residue costs 20 Threefry
//   rounds (about 80 add/rotate/xor) and two Montgomery products, against
//   4 bytes of c0 read; the contraction adds 4 multiply-adds.  By
//   chip_smoke's yardstick (32-bit operations over the float32 rate,
//   67 T/s; Hopper issues integer add, xor and funnel shift at a lower
//   rate) the HyDia shape is bound by operations, the HERS shape
//   (K = 512: A is 1.9 GB) by bytes.  Against the card, the realistic
//   reference is K5's own time on the same residues: the seeded
//   contraction does K5's work and hides the c0 and A streams under it,
//   with the key schedule computed once per thread and four independent
//   draws in flight per thread.  It replaces K5's write of c1 (0.94 GB),
//   the copy of c0 into a [nb*K, 2, L, N] stack (0.94 GB read and
//   written) and K2's read of the stack.
#include <cuda_runtime.h>
#include <stdint.h>

#include "modmath.cuh"
#include "threefry.cuh"

namespace {

constexpr int THREADS = 128;

struct DotArgs {
  uint32_t *out;      // [nb, 3, l, n]
  const uint32_t *A;  // [K, 2, LA, n]
  const uint32_t *B;  // ct_dot: [nb, K, 2, LB, n]; seeded: c0 [nb*K, LB, n]
  int K, nb, l, n, LA, LB;
  const uint32_t *qs, *qneg, *r1, *r2;  // per limb: q, -q^-1, R, R^2 mod q
  uint32_t seed, group;                 // seeded: the Threefry key
};

template <int V>
__device__ __forceinline__ void load(const uint32_t *p, uint32_t (&x)[V]) {
  if constexpr (V == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4 *>(p));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
    x[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store(uint32_t *p, const uint32_t (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint4 *>(p) = make_uint4(x[0], x[1], x[2], x[3]);
  } else {
    p[0] = x[0];
  }
}

// One thread's V coefficients c..c+V-1 of limb i (V = 1 or 4).  KT > 0:
// K == KT, a multiple of 4, and A is held in registers; KT == 0: K is
// p.K and A is streamed.
template <int KT, int V, bool SEEDED>
struct Dot {
  const DotArgs p;
  int K;
  size_t sa, sb, row;
  uint32_t q, qn, r1, r2;
  ThreefryKey key;
  uint32_t ar[KT > 0 ? KT : 1][2][V];

  __device__ __forceinline__ Dot(const DotArgs &args, int c, int i) : p(args), key{} {
    K = KT > 0 ? KT : p.K;
    sa = (size_t)p.LA * p.n;
    sb = (size_t)p.LB * p.n;
    row = (size_t)i * p.n + c;
    q = p.qs[i]; qn = p.qneg[i]; r1 = p.r1[i]; r2 = p.r2[i];
    if constexpr (SEEDED) key = threefry_key(p.seed, p.group);
    if constexpr (KT > 0) {
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        load<V>(p.A + (size_t)(2 * k) * sa + row, ar[k][0]);
        load<V>(p.A + (size_t)(2 * k + 1) * sa + row, ar[k][1]);
      }
    }
  }

  // the products of k0..k0+3 (with TAIL, those below K) of block blk into
  // the sums; without the guard the loads of all four may be issued first
  template <bool TAIL>
  __device__ __forceinline__ void group4(int blk, int k0, acc96 (&s0)[V],
                                         acc96 (&s1)[V], acc96 (&s2)[V]) {
    uint64_t t0[V], t1[V], u1[V], t2[V];
#pragma unroll
    for (int v = 0; v < V; ++v) t0[v] = t1[v] = u1[v] = t2[v] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + j;
      if (!TAIL || k < K) {
        uint32_t a0[V], a1[V], b0[V], b1[V];
        if constexpr (KT > 0) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            a0[v] = ar[k][0][v];
            a1[v] = ar[k][1][v];
          }
        } else {
          load<V>(p.A + (size_t)(2 * k) * sa + row, a0);
          load<V>(p.A + (size_t)(2 * k + 1) * sa + row, a1);
        }
        const size_t b = (size_t)blk * K + k;  // the ciphertext
        if constexpr (SEEDED) {
          load<V>(p.B + b * sb + row, b0);
          // counter (b*LB + i)*n + c mod 2^32 = row + b*(LB*n) in uint32
          const uint32_t idx = (uint32_t)row + (uint32_t)b * (uint32_t)sb;
#pragma unroll
          for (int v = 0; v < V; ++v)
            b1[v] = uniform_residue_keyed(key, idx + v, q, qn, r1, r2);
        } else {
          load<V>(p.B + 2 * b * sb + row, b0);
          load<V>(p.B + (2 * b + 1) * sb + row, b1);
        }
#pragma unroll
        for (int v = 0; v < V; ++v) {
          t0[v] = mad_wide(a0[v], b0[v], t0[v]);
          t1[v] = mad_wide(a0[v], b1[v], t1[v]);
          u1[v] = mad_wide(a1[v], b0[v], u1[v]);
          t2[v] = mad_wide(a1[v], b1[v], t2[v]);
        }
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      acc_fold(s0[v], t0[v]);
      acc_fold(s1[v], t1[v]);
      acc_fold(s1[v], u1[v]);
      acc_fold(s2[v], t2[v]);
    }
  }

  __device__ __forceinline__ void run() {
    const size_t so = (size_t)p.l * p.n;
    for (int blk = 0; blk < p.nb; ++blk) {
      acc96 s0[V], s1[V], s2[V];
#pragma unroll
      for (int v = 0; v < V; ++v) s0[v] = s1[v] = s2[v] = acc96{0, 0};
      if constexpr (KT > 0) {
#pragma unroll
        for (int k0 = 0; k0 < KT; k0 += 4)
          this->template group4<false>(blk, k0, s0, s1, s2);
      } else {
        const int k4 = K & ~3;
        for (int k0 = 0; k0 < k4; k0 += 4)
          this->template group4<false>(blk, k0, s0, s1, s2);
        if (k4 < K) this->template group4<true>(blk, k4, s0, s1, s2);
      }
      uint32_t o0[V], o1[V], o2[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        o0[v] = acc_redc(s0[v], q, qn, r1, r2);
        o1[v] = acc_redc(s1[v], q, qn, r1, r2);
        o2[v] = acc_redc(s2[v], q, qn, r1, r2);
      }
      uint32_t *o = p.out + (size_t)blk * 3 * so + row;
      store<V>(o, o0);
      store<V>(o + so, o1);
      store<V>(o + 2 * so, o2);
    }
  }
};

template <int KT, int V, bool SEEDED>
__device__ __forceinline__ void dot_body(const DotArgs &p) {
  const int c = (blockIdx.x * THREADS + threadIdx.x) * V;
  if (c >= p.n) return;
  Dot<KT, V, SEEDED>(p, c, blockIdx.y).run();
}

template <int KT, int V>
__global__ void __launch_bounds__(THREADS) ct_dot_kernel(const DotArgs p) {
  dot_body<KT, V, false>(p);
}

template <int KT>
__global__ void __launch_bounds__(THREADS) ct_dot_seeded_kernel(const DotArgs p) {
  dot_body<KT, 1, true>(p);
}

dim3 grid_of(const DotArgs &p, int V) {
  const int per = THREADS * V;
  return dim3((unsigned)((p.n + per - 1) / per), (unsigned)p.l);
}

template <int KT, int V>
void go(const DotArgs &p, cudaStream_t s) {
  ct_dot_kernel<KT, V><<<grid_of(p, V), THREADS, 0, s>>>(p);
}

template <int KT>
void go_seeded(const DotArgs &p, cudaStream_t s) {
  ct_dot_seeded_kernel<KT><<<grid_of(p, 1), THREADS, 0, s>>>(p);
}

bool aligned16(const void *x) { return ((uintptr_t)x & 15) == 0; }

}  // namespace

// A: [K, 2, LA, n]; B: [nb, K, 2, LB, n]; out: [nb, 3, l, n] with
// l <= min(LA, LB); qs/qneg/r1/r2 indexed by limb 0..l-1.  Residues below
// 2^31.
extern "C" int imtpu_ct_dot(void *out, const void *A, const void *B, int64_t K,
                            int64_t nb, int64_t l, int64_t n, int64_t LA,
                            int64_t LB, const void *qs, const void *qneg,
                            const void *r1, const void *r2, void *stream) {
  if (nb == 0 || l == 0) return 0;
  if (l > 65535) return (int)cudaErrorInvalidConfiguration;
  const DotArgs p{(uint32_t *)out, (const uint32_t *)A, (const uint32_t *)B,
                  (int)K, (int)nb, (int)l, (int)n, (int)LA, (int)LB,
                  (const uint32_t *)qs, (const uint32_t *)qneg,
                  (const uint32_t *)r1, (const uint32_t *)r2, 0u, 0u};
  const cudaStream_t s = (cudaStream_t)stream;
  // V > 1 loads need 16-byte aligned rows; the K = 32 kernel has V = 1
  const bool vec = n % 4 == 0 && aligned16(A) && aligned16(B) && aligned16(out);
  // A in registers at the measured shapes (HyDia K = 32, Blind-Match
  // K = 4); every other K streams A with B
  if (K == 32) go<32, 1>(p, s);
  else if (!vec) go<0, 1>(p, s);
  else if (K == 4) go<4, 4>(p, s);
  else go<0, 4>(p, s);
  return (int)cudaGetLastError();
}

// The contraction of A with the nb blocks of K ciphertexts (c0, c1) whose
// c0 is c0 [nb*K, L, n] and whose c1 is Threefry(seed, group) at counter
// (b*L + limb)*n + k mod 2^32, K5's stream over the store's L limbs; out
// [nb, 3, l, n], l <= min(LA, L).
extern "C" int imtpu_ct_dot_seeded(void *out, const void *A, const void *c0,
                                   int64_t K, int64_t nb, int64_t l, int64_t n,
                                   int64_t LA, int64_t L, const void *qs,
                                   const void *qneg, const void *r1,
                                   const void *r2, int64_t seed, int64_t group,
                                   void *stream) {
  if (nb == 0 || l == 0) return 0;
  if (l > 65535) return (int)cudaErrorInvalidConfiguration;
  const DotArgs p{(uint32_t *)out, (const uint32_t *)A, (const uint32_t *)c0,
                  (int)K, (int)nb, (int)l, (int)n, (int)LA, (int)L,
                  (const uint32_t *)qs, (const uint32_t *)qneg,
                  (const uint32_t *)r1, (const uint32_t *)r2,
                  (uint32_t)seed, (uint32_t)group};
  const cudaStream_t s = (cudaStream_t)stream;
  // A in registers at HyDia's K = 32 (n1 at dimension 512); HERS's
  // K = 512 and every other K stream A
  if (K == 32) go_seeded<32>(p, s);
  else go_seeded<0>(p, s);
  return (int)cudaGetLastError();
}
