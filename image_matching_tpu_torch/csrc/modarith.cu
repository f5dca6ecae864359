// K11: standalone residue arithmetic between the other kernels.
//
// Replaces image_matching_tpu/ops/modmath.py mod_add, mod_sub, mod_neg and
// mont_mul (:90-153) where the JAX package calls them outside the fused
// operations: ciphertext add/neg, add_scalar, mul_plain, mul_scalar and
// mul_scalar_int (ckks/context.py:643-732), eval_sum's add (:1134), and the
// modular sums of many rows (matching/senders.py:45 _mod_sum_rows: HyDia's
// giant steps, the faithful HERS sum, the membership sum of flags, the
// output accumulation of slot packing):
//   elementwise pass: out = a + b, a - b, -a or a * b * R^-1 mod q_i, with
//     b of a's shape, an [l, N] plane broadcast over the leading axes, or a
//     per-limb constant [l]; with a head of h components out of k, each
//     ciphertext's components past its first h pass through unchanged
//     (add_scalar's component 0, or the add of ciphertexts with unequal
//     component counts), over any number of ciphertexts, so no
//     concatenation is needed; a same-shape b then holds h components per
//     ciphertext;
//   row-sum pass: out = sum_r a[r] mod q_i over R rows, summed in 64 bits
//     (R < 2^32 rows of residues < 2^31 cannot overflow) and reduced once:
//     the same canonical residue as the JAX package's chain of mod_adds.
// Every caller works on a prefix of the chain: limbs 0..l-1.
//
// What bounds it on the H100: device memory, if the index arithmetic and
// the reduction stay off the critical path.  The elementwise pass reads
// one or two residues and writes one per element with at most one
// Montgomery product; the row sum reads R and writes one.
//
// Design: a 2-D grid.  blockIdx.y is the [l, N] block (ciphertext and
// component come from it with one 32-bit division per block), blockIdx.x
// with the thread covers the plane, V = 4 coefficients a thread (16-byte
// loads of a, of a same-shape or plane b, and of the rows; 16-byte
// stores); the limb is the thread's index shifted by log2(N / V), as N is
// a power of two.  The row sum splits the rows of a block's 32 vectors
// over its four warps and adds their partials in shared memory.  No 64-bit
// division and no `%` remain: the row sum reduces its 64-bit sum s = hi
// 2^32 + lo with two Montgomery products, mont(hi, R^2) + mont(lo, R) = hi
// 2^32 + lo mod q (each takes a factor below 2^32 and one below q).
// Pass-through components are plain 16-byte copies in the same launch.
// `a` and a same-shape `b` are read in place through a block stride, so a
// ciphertext dropped to fewer limbs (a view) is not copied.  An operand
// that is not 16-byte aligned (or a stride that is not a multiple of four)
// takes V = 1 in the same kernel.
#include <cuda_runtime.h>
#include <stdint.h>

#include "modmath.cuh"
#include "passgrid.cuh"

#define K11_THREADS 128
#define K11_SUM_WARPS (K11_THREADS / 32)
#define K11_MAX_GRID_Y 65535

enum { OP_ADD = 0, OP_SUB = 1, OP_NEG = 2, OP_MUL = 3 };
enum { B_SAME = 0, B_PLANE = 1, B_LIMB = 2 };

struct ArithArgs {
  uint32_t *out;
  const uint32_t *a, *b, *qs, *qneg;
  int64_t a_bstride, b_bstride;
  int kcomp, headk, B, plane_v, lg;  // plane_v = l n / V, lg = log2(n / V)
};

template <int V, int OP, int BM>
__global__ void __launch_bounds__(K11_THREADS) modarith_kernel(ArithArgs p) {
  const int j = blockIdx.x * K11_THREADS + threadIdx.x;  // V-vector of the plane
  if (j >= p.plane_v) return;
  const int e = j * V;
  const int limb = j >> p.lg;
  const size_t plane = (size_t)p.plane_v * V;
  for (int blk = blockIdx.y; blk < p.B; blk += gridDim.y) {
    const int ct = blk / p.kcomp, comp = blk - ct * p.kcomp;
    uint32_t x[V];
    ld_v<V>(p.a + blk * p.a_bstride + e, x);
    uint32_t *o = p.out + blk * plane + e;
    if (comp >= p.headk) {
      st_v<V>(o, x);
      continue;
    }
    const uint32_t q = __ldg(p.qs + limb);
    uint32_t y[V];
    if (OP != OP_NEG) {
      if (BM == B_SAME) {
        ld_v<V>(p.b + (int64_t)(ct * p.headk + comp) * p.b_bstride + e, y);
      } else if (BM == B_PLANE) {
        ld_v<V>(p.b + e, y);
      } else {
        const uint32_t c = __ldg(p.b + limb);
#pragma unroll
        for (int v = 0; v < V; ++v) y[v] = c;
      }
    }
    const uint32_t qn = OP == OP_MUL ? __ldg(p.qneg + limb) : 0u;
    uint32_t r[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (OP == OP_ADD)
        r[v] = mod_add(x[v], y[v], q);
      else if (OP == OP_SUB)
        r[v] = mod_sub(x[v], y[v], q);
      else if (OP == OP_NEG)
        r[v] = x[v] == 0u ? 0u : q - x[v];
      else
        r[v] = mont_mul(x[v], y[v], q, qn);
    }
    st_v<V>(o, r);
  }
}

// Each block sums 32 V-vectors of one [l, N] block: warp w of the
// K11_SUM_WARPS adds rows w, w + K11_SUM_WARPS, ... (four loads in flight
// a thread), and warp 0 adds the warps' 64-bit partials, reduces and
// stores.  Splitting the rows over the warps keeps many short blocks in
// flight where one thread per coefficient would loop over every row.
template <int V>
__global__ void __launch_bounds__(K11_THREADS)
    mod_sum_kernel(uint32_t *__restrict__ out, const uint32_t *__restrict__ a,
                   int64_t rstride, int R, int B, int plane_v, int lg,
                   const uint32_t *__restrict__ qs,
                   const uint32_t *__restrict__ qneg,
                   const uint32_t *__restrict__ r1,
                   const uint32_t *__restrict__ r2) {
  __shared__ uint64_t part[K11_SUM_WARPS - 1][32][V];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;  // V-vector of the plane
  const bool live = j < plane_v;
  const int e = j * V;
  const size_t plane = (size_t)plane_v * V;
  constexpr int W = K11_SUM_WARPS;
  for (int blk = blockIdx.y; blk < B; blk += gridDim.y) {
    uint64_t s[V];
#pragma unroll
    for (int v = 0; v < V; ++v) s[v] = 0;
    if (live) {
      const uint32_t *p = a + blk * plane + e;
      for (int r = w; r < R; r += 4 * W) {
        // four of the warp's rows, the loads past R predicated off, so a
        // warp's last rows are in flight together too
        uint32_t x[4][V];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (r + u * W < R) {
            ld_v<V>(p + (r + u * W) * rstride, x[u]);
          } else {
#pragma unroll
            for (int v = 0; v < V; ++v) x[u][v] = 0;
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < V; ++v) s[v] += x[u][v];
      }
    }
    if (w > 0) {
#pragma unroll
      for (int v = 0; v < V; ++v) part[w - 1][lane][v] = s[v];
    }
    __syncthreads();
    if (w == 0 && live) {
      const int limb = j >> lg;
      const uint32_t q = __ldg(qs + limb), qn = __ldg(qneg + limb);
      const uint32_t c1 = __ldg(r1 + limb), c2 = __ldg(r2 + limb);
      uint32_t o[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
#pragma unroll
        for (int u = 0; u < W - 1; ++u) s[v] += part[u][lane][v];
        // hi 2^32 + lo mod q: both products take a factor below 2^32 and
        // one below q, so each is exact
        o[v] = mod_add(mont_mul((uint32_t)(s[v] >> 32), c2, q, qn),
                       mont_mul((uint32_t)s[v], c1, q, qn), q);
      }
      st_v<V>(out + blk * plane + e, o);
    }
    __syncthreads();  // part is reused by the next block row
  }
}

static int log2_exact(int64_t x) {  // -1 unless x is a power of two
  if (x < 1 || (x & (x - 1)) != 0) return -1;
  int k = 0;
  while ((int64_t)1 << k < x) ++k;
  return k;
}

static dim3 k11_grid(int64_t plane_v, int64_t B) {
  return dim3((unsigned)((plane_v + K11_THREADS - 1) / K11_THREADS),
              (unsigned)(B < K11_MAX_GRID_Y ? B : K11_MAX_GRID_Y));
}

template <int V, int OP>
static void launch_op(const ArithArgs &p, int b_mode, dim3 grid, cudaStream_t s) {
  if (b_mode == B_SAME)
    modarith_kernel<V, OP, B_SAME><<<grid, K11_THREADS, 0, s>>>(p);
  else if (b_mode == B_PLANE)
    modarith_kernel<V, OP, B_PLANE><<<grid, K11_THREADS, 0, s>>>(p);
  else
    modarith_kernel<V, OP, B_LIMB><<<grid, K11_THREADS, 0, s>>>(p);
}

template <int V>
static void launch_arith(const ArithArgs &p, int op, int b_mode, dim3 grid,
                         cudaStream_t s) {
  if (op == OP_ADD)
    launch_op<V, OP_ADD>(p, b_mode, grid, s);
  else if (op == OP_SUB)
    launch_op<V, OP_SUB>(p, b_mode, grid, s);
  else if (op == OP_NEG)
    modarith_kernel<V, OP_NEG, B_SAME><<<grid, K11_THREADS, 0, s>>>(p);
  else
    launch_op<V, OP_MUL>(p, b_mode, grid, s);
}

// a: B blocks of [l, n] residues, block stride a_bstride; b (unused for
// neg): B / kcomp * headk blocks with stride b_bstride (b_mode 0), one
// [l, n] plane (b_mode 1) or [l] (b_mode 2); op 0 add, 1 sub, 2 neg, 3
// Montgomery product; out: [B, l, n], B = ciphertexts * kcomp blocks, the
// op applied to the first headk blocks of every kcomp (kcomp = headk = 1:
// all).  n is a power of two.
extern "C" int imtpu_modarith(void *out, const void *a, int64_t a_bstride,
                              const void *b, int64_t b_bstride, int64_t b_mode,
                              int64_t op, int64_t kcomp, int64_t headk,
                              int64_t B, int64_t l,
                              int64_t n, const void *qs, const void *qneg,
                              void *stream) {
  if (B * l * n == 0) return 0;
  if (op < 0 || op > 3 || b_mode < 0 || b_mode > 2 || kcomp < 1 || headk < 1 ||
      headk > kcomp || B % kcomp != 0 || log2_exact(n) < 0 ||
      l * n >= (int64_t)1 << 31 || (op != OP_NEG && b == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool vec = n % 4 == 0 && aligned16(out) && aligned16(a) &&
                   a_bstride % 4 == 0 &&
                   (op == OP_NEG || b_mode == B_LIMB ||
                    (aligned16(b) && (b_mode == B_PLANE || b_bstride % 4 == 0)));
  const int V = vec ? 4 : 1;
  const ArithArgs p{(uint32_t *)out, (const uint32_t *)a, (const uint32_t *)b,
                    (const uint32_t *)qs, (const uint32_t *)qneg, a_bstride,
                    b_bstride, (int)kcomp, (int)headk, (int)B,
                    (int)(l * n / V), log2_exact(n / V)};
  const dim3 grid = k11_grid(p.plane_v, B);
  if (vec)
    launch_arith<4>(p, (int)op, (int)b_mode, grid, (cudaStream_t)stream);
  else
    launch_arith<1>(p, (int)op, (int)b_mode, grid, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// a: R rows, each B contiguous blocks of [l, n], row stride rstride;
// out: [B, l, n] = their sum mod q (qneg = -q^-1 mod 2^32, r1 = R mod q,
// r2 = R^2 mod q, indexed by limb).  n is a power of two, R < 2^32.
extern "C" int imtpu_mod_sum(void *out, const void *a, int64_t rstride, int64_t R,
                             int64_t B, int64_t l, int64_t n, const void *qs,
                             const void *qneg, const void *r1, const void *r2,
                             void *stream) {
  if (B * l * n == 0) return 0;
  if (R < 1 || R >= (int64_t)1 << 31 || log2_exact(n) < 0 ||
      l * n >= (int64_t)1 << 31)
    return (int)cudaErrorInvalidValue;
  const bool vec = n % 4 == 0 && aligned16(out) && aligned16(a) && rstride % 4 == 0;
  const int V = vec ? 4 : 1;
  const int64_t plane_v = l * n / V;
  const dim3 grid((unsigned)((plane_v + 31) / 32),
                  (unsigned)(B < K11_MAX_GRID_Y ? B : K11_MAX_GRID_Y));
  if (vec)
    mod_sum_kernel<4><<<grid, K11_THREADS, 0, (cudaStream_t)stream>>>(
        (uint32_t *)out, (const uint32_t *)a, rstride, (int)R, (int)B,
        (int)plane_v, log2_exact(n / 4), (const uint32_t *)qs,
        (const uint32_t *)qneg, (const uint32_t *)r1, (const uint32_t *)r2);
  else
    mod_sum_kernel<1><<<grid, K11_THREADS, 0, (cudaStream_t)stream>>>(
        (uint32_t *)out, (const uint32_t *)a, rstride, (int)R, (int)B,
        (int)plane_v, log2_exact(n), (const uint32_t *)qs,
        (const uint32_t *)qneg, (const uint32_t *)r1, (const uint32_t *)r2);
  return (int)cudaGetLastError();
}
