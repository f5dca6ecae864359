// K1: negacyclic NTT over RNS limbs, forward and inverse.
//
// Replaces image_matching_tpu/ops/ntt.py NttPlan.fwd (:231) and
// NttPlan.inv (:260).  Same merged-twiddle wiring as host_ntt_fwd /
// host_ntt_inv (:294, :313): forward is Cooley-Tukey from natural order
// to bit-reversed evaluation order with twiddle psis[m + g] at stage m,
// group g; inverse is Gentleman-Sande with ipsis[h + g] and a final 1/N.
// All outputs are canonical residues, so the result is bit-identical to
// the JAX plan's (an exact transform over Z_q has one correct output);
// between stages the values are lazy (below).
//
// What bounds it on the H100: device memory for many rows (each row is
// read and written once, N * 4 B each way; the bound at 160 rows of 2^15
// is 0.014 ms), the integer pipes and the latency of a few dependent
// passes for few rows.  The main path launches it with 2 to several
// hundred rows: a rescale's top limb (2 rows), a query's keyswitch (14-40),
// the compare circuit's stacks of 16 scores (hundreds).  A design that
// gives each row one block leaves most of the 132 SMs idle below 132 rows
// and ran 15 barrier-separated radix-2 stages through shared memory.
//
// Design: a hierarchical two-pass transform, N = 2^a * 2^8.  Cooley-
// Tukey's first a stages (strides N/2 ... 256) only mix elements that
// share the low 8 index bits: the column pass gives each block 32 columns
// j and the 2^a elements j + i * 256 of each; then the row falls apart
// into 2^a contiguous sub-blocks of 256, and the row pass gives each warp
// one sub-block for the last 8 stages.  The inverse runs the mirror: rows
// first, columns last, 1/N folded into the last store.
//   - Many small blocks per row (2^a/4 row-pass blocks and 8 column-pass
//     blocks at N = 2^15) fill the card from a few rows on.
//   - Every butterfly runs in registers.  A column-pass thread holds
//     2^ceil(a/2) elements through ceil(a/2) stages, exchanges them once
//     through shared memory (lanes on consecutive columns: no bank
//     conflict) and runs the other floor(a/2).  A row-pass lane holds 8
//     elements through 3 stages at a time and the warp regroups them
//     twice through its own swizzled 1 KiB of shared memory (every access
//     on 32 distinct banks, a __syncwarp each way).  One barrier per row
//     pass (the twiddles), two per column pass: 3 where one block per row
//     had 15.
//   - Twiddles with their Shoup companions are staged once per block into
//     shared memory (the 2^a - 1 the column pass needs; 255 per sub-block
//     for the row pass) and read from there: no global twiddle load
//     inside a butterfly loop.
//   - Between the passes each row makes one round trip through `out`,
//     which at the main path's row counts stays mostly in the 50 MB L2.
//     Neither pass needs more than 48 KiB of shared memory, so no kernel
//     attribute is set on any path.
// What is left: the integer pipes, which the lazy residues below relieve.
//
// Lazy residues (Harvey's butterfly).  Every value a butterfly reads or
// writes lies in [0, 2q), which 32 bits hold because every modulus is
// below 2^31 (ops/ntt.py NttPlan refuses more):
//   - shoup_lazy drops the Shoup product's correction: a w - hi q, hi =
//     floor(a wsh / 2^32), falls short of a w / q by less than 2, so it
//     lies in [0, 2q) for any a < 2^32;
//   - Cooley-Tukey reduces u and t = v w once each into [0, q) (red: one
//     subtraction and a min) and writes u + t and u - t + q, both in
//     [0, 2q); Gentleman-Sande reduces u and v and writes u + v and the
//     lazy product of u - v + q; mul2's inner product stays below 2q,
//     which its outer product takes;
//   - red is min(x, x - q), one VIADDMNMX on sm_90a.  A butterfly is
//     now the Shoup product's IMAD.HI and two IMADs, two VIADDMNMX and
//     two adds; with modmath.cuh's full reductions (shoup_mul, mod_sub,
//     mod_add) it was the same three products, three ISETP + SEL pairs
//     and about four adds.  In SASS (nvcc 12.8) the forward column pass
//     at N = 2^15 (56 butterflies a thread) runs 1,048 instructions a
//     thread where it ran 1,368, 5.7 fewer a butterfly, 3.7 of them on
//     the ALU pipe (647 -> 439); the batched row pass 928 and 944 (forward,
//     inverse) where it ran 1,112 and 1,128.
// Values become canonical again where a transform ends: the forward row
// pass reduces its outputs once before its store, and the inverse's 1/N
// is the full shoup_mul.  Inside one imtpu_ntt call the rows' round trip
// through `out` between the passes carries [0, 2q) values, which nothing
// else reads.  Each pass that imtpu_ntt_pass runs alone ends canonical
// (Args::canon): a slot shard's all-to-all between the passes carries
// plain residues, and the entry point, not a setting, decides.
//
// The row pass, a block a row (ntt_rows_kernel), is bound by the
// instructions it issues, not its bytes: it moves what the column pass
// moves but took 1.4x as long per stage (H100 SXM, 900 rows of 2^15: 0.147
// ms for 8 stages against 0.092 for 7), ~100 instructions an element
// against ~60.  Its excess: a second Shoup product in stages 5-7, a third
// relayout, and 252 twiddles staged behind a barrier for each 1,024 words.
// Where a launch holds each limb in several batch rows (the main path's
// ModUps, mod-downs and compare stacks), ntt_rows_batch_kernel takes the
// row pass instead: a block walks R' batch rows of one limb and stages its
// tile's twiddles once for them, all 255 of each sub-block, so every stage
// takes one staged twiddle and one Shoup product; a row makes two
// relayouts, its edge layout moved as 16-byte accesses, and row b + 1's
// loads are issued before row b's butterflies.  At 900 rows it runs 0.110
// ms, 1.05x the column pass per stage.  ntt_rows_kernel stays for launches
// of one batch row or too few blocks, and for the slot shards.
//
// The first pass's loads take a batch stride, so a slice of limbs (the top
// limb of a rescale, the special limbs of a mod-down) is read in place, and
// an optional permutation perm[x] of the input: the Galois automorphism
// gather of image_matching_tpu/ckks/context.py _permute (:976) fused into
// the inverse NTT that starts a rotation's key switch.
//
// A slot shard (parallel/tensor.py: shard s of D holds positions
// [s N/D, (s+1) N/D) of every row) runs the two passes alone through
// imtpu_ntt_pass, with an all-to-all between them:
//   - the column pass over a column subset: shard s's [2^a, 256/D] block
//     (columns s 256/D ... and all 2^a elements of each), rows 2^logw =
//     N/D wide, column stride 2^(logw - a); its twiddles depend only on
//     the element index i, so they need no offset;
//   - the row pass over the shard's own 2^(logw - 8) sub-blocks, whose
//     twiddles take the global sub-block index (local + blk_off);
//   - a source limb stride apart from the row width, so the inverse's row
//     pass gathers a rotation from the all-gathered full-width source
//     (perm rows of the shard's own slots, holding global indices).
#include <cuda_runtime.h>
#include <stdint.h>

#include "modmath.cuh"

namespace {

constexpr int kMaxRowBits = 8;  // b: a row-pass warp holds 2^8 elements

// Shared-memory twiddles of one block: for v = 0..K-1, the (SB << v)
// entries from table index (1 << (P + v)) + (blk0 << v) on, at offset
// ((1 << v) - 1) << lsb (SB = 1 << lsb sub-transforms per block).
__device__ __forceinline__ void stage_twiddles(uint2 *stw,
                                               const uint32_t *__restrict__ w,
                                               const uint32_t *__restrict__ wsh,
                                               int P, int K, int lsb, int blk0) {
  const int total = ((1 << K) - 1) << lsb;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int v = 31 - __clz((e >> lsb) + 1);
    const int g = (1 << (P + v)) + (blk0 << v) + e - (((1 << v) - 1) << lsb);
    stw[e] = make_uint2(__ldg(w + g), __ldg(wsh + g));
  }
}

// The lazy residues (see the top of this file): every value a butterfly
// reads or writes lies in [0, 2q).  x mod q for x < 2q: x - q wraps above
// x when x < q.
__device__ __forceinline__ uint32_t red(uint32_t x, uint32_t q) { return min(x, x - q); }

// a * w mod q or that plus q, for any a < 2^32: Shoup's product without
// its correction (the quotient hi falls short of a w / q by less than 2).
__device__ __forceinline__ uint32_t shoup_lazy(uint32_t a, uint32_t w, uint32_t wsh,
                                               uint32_t q) {
  return a * w - __umulhi(a, wsh) * q;
}

// Cooley-Tukey: (u, v) -> (u + t, u - t) with t = v w, up to multiples of q.
__device__ __forceinline__ void ct_t(uint32_t &u, uint32_t &v, uint32_t t, uint32_t q) {
  t = red(t, q);
  u = red(u, q);
  v = u - t + q;
  u += t;
}
__device__ __forceinline__ void ct(uint32_t &u, uint32_t &v, uint2 w, uint32_t q) {
  ct_t(u, v, shoup_lazy(v, w.x, w.y, q), q);
}

// Gentleman-Sande: (u, v) -> (u + v, (u - v) w); returns u - v + q.
__device__ __forceinline__ uint32_t gs_d(uint32_t &u, uint32_t v, uint32_t q) {
  u = red(u, q);
  v = red(v, q);
  const uint32_t d = u - v + q;
  u += v;
  return d;
}
__device__ __forceinline__ void gs(uint32_t &u, uint32_t &v, uint2 w, uint32_t q) {
  v = shoup_lazy(gs_d(u, v, q), w.x, w.y, q);
}

// The same with the twiddle w = t * c given as two factors (each with its
// Shoup companion): psis[x | y] = psis[x] * psis[y] for disjoint bits,
// because the exponent brv(x | y) = brv(x) + brv(y).  The inner product
// stays below 2q, which the outer takes as any a < 2^32.
__device__ __forceinline__ uint32_t mul2(uint32_t x, uint2 t, uint2 c, uint32_t q) {
  return shoup_lazy(shoup_lazy(x, t.x, t.y, q), c.x, c.y, q);
}
__device__ __forceinline__ void ct2(uint32_t &u, uint32_t &v, uint2 t, uint2 c, uint32_t q) {
  ct_t(u, v, mul2(v, t, c, q), q);
}
__device__ __forceinline__ void gs2(uint32_t &u, uint32_t &v, uint2 t, uint2 c, uint32_t q) {
  v = mul2(gs_d(u, v, q), t, c, q);
}

// A pass's outputs: x[r] / N where the inverse ends (`div`), canonical
// where `canon` asks, else left in [0, 2q).
template <int E>
__device__ __forceinline__ void finish(uint32_t (&x)[E], bool div, bool canon,
                                       const uint32_t *ninv, const uint32_t *ninv_sh, int limb,
                                       uint32_t q) {
  if (div) {
    const uint32_t ni = ninv[limb], nish = ninv_sh[limb];
#pragma unroll
    for (int r = 0; r < E; ++r) x[r] = shoup_mul(x[r], ni, nish, q);
  } else if (canon) {
#pragma unroll
    for (int r = 0; r < E; ++r) x[r] = red(x[r], q);
  }
}

// Row pass over contiguous sub-blocks of 256 elements: the last 8 stages
// of the forward transform or the first 8 of the inverse.  Block (row,
// tile) holds SB = 1 << lsb sub-blocks, one per warp.  A warp moves its
// sub-block between three register layouts through its own 1 KiB of
// shared memory (a __syncwarp each way), so every stage runs in registers:
//   A: x[r] is element (r << 5) | l              (bits 7..5 in registers)
//   B: x[k] is element (l >> 2) << 5 | k << 2 | (l & 3)   (bits 4..2)
//   C: x[g * 4 + k] is element g << 7 | l << 2 | k   (bits 1..0, and 7)
// for lane l.  Word i of the warp's block lies at swz(i), which puts the
// 32 lanes of every layout's access on 32 distinct banks.  Table blocks
// v < 5 (31 twiddles per sub-block) are staged; a twiddle of blocks 5-7,
// psis[(1 << (a + v)) + (blk << v) + g] with g < 2^v, is the product of
// the sub-block's factor c_v = psis[(1 << (a + v)) + (blk << v)] (held in
// registers) and psis[g] (128 entries staged once per block, shared by its
// sub-blocks): a second Shoup product per butterfly in place of 224 staged
// twiddles per sub-block.
__device__ __forceinline__ int swz(int i) {
  const int h = (i >> 5) & 7;
  return i ^ (h << 2) ^ (h & 3);
}
enum { LAY_A, LAY_B, LAY_C };

template <int LAY>
__device__ __forceinline__ int lay(int e, int l) {
  if constexpr (LAY == LAY_A) return (e << 5) | l;
  if constexpr (LAY == LAY_B) return ((l >> 2) << 5) | (e << 2) | (l & 3);
  return ((e >> 2) << 7) | (l << 2) | (e & 3);
}

template <int FROM, int TO>
__device__ __forceinline__ void relayout(uint32_t (&x)[8], uint32_t *s, int l) {
#pragma unroll
  for (int e = 0; e < 8; ++e) s[swz(lay<FROM>(e, l))] = x[e];
  __syncwarp();
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e] = s[swz(lay<TO>(e, l))];
  __syncwarp();
}

template <bool INV>
__global__ void __launch_bounds__(128)
    ntt_rows_kernel(uint32_t *__restrict__ out, const uint32_t *__restrict__ in,
                    int64_t in_bstride, int64_t in_lstride,
                    const int32_t *__restrict__ perm, int64_t perm_bstride,
                    int first, int last, int canon, const int32_t *__restrict__ limb_idx,
                    int L, int logn, int logw, int blk_off, int lsb,
                    const uint32_t *__restrict__ tw,
                    const uint32_t *__restrict__ tw_sh,
                    const uint32_t *__restrict__ qs,
                    const uint32_t *__restrict__ ninv,
                    const uint32_t *__restrict__ ninv_sh) {
  constexpr int B = kMaxRowBits, KS = 5, NT = 1 << (B - 1);
  // staged twiddles of blocks v < KS (31 << lsb), psis[0..NT), then data
  extern __shared__ uint2 stw[];
  // n: the transform (twiddle rows); w: the rows of in and out; sub-block
  // blk0 + warp of the row is sub-block gblk0 + warp of the transform
  const int n = 1 << logn, w = 1 << logw, a = logn - B;
  const size_t row = blockIdx.x;
  const int li = (int)(row % L), limb = limb_idx[li];
  const size_t bi = row / L;
  const uint32_t q = qs[limb];
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int blk0 = blockIdx.y << lsb, gblk0 = blk0 + blk_off;
  const int base = (blk0 + warp) << B;
  const uint2 *tt = stw + (((1 << KS) - 1) << lsb);
  uint32_t *s = reinterpret_cast<uint32_t *>(stw + (((1 << KS) - 1) << lsb) + NT) + (warp << B);
  uint32_t x[8];
  if (first) {
    const uint32_t *src = in + bi * in_bstride + (size_t)li * in_lstride;
    if (perm) {
      const int32_t *pr = perm + bi * perm_bstride;
#pragma unroll
      for (int r = 0; r < 8; ++r) x[r] = src[pr[base + lay<LAY_A>(r, l)]];
    } else {
#pragma unroll
      for (int r = 0; r < 8; ++r) x[r] = src[base + lay<LAY_A>(r, l)];
    }
  } else {
    const uint32_t *src = out + row * w;
#pragma unroll
    for (int r = 0; r < 8; ++r) x[r] = src[base + lay<LAY_A>(r, l)];
  }
  const uint32_t *wl = tw + (size_t)limb * n, *wshl = tw_sh + (size_t)limb * n;
  stage_twiddles(stw, wl, wshl, a, KS, lsb, gblk0);
  for (int g = threadIdx.x; g < NT; g += blockDim.x)
    stw[(((1 << KS) - 1) << lsb) + g] = make_uint2(__ldg(wl + g), __ldg(wshl + g));
  uint2 c[B - KS];  // c[v - KS], v = 5..7
#pragma unroll
  for (int v = KS; v < B; ++v) {
    const int e = (1 << (a + v)) + ((gblk0 + warp) << v);
    c[v - KS] = make_uint2(__ldg(wl + e), __ldg(wshl + e));
  }
  __syncthreads();
  // the staged twiddles of table block v < KS (stage v forward, B-1-v inverse)
#define TWB(v) (stw + ((((1 << (v)) - 1) << lsb) + (warp << (v))))
  if (!INV) {
    // stage ul pairs index bit 7-ul; its twiddle group is index >> (8-ul)
#pragma unroll
    for (int u = 0; u < 3; ++u) {  // bits 7..5, layout A
      const uint2 *w = TWB(u);
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (!(r & (4 >> u))) ct(x[r], x[r + (4 >> u)], w[r >> (3 - u)], q);
    }
    relayout<LAY_A, LAY_B>(x, s, l);
#pragma unroll
    for (int u = 0; u < 3; ++u) {  // bits 4..2, layout B; blocks 3, 4 staged, 5 a product
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (!(k & (4 >> u))) {
          const int g = ((l >> 2) << u) | (k >> (3 - u));
          if (u < 2)
            ct(x[k], x[k + (4 >> u)], TWB(3 + u)[g], q);
          else
            ct2(x[k], x[k + (4 >> u)], tt[g], c[0], q);
        }
    }
    relayout<LAY_B, LAY_C>(x, s, l);
#pragma unroll
    for (int u = 0; u < 2; ++u) {  // bits 1..0, layout C; blocks 6, 7 as products
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (!(e & (2 >> u)))
          ct2(x[e], x[e + (2 >> u)], tt[((e >> 2) << (5 + u)) | (l << u) | ((e & 3) >> (2 - u))],
              c[1 + u], q);
    }
    relayout<LAY_C, LAY_A>(x, s, l);
  } else {
    // stage ul pairs index bit ul; its twiddle group is index >> (ul+1),
    // its table block v = 7-ul
    relayout<LAY_A, LAY_C>(x, s, l);
#pragma unroll
    for (int ul = 0; ul < 2; ++ul) {  // bits 0..1, layout C; blocks 7, 6 as products
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (!(e & (1 << ul)))
          gs2(x[e], x[e + (1 << ul)],
              tt[((e >> 2) << (6 - ul)) | (l << (1 - ul)) | ((e & 3) >> (ul + 1))], c[2 - ul], q);
    }
    relayout<LAY_C, LAY_B>(x, s, l);
#pragma unroll
    for (int ul = 2; ul < 5; ++ul) {  // bits 2..4, layout B; block 5 a product, 4, 3 staged
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (!(k & (1 << (ul - 2)))) {
          const int g = ((l >> 2) << (4 - ul)) | (k >> (ul - 1));
          if (ul == 2)
            gs2(x[k], x[k + 1], tt[g], c[0], q);
          else
            gs(x[k], x[k + (1 << (ul - 2))], TWB(7 - ul)[g], q);
        }
    }
    relayout<LAY_B, LAY_A>(x, s, l);
#pragma unroll
    for (int ul = 5; ul < 8; ++ul) {  // bits 5..7, layout A
      const uint2 *w = TWB(7 - ul);
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (!(r & (1 << (ul - 5)))) gs(x[r], x[r + (1 << (ul - 5))], w[r >> (ul - 4)], q);
    }
  }
#undef TWB
  finish(x, INV && last, !INV || canon, ninv, ninv_sh, limb, q);
  uint32_t *dst = out + row * w;
#pragma unroll
  for (int r = 0; r < 8; ++r) dst[base + lay<LAY_A>(r, l)] = x[r];
}

// Layout C's eight elements of the sub-block at p (x[g * 4 + k] = p[g << 7
// | l << 2 | k]): two 16-byte accesses a lane where p is 16-byte aligned.
__device__ __forceinline__ void load_c(uint32_t (&x)[8], const uint32_t *p, int l) {
  p += l << 2;
  if (!(reinterpret_cast<uintptr_t>(p) & 15)) {
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const uint4 v = *reinterpret_cast<const uint4 *>(p + (g << 7));
      x[g * 4] = v.x, x[g * 4 + 1] = v.y, x[g * 4 + 2] = v.z, x[g * 4 + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = p[((e >> 2) << 7) | (e & 3)];
  }
}

__device__ __forceinline__ void store_c(uint32_t *p, const uint32_t (&x)[8], int l) {
  p += l << 2;
  if (!(reinterpret_cast<uintptr_t>(p) & 15)) {
#pragma unroll
    for (int g = 0; g < 2; ++g)
      *reinterpret_cast<uint4 *>(p + (g << 7)) =
          make_uint4(x[g * 4], x[g * 4 + 1], x[g * 4 + 2], x[g * 4 + 3]);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) p[((e >> 2) << 7) | (e & 3)] = x[e];
  }
}

// The batched row pass (imtpu_ntt with rb > 1), for launches that hand K1
// the same limb in many batch rows.  Block (row group, limb; tile) walks
// batch rows b0 .. b0 + rb of one limb, so it stages the tile's twiddles
// once for rb rows, and stages all 255 of each sub-block (table blocks v =
// 0..7, psis[(1 << (a + v)) + (blk << v) + g]): every stage takes one
// staged twiddle and one Shoup product.  A row makes two relayouts where
// ntt_rows_kernel makes three: the forward loads layout A and stores
// layout C, the inverse loads C (through perm: its indices as C) and
// stores A, C's four consecutive elements a lane one 16-byte access.  Row
// b + 1's loads are issued before row b's butterflies.
template <bool INV>
__global__ void __launch_bounds__(128)
    ntt_rows_batch_kernel(uint32_t *__restrict__ out, const uint32_t *__restrict__ in,
                          int64_t in_bstride, const int32_t *__restrict__ perm,
                          int64_t perm_bstride, int first, int last,
                          const int32_t *__restrict__ limb_idx, int L, int batch, int rb,
                          int logn, int lsb, const uint32_t *__restrict__ tw,
                          const uint32_t *__restrict__ tw_sh,
                          const uint32_t *__restrict__ qs,
                          const uint32_t *__restrict__ ninv,
                          const uint32_t *__restrict__ ninv_sh) {
  constexpr int B = kMaxRowBits;
  extern __shared__ uint2 stw[];  // staged twiddles of blocks v < 8 (255 << lsb), then data
  const int n = 1 << logn, a = logn - B;
  const int li = (int)(blockIdx.x % L), limb = limb_idx[li];
  const int b0 = (int)(blockIdx.x / L) * rb, b1 = min(b0 + rb, batch);
  const uint32_t q = qs[limb];
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int blk0 = blockIdx.y << lsb, base = (blk0 + warp) << B;
  uint32_t *s = reinterpret_cast<uint32_t *>(stw + (((1 << B) - 1) << lsb)) + (warp << B);
  // the sub-block of batch row b: its input, and where it goes
  auto src = [&](int b) {
    return first ? in + (size_t)b * in_bstride + (size_t)li * n + base
                 : out + ((size_t)b * L + li) * n + base;
  };
  auto load = [&](uint32_t(&x)[8], int b) {
    const uint32_t *p = src(b);
    if (INV) {  // the first pass: layout C
      if (perm) {
        uint32_t idx[8];
        load_c(idx, reinterpret_cast<const uint32_t *>(perm + (size_t)b * perm_bstride + base), l);
        p -= base;
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = p[idx[e]];
      } else {
        load_c(x, p, l);
      }
    } else if (first && perm) {  // N = 2^8: the row pass is the forward's first
      const int32_t *pr = perm + (size_t)b * perm_bstride + base;
      p -= base;
#pragma unroll
      for (int r = 0; r < 8; ++r) x[r] = p[pr[lay<LAY_A>(r, l)]];
    } else {
#pragma unroll
      for (int r = 0; r < 8; ++r) x[r] = p[lay<LAY_A>(r, l)];
    }
  };
  uint32_t x[8], y[8] = {};
  load(x, b0);
  stage_twiddles(stw, tw + (size_t)limb * n, tw_sh + (size_t)limb * n, a, B, lsb, blk0);
  __syncthreads();
  // the staged twiddles of table block v of this warp's sub-block
#define TWB(v) (stw + ((((1 << (v)) - 1) << lsb) + (warp << (v))))
  for (int b = b0; b < b1; ++b) {
    if (b + 1 < b1) load(y, b + 1);
    uint32_t *dst = out + ((size_t)b * L + li) * n + base;
    if (!INV) {
      // stage v pairs index bit 7-v; its twiddle group is index >> (8-v)
#pragma unroll
      for (int v = 0; v < 3; ++v) {  // bits 7..5, layout A
        const uint2 *w = TWB(v);
#pragma unroll
        for (int r = 0; r < 8; ++r)
          if (!(r & (4 >> v))) ct(x[r], x[r + (4 >> v)], w[r >> (3 - v)], q);
      }
      relayout<LAY_A, LAY_B>(x, s, l);
#pragma unroll
      for (int u = 0; u < 3; ++u) {  // bits 4..2, layout B: blocks 3..5
        const uint2 *w = TWB(3 + u) + ((l >> 2) << u);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (!(k & (4 >> u))) ct(x[k], x[k + (4 >> u)], w[k >> (3 - u)], q);
      }
      relayout<LAY_B, LAY_C>(x, s, l);
#pragma unroll
      for (int u = 0; u < 2; ++u) {  // bits 1..0, layout C: blocks 6, 7
        const uint2 *w = TWB(6 + u) + (l << u);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (!(e & (2 >> u)))
            ct(x[e], x[e + (2 >> u)], w[((e >> 2) << (5 + u)) | ((e & 3) >> (2 - u))], q);
      }
      finish(x, false, true, ninv, ninv_sh, limb, q);
      store_c(dst, x, l);
    } else {
      // stage ul pairs index bit ul; its twiddle group is index >> (ul+1),
      // its table block v = 7-ul
#pragma unroll
      for (int ul = 0; ul < 2; ++ul) {  // bits 0..1, layout C: blocks 7, 6
        const uint2 *w = TWB(7 - ul) + (l << (1 - ul));
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (!(e & (1 << ul)))
            gs(x[e], x[e + (1 << ul)], w[((e >> 2) << (6 - ul)) | ((e & 3) >> (ul + 1))], q);
      }
      relayout<LAY_C, LAY_B>(x, s, l);
#pragma unroll
      for (int ul = 2; ul < 5; ++ul) {  // bits 2..4, layout B: blocks 5..3
        const uint2 *w = TWB(7 - ul) + ((l >> 2) << (4 - ul));
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (!(k & (1 << (ul - 2)))) gs(x[k], x[k + (1 << (ul - 2))], w[k >> (ul - 1)], q);
      }
      relayout<LAY_B, LAY_A>(x, s, l);
#pragma unroll
      for (int ul = 5; ul < 8; ++ul) {  // bits 5..7, layout A: blocks 2..0
        const uint2 *w = TWB(7 - ul);
#pragma unroll
        for (int r = 0; r < 8; ++r)
          if (!(r & (1 << (ul - 5)))) gs(x[r], x[r + (1 << (ul - 5))], w[r >> (ul - 4)], q);
      }
      finish(x, last, false, ninv, ninv_sh, limb, q);
#pragma unroll
      for (int r = 0; r < 8; ++r) dst[lay<LAY_A>(r, l)] = x[r];
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) x[r] = y[r];
  }
#undef TWB
}

// Column pass over the 2^A elements j + i * 2^b of 32 columns j per block,
// b = logw - A (8 for a whole row; fewer for a shard's column subset):
// the first A stages of the forward transform (reading `in`, the first
// pass) or the last A of the inverse (reading `out`, scaling by 1/N).
// Thread (c, tc), tc < 2^R2, holds 2^R1 elements, R1 + R2 = A, R1 - R2 in
// {0, 1}, in one of two layouts:
//   A: x[k] is element i = (k << R2) | tc          (the high index bits)
//   B: x[g * 2^R2 + k2] is i = ((tc * G + g) << R2) | k2, G = 2^(R1-R2)
template <bool INV, int R1, int R2>
__global__ void ntt_cols_kernel(uint32_t *__restrict__ out,
                                const uint32_t *__restrict__ in,
                                int64_t in_bstride, int64_t in_lstride,
                                const int32_t *__restrict__ perm,
                                int64_t perm_bstride,
                                const int32_t *__restrict__ limb_idx, int L,
                                int logn, int logw, int canon,
                                const uint32_t *__restrict__ tw,
                                const uint32_t *__restrict__ tw_sh,
                                const uint32_t *__restrict__ qs,
                                const uint32_t *__restrict__ ninv,
                                const uint32_t *__restrict__ ninv_sh) {
  constexpr int A = R1 + R2, E = 1 << R1, K2 = 1 << R2, G = 1 << (R1 - R2);
  extern __shared__ uint2 stw[];  // 2^A - 1 twiddles, then [2^A][32] data
  uint32_t *sdat = reinterpret_cast<uint32_t *>(stw + ((1 << A) - 1));
  const int n = 1 << logn, b = logw - A;
  const size_t row = blockIdx.x;
  const int li = (int)(row % L), limb = limb_idx[li];
  const size_t bi = row / L;
  const uint32_t q = qs[limb];
  const int c = threadIdx.x & 31, tc = threadIdx.x >> 5;
  const int j = (blockIdx.y << 5) + c;
  uint32_t x[E];
  stage_twiddles(stw, tw + (size_t)limb * n, tw_sh + (size_t)limb * n, 0, A, 0, 0);
  uint32_t *dst = out + row * ((size_t)1 << logw);
  if (!INV) {
    const uint32_t *src = in + bi * in_bstride + (size_t)li * in_lstride;
    const int32_t *pr = perm ? perm + bi * perm_bstride : nullptr;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int idx = j + (((k << R2) | tc) << b);
      x[k] = pr ? src[pr[idx]] : src[idx];
    }
    __syncthreads();
    // global stage u pairs bit A-1-u of i; its twiddle group is i >> (A-u)
#pragma unroll
    for (int u = 0; u < R1; ++u) {
      const int h = E >> (u + 1);
      const uint2 *w = stw + ((1 << u) - 1);
#pragma unroll
      for (int k = 0; k < E; ++k)
        if (!(k & h)) ct(x[k], x[k + h], w[k >> (R1 - u)], q);
    }
    if constexpr (R2 > 0) {
#pragma unroll
      for (int k = 0; k < E; ++k) sdat[(((k << R2) | tc) << 5) + c] = x[k];
      __syncthreads();
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int k2 = 0; k2 < K2; ++k2)
          x[g * K2 + k2] = sdat[((((tc * G + g) << R2) | k2) << 5) + c];
#pragma unroll
      for (int u = 0; u < R2; ++u) {
        const int h = K2 >> (u + 1);
        const uint2 *w = stw + ((1 << (R1 + u)) - 1);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int k2 = 0; k2 < K2; ++k2)
            if (!(k2 & h))
              ct(x[g * K2 + k2], x[g * K2 + k2 + h],
                 w[((tc * G + g) << u) | (k2 >> (R2 - u))], q);
      }
      finish(x, false, canon, ninv, ninv_sh, limb, q);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int k2 = 0; k2 < K2; ++k2)
          dst[j + ((((tc * G + g) << R2) | k2) << b)] = x[g * K2 + k2];
    } else {
      finish(x, false, canon, ninv, ninv_sh, limb, q);
#pragma unroll
      for (int k = 0; k < E; ++k) dst[j + (((k << R2) | tc) << b)] = x[k];
    }
  } else {
    // local stage u pairs bit u of i; its twiddle group is i >> (u+1), its
    // table block v = A-1-u
    if constexpr (R2 > 0) {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int k2 = 0; k2 < K2; ++k2)
          x[g * K2 + k2] = dst[j + ((((tc * G + g) << R2) | k2) << b)];
      __syncthreads();
#pragma unroll
      for (int u = 0; u < R2; ++u) {
        const int h = 1 << u;
        const uint2 *w = stw + ((1 << (A - 1 - u)) - 1);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int k2 = 0; k2 < K2; ++k2)
            if (!(k2 & h))
              gs(x[g * K2 + k2], x[g * K2 + k2 + h],
                 w[((tc * G + g) << (R2 - u - 1)) | (k2 >> (u + 1))], q);
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int k2 = 0; k2 < K2; ++k2)
          sdat[((((tc * G + g) << R2) | k2) << 5) + c] = x[g * K2 + k2];
      __syncthreads();
#pragma unroll
      for (int k = 0; k < E; ++k) x[k] = sdat[(((k << R2) | tc) << 5) + c];
    } else {
#pragma unroll
      for (int k = 0; k < E; ++k) x[k] = dst[j + (((k << R2) | tc) << b)];
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < R1; ++u) {
      const int h = 1 << u;
      const uint2 *w = stw + ((1 << (R1 - 1 - u)) - 1);
#pragma unroll
      for (int k = 0; k < E; ++k)
        if (!(k & h)) gs(x[k], x[k + h], w[k >> (u + 1)], q);
    }
    finish(x, true, true, ninv, ninv_sh, limb, q);
#pragma unroll
    for (int k = 0; k < E; ++k) dst[j + (((k << R2) | tc) << b)] = x[k];
  }
}

struct Args {
  uint32_t *out;
  const uint32_t *in;
  int64_t in_bstride, in_lstride;
  const int32_t *perm;
  int64_t perm_bstride;
  const int32_t *limb_idx;
  unsigned rows;
  int L, logn, logw, blk_off;
  const uint32_t *tw, *tw_sh, *qs, *ninv, *ninv_sh;
  cudaStream_t st;
  int rb;     // batch rows a block of the batched row pass walks (imtpu_ntt)
  int canon;  // a pass alone (imtpu_ntt_pass): canonical outputs
};

template <bool INV>
void rows_pass(const Args &g, int first, int last) {
  constexpr int B = kMaxRowBits, KS = 5, NT = 1 << (B - 1);
  // sub: log2 of the row's sub-blocks; 2^lsb of them a block, at most 4
  const int sub = g.logw - B;
  const int lsb = sub < 2 ? sub : 2;
  const dim3 grid(g.rows, 1u << (sub - lsb));
  const size_t smem = ((size_t)(((1 << KS) - 1) << lsb) + NT) * sizeof(uint2) +
                      ((size_t)1 << (B + lsb)) * sizeof(uint32_t);
  ntt_rows_kernel<INV><<<grid, 32 << lsb, smem, g.st>>>(
      g.out, g.in, g.in_bstride, g.in_lstride, g.perm, g.perm_bstride, first, last, g.canon,
      g.limb_idx, g.L, g.logn, g.logw, g.blk_off, lsb, g.tw, g.tw_sh, g.qs, g.ninv,
      g.ninv_sh);
}

template <bool INV>
void rows_batch_pass(const Args &g, int first, int last) {
  constexpr int B = kMaxRowBits;
  const int sub = g.logn - B, lsb = sub < 2 ? sub : 2;
  const unsigned batch = g.rows / g.L, groups = (batch + g.rb - 1) / g.rb;
  const dim3 grid(groups * g.L, 1u << (sub - lsb));
  const size_t smem = ((size_t)((1 << B) - 1) << lsb) * sizeof(uint2) +
                      ((size_t)1 << (B + lsb)) * sizeof(uint32_t);
  ntt_rows_batch_kernel<INV><<<grid, 32 << lsb, smem, g.st>>>(
      g.out, g.in, g.in_bstride, g.perm, g.perm_bstride, first, last, g.limb_idx, g.L,
      (int)batch, g.rb, g.logn, lsb, g.tw, g.tw_sh, g.qs, g.ninv, g.ninv_sh);
}

template <bool INV>
void rows_any_pass(const Args &g, int first, int last) {
  if (g.rb > 1)
    rows_batch_pass<INV>(g, first, last);
  else
    rows_pass<INV>(g, first, last);
}

template <bool INV, int R1, int R2>
void cols_pass(const Args &g) {
  constexpr int A = R1 + R2;
  const dim3 grid(g.rows, 1u << (g.logw - A - 5));
  const size_t smem = ((1 << A) - 1) * sizeof(uint2) + (size_t)(32 << A) * sizeof(uint32_t);
  ntt_cols_kernel<INV, R1, R2><<<grid, 32 << R2, smem, g.st>>>(
      g.out, g.in, g.in_bstride, g.in_lstride, g.perm, g.perm_bstride, g.limb_idx, g.L,
      g.logn, g.logw, g.canon, g.tw, g.tw_sh, g.qs, g.ninv, g.ninv_sh);
}

template <bool INV>
void cols_dispatch(const Args &g, int a) {
  switch (a) {
    case 1: cols_pass<INV, 1, 0>(g); break;
    case 2: cols_pass<INV, 1, 1>(g); break;
    case 3: cols_pass<INV, 2, 1>(g); break;
    case 4: cols_pass<INV, 2, 2>(g); break;
    case 5: cols_pass<INV, 3, 2>(g); break;
    case 6: cols_pass<INV, 3, 3>(g); break;
    case 7: cols_pass<INV, 4, 3>(g); break;
    default: cols_pass<INV, 4, 4>(g); break;
  }
}

}  // namespace

// rows = batch * L rows of n = 2^logn residues, 8 <= logn <= 16; row
// r = (b, i) reads in + b * in_bstride + i * n (through perm + b *
// perm_bstride when perm is not NULL; perm_bstride 0 shares one
// permutation) and uses table row limb_idx[i].  tw/tw_sh are psis/psis_sh
// (forward) or ipsis/ipsis_sh (inverse), [Ltot, n].  out is [rows, n]; it
// may alias in when in is contiguous and perm is NULL (each block reads all
// of a row's tile before it writes it).  The pass after the first reads and
// writes out in place.  rb: the batch rows a block of the row pass walks
// (ops/ntt.py rows_per_block); 1 runs ntt_rows_kernel, a block a row.
extern "C" int imtpu_ntt(void *out, const void *in, int64_t in_bstride,
                         const void *perm, int64_t perm_bstride,
                         const void *limb_idx, int64_t rows, int64_t L,
                         int64_t logn, const void *tw, const void *tw_sh,
                         const void *qs, const void *ninv, const void *ninv_sh,
                         int64_t inverse, int64_t rb, void *stream) {
  if (rows == 0) return 0;
  if (logn < kMaxRowBits || logn > 2 * kMaxRowBits || rows > 0x7fffffff || L < 1 ||
      rb < 1 || rb > 0x7fffffff || (rb > 1 && rows % L))
    return (int)cudaErrorInvalidValue;
  const Args g{(uint32_t *)out, (const uint32_t *)in, in_bstride, (int64_t)1 << logn,
               (const int32_t *)perm, perm_bstride, (const int32_t *)limb_idx,
               (unsigned)rows, (int)L, (int)logn, (int)logn, 0, (const uint32_t *)tw,
               (const uint32_t *)tw_sh, (const uint32_t *)qs,
               (const uint32_t *)ninv, (const uint32_t *)ninv_sh,
               (cudaStream_t)stream, (int)rb, 0};
  const int a = (int)logn - kMaxRowBits;
  if (!inverse) {
    if (a > 0) {
      cols_dispatch<false>(g, a);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    rows_any_pass<false>(g, a == 0, 1);
  } else {
    rows_any_pass<true>(g, 1, a == 0);
    if (a > 0) {
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
      cols_dispatch<true>(g, a);
    }
  }
  return (int)cudaGetLastError();
}

// One pass of a slot shard's transform (see the top of this file): the
// column pass (cols != 0) over rows of 2^logw residues holding the
// shard's [2^a, 2^(logw - a)] column block (forward: reads in, which out
// may alias; inverse: in place in out, with 1/N), or the row pass over
// the rows' 2^(logw - 8) sub-blocks, global sub-block index = local +
// blk_off (reads in, through perm when not NULL: row r = (b, i) at in +
// b * in_bstride + i * in_lstride; the inverse's row pass is its first).
// 8 < logn <= 16; the column pass needs 2^(logw - a) >= 32 columns.
extern "C" int imtpu_ntt_pass(void *out, const void *in, int64_t in_bstride,
                              int64_t in_lstride, const void *perm,
                              int64_t perm_bstride, const void *limb_idx,
                              int64_t rows, int64_t L, int64_t logn,
                              int64_t logw, int64_t cols, int64_t blk_off,
                              const void *tw, const void *tw_sh, const void *qs,
                              const void *ninv, const void *ninv_sh,
                              int64_t inverse, void *stream) {
  if (rows == 0) return 0;
  const int64_t a = logn - kMaxRowBits;
  if (a < 1 || logn > 2 * kMaxRowBits || logw > logn || logw < kMaxRowBits ||
      rows > 0x7fffffff || L < 1 || blk_off < 0 ||
      blk_off + ((int64_t)1 << (logw - kMaxRowBits)) > ((int64_t)1 << a) ||
      (cols && (logw - a < 5 || perm != nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args g{(uint32_t *)out, (const uint32_t *)in, in_bstride, in_lstride,
               (const int32_t *)perm, perm_bstride, (const int32_t *)limb_idx,
               (unsigned)rows, (int)L, (int)logn, (int)logw, (int)blk_off,
               (const uint32_t *)tw, (const uint32_t *)tw_sh, (const uint32_t *)qs,
               (const uint32_t *)ninv, (const uint32_t *)ninv_sh, (cudaStream_t)stream, 1, 1};
  if (cols) {
    if (inverse)
      cols_dispatch<true>(g, (int)a);
    else
      cols_dispatch<false>(g, (int)a);
  } else if (inverse) {
    rows_pass<true>(g, 1, 0);
  } else {
    rows_pass<false>(g, 1, 1);
  }
  return (int)cudaGetLastError();
}
