// K12: the modular sum of shard partials.
//
// Replaces image_matching_tpu/parallel/sharded.py psum_mod (:37), the
// cross-shard reduction of the membership flags, together with each
// shard's local chain of mod_adds before it (sharded.py:104-111,
// :244-249): out[i] = (sum over buffers p, rows r of buf_p[r][i]) mod
// q_limb(i).  The TPU version psums 16-bit halves (so a uint32 psum
// cannot wrap) and refolds them with Montgomery powers of 2^16; here the
// residues (< q < 2^31, Montgomery form kept: a sum of Montgomery forms is
// the Montgomery form of the sum) are summed in 64 bits and reduced once,
// which gives the same canonical residue.  A 64-bit sum of fewer than 2^33
// residues below 2^31 cannot overflow; a launch takes fewer than 2^31 rows.
//
// The P buffers are separate allocations (one per shard, a partial copied
// from another card, or a gathered one), so no single row stride
// addresses them.  Their addresses, the first row of each in the list and
// the limbs' constants go to the kernel by value, in one struct parameter
// (as K6 passes its Threefry key schedule): no device table, no copy from
// the host and no host sync, so the wrapper returns while the card is
// still busy.  A launch takes at most K12_CAP buffers; the wrapper reduces
// a longer list in chunks and appends each chunk's sum as one more
// one-row buffer, which is exact (a sum of canonical residues mod q does
// not depend on grouping).  Buffer p holds rows[p] contiguous rows of the
// same [B, l, n] block of `total` residues.
//
// What bounds it on the H100: device memory (each input residue read
// once, one residue written per element).  Design, after K11's row sum
// (modarith.cu): a block of K12_THREADS threads covers VB = K12_THREADS /
// G V-vectors of one [l, n] plane and splits the list's rows over its G
// row groups (G = 4: one warp a group); a thread keeps four loads of V = 4
// residues (16 bytes) in flight and walks the list with a buffer cursor
// that only moves forward; the 64-bit partials are joined in shared
// memory and reduced as s = hi 2^32 + lo = mont(hi, R^2) + mont(lo, R),
// with no `%`.  The limb is the vector's index shifted by log2(n / V) (n
// a power of two).  G is the least of 4, 8 and 16 that gives the launch
// PASS_MIN_BLOCKS blocks (passgrid.cuh), so a small plane still fills the
// card.  A buffer or output not on a 16-byte boundary takes V = 1.
#include <cuda_runtime.h>
#include <stdint.h>

#include "modmath.cuh"
#include "passgrid.cuh"

#define K12_THREADS 128
#define K12_CAP 64        // buffers a launch
#define K12_MAX_LIMBS 64  // limbs a launch

struct PsumList {
  const uint32_t *buf[K12_CAP];
  int start[K12_CAP + 1];  // buffer p's first row in the list; start[P]: all rows
  uint32_t q[K12_MAX_LIMBS], qneg[K12_MAX_LIMBS], r1[K12_MAX_LIMBS], r2[K12_MAX_LIMBS];
};

template <int V, int G>
__global__ void __launch_bounds__(K12_THREADS)
    psum_mod_kernel(uint32_t *__restrict__ out, const PsumList L, int P,
                    int64_t total, int B, int plane_v, int lg) {
  constexpr int VB = K12_THREADS / G;
  __shared__ uint64_t part[G - 1][VB][V];
  const int lane = threadIdx.x % VB, grp = threadIdx.x / VB;
  const int j = blockIdx.x * VB + lane;  // V-vector of the plane
  const bool live = j < plane_v;
  const int e = j * V;
  const int R = L.start[P];
  const int64_t plane = (int64_t)plane_v * V;
  for (int blk = blockIdx.y; blk < B; blk += gridDim.y) {
    const int64_t off = blk * plane + e;
    uint64_t s[V];
#pragma unroll
    for (int v = 0; v < V; ++v) s[v] = 0;
    if (live) {
      int p = 0;  // the buffer of the group's next row: rows only grow
      for (int r = grp; r < R; r += 4 * G) {
        uint32_t x[4][V];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int g = r + u * G;
          if (g < R) {
            while (g >= L.start[p + 1]) ++p;
            ld_v<V>(L.buf[p] + (int64_t)(g - L.start[p]) * total + off, x[u]);
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
    if (grp > 0) {
#pragma unroll
      for (int v = 0; v < V; ++v) part[grp - 1][lane][v] = s[v];
    }
    __syncthreads();
    if (grp == 0 && live) {
      const int limb = j >> lg;
      const uint32_t q = L.q[limb], qn = L.qneg[limb], c1 = L.r1[limb], c2 = L.r2[limb];
      uint32_t o[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
#pragma unroll
        for (int u = 0; u < G - 1; ++u) s[v] += part[u][lane][v];
        // hi 2^32 + lo mod q: both products take a factor below 2^32 and
        // one below q, so each is exact
        o[v] = mod_add(mont_mul((uint32_t)(s[v] >> 32), c2, q, qn),
                       mont_mul((uint32_t)s[v], c1, q, qn), q);
      }
      st_v<V>(out + off, o);
    }
    __syncthreads();  // part is reused by the next plane
  }
}

static int log2_exact(int64_t x) {  // -1 unless x is a power of two
  if (x < 1 || (x & (x - 1)) != 0) return -1;
  int k = 0;
  while ((int64_t)1 << k < x) ++k;
  return k;
}

template <int V>
static void launch_v(uint32_t *out, const PsumList &L, int P, int64_t total,
                     int64_t B, int64_t plane_v, int lg, cudaStream_t s) {
  const unsigned by = (unsigned)(B < PASS_MAX_GRID_Y ? B : PASS_MAX_GRID_Y);
  const auto blocks = [&](int G) { return (plane_v + K12_THREADS / G - 1) / (K12_THREADS / G); };
  if (blocks(4) * by >= PASS_MIN_BLOCKS)
    psum_mod_kernel<V, 4><<<dim3((unsigned)blocks(4), by), K12_THREADS, 0, s>>>(
        out, L, P, total, (int)B, (int)plane_v, lg);
  else if (blocks(8) * by >= PASS_MIN_BLOCKS)
    psum_mod_kernel<V, 8><<<dim3((unsigned)blocks(8), by), K12_THREADS, 0, s>>>(
        out, L, P, total, (int)B, (int)plane_v, lg);
  else
    psum_mod_kernel<V, 16><<<dim3((unsigned)blocks(16), by), K12_THREADS, 0, s>>>(
        out, L, P, total, (int)B, (int)plane_v, lg);
}

// addrs, rows: host arrays of the P buffers' device addresses and row
// counts (int64); consts: host uint32 [4][l], per limb q, -q^-1 mod 2^32,
// R mod q and R^2 mod q; total = the residues of one row, B = total / (l
// n) blocks of [l, n]; out: one row, the sum mod q.  n is a power of two.
extern "C" int imtpu_psum_mod(void *out, const void *addrs, const void *rows, int64_t P,
                              int64_t total, int64_t l, int64_t n, const void *consts,
                              void *stream) {
  if (total == 0) return 0;
  if (P < 1 || P > K12_CAP || l < 1 || l > K12_MAX_LIMBS || log2_exact(n) < 0 ||
      total % (l * n) != 0 || l * n >= (int64_t)1 << 31)
    return (int)cudaErrorInvalidValue;
  PsumList L;
  const int64_t *a = (const int64_t *)addrs, *r = (const int64_t *)rows;
  const uint32_t *c = (const uint32_t *)consts;
  bool vec = n % 4 == 0 && aligned16(out);
  int64_t start = 0;
  for (int p = 0; p < P; ++p) {
    if (r[p] < 0) return (int)cudaErrorInvalidValue;
    L.buf[p] = (const uint32_t *)a[p];
    L.start[p] = (int)start;
    vec = vec && aligned16(L.buf[p]);
    start += r[p];
    if (start >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  }
  L.start[P] = (int)start;
  for (int i = 0; i < l; ++i) {
    L.q[i] = c[i];
    L.qneg[i] = c[l + i];
    L.r1[i] = c[2 * l + i];
    L.r2[i] = c[3 * l + i];
  }
  const int64_t B = total / (l * n);
  if (vec)
    launch_v<4>((uint32_t *)out, L, (int)P, total, B, l * n / 4, log2_exact(n / 4),
                (cudaStream_t)stream);
  else
    launch_v<1>((uint32_t *)out, L, (int)P, total, B, l * n, log2_exact(n),
                (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
