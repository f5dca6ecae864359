// Launch geometry of the streaming passes over B rows of l limbs of n
// coefficients (K6 seeded_encrypt.cu, K7 rescale.cu, K10 pk_encrypt.cu):
// V coefficients a thread (V = 4: 16-byte accesses; V = 1 where an operand
// or stride is not 16-byte aligned, in the same kernel).  K3/K8 (fbc.cuh)
// and K11 (modarith.cu) take the block floor and the alignment test.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define PASS_THREADS 128
#define PASS_MIN_BLOCKS 528      // four blocks for each of the H100's 132 SMs
#define PASS_TARGET_BLOCKS 8448  // four waves of 16 resident blocks a SM
#define PASS_MAX_GRID_Y 65535    // gridDim.y's (and gridDim.z's) limit

static inline bool aligned16(const void *p) { return ((uintptr_t)p & 15u) == 0; }

// A pass whose thread loops over the limbs: coefficients over x, rows over
// y (the kernel loops past the grid's limit), the limbs split over z into
// chunks of *per until the launch has PASS_MIN_BLOCKS blocks (a launch of
// one ciphertext still fills the card).
static inline dim3 limb_split_grid(int64_t B, int64_t l, int64_t n, int V, int *per) {
  const int64_t bx = (n / V + PASS_THREADS - 1) / PASS_THREADS;
  const int64_t by = B < PASS_MAX_GRID_Y ? B : PASS_MAX_GRID_Y;
  int64_t chunks = (PASS_MIN_BLOCKS + bx * by - 1) / (bx * by);
  if (chunks > l) chunks = l;
  if (chunks < 1) chunks = 1;
  *per = (int)((l + chunks - 1) / chunks);
  return dim3((unsigned)bx, (unsigned)by, (unsigned)((l + *per - 1) / *per));
}

// A pass whose thread holds one limb's operands in registers and walks
// the rows: coefficients over x, limbs over y, the rows over z in
// stretches of *stretch, as many stretches as bring the launch to about
// PASS_TARGET_BLOCKS blocks.
static inline dim3 row_stretch_grid(int64_t B, int64_t l, int64_t n, int V, int *stretch) {
  const int64_t bx = (n / V + PASS_THREADS - 1) / PASS_THREADS;
  int64_t bz = (PASS_TARGET_BLOCKS + bx * l - 1) / (bx * l);
  if (bz > B) bz = B;
  if (bz < 1) bz = 1;
  *stretch = (int)((B + bz - 1) / bz);
  return dim3((unsigned)bx, (unsigned)l, (unsigned)((B + *stretch - 1) / *stretch));
}
