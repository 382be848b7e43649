// Helpers shared by the stencil kernels (advec_u.cu, diff_uvw.cu).
//
// Fields are (nz, ny, nx) row-major, x contiguous, periodic on every axis.
// Values are read through the read-only path (__ldg) and computed in f32;
// bfloat16 goes through __bfloat162float / __float2bfloat16 (round to
// nearest even, as torch's .to(torch.bfloat16)).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// a + s wrapped into [0, n), for |s| <= n.
__device__ __forceinline__ int wrap(int a, int n) {
  return a < 0 ? a + n : (a >= n ? a - n : a);
}

// The paper's unravel permutation: which tile axis the linear block index
// walks fastest. UNRAVEL_A/B/C name the axes (0 = x, 1 = y, 2 = z), fastest
// first; the launcher passes a 1-D grid of gx * gy * gz blocks.
__device__ __forceinline__ void unravel(long long b, int gx, int gy, int gz,
                                        int& bx, int& by, int& bz) {
  const int g[3] = {gx, gy, gz};
  int t[3];
  t[UNRAVEL_A] = static_cast<int>(b % g[UNRAVEL_A]);
  b /= g[UNRAVEL_A];
  t[UNRAVEL_B] = static_cast<int>(b % g[UNRAVEL_B]);
  t[UNRAVEL_C] = static_cast<int>(b / g[UNRAVEL_B]);
  bx = t[0];
  by = t[1];
  bz = t[2];
}

#define STENCIL_THREADS (BLOCK_SIZE_X * BLOCK_SIZE_Y * BLOCK_SIZE_Z)

// Grid of one stencil launch: x/y tiles of the block, z tiles of
// BLOCK_SIZE_Z threads that each walk TILE_FACTOR_Z points.
struct StencilGrid {
  int gx, gy, gz;
  long long blocks;
};

static inline StencilGrid stencil_grid(int nz, int ny, int nx) {
  StencilGrid g;
  g.gx = (nx + BLOCK_SIZE_X - 1) / BLOCK_SIZE_X;
  g.gy = (ny + BLOCK_SIZE_Y - 1) / BLOCK_SIZE_Y;
  const int zt = BLOCK_SIZE_Z * TILE_FACTOR_Z;
  g.gz = (nz + zt - 1) / zt;
  g.blocks = static_cast<long long>(g.gx) * g.gy * g.gz;
  return g;
}
