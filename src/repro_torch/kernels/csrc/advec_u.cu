// advec_u — advection tendency of u on a periodic (nz, ny, nx) grid:
// flux form with 5th-order interpolation, stencil radius 3, 78 flop/point.
//
// Replaces the TPU kernel src/repro/kernels/advec_u.py:_kernel_body (entered
// through _pallas_entry, pl.pallas_call at advec_u.py:91); the arithmetic is
// that of src/repro/kernels/ref.py:advec_terms, term for term.
//
// Bound on the H100: memory. Each point reads u, v, w and writes ut, 78
// flop for 16 bytes (f32), about 5 flop/byte against the card's 67 TFLOP/s
// / 3.35 TB/s = 20; the least time is 4 fields over HBM bandwidth.
//
// Design: each thread owns one (x, y) column and walks TILE_FACTOR_Z points
// in z; a block is BLOCK_SIZE_X x BLOCK_SIZE_Y x BLOCK_SIZE_Z threads with x
// fastest, so a warp reads consecutive x. Neighbours are read through __ldg
// with periodic wrap: unlike TPU blocks, CUDA blocks may read overlapping and
// wrapped cells, so there are no halo side slabs and no divisibility rule;
// the L1 and L2 caches serve the 7-point reuse along each axis. The ragged
// edge is masked, so every config runs on every shape. Compute is f32.
//
// Tunables, compiled in as defines (the paper's CUDA axes):
//   BLOCK_SIZE_X, BLOCK_SIZE_Y, BLOCK_SIZE_Z, TILE_FACTOR_Z,
//   UNRAVEL_A/B/C (block-order permutation), MIN_BLOCKS_PER_SM.
#include "common.cuh"

namespace {

constexpr float C0 = 37.0f / 60.0f;
constexpr float C1 = -8.0f / 60.0f;
constexpr float C2 = 1.0f / 60.0f;

// 5th-order interpolation to the face between cells o-1 and o; a[3 + s] is
// the field shifted by s cells along one axis.
__device__ __forceinline__ float interp(const float* a, int o) {
  return C0 * (a[3 + o - 1] + a[3 + o]) + C1 * (a[3 + o - 2] + a[3 + o + 1]) +
         C2 * (a[3 + o - 3] + a[3 + o + 2]);
}

template <typename T>
__global__ void __launch_bounds__(STENCIL_THREADS, MIN_BLOCKS_PER_SM)
    advec_u_kernel(const T* __restrict__ u, const T* __restrict__ v,
                   const T* __restrict__ w, const float* __restrict__ scal,
                   T* __restrict__ ut, int nz, int ny, int nx, int gx, int gy,
                   int gz) {
  int bx, by, bz;
  unravel(blockIdx.x, gx, gy, gz, bx, by, bz);
  const int i = bx * BLOCK_SIZE_X + threadIdx.x;
  const int j = by * BLOCK_SIZE_Y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const int k0 = (bz * BLOCK_SIZE_Z + threadIdx.z) * TILE_FACTOR_Z;
  const float dxi = __ldg(scal), dyi = __ldg(scal + 1), dzi = __ldg(scal + 2);
  const long long sz = static_cast<long long>(ny) * nx;

  int xi[7];
  long long yo[7];
#pragma unroll
  for (int s = -3; s <= 3; ++s) {
    xi[3 + s] = wrap(i + s, nx);
    yo[3 + s] = static_cast<long long>(wrap(j + s, ny)) * nx;
  }

#pragma unroll
  for (int t = 0; t < TILE_FACTOR_Z; ++t) {
    const int k = k0 + t;
    if (k >= nz) break;
    long long zo[7];
#pragma unroll
    for (int s = -3; s <= 3; ++s) zo[3 + s] = wrap(k + s, nz) * sz;
    const long long row = zo[3] + yo[3];

    float ux[7], uy[7], uz[7], vy[3], wz[3];
#pragma unroll
    for (int s = 0; s < 7; ++s) {
      ux[s] = load(u + row + xi[s]);
      uy[s] = load(u + zo[3] + yo[s] + i);
      uz[s] = load(u + zo[s] + yo[3] + i);
    }
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      vy[s] = load(v + zo[3] + yo[2 + s] + i);
      wz[s] = load(w + zo[2 + s] + yo[3] + i);
    }
    // vy[1 + s], wz[1 + s]: v and w shifted by s in -1..1
    const float fx_p = 0.5f * (ux[3] + ux[4]) * interp(ux, 1);
    const float fx_m = 0.5f * (ux[2] + ux[3]) * interp(ux, 0);
    const float fy_p = 0.5f * (vy[1] + vy[2]) * interp(uy, 1);
    const float fy_m = 0.5f * (vy[0] + vy[1]) * interp(uy, 0);
    const float fz_p = 0.5f * (wz[1] + wz[2]) * interp(uz, 1);
    const float fz_m = 0.5f * (wz[0] + wz[1]) * interp(uz, 0);
    const float r =
        -(dxi * (fx_p - fx_m) + dyi * (fy_p - fy_m) + dzi * (fz_p - fz_m));
    store(ut + row + i, r);
  }
}

template <typename T>
int launch(const void* u, const void* v, const void* w, const void* scal,
           void* out, int nz, int ny, int nx, cudaStream_t stream) {
  const StencilGrid g = stencil_grid(nz, ny, nx);
  const dim3 block(BLOCK_SIZE_X, BLOCK_SIZE_Y, BLOCK_SIZE_Z);
  advec_u_kernel<T><<<static_cast<unsigned int>(g.blocks), block, 0,
                      stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(v),
      static_cast<const T*>(w), static_cast<const float*>(scal),
      static_cast<T*>(out), nz, ny, nx, g.gx, g.gy, g.gz);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int advec_u_launch(int dtype, const void* u, const void* v,
                              const void* w, const void* scal, void* out,
                              int nz, int ny, int nx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(u, v, w, scal, out, nz, ny, nx, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(u, v, w, scal, out, nz, ny, nx, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
