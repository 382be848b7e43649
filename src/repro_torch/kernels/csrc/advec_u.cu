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
//
// TILE=1 builds the second body, `tile` (stencil_tile.cuh), in place of the
// one above (`ldg`): 2-D blocks march a strip of STRIP_Z planes, staging u
// with its radius-3 halo in x and y, v with a y halo of 1 and w alone into
// a ring in shared memory by cp.async; each thread keeps u's 7 and w's 3 z
// neighbours of its column in register queues. Same arithmetic, term for
// term, and the same bf16 rounding on store.
#include "common.cuh"
#if TILE
#include "stencil_tile.cuh"
#endif

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
int launch_ldg(const void* u, const void* v, const void* w, const void* scal,
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

#if TILE
constexpr int ADVEC_L = 3;  // radius in z
constexpr int ADVEC_NBUF = ADVEC_L + 1 + tile::AHEAD;
template <typename T, bool VEC = true>
using StageU = tile::Stage<T, 3, 3, VEC>;
template <typename T, bool VEC = true>
using StageV = tile::Stage<T, 1, 0, VEC>;
template <typename T, bool VEC = true>
using StageW = tile::Stage<T, 0, 0, VEC>;

// Shared memory of a tile block: the ring's buffers of u, v and w.
template <typename T>
constexpr int tile_smem_bytes() {
  return ADVEC_NBUF * static_cast<int>(sizeof(T)) *
         (StageU<T>::ELEMS + StageV<T>::ELEMS + StageW<T>::ELEMS);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(TILE_THREADS, MIN_BLOCKS_PER_SM)
    advec_u_tile_kernel(const T* __restrict__ u, const T* __restrict__ v,
                        const T* __restrict__ w,
                        const float* __restrict__ scal, T* __restrict__ ut,
                        int nz, int ny, int nx, int gx, int gy, int gz) {
  using SU = StageU<T, VEC>;
  using SV = StageV<T, VEC>;
  using SW = StageW<T, VEC>;
  constexpr int L = ADVEC_L, NBUF = ADVEC_NBUF;
  extern __shared__ __align__(16) unsigned char smem[];
  T* su = reinterpret_cast<T*>(smem);
  T* sv = su + NBUF * SU::ELEMS;
  T* sw = sv + NBUF * SV::ELEMS;

  const tile::Block b = tile::block_of(nz, gx, gy, gz);
  SU stu;
  SV stv;
  SW stw;
  stu.init(b, ny, nx);
  stv.init(b, ny, nx);
  stw.init(b, ny, nx);
  const float dxi = __ldg(scal), dyi = __ldg(scal + 1), dzi = __ldg(scal + 2);
  const int i = b.x0 + threadIdx.x, j = b.y0 + threadIdx.y;
  const bool active = i < nx && j < ny;
  const int plane = ny * nx;
  T* out = ut + b.z0 * plane + j * nx + i;  // advances a plane a step
  // this thread's column in each field's buffer
  const int own_u = (L + threadIdx.y) * SU::PITCH + SU::PX + threadIdx.x;
  const int own_v = (1 + threadIdx.y) * SV::PITCH + threadIdx.x;
  const int own_w = threadIdx.y * SW::PITCH + threadIdx.x;
  // u at this column, planes k-3..k+3; w, planes k-1..k+1 (k: the plane
  // computed in this step)
  float uq[7] = {}, wq[3] = {};

  tile::march<NBUF>(
      (b.z1 - b.z0) + 2 * L,
      [&](int p, int buf) {
        const int zoff = tile::halo_index(b.z0 - L + p, nz) * plane;
        stu.load(su + buf * SU::ELEMS, u, zoff, b, ny, nx);
        stv.load(sv + buf * SV::ELEMS, v, zoff, b, ny, nx);
        stw.load(sw + buf * SW::ELEMS, w, zoff, b, ny, nx);
      },
      [&](int p, int buf) {
        tile::push(uq, tile::to_f32(su[buf * SU::ELEMS + own_u]));
        const int lag2 = (buf + NBUF - 2) % NBUF;  // w's plane k + 1
        tile::push(wq, tile::to_f32(sw[lag2 * SW::ELEMS + own_w]));
        if (p < 2 * L || !active) return;
        const int c = (buf + NBUF - L) % NBUF;  // plane k = z0 + p - 2L
        const T* cu = su + c * SU::ELEMS + own_u;
        const T* cv = sv + c * SV::ELEMS + own_v;
        float ux[7], uy[7], vy[3];
#pragma unroll
        for (int s = 0; s < 7; ++s) {
          ux[s] = tile::to_f32(cu[s - 3]);
          uy[s] = tile::to_f32(cu[(s - 3) * SU::PITCH]);
        }
#pragma unroll
        for (int s = 0; s < 3; ++s)
          vy[s] = tile::to_f32(cv[(s - 1) * SV::PITCH]);
        const float fx_p = 0.5f * (ux[3] + ux[4]) * interp(ux, 1);
        const float fx_m = 0.5f * (ux[2] + ux[3]) * interp(ux, 0);
        const float fy_p = 0.5f * (vy[1] + vy[2]) * interp(uy, 1);
        const float fy_m = 0.5f * (vy[0] + vy[1]) * interp(uy, 0);
        const float fz_p = 0.5f * (wq[1] + wq[2]) * interp(uq, 1);
        const float fz_m = 0.5f * (wq[0] + wq[1]) * interp(uq, 0);
        const float r = -(dxi * (fx_p - fx_m) + dyi * (fy_p - fy_m) +
                          dzi * (fz_p - fz_m));
        store(out, r);
        out += plane;
      });
}

template <typename T, bool VEC>
int launch_tile(const void* u, const void* v, const void* w, const void* scal,
                void* out, int nz, int ny, int nx, cudaStream_t stream) {
  const StencilGrid g = tile::grid(nz, ny, nx);
  constexpr int smem = tile_smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(
      advec_u_tile_kernel<T, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  advec_u_tile_kernel<T, VEC><<<static_cast<unsigned int>(g.blocks),
                                dim3(BLOCK_SIZE_X, BLOCK_SIZE_Y), smem,
                                stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(v),
      static_cast<const T*>(w), static_cast<const float*>(scal),
      static_cast<T*>(out), nz, ny, nx, g.gx, g.gy, g.gz);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* u, const void* v, const void* w, const void* scal,
           void* out, int nz, int ny, int nx, cudaStream_t stream) {
  const void* staged[3] = {u, v, w};
  if (tile::vectorizable<T>(nx, staged, 3))
    return launch_tile<T, true>(u, v, w, scal, out, nz, ny, nx, stream);
  return launch_tile<T, false>(u, v, w, scal, out, nz, ny, nx, stream);
}
#else
template <typename T>
int launch(const void* u, const void* v, const void* w, const void* scal,
           void* out, int nz, int ny, int nx, cudaStream_t stream) {
  return launch_ldg<T>(u, v, w, scal, out, nz, ny, nx, stream);
}
#endif

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
