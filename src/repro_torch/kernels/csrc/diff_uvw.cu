// diff_uvw — diffusion of (u, v, w) with a variable eddy viscosity on a
// periodic (nz, ny, nx) grid: d/dx(ev * df/dx) summed over the three axes,
// halo 1, 27 flop/point/field.
//
// Replaces the TPU kernels of src/repro/kernels/diff_uvw.py:
//   _fused_kernel  (pl.pallas_call at diff_uvw.py:111) -> diff_uvw_fused
//   _single_kernel (pl.pallas_call at diff_uvw.py:126) -> diff_uvw_single
// with the arithmetic of src/repro/kernels/ref.py:diff_term / diff_field.
//
// Bound on the H100: memory. The fused kernel reads u, v, w and evisc once
// and writes three tendencies (7 fields, 81 flop per point: about 3 flop per
// f32 byte against the card's ratio of 20). The single-field kernel reads
// one field and evisc and writes one tendency; the fuse_outputs=False
// variant launches it once per field, reading evisc three times (9 fields).
//
// Design: as advec_u.cu. Each thread owns an (x, y) column and walks
// TILE_FACTOR_Z points in z, reading the 7-point neighbourhood through
// __ldg with periodic wrap; overlapping reads between blocks are legal on
// CUDA, so the TPU's halo side slabs and divisibility rule are gone, and the
// ragged edge is masked. Compute is f32.
//
// TILE=1 builds both kernels' second body, `tile` (stencil_tile.cuh), in
// place of the one above (`ldg`): 2-D blocks march a strip of STRIP_Z
// planes, staging each field they read (f and evisc; the fused kernel u, v,
// w and evisc) with a halo of 1 in x and y into one ring in shared memory
// by cp.async; each thread keeps the 3 z neighbours of its column of each
// field in register queues. The fused body computes a point's six face
// viscosities once for its three tendencies, and a point costs 16
// neighbour reads from shared memory (x+-1 and y+-1 of four fields) where
// three single-field launches make 24. Same arithmetic, term for term.
#include "common.cuh"
#if TILE
#include "stencil_tile.cuh"
#endif

namespace {

// a[1 + s] is the field shifted by s cells along one axis; ev_p and ev_m
// the viscosities on the faces at +1/2 and -1/2 cell.
__device__ __forceinline__ float diff_flux(const float* a, float ev_p,
                                          float ev_m, float di) {
  return (di * di) * (ev_p * (a[2] - a[1]) - ev_m * (a[1] - a[0]));
}

// The faces' viscosities from e[1 + s], the eddy viscosity shifted so.
__device__ __forceinline__ float face_p(const float* e) {
  return 0.5f * (e[1] + e[2]);
}
__device__ __forceinline__ float face_m(const float* e) {
  return 0.5f * (e[0] + e[1]);
}

__device__ __forceinline__ float diff_term(const float* a, const float* e,
                                           float di) {
  return diff_flux(a, face_p(e), face_m(e), di);
}

struct Neighbours {
  long long zo[3], yo[3];
  int xi[3];
  int i;
};

template <typename T>
__device__ __forceinline__ float diff_field(const T* __restrict__ f,
                                           const float (&ex)[3],
                                           const float (&ey)[3],
                                           const float (&ez)[3],
                                           const Neighbours& n, float dxi,
                                           float dyi, float dzi) {
  float fx[3], fy[3], fz[3];
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    fx[s] = load(f + n.zo[1] + n.yo[1] + n.xi[s]);
    fy[s] = load(f + n.zo[1] + n.yo[s] + n.i);
    fz[s] = load(f + n.zo[s] + n.yo[1] + n.i);
  }
  return diff_term(fx, ex, dxi) + diff_term(fy, ey, dyi) +
         diff_term(fz, ez, dzi);
}

// Walks the thread's z strip, calling body(neighbours, ex, ey, ez) per point.
template <typename T, typename Body>
__device__ __forceinline__ void walk(const T* __restrict__ evisc, int nz,
                                     int ny, int nx, int gx, int gy, int gz,
                                     Body body) {
  int bx, by, bz;
  unravel(blockIdx.x, gx, gy, gz, bx, by, bz);
  Neighbours n;
  n.i = bx * BLOCK_SIZE_X + threadIdx.x;
  const int j = by * BLOCK_SIZE_Y + threadIdx.y;
  if (n.i >= nx || j >= ny) return;
  const int k0 = (bz * BLOCK_SIZE_Z + threadIdx.z) * TILE_FACTOR_Z;
  const long long sz = static_cast<long long>(ny) * nx;
#pragma unroll
  for (int s = -1; s <= 1; ++s) {
    n.xi[1 + s] = wrap(n.i + s, nx);
    n.yo[1 + s] = static_cast<long long>(wrap(j + s, ny)) * nx;
  }
#pragma unroll
  for (int t = 0; t < TILE_FACTOR_Z; ++t) {
    const int k = k0 + t;
    if (k >= nz) break;
#pragma unroll
    for (int s = -1; s <= 1; ++s) n.zo[1 + s] = wrap(k + s, nz) * sz;
    float ex[3], ey[3], ez[3];
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      ex[s] = load(evisc + n.zo[1] + n.yo[1] + n.xi[s]);
      ey[s] = load(evisc + n.zo[1] + n.yo[s] + n.i);
      ez[s] = load(evisc + n.zo[s] + n.yo[1] + n.i);
    }
    body(n, ex, ey, ez, n.zo[1] + n.yo[1] + n.i);
  }
}

template <typename T>
__global__ void __launch_bounds__(STENCIL_THREADS, MIN_BLOCKS_PER_SM)
    diff_uvw_fused_kernel(const T* __restrict__ u, const T* __restrict__ v,
                          const T* __restrict__ w, const T* __restrict__ evisc,
                          const float* __restrict__ scal, T* __restrict__ ut,
                          T* __restrict__ vt, T* __restrict__ wt, int nz,
                          int ny, int nx, int gx, int gy, int gz) {
  const float dxi = __ldg(scal), dyi = __ldg(scal + 1), dzi = __ldg(scal + 2);
  walk<T>(evisc, nz, ny, nx, gx, gy, gz,
          [&](const Neighbours& n, const float(&ex)[3], const float(&ey)[3],
              const float(&ez)[3], long long c) {
            store(ut + c, diff_field(u, ex, ey, ez, n, dxi, dyi, dzi));
            store(vt + c, diff_field(v, ex, ey, ez, n, dxi, dyi, dzi));
            store(wt + c, diff_field(w, ex, ey, ez, n, dxi, dyi, dzi));
          });
}

template <typename T>
__global__ void __launch_bounds__(STENCIL_THREADS, MIN_BLOCKS_PER_SM)
    diff_uvw_single_kernel(const T* __restrict__ f,
                           const T* __restrict__ evisc,
                           const float* __restrict__ scal,
                           T* __restrict__ ft, int nz, int ny, int nx, int gx,
                           int gy, int gz) {
  const float dxi = __ldg(scal), dyi = __ldg(scal + 1), dzi = __ldg(scal + 2);
  walk<T>(evisc, nz, ny, nx, gx, gy, gz,
          [&](const Neighbours& n, const float(&ex)[3], const float(&ey)[3],
              const float(&ez)[3], long long c) {
            store(ft + c, diff_field(f, ex, ey, ez, n, dxi, dyi, dzi));
          });
}

template <typename T>
int launch_fused_ldg(const void* u, const void* v, const void* w,
                     const void* evisc, const void* scal, void* ut, void* vt,
                     void* wt, int nz, int ny, int nx, cudaStream_t stream) {
  const StencilGrid g = stencil_grid(nz, ny, nx);
  const dim3 block(BLOCK_SIZE_X, BLOCK_SIZE_Y, BLOCK_SIZE_Z);
  diff_uvw_fused_kernel<T><<<static_cast<unsigned int>(g.blocks), block, 0,
                             stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(v),
      static_cast<const T*>(w), static_cast<const T*>(evisc),
      static_cast<const float*>(scal), static_cast<T*>(ut),
      static_cast<T*>(vt), static_cast<T*>(wt), nz, ny, nx, g.gx, g.gy, g.gz);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_single_ldg(const void* f, const void* evisc, const void* scal,
                      void* ft, int nz, int ny, int nx, cudaStream_t stream) {
  const StencilGrid g = stencil_grid(nz, ny, nx);
  const dim3 block(BLOCK_SIZE_X, BLOCK_SIZE_Y, BLOCK_SIZE_Z);
  diff_uvw_single_kernel<T><<<static_cast<unsigned int>(g.blocks), block, 0,
                              stream>>>(
      static_cast<const T*>(f), static_cast<const T*>(evisc),
      static_cast<const float*>(scal), static_cast<T*>(ft), nz, ny, nx, g.gx,
      g.gy, g.gz);
  return static_cast<int>(cudaGetLastError());
}

#if TILE
constexpr int DIFF_L = 1;
constexpr int DIFF_NBUF = DIFF_L + 1 + tile::AHEAD;
template <typename T, bool VEC = true>
using StageF = tile::Stage<T, 1, 1, VEC>;

// Shared memory of a tile block: the ring's buffers of its FIELDS staged
// fields (2: f and evisc; 4: u, v, w and evisc).
template <typename T, int FIELDS>
constexpr int tile_smem_bytes() {
  return DIFF_NBUF * static_cast<int>(sizeof(T)) * FIELDS * StageF<T>::ELEMS;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(TILE_THREADS, MIN_BLOCKS_PER_SM)
    diff_uvw_single_tile_kernel(const T* __restrict__ f,
                                const T* __restrict__ evisc,
                                const float* __restrict__ scal,
                                T* __restrict__ ft, int nz, int ny, int nx,
                                int gx, int gy, int gz) {
  using S = StageF<T, VEC>;
  constexpr int L = DIFF_L, NBUF = DIFF_NBUF;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sf = reinterpret_cast<T*>(smem);
  T* se = sf + NBUF * S::ELEMS;

  const tile::Block b = tile::block_of(nz, gx, gy, gz);
  S stf, ste;
  stf.init(b, ny, nx);
  ste.init(b, ny, nx);
  const float dxi = __ldg(scal), dyi = __ldg(scal + 1), dzi = __ldg(scal + 2);
  const int i = b.x0 + threadIdx.x, j = b.y0 + threadIdx.y;
  const bool active = i < nx && j < ny;
  const int plane = ny * nx;
  T* out = ft + b.z0 * plane + j * nx + i;  // advances a plane a step
  const int own = (L + threadIdx.y) * S::PITCH + S::PX + threadIdx.x;
  // f and evisc at this column, planes k-1..k+1 (k: the plane computed in
  // this step)
  float fq[3] = {}, eq[3] = {};

  tile::march<NBUF>(
      (b.z1 - b.z0) + 2 * L,
      [&](int p, int buf) {
        const int zoff = tile::halo_index(b.z0 - L + p, nz) * plane;
        stf.load(sf + buf * S::ELEMS, f, zoff, b, ny, nx);
        ste.load(se + buf * S::ELEMS, evisc, zoff, b, ny, nx);
      },
      [&](int p, int buf) {
        const int front = buf * S::ELEMS + own;
        tile::push(fq, tile::to_f32(sf[front]));
        tile::push(eq, tile::to_f32(se[front]));
        if (p < 2 * L || !active) return;
        // plane k = z0 + p - 2L
        const int c = ((buf + NBUF - L) % NBUF) * S::ELEMS + own;
        float fx[3], fy[3], ex[3], ey[3];
#pragma unroll
        for (int s = 0; s < 3; ++s) {
          fx[s] = tile::to_f32(sf[c + s - 1]);
          fy[s] = tile::to_f32(sf[c + (s - 1) * S::PITCH]);
          ex[s] = tile::to_f32(se[c + s - 1]);
          ey[s] = tile::to_f32(se[c + (s - 1) * S::PITCH]);
        }
        store(out, diff_term(fx, ex, dxi) + diff_term(fy, ey, dyi) +
                       diff_term(fq, eq, dzi));
        out += plane;
      });
}

template <typename T, bool VEC>
int launch_single_tile(const void* f, const void* evisc, const void* scal,
                       void* ft, int nz, int ny, int nx, cudaStream_t stream) {
  const StencilGrid g = tile::grid(nz, ny, nx);
  constexpr int smem = tile_smem_bytes<T, 2>();
  cudaError_t e = cudaFuncSetAttribute(
      diff_uvw_single_tile_kernel<T, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  diff_uvw_single_tile_kernel<T, VEC><<<static_cast<unsigned int>(g.blocks),
                                        dim3(BLOCK_SIZE_X, BLOCK_SIZE_Y),
                                        smem, stream>>>(
      static_cast<const T*>(f), static_cast<const T*>(evisc),
      static_cast<const float*>(scal), static_cast<T*>(ft), nz, ny, nx, g.gx,
      g.gy, g.gz);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_single(const void* f, const void* evisc, const void* scal,
                  void* ft, int nz, int ny, int nx, cudaStream_t stream) {
  const void* staged[2] = {f, evisc};
  if (tile::vectorizable<T>(nx, staged, 2))
    return launch_single_tile<T, true>(f, evisc, scal, ft, nz, ny, nx,
                                       stream);
  return launch_single_tile<T, false>(f, evisc, scal, ft, nz, ny, nx,
                                      stream);
}

// The fused kernel's tile body: u, v, w and evisc share one ring (field f's
// buffer n at (f * NBUF + n) * ELEMS), staged by one Stage, whose chunk
// offsets are the same for every field; each thread keeps a queue of
// planes k-1..k+1 of its column of each field.
template <typename T, bool VEC>
__global__ void __launch_bounds__(TILE_THREADS, MIN_BLOCKS_PER_SM)
    diff_uvw_fused_tile_kernel(const T* __restrict__ u,
                               const T* __restrict__ v,
                               const T* __restrict__ w,
                               const T* __restrict__ evisc,
                               const float* __restrict__ scal,
                               T* __restrict__ ut, T* __restrict__ vt,
                               T* __restrict__ wt, int nz, int ny, int nx,
                               int gx, int gy, int gz) {
  using S = StageF<T, VEC>;
  constexpr int L = DIFF_L, NBUF = DIFF_NBUF, E = 3;  // E: evisc's index
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const T* const src[4] = {u, v, w, evisc};
  T* const dst[3] = {ut, vt, wt};

  const tile::Block b = tile::block_of(nz, gx, gy, gz);
  S st;
  st.init(b, ny, nx);
  const float dxi = __ldg(scal), dyi = __ldg(scal + 1), dzi = __ldg(scal + 2);
  const int i = b.x0 + threadIdx.x, j = b.y0 + threadIdx.y;
  const bool active = i < nx && j < ny;
  const int plane = ny * nx;
  int out = b.z0 * plane + j * nx + i;  // advances a plane a step
  const int own = (L + threadIdx.y) * S::PITCH + S::PX + threadIdx.x;
  // each field at this column, planes k-1..k+1 (k: the plane computed in
  // this step)
  float q[4][3] = {};

  tile::march<NBUF>(
      (b.z1 - b.z0) + 2 * L,
      [&](int p, int buf) {
        const int zoff = tile::halo_index(b.z0 - L + p, nz) * plane;
#pragma unroll
        for (int f = 0; f < 4; ++f)
          st.load(ring + (f * NBUF + buf) * S::ELEMS, src[f], zoff, b, ny,
                  nx);
      },
      [&](int p, int buf) {
#pragma unroll
        for (int f = 0; f < 4; ++f)
          tile::push(q[f], tile::to_f32(
                               ring[(f * NBUF + buf) * S::ELEMS + own]));
        if (p < 2 * L || !active) return;
        // plane k = z0 + p - 2L: field f's cell at (f * NBUF) * ELEMS + c
        const int c = ((buf + NBUF - L) % NBUF) * S::ELEMS + own;
        auto at = [&](int f, int d) {
          return tile::to_f32(ring[f * NBUF * S::ELEMS + c + d]);
        };
        const float ex[3] = {at(E, -1), q[E][1], at(E, 1)};
        const float ey[3] = {at(E, -S::PITCH), q[E][1], at(E, S::PITCH)};
        // the six face viscosities, shared by the three tendencies
        const float xp = face_p(ex), xm = face_m(ex);
        const float yp = face_p(ey), ym = face_m(ey);
        const float zp = face_p(q[E]), zm = face_m(q[E]);
#pragma unroll
        for (int f = 0; f < 3; ++f) {
          const float fx[3] = {at(f, -1), q[f][1], at(f, 1)};
          const float fy[3] = {at(f, -S::PITCH), q[f][1], at(f, S::PITCH)};
          store(dst[f] + out, diff_flux(fx, xp, xm, dxi) +
                                  diff_flux(fy, yp, ym, dyi) +
                                  diff_flux(q[f], zp, zm, dzi));
        }
        out += plane;
      });
}

template <typename T, bool VEC>
int launch_fused_tile(const void* u, const void* v, const void* w,
                      const void* evisc, const void* scal, void* ut, void* vt,
                      void* wt, int nz, int ny, int nx, cudaStream_t stream) {
  const StencilGrid g = tile::grid(nz, ny, nx);
  constexpr int smem = tile_smem_bytes<T, 4>();
  cudaError_t e = cudaFuncSetAttribute(
      diff_uvw_fused_tile_kernel<T, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  diff_uvw_fused_tile_kernel<T, VEC><<<static_cast<unsigned int>(g.blocks),
                                       dim3(BLOCK_SIZE_X, BLOCK_SIZE_Y), smem,
                                       stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(v),
      static_cast<const T*>(w), static_cast<const T*>(evisc),
      static_cast<const float*>(scal), static_cast<T*>(ut),
      static_cast<T*>(vt), static_cast<T*>(wt), nz, ny, nx, g.gx, g.gy, g.gz);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fused(const void* u, const void* v, const void* w,
                 const void* evisc, const void* scal, void* ut, void* vt,
                 void* wt, int nz, int ny, int nx, cudaStream_t stream) {
  const void* staged[4] = {u, v, w, evisc};
  if (tile::vectorizable<T>(nx, staged, 4))
    return launch_fused_tile<T, true>(u, v, w, evisc, scal, ut, vt, wt, nz,
                                      ny, nx, stream);
  return launch_fused_tile<T, false>(u, v, w, evisc, scal, ut, vt, wt, nz,
                                     ny, nx, stream);
}
#else
template <typename T>
int launch_single(const void* f, const void* evisc, const void* scal,
                  void* ft, int nz, int ny, int nx, cudaStream_t stream) {
  return launch_single_ldg<T>(f, evisc, scal, ft, nz, ny, nx, stream);
}

template <typename T>
int launch_fused(const void* u, const void* v, const void* w,
                 const void* evisc, const void* scal, void* ut, void* vt,
                 void* wt, int nz, int ny, int nx, cudaStream_t stream) {
  return launch_fused_ldg<T>(u, v, w, evisc, scal, ut, vt, wt, nz, ny, nx,
                             stream);
}
#endif

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns the launch's cudaError_t.
extern "C" int diff_uvw_fused(int dtype, const void* u, const void* v,
                              const void* w, const void* evisc,
                              const void* scal, void* ut, void* vt, void* wt,
                              int nz, int ny, int nx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fused<float>(u, v, w, evisc, scal, ut, vt, wt, nz, ny, nx,
                               s);
  if (dtype == 1)
    return launch_fused<__nv_bfloat16>(u, v, w, evisc, scal, ut, vt, wt, nz,
                                       ny, nx, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int diff_uvw_single(int dtype, const void* f, const void* evisc,
                               const void* scal, void* ft, int nz, int ny,
                               int nx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_single<float>(f, evisc, scal, ft, nz, ny, nx, s);
  if (dtype == 1)
    return launch_single<__nv_bfloat16>(f, evisc, scal, ft, nz, ny, nx, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
