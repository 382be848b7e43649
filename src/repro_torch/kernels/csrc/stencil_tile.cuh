// The `tile` body's walk, shared by advec_u.cu and diff_uvw.cu (built with
// -DTILE=1): the 2.5-D design for a stencil on this card.
//
// A block of BLOCK_SIZE_X x BLOCK_SIZE_Y threads owns that tile of (x, y)
// and marches a strip of STRIP_Z planes in z. Each plane of each field is
// staged into shared memory with its halo (Stage) through cp.async, AHEAD
// planes before the block reads it, into a ring of L + 1 + AHEAD buffers
// (L: the stencil's radius in z). Each thread keeps its own column's z
// neighbours in a register queue, pushed from the ring as each plane
// arrives, and reads its x and y neighbours from the ring. So each plane of
// each field leaves HBM about once per block (the halo mostly comes from
// L2), and a point costs one global load per field and a dozen
// shared-memory reads, where the ldg body issues 27 (advec_u) or 14
// (diff_uvw) loads per point. A strip starts with a warm-up of L planes
// below it and ends with L above it, wrapped periodically: 2L / STRIP_Z
// planes more than the strip itself. What bounds it on the H100 is not
// measured (no profiler counters there). bf16 moves half of f32's bytes
// and runs barely faster, so the bytes alone do not; the hypothesis is
// that the instructions a point issues (shared-memory reads, the stencil
// arithmetic, the queue shifts) set the pace (PERF.md).
//
// Rows and 16-byte chunks wrap with a true modulo, so a tile with its halo
// may be wider than the grid. When nx is a multiple of a chunk (4 f32, 8
// bf16) and every staged field starts on a 16-byte boundary ("vec"), every
// chunk of a staged row maps to a whole chunk of the grid, the halo
// included: the row is staged from one chunk left of the tile to one chunk
// right of it, all in 16-byte copies. Otherwise each element is copied on
// its own: f32 by a 4-byte cp.async, bf16 by a load and a store (cp.async
// copies 4, 8 or 16 bytes). The launcher picks, per launch, between two
// instantiations of each kernel (VEC true or false), so the vec one keeps
// no register for the other path.
#pragma once

#include <cstdint>

#include "common.cuh"

#define TILE_THREADS (BLOCK_SIZE_X * BLOCK_SIZE_Y)

namespace tile {

// Planes in flight while the block computes on an earlier one.
constexpr int AHEAD = 2;

// a wrapped periodically into [0, n), for any a.
__device__ __forceinline__ int halo_index(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy16(void* s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(s)),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void copy1(float* s, const float* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(s)),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void copy1(__nv_bfloat16* s,
                                      const __nv_bfloat16* g) {
  *reinterpret_cast<unsigned short*>(s) =
      __ldg(reinterpret_cast<const unsigned short*>(g));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The block's tile origin (x0, y0), its strip [z0, z1) and its thread's
// linear index.
struct Block {
  int x0, y0, z0, z1, tid;
};

__device__ __forceinline__ Block block_of(int nz, int gx, int gy, int gz) {
  int bx, by, bz;
  unravel(blockIdx.x, gx, gy, gz, bx, by, bz);
  Block b;
  b.x0 = bx * BLOCK_SIZE_X;
  b.y0 = by * BLOCK_SIZE_Y;
  b.z0 = bz * STRIP_Z;
  b.z1 = min(b.z0 + STRIP_Z, nz);
  b.tid = threadIdx.y * BLOCK_SIZE_X + threadIdx.x;
  return b;
}

// One field's plane as a block stages it: rows y0 - HY .. y0 + BLOCK_SIZE_Y
// + HY - 1 and columns x0 - PX .. x0 + BLOCK_SIZE_X + PX - 1, wrapped, row
// major with PITCH elements a row. PX is one 16-byte chunk when the stencil
// reaches across x (0 < HX <= a chunk), so the tile's first column sits on
// a 16-byte boundary.
template <typename T, int HY, int HX, bool VEC>
struct Stage {
  static constexpr int V = 16 / static_cast<int>(sizeof(T));
  static_assert(HX <= V && BLOCK_SIZE_X % V == 0,
                "a halo wider than a chunk, or a tile not whole chunks");
  static constexpr int PX = HX > 0 ? V : 0;
  static constexpr int ROWS = BLOCK_SIZE_Y + 2 * HY;
  static constexpr int PITCH = BLOCK_SIZE_X + 2 * PX;
  static constexpr int CPR = PITCH / V;  // chunks a row
  static constexpr int CHUNKS = ROWS * CPR;
  static constexpr int PER_THREAD = (CHUNKS + TILE_THREADS - 1) / TILE_THREADS;
  static constexpr int ELEMS = ROWS * PITCH;  // one buffer

  int off[PER_THREAD];  // y * nx + x of this thread's chunks (VEC)

  __device__ __forceinline__ void init(const Block& b, int ny, int nx) {
    if (!VEC) return;
    const int cx0 = (b.x0 - PX) / V;  // exact: x0 is a multiple of V
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int q = b.tid + j * TILE_THREADS;
      off[j] = halo_index(b.y0 - HY + q / CPR, ny) * nx +
               halo_index(cx0 + q % CPR, nx / V) * V;
    }
  }

  // Issue the copies of the plane at zoff (= z * ny * nx, z wrapped) of g
  // into the buffer s.
  __device__ __forceinline__ void load(T* s, const T* __restrict__ g, int zoff,
                                       const Block& b, int ny,
                                       int nx) const {
    if constexpr (VEC) {
#pragma unroll
      for (int j = 0; j < PER_THREAD; ++j) {
        const int q = b.tid + j * TILE_THREADS;
        if (CHUNKS % TILE_THREADS == 0 || q < CHUNKS)
          copy16(s + q * V, g + zoff + off[j]);
      }
    } else {
      for (int q = b.tid; q < ELEMS; q += TILE_THREADS)
        copy1(s + q, g + zoff + halo_index(b.y0 - HY + q / PITCH, ny) * nx +
                         halo_index(b.x0 - PX + q % PITCH, nx));
    }
  }
};

// The strip's march over `planes` staged planes (plane p is z = z0 - L + p,
// wrapped): load(p, buffer) issues plane p's copies into ring buffer
// `buffer`; step(p, buffer) runs once plane p is in shared memory for every
// thread, in buffer p % NBUF. Plane p + AHEAD is in flight during step(p),
// into the buffer that plane p - L - 1 held, so a ring of NBUF = L + 1 +
// AHEAD buffers keeps planes p - L .. p readable. The loop is unrolled by
// NBUF, so every buffer index is a constant of its copy of the body.
template <int NBUF, typename Load, typename Step>
__device__ __forceinline__ void march(int planes, Load load, Step step) {
  static_assert(AHEAD < NBUF, "a ring shorter than the planes in flight");
#pragma unroll
  for (int p = 0; p < AHEAD; ++p) {
    if (p < planes) load(p, p);
    commit();
  }
  for (int p0 = 0; p0 < planes; p0 += NBUF) {
#pragma unroll
    for (int r = 0; r < NBUF; ++r) {
      const int p = p0 + r;
      if (p >= planes) break;
      wait<AHEAD - 1>();  // this thread's copies of plane p have landed
      __syncthreads();    // everyone's have; step(p - 1) is done everywhere
      if (p + AHEAD < planes) load(p + AHEAD, (r + AHEAD) % NBUF);
      commit();
      step(p, r);
    }
  }
}

// Shift a register queue by one plane and push x at its front.
template <int N>
__device__ __forceinline__ void push(float (&q)[N], float x) {
#pragma unroll
  for (int s = 0; s + 1 < N; ++s) q[s] = q[s + 1];
  q[N - 1] = x;
}

// Whether every staged field may go by 16-byte chunks (see above).
template <typename T>
static inline bool vectorizable(int nx, const void* const* fields, int n) {
  if (nx % (16 / static_cast<int>(sizeof(T)))) return false;
  for (int f = 0; f < n; ++f)
    if (reinterpret_cast<std::uintptr_t>(fields[f]) % 16) return false;
  return true;
}

// Grid of a tile launch: x/y tiles of the block, z strips of STRIP_Z.
static inline StencilGrid grid(int nz, int ny, int nx) {
  StencilGrid g;
  g.gx = (nx + BLOCK_SIZE_X - 1) / BLOCK_SIZE_X;
  g.gy = (ny + BLOCK_SIZE_Y - 1) / BLOCK_SIZE_Y;
  g.gz = (nz + STRIP_Z - 1) / STRIP_Z;
  g.blocks = static_cast<long long>(g.gx) * g.gy * g.gz;
  return g;
}

}  // namespace tile
