// matmul — C = A @ B with an f32 accumulator, written in A's dtype.
// A is (m, k), B is (k, n), C is (m, n), all row-major.
//
// Replaces the TPU kernel src/repro/kernels/matmul.py:_mm_kernel
// (pl.pallas_call at matmul.py:137) and its Pallas-Triton twin
// _mm_gpu_kernel (pl.pallas_call at matmul.py:87): one CUDA source serves
// both.
//
// Bound on the H100: operations. 2mnk flop against (mk + kn + mn) elements;
// at the quickstart's (m, n, k) = (512, 512, 1024) that is 0.54 GFLOP for
// 5.2 MB in f32, far above the card's 20 flop/byte.
//
// Two bodies behind one entry point; a build compiles one of them, by the
// launch's dtype (-DBF16) and by whether the rows allow 16-byte access
// (-DVEC), which the wrapper (kernels/matmul.py) decides from the shape:
//
//  * f32 body (BF16=0; and BF16=1 with VEC=0): a register-blocked SIMT
//    SGEMM on the CUDA cores in IEEE f32 FMAs — never TF32 or 3xTF32, whose
//    rounding would miss the f32 tolerance of 1e-5. 256 threads own a
//    BLOCK_M x BLOCK_N tile of C, each thread a TM x TN = (BLOCK_M / 16) x
//    (BLOCK_N / 16) sub-tile split 4 + 4 in both directions (rows
//    4 ty + i and 64 + 4 ty + i), so its A and B fragments are float4 reads
//    of shared memory that the warps of 4 ty x 8 tx take without bank
//    conflicts: 64 FMAs per 4 vector loads at 8 x 8. A is stored k-major
//    (transposed, rows padded by 4 words) so a thread's A values lie next
//    to each other. A ring of STAGES shared-memory tiles is filled with
//    cp.async: A by 4-byte copies whose destination transposes it (a warp
//    reads 4 rows x 8 consecutive k: whole 32-byte sectors, 32 banks), B by
//    16-byte copies when VEC=1 (k % 4 == 0, n % 4 == 0, 16-byte aligned
//    pointers) and 4-byte ones otherwise; copies past the edge fill zeros.
//    bf16 operands that TMA cannot take are read with plain loads, widened
//    to f32 and stored into the same ring. One __syncthreads per k step:
//    the copies of tile t + STAGES - 1 fly while tile t is multiplied.
//  * bf16 body (BF16=1, VEC=1: k % 8 == 0, n % 8 == 0, 16-byte aligned
//    pointers — TMA's rule for global strides and addresses): TMA + wgmma
//    on the tensor cores. BLOCK_M / 64 warpgroups (1 or 2) each own 64 rows
//    of the BLOCK_M x BLOCK_N tile. Thread 0 keeps a ring of STAGES stages
//    filled by TMA loads of the A box (BLOCK_M x 64) and the B panels
//    (64 x 64 each), 128-byte swizzled; each stage has a full mbarrier that
//    expects the transaction bytes and an empty mbarrier on which every
//    warp arrives once the wgmma that read the stage has been waited on.
//    Per 64-deep tile each warpgroup issues four
//    wgmma.m64nBLOCK_Nk16.f32.bf16.bf16 with both operands described from
//    shared memory (B MN-major, through the transpose-B immediate) and f32
//    accumulators in registers, keeps one tile's group in flight
//    (wait_group 1), and then releases the previous tile's stage, which
//    thread 0 refills STAGES tiles ahead. k always moves 64 at a time here
//    (one swizzle row); BLOCK_K is the f32 body's depth. TMA zero-fills
//    boxes past the edges, so ragged m, n and k need no load masks; the
//    epilogue masks its stores.
//
// Split-K (SPLIT_K = 1, 2, 4): the grid's z axis cuts the k tiles into
// SPLIT_K block-aligned ranges. With SPLIT_K > 1 each slice writes its f32
// partial tile to a workspace of SPLIT_K x m x n f32 (the wrapper allocates
// it), and splitk_reduce sums the slices in increasing z order and writes C.
// No atomics: one config gives bit-identical results from launch to
// launch. Within a slice every output sums its products in increasing k
// order, so configs of one body with the same SPLIT_K agree bit for bit;
// configs with different SPLIT_K (or bodies) group the sum differently and
// differ by rounding only. Each partial is an f32 sum of k / SPLIT_K
// products with relative error about (k / SPLIT_K) * 2^-24 of the sum of
// |products|, and adding SPLIT_K partials adds SPLIT_K * 2^-24 more; at
// k = 8192 that is below 1e-3 of sum|a b| in the worst case and about
// sqrt(k) * 2^-24 ~ 5e-6 of it for random signs — within the tuner's
// tolerance (1e-5 relative plus 1e-5 x max|C|).
//
// GRID_MN picks the grid order, the counterpart of grid_order: 1 walks m
// tiles along blockIdx.x ("mnk"), 0 walks n tiles there ("nmk"). Dynamic
// shared memory above 48 KB is asked for with cudaFuncSetAttribute; a
// refusal (above 227 KB) comes back as the launch's error code.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#if BF16 && VEC
#include "hopper.cuh"
#endif

namespace {

#if BF16
typedef __nv_bfloat16 T;
#else
typedef float T;
#endif

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// The k tiles [begin, begin + count) of split slice z, tiles of `depth`.
struct KRange {
  int begin, count;
};
__device__ __forceinline__ KRange k_range(int k, int depth) {
  const int tiles = (k + depth - 1) / depth;
  const int per = (tiles + SPLIT_K - 1) / SPLIT_K;
  const int begin = blockIdx.z * per;
  const int count = begin < tiles ? min(per, tiles - begin) : 0;
  return {begin, count};
}

__device__ __forceinline__ void block_origin(int& m0, int& n0) {
#if GRID_MN
  m0 = blockIdx.x * BLOCK_M;
  n0 = blockIdx.y * BLOCK_N;
#else
  n0 = blockIdx.x * BLOCK_N;
  m0 = blockIdx.y * BLOCK_M;
#endif
}

// Sums the SPLIT_K f32 partials of each output in increasing z order and
// writes C in its dtype.
__global__ void splitk_reduce(const float* __restrict__ ws, T* __restrict__ c,
                              long long mn) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < mn;
       i += 256LL * gridDim.x) {
    float s = ws[i];
    for (int z = 1; z < SPLIT_K; ++z) s += ws[z * mn + i];
    store(c + i, s);
  }
}

#if !(BF16 && VEC)
// ============================================================ f32 body

constexpr int THREADS = 256;
constexpr int TM = BLOCK_M / 16;          // rows of C a thread owns
constexpr int TN = BLOCK_N / 16;          // columns of C a thread owns
constexpr int AS = BLOCK_M + 4;           // words in a row of A^T
constexpr int A_TILE = BLOCK_K * AS;      // words
constexpr int B_TILE = BLOCK_K * BLOCK_N;
constexpr int STAGE = A_TILE + B_TILE;
constexpr size_t SMEM = static_cast<size_t>(STAGES) * STAGE * 4;
static_assert(TM == 4 || TM == 8, "BLOCK_M 64 or 128");
static_assert(TN == 4 || TN == 8, "BLOCK_N 64 or 128");
static_assert(BLOCK_K % 8 == 0 && STAGES >= 2, "BLOCK_K of 8s, 2+ stages");

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One element of the tile: a cp.async of an f32, or a plain widened load
// of a bf16 (no copy engine converts). Out of range: zero.
__device__ __forceinline__ void put(float* dst, const float* base,
                                    long long off, bool ok) {
  cp_async4(dst, ok ? base + off : base, ok);
}
__device__ __forceinline__ void put(float* dst, const __nv_bfloat16* base,
                                    long long off, bool ok) {
  *dst = ok ? __bfloat162float(base[off]) : 0.0f;
}

// Stage the (BLOCK_M x BLOCK_K) tile of A at (m0, k0) transposed into
// `as`, and the (BLOCK_K x BLOCK_N) tile of B at (k0, n0) into `bs`.
__device__ __forceinline__ void load_tile(float* as, float* bs,
                                          const T* __restrict__ a,
                                          const T* __restrict__ b, int m,
                                          int n, int k, int m0, int n0,
                                          int k0) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // A: a warp copies 4 rows x 8 consecutive k per task
#pragma unroll
  for (int task = warp; task < BLOCK_M * BLOCK_K / 32; task += 8) {
    const int q = (task % (BLOCK_K / 8)) * 8 + lane % 8;
    const int r = (task / (BLOCK_K / 8)) * 4 + lane / 8;
    const int gm = m0 + r, gk = k0 + q;
    put(as + q * AS + r, a, static_cast<long long>(gm) * k + gk,
        gm < m && gk < k);
  }
#if VEC
  // B: 16-byte chunks (n % 4 == 0: a chunk is all in or all out)
#pragma unroll
  for (int e = threadIdx.x; e < BLOCK_K * BLOCK_N / 4; e += THREADS) {
    const int r = e / (BLOCK_N / 4), q = (e % (BLOCK_N / 4)) * 4;
    const int gk = k0 + r, gn = n0 + q;
    const bool ok = gk < k && gn < n;
    cp_async16(bs + r * BLOCK_N + q,
               ok ? b + static_cast<long long>(gk) * n + gn : b, ok);
  }
#else
#pragma unroll
  for (int e = threadIdx.x; e < BLOCK_K * BLOCK_N; e += THREADS) {
    const int r = e / BLOCK_N, q = e % BLOCK_N;
    const int gk = k0 + r, gn = n0 + q;
    put(bs + r * BLOCK_N + q, b, static_cast<long long>(gk) * n + gn,
        gk < k && gn < n);
  }
#endif
}

__global__ void __launch_bounds__(THREADS)
    matmul_f32_body(const T* __restrict__ a, const T* __restrict__ b,
                    T* __restrict__ c, float* __restrict__ ws, int m, int n,
                    int k) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int m0, n0;
  block_origin(m0, n0);
  const KRange kr = k_range(k, BLOCK_K);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int tx = (warp % 2) * 8 + lane % 8;   // 16 x 16 threads, warps of
  const int ty = (warp / 2) * 4 + lane / 8;   // 4 ty x 8 tx

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kr.count)
      load_tile(smem + s * STAGE, smem + s * STAGE + A_TILE, a, b, m, n, k,
                m0, n0, (kr.begin + s) * BLOCK_K);
    cp_async_commit();
  }
  for (int t = 0; t < kr.count; ++t) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of tile t landed
    __syncthreads();   // everyone's did, and tile t - 1 is no longer read
    const int nt = t + STAGES - 1;
    if (nt < kr.count) {
      float* st = smem + (nt % STAGES) * STAGE;
      load_tile(st, st + A_TILE, a, b, m, n, k, m0, n0,
                (kr.begin + nt) * BLOCK_K);
    }
    cp_async_commit();
    const float* as = smem + (t % STAGES) * STAGE;
    const float* bs = as + A_TILE;
#pragma unroll
    for (int kk = 0; kk < BLOCK_K; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int h = 0; h < TM / 4; ++h) {
        const float4 v =
            *reinterpret_cast<const float4*>(as + kk * AS + h * 64 + ty * 4);
        av[4 * h] = v.x; av[4 * h + 1] = v.y;
        av[4 * h + 2] = v.z; av[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(
            bs + kk * BLOCK_N + h * 64 + tx * 4);
        bv[4 * h] = v.x; bv[4 * h + 1] = v.y;
        bv[4 * h + 2] = v.z; bv[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (gm >= m) continue;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int gn = n0 + h * 64 + tx * 4;
      const float* v = &acc[i][4 * h];
#if SPLIT_K > 1
      float* out = ws + static_cast<long long>(blockIdx.z) * m * n +
                   static_cast<long long>(gm) * n + gn;
#else
      T* out = c + static_cast<long long>(gm) * n + gn;
#endif
#if VEC
      if (gn < n)
        *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
#else
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gn + j < n) store(out + j, v[j]);
#endif
    }
  }
}

int launch_body(const T* a, const T* b, T* c, float* ws, int m, int n, int k,
                dim3 grid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      matmul_f32_body, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM));
  if (err != cudaSuccess) {
    cudaGetLastError();   // clear it, so the next launch does not see it
    return static_cast<int>(err);
  }
  matmul_f32_body<<<grid, THREADS, SMEM, stream>>>(a, b, c, ws, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

#else
// ============================================================ bf16 body

constexpr int WG = BLOCK_M / 64;              // consumer warpgroups
constexpr int THREADS = 128 * WG;
constexpr int KT = 64;                        // k per tile: one swizzle row
constexpr int A_BYTES = BLOCK_M * KT * 2;     // one A box
constexpr int PANEL_BYTES = KT * 64 * 2;      // one 64-column B panel
constexpr int B_BYTES = BLOCK_N / 64 * PANEL_BYTES;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int ACC = BLOCK_N / 2;              // f32 accumulators a thread
// 1024 bytes of slack to align the ring, then the ring, then full[] and
// empty[] barriers.
constexpr size_t SMEM = 1024 + static_cast<size_t>(STAGES) * STAGE_BYTES +
                        2 * STAGES * sizeof(uint64_t);
static_assert(WG == 1 || WG == 2, "BLOCK_M 64 or 128");
static_assert(BLOCK_N == 64 || BLOCK_N == 128, "BLOCK_N 64 or 128");
static_assert(STAGES >= 2, "a ring of 2+ stages");

__device__ __forceinline__ void fill_stage(uint8_t* st, uint64_t* full,
                                           const CUtensorMap* ta,
                                           const CUtensorMap* tb, int m0,
                                           int n0, int k0) {
  mbar_expect_tx(full, STAGE_BYTES);
  tma_load_2d(st, ta, full, k0, m0);
#pragma unroll
  for (int p = 0; p < BLOCK_N / 64; ++p)
    tma_load_2d(st + A_BYTES + p * PANEL_BYTES, tb, full, n0 + 64 * p, k0);
}

__global__ void __launch_bounds__(THREADS)
    matmul_bf16_body(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb,
                     __nv_bfloat16* __restrict__ c, float* __restrict__ ws,
                     int m, int n, int k) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  int m0, n0;
  block_origin(m0, n0);
  const KRange kr = k_range(k, KT);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = warp / 4;   // this thread's warpgroup: rows 64 g .. 64 g + 63

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, THREADS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < STAGES && s < kr.count; ++s)
      fill_stage(ring + s * STAGE_BYTES, full + s, &ta, &tb, m0, n0,
                 (kr.begin + s) * KT);

  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.0f;

  for (int t = 0; t < kr.count; ++t) {
    const int s = t % STAGES;
    mbar_wait(full + s, (t / STAGES) & 1);
    __syncwarp();   // wgmma is .aligned: the whole warp, converged
    const uint8_t* as = ring + s * STAGE_BYTES + g * 64 * 128;
    const uint8_t* bs = ring + s * STAGE_BYTES + A_BYTES;
    wgmma_fence_operands<ACC>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
      wgmma_m64k16<BLOCK_N>(acc, wgmma_desc_sw128(as + 32 * kk, 16, 1024),
                            wgmma_desc_sw128(bs + 16 * kk * 128, PANEL_BYTES,
                                             1024));
    wgmma_commit();
    // The products of tile t - 1 are done: its stage may be refilled.
    wgmma_wait<1>();
    wgmma_fence_operands<ACC>(acc);
    const int done = t - 1;
    if (done >= 0) {
      const int sd = done % STAGES;
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + sd);
      if (tid == 0 && done + STAGES < kr.count) {
        mbar_wait(empty + sd, (done / STAGES) & 1);
        fill_stage(ring + sd * STAGE_BYTES, full + sd, &ta, &tb, m0, n0,
                   (kr.begin + done + STAGES) * KT);
      }
      __syncwarp();
    }
  }
  wgmma_wait<0>();
  wgmma_fence_operands<ACC>(acc);

  // Accumulator layout of m64nNk16: warp w of the group holds rows
  // 16 (w % 4) + lane / 4 (+ 8); register 4 j + e holds column
  // 8 j + 2 (lane % 4) + (e % 2), the row + 8 for e >= 2.
  const int r0 = m0 + g * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BLOCK_N / 8; ++j) {
    const int gn = n0 + 8 * j + 2 * (lane % 4);   // even; n % 8 == 0
    if (gn >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = r0 + 8 * h;
      if (gm >= m) continue;
      const long long off = static_cast<long long>(gm) * n + gn;
#if SPLIT_K > 1
      *reinterpret_cast<float2*>(
          ws + static_cast<long long>(blockIdx.z) * m * n + off) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
#else
      *reinterpret_cast<__nv_bfloat162*>(c + off) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
#endif
    }
  }
}

int launch_body(const T* a, const T* b, T* c, float* ws, int m, int n, int k,
                dim3 grid, cudaStream_t stream) {
  if (k % 8 != 0 || n % 8 != 0 ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ta, tb;
  int err = make_tma_map_bf16(&ta, a, m, k, BLOCK_M);
  if (err == 0) err = make_tma_map_bf16(&tb, b, k, n, KT);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      matmul_bf16_body, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM));
  if (e != cudaSuccess) {
    cudaGetLastError();   // clear it, so the next launch does not see it
    return static_cast<int>(e);
  }
  matmul_bf16_body<<<grid, THREADS, SMEM, stream>>>(ta, tb, c, ws, m, n, k);
  return static_cast<int>(cudaGetLastError());
}
#endif

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, and must be this build's (-DBF16).
// ws: SPLIT_K x m x n f32 (unused when SPLIT_K == 1). Returns the
// cudaError_t of the launches.
extern "C" int matmul_launch(int dtype, const void* a, const void* b, void* c,
                             void* ws, int m, int n, int k, void* stream) {
  if (dtype != BF16 || m < 1 || n < 1 || k < 1 || (SPLIT_K > 1 && !ws))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int tm = (m + BLOCK_M - 1) / BLOCK_M;
  const unsigned int tn = (n + BLOCK_N - 1) / BLOCK_N;
#if GRID_MN
  const dim3 grid(tm, tn, SPLIT_K);
#else
  const dim3 grid(tn, tm, SPLIT_K);
#endif
  int err = launch_body(static_cast<const T*>(a), static_cast<const T*>(b),
                        static_cast<T*>(c), static_cast<float*>(ws), m, n, k,
                        grid, s);
  if (err != 0 || SPLIT_K == 1) return err;
  const long long mn = static_cast<long long>(m) * n;
  const long long blocks = (mn + 255) / 256;
  splitk_reduce<<<static_cast<unsigned int>(blocks < 4096 ? blocks : 4096),
                  256, 0, s>>>(static_cast<const float*>(ws),
                               static_cast<T*>(c), mn);
  return static_cast<int>(cudaGetLastError());
}
