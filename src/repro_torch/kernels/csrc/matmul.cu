// matmul — C = A @ B with an f32 accumulator, written in A's dtype.
// A is (m, k), B is (k, n), C is (m, n), all row-major.
//
// Replaces the TPU kernel src/repro/kernels/matmul.py:_mm_kernel
// (pl.pallas_call at matmul.py:137) and its Pallas-Triton twin
// _mm_gpu_kernel (pl.pallas_call at matmul.py:87): one CUDA kernel serves
// both.
//
// Bound on the H100: operations. 2mnk flop against (mk + kn + mn) elements;
// at the quickstart's 512 x 1024 x 512 that is 0.54 GFLOP for 5.2 MB in f32,
// far above the card's 20 flop/byte. f32 inputs use IEEE f32 FMAs on the
// CUDA cores (67 TFLOP/s), never TF32, whose 10-bit mantissa would miss the
// f32 tolerance of 1e-5; bf16 inputs are read as bf16 and accumulated in f32
// on the same cores (no tensor cores yet: wgmma and TMA are later work).
//
// Design: a tiled shared-memory GEMM. A block of 256 threads owns a
// BLOCK_M x BLOCK_N tile of C and keeps it in registers, each thread a
// (BLOCK_M / 16) x (BLOCK_N / 16) sub-tile strided by 16 so that neighbouring
// threads touch neighbouring shared-memory words and C addresses. The k loop
// stages BLOCK_K-deep slices of A (transposed, padded against bank
// conflicts) and B in shared memory as f32. Every output element sums its k
// products in increasing k order whatever the tiling, so all configs give
// bit-identical results. Ragged edges are masked (zero-filled loads, guarded
// stores), so blocks need not divide the problem. GRID_MN picks the grid
// order, the counterpart of grid_order: 1 walks m tiles along blockIdx.x
// ("mnk"), 0 walks n tiles there ("nmk").
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TM = BLOCK_M / 16;
constexpr int TN = BLOCK_N / 16;
static_assert(BLOCK_M % 16 == 0 && BLOCK_N % 16 == 0, "tiles of 16");

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ c, int m, int n, int k) {
  __shared__ float as[BLOCK_K][BLOCK_M + 1];
  __shared__ float bs[BLOCK_K][BLOCK_N];
#if GRID_MN
  const int m0 = blockIdx.x * BLOCK_M, n0 = blockIdx.y * BLOCK_N;
#else
  const int n0 = blockIdx.x * BLOCK_N, m0 = blockIdx.y * BLOCK_M;
#endif
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += BLOCK_K) {
    for (int idx = threadIdx.x; idx < BLOCK_M * BLOCK_K; idx += THREADS) {
      const int r = idx / BLOCK_K, q = idx % BLOCK_K;
      const int gm = m0 + r, gk = k0 + q;
      as[q][r] = (gm < m && gk < k)
                     ? load(a + static_cast<long long>(gm) * k + gk)
                     : 0.0f;
    }
    for (int idx = threadIdx.x; idx < BLOCK_K * BLOCK_N; idx += THREADS) {
      const int r = idx / BLOCK_N, q = idx % BLOCK_N;
      const int gk = k0 + r, gn = n0 + q;
      bs[r][q] = (gk < k && gn < n)
                     ? load(b + static_cast<long long>(gk) * n + gn)
                     : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BLOCK_K; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < n) store(c + static_cast<long long>(gm) * n + gn, acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* c, int m, int n, int k,
           cudaStream_t stream) {
  const unsigned int tm = (m + BLOCK_M - 1) / BLOCK_M;
  const unsigned int tn = (n + BLOCK_N - 1) / BLOCK_N;
#if GRID_MN
  const dim3 grid(tm, tn);
#else
  const dim3 grid(tn, tm);
#endif
  matmul_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int matmul_launch(int dtype, const void* a, const void* b, void* c,
                             int m, int n, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, c, m, n, k, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, c, m, n, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
