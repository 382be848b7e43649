// flash_attention — forward attention over flattened heads, with the online
// softmax, for causal (CAUSAL=1) and full (CAUSAL=0) masks.
// q is (BH, S, D); k and v are (BHkv, S, D), all row-major and contiguous;
// o is (BH, S, D) in q's dtype. Query head bh reads kv row bh / (BH / BHkv),
// so grouped-query attention never materialises repeated kv heads. The
// scale is 1/sqrt(D); o = acc / max(l, 1e-30).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_fa_kernel
// (pl.pallas_call at flash_attention.py:123), which serves both builders,
// flash_attention_causal and flash_attention_full.
//
// Bound on the H100: operations. 4 * BH * S^2 * D flop in full mode and
// about half that in causal mode, against 2 * (BH + BHkv) * S * D elements
// moved; at the LM slice's BH = 128, S = 2048, D = 128 in bf16 that is
// 137 GFLOP for 268 MB, about 500 flop a byte, above the card's 295.
//
// Design (one thread block per (bh, tile of BLOCK_Q query rows)):
//  * The block stages its Q tile in shared memory once, then walks the k/v
//    tiles of BLOCK_K rows through shared memory. In causal mode the walk
//    stops at the tile holding the block's last query row (the counterpart
//    of the pl.when skip) and q tiles are launched last-first, so the long
//    rows start early; a warp whose rows all lie above a tile skips its
//    arithmetic there. Keys at or past S and, in causal mode, keys after the
//    query row are masked (score -1e30, weight exactly 0), so every config
//    runs on every S.
//  * Each warp owns RW = BLOCK_Q / (THREADS / 32) query rows (16 or 32) and
//    keeps their softmax state (m, l) and output accumulator in registers
//    (bf16) or thread-private arrays (f32).
//  * bf16: both products run on the tensor cores through mma.sync m16n8k16
//    (bf16 inputs, f32 accumulators); scores are kept in the log2 domain
//    and exponentiated with exp2f. P is rounded to bf16 where it is packed
//    into the A operand of the P.V product (pack_bf16 below); l sums the
//    unrounded f32 weights. The V operand is read with ldmatrix.trans.
//    Rows of shared memory are padded by 8 elements, so the fragment loads
//    hit 32 different banks.
//  * f32: IEEE f32 FMAs on the CUDA cores, never TF32, whose 10-bit
//    mantissa would miss the f32 tolerance of 1e-5. Lanes split the keys of
//    a tile for Q.K and the head dimension for P.V; warp shuffles reduce
//    the row max and sum. Rows of shared memory are padded by one word.
//  * No cp.async double buffering, wgmma, TMA or warp specialisation yet.
//
// Tunables (-D): BLOCK_Q, BLOCK_K, THREADS; CAUSAL; HEAD_DIM is the
// problem's D. The launcher asks for the dynamic shared memory above 48 KB
// with cudaFuncSetAttribute and returns its error if the card refuses.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = HEAD_DIM;
constexpr int WARPS = THREADS / 32;
constexpr int RW = BLOCK_Q / WARPS;   // query rows per warp
constexpr int MT = RW / 16;           // m16 tiles per warp (bf16 path)
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

static_assert(THREADS % 32 == 0 && BLOCK_Q % WARPS == 0, "whole warps");
static_assert(RW == 16 || RW == 32, "16 or 32 query rows per warp");
static_assert(BLOCK_K % 32 == 0, "key tiles of whole warps");
static_assert(D == 128 || D == 256, "head dim 128 or 256");

constexpr int BF_STRIDE = D + 8;   // bf16 elements per shared-memory row
constexpr int F_STRIDE = D + 1;    // f32 words per shared-memory row
constexpr size_t SMEM_BF16 =
    static_cast<size_t>(BLOCK_Q + 2 * BLOCK_K) * BF_STRIDE * 2;
constexpr size_t SMEM_F32 =
    static_cast<size_t>(BLOCK_Q + 2 * BLOCK_K) * F_STRIDE * 4;

__device__ __forceinline__ int q_tile() {
#if CAUSAL
  return gridDim.x - 1 - blockIdx.x;   // longest rows first
#else
  return blockIdx.x;
#endif
}

// Number of k/v tiles the block at query offset q0 must visit.
__device__ __forceinline__ int k_tiles(int q0, int s) {
  const int n = (s + BLOCK_K - 1) / BLOCK_K;
#if CAUSAL
  const int diag = (q0 + BLOCK_Q - 1) / BLOCK_K + 1;
  return diag < n ? diag : n;
#else
  return n;
#endif
}

__device__ __forceinline__ bool key_ok(int key, int row, int s) {
#if CAUSAL
  return key < s && key <= row;
#else
  return key < s;
#endif
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// ------------------------------------------------------------------ bf16

// rows [r0, r0 + rows) of a (S, D) matrix into shared memory, 16 bytes a
// thread; rows at or past S are zero.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int rows, int s) {
  constexpr int VPR = D / 8;   // 16-byte vectors per row
  for (int i = threadIdx.x; i < rows * VPR; i += THREADS) {
    const int r = i / VPR, c = i % VPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < s)
      val = __ldg(reinterpret_cast<const uint4*>(
                      src + static_cast<size_t>(r0 + r) * D) + c);
    *reinterpret_cast<uint4*>(dst + r * BF_STRIDE + c * 8) = val;
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two f32 values as one bf16 pair, lo in the low half: this is where P is
// rounded to bf16 before the P.V product.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// c += a . b on one m16n8k16 tile: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B operand (k = 16 keys, n = 8 head dims) of P.V from V rows in shared
// memory: lanes 0-15 address the 16 key rows, .trans hands each lane the
// (key, dim) pairs the fragment layout wants.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const __nv_bfloat16* p) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

__global__ void __launch_bounds__(THREADS)
    fa_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, int s, int group,
                   float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + BLOCK_Q * BF_STRIDE;
  __nv_bfloat16* vs = ks + BLOCK_K * BF_STRIDE;

  const int q0 = q_tile() * BLOCK_Q;
  const int bh = blockIdx.y;
  const size_t q_off = static_cast<size_t>(bh) * s * D;
  const size_t kv_off = static_cast<size_t>(bh / group) * s * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;   // fragment row group, column pair
  const int w0 = warp * RW;                // the warp's first row in the tile
  const float sl2 = scale * LOG2E;

  load_tile(qs, q + q_off, q0, BLOCK_Q, s);

  float acc[MT][D / 8][4];
  float m[MT][2], l[MT][2];   // rows g and g + 8 of each m tile
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[mt][h] = NEG_INF;
      l[mt][h] = 0.0f;
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][dt][e] = 0.0f;
  }

  const int n_kt = k_tiles(q0, s);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BLOCK_K;
    __syncthreads();   // the last tile's readers are done
    load_tile(ks, k + kv_off, k0, BLOCK_K, s);
    load_tile(vs, v + kv_off, k0, BLOCK_K, s);
    __syncthreads();
#if CAUSAL
    if (k0 > q0 + w0 + RW - 1) continue;   // every row of the warp is above
#endif
    const bool masked =
        k0 + BLOCK_K > s || (CAUSAL && k0 + BLOCK_K - 1 > q0 + w0);

    // S = Q K^T on the tensor cores.
    float sc[MT][BLOCK_K / 8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < BLOCK_K / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[mt][nt][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const __nv_bfloat16* qr =
            qs + (w0 + mt * 16 + g) * BF_STRIDE + kk + 2 * t;
        a[mt][0] = ld32(qr);
        a[mt][1] = ld32(qr + 8 * BF_STRIDE);
        a[mt][2] = ld32(qr + 8);
        a[mt][3] = ld32(qr + 8 * BF_STRIDE + 8);
      }
#pragma unroll
      for (int nt = 0; nt < BLOCK_K / 8; ++nt) {
        const __nv_bfloat16* kr = ks + (nt * 8 + g) * BF_STRIDE + kk + 2 * t;
        const uint32_t b0 = ld32(kr), b1 = ld32(kr + 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma(sc[mt][nt], a[mt], b0, b1);
      }
    }

    // Online softmax, per row; a row's columns sit in the 4 lanes of a quad.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q0 + w0 + mt * 16 + g + 8 * h;
        float mx = m[mt][h];
#pragma unroll
        for (int nt = 0; nt < BLOCK_K / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = sc[mt][nt][2 * h + e] * sl2;
            if (masked && !key_ok(k0 + nt * 8 + 2 * t + e, row, s))
              x = NEG_INF;
            sc[mt][nt][2 * h + e] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
        const float alpha = exp2f(m[mt][h] - mx);
        float rs = 0.0f;
#pragma unroll
        for (int nt = 0; nt < BLOCK_K / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = sc[mt][nt][2 * h + e];
            const float p = x == NEG_INF ? 0.0f : exp2f(x - mx);
            sc[mt][nt][2 * h + e] = p;
            rs += p;
          }
        rs += __shfl_xor_sync(FULL, rs, 1);
        rs += __shfl_xor_sync(FULL, rs, 2);
        l[mt][h] = alpha * l[mt][h] + rs;
        m[mt][h] = mx;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          acc[mt][dt][2 * h] *= alpha;
          acc[mt][dt][2 * h + 1] *= alpha;
        }
      }
    }

    // O += P V on the tensor cores: the score tiles 2j and 2j + 1 are the
    // A fragment of key block j.
#pragma unroll
    for (int kb = 0; kb < BLOCK_K / 16; ++kb) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = pack_bf16(sc[mt][2 * kb][0], sc[mt][2 * kb][1]);
        a[mt][1] = pack_bf16(sc[mt][2 * kb][2], sc[mt][2 * kb][3]);
        a[mt][2] = pack_bf16(sc[mt][2 * kb + 1][0], sc[mt][2 * kb + 1][1]);
        a[mt][3] = pack_bf16(sc[mt][2 * kb + 1][2], sc[mt][2 * kb + 1][3]);
      }
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1,
                          vs + (kb * 16 + (lane & 15)) * BF_STRIDE + dt * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma(acc[mt][dt], a[mt], b0, b1);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + w0 + mt * 16 + g + 8 * h;
      if (row >= s) continue;
      const float inv = 1.0f / fmaxf(l[mt][h], 1e-30f);
      __nv_bfloat16* orow = o + q_off + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) =
            __floats2bfloat162_rn(acc[mt][dt][2 * h] * inv,
                                  acc[mt][dt][2 * h + 1] * inv);
    }
}

// ------------------------------------------------------------------- f32

__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int rows, int s) {
  for (int i = threadIdx.x; i < rows * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[r * F_STRIDE + c] =
        r0 + r < s ? __ldg(src + static_cast<size_t>(r0 + r) * D + c) : 0.0f;
  }
}

__global__ void __launch_bounds__(THREADS)
    fa_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int s,
                  int group, float scale) {
  constexpr int CPL = BLOCK_K / 32;   // keys per lane
  constexpr int DPL = D / 32;         // head dims per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + BLOCK_Q * F_STRIDE;
  float* vs = ks + BLOCK_K * F_STRIDE;

  const int q0 = q_tile() * BLOCK_Q;
  const int bh = blockIdx.y;
  const size_t q_off = static_cast<size_t>(bh) * s * D;
  const size_t kv_off = static_cast<size_t>(bh / group) * s * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int w0 = warp * RW;

  load_tile(qs, q + q_off, q0, BLOCK_Q, s);

  float acc[RW][DPL], m[RW], l[RW];
  for (int r = 0; r < RW; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.0f;
    for (int j = 0; j < DPL; ++j) acc[r][j] = 0.0f;
  }

  const int n_kt = k_tiles(q0, s);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BLOCK_K;
    __syncthreads();
    load_tile(ks, k + kv_off, k0, BLOCK_K, s);
    load_tile(vs, v + kv_off, k0, BLOCK_K, s);
    __syncthreads();
#if CAUSAL
    if (k0 > q0 + w0 + RW - 1) continue;
#endif
#pragma unroll 1
    for (int r = 0; r < RW; ++r) {
      const int row = q0 + w0 + r;
      const float* qr = qs + (w0 + r) * F_STRIDE;
      float sc[CPL];
      bool ok[CPL];
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const float* kr = ks + (lane + 32 * j) * F_STRIDE;
        float dot = 0.0f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        ok[j] = key_ok(k0 + lane + 32 * j, row, s);
        sc[j] = ok[j] ? dot * scale : NEG_INF;
        mx = fmaxf(mx, sc[j]);
      }
      mx = warp_max(mx);
      const float alpha = expf(m[r] - mx);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        sc[j] = ok[j] ? expf(sc[j] - mx) : 0.0f;
        rs += sc[j];
      }
      rs = warp_sum(rs);
      l[r] = alpha * l[r] + rs;
      m[r] = mx;
      float a[DPL];
#pragma unroll
      for (int j = 0; j < DPL; ++j) a[j] = acc[r][j] * alpha;
#pragma unroll
      for (int c = 0; c < BLOCK_K; ++c) {
        const float p = __shfl_sync(FULL, sc[c / 32], c % 32);
        const float* vr = vs + c * F_STRIDE + lane;
#pragma unroll
        for (int j = 0; j < DPL; ++j) a[j] = fmaf(p, vr[32 * j], a[j]);
      }
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[r][j] = a[j];
    }
  }

  for (int r = 0; r < RW; ++r) {
    const int row = q0 + w0 + r;
    if (row >= s) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    float* orow = o + q_off + static_cast<size_t>(row) * D + lane;
    for (int j = 0; j < DPL; ++j) orow[32 * j] = acc[r][j] / denom;
  }
}

// ---------------------------------------------------------------- launch

template <typename T>
int launch(void (*kern)(const T*, const T*, const T*, T*, int, int, float),
           size_t smem, const void* q, const void* k, const void* v, void* o,
           int bh, int bhkv, int s, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();   // clear it, so the next launch does not see it
    return static_cast<int>(err);
  }
  const dim3 grid((s + BLOCK_Q - 1) / BLOCK_Q, bh);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s, bh / bhkv,
      1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a shape this build does not take).
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* o, int bh,
                                      int bhkv, int s, int d, void* stream) {
  if (d != D || bh < 1 || bhkv < 1 || bh % bhkv != 0 || s < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(fa_f32_kernel, SMEM_F32, q, k, v, o, bh, bhkv, s, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(fa_bf16_kernel, SMEM_BF16, q, k, v, o, bh,
                                 bhkv, s, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
