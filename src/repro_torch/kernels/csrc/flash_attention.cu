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
//    rows start early (q_tile and k_tiles, shared by every body); warps
//    whose rows all lie above a tile skip its arithmetic there. Keys at or
//    past S and, in causal mode, keys after the query row are masked (score
//    -1e30, weight exactly 0), so every config runs on every S.
//  * Two bodies; a build compiles one of them (-DWGMMA), which the wrapper
//    (kernels/flash_attention.py, choose_body) picks from the dtype, D and
//    the config:
//  * mma body (WGMMA=0): float32 and bfloat16. Each warp owns
//    RW = BLOCK_Q / (THREADS / 32) query rows (16 or 32) and keeps their
//    softmax state (m, l) and output accumulator in registers (bf16) or
//    thread-private arrays (f32). All threads copy each k/v tile through
//    registers between two __syncthreads, so no copy overlaps arithmetic.
//  * mma body, bf16: both products run on the tensor cores through
//    mma.sync m16n8k16
//    (bf16 inputs, f32 accumulators); scores are kept in the log2 domain
//    and exponentiated with exp2f. P is rounded to bf16 where it is packed
//    into the A operand of the P.V product (pack_bf16 below); l sums the
//    unrounded f32 weights. The V operand is read with ldmatrix.trans.
//    Rows of shared memory are padded by 8 elements, so the fragment loads
//    hit 32 different banks.
//  * mma body, f32: IEEE f32 FMAs on the CUDA cores, never TF32, whose
//    10-bit mantissa would miss the f32 tolerance of 1e-5. Lanes split the
//    keys of a tile for Q.K and the head dimension for P.V; warp shuffles
//    reduce the row max and sum. Rows of shared memory are padded by one
//    word.
//  * wgmma body (WGMMA=1): bfloat16 at D = 128, BLOCK_Q 64 or 128 with
//    THREADS = 2 * BLOCK_Q (one warpgroup per 64 query rows, 16 rows a
//    warp), BLOCK_K 64 or 128. Q, K and V arrive by TMA through 3-D tensor
//    maps (D, S, heads), 128-byte swizzled in 64-column panels, so the kv
//    head of query head bh is the TMA coordinate bh / group and rows past S
//    arrive as zeros, never as the next head's rows. Q comes once; K and V
//    go through a ring of two stages, each with a full mbarrier that
//    expects the transaction bytes and an empty mbarrier on which every
//    warp arrives once the P.V wgmma that read the stage has been waited
//    on; thread 0 then refills the stage two tiles ahead (the protocol of
//    matmul.cu's bf16 body), so the next tile's copies fly while this one
//    is multiplied. S = Q K^T is wgmma m64nBLOCK_Kk16 with both operands in
//    shared memory (K stored keys x d is a K-major B: transpose-B 0). The
//    online softmax runs on the accumulator in registers: a warp holds 16
//    rows and each 8-column chunk is laid out as mma.sync's m16n8 C
//    fragment, so it is the mma body's softmax, except that m holds raw
//    scores and each weight costs one FFMA and one ex2.approx.ftz: the
//    softmax's instructions, not the tensor cores, bound this body, and
//    exp2f adds a range fix-up to each. O += P V is wgmma
//    m64n128k16 with P from registers (the RS form; chunks 2j and 2j + 1
//    packed to bf16 are k-step j's A fragment) and V from shared memory
//    (MN-major B, transpose-B 1). No producer warp, warp specialisation,
//    setmaxnreg or overlap of the softmax with the products yet.
//
// Tunables (-D): BLOCK_Q, BLOCK_K, THREADS; CAUSAL; WGMMA; HEAD_DIM is the
// problem's D. The launcher asks for the dynamic shared memory above 48 KB
// with cudaFuncSetAttribute and returns its error if the card refuses.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#if WGMMA
#include "hopper.cuh"
#endif

namespace {

constexpr int D = HEAD_DIM;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

static_assert(D == 128 || D == 256, "head dim 128 or 256");

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

// Two f32 values as one bf16 pair, lo in the low half: this is where P is
// rounded to bf16 before the P.V product.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

#if WGMMA
// ============================================================ wgmma body

// 2^x on the special-function unit, subnormals flushed to zero: exp2f
// without -use_fast_math adds a range fix-up around the same instruction.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr int WG = BLOCK_Q / 64;           // warpgroups, 64 query rows each
constexpr int STAGES = 2;                  // depth of the k/v ring
constexpr int Q_PANEL = BLOCK_Q * 128;     // bytes of a 64-column Q panel
constexpr int KV_PANEL = BLOCK_K * 128;    // bytes of a 64-column K/V panel
constexpr int Q_BYTES = D / 64 * Q_PANEL;
constexpr int KV_BYTES = D / 64 * KV_PANEL;
constexpr int STAGE_BYTES = 2 * KV_BYTES;  // K's panels, then V's
constexpr int SACC = BLOCK_K / 2;          // score accumulators a thread
constexpr int OACC = D / 2;                // output accumulators a thread
// 1024 bytes of slack to align Q, then Q, the ring, full[], empty[] and
// Q's barrier.
constexpr size_t SMEM = 1024 + static_cast<size_t>(Q_BYTES) +
                        STAGES * static_cast<size_t>(STAGE_BYTES) +
                        (2 * STAGES + 1) * sizeof(uint64_t);
static_assert(D == 128, "the wgmma body takes D = 128");
static_assert(WG == 1 || WG == 2, "BLOCK_Q 64 or 128");
static_assert(THREADS == 128 * WG, "one warpgroup per 64 query rows");
static_assert(BLOCK_K == 64 || BLOCK_K == 128, "BLOCK_K 64 or 128");

// K and V rows [k0, k0 + BLOCK_K) of kv head kvh into stage `st`.
__device__ __forceinline__ void fill_stage(uint8_t* st, uint64_t* full,
                                           const CUtensorMap* tk,
                                           const CUtensorMap* tv, int k0,
                                           int kvh) {
  mbar_expect_tx(full, STAGE_BYTES);
#pragma unroll
  for (int p = 0; p < D / 64; ++p) {
    tma_load_3d(st + p * KV_PANEL, tk, full, 64 * p, k0, kvh);
    tma_load_3d(st + KV_BYTES + p * KV_PANEL, tv, full, 64 * p, k0, kvh);
  }
}

__global__ void __launch_bounds__(THREADS)
    fa_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    __nv_bfloat16* __restrict__ o, int s, int group,
                    float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = qs + Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int q0 = q_tile() * BLOCK_Q;
  const int bh = blockIdx.y, kvh = bh / group;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4;                 // this thread's warpgroup
  const int g = lane >> 2, t = lane & 3;   // fragment row group, column pair
  const int w0 = warp * 16;                // the warp's first row in the tile
  const float sl2 = scale * LOG2E;
  const int n_kt = k_tiles(q0, s);

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, THREADS / 32);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, Q_BYTES);
#pragma unroll
    for (int p = 0; p < D / 64; ++p)
      tma_load_3d(qs + p * Q_PANEL, &tq, qbar, 64 * p, q0, bh);
    for (int st = 0; st < STAGES && st < n_kt; ++st)
      fill_stage(ring + st * STAGE_BYTES, full + st, &tk, &tv, st * BLOCK_K,
                 kvh);
  }

  // Accumulator layout of m64nNk16: warp w of the warpgroup holds rows
  // 16 (w % 4) + g (+ 8); register 4 c + e holds column 8 c + 2 t + (e % 2),
  // the row + 8 for e >= 2 — chunk c is an m16n8 C fragment.
  float acc[OACC];
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};   // rows g, g + 8
#pragma unroll
  for (int i = 0; i < OACC; ++i) acc[i] = 0.0f;
  const uint8_t* qa = qs + wg * 64 * 128;   // the warpgroup's rows of a panel
  mbar_wait(qbar, 0);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % STAGES, k0 = kt * BLOCK_K;
    const uint32_t phase = (kt / STAGES) & 1;
    uint8_t* ks = ring + st * STAGE_BYTES;
    const uint8_t* vs = ks + KV_BYTES;
    // This warp is done reading the stage: one arrival on its empty
    // barrier; thread 0 then waits for every warp's and refills the stage
    // with tile kt + STAGES.
    auto release = [&]() {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);
      if (tid == 0 && kt + STAGES < n_kt) {
        mbar_wait(empty + st, phase);
        fill_stage(ks, full + st, &tk, &tv, k0 + STAGES * BLOCK_K, kvh);
      }
      __syncwarp();
    };
    mbar_wait(full + st, phase);
    __syncwarp();   // wgmma is .aligned: the whole warp, converged
    if (CAUSAL && k0 > q0 + wg * 64 + 63) {
      release();   // every row of the warpgroup lies above the tile
    } else {
      const bool masked =
          k0 + BLOCK_K > s || (CAUSAL && k0 + BLOCK_K - 1 > q0 + w0);

      // S = Q K^T: 16-deep slices kk of D, panel kk / 4, 32 bytes apart.
      float sc[SACC];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64k16<BLOCK_K, 0>(
            sc,
            wgmma_desc_sw128(qa + kk / 4 * Q_PANEL + 32 * (kk % 4), 16, 1024),
            wgmma_desc_sw128(ks + kk / 4 * KV_PANEL + 32 * (kk % 4), 16,
                             1024),
            kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_operands<SACC>(sc);

      // Online softmax, per row; a row's columns sit in the 4 lanes of a
      // quad. m holds raw scores; each weight is one FFMA into ex2,
      // 2^(s sl2 - m sl2), and a masked key's -1e30 gives exactly 0.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q0 + w0 + g + 8 * h;
        float mx = m[h];
        if (masked) {
#pragma unroll
          for (int c = 0; c < BLOCK_K / 8; ++c)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (!key_ok(k0 + 8 * c + 2 * t + e, row, s))
                sc[4 * c + 2 * h + e] = NEG_INF;
        }
#pragma unroll
        for (int c = 0; c < BLOCK_K / 8; ++c)
          mx = fmaxf(mx, fmaxf(sc[4 * c + 2 * h], sc[4 * c + 2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
        const float ms = mx == NEG_INF ? 0.0f : mx * sl2;
        const float alpha = ex2(fmaf(m[h], sl2, -ms));
        float rs = 0.0f;
#pragma unroll
        for (int c = 0; c < BLOCK_K / 8; ++c)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ex2(fmaf(sc[4 * c + 2 * h + e], sl2, -ms));
            sc[4 * c + 2 * h + e] = p;
            rs += p;
          }
        rs += __shfl_xor_sync(FULL, rs, 1);
        rs += __shfl_xor_sync(FULL, rs, 2);
        l[h] = alpha * l[h] + rs;
        m[h] = mx;
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          acc[4 * c + 2 * h] *= alpha;
          acc[4 * c + 2 * h + 1] *= alpha;
        }
      }

      // O += P V: chunks 2j and 2j + 1 of P, rounded to bf16, are the A
      // fragment of k-step j; V's 16 key rows of step j start 16 j rows
      // into each panel.
      uint32_t pa[BLOCK_K / 16][4];
#pragma unroll
      for (int j = 0; j < BLOCK_K / 16; ++j) {
        pa[j][0] = pack_bf16(sc[8 * j], sc[8 * j + 1]);
        pa[j][1] = pack_bf16(sc[8 * j + 2], sc[8 * j + 3]);
        pa[j][2] = pack_bf16(sc[8 * j + 4], sc[8 * j + 5]);
        pa[j][3] = pack_bf16(sc[8 * j + 6], sc[8 * j + 7]);
      }
      wgmma_fence_operands<OACC>(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BLOCK_K / 16; ++j)
        wgmma_m64n128k16_rs<1>(
            acc, pa[j], wgmma_desc_sw128(vs + 16 * j * 128, KV_PANEL, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_operands<OACC>(acc);
      release();
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + w0 + g + 8 * h;
    if (row >= s) continue;
    const float inv = 1.0f / fmaxf(l[h], 1e-30f);
    __nv_bfloat16* orow =
        o + (static_cast<size_t>(bh) * s + row) * D + 2 * t;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) =
          __floats2bfloat162_rn(acc[4 * c + 2 * h] * inv,
                                acc[4 * c + 2 * h + 1] * inv);
  }
}

int launch_wgmma(const void* q, const void* k, const void* v, void* o, int bh,
                 int bhkv, int s, cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  int err = make_tma_map_bf16_3d(&tq, q, D, s, bh, BLOCK_Q);
  if (err == 0) err = make_tma_map_bf16_3d(&tk, k, D, s, bhkv, BLOCK_K);
  if (err == 0) err = make_tma_map_bf16_3d(&tv, v, D, s, bhkv, BLOCK_K);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      fa_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM));
  if (e != cudaSuccess) {
    cudaGetLastError();   // clear it, so the next launch does not see it
    return static_cast<int>(e);
  }
  const dim3 grid((s + BLOCK_Q - 1) / BLOCK_Q, bh);
  fa_wgmma_kernel<<<grid, THREADS, SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), s, bh / bhkv,
      1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}
#else
// ============================================================= mma body

constexpr int WARPS = THREADS / 32;
constexpr int RW = BLOCK_Q / WARPS;   // query rows per warp
constexpr int MT = RW / 16;           // m16 tiles per warp (bf16 path)

static_assert(THREADS % 32 == 0 && BLOCK_Q % WARPS == 0, "whole warps");
static_assert(RW == 16 || RW == 32, "16 or 32 query rows per warp");
static_assert(BLOCK_K % 32 == 0, "key tiles of whole warps");

constexpr int BF_STRIDE = D + 8;   // bf16 elements per shared-memory row
constexpr int F_STRIDE = D + 1;    // f32 words per shared-memory row
constexpr size_t SMEM_BF16 =
    static_cast<size_t>(BLOCK_Q + 2 * BLOCK_K) * BF_STRIDE * 2;
constexpr size_t SMEM_F32 =
    static_cast<size_t>(BLOCK_Q + 2 * BLOCK_K) * F_STRIDE * 4;

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

#endif  // WGMMA

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; a WGMMA build takes bfloat16 only, on
// 16-byte aligned q, k and v. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a shape this build does not take).
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* o, int bh,
                                      int bhkv, int s, int d, void* stream) {
  if (d != D || bh < 1 || bhkv < 1 || bh % bhkv != 0 || s < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#if WGMMA
  if (dtype == 1) return launch_wgmma(q, k, v, o, bh, bhkv, s, st);
#else
  if (dtype == 0)
    return launch<float>(fa_f32_kernel, SMEM_F32, q, k, v, o, bh, bhkv, s, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(fa_bf16_kernel, SMEM_BF16, q, k, v, o, bh,
                                 bhkv, s, st);
#endif
  return static_cast<int>(cudaErrorInvalidValue);
}
