// flash_attention_bwd — the gradient of flash attention over flattened
// heads (dq, dk, dv from q, k, v and dO, the output's gradient), causal
// (CAUSAL=1) or full (CAUSAL=0), bfloat16 at D = 128, with grouped kv.
// q, dO and dq are (BH, S, D); k, v, dk and dv are (BHkv, S, D); all
// row-major and contiguous. Query head bh reads kv row bh / (BH / BHkv), and
// dk, dv of a kv row sum over its group of query heads. The scale is
// 1/sqrt(D), as the forward's.
//
// Replaces no TPU kernel: the reference has no backward kernel (its training
// differentiates the plain attention, src/repro/kernels/ops.py:attention),
// and the port recomputed the plain version in float32 and took its
// autograd gradient. It was added for training's attention backward, which
// held about half of the device's busy time in a training step.
//
// Bound on the H100: operations. The gradient needs five products of
// 2 * D flop a (query, key) pair (Q.K^T, dO.V^T, P^T.dO, dS^T.Q, dS.K); this
// kernel runs nine (Q.K^T three times, dO.V^T three times), so that no
// block needs another's partial sums and delta comes from f32 products. At
// the training cell's BH 64, S 2048, causal, that is 309 GFLOP against
// ~0.15 GB of compulsory traffic.
//
// Design (FA2's split, on mma.sync m16n8k16: bf16 operands, f32 sums; each
// warp owns 16 rows, a block ROWS = THREADS / 2 rows):
//  * fa_bwd_dq_kernel, one block per (bh, tile of ROWS query rows), tiles
//    launched longest first when causal. It stages its Q and dO rows once.
//    Sweep 1 walks the k and v tiles (BLOCK_K rows) for the online row max
//    and sum of the scores and the row sum of P * dP (dP = dO V^T), and
//    writes lse (log2 domain: max + log2(sum)) and delta = rowsum(P * dP),
//    f32, (BH, S). Sweep 2 walks them again: P = 2^(s * scale * log2e -
//    lse), dP, dS = P * (dP - delta), dQ += dS K, the f32 accumulator of
//    16 x 128 a warp in registers; dq = dQ * scale.
//  * fa_bwd_dkdv_kernel, one block per (bhkv, tile of ROWS key rows), k
//    tile 0 (the most work when causal) first. It stages its K and V rows
//    once and keeps dK and dV (16 x 128 f32 each a warp) in registers while
//    it walks every query head of the group and, when causal, the q tiles
//    (BLOCK_Q rows) at or after its keys, with their lse and delta: P^T =
//    2^(scale log2e K Q^T - lse), dV += P^T dO, dP^T = V dO^T, dS^T =
//    P^T * (dP^T - delta), dK += dS^T Q. The group's sum stays in registers,
//    so the pass writes each dk, dv row once: no atomics, no scratch of
//    partial sums, and the same bits on every run.
//  Both products of a step read A from its rows in shared memory or from
//  the C fragments of the step before (P and dS, rounded to bf16 there), and
//  B row by row (ld32) or through ldmatrix.trans; rows are padded by 8
//  elements, so fragment loads hit 32 banks. Rows past S load as zeros and
//  are masked (weight exactly 0), so every config runs on every S. Every
//  tile crosses registers into shared memory between two __syncthreads: no
//  copy overlaps arithmetic yet.
//
// Tunables (-D): BLOCK_Q (the q tile of the dk/dv pass), BLOCK_K (the k tile
// of the dq pass), THREADS; CAUSAL; HEAD_DIM is the problem's D. The
// launcher asks for the dynamic shared memory above 48 KB with
// cudaFuncSetAttribute and returns its error if the card refuses.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = HEAD_DIM;
constexpr int ROWS = THREADS / 2;   // rows a block owns, 16 a warp
constexpr int STRIDE = D + 8;       // bf16 elements a shared-memory row
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

static_assert(D == 128, "the backward takes head dim 128");
static_assert(THREADS == 64 || THREADS == 128 || THREADS == 256,
              "2, 4 or 8 warps");
static_assert(BLOCK_Q % 16 == 0 && BLOCK_K % 16 == 0, "tiles of 16 rows");

// dq pass: Q and dO rows, the K and V tiles.
constexpr size_t SMEM_DQ =
    static_cast<size_t>(2 * ROWS + 2 * BLOCK_K) * STRIDE * 2;
// dk/dv pass: K and V rows, the Q and dO tiles, lse and delta of the tile.
constexpr size_t SMEM_DKDV =
    static_cast<size_t>(2 * ROWS + 2 * BLOCK_Q) * STRIDE * 2 + BLOCK_Q * 8;

__device__ __forceinline__ bool key_ok(int key, int row, int s) {
#if CAUSAL
  return key < s && key <= row;
#else
  return key < s;
#endif
}

// Two f32 values as one bf16 pair, lo in the low half: where P and dS are
// rounded to bf16 before they enter a product.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [r0, r0 + rows) of a (S, D) matrix into shared memory, 16 bytes a
// thread; rows at or past S are zero.
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int rows, int s) {
  constexpr int VPR = D / 8;   // 16-byte vectors a row
  for (int i = threadIdx.x; i < rows * VPR; i += THREADS) {
    const int r = i / VPR, c = i % VPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < s)
      val = __ldg(reinterpret_cast<const uint4*>(
                      src + static_cast<size_t>(r0 + r) * D) + c);
    *reinterpret_cast<uint4*>(dst + r * STRIDE + c * 8) = val;
  }
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

// The B operand (k = 16 rows, n = 8 columns) of a product whose B is stored
// row by row (k, n): lanes 0-15 address the 16 rows, .trans hands each lane
// the pairs the fragment layout wants.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const __nv_bfloat16* p) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

// c = a . b^T for the warp's 16 rows of a (16 x D) against the N rows of b
// (N x D), both rows in shared memory. C fragment layout: c[nt][e] is row
// g + 8 (e / 2), column 8 nt + 2 t + e % 2.
template <int N>
__device__ __forceinline__ void rows_rows_t(float (&c)[N / 8][4],
                                            const __nv_bfloat16* a,
                                            const __nv_bfloat16* b, int g,
                                            int t) {
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    const __nv_bfloat16* ar = a + g * STRIDE + kk + 2 * t;
    const uint32_t af[4] = {ld32(ar), ld32(ar + 8 * STRIDE), ld32(ar + 8),
                            ld32(ar + 8 * STRIDE + 8)};
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) {
      const __nv_bfloat16* br = b + (nt * 8 + g) * STRIDE + kk + 2 * t;
      mma(c[nt], af, ld32(br), ld32(br + 8));
    }
  }
}

// c (16 x D) += p . b: p the warp's (16 x N) C fragments, rounded to bf16
// (fragments 2j and 2j + 1 are the A fragment of k-step j), b the N rows
// (N x D) in shared memory.
template <int N>
__device__ __forceinline__ void frag_rows(float (&c)[D / 8][4],
                                          const float (&p)[N / 8][4],
                                          const __nv_bfloat16* b, int lane) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j) {
    const uint32_t a[4] = {pack_bf16(p[2 * j][0], p[2 * j][1]),
                           pack_bf16(p[2 * j][2], p[2 * j][3]),
                           pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                           pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      uint32_t b0, b1;
      ldmatrix_x2_trans(b0, b1, b + (j * 16 + (lane & 15)) * STRIDE + dt * 8);
      mma(c[dt], a, b0, b1);
    }
  }
}

// The warp's 16 x D f32 fragments times `scale`, as bf16 rows of `out`
// starting at row r0 (rows at or past S are not written).
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&c)[D / 8][4],
                                           float scale, int r0, int s, int g,
                                           int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row >= s) continue;
    __nv_bfloat16* orow = out + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) =
          __floats2bfloat162_rn(c[dt][2 * h] * scale,
                                c[dt][2 * h + 1] * scale);
  }
}

__global__ void __launch_bounds__(THREADS)
    fa_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     __nv_bfloat16* __restrict__ dq, float* __restrict__ lse,
                     float* __restrict__ delta, int s, int group,
                     float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + ROWS * STRIDE;
  __nv_bfloat16* ks = dos + ROWS * STRIDE;
  __nv_bfloat16* vs = ks + BLOCK_K * STRIDE;

#if CAUSAL
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;   // longest rows first
#else
  const int q0 = blockIdx.x * ROWS;
#endif
  const int bh = blockIdx.y;
  const size_t q_off = static_cast<size_t>(bh) * s * D;
  const size_t kv_off = static_cast<size_t>(bh / group) * s * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = warp * 16;   // the warp's first row in the block
  const float sl2 = scale * LOG2E;

  load_rows(qs, q + q_off, q0, ROWS, s);
  load_rows(dos, dout + q_off, q0, ROWS, s);

  const int n = (s + BLOCK_K - 1) / BLOCK_K;
#if CAUSAL
  const int diag = (q0 + ROWS - 1) / BLOCK_K + 1;
  const int n_kt = diag < n ? diag : n;
#else
  const int n_kt = n;
#endif

  // Sweep 1: the row max m (log2 domain), sum l of 2^(score - m) and
  // sum dl of 2^(score - m) dP, rescaled as m grows. delta = dl / l is
  // rowsum(P * dP), which equals rowsum(dO * o) but is taken from f32 P
  // and dP: the bf16-rounded o would leave an error of 2^-9 |dO| |o| in
  // delta, far above dP - delta where P is one-hot.
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};   // rows g, g + 8
  float dl[2] = {0.0f, 0.0f};
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BLOCK_K;
    __syncthreads();   // the last tile's readers are done
    load_rows(ks, k + kv_off, k0, BLOCK_K, s);
    load_rows(vs, v + kv_off, k0, BLOCK_K, s);
    __syncthreads();
    if (CAUSAL && k0 > q0 + w0 + 15) continue;   // every row lies above
    const bool masked =
        k0 + BLOCK_K > s || (CAUSAL && k0 + BLOCK_K - 1 > q0 + w0);
    float sc[BLOCK_K / 8][4], dp[BLOCK_K / 8][4];
    rows_rows_t<BLOCK_K>(sc, qs + w0 * STRIDE, ks, g, t);
    rows_rows_t<BLOCK_K>(dp, dos + w0 * STRIDE, vs, g, t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + w0 + g + 8 * h;
      float mx = m[h];
#pragma unroll
      for (int nt = 0; nt < BLOCK_K / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = sc[nt][2 * h + e] * sl2;
          if (masked && !key_ok(k0 + nt * 8 + 2 * t + e, row, s))
            x = NEG_INF;
          sc[nt][2 * h + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      float rs = 0.0f, rd = 0.0f;
#pragma unroll
      for (int nt = 0; nt < BLOCK_K / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = sc[nt][2 * h + e];
          const float p = x == NEG_INF ? 0.0f : exp2f(x - mx);
          rs += p;
          rd = fmaf(p, dp[nt][2 * h + e], rd);
        }
      rs += __shfl_xor_sync(FULL, rs, 1);
      rs += __shfl_xor_sync(FULL, rs, 2);
      rd += __shfl_xor_sync(FULL, rd, 1);
      rd += __shfl_xor_sync(FULL, rd, 2);
      const float alpha = exp2f(m[h] - mx);
      l[h] = alpha * l[h] + rs;
      dl[h] = alpha * dl[h] + rd;
      m[h] = mx;
    }
  }
  // Key 0 is every row's, so l >= 1 for every row of the block.
  float lse2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + w0 + g + 8 * h;
    lse2[h] = m[h] + log2f(l[h]);
    dl[h] /= l[h];
    if (t == 0 && row < s) {
      lse[static_cast<size_t>(bh) * s + row] = lse2[h];
      delta[static_cast<size_t>(bh) * s + row] = dl[h];
    }
  }

  // Sweep 2: dQ += (P * (dO V^T - delta)) K.
  float dqa[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[dt][e] = 0.0f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BLOCK_K;
    __syncthreads();
    load_rows(ks, k + kv_off, k0, BLOCK_K, s);
    load_rows(vs, v + kv_off, k0, BLOCK_K, s);
    __syncthreads();
    if (CAUSAL && k0 > q0 + w0 + 15) continue;
    const bool masked =
        k0 + BLOCK_K > s || (CAUSAL && k0 + BLOCK_K - 1 > q0 + w0);
    float sc[BLOCK_K / 8][4], dp[BLOCK_K / 8][4];
    rows_rows_t<BLOCK_K>(sc, qs + w0 * STRIDE, ks, g, t);
    rows_rows_t<BLOCK_K>(dp, dos + w0 * STRIDE, vs, g, t);
#pragma unroll
    for (int nt = 0; nt < BLOCK_K / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int row = q0 + w0 + g + 8 * h;
        const bool ok =
            !masked || key_ok(k0 + nt * 8 + 2 * t + e % 2, row, s);
        const float p = ok ? exp2f(fmaf(sc[nt][e], sl2, -lse2[h])) : 0.0f;
        sc[nt][e] = p * (dp[nt][e] - dl[h]);
      }
    frag_rows<BLOCK_K>(dqa, sc, ks, lane);
  }
  store_rows(dq + q_off, dqa, scale, q0 + w0, s, g, t);
}

__global__ void __launch_bounds__(THREADS)
    fa_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, int s, int group,
                       float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + ROWS * STRIDE;
  __nv_bfloat16* qs = vs + ROWS * STRIDE;
  __nv_bfloat16* dos = qs + BLOCK_Q * STRIDE;
  float* lse_s = reinterpret_cast<float*>(dos + BLOCK_Q * STRIDE);
  float* delta_s = lse_s + BLOCK_Q;

  const int k0 = blockIdx.x * ROWS;   // causal: tile 0, the most work, first
  const int kvh = blockIdx.y;
  const size_t kv_off = static_cast<size_t>(kvh) * s * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = warp * 16;
  const int kw = k0 + w0;     // the warp's first key
  const float sl2 = scale * LOG2E;

  load_rows(ks, k + kv_off, k0, ROWS, s);
  load_rows(vs, v + kv_off, k0, ROWS, s);

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dka[dt][e] = 0.0f;
      dva[dt][e] = 0.0f;
    }

  const int nq = (s + BLOCK_Q - 1) / BLOCK_Q;
  // the first q tile with a row at or after the block's keys
  const int qt0 = CAUSAL ? k0 / BLOCK_Q : 0;
  for (int hh = 0; hh < group; ++hh) {
    const int bh = kvh * group + hh;
    const size_t q_off = static_cast<size_t>(bh) * s * D;
    for (int qt = qt0; qt < nq; ++qt) {
      const int q0 = qt * BLOCK_Q;
      __syncthreads();   // the last tile's readers are done
      load_rows(qs, q + q_off, q0, BLOCK_Q, s);
      load_rows(dos, dout + q_off, q0, BLOCK_Q, s);
      for (int i = threadIdx.x; i < BLOCK_Q; i += THREADS) {
        const bool in = q0 + i < s;
        const size_t at = static_cast<size_t>(bh) * s + q0 + i;
        lse_s[i] = in ? lse[at] : 0.0f;
        delta_s[i] = in ? delta[at] : 0.0f;
      }
      __syncthreads();
      if (CAUSAL && q0 + BLOCK_Q - 1 < kw) continue;   // above the keys
      const bool masked =
          q0 + BLOCK_Q > s || (CAUSAL && q0 < kw + 15);

      // P^T: row g + 8 (e / 2) is key kw + g + 8 (e / 2), column
      // 8 nt + 2 t + e % 2 is query q0 + that column.
      float pt[BLOCK_Q / 8][4];
      rows_rows_t<BLOCK_Q>(pt, ks + w0 * STRIDE, qs, g, t);
#pragma unroll
      for (int nt = 0; nt < BLOCK_Q / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + 2 * t + e % 2;
          const int key = kw + g + 8 * (e / 2);
          const bool ok =
              !masked || (q0 + col < s && (!CAUSAL || key <= q0 + col));
          pt[nt][e] =
              ok ? exp2f(fmaf(pt[nt][e], sl2, -lse_s[col])) : 0.0f;
        }
      frag_rows<BLOCK_Q>(dva, pt, dos, lane);          // dV += P^T dO

      float dpt[BLOCK_Q / 8][4];
      rows_rows_t<BLOCK_Q>(dpt, vs + w0 * STRIDE, dos, g, t);  // V dO^T
#pragma unroll
      for (int nt = 0; nt < BLOCK_Q / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pt[nt][e] *= dpt[nt][e] - delta_s[nt * 8 + 2 * t + e % 2];
      frag_rows<BLOCK_Q>(dka, pt, qs, lane);           // dK += dS^T Q
    }
  }
  store_rows(dk + kv_off, dka, scale, kw, s, g, t);
  store_rows(dv + kv_off, dva, 1.0f, kw, s, g, t);
}

// Ask for `bytes` of dynamic shared memory for `kern`; the card's refusal,
// cleared so the next launch does not see it, or cudaSuccess.
template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

}  // namespace

// dtype: 1 = bfloat16 (the only one this kernel takes). lse and delta are
// (BH, S) float32 scratch the wrapper allocates. Enqueues both passes on
// `stream`; returns the first cudaError_t of a launch
// (cudaErrorInvalidValue for a shape or dtype this build does not take).
extern "C" int flash_attention_bwd_launch(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    void* dq, void* dk, void* dv, void* lse, void* delta, int bh, int bhkv,
    int s, int d, void* stream) {
  if (dtype != 1 || d != D || bh < 1 || bhkv < 1 || bh % bhkv != 0 || s < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = allow_smem(fa_bwd_dq_kernel, SMEM_DQ);
  if (err == cudaSuccess) err = allow_smem(fa_bwd_dkdv_kernel, SMEM_DKDV);
  if (err != cudaSuccess) return static_cast<int>(err);
  using bf = __nv_bfloat16;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const int tiles = (s + ROWS - 1) / ROWS;
  fa_bwd_dq_kernel<<<dim3(tiles, bh), THREADS, SMEM_DQ, st>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout),
      static_cast<bf*>(dq),
      static_cast<float*>(lse), static_cast<float*>(delta), s, bh / bhkv,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fa_bwd_dkdv_kernel<<<dim3(tiles, bhkv), THREADS, SMEM_DKDV, st>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout),
      static_cast<bf*>(dk), static_cast<bf*>(dv),
      static_cast<const float*>(lse), static_cast<const float*>(delta), s,
      bh / bhkv, scale);
  return static_cast<int>(cudaGetLastError());
}
