// Cache attention: out[b, q, c] = sum_n w_b[q, n] * V[n, c],
// w_b = bf16(exp(-beta_b * (1 - F[q] . C[n]))), affinity accumulated in f32.
// V is a value matrix (K1) or one_hot(labels), never built (K2, K3).
//
// Replaces the TPU kernels of summer_clip_tpu/ops/cache_kernels.py:
//   K1 cache_attention     -> cache_dense   (bf16 or int8 value matrix)
//   K2 labels_dense_pallas -> labels_dense  (any row order)
//   K3 onehot_pallas       -> onehot_grouped (class-grouped rows)
// and of tools/sweep_onehot_variants.py:
//   K13 onehot_variant     -> onehot_grouped<expand mode> (K3's sum with the
//                             class partials of each block_n-row cache block
//                             formed apart, then added as the mode says)
//
// What bounds them on Hopper. The TPU keeps a (block_b, block_q, C_p) f32
// output block resident in VMEM (up to 4 MB); a Hopper block has 227 KB of
// shared memory, so the classes are tiled too and every output element is
// owned by exactly one block: no reduction crosses blocks, no atomics, and the
// result is the same on every run (Tip's grid search takes a first-max argmax).
// Features are bf16; the affinity tile is computed the same way in both
// kernels (one warp per 16 x 16 tile, K steps in order), so K2 and K3 add the
// same bf16-rounded terms and differ only in f32 summation order.
//   - K2 multiplies w by one-hot tiles rebuilt per 16 rows x 16 classes in
//     shared memory (the dense w @ V of the TPU kernel). A tile whose 16 rows
//     hold none of its 16 classes adds exact zeros and is skipped.
//   - K3 walks, per block of 16 classes, only the cache rows of those classes
//     (a host-side stable sort of the labels, with per-class offsets) and sums
//     the weights of each class in f32 registers. The per-class partial sums
//     are never rounded to bf16 (the TPU lost 0.24 abs that way).
//   - K13 is the same walk. The TPU kernel forms, per block of block_n cache
//     rows, each class's partial sum (w @ local) and scatters it to the output
//     columns with a second product (small @ expand) whose precision is the
//     sweep's parameter. Here a class's rows come in row order (the sort is
//     stable), so a thread keeps one running partial per (class, beta), and
//     when a row of the next cache block arrives it adds the finished partial
//     to the accumulator as the mode says: "highest" as it is, "split3" as
//     (hi + mid) + lo of its three bf16 parts (exact, so equal to "highest"
//     bit for bit), "default" rounded to bf16 first (the one-pass product).
//     The partial registers double K3's accumulators (16 betas x 4 classes
//     each), which the 256-thread block still holds. No expand matrix is
//     built: each class owns its output column.
//   - K1: a block owns 16 queries x 256 classes x the 8 betas of a launch:
//     the 8 weight tiles of one affinity tile are stacked into a 128-row
//     operand, so one affinity tile serves all betas of the chunk, and the f32
//     accumulators (128 x 256) fill the registers of two warpgroups. Each
//     class slice recomputes the affinity (sharing it would need the (Nt, Nc)
//     affinity in device memory, which the TPU kernel never writes either).
//     wgmma on TMA-staged operands, weights written from registers as the A
//     operand, V read MN-major: see the section below.
// No running maximum: the exponent is <= 0 for normalised rows, and like the
// TPU kernels none of these assumes it (an unnormalised row may overflow to inf
// here exactly as it does there).
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "hopper_common.cuh"   // mbarriers, TMA, wgmma (K1)

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBc;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBr;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ float cache_weight(float beta, float aff) {
  return __bfloat162float(__float2bfloat16(expf(-beta * (1.0f - aff))));
}

// aff tile (16 queries x 16 cache rows): q rows in shared memory (row-major,
// ldq), cache rows row-major with leading dimension ldc, K steps in order.
__device__ __forceinline__ void affinity_tile(FragC& s, const bf16* q, int ldq,
                                              const bf16* c, int ldc, int D) {
  wmma::fill_fragment(s, 0.f);
  for (int kk = 0; kk < D; kk += 16) {
    FragA a;
    FragBc b;
    wmma::load_matrix_sync(a, q + kk, ldq);
    wmma::load_matrix_sync(b, c + kk, ldc);
    wmma::mma_sync(s, a, b, s);
  }
}

// ---------------------------------------------------------------------------
// K2: block = (16-query tile, one beta, 1024-class slice). Cache rows in
// tiles of 128 (one 16-row affinity tile per warp); each warp owns up to 8
// class tiles of the slice and accumulates w @ one_hot in WMMA fragments.
// ---------------------------------------------------------------------------
constexpr int kK2Rows = 16 * kWarps;   // cache rows per step
constexpr int kK2Classes = 1024;       // classes per block (8 tiles per warp)

__global__ void __launch_bounds__(kThreads)
labels_dense_kernel(const bf16* __restrict__ f, const bf16* __restrict__ cf,
                    const int* __restrict__ labels, const float* __restrict__ betas,
                    float* __restrict__ out, int Nt, int Ncp, int D, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * 16, bi = blockIdx.y, c_base = blockIdx.z * kK2Classes;
  const float beta = betas[bi];
  const int ldq = D + kPad, ldw = kK2Rows + kPad;
  bf16* q_s = reinterpret_cast<bf16*>(smem);               // 16 x ldq
  bf16* w_s = q_s + 16 * ldq;                              // 16 x ldw
  float* aff_s = reinterpret_cast<float*>(w_s + 16 * ldw); // 16 x kK2Rows
  float* scratch = aff_s + 16 * kK2Rows;                   // 256 floats per warp
  float* my = scratch + warp * 256;
  bf16* oh = reinterpret_cast<bf16*>(my);                  // 16 x 16 one-hot tile

  for (int idx = tid; idx < 16 * D; idx += kThreads)
    q_s[(idx / D) * ldq + idx % D] = f[(size_t)(q0 + idx / D) * D + idx % D];

  int nct = (C - c_base + 15) / 16;
  if (nct > kK2Classes / 16) nct = kK2Classes / 16;
  FragC acc[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) wmma::fill_fragment(acc[t], 0.f);

  for (int n0 = 0; n0 < Ncp; n0 += kK2Rows) {
    __syncthreads();
    {
      FragC s;
      affinity_tile(s, q_s, ldq, cf + (size_t)(n0 + warp * 16) * D, D, D);
      wmma::store_matrix_sync(aff_s + warp * 16, s, kK2Rows, wmma::mem_row_major);
    }
    __syncthreads();
    for (int idx = tid; idx < 16 * kK2Rows; idx += kThreads)
      w_s[(idx / kK2Rows) * ldw + idx % kK2Rows] =
          __float2bfloat16(cache_weight(beta, aff_s[idx]));
    __syncthreads();
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int ct = warp + kWarps * t;
      if (ct >= nct) break;
      const int cls0 = c_base + ct * 16;
      for (int ks = 0; ks < kK2Rows / 16; ++ks) {
        const int lab = lane < 16 ? labels[n0 + ks * 16 + lane] - cls0 : -1;
        const bool hit = lab >= 0 && lab < 16;
        if (!__any_sync(0xffffffffu, hit)) continue;  // all-zero tile adds nothing
#pragma unroll
        for (int e = 0; e < 8; ++e) oh[lane * 8 + e] = __float2bfloat16(0.f);
        __syncwarp();
        if (hit) oh[lane * 16 + lab] = __float2bfloat16(1.f);
        __syncwarp();
        FragA a;
        FragBr b;
        wmma::load_matrix_sync(a, w_s + ks * 16, ldw);
        wmma::load_matrix_sync(b, oh, 16);
        wmma::mma_sync(acc[t], a, b, acc[t]);
        __syncwarp();
      }
    }
  }
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int ct = warp + kWarps * t;
    if (ct >= nct) break;
    wmma::store_matrix_sync(my, acc[t], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int q = q0 + e / 16, c = c_base + ct * 16 + e % 16;
      if (q < Nt && c < C) out[((size_t)bi * Nt + q) * C + c] = my[e];
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// K3 (kExpand == kRowSum): block = (64-query tile, 16-class group), all betas
// (<= 16) of the call. Rows of the group are rows_sorted[offs[c0] .. offs[c0 +
// 16]), gathered 32 at a time. Thread t owns queries t % 64 and classes
// 4 * (t / 64) .. + 3.
// K13 (kExpand == kHighest, kSplit3, kDefault): the same blocks; the weights
// of a class are summed per block_n-row cache block into a partial, and each
// finished partial reaches the accumulator through expand_partial.
// ---------------------------------------------------------------------------
constexpr int kK3Q = 64, kK3Rows = 32, kK3Classes = 16, kMaxBeta = 16;
constexpr int kRowSum = -1, kHighest = 0, kSplit3 = 1, kDefault = 2;

// what the class-sum scatter (small @ expand) adds for one partial
template <int kExpand>
__device__ __forceinline__ float expand_partial(float p) {
  if constexpr (kExpand == kSplit3) {
    const bf16 hi = __float2bfloat16(p);
    const float r1 = p - __bfloat162float(hi);
    const bf16 mid = __float2bfloat16(r1);
    const bf16 lo = __float2bfloat16(r1 - __bfloat162float(mid));
    return __fadd_rn(__fadd_rn(__bfloat162float(hi), __bfloat162float(mid)),
                     __bfloat162float(lo));
  }
  if constexpr (kExpand == kDefault) return __bfloat162float(__float2bfloat16(p));
  return p;
}

// add class k's finished partials (one per beta) to its accumulators and start anew
template <int kExpand>
__device__ __forceinline__ void flush_partials(float (&acc)[kMaxBeta][4],
                                               float (&part)[kMaxBeta][4], int k, int nb) {
#pragma unroll
  for (int b = 0; b < kMaxBeta; ++b) {
    if (b < nb) acc[b][k] += expand_partial<kExpand>(part[b][k]);
    part[b][k] = 0.f;
  }
}

// kCastW (K13's cast_w) rounds w to bf16 before the class sum. The TPU's
// default-precision product takes w as a bf16 operand anyway (the tool's
// "the MXU truncates for free"), so every arm here sums the same bf16 weights
// as K3 does, and the two values of kCastW give the same bits.
template <int kExpand, bool kCastW>
__global__ void __launch_bounds__(kThreads)
onehot_grouped_kernel(const bf16* __restrict__ f, const bf16* __restrict__ cf,
                      const int* __restrict__ rows_sorted, const int* __restrict__ offs,
                      const float* __restrict__ betas, float* __restrict__ out,
                      int nb, int Nt, int D, int C, int block_n) {
  constexpr bool kPartials = kExpand != kRowSum;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int q0 = blockIdx.x * kK3Q, c0 = blockIdx.y * kK3Classes;
  const int c_end = min(c0 + kK3Classes, C);
  const int ld = D + kPad, lda = kK3Q + 4;
  bf16* q_s = reinterpret_cast<bf16*>(smem);                  // kK3Q x ld
  bf16* c_s = q_s + kK3Q * ld;                                // kK3Rows x ld
  float* aff_s = reinterpret_cast<float*>(c_s + kK3Rows * ld);  // kK3Rows x lda (row r, query q)
  __shared__ int offs_s[kK3Classes + 1];
  __shared__ float beta_s[kMaxBeta];
  __shared__ int blk_s[kK3Rows];                              // cache block of each gathered row

  for (int idx = tid; idx < kK3Q * D; idx += kThreads)
    q_s[(idx / D) * ld + idx % D] = f[(size_t)(q0 + idx / D) * D + idx % D];
  if (tid <= kK3Classes) offs_s[tid] = offs[min(c0 + tid, C)];
  if (tid < kMaxBeta) beta_s[tid] = tid < nb ? betas[tid] : 0.f;

  const int q = tid % kK3Q, cl0 = (tid / kK3Q) * 4;
  float acc[kMaxBeta][4];
  float part[kMaxBeta][4];   // K13: the running partial of each (beta, class)
  int cur[4];                // K13: the cache block those partials belong to
#pragma unroll
  for (int b = 0; b < kMaxBeta; ++b)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[b][k] = part[b][k] = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) cur[k] = -1;
  __syncthreads();

  const int seg0 = offs_s[0], seg1 = offs_s[c_end - c0];
  for (int r0 = seg0; r0 < seg1; r0 += kK3Rows) {
    const int nrows = min(kK3Rows, seg1 - r0);
    __syncthreads();
    for (int idx = tid; idx < kK3Rows * D; idx += kThreads) {
      const int i = idx / D, j = idx % D;
      c_s[i * ld + j] = i < nrows ? cf[(size_t)rows_sorted[r0 + i] * D + j]
                                  : __float2bfloat16(0.f);
    }
    if constexpr (kPartials) {
      if (tid < kK3Rows) blk_s[tid] = tid < nrows ? rows_sorted[r0 + tid] / block_n : -1;
    }
    __syncthreads();
    {
      const int qt = warp / 2, rt = warp % 2;
      FragC s;
      affinity_tile(s, q_s + qt * 16 * ld, ld, c_s + rt * 16 * ld, ld, D);
      wmma::store_matrix_sync(aff_s + rt * 16 * lda + qt * 16, s, lda, wmma::mem_col_major);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int cl = cl0 + k;
      if (c0 + cl >= c_end) break;
      const int lo = max(offs_s[cl], r0) - r0, hi = min(offs_s[cl + 1], r0 + nrows) - r0;
      for (int r = lo; r < hi; ++r) {
        const float a = aff_s[r * lda + q];
        if constexpr (kPartials) {
          if (blk_s[r] != cur[k]) {   // the class's rows of the next cache block begin
            flush_partials<kExpand>(acc, part, k, nb);
            cur[k] = blk_s[r];
          }
#pragma unroll
          for (int b = 0; b < kMaxBeta; ++b)
            if (b < nb) part[b][k] += cache_weight(beta_s[b], a);
        } else {
#pragma unroll
          for (int b = 0; b < kMaxBeta; ++b)
            if (b < nb) acc[b][k] += cache_weight(beta_s[b], a);
        }
      }
    }
  }
  if constexpr (kPartials) {
#pragma unroll
    for (int k = 0; k < 4; ++k) flush_partials<kExpand>(acc, part, k, nb);
  }
  // stage each beta's (64 x 16) tile so rows are written contiguously
  __syncthreads();
  float* stage = aff_s;  // kK3Q x (kK3Classes + 1)
#pragma unroll
  for (int b = 0; b < kMaxBeta; ++b) {
    if (b >= nb) break;
#pragma unroll
    for (int k = 0; k < 4; ++k) stage[q * (kK3Classes + 1) + cl0 + k] = acc[b][k];
    __syncthreads();
    for (int e = tid; e < kK3Q * kK3Classes; e += kThreads) {
      const int qq = q0 + e / kK3Classes, c = c0 + e % kK3Classes;
      if (qq < Nt && c < c_end)
        out[((size_t)b * Nt + qq) * C + c] = stage[(e / kK3Classes) * (kK3Classes + 1) + e % kK3Classes];
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K1 on Hopper: block = (16-query tile, 256-class slice), the <= 8 betas of
// the launch stacked into 128 rows of w (beta b, query q at row 16 b + q).
// The affinity recompute factor D x (queries a block) / (accumulators a
// block) is 768 x 16 / (128 x 256) = 0.375 (32 x 128 would give 0.75): each
// class slice recomputes the affinity and its exponentials, so the wide slice
// halves both. What bounds it on the H100: the bytes each block streams from
// L2, Nc (2 D + 2 x 256) (59 GB a call at Nt = 8192, Nc = 16384, D = 768,
// C = 1000), which the SMs take in at about 4 TB/s together (17 ms at that
// shape with every product and exponential taken out; PERF.md). Queries x
// classes a block is what divides those bytes, and the f32 accumulators
// (8 betas x 16 x 256) already fill two warpgroups' registers. Multicasting
// the cache to clusters of 2 and 4 blocks (one L2 read for several SMs) was
// slower on the same card in the same run (PERF.md), so each block loads its
// own.
// Threads: two warpgroups and no producer warp (a block of more than 256
// threads caps a thread at 168 registers, and w V's accumulators alone take
// 128). A buffer refills itself: the last warp of the block to release it
// arms its barrier and issues its next load by TMA.
// Cache rows go in k-blocks of 64; warpgroup x takes the affinity of k-blocks
// 2 p + x, and both take every k-block's w V:
//   1. affinity, transposed: S^T (64 cache rows x 16 queries) = C Q^T by
//      wgmma.m64n16k16 over D, 16-deep steps in order, with the cache rows
//      (the ring's 64 x 64 boxes) and the queries (resident boxes) as K-major
//      operands as TMA wrote them. On the H100 this gives K2's WMMA affinity
//      bit for bit (affinity_probe below; chip_smoke.py checks it), so K1, K2,
//      K3 and K13 add the same bf16 weights;
//   2. weights: the warpgroup pairs its accumulators along the cache rows with
//      one shuffle, turns them into the 8 betas' bf16 weights (cache_weight)
//      and writes them straight from registers into its w buffer, the
//      swizzled K-major A operand (no f32 round trip through shared memory);
//      int8 values are converted to bf16 in shared memory here;
//   3. w V: warpgroup x owns the m64 tile of rows 64 x .. (betas 4 x ..
//      4 x + 3): four 64-class value boxes of wgmma.m64n64k16 for each
//      k-block, V read MN-major as TMA wrote it. The products are left
//      running while the warpgroup computes its next affinity, and warpgroup
//      0 takes the odd k-block of a pair one affinity later, so the two run
//      half a pair apart and one's exponentials overlap the other's loads.
// ---------------------------------------------------------------------------
namespace k1 {
constexpr int kQ = 16, kC = 256, kB = 8, kN = 64;     // queries, classes, betas, cache rows a step
constexpr int kCtaThreads = 256;                       // two warpgroups
constexpr int kBox = 8192;                             // 64 rows x 128 bytes
constexpr int kQBox = kQ * 128;                        // 16 query rows x 64 columns
constexpr int kVBoxes = kC / 64;                       // bf16 value boxes of a k-block
constexpr int kMaxFStages = 12;
constexpr int kVSlots = 2;                             // value tiles in flight (a pair)
constexpr int kWBytes = kB * kQ * kN * 2;              // one w buffer: 2 m64 tiles x 64 deep
constexpr int kSmemLimit = 232448;
constexpr int kBarriers = kMaxFStages + kVSlots + 4 + 1;   // + w_full, w_empty, q_full

// shared memory of everything but the feature ring; the ring takes what is left
__host__ __device__ constexpr int fixed_bytes(int nd, bool i8) {
  return 1024 + nd * kQBox                               // Q boxes
         + kVSlots * kVBoxes * kBox / (i8 ? 2 : 1)       // value tiles (int8: 64 x 256 bytes)
         + (i8 ? 2 * kVBoxes * kBox : 0)                 // int8: a bf16 conversion a warpgroup
         + 2 * kWBytes + 8 * kBarriers;
}
}  // namespace k1

template <bool kInt8>
__global__ void __launch_bounds__(k1::kCtaThreads, 1)
cache_dense_kernel(const __grid_constant__ CUtensorMap fmap,
                   const __grid_constant__ CUtensorMap cmap,
                   const __grid_constant__ CUtensorMap vmap, const float* __restrict__ betas,
                   float* __restrict__ out, int nb, int Nt, int Ncp, int Dp, int C, int fstages) {
  using namespace k1;
  constexpr int kVBytes = kVBoxes * kBox / (kInt8 ? 2 : 1);   // one value tile
  constexpr int kVReaders = kInt8 ? 4 : 8;               // warps of a block that read a value tile
  extern __shared__ unsigned char smem_raw[];
  __shared__ float beta[kB];
  __shared__ uint32_t f_released[kMaxFStages], v_released[kVSlots];   // readers done with a load
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const int nd = (Dp + 63) / 64;                         // 64-column boxes of a feature row
  const uint32_t q_s = base;
  const uint32_t v_s = base + ((nd * kQBox + 1023) & ~1023);   // kVSlots value tiles
  const uint32_t cv_s = v_s + kVSlots * kVBytes;         // int8: warpgroup x converts into cv x
  const uint32_t w_s = cv_s + (kInt8 ? 2 * kVBoxes * kBox : 0);   // warpgroup x writes w buffer x
  const uint32_t f_s = w_s + 2 * kWBytes;                // the feature ring
  const uint32_t f_full = f_s + fstages * kBox;
  const uint32_t v_full = f_full + 8 * kMaxFStages;
  const uint32_t w_full = v_full + 8 * kVSlots, w_empty = w_full + 16, q_full = w_empty + 16;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kQ, c0 = blockIdx.y * kC;
  const int nkb = Ncp / kN, nslices = nkb * nd;          // nkb even (the wrapper pads)

  // The ring's slices take turns between the warpgroups: slice `fit` is
  // columns 64 d .. of k-block 2 p + x, fit = 2 nd p + 2 d + x. With an even
  // number of stages a stage always serves the same warpgroup, which takes its
  // slices in order, so no wait ever runs two loads ahead of its barrier (a
  // parity wait cannot tell those apart).
  auto load_slice = [&](int fit) {
    const int st = fit % fstages, r = fit % (2 * nd);
    mbar_expect(f_full + 8 * st, kBox);
    tma_2d(f_s + st * kBox, &cmap, f_full + 8 * st, 64 * (r >> 1),
           (2 * (fit / (2 * nd)) + (r & 1)) * kN);
  };
  auto load_values = [&](int i) {
    const int vs = i % kVSlots;
    const uint32_t dst = v_s + vs * kVBytes, bar = v_full + 8 * vs;
    mbar_expect(bar, kVBytes);
    if (kInt8) {
      tma_2d(dst, &vmap, bar, c0, i * kN);               // 64 rows x 256 int8 columns
    } else {
#pragma unroll
      for (int vb = 0; vb < kVBoxes; ++vb)
        tma_2d(dst + vb * kBox, &vmap, bar, c0 + 64 * vb, i * kN);
    }
  };

  if (tid < kB) beta[tid] = betas[tid < nb ? tid : nb - 1];
  if (tid == 0) {
    for (int s = 0; s < fstages; ++s) {
      mbar_init(f_full + 8 * s, 1);
      f_released[s] = 0;
    }
    for (int s = 0; s < kVSlots; ++s) {
      mbar_init(v_full + 8 * s, 1);
      v_released[s] = 0;
    }
    for (int x = 0; x < 2; ++x) {
      mbar_init(w_full + 8 * x, 128);                    // every thread of the writing warpgroup
      mbar_init(w_empty + 8 * x, 8);                     // both warpgroups' products done
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect(q_full, nd * kQBox);
    for (int d = 0; d < nd; ++d) tma_2d(q_s + d * kQBox, &fmap, q_full, 64 * d, q0);
    for (int fit = 0; fit < min(fstages, nslices); ++fit) load_slice(fit);
    for (int i = 0; i < min(kVSlots, nkb); ++i) load_values(i);
  }
  __syncthreads();

  // a warp is done with a buffer: the last of its readers issues its next load
  auto release_slice = [&](int fit) {
    __syncwarp();
    if (lane == 0 && atomicAdd(&f_released[fit % fstages], 1u) % 4 == 3 &&
        fit + fstages < nslices)
      load_slice(fit + fstages);
  };
  auto release_values = [&](int i) {
    __syncwarp();
    if (lane == 0 && atomicAdd(&v_released[i % kVSlots], 1u) % kVReaders == kVReaders - 1 &&
        i + kVSlots < nkb)
      load_values(i + kVSlots);
  };
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  const int x = warp >> 2, wp = warp & 3, g = lane >> 2, t = lane & 3, wt = tid & 127;
  float acc[kVBoxes][32];                        // this warpgroup's m64 tile x 256 classes
#pragma unroll
  for (int vb = 0; vb < kVBoxes; ++vb)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[vb][e] = 0.f;
  const uint32_t wbuf = w_s + x * kWBytes;
  // w V of k-block k (w(k) written by warpgroup k % 2), left running
  auto issue_wv = [&](int k) {
    const int b = k & 1;
    mbar_wait_bounded(w_full + 8 * b, (k >> 1) & 1);
    if (!kInt8) mbar_wait_bounded(v_full + 8 * (k % kVSlots), (k / kVSlots) & 1);
    const uint32_t wk = w_s + b * kWBytes + x * kBox;    // this warpgroup's m64 tile
    const uint32_t vk = kInt8 ? cv_s + b * kVBoxes * kBox : v_s + (k % kVSlots) * kVBytes;
    wgmma_fence();
#pragma unroll
    for (int vb = 0; vb < kVBoxes; ++vb)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_ss_t<1>(acc[vb], sw128_desc(wk + 32 * kk),
                                sw128_desc(vk + vb * kBox + 2048 * kk), 1);
    wgmma_commit();
  };
  // the products of k-block k are done in this warpgroup
  auto done_wv = [&](int k) {
    release(w_empty + 8 * (k & 1));
    if (!kInt8) release_values(k);
  };
  mbar_wait_bounded(q_full, 0);
  // Warpgroup 0 takes k-block 2 p - 1's w V after its own affinity of pair p:
  // the warpgroups then run half a pair apart, and one's exponentials overlap
  // the other's affinity (each still adds the k-blocks in order).
  for (int p = 0; p < nkb / 2; ++p) {
    const int own = 2 * p + x;
    // 1. S^T of k-block `own`: cache rows 16 wp + g (+ 8) x queries 8 j + 2 t (+ 1)
    float sacc[8];   // the first step overwrites it (no register write while products run)
    for (int d = 0; d < nd; ++d) {
      const int fit = 2 * nd * p + 2 * d + x, st = fit % fstages;
      mbar_wait_bounded(f_full + 8 * st, (fit / fstages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)   // past D the boxes hold TMA's zeros: exact, as K2's steps
        wgmma_m64n16k16_ss<0>(sacc, sw128_desc(f_s + st * kBox + 32 * kk),
                              sw128_desc(q_s + d * kQBox + 32 * kk), (d | kk) != 0);
      wgmma_commit();
      wgmma_wait_n<1>();   // the previous slice's products are done: release it
      if (d > 0) release_slice(fit - 2);
      if (d == 0 && p > 0) {   // the products issued in the previous pair are done
        if (x == 0) {
          if (p > 1) done_wv(2 * p - 3);
          done_wv(2 * p - 2);
        } else {
          done_wv(2 * p - 2);
          done_wv(2 * p - 1);
        }
      }
    }
    wgmma_wait_n<0>();
    keep_n(sacc);
#pragma unroll
    for (int vb = 0; vb < kVBoxes; ++vb) keep_n(acc[vb]);
    release_slice(2 * nd * p + 2 * (nd - 1) + x);
    // 2. the weights of k-block `own` into w buffer x (both warpgroups are
    // done with its previous contents); int8 values converted into cv x
    if (p > 0) mbar_wait_bounded(w_empty + 8 * x, (p - 1) & 1);
    if (kInt8) {   // row wt / 2, columns 128 (wt % 2) ..
      const int vs = own % kVSlots;
      mbar_wait_bounded(v_full + 8 * vs, (own / kVSlots) & 1);
      const int r = wt >> 1, col = 128 * (wt & 1);
      const unsigned char* src = gbase + (v_s + vs * kVBytes - base) + r * kC + col;
      unsigned char* dst = gbase + (cv_s + x * kVBoxes * kBox - base) + (col >> 6) * kBox;
#pragma unroll
      for (int h = 0; h < 8; ++h) {
        const uint4 rv = *reinterpret_cast<const uint4*>(src + 16 * h);
        const int8_t* e = reinterpret_cast<const int8_t*>(&rv);
        uint4 lo, hi;
        bf16* l8 = reinterpret_cast<bf16*>(&lo);
        bf16* h8 = reinterpret_cast<bf16*>(&hi);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          l8[u] = __float2bfloat16((float)e[u]);
          h8[u] = __float2bfloat16((float)e[8 + u]);
        }
        const int cc = 16 * h;                           // column in the thread's two boxes
        unsigned char* box = dst + (cc >> 6) * kBox;
        *reinterpret_cast<uint4*>(box + sw128_offset(r, cc & 63)) = lo;
        *reinterpret_cast<uint4*>(box + sw128_offset(r, (cc & 63) + 8)) = hi;
      }
      release_values(own);
    }
    // pair along the cache rows: lanes 4 apart hold rows n and n + 1 of the
    // same two queries; the even one keeps query q, the odd one q + 1
    const bool odd = g & 1;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float a0 = sacc[4 * j + 2 * hr], a1 = sacc[4 * j + 2 * hr + 1];
        const float got = __shfl_xor_sync(0xffffffffu, odd ? a0 : a1, 4);
        const float lo = odd ? got : a0, hi = odd ? a1 : got;   // cache rows n, n + 1
        const int q = 8 * j + 2 * t + (odd ? 1 : 0), n = 16 * wp + 8 * hr + (g & ~1);
#pragma unroll
        for (int b = 0; b < kB; ++b) {
          const int row = kQ * b + q;                          // m64 tile row / 64
          *reinterpret_cast<uint32_t*>(gbase + (wbuf - base) + (row >> 6) * kBox +
                                       sw128_offset(row & 63, n)) =
              pack2(cache_weight(beta[b], lo), cache_weight(beta[b], hi));
        }
      }
    fence_proxy_async();   // w (and the converted values) are wgmma operands
    mbar_arrive(w_full + 8 * x);
    // 3. w V, k-blocks in order: warpgroup 0 takes 2 p - 1 and 2 p, warpgroup 1 2 p and 2 p + 1
    if (x == 0) {
      if (p > 0) issue_wv(2 * p - 1);
      issue_wv(2 * p);
    } else {
      issue_wv(2 * p);
      issue_wv(2 * p + 1);
    }
  }
  if (x == 0) {   // the last k-block, once warpgroup 1 may write its weights
    wgmma_wait_n<0>();
#pragma unroll
    for (int vb = 0; vb < kVBoxes; ++vb) keep_n(acc[vb]);
    if (nkb >= 4) done_wv(nkb - 3);
    done_wv(nkb - 2);
    issue_wv(nkb - 1);
  }
  wgmma_wait_n<0>();
#pragma unroll
  for (int vb = 0; vb < kVBoxes; ++vb) keep_n(acc[vb]);
  // out[b, q, c]: warpgroup x's tile holds rows 64 x + 16 wp + g (+ 8)
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = 64 * x + 16 * wp + g + 8 * hr;
    const int b = row / kQ, q = q0 + row % kQ;
    if (b >= nb || q >= Nt) continue;
    float* o = out + ((size_t)b * Nt + q) * C;
#pragma unroll
    for (int vb = 0; vb < kVBoxes; ++vb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + 64 * vb + 8 * j + 2 * t;
        if (c < C) o[c] = acc[vb][4 * j + 2 * hr];
        if (c + 1 < C) o[c + 1] = acc[vb][4 * j + 2 * hr + 1];
      }
  }
}

template <bool kInt8>
int launch_cache_dense(const void* f, const void* cf, const void* v, const void* betas,
                       void* out, int nb, int Nt, int Ntp, int Ncp, int D, int C, int Cp,
                       cudaStream_t stream) {
  using namespace k1;
  if (nb < 1 || nb > kB || Ntp % kQ || Ncp % (2 * kN) || Cp % kC || D % 16 || D < 16 ||
      Ncp < 2 * kN)
    return (int)cudaErrorInvalidValue;
  const int nd = (D + 63) / 64;
  // even: a stage serves one warpgroup; at least two a warpgroup (one in use, one loading)
  const int fstages = min(kMaxFStages, (kSmemLimit - fixed_bytes(nd, kInt8)) / kBox) & ~1;
  if (fstages < 4) return (int)cudaErrorInvalidValue;
  const int smem = fixed_bytes(nd, kInt8) + fstages * kBox;
  CUtensorMap fm, cm, vm;
  int err;
  if ((err = map_2d(&fm, f, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, D, Ntp, 2LL * D, 64, kQ,
                    CU_TENSOR_MAP_SWIZZLE_128B)) != 0 ||
      (err = map_2d(&cm, cf, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, D, Ncp, 2LL * D, 64, kN,
                    CU_TENSOR_MAP_SWIZZLE_128B)) != 0 ||
      (err = kInt8 ? map_2d(&vm, v, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, Cp, Ncp, Cp, kC, kN,
                            CU_TENSOR_MAP_SWIZZLE_NONE)
                   : map_2d(&vm, v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, Cp, Ncp, 2LL * Cp, 64,
                            kN, CU_TENSOR_MAP_SWIZZLE_128B)) != 0)
    return err;
  cudaFuncSetAttribute(cache_dense_kernel<kInt8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  cache_dense_kernel<kInt8><<<dim3(Ntp / kQ, Cp / kC), kCtaThreads, smem, stream>>>(
      fm, cm, vm, (const float*)betas, (float*)out, nb, Nt, Ncp, D, C, fstages);
  return (int)cudaGetLastError();
}

// The affinity probe: tile i is cache rows 64 i .. x queries 16 i .. of cf and
// f (D <= 256 columns), S = F C^T two ways, each 16-deep step in order: WMMA as
// K2 computes it (out[0]) and K1's transposed wgmma.m64n16k16 (out[1]).
constexpr int kProbeMaxD = 256;
__global__ void __launch_bounds__(128)
affinity_probe_kernel(const bf16* __restrict__ f, const bf16* __restrict__ cf,
                      float* __restrict__ out, int D, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const int ld = D + kPad, nd = (D + 63) / 64;
  const uint32_t csw = base, fsw = base + nd * 8192;     // swizzled 64-column boxes
  bf16* frm = reinterpret_cast<bf16*>(gbase + nd * (8192 + 2048));   // row-major copies
  bf16* crm = frm + 16 * ld;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* fb = f + (size_t)blockIdx.x * 16 * D;
  const bf16* cb = cf + (size_t)blockIdx.x * 64 * D;
  for (int e = tid; e < 64 * nd * 64; e += 128) {
    const int r = e / (nd * 64), col = e % (nd * 64);
    const uint32_t off = (col >> 6) * 8192 + sw128_offset(r, col & 63);
    const bf16 cv = col < D ? cb[(size_t)r * D + col] : __float2bfloat16(0.f);
    *reinterpret_cast<bf16*>(gbase + off) = cv;
    if (col < D) crm[r * ld + col] = cv;
    if (r < 16) {
      const bf16 fv = col < D ? fb[(size_t)r * D + col] : __float2bfloat16(0.f);
      *reinterpret_cast<bf16*>(gbase + nd * 8192 + (col >> 6) * 2048 +
                               sw128_offset(r, col & 63)) = fv;
      if (col < D) frm[r * ld + col] = fv;
    }
  }
  fence_proxy_async();
  __syncthreads();
  float* o = out + (size_t)blockIdx.x * 16 * 64;
  {   // WMMA: warp w, the 16 queries x cache rows 16 w .. + 15
    FragC s;
    affinity_tile(s, frm, ld, crm + warp * 16 * ld, ld, D);
    wmma::store_matrix_sync(o + warp * 16, s, 64, wmma::mem_row_major);
  }
  // wgmma S^T: cache rows 16 w + g (+ 8), queries 8 j + 2 t (+ 1)
  float s[8];
  for (int e = 0; e < 8; ++e) s[e] = 0.f;
  keep_n(s);
  wgmma_fence();
  for (int d = 0; d < nd; ++d)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)   // the boxes are zero past D
      wgmma_m64n16k16_ss<0>(s, sw128_desc(csw + d * 8192 + 32 * kk),
                            sw128_desc(fsw + d * 2048 + 32 * kk), 1);
  wgmma_commit();
  wgmma_wait();
  keep_n(s);
  const int g = lane >> 2, t = lane & 3;
  float* o1 = out + (size_t)(tiles + blockIdx.x) * 16 * 64;
  for (int j = 0; j < 2; ++j)
    for (int hr = 0; hr < 2; ++hr)
      for (int u = 0; u < 2; ++u)
        o1[(8 * j + 2 * t + u) * 64 + 16 * warp + g + 8 * hr] = s[4 * j + 2 * hr + u];
}

int onehot_grouped_smem(int D) {
  return (kK3Q + kK3Rows) * (D + kPad) * 2 + kK3Rows * (kK3Q + 4) * 4;
}

template <int kExpand, bool kCastW>
int launch_onehot_grouped(const void* f, const void* cf, const void* rows_sorted,
                          const void* offs, const void* betas, void* out, int nb, int Nt,
                          int Ntp, int D, int C, int block_n, cudaStream_t stream) {
  if (nb < 1 || nb > kMaxBeta || Ntp % kK3Q) return (int)cudaErrorInvalidValue;
  const int smem = onehot_grouped_smem(D);
  cudaFuncSetAttribute(onehot_grouped_kernel<kExpand, kCastW>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid(Ntp / kK3Q, (C + kK3Classes - 1) / kK3Classes);
  onehot_grouped_kernel<kExpand, kCastW><<<grid, kThreads, smem, stream>>>(
      (const bf16*)f, (const bf16*)cf, (const int*)rows_sorted, (const int*)offs,
      (const float*)betas, (float*)out, nb, Nt, D, C, block_n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int labels_dense_smem_bytes(int D) {
  return (16 * (D + kPad) + 16 * (kK2Rows + kPad)) * 2 + (16 * kK2Rows + kWarps * 256) * 4;
}

// f (Ntp, D) with Ntp % 16 == 0; cf (Ncp, D) and labels (Ncp,) with Ncp % 128 == 0.
int labels_dense_bf16(const void* f, const void* cf, const void* labels, const void* betas,
                      void* out, int nb, int Nt, int Ntp, int Ncp, int D, int C,
                      void* stream) {
  const int smem = labels_dense_smem_bytes(D);
  cudaFuncSetAttribute(labels_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid(Ntp / 16, nb, (C + kK2Classes - 1) / kK2Classes);
  labels_dense_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)f, (const bf16*)cf, (const int*)labels, (const float*)betas, (float*)out,
      Nt, Ncp, D, C);
  return (int)cudaGetLastError();
}

int onehot_grouped_smem_bytes(int D) { return onehot_grouped_smem(D); }

// f (Ntp, D) with Ntp % 64 == 0; rows_sorted: real cache rows stably sorted by
// label; offs (C + 1,): class c owns rows_sorted[offs[c] .. offs[c + 1]).
int onehot_grouped_bf16(const void* f, const void* cf, const void* rows_sorted,
                        const void* offs, const void* betas, void* out, int nb, int Nt,
                        int Ntp, int D, int C, void* stream) {
  return launch_onehot_grouped<kRowSum, true>(f, cf, rows_sorted, offs, betas, out, nb, Nt,
                                              Ntp, D, C, 1, (cudaStream_t)stream);
}

// K13: as onehot_grouped_bf16, with the class partials of each block_n-row
// block of the cache (rows in their original order) added as expand_mode says
// (0 highest, 1 split3, 2 default); cast_w 0 or 1.
int onehot_variant_bf16(const void* f, const void* cf, const void* rows_sorted,
                        const void* offs, const void* betas, void* out, int nb, int Nt,
                        int Ntp, int D, int C, int block_n, int expand_mode, int cast_w,
                        void* stream) {
  if (block_n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define K13_LAUNCH(MODE, CAST)                                                              \
  return launch_onehot_grouped<MODE, CAST>(f, cf, rows_sorted, offs, betas, out, nb, Nt, Ntp, \
                                           D, C, block_n, s)
  switch (expand_mode * 2 + (cast_w ? 1 : 0)) {
    case 0: K13_LAUNCH(kHighest, false);
    case 1: K13_LAUNCH(kHighest, true);
    case 2: K13_LAUNCH(kSplit3, false);
    case 3: K13_LAUNCH(kSplit3, true);
    case 4: K13_LAUNCH(kDefault, false);
    case 5: K13_LAUNCH(kDefault, true);
    default: return (int)cudaErrorInvalidValue;
  }
#undef K13_LAUNCH
}

// f (Ntp, D) with Ntp % 32 == 0; cf (Ncp, D) and v (Ncp, Cp) with Ncp % 64 == 0,
// Cp % 128 == 0 (zero value rows and columns as padding); nb <= 8 betas;
// D % 16 == 0 and D <= 1152 (the query tile stays in shared memory); every
// base 16-byte aligned (TMA).
int cache_dense_bf16(const void* f, const void* cf, const void* v, const void* betas,
                     void* out, int nb, int Nt, int Ntp, int Ncp, int D, int C, int Cp,
                     void* stream) {
  return launch_cache_dense<false>(f, cf, v, betas, out, nb, Nt, Ntp, Ncp, D, C, Cp,
                                   (cudaStream_t)stream);
}

int cache_dense_i8(const void* f, const void* cf, const void* v, const void* betas, void* out,
                   int nb, int Nt, int Ntp, int Ncp, int D, int C, int Cp, void* stream) {
  return launch_cache_dense<true>(f, cf, v, betas, out, nb, Nt, Ntp, Ncp, D, C, Cp,
                                  (cudaStream_t)stream);
}

// K1's feature-ring stages at width D (0: D does not fit shared memory)
int cache_dense_feature_stages(int D, int int8_values) {
  const int st = (k1::kSmemLimit - k1::fixed_bytes((D + 63) / 64, int8_values != 0)) / k1::kBox;
  return st < 4 ? 0 : (st > k1::kMaxFStages ? k1::kMaxFStages : st) & ~1;
}

// f: (16 tiles, D), cf: (64 tiles, D) bf16, D % 16 == 0, D <= 256;
// out: (2, tiles, 16, 64) f32
int affinity_probe_bf16(const void* f, const void* cf, void* out, int D, int tiles,
                        void* stream) {
  if (D < 16 || D % 16 || D > kProbeMaxD || tiles < 1) return (int)cudaErrorInvalidValue;
  const int nd = (D + 63) / 64;
  const int smem = 1024 + nd * (8192 + 2048) + 80 * (D + kPad) * 2;
  cudaFuncSetAttribute(affinity_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  affinity_probe_kernel<<<tiles, 128, smem, (cudaStream_t)stream>>>(
      (const bf16*)f, (const bf16*)cf, (float*)out, D, tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
