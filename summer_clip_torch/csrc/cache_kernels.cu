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
//   - K1 is bound by operations (2 Nt Nc C per beta). A block owns 32
//     queries x 128 classes x the 8 betas of a launch: the 8 weight tiles of
//     one affinity tile are stacked into a 256-row operand, so one affinity
//     tile serves all betas of the chunk and the f32 accumulators (256 x 128)
//     fill the registers of 16 warps. The price of tiling the classes is that
//     each of the C / 128 class slices recomputes the affinity (0.75 of a
//     slice's w @ V work at D = 768); sharing it across slices would need the
//     (Nt, Nc) affinity in device memory, which the TPU kernel never writes
//     either. Cache features stream through shared memory in 128-column
//     slices by cp.async into two buffers, the next slice in flight while the
//     current one is multiplied; values come in 128 x 128 tiles (int8 values
//     are converted per tile) into the buffer just consumed.
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
// K1: block = (32-query tile, 128-class slice), all betas (<= 8) of the launch.
// 16 warps. Per step of 128 cache rows: warp w computes affinity tile
// (w / 8, w % 8) over the whole D, K steps in order (the same order as
// affinity_tile, so K1 and K2 see the same affinity bits); all threads turn the
// 32 x 128 affinities into 8 x 32 weight rows; warp w accumulates rows
// 32 (w / 2) .. + 31 (beta w / 2) x columns 64 (w % 2) .. + 63 of W @ V.
// ---------------------------------------------------------------------------
constexpr int kK1Warps = 16, kK1Threads = kK1Warps * 32;
constexpr int kK1Q = 32, kK1N = 128, kK1C = 128, kK1B = 8, kK1Ks = 128;
constexpr int kK1Ldr = 128 + kPad;      // feature slice / value tile rows (bf16)
constexpr int kK1Ldw = kK1N + kPad;     // weight rows (bf16)
constexpr int kK1Lda = kK1N + 4;        // affinity rows (f32)

__device__ __forceinline__ uint4 ld16g(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gmem_ptr) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem_ptr));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

// 128 x 128 value tile into shared memory as bf16 (rows n0 .., columns c0 ..)
__device__ __forceinline__ void load_values(bf16* r_s, const bf16* v, int n0, int c0, int Cp,
                                            int tid) {
  for (int g = tid; g < kK1N * (kK1C / 8); g += kK1Threads) {
    const int r = g / (kK1C / 8), c = (g % (kK1C / 8)) * 8;
    *reinterpret_cast<uint4*>(r_s + r * kK1Ldr + c) = ld16g(v + (size_t)(n0 + r) * Cp + c0 + c);
  }
}
__device__ __forceinline__ void load_values(bf16* r_s, const int8_t* v, int n0, int c0, int Cp,
                                            int tid) {
  for (int g = tid; g < kK1N * (kK1C / 16); g += kK1Threads) {
    const int r = g / (kK1C / 16), c = (g % (kK1C / 16)) * 16;
    const uint4 raw = ld16g(v + (size_t)(n0 + r) * Cp + c0 + c);
    const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
    uint4 lo, hi;
    bf16* l8 = reinterpret_cast<bf16*>(&lo);
    bf16* h8 = reinterpret_cast<bf16*>(&hi);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      l8[t] = __float2bfloat16((float)e[t]);
      h8[t] = __float2bfloat16((float)e[8 + t]);
    }
    *reinterpret_cast<uint4*>(r_s + r * kK1Ldr + c) = lo;
    *reinterpret_cast<uint4*>(r_s + r * kK1Ldr + c + 8) = hi;
  }
}

template <typename VT>
__global__ void __launch_bounds__(kK1Threads, 1)
cache_dense_kernel(const bf16* __restrict__ f, const bf16* __restrict__ cf,
                   const VT* __restrict__ v, const float* __restrict__ betas,
                   float* __restrict__ out, int nb, int Nt, int Ncp, int D, int C, int Cp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kK1Q, c0 = blockIdx.y * kK1C;
  const int ldq = D + kPad;
  bf16* q_s = reinterpret_cast<bf16*>(smem);                       // kK1Q x ldq
  bf16* r_s = q_s + kK1Q * ldq;                                    // 2 x 128 x kK1Ldr
  float* aff_s = reinterpret_cast<float*>(r_s + 2 * 128 * kK1Ldr); // kK1Q x kK1Lda
  bf16* w_s = reinterpret_cast<bf16*>(aff_s + kK1Q * kK1Lda);      // (kK1B * kK1Q) x kK1Ldw
  __shared__ float beta_s[kK1B];

  for (int g = tid; g < kK1Q * (D / 8); g += kK1Threads) {
    const int r = g / (D / 8), c = (g % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(q_s + r * ldq + c) = ld16g(f + (size_t)(q0 + r) * D + c);
  }
  if (tid < kK1B) beta_s[tid] = betas[tid < nb ? tid : nb - 1];

  const int aq = warp / 8, an = warp % 8;   // this warp's affinity tile
  const int wm = warp / 2, wn = warp % 2;   // this warp's output tile (beta wm)
  FragC acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // feature slice (rows n0 .., columns k0 ..) of the cache into buffer `buf`
  auto issue_slice = [&](int n0, int k0, int buf) {
    const int ks = min(kK1Ks, D - k0);
    bf16* dst = r_s + buf * 128 * kK1Ldr;
    for (int g = tid; g < kK1N * (ks / 8); g += kK1Threads) {
      const int r = g / (ks / 8), c = (g % (ks / 8)) * 8;
      cp_async16(dst + r * kK1Ldr + c, cf + (size_t)(n0 + r) * D + k0 + c);
    }
  };
  int it = 0;            // slices consumed so far; slice `it` lives in buffer it & 1
  issue_slice(0, 0, 0);
  cp_async_commit();
  for (int n0 = 0; n0 < Ncp; n0 += kK1N) {
    FragC s;
    wmma::fill_fragment(s, 0.f);
    for (int k0 = 0; k0 < D; k0 += kK1Ks, ++it) {
      const int ks = min(kK1Ks, D - k0);
      // the other buffer was last read before the barrier that ended the
      // previous slice (or the previous step's w @ V): the next slice may land
      const bool more_k = k0 + kK1Ks < D, more = more_k || n0 + kK1N < Ncp;
      if (more) issue_slice(more_k ? n0 : n0 + kK1N, more_k ? k0 + kK1Ks : 0, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait_one();
      __syncthreads();   // slice `it` landed for all (and q_s, beta_s, first time round)
      const bf16* c_t = r_s + (it & 1) * 128 * kK1Ldr;
      for (int kk = 0; kk < ks; kk += 16) {
        FragA a;
        FragBc b;
        wmma::load_matrix_sync(a, q_s + aq * 16 * ldq + k0 + kk, ldq);
        wmma::load_matrix_sync(b, c_t + an * 16 * kK1Ldr + kk, kK1Ldr);
        wmma::mma_sync(s, a, b, s);
      }
      __syncthreads();   // every warp is done with buffer it & 1
    }
    wmma::store_matrix_sync(aff_s + aq * 16 * kK1Lda + an * 16, s, kK1Lda, wmma::mem_row_major);
    __syncthreads();     // affinities complete
    bf16* v_s = r_s + ((it - 1) & 1) * 128 * kK1Ldr;   // the buffer just consumed
    load_values(v_s, v, n0, c0, Cp, tid);
    for (int idx = tid; idx < kK1Q * kK1N; idx += kK1Threads) {
      const int qi = idx / kK1N, n = idx % kK1N;
      const float a = aff_s[qi * kK1Lda + n];
#pragma unroll
      for (int b = 0; b < kK1B; ++b)
        w_s[(b * kK1Q + qi) * kK1Ldw + n] = __float2bfloat16(expf(-beta_s[b] * (1.0f - a)));
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < kK1N; kk += 16) {
      FragA fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], w_s + (wm * 32 + i * 16) * kK1Ldw + kk, kK1Ldw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragBr fb;
        wmma::load_matrix_sync(fb, v_s + kk * kK1Ldr + wn * 64 + j * 16, kK1Ldr);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
    __syncthreads();     // the value buffer and w_s are free for the next step
  }
  __syncthreads();       // w_s becomes the warps' f32 staging
  float* my = reinterpret_cast<float*>(w_s) + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(my, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int qq = q0 + i * 16 + e / 16, c = c0 + wn * 64 + j * 16 + e % 16;
        if (wm < nb && qq < Nt && c < C) out[((size_t)wm * Nt + qq) * C + c] = my[e];
      }
      __syncwarp();
    }
}

template <typename VT>
int launch_cache_dense(const void* f, const void* cf, const void* v, const void* betas,
                       void* out, int nb, int Nt, int Ntp, int Ncp, int D, int C, int Cp,
                       cudaStream_t stream) {
  if (nb < 1 || nb > kK1B || Ntp % kK1Q || Ncp % kK1N || Cp % kK1C || D % 16 || D < 16)
    return (int)cudaErrorInvalidValue;
  const int smem = (kK1Q * (D + kPad) + 2 * 128 * kK1Ldr + kK1B * kK1Q * kK1Ldw) * 2
                   + kK1Q * kK1Lda * 4;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(cache_dense_kernel<VT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  dim3 grid(Ntp / kK1Q, Cp / kK1C);
  cache_dense_kernel<VT><<<grid, kK1Threads, smem, stream>>>(
      (const bf16*)f, (const bf16*)cf, (const VT*)v, (const float*)betas, (float*)out, nb, Nt,
      Ncp, D, C, Cp);
  return (int)cudaGetLastError();
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

// f (Ntp, D) with Ntp % 32 == 0; cf (Ncp, D) and v (Ncp, Cp) with Ncp % 128 == 0,
// Cp % 128 == 0 (zero value rows and columns as padding); nb <= 8 betas;
// D % 16 == 0 and D <= 1152 (the query tile stays in shared memory).
int cache_dense_bf16(const void* f, const void* cf, const void* v, const void* betas,
                     void* out, int nb, int Nt, int Ntp, int Ncp, int D, int C, int Cp,
                     void* stream) {
  return launch_cache_dense<bf16>(f, cf, v, betas, out, nb, Nt, Ntp, Ncp, D, C, Cp,
                                  (cudaStream_t)stream);
}

int cache_dense_i8(const void* f, const void* cf, const void* v, const void* betas, void* out,
                   int nb, int Nt, int Ntp, int Ncp, int D, int C, int Cp, void* stream) {
  return launch_cache_dense<int8_t>(f, cf, v, betas, out, nb, Nt, Ntp, Ncp, D, C, Cp,
                                    (cudaStream_t)stream);
}

}  // extern "C"
