// Weight-streaming products for decode-shaped activations (R <= 8 rows), sm_90a.
//
// Replaces the TPU kernels of summer_clip_tpu/ops/gemv.py:
//   K7  streamed_qmatmul -> streamed_qmatmul_{i8,bf16,f32}
//       out (R, N) f32 = (bf16(x) (R, K) . w (K, N), f32 sums) * scale (N)
//   K10 fused_qmlp       -> fused_qmlp_i8
//       out (R, D) f32 = (bf16(gelu_tanh(bf16(x) . w1 * s1 + b1)) . w2) * s2 + b2
//
// Arithmetic, the same in the plain PyTorch versions: x rounded to bf16, an
// int8 weight widened exactly, the products and sums in f32 (a bf16 times an
// int8 is exact in f32, so FMA on the CUDA cores is as exact as a tensor-core
// product), the scale multiplied after the sum. The hidden of K10 stays f32
// until the bf16 rounding that feeds the second product.
//
// What bounds them on Hopper: bytes. One token reads every stored weight once
// and does 2 R operations per weight, far under the card's operations per byte.
// So the kernels read the weights as stored, 16 bytes a thread with adjacent
// threads on adjacent columns of the row-major matrix, and keep several loads
// in flight per thread.
//
// K7. N = 1280 gives only 80 16-byte column groups, so a block owns 8 of
// them (128 int8 columns) and its 256 threads split the K rows 32 ways; where
// the column tiles alone do not fill 132 SMs, the K axis is also split over
// blocks (grid.y). The 32 row lanes of a block are added in a fixed order
// (shuffles, then shared memory). Split blocks write their (R, 128) partial
// sums to a workspace; the block that arrives last at a column tile (an
// integer ticket, no float atomics) adds the partials in split order and
// applies the scale. So the result is deterministic, and a row's result does
// not depend on how many rows ride with it (the split depends on K, N and the
// weight type only). A first version gave a block 2048 columns and 8-row
// chunks: the two last blocks of c_attn then added 160 partials of 2048
// columns alone (0.106 ms at R = 1 and 0.73 ms at R = 8 on an H100, against
// 0.007 and 0.018 ms of this one). The next step is the K split inside a
// thread block cluster, added through distributed shared memory, which takes
// the workspace round trip out of a kernel of a few microseconds.
//
// K10. The hidden chunks are the parallel axis: a block owns 32 hidden units,
// stages its (D, 32) slab of w1 (32-byte pieces of each row) and the bf16-
// rounded x in shared memory, computes its (R, 32) slice of the hidden, and
// multiplies it by its 32 contiguous rows of w2. The (chunks, R, D) partials
// go to a workspace and a second small kernel of the same entry point adds
// them in chunk order and applies s2 and b2: a last-block reduction of 160
// chunks by one block would take longer than the products.
//
// Each entry point returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gemv_common.cuh"

namespace {

constexpr int kThreads = 256;   // K7: threads a block
constexpr int kGroups = 8;      // K7: 16-byte column groups a block owns (128 int8 columns)
constexpr int kLanes = kThreads / kGroups;   // K7: rows of a chunk walked side by side
constexpr int kMaxChunk = 1024; // K7: rows of x a block keeps in shared memory

// K7. grid.x: column tiles of kGroups 16-byte groups; grid.y: K splits of
// `chunk` rows. Thread = (k lane, column group): lane & 7 is the group, and
// the 32 (warp, lane >> 3) pairs walk the chunk's rows 32 apart, so a warp
// reads four 128-byte row pieces at a time. ws: (splits, rows, N) partial sums;
// tickets: one int per column tile, 0 at rest.
template <typename W, int R, bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
qmatmul_kernel(const float* __restrict__ x, const W* __restrict__ w,
               const float* __restrict__ scale, float* __restrict__ out,
               float* __restrict__ ws, int* __restrict__ tickets, int rows, int K, int N,
               int chunk) {
  constexpr int V = Vec<W>::n;
  constexpr int TILE = kGroups * V;               // columns a block owns
  __shared__ __align__(16) float xs[8 * kMaxChunk];   // x rows, then the warps' sums
  __shared__ int is_last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kb = blockIdx.y * chunk;
  const int len = min(K, kb + chunk) - kb;
  const int splits = gridDim.y;

  // this block's rows kb .. of x, rounded to bf16; rows past `rows` are zero
  for (int i = tid; i < R * len; i += kThreads) {
    const int r = i / len, k = i % len;
    xs[r * kMaxChunk + k] = r < rows ? round_bf16(x[(size_t)r * K + kb + k]) : 0.f;
  }
  __syncthreads();

  const int c0 = blockIdx.x * TILE;
  const int col = c0 + (lane & (kGroups - 1)) * V;
  const int klane = warp * (32 / kGroups) + lane / kGroups;   // 0 .. kLanes - 1
  float acc[R][V];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < V; ++j) acc[r][j] = 0.f;
  }
  if (col < N) {
    constexpr int U = R >= 8 ? 2 : 4;   // rows of w in flight per thread
    const W* wp = w + (size_t)kb * N;
    int k = klane;
    for (; k + (U - 1) * kLanes < len; k += U * kLanes) {
      float f[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u)
        load_cols<W, ALIGNED>(wp + (size_t)(k + u * kLanes) * N, col, N, f[u]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float xv = xs[r * kMaxChunk + k + u * kLanes];
#pragma unroll
          for (int j = 0; j < V; ++j) acc[r][j] = fmaf(xv, f[u][j], acc[r][j]);
        }
      }
    }
    for (; k < len; k += kLanes) {
      float f[V];
      load_cols<W, ALIGNED>(wp + (size_t)k * N, col, N, f);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float xv = xs[r * kMaxChunk + k];
#pragma unroll
        for (int j = 0; j < V; ++j) acc[r][j] = fmaf(xv, f[j], acc[r][j]);
      }
    }
  }
  // add the k lanes in a fixed order: within the warp by shuffles, then the
  // warps through shared memory (x is no longer read)
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], kGroups);
      acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], 2 * kGroups);
    }
  }
  __syncthreads();
  float* red = xs;   // (warps, R, TILE)
  if (lane < kGroups) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < V; ++j) red[(warp * R + r) * TILE + lane * V + j] = acc[r][j];
    }
  }
  __syncthreads();
  const int width = min(N - c0, TILE);
  for (int i = tid; i < rows * width; i += kThreads) {
    const int r = i / width, c = i % width;
    float sum = 0.f;
#pragma unroll
    for (int wv = 0; wv < kThreads / 32; ++wv) sum += red[(wv * R + r) * TILE + c];
    if (splits == 1)
      out[(size_t)r * N + c0 + c] = sum * (scale ? scale[c0 + c] : 1.f);
    else
      ws[((size_t)blockIdx.y * rows + r) * N + c0 + c] = sum;
  }
  if (splits == 1) return;

  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&tickets[blockIdx.x], 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // the last block of this column tile: add the partials in split order
  for (int i = tid; i < rows * width; i += kThreads) {
    const int r = i / width, c = c0 + i % width;
    const float* p = ws + (size_t)r * N + c;
    const size_t step = (size_t)rows * N;
    float sum = 0.f;
    int s = 0;
    for (; s + 4 <= splits; s += 4) {   // four loads in flight, added in split order
      const float p0 = __ldcg(p + s * step), p1 = __ldcg(p + (s + 1) * step);
      const float p2 = __ldcg(p + (s + 2) * step), p3 = __ldcg(p + (s + 3) * step);
      sum += p0;
      sum += p1;
      sum += p2;
      sum += p3;
    }
    for (; s < splits; ++s) sum += __ldcg(p + s * step);
    out[(size_t)r * N + c] = sum * (scale ? scale[c] : 1.f);
  }
  if (tid == 0) tickets[blockIdx.x] = 0;
}

template <typename W, int R>
int launch_qmatmul_r(const void* x, const void* w, const void* scale, void* out, void* ws,
                     void* tickets, int rows, int K, int N, int chunk, int splits, bool aligned,
                     cudaStream_t stream) {
  constexpr int TILE = kGroups * Vec<W>::n;
  dim3 grid((unsigned)((N + TILE - 1) / TILE), (unsigned)splits);
  if (aligned)
    qmatmul_kernel<W, R, true><<<grid, kThreads, 0, stream>>>(
        (const float*)x, (const W*)w, (const float*)scale, (float*)out, (float*)ws,
        (int*)tickets, rows, K, N, chunk);
  else
    qmatmul_kernel<W, R, false><<<grid, kThreads, 0, stream>>>(
        (const float*)x, (const W*)w, (const float*)scale, (float*)out, (float*)ws,
        (int*)tickets, rows, K, N, chunk);
  return (int)cudaGetLastError();
}

template <typename W>
int launch_qmatmul(const void* x, const void* w, const void* scale, void* out, void* ws,
                   void* tickets, int rows, int K, int N, int chunk, void* stream) {
  if (rows < 1 || rows > 8 || K < 1 || N < 1 || chunk < 1 || chunk > kMaxChunk)
    return (int)cudaErrorInvalidValue;
  const int splits = (K + chunk - 1) / chunk;
  if (splits > 65535) return (int)cudaErrorInvalidValue;
  const bool aligned = N % Vec<W>::n == 0 && (uintptr_t)w % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (rows == 1)
    return launch_qmatmul_r<W, 1>(x, w, scale, out, ws, tickets, rows, K, N, chunk, splits, aligned, s);
  if (rows == 2)
    return launch_qmatmul_r<W, 2>(x, w, scale, out, ws, tickets, rows, K, N, chunk, splits, aligned, s);
  if (rows <= 4)
    return launch_qmatmul_r<W, 4>(x, w, scale, out, ws, tickets, rows, K, N, chunk, splits, aligned, s);
  return launch_qmatmul_r<W, 8>(x, w, scale, out, ws, tickets, rows, K, N, chunk, splits, aligned, s);
}

// ---------------------------------------------------------------------------
// K10
// ---------------------------------------------------------------------------
constexpr int kMlpThreads = 256;
constexpr int kMlpWarps = kMlpThreads / 32;
constexpr int kBh = 32;          // hidden units per block

// Shared memory: xs (R, D) f32 | w1s (D, 32) int8 | red (8 warps, R, 32) f32 |
// hs (R, 32) f32. part: (H / 32, rows, D).
template <int R>
__global__ void __launch_bounds__(kMlpThreads)
qmlp_partial_kernel(const float* __restrict__ x, const int8_t* __restrict__ w1,
                    const float* __restrict__ s1, const float* __restrict__ b1,
                    const int8_t* __restrict__ w2, float* __restrict__ part, int rows, int D,
                    int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  int8_t* w1s = reinterpret_cast<int8_t*>(xs + R * D);
  float* red = reinterpret_cast<float*>(w1s + (size_t)D * kBh);
  float* hs = red + kMlpWarps * R * kBh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h0 = blockIdx.x * kBh;

  // the (D, 32) slab of w1: two 16-byte pieces a row, several rows in flight
  for (int i = tid; i < D * 2; i += kMlpThreads) {
    const int k = i >> 1, half = i & 1;
    *reinterpret_cast<uint4*>(w1s + k * kBh + half * 16) =
        *reinterpret_cast<const uint4*>(w1 + (size_t)k * H + h0 + half * 16);
  }
  for (int i = tid; i < R * D; i += kMlpThreads) {
    const int r = i / D, k = i % D;
    xs[i] = r < rows ? round_bf16(x[(size_t)r * D + k]) : 0.f;
  }
  __syncthreads();

  // first product: warp = slice of K (D / 8 rows), lane = hidden unit
  {
    const int slice = D / kMlpWarps;
    const int k0 = warp * slice;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int k = k0; k < k0 + slice; k += 4) {
      float wv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) wv[u] = (float)w1s[(k + u) * kBh + lane];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + r * D + k);
        acc[r] = fmaf(xv.x, wv[0], acc[r]);
        acc[r] = fmaf(xv.y, wv[1], acc[r]);
        acc[r] = fmaf(xv.z, wv[2], acc[r]);
        acc[r] = fmaf(xv.w, wv[3], acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) red[(warp * R + r) * kBh + lane] = acc[r];
  }
  __syncthreads();
  if (tid < R * kBh) {
    const int r = tid >> 5;
    float sum = 0.f;
#pragma unroll
    for (int wv = 0; wv < kMlpWarps; ++wv) sum += red[(wv * R + r) * kBh + lane];
    const float t = sum * s1[h0 + lane] + b1[h0 + lane];
    hs[r * kBh + lane] = round_bf16(gelu_tanh(t));
  }
  __syncthreads();

  // second product: a thread owns 16 adjacent output columns and walks the
  // block's 32 rows of w2, which are contiguous in device memory
  for (int cg = tid; cg < D / 16; cg += kMlpThreads) {
    const int col = cg * 16;
    float acc[R][16];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[r][j] = 0.f;
    }
    const int8_t* wp = w2 + (size_t)h0 * D + col;
    constexpr int U = R >= 8 ? 4 : 8;
    for (int j0 = 0; j0 < kBh; j0 += U) {
      float f[U][16];
#pragma unroll
      for (int u = 0; u < U; ++u)
        Vec<int8_t>::unpack(*reinterpret_cast<const uint4*>(wp + (size_t)(j0 + u) * D), f[u]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float hv = hs[r * kBh + j0 + u];
#pragma unroll
          for (int j = 0; j < 16; ++j) acc[r][j] = fmaf(hv, f[u][j], acc[r][j]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < rows) {
        float4* dst = reinterpret_cast<float4*>(part + ((size_t)blockIdx.x * rows + r) * D + col);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dst[j] = make_float4(acc[r][4 * j], acc[r][4 * j + 1], acc[r][4 * j + 2],
                               acc[r][4 * j + 3]);
      }
    }
  }
}

// out[r, n] = (sum over chunks, in chunk order, of part[c, r, n]) * s2[n] + b2[n]
__global__ void qmlp_reduce_kernel(const float* __restrict__ part, const float* __restrict__ s2,
                                   const float* __restrict__ b2, float* __restrict__ out,
                                   int rows, int D, int chunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * D) return;
  const int n = i % D;
  float sum = 0.f;
  for (int c = 0; c < chunks; ++c) sum += part[(size_t)c * rows * D + i];
  out[i] = sum * s2[n] + b2[n];
}

template <int R>
int launch_qmlp(const void* x, const void* w1, const void* s1, const void* b1, const void* w2,
                void* part, int rows, int D, int H, cudaStream_t stream) {
  const int smem = R * D * 4 + D * kBh + kMlpWarps * R * kBh * 4 + R * kBh * 4;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(qmlp_partial_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  qmlp_partial_kernel<R><<<H / kBh, kMlpThreads, smem, stream>>>(
      (const float*)x, (const int8_t*)w1, (const float*)s1, (const float*)b1, (const int8_t*)w2,
      (float*)part, rows, D, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (rows <= 8, K) f32, w (K, N) row-major, scale (N) f32 or null, out (rows, N)
// f32. ws: at least ceil(K / chunk) * rows * N floats; tickets: at least
// ceil(N / (8 * columns per 16 bytes)) ints, zero before the first call (the
// kernel leaves them zero). chunk <= 1024 rows of K per block.
int streamed_qmatmul_i8(const void* x, const void* w, const void* scale, void* out, void* ws,
                        void* tickets, int rows, int K, int N, int chunk, void* stream) {
  return launch_qmatmul<int8_t>(x, w, scale, out, ws, tickets, rows, K, N, chunk, stream);
}
int streamed_qmatmul_bf16(const void* x, const void* w, const void* scale, void* out, void* ws,
                          void* tickets, int rows, int K, int N, int chunk, void* stream) {
  return launch_qmatmul<bf16>(x, w, scale, out, ws, tickets, rows, K, N, chunk, stream);
}
int streamed_qmatmul_f32(const void* x, const void* w, const void* scale, void* out, void* ws,
                         void* tickets, int rows, int K, int N, int chunk, void* stream) {
  return launch_qmatmul<float>(x, w, scale, out, ws, tickets, rows, K, N, chunk, stream);
}

// x (rows <= 8, D) f32; w1 (D, H), w2 (H, D) int8 row-major, 16-byte aligned;
// s1, b1 (H), s2, b2 (D) f32; out (rows, D) f32; part: (H / 32) * rows * D floats.
// D a multiple of 32, H a multiple of 32.
int fused_qmlp_i8(const void* x, const void* w1, const void* s1, const void* b1, const void* w2,
                  const void* s2, const void* b2, void* out, void* part, int rows, int D, int H,
                  void* stream) {
  if (rows < 1 || rows > 8 || D < 32 || D % 32 || H < kBh || H % kBh)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)w1 % 16 || (uintptr_t)w2 % 16 || (uintptr_t)part % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  if (rows == 1) err = launch_qmlp<1>(x, w1, s1, b1, w2, part, rows, D, H, s);
  else if (rows == 2) err = launch_qmlp<2>(x, w1, s1, b1, w2, part, rows, D, H, s);
  else if (rows <= 4) err = launch_qmlp<4>(x, w1, s1, b1, w2, part, rows, D, H, s);
  else err = launch_qmlp<8>(x, w1, s1, b1, w2, part, rows, D, H, s);
  if (err != 0) return err;
  const int total = rows * D;
  qmlp_reduce_kernel<<<(total + 127) / 128, 128, 0, s>>>(
      (const float*)part, (const float*)s2, (const float*)b2, (float*)out, rows, D, H / kBh);
  return (int)cudaGetLastError();
}

}  // extern "C"
