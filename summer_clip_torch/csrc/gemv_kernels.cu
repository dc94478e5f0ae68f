// Weight-streaming products for decode-shaped activations (R <= 8 rows), sm_90a.
//
// Replaces the TPU kernels of summer_clip_tpu/ops/gemv.py:
//   K7  streamed_qmatmul -> cluster_qmatmul_{i8,bf16,f32}
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
//
// K7. A launch of a few microseconds, so its fixed cost is the target. A CTA
// owns a (column tile of twb bytes, K chunk) item; the CTAs that split one
// tile's K form a thread-block cluster (1, 2, 4 or 8; ops/gemv.k7_plan picks
// twb, the split and the box rows from K, N and the weight type only). At its
// start a CTA's thread 0 asks TMA for its first ring slots of weight boxes
// (2-D boxes of a UINT8 map over the rows' bytes; up to 96 KB in flight a
// CTA), before griddepcontrol.wait: the weights never depend on the kernel
// before, so under programmatic dependent launch they stream while that kernel
// ends. x is read only after the wait, rounded to bf16 into shared memory. The
// consumers multiply each box from shared memory (weight_ring.cuh); a slot, once
// read, is refilled with the CTA's next box. After the main loop the CTA lets
// the next launch start (griddepcontrol.launch_dependents), sums its tile in a
// fixed order and pushes each sum to the rank that owns it (distributed shared
// memory); after one cluster barrier each rank adds its sums in rank order and
// scales and stores its share of the tile. No
// workspace, no ticket, no second pass over L2. The split and the order of
// every sum depend on the matrix only, so a row's result does not depend on the
// rows that ride with it, and two runs give the same bits. Rows whose bytes TMA
// cannot address (N times the item size not a multiple of 16, or a base not
// 16-byte aligned) are copied element by element into the same boxes by the
// CTA's threads; none of gpt2-large's matrices takes that path.
//
// K10. The hidden chunks are the parallel axis: a block owns 32 hidden units,
// stages its (D, 32) slab of w1 (32-byte pieces of each row) and the bf16-
// rounded x in shared memory, computes its (R, 32) slice of the hidden, and
// multiplies it by its 32 contiguous rows of w2. The (chunks, R, D) partials
// go to a workspace and a second small kernel of the same entry point adds
// them in chunk order and applies s2 and b2: a last-block reduction of 160
// chunks by one block would take longer than the products.
//
// Each entry point returns the launch's error.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "gemv_common.cuh"
#include "hopper_common.cuh"
#include "weight_ring.cuh"

namespace {

// ---------------------------------------------------------------------------
// K7
// ---------------------------------------------------------------------------
constexpr int kQmmRingBytes = 96 * 1024;   // weight bytes a CTA keeps in flight
constexpr int kQmmMaxSlots = 16;
constexpr int kQmmXsRows = 1280;           // rows of x a CTA stages at a time
constexpr int kSmemLimit = 232448;

struct QmmArgs {
  CUtensorMap map;                 // w as (K rows, N * itemsize bytes), UINT8, box (twb, br)
  const float* x;                  // (rows, K)
  const void* w;                   // (K, N) row-major
  const float* scale;              // (N) or null
  float* out;                      // (rows, N)
  int rows, K, N;
  int twb, split, kc, br;          // tile bytes, CTAs a cluster, rows of K a CTA, rows a box
  int slots, slot_bytes, seg;      // ring slots, their stride, rows of x staged at a time
  int tma;                         // 1: TMA boxes; 0: element-wise copies
};

template <typename W> struct Bits;
template <> struct Bits<int8_t> { typedef uint8_t t; };
template <> struct Bits<bf16> { typedef uint16_t t; };
template <> struct Bits<float> { typedef uint32_t t; };

// box j of this CTA's chunk by the CTA's threads, zeros past the matrix
template <typename W>
__device__ __forceinline__ void copy_box(const QmmArgs& a, int c0, int row0, unsigned char* dst) {
  typedef typename Bits<W>::t U;
  const int tw = a.twb / (int)sizeof(W);
  const U* w = reinterpret_cast<const U*>(a.w);
  for (int i = threadIdx.x; i < a.br * tw; i += kRingThreads) {
    const int r = row0 + i / tw, c = c0 + i % tw;
    reinterpret_cast<U*>(dst)[i] = r < a.K && c < a.N ? w[(size_t)r * a.N + c] : (U)0;
  }
}

template <typename W, int R>
__global__ void __launch_bounds__(kRingThreads)
qmatmul_kernel(const __grid_constant__ QmmArgs a) {
  constexpr int V = Vec<W>::n;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int tw = a.twb / (int)sizeof(W);
  unsigned char* ring = smem;
  float* xs = reinterpret_cast<float*>(smem + (size_t)a.slots * a.slot_bytes);   // (R, seg)
  float* red = xs + R * a.seg;                     // (warps, R, tw)
  float* recv = red + kRingWarps * R * tw;         // (split, stride): the ranks' sums, pushed
  uint64_t* bars = reinterpret_cast<uint64_t*>(recv + R * tw + 8);
  const int rank = a.split > 1 ? (int)cluster_rank() : 0;
  const int tile = blockIdx.x / a.split;
  const int kb = rank * a.kc, c0 = tile * tw;
  const int nbox = a.kc / a.br;
  const int box_bytes = a.twb * a.br;

  if (a.tma && tid == 0) {   // the first slots, before the wait: weights only
    for (int s = 0; s < a.slots; ++s) mbar_init(smem_u32(bars + s), 1);
    mbar_init_fence();
    for (int j = 0; j < a.slots && j < nbox; ++j) {
      mbar_expect(smem_u32(bars + j), box_bytes);
      tma_2d_hint(smem_u32(ring + (size_t)j * a.slot_bytes), &a.map, smem_u32(bars + j),
                  tile * a.twb, kb + j * a.br, evict_first_policy());
    }
  }
  grid_dependency_wait();   // x (and the output's memory) belong to the kernel before

  // the epilogue's first scale, asked for with the first rows of x
  const int i0 = rank + a.split * tid;
  const float sc0 = a.scale && i0 < a.rows * tw && c0 + i0 % tw < a.N ? a.scale[c0 + i0 % tw] : 1.f;
  const BoxLanes bl(a.twb);
  float acc[R][V];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < V; ++j) acc[r][j] = 0.f;
  }
  for (int s0 = 0; s0 < a.kc; s0 += a.seg) {
    __syncthreads();   // the last segment's rows of x are read
    for (int i = tid; i < R * a.seg; i += kRingThreads) {
      const int r = i / a.seg, k = kb + s0 + i % a.seg;
      xs[i] = r < a.rows && k < a.K && s0 + i % a.seg < a.kc ? round_bf16(a.x[(size_t)r * a.K + k])
                                                             : 0.f;
    }
    __syncthreads();
    // the segment's boxes a ring-full at a time: wait (or copy) and multiply,
    // then one barrier frees their slots and thread 0 refills them
    const int j_end = min(nbox, (s0 + a.seg) / a.br);
    for (int j0 = s0 / a.br; j0 < j_end; j0 += a.slots) {
      const int jn = min(j_end, j0 + a.slots);
      for (int j = j0; j < jn; ++j) {
        const int slot = j % a.slots;
        if (a.tma) mbar_wait_bounded(smem_u32(bars + slot), (uint32_t)(j / a.slots) & 1u);
        else copy_box<W>(a, c0, kb + j * a.br, ring + (size_t)slot * a.slot_bytes);
      }
      if (!a.tma) __syncthreads();
      boxes_fma<W, R>(ring, a.slot_bytes, a.slots, j0 % a.slots, jn - j0, a.twb, a.br,
                      xs + (j0 * a.br - s0), a.seg, bl, acc);
      __syncthreads();   // the slots are read
      if (a.tma && tid == 0) {
        for (int j = j0; j < jn && j + a.slots < nbox; ++j) {
          const int slot = j % a.slots;
          mbar_expect(smem_u32(bars + slot), box_bytes);
          tma_2d_hint(smem_u32(ring + (size_t)slot * a.slot_bytes), &a.map, smem_u32(bars + slot),
                      tile * a.twb, kb + (j + a.slots) * a.br, evict_first_policy());
        }
      }
    }
  }
  launch_dependents();   // the next launch may start streaming its weights

  const int stride = (a.rows * tw + a.split - 1) / a.split;
  tile_sums<W, R>(acc, bl, tw, 0, a.rows, red, recv, a.split, rank, stride);
  if (a.split > 1) cluster_sync();   // every rank's sums are pushed
  else __syncthreads();
  // this rank's share of the tile: element i = rank, rank + split, ...
  for (int i = i0; i < a.rows * tw; i += a.split * kRingThreads) {
    const int r = i / tw, c = c0 + i % tw;
    const float v = rank_sum(recv, i / a.split, a.split, stride);
    if (c < a.N) a.out[(size_t)r * a.N + c] = v * (i == i0 ? sc0 : a.scale ? a.scale[c] : 1.f);
  }
}

template <typename W, int R>
int launch_qmatmul_r(QmmArgs& a, int pdl, cudaStream_t stream) {
  const int tw = a.twb / (int)sizeof(W);
  const size_t smem = (size_t)a.slots * a.slot_bytes + 4ull * R * a.seg +
                      4ull * kRingWarps * R * tw + 4ull * (R * tw + 8) + 8ull * a.slots;
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  static bool sized = false;   // the largest dynamic shared memory, once
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        qmatmul_kernel<W, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const int tiles = (a.N * (int)sizeof(W) + a.twb - 1) / a.twb;
  cudaLaunchAttribute attrs[2];
  int n = 0;
  if (a.split > 1) {
    attrs[n].id = cudaLaunchAttributeClusterDimension;
    attrs[n].val.clusterDim.x = (unsigned)a.split;
    attrs[n].val.clusterDim.y = 1;
    attrs[n].val.clusterDim.z = 1;
    ++n;
  }
  if (pdl) {
    attrs[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attrs[n].val.programmaticStreamSerializationAllowed = 1;
    ++n;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * a.split));
  cfg.blockDim = dim3(kRingThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attrs;
  cfg.numAttrs = (unsigned)n;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, qmatmul_kernel<W, R>, a);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <typename W>
int launch_qmatmul(const void* x, const void* w, const void* scale, void* out, int rows, int K,
                   int N, int twb, int split, int kc, int br, int pdl, void* stream) {
  if (rows < 1 || rows > 8 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  if ((twb != 16 && twb != 32 && twb != 64 && twb != 128) || twb < (int)sizeof(W) * 4)
    return (int)cudaErrorInvalidValue;
  if ((split != 1 && split != 2 && split != 4 && split != 8) || kc < 8 || kc % 8 ||
      (long long)kc * (split - 1) >= K || (long long)kc * split < K)
    return (int)cudaErrorInvalidValue;
  if (br < 1 || br > 256 || kc % br || twb * br > 16384) return (int)cudaErrorInvalidValue;
  QmmArgs a = {};
  a.x = (const float*)x;
  a.w = w;
  a.scale = (const float*)scale;
  a.out = (float*)out;
  a.rows = rows; a.K = K; a.N = N;
  a.twb = twb; a.split = split; a.kc = kc; a.br = br;
  const long long row_bytes = (long long)N * sizeof(W);
  a.tma = row_bytes % 16 == 0 && (uintptr_t)w % 16 == 0;
  a.slot_bytes = (twb * br + 127) / 128 * 128;
  const int nbox = kc / br;
  a.slots = a.tma ? std::min(std::min(nbox, kQmmMaxSlots), std::max(1, kQmmRingBytes / a.slot_bytes))
                   : 1;
  a.seg = std::min(kc, std::max(br, kQmmXsRows / br * br));
  if (a.tma) {
    const int err = map_2d(&a.map, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, row_bytes, K, row_bytes,
                           twb, br, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != 0) return err;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (rows == 1) return launch_qmatmul_r<W, 1>(a, pdl, s);
  if (rows == 2) return launch_qmatmul_r<W, 2>(a, pdl, s);
  if (rows <= 4) return launch_qmatmul_r<W, 4>(a, pdl, s);
  return launch_qmatmul_r<W, 8>(a, pdl, s);
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

// K7. x (rows <= 8, K) f32, w (K, N) row-major, scale (N) f32 or null, out
// (rows, N) f32. The plan (ops/gemv.k7_plan): twb bytes a column tile (16, 32,
// 64 or 128), split CTAs a cluster (1, 2, 4, 8) over chunks of kc rows of K (a
// multiple of 8; split - 1 chunks fall short of K, split chunks do not), boxes
// of br rows (br divides kc, br <= 256, twb * br <= 16384). pdl: launch with
// programmatic stream serialization (w and scale must not be written by the
// kernel launched just before on the stream).
int cluster_qmatmul_i8(const void* x, const void* w, const void* scale, void* out, int rows,
                       int K, int N, int twb, int split, int kc, int br, int pdl, void* stream) {
  return launch_qmatmul<int8_t>(x, w, scale, out, rows, K, N, twb, split, kc, br, pdl, stream);
}
int cluster_qmatmul_bf16(const void* x, const void* w, const void* scale, void* out, int rows,
                         int K, int N, int twb, int split, int kc, int br, int pdl, void* stream) {
  return launch_qmatmul<bf16>(x, w, scale, out, rows, K, N, twb, split, kc, br, pdl, stream);
}
int cluster_qmatmul_f32(const void* x, const void* w, const void* scale, void* out, int rows,
                        int K, int N, int twb, int split, int kc, int br, int pdl, void* stream) {
  return launch_qmatmul<float>(x, w, scale, out, rows, K, N, twb, split, kc, br, pdl, stream);
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
