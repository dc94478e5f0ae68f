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
// K10. One launch of clusters of 1-8 CTAs, at most one CTA an SM
// (ops/gemv.k10_plan, from D and H only): cluster c owns hc hidden units, its
// rank r rows [r kc, (r + 1) kc) of w1 (kc = D / split) and the same columns of
// w2 and of the output. A CTA asks TMA for all of its weight bytes at its start
// (w1: kc rows of the chunk's hc-byte column slab, before griddepcontrol.wait,
// so that under programmatic dependent launch they stream while the kernel
// before ends; w2: the chunk's hc rows restricted to its kc columns, right
// after it has asked for x, which an SM's queue would otherwise hold behind
// them), every box with its own mbarrier. The first product runs box by box as
// they land; the CTA's (R, hc) sums go to every rank of the cluster over
// distributed shared memory, and after one cluster barrier each rank adds them
// in rank order, applies s1, b1 and gelu_tanh and rounds to bf16: every rank
// holds the same hidden. The second product, (R, hc) by the resident w2 boxes,
// leaves the cluster's partial of the rank's kc output columns in a workspace.
// The warps' sums lie swizzled in shared memory (weight_ring.cuh, kSwz): at a
// 256-byte tile the unswizzled layout put 16 lanes of a store on one bank. The
// sum over the clusters is in the same launch: each CTA draws one ticket per
// group of 16 columns (an acquire-release atomic after a CTA barrier); the CTA
// that draws a group's last ticket reads the group's partials by TMA (a 3-D
// box: 16 columns, every row, the clusters), adds them in cluster order,
// scales, adds b2, stores and resets the ticket. No grid barrier, no second
// launch. The order of every sum follows from (D, H) only, so a row's result
// does not depend on the rows that ride with it, and two runs give the same
// bits. tools/torch_k10_phases.py times the phases (a -DK10_PROBE build).
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
constexpr int kMlpGroup = 16;   // output columns a ticket covers

#ifdef K10_PROBE   // tools/torch_k10_phases.py: a CTA's globaltimer (ns) at the end of each phase
constexpr int kProbeSlots = 16;   // 15 phases, then the column groups the CTA added
__device__ long long k10_stamps[1024 * kProbeSlots];
#define K10_STAMP(slot, value)                                                  \
  if (threadIdx.x == 0 && blockIdx.x < 1024) k10_stamps[blockIdx.x * kProbeSlots + (slot)] = (value)
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define K10_PHASE(slot) \
  do {                  \
    __syncthreads();    \
    K10_STAMP(slot, global_ns()); \
  } while (0)
#else
#define K10_STAMP(slot, value)
#define K10_PHASE(slot)
#endif

// *p += v at gpu scope with release and acquire semantics; returns the old *p
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], %2;" : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// 16 bytes from device memory (through L2) to shared memory, asynchronously
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void copies_wait() { asm volatile("cp.async.wait_all;" ::: "memory"); }

// The plan (ops/gemv.k10_plan): cluster c owns hidden units [c hc, (c + 1) hc);
// its rank r owns rows [r kc, (r + 1) kc) of w1 (kc = D / split) and the same
// columns of w2 and of the output. w1 comes in nb1 boxes of (br1 rows, hc
// bytes), w2 in nt2 column tiles of twb2 bytes, each nb2 boxes of (br2 rows,
// twb2 bytes), every box in its own slot with its own mbarrier.
struct MlpArgs {
  CUtensorMap map1;        // w1 as (D rows, H bytes), UINT8, box (hc, br1)
  CUtensorMap map2;        // w2 as (H rows, D bytes), UINT8, box (twb2, br2)
  const float* x;          // (rows, D)
  const float *s1, *b1;    // (H)
  const float *s2, *b2;    // (D)
  float* out;              // (rows, D)
  float* part;             // (clusters, rows, D): each cluster's second product
  int* tickets;            // (D / kMlpGroup), zero between launches
  CUtensorMap map3;        // part as (clusters, rows, D) f32, box (16 columns, rows, cq clusters)
  int rows, D, H;
  int hc, split, kc, br1, twb2, br2;
  int nb1, nt2, nb2, slot1, slot2, a_bytes;
  int cq;                  // clusters a box of partials spans
};

// Shared memory of a K10 CTA, as qmlp_kernel<R> lays it out:
//   A: w1's boxes, then x (R, kc) f32; once both are read, the warps' sums
//      (kRingWarps, R, hc or twb2) f32 | w2's boxes | recv (split, R, hc) f32:
//      every rank's sums of the first product | hs (R, hc) f32: the hidden
//   mbarriers (one a box, one for the partials) | the count and list of the
//   column groups the CTA adds | s2 and b2 of the rank's kc columns (2, kc) f32.
// At the end everything before the mbarriers holds the running sums of the
// groups the CTA adds and a box of partials a group (cq clusters: as many as
// fit, one at least).
inline size_t up16(size_t v) { return (v + 15) / 16 * 16; }

inline size_t mlp_layout(MlpArgs& a, int R) {
  const auto up = [](size_t v) { return (v + 127) / 128 * 128; };
  a.kc = a.D / a.split;
  a.nb1 = a.kc / a.br1;
  a.nt2 = a.kc / a.twb2;
  a.nb2 = a.hc / a.br2;
  a.slot1 = (int)up((size_t)a.br1 * a.hc);
  a.slot2 = (int)up((size_t)a.br2 * a.twb2);
  const size_t staged = (size_t)a.nb1 * a.slot1 + 4ull * R * a.kc;
  const size_t red = 4ull * kRingWarps * R * std::max(a.hc, a.twb2);
  const size_t rest = (size_t)a.nt2 * a.nb2 * a.slot2 + 4ull * (a.split + 1) * R * a.hc;
  // the final sums: running sums of every column of the rank's share, and a box
  // of one cluster's partials a column group at least
  const size_t sums = up(4ull * R * a.kc) + (a.kc / kMlpGroup) * up(4ull * kMlpGroup * R);
  a.a_bytes = (int)up(std::max(std::max(staged, red), sums > rest ? sums - rest : 0));
  const size_t before_bars = (size_t)a.a_bytes + rest;
  const int clusters = a.H / a.hc;
  for (a.cq = std::min(clusters, 256); a.cq > 1; --a.cq)
    if (up(4ull * a.rows * a.kc) + (a.kc / kMlpGroup) * up(4ull * kMlpGroup * a.rows * a.cq) <=
        before_bars)
      break;
  return before_bars + 8ull * ((a.nb1 + a.nt2 * a.nb2 + 2) & ~1) +
         up16(4ull * (a.kc / kMlpGroup + 1)) + 8ull * a.kc;
}

// The partials of this CTA's nm column groups (groups[]), cq clusters at a
// time: one TMA box a group (16 columns, every row, cq clusters) into shared
// memory, added in cluster order to running sums; then scaled, biased, stored.
__device__ __forceinline__ void add_groups(const MlpArgs& a, int nm, const int* groups,
                                           int clusters, int k0, unsigned char* smem,
                                           uint64_t* done, const float* sb2) {
  const int tid = threadIdx.x;
  const int n4 = a.rows * nm * 4;   // 4 adjacent columns: row e / (4 nm), group e / 4 % nm
  const int blk = (a.cq * a.rows * kMlpGroup + 31) / 32 * 32;   // floats a box takes
  float4* sums = reinterpret_cast<float4*>(smem);
  const float* stage = reinterpret_cast<const float*>(smem) + (4 * n4 + 31) / 32 * 32;
  for (int e = tid; e < n4; e += kRingThreads) sums[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int q0 = 0, n = 0; q0 < clusters; q0 += a.cq, ++n) {
    if (tid < 32) {
      // the partials were written by other CTAs (acquired with the tickets) and
      // the shared memory by this one's threads: both before the async proxy's copies
      asm volatile("fence.proxy.async;" ::: "memory");
      if (tid == 0) mbar_expect(smem_u32(done), nm * a.cq * a.rows * kMlpGroup * 4);
      __syncwarp();
      for (int m = tid; m < nm; m += 32)
        tma_tile(smem_u32(stage + m * blk), &a.map3, smem_u32(done), k0 + groups[m] * kMlpGroup, 0,
                 q0);
    }
    mbar_wait_bounded(smem_u32(done), (uint32_t)n & 1u);
    K10_STAMP(12, global_ns());   // the partials landed
    const int nq = min(a.cq, clusters - q0);
    for (int e = tid; e < n4; e += kRingThreads) {
      const float4* p = reinterpret_cast<const float4*>(stage + e / 4 % nm * blk +
                                                        e / (4 * nm) * kMlpGroup) + e % 4;
      float4 s = sums[e];
      for (int j0 = 0; j0 < nq; j0 += 8) {   // eight loads in flight, then their adds in order
        float4 v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (j0 + u < nq) v[u] = p[(j0 + u) * a.rows * 4];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (j0 + u < nq) {
            s.x += v[u].x; s.y += v[u].y; s.z += v[u].z; s.w += v[u].w;
          }
      }
      sums[e] = s;
    }
    __syncthreads();   // the boxes are read before the next ones land
    K10_STAMP(13, global_ns());   // the partials added
  }
  for (int e = tid; e < n4; e += kRingThreads) {
    const int c = groups[e / 4 % nm] * kMlpGroup + e % 4 * 4;   // of the rank's kc columns
    const float4 s = sums[e], sc = *reinterpret_cast<const float4*>(sb2 + c),
                 bs = *reinterpret_cast<const float4*>(sb2 + a.kc + c);
    *reinterpret_cast<float4*>(a.out + (size_t)(e / (4 * nm)) * a.D + k0 + c) =
        make_float4(__fadd_rn(__fmul_rn(s.x, sc.x), bs.x), __fadd_rn(__fmul_rn(s.y, sc.y), bs.y),
                    __fadd_rn(__fmul_rn(s.z, sc.z), bs.z), __fadd_rn(__fmul_rn(s.w, sc.w), bs.w));
  }
  K10_PHASE(14);   // the groups stored
}

template <int R>
__global__ void __launch_bounds__(kRingThreads)
qmlp_kernel(const __grid_constant__ MlpArgs a) {
  constexpr int V = Vec<int8_t>::n;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  unsigned char* w1s = smem;
  float* xs = reinterpret_cast<float*>(smem + (size_t)a.nb1 * a.slot1);
  float* red = reinterpret_cast<float*>(smem);
  unsigned char* w2s = smem + a.a_bytes;
  const int nbox = a.nb1 + a.nt2 * a.nb2;
  float* recv = reinterpret_cast<float*>(w2s + (size_t)a.nt2 * a.nb2 * a.slot2);
  float* hs = recv + a.split * R * a.hc;
  uint64_t* bars = reinterpret_cast<uint64_t*>(hs + R * a.hc);
  int* mine = reinterpret_cast<int*>(bars + ((nbox + 2) & ~1));   // a count, then groups
  float* sb2 = reinterpret_cast<float*>(mine + (a.kc / kMlpGroup + 4) / 4 * 4);
  const int rank = a.split > 1 ? (int)cluster_rank() : 0;
  const int chunk = blockIdx.x / a.split, clusters = gridDim.x / a.split;
  const int h0 = chunk * a.hc, k0 = rank * a.kc;

  K10_STAMP(0, global_ns());
  if (a.split > 1) cluster_arrive_relaxed();
  if (tid == 0) {
    for (int b = 0; b <= nbox; ++b) mbar_init(smem_u32(bars + b), 1);
    mbar_init_fence();
  }
  __syncthreads();
  // Every weight byte of the CTA asked for at once, lane 0 of warp w asking
  // for boxes w, w + 8, ...: w1's before the wait (the weights never depend on
  // the kernel before), w2's just after x's loads, so that x does not queue
  // behind them.
  const uint64_t policy = evict_first_policy();
  const auto ask = [&](int b0, int b1) {
    for (int b = b0 + warp; b < b1 && lane == 0; b += kRingWarps) {
      const uint32_t bar = smem_u32(bars + b);
      if (b < a.nb1) {
        mbar_expect(bar, a.br1 * a.hc);
        tma_2d_hint(smem_u32(w1s + (size_t)b * a.slot1), &a.map1, bar, h0, k0 + b * a.br1, policy);
      } else {
        const int j = b - a.nb1, t = j / a.nb2, i = j % a.nb2;
        mbar_expect(bar, a.br2 * a.twb2);
        tma_2d_hint(smem_u32(w2s + (size_t)j * a.slot2), &a.map2, bar, k0 + t * a.twb2,
                    h0 + i * a.br2, policy);
      }
    }
  };
  ask(0, a.nb1);
  grid_dependency_wait();   // x, the scales and biases belong to the kernel before

  const int hcol = tid % a.hc;   // hc divides 256: the hidden unit this thread finishes
  const float s1v = a.s1[h0 + hcol], b1v = a.b1[h0 + hcol];
  for (int i = 4 * tid; i < 2 * a.kc; i += 4 * kRingThreads)   // needed at the end only
    copy16_async(sb2 + i, i < a.kc ? a.s2 + k0 + i : a.b2 + k0 + i - a.kc);
  // this rank's chunk of x as bf16, four 16-byte loads in flight a thread
  for (int base = 0; base < R * a.kc / 4; base += 4 * kRingThreads) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = 4 * (base + u * kRingThreads + tid), r = e / a.kc;
      v[u] = e < R * a.kc && r < a.rows
                 ? *reinterpret_cast<const float4*>(a.x + (size_t)r * a.D + k0 + e % a.kc)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (base == 0) ask(a.nb1, nbox);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = 4 * (base + u * kRingThreads + tid);
      if (e < R * a.kc)
        *reinterpret_cast<float4*>(xs + e) = make_float4(round_bf16(v[u].x), round_bf16(v[u].y),
                                                         round_bf16(v[u].z), round_bf16(v[u].w));
    }
  }
  __syncthreads();
  K10_STAMP(1, global_ns());   // the weights asked for, the wait over, x staged

  float acc[R][V];
  {   // first product, box by box as they land: (R, kc) . (kc, hc)
    const BoxLanes bl(a.hc);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[r][e] = 0.f;
    for (int j = 0; j < a.nb1; ++j) {
      mbar_wait_bounded(smem_u32(bars + j), 0u);
      boxes_fma<int8_t, R>(w1s, a.slot1, a.nb1, j, 1, a.hc, a.br1, xs + j * a.br1, a.kc, bl, acc);
    }
    __syncthreads();   // w1's boxes and x are read: the warps' sums take their place
    K10_STAMP(2, global_ns());   // w1's boxes landed and multiplied
    warp_sums<int8_t, R, true>(acc, bl, a.hc, red);
    __syncthreads();
    K10_STAMP(10, global_ns());   // the first product's warp sums
  }
  // The CTA's (R, hc) sums to every rank of the cluster, recv[rank][r][c]:
  // each rank adds them in rank order, so every rank holds the same hidden.
  if (a.split > 1) cluster_wait();   // every CTA of the cluster has started
  for (int e0 = 32 * warp; e0 < R * a.hc; e0 += kRingThreads) {   // R hc is a multiple of 16
    const int e = e0 + lane;
    const float v = e < R * a.hc ? warps_sum<R, true>(red, e / a.hc, e % a.hc, a.hc) : 0.f;
    // lanes 4 j .. 4 j + 3 hold four adjacent sums: lane 4 j stores them at once
    const float4 v4 = make_float4(v, __shfl_down_sync(0xffffffffu, v, 1),
                                  __shfl_down_sync(0xffffffffu, v, 2),
                                  __shfl_down_sync(0xffffffffu, v, 3));
    float* dst = recv + rank * R * a.hc + e;
    if (e < R * a.hc && lane % 4 == 0) {
      if (a.split == 1) *reinterpret_cast<float4*>(dst) = v4;
      else
        for (int q = 0; q < a.split; ++q) st_cluster_v4(cluster_addr(smem_u32(dst), (uint32_t)q), v4);
    }
  }
  K10_PHASE(3);   // the sums pushed
  if (a.split > 1) cluster_sync();
  else __syncthreads();
  K10_STAMP(4, global_ns());   // the sums exchanged
  for (int i0 = tid; i0 < R * a.hc; i0 += 4 * kRingThreads) {   // four chains in flight
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    for (int q = 0; q < a.split; ++q)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u * kRingThreads < R * a.hc) t[u] += recv[q * R * a.hc + i0 + u * kRingThreads];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i0 + u * kRingThreads < R * a.hc)
        hs[i0 + u * kRingThreads] = round_bf16(gelu_tanh(__fadd_rn(__fmul_rn(t[u], s1v), b1v)));
  }
  __syncthreads();
  K10_STAMP(5, global_ns());   // the hidden

  {   // second product, a column tile at a time: (R, hc) . (hc, twb2)
    const BoxLanes bl(a.twb2);
    for (int t = 0; t < a.nt2; ++t) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[r][e] = 0.f;
      // the tile's boxes landed while the first product ran: all of them at once
      for (int i = 0; i < a.nb2; ++i) mbar_wait_bounded(smem_u32(bars + a.nb1 + t * a.nb2 + i), 0u);
      boxes_fma<int8_t, R>(w2s + (size_t)t * a.nb2 * a.slot2, a.slot2, a.nb2, 0, a.nb2, a.twb2,
                           a.br2, hs, a.hc, bl, acc);
      if (t == a.nt2 - 1) {
        launch_dependents();   // the next launch may ask for its weights
        K10_PHASE(6);   // the second product
      }
      warp_sums<int8_t, R, true>(acc, bl, a.twb2, red);
      __syncthreads();
      K10_STAMP(11, global_ns());   // the second product's warp sums
      for (int i = tid; i < a.rows * a.twb2; i += kRingThreads) {
        const int r = i / a.twb2, c = k0 + t * a.twb2 + i % a.twb2;
        a.part[((size_t)chunk * a.rows + r) * a.D + c] =
            warps_sum<R, true>(red, r, i % a.twb2, a.twb2);
      }
      __syncthreads();   // red is read
    }
  }

  // The sum over the clusters: the CTA that draws a column group's last ticket
  // adds the group's partials in cluster order, scales, adds the bias and
  // stores, and puts the ticket back to zero. A ticket is drawn by one thread
  // after the barrier, with release (every partial of the CTA, ordered before
  // it by the barrier, visible first) and acquire (the partials of the CTAs
  // that drew before it visible after).
  K10_STAMP(7, global_ns());   // the partials written
  const int ng = a.kc / kMlpGroup, g0 = k0 / kMlpGroup;
  int* groups = mine + 1;
  for (int g = tid; g < ng; g += kRingThreads) {
    const bool last = atomic_add_acq_rel(a.tickets + g0 + g, 1) == clusters - 1;
    if (last) a.tickets[g0 + g] = 0;
    groups[g] = last;
  }
  __syncthreads();
  K10_STAMP(8, global_ns());   // the tickets drawn
  if (warp == 0) {   // the groups this CTA adds, listed in order
    int n = 0;
    for (int g0w = 0; g0w < ng; g0w += 32) {
      const bool last = g0w + lane < ng && groups[g0w + lane];
      const uint32_t ballot = __ballot_sync(0xffffffffu, last);
      __syncwarp();
      if (last) groups[n + __popc(ballot & ((1u << lane) - 1u))] = g0w + lane;
      n += __popc(ballot);
      __syncwarp();
    }
    if (lane == 0) mine[0] = n;
  }
  __syncthreads();
  const int nm = mine[0];
  K10_STAMP(15, nm);
  copies_wait();   // s2 and b2
  __syncthreads();
  if (nm > 0) add_groups(a, nm, mine + 1, clusters, k0, smem, bars + nbox, sb2);
  K10_PHASE(9);   // the groups added
}

// The workspace of partials as a 3-D f32 map (D columns, rows, clusters), read
// in boxes of 16 columns, every row and cq clusters.
inline int map_partials(CUtensorMap* map, const float* part, int D, int rows, int clusters,
                        int cq) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(part) % 16) return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)clusters};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 4, (cuuint64_t)rows * D * 4};
  const cuuint32_t box[3] = {(cuuint32_t)kMlpGroup, (cuuint32_t)rows, (cuuint32_t)cq};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(part), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// split > 1 (or `cluster`: the occupancy query needs one): a cluster of split CTAs
template <int R>
cudaLaunchConfig_t mlp_config(MlpArgs& a, int pdl, cudaStream_t stream, cudaLaunchAttribute* attrs,
                              bool cluster) {
  cudaLaunchConfig_t cfg = {};
  int n = 0;
  if (a.split > 1 || cluster) {
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
  cfg.gridDim = dim3((unsigned)(a.H / a.hc * a.split));
  cfg.blockDim = dim3(kRingThreads);
  cfg.dynamicSmemBytes = mlp_layout(a, R);
  cfg.stream = stream;
  cfg.attrs = attrs;
  cfg.numAttrs = (unsigned)n;
  return cfg;
}

// launch (clusters == null) or count the clusters an H100 holds at once
template <int R>
int launch_qmlp_r(MlpArgs& a, int pdl, cudaStream_t stream, int* clusters) {
  cudaLaunchAttribute attrs[2];
  const cudaLaunchConfig_t cfg = mlp_config<R>(a, pdl, stream, attrs, clusters != nullptr);
  if (cfg.dynamicSmemBytes > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        qmlp_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  if (clusters != nullptr) return (int)cudaOccupancyMaxActiveClusters(clusters, qmlp_kernel<R>, &cfg);
  const int map_err = map_partials(&a.map3, a.part, a.D, a.rows, a.H / a.hc, a.cq);
  if (map_err != 0) return map_err;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, qmlp_kernel<R>, a);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

inline bool pow2_in(int v, int lo, int hi) { return v >= lo && v <= hi && (v & (v - 1)) == 0; }

// the plan's fields of a, or an error for a plan the kernel does not take
int mlp_plan(MlpArgs& a, int rows, int D, int H, int hc, int split, int br1, int twb2, int br2) {
  if (rows < 1 || rows > 8 || D < 16 || H < 16) return (int)cudaErrorInvalidValue;
  if (!pow2_in(hc, 16, 256) || H % hc || split < 1 || split > 8 || D % split ||
      (D / split) % kMlpGroup)
    return (int)cudaErrorInvalidValue;
  const int kc = D / split;
  if (br1 < 1 || br1 > 256 || kc % br1 || !pow2_in(twb2, 16, 256) || kc % twb2 || br2 < 1 ||
      br2 > 256 || hc % br2)
    return (int)cudaErrorInvalidValue;
  a.rows = rows; a.D = D; a.H = H;
  a.hc = hc; a.split = split; a.br1 = br1; a.twb2 = twb2; a.br2 = br2;
  return 0;
}

int launch_qmlp(MlpArgs& a, int pdl, cudaStream_t stream, int* clusters) {
  if (a.rows == 1) return launch_qmlp_r<1>(a, pdl, stream, clusters);
  if (a.rows == 2) return launch_qmlp_r<2>(a, pdl, stream, clusters);
  if (a.rows <= 4) return launch_qmlp_r<4>(a, pdl, stream, clusters);
  return launch_qmlp_r<8>(a, pdl, stream, clusters);
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

// K10. x (rows <= 8, D) f32; w1 (D, H), w2 (H, D) int8 row-major, 16-byte
// aligned; s1, b1 (H), s2, b2 (D) f32; out (rows, D) f32. The plan
// (ops/gemv.k10_plan): hc hidden units a cluster (16 to 256, a power of two
// dividing H), split CTAs a cluster (1 to 8, D / split a multiple of 16), w1
// boxes of br1 rows (dividing D / split), w2 column tiles of twb2 bytes (16 to
// 256, a power of two dividing D / split) in boxes of br2 rows (dividing hc).
// part: (H / hc) * rows * D floats; tickets: D / 16 ints, zero (each launch
// leaves them so). pdl: launch with programmatic stream serialization (w1 and
// w2 must not be written by the kernel launched just before on the stream).
int fused_qmlp_i8(const void* x, const void* w1, const void* s1, const void* b1, const void* w2,
                  const void* s2, const void* b2, void* out, void* part, void* tickets, int rows,
                  int D, int H, int hc, int split, int br1, int twb2, int br2, int pdl,
                  void* stream) {
  MlpArgs a = {};
  int err = mlp_plan(a, rows, D, H, hc, split, br1, twb2, br2);
  if (err != 0) return err;
  if ((uintptr_t)w1 % 16 || (uintptr_t)w2 % 16) return (int)cudaErrorInvalidValue;
  a.x = (const float*)x;
  a.s1 = (const float*)s1; a.b1 = (const float*)b1;
  a.s2 = (const float*)s2; a.b2 = (const float*)b2;
  a.out = (float*)out;
  a.part = (float*)part;
  a.tickets = (int*)tickets;
  err = map_2d(&a.map1, w1, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, H, D, H, hc, br1,
               CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  err = map_2d(&a.map2, w2, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, D, H, D, twb2, br2,
               CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  return launch_qmlp(a, pdl, (cudaStream_t)stream, nullptr);
}

// How many of fused_qmlp_i8's clusters the card holds at once for this plan
// and rows (cudaOccupancyMaxActiveClusters), into *clusters. Launches nothing.
int fused_qmlp_clusters(int rows, int D, int H, int hc, int split, int br1, int twb2, int br2,
                        void* clusters) {
  MlpArgs a = {};
  const int err = mlp_plan(a, rows, D, H, hc, split, br1, twb2, br2);
  return err != 0 ? err : launch_qmlp(a, 0, nullptr, (int*)clusters);
}

#ifdef K10_PROBE
// the probe's stamps of the last launch: n values of k10_stamps into host memory
int fused_qmlp_stamps(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, k10_stamps, (size_t)n * sizeof(long long));
}
#endif

}  // extern "C"
