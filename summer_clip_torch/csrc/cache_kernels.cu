// Cache attention: out[b, q, c] = sum_n w_b[q, n] * V[n, c],
// w_b = bf16(exp(-beta_b * (1 - F[q] . C[n]))), affinity accumulated in f32.
// V is a value matrix (K1) or one_hot(labels), never built (K2, K3, K13).
//
// Replaces the TPU kernels of summer_clip_tpu/ops/cache_kernels.py:
//   K1 cache_attention     -> cache_dense   (bf16 or int8 value matrix)
//   K2 labels_dense_pallas -> grouped_kernel<kRowSum> (any row order)
//   K3 onehot_pallas       -> grouped_kernel<kRowSum> (class-grouped rows)
// and of tools/sweep_onehot_variants.py:
//   K13 onehot_variant     -> grouped_kernel<expand mode> (K3's sum with the
//                             class partials of each block_n-row cache block
//                             formed apart, then added as the mode says)
//
// K2, K3 and K13 are one class-grouped template. The label kernels compute
// sum_n bf16(exp(-beta (1 - a_qn))) [label_n = c]: per (query, cache row) one
// affinity of D products and, per beta, one exponential. What bounds them on
// the H100:
//   - the exponentials: one expf (one MUFU.EX2) per (query, row, beta), 16 a
//     clock an SM, about 4.2e12 a second on 132 SMs at 1.98 GHz (0.50 ms at
//     Nt = 8192, Nc = 16000, 16 betas; 1.54 ms at K13's Nt = 50176, 8
//     betas). With the argument, the bf16 rounding and the add a weight takes
//     about 13 instructions, so the issue rate binds first (weight_rate_probe
//     below measures what a loop of nothing but weights reaches);
//   - the L2 intake of the affinity: a block of 64 resident queries takes in
//     2 D / 64 bytes a (query, row) of cache rows, and the SMs take in about
//     4 TB/s together (PERF.md): 6.4 ms at K13's shape (D = 1024).
// What the design does about each:
//   - the affinity is computed once per (query, row) for every beta of the
//     launch (up to 16) by wgmma.m64n128k16 from shared memory: a block keeps
//     its 64 queries resident (TMA, 128-byte swizzle) and walks 128-row tiles
//     of the cache in class order through a TMA ring over D;
//   - the rows reach the block in class order: the wrapper sorts the labels on
//     the host (stably: rows of a class keep their order) and gathers the
//     (Nc, D) bf16 rows once on the device into that order (Nc x D x 2 bytes
//     more device memory, 2.6 GB at the sweep tool's full cache), so a tile is
//     one TMA box. K2 takes the same order: its any-row-order contract costs a
//     host sort, not a dense product over all classes;
//   - two roles, so that neither waits on the other's work: warpgroup 0
//     issues the loads and the products and writes each affinity tile (f32)
//     into one of two shared buffers; warpgroups 1 and 2 walk them. A walking
//     thread takes one query and up to 4 betas (4 threads a query), weighs a
//     batch of 8 rows at once (independent exponentials) and adds the bf16
//     weights into f32 class sums in registers in row order. Segment
//     boundaries (a new class; for K13 also a new block_n block) are the same
//     for every query, so the walk's branches are uniform across the warp.
//     The roles meet only at the buffers' mbarriers;
//   - finished classes wait in registers by 8 and go out as two 16-byte
//     stores a (beta, query): one store a class would cost an L2 transaction
//     for every 4 bytes;
//   - balanced work, the same result on every run: the sorted rows are cut
//     into work items of equal tile counts (grid: query tiles x items), so a
//     one-class cache spreads over many blocks. A class cut by an item
//     boundary leaves a piece record per item in a workspace (the head piece,
//     the expanded complete segments, the open tail piece); a second small
//     kernel adds them in item order, and fills the empty classes with 0. No
//     float atomics.
// K13 forms, per block of block_n cache rows, each class's partial sum and adds
// it to the output column as its mode says: "highest" as it is, "split3" as
// (hi + mid) + lo of its three bf16 parts (exact, so equal to "highest" bit for
// bit), "default" rounded to bf16 once (after all the segment's rows, pieces
// included). No expand matrix is built: each class owns its output column.
// K13's cast_w does not reach the card: the TPU's default-precision product
// takes w as a bf16 operand anyway, so every arm sums the same bf16 weights.
//
// K1: a block owns 16 queries x 256 classes x the 8 betas of a launch: the 8
// weight tiles of one affinity tile are stacked into a 128-row operand, so one
// affinity tile serves all betas of the chunk, and the f32 accumulators
// (128 x 256) fill the registers of two warpgroups. Each class slice
// recomputes the affinity (sharing it would need the (Nt, Nc) affinity in
// device memory, which the TPU kernel never writes either). wgmma on
// TMA-staged operands, weights written from registers as the A operand, V read
// MN-major: see the section below.
// No running maximum: the exponent is <= 0 for normalised rows, and like the
// TPU kernels none of these assumes it (an unnormalised row may overflow to inf
// here exactly as it does there).
//
// Each entry point returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "hopper_common.cuh"   // mbarriers, TMA, wgmma

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBc;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ float cache_weight(float beta, float aff) {
  return __bfloat162float(__float2bfloat16(expf(-beta * (1.0f - aff))));
}
// cache_weight of two affinities at once: the same expf and the same
// round-to-nearest-even to bf16, by one packed conversion
__device__ __forceinline__ void cache_weight2(float beta, float a0, float a1, float& w0,
                                              float& w1) {
  const uint32_t p = pack2(expf(-beta * (1.0f - a0)), expf(-beta * (1.0f - a1)));
  w0 = __uint_as_float(p << 16);
  w1 = __uint_as_float(p & 0xFFFF0000u);
}

// aff tile (16 queries x 16 cache rows) by WMMA, K steps in order: q rows
// row-major (ldq), cache rows row-major (ldc). The affinity probe's reference.
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

// D (64 x 128, f32) (+)= A (64 x 16, bf16, shared, K-major) * B (16 x 128, bf16,
// shared, K-major): S = F C^T with both tiles as TMA wrote them
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate)
      : "memory");
}

// A wait of one role of grouped_kernel on the other, which may last a tile:
// the waiting warp sleeps between tries and leaves its issue slots to the
// warps that work. Like mbar_wait_bounded it traps after about two seconds.
__device__ __forceinline__ void mbar_wait_sleep(uint32_t bar, uint32_t parity) {
  uint32_t done, spins = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    __nanosleep(128);
    if (++spins == (1u << 24)) __trap();
  }
}

constexpr int kRowSum = -1, kHighest = 0, kSplit3 = 1, kDefault = 2;

// what K13's class-sum scatter (small @ expand) adds for one partial; K2 and
// K3 (kRowSum) add it as it is
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

// ---------------------------------------------------------------------------
// K2, K3, K13: block = (64-query tile, work item of 128-row tiles of the
// class-sorted cache), all betas (<= 16) of the launch.
// Host tables (ops/cache_kernels.py grouped_plan):
//   meta (Np,): per sorted row its class, with bit 31 set where a class
//     begins and bit 30 where a segment begins (K13: a class or a block_n
//     block); the padding rows after the last real row form class kNone;
//   items (n_items + 1,): the tiles of each work item;
//   slots (n_items, 2): the workspace slot of the item's head piece (the
//     class it begins inside of) and of its tail piece (the class it ends
//     inside of), -1 where the item boundary is a class boundary;
//   fix_cls, fix_offs: the classes the second kernel writes (cut or empty)
//     and their slots, fix_offs[e] .. fix_offs[e + 1], in item order.
// A piece record is (h, c, o, s): h the sum of the rows before the class's
// first segment boundary in the item (joins the previous item's open
// segment), s whether that segment closed in the item, c the expanded sums of
// the segments that began and ended in the item, o the open tail segment.
// ---------------------------------------------------------------------------
namespace grp {
constexpr int kQ = 64;                   // queries of a block: resident, wgmma's M
constexpr int kR = 128;                  // sorted cache rows of a tile: wgmma's N
constexpr int kMmaThreads = 128;         // warpgroup 0: loads and products
constexpr int kWalkThreads = 256;        // warpgroups 1 and 2: exponentials and sums
constexpr int kThreads = kMmaThreads + kWalkThreads;
constexpr int kBox = 8192;               // 64 rows x 128 bytes: a query box
constexpr int kStage = 2 * kBox;         // a ring stage: 128 cache rows x 64 columns
constexpr int kMaxStages = 16;
constexpr int kMaxAff = 2;               // affinity tiles in flight between the roles
constexpr int kAffLd = kQ + 4;           // aff[row][query] f32: conflict-free stores and reads
constexpr int kAffBytes = kR * kAffLd * 4;
constexpr int kMaxBeta = 16;             // betas a launch
constexpr int kWalkers = kWalkThreads / kQ;   // threads a query in the walk: betas w, w + 4, ..
constexpr int kBatch = 8;                // rows the walk weighs before it adds them
constexpr int kBatches = kR / kBatch;
constexpr int kSmemLimit = 232448;
constexpr int kSegStart = 0x40000000, kClsMask = 0x3FFFFFFF;   // bit 31: a class begins
constexpr int kNone = kClsMask;          // the class field of the padding rows

// shared memory of everything but the ring: the query boxes, the affinity
// tiles with their meta and boundary masks, the barriers
__host__ __device__ constexpr int fixed_bytes(int nd, int naff) {
  return 1024 + nd * kBox + naff * (kAffBytes + kR * 4 + kR / 8) +
         8 * (kMaxStages + 1 + 2 * kMaxAff);
}
}  // namespace grp

// kNbt: betas a walking thread weighs (nb <= 4 kNbt)
template <int kExpand, int kNbt>
__global__ void __launch_bounds__(grp::kThreads, 1)
grouped_kernel(const __grid_constant__ CUtensorMap fmap, const __grid_constant__ CUtensorMap cmap,
               const int* __restrict__ meta, const int* __restrict__ items,
               const int* __restrict__ slots, const float* __restrict__ betas,
               float* __restrict__ out, float4* __restrict__ ws, int nb, int Nt, int Ntp,
               int Dp, int C, int stages, int naff) {
  using namespace grp;
  constexpr bool kPartials = kExpand != kRowSum;
  extern __shared__ unsigned char smem_raw[];
  __shared__ float beta_s[kMaxBeta];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const int nd = (Dp + 63) / 64;                          // 64-column boxes of a row
  const uint32_t q_s = base;                              // nd boxes: 64 queries x 64 columns
  const uint32_t c_s = q_s + nd * kBox;                   // the ring
  // naff affinity tiles (kR x kAffLd f32), their meta and their boundary masks
  float* aff = reinterpret_cast<float*>(gbase + nd * kBox + stages * kStage);
  int* meta_s = reinterpret_cast<int*>(aff + naff * kR * kAffLd);
  uint32_t* bmask = reinterpret_cast<uint32_t*>(meta_s + naff * kR);
  const uint32_t full = smem_u32(bmask + naff * kR / 32), q_full = full + 8 * stages;
  const uint32_t aff_full = q_full + 8, aff_empty = aff_full + 8 * kMaxAff;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kQ, item = blockIdx.y;
  const int tile0 = items[item], ntiles = items[item + 1] - tile0, nslices = ntiles * nd;
  // slice fit: columns 64 (fit % nd) .. of the item's tile fit / nd
  auto load_slice = [&](int fit) {
    const int st = fit % stages;
    mbar_expect(full + 8 * st, kStage);
    tma_2d(c_s + st * kStage, &cmap, full + 8 * st, 64 * (fit % nd), (tile0 + fit / nd) * kR);
  };
  if (tid < kMaxBeta) beta_s[tid] = betas[tid < nb ? tid : nb - 1];
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(full + 8 * s, 1);
    mbar_init(q_full, 1);
    for (int b = 0; b < naff; ++b) {
      mbar_init(aff_full + 8 * b, kMmaThreads);           // every thread that wrote the tile
      mbar_init(aff_empty + 8 * b, kWalkThreads / 32);    // every walking warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect(q_full, nd * kBox);
    for (int d = 0; d < nd; ++d) tma_2d(q_s + d * kBox, &fmap, q_full, 64 * d, q0);
    for (int fit = 0; fit < min(stages, nslices); ++fit) load_slice(fit);
  }
  __syncthreads();

  if (warp < kMmaThreads / 32) {
    // Warpgroup 0: S (64 queries x 128 rows) of each tile by wgmma over the
    // ring, then the tile into aff buffer k % naff once the walkers are done
    // with its previous contents. No other synchronisation with the walkers.
    const int wp = warp, g = lane >> 2, t = lane & 3;
    // the warpgroup's products of a stage are done (a wgmma group completes for
    // the whole warpgroup): its next load goes out at once
    auto release_slice = [&](int fit) {
      if (tid == 0 && fit + stages < nslices) load_slice(fit + stages);
    };
    mbar_wait_bounded(q_full, 0);
    float acc[64];   // the first step overwrites it (no register write while products run)
    for (int k = 0; k < ntiles; ++k) {
      const int m = meta[(tile0 + k) * kR + tid];   // read ahead of the products
      for (int d = 0; d < nd; ++d) {
        const int fit = k * nd + d, st = fit % stages;
        mbar_wait_bounded(full + 8 * st, (fit / stages) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)   // past D the boxes hold TMA's zeros: exact
          wgmma_m64n128k16_ss(acc, sw128_desc(q_s + d * kBox + 32 * kk),
                              sw128_desc(c_s + st * kStage + 32 * kk), (d | kk) != 0);
        wgmma_commit();
        wgmma_wait_n<1>();
        if (d > 0) release_slice(fit - 1);
      }
      wgmma_wait_n<0>();
      keep_n(acc);
      release_slice(k * nd + nd - 1);
      const int b = k % naff;
      if (k >= naff) mbar_wait_sleep(aff_empty + 8 * b, (k / naff - 1) & 1);
      float* ab = aff + b * kR * kAffLd;
#pragma unroll
      for (int j = 0; j < 16; ++j)   // query 16 wp + g + 8 h, cache row 8 j + 2 t + u
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int u = 0; u < 2; ++u)
            ab[(8 * j + 2 * t + u) * kAffLd + 16 * wp + g + 8 * h] = acc[4 * j + 2 * h + u];
      meta_s[b * kR + tid] = m;   // the tile's meta, and a bit for each row where a segment begins
      const uint32_t bits = __ballot_sync(0xffffffffu, m < 0 || (kPartials && (m & kSegStart)));
      if (lane == 0) bmask[b * (kR / 32) + warp] = bits;
      mbar_arrive(aff_full + 8 * b);   // releases this thread's writes to the walkers
    }
    return;
  }

  // Warpgroups 1 and 2: the walk. Thread = (query q0 + wq, betas wb, wb + 4,
  // ..); the state of the class being summed: open (its current segment),
  // cacc (K13: its closed segments, expanded), hfirst (the head piece, once
  // the item's head class has closed its first segment)
  const int wt = tid - kMmaThreads, wq = wt % kQ, wb = wt / kQ;
  const bool qreal = q0 + wq < Nt;
  float bet[kNbt], open[kNbt], cacc[kNbt], hfirst[kNbt];
  int nbt = 0;                            // this thread's betas of the launch (warp-uniform)
#pragma unroll
  for (int i = 0; i < kNbt; ++i) {
    const int b = wb + kWalkers * i;
    bet[i] = beta_s[b < nb ? b : 0];
    if (b < nb) nbt = i + 1;
    open[i] = cacc[i] = hfirst[i] = 0.f;
  }
  const int head_slot = slots[2 * item], tail_slot = slots[2 * item + 1];
  const int m0 = meta[tile0 * kR];
  int cur = m0 < 0 ? kNone : (m0 & kClsMask);             // the class being summed
  bool in_head = m0 >= 0;   // it began in an earlier item (its sum is a piece)
  bool seen = false;        // the head class's first segment has closed
  // finished classes 8 wid .. 8 wid + 7 (those in wmask) wait in registers and
  // go out together: two 16-byte stores where all 8 are there
  float win[kNbt][8];
  int wid = -1;
  uint32_t wmask = 0;
  auto flush = [&]() {
    if (wmask != 0 && qreal) {
#pragma unroll
      for (int i = 0; i < kNbt; ++i) {
        if (i >= nbt) break;
        float* o = out + ((size_t)(wb + kWalkers * i) * Nt + q0 + wq) * C + 8 * wid;
        if (wmask == 0xFFu && (C & 3) == 0) {
          *reinterpret_cast<float4*>(o) =
              make_float4(win[i][0], win[i][1], win[i][2], win[i][3]);
          *reinterpret_cast<float4*>(o + 4) =
              make_float4(win[i][4], win[i][5], win[i][6], win[i][7]);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (wmask >> j & 1) o[j] = win[i][j];
        }
      }
    }
    wmask = 0;
  };
  auto piece = [&](int slot, int i, float4 r) {
    ws[((size_t)slot * kMaxBeta + wb + kWalkers * i) * Ntp + q0 + wq] = r;
  };
  auto close_class = [&]() {
    if (cur != kNone) {
      if (!in_head && cur >> 3 != wid) {
        flush();
        wid = cur >> 3;
      }
#pragma unroll
      for (int i = 0; i < kNbt; ++i) {
        if (i >= nbt) break;
        const float last = expand_partial<kExpand>(open[i]);
        if (in_head) {
          piece(head_slot, i, seen ? make_float4(hfirst[i], cacc[i] + last, 0.f, 1.f)
                                   : make_float4(open[i], 0.f, 0.f, 0.f));
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (j == (cur & 7)) win[i][j] = cacc[i] + last;
        }
      }
      if (!in_head) wmask |= 1u << (cur & 7);
    }
#pragma unroll
    for (int i = 0; i < kNbt; ++i) open[i] = cacc[i] = 0.f;
  };
  auto close_segment = [&]() {   // K13: a block_n block begins inside the class
#pragma unroll
    for (int i = 0; i < kNbt; ++i) {
      if (in_head && !seen)
        hfirst[i] = open[i];
      else
        cacc[i] += expand_partial<kExpand>(open[i]);
      open[i] = 0.f;
    }
    if (in_head) seen = true;
  };
  for (int k = 0; k < ntiles; ++k) {
    const int b = k % naff;
    mbar_wait_sleep(aff_full + 8 * b, (k / naff) & 1);
    const float* ab = aff + b * kR * kAffLd;
    const int* mb = meta_s + b * kR;
    // each batch's weights first (independent: the exponentials overlap),
    // then their sums in row order; at each row where a segment begins (a set
    // bit of the batch's mask) the rows before it are added (the adds of the
    // rows outside the run are predicated off) and the segment or class is
    // closed: one copy of the closing code, whatever the number of boundaries
    for (int bi = 0; bi < kBatches; ++bi) {
      const int rb = kBatch * bi;
      float w[kBatch][kNbt];
#pragma unroll
      for (int j = 0; j < kBatch; j += 2) {
        const float a0 = ab[(rb + j) * kAffLd + wq], a1 = ab[(rb + j + 1) * kAffLd + wq];
#pragma unroll
        for (int i = 0; i < kNbt; ++i) cache_weight2(bet[i], a0, a1, w[j][i], w[j + 1][i]);
      }
      uint32_t bits = (bmask[b * (kR / 32) + (rb >> 5)] >> (rb & 31)) & ((1u << kBatch) - 1);
      int from = 0;   // the batch's rows before `from` are added
      while (bits) {
        const int p = __ffs(bits) - 1;   // a segment begins at row rb + p
        bits &= bits - 1;
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
#pragma unroll
          for (int i = 0; i < kNbt; ++i)
            if (j >= from && j < p) open[i] += w[j][i];
        const int m = mb[rb + p];
        if (m < 0) {   // a class begins: the previous one is done
          close_class();
          cur = m & kClsMask;
          in_head = false;
        } else {       // K13: a block_n block begins inside the class
          close_segment();
        }
        from = p;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
#pragma unroll
        for (int i = 0; i < kNbt; ++i)
          if (j >= from) open[i] += w[j][i];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(aff_empty + 8 * b);
  }
  if (tail_slot >= 0) {   // the class goes on in the next item: its piece
#pragma unroll
    for (int i = 0; i < kNbt; ++i) {
      if (i >= nbt) break;
      piece(tail_slot, i, !in_head ? make_float4(0.f, cacc[i], open[i], 1.f)
                          : seen   ? make_float4(hfirst[i], cacc[i], open[i], 1.f)
                                   : make_float4(open[i], 0.f, 0.f, 0.f));
    }
  } else {
    close_class();
  }
  flush();
}

// The classes cut by an item boundary (their pieces added in item order) and
// the empty classes (no pieces: 0). A thread takes (fix entry e, query q,
// beta blockIdx.z); kByClass: neighbouring threads take neighbouring entries
// of one query (where many classes are empty: their outputs lie side by side),
// else neighbouring queries of one entry.
template <int kExpand, bool kByClass>
__global__ void __launch_bounds__(128)
grouped_fix_kernel(const float4* __restrict__ ws, const int* __restrict__ fix_cls,
                   const int* __restrict__ fix_offs, float* __restrict__ out, int n_fix, int Nt,
                   int Ntp, int C) {
  const int b = blockIdx.z;
  const int e = kByClass ? blockIdx.x * 128 + threadIdx.x : blockIdx.x;
  if (e >= n_fix) return;
  const int s0 = fix_offs[e], s1 = fix_offs[e + 1], c = fix_cls[e];
  for (int q = kByClass ? blockIdx.y : blockIdx.y * 128 + threadIdx.x; q < Nt;
       q += kByClass ? gridDim.y : gridDim.y * 128) {
    float cacc = 0.f, open = 0.f;
    for (int s = s0; s < s1; ++s) {
      const float4 r = ws[((size_t)s * grp::kMaxBeta + b) * Ntp + q];
      open += r.x;
      if (r.w != 0.f) {   // the segment open before the item closed in it
        cacc += expand_partial<kExpand>(open);
        open = 0.f;
      }
      cacc += r.y;
      open += r.z;
    }
    out[((size_t)b * Nt + q) * C + c] = cacc + expand_partial<kExpand>(open);
  }
}

// affinity tiles in flight at padded width Dp: two where they leave the ring
// three stages, else one
int grouped_aff_at(int Dp) {
  const int nd = (Dp + 63) / 64;
  return grp::kSmemLimit - grp::fixed_bytes(nd, 2) >= 3 * grp::kStage ? 2 : 1;
}

// ring stages at padded width Dp (0: Dp does not fit shared memory)
int grouped_stages_at(int Dp) {
  const int st = (grp::kSmemLimit - grp::fixed_bytes((Dp + 63) / 64, grouped_aff_at(Dp))) /
                 grp::kStage;
  return st < 2 ? 0 : (st > grp::kMaxStages ? grp::kMaxStages : st);
}

template <int kExpand, int kNbt>
int launch_grouped_nbt(const void* f, const void* cs, const void* meta, const void* items,
                   const void* slots, const void* fix_cls, const void* fix_offs,
                   const void* betas, void* out, void* ws, int nb, int Nt, int Ntp, int Np,
                   int Dp, int C, int n_items, int n_fix, cudaStream_t stream) {
  using namespace grp;
  if (nb < 1 || nb > kMaxBeta || Ntp % kQ || Ntp < Nt || Np % kR || Dp % 16 || Dp < 16 ||
      n_items < 0 || n_fix < 0 || (n_items > 0 && Np < kR))
    return (int)cudaErrorInvalidValue;
  const int stages = grouped_stages_at(Dp);
  if (stages == 0) return (int)cudaErrorInvalidValue;
  if (n_items > 0) {
    CUtensorMap fm, cm;
    int err;
    if ((err = map_2d(&fm, f, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, Dp, Ntp, 2LL * Dp, 64, kQ,
                      CU_TENSOR_MAP_SWIZZLE_128B)) != 0 ||
        (err = map_2d(&cm, cs, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, Dp, Np, 2LL * Dp, 64, kR,
                      CU_TENSOR_MAP_SWIZZLE_128B)) != 0)
      return err;
    const int naff = grouped_aff_at(Dp);
    const int smem = fixed_bytes((Dp + 63) / 64, naff) + stages * kStage;
    cudaFuncSetAttribute(grouped_kernel<kExpand, kNbt>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    grouped_kernel<kExpand, kNbt><<<dim3(Ntp / kQ, n_items), kThreads, smem, stream>>>(
        fm, cm, (const int*)meta, (const int*)items, (const int*)slots, (const float*)betas,
        (float*)out, (float4*)ws, nb, Nt, Ntp, Dp, C, stages, naff);
    if ((err = (int)cudaGetLastError()) != 0) return err;
  }
  if (n_fix >= 32)
    grouped_fix_kernel<kExpand, true><<<dim3((n_fix + 127) / 128, min(Nt, 65535), nb), 128, 0,
                                         stream>>>((const float4*)ws, (const int*)fix_cls,
                                                   (const int*)fix_offs, (float*)out, n_fix, Nt,
                                                   Ntp, C);
  else if (n_fix > 0)
    grouped_fix_kernel<kExpand, false><<<dim3(n_fix, min((Nt + 127) / 128, 65535), nb), 128, 0,
                                          stream>>>((const float4*)ws, (const int*)fix_cls,
                                                    (const int*)fix_offs, (float*)out, n_fix,
                                                    Nt, Ntp, C);
  return (int)cudaGetLastError();
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
//      operands as TMA wrote them. On the H100 this gives the WMMA affinity and
//      the grouped template's bit for bit (affinity_probe below;
//      chip_smoke.py checks it), so K1, K2, K3 and K13 add the same bf16
//      weights;
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
      for (int kk = 0; kk < 4; ++kk)   // past D the boxes hold TMA's zeros: exact
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

// a launch weighs nb betas, 4 threads a query: ceil(nb / 4) a thread
template <int kExpand>
int launch_grouped(const void* f, const void* cs, const void* meta, const void* items,
                   const void* slots, const void* fix_cls, const void* fix_offs,
                   const void* betas, void* out, void* ws, int nb, int Nt, int Ntp, int Np,
                   int Dp, int C, int n_items, int n_fix, cudaStream_t stream) {
#define GROUPED_NBT(N)                                                                    \
  return launch_grouped_nbt<kExpand, N>(f, cs, meta, items, slots, fix_cls, fix_offs, betas, \
                                        out, ws, nb, Nt, Ntp, Np, Dp, C, n_items, n_fix, stream)
  switch ((nb + grp::kWalkers - 1) / grp::kWalkers) {
    case 1: GROUPED_NBT(1);
    case 2: GROUPED_NBT(2);
    case 3: GROUPED_NBT(3);
    case 4: GROUPED_NBT(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef GROUPED_NBT
}



// The affinity probe: tile i is queries 64 i .. + 63 of f and cache rows
// 128 i .. + 127 of cf (D <= 1024 columns), S = F C^T three ways, each 16-deep
// step in order: [0] WMMA 16 x 16 tiles (from device memory), [1] K1's
// transposed wgmma.m64n16k16 (64 cache rows as M, 16 queries as N), [2] the
// grouped template's wgmma.m64n128k16 (queries as M, 128 cache rows as N).
// out (3, tiles, 64 queries, 128 rows).
constexpr int kProbeMaxD = 1024;
__global__ void __launch_bounds__(128)
affinity_probe_kernel(const bf16* __restrict__ f, const bf16* __restrict__ cf,
                      float* __restrict__ out, int D, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t csw = base, fsw = base + 16384;   // swizzled boxes: 128 cache rows, 64 queries
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, nd = (D + 63) / 64;
  const bf16* fb = f + (size_t)blockIdx.x * 64 * D;
  const bf16* cb = cf + (size_t)blockIdx.x * 128 * D;
  float s1[2][4][8], s2[64];
  for (int d = 0; d < nd; ++d) {
    __syncthreads();
    for (int e = tid; e < 128 * 64; e += 128) {
      const int r = e >> 6, col = e & 63, gc = 64 * d + col;
      *reinterpret_cast<bf16*>(gbase + sw128_offset(r, col)) =
          gc < D ? cb[(size_t)r * D + gc] : __float2bfloat16(0.f);
      if (r < 64)
        *reinterpret_cast<bf16*>(gbase + 16384 + sw128_offset(r, col)) =
            gc < D ? fb[(size_t)r * D + gc] : __float2bfloat16(0.f);
    }
    fence_proxy_async();
    __syncthreads();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int acc = (d | kk) != 0;
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wgmma_m64n16k16_ss<0>(s1[x][j], sw128_desc(csw + 8192 * x + 32 * kk),
                                sw128_desc(fsw + 2048 * j + 32 * kk), acc);
      wgmma_m64n128k16_ss(s2, sw128_desc(fsw + 32 * kk), sw128_desc(csw + 32 * kk), acc);
    }
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int j = 0; j < 4; ++j) keep_n(s1[x][j]);
    keep_n(s2);
  }
  const size_t tile = (size_t)tiles * 64 * 128;
  float* o = out + (size_t)blockIdx.x * 64 * 128;
  for (int qg = 0; qg < 4; ++qg)   // WMMA: warp w, queries 16 qg .., cache rows 32 w .. + 31
    for (int rg = 0; rg < 2; ++rg) {
      FragC s;
      affinity_tile(s, fb + (size_t)16 * qg * D, D, cb + (size_t)(32 * warp + 16 * rg) * D, D, D);
      wmma::store_matrix_sync(o + 16 * qg * 128 + 32 * warp + 16 * rg, s, 128,
                              wmma::mem_row_major);
    }
  const int g = lane >> 2, t = lane & 3;
  for (int h = 0; h < 2; ++h)
    for (int u = 0; u < 2; ++u) {
      const int m = 16 * warp + g + 8 * h;
      for (int x = 0; x < 2; ++x)
        for (int jj = 0; jj < 2; ++jj)
          for (int j = 0; j < 4; ++j)   // [1]: cache row 64 x + m, query 16 j + 8 jj + 2 t + u
            o[tile + (16 * j + 8 * jj + 2 * t + u) * 128 + 64 * x + m] =
                s1[x][j][4 * jj + 2 * h + u];
      for (int jj = 0; jj < 16; ++jj)   // [2]: query m, cache row 8 jj + 2 t + u
        o[2 * tile + m * 128 + 8 * jj + 2 * t + u] = s2[4 * jj + 2 * h + u];
    }
}

// The weight-rate probe: 256 threads a block weigh `rows` rows of an f32
// tile in shared memory as the walk does (4 betas a thread, batches of 8 rows,
// cache_weight2, the adds in row order), with no boundaries, no loads of the
// tiles and no stores: what the exponentials and their adds allow alone.
__global__ void __launch_bounds__(256, 1)
weight_rate_probe_kernel(const float* __restrict__ betas, float* __restrict__ out, int rows) {
  using namespace grp;
  __shared__ float aff[kR * kAffLd];
  for (int i = threadIdx.x; i < kR * kAffLd; i += 256) aff[i] = 0.5f + 0.001f * (i % 97);
  __syncthreads();
  const int wq = threadIdx.x % kQ, wb = threadIdx.x / kQ;
  float bet[4], open[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bet[i] = betas[wb + kWalkers * i];
    open[i] = 0.f;
  }
  for (int r0 = 0; r0 < rows; r0 += kBatch) {
    const int rb = r0 % kR;
    float w[kBatch][4];
#pragma unroll
    for (int j = 0; j < kBatch; j += 2) {
      const float a0 = aff[(rb + j) * kAffLd + wq], a1 = aff[(rb + j + 1) * kAffLd + wq];
#pragma unroll
      for (int i = 0; i < 4; ++i) cache_weight2(bet[i], a0, a1, w[j][i], w[j + 1][i]);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) open[i] += w[j][i];
  }
  out[blockIdx.x * 256 + threadIdx.x] = (open[0] + open[1]) + (open[2] + open[3]);
}

// ---------------------------------------------------------------------------
// K14 blend_argmax_hits: the Tip search's blend, argmax and hit count,
//   hits[b, a] = #{n : argmax_j(cl[n, j] + alpha_a * cache[b, n, j]) == labels[n]}.
// It replaces no TPU kernel: in the JAX package XLA fuses argmax(cl + alpha * c)
// (summer_clip_tpu/methods/tip.py, accs_for_chunk_args); the eager port wrote
// each beta's (A, Nt, C) product and sum whole and read the sum back.
// What bounds it on the H100 (a Tip chunk: 16 betas, Nt = 50,000, C = 1,000,
// 20 alphas, 1.6e10 (value, alpha) blends):
//   - the instructions: a blend is a product and a sum (the FMA pipe, 128 a
//     clock an SM) and a running maximum a compare on the ALU pipe (64 a
//     clock): 0.10 ms a beta at one ALU instruction a blend;
//   - the bytes: each beta's cache logits read once and the zero-shot logits
//     once a row (200 MB + 200 MB / 16 a beta): 0.06 ms a beta at 3.35 TB/s;
//   - the latency of those reads, which only resident warps hide, and
//     registers bound the resident warps.
// What the design does about them:
//   - a warp owns one test row at a time and reads it in slices of 1024
//     columns, a lane's 32 columns of a beta's cache row in flight at once
//     (16-byte loads where C % 4 == 0, evict-first: read once) and the
//     zero-shot row 4 columns at a time as they are used (cached: every beta
//     reads it again); every value serves every alpha of the launch (up to 24),
//     whose values are kernel parameters (a constant operand of the product,
//     no register);
//   - the maximum alone runs over every blend (fmaxf: one ALU instruction); the
//     column is kept a group of 4 of a lane's columns at a time (a compare and
//     a select a group): the first group that raised the lane's maximum. The
//     warp's maximum M then comes by shuffles, and the row hits where its
//     label's blend equals M and no column before the label reaches M: a lane
//     whose first group reaching M lies wholly before the label has one, and
//     where the group straddles the label the lane blends those columns again.
//     So the first column wins a tie, as in torch.argmax. Column groups wholly
//     past C are skipped (uniform branch): a narrow C costs its own width;
//   - NaN counts as the maximum, as in torch.argmax, and fmaxf drops it. A
//     blend can be NaN only where a value read or an alpha is not finite, so a
//     (row, beta) is blended again only then, decided for the warp at once,
//     column by column with a (value, column) pair a lane and alpha (NaN the
//     largest, the lowest column on a tie) reduced across the warp by shuffles;
//   - each blended value is __fadd_rn(cl, __fmul_rn(alpha, c)): the product
//     rounded, then the sum, as the eager expression does, never contracted
//     into an FMA, so the counts equal the plain version's bit for bit;
//   - a block tallies its hits in shared memory (nb x G ints) and adds them to
//     the output once, by integer atomics: exact and independent of order.
namespace blend {
constexpr int kWarps = 4;               // warps of a block
constexpr int kMinBlocks = 3;           // resident blocks an SM (caps the registers)
constexpr int kGroups = 8;              // groups of 4 columns a lane holds in a slice
constexpr int kSlice = 32 * 4 * kGroups;   // columns of a slice
constexpr int kMaxAlphas = 24;          // alphas of a launch
constexpr int kMaxBetas = 512;          // betas of a launch (the tally: 48 KB of shared memory)
constexpr int kNone = 0x7fffffff;       // no column yet

struct Alphas {
  float a[kMaxAlphas];
};

__device__ __forceinline__ bool finite(float x) { return fabsf(x) < INFINITY; }

__device__ __forceinline__ float blended(float cl, float alpha, float c) {
  return __fadd_rn(cl, __fmul_rn(alpha, c));
}

// A lane's columns of the slice at col0, in groups of 4: group g holds columns
// first + j step (j < 4), increasing with g and j.
template <int V>
__device__ __forceinline__ int group_first(int col0, int g, int lane) {
  return V == 4 ? col0 + (g * 32 + lane) * 4 : col0 + g * 128 + lane;
}
template <int V>
__host__ __device__ constexpr int group_step() { return V == 4 ? 1 : 32; }

// The 4 values of a group, pad past C. V = 4: C % 4 == 0, so a vector lies
// wholly inside the row or wholly past it.
template <int V, bool kStream>
__device__ __forceinline__ void load_group(float (&v)[4], const float* __restrict__ row,
                                           int first, int C, float pad) {
  if constexpr (V == 4) {
    float4 t = make_float4(pad, pad, pad, pad);
    if (first < C) {
      const float4* p = reinterpret_cast<const float4*>(row + first);
      t = kStream ? __ldcs(p) : __ldg(p);
    }
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = first + 32 * j;
      v[j] = col < C ? (kStream ? __ldcs(row + col) : __ldg(row + col)) : pad;
    }
  }
}

// Whether the first column reaching the warp's maximum is the label L: bv, bk
// the lane's maximum and the first column of the first group that reached it,
// vL the label's blend.
template <int V>
__device__ __forceinline__ bool first_max_at(float bv, int bk, float vL, int L, float alpha,
                                             const float* __restrict__ cl_row,
                                             const float* __restrict__ c_row) {
  float M = bv;
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, m));
  if (vL != M) return false;                // uniform
  constexpr int s = group_step<V>();
  bool before = false;                      // a column before L reaches M
  if (bv == M) {
    if (bk + 3 * s < L) {
      before = true;
    } else if (bk < L) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int col = bk + j * s;
        if (col < L) before |= blended(cl_row[col], alpha, c_row[col]) == M;
      }
    }
  }
  return !__any_sync(0xffffffffu, before);
}

// The same for any values: the lane's (value, column) pair of each alpha over
// its columns (NaN the largest, the first NaN stays), the warp's by shuffles
// (the lower column on a tie), against the label. Returns the hit bits.
template <int G, int V>
__device__ __forceinline__ unsigned hits_exact(const Alphas& al, const float* __restrict__ cl_row,
                                            const float* __restrict__ c_row, int C,
                                            long long label, int lane) {
  float bv[G];
  int bi[G];
#pragma unroll
  for (int a = 0; a < G; ++a) bv[a] = -INFINITY, bi[a] = kNone;
  for (int col0 = 0; col0 < C; col0 += kSlice)
    for (int g = 0; g < kGroups; ++g)
      for (int j = 0; j < 4; ++j) {
        const int col = group_first<V>(col0, g, lane) + j * group_step<V>();
        if (col >= C) continue;
        const float x = cl_row[col], y = c_row[col];
#pragma unroll
        for (int a = 0; a < G; ++a) {
          const float v = blended(x, al.a[a], y);
          const bool take = bi[a] == kNone || v > bv[a] || (v != v && bv[a] == bv[a]);
          bv[a] = take ? v : bv[a];
          bi[a] = take ? col : bi[a];
        }
      }
  unsigned hit = 0;
#pragma unroll
  for (int a = 0; a < G; ++a) {
    float v = bv[a];
    int i = bi[a];
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, m);
      const int oi = __shfl_xor_sync(0xffffffffu, i, m);
      const bool take = ov != ov ? (v == v || oi < i) : (ov > v || (ov == v && oi < i));
      v = take ? ov : v;
      i = take ? oi : i;
    }
    hit |= (unsigned)((long long)i == label) << a;
  }
  return hit;
}
}  // namespace blend

// cache (nb, Nt, C), cl (Nt, C) f32, labels (Nt,) int64; the launch's A <= G
// alphas (the last repeated up to G); hits (nb, ldh) int32 from its first
// alpha's column, zero on entry. Rows go to warps in turn.
template <int G, int V>
__global__ void __launch_bounds__(blend::kWarps * 32, blend::kMinBlocks)
blend_argmax_kernel(const float* __restrict__ cache, const float* __restrict__ cl,
                    const long long* __restrict__ labels, const blend::Alphas al,
                    int* __restrict__ hits, int nb, int Nt, int C, int A, int ldh) {
  using namespace blend;
  extern __shared__ int counts[];   // (nb, A): the block's hits
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < nb * A; i += blockDim.x) counts[i] = 0;
  bool alphas_finite = true;
#pragma unroll
  for (int a = 0; a < G; ++a) alphas_finite &= finite(al.a[a]);
  __syncthreads();
  const size_t plane = (size_t)Nt * C;
  constexpr int s = group_step<V>();
  for (int n = blockIdx.x * kWarps + (threadIdx.x >> 5); n < Nt; n += gridDim.x * kWarps) {
    const long long label = labels[n];
    const bool label_in = label >= 0 && label < C;   // else the row never hits
    const int L = label_in ? (int)label : 0;
    const float* cl_row = cl + (size_t)n * C;
    const float clL = cl_row[L];
    for (int b = 0; b < nb; ++b) {
      const float* c_row = cache + b * plane + (size_t)n * C;
      const float cL = c_row[L];
      float bv[G];
      int bk[G];
#pragma unroll
      for (int a = 0; a < G; ++a) bv[a] = -INFINITY, bk[a] = lane * V;
      bool ok = alphas_finite;
      for (int col0 = 0; col0 < C; col0 += kSlice) {
        float y[kGroups][4];
#pragma unroll
        for (int g = 0; g < kGroups; ++g)
          if (col0 + g * 128 < C) load_group<V, true>(y[g], c_row, group_first<V>(col0, g, lane), C, 0.f);
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          if (col0 + g * 128 >= C) break;   // uniform: the rest lies past C
          const int first = group_first<V>(col0, g, lane);
          float x[4];
          load_group<V, false>(x, cl_row, first, C, -INFINITY);
#pragma unroll
          for (int j = 0; j < 4; ++j) ok &= (finite(x[j]) || first + j * s >= C) & finite(y[g][j]);
#pragma unroll
          for (int a = 0; a < G; ++a) {
            float m = bv[a];
#pragma unroll
            for (int j = 0; j < 4; ++j) m = fmaxf(m, blended(x[j], al.a[a], y[g][j]));
            bk[a] = m > bv[a] ? first : bk[a];
            bv[a] = m;
          }
        }
      }
      unsigned hit = 0;
      if (__all_sync(0xffffffffu, ok)) {
#pragma unroll
        for (int a = 0; a < G; ++a)
          if (label_in && first_max_at<V>(bv[a], bk[a], blended(clL, al.a[a], cL), L, al.a[a],
                                            cl_row, c_row))
            hit |= 1u << a;
      } else {
        hit = hits_exact<G, V>(al, cl_row, c_row, C, label, lane);
      }
      if (lane < A && (hit >> lane & 1u)) atomicAdd(&counts[b * A + lane], 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nb * A; i += blockDim.x)
    if (counts[i]) atomicAdd(&hits[(i / A) * ldh + i % A], counts[i]);
}

template <int G, int V>
int launch_blend_at(const float* cache, const float* cl, const long long* labels,
                    const blend::Alphas& al, int* hits, int nb, int Nt, int C, int A, int ldh,
                    cudaStream_t s) {
  const int threads = blend::kWarps * 32, smem = nb * A * (int)sizeof(int);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, blend_argmax_kernel<G, V>, threads, smem);
  const int row_blocks = (Nt + blend::kWarps - 1) / blend::kWarps;
  const int resident = (per_sm > 0 ? per_sm : 1) * sms;
  blend_argmax_kernel<G, V><<<row_blocks < resident ? row_blocks : resident, threads, smem, s>>>(
      cache, cl, labels, al, hits, nb, Nt, C, A, ldh);
  return (int)cudaGetLastError();
}

// The register group: the launch's alphas rounded up to a multiple of 4.
template <int V>
int launch_blend(const float* cache, const float* cl, const long long* labels,
                 const blend::Alphas& al, int* hits, int nb, int Nt, int C, int A, int ldh,
                 cudaStream_t s) {
  switch ((A + 3) / 4) {
    case 1: return launch_blend_at<4, V>(cache, cl, labels, al, hits, nb, Nt, C, A, ldh, s);
    case 2: return launch_blend_at<8, V>(cache, cl, labels, al, hits, nb, Nt, C, A, ldh, s);
    case 3: return launch_blend_at<12, V>(cache, cl, labels, al, hits, nb, Nt, C, A, ldh, s);
    case 4: return launch_blend_at<16, V>(cache, cl, labels, al, hits, nb, Nt, C, A, ldh, s);
    case 5: return launch_blend_at<20, V>(cache, cl, labels, al, hits, nb, Nt, C, A, ldh, s);
    default: return launch_blend_at<24, V>(cache, cl, labels, al, hits, nb, Nt, C, A, ldh, s);
  }
}

}  // namespace

extern "C" {

#define GROUPED_ARGS                                                                        \
  const void *f, const void *cs, const void *meta, const void *items, const void *slots,  \
      const void *fix_cls, const void *fix_offs, const void *betas, void *out, void *ws,   \
      int nb, int Nt, int Ntp, int Np, int Dp, int C, int n_items, int n_fix
#define GROUPED_PASS f, cs, meta, items, slots, fix_cls, fix_offs, betas, out, ws, nb, Nt, Ntp, \
                     Np, Dp, C, n_items, n_fix

// K2, K3 and K13 take the same arguments: f (Ntp, Dp) bf16 with Ntp % 64 ==
// 0; cs (Np, Dp) bf16, the cache rows in class order (Np % 128 == 0); the host
// tables of grouped_kernel; ws (n_slots, 16, Ntp) float4; out (nb, Nt, C) f32.
int labels_dense_bf16(GROUPED_ARGS, void* stream) {
  return launch_grouped<kRowSum>(GROUPED_PASS, (cudaStream_t)stream);
}

int onehot_grouped_bf16(GROUPED_ARGS, void* stream) {
  return launch_grouped<kRowSum>(GROUPED_PASS, (cudaStream_t)stream);
}

// K13: the class partials of each block_n block (the segments of meta) added
// as expand_mode says (0 highest, 1 split3, 2 default)
int onehot_variant_bf16(GROUPED_ARGS, int expand_mode, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (expand_mode) {
    case 0: return launch_grouped<kHighest>(GROUPED_PASS, s);
    case 1: return launch_grouped<kSplit3>(GROUPED_PASS, s);
    case 2: return launch_grouped<kDefault>(GROUPED_PASS, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the grouped template's ring stages at padded width Dp (0: too wide)
int grouped_stages(int Dp) { return grouped_stages_at(Dp); }

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

// f: (64 tiles, D), cf: (128 tiles, D) bf16, D % 16 == 0, D <= 1024;
// out: (3, tiles, 64, 128) f32
int affinity_probe_bf16(const void* f, const void* cf, void* out, int D, int tiles,
                        void* stream) {
  if (D < 16 || D % 16 || D > kProbeMaxD || tiles < 1) return (int)cudaErrorInvalidValue;
  const int smem = 1024 + 16384 + 8192;
  cudaFuncSetAttribute(affinity_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  affinity_probe_kernel<<<tiles, 128, smem, (cudaStream_t)stream>>>(
      (const bf16*)f, (const bf16*)cf, (float*)out, D, tiles);
  return (int)cudaGetLastError();
}


// K14: cache (nb, Nt, C) and cl (Nt, C) f32, labels (Nt,) int64, all contiguous;
// alphas: A <= 24 values on the host; hits (nb, ldh) int32 from the launch's
// first alpha's column, zeroed by the caller; nb <= 512
int blend_argmax_hits_f32(const void* cache, const void* cl, const void* labels,
                          const float* alphas, void* hits, int nb, int Nt, int C, int A, int ldh,
                          void* stream) {
  if (nb < 1 || nb > blend::kMaxBetas || Nt < 1 || C < 1 || A < 1 || A > blend::kMaxAlphas ||
      ldh < A)
    return (int)cudaErrorInvalidValue;
  blend::Alphas al;
  for (int a = 0; a < blend::kMaxAlphas; ++a) al.a[a] = alphas[a < A ? a : A - 1];
  const float *c = (const float*)cache, *l = (const float*)cl;
  const bool v4 = C % 4 == 0 && ((uintptr_t)c | (uintptr_t)l) % 16 == 0;
  return (v4 ? launch_blend<4> : launch_blend<1>)(c, l, (const long long*)labels, al, (int*)hits,
                                                  nb, Nt, C, A, ldh, (cudaStream_t)stream);
}

// betas (16,) f32; out (blocks x 256,) f32; rows % 8 == 0
int weight_rate_probe_bf16(const void* betas, void* out, int rows, int blocks, void* stream) {
  if (rows < 8 || rows % 8 || blocks < 1) return (int)cudaErrorInvalidValue;
  weight_rate_probe_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>((const float*)betas,
                                                                     (float*)out, rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
