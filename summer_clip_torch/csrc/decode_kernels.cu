// The whole GPT-2 block stack for one token of up to 8 decode streams, sm_90a.
//
// Replaces the TPU kernel of summer_clip_tpu/ops/decode_block.py:
//   K8 decode_block -> decode_stack (one launch of a persistent clustered grid)
//   for each of L blocks: LN -> qkv (bf16 operands, f32 sums, column scale, bias)
//   -> the fresh K and V rows quantised per row to int8 (or cast to bf16) ->
//   attention of each stream's query over that stream's ring rows
//   pad[b] <= t < index[b] plus the fresh row as stored, online softmax ->
//   out projection + residual -> LN -> fc + tanh-GELU -> projection + residual.
//   Out: y (B, D) f32 and the fresh rows (L, B, D) with their scales (L, B, 1);
//   the caller writes them into the rings.
//
// Arithmetic: that of ops/decode_block.py:decode_block_reference, rounding
// points included (K dequantised as bf16(k) * bf16(ks) in bf16, q / sqrt(hd)
// rounded to bf16, f32 scores, bf16(p * vs) * bf16(v) rounded to bf16 before
// the f32 sum, ring rows taken 256 at a time with the fresh token first, masked
// scores -1e30, one division by l at the end). Only the order of f32 sums
// differs.
//
// What bounds it on Hopper: bytes (12 D^2 stored weight bytes a block and a
// token, read once for all streams, plus each stream's live ring rows), and
// beside them the chain of 5 L stages, each of which needs the last one's
// activations: a grid-wide barrier between stages (5 L - 1 a token). The
// design keeps the weight stream off that chain:
//
// - One CTA an SM, in clusters of 4; the grid is as many clusters as can be
//   resident at once (cudaOccupancyMaxActiveClusters), so the barriers cannot
//   deadlock. The barrier is a counter in global memory (a release add, relaxed
//   polls by one thread and an acquire fence, a CTA barrier on each side); a
//   launch leaves it at zero.
// - The weights of the whole launch are one sequence of TMA boxes a CTA,
//   fixed by the geometry: for each block and product, the column tiles dealt
//   to the CTA's cluster (16 to 256 bytes wide, ops/decode_block.stage_plan),
//   and in each tile the rank's K chunk in boxes of up to 256 rows and 16 KB.
//   A ring of 8 slots holds the sequence's next boxes, marked evict-first in
//   L2 so that activations, parameters and ring rows stay there. The slots a
//   stage frees are refilled by thread 0 once its CTA has arrived at the
//   barrier that ends the stage (a TMA issue costs the issuing thread ~0.15 us,
//   which on a stage's chain was a fifth of the stage), with the next boxes of
//   the sequence, whatever stage they belong to. So the loads of the coming
//   stages are in flight while a stage computes and while the grid waits: the
//   stream runs a full ring (128 KB a CTA, 15 MB on the card) ahead of the
//   chain. A producer warp would wait for a free slot at the same moments,
//   since only consumption frees one.
// - Split K inside a cluster: the four CTAs of a cluster take one column tile's
//   four K chunks; each sums its chunk in a fixed order (weight_ring.cuh: rows
//   walked a box at a time, reduce-scatter shuffles, the warps in order; at
//   eight streams the rows four at a time, two passes over the resident
//   boxes), then pushes every sum to the rank that owns it (distributed shared
//   memory), and after one cluster barrier each rank adds its quarter of the
//   tile in rank order from local shared memory and scales, biases and stores
//   it (or GELU, or adds it to the residual), with the epilogue's operands
//   loaded before the products. One cluster barrier a tile; no workspace
//   partials, fence or ticket.
// - LayerNorm: every thread loads a float4 of each 1024 floats of every
//   stream's row, with the CTA's chunk of gamma and beta, in one L2 trip; the
//   two-pass statistics are block sums; the chunk's normalised bf16 values go
//   to shared memory.
// - Attention: unit = (stream, head), one CTA a unit, units dealt over the
//   grid (at one stream 20 of the CTAs). A unit's first trip to memory asks for
//   the fresh row, the head's q, k and v and the first pass's ring rows (asked
//   of L2 before the barrier that opens the stage) at once; each later pass's
//   rows are asked for during the pass before. (Rows split over a cluster's
//   four CTAs, with the pass max and the (l, acc) partials exchanged over
//   distributed shared memory, cost two cluster barriers a unit and left a
//   cluster walking six units in turn at eight streams: slower at every shape
//   measured.) Only passes with live rows are read, and of those only live
//   rows: index and pad are read on the device.
// - Every sum is in an order fixed by the geometry, never by the number of
//   streams or by timing: two runs give the same bits, and a stream's result
//   does not depend on the streams that ride with it.
//
// The entry point returns the launch's error; it refuses a grid that cannot be
// co-resident instead of deadlocking in a barrier, and a barrier that waits
// about two seconds traps.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gemv_common.cuh"
#include "hopper_common.cuh"
#include "weight_ring.cuh"

namespace {

constexpr int kThreads = kRingThreads;     // 256: every thread computes
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 4;                // CTAs a cluster: a product's K split
constexpr int kKcMax = 1280;               // rows of K a CTA stages (H <= 4 kKcMax)
constexpr int kTileMax = 256;              // columns a tile at most (twb <= 256 bytes)
constexpr int kSlotBytes = 16384;          // a ring slot: one TMA box
constexpr int kTc = 256;                   // ring rows a pass of the attention takes
constexpr int kHd = 64;                    // features of a head (every GPT-2 has 64)
constexpr int kDMax = 2 * kThreads * 4;    // a LayerNorm row: two float4 a thread
constexpr float kNeg = -1e30f;
// shared memory: ring | xs (8, kKcMax) f32 | red (warps, 4, kTileMax) f32 (a
// tile's rows four at a time) | xch (2, 8, kTileMax) f32 | mbarriers
constexpr int kXsBytes = 8 * kKcMax * 4;
constexpr int kRedBytes = kWarps * 4 * kTileMax * 4;
constexpr int kXchFloats = 8 * kTileMax;
constexpr int kSmemLimit = 232448;
constexpr int kFixedBytes = kXsBytes + kRedBytes + 2 * kXchFloats * 4 + 16 * 8;
constexpr int kSlots = (kSmemLimit - kFixedBytes) / kSlotBytes;   // 8
constexpr int kSmemBytes = kSlots * kSlotBytes + kFixedBytes;
static_assert(kSlots >= 2 && kSlots <= 16, "the ring");
constexpr int kEpi = 8 * kTileMax / (kCluster * kThreads);   // a tile's sums a thread: 2

enum { OUT_STORE = 0, OUT_GELU = 1, OUT_RESIDUAL = 2 };

#ifdef K8_PROBE   // phase stamps inside a stage, after the stage stamps: (L, 5, 8, grid)
#define PROBE(P, l, stage, slot)                                                              \
  if ((P).stamps && threadIdx.x == 0)                                                         \
    (P).stamps[(size_t)(P).L * 10 * gridDim.x + 2 +                                           \
               ((((size_t)(l) * 5 + (stage)) * 8 + (slot)) * gridDim.x) + blockIdx.x] = clock64();
#else
#define PROBE(P, l, stage, slot)
#endif

// products: 0 qkv (D -> 3D), 1 proj (D -> D), 2 fc (D -> H), 3 out (H -> D)
struct Params {
  CUtensorMap maps[4];                // (L K rows, N * itemsize bytes), UINT8, box (twb, br)
  float* x;                           // (B, D) residual stream, in place: y at the end
  const float* scale[4];              // (L, 1, N)
  const float* bias[4];
  const float* ln;                    // (L, 4, D)
  const void *k, *v;                  // (L, B, T, D)
  const float *ks, *vs;               // (L, B, T, 1)
  const int *index, *pad;             // (B)
  void *kq, *vq;                      // (L, B, D) out
  float *ksn, *vsn;                   // (L, B, 1) out
  float *qkv, *att, *hid;             // activations between stages (L2)
  unsigned* sync;                     // grid barrier: arrivals, exits; zero at rest
  long long* stamps;   // null, or (L, 5 stages, {start, end of this CTA's work}, grid) SM cycle
                       // counts and then CTA 0's globaltimer (ns) at its start and end
  int L, B, T, D, H, nh;
  int twb[4], br[4];                  // tile bytes and box rows of each product
  int tiles[4], prefix[4], tiles_layer;   // column tiles; dealt round-robin over a launch
  int ncl;                            // clusters in the grid
};

__device__ __forceinline__ int prod_k(const Params& P, int p) { return p == 3 ? P.H : P.D; }
__device__ __forceinline__ int prod_n(const Params& P, int p) {
  return p == 0 ? 3 * P.D : p == 2 ? P.H : P.D;
}

// The tiles of block l's product p go to clusters round-robin, continuing
// where the launch's previous product left off: a cluster's first tile.
__device__ __forceinline__ int first_tile(const Params& P, int l, int p, int cl) {
  const int base = (l * P.tiles_layer + P.prefix[p]) % P.ncl;
  return (cl - base + P.ncl) % P.ncl;
}

// A place in a CTA's sequence of weight boxes: block, product, tile, box,
// with the product's constants at hand (read from the parameters once a
// product, so that asking for a box is a few register operations).
struct Cursor {
  int l, p, t, j;
  int tiles, nbox, twb, br, row0;   // row0: the rank's first row of block l's matrix

  __device__ __forceinline__ void load(const Params& P, int rank) {
    const int K = prod_k(P, p);
    tiles = P.tiles[p];
    twb = P.twb[p];
    br = P.br[p];
    nbox = K / kCluster / br;
    row0 = l * K + rank * (K / kCluster);
  }
};

__device__ __forceinline__ void settle(const Params& P, Cursor& c, int cl, int rank) {
  while (c.l < P.L && c.t >= c.tiles) {
    if (++c.p == 4) {
      c.p = 0;
      ++c.l;
    }
    c.j = 0;
    if (c.l < P.L) {
      c.t = first_tile(P, c.l, c.p, cl);
      c.load(P, rank);
    }
  }
}

__device__ __forceinline__ void step(const Params& P, Cursor& c, int cl, int rank) {
  if (++c.j == c.nbox) {
    c.j = 0;
    c.t += P.ncl;
    settle(P, c, cl, rank);
  }
}

__device__ __forceinline__ void issue_box(const Params& P, const Cursor& c, unsigned char* slot,
                                          uint64_t* bar, uint64_t policy) {
  const uint32_t b = smem_u32(bar);
  mbar_expect(b, (uint32_t)(c.twb * c.br));
  tma_2d_hint(smem_u32(slot), &P.maps[c.p], b, c.t * c.twb, c.row0 + c.j * c.br, policy);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The same value in every thread; `scratch` holds kWarps floats. The warps'
// results are combined in warp order, so the sum does not depend on timing.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* scratch) {
  v = MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = MAX ? fmaxf(r, scratch[w]) : r + scratch[w];
  return r;
}

// The grid barrier, in two halves: the CTA's writes before the bar.sync are
// released with thread 0's add (arrive), and acquired by every thread of the
// grid through thread 0's load and the second bar.sync (wait). Between the two
// thread 0 may do work of its own.
__device__ __forceinline__ void grid_arrive(unsigned* count) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(count) : "memory");
}
// relaxed polls, then one acquire fence once the count is reached
__device__ __forceinline__ void grid_wait(unsigned* count, unsigned target) {
  if (threadIdx.x == 0) {
    const long long t0 = clock64();
    unsigned seen;
    do {
      asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(count) : "memory");
      if (clock64() - t0 > (1ll << 32)) __trap();   // ~2 s: a grid that is not co-resident
    } while (seen < target);
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
  }
  __syncthreads();
}

// Ask L2 for what block l's product p reads besides the weights and the rows:
// its LayerNorm's gamma and beta over this rank's chunk, and the scale and bias
// of this cluster's tiles (issued before the barrier that opens the stage,
// since the weight stream keeps evicting them).
__device__ __forceinline__ void prefetch_params(const Params& P, int l, int p, int cl, int rank,
                                                int itemsize) {
  const int kc = prod_k(P, p) / kCluster, N = prod_n(P, p);
  const int tw = P.twb[p] / itemsize, lines = (tw * 4 + 127) / 128;
  int i = threadIdx.x;
  if (p == 0 || p == 2) {
    const float* g = P.ln + ((size_t)l * 4 + (p == 0 ? 0 : 2)) * P.D + rank * kc;
    const int ln_lines = (kc * 4 + 127) / 128;
    if (i < 2 * ln_lines) {
      asm volatile("prefetch.global.L2 [%0];" ::"l"(g + (i / ln_lines) * P.D + (i % ln_lines) * 32));
      return;
    }
    i -= 2 * ln_lines;
  }
  const int t = first_tile(P, l, p, cl) + (i / (2 * lines)) * P.ncl;
  if (t < P.tiles[p]) {
    const float* v = ((i / lines) % 2 ? P.bias[p] : P.scale[p]) + (size_t)l * N + t * tw;
    asm volatile("prefetch.global.L2 [%0];" ::"l"(v + (i % lines) * 32));
  }
}

// The weight ring. Box m of the CTA's sequence goes to slot m % kSlots.
struct Ring {
  unsigned char* slots;
  uint64_t* bars;
  int n;          // boxes consumed (every thread's count)
  int issued;     // boxes asked for (thread 0's)
  Cursor next;    // the box the next refill asks for (thread 0's)
  int xchg;       // cluster exchanges so far: the parity picks the exchange buffer

  // Thread 0: ask for boxes until the ring is full. Called after thread 0 has
  // arrived at a grid barrier, before it polls (a TMA issue costs the issuing
  // thread ~0.15 us, too much for a stage's chain; a second thread issuing
  // while thread 0 polled measured slower), and before the waits of a stage's
  // second tile.
  __device__ __forceinline__ void refill(const Params& P, int rank, int cl) {
    if (threadIdx.x != 0) return;
    // read once a token: evicted from L2 first, so that the activations,
    // parameters and ring rows stay there
    const uint64_t policy = evict_first_policy();
    for (; issued < n + kSlots && next.l < P.L; ++issued) {
      const int slot = issued % kSlots;
      issue_box(P, next, slots + (size_t)slot * kSlotBytes, bars + slot, policy);
      step(P, next, cl, rank);
    }
  }
};

// xs (R, kc) <- bf16(LN(rows of in)) or bf16(rows of in), columns kb .. kb + kc
// of every stream's row; rows B .. R - 1 zero. gb: 2 kc + kWarps R floats of
// scratch. Every load is issued before the first is used: one L2 trip.
template <int R>
__device__ __forceinline__ void stage_rows(const Params& P, const float* in, int K,
                                           const float* gamma, const float* beta, int kb,
                                           int kc, float* xs, float* gb) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (gamma != nullptr) {
    // LayerNorm: the chunk's gamma and beta, and every stream's whole row, a
    // thread a float4 of each 1024 floats (K <= 2048); statistics by block sums.
    // (Each CTA loading only its chunk, with the four ranks' sums exchanged
    // over distributed shared memory, read a quarter of the bytes but took two
    // cluster barriers: 4.4 us a stage at one stream against 1.2-1.7.)
    float g[4], bt[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = tid + u * kThreads;
      g[u] = i < kc ? __ldg(gamma + kb + i) : 0.f;
      bt[u] = i < kc ? __ldg(beta + kb + i) : 0.f;
    }
    float4 v[R][2];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = (tid + j * kThreads) * 4;
        v[r][j] = r < P.B && e < K ? __ldcg(reinterpret_cast<const float4*>(in + (size_t)r * K + e))
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = tid + u * kThreads;
      if (i < kc) {
        gb[i] = g[u];
        gb[kc + i] = bt[u];
      }
    }
    float* wsum = gb + 2 * kc;   // (warps, R)
    // two passes, each a sum of every row at once: a thread's values, the
    // warp's lanes, the warps in order
    float mean[R], rs[R];
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      float t[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        t[r] = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if ((tid + j * kThreads) * 4 < K) {
            const float4 q = v[r][j];
            if (pass == 0) {
              t[r] += (q.x + q.y) + (q.z + q.w);
            } else {
              const float a = q.x - mean[r], b = q.y - mean[r], c = q.z - mean[r],
                          d = q.w - mean[r];
              t[r] += (a * a + b * b) + (c * c + d * d);
            }
          }
        }
        t[r] = warp_sum(t[r]);
      }
      __syncthreads();   // gamma and beta are written; the last pass's sums are read
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) wsum[warp * R + r] = t[r];
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += wsum[w * R + r];
        if (pass == 0) mean[r] = sum / (float)K;
        else rs[r] = 1.f / sqrtf(sum / (float)K + 1e-5f);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int i = (tid + j * kThreads) * 4 - kb;
        if (i >= 0 && i < kc) {
          const float e[4] = {v[r][j].x, v[r][j].y, v[r][j].z, v[r][j].w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
            xs[r * kc + i + u] = r < P.B ? round_bf16((e[u] - mean[r]) * rs[r] * gb[i + u] +
                                                      gb[kc + i + u])
                                         : 0.f;
        }
      }
    }
  } else {
    // every load before the first store: R kc / 4 float4 over 256 threads
    constexpr int U = (8 * kKcMax / 4 + kThreads - 1) / kThreads;   // 10
    const int n4 = R * kc / 4, c4 = kc / 4;
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = tid + u * kThreads, r = i / c4;
      v[u] = i < n4 && r < P.B
                 ? __ldcg(reinterpret_cast<const float4*>(in + (size_t)r * K + kb) + i % c4)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = tid + u * kThreads;
      if (i < n4) {
        float* d = xs + (i / c4) * kc + (i % c4) * 4;
        d[0] = round_bf16(v[u].x);
        d[1] = round_bf16(v[u].y);
        d[2] = round_bf16(v[u].z);
        d[3] = round_bf16(v[u].w);
      }
    }
  }
  __syncthreads();
}

// One product stage: this cluster's column tiles of block l's product p.
// At eight streams the rows are taken four at a time (two passes over the same
// resident boxes), so that a thread's sums stay in registers.
template <typename W, int R>
__device__ __forceinline__ void product_stage(const Params& P, int l, int p, int cl, int rank,
                                              Ring& ring, float* xs, float* red, float* xch) {
  constexpr int V = Vec<W>::n;
  constexpr int RB = R < 4 ? R : 4;
  const int tid = threadIdx.x;
  const int K = prod_k(P, p), N = prod_n(P, p), kc = K / kCluster, kb = rank * kc;
  const int twb = P.twb[p], tw = twb / (int)sizeof(W), br = P.br[p], nbox = kc / br;
  int t = first_tile(P, l, p, cl);
  if (t >= P.tiles[p]) return;   // no tile of this product for this cluster
  const int stg = p == 0 ? 0 : p + 1;
  PROBE(P, l, stg, 0);
  const float* ln = P.ln + (size_t)l * 4 * P.D;
  const float* gamma = p == 0 ? ln : p == 2 ? ln + 2 * P.D : nullptr;
  stage_rows<R>(P, p == 0 || p == 2 ? P.x : p == 1 ? P.att : P.hid, K, gamma,
                gamma ? gamma + P.D : nullptr, kb, kc, xs, red);
  float* out = p == 0 ? P.qkv : p == 2 ? P.hid : P.x;
  const int mode = p == 0 ? OUT_STORE : p == 2 ? OUT_GELU : OUT_RESIDUAL;
  const float* scale = P.scale[p] + (size_t)l * N;
  const float* bias = P.bias[p] + (size_t)l * N;
  const BoxLanes bl(twb);
  PROBE(P, l, stg, 1);
  for (bool first = true; t < P.tiles[p]; t += P.ncl, first = false) {
    // the epilogue's operands first: they arrive while the products run
    const int c0 = t * tw;
    float sc[kEpi], bs[kEpi], res[kEpi];
#pragma unroll
    for (int e = 0; e < kEpi; ++e) {   // this rank's sums: i = rank + 4 (tid + 256 e)
      const int i = rank + kCluster * (tid + kThreads * e), col = c0 + i % tw;
      sc[e] = bs[e] = res[e] = 0.f;
      if (i < P.B * tw && col < N) {
        sc[e] = __ldg(scale + col);
        bs[e] = __ldg(bias + col);
        if (mode == OUT_RESIDUAL) res[e] = __ldcg(out + (size_t)(i / tw) * N + col);
      }
    }
    // the tile's boxes (at most kSlots: the host's plan) are all resident before
    // the products; one barrier then frees their slots
    float* part = xch + (ring.xchg & 1) * kXchFloats;
    if (!first) ring.refill(P, rank, cl);   // the last tile's slots, while the operands load
    for (int j = 0; j < nbox; ++j) {
      const int n = ring.n + j;
      mbar_wait_bounded(smem_u32(ring.bars + n % kSlots), (uint32_t)(n / kSlots) & 1u);
    }
    if (first) PROBE(P, l, stg, 2);
    for (int h = 0; h < R / RB; ++h) {
      if (h > 0) __syncthreads();   // red is read
      float acc[RB][V];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
#pragma unroll
        for (int j = 0; j < V; ++j) acc[r][j] = 0.f;
      }
      boxes_fma<W, RB>(ring.slots, kSlotBytes, kSlots, ring.n % kSlots, nbox, twb, br,
                       xs + h * RB * kc, kc, bl, acc);
      if (first && h == 0) PROBE(P, l, stg, 3);
      tile_sums<W, RB>(acc, bl, tw, h * RB, P.B, red, part, kCluster, rank, kXchFloats / kCluster);
    }
    if (first) PROBE(P, l, stg, 4);
    ring.n += nbox;
    cluster_sync();    // the sums are pushed; the slots are read, a refill may reuse them
    if (first) PROBE(P, l, stg, 5);
    // this rank's share of the tile, summed over the ranks in rank order
#pragma unroll
    for (int e = 0; e < kEpi; ++e) {
      const int i = rank + kCluster * (tid + kThreads * e), col = c0 + i % tw;
      if (i < P.B * tw && col < N) {
        const float v = rank_sum(part, i / kCluster, kCluster, kXchFloats / kCluster) * sc[e] + bs[e];
        out[(size_t)(i / tw) * N + col] =
            mode == OUT_STORE ? v : mode == OUT_GELU ? gelu_tanh(v) : res[e] + v;
      }
    }
    if (first) PROBE(P, l, stg, 6);
    ++ring.xchg;
  }
}

// Four adjacent features of a ring row: the load, and the floats of what it read.
__device__ __forceinline__ uint32_t load_raw4(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint2 load_raw4(const bf16* p) {
  return *reinterpret_cast<const uint2*>(p);
}
__device__ __forceinline__ void unpack4(uint32_t raw, float (&f)[4]) {
  const uint32_t w = raw ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7651)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7652)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7653)) - 8388736.f;
}
__device__ __forceinline__ void unpack4(const uint2& raw, float (&f)[4]) {
  f[0] = __uint_as_float(raw.x << 16);
  f[1] = __uint_as_float(raw.x & 0xffff0000u);
  f[2] = __uint_as_float(raw.y << 16);
  f[3] = __uint_as_float(raw.y & 0xffff0000u);
}

// The fresh K or V value as the ring stores it: (stored, its float).
__device__ __forceinline__ float store_fresh(int8_t* dst, float v, float scale) {
  const float q = fminf(fmaxf(rintf(v / scale), -127.f), 127.f);
  *dst = (int8_t)q;
  return q;
}
__device__ __forceinline__ float store_fresh(bf16* dst, float v, float) {
  const bf16 q = __float2bfloat16_rn(v);
  *dst = q;
  return __bfloat162float(q);
}

// The ring rows a pass reads: a thread's whole K row (row c0 + tid) with its
// scales, and 4 features of 16 rows of V (rows tid / 16 + 16 m, features
// 4 (tid % 16) ..). Asked for before they are needed: a unit's first pass with
// the fresh row, every later one during the pass before.
template <typename KV>
struct PassRows {
  static constexpr int KP = kHd / Vec<KV>::n;   // 16-byte pieces of a head's K row
  uint4 k[KP];
  float ks, vs;
  decltype(load_raw4((const KV*)nullptr)) v[kTc / 16];

  __device__ __forceinline__ void load(const KV* kring, const KV* vring, const float* ks_row,
                                       const float* vs_row, int c0, int idx, int padv, int D) {
    const int tid = threadIdx.x, r = c0 + tid;
    if (r < idx && r >= padv) {
#pragma unroll
      for (int u = 0; u < KP; ++u)
        k[u] = *reinterpret_cast<const uint4*>(kring + (size_t)r * D + u * Vec<KV>::n);
      ks = ks_row[r];
      vs = vs_row[r];
    }
#pragma unroll
    for (int m = 0; m < kTc / 16; ++m) {
      const int rr = c0 + (tid >> 4) + 16 * m;
      if (rr < idx && rr >= padv) v[m] = load_raw4(vring + (size_t)rr * D + (tid & 15) * 4);
    }
  }
};

// max over the block of two values at once; scratch holds 2 kWarps floats
__device__ __forceinline__ float2 block_max2(float a, float b, float* scratch) {
  a = warp_max(a);
  b = warp_max(b);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    scratch[threadIdx.x >> 5] = a;
    scratch[kWarps + (threadIdx.x >> 5)] = b;
  }
  __syncthreads();
  float2 r = make_float2(scratch[0], scratch[kWarps]);
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    r.x = fmaxf(r.x, scratch[w]);
    r.y = fmaxf(r.y, scratch[kWarps + w]);
  }
  return r;
}

// The attention stage: unit = (stream, head), one CTA a unit: units
// blockIdx.x, + gridDim.x, ... A unit's first L2 trip asks for everything that
// does not wait on another load: the fresh k and v rows (their amax), the
// head's q, k and v, and the first pass's ring rows. A pass: a thread a ring row
// for the scores, then (16 row groups, 4 features) for the weighted sum of V.
// scr: the CTA's scratch.
template <typename KV>
__device__ __forceinline__ void attention_stage(const Params& P, int l, float* scr) {
  constexpr bool INT8 = sizeof(KV) == 1;
  constexpr int V = Vec<KV>::n;
  const int tid = threadIdx.x;
  const int D = P.D, T = P.T, B = P.B, nh = P.nh;
  float* qb = scr;                  // (hd) bf16(q / sqrt(hd))
  float* pv = scr + kHd;            // (kTc) bf16(p * vs); first the fresh row's score terms
  float* acc = pv + kTc;            // (hd)
  float* wsc = acc + kHd;           // (2 warps) block reductions
  float* redv = wsc + 2 * kWarps;   // (16 row groups, hd)
  const int rg = tid >> 4, dg = tid & 15;
  for (int u = blockIdx.x; u < B * nh; u += gridDim.x) {
    const bool first = u == (int)blockIdx.x;
    if (first) PROBE(P, l, 1, 0);
    const int b = u / nh, h = u % nh;
    const float* row = P.qkv + (size_t)b * 3 * D;
    const int idx = min(max(P.index[b], 0), T);
    const int padv = max(P.pad[b], 0);
    const size_t ring_row = ((size_t)l * B + b) * T;
    const KV* kring = reinterpret_cast<const KV*>(P.k) + ring_row * D + h * kHd;
    const KV* vring = reinterpret_cast<const KV*>(P.v) + ring_row * D + h * kHd;
    const float* ks_row = P.ks + ring_row;
    const float* vs_row = P.vs + ring_row;
    int c0 = (padv / kTc) * kTc;
    __syncthreads();   // the last unit's shared values are read
    float qf = 0.f, kfr = 0.f, vfr = 0.f, km = 0.f, vm = 0.f;
    if (tid < kHd) {
      qf = __ldcg(row + h * kHd + tid);
      kfr = __ldcg(row + D + h * kHd + tid);
      vfr = __ldcg(row + 2 * D + h * kHd + tid);
    }
    if (INT8) {        // per-row scales: the largest |k| and |v| of the whole row
      for (int e = tid; e < D; e += kThreads) {
        km = fmaxf(km, fabsf(__ldcg(row + D + e)));
        vm = fmaxf(vm, fabsf(__ldcg(row + 2 * D + e)));
      }
    }
    PassRows<KV> pr;
    if (c0 < idx) pr.load(kring, vring, ks_row, vs_row, c0, idx, padv, D);
    float ksc = 1.f, vsc = 1.f;
    if (INT8) {        // times the f32 reciprocal, as the plain version computes it
      const float2 mx = block_max2(km, vm, wsc);
      ksc = fmaxf(mx.x, 1e-12f) * (1.f / 127.f);
      vsc = fmaxf(mx.y, 1e-12f) * (1.f / 127.f);
    }
    if (first) PROBE(P, l, 1, 1);
    const size_t fresh = ((size_t)l * B + b) * D + h * kHd;
    if (tid < kHd) {
      const float kq = store_fresh(reinterpret_cast<KV*>(P.kq) + fresh + tid, kfr, ksc);
      const float vq = store_fresh(reinterpret_cast<KV*>(P.vq) + fresh + tid, vfr, vsc);
      qb[tid] = round_bf16(qf / sqrtf((float)kHd));
      acc[tid] = vsc * vq;                     // the fresh row as stored, weight 1
      pv[tid] = round_bf16(kq * ksc) * qb[tid];
    }
    if (h == 0 && tid == 0) {
      P.ksn[(size_t)l * B + b] = ksc;
      P.vsn[(size_t)l * B + b] = vsc;
    }
    __syncthreads();
    float m = 0.f, lsum = 1.f;
    for (int d = 0; d < kHd; ++d) m += pv[d];   // the fresh row's score, the same in every thread
    if (first) PROBE(P, l, 1, 2);

    for (; c0 < idx; c0 += kTc) {
      const int r = c0 + tid;
      const bool valid = r < idx && r >= padv;
      float sc = kNeg;
      if (valid) {
        const float ksb = round_bf16(pr.ks);
        float s = 0.f;
#pragma unroll
        for (int u8 = 0; u8 < PassRows<KV>::KP; ++u8) {
          float f[V];
          Vec<KV>::unpack(pr.k[u8], f);
#pragma unroll
          for (int e = 0; e < V; ++e) s = fmaf(round_bf16(f[e] * ksb), qb[u8 * V + e], s);
        }
        sc = s;
      }
      const float mnew = fmaxf(m, block_reduce<true>(sc, wsc));
      if (first) PROBE(P, l, 1, 3);
      const float alpha = expf(m - mnew);
      const float p = valid ? expf(sc - mnew) : 0.f;
      pv[tid] = valid ? round_bf16(p * pr.vs) : 0.f;
      lsum = lsum * alpha + block_reduce<false>(p, wsc);   // its barriers also publish pv
      if (first) PROBE(P, l, 1, 4);
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int mm = 0; mm < kTc / 16; ++mm) {   // in row order
        const int rr = rg + 16 * mm;
        if (c0 + rr < idx && c0 + rr >= padv) {
          const float wgt = pv[rr];
          float f[4];
          unpack4(pr.v[mm], f);
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] += round_bf16(wgt * f[e]);
        }
      }
      // the next pass's rows, asked for before this pass's sums are added
      if (c0 + kTc < idx) pr.load(kring, vring, ks_row, vs_row, c0 + kTc, idx, padv, D);
#pragma unroll
      for (int e = 0; e < 4; ++e) redv[rg * kHd + dg * 4 + e] = a[e];
      __syncthreads();
      if (tid < kHd) {
        float t = 0.f;
        for (int g = 0; g < kThreads / 16; ++g) t += redv[g * kHd + tid];
        acc[tid] = acc[tid] * alpha + t;
      }
      m = mnew;
      if (first) PROBE(P, l, 1, 5);
    }
    __syncthreads();
    if (tid < kHd) P.att[(size_t)b * D + h * kHd + tid] = acc[tid] / lsum;
    if (first) PROBE(P, l, 1, 6);
  }
}

__device__ __forceinline__ void stamp(const Params& P, int layer, int stage, int end) {
  if (P.stamps && threadIdx.x == 0)
    P.stamps[(((size_t)layer * 5 + stage) * 2 + end) * gridDim.x + blockIdx.x] = clock64();
}

__device__ __forceinline__ void stamp_wall(const Params& P, int end) {
  if (P.stamps && threadIdx.x == 0 && blockIdx.x == 0) {
    long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    P.stamps[(size_t)P.L * 10 * gridDim.x + end] = ns;
  }
}

// Ask L2 for the ring rows of the first pass of this CTA's first attention
// unit of block l (K and V of a head: 64 bytes or 128 a row, a line a row).
template <typename KV>
__device__ __forceinline__ void prefetch_ring(const Params& P, int l) {
  const int u = blockIdx.x;
  if (u >= P.B * P.nh) return;
  const int b = u / P.nh, h = u % P.nh;
  const int idx = min(max(P.index[b], 0), P.T), padv = max(P.pad[b], 0);
  const int r = (padv / kTc) * kTc + (int)threadIdx.x;
  if (r < idx && r >= padv) {
    const size_t at = (((size_t)l * P.B + b) * P.T + r) * P.D + h * kHd;
    asm volatile("prefetch.global.L2 [%0];" ::"l"(reinterpret_cast<const KV*>(P.k) + at));
    asm volatile("prefetch.global.L2 [%0];" ::"l"(reinterpret_cast<const KV*>(P.v) + at));
  }
}

template <typename W, typename KV, int R>
__global__ void __launch_bounds__(kThreads, 1)
decode_stack_kernel(const __grid_constant__ Params P) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem + kSlots * kSlotBytes);
  float* red = xs + 8 * kKcMax;
  float* xch = red + kWarps * 4 * kTileMax;
  const int rank = (int)cluster_rank(), cl = blockIdx.x / kCluster;
  Ring ring;
  ring.slots = smem;
  ring.bars = reinterpret_cast<uint64_t*>(xch + 2 * kXchFloats);
  ring.n = ring.issued = ring.xchg = 0;
  ring.next.l = ring.next.p = ring.next.j = 0;   // the sequence's first box
  ring.next.t = first_tile(P, 0, 0, cl);
  ring.next.load(P, rank);
  settle(P, ring.next, cl, rank);
  if (threadIdx.x == 0) {   // the ring's first boxes
    for (int s = 0; s < kSlots; ++s) mbar_init(smem_u32(ring.bars + s), 1);
    mbar_init_fence();
  }
  ring.refill(P, rank, cl);
  __syncthreads();
  stamp_wall(P, 0);
  unsigned barriers = 0;
  for (int l = 0; l < P.L; ++l) {
    for (int stage = 0; stage < 5; ++stage) {
      stamp(P, l, stage, 0);
      if (stage == 1) attention_stage<KV>(P, l, red);
      else product_stage<W, R>(P, l, stage == 0 ? 0 : stage - 1, cl, rank, ring, xs, red, xch);
      stamp(P, l, stage, 1);
      if (l + 1 < P.L || stage < 4) {
        // the coming product stage's parameters (after the qkv stage, proj's,
        // and the attention's first ring rows) asked of L2; the stage's slots
        // refilled once this CTA has arrived
        const int nl = stage == 4 ? l + 1 : l, ns = stage == 4 ? 0 : stage == 0 ? 2 : stage + 1;
        prefetch_params(P, nl, ns == 0 ? 0 : ns - 1, cl, rank, (int)sizeof(W));
        if (stage == 0) prefetch_ring<KV>(P, l);
        grid_arrive(P.sync);
        ring.refill(P, rank, cl);
        grid_wait(P.sync, ++barriers * gridDim.x);
      }
    }
  }
  if (threadIdx.x == 0 && atomicAdd(P.sync + 1, 1u) == gridDim.x - 1) {
    P.sync[0] = 0;   // every CTA has passed every barrier: the counters go back to zero
    P.sync[1] = 0;
  }
  stamp_wall(P, 1);
}

template <typename W, typename KV, int R>
int launch_r(Params& p, cudaStream_t stream, int* grid_out, bool query) {
  const auto kern = decode_stack_kernel<W, KV, R>;
  static int clusters = 0;   // clusters that can be resident at once, found once
  if (clusters == 0) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = kCluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster * 256);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kSmemBytes;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (n < 1) return (int)cudaErrorCooperativeLaunchTooLarge;   // refused, not deadlocked
    clusters = n;
  }
  if (grid_out) *grid_out = clusters * kCluster;
  if (query) return 0;
  p.ncl = clusters;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, p);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <typename W, typename KV>
int launch(Params& p, cudaStream_t stream, int* grid_out, bool query) {
  if (p.B == 1) return launch_r<W, KV, 1>(p, stream, grid_out, query);
  if (p.B == 2) return launch_r<W, KV, 2>(p, stream, grid_out, query);
  if (p.B <= 4) return launch_r<W, KV, 4>(p, stream, grid_out, query);
  return launch_r<W, KV, 8>(p, stream, grid_out, query);
}

}  // namespace

extern "C" {

// ptrs, in order: x, wqkv, wproj, w1, w2, sqkv, bqkv, sproj, bproj, s1, b1, s2,
// b2, ln, k, v, ks, vs, index, pad, kq, vq, ksn, vsn, qkv, att, hid, sync,
// stamps (29 device pointers; layouts in Params; stamps may be null; sync: two
// unsigned ints, zero before the first call, left zero). dims: L, B, T, D, H,
// nh, then the tile bytes (16 to 256, a power of two) and box rows of qkv,
// proj, fc, out (ops/decode_block.stage_plan): a box's rows divide K / 4, at
// most 256, a box holds at most 16 KB, and a tile's K / 4 rows take at most 8
// boxes. Weights int8 or bf16; rings and fresh rows
// int8 or bf16. Heads of 64 features; D a multiple of 128 and at most 2048, H
// a multiple of 128 and at most 5120. grid_out (host, may be null) receives the
// number of CTAs. With null ptrs the call launches nothing and only reports the
// grid it would take.
int decode_stack(const void* const* ptrs, const int* dims, int weights_bf16, int kv_bf16,
                 void* stream, int* grid_out) {
  Params p = {};
  const bool query = ptrs == nullptr;
  const void* const none[29] = {};
  if (query) ptrs = none;
  int i = 0;
  p.x = (float*)ptrs[i++];
  const void* w[4];
  for (int q = 0; q < 4; ++q) w[q] = ptrs[i++];
  for (int q = 0; q < 4; ++q) {
    p.scale[q] = (const float*)ptrs[i++];
    p.bias[q] = (const float*)ptrs[i++];
  }
  p.ln = (const float*)ptrs[i++];
  p.k = ptrs[i++]; p.v = ptrs[i++];
  p.ks = (const float*)ptrs[i++]; p.vs = (const float*)ptrs[i++];
  p.index = (const int*)ptrs[i++]; p.pad = (const int*)ptrs[i++];
  p.kq = (void*)ptrs[i++]; p.vq = (void*)ptrs[i++];
  p.ksn = (float*)ptrs[i++]; p.vsn = (float*)ptrs[i++];
  p.qkv = (float*)ptrs[i++]; p.att = (float*)ptrs[i++]; p.hid = (float*)ptrs[i++];
  p.sync = (unsigned*)ptrs[i++];
  p.stamps = (long long*)ptrs[i++];
  p.L = dims[0]; p.B = dims[1]; p.T = dims[2]; p.D = dims[3]; p.H = dims[4]; p.nh = dims[5];
  const int isz = weights_bf16 ? 2 : 1;
  if (p.L < 1 || p.B < 1 || p.B > 8 || p.T < 1 || p.nh < 1) return (int)cudaErrorInvalidValue;
  if (p.D != kHd * p.nh || p.D % 128 || p.D > kDMax || p.H < 128 || p.H % 128 ||
      p.H > kCluster * kKcMax)
    return (int)cudaErrorInvalidValue;
  p.tiles_layer = 0;
  for (int q = 0; q < 4; ++q) {
    p.twb[q] = dims[6 + q];
    p.br[q] = dims[10 + q];
    const int K = q == 3 ? p.H : p.D, N = q == 0 ? 3 * p.D : q == 2 ? p.H : p.D;
    const int twb = p.twb[q], br = p.br[q];
    if ((twb != 16 && twb != 32 && twb != 64 && twb != 128 && twb != 256) || br < 1 || br > 256 ||
        (K / kCluster) % br || twb * br > kSlotBytes || K / kCluster / br > kSlots)
      return (int)cudaErrorInvalidValue;
    p.tiles[q] = (N * isz + twb - 1) / twb;
    p.prefix[q] = p.tiles_layer;
    p.tiles_layer += p.tiles[q];
    if (!query) {
      const long long row_bytes = (long long)N * isz;
      const int err = map_2d(&p.maps[q], w[q], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, row_bytes,
                             (long long)p.L * K, row_bytes, twb, br, CU_TENSOR_MAP_SWIZZLE_NONE);
      if (err != 0) return err;
    }
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (weights_bf16)
    return kv_bf16 ? launch<bf16, bf16>(p, s, grid_out, query)
                   : launch<bf16, int8_t>(p, s, grid_out, query);
  return kv_bf16 ? launch<int8_t, bf16>(p, s, grid_out, query)
                 : launch<int8_t, int8_t>(p, s, grid_out, query);
}

}  // extern "C"
