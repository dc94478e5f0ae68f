// The whole GPT-2 block stack for one token of up to 8 decode streams, sm_90a.
//
// Replaces the TPU kernel of summer_clip_tpu/ops/decode_block.py:
//   K8 decode_block -> decode_block (one cooperative launch)
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
// beside them the fixed cost of a stage. The TPU kernel is a sequential
// (layer, stage) grid on one core with the activations in VMEM; here the
// weights can only be pulled by all SMs at once, so the kernel is persistent
// (one block an SM, launched cooperatively) and every stage is spread over the
// grid, with a grid-wide barrier between stages: 5 a block (qkv | attention |
// proj | fc | out), 5 L - 1 a token. Activations between stages (at most
// 8 x H f32) live in a small workspace that stays in L2. A stage is a chain of
// waits (the input rows from L2, the weights, the partials, the ticket), so
// every loop issues its loads in batches before the first use, and a block asks
// L2 for the weights of the product after the coming stage before it enters a
// barrier. Measured on an H100 (tools/torch_k8_stages.py): 6-10 us a stage at
// one stream, of which the barrier is about 1.2 us.
//
// Products: K7's tiling (gemv_kernels.cu). A work item is (128-column tile,
// K chunk); the chunk size depends on the geometry only, so a stream's sums do
// not depend on its companions. A block's 32 row lanes add in a fixed order;
// where K is split the partials go to the workspace and the block that arrives
// last at a column tile (integer ticket, no float atomics) adds them in split
// order and applies scale, bias and the stage's epilogue (store, GELU, or
// residual add in place). So two runs give the same bits.
//
// Attention: a (stream, head) pair is a unit of work. A thread owns a ring row
// of the 256-row pass for the scores, then the threads regroup as (row group,
// 4 features) for the weighted sum of V; a pass loads its K row and its pieces
// of V before it computes. Only passes that hold live rows are read, and of
// those only the live rows: index and pad are read on the device, never on the
// host.
//
// The entry point returns the launch's error; it refuses a grid that cannot be
// co-resident instead of deadlocking in a barrier.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gemv_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = 8;                 // 16-byte column groups of a tile
constexpr int kLanes = kThreads / kGroups; // rows of a chunk walked side by side
constexpr int kMaxChunk = 1024;            // rows of K a block keeps in shared memory
constexpr int kTc = 256;                   // ring rows a pass of the attention takes
constexpr int kHd = 64;                    // features of a head (every GPT-2 has 64)
constexpr int kTicketStride = 1024;        // tickets a stage owns
constexpr float kNeg = -1e30f;
// a block's staged rows of x (8 x kMaxChunk), reused for the warps' sums
// (warps x 8 rows x a padded tile of 8 x 17 floats: a lane's 16 columns sit 17
// apart, so the lanes of a store fall on different banks)
constexpr int kXsFloats = kWarps * 8 * kGroups * 17;
static_assert(kXsFloats >= 8 * kMaxChunk, "the staged rows must fit");
constexpr int kSmemFloats = kXsFloats + 16;
constexpr int kLnRegs = 64;                // a lane holds a LayerNorm row of up to 32 x 64 in registers

enum { IN_LN = 0, IN_PLAIN = 1 };
enum { OUT_STORE = 0, OUT_GELU = 1, OUT_RESIDUAL = 2 };

struct Params {
  float* x;                                   // (B, D) residual stream, in place: y at the end
  const void *wqkv, *wproj, *w1, *w2;         // (L, K, N) as stored
  const float *sqkv, *bqkv, *sproj, *bproj, *s1, *b1, *s2, *b2;   // (L, 1, N)
  const float* ln;                            // (L, 4, D)
  const void *k, *v;                          // (L, B, T, D)
  const float *ks, *vs;                       // (L, B, T, 1)
  const int *index, *pad;                     // (B)
  void *kq, *vq;                              // (L, B, D) out
  float *ksn, *vsn;                           // (L, B, 1) out
  float *qkv, *att, *hid, *part;              // workspace
  int* tickets;
  long long* stamps;   // null, or (L, 5 stages, {start, end of this block's work}, grid) SM cycle
                       // counts and then block 0's globaltimer (ns) at its start and end
  int L, B, T, D, H, nh;
  int chunk_qkv, chunk_proj, chunk_fc, chunk_out;
};

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

__device__ __forceinline__ void emit(float v, float* out, size_t i, int mode) {
  if (mode == OUT_STORE) out[i] = v;
  else if (mode == OUT_GELU) out[i] = gelu_tanh(v);
  else out[i] = __ldcg(out + i) + v;
}

// One product stage over the grid: out (rows, N) <- epilogue((in' (rows, K) . w
// (K, N)) * scale + bias), in' = bf16(LN(in)) or bf16(in). A block takes the
// items blockIdx.x, blockIdx.x + gridDim.x, ...; item = (column tile, K chunk).
template <typename W, int R>
__device__ __noinline__ void gemv_stage(const float* in, int in_mode, const float* gamma,
                                        const float* beta, const W* __restrict__ w,
                                        const float* __restrict__ scale,
                                        const float* __restrict__ bias, float* out, int out_mode,
                                        float* part, int* tickets, int rows, int K, int N,
                                        int chunk, float* sm) {
  constexpr int V = Vec<W>::n;
  constexpr int TILE = kGroups * V;
  __shared__ int is_last;
  constexpr int TILEP = kGroups * (V + 1);   // a tile's columns, each lane's padded by one
  float* xs = sm;                      // (R, kMaxChunk), then the warps' sums
  float* mu = sm + kXsFloats;          // (8) row means
  float* rs = mu + 8;                  // (8) 1 / sqrt(var + eps)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ctiles = (N + TILE - 1) / TILE;
  const int splits = (K + chunk - 1) / chunk;
  const int items = ctiles * splits;
  if ((int)blockIdx.x >= items) return;

  if (in_mode == IN_LN && warp < rows) {   // warp r: the statistics of row r, two passes
    const float* row = in + (size_t)warp * K;
    float mean, var;
    if (K <= 32 * kLnRegs) {
      // the row in registers: every load is issued before the first is used,
      // so the warp waits for L2 once, not once a loop round
      float v[kLnRegs];
#pragma unroll
      for (int j = 0; j < kLnRegs; ++j) v[j] = j * 32 + lane < K ? __ldcg(row + j * 32 + lane) : 0.f;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kLnRegs; ++j) s += v[j];
      mean = warp_sum(s) / (float)K;
      float q = 0.f;
#pragma unroll
      for (int j = 0; j < kLnRegs; ++j) {
        const float d = j * 32 + lane < K ? v[j] - mean : 0.f;
        q += d * d;
      }
      var = warp_sum(q) / (float)K;
    } else {
      float s = 0.f;
      for (int i = lane; i < K; i += 32) s += __ldcg(row + i);
      mean = warp_sum(s) / (float)K;
      float q = 0.f;
      for (int i = lane; i < K; i += 32) {
        const float d = __ldcg(row + i) - mean;
        q += d * d;
      }
      var = warp_sum(q) / (float)K;
    }
    if (lane == 0) {
      mu[warp] = mean;
      rs[warp] = 1.f / sqrtf(var + 1e-5f);
    }
  }

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int ct = item % ctiles, sp = item / ctiles;
    const int kb = sp * chunk;
    const int len = min(K, kb + chunk) - kb;
    __syncthreads();   // the statistics are written; the last item's sums are read
    for (int base = tid; base < R * len; base += 4 * kThreads) {   // four loads in flight
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = base + u * kThreads, r = i / len;
        v[u] = i < R * len && r < rows ? __ldcg(in + (size_t)r * K + kb + i % len) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = base + u * kThreads, r = i / len, k = i % len;
        if (i >= R * len) break;
        if (in_mode == IN_LN && r < rows)
          v[u] = (v[u] - mu[r]) * rs[r] * gamma[kb + k] + beta[kb + k];
        xs[r * kMaxChunk + k] = round_bf16(v[u]);
      }
    }
    __syncthreads();

    const int c0 = ct * TILE;
    const int col = c0 + (lane & (kGroups - 1)) * V;
    const int klane = warp * (32 / kGroups) + lane / kGroups;
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
          load_cols<W, true>(wp + (size_t)(k + u * kLanes) * N, col, N, f[u]);
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
      if constexpr (R <= 4) {
        // a short last batch in one go: its rows past the chunk read the
        // chunk's last row again and count with x = 0 (U loads, then U uses)
        if (k < len) {
          float f[U][V];
#pragma unroll
          for (int u = 0; u < U; ++u)
            load_cols<W, true>(wp + (size_t)min(k + u * kLanes, len - 1) * N, col, N, f[u]);
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int kk = k + u * kLanes;
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float xv = kk < len ? xs[r * kMaxChunk + min(kk, len - 1)] : 0.f;
#pragma unroll
              for (int j = 0; j < V; ++j) acc[r][j] = fmaf(xv, f[u][j], acc[r][j]);
            }
          }
        }
      } else {   // more streams: the registers hold the sums, so a row at a time
        for (; k < len; k += kLanes) {
          float f[V];
          load_cols<W, true>(wp + (size_t)k * N, col, N, f);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float xv = xs[r * kMaxChunk + k];
#pragma unroll
            for (int j = 0; j < V; ++j) acc[r][j] = fmaf(xv, f[j], acc[r][j]);
          }
        }
      }
    }
    // the k lanes in a fixed order: shuffles inside the warp, then the warps
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], kGroups);
        acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], 2 * kGroups);
      }
    }
    __syncthreads();
    float* red = xs;   // (warps, R, TILEP)
    if (lane < kGroups) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int j = 0; j < V; ++j) red[(warp * R + r) * TILEP + lane * (V + 1) + j] = acc[r][j];
      }
    }
    __syncthreads();
    const int width = min(N - c0, TILE);
    for (int i = tid; i < rows * width; i += kThreads) {
      const int r = i / width, cl = i % width, c = c0 + cl;
      float sum = 0.f;
#pragma unroll
      for (int wv = 0; wv < kWarps; ++wv) sum += red[(wv * R + r) * TILEP + cl / V * (V + 1) + cl % V];
      if (splits == 1)
        emit(sum * scale[c] + bias[c], out, (size_t)r * N + c, out_mode);
      else
        part[((size_t)sp * rows + r) * N + c] = sum;
    }
    if (splits == 1) continue;

    __threadfence();
    __syncthreads();
    if (tid == 0) is_last = atomicAdd(&tickets[ct], 1) == splits - 1;
    __syncthreads();
    if (!is_last) continue;
    __threadfence();
    // the last block at this column tile: the partials in split order. A
    // thread owns up to OPT outputs and keeps four splits of each in flight.
    constexpr int OPT = (R * TILE + kThreads - 1) / kThreads;
    const size_t step = (size_t)rows * N;
    size_t off[OPT];
    float sum[OPT];
#pragma unroll
    for (int o = 0; o < OPT; ++o) {
      const int i = tid + o * kThreads;
      off[o] = i < rows * width ? (size_t)(i / width) * N + c0 + i % width : (size_t)-1;
      sum[o] = 0.f;
    }
    for (int s = 0; s < splits; s += 4) {
      float v[4][OPT];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int o = 0; o < OPT; ++o)
          v[q][o] = s + q < splits && off[o] != (size_t)-1 ? __ldcg(part + (s + q) * step + off[o])
                                                            : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int o = 0; o < OPT; ++o) sum[o] += v[q][o];
      }
    }
#pragma unroll
    for (int o = 0; o < OPT; ++o) {
      if (off[o] != (size_t)-1) {
        const int c = c0 + (tid + o * kThreads) % width;
        emit(sum[o] * scale[c] + bias[c], out, off[o], out_mode);
      }
    }
    if (tid == 0) tickets[ct] = 0;
  }
}

// Ask L2 for the weights of this block's first work item of a coming stage (a
// 128-byte line a row of the chunk), so that the stage finds them there after
// the barrier and its prologue instead of waiting for device memory then.
template <typename W>
__device__ __forceinline__ void prefetch_stage(const W* w, int K, int N, int chunk) {
  constexpr int TILE = kGroups * Vec<W>::n;
  const int ctiles = (N + TILE - 1) / TILE;
  const int splits = (K + chunk - 1) / chunk;
  if ((int)blockIdx.x >= ctiles * splits) return;
  const int ct = blockIdx.x % ctiles, kb = (blockIdx.x / ctiles) * chunk;
  const int len = min(K, kb + chunk) - kb;
  for (int r = threadIdx.x; r < len; r += kThreads)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(w + (size_t)(kb + r) * N + ct * TILE));
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

// The attention stage: unit = (stream, head), units blockIdx.x, + gridDim.x, ...
template <typename KV>
__device__ __noinline__ void attention_stage(const Params& p, int layer, float* sm) {
  constexpr bool INT8 = sizeof(KV) == 1;
  constexpr int V = Vec<KV>::n;
  constexpr int hd = kHd;
  const int tid = threadIdx.x;
  const int D = p.D, T = p.T, B = p.B, nh = p.nh;
  float* qb = sm;                 // (hd) bf16(q / sqrt(hd))
  float* acc = sm + kHd;          // (hd)
  float* pv = sm + 2 * kHd;       // (kTc) bf16(p * vs); first the fresh row's score terms
  float* red = pv + kTc;          // (row groups, hd)
  float* scratch = red + kThreads * 4;
  constexpr int ng = hd / 4;          // threads a row of V takes, 4 features each
  constexpr int nrg = kThreads / ng;  // row groups

  for (int u = blockIdx.x; u < B * nh; u += gridDim.x) {
    const int b = u / nh, h = u % nh;
    const float* row = p.qkv + (size_t)b * 3 * D;
    __syncthreads();   // the last unit's shared values are read
    float ksc = 1.f, vsc = 1.f;
    if (INT8) {        // per-row scales: the largest |k| and |v| of the whole row
      float km = 0.f, vm = 0.f;
      for (int i = tid; i < D; i += kThreads) {
        km = fmaxf(km, fabsf(__ldcg(row + D + i)));
        vm = fmaxf(vm, fabsf(__ldcg(row + 2 * D + i)));
      }
      // times the f32 reciprocal, as the plain version computes it
      ksc = fmaxf(block_reduce<true>(km, scratch), 1e-12f) * (1.f / 127.f);
      vsc = fmaxf(block_reduce<true>(vm, scratch), 1e-12f) * (1.f / 127.f);
      __syncthreads();
    }
    const size_t fresh = ((size_t)layer * B + b) * D + h * hd;
    if (tid < hd) {
      const int d = h * hd + tid;
      const float kq = store_fresh(reinterpret_cast<KV*>(p.kq) + fresh + tid, __ldcg(row + D + d), ksc);
      const float vq = store_fresh(reinterpret_cast<KV*>(p.vq) + fresh + tid, __ldcg(row + 2 * D + d), vsc);
      qb[tid] = round_bf16(__ldcg(row + d) / sqrtf((float)hd));
      acc[tid] = vsc * vq;                       // the fresh row as stored, weight 1
      pv[tid] = round_bf16(kq * ksc) * qb[tid];
    }
    if (h == 0 && tid == 0) {
      p.ksn[(size_t)layer * B + b] = ksc;
      p.vsn[(size_t)layer * B + b] = vsc;
    }
    __syncthreads();
    float m = 0.f, l = 1.f;
    for (int d = 0; d < hd; ++d) m += pv[d];     // the fresh row's score, the same in every thread

    const int idx = min(max(p.index[b], 0), T);
    const int padv = max(p.pad[b], 0);
    const size_t ring = ((size_t)layer * B + b) * T;
    const KV* kring = reinterpret_cast<const KV*>(p.k) + ring * D + h * hd;
    const KV* vring = reinterpret_cast<const KV*>(p.v) + ring * D + h * hd;
    const int rg = tid / ng, dg = tid % ng;   // this thread's place in the weighted sum of V
    for (int c0 = (padv / kTc) * kTc; c0 < idx; c0 += kTc) {
      constexpr int KP = hd / V;       // 16-byte pieces of a K row
      constexpr int VR = kTc / nrg;    // rows of V a thread takes in a pass
      const int r = c0 + tid;
      const bool valid = r < idx && r >= padv;
      const int last = min(kTc, idx - c0);
      // every load of the pass before any use: the thread's K row with its
      // scales, and its pieces of V, so that the pass waits for memory once
      uint4 kraw[KP];
      decltype(load_raw4(vring)) vraw[VR];
      float ksb = 0.f, vsr = 0.f;
      if (valid) {
        const KV* kp = kring + (size_t)r * D;
        ksb = p.ks[ring + r];
        vsr = p.vs[ring + r];
#pragma unroll
        for (int u = 0; u < KP; ++u) kraw[u] = *reinterpret_cast<const uint4*>(kp + u * V);
      }
      if (tid < ng * nrg) {
#pragma unroll
        for (int u = 0; u < VR; ++u) {
          const int rr = rg + u * nrg;
          if (rr < last && c0 + rr >= padv)
            vraw[u] = load_raw4(vring + (size_t)(c0 + rr) * D + dg * 4);
        }
      }
      float sc = kNeg;
      if (valid) {
        ksb = round_bf16(ksb);
        float s = 0.f;
#pragma unroll
        for (int u = 0; u < KP; ++u) {
          float f[V];
          Vec<KV>::unpack(kraw[u], f);
#pragma unroll
          for (int e = 0; e < V; ++e) s = fmaf(round_bf16(f[e] * ksb), qb[u * V + e], s);
        }
        sc = s;
      }
      const float mnew = fmaxf(m, block_reduce<true>(sc, scratch));
      const float alpha = expf(m - mnew);
      const float pr = valid ? expf(sc - mnew) : 0.f;
      pv[tid] = valid ? round_bf16(pr * vsr) : 0.f;
      l = l * alpha + block_reduce<false>(pr, scratch);   // its barriers also publish pv
      if (tid < ng * nrg) {
        float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int u = 0; u < VR; ++u) {   // in row order
          const int rr = rg + u * nrg;
          if (rr < last && c0 + rr >= padv) {
            const float wgt = pv[rr];
            float f[4];
            unpack4(vraw[u], f);
#pragma unroll
            for (int e = 0; e < 4; ++e) a[e] += round_bf16(wgt * f[e]);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) red[rg * hd + dg * 4 + e] = a[e];
      }
      __syncthreads();
      if (tid < hd) {
        float s = 0.f;
        for (int g = 0; g < nrg; ++g) s += red[g * hd + tid];
        acc[tid] = acc[tid] * alpha + s;
      }
      m = mnew;
    }
    __syncthreads();
    if (tid < hd) p.att[(size_t)b * D + h * hd + tid] = acc[tid] / l;
  }
}

__device__ __forceinline__ void stamp(const Params& p, int layer, int stage, int end) {
  if (p.stamps && threadIdx.x == 0)
    p.stamps[(((size_t)layer * 5 + stage) * 2 + end) * gridDim.x + blockIdx.x] = clock64();
}

__device__ __forceinline__ void stamp_wall(const Params& p, int end) {
  if (p.stamps && threadIdx.x == 0 && blockIdx.x == 0) {
    long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    p.stamps[(size_t)p.L * 10 * gridDim.x + end] = ns;
  }
}

// One of a block's four products: 0 qkv, 2 proj, 3 fc, 4 out (1 is the attention).
template <typename W> struct Product {
  const float *in, *gamma, *beta, *scale, *bias;
  const W* w;
  float* out;
  int in_mode, out_mode, K, N, chunk;
};

template <typename W>
__device__ __forceinline__ Product<W> product(const Params& p, int l, int stage) {
  const int D = p.D, H = p.H;
  const float* ln = p.ln + (size_t)l * 4 * D;
  Product<W> s;
  if (stage == 0) {
    s = {p.x, ln, ln + D, p.sqkv + (size_t)l * 3 * D, p.bqkv + (size_t)l * 3 * D,
         reinterpret_cast<const W*>(p.wqkv) + (size_t)l * D * 3 * D, p.qkv, IN_LN, OUT_STORE, D,
         3 * D, p.chunk_qkv};
  } else if (stage == 2) {
    s = {p.att, nullptr, nullptr, p.sproj + (size_t)l * D, p.bproj + (size_t)l * D,
         reinterpret_cast<const W*>(p.wproj) + (size_t)l * D * D, p.x, IN_PLAIN, OUT_RESIDUAL, D, D,
         p.chunk_proj};
  } else if (stage == 3) {
    s = {p.x, ln + 2 * D, ln + 3 * D, p.s1 + (size_t)l * H, p.b1 + (size_t)l * H,
         reinterpret_cast<const W*>(p.w1) + (size_t)l * D * H, p.hid, IN_LN, OUT_GELU, D, H,
         p.chunk_fc};
  } else {
    s = {p.hid, nullptr, nullptr, p.s2 + (size_t)l * D, p.b2 + (size_t)l * D,
         reinterpret_cast<const W*>(p.w2) + (size_t)l * H * D, p.x, IN_PLAIN, OUT_RESIDUAL, H, D,
         p.chunk_out};
  }
  return s;
}

// The stages run as one loop; the product and the attention stay out of line
// (inlined, each kernel held four copies of the product: no faster at one
// stream, and slower at eight, on an H100).
template <typename W, typename KV, int R>
__global__ void __launch_bounds__(kThreads)
decode_block_kernel(const __grid_constant__ Params p) {
  __shared__ __align__(16) float sm[kSmemFloats];
  cg::grid_group grid = cg::this_grid();
  stamp_wall(p, 0);
  for (int l = 0; l < p.L; ++l) {
    for (int stage = 0; stage < 5; ++stage) {
      stamp(p, l, stage, 0);
      if (stage == 1) {
        attention_stage<KV>(p, l, sm);
      } else {
        const Product<W> s = product<W>(p, l, stage);
        gemv_stage<W, R>(s.in, s.in_mode, s.gamma, s.beta, s.w, s.scale, s.bias, s.out,
                         s.out_mode, p.part, p.tickets + stage * kTicketStride, p.B, s.K, s.N,
                         s.chunk, sm);
      }
      stamp(p, l, stage, 1);
      if (l + 1 == p.L && stage == 4) break;
      // ask L2 for the weights of the product after the coming stage
      const int ahead = stage == 3 ? 0 : stage + 2;
      if (stage != 4 && (stage != 3 || l + 1 < p.L)) {
        const Product<W> s = product<W>(p, stage == 3 ? l + 1 : l, ahead);
        prefetch_stage(s.w, s.K, s.N, s.chunk);
      }
      grid.sync();
    }
  }
  stamp_wall(p, 1);
}

template <typename W, typename KV, int R>
int launch_r(const Params& p, cudaStream_t stream, int* grid_out, bool query) {
  int dev = 0, sms = 0, coop = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, decode_block_kernel<W, KV, R>,
                                                      kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (occ < 1) return (int)cudaErrorCooperativeLaunchTooLarge;   // refused, not deadlocked
  const int grid = sms;   // one block an SM (two were slower where they fitted)
  if (grid_out) *grid_out = grid;
  if (query) return 0;
  Params copy = p;
  void* args[] = {&copy};
  err = cudaLaunchCooperativeKernel((void*)decode_block_kernel<W, KV, R>, dim3(grid),
                                    dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename W, typename KV>
int launch(const Params& p, cudaStream_t stream, int* grid_out, bool query) {
  if (p.B == 1) return launch_r<W, KV, 1>(p, stream, grid_out, query);
  if (p.B == 2) return launch_r<W, KV, 2>(p, stream, grid_out, query);
  if (p.B <= 4) return launch_r<W, KV, 4>(p, stream, grid_out, query);
  return launch_r<W, KV, 8>(p, stream, grid_out, query);
}

}  // namespace

extern "C" {

// ptrs, in order: x, wqkv, wproj, w1, w2, sqkv, bqkv, sproj, bproj, s1, b1, s2,
// b2, ln, k, v, ks, vs, index, pad, kq, vq, ksn, vsn, qkv, att, hid, part,
// tickets, stamps (30 device pointers; layouts in Params; stamps may be null). dims: L, B, T, D, H, nh,
// chunk_qkv, chunk_proj, chunk_fc, chunk_out (rows of K a work item of each
// product takes, a multiple of 32, at most 1024). Weights int8 or bf16; rings
// and fresh rows int8 or bf16. part: at least max over the four products of
// ceil(K / chunk) * B * N floats; tickets: 8192 ints, zero before the first
// call (the kernel leaves them zero). Heads of 64 features.
// grid_out (host, may be null) receives the number of blocks. With null ptrs
// the call launches nothing and only reports the grid it would take.
int decode_block(const void* const* ptrs, const int* dims, int weights_bf16, int kv_bf16,
                 void* stream, int* grid_out) {
  Params p = {};
  const bool query = ptrs == nullptr;
  const void* const none[30] = {};
  if (query) ptrs = none;
  int i = 0;
  p.x = (float*)ptrs[i++];
  p.wqkv = ptrs[i++]; p.wproj = ptrs[i++]; p.w1 = ptrs[i++]; p.w2 = ptrs[i++];
  p.sqkv = (const float*)ptrs[i++]; p.bqkv = (const float*)ptrs[i++];
  p.sproj = (const float*)ptrs[i++]; p.bproj = (const float*)ptrs[i++];
  p.s1 = (const float*)ptrs[i++]; p.b1 = (const float*)ptrs[i++];
  p.s2 = (const float*)ptrs[i++]; p.b2 = (const float*)ptrs[i++];
  p.ln = (const float*)ptrs[i++];
  p.k = ptrs[i++]; p.v = ptrs[i++];
  p.ks = (const float*)ptrs[i++]; p.vs = (const float*)ptrs[i++];
  p.index = (const int*)ptrs[i++]; p.pad = (const int*)ptrs[i++];
  p.kq = (void*)ptrs[i++]; p.vq = (void*)ptrs[i++];
  p.ksn = (float*)ptrs[i++]; p.vsn = (float*)ptrs[i++];
  p.qkv = (float*)ptrs[i++]; p.att = (float*)ptrs[i++]; p.hid = (float*)ptrs[i++];
  p.part = (float*)ptrs[i++];
  p.tickets = (int*)ptrs[i++];
  p.stamps = (long long*)ptrs[i++];
  p.L = dims[0]; p.B = dims[1]; p.T = dims[2]; p.D = dims[3]; p.H = dims[4]; p.nh = dims[5];
  p.chunk_qkv = dims[6]; p.chunk_proj = dims[7]; p.chunk_fc = dims[8]; p.chunk_out = dims[9];
  if (p.L < 1 || p.B < 1 || p.B > 8 || p.T < 1 || p.nh < 1 || p.D < 16 || p.H < 16)
    return (int)cudaErrorInvalidValue;
  if (p.D != kHd * p.nh || p.H % 16) return (int)cudaErrorInvalidValue;
  const int chunks[4] = {p.chunk_qkv, p.chunk_proj, p.chunk_fc, p.chunk_out};
  for (int c = 0; c < 4; ++c)
    if (chunks[c] < 32 || chunks[c] > kMaxChunk || chunks[c] % 32) return (int)cudaErrorInvalidValue;
  if (3 * p.D / 64 + 1 > kTicketStride || p.H / 64 + 1 > kTicketStride)   // 5 x 1024 <= 8192 tickets
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (weights_bf16)
    return kv_bf16 ? launch<bf16, bf16>(p, s, grid_out, query)
                   : launch<bf16, int8_t>(p, s, grid_out, query);
  return kv_bf16 ? launch<int8_t, bf16>(p, s, grid_out, query)
                 : launch<int8_t, int8_t>(p, s, grid_out, query);
}

}  // extern "C"
