// Device code shared by K7 and K10 (gemv_kernels.cu) and K8 (decode_kernels.cu): a box
// of weight rows that TMA wrote to shared memory, times the staged bf16 rows of
// x; the sums of a column tile in a fixed order, first inside the CTA, then over
// the CTAs of a thread-block cluster that split the tile's K.
//
// A box is `rows` weight rows of `twb` bytes (16 to 256), as TMA writes
// a 2-D box without swizzle: row k at byte k * twb. 256 threads walk it as g =
// twb / 16 column groups of 16 bytes by 256 / g row lanes: lane = sub * g + gq,
// and row lane rl = warp * (32 / g) + sub takes rows rl, rl + 256 / g, ... A
// warp reads 512 contiguous bytes a step, so no two lanes meet on a bank.
//
// Sum order (what keeps a row's result independent of its companions and of
// the run): each thread adds its rows in row order; the row lanes of a warp by
// xor shuffles; the warps in warp order; the cluster's ranks in rank order. It
// depends on (twb, box rows, K split) only, which the host picks from the
// matrix's geometry. Across the cluster the sums are pushed: sum i of the tile
// goes to rank i % split, into its receive buffer at [sender rank][i / split]
// (a store to distributed shared memory), so that after one cluster barrier
// every rank adds its own sums from local shared memory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemv_common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int kRingThreads = 256;
constexpr int kRingWarps = kRingThreads / 32;

struct BoxLanes {
  int g, gq, rl, nl;
  __device__ __forceinline__ explicit BoxLanes(int twb) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    g = twb >> 4;
    gq = lane % g;
    rl = warp * (32 / g) + lane / g;
    nl = kRingThreads / g;
  }
};

// acc[r][j] += xs[r * xstride + k] * w[k][gq * V + j] over the rows of nb
// boxes of `rows` rows each: box j in ring slot (n0 + j) % nslots (n0 <
// nslots, nb <= nslots), its rows following box j - 1's in xs. The boxes are
// the inner loop, so a thread has nb independent loads in flight.
template <typename W, int R>
__device__ __forceinline__ void boxes_fma(const unsigned char* ring, int slot_bytes, int nslots,
                                          int n0, int nb, int twb, int rows, const float* xs,
                                          int xstride, const BoxLanes& bl,
                                          float (&acc)[R][Vec<W>::n]) {
  constexpr int V = Vec<W>::n;
  for (int k = bl.rl; k < rows; k += bl.nl) {
#pragma unroll 4
    for (int j = 0; j < nb; ++j) {
      const int slot = n0 + j < nslots ? n0 + j : n0 + j - nslots;
      const uint4 raw = *reinterpret_cast<const uint4*>(ring + (size_t)slot * slot_bytes +
                                                        (size_t)k * twb + bl.gq * 16);
      float f[V];
      Vec<W>::unpack(raw, f);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float xv = xs[r * xstride + j * rows + k];
#pragma unroll
        for (int e = 0; e < V; ++e) acc[r][e] = fmaf(xv, f[e], acc[r][e]);
      }
    }
  }
}

// Reduce-scatter over a warp's row lanes (xor offsets O, O / 2, .. G): at each
// offset a lane keeps half of the n sums it holds (the upper half if its lane
// bit is set) and adds the partner's copy of that half; once a lane holds one
// sum the remaining offsets add it whole. Every sum meets the same partners in
// the same order whatever n is. base: the first index the lane ends holding;
// dup: the lane bits whose lanes end holding the same sums.
template <int N, int O, int G>
__device__ __forceinline__ void reduce_scatter(float* a, int lane, int& base, int& dup) {
  if constexpr (O >= G) {
    if constexpr (N >= 2) {
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int k = 0; k < N / 2; ++k) {
        const float keep = up ? a[k + N / 2] : a[k];
        const float send = up ? a[k] : a[k + N / 2];
        a[k] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      if (up) base += N / 2;
      reduce_scatter<N / 2, O / 2, G>(a, lane, base, dup);
    } else {
      a[0] += __shfl_xor_sync(0xffffffffu, a[0], O);
      dup |= O;
      reduce_scatter<1, O / 2, G>(a, lane, base, dup);
    }
  }
}

// Column c of a tile's row as it lies in red. Swizzled (kSwz, for 16 columns a
// lane group, int8 weights): c's place in its 16-column group XORed with
// (c / 32) % 16, so that lanes of one warp holding the same place of
// different groups store to different banks; without it a row of 256 bytes
// puts 16 lanes of a store on one bank.
template <bool kSwz>
__device__ __forceinline__ int red_col(int c) {
  return kSwz ? c ^ ((c >> 5) & 15) : c;
}

// kSwz also flattens the accumulator column-major (the first halvings of the
// reduce-scatter split columns, not rows, so the lanes that keep different
// halves store to different banks too); which lane adds a pair does not
// change its sum, so the bits are those of the row-major order.
template <typename W, int R, int G, bool kSwz>
__device__ __forceinline__ void warp_tile_sums(float (&acc)[R][Vec<W>::n], int gq, int tw,
                                               float* red) {
  constexpr int V = Vec<W>::n, N = R * V;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float a[N];
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = kSwz ? acc[i % R][i / R] : acc[i / V][i % V];
  int base = 0, dup = 0;
  reduce_scatter<N, 16, G>(a, lane, base, dup);
  constexpr int HELD = N >= 32 / G ? N / (32 / G) : 1;
  if ((lane & dup) == 0) {
#pragma unroll
    for (int k = 0; k < HELD; ++k) {
      const int i = base + k, r = kSwz ? i % R : i / V, e = kSwz ? i / R : i % V;
      red[(warp * R + r) * tw + red_col<kSwz>(gq * V + e)] = a[k];
    }
  }
}

// Each warp's sums of a tile of tw columns, red[(warp * R + r) * tw +
// red_col<kSwz>(c)]: the row lanes of a warp added by reduce-scatter shuffles.
template <typename W, int R, bool kSwz = false>
__device__ __forceinline__ void warp_sums(float (&acc)[R][Vec<W>::n], const BoxLanes& bl, int tw,
                                          float* red) {
  switch (bl.g) {
    case 1: warp_tile_sums<W, R, 1, kSwz>(acc, bl.gq, tw, red); break;
    case 2: warp_tile_sums<W, R, 2, kSwz>(acc, bl.gq, tw, red); break;
    case 4: warp_tile_sums<W, R, 4, kSwz>(acc, bl.gq, tw, red); break;
    case 8: warp_tile_sums<W, R, 8, kSwz>(acc, bl.gq, tw, red); break;
    default: warp_tile_sums<W, R, 16, kSwz>(acc, bl.gq, tw, red); break;
  }
}

// The sum over the warps, in warp order, of column c of row r of red.
template <int R, bool kSwz = false>
__device__ __forceinline__ float warps_sum(const float* red, int r, int c, int tw) {
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kRingWarps; ++w) s += red[(w * R + r) * tw + red_col<kSwz>(c)];
  return s;
}

// The CTA's sums of a tile of tw columns for rows r0 .. r0 + R - 1, sum i =
// (r0 + r) * tw + c for r0 + r < rows_out, pushed to its owner rank's receive
// buffer `recv` (split * stride floats: see above; split 1: recv[i]). red holds
// kRingWarps * R * tw floats. The row lanes of a warp by reduce-scatter
// shuffles, then the warps in order. The caller synchronises (the cluster, or
// the block at split 1) before recv is read, and the block before red is
// written again.
template <typename W, int R>
__device__ __forceinline__ void tile_sums(float (&acc)[R][Vec<W>::n], const BoxLanes& bl, int tw,
                                          int r0, int rows_out, float* red, float* recv, int split,
                                          int rank, int stride) {
  warp_sums<W, R>(acc, bl, tw, red);
  __syncthreads();
  for (int i = threadIdx.x; i < min(R, rows_out - r0) * tw; i += kRingThreads) {
    const float s = warps_sum<R>(red, i / tw, i % tw, tw);
    const int idx = r0 * tw + i;
    if (split == 1) recv[idx] = s;
    else
      st_cluster_u32(cluster_addr(smem_u32(recv + rank * stride + idx / split),
                                  (uint32_t)(idx % split)), __float_as_uint(s));
  }
}

// This rank's sum k (the tile's sum k * split + rank) over the ranks, in rank
// order, from its receive buffer.
__device__ __forceinline__ float rank_sum(const float* recv, int k, int split, int stride) {
  float s = 0.f;
  for (int q = 0; q < split; ++q) s += recv[q * stride + k];
  return s;
}

}  // namespace
