// Fused transformer-block halves for the CLIP towers (bf16, sm_90a).
//
// Replaces the TPU kernels of summer_clip_tpu/ops/block_kernels.py:
//   K5 fused_ln_attn  ->  ln_attn_heads (one block per (sequence, head))
//                         + linear_residual (out_proj + bias + residual)
//   K6 fused_ln_mlp   ->  ln_mlp (one block per 32- or 48-row tile, all D columns)
//   K9 fused_ln_mlp_chunked -> ln_mlp_wide at D = 1024 (a cluster of two CTAs
//                         per 64-row tile; see below)
//
// What bounds them on Hopper. The TPU keeps all four attention weights
// (4*D^2 bf16 = 4.7 MB at ViT-B) and both MLP weights resident in 16 MB of
// VMEM. A Hopper block has at most 227 KB of shared memory, so weights stream
// through shared memory in 64-wide K slices (L2-resident: every block reads
// the same weights), and the activations that the TPU keeps on chip stay on
// chip here too:
//   - K5: LN(x), the head's q/k/v (T x 64 each) and the score rows live only
//     in shared memory. The per-head output o (B, T, D) goes through device
//     memory once to the out_proj launch. Next step: fuse out_proj into the
//     head kernel (needs a cross-head reduction, e.g. a cluster/DSMEM sum).
//   - K6: the (MR, 4D) hidden never leaves the SM: it is produced 64 columns
//     at a time and consumed at once by c_proj, whose MR x D f32 accumulators
//     stay in registers (so D is 512 or 768). Next step: wgmma + TMA with a
//     larger row tile.
//   - K9 (the ViT-L/14 width, D = 1024, H = 4096): the MLP's 138 GFLOP at
//     B = 32, T = 257 take 0.14 ms at 989 TFLOP/s, but what binds it on the
//     card is the weights every row tile reads from L2 (below). Design (wgmma
//     + TMA, Hopper's own units): a cluster of two CTAs owns 64 rows; CTA r owns output
//     columns 512 r .. 512 r + 511 (64 x 512 f32 accumulators: 128 registers
//     a thread of two consumer warpgroups, each m64n128 x 2). LN(x) of the 64
//     rows stays in shared memory (128 KB) as the A operand of c_fc. The
//     hidden goes in chunks of 128: each CTA makes 64 of them (c_fc,
//     wgmma.m64n32k16, 32 a warpgroup), applies bias and QuickGELU and writes
//     the bf16 piece to its own and its partner's shared memory (distributed
//     shared memory; exact, since the hidden is rounded to bf16 before
//     c_proj), then both multiply the whole chunk (A from registers) into
//     their own columns (wgmma.m64n128k16). So the hidden is made once: the
//     MLP's operations and no more (the previous design remade it for each
//     512-column half: 1.5x). W1 and W2 tiles arrive by TMA (128-byte
//     swizzle, K-major as they lie: (out, in) weights are the B operands with
//     nothing transposed) into a 5-stage ring of 16 KB that refills itself:
//     the last warp to release a stage issues its next load (there is no
//     producer warp: a block of more than 256 threads caps a thread at 168
//     registers).
//     L2 reads: each CTA streams half of W1 and half of W2 (8.4 MB), 258 CTAs
//     at B = 32, T = 257: 2.2 GB a call (the previous design: 6.5 GB), about
//     0.68 ms at the ~3.2 TB/s the SMs take in (PERF.md). Multicast across
//     the row tiles of a larger cluster was not built: for K1 it was slower
//     (cache_kernels.cu). Taller row tiles would halve the reads. Every
//     output is summed in f32 over the
//     hidden in one fixed order (chunk by chunk, 16 deep steps in order), so
//     two runs agree bit for bit and a row does not depend on its neighbours.
// Weights and activations of K5/K6 are staged 16 bytes a thread, and the next
// weight slices are in flight (in registers, or by cp.async into a 3-stage
// ring) while the current one is multiplied; their products use WMMA bf16
// 16x16x16 tiles with f32 accumulation. Rounding points
// follow the JAX kernels: every dot is accumulated in f32 and rounded to bf16,
// the bias is added in bf16, LayerNorm runs in f32 with f32 scale and bias,
// QuickGELU is (bf16(1.702) * h) in bf16, sigmoid in f32 rounded to bf16, the
// product in bf16, and the residual add in bf16.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "hopper_common.cuh"   // mbarriers, TMA, wgmma, clusters (K9)

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kHeadDim = 64;
constexpr int kPad = 8;  // bf16 row padding of shared tiles (keeps 32-byte alignment)

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBc;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBr;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ uint4 ld16(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void st16(bf16* p, uint4 v) { *reinterpret_cast<uint4*>(p) = v; }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// A row of d bf16 values (d % 8 == 0, d <= kMaxRow) held in registers, 8 a
// lane per 16-byte load: lane l holds columns (l + 32 u) * 8 .. + 7 in v[8 u ..].
constexpr int kMaxRow = 1024;
constexpr int kRowVecs = kMaxRow / 256;

// mean and 1/sqrt(var + eps) of one row, f32, two passes over the registers
// (jnp.var is centred); v keeps the row for the caller
__device__ __forceinline__ void row_stats(const bf16* row, int d, float eps, int lane,
                                          float (&v)[8 * kRowVecs], float* mean_out,
                                          float* rstd_out) {
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < kRowVecs; ++u) {
    const int j = (lane + 32 * u) * 8;
    if (j < d) {
      const uint4 raw = ld16(row + j);
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        v[8 * u + t] = __bfloat162float(e[t]);
        s += v[8 * u + t];
      }
    }
  }
  const float mean = warp_sum(s) / d;
  float q = 0.f;
#pragma unroll
  for (int u = 0; u < kRowVecs; ++u) {
    if ((lane + 32 * u) * 8 < d) {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float c = v[8 * u + t] - mean;
        q += c * c;
      }
    }
  }
  const float var = warp_sum(q) / d;
  *mean_out = mean;
  *rstd_out = rsqrtf(var + eps);
}

// 8 LayerNorm outputs (x - mean) * rstd * w + b, f32, rounded to bf16 and packed;
// w and b are read as float4 (16-byte aligned f32 vectors)
__device__ __forceinline__ uint4 ln8(const float* x, float mean, float rstd,
                                     const float* __restrict__ w, const float* __restrict__ b) {
  const float4 w0 = reinterpret_cast<const float4*>(w)[0], w1 = reinterpret_cast<const float4*>(w)[1];
  const float4 b0 = reinterpret_cast<const float4*>(b)[0], b1 = reinterpret_cast<const float4*>(b)[1];
  const float ws[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  const float bs[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  uint4 out;
  bf16* o8 = reinterpret_cast<bf16*>(&out);
#pragma unroll
  for (int e = 0; e < 8; ++e) o8[e] = __float2bfloat16((x[e] - mean) * rstd * ws[e] + bs[e]);
  return out;
}

// ---------------------------------------------------------------------------
// K5 part 1: per (sequence, head): o_h = softmax(q_h k_h^T / sqrt(64)) v_h,
// with q/k/v = bf16(LN(x) @ W^T) + b computed in the block.
// ---------------------------------------------------------------------------
constexpr int kRowChunk = 16 * kWarps;  // rows per projection pass (4 x 2 warps of 32 x 96)
constexpr int kKc = 64;                  // K slice of the projection
constexpr int kQkvCols = 3 * kHeadDim;   // q | k | v columns of one head
constexpr int kColTiles = kQkvCols / 16;
// Shared-memory row strides padded against bank conflicts: q/k/v rows of 64
// bf16 (128 bytes) would put all 16 rows of a fragment on the same banks.
constexpr int kLdh = kHeadDim + kPad;    // q/k/v rows (144 bytes)
constexpr int kLdo = kHeadDim + 4;       // f32 staging of o (68 words)

__global__ void __launch_bounds__(kThreads)
ln_attn_heads_kernel(const bf16* __restrict__ x, const float* __restrict__ lnw,
                     const float* __restrict__ lnb, const bf16* __restrict__ w_in,
                     const bf16* __restrict__ b_in, bf16* __restrict__ o,
                     int T, int Tp, int D, int H, int causal, float eps, float scale,
                     int wregion) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* xb = x + (size_t)b * T * D;

  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + Tp * kLdh;
  bf16* v_s = k_s + Tp * kLdh;
  float* mean_s = reinterpret_cast<float*>(v_s + Tp * kLdh);
  float* rstd_s = mean_s + Tp;
  unsigned char* region = reinterpret_cast<unsigned char*>(rstd_s + Tp);

  // LayerNorm statistics of every row of the sequence
  for (int r = warp; r < T; r += kWarps) {
    float m, rs, row[8 * kRowVecs];
    row_stats(xb + (size_t)r * D, D, eps, lane, row, &m, &rs);
    if (lane == 0) { mean_s[r] = m; rstd_s[r] = rs; }
  }
  __syncthreads();

  // ---- phase 1: q/k/v of this head for all rows --------------------------
  bf16* y_t = reinterpret_cast<bf16*>(region);                 // kRowChunk x (kKc+pad)
  bf16* w_t = y_t + kRowChunk * (kKc + kPad);                  // kQkvCols x (kKc+pad)
  float* scratch = reinterpret_cast<float*>(w_t + kQkvCols * (kKc + kPad));  // 256 floats/warp
  float* my_scratch = scratch + warp * 256;
  const int ldt = kKc + kPad;

  // 16-byte staging; the next (rows, K) slice is fetched into registers while
  // the current one is multiplied
  constexpr int kGroups = kKc / 8;
  constexpr int kXG = kRowChunk * kGroups / kThreads;
  constexpr int kWG = kQkvCols * kGroups / kThreads;
  uint4 xr[kXG], wr[kWG];
  auto fetch = [&](int r0, int k0) {
#pragma unroll
    for (int u = 0; u < kXG; ++u) {
      const int g = tid + u * kThreads, r = r0 + g / kGroups, j = k0 + (g % kGroups) * 8;
      xr[u] = r < T ? ld16(xb + (size_t)r * D + j) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kWG; ++u) {
      const int g = tid + u * kThreads, n = g / kGroups, j = k0 + (g % kGroups) * 8;
      const int wrow = (n / kHeadDim) * D + h * kHeadDim + (n % kHeadDim);
      wr[u] = ld16(w_in + (size_t)wrow * D + j);
    }
  };
  auto stash = [&](int r0, int k0) {
#pragma unroll
    for (int u = 0; u < kXG; ++u) {
      const int g = tid + u * kThreads, i = g / kGroups, jj = (g % kGroups) * 8, r = r0 + i;
      uint4 out = make_uint4(0, 0, 0, 0);
      if (r < T) {
        const bf16* in = reinterpret_cast<const bf16*>(&xr[u]);
        float xv[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) xv[e] = __bfloat162float(in[e]);
        out = ln8(xv, mean_s[r], rstd_s[r], lnw + k0 + jj, lnb + k0 + jj);
      }
      st16(y_t + i * ldt + jj, out);
    }
#pragma unroll
    for (int u = 0; u < kWG; ++u) {
      const int g = tid + u * kThreads;
      st16(w_t + (g / kGroups) * ldt + (g % kGroups) * 8, wr[u]);
    }
  };

  // warp tile: 32 rows (2 row tiles) x 96 of the head's 192 q|k|v columns
  const int pr = warp / 2, pc = warp % 2;
  fetch(0, 0);
  for (int r0 = 0; r0 < Tp; r0 += kRowChunk) {
    FragC acc[2][kColTiles / 2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < kColTiles / 2; ++c) wmma::fill_fragment(acc[i][c], 0.f);
    const int rbase = r0 + pr * 32;
    const bool live0 = rbase < Tp, live1 = rbase + 16 < Tp;   // padded rows are skipped
    for (int k0 = 0; k0 < D; k0 += kKc) {
      __syncthreads();
      stash(r0, k0);
      __syncthreads();
      if (k0 + kKc < D) fetch(r0, k0 + kKc);
      else if (r0 + kRowChunk < Tp) fetch(r0 + kRowChunk, 0);
      if (live0) {
#pragma unroll
        for (int kk = 0; kk < kKc; kk += 16) {
          FragA a0, a1;
          wmma::load_matrix_sync(a0, y_t + pr * 32 * ldt + kk, ldt);
          if (live1) wmma::load_matrix_sync(a1, y_t + (pr * 32 + 16) * ldt + kk, ldt);
#pragma unroll
          for (int c = 0; c < kColTiles / 2; ++c) {
            FragBc bfr;
            wmma::load_matrix_sync(bfr, w_t + (pc * kColTiles / 2 + c) * 16 * ldt + kk, ldt);
            wmma::mma_sync(acc[0][c], a0, bfr, acc[0][c]);
            if (live1) wmma::mma_sync(acc[1][c], a1, bfr, acc[1][c]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (rbase + i * 16 >= Tp) break;
#pragma unroll
      for (int c = 0; c < kColTiles / 2; ++c) {
        wmma::store_matrix_sync(my_scratch, acc[i][c], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = rbase + i * 16 + e / 16;
          const int n = (pc * kColTiles / 2 + c) * 16 + e % 16;
          const int sel = n / kHeadDim, col = n % kHeadDim;
          const float bias = __bfloat162float(b_in[sel * D + h * kHeadDim + col]);
          const float v = r < T ? round_bf16(my_scratch[e]) + bias : 0.f;
          bf16* dst = sel == 0 ? q_s : (sel == 1 ? k_s : v_s);
          dst[r * kLdh + col] = __float2bfloat16(v);
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // ---- phase 2: scores, softmax and P @ V, one 16-query tile per warp ----
  float* sbuf = reinterpret_cast<float*>(region) + (size_t)warp * 16 * wregion;
  bf16* pbuf = reinterpret_cast<bf16*>(sbuf);
  const int nkt = Tp / 16;
  for (int qt = warp; qt < nkt; qt += kWarps) {
    const int kt_end = causal ? qt + 1 : nkt;
    FragA qa[kHeadDim / 16];
#pragma unroll
    for (int c = 0; c < kHeadDim / 16; ++c)
      wmma::load_matrix_sync(qa[c], q_s + qt * 16 * kLdh + c * 16, kLdh);
    for (int kt = 0; kt < kt_end; ++kt) {
      FragC s;
      wmma::fill_fragment(s, 0.f);
#pragma unroll
      for (int c = 0; c < kHeadDim / 16; ++c) {
        FragBc kb;
        wmma::load_matrix_sync(kb, k_s + kt * 16 * kLdh + c * 16, kLdh);
        wmma::mma_sync(s, qa[c], kb, s);
      }
      wmma::store_matrix_sync(sbuf + kt * 16, s, wregion, wmma::mem_row_major);
    }
    __syncwarp();
    const int ncols = kt_end * 16;
    for (int i = 0; i < 16; ++i) {
      const int qi = qt * 16 + i;
      float vals[8];
      float m = -INFINITY;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int j = lane + 32 * t;
        const bool ok = j < ncols && j < T && (!causal || j <= qi);
        vals[t] = ok ? sbuf[i * wregion + j] * scale : -INFINITY;
        m = fmaxf(m, vals[t]);
      }
      m = warp_max(m);
      float l = 0.f;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        vals[t] = vals[t] == -INFINITY ? 0.f : expf(vals[t] - m);
        l += vals[t];
      }
      l = warp_sum(l);
      __syncwarp();  // the whole row is read before its bf16 view is written
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int j = lane + 32 * t;
        if (j < ncols) pbuf[i * 2 * wregion + j] = __float2bfloat16(vals[t] / l);
      }
      __syncwarp();
    }
    FragC oacc[kHeadDim / 16];
#pragma unroll
    for (int c = 0; c < kHeadDim / 16; ++c) wmma::fill_fragment(oacc[c], 0.f);
    for (int kt = 0; kt < kt_end; ++kt) {
      FragA p;
      wmma::load_matrix_sync(p, pbuf + kt * 16, 2 * wregion);
#pragma unroll
      for (int c = 0; c < kHeadDim / 16; ++c) {
        FragBr vb;
        wmma::load_matrix_sync(vb, v_s + kt * 16 * kLdh + c * 16, kLdh);
        wmma::mma_sync(oacc[c], p, vb, oacc[c]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < kHeadDim / 16; ++c)
      wmma::store_matrix_sync(sbuf + c * 16, oacc[c], kLdo, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 16 * kHeadDim; e += 32) {
      const int i = e / kHeadDim, j = e % kHeadDim;
      const int qi = qt * 16 + i;
      if (qi < T)
        o[((size_t)b * T + qi) * D + h * kHeadDim + j] = __float2bfloat16(sbuf[i * kLdo + j]);
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// K5 part 2: out = res + (bf16(a @ w^T) + bias), w in (N, K) Linear layout.
// 128 x 128 output tile per block, 8 warps as 4 (M) x 2 (N), K slices of 32.
// ---------------------------------------------------------------------------
constexpr int kBm = 128, kBn = 128, kBk = 32;

__global__ void __launch_bounds__(kThreads)
linear_residual_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                       const bf16* __restrict__ bias, const bf16* __restrict__ res,
                       bf16* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(128) bf16 a_t[kBm * (kBk + kPad)];
  __shared__ __align__(128) bf16 w_t[kBn * (kBk + kPad)];
  __shared__ __align__(128) float scratch[kWarps * 256];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * kBm, n0 = blockIdx.y * kBn;
  const int wm = warp / 2, wn = warp % 2;  // warp tile: rows wm*32, cols wn*64
  const int ld = kBk + kPad;
  FragC acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // 16-byte staging with the next K slice fetched into registers during the MMAs
  constexpr int kGroups = kBk / 8;
  constexpr int kG = kBm * kGroups / kThreads;
  uint4 ar[kG], wr[kG];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int u = 0; u < kG; ++u) {
      const int g = tid + u * kThreads, i = g / kGroups, j = k0 + (g % kGroups) * 8;
      ar[u] = m0 + i < M ? ld16(a + (size_t)(m0 + i) * K + j) : make_uint4(0, 0, 0, 0);
      wr[u] = ld16(w + (size_t)(n0 + i) * K + j);
    }
  };
  fetch(0);
  for (int k0 = 0; k0 < K; k0 += kBk) {
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kG; ++u) {
      const int g = tid + u * kThreads, off = (g / kGroups) * ld + (g % kGroups) * 8;
      st16(a_t + off, ar[u]);
      st16(w_t + off, wr[u]);
    }
    __syncthreads();
    if (k0 + kBk < K) fetch(k0 + kBk);
#pragma unroll
    for (int kk = 0; kk < kBk; kk += 16) {
      FragA fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], a_t + (wm * 32 + i * 16) * ld + kk, ld);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragBc fb;
        wmma::load_matrix_sync(fb, w_t + (wn * 64 + j * 16) * ld + kk, ld);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
  }
  float* my = scratch + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(my, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int m = m0 + wm * 32 + i * 16 + e / 16;
        const int n = n0 + wn * 64 + j * 16 + e % 16;
        if (m < M) {
          const float v = round_bf16(round_bf16(my[e]) + __bfloat162float(bias[n]));
          out[(size_t)m * N + n] =
              __float2bfloat16(__bfloat162float(res[(size_t)m * N + n]) + v);
        }
      }
      __syncwarp();
    }
}

// ---------------------------------------------------------------------------
// K6: out = x + c_proj(QuickGELU(c_fc(LN(x)))), rows independent.
// Block: MR rows x all D output columns, so the hidden is made exactly once.
// LN(x) of the row tile stays in shared memory; the hidden is made 64 columns
// at a time (one 16 x 16 c_fc tile per warp, so MR / 16 * 4 warps) and
// consumed at once by c_proj, whose f32 accumulators (MR x D) stay in
// registers. Weight slices arrive by cp.async into a 3-stage ring: the next
// two c_fc slices (KS wide) and the chunk's c_proj slice load while the
// current slice is multiplied.
// One block fills an SM's shared memory, so the row tile sets the number of
// waves: at D = 768 a ViT-B/16 batch of 32 (6304 rows) makes 132 blocks of 48
// rows, one wave on 132 SMs, where 32-row tiles made 197 blocks, two waves
// with the second one a half empty. The text width (D = 512) keeps 32-row
// tiles (616 blocks at B = 256).
// ---------------------------------------------------------------------------
constexpr int kHc = 64;    // hidden chunk
constexpr int kStages = 3;

__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gmem_ptr) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem_ptr));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

// NC: output columns a block owns (blockIdx.y picks which NC of the D); K6
// takes all D.
template <int D, int MR, int KS, int NC = D>
struct MlpTile {
  static constexpr int kD = D, kMR = MR, kKS = KS, kNC = NC;
  static constexpr int kWarps = MR / 16 * (kHc / 16);  // one c_fc tile per warp
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kRowTiles = MR / 16;
  static constexpr int kNcf = NC / 16 / kWarps;        // c_proj column tiles per warp
  static_assert(NC % (16 * kWarps) == 0 && D % NC == 0 && D % KS == 0,
                "tile does not divide D");
  static constexpr int kSmemBytes =
      (MR * (D + kPad) + kStages * kHc * (KS + kPad) + MR * (kHc + kPad) + NC * (kHc + kPad)) * 2
      + kWarps * 256 * 4;
};
typedef MlpTile<512, 32, 128> MlpText;          // ViT-B text width
typedef MlpTile<768, 48, 64> MlpImage;          // ViT-B image width

template <int D, int MR, int KS, int NC>
__global__ void __launch_bounds__(MlpTile<D, MR, KS, NC>::kThreads)
ln_mlp_kernel(const bf16* __restrict__ x, const float* __restrict__ lnw,
              const float* __restrict__ lnb, const bf16* __restrict__ w1,
              const bf16* __restrict__ b1, const bf16* __restrict__ w2,
              const bf16* __restrict__ b2, bf16* __restrict__ out, int M, int Hd, float eps) {
  typedef MlpTile<D, MR, KS, NC> Tile;
  constexpr int kNw = Tile::kWarps, kNt = Tile::kThreads, kRt = Tile::kRowTiles;
  constexpr int kNcf = Tile::kNcf;
  constexpr int ldy = D + kPad, ldk = KS + kPad, ldh = kHc + kPad;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * MR;
  const int n0 = blockIdx.y * NC;                      // first output column of the block
  bf16* y_s = reinterpret_cast<bf16*>(smem);          // MR x ldy
  bf16* w1_s = y_s + MR * ldy;                         // kStages x kHc x ldk (hidden, k)
  bf16* h_s = w1_s + kStages * kHc * ldk;              // MR x ldh
  bf16* w2_s = h_s + MR * ldh;                         // NC x ldh   (out rows, hidden)
  float* scratch = reinterpret_cast<float*>(w2_s + NC * ldh);  // 256 floats / warp
  float* my = scratch + warp * 256;

  constexpr int nk = D / KS;
  auto issue_w1 = [&](int slice) {                     // slice = chunk * nk + k step
    const int hc0 = (slice / nk) * kHc, k0 = (slice % nk) * KS;
    bf16* dst = w1_s + (slice % kStages) * kHc * ldk;
    for (int g = tid; g < kHc * KS / 8; g += kNt)
      cp_async16(dst + (g / (KS / 8)) * ldk + (g % (KS / 8)) * 8,
                 w1 + (size_t)(hc0 + g / (KS / 8)) * D + k0 + (g % (KS / 8)) * 8);
  };
  auto issue_w2 = [&](int hc0) {
    for (int g = tid; g < NC * kHc / 8; g += kNt)
      cp_async16(w2_s + (g / (kHc / 8)) * ldh + (g % (kHc / 8)) * 8,
                 w2 + (size_t)(n0 + g / (kHc / 8)) * Hd + hc0 + (g % (kHc / 8)) * 8);
  };
  issue_w1(0);
  cp_async_commit();
  issue_w1(1);
  cp_async_commit();

  // LN(x) of the row tile, f32 statistics, rounded to bf16
  for (int i = warp; i < MR; i += kNw) {
    const int m = m0 + i;
    if (m < M) {
      float mean, rstd, row[8 * kRowVecs];
      row_stats(x + (size_t)m * D, D, eps, lane, row, &mean, &rstd);
#pragma unroll
      for (int u = 0; u < kRowVecs; ++u) {
        const int j = (lane + 32 * u) * 8;
        if (j < D) st16(y_s + i * ldy + j, ln8(row + 8 * u, mean, rstd, lnw + j, lnb + j));
      }
    } else {
      for (int j = lane * 8; j < D; j += 256) st16(y_s + i * ldy + j, make_uint4(0, 0, 0, 0));
    }
  }

  const float gelu_c = __bfloat162float(__float2bfloat16(1.702f));
  const int hw_r = warp / (kHc / 16), hw_c = warp % (kHc / 16);  // this warp's c_fc tile
  FragC oacc[kRt][kNcf];                               // c_proj: all rows, kNcf col tiles of NC
#pragma unroll
  for (int i = 0; i < kRt; ++i)
#pragma unroll
    for (int c = 0; c < kNcf; ++c) wmma::fill_fragment(oacc[i][c], 0.f);

  const int total = (Hd / kHc) * nk;
  for (int hc0 = 0, slice = 0; hc0 < Hd; hc0 += kHc) {
    FragC hacc;
    wmma::fill_fragment(hacc, 0.f);
    for (int kstep = 0; kstep < nk; ++kstep, ++slice) {
      cp_async_wait_one();
      __syncthreads();           // slice landed for all; stage (slice+2)%3 is free again
      if (kstep == 0) issue_w2(hc0);      // w2_s and h_s were last read before this barrier
      if (slice + 2 < total) issue_w1(slice + 2);
      cp_async_commit();
      const bf16* w1_t = w1_s + (slice % kStages) * kHc * ldk;
      const int k0 = kstep * KS;
#pragma unroll
      for (int kk = 0; kk < KS; kk += 16) {
        FragA a;
        FragBc bfr;
        wmma::load_matrix_sync(a, y_s + hw_r * 16 * ldy + k0 + kk, ldy);
        wmma::load_matrix_sync(bfr, w1_t + hw_c * 16 * ldk + kk, ldk);
        wmma::mma_sync(hacc, a, bfr, hacc);
      }
    }
    // hidden epilogue: bias (bf16), QuickGELU with the JAX kernel's rounding
    wmma::store_matrix_sync(my, hacc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int i = hw_r * 16 + e / 16, j = hw_c * 16 + e % 16;
      const float hv = round_bf16(round_bf16(my[e]) + __bfloat162float(b1[hc0 + j]));
      const float sg = round_bf16(gelu_c * hv);
      const float sig = round_bf16(1.f / (1.f + expf(-sg)));
      h_s[i * ldh + j] = __float2bfloat16(hv * sig);
    }
    cp_async_wait_all();
    __syncthreads();             // h_s complete, w2_s landed
#pragma unroll
    for (int kk = 0; kk < kHc; kk += 16) {
      FragA a[kRt];
#pragma unroll
      for (int i = 0; i < kRt; ++i)
        wmma::load_matrix_sync(a[i], h_s + i * 16 * ldh + kk, ldh);
#pragma unroll
      for (int c = 0; c < kNcf; ++c) {
        FragBc bfr;
        wmma::load_matrix_sync(bfr, w2_s + (warp * kNcf + c) * 16 * ldh + kk, ldh);
#pragma unroll
        for (int i = 0; i < kRt; ++i) wmma::mma_sync(oacc[i][c], a[i], bfr, oacc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRt; ++i)
#pragma unroll
    for (int c = 0; c < kNcf; ++c) {
      wmma::store_matrix_sync(my, oacc[i][c], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int m = m0 + i * 16 + e / 16;
        const int n = n0 + (warp * kNcf + c) * 16 + e % 16;
        if (m < M) {
          const float v = round_bf16(round_bf16(my[e]) + __bfloat162float(b2[n]));
          out[(size_t)m * D + n] =
              __float2bfloat16(__bfloat162float(x[(size_t)m * D + n]) + v);
        }
      }
      __syncwarp();
    }
}

template <class Tile>
int launch_ln_mlp(const void* x, const void* lnw, const void* lnb, const void* w1,
                  const void* b1, const void* w2, const void* b2, void* out, int M, int Hd,
                  float eps, cudaStream_t stream) {
  auto kernel = ln_mlp_kernel<Tile::kD, Tile::kMR, Tile::kKS, Tile::kNC>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::kSmemBytes);
  const dim3 grid((M + Tile::kMR - 1) / Tile::kMR, Tile::kD / Tile::kNC);
  kernel<<<grid, Tile::kThreads, Tile::kSmemBytes, stream>>>(
      (const bf16*)x, (const float*)lnw, (const float*)lnb, (const bf16*)w1, (const bf16*)b1,
      (const bf16*)w2, (const bf16*)b2, (bf16*)out, M, Hd, eps);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K9: out = x + c_proj(QuickGELU(c_fc(LN(x)))) at D = 1024 on wgmma + TMA.
// Grid: two CTAs a 64-row tile (cluster rank r: output columns 512 r ..).
// Threads: two consumer warpgroups (warpgroup w: c_fc hidden columns 32 w ..
// of the CTA's share, c_proj output columns 256 w .. of the CTA's half) and
// no producer warp: a block of more than 256 threads caps a thread at 168
// registers, and c_proj's accumulators alone take 128. The ring refills
// itself: the last warp to release a stage issues its next load (one thread,
// by TMA), as K11 does.
// ---------------------------------------------------------------------------
namespace k9 {
constexpr int kD = 1024;                  // model width
constexpr int kRows = 64;                 // rows of a tile (one wgmma M)
constexpr int kCluster = 2;               // CTAs of a tile: halves of the output columns
constexpr int kCols = kD / kCluster;      // output columns a CTA owns
constexpr int kChunk = 128;               // hidden columns of a chunk
constexpr int kShare = kChunk / kCluster; // hidden columns a CTA makes of each chunk
constexpr int kCtaThreads = 256;          // two warpgroups
constexpr int kCtaWarps = kCtaThreads / 32;
constexpr int kStageBytes = 16384;        // W1: 64 hidden x 128 deep; W2: 128 outputs x 64 hidden
constexpr int kRing = 5;
constexpr int kFcStages = kD / 128;       // W1 stages of a chunk
constexpr int kProjStages = (kChunk / 64) * (kCols / 128);   // W2 stages of a chunk
constexpr int kStagesPerChunk = kFcStages + kProjStages;
constexpr int kLnBytes = kRows * kD * 2;  // LN(x): 16 swizzled 64 x 64 tiles
constexpr int kHld = kChunk + 8;          // padded hidden row (bf16): conflict-free fragment loads
constexpr int kHBytes = kRows * kHld * 2;
constexpr int kBarriers = kRing + 2;      // full a stage; the chunk's h_full, h_empty
constexpr int kSmem = 1024 + kLnBytes + kRing * kStageBytes + kHBytes + 8 * kBarriers;
static_assert(kSmem <= 232448, "K9 tile does not fit shared memory");
}  // namespace k9

__device__ __forceinline__ float quick_gelu_bf16(float acc, float bias, float gelu_c) {
  const float hv = round_bf16(round_bf16(acc) + bias);
  const float sg = round_bf16(gelu_c * hv);
  const float sig = round_bf16(1.f / (1.f + expf(-sg)));
  return round_bf16(hv * sig);
}

__global__ void __cluster_dims__(k9::kCluster, 1, 1) __launch_bounds__(k9::kCtaThreads, 1)
ln_mlp_wide_kernel(const __grid_constant__ CUtensorMap w1map,
                   const __grid_constant__ CUtensorMap w2map, const bf16* __restrict__ x,
                   const float* __restrict__ lnw, const float* __restrict__ lnb,
                   const bf16* __restrict__ b1, const bf16* __restrict__ b2,
                   bf16* __restrict__ out, int M, int Hd, float eps) {
  using namespace k9;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int released[kRing];                      // warps done with a stage's current load
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;        // swizzled tiles at 1024-byte boundaries
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t ln_s = base, ring = base + kLnBytes, h_s = ring + kRing * kStageBytes;
  unsigned char* h_g = gbase + (h_s - base);
  const uint32_t full = h_s + kHBytes, h_full = full + 8 * kRing, h_empty = h_full + 8;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t rank = cluster_rank(), peer = rank ^ 1u;
  const int m0 = (blockIdx.x / kCluster) * kRows;
  const int nch = (Hd + kChunk - 1) / kChunk, total = nch * kStagesPerChunk;

  // load `it` of the weight stream: per chunk, the CTA's W1 share (8 stages of
  // two 64 x 64 boxes), then its W2 half (8 stages of one 64 x 128 box)
  auto issue = [&](int it) {
    const int s = it % kRing, c = it / kStagesPerChunk, st = it % kStagesPerChunk;
    const uint32_t dst = ring + s * kStageBytes, bar = full + 8 * s;
    mbar_expect(bar, kStageBytes);
    if (st < kFcStages) {
      const int hid = c * kChunk + (int)rank * kShare;
      tma_2d(dst, &w1map, bar, st * 128, hid);
      tma_2d(dst + 8192, &w1map, bar, st * 128 + 64, hid);
    } else {
      const int p = st - kFcStages, kb = p / (kCols / 128), rb = p % (kCols / 128);
      tma_2d(dst, &w2map, bar, c * kChunk + kb * 64, (int)rank * kCols + rb * 128);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(full + 8 * s, 1);
      released[s] = 0;
    }
    mbar_init(h_full, 2 * kCtaThreads);                // every thread of both CTAs
    mbar_init(h_empty, 2 * kCtaThreads);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int it = 0; it < min(kRing, total); ++it) issue(it);
  // LN(x) of the tile, f32 statistics, rounded to bf16, into the swizzled A tiles
  for (int i = warp; i < kRows; i += kCtaWarps) {
    const int m = m0 + i;
    float mean = 0.f, rstd = 0.f, row[8 * kRowVecs];
    if (m < M) row_stats(x + (size_t)m * kD, kD, eps, lane, row, &mean, &rstd);
#pragma unroll
    for (int u = 0; u < kRowVecs; ++u) {
      const int j = (lane + 32 * u) * 8;
      const uint4 v =
          m < M ? ln8(row + 8 * u, mean, rstd, lnw + j, lnb + j) : make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(gbase + (j >> 6) * 8192 + sw128_offset(i, j & 63)) = v;
    }
  }
  fence_proxy_async();   // the LN tiles are wgmma operands
  cluster_sync();        // and both CTAs' barriers exist before any remote arrival

  const int w = warp >> 2, wp = warp & 3, g = lane >> 2, t = lane & 3;
  const float gelu_c = __bfloat162float(__float2bfloat16(1.702f));
  const uint32_t h_full_peer = cluster_addr(h_full, peer);
  const uint32_t h_empty_peer = cluster_addr(h_empty, peer);
  const uint32_t h_peer = cluster_addr(h_s, peer);
  float acc[2][64];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[hf][e] = 0.f;
  // this warp is done with load `it`; the last of the 8 warps refills its stage
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) {
      const int s = it % kRing;
      if (atomicAdd(&released[s], 1) == kCtaWarps - 1) {
        released[s] = 0;
        if (it + kRing < total) issue(it + kRing);
      }
    }
  };
  int it = 0;
  for (int c = 0; c < nch; ++c) {
    // c_fc: 64 rows x this warpgroup's 32 hidden columns, over all D
    const int hc0 = (int)rank * kShare + 32 * w;      // first hidden column (in the chunk)
    float hacc[16];   // the first step overwrites it (no register write while products run)
    int prev = -1;
    for (int st = 0; st < kFcStages; ++st, ++it) {
      const int s = it % kRing;
      mbar_wait_bounded(full + 8 * s, (it / kRing) & 1);
      const uint32_t stage = ring + s * kStageBytes;
      wgmma_fence();
#pragma unroll
      for (int box = 0; box < 2; ++box)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n32k16_ss<0>(hacc, sw128_desc(ln_s + (2 * st + box) * 8192 + 32 * kk),
                                sw128_desc(stage + box * 8192 + w * 4096 + 32 * kk),
                                (st | box | kk) != 0);
      wgmma_commit();
      wgmma_wait_n<1>();   // the previous stage's products are done
      if (prev >= 0) release(prev);
      prev = it;
    }
    wgmma_wait_n<0>();
    keep_n(hacc);
    release(prev);

    // bias + QuickGELU, the bf16 piece to this CTA's and the partner's hidden buffer
    if (c > 0) mbar_wait_bounded<true>(h_empty, (c - 1) & 1);   // both CTAs read chunk c - 1
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = hc0 + 8 * j + 2 * t, hid = c * kChunk + col;
      const bool live = hid < Hd;                       // Hd is even: both columns or neither
      const float bias0 = live ? __bfloat162float(b1[hid]) : 0.f;
      const float bias1 = live ? __bfloat162float(b1[hid + 1]) : 0.f;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = 16 * wp + g + 8 * hr;
        const uint32_t v = live ? pack2(quick_gelu_bf16(hacc[4 * j + 2 * hr], bias0, gelu_c),
                                        quick_gelu_bf16(hacc[4 * j + 2 * hr + 1], bias1, gelu_c))
                                : 0u;
        const uint32_t off = (uint32_t)(r * kHld + col) * 2;
        *reinterpret_cast<uint32_t*>(h_g + off) = v;
        st_cluster_u32(h_peer + off, v);
      }
    }
    mbar_arrive(h_full);
    mbar_arrive_remote(h_full_peer);
    mbar_wait_bounded<true>(h_full, c & 1);

    // c_proj: the chunk into this warpgroup's 256 output columns; the A
    // fragments of a 64-deep half (rows 16 wp + g, + 8) are loaded per half
    prev = -1;
    uint32_t afr[4][4];
#pragma unroll   // register accumulators and fragments indexed by the stage
    for (int st = 0; st < kProjStages; ++st, ++it) {
      const int s = it % kRing;
      const int kb = st / (kCols / 128), rb = st % (kCols / 128);
      if (rb == 0) {   // a new 64-deep half of the chunk: its fragments
        if (kb > 0) {  // the previous half's products still read the registers
          wgmma_wait_n<0>();
          keep_n(acc[0]);
          keep_n(acc[1]);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) keep_n(afr[kk]);
          if (prev >= 0) release(prev);
          prev = -1;
        }
        const unsigned char* h0 = h_g + ((16 * wp + g) * kHld + 64 * kb + 2 * t) * 2;
        const unsigned char* h1 = h0 + 8 * kHld * 2;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          afr[kk][0] = *reinterpret_cast<const uint32_t*>(h0 + 32 * kk);
          afr[kk][1] = *reinterpret_cast<const uint32_t*>(h1 + 32 * kk);
          afr[kk][2] = *reinterpret_cast<const uint32_t*>(h0 + 32 * kk + 16);
          afr[kk][3] = *reinterpret_cast<const uint32_t*>(h1 + 32 * kk + 16);
        }
        if (kb == kChunk / 64 - 1) {   // this thread has read the whole chunk
          mbar_arrive(h_empty);
          mbar_arrive_remote(h_empty_peer);
        }
      }
      mbar_wait_bounded(full + 8 * s, (it / kRing) & 1);
      if (rb / 2 != w) {   // the other warpgroup's columns
        release(it);
        continue;
      }
      const uint32_t stage = ring + s * kStageBytes;
      float (&d)[64] = acc[rb & 1];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n128k16_rs<0>(d, afr[kk], sw128_desc(stage + 32 * kk), 1);
      wgmma_commit();
      wgmma_wait_n<1>();
      if (prev >= 0) release(prev);
      prev = it;
    }
    wgmma_wait_n<0>();
    keep_n(acc[0]);
    keep_n(acc[1]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) keep_n(afr[kk]);
    release(prev);
  }

  // out = x + (bf16(acc) + b2), bf16
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = (int)rank * kCols + 256 * w + 128 * hf + 8 * j + 2 * t;
      const float bb0 = __bfloat162float(b2[n]), bb1 = __bfloat162float(b2[n + 1]);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = m0 + 16 * wp + g + 8 * hr;
        if (m >= M) continue;
        const __nv_bfloat162 xr = *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)m * kD + n);
        const float v0 = round_bf16(round_bf16(acc[hf][4 * j + 2 * hr]) + bb0);
        const float v1 = round_bf16(round_bf16(acc[hf][4 * j + 2 * hr + 1]) + bb1);
        *reinterpret_cast<uint32_t*>(out + (size_t)m * kD + n) =
            pack2(__bfloat162float(xr.x) + v0, __bfloat162float(xr.y) + v1);
      }
    }
  cluster_sync();   // no CTA leaves while its partner may still write to it
}

int launch_ln_mlp_wide(const void* x, const void* lnw, const void* lnb, const void* w1,
                       const void* b1, const void* w2, const void* b2, void* out, int M, int Hd,
                       float eps, cudaStream_t stream) {
  using namespace k9;
  CUtensorMap w1m, w2m;
  int err;
  if ((err = map_2d(&w1m, w1, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, kD, Hd, 2LL * kD, 64, 64,
                    CU_TENSOR_MAP_SWIZZLE_128B)) != 0 ||
      (err = map_2d(&w2m, w2, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, Hd, kD, 2LL * Hd, 64, 128,
                    CU_TENSOR_MAP_SWIZZLE_128B)) != 0)
    return err;
  cudaFuncSetAttribute(ln_mlp_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  const int tiles = (M + kRows - 1) / kRows;
  ln_mlp_wide_kernel<<<tiles * kCluster, kCtaThreads, kSmem, stream>>>(
      w1m, w2m, (const bf16*)x, (const float*)lnw, (const float*)lnb, (const bf16*)b1,
      (const bf16*)b2, (bf16*)out, M, Hd, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// f32 score-row stride of ln_attn_heads' phase 2 (words; 4 of padding keep
// the 16 rows of a fragment off each other's banks)
int ln_attn_heads_score_stride(int Tp) { return (Tp > kHeadDim ? Tp : kHeadDim) + 4; }

// Shared memory of ln_attn_heads for a padded length Tp (the wrapper checks the limit).
int ln_attn_heads_smem_bytes(int Tp) {
  const int phase1 = (kRowChunk + kQkvCols) * (kKc + kPad) * 2 + kWarps * 256 * 4;
  const int phase2 = kWarps * 16 * ln_attn_heads_score_stride(Tp) * 4;
  return 3 * Tp * kLdh * 2 + 2 * Tp * 4 + (phase1 > phase2 ? phase1 : phase2);
}

int ln_attn_heads_bf16(const void* x, const void* lnw, const void* lnb, const void* w_in,
                       const void* b_in, void* o, int B, int T, int D, int H, int causal,
                       float eps, void* stream) {
  const int Tp = (T + 15) / 16 * 16;
  const int wregion = ln_attn_heads_score_stride(Tp);
  const int smem = ln_attn_heads_smem_bytes(Tp);
  cudaFuncSetAttribute(ln_attn_heads_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const float scale = 1.0f / sqrtf((float)kHeadDim);
  ln_attn_heads_kernel<<<B * H, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)lnw, (const float*)lnb, (const bf16*)w_in,
      (const bf16*)b_in, (bf16*)o, T, Tp, D, H, causal, eps, scale, wregion);
  return (int)cudaGetLastError();
}

int linear_residual_bf16(const void* a, const void* w, const void* bias, const void* res,
                         void* out, int M, int N, int K, void* stream) {
  dim3 grid((M + kBm - 1) / kBm, N / kBn);
  linear_residual_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)a, (const bf16*)w, (const bf16*)bias, (const bf16*)res, (bf16*)out,
      M, N, K);
  return (int)cudaGetLastError();
}

// D = 512 or 768 (the ViT-B text and image widths); Hd % 64 == 0 (the wrapper checks)
int ln_mlp_bf16(const void* x, const void* lnw, const void* lnb, const void* w1,
                const void* b1, const void* w2, const void* b2, void* out, int M, int D,
                int Hd, float eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 512)
    return launch_ln_mlp<MlpText>(x, lnw, lnb, w1, b1, w2, b2, out, M, Hd, eps, s);
  if (D == 768)
    return launch_ln_mlp<MlpImage>(x, lnw, lnb, w1, b1, w2, b2, out, M, Hd, eps, s);
  return (int)cudaErrorInvalidValue;
}

// K9. D = 1024 (the ViT-L/14 image width); Hd % 64 == 0 (the wrapper checks)
int ln_mlp_chunked_bf16(const void* x, const void* lnw, const void* lnb, const void* w1,
                        const void* b1, const void* w2, const void* b2, void* out, int M,
                        int D, int Hd, float eps, void* stream) {
  if (D != k9::kD || Hd < 64 || Hd % 64 || M < 1) return (int)cudaErrorInvalidValue;
  return launch_ln_mlp_wide(x, lnw, lnb, w1, b1, w2, b2, out, M, Hd, eps, (cudaStream_t)stream);
}

// K9's shared memory a CTA (bytes) and CTAs a cluster, for the host-side checks
int ln_mlp_wide_smem_bytes() { return k9::kSmem; }
int ln_mlp_wide_cluster() { return k9::kCluster; }

}  // extern "C"
