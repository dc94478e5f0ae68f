// Softmax attention kernels for Hopper (head dim 64, sm_90a).
//
// Replaces the TPU kernels of summer_clip_tpu/ops/attention.py:
//   K4  short_attention_packed (:248) -> short_attention_bf16 / short_attention_f32,
//       heads read as 64-column slices of the packed (B, T, H*64) tensors (row
//       stride given by the caller, so q/k/v may be views of one fused
//       (B, T, 3D) projection: nothing is copied or transposed in device memory);
//   K12 short_attention (:195)        -> the same entries on (BH, T, 64);
//   K11 flash_attention (:87)         -> flash_attention_bf16 / flash_attention_f32,
//       (BH, T, 64) with Tq != Tk and a causal mask shifted by q_offset (row i
//       sees keys <= q_offset + i).
//
// Rounding points (the TPU kernels'):
//   K4 / K12: s = q k^T / 8 in f32, causal mask, an exact softmax over the whole
//     key row in f32, p / l rounded to bf16 before the PV product, f32
//     accumulation, bf16 out.
//   K11: online softmax over key tiles, masked scores out of the maximum and
//     the sum, acc and l rescaled by exp(m - m_new), the unnormalised p rounded
//     to the value type before PV, out = acc / max(l, 1e-30).
//
// What bounds them on this card. K4 at ViT-L/14 (B = 32, T = 257, 16 heads) moves
// 67 MB (q, k, v in, o out: 0.020 ms at 3.35 TB/s) for 8.7 GFLOP of tensor work
// (0.009 ms), so it is bound by bytes, and the scores must never reach device
// memory. K11 at (160, 1024, 64) causal moves 84 MB (0.025 ms) for 21.5 GFLOP
// (0.022 ms): bytes and operations nearly tie, so the tensor cores have to run
// near their rate while K/V stream in. Beside both, the special-function units
// take one exponential a score (two in K4's exact softmax) at 16 a clock an SM,
// which at T = 257 is as long as the tensor work.
//
// bf16 design (one template, kExact = K4 / K12, else K11). A block holds kWG
// warpgroups of 128 threads; each owns 64-query tiles and runs wgmma.m64n64k16:
// S = Q K^T with Q and K as K-major shared-memory operands, the softmax on S in
// registers, P converted to bf16 in registers and used as the register A
// operand of O += P V, where V is the MN-major B operand read from shared memory
// as TMA wrote it: nothing transposes V anywhere (the previous design wrote V^T
// 2 bytes at a time into shared memory with 8-way bank conflicts). Q, K and V
// tiles (64 rows x 128 bytes, 128-byte swizzle, the layout the wgmma descriptor
// names) arrive by TMA (cp.async.bulk.tensor, 3-D tensor maps over (columns,
// rows, sequences) with the caller's strides, so the fused projection's views
// are read in place and rows past T arrive as zeros) on mbarriers; one elected
// thread issues each load, so no thread stages anything by hand.
//   K4 / K12: a block owns (sequence, head, query split); all K and V tiles of
//   the head are issued at once and stay resident (80 KB at T = 257, 160 KB at
//   T = 640), the warpgroups walk the head's query tiles and compute on each key
//   tile as soon as it lands. Two passes over the keys (the previous design
//   made three): pass 1 keeps m and l online, pass 2 recomputes S and forms
//   bf16(exp(s - m) / l) for PV. l is summed online with rescaling by
//   exp(m_old - m_new) where JAX sums exp(s - m) with the final m: the two differ
//   by a few f32 ulps, so p / l can land on the neighbouring bf16 value only at
//   a near tie, the same size of difference as the f32 summation order.
//   A warpgroup's next Q tile is loaded as soon as its current tile's last
//   product is done, while the current output is stored. Blocks are
//   (sequence x head) with a query split only where the heads alone leave SMs
//   idle; two blocks of two warpgroups fit an SM up to T = 320, four
//   warpgroups share one block above that. Another block of the same head (a
//   split) re-reads K and V from L2, which at 67 MB of q, k, v, o in a pass is
//   fine.
//   K11: a block owns 128 queries (two warpgroups) of one head, and K/V stream
//   through a ring of 4 stages of 64 keys; the last warp to release a stage
//   issues its refill. Only tiles that cross the causal diagonal or the end of
//   the keys pay for the mask; a warpgroup stops at its last visible key. Causal
//   query tiles go heaviest first (grid x counts query blocks from the end), so
//   the tail of the grid is light, and the grid has no BH limit.
//   The special-function unit computes exp2 of s * log2(e) / 8 - m, one FFMA
//   and one MUFU a score.
// What still holds it back: a warpgroup runs S, softmax and PV one after the
// other, and the four warpgroups of an SM drift into step, so the
// special-function units and the tensor cores take turns being idle; each is
// about a third busy at ViT-L/14 (PERF.md). The design runs at 110-119
// registers of the 128 that two blocks an SM allow; variants that overlapped
// more inside a warpgroup spilled or serialised their wgmma (PERF.md, PR 7).
//
// f32 design (K4 and K11 share it, as before): true f32 products on the CUDA
// cores (the f32 route exists for f32 models). A block owns 64 queries of one
// head in 128 threads; a thread owns a register micro-tile of 4 queries x 8 keys
// of S and 4 queries x 8 features of O, so each value it reads from shared
// memory feeds 4-8 FMAs (the previous design held one query a thread, one FMA
// a shared-memory read). Row maxima and sums reduce over the 8 threads that
// share a row. 64-key tiles arrive by cp.async, double-buffered; P passes
// through shared memory between the two products. Online softmax with expf, as
// before. Element (b, t, h, j) of q lies at b * qsb + t * sr + h * 64 + j, of k
// and v at b * ksb + ..., of o at b * ob + t * orow + h * 64 + j, so the same
// code serves (BH, T, 64) (H = 1) and packed (B, T, H * 64) tensors.
//
// Each entry point returns cudaGetLastError() after its launch (or the error of
// building a tensor map).

#include <math.h>

#include "hopper_common.cuh"   // mbarriers, TMA, wgmma, the tensor-map encoder

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kHeadDim = 64;
constexpr int kTile = 64;                        // queries of a warpgroup tile; keys of a K/V tile
constexpr int kTileBytes = kTile * kHeadDim * 2; // one bf16 tile: 64 rows of 128 bytes
constexpr int kMaxT = 640;
constexpr int kFlashStages = 4;                  // K/V ring of K11
constexpr int kMaxWG = 4;
constexpr int kSmemLimit = 232448;               // dynamic shared memory a block may use
constexpr int kSmemSm = 233472;                  // shared memory of an SM
constexpr int kSms = 132;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e30f;

// ---------------------------------------------------------------------------
// bf16: K4 / K12 (kExact) and K11 on one warpgroup template
// ---------------------------------------------------------------------------
struct Bf16Args {
  bf16* o;
  long long ob, orow;    // o: element (b, t, h, j) at b * ob + t * orow + h * 64 + j
  int Tq, Tk, H, nbh;    // nbh: sequences x heads
  int causal, q_offset;
  int nsplit;            // K4: query splits of a head (grid y)
  int stages;            // K/V tiles in shared memory
  float scale_log2;      // log2(e) / sqrt(64)
};

// Keys a 64-query tile at q0 needs (K11): all, or up to its last row's position.
__device__ __forceinline__ int flash_tiles(const Bf16Args& a, int q0) {
  if (q0 >= a.Tq) return 0;
  const int kend = a.causal ? min(a.Tk, a.q_offset + min(q0 + kTile, a.Tq)) : a.Tk;
  return (kend + kTile - 1) / kTile;
}

template <bool kExact, int kWG>
__global__ void __launch_bounds__(kWG * 128, kWG == 2 ? 2 : 1)
attention_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, const Bf16Args a) {
  extern __shared__ unsigned char smem_raw[];
  // tiles at a 1024-byte boundary (the swizzle repeats every 8 rows of 128 bytes)
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t k_s = base, v_s = base + a.stages * kTileBytes;
  const uint32_t q_s = base + 2 * a.stages * kTileBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(gbase + (2 * a.stages + kWG) * kTileBytes);
  const uint32_t kv_full = smem_u32(bars), q_full = kv_full + 8 * a.stages;
  int* released = reinterpret_cast<int*>(bars + a.stages + kWG);   // warps done with a stage

  const int tid = threadIdx.x, w = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  // the block's work
  int seq, col0, first_q[kMaxWG], ntw[kMaxWG], nkb, my_first, my_ntw;
  const int nqt = (a.Tq + kTile - 1) / kTile, step = a.nsplit * kWG;
  if (kExact) {
    const int bh = blockIdx.x;
    seq = bh / a.H;
    col0 = (bh % a.H) * kHeadDim;
    const int nkt = (a.Tk + kTile - 1) / kTile;
    int last = 0;
#pragma unroll
    for (int i = 0; i < kWG; ++i) {
      first_q[i] = blockIdx.y * kWG + i;
      if (first_q[i] < nqt) last = max(last, first_q[i] + (nqt - 1 - first_q[i]) / step * step);
      ntw[i] = 0;
    }
    nkb = a.causal ? min(nkt, last + 1) : nkt;   // the keys the block's last query tile sees
    my_first = blockIdx.y * kWG + w;
    my_ntw = 0;
  } else {
    const int nqb = (a.Tq + kWG * kTile - 1) / (kWG * kTile);
    const int qb = nqb - 1 - (int)(blockIdx.x / a.nbh);   // heaviest causal tiles first
    seq = blockIdx.x % a.nbh;
    col0 = 0;
    nkb = 0;
#pragma unroll
    for (int i = 0; i < kWG; ++i) {
      first_q[i] = qb * kWG + i;
      ntw[i] = flash_tiles(a, first_q[i] * kTile);
      nkb = max(nkb, ntw[i]);
    }
    my_first = qb * kWG + w;
    my_ntw = flash_tiles(a, my_first * kTile);
  }

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(kv_full + 8 * s, 1);
      released[s] = 0;
    }
    for (int i = 0; i < kWG; ++i) mbar_init(q_full + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < kWG; ++i)
      if (first_q[i] < nqt) {
        mbar_expect(q_full + 8 * i, kTileBytes);
        tma_tile(q_s + i * kTileBytes, &qmap, q_full + 8 * i, col0, first_q[i] * kTile, seq);
      }
    for (int j = 0; j < min(a.stages, nkb); ++j) {
      mbar_expect(kv_full + 8 * j, 2 * kTileBytes);
      tma_tile(k_s + j * kTileBytes, &kmap, kv_full + 8 * j, col0, j * kTile, seq);
      tma_tile(v_s + j * kTileBytes, &vmap, kv_full + 8 * j, col0, j * kTile, seq);
    }
  }

  const int r0 = 16 * warp + g;                    // this thread's rows of a tile: r0, r0 + 8
  const uint32_t q_t = q_s + w * kTileBytes;       // this warpgroup's Q tile
  // K4 / K12: the warpgroup's query tiles of this block; K11: its one tile
  const int qstep = kExact ? step : nqt;
  int use = 0;
  for (int qi = my_first; qi < nqt; qi += qstep, ++use) {
    const int q0 = qi * kTile;
    mbar_wait(q_full + 8 * w, use & 1);
    const int nk = kExact ? (a.causal ? qi + 1 : (a.Tk + kTile - 1) / kTile) : my_ntw;
    const int row0 = q0 + r0, row1 = row0 + 8;

    // S of key tile j, masked (-inf) where needed
    auto scores = [&](float (&s)[32], int j) {
      const uint32_t kt = k_s + (j % a.stages) * kTileBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_ss(s, sw128_desc(q_t + 32 * kk), sw128_desc(kt + 32 * kk), kk);
      wgmma_commit();
      wgmma_wait();
      keep(s);
      const int n0 = j * kTile;
      const bool edge = n0 + kTile > a.Tk ||
                        (a.causal && n0 + kTile - 1 > (kExact ? 0 : a.q_offset) + q0);
      if (edge) {
        const int lim0 = a.causal ? (kExact ? 0 : a.q_offset) + row0 : a.Tk;
        const int lim1 = a.causal ? lim0 + 8 : a.Tk;
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int key = n0 + 8 * (e >> 2) + 2 * t + (e & 1);
          const int lim = (e & 2) ? lim1 : lim0;
          if (key >= a.Tk || (a.causal && key > lim)) s[e] = -INFINITY;
        }
      }
    };
    // O += bf16(p) V of key tile j; p in the S accumulator layout
    auto pv = [&](float (&o)[32], const float (&p)[32], int j) {
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = pack2(p[8 * kk + 0], p[8 * kk + 1]);
        pa[kk][1] = pack2(p[8 * kk + 2], p[8 * kk + 3]);
        pa[kk][2] = pack2(p[8 * kk + 4], p[8 * kk + 5]);
        pa[kk][3] = pack2(p[8 * kk + 6], p[8 * kk + 7]);
      }
      const uint32_t vt = v_s + (j % a.stages) * kTileBytes;
      keep(pa);   // the operands are final before the fence (not moved past it)
      keep(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_rs(o, pa[kk], sw128_desc(vt + 2048 * kk));
      wgmma_commit();
      wgmma_wait();
      keep(o);
      keep(pa);
    };

    float oacc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) oacc[e] = 0.f;
    float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f;   // log2 domain; l per thread
    for (int j = 0; j < nk; ++j) {   // pass 1 (K4) or the only pass (K11)
      const int s_idx = j % a.stages;
      mbar_wait(kv_full + 8 * s_idx, (j / a.stages) & 1);
      float s[32];
      scores(s, j);
      float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
      for (int e = 0; e < 32; e += 4) {
        x0 = fmaxf(x0, fmaxf(s[e], s[e + 1]));
        x1 = fmaxf(x1, fmaxf(s[e + 2], s[e + 3]));
      }
      const float mn0 = fmaxf(m0, quad_max(x0) * a.scale_log2);
      const float mn1 = fmaxf(m1, quad_max(x1) * a.scale_log2);
      const float al0 = ex2(m0 - mn0), al1 = ex2(m1 - mn1);
      l0 *= al0;
      l1 *= al1;
#pragma unroll
      for (int e = 0; e < 32; e += 4) {
        s[e] = ex2(fmaf(s[e], a.scale_log2, -mn0));
        s[e + 1] = ex2(fmaf(s[e + 1], a.scale_log2, -mn0));
        s[e + 2] = ex2(fmaf(s[e + 2], a.scale_log2, -mn1));
        s[e + 3] = ex2(fmaf(s[e + 3], a.scale_log2, -mn1));
        l0 += s[e] + s[e + 1];
        l1 += s[e + 2] + s[e + 3];
      }
      m0 = mn0;
      m1 = mn1;
      if (!kExact) {
#pragma unroll
        for (int e = 0; e < 32; e += 4) {
          oacc[e] *= al0;
          oacc[e + 1] *= al0;
          oacc[e + 2] *= al1;
          oacc[e + 3] *= al1;
        }
        pv(oacc, s, j);
        // release the stage; the last warp that needed it refills it
        __syncwarp();
        if (lane == 0) {
          int need = 0;
#pragma unroll
          for (int i = 0; i < kWG; ++i) need += j < ntw[i] ? 4 : 0;
          if (atomicAdd(&released[s_idx], 1) == need - 1) {
            released[s_idx] = 0;
            const int jn = j + a.stages;
            if (jn < nkb) {
              const uint32_t bar = kv_full + 8 * s_idx;
              mbar_expect(bar, 2 * kTileBytes);
              tma_tile(k_s + s_idx * kTileBytes, &kmap, bar, col0, jn * kTile, seq);
              tma_tile(v_s + s_idx * kTileBytes, &vmap, bar, col0, jn * kTile, seq);
            }
          }
        }
      }
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    float i0, i1;
    if (kExact) {   // pass 2: p = bf16(exp(s - m) / l), O += p V
      i0 = 1.f / l0;
      i1 = 1.f / l1;
      for (int j = 0; j < nk; ++j) {
        float s[32];
        scores(s, j);
#pragma unroll
        for (int e = 0; e < 32; e += 4) {
          s[e] = ex2(fmaf(s[e], a.scale_log2, -m0)) * i0;
          s[e + 1] = ex2(fmaf(s[e + 1], a.scale_log2, -m0)) * i0;
          s[e + 2] = ex2(fmaf(s[e + 2], a.scale_log2, -m1)) * i1;
          s[e + 3] = ex2(fmaf(s[e + 3], a.scale_log2, -m1)) * i1;
        }
        pv(oacc, s, j);
      }
      i0 = i1 = 1.f;
      // the warpgroup is done with its Q tile: load the next one while this one is stored
      asm volatile("bar.sync %0, 128;" ::"r"(1 + w) : "memory");
      if (wt == 0 && qi + qstep < nqt) {
        mbar_expect(q_full + 8 * w, kTileBytes);
        tma_tile(q_t, &qmap, q_full + 8 * w, col0, (qi + qstep) * kTile, seq);
      }
    } else {
      i0 = 1.f / fmaxf(l0, 1e-30f);
      i1 = 1.f / fmaxf(l1, 1e-30f);
    }

    bf16* o0 = a.o + (size_t)seq * a.ob + (size_t)row0 * a.orow + col0 + 2 * t;
    bf16* o1 = o0 + 8 * a.orow;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      if (row0 < a.Tq)
        *reinterpret_cast<uint32_t*>(o0 + 8 * jn) =
            pack2(oacc[4 * jn] * i0, oacc[4 * jn + 1] * i0);
      if (row1 < a.Tq)
        *reinterpret_cast<uint32_t*>(o1 + 8 * jn) =
            pack2(oacc[4 * jn + 2] * i1, oacc[4 * jn + 3] * i1);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: K11 and K4 / K12, true f32 products on the CUDA cores
// ---------------------------------------------------------------------------
constexpr int kF32Threads = 128;
constexpr int kF32Ld = kHeadDim + 4;   // padded rows of Q, K and P (floats): conflict-free reads
constexpr int kF32Smem = (kTile * kF32Ld * 2 + 2 * kTile * kF32Ld + 2 * kTile * kHeadDim) * 4;

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Grid x: (query tile counted from the end) x nbh + sequence * H + head.
__global__ void __launch_bounds__(kF32Threads, 2)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int Tq, int Tk, int nbh,
                     int H, long long qsb, long long ksb, long long sr, long long ob,
                     long long orow, int causal, int q_offset, float scale) {
  extern __shared__ __align__(16) float fsm[];
  float* q_s = fsm;                          // 64 x kF32Ld
  float* p_s = q_s + kTile * kF32Ld;         // 64 x kF32Ld: P between the products
  float* k_s = p_s + kTile * kF32Ld;         // 2 x 64 x kF32Ld
  float* v_s = k_s + 2 * kTile * kF32Ld;     // 2 x 64 x 64
  const int tid = threadIdx.x;
  const int kg = tid & 7, rg = tid >> 3;     // keys kg + 8 j / features 4 kg + 32 h; rows 4 rg + i
  const int nqt = (Tq + kTile - 1) / kTile;
  const int q0 = (nqt - 1 - (int)(blockIdx.x / nbh)) * kTile;
  const int bh = blockIdx.x % nbh, seq = bh / H, head = bh % H;
  const float* qb = q + (size_t)seq * qsb + (size_t)head * kHeadDim;
  const float* kb = k + (size_t)seq * ksb + (size_t)head * kHeadDim;
  const float* vb = v + (size_t)seq * ksb + (size_t)head * kHeadDim;
  const int kend = causal ? min(Tk, q_offset + min(q0 + kTile, Tq)) : Tk;
  const int ntiles = (kend + kTile - 1) / kTile;

  auto stage = [&](int j) {   // K and V tile j into buffer j & 1; rows past Tk are zeros
    float* kd = k_s + (j & 1) * kTile * kF32Ld;
    float* vd = v_s + (j & 1) * kTile * kHeadDim;
    for (int idx = tid; idx < kTile * 16; idx += kF32Threads) {
      const int r = idx >> 4, c = (idx & 15) * 4, key = j * kTile + r;
      const bool ok = key < Tk;
      const size_t off = (size_t)(ok ? key : 0) * sr + c;
      cp_async16(kd + r * kF32Ld + c, kb + off, ok);
      cp_async16(vd + r * kHeadDim + c, vb + off, ok);
    }
  };
  for (int idx = tid; idx < kTile * 16; idx += kF32Threads) {
    const int r = idx >> 4, c = (idx & 15) * 4;
    const bool ok = q0 + r < Tq;
    cp_async16(q_s + r * kF32Ld + c, qb + (size_t)(ok ? q0 + r : 0) * sr + c, ok);
  }
  stage(0);
  cp_async_commit();

  float acc[4][8], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }
  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {
      stage(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = k_s + (j & 1) * kTile * kF32Ld;
    const float* vt = v_s + (j & 1) * kTile * kHeadDim;

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kHeadDim; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_s + (4 * rg + i) * kF32Ld + d);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 kv = *reinterpret_cast<const float4*>(kt + (kg + 8 * c) * kF32Ld + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][c] = fmaf(qv[i].x, kv.x, s[i][c]);
          s[i][c] = fmaf(qv[i].y, kv.y, s[i][c]);
          s[i][c] = fmaf(qv[i].z, kv.z, s[i][c]);
          s[i][c] = fmaf(qv[i].w, kv.w, s[i][c]);
        }
      }
    }
    const int n0 = j * kTile;
    const bool edge = n0 + kTile > Tk || (causal && n0 + kTile - 1 > q_offset + q0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + 4 * rg + i;
      float mx = kMasked;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int key = n0 + kg + 8 * c;
        const bool ok = !edge || (key < Tk && (!causal || key <= qpos));
        s[i][c] = ok ? s[i][c] * scale : kMasked;
        mx = fmaxf(mx, s[i][c]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float mn = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float p = expf(s[i][c] - mn);
        rs += p;
        p_s[(4 * rg + i) * kF32Ld + kg + 8 * c] = p;
      }
      l[i] = l[i] * alpha + rs;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < kTile; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(p_s + (4 * rg + i) * kF32Ld + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 lo = *reinterpret_cast<const float4*>(vt + (kk + u) * kHeadDim + 4 * kg);
        const float4 hi = *reinterpret_cast<const float4*>(vt + (kk + u) * kHeadDim + 32 + 4 * kg);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y : u == 2 ? pv[i].z : pv[i].w;
          acc[i][0] = fmaf(p, lo.x, acc[i][0]);
          acc[i][1] = fmaf(p, lo.y, acc[i][1]);
          acc[i][2] = fmaf(p, lo.z, acc[i][2]);
          acc[i][3] = fmaf(p, lo.w, acc[i][3]);
          acc[i][4] = fmaf(p, hi.x, acc[i][4]);
          acc[i][5] = fmaf(p, hi.y, acc[i][5]);
          acc[i][6] = fmaf(p, hi.z, acc[i][6]);
          acc[i][7] = fmaf(p, hi.w, acc[i][7]);
        }
      }
    }
    __syncthreads();   // this buffer and P are rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    li += __shfl_xor_sync(0xffffffffu, li, 4);
    const int row = q0 + 4 * rg + i;
    if (row >= Tq) continue;
    const float inv = 1.f / fmaxf(li, 1e-30f);
    float* op = o + (size_t)seq * ob + (size_t)row * orow + (size_t)head * kHeadDim + 4 * kg;
    *reinterpret_cast<float4*>(op) =
        make_float4(acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv, acc[i][3] * inv);
    *reinterpret_cast<float4*>(op + 32) =
        make_float4(acc[i][4] * inv, acc[i][5] * inv, acc[i][6] * inv, acc[i][7] * inv);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
// A 3-D map (columns, rows, sequences) over bf16 rows of `cols` elements with
// the given strides (elements), read in 64 x 64 tiles with the 128-byte swizzle;
// reads past `rows` or `seqs` are zeros.
int tile_map(CUtensorMap* map, const void* base, long long cols, long long rows, long long seqs,
             long long row_stride, long long seq_stride) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)seqs};
  const cuuint64_t strides[2] = {(cuuint64_t)row_stride * 2, (cuuint64_t)seq_stride * 2};
  const cuuint32_t box[3] = {kHeadDim, kTile, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int bf16_smem(int stages, int wg) {   // alignment, tiles, barriers, stage counters
  return 1024 + (2 * stages + wg) * kTileBytes + (stages + wg) * 8 + stages * 4;
}

template <bool kExact, int kWG>
int launch_bf16(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                const Bf16Args& a, dim3 grid, cudaStream_t stream) {
  const int smem = bf16_smem(a.stages, kWG);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(attention_bf16_kernel<kExact, kWG>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(attention_bf16_kernel<kExact, kWG>,
                       cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  attention_bf16_kernel<kExact, kWG><<<grid, kWG * 128, smem, stream>>>(qm, km, vm, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v: element (b, t, h, j) at b * sb + t * sr + h * 64 + j (16-byte
// aligned base, sb and sr multiples of 8); o alike with ob / orow.
// Packed (B, T, H * 64): H heads. (BH, T, 64): B = BH sequences of H = 1 head.
int short_attention_bf16(const void* q, const void* k, const void* v, void* o, int B, int H,
                         int T, long long sb, long long sr, long long ob, long long orow,
                         int causal, void* stream) {
  const long long bh = (long long)B * H;
  if (T < 1 || T > kMaxT || B < 1 || H < 1 || bh > 2147483647LL) return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  int err;
  if ((err = tile_map(&qm, q, (long long)H * kHeadDim, T, B, sr, sb)) != 0 ||
      (err = tile_map(&km, k, (long long)H * kHeadDim, T, B, sr, sb)) != 0 ||
      (err = tile_map(&vm, v, (long long)H * kHeadDim, T, B, sr, sb)) != 0)
    return err;
  const int nt = (T + kTile - 1) / kTile;
  // two blocks of two warpgroups an SM while their K/V fit, else one of four
  const bool pair = 2 * (bf16_smem(nt, 2) + 1024) <= kSmemSm;
  const int wg = pair ? 2 : 4, slots = kSms * (pair ? 2 : 1);
  // split a head's query tiles over several blocks only while the heads alone
  // leave block slots idle
  int nsplit = (int)((slots + bh - 1) / bh);
  nsplit = max(1, min(nsplit, (nt + wg - 1) / wg));
  Bf16Args a{(bf16*)o, ob, orow, T, T, H, (int)bh, causal, 0, nsplit, nt,
             kLog2e / sqrtf((float)kHeadDim)};
  const dim3 grid((unsigned)bh, (unsigned)nsplit);
  return pair ? launch_bf16<true, 2>(qm, km, vm, a, grid, (cudaStream_t)stream)
              : launch_bf16<true, 4>(qm, km, vm, a, grid, (cudaStream_t)stream);
}

// q, o: (BH, Tq, 64); k, v: (BH, Tk, 64); contiguous, 16-byte aligned. With
// causal, query row i sees keys <= q_offset + i.
int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int BH, int Tq,
                         int Tk, int causal, int q_offset, void* stream) {
  if (BH < 1 || Tq < 1 || Tk < 1 || q_offset < 0) return (int)cudaErrorInvalidValue;
  const long long nqb = (Tq + 2 * kTile - 1) / (2 * kTile);
  if (nqb * BH > 2147483647LL) return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  int err;
  if ((err = tile_map(&qm, q, kHeadDim, Tq, BH, kHeadDim, (long long)Tq * kHeadDim)) != 0 ||
      (err = tile_map(&km, k, kHeadDim, Tk, BH, kHeadDim, (long long)Tk * kHeadDim)) != 0 ||
      (err = tile_map(&vm, v, kHeadDim, Tk, BH, kHeadDim, (long long)Tk * kHeadDim)) != 0)
    return err;
  Bf16Args a{(bf16*)o, (long long)Tq * kHeadDim, kHeadDim, Tq, Tk, 1, BH, causal, q_offset, 1,
             kFlashStages, kLog2e / sqrtf((float)kHeadDim)};
  return launch_bf16<false, 2>(qm, km, vm, a, dim3((unsigned)(nqb * BH)), (cudaStream_t)stream);
}

int flash_attention_f32(const void* q, const void* k, const void* v, void* o, int BH, int Tq,
                        int Tk, int causal, int q_offset, void* stream) {
  if (BH < 1 || Tq < 1 || Tk < 1 || q_offset < 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)(Tq + kTile - 1) / kTile * BH;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(attention_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kF32Smem);
  attention_f32_kernel<<<(unsigned)blocks, kF32Threads, kF32Smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, Tq, Tk, BH, 1,
      (long long)Tq * kHeadDim, (long long)Tk * kHeadDim, kHeadDim, (long long)Tq * kHeadDim,
      kHeadDim, causal, q_offset, 1.0f / sqrtf((float)kHeadDim));
  return (int)cudaGetLastError();
}

// The f32 variant of short_attention_bf16: the same addressing (sb and sr
// multiples of 4 here), the softmax taken tile by tile over the T <= 640 keys.
int short_attention_f32(const void* q, const void* k, const void* v, void* o, int B, int H, int T,
                        long long sb, long long sr, long long ob, long long orow, int causal,
                        void* stream) {
  const long long bh = (long long)B * H;
  if (T < 1 || T > kMaxT || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)(T + kTile - 1) / kTile * bh;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(attention_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kF32Smem);
  attention_f32_kernel<<<(unsigned)blocks, kF32Threads, kF32Smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, T, T, (int)bh, H, sb, sb, sr,
      ob, orow, causal, 0, 1.0f / sqrtf((float)kHeadDim));
  return (int)cudaGetLastError();
}

}  // extern "C"
