// Softmax attention kernels (head dim 64, sm_90a): one pass over short
// sequences in bf16, tile by tile (online softmax) in bf16 and f32.
//
// Replaces the TPU kernels of summer_clip_tpu/ops/attention.py:
//   K4  short_attention_packed -> short_attention, heads read as 64-column
//       slices of the packed (B, T, H*64) tensors (row stride given by the
//       caller, so q/k/v may be views of one fused (B, T, 3D) projection);
//   K12 short_attention        -> the same device code on (BH, T, 64).
// f32 operands (an f32 model at short T) take short_attention_f32, the f32
// device code of K11 below on the same addressing.
// Neither side of the kernel transposes anything in device memory, which is
// the point of the packed TPU kernel.
//
// Per (sequence, head): s = q k^T / sqrt(64) in f32, optional causal mask,
// exact softmax over the whole key row in f32, p / l rounded to bf16 before
// the PV product (the TPU kernel's rounding point), f32 accumulation, bf16 out.
//
// What bounds it on Hopper. The work is bound by bytes (q, k, v in, o out:
// 67 MB at ViT-L/14 B = 32 against 8.7 GFLOP), so scores and probabilities
// must never reach device memory, and enough warps must be in flight to hide
// latency. The TPU keeps whole (T, T) f32 score tiles of several heads in
// VMEM; a (257, 257) f32 tile is 264 KB and does not fit a Hopper block, and
// keeping even 16 f32 score rows per warp in shared memory leaves one block
// of 7 warps per SM (the first version of this kernel: 0.52 ms at ViT-L/14
// shapes). So nothing but K and V^T of one head lives in shared memory
// (75 KB at T = 257, three blocks per SM) and the scores live in registers:
// a warp owns 16 queries and walks the keys three times with
// mma.sync.m16n8k16 -- row maximum, row sum of exp(s - m), then p = exp(s - m)
// / l rounded to bf16 and fed straight into the PV product as the A operand
// (the accumulator layout of two 8-key score tiles is the A layout of one
// 16-key step). The softmax stays exact over the whole row; the price is two
// more QK^T passes, which the tensor cores have to spare here. Row maxima and
// sums reduce over the 4 lanes that share a row. Padded keys (T rounded up to
// 16) are masked to -inf and never enter the maximum or the sum.
// Next steps: K/V through TMA, 64-query warpgroup tiles with wgmma.
//
//
//   K11 flash_attention        -> flash_attention_bf16 / flash_attention_f32,
//       online-softmax attention on (BH, T, 64) with Tq != Tk and a causal
//       mask shifted by q_offset (row i sees keys <= q_offset + i).
// The TPU kernel keeps all of K and V of a head in VMEM and pads the 64-wide
// heads to 128 lanes; neither has a counterpart here. A block owns 64 queries
// of one head (bf16: 4 warps of 16 queries on mma.sync.m16n8k16; f32: 128
// threads, a query each, plain FMA with true f32 products) and walks the keys
// in tiles staged in shared memory (K, and V transposed for the bf16 B
// operand), so scores never reach device memory and a causal block stops at
// its last visible key. Per tile: s = q k^T / 8 in f32, masked scores -1e30,
// m, l and the accumulator rescaled as in the TPU kernel, p rounded to the
// value type before the PV product, out = acc / max(l, 1e-30). At T = 1024
// the work is bound by operations, not bytes (bf16: 43 GFLOP against 84 MB
// at BH = 160), so the next step is wgmma on 64-query warpgroup tiles.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kHeadDim = 64;
constexpr int kPad = 8;                  // bf16 row padding of shared tiles
constexpr int kLdh = kHeadDim + kPad;    // K rows in shared memory (144 bytes)
constexpr int kMaxT = 640;               // K and V^T of one head: 175 KB
constexpr int kSmemLimit = 232448;       // dynamic shared memory a block may use
constexpr int kSms = 132;

__device__ __forceinline__ uint4 ld16(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ uint32_t ld4(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D (16 x 8, f32) += A (16 x 16, bf16, row) * B (16 x 8, bf16, col).
// Lane = 4 g + t. A: a0 (row g, cols 2t..), a1 (row g + 8, cols 2t..),
// a2 (row g, cols 2t + 8..), a3 (row g + 8, cols 2t + 8..).
// B: b0 (k 2t.., n g), b1 (k 2t + 8.., n g). D: d0 d1 (row g, cols 2t, 2t + 1),
// d2 d3 (row g + 8, the same columns).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Scaled, masked scores of the warp's 16 queries (rows row0 + g and + 8)
// against keys n0 .. n0 + 7: s[0] s[1] row g, keys n0 + 2t, + 1; s[2] s[3]
// row g + 8. A masked score is -inf.
__device__ __forceinline__ void score_tile(float (&s)[4], const uint32_t (&qa)[4][4],
                                           const bf16* k_s, int n0, int row0, int g, int t,
                                           float scale, int T, int causal) {
  s[0] = s[1] = s[2] = s[3] = 0.f;
  const bf16* krow = k_s + (n0 + g) * kLdh + 2 * t;
#pragma unroll
  for (int c = 0; c < kHeadDim / 16; ++c)
    mma16816(s, qa[c], ld4(krow + c * 16), ld4(krow + c * 16 + 8));
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int key = n0 + 2 * t + (e & 1), row = row0 + g + (e >> 1) * 8;
    const bool ok = key < T && (!causal || key <= row);
    s[e] = ok ? s[e] * scale : -INFINITY;
  }
}

// Element (b, t, h, j) of q, k and v lies at b * sb + t * sr + h * 64 + j (o at
// ob / orow alike). Grid: x = sequence * H + head, y = query split; query tile
// qt goes to split (qt / 8) % nsplit, warp qt % 8.
__global__ void __launch_bounds__(kThreads)
short_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       int T, int Tp, int H, long long sb, long long sr, long long ob,
                       long long orow, int causal, float scale, int nsplit) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t in_base = (size_t)b * sb + (size_t)h * kHeadDim;
  const size_t out_base = (size_t)b * ob + (size_t)h * kHeadDim;
  const int ldv = Tp + kPad;

  bf16* k_s = reinterpret_cast<bf16*>(smem);   // Tp x kLdh: K, a key per row
  bf16* vt_s = k_s + Tp * kLdh;                // 64 x ldv: V^T, a head column per row

  // K, and V transposed, of this head; 16 bytes a thread from device memory.
  // Keys past T are zero (a padded value must be finite: its probability is 0).
  const int nkt = Tp / 16;
  for (int idx = tid; idx < Tp * (kHeadDim / 8); idx += kThreads) {
    const int r = idx / (kHeadDim / 8), c = (idx % (kHeadDim / 8)) * 8;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (r < T) {
      kv = ld16(k + in_base + (size_t)r * sr + c);
      vv = ld16(v + in_base + (size_t)r * sr + c);
    }
    *reinterpret_cast<uint4*>(k_s + r * kLdh + c) = kv;
    const bf16* e = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
    for (int j = 0; j < 8; ++j) vt_s[(c + j) * ldv + r] = e[j];
  }
  __syncthreads();

  for (int qt = blockIdx.y * kWarps + warp; qt < nkt; qt += nsplit * kWarps) {
    const int row0 = qt * 16;
    // this warp's 16 queries as A fragments, straight from device memory
    uint32_t qa[kHeadDim / 16][4];
    {
      const bool ok0 = row0 + g < T, ok1 = row0 + g + 8 < T;
      const bf16* q0 = q + in_base + (size_t)(row0 + g) * sr + 2 * t;
      const bf16* q1 = q0 + 8 * sr;
#pragma unroll
      for (int c = 0; c < kHeadDim / 16; ++c) {
        qa[c][0] = ok0 ? ld4(q0 + c * 16) : 0u;
        qa[c][1] = ok1 ? ld4(q1 + c * 16) : 0u;
        qa[c][2] = ok0 ? ld4(q0 + c * 16 + 8) : 0u;
        qa[c][3] = ok1 ? ld4(q1 + c * 16 + 8) : 0u;
      }
    }
    const int chunks = causal ? qt + 1 : nkt;   // 16-key steps this tile sees

    // pass 1: row maxima (every row sees key 0, so they are finite)
    float m0 = -INFINITY, m1 = -INFINITY;
    for (int n0 = 0; n0 < chunks * 16; n0 += 8) {
      float s[4];
      score_tile(s, qa, k_s, n0, row0, g, t, scale, T, causal);
      m0 = fmaxf(m0, fmaxf(s[0], s[1]));
      m1 = fmaxf(m1, fmaxf(s[2], s[3]));
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);

    // pass 2: row sums of exp(s - m); exp(-inf) = 0 for masked keys
    float l0 = 0.f, l1 = 0.f;
    for (int n0 = 0; n0 < chunks * 16; n0 += 8) {
      float s[4];
      score_tile(s, qa, k_s, n0, row0, g, t, scale, T, causal);
      l0 += expf(s[0] - m0) + expf(s[1] - m0);
      l1 += expf(s[2] - m1) + expf(s[3] - m1);
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);

    // pass 3: p = bf16(exp(s - m) / l), o += p v, 16 keys a step
    float oacc[kHeadDim / 8][4];
#pragma unroll
    for (int dt = 0; dt < kHeadDim / 8; ++dt)
      oacc[dt][0] = oacc[dt][1] = oacc[dt][2] = oacc[dt][3] = 0.f;
    for (int kc = 0; kc < chunks; ++kc) {
      float s0[4], s1[4];
      score_tile(s0, qa, k_s, kc * 16, row0, g, t, scale, T, causal);
      score_tile(s1, qa, k_s, kc * 16 + 8, row0, g, t, scale, T, causal);
      uint32_t pa[4];
      pa[0] = pack2(expf(s0[0] - m0) / l0, expf(s0[1] - m0) / l0);
      pa[1] = pack2(expf(s0[2] - m1) / l1, expf(s0[3] - m1) / l1);
      pa[2] = pack2(expf(s1[0] - m0) / l0, expf(s1[1] - m0) / l0);
      pa[3] = pack2(expf(s1[2] - m1) / l1, expf(s1[3] - m1) / l1);
      const bf16* vrow = vt_s + g * ldv + kc * 16 + 2 * t;
#pragma unroll
      for (int dt = 0; dt < kHeadDim / 8; ++dt)
        mma16816(oacc[dt], pa, ld4(vrow + dt * 8 * ldv), ld4(vrow + dt * 8 * ldv + 8));
    }

    bf16* o0 = o + out_base + (size_t)(row0 + g) * orow + 2 * t;
    bf16* o1 = o0 + 8 * orow;
#pragma unroll
    for (int dt = 0; dt < kHeadDim / 8; ++dt) {
      if (row0 + g < T)
        *reinterpret_cast<uint32_t*>(o0 + dt * 8) = pack2(oacc[dt][0], oacc[dt][1]);
      if (row0 + g + 8 < T)
        *reinterpret_cast<uint32_t*>(o1 + dt * 8) = pack2(oacc[dt][2], oacc[dt][3]);
    }
  }
}


// ---------------------------------------------------------------------------
// K11, bf16. Grid: x = query tile of 64, y = head. q, o: (BH, Tq, 64); k, v:
// (BH, Tk, 64), contiguous.
// ---------------------------------------------------------------------------
constexpr int kFlashWarps = 4;
constexpr int kFlashThreads = kFlashWarps * 32;
constexpr int kFlashQ = kFlashWarps * 16;   // queries a block
constexpr int kFlashK = 64;                 // keys a tile
constexpr int kLdv = kFlashK + kPad;        // V^T rows in shared memory
constexpr float kMasked = -1e30f;

__global__ void __launch_bounds__(kFlashThreads)
flash_attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ o, int Tq, int Tk,
                            int causal, int q_offset, float scale) {
  __shared__ __align__(16) bf16 k_s[kFlashK * kLdh];     // a key per row
  __shared__ __align__(16) bf16 vt_s[kHeadDim * kLdv];   // a head column per row
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kFlashQ;
  const int row0 = q0 + warp * 16;
  const size_t qbase = (size_t)blockIdx.y * Tq * kHeadDim;
  const size_t kbase = (size_t)blockIdx.y * Tk * kHeadDim;

  uint32_t qa[kHeadDim / 16][4];
  {
    const bool ok0 = row0 + g < Tq, ok1 = row0 + g + 8 < Tq;
    const bf16* p0 = q + qbase + (size_t)(row0 + g) * kHeadDim + 2 * t;
    const bf16* p1 = p0 + 8 * kHeadDim;
#pragma unroll
    for (int c = 0; c < kHeadDim / 16; ++c) {
      qa[c][0] = ok0 ? ld4(p0 + c * 16) : 0u;
      qa[c][1] = ok1 ? ld4(p1 + c * 16) : 0u;
      qa[c][2] = ok0 ? ld4(p0 + c * 16 + 8) : 0u;
      qa[c][3] = ok1 ? ld4(p1 + c * 16 + 8) : 0u;
    }
  }
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float oacc[kHeadDim / 8][4];
#pragma unroll
  for (int dt = 0; dt < kHeadDim / 8; ++dt)
    oacc[dt][0] = oacc[dt][1] = oacc[dt][2] = oacc[dt][3] = 0.f;

  // keys this block can see: all of them, or up to its last query's position
  int kend = Tk;
  if (causal) kend = min(Tk, q_offset + min(q0 + kFlashQ, Tq));
  const int qr0 = q_offset + row0 + g, qr1 = qr0 + 8;   // absolute query positions

  for (int n0 = 0; n0 < kend; n0 += kFlashK) {
    __syncthreads();   // the previous tile is no longer read
    for (int idx = tid; idx < kFlashK * (kHeadDim / 8); idx += kFlashThreads) {
      const int r = idx / (kHeadDim / 8), c = (idx % (kHeadDim / 8)) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (n0 + r < Tk) {
        kv = ld16(k + kbase + (size_t)(n0 + r) * kHeadDim + c);
        vv = ld16(v + kbase + (size_t)(n0 + r) * kHeadDim + c);
      }
      *reinterpret_cast<uint4*>(k_s + r * kLdh + c) = kv;
      const bf16* e = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt_s[(c + j) * kLdv + r] = e[j];
    }
    __syncthreads();

    float s[kFlashK / 8][4];
    float mx0 = kMasked, mx1 = kMasked;
#pragma unroll
    for (int nt = 0; nt < kFlashK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* krow = k_s + (nt * 8 + g) * kLdh + 2 * t;
#pragma unroll
      for (int c = 0; c < kHeadDim / 16; ++c)
        mma16816(s[nt], qa[c], ld4(krow + c * 16), ld4(krow + c * 16 + 8));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + nt * 8 + 2 * t + (e & 1);
        const int qr = (e >> 1) ? qr1 : qr0;
        const bool ok = key < Tk && (!causal || key <= qr);
        s[nt][e] = ok ? s[nt][e] * scale : kMasked;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kFlashK / 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - mn0);
      s[nt][1] = expf(s[nt][1] - mn0);
      s[nt][2] = expf(s[nt][2] - mn1);
      s[nt][3] = expf(s[nt][3] - mn1);
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * a0 + quad_sum(rs0);
    l1 = l1 * a1 + quad_sum(rs1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int dt = 0; dt < kHeadDim / 8; ++dt) {
      oacc[dt][0] *= a0;
      oacc[dt][1] *= a0;
      oacc[dt][2] *= a1;
      oacc[dt][3] *= a1;
    }
    // p rounded to bf16; two 8-key score tiles are the A operand of a 16-key step
#pragma unroll
    for (int kc = 0; kc < kFlashK / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack2(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack2(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack2(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack2(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const bf16* vrow = vt_s + g * kLdv + kc * 16 + 2 * t;
#pragma unroll
      for (int dt = 0; dt < kHeadDim / 8; ++dt)
        mma16816(oacc[dt], pa, ld4(vrow + dt * 8 * kLdv), ld4(vrow + dt * 8 * kLdv + 8));
    }
  }

  const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
  bf16* o0 = o + qbase + (size_t)(row0 + g) * kHeadDim + 2 * t;
  bf16* o1 = o0 + 8 * kHeadDim;
#pragma unroll
  for (int dt = 0; dt < kHeadDim / 8; ++dt) {
    if (row0 + g < Tq)
      *reinterpret_cast<uint32_t*>(o0 + dt * 8) = pack2(oacc[dt][0] * i0, oacc[dt][1] * i0);
    if (row0 + g + 8 < Tq)
      *reinterpret_cast<uint32_t*>(o1 + dt * 8) = pack2(oacc[dt][2] * i1, oacc[dt][3] * i1);
  }
}

// ---------------------------------------------------------------------------
// K11 and K4 / K12, f32: true f32 products on the CUDA cores. A thread owns
// one query (its 64 features and 64 accumulators in registers); K and V tiles
// of 32 keys are read from shared memory as broadcasts. Element (b, t, h, j) of
// q lies at b * qsb + t * sr + h * 64 + j, of k and v at b * ksb + ..., of o at
// b * ob + t * orow + h * 64 + j; blockIdx.x = b * H + h. So the same code
// serves (BH, T, 64) tensors (H = 1) and the heads of packed (B, T, H * 64)
// ones, views of a fused projection included.
// ---------------------------------------------------------------------------
constexpr int kF32Threads = 128;   // queries a block
constexpr int kF32K = 32;          // keys a tile

__global__ void __launch_bounds__(kF32Threads)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int Tq, int Tk, int H,
                     long long qsb, long long ksb, long long sr, long long ob, long long orow,
                     int causal, int q_offset, float scale) {
  __shared__ __align__(16) float k_s[kF32K * kHeadDim];
  __shared__ __align__(16) float v_s[kF32K * kHeadDim];
  const int tid = threadIdx.x;
  const int q0 = blockIdx.y * kF32Threads;
  const int row = q0 + tid;
  const bool live = row < Tq;
  const int seq = blockIdx.x / H, head = blockIdx.x % H;
  const size_t qbase = (size_t)seq * qsb + (size_t)head * kHeadDim;
  const size_t kbase = (size_t)seq * ksb + (size_t)head * kHeadDim;
  const size_t obase = (size_t)seq * ob + (size_t)head * kHeadDim;

  float qv[kHeadDim], acc[kHeadDim];
#pragma unroll
  for (int d = 0; d < kHeadDim; d += 4) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) x = *reinterpret_cast<const float4*>(q + qbase + (size_t)row * sr + d);
    qv[d] = x.x; qv[d + 1] = x.y; qv[d + 2] = x.z; qv[d + 3] = x.w;
    acc[d] = acc[d + 1] = acc[d + 2] = acc[d + 3] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  int kend = Tk;
  if (causal) kend = min(Tk, q_offset + min(q0 + kF32Threads, Tq));
  const int qpos = q_offset + row;

  for (int n0 = 0; n0 < kend; n0 += kF32K) {
    __syncthreads();
    for (int idx = tid; idx < kF32K * (kHeadDim / 4); idx += kF32Threads) {
      const int r = idx / (kHeadDim / 4), c = (idx % (kHeadDim / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (n0 + r < Tk) {
        kv = *reinterpret_cast<const float4*>(k + kbase + (size_t)(n0 + r) * sr + c);
        vv = *reinterpret_cast<const float4*>(v + kbase + (size_t)(n0 + r) * sr + c);
      }
      *reinterpret_cast<float4*>(k_s + r * kHeadDim + c) = kv;
      *reinterpret_cast<float4*>(v_s + r * kHeadDim + c) = vv;
    }
    __syncthreads();

    float s[kF32K];
    float mx = kMasked;
#pragma unroll
    for (int j = 0; j < kF32K; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < kHeadDim; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(k_s + j * kHeadDim + d);
        dot = fmaf(qv[d], kv.x, dot);
        dot = fmaf(qv[d + 1], kv.y, dot);
        dot = fmaf(qv[d + 2], kv.z, dot);
        dot = fmaf(qv[d + 3], kv.w, dot);
      }
      const int key = n0 + j;
      const bool ok = key < Tk && (!causal || key <= qpos);
      s[j] = ok ? dot * scale : kMasked;
      mx = fmaxf(mx, s[j]);
    }
    const float mn = fmaxf(m, mx);
    const float alpha = expf(m - mn);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < kF32K; ++j) {
      s[j] = expf(s[j] - mn);
      rs += s[j];
    }
    l = l * alpha + rs;
    m = mn;
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kF32K; ++j) {
#pragma unroll
      for (int d = 0; d < kHeadDim; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(v_s + j * kHeadDim + d);
        acc[d] = fmaf(s[j], vv.x, acc[d]);
        acc[d + 1] = fmaf(s[j], vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(s[j], vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(s[j], vv.w, acc[d + 3]);
      }
    }
  }
  if (!live) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int d = 0; d < kHeadDim; d += 4)
    *reinterpret_cast<float4*>(o + obase + (size_t)row * orow + d) =
        make_float4(acc[d] * inv, acc[d + 1] * inv, acc[d + 2] * inv, acc[d + 3] * inv);
}

}  // namespace

extern "C" {

// q, k, v: element (b, t, h, j) at b * sb + t * sr + h * 64 + j (16-byte
// aligned base, sb and sr multiples of 8); o alike with ob / orow.
// Packed (B, T, H * 64): H heads. (BH, T, 64): B = BH sequences of H = 1 head.
int short_attention_bf16(const void* q, const void* k, const void* v, void* o, int B, int H,
                         int T, long long sb, long long sr, long long ob, long long orow,
                         int causal, void* stream) {
  if (T < 1 || T > kMaxT || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const int Tp = (T + 15) / 16 * 16;
  const int smem = (Tp * kLdh + kHeadDim * (Tp + kPad)) * 2;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const int nkt = Tp / 16;
  // split the queries of one head over several blocks only while the
  // (sequence, head) pairs alone leave SMs idle
  const long long bh = (long long)B * H;
  int nsplit = (int)((2 * kSms + bh - 1) / bh);
  const int max_split = (nkt + kWarps - 1) / kWarps;
  if (nsplit > max_split) nsplit = max_split;
  if (nsplit < 1) nsplit = 1;
  cudaFuncSetAttribute(short_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const float scale = 1.0f / sqrtf((float)kHeadDim);
  dim3 grid((unsigned)bh, (unsigned)nsplit);
  short_attention_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, T, Tp, H, sb, sr, ob, orow,
      causal, scale, nsplit);
  return (int)cudaGetLastError();
}

// q, o: (BH, Tq, 64); k, v: (BH, Tk, 64); contiguous, 16-byte aligned. With
// causal, query row i sees keys <= q_offset + i.
int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int BH, int Tq,
                         int Tk, int causal, int q_offset, void* stream) {
  if (BH < 1 || BH > 65535 || Tq < 1 || Tk < 1 || q_offset < 0) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((Tq + kFlashQ - 1) / kFlashQ), (unsigned)BH);
  flash_attention_bf16_kernel<<<grid, kFlashThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, Tq, Tk, causal, q_offset,
      1.0f / sqrtf((float)kHeadDim));
  return (int)cudaGetLastError();
}

int flash_attention_f32(const void* q, const void* k, const void* v, void* o, int BH, int Tq,
                        int Tk, int causal, int q_offset, void* stream) {
  if (BH < 1 || BH > 65535 || Tq < 1 || Tk < 1 || q_offset < 0) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)BH, (unsigned)((Tq + kF32Threads - 1) / kF32Threads));
  attention_f32_kernel<<<grid, kF32Threads, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, Tq, Tk, 1,
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
  if (T < 1 || T > kMaxT || B < 1 || H < 1 || bh > 2147483647LL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)bh, (unsigned)((T + kF32Threads - 1) / kF32Threads));
  attention_f32_kernel<<<grid, kF32Threads, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, T, T, H, sb, sb, sr, ob, orow,
      causal, 0, 1.0f / sqrtf((float)kHeadDim));
  return (int)cudaGetLastError();
}

}  // extern "C"
