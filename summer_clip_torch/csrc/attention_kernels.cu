// One-pass softmax attention for short sequences (bf16, head dim 64, sm_90a).
//
// Replaces the TPU kernels of summer_clip_tpu/ops/attention.py:
//   K4  short_attention_packed -> short_attention, heads read as 64-column
//       slices of the packed (B, T, H*64) tensors (row stride given by the
//       caller, so q/k/v may be views of one fused (B, T, 3D) projection);
//   K12 short_attention        -> the same device code on (BH, T, 64).
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

}  // extern "C"
