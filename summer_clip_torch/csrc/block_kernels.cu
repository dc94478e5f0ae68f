// Fused transformer-block halves for the CLIP towers (bf16, sm_90a).
//
// Replaces the TPU kernels of summer_clip_tpu/ops/block_kernels.py:
//   K5 fused_ln_attn (:255) -> ln_rows -> block_gemm (in_proj, + bias)
//                        -> K4's attention device code (attention_kernels.cu)
//                        -> block_gemm (out_proj, + bias, + residual)
//   K6 fused_ln_mlp (:75)   -> ln_rows -> block_gemm (c_fc, + bias, QuickGELU)
//                        -> block_gemm (c_proj, + bias, + residual)
//   K9 fused_ln_mlp_chunked (:132) -> ln_mlp_wide at D = 1024 (a cluster of two
//                        CTAs per 64-row tile; see below)
//
// K5 and K6 on this card. Their work is four or two mid-size products: at the
// ViT-B/16 image shape (6304 rows, D = 768) 59.5 GFLOP for the MLP half (0.060
// ms at 989 TFLOP/s) against 19 MB of x, out and weights (0.006 ms at 3.35
// TB/s), so operations bound them. The TPU kernels keep the weights resident in
// VMEM and the intermediates (LN(x), q/k/v, the per-head o, the MLP hidden) on
// chip. A Hopper block has 227 KB of shared memory, so the earlier design (one
// block per 32-48-row tile over all D columns, or per (sequence, head)) streamed
// all weights from L2 into every short row tile (a weight byte served 32-48
// rows: 1.3-3.9 GB of L2 intake a call) and recomputed each sequence's
// LayerNorm once per head. Here the intermediates go through device memory
// instead, in the bf16 the JAX kernels round them to before their next product,
// so the function and its rounding points stay the same; their round trip costs
// 77 MB at the image shape (0.023 ms), 242 MB at ViT-L/14 text (0.072 ms). In
// exchange every product runs as one wgmma GEMM template with row tiles of 128:
//   - ln_rows: LayerNorm a warp per row (f32 statistics, f32 scale and bias,
//     rounded to bf16), once per row: the A operand of the first product.
//   - block_gemm<BN, epilogue>: out = epilogue(A (M x K) . W^T), W the (N, K)
//     Linear weight as it lies. A block owns 128 rows x BN columns (BN = 256,
//     192 or 128, picked by ops/block_kernels.gemm_tile against the card's wave
//     count); two consumer warpgroups own 64 rows each with a 64 x BN f32
//     accumulator in registers (wgmma.m64nBNk16, both operands K-major in
//     shared memory). One producer warp brings A and W tiles 64 deep by TMA
//     (128-byte swizzle, K as it lies: nothing transposed) into a ring of 4-7
//     stages guarded by full and empty mbarriers. The epilogue works on bf16x2
//     pairs and writes the tile into the drained ring, and a TMA store takes
//     it out in whole lines. A weight byte now serves 128 rows and a 128 x 256
//     tile takes in 85 operations a byte from L2. Blocks walk the N tiles of a
//     row tile next to each other, so A is read from device memory about
//     once. What binds it (PERF.md section 6; tools/torch_block_gemm_tiles.py
//     --probe): the main loop alone runs at cuBLAS's rate on these products;
//     the epilogue (bias, QuickGELU's two special-function operations an
//     output, the residual's loads), which no tensor work overlaps, takes the
//     rest. 4-byte global stores from the accumulator layout, a 2-block
//     cluster that multicast each W tile to two row tiles (half the L2 reads),
//     a persistent grid whose ring ran on across tiles, wgmma.fence once a
//     tile and two wgmma groups in flight were each slower.
//   - epilogues, the JAX kernels' rounding points: the dot in f32 rounded to
//     bf16, the bias added in bf16; QuickGELU as bf16(1.703125 h) in bf16, the
//     sigmoid in f32 (the special-function unit's, a few f32 ulps from
//     torch.sigmoid's: see epilogue_pair) rounded to bf16, the product in
//     bf16; the residual added in bf16 (epilogue_pair). Every output is
//     summed by one block in one fixed order (64-deep stages in order, 16-deep
//     steps in order), so two runs give the same bits and a row does not
//     depend on its neighbours.
//   - K5's attention is K4's device code (short_attention_bf16) on q, k and v as
//     strided views of the fused (B, T, 3D) projection, so K5 takes T <= 640 as
//     K4 does; the wrapper launches it without counting a K4 launch.
//
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
//     Its rounding points are the epilogues' above; LayerNorm runs in f32 with
//     f32 scale and bias.
//
// Each entry point returns cudaGetLastError() after its launch (or the error of
// building a tensor map).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"   // mbarriers, TMA, wgmma, clusters, tensor maps

typedef __nv_bfloat16 bf16;

namespace {

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

// QuickGELU of a c_fc output with the JAX kernel's rounding (K9): the dot
// rounded to bf16, the bias added in bf16, bf16(1.702) * h in bf16, the sigmoid
// in f32 rounded to bf16, the product in bf16
__device__ __forceinline__ float quick_gelu_bf16(float acc, float bias, float gelu_c) {
  const float hv = round_bf16(round_bf16(acc) + bias);
  const float sg = round_bf16(gelu_c * hv);
  const float sig = round_bf16(1.f / (1.f + expf(-sg)));
  return round_bf16(hv * sig);
}

// ---------------------------------------------------------------------------
// K5 / K6 step 1: y = LN(x), a warp per row (the A operand of the first GEMM)
// ---------------------------------------------------------------------------
constexpr int kLnRowsPerBlock = 8;

__global__ void __launch_bounds__(kLnRowsPerBlock * 32)
ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ lnw,
               const float* __restrict__ lnb, bf16* __restrict__ y, int M, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const long long m = (long long)blockIdx.x * kLnRowsPerBlock + (threadIdx.x >> 5);
  if (m >= M) return;
  float mean, rstd, row[8 * kRowVecs];
  row_stats(x + m * D, D, eps, lane, row, &mean, &rstd);
#pragma unroll
  for (int u = 0; u < kRowVecs; ++u) {
    const int j = (lane + 32 * u) * 8;
    if (j < D) st16(y + m * D + j, ln8(row + 8 * u, mean, rstd, lnw + j, lnb + j));
  }
}

// ---------------------------------------------------------------------------
// K5 / K6 products: out = epilogue(A . W^T) on wgmma + TMA
// ---------------------------------------------------------------------------
__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}
// one box of shared memory to (c0, c1) of a 2-D tensor map (boxes past the
// map's edges are clipped), in this thread's bulk group
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
               : "memory");
}

// D (64 x BN, f32) (+)= A (64 x 16, shared, K-major) * B (16 x BN, shared,
// K-major), for BN = 128, 192, 256 (the accumulator's size picks the shape)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {   // m64n128k16
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate)
      : "memory");
}
__device__ __forceinline__ void wgmma_ss(float (&d)[96], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {   // m64n192k16
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
      "%92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate)
      : "memory");
}
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {   // m64n256k16
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
      "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
      "%123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate)
      : "memory");
}

namespace gemm {
constexpr int kRows = 128;                    // rows of a block tile: 64 a warpgroup
constexpr int kDepth = 64;                    // K of a stage: one 128-byte swizzled row
constexpr int kConsumerWarps = 8;             // two consumer warpgroups
constexpr int kThreads = 384;                 // and a loading warpgroup
constexpr int kABytes = kRows * kDepth * 2;   // 16 KB of A a stage
constexpr int kSmemLimit = 232448;            // shared memory a block may use
constexpr int kMaxStages = 8;
enum Epilogue { kBias = 0, kBiasGelu = 1, kBiasResidual = 2 };

template <int BN>
struct Tile {
  static_assert(BN == 128 || BN == 192 || BN == 256, "no wgmma wrapper for this tile");
  static constexpr int kStageBytes = kABytes + BN * kDepth * 2;
  // as many stages as fit beside the alignment slack and the barriers
  static constexpr int kFit = (kSmemLimit - 1024 - 16 * kMaxStages) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 16 * kStages;
  static_assert(kStages >= 3, "ring too shallow");
};
}  // namespace gemm

// An output pair (columns c, c + 1 of a row) with the JAX kernels' rounding
// points, on bf16x2 values: add.rn / mul.rn.bf16x2 round the exact sum or
// product once, as rounding the f32 result does (a sum or product of two bf16
// values is exact in f32, or its tail is below half a bf16 ulp). The dot
// rounded to bf16, the bias added in bf16; kBiasGelu: bf16(1.702) * h in
// bf16, the sigmoid in f32 rounded to bf16, the product in bf16. The residual
// is added by the caller.
//
// The sigmoid is the special-function unit's: __expf and __fdividef, a few
// f32 ulps from 1 / (1 + e^-z) (CUDA's bounds: 2 + 1.173 |z| ulps for __expf,
// 2 for __fdividef). Where its f32 value lies that close to a bf16 tie it can
// round to the bf16 next to the one that the plain version's torch.sigmoid
// (expf and an IEEE division) and the JAX kernel's f32 sigmoid round to: one
// bf16 ulp of the sigmoid, at most |h| 2^-7 in the output with the product's
// rounding. expf and a reciprocal rounded to nearest give torch.sigmoid's
// bits but made K6 1.3-1.4x slower, and taking them only near a tie 1.4-1.5x
// (PERF.md section 6).
template <int kEpi>
__device__ __forceinline__ __nv_bfloat162 epilogue_pair(float a0, float a1, __nv_bfloat162 b2) {
  const __nv_bfloat162 h = __hadd2(__floats2bfloat162_rn(a0, a1), b2);
  if (kEpi != gemm::kBiasGelu) return h;
  const float2 sg = __bfloat1622float2(__hmul2(__float2bfloat162_rn(1.702f), h));
  return __hmul2(h, __floats2bfloat162_rn(__fdividef(1.f, 1.f + __expf(-sg.x)),
                                          __fdividef(1.f, 1.f + __expf(-sg.y))));
}

// Grid: one block a (128-row, BN-column) tile, the tiles of a row tile next to
// each other along blockIdx.x, so the blocks in flight read the same A rows.
// Threads: warpgroups 0 and 1 multiply (warpgroup w owns rows 64 w .. 64 w + 63
// of the tile); one warp of warpgroup 2 loads. 384 threads cap a thread at 168
// registers, which the 128 accumulators of a 256-column tile fit.
// Ring: stage s holds the A tile (128 rows x 64 deep) and the W tile (BN rows x
// 64 deep); full[s] completes when its bytes have landed, empty[s] when the 8
// consumer warps are done with it.
template <int BN, int kEpi>
__global__ void __launch_bounds__(gemm::kThreads, 1)
block_gemm_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
                  const __grid_constant__ CUtensorMap omap, const bf16* __restrict__ bias,
                  const bf16* __restrict__ res, int M, int N, int K) {
  using namespace gemm;
  typedef Tile<BN> T;
  constexpr int S = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;        // swizzled tiles at 1024-byte boundaries
  const uint32_t full = base + S * T::kStageBytes, empty = full + 8 * S;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ntn = (N + BN - 1) / BN;
  const int n0 = ((int)blockIdx.x % ntn) * BN, m0 = ((int)blockIdx.x / ntn) * kRows;
  const int nk = (K + kDepth - 1) / kDepth;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // the loads: stage kb % S once the consumers are done with load kb - S;
    // rows past M or N and columns past K arrive as zeros
    if (lane == 0) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % S;
        if (kb >= S) mbar_wait_bounded(empty + 8 * s, ((kb / S) - 1) & 1);
        const uint32_t dst = base + s * T::kStageBytes, bar = full + 8 * s;
        mbar_expect(bar, T::kStageBytes);
        tma_2d(dst, &amap, bar, kb * kDepth, m0);
        tma_2d(dst + kABytes, &bmap, bar, kb * kDepth, n0);
      }
    }
    return;
  }
  if (warp > kConsumerWarps) return;

  const int w = warp >> 2, wp = warp & 3, g = lane >> 2, t = lane & 3;
  float acc[BN / 2];   // the first step overwrites it (no register write while products run)
  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % S;
    mbar_wait_bounded(full + 8 * s, (kb / S) & 1);
    const uint32_t a_t = base + s * T::kStageBytes + w * (kABytes / 2);
    const uint32_t b_t = base + s * T::kStageBytes + kABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDepth / 16; ++kk)
      wgmma_ss(acc, sw128_desc(a_t + 32 * kk), sw128_desc(b_t + 32 * kk), (kb | kk) != 0);
    wgmma_commit();
    wgmma_wait_n<1>();   // the previous stage's products are done: release it
    if (kb > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * ((kb - 1) % S));
    }
  }
  wgmma_wait_n<0>();
  keep_n(acc);

  // epilogue: thread 32 wp + 4 g + t holds rows 16 wp + g (+ 8) of the
  // warpgroup's 64, columns 8 j + 2 t and + 1. The bf16 tile goes to the ring's
  // memory (once both warpgroups are done with it) as BN / 64 swizzled boxes of
  // 64 x 64, then out by TMA: whole lines, rows past M and columns past N
  // clipped by the tensor map.
  asm volatile("bar.sync 1, 256;" ::: "memory");
  const uint32_t o_t = base + w * (64 * BN * 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * t, n = n0 + c;
    const bool live_n = n < N;                         // N is a multiple of 8
    const __nv_bfloat162 b2 =
        live_n ? *reinterpret_cast<const __nv_bfloat162*>(bias + n) : __float2bfloat162_rn(0.f);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = 16 * wp + g + 8 * hr, m = m0 + 64 * w + r;
      __nv_bfloat162 v = epilogue_pair<kEpi>(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1], b2);
      if (kEpi == kBiasResidual && live_n && m < M)
        v = __hadd2(v, *reinterpret_cast<const __nv_bfloat162*>(res + (size_t)m * N + n));
      st_shared_u32(o_t + (c >> 6) * 8192 + sw128_offset(r, c & 63),
                    *reinterpret_cast<const uint32_t*>(&v));
    }
  }
  fence_proxy_async();   // the tile is read by TMA
  asm volatile("bar.sync %0, 128;" ::"r"(2 + w) : "memory");
  if ((tid & 127) == 0) {
    for (int bx = 0; bx < BN / 64 && n0 + 64 * bx < N; ++bx)
      tma_store_2d(&omap, o_t + bx * 8192, n0 + 64 * bx, m0 + 64 * w);
    asm volatile("cp.async.bulk.commit_group;\ncp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

template <int BN, int kEpi>
int launch_gemm(const void* a, const void* w, const void* bias, const void* res, void* out, int M,
                int N, int K, cudaStream_t stream) {
  using namespace gemm;
  CUtensorMap am, bm, om;
  int err;
  if ((err = map_2d(&am, a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, K, M, 2LL * K, kDepth, kRows,
                    CU_TENSOR_MAP_SWIZZLE_128B)) != 0 ||
      (err = map_2d(&bm, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, K, N, 2LL * K, kDepth, BN,
                    CU_TENSOR_MAP_SWIZZLE_128B)) != 0 ||
      (err = map_2d(&om, out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, N, M, 2LL * N, 64, 64,
                    CU_TENSOR_MAP_SWIZZLE_128B)) != 0)
    return err;
  auto kernel = block_gemm_kernel<BN, kEpi>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BN>::kSmem);
  const long long blocks = (long long)((M + kRows - 1) / kRows) * ((N + BN - 1) / BN);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, Tile<BN>::kSmem, stream>>>(
      am, bm, om, (const bf16*)bias, (const bf16*)res, M, N, K);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_gemm_epi(const void* a, const void* w, const void* bias, const void* res, void* out,
                    int M, int N, int K, int epilogue, cudaStream_t stream) {
  switch (epilogue) {
    case gemm::kBias: return launch_gemm<BN, gemm::kBias>(a, w, bias, res, out, M, N, K, stream);
    case gemm::kBiasGelu:
      return launch_gemm<BN, gemm::kBiasGelu>(a, w, bias, res, out, M, N, K, stream);
    case gemm::kBiasResidual:
      return launch_gemm<BN, gemm::kBiasResidual>(a, w, bias, res, out, M, N, K, stream);
  }
  return (int)cudaErrorInvalidValue;
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

// K5 / K6 step 1: y (M, D) = LN(x), D % 8 == 0 and D <= 1024 (the wrapper checks)
int ln_rows_bf16(const void* x, const void* lnw, const void* lnb, void* y, int M, int D,
                 float eps, void* stream) {
  if (M < 1 || D < 8 || D % 8 || D > kMaxRow) return (int)cudaErrorInvalidValue;
  const int blocks = (M + kLnRowsPerBlock - 1) / kLnRowsPerBlock;
  ln_rows_kernel<<<blocks, kLnRowsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)lnw, (const float*)lnb, (bf16*)y, M, D, eps);
  return (int)cudaGetLastError();
}

// K5 / K6 products: out (M, N) = epilogue(a (M, K) . w (N, K)^T); bias (N,);
// res (M, N) for the residual epilogue (0: + bias, 1: + bias then QuickGELU,
// 2: + bias then + res). bn: the block tile's columns (128, 192 or 256, from
// ops/block_kernels.gemm_tile). N and K multiples of 8, every pointer 16-byte
// aligned, rows contiguous.
int block_gemm_bf16(const void* a, const void* w, const void* bias, const void* res, void* out,
                    int M, int N, int K, int bn, int epilogue, void* stream) {
  if (M < 1 || N < 8 || N % 8 || K < 8 || K % 8) return (int)cudaErrorInvalidValue;
  if (epilogue == gemm::kBiasResidual && res == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bn) {
    case 128: return launch_gemm_epi<128>(a, w, bias, res, out, M, N, K, epilogue, s);
    case 192: return launch_gemm_epi<192>(a, w, bias, res, out, M, N, K, epilogue, s);
    case 256: return launch_gemm_epi<256>(a, w, bias, res, out, M, N, K, epilogue, s);
  }
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
