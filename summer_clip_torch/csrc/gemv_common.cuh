// Device functions shared by the decode kernels (gemv_kernels.cu: K7, K10;
// decode_kernels.cu: K8): bf16 rounding, 16 bytes of a stored weight row widened
// to floats, tanh-GELU.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 16 bytes of row-major weights as floats: 16 int8, 8 bf16 or 4 f32.
template <typename W> struct Vec;
template <> struct Vec<int8_t> {
  static constexpr int n = 16;
  static __device__ __forceinline__ void unpack(const uint4& raw, float (&f)[16]) {
    // Exact, and without the integer-to-float converter: s + 128 (the byte
    // with its sign bit flipped) placed in the low mantissa byte of 2^23 is
    // the float 2^23 + 128 + s.
    const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u, raw.z ^ 0x80808080u,
                           raw.w ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[4 * i] = __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7650)) - 8388736.f;
      f[4 * i + 1] = __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7651)) - 8388736.f;
      f[4 * i + 2] = __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7652)) - 8388736.f;
      f[4 * i + 3] = __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7653)) - 8388736.f;
    }
  }
};
template <> struct Vec<bf16> {
  static constexpr int n = 8;
  static __device__ __forceinline__ void unpack(const uint4& raw, float (&f)[8]) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);            // low half: the even column
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <> struct Vec<float> {
  static constexpr int n = 4;
  // a weight stored in f32 is rounded to bf16 like x (the TPU kernel's cast)
  static __device__ __forceinline__ void unpack(const uint4& raw, float (&f)[4]) {
    f[0] = round_bf16(__uint_as_float(raw.x));
    f[1] = round_bf16(__uint_as_float(raw.y));
    f[2] = round_bf16(__uint_as_float(raw.z));
    f[3] = round_bf16(__uint_as_float(raw.w));
  }
};

__device__ __forceinline__ float gelu_tanh(float v) {
  const float c = 0.7978845608028654f;   // sqrt(2 / pi)
  return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
}

}  // namespace
