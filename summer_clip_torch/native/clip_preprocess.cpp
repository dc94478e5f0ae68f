// Native host preprocessing for the feature-extraction pipeline.
//
// The card's host feeds save_features thousands of images a second; PIL's
// per-image resize cannot keep up. This library implements the CLIP eval
// transform's arithmetic in C++ (reference semantics: torchvision
// Resize(bicubic, shorter->S) + CenterCrop(S) + Normalize):
//
//   decoded RGB --bicubic shorter-side resize--> (>=S x >=S)
//               --center crop S--> normalize (CLIP mean/std) --> float32 HWC
//
// The caller decodes each JPEG with Pillow's libjpeg at the DCT scale this
// library picks (clip_preprocess_denom), passes the RGB bytes in
// (clip_preprocess_rgb) and runs the batch in a thread pool: both calls
// release the GIL, and each writes straight into its row of the caller's
// float32 batch. Exposed via a C ABI for ctypes (no pybind11 dependency).

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

constexpr float kMean[3] = {0.48145466f, 0.4578275f, 0.40821073f};
constexpr float kStd[3] = {0.26862954f, 0.26130258f, 0.27577711f};

// pick the smallest DCT scale that keeps the short side >= 2x the target
// (headroom so the bicubic pass controls final quality). fast mode only
// requires >= 1x: e.g. 480x640 -> 224 decodes at 1/2 resolution (4x fewer
// pixels through the IDCT; libjpeg's scaled IDCT is itself a low-pass, so
// quality loss vs the full decode is small: a mean |d| under 0.05).
int DctDenom(int width, int height, int target_short, int fast) {
  int short_side = std::min<int>(width, height);
  const int margin = fast ? 1 : 2;
  int denom = 1;
  while (denom < 8 && target_short > 0 &&
         short_side / (denom * 2) >= margin * target_short) {
    denom *= 2;
  }
  return denom;
}

inline float CubicKernel(float x) {
  // Catmull-Rom style cubic with a = -0.5 (PIL's bicubic kernel)
  constexpr float a = -0.5f;
  x = std::fabs(x);
  if (x < 1.0f) return ((a + 2.0f) * x - (a + 3.0f)) * x * x + 1.0f;
  if (x < 2.0f) return (((x - 5.0f) * x + 8.0f) * x - 4.0f) * a;
  return 0.0f;
}

// Precompute antialiased convolution taps for one axis (PIL-style: the
// kernel support scales with the downscale factor so frequencies above the
// target Nyquist are filtered, not aliased).
void BuildTaps(int in_size, int out_size, std::vector<int>* starts,
               std::vector<float>* weights, int* ntaps) {
  const double scale = static_cast<double>(in_size) / out_size;
  const double filter_scale = std::max(scale, 1.0);
  const double support = 2.0 * filter_scale;  // bicubic support = 2
  *ntaps = static_cast<int>(std::ceil(support)) * 2 + 1;
  starts->assign(out_size, 0);
  weights->assign(static_cast<size_t>(out_size) * (*ntaps), 0.0f);
  for (int x = 0; x < out_size; ++x) {
    const double center = (x + 0.5) * scale - 0.5;
    int start = static_cast<int>(std::floor(center - support)) + 1;
    start = std::clamp(start, 0, std::max(in_size - *ntaps, 0));
    (*starts)[x] = start;
    double wsum = 0.0;
    float* w = weights->data() + static_cast<size_t>(x) * (*ntaps);
    for (int k = 0; k < *ntaps; ++k) {
      int xx = start + k;
      if (xx >= in_size) break;
      double wgt = CubicKernel(static_cast<float>((center - xx) / filter_scale));
      w[k] = static_cast<float>(wgt);
      wsum += wgt;
    }
    if (wsum != 0.0) {
      for (int k = 0; k < *ntaps; ++k) w[k] = static_cast<float>(w[k] / wsum);
    }
  }
}

// Separable antialiased bicubic resize of an RGB byte image.
void ResizeBicubic(const uint8_t* src, int sw, int sh, float* dst, int dw, int dh) {
  std::vector<int> xs, ys;
  std::vector<float> xw, yw;
  int xt = 0, yt = 0;
  BuildTaps(sw, dw, &xs, &xw, &xt);
  BuildTaps(sh, dh, &ys, &yw, &yt);

  // horizontal pass into a temp (sh x dw x 3) buffer
  std::vector<float> tmp(static_cast<size_t>(sh) * dw * 3);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* srow = src + static_cast<size_t>(y) * sw * 3;
    float* trow = tmp.data() + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const float* w = xw.data() + static_cast<size_t>(x) * xt;
      const int start = xs[x];
      float acc[3] = {0, 0, 0};
      const int kmax = std::min(xt, sw - start);
      for (int k = 0; k < kmax; ++k) {
        const uint8_t* px = srow + (start + k) * 3;
        acc[0] += w[k] * px[0];
        acc[1] += w[k] * px[1];
        acc[2] += w[k] * px[2];
      }
      trow[x * 3 + 0] = acc[0];
      trow[x * 3 + 1] = acc[1];
      trow[x * 3 + 2] = acc[2];
    }
  }
  // vertical pass
  for (int y = 0; y < dh; ++y) {
    const float* w = yw.data() + static_cast<size_t>(y) * yt;
    const int start = ys[y];
    const int kmax = std::min(yt, sh - start);
    float* drow = dst + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      for (int c = 0; c < 3; ++c) {
        float acc = 0.0f;
        for (int k = 0; k < kmax; ++k) {
          acc += w[k] * tmp[(static_cast<size_t>(start + k) * dw + x) * 3 + c];
        }
        drow[x * 3 + c] = acc;
      }
    }
  }
}

// Eval transform of one decoded RGB image -> normalized float32 (S, S, 3).
void TransformRgb(const uint8_t* rgb, int w, int h, int out_size, float* out) {
  // shorter-side resize
  int rw, rh;
  if (w <= h) {
    rw = out_size;
    rh = std::max(1, static_cast<int>(std::lround(
        static_cast<double>(h) * out_size / w)));
  } else {
    rh = out_size;
    rw = std::max(1, static_cast<int>(std::lround(
        static_cast<double>(w) * out_size / h)));
  }
  std::vector<float> resized(static_cast<size_t>(rw) * rh * 3);
  ResizeBicubic(rgb, w, h, resized.data(), rw, rh);

  // center crop + normalize
  const int left = (rw - out_size) / 2;
  const int top = (rh - out_size) / 2;
  for (int y = 0; y < out_size; ++y) {
    const float* srow = resized.data() + (static_cast<size_t>(y + top) * rw + left) * 3;
    float* drow = out + static_cast<size_t>(y) * out_size * 3;
    for (int x = 0; x < out_size; ++x) {
      for (int c = 0; c < 3; ++c) {
        float v = std::clamp(srow[x * 3 + c], 0.0f, 255.0f) / 255.0f;
        drow[x * 3 + c] = (v - kMean[c]) / kStd[c];
      }
    }
  }
}

}  // namespace

extern "C" {

// The DCT scale denominator (1, 2, 4 or 8) the decode of a width x height
// JPEG takes for an out_size target (see DctDenom).
int clip_preprocess_denom(int width, int height, int out_size, int fast) {
  return DctDenom(width, height, out_size, fast);
}

// Resize, crop and normalize one decoded image: rgb is (h, w, 3) uint8,
// out (out_size, out_size, 3) float32. Returns 1.
int clip_preprocess_rgb(const uint8_t* rgb, int w, int h, int out_size, float* out) {
  TransformRgb(rgb, w, h, out_size, out);
  return 1;
}

}  // extern "C"
