// mgdata — native host-side image ops for the mgtpu data plane.
//
// The reference delegated its data-path compute to native Torch
// packages: `image` (C resize/warp, SURVEY §2.9) and `threads` (C
// donkey pool, `data.lua:15-38`). This library is the rebuild's native
// data plane: PIL-compatible separable resampling, affine warps, and a
// fused crop+flip+normalize batch assembler, exposed through a plain C
// ABI consumed via ctypes (mgtpu/native/__init__.py). Python/PIL
// remains the behavioural fallback; tests pin the two paths together.
//
// All images are HWC float32, C-contiguous (the NHWC layout the
// rest of mgtpu uses). Every function is thread-safe and touches only
// locals / its own heap scratch (mg_resize allocates axis-weight
// tables and a tmp plane per call), so donkey workers can call in
// parallel without the GIL.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Separable resampling, PIL-compatible.
//
// PIL's resize (Resample.c) computes, per output index i on an axis of
// input length `in` and output length `out`:
//   scale   = in / out
//   fscale  = max(scale, 1)
//   center  = (i + 0.5) * scale
//   support = filter_support * fscale
//   weights w_k = filter((k + 0.5 - center) / fscale)  for k in
//                 [floor(center - support), ceil(center + support))
// normalized to sum 1. Bilinear = triangle (support 1); bicubic =
// Keys cubic with a = -0.5 (support 2).
// ---------------------------------------------------------------------------

static inline float filter_triangle(float x) {
  x = std::fabs(x);
  return x < 1.0f ? 1.0f - x : 0.0f;
}

static inline float filter_cubic(float x) {
  // Keys cubic, a = -0.5 (PIL's bicubic)
  x = std::fabs(x);
  if (x < 1.0f) return ((1.5f * x - 2.5f) * x) * x + 1.0f;
  if (x < 2.0f) return (((-0.5f * x) + 2.5f) * x - 4.0f) * x + 2.0f;
  return 0.0f;
}

struct AxisWeights {
  std::vector<int> first;     // first input index per output index
  std::vector<int> count;     // number of taps per output index
  std::vector<float> weights; // taps, max_count-strided rows
  int stride;
};

static void build_weights(int in, int out, int filter, AxisWeights* aw) {
  const double scale = (double)in / out;
  const double fscale = scale < 1.0 ? 1.0 : scale;
  const double fsupport = filter == 2 ? 2.0 : 1.0;
  const double support = fsupport * fscale;
  const int max_taps = (int)std::ceil(support) * 2 + 1;
  aw->first.resize(out);
  aw->count.resize(out);
  aw->weights.assign((size_t)out * max_taps, 0.0f);
  aw->stride = max_taps;
  for (int i = 0; i < out; i++) {
    const double center = (i + 0.5) * scale;
    int lo = (int)(center - support + 0.5);
    int hi = (int)(center + support + 0.5);
    lo = std::max(lo, 0);
    hi = std::min(hi, in);
    float* w = &aw->weights[(size_t)i * max_taps];
    double sum = 0.0;
    for (int k = lo; k < hi; k++) {
      const double x = (k + 0.5 - center) / fscale;
      const double v = filter == 2 ? filter_cubic((float)x) : filter_triangle((float)x);
      w[k - lo] = (float)v;
      sum += v;
    }
    if (sum != 0.0) {
      for (int k = 0; k < hi - lo; k++) w[k] = (float)(w[k] / sum);
    }
    aw->first[i] = lo;
    aw->count[i] = hi - lo;
  }
}

// filter: 0 = nearest, 1 = bilinear (triangle), 2 = bicubic (Keys a=-.5)
void mg_resize(const float* src, int h, int w, int c, float* dst, int oh,
               int ow, int filter) {
  if (oh == h && ow == w) {
    std::memcpy(dst, src, sizeof(float) * (size_t)h * w * c);
    return;
  }
  if (filter == 0) {
    // nearest, PIL parity: PIL walks xin from scale/2 ADDING scale per
    // pixel (double accumulation) then truncates — replicating the
    // accumulation, not the closed form, is what matches at exact
    // pixel-boundary centers (verified against PIL 12 in tests)
    const double sy = (double)h / oh, sx = (double)w / ow;
    std::vector<int> xmap(ow);
    double xin = sx * 0.5;
    for (int x = 0; x < ow; x++, xin += sx)
      xmap[x] = std::min(std::max((int)xin, 0), w - 1);
    double yin = sy * 0.5;
    for (int y = 0; y < oh; y++, yin += sy) {
      const int iy = std::min(std::max((int)yin, 0), h - 1);
      for (int x = 0; x < ow; x++) {
        std::memcpy(dst + ((size_t)y * ow + x) * c,
                    src + ((size_t)iy * w + xmap[x]) * c, sizeof(float) * c);
      }
    }
    return;
  }
  AxisWeights wy, wx;
  build_weights(h, oh, filter, &wy);
  build_weights(w, ow, filter, &wx);
  // horizontal pass into tmp (h, ow, c), then vertical into dst
  std::vector<float> tmp((size_t)h * ow * c, 0.0f);
  for (int y = 0; y < h; y++) {
    const float* row = src + (size_t)y * w * c;
    float* trow = tmp.data() + (size_t)y * ow * c;
    for (int x = 0; x < ow; x++) {
      const float* wgt = &wx.weights[(size_t)x * wx.stride];
      const int lo = wx.first[x], n = wx.count[x];
      float* out = trow + (size_t)x * c;
      for (int ch = 0; ch < c; ch++) out[ch] = 0.0f;
      for (int k = 0; k < n; k++) {
        const float wk = wgt[k];
        const float* px = row + (size_t)(lo + k) * c;
        for (int ch = 0; ch < c; ch++) out[ch] += wk * px[ch];
      }
    }
  }
  for (int y = 0; y < oh; y++) {
    const float* wgt = &wy.weights[(size_t)y * wy.stride];
    const int lo = wy.first[y], n = wy.count[y];
    float* orow = dst + (size_t)y * ow * c;
    std::memset(orow, 0, sizeof(float) * (size_t)ow * c);
    for (int k = 0; k < n; k++) {
      const float wk = wgt[k];
      const float* trow = tmp.data() + (size_t)(lo + k) * ow * c;
      for (int i = 0; i < ow * c; i++) orow[i] += wk * trow[i];
    }
  }
}

// ---------------------------------------------------------------------------
// Affine warp, PIL Image.transform(AFFINE, bilinear) parity:
//   (xr, yr) = (a*(x+0.5) + b*(y+0.5) + tx, d*(x+0.5) + e*(y+0.5) + ty)
//   fill 0 when (xr, yr) leaves [0, w) x [0, h);
//   else bilinear at (xr-0.5, yr-0.5) with border-replicate taps.
// (Convention established empirically against PIL 12; see
// tests/test_native.py.)
// ---------------------------------------------------------------------------
void mg_warp_affine(const float* src, int h, int w, int c, float* dst,
                    double a, double b, double tx, double d, double e,
                    double ty) {
  for (int y = 0; y < h; y++) {
    float* orow = dst + (size_t)y * w * c;
    const double yc = y + 0.5;
    for (int x = 0; x < w; x++) {
      const double xc = x + 0.5;
      const double xr = a * xc + b * yc + tx;
      const double yr = d * xc + e * yc + ty;
      float* out = orow + (size_t)x * c;
      if (xr < 0.0 || xr >= w || yr < 0.0 || yr >= h) {
        for (int ch = 0; ch < c; ch++) out[ch] = 0.0f;
        continue;
      }
      const double xin = xr - 0.5, yin = yr - 0.5;
      const int x0 = (int)std::floor(xin), y0 = (int)std::floor(yin);
      const float fx = (float)(xin - x0), fy = (float)(yin - y0);
      const float w00 = (1 - fx) * (1 - fy), w01 = fx * (1 - fy);
      const float w10 = (1 - fx) * fy, w11 = fx * fy;
      const int xa = std::max(x0, 0), xb = std::min(x0 + 1, w - 1);
      const int ya = std::max(y0, 0), yb = std::min(y0 + 1, h - 1);
      const float* r0 = src + (size_t)ya * w * c;
      const float* r1 = src + (size_t)yb * w * c;
      for (int ch = 0; ch < c; ch++) {
        out[ch] = w00 * r0[(size_t)xa * c + ch] +
                  w01 * r0[(size_t)xb * c + ch] +
                  w10 * r1[(size_t)xa * c + ch] +
                  w11 * r1[(size_t)xb * c + ch];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Fused crop + horizontal-flip + per-channel normalize, writing straight
// into a batch slot — the trainBatch assembly the reference did as
// separate transform passes + put2GPU staging (`train.lua:132-145`).
// src (h, w, c) -> dst (size, size, c); crop origin (y1, x1); flip
// mirrors x; out = (in - mean[c]) / std[c].
// ---------------------------------------------------------------------------
void mg_crop_flip_normalize(const float* src, int h, int w, int c, float* dst,
                            int y1, int x1, int size, int flip,
                            const float* mean, const float* std_) {
  (void)h;
  for (int y = 0; y < size; y++) {
    const float* row = src + ((size_t)(y1 + y) * w + x1) * c;
    float* orow = dst + (size_t)y * size * c;
    for (int x = 0; x < size; x++) {
      const float* px = row + (size_t)(flip ? (size - 1 - x) : x) * c;
      float* out = orow + (size_t)x * c;
      for (int ch = 0; ch < c; ch++)
        out[ch] = (px[ch] - mean[ch]) / std_[ch];
    }
  }
}

// Batch ZCA-style dense whitening: out = (in - mean) @ P, in/out
// (n, d), P (d, d) column-major-agnostic (row-major here). Used by the
// cifar ingest tool; simple blocked matmul, good enough for one-shot
// offline work but ~10x numpy-free Python.
void mg_whiten(const float* in, const float* mean, const float* p, float* out,
               int n, int d) {
  const int B = 64;
  std::vector<float> centered((size_t)B * d);
  for (int i0 = 0; i0 < n; i0 += B) {
    const int nb = std::min(B, n - i0);
    for (int i = 0; i < nb; i++)
      for (int j = 0; j < d; j++)
        centered[(size_t)i * d + j] = in[(size_t)(i0 + i) * d + j] - mean[j];
    for (int i = 0; i < nb; i++) {
      float* orow = out + (size_t)(i0 + i) * d;
      std::memset(orow, 0, sizeof(float) * d);
      for (int k = 0; k < d; k++) {
        const float v = centered[(size_t)i * d + k];
        if (v == 0.0f) continue;
        const float* prow = p + (size_t)k * d;
        for (int j = 0; j < d; j++) orow[j] += v * prow[j];
      }
    }
  }
}

int mg_version() { return 1; }

}  // extern "C"
