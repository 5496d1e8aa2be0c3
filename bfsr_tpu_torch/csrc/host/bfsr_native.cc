// bfsr_native: the port's host-side resampling for the data wrappers.
//
// Three C entries on float32 (H, W, C) row-major arrays, each parallel over
// its output with OpenMP.  bfsr_tpu_torch/native.py builds this file with
// g++ at first use and calls it through ctypes, which releases the GIL for
// the call, so the data loader's threads run it at once:
//
//   bilinear_resize_f32    F.interpolate(mode='bilinear') semantics, with
//                          and without align_corners
//   updownup_residual_f32  the wrappers' lr_up and its up-down-up residual,
//                          lr_up - up(down(lr_up)), in one call
//   bicubic_resize_f32     MATLAB imresize: antialiased bicubic, symmetric
//                          boundary, the smaller-scale axis first

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// one output index of a bilinear axis: its two source indices and the
// weight of the second
struct AxisTap {
  int i0, i1;
  float w1;
};

// align_corners=false: src = (i + 0.5) * in / out - 0.5, clamped to the
// input; align_corners=true: src = i * (in - 1) / (out - 1)
std::vector<AxisTap> axis_taps(int in_size, int out_size, bool align_corners) {
  std::vector<AxisTap> taps(out_size);
  for (int i = 0; i < out_size; ++i) {
    double src;
    if (align_corners && out_size > 1) {
      src = static_cast<double>(i) * (in_size - 1) / (out_size - 1);
    } else {
      src = (i + 0.5) * (static_cast<double>(in_size) / out_size) - 0.5;
    }
    src = std::min(std::max(src, 0.0), static_cast<double>(in_size - 1));
    const int i0 = static_cast<int>(std::floor(src));
    taps[i] = {i0, std::min(i0 + 1, in_size - 1),
               static_cast<float>(src - i0)};
  }
  return taps;
}

// dst = bilinear(src), or, with ``minuend``, dst = minuend - bilinear(src);
// x is interpolated first, then y
void bilinear(const float* src, int H, int W, int C, float* dst, int OH,
              int OW, bool align_corners, const float* minuend) {
  const std::vector<AxisTap> ty = axis_taps(H, OH, align_corners);
  const std::vector<AxisTap> tx = axis_taps(W, OW, align_corners);
#pragma omp parallel for schedule(static)
  for (int oy = 0; oy < OH; ++oy) {
    const AxisTap& ay = ty[oy];
    const float* row0 = src + static_cast<int64_t>(ay.i0) * W * C;
    const float* row1 = src + static_cast<int64_t>(ay.i1) * W * C;
    const int64_t base = static_cast<int64_t>(oy) * OW * C;
    for (int ox = 0; ox < OW; ++ox) {
      const AxisTap& ax = tx[ox];
      const float wy = ay.w1, wx = ax.w1;
      const float* p00 = row0 + ax.i0 * C;
      const float* p01 = row0 + ax.i1 * C;
      const float* p10 = row1 + ax.i0 * C;
      const float* p11 = row1 + ax.i1 * C;
      for (int c = 0; c < C; ++c) {
        const float top = p00[c] + (p01[c] - p00[c]) * wx;
        const float bot = p10[c] + (p11[c] - p10[c]) * wx;
        const float v = top + (bot - top) * wy;
        const int64_t o = base + ox * C + c;
        dst[o] = minuend ? minuend[o] - v : v;
      }
    }
  }
}

double cubic(double x) {
  const double ax = std::fabs(x);
  if (ax <= 1.0) return 1.5 * ax * ax * ax - 2.5 * ax * ax + 1.0;
  if (ax <= 2.0) return -0.5 * ax * ax * ax + 2.5 * ax * ax - 4.0 * ax + 2.0;
  return 0.0;
}

// MATLAB's contributions of an axis: ``taps`` source indices and
// normalised weights per output index
struct MatlabTaps {
  int taps;
  std::vector<int> idx;     // (out, taps)
  std::vector<double> wts;  // (out, taps)
};

// u = o / scale + 0.5 (1 - 1 / scale) for 1-based o; the kernel widened by
// 1 / scale when shrinking; symmetric (mirror-without-repeat) borders
MatlabTaps matlab_taps(int in_len, int out_len, double scale) {
  const double kw = scale < 1.0 ? 4.0 / scale : 4.0;
  MatlabTaps t;
  t.taps = static_cast<int>(std::ceil(kw)) + 2;
  const int P = t.taps;
  t.idx.resize(static_cast<size_t>(out_len) * P);
  t.wts.resize(static_cast<size_t>(out_len) * P);
  const int period = 2 * in_len;
  for (int o = 0; o < out_len; ++o) {
    const double u = (o + 1) / scale + 0.5 * (1.0 - 1.0 / scale);
    const int left = static_cast<int>(std::floor(u - kw / 2.0));
    double sum = 0.0;
    for (int p = 0; p < P; ++p) {
      const int ind = left + p - 1;
      const double x = u - ind - 1;
      const double w = scale < 1.0 ? scale * cubic(scale * x) : cubic(x);
      t.wts[o * P + p] = w;
      sum += w;
      int m = ((ind % period) + period) % period;
      if (m >= in_len) m = period - 1 - m;
      t.idx[o * P + p] = m;
    }
    for (int p = 0; p < P; ++p) t.wts[o * P + p] /= sum;
  }
  return t;
}

// one axis of the MATLAB resize: (rows, in, inner) -> (rows, out, inner)
// along the middle axis, accumulated in double, parallel over (rows, out)
void resize_axis(const float* src, int rows, int in, int inner,
                 const MatlabTaps& t, int out, float* dst) {
#pragma omp parallel for collapse(2) schedule(static)
  for (int r = 0; r < rows; ++r) {
    for (int o = 0; o < out; ++o) {
      const float* s = src + static_cast<int64_t>(r) * in * inner;
      float* d = dst + static_cast<int64_t>(r) * out * inner;
      const int* idx = &t.idx[static_cast<size_t>(o) * t.taps];
      const double* wts = &t.wts[static_cast<size_t>(o) * t.taps];
      for (int k = 0; k < inner; ++k) {
        double acc = 0.0;
        for (int p = 0; p < t.taps; ++p) {
          acc += wts[p] * s[static_cast<int64_t>(idx[p]) * inner + k];
        }
        d[static_cast<int64_t>(o) * inner + k] = static_cast<float>(acc);
      }
    }
  }
}

}  // namespace

extern "C" {

// src (H, W, C) -> dst (OH, OW, C)
void bilinear_resize_f32(const float* src, int H, int W, int C, float* dst,
                         int OH, int OW, int align_corners) {
  bilinear(src, H, W, C, dst, OH, OW, align_corners != 0, nullptr);
}

// the normalised LR (h, w, C) -> lr_up (H, W, C), its bilinear upsample,
// and residual = lr_up - up(down(lr_up)) (H, W, C)
void updownup_residual_f32(const float* lr, int h, int w, int C, int H, int W,
                           float* lr_up, float* residual) {
  bilinear(lr, h, w, C, lr_up, H, W, false, nullptr);
  std::vector<float> down(static_cast<size_t>(h) * w * C);
  bilinear(lr_up, H, W, C, down.data(), h, w, false, nullptr);
  bilinear(down.data(), h, w, C, residual, H, W, false, lr_up);
}

// MATLAB-imresize bicubic, src (H, W, C) -> dst (OH, OW, C): the axis of the
// smaller scale first (rows on a tie)
void bicubic_resize_f32(const float* src, int H, int W, int C, float* dst,
                        int OH, int OW) {
  const double sy = static_cast<double>(OH) / H;
  const double sx = static_cast<double>(OW) / W;
  const MatlabTaps ty = matlab_taps(H, OH, sy), tx = matlab_taps(W, OW, sx);
  if (sy <= sx) {
    std::vector<float> tmp(static_cast<size_t>(OH) * W * C);
    resize_axis(src, 1, H, W * C, ty, OH, tmp.data());
    resize_axis(tmp.data(), OH, W, C, tx, OW, dst);
  } else {
    std::vector<float> tmp(static_cast<size_t>(H) * OW * C);
    resize_axis(src, H, W, C, tx, OW, tmp.data());
    resize_axis(tmp.data(), 1, H, OW * C, ty, OH, dst);
  }
}

}  // extern "C"
