// Host-side letterbox packer of the serving path: bilinear letterbox resize
// + center pad + /255 normalization + NHWC batch assembly in one C++ call,
// threaded across images with std::thread, writing straight into the
// float32 numpy buffer the predictor copies to the device.
//
// A copy of the serving part of yolo_for_turbines_tpu/native/packer.cpp
// (letterbox_one, batch_letterbox_normalize); tests/test_torch_config.py
// holds it to the original bit for bit.
//
// Geometry matches data/augment.py::letterbox: scale = size / max(h, w),
// rounded target dims, centered padding (top = (size - nh) / 2).
// Resampling is classic half-pixel-center bilinear; PIL's downscale filter
// adds antialiasing, so pixels differ slightly from the numpy + PIL path.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "bilinear.h"

namespace {

// Letterbox one HWC uint8 image into a float32 (size, size, 3) canvas.
// Separable two-pass resize: horizontal u8->f32 (work sh*nw), then vertical
// blend + /255 straight into the padded destination (work nh*nw). Sequential
// access, precomputed tables -- an order of magnitude over naive per-pixel
// sampling.
void letterbox_one(const uint8_t* src, int sh, int sw, float* dst, int size,
                   float pad_value) {
  // double + nearbyint (round-half-to-even) to match Python round() in
  // data/augment.py::letterbox_box_geometry -- lround would round half away
  // from zero and misalign image vs box geometry by 1px at exact .5
  const double dscale = static_cast<double>(size) / std::max(sh, sw);
  const int nh = std::max(1, static_cast<int>(std::nearbyint(sh * dscale)));
  const int nw = std::max(1, static_cast<int>(std::nearbyint(sw * dscale)));
  const int top = (size - nh) / 2;
  const int left = (size - nw) / 2;
  const size_t plane = static_cast<size_t>(size) * size * 3;
  std::fill(dst, dst + plane, pad_value);
  constexpr float kInv255 = 1.0f / 255.0f;

  if (nh == sh && nw == sw) {
    for (int y = 0; y < nh; ++y) {
      const uint8_t* row = src + static_cast<size_t>(y) * sw * 3;
      float* out = dst + (static_cast<size_t>(top + y) * size + left) * 3;
      for (int i = 0; i < nw * 3; ++i) out[i] = row[i] * kInv255;
    }
    return;
  }

  const AxisTab tx = make_axis(sw, nw);
  const AxisTab ty = make_axis(sh, nh);

  // Pass 1: horizontal resample of every source row into f32 (sh, nw, 3).
  std::vector<float> tmp(static_cast<size_t>(sh) * nw * 3);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * sw * 3;
    float* out = tmp.data() + static_cast<size_t>(y) * nw * 3;
    for (int x = 0; x < nw; ++x) {
      const uint8_t* p0 = row + tx.i0[x] * 3;
      const uint8_t* p1 = row + tx.i1[x] * 3;
      const float w = tx.w[x];
      out[x * 3 + 0] = p0[0] + (p1[0] - p0[0]) * w;
      out[x * 3 + 1] = p0[1] + (p1[1] - p0[1]) * w;
      out[x * 3 + 2] = p0[2] + (p1[2] - p0[2]) * w;
    }
  }

  // Pass 2: vertical blend + normalize into the letterboxed window.
  for (int y = 0; y < nh; ++y) {
    const float* r0 = tmp.data() + static_cast<size_t>(ty.i0[y]) * nw * 3;
    const float* r1 = tmp.data() + static_cast<size_t>(ty.i1[y]) * nw * 3;
    const float w = ty.w[y];
    float* out = dst + (static_cast<size_t>(top + y) * size + left) * 3;
    for (int i = 0; i < nw * 3; ++i) {
      out[i] = (r0[i] + (r1[i] - r0[i]) * w) * kInv255;
    }
  }
}

}  // namespace

extern "C" {

// Batch letterbox+normalize: n images (pointer + dims arrays) into a
// preallocated float32 (n, size, size, 3) buffer. Threaded across images.
void batch_letterbox_normalize(const uint8_t** srcs, const int* shs,
                               const int* sws, int n, float* dst, int size,
                               float pad_value, int num_threads) {
  const size_t plane = static_cast<size_t>(size) * size * 3;
  num_threads = std::max(1, std::min(num_threads, n));
  std::vector<std::thread> workers;
  workers.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) {
    workers.emplace_back([=]() {
      for (int i = t; i < n; i += num_threads) {
        letterbox_one(srcs[i], shs[i], sws[i], dst + i * plane, size,
                      pad_value);
      }
    });
  }
  for (auto& w : workers) w.join();
}

}  // extern "C"
