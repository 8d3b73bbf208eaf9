// Half-pixel-center bilinear coefficient table of one axis, shared by the
// letterbox packer (letterbox.cpp) and the train augmenter (augment.cpp).

#pragma once

#include <algorithm>
#include <vector>

struct AxisTab {
  std::vector<int> i0, i1;
  std::vector<float> w;  // weight of i1; (1 - w) of i0
};

inline AxisTab make_axis(int src, int dst) {
  AxisTab t;
  t.i0.resize(dst);
  t.i1.resize(dst);
  t.w.resize(dst);
  const float s = static_cast<float>(src) / dst;
  for (int x = 0; x < dst; ++x) {
    float f = (x + 0.5f) * s - 0.5f;
    f = std::max(0.0f, std::min(f, static_cast<float>(src - 1)));
    t.i0[x] = static_cast<int>(f);
    t.i1[x] = std::min(t.i0[x] + 1, src - 1);
    t.w[x] = f - t.i0[x];
  }
  return t;
}
