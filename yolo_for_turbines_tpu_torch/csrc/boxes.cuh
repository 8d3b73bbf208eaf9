// Box arithmetic shared by the greedy NMS kernel (nms.cu) and the pairwise
// IoU kernel (iou.cu): the conversion of an input box, NaN-propagating
// min / max, and the IoU formula
//
//     inter / (area_i + area_j - inter + 1e-6)
//
// in the operation order of the Pallas kernels (_nms_kernel, _iou_tile_kernel)
// and of the plain torch versions. Both CUDA kernels must equal their plain
// version bit for bit, so every sum, difference and product is an _rn
// intrinsic (the compiler never contracts those into FMAs) and the divisions
// are IEEE. What depends on one box only (x2, y2, area) is computed once per
// box: the same operations on the same inputs as computing it per pair.
// Halving by __fmul_rn(w, 0.5f) is the plain version's w / 2 for every float.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace boxes {

// torch.maximum / torch.minimum: a NaN operand gives NaN (fmaxf drops it)
__device__ __forceinline__ float max_nan(float a, float b) {
    return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float min_nan(float a, float b) {
    return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}

struct Box {
    float x1, y1, x2, y2, area;
};

// (a, b, w, h) is (cx, cy, w, h) when `center`, else top-left (x1, y1, w, h).
// The centre conversion is the plain version's `xy - wh / 2`.
__device__ __forceinline__ Box make_box(float a, float b, float w, float h, bool center) {
    Box r;
    r.x1 = center ? __fsub_rn(a, __fmul_rn(w, 0.5f)) : a;
    r.y1 = center ? __fsub_rn(b, __fmul_rn(h, 0.5f)) : b;
    r.x2 = __fadd_rn(r.x1, w);
    r.y2 = __fadd_rn(r.y1, h);
    r.area = __fmul_rn(w, h);
    return r;
}

// Whether the four corners are finite. Between two such boxes no min / max
// of the formula sees a NaN (a difference of finite values is finite or
// infinite), so fmaxf / fminf give what torch.maximum / torch.minimum give.
__device__ __forceinline__ bool corners_finite(const Box& r) {
    return isfinite(r.x1) && isfinite(r.y1) && isfinite(r.x2) && isfinite(r.y2);
}

// IoU of row box i and column box j. kFinite: both boxes passed
// corners_finite, so the single-instruction min / max are exact.
template <bool kFinite>
__device__ __forceinline__ float iou(const Box& i, const Box& j) {
    const float xa = kFinite ? fmaxf(i.x1, j.x1) : max_nan(i.x1, j.x1);
    const float ya = kFinite ? fmaxf(i.y1, j.y1) : max_nan(i.y1, j.y1);
    const float xb = kFinite ? fminf(i.x2, j.x2) : min_nan(i.x2, j.x2);
    const float yb = kFinite ? fminf(i.y2, j.y2) : min_nan(i.y2, j.y2);
    const float dx = __fsub_rn(xb, xa), dy = __fsub_rn(yb, ya);
    const float inter = __fmul_rn(kFinite ? fmaxf(dx, 0.f) : max_nan(dx, 0.f),
                                  kFinite ? fmaxf(dy, 0.f) : max_nan(dy, 0.f));
    const float uni = __fsub_rn(__fadd_rn(i.area, j.area), inter);
    const float d = __fadd_rn(uni, 1e-6f);
    // Most pairs do not overlap, and the compiler's IEEE division sends a
    // zero numerator down its slow path (measured: twice the kernel's time).
    // So a zero numerator divides 1 instead and multiplies the quotient by
    // the zero: 0 * (1 / d) is 0 / d for every d that can occur (NaN for
    // d = 0 or NaN, else a zero of the quotient's sign; 1 / d would overflow
    // only for a denormal d, and x + 1e-6f is never a nonzero denormal).
    const bool zero = inter == 0.f;
    const float q = __fdiv_rn(zero ? 1.f : inter, d);
    return zero ? __fmul_rn(inter, q) : q;
}

}  // namespace boxes
