// K9: the sampling core of multi-scale deformable attention (RT-DETR's
// decoder, models/rtdetr.py::MSDeformableAttention), in one pass:
//
//   out[b, q, h * D + c] = bf16( sum_{l, p} w[b, q, h, l, p]
//                                * bilinear(value_l[b, :, :, h * D + c], loc[b, q, h, l, p]) )
//
// value (B, N, heads * D) bf16, the levels' tokens one after another, each
// level row-major over its (H_l, W_l) plane; loc (B, Q, heads, L, P, 2) f32
// (x, y) in [0, 1]; w (B, Q, heads, L * P) f32 (already softmaxed). The
// bilinear sample is grid_sample's with align_corners=False and zero padding
// at the grid 2 loc - 1: the source pixel ((g + 1) W - 1) / 2, its four
// neighbours weighted by their distances, those outside the plane left out.
//
// Replaces no TPU kernel: the JAX package has no deformable attention. On
// the card the plain version (ops/kernels/deform_kernel.py) split the
// memory by level, copied each level's values to float32 laid per head
// (B * heads, D, H_l, W_l) so that grid_sample would take them beside the
// float32 grid, sampled each level, stacked the samples and summed them
// under the weights: on an NVIDIA H100 80GB HBM3 (700 W) at B = 64 and
// 640px, 13.8 ms of a 54 ms forward over the six layers, the copies a third
// of it. The sampler's time varied with where the weights of a seed put the
// samples, and with it the offline benchmark's throughput by about 1% from
// seed to seed. This kernel: 1.97 ms over the six layers there.
//
// Bound on the H100: the value tensor's bytes (4.3 MB an image at 640px)
// read once, if every line is sampled, beside the locations, the weights
// and the output; the work is a few dozen operations per sample. Design:
// one thread per (b, q, head, channel), so the D = 32 lanes of a warp read
// a corner's 64 contiguous bytes of one head together (and the locations
// and weights as broadcasts); each thread walks its 12 samples in order
// and keeps the weighted sum in f32, rounded once at the store. Items run
// in (b, q, head) order, so the CTAs in flight work on one or two images,
// whose values (4.3 MB) stay in L2 while their samples are taken: each line
// comes from device memory about once, whatever the samples' spread.
//
// Exactness: the plain version's arithmetic in f32 with _rn intrinsics (no
// FMA contraction), the grid 2 loc - 1 and the source pixel as
// grid_sample computes them; the sum over the 12 samples in their order,
// where the plain version reduces with torch's sum: the two agree to f32
// rounding, then to one bf16 rounding of the result.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 4;

struct Levels {
    int n;
    int h[kMaxLevels];
    int w[kMaxLevels];
    int start[kMaxLevels];  // first token of each level
};

__device__ __forceinline__ float corner(const __nv_bfloat16* v, int x, int y, int w, int h,
                                        long long row) {
    if (x < 0 || y < 0 || x >= w || y >= h) return 0.f;
    return __bfloat162float(v[(static_cast<long long>(y) * w + x) * row]);
}

__global__ void __launch_bounds__(kThreads)
deform_attention_kernel(const __nv_bfloat16* __restrict__ value, const float* __restrict__ loc,
                        const float* __restrict__ weights, __nv_bfloat16* __restrict__ out,
                        Levels lv, int queries, int heads, int dim, int points, long long items,
                        long long tokens) {
    const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    const long long item = t / dim;  // (b * Q + q) * heads + head
    if (item >= items) return;
    const int c = static_cast<int>(t - item * dim);
    const int head = static_cast<int>(item % heads);
    const long long b = item / heads / queries;
    const long long row = static_cast<long long>(heads) * dim;  // elements per token
    const __nv_bfloat16* vb = value + b * tokens * row + static_cast<long long>(head) * dim + c;
    const int samples = lv.n * points;
    const float* lp = loc + item * samples * 2;
    const float* wp = weights + item * samples;
    float acc = 0.f;
    for (int l = 0; l < lv.n; ++l) {
        const int h = lv.h[l], w = lv.w[l];
        const __nv_bfloat16* v = vb + static_cast<long long>(lv.start[l]) * row;
        for (int p = 0; p < points; ++p) {
            const int k = l * points + p;
            const float gx = __fsub_rn(__fmul_rn(2.f, lp[2 * k]), 1.f);
            const float gy = __fsub_rn(__fmul_rn(2.f, lp[2 * k + 1]), 1.f);
            const float ix = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(gx, 1.f), w), 1.f), 0.5f);
            const float iy = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(gy, 1.f), h), 1.f), 0.5f);
            const float fx = floorf(ix), fy = floorf(iy);
            const int x0 = static_cast<int>(fx), y0 = static_cast<int>(fy);
            const float dx1 = __fsub_rn(__fadd_rn(fx, 1.f), ix), dx0 = __fsub_rn(ix, fx);
            const float dy1 = __fsub_rn(__fadd_rn(fy, 1.f), iy), dy0 = __fsub_rn(iy, fy);
            float s = __fmul_rn(corner(v, x0, y0, w, h, row), __fmul_rn(dx1, dy1));
            s = __fadd_rn(s, __fmul_rn(corner(v, x0 + 1, y0, w, h, row), __fmul_rn(dx0, dy1)));
            s = __fadd_rn(s, __fmul_rn(corner(v, x0, y0 + 1, w, h, row), __fmul_rn(dx1, dy0)));
            s = __fadd_rn(s, __fmul_rn(corner(v, x0 + 1, y0 + 1, w, h, row), __fmul_rn(dx0, dy0)));
            acc = __fadd_rn(acc, __fmul_rn(wp[k], s));
        }
    }
    out[item * dim + c] = __float2bfloat16_rn(acc);
}

}  // namespace

// value (B, N, heads * dim) bf16; loc (B, Q, heads, levels, points, 2) f32;
// weights (B, Q, heads, levels * points) f32; out (B, Q, heads * dim) bf16;
// shapes: levels (h, w) pairs, host memory, their h * w summing to N.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for what it does not
// take (more than 4 levels, a plane that does not fit the tokens).
extern "C" int deform_attention_launch(const void* value, const void* loc, const void* weights,
                                       void* out, const int* shapes, int levels, int batch,
                                       int tokens, int queries, int heads, int dim, int points,
                                       void* stream) {
    if (levels < 1 || levels > kMaxLevels || batch < 0 || tokens < 1 || queries < 0 ||
        heads < 1 || dim < 1 || points < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    Levels lv{};
    lv.n = levels;
    long long at = 0;
    for (int l = 0; l < levels; ++l) {
        lv.h[l] = shapes[2 * l];
        lv.w[l] = shapes[2 * l + 1];
        if (lv.h[l] < 1 || lv.w[l] < 1) return static_cast<int>(cudaErrorInvalidValue);
        lv.start[l] = static_cast<int>(at);
        at += static_cast<long long>(lv.h[l]) * lv.w[l];
    }
    if (at != tokens) return static_cast<int>(cudaErrorInvalidValue);
    const long long items = static_cast<long long>(batch) * queries * heads;
    if (items == 0) return static_cast<int>(cudaSuccess);
    const long long blocks = (items * dim + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    deform_attention_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(value), static_cast<const float*>(loc),
        static_cast<const float*>(weights), static_cast<__nv_bfloat16*>(out), lv, queries,
        heads, dim, points, items, tokens);
    return static_cast<int>(cudaGetLastError());
}
