// K10: the single-image letterbox (inference.Predictor.predict_image on the
// card), in one pass from the host frame as uploaded to the model's input:
//
//   out[0, r, c, ch] = v / 255 inside the resized image, 0 in the pad,
//   v = Pillow's 8-bit bilinear resize (Image.resize(..., BILINEAR)) of the
//       HWC uint8 frame (h0, w0, 3) to (nh, nw), placed at (top, left) of
//       the (S, S) canvas,
//
// bit for bit equal to data/augment.py::letterbox followed by
// astype(np.float32) / 255.0. Pillow's resample (libImaging/Resample.c) is
// integer arithmetic: each pass sums pixel * k in int32 from 1 << 21, with k
// the coefficients in fixed point with 22 fractional bits, and clip8 keeps
// the shift right by 22 clamped to [0, 255]; the horizontal pass is rounded
// to uint8 before the vertical one. The coefficients are computed on the host
// in float64 as Pillow computes them (ops/kernels/letterbox_kernel.py::
// pil_bilinear_tables) and read here as int32 tables: bounds (out, 2), each
// output's first source index and count of taps, and coeffs (out, ksize).
// A pass Pillow skips (an unchanged side) comes as the identity: one tap of
// 1 << 22.
//
// Replaces no TPU kernel: the JAX package letterboxes on the host with PIL,
// as the port did on the card too (PIL's resize took about 11 ms of a 1080p
// request on the host). Bound on the H100: bytes, the frame read once (6.2 MB
// at 1080p) and the float32 canvas written once (2.08 MB at 416px), about
// 2.5 us at 3.35 TB/s; in practice a launch of a few microseconds. Design:
// each CTA takes a band of up to 16 canvas rows by a tile of up to 64
// columns. It runs the horizontal pass over only the source rows its band's
// image rows read (the band's halo rows are recomputed by the next band) and
// keeps them as uint8 in shared memory, then runs the vertical pass from
// there and writes the band's floats, the pad's zeros included, so that no
// other launch touches the canvas. The 1/255 of each value is IEEE division
// (no fast math), taken once per CTA into a 256-entry table.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // one thread per entry of the 1/255 table
constexpr int kPrecisionBits = 22;  // Pillow's PRECISION_BITS, 32 - 8 - 2
constexpr int kSmemDefault = 48 * 1024;

__device__ __forceinline__ int clip8(int ss) {
    const int v = ss >> kPrecisionBits;  // arithmetic shift, as Pillow's
    return v < 0 ? 0 : (v > 255 ? 255 : v);
}

__global__ void __launch_bounds__(kThreads)
letterbox_kernel(const uint8_t* __restrict__ src, int w0, const int* __restrict__ hb,
                 const int* __restrict__ hk, int hks, const int* __restrict__ vb,
                 const int* __restrict__ vk, int vks, float* __restrict__ out, int size, int nh,
                 int nw, int top, int left, int band_rows, int tile_cols) {
    extern __shared__ uint8_t mid[];  // the horizontal pass: source rows x columns x 3
    __shared__ float scaled[256];
    scaled[threadIdx.x] = __fdiv_rn(static_cast<float>(threadIdx.x), 255.0f);

    // this CTA's canvas rows [r0, r1) and columns [c0, c1), and the image's
    // rows [i0, i1) and columns [j0, j1) among them
    const int r0 = blockIdx.y * band_rows, r1 = min(size, r0 + band_rows);
    const int c0 = blockIdx.x * tile_cols, c1 = min(size, c0 + tile_cols);
    const int i0 = max(r0, top) - top, i1 = min(r1, top + nh) - top;
    const int j0 = max(c0, left) - left, j1 = min(c1, left + nw) - left;
    const int pitch = max(j1 - j0, 0) * 3;
    int first = 0;  // the first source row the band reads
    if (i1 > i0 && pitch > 0) {
        first = vb[2 * i0];
        const int rows = vb[2 * (i1 - 1)] + vb[2 * (i1 - 1) + 1] - first;
        const int items = rows * pitch;
        for (int t = threadIdx.x; t < items; t += kThreads) {
            const int r = t / pitch, q = t - r * pitch;
            const int j = j0 + q / 3, ch = q - (q / 3) * 3;
            const int xmin = hb[2 * j], taps = hb[2 * j + 1];
            const int* k = hk + static_cast<long long>(j) * hks;
            const uint8_t* p =
                src + (static_cast<long long>(first + r) * w0 + xmin) * 3 + ch;
            int ss = 1 << (kPrecisionBits - 1);
            for (int x = 0; x < taps; ++x) ss += static_cast<int>(p[3 * x]) * k[x];
            mid[t] = static_cast<uint8_t>(clip8(ss));
        }
    }
    __syncthreads();

    const int width = (c1 - c0) * 3;
    const int items = (r1 - r0) * width;
    for (int t = threadIdx.x; t < items; t += kThreads) {
        const int rr = t / width, q = t - rr * width;
        const int cc = q / 3, ch = q - cc * 3;
        const int i = r0 + rr - top, j = c0 + cc - left;
        float v = 0.0f;
        if (i >= 0 && i < nh && j >= 0 && j < nw) {
            const int taps = vb[2 * i + 1];
            const int* k = vk + static_cast<long long>(i) * vks;
            const uint8_t* p = mid + (vb[2 * i] - first) * pitch + (j - j0) * 3 + ch;
            int ss = 1 << (kPrecisionBits - 1);
            for (int y = 0; y < taps; ++y) ss += static_cast<int>(p[y * pitch]) * k[y];
            v = scaled[clip8(ss)];
        }
        out[(static_cast<long long>(r0 + rr) * size + c0 + cc) * 3 + ch] = v;
    }
}

}  // namespace

// table: the horizontal bounds (nw, 2) and coeffs (nw, hks), then the
// vertical bounds (nh, 2) and coeffs (nh, vks), int32 in one buffer; out
// (1, size, size, 3) float32; smem: bytes of the horizontal pass per CTA.
extern "C" int letterbox_launch(const void* src, int w0, const void* table, int hks, int vks,
                                void* out, int size, int nh, int nw, int top, int left,
                                int band_rows, int tile_cols, int smem, void* stream) {
    const int* hb = static_cast<const int*>(table);
    const int* hk = hb + 2 * static_cast<long long>(nw);
    const int* vb = hk + static_cast<long long>(nw) * hks;
    const int* vk = vb + 2 * static_cast<long long>(nh);
    if (smem > kSmemDefault) {
        const cudaError_t e = cudaFuncSetAttribute(
            letterbox_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return e;
    }
    const dim3 grid((size + tile_cols - 1) / tile_cols, (size + band_rows - 1) / band_rows);
    letterbox_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(src), w0, hb, hk, hks, vb, vk, vks, static_cast<float*>(out),
        size, nh, nw, top, left, band_rows, tile_cols);
    return cudaGetLastError();
}
