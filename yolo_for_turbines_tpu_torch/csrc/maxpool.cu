// K8: the max pools of the folded bf16 forward, on NHWC memory (a
// channels_last tensor), in two geometries of one family:
//
//   - the pyramid: out[b, h, w, s * C + c] = the max of x[b, ., ., c] over
//     the windows[s] x windows[s] window centred on (h, w), stride 1, the
//     cells outside the plane skipped (F.max_pool2d(x, k, 1, padding=k // 2));
//     a window of 1 is x itself. YOLOv4's SPP (13, 9, 5, 1) and YOLOv7's
//     SPPCSPC (1, 5, 9, 13): the pools and the channel concat after them in
//     one pass that writes each slot's channel slice of the output row.
//   - 2x2 windows at stride 2, VALID (YOLOv7's MP, tiny's down-sampling
//     pools): out[b, i, j, c] = the max of x[b, 2i..2i+1, 2j..2j+1, c]; or
//     at stride 1, SAME with the pad after (tiny's last pool, as the JAX
//     maxpool2d): the max of x[b, i..i+1, j..j+1, c] inside the plane.
//   - 3x3 windows at stride 2 with a symmetric pad of 1 (the ResNet stem's
//     pool, RT-DETR's; F.max_pool2d(x, 3, 2, 1)): out[b, i, j, c] = the max
//     of x[b, 2i-1..2i+1, 2j-1..2j+1, c] inside the plane, Ho = (H - 1) / 2
//     + 1 (the pad is -inf: the cells outside are skipped).
//
// Replaces no TPU kernel: the JAX package pools with lax.reduce_window and
// XLA fused each pool with its neighbours. On the card aten's NHWC max pool
// (max_pool_forward_nhwc) read a 5-, 9- or 13-wide window around each
// output cell from device memory, so SPP's three pools read its plane
// 25 + 81 + 169 times over and then torch.cat copied them into the concat:
// 2.7 ms for YOLOv4's SPP at B = 64, 608px (1.3% of its byte bound), and
// 6.1 ms for YOLOv7's pools at 640px.
//
// Bound on the H100: device-memory bytes. The pyramid reads its plane once
// and writes len(windows) planes; 2x2 reads four input cells and writes one.
//
// Design, pyramid: one CTA per (image, block of 8 << qshift channels) loads
// the whole H x W plane of its channels into shared memory with 16-byte
// cp.async copies (all in flight at once), then forms the windows from
// there: separable maxima (a row pass into a second plane, then a column
// pass back), cascaded from the smallest window to the largest (13 = 5 of
// 5 of 5, 9 = 5 of 5: exact for max, and exact at the plane's edges, where
// each pass skips what lies outside). Each level's column pass writes the
// slots of its window as 16-byte stores of 8 channels. The channel block is
// the widest (up to 64) whose two planes fit kSmemTarget, so that four CTAs
// share an SM. A plane whose two copies at 8 channels exceed kSmemMax
// (sides above 85) is split into bands of rows, a CTA a band: it loads
// its band and `halo` rows on each side (the largest window's radius) and
// stores the band's rows alone. Each pass of the cascade spoils only the
// rows within its reach of a loaded edge inside the plane, and the halo
// is as wide as all of them together, so the stored rows are exact. A row
// too wide for a band of one row and its halos is refused.
// Design, 2x2: a streaming pass; each thread owns 8 channels of one output
// cell (four 16-byte loads, one 16-byte store) in a grid-stride loop over
// the card's resident blocks. At stride 1 the loads past the plane's last
// row or column read that row or column again, which leaves the max as it
// is. 3x3 at stride 2 is the same pass with nine loads, the rows and
// columns outside the plane clamped to the centre's (always inside), which
// again leaves the max as it is; neighbouring windows share a row or a
// column, which L2 serves.
//
// Exactness: __hmax2_nan on bf16 pairs; max is order-free, and a NaN
// anywhere in a window gives NaN, as aten's pool (`val > max || isnan`).
// The values equal the aten composition's; of +0 and -0 in one window
// either may come out, and they compare equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSlots = 8;
constexpr int kMaxDevices = 64;
// shared memory a pyramid CTA aims at: four CTAs to an SM (228 KB)
constexpr int kSmemTarget = 56 * 1024;
// the most one CTA may take (232,448 bytes, after opting in)
constexpr int kSmemMax = 227 * 1024;

struct Windows {
    int n;  // slots
    int k[kMaxSlots];  // each slot's window, odd
};

__device__ __forceinline__ uint32_t max2(uint32_t a, uint32_t b) {
    const __nv_bfloat162 r = __hmax2_nan(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                         *reinterpret_cast<const __nv_bfloat162*>(&b));
    return *reinterpret_cast<const uint32_t*>(&r);
}

// 8 bf16 channels at once
__device__ __forceinline__ uint4 max8(uint4 a, uint4 b) {
    return make_uint4(max2(a.x, b.x), max2(a.y, b.y), max2(a.z, b.z), max2(a.w, b.w));
}

__device__ __forceinline__ void copy16_async(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void wait_copies() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Grid (C / (8 << qshift), images, bands). x holds c8 16-byte vectors a
// pixel, out win.n * c8; band z stores rows [z * band, (z + 1) * band) of
// its image and loads rows [l0, l1), `halo` more on each side inside the
// plane. `plane` is this CTA's block of the loaded rows, `rows` a level's
// row pass. Vector i of a plane is pixel i >> qshift, vector i & (q_n - 1)
// of the block.
__global__ void __launch_bounds__(kThreads)
maxpool_pyramid_kernel(const uint4* __restrict__ x, uint4* __restrict__ out, Windows win, int h,
                       int w, int c8, int qshift, int band, int halo) {
    extern __shared__ uint4 smem[];
    const int q_n = 1 << qshift;
    const int r0 = blockIdx.z * band, r1 = min(h, r0 + band);
    const int l0 = max(0, r0 - halo), lh = min(h, r1 + halo) - l0;  // rows loaded
    const int n = (lh * w) << qshift;
    // the vectors of the rows this band stores
    const int lo = ((r0 - l0) * w) << qshift, hi = ((r1 - l0) * w) << qshift;
    uint4* plane = smem;
    uint4* rows = smem + n;
    const long long first = (static_cast<long long>(blockIdx.y) * h + l0) * w;  // pixel
    const int q0 = blockIdx.x << qshift;
    const uint4* src = x + first * c8 + q0;
    uint4* dst = out + first * win.n * c8 + q0;

    for (int i = threadIdx.x; i < n; i += kThreads) {
        copy16_async(plane + i, src + static_cast<long long>(i >> qshift) * c8 + (i & (q_n - 1)));
    }
    wait_copies();
    __syncthreads();

    // vector i of the plane into every slot whose window is k, if its row
    // is one this band stores
    auto store = [=](int i, uint4 v, int k) {
        if (i < lo || i >= hi) return;
        const long long at = static_cast<long long>(i >> qshift) * win.n * c8 + (i & (q_n - 1));
#pragma unroll
        for (int s = 0; s < kMaxSlots; ++s) {  // unrolled: win.k stays in the parameter bank
            if (s < win.n && win.k[s] == k) dst[at + static_cast<long long>(s) * c8] = v;
        }
    };
    for (int i = lo + threadIdx.x; i < hi; i += kThreads) store(i, plane[i], 1);

    const int row_step = w << qshift;  // vectors from one row of pixels to the next
    int radius = 0;  // of the window `plane` holds
    for (;;) {
        int next = 0x7fffffff;  // the next larger window
#pragma unroll
        for (int s = 0; s < kMaxSlots; ++s) {
            if (s < win.n && win.k[s] > 2 * radius + 1 && win.k[s] < next) next = win.k[s];
        }
        if (next == 0x7fffffff) break;
        const int grow = (next - 1) / 2 - radius;
        const int dw = min(grow, w - 1), dh = min(grow, lh - 1);  // past them: outside
        for (int i = threadIdx.x; i < n; i += kThreads) {
            const int p = i >> qshift;
            const int col = p - (p / w) * w;
            uint4 m = plane[i];
            for (int t = 1; t <= dw; ++t) {
                if (col - t >= 0) m = max8(m, plane[i - (t << qshift)]);
                if (col + t < w) m = max8(m, plane[i + (t << qshift)]);
            }
            rows[i] = m;
        }
        __syncthreads();
        for (int i = threadIdx.x; i < n; i += kThreads) {
            const int row = (i >> qshift) / w;
            uint4 m = rows[i];
            for (int t = 1; t <= dh; ++t) {
                if (row - t >= 0) m = max8(m, rows[i - t * row_step]);
                if (row + t < lh) m = max8(m, rows[i + t * row_step]);
            }
            plane[i] = m;
            store(i, m, next);
        }
        __syncthreads();
        radius = (next - 1) / 2;
    }
}

// Grid (blocks, images): image y, then y + gridDim.y, ...; within an image
// the items are (output cell, vector of 8 channels), ho * wo * c8 of them.
// Stride 2: ho = h / 2, wo = w / 2; stride 1: ho = h, wo = w.
__global__ void __launch_bounds__(kThreads)
maxpool2x2_kernel(const uint4* __restrict__ x, uint4* __restrict__ out, int batch, int h, int w,
                  int c8, int stride) {
    const int ho = stride == 2 ? h / 2 : h, wo = stride == 2 ? w / 2 : w;
    const int items = ho * wo * c8;
    for (int image = blockIdx.y; image < batch; image += gridDim.y) {
        const uint4* src = x + static_cast<long long>(image) * h * w * c8;
        uint4* dst = out + static_cast<long long>(image) * items;
        for (int i = blockIdx.x * kThreads + threadIdx.x; i < items; i += gridDim.x * kThreads) {
            const int cell = i / c8, q = i - cell * c8;
            const int oi = cell / wo, oj = cell - oi * wo;
            const int i0 = stride * oi, j0 = stride * oj;
            // the next row and column, or the last again at stride 1's edge
            const long long down = static_cast<long long>(min(i0 + 1, h - 1) - i0) * w * c8;
            const int right = (min(j0 + 1, w - 1) - j0) * c8;
            const long long at = (static_cast<long long>(i0) * w + j0) * c8 + q;
            const uint4 a = src[at], b = src[at + right];
            const uint4 c = src[at + down], d = src[at + down + right];
            dst[i] = max8(max8(a, b), max8(c, d));
        }
    }
}

// Grid (blocks, images) as maxpool2x2_kernel's; ho = (h - 1) / 2 + 1, wo
// likewise. The window's rows 2i - 1 .. 2i + 1 and columns 2j - 1 .. 2j + 1,
// those outside the plane replaced by 2i and 2j.
__global__ void __launch_bounds__(kThreads)
maxpool3x3s2_kernel(const uint4* __restrict__ x, uint4* __restrict__ out, int batch, int h,
                    int w, int c8) {
    const int ho = (h - 1) / 2 + 1, wo = (w - 1) / 2 + 1;
    const int items = ho * wo * c8;
    for (int image = blockIdx.y; image < batch; image += gridDim.y) {
        const uint4* src = x + static_cast<long long>(image) * h * w * c8;
        uint4* dst = out + static_cast<long long>(image) * items;
        for (int i = blockIdx.x * kThreads + threadIdx.x; i < items; i += gridDim.x * kThreads) {
            const int cell = i / c8, q = i - cell * c8;
            const int oi = cell / wo, oj = cell - oi * wo;
            const int i0 = 2 * oi, j0 = 2 * oj;
            const int rows[3] = {i0 > 0 ? i0 - 1 : i0, i0, i0 + 1 < h ? i0 + 1 : i0};
            const int cols[3] = {j0 > 0 ? j0 - 1 : j0, j0, j0 + 1 < w ? j0 + 1 : j0};
            uint4 m = src[(static_cast<long long>(i0) * w + j0) * c8 + q];
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                const long long row = static_cast<long long>(rows[a]) * w;
#pragma unroll
                for (int b = 0; b < 3; ++b) m = max8(m, src[(row + cols[b]) * c8 + q]);
            }
            dst[i] = m;
        }
    }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// the card's resident blocks of `kernel`, asked once per device (`cached`
// belongs to one kernel)
template <typename Kernel>
int resident_blocks(Kernel kernel, int* cached) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
    if (cached[dev] == 0) {
        int sms = 0, per_sm = 0;
        if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) !=
                cudaSuccess) {
            return 0;
        }
        cached[dev] = sms * per_sm;
    }
    return cached[dev];
}

}  // namespace

// The pyramid. x (B, H, W, C) bf16, out (B, H, W, n_slots * C) bf16, both
// 16-byte aligned, C % 8 == 0; windows: n_slots odd windows >= 1 (host
// memory). Returns cudaGetLastError(), or cudaErrorInvalidValue for what
// the kernel does not take (a row whose band of one row and its halos
// exceeds kSmemMax at 8 channels, more than 65,535 bands).
extern "C" int maxpool_pyramid_launch(const void* x, void* out, const int* windows, int n_slots,
                                      int batch, int h, int w, int c, void* stream) {
    if (n_slots < 1 || n_slots > kMaxSlots || batch < 0 || h < 1 || w < 1 || c < 8 ||
        c % 8 != 0 || !aligned16(x) || !aligned16(out)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    Windows win{};
    win.n = n_slots;
    int halo = 0;
    for (int s = 0; s < n_slots; ++s) {
        if (windows[s] < 1 || windows[s] % 2 == 0) return static_cast<int>(cudaErrorInvalidValue);
        win.k[s] = windows[s];
        if ((windows[s] - 1) / 2 > halo) halo = (windows[s] - 1) / 2;
    }
    if (batch == 0) return static_cast<int>(cudaSuccess);
    const int c8 = c / 8;
    const long long pixels = static_cast<long long>(h) * w;
    const long long row_bytes = 2 * (16LL * w);  // a row of both planes, 8 channels
    // the whole plane in one band where it fits, else bands as tall as fit
    // with their halos, evened out
    int band = h, bands = 1;
    if (h * row_bytes > kSmemMax) {
        const long long most = kSmemMax / row_bytes - 2LL * halo;
        if (most < 1) return static_cast<int>(cudaErrorInvalidValue);
        bands = static_cast<int>((h + most - 1) / most);
        band = (h + bands - 1) / bands;
        if (bands > 65535) return static_cast<int>(cudaErrorInvalidValue);
    }
    const int loaded = band + 2 * halo < h ? band + 2 * halo : h;
    auto smem_of = [&](int qshift) { return loaded * (row_bytes << qshift); };
    int qshift = 0;
    for (int q = 3; q > 0; --q) {
        if (c8 % (1 << q) == 0 && smem_of(q) <= kSmemTarget) {
            qshift = q;
            break;
        }
    }
    static bool opted[kMaxDevices] = {};
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
        return static_cast<int>(cudaErrorInvalidDevice);
    }
    if (!opted[dev]) {
        const cudaError_t e = cudaFuncSetAttribute(
            maxpool_pyramid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
        if (e != cudaSuccess) return static_cast<int>(e);
        opted[dev] = true;
    }
    const auto s = static_cast<cudaStream_t>(stream);
    for (int b0 = 0; b0 < batch; b0 += 65535) {  // grid.y caps the images of a launch
        const int nb = batch - b0 < 65535 ? batch - b0 : 65535;
        const long long skip = static_cast<long long>(b0) * pixels * c8;
        maxpool_pyramid_kernel<<<dim3(c8 >> qshift, nb, bands), kThreads, smem_of(qshift), s>>>(
            static_cast<const uint4*>(x) + skip, static_cast<uint4*>(out) + skip * n_slots, win,
            h, w, c8, qshift, band, halo);
    }
    return static_cast<int>(cudaGetLastError());
}

// 2x2 windows, stride 2 VALID or stride 1 SAME. x (B, H, W, C) bf16, out
// (B, Ho, Wo, C) bf16 (H / 2 x W / 2 at stride 2, H x W at stride 1), both
// 16-byte aligned, C % 8 == 0, Ho * Wo * C / 8 <= 2^30 (the kernel's 32-bit
// index, its grid stride added). Returns cudaGetLastError().
extern "C" int maxpool2x2_launch(const void* x, void* out, int batch, int h, int w, int c,
                                 int stride, void* stream) {
    const long long ho = stride == 2 ? h / 2 : h, wo = stride == 2 ? w / 2 : w;
    if (batch < 0 || h < 0 || w < 0 || c < 8 || c % 8 != 0 || (stride != 1 && stride != 2) ||
        !aligned16(x) || !aligned16(out) || ho * wo * (c / 8) > (1LL << 30)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long items = ho * wo * (c / 8);
    if (batch == 0 || items == 0) return static_cast<int>(cudaSuccess);
    static int resident[kMaxDevices] = {};
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
        return static_cast<int>(cudaErrorInvalidDevice);
    }
    if (resident[dev] == 0) {
        int sms = 0, per_sm = 0;
        if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, maxpool2x2_kernel, kThreads,
                                                          0) != cudaSuccess) {
            return static_cast<int>(cudaErrorInvalidDevice);
        }
        resident[dev] = sms * per_sm;
    }
    // the card's resident blocks, spread over the images
    const long long images = batch < 65535 ? batch : 65535;
    long long across = resident[dev] / images;
    if (across < 1) across = 1;
    const long long per_image = (items + kThreads - 1) / kThreads;
    if (across > per_image) across = per_image;
    maxpool2x2_kernel<<<dim3(static_cast<unsigned>(across), static_cast<unsigned>(images)),
                        kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(out), batch, h, w, c / 8, stride);
    return static_cast<int>(cudaGetLastError());
}

// 3x3 windows at stride 2, pad 1. x (B, H, W, C) bf16, out (B, Ho, Wo, C)
// bf16 with Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1, both 16-byte
// aligned, C % 8 == 0, Ho * Wo * C / 8 <= 2^30. Returns cudaGetLastError().
extern "C" int maxpool3x3s2_launch(const void* x, void* out, int batch, int h, int w, int c,
                                   void* stream) {
    if (batch < 0 || h < 1 || w < 1 || c < 8 || c % 8 != 0 || !aligned16(x) || !aligned16(out)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long items = static_cast<long long>((h - 1) / 2 + 1) * ((w - 1) / 2 + 1) * (c / 8);
    if (items > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
    if (batch == 0) return static_cast<int>(cudaSuccess);
    static int cached[kMaxDevices] = {};
    const int resident = resident_blocks(maxpool3x3s2_kernel, cached);
    if (resident <= 0) return static_cast<int>(cudaErrorInvalidDevice);
    const long long images = batch < 65535 ? batch : 65535;
    long long across = resident / images;
    if (across < 1) across = 1;
    const long long per_image = (items + kThreads - 1) / kThreads;
    if (across > per_image) across = per_image;
    maxpool3x3s2_kernel<<<dim3(static_cast<unsigned>(across), static_cast<unsigned>(images)),
                          kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(out), batch, h, w, c / 8);
    return static_cast<int>(cudaGetLastError());
}
