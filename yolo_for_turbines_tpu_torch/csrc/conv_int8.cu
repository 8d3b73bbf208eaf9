// An s8 convolution as an implicit GEMM on Hopper (s8 wgmma + TMA), kernel K7
// of the int8 serving path:
//     out[b, y, x, n] = sum over taps (u, v) and input channels c of
//                       x[b, s*y + u - pad, s*x + v - pad, c] * w[n, (u*k + v)*C + c]
// with s8 x and w, zero padding, and the exact i32 sums written as the NHWC
// i32 tensor the int8 conv's epilogue (K6) reads.
//
// Replaces no TPU kernel: XLA ran the JAX package's int8 convs as int32
// convolutions. On the card the int8 layer path ran each conv as an im2col
// copy (unfold, permute, copy_ into a (positions, k*k*C) buffer) and
// torch._int_mm, which cuBLAS ran on sm80 WMMA kernels; that plain version
// stays in ops/kernels/int8_conv_kernel.py (int8_conv_reference).
//
// Bound on an H100 SXM (1,979 T s8 operations per second dense, 3.35 TB/s,
// 700 W): bytes for most of Darknet-53's convs, whose i32 outputs are four
// times the bytes of their s8 inputs. The 55 products of one 416px forward
// outside K4's stage are 46.28 G operations per image (2.99 ms at B=128),
// and write 16.9 GB of i32 at B=128 (5.0 ms).
//
// Design:
//   1. M is the output positions in (image, y, x) order, N the output
//      channels, K the taps times the input channels. A CTA owns kM = 128
//      positions (two consumer warpgroups of 64) and kN = min(Cout, 256) of
//      the output channels (16 to 256, by Cout); one producer warp issues
//      every TMA copy into a ring of stages, and the consumers run
//      wgmma.mma_async s32.s8.s8 (m64nNk32) on the stages that have arrived.
//   2. A K step is one tap and kc channels: kc = 128 (a 128-byte swizzle
//      row) where C is a multiple of 128, else 64 or 32 with the 64- or
//      32-byte swizzle. Both operands are K-major in shared memory, as s8
//      wgmma wants them.
//   3. No im2col matrix in device memory: the A tile of a K step is loaded
//      by TMA's im2col mode from the NHWC s8 input, 128 consecutive output
//      positions (across rows and images) read at the tap's offset with the
//      conv's stride as the traversal stride; the zero padding and the
//      positions past the batch are TMA's out-of-bounds zero fill. A 1x1
//      conv at stride 1 reads its A tile as a plain tile of the (positions,
//      C) matrix. B is the K-major weight copy (Cout, k*k*C) that
//      models/quantize.py::pack_int8 makes once per conv.
//   4. The ring's depth is chosen per launch from the stage's bytes, so that
//      one CTA (kN = 256), two (128) or three (<= 64) fit an SM and one
//      CTA's stores overlap another's loads.
//   5. The i32 accumulators go from registers to device memory, two per
//      8-byte store: a quad of lanes writes 32 contiguous bytes of a row.
//
// Exactness: the i32 sums are exact in any order (|sum| <= 4608 * 127^2 <
// 2^31), so the output equals the plain version's bit for bit.
//
// Geometry taken: kernel 1 or 3 with pad kernel / 2, stride 1 or 2, C a
// multiple of 32, Cout a multiple of 16, contiguous 16-byte-aligned tensors.
// The wrapper sends every other int8 conv on the card here as a 1x1 over
// its im2col matrix, whose columns it pads to a multiple of 32.
//
// Host work per launch: two tensor-map encodes (the pointers change with
// every call); the shared-memory attribute and the occupancy are asked once
// per device.
//
// Registers (ptxas, sm_90a): 34 to 154 per thread over the five kN
// instantiations, no spills. Times: PERF.md (chip_smoke.py phase k7).

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kM = 128;                    // positions per CTA: two warpgroups of 64
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr int kMaxStages = 8;
constexpr int kMaxN = 256;                 // output channels per CTA, at most
constexpr int kBarBytes = 2 * kMaxStages * 8;
constexpr int kMaxDevices = 64;

// CTAs of one kN meant to share an SM (its ring is sized for that)
__host__ __device__ constexpr int ctas_per_sm(int n) { return n >= 256 ? 1 : n >= 128 ? 2 : 3; }

struct Params {
    int32_t* out;
    int M;               // output positions: batch * Ho * Wo
    int ho, wo;          // output sides
    int stride, pad, k;  // conv geometry
    int cin, cout;
    int kc;              // channels per K step: 32, 64 or 128
    int csteps;          // K steps per tap: cin / kc
    int ksteps;          // k * k * csteps
    int stages;          // the ring's depth
    int stage_bytes;     // one A tile (kM x kc) and one B tile (kN x kc)
    int im2col;          // 0: A is a tile of the (M, C) matrix (1x1, stride 1)
    int tiles;           // (position tiles) x (channel tiles)
};

// Shared-memory operand descriptor of a K-major tile whose rows of kc bytes
// TMA wrote with the kc-byte swizzle (kc = 128, 64 or 32; 1024-aligned
// base): 8-row groups 8 * kc bytes apart. Stepping K by 32 bytes adds 2 to
// the start address, in the descriptor's 16-byte units.
__device__ __forceinline__ uint64_t kmajor_desc(const void* tile, int kc) {
    const uint64_t layout = kc == 128 ? 1 : kc == 64 ? 2 : 3;
    return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>(1) << 16) |                    // leading offset (unused)
           (static_cast<uint64_t>((8 * kc) >> 4) << 32) |        // stride offset: 8 rows
           (layout << 62);
}

// ---- wgmma, s8 x s8 -> s32, m64nNk32 -----------------------------------------
// Both operands K-major in shared memory; the integer form takes only the
// scale-d predicate after the descriptors.

#define R8(i)                                                                       \
    "+r"(d[i + 0]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), \
        "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define R16(i) R8(i), R8(i + 8)
#define R32(i) R16(i), R16(i + 16)
#define R64(i) R32(i), R32(i + 32)
#define REGS8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define REGS16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define REGS32                                    \
    "{%0, %1, %2, %3, %4, %5, %6, %7, "           \
    "%8, %9, %10, %11, %12, %13, %14, %15, "      \
    "%16, %17, %18, %19, %20, %21, %22, %23, "    \
    "%24, %25, %26, %27, %28, %29, %30, %31}"
#define REGS64                                            \
    "{%0, %1, %2, %3, %4, %5, %6, %7, "                   \
    "%8, %9, %10, %11, %12, %13, %14, %15, "              \
    "%16, %17, %18, %19, %20, %21, %22, %23, "            \
    "%24, %25, %26, %27, %28, %29, %30, %31, "            \
    "%32, %33, %34, %35, %36, %37, %38, %39, "            \
    "%40, %41, %42, %43, %44, %45, %46, %47, "            \
    "%48, %49, %50, %51, %52, %53, %54, %55, "            \
    "%56, %57, %58, %59, %60, %61, %62, %63}"
#define REGS128                                            \
    "{%0, %1, %2, %3, %4, %5, %6, %7, "                    \
    "%8, %9, %10, %11, %12, %13, %14, %15, "               \
    "%16, %17, %18, %19, %20, %21, %22, %23, "             \
    "%24, %25, %26, %27, %28, %29, %30, %31, "             \
    "%32, %33, %34, %35, %36, %37, %38, %39, "             \
    "%40, %41, %42, %43, %44, %45, %46, %47, "             \
    "%48, %49, %50, %51, %52, %53, %54, %55, "             \
    "%56, %57, %58, %59, %60, %61, %62, %63, "             \
    "%64, %65, %66, %67, %68, %69, %70, %71, "             \
    "%72, %73, %74, %75, %76, %77, %78, %79, "             \
    "%80, %81, %82, %83, %84, %85, %86, %87, "             \
    "%88, %89, %90, %91, %92, %93, %94, %95, "             \
    "%96, %97, %98, %99, %100, %101, %102, %103, "         \
    "%104, %105, %106, %107, %108, %109, %110, %111, "     \
    "%112, %113, %114, %115, %116, %117, %118, %119, "     \
    "%120, %121, %122, %123, %124, %125, %126, %127}"

// d[64 x kN] += A[64 x 32] (shared, descriptor da) @ B[32 x kN] (shared, db)
template <int kN>
__device__ __forceinline__ void wgmma_s8(int (&d)[kN / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_s8<16>(int (&d)[8], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 " REGS8 ", %8, %9, p;\n}\n"
        : R8(0)
        : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[16], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 " REGS16 ", %16, %17, p;\n}\n"
        : R16(0)
        : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " REGS32 ", %32, %33, p;\n}\n"
        : R32(0)
        : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " REGS64 ", %64, %65, p;\n}\n"
        : R64(0)
        : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " REGS128 ", %128, %129, p;\n}\n"
        : R64(0), R64(64)
        : "l"(da), "l"(db), "r"(1));
}

#undef REGS128
#undef REGS64
#undef REGS32
#undef REGS16
#undef REGS8
#undef R64
#undef R32
#undef R16
#undef R8

// ---- the kernel ----------------------------------------------------------

// Tile t of a launch: position tile t / (Cout / kN), channel tile t % (Cout
// / kN), so that the channel tiles of one position tile run side by side
// and read its input while it is in L2.
template <int kN>
struct Tile {
    int m0, n0;
    __device__ Tile(const Params& p, int t) {
        const int n_tiles = p.cout / kN;
        const int mt = t / n_tiles;
        m0 = mt * kM;
        n0 = (t - mt * n_tiles) * kN;
    }
};

// The producer warp's lane 0: every K step's A and B tiles of the CTA's
// tiles, in order, into the ring; it runs ahead into the next tile while the
// consumers store the last one.
template <int kN>
__device__ __forceinline__ void produce(const Params& p, unsigned char* base, uint64_t* full,
                                        uint64_t* empty, const CUtensorMap* tm_x,
                                        const CUtensorMap* tm_w) {
    const int per_image = p.ho * p.wo;
    const int a_bytes = kM * p.kc;
    int it = 0;  // K steps so far, over the CTA's tiles
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        const Tile<kN> tile(p, t);
        // the filter origin of the tile's first position
        const int img = tile.m0 / per_image;
        const int rem = tile.m0 - img * per_image;
        const int y = rem / p.wo;
        const int x0 = (rem - y * p.wo) * p.stride - p.pad;
        const int y0 = y * p.stride - p.pad;
        for (int k = 0; k < p.ksteps; ++k, ++it) {
            const int s = it % p.stages;
            mbar_wait(&empty[s], empty_parity(it, p.stages));
            mbar_expect_tx(&full[s], a_bytes + kN * p.kc);
            const int tap = k / p.csteps;
            const int c0 = (k - tap * p.csteps) * p.kc;
            unsigned char* a = base + s * p.stage_bytes;
            if (p.im2col) {
                const int u = tap / p.k;
                tma_load_im2col_4d(a, tm_x, c0, x0, y0, img,
                                   static_cast<uint16_t>(tap - u * p.k), static_cast<uint16_t>(u),
                                   &full[s]);
            } else {
                tma_load(a, tm_x, c0, tile.m0, &full[s]);
            }
            tma_load(a + a_bytes, tm_w, tap * p.cin + c0, tile.n0, &full[s]);
        }
    }
}

// The two consumer warpgroups: 64 positions x kN channels each of every
// tile of the CTA.
template <int kN>
__device__ __forceinline__ void consume(const Params& p, unsigned char* base, uint64_t* full,
                                        uint64_t* empty) {
    const int tid = threadIdx.x;
    const int wg = tid >> 7;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int a_bytes = kM * p.kc;
    auto release = [&](int it) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[it % p.stages]);
    };
    int it = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        const Tile<kN> tile(p, t);
        int acc[kN / 2];
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) acc[i] = 0;
        // One commit group per K step, one group kept in flight.
        for (int k = 0; k < p.ksteps; ++k, ++it) {
            const int s = it % p.stages;
            mbar_wait(&full[s], (it / p.stages) & 1);
            const unsigned char* a = base + s * p.stage_bytes;
            const uint64_t da = kmajor_desc(a + wg * 64 * p.kc, p.kc);
            const uint64_t db = kmajor_desc(a + a_bytes, p.kc);
            pin(acc);
            wgmma_fence();
            for (int kk = 0; kk < p.kc / 32; ++kk) wgmma_s8<kN>(acc, da + 2 * kk, db + 2 * kk);
            wgmma_commit();
            wgmma_wait<1>();
            pin(acc);
            // the previous step's group is done: its stage is free
            if (k > 0) release(it - 1);
        }
        wgmma_wait<0>();
        pin(acc);
        release(it - 1);  // the tile's last stage: the producer refills it during the stores

        // accumulator i of the 64 x kN tile: row 16 * warp + lane / 4 + 8 * ((i >> 1) & 1),
        // column 8 * (i >> 2) + 2 * (lane & 3) + (i & 1)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = tile.m0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * h;
            if (row >= p.M) continue;
            int32_t* dst = p.out + static_cast<size_t>(row) * p.cout + tile.n0 + 2 * (lane & 3);
#pragma unroll
            for (int j = 0; j < kN / 8; ++j)
                *reinterpret_cast<int2*>(dst + 8 * j) =
                    make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
    }
}

// A persistent 1-D grid: CTA b takes tiles b, b + gridDim.x, ... (Tile).
template <int kN>
__global__ void __launch_bounds__(kThreads, ctas_per_sm(kN))
conv_int8_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_w, const Params p) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* base = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
    uint64_t* full = reinterpret_cast<uint64_t*>(base + p.stages * p.stage_bytes);
    uint64_t* empty = full + kMaxStages;

    if (threadIdx.x == kConsumers) {
        for (int s = 0; s < p.stages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], kConsumers / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x >= kConsumers) {
        if (threadIdx.x == kConsumers) produce<kN>(p, base, full, empty, &tm_x, &tm_w);
    } else {
        consume<kN>(p, base, full, empty);
    }
}

CUtensorMapSwizzle swizzle_of(int kc) {
    return kc == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                     : kc == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
}

template <int kN>
int launch(const CUtensorMap& tm_x, const CUtensorMap& tm_w, Params p, cudaStream_t stream) {
    p.stage_bytes = round_up(kM * p.kc + kN * p.kc, 1024);
    // the ring that lets ctas_per_sm(kN) CTAs share an SM's 228 KB (each CTA
    // also holds 1 KB for the system), at least two stages; it runs on across
    // the CTA's tiles
    const int budget = 233472 / ctas_per_sm(kN) - 1024 - 1024 - kBarBytes;
    const int stages = budget / p.stage_bytes;
    p.stages = stages < 2 ? 2 : stages > kMaxStages ? kMaxStages : stages;
    const int smem = 1024 + p.stages * p.stage_bytes + kBarBytes;
    if (smem > kSmemLimit) return cudaErrorInvalidValue;
    const long long tiles = static_cast<long long>((p.M + kM - 1) / kM) * (p.cout / kN);
    if (tiles > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
    p.tiles = static_cast<int>(tiles);
    // asked once per device (and per K step width, which sets the ring's
    // bytes): the shared memory the kernel may use, and the CTAs that fit
    // the card at once; these arrays belong to one kN
    static int allowed[kMaxDevices] = {};
    static int resident[kMaxDevices][3] = {};
    const auto kernel = conv_int8_wgmma_kernel<kN>;
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    if (smem > allowed[device]) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        allowed[device] = smem;
    }
    int& fit = resident[device][p.kc / 64];  // kc 32, 64, 128
    if (fit == 0) {
        int sms = 0, per_sm = 0;
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        fit = sms * (per_sm > 0 ? per_sm : 1);
    }
    // as many CTAs as fit the card at once, or one per tile
    const int grid = static_cast<int>(tiles < fit ? tiles : fit);
    kernel<<<grid, kThreads, smem, stream>>>(tm_x, tm_w, p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One s8 conv over a (batch, H, W, C) NHWC s8 tensor x with K-major s8
// weights w (Cout, k*k*C; row n holds output channel n's weights, K index
// (u*k + v)*C + c for tap (u, v)) into the (batch, Ho, Wo, Cout) NHWC i32
// tensor out, Ho = (H + 2*pad - k) / stride + 1 with pad = k / 2, likewise
// Wo. Every pointer 16-byte aligned; out overlaps neither input. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a geometry the kernel does
// not take, or cudaErrorNotSupported when libcuda's tensor-map encoders are
// unavailable.
extern "C" int int8_conv_launch(const void* x, const void* w, void* out, int batch, int H, int W,
                                int C, int cout, int kernel, int stride, void* stream) {
    if ((kernel != 1 && kernel != 3) || (stride != 1 && stride != 2) || C < 32 || C % 32 ||
        cout < 16 || cout % 16 || batch < 1 || H < 1 || W < 1)
        return cudaErrorInvalidValue;
    Params p{};
    p.out = static_cast<int32_t*>(out);
    p.k = kernel;
    p.pad = kernel / 2;
    p.stride = stride;
    p.ho = (H + 2 * p.pad - kernel) / stride + 1;
    p.wo = (W + 2 * p.pad - kernel) / stride + 1;
    const long long M = static_cast<long long>(batch) * p.ho * p.wo;
    if (M > 0x7FFFFFFFLL - kM) return cudaErrorInvalidValue;
    p.M = static_cast<int>(M);
    p.cin = C;
    p.cout = cout;
    p.kc = C % 128 == 0 ? 128 : C % 64 == 0 ? 64 : 32;
    p.csteps = C / p.kc;
    p.ksteps = kernel * kernel * p.csteps;
    p.im2col = !(kernel == 1 && stride == 1);
    int n = 16;
    while (n < kMaxN && cout % (2 * n) == 0) n *= 2;

    const EncodeTiled tiled = encode_tiled();
    const EncodeIm2col im2col = encode_im2col();
    if (tiled == nullptr || im2col == nullptr) return cudaErrorNotSupported;
    const CUtensorMapSwizzle sw = swizzle_of(p.kc);
    CUtensorMap tm_x, tm_w;
    const uint64_t w_dims[2] = {static_cast<uint64_t>(kernel) * kernel * C,
                                static_cast<uint64_t>(cout)};
    const uint32_t w_box[2] = {static_cast<uint32_t>(p.kc), static_cast<uint32_t>(n)};
    if (!encode(tiled, &tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, 2, w_dims, w_box, sw))
        return cudaErrorInvalidValue;
    if (!p.im2col) {
        const uint64_t x_dims[2] = {static_cast<uint64_t>(C), static_cast<uint64_t>(M)};
        const uint32_t x_box[2] = {static_cast<uint32_t>(p.kc), kM};
        if (!encode(tiled, &tm_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, x, 2, x_dims, x_box, sw))
            return cudaErrorInvalidValue;
    } else {
        // (channel, x, y, image); the bounding box holds the filter origins
        // of the output positions: from -pad to (side - 1) + pad - (k - 1)
        const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                                    static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(batch)};
        const cuuint64_t strides[3] = {static_cast<cuuint64_t>(C),
                                       static_cast<cuuint64_t>(W) * C,
                                       static_cast<cuuint64_t>(H) * W * C};
        const int lower[2] = {-p.pad, -p.pad};
        const int upper[2] = {p.pad - (kernel - 1), p.pad - (kernel - 1)};
        const cuuint32_t traverse[4] = {1, static_cast<cuuint32_t>(stride),
                                        static_cast<cuuint32_t>(stride), 1};
        if (im2col(&tm_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x), dims, strides,
                   lower, upper, static_cast<cuuint32_t>(p.kc), kM, traverse,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
            return cudaErrorInvalidValue;
    }
    const auto st = static_cast<cudaStream_t>(stream);
    switch (n) {
        case 256: return launch<256>(tm_x, tm_w, p, st);
        case 128: return launch<128>(tm_x, tm_w, p, st);
        case 64: return launch<64>(tm_x, tm_w, p, st);
        case 32: return launch<32>(tm_x, tm_w, p, st);
        default: return launch<16>(tm_x, tm_w, p, st);
    }
}
