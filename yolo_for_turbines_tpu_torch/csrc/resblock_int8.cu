// Fused int8 Darknet residual block (post-training-quantized serving path) on
// Hopper (s8 wgmma + TMA):
//     mid = clip(rint(act(x @ W1 * d1 + b1) * vm1), -127, 127)   s8, 0 outside the image
//     y   = act(conv3x3(mid) * d2 + b2)
//     out = clip(rint(y * vout + x * rres), -127, 127)           s8
// with s8 activations and weights, i32 sums and an f32 epilogue whose
// per-channel rows (d1 = s_in*sw1, vm1 = 1/s_mid, d2 = s_mid*sw2,
// vout = 1/s_out, rres = s_in/s_out) the wrapper folds from the calibrated
// scale chain.
//
// Replaces the Pallas kernel
// yolo_for_turbines_tpu/ops/pallas/resblock_int8_kernel.py
// (fused_residual_stage_int8 / _stage_kernel_i8) and follows its formula,
// not the XLA block loop's (which divides by the scales instead of
// multiplying by their reciprocals). One launch runs ONE block.
//
// Bound on an H100 SXM (1,979 T int8 operations per second dense, 700 W):
// compute. One block of one 26x26x512 image is 2*676*(512*256 + 2304*512) =
// 1.772 G operations, so the 8-block stage at B=128 is 1.815 T operations =
// 0.917 ms (0.057 ms at B=8); its bytes (x, out and the weights once) take
// 0.03 ms at B=128.
//
// Design: the skeleton of the bf16 kernel (resblock.cu), with what s8 changes.
//   1. Products on wgmma.mma_async s32.s8.s8 (m64n256k32 for the 3x3,
//      m64n64k32 for the 1x1), both operands K-major in shared memory, i32
//      accumulators in registers. Two consumer warpgroups; one producer warp
//      issues every TMA copy.
//   2. A CTA owns kM = 128 positions of the zero-padded (W+2)-wide layout
//      (th = 128 / (W+2) output rows) and kNOut = 256 of the 512 output
//      channels. The grid is (row tiles, 2, B); the two CTAs of a tile are a
//      cluster that splits the 1x1 (128 mid channels each, over the th + 2
//      input rows) and swaps halves of mid by one bulk copy through
//      distributed shared memory. Each CTA runs the 3x3 over its own half of
//      mid first, so the exchange overlaps 9 K stages.
//   3. A 128-byte swizzle row holds 128 channels, so K per ring stage is 128:
//      the 1x1 has 4 K stages, the 3x3 has 18, two per tap. The whole x tile
//      (up to 192 rows x 512 channels, 96 KB) and the CTA's half of W1
//      (64 KB) are resident for the 1x1; the 3x3 reuses that memory for mid
//      (two 128-channel blocks) and a 5-stage ring of W2 tiles (256 channels x
//      128 bytes). The ring's slots count down from the top of shared memory:
//      those that lie past the x tile and W1 are filled while the 1x1 runs.
//   4. A tap (u, v) of the 3x3 is a row shift of (u-1)*(W+2) + (v-1) in the
//      padded layout. mid is kept in the layout TMA writes (128-byte rows,
//      128-byte swizzle), and wgmma applies that swizzle on absolute
//      shared-memory address bits, so the shift is just the start address of
//      the A descriptor.
//   5. Epilogues run from the accumulator registers; the seven per-channel
//      rows of the CTA's slice are staged in shared memory once, one float4
//      per channel. The 1x1's epilogue writes s8 mid where the image is and
//      leaves every other position at exactly 0 (the conv's zero padding; a
//      zero-filled x row would give requant(act(b1) * vm1), not 0). For the
//      3x3's, the producer loads the residual x tile by TMA into the ring slot
//      that frees up first after the last round; the output codes replace it
//      in place and are stored by TMA, which clips rows past the image.
//
// Exactness: with leaky_relu the output equals the plain torch version
// (fused_residual_stage_int8_reference) code for code. The i32 sums are exact
// in any order (|sum| <= 2304 * 127^2 < 2^31); the f32 epilogue uses the _rn
// intrinsics, which the compiler never contracts into FMAs, in the plain
// version's operation order, and rintf rounds half to even like torch.round.
// Mish goes through tanhf/log1pf/expf, which may differ from torch's by an
// ulp and so move a code at a .5 tie.
//
// x is read by TMA as a (B*H*W, C) matrix for the 1x1: rows above the first
// image and past the last one are zero-filled by the hardware, rows of a
// neighbouring image are computed and discarded, so the buffers need no
// padding. Outputs never alias inputs (neighbouring CTAs read each other's
// halo rows): the wrapper ping-pongs two buffers across a stage. The weights
// come K-major: W1 as (C/2, C) and W2 as (C, 9*C/2), each row one output
// channel (w2's K index is tap * C/2 + input channel).
//
// Geometry taken: C = 512, 1 <= W <= 32, any H.
//
// Times (NVIDIA H100 80GB HBM3, 700 W power limit; chip_smoke.py phase k4):
// the 8-block 26x26x512 stage takes 2.65 ms at B=128, 35% of its bound, and
// 0.21 ms at B=8 (27%), against 21.3 and 1.72 ms for the mma.sync (WMMA)
// kernel this one replaces, run in the same call.
//
// What limits it (tools/resblock_phases.py --kernel k4, B=128): a CTA takes
// 22.1 us. The 3x3 loop (11.1 us) runs at about 90% of the SM's s8 rate, but
// one CTA fills an SM, so its serial phases leave the tensor cores idle half
// of the time: the x tile and the 1x1 2.2 us, the zeroing of mid 1.0 us, the
// 1x1's epilogue 3.3 us, the output epilogue 3.8 us, the store 0.6 us. The
// epilogues are bound by instruction issue (about 20 per element), after
// their conversions were cut to one per element. Hiding them needs a second
// tile in flight per SM: a persistent kernel, or chained blocks.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kC = 512;               // channels the kernel takes
constexpr int kCh = kC / 2;           // mid channels
constexpr int kNOut = 256;            // output channels per CTA
constexpr int kM = 128;               // rows per CTA product: two warpgroups of 64
constexpr int kKc = 128;              // K per stage: one 128-byte swizzle row of s8
constexpr int kConsumers = 256;       // two warpgroups
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr int kMaxW = 32;
constexpr int kK1 = kC / kKc;         // K stages of the 1x1
constexpr int kTaps = 9;
constexpr int kK3 = kTaps * kCh / kKc;  // K stages of the 3x3: one per tap and half of mid
constexpr int kRowBlocks = 3;         // 64-row blocks of the 1x1: up to 192 positions
constexpr int kW1Tile = 128 * 128;    // 128 mid channels x 128 input channels
constexpr int kW2Stages = 5;
constexpr int kW2Tile = kNOut * 128;  // 256 output channels x 128 of K
constexpr int kBarBytes = 256;
// the CTA's epilogue rows, one float4 per channel: (d1, b1, vm1, -) for its
// 128 mid channels, (d2, b2, vout, rres) for its 256 output channels
constexpr int kRowBytes = (128 + kNOut) * 16;
constexpr int kTailBytes = kBarBytes + kRowBytes;
// A cluster holds the kC / kNOut CTAs of one tile (its output-channel
// slices); each computes 128 of the 1x1's kCh channels into every CTA's mid.
constexpr int kPair = kC / kNOut;
static_assert(kPair == 2 && kCh / kPair == kKc, "one 128-channel block of mid per CTA of a pair");
static_assert(kK3 == kPair * kTaps, "a K stage of the 3x3 is one tap of one block of mid");

// Shared-memory plan of one CTA for a width W; offsets from a 1024-aligned
// base. The 1x1 holds the x tile and W1; the 3x3 reuses that memory for mid
// and the W2 ring. (ops/kernels/resblock_int8_kernel.py::smem_plan mirrors
// it for the tests.)
struct Layout {
    int th;        // output rows of a tile
    int n1;        // positions of the 1x1: th + 2 input rows
    int xchunk;    // bytes of one 128-channel K chunk of the x tile
    int w1_off;    // the CTA's kK1 W1 tiles, past the x tile
    int mid_block;  // bytes of one 128-channel block of mid
    int ring_end;   // the W2 ring's slots count down from here
    int w2_early;   // its first slots that lie past the x tile and W1
    int res_bytes, res_stride;  // one 128-channel residual box, and its slot
    int bar_off;  // then the barriers, then the epilogue rows
    __host__ __device__ explicit Layout(int W) {
        th = kM / (W + 2);
        n1 = (th + 2) * W;
        xchunk = round_up(n1, 8) * 128;
        w1_off = kK1 * xchunk;
        mid_block = round_up((kM + 2 * (W + 2) + 2) * 128, 1024);
        ring_end = kPair * mid_block + kW2Stages * kW2Tile;
        res_bytes = th * W * 128;
        res_stride = round_up(res_bytes, 1024);
        const int end1 = w1_off + kK1 * kW1Tile;
        w2_early = ring_end > end1 ? (ring_end - end1) / kW2Tile : 0;
        if (w2_early > kW2Stages) w2_early = kW2Stages;
        bar_off = end1 > ring_end ? end1 : ring_end;
    }
    __host__ __device__ int slot_off(int s) const { return ring_end - (s + 1) * kW2Tile; }
    __host__ __device__ int smem_bytes() const { return 1024 + bar_off + kTailBytes; }
};

struct Barriers {
    uint64_t x_full[kK1];  // K chunk k of the x tile and W1 tile k
    uint64_t w2_full[kW2Stages], w2_empty[kW2Stages];
    uint64_t x_done;     // every consumer warp is past the 1x1's products
    uint64_t mid_own;    // this CTA's half of mid is written
    uint64_t mid_in;     // the partner's half of mid has arrived
    uint64_t peer_read;  // this CTA's half of mid has reached the partner
};
static_assert(sizeof(Barriers) <= kBarBytes, "barriers fit their slot");

// The seven per-channel f32 rows of one block.
struct Rows {
    const float* d1;    // (C/2)
    const float* b1;    // (C/2)
    const float* vm1;   // (C/2)
    const float* d2;    // (C)
    const float* b2;    // (C)
    const float* vout;  // (C)
    const float* rres;  // (C)
};

// kAct 0 = leaky_relu(0.1), 1 = mish
template <int kAct>
__device__ __forceinline__ float activate(float v) {
    if (kAct == 0) return fmaxf(v, __fmul_rn(v, 0.1f));  // the slope is below 1
    return __fmul_rn(v, tanhf(log1pf(expf(v))));
}

// The epilogues are bound by the SM's conversion rate (a quarter of its f32
// rate), so only the i32 sums go through a conversion instruction.
//
// clip(rint(v), -127, 127) as the low byte of the result. The bounds are
// integers, so clipping first gives the same code; adding 1.5 * 2^23 then
// rounds to the nearest integer, ties to even like rintf, into the low
// mantissa bits.
__device__ __forceinline__ uint32_t requant_bits(float v) {
    return __float_as_uint(__fadd_rn(fminf(fmaxf(v, -127.f), 127.f), 12582912.f));
}

// The codes of two values as two s8 in 16 bits.
__device__ __forceinline__ uint16_t requant2(float v0, float v1) {
    return static_cast<uint16_t>(__byte_perm(requant_bits(v0), requant_bits(v1), 0x0040));
}

// float(s8), exactly, of byte `kByte` of a word whose bytes are s8 codes
// XOR 0x80 (the codes + 128): the byte becomes the low mantissa bits of
// 2^23 + code + 128.
template <int kByte>
__device__ __forceinline__ float biased_s8_to_float(uint32_t biased) {
    return __fadd_rn(__uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 + kByte)),
                     -8388736.f);
}

// The two consumer warpgroups only (barrier 0 is __syncthreads).
__device__ __forceinline__ void consumers_sync() { named_sync<kConsumers>(); }

// ---- wgmma, s8 x s8 -> s32 ---------------------------------------------------
// Both operands K-major in shared memory; the integer form takes only the
// scale-d predicate after the descriptors. One instruction is 32 of K.

#define R8(i)                                                                       \
    "+r"(d[i + 0]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), \
        "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define ACC32 R8(0), R8(8), R8(16), R8(24)
#define ACC64 ACC32, R8(32), R8(40), R8(48), R8(56)
#define REGS32                                    \
    "{%0, %1, %2, %3, %4, %5, %6, %7, "           \
    "%8, %9, %10, %11, %12, %13, %14, %15, "      \
    "%16, %17, %18, %19, %20, %21, %22, %23, "    \
    "%24, %25, %26, %27, %28, %29, %30, %31}"
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

// d[64x64] += A[64x32] (shared, descriptor da) @ B[32x64] (shared, db)
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " REGS32
        ", %32, %33, p;\n}\n"
        : ACC32
        : "l"(da), "l"(db), "r"(1));
}

// d[64x256] += A[64x32] (shared, da) @ B[32x256] (shared, db)
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " REGS128
        ", %128, %129, p;\n}\n"
        : ACC64, R8(64), R8(72), R8(80), R8(88), R8(96), R8(104), R8(112), R8(120)
        : "l"(da), "l"(db), "r"(1));
}

#undef REGS128
#undef REGS32
#undef ACC64
#undef ACC32
#undef R8

// Byte offset of (row, channel < 128) in a box of 128-byte s8 rows that TMA
// wrote with the 128-byte swizzle (1024-aligned base).
__device__ __forceinline__ int sw128_offset(int row, int c) {
    return row * 128 + (((c >> 4) ^ row) & 7) * 16 + (c & 15);
}

// ---- phase stamps (off unless built with -DRESBLOCK_PHASES) ---------------

// tools/resblock_phases.py builds this file with RESBLOCK_PHASES defined:
// consumer thread 0 of every CTA then records the SM clock at each phase
// boundary (and the global timer at the first and last) for the tool to read.
constexpr int kPhases = 10;  // start, first x chunk in, x tile in, 1x1 done, own half
                             // of mid zeroed, own half written, 3x3 done (partner's
                             // half waited for at its middle), residual in, output
                             // computed, output stored
constexpr int kMaxStampedCtas = 1 << 14;
#ifdef RESBLOCK_PHASES
__device__ long long g_stamps[kMaxStampedCtas][kPhases + 2];
__device__ __forceinline__ void phase(int i) {
    if (threadIdx.x != 0) return;
    const int cta = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
    if (cta >= kMaxStampedCtas) return;
    g_stamps[cta][i] = clock64();
    if (i == 0 || i == kPhases - 1) {
        long long t;
        asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
        g_stamps[cta][kPhases + (i != 0)] = t;
    }
}
#else
__device__ __forceinline__ void phase(int) {}
#endif

// ---- the kernel ----------------------------------------------------------

// K stage k of the 3x3 reads block cb of mid at tap t (W2 column
// t * kCh + cb * 128). A CTA takes its own block (over all taps) first, and
// the partner's once it has arrived.
struct Step3 {
    int cb, tap;
    __device__ Step3(int k, uint32_t rank) {
        cb = k < kTaps ? rank : rank ^ 1;
        tap = k % kTaps;
    }
};

// The two consumer warpgroups: the 1x1 into mid, then the 3x3 and the
// output epilogue.
template <int kAct>
__device__ __forceinline__ void consume(const Layout& L, unsigned char* base, Barriers& bars,
                                        const float4* rows1, const float4* rows2,
                                        const CUtensorMap* tm_out, int H, int W, int y0, int nh,
                                        int img, uint32_t rank) {
    const int wp = W + 2;
    const int tid = threadIdx.x;
    const int wg = tid >> 7;           // consumer warpgroup
    const int warp = (tid >> 5) & 3;   // warp in the warpgroup: 16 rows each
    const int lane = tid & 31;
    const int r16 = warp * 16 + (lane >> 2);  // accumulator rows r16, r16 + 8 of a 64-row block
    auto release = [&](uint64_t* bar) {
        __syncwarp();
        if (lane == 0) mbar_arrive(bar);
    };

    // 1. mid = requant(act(x @ W1 * d1 + b1) * vm1) for the th + 2 input rows
    // (3 blocks of 64) and this warpgroup's 64 of the CTA's 128 channels. x
    // rows outside the image give discarded results.
    {
        int acc[kRowBlocks][32];
#pragma unroll
        for (int m = 0; m < kRowBlocks; ++m)
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[m][i] = 0;
        for (int k = 0; k < kK1; ++k) {
            mbar_wait(&bars.x_full[k], 0);
            if (k == 0) phase(1);
            if (k == kK1 - 1) phase(2);
            const unsigned char* xa = base + k * L.xchunk;
            const uint64_t db = sw128_desc(base + L.w1_off + k * kW1Tile + wg * (kW1Tile / 2));
#pragma unroll
            for (int m = 0; m < kRowBlocks; ++m) pin(acc[m]);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kKc / 32; ++kk)
#pragma unroll
                for (int m = 0; m < kRowBlocks; ++m)
                    wgmma_s8_n64(acc[m], sw128_desc(xa + m * 64 * 128) + 2 * kk, db + 2 * kk);
            wgmma_commit();
        }
        wgmma_wait<0>();
#pragma unroll
        for (int m = 0; m < kRowBlocks; ++m) pin(acc[m]);
        phase(3);
        release(&bars.x_done);  // the producer may now overwrite x and W1
        consumers_sync();       // no warp reads x any more ...
        cluster_arrive();       // ... so the partner may copy its half of mid over it
        // This CTA's half of mid is block `rank`: zeroed, then written where
        // the image is.
        unsigned char* own = base + rank * L.mid_block;
        for (int i = tid; i < L.mid_block / 16; i += kConsumers)
            reinterpret_cast<uint4*>(own)[i] = make_uint4(0u, 0u, 0u, 0u);
        consumers_sync();
        phase(4);
        int mrow[kRowBlocks][2];  // mid row of each accumulator row, -1 where mid stays 0
#pragma unroll
        for (int m = 0; m < kRowBlocks; ++m) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int p = m * 64 + r16 + 8 * h;
                const int row = p / W;
                const int y = y0 - 1 + row;
                mrow[m][h] =
                    p < L.n1 && y >= 0 && y < H ? 2 + row * wp + (p - row * W) : -1;
            }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int cl = wg * 64 + 8 * j + 2 * (lane & 3);  // of the CTA's 128
            const float4 e0 = rows1[cl], e1 = rows1[cl + 1];
#pragma unroll
            for (int m = 0; m < kRowBlocks; ++m) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    if (mrow[m][h] < 0) continue;
                    const int i = 4 * j + 2 * h;
                    const float v0 = __fmul_rn(
                        activate<kAct>(
                            __fadd_rn(__fmul_rn(static_cast<float>(acc[m][i]), e0.x), e0.y)),
                        e0.z);
                    const float v1 = __fmul_rn(
                        activate<kAct>(
                            __fadd_rn(__fmul_rn(static_cast<float>(acc[m][i + 1]), e1.x), e1.y)),
                        e1.z);
                    *reinterpret_cast<uint16_t*>(own + sw128_offset(mrow[m][h], cl)) =
                        requant2(v0, v1);
                }
            }
        }
        // written through the generic proxy, read by wgmma and by the bulk
        // copy to the partner (the async proxy)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        consumers_sync();
        if (tid == 0) mbar_arrive(&bars.mid_own);
    }
    phase(5);

    // 2. the 3x3 as 18 K stages (Step3); the output row q of the tile reads
    // mid row 1 + wp + q + shift(tap).
    const unsigned char* mid = base;
    int it = 0;
    auto wait_full = [&]() {
        const int s = it % kW2Stages;
        mbar_wait(&bars.w2_full[s], (it / kW2Stages) & 1);
        return base + L.slot_off(s);
    };
    int acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;
    // One commit group per stage (four m64n256k32), one group kept in flight.
    for (int k = 0; k < kK3; ++k, ++it) {
        if (k == kTaps) {  // the partner's half of mid from here on
            mbar_wait(&bars.mid_in, 0);
            if (tid == 0) mbar_arrive_remote(cluster_addr(&bars.peer_read, rank ^ 1));
        }
        const unsigned char* st = wait_full();
        const Step3 step(k, rank);
        const int row = 1 + wp + wg * 64 + (step.tap / 3 - 1) * wp + (step.tap % 3 - 1);
        const uint64_t da = sw128_desc(mid + step.cb * L.mid_block + row * 128);
        const uint64_t db = sw128_desc(st);
        pin(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKc / 32; ++kk) wgmma_s8_n256(acc, da + 2 * kk, db + 2 * kk);
        wgmma_commit();
        wgmma_wait<1>();
        pin(acc);
        // the previous stage's group is done: its tile is free
        if (k > 0) release(&bars.w2_empty[(it - 1) % kW2Stages]);
    }
    wgmma_wait<0>();
    pin(acc);
    phase(6);

    // 3. out = requant(act(acc * d2 + b2) * vout + x * rres). The residual
    // tile (two 128-channel boxes) is in the ring slot of step kK3; the codes
    // replace it there and go out by TMA.
    unsigned char* res = wait_full();
    phase(7);
    int brow[2];  // rows of the residual box, -1 where the result is discarded
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int q = wg * 64 + r16 + 8 * h;
        const int ty = q / wp;
        const int xc = q - ty * wp - 1;
        brow[h] = ty < L.th && xc >= 0 && xc < W ? ty * W + xc : -1;
    }
    // four column pairs at a time, their loads ahead of their stores
#pragma unroll
    for (int jb = 0; jb < 32; jb += 4) {
        float4 e[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c) e[j][c] = rows2[8 * (jb + j) + 2 * (lane & 3) + c];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            if (brow[h] < 0) continue;
            uint16_t* p[4];
            uint32_t xv[4];  // two residual codes, each + 128
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int col = 8 * (jb + j) + 2 * (lane & 3);
                p[j] = reinterpret_cast<uint16_t*>(res + (col >> 7) * L.res_stride +
                                                   sw128_offset(brow[h], col & 127));
                xv[j] = *p[j] ^ 0x8080u;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int i = 4 * (jb + j) + 2 * h;  // accumulator pair
                const float v0 = activate<kAct>(
                    __fadd_rn(__fmul_rn(static_cast<float>(acc[i]), e[j][0].x), e[j][0].y));
                const float v1 = activate<kAct>(
                    __fadd_rn(__fmul_rn(static_cast<float>(acc[i + 1]), e[j][1].x), e[j][1].y));
                *p[j] = requant2(
                    __fadd_rn(__fmul_rn(v0, e[j][0].z),
                              __fmul_rn(biased_s8_to_float<0>(xv[j]), e[j][0].w)),
                    __fadd_rn(__fmul_rn(v1, e[j][1].z),
                              __fmul_rn(biased_s8_to_float<1>(xv[j]), e[j][1].w)));
            }
        }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to TMA
    consumers_sync();
    phase(8);
    if (tid == 0) {
#pragma unroll
        for (int g = 0; g < 2; ++g)
            tma_store_4d(tm_out, res + g * L.res_stride, nh * kNOut + g * 128, y0, img);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        // shared memory must stay until the stores have read it
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        // and until the partner holds this CTA's half of mid
        mbar_wait(&bars.peer_read, 0);
    }
    phase(9);
}

// The producer warp. Lane 0 issues the weight and residual copies in the
// order the consumers take them; lane 1 sends this CTA's half of mid to the
// partner once it is written and the partner is past its x tile (the
// cluster barrier).
__device__ __forceinline__ void produce(const Layout& L, unsigned char* base, Barriers& bars,
                                        const CUtensorMap* tm_w2, const CUtensorMap* tm_res,
                                        int y0, int nh, int img, uint32_t rank) {
    const int lane = threadIdx.x & 31;
    auto load_w2 = [&](int k) {
        const int s = k % kW2Stages;
        mbar_wait(&bars.w2_empty[s], empty_parity(k, kW2Stages));
        mbar_expect_tx(&bars.w2_full[s], kW2Tile);
        const Step3 step(k, rank);
        tma_load(base + L.slot_off(s), tm_w2, step.tap * kCh + step.cb * kKc, nh * kNOut,
                 &bars.w2_full[s]);
    };
    if (lane == 0) {
        // the slots past the x tile and W1 at once, the others once no
        // consumer reads x or W1 any more
        for (int k = 0; k < L.w2_early; ++k) load_w2(k);
        mbar_wait(&bars.x_done, 0);
        for (int k = L.w2_early; k < kW2Stages; ++k) load_w2(k);
    }
    __syncwarp();
    cluster_arrive();
    cluster_wait();  // the partner's x tile, under its mid, is no longer read
    if (lane == 0) {
        for (int k = kW2Stages; k < kK3; ++k) load_w2(k);
        // the residual x for the epilogue, into the next slot to free up
        const int s = kK3 % kW2Stages;
        mbar_wait(&bars.w2_empty[s], empty_parity(kK3, kW2Stages));
        mbar_expect_tx(&bars.w2_full[s], 2 * L.res_bytes);
        for (int g = 0; g < 2; ++g)
            tma_load_4d(base + L.slot_off(s) + g * L.res_stride, tm_res, nh * kNOut + g * 128, y0,
                        img, &bars.w2_full[s]);
    } else if (lane == 1) {
        mbar_wait(&bars.mid_own, 0);
        unsigned char* own = base + rank * L.mid_block;
        copy_to_peer(cluster_addr(own, rank ^ 1), own, L.mid_block,
                     cluster_addr(&bars.mid_in, rank ^ 1));
    }
}

// Grid (row tiles, C / kNOut, batch); clusters of the kPair CTAs of a tile
// along y.
template <int kAct>
__global__ void __launch_bounds__(kThreads, 1)
resblock_int8_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                           const __grid_constant__ CUtensorMap tm_w1,
                           const __grid_constant__ CUtensorMap tm_w2,
                           const __grid_constant__ CUtensorMap tm_res,
                           const __grid_constant__ CUtensorMap tm_out, const Rows rows, int H,
                           int W) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* base = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
    const Layout L(W);
    Barriers& bars = *reinterpret_cast<Barriers*>(base + L.bar_off);
    float4* rows1 = reinterpret_cast<float4*>(base + L.bar_off + kBarBytes);
    float4* rows2 = rows1 + 128;
    const int y0 = blockIdx.x * L.th;
    const int nh = blockIdx.y;
    const int img = blockIdx.z;
    const uint32_t rank = cluster_rank();

    if (threadIdx.x == kConsumers) {  // the producer's lane 0
        for (int k = 0; k < kK1; ++k) mbar_init(&bars.x_full[k], 1);
        for (int s = 0; s < kW2Stages; ++s) {
            mbar_init(&bars.w2_full[s], 1);
            mbar_init(&bars.w2_empty[s], kConsumers / 32);
        }
        mbar_init(&bars.x_done, kConsumers / 32);
        mbar_init(&bars.mid_own, 1);
        mbar_init(&bars.mid_in, 1);
        mbar_init(&bars.peer_read, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        // The first copies wait on nothing: the whole x tile of the 1x1 (rows
        // y0-1 .. y0+th) and the CTA's half of W1, one barrier per K chunk.
        const int p0 = (img * H + y0 - 1) * W;
        for (int k = 0; k < kK1; ++k) {
            mbar_expect_tx(&bars.x_full[k], L.xchunk + kW1Tile);
            tma_load(base + k * L.xchunk, &tm_x, k * kKc, p0, &bars.x_full[k]);
            tma_load(base + L.w1_off + k * kW1Tile, &tm_w1, k * kKc, rank * 128, &bars.x_full[k]);
        }
    } else if (threadIdx.x < kConsumers) {
        // the epilogues read their rows from shared memory
        for (int i = threadIdx.x; i < 128 + kNOut; i += kConsumers) {
            if (i < 128) {
                const int c = rank * 128 + i;
                rows1[i] = make_float4(rows.d1[c], rows.b1[c], rows.vm1[c], 0.f);
            } else {
                const int c = nh * kNOut + i - 128;
                rows2[i - 128] = make_float4(rows.d2[c], rows.b2[c], rows.vout[c], rows.rres[c]);
            }
        }
    }
    __syncthreads();
    phase(0);
    // the partner's half of mid lands on mid_in: one arrival, its bytes
    if (threadIdx.x == 0) mbar_expect_tx(&bars.mid_in, L.mid_block);

    if (threadIdx.x >= kConsumers)
        produce(L, base, bars, &tm_w2, &tm_res, y0, nh, img, rank);
    else
        consume<kAct>(L, base, bars, rows1, rows2, &tm_out, H, W, y0, nh, img, rank);
}

// An s8 tensor map with boxes whose inner edge is 128 elements.
bool encode_s8(EncodeTiled fn, CUtensorMap* map, const void* ptr, int rank, const uint64_t* dims,
               const uint32_t* box) {
    return encode(fn, map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, ptr, rank, dims, box);
}

}  // namespace

// One quantized residual block over a (B, H, W, C) s8 NHWC batch; act 0 =
// leaky, 1 = mish. w1: (C/2, C) and w2: (C, 9*C/2) s8, K-major (row n holds
// output channel n's weights; w2's K index is tap * C/2 + input channel);
// d1, b1, vm1: (C/2) f32 rows; d2, b2, vout, rres: (C) f32 rows. x and out
// must not overlap; every pointer 16-byte aligned. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a geometry the kernel does
// not take, or cudaErrorNotSupported when libcuda's tensor-map encoder is
// unavailable.
extern "C" int resblock_int8_launch(const void* x, const void* w1, const void* d1,
                                    const void* b1, const void* vm1, const void* w2,
                                    const void* d2, const void* b2, const void* vout,
                                    const void* rres, void* out, int batch, int H,
                                    int W, int C, int act, void* stream) {
    if (C != kC || W < 1 || W > kMaxW || H < 1 || batch < 1 || batch > 65535 ||
        (act != 0 && act != 1))
        return cudaErrorInvalidValue;
    const Layout L(W);
    if (L.n1 > kRowBlocks * 64 || L.smem_bytes() > kSmemLimit) return cudaErrorInvalidValue;
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return cudaErrorNotSupported;
    CUtensorMap tm_x, tm_w1, tm_w2, tm_res, tm_out;
    const uint64_t x2d[2] = {kC, static_cast<uint64_t>(batch) * H * W};
    const uint32_t x2d_box[2] = {kKc, static_cast<uint32_t>(L.xchunk / 128)};
    const uint64_t w1_dims[2] = {kC, kCh};
    const uint32_t w1_box[2] = {kKc, 128};
    const uint64_t w2_dims[2] = {kTaps * kCh, kC};
    const uint32_t w2_box[2] = {kKc, kNOut};
    const uint64_t nhwc[4] = {kC, static_cast<uint64_t>(W), static_cast<uint64_t>(H),
                              static_cast<uint64_t>(batch)};
    const uint32_t tile_box[4] = {kKc, static_cast<uint32_t>(W), static_cast<uint32_t>(L.th), 1};
    if (!encode_s8(fn, &tm_x, x, 2, x2d, x2d_box) ||
        !encode_s8(fn, &tm_w1, w1, 2, w1_dims, w1_box) ||
        !encode_s8(fn, &tm_w2, w2, 2, w2_dims, w2_box) ||
        !encode_s8(fn, &tm_res, x, 4, nhwc, tile_box) ||
        !encode_s8(fn, &tm_out, out, 4, nhwc, tile_box))
        return cudaErrorInvalidValue;
    const int smem = L.smem_bytes();
    const auto kernel = act == 0 ? resblock_int8_wgmma_kernel<0> : resblock_int8_wgmma_kernel<1>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const Rows rows{static_cast<const float*>(d1), static_cast<const float*>(b1),
                    static_cast<const float*>(vm1), static_cast<const float*>(d2),
                    static_cast<const float*>(b2), static_cast<const float*>(vout),
                    static_cast<const float*>(rres)};
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((H + L.th - 1) / L.th, kPair, batch);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute cluster;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = 1;
    cluster.val.clusterDim.y = kPair;
    cluster.val.clusterDim.z = 1;
    cfg.attrs = &cluster;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, tm_x, tm_w1, tm_w2, tm_res, tm_out, rows, H, W);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

#ifdef RESBLOCK_PHASES
// Copies the stamps of the first `ctas` CTAs of the last launch to `host`
// ((kPhases + 2) int64 each: SM clocks, then global-timer start and end in ns).
extern "C" int resblock_int8_phases(void* host, int ctas) {
    if (ctas < 0 || ctas > kMaxStampedCtas) return cudaErrorInvalidValue;
    return static_cast<int>(
        cudaMemcpyFromSymbol(host, g_stamps, static_cast<size_t>(ctas) * (kPhases + 2) * 8));
}
#endif
