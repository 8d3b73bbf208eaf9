// Fused folded-inference Darknet residual block on Hopper (wgmma + TMA):
//     out = x + bf16(act(conv3x3(mid) + b2)),  mid = bf16(act(x @ W1 + b1))
// with f32 sums, mid rounded to bf16 and the residual added in bf16.
//
// Replaces the Pallas kernel yolo_for_turbines_tpu/ops/pallas/resblock_kernel.py
// (fused_residual_stage / _stage_kernel). The TPU kernel keeps whole images
// resident in VMEM over a chunk of blocks; a 26x26x512 bf16 image (692 KB)
// does not fit the 227 KB of shared memory a CTA can hold, so here one launch
// runs ONE block and a CTA owns a tile of positions x half the channels.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 700 W): compute. One block
// of one 26x26x512 image is 2*676*(512*256 + 2304*512) = 1.772 GFLOP, so the
// 8-block stage at B=128 is 1.815 TFLOP = 1.835 ms (0.115 ms at B=8); its
// bytes (x, out and the weights once, 32 MB at B=8) take 0.010 ms.
//
// Design, against the limits of the earlier mma.sync (WMMA) kernel, whose
// CTAs owned 2 output rows x all 512 channels:
//   1. Products on wgmma (f32 accumulators in registers), the only
//      instruction that reaches Hopper's tensor-core rate, with both operands
//      in shared memory. Two consumer warpgroups; one producer warp issues
//      every TMA copy.
//   2. A CTA owns kM = 128 positions of the zero-padded (W+2)-wide layout
//      (th = 128 / (W+2) output rows: 4 at 26x26, 112 positions used) and
//      kNOut = 256 of the 512 output channels: each warpgroup one
//      m64n256k16 accumulator. The grid is (row tiles, 2, B): 1792 CTAs at
//      B=128, 112 at B=8. Each CTA streams 1.2 MB of W2 for 4 rows, against
//      2.6 MB of W1 + W2 for 2 rows before.
//   3. The 1x1 (th + 2 input rows: the halo) is split between the two CTAs of
//      a tile, which form a cluster: each computes 128 of the 256 mid
//      channels, and one bulk copy through distributed shared memory sends
//      them to the partner. The CTA's whole x tile (up to 192 rows x 512
//      channels) is loaded by TMA at once, W1 streams through a ring beside
//      it, and each warpgroup computes 64 mid channels over 3 row blocks of
//      64. The 1x1 is 10% of a block's FLOPs; the halo rows and the padding
//      to 192 rows add about half of that again. Each CTA runs the 3x3 over
//      its own half of mid first, so the exchange overlaps 18 K stages.
//   4. No __syncthreads in the K loops: consumers wait on a stage's "full"
//      mbarrier and release it on its "empty" one. The 3x3's W2 tiles
//      (256 x 64, 128-byte swizzle) stream through a 3-stage ring that
//      reuses the x tile's memory once the 1x1 is done; one commit group of
//      four m64n256k16 per stage, one group in flight.
//   5. The 3x3 reads A straight from mid. In the padded layout a tap (u, v)
//      is a row shift of (u-1)*(W+2) + (v-1). mid is kept as four 64-channel
//      blocks of 128-byte rows with the 128-byte swizzle (the layout TMA
//      writes), and wgmma applies that swizzle on absolute shared-memory
//      address bits, so a descriptor may start at any row of a block: the
//      shift is just a start address (checked on the card against the plain
//      version at every geometry taken).
// Epilogues run from the accumulator registers, with the biases staged in
// shared memory. The 1x1's (+ b1, act, bf16) writes mid, leaving positions
// outside the image at exactly 0 (the conv's zero padding). For the 3x3's
// (+ b2, act, bf16, + x in bf16), the producer loads the residual x tile by
// TMA into the two ring stages that free up last, while the last K steps
// run; the output is written over it in place and stored by TMA, which clips
// rows past the image.
//
// x is read by TMA as a (B*H*W, C) matrix for the 1x1: rows above the first
// image and past the last one are zero-filled by the hardware, rows of a
// neighbouring image are computed and discarded, so the buffers need no
// padding. Outputs never alias inputs (neighbouring CTAs read each other's
// halo rows): the wrapper ping-pongs two buffers across a stage. The weights
// come K-major: W1 as (C/2, C) and W2 as (C, 9*C/2), each row one output
// channel.
//
// Geometry taken: C = 512, 1 <= W <= 32, any H (the 26x26x512 stage at
// 416px and the 320-512px inputs).
//
// What limits it (measured by tools/resblock_phases.py): the 3x3 loop
// runs near the tensor-core rate, but one CTA fills an SM, so its serial
// phases (the 1x1's loads and products, the exchange, the epilogue) are
// idle tensor time, about 40% of a CTA. Hiding them needs a second tile in
// flight per SM: a persistent kernel, or chained blocks.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kC = 512;               // channels the kernel takes
constexpr int kCh = kC / 2;           // mid channels
constexpr int kNOut = 256;            // output channels per CTA
constexpr int kM = 128;               // rows per CTA product: two warpgroups of 64
constexpr int kKc = 64;               // K per stage: one 128-byte swizzle row of bf16
constexpr int kConsumers = 256;       // two warpgroups
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr int kMaxW = 32;
constexpr int kK1 = kC / kKc;         // K stages of the 1x1
constexpr int kK3 = 9 * kCh / kKc;    // K stages of the 3x3
constexpr int kRowBlocks = 3;         // 64-row blocks of the 1x1: up to 192 positions
constexpr int kW1Tile = 128 * 128;    // a 128-channel x 64 W1 tile
constexpr int kMaxW1Stages = 4;
constexpr int kW2Stages = 3;
constexpr int kW2Tile = kNOut * 128;  // a 256-channel x 64 W2 tile
constexpr int kBarBytes = 256;
constexpr int kBiasBytes = (128 + kNOut) * 4;  // the CTA's b1 and b2 slices
constexpr int kTailBytes = kBarBytes + kBiasBytes;
// A cluster holds the kC / kNOut CTAs of one tile (its output-channel
// slices); each computes 128 of the 1x1's kCh channels into every CTA's mid.
constexpr int kPair = kC / kNOut;
static_assert(kPair == 2 && kCh / kPair == 128, "one 128-channel 1x1 slice per CTA of a pair");

// Shared-memory plan of one CTA for a width W; offsets from a 1024-aligned
// base. The 1x1 holds the x tile and the W1 ring; the 3x3 reuses that memory
// for mid and the W2 ring.
struct Layout {
    int th;        // output rows of a tile
    int n1;        // positions of the 1x1: th + 2 input rows
    int xchunk;    // bytes of one 64-channel K chunk of the x tile
    int w1_off, w1_stages;
    int mid_block;  // bytes of one 64-channel block of mid
    int w2_off;     // the W2 ring, past mid's four blocks
    int res_bytes, res_stride;  // one 64-channel residual box, and its slot
    int bar_off;  // then the barriers, then the biases
    __host__ __device__ explicit Layout(int W) {
        th = kM / (W + 2);
        n1 = (th + 2) * W;
        xchunk = round_up(n1, 8) * 128;
        w1_off = kK1 * xchunk;
        w1_stages = (kSmemLimit - 1024 - kTailBytes - w1_off) / kW1Tile;
        if (w1_stages > kMaxW1Stages) w1_stages = kMaxW1Stages;
        mid_block = round_up((kM + 2 * (W + 2) + 2) * 128, 1024);
        w2_off = kCh / 64 * mid_block;
        res_bytes = th * W * 128;
        res_stride = round_up(res_bytes, 1024);
        const int end1 = w1_off + w1_stages * kW1Tile;
        const int end2 = w2_off + kW2Stages * kW2Tile;
        bar_off = end1 > end2 ? end1 : end2;
    }
    __host__ __device__ int smem_bytes() const { return 1024 + bar_off + kTailBytes; }
};

struct Barriers {
    uint64_t x_full[kK1];
    uint64_t w1_full[kMaxW1Stages], w1_empty[kMaxW1Stages];
    uint64_t w2_full[kW2Stages], w2_empty[kW2Stages];
    uint64_t x_done;     // every consumer warp is past the 1x1's products
    uint64_t mid_own;    // this CTA's half of mid is written
    uint64_t mid_in;     // the partner's half of mid has arrived
    uint64_t peer_read;  // this CTA's half of mid has reached the partner
};
static_assert(sizeof(Barriers) <= kBarBytes, "barriers fit their slot");

// kAct 0 = leaky_relu(0.1), 1 = mish
template <int kAct>
__device__ __forceinline__ float activate(float v) {
    if (kAct == 0) return v > 0.f ? v : v * 0.1f;
    return v * tanhf(log1pf(expf(v)));
}

// The two consumer warpgroups only (barrier 0 is __syncthreads).
__device__ __forceinline__ void consumers_sync() { named_sync<kConsumers>(); }

// ---- wgmma ---------------------------------------------------------------

#define F8(i)                                                                       \
    "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
        "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ACC32 F8(0), F8(8), F8(16), F8(24)
#define ACC64 ACC32, F8(32), F8(40), F8(48), F8(56)
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

// d[64x64] += A[64x16] (shared, descriptor da) @ B[16x64] (shared, db)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : ACC32
        : "l"(da), "l"(db), "r"(1));
}

// d[64x256] += A[64x16] (shared, da) @ B[16x256] (shared, db)
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " REGS128
        ", %128, %129, p, 1, 1, 0, 0;\n}\n"
        : ACC64, F8(64), F8(72), F8(80), F8(88), F8(96), F8(104), F8(112), F8(120)
        : "l"(da), "l"(db), "r"(1));
}

#undef REGS128
#undef REGS32
#undef ACC64
#undef ACC32
#undef F8

// Byte offset of (row, channel < 64) in a box of 128-byte rows that TMA
// wrote with the 128-byte swizzle (1024-aligned base).
__device__ __forceinline__ int sw128_offset(int row, int c) {
    return row * 128 + (((c >> 3) ^ row) & 7) * 16 + (c & 7) * 2;
}

// mid holds its 256 channels as four 64-channel blocks of 128-byte rows in
// that same layout, so any row of it can start a wgmma A operand.
__device__ __forceinline__ int mid_offset(const Layout& L, int row, int c) {
    return (c >> 6) * L.mid_block + sw128_offset(row, c & 63);
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

// Accumulator element i of a 64xN wgmma tile lives at row
// 16 * warp + lane / 4 + 8 * ((i >> 1) & 1), column 8 * (i >> 2) + 2 * (lane & 3) + (i & 1).

// ---- the kernel ----------------------------------------------------------

// K stage k of the 3x3 reads mid channel block cb at tap t (W2 column
// t * kCh + cb * 64). A CTA takes the two blocks of its own half of mid
// (over all taps) first, and the partner's half once it has arrived.
struct Step3 {
    int cb, tap;
    __device__ Step3(int k, uint32_t rank) {
        const int kh = k % (kK3 / 2);
        cb = 2 * (k < kK3 / 2 ? rank : rank ^ 1) + (kh & 1);
        tap = kh >> 1;
    }
};

// The two consumer warpgroups: the 1x1 into mid, then the 3x3 and the
// output epilogue.
template <int kAct>
__device__ __forceinline__ void consume(const Layout& L, unsigned char* base, Barriers& bars,
                                        const float* bias1, const float* bias2,
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

    // 1. mid = bf16(act(x @ W1 + b1)) for the th + 2 input rows (3 blocks of
    // 64) and this warpgroup's 64 of the CTA's 128 channels. x rows outside
    // the image give discarded results.
    {
        float acc[kRowBlocks][32];
#pragma unroll
        for (int m = 0; m < kRowBlocks; ++m)
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[m][i] = 0.f;
        for (int k = 0; k < kK1; ++k) {
            const int s = k % L.w1_stages;
            mbar_wait(&bars.x_full[k], 0);
            if (k == 0) phase(1);
            if (k == kK1 - 1) phase(2);
            mbar_wait(&bars.w1_full[s], (k / L.w1_stages) & 1);
            const unsigned char* xa = base + k * L.xchunk;
            const uint64_t db = sw128_desc(base + L.w1_off + s * kW1Tile + wg * (kW1Tile / 2));
#pragma unroll
            for (int m = 0; m < kRowBlocks; ++m) pin(acc[m]);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kKc / 16; ++kk)
#pragma unroll
                for (int m = 0; m < kRowBlocks; ++m)
                    wgmma_ss_n64(acc[m], sw128_desc(xa + m * 64 * 128) + 2 * kk, db + 2 * kk);
            wgmma_commit();
            wgmma_wait<1>();  // the previous step's group is done: free its W1 slot
#pragma unroll
            for (int m = 0; m < kRowBlocks; ++m) pin(acc[m]);
            if (k > 0) release(&bars.w1_empty[(k - 1) % L.w1_stages]);
        }
        wgmma_wait<0>();
#pragma unroll
        for (int m = 0; m < kRowBlocks; ++m) pin(acc[m]);
        phase(3);
        release(&bars.x_done);  // the producer may now overwrite x and W1
        consumers_sync();       // no warp reads x any more ...
        cluster_arrive();       // ... so the partner may copy its half of mid over it
        // This CTA's half of mid is its 128 channels: blocks 2 * rank and
        // 2 * rank + 1, zeroed, then written where the image is.
        unsigned char* own = base + 2 * rank * L.mid_block;
        for (int i = tid; i < 2 * L.mid_block / 16; i += kConsumers)
            reinterpret_cast<uint4*>(own)[i] = make_uint4(0u, 0u, 0u, 0u);
        consumers_sync();
        phase(4);
#pragma unroll
        for (int m = 0; m < kRowBlocks; ++m) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int p = m * 64 + r16 + 8 * h;
                const int row = p / W;
                const int y = y0 - 1 + row;
                if (p >= L.n1 || y < 0 || y >= H) continue;  // mid stays 0 there
                const int mrow = 2 + row * wp + (p - row * W);
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const int i = 4 * j + 2 * h;
                    const int cl = wg * 64 + 8 * j + 2 * (lane & 3);  // of the CTA's 128
                    const float2 bias = *reinterpret_cast<const float2*>(bias1 + cl);
                    *reinterpret_cast<__nv_bfloat162*>(base + mid_offset(L, mrow, rank * 128 + cl)) =
                        __floats2bfloat162_rn(activate<kAct>(acc[m][i] + bias.x),
                                              activate<kAct>(acc[m][i + 1] + bias.y));
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

    // 2. the 3x3 as 36 K stages (Step3); the output row q of the tile reads
    // mid row 1 + wp + q + shift(tap).
    const unsigned char* mid = base;
    unsigned char* ring = base + L.w2_off;
    int it = 0;
    auto wait_full = [&]() {
        const int s = it % kW2Stages;
        mbar_wait(&bars.w2_full[s], (it / kW2Stages) & 1);
        return ring + s * kW2Tile;
    };
    // acc[64 * hf + i] is element i of the 64x128 tile of output channels
    // hf * 128 .. of this CTA's 256
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    // One commit group per stage (four m64n256k16), one group kept in flight.
    for (int k = 0; k < kK3; ++k, ++it) {
        if (k == kK3 / 2) {  // the partner's half of mid from here on
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
        for (int kk = 0; kk < kKc / 16; ++kk) wgmma_ss_n256(acc, da + 2 * kk, db + 2 * kk);
        wgmma_commit();
        wgmma_wait<1>();
        pin(acc);
        // the previous stage's group is done: its tile is free
        if (k > 0) release(&bars.w2_empty[(it - 1) % kW2Stages]);
    }
    wgmma_wait<0>();
    pin(acc);
    phase(6);

    // 3. out = x + bf16(act(acc + b2)), in bf16. The residual tile of output
    // channels hf * 128 .. (two 64-channel boxes) is in the ring stage of
    // step kK3 + hf; the result replaces it there and goes out by TMA.
    unsigned char* res[2];
    res[0] = wait_full();
    ++it;
    res[1] = wait_full();
    phase(7);
    int brow[2];  // rows of the residual box, -1 where the result is discarded
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int q = wg * 64 + r16 + 8 * h;
        const int ty = q / wp;
        const int xc = q - ty * wp - 1;
        brow[h] = ty < L.th && xc >= 0 && xc < W ? ty * W + xc : -1;
    }
    // eight column pairs at a time, their loads ahead of their stores
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
        for (int jb = 0; jb < 16; jb += 8) {
            float2 bias[8];
#pragma unroll
            for (int j = 0; j < 8; ++j)
                bias[j] = *reinterpret_cast<const float2*>(bias2 + hf * 128 + 8 * (jb + j) +
                                                           2 * (lane & 3));
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                if (brow[h] < 0) continue;
                __nv_bfloat162* p[8];
                __nv_bfloat162 xv[8];
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const int col = 8 * (jb + j) + 2 * (lane & 3);
                    p[j] = reinterpret_cast<__nv_bfloat162*>(
                        res[hf] + (col >> 6) * L.res_stride + sw128_offset(brow[h], col & 63));
                    xv[j] = *p[j];
                }
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const int i = 64 * hf + 4 * (jb + j) + 2 * h;  // accumulator pair
                    const __nv_bfloat162 yb =
                        __floats2bfloat162_rn(activate<kAct>(acc[i] + bias[j].x),
                                              activate<kAct>(acc[i + 1] + bias[j].y));
                    *p[j] = __floats2bfloat162_rn(__bfloat162float(xv[j].x) + __bfloat162float(yb.x),
                                                  __bfloat162float(xv[j].y) + __bfloat162float(yb.y));
                }
            }
        }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to TMA
    consumers_sync();
    phase(8);
    if (tid == 0) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
            for (int g = 0; g < 2; ++g)
                tma_store_4d(tm_out, res[hf] + g * L.res_stride, nh * kNOut + hf * 128 + g * 64,
                             y0, img);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        // shared memory must stay until the stores have read it
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        // and until the partner holds this CTA's half of mid
        mbar_wait(&bars.peer_read, 0);
    }
    phase(9);
}

// The first copies of a CTA, which wait on nothing: the whole x tile of the
// 1x1 (rows y0-1 .. y0+th), one barrier per K chunk, with the first W1 tiles
// between its chunks.
__device__ __forceinline__ void issue_first_tiles(const Layout& L, unsigned char* base,
                                                  Barriers& bars, const CUtensorMap* tm_x,
                                                  const CUtensorMap* tm_w1, int H, int W, int y0,
                                                  int img, uint32_t rank) {
    const int p0 = (img * H + y0 - 1) * W;
    for (int k = 0; k < kK1; ++k) {
        mbar_expect_tx(&bars.x_full[k], L.xchunk);
        tma_load(base + k * L.xchunk, tm_x, k * kKc, p0, &bars.x_full[k]);
        if (k < L.w1_stages) {
            mbar_expect_tx(&bars.w1_full[k], kW1Tile);
            tma_load(base + L.w1_off + k * kW1Tile, tm_w1, k * kKc, rank * 128, &bars.w1_full[k]);
        }
    }
}

// The producer warp. Lane 0 issues the weight and residual copies in the
// order the consumers take them; lane 1 sends this CTA's half of mid to the
// partner once it is written and the partner is past its x tile (the
// cluster barrier).
__device__ __forceinline__ void produce(const Layout& L, unsigned char* base, Barriers& bars,
                                        const CUtensorMap* tm_w1, const CUtensorMap* tm_w2,
                                        const CUtensorMap* tm_res, int y0, int nh, int img,
                                        uint32_t rank) {
    const int lane = threadIdx.x & 31;
    unsigned char* ring = base + L.w2_off;
    auto load_w2 = [&](int k) {
        const int s = k % kW2Stages;
        mbar_wait(&bars.w2_empty[s], empty_parity(k, kW2Stages));
        mbar_expect_tx(&bars.w2_full[s], kW2Tile);
        const Step3 step(k, rank);
        tma_load(ring + s * kW2Tile, tm_w2, step.tap * kCh + step.cb * kKc, nh * kNOut,
                 &bars.w2_full[s]);
    };
    if (lane == 0) {
        // the rest of W1 (issue_first_tiles sent the x tile and the first
        // W1 tiles)
        for (int k = L.w1_stages; k < kK1; ++k) {
            const int s = k % L.w1_stages;
            mbar_wait(&bars.w1_empty[s], empty_parity(k, L.w1_stages));
            mbar_expect_tx(&bars.w1_full[s], kW1Tile);
            tma_load(base + L.w1_off + s * kW1Tile, tm_w1, k * kKc, rank * 128, &bars.w1_full[s]);
        }
        // W2, once no consumer reads x or W1 any more
        mbar_wait(&bars.x_done, 0);
        for (int k = 0; k < kW2Stages; ++k) load_w2(k);
    }
    __syncwarp();
    cluster_arrive();
    cluster_wait();  // the partner's x tile, under its mid, is no longer read
    if (lane == 0) {
        for (int k = kW2Stages; k < kK3; ++k) load_w2(k);
        // the residual x for the epilogue, into the two slots freed last
        for (int hf = 0; hf < 2; ++hf) {
            const int k = kK3 + hf;
            const int s = k % kW2Stages;
            mbar_wait(&bars.w2_empty[s], empty_parity(k, kW2Stages));
            mbar_expect_tx(&bars.w2_full[s], 2 * L.res_bytes);
            for (int g = 0; g < 2; ++g)
                tma_load_4d(ring + s * kW2Tile + g * L.res_stride, tm_res,
                            nh * kNOut + hf * 128 + g * 64, y0, img, &bars.w2_full[s]);
        }
    } else if (lane == 1) {
        mbar_wait(&bars.mid_own, 0);
        unsigned char* own = base + 2 * rank * L.mid_block;
        copy_to_peer(cluster_addr(own, rank ^ 1), own, 2 * L.mid_block,
                     cluster_addr(&bars.mid_in, rank ^ 1));
    }
}

// Grid (row tiles, C / kNOut, batch); clusters of the kPair CTAs of a tile
// along y.
template <int kAct>
__global__ void __launch_bounds__(kThreads, 1)
resblock_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_w1,
                      const __grid_constant__ CUtensorMap tm_w2,
                      const __grid_constant__ CUtensorMap tm_res,
                      const __grid_constant__ CUtensorMap tm_out,
                      const float* __restrict__ b1, const float* __restrict__ b2,
                      int H, int W) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* base = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
    const Layout L(W);
    Barriers& bars = *reinterpret_cast<Barriers*>(base + L.bar_off);
    float* bias1 = reinterpret_cast<float*>(base + L.bar_off + kBarBytes);
    float* bias2 = bias1 + 128;
    const int y0 = blockIdx.x * L.th;
    const int nh = blockIdx.y;
    const int img = blockIdx.z;
    const uint32_t rank = cluster_rank();

    if (threadIdx.x == kConsumers) {  // the producer's lane 0
        for (int k = 0; k < kK1; ++k) mbar_init(&bars.x_full[k], 1);
        for (int s = 0; s < kMaxW1Stages; ++s) {
            mbar_init(&bars.w1_full[s], 1);
            mbar_init(&bars.w1_empty[s], kConsumers / 32);
        }
        for (int s = 0; s < kW2Stages; ++s) {
            mbar_init(&bars.w2_full[s], 1);
            mbar_init(&bars.w2_empty[s], kConsumers / 32);
        }
        mbar_init(&bars.x_done, kConsumers / 32);
        mbar_init(&bars.mid_own, 1);
        mbar_init(&bars.mid_in, 1);
        mbar_init(&bars.peer_read, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        issue_first_tiles(L, base, bars, &tm_x, &tm_w1, H, W, y0, img, rank);
    } else if (threadIdx.x < kConsumers) {
        // the epilogues read the biases from shared memory
        for (int i = threadIdx.x; i < 128 + kNOut; i += kConsumers)
            bias1[i] = i < 128 ? b1[rank * 128 + i] : b2[nh * kNOut + i - 128];
    }
    __syncthreads();
    phase(0);
    // the partner's half of mid lands on mid_in: one arrival, its bytes
    if (threadIdx.x == 0) mbar_expect_tx(&bars.mid_in, 2 * L.mid_block);

    if (threadIdx.x >= kConsumers)
        produce(L, base, bars, &tm_w1, &tm_w2, &tm_res, y0, nh, img, rank);
    else
        consume<kAct>(L, base, bars, bias1, bias2, &tm_out, H, W, y0, nh, img, rank);
}

// ---- host side -------------------------------------------------------------

// A bf16 tensor map with boxes whose inner edge is 64 elements.
bool encode_bf16(EncodeTiled fn, CUtensorMap* map, const void* ptr, int rank,
                 const uint64_t* dims, const uint32_t* box) {
    return encode(fn, map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, sizeof(bf16), ptr, rank, dims,
                  box);
}

}  // namespace

// One residual block over a (B, H, W, C) bf16 NHWC batch; act 0 = leaky,
// 1 = mish. w1: (C/2, C) and w2: (C, 9*C/2) bf16, K-major (row n holds output
// channel n's weights; w2's K index is tap * C/2 + input channel); b1: (C/2)
// and b2: (C) f32. x and out must not overlap; every pointer 16-byte aligned.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a geometry the
// kernel does not take, or cudaErrorNotSupported when the driver's tensor-map
// encoder is unavailable.
extern "C" int resblock_launch(const void* x, const void* w1, const void* b1, const void* w2,
                               const void* b2, void* out, int batch, int H, int W, int C,
                               int act, void* stream) {
    if (C != kC || W < 1 || W > kMaxW || H < 1 || batch < 1 || batch > 65535 ||
        (act != 0 && act != 1))
        return cudaErrorInvalidValue;
    const Layout L(W);
    if (L.w1_stages < 2 || L.smem_bytes() > kSmemLimit) return cudaErrorInvalidValue;
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return cudaErrorNotSupported;
    CUtensorMap tm_x, tm_w1, tm_w2, tm_res, tm_out;
    const uint64_t x2d[2] = {kC, static_cast<uint64_t>(batch) * H * W};
    const uint32_t x2d_box[2] = {kKc, static_cast<uint32_t>(L.xchunk / 128)};
    const uint64_t w1_dims[2] = {kC, kCh};
    const uint32_t w1_box[2] = {kKc, 128};
    const uint64_t w2_dims[2] = {9 * kCh, kC};
    const uint32_t w2_box[2] = {kKc, kNOut};
    const uint64_t nhwc[4] = {kC, static_cast<uint64_t>(W), static_cast<uint64_t>(H),
                              static_cast<uint64_t>(batch)};
    const uint32_t tile_box[4] = {kKc, static_cast<uint32_t>(W), static_cast<uint32_t>(L.th), 1};
    if (!encode_bf16(fn, &tm_x, x, 2, x2d, x2d_box) ||
        !encode_bf16(fn, &tm_w1, w1, 2, w1_dims, w1_box) ||
        !encode_bf16(fn, &tm_w2, w2, 2, w2_dims, w2_box) ||
        !encode_bf16(fn, &tm_res, x, 4, nhwc, tile_box) ||
        !encode_bf16(fn, &tm_out, out, 4, nhwc, tile_box))
        return cudaErrorInvalidValue;
    const int smem = L.smem_bytes();
    const auto kernel = act == 0 ? resblock_wgmma_kernel<0> : resblock_wgmma_kernel<1>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
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
    err = cudaLaunchKernelEx(&cfg, kernel, tm_x, tm_w1, tm_w2, tm_res, tm_out,
                             static_cast<const float*>(b1), static_cast<const float*>(b2), H, W);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

#ifdef RESBLOCK_PHASES
// Copies the stamps of the first `ctas` CTAs of the last launch to `host`
// ((kPhases + 2) int64 each: SM clocks, then global-timer start and end in ns).
extern "C" int resblock_phases(void* host, int ctas) {
    if (ctas < 0 || ctas > kMaxStampedCtas) return cudaErrorInvalidValue;
    return static_cast<int>(
        cudaMemcpyFromSymbol(host, g_stamps, static_cast<size_t>(ctas) * (kPhases + 2) * 8));
}
#endif
