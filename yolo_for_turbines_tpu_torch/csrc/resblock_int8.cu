// Fused int8 Darknet residual block (post-training-quantized serving path):
//     mid = clip(rint(act(x @ W1 * d1 + b1) * vm1))
//     y   = act(conv3x3(mid) * d2 + b2)
//     out = clip(rint(y * vout + x * rres), -127, 127)
// with s8 activations and weights, i32 accumulation and an f32 epilogue
// whose per-channel rows (d1 = s_in*sw1, vm1 = 1/s_mid, d2 = s_mid*sw2,
// vout = 1/s_out, rres = s_in/s_out) the wrapper folds from the calibrated
// scale chain.
//
// Replaces the Pallas kernel
// yolo_for_turbines_tpu/ops/pallas/resblock_int8_kernel.py
// (fused_residual_stage_int8 / _stage_kernel_i8) and follows its formula,
// not the XLA block loop's (which divides by the scales instead of
// multiplying by their reciprocals).
//
// Structure of the bf16 kernel (resblock.cu): one launch runs ONE block;
// each CTA owns TH output rows x W x all C output channels of one image:
//
//   1. mid = requant(act(x @ W1 * d1 + b1)) for input rows y0-1 .. y0+TH on
//      the s8 tensor cores (WMMA m16n16k16, i32 accumulation), stored as s8
//      in shared memory in a zero-padded (TH+2) x (W+2) x C/2 layout. The
//      halo rows are recomputed, not exchanged; x is read straight from
//      device memory, and the wrapper pads the activation buffers so the
//      rows above and below the image stay in bounds. Zero padding of the
//      s8 mid is exact: the XLA path pads its s8 t1 with 0 too;
//   2. a 3x3 tap (u, v) is a constant row shift of (u-1)*(W+2) + (v-1) in
//      the padded layout, so the conv is nine shifted (positions, C/2) @
//      (C/2, C) s8 products accumulated in i32;
//   3. epilogue: dequant, bias, act, residual add and requant in f32.
//
// Exactness: the output must equal the plain torch version
// (fused_residual_stage_int8_reference) for leaky_relu. The i32 sums are
// exact in any order; the f32 epilogue uses the _rn intrinsics, which the
// compiler never contracts into FMAs, in the plain version's operation
// order, and rintf rounds half to even like torch.round. Mish goes through
// tanhf/log1pf/expf, which may differ from torch's by an ulp.
//
// W1 and W2 (as a (9*C/2, C) matrix) stream through a double-buffered ring
// of 32-row slices in shared memory filled with cp.async, shared by the 8
// warps; each warp owns up to 16 accumulator tiles of 16x16. Shared rows
// are skewed by 16 bytes (WMMA s8 needs a row pitch that is a multiple of
// 16 bytes). s8 operands take half the shared memory of the bf16 kernel,
// so every Darknet-53 geometry (208x208x64 .. 13x13x1024) fits easily.
//
// Outputs never alias inputs: neighbouring CTAs read each other's halo rows
// of x, so the Python wrapper ping-pongs two buffers across a stage.
//
// Bound on the H100: the s8 tensor-core products (about 0.23 T int8
// operations, 0.11 T multiply-adds, per 26x26x512 block at B = 128), here
// through mma.sync-class WMMA and far below the card's int8 peak: the
// 8-block stage took 21.3 ms at B = 128, about 85 T operations per second
// (H100 80GB HBM3, 700 W power limit). At small B the weights each block
// streams from L2 to few CTAs.
//
// Left for later: wgmma (s8) with TMA-fed weight tiles, chaining several
// blocks per launch, and splitting output channels across CTAs at small B.

#include <cuda_runtime.h>
#include <mma.h>
#include <math.h>

using namespace nvcuda;

namespace {

constexpr int kTileRows = 2;     // TH: output rows per CTA
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32;       // K rows per ring stage
constexpr int kStages = 2;       // ring stages (kStages - 1 chunks in flight)
constexpr int kAcc = 16;         // 16x16 accumulator tiles per warp
constexpr int kSkew = 16;        // bytes of padding per shared row
constexpr int kMaxSmem = 232448;  // 227 KB opt-in limit per block on sm_90

using s8 = signed char;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, s8, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, s8, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, int>;

__host__ __device__ __forceinline__ int round_up(int v, int m) {
    return (v + m - 1) / m * m;
}

// 16x16 tiles per warp along N (NF) and M (MF = kAcc / NF) for an N-wide
// product; N is 32, 64 or a multiple of 128
__host__ __device__ __forceinline__ int nf_for(int n) { return n >= 128 ? 8 : n / 16; }
__host__ __device__ __forceinline__ int mf_for(int n) { return kAcc / nf_for(n); }

__device__ __forceinline__ float activate(float v, int act) {
    if (act == 0) return v > 0.f ? v : __fmul_rn(v, 0.1f);   // leaky_relu(0.1)
    return __fmul_rn(v, tanhf(log1pf(expf(v))));             // mish
}

// clip(rint(v), -127, 127) as s8
__device__ __forceinline__ s8 requant(float v) {
    return static_cast<s8>(fminf(fmaxf(rintf(v), -127.f), 127.f));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [c*kChunk, (c+1)*kChunk) of the row-major (K, n) s8 matrix b into a
// ring stage with row pitch n + kSkew.
__device__ __forceinline__ void load_b_chunk(s8* stage, const s8* __restrict__ b,
                                             int n, int c) {
    const int vec_row = n / 16;
    const s8* src = b + static_cast<size_t>(c) * kChunk * n;
    for (int v = threadIdx.x; v < kChunk * vec_row; v += kThreads) {
        const int r = v / vec_row;
        const int col = (v - r * vec_row) * 16;
        cp_async16(stage + r * (n + kSkew) + col, src + static_cast<size_t>(r) * n + col);
    }
}

// C[m_pad, n] = A[m_pad, K] @ B[K, n] in i32 with K = n_chunks * kChunk. A
// row m of K-chunk c starts at a_chunk(c) + m * lda; B streams through the
// ring. Each warp owns one MF x NF tile block per round; epi(m0, n0, stage)
// consumes every accumulator tile. Called by all threads of the CTA.
template <int MF, int NF, typename AChunk, typename Epi>
__device__ __forceinline__ void ring_gemm(AChunk a_chunk, int lda,
                                          const s8* __restrict__ b, int n,
                                          int n_chunks, int m_pad, s8* ring,
                                          int* stage, Epi epi) {
    const int warp = threadIdx.x >> 5;
    const int tiles_n = n / (16 * NF);
    const int tiles = (m_pad / (16 * MF)) * tiles_n;
    const int ldb = n + kSkew;
    for (int round = 0; round * kWarps < tiles; ++round) {
        const int t = round * kWarps + warp;
        const bool active = t < tiles;
        const int m0 = active ? (t / tiles_n) * 16 * MF : 0;
        const int n0 = active ? (t % tiles_n) * 16 * NF : 0;
        FragC acc[MF][NF];
#pragma unroll
        for (int i = 0; i < MF; ++i)
#pragma unroll
            for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[i][j], 0);

        // kStages - 1 chunks in flight; one commit group per chunk (empty
        // past the end) keeps the wait count uniform
        for (int s = 0; s < kStages - 1; ++s) {
            if (s < n_chunks) load_b_chunk(ring + s * kChunk * ldb, b, n, s);
            cp_async_commit();
        }
        for (int c = 0; c < n_chunks; ++c) {
            cp_async_wait<kStages - 2>();  // this thread's copies of chunk c
            __syncthreads();  // everyone's; and the stage read in c - 1 is free
            const int next = c + kStages - 1;
            if (next < n_chunks)
                load_b_chunk(ring + (next % kStages) * kChunk * ldb, b, n, next);
            cp_async_commit();
            if (active) {
                const s8* a = a_chunk(c);
                const s8* bs = ring + (c % kStages) * kChunk * ldb;
#pragma unroll
                for (int kk = 0; kk < kChunk; kk += 16) {
                    FragB bf[NF];
#pragma unroll
                    for (int j = 0; j < NF; ++j)
                        wmma::load_matrix_sync(bf[j], bs + kk * ldb + n0 + 16 * j, ldb);
#pragma unroll
                    for (int i = 0; i < MF; ++i) {
                        FragA af;
                        wmma::load_matrix_sync(
                            af, a + static_cast<size_t>(m0 + 16 * i) * lda + kk, lda);
#pragma unroll
                        for (int j = 0; j < NF; ++j)
                            wmma::mma_sync(acc[i][j], af, bf[j], acc[i][j]);
                    }
                }
            }
        }
        cp_async_wait<0>();
        __syncthreads();  // the ring is refilled by the next product
        if (active) {
#pragma unroll
            for (int i = 0; i < MF; ++i)
#pragma unroll
                for (int j = 0; j < NF; ++j) {
                    wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
                    __syncwarp();
                    epi(m0 + 16 * i, n0 + 16 * j, stage);
                    __syncwarp();
                }
        }
    }
}

template <typename AChunk, typename Epi>
__device__ __forceinline__ void gemm_dispatch(int nf, AChunk a_chunk, int lda,
                                              const s8* __restrict__ b, int n,
                                              int n_chunks, int m_pad, s8* ring,
                                              int* stage, Epi epi) {
    if (nf == 8)
        ring_gemm<kAcc / 8, 8>(a_chunk, lda, b, n, n_chunks, m_pad, ring, stage, epi);
    else if (nf == 4)
        ring_gemm<kAcc / 4, 4>(a_chunk, lda, b, n, n_chunks, m_pad, ring, stage, epi);
    else
        ring_gemm<kAcc / 2, 2>(a_chunk, lda, b, n, n_chunks, m_pad, ring, stage, epi);
}

struct Rows {
    const float* d1;    // (C/2)
    const float* b1;    // (C/2)
    const float* vm1;   // (C/2)
    const float* d2;    // (C)
    const float* b2;    // (C)
    const float* vout;  // (C)
    const float* rres;  // (C)
};

// x, out: (B, H, W, C) s8 inside padded buffers (see the wrapper);
// w1: (C, C/2) s8; w2: (9, C/2, C) s8 (taps row-major).
__global__ void __launch_bounds__(kThreads)
resblock_int8_kernel(const s8* __restrict__ x, const s8* __restrict__ w1,
                     const s8* __restrict__ w2, Rows rows, s8* __restrict__ out,
                     int H, int W, int C, int act,
                     int m1_pad, int mout_pad, int mid_len) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    const int ch = C / 2;
    const int wp = W + 2;
    const int ldm = ch + kSkew;  // mid row pitch (bytes)
    s8* mid = reinterpret_cast<s8*>(smem_raw);
    s8* ring = mid + static_cast<size_t>(round_up(mid_len * ldm, 128));
    int* stage = reinterpret_cast<int*>(ring + kStages * kChunk * (C + kSkew)) +
                 (threadIdx.x >> 5) * 256;

    const int y0 = blockIdx.x * kTileRows;
    const size_t img = static_cast<size_t>(blockIdx.y) * H * W * C;
    const s8* ximg = x + img;
    s8* oimg = out + img;
    const int lane = threadIdx.x & 31;

    for (int v = threadIdx.x; v < mid_len * ldm / 16; v += kThreads)
        reinterpret_cast<uint4*>(mid)[v] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();

    // 1. mid = requant(act(x @ W1 * d1 + b1)) over pixels of rows
    // y0-1 .. y0+TH; rows outside the image read the padding / neighbours
    // and are discarded
    const int n1 = (kTileRows + 2) * W;
    const s8* xrows = ximg + static_cast<long long>(y0 - 1) * W * C;
    gemm_dispatch(
        nf_for(ch), [&](int c) { return xrows + c * kChunk; }, C, w1, ch,
        C / kChunk, m1_pad, ring, stage,
        [&](int m0, int n0, const int* st) {
            for (int e = lane; e < 256; e += 32) {
                const int p = m0 + (e >> 4);
                if (p >= n1) continue;
                const int row = p / W;
                const int y = y0 - 1 + row;
                if (y < 0 || y >= H) continue;  // the conv's zero padding
                const int c = n0 + (e & 15);
                const float v = activate(
                    __fadd_rn(__fmul_rn(static_cast<float>(st[e]), rows.d1[c]), rows.b1[c]),
                    act);
                mid[static_cast<size_t>(1 + row * wp + (p - row * W) + 1) * ldm + c] =
                    requant(__fmul_rn(v, rows.vm1[c]));
            }
        });
    __syncthreads();

    // 2.+3. out = requant(act(conv3x3(mid) * d2 + b2) * vout + x * rres) over
    // positions q of the padded rows 1 .. TH (padded row q / wp + 1, padded
    // column q % wp)
    gemm_dispatch(
        nf_for(C),
        [&](int c) {
            const int k = c * kChunk;
            const int tap = k / ch;
            const int off = (tap / 3 - 1) * wp + (tap % 3 - 1);
            return mid + static_cast<size_t>(1 + wp + off) * ldm + (k - tap * ch);
        },
        ldm, w2, C, 9 * ch / kChunk, mout_pad, ring, stage,
        [&](int m0, int n0, const int* st) {
            for (int e = lane; e < 256; e += 32) {
                const int q = m0 + (e >> 4);
                const int ty = q / wp;
                const int xc = q - ty * wp - 1;
                const int y = y0 + ty;
                if (ty >= kTileRows || y >= H || xc < 0 || xc >= W) continue;
                const int c = n0 + (e & 15);
                const size_t idx = (static_cast<size_t>(y) * W + xc) * C + c;
                const float v = activate(
                    __fadd_rn(__fmul_rn(static_cast<float>(st[e]), rows.d2[c]), rows.b2[c]),
                    act);
                const float r = __fmul_rn(static_cast<float>(ximg[idx]), rows.rres[c]);
                oimg[idx] = requant(__fadd_rn(__fmul_rn(v, rows.vout[c]), r));
            }
        });
}

struct Geometry {
    int m1_pad, mout_pad, mid_len;
    size_t smem;
};

Geometry geometry(int W, int C) {
    Geometry g;
    const int wp = W + 2;
    const int ch = C / 2;
    g.m1_pad = round_up((kTileRows + 2) * W, 16 * mf_for(ch));
    g.mout_pad = round_up(kTileRows * wp, 16 * mf_for(C));
    g.mid_len = g.mout_pad + 2 * wp + 2;
    g.smem = static_cast<size_t>(round_up(g.mid_len * (ch + kSkew), 128)) +
             static_cast<size_t>(kStages) * kChunk * (C + kSkew) +
             static_cast<size_t>(kWarps) * 256 * sizeof(int);
    return g;
}

bool width_ok(int n) { return n == 32 || n == 64 || (n >= 128 && n % 128 == 0); }

}  // namespace

// Dynamic shared memory one CTA needs for a (W, C) geometry.
extern "C" long long resblock_int8_smem_bytes(int W, int C) {
    return static_cast<long long>(geometry(W, C).smem);
}

// Pixels of padding the x buffer needs before its first and after its last
// image: the rows above and below an image that the 1x1 reads and discards,
// plus the tail of the last 16-row tile.
extern "C" int resblock_int8_pad_pixels(int W, int C) {
    return 2 * W + geometry(W, C).m1_pad - (kTileRows + 2) * W + 16;
}

// One quantized residual block over a (B, H, W, C) s8 NHWC batch; act 0 =
// leaky, 1 = mish. x must have resblock_int8_pad_pixels(W, C) * C readable
// bytes before and after it; x and out must not overlap. d1, b1, vm1 are
// (C/2) f32 rows; d2, b2, vout, rres (C) f32 rows. Returns
// cudaGetLastError().
extern "C" int resblock_int8_launch(const void* x, const void* w1, const void* d1,
                                    const void* b1, const void* vm1, const void* w2,
                                    const void* d2, const void* b2, const void* vout,
                                    const void* rres, void* out, int batch, int H,
                                    int W, int C, int act, void* stream) {
    if (batch <= 0 || H <= 0 || W <= 0 || batch > 65535 || !width_ok(C) ||
        !width_ok(C / 2) || (C / 2) % kChunk != 0 || (act != 0 && act != 1))
        return cudaErrorInvalidValue;
    const Geometry g = geometry(W, C);
    if (g.smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        resblock_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(g.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const Rows rows{static_cast<const float*>(d1), static_cast<const float*>(b1),
                    static_cast<const float*>(vm1), static_cast<const float*>(d2),
                    static_cast<const float*>(b2), static_cast<const float*>(vout),
                    static_cast<const float*>(rres)};
    const dim3 grid((H + kTileRows - 1) / kTileRows, batch);
    resblock_int8_kernel<<<grid, kThreads, g.smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const s8*>(x), static_cast<const s8*>(w1),
        static_cast<const s8*>(w2), rows, static_cast<s8*>(out), H, W, C, act,
        g.m1_pad, g.mout_pad, g.mid_len);
    return static_cast<int>(cudaGetLastError());
}
