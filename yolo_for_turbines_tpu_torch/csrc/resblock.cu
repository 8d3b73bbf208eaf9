// Fused folded-inference Darknet residual block:
//     out = x + act(conv3x3(act(x @ W1 + b1)) + b2)
//
// Replaces the Pallas kernel yolo_for_turbines_tpu/ops/pallas/resblock_kernel.py
// (fused_residual_stage / _stage_kernel). The TPU kernel keeps a whole image
// resident in VMEM across a chunk of blocks; one 26x26x512 bf16 image is
// 692 KB, far beyond the 227 KB of shared memory a CTA can hold, so here one
// launch runs ONE block and each CTA owns a tile of TH output rows x W x all
// C output channels of one image:
//
//   1. mid = act(x @ W1 + b1) for input rows y0-1 .. y0+TH on the tensor
//      cores (WMMA bf16, f32 accumulation), rounded to bf16 as the Pallas
//      kernel does, stored in shared memory in a zero-padded
//      (TH+2) x (W+2) x C/2 layout. The halo rows are recomputed by the
//      neighbouring CTA, not exchanged. x is read straight from device
//      memory: the wrapper pads the activation buffers so the rows above
//      and below the image (whose results are discarded) stay in bounds;
//   2. in the padded layout a 3x3 tap (u, v) is a constant row shift of
//      (u-1)*(W+2) + (v-1), so the conv is nine shifted (positions, C/2) @
//      (C/2, C) products accumulated in f32 (outputs in the two pad columns
//      are computed and discarded);
//   3. epilogue: + b2, act, round to bf16, residual add in bf16.
//
// Both products stream their weights (W1, then W2 as a (9*C/2, C) matrix)
// through a double-buffered ring of 32-row slices in shared memory filled
// with cp.async (one barrier per slice), shared by all 8 warps; each warp
// owns up to 16 accumulator
// tiles of 16x16 for the whole K loop. Shared rows are skewed by 16
// elements to spread ldmatrix accesses over the banks.
//
// Outputs never alias inputs: neighbouring CTAs read each other's halo rows
// of x, so the Python wrapper ping-pongs two buffers across a stage.
//
// Bound on the H100: at B = 128 the tensor-core FLOPs (about 0.23 TFLOP per
// 26x26x512 block), here through mma.sync-class WMMA rather than wgmma; at
// B = 1 the 2.6 MB of bf16 weights each block streams from L2 to only 13
// CTAs. One CTA per SM (about 100-210 KB of shared memory, 255 registers a
// thread). Measured, the 3x3 product runs far below the tensor-core rate,
// and a deeper ring did not speed it up: load latency is not what holds it
// back.
//
// Left for later: wgmma with TMA-fed weight tiles, chaining several blocks
// per launch, and splitting output channels across CTAs at small B.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int kTileRows = 2;     // TH: output rows per CTA
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32;       // K rows per ring stage
constexpr int kStages = 2;       // ring stages (kStages - 1 chunks in flight)
constexpr int kAcc = 16;         // 16x16 accumulator tiles per warp
constexpr int kSkew = 16;        // elements of padding per shared row
constexpr int kMaxSmem = 232448;  // 227 KB opt-in limit per block on sm_90

using bf16 = __nv_bfloat16;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__host__ __device__ __forceinline__ int round_up(int v, int m) {
    return (v + m - 1) / m * m;
}

// 16x16 tiles per warp along N (NF) and M (MF = kAcc / NF) for an N-wide
// product; N is 32, 64 or a multiple of 128
__host__ __device__ __forceinline__ int nf_for(int n) { return n >= 128 ? 8 : n / 16; }
__host__ __device__ __forceinline__ int mf_for(int n) { return kAcc / nf_for(n); }

__device__ __forceinline__ float activate(float v, int act) {
    if (act == 0) return v > 0.f ? v : v * 0.1f;    // leaky_relu(0.1)
    return v * tanhf(log1pf(expf(v)));              // mish
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

// Rows [c*kChunk, (c+1)*kChunk) of the row-major (K, n) matrix b into a ring
// stage with row pitch n + kSkew.
__device__ __forceinline__ void load_b_chunk(bf16* stage, const bf16* __restrict__ b,
                                             int n, int c) {
    const int vec_row = n / 8;
    const bf16* src = b + static_cast<size_t>(c) * kChunk * n;
    for (int v = threadIdx.x; v < kChunk * vec_row; v += kThreads) {
        const int r = v / vec_row;
        const int col = (v - r * vec_row) * 8;
        cp_async16(stage + r * (n + kSkew) + col, src + static_cast<size_t>(r) * n + col);
    }
}

// C[m_pad, n] = A[m_pad, K] @ B[K, n] with K = n_chunks * kChunk. A row m of
// K-chunk c starts at a_chunk(c) + m * lda; B streams through the ring.
// Each warp owns one MF x NF tile block per round; epi(m0, n0, acc, stage)
// consumes every accumulator tile. Called by all threads of the CTA.
template <int MF, int NF, typename AChunk, typename Epi>
__device__ __forceinline__ void ring_gemm(AChunk a_chunk, int lda,
                                          const bf16* __restrict__ b, int n,
                                          int n_chunks, int m_pad, bf16* ring,
                                          float* stage, Epi epi) {
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
            for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[i][j], 0.f);

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
                const bf16* a = a_chunk(c);
                const bf16* bs = ring + (c % kStages) * kChunk * ldb;
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
                                              const bf16* __restrict__ b, int n,
                                              int n_chunks, int m_pad, bf16* ring,
                                              float* stage, Epi epi) {
    if (nf == 8)
        ring_gemm<kAcc / 8, 8>(a_chunk, lda, b, n, n_chunks, m_pad, ring, stage, epi);
    else if (nf == 4)
        ring_gemm<kAcc / 4, 4>(a_chunk, lda, b, n, n_chunks, m_pad, ring, stage, epi);
    else
        ring_gemm<kAcc / 2, 2>(a_chunk, lda, b, n, n_chunks, m_pad, ring, stage, epi);
}

// x, out: (B, H, W, C) bf16 inside padded buffers (see the wrapper);
// w1: (C, C/2) bf16; b1: (C/2) f32; w2: (9, C/2, C) bf16 (taps row-major);
// b2: (C) f32.
__global__ void __launch_bounds__(kThreads)
resblock_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                const float* __restrict__ b1, const bf16* __restrict__ w2,
                const float* __restrict__ b2, bf16* __restrict__ out,
                int H, int W, int C, int act,
                int m1_pad, int mout_pad, int mid_len) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    const int ch = C / 2;
    const int wp = W + 2;
    const int ldm = ch + kSkew;  // mid row pitch
    bf16* mid = reinterpret_cast<bf16*>(smem_raw);
    bf16* ring = mid + static_cast<size_t>(mid_len) * ldm;
    float* stage = reinterpret_cast<float*>(ring + kStages * kChunk * (C + kSkew)) +
                   (threadIdx.x >> 5) * 256;

    const int y0 = blockIdx.x * kTileRows;
    const size_t img = static_cast<size_t>(blockIdx.y) * H * W * C;
    const bf16* ximg = x + img;
    bf16* oimg = out + img;
    const int lane = threadIdx.x & 31;

    for (int v = threadIdx.x; v < mid_len * ldm / 8; v += kThreads)
        reinterpret_cast<uint4*>(mid)[v] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();

    // 1. mid = act(x @ W1 + b1) over pixels of rows y0-1 .. y0+TH; rows
    // outside the image read the padding / neighbours and are discarded
    const int n1 = (kTileRows + 2) * W;
    const bf16* xrows = ximg + static_cast<long long>(y0 - 1) * W * C;
    gemm_dispatch(
        nf_for(ch), [&](int c) { return xrows + c * kChunk; }, C, w1, ch,
        C / kChunk, m1_pad, ring, stage,
        [&](int m0, int n0, const float* st) {
            for (int e = lane; e < 256; e += 32) {
                const int p = m0 + (e >> 4);
                if (p >= n1) continue;
                const int row = p / W;
                const int y = y0 - 1 + row;
                if (y < 0 || y >= H) continue;  // the conv's zero padding
                const int c = n0 + (e & 15);
                const float v = activate(st[e] + b1[c], act);
                mid[static_cast<size_t>(1 + row * wp + (p - row * W) + 1) * ldm + c] =
                    __float2bfloat16(v);
            }
        });
    __syncthreads();

    // 2.+3. out = x + act(conv3x3(mid) + b2) over positions q of the padded
    // rows 1 .. TH (padded row q / wp + 1, padded column q % wp)
    gemm_dispatch(
        nf_for(C),
        [&](int c) {
            const int k = c * kChunk;
            const int tap = k / ch;
            const int off = (tap / 3 - 1) * wp + (tap % 3 - 1);
            return mid + static_cast<size_t>(1 + wp + off) * ldm + (k - tap * ch);
        },
        ldm, w2, C, 9 * ch / kChunk, mout_pad, ring, stage,
        [&](int m0, int n0, const float* st) {
            for (int e = lane; e < 256; e += 32) {
                const int q = m0 + (e >> 4);
                const int ty = q / wp;
                const int xc = q - ty * wp - 1;
                const int y = y0 + ty;
                if (ty >= kTileRows || y >= H || xc < 0 || xc >= W) continue;
                const int c = n0 + (e & 15);
                const size_t idx = (static_cast<size_t>(y) * W + xc) * C + c;
                const float v = activate(st[e] + b2[c], act);
                const float yb = __bfloat162float(__float2bfloat16(v));
                oimg[idx] = __float2bfloat16(__bfloat162float(ximg[idx]) + yb);
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
    g.smem = static_cast<size_t>(g.mid_len) * (ch + kSkew) * sizeof(bf16) +
             static_cast<size_t>(kStages) * kChunk * (C + kSkew) * sizeof(bf16) +
             static_cast<size_t>(kWarps) * 256 * sizeof(float);
    return g;
}

bool width_ok(int n) { return n == 32 || n == 64 || (n >= 128 && n % 128 == 0); }

}  // namespace

// Dynamic shared memory one CTA needs for a (W, C) geometry.
extern "C" long long resblock_smem_bytes(int W, int C) {
    return static_cast<long long>(geometry(W, C).smem);
}

// Pixels of padding the x buffer needs before its first and after its last
// image: the rows above and below an image that the 1x1 reads and discards,
// plus the tail of the last 16-row tile.
extern "C" int resblock_pad_pixels(int W, int C) {
    return 2 * W + geometry(W, C).m1_pad - (kTileRows + 2) * W + 16;
}

// One residual block over a (B, H, W, C) bf16 NHWC batch; act 0 = leaky,
// 1 = mish. x must have resblock_pad_pixels(W, C) * C readable elements
// before and after it; x and out must not overlap. Returns cudaGetLastError().
extern "C" int resblock_launch(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* out,
                               int batch, int H, int W, int C, int act,
                               void* stream) {
    if (batch <= 0 || H <= 0 || W <= 0 || batch > 65535 || !width_ok(C) ||
        !width_ok(C / 2) || (C / 2) % kChunk != 0 || (act != 0 && act != 1))
        return cudaErrorInvalidValue;
    const Geometry g = geometry(W, C);
    if (g.smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        resblock_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(g.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((H + kTileRows - 1) / kTileRows, batch);
    resblock_kernel<<<grid, kThreads, g.smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
        static_cast<const float*>(b1), static_cast<const bf16*>(w2),
        static_cast<const float*>(b2), static_cast<bf16*>(out), H, W, C, act,
        g.m1_pad, g.mout_pad, g.mid_len);
    return static_cast<int>(cudaGetLastError());
}
