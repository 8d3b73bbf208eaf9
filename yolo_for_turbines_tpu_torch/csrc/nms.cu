// Fused class-aware greedy NMS over the top-K candidates of each image,
// sorted by descending score: a kept box clears every later box of its class
// with IoU >= thr, and a cleared box clears nothing.
//
// Replaces the Pallas kernel yolo_for_turbines_tpu/ops/pallas/nms_kernel.py
// (greedy_nms_pallas / _nms_kernel), which builds the K x K suppression
// matrix in VMEM and sweeps it in K dependent steps.
//
// Bound on the H100: latency, not bytes (0.8 MB at B = 128, K = 256) and not
// operations (a few us of arithmetic). The first CUDA version ran the sweep
// as K steps of one CTA, each ending in a __syncthreads: 256 barriers, 0.083
// ms whatever the batch, after four small torch kernels that converted and
// copied the candidates.
//
// Design:
//  1. Suppress bits, in parallel. bits[i][w] holds, for the 32 candidates
//     j = 32 w + b, whether j > i, class j == class i and IoU(i, j) >= thr.
//     A warp takes one word column w and 32 rows: lane b keeps column box j
//     in registers, the row boxes come from shared memory, __ballot_sync
//     makes each word. Only words at or above the diagonal are computed.
//     An image's tests run on one SM, whose instruction rate bounds them,
//     so tasks whose boxes are all finite take single-instruction min / max.
//  2. The sweep, by one warp, with no block barrier. The keep words start as
//     the validity bits. The warp walks the set bits in order: __ffs finds
//     the lowest box i of the current word not yet visited (kept: everything
//     before it is final), every lane clears bits[i][l] from the keep words
//     it owns. Cleared boxes are never visited, so the number of dependent
//     steps is the number of kept boxes, each one shared-memory read.
//  3. The candidates are read as they are: (B, K, 6) f32 rows [x, y, w, h,
//     score, class] and the validity bytes; centre boxes are converted here
//     with the plain version's floats (boxes.cuh). Nothing runs before the
//     launch.
//  4. Any K. K <= 1024: one launch per batch, one CTA per image, boxes and
//     bits in dynamic shared memory (152 KB at K = 1024, 14 KB at K = 256).
//     K > 1024: the same device functions as two launches, nms_bits_kernel
//     (a CTA per 32 rows, bits to a scratch tensor in device memory) and
//     nms_sweep_kernel (one warp per image, keep words in shared memory,
//     lanes striding over them). That path serves calls with max_boxes = N
//     and is held for correctness, not speed.
//
// Exactness: the keep mask equals the plain torch version bit for bit, NaN
// boxes included (a NaN IoU or class compares false and clears nothing).
//
// Measured on an NVIDIA H100 80GB HBM3 (700 W power limit), chip_smoke.py
// phase k1, K = 256 of N = 10647 with 3 classes (about 180 of 256 kept),
// wrapper included: 0.024 ms at B = 1, 8 and 128, of which the card 0.022 ms
// (20 launches replayed as one CUDA graph): about 10 us for the bits and the
// loads on the image's one SM, about 50 ns per kept box in the sweep. The
// first version in the same call: 0.10-0.15 ms. K = 2048, B = 2 (two
// launches, the sweep reading device memory): 0.32 ms. PERF.md has the runs.

#include "boxes.cuh"

namespace {

using boxes::Box;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kFusedMaxK = 1024;   // 32 keep words: bits fit shared memory
constexpr int kBitsThreads = 256;  // nms_bits_kernel

// One candidate row [x, y, w, h, score, class] -> its box (x1, y1, x2, y2 in
// `a`; area and class in `b`). Rows are 24 bytes: three 8-byte loads.
__device__ __forceinline__ void load_cand(const float* __restrict__ cand, size_t row, bool center,
                                          float4& a, float2& b) {
    const float2* p = reinterpret_cast<const float2*>(cand) + 3 * row;
    const float2 xy = p[0], wh = p[1], sc = p[2];
    const Box r = boxes::make_box(xy.x, xy.y, wh.x, wh.y, center);
    a = make_float4(r.x1, r.y1, r.x2, r.y2);
    b = make_float2(r.area, sc.y);
}

// One warp: lane holds column candidate j (box aj / bj); the nrows <= 32 row
// boxes ra / rb start at candidate i0. Returns in lane r the word of this
// column for row i0 + r. kFinite: every box of the task has finite corners.
template <bool kFinite>
__device__ __forceinline__ unsigned suppress_rows(const Box& boxj, float clsj, int j, bool j_ok,
                                                  const float4* ra, const float2* rb, int i0,
                                                  int nrows, float thr, int lane) {
    unsigned mine = 0;
#pragma unroll 4  // independent rows: more tests in flight per warp
    for (int r = 0; r < nrows; ++r) {
        const float4 a = ra[r];
        const float2 b = rb[r];
        const Box boxi = {a.x, a.y, a.z, a.w, b.x};
        const bool s = j_ok && j > i0 + r && b.y == clsj &&
                       boxes::iou<kFinite>(boxi, boxj) >= thr;
        const unsigned word = __ballot_sync(kFull, s);
        if (lane == r) mine = word;
    }
    return mine;
}

// The same, written to bits[r * stride]. One CTA is one SM, so at K = 256 the
// 32.6 K tests of an image are bound by that SM's instruction rate: a task
// whose 64 boxes all have finite corners (one vote) takes the single-instruction
// min / max.
__device__ __forceinline__ void suppress_words(const float4 aj, const float2 bj, int j, bool j_ok,
                                               const float4* ra, const float2* rb, int i0,
                                               int nrows, float thr, unsigned* bits, int stride,
                                               int lane) {
    const Box boxj = {aj.x, aj.y, aj.z, aj.w, bj.x};
    const float4 al = ra[min(lane, nrows - 1)];
    const Box mine_row = {al.x, al.y, al.z, al.w, 0.f};
    const bool finite = __all_sync(kFull, boxes::corners_finite(boxj) &&
                                              boxes::corners_finite(mine_row));
    const unsigned mine =
        finite ? suppress_rows<true>(boxj, bj.y, j, j_ok, ra, rb, i0, nrows, thr, lane)
               : suppress_rows<false>(boxj, bj.y, j, j_ok, ra, rb, i0, nrows, thr, lane);
    if (lane < nrows) bits[static_cast<size_t>(lane) * stride] = mine;
}

// Validity bytes of one image -> keep words, by the warps of the CTA.
__device__ __forceinline__ void load_valid_words(const unsigned char* __restrict__ valid, int k,
                                                 int words, unsigned* skeep, int warp, int nwarps,
                                                 int lane) {
    for (int w = warp; w < words; w += nwarps) {
        const int j = 32 * w + lane;
        const unsigned word = __ballot_sync(kFull, j < k && valid[j] != 0);
        if (lane == 0) skeep[w] = word;
    }
}

// The greedy sweep by one warp. bits: (K, words) in shared or device memory;
// skeep: the keep words in shared memory, final on return. kRegisters (words
// <= 32): lane l keeps word l in a register during the sweep, so a step is
// __ffs, one shared-memory read and a mask. Otherwise lane l owns the words
// l, l + 32, ... in shared memory.
template <bool kRegisters>
__device__ __forceinline__ void sweep(const unsigned* bits, unsigned* skeep, int words, int lane) {
    unsigned mine = (kRegisters && lane < words) ? skeep[lane] : 0u;
    for (int w = 0; w < words; ++w) {
        // word w is final: every earlier word has been walked
        unsigned pending;
        if (kRegisters) {
            pending = __shfl_sync(kFull, mine, w);
        } else {
            __syncwarp();
            pending = skeep[w];
        }
        const int first = lane + (w > lane ? ((w - lane + 31) & ~31) : 0);  // owned, >= w
        while (pending) {  // uniform across the warp
            const int b = __ffs(pending) - 1;
            const unsigned* row = bits + static_cast<size_t>(32 * w + b) * words;
            const unsigned same_word = row[w];
            if (kRegisters) {
                if (lane >= w && lane < words) mine &= ~row[lane];
            } else {
                for (int l = first; l < words; l += 32) skeep[l] &= ~row[l];
            }
            pending &= ~same_word & ~((2u << b) - 1u);
        }
    }
    if (kRegisters && lane < words) skeep[lane] = mine;
    __syncwarp();
}

__device__ __forceinline__ void store_keep(const unsigned* skeep, int k,
                                           unsigned char* __restrict__ keep_out, int lane) {
    for (int j = lane; j < k; j += 32) keep_out[j] = (skeep[j >> 5] >> (j & 31)) & 1u;
}

// K <= 1024: one CTA per image.
__global__ void __launch_bounds__(1024)
nms_fused_kernel(const float* __restrict__ cand, const unsigned char* __restrict__ valid,
                 float thr, int k, int center, unsigned char* __restrict__ keep_out) {
    extern __shared__ float4 smem[];
    const int words = (k + 31) >> 5;
    float4* sa = smem;                                         // k boxes: x1 y1 x2 y2
    float2* sb = reinterpret_cast<float2*>(sa + k);            // k: area, class
    unsigned* skeep = reinterpret_cast<unsigned*>(sb + k);     // keep words
    unsigned* sbits = skeep + words;                           // k x words

    const size_t base = static_cast<size_t>(blockIdx.x) * k;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
    for (int j = threadIdx.x; j < k; j += blockDim.x) load_cand(cand, base + j, center, sa[j], sb[j]);
    load_valid_words(valid + base, k, words, skeep, warp, nwarps, lane);
    __syncthreads();

    // tasks: word column w, 32-row chunk rc <= w, numbered t = w (w + 1) / 2 + rc
    const int ntasks = words * (words + 1) / 2;
    for (int t = warp; t < ntasks; t += nwarps) {
        int w = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
        while (w * (w + 1) / 2 > t) --w;
        while ((w + 1) * (w + 2) / 2 <= t) ++w;
        const int rc = t - w * (w + 1) / 2;
        const int j = 32 * w + lane, jc = min(j, k - 1), i0 = 32 * rc;
        suppress_words(sa[jc], sb[jc], j, j < k, sa + i0, sb + i0, i0, min(32, k - i0), thr,
                       sbits + static_cast<size_t>(i0) * words + w, words, lane);
    }
    __syncthreads();

    if (warp == 0) {
        sweep<true>(sbits, skeep, words, lane);
        store_keep(skeep, k, keep_out + base, lane);
    }
}

// K > 1024, first launch: CTA (rc, image) computes the words of rows
// 32 rc .. 32 rc + 31 at or right of the diagonal into device memory.
__global__ void __launch_bounds__(kBitsThreads)
nms_bits_kernel(const float* __restrict__ cand, float thr, int k, int center,
                unsigned* __restrict__ bits) {
    __shared__ float4 ra[32];
    __shared__ float2 rb[32];
    const int words = (k + 31) >> 5;
    const int rc = blockIdx.x, i0 = 32 * rc, nrows = min(32, k - i0);
    const size_t base = static_cast<size_t>(blockIdx.y) * k;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
    if (threadIdx.x < nrows) load_cand(cand, base + i0 + threadIdx.x, center, ra[threadIdx.x],
                                       rb[threadIdx.x]);
    __syncthreads();
    for (int w = rc + warp; w < words; w += nwarps) {
        const int j = 32 * w + lane;
        float4 aj;
        float2 bj;
        load_cand(cand, base + min(j, k - 1), center, aj, bj);
        suppress_words(aj, bj, j, j < k, ra, rb, i0, nrows, thr,
                       bits + (base + i0) * words + w, words, lane);
    }
}

// K > 1024, second launch: one warp per image sweeps the bits in device
// memory; the keep words live in shared memory.
__global__ void __launch_bounds__(32)
nms_sweep_kernel(const unsigned char* __restrict__ valid, const unsigned* __restrict__ bits,
                 int k, unsigned char* __restrict__ keep_out) {
    extern __shared__ unsigned skeep_dyn[];
    const int words = (k + 31) >> 5;
    const size_t base = static_cast<size_t>(blockIdx.x) * k;
    const int lane = threadIdx.x;
    load_valid_words(valid + base, k, words, skeep_dyn, 0, 1, lane);
    sweep<false>(bits + base * words, skeep_dyn, words, lane);
    store_keep(skeep_dyn, k, keep_out + base, lane);
}

}  // namespace

// cand (B, K, 6) f32 rows [x, y, w, h, score, class], contiguous and 8-byte
// aligned; valid (B, K) bool; keep (B, K) bool output; center != 0 for cxcywh
// boxes, 0 for top-left xywh. K <= 1024 takes one launch and no scratch;
// larger K takes two launches and `bits`, (B, K, ceil(K / 32)) int32 of
// device memory. Returns the first CUDA error.
extern "C" int greedy_nms_launch(const void* cand, const void* valid, float thr, int batch, int k,
                                 int center, void* bits, void* keep, void* stream) {
    if (batch <= 0 || k <= 0) return cudaErrorInvalidValue;
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* c = static_cast<const float*>(cand);
    const auto* v = static_cast<const unsigned char*>(valid);
    auto* out = static_cast<unsigned char*>(keep);
    const int words = (k + 31) / 32;
    if (k <= kFusedMaxK) {
        const size_t smem = static_cast<size_t>(k) * (sizeof(float4) + sizeof(float2)) +
                            sizeof(unsigned) * (words + static_cast<size_t>(k) * words);
        if (smem > 48 * 1024) {
            const cudaError_t e = cudaFuncSetAttribute(
                nms_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(smem));
            if (e != cudaSuccess) return static_cast<int>(e);
        }
        const int ntasks = words * (words + 1) / 2;
        const int threads = 32 * (ntasks < 32 ? ntasks : 32);
        nms_fused_kernel<<<batch, threads, smem, s>>>(c, v, thr, k, center, out);
        return static_cast<int>(cudaGetLastError());
    }
    if (bits == nullptr || batch > 65535) return cudaErrorInvalidValue;
    nms_bits_kernel<<<dim3(words, batch), kBitsThreads, 0, s>>>(c, thr, k, center,
                                                                static_cast<unsigned*>(bits));
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t smem = sizeof(unsigned) * words;
    if (smem > 48 * 1024) {
        e = cudaFuncSetAttribute(nms_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    nms_sweep_kernel<<<batch, 32, smem, s>>>(v, static_cast<const unsigned*>(bits), k, out);
    return static_cast<int>(cudaGetLastError());
}
