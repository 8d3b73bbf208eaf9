// Pairwise IoU matrix: (K, 4) boxes -> (K, K) f32,
//     out[i][j] = inter(i, j) / (area_i + area_j - inter(i, j) + 1e-6).
//
// Replaces the Pallas kernel yolo_for_turbines_tpu/ops/pallas/iou_kernel.py
// (pairwise_iou_pallas / _iou_tile_kernel). The TPU kernel tiles the matrix
// in 128x128 blocks, pads K with zero-area boxes, and feeds box j as a (4, K)
// column copy so it broadcasts along lanes.
//
// Bound on the H100: device-memory writes. K*K*4 bytes go out (64 MB at
// K = 4096, more than the 50 MB L2) for a few dozen instructions per element;
// the K boxes read are nothing beside that. The first CUDA version gave one
// element and one 4-byte store to each thread of a 32 x 8 tile (65,536 CTAs
// at K = 4096, each staging 40 boxes behind a barrier to write 1 KB) and
// reached a quarter of the card's write rate.
//
// Design: a thread owns 4 neighbouring columns and several rows. It loads
// and converts its 4 column boxes once (corners and area in registers, the
// centre conversion included: nothing runs before the launch), then per row
// reads the row box (one address per warp, a broadcast), computes 4 IoUs and
// writes them as one 16-byte store, so a warp writes 512 contiguous bytes of
// a row. A CTA of 8 warps covers 128 columns and 64 rows, warp y taking
// rows y, y + 8, ...; no shared memory, no barrier. The stores are
// streaming (__stcs): the matrix is written once and not read here. The
// min / max of the formula must propagate NaN as torch does, which costs
// several instructions each; a thread whose boxes all have finite corners
// takes single-instruction min / max, which give the same floats there
// (boxes.cuh). Rows are 16-byte aligned only when K % 4 == 0: for other K
// the launcher takes the scalar variant of the same kernel, in which a
// thread's 4 columns lie 32 apart so that each store instruction of a warp
// still writes 128 contiguous bytes. Ragged edges are masked, so K needs no
// padding.
//
// Exactness: the matrix equals the plain torch version bit for bit
// (boxes.cuh: _rn intrinsics in the Pallas operation order, IEEE division).
//
// Measured on an NVIDIA H100 80GB HBM3 (700 W power limit), chip_smoke.py
// phase k3, wrapper included, K = 4096: 0.029 ms for centre and for top-left
// boxes, 69% of the 0.020 ms that 67 MB take at 3.35 TB/s (a fill of the same
// 64 MB by torch takes 0.024 ms); the first version in the same call 0.089 ms
// (centre) and 0.078 ms (top-left). Both constants below were picked by
// measurement there. Rows per CTA: 0.049 ms at 8, 0.035 at 16, 0.030 at 32,
// 0.029 at 64, 128 and 256; plain stores instead of streaming ones cost 2%. What was left after the stores were wide: the IEEE division,
// whose slow path a zero numerator takes (boxes.cuh), had doubled the time.
// At K = 256 the host's call rate sets the time (0.02 ms). PERF.md has the
// runs.

#include "boxes.cuh"

namespace {

using boxes::Box;

constexpr int kWarps = 8;            // warps per CTA, one row each per pass
constexpr int kTileCols = 128;       // 32 lanes x 4 columns
constexpr int kRows = 64;            // rows of the matrix per CTA

template <bool kVec>
__global__ void __launch_bounds__(32 * kWarps)
pairwise_iou_kernel(const float4* __restrict__ in, int k, int center, float* __restrict__ out) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int j0 = blockIdx.x * kTileCols + (kVec ? 4 * lane : lane);
    constexpr int kStep = kVec ? 1 : 32;  // distance between a thread's columns
    if (j0 >= k) return;

    Box cols[4];
    bool finite = true;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        const int j = j0 + c * kStep;
        const float4 v = j < k ? in[j] : make_float4(0.f, 0.f, 0.f, 0.f);
        cols[c] = boxes::make_box(v.x, v.y, v.z, v.w, center != 0);
        finite = finite && boxes::corners_finite(cols[c]);
    }

    const int i_begin = blockIdx.y * kRows;
    const int i_end = min(k, i_begin + kRows);
    for (int i = i_begin + warp; i < i_end; i += kWarps) {
        const float4 v = __ldg(in + i);
        const Box row = boxes::make_box(v.x, v.y, v.z, v.w, center != 0);
        float r[4];
        if (finite && boxes::corners_finite(row)) {
#pragma unroll
            for (int c = 0; c < 4; ++c) r[c] = boxes::iou<true>(row, cols[c]);
        } else {
#pragma unroll
            for (int c = 0; c < 4; ++c) r[c] = boxes::iou<false>(row, cols[c]);
        }
        float* p = out + static_cast<size_t>(i) * k + j0;
        if (kVec) {  // K % 4 == 0: j0 + 3 < k and p is 16-byte aligned
            __stcs(reinterpret_cast<float4*>(p), make_float4(r[0], r[1], r[2], r[3]));
        } else {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                if (j0 + c * kStep < k) __stcs(p + c * kStep, r[c]);
            }
        }
    }
}

}  // namespace

// boxes (K, 4) f32, contiguous and 16-byte aligned: cxcywh when center != 0,
// else top-left xywh; out (K, K) f32 contiguous, 16-byte aligned.
// K % 4 == 0 takes the 16-byte-store variant, other K the scalar one.
// Returns cudaGetLastError().
extern "C" int pairwise_iou_launch(const void* boxes, int k, int center, void* out, void* stream) {
    if (k <= 0 || (k + kRows - 1) / kRows > 65535) return cudaErrorInvalidValue;
    const dim3 grid((k + kTileCols - 1) / kTileCols, (k + kRows - 1) / kRows);
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* in = static_cast<const float4*>(boxes);
    auto* o = static_cast<float*>(out);
    auto kernel = k % 4 == 0 ? pairwise_iou_kernel<true> : pairwise_iou_kernel<false>;
    kernel<<<grid, 32 * kWarps, 0, s>>>(in, k, center, o);
    return static_cast<int>(cudaGetLastError());
}
