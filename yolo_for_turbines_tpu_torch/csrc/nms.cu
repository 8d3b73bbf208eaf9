// Fused class-aware greedy NMS: IoU test and sequential sweep in one launch.
//
// Replaces the Pallas kernel yolo_for_turbines_tpu/ops/pallas/nms_kernel.py
// (greedy_nms_pallas / _nms_kernel). Input per image: the top-K candidates
// sorted by descending score, boxes already in top-left xywh (the Python
// wrapper converts from center format, so this kernel and its plain torch
// version see identical floats), their class ids and validity bits.
//
// Design: one CTA per image, one thread per candidate (K <= 1024). Boxes,
// classes and keep bits are staged in shared memory. Step i of the sweep:
// if keep[i] is still set, every later thread j of the same class with
// IoU(i, j) >= thr clears keep[j]. Box i's bit is final by step i because
// only earlier boxes can clear it, so this is exactly the Pallas sweep
// keep <- keep * (1 - row_i * keep_i) without materialising the K x K matrix.
//
// Exactness: the keep mask must equal the plain torch version bit for bit.
// The arithmetic uses the _rn intrinsics, which the compiler never contracts
// into FMAs, in the operation order of _nms_kernel; the division is IEEE.
// min/max propagate NaN like torch.minimum / torch.maximum.
//
// Bound on the H100: latency. The sweep is K dependent steps, each ending in
// a __syncthreads (256 at K = 256); the arithmetic per step is a few dozen
// flops per thread. A batch of B images runs B independent CTAs, so batches
// up to the SM count cost about the same as one image.
//
// Left for later: a bitmask precomputed in parallel before the sweep, and a
// warp-level sweep that skips the barrier for steps whose box was cleared.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float max_nan(float a, float b) {
    return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float min_nan(float a, float b) {
    return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}

__global__ void greedy_nms_kernel(const float4* __restrict__ boxes,
                                  const float* __restrict__ cls,
                                  const unsigned char* __restrict__ valid,
                                  float thr, int k,
                                  unsigned char* __restrict__ keep_out) {
    extern __shared__ float4 smem[];
    float4* sbox = smem;                                       // k boxes
    float* scls = reinterpret_cast<float*>(sbox + k);          // k classes
    int* skeep = reinterpret_cast<int*>(scls + k);             // k keep bits

    const size_t base = static_cast<size_t>(blockIdx.x) * k;
    const int j = threadIdx.x;
    const bool active = j < k;

    float4 bj = make_float4(0.f, 0.f, 0.f, 0.f);
    float cj = 0.f;
    if (active) {
        bj = boxes[base + j];
        cj = cls[base + j];
        sbox[j] = bj;
        scls[j] = cj;
        skeep[j] = valid[base + j] ? 1 : 0;
    }
    __syncthreads();

    const float x2j = __fadd_rn(bj.x, bj.z);
    const float y2j = __fadd_rn(bj.y, bj.w);
    const float area_j = __fmul_rn(bj.z, bj.w);

    for (int i = 0; i < k; ++i) {
        // skeep[i] is read by every thread and written by none in step i
        if (skeep[i] && active && j > i && skeep[j] && scls[i] == cj) {
            const float4 bi = sbox[i];
            const float xa = max_nan(bi.x, bj.x);
            const float ya = max_nan(bi.y, bj.y);
            const float xb = min_nan(__fadd_rn(bi.x, bi.z), x2j);
            const float yb = min_nan(__fadd_rn(bi.y, bi.w), y2j);
            const float inter = __fmul_rn(max_nan(__fsub_rn(xb, xa), 0.f),
                                          max_nan(__fsub_rn(yb, ya), 0.f));
            const float uni = __fsub_rn(__fadd_rn(__fmul_rn(bi.z, bi.w), area_j),
                                        inter);
            const float iou = __fdiv_rn(inter, __fadd_rn(uni, 1e-6f));
            if (iou >= thr) skeep[j] = 0;
        }
        __syncthreads();
    }
    if (active) keep_out[base + j] = skeep[j] ? 1 : 0;
}

}  // namespace

// boxes (B, K, 4) f32 top-left xywh, cls (B, K) f32, valid (B, K) bool,
// keep (B, K) bool output; all contiguous. Returns cudaGetLastError().
extern "C" int greedy_nms_launch(const void* boxes, const void* cls,
                                 const void* valid, float thr, int batch,
                                 int k, void* keep, void* stream) {
    if (batch <= 0 || k <= 0 || k > 1024) return cudaErrorInvalidValue;
    const int threads = (k + 31) / 32 * 32;
    const size_t smem = static_cast<size_t>(k) *
                        (sizeof(float4) + sizeof(float) + sizeof(int));
    greedy_nms_kernel<<<batch, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(boxes), static_cast<const float*>(cls),
        static_cast<const unsigned char*>(valid), thr, k,
        static_cast<unsigned char*>(keep));
    return static_cast<int>(cudaGetLastError());
}
