// The epilogue of a folded conv in one pass, in place on the conv's bf16
// output y (NHWC memory: rows = B*H*W, C channels):
//     y[r, c] = bf16(skip[r, c] + act(float(y[r, c]) + float(bias[c])))
// with act identity, leaky_relu(0.1) or mish, and skip optional.
//
// Replaces no TPU kernel: on the TPU, XLA fused the bias, the activation
// and the residual add into its convolution. On the card cuDNN computes the
// convolution and PyTorch adds the bias in a separate pass; through a
// channels_last output the (1, C, 1, 1) bias does not coalesce, so
// TensorIterator takes its generic kernel with an offset calculator and
// 2-byte accesses (40% of the card's bandwidth, 30% of the offline
// forward). The activation and the residual add were two more passes, each
// reading and writing the whole activation and rounding it to bf16.
//
// Bound on the H100: device-memory bytes. A few operations per element
// (mish: a few dozen) against 4 bytes read and written (6 with a skip).
// Design: one read and one write of y, one read of skip, and one rounding,
// at the store. Each thread moves 16-byte vectors of 8 consecutive elements
// and keeps kUnroll of them (and their skips) in flight before it computes,
// so that enough bytes are outstanding to reach HBM bandwidth. The grid is
// the card's resident blocks and strides over the tensor by a multiple of
// the channel period P = C / gcd(C, 8) vectors, so every vector a thread
// touches starts at the same channel: it reads its 8 bias values once, into
// registers, and computes no index modulo in the loop. That holds for any
// C, the heads' 255 and 21 channels included (a vector then wraps from one
// row's last channels into the next row's first); only the last n % 8
// elements are left to a scalar tail. When a pointer is not 16-byte
// aligned (a view into another tensor), the launcher takes the variant of
// the same kernel that moves one element at a time.
//
// Exactness: the f32 operations of the plain torch version in its order,
// with _rn intrinsics so that nvcc contracts no multiply and add into an
// FMA; leaky and identity equal it bit for bit; mish calls tanhf, log1pf
// and expf, as torch's CUDA mish does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // vectors in flight per thread
constexpr int kMaxDevices = 64;

enum Act { kIdentity = 0, kLeaky = 1, kMish = 2 };

template <int kAct>
__device__ __forceinline__ float activate(float t) {
    if (kAct == kLeaky) return t > 0.f ? t : __fmul_rn(t, 0.1f);
    if (kAct == kMish) return __fmul_rn(t, tanhf(log1pf(expf(t))));
    return t;
}

template <int kAct, bool kSkip>
__device__ __forceinline__ float epilogue(__nv_bfloat16 y, float b, __nv_bfloat16 s) {
    const float out = activate<kAct>(__fadd_rn(__bfloat162float(y), b));
    return kSkip ? __fadd_rn(out, __bfloat162float(s)) : out;
}

// kVec consecutive elements as one load / store
template <int kVec>
struct Pack;
template <>
struct Pack<8> {
    using T = uint4;
};
template <>
struct Pack<1> {
    using T = __nv_bfloat16;
};

template <int kVec, int kAct, bool kSkip>
__device__ __forceinline__ typename Pack<kVec>::T apply(typename Pack<kVec>::T y, const float* b,
                                                        typename Pack<kVec>::T s) {
    typename Pack<kVec>::T out;
    const auto* yv = reinterpret_cast<const __nv_bfloat16*>(&y);
    const auto* sv = reinterpret_cast<const __nv_bfloat16*>(&s);
    auto* ov = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
        ov[j] = __float2bfloat16_rn(epilogue<kAct, kSkip>(yv[j], b[j], sv[j]));
    }
    return out;
}

// n elements; `stride` threads take part, a multiple of the channel period,
// and thread t handles vectors t, t + stride, t + 2 * stride, ...
template <int kVec, int kAct, bool kSkip>
__global__ void __launch_bounds__(kThreads)
conv_epilogue_kernel(__nv_bfloat16* __restrict__ y, const __nv_bfloat16* __restrict__ bias,
                     const __nv_bfloat16* __restrict__ skip, long long n, int c, long long stride,
                     int period) {
    using V = typename Pack<kVec>::T;
    const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (tid >= stride) return;
    const long long n_vec = n / kVec;

    // the channels of this thread's kVec lanes, the same in every vector it
    // touches (kVec * stride is a multiple of C)
    const int c0 = static_cast<int>((static_cast<long long>(kVec) * (tid % period)) % c);
    float b[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) b[j] = __bfloat162float(bias[(c0 + j) % c]);

    V* yp = reinterpret_cast<V*>(y);
    const V* sp = reinterpret_cast<const V*>(skip);
    for (long long base = tid; base < n_vec; base += kUnroll * stride) {
        V yv[kUnroll], sv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const long long v = base + u * stride;
            if (v < n_vec) {
                yv[u] = yp[v];
                if (kSkip) sv[u] = sp[v];
            }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const long long v = base + u * stride;
            if (v < n_vec) yp[v] = apply<kVec, kAct, kSkip>(yv[u], b, kSkip ? sv[u] : yv[u]);
        }
    }
    if (kVec > 1 && tid == 0) {  // the last n % kVec elements
        for (long long e = n_vec * kVec; e < n; ++e) {
            const float be = __bfloat162float(bias[e % c]);
            y[e] = __float2bfloat16_rn(epilogue<kAct, kSkip>(y[e], be, kSkip ? skip[e] : y[e]));
        }
    }
}

int gcd(int a, int b) {
    while (b) {
        const int t = a % b;
        a = b;
        b = t;
    }
    return a;
}

// blocks of `kernel` that fit on the card at once, asked once per device
// (`cached` belongs to one instantiation: their register counts differ)
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

template <int kVec, int kAct, bool kSkip>
int launch(void* y, const void* bias, const void* skip, long long n, int c, cudaStream_t s) {
    static int cached[kMaxDevices] = {};
    auto kernel = conv_epilogue_kernel<kVec, kAct, kSkip>;
    const int resident = resident_blocks(kernel, cached);
    if (resident <= 0) return static_cast<int>(cudaErrorInvalidDevice);
    const int period = c / gcd(c, kVec);  // vectors after which the channels repeat
    const long long n_vec = n / kVec;
    const long long per_block = static_cast<long long>(kThreads) * kUnroll;
    long long blocks = (n_vec + per_block - 1) / per_block;
    if (blocks > resident) blocks = resident;
    const long long at_least = (period + kThreads - 1) / kThreads;  // stride >= period
    if (blocks < at_least) blocks = at_least;
    if (blocks < 1) blocks = 1;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const long long stride = blocks * kThreads / period * period;
    kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<__nv_bfloat16*>(y), static_cast<const __nv_bfloat16*>(bias),
        static_cast<const __nv_bfloat16*>(skip), n, c, stride, period);
    return static_cast<int>(cudaGetLastError());
}

template <int kVec, int kAct>
int launch_skip(void* y, const void* bias, const void* skip, long long n, int c, cudaStream_t s) {
    return skip ? launch<kVec, kAct, true>(y, bias, skip, n, c, s)
                : launch<kVec, kAct, false>(y, bias, skip, n, c, s);
}

template <int kVec>
int launch_act(void* y, const void* bias, const void* skip, long long n, int c, int act,
               cudaStream_t s) {
    switch (act) {
        case kIdentity: return launch_skip<kVec, kIdentity>(y, bias, skip, n, c, s);
        case kLeaky: return launch_skip<kVec, kLeaky>(y, bias, skip, n, c, s);
        case kMish: return launch_skip<kVec, kMish>(y, bias, skip, n, c, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// y (rows, C) bf16, written in place; bias (C,) bf16; skip (rows, C) bf16 or
// null, not overlapping y; act 0 identity, 1 leaky_relu(0.1), 2 mish.
// 16-byte vectors when y and skip are 16-byte aligned, one element at a
// time otherwise. Returns cudaGetLastError().
extern "C" int conv_epilogue_launch(void* y, const void* bias, const void* skip, long long rows,
                                    int c, int act, void* stream) {
    if (rows < 0 || c <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const long long n = rows * c;
    if (n == 0) return static_cast<int>(cudaSuccess);
    const auto s = static_cast<cudaStream_t>(stream);
    const bool vec = aligned16(y) && (skip == nullptr || aligned16(skip));
    return vec ? launch_act<8>(y, bias, skip, n, c, act, s)
               : launch_act<1>(y, bias, skip, n, c, act, s);
}
