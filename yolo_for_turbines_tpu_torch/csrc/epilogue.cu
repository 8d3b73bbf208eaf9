// The epilogue of a folded conv in one pass, in place on the conv's bf16
// output y (NHWC memory: rows = B*H*W, C channels):
//     y[r, c] = bf16(skip[r, c] + act(float(y[r, c]) + float(bias[c])))
// with act identity, leaky_relu(0.1), mish, silu or relu, and skip
// optional; or, in the add-first order (a ResNet bottleneck's last conv,
// whose shortcut joins before its ReLU),
//     y[r, c] = bf16(act(float(y[r, c]) + float(bias[c]) + float(skip[r, c]))).
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
// The result may go elsewhere (conv_epilogue_slice_launch): into a channel
// slice of a channels_last concat buffer, out[r * pitch + c] (out the
// slice's first channel, pitch the buffer's channels), so that the concat
// needs no copy pass; with `keep`, into y as well, for a part that a later
// conv also reads (cuDNN copies a strided input to dense memory first). A
// thread's vectors lie a whole number of rows apart (kVec * stride is a
// multiple of C), so its store address advances by a fixed step and the loop
// still computes no index modulo. The 16-byte variant takes C, the slice's
// start and the pitch on 8-element boundaries (every concat part of the
// models); any other slice takes the one-element variant.
//
// Exactness: the f32 operations of the plain torch version in its order,
// with _rn intrinsics so that nvcc contracts no multiply and add into an
// FMA; leaky and identity equal it bit for bit; mish calls tanhf, log1pf
// and expf, as torch's CUDA mish does; silu is torch's CUDA silu, x / (1 +
// expf(-x)) with an IEEE division (no fast math on either side); relu is
// the plain version's where(t < 0, 0, t), so a NaN and a -0 pass as they
// are. The add-first order adds the bias, then the skip, then activates,
// each add rounded once in f32, as the plain version.
//
// K6, further down, is the same pass for an int8 conv (models/quantize.py):
// from the conv's i32 output to the next layer's s8 codes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // vectors in flight per thread
constexpr int kMaxDevices = 64;

enum Act { kIdentity = 0, kLeaky = 1, kMish = 2, kSilu = 3, kRelu = 4 };
// where the result goes: over y, into the slice, or into both
enum Out { kInPlace = 0, kSlice = 1, kBoth = 2 };
// or'd into `act`: the skip joins before the activation
constexpr int kAddFirst = 16;

template <int kAct>
__device__ __forceinline__ float activate(float t) {
    if (kAct == kLeaky) return t > 0.f ? t : __fmul_rn(t, 0.1f);
    if (kAct == kMish) return __fmul_rn(t, tanhf(log1pf(expf(t))));
    if (kAct == kSilu) return __fdiv_rn(t, __fadd_rn(1.f, expf(-t)));
    if (kAct == kRelu) return t < 0.f ? 0.f : t;
    return t;
}

template <int kAct, bool kSkip, bool kFirst = false>
__device__ __forceinline__ float epilogue(__nv_bfloat16 y, float b, __nv_bfloat16 s) {
    if (kFirst) {
        return activate<kAct>(__fadd_rn(__fadd_rn(__bfloat162float(y), b), __bfloat162float(s)));
    }
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

template <int kVec, int kAct, bool kSkip, bool kFirst = false>
__device__ __forceinline__ typename Pack<kVec>::T apply(typename Pack<kVec>::T y, const float* b,
                                                        typename Pack<kVec>::T s) {
    typename Pack<kVec>::T out;
    const auto* yv = reinterpret_cast<const __nv_bfloat16*>(&y);
    const auto* sv = reinterpret_cast<const __nv_bfloat16*>(&s);
    auto* ov = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
        ov[j] = __float2bfloat16_rn(epilogue<kAct, kSkip, kFirst>(yv[j], b[j], sv[j]));
    }
    return out;
}

// n elements; `stride` threads take part, a multiple of the channel period,
// and thread t handles vectors t, t + stride, t + 2 * stride, ...; with kOut
// other than kInPlace, out and pitch as conv_epilogue_slice_launch's
template <int kVec, int kAct, bool kSkip, bool kFirst = false, int kOut = kInPlace>
__global__ void __launch_bounds__(kThreads)
conv_epilogue_kernel(__nv_bfloat16* __restrict__ y, const __nv_bfloat16* __restrict__ bias,
                     const __nv_bfloat16* __restrict__ skip, long long n, int c, long long stride,
                     int period, __nv_bfloat16* __restrict__ out, int pitch) {
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

    // the slice: this thread's first vector lies in row kVec * tid / C, and
    // each stride moves it kVec * stride / C rows on (counted in vectors)
    const long long o0 = (kVec * tid / c * pitch + c0) / kVec;
    const long long o_step = kVec * stride / c * pitch / kVec;

    V* yp = reinterpret_cast<V*>(y);
    const V* sp = reinterpret_cast<const V*>(skip);
    V* op = reinterpret_cast<V*>(out);
    long long k = 0;  // strides from tid to base
    for (long long base = tid; base < n_vec; base += kUnroll * stride, k += kUnroll) {
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
            if (v < n_vec) {
                const V r = apply<kVec, kAct, kSkip, kFirst>(yv[u], b, kSkip ? sv[u] : yv[u]);
                if (kOut != kSlice) yp[v] = r;
                if (kOut != kInPlace) op[o0 + (k + u) * o_step] = r;
            }
        }
    }
    if (kVec > 1 && tid == 0) {  // the last n % kVec elements
        for (long long e = n_vec * kVec; e < n; ++e) {
            const float be = __bfloat162float(bias[e % c]);
            const __nv_bfloat16 r = __float2bfloat16_rn(
                epilogue<kAct, kSkip, kFirst>(y[e], be, kSkip ? skip[e] : y[e]));
            if (kOut != kSlice) y[e] = r;
            if (kOut != kInPlace) out[e / c * pitch + e % c] = r;
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

// where a launch stores its result: nothing for kInPlace
struct Dest {
    void* out;
    int pitch;
};

template <int kVec, int kAct, bool kSkip, bool kFirst, int kOut>
int launch(void* y, const void* bias, const void* skip, long long n, int c, Dest d,
           cudaStream_t s) {
    static int cached[kMaxDevices] = {};
    auto kernel = conv_epilogue_kernel<kVec, kAct, kSkip, kFirst, kOut>;
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
        static_cast<const __nv_bfloat16*>(skip), n, c, stride, period,
        static_cast<__nv_bfloat16*>(d.out), d.pitch);
    return static_cast<int>(cudaGetLastError());
}

template <int kVec, int kAct, int kOut>
int launch_skip(void* y, const void* bias, const void* skip, long long n, int c, Dest d,
                cudaStream_t s) {
    return skip ? launch<kVec, kAct, true, false, kOut>(y, bias, skip, n, c, d, s)
                : launch<kVec, kAct, false, false, kOut>(y, bias, skip, n, c, d, s);
}

// the add-first order, which only a skip makes differ from the other
template <int kVec, int kAct, int kOut>
int launch_first(void* y, const void* bias, const void* skip, long long n, int c, Dest d,
                 cudaStream_t s) {
    return skip ? launch<kVec, kAct, true, true, kOut>(y, bias, skip, n, c, d, s)
                : launch<kVec, kAct, false, false, kOut>(y, bias, skip, n, c, d, s);
}

template <int kVec, int kOut>
int launch_act(void* y, const void* bias, const void* skip, long long n, int c, int act, Dest d,
               cudaStream_t s) {
    switch (act) {
        case kIdentity: return launch_skip<kVec, kIdentity, kOut>(y, bias, skip, n, c, d, s);
        case kLeaky: return launch_skip<kVec, kLeaky, kOut>(y, bias, skip, n, c, d, s);
        case kMish: return launch_skip<kVec, kMish, kOut>(y, bias, skip, n, c, d, s);
        case kSilu: return launch_skip<kVec, kSilu, kOut>(y, bias, skip, n, c, d, s);
        case kRelu: return launch_skip<kVec, kRelu, kOut>(y, bias, skip, n, c, d, s);
        case kAddFirst | kIdentity:
            return launch_first<kVec, kIdentity, kOut>(y, bias, skip, n, c, d, s);
        case kAddFirst | kRelu: return launch_first<kVec, kRelu, kOut>(y, bias, skip, n, c, d, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// ---------------------------------------------------------------------------
// K6: an int8 conv's epilogue in one pass. From the conv's NHWC i32 output
// y (rows = B*Ho*Wo, C channels) to new s8 codes q:
//     q[r, c] = s8(clamp(rint((act(f32(y[r, c]) * d[c] [+ f32(yb[r, c]) * db[c]]
//                                  + bias[c]) [+ f32(res[r, c]) * rs]) / s_out),
//                        -127, 127))
// where yb is the second branch of a conv that reads a concat as two int8
// convs, res the s8 input of a residual block (its scale rs), d and db the
// per-channel dequant scales and s_out the output scale (a device scalar,
// read through its pointer: the caller never syncs).
//
// Replaces no TPU kernel: XLA fused the int8 conv's epilogue into its
// int32 convolution. On the card torch._int_mm writes i32 and the epilogue
// was 8 to 11 aten passes over an f32 copy (conversion, multiply, add,
// activation, residual, divide, round, clamp, narrowing), about 61 bytes
// per element. Bound on the H100: device-memory bytes, 5 per element (6
// with a residual, 9 with a second branch); a few dozen operations per
// element (leaky; mish more). Design as K5's: the grid is the card's
// resident blocks, striding by a multiple of the channel period so each
// thread keeps its lanes' d, bias (and db) in registers; a vector is 16
// elements, four 16-byte i32 loads (and one 16-byte load of the residual
// codes) and one 16-byte store of s8; kQUnroll vectors in flight per
// thread; the last n % 16 elements in a scalar tail; a one-element variant
// for pointers that are not 16-byte aligned.
//
// Exactness: the f32 operations of models/quantize.py's composition in its
// order, each rounded once (_rn intrinsics: no FMA), the division a true
// IEEE division as aten's by a 0-dim device tensor, rint for torch.round
// (ties to even), the activations as in K5: the codes equal the
// composition's bit for bit.

constexpr int kQUnroll = 2;  // 16-element vectors in flight per thread

__device__ __forceinline__ int lane4(const int4& v, int k) {
    return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// byte j of a 16-byte vector of s8 codes, sign-extended
__device__ __forceinline__ int code_at(const int4& v, int j) {
    return static_cast<int>(static_cast<unsigned>(lane4(v, j / 4)) << (24 - 8 * (j % 4))) >> 24;
}

// kVec consecutive elements of each operand, as loaded
template <int kVec>
struct QLanes;

template <>
struct QLanes<16> {
    int4 y[4], yb[4], res;

    template <bool kRes, bool kBranch>
    __device__ __forceinline__ void load(const int* y_p, const int* yb_p, const int8_t* res_p,
                                         long long e) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            y[k] = reinterpret_cast<const int4*>(y_p + e)[k];
            if (kBranch) yb[k] = reinterpret_cast<const int4*>(yb_p + e)[k];
        }
        if (kRes) res = *reinterpret_cast<const int4*>(res_p + e);
    }
    __device__ __forceinline__ int y_at(int j) const { return lane4(y[j / 4], j % 4); }
    __device__ __forceinline__ int yb_at(int j) const { return lane4(yb[j / 4], j % 4); }
    __device__ __forceinline__ int res_at(int j) const { return code_at(res, j); }

    // the 16 codes as one 16-byte store
    static __device__ __forceinline__ void store(int8_t* q_p, long long e, const int (&q)[16]) {
        unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            w[j / 4] |= (static_cast<unsigned>(q[j]) & 0xffu) << (8 * (j % 4));
        }
        *reinterpret_cast<int4*>(q_p + e) =
            make_int4(static_cast<int>(w[0]), static_cast<int>(w[1]), static_cast<int>(w[2]),
                      static_cast<int>(w[3]));
    }
};

template <>
struct QLanes<1> {
    int y, yb, res;

    template <bool kRes, bool kBranch>
    __device__ __forceinline__ void load(const int* y_p, const int* yb_p, const int8_t* res_p,
                                         long long e) {
        y = y_p[e];
        if (kBranch) yb = yb_p[e];
        if (kRes) res = res_p[e];
    }
    __device__ __forceinline__ int y_at(int) const { return y; }
    __device__ __forceinline__ int yb_at(int) const { return yb; }
    __device__ __forceinline__ int res_at(int) const { return res; }
    static __device__ __forceinline__ void store(int8_t* q_p, long long e, const int (&q)[1]) {
        q_p[e] = static_cast<int8_t>(q[0]);
    }
};

template <int kAct, bool kRes, bool kBranch>
__device__ __forceinline__ int requant(int y, float d, int yb, float db, float b, int res,
                                       float rs, float s_out) {
    float t = __fmul_rn(__int2float_rn(y), d);
    if (kBranch) t = __fadd_rn(t, __fmul_rn(__int2float_rn(yb), db));
    t = activate<kAct>(__fadd_rn(t, b));
    if (kRes) t = __fadd_rn(t, __fmul_rn(__int2float_rn(res), rs));
    t = fminf(fmaxf(rintf(__fdiv_rn(t, s_out)), -127.f), 127.f);
    return __float2int_rn(t);
}

// n elements; `stride` threads take part, a multiple of the channel period,
// and thread t handles vectors t, t + stride, t + 2 * stride, ...
template <int kVec, int kAct, bool kRes, bool kBranch>
__global__ void __launch_bounds__(kThreads)
int8_epilogue_kernel(const int* __restrict__ y, const int* __restrict__ yb,
                     const int8_t* __restrict__ res, int8_t* __restrict__ q,
                     const float* __restrict__ d, const float* __restrict__ db,
                     const float* __restrict__ bias, const float* __restrict__ s_out_p,
                     const float* __restrict__ rs_p, long long n, int c, long long stride,
                     int period) {
    const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (tid >= stride) return;
    const long long n_vec = n / kVec;
    const float s_out = *s_out_p;
    const float rs = kRes ? *rs_p : 0.f;

    // this thread's lanes' channels, the same in every vector it touches
    const int c0 = static_cast<int>((static_cast<long long>(kVec) * (tid % period)) % c);
    float dv[kVec], dbv[kVec], bv[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
        const int ch = (c0 + j) % c;
        dv[j] = d[ch];
        bv[j] = bias[ch];
        dbv[j] = kBranch ? db[ch] : 0.f;
    }

    for (long long base = tid; base < n_vec; base += kQUnroll * stride) {
        QLanes<kVec> in[kQUnroll];
#pragma unroll
        for (int u = 0; u < kQUnroll; ++u) {
            const long long v = base + u * stride;
            if (v < n_vec) in[u].template load<kRes, kBranch>(y, yb, res, v * kVec);
        }
#pragma unroll
        for (int u = 0; u < kQUnroll; ++u) {
            const long long v = base + u * stride;
            if (v >= n_vec) continue;
            int out[kVec];
#pragma unroll
            for (int j = 0; j < kVec; ++j) {
                out[j] = requant<kAct, kRes, kBranch>(
                    in[u].y_at(j), dv[j], kBranch ? in[u].yb_at(j) : 0, dbv[j], bv[j],
                    kRes ? in[u].res_at(j) : 0, rs, s_out);
            }
            QLanes<kVec>::store(q, v * kVec, out);
        }
    }
    if (kVec > 1 && tid == 0) {  // the last n % kVec elements
        for (long long e = n_vec * kVec; e < n; ++e) {
            const int ch = static_cast<int>(e % c);
            q[e] = static_cast<int8_t>(requant<kAct, kRes, kBranch>(
                y[e], d[ch], kBranch ? yb[e] : 0, kBranch ? db[ch] : 0.f, bias[ch],
                kRes ? res[e] : 0, rs, s_out));
        }
    }
}

struct Int8EpilogueArgs {
    const void *y, *yb, *res;
    void* q;
    const void *d, *db, *bias, *s_out, *rs;
    long long n;
    int c;
};

template <int kVec, int kAct, bool kRes, bool kBranch>
int launch_int8(const Int8EpilogueArgs& a, cudaStream_t s) {
    static int cached[kMaxDevices] = {};
    auto kernel = int8_epilogue_kernel<kVec, kAct, kRes, kBranch>;
    const int resident = resident_blocks(kernel, cached);
    if (resident <= 0) return static_cast<int>(cudaErrorInvalidDevice);
    const int period = a.c / gcd(a.c, kVec);  // vectors after which the channels repeat
    const long long n_vec = a.n / kVec;
    const long long per_block = static_cast<long long>(kThreads) * kQUnroll;
    long long blocks = (n_vec + per_block - 1) / per_block;
    if (blocks > resident) blocks = resident;
    const long long at_least = (period + kThreads - 1) / kThreads;  // stride >= period
    if (blocks < at_least) blocks = at_least;
    if (blocks < 1) blocks = 1;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const long long stride = blocks * kThreads / period * period;
    kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const int*>(a.y), static_cast<const int*>(a.yb),
        static_cast<const int8_t*>(a.res), static_cast<int8_t*>(a.q),
        static_cast<const float*>(a.d), static_cast<const float*>(a.db),
        static_cast<const float*>(a.bias), static_cast<const float*>(a.s_out),
        static_cast<const float*>(a.rs), a.n, a.c, stride, period);
    return static_cast<int>(cudaGetLastError());
}

template <int kVec, int kAct>
int launch_int8_operands(const Int8EpilogueArgs& a, cudaStream_t s) {
    if (a.res && a.yb) return launch_int8<kVec, kAct, true, true>(a, s);
    if (a.res) return launch_int8<kVec, kAct, true, false>(a, s);
    if (a.yb) return launch_int8<kVec, kAct, false, true>(a, s);
    return launch_int8<kVec, kAct, false, false>(a, s);
}

template <int kVec>
int launch_int8_act(const Int8EpilogueArgs& a, int act, cudaStream_t s) {
    switch (act) {
        case kLeaky: return launch_int8_operands<kVec, kLeaky>(a, s);
        case kMish: return launch_int8_operands<kVec, kMish>(a, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// y (rows, C) bf16, written in place; bias (C,) bf16; skip (rows, C) bf16 or
// null, not overlapping y; act 0 identity, 1 leaky_relu(0.1), 2 mish, 3 silu,
// 4 relu, with kAddFirst (16) or'd in for the add-first order (identity and
// relu).
// 16-byte vectors when y and skip are 16-byte aligned, one element at a
// time otherwise. Returns cudaGetLastError().
extern "C" int conv_epilogue_launch(void* y, const void* bias, const void* skip, long long rows,
                                    int c, int act, void* stream) {
    if (rows < 0 || c <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const long long n = rows * c;
    if (n == 0) return static_cast<int>(cudaSuccess);
    const auto s = static_cast<cudaStream_t>(stream);
    const bool vec = aligned16(y) && (skip == nullptr || aligned16(skip));
    const Dest d{nullptr, 0};
    return vec ? launch_act<8, kInPlace>(y, bias, skip, n, c, act, d, s)
               : launch_act<1, kInPlace>(y, bias, skip, n, c, act, d, s);
}

// The same epilogue with its result stored into a channel slice of a
// channels_last buffer: out[r * pitch + c] for row r and channel c < C, out
// the slice's first element (the buffer's start plus the slice's channel
// offset), pitch >= C the buffer's channels; the slice overlaps neither y
// nor skip. With keep != 0 the result goes into y as well, else y is only
// read. 16-byte vectors when y, skip and out are 16-byte aligned and C and
// pitch multiples of 8, one element at a time otherwise. Returns
// cudaGetLastError().
extern "C" int conv_epilogue_slice_launch(void* y, const void* bias, const void* skip, void* out,
                                          long long rows, int c, int pitch, int keep, int act,
                                          void* stream) {
    if (rows < 0 || c <= 0 || pitch < c || out == nullptr) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long n = rows * c;
    if (n == 0) return static_cast<int>(cudaSuccess);
    const auto s = static_cast<cudaStream_t>(stream);
    const bool vec = aligned16(y) && (skip == nullptr || aligned16(skip)) && aligned16(out) &&
                     c % 8 == 0 && pitch % 8 == 0;
    const Dest d{out, pitch};
    if (keep) {
        return vec ? launch_act<8, kBoth>(y, bias, skip, n, c, act, d, s)
                   : launch_act<1, kBoth>(y, bias, skip, n, c, act, d, s);
    }
    return vec ? launch_act<8, kSlice>(y, bias, skip, n, c, act, d, s)
               : launch_act<1, kSlice>(y, bias, skip, n, c, act, d, s);
}

// K6. y (rows, C) i32; yb (rows, C) i32 or null (the second branch, with
// db (C,) f32); res (rows, C) s8 or null (with rs, a device f32 scalar);
// q (rows, C) s8, written, overlapping no input; d, bias (C,) f32; s_out a
// device f32 scalar; act 1 leaky_relu(0.1), 2 mish. 16-element vectors when
// y, yb, res and q are 16-byte aligned, one element at a time otherwise.
// Returns cudaGetLastError().
extern "C" int int8_epilogue_launch(const void* y, const void* yb, const void* res, void* q,
                                    const void* d, const void* db, const void* bias,
                                    const void* s_out, const void* rs, long long rows, int c,
                                    int act, void* stream) {
    if (rows < 0 || c <= 0 || (yb && !db) || (res && !rs)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Int8EpilogueArgs a{y, yb, res, q, d, db, bias, s_out, rs, rows * c, c};
    if (a.n == 0) return static_cast<int>(cudaSuccess);
    const auto s = static_cast<cudaStream_t>(stream);
    const bool vec = aligned16(y) && aligned16(q) && (yb == nullptr || aligned16(yb)) &&
                     (res == nullptr || aligned16(res));
    return vec ? launch_int8_act<16>(a, act, s) : launch_int8_act<1>(a, act, s);
}
