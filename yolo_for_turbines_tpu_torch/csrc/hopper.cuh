// What the wgmma + TMA kernels of this directory share (resblock.cu,
// resblock_int8.cu, conv_int8.cu): mbarriers, the cluster barrier and distributed shared
// memory, TMA tile loads and stores, the shared-memory operand descriptor of
// wgmma in the 128-byte swizzle, and the host-side tensor-map encoder.
// Needs sm_90a. Everything is inlined or has internal linkage, so each
// translation unit carries its own copy.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is reached
                   // through the runtime's entry-point query, not linked
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

constexpr int kSmemLimit = 232448;  // what one CTA may opt into on sm_90

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers, barriers and TMA -------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
                 : "memory");
}

// Spins until the phase of the given parity has completed. A wait that
// outlasts about 10 s of SM clock traps (the launch fails) instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
    uint32_t done = 0;
    const long long start = clock64();
    while (!done) {
        if (clock64() - start > 20000000000LL) __trap();
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(smem_u32(bar)), "r"(parity)
            : "memory");
    }
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait parity for the n-th use (n = 0, 1, ...) of a ring slot's empty
// barrier: the first round finds the slot free.
__device__ __forceinline__ int empty_parity(int n, int stages) { return ((n / stages) & 1) ^ 1; }

// The first kCount threads of the CTA only (barrier 0 is __syncthreads).
template <int kCount>
__device__ __forceinline__ void named_sync() {
    asm volatile("bar.sync 1, %0;\n" ::"n"(kCount) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return r;
}

// Cluster-wide barrier in two halves: every thread of every CTA of the
// cluster arrives; a thread that waits, waits for all. Within a producer
// warp the two halves run with all 32 lanes together: a lane that arrived
// and went on with other work while others of its warp waited hung it.
__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Address of the same shared-memory offset in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_addr(const void* local, uint32_t rank) {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(remote)
                 : "r"(smem_u32(local)), "r"(rank));
    return remote;
}

// Copies `bytes` of this CTA's shared memory to the same offset in the
// partner's, completing on the partner's barrier (both given as cluster
// addresses).
__device__ __forceinline__ void copy_to_peer(uint32_t dst, const void* src, int bytes,
                                             uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(dst), "r"(smem_u32(src)), "r"(bytes), "r"(bar)
        : "memory");
}

__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar) {
    asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
                 : "memory");
}

// One 2-D tile (c0 = column, c1 = row; may be out of bounds: zero-filled).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
        : "memory");
}

// One box of an NHWC tensor seen as 4-D (channel, x, y, image).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c, int y,
                                            int img, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(0), "r"(y), "r"(img),
        "r"(smem_u32(bar))
        : "memory");
}

// An im2col box of an NHWC tensor seen as 4-D (channel, x, y, image): the
// tensor map's pixels-per-column pixels from the filter origin (x, y, img),
// walked in (x, y, image) order at the map's traversal strides inside its
// bounding box, each read at the offset (dx, dy) of one filter tap; out of
// bounds reads as zero.
__device__ __forceinline__ void tma_load_im2col_4d(void* dst, const CUtensorMap* map, int c, int x,
                                                   int y, int img, uint16_t dx, uint16_t dy,
                                                   uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4, %5}], [%6], {%7, %8};\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(x), "r"(y), "r"(img),
        "r"(smem_u32(bar)), "h"(dx), "h"(dy)
        : "memory");
}

// The store counterpart; rows outside the tensor are not written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c,
                                             int y, int img) {
    asm volatile(
        "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, %3, %4}], [%5];\n" ::
            "l"(reinterpret_cast<uint64_t>(map)),
        "r"(c), "r"(0), "r"(y), "r"(img), "r"(smem_u32(src))
        : "memory");
}

// ---- wgmma ---------------------------------------------------------------

// Shared-memory operand descriptor of a K-major tile in the 128-byte swizzle
// (as TMA writes it into a 1024-aligned region): rows of 128 bytes, 8-row
// groups 1024 bytes apart. The tile may start at any row of the region;
// stepping K by 32 bytes (16 bf16, 32 s8: one instruction's depth) adds 2, in
// the descriptor's 16-byte units, to the start address.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
    return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>(1) << 16) |             // leading offset (unused)
           (static_cast<uint64_t>(1024 >> 4) << 32) |     // stride offset: 8 rows
           (static_cast<uint64_t>(1) << 62);              // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across a
// wgmma fence or wait.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(int (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Accumulator element i of a 64xN wgmma tile (f32 or s32) lives at row
// 16 * warp + lane / 4 + 8 * ((i >> 1) & 1), column 8 * (i >> 2) + 2 * (lane & 3) + (i & 1).

// ---- host side -------------------------------------------------------------

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);
using EncodeIm2col = decltype(&cuTensorMapEncodeIm2col);

// A libcuda function by name, through the runtime's entry-point query, or
// nullptr.
static inline void* entry_point(const char* name) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? p : nullptr;
}

static inline EncodeTiled encode_tiled() {
    static const EncodeTiled fn =
        reinterpret_cast<EncodeTiled>(entry_point("cuTensorMapEncodeTiled"));
    return fn;
}

static inline EncodeIm2col encode_im2col() {
    static const EncodeIm2col fn =
        reinterpret_cast<EncodeIm2col>(entry_point("cuTensorMapEncodeIm2col"));
    return fn;
}

// A tensor of `rank` dims (dims[0] innermost, contiguous) of `elem_bytes`-wide
// elements of type `dtype`, read or written in boxes whose inner edge spans
// the swizzle's width (128 bytes unless given); out-of-bounds elements read
// as zero and are not written.
static inline bool encode(EncodeTiled fn, CUtensorMap* map, CUtensorMapDataType dtype,
                          int elem_bytes, const void* ptr, int rank, const uint64_t* dims,
                          const uint32_t* box,
                          CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
    cuuint64_t gdims[4], strides[3];
    cuuint32_t gbox[4], elem[4];
    uint64_t stride = elem_bytes;
    for (int i = 0; i < rank; ++i) {
        gdims[i] = dims[i];
        gbox[i] = box[i];
        elem[i] = 1;
        if (i > 0) strides[i - 1] = stride;
        stride *= dims[i];
    }
    return fn(map, dtype, rank, const_cast<void*>(ptr), gdims, strides, gbox, elem,
              CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
