// Helpers shared by csrc/sepconv.cu and csrc/probe.cu: asynchronous copies
// to shared memory (cp.async), ldmatrix and mma.sync bf16 on the tensor
// cores, and the opt-in to more than 48 KB of dynamic shared memory.
// ops/_build.py hashes every csrc/*.cuh into each library's name, so an
// edited header never loads a stale library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int MAX_DEVICES = 64;

// Lets `kernel` use all the dynamic shared memory a block can have on
// `device` (past 48 KB a kernel must ask): once per device, remembered in
// the caller's `ready` flags, one array per kernel.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, int device, std::atomic<bool>* ready) {
    if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (ready[device].load()) return cudaSuccess;
    int most = 0;
    cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           device);
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err == cudaSuccess) ready[device].store(true);
    return err;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; with ok false, 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok = true) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p))
        : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p))
        : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 operands, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float4 lds4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

// Four f32 values as bf16 hi = bf16(v) and lo = bf16(v - hi) (round to
// nearest even), each plane's four bf16 stored as one 8-byte word (hi and
// lo 8-byte aligned)
__device__ __forceinline__ void split_hi_lo(float4 v, __nv_bfloat16* hi,
                                            __nv_bfloat16* lo) {
    const __nv_bfloat162 h01 = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 h23 = __floats2bfloat162_rn(v.z, v.w);
    *reinterpret_cast<uint2*>(hi) = make_uint2(bits(h01), bits(h23));
    const float2 f01 = __bfloat1622float2(h01);
    const float2 f23 = __bfloat1622float2(h23);
    *reinterpret_cast<uint2*>(lo) = make_uint2(
        bits(__floats2bfloat162_rn(v.x - f01.x, v.y - f01.y)),
        bits(__floats2bfloat162_rn(v.z - f23.x, v.w - f23.y)));
}

}  // namespace
