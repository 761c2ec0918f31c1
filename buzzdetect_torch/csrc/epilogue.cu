// The epilogues of the Audio Spectrogram Transformer's products, each one
// pass over the product's f32 output (models/ast.py, ops/epilogue.py).
//
// It replaces no TPU kernel: the JAX package runs no transformer. It was
// added because cuBLAS's bf16 product with an f32 output takes no f32 bias,
// and PyTorch spends a pass apiece on the bias (a broadcast add that does
// not vectorise), GELU, the bf16 rounding of the next product's operand and
// the residual add: 47% of a 128-window chunk's card time on the H100,
// about 78 ms against 41 ms of products.
//
// Modes, on (rows, cols) row-major f32 y and an f32 bias of cols:
//   0  out (bf16) = bf16(y + bias)               (qkv: attention's operands)
//   1  out (bf16) = bf16(gelu(y + bias))         (fc1: fc2's operand; exact
//                                                  erf GELU in f32)
//   2  x (f32) += y + bias                       (proj, fc2: the residual)
// Each thread takes four consecutive values a step (float4 loads, cols a
// multiple of 4) over a grid-stride loop; the bias is read through the L1.
// Bound: memory (bytes 4 + 2, 4 + 2 and 4 + 4 + 4 a value in the three
// modes, at 3.35 TB/s on an H100 SXM).
//
// f32 arithmetic as PyTorch's elementwise kernels do it: the sum y + bias
// rounded once; GELU as (v * 0.5) * (1 + erf(v * sqrt(1/2))) with erff;
// x + (y + bias); bf16 rounding to nearest even.
//
// The deep-norm post-LN of BEATs' blocks (models/beats.py; bz_post_ln), a
// fourth mode of its own entry: x = LayerNorm(alpha x + (y + bias)) over
// each row, in place on the f32 residual stream, and the result also
// rounded to bf16 as the next product's operand (out_bf16; none under
// f32). One warp a row, cols = 128 V (V <= 8; 768 is 6), the row held in
// registers as V float4 a lane: the sum and the sum of squared deviations
// from the mean by warp shuffles (two passes over the registers, no
// Welford), the variance biased, (v - mean) / sqrt(var + eps) * w + b.
// Bound: memory, 4 + 4 + 4 + 2 bytes a value (y and x read, x and the bf16
// operand written); a 63,488 x 768 block (128 windows of 496 tokens) is
// 683 MB, 0.204 ms at 3.35 TB/s.
//
// Plain C interface, loaded with ctypes; returns a cudaError_t code
// (0 = success) and launches on the given stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int BIAS_BF16 = 0, BIAS_GELU_BF16 = 1, BIAS_RESIDUAL = 2;
constexpr float SQRT1_2 = 0.70710678118654752440f;

__device__ __forceinline__ float gelu(float v) {
    return v * 0.5f * (1.f + erff(v * SQRT1_2));
}

__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
}

template <int MODE>
__global__ void __launch_bounds__(NT)
epilogue_kernel(const float4* __restrict__ y, const float4* __restrict__ bias,
                void* __restrict__ out, const int quads, const int row_quads) {
    for (int i = blockIdx.x * NT + threadIdx.x; i < quads;
         i += gridDim.x * NT) {
        const float4 v = y[i];
        const float4 b = __ldg(bias + i % row_quads);
        float4 s = make_float4(__fadd_rn(v.x, b.x), __fadd_rn(v.y, b.y),
                               __fadd_rn(v.z, b.z), __fadd_rn(v.w, b.w));
        if constexpr (MODE == BIAS_RESIDUAL) {
            float4* const x = static_cast<float4*>(out) + i;
            const float4 r = *x;
            *x = make_float4(__fadd_rn(r.x, s.x), __fadd_rn(r.y, s.y),
                             __fadd_rn(r.z, s.z), __fadd_rn(r.w, s.w));
        } else {
            if constexpr (MODE == BIAS_GELU_BF16)
                s = make_float4(gelu(s.x), gelu(s.y), gelu(s.z), gelu(s.w));
            static_cast<uint2*>(out)[i] =
                make_uint2(bf16x2(s.x, s.y), bf16x2(s.z, s.w));
        }
    }
}

// rows of cols = 128 V; out_bf16 may be null
template <int V>
__global__ void __launch_bounds__(NT)
post_ln_kernel(const float4* __restrict__ y, const float4* __restrict__ bias,
               float4* __restrict__ x, const float4* __restrict__ w,
               const float4* __restrict__ b, uint2* __restrict__ out_bf16,
               const long long rows, const float alpha, const float eps) {
    constexpr int Q = 32 * V;  // float4 a row
    const int lane = threadIdx.x & 31;
    const long long row = (long long)blockIdx.x * (NT / 32) +
                          (threadIdx.x >> 5);
    if (row >= rows) return;
    const long long at = row * Q + lane;
    float4 v[V];
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
        const float4 p = y[at + 32 * k];
        const float4 c = __ldg(bias + lane + 32 * k);
        const float4 r = x[at + 32 * k];
        v[k] = make_float4(
            __fadd_rn(__fmul_rn(alpha, r.x), __fadd_rn(p.x, c.x)),
            __fadd_rn(__fmul_rn(alpha, r.y), __fadd_rn(p.y, c.y)),
            __fadd_rn(__fmul_rn(alpha, r.z), __fadd_rn(p.z, c.z)),
            __fadd_rn(__fmul_rn(alpha, r.w), __fadd_rn(p.w, c.w)));
        sum += (v[k].x + v[k].y) + (v[k].z + v[k].w);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = sum * (1.f / (4 * Q));
    float sq = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
        const float a = v[k].x - mean, c = v[k].y - mean;
        const float d = v[k].z - mean, e = v[k].w - mean;
        sq += (a * a + c * c) + (d * d + e * e);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float rstd = 1.f / sqrtf(sq * (1.f / (4 * Q)) + eps);
#pragma unroll
    for (int k = 0; k < V; ++k) {
        const float4 g = __ldg(w + lane + 32 * k);
        const float4 h = __ldg(b + lane + 32 * k);
        const float4 o = make_float4(fmaf((v[k].x - mean) * rstd, g.x, h.x),
                                     fmaf((v[k].y - mean) * rstd, g.y, h.y),
                                     fmaf((v[k].z - mean) * rstd, g.z, h.z),
                                     fmaf((v[k].w - mean) * rstd, g.w, h.w));
        x[at + 32 * k] = o;
        if (out_bf16 != nullptr)
            out_bf16[at + 32 * k] = make_uint2(bf16x2(o.x, o.y),
                                               bf16x2(o.z, o.w));
    }
}

}  // namespace

extern "C" {

// mode as above; y: (rows, cols) f32; bias: (cols) f32; out: (rows, cols)
// bf16 (modes 0, 1) or f32 x updated in place (mode 2). cols a multiple of
// 4, every pointer 16-byte aligned, rows x cols / 4 under 2^31.
int bz_epilogue(int mode, const void* y, const void* bias, void* out,
                long long rows, int cols, void* stream) {
    const long long quads = rows * (long long)cols / 4;
    if (rows <= 0 || cols <= 0 || cols % 4 != 0 || quads >= (1LL << 31) ||
        reinterpret_cast<uintptr_t>(y) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(bias) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(out) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    // enough blocks to fill the card several times over; the loop takes
    // the rest
    const int grid = (int)((quads + NT - 1) / NT < 132 * 16
                               ? (quads + NT - 1) / NT
                               : 132 * 16);
    const float4* const yv = static_cast<const float4*>(y);
    const float4* const bv = static_cast<const float4*>(bias);
    const int q = (int)quads, row_q = cols / 4;
    if (mode == BIAS_BF16)
        epilogue_kernel<BIAS_BF16><<<grid, NT, 0, s>>>(yv, bv, out, q, row_q);
    else if (mode == BIAS_GELU_BF16)
        epilogue_kernel<BIAS_GELU_BF16><<<grid, NT, 0, s>>>(yv, bv, out, q,
                                                            row_q);
    else if (mode == BIAS_RESIDUAL)
        epilogue_kernel<BIAS_RESIDUAL><<<grid, NT, 0, s>>>(yv, bv, out, q,
                                                           row_q);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

// x = LayerNorm(alpha x + (y + bias)) (w, b, eps) over each row of (rows,
// cols) f32, in place; out_bf16 (rows, cols) bf16 the same values rounded,
// or null. cols = 128 V with V in 1..8, every pointer 16-byte aligned.
int bz_post_ln(const void* y, const void* bias, void* x, const void* w,
               const void* b, void* out_bf16, long long rows, int cols,
               float alpha, float eps, void* stream) {
    const int v = cols / 128;
    if (rows <= 0 || cols % 128 != 0 || v < 1 || v > 8 ||
        rows > (long long)(NT / 32) * 2147483647LL ||
        reinterpret_cast<uintptr_t>(y) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(bias) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(b) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(out_bf16) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned grid = (unsigned)((rows + NT / 32 - 1) / (NT / 32));
#define BZ_POST_LN_CASE(V)                                                  \
    case V:                                                                 \
        post_ln_kernel<V><<<grid, NT, 0, s>>>(                              \
            static_cast<const float4*>(y), static_cast<const float4*>(bias), \
            static_cast<float4*>(x), static_cast<const float4*>(w),         \
            static_cast<const float4*>(b), static_cast<uint2*>(out_bf16),   \
            rows, alpha, eps);                                              \
        break;
    switch (v) {
        BZ_POST_LN_CASE(1)
        BZ_POST_LN_CASE(2)
        BZ_POST_LN_CASE(3)
        BZ_POST_LN_CASE(4)
        BZ_POST_LN_CASE(5)
        BZ_POST_LN_CASE(6)
        BZ_POST_LN_CASE(7)
        BZ_POST_LN_CASE(8)
    }
#undef BZ_POST_LN_CASE
    return (int)cudaGetLastError();
}

const char* bz_epilogue_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
