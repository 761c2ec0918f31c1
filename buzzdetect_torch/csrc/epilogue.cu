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

const char* bz_epilogue_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
