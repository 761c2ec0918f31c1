// YAMNet's layer 1 in one pass: log-mel patches -> the NHWC activations
// that fused_front reads (models/yamnet.py: layer1, ops/layer1.py).
//
// It replaces no TPU kernel: the JAX package leaves layer 1 to XLA
// (buzzdetect_tpu/models/yamnet.py, packed_l1). It was added because the
// port ran the layer as a chain of PyTorch passes over the 328 MB output
// of a 1,667-patch chunk (pad, cuDNN's NCHW convolution, a broadcast bias
// add, ReLU, the bf16 roundings and the NHWC permute), 11-14 times the
// layer's bytes bound on the H100.
//
// What it computes, per patch: a 3x3 stride-2 convolution from one channel
// (96 x 64 log-mel frames x bands) to 32, with TF-SAME padding, which at
// stride 2 on even sizes pads bottom and right only: output (ho, wo) reads
// input rows 2ho..2ho+2 and columns 2wo..2wo+2, and row 96 and column 64
// are zero. Then the bias, then ReLU. Output (B, 48, 32, 32) f32, NHWC.
//
// Arithmetic, fixed whatever the batch or the launch: the nine products
// x[2ho+ky][2wo+kx] * w[c][ky][kx], each rounded to f32, summed in f32 in
// the order ky = 0..2, kx = 0..2 (ky outer), starting from the first
// product; then + bias[c]; then ReLU (v < 0 -> 0, a NaN kept). FMUL and
// FADD are written as intrinsics, so the compiler contracts nothing into
// FFMA, and ops/layer1.replay repeats the same steps in PyTorch bit for
// bit. Mode BF16 rounds each patch value and each tap to bf16 (nearest,
// ties to even) as it is staged; a bf16 x bf16 product is exact in f32, so
// only the sum order differs from a convolution's; the sum stays f32, and
// the output is rounded to bf16 after ReLU and stored as f32, as
// fused_front takes it. No atomics: a patch's output depends on its input
// alone.
//
// Bound on an H100 SXM: bytes. A patch reads 24,576 bytes and writes
// 196,608 (1.47 GFLOP against 369 MB a 1,667-patch chunk, 4 FLOP a byte,
// far below the f32 ridge of ~20), so 0.110 ms a chunk at 3.35 TB/s, the
// writes 89% of it. The design spends nothing on the bytes but the
// compulsory ones and writes them whole:
//   - a block of NT = 256 threads owns one patch and a band of R output
//     rows (R = 8, 4, 2 or 1, chosen per launch in ops/layer1.band_rows so
//     that a batch of 5 fills the card as well as a batch of 1,667 does);
//     it stages its 2R + 1 input rows in shared memory with 16-byte loads
//     (rounded there in mode BF16; the zero row and column of the padding
//     beside them), and the 9 x 32 taps transposed to tap-major with the
//     32 biases;
//   - thread t computes channels 4 (t % 8) .. 4 (t % 8) + 3 of position
//     wo = t / 8 of each of the band's rows, its 36 taps and 4 biases held
//     in registers, and stores the four as one float4: a warp writes 4
//     positions x 32 channels, 512 contiguous bytes, and a block one whole
//     output row a step;
//   - the input is read once from device memory and its overlap row once
//     more from the L2 per band; the output never returns to the SM.
//
// Plain C interface, loaded with ctypes; returns a cudaError_t code
// (0 = success) and launches on the given stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int H = 96, W = 64;          // a patch: frames x mel bands
constexpr int HO = 48, WO = 32, C = 32;
constexpr int TAPS = 9;
constexpr int NT = WO * C / 4;         // one output row: 256 threads
constexpr int MAX_ROWS = 8;            // output rows a block at most
constexpr int IN_ROWS = 2 * MAX_ROWS + 1;
// a staged row: 64 columns, column 64 the right padding, 16-byte aligned
constexpr int STRIDE = W + 4;

__device__ __forceinline__ float round_bf16(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool BF16>
__global__ void __launch_bounds__(NT)
layer1_kernel(const float4* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ bias, float4* __restrict__ out,
              const int rows) {
    __shared__ __align__(16) float s_x[IN_ROWS * STRIDE];
    __shared__ __align__(16) float s_w[TAPS * C];
    __shared__ __align__(16) float s_b[C];
    const int bands = HO / rows;
    const int b = blockIdx.x / bands;
    const int h0 = (blockIdx.x - b * bands) * rows;
    const int t = threadIdx.x;

    // the taps, OIHW (32, 1, 3, 3), as [tap][channel]; the biases
    for (int i = t; i < TAPS * C; i += NT) {
        const float v = __ldg(w + i);
        s_w[(i % TAPS) * C + i / TAPS] = BF16 ? round_bf16(v) : v;
    }
    if (t < C)
        s_b[t] = __ldg(bias + t);
    // input rows 2 h0 .. 2 h0 + 2R; row 96 (the bottom padding) is zero
    const int in_rows = 2 * rows + 1;
    const float4* const src = x + ((size_t)b * H + 2 * h0) * (W / 4);
    for (int i = t; i < in_rows * (W / 4); i += NT) {
        const int r = i / (W / 4), q = i - r * (W / 4);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (2 * h0 + r < H) {
            v = __ldg(src + i);
            if (BF16)
                v = make_float4(round_bf16(v.x), round_bf16(v.y),
                                round_bf16(v.z), round_bf16(v.w));
        }
        *reinterpret_cast<float4*>(s_x + r * STRIDE + 4 * q) = v;
    }
    if (t < in_rows)
        s_x[t * STRIDE + W] = 0.f;      // column 64: the right padding
    __syncthreads();

    const int cq = t % (C / 4), wo = t / (C / 4);
    float4 k[TAPS];
#pragma unroll
    for (int j = 0; j < TAPS; ++j)
        k[j] = *reinterpret_cast<const float4*>(s_w + j * C + 4 * cq);
    const float4 bb = *reinterpret_cast<const float4*>(s_b + 4 * cq);
    float4* dst = out + (((size_t)b * HO + h0) * WO + wo) * (C / 4) + cq;
    for (int r = 0; r < rows; ++r) {
        const float* const xr = s_x + 2 * r * STRIDE + 2 * wo;
        float4 acc;
#pragma unroll
        for (int j = 0; j < TAPS; ++j) {
            const float v = xr[(j / 3) * STRIDE + j % 3];
            const float4 p = make_float4(
                __fmul_rn(v, k[j].x), __fmul_rn(v, k[j].y),
                __fmul_rn(v, k[j].z), __fmul_rn(v, k[j].w));
            if (j == 0)
                acc = p;
            else
                acc = make_float4(__fadd_rn(acc.x, p.x),
                                  __fadd_rn(acc.y, p.y),
                                  __fadd_rn(acc.z, p.z),
                                  __fadd_rn(acc.w, p.w));
        }
        float y[4] = {__fadd_rn(acc.x, bb.x), __fadd_rn(acc.y, bb.y),
                      __fadd_rn(acc.z, bb.z), __fadd_rn(acc.w, bb.w)};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            y[c] = y[c] < 0.f ? 0.f : y[c];
            if (BF16)
                y[c] = round_bf16(y[c]);
        }
        dst[(size_t)r * WO * (C / 4)] = make_float4(y[0], y[1], y[2], y[3]);
    }
}

}  // namespace

extern "C" {

// x: (batch, 96, 64) f32 patches; w: (32, 1, 3, 3) f32 taps; bias: (32)
// f32; out: (batch, 48, 32, 32) f32. rows: output rows a block (1, 2, 4
// or 8); bf16: 0 exact f32, 1 bf16 operands and output. Every pointer
// 16-byte aligned.
int bz_layer1(const void* x, const void* w, const void* bias, void* out,
              int batch, int rows, int bf16, void* stream) {
    if (batch <= 0 || (rows != 1 && rows != 2 && rows != 4 && rows != 8) ||
        (long long)batch * (HO / rows) >= (1LL << 31) ||
        (bf16 != 0 && bf16 != 1) ||
        reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(bias) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(out) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned grid = (unsigned)(batch * (HO / rows));
    const float4* const xv = static_cast<const float4*>(x);
    const float* const wv = static_cast<const float*>(w);
    const float* const bv = static_cast<const float*>(bias);
    float4* const ov = static_cast<float4*>(out);
    if (bf16)
        layer1_kernel<true><<<grid, NT, 0, s>>>(xv, wv, bv, ov, rows);
    else
        layer1_kernel<false><<<grid, NT, 0, s>>>(xv, wv, bv, ov, rows);
    return (int)cudaGetLastError();
}

const char* bz_layer1_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
