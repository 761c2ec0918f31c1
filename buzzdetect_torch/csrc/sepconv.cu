// YAMNet depthwise-separable conv stack (fused_front / fused_tail).
//
// Replaces the TPU kernel buzzdetect_tpu/ops/pallas_conv.py::_tail_kernel as
// launched by fused_front (layers 2-7 with plain_through=8) and fused_tail
// (layers 8-14 + global average pooling; or any sep-layer range without
// pooling, e.g. layers 4-7).
//
// Each separable layer is: depthwise 3x3 (TF-SAME padding) + bias + ReLU,
// then pointwise 1x1 (C -> F) + bias + ReLU, on NHWC f32 activations.
//
// Three modes of the pointwise product, as the TPU kernel's compute_dtype
// and precision select them (pallas_conv.py::_pw_dot / _pack_pw):
//   HIGHEST  f32 weights and activations, exact f32;
//   BF16     bf16 weights; the activation entering the product is rounded
//            to bf16 (round to nearest even); f32 accumulate;
//   HIGH     the emulated HIGH: weights as bf16 hi and lo planes
//            (w ~= hi + lo), the activation split the same way on the fly
//            (a_hi = bf16(a), a_lo = bf16(a - a_hi)), and the product
//            a_hi*w_hi + a_hi*w_lo + a_lo*w_hi with f32 accumulate.
// The depthwise taps, biases, ReLU and pooling stay f32 in every mode. A
// product of two bf16 values is exact in f32, so FFMA on bf16-rounded
// values computes exactly the products the TPU's one-pass bf16 products
// compute; only the order of the f32 sums differs. Weights stay bf16 in
// device memory (half the bytes); the shared-memory tiles hold the
// bf16-rounded values as f32, so the inner loop is the same FFMA loop in
// every mode.
//
// Bound on an H100 SXM. One 200 s chunk is 209 patches; the front does
// 26.7 M MAC per patch and the tail 41.5 M, so ~11.2 and ~17.3 GFLOP per
// chunk, against tens of MB of compulsory traffic (~41 MB of layer-1
// activations in, ~11 MB of tail weights). At the card's 67 TFLOP/s
// non-tensor f32 peak that is ~0.17 ms and ~0.26 ms: the stack is bound by
// f32 FFMA throughput, not by memory. (The bf16 and HIGH modes are bound by
// the same FFMA work here: one and three products per multiply-add; the
// tensor cores, which would bound them lower, are later work.)
//
// What the design does about it. The pointwise product is >95% of the
// operations, so each layer is one launch of a tiled FFMA matrix product
// (128 or 64 positions x 64 output channels per block, 8x4 or 4x4 outputs
// per thread fed by float4 shared-memory reads, K staged through shared
// memory in chunks of 8 input channels, two blocks per SM). The
// depthwise 3x3 for a K chunk is computed straight into the shared-memory
// A tile, so the depthwise output never reaches device memory; only the
// layer's output does. Exact f32: FFMA only, no TF32, no tensor cores,
// and every output is one thread's sum in a fixed order, with no atomics,
// so results are identical from run to run. Pooling is a second small
// kernel that sums the spatial positions in a fixed order.
//
// Padding. TF-SAME at stride 2 on even input pads bottom/right only, so
// output (ho, wo) is centred on input (2*ho + 1, 2*wo + 1); at stride 1 it
// is centred on (ho, wo). The host passes the centre offset per axis
// (off = 1 - pad_before).
//
// Plain C interface, loaded with ctypes; every function returns a
// cudaError_t code (0 = success) and launches on the given stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// A block owns BM output positions (128, or 64 where 128 would leave the
// card with fewer than two blocks per SM) x BN output channels.
constexpr int BN = 64;   // output channels per block
constexpr int BK = 8;    // input channels per K chunk
constexpr int NT = 256;  // threads per block: 16 x 16
constexpr int TN = BN / 16;  // 4 output channels per thread
// As rows padded by 4 floats: the depthwise staging stores hit 32 distinct
// banks, and every row stays 16-byte aligned for the float4 reads
constexpr int APAD = 4;
constexpr int DIMS = 9;  // ints per layer descriptor on the host side

enum Mode { HIGHEST = 0, BF16 = 1, HIGH = 2 };

struct Layer {
    const float* dw;    // (9, C) depthwise taps, tap t = (dy+1)*3 + (dx+1)
    const float* dw_b;  // (C,)
    const void* pw;     // (C, F) pointwise, row-major: f32 (HIGHEST), bf16
                        // (BF16), or bf16 hi then lo planes, (2, C, F) (HIGH)
    const float* pw_b;  // (F,)
    int h, w, c, f, stride, ho, wo, off_h, off_w;
};

__device__ __forceinline__ float bf16_round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

template <int BM, int MODE>
__global__ void __launch_bounds__(NT, 2)
sep_layer_kernel(const float* __restrict__ x, float* __restrict__ y,
                 const Layer L, const int m_total) {
    constexpr int TM = BM / 16;             // output positions per thread
    constexpr int DW_SLOTS = BM * BK / NT;  // depthwise values per chunk
    constexpr int NP = MODE == HIGH ? 2 : 1;  // operand planes: hi, lo
    __shared__ __align__(16) float As[NP][BK][BM + APAD];  // depthwise out
    __shared__ __align__(16) float Bs[NP][BK][BN];         // pointwise w

    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
    const int hwo = L.ho * L.wo;

    // depthwise staging: each thread computes channel kk of every K chunk
    // at positions tid / BK + j * (NT / BK), so 8 neighbouring threads read
    // 8 neighbouring channels of one input pixel. Positions are fixed
    // across K chunks; pix is the centre pixel's offset.
    const int kk = tid % BK;
    long long pix[DW_SLOTS];
    int ch[DW_SLOTS], cw[DW_SLOTS];
    bool live[DW_SLOTS];
#pragma unroll
    for (int j = 0; j < DW_SLOTS; ++j) {
        const int m = m0 + tid / BK + j * (NT / BK);
        live[j] = m < m_total;
        const int mm = live[j] ? m : 0;
        const int b = mm / hwo, r = mm % hwo;
        ch[j] = (r / L.wo) * L.stride + L.off_h;
        cw[j] = (r % L.wo) * L.stride + L.off_w;
        pix[j] = (((long long)b * L.h + ch[j]) * L.w + cw[j]) * L.c;
    }
    // pointwise staging: one float2 of the (BK, BN) weight chunk per thread
    const int pk = tid / (BN / 2), pn = (tid % (BN / 2)) * 2;

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < L.c; k0 += BK) {
        const int c = k0 + kk;
        float w[9];
#pragma unroll
        for (int t = 0; t < 9; ++t) w[t] = L.dw[t * L.c + c];
        const float bias = L.dw_b[c];
#pragma unroll
        for (int j = 0; j < DW_SLOTS; ++j) {
            float v = 0.f;
            if (live[j]) {
                const float* xp = x + pix[j] + c;
                // centre tap first, then the others in tap order, as the
                // TPU kernel accumulates them
                float a = xp[0] * w[4];
#pragma unroll
                for (int t = 0; t < 9; ++t) {
                    if (t == 4) continue;
                    const int dy = t / 3 - 1, dx = t % 3 - 1;
                    const int ih = ch[j] + dy, iw = cw[j] + dx;
                    if (ih >= 0 && ih < L.h && iw >= 0 && iw < L.w)
                        a = fmaf(xp[(dy * L.w + dx) * L.c], w[t], a);
                }
                v = fmaxf(a + bias, 0.f);
            }
            const int pos = tid / BK + j * (NT / BK);
            if (MODE == HIGHEST) {
                As[0][kk][pos] = v;
            } else {
                const float hi = bf16_round(v);
                As[0][kk][pos] = hi;
                if (MODE == HIGH) As[NP - 1][kk][pos] = bf16_round(v - hi);
            }
        }
        const long long w_off = (long long)(k0 + pk) * L.f + n0 + pn;
        if (MODE == HIGHEST) {
            *reinterpret_cast<float2*>(&Bs[0][pk][pn]) =
                *reinterpret_cast<const float2*>(
                    static_cast<const float*>(L.pw) + w_off);
        } else {
            const __nv_bfloat16* pw = static_cast<const __nv_bfloat16*>(L.pw);
#pragma unroll
            for (int p = 0; p < NP; ++p)
                *reinterpret_cast<float2*>(&Bs[p][pk][pn]) =
                    __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                        pw + (long long)p * L.c * L.f + w_off));
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < BK; ++k) {
            float a[NP][TM], b[NP][TN];
#pragma unroll
            for (int p = 0; p < NP; ++p) {
#pragma unroll
                for (int q = 0; q < TM; q += 4) {
                    const float4 v = *reinterpret_cast<const float4*>(
                        &As[p][k][ty * TM + q]);
                    a[p][q] = v.x; a[p][q + 1] = v.y;
                    a[p][q + 2] = v.z; a[p][q + 3] = v.w;
                }
                const float4 b4 =
                    *reinterpret_cast<const float4*>(&Bs[p][k][tx * TN]);
                b[p][0] = b4.x; b[p][1] = b4.y; b[p][2] = b4.z; b[p][3] = b4.w;
            }
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) {
                    acc[i][j] = fmaf(a[0][i], b[0][j], acc[i][j]);
                    if (MODE == HIGH) {  // + a_hi*w_lo + a_lo*w_hi
                        acc[i][j] = fmaf(a[0][i], b[NP - 1][j], acc[i][j]);
                        acc[i][j] = fmaf(a[NP - 1][i], b[0][j], acc[i][j]);
                    }
                }
        }
        __syncthreads();
    }

    const int n = n0 + tx * TN;
    const float4 pb = *reinterpret_cast<const float4*>(L.pw_b + n);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int m = m0 + ty * TM + i;
        if (m >= m_total) continue;
        const float4 o = make_float4(fmaxf(acc[i][0] + pb.x, 0.f),
                                     fmaxf(acc[i][1] + pb.y, 0.f),
                                     fmaxf(acc[i][2] + pb.z, 0.f),
                                     fmaxf(acc[i][3] + pb.w, 0.f));
        *reinterpret_cast<float4*>(y + (long long)m * L.f + n) = o;
    }
}

// (B, P, F) -> (B, F): mean over the P spatial positions, summed in order.
__global__ void gap_kernel(const float* __restrict__ x, float* __restrict__ y,
                           int batch, int p, int f) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)batch * f) return;
    const long long b = i / f, n = i % f;
    const float* xp = x + b * p * f + n;
    float s = 0.f;
    for (int q = 0; q < p; ++q) s += xp[(long long)q * f];
    y[i] = s / (float)p;
}

// Runs the layers in order: layer i reads the previous layer's output from
// one scratch buffer and writes the other; the last layer writes `out`
// directly, or (with gap) a scratch buffer that gap_kernel reduces to `out`.
template <int BM>
void launch_layer(int mode, dim3 grid, cudaStream_t stream, const float* in,
                  float* dst, const Layer& L, int m_total) {
    if (mode == BF16)
        sep_layer_kernel<BM, BF16><<<grid, NT, 0, stream>>>(in, dst, L,
                                                            m_total);
    else if (mode == HIGH)
        sep_layer_kernel<BM, HIGH><<<grid, NT, 0, stream>>>(in, dst, L,
                                                            m_total);
    else
        sep_layer_kernel<BM, HIGHEST><<<grid, NT, 0, stream>>>(in, dst, L,
                                                               m_total);
}

int run_stack(const float* x, float* out, float* buf0, float* buf1, int batch,
              int n_layers, const int64_t* ptrs, const int* dims, int gap,
              int mode, cudaStream_t stream) {
    if (batch <= 0 || n_layers <= 0 || mode < HIGHEST || mode > HIGH)
        return (int)cudaErrorInvalidValue;
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const float* in = x;
    float* bufs[2] = {buf0, buf1};
    Layer L{};
    for (int i = 0; i < n_layers; ++i) {
        const int* d = dims + DIMS * i;
        L.dw = reinterpret_cast<const float*>(ptrs[4 * i + 0]);
        L.dw_b = reinterpret_cast<const float*>(ptrs[4 * i + 1]);
        L.pw = reinterpret_cast<const void*>(ptrs[4 * i + 2]);
        L.pw_b = reinterpret_cast<const float*>(ptrs[4 * i + 3]);
        L.h = d[0]; L.w = d[1]; L.c = d[2]; L.f = d[3]; L.stride = d[4];
        L.ho = d[5]; L.wo = d[6]; L.off_h = d[7]; L.off_w = d[8];
        if (L.c % BK != 0 || L.f % BN != 0)
            return (int)cudaErrorInvalidValue;
        const bool last = i == n_layers - 1;
        float* dst = (last && !gap) ? out : bufs[i % 2];
        const int m_total = batch * L.ho * L.wo;
        const int tiles128 = (m_total + 127) / 128 * (L.f / BN);
        if (tiles128 >= 2 * sms)
            launch_layer<128>(mode, dim3((m_total + 127) / 128, L.f / BN),
                              stream, in, dst, L, m_total);
        else
            launch_layer<64>(mode, dim3((m_total + 63) / 64, L.f / BN),
                             stream, in, dst, L, m_total);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        in = dst;
    }
    if (gap) {
        const long long n = (long long)batch * L.f;
        const int threads = 256;
        gap_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                     stream>>>(in, out, batch, L.ho * L.wo, L.f);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

}  // namespace

extern "C" {

// A range of separable layers on NHWC f32, e.g. layers 2-7 of the front,
// (B, 48, 32, 32) -> (B, 6, 4, 512), or layers 8-14 with gap=1,
// (B, 6, 4, 512) -> (B, 1024); mode is a Mode (0 HIGHEST, 1 BF16, 2 HIGH).
int bz_sep_stack(const float* x, float* out, float* buf0, float* buf1,
                 int batch, int n_layers, const int64_t* ptrs,
                 const int* dims, int gap, int mode, void* stream) {
    return run_stack(x, out, buf0, buf1, batch, n_layers, ptrs, dims, gap,
                     mode, static_cast<cudaStream_t>(stream));
}

const char* bz_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
