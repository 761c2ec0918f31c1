// YAMNet depthwise-separable conv stack (fused_front / fused_tail), exact f32.
//
// Replaces the TPU kernel buzzdetect_tpu/ops/pallas_conv.py::_tail_kernel as
// launched by fused_front (layers 2-7 with plain_through=8) and fused_tail
// (layers 8-14 + global average pooling; or any sep-layer range without
// pooling, e.g. layers 4-7).
//
// Each separable layer is: depthwise 3x3 (TF-SAME padding) + bias + ReLU,
// then pointwise 1x1 (C -> F) + bias + ReLU, on NHWC f32 activations.
//
// Bound on an H100 SXM. One 200 s chunk is 209 patches; the front does
// 26.7 M MAC per patch and the tail 41.5 M, so ~11.2 and ~17.3 GFLOP per
// chunk, against tens of MB of compulsory traffic (~41 MB of layer-1
// activations in, ~11 MB of tail weights). At the card's 67 TFLOP/s
// non-tensor f32 peak that is ~0.17 ms and ~0.26 ms: the stack is bound by
// f32 FFMA throughput, not by memory.
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

struct Layer {
    const float* dw;    // (9, C) depthwise taps, tap t = (dy+1)*3 + (dx+1)
    const float* dw_b;  // (C,)
    const float* pw;    // (C, F) pointwise, row-major
    const float* pw_b;  // (F,)
    int h, w, c, f, stride, ho, wo, off_h, off_w;
};

template <int BM>
__global__ void __launch_bounds__(NT, 2)
sep_layer_kernel(const float* __restrict__ x, float* __restrict__ y,
                 const Layer L, const int m_total) {
    constexpr int TM = BM / 16;             // output positions per thread
    constexpr int DW_SLOTS = BM * BK / NT;  // depthwise values per chunk
    __shared__ __align__(16) float As[BK][BM + APAD];  // depthwise output
    __shared__ __align__(16) float Bs[BK][BN];         // pointwise weights

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
            As[kk][tid / BK + j * (NT / BK)] = v;
        }
        *reinterpret_cast<float2*>(&Bs[pk][pn]) =
            *reinterpret_cast<const float2*>(
                L.pw + (long long)(k0 + pk) * L.f + n0 + pn);
        __syncthreads();
#pragma unroll
        for (int k = 0; k < BK; ++k) {
            float a[TM];
#pragma unroll
            for (int q = 0; q < TM; q += 4) {
                const float4 v =
                    *reinterpret_cast<const float4*>(&As[k][ty * TM + q]);
                a[q] = v.x; a[q + 1] = v.y; a[q + 2] = v.z; a[q + 3] = v.w;
            }
            const float4 b4 = *reinterpret_cast<const float4*>(&Bs[k][tx * TN]);
            const float b[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j)
                    acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
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
int run_stack(const float* x, float* out, float* buf0, float* buf1, int batch,
              int n_layers, const int64_t* ptrs, const int* dims, int gap,
              cudaStream_t stream) {
    if (batch <= 0 || n_layers <= 0) return (int)cudaErrorInvalidValue;
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
        L.pw = reinterpret_cast<const float*>(ptrs[4 * i + 2]);
        L.pw_b = reinterpret_cast<const float*>(ptrs[4 * i + 3]);
        L.h = d[0]; L.w = d[1]; L.c = d[2]; L.f = d[3]; L.stride = d[4];
        L.ho = d[5]; L.wo = d[6]; L.off_h = d[7]; L.off_w = d[8];
        if (L.c % BK != 0 || L.f % BN != 0)
            return (int)cudaErrorInvalidValue;
        const bool last = i == n_layers - 1;
        float* dst = (last && !gap) ? out : bufs[i % 2];
        const int m_total = batch * L.ho * L.wo;
        const int tiles128 = (m_total + 127) / 128 * (L.f / BN);
        if (tiles128 >= 2 * sms) {
            const dim3 grid((m_total + 127) / 128, L.f / BN);
            sep_layer_kernel<128><<<grid, NT, 0, stream>>>(in, dst, L,
                                                           m_total);
        } else {
            const dim3 grid((m_total + 63) / 64, L.f / BN);
            sep_layer_kernel<64><<<grid, NT, 0, stream>>>(in, dst, L,
                                                          m_total);
        }
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
// (B, 6, 4, 512) -> (B, 1024).
int bz_sep_stack(const float* x, float* out, float* buf0, float* buf1,
                 int batch, int n_layers, const int64_t* ptrs,
                 const int* dims, int gap, void* stream) {
    return run_stack(x, out, buf0, buf1, batch, n_layers, ptrs, dims, gap,
                     static_cast<cudaStream_t>(stream));
}

const char* bz_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
