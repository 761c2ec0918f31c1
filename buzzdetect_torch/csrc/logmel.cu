// Fused log-mel spectrogram, exact f32.
//
// Replaces the TPU kernel buzzdetect_tpu/ops/pallas_frontend.py::_kernel as
// launched by log_mel_spectrogram_pallas: padded f32 waveform -> per 400-
// sample frame at hop 160, the Hann-windowed real DFT (257 bins), its
// magnitude sqrt(re^2 + im^2), the (257 x 64) HTK mel product, and
// log(mel + offset). Rows of a (B, n) batch are independent waveforms.
//
// Bound on an H100 SXM. One 200 s chunk is n = 3,210,480 samples, 20,064
// frames: the dense DFT is 20,064 x 400 x 514 multiply-adds (8.25 GFLOP),
// the mel product 0.66 GFLOP, against ~13 MB of samples in and ~5 MB of
// log-mel out. At the card's 67 TFLOP/s f32 peak outside the tensor cores
// that is ~0.133 ms against ~6 us of memory time: the kernel is bound by
// f32 FFMA throughput.
//
// What the design does about it. One block owns 64 frames. It stages the
// samples those frames read (66 hop rows of 160) in shared memory once,
// with each row padded to 161 floats so that 32 lanes on 32 consecutive
// frames read 32 distinct banks. It then walks the bins in 4 chunks of 64
// (bin 256, the Nyquist bin, is computed apart by four threads per frame,
// so only the 257 real bins are computed). For a chunk, the (400 x 128)
// DFT operand (re | im of 64 bins) comes from L2 in K chunks of 80 taps
// through shared memory; each thread accumulates re and im of 2 frames x
// 8 bins with FFMA, reading its two samples conflict-free and the DFT row
// as broadcasts. The chunk's magnitudes go to shared memory, and each
// thread adds their share of the mel product to its 2 frames x 8 mel
// accumulators. The spectrum never reaches device memory; only the log-mel
// is written. Exact f32: FFMA only, IEEE sqrtf and logf, no tensor cores,
// no TF32, no cuBLAS or cuFFT; every sum runs in a fixed order, so
// results are identical from run to run.
//
// Plain C interface, loaded with ctypes; returns a cudaError_t code
// (0 = success) and launches on the given stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WINDOW = 400;   // samples per frame
constexpr int HOP = 160;      // samples between frames
constexpr int MELS = 64;      // mel bands out
constexpr int NYQ_BIN = 256;  // the last of the 257 bins, computed apart
constexpr int FT = 64;        // frames per block
constexpr int NT = 256;       // threads per block: 8 warps
constexpr int BB = 64;        // bins per chunk: 8 per warp
constexpr int NCHUNK = NYQ_BIN / BB;  // chunks covering bins 0..255
constexpr int KC = 80;        // taps per staged K chunk: WINDOW = 5 KC,
                              // HOP = 2 KC, so a K chunk never straddles
                              // a hop row
constexpr int ROWS = FT + 2;  // frame f reads hop rows f, f+1, f+2
constexpr int RS = HOP + 1;   // padded row stride (see the note above)
constexpr int S_FLOATS = (ROWS * RS + 3) / 4 * 4;  // keeps D 16-byte aligned
constexpr int D_FLOATS = KC * 2 * BB;  // one K chunk of (re | im)
constexpr int M_STRIDE = BB + 1;       // magnitude tile row stride
constexpr int NYQ_PARTS = NT / FT;     // threads per frame on bin 256
constexpr int SMEM_FLOATS = S_FLOATS + D_FLOATS + 2 * NT + FT;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;
static_assert(FT * M_STRIDE <= D_FLOATS, "magnitude tile reuses D");
static_assert(WINDOW % (NYQ_PARTS) == 0, "bin-256 taps split evenly");

// dft: (NCHUNK, WINDOW, 2 * BB), chunk c tap k = [re of bins c*BB..+BB |
//      im of the same bins]; nyq: (WINDOW, 2) = re | im of bin 256;
// mel: (257, MELS) row-major.
__global__ void __launch_bounds__(NT, 2)
logmel_kernel(const float* __restrict__ wav, float* __restrict__ out,
              const float* __restrict__ dft, const float* __restrict__ nyq,
              const float* __restrict__ mel, const long long n,
              const int n_frames, const float log_offset) {
    extern __shared__ __align__(16) float smem[];
    float* S = smem;                // (ROWS, RS) hop rows of the samples
    float* D = smem + S_FLOATS;     // DFT K chunk; then (FT, M_STRIDE) |X|
    float* P = D + D_FLOATS;        // (2, NYQ_PARTS, FT) bin-256 partials
    float* Q = P + 2 * NT;          // (FT,) |X| of bin 256

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int f0 = blockIdx.x * FT;
    const float* x = wav + (long long)blockIdx.y * n;
    const long long base = (long long)f0 * HOP;

    // the tile's samples, zero past the end (only masked frames read them)
    for (int i = tid; i < ROWS * HOP; i += NT) {
        const long long s = base + i;
        S[(i / HOP) * RS + i % HOP] = s < n ? x[s] : 0.f;
    }
    __syncthreads();

    // bin 256: frame tid % FT, taps [part * 100, part * 100 + 100)
    {
        const int f = tid % FT, part = tid / FT;
        constexpr int PART = WINDOW / NYQ_PARTS;
        float r = 0.f, im = 0.f;
        for (int k = part * PART; k < (part + 1) * PART; ++k) {
            const float a = S[(f + k / HOP) * RS + k % HOP];
            r = fmaf(a, __ldg(nyq + 2 * k), r);
            im = fmaf(a, __ldg(nyq + 2 * k + 1), im);
        }
        P[part * FT + f] = r;
        P[NT + part * FT + f] = im;
    }
    __syncthreads();
    if (tid < FT) {
        float r = 0.f, im = 0.f;
#pragma unroll
        for (int p = 0; p < NYQ_PARTS; ++p) {
            r += P[p * FT + tid];
            im += P[NT + p * FT + tid];
        }
        Q[tid] = sqrtf(r * r + im * im);
    }

    // this thread: frames lane and lane + 32 of the tile; bins (DFT phase)
    // and mel bands (mel phase) warp * 8 .. warp * 8 + 7
    float macc[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) macc[i][j] = 0.f;

    for (int c = 0; c < NCHUNK; ++c) {
        float re[2][8], im[2][8];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) re[i][j] = im[i][j] = 0.f;

        for (int q = 0; q < WINDOW / KC; ++q) {
            __syncthreads();  // every read of D (or of the |X| tile) is done
            const float4* src = reinterpret_cast<const float4*>(
                dft + ((long long)c * WINDOW + q * KC) * (2 * BB));
            float4* dst = reinterpret_cast<float4*>(D);
            for (int i = tid; i < D_FLOATS / 4; i += NT) dst[i] = src[i];
            __syncthreads();
            // taps q*KC .. q*KC+KC-1 lie in hop row q/2 from column (q%2)*KC
            const float* s0 = S + (lane + q / 2) * RS + (q % 2) * KC;
            const float* s1 = s0 + 32 * RS;
            const float* d = D + warp * 8;
#pragma unroll 4
            for (int k = 0; k < KC; ++k) {
                const float a0 = s0[k], a1 = s1[k];
                const float* dk = d + k * (2 * BB);
                const float4 r0 = *reinterpret_cast<const float4*>(dk);
                const float4 r1 = *reinterpret_cast<const float4*>(dk + 4);
                const float4 i0 = *reinterpret_cast<const float4*>(dk + BB);
                const float4 i1 =
                    *reinterpret_cast<const float4*>(dk + BB + 4);
                const float rv[8] = {r0.x, r0.y, r0.z, r0.w,
                                     r1.x, r1.y, r1.z, r1.w};
                const float iv[8] = {i0.x, i0.y, i0.z, i0.w,
                                     i1.x, i1.y, i1.z, i1.w};
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    re[0][j] = fmaf(a0, rv[j], re[0][j]);
                    re[1][j] = fmaf(a1, rv[j], re[1][j]);
                    im[0][j] = fmaf(a0, iv[j], im[0][j]);
                    im[1][j] = fmaf(a1, iv[j], im[1][j]);
                }
            }
        }
        __syncthreads();  // D is read out: reuse it as the |X| tile
        float* M = D;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
                M[(lane + 32 * i) * M_STRIDE + warp * 8 + j] =
                    sqrtf(re[i][j] * re[i][j] + im[i][j] * im[i][j]);
        __syncthreads();
        const float* mw = mel + (long long)(c * BB) * MELS + warp * 8;
        for (int b = 0; b < BB; ++b) {
            const float m0 = M[lane * M_STRIDE + b];
            const float m1 = M[(lane + 32) * M_STRIDE + b];
            const float4 w0 = __ldg(reinterpret_cast<const float4*>(
                mw + b * MELS));
            const float4 w1 = __ldg(reinterpret_cast<const float4*>(
                mw + b * MELS + 4));
            const float wv[8] = {w0.x, w0.y, w0.z, w0.w,
                                 w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                macc[0][j] = fmaf(m0, wv[j], macc[0][j]);
                macc[1][j] = fmaf(m1, wv[j], macc[1][j]);
            }
        }
    }

    // bin 256 last, as the bin order of the mel product goes
    const float* mw = mel + (long long)NYQ_BIN * MELS + warp * 8;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int f = f0 + lane + 32 * i;
        if (f >= n_frames) continue;
        const float m = Q[lane + 32 * i];
        float o[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
            o[j] = logf(fmaf(m, __ldg(mw + j), macc[i][j]) + log_offset);
        float4* dst = reinterpret_cast<float4*>(
            out + ((long long)blockIdx.y * n_frames + f) * MELS + warp * 8);
        dst[0] = make_float4(o[0], o[1], o[2], o[3]);
        dst[1] = make_float4(o[4], o[5], o[6], o[7]);
    }
}

}  // namespace

extern "C" {

// (batch, n) f32 waveforms -> (batch, n_frames, 64) log-mel, where
// n_frames = 1 + (n - 400) / 160. dft, nyq and mel as described above.
int bz_logmel(const float* wav, float* out, const float* dft,
              const float* nyq, const float* mel, int batch, long long n,
              int n_frames, float log_offset, void* stream) {
    if (batch <= 0 || batch > 65535 || n < WINDOW
            || n_frames != 1 + (n - WINDOW) / HOP)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((n_frames + FT - 1) / FT, batch);
    logmel_kernel<<<grid, NT, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
        wav, out, dft, nyq, mel, n, n_frames, log_offset);
    return (int)cudaGetLastError();
}

const char* bz_logmel_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
