// Fused log-mel spectrogram by FFT, exact f32.
//
// Replaces the TPU kernel buzzdetect_tpu/ops/pallas_frontend.py::_kernel as
// launched by log_mel_spectrogram_pallas, and is the card's default
// frontend: a waveform (f32, or the int16 wire scaled by 2^-15 as it is
// loaded) -> per 400-sample frame at hop 160, the Hann-windowed 512-point
// real FFT (257 bins), its magnitude sqrt(re^2 + im^2), the dense (257 x 64)
// HTK mel product, and log(mel + offset). Rows of a (B, n) batch are
// independent waveforms.
//
// Bound on an H100 SXM. A 1,667-patch chunk (the benchmark's, 1600.335 s)
// is 160,032 frames: benchmark/roofline.frontend_flops counts 2.5 N log2 N
// flops of FFT a frame, the window, the magnitudes and the dense mel
// product (45.6 kflop a frame, 7.30 GFLOP), 0.109 ms at the 67 TFLOP/s f32
// peak, against 0.027 ms for its bytes (the int16 wire read once, the
// log-mel written once): the kernel is bound by f32 arithmetic. B = 209
// (20,064 frames, a 200 s chunk) is 0.0137 ms. The dense-DFT design this
// file held before did 8.25 GFLOP at B = 209 (0.133 ms at the same peak),
// eight times the FFT's multiply-adds; the mel product, 16,448 FMA a
// frame, is now the largest part of the work.
//
// The design, one block of NT = 4 FT threads a tile of FT frames:
//   - The FFT. A frame's 400 samples, times the periodic Hann window (built
//     on the host in float64, rounded once to f32 and halved, so that the
//     even/odd split below needs no 1/2), packed as 256 complex points
//     z[m] = u[2m] + i u[2m+1] (zero from m = 200), take a 256-point
//     complex FFT as 16 x 16: 16 threads (half a warp) own a frame; thread
//     t reads z[t + 16 j] straight from device memory (two samples a load)
//     and runs a 16-point DFT over j in registers (two radix-4 passes),
//     multiplies by W256^(t k2), and the half-warp transposes the 16 x 16
//     through 2 KB of shared memory (swizzled, so that neither side
//     conflicts), after __syncwarp alone; thread k2 then runs the 16-point
//     DFT over t and holds Z[k2 + 16 k1]. The post-twiddle X[k] = E + W512^k
//     O, with E and O from Z[k] and conj(Z[256 - k]) of the partner thread
//     (one shuffle of its 8 upper values), gives |X[k]| and |X[256 - k]| =
//     |E - W512^k O| a pair; thread 0 adds bin 128. The twiddles are the
//     host's float64 tables rounded once to f32. The magnitudes go to a
//     (257, FT + 4) tile in shared memory, bin-major; the spectrum never
//     reaches device memory. Each thread keeps the next round's samples in
//     flight while it computes this one's. FT / 4 frames a round, 4 rounds.
//   - The mel product, dense, as a GEMM from shared memory: thread (fg, bg)
//     owns 4 frames x 4 bands (one float4 of magnitudes and one of weights a
//     bin, 16 FMA); a warp spans 8 frame groups x 4 band groups where the
//     tile allows, so that each load is a broadcast of 128 or 64 bytes. The
//     mel matrix streams through a 3-stage cp.async ring of 32-bin chunks
//     over the space the transposes used; bin 256 comes last, from the L1.
//   - FT in {64, 32, 16, 8} is chosen per launch in ops/logmel.py
//     (launch_geometry, from the frame count, the batch and the SM count):
//     the largest tile whose busiest SM gets at most 1.1x the frames of the
//     best. No cluster: a block holds its frames' whole spectrum. At
//     FT = 64 a block takes 107 KB of shared memory, so two share an SM.
//
// Exact f32 on the FFMA pipes and the same bits at every shape: FFMA, FMUL
// and FADD (written as intrinsics, so that no contraction is left to the
// compiler), IEEE sqrtf and logf; no tensor cores, no TF32, no cuFFT or
// cuBLAS, no split K and no atomics. Every frame runs the same instruction
// sequence whatever FT, the launch or the batch, and each mel band is one
// fmaf chain over the bins 0..256 ascending, so a frame's log-mel depends
// on nothing but its samples.
//
// Measured (tools/logmel_geometries.py, device time from torch.profiler,
// NVIDIA H100 80GB HBM3 at 700 W): 0.264-0.279 ms for the 1,667-patch
// chunk on the int16 wire (FT = 64), 39-41% of its 0.109 ms bound, against
// ~2.0 ms for the dense-DFT design at that shape and 4.9 ms a chunk for
// the matmul frontend in the benchmark; 0.047-0.050 ms at B = 209 (28% of
// 0.0137 ms; the dense-DFT design 0.249 ms); 0.013 ms at B = 5. What holds
// it, by variants with a phase taken out: the FFT rounds and the mel
// product take about half each. The mel product runs at ~64% of the FFMA
// rate (two shared loads a 16 FMA, a barrier a ring chunk); the FFT at
// ~800 instructions a thread a frame, its transposes, shuffles and IEEE
// square roots among them. An 8 x 4 mel tile on half the threads was 5%
// faster at FT = 64 and slower at every smaller tile. Which stall holds
// each phase is not measurable there (no ncu).
//
// The Kaldi geometry (the Audio Spectrogram Transformer's fbank,
// models/ast.py; torchaudio.compliance.kaldi.fbank with htk_compat,
// use_energy off, a 'hanning' window, 128 bins, dither 0, a 10 ms shift) is
// the second instantiation of the same kernel (KIND = KALDI, bz_fbank_kaldi):
// the same frames, FFT, wire and tiles, and per frame before the window its
// own mean subtracted (a half-warp sum of the 400 samples) and a 0.97
// pre-emphasis whose first sample takes itself as the one before (a
// shuffle brings each pair the sample that precedes it); the symmetric
// Hann window (0.5 - 0.5 cos(2 pi n / 399)); the power spectrum re^2 + im^2
// in place of the magnitude; a (257 x 128) Kaldi mel matrix (20-8000 Hz,
// the Nyquist row zero) in 16-bin ring chunks, each thread 4 frames x 8
// bands; and log(max(e, floor)), then (x + shift) / divisor, AST's
// normalisation. Its work a frame is the FFT's and a product twice as
// wide: 131,072 frames (a 128-window chunk) are 8.6 GFLOP, 0.13 ms at the
// f32 peak, against 0.109 ms for its bytes (the int16 wire and the f32
// output). KIND = YAMNET compiles to the code above, unchanged.
//
// Plain C interface, loaded with ctypes; returns a cudaError_t code
// (0 = success) and launches on the given stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "ptx.cuh"

namespace {

constexpr int WINDOW = 400;   // samples per frame
constexpr int HOP = 160;      // samples between frames
constexpr int MELS = 64;      // mel bands out (YAMNet)
// the geometries: YAMNet's log-mel, and the Kaldi fbank of AST
constexpr int YAMNET = 0, KALDI = 1;
constexpr float PREEMPH = 0.97f;  // Kaldi's pre-emphasis
constexpr int BINS = 257;     // rfft bins of 512 points
constexpr int NC = 256;       // complex points of the packed FFT
constexpr int ZN = WINDOW / 2;  // nonzero packed points
constexpr int JN = (ZN + 15) / 16;  // loads a thread: j = 0..JN-1
constexpr float INT16_SCALE = 1.0f / 32768.0f;  // exact: 2^-15
// the host's tables, one tensor: half-window (400) | W256^e (256 x re, im)
// | W512^k, k < 128 (128 x re, im) | W256^(t k2) at [k2][t] (16 x 16 x re,
// im: pass 1's twiddles, so that the 16 lanes of a frame read 16
// consecutive entries)
constexpr int T_WIN = 0;
constexpr int T_W256 = WINDOW;
constexpr int T_W512 = T_W256 + 2 * NC;
constexpr int T_PASS = T_W512 + 2 * (NC / 2);
constexpr int TABLE_FLOATS = T_PASS + 2 * NC;
constexpr int RING = 3;
constexpr int W_FLOATS = 2048;  // floats of a chunk of the mel ring
static_assert(TABLE_FLOATS % 4 == 0 && W_FLOATS % 4 == 0, "16-byte copies");

// the mel product of a geometry: NM bands, NB = NM / 64 band blocks a
// thread, chunks of KB bins (bins 0..255; bin 256 is apart)
template <int KIND>
struct Mel {
    static constexpr int NM = KIND == KALDI ? 128 : MELS;
    static constexpr int NB = NM / 64;
    static constexpr int KB = W_FLOATS / NM;      // 32 (YAMNet), 16 (Kaldi)
    static constexpr int CHUNKS = (BINS - 1) / KB;
    static_assert(CHUNKS * KB == BINS - 1, "bin 256 is apart");
};

template <int FT>
struct FftTile {
    static constexpr int NT = 4 * FT;          // threads
    static constexpr int FPR = NT / 16;        // frames a round
    static constexpr int ROUNDS = FT / FPR;    // = 4
    static constexpr int MP = FT + 4;          // magnitude row stride
    static constexpr int M_FLOATS = BINS * MP;
    static constexpr int X_FLOATS = (NT / 32) * 1024;  // 2 KB a frame
    static constexpr int U_FLOATS =
        X_FLOATS > RING * W_FLOATS ? X_FLOATS : RING * W_FLOATS;
    static constexpr int SMEM = (TABLE_FLOATS + M_FLOATS + U_FLOATS) * 4;
    // the mel tile: FG frame groups x 16 band groups of 4 x 4; a warp
    // spans FGW x BGW of them
    static constexpr int FG = FT / 4;
    static constexpr int FGW = FG < 8 ? FG : 8;
    static constexpr int BGW = 32 / FGW;
    static constexpr int WF = FG / FGW;        // warps along the frames
    static_assert(FT % 8 == 0 && ROUNDS == 4, "tile");
    static_assert(MP % 4 == 0, "float4 magnitude reads");
    static_assert(SMEM <= 232448, "shared memory of one block");
};

__device__ __forceinline__ float2 lds2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
}

// (a + ib) * (wr + i wi)
__device__ __forceinline__ void cmul(float& a, float& b, float wr, float wi) {
    const float r = fmaf(a, wr, -__fmul_rn(b, wi));
    b = fmaf(a, wi, __fmul_rn(b, wr));
    a = r;
}

// 4-point DFT in place, natural order (W4 = -i)
__device__ __forceinline__ void dft4(float& r0, float& i0, float& r1,
                                     float& i1, float& r2, float& i2,
                                     float& r3, float& i3) {
    const float b0r = __fadd_rn(r0, r2), b0i = __fadd_rn(i0, i2);
    const float b1r = __fsub_rn(r0, r2), b1i = __fsub_rn(i0, i2);
    const float b2r = __fadd_rn(r1, r3), b2i = __fadd_rn(i1, i3);
    const float b3r = __fsub_rn(r1, r3), b3i = __fsub_rn(i1, i3);
    r0 = __fadd_rn(b0r, b2r), i0 = __fadd_rn(b0i, b2i);
    r2 = __fsub_rn(b0r, b2r), i2 = __fsub_rn(b0i, b2i);
    r1 = __fadd_rn(b1r, b3i), i1 = __fsub_rn(b1i, b3r);  // b1 - i b3
    r3 = __fsub_rn(b1r, b3i), i3 = __fadd_rn(b1i, b3r);  // b1 + i b3
}

// 16-point DFT of a[0..15] in place, natural order: j = j1 + 4 j2,
// k = p + 4 q; a 4-point DFT over j2 for each j1, the twiddles W16^(j1 p)
// (W16^e = W256^(16 e) from the table tw), a 4-point DFT over j1 for each
// p, and the outputs renamed from 4 p + q to p + 4 q
__device__ __forceinline__ void dft16(float (&re)[16], float (&im)[16],
                                      const float* tw) {
#pragma unroll
    for (int j1 = 0; j1 < 4; ++j1)
        dft4(re[j1], im[j1], re[j1 + 4], im[j1 + 4], re[j1 + 8], im[j1 + 8],
             re[j1 + 12], im[j1 + 12]);
    // c[j1][p] now sits at j1 + 4 p
    const float2 w1 = lds2(tw + 2 * 16), w3 = lds2(tw + 2 * 48),
                 w9 = lds2(tw + 2 * 144);
    const float h = tw[2 * 32];  // cos(pi / 4) = -sin(-pi / 4)
    cmul(re[5], im[5], w1.x, w1.y);    // (1, 1)
    cmul(re[13], im[13], w3.x, w3.y);  // (1, 3)
    cmul(re[7], im[7], w3.x, w3.y);    // (3, 1)
    cmul(re[15], im[15], w9.x, w9.y);  // (3, 3)
    {   // (1, 2) and (2, 1): W16^2 = h (1 - i)
        float a = re[9], b = im[9];
        re[9] = __fmul_rn(h, __fadd_rn(a, b)), im[9] = __fmul_rn(h, __fsub_rn(b, a));
        a = re[6], b = im[6];
        re[6] = __fmul_rn(h, __fadd_rn(a, b)), im[6] = __fmul_rn(h, __fsub_rn(b, a));
    }
    {   // (2, 3) and (3, 2): W16^6 = -h (1 + i)
        float a = re[14], b = im[14];
        re[14] = __fmul_rn(h, __fsub_rn(b, a)), im[14] = -__fmul_rn(h, __fadd_rn(a, b));
        a = re[11], b = im[11];
        re[11] = __fmul_rn(h, __fsub_rn(b, a)), im[11] = -__fmul_rn(h, __fadd_rn(a, b));
    }
    {   // (2, 2): W16^4 = -i, exact
        const float a = re[10];
        re[10] = im[10], im[10] = -a;
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
        dft4(re[4 * p], im[4 * p], re[4 * p + 1], im[4 * p + 1],
             re[4 * p + 2], im[4 * p + 2], re[4 * p + 3], im[4 * p + 3]);
    float r[16], i[16];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) r[p + 4 * q] = re[4 * p + q],
                                    i[p + 4 * q] = im[4 * p + q];
#pragma unroll
    for (int k = 0; k < 16; ++k) re[k] = r[k], im[k] = i[k];
}

// a bin's magnitude (YAMNet) or power (Kaldi)
template <int KIND>
__device__ __forceinline__ float spectral(float re, float im) {
    const float p = fmaf(re, re, __fmul_rn(im, im));
    if constexpr (KIND == KALDI) return p;
    else return sqrtf(p);
}

// Kaldi's framing of one frame's samples, held as pairs (x[j], y[j]) =
// samples (2m, 2m + 1), m = t + 16 j, by lane t of a half-warp: subtract
// the frame's mean, then y[n] -= 0.97 y[n - 1], sample 0 taking itself as
// the one before; the pairs past the frame's end stay zero
__device__ __forceinline__ void kaldi_frame(float (&x)[16], float (&y)[16],
                                            int t, int lane) {
    constexpr int JN_ = (WINDOW / 2 + 15) / 16;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < JN_; ++j) s = __fadd_rn(s, __fadd_rn(x[j], y[j]));
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
        s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    const float mean = __fdiv_rn(s, (float)WINDOW);
#pragma unroll
    for (int j = 0; j < JN_; ++j) {
        x[j] = __fsub_rn(x[j], mean);
        y[j] = __fsub_rn(y[j], mean);
    }
    // sample 2m - 1: lane t - 1's y[j], or for t = 0 lane 15's y[j - 1]
    const int src = (lane & 16) | ((t + 15) & 15);
    float up[JN_];
#pragma unroll
    for (int j = 0; j < JN_; ++j) up[j] = __shfl_sync(0xffffffffu, y[j], src);
#pragma unroll
    for (int j = 0; j < JN_; ++j) {
        const bool in = t + 16 * j < WINDOW / 2;
        const float prev = t > 0 ? up[j] : j > 0 ? up[j > 0 ? j - 1 : 0] : x[0];
        const float ny = __fsub_rn(y[j], __fmul_rn(PREEMPH, x[j]));
        const float nx = __fsub_rn(x[j], __fmul_rn(PREEMPH, prev));
        x[j] = in ? nx : 0.f;
        y[j] = in ? ny : 0.f;
    }
}

// samples 2m and 2m + 1 of a frame, one load (rows are aligned for it:
// bz_logmel refuses an odd row stride). They stay in flight, as loaded,
// until the next round reads them through as_f32. (A second, unaligned
// path selected at run time made the compiler funnel every aligned load
// of the int16 wire through one register, so that the loads of a round
// waited for each other.)
__device__ __forceinline__ float2 load_pair(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
}

__device__ __forceinline__ short2 load_pair(const short* p) {
    return __ldg(reinterpret_cast<const short2*>(p));
}

__device__ __forceinline__ float2 as_f32(float2 v) { return v; }

// the int16 wire scaled by 2^-15 (exact)
__device__ __forceinline__ float2 as_f32(short2 v) {
    return make_float2(__fmul_rn(__int2float_rn(v.x), INT16_SCALE),
                       __fmul_rn(__int2float_rn(v.y), INT16_SCALE));
}

// wav: batch rows of In, stride samples apart (even), each holding at
// least the n_frames frames' samples; out: (batch, n_frames, NM);
// tables: TABLE_FLOATS as above; mel: (257, NM) row-major. Grid: (frame
// tiles, batch). YAMNet: log(mel + log_offset); Kaldi: (log(max(mel,
// log_offset)) + shift) / divisor.
template <typename In, int FT, int KIND>
__global__ void __launch_bounds__(FftTile<FT>::NT, 2)
logmel_fft_kernel(const In* __restrict__ wav, float* __restrict__ out,
                  const float* __restrict__ tables,
                  const float* __restrict__ mel, const long long stride,
                  const int n_frames, const float log_offset,
                  const float shift, const float divisor) {
    using T = FftTile<FT>;
    using W = Mel<KIND>;
    constexpr int NT = T::NT, MP = T::MP, NM = W::NM, NB = W::NB;
    constexpr int KB = W::KB;
    extern __shared__ __align__(16) float smem[];
    float* const TB = smem;                        // the tables
    float* const M = smem + TABLE_FLOATS;          // (BINS, MP) |X|
    float* const U = M + T::M_FLOATS;              // transposes, then the
                                                   // mel ring
    const int tid = threadIdx.x, lane = tid & 31;
    const int f0 = blockIdx.x * FT;
    const In* const x = wav + (long long)blockIdx.y * stride;

    for (int i = tid; i < TABLE_FLOATS / 4; i += NT)
        cp_async16(TB + 4 * i, tables + 4 * i);
    cp_async_commit();

    // the FFT: thread t of the half-warp that owns frame slot r * FPR + sub
    const int t = tid & 15, sub = tid >> 4;
    float* const X = U + (tid >> 5) * 1024 + (lane >> 4) * 512;
    using Raw = decltype(load_pair(x));
    auto load_round = [&](Raw (&z)[JN], int r) {
        const int frame = f0 + r * T::FPR + sub;
        const In* const src = x + (long long)frame * HOP + 2 * t;
#pragma unroll
        for (int j = 0; j < JN; ++j)
            z[j] = frame < n_frames && t + 16 * j < ZN
                       ? load_pair(src + 32 * j)
                       : Raw{};
    };
    Raw cur[JN];
    load_round(cur, 0);
    cp_async_wait<0>();
    __syncthreads();

#pragma unroll 1
    for (int r = 0; r < T::ROUNDS; ++r) {
        const int slot = r * T::FPR + sub;
        Raw nxt[JN];
        if (r + 1 < T::ROUNDS) load_round(nxt, r + 1);
        float zr[16], zi[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            if (j < JN) {
                const float2 v = as_f32(cur[j]);
                zr[j] = v.x, zi[j] = v.y;
            } else {
                zr[j] = zi[j] = 0.f;
            }
        }
        if constexpr (KIND == KALDI) kaldi_frame(zr, zi, t, lane);
#pragma unroll
        for (int j = 0; j < JN; ++j) {
            // past the window's end the samples are zero; any table entry
            // will do
            const int m = t + 16 * j < ZN ? t + 16 * j : 0;
            const float2 h = lds2(TB + T_WIN + 2 * m);
            zr[j] = __fmul_rn(zr[j], h.x);
            zi[j] = __fmul_rn(zi[j], h.y);
        }
        dft16(zr, zi, TB + T_W256);
#pragma unroll
        for (int k2 = 1; k2 < 16; ++k2) {
            const float2 w = lds2(TB + T_PASS + 2 * (16 * k2 + t));
            cmul(zr[k2], zi[k2], w.x, w.y);
        }
        // row k2, column t: the 16-byte chunk t / 2 of row k2 at t / 2 ^ (k2
        // % 8), so that 8 lanes reading 8 rows hit 8 bank quads
        __syncwarp();  // the last round's reads of X are done
#pragma unroll
        for (int k2 = 0; k2 < 16; ++k2)
            *reinterpret_cast<float2*>(X + k2 * 32 + (((t >> 1) ^ (k2 & 7)) << 2) +
                                       ((t & 1) << 1)) =
                make_float2(zr[k2], zi[k2]);
        __syncwarp();
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            const float4 v = lds4(X + t * 32 + ((c ^ (t & 7)) << 2));
            zr[2 * c] = v.x, zi[2 * c] = v.y;
            zr[2 * c + 1] = v.z, zi[2 * c + 1] = v.w;
        }
        dft16(zr, zi, TB + T_W256);  // z[k1] = Z[t + 16 k1]
        // Z[256 - t - 16 k1]: the partner thread (16 - t) % 16's value
        // 15 - k1, or for t = 0 this thread's (16 - k1) % 16
        const int src = (lane & 16) | ((16 - t) & 15);
        float pr[8], pi[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            pr[i] = __shfl_sync(0xffffffffu, zr[8 + i], src);
            pi[i] = __shfl_sync(0xffffffffu, zi[8 + i], src);
        }
        const bool dc = t == 0;
#pragma unroll
        for (int k1 = 0; k1 < 8; ++k1) {
            const int k = t + 16 * k1;
            const float cr = k1 == 0 ? (dc ? zr[0] : pr[7])
                                     : (dc ? pr[(8 - k1) & 7] : pr[7 - k1]);
            const float ci = k1 == 0 ? (dc ? zi[0] : pi[7])
                                     : (dc ? pi[(8 - k1) & 7] : pi[7 - k1]);
            const float a = zr[k1], b = zi[k1];
            // E = Z[k] + conj(Z[256 - k]); O = (Z[k] - conj(Z[256 - k])) / i
            const float er = __fadd_rn(a, cr), ei = __fsub_rn(b, ci);
            float orr = __fadd_rn(b, ci), oi = __fsub_rn(cr, a);
            const float2 w = lds2(TB + T_W512 + 2 * k);
            cmul(orr, oi, w.x, w.y);
            const float xr = __fadd_rn(er, orr), xi = __fadd_rn(ei, oi);
            const float yr = __fsub_rn(er, orr), yi = __fsub_rn(ei, oi);
            M[k * MP + slot] = spectral<KIND>(xr, xi);
            M[(NC - k) * MP + slot] = spectral<KIND>(yr, yi);
        }
        if (dc) {  // bin 128: X = conj(2 Z[128])
            const float a = __fadd_rn(zr[8], zr[8]), b = __fadd_rn(zi[8], zi[8]);
            M[(NC / 2) * MP + slot] = spectral<KIND>(a, b);
        }
#pragma unroll
        for (int j = 0; j < JN; ++j) cur[j] = nxt[j];
    }
    __syncthreads();  // the magnitudes are complete; U is free

    // the mel product: frames 4 fg .. 4 fg + 3, bands 4 bg .. 4 bg + 3 (and
    // 64 + 4 bg .. under Kaldi)
    auto load_w = [&](int c) {
        float* const dst = U + (c % RING) * W_FLOATS;
        const float* const srcw = mel + c * W_FLOATS;
        for (int i = tid; i < W_FLOATS / 4; i += NT)
            cp_async16(dst + 4 * i, srcw + 4 * i);
    };
#pragma unroll
    for (int c = 0; c < RING - 1; ++c) {
        load_w(c);
        cp_async_commit();
    }
    const int warp = tid >> 5;
    const int fg = (warp % T::WF) * T::FGW + lane % T::FGW;
    const int bg = (warp / T::WF) * T::BGW + lane / T::FGW;
    float acc[4][4 * NB];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4 * NB; ++j) acc[i][j] = 0.f;
    auto fma16 = [&](int nb, const float4& m4, const float4& w4) {
        const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                acc[i][4 * nb + j] = fmaf(mv[i], wv[j], acc[i][4 * nb + j]);
    };
#pragma unroll 1
    for (int c = 0; c < W::CHUNKS; ++c) {
        cp_async_wait<RING - 2>();
        __syncthreads();  // chunk c is in; chunk c - 1's stage is read out
        if (c + RING - 1 < W::CHUNKS) load_w(c + RING - 1);
        cp_async_commit();
        const float* const mk = M + c * KB * MP + 4 * fg;
        const float* const wk = U + (c % RING) * W_FLOATS + 4 * bg;
#pragma unroll 8
        for (int kk = 0; kk < KB; ++kk) {
            const float4 m4 = lds4(mk + kk * MP);
#pragma unroll
            for (int nb = 0; nb < NB; ++nb)
                fma16(nb, m4, lds4(wk + kk * NM + 64 * nb));
        }
    }
    {
        const float4 m4 = lds4(M + (BINS - 1) * MP + 4 * fg);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
            fma16(nb, m4, __ldg(reinterpret_cast<const float4*>(
                              mel + (BINS - 1) * NM + 64 * nb) + bg));
    }
    auto finish = [&](float e) {
        if constexpr (KIND == KALDI)
            return __fdiv_rn(__fadd_rn(logf(fmaxf(e, log_offset)), shift),
                             divisor);
        else
            return logf(__fadd_rn(e, log_offset));
    };
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int frame = f0 + 4 * fg + i;
        if (frame < n_frames)
#pragma unroll
            for (int nb = 0; nb < NB; ++nb)
                *reinterpret_cast<float4*>(
                    out + ((long long)blockIdx.y * n_frames + frame) * NM +
                    64 * nb + 4 * bg) =
                    make_float4(finish(acc[i][4 * nb]),
                                finish(acc[i][4 * nb + 1]),
                                finish(acc[i][4 * nb + 2]),
                                finish(acc[i][4 * nb + 3]));
    }
}

template <typename In, int FT, int KIND>
cudaError_t configure(int device) {
    static std::atomic<bool> ready[MAX_DEVICES];
    if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (ready[device].load()) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        logmel_fft_kernel<In, FT, KIND>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, FftTile<FT>::SMEM);
    if (err == cudaSuccess) ready[device].store(true);
    return err;
}

// what the C entries below do for one (In, FT, KIND): launch, or count the
// blocks an SM holds at once
template <typename In, int FT, int KIND>
int run(bool launch, const void* wav, float* out, const float* tables,
        const float* mel, int batch, long long stride, int n_frames,
        const float (&post)[3], cudaStream_t stream, int* blocks) {
    using T = FftTile<FT>;
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = configure<In, FT, KIND>(device);
    if (err != cudaSuccess) return (int)err;
    if (!launch)
        return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks, logmel_fft_kernel<In, FT, KIND>, T::NT, T::SMEM);
    const In* const w = static_cast<const In*>(wav);
    if (reinterpret_cast<uintptr_t>(w) % (2 * sizeof(In)) != 0)
        return (int)cudaErrorMisalignedAddress;
    const dim3 grid((unsigned)((n_frames + FT - 1) / FT), (unsigned)batch);
    logmel_fft_kernel<In, FT, KIND><<<grid, T::NT, T::SMEM, stream>>>(
        w, out, tables, mel, stride, n_frames, post[0], post[1], post[2]);
    return (int)cudaGetLastError();
}

template <typename In, int KIND>
int dispatch(int ft, bool launch, const void* wav, float* out,
             const float* tables, const float* mel, int batch,
             long long stride, int n_frames, const float (&post)[3],
             cudaStream_t stream, int* blocks) {
#define BZ_LOGMEL_CASE(F)                                                   \
    if (ft == F)                                                            \
        return run<In, F, KIND>(launch, wav, out, tables, mel, batch,       \
                                stride, n_frames, post, stream, blocks);
    BZ_LOGMEL_CASE(64)
    BZ_LOGMEL_CASE(32)
    BZ_LOGMEL_CASE(16)
    BZ_LOGMEL_CASE(8)
#undef BZ_LOGMEL_CASE
    return (int)cudaErrorInvalidValue;  // not a tile the kernel has
}

}  // namespace

extern "C" {

// (batch, n) waveforms, rows stride samples apart (stride even and at
// least n, the first row aligned to two samples) -> (batch, n_frames, 64)
// log-mel, where n_frames = 1 + (n - 400) / 160, ft frames a block (ft in
// {64, 32, 16, 8}). wire 0: f32 samples; wire 1: the int16 wire, scaled by
// 2^-15 as it is loaded. tables and mel as described above.
int bz_logmel(const void* wav, int wire, float* out, const float* tables,
              const float* mel, int batch, long long n, long long stride,
              int n_frames, float log_offset, int ft, void* stream) {
    if (batch <= 0 || batch > 65535 || n < WINDOW || stride < n ||
        stride % 2 != 0 || n_frames != 1 + (n - WINDOW) / HOP ||
        (wire != 0 && wire != 1))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float post[3] = {log_offset, 0.f, 1.f};
    return wire == 0
               ? dispatch<float, YAMNET>(ft, true, wav, out, tables, mel,
                                         batch, stride, n_frames, post, s,
                                         nullptr)
               : dispatch<short, YAMNET>(ft, true, wav, out, tables, mel,
                                         batch, stride, n_frames, post, s,
                                         nullptr);
}

// *blocks = how many blocks of tile ft one SM of the current device runs at
// once (cudaOccupancyMaxActiveBlocksPerMultiprocessor; the same for both
// wires)
int bz_logmel_blocks(int ft, int* blocks) {
    *blocks = 0;
    const float post[3] = {0.f, 0.f, 1.f};
    return dispatch<float, YAMNET>(ft, false, nullptr, nullptr, nullptr,
                                   nullptr, 1, 0, 0, post, nullptr, blocks);
}

// The Kaldi geometry: as bz_logmel, with mel (257, 128) and out (batch,
// n_frames, 128) = (log(max(fbank, floor)) + shift) / divisor.
int bz_fbank_kaldi(const void* wav, int wire, float* out,
                   const float* tables, const float* mel, int batch,
                   long long n, long long stride, int n_frames, float floor,
                   float shift, float divisor, int ft, void* stream) {
    if (batch <= 0 || batch > 65535 || n < WINDOW || stride < n ||
        stride % 2 != 0 || n_frames != 1 + (n - WINDOW) / HOP ||
        (wire != 0 && wire != 1))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float post[3] = {floor, shift, divisor};
    return wire == 0
               ? dispatch<float, KALDI>(ft, true, wav, out, tables, mel,
                                        batch, stride, n_frames, post, s,
                                        nullptr)
               : dispatch<short, KALDI>(ft, true, wav, out, tables, mel,
                                        batch, stride, n_frames, post, s,
                                        nullptr);
}

int bz_fbank_kaldi_blocks(int ft, int* blocks) {
    *blocks = 0;
    const float post[3] = {0.f, 0.f, 1.f};
    return dispatch<float, KALDI>(ft, false, nullptr, nullptr, nullptr,
                                  nullptr, 1, 0, 0, post, nullptr, blocks);
}

const char* bz_logmel_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
