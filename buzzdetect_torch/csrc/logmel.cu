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
// f32 FFMA throughput. A file's ragged last chunk (5 patches, 480 frames)
// is 1/42 of that work: there the bound is filling the card at all.
//
// What held the earlier design (one block of 64 frames walking all 257
// bins) back: a 200 s chunk launched 314 blocks, two per SM, so a full wave
// and a wave of 50; 480 frames launched 8 blocks on 132 SMs; and the DFT
// operand was copied synchronously between two barriers.
//
// The design:
//   - A thread-block cluster of CS blocks shares FT frames. The bins 0..255
//     are 4 chunks of 64; the block of rank r computes the DFT and the
//     magnitudes of chunks [r * 4 / CS, (r + 1) * 4 / CS) for the cluster's
//     frames into its own shared memory. After cluster.sync() it copies the
//     other ranks' magnitude tiles into its own shared memory (R), 256
//     contiguous bytes per 16 threads, then a second cluster.sync() lets
//     every block run on, and it runs the mel product for bands
//     [r * 64 / CS, (r + 1) * 64 / CS) from local memory, in the bins' own
//     order. Reading the remote tiles in place instead (each lane its own
//     frame's row) took 0.73 ms of a 1.07 ms launch at FT = 32, CS = 4:
//     distributed shared memory wants whole segments. Bin 256 (the Nyquist
//     bin, 800 FMA a frame) is computed by every block of the cluster for
//     its own use.
//   - FT and CS are chosen at launch (ops/logmel.py::launch_geometry, from
//     the frame count, the batch, the SM count and
//     cudaOccupancyMaxActiveClusters): FT in {128, 64, 32}, CS in {2, 4},
//     the first candidate (larger tiles first, clusters of 2 before 4)
//     whose busiest SM gets at most 1.1x the fewest (frame, bin-chunk)
//     pairs any candidate gives it. On the H100, a 200 s chunk gets FT = 64,
//     CS = 2: 628 blocks, two an SM, the busiest SM 1.05x the mean. 480
//     frames get FT = 32, CS = 4: 60 blocks. Clusters of 4 at one block an
//     SM fill only 120 of the 132 SMs (30 clusters: GPCs whose SM count is
//     not a multiple of 4), and at one tile clusters of 2 stage the samples
//     and bin 256 for half as many blocks.
//   - Each thread owns TF = FT / 16 frames x TB = 4 bins of re and im, 256
//     threads a block. Per 4 taps it reads its frames' samples as one
//     float4 each (hop rows padded to 164 floats, so that 8 lanes on
//     consecutive frames hit 8 distinct bank quads) and, per tap, the DFT
//     row's 4 re and 4 im as two float4s that 16 lanes share. Of the tiles
//     timed (4 x 8 and 2 x 8 before it), this one issues the fewest loads
//     per FFMA at FT = 64 and read the fastest at every geometry.
//   - The DFT operand comes through a 3-stage cp.async ring of 20-tap steps
//     (10 KB each), one barrier a step; the frames' hop rows (4-byte
//     cp.async, zero past the end) and bin 256's DFT arrive as one more
//     group in flight with the first steps. At FT = 64 a block takes 113 KB
//     of shared memory, so two blocks share an SM.
//   - The spectrum never reaches device memory; only the log-mel is
//     written.
//
// Exact f32 and the same bits as the earlier design at every shape: FFMA
// only, IEEE sqrtf and logf, no tensor cores, no TF32, no cuBLAS or cuFFT,
// no split K and no atomics. re and im of each (frame, bin) are one fmaf
// chain over the taps 0..399 ascending; bin 256 is four chains of 100 taps
// summed in order; each mel band is one fmaf chain over the bins 0..255
// ascending, then bin 256. The tile shape changes none of them, so a frame's
// log-mel does not depend on FT, CS or the batch.
//
// Measured (tools/logmel_geometries.py, tools/compare_builds.py and
// chip_smoke.py, device time from torch.profiler, NVIDIA H100 80GB HBM3 at
// 700 W):
// 0.276-0.283 ms for a 200 s chunk (FT = 64, CS = 2), 2.1x the 0.133 ms
// bound, against 0.436 ms for the earlier design and 0.53 ms for the matmul
// frontend; 0.025 ms for 480 frames (FT = 32, CS = 4), against 0.136 ms
// and the matmul frontend's 0.041. The DFT loop holds it: 8.25 GFLOP in
// 0.28 ms is 29 TFLOP/s, 55% of the 53.7 TFLOP/s an FMA chain reaches on
// the card, with the busiest SM 1.05x the mean (the mel product and its
// copy took 9% of the launch, measured with the earlier 2 x 8 tile). Which
// stall holds the loop is not measurable there (no ncu).
//
// Plain C interface, loaded with ctypes; returns a cudaError_t code
// (0 = success) and launches on the given stream.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "ptx.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WINDOW = 400;   // samples per frame
constexpr int HOP = 160;      // samples between frames
constexpr int MELS = 64;      // mel bands out
constexpr int NYQ_BIN = 256;  // the last of the 257 bins, computed apart
constexpr int BB = 64;        // bins per chunk
constexpr int NCHUNK = NYQ_BIN / BB;  // chunks covering bins 0..255
constexpr int KC = 20;        // taps per ring step: HOP = 8 KC, WINDOW =
                              // 20 KC, so a step never straddles a hop row
constexpr int KSTEPS = WINDOW / KC;
constexpr int RING = 3;       // cp.async ring stages
constexpr int RS = HOP + 4;   // padded hop-row stride (see the note above)
constexpr int D_FLOATS = KC * 2 * BB;  // one ring step of (re | im)
constexpr int NYQ_PARTS = 4;  // bin 256: four chains of 100 taps
constexpr int NYQ_TAPS = WINDOW / NYQ_PARTS;
static_assert(HOP % KC == 0 && WINDOW % KC == 0 && KC % 4 == 0, "steps");
static_assert(NYQ_TAPS % 4 == 0 && HOP % 4 == 0, "float4 sample reads");

template <int FT, int CS>
struct LogmelTile {
    static constexpr int CPB = NCHUNK / CS;   // bin chunks per block
    static constexpr int BANDS = MELS / CS;   // mel bands per block
    static constexpr int ROWS = FT + 2;       // frame f reads rows f..f+2
    static constexpr int S_FLOATS = ROWS * RS;
    static constexpr int MS = CPB * BB + 4;   // magnitude row stride
    static constexpr int M_FLOATS = FT * MS;
    static constexpr int P_FLOATS = 2 * NYQ_PARTS * FT;
    static constexpr int N_FLOATS = 2 * WINDOW;  // bin 256's re | im taps
    static constexpr int SMEM = (S_FLOATS + RING * D_FLOATS + M_FLOATS +
                                 P_FLOATS + FT + N_FLOATS) * 4;
    // the DFT tile of a thread: TF frames x TB bins, SL frame slots; NT
    // threads a block
    static constexpr int TF = FT / 16;
    static constexpr int TB = 4;
    static constexpr int SL = FT / TF;
    static constexpr int NT = SL * (BB / TB);
    // the mel tile of a thread: one frame x MB bands
    static constexpr int MB = BANDS * FT / NT;
    static_assert(SL % 32 == 0 || 32 % SL == 0, "a warp's frames");
    static_assert(MB >= 2 && MB % 2 == 0 && FT % 32 == 0, "the mel tiles");
    static constexpr int R_FLOATS = (NCHUNK - CPB) * FT * BB;
    static_assert(R_FLOATS + (NYQ_BIN + 1) * BANDS <=
                      S_FLOATS + RING * D_FLOATS,
                  "R and W over the samples and the ring");
    static_assert(SMEM <= 232448, "shared memory of one block");
};

// 4 bytes global -> shared, asynchronously; with ok false, a zero
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ float part(const float4& v, int t) {
    return t == 0 ? v.x : t == 1 ? v.y : t == 2 ? v.z : v.w;
}

// dft: (NCHUNK, WINDOW, 2 * BB), chunk c tap k = [re of bins c*BB..+BB |
//      im of the same bins]; nyq: (WINDOW, 2) = re | im of bin 256;
// mel: (257, MELS) row-major. Grid: (frame tiles * CS, batch), clusters of
// CS along x.
template <int FT, int CS>
__global__ void __launch_bounds__(LogmelTile<FT, CS>::NT, FT >= 128 ? 1 : 2)
logmel_kernel(const float* __restrict__ wav, float* __restrict__ out,
              const float* __restrict__ dft, const float* __restrict__ nyq,
              const float* __restrict__ mel, const long long n,
              const int n_frames, const float log_offset) {
    using T = LogmelTile<FT, CS>;
    constexpr int TF = T::TF, TB = T::TB, SL = T::SL, MB = T::MB, NT = T::NT;
    constexpr int STEPS = T::CPB * KSTEPS;
    extern __shared__ __align__(16) float smem[];
    float* const S = smem;                        // (ROWS, RS) hop rows
    float* const ring = S + T::S_FLOATS;          // DFT steps
    float* const R = smem;                        // then, over S and the
                                                  // ring: the other ranks'
    float* const W = R + T::R_FLOATS;             // |X|, and (257, BANDS) mel
    float* const M = ring + RING * D_FLOATS;      // (FT, MS) |X|, own bins
    float* const P = M + T::M_FLOATS;             // (2, 4, FT) bin-256 parts
    float* const Q = P + T::P_FLOATS;             // (FT,) |X| of bin 256
    float* const N = Q + FT;                      // (WINDOW, 2) bin 256's DFT

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int tid = threadIdx.x;
    const int f0 = (blockIdx.x / CS) * FT;
    const float* const x = wav + (long long)blockIdx.y * n;
    const long long base = (long long)f0 * HOP;
    const int c0 = rank * T::CPB;  // this block's first bin chunk

    // ring step s: taps (s % KSTEPS) * KC.. of bin chunk c0 + s / KSTEPS
    auto load_step = [&](int s) {
        const float* const src =
            dft + ((long long)(c0 + s / KSTEPS) * WINDOW + (s % KSTEPS) * KC) *
                      (2 * BB);
        float* const dst = ring + (s % RING) * D_FLOATS;
        for (int i = tid; i < D_FLOATS / 4; i += NT)
            cp_async16(dst + 4 * i, src + 4 * i);
    };
    // cp.async group 0: the tile's samples (zero past the end; only masked
    // frames read them) and bin 256's DFT; groups 1, 2: ring steps 0, 1
    for (int i = tid; i < T::ROWS * HOP; i += NT) {
        const long long s = base + i;
        cp_async4(S + (i / HOP) * RS + i % HOP, x + (s < n ? s : 0), s < n);
    }
    for (int i = tid; i < T::N_FLOATS / 4; i += NT)
        cp_async16(N + 4 * i, nyq + 4 * i);
    cp_async_commit();
#pragma unroll
    for (int s = 0; s < RING - 1; ++s) {
        load_step(s);
        cp_async_commit();
    }
    cp_async_wait<RING - 1>();
    __syncthreads();

    // bin 256: item (frame f, part p) sums taps [p * 100, p * 100 + 100)
    for (int item = tid; item < NYQ_PARTS * FT; item += NT) {
        const int f = item % FT, p = item / FT;
        float r = 0.f, im = 0.f;
        for (int k = p * NYQ_TAPS; k < (p + 1) * NYQ_TAPS; k += 4) {
            const float4 a = lds4(S + (f + k / HOP) * RS + k % HOP);
            const float4 w0 = lds4(N + 2 * k), w1 = lds4(N + 2 * k + 4);
            r = fmaf(a.x, w0.x, r);
            im = fmaf(a.x, w0.y, im);
            r = fmaf(a.y, w0.z, r);
            im = fmaf(a.y, w0.w, im);
            r = fmaf(a.z, w1.x, r);
            im = fmaf(a.z, w1.y, im);
            r = fmaf(a.w, w1.z, r);
            im = fmaf(a.w, w1.w, im);
        }
        P[p * FT + f] = r;
        P[NYQ_PARTS * FT + p * FT + f] = im;
    }
    __syncthreads();
    if (tid < FT) {
        float r = 0.f, im = 0.f;
#pragma unroll
        for (int p = 0; p < NYQ_PARTS; ++p) {
            r += P[p * FT + tid];
            im += P[NYQ_PARTS * FT + p * FT + tid];
        }
        Q[tid] = sqrtf(r * r + im * im);
    }

    // the DFT: this thread's frames slot + i * SL (i < TF) and bins
    // g * TB .. g * TB + TB - 1 of each of the block's chunks
    const int slot = tid % SL, g = tid / SL;
    float re[TF][TB], im[TF][TB];
#pragma unroll
    for (int i = 0; i < TF; ++i)
#pragma unroll
        for (int j = 0; j < TB; ++j) re[i][j] = im[i][j] = 0.f;

    // Step s's copies were committed as cp.async group s + 1. The barrier
    // after the wait ends step s-1's reads, so its stage can be refilled.
    for (int s = 0; s < STEPS; ++s) {
        cp_async_wait<RING - 2>();
        __syncthreads();
        if (s + RING - 1 < STEPS) load_step(s + RING - 1);
        cp_async_commit();
        const int q = s % KSTEPS;
        // taps q*KC .. q*KC+KC-1 lie in hop row q/R from column (q%R)*KC
        constexpr int R = HOP / KC;
        const float* const sp = S + (slot + q / R) * RS + (q % R) * KC;
        const float* const d = ring + (s % RING) * D_FLOATS + g * TB;
#pragma unroll
        for (int kk = 0; kk < KC; kk += 4) {
            float4 a[TF];
#pragma unroll
            for (int i = 0; i < TF; ++i) a[i] = lds4(sp + i * SL * RS + kk);
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                const float* const dk = d + (kk + t) * (2 * BB);
                float wr[TB], wi[TB];
#pragma unroll
                for (int j = 0; j < TB; j += 4) {
                    const float4 r4 = lds4(dk + j), i4 = lds4(dk + BB + j);
                    wr[j] = r4.x, wr[j + 1] = r4.y, wr[j + 2] = r4.z,
                    wr[j + 3] = r4.w;
                    wi[j] = i4.x, wi[j + 1] = i4.y, wi[j + 2] = i4.z,
                    wi[j + 3] = i4.w;
                }
#pragma unroll
                for (int i = 0; i < TF; ++i) {
                    const float av = part(a[i], t);
#pragma unroll
                    for (int j = 0; j < TB; ++j) {
                        re[i][j] = fmaf(av, wr[j], re[i][j]);
                        im[i][j] = fmaf(av, wi[j], im[i][j]);
                    }
                }
            }
        }
        if (q == KSTEPS - 1) {  // a bin chunk is done: its magnitudes to M
            const int col = (s / KSTEPS) * BB + g * TB;
#pragma unroll
            for (int i = 0; i < TF; ++i) {
                float mg[TB];
#pragma unroll
                for (int j = 0; j < TB; ++j) {
                    mg[j] = sqrtf(re[i][j] * re[i][j] + im[i][j] * im[i][j]);
                    re[i][j] = im[i][j] = 0.f;
                }
#pragma unroll
                for (int j = 0; j < TB; j += 4)
                    *reinterpret_cast<float4*>(M + (slot + i * SL) * T::MS +
                                               col + j) =
                        make_float4(mg[j], mg[j + 1], mg[j + 2], mg[j + 3]);
            }
        }
    }

    // The samples and the ring are read out. Over them go R, the other
    // ranks' magnitude tiles copied here, and W, this block's bands of the
    // mel matrix.
    __syncthreads();
    const int band0 = rank * T::BANDS;
    for (int i = tid; i < (NYQ_BIN + 1) * T::BANDS / 4; i += NT) {
        const int b = i / (T::BANDS / 4), c = (i % (T::BANDS / 4)) * 4;
        cp_async16(W + b * T::BANDS + c, mel + b * MELS + band0 + c);
    }
    cp_async_commit();
    cluster.sync();  // every block's magnitudes are complete
    // Remote chunk rc (the chunks in order, this block's own left out) of
    // frame f goes to R row rc * FT + f, 64 floats with its float4 j at
    // j ^ (f % 8), so that 8 lanes on consecutive frames read 8 distinct
    // bank quads. 16 consecutive threads copy one 256-byte row: distributed
    // shared memory is read in whole segments, a few loads in flight each.
    constexpr int COPY = (NCHUNK - T::CPB) * FT * (BB / 4);  // float4s
    constexpr int UNR = 4;
    for (int i0 = tid; i0 < COPY; i0 += UNR * NT) {
        float4 v[UNR];
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
            const int i = i0 + u * NT;
            if (i < COPY) {
                const int j = i % (BB / 4), fr = (i / (BB / 4)) % FT;
                const int rc = i / (BB / 4 * FT);
                const int c = rc < c0 ? rc : rc + T::CPB;
                v[u] = *reinterpret_cast<const float4*>(
                    cluster.map_shared_rank(M, c / T::CPB) + fr * T::MS +
                    (c % T::CPB) * BB + 4 * j);
            }
        }
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
            const int i = i0 + u * NT;
            if (i < COPY) {
                const int j = i % (BB / 4), fr = (i / (BB / 4)) % FT;
                const int rc = i / (BB / 4 * FT);
                *reinterpret_cast<float4*>(R + (rc * FT + fr) * BB +
                                           4 * (j ^ (fr % 8))) = v[u];
            }
        }
    }
    cp_async_wait<0>();
    // R and W are complete, and no block reads another's magnitudes again,
    // so every block may run on to its end
    cluster.sync();

    // the mel product: frame f, bands band0 + mg * MB .. + MB - 1, over the
    // bins 0..255 in order (chunk c: this block's own in M, else in R), then
    // bin 256
    const int f = tid % FT, mg = tid / FT;
    float macc[MB];
#pragma unroll
    for (int j = 0; j < MB; ++j) macc[j] = 0.f;
    for (int c = 0; c < NCHUNK; ++c) {
        const bool own = c / T::CPB == rank;
        const int rc = c < c0 ? c : c - T::CPB;
        const float* const mr = own ? M + f * T::MS + (c % T::CPB) * BB
                                    : R + (rc * FT + f) * BB;
        const int swz = own ? 0 : f % 8;
        const float* const w = W + c * BB * T::BANDS + mg * MB;
#pragma unroll
        for (int b = 0; b < BB; b += 4) {
            const float4 m4 = lds4(mr + 4 * ((b / 4) ^ swz));
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                const float mv = part(m4, t);
                const float* const wb = w + (b + t) * T::BANDS;
                if constexpr (MB % 4 == 0) {
#pragma unroll
                    for (int j = 0; j < MB; j += 4) {
                        const float4 w4 = lds4(wb + j);
                        macc[j] = fmaf(mv, w4.x, macc[j]);
                        macc[j + 1] = fmaf(mv, w4.y, macc[j + 1]);
                        macc[j + 2] = fmaf(mv, w4.z, macc[j + 2]);
                        macc[j + 3] = fmaf(mv, w4.w, macc[j + 3]);
                    }
                } else {
#pragma unroll
                    for (int j = 0; j < MB; j += 2) {
                        const float2 w2 =
                            *reinterpret_cast<const float2*>(wb + j);
                        macc[j] = fmaf(mv, w2.x, macc[j]);
                        macc[j + 1] = fmaf(mv, w2.y, macc[j + 1]);
                    }
                }
            }
        }
    }
    const int frame = f0 + f;
    if (frame < n_frames) {
        const float qv = Q[f];
        const float* const w = W + NYQ_BIN * T::BANDS + mg * MB;
        float* const o = out + ((long long)blockIdx.y * n_frames + frame) *
                                   MELS + band0 + mg * MB;
#pragma unroll
        for (int j = 0; j < MB; j += 2)
            *reinterpret_cast<float2*>(o + j) = make_float2(
                logf(fmaf(qv, w[j], macc[j]) + log_offset),
                logf(fmaf(qv, w[j + 1], macc[j + 1]) + log_offset));
    }
}

template <int FT, int CS>
cudaError_t configure(int device) {
    static std::atomic<bool> ready[MAX_DEVICES];
    if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (ready[device].load()) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        logmel_kernel<FT, CS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        LogmelTile<FT, CS>::SMEM);
    if (err == cudaSuccess) ready[device].store(true);
    return err;
}

template <int FT, int CS>
cudaLaunchConfig_t launch_config(int tiles, int batch, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(tiles * CS), (unsigned)batch, 1);
    cfg.blockDim = dim3(LogmelTile<FT, CS>::NT, 1, 1);
    cfg.dynamicSmemBytes = LogmelTile<FT, CS>::SMEM;
    cfg.stream = stream;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = CS;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

// what the C entries below do for one (FT, CS): launch, or count clusters
template <int FT, int CS>
int run(bool launch, const float* wav, float* out, const float* dft,
        const float* nyq, const float* mel, int batch, long long n,
        int n_frames, float log_offset, cudaStream_t stream, int* clusters) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = configure<FT, CS>(device);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr;
    const int tiles = launch ? (n_frames + FT - 1) / FT : 1;
    const cudaLaunchConfig_t cfg =
        launch_config<FT, CS>(tiles, launch ? batch : 1, stream, &attr);
    if (!launch)
        return (int)cudaOccupancyMaxActiveClusters(
            clusters, logmel_kernel<FT, CS>, &cfg);
    err = cudaLaunchKernelEx(&cfg, logmel_kernel<FT, CS>, wav, out, dft, nyq,
                             mel, n, n_frames, log_offset);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

int dispatch(int ft, int cs, bool launch, const float* wav, float* out,
             const float* dft, const float* nyq, const float* mel, int batch,
             long long n, int n_frames, float log_offset, cudaStream_t stream,
             int* clusters) {
#define BZ_LOGMEL_CASE(F, C)                                                \
    if (ft == F && cs == C)                                                 \
        return run<F, C>(launch, wav, out, dft, nyq, mel, batch, n, n_frames, \
                         log_offset, stream, clusters);
    BZ_LOGMEL_CASE(128, 4)
    BZ_LOGMEL_CASE(128, 2)
    BZ_LOGMEL_CASE(64, 4)
    BZ_LOGMEL_CASE(64, 2)
    BZ_LOGMEL_CASE(32, 4)
    BZ_LOGMEL_CASE(32, 2)
#undef BZ_LOGMEL_CASE
    return (int)cudaErrorInvalidValue;  // not a geometry the kernel has
}

}  // namespace

extern "C" {

// (batch, n) f32 waveforms -> (batch, n_frames, 64) log-mel, where
// n_frames = 1 + (n - 400) / 160, with ft frames per cluster of cs blocks
// (ft in {128, 64, 32}, cs in {4, 2}). dft, nyq and mel as described above.
int bz_logmel(const float* wav, float* out, const float* dft,
              const float* nyq, const float* mel, int batch, long long n,
              int n_frames, float log_offset, int ft, int cs, void* stream) {
    if (batch <= 0 || batch > 65535 || n < WINDOW ||
        n_frames != 1 + (n - WINDOW) / HOP)
        return (int)cudaErrorInvalidValue;
    return dispatch(ft, cs, true, wav, out, dft, nyq, mel, batch, n, n_frames,
                    log_offset, static_cast<cudaStream_t>(stream), nullptr);
}

// *clusters = how many clusters of the (ft, cs) geometry the current device
// runs at once (cudaOccupancyMaxActiveClusters).
int bz_logmel_clusters(int ft, int cs, int* clusters) {
    *clusters = 0;
    return dispatch(ft, cs, false, nullptr, nullptr, nullptr, nullptr,
                    nullptr, 1, 0, 0, 0.f, nullptr, clusters);
}

const char* bz_logmel_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
