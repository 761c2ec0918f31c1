// The capability probe's kernels: layout remaps, three matrix products, and
// an FMA chain.
//
// Replaces the TPU kernels of tools/mosaic_capability_probe.py: `run` (one
// whole-array kernel per layout case), `case_collapsed_dot`,
// `case_dot_high` and `case_dot_high_emulated`. On the TPU the probe asked
// which tensor-shape operations the Mosaic compiler lowers at all. On this
// card every form compiles, so what the probe checks here is the index
// arithmetic a fused front would use (stride-2 subsampling, rolls,
// pad-shifts, a row gather), and which of the card's two routes to an
// emulated-HIGH product on the tensor cores is faster: the native one (an
// f32 weight split in the kernel, one accumulator), or the one
// csrc/sepconv.cu's HIGH mode runs (a pre-split weight, two accumulators).
// Both run one pipeline, dot_hilo_mma_kernel<F32_W, ONE_ACC>, so the
// comparison measures those two choices and nothing else.
//
// remap (for `run`, tools/mosaic_capability_probe.py:48-54, one
// whole-array pallas_call per layout case). Each output element is one
// input element (its flat offset from the case's index arithmetic, written
// out below per case), or zero for the mask and pad cases, or
// (outer_broadcast_mul) an input element times a weight. Exact: it moves
// values, and outer_broadcast_mul is one f32 multiply. Bound: bytes (the
// input sectors each case reads, each output written once): 21.2 MB for
// the probe's 20 cases, 0.0063 ms at 3.35 TB/s. What held the earlier
// kernel far from it was not the card: one launch per case (20 per sweep,
// each with its host wrapper), and per element a 4-dimensional unravel in
// 64-bit division, which the card emulates in software. The design:
//   - One launch for a batch of cases. The host passes a table by value
//     (__grid_constant__, so the kernel indexes it without a copy): per
//     case its id, the three pointers, the input and output shapes as
//     32-bit ints with leading ones, its element count and its first
//     block. A block finds its case from the first-block prefix and
//     dispatches on the id to the case's functor, so a warp never mixes
//     cases.
//   - 32-bit index arithmetic: every input and output has under 2^31
//     elements (the host refuses others).
//   - Each thread makes 4 neighbouring outputs and stores them as one
//     float4 where the output's last dimension is a multiple of 4 (so the
//     four share their outer indices and one unravel serves them; every
//     probe case), else as four scalars. Loads stay per element: the
//     functors gather.
//   Measured: at the end of this note.
//
// dot_f32 (for `case_collapsed_dot`, the pallas_call at
// tools/mosaic_capability_probe.py:152: jnp.dot at HIGHEST). (M, K) @ (K,
// N) in exact f32 on FFMA: no TF32, no tensor cores. Bound: FFMA
// throughput, 2 M N K operations at the f32 peak (at 5016 x 512 x 512,
// layers 8-12's pointwise product at B = 209, and 1254 x 1024 x 1024,
// layer 14's: 2.63 GFLOP, 0.039 ms at 67 TFLOP/s, 0.051 ms at the 51-55
// TFLOP/s an FMA chain reaches on the card). The design,
// dot_f32_kernel<TM, BN>:
//   - The same arithmetic as the earlier 64 x 64 kernel, so its outputs
//     are bit for bit the same: one accumulator per output from 0, acc =
//     fmaf(a[m][k], w[k][n], acc) for k ascending. No split K, no atomics:
//     identical from run to run.
//   - A block of 2 BN threads owns 16 TM rows x BN columns; each thread TM
//     rows (16 apart) x 8 columns (two float4 groups BN / 2 apart). Per 4
//     k steps a thread reads TM float4s of A (4 k of one row each) and 8
//     float4s of B: TM + 8 shared loads per 32 TM FFMA (TM = 5: 13 per
//     160; the earlier 4 x 4 tile: 8 per 64).
//   - No transpose. A stays (m, k) in shared memory, rows padded to 20
//     floats: a thread's float4 holds 4 k of one row, and the 4 rows a
//     warp reads at once (rows 16 i + ty, ty consecutive) start on bank
//     quads 0, 20, 8, 28, so each read is one wavefront. So both operands
//     go to shared memory by cp.async as they lie in device memory.
//   - Loads in flight while a chunk computes: K in chunks of 16 through a
//     ring of 3 cp.async stages (A's 16 TM rows, B's 16 x BN slice), one
//     barrier per chunk; 43776 bytes at TM = 5, BN = 128. Chunks of 32
//     measured no faster (compare_builds against a build with them).
//   - Filling 132 SMs: BN = 128 where N allows it, else 64; TM = 5 or 4;
//     the pair whose busiest SM gets the fewest outputs (its ceil(blocks /
//     SMs) blocks), the larger tile on a tie. 5016 x 512: 63 x 4 = 252
//     blocks of 80 x 128, the busiest SM 2 (20480 outputs against a mean
//     of 19456; 128-row tiles would give 160 blocks and the busiest
//     32768). 1254 x 1024: 16 x 8 = 128 blocks of 80 x 128, one per SM
//     (10240 against 9728; 128-row tiles: 80 blocks of 16384). The probe's
//     1024 x 128: 32 blocks of 64 x 64. BN = 128 halves the L2 reads of A
//     against BN = 64 and measured 2-3% faster at both tail shapes, the
//     tiles' balance being the same. No TM = 8: it never gives the better
//     balance at these shapes, and takes 161 registers a thread.
//   Measured: at the end of this note.
//
// dot_high (for `case_dot_high`, "native HIGH") and dot_high_emulated (for
// `case_dot_high_emulated`, the TPU's `_pw_dot` at HIGH: three one-pass bf16
// products on the MXU): the card's form of the TPU's three-pass HIGH. The
// f32 activation is split into bf16 hi and lo halves (hi = bf16(v), lo =
// bf16(v - hi), round to nearest even), and hi*hi + hi*lo + lo*hi run on the
// tensor cores (mma.sync.m16n8k16 bf16 -> f32). One kernel,
// dot_hilo_mma_kernel<F32_W, ONE_ACC>, serves both; they differ only in
//   - the weight's form: dot_high takes it f32 and splits each (32 x 128)
//     chunk once in shared memory, as it splits the activation;
//     dot_high_emulated takes it pre-split as (2, K, N) bf16 hi and lo
//     planes (ops/sepconv.pack_pointwise(w, 'high')), as csrc/sepconv.cu's
//     HIGH mode does;
//   - the accumulators: dot_high adds hi*hi, hi*lo and lo*hi into one for
//     each 16 taps, in that order; dot_high_emulated keeps hi*hi in one and
//     hi*lo + lo*hi in another, added in the epilogue, exactly as
//     sep_layer_mma_kernel does.
// The pipeline: a ring of 3 cp.async stages brings each K chunk of 32 (the
// f32 activation tile and the weight tile, 16 bytes a thread) to shared
// memory while earlier chunks compute; each chunk is split once into bf16
// planes; ldmatrix feeds the mma.sync tiles. 64 x 128 outputs per block of 8
// warps (2 along M x 4 along N, each 32 x 32), so the conv tail's shapes
// launch 316 (5016 x 512) and 160 (1254 x 1024) blocks, at least one per
// SM; the M edge is masked with zero rows and an N edge (N = 64 mod 128)
// with zero columns, neither stored. K in order, no split K, no atomics:
// identical from run to run. dot_high's earlier kernel (nvcuda::wmma, 4
// warps on 64 x 64 tiles, each chunk loaded and split between two barriers
// with nothing in flight) ran the same mma sequence into its one
// accumulator: a wmma bf16 16x16x16 product is two m16n8k16 mma on this
// card. Bound: three bf16 products (6 M N K operations) at the tensor
// cores' dense bf16 peak, or the bytes, whichever is larger. Measured: at
// the end of this note.
//
// fma_chain (for tools/roofline.py's measured f32 peak). Each thread keeps
// four independent values in registers and applies v = fma(v, a, b) to each
// `steps` times: 2 operations per step and value, against 8 bytes of
// traffic per value. Bound: FFMA throughput.
//
// Measured (chip_smoke.py and tools/compare_builds.py, device time alone
// from torch.profiler, NVIDIA H100 80GB HBM3 at 700 W):
//   remap, the probe's 20 cases in one launch: 0.0076-0.0092 ms against the
//     0.0063 ms bound (the earlier one-launch-per-case kernel: 0.058 ms; 20
//     PyTorch calls: 0.039 ms). By CUDA events the batch takes 0.12-0.40
//     ms: the host wrapper's 20 item checks, not the card.
//   dot_f32: 0.055 ms at 5016 x 512 x 512 on layer 8's activations (48
//     TFLOP/s; torch.matmul f32 0.055 ms) and 0.061 ms at 1254 x 1024 x
//     1024 (44 TFLOP/s; torch.matmul 0.062), against the 0.039 ms bound; on
//     seeded normal activations 0.068 and 0.076 ms against the earlier
//     kernel's 0.091 and 0.106. Its busiest SM runs at 94-98% of the FMA
//     chain's rate: what holds it is the FFMA issue rate itself and the
//     tile granularity (the busiest SM 1.05x the mean work).
//   dot_high: 0.039 ms at 5016 x 512 x 512 and 0.047 ms at 1254 x 1024 x
//     1024 on the conv tail's operands (0.64x and 0.74x torch.matmul f32,
//     1.11x and 1.16x dot_high_emulated's 0.035 and 0.040), against the
//     earlier wmma kernel's 0.042 and 0.061; its outputs are bit for bit
//     that kernel's. Pipelining its weight split behind the previous
//     chunk's product took it from 1.21x to 1.16x dot_high_emulated at
//     1254 x 1024 x 1024. Both HIGH routes sit at 4.4-5.9x the bound; what
//     is left between them is the weight's split.
//
// Plain C interface, loaded with ctypes; every function returns a
// cudaError_t code (0 = success) and launches on the given stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "ptx.cuh"

namespace {

// --- remap -------------------------------------------------------------------

struct Dims {
    int i[4];  // input shape, leading ones
    int o[4];  // output shape, leading ones
};

__device__ __forceinline__ int ravel(int a, int b, int c, int d,
                                     const int* s) {
    return ((a * s[1] + b) * s[2] + c) * s[3] + d;
}

__device__ __forceinline__ int wrap(int v, int n) {
    return ((v % n) + n) % n;
}

struct NoMul {
    static constexpr bool kMul = false;
    __device__ static int mul(const int*, const Dims&) { return 0; }
};

// Each case: src(o, D) is the input offset of output index o (4 dims), or
// -1 for a zero. The comments give the numpy expression the probe checks.

// x[:, :, ::2]
struct StrideLane : NoMul {
    __device__ static int src(const int* o, const Dims& D) {
        return ravel(o[0], o[1], o[2], 2 * o[3], D.i);
    }
};

// x[:, ::2, :]
struct StrideSublane : NoMul {
    __device__ static int src(const int* o, const Dims& D) {
        return ravel(o[0], o[1], 2 * o[2], o[3], D.i);
    }
};

// x[::2] on (N, H, W, C)
struct StrideLeading : NoMul {
    __device__ static int src(const int* o, const Dims& D) {
        return ravel(2 * o[0], o[1], o[2], o[3], D.i);
    }
};

// x.reshape(N / 2, 2, H, W, C)[:, 0]: leading index n -> 2 n + 0
struct ReshapeLeadingSplit : NoMul {
    __device__ static int src(const int* o, const Dims& D) {
        return ravel(o[0] * 2 + 0, o[1], o[2], o[3], D.i);
    }
};

// (N, H, W, C) -> (N * H, W, C): output row r is (r / H, r % H)
struct ReshapeLeadingMerge : NoMul {
    __device__ static int src(const int* o, const Dims& D) {
        return ravel(o[1] / D.i[1], o[1] % D.i[1], o[2], o[3], D.i);
    }
};

// (N, H, W, C) -> (N * H * W, C)
struct CollapseTo2d : NoMul {
    __device__ static int src(const int* o, const Dims& D) {
        const int r = o[2], hw = D.i[1] * D.i[2];
        return ravel(r / hw, (r / D.i[2]) % D.i[1], r % D.i[2], o[3], D.i);
    }
};

// (R, W * C) -> (R, W, C)
struct SplitMinor : NoMul {
    __device__ static int src(const int* o, const Dims& D) {
        return ravel(0, 0, o[1], o[2] * D.o[3] + o[3], D.i);
    }
};

// np.roll(x, 1, 1)
struct RollSublane : NoMul {
    __device__ static int src(const int* o, const Dims& D) {
        return ravel(o[0], o[1], wrap(o[2] - 1, D.i[2]), o[3], D.i);
    }
};

// np.roll(x, 128, 2)
struct RollLane : NoMul {
    __device__ static int src(const int* o, const Dims& D) {
        return ravel(o[0], o[1], o[2], wrap(o[3] - 128, D.i[3]), D.i);
    }
};

// np.pad(x, ((0, 0), (1, 0), (0, 0)))[:, :-1, :]
struct PadSliceShift : NoMul {
    __device__ static int src(const int* o, const Dims& D) {
        return o[2] == 0 ? -1 : ravel(o[0], o[1], o[2] - 1, o[3], D.i);
    }
};

// np.swapaxes(x, 1, 2)
struct TransposeMinor : NoMul {
    __device__ static int src(const int* o, const Dims& D) {
        return ravel(o[0], o[1], o[3], o[2], D.i);
    }
};

// (N, H, W, C) as rows (N * H * W, C); output row (p, ho, wo) of
// (N, H / 2, W / 2) reads row p * H * W + 2 ho * W + 2 wo
struct RowGather : NoMul {
    __device__ static int src(const int* o, const Dims& D) {
        const int h2 = D.i[1] / 2, w2 = D.i[2] / 2, r = o[2];
        const int p = r / (h2 * w2), ho = (r / w2) % h2, wo = r % w2;
        return ravel(p, 2 * ho, 2 * wo, o[3], D.i);
    }
};

// np.where(pos % 4 == 0, 0, x), pos the index on axis 1
struct IotaMask : NoMul {
    __device__ static int src(const int* o, const Dims& D) {
        return (o[2] & 3) == 0 ? -1 : ravel(o[0], o[1], o[2], o[3], D.i);
    }
};

// np.where(pos % 3 == 0, 0, x)
struct IotaMod24 : NoMul {
    __device__ static int src(const int* o, const Dims& D) {
        return o[2] % 3 == 0 ? -1 : ravel(o[0], o[1], o[2], o[3], D.i);
    }
};

// x.reshape(A, B / 2, 2, C)[:, :, 0]
struct SplitSublane : NoMul {
    __device__ static int src(const int* o, const Dims& D) {
        return ravel(o[0], o[1], o[2] * 2 + 0, o[3], D.i);
    }
};

// np.roll(x, 32, 2)
struct RollLane32 : NoMul {
    __device__ static int src(const int* o, const Dims& D) {
        return ravel(o[0], o[1], o[2], wrap(o[3] - 32, D.i[3]), D.i);
    }
};

// np.pad(x, ((0, 0), (0, 0), (1, 0)))[:, :, :-1]
struct PadSliceLane : NoMul {
    __device__ static int src(const int* o, const Dims& D) {
        return o[3] == 0 ? -1 : ravel(o[0], o[1], o[2], o[3] - 1, D.i);
    }
};

// (A, B, W * C) -> (A, B, W, C)
struct SplitMinorSmall : NoMul {
    __device__ static int src(const int* o, const Dims& D) {
        return ravel(0, o[0], o[1], o[2] * D.o[3] + o[3], D.i);
    }
};

// (A, R, Q * C) -> reshape (A, R, Q, C) -> swapaxes(1, 2) -> (A * Q, R, C)
struct SwapNonminorMerge : NoMul {
    __device__ static int src(const int* o, const Dims& D) {
        const int q_count = D.i[3] / D.o[3];
        const int a = o[1] / q_count, q = o[1] % q_count;
        return ravel(0, a, o[2], q * D.o[3] + o[3], D.i);
    }
};

// x * w, w of shape (C, 1, 1) against x (C, H, L)
struct OuterBroadcastMul {
    static constexpr bool kMul = true;
    __device__ static int src(const int* o, const Dims& D) {
        return ravel(o[0], o[1], o[2], o[3], D.i);
    }
    __device__ static int mul(const int* o, const Dims&) { return o[1]; }
};

constexpr int N_CASES = 20;    // the case ids of bz_probe_remap_batch
constexpr int MAX_REMAP = 32;  // cases in one launch's table
constexpr int RT = 256;        // threads per block
constexpr int R_BLOCK = 4 * RT;  // outputs per block: 4 neighbours a thread

// One case of a batch. The table travels as a kernel parameter (2.3 KB of
// the 4 KB a launch may pass).
struct RemapCase {
    const float* x;
    const float* w;  // outer_broadcast_mul's weight, else unused
    float* y;
    Dims D;
    int n;      // output elements
    int first;  // the case's first block
    int id;     // case id, the order of ops/probe.py's CASES
    int vec;    // 1: four neighbouring outputs stored as one float4
};

struct RemapBatch {
    RemapCase c[MAX_REMAP];
    int count;
};

__device__ __forceinline__ void unravel(unsigned i, const int* s, int* o) {
#pragma unroll
    for (int d = 3; d > 0; --d) {
        o[d] = (int)(i % (unsigned)s[d]);
        i /= (unsigned)s[d];
    }
    o[0] = (int)i;
}

template <class Case>
__device__ __forceinline__ float remap_value(const RemapCase& R,
                                             const Dims& D, const int* o) {
    const int s = Case::src(o, D);
    float v = s < 0 ? 0.f : R.x[s];
    if (Case::kMul) v *= R.w[Case::mul(o, D)];
    return v;
}

// Outputs 4 t .. 4 t + 3 of the case's block `block`, t the thread
template <class Case>
__device__ void remap_block(const RemapCase& R, int block) {
    const Dims D = R.D;
    const int i0 = (block * RT + (int)threadIdx.x) * 4;
    if (i0 >= R.n) return;
    int o[4];
    if (R.vec) {
        // o[3] is a multiple of 4 and o[3] + 3 < D.o[3]: the four share
        // o[0..2]
        unravel((unsigned)i0, D.o, o);
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int oj[4] = {o[0], o[1], o[2], o[3] + j};
            v[j] = remap_value<Case>(R, D, oj);
        }
        *reinterpret_cast<float4*>(R.y + i0) =
            make_float4(v[0], v[1], v[2], v[3]);
        return;
    }
    for (int j = 0; j < 4 && i0 + j < R.n; ++j) {
        unravel((unsigned)(i0 + j), D.o, o);
        R.y[i0 + j] = remap_value<Case>(R, D, o);
    }
}

__global__ void __launch_bounds__(RT)
remap_kernel(const __grid_constant__ RemapBatch batch) {
    const int b = (int)blockIdx.x;
    int c = 0;
    while (c + 1 < batch.count && b >= batch.c[c + 1].first) ++c;
    const RemapCase& R = batch.c[c];
    const int blk = b - R.first;
    switch (R.id) {
        case 0: remap_block<StrideLane>(R, blk); break;
        case 1: remap_block<StrideSublane>(R, blk); break;
        case 2: remap_block<StrideLeading>(R, blk); break;
        case 3: remap_block<ReshapeLeadingSplit>(R, blk); break;
        case 4: remap_block<ReshapeLeadingMerge>(R, blk); break;
        case 5: remap_block<CollapseTo2d>(R, blk); break;
        case 6: remap_block<SplitMinor>(R, blk); break;
        case 7: remap_block<RollSublane>(R, blk); break;
        case 8: remap_block<RollLane>(R, blk); break;
        case 9: remap_block<PadSliceShift>(R, blk); break;
        case 10: remap_block<TransposeMinor>(R, blk); break;
        case 11: remap_block<RowGather>(R, blk); break;
        case 12: remap_block<IotaMask>(R, blk); break;
        case 13: remap_block<IotaMod24>(R, blk); break;
        case 14: remap_block<SplitSublane>(R, blk); break;
        case 15: remap_block<RollLane32>(R, blk); break;
        case 16: remap_block<PadSliceLane>(R, blk); break;
        case 17: remap_block<SplitMinorSmall>(R, blk); break;
        case 18: remap_block<SwapNonminorMerge>(R, blk); break;
        default: remap_block<OuterBroadcastMul>(R, blk); break;
    }
}

// --- the FFMA product ------------------------------------------------------------

constexpr int DK = 16;    // K chunk
constexpr int DTY = 16;   // threads along M
constexpr int DRING = 3;  // cp.async ring stages
// A rows (m, k) padded by 4 floats: 16-byte aligned, and the 4 consecutive
// rows a warp reads at once start on distinct bank quads
constexpr int DLDA = DK + 4;

// The tile of dot_f32_kernel<TM, BN>: TX = BN / 8 threads along N, each 8
// columns in two float4 groups BN / 2 apart; 16 along M, each TM rows 16
// apart. A warp is 8 threads along N x 4 along M.
template <int TM, int BN>
struct DotTile {
    static constexpr int TX = BN / 8;
    static constexpr int THREADS = TX * DTY;
    static constexpr int WX = TX / 8;             // warps along N
    static constexpr int BM = TM * DTY;           // rows per block
    static constexpr int A_STAGE = BM * DLDA;     // floats
    static constexpr int STAGE = A_STAGE + DK * BN;
    static constexpr int SMEM = DRING * STAGE * (int)sizeof(float);
};

template <int TM, int BN>
__global__ void __launch_bounds__(DotTile<TM, BN>::THREADS)
dot_f32_kernel(const float* __restrict__ a, const float* __restrict__ w,
               float* __restrict__ c, int m, int n, int k) {
    using T = DotTile<TM, BN>;
    constexpr int NT = T::THREADS;
    constexpr int A_PIECES = T::BM * DK / 4;  // 16-byte pieces of a chunk
    extern __shared__ __align__(16) unsigned char dot_smem[];
    float* const ring = reinterpret_cast<float*>(dot_smem);
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int tx = (warp % T::WX) * 8 + lane % 8;
    const int ty = (warp / T::WX) * 4 + lane / 8;
    const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * BN;
    const int n_chunks = k / DK;

    // chunk k's (BM, DK) rows of A (zero rows past M) and (DK, BN) slice
    // of W into ring stage k % DRING, as they lie in device memory
    auto load_chunk = [&](int chunk) {
        float* const As = ring + (chunk % DRING) * T::STAGE;
        float* const Ws = As + T::A_STAGE;
        const int k0 = chunk * DK;
#pragma unroll
        for (int i = 0; i < (A_PIECES + NT - 1) / NT; ++i) {
            const int q = tid + i * NT;
            if (A_PIECES % NT != 0 && q >= A_PIECES) break;
            const int r = q / (DK / 4), cc = (q % (DK / 4)) * 4;
            const bool ok = m0 + r < m;
            cp_async16(As + r * DLDA + cc,
                       a + (long long)(ok ? m0 + r : 0) * k + k0 + cc, ok);
        }
#pragma unroll
        for (int i = 0; i < DK * BN / 4 / NT; ++i) {
            const int q = tid + i * NT;
            const int r = q / (BN / 4), cc = (q % (BN / 4)) * 4;
            cp_async16(Ws + r * BN + cc,
                       w + (long long)(k0 + r) * n + n0 + cc);
        }
    };

    float acc[TM][8];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    // the thread's rows 16 i + ty, columns tx * 4 .. + 3 and BN / 2 + tx *
    // 4 .. + 3; per 4 k, one float4 of each row, then k by k two of W
    auto multiply = [&](int chunk) {
        const float* const As = ring + (chunk % DRING) * T::STAGE;
        const float* const Ws = As + T::A_STAGE;
#pragma unroll
        for (int k4 = 0; k4 < DK; k4 += 4) {
            float4 av[TM];
#pragma unroll
            for (int i = 0; i < TM; ++i)
                av[i] = lds4(As + (i * DTY + ty) * DLDA + k4);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                const float4 b0 = lds4(Ws + (k4 + kk) * BN + tx * 4);
                const float4 b1 = lds4(Ws + (k4 + kk) * BN + BN / 2 + tx * 4);
                const float b[8] = {b0.x, b0.y, b0.z, b0.w,
                                    b1.x, b1.y, b1.z, b1.w};
#pragma unroll
                for (int i = 0; i < TM; ++i) {
                    const float ai = kk == 0   ? av[i].x
                                     : kk == 1 ? av[i].y
                                     : kk == 2 ? av[i].z
                                               : av[i].w;
#pragma unroll
                    for (int j = 0; j < 8; ++j)
                        acc[i][j] = fmaf(ai, b[j], acc[i][j]);
                }
            }
        }
    };

    // Chunk k's stage was committed as cp.async group k. The barrier of
    // iteration k follows the wait for it and ends chunk k-1's product, so
    // stage (k-1) % DRING can be refilled with chunk k + DRING - 1.
#pragma unroll
    for (int s = 0; s < DRING - 1; ++s) {
        if (s < n_chunks) load_chunk(s);
        cp_async_commit();
    }
    for (int kc = 0; kc < n_chunks; ++kc) {
        cp_async_wait<DRING - 2>();
        __syncthreads();
        if (kc + DRING - 1 < n_chunks) load_chunk(kc + DRING - 1);
        cp_async_commit();
        multiply(kc);
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int row = m0 + i * DTY + ty;
        if (row >= m) continue;
        float* const out = c + (long long)row * n + n0 + tx * 4;
        *reinterpret_cast<float4*>(out) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        *reinterpret_cast<float4*>(out + BN / 2) =
            make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
}

template <int TM, int BN>
int launch_dot_f32(const float* a, const float* w, float* c, int m, int n,
                   int k, int device, cudaStream_t stream) {
    using T = DotTile<TM, BN>;
    static std::atomic<bool> ready[MAX_DEVICES];
    const cudaError_t err =
        opt_in_smem(dot_f32_kernel<TM, BN>, device, ready);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((m + T::BM - 1) / T::BM, n / BN);
    dot_f32_kernel<TM, BN><<<grid, T::THREADS, T::SMEM, stream>>>(a, w, c, m,
                                                                  n, k);
    return (int)cudaGetLastError();
}

// --- the HIGH products on the tensor cores -------------------------------------

constexpr int EM = 64, EN = 128, EK = 32;  // block tile; K chunk
constexpr int ET = 256;    // threads: 8 warps, 2 along M x 4 along N
constexpr int ERING = 3;   // cp.async ring stages
// bf16 row padding: the 8 rows an ldmatrix reads start on distinct bank
// groups, and every row stays 16-byte aligned
constexpr int EPAD = 8;
constexpr int E_LDA = EK + EPAD, E_LDB = EN + EPAD;  // bf16 rows
constexpr int E_A_PLANE = EM * E_LDA;  // one plane of the split A tile
constexpr int E_B_PLANE = EK * E_LDB;  // one plane of a chunk's weights
constexpr int E_STAGE_A = EM * EK * (int)sizeof(float);

// The two HIGH routes differ only in the weight's form and the
// accumulators:
//   - F32_W: the weight arrives f32 (K, N); a ring stage holds its (EK, EN)
//     f32 tile, split once per chunk into the W tile's bf16 hi and lo planes
//     in shared memory, as the activation is. Else it arrives pre-split as
//     (2, K, N) bf16 hi, lo, and a ring stage holds both planes.
//   - ONE_ACC: hi*hi, hi*lo and lo*hi added into one accumulator for each
//     16 taps, in that order (dot_high); else hi*hi in one and hi*lo +
//     lo*hi in another, added in the epilogue (dot_high_emulated).
//   With an f32 weight the split is three times the work, so it is
//   pipelined: chunk k+1 is split while chunk k's product runs, into the
//   other of two split buffers, one barrier a chunk, and a ring of 2 stages
//   keeps the whole within two blocks an SM. A pre-split weight keeps one
//   split buffer, a ring of 3 and two barriers a chunk.
template <bool F32_W>
struct HiloSmem {
    static constexpr int NBUF = F32_W ? 2 : 1;     // split buffers
    static constexpr int RING = F32_W ? 2 : ERING;  // cp.async stages
    // bf16 elements of a split buffer: the A tile's two planes, then the W
    // tile's two planes (F32_W)
    static constexpr int BUF = 2 * (E_A_PLANE + (F32_W ? E_B_PLANE : 0));
    // bytes: a ring stage (the f32 activation tile, then the weight: f32,
    // or its hi and lo planes), then the whole: the split buffers and the
    // ring
    static constexpr int STAGE_W = F32_W
        ? EK * EN * (int)sizeof(float)
        : 2 * E_B_PLANE * (int)sizeof(__nv_bfloat16);
    static constexpr int STAGE = E_STAGE_A + STAGE_W;
    static constexpr int SPLIT = NBUF * BUF * (int)sizeof(__nv_bfloat16);
    static constexpr int BYTES = SPLIT + RING * STAGE;
};

template <bool F32_W, bool ONE_ACC>
__global__ void __launch_bounds__(ET, 2)
dot_hilo_mma_kernel(const float* __restrict__ a,
                    const void* __restrict__ w_any,
                    float* __restrict__ c, int m, int n, int k) {
    using L = HiloSmem<F32_W>;
    constexpr int NACC = ONE_ACC ? 1 : 2;
    extern __shared__ __align__(16) unsigned char esmem[];
    // split buffer b: the A tile's hi, lo planes, then (F32_W) the W tile's
    __nv_bfloat16* const split_base = reinterpret_cast<__nv_bfloat16*>(esmem);
    unsigned char* const ring = esmem + L::SPLIT;
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int wm = warp / 4, wn = warp % 4;  // the warp's 32 x 32 sub-tile
    const int m0 = blockIdx.x * EM, n0 = blockIdx.y * EN;
    const int n_chunks = k / EK;
    const long long plane = (long long)k * n;

    auto stage_a = [&](int chunk) {
        return reinterpret_cast<float*>(ring + (chunk % L::RING) * L::STAGE);
    };
    auto stage_w = [&](int chunk) {
        return ring + (chunk % L::RING) * L::STAGE + E_STAGE_A;
    };
    // chunk k's (EM, EK) f32 activations (zero rows past M) and its (EK,
    // EN) weights (zero columns past N) into ring stage k % RING
    auto load_chunk = [&](int chunk) {
        const int k0 = chunk * EK;
        float* const A = stage_a(chunk);
#pragma unroll
        for (int i = 0; i < EM * EK / 4 / ET; ++i) {
            const int q = tid + i * ET;
            const int r = q / (EK / 4), cc = (q % (EK / 4)) * 4;
            const bool ok = m0 + r < m;
            cp_async16(A + r * EK + cc,
                       a + (long long)(ok ? m0 + r : 0) * k + k0 + cc, ok);
        }
        if constexpr (F32_W) {
            const float* const w = static_cast<const float*>(w_any);
            float* const W = reinterpret_cast<float*>(stage_w(chunk));
#pragma unroll
            for (int i = 0; i < EK * EN / 4 / ET; ++i) {
                const int q = tid + i * ET;
                const int r = q / (EN / 4), cc = (q % (EN / 4)) * 4;
                const bool ok = n0 + cc < n;
                cp_async16(W + r * EN + cc,
                           w + (long long)(k0 + r) * n + (ok ? n0 + cc : 0),
                           ok);
            }
        } else {
            const __nv_bfloat16* const w =
                static_cast<const __nv_bfloat16*>(w_any);
            __nv_bfloat16* const W =
                reinterpret_cast<__nv_bfloat16*>(stage_w(chunk));
#pragma unroll
            for (int i = 0; i < 2 * EK * EN / 8 / ET; ++i) {
                const int q = tid + i * ET;
                const int p = q / (EK * EN / 8), r = (q / (EN / 8)) % EK;
                const int cc = (q % (EN / 8)) * 8;
                const bool ok = n0 + cc < n;
                cp_async16(W + p * E_B_PLANE + r * E_LDB + cc,
                           w + p * plane + (long long)(k0 + r) * n +
                               (ok ? n0 + cc : 0),
                           ok);
            }
        }
    };
    // chunk k's activations (and an f32 weight) split once into the A (and
    // W) tile's hi and lo planes of split buffer k % NBUF
    auto split = [&](int chunk) {
        const float* const A = stage_a(chunk);
        __nv_bfloat16* const As = split_base + (chunk % L::NBUF) * L::BUF;
        __nv_bfloat16* const Ws = As + 2 * E_A_PLANE;
#pragma unroll
        for (int i = 0; i < EM * EK / 4 / ET; ++i) {
            const int q = tid + i * ET;
            const int r = q / (EK / 4), cc = (q % (EK / 4)) * 4;
            split_hi_lo(lds4(A + r * EK + cc), As + r * E_LDA + cc,
                        As + E_A_PLANE + r * E_LDA + cc);
        }
        if constexpr (F32_W) {
            const float* const W = reinterpret_cast<const float*>(
                stage_w(chunk));
#pragma unroll
            for (int i = 0; i < EK * EN / 4 / ET; ++i) {
                const int q = tid + i * ET;
                const int r = q / (EN / 4), cc = (q % (EN / 4)) * 4;
                split_hi_lo(lds4(W + r * EN + cc), Ws + r * E_LDB + cc,
                            Ws + E_B_PLANE + r * E_LDB + cc);
            }
        }
    };

    // ONE_ACC: acc[0] takes all three products; else acc[0]: a_hi * w_hi,
    // acc[1]: a_hi * w_lo + a_lo * w_hi
    float acc[NACC][2][4][4];
#pragma unroll
    for (int p = 0; p < NACC; ++p)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[p][i][j][e] = 0.f;

    auto multiply = [&](int chunk) {
        const __nv_bfloat16* const As =
            split_base + (chunk % L::NBUF) * L::BUF;
        const __nv_bfloat16* const W =
            F32_W ? As + 2 * E_A_PLANE
                  : reinterpret_cast<const __nv_bfloat16*>(stage_w(chunk));
#pragma unroll
        for (int ks = 0; ks < EK; ks += 16) {
            uint32_t af[2][2][4], bf[2][4][2];
#pragma unroll
            for (int p = 0; p < 2; ++p) {
                // A: lanes 0-15 rows 0-15 at k, lanes 16-31 the same rows
                // at k + 8 (a0..a3 of the m16n8k16 fragment)
#pragma unroll
                for (int i = 0; i < 2; ++i)
                    ldmatrix_x4(af[p][i],
                                As + p * E_A_PLANE +
                                    (wm * 32 + i * 16 + lane % 16) * E_LDA +
                                    ks + (lane / 16) * 8);
                // B, stored (k, n): transposed loads of k rows 0-15 at
                // columns n and n + 8 give two n8 tiles' (b0, b1)
#pragma unroll
                for (int jj = 0; jj < 2; ++jj) {
                    uint32_t r[4];
                    ldmatrix_x4_trans(r, W + p * E_B_PLANE +
                                             (ks + lane % 16) * E_LDB +
                                             wn * 32 + jj * 16 +
                                             (lane / 16) * 8);
                    bf[p][2 * jj][0] = r[0];
                    bf[p][2 * jj][1] = r[1];
                    bf[p][2 * jj + 1][0] = r[2];
                    bf[p][2 * jj + 1][1] = r[3];
                }
            }
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    mma_bf16(acc[0][i][j], af[0][i], bf[0][j]);
                    mma_bf16(acc[NACC - 1][i][j], af[0][i], bf[1][j]);
                    mma_bf16(acc[NACC - 1][i][j], af[1][i], bf[0][j]);
                }
        }
    };

    // Chunk k's stage was committed as cp.async group k.
    if constexpr (F32_W) {
        // Iteration k: the barrier follows the wait for chunk k+1 and ends
        // chunk k-1's product and chunk k's split, so stage k % 2 can be
        // refilled with chunk k+2 and split buffer (k+1) % 2 rewritten
        // while chunk k's product runs.
        load_chunk(0);
        cp_async_commit();
        if (n_chunks > 1) load_chunk(1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        split(0);
        for (int kc = 0; kc < n_chunks; ++kc) {
            cp_async_wait<0>();
            __syncthreads();
            if (kc + 2 < n_chunks) load_chunk(kc + 2);
            cp_async_commit();
            if (kc + 1 < n_chunks) split(kc + 1);
            multiply(kc);
        }
    } else {
#pragma unroll
        for (int s = 0; s < ERING - 1; ++s) {
            if (s < n_chunks) load_chunk(s);
            cp_async_commit();
        }
        // The first barrier of iteration k follows the wait for chunk k and
        // ends chunk k-1's product, so stage (k-1) % RING can be refilled
        // and the split tiles rewritten; the second makes the split tiles
        // whole before the product.
        for (int kc = 0; kc < n_chunks; ++kc) {
            cp_async_wait<ERING - 2>();
            __syncthreads();
            if (kc + ERING - 1 < n_chunks) load_chunk(kc + ERING - 1);
            cp_async_commit();
            split(kc);
            __syncthreads();
            multiply(kc);
        }
    }

    // c0, c1 of an mma tile are row g's columns 2t, 2t+1 and c2, c3 row
    // g+8's; each pair of lanes swaps halves, so the even lane stores row
    // g's columns 2t..2t+3 and the odd lane row g+8's 2t-2..2t+1
    const int g = lane / 4, t = lane % 4;
    const bool odd = t & 1;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            float v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
                v[e] = ONE_ACC ? acc[0][i][j][e]
                               : acc[0][i][j][e] + acc[NACC - 1][i][j][e];
            const float s0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[2], 1);
            const float s1 = __shfl_xor_sync(0xffffffffu, odd ? v[1] : v[3], 1);
            const int row = m0 + wm * 32 + i * 16 + g + (odd ? 8 : 0);
            const int col = n0 + wn * 32 + j * 8 + 2 * (t & ~1);
            if (row < m && col < n)
                *reinterpret_cast<float4*>(c + (long long)row * n + col) =
                    odd ? make_float4(s0, s1, v[2], v[3])
                        : make_float4(v[0], v[1], s0, s1);
        }
}

// one HIGH product: the kernel's instance for the weight's form and the
// accumulators, after the opt-in to its shared memory
template <bool F32_W, bool ONE_ACC>
int launch_hilo(const float* a, const void* w, float* c, int m, int n, int k,
                cudaStream_t stream) {
    static std::atomic<bool> ready[MAX_DEVICES];
    int device = 0;
    cudaGetDevice(&device);
    const cudaError_t err =
        opt_in_smem(dot_hilo_mma_kernel<F32_W, ONE_ACC>, device, ready);
    if (err != cudaSuccess) return (int)err;
    dot_hilo_mma_kernel<F32_W, ONE_ACC>
        <<<dim3((m + EM - 1) / EM, (n + EN - 1) / EN), ET,
           HiloSmem<F32_W>::BYTES, stream>>>(a, w, c, m, n, k);
    return (int)cudaGetLastError();
}

// --- the FMA chain ----------------------------------------------------------------

__global__ void fma_chain_kernel(const float4* __restrict__ x,
                                 float4* __restrict__ y, long long n4,
                                 int steps, float a, float b) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n4; i += stride) {
        float4 v = x[i];
#pragma unroll 8
        for (int s = 0; s < steps; ++s) {
            v.x = fmaf(v.x, a, b);
            v.y = fmaf(v.y, a, b);
            v.z = fmaf(v.z, a, b);
            v.w = fmaf(v.w, a, b);
        }
        y[i] = v;
    }
}

bool dot_shape_ok(int m, int n, int k) {
    return m > 0 && n > 0 && k > 0 && n % 64 == 0 && k % 32 == 0;
}

}  // namespace

extern "C" {

// `count` layout cases (ids 0..19, the order of ops/probe.py's CASES) in
// one launch: case i reads ptrs[3 i] (and ptrs[3 i + 1], the weight of
// outer_broadcast_mul) and writes ptrs[3 i + 2]; dims[8 i ..] holds its
// input then its output shape, 4 entries each with leading ones. Every
// input and output must have under 2^31 elements.
int bz_probe_remap_batch(int count, const int* ids, const int64_t* ptrs,
                         const int* dims, void* stream) {
    if (count <= 0 || count > MAX_REMAP) return (int)cudaErrorInvalidValue;
    RemapBatch batch{};
    batch.count = count;
    long long blocks = 0;
    for (int c = 0; c < count; ++c) {
        RemapCase& R = batch.c[c];
        R.id = ids[c];
        if (R.id < 0 || R.id >= N_CASES) return (int)cudaErrorInvalidValue;
        R.x = reinterpret_cast<const float*>(ptrs[3 * c]);
        R.w = reinterpret_cast<const float*>(ptrs[3 * c + 1]);
        R.y = reinterpret_cast<float*>(ptrs[3 * c + 2]);
        long long n_in = 1, n_out = 1;
        for (int d = 0; d < 4; ++d) {
            R.D.i[d] = dims[8 * c + d];
            R.D.o[d] = dims[8 * c + 4 + d];
            if (R.D.i[d] <= 0 || R.D.o[d] <= 0)
                return (int)cudaErrorInvalidValue;
            n_in *= R.D.i[d];
            n_out *= R.D.o[d];
        }
        if (n_in >= (1LL << 31) || n_out >= (1LL << 31))
            return (int)cudaErrorInvalidValue;
        R.n = (int)n_out;
        R.vec = R.D.o[3] % 4 == 0 &&
                reinterpret_cast<uintptr_t>(R.y) % 16 == 0;
        R.first = (int)blocks;
        blocks += (n_out + R_BLOCK - 1) / R_BLOCK;
    }
    remap_kernel<<<(unsigned)blocks, RT, 0,
                   static_cast<cudaStream_t>(stream)>>>(batch);
    return (int)cudaGetLastError();
}

// One layout case: a batch of one. dims holds the input then the output
// shape, 4 entries each with leading ones; n_out = the output's size.
int bz_probe_remap(int case_id, const float* x, const float* w, float* y,
                   const int64_t* dims, long long n_out, void* stream) {
    int d32[8];
    long long size = 1;
    for (int d = 0; d < 8; ++d) {
        if (dims[d] <= 0 || dims[d] >= (1LL << 31))
            return (int)cudaErrorInvalidValue;
        d32[d] = (int)dims[d];
        if (d >= 4) size *= dims[d];
    }
    if (size != n_out) return (int)cudaErrorInvalidValue;
    const int64_t ptrs[3] = {reinterpret_cast<int64_t>(x),
                             reinterpret_cast<int64_t>(w),
                             reinterpret_cast<int64_t>(y)};
    return bz_probe_remap_batch(1, &case_id, ptrs, d32, stream);
}

// c (m, n) = a (m, k) @ w (k, n), exact f32 on FFMA. The tile: BN = 128
// where N allows it, else 64; TM = 5 or 4 rows per thread; the pair that
// gives the busiest SM the fewest outputs (its ceil(blocks / SMs) blocks of
// 16 TM x BN), the larger tile on a tie.
int bz_probe_dot_f32(const float* a, const float* w, float* c, int m, int n,
                     int k, void* stream) {
    if (!dot_shape_ok(m, n, k)) return (int)cudaErrorInvalidValue;
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (sms <= 0) return (int)cudaErrorInvalidDevice;
    auto busiest = [&](int tm, int bn) {
        const int bm = tm * DTY;
        const long long blocks = (long long)((m + bm - 1) / bm) * (n / bn);
        return (blocks + sms - 1) / sms * bm * bn;
    };
    int tm = 0, bn = 0;  // candidates from the largest tile down
    for (const int b : {128, 64}) {
        if (n % b != 0) continue;
        for (const int t : {5, 4})
            if (tm == 0 || busiest(t, b) < busiest(tm, bn)) tm = t, bn = b;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bn == 128)
        return tm == 5 ? launch_dot_f32<5, 128>(a, w, c, m, n, k, device, s)
                       : launch_dot_f32<4, 128>(a, w, c, m, n, k, device, s);
    return tm == 5 ? launch_dot_f32<5, 64>(a, w, c, m, n, k, device, s)
                   : launch_dot_f32<4, 64>(a, w, c, m, n, k, device, s);
}

// c = a @ w at HIGH on the tensor cores: a (m, k) and w (k, n) f32, split
// into bf16 hi/lo in shared memory; hi*hi + hi*lo + lo*hi, f32 accumulate.
int bz_probe_dot_high(const float* a, const float* w, float* c, int m, int n,
                      int k, void* stream) {
    if (!dot_shape_ok(m, n, k)) return (int)cudaErrorInvalidValue;
    return launch_hilo<true, true>(a, w, c, m, n, k,
                                   static_cast<cudaStream_t>(stream));
}

// c = a @ w at emulated HIGH on the tensor cores: w_hilo (2, k, n) bf16 hi
// then lo; hi*hi and hi*lo + lo*hi in two f32 accumulators.
int bz_probe_dot_high_emulated(const float* a, const void* w_hilo, float* c,
                               int m, int n, int k, void* stream) {
    if (!dot_shape_ok(m, n, k)) return (int)cudaErrorInvalidValue;
    return launch_hilo<false, false>(a, w_hilo, c, m, n, k,
                                     static_cast<cudaStream_t>(stream));
}

// y = x after `steps` of v = fma(v, a, b); n a multiple of 4.
int bz_probe_fma_chain(const float* x, float* y, long long n, int steps,
                       float a, float b, void* stream) {
    if (n <= 0 || n % 4 != 0 || steps < 0) return (int)cudaErrorInvalidValue;
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const long long n4 = n / 4;
    const int threads = 256;
    long long blocks = (n4 + threads - 1) / threads;
    if (blocks > 8LL * sms) blocks = 8LL * sms;  // one full wave, then loop
    fma_chain_kernel<<<(unsigned)blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(y), n4,
        steps, a, b);
    return (int)cudaGetLastError();
}

const char* bz_probe_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
