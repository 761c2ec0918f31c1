// The capability probe's kernels: layout remaps, three matrix products, and
// an FMA chain.
//
// Replaces the TPU kernels of tools/mosaic_capability_probe.py: `run` (one
// whole-array kernel per layout case), `case_collapsed_dot`,
// `case_dot_high` and `case_dot_high_emulated`. On the TPU the probe asked
// which tensor-shape operations the Mosaic compiler lowers at all. On this
// card every form compiles, so what the probe checks here is the index
// arithmetic a fused front would use (stride-2 subsampling, rolls,
// pad-shifts, a row gather), and which of the card's two tensor-core routes
// to an emulated-HIGH product is faster: the native one (wmma, both
// operands split in shared memory, one accumulator), or the one
// csrc/sepconv.cu's HIGH mode runs (mma.sync on a pre-split weight, two
// accumulators).
//
// remap (for `run`). One __global__ template over a case functor: each
// output element is one input element (its flat offset from the case's
// index arithmetic, written out below per case), or zero for the mask and
// pad cases, or (outer_broadcast_mul) an input element times a weight. The
// host passes the input and output shapes, padded to 4 dims with leading
// ones. Bound: bytes (each input element read once, each output written
// once); a grid-stride loop with one element per thread and iteration.
// Exact: it moves values, and outer_broadcast_mul is one f32 multiply.
//
// dot_f32 (for `case_collapsed_dot`). (M, K) @ (K, N) in exact f32: a
// tiled FFMA product, 64 x 64 outputs per block of 256 threads, 4 x 4 per
// thread from float4 shared-memory reads, K staged in chunks of 16. No
// TF32, no tensor cores; every output is one thread's sum in a fixed order
// (k ascending), so results are identical from run to run. Bound: FFMA
// throughput (2 M N K operations at the f32 peak) at the shapes the probe
// and the conv tail use.
//
// dot_high (for `case_dot_high`, "native HIGH"). The card's native form of
// the TPU's three-pass HIGH: f32 activation and f32 weight are split into
// bf16 hi and lo halves as they are staged in shared memory
// (hi = bf16(v), lo = bf16(v - hi), round to nearest even), and
// hi*hi + hi*lo + lo*hi run on the tensor cores with f32 accumulation
// (nvcuda::wmma bf16 16x16x16 fragments). 64 x 64 outputs per block of 4
// warps, each warp 32 x 32 (2 x 2 fragments), K staged in chunks of 32.
// Shared-memory rows are padded by 8 bf16 (ldm a multiple of 8 elements,
// every fragment pointer 32-byte aligned); the M edge is masked with zero
// rows, and the output goes through shared memory so that masked rows are
// never stored. Bound: three bf16 products (6 M N K operations) at the
// tensor cores' dense bf16 peak, or the bytes, whichever is larger. No wgmma,
// no TMA, no pipelining: simple and right first.
//
// dot_high_emulated (for `case_dot_high_emulated`, the TPU's `_pw_dot` at
// HIGH: three one-pass bf16 products on the MXU). The product of
// csrc/sepconv.cu's HIGH mode on its own, on the tensor cores. The weight
// arrives pre-split as (2, K, N) bf16 hi and lo planes
// (ops/sepconv.pack_pointwise(w, 'high')); a ring of 3 cp.async stages
// brings each K chunk of 32 (the f32 activation tile and both weight
// planes, 16 bytes a thread) to shared memory while earlier chunks
// compute; each chunk's activation is split once into bf16 hi and lo planes
// in shared memory (a_hi = bf16(a), a_lo = bf16(a - a_hi)); ldmatrix feeds
// mma.sync.m16n8k16 bf16 -> f32 with two accumulators, hi*hi and
// hi*lo + lo*hi, added in the epilogue, exactly as sep_layer_mma_kernel
// does. 64 x 128 outputs per block of 8 warps (2 along M x 4 along N, each
// 32 x 32), so the conv tail's shapes launch 316 (5016 x 512) and 160
// (1254 x 1024) blocks, at least one per SM; the M edge is masked with
// zero rows and an N edge (N = 64 mod 128) with zero columns, neither
// stored. K in order, no split K, no atomics: identical from run to run.
// Bound: three bf16 products at the dense bf16 peak, as dot_high. Measured
// (chip_smoke.py, H100 SXM at 700 W): 0.035 ms device time at 5016 x 512 x
// 512 and 0.041 at 1254 x 1024 x 1024, 4-5x that bound and 0.58-0.65x
// torch.matmul in f32; the earlier FFMA kernel took 0.26-0.30 ms. Within
// 2.2e-4 of float64 on standard-normal operands at K = 1024 (dot_high, one
// accumulator: 6.3e-4).
//
// fma_chain (for tools/roofline.py's measured f32 peak). Each thread keeps
// four independent values in registers and applies v = fma(v, a, b) to each
// `steps` times: 2 operations per step and value, against 8 bytes of
// traffic per value. Bound: FFMA throughput.
//
// Plain C interface, loaded with ctypes; every function returns a
// cudaError_t code (0 = success) and launches on the given stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <atomic>

#include "ptx.cuh"

namespace {

// --- remap -------------------------------------------------------------------

struct Dims {
    long long i[4];  // input shape, leading ones
    long long o[4];  // output shape, leading ones
};

__device__ __forceinline__ long long ravel(long long a, long long b,
                                           long long c, long long d,
                                           const long long* s) {
    return ((a * s[1] + b) * s[2] + c) * s[3] + d;
}

__device__ __forceinline__ long long wrap(long long v, long long n) {
    return ((v % n) + n) % n;
}

struct NoMul {
    static constexpr bool kMul = false;
    __device__ static long long mul(const long long*, const Dims&) {
        return 0;
    }
};

// Each case: src(o, D) is the input offset of output index o (4 dims), or
// -1 for a zero. The comments give the numpy expression the probe checks.

// x[:, :, ::2]
struct StrideLane : NoMul {
    __device__ static long long src(const long long* o, const Dims& D) {
        return ravel(o[0], o[1], o[2], 2 * o[3], D.i);
    }
};

// x[:, ::2, :]
struct StrideSublane : NoMul {
    __device__ static long long src(const long long* o, const Dims& D) {
        return ravel(o[0], o[1], 2 * o[2], o[3], D.i);
    }
};

// x[::2] on (N, H, W, C)
struct StrideLeading : NoMul {
    __device__ static long long src(const long long* o, const Dims& D) {
        return ravel(2 * o[0], o[1], o[2], o[3], D.i);
    }
};

// x.reshape(N / 2, 2, H, W, C)[:, 0]: leading index n -> 2 n + 0
struct ReshapeLeadingSplit : NoMul {
    __device__ static long long src(const long long* o, const Dims& D) {
        return ravel(o[0] * 2 + 0, o[1], o[2], o[3], D.i);
    }
};

// (N, H, W, C) -> (N * H, W, C): output row r is (r / H, r % H)
struct ReshapeLeadingMerge : NoMul {
    __device__ static long long src(const long long* o, const Dims& D) {
        return ravel(o[1] / D.i[1], o[1] % D.i[1], o[2], o[3], D.i);
    }
};

// (N, H, W, C) -> (N * H * W, C)
struct CollapseTo2d : NoMul {
    __device__ static long long src(const long long* o, const Dims& D) {
        const long long r = o[2], hw = D.i[1] * D.i[2];
        return ravel(r / hw, (r / D.i[2]) % D.i[1], r % D.i[2], o[3], D.i);
    }
};

// (R, W * C) -> (R, W, C)
struct SplitMinor : NoMul {
    __device__ static long long src(const long long* o, const Dims& D) {
        return ravel(0, 0, o[1], o[2] * D.o[3] + o[3], D.i);
    }
};

// np.roll(x, 1, 1)
struct RollSublane : NoMul {
    __device__ static long long src(const long long* o, const Dims& D) {
        return ravel(o[0], o[1], wrap(o[2] - 1, D.i[2]), o[3], D.i);
    }
};

// np.roll(x, 128, 2)
struct RollLane : NoMul {
    __device__ static long long src(const long long* o, const Dims& D) {
        return ravel(o[0], o[1], o[2], wrap(o[3] - 128, D.i[3]), D.i);
    }
};

// np.pad(x, ((0, 0), (1, 0), (0, 0)))[:, :-1, :]
struct PadSliceShift : NoMul {
    __device__ static long long src(const long long* o, const Dims& D) {
        return o[2] == 0 ? -1 : ravel(o[0], o[1], o[2] - 1, o[3], D.i);
    }
};

// np.swapaxes(x, 1, 2)
struct TransposeMinor : NoMul {
    __device__ static long long src(const long long* o, const Dims& D) {
        return ravel(o[0], o[1], o[3], o[2], D.i);
    }
};

// (N, H, W, C) as rows (N * H * W, C); output row (p, ho, wo) of
// (N, H / 2, W / 2) reads row p * H * W + 2 ho * W + 2 wo
struct RowGather : NoMul {
    __device__ static long long src(const long long* o, const Dims& D) {
        const long long h2 = D.i[1] / 2, w2 = D.i[2] / 2, r = o[2];
        const long long p = r / (h2 * w2), ho = (r / w2) % h2, wo = r % w2;
        return ravel(p, 2 * ho, 2 * wo, o[3], D.i);
    }
};

// np.where(pos % 4 == 0, 0, x), pos the index on axis 1
struct IotaMask : NoMul {
    __device__ static long long src(const long long* o, const Dims& D) {
        return (o[2] & 3) == 0 ? -1 : ravel(o[0], o[1], o[2], o[3], D.i);
    }
};

// np.where(pos % 3 == 0, 0, x)
struct IotaMod24 : NoMul {
    __device__ static long long src(const long long* o, const Dims& D) {
        return o[2] % 3 == 0 ? -1 : ravel(o[0], o[1], o[2], o[3], D.i);
    }
};

// x.reshape(A, B / 2, 2, C)[:, :, 0]
struct SplitSublane : NoMul {
    __device__ static long long src(const long long* o, const Dims& D) {
        return ravel(o[0], o[1], o[2] * 2 + 0, o[3], D.i);
    }
};

// np.roll(x, 32, 2)
struct RollLane32 : NoMul {
    __device__ static long long src(const long long* o, const Dims& D) {
        return ravel(o[0], o[1], o[2], wrap(o[3] - 32, D.i[3]), D.i);
    }
};

// np.pad(x, ((0, 0), (0, 0), (1, 0)))[:, :, :-1]
struct PadSliceLane : NoMul {
    __device__ static long long src(const long long* o, const Dims& D) {
        return o[3] == 0 ? -1 : ravel(o[0], o[1], o[2], o[3] - 1, D.i);
    }
};

// (A, B, W * C) -> (A, B, W, C)
struct SplitMinorSmall : NoMul {
    __device__ static long long src(const long long* o, const Dims& D) {
        return ravel(0, o[0], o[1], o[2] * D.o[3] + o[3], D.i);
    }
};

// (A, R, Q * C) -> reshape (A, R, Q, C) -> swapaxes(1, 2) -> (A * Q, R, C)
struct SwapNonminorMerge : NoMul {
    __device__ static long long src(const long long* o, const Dims& D) {
        const long long q_count = D.i[3] / D.o[3];
        const long long a = o[1] / q_count, q = o[1] % q_count;
        return ravel(0, a, o[2], q * D.o[3] + o[3], D.i);
    }
};

// x * w, w of shape (C, 1, 1) against x (C, H, L)
struct OuterBroadcastMul {
    static constexpr bool kMul = true;
    __device__ static long long src(const long long* o, const Dims& D) {
        return ravel(o[0], o[1], o[2], o[3], D.i);
    }
    __device__ static long long mul(const long long* o, const Dims&) {
        return o[1];
    }
};

template <class Case>
__global__ void remap_kernel(const float* __restrict__ x,
                             const float* __restrict__ w,
                             float* __restrict__ y, const Dims D,
                             long long n) {
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += step) {
        long long o[4];
        long long r = i;
#pragma unroll
        for (int d = 3; d >= 0; --d) {
            o[d] = r % D.o[d];
            r /= D.o[d];
        }
        const long long s = Case::src(o, D);
        float v = s < 0 ? 0.f : x[s];
        if (Case::kMul) v *= w[Case::mul(o, D)];
        y[i] = v;
    }
}

template <class Case>
int launch_remap(const float* x, const float* w, float* y, const Dims& D,
                 long long n, cudaStream_t stream) {
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    remap_kernel<Case><<<(unsigned)(blocks < 4096 ? blocks : 4096), threads,
                         0, stream>>>(x, w, y, D, n);
    return (int)cudaGetLastError();
}

// --- the FFMA product ------------------------------------------------------------

constexpr int FM = 64, FN = 64, FK = 16;  // block tile; K chunk
constexpr int FT = 256;                   // threads: 16 x 16, 4 x 4 outputs each
constexpr int APAD = 4;                   // keeps As rows 16-byte aligned

__global__ void __launch_bounds__(FT)
dot_f32_kernel(const float* __restrict__ a, const float* __restrict__ w,
               float* __restrict__ c, int m, int n, int k) {
    __shared__ __align__(16) float As[FK][FM + APAD];
    __shared__ __align__(16) float Ws[FK][FN];
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int m0 = blockIdx.x * FM, n0 = blockIdx.y * FN;
    // staging: one float4 of the A tile (row ar, k ak..ak+3) and one of
    // the W tile (row wr, columns wc..wc+3) per thread
    const int ar = tid / (FK / 4), ak = (tid % (FK / 4)) * 4;
    const int wr = tid / (FN / 4), wc = (tid % (FN / 4)) * 4;

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < k; k0 += FK) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (m0 + ar < m)
            v = *reinterpret_cast<const float4*>(a + (long long)(m0 + ar) * k
                                                 + k0 + ak);
        As[ak + 0][ar] = v.x;
        As[ak + 1][ar] = v.y;
        As[ak + 2][ar] = v.z;
        As[ak + 3][ar] = v.w;
        *reinterpret_cast<float4*>(&Ws[wr][wc]) =
            *reinterpret_cast<const float4*>(w + (long long)(k0 + wr) * n +
                                             n0 + wc);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < FK; ++kk) {
            const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
            const float4 b4 = *reinterpret_cast<const float4*>(&Ws[kk][tx * 4]);
            const float av[4] = {a4.x, a4.y, a4.z, a4.w};
            const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = m0 + ty * 4 + i;
        if (row >= m) continue;
        *reinterpret_cast<float4*>(c + (long long)row * n + n0 + tx * 4) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
}

// --- the emulated-HIGH product on the tensor cores -------------------------------

constexpr int EM = 64, EN = 128, EK = 32;  // block tile; K chunk
constexpr int ET = 256;    // threads: 8 warps, 2 along M x 4 along N
constexpr int ERING = 3;   // cp.async ring stages
// bf16 row padding: the 8 rows an ldmatrix reads start on distinct bank
// groups, and every row stays 16-byte aligned
constexpr int EPAD = 8;
constexpr int E_LDA = EK + EPAD, E_LDB = EN + EPAD;  // bf16 rows
constexpr int E_A_PLANE = EM * E_LDA;  // one plane of the split A tile
constexpr int E_B_PLANE = EK * E_LDB;  // one plane of a chunk's weights
// bytes: a ring stage (the f32 activation tile, then the weights' hi and
// lo planes), then the whole: the split A tile's two planes and the ring
constexpr int E_STAGE_A = EM * EK * (int)sizeof(float);
constexpr int E_STAGE = E_STAGE_A + 2 * E_B_PLANE * (int)sizeof(__nv_bfloat16);
constexpr int E_SMEM =
    2 * E_A_PLANE * (int)sizeof(__nv_bfloat16) + ERING * E_STAGE;

__global__ void __launch_bounds__(ET, 2)
dot_hilo_mma_kernel(const float* __restrict__ a,
                    const __nv_bfloat16* __restrict__ w,
                    float* __restrict__ c, int m, int n, int k) {
    extern __shared__ __align__(16) unsigned char esmem[];
    __nv_bfloat16* const As = reinterpret_cast<__nv_bfloat16*>(esmem);
    unsigned char* const ring =
        esmem + 2 * E_A_PLANE * (int)sizeof(__nv_bfloat16);
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int wm = warp / 4, wn = warp % 4;  // the warp's 32 x 32 sub-tile
    const int m0 = blockIdx.x * EM, n0 = blockIdx.y * EN;
    const int n_chunks = k / EK;
    const long long plane = (long long)k * n;

    auto stage_a = [&](int chunk) {
        return reinterpret_cast<float*>(ring + (chunk % ERING) * E_STAGE);
    };
    auto stage_w = [&](int chunk) {
        return reinterpret_cast<__nv_bfloat16*>(
            ring + (chunk % ERING) * E_STAGE + E_STAGE_A);
    };
    // chunk k's (EM, EK) f32 activations (zero rows past M) and its (EK,
    // EN) hi and lo weights (zero columns past N) into ring stage k % ERING
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
        __nv_bfloat16* const W = stage_w(chunk);
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
    };
    // chunk k's activations split once into the A tile's hi and lo planes
    auto split = [&](int chunk) {
        const float* const A = stage_a(chunk);
#pragma unroll
        for (int i = 0; i < EM * EK / 4 / ET; ++i) {
            const int q = tid + i * ET;
            const int r = q / (EK / 4), cc = (q % (EK / 4)) * 4;
            split_hi_lo(lds4(A + r * EK + cc), As + r * E_LDA + cc,
                        As + E_A_PLANE + r * E_LDA + cc);
        }
    };

    // acc[0]: a_hi * w_hi; acc[1]: a_hi * w_lo + a_lo * w_hi
    float acc[2][2][4][4];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[p][i][j][e] = 0.f;

    auto multiply = [&](int chunk) {
        const __nv_bfloat16* const W = stage_w(chunk);
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
                    mma_bf16(acc[1][i][j], af[0][i], bf[1][j]);
                    mma_bf16(acc[1][i][j], af[1][i], bf[0][j]);
                }
        }
    };

    // Chunk k's stage was committed as cp.async group k. The first barrier
    // of iteration k follows the wait for it and ends chunk k-1's product,
    // so stage (k-1) % ERING can be refilled and the A tile rewritten; the
    // second makes the A tile whole before the product.
#pragma unroll
    for (int s = 0; s < ERING - 1; ++s) {
        if (s < n_chunks) load_chunk(s);
        cp_async_commit();
    }
    for (int kc = 0; kc < n_chunks; ++kc) {
        cp_async_wait<ERING - 2>();
        __syncthreads();
        if (kc + ERING - 1 < n_chunks) load_chunk(kc + ERING - 1);
        cp_async_commit();
        split(kc);
        __syncthreads();
        multiply(kc);
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
                v[e] = acc[0][i][j][e] + acc[1][i][j][e];
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


// --- the native-HIGH product on the tensor cores (wmma) -------------------------

namespace wmma = nvcuda::wmma;

constexpr int HM = 64, HN = 64, HK = 32;  // block tile; K chunk
constexpr int HT = 128;                   // threads: 4 warps, 2 x 2
constexpr int LDA = HK + 8;               // bf16; a multiple of 8
constexpr int LDB = HN + 8;               // bf16; a multiple of 8
constexpr int LDC = HN + 4;               // f32; a multiple of 4

__global__ void __launch_bounds__(HT)
dot_high_kernel(const float* __restrict__ a, const float* __restrict__ w,
                float* __restrict__ c, int m, int n, int k) {
    __shared__ __align__(32) __nv_bfloat16 As[2][HM][LDA];  // hi, lo
    __shared__ __align__(32) __nv_bfloat16 Ws[2][HK][LDB];  // hi, lo
    __shared__ __align__(32) float Cs[HM][LDC];
    const int tid = threadIdx.x, warp = tid / 32;
    const int wm = warp / 2, wn = warp % 2;  // the warp's 32 x 32 sub-tile
    const int m0 = blockIdx.x * HM, n0 = blockIdx.y * HN;

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    for (int k0 = 0; k0 < k; k0 += HK) {
        for (int q = tid; q < HM * HK / 4; q += HT) {
            const int r = q / (HK / 4), cc = (q % (HK / 4)) * 4;
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);  // masked rows: 0
            if (m0 + r < m)
                v = *reinterpret_cast<const float4*>(
                    a + (long long)(m0 + r) * k + k0 + cc);
            split_hi_lo(v, &As[0][r][cc], &As[1][r][cc]);
        }
        for (int q = tid; q < HK * HN / 4; q += HT) {
            const int r = q / (HN / 4), cc = (q % (HN / 4)) * 4;
            const float4 v = *reinterpret_cast<const float4*>(
                w + (long long)(k0 + r) * n + n0 + cc);
            split_hi_lo(v, &Ws[0][r][cc], &Ws[1][r][cc]);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < HK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> fa[2][2];  // [plane][i]
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> fb[2][2];  // [plane][j]
#pragma unroll
            for (int p = 0; p < 2; ++p)
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    wmma::load_matrix_sync(fa[p][i],
                                           &As[p][wm * 32 + i * 16][kk], LDA);
                    wmma::load_matrix_sync(fb[p][i],
                                           &Ws[p][kk][wn * 32 + i * 16], LDB);
                }
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    wmma::mma_sync(acc[i][j], fa[0][i], fb[0][j], acc[i][j]);
                    wmma::mma_sync(acc[i][j], fa[0][i], fb[1][j], acc[i][j]);
                    wmma::mma_sync(acc[i][j], fa[1][i], fb[0][j], acc[i][j]);
                }
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
            wmma::store_matrix_sync(&Cs[wm * 32 + i * 16][wn * 32 + j * 16],
                                    acc[i][j], LDC, wmma::mem_row_major);
    __syncthreads();
    for (int q = tid; q < HM * HN / 4; q += HT) {
        const int r = q / (HN / 4), cc = (q % (HN / 4)) * 4;
        if (m0 + r < m)
            *reinterpret_cast<float4*>(c + (long long)(m0 + r) * n + n0 + cc) =
                *reinterpret_cast<const float4*>(&Cs[r][cc]);
    }
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

// One layout case (0..19, the order of ops/probe.py's CASES) from x (and w
// for outer_broadcast_mul) into y; dims holds the input then the output
// shape, 4 entries each with leading ones; n_out = the output's size.
int bz_probe_remap(int case_id, const float* x, const float* w, float* y,
                   const int64_t* dims, long long n_out, void* stream) {
    if (n_out <= 0) return (int)cudaErrorInvalidValue;
    Dims D;
    for (int d = 0; d < 4; ++d) {
        D.i[d] = dims[d];
        D.o[d] = dims[4 + d];
        if (D.i[d] <= 0 || D.o[d] <= 0) return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (case_id) {
        case 0: return launch_remap<StrideLane>(x, w, y, D, n_out, s);
        case 1: return launch_remap<StrideSublane>(x, w, y, D, n_out, s);
        case 2: return launch_remap<StrideLeading>(x, w, y, D, n_out, s);
        case 3: return launch_remap<ReshapeLeadingSplit>(x, w, y, D, n_out, s);
        case 4: return launch_remap<ReshapeLeadingMerge>(x, w, y, D, n_out, s);
        case 5: return launch_remap<CollapseTo2d>(x, w, y, D, n_out, s);
        case 6: return launch_remap<SplitMinor>(x, w, y, D, n_out, s);
        case 7: return launch_remap<RollSublane>(x, w, y, D, n_out, s);
        case 8: return launch_remap<RollLane>(x, w, y, D, n_out, s);
        case 9: return launch_remap<PadSliceShift>(x, w, y, D, n_out, s);
        case 10: return launch_remap<TransposeMinor>(x, w, y, D, n_out, s);
        case 11: return launch_remap<RowGather>(x, w, y, D, n_out, s);
        case 12: return launch_remap<IotaMask>(x, w, y, D, n_out, s);
        case 13: return launch_remap<IotaMod24>(x, w, y, D, n_out, s);
        case 14: return launch_remap<SplitSublane>(x, w, y, D, n_out, s);
        case 15: return launch_remap<RollLane32>(x, w, y, D, n_out, s);
        case 16: return launch_remap<PadSliceLane>(x, w, y, D, n_out, s);
        case 17: return launch_remap<SplitMinorSmall>(x, w, y, D, n_out, s);
        case 18: return launch_remap<SwapNonminorMerge>(x, w, y, D, n_out, s);
        case 19: return launch_remap<OuterBroadcastMul>(x, w, y, D, n_out, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// c (m, n) = a (m, k) @ w (k, n), exact f32 on FFMA.
int bz_probe_dot_f32(const float* a, const float* w, float* c, int m, int n,
                     int k, void* stream) {
    if (!dot_shape_ok(m, n, k)) return (int)cudaErrorInvalidValue;
    dot_f32_kernel<<<dim3((m + FM - 1) / FM, n / FN), FT, 0,
                     static_cast<cudaStream_t>(stream)>>>(a, w, c, m, n, k);
    return (int)cudaGetLastError();
}

// c = a @ w at HIGH on the tensor cores: a (m, k) and w (k, n) f32, split
// into bf16 hi/lo in shared memory; hi*hi + hi*lo + lo*hi, f32 accumulate.
int bz_probe_dot_high(const float* a, const float* w, float* c, int m, int n,
                      int k, void* stream) {
    if (!dot_shape_ok(m, n, k)) return (int)cudaErrorInvalidValue;
    dot_high_kernel<<<dim3((m + HM - 1) / HM, n / HN), HT, 0,
                      static_cast<cudaStream_t>(stream)>>>(a, w, c, m, n, k);
    return (int)cudaGetLastError();
}

// c = a @ w at emulated HIGH on the tensor cores: w_hilo (2, k, n) bf16 hi
// then lo; hi*hi and hi*lo + lo*hi in two f32 accumulators.
int bz_probe_dot_high_emulated(const float* a, const void* w_hilo, float* c,
                               int m, int n, int k, void* stream) {
    if (!dot_shape_ok(m, n, k)) return (int)cudaErrorInvalidValue;
    static std::atomic<bool> ready[MAX_DEVICES];
    int device = 0;
    cudaGetDevice(&device);
    const cudaError_t err = opt_in_smem(dot_hilo_mma_kernel, device, ready);
    if (err != cudaSuccess) return (int)err;
    dot_hilo_mma_kernel<<<dim3((m + EM - 1) / EM, (n + EN - 1) / EN), ET,
                          E_SMEM, static_cast<cudaStream_t>(stream)>>>(
        a, static_cast<const __nv_bfloat16*>(w_hilo), c, m, n, k);
    return (int)cudaGetLastError();
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
