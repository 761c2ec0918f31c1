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
// The depthwise taps, biases, ReLU and pooling stay f32 in every mode.
// Weights stay bf16 in device memory in BF16 and HIGH (half the bytes).
//
// Two kernels, one per route of the pointwise product, built on one
// scheme: a block owns BM positions x BN = min(F, 256) output channels; K
// goes in chunks of input channels, in order; a ring of cp.async stages
// brings each chunk's weights, its 9 depthwise taps and bias, and the
// window of input positions its outputs read to shared memory while
// earlier chunks compute; the chunk's depthwise is computed from that
// window into a shared-memory A tile, so it never reaches device memory.
//   sep_layer_kernel      HIGHEST: FFMA, exact f32 (the main path);
//   sep_layer_mma_kernel  BF16 and HIGH: bf16 operands on the tensor cores
//                         (mma.sync m16n8k16, f32 accumulate).
// Every layer ran faster on the tensor cores in BF16 and HIGH than on FFMA
// in exact f32 (chip_smoke.py prints the ratio per layer), so those modes
// take the tensor cores on every layer, and sep_layer_kernel is exact f32
// only.
//
// Bound on an H100 SXM. One 200 s chunk is 209 patches; the front does
// 26.7 M MAC per patch and the tail 41.5 M, so ~11.2 and ~17.3 GFLOP per
// chunk, against tens of MB of compulsory traffic (~41 MB of layer-1
// activations in, ~11 MB of tail weights). HIGHEST: at the card's 67
// TFLOP/s non-tensor f32 peak that is ~0.17 ms and ~0.26 ms (~0.21 and
// ~0.32 ms at the 54 TFLOP/s an FMA chain reaches on the card), bound by
// FFMA throughput, not by memory. BF16 and HIGH: one and three bf16
// products per multiply-add at 989 TFLOP/s, ~0.017 and ~0.052 ms for the
// tail. That is so little that the rest weighs as much: the tail's ~16-22
// MB of compulsory traffic (0.005-0.007 ms at 3.35 TB/s) and its
// depthwise, which stays on FFMA: 0.27 GFLOP per chunk, 0.004 ms at 67
// TFLOP/s, or 0.6 GFLOP (0.009 ms) with the recompute below.
//
// HIGHEST design (sep_layer_kernel<BN, TM>). 256 threads; each owns TM = 8,
// 5 or 4 positions x 8 output channels, the channels read as two float4s
// BN / 2 apart from the weight stage, the positions as float4s 4 * TY apart
// (TM = 8, 4) or five scalars (TM = 5) from the A tile; a warp is 8
// threads along N x 4 along M, so each of its reads touches at most 128
// distinct bytes. K in chunks of 16 input channels through a ring of 3
// cp.async stages (2 where 3 would leave one block per SM: layer 3), the
// chunk's (16, BN) f32 weights beside its taps, bias and input window. Two
// barriers per chunk, as the tensor-core kernel.
//   - Exact f32: FFMA only, no TF32, no tensor cores, no split K, no
//     atomics. The arithmetic is that of the earlier 64-channel FFMA
//     kernel, so its outputs are bit for bit the same: depthwise
//     a = x_centre * w[4], then fmaf over the other taps in tap order (a
//     tap off the image is skipped), then fmaxf(a + bias, 0); pointwise one
//     accumulator per output from 0, acc = fmaf(a_k, w_k, acc) for k
//     ascending; epilogue fmaxf(acc + bias, 0).
//   - Recompute. Each A tile is computed F / BN times: 1 on layers 2-6, 2
//     on 7-12, 4 on 13-14 (the earlier FFMA kernel's BN = 64: up to 16,
//     each tap a load from L2).
//   - Grid. BN = min(F, 256); TM = 8, 5 or 4, whichever gives the busiest
//     SM the fewest positions (ceil(blocks / SMs) x BM), the larger TM on a
//     tie. Two blocks fit an SM (registers and shared memory), 264 slots
//     on 132 SMs. At B = 209: layer 2 2508 blocks (BM 128, 9.5 waves of
//     264), 3 and 4 627 (BM 128, 2.4 waves), 5 and 6 502 (40, 1.9), 7-12
//     252 (40, 0.95: every SM one or two blocks, the busiest 80 positions
//     against a mean of 76; BM 32 gives 314 blocks and the busiest SM 96),
//     13-14 128 (40, one block on each of 128 SMs; BM 64 gives 80 blocks of
//     64 positions). The earlier kernel launched 320 blocks of 64 channels
//     on every tail layer, 1.21 waves. Only BM depends on the batch, never
//     BK, BN or the order of K, so a patch's outputs do not depend on it.
//   Pooling is a second small kernel that sums the spatial positions in a
//   fixed order.
//   Measured (chip_smoke.py, device time alone at B = 209, H100 SXM at 700
//   W): fused_tail 0.62 ms against the earlier kernel's 1.84 and the cuDNN
//   f32 stack's 1.12 (0.55x); fused_front 0.46 ms (earlier 1.07). Per
//   layer 1.9-3.0x the bound at 67 TFLOP/s; at the 54 TFLOP/s an FMA chain
//   reaches, layers 8-12 run at ~52% of FFMA throughput. What bounds it
//   now: the instructions around the FFMAs (shared-memory reads, the
//   depthwise, the cp.async issue) and two barriers per 16 channels, at
//   two blocks per SM; and at B = 5 the serial chain of K chunks (a block
//   per 32-40 positions, no split K), which cuDNN does not have.
//
// BF16 / HIGH design (sep_layer_mma_kernel). Eight warps, each a 32 x 32
// (or 16 x 32) tile of the block's BM positions x BN output channels; K in
// chunks of 32 input channels (two k16 steps per chunk).
//   - A ring of cp.async stages (16 bytes a thread; 3 stages in BF16, 2 in
//     HIGH, whose weights are twice the bytes) brings each chunk's inputs
//     to shared memory while earlier chunks compute: its (32, BN) bf16
//     weights (HIGH: hi and lo planes; already bf16 in device memory), its
//     9 depthwise taps and bias, and the window of input positions its
//     outputs read (every position from the first output's upper-left tap
//     to the last one's lower-right, zeros past the ends of the batch).
//   - The depthwise stays f32 FFMA in the same tap order as HIGHEST
//     (centre first, then the others), read from that window, and is
//     rounded to bf16 straight into the shared-memory A tile (HIGH: hi and
//     lo planes), so it never reaches device memory. Each thread computes
//     4 neighbouring channels of one position; a tap off the image reads 0,
//     which adds exactly nothing. Two barriers per chunk: one before the
//     depthwise (the chunk's stage has landed; the last product is done
//     with the A tile and its stage, which is refilled), one before the
//     product (the A tile is whole).
//   - ldmatrix feeds mma.sync.m16n8k16 bf16 x bf16 -> f32. HIGH keeps two
//     accumulators, hi*hi and hi*lo + lo*hi, added in the epilogue (the
//     tensor cores' own f32 accumulation errs more than FFMA; keeping the
//     small terms apart keeps them from rounding against the large one).
//   - Recompute. As the HIGHEST kernel, each A tile is computed F / BN
//     times, BN = min(F, 256) (F = 64, 128, or a multiple of 256): 1 on
//     layers 2-6, 2 on 7-12 and 4 on 13-14.
//   - Grid. BM = 128, 64 or 32 rows for BN = 64, 128, 256 (warp tiles 32
//     x 32), halved (warp tiles 16 x 32) where the full tile would give the
//     card fewer than two blocks per SM, by count or by shared memory. At
//     B = 209 on 132 SMs, in both modes: layer 2 2508 blocks (BM 128), 3
//     2508 (32, halved by shared memory), 4 1254 (64), 5 1254 (16, halved by
//     shared memory), 6 627 (32), 7 628 (16, by shared memory), 8-12 314
//     (32), 13-14 316 (16, halved by count). Only BM depends on the batch,
//     never BK, BN or the order of K, so a patch's outputs do not depend on
//     the batch.
//   - Epilogue: bias + ReLU in f32, pairs of lanes swap halves so each
//     stores a float4. No atomics, no split K: every output is one fixed
//     chain of mma.sync over K in order, identical from run to run.
//   What likely bounds it now (from the shapes; HIGH's three products take
//   less than twice BF16's one): every block of a layer reads the layer's
//   weights for its BN channels again, and every n-block its input window,
//   from L2 (e.g. layer 8: 157 m-blocks x 256 KB of weights each, ~80 MB,
//   plus ~30 MB of f32 inputs). Sharing a weight tile across the blocks of
//   a cluster (TMA multicast) or keeping layers on chip is the next step;
//   wgmma and a producer warp come with it. No wgmma or TMA yet: layer 8's
//   bf16 product (5016 x 512 x 512 at B = 209) is ~2.7 us at 989 TFLOP/s,
//   a small part of the layer's time, so the mma loop is not what sets
//   the pace.

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

#include <atomic>

#include "ptx.cuh"

namespace {

constexpr int DIMS = 9;  // ints per layer descriptor on the host side
// rows of a chunk's depthwise stage ahead of the input window: the 9 taps
// and the bias of the chunk's channels
constexpr int XHEAD = 10;

enum Mode { HIGHEST = 0, BF16 = 1, HIGH = 2 };

struct Layer {
    const float* dw;    // (9, C) depthwise taps, tap t = (dy+1)*3 + (dx+1)
    const float* dw_b;  // (C,)
    const void* pw;     // (C, F) pointwise, row-major: f32 (HIGHEST), bf16
                        // (BF16), or bf16 hi then lo planes, (2, C, F) (HIGH)
    const float* pw_b;  // (F,)
    int h, w, c, f, stride, ho, wo, off_h, off_w;
};

// Input rows (flattened (b, h, w) positions) that the depthwise of `bm`
// consecutive outputs can read: they span at most bm / Wo + 2 output rows,
// so stride * (that - 1) + 3 input rows of W, and a position either side.
__host__ __device__ inline int window_rows(int bm, const Layer& L) {
    return (L.stride * ((bm + L.wo - 1) / L.wo + 1) + 3) * L.w + 2;
}

// --- the FFMA route (HIGHEST) ----------------------------------------------------

constexpr int FK = 16;   // input channels per K chunk
constexpr int FT = 256;  // threads per block: 8 warps
constexpr int FRING = 3;  // cp.async ring stages, where two blocks fit an SM
// A rows padded by 4 floats: rows stay 16-byte aligned for the float4 reads
constexpr int APAD = 4;

// The tile of sep_layer_kernel<BN, TM>: TX = BN / 8 threads along N, each
// 8 channels in two float4 groups BN / 2 apart; TY = 256 / TX along M, each
// TM positions: TM = 8 or 4 in float4 groups 4 * TY apart, TM = 5 as five
// neighbouring positions. A warp is 8 x 4 threads.
template <int BN, int TM>
struct FfmaTile {
    static constexpr int TX = BN / 8;
    static constexpr int TY = FT / TX;
    static constexpr int BM = TM * TY;  // positions per block
    static constexpr int WX = TX / 8;   // warps along N
    static constexpr int LDA = BM + APAD;
    // the block row of the thread's i-th position
    __device__ static int row(int ty, int i) {
        return TM % 4 == 0 ? (i / 4) * 4 * TY + ty * 4 + i % 4 : ty * TM + i;
    }
};

// One ring stage, in floats: a chunk's (FK, BN) weights, then its taps,
// bias and input window, FK channels a row
__host__ __device__ inline int ffma_stage(int bm, int bn, const Layer& L) {
    return FK * bn + (XHEAD + window_rows(bm, L)) * FK;
}

// Dynamic shared memory of a tile: the f32 A tile (FK, BM + APAD), then the
// ring's stages
inline int ffma_smem(int bm, int bn, int stages, const Layer& L) {
    return (int)sizeof(float) *
           (FK * (bm + APAD) + stages * ffma_stage(bm, bn, L));
}

template <int BN, int TM>
__global__ void __launch_bounds__(FT, 2)
sep_layer_kernel(const float* __restrict__ x, float* __restrict__ y,
                 const Layer L, const int m_total, const int ring) {
    using T = FfmaTile<BN, TM>;
    constexpr int BM = T::BM, LDA = T::LDA;
    // depthwise: 4 threads per position, 4 neighbouring channels each, so
    // 64 positions per pass (BM = 32: half the threads rest)
    constexpr int DW_POS = (BM + 63) / 64;
    constexpr int PIECES = FK * BN / 4;  // 16-byte pieces of weights
    static_assert(PIECES % FT == 0, "weight tile");
    const int stage = ffma_stage(BM, BN, L);  // floats
    extern __shared__ __align__(16) unsigned char ffma_smem_raw[];
    float* const As = reinterpret_cast<float*>(ffma_smem_raw);
    float* const Ring = As + FK * LDA;

    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int tx = (warp % T::WX) * 8 + lane % 8;
    const int ty = (warp / T::WX) * 4 + lane / 8;
    const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
    const int hwo = L.ho * L.wo;
    const int n_chunks = L.c / FK;
    const int n_in = m_total / hwo * L.h * L.w;  // input positions

    // the flattened input position of output m's centre tap
    auto centre = [&](int m) {
        const int b = m / hwo, r = m % hwo;
        return (b * L.h + (r / L.wo) * L.stride + L.off_h) * L.w +
               (r % L.wo) * L.stride + L.off_w;
    };
    // the block's input window: every tap of its outputs
    const int m_last = (m0 + BM < m_total ? m0 + BM : m_total) - 1;
    const int lo = centre(m0) - L.w - 1;
    const int hi = centre(m_last) + L.w + 1;
    const int xrows = window_rows(BM, L);
    const int n_rows = hi - lo + 1 < xrows ? hi - lo + 1 : xrows;

    // the thread's depthwise positions: the window row of each centre tap,
    // and one bit per tap t that lies on the image (none for a position
    // past the batch or past the block)
    const int kq = (tid % 4) * 4;
    int row[DW_POS], taps[DW_POS];
#pragma unroll
    for (int j = 0; j < DW_POS; ++j) {
        const int pos = tid / 4 + 64 * j, m = m0 + pos;
        row[j] = XHEAD;
        taps[j] = 0;
        if (pos < BM && m < m_total) {
            const int r = m % hwo;
            const int ch = (r / L.wo) * L.stride + L.off_h;
            const int cw = (r % L.wo) * L.stride + L.off_w;
            row[j] = XHEAD + centre(m) - lo;
#pragma unroll
            for (int t = 0; t < 9; ++t) {
                const int ih = ch + t / 3 - 1, iw = cw + t % 3 - 1;
                if (ih >= 0 && ih < L.h && iw >= 0 && iw < L.w)
                    taps[j] |= 1 << t;
            }
        }
    }

    const float* const pw = static_cast<const float*>(L.pw);
    // chunk k's (FK, BN) weights and its depthwise inputs (taps, bias, the
    // input window's FK channels; zeros off the ends of the batch) into
    // ring stage k % ring
    auto load_chunk = [&](int chunk) {
        float* const B = Ring + (chunk % ring) * stage;
        float* const X = B + FK * BN;
        const int c0 = chunk * FK;
        const float* const src = pw + (long long)c0 * L.f + n0;
#pragma unroll
        for (int i = 0; i < PIECES / FT; ++i) {
            const int q = tid + i * FT;
            const int r = q / (BN / 4), cc = (q % (BN / 4)) * 4;
            cp_async16(B + r * BN + cc, src + (long long)r * L.f + cc);
        }
        for (int q = tid; q < (XHEAD + n_rows) * (FK / 4); q += FT) {
            const int r = q / (FK / 4), cc = (q % (FK / 4)) * 4;
            const int p = lo + r - XHEAD;
            const bool ok = r < XHEAD || (p >= 0 && p < n_in);
            const float* g =
                r < 9 ? L.dw + r * L.c
                      : r == 9 ? L.dw_b
                               : x + (long long)(ok ? p : 0) * L.c;
            cp_async16(X + r * FK + cc, g + c0 + cc, ok);
        }
    };
    // chunk k's depthwise + bias + ReLU from its stage into the A tile,
    // stored (k, position)
    auto depthwise = [&](int chunk) {
        const float* const X = Ring + (chunk % ring) * stage + FK * BN;
        float4 a[DW_POS];
        // centre tap first, then the others in tap order, as the TPU
        // kernel accumulates them
        const float4 wc = lds4(X + 4 * FK + kq);
#pragma unroll
        for (int j = 0; j < DW_POS; ++j) {
            a[j] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (taps[j]) {
                const float4 v = lds4(X + row[j] * FK + kq);
                a[j] = make_float4(v.x * wc.x, v.y * wc.y, v.z * wc.z,
                                   v.w * wc.w);
            }
        }
#pragma unroll
        for (int t = 0; t < 9; ++t) {
            if (t == 4) continue;
            const int off = ((t / 3 - 1) * L.w + (t % 3 - 1)) * FK;
            const float4 w = lds4(X + t * FK + kq);
#pragma unroll
            for (int j = 0; j < DW_POS; ++j) {
                if (!((taps[j] >> t) & 1)) continue;
                const float4 v = lds4(X + row[j] * FK + off + kq);
                a[j].x = fmaf(v.x, w.x, a[j].x);
                a[j].y = fmaf(v.y, w.y, a[j].y);
                a[j].z = fmaf(v.z, w.z, a[j].z);
                a[j].w = fmaf(v.w, w.w, a[j].w);
            }
        }
        const float4 bias = lds4(X + 9 * FK + kq);
#pragma unroll
        for (int j = 0; j < DW_POS; ++j) {
            const int pos = tid / 4 + 64 * j;
            if (pos >= BM) continue;
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (taps[j])
                v = make_float4(fmaxf(a[j].x + bias.x, 0.f),
                                fmaxf(a[j].y + bias.y, 0.f),
                                fmaxf(a[j].z + bias.z, 0.f),
                                fmaxf(a[j].w + bias.w, 0.f));
            As[(kq + 0) * LDA + pos] = v.x;
            As[(kq + 1) * LDA + pos] = v.y;
            As[(kq + 2) * LDA + pos] = v.z;
            As[(kq + 3) * LDA + pos] = v.w;
        }
    };

    float acc[TM][8];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    auto multiply = [&](int chunk) {
        const float* const B = Ring + (chunk % ring) * stage;
#pragma unroll
        for (int k = 0; k < FK; ++k) {
            float a[TM], b[8];
            if constexpr (TM % 4 == 0) {
#pragma unroll
                for (int q = 0; q < TM / 4; ++q) {
                    const float4 v = lds4(As + k * LDA + T::row(ty, 4 * q));
                    a[4 * q] = v.x; a[4 * q + 1] = v.y;
                    a[4 * q + 2] = v.z; a[4 * q + 3] = v.w;
                }
            } else {
#pragma unroll
                for (int i = 0; i < TM; ++i)
                    a[i] = As[k * LDA + T::row(ty, i)];
            }
            const float4 b0 = lds4(B + k * BN + tx * 4);
            const float4 b1 = lds4(B + k * BN + BN / 2 + tx * 4);
            b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
            b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
    };

    // Chunk k's stage was committed as cp.async group k. The first barrier
    // of iteration k follows the wait for it and ends chunk k-1's product,
    // so stage (k-1) % ring can be refilled (with chunk k+ring-1) and the A
    // tile rewritten; the second makes the A tile whole before the product.
    for (int s = 0; s < ring - 1; ++s) {
        if (s < n_chunks) load_chunk(s);
        cp_async_commit();
    }
    for (int kc = 0; kc < n_chunks; ++kc) {
        if (ring == FRING)
            cp_async_wait<FRING - 2>();
        else
            cp_async_wait<0>();
        __syncthreads();
        if (kc + ring - 1 < n_chunks) load_chunk(kc + ring - 1);
        cp_async_commit();
        depthwise(kc);
        __syncthreads();
        multiply(kc);
    }

    const float4 pb0 = *reinterpret_cast<const float4*>(L.pw_b + n0 + tx * 4);
    const float4 pb1 =
        *reinterpret_cast<const float4*>(L.pw_b + n0 + BN / 2 + tx * 4);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int m = m0 + T::row(ty, i);
        if (m >= m_total) continue;
        const float* c = acc[i];
        float* const out = y + (long long)m * L.f + n0 + tx * 4;
        *reinterpret_cast<float4*>(out) = make_float4(
            fmaxf(c[0] + pb0.x, 0.f), fmaxf(c[1] + pb0.y, 0.f),
            fmaxf(c[2] + pb0.z, 0.f), fmaxf(c[3] + pb0.w, 0.f));
        *reinterpret_cast<float4*>(out + BN / 2) = make_float4(
            fmaxf(c[4] + pb1.x, 0.f), fmaxf(c[5] + pb1.y, 0.f),
            fmaxf(c[6] + pb1.z, 0.f), fmaxf(c[7] + pb1.w, 0.f));
    }
}

// --- the tensor-core route (BF16, HIGH) ------------------------------------------

constexpr int MK = 32;  // input channels per K chunk: two k16 steps
constexpr int MT = 256;  // threads per block: 8 warps
// bf16 row padding of the A and B tiles: the 8 rows an ldmatrix reads start
// on distinct bank groups, and every row stays 16-byte aligned
constexpr int MPAD = 8;

// operand planes (hi, lo) and cp.async ring stages of a mode: HIGH's
// weights are twice the bytes, so its ring is one stage shorter
__host__ __device__ constexpr int mma_planes(int mode) {
    return mode == HIGH ? 2 : 1;
}
__host__ __device__ constexpr int mma_ring(int mode) {
    return mode == HIGH ? 2 : 3;
}

// The tile of sep_layer_mma_kernel<BN, FM, MODE>: BN output channels over
// BN / 32 warps along N, the other warps along M; each warp owns 16 * FM
// positions x 32 channels, FM x 4 mma tiles of m16 x n8.
template <int BN, int FM, int MODE>
struct MmaTile {
    static constexpr int WN = BN / 32;               // warps along N
    static constexpr int WM = 8 / WN;                // warps along M
    static constexpr int BM = 16 * FM * WM;          // positions per block
    static constexpr int NP = mma_planes(MODE);
    static constexpr int STAGES = mma_ring(MODE);
    static constexpr int LDA = MK + MPAD;            // A row, bf16
    static constexpr int LDB = BN + MPAD;            // B row, bf16
    static constexpr int A_PLANE = BM * LDA, B_PLANE = MK * LDB;
    static constexpr int A_TILE = NP * A_PLANE;      // the depthwise output
    static constexpr int B_STAGE = NP * B_PLANE;     // a chunk's weights
};

// Dynamic shared memory of a tile: the bf16 A tile, then the ring of
// stages, each a chunk's bf16 weights and its f32 depthwise inputs (taps,
// bias, input window). A layer of fewer chunks than ring stages uses fewer.
__host__ __device__ inline int mma_stages(int mode, const Layer& L) {
    const int chunks = L.c / MK;
    return chunks < mma_ring(mode) ? chunks : mma_ring(mode);
}

__host__ __device__ inline int mma_smem(int mode, int bm, int bn,
                                        const Layer& L) {
    return (int)sizeof(__nv_bfloat16) * mma_planes(mode) *
               (bm * (MK + MPAD) + mma_stages(mode, L) * MK * (bn + MPAD)) +
           (int)sizeof(float) * mma_stages(mode, L) *
               (XHEAD + window_rows(bm, L)) * MK;
}

template <int BN, int FM, int MODE>
__global__ void __launch_bounds__(MT, 2)
sep_layer_mma_kernel(const float* __restrict__ x, float* __restrict__ y,
                     const Layer L, const int m_total) {
    using T = MmaTile<BN, FM, MODE>;
    constexpr int BM = T::BM, NP = T::NP, LDA = T::LDA, LDB = T::LDB;
    constexpr int S = T::STAGES;
    // depthwise: 8 threads per position, 4 neighbouring channels each, so
    // 32 positions per pass (BM = 16: half the threads rest)
    constexpr int DW_POS = (BM + 31) / 32;
    constexpr int PIECES = NP * MK * BN / 8;  // 16-byte pieces of weights
    static_assert(PIECES % MT == 0, "weight tile");
    const int xrows = window_rows(BM, L);
    const int x_stage = (XHEAD + xrows) * MK;  // floats
    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16* const As = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* const Bs = As + T::A_TILE;
    float* const Xs =
        reinterpret_cast<float*>(Bs + mma_stages(MODE, L) * T::B_STAGE);

    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int wm = warp / T::WN, wn = warp % T::WN;
    const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
    const int hwo = L.ho * L.wo;
    const int n_chunks = L.c / MK;
    const int n_in = m_total / hwo * L.h * L.w;  // input positions

    // the flattened input position of output m's centre tap
    auto centre = [&](int m) {
        const int b = m / hwo, r = m % hwo;
        return (b * L.h + (r / L.wo) * L.stride + L.off_h) * L.w +
               (r % L.wo) * L.stride + L.off_w;
    };
    // the block's input window: every tap of its outputs
    const int m_last = (m0 + BM < m_total ? m0 + BM : m_total) - 1;
    const int lo = centre(m0) - L.w - 1;
    const int hi = centre(m_last) + L.w + 1;
    const int n_rows = hi - lo + 1 < xrows ? hi - lo + 1 : xrows;

    const int kq = (tid % 8) * 4;
    int row[DW_POS], ch[DW_POS], cw[DW_POS];
    bool live[DW_POS];
#pragma unroll
    for (int j = 0; j < DW_POS; ++j) {
        const int pos = tid / 8 + 32 * j, m = m0 + pos;
        live[j] = pos < BM && m < m_total;
        const int mm = live[j] ? m : m0;
        const int r = mm % hwo;
        ch[j] = (r / L.wo) * L.stride + L.off_h;
        cw[j] = (r % L.wo) * L.stride + L.off_w;
        row[j] = XHEAD + centre(mm) - lo;
    }

    const __nv_bfloat16* const pw = static_cast<const __nv_bfloat16*>(L.pw);
    const long long plane = (long long)L.c * L.f;
    // chunk k's (MK, BN) weights (HIGH: hi and lo) and its depthwise
    // inputs (taps, bias, the input window's MK channels; zeros off the
    // ends of the batch) into ring stage k % S
    auto load_chunk = [&](int chunk) {
        const int stage = chunk % S, c0 = chunk * MK;
        __nv_bfloat16* const B = Bs + stage * T::B_STAGE;
        const __nv_bfloat16* const src = pw + (long long)c0 * L.f + n0;
#pragma unroll
        for (int i = 0; i < PIECES / MT; ++i) {
            const int q = tid + i * MT;
            const int p = q / (MK * BN / 8), r = (q / (BN / 8)) % MK;
            const int cc = (q % (BN / 8)) * 8;
            cp_async16(B + p * T::B_PLANE + r * LDB + cc,
                       src + p * plane + (long long)r * L.f + cc);
        }
        float* const X = Xs + stage * x_stage;
        for (int q = tid; q < (XHEAD + n_rows) * (MK / 4); q += MT) {
            const int r = q / (MK / 4), cc = (q % (MK / 4)) * 4;
            const int p = lo + r - XHEAD;
            const bool ok = r < XHEAD || (p >= 0 && p < n_in);
            const float* g =
                r < 9 ? L.dw + r * L.c
                      : r == 9 ? L.dw_b
                               : x + (long long)(ok ? p : 0) * L.c;
            cp_async16(X + r * MK + cc, g + c0 + cc, ok);
        }
    };
    // chunk k's depthwise + bias + ReLU from its stage, rounded to bf16,
    // into the A tile (HIGH: hi and lo planes)
    auto depthwise = [&](int chunk) {
        const float* const X = Xs + (chunk % S) * x_stage;
        float4 w[9];
#pragma unroll
        for (int t = 0; t < 9; ++t) w[t] = lds4(X + t * MK + kq);
        const float4 bias = lds4(X + 9 * MK + kq);
#pragma unroll
        for (int j = 0; j < DW_POS; ++j) {
            const int pos = tid / 8 + 32 * j;
            if (pos >= BM) continue;
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (live[j]) {
                const float* xp = X + row[j] * MK + kq;
                float4 xv[9];
#pragma unroll
                for (int t = 0; t < 9; ++t) {
                    const int dy = t / 3 - 1, dx = t % 3 - 1;
                    const int ih = ch[j] + dy, iw = cw[j] + dx;
                    xv[t] = (ih >= 0 && ih < L.h && iw >= 0 && iw < L.w)
                                ? lds4(xp + (dy * L.w + dx) * MK)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
                }
                // centre tap first, then the others in tap order, as the
                // TPU kernel accumulates them
                float4 a = make_float4(xv[4].x * w[4].x, xv[4].y * w[4].y,
                                       xv[4].z * w[4].z, xv[4].w * w[4].w);
#pragma unroll
                for (int t = 0; t < 9; ++t) {
                    if (t == 4) continue;
                    a.x = fmaf(xv[t].x, w[t].x, a.x);
                    a.y = fmaf(xv[t].y, w[t].y, a.y);
                    a.z = fmaf(xv[t].z, w[t].z, a.z);
                    a.w = fmaf(xv[t].w, w[t].w, a.w);
                }
                v = make_float4(fmaxf(a.x + bias.x, 0.f),
                                fmaxf(a.y + bias.y, 0.f),
                                fmaxf(a.z + bias.z, 0.f),
                                fmaxf(a.w + bias.w, 0.f));
            }
            __nv_bfloat16* const a_row = As + pos * LDA + kq;
            if (MODE == HIGH) {
                split_hi_lo(v, a_row, a_row + T::A_PLANE);
            } else {
                *reinterpret_cast<uint2*>(a_row) =
                    make_uint2(bits(__floats2bfloat162_rn(v.x, v.y)),
                               bits(__floats2bfloat162_rn(v.z, v.w)));
            }
        }
    };

    // acc[0]: a_hi * w_hi (BF16: a * w); acc[1] (HIGH): a_hi * w_lo +
    // a_lo * w_hi
    float acc[NP][FM][4][4];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[p][i][j][e] = 0.f;

    auto multiply = [&](int chunk) {
        const __nv_bfloat16* const B = Bs + (chunk % S) * T::B_STAGE;
#pragma unroll
        for (int ks = 0; ks < MK; ks += 16) {
            uint32_t a[NP][FM][4], b[NP][4][2];
#pragma unroll
            for (int p = 0; p < NP; ++p) {
                // A: lanes 0-15 rows 0-15 at k, lanes 16-31 the same rows
                // at k + 8 (a0..a3 of the m16n8k16 fragment)
#pragma unroll
                for (int i = 0; i < FM; ++i)
                    ldmatrix_x4(a[p][i],
                                As + p * T::A_PLANE +
                                    (wm * 16 * FM + i * 16 + lane % 16) * LDA +
                                    ks + (lane / 16) * 8);
                // B, stored (k, n): transposed loads of k rows 0-15 at
                // columns n and n + 8 give two n8 tiles' (b0, b1)
#pragma unroll
                for (int jj = 0; jj < 2; ++jj) {
                    uint32_t r[4];
                    ldmatrix_x4_trans(r, B + p * T::B_PLANE +
                                             (ks + lane % 16) * LDB + wn * 32 +
                                             jj * 16 + (lane / 16) * 8);
                    b[p][2 * jj][0] = r[0];
                    b[p][2 * jj][1] = r[1];
                    b[p][2 * jj + 1][0] = r[2];
                    b[p][2 * jj + 1][1] = r[3];
                }
            }
#pragma unroll
            for (int i = 0; i < FM; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    mma_bf16(acc[0][i][j], a[0][i], b[0][j]);
                    if (MODE == HIGH) {
                        mma_bf16(acc[NP - 1][i][j], a[0][i], b[NP - 1][j]);
                        mma_bf16(acc[NP - 1][i][j], a[NP - 1][i], b[0][j]);
                    }
                }
        }
    };

    // Chunk k's stage was committed as cp.async group k. The first barrier
    // of iteration k follows the wait for it and ends chunk k-1's product,
    // so stage (k-1) % S can be refilled (with chunk k+S-1) and the A tile
    // rewritten; the second makes the A tile whole before the product.
#pragma unroll
    for (int s = 0; s < S - 1; ++s) {
        if (s < n_chunks) load_chunk(s);
        cp_async_commit();
    }
    for (int kc = 0; kc < n_chunks; ++kc) {
        cp_async_wait<S - 2>();
        __syncthreads();
        if (kc + S - 1 < n_chunks) load_chunk(kc + S - 1);
        cp_async_commit();
        depthwise(kc);
        __syncthreads();
        multiply(kc);
    }

    // c0, c1 of an mma tile are row g's columns 2t, 2t+1 and c2, c3 row
    // g+8's; each pair of lanes swaps halves, so the even lane stores row
    // g's columns 2t..2t+3 and the odd lane row g+8's 2t-2..2t+1
    const int g = lane / 4, t = lane % 4;
    const bool odd = t & 1;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            float c[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
                c[e] = MODE == HIGH ? acc[0][i][j][e] + acc[NP - 1][i][j][e]
                                    : acc[0][i][j][e];
            const float s0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
            const float s1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
            const float4 o = odd ? make_float4(s0, s1, c[2], c[3])
                                 : make_float4(c[0], c[1], s0, s1);
            const int m = m0 + wm * 16 * FM + i * 16 + g + (odd ? 8 : 0);
            const int n = n0 + wn * 32 + j * 8 + 2 * (t & ~1);
            const float4 pb = *reinterpret_cast<const float4*>(L.pw_b + n);
            if (m < m_total)
                *reinterpret_cast<float4*>(y + (long long)m * L.f + n) =
                    make_float4(fmaxf(o.x + pb.x, 0.f), fmaxf(o.y + pb.y, 0.f),
                                fmaxf(o.z + pb.z, 0.f), fmaxf(o.w + pb.w, 0.f));
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

// The shapes the kernels take: K in whole chunks (16 channels on FFMA, 32
// on the tensor cores), and F = 64, 128 or a multiple of BN = 256.
// ops/sepconv.py::_kernel_takes states the same rule for the wrapper's
// check: a change to one is made in the other.
bool takes(int mode, const Layer& L) {
    const int chunk = mode == HIGHEST ? FK : MK;
    return L.c % chunk == 0 && (L.f == 64 || L.f == 128 || L.f % 256 == 0);
}

template <int BN, int TM>
cudaError_t launch_ffma(int device, dim3 grid, int smem, int ring,
                        cudaStream_t stream, const float* in, float* dst,
                        const Layer& L, int m_total) {
    static std::atomic<bool> ready[MAX_DEVICES];
    const cudaError_t err =
        opt_in_smem(sep_layer_kernel<BN, TM>, device, ready);
    if (err != cudaSuccess) return err;
    sep_layer_kernel<BN, TM><<<grid, FT, smem, stream>>>(in, dst, L, m_total,
                                                        ring);
    return cudaGetLastError();
}

template <int BN>
cudaError_t launch_ffma_tm(int tm, int device, dim3 grid, int smem, int ring,
                           cudaStream_t stream, const float* in, float* dst,
                           const Layer& L, int m_total) {
    switch (tm) {
        case 8:
            return launch_ffma<BN, 8>(device, grid, smem, ring, stream, in,
                                      dst, L, m_total);
        case 5:
            return launch_ffma<BN, 5>(device, grid, smem, ring, stream, in,
                                      dst, L, m_total);
        default:
            return launch_ffma<BN, 4>(device, grid, smem, ring, stream, in,
                                      dst, L, m_total);
    }
}

// One HIGHEST layer: BN = min(F, 256); TM = 8, 5 or 4 positions per
// thread, whichever gives the busiest SM the fewest positions (its
// ceil(blocks / SMs) blocks of BM), the larger on a tie; a ring of FRING
// stages if two blocks still fit an SM's shared memory, else 2.
cudaError_t launch_ffma_layer(int device, int sms, int sm_smem,
                              cudaStream_t stream, const float* in,
                              float* dst, const Layer& L, int m_total) {
    const int bn = L.f < 256 ? L.f : 256;
    const int ty = FT / (bn / 8);
    const int n_blocks = L.f / bn;
    auto busiest = [&](int bm) {
        const long long blocks = (long long)((m_total + bm - 1) / bm) *
                                 n_blocks;
        return (blocks + sms - 1) / sms * bm;
    };
    int tm = 8;
    for (const int t : {5, 4})
        if (busiest(t * ty) < busiest(tm * ty)) tm = t;
    const int bm = tm * ty;
    const int ring =
        2 * (ffma_smem(bm, bn, FRING, L) + 1024) <= sm_smem ? FRING : 2;
    const int chunks = L.c / FK;
    const int smem = ffma_smem(bm, bn, chunks < ring ? chunks : ring, L);
    const dim3 grid((m_total + bm - 1) / bm, n_blocks);
    switch (bn) {
        case 64:
            return launch_ffma_tm<64>(tm, device, grid, smem, ring, stream,
                                      in, dst, L, m_total);
        case 128:
            return launch_ffma_tm<128>(tm, device, grid, smem, ring, stream,
                                       in, dst, L, m_total);
        default:
            return launch_ffma_tm<256>(tm, device, grid, smem, ring, stream,
                                       in, dst, L, m_total);
    }
}

template <int BN, int FM, int MODE>
cudaError_t launch_mma(int device, dim3 grid, int smem, cudaStream_t stream,
                       const float* in, float* dst, const Layer& L,
                       int m_total) {
    static std::atomic<bool> ready[MAX_DEVICES];
    const cudaError_t err =
        opt_in_smem(sep_layer_mma_kernel<BN, FM, MODE>, device, ready);
    if (err != cudaSuccess) return err;
    sep_layer_mma_kernel<BN, FM, MODE><<<grid, MT, smem, stream>>>(
        in, dst, L, m_total);
    return cudaGetLastError();
}

template <int BN, int FM>
cudaError_t launch_mma_mode(int mode, int device, dim3 grid, int smem,
                            cudaStream_t stream, const float* in, float* dst,
                            const Layer& L, int m_total) {
    return mode == HIGH
               ? launch_mma<BN, FM, HIGH>(device, grid, smem, stream, in, dst,
                                          L, m_total)
               : launch_mma<BN, FM, BF16>(device, grid, smem, stream, in, dst,
                                          L, m_total);
}

// One BF16 or HIGH layer: BN = min(F, 256); the full tile (warp tiles
// 32 x 32) if it gives at least two blocks per SM, by count and by shared
// memory, else half as many rows (16 x 32).
cudaError_t launch_mma_layer(int mode, int device, int sms, int sm_smem,
                             cudaStream_t stream, const float* in, float* dst,
                             const Layer& L, int m_total) {
    const int bn = L.f < 256 ? L.f : 256;
    const int bm = 32 * (8 / (bn / 32));
    const bool full =
        (long long)((m_total + bm - 1) / bm) * (L.f / bn) >= 2 * sms &&
        2 * (mma_smem(mode, bm, bn, L) + 1024) <= sm_smem;
    const int rows = full ? bm : bm / 2;
    const int smem = mma_smem(mode, rows, bn, L);
    const dim3 grid((m_total + rows - 1) / rows, L.f / bn);
    switch (bn) {
        case 64:
            return full ? launch_mma_mode<64, 2>(mode, device, grid, smem,
                                                 stream, in, dst, L, m_total)
                        : launch_mma_mode<64, 1>(mode, device, grid, smem,
                                                 stream, in, dst, L, m_total);
        case 128:
            return full ? launch_mma_mode<128, 2>(mode, device, grid, smem,
                                                  stream, in, dst, L, m_total)
                        : launch_mma_mode<128, 1>(mode, device, grid, smem,
                                                  stream, in, dst, L, m_total);
        default:
            return full ? launch_mma_mode<256, 2>(mode, device, grid, smem,
                                                  stream, in, dst, L, m_total)
                        : launch_mma_mode<256, 1>(mode, device, grid, smem,
                                                  stream, in, dst, L, m_total);
    }
}

// Runs the layers in order: layer i reads the previous layer's output from
// one scratch buffer and writes the other; the last layer writes `out`
// directly, or (with gap) a scratch buffer that gap_kernel reduces to `out`.
int run_stack(const float* x, float* out, float* buf0, float* buf1, int batch,
              int n_layers, const int64_t* ptrs, const int* dims, int gap,
              int mode, cudaStream_t stream) {
    if (batch <= 0 || n_layers <= 0 || mode < HIGHEST || mode > HIGH)
        return (int)cudaErrorInvalidValue;
    int device = 0, sms = 0, sm_smem = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaDeviceGetAttribute(&sm_smem,
                           cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
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
        if (!takes(mode, L)) return (int)cudaErrorInvalidValue;
        const bool last = i == n_layers - 1;
        float* dst = (last && !gap) ? out : bufs[i % 2];
        const int m_total = batch * L.ho * L.wo;
        const cudaError_t err =
            mode == HIGHEST
                ? launch_ffma_layer(device, sms, sm_smem, stream, in, dst, L,
                                    m_total)
                : launch_mma_layer(mode, device, sms, sm_smem, stream, in,
                                   dst, L, m_total);
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
