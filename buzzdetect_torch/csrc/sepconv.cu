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
// Two kernels, one per route of the pointwise product:
//   sep_layer_kernel      HIGHEST: FFMA, exact f32 (the main path);
//   sep_layer_mma_kernel  BF16 and HIGH: bf16 operands on the tensor cores
//                         (mma.sync m16n8k16, f32 accumulate).
// Every layer of both stacks ran faster on the tensor cores in BF16 and
// HIGH than the FFMA loop ran it in exact f32 (chip_smoke.py prints the
// ratio per layer; BF16 and HIGH ran that same loop before), so those modes
// take the tensor cores on every layer, and sep_layer_kernel is exact f32
// only.
//
// Bound on an H100 SXM. One 200 s chunk is 209 patches; the front does
// 26.7 M MAC per patch and the tail 41.5 M, so ~11.2 and ~17.3 GFLOP per
// chunk, against tens of MB of compulsory traffic (~41 MB of layer-1
// activations in, ~11 MB of tail weights). HIGHEST: at the card's 67
// TFLOP/s non-tensor f32 peak that is ~0.17 ms and ~0.26 ms, bound by FFMA
// throughput, not by memory. BF16 and HIGH: one and three bf16 products
// per multiply-add at 989 TFLOP/s, ~0.017 and ~0.052 ms for the tail. That
// is so little that the rest weighs as much: the tail's ~16-22 MB of
// compulsory traffic (0.005-0.007 ms at 3.35 TB/s) and its depthwise,
// which stays on FFMA: 0.27 GFLOP per chunk, 0.004 ms at 67 TFLOP/s, or
// 0.6 GFLOP (0.009 ms) with the recompute below.
//
// HIGHEST design. The pointwise product is >95% of the operations, so each
// layer is one launch of a tiled FFMA matrix product (128 or 64 positions x
// 64 output channels per block, 8x4 or 4x4 outputs per thread fed by
// float4 shared-memory reads, K staged through shared memory in chunks of
// 8 input channels, two blocks per SM). The depthwise 3x3 for a K chunk is
// computed straight into the shared-memory A tile, so the depthwise output
// never reaches device memory; only the layer's output does. Exact f32:
// FFMA only, no TF32, no tensor cores, and every output is one thread's sum
// in a fixed order, with no atomics, so results are identical from run to
// run. Pooling is a second small kernel that sums the spatial positions in
// a fixed order.
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
//   - Recompute. A block computes the depthwise of its positions for all K
//     and reuses it for its BN output channels, so each A tile is computed
//     F / BN times. BN = min(F, 256) (F = 64, 128, or a multiple of 256),
//     so the factor is 1 on layers 2-6, 2 on 7-12 and 4 on 13-14 (the FFMA
//     route: F / 64, up to 16).
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
    const float* const pw = static_cast<const float*>(L.pw);

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
                pw + (long long)(k0 + pk) * L.f + n0 + pn);
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

// --- the tensor-core route (BF16, HIGH) ------------------------------------------

constexpr int MK = 32;  // input channels per K chunk: two k16 steps
constexpr int MT = 256;  // threads per block: 8 warps
// bf16 row padding of the A and B tiles: the 8 rows an ldmatrix reads start
// on distinct bank groups, and every row stays 16-byte aligned
constexpr int MPAD = 8;
// rows of a chunk's depthwise stage ahead of the input window: the 9 taps
// and the bias of the chunk's MK channels
constexpr int XHEAD = 10;
constexpr int MAX_DEVICES = 64;

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

// Input rows (flattened (b, h, w) positions) that the depthwise of `bm`
// consecutive outputs can read: they span at most bm / Wo + 2 output rows,
// so stride * (that - 1) + 3 input rows of W, and a position either side.
__host__ __device__ inline int mma_xrows(int bm, const Layer& L) {
    return (L.stride * ((bm + L.wo - 1) / L.wo + 1) + 3) * L.w + 2;
}

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
               (XHEAD + mma_xrows(bm, L)) * MK;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; with ok false, 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok = true) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p))
        : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p))
        : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 operands, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float4 lds4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
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
    const int xrows = mma_xrows(BM, L);
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
            const __nv_bfloat162 h01 = __floats2bfloat162_rn(v.x, v.y);
            const __nv_bfloat162 h23 = __floats2bfloat162_rn(v.z, v.w);
            __nv_bfloat16* const a_row = As + pos * LDA + kq;
            *reinterpret_cast<uint2*>(a_row) =
                make_uint2(bits(h01), bits(h23));
            if (MODE == HIGH) {  // lo = bf16(v - hi)
                const float2 f01 = __bfloat1622float2(h01);
                const float2 f23 = __bfloat1622float2(h23);
                *reinterpret_cast<uint2*>(a_row + T::A_PLANE) = make_uint2(
                    bits(__floats2bfloat162_rn(v.x - f01.x, v.y - f01.y)),
                    bits(__floats2bfloat162_rn(v.z - f23.x, v.w - f23.y)));
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

// The shapes sep_layer_mma_kernel takes: K in whole chunks, and F = 64, 128
// or a multiple of BN = 256. ops/sepconv.py::_kernel_takes states the same
// rule, and the rule of sep_layer_kernel, for the wrapper's check: a change
// to one is made in the other.
bool mma_takes(const Layer& L) {
    return L.c % MK == 0 && (L.f == 64 || L.f == 128 || L.f % 256 == 0);
}

template <int BN, int FM, int MODE>
cudaError_t launch_mma(int device, dim3 grid, int smem, cudaStream_t stream,
                       const float* in, float* dst, const Layer& L,
                       int m_total) {
    // past 48 KB a kernel must ask for its dynamic shared memory; ask once
    // per device for all a block can have
    static std::atomic<bool> ready[MAX_DEVICES];
    if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (!ready[device].load()) {
        int most = 0;
        cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
        const cudaError_t err = cudaFuncSetAttribute(
            sep_layer_mma_kernel<BN, FM, MODE>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, most);
        if (err != cudaSuccess) return err;
        ready[device].store(true);
    }
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
        if (mode == HIGHEST ? (L.c % BK != 0 || L.f % BN != 0)
                            : !mma_takes(L))
            return (int)cudaErrorInvalidValue;
        const bool last = i == n_layers - 1;
        float* dst = (last && !gap) ? out : bufs[i % 2];
        const int m_total = batch * L.ho * L.wo;
        if (mode != HIGHEST) {
            const cudaError_t err = launch_mma_layer(
                mode, device, sms, sm_smem, stream, in, dst, L, m_total);
            if (err != cudaSuccess) return (int)err;
            in = dst;
            continue;
        }
        const int tiles128 = (m_total + 127) / 128 * (L.f / BN);
        if (tiles128 >= 2 * sms)
            sep_layer_kernel<128><<<dim3((m_total + 127) / 128, L.f / BN),
                                     NT, 0, stream>>>(in, dst, L, m_total);
        else
            sep_layer_kernel<64><<<dim3((m_total + 63) / 64, L.f / BN), NT,
                                   0, stream>>>(in, dst, L, m_total);
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
