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
// Four kernels, built on one scheme: a block owns BM positions x BN
// output channels; K goes in chunks of input channels, in order; a ring of
// cp.async stages brings each chunk's weights, its 9 depthwise taps and
// bias, and the window of input positions its outputs read to shared
// memory while earlier chunks compute; the chunk's depthwise is computed
// from that window into a shared-memory A tile, so it never reaches device
// memory.
//   sep_layer_kernel      HIGHEST, the wide tile (BN = min(F, 256)): FFMA,
//                         exact f32, for batches that fill the card (the
//                         main path's 209-patch chunks);
//   sep_narrow_kernel     HIGHEST, the narrow tiles (BN = 8-64): the same
//                         arithmetic for batches that do not;
//   sep_layer_mma_kernel  BF16 and HIGH: bf16 operands on the tensor cores
//                         (mma.sync m16n8k16, f32 accumulate), 16-128
//                         positions a block, two blocks an SM;
//   sep_mma_wide_kernel   BF16 layers with F a multiple of 256 at batches
//                         that fill the card: the same products and bits
//                         on 128 or 64 positions x 256 channels a block.
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
// HIGHEST design (sep_layer_kernel<BN, TM>). 256 threads; each owns TM = 5
// or 4 positions TY apart x 8 output channels, the channels read as two
// float4s BN / 2 apart from the weight stage; a warp is 8 threads along N x
// 4 along M. K in chunks of FK = 16 input channels, in order.
//   - The A tile is (position, k): a position's 16 channels, rows padded to
//     ALD = 20 floats. Per 4 k a thread reads TM float4s of A (4 k of one
//     position each) and 8 float4s of weights: 13 shared loads per 160 FFMA
//     at TM = 5 (a (k, position) tile needs five scalar reads a k: 28 per
//     160). The 4 rows a warp reads at once are neighbours, i * TY
//     + ty for 4 consecutive ty, and a pitch of 20 floats puts them on bank
//     quads 0, 20, 8 and 28: one wavefront. The depthwise writes each
//     (position, 4 channels) as one float4.
//   - One barrier per chunk, two A tiles. Stage s of the cp.async ring holds
//     chunk s's (16, BN) weights and chunk s + 1's depthwise inputs (taps,
//     bias, input window); chunk 0's inputs come first, a group of their
//     own, in stage ring - 1. Between barriers k and k + 1 a block refills
//     the stage chunk k - 1 used with group k + ring - 1, computes chunk k +
//     1's depthwise into the A tile chunk k - 1's product is done with, and
//     multiplies chunk k from the other. With 3 stages each group has two
//     products' time to land (what 4 stages of the earlier pairing, one
//     chunk's weights and inputs a stage, would give); 2 stages where 3 do
//     not leave room for two blocks an SM (layer 3).
//   - Shared memory a block: 2 x BM x 20 floats of A tiles and ring x (16 BN
//     + 16 x (10 + window rows)) floats of stages, the window sized by
//     ffma_window_rows (one output row tighter than window_rows). At B =
//     209, KB: layer 2 87.2 (3 stages), 3 82.0 (2), 4 62.8, 5 95.5, 6 68.5,
//     7 91.0, 8-12 66.2, 13 88.8, 14 65.1 (3): two blocks an SM on every
//     layer (227 KB).
//   - Registers (nvcc -Xptxas -v, tools/ffma_geometries.py prints them),
//     at BN = 64, 128, 256: TM = 5 128, 128, 126; TM = 4 117, 96, 95; no
//     spills. __launch_bounds__(256, 2) caps a thread at 128. The stage
//     pointers rotate (no `% ring` a chunk), the weight pieces' offsets and
//     the thread's place come from threadIdx where they are used, and the
//     window copy is not unrolled, so that no per-thread offset stays live
//     across the product. No TM = 8: with this schedule's live state its 64
//     accumulators spilled 8-56 bytes in every form tried.
//   - The depthwise is recomputed F / BN times: 1 on layers 2-6, 2 on 7-12,
//     4 on 13-14. Computing it once per cluster of F / BN blocks and copying
//     it to every rank through distributed shared memory is not done: the
//     most it could save is the redundant part of the depthwise's share of
//     a chunk's instructions (9 taps of 4 channels and their reads against
//     8 x TM products a k, about a tenth; half of it redundant on 7-12,
//     three quarters on 13-14), and it puts a cluster barrier where the
//     block's one barrier a chunk is.
//   - Exact f32: FFMA only, no TF32, no tensor cores, no split K, no
//     atomics. The arithmetic is that of the earlier kernels, so the outputs
//     are bit for bit the same: depthwise a = x_centre * w[4] (__fmul_rn),
//     then fmaf over the other taps in tap order (a tap off the image is
//     skipped), then fmaxf(__fadd_rn(a, bias), 0); pointwise one
//     accumulator per output from 0, acc = fmaf(a_k, w_k, acc) for k
//     ascending; epilogue fmaxf(__fadd_rn(acc, bias), 0).
//   - Grid. BN = min(F, 256); TM = 5 or 4, whichever gives the busiest SM
//     the least work, ceil(blocks / SMs) x (BM + BLOCK_ROWS), BLOCK_ROWS =
//     48 positions of a block's fixed work, TM = 5 on a tie. At B = 209:
//     layer 2 2007 blocks (BM 160), 3 and 4 1004 (80), 5 and 6 502 (40),
//     7-12 252 (40: every SM one or two blocks), 13-14 128 (40). Only BM
//     depends on the batch, never BK, BN or the order of K, so a patch's
//     outputs do not depend on it.
//   Pooling is a second small kernel that sums the spatial positions in a
//   fixed order.
//   The wide tile fills the card only at large batches: at B = 1-8 the
//   tail layers would launch 2-4 blocks on 132 SMs, each streaming its
//   0.5-1 MB of weights; the narrow tiles run there (below).
//   Measured (tools/compare_builds.py, device time alone, B = 209, against
//   the earlier kernel in the same call, H100 SXM at 700 W): fused_tail
//   0.557 ms (earlier 0.637), fused_front 0.448 (0.456), layers 4-7 0.288
//   (0.301); layers 8-12 0.081 each (0.093), 2.0x their bound at 67
//   TFLOP/s, 13 and 14 0.055 and 0.094 (0.061, 0.109), 2.8x and 2.4x;
//   layers 3 and 4 are slower, 0.074 and 0.104 (0.069, 0.094: the earlier
//   TM = 8 tile), the others 0.87-0.98x. B = 1-8 within 1%.

// HIGHEST at small batches (sep_narrow_kernel<BN, TM>). 256 threads; BN =
// 8, 16, 32 or 64 threads along N, one output channel each, and 256 / BN
// along M, each TM = 1, 2 or 4 positions 256 / BN apart: BM = 256 / BN x
// TM, 4-128 positions. K in chunks of NK = 64 input channels (so C in
// chunks of 64: layer 2's 32 channels keep the wide tile) through the same
// ring of 3 stages (2 where 3 do not fit a block), two barriers a chunk.
// A stage holds the chunk's weights transposed, (BN, 64 + 4) (4-byte
// cp.async), so a thread reads 4 K steps of its channel as one float4, and
// the A tile is (position, 64 + 4), so it reads 4 K steps of a position as
// one float4: 1 + TM shared reads per 4 TM multiply-adds. Rows of 68
// floats put 8 neighbouring rows on distinct bank groups. The depthwise is
// recomputed by every n-block (F / BN times) for its own positions only:
// 9 multiply-adds a position and channel against the product's BN.
//   - The same arithmetic, so the outputs are bit for bit those of the
//     wide tile: depthwise centre product and bias sum written as
//     __fmul_rn / __fadd_rn (nothing may fold them into a multiply-add),
//     the other taps fmaf in tap order; pointwise one accumulator per
//     output from 0 over K ascending, fmaxf(acc + bias, 0). No split K, no
//     atomics; a thread whose positions lie past the batch skips the
//     product, and no row past the batch is computed.
//   - Grid. ffma_geometry prices the wide tile and the 12 narrow ones with
//     ffma_cost, the busiest SM's share: ceil(blocks / SMs) blocks, each
//     rows x (BN + 9) multiply-adds and BN + window rows floats brought in
//     (LOAD_COST = 16 multiply-adds a float) per input channel, and takes
//     the cheapest, the wide tile on a tie. The shapes alone decide: the
//     narrow tiles win at B = 1-8 on layers 3-14 (the tail 64-128 blocks,
//     against 2-4), the wide tile at B = 209 on every layer (its grid
//     above) and from B = 16-128 on, layer by layer.
//     tools/ffma_geometries.py times all 14 tiles per layer and batch: on
//     layers 2-8, 13 and 14 at B = 1-209 the picked tile took 1.031x the
//     fastest on average (1.358x at worst: layer 5 at B = 16, where the
//     wide tile at TM = 4 beats the narrow pick). LOAD_COST 8 averaged
//     1.024x but left layer 8 at B = 1 on 48 blocks; 32 averaged 1.026x
//     (1.292x at worst) but gains only at B = 16-32, which no path of the
//     port launches, and moves layer 3 at B = 8 to a tile 1% slower.
//   - ops/sepconv.py::ffma_geometry mirrors the rule; bz_sep_geometry
//     gives the library's choice, which chip_smoke.py holds to the mirror
//     at every B from 1 to 209.
//   Measured (tools/compare_builds.py, device time alone, H100 SXM at 700
//   W): fused_tail at B = 1-8 0.090-0.138 ms against the wide tile's
//   0.366-0.381 (cuDNN's f32 stack: 0.18-0.24, chip_smoke.py), fused_front
//   0.036-0.072 against 0.097-0.098; B = 209 as before. What bounds it now
//   (inferred from tools/ffma_geometries.py, not traced): a fixed ~4 us a
//   launch (layer 3, one K chunk, 3.9 us at B = 1) and ~1.1 us a K chunk
//   (layer 8, eight chunks, 11.8 us), where each chunk's 64 FFMAs take
//   ~0.1 us; so the shared-memory reads (the depthwise recomputed by every
//   n-block reads as much as the product) and the two barriers, not the
//   FFMA chain. A deeper ring was tried and did not help: the loads are
//   not what waits. Computing the depthwise once per layer, and fewer
//   launches for the whole tail, are the next steps.
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
//   What bounds it (measured on the card, tools/mma_tiles.py): not
//   the tensor cores. At the cells' 1,667 patches layers 5-14 ran 2.1-10x
//   their floor (f32 activations read and written once), 2.50 ms a chunk
//   in all; at B = 209 3.5-22x. Its 16-32 rows a block (BN = 256) bring a
//   chunk's 16 KB of weights in from L2 for each 16-32 positions. At large
//   batches sep_mma_wide_kernel (below) takes those layers.
//
// BF16 at large batches (sep_mma_wide_kernel<BM>). The same scheme and
// arithmetic as sep_layer_mma_kernel, on BM = 128 or 64 positions x 256
// channels: eight warps of 2 x 4, each BM / 2 x 64 outputs (BM = 128: 128
// accumulators a thread, 255 registers, one block an SM). A chunk's 16 KB
// of weights now serve 64-128 positions, and the window's rows past its
// BM outputs are a smaller share.
//   - Pipeline: sep_layer_kernel's, one barrier a chunk and two A tiles:
//     stage s of the cp.async ring (3 stages, 2 where 3 do not fit a
//     block: layers 5 and 7 at 128 rows) holds chunk s's weights and chunk
//     s + 1's taps, bias and window; between barriers a block refills the
//     stage the last chunk used, computes chunk k + 1's depthwise into one
//     A tile and multiplies chunk k from the other.
//   - Bits: both tensor-core kernels call the same depthwise_at (centre
//     tap first, the others in tap order, a tap off the image reads 0,
//     bias, ReLU), store_bf16x4 (round to nearest even) and store_mma_tile
//     (the epilogue's bias and ReLU in f32), and each output is one chain
//     of mma.sync over K in k16 steps, ascending, from zero. So its outputs
//     equal sep_layer_mma_kernel's bit for bit on every layer and batch
//     (tests/test_torch_sepconv.py checks layers 5-14 at B = 209 and 1,667,
//     chip_smoke.py at B = 1-1,667, and holds them to the plain version): a
//     patch's scores do not depend on the tile its batch drew.
//   - Grid: one dimension, the F / 256 blocks of an M tile one after
//     another, so the window they share comes from device memory once.
//   - The window's copy gives each thread rows MT / 8 apart, the taps and
//     bias apart: per piece an add and a compare, not the divisions and
//     selects of sep_layer_mma_kernel's loop. That alone took layer 7 from
//     0.175 to 0.139 ms and layer 13 from 0.187 to 0.140 at 1,667 patches.
//   - Rule (mma_geometry): in BF16 the tile mma_cost prices least of
//     sep_layer_mma_kernel's and the wide one at 128 and 64 rows, a wide
//     one only where its blocks leave no more than every other SM idle;
//     HIGH keeps sep_layer_mma_kernel. mma_cost is the busiest SM's waves
//     x chunks x (its blocks' positions at POSITION_COST = 640 bytes each
//     plus the bytes they bring in), a fit to both tiles' times at B = 32,
//     64, 209 and 1,667. It gives: B = 1-32 sep_layer_mma_kernel
//     everywhere; B = 64 the wide tile at 64 rows on layers 5 and 6;
//     B = 209 the wide tile on every layer 5-14 (64 rows on 5, 6, 13, 14;
//     128 on 7-12); B = 1,667 128 rows on 5-12, 64 on 13 and 14.
//   - Measured (tools/mma_tiles.py, device time alone, H100 SXM at 700 W),
//     at 1,667 patches against sep_layer_mma_kernel: layer 5 0.211 ms
//     (0.303), 6 0.219 (0.288), 7 0.141 (0.229), 8-12 0.186-0.189 (0.253-
//     0.254), 13 0.145 (0.165), 14 0.220 (0.252): 1.87 ms against 2.51 for
//     layers 5-14, 1.4-9.0x their floor. At B = 209 0.378 ms against
//     0.465, layer 6 even. Each pick is the fastest tile or within 6% of
//     it, at B = 1-1,667; at B <= 32 the fastest wide tile takes 1.14-1.84x
//     sep_layer_mma_kernel's time on every layer 5-14.
//   What bounds it now (timed with parts of the kernel taken out):
//   at layer 8, 1,667 patches, the copies alone take 0.10-0.12 ms (the
//   floor is 0.049), the depthwise and product alone 0.16 ms, all of it
//   0.19: the warps of one block an SM wait on their own depthwise's
//   shared-memory reads and chains more than on the tensor cores (the
//   product alone, 0.08 ms, runs at ~250 TFLOP/s). Tried and dropped: bulk
//   copies by the copy engine (TMA, one a 128-byte row: slower than
//   cp.async), a depthwise that reuses input rows across output rows (255
//   registers spill), and producer and consumer warps (setmaxnreg 88/168
//   and 96/160: 10-15% slower). Fewer instructions a chunk, or a deeper K
//   chunk, are the next steps.

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
// A rows: FK channels of one position, padded by 4 floats, so a row stays
// 16-byte aligned and the 4 neighbouring rows a warp reads at once start on
// bank quads 0, 20, 8 and 28
constexpr int ALD = FK + 4;

// The tile of sep_layer_kernel<BN, TM>: TX = BN / 8 threads along N, each
// 8 channels in two float4 groups BN / 2 apart; TY = 256 / TX along M, each
// TM = 5 or 4 positions TY apart. A warp is 8 x 4 threads.
template <int BN, int TM>
struct FfmaTile {
    static constexpr int TX = BN / 8;
    static constexpr int TY = FT / TX;
    static constexpr int BM = TM * TY;  // positions per block
    static constexpr int WX = TX / 8;   // warps along N
    // the thread's place along N and M, from threadIdx where it is needed,
    // not kept across the chunk loop
    __device__ static int tx() {
        return (threadIdx.x / 32 % WX) * 8 + threadIdx.x % 8;
    }
    __device__ static int ty() {
        return (threadIdx.x / 32 / WX) * 4 + threadIdx.x % 32 / 8;
    }
};

// Input rows that the depthwise of `bm` consecutive outputs reads, at
// most: the outputs span at most (bm + wo - 2) / wo + 1 output rows, whose
// centres lie stride input rows apart (or less, from one image's last row
// to the next one's first), so stride times that less one, plus 3, input
// rows of W, and a position either side. window_rows, which the other
// tiles size by, allows one output row more.
__host__ __device__ inline int ffma_window_rows(int bm, const Layer& L) {
    return (L.stride * ((bm + L.wo - 2) / L.wo) + 3) * L.w + 2;
}

// One ring stage, in floats: a chunk's (FK, BN) weights, then the next
// chunk's taps, bias and input window, FK channels a row
__host__ __device__ inline int ffma_stage(int bm, int bn, const Layer& L) {
    return FK * bn + (XHEAD + ffma_window_rows(bm, L)) * FK;
}

// Dynamic shared memory of a tile: two f32 A tiles (BM, ALD), then the
// ring's stages
inline int ffma_smem(int bm, int bn, int stages, const Layer& L) {
    return (int)sizeof(float) *
           (2 * bm * ALD + stages * ffma_stage(bm, bn, L));
}

template <int BN, int TM>
__global__ void __launch_bounds__(FT, 2)
sep_layer_kernel(const float* __restrict__ x, float* __restrict__ y,
                 const Layer L, const int m_total, const int ring) {
    using T = FfmaTile<BN, TM>;
    constexpr int BM = T::BM, TY = T::TY;
    // depthwise: 4 threads per position, 4 neighbouring channels each, so
    // 64 positions per pass (BM = 32: half the threads rest)
    constexpr int DW_POS = (BM + 63) / 64;
    constexpr int PIECES = FK * BN / 4;  // 16-byte pieces of weights
    static_assert(PIECES % FT == 0, "weight tile");
    const int stage = ffma_stage(BM, BN, L);  // floats
    extern __shared__ __align__(16) unsigned char ffma_smem_raw[];
    float* const As = reinterpret_cast<float*>(ffma_smem_raw);
    float* const Ring = As + 2 * BM * ALD;

    const int tid = threadIdx.x;
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
    const int xrows = ffma_window_rows(BM, L);
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

    // Stage s holds chunk s's weights and chunk s + 1's depthwise inputs,
    // the two a block uses between the same two barriers; chunk 0's
    // depthwise inputs go to the stage before 0, ring - 1, whose weights
    // come only after chunk 0's depthwise is done.
    const float* const pw = static_cast<const float*>(L.pw);
    // chunk k's (FK, BN) weights into stage S: the thread's 16-byte pieces
    // lie W_ROWS rows apart, from row w_row, column w_col (from threadIdx
    // here, not kept across the chunk loop)
    constexpr int W_ROWS = FT / (BN / 4);
    auto load_weights = [&](float* S, int chunk) {
        const int w_row = threadIdx.x / (BN / 4);
        const int w_col = threadIdx.x % (BN / 4) * 4;
        const float* src =
            pw + ((long long)chunk * FK + w_row) * L.f + n0 + w_col;
        float* dst = S + w_row * BN + w_col;
#pragma unroll
        for (int i = 0; i < PIECES / FT; ++i) {
            cp_async16(dst, src);
            src += W_ROWS * L.f;
            dst += W_ROWS * BN;
        }
    };
    // chunk k's depthwise inputs into stage S, after its weights: taps,
    // bias, the input window's FK channels; zeros off the ends of the batch
    auto load_window = [&](float* S, int chunk) {
        float* const X = S + FK * BN + kq;
        const int c0 = chunk * FK + kq;
        // not unrolled: an unrolled copy keeps each piece's address live
        // across the product, past the registers two blocks an SM leave
#pragma unroll 1
        for (int r = tid / 4; r < XHEAD + n_rows; r += FT / 4) {
            const int p = lo + r - XHEAD;
            const bool ok = r < XHEAD || (p >= 0 && p < n_in);
            const float* g =
                r < 9 ? L.dw + r * L.c
                      : r == 9 ? L.dw_b
                               : x + (long long)(ok ? p : 0) * L.c;
            cp_async16(X + r * FK, g + c0, ok);
        }
    };
    // cp.async group g into stage S: chunk g's weights and chunk g + 1's
    // depthwise inputs
    auto load_group = [&](float* S, int g) {
        if (g < n_chunks) load_weights(S, g);
        if (g + 1 < n_chunks) load_window(S, g + 1);
        cp_async_commit();
    };
    // the depthwise + bias + ReLU of the chunk whose inputs stage S holds,
    // into A tile A, stored (position, k): each (position, 4 channels) one
    // float4. Position by position, centre tap first, then the others in
    // tap order, as the TPU kernel accumulates them; the product and the
    // sum that no multiply-add may absorb are written as such.
    auto depthwise = [&](const float* S, float* A) {
        const float* const X = S + FK * BN;
        const float4 wc = lds4(X + 4 * FK + kq);
        const float4 bias = lds4(X + 9 * FK + kq);
#pragma unroll
        for (int j = 0; j < DW_POS; ++j) {
            const int pos = tid / 4 + 64 * j;
            if (pos >= BM) continue;
            const int on = taps[j];
            const float* const xc = X + row[j] * FK + kq;
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (on) {
                const float4 c = lds4(xc);
                float4 a = make_float4(
                    __fmul_rn(c.x, wc.x), __fmul_rn(c.y, wc.y),
                    __fmul_rn(c.z, wc.z), __fmul_rn(c.w, wc.w));
#pragma unroll
                for (int t = 0; t < 9; ++t) {
                    if (t == 4 || !((on >> t) & 1)) continue;
                    const float4 w = lds4(X + t * FK + kq);
                    const float4 u =
                        lds4(xc + ((t / 3 - 1) * L.w + (t % 3 - 1)) * FK);
                    a.x = fmaf(u.x, w.x, a.x);
                    a.y = fmaf(u.y, w.y, a.y);
                    a.z = fmaf(u.z, w.z, a.z);
                    a.w = fmaf(u.w, w.w, a.w);
                }
                v = make_float4(fmaxf(__fadd_rn(a.x, bias.x), 0.f),
                                fmaxf(__fadd_rn(a.y, bias.y), 0.f),
                                fmaxf(__fadd_rn(a.z, bias.z), 0.f),
                                fmaxf(__fadd_rn(a.w, bias.w), 0.f));
            }
            *reinterpret_cast<float4*>(A + pos * ALD + kq) = v;
        }
    };

    float acc[TM][8];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    // the product of the chunk whose weights stage S holds with A tile A:
    // the thread's positions i * TY + ty, channels tx * 4 .. + 3 and BN / 2
    // + tx * 4 .. + 3. Per 4 k, one float4 of each position (4 k of its
    // row), then k by k two float4s of weights.
    auto multiply = [&](const float* S, const float* A) {
        const float* const Ap = A + T::ty() * ALD;
        const float* const B = S + T::tx() * 4;
#pragma unroll
        for (int k0 = 0; k0 < FK; k0 += 4) {
            float4 a[TM];
#pragma unroll
            for (int i = 0; i < TM; ++i) a[i] = lds4(Ap + i * TY * ALD + k0);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                const float4 b0 = lds4(B + (k0 + kk) * BN);
                const float4 b1 = lds4(B + (k0 + kk) * BN + BN / 2);
                const float b[8] = {b0.x, b0.y, b0.z, b0.w,
                                    b1.x, b1.y, b1.z, b1.w};
#pragma unroll
                for (int i = 0; i < TM; ++i) {
                    const float ai = kk == 0   ? a[i].x
                                     : kk == 1 ? a[i].y
                                     : kk == 2 ? a[i].z
                                               : a[i].w;
#pragma unroll
                    for (int j = 0; j < 8; ++j)
                        acc[i][j] = fmaf(ai, b[j], acc[i][j]);
                }
            }
        }
    };

    // One barrier per chunk. Group g lands in stage g % ring; the wait
    // before barrier k leaves ring - 2 groups in flight, so group k has
    // landed. Between barriers k and k + 1 a block refills stage (k - 1) %
    // ring (`last`), which chunk k - 1's product and chunk k's depthwise
    // are done with, with group k + ring - 1; computes chunk k + 1's
    // depthwise from stage k % ring (`cur`) into A tile (k + 1) % 2, which
    // chunk k - 1's product is done with; and multiplies chunk k, from
    // `cur` and A tile k % 2. Each group has ring - 1 products' time to
    // land. Chunk 0's depthwise inputs come first, as a group of their own.
    auto wait_group = [&]() {
        if (ring == FRING)
            cp_async_wait<FRING - 2>();
        else
            cp_async_wait<0>();
    };
    float* const end = Ring + (ring - 1) * stage;
    float* last = end;
    float* cur = Ring;
    load_window(last, 0);
    cp_async_commit();
    for (int g = 0; g < ring - 1; ++g) load_group(Ring + g * stage, g);
    if (ring == FRING)
        cp_async_wait<FRING - 1>();
    else
        cp_async_wait<1>();
    __syncthreads();
    depthwise(last, As);
    for (int kc = 0; kc < n_chunks; ++kc) {
        wait_group();
        __syncthreads();
        load_group(last, kc + ring - 1);
        if (kc + 1 < n_chunks)
            depthwise(cur, As + ((kc + 1) & 1) * BM * ALD);
        multiply(cur, As + (kc & 1) * BM * ALD);
        last = cur;
        cur = cur == end ? Ring : cur + stage;
    }

    const int tx = T::tx(), ty = T::ty();
    const float4 pb0 = *reinterpret_cast<const float4*>(L.pw_b + n0 + tx * 4);
    const float4 pb1 =
        *reinterpret_cast<const float4*>(L.pw_b + n0 + BN / 2 + tx * 4);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int m = m0 + i * TY + ty;
        if (m >= m_total) continue;
        const float* c = acc[i];
        float* const out = y + (long long)m * L.f + n0 + tx * 4;
        *reinterpret_cast<float4*>(out) = make_float4(
            fmaxf(__fadd_rn(c[0], pb0.x), 0.f),
            fmaxf(__fadd_rn(c[1], pb0.y), 0.f),
            fmaxf(__fadd_rn(c[2], pb0.z), 0.f),
            fmaxf(__fadd_rn(c[3], pb0.w), 0.f));
        *reinterpret_cast<float4*>(out + BN / 2) = make_float4(
            fmaxf(__fadd_rn(c[4], pb1.x), 0.f),
            fmaxf(__fadd_rn(c[5], pb1.y), 0.f),
            fmaxf(__fadd_rn(c[6], pb1.z), 0.f),
            fmaxf(__fadd_rn(c[7], pb1.w), 0.f));
    }
}

// --- the FFMA route for small batches (HIGHEST) ----------------------------------

constexpr int NK = 64;  // input channels per K chunk
// A and weight rows padded by 4 floats: 16-byte aligned, and 8 neighbouring
// rows start on distinct bank groups
constexpr int NLD = NK + 4;

// The tile of sep_narrow_kernel<BN, TM>: BN threads along N, one output
// channel each; TY = 256 / BN along M, each TM positions TY apart.
template <int BN, int TM>
struct NarrowTile {
    static constexpr int TY = FT / BN;
    static constexpr int BM = TY * TM;  // positions per block
};

// One ring stage, in floats: a chunk's weights transposed, (BN, NLD), then
// its taps, bias and input window, NK channels a row
__host__ __device__ inline int narrow_stage(int bm, int bn, const Layer& L) {
    return bn * NLD + (XHEAD + window_rows(bm, L)) * NK;
}

// Dynamic shared memory of a tile: the f32 A tile (BM, NLD), then the ring
inline int narrow_smem(int bm, int bn, int stages, const Layer& L) {
    return (int)sizeof(float) *
           (bm * NLD + stages * narrow_stage(bm, bn, L));
}

// 4 bytes global -> shared, asynchronously
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
}

template <int BN, int TM>
__global__ void __launch_bounds__(FT, 2)
sep_narrow_kernel(const float* __restrict__ x, float* __restrict__ y,
                  const Layer L, const int m_total, const int ring) {
    using T = NarrowTile<BN, TM>;
    constexpr int BM = T::BM, TY = T::TY;
    constexpr int GROUPS = NK / 4;        // float4 groups of a chunk
    constexpr int DW_STEP = FT / GROUPS;  // positions per depthwise pass
    constexpr int DW_POS = (BM + DW_STEP - 1) / DW_STEP;
    static_assert((NK * BN) % FT == 0, "weight tile");
    const int stage = narrow_stage(BM, BN, L);  // floats
    extern __shared__ __align__(16) unsigned char narrow_smem_raw[];
    float* const As = reinterpret_cast<float*>(narrow_smem_raw);
    float* const Ring = As + BM * NLD;

    const int tid = threadIdx.x, tx = tid % BN, ty = tid / BN;
    const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
    const int hwo = L.ho * L.wo;
    const int n_chunks = L.c / NK;
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

    // the thread's depthwise positions, as sep_layer_kernel's
    const int kq = (tid % GROUPS) * 4;
    int row[DW_POS], taps[DW_POS];
#pragma unroll
    for (int j = 0; j < DW_POS; ++j) {
        const int pos = tid / GROUPS + DW_STEP * j, m = m0 + pos;
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
    // chunk k's weights, transposed to (BN, NK) rows, and its depthwise
    // inputs (taps, bias, the input window's NK channels; zeros off the
    // ends of the batch) into ring stage k % ring
    auto load_chunk = [&](int chunk) {
        float* const W = Ring + (chunk % ring) * stage;
        float* const X = W + BN * NLD;
        const int c0 = chunk * NK;
        const float* const src = pw + (long long)c0 * L.f + n0;
#pragma unroll
        for (int i = 0; i < NK * BN / FT; ++i) {
            const int q = tid + i * FT;
            const int k = q / BN, n = q % BN;
            cp_async4(W + n * NLD + k, src + (long long)k * L.f + n);
        }
        for (int q = tid; q < (XHEAD + n_rows) * GROUPS; q += FT) {
            const int r = q / GROUPS, cc = (q % GROUPS) * 4;
            const int p = lo + r - XHEAD;
            const bool ok = r < XHEAD || (p >= 0 && p < n_in);
            const float* g =
                r < 9 ? L.dw + r * L.c
                      : r == 9 ? L.dw_b
                               : x + (long long)(ok ? p : 0) * L.c;
            cp_async16(X + r * NK + cc, g + c0 + cc, ok);
        }
    };
    // chunk k's depthwise + bias + ReLU from its stage into the A tile,
    // stored (position, k); the arithmetic of sep_layer_kernel's, with the
    // product and the sum that no multiply-add may absorb written as such
    auto depthwise = [&](int chunk) {
        const float* const X = Ring + (chunk % ring) * stage + BN * NLD;
        float4 a[DW_POS];
        const float4 wc = lds4(X + 4 * NK + kq);
#pragma unroll
        for (int j = 0; j < DW_POS; ++j) {
            a[j] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (taps[j]) {
                const float4 v = lds4(X + row[j] * NK + kq);
                a[j] = make_float4(__fmul_rn(v.x, wc.x), __fmul_rn(v.y, wc.y),
                                   __fmul_rn(v.z, wc.z), __fmul_rn(v.w, wc.w));
            }
        }
#pragma unroll
        for (int t = 0; t < 9; ++t) {
            if (t == 4) continue;
            const int off = ((t / 3 - 1) * L.w + (t % 3 - 1)) * NK;
            const float4 w = lds4(X + t * NK + kq);
#pragma unroll
            for (int j = 0; j < DW_POS; ++j) {
                if (!((taps[j] >> t) & 1)) continue;
                const float4 v = lds4(X + row[j] * NK + off + kq);
                a[j].x = fmaf(v.x, w.x, a[j].x);
                a[j].y = fmaf(v.y, w.y, a[j].y);
                a[j].z = fmaf(v.z, w.z, a[j].z);
                a[j].w = fmaf(v.w, w.w, a[j].w);
            }
        }
        const float4 bias = lds4(X + 9 * NK + kq);
#pragma unroll
        for (int j = 0; j < DW_POS; ++j) {
            const int pos = tid / GROUPS + DW_STEP * j;
            if (pos >= BM) continue;
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (taps[j])
                v = make_float4(fmaxf(__fadd_rn(a[j].x, bias.x), 0.f),
                                fmaxf(__fadd_rn(a[j].y, bias.y), 0.f),
                                fmaxf(__fadd_rn(a[j].z, bias.z), 0.f),
                                fmaxf(__fadd_rn(a[j].w, bias.w), 0.f));
            *reinterpret_cast<float4*>(As + pos * NLD + kq) = v;
        }
    };

    // one accumulator per output from 0, k ascending; a thread whose first
    // position lies past the batch has no output and skips the product
    float acc[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) acc[i] = 0.f;
    const bool busy = m0 + ty < m_total;
    auto multiply = [&](int chunk) {
        const float* const W = Ring + (chunk % ring) * stage + tx * NLD;
#pragma unroll
        for (int k = 0; k < NK; k += 4) {
            const float4 w = lds4(W + k);
#pragma unroll
            for (int i = 0; i < TM; ++i) {
                const float4 a = lds4(As + (ty + TY * i) * NLD + k);
                acc[i] = fmaf(a.x, w.x, acc[i]);
                acc[i] = fmaf(a.y, w.y, acc[i]);
                acc[i] = fmaf(a.z, w.z, acc[i]);
                acc[i] = fmaf(a.w, w.w, acc[i]);
            }
        }
    };

    // chunk k's stage was committed as cp.async group k; the first barrier
    // of iteration k ends chunk k-1's product, so stage (k-1) % ring can be
    // refilled and the A tile rewritten; the second makes the A tile whole
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
        if (busy) multiply(kc);
    }

    const float pb = L.pw_b[n0 + tx];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int m = m0 + ty + TY * i;
        if (m < m_total)
            y[(long long)m * L.f + n0 + tx] =
                fmaxf(__fadd_rn(acc[i], pb), 0.f);
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

// --- what every tensor-core tile computes alike -------------------------------
// A patch's scores must not depend on the tile its batch drew, so the two
// tensor-core kernels share the arithmetic of their outputs: one
// position's depthwise, its bf16 rounding and one mma tile's epilogue.

// The flattened input position of output m's centre tap
__device__ __forceinline__ int centre_of(const Layer& L, int m) {
    const int hwo = L.ho * L.wo;
    const int b = m / hwo, r = m % hwo;
    return (b * L.h + (r / L.wo) * L.stride + L.off_h) * L.w +
           (r % L.wo) * L.stride + L.off_w;
}

// One bit per tap t of output m that lies on the image
__device__ __forceinline__ int taps_on(const Layer& L, int m) {
    const int r = m % (L.ho * L.wo);
    const int ch = (r / L.wo) * L.stride + L.off_h;
    const int cw = (r % L.wo) * L.stride + L.off_w;
    int on = 0;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
        const int ih = ch + t / 3 - 1, iw = cw + t % 3 - 1;
        if (ih >= 0 && ih < L.h && iw >= 0 && iw < L.w) on |= 1 << t;
    }
    return on;
}

// The depthwise + bias + ReLU in f32 of 4 channels of one position: its
// centre tap at xp in a window of MK channels a position and rows of L.w
// positions, its taps w and bias; `on` as taps_on gives it, 0 for a
// position past the batch, which reads 0. The centre tap first, then the
// others in tap order, a tap off the image reading 0, as the TPU kernel
// accumulates them.
__device__ __forceinline__ float4 depthwise_at(const float* xp,
                                               const float4 (&w)[9],
                                               float4 bias, int on,
                                               const Layer& L) {
    if (!on) return make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 c = lds4(xp);
    float4 a = make_float4(c.x * w[4].x, c.y * w[4].y, c.z * w[4].z,
                           c.w * w[4].w);
#pragma unroll
    for (int t = 0; t < 9; ++t) {
        if (t == 4) continue;
        const float4 u =
            (on >> t) & 1 ? lds4(xp + ((t / 3 - 1) * L.w + (t % 3 - 1)) * MK)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
        a.x = fmaf(u.x, w[t].x, a.x);
        a.y = fmaf(u.y, w[t].y, a.y);
        a.z = fmaf(u.z, w[t].z, a.z);
        a.w = fmaf(u.w, w[t].w, a.w);
    }
    return make_float4(fmaxf(a.x + bias.x, 0.f), fmaxf(a.y + bias.y, 0.f),
                       fmaxf(a.z + bias.z, 0.f), fmaxf(a.w + bias.w, 0.f));
}

// v rounded to bf16, to nearest even, into 4 consecutive A tile entries
__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* dst, float4 v) {
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(bits(__floats2bfloat162_rn(v.x, v.y)),
                   bits(__floats2bfloat162_rn(v.z, v.w)));
}

// The epilogue of one m16 x n8 mma tile whose first output is (m, n):
// bias + ReLU in f32. c0, c1 are row g's columns 2t, 2t+1 and c2, c3 row
// g+8's; each pair of lanes swaps halves, so the even lane stores row g's
// columns 2t..2t+3 and the odd lane row g+8's 2t-2..2t+1, one float4 each.
__device__ __forceinline__ void store_mma_tile(float* y, const Layer& L,
                                               int m_total,
                                               const float (&c)[4], int m,
                                               int n, int lane) {
    const int g = lane / 4, t = lane % 4;
    const bool odd = t & 1;
    const float s0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
    const float s1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
    const float4 o = odd ? make_float4(s0, s1, c[2], c[3])
                         : make_float4(c[0], c[1], s0, s1);
    m += g + (odd ? 8 : 0);
    n += 2 * (t & ~1);
    const float4 pb = *reinterpret_cast<const float4*>(L.pw_b + n);
    if (m < m_total)
        *reinterpret_cast<float4*>(y + (long long)m * L.f + n) =
            make_float4(fmaxf(o.x + pb.x, 0.f), fmaxf(o.y + pb.y, 0.f),
                        fmaxf(o.z + pb.z, 0.f), fmaxf(o.w + pb.w, 0.f));
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

    // the block's input window: every tap of its outputs
    const int m_last = (m0 + BM < m_total ? m0 + BM : m_total) - 1;
    const int lo = centre_of(L, m0) - L.w - 1;
    const int hi = centre_of(L, m_last) + L.w + 1;
    const int n_rows = hi - lo + 1 < xrows ? hi - lo + 1 : xrows;

    // the thread's depthwise positions: the window row of each centre tap
    // and its taps on the image (none past the batch)
    const int kq = (tid % 8) * 4;
    int row[DW_POS], on[DW_POS];
#pragma unroll
    for (int j = 0; j < DW_POS; ++j) {
        const int pos = tid / 8 + 32 * j, m = m0 + pos;
        row[j] = XHEAD;
        on[j] = 0;
        if (pos < BM && m < m_total) {
            row[j] = XHEAD + centre_of(L, m) - lo;
            on[j] = taps_on(L, m);
        }
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
            const float4 v =
                depthwise_at(X + row[j] * MK + kq, w, bias, on[j], L);
            __nv_bfloat16* const a_row = As + pos * LDA + kq;
            if (MODE == HIGH)
                split_hi_lo(v, a_row, a_row + T::A_PLANE);
            else
                store_bf16x4(a_row, v);
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

#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            float c[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
                c[e] = MODE == HIGH ? acc[0][i][j][e] + acc[NP - 1][i][j][e]
                                    : acc[0][i][j][e];
            store_mma_tile(y, L, m_total, c, m0 + wm * 16 * FM + i * 16,
                           n0 + wn * 32 + j * 8, lane);
        }
}

// --- the wide tensor-core tile (BF16, F >= 256, large batches) -------------------

constexpr int WBN = 256;         // output channels a block
constexpr int WWM = 2, WWN = 4;  // warps along M and along N

// The tile of sep_mma_wide_kernel<BM>: BM = 128 or 64 positions x 256
// output channels over 2 x 4 warps, each BM / 2 positions x 64 channels,
// FM x FN mma tiles of m16 x n8.
template <int BM>
struct WideTile {
    static constexpr int FM = BM / (16 * WWM);  // m16 tiles a warp: 4 or 2
    static constexpr int FN = WBN / (8 * WWN);  // n8 tiles a warp: 8
    static constexpr int LDA = MK + MPAD;       // A row, bf16
    static constexpr int LDB = WBN + MPAD;      // B row, bf16
    static constexpr int A_TILE = BM * LDA;     // one A tile, bf16
    static constexpr int B_STAGE = MK * LDB;    // a chunk's weights, bf16
};

// One ring stage of the wide tile, in bytes: a chunk's (MK, 256) bf16
// weights, then the next chunk's taps, bias and input window in f32, MK
// channels a row, the window sized by ffma_window_rows
__host__ __device__ inline int wide_stage(int bm, const Layer& L) {
    return (int)sizeof(__nv_bfloat16) * MK * (WBN + MPAD) +
           (int)sizeof(float) * (XHEAD + ffma_window_rows(bm, L)) * MK;
}

// Dynamic shared memory of the wide tile: two bf16 A tiles, then the ring
inline int wide_smem(int bm, int ring, const Layer& L) {
    return (int)sizeof(__nv_bfloat16) * 2 * bm * (MK + MPAD) +
           ring * wide_stage(bm, L);
}

template <int BM>
__global__ void __launch_bounds__(MT, 1)
sep_mma_wide_kernel(const float* __restrict__ x, float* __restrict__ y,
                    const Layer L, const int m_total, const int ring) {
    using T = WideTile<BM>;
    constexpr int FM = T::FM, FN = T::FN, LDA = T::LDA, LDB = T::LDB;
    // depthwise: 8 threads per position, 4 neighbouring channels each, so
    // 32 positions per pass
    constexpr int DW_POS = BM / 32;
    constexpr int PIECES = MK * WBN / 8;  // 16-byte pieces of weights
    static_assert(PIECES % MT == 0, "weight tile");
    const int xrows = ffma_window_rows(BM, L);
    const int stage = wide_stage(BM, L);  // bytes
    extern __shared__ __align__(16) unsigned char wide_smem_raw[];
    __nv_bfloat16* const As = reinterpret_cast<__nv_bfloat16*>(wide_smem_raw);
    unsigned char* const Ring =
        wide_smem_raw + sizeof(__nv_bfloat16) * 2 * T::A_TILE;
    // a stage's weights, and after them its depthwise inputs
    auto weights_of = [](unsigned char* S) {
        return reinterpret_cast<__nv_bfloat16*>(S);
    };
    auto window_of = [](unsigned char* S) {
        return reinterpret_cast<float*>(S + sizeof(__nv_bfloat16) *
                                                T::B_STAGE);
    };

    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int wm = warp / WWN, wn = warp % WWN;
    // the F / 256 blocks of one M tile run one after another, so the
    // input window they all read comes from device memory once
    const int n_tiles = L.f / WBN;
    const int m0 = blockIdx.x / n_tiles * BM;
    const int n0 = blockIdx.x % n_tiles * WBN;
    const int hwo = L.ho * L.wo;
    const int n_chunks = L.c / MK;
    const int n_in = m_total / hwo * L.h * L.w;  // input positions

    // the block's input window: every tap of its outputs
    const int m_last = (m0 + BM < m_total ? m0 + BM : m_total) - 1;
    const int lo = centre_of(L, m0) - L.w - 1;
    const int hi = centre_of(L, m_last) + L.w + 1;
    const int n_rows = hi - lo + 1 < xrows ? hi - lo + 1 : xrows;

    // the thread's depthwise positions: the window row of each centre tap
    // and its taps on the image (none past the batch)
    const int kq = (tid % 8) * 4;
    int row[DW_POS], on[DW_POS];
#pragma unroll
    for (int j = 0; j < DW_POS; ++j) {
        const int m = m0 + tid / 8 + 32 * j;
        row[j] = XHEAD;
        on[j] = 0;
        if (m < m_total) {
            row[j] = XHEAD + centre_of(L, m) - lo;
            on[j] = taps_on(L, m);
        }
    }

    // Stage s holds chunk s's weights and chunk s + 1's depthwise inputs,
    // the two a block uses between the same two barriers; chunk 0's
    // depthwise inputs go to the stage before 0, ring - 1, whose weights
    // come only after chunk 0's depthwise is done.
    const __nv_bfloat16* const pw = static_cast<const __nv_bfloat16*>(L.pw);
    auto load_weights = [&](unsigned char* S, int chunk) {
        __nv_bfloat16* const B = weights_of(S);
        const __nv_bfloat16* const src =
            pw + (long long)chunk * MK * L.f + n0;
#pragma unroll
        for (int i = 0; i < PIECES / MT; ++i) {
            const int q = threadIdx.x + i * MT;
            const int r = q / (WBN / 8), cc = (q % (WBN / 8)) * 8;
            cp_async16(B + r * LDB + cc, src + (long long)r * L.f + cc);
        }
    };
    // chunk k's depthwise inputs into stage S, after its weights: taps and
    // bias (the first 80 threads), then the input window's MK channels,
    // a thread's rows MT / 8 apart; zeros off the ends of the batch
    auto load_window = [&](unsigned char* S, int chunk) {
        float* const X = window_of(S);
        const int c0 = chunk * MK, cc = threadIdx.x % (MK / 4) * 4;
        if (threadIdx.x < XHEAD * (MK / 4)) {
            const int r = threadIdx.x / (MK / 4);
            cp_async16(X + r * MK + cc,
                       (r < 9 ? L.dw + r * L.c : L.dw_b) + c0 + cc);
        }
        // not unrolled: an unrolled copy keeps each piece's address live
        // across the product
#pragma unroll 1
        for (int r = threadIdx.x / (MK / 4); r < n_rows; r += MT / (MK / 4)) {
            const int p = lo + r;
            const bool ok = p >= 0 && p < n_in;
            cp_async16(X + (XHEAD + r) * MK + cc,
                       x + (long long)(ok ? p : 0) * L.c + c0 + cc, ok);
        }
    };
    // cp.async group g into stage S: chunk g's weights and chunk g + 1's
    // depthwise inputs
    auto load_group = [&](unsigned char* S, int g) {
        if (g < n_chunks) load_weights(S, g);
        if (g + 1 < n_chunks) load_window(S, g + 1);
        cp_async_commit();
    };
    // the depthwise + bias + ReLU of the chunk whose inputs stage S holds,
    // rounded to bf16, into A tile A (depthwise_at, as sep_layer_mma_kernel)
    auto depthwise = [&](unsigned char* S, __nv_bfloat16* A) {
        const float* const X = window_of(S);
        float4 w[9];
#pragma unroll
        for (int t = 0; t < 9; ++t) w[t] = lds4(X + t * MK + kq);
        const float4 bias = lds4(X + 9 * MK + kq);
#pragma unroll
        for (int j = 0; j < DW_POS; ++j)
            store_bf16x4(A + (tid / 8 + 32 * j) * LDA + kq,
                         depthwise_at(X + row[j] * MK + kq, w, bias, on[j],
                                      L));
    };

    float acc[FM][FN][4];
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    // the product of the chunk whose weights stage S holds with A tile A:
    // per k16 step, FM ldmatrix of A and FN / 2 transposed ldmatrix of B
    // feed FM x FN mma.sync, each output's chain over K ascending
    auto multiply = [&](unsigned char* S, const __nv_bfloat16* A) {
        const __nv_bfloat16* const B = weights_of(S);
#pragma unroll
        for (int ks = 0; ks < MK; ks += 16) {
            uint32_t a[FM][4], b[FN][2];
#pragma unroll
            for (int i = 0; i < FM; ++i)
                ldmatrix_x4(a[i], A + (wm * 16 * FM + i * 16 + lane % 16) * LDA +
                                      ks + (lane / 16) * 8);
#pragma unroll
            for (int jj = 0; jj < FN / 2; ++jj) {
                uint32_t r[4];
                ldmatrix_x4_trans(r, B + (ks + lane % 16) * LDB +
                                         wn * 8 * FN + jj * 16 +
                                         (lane / 16) * 8);
                b[2 * jj][0] = r[0];
                b[2 * jj][1] = r[1];
                b[2 * jj + 1][0] = r[2];
                b[2 * jj + 1][1] = r[3];
            }
#pragma unroll
            for (int i = 0; i < FM; ++i)
#pragma unroll
                for (int j = 0; j < FN; ++j) mma_bf16(acc[i][j], a[i], b[j]);
        }
    };

    // One barrier per chunk, as sep_layer_kernel's. Group g lands in stage
    // g % ring; the wait before barrier k leaves ring - 2 groups in flight,
    // so group k has landed. Between barriers k and k + 1 a block refills
    // stage (k - 1) % ring (`last`), which chunk k - 1's product and chunk
    // k's depthwise are done with, with group k + ring - 1; computes chunk k
    // + 1's depthwise from stage k % ring (`cur`) into A tile (k + 1) % 2,
    // which chunk k - 1's product is done with; and multiplies chunk k,
    // from `cur` and A tile k % 2.
    unsigned char* const end = Ring + (ring - 1) * stage;
    unsigned char* last = end;
    unsigned char* cur = Ring;
    load_window(last, 0);
    cp_async_commit();
    for (int g = 0; g < ring - 1; ++g) load_group(Ring + g * stage, g);
    if (ring == 3)
        cp_async_wait<2>();
    else
        cp_async_wait<1>();
    __syncthreads();
    depthwise(last, As);
    for (int kc = 0; kc < n_chunks; ++kc) {
        if (ring == 3)
            cp_async_wait<1>();
        else
            cp_async_wait<0>();
        __syncthreads();
        load_group(last, kc + ring - 1);
        if (kc + 1 < n_chunks)
            depthwise(cur, As + ((kc + 1) & 1) * T::A_TILE);
        multiply(cur, As + (kc & 1) * T::A_TILE);
        last = cur;
        cur = cur == end ? Ring : cur + stage;
    }

    // the epilogue of sep_layer_mma_kernel (store_mma_tile)
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
            store_mma_tile(y, L, m_total, acc[i][j],
                           m0 + wm * 16 * FM + i * 16, n0 + wn * 8 * FN + j * 8,
                           lane);
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
    return tm == 5 ? launch_ffma<BN, 5>(device, grid, smem, ring, stream, in,
                                        dst, L, m_total)
                   : launch_ffma<BN, 4>(device, grid, smem, ring, stream, in,
                                        dst, L, m_total);
}

// The launch of one HIGHEST layer: the kernel (narrow 0: sep_layer_kernel,
// 1: sep_narrow_kernel), its tile (BN, TM, BM), grid and ring stages, and
// its dynamic shared memory in bytes. ops/sepconv.py::ffma_geometry states
// the same rule: a change to one is made in the other.
struct Geometry {
    int narrow, bn, tm, bm, grid_m, grid_n, ring, smem;
};

// The weight of one float that a block brings in, against one
// multiply-add, in ffma_cost
constexpr int LOAD_COST = 16;

// The busiest SM's share of a layer, the yardstick between geometries, in
// multiply-adds per input channel: ceil(blocks / SMs) blocks, each
// computing `rows` positions x (BN + 9) (the pointwise and the depthwise
// it recomputes), and bringing in BN weights and the window of `rows_in`
// positions at LOAD_COST each.
long long ffma_cost(long long blocks, int rows, int rows_in, int bn,
                    const Layer& L, int sms) {
    return (blocks + sms - 1) / sms *
           ((long long)rows * (bn + 9) +
            (long long)LOAD_COST * (bn + window_rows(rows_in, L)));
}

// A block's fixed work in wide_geometry's price, in positions: its
// prologue (chunk 0's window and depthwise before the first product) and
// its epilogue. tools/ffma_geometries.py times both TMs at every layer:
// at 48 the price picks the faster on every layer at B = 209.
constexpr int BLOCK_ROWS = 48;

// The wide tile: BN = min(F, 256); TM = 5 or 4 positions per thread,
// whichever gives the busiest SM the least work, ceil(blocks / SMs) x (BM +
// BLOCK_ROWS), TM = 5 on a tie (a caller may name TM:
// tools/ffma_geometries.py times each); a ring of FRING stages if two
// blocks still fit an SM's shared memory, else 2 (two always fit at TM = 5
// and 4 with 2 stages on the YAMNet layers).
Geometry wide_geometry(const Layer& L, int m_total, int sms, int sm_smem,
                       int tm = 0) {
    Geometry g{};
    g.bn = L.f < 256 ? L.f : 256;
    const int ty = FT / (g.bn / 8);
    g.grid_n = L.f / g.bn;
    auto price = [&](int t) {
        const long long blocks =
            (long long)((m_total + t * ty - 1) / (t * ty)) * g.grid_n;
        return (blocks + sms - 1) / sms * (t * ty + BLOCK_ROWS);
    };
    g.tm = tm ? tm : price(4) < price(5) ? 4 : 5;
    g.bm = g.tm * ty;
    g.grid_m = (m_total + g.bm - 1) / g.bm;
    g.ring = 2 * (ffma_smem(g.bm, g.bn, FRING, L) + 1024) <= sm_smem ? FRING
                                                                      : 2;
    g.smem = ffma_smem(g.bm, g.bn, g.ring, L);
    return g;
}

// A narrow tile (C in chunks of NK only), BN = 8, 16, 32 or 64 and TM =
// 1, 2 or 4, with a ring of FRING stages if a block's shared memory holds
// it, else 2; ring 0 where neither fits or C is not in chunks of NK.
Geometry narrow_geometry(const Layer& L, int m_total, int bn, int tm,
                         int block_smem) {
    const int bm = FT / bn * tm, chunks = L.c / NK;
    auto smem = [&](int r) {
        return narrow_smem(bm, bn, chunks < r ? chunks : r, L);
    };
    int ring = smem(FRING) <= block_smem ? FRING : 2;
    if (L.c % NK || smem(ring) > block_smem) ring = 0;
    return Geometry{1, bn, tm, bm, (m_total + bm - 1) / bm, L.f / bn, ring,
                    smem(ring)};
}

// The wide tile, unless a narrow one costs less by ffma_cost: of BN = 8,
// 16, 32, 64 x TM = 1, 2, 4 the first of least cost. The wide tile computes
// all its BM rows, a narrow one only those in the batch.
Geometry ffma_geometry(const Layer& L, int m_total, int sms, int sm_smem,
                       int block_smem) {
    Geometry g = wide_geometry(L, m_total, sms, sm_smem);
    long long best =
        ffma_cost((long long)g.grid_m * g.grid_n, g.bm,
                  g.bm < m_total ? g.bm : m_total, g.bn, L, sms);
    for (const int bn : {8, 16, 32, 64}) {
        for (const int tm : {1, 2, 4}) {
            const Geometry n = narrow_geometry(L, m_total, bn, tm, block_smem);
            if (!n.ring) continue;
            const int rows = n.bm < m_total ? n.bm : m_total;
            const long long cost = ffma_cost(
                (long long)n.grid_m * n.grid_n, rows, rows, bn, L, sms);
            if (cost < best) {
                best = cost;
                g = n;
            }
        }
    }
    return g;
}

template <int BN, int TM>
cudaError_t launch_narrow(int device, const Geometry& g, cudaStream_t stream,
                          const float* in, float* dst, const Layer& L,
                          int m_total) {
    static std::atomic<bool> ready[MAX_DEVICES];
    const cudaError_t err =
        opt_in_smem(sep_narrow_kernel<BN, TM>, device, ready);
    if (err != cudaSuccess) return err;
    sep_narrow_kernel<BN, TM><<<dim3(g.grid_m, g.grid_n), FT, g.smem,
                                stream>>>(in, dst, L, m_total, g.ring);
    return cudaGetLastError();
}

template <int BN>
cudaError_t launch_narrow_tm(int device, const Geometry& g,
                             cudaStream_t stream, const float* in, float* dst,
                             const Layer& L, int m_total) {
    switch (g.tm) {
        case 1:
            return launch_narrow<BN, 1>(device, g, stream, in, dst, L,
                                        m_total);
        case 2:
            return launch_narrow<BN, 2>(device, g, stream, in, dst, L,
                                        m_total);
        default:
            return launch_narrow<BN, 4>(device, g, stream, in, dst, L,
                                        m_total);
    }
}

// One HIGHEST layer at geometry g.
cudaError_t launch_geometry(int device, const Geometry& g, cudaStream_t stream,
                            const float* in, float* dst, const Layer& L,
                            int m_total) {
    if (g.narrow) {
        switch (g.bn) {
            case 8:
                return launch_narrow_tm<8>(device, g, stream, in, dst, L,
                                           m_total);
            case 16:
                return launch_narrow_tm<16>(device, g, stream, in, dst, L,
                                            m_total);
            case 32:
                return launch_narrow_tm<32>(device, g, stream, in, dst, L,
                                            m_total);
            default:
                return launch_narrow_tm<64>(device, g, stream, in, dst, L,
                                            m_total);
        }
    }
    const dim3 grid(g.grid_m, g.grid_n);
    switch (g.bn) {
        case 64:
            return launch_ffma_tm<64>(g.tm, device, grid, g.smem, g.ring,
                                      stream, in, dst, L, m_total);
        case 128:
            return launch_ffma_tm<128>(g.tm, device, grid, g.smem, g.ring,
                                       stream, in, dst, L, m_total);
        default:
            return launch_ffma_tm<256>(g.tm, device, grid, g.smem, g.ring,
                                       stream, in, dst, L, m_total);
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

template <int BM>
cudaError_t launch_wide(int device, dim3 grid, int smem, int ring,
                        cudaStream_t stream, const float* in, float* dst,
                        const Layer& L, int m_total) {
    static std::atomic<bool> ready[MAX_DEVICES];
    const cudaError_t err =
        opt_in_smem(sep_mma_wide_kernel<BM>, device, ready);
    if (err != cudaSuccess) return err;
    sep_mma_wide_kernel<BM><<<grid, MT, smem, stream>>>(in, dst, L, m_total,
                                                       ring);
    return cudaGetLastError();
}

// The current device and what the grids are sized by: its SMs, and the
// shared memory of an SM and (opted in) of a block, in bytes
struct Card {
    int device, sms, sm_smem, block_smem;
};

// The launch of one BF16 or HIGH layer: the kernel (wide 0:
// sep_layer_mma_kernel, 1: sep_mma_wide_kernel), its tile (BN output
// channels x BM positions), its grid along M and N, the wide tile's ring
// stages (0 for sep_layer_mma_kernel, whose mode fixes its ring) and the
// dynamic shared memory in bytes.
struct MmaGeometry {
    int wide, bn, bm, grid_m, grid_n, ring, smem;
};

// sep_layer_mma_kernel's tile: BN = min(F, 256); the full tile (warp tiles
// 32 x 32) if it gives at least two blocks per SM, by count and by shared
// memory, else half as many rows (16 x 32).
MmaGeometry small_mma_geometry(int mode, const Layer& L, int m_total,
                               const Card& card) {
    const int bn = L.f < 256 ? L.f : 256;
    const int bm = 32 * (8 / (bn / 32));
    const bool full =
        (long long)((m_total + bm - 1) / bm) * (L.f / bn) >= 2 * card.sms &&
        2 * (mma_smem(mode, bm, bn, L) + 1024) <= card.sm_smem;
    const int rows = full ? bm : bm / 2;
    return MmaGeometry{0, bn, rows, (m_total + rows - 1) / rows, L.f / bn, 0,
                       mma_smem(mode, rows, bn, L)};
}

// sep_mma_wide_kernel's tile at BM rows (BF16): a ring of 3 stages if a
// block's shared memory holds it, else 2; ring 0 where neither fits or F
// is no multiple of its 256 channels.
MmaGeometry wide_mma_geometry(const Layer& L, int m_total, int bm,
                              const Card& card) {
    int ring = wide_smem(bm, 3, L) <= card.block_smem ? 3 : 2;
    if (L.f % WBN || wide_smem(bm, ring, L) > card.block_smem) ring = 0;
    return MmaGeometry{1, WBN, bm, (m_total + bm - 1) / bm, L.f / WBN, ring,
                       wide_smem(bm, ring, L)};
}

// What one position's depthwise and product cost a block, in bytes brought
// in from L2 (mma_cost): fitted to both tiles' device times on layers 5-14
// at B = 32, 64, 209 and 1,667 (tools/mma_tiles.py), where each tile's time
// followed its busiest SM's positions and bytes within 6%
constexpr int POSITION_COST = 640;

// The busiest SM's time on a tensor-core tile, in bytes: its waves,
// ceil(blocks / (SMs x the blocks an SM holds at once)), x the layer's K
// chunks x what a wave's blocks do a chunk on one SM: their positions at
// POSITION_COST each, and the bytes they bring in (the chunk's 32 rows of
// BN bf16 weights, and of f32 input for each row of its window).
long long mma_cost(const MmaGeometry& g, int mode, int m_total,
                   const Layer& L, const Card& card) {
    const int held =
        !g.wide && 2 * (g.smem + 1024) <= card.sm_smem ? 2 : 1;
    const long long blocks = (long long)g.grid_m * g.grid_n;
    const long long waves = (blocks + held * card.sms - 1) / (held * card.sms);
    const int rows = g.bm < m_total ? g.bm : m_total;
    const int window = g.wide ? ffma_window_rows(rows, L)
                              : window_rows(rows, L);
    return waves * (L.c / MK) * held *
           ((long long)rows * POSITION_COST +
            (long long)MK * (2 * g.bn * mma_planes(mode) + 4 * window));
}

// The tile of a BF16 or HIGH layer. HIGH keeps sep_layer_mma_kernel (its
// two accumulators would double the wide tile's registers). In BF16 a
// layer with F a multiple of 256 takes the wide tile at 128 or 64 rows
// where mma_cost prices it below sep_layer_mma_kernel's tile and its
// blocks leave no more than every other SM idle (below that, at B = 1-32,
// the wide tile timed 1.14-1.84x sep_layer_mma_kernel's on every layer
// 5-14). The outputs are the same bits on every tile, so only the time
// depends on the choice.
MmaGeometry mma_geometry(int mode, const Layer& L, int m_total,
                         const Card& card) {
    MmaGeometry best = small_mma_geometry(mode, L, m_total, card);
    if (mode != BF16) return best;
    long long least = mma_cost(best, mode, m_total, L, card);
    for (const int bm : {128, 64}) {
        const MmaGeometry w = wide_mma_geometry(L, m_total, bm, card);
        if (!w.ring || 2LL * w.grid_m * w.grid_n < card.sms) continue;
        const long long cost = mma_cost(w, mode, m_total, L, card);
        if (cost < least) {
            least = cost;
            best = w;
        }
    }
    return best;
}

// One BF16 or HIGH layer at geometry g.
cudaError_t launch_mma_geometry(int mode, int device, const MmaGeometry& g,
                                cudaStream_t stream, const float* in,
                                float* dst, const Layer& L, int m_total) {
    const dim3 grid(g.grid_m, g.grid_n);
    if (g.wide) {
        const dim3 blocks(g.grid_m * g.grid_n);
        return g.bm == 128 ? launch_wide<128>(device, blocks, g.smem, g.ring,
                                              stream, in, dst, L, m_total)
                           : launch_wide<64>(device, blocks, g.smem, g.ring,
                                             stream, in, dst, L, m_total);
    }
    const bool full = g.bm == 32 * (8 / (g.bn / 32));
    switch (g.bn) {
        case 64:
            return full ? launch_mma_mode<64, 2>(mode, device, grid, g.smem,
                                                 stream, in, dst, L, m_total)
                        : launch_mma_mode<64, 1>(mode, device, grid, g.smem,
                                                 stream, in, dst, L, m_total);
        case 128:
            return full ? launch_mma_mode<128, 2>(mode, device, grid, g.smem,
                                                  stream, in, dst, L, m_total)
                        : launch_mma_mode<128, 1>(mode, device, grid, g.smem,
                                                  stream, in, dst, L, m_total);
        default:
            return full ? launch_mma_mode<256, 2>(mode, device, grid, g.smem,
                                                  stream, in, dst, L, m_total)
                        : launch_mma_mode<256, 1>(mode, device, grid, g.smem,
                                                  stream, in, dst, L, m_total);
    }
}

Card current_card() {
    Card c{};
    cudaGetDevice(&c.device);
    cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, c.device);
    cudaDeviceGetAttribute(&c.sm_smem,
                           cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                           c.device);
    cudaDeviceGetAttribute(&c.block_smem,
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, c.device);
    return c;
}

// A layer's shape from its host descriptor (DIMS ints), no operands
Layer layer_of(const int* d) {
    Layer L{};
    L.h = d[0]; L.w = d[1]; L.c = d[2]; L.f = d[3]; L.stride = d[4];
    L.ho = d[5]; L.wo = d[6]; L.off_h = d[7]; L.off_w = d[8];
    return L;
}

// Runs the layers in order: layer i reads the previous layer's output from
// one scratch buffer and writes the other; the last layer writes `out`
// directly, or (with gap) a scratch buffer that gap_kernel reduces to `out`.
int run_stack(const float* x, float* out, float* buf0, float* buf1, int batch,
              int n_layers, const int64_t* ptrs, const int* dims, int gap,
              int mode, cudaStream_t stream, int* wide) {
    if (wide) *wide = 0;
    if (batch <= 0 || n_layers <= 0 || mode < HIGHEST || mode > HIGH)
        return (int)cudaErrorInvalidValue;
    const Card card = current_card();
    const float* in = x;
    float* bufs[2] = {buf0, buf1};
    Layer L{};
    for (int i = 0; i < n_layers; ++i) {
        L = layer_of(dims + DIMS * i);
        L.dw = reinterpret_cast<const float*>(ptrs[4 * i + 0]);
        L.dw_b = reinterpret_cast<const float*>(ptrs[4 * i + 1]);
        L.pw = reinterpret_cast<const void*>(ptrs[4 * i + 2]);
        L.pw_b = reinterpret_cast<const float*>(ptrs[4 * i + 3]);
        if (!takes(mode, L)) return (int)cudaErrorInvalidValue;
        const bool last = i == n_layers - 1;
        float* dst = (last && !gap) ? out : bufs[i % 2];
        const int m_total = batch * L.ho * L.wo;
        cudaError_t err;
        if (mode == HIGHEST) {
            err = launch_geometry(card.device,
                                  ffma_geometry(L, m_total, card.sms,
                                                card.sm_smem, card.block_smem),
                                  stream, in, dst, L, m_total);
        } else {
            const MmaGeometry g = mma_geometry(mode, L, m_total, card);
            err = launch_mma_geometry(mode, card.device, g, stream, in, dst, L,
                                      m_total);
            if (wide && err == cudaSuccess) *wide += g.wide;
        }
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
// Into `wide`, unless null, the number of layers it launched on
// sep_mma_wide_kernel. `wide` comes after the stream, so a caller that
// passes it to an older build, which lacks it, loses nothing but the count.
int bz_sep_stack(const float* x, float* out, float* buf0, float* buf1,
                 int batch, int n_layers, const int64_t* ptrs,
                 const int* dims, int gap, int mode, void* stream, int* wide) {
    return run_stack(x, out, buf0, buf1, batch, n_layers, ptrs, dims, gap,
                     mode, static_cast<cudaStream_t>(stream), wide);
}

// The exact-f32 route's launch of each of n_layers layers (dims as
// bz_sep_stack's) at `batch` on a card of `sms` SMs, `sm_smem` bytes of
// shared memory per SM and `block_smem` per block: 8 ints a layer into
// `out`, ffma_geometry's Geometry (narrow, BN, TM, BM, grid along M and N,
// ring stages, shared memory bytes). A host function: it launches nothing.
int bz_sep_geometry(int batch, int n_layers, const int* dims, int sms,
                    int sm_smem, int block_smem, int* out) {
    if (batch <= 0 || n_layers <= 0 || sms <= 0)
        return (int)cudaErrorInvalidValue;
    for (int i = 0; i < n_layers; ++i) {
        const Layer L = layer_of(dims + DIMS * i);
        if (!takes(HIGHEST, L)) return (int)cudaErrorInvalidValue;
        const Geometry g = ffma_geometry(L, batch * L.ho * L.wo, sms, sm_smem,
                                         block_smem);
        const int v[8] = {g.narrow, g.bn,     g.tm,   g.bm,
                          g.grid_m, g.grid_n, g.ring, g.smem};
        for (int k = 0; k < 8; ++k) out[8 * i + k] = v[k];
    }
    return 0;
}

// One exact-f32 layer (its descriptor and 4 operand pointers as one layer
// of bz_sep_stack's) at a tile the caller names: the wide tile (narrow 0)
// at TM = 5 or 4, or 0 for the rule's TM; or the narrow BN x TM (8, 16,
// 32, 64 x 1, 2, 4). For tools/ffma_geometries.py, which times every tile;
// the wrappers launch through bz_sep_stack only. A tile that does not fit
// returns -1.
int bz_sep_layer_at(const float* x, float* y, int batch, const int64_t* ptrs,
                    const int* dims, int narrow, int bn, int tm,
                    void* stream) {
    Layer L = layer_of(dims);
    L.dw = reinterpret_cast<const float*>(ptrs[0]);
    L.dw_b = reinterpret_cast<const float*>(ptrs[1]);
    L.pw = reinterpret_cast<const void*>(ptrs[2]);
    L.pw_b = reinterpret_cast<const float*>(ptrs[3]);
    const bool tile = narrow ? (bn == 8 || bn == 16 || bn == 32 || bn == 64) &&
                                   (tm == 1 || tm == 2 || tm == 4)
                             : tm == 0 || tm == 5 || tm == 4;
    if (batch <= 0 || !takes(HIGHEST, L) || !tile)
        return (int)cudaErrorInvalidValue;
    const Card card = current_card();
    const int m_total = batch * L.ho * L.wo;
    const Geometry g =
        narrow ? narrow_geometry(L, m_total, bn, tm, card.block_smem)
               : wide_geometry(L, m_total, card.sms, card.sm_smem, tm);
    if (!g.ring || g.smem > card.block_smem) return -1;
    return (int)launch_geometry(card.device, g,
                                static_cast<cudaStream_t>(stream), x, y, L,
                                m_total);
}

// One BF16 or HIGH layer (its descriptor and 4 operand pointers as one
// layer of bz_sep_stack's) at a tile the caller names: `tile` -1 for the
// rule's, 0 for sep_layer_mma_kernel's, 128 or 64 for the wide tile at
// that many rows (BF16 and F a multiple of 256 only), the tile it launched
// into `launched` as `tile` names it. For the tools and tests that time and
// compare the tiles; the wrappers launch through bz_sep_stack only. A tile
// that does not fit or take the layer returns -1.
int bz_mma_layer_at(const float* x, float* y, int batch, const int64_t* ptrs,
                    const int* dims, int mode, int tile, int* launched,
                    void* stream) {
    Layer L = layer_of(dims);
    L.dw = reinterpret_cast<const float*>(ptrs[0]);
    L.dw_b = reinterpret_cast<const float*>(ptrs[1]);
    L.pw = reinterpret_cast<const void*>(ptrs[2]);
    L.pw_b = reinterpret_cast<const float*>(ptrs[3]);
    if (batch <= 0 || (mode != BF16 && mode != HIGH) || !takes(mode, L) ||
        (tile != -1 && tile != 0 && tile != 128 && tile != 64))
        return (int)cudaErrorInvalidValue;
    const Card card = current_card();
    const int m_total = batch * L.ho * L.wo;
    MmaGeometry g = tile == -1 ? mma_geometry(mode, L, m_total, card)
                               : small_mma_geometry(mode, L, m_total, card);
    if (tile > 0) {
        if (mode != BF16) return -1;
        g = wide_mma_geometry(L, m_total, tile, card);
        if (!g.ring) return -1;
    }
    *launched = g.wide ? g.bm : 0;
    return (int)launch_mma_geometry(mode, card.device, g,
                                    static_cast<cudaStream_t>(stream), x, y,
                                    L, m_total);
}

// The current device's SMs, shared memory per SM and per block (opted
// in), as bz_sep_stack sizes its grids by them: 3 ints into `out`.
int bz_sep_card(int* out) {
    const Card c = current_card();
    out[0] = c.sms;
    out[1] = c.sm_smem;
    out[2] = c.block_smem;
    return (int)cudaGetLastError();
}

const char* bz_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
