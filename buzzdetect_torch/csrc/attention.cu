// Fused softmax attention, non-causal, head dimension 64: the Audio
// Spectrogram Transformer's (models/ast.py) QK^T, softmax and PV in one
// launch, with no S or P in device memory.
//
// It replaces no TPU kernel: the JAX package runs YAMNet alone and has no
// attention. It was added because attention is 21% of an AST window's
// work (54.3 of 261 GFLOP: 12 blocks of 12 heads, 1,214 tokens, head 64)
// and a product per head through the library would write the (1,214 x
// 1,214) scores and probabilities of every head to device memory and read
// them back, 12 times a window.
//
// Input: the qkv product's output as it is, (batch, n, 3 C) row-major with
// C = heads x 64: q of head h at columns h*64.., k at C + h*64.., v at
// 2C + h*64.. (timm's reshape(B, N, 3, H, D)). Output (batch, n, C), head h
// at columns h*64.. (attn.transpose(1, 2).reshape(B, N, C)): the permutes
// are the kernel's addressing, never a copy.
//
// Bound on an H100 SXM (ops/attention.attention_bound_s; benchmark/
// roofline_ast.py counts the same): a 128-window chunk is 6.95 TFLOP of
// QK^T and PV (4 n^2 d per head), 7.0 ms at the 989 TFLOP/s bf16 peak,
// against 11.5 GB of q, k, v and o (3.4 ms at 3.35 TB/s): compute-bound.
//
// bf16 (attention_bf16_kernel), flash-attention's schedule with mma.sync
// on the tensor cores: a block of 4 warps owns 64 query rows (16 a warp)
// of one head of one window and walks the keys in tiles of 64. The q tile
// and a two-stage ring of k and v tiles sit in shared memory (cp.async,
// 16-byte chunks swizzled by row so that ldmatrix reads conflict-free);
// each warp holds its q fragments in registers, computes S = q k^T (32
// m16n8k16 products a tile), masks the keys past n (the last tile: 1,214
// = 18 x 64 + 62), keeps a running row maximum m and row sum l in f32 and
// rescales its f32 output accumulators by exp(m_old - m_new); P =
// exp(S/8 - m) in f32, rounded to bf16 in registers as the A operand of PV
// (the accumulator layout of two n-tiles is the A layout of one k-step),
// v read through ldmatrix.trans. At the end O / l, rounded to bf16. The
// softmax and the sums are f32; the products take bf16 operands and
// accumulate in f32. l sums the f32 probabilities; the reference
// (benchmark/reference/ast.py, 'bf16') rounds the normalised P, so the two
// differ by where P is rounded, at bf16's relative 2^-9.
//
// f32 (attention_f32_kernel), exact f32 on the FFMA pipes: a thread owns
// one query row (q and o in registers), the block stages 32 keys of k and
// v in shared memory (every thread reads the same key: a broadcast),
// computes the 32 scores as fmaf chains over d ascending, and runs the
// same online softmax with expf. No tensor cores, no TF32.
//
// BEATs (models/beats.py; bz_attention_relpos) adds to each score a gated
// relative-position bias: s_ij = q_i k_j * scale + g_ih bias_h[j - i].
// bias_h is one f32 row a head of 2n - 1 values (d = j - i from -(n - 1),
// built once on the host from the shared bucketed table, so no bucket is
// computed here); the gate g_ih = u0 (u1 a_h - 1) + 2, (u0, u1) =
// sigmoid(G q_i + c), is the layer's (G: 2 x 64, c: 2, a: heads; f32) and
// reads the query row as the kernel holds it (bf16 under bf16). Both
// kernels take it as a template parameter, RELPOS: with it the bf16 kernel
// computes each warp's 16 gates from the q tile in shared memory (two
// lanes a row, a shuffle), adds g bias from the L1-cached row to S in f32
// before the online softmax (the scale folded in there, so the softmax
// runs in units of log2 e), and the f32 kernel computes its row's gate
// from q in registers; without it both compile to the code they had, the
// Audio Spectrogram Transformer's. The bias row and the gate add 4 (2n -
// 1) bytes a head and 2 x 2 x 64 flops a row and head to the work above.
//
// Plain C interface, loaded with ctypes; returns a cudaError_t code
// (0 = success) and launches on the given stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int D = 64;        // head dimension
constexpr int BM = 64;       // query rows a block (bf16)
constexpr int BN = 64;       // keys a tile (bf16)
constexpr int NT = 128;      // threads a block (bf16): 4 warps
constexpr int TILE = BM * D / 8;   // 16-byte chunks of a 64 x 64 bf16 tile
constexpr int F_BM = 128;    // query rows a block (f32): one a thread
constexpr int F_BN = 32;     // keys a tile (f32)
constexpr float LOG2E = 1.4426950408889634f;

// chunk c (8 bf16 of a row) of row r of a 64 x 64 tile, swizzled so that
// the 8 rows an ldmatrix phase reads lie in 8 different bank quads
__device__ __forceinline__ int swz(int r, int c) { return r * 8 + (c ^ (r & 7)); }

// rows row0 .. row0 + 63 of one head's q, k or v (src: row 0 of it, rows
// ld elements apart) into a swizzled tile; rows at or past n read as zero
__device__ __forceinline__ void load_tile(uint4* dst,
                                          const __nv_bfloat16* src,
                                          long long ld, int row0, int n,
                                          int tid) {
#pragma unroll
    for (int i = 0; i < TILE / NT; ++i) {
        const int idx = tid + i * NT;
        const int r = idx >> 3, c = idx & 7;
        const bool ok = row0 + r < n;
        cp_async16(dst + swz(r, c),
                   src + (long long)(ok ? row0 + r : 0) * ld + c * 8, ok);
    }
}

__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the gate of query row q (d values of head h, f32) under gate = G (2 x
// 64) | c (2) | a (heads): u0 (u1 a_h - 1) + 2, (u0, u1) = sigmoid(G q + c)
__device__ __forceinline__ float gate_of(float dot0, float dot1,
                                         const float* __restrict__ gate,
                                         int h) {
    const float u0 = 1.f / (1.f + expf(-(dot0 + __ldg(gate + 2 * D))));
    const float u1 = 1.f / (1.f + expf(-(dot1 + __ldg(gate + 2 * D + 1))));
    return fmaf(u0, fmaf(u1, __ldg(gate + 2 * D + 2 + h), -1.f), 2.f);
}

// grid (query tiles, heads, batch); scale_log2 = scale * log2(e), or with
// RELPOS the scale itself; with RELPOS, rel: (heads, 2n - 1) f32 bias
// rows, gate: G | c | a as above
template <bool RELPOS>
__global__ void __launch_bounds__(NT)
attention_bf16_kernel(const __nv_bfloat16* __restrict__ qkv,
                      __nv_bfloat16* __restrict__ out, const int n,
                      const int heads, const float scale_log2,
                      const float* __restrict__ rel,
                      const float* __restrict__ gate) {
    __shared__ uint4 sm[5 * TILE];                // q | k x 2 | v x 2
    uint4* const Qs = sm;
    uint4* const Ks = sm + TILE;
    uint4* const Vs = sm + 3 * TILE;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int q0 = blockIdx.x * BM, h = blockIdx.y;
    const int C = heads * D;
    const long long ld = 3LL * C;
    const __nv_bfloat16* const base =
        qkv + (long long)blockIdx.z * n * ld + h * D;
    const __nv_bfloat16* const kp = base + C;
    const __nv_bfloat16* const vp = base + 2 * C;
    const int tiles = (n + BN - 1) / BN;

    load_tile(Qs, base, ld, q0, n, tid);
    load_tile(Ks, kp, ld, 0, n, tid);
    load_tile(Vs, vp, ld, 0, n, tid);
    cp_async_commit();

    uint32_t qf[4][4];
    float o[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    // rows g = lane / 4 (m0, l0) and g + 8 (m1, l1) of the warp's 16
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    // RELPOS: the two rows' gates and bias rows (at d = 0 for key 0), and
    // the softmax's factor once the scale is in S
    float g0 = 0.f, g1 = 0.f;
    const float* rel0 = nullptr;
    const float* rel1 = nullptr;
    const float sl2 = RELPOS ? LOG2E : scale_log2;
    if constexpr (RELPOS) {
        const int i0 = min(q0 + 16 * warp + (lane >> 2), n - 1);
        const int i1 = min(q0 + 16 * warp + (lane >> 2) + 8, n - 1);
        const float* const relh = rel + (long long)h * (2 * n - 1) + n - 1;
        rel0 = relh - i0, rel1 = relh - i1;
    }

#pragma unroll 1
    for (int t = 0; t < tiles; ++t) {
        const int s = t & 1;
        if (t + 1 < tiles) {
            load_tile(Ks + (s ^ 1) * TILE, kp, ld, (t + 1) * BN, n, tid);
            load_tile(Vs + (s ^ 1) * TILE, vp, ld, (t + 1) * BN, n, tid);
        }
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();  // tile t (and at t = 0 the q tile) is in
        if (t == 0) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                ldmatrix_x4(qf[kk], Qs + swz(16 * warp + (lane & 15),
                                             2 * kk + (lane >> 4)));
            if constexpr (RELPOS) {
                // lanes 2r and 2r + 1 take row r of the warp's 16, half of
                // d each
                const int r = 16 * warp + (lane >> 1), half = lane & 1;
                float dot0 = 0.f, dot1 = 0.f;
#pragma unroll
                for (int c = 4 * half; c < 4 * half + 4; ++c) {
                    const uint4 v = Qs[swz(r, c)];
                    const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const float2 qq = __bfloat1622float2(
                            *reinterpret_cast<const __nv_bfloat162*>(&w4[e]));
                        const int d = 8 * c + 2 * e;
                        dot0 = fmaf(qq.x, __ldg(gate + d), dot0);
                        dot0 = fmaf(qq.y, __ldg(gate + d + 1), dot0);
                        dot1 = fmaf(qq.x, __ldg(gate + D + d), dot1);
                        dot1 = fmaf(qq.y, __ldg(gate + D + d + 1), dot1);
                    }
                }
                dot0 += __shfl_xor_sync(0xffffffffu, dot0, 1);
                dot1 += __shfl_xor_sync(0xffffffffu, dot1, 1);
                const float g = gate_of(dot0, dot1, gate, h);
                g0 = __shfl_sync(0xffffffffu, g, 2 * (lane >> 2));
                g1 = __shfl_sync(0xffffffffu, g, 2 * (lane >> 2) + 16);
            }
        }
        const uint4* const K = Ks + s * TILE;
        const uint4* const V = Vs + s * TILE;

        // S = q k^T: n-tiles of 8 keys, k-steps of 16 of d
        float sc[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
                uint32_t kb[4];
                ldmatrix_x4(kb, K + swz(16 * jj + (lane & 7) +
                                            ((lane >> 4) << 3),
                                        2 * kk + ((lane >> 3) & 1)));
                mma_bf16(sc[2 * jj], qf[kk], kb);
                mma_bf16(sc[2 * jj + 1], qf[kk], kb + 2);
            }
        const int key0 = t * BN;
        if constexpr (RELPOS) {  // S scale + g bias[j - i], keys below n
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int key = key0 + 8 * j + 2 * (lane & 3) + (e & 1);
                    if (key < n)
                        sc[j][e] = fmaf(
                            sc[j][e], scale_log2,
                            (e < 2 ? g0 : g1) *
                                __ldg((e < 2 ? rel0 : rel1) + key));
                }
        }
        if (key0 + BN > n) {  // the tail: keys past n take no weight
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (key0 + 8 * j + 2 * (lane & 3) + (e & 1) >= n)
                        sc[j][e] = -INFINITY;
        }

        // the online softmax, in units of S (the scale is positive)
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
            mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
        }
        mx0 = quad_max(mx0);
        mx1 = quad_max(mx1);
        const float a0 = exp2f((m0 - mx0) * sl2);   // 0 at t = 0
        const float a1 = exp2f((m1 - mx1) * sl2);
        m0 = mx0, m1 = mx1;
        const float mb0 = mx0 * sl2, mb1 = mx1 * sl2;
        float rs0 = 0.f, rs1 = 0.f;
        uint32_t pf[4][4];  // P as the A operand of PV, k-step kk
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const float p0 = exp2f(fmaf(sc[j][0], sl2, -mb0));
            const float p1 = exp2f(fmaf(sc[j][1], sl2, -mb0));
            const float p2 = exp2f(fmaf(sc[j][2], sl2, -mb1));
            const float p3 = exp2f(fmaf(sc[j][3], sl2, -mb1));
            rs0 += p0 + p1;
            rs1 += p2 + p3;
            pf[j >> 1][(j & 1) * 2] = bits(__floats2bfloat162_rn(p0, p1));
            pf[j >> 1][(j & 1) * 2 + 1] = bits(__floats2bfloat162_rn(p2, p3));
        }
        l0 = fmaf(l0, a0, rs0);
        l1 = fmaf(l1, a1, rs1);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            o[j][0] *= a0, o[j][1] *= a0;
            o[j][2] *= a1, o[j][3] *= a1;
        }
        // O += P v: k-steps of 16 keys, n-tiles of 8 of d
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
                uint32_t vb[4];
                ldmatrix_x4_trans(vb, V + swz(16 * kk + (lane & 7) +
                                                  (((lane >> 3) & 1) << 3),
                                              2 * jj + (lane >> 4)));
                mma_bf16(o[2 * jj], pf[kk], vb);
                mma_bf16(o[2 * jj + 1], pf[kk], vb + 2);
            }
        __syncthreads();  // stage s is read out before it is refilled
    }

    const float i0 = 1.f / quad_sum(l0), i1 = 1.f / quad_sum(l1);
    const int r0 = q0 + 16 * warp + (lane >> 2), r1 = r0 + 8;
    __nv_bfloat16* const op =
        out + (long long)blockIdx.z * n * C + h * D + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        if (r0 < n)
            *reinterpret_cast<__nv_bfloat162*>(op + (long long)r0 * C + 8 * j) =
                __floats2bfloat162_rn(o[j][0] * i0, o[j][1] * i0);
        if (r1 < n)
            *reinterpret_cast<__nv_bfloat162*>(op + (long long)r1 * C + 8 * j) =
                __floats2bfloat162_rn(o[j][2] * i1, o[j][3] * i1);
    }
}

// grid (query tiles of F_BM, heads, batch); rel and gate as above
template <bool RELPOS>
__global__ void __launch_bounds__(F_BM)
attention_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                     const int n, const int heads, const float scale,
                     const float* __restrict__ rel,
                     const float* __restrict__ gate) {
    __shared__ __align__(16) float Ks[F_BN][D];
    __shared__ __align__(16) float Vs[F_BN][D];
    const int tid = threadIdx.x, h = blockIdx.y;
    const int row = blockIdx.x * F_BM + tid;
    const int C = heads * D;
    const long long ld = 3LL * C;
    const float* const base = qkv + (long long)blockIdx.z * n * ld + h * D;
    float q[D], o[D];
#pragma unroll
    for (int d = 0; d < D; d += 4) {
        const float4 v = row < n ? __ldg(reinterpret_cast<const float4*>(
                                       base + (long long)row * ld + d))
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        q[d] = v.x, q[d + 1] = v.y, q[d + 2] = v.z, q[d + 3] = v.w;
        o[d] = o[d + 1] = o[d + 2] = o[d + 3] = 0.f;
    }
    float m = -INFINITY, l = 0.f;
    float g = 0.f;
    const float* relr = nullptr;
    if constexpr (RELPOS) {
        float dot0 = 0.f, dot1 = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
            dot0 = fmaf(q[d], __ldg(gate + d), dot0);
            dot1 = fmaf(q[d], __ldg(gate + D + d), dot1);
        }
        g = gate_of(dot0, dot1, gate, h);
        relr = rel + (long long)h * (2 * n - 1) + n - 1 - min(row, n - 1);
    }
#pragma unroll 1
    for (int k0 = 0; k0 < n; k0 += F_BN) {
        __syncthreads();  // the last tile is read out
        for (int i = tid; i < F_BN * D / 4; i += F_BM) {
            const int r = i / (D / 4), c = 4 * (i % (D / 4));
            const bool ok = k0 + r < n;
            const long long at = (long long)(ok ? k0 + r : 0) * ld + c;
            const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
            *reinterpret_cast<float4*>(&Ks[r][c]) =
                ok ? __ldg(reinterpret_cast<const float4*>(base + C + at)) : z;
            *reinterpret_cast<float4*>(&Vs[r][c]) =
                ok ? __ldg(reinterpret_cast<const float4*>(base + 2 * C + at))
                   : z;
        }
        __syncthreads();
        float s[F_BN];
        float mx = m;
#pragma unroll
        for (int k = 0; k < F_BN; ++k) {
            float acc = 0.f;
#pragma unroll
            for (int d = 0; d < D; ++d) acc = fmaf(q[d], Ks[k][d], acc);
            if constexpr (RELPOS)
                s[k] = k0 + k < n
                           ? __fadd_rn(__fmul_rn(acc, scale),
                                       __fmul_rn(g, __ldg(relr + k0 + k)))
                           : -INFINITY;
            else
                s[k] = k0 + k < n ? __fmul_rn(acc, scale) : -INFINITY;
            mx = fmaxf(mx, s[k]);
        }
        const float a = expf(__fsub_rn(m, mx));   // 0 at the first tile
        m = mx;
        l = __fmul_rn(l, a);
#pragma unroll
        for (int d = 0; d < D; ++d) o[d] = __fmul_rn(o[d], a);
#pragma unroll
        for (int k = 0; k < F_BN; ++k) {
            const float p = expf(__fsub_rn(s[k], mx));
            l = __fadd_rn(l, p);
#pragma unroll
            for (int d = 0; d < D; ++d) o[d] = fmaf(p, Vs[k][d], o[d]);
        }
    }
    if (row < n) {
        float* const op = out + ((long long)blockIdx.z * n + row) * C + h * D;
#pragma unroll
        for (int d = 0; d < D; d += 4)
            *reinterpret_cast<float4*>(op + d) =
                make_float4(__fdiv_rn(o[d], l), __fdiv_rn(o[d + 1], l),
                            __fdiv_rn(o[d + 2], l), __fdiv_rn(o[d + 3], l));
    }
}

template <bool RELPOS>
int launch(const void* qkv, void* out, int dtype, int batch, int n,
           int heads, int head_dim, float scale, const float* rel,
           const float* gate, void* stream) {
    if (head_dim != D || batch <= 0 || batch > 65535 || n <= 0 ||
        heads <= 0 || heads > 65535 || (dtype != 0 && dtype != 1) ||
        reinterpret_cast<uintptr_t>(qkv) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
        (RELPOS && (rel == nullptr || gate == nullptr)))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 1) {
        const dim3 grid((unsigned)((n + BM - 1) / BM), (unsigned)heads,
                        (unsigned)batch);
        attention_bf16_kernel<RELPOS><<<grid, NT, 0, s>>>(
            static_cast<const __nv_bfloat16*>(qkv),
            static_cast<__nv_bfloat16*>(out), n, heads,
            RELPOS ? scale : scale * LOG2E, rel, gate);
    } else {
        const dim3 grid((unsigned)((n + F_BM - 1) / F_BM), (unsigned)heads,
                        (unsigned)batch);
        attention_f32_kernel<RELPOS><<<grid, F_BM, 0, s>>>(
            static_cast<const float*>(qkv), static_cast<float*>(out), n,
            heads, scale, rel, gate);
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// (batch, n, 3 heads 64) -> (batch, n, heads 64), dtype 0: f32 (exact
// f32), 1: bf16 (tensor cores, f32 softmax and sums); head_dim must be 64,
// the rows 16-byte aligned. scale multiplies q k^T.
int bz_attention(const void* qkv, void* out, int dtype, int batch, int n,
                 int heads, int head_dim, float scale, void* stream) {
    return launch<false>(qkv, out, dtype, batch, n, heads, head_dim, scale,
                         nullptr, nullptr, stream);
}

// As bz_attention, each score plus g_ih bias_h[j - i]: rel (heads, 2n - 1)
// f32, d = j - i at column d + n - 1; gate G (2 x 64) | c (2) | a (heads)
// f32 (see the note at the top).
int bz_attention_relpos(const void* qkv, void* out, int dtype, int batch,
                        int n, int heads, int head_dim, float scale,
                        const float* rel, const float* gate, void* stream) {
    return launch<true>(qkv, out, dtype, batch, n, heads, head_dim, scale,
                        rel, gate, stream);
}

const char* bz_attention_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
