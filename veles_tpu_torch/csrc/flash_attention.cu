// Flash attention for training on Hopper (sm_90a): the forward and the two
// backward passes behind mha_forward under set_attention_backend('flash_pallas').
//
// They replace jax's bundled TPU Pallas flash attention, which
// veles_tpu/ops/attention.py:176 (flash_attention_tpu) calls at :190
// (jax/experimental/pallas/ops/tpu/flash_attention.py):
//
//   flash_fwd_kernel      the forward, _flash_attention_impl (pallas_call :758):
//                         o and the row residual
//   flash_bwd_dkv_kernel  _flash_attention_bwd_dkv (:941, pallas_call :1121)
//   flash_bwd_dq_kernel   _flash_attention_bwd_dq (:1287, pallas_call :1456)
//
// Operands are (BH, S, D) row-major fp32: q (BH, Sq, D), k and v (BH, Sk, D),
// o and do (BH, Sq, D), the residuals lse and di (BH, Sq).  For query row r
// and key c:
//
//   s_rc  = (q_r . k_c) * scale              (a multiply, as the bundled kernel)
//   live  = c < Sk  and  (not causal  or  c <= r)   (the bundled causal rule)
//   lse_r = log sum_{live c} exp(s_rc),  o_r = sum_{live c} exp(s_rc - lse_r) v_c
//   P = exp(s - lse),  dP = do v^T,  di_r = sum_d o_rd do_rd,  dS = P (dP - di)
//   dv = P^T do,  dk = scale dS^T q,  dq = scale dS k
//
// The bundled kernel keeps the softmax state as separate l and m; one fp32
// log-sum-exp per row carries the same information into the backward.  Masked
// keys are excluded outright (s = -inf, p = 0) and the running max starts at
// -inf, so no finite mask value can leak mass into a row.  di is formed once
// per backward by the caller, as the bundled _flash_attention_bwd does in XLA
// (flash_attention.py:273) before either pallas_call, and read by both passes.
//
// Bound on the H100: operations.  At the training shape (32 x 8 heads, S 512,
// D 64, causal) the forward does two causal products of S^2 D per head
// (8.6 GFLOP), dK/dV four (17.2 GFLOP: S and dP recomputed, dV, dK) and dQ
// three (12.9 GFLOP), against 134 / 202 / 169 MB of operands (0.04-0.06 ms at
// 3.35 TB/s).  fp32 accuracy on the tensor cores costs three TF32 products per
// product (below): 0.052 / 0.104 / 0.078 ms at the dense 495 TFLOP/s TF32
// rate, against 0.128 / 0.257 / 0.193 ms as fp32 FMA on the CUDA cores.
//
// Forward (fp32 FMA on the CUDA cores, simple and exact before fast):
// - a block of 256 threads owns one 64-row query tile and walks the key tiles
//   in ascending order inside the block (the TPU grid's sequential axis
//   become a loop), skipping tiles wholly above the diagonal (the bundled
//   kernel's below_or_on_diag); blocks are issued longest-first.
// - tiles are staged in shared memory as 64 x 65 floats (the odd stride keeps
//   its access patterns free of bank conflicts); each thread holds a 4 x 4
//   strided piece of the score and accumulator tiles in registers.
//
// Backward (the two passes on the tensor cores):
// - products are mma.sync m16n8k8 in 3xTF32: each fp32 operand x splits into
//   big = tf32(x) and small = tf32(x - big) (rounded to nearest by integer
//   arithmetic: cvt issues at a quarter of its rate and was the first
//   limit); each 16-deep partial sum takes small.big + big.small, then
//   big.big, from zero in the tensor cores and is added to the running sum
//   as an fp32 add.  This is CUTLASS's fast-fp32 scheme, the one PyTorch's fp32
//   memory-efficient attention runs; the tensor cores sum with truncation,
//   so chaining every step through their accumulator lost ~5x the fp32
//   plain version's accuracy on the card, while this keeps it.  One TF32
//   product alone keeps ~3 decimal digits and would change the result.
//   wgmma is not used: in TF32 it takes B only K-major from shared memory,
//   and three of the five products (dv += P^T do, dk += dS^T q, dq += dS k)
//   have B the other way.
// - a block of 8 warps owns 64 rows: keys in dK/dV (S^T = k q^T and dP^T =
//   v do^T, FlashAttention-2's layout), query rows in dQ (S = q k^T, dP =
//   do v^T).  Each warp forms a 32 x 16 piece of S and dP, turns it into P
//   and dS, and hands them to the block through shared memory; then it
//   accumulates a 32 x 16 piece of the output.  Every A operand sits in
//   shared memory fragment-native and already split (one float4 a lane and
//   half): the block's resident k and v (dK/dV) or q and do (dQ), split
//   once, and P and dS as the warps' accumulator fragments stand, the next
//   product taking the k order (0,2,4,6,1,3,5,7) within each 8-wide step in
//   both operands.  B operands are read from the staged tiles and split on
//   the fly.  Pieces wholly above the causal diagonal or past an end skip
//   their products.  64 accumulators a thread; each B fragment split feeds
//   two row blocks (4 warps with 16 x 64 pieces needed 255 registers and
//   spilled).
// - tiles are staged by cp.async: 16-byte copies (4-byte where D % 4 != 0 or
//   an operand is not 16-byte aligned, in the same kernel), into rows of 68
//   floats.  Every fragment read is free of bank conflicts at that stride:
//   row g, columns t and t+4 (banks 4g + t) and rows 2t, 2t+1, column g
//   (8t + g).
// - D <= 64 (the training shape) keeps the block's own operands resident and
//   double-buffers the walked side: dK/dV fetches the next query tile's q,
//   do, lse and di, dQ the next key tile's k and v, while the current one is
//   in the tensor cores.  Larger D contracts in 64-wide chunks staged in turn,
//   each block accumulating one 64-wide chunk of its output (grid.z), so any D
//   runs with fixed registers and shared memory.
// - occupancy: one block of 8 warps an SM (199 KB of shared memory for
//   dK/dV, 166 KB for dQ), with the double buffer hiding the copies.  What
//   bounds it on the card: tools/flash_bwd_profile.py (mma.sync reaches 64%
//   of the TF32 rate; the warps issue ~20 other instructions per product,
//   most of them splitting B operands).
// - two passes with no atomics, as the reference's: dK/dV owns key tiles and
//   walks query tiles, dQ owns query tiles and walks key tiles, both
//   recomputing P from the row residual, so dq, dk and dv repeat bit for bit
//   from run to run.  Causal tiles wholly above the diagonal are skipped.
// - rows, keys and head columns past the ends are zero-filled on staging and
//   masked, so any S and D are taken; the ragged tail is never refused.
//
// Plain C interface (loaded with ctypes): each entry point launches on the
// given stream and returns cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // forward block
constexpr int kT = 64;              // tile rows = tile keys = D chunk
constexpr int kLd = kT + 1;         // padded row stride of a forward tile
constexpr int kTile = kT * kLd;     // floats in one forward tile
constexpr int kBwdThreads = 256;    // backward block: 8 warps, each
constexpr int kWM = 2;              //   owning 2 16-row blocks
constexpr int kWN = 2;              //   x 2 8-wide column blocks of a tile
constexpr int kBLd = kT + 4;        // row stride of a backward tile (16 B rows)
constexpr int kBTile = kT * kBLd;   // floats in one backward tile
constexpr int kN8 = kT / 8;         // 8-wide column blocks of a tile
constexpr size_t kMaxSmem = 227 * 1024;

// Rows [row0, row0 + 64) x columns [col0, col0 + 64) of a (rows, dh)
// row-major matrix into a shared tile; zero outside the matrix.
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int rows, int col0,
                                          int dh) {
    for (int idx = threadIdx.x; idx < kT * kT; idx += kThreads) {
        const int r = idx >> 6, c = idx & (kT - 1);
        const int gr = row0 + r, gc = col0 + c;
        dst[r * kLd + c] =
            (gr < rows && gc < dh) ? __ldg(src + (int64_t)gr * dh + gc) : 0.f;
    }
}

// acc[i][j] += sum_d a[ty + 16i][d] * b[tx + 16j][d]        (a b^T)
__device__ __forceinline__ void mma_nt(float acc[4][4], const float* a,
                                       const float* b, int ty, int tx) {
#pragma unroll 8
    for (int d = 0; d < kT; ++d) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            av[i] = a[(ty + 16 * i) * kLd + d];
            bv[i] = b[(tx + 16 * i) * kLd + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
}

// acc[i][j] += sum_k a[ty + 16i][k] * b[k][tx + 16j]        (a b)
__device__ __forceinline__ void mma_nn(float acc[4][4], const float* a,
                                       const float* b, int ty, int tx) {
#pragma unroll 8
    for (int k = 0; k < kT; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            av[i] = a[(ty + 16 * i) * kLd + k];
            bv[i] = b[k * kLd + tx + 16 * i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
}

// Reduce over the 16 lanes that share a row (a half warp: tx = lane & 15).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
    return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

// The block's (head, tile) from blockIdx.x = tile * bh + head: every
// head's tile t is issued before any head's tile t + 1.  With reverse, the
// last tile (the longest causal walk for a query tile) comes first.
__device__ __forceinline__ void block_coords(int bh, int tiles, bool reverse,
                                             int* head, int* tile) {
    const int t = blockIdx.x / bh;
    *head = blockIdx.x - t * bh;
    *tile = reverse ? tiles - 1 - t : t;
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int bh, int sq, int sk, int dh,
                 int causal, float scale) {
    extern __shared__ float smem[];
    float* qs = smem;
    float* ks = qs + kTile;
    float* vs = ks + kTile;
    float* ps = vs + kTile;
    const int tiles = (sq + kT - 1) / kT;
    int head, qt;
    block_coords(bh, tiles, causal != 0, &head, &qt);
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
    const int q0 = qt * kT, c0 = blockIdx.z * kT;
    const float* qh = q + (int64_t)head * sq * dh;
    const float* kh = k + (int64_t)head * sk * dh;
    const float* vh = v + (int64_t)head * sk * dh;
    const bool resident = dh <= kT;
    const int k_end = causal ? min(sk, q0 + kT) : sk;

    float m[4], l[4], acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = -INFINITY;
        l[i] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
    if (resident) load_tile(qs, qh, q0, sq, 0, dh);

    for (int k0 = 0; k0 < k_end; k0 += kT) {
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
        for (int d0 = 0; d0 < dh; d0 += kT) {
            if (!resident) load_tile(qs, qh, q0, sq, d0, dh);
            load_tile(ks, kh, k0, sk, d0, dh);
            __syncthreads();
            mma_nt(s, qs, ks, ty, tx);
            __syncthreads();
        }
        load_tile(vs, vh, k0, sk, c0, dh);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = q0 + ty + 16 * i;
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int col = k0 + tx + 16 * j;
                const bool live = col < sk && (!causal || col <= row);
                s[i][j] = live ? s[i][j] * scale : -INFINITY;
                mx = fmaxf(mx, s[i][j]);
            }
            const float m_new = fmaxf(m[i], row_max(mx));
            // a row with no live key yet keeps p = 0 and alpha = 1
            const float m_use = m_new == -INFINITY ? 0.f : m_new;
            const float alpha = expf(m[i] - m_use);
            l[i] *= alpha;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                acc[i][j] *= alpha;
                const float p = expf(s[i][j] - m_use);
                l[i] += p;
                ps[(ty + 16 * i) * kLd + tx + 16 * j] = p;
            }
            m[i] = m_new;
        }
        __syncthreads();
        mma_nn(acc, ps, vs, ty, tx);
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float lsum = row_sum(l[i]);
        const int row = q0 + ty + 16 * i;
        if (row >= sq) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = c0 + tx + 16 * j;
            if (col < dh) o[((int64_t)head * sq + row) * dh + col] = acc[i][j] / lsum;
        }
        if (blockIdx.z == 0 && tx == 0)
            lse[(int64_t)head * sq + row] = m[i] + logf(lsum);
    }
}

// ------------------------------------------------------------------ backward
// cp.async of 16 or 4 bytes; with in == false nothing is read and the
// destination is zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most n of this thread's committed groups are in flight.
template <int n>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// Rows [row0, row0 + 64) x columns [col0, col0 + 64) of a (rows, dh)
// row-major matrix into a backward tile (stride kBLd), zero outside the
// matrix; vec: 16-byte copies (dh % 4 == 0 and src 16-byte aligned, so a
// group of 4 columns is wholly in or out).
__device__ __forceinline__ void stage_tile(float* dst,
                                           const float* __restrict__ src,
                                           int row0, int rows, int col0,
                                           int dh, bool vec) {
    if (vec) {
        for (int idx = threadIdx.x; idx < kT * kT / 4; idx += kBwdThreads) {
            const int r = idx >> 4, c = (idx & 15) << 2;
            const int gr = row0 + r, gc = col0 + c;
            const bool in = gr < rows && gc < dh;
            cp_async16(dst + r * kBLd + c,
                       in ? src + (int64_t)gr * dh + gc : src, in);
        }
    } else {
        for (int idx = threadIdx.x; idx < kT * kT; idx += kBwdThreads) {
            const int r = idx >> 6, c = idx & (kT - 1);
            const int gr = row0 + r, gc = col0 + c;
            const bool in = gr < rows && gc < dh;
            cp_async4(dst + r * kBLd + c,
                      in ? src + (int64_t)gr * dh + gc : src, in);
        }
    }
}

// Entries [row0, row0 + 64) of a row vector, zero past rows.
__device__ __forceinline__ void stage_row(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int rows) {
    for (int r = threadIdx.x; r < kT; r += kBwdThreads) {
        const bool in = row0 + r < rows;
        cp_async4(dst + r, in ? src + row0 + r : src, in);
    }
}

// x = big + small, both TF32: big = x rounded to its top 19 bits (nearest,
// ties away from zero, as cvt.rna.tf32.f32), small = the rest rounded the
// same way.  Integer arithmetic: it issues at four times cvt's rate.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
    big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    const float rest = x - __uint_as_float(big);
    small = (__float_as_uint(rest) + 0x1000u) & 0xffffe000u;
}

// d = a b + c on one 16 x 8 x 8 TF32 tile (d may be c).
__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4],
                                         const uint32_t b[2],
                                         const float c[4]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %11, %12, %13};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
          "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// A 64 x 64 operand of a product, kept in shared memory fragment-native:
// for row block m and 8-wide k block kb, each lane's A fragment as one
// float4, split into big and small TF32 halves (two arrays of kFrag
// float4s, entry (m kN8 + kb) 32 + lane).
constexpr int kFrag = 4 * kN8 * 32;

__device__ __forceinline__ void store_split(float4* big, float4* small,
                                            int at, float x0, float x1,
                                            float x2, float x3) {
    uint32_t hb[4], hs[4];
    split(x0, hb[0], hs[0]);
    split(x1, hb[1], hs[1]);
    split(x2, hb[2], hs[2]);
    split(x3, hb[3], hs[3]);
    big[at] = make_float4(__uint_as_float(hb[0]), __uint_as_float(hb[1]),
                          __uint_as_float(hb[2]), __uint_as_float(hb[3]));
    small[at] = make_float4(__uint_as_float(hs[0]), __uint_as_float(hs[1]),
                            __uint_as_float(hs[2]), __uint_as_float(hs[3]));
}

// A staged 64-row tile as fragment-native A operands in natural k order
// (lane g, t: (g, t), (g+8, t), (g, t+4), (g+8, t+4) of its block); all
// threads of the block take part.
__device__ __forceinline__ void frag_from_tile(float4* big, float4* small,
                                               const float* tile) {
    for (int u = threadIdx.x; u < kFrag; u += kBwdThreads) {
        const int lane = u & 31, m = u >> 8, kb = (u >> 5) & (kN8 - 1);
        const float* p =
            tile + (16 * m + (lane >> 2)) * kBLd + 8 * kb + (lane & 3);
        store_split(big, small, u, p[0], p[8 * kBLd], p[4], p[8 * kBLd + 4]);
    }
}

// A warp's accumulator fragments c[mi][i] (rows 16 (m0 + mi).., columns
// 8 (kb0 + i)..; lane g, t holds (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1))
// as fragment-native A operands of a later product whose k steps take the
// order (0,2,4,6,1,3,5,7) in both operands: A's column t is column 2t and
// A's column t+4 is column 2t+1, so each fragment is stored as it stands.
__device__ __forceinline__ void store_c(float4* big, float4* small, int m0,
                                        int kb0, const float c[kWM][kWN][4],
                                        int lane) {
#pragma unroll
    for (int mi = 0; mi < kWM; ++mi)
#pragma unroll
        for (int i = 0; i < kWN; ++i)
            store_split(big, small, ((m0 + mi) * kN8 + kb0 + i) * 32 + lane,
                        c[mi][i][0], c[mi][i][2], c[mi][i][1], c[mi][i][3]);
}

// One warp, lane = 4 g + t: acc[mi][i] (the 16 x 8 accumulator fragment of
// rows 16 (m0 + mi).., output columns n0 + 8i..) += A . B over the k blocks
// [kb0, kb1), A a fragment-native operand, in 3xTF32.  B's 8 x 8 block (k
// block kb, output columns n0 + 8i..) is read from a staged tile b and
// split once for both row blocks:
// - kPairs false: B = b[n0 + 8i .. +8][8kb .. +8]^T, lane reading row g,
//   columns t and t+4 (natural k order);
// - kPairs true: B = b[8kb .. +8][n0 + 8i .. +8], lane reading rows 2t and
//   2t+1, column g (the permuted k order of store_c).
// Both patterns are free of bank conflicts at the stride of 68.  Two k steps
// at a time sum as.bb + ab.bs + ab.bb from zero in the tensor cores (the
// cross terms first) and add that to acc as an fp32 add: the tensor cores
// sum with truncation, and keeping each 16-deep sum apart holds sums over
// hundreds of keys at fp32 accuracy.  The fragments are independent, so
// their products issue interleaved.  The k loop is unrolled whole, so every
// shared address is a constant offset; pairs of k blocks wholly outside
// [kb0, kb1) are skipped, and a block inside a pair but outside the range
// holds exact zeros in A (masked P or dS), so it adds nothing.
template <bool kPairs>
__device__ __forceinline__ void product(float acc[kWM][kWN][4],
                                        const float4* big,
                                        const float4* small, int m0, int kb0,
                                        int kb1, const float* b, int n0,
                                        int g, int t, int lane) {
    const float zero[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kp = 0; kp < kN8; kp += 2) {
        if (kp + 2 <= kb0 || kp >= kb1) continue;
        float part[kWM][kWN][4];
#pragma unroll
        for (int step = 0; step < 2; ++step) {
            const int kb = kp + step;
            uint32_t ab[kWM][4], as[kWM][4], bb[kWN][2], bs[kWN][2];
#pragma unroll
            for (int mi = 0; mi < kWM; ++mi) {
                const int at = ((m0 + mi) * kN8 + kb) * 32 + lane;
                const float4 fb = big[at], fs = small[at];
                ab[mi][0] = __float_as_uint(fb.x);
                ab[mi][1] = __float_as_uint(fb.y);
                ab[mi][2] = __float_as_uint(fb.z);
                ab[mi][3] = __float_as_uint(fb.w);
                as[mi][0] = __float_as_uint(fs.x);
                as[mi][1] = __float_as_uint(fs.y);
                as[mi][2] = __float_as_uint(fs.z);
                as[mi][3] = __float_as_uint(fs.w);
            }
#pragma unroll
            for (int i = 0; i < kWN; ++i) {
                const float* br =
                    kPairs ? b + (8 * kb + 2 * t) * kBLd + n0 + 8 * i + g
                           : b + (n0 + 8 * i + g) * kBLd + 8 * kb + t;
                split(br[0], bb[i][0], bs[i][0]);
                split(br[kPairs ? kBLd : 4], bb[i][1], bs[i][1]);
            }
#pragma unroll
            for (int mi = 0; mi < kWM; ++mi)
#pragma unroll
                for (int i = 0; i < kWN; ++i)
                    mma_tf32(part[mi][i], as[mi], bb[i],
                             step ? part[mi][i] : zero);
#pragma unroll
            for (int mi = 0; mi < kWM; ++mi)
#pragma unroll
                for (int i = 0; i < kWN; ++i)
                    mma_tf32(part[mi][i], ab[mi], bs[i], part[mi][i]);
#pragma unroll
            for (int mi = 0; mi < kWM; ++mi)
#pragma unroll
                for (int i = 0; i < kWN; ++i)
                    mma_tf32(part[mi][i], ab[mi], bb[i], part[mi][i]);
        }
#pragma unroll
        for (int mi = 0; mi < kWM; ++mi)
#pragma unroll
            for (int i = 0; i < kWN; ++i)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[mi][i][e] += part[mi][i][e];
    }
}

// dK/dV: a block owns 64 keys and walks the query tiles.  Warp w (rows
// 32 (w & 1).., columns n0 = 16 (w >> 1)..) forms S^T and dP^T for those
// keys and queries n0.. of the tile, hands P and dS to the block through
// shared memory, then accumulates dV and dK for the same keys and output
// columns n0...
// Shared memory: k and v fragment-native, two stages of (q tile, do tile,
// lse row, di row), P and dS fragment-native (whose space first takes the
// raw k and v tiles).
constexpr int kDkvStage = 2 * kBTile + 2 * kT;
constexpr size_t kDkvSmem =
    8 * kFrag * sizeof(float4) + 2 * kDkvStage * sizeof(float);

__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ di,
                     const float* __restrict__ lse,
                     const float* __restrict__ dout, float* __restrict__ dk,
                     float* __restrict__ dv, int bh, int sq, int sk, int dh,
                     int causal, float scale, int vec) {
    extern __shared__ __align__(16) float4 smem16[];
    float4* kf_big = smem16;
    float4* kf_small = kf_big + kFrag;
    float4* vf_big = kf_small + kFrag;
    float4* vf_small = vf_big + kFrag;
    float4* p_big = vf_small + kFrag;
    float4* p_small = p_big + kFrag;
    float4* ds_big = p_small + kFrag;
    float4* ds_small = ds_big + kFrag;
    float* raw = reinterpret_cast<float*>(p_big);     // k, v as staged
    float* stages = reinterpret_cast<float*>(ds_small + kFrag);
    const int tiles = (sk + kT - 1) / kT;
    int head, kt;
    // key tile 0 has the longest causal walk: natural order is longest-first
    block_coords(bh, tiles, false, &head, &kt);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2,
              t = lane & 3, m0 = kWM * (warp & 1), n0 = 8 * kWN * (warp >> 1);
    const int k0 = kt * kT, c0 = blockIdx.z * kT;
    const int64_t qoff = (int64_t)head * sq * dh, koff = (int64_t)head * sk * dh;
    const float* qh = q + qoff;
    const float* doh = dout + qoff;
    const float* lseh = lse + (int64_t)head * sq;
    const float* dih = di + (int64_t)head * sq;
    const bool resident = dh <= kT, v16 = vec != 0;

    // q and do columns [col0, col0 + 64) of query tile q0 into a stage, and
    // its lse and di rows
    auto stage_queries = [&](float* st, int q0, int col0, bool rows) {
        stage_tile(st, qh, q0, sq, col0, dh, v16);
        stage_tile(st + kBTile, doh, q0, sq, col0, dh, v16);
        if (rows) {
            stage_row(st + 2 * kBTile, lseh, q0, sq);
            stage_row(st + 2 * kBTile + kT, dih, q0, sq);
        }
    };
    // k and v columns [d0, d0 + 64) of the block's keys, fragment-native
    auto stage_keys = [&](int d0) {
        stage_tile(raw, k + koff, k0, sk, d0, dh, v16);
        stage_tile(raw + kBTile, v + koff, k0, sk, d0, dh, v16);
    };
    auto split_keys = [&]() {
        frag_from_tile(kf_big, kf_small, raw);
        frag_from_tile(vf_big, vf_small, raw + kBTile);
    };

    float dk_acc[kWM][kWN][4] = {}, dv_acc[kWM][kWN][4] = {};
    // causal: query rows below k0 see none of these keys
    const int q_begin = causal ? k0 : 0;
    if (resident && q_begin < sq) {
        stage_keys(0);
        stage_queries(stages, q_begin, 0, true);
        cp_commit();
        cp_wait<0>();
        __syncthreads();
        split_keys();   // ordered before its readers by the loop's barrier
    }
    int buf = 0;
    for (int q0 = q_begin; q0 < sq; q0 += kT, buf ^= 1) {
        float* qs = stages + buf * kDkvStage;
        float* dos = qs + kBTile;
        const float* lse_s = dos + kBTile;
        const float* di_s = lse_s + kT;
        if (resident) {
            if (q0 + kT < sq) {
                stage_queries(stages + (buf ^ 1) * kDkvStage, q0 + kT, 0, true);
                cp_commit();
                cp_wait<1>();
            } else {
                cp_wait<0>();
            }
            __syncthreads();
        }
        // this warp's piece has no live (key, query) pair: past an end, or
        // wholly above the causal diagonal
        const bool dead = k0 + 16 * m0 >= sk || q0 + n0 >= sq
                          || (causal && k0 + 16 * m0 > q0 + n0 + 8 * kWN - 1);
        float s[kWM][kWN][4] = {}, dp[kWM][kWN][4] = {};   // S^T and dP^T
        for (int d0 = 0; d0 < dh; d0 += kT) {
            if (!resident) {
                stage_queries(qs, q0, d0, d0 == 0);
                stage_keys(d0);
                cp_commit();
                cp_wait<0>();
                __syncthreads();
                split_keys();
                __syncthreads();
            }
            if (!dead) {
                product<false>(s, kf_big, kf_small, m0, 0, kN8, qs, n0, g, t,
                               lane);
                product<false>(dp, vf_big, vf_small, m0, 0, kN8, dos, n0, g,
                               t, lane);
            }
            if (!resident) __syncthreads();
        }
        if (!resident) {
            stage_queries(qs, q0, c0, false);
            cp_commit();
        }
#pragma unroll
        for (int mi = 0; mi < kWM; ++mi)
#pragma unroll
            for (int i = 0; i < kWN; ++i)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int key = k0 + 16 * (m0 + mi) + g + 8 * (e >> 1);
                    const int ql = n0 + 8 * i + 2 * t + (e & 1);
                    const int row = q0 + ql;
                    const bool live =
                        row < sq && key < sk && (!causal || key <= row);
                    const float p =
                        live ? expf(s[mi][i][e] * scale - lse_s[ql]) : 0.f;
                    dp[mi][i][e] = p * (dp[mi][i][e] - di_s[ql]);
                    s[mi][i][e] = p;
                }
        store_c(p_big, p_small, m0, n0 / 8, s, lane);
        store_c(ds_big, ds_small, m0, n0 / 8, dp, lane);
        if (!resident) cp_wait<0>();
        __syncthreads();
        // query blocks wholly below the warp's keys (causal) or past sq: P = 0
        const int kb0 = causal ? max(0, (k0 + 16 * m0 - q0) / 8) : 0;
        const int kb1 = min(kN8, (sq - q0 + 7) / 8);
        product<true>(dv_acc, p_big, p_small, m0, kb0, kb1, dos, n0, g, t,
                      lane);
        product<true>(dk_acc, ds_big, ds_small, m0, kb0, kb1, qs, n0, g, t,
                      lane);
        __syncthreads();
    }
#pragma unroll
    for (int mi = 0; mi < kWM; ++mi)
#pragma unroll
        for (int i = 0; i < kWN; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int key = k0 + 16 * (m0 + mi) + g + 8 * (e >> 1);
                const int col = c0 + n0 + 8 * i + 2 * t + (e & 1);
                if (key >= sk || col >= dh) continue;
                const int64_t at = koff + (int64_t)key * dh + col;
                dk[at] = dk_acc[mi][i][e] * scale;
                dv[at] = dv_acc[mi][i][e];
            }
}

// dQ: a block owns 64 query rows and walks the key tiles.  Warp w (rows
// 32 (w & 1).., columns n0 = 16 (w >> 1)..) forms S and dP for those rows
// and keys n0.. of the tile, hands dS to the block through shared memory,
// then accumulates dQ for the same rows and output columns n0...
// Shared memory: q and do fragment-native, two stages of (k tile, v tile),
// dS fragment-native.
constexpr int kDqStage = 2 * kBTile;
constexpr size_t kDqSmem =
    6 * kFrag * sizeof(float4) + 2 * kDqStage * sizeof(float);

__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ di,
                    const float* __restrict__ lse,
                    const float* __restrict__ dout, float* __restrict__ dq,
                    int bh, int sq, int sk, int dh, int causal, float scale,
                    int vec) {
    extern __shared__ __align__(16) float4 smem16[];
    float4* qf_big = smem16;
    float4* qf_small = qf_big + kFrag;
    float4* dof_big = qf_small + kFrag;
    float4* dof_small = dof_big + kFrag;
    float4* ds_big = dof_small + kFrag;
    float4* ds_small = ds_big + kFrag;
    float* stages = reinterpret_cast<float*>(ds_small + kFrag);
    const int tiles = (sq + kT - 1) / kT;
    int head, qt;
    block_coords(bh, tiles, causal != 0, &head, &qt);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2,
              t = lane & 3, m0 = kWM * (warp & 1), n0 = 8 * kWN * (warp >> 1);
    const int q0 = qt * kT, c0 = blockIdx.z * kT;
    const int64_t qoff = (int64_t)head * sq * dh, koff = (int64_t)head * sk * dh;
    const float* kh = k + koff;
    const float* vh = v + koff;
    const bool resident = dh <= kT, v16 = vec != 0;
    const int k_end = causal ? min(sk, q0 + kT) : sk;

    // q and do columns [d0, d0 + 64) of the block's rows, staged in a free
    // stage and split fragment-native
    auto stage_rows = [&](float* scratch, int d0) {
        stage_tile(scratch, q + qoff, q0, sq, d0, dh, v16);
        stage_tile(scratch + kBTile, dout + qoff, q0, sq, d0, dh, v16);
    };
    auto split_rows = [&](const float* scratch) {
        frag_from_tile(qf_big, qf_small, scratch);
        frag_from_tile(dof_big, dof_small, scratch + kBTile);
    };

    // the rows a thread touches: g and g + 8 of each of its row blocks
    float lse_r[kWM][2], di_r[kWM][2];
    int rows[kWM][2];
#pragma unroll
    for (int mi = 0; mi < kWM; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = q0 + 16 * (m0 + mi) + g + 8 * h;
            const bool in = row < sq;
            rows[mi][h] = row;
            lse_r[mi][h] = in ? __ldg(lse + (int64_t)head * sq + row) : 0.f;
            di_r[mi][h] = in ? __ldg(di + (int64_t)head * sq + row) : 0.f;
        }
    if (resident) {
        stage_rows(stages + kDqStage, 0);
        stage_tile(stages, kh, 0, sk, 0, dh, v16);
        stage_tile(stages + kBTile, vh, 0, sk, 0, dh, v16);
        cp_commit();
        cp_wait<0>();
        __syncthreads();
        split_rows(stages + kDqStage);
        // the loop's first barrier orders the split before its readers and
        // before the prefetch into the same stage
        __syncthreads();
    }
    float dq_acc[kWM][kWN][4] = {};
    int buf = 0;
    for (int k0 = 0; k0 < k_end; k0 += kT, buf ^= 1) {
        float* ks = stages + buf * kDqStage;
        float* vs = ks + kBTile;
        if (resident) {
            if (k0 + kT < k_end) {
                float* next = stages + (buf ^ 1) * kDqStage;
                stage_tile(next, kh, k0 + kT, sk, 0, dh, v16);
                stage_tile(next + kBTile, vh, k0 + kT, sk, 0, dh, v16);
                cp_commit();
                cp_wait<1>();
            } else {
                cp_wait<0>();
            }
            __syncthreads();
        }
        // this warp's piece has no live (row, key) pair: past an end, or
        // wholly above the causal diagonal
        const bool dead = q0 + 16 * m0 >= sq || k0 + n0 >= sk
                          || (causal && k0 + n0 > q0 + 16 * (m0 + kWM) - 1);
        float s[kWM][kWN][4] = {}, dp[kWM][kWN][4] = {};
        for (int d0 = 0; d0 < dh; d0 += kT) {
            if (!resident) {
                float* scratch = stages + (buf ^ 1) * kDqStage;
                stage_rows(scratch, d0);
                stage_tile(ks, kh, k0, sk, d0, dh, v16);
                stage_tile(vs, vh, k0, sk, d0, dh, v16);
                cp_commit();
                cp_wait<0>();
                __syncthreads();
                split_rows(scratch);
                __syncthreads();
            }
            if (!dead) {
                product<false>(s, qf_big, qf_small, m0, 0, kN8, ks, n0, g, t,
                               lane);
                product<false>(dp, dof_big, dof_small, m0, 0, kN8, vs, n0, g,
                               t, lane);
            }
            if (!resident) __syncthreads();
        }
        if (!resident) {
            stage_tile(ks, kh, k0, sk, c0, dh, v16);
            cp_commit();
        }
#pragma unroll
        for (int mi = 0; mi < kWM; ++mi)
#pragma unroll
            for (int i = 0; i < kWN; ++i)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int h = e >> 1, row = rows[mi][h];
                    const int col = k0 + n0 + 8 * i + 2 * t + (e & 1);
                    const bool live =
                        row < sq && col < sk && (!causal || col <= row);
                    const float p =
                        live ? expf(s[mi][i][e] * scale - lse_r[mi][h]) : 0.f;
                    dp[mi][i][e] = p * (dp[mi][i][e] - di_r[mi][h]);
                }
        store_c(ds_big, ds_small, m0, n0 / 8, dp, lane);
        if (!resident) cp_wait<0>();
        __syncthreads();
        // key blocks wholly after the warp's rows (causal) or past sk: dS = 0
        int kb1 = min(kN8, (sk - k0 + 7) / 8);
        if (causal) kb1 = min(kb1, (q0 + 16 * (m0 + kWM) - 1 - k0) / 8 + 1);
        product<true>(dq_acc, ds_big, ds_small, m0, 0, kb1, ks, n0, g, t,
                      lane);
        __syncthreads();
    }
#pragma unroll
    for (int mi = 0; mi < kWM; ++mi)
#pragma unroll
        for (int i = 0; i < kWN; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int row = rows[mi][e >> 1];
                const int col = c0 + n0 + 8 * i + 2 * t + (e & 1);
                if (row < sq && col < dh)
                    dq[qoff + (int64_t)row * dh + col] =
                        dq_acc[mi][i][e] * scale;
            }
}

// Grid of one block per (tile, head) and per 64-wide output chunk of D;
// false when the geometry does not fit a grid.
bool plan(int bh, int rows, int dh, dim3* grid) {
    if (bh < 1 || rows < 1 || dh < 1) return false;
    const int64_t tiles = (rows + kT - 1) / kT;
    const int64_t chunks = (dh + kT - 1) / kT;
    if (tiles * bh > 0x7fffffff || chunks > 65535) return false;
    *grid = dim3((unsigned)(tiles * bh), 1, (unsigned)chunks);
    return true;
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
    if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// 1 when every (BH, S, D) operand can be staged by 16-byte copies: D % 4 == 0
// and 16-byte aligned bases.
int rows_of_16_bytes(int dh, const float* const* ptrs, int n) {
    if (dh % 4) return 0;
    for (int i = 0; i < n; ++i)
        if ((uintptr_t)ptrs[i] % 16) return 0;
    return 1;
}

}  // namespace

extern "C" {

int flash_attention_fwd_f32(const float* q, const float* k, const float* v,
                            float* o, float* lse, int bh, int sq, int sk,
                            int dh, int causal, float scale, void* stream) {
    dim3 grid;
    if (sk < 1 || !plan(bh, sq, dh, &grid)) return (int)cudaErrorInvalidValue;
    const size_t smem = 4 * kTile * sizeof(float);
    int code = prepare(flash_fwd_kernel, smem);
    if (code) return code;
    flash_fwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        q, k, v, o, lse, bh, sq, sk, dh, causal, scale);
    return (int)cudaGetLastError();
}

int flash_attention_bwd_dkv_f32(const float* q, const float* k,
                                const float* v, const float* di,
                                const float* lse, const float* dout,
                                float* dk, float* dv, int bh, int sq, int sk,
                                int dh, int causal, float scale,
                                void* stream) {
    dim3 grid;
    if (sq < 1 || !plan(bh, sk, dh, &grid)) return (int)cudaErrorInvalidValue;
    int code = prepare(flash_bwd_dkv_kernel, kDkvSmem);
    if (code) return code;
    const float* staged[] = {q, k, v, dout};
    flash_bwd_dkv_kernel<<<grid, kBwdThreads, kDkvSmem,
                           (cudaStream_t)stream>>>(
        q, k, v, di, lse, dout, dk, dv, bh, sq, sk, dh, causal, scale,
        rows_of_16_bytes(dh, staged, 4));
    return (int)cudaGetLastError();
}

int flash_attention_bwd_dq_f32(const float* q, const float* k, const float* v,
                               const float* di, const float* lse,
                               const float* dout, float* dq, int bh, int sq,
                               int sk, int dh, int causal, float scale,
                               void* stream) {
    dim3 grid;
    if (sk < 1 || !plan(bh, sq, dh, &grid)) return (int)cudaErrorInvalidValue;
    int code = prepare(flash_bwd_dq_kernel, kDqSmem);
    if (code) return code;
    const float* staged[] = {q, k, v, dout};
    flash_bwd_dq_kernel<<<grid, kBwdThreads, kDqSmem, (cudaStream_t)stream>>>(
        q, k, v, di, lse, dout, dq, bh, sq, sk, dh, causal, scale,
        rows_of_16_bytes(dh, staged, 4));
    return (int)cudaGetLastError();
}

const char* flash_attention_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
