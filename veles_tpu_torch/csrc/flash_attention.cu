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
// o and do (BH, Sq, D), the residual lse (BH, Sq).  For query row r and key c:
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
// -inf, so no finite mask value can leak mass into a row.
//
// Bound on the H100: operations.  At the training shape (32 x 8 heads, S 512,
// D 64, causal) the forward does two causal products of S^2 D per head
// (8.6 GFLOP, 0.128 ms at the 67 TFLOP/s fp32 rate) against 134 MB of q, k, v
// and o (0.040 ms at 3.35 TB/s); the backward five (21.5 GFLOP, 0.32 ms)
// against 268 MB.  fp32 throughout, on the CUDA cores (no TF32: the reference
// is fp32).
//
// Design, simple and exact before fast:
// - a block of 256 threads owns one 64-row tile: query rows (forward, dQ) or
//   keys (dK/dV).  It walks the other side's 64-wide tiles in ascending order
//   inside the block, the TPU grid's sequential axis become a loop, and skips
//   the tiles wholly above the diagonal (the bundled kernel's
//   below_or_on_diag); blocks are issued longest-first.
// - tiles are staged in shared memory as 64 x 65 floats (the odd stride keeps
//   every access pattern below free of bank conflicts); each thread holds a
//   4 x 4 strided piece of the 64 x 64 score, probability and accumulator
//   tiles in registers.
// - the head dimension is tiled too: products contract over D in chunks of
//   64 staged through shared memory, and each block accumulates one 64-wide
//   chunk of its output (grid.z), so any D runs with fixed registers and
//   shared memory.  D <= 64 is one chunk: then the block's own tiles stay
//   resident and are loaded once.
// - the backward is two passes with no atomics, as the reference's: dK/dV
//   owns key tiles and walks query tiles, dQ owns query tiles and walks key
//   tiles.  Both recompute P from the row residual, and both form di from o
//   and do themselves, so no other kernel runs and the results repeat bit
//   for bit from run to run.
// - rows, keys and head columns past the ends are zero-filled on load and
//   masked, so any S and D are taken; the ragged tail is never refused.
//
// Plain C interface (loaded with ctypes): each entry point launches on the
// given stream and returns cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;              // tile rows = tile keys = D chunk
constexpr int kLd = kT + 1;         // padded row stride of a shared tile
constexpr int kTile = kT * kLd;     // floats in one shared tile
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

// acc[i][j] += sum_k a[k][ty + 16i] * b[k][tx + 16j]        (a^T b)
__device__ __forceinline__ void mma_tn(float acc[4][4], const float* a,
                                       const float* b, int ty, int tx) {
#pragma unroll 8
    for (int k = 0; k < kT; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            av[i] = a[k * kLd + ty + 16 * i];
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

// lse (or 0 past the end) and di = sum_d o do for the 64 rows of a query
// tile, into shared memory: one warp a row, lanes striding over D.
__device__ __forceinline__ void row_residuals(
    const float* __restrict__ o, const float* __restrict__ dout,
    const float* __restrict__ lse, int q0, int sq, int dh, float* lse_s,
    float* di_s) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < kT; r += kThreads / 32) {
        const int row = q0 + r;
        float acc = 0.f;
        if (row < sq)
            for (int d = lane; d < dh; d += 32)
                acc = fmaf(__ldg(o + (int64_t)row * dh + d),
                           __ldg(dout + (int64_t)row * dh + d), acc);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (lane == 0) {
            di_s[r] = acc;
            lse_s[r] = row < sq ? __ldg(lse + row) : 0.f;
        }
    }
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

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ o,
                     const float* __restrict__ lse,
                     const float* __restrict__ dout, float* __restrict__ dk,
                     float* __restrict__ dv, int bh, int sq, int sk, int dh,
                     int causal, float scale) {
    extern __shared__ float smem[];
    float* qs = smem;
    float* dos = qs + kTile;
    float* ks = dos + kTile;
    float* vs = ks + kTile;
    float* ps = vs + kTile;
    float* dss = ps + kTile;
    float* lse_s = dss + kTile;
    float* di_s = lse_s + kT;
    const int tiles = (sk + kT - 1) / kT;
    int head, kt;
    // key tile 0 has the longest causal walk: natural order is longest-first
    block_coords(bh, tiles, false, &head, &kt);
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
    const int k0 = kt * kT, c0 = blockIdx.z * kT;
    const int64_t qoff = (int64_t)head * sq * dh, koff = (int64_t)head * sk * dh;
    const bool resident = dh <= kT;

    float dk_acc[4][4], dv_acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
    if (resident) {
        load_tile(ks, k + koff, k0, sk, 0, dh);
        load_tile(vs, v + koff, k0, sk, 0, dh);
    }
    // causal: query rows below k0 see none of these keys
    const int q_begin = causal ? (k0 / kT) * kT : 0;
    for (int q0 = q_begin; q0 < sq; q0 += kT) {
        row_residuals(o + qoff, dout + qoff, lse + (int64_t)head * sq, q0, sq,
                      dh, lse_s, di_s);
        float s[4][4], dp[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
        for (int d0 = 0; d0 < dh; d0 += kT) {
            load_tile(qs, q + qoff, q0, sq, d0, dh);
            load_tile(dos, dout + qoff, q0, sq, d0, dh);
            if (!resident) {
                load_tile(ks, k + koff, k0, sk, d0, dh);
                load_tile(vs, v + koff, k0, sk, d0, dh);
            }
            __syncthreads();
            mma_nt(s, qs, ks, ty, tx);
            mma_nt(dp, dos, vs, ty, tx);
            __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int col = k0 + tx + 16 * j;
                const bool live =
                    row < sq && col < sk && (!causal || col <= row);
                const float p = live ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
                ps[r * kLd + tx + 16 * j] = p;
                dss[r * kLd + tx + 16 * j] = p * (dp[i][j] - di_s[r]);
            }
        }
        if (!resident) {
            load_tile(qs, q + qoff, q0, sq, c0, dh);
            load_tile(dos, dout + qoff, q0, sq, c0, dh);
        }
        __syncthreads();
        mma_tn(dv_acc, ps, dos, ty, tx);
        mma_tn(dk_acc, dss, qs, ty, tx);
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int key = k0 + ty + 16 * i;
        if (key >= sk) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = c0 + tx + 16 * j;
            if (col >= dh) continue;
            const int64_t at = koff + (int64_t)key * dh + col;
            dk[at] = dk_acc[i][j] * scale;
            dv[at] = dv_acc[i][j];
        }
    }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ lse,
                    const float* __restrict__ dout, float* __restrict__ dq,
                    int bh, int sq, int sk, int dh, int causal, float scale) {
    extern __shared__ float smem[];
    float* qs = smem;
    float* dos = qs + kTile;
    float* ks = dos + kTile;
    float* vs = ks + kTile;
    float* dss = vs + kTile;
    float* lse_s = dss + kTile;
    float* di_s = lse_s + kT;
    const int tiles = (sq + kT - 1) / kT;
    int head, qt;
    block_coords(bh, tiles, causal != 0, &head, &qt);
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
    const int q0 = qt * kT, c0 = blockIdx.z * kT;
    const int64_t qoff = (int64_t)head * sq * dh, koff = (int64_t)head * sk * dh;
    const bool resident = dh <= kT;
    const int k_end = causal ? min(sk, q0 + kT) : sk;

    row_residuals(o + qoff, dout + qoff, lse + (int64_t)head * sq, q0, sq, dh,
                  lse_s, di_s);
    if (resident) {
        load_tile(qs, q + qoff, q0, sq, 0, dh);
        load_tile(dos, dout + qoff, q0, sq, 0, dh);
    }
    float dq_acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dq_acc[i][j] = 0.f;
    for (int k0 = 0; k0 < k_end; k0 += kT) {
        float s[4][4], dp[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
        for (int d0 = 0; d0 < dh; d0 += kT) {
            if (!resident) {
                load_tile(qs, q + qoff, q0, sq, d0, dh);
                load_tile(dos, dout + qoff, q0, sq, d0, dh);
            }
            load_tile(ks, k + koff, k0, sk, d0, dh);
            load_tile(vs, v + koff, k0, sk, d0, dh);
            __syncthreads();
            mma_nt(s, qs, ks, ty, tx);
            mma_nt(dp, dos, vs, ty, tx);
            __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int col = k0 + tx + 16 * j;
                const bool live =
                    row < sq && col < sk && (!causal || col <= row);
                const float p = live ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
                dss[r * kLd + tx + 16 * j] = p * (dp[i][j] - di_s[r]);
            }
        }
        if (!resident) load_tile(ks, k + koff, k0, sk, c0, dh);
        __syncthreads();
        mma_nn(dq_acc, dss, ks, ty, tx);
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row >= sq) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = c0 + tx + 16 * j;
            if (col < dh) dq[qoff + (int64_t)row * dh + col] = dq_acc[i][j] * scale;
        }
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
                                const float* v, const float* o,
                                const float* lse, const float* dout,
                                float* dk, float* dv, int bh, int sq, int sk,
                                int dh, int causal, float scale,
                                void* stream) {
    dim3 grid;
    if (sq < 1 || !plan(bh, sk, dh, &grid)) return (int)cudaErrorInvalidValue;
    const size_t smem = (6 * kTile + 2 * kT) * sizeof(float);
    int code = prepare(flash_bwd_dkv_kernel, smem);
    if (code) return code;
    flash_bwd_dkv_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        q, k, v, o, lse, dout, dk, dv, bh, sq, sk, dh, causal, scale);
    return (int)cudaGetLastError();
}

int flash_attention_bwd_dq_f32(const float* q, const float* k, const float* v,
                               const float* o, const float* lse,
                               const float* dout, float* dq, int bh, int sq,
                               int sk, int dh, int causal, float scale,
                               void* stream) {
    dim3 grid;
    if (sk < 1 || !plan(bh, sq, dh, &grid)) return (int)cudaErrorInvalidValue;
    const size_t smem = (5 * kTile + 2 * kT) * sizeof(float);
    int code = prepare(flash_bwd_dq_kernel, smem);
    if (code) return code;
    flash_bwd_dq_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        q, k, v, o, lse, dout, dq, bh, sq, sk, dh, causal, scale);
    return (int)cudaGetLastError();
}

const char* flash_attention_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
