// Cross-channel local response normalization (AlexNet LRN) for Hopper
// (sm_90a), forward and backward.
//
//   lrn_fwd   replaces veles_tpu/ops/pallas_kernels.py:226 (_lrn_fwd, kernel
//             _lrn_fwd_kernel at :163, launched by _lrn_call at :204)
//   lrn_bwd   replaces veles_tpu/ops/pallas_kernels.py:244 (_lrn_bwd_vjp,
//             kernel _lrn_bwd_kernel at :172)
//
// Rows (M, C) fp32, C contiguous (the NHWC activation seen as M = N*H*W rows).
// Channel i's window is [i - n/2, i + n - 1 - n/2] clipped to [0, C): the
// reference's band, asymmetric for even n.
//
//   forward:  s_i = sum_{j in window(i)} x_j^2,  d = k + (alpha/n) s,
//             y = x * d^-beta                    (outputs y and d)
//   backward: t_j = dy_j x_j d_j^(-beta-1),  inner_i = sum_{j : i in window(j)} t_j,
//             dx = dy (d d^(-beta-1)) - (2 (alpha/n) beta) x inner
//
// The TPU kernel takes the window sum as a banded matmul on the MXU; here it
// is a direct fp32 sum over the window in ascending channel order (no TF32,
// and the order of the plain version in ops/hopper_kernels.py), with every
// product, sum and power an explicit round-to-nearest operation in the
// reference's order, so compiler flags cannot move a bit.  powf is the
// accurate libdevice power (no fast math, no __powf).
//
// Bound on the H100: bytes.  The forward reads x and writes y and d (12
// bytes an element), the backward reads x, d, dy and writes dx (16 bytes),
// for a few tens of flops an element: far below the fp32 ridge.  Design: a
// block stages a tile of whole rows (about 2048 elements) in shared memory
// with coalesced loads, so each x (forward) or t (backward) is read from
// device memory once and the n-term window sums come from shared memory; a
// grid-stride loop over tiles fills the card.  Any C up to 56K channels
// (one row must fit in shared memory) and any n >= 1.
//
// Plain C interface (loaded with ctypes): each entry point launches on the
// given stream and returns cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileElems = 2048;
constexpr int64_t kMaxBlocks = 132 * 16;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

__global__ void lrn_fwd_kernel(const float* __restrict__ x,
                               float* __restrict__ y, float* __restrict__ d,
                               int64_t rows, int c, int rows_per_tile,
                               int lo, int hi, float alpha_n, float neg_beta,
                               float k) {
    extern __shared__ float xs[];
    const int64_t tiles = (rows + rows_per_tile - 1) / rows_per_tile;
    for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int64_t row0 = tile * rows_per_tile;
        const int64_t nrows =
            rows - row0 < rows_per_tile ? rows - row0 : rows_per_tile;
        const int elems = (int)nrows * c;
        const float* xt = x + row0 * c;
        for (int e = threadIdx.x; e < elems; e += blockDim.x) xs[e] = xt[e];
        __syncthreads();
        for (int e = threadIdx.x; e < elems; e += blockDim.x) {
            const int i = e % c;
            const float* row = xs + (e - i);
            const int j0 = i - lo < 0 ? 0 : i - lo;
            const int j1 = i + hi > c - 1 ? c - 1 : i + hi;
            float s = 0.f;
            for (int j = j0; j <= j1; ++j)
                s = __fadd_rn(s, __fmul_rn(row[j], row[j]));
            const float dv = __fadd_rn(k, __fmul_rn(alpha_n, s));
            d[row0 * c + e] = dv;
            y[row0 * c + e] = __fmul_rn(xs[e], powf(dv, neg_beta));
        }
        __syncthreads();
    }
}

__global__ void lrn_bwd_kernel(const float* __restrict__ x,
                               const float* __restrict__ d,
                               const float* __restrict__ dy,
                               float* __restrict__ dx, int64_t rows, int c,
                               int rows_per_tile, int lo, int hi,
                               float neg_beta_1, float coef) {
    extern __shared__ float ts[];
    const int64_t tiles = (rows + rows_per_tile - 1) / rows_per_tile;
    for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int64_t row0 = tile * rows_per_tile;
        const int64_t nrows =
            rows - row0 < rows_per_tile ? rows - row0 : rows_per_tile;
        const int elems = (int)nrows * c;
        const int64_t base = row0 * c;
        for (int e = threadIdx.x; e < elems; e += blockDim.x) {
            const float dpow = powf(d[base + e], neg_beta_1);
            ts[e] = __fmul_rn(__fmul_rn(dy[base + e], x[base + e]), dpow);
        }
        __syncthreads();
        for (int e = threadIdx.x; e < elems; e += blockDim.x) {
            const int i = e % c;
            const float* row = ts + (e - i);
            // j's window holds i  <=>  i - hi <= j <= i + lo
            const int j0 = i - hi < 0 ? 0 : i - hi;
            const int j1 = i + lo > c - 1 ? c - 1 : i + lo;
            float inner = 0.f;
            for (int j = j0; j <= j1; ++j) inner = __fadd_rn(inner, row[j]);
            const float xv = x[base + e], dv = d[base + e];
            const float dpow = powf(dv, neg_beta_1);
            dx[base + e] = __fsub_rn(
                __fmul_rn(dy[base + e], __fmul_rn(dv, dpow)),
                __fmul_rn(__fmul_rn(coef, xv), inner));
        }
        __syncthreads();
    }
}

// Whole rows per tile, the tile's shared memory and the grid; false when
// one row does not fit in shared memory.
bool plan(int64_t rows, int c, int* rows_per_tile, size_t* smem,
          unsigned* blocks) {
    *rows_per_tile = kTileElems / c > 0 ? kTileElems / c : 1;
    *smem = (size_t)(*rows_per_tile) * c * sizeof(float);
    if (*smem > kMaxSmem) return false;
    int64_t tiles = (rows + *rows_per_tile - 1) / *rows_per_tile;
    *blocks = (unsigned)(tiles < kMaxBlocks ? tiles : kMaxBlocks);
    return true;
}

}  // namespace

extern "C" {

int lrn_forward_f32(const float* x, float* y, float* d, long long rows, int c,
                    int n, float alpha_n, float neg_beta, float k,
                    void* stream) {
    if (rows <= 0 || c <= 0) return 0;
    int rows_per_tile;
    size_t smem;
    unsigned blocks;
    if (n < 1 || !plan(rows, c, &rows_per_tile, &smem, &blocks))
        return (int)cudaErrorInvalidValue;
    if (smem > kDefaultSmem)
        cudaFuncSetAttribute(lrn_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    lrn_fwd_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        x, y, d, rows, c, rows_per_tile, n / 2, n - 1 - n / 2, alpha_n,
        neg_beta, k);
    return (int)cudaGetLastError();
}

int lrn_backward_f32(const float* x, const float* d, const float* dy,
                     float* dx, long long rows, int c, int n,
                     float neg_beta_1, float coef, void* stream) {
    if (rows <= 0 || c <= 0) return 0;
    int rows_per_tile;
    size_t smem;
    unsigned blocks;
    if (n < 1 || !plan(rows, c, &rows_per_tile, &smem, &blocks))
        return (int)cudaErrorInvalidValue;
    if (smem > kDefaultSmem)
        cudaFuncSetAttribute(lrn_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    lrn_bwd_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        x, d, dy, dx, rows, c, rows_per_tile, n / 2, n - 1 - n / 2,
        neg_beta_1, coef);
    return (int)cudaGetLastError();
}

const char* lrn_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
