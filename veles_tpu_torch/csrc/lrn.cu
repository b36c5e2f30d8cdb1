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
// and the order of the plain version in ops/hopper_kernels.py: the first
// term of a window is its lowest channel, zero outside the row), with every
// product, sum and power an explicit round-to-nearest operation in the
// reference's order, so compiler flags cannot move a bit.  powf is the
// accurate libdevice power (no fast math, no __powf).
//
// Bound on the H100: bytes.  The forward reads x and writes y and d (12
// bytes an element), the backward reads x, d, dy and writes dx (16 bytes),
// for a few tens of instructions an element.  The first version (a block
// staged one tile, synchronised, computed, then asked for the next; scalar
// accesses; a `%` and a runtime window loop an element; the backward's
// power and its operands taken twice) reached 40-45% of the byte bound:
// its loads and its instruction issue took turns.  This design streams:
//
// - A persistent grid (SMs x the occupancy the shared memory allows) walks
//   tiles of whole rows -- one contiguous span an operand -- through a ring
//   of 3 shared-memory stages.  A stage is filled by one 1-D bulk
//   copy an operand (cp.async.bulk, completing on the stage's mbarrier)
//   when C % 4 == 0 and every pointer is 16-byte aligned, else by 4-byte
//   cp.async tracked by the same mbarrier.  While a tile is computed the
//   next 2 tiles are in flight.  Rows are dealt so that every
//   block walks the same number of tiles, give or take one.
// - A thread owns quads of 4 channels (W = 4): 16-byte shared loads, and
//   y, d, dx written by 16-byte streaming stores (__stcs: LRN1's 149 MB
//   tensors do not fit the 50 MB L2).  Any other C, or an unaligned
//   pointer, takes the same kernel at W = 1.
// - n = 5 (AlexNet's) is a template: a quad reads its 4 values and the 2 +
//   2 of its halo once (8-byte, 16-byte, 8-byte loads), squares each once
//   and forms its four window sums.  Other n take a runtime window loop.
//   A thread's channel advances by a constant step from tile to tile (tiles
//   start on a row), so no element pays an integer division.
// - Backward: phase 1 takes x, d, dy of the thread's own quads from the
//   stage, evaluates d^(-beta-1) once, and writes t over dy and
//   dy (d d^(-beta-1)) over d; phase 2 sums t's windows and writes dx.
//   One power an element, every operand read from device memory once.
// - Rows too wide for two stages (forward C > 29,052, backward C > 9,684;
//   no network in the repository comes near) take a block-per-row kernel
//   without a ring; its backward keeps t in shared memory and passes
//   dy (d d^(-beta-1)) through dx, so it reads x and that term twice.
// Any C up to 58,112 channels (one row must fit in shared memory), any n.
//
// Plain C interface (loaded with ctypes): each entry point launches on the
// given stream and returns cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 227 * 1024;

// Target elements a tile: forward (x only), backward (three operands a
// stage); stages in the ring.  Larger tiles fit fewer blocks an SM.
constexpr int kFwdTile = 4096;
constexpr int kBwdTile = 2048;
constexpr int kStages = 3;

// ------------------------------------------------------ async copy helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                     smem_u32(bar)),
                 "r"(count));
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
    asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "LRN_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra LRN_WAIT;\n"
        "}\n" ::"r"(smem_u32(bar)),
        "r"(parity)
        : "memory");
}

// One thread: arrive on bar expecting `bytes` of bulk copies.
__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_u32(bar)),
        "r"(bytes)
        : "memory");
}

__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
}

// bar counts one arrival from this thread once its cp.asyncs have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
    asm volatile(
        "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
            smem_u32(bar))
        : "memory");
}

// Order this thread's shared-memory writes before later bulk copies into
// the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Fill OPS stage slots (stride `slot` floats) with elems floats of each
// src from `base`: one bulk copy an operand (W == 4), or 4-byte cp.async
// by every thread (W == 1).  Called by the whole block.
template <int W, int OPS>
__device__ __forceinline__ void fill(float* stage, int slot,
                                     const float* const (&src)[OPS],
                                     int64_t base, int elems,
                                     uint64_t* bar) {
    if constexpr (W == 4) {
        if (threadIdx.x == 0) {
            const unsigned bytes = (unsigned)elems * 4u;
            bar_expect(bar, bytes * OPS);
#pragma unroll
            for (int o = 0; o < OPS; ++o)
                bulk_copy(stage + o * slot, src[o] + base, bytes, bar);
        }
    } else {
        for (int e = threadIdx.x; e < elems; e += kThreads)
#pragma unroll
            for (int o = 0; o < OPS; ++o)
                cp_async4(stage + o * slot + e, src[o] + base + e);
        cp_async_arrive(bar);
    }
}

// ------------------------------------------------- W-wide loads and stores
// W floats from shared or device memory (plain loads: in the wide
// backward the thread reads back what it wrote).
template <int W>
__device__ __forceinline__ void ld(const float* p, float (&v)[W]) {
    if constexpr (W == 4) {
        const float4 q = *reinterpret_cast<const float4*>(p);
        v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
        v[0] = *p;
    }
}

template <int W>
__device__ __forceinline__ void sts(float* p, const float (&v)[W]) {
    if constexpr (W == 4)
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    else
        *p = v[0];
}

// Streaming store to device memory (evict first: read by the next layer,
// not by this kernel).
template <int W>
__device__ __forceinline__ void st_stream(float* p, const float (&v)[W]) {
    if constexpr (W == 4)
        __stcs(reinterpret_cast<float4*>(p),
               make_float4(v[0], v[1], v[2], v[3]));
    else
        __stcs(p, v[0]);
}

// ------------------------------------------------------------- the math
// out[w] = sum over j in [i - left, i + right], clipped to [0, c), of v_j
// (SQ: v_j^2), i = ch + w, where p points at channel ch of a row in shared
// memory; ascending j.
template <int N, int W, bool SQ>
__device__ __forceinline__ void window_sums(const float* p, int ch, int c,
                                            int left, int right,
                                            float (&out)[W]) {
    if constexpr (N == 5 && W == 4) {
        // left == right == 2; ch % 4 == 0 and c % 4 == 0, so each 2-wide
        // halo is wholly in the row or wholly out
        const float2 zero = make_float2(0.f, 0.f);
        const float2 l =
            ch > 0 ? *reinterpret_cast<const float2*>(p - 2) : zero;
        const float4 m = *reinterpret_cast<const float4*>(p);
        const float2 r =
            ch + 4 < c ? *reinterpret_cast<const float2*>(p + 4) : zero;
        float q[8] = {l.x, l.y, m.x, m.y, m.z, m.w, r.x, r.y};
        if constexpr (SQ) {
#pragma unroll
            for (int j = 0; j < 8; ++j) q[j] = __fmul_rn(q[j], q[j]);
        }
#pragma unroll
        for (int w = 0; w < 4; ++w) {
            float s = q[w];
#pragma unroll
            for (int j = 1; j < 5; ++j) s = __fadd_rn(s, q[w + j]);
            out[w] = s;
        }
    } else {
#pragma unroll
        for (int w = 0; w < W; ++w) {
            const int i = ch + w;
            const int j0 = i - left < 0 ? 0 : i - left;
            const int j1 = i + right > c - 1 ? c - 1 : i + right;
            float s = 0.f;
            for (int j = j0; j <= j1; ++j) {
                const float v = p[j - ch];
                s = __fadd_rn(s, SQ ? __fmul_rn(v, v) : v);
            }
            out[w] = s;
        }
    }
}

// Forward at the W channels from ch of a row staged in shared memory (xs
// points at channel ch); y and d point at the same channels in device
// memory.
template <int N, int W>
__device__ __forceinline__ void fwd_at(const float* xs, int ch, int c,
                                       int lo, int hi, float alpha_n,
                                       float neg_beta, float k, float* y,
                                       float* d) {
    float s[W], xv[W], dv[W], yv[W];
    window_sums<N, W, true>(xs, ch, c, lo, hi, s);
    ld<W>(xs, xv);
#pragma unroll
    for (int w = 0; w < W; ++w) {
        dv[w] = __fadd_rn(k, __fmul_rn(alpha_n, s[w]));
        yv[w] = __fmul_rn(xv[w], powf(dv[w], neg_beta));
    }
    st_stream<W>(y, yv);
    st_stream<W>(d, dv);
}

// Backward, phase 1 at W channels: t = (dy x) d^(-beta-1) and
// a = dy (d d^(-beta-1)), the one power an element.
template <int W>
__device__ __forceinline__ void bwd_terms(const float (&xv)[W],
                                          const float (&dv)[W],
                                          const float (&gv)[W],
                                          float neg_beta_1, float (&t)[W],
                                          float (&a)[W]) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
        const float p = powf(dv[w], neg_beta_1);
        t[w] = __fmul_rn(__fmul_rn(gv[w], xv[w]), p);
        a[w] = __fmul_rn(gv[w], __fmul_rn(dv[w], p));
    }
}

// Backward, phase 2: dx = a - (coef x) inner.
template <int W>
__device__ __forceinline__ void bwd_out(const float (&a)[W],
                                        const float (&xv)[W],
                                        const float (&inner)[W], float coef,
                                        float (&dx)[W]) {
#pragma unroll
    for (int w = 0; w < W; ++w)
        dx[w] = __fsub_rn(a[w], __fmul_rn(__fmul_rn(coef, xv[w]), inner[w]));
}

// ----------------------------------------------------------- ring kernels
// Block-wide ring bookkeeping: stage s's barrier sits after every stage's
// slots; local tile j lives in stage j % stages, phase (j / stages) & 1.
struct Ring {
    float* smem;
    uint64_t* bars;
    int slot, ops, stages;
    __device__ float* stage(int s) const { return smem + s * ops * slot; }
};

__device__ __forceinline__ Ring ring_init(float* smem, int slot, int ops,
                                          int stages, unsigned arrivals) {
    Ring r{smem, reinterpret_cast<uint64_t*>(smem + stages * ops * slot),
           slot, ops, stages};
    if (threadIdx.x == 0) {
        for (int s = 0; s < stages; ++s) bar_init(&r.bars[s], arrivals);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    return r;
}

template <int N, int W>
__global__ void __launch_bounds__(kThreads)
    lrn_fwd_kernel(const float* __restrict__ x, float* __restrict__ y,
                   float* __restrict__ d, int64_t rows, int c, int rpt,
                   int slot, int stages, int n, float alpha_n,
                   float neg_beta, float k) {
    extern __shared__ __align__(16) float smem[];
    const int lo = N ? N / 2 : n / 2, hi = N ? N - 1 - N / 2 : n - 1 - n / 2;
    const int64_t tiles = (rows + rpt - 1) / rpt;
    const Ring ring = ring_init(smem, slot, 1, stages, W == 4 ? 1 : kThreads);
    const float* const src[1] = {x};
    auto load = [&](int64_t tile, int s) {
        const int64_t row0 = tile * rpt;
        const int nrows = (int)(rows - row0 < rpt ? rows - row0 : rpt);
        fill<W, 1>(ring.stage(s), slot, src, row0 * c, nrows * c,
                   &ring.bars[s]);
    };
    for (int s = 0; s < stages; ++s) {
        const int64_t tile = blockIdx.x + (int64_t)s * gridDim.x;
        if (tile < tiles) load(tile, s);
    }
    // tiles start on a row: a thread's channels are the same in every tile
    const int ch0 = (W * threadIdx.x) % c, step = (W * kThreads) % c;
    for (int j = 0;; ++j) {
        const int64_t tile = blockIdx.x + (int64_t)j * gridDim.x;
        if (tile >= tiles) break;
        const int s = j % stages;
        bar_wait(&ring.bars[s], (j / stages) & 1);
        const float* xs = ring.stage(s);
        const int64_t row0 = tile * rpt;
        const int nrows = (int)(rows - row0 < rpt ? rows - row0 : rpt);
        const int elems = nrows * c;
        const int64_t base = row0 * c;
        int ch = ch0;
        for (int e = W * threadIdx.x; e < elems; e += W * kThreads) {
            fwd_at<N, W>(xs + e, ch, c, lo, hi, alpha_n, neg_beta, k,
                         y + base + e, d + base + e);
            ch += step;
            if (ch >= c) ch -= c;
        }
        __syncthreads();
        const int64_t next = tile + (int64_t)stages * gridDim.x;
        if (next < tiles) load(next, s);
    }
}

template <int N, int W>
__global__ void __launch_bounds__(kThreads)
    lrn_bwd_kernel(const float* __restrict__ x, const float* __restrict__ d,
                   const float* __restrict__ dy, float* __restrict__ dx,
                   int64_t rows, int c, int rpt, int slot, int stages, int n,
                   float neg_beta_1, float coef) {
    extern __shared__ __align__(16) float smem[];
    const int lo = N ? N / 2 : n / 2, hi = N ? N - 1 - N / 2 : n - 1 - n / 2;
    const int64_t tiles = (rows + rpt - 1) / rpt;
    const Ring ring = ring_init(smem, slot, 3, stages, W == 4 ? 1 : kThreads);
    const float* const src[3] = {x, d, dy};
    auto load = [&](int64_t tile, int s) {
        const int64_t row0 = tile * rpt;
        const int nrows = (int)(rows - row0 < rpt ? rows - row0 : rpt);
        fill<W, 3>(ring.stage(s), slot, src, row0 * c, nrows * c,
                   &ring.bars[s]);
    };
    for (int s = 0; s < stages; ++s) {
        const int64_t tile = blockIdx.x + (int64_t)s * gridDim.x;
        if (tile < tiles) load(tile, s);
    }
    const int ch0 = (W * threadIdx.x) % c, step = (W * kThreads) % c;
    for (int j = 0;; ++j) {
        const int64_t tile = blockIdx.x + (int64_t)j * gridDim.x;
        if (tile >= tiles) break;
        const int s = j % stages;
        bar_wait(&ring.bars[s], (j / stages) & 1);
        float* xs = ring.stage(s);
        float* ds = xs + slot;   // d, then a = dy (d d^(-beta-1))
        float* ts = ds + slot;   // dy, then t = (dy x) d^(-beta-1)
        const int64_t row0 = tile * rpt;
        const int nrows = (int)(rows - row0 < rpt ? rows - row0 : rpt);
        const int elems = nrows * c;
        const int64_t base = row0 * c;
        for (int e = W * threadIdx.x; e < elems; e += W * kThreads) {
            float xv[W], dv[W], gv[W], t[W], a[W];
            ld<W>(xs + e, xv);
            ld<W>(ds + e, dv);
            ld<W>(ts + e, gv);
            bwd_terms<W>(xv, dv, gv, neg_beta_1, t, a);
            sts<W>(ts + e, t);
            sts<W>(ds + e, a);
        }
        __syncthreads();
        int ch = ch0;
        for (int e = W * threadIdx.x; e < elems; e += W * kThreads) {
            float inner[W], xv[W], a[W], out[W];
            // i is in j's window  <=>  i - hi <= j <= i + lo
            window_sums<N, W, false>(ts + e, ch, c, hi, lo, inner);
            ld<W>(xs + e, xv);
            ld<W>(ds + e, a);
            bwd_out<W>(a, xv, inner, coef, out);
            st_stream<W>(dx + base + e, out);
            ch += step;
            if (ch >= c) ch -= c;
        }
        if constexpr (W == 4) fence_proxy_async();
        __syncthreads();
        const int64_t next = tile + (int64_t)stages * gridDim.x;
        if (next < tiles) load(next, s);
    }
}

// ------------------------------------------- rows too wide for the ring
template <int W>
__global__ void __launch_bounds__(kThreads)
    lrn_fwd_wide_kernel(const float* __restrict__ x, float* __restrict__ y,
                        float* __restrict__ d, int64_t rows, int c, int n,
                        float alpha_n, float neg_beta, float k) {
    extern __shared__ __align__(16) float smem[];
    const int lo = n / 2, hi = n - 1 - n / 2;
    for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
        const int64_t base = row * c;
        for (int e = W * threadIdx.x; e < c; e += W * kThreads) {
            float v[W];
            ld<W>(x + base + e, v);
            sts<W>(smem + e, v);
        }
        __syncthreads();
        for (int e = W * threadIdx.x; e < c; e += W * kThreads)
            fwd_at<0, W>(smem + e, e, c, lo, hi, alpha_n, neg_beta, k,
                         y + base + e, d + base + e);
        __syncthreads();
    }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
    lrn_bwd_wide_kernel(const float* __restrict__ x,
                        const float* __restrict__ d,
                        const float* __restrict__ dy, float* dx,
                        int64_t rows, int c, int n, float neg_beta_1,
                        float coef) {
    extern __shared__ __align__(16) float smem[];
    const int lo = n / 2, hi = n - 1 - n / 2;
    for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
        const int64_t base = row * c;
        for (int e = W * threadIdx.x; e < c; e += W * kThreads) {
            float xv[W], dv[W], gv[W], t[W], a[W];
            ld<W>(x + base + e, xv);
            ld<W>(d + base + e, dv);
            ld<W>(dy + base + e, gv);
            bwd_terms<W>(xv, dv, gv, neg_beta_1, t, a);
            sts<W>(smem + e, t);
            // a waits in dx for this same thread's phase 2
            if constexpr (W == 4)
                *reinterpret_cast<float4*>(dx + base + e) =
                    make_float4(a[0], a[1], a[2], a[3]);
            else
                dx[base + e] = a[0];
        }
        __syncthreads();
        for (int e = W * threadIdx.x; e < c; e += W * kThreads) {
            float inner[W], xv[W], a[W], out[W];
            window_sums<0, W, false>(smem + e, e, c, hi, lo, inner);
            ld<W>(x + base + e, xv);
            ld<W>(dx + base + e, a);
            bwd_out<W>(a, xv, inner, coef, out);
            st_stream<W>(dx + base + e, out);
        }
        __syncthreads();
    }
}

// ---------------------------------------------------------------- planning
// How a call is launched: the quad width, the template's n (0: runtime),
// whether the row is too wide for the ring, rows a tile, shared floats a
// slot, stages, shared bytes and blocks.
struct Plan {
    int width, templ_n, wide, rpt, slot, stages;
    size_t smem;
    unsigned blocks;
};

int sm_count() {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms > 0 ? sms : 1;
}

template <typename Kernel>
cudaError_t occupancy(Kernel kernel, size_t smem, int* per_sm) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                        kThreads, smem);
    if (err == cudaSuccess && *per_sm < 1) err = cudaErrorInvalidValue;
    return err;
}

// Ring plan for `ops` operands a stage and a target of `tile` elements a
// tile; the grid is SMs x occupancy, and rows a tile are cut so that every
// block walks the same number of tiles, give or take one.  p->wide when
// two stages of one row do not fit.
template <typename RingKernel, typename WideKernel>
cudaError_t plan(RingKernel ring_kernel, WideKernel wide_kernel,
                 int64_t rows, int c, int ops, int tile, Plan* p) {
    const int rpt0 = tile / c > 0 ? tile / c : 1;
    p->slot = (rpt0 * c + 3) / 4 * 4;
    const size_t stage = (size_t)p->slot * 4 * ops;
    p->stages = kStages;
    while (p->stages > 2 && p->stages * (stage + 8) > kMaxSmem) --p->stages;
    int per_sm = 0;
    cudaError_t err;
    p->wide = p->stages * (stage + 8) > kMaxSmem;
    if (p->wide) {
        p->rpt = 1;
        p->stages = 0;
        p->smem = (size_t)p->slot * 4;
        err = occupancy(wide_kernel, p->smem, &per_sm);
        if (err != cudaSuccess) return err;
        const int64_t grid = (int64_t)sm_count() * per_sm;
        p->blocks = (unsigned)(rows < grid ? rows : grid);
        return cudaSuccess;
    }
    p->smem = p->stages * (stage + 8);
    err = occupancy(ring_kernel, p->smem, &per_sm);
    if (err != cudaSuccess) return err;
    const int64_t grid = (int64_t)sm_count() * per_sm;
    const int64_t tiles0 = (rows + rpt0 - 1) / rpt0;
    if (tiles0 <= grid) {
        p->rpt = rpt0;
        p->blocks = (unsigned)tiles0;
    } else {
        const int64_t rounds = (tiles0 + grid - 1) / grid;
        p->rpt = (int)((rows + grid * rounds - 1) / (grid * rounds));
        const int64_t tiles = (rows + p->rpt - 1) / p->rpt;
        p->blocks = (unsigned)(tiles < grid ? tiles : grid);
    }
    return cudaSuccess;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <int N, int W>
cudaError_t fwd_plan(int64_t rows, int c, Plan* p) {
    p->width = W;
    p->templ_n = N;
    return plan(lrn_fwd_kernel<N, W>, lrn_fwd_wide_kernel<W>, rows, c, 1,
                kFwdTile, p);
}

template <int N, int W>
cudaError_t bwd_plan(int64_t rows, int c, Plan* p) {
    p->width = W;
    p->templ_n = N;
    return plan(lrn_bwd_kernel<N, W>, lrn_bwd_wide_kernel<W>, rows, c, 3,
                kBwdTile, p);
}

template <int N, int W>
int fwd_launch(const float* x, float* y, float* d, int64_t rows, int c,
               int n, float alpha_n, float neg_beta, float k,
               cudaStream_t stream) {
    Plan p;
    cudaError_t err = fwd_plan<N, W>(rows, c, &p);
    if (err != cudaSuccess) return (int)err;
    if (p.wide)
        lrn_fwd_wide_kernel<W><<<p.blocks, kThreads, p.smem, stream>>>(
            x, y, d, rows, c, n, alpha_n, neg_beta, k);
    else
        lrn_fwd_kernel<N, W><<<p.blocks, kThreads, p.smem, stream>>>(
            x, y, d, rows, c, p.rpt, p.slot, p.stages, n, alpha_n, neg_beta,
            k);
    return (int)cudaGetLastError();
}

template <int N, int W>
int bwd_launch(const float* x, const float* d, const float* dy, float* dx,
               int64_t rows, int c, int n, float neg_beta_1, float coef,
               cudaStream_t stream) {
    Plan p;
    cudaError_t err = bwd_plan<N, W>(rows, c, &p);
    if (err != cudaSuccess) return (int)err;
    if (p.wide)
        lrn_bwd_wide_kernel<W><<<p.blocks, kThreads, p.smem, stream>>>(
            x, d, dy, dx, rows, c, n, neg_beta_1, coef);
    else
        lrn_bwd_kernel<N, W><<<p.blocks, kThreads, p.smem, stream>>>(
            x, d, dy, dx, rows, c, p.rpt, p.slot, p.stages, n, neg_beta_1,
            coef);
    return (int)cudaGetLastError();
}

bool bad_args(long long rows, int c, int n) {
    return n < 1 || (int64_t)rows * c / c != rows ||
           (size_t)(c + 3) / 4 * 16 > kMaxSmem;
}

}  // namespace

extern "C" {

int lrn_forward_f32(const float* x, float* y, float* d, long long rows, int c,
                    int n, float alpha_n, float neg_beta, float k,
                    void* stream) {
    if (rows <= 0 || c <= 0) return 0;
    if (bad_args(rows, c, n)) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    const bool vec = c % 4 == 0 && aligned16(x) && aligned16(y) &&
                     aligned16(d);
    if (n == 5)
        return vec ? fwd_launch<5, 4>(x, y, d, rows, c, n, alpha_n, neg_beta,
                                      k, s)
                   : fwd_launch<5, 1>(x, y, d, rows, c, n, alpha_n, neg_beta,
                                      k, s);
    return vec ? fwd_launch<0, 4>(x, y, d, rows, c, n, alpha_n, neg_beta, k,
                                  s)
               : fwd_launch<0, 1>(x, y, d, rows, c, n, alpha_n, neg_beta, k,
                                  s);
}

int lrn_backward_f32(const float* x, const float* d, const float* dy,
                     float* dx, long long rows, int c, int n,
                     float neg_beta_1, float coef, void* stream) {
    if (rows <= 0 || c <= 0) return 0;
    if (bad_args(rows, c, n)) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    const bool vec = c % 4 == 0 && aligned16(x) && aligned16(d) &&
                     aligned16(dy) && aligned16(dx);
    if (n == 5)
        return vec ? bwd_launch<5, 4>(x, d, dy, dx, rows, c, n, neg_beta_1,
                                      coef, s)
                   : bwd_launch<5, 1>(x, d, dy, dx, rows, c, n, neg_beta_1,
                                      coef, s);
    return vec ? bwd_launch<0, 4>(x, d, dy, dx, rows, c, n, neg_beta_1, coef,
                                  s)
               : bwd_launch<0, 1>(x, d, dy, dx, rows, c, n, neg_beta_1, coef,
                                  s);
}

// The launch a call would take: out = {width, template n, wide, rows a
// tile, stages, blocks, shared bytes}.  vec: C % 4 == 0 and every pointer
// 16-byte aligned.
int lrn_plan_info(long long rows, int c, int n, int vec, int backward,
                  long long* out) {
    if (rows <= 0 || c <= 0 || bad_args(rows, c, n))
        return (int)cudaErrorInvalidValue;
    vec = vec && c % 4 == 0;
    Plan p;
    cudaError_t err;
    if (backward)
        err = n == 5 ? (vec ? bwd_plan<5, 4>(rows, c, &p)
                            : bwd_plan<5, 1>(rows, c, &p))
                     : (vec ? bwd_plan<0, 4>(rows, c, &p)
                            : bwd_plan<0, 1>(rows, c, &p));
    else
        err = n == 5 ? (vec ? fwd_plan<5, 4>(rows, c, &p)
                            : fwd_plan<5, 1>(rows, c, &p))
                     : (vec ? fwd_plan<0, 4>(rows, c, &p)
                            : fwd_plan<0, 1>(rows, c, &p));
    if (err != cudaSuccess) return (int)err;
    if (p.wide) p.templ_n = 0;
    const long long v[7] = {p.width, p.templ_n, p.wide, p.rpt, p.stages,
                            (long long)p.blocks, (long long)p.smem};
    for (int i = 0; i < 7; ++i) out[i] = v[i];
    return 0;
}

const char* lrn_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
