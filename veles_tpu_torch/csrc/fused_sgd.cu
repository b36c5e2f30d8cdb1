// Fused momentum-SGD update for Hopper (sm_90a): every momentum update of
// the training path.
//
//   fused_sgd_update   replaces veles_tpu/ops/pallas_kernels.py:92
//                      (fused_sgd_update, kernel _sgd_kernel at :79).
//
// One elementwise pass over a parameter p, its velocity v and its batch-SUM
// gradient g (all fp32, same length n), writing NEW tensors p' and v' (out
// of place: the training step holds the update pending until Decision
// commits it, so p and v must survive):
//
//   gn = g * inv_batch                              (inv_batch = 1/max(batch,1))
//   clip > 0:  gn = clamp(gn, -clip, clip);  wd != 0:  gn = fma(wd, d, gn)
//   clip off:  wd != 0:  gn = fma(g, inv_batch, wd * d)
//   d  = fma(1 - l1, p, l1 * sign(p))               (mixed L1/L2 decay)
//   v' = fma(m, v, -(lr * gn))
//   p' = p + v'
//
// With the clip off this is the Pallas kernel's function operation for
// operation, in the order XLA compiles it (it contracts each product that
// feeds an add into one fused multiply-add, as written above; measured bit
// for bit against the kernel in interpret mode).  Every operation is an
// explicit round-to-nearest intrinsic, so nvcc contracts nothing else and
// the build flags do not matter.  The Pallas kernel has no clip path (JAX
// routes a clipped update to XLA); here the clip is a runtime scalar, so
// every momentum update on the card has this one route.
//
// Bound on the H100: bytes.  Per element it reads 12 bytes and writes 8
// for under ten flops — far below the fp32 ridge.  What the design does
// about it: one pass, each element read and written once, 16-byte vector
// loads and stores where every pointer is 16-byte aligned, a grid-stride
// loop over enough blocks to fill the card, and a scalar loop for the
// ragged tail.  At MNIST-FC's shapes (79,510 elements over four tensors)
// the launches are latency-bound; folding them into one multi-tensor
// launch is later work.
//
// Plain C interface (loaded with ctypes): the entry point launches on the
// given stream and returns cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct SgdScalars {
    float inv_batch, lr, momentum, weight_decay, l1, one_minus_l1, clip;
};

__device__ __forceinline__ float sign_of(float p) {
    // jnp.sign: -1, 0 or 1, NaN stays NaN
    return p > 0.f ? 1.f : (p < 0.f ? -1.f : p);
}

__device__ __forceinline__ void sgd_element(float p, float v, float g,
                                            const SgdScalars& s, float& p_out,
                                            float& v_out) {
    float gn;
    if (s.clip > 0.f) {
        gn = __fmul_rn(g, s.inv_batch);
        gn = gn < -s.clip ? -s.clip : (gn > s.clip ? s.clip : gn);
        if (s.weight_decay != 0.f) {
            float d = __fmaf_rn(s.one_minus_l1, p, __fmul_rn(s.l1, sign_of(p)));
            gn = __fmaf_rn(s.weight_decay, d, gn);
        }
    } else if (s.weight_decay != 0.f) {
        float d = __fmaf_rn(s.one_minus_l1, p, __fmul_rn(s.l1, sign_of(p)));
        gn = __fmaf_rn(g, s.inv_batch, __fmul_rn(s.weight_decay, d));
    } else {
        gn = __fmul_rn(g, s.inv_batch);
    }
    v_out = __fmaf_rn(s.momentum, v, -__fmul_rn(s.lr, gn));
    p_out = __fadd_rn(p, v_out);
}

// n4 float4 groups through 16-byte accesses (vec == true; the pointers are
// aligned), then the n - 4*n4 tail elements one by one.
__global__ void fused_sgd_kernel(const float* __restrict__ p,
                                 const float* __restrict__ v,
                                 const float* __restrict__ g,
                                 float* __restrict__ p_out,
                                 float* __restrict__ v_out, int64_t n,
                                 int64_t n4, SgdScalars s) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const float4* v4 = reinterpret_cast<const float4*>(v);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* po4 = reinterpret_cast<float4*>(p_out);
    float4* vo4 = reinterpret_cast<float4*>(v_out);
    for (int64_t i = first; i < n4; i += stride) {
        float4 a = p4[i], b = v4[i], c = g4[i], pa, va;
        sgd_element(a.x, b.x, c.x, s, pa.x, va.x);
        sgd_element(a.y, b.y, c.y, s, pa.y, va.y);
        sgd_element(a.z, b.z, c.z, s, pa.z, va.z);
        sgd_element(a.w, b.w, c.w, s, pa.w, va.w);
        po4[i] = pa;
        vo4[i] = va;
    }
    for (int64_t i = 4 * n4 + first; i < n; i += stride) {
        sgd_element(p[i], v[i], g[i], s, p_out[i], v_out[i]);
    }
}

constexpr int kThreads = 256;
// enough resident blocks to fill 132 SMs several times over; the
// grid-stride loop covers the rest
constexpr int64_t kMaxBlocks = 132 * 8;

}  // namespace

extern "C" {

int fused_sgd_update_f32(const float* p, const float* v, const float* g,
                         float* p_out, float* v_out, long long n,
                         float inv_batch, float lr, float momentum,
                         float weight_decay, float l1, float one_minus_l1,
                         float clip, void* stream) {
    if (n <= 0) return 0;
    SgdScalars s{inv_batch, lr, momentum, weight_decay, l1, one_minus_l1,
                 clip};
    const uintptr_t bits = (uintptr_t)p | (uintptr_t)v | (uintptr_t)g |
                           (uintptr_t)p_out | (uintptr_t)v_out;
    const int64_t n4 = (bits % 16 == 0) ? n / 4 : 0;
    const int64_t work = n4 > 0 ? n4 : n;
    int64_t blocks = (work + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    fused_sgd_kernel<<<(unsigned)blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(p, v, g, p_out, v_out, n, n4,
                                               s);
    return (int)cudaGetLastError();
}

const char* fused_sgd_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
