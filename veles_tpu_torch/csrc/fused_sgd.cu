// Fused momentum-SGD update for Hopper (sm_90a): every momentum update of
// the training path, a whole step's tensors in one launch.
//
//   fused_sgd_update   replaces veles_tpu/ops/pallas_kernels.py:92
//                      (fused_sgd_update, kernel _sgd_kernel at :79).
//
// One elementwise pass over each listed parameter p, its velocity v and its
// batch-SUM gradient g (all fp32, same length n per tensor), writing NEW
// tensors p' and v' (out of place: the training step holds the update
// pending until Decision commits it, so p and v must survive):
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
// for under ten flops — far below the fp32 ridge.  A training step's
// tensors are few and, in the small models, short (MNIST-FC: four tensors,
// 79,510 elements, ~0.12 us of bytes), so one launch per tensor costs more
// than the bytes.  What the design does about both: one launch updates up
// to kMaxTensors tensors, described by a table passed BY VALUE as the
// kernel's parameter (no host-to-device copy, no sync); each tensor owns a
// contiguous run of blocks (a prefix of per-tensor block counts in the
// table maps a block to its tensor), each block a chunk of kUnroll float4
// groups a thread, all loads of a thread issued before its arithmetic.  A
// tensor whose five pointers are 16-byte aligned takes 16-byte accesses
// (its ragged tail, n % 4 elements, by its first block); any other tensor
// takes the scalar loop alone.  Each element is read and written once.
//
// Plain C interface (loaded with ctypes): the entry point launches on the
// given stream and returns cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct SgdScalars {
    float inv_batch, lr, momentum, weight_decay, l1, one_minus_l1, clip;
};

// One tensor of a launch: 80 bytes.
struct SgdTensor {
    const float* p;
    const float* v;
    const float* g;
    float* p_out;
    float* v_out;
    long long n;
    SgdScalars s;
    int vec;                 // 16-byte accesses (all five pointers aligned)
};

constexpr int kMaxTensors = 48;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;                   // float4 groups (or floats) a thread
constexpr int kChunk = kThreads * kUnroll;   // units a block

// The launch's parameter: 4 + 49 * 4 + 48 * 80 = 4040 bytes, inside the
// 4 KB that a kernel parameter may take on every CUDA 12 toolkit.
struct SgdTable {
    int count;
    int block_start[kMaxTensors + 1];        // prefix of per-tensor blocks
    SgdTensor t[kMaxTensors];
};
static_assert(sizeof(SgdTable) <= 4096, "the table must fit a parameter");

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

// Block b updates chunk (b - block_start[k]) of tensor k, the k with
// block_start[k] <= b < block_start[k + 1].
__global__ void __launch_bounds__(kThreads)
fused_sgd_kernel(const __grid_constant__ SgdTable table) {
    const int b = blockIdx.x;
    // the last k with block_start[k] <= b, by bisection (uniform a block)
    int k = 0, hi = table.count - 1;
    while (k < hi) {
        const int mid = (k + hi + 1) >> 1;
        if (table.block_start[mid] <= b) k = mid;
        else hi = mid - 1;
    }
    const SgdTensor& t = table.t[k];
    const SgdScalars s = t.s;
    const long long first =
        (long long)(b - table.block_start[k]) * kChunk + threadIdx.x;
    if (t.vec) {
        const long long n4 = t.n / 4;
        const float4* p4 = reinterpret_cast<const float4*>(t.p);
        const float4* v4 = reinterpret_cast<const float4*>(t.v);
        const float4* g4 = reinterpret_cast<const float4*>(t.g);
        float4* po4 = reinterpret_cast<float4*>(t.p_out);
        float4* vo4 = reinterpret_cast<float4*>(t.v_out);
        float4 a[kUnroll], c[kUnroll], d[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const long long i = first + (long long)u * kThreads;
            if (i < n4) {
                a[u] = p4[i];
                c[u] = v4[i];
                d[u] = g4[i];
            }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const long long i = first + (long long)u * kThreads;
            if (i < n4) {
                float4 pa, va;
                sgd_element(a[u].x, c[u].x, d[u].x, s, pa.x, va.x);
                sgd_element(a[u].y, c[u].y, d[u].y, s, pa.y, va.y);
                sgd_element(a[u].z, c[u].z, d[u].z, s, pa.z, va.z);
                sgd_element(a[u].w, c[u].w, d[u].w, s, pa.w, va.w);
                po4[i] = pa;
                vo4[i] = va;
            }
        }
        // the ragged tail: at most three elements, by the first block
        const long long tail = 4 * n4 + threadIdx.x;
        if (b == table.block_start[k] && tail < t.n)
            sgd_element(t.p[tail], t.v[tail], t.g[tail], s, t.p_out[tail],
                        t.v_out[tail]);
        return;
    }
    float a[kUnroll], c[kUnroll], d[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
        const long long i = first + (long long)u * kThreads;
        if (i < t.n) {
            a[u] = t.p[i];
            c[u] = t.v[i];
            d[u] = t.g[i];
        }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
        const long long i = first + (long long)u * kThreads;
        if (i < t.n) sgd_element(a[u], c[u], d[u], s, t.p_out[i], t.v_out[i]);
    }
}

}  // namespace

extern "C" {

// The most tensors one launch takes; a longer list is split by the caller.
int fused_sgd_max_tensors() { return kMaxTensors; }

// Update `count` tensors in one launch.  ptrs holds five pointers a tensor
// (p, v, g, p_out, v_out), n the lengths, scalars seven a tensor (inv_batch,
// lr, momentum, weight_decay, l1, one_minus_l1, clip).  Tensors of length 0
// take no block; a list of only those launches nothing.
int fused_sgd_update_multi_f32(const unsigned long long* ptrs,
                               const long long* n, const float* scalars,
                               int count, void* stream) {
    if (count < 0 || count > kMaxTensors) return (int)cudaErrorInvalidValue;
    SgdTable table = {};
    long long blocks = 0;
    for (int k = 0; k < count; ++k) {
        SgdTensor& t = table.t[table.count];
        const unsigned long long* pk = ptrs + 5 * k;
        const float* sk = scalars + 7 * k;
        if (n[k] <= 0) continue;
        t.p = reinterpret_cast<const float*>(pk[0]);
        t.v = reinterpret_cast<const float*>(pk[1]);
        t.g = reinterpret_cast<const float*>(pk[2]);
        t.p_out = reinterpret_cast<float*>(pk[3]);
        t.v_out = reinterpret_cast<float*>(pk[4]);
        t.n = n[k];
        t.s = SgdScalars{sk[0], sk[1], sk[2], sk[3], sk[4], sk[5], sk[6]};
        t.vec = ((pk[0] | pk[1] | pk[2] | pk[3] | pk[4]) % 16) == 0;
        const long long units = t.vec ? t.n / 4 : t.n;
        const long long tb = units > 0 ? (units + kChunk - 1) / kChunk : 1;
        table.block_start[table.count] = (int)blocks;
        blocks += tb;
        if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
        ++table.count;
    }
    if (table.count == 0) return 0;
    table.block_start[table.count] = (int)blocks;
    fused_sgd_kernel<<<(unsigned)blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(table);
    return (int)cudaGetLastError();
}

const char* fused_sgd_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
