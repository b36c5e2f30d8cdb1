// Inverted dropout, and Bernoulli draws from a tensor of probabilities, with
// an in-kernel threefry2x32 stream, for Hopper (sm_90a).
//
//   dropout   replaces veles_tpu/ops/pallas_kernels.py:272 (dropout, kernel
//             _dropout_kernel at :260, launched at :309)
//   bernoulli no TPU kernel: jax.random.bernoulli(key, p) for a tensor p,
//             which the RBM's step draws (veles_tpu/ops/rbm.py:64-65,
//             veles_tpu/ops/functional.py:591) and XLA computes there
//
// out_i = keep_i ? x_i / p : 0 with p the keep probability (float32), and
// keep_i = u_i < p, u_i the float32 in [0, 1) that jax.random.uniform makes
// from 32 random bits: bitcast((bits >> 9) | 0x3f800000) - 1.  The bits are
// jax's partitionable threefry stream: element i (flat index) hashes the
// counter (hi(i), lo(i)) under the key (k0, k1), 20 rounds, and bits =
// out0 ^ out1.  So the mask is jax.random.bernoulli(key, p, shape) bit for
// bit, the contract of the Pallas wrapper's off-TPU branch (:286-293) and of
// veles_tpu/ops/functional.py::dropout; the TPU branch's hardware PRNG has
// no counterpart off the TPU.  x / p is a division, as in those branches
// (not the TPU branch's multiply by 1/p), so the output is bit-equal too.
// The backward is this kernel on dy with the same key: no mask is stored.
//
// The key comes in as two uint32 values by value (a host value; nothing is
// read back from the card).  Bound on the H100: operations — about 80
// integer operations an element for the hash against 8 bytes moved.
// Design: one element per thread per grid-stride step, rotations by
// __funnelshift_l, the key schedule in registers.
//
// bernoulli: out_i = u_i < p_i ? 1 : 0 in float32, u_i the same uniform of
// the same threefry stream, so out is jax.random.bernoulli(key, p)
// .astype(float32) bit for bit for a contiguous fp32 p (the flat index is
// jax's row-major counter).  p = 0 never draws 1 and p = 1 always does
// (u < 1).  Bound: operations, as dropout's (8 bytes an element: p read,
// out written).
//
// Plain C interface (loaded with ctypes): the entry point launches on the
// given stream and returns cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
    return __funnelshift_l(v, v, r);
}

// The four rounds of one key-schedule step, rotations r0..r3.
#define THREEFRY_ROUNDS(r0, r1, r2, r3)                 \
    x0 += x1; x1 = rotl(x1, r0); x1 ^= x0;              \
    x0 += x1; x1 = rotl(x1, r1); x1 ^= x0;              \
    x0 += x1; x1 = rotl(x1, r2); x1 ^= x0;              \
    x0 += x1; x1 = rotl(x1, r3); x1 ^= x0;

__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t k2, uint32_t x0,
                                                  uint32_t x1) {
    x0 += k0;
    x1 += k1;
    THREEFRY_ROUNDS(13, 15, 26, 6)
    x0 += k1; x1 += k2 + 1u;
    THREEFRY_ROUNDS(17, 29, 16, 24)
    x0 += k2; x1 += k0 + 2u;
    THREEFRY_ROUNDS(13, 15, 26, 6)
    x0 += k0; x1 += k1 + 3u;
    THREEFRY_ROUNDS(17, 29, 16, 24)
    x0 += k1; x1 += k2 + 4u;
    THREEFRY_ROUNDS(13, 15, 26, 6)
    x0 += k2; x1 += k0 + 5u;
    return x0 ^ x1;
}

__global__ void dropout_kernel(const float* __restrict__ x,
                               float* __restrict__ out, int64_t n,
                               uint32_t k0, uint32_t k1, float keep) {
    const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        const uint32_t bits = threefry_bits(
            k0, k1, k2, (uint32_t)((uint64_t)i >> 32), (uint32_t)i);
        const float u =
            __fsub_rn(__uint_as_float((bits >> 9) | 0x3f800000u), 1.0f);
        out[i] = u < keep ? __fdiv_rn(x[i], keep) : 0.0f;
    }
}

__global__ void bernoulli_kernel(const float* __restrict__ p,
                                 float* __restrict__ out, int64_t n,
                                 uint32_t k0, uint32_t k1) {
    const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        const uint32_t bits = threefry_bits(
            k0, k1, k2, (uint32_t)((uint64_t)i >> 32), (uint32_t)i);
        const float u =
            __fsub_rn(__uint_as_float((bits >> 9) | 0x3f800000u), 1.0f);
        out[i] = u < p[i] ? 1.0f : 0.0f;
    }
}

int64_t grid_for(int64_t n) {
    int64_t blocks = (n + kThreads - 1) / kThreads;
    return blocks > kMaxBlocks ? kMaxBlocks : blocks;
}

}  // namespace

extern "C" {

int dropout_f32(const float* x, float* out, long long n, unsigned k0,
                unsigned k1, float keep, void* stream) {
    if (n <= 0) return 0;
    dropout_kernel<<<(unsigned)grid_for(n), kThreads, 0,
                     (cudaStream_t)stream>>>(x, out, n, k0, k1, keep);
    return (int)cudaGetLastError();
}

int bernoulli_f32(const float* p, float* out, long long n, unsigned k0,
                  unsigned k1, void* stream) {
    if (n <= 0) return 0;
    bernoulli_kernel<<<(unsigned)grid_for(n), kThreads, 0,
                       (cudaStream_t)stream>>>(p, out, n, k0, k1);
    return (int)cudaGetLastError();
}

const char* dropout_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
