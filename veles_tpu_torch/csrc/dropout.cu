// Inverted dropout, Bernoulli draws from a tensor of probabilities, and the
// seeded gumbel-max draw of a token a row of logits, with an in-kernel
// threefry2x32 stream, for Hopper (sm_90a).
//
//   dropout      replaces veles_tpu/ops/pallas_kernels.py:272 (dropout,
//                kernel _dropout_kernel at :260, launched at :309)
//   bernoulli    no TPU kernel: jax.random.bernoulli(key, p) for a tensor
//                p, which the RBM's step draws (veles_tpu/ops/rbm.py:64-65,
//                veles_tpu/ops/functional.py:591) and XLA computes there
//   sample_token no TPU kernel: temperature / top-k sampling (below)
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
// An element offset o (int64, 0 for a whole tensor) makes element i hash
// the counter of i + o: a data-parallel rank whose rows start at flat
// element o of the global batch draws exactly those rows of the global
// mask, as a sharded run of jax's partitionable threefry does
// (veles_tpu/compat.py:11-26).
//
// The key comes in as two uint32 values by value (a host value; nothing is
// read back from the card), or, through dropout_dev_f32, as a pointer to two
// uint32 words on the card that each thread reads before its loop: the same
// kernel body, so the mask is bit-equal for an equal key.  That entry is for
// a CUDA graph, which keeps by-value parameters as they were at capture; the
// Pallas kernel takes its seed as a scalar-prefetch operand the same way
// (pallas_kernels.py:260).  Bound on the H100: operations — about 80
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
// sample_token: no TPU kernel either.  The seeded temperature / top-k draw
// of one token a row, jax.random.categorical(key, lg / T) after the top-k
// mask of veles_tpu/ops/transformer.py:494-536 (_make_sampler,
// sample_token), which XLA computes inside the reference's decode
// programs.  One block a row of V logits:
//   1. the row's key: the given key, or (the serving engine's mode, the
//      reference's _make_pick in veles_tpu/serving/lm_engine.py:895-915)
//      fold_in(fold_in(base, seed[r]), pos[r]), each fold_in the hash of
//      the counter (0, data) whose two output words are the new key;
//   2. element i's 32 bits at counter offset(r) + i, with offset(r) = 0
//      under a row's own key and r * V under one key for the whole
//      (rows, V) draw (generate's mode: jax's flat row-major counter);
//   3. jax's uniform(minval=tiny, maxval=1.): maxval - minval rounds to
//      1.0f, so u = max(tiny, f + tiny), f the unit float of the bits;
//      then the gumbel draw g = -log(-log(u)) with the full-precision
//      logf (this file builds without --use_fast_math, never __logf);
//   4. lg_i kept where lg_i >= thr[r] (the k-th largest value of the row,
//      found before the launch; ties at the cutoff stay eligible), else
//      -1e30 (NEG_INF_LOGIT);
//   5. s_i = lg_i / T as an IEEE division (not a multiply by 1/T), and
//      v_i = g_i + s_i;
//   6. out[r] = argmax v, the lowest index on ties (jnp.argmax's rule),
//      by a block reduction of (value, index) pairs.
// Bound: operations (the hash of every element, as dropout's, and two
// logf) against 4 bytes an element read.

// Plain C interface (loaded with ctypes): the entry point launches on the
// given stream and returns cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <math.h>
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

// The hash of the counter words (x0, x1) under (k0, k1), k2 the key
// schedule's third word; the two output words land in x0, x1.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t k2, uint32_t& x0,
                                             uint32_t& x1) {
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
}

__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t k2, uint32_t x0,
                                                  uint32_t x1) {
    threefry2x32(k0, k1, k2, x0, x1);
    return x0 ^ x1;
}

// jax.random.fold_in: the key (k0, k1) becomes the hash of (0, data).
__device__ __forceinline__ void fold_in(uint32_t& k0, uint32_t& k1,
                                        uint32_t data) {
    uint32_t x0 = 0u, x1 = data;
    threefry2x32(k0, k1, k0 ^ k1 ^ 0x1BD11BDAu, x0, x1);
    k0 = x0;
    k1 = x1;
}

// key: null for the by-value words k0, k1, else two words on the card.
__global__ void dropout_kernel(const float* __restrict__ x,
                               float* __restrict__ out, int64_t n,
                               uint32_t k0, uint32_t k1, float keep,
                               const uint32_t* __restrict__ key,
                               int64_t offset) {
    if (key != nullptr) {
        k0 = key[0];
        k1 = key[1];
    }
    const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        const uint64_t c = (uint64_t)(i + offset);
        const uint32_t bits =
            threefry_bits(k0, k1, k2, (uint32_t)(c >> 32), (uint32_t)c);
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

// (value, index) of the better of two candidates: the larger value, the
// lower index on a tie (a NaN never wins).
__device__ __forceinline__ void better(float& v, int& i, float v2, int i2) {
    if (v2 > v || (v2 == v && i2 < i)) {
        v = v2;
        i = i2;
    }
}

constexpr int kSampleThreads = 256;
constexpr float kTiny = 1.17549435e-38f;      // FLT_MIN, jax's minval
constexpr float kNegInfLogit = -1e30f;

// One block a row; see the header.  seeds == nullptr: (k0, k1) is the
// row's key with counters r * vocab + i; else the base key, folded with
// seeds[r] then pos[r], counters i.  thr == nullptr: no top-k mask, else
// row r's k-th largest value is thr[r * thr_stride].
__global__ void __launch_bounds__(kSampleThreads)
sample_token_kernel(const float* __restrict__ logits, int vocab,
                    const float* __restrict__ thr, int thr_stride,
                    float temperature,
                    uint32_t k0, uint32_t k1, const int* __restrict__ seeds,
                    const int* __restrict__ pos, int* __restrict__ out) {
    const int64_t r = blockIdx.x;
    int64_t offset = r * vocab;
    if (seeds != nullptr) {
        fold_in(k0, k1, (uint32_t)seeds[r]);
        fold_in(k0, k1, (uint32_t)pos[r]);
        offset = 0;
    }
    const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
    const float* row = logits + r * vocab;
    const float cut = thr != nullptr ? thr[r * thr_stride] : 0.0f;
    float best = -INFINITY;
    int best_i = 0x7fffffff;
    for (int i = threadIdx.x; i < vocab; i += blockDim.x) {
        float lg = row[i];
        if (thr != nullptr && !(lg >= cut)) lg = kNegInfLogit;
        const float s = __fdiv_rn(lg, temperature);
        const uint64_t c = (uint64_t)(offset + i);
        const uint32_t bits =
            threefry_bits(k0, k1, k2, (uint32_t)(c >> 32), (uint32_t)c);
        const float f =
            __fsub_rn(__uint_as_float((bits >> 9) | 0x3f800000u), 1.0f);
        const float u = fmaxf(kTiny, __fadd_rn(f, kTiny));
        const float g = -logf(-logf(u));
        better(best, best_i, __fadd_rn(g, s), i);
    }
    for (int d = 16; d > 0; d >>= 1) {
        better(best, best_i, __shfl_down_sync(0xffffffffu, best, d),
               __shfl_down_sync(0xffffffffu, best_i, d));
    }
    __shared__ float vals[kSampleThreads / 32];
    __shared__ int idxs[kSampleThreads / 32];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane == 0) {
        vals[warp] = best;
        idxs[warp] = best_i;
    }
    __syncthreads();
    if (warp == 0) {
        const int n = blockDim.x / 32;
        best = lane < n ? vals[lane] : -INFINITY;
        best_i = lane < n ? idxs[lane] : 0x7fffffff;
        for (int d = 16; d > 0; d >>= 1) {
            better(best, best_i, __shfl_down_sync(0xffffffffu, best, d),
                   __shfl_down_sync(0xffffffffu, best_i, d));
        }
        if (lane == 0) out[r] = best_i;
    }
}

int64_t grid_for(int64_t n) {
    int64_t blocks = (n + kThreads - 1) / kThreads;
    return blocks > kMaxBlocks ? kMaxBlocks : blocks;
}

}  // namespace

extern "C" {

int dropout_f32(const float* x, float* out, long long n, unsigned k0,
                unsigned k1, float keep, long long offset, void* stream) {
    if (n <= 0) return 0;
    if (offset < 0) return (int)cudaErrorInvalidValue;
    dropout_kernel<<<(unsigned)grid_for(n), kThreads, 0,
                     (cudaStream_t)stream>>>(x, out, n, k0, k1, keep,
                                             nullptr, offset);
    return (int)cudaGetLastError();
}

// dropout_f32 with the key read on the card from key[0], key[1].
int dropout_dev_f32(const float* x, float* out, long long n,
                    const unsigned* key, float keep, long long offset,
                    void* stream) {
    if (n <= 0) return 0;
    if (key == nullptr || offset < 0) return (int)cudaErrorInvalidValue;
    dropout_kernel<<<(unsigned)grid_for(n), kThreads, 0,
                     (cudaStream_t)stream>>>(x, out, n, 0u, 0u, keep, key,
                                             offset);
    return (int)cudaGetLastError();
}

int bernoulli_f32(const float* p, float* out, long long n, unsigned k0,
                  unsigned k1, void* stream) {
    if (n <= 0) return 0;
    bernoulli_kernel<<<(unsigned)grid_for(n), kThreads, 0,
                       (cudaStream_t)stream>>>(p, out, n, k0, k1);
    return (int)cudaGetLastError();
}

// One token a row of the (rows, vocab) fp32 logits into out (int32).
// seeds and pos null: (k0, k1) is the one key of the whole draw; else both
// are (rows,) int32 and (k0, k1) the base key.  thr null: no top-k mask,
// else row r's cutoff is thr[r * thr_stride] (a column of topk's values).
int sample_token_f32(const float* logits, long long rows, int vocab,
                     const float* thr, int thr_stride, float temperature,
                     unsigned k0,
                     unsigned k1, const int* seeds, const int* pos, int* out,
                     void* stream) {
    if (rows <= 0) return 0;
    if (vocab <= 0 || rows > 0x7fffffffLL || (seeds == nullptr) !=
        (pos == nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    const int threads = vocab >= kSampleThreads
                            ? kSampleThreads
                            : ((vocab + 31) / 32) * 32;
    sample_token_kernel<<<(unsigned)rows, threads, 0,
                          (cudaStream_t)stream>>>(
        logits, vocab, thr, thr_stride, temperature, k0, k1, seeds, pos,
        out);
    return (int)cudaGetLastError();
}

const char* dropout_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
