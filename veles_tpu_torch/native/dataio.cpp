// Native data-path kernels for the host side of the loader hot loop.
//
// Copy of veles_tpu/native/dataio.cpp for the PyTorch port: the same
// four entry points with the same arithmetic, so the port's gather equals
// the reference's bit for bit.  The hot path is HOST data preparation —
// gathering minibatch rows out of a memory-mapped record file and
// converting uint8 pixels to scaled float32 (RecordsLoader / ImageNet: per
// step, minibatch x sample bytes).  numpy does this as gather-then-convert
// with an intermediate copy and no parallelism; these kernels fuse
// gather+convert and split rows across threads.  On the card's path the
// output is a pinned staging buffer that the loader then copies to the
// device.
//
// Build: g++ -O3 -fPIC -shared -std=c++17 -pthread -ffp-contract=off
// (veles_tpu_torch/native/__init__.py does it at first use, into
// build/native/).  -ffp-contract=off keeps float(u8) * scale + offset a
// multiply and an add, each rounded, never one fused multiply-add.
// Bindings: ctypes (CDLL, so the GIL is released during a call) with a
// numpy fallback.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Split [0, n) into roughly equal chunks across up to max_threads workers.
template <typename Fn>
void parallel_rows(int64_t n, Fn fn) {
    unsigned hw = std::thread::hardware_concurrency();
    int64_t n_threads = hw ? static_cast<int64_t>(hw) : 4;
    if (n_threads > n) n_threads = n > 0 ? n : 1;
    if (n_threads <= 1) {
        fn(0, n);
        return;
    }
    std::vector<std::thread> workers;
    workers.reserve(n_threads);
    int64_t chunk = (n + n_threads - 1) / n_threads;
    for (int64_t t = 0; t < n_threads; ++t) {
        int64_t begin = t * chunk;
        int64_t end = begin + chunk < n ? begin + chunk : n;
        if (begin >= end) break;
        workers.emplace_back([=] { fn(begin, end); });
    }
    for (auto& w : workers) w.join();
}

}  // namespace

extern "C" {

// out[i] = float(src[idx[i]]) * scale + offset   (row-wise)
// src: (n_src, sample_elems) uint8;  out: (n_idx, sample_elems) float32.
void gather_u8_to_f32(const uint8_t* src, const int32_t* idx, int64_t n_idx,
                      int64_t sample_elems, float scale, float offset,
                      float* out) {
    parallel_rows(n_idx, [=](int64_t begin, int64_t end) {
        for (int64_t i = begin; i < end; ++i) {
            const uint8_t* row = src +
                static_cast<int64_t>(idx[i]) * sample_elems;
            float* dst = out + i * sample_elems;
            for (int64_t j = 0; j < sample_elems; ++j)
                dst[j] = static_cast<float>(row[j]) * scale + offset;
        }
    });
}

// Same gather for float32 sources (no conversion, optional affine).
void gather_f32(const float* src, const int32_t* idx, int64_t n_idx,
                int64_t sample_elems, float scale, float offset,
                float* out) {
    bool identity = scale == 1.0f && offset == 0.0f;
    parallel_rows(n_idx, [=](int64_t begin, int64_t end) {
        for (int64_t i = begin; i < end; ++i) {
            const float* row = src +
                static_cast<int64_t>(idx[i]) * sample_elems;
            float* dst = out + i * sample_elems;
            if (identity) {
                std::memcpy(dst, row, sample_elems * sizeof(float));
            } else {
                for (int64_t j = 0; j < sample_elems; ++j)
                    dst[j] = row[j] * scale + offset;
            }
        }
    });
}

// batch[i] -= mean  (mean-image subtraction, row-parallel)
void subtract_mean(float* batch, const float* mean, int64_t n_rows,
                   int64_t sample_elems) {
    parallel_rows(n_rows, [=](int64_t begin, int64_t end) {
        for (int64_t i = begin; i < end; ++i) {
            float* row = batch + i * sample_elems;
            for (int64_t j = 0; j < sample_elems; ++j) row[j] -= mean[j];
        }
    });
}

// int32 label gather (tiny, but keeps the whole fill native).
void gather_i32(const int32_t* src, const int32_t* idx, int64_t n_idx,
                int32_t* out) {
    for (int64_t i = 0; i < n_idx; ++i) out[i] = src[idx[i]];
}

int dataio_abi_version() { return 1; }

}  // extern "C"
