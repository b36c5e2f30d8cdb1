// Standalone native inference runner over libtorch's AOTInductor loader.
//
// Counterpart of veles_tpu/native/artifact_runner.cpp (which compiles
// StableHLO through the PJRT C API): this binary loads a bundle written by
// veles_tpu_torch.export.export_native_bundle -- an AOTInductor package
// with the trained weights baked in as constants and a static batch -- and
// runs it with no Python and no framework.
//
// Bundle layout:
//   program.pt2    AOTInductor package (compiled for the CPU or the card)
//   input.shape    ascii dims of the program's one input
//   manifest.json  shapes/dtypes (informational)
//
// Usage:
//   artifact_runner <bundle_dir> [input.bin output.bin]
//   artifact_runner --selfcheck
//
// input.bin / output.bin: raw little-endian f32.  Without them the
// program is loaded and nothing is run.  --selfcheck reports libtorch's
// version, whether a card is visible and the ops this binary registers,
// and needs no bundle and no device.
//
// An exported program keeps the LRN forward as one call of the op
// veles_tpu_torch::lrn_forward, which AOTInductor runs through the
// dispatcher.  This binary registers that op under the Python op's
// schema: on the CPU the plain window sum in ATen, on the card the
// port's hand-written kernel, dlopen'd from the library named by
// $VELES_TPU_TORCH_LRN_LIBRARY (build/kernels/lrn-<hash>.so).  A bundle
// whose op is not registered fails to load, naming the op.  The count of
// kernel launches is printed on stderr as "lrn_forward launches N", and
// on the card the run's memory as "card bytes <used> <allocator peak>":
// the card's used bytes after the run less those before the load (what
// the program took beyond the CUDA context, which the first reading
// creates), and the caching allocator's peak.
//
// Products run in full fp32 (TF32 off in cuBLAS and cuDNN), as the
// port's default precision mode runs them.

#include <dlfcn.h>

#include <atomic>
#include <cstdio>
#include <cstdlib>
#include <fstream>
#include <iostream>
#include <sstream>
#include <string>
#include <tuple>
#include <vector>

#include <ATen/ATen.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>
#include <torch/library.h>
#include <torch/version.h>

#ifdef ARTIFACT_RUNNER_CUDA
#include <c10/cuda/CUDACachingAllocator.h>
#include <c10/cuda/CUDAFunctions.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#endif

namespace {

std::atomic<long long> g_lrn_launches{0};

[[noreturn]] void die(const std::string& what) {
  std::fprintf(stderr, "artifact_runner: %s\n", what.c_str());
  std::exit(1);
}

std::string read_file(const std::string& path) {
  std::ifstream in(path, std::ios::binary);
  if (!in) die("cannot read " + path);
  std::ostringstream buf;
  buf << in.rdbuf();
  return buf.str();
}

// The fp32 scalars of the kernels, rounded once from the op's doubles as
// veles_tpu_torch/ops/hopper_kernels.py:_lrn_scalars rounds them.
struct LrnScalars {
  float alpha_n, neg_beta, k;
};

LrnScalars lrn_scalars(double alpha, double beta, int64_t n, double k) {
  return {(float)(alpha / (double)n), (float)(-beta), (float)k};
}

// sum_{m < n} t[..., i - left + m] over the last axis, zero outside
// [0, C), added in ascending channel order (the kernels' order).
at::Tensor window_sum(const at::Tensor& t, int64_t n, int64_t left) {
  const int64_t c = t.size(-1);
  at::Tensor padded = at::constant_pad_nd(t, {left, n - 1 - left}, 0);
  at::Tensor out = padded.narrow(-1, 0, c);
  for (int64_t m = 1; m < n; ++m) out = out + padded.narrow(-1, m, c);
  return out;
}

std::tuple<at::Tensor, at::Tensor> lrn_forward_cpu(const at::Tensor& x,
                                                   double alpha, double beta,
                                                   int64_t n, double k) {
  const LrnScalars s = lrn_scalars(alpha, beta, n, k);
  at::Tensor d = window_sum(x * x, n, n / 2).mul((double)s.alpha_n)
                     .add((double)s.k);
  return {x * at::pow(d, (double)s.neg_beta), d};
}

#ifdef ARTIFACT_RUNNER_CUDA
using LrnForwardFn = int (*)(const float*, float*, float*, long long, int,
                             int, float, float, float, void*);
using LrnErrorFn = const char* (*)(int);

struct LrnLibrary {
  LrnForwardFn forward = nullptr;
  LrnErrorFn error = nullptr;
};

const LrnLibrary& lrn_library() {
  static const LrnLibrary lib = [] {
    const char* path = std::getenv("VELES_TPU_TORCH_LRN_LIBRARY");
    TORCH_CHECK(path && *path,
                "VELES_TPU_TORCH_LRN_LIBRARY must name the built LRN kernel "
                "library (build/kernels/lrn-<hash>.so)");
    void* handle = dlopen(path, RTLD_NOW | RTLD_LOCAL);
    TORCH_CHECK(handle, "cannot load ", path, ": ", dlerror());
    LrnLibrary out;
    out.forward = (LrnForwardFn)dlsym(handle, "lrn_forward_f32");
    out.error = (LrnErrorFn)dlsym(handle, "lrn_error_string");
    TORCH_CHECK(out.forward && out.error, path,
                " lacks lrn_forward_f32 or lrn_error_string");
    return out;
  }();
  return lib;
}

std::tuple<at::Tensor, at::Tensor> lrn_forward_cuda(const at::Tensor& x,
                                                    double alpha, double beta,
                                                    int64_t n, double k) {
  TORCH_CHECK(x.scalar_type() == at::kFloat, "x must be float32");
  TORCH_CHECK(x.is_contiguous(), "x must be contiguous");
  const LrnLibrary& lib = lrn_library();
  const LrnScalars s = lrn_scalars(alpha, beta, n, k);
  at::Tensor y = at::empty_like(x);
  at::Tensor d = at::empty_like(x);
  const int64_t c = x.size(-1);
  c10::cuda::CUDAGuard guard(x.device());
  void* stream = c10::cuda::getCurrentCUDAStream(x.device().index()).stream();
  const int code = lib.forward(x.data_ptr<float>(), y.data_ptr<float>(),
                               d.data_ptr<float>(),
                               x.numel() / (c > 0 ? c : 1), (int)c, (int)n,
                               s.alpha_n, s.neg_beta, s.k, stream);
  TORCH_CHECK(code == 0, "lrn_forward launch failed: ", lib.error(code));
  ++g_lrn_launches;
  return {y, d};
}
#endif

}  // namespace

// The op's schema, as the Python op veles_tpu_torch::lrn_forward
// (veles_tpu_torch/ops/hopper_kernels.py) declares it.
TORCH_LIBRARY(veles_tpu_torch, m) {
  m.def("lrn_forward(Tensor x, float alpha, float beta, SymInt n, float k)"
        " -> (Tensor, Tensor)");
}

TORCH_LIBRARY_IMPL(veles_tpu_torch, CPU, m) {
  m.impl("lrn_forward", &lrn_forward_cpu);
}

#ifdef ARTIFACT_RUNNER_CUDA
TORCH_LIBRARY_IMPL(veles_tpu_torch, CUDA, m) {
  m.impl("lrn_forward", &lrn_forward_cuda);
}
#endif

namespace {

bool card_available() {
#ifdef ARTIFACT_RUNNER_CUDA
  return c10::cuda::device_count() > 0;
#else
  return false;
#endif
}

// The card's used bytes (total less free), through the CUDA runtime that
// libtorch loaded (looked up, not linked: one runtime in the process);
// -1 when it cannot be read.
long long card_used_bytes() {
  using MemGetInfo = int (*)(size_t*, size_t*);
  static const auto fn = (MemGetInfo)dlsym(RTLD_DEFAULT, "cudaMemGetInfo");
  size_t free_b = 0, total_b = 0;
  if (!fn || fn(&free_b, &total_b) != 0) return -1;
  return (long long)(total_b - free_b);
}

int selfcheck() {
  std::printf("libtorch %s\n", TORCH_VERSION);
  std::printf("cuda build %d, card %d\n",
#ifdef ARTIFACT_RUNNER_CUDA
              1,
#else
              0,
#endif
              card_available() ? 1 : 0);
  for (const auto& name : {"veles_tpu_torch::lrn_forward"}) {
    auto op = c10::Dispatcher::singleton().findSchema({name, ""});
    if (!op) die(std::string("op not registered: ") + name);
    std::cout << "op " << op->schema() << "\n";
  }
  std::printf("SELFCHECK OK\n");
  return 0;
}

int run(int argc, char** argv) {
  const std::string bundle = argv[1];
  at::globalContext().setAllowTF32CuBLAS(false);
  at::globalContext().setAllowTF32CuDNN(false);
  const long long used_before = card_available() ? card_used_bytes() : -1;
  torch::inductor::AOTIModelPackageLoader loader(bundle + "/program.pt2");
  auto metadata = loader.get_metadata();
  const std::string device_name = metadata.count("AOTI_DEVICE_KEY")
                                      ? metadata["AOTI_DEVICE_KEY"]
                                      : std::string("cpu");
  std::printf("loaded %s/program.pt2 (device %s)\n", bundle.c_str(),
              device_name.c_str());
  if (argc < 4) {
    std::printf("LOAD OK (no input given)\n");
    return 0;
  }

  std::vector<int64_t> dims;
  {
    std::ifstream shp(bundle + "/input.shape");
    int64_t d;
    while (shp >> d) dims.push_back(d);
  }
  if (dims.empty()) die("no dims in " + bundle + "/input.shape");
  std::string raw = read_file(argv[2]);
  int64_t want = 4;  // f32 bytes
  for (int64_t d : dims) want *= d;
  if ((int64_t)raw.size() != want)
    die("input size mismatch: " + std::string(argv[2]) + " has " +
        std::to_string(raw.size()) + " bytes, input.shape needs " +
        std::to_string(want));

  const at::Device device(device_name);
  at::Tensor input =
      at::from_blob(raw.data(), dims, at::TensorOptions(at::kFloat)).clone();
  input = input.to(device);
  std::vector<at::Tensor> outputs = loader.run({input});
  if (outputs.size() != 1)
    die("program has " + std::to_string(outputs.size()) +
        " outputs; this runner serves single-output programs");
  at::Tensor out = outputs[0].to(at::kCPU).to(at::kFloat).contiguous();

  std::ofstream of(argv[3], std::ios::binary);
  of.write(static_cast<const char*>(out.data_ptr()),
           (std::streamsize)(out.numel() * 4));
  of.close();
  if (!of) die(std::string("cannot write ") + argv[3]);
  std::fprintf(stderr, "lrn_forward launches %lld\n",
               (long long)g_lrn_launches.load());
#ifdef ARTIFACT_RUNNER_CUDA
  if (device.is_cuda()) {
    const long long used_after = card_used_bytes();
    const auto stats =
        c10::cuda::CUDACachingAllocator::getDeviceStats(device.index() < 0
                                                            ? 0
                                                            : device.index());
    std::fprintf(stderr, "card bytes %lld %lld\n",
                 used_before < 0 || used_after < 0 ? -1LL
                                                   : used_after - used_before,
                 (long long)stats.allocated_bytes[0].peak);
  }
#endif
  std::printf("EXECUTE OK: wrote %lld bytes to %s\n",
              (long long)(out.numel() * 4), argv[3]);
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc == 2 && std::string(argv[1]) == "--selfcheck") return selfcheck();
  if (argc != 2 && argc != 4) {
    std::fprintf(stderr,
                 "usage: artifact_runner <bundle_dir> [input.bin output.bin]"
                 "\n       artifact_runner --selfcheck\n");
    return 2;
  }
  try {
    return run(argc, argv);
  } catch (const std::exception& e) {
    die(e.what());
  }
}
