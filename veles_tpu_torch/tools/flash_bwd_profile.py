"""What bounds the tensor-core flash kernels (7a forward, 7b dK/dV, 7c
dQ) on the card, and what every attention kernel costs in registers.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 -m veles_tpu_torch.tools.flash_bwd_profile

(The module keeps its first name; it now covers the forward, the paged
decode and prefill kernels and the fused SGD kernel too.)  Prints one
JSON object with
- the card's name and power limit;
- ``ptxas`` resources of every kernel in ``csrc/flash_attention.cu``,
  ``csrc/paged_flash_attention.cu`` (every decode and prefill instance)
  and ``csrc/fused_sgd.cu`` as built for ``sm_90a`` (``nvcc -Xptxas
  -v``): registers a thread, spill stores and loads in bytes, static
  shared memory; beside them each flash kernel's dynamic shared memory,
  and the decode and prefill kernels' at the serving shapes (8 heads,
  kv 8, head_dim 64; decode c 1, prefill c 32);
- the rate ``mma.sync.m16n8k8`` TF32 products reach on this card when
  nothing else is issued (a microbenchmark built here with nvcc: eight
  independent accumulators a warp, 4, 8 or 16 warps a block, two blocks
  an SM): the ceiling of the instruction the kernels use, beside the
  data sheet's dense TF32 rate, which only ``wgmma`` reaches;
- the instruction mix of each flash kernel as compiled (SASS opcodes
  counted by ``cuobjdump``): tensor-core products against everything
  else the warps issue to feed them;
- each flash kernel's card time at the LM's train shape (32 x 8 heads,
  s 512, head_dim 64, causal) and its fp32-accurate TF32 rate, against
  the 3xTF32 bound at the data-sheet rate and at the measured mma.sync
  rate.
"""

import collections
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

MICROBENCH = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
__global__ void mma_rate(float* out, int iters) {
    uint32_t a[4], b[2];
    for (int i = 0; i < 4; ++i)
        a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i) & 0xffffe000u;
    b[0] = a[0];
    b[1] = a[1];
    float c[8][4] = {};
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
            asm volatile(
                "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
                  "r"(b[1]));
    }
    float s = 0.f;
    for (int j = 0; j < 8; ++j)
        for (int e = 0; e < 4; ++e) s += c[j][e];
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
int main() {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
    float* out;
    cudaMalloc(&out, sms * 2 * 512 * sizeof(float));
    cudaEvent_t start, end;
    cudaEventCreate(&start);
    cudaEventCreate(&end);
    for (int warps = 4; warps <= 16; warps *= 2) {
        const int iters = 4096;
        mma_rate<<<sms * 2, warps * 32>>>(out, 16);
        cudaEventRecord(start);
        mma_rate<<<sms * 2, warps * 32>>>(out, iters);
        cudaEventRecord(end);
        cudaEventSynchronize(end);
        float ms = 0.f;
        cudaEventElapsedTime(&ms, start, end);
        const double flops = 2.0 * sms * warps * iters * 8 * 2 * 16 * 8 * 8;
        printf("%d %.6g\n", warps, flops / ms * 1e-9);
    }
    return 0;
}
"""

#: dense TF32 tensor-core rate of the H100 SXM data sheet (wgmma)
TF32_FLOP_S = 495e12


def mma_rates(build):
    """{warps a block: measured mma.sync TF32 flop/s} from the
    microbenchmark."""
    from veles_tpu_torch.ops import _build
    src, exe = build / "mma_rate.cu", build / "mma_rate"
    src.write_text(MICROBENCH)
    subprocess.run([_build.nvcc_path(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-o", str(exe),
                    str(src)], check=True, capture_output=True, text=True)
    out = subprocess.run([str(exe)], check=True, capture_output=True,
                         text=True).stdout
    return {int(w): float(r) * 1e12 for w, r in
            (line.split() for line in out.splitlines())}


def ptxas_resources(build):
    """{kernel: {"registers", "spill_stores", "spill_loads", "smem_static"}}
    for every kernel of the two attention sources and the fused SGD
    source, from ``nvcc -Xptxas -v`` with the build's own flags (names
    demangled by cu++filt)."""
    from veles_tpu_torch.ops import _build
    out = {}
    for name in ("flash_attention", "paged_flash_attention", "fused_sgd"):
        proc = subprocess.run(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(build / ("ptxas_%s.so" % name)),
             str(_build.CSRC_DIR / (name + ".cu"))],
            check=True, capture_output=True, text=True)
        entry = None
        for line in (proc.stdout + proc.stderr).splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = demangle(m.group(1))
                out[entry] = {}
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and entry:
                out[entry].update(spill_stores=int(m.group(1)),
                                  spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                smem = re.search(r"(\d+) bytes smem", line)
                out[entry].update(registers=int(m.group(1)),
                                  smem_static=int(smem.group(1))
                                  if smem else 0)
    return out


def demangle(symbol):
    """``symbol`` demangled by the toolkit's cu++filt, shortened to the
    kernel's name and template arguments; as it is when that fails."""
    from veles_tpu_torch.ops import _build
    filt = Path(_build.nvcc_path()).with_name("cu++filt")
    try:
        name = subprocess.run([str(filt), symbol], check=True,
                              capture_output=True, text=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return symbol
    name = re.sub(r"\((?:bool|int)\)", "", name)
    name = name.replace("(anonymous namespace)::", "").replace("<unnamed>::",
                                                                "")
    return name.split("(")[0].replace("void ", "")


def sass_mix(library):
    """{kernel: {opcode: static count}} for the three flash kernels of
    the built library, from ``cuobjdump -sass``."""
    from veles_tpu_torch.ops import _build
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(library)],
                          check=True, capture_output=True, text=True).stdout
    mix, name = {}, None
    for line in text.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name = next((k for k in ("flash_bwd_dkv_kernel",
                                     "flash_bwd_dq_kernel",
                                     "flash_fwd_kernel")
                         if k in head.group(1)), None)
            if name:
                mix[name] = collections.Counter()
            continue
        op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                       line)
        if name and op:
            mix[name][op.group(1).split(".")[0]] += 1
    return {k: dict(v.most_common()) for k, v in mix.items()}


def main():
    import numpy
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_profile: no CUDA device", file=sys.stderr)
        return 2
    from veles_tpu_torch.ops import _build
    from veles_tpu_torch.ops import hopper_kernels as HK
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    resources = ptxas_resources(_build.BUILD_DIR)
    rates = mma_rates(_build.BUILD_DIR)
    library = _build.compile_source(_build.CSRC_DIR / "flash_attention.cu")
    mix = sass_mix(library)
    flash_lib = HK._flash_lib()
    flash_lib.flash_attention_smem_bytes.restype = ctypes.c_int
    paged_lib = HK._lib()
    paged_lib.paged_flash_decode_smem_bytes.restype = ctypes.c_int
    paged_lib.paged_flash_prefill_smem_bytes.restype = ctypes.c_int
    smem = {name: flash_lib.flash_attention_smem_bytes(i) for i, name in
            enumerate(("flash_fwd_kernel", "flash_bwd_dkv_kernel",
                       "flash_bwd_dq_kernel"))}
    smem["decode_split_kernel (8 heads, kv 8, c 1, head_dim 64)"] = \
        paged_lib.paged_flash_decode_smem_bytes(8, 8, 1, 64)
    smem["prefill_split_kernel (8 heads, kv 8, c 32, head_dim 64)"] = \
        paged_lib.paged_flash_prefill_smem_bytes(8, 8, 32, 64)

    b, h, s, dh = 32, 8, 512, 64
    rng = numpy.random.RandomState(0)
    q, k, v, do = (torch.as_tensor(rng.randn(b, h, s, dh)
                                   .astype(numpy.float32), device="cuda")
                   for _ in range(4))
    o, lse = HK.flash_attention_ref(q, k, v, True)
    di = HK.flash_attention_di(o, do)
    calls = {"flash_fwd_kernel": lambda: HK.flash_attention_fwd(
                 q, k, v, True),
             "flash_bwd_dkv_kernel": lambda: HK.flash_attention_bwd_dkv(
                 q, k, v, o, lse, do, True, di=di),
             "flash_bwd_dq_kernel": lambda: HK.flash_attention_bwd_dq(
                 q, k, v, o, lse, do, True, di=di)}
    product = 2 * b * h * (s * (s + 1) // 2) * dh
    report = {"card": smi, "ptxas": resources, "smem_dynamic": smem,
              "mma_sync_tf32_flop_s": rates,
              "datasheet_tf32_flop_s": TF32_FLOP_S, "kernels": {}}
    ceiling = max(rates.values())
    for (name, call), n_products in zip(calls.items(), (2, 4, 3)):
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                call()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 20)
        ms = sorted(times)[2]
        tf32 = 3 * n_products * product
        ops = mix.get(name, {})
        hmma = ops.get("HMMA", 0)
        report["kernels"][name] = {
            "ms": ms, "tf32_flop_s": tf32 / ms * 1e3,
            "bound_ms_datasheet": tf32 / TF32_FLOP_S * 1e3,
            "bound_ms_mma_sync": tf32 / ceiling * 1e3,
            "sass_hmma": hmma,
            "sass_other_per_hmma": (sum(ops.values()) - hmma) / max(hmma, 1),
            "sass_top": dict(list(ops.items())[:12])}
    report["measured_at"] = time.strftime("%Y-%m-%d %H:%M:%S")
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
