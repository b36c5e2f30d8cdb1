"""What bounds the flash backward kernels (7b dK/dV, 7c dQ) on the card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 -m veles_tpu_torch.tools.flash_bwd_profile

Prints one JSON object with
- the card's name and power limit;
- the rate ``mma.sync.m16n8k8`` TF32 products reach on this card when
  nothing else is issued (a microbenchmark built here with nvcc: eight
  independent accumulators a warp, 4, 8 or 16 warps a block, two blocks
  an SM): the ceiling of the instruction the kernels use, beside the
  data sheet's dense TF32 rate, which only ``wgmma`` reaches;
- the instruction mix of each backward kernel as compiled (SASS opcodes
  counted by ``cuobjdump``): tensor-core products against everything
  else the warps issue to feed them;
- each kernel's card time at the LM's train shape (32 x 8 heads, s 512,
  head_dim 64, causal) and its fp32-accurate TF32 rate, against the
  3xTF32 bound at the data-sheet rate and at the measured mma.sync rate.
"""

import collections
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


def sass_mix(library):
    """{kernel: {opcode: static count}} for the backward kernels of the
    built library, from ``cuobjdump -sass``."""
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
    return {k: dict(v.most_common()) for k, v in mix.items()
            if k != "flash_fwd_kernel"}


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
    rates = mma_rates(_build.BUILD_DIR)
    library = _build.compile_source(_build.CSRC_DIR / "flash_attention.cu")
    mix = sass_mix(library)

    b, h, s, dh = 32, 8, 512, 64
    rng = numpy.random.RandomState(0)
    q, k, v, do = (torch.as_tensor(rng.randn(b, h, s, dh)
                                   .astype(numpy.float32), device="cuda")
                   for _ in range(4))
    o, lse = HK.flash_attention_ref(q, k, v, True)
    di = HK.flash_attention_di(o, do)
    calls = {"flash_bwd_dkv_kernel": lambda: HK.flash_attention_bwd_dkv(
                 q, k, v, o, lse, do, True, di=di),
             "flash_bwd_dq_kernel": lambda: HK.flash_attention_bwd_dq(
                 q, k, v, o, lse, do, True, di=di)}
    product = 2 * b * h * (s * (s + 1) // 2) * dh
    report = {"card": smi, "mma_sync_tf32_flop_s": rates,
              "datasheet_tf32_flop_s": TF32_FLOP_S, "kernels": {}}
    ceiling = max(rates.values())
    for (name, call), n_products in zip(calls.items(), (4, 3)):
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
