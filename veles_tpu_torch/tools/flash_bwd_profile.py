"""What bounds the tensor-core flash kernels (7a forward, 7b dK/dV, 7c
dQ) on the card, and what every attention kernel costs in registers.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 -m veles_tpu_torch.tools.flash_bwd_profile

(The module keeps its first name; it now covers the forward, the paged
decode and prefill kernels, the fused SGD kernel and the LRN kernels
too.)  Prints one
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
  rate;
- under ``lrn``: each LRN kernel instance's (``csrc/lrn.cu``) static
  SASS mix by class (MUFU, fp32, integer, LDS/STS, LDG/STG and their
  widths, bulk and 4-byte async copies, barrier operations) and its
  loops (each backward branch: first and last instruction, the
  instructions between, and the instructions issued along the loop's
  common path -- see ``common_path`` -- with the stores on it); each
  kernel's card time at AlexNet's two LRN layers with its launch plan,
  the bytes it must move, its achieved TB/s and its share of the byte
  bound, beside the time of the same source built with the hardware's
  approximate ``__powf`` (what the accurate power costs); and the TB/s
  plain PyTorch streaming kernels reach with each mix of reads and
  writes.

``--sass-dir DIR`` writes each LRN kernel's SASS listing there.
"""

import argparse
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
    for every kernel of the two attention sources, the fused SGD source
    and the LRN source, from ``nvcc -Xptxas -v`` with the build's own
    flags (names demangled by cu++filt)."""
    from veles_tpu_torch.ops import _build
    out = {}
    for name in ("flash_attention", "paged_flash_attention", "fused_sgd",
                 "lrn"):
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


def sass_listings(library):
    """{mangled kernel name: its lines of SASS} for the built library,
    from ``cuobjdump -sass``."""
    from veles_tpu_torch.ops import _build
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(library)],
                          check=True, capture_output=True, text=True).stdout
    listings, name = {}, None
    for line in text.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name = head.group(1)
            listings[name] = []
        elif name:
            listings[name].append(line)
    return listings


def sass_mix(library):
    """{kernel: {opcode: static count}} for the three flash kernels of
    the built library."""
    mix = {}
    for symbol, lines in sass_listings(library).items():
        name = next((k for k in ("flash_bwd_dkv_kernel",
                                 "flash_bwd_dq_kernel", "flash_fwd_kernel")
                     if k in symbol), None)
        if name:
            mix[name] = collections.Counter(
                op.group(1).split(".")[0] for op in (
                    re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                              r"([A-Z][A-Z0-9_]*)", line) for line in lines)
                if op)
    return {k: dict(v.most_common()) for k, v in mix.items()}


#: SASS opcode classes of the LRN report (first token before a dot)
SASS_CLASSES = {
    "mufu": ("MUFU",),
    "fp32": ("FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "FCHK",
             "FRND", "FSWZADD"),
    "integer": ("IMAD", "IADD3", "ISETP", "LOP3", "SHF", "LEA", "IABS",
                "IMNMX", "SEL", "I2F", "F2I", "SGXT", "PRMT", "FLO",
                "POPC", "IMUL", "LOP", "SHL", "SHR", "I2FP", "F2FP"),
    "move": ("MOV", "S2R", "S2UR", "CS2R", "ULDC", "R2UR", "UMOV",
             "UIADD3", "UIMAD", "ULOP3", "USHF", "UISETP", "USEL"),
    "lds": ("LDS", "LDSM"),
    "sts": ("STS",),
    "ldg": ("LDG", "LD"),
    "stg": ("STG", "ST"),
    "bulk_copy": ("UBLKCP",),
    "cp_async": ("LDGSTS", "ARRIVES", "LDGDEPBAR", "DEPBAR"),
    "barrier": ("SYNCS", "BAR", "MEMBAR", "FENCE", "WARPSYNC", "ERRBAR",
                "CCTL"),
    "branch": ("BRA", "BRX", "EXIT", "RET", "CALL", "BSSY", "BSYNC",
               "YIELD", "NOP"),
}


def common_path(ops, start, end):
    """Instructions a warp issues from ``start`` to the loop's back edge
    at ``end`` along its common path: every forward conditional branch
    falls through, except one on a predicate last set by ``FSETP.GEU.AND
    Px, PT, Rd, RZ`` (powf's exit for a base >= 0, the normal case), and
    unconditional branches are taken.  Exact for a loop whose only
    branches are powf's special cases (the LRN kernels' n = 5 loops);
    a loop with a data-dependent trip count inside needs its own walk.
    Returns (instructions, stores to device memory)."""
    index = {a: i for i, (a, _) in enumerate(ops)}
    i, count, stores, geu = index[start], 0, 0, set()
    while count < 100000:
        addr, op = ops[i]
        count += 1
        stores += op.split()[0].startswith("STG") or (
            op.startswith("@") and op.split()[1].startswith("STG"))
        if addr == end:
            return count, stores
        m = re.match(r"(@!?P\d\s+)?BRA(?:\.\S+)?\s+(?:!?P\d,\s*)?0x"
                     r"([0-9a-f]+)", op)
        if m:
            cond = m.group(1)
            if cond is None or (cond.startswith("@P")
                                and cond.strip()[1:] in geu):
                i = index[int(m.group(2), 16)]
                continue
        setter = re.match(r"(?:@!?P\d\s+)?([A-Z0-9.]+)\s+(P\d)\s*,", op)
        if setter and not setter.group(1).startswith("BRA"):
            if re.match(r"FSETP\.GEU\.AND (P\d), PT, R\d+, RZ", op):
                geu.add(setter.group(2))
            else:
                geu.discard(setter.group(2))
        i += 1
    return None, None


def lrn_sass(library, sass_dir=None):
    """{kernel instance: {"total", "classes", "widths", "loops"}} for
    every LRN kernel of the built library, from ``cuobjdump -sass``:
    static instruction counts by class, the memory opcodes with their
    widths (e.g. ``LDS.128``, ``STG.E.128``), and every loop as
    [first, last, instructions, common-path instructions, stores on that
    path] (a branch to an earlier address; loops nest).  With
    ``sass_dir``, each listing is written there."""
    listings = {demangle(symbol): lines for symbol, lines in
                sass_listings(library).items() if "lrn" in symbol}
    out = {}
    for name, lines in listings.items():
        if sass_dir:
            path = Path(sass_dir) / (re.sub(r"[^\w]+", "_", name) + ".sass")
            path.write_text("\n".join(lines) + "\n")
        ops, labels, branches = [], {}, []
        pending, plain = [], []
        for line in lines:
            lab = re.match(r"\s*(\.L_x_\d+):", line)
            if lab:
                pending.append(lab.group(1))
                continue
            m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                          r"([A-Z][A-Z0-9_.]*)(.*)", line)
            if not m:
                continue
            addr = int(m.group(1), 16)
            for lab_name in pending:
                labels[lab_name] = addr
            pending = []
            ops.append((addr, m.group(2)))
            pred = re.search(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?", line)
            plain.append((addr, (pred.group(1) or "") + m.group(2)
                          + m.group(3).split(";")[0]))
            if m.group(2).split(".")[0] == "BRA":
                target = re.search(r"`\((\.L_x_\d+)\)|0x([0-9a-f]+)",
                                   m.group(3))
                if target:
                    branches.append((addr, target.group(1)
                                     or int(target.group(2), 16)))
        counts = collections.Counter(op.split(".")[0] for _, op in ops)
        classes = collections.Counter()
        for op, k in counts.items():
            cls = next((c for c, names in SASS_CLASSES.items()
                        if op in names), "other")
            classes[cls] += k
        widths = collections.Counter(
            op for _, op in ops if op.split(".")[0] in (
                "LDS", "STS", "LDG", "STG", "LD", "ST", "LDGSTS", "UBLKCP"))
        loops = []
        for addr, target in branches:
            start = labels.get(target) if isinstance(target, str) else target
            if start is not None and start <= addr:
                loops.append([start, addr, sum(1 for a, _ in ops
                                               if start <= a <= addr),
                              *common_path(plain, start, addr)])
        out[name] = {"total": len(ops), "classes": dict(classes),
                     "opcodes": dict(counts.most_common()),
                     "widths": dict(widths), "loops": sorted(loops)}
    return out


def time_calls(torch, fns, calls=10, reps=15):
    """Median card ms of one call over ``reps`` runs of ``calls``
    back-to-back calls cycling through ``fns`` (CUDA events)."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for k in range(calls):
            fns[k % len(fns)]()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return sorted(times)[len(times) // 2]


#: AlexNet's LRN inputs (NHWC): conv1's and conv2's outputs
LRN_SHAPES = {"lrn1": (128, 55, 55, 96), "lrn2": (128, 27, 27, 256)}
HBM_BYTES_S = 3.35e12


def fast_power_library(build):
    """The LRN library built from the checkout's ``lrn.cu`` with every
    ``powf`` of the kernels replaced by the hardware approximation
    ``__powf``: a yardstick of what the accurate power costs, timed
    beside the kernels and never used by the port (its results are
    neither checked nor accurate enough to be)."""
    from veles_tpu_torch.ops import _build
    src = (_build.CSRC_DIR / "lrn.cu").read_text()
    variant, lib = build / "lrn_fast_power.cu", build / "lrn_fast_power.so"
    variant.write_text(re.sub(r"\bpowf\(", "__powf(", src))
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(variant)], check=True, capture_output=True,
                   text=True)
    lib = ctypes.CDLL(str(lib))
    ptr, i32, f32, i64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                          ctypes.c_longlong)
    lib.lrn_forward_f32.argtypes = [ptr] * 3 + [i64, i32, i32] + [f32] * 3 \
        + [ptr]
    lib.lrn_backward_f32.argtypes = [ptr] * 4 + [i64, i32, i32] + [f32] * 2 \
        + [ptr]
    return lib


def lrn_report(torch, HK, fast_power=None):
    """Each LRN kernel's card time at AlexNet's two LRN layers (inputs
    cycled over 4 copies, cold in the 50 MB L2), the bytes it must move
    (forward 12, backward 16 an element), TB/s and the share of the
    3.35 TB/s byte bound; the launch plan where the library reports it
    (a parent's library may not); with ``fast_power`` (see
    ``fast_power_library``), that library's times on the same inputs."""
    import numpy
    sc = HK._lrn_scalars(1e-4, 0.75, 5, 2.0)
    out = {}
    for i, (name, shape) in enumerate(LRN_SHAPES.items()):
        rng = numpy.random.RandomState(i)
        x = torch.as_tensor(3 * numpy.abs(rng.randn(*shape)).astype(
            numpy.float32), device="cuda")
        dy = torch.as_tensor(rng.randn(*shape).astype(numpy.float32),
                             device="cuda")
        xs = [x] + [x.clone() for _ in range(3)]
        ds = [HK.lrn_forward(t)[1] for t in xs]
        dys = [dy] + [dy.clone() for _ in range(3)]
        elems = x.numel()
        rows, c = elems // shape[-1], shape[-1]

        fwd = time_calls(torch, [lambda t=t: HK.lrn_forward(t) for t in xs])
        bwd = time_calls(torch, [lambda t=t, e=e, g=g: HK.lrn_backward(
            t, e, g) for t, e, g in zip(xs, ds, dys)])
        fast = {}
        if fast_power is not None:
            y, dx = torch.empty_like(x), torch.empty_like(x)
            d_out = torch.empty_like(x)
            stream = torch.cuda.current_stream().cuda_stream
            fast["forward"] = time_calls(torch, [
                lambda t=t: fast_power.lrn_forward_f32(
                    t.data_ptr(), y.data_ptr(), d_out.data_ptr(), rows, c,
                    5, float(sc["alpha_n"]), float(sc["neg_beta"]),
                    float(sc["k"]), stream) for t in xs])
            fast["backward"] = time_calls(torch, [
                lambda t=t, e=e, g=g: fast_power.lrn_backward_f32(
                    t.data_ptr(), e.data_ptr(), g.data_ptr(), dx.data_ptr(),
                    rows, c, 5, float(sc["neg_beta_1"]), float(sc["coef"]),
                    stream) for t, e, g in zip(xs, ds, dys)])
        rec = {}
        for kind, ms, per in (("forward", fwd, 12), ("backward", bwd, 16)):
            n_bytes = per * elems
            bound = n_bytes / HBM_BYTES_S * 1e3
            rec[kind] = {"ms": ms, "bytes": n_bytes, "tb_s": n_bytes / ms
                         * 1e-9, "bound_ms": bound, "bound_share": bound / ms}
            if kind in fast:
                rec[kind]["fast_power_ms"] = fast[kind]
            if hasattr(HK, "lrn_plan"):
                rec[kind]["plan"] = HK.lrn_plan(rows, c, 5,
                                                backward=kind == "backward")
        out[name] = dict(rec, shape=list(shape))
    return out


def memory_rates(torch, n=1 << 26):
    """TB/s that plain PyTorch streaming kernels reach on this card
    (256 MB a tensor, 4 copies cycled): read only (sum), write only
    (fill), one read to one write (copy), two reads to one write (add)
    and three reads to one write (addcmul) — what each mix of reads and
    writes can draw from device memory, beside the data sheet's 3.35."""
    a = [torch.ones(n, device="cuda") for _ in range(4)]
    b = [torch.ones(n, device="cuda") for _ in range(4)]
    c = [torch.empty(n, device="cuda") for _ in range(4)]
    calls = {"read": (lambda i: a[i].sum(), 4),
             "write": (lambda i: c[i].fill_(1.0), 4),
             "copy_1r_1w": (lambda i: c[i].copy_(a[i]), 8),
             "add_2r_1w": (lambda i: torch.add(a[i], b[i], out=c[i]), 12),
             "addcmul_3r_1w": (lambda i: torch.addcmul(
                 a[i], b[i], a[(i + 1) % 4], out=c[i]), 16)}
    out = {}
    for name, (fn, per) in calls.items():
        ms = time_calls(torch, [lambda i=i: fn(i) for i in range(4)])
        out[name] = per * n / ms * 1e-9
    return out


def main(argv=None):
    import numpy
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--sass-dir")
    args = parser.parse_args(argv)
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
    if args.sass_dir:
        Path(args.sass_dir).mkdir(parents=True, exist_ok=True)
    lrn = {"sass": lrn_sass(_build.compile_source(_build.CSRC_DIR / "lrn.cu"),
                            args.sass_dir),
           "cases": lrn_report(torch, HK, fast_power_library(
               _build.BUILD_DIR)),
           "memory_tb_s": memory_rates(torch)}
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
              "lrn": lrn,
              "mma_sync_tf32_flop_s": rates,
              "datasheet_tf32_flop_s": TF32_FLOP_S, "kernels": {}}
    ceiling = max(rates.values())
    for (name, call), n_products in zip(calls.items(), (2, 4, 3)):
        ms = time_calls(torch, [call], calls=20, reps=5)
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
