#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits nonzero before the final line is printed):

1. device — the card's name, the device count and ``nvidia-smi``'s name
   and power limit;
2. build — the CUDA kernels compiled from ``veles_tpu_torch/csrc/``
   (``paged_flash_attention.cu``, ``fused_sgd.cu``, ``lrn.cu``,
   ``dropout.cu``, ``flash_attention.cu``; one nvcc per source, all
   started together) into
   ``build/kernels/``;
3. kernels — each kernel against its plain PyTorch version on the card
   at its main path's shapes, with kernel, plain-version and library
   card times (CUDA events; see ``time_ms``) and the card's bound for
   the same work: the paged attention kernels at the serving shapes
   (library: scaled_dot_product_attention on the gathered view), then
   (checked, not timed) long page tables — a 16384-token lane view at
   head_dim 128 — and a head_dim that is neither a multiple of 4 nor
   below 256; the fused SGD kernel at MNIST-FC's four parameters,
   AlexNet's sixteen, a 4096x4096 weight, odd sizes, weight decay with
   an L1 mix and a clip (no library call computes that function); the
   LRN forward and backward kernels at AlexNet's two LRN layers (library:
   ``local_response_norm`` on the NCHW view and its autograd backward),
   checked, not timed, at C = 200 with n = 4; dropout at AlexNet's two
   dropout inputs and at sizes 1, 127 and 2**16 + 3, bit-equal to its
   plain version (no library call draws jax's mask);
4. serve — the paged LM engine at the full width of the repo's LM
   config (vocab 256, d_model 512, 8 heads, 8 layers, learned positions,
   max_len 512, fp32, random weights from a seed) answers 16 requests
   through the kernels, then every emitted token is checked against a
   teacher-forced pass of the plain attention path;
5. train — the MNIST-FC sample (784→100 tanh→10 softmax, minibatch 100,
   60,000 train / 10,000 validation synthetic samples, 2 epochs, fused
   mode) through ``samples.mnist.train`` on the card: validation error
   below 5%, validation loss falling, every dispatched train minibatch's
   four momentum updates through the kernel; then the same seed on the
   card and on the CPU for 50 committed updates, weights within 1e-4;
6. alexnet — the ImageNet sample at full AlexNet width
   (``alexnet_layers()``: crop 227, five conv blocks with two LRN and
   three max-pooling layers, two dropout-FC 4096 layers, softmax 1000;
   minibatch 128; the synthetic loader at 256x256, 640 train / 128
   validation, 2 epochs) through ``samples.imagenet.train`` on the card:
   finite losses, and per dispatched train step exactly 2 LRN forward
   (plus 2 per validation minibatch), 2 LRN backward, 4 dropout and 16
   fused SGD launches; then the same seed on the card and on the CPU at
   minibatch 16 for 3 committed updates, each layer's weight gap within
   its limit (``ALEXNET_*_SHARE``) after the first update and after the
   third, and two faulty card runs rejected by the same limits;
7. lm_train — the char-LM sample at the repo's full LM width (vocab 256,
   d_model 512, 8 heads, 8 layers, s 512, minibatch 32; 10 train steps
   and 2 validation minibatches) through ``samples.char_lm.train``'s
   build + initialize + run under ``set_attention_backend('flash_pallas')``:
   exactly 8 launches of each flash kernel a train step and 8 of the
   forward a validation minibatch, finite and falling losses; tokens/s
   and the card's busy share of a steady step under 'flash_pallas' and
   under 'xla'; greedy ``sample_tokens`` on the card checked against a
   teacher-forced plain pass; then card vs CPU at 2 layers, s 128,
   minibatch 4 after the first and the third Adam update
   (``LM_*_SHARE``), and two faulty card runs rejected by those limits;
8. one JSON line listing every ported kernel, then the JSON result line.

The kernels phase also holds the three flash-attention kernels (forward,
dK/dV pass, dQ pass; ``flash_attention.cu``) at the LM's train shape
(32 x 8 heads, s 512, head_dim 64, causal), with kernel, plain and SDPA
times, the 3xTF32 and fp32-FMA bounds, and the elements four faulty
plain versions put outside the limits (one of them the plain backward
in single TF32 products); then, checked only, s 200 non-causal at
head_dim 32, 40, 128 and 37 (rows not 16-byte aligned), and scores
peaked at ±100.  In every case each backward kernel is launched twice
(bit-equal) and held against an fp64 plain version: its error at most
``FLASH_FP64_FACTOR`` times the fp32 plain version's.

It imports nothing of JAX and nothing of the ``veles_tpu`` package.
"""

import contextlib
import json
import statistics
import subprocess
import sys
import time
import numpy

SEED = 20261016
#: H100 SXM data-sheet peaks: HBM bytes/s, fp32 (non-tensor) flop/s and
#: dense TF32 tensor-core flop/s
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
TF32_FLOP_S = 495e12
#: 32-bit integer operations/s: 64 INT32 lanes per SM (half the 128 fp32
#: lanes behind the 67 TFLOP/s; Hopper white paper) x 132 SMs x 1.98 GHz
INT32_OP_S = 64 * 132 * 1.98e9
#: threefry2x32 per element: 20 rounds of add, rotate, xor; 5 key
#: injections of 3 adds; 2 initial adds; then xor, shift, or, subtract,
#: compare and select to turn the words into a kept-or-zero output
DROPOUT_OPS = 20 * 3 + 5 * 3 + 2 + 6
#: copies of each timed kernel's inputs, cycled so that every call finds
#: its operands cold in the 50 MB L2 (4 x 16.8 MB of decode pools)
COPIES = 4
#: fp32 kernel vs plain version, outputs O(1): the two sum up to 512
#: keys in different orders (~1e-6 expected); 1e-4 leaves 100x margin
KERNEL_ATOL = 1e-4
#: teacher-forced check: an emitted token's logit may sit below its
#: row's max by at most this much (fp32 near-ties between the kernel
#: path and the plain path; logits are O(1))
LOGIT_TOL = 1e-3

#: jax's bundled TPU flash attention, which veles_tpu/ops/attention.py:190
#: calls; its three pallas_call sites
BUNDLED = "jax/experimental/pallas/ops/tpu/flash_attention.py"
REPLACES = {
    "flash_attention_fwd": BUNDLED + ":758",
    "flash_attention_bwd_dkv": BUNDLED + ":1121",
    "flash_attention_bwd_dq": BUNDLED + ":1456",
    "fused_sgd_update": "veles_tpu/ops/pallas_kernels.py:92",
    "lrn_forward": "veles_tpu/ops/pallas_kernels.py:226",
    "lrn_backward": "veles_tpu/ops/pallas_kernels.py:244",
    "dropout": "veles_tpu/ops/pallas_kernels.py:272",
    "paged_flash_decode": "veles_tpu/ops/pallas_kernels.py:367",
    "paged_flash_prefill": "veles_tpu/ops/pallas_kernels.py:443",
}
SOURCES = {
    "flash_attention_fwd": "veles_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_bwd_dkv": "veles_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_bwd_dq": "veles_tpu_torch/csrc/flash_attention.cu",
    "fused_sgd_update": "veles_tpu_torch/csrc/fused_sgd.cu",
    "lrn_forward": "veles_tpu_torch/csrc/lrn.cu",
    "lrn_backward": "veles_tpu_torch/csrc/lrn.cu",
    "dropout": "veles_tpu_torch/csrc/dropout.cu",
    "paged_flash_decode": "veles_tpu_torch/csrc/paged_flash_attention.cu",
    "paged_flash_prefill": "veles_tpu_torch/csrc/paged_flash_attention.cu",
}
#: fused SGD kernel vs plain version: at most 1 ulp per element (the
#: plain version rounds each fused multiply-add once from float64)
SGD_MAX_ULPS = 1.0
#: MNIST-FC's parameters: (784, 100) and (100,) tanh, (100, 10) and (10,)
MNIST_PARAMS = ((784, 100), (100,), (100, 10), (10,))
#: AlexNet's sixteen: five HWIO convs and three FC layers, with biases
ALEXNET_PARAMS = ((11, 11, 3, 96), (96,), (5, 5, 96, 256), (256,),
                  (3, 3, 256, 384), (384,), (3, 3, 384, 384), (384,),
                  (3, 3, 384, 256), (256,), (9216, 4096), (4096,),
                  (4096, 4096), (4096,), (4096, 1000), (1000,))
#: LRN kernels vs plain versions: they differ only where CUDA's powf and
#: PyTorch's pow round differently (the window sums are in one order);
#: the reference's own Pallas-vs-XLA tolerances
LRN_FWD_TOL = (2e-6, 2e-6)           # (rtol, atol)
LRN_BWD_TOL = (3e-5, 3e-6)
#: AlexNet's LRN inputs: conv1's and conv2's NHWC outputs
LRN_SHAPES = {"lrn1": (128, 55, 55, 96), "lrn2": (128, 27, 27, 256)}
#: AlexNet's dropout inputs: pool5 flattened, and fc6's output
DROPOUT_SHAPES = {"dropout6": (128, 9216), "dropout7": (128, 4096)}
#: card vs CPU AlexNet at minibatch 16, one seed.  A layer's gap is max
#: |card - CPU| over its weights and bias, as a share of its movement,
#: max |CPU - initial| (initial weights are bit-equal).  cuDNN (TF32 off)
#: and the CPU sum the convolutions in other orders (activations ~3e-6
#: apart, relative), so a max-pool window whose two largest inputs are
#: that close picks another argmax on one side (a flip: 3 of pool2's
#: 692,224 windows in the first step) and routes one gradient element
#: elsewhere.  After the first committed update:
#: - a layer above every max pool (the FC layers) sees no flip; only
#:   summation order parts the runs (~1e-9 absolute, a ~1e-6 share):
ALEXNET_FC_SHARE = 1e-4
#: - a layer under a max pool takes the flips' rerouted elements, each one
#:   term of a weight gradient's sum over 16 x 27 x 27 positions or more:
ALEXNET_CONV_SHARE = 0.1
#: After the third, every layer's forward carries the first step's flips
#: (the last run read 7.6e-5 to 1.6e-4 absolute at conv3-fc7):
ALEXNET_DRIFT_SHARE = 0.25
#: faulty card runs, each against the same CPU run, that the first-update
#: limits must reject: every dropout key folded once more (another mask;
#: every layer's gradient changes), and the LRN backward given the
#: denominator of k = 1 where the forward used k = 2 (conv1's and conv2's
#: gradients scale by 2^0.75, a share of ~0.68)
ALEXNET_FAULTS = ("dropout_key", "lrn_backward_k")
#: card vs CPU weights after 50 committed updates: cuBLAS and the CPU
#: sum the GEMMs in different orders over 50 steps; weights are O(0.1)
TRAIN_ATOL = 1e-4
#: the repo's LM config at full width (bench.py's lm config)
LM_CONFIG = dict(vocab=256, d_model=512, n_heads=8, n_layers=8, max_len=512)
#: the flash kernels' main shape: (b, h, s, dh) of that config's train
#: step at minibatch 32, causal
FLASH_MAIN = (32, 8, 512, 64)
#: flash kernels vs plain versions, outputs and gradients O(1): sums of up
#: to 512 terms in another order than cuBLAS's (~1e-6 expected); the
#: peaked case (scores near ±100) scales the limit by the output's size
FLASH_ATOL = 1e-4
#: the backward kernels (3xTF32 on the tensor cores) against an fp64 plain
#: version on the same inputs: their max abs error at most this many times
#: the fp32 plain version's (fp32 accuracy; one TF32 product would not be)
FLASH_FP64_FACTOR = 4.0
#: the char-LM train phase: loader seq_len 513 (s = 512 after the shift),
#: 320 train / 64 validation sequences at minibatch 32 = 10 train steps
#: and 2 validation minibatches in one epoch
LM_TRAIN = {"loader": {"minibatch_size": 32, "n_train": 320, "n_valid": 64,
                       "seq_len": 513, "vocab": 256},
            "trainer": dict(LM_CONFIG, learning_rate=1e-3),
            "decision": {"max_epochs": 1, "fail_iterations": 10}}
#: card vs CPU at d_model 512, 8 heads, 2 layers, s 128, minibatch 4: one
#: validation minibatch, then 3 Adam updates
LM_SMALL = {"loader": {"minibatch_size": 4, "n_train": 12, "n_valid": 4,
                       "seq_len": 129, "vocab": 256},
            "trainer": dict(LM_CONFIG, n_layers=2, learning_rate=1e-3),
            "decision": {"max_epochs": 1, "fail_iterations": 10}}
#: a tensor's gap is ||card - CPU|| / ||CPU - initial|| (initial weights
#: are bit-equal).  Adam's first updates are close to lr.sign(g), so an
#: element whose gradient is near 0 and differs in sign by roundoff moves
#: a whole step the other way; a norm weighs such elements against the
#: tensor's whole movement.  Limits after the first and the third update,
#: set from one sound run (worst tensor 1.1e-4 after the first update,
#: 2.0e-3 after the third) and the two faulty runs below (worst 1.48 and
#: 0.89 after the first): 87x above the sound reading and 89x below the
#: weaker fault; the third-update limit 25x above its sound reading
LM_FIRST_SHARE = 0.01
LM_THIRD_SHARE = 0.05
#: faulty card runs the first-update limit must reject: the flash backward
#: launched with causal=False, and given the sm_scale of head_dim / 2
LM_FAULTS = ("bwd_not_causal", "bwd_other_scale")


def check(cond, what):
    if not cond:
        raise RuntimeError("chip smoke failed: %s" % what)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, "nvidia-smi: %s" % out.stderr.strip())
    return out.stdout.strip().splitlines()[0]


def time_ms(fns, torch, calls=10, reps=25):
    """Median over ``reps`` of the card time of one call, each rep
    timing ``calls`` back-to-back calls between two CUDA events.  The
    calls cycle through ``fns`` (one per copy of the inputs, so a call
    finds its operands cold in the 50 MB L2, as a serving step finds the
    next layer's pool), and a spin kernel keeps the card busy while the
    host enqueues them, so the host's per-call overhead stays out of the
    card time."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fns[0]()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # spin for twice the host's enqueue time (at most 2.5 GHz)
    cycles = int(2 * 2.5e9 * host_s * calls) + 100000
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for k in range(calls):
            fns[k % len(fns)]()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def bound(n_bytes, n_flops, flop_s=FP32_FLOP_S):
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = n_flops / flop_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ kernels
def live_pages(ptab_width, page, pos, c, window=None, sinks=0,
               prefill=False):
    """How many pages of each lane's table hold a key live for any of
    its query rows — the pages the CUDA kernels read (``page_live`` in
    the source), which is what a bound counts."""
    out = []
    for p in pos:
        n = 0
        for j in range(ptab_width):
            kb = j * page
            live = kb < p if prefill else kb <= p + c - 1
            if window:
                live = live and (kb + page - 1 > p - window or kb < sinks)
            n += bool(live)
        out.append(n)
    return out


def decode_case(torch, HK, A, b=8, h=8, kv=8, c=1, dh=64, page=32, m=16,
                window=None, sinks=0, seed=0, timed=True):
    dev = torch.device("cuda")
    rng = numpy.random.RandomState(seed)
    n_pages = b * m + 1
    q = torch.as_tensor(rng.randn(b, h, c, dh).astype(numpy.float32),
                        device=dev)
    kp = torch.as_tensor(rng.randn(n_pages, kv, page, dh).astype(
        numpy.float32), device=dev)
    vp = torch.as_tensor(rng.randn(n_pages, kv, page, dh).astype(
        numpy.float32), device=dev)
    ptab_h = (1 + rng.permutation(b * m)).reshape(b, m).astype(numpy.int32)
    # lanes deep in their tables, as a long-running batch sits
    pos_h = rng.randint(m * page - 32, m * page - c + 1, b).astype(
        numpy.int32)
    ptab = torch.as_tensor(ptab_h, device=dev)
    pos = torch.as_tensor(pos_h, device=dev)

    got = HK.paged_flash_decode(q, kp, vp, ptab, pos, window, sinks)
    ref = HK.paged_flash_decode_ref(q, kp, vp, ptab, pos, window, sinks)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    check(err <= KERNEL_ATOL, "decode max abs err %g > %g" % (err,
                                                             KERNEL_ATOL))
    shape = {"b": b, "h": h, "kv": kv, "c": c, "dh": dh, "page": page,
             "m": m, "window": window, "sinks": sinks}
    if not timed:
        return {"kernel": "paged_flash_decode", "shape": shape,
                "max_abs_err": err}
    pools = [(kp, vp)] + [(kp.clone(), vp.clone()) for _ in range(COPIES - 1)]
    ms = time_ms([lambda k=k, v=v: HK.paged_flash_decode(
        q, k, v, ptab, pos, window, sinks) for k, v in pools], torch)
    plain_ms = time_ms([lambda k=k, v=v: HK.paged_flash_decode_ref(
        q, k, v, ptab, pos, window, sinks) for k, v in pools], torch)
    # library yardstick: SDPA on the gathered, head-repeated view
    views = [(A._repeat_kv(A.paged_view(k, ptab), h),
              A._repeat_kv(A.paged_view(v, ptab), h)) for k, v in pools]
    mask = A.chunk_live_mask(pos.long(), c, m * page, window, sinks)[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_err = (sdpa(q, *views[0], attn_mask=mask)
                   - ref).abs().max().item()
    library_ms = time_ms([lambda kx=kx, vx=vx: sdpa(q, kx, vx,
                                                    attn_mask=mask)
                          for kx, vx in views], torch)
    pages = sum(live_pages(m, page, pos_h, c, window, sinks))
    n_bytes = (2 * q.numel() * 4 + ptab.numel() * 4 + pos.numel() * 4
               + pages * 2 * kv * page * dh * 4)
    n_flops = 4 * (h // kv) * c * pages * kv * page * dh
    bound_ms, bound_by = bound(n_bytes, n_flops)
    return {"kernel": "paged_flash_decode",
            "shape": dict(shape, live_pages=pages),
            "max_abs_err": err, "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_max_abs_err": library_err,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": n_bytes}


def prefill_case(torch, HK, A, n_hist, b=1, h=8, kv=8, dh=64, page=32,
                 m=16, window=None, sinks=0, seed=1, timed=True):
    dev = torch.device("cuda")
    rng = numpy.random.RandomState(seed)
    n_pages = b * m + 1
    c = page

    def t(*shape):
        return torch.as_tensor(rng.randn(*shape).astype(numpy.float32),
                               device=dev)

    q, kn, vn = t(b, h, c, dh), t(b, kv, c, dh), t(b, kv, c, dh)
    kp, vp = t(n_pages, kv, page, dh), t(n_pages, kv, page, dh)
    ptab = torch.as_tensor((1 + rng.permutation(b * m)).reshape(b, m)
                           .astype(numpy.int32), device=dev)
    pos_h = numpy.full(b, n_hist * page, numpy.int32)
    pos = torch.as_tensor(pos_h, device=dev)
    kr, vr = kp.clone(), vp.clone()
    got, _, _ = HK.paged_flash_prefill(q, kn, vn, kp, vp, ptab, pos,
                                       window, sinks)
    ref, _, _ = HK.paged_flash_prefill_ref(q, kn, vn, kr, vr, ptab, pos,
                                           window, sinks)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    check(err <= KERNEL_ATOL, "prefill max abs err %g > %g"
          % (err, KERNEL_ATOL))
    check(torch.equal(kp, kr) and torch.equal(vp, vr),
          "prefill install is not bit-equal to the plain version's")
    shape = {"b": b, "h": h, "kv": kv, "c": c, "dh": dh, "page": page,
             "m": m, "window": window, "sinks": sinks, "n_hist": n_hist}
    if not timed:
        return {"kernel": "paged_flash_prefill", "shape": shape,
                "max_abs_err": err}
    pools = [(kp, vp)] + [(kp.clone(), vp.clone()) for _ in range(COPIES - 1)]
    ms = time_ms([lambda k=k, v=v: HK.paged_flash_prefill(
        q, kn, vn, k, v, ptab, pos, window, sinks) for k, v in pools], torch)
    plain_ms = time_ms([lambda k=k, v=v: HK.paged_flash_prefill_ref(
        q, kn, vn, k, v, ptab, pos, window, sinks) for k, v in pools], torch)
    views = [(A._repeat_kv(A.paged_view(k, ptab), h),
              A._repeat_kv(A.paged_view(v, ptab), h)) for k, v in pools]
    mask = A.chunk_live_mask(pos.long(), c, m * page, window, sinks)[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_err = (sdpa(q, *views[0], attn_mask=mask)
                   - ref).abs().max().item()
    library_ms = time_ms([lambda kx=kx, vx=vx: sdpa(q, kx, vx,
                                                    attn_mask=mask)
                          for kx, vx in views], torch)
    hist = sum(live_pages(m, page, pos_h, c, window, sinks,
                             prefill=True))
    keys = c * hist * page + b * c * (c + 1) // 2      # over all rows
    n_bytes = (2 * q.numel() * 4 + 4 * kn.numel() * 4 + ptab.numel() * 4
               + pos.numel() * 4 + hist * 2 * kv * page * dh * 4)
    n_flops = 4 * h * keys * dh
    bound_ms, bound_by = bound(n_bytes, n_flops)
    return {"kernel": "paged_flash_prefill",
            "shape": dict(shape, history_pages=hist),
            "max_abs_err": err, "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_max_abs_err": library_err,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": n_bytes}


# ---------------------------------------------------------------- fused SGD
def sgd_operands(torch, shape, seed, copies=1):
    """``copies`` sets of (p, v, g) of ``shape`` on the card (g a batch
    sum of 100 samples)."""
    rng = numpy.random.RandomState(seed)
    n = int(numpy.prod(shape))
    dev = torch.device("cuda")

    def t(a):
        return torch.as_tensor(a.astype(numpy.float32).reshape(shape),
                               device=dev)

    out = [(t(rng.uniform(-0.3, 0.3, n)), t(rng.randn(n) * 0.01),
            t(rng.randn(n) * 5))]
    return out + [tuple(x.clone() for x in out[0])
                  for _ in range(copies - 1)]


def sgd_ulps(torch, got, ref):
    """(max |got - ref| in ulps of ref, count of unequal elements)."""
    a = ref.abs()
    ulp = torch.nextafter(a, torch.full_like(a, float("inf"))) - a
    return ((got - ref).abs() / ulp).max().item(), int((got != ref).sum())


def sgd_case(torch, HK, shapes, name, wd=0.0, l1=0.0, clip=None, seed=0,
             copies=1):
    """One update of each of ``shapes`` (momentum 0.9, lr 0.03, batch
    100): checked against the plain version, then timed as one call that
    updates them all."""
    sets = [sgd_operands(torch, shape, seed + i, copies)
            for i, shape in enumerate(shapes)]
    args = (100, 0.03, 0.9, wd, l1, clip)
    worst, unequal = 0.0, 0
    for ops in sets:
        p, v, g = ops[0]
        got = HK.fused_sgd_update(p, v, g, *args)
        ref = HK.fused_sgd_update_ref(p, v, g, *args)
        torch.cuda.synchronize()
        for x, y in zip(got, ref):
            ulps, neq = sgd_ulps(torch, x, y)
            worst, unequal = max(worst, ulps), unequal + neq
    check(worst <= SGD_MAX_ULPS, "fused_sgd_update %s: %g ulps > %g"
          % (name, worst, SGD_MAX_ULPS))

    def step(fn, k):
        return lambda: [fn(*ops[k], *args) for ops in sets]

    ms = time_ms([step(HK.fused_sgd_update, k) for k in range(copies)],
                 torch)
    plain_ms = time_ms([step(HK.fused_sgd_update_ref, k)
                        for k in range(copies)], torch, calls=3, reps=5)
    n = sum(int(numpy.prod(s)) for s in shapes)
    # read p, v, g and write p', v' once: 20 bytes; ~10 flops an element
    bound_ms, bound_by = bound(20 * n, 10 * n)
    return {"kernel": "fused_sgd_update", "case": name,
            "shapes": [list(s) for s in shapes], "elements": n,
            "weight_decay": wd, "l1_vs_l2": l1, "clip": clip,
            "max_abs_err": max((x - y).abs().max().item()
                               for x, y in zip(got, ref)),
            "max_ulps": worst, "unequal": unequal, "kernel_ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by}


def sgd_cases(torch, HK):
    big = (4096, 4096)
    return [sgd_case(torch, HK, MNIST_PARAMS, "mnist_fc_step"),
            sgd_case(torch, HK, ALEXNET_PARAMS, "alexnet_step", wd=0.0005,
                     seed=50),
            sgd_case(torch, HK, [big], "fc_4096x4096", seed=10, copies=2),
            sgd_case(torch, HK, [(1,), (127,), (129,)], "odd_sizes",
                     seed=20),
            sgd_case(torch, HK, MNIST_PARAMS, "decay_l1_mix", wd=0.0005,
                     l1=0.3, seed=30),
            sgd_case(torch, HK, MNIST_PARAMS, "clip", wd=0.0005, l1=0.3,
                     clip=0.05, seed=40)]


# ---------------------------------------------------------------------- LRN
def close(torch, got, ref, tol):
    """Elementwise: |got - ref| <= atol + rtol |ref|."""
    rtol, atol = tol
    return (got - ref).abs() <= atol + rtol * ref.abs()


def within(torch, got, ref, tol):
    """(max |got - ref|, True when every element is within atol + rtol
    |ref|)."""
    return (got - ref).abs().max().item(), bool(close(torch, got, ref,
                                                      tol).all())


def lrn_faults(torch, HK, x, dy, y_ref, d_ref, dx_ref, hyper, k):
    """({fault: elements outside the limits}, the cross-channel term's
    rms share of dx) for faulty plain versions: the forward without its
    window (d = k), the backward without its cross-channel term, and
    (even n only) the backward summing the forward's window instead of
    its transpose.  Each count must be nonzero, or the check could not
    see that fault."""
    alpha, beta, n = hyper
    s = HK._lrn_scalars(alpha, beta, n, k)
    d_flat = torch.full_like(x, float(s["k"]))
    dpow = torch.pow(d_ref, float(s["neg_beta_1"]))
    direct = dy * (d_ref * dpow)
    out = {"fwd_without_window": int((~close(
               torch, x * torch.pow(d_flat, float(s["neg_beta"])), y_ref,
               LRN_FWD_TOL)).sum() + (~close(torch, d_flat, d_ref,
                                            LRN_FWD_TOL)).sum()),
           "bwd_without_cross_term": int((~close(
               torch, direct, dx_ref, LRN_BWD_TOL)).sum())}
    if n % 2 == 0:
        inner = HK._window_sum(dy * x * dpow, n, n // 2)
        out["bwd_forward_window"] = int((~close(
            torch, direct - float(s["coef"]) * x * inner, dx_ref,
            LRN_BWD_TOL)).sum())
    return out, ((direct - dx_ref).norm() / dx_ref.norm()).item()


def lrn_case(torch, HK, name, shape, n=5, seed=0, timed=True):
    """Kernels 2 and 3 on an NHWC ``shape`` against their plain versions
    (and, timed, against local_response_norm on the NCHW view)."""
    dev = torch.device("cuda")
    rng = numpy.random.RandomState(seed)
    c = shape[-1]
    rows = int(numpy.prod(shape[:-1]))
    # non-negative inputs (post-ReLU) of rms 3 and an O(1) cotangent, so
    # that the window term of d and the backward's cross-channel term
    # both sit well above the limits (``lrn_faults`` counts by how much)
    x = torch.as_tensor(3 * numpy.abs(rng.randn(*shape)).astype(
        numpy.float32), device=dev)
    dy = torch.as_tensor(rng.randn(*shape).astype(numpy.float32),
                         device=dev)
    hyper = (1e-4, 0.75, n)
    y, d = HK.lrn_forward(x, *hyper, 2.0)
    dx = HK.lrn_backward(x, d, dy, *hyper)
    y_ref, d_ref = HK.lrn_forward_ref(x, *hyper, 2.0)
    dx_ref = HK.lrn_backward_ref(x, d_ref, dy, *hyper)
    torch.cuda.synchronize()
    fwd_err, fwd_ok = within(torch, y, y_ref, LRN_FWD_TOL)
    d_err, d_ok = within(torch, d, d_ref, LRN_FWD_TOL)
    bwd_err, bwd_ok = within(torch, dx, dx_ref, LRN_BWD_TOL)
    check(fwd_ok and d_ok, "lrn_forward %s: max abs err %g / %g beyond "
          "%r" % (name, fwd_err, d_err, LRN_FWD_TOL))
    check(bwd_ok, "lrn_backward %s: max abs err %g beyond %r"
          % (name, bwd_err, LRN_BWD_TOL))
    faults, cross_share = lrn_faults(torch, HK, x, dy, y_ref, d_ref, dx_ref,
                                     hyper, 2.0)
    check(all(v > 0 for v in faults.values()), "lrn %s: a fault would pass "
          "the limits: %r" % (name, faults))
    shape = {"rows": rows, "c": c, "n": n}
    fwd = {"kernel": "lrn_forward", "case": name, "shape": shape,
           "max_abs_err": max(fwd_err, d_err), "faults_caught": {
               k: v for k, v in faults.items() if k.startswith("fwd")}}
    bwd = {"kernel": "lrn_backward", "case": name, "shape": shape,
           "max_abs_err": bwd_err, "cross_term_rms_share": cross_share,
           "faults_caught": {k: v for k, v in faults.items()
                             if k.startswith("bwd")}}
    if not timed:
        return fwd, bwd
    xs = [x] + [x.clone() for _ in range(COPIES - 1)]
    ds = [d] + [d.clone() for _ in range(COPIES - 1)]
    # the library: local_response_norm on the NHWC tensor's NCHW view
    lib = torch.nn.functional.local_response_norm
    xv = [t.permute(0, 3, 1, 2) for t in xs]
    lib_err = (lib(xv[0], n, *hyper[:2], 2.0).permute(0, 2, 3, 1)
               - y_ref).abs().max().item()
    leaves = [t.detach().clone().requires_grad_() for t in xv]
    outs = [lib(t, n, *hyper[:2], 2.0) for t in leaves]
    dyv = dy.permute(0, 3, 1, 2)
    elems = rows * c
    fwd.update(
        kernel_ms=time_ms([lambda t=t: HK.lrn_forward(t, *hyper, 2.0)
                           for t in xs], torch),
        plain_ms=time_ms([lambda t=t: HK.lrn_forward_ref(t, *hyper, 2.0)
                          for t in xs], torch, calls=3, reps=5),
        library_ms=time_ms([lambda t=t: lib(t, n, *hyper[:2], 2.0)
                            for t in xv], torch, calls=3, reps=5),
        library_max_abs_err=lib_err, bytes=12 * elems)
    fwd["bound_ms"], fwd["bound_by"] = bound(12 * elems, (n + 4) * elems)
    bwd.update(
        kernel_ms=time_ms([lambda t=t, e=e: HK.lrn_backward(t, e, dy,
                                                            *hyper)
                           for t, e in zip(xs, ds)], torch),
        plain_ms=time_ms([lambda t=t, e=e: HK.lrn_backward_ref(t, e, dy,
                                                               *hyper)
                          for t, e in zip(xs, ds)], torch, calls=3,
                         reps=5),
        library_ms=time_ms([lambda o=o, t=t: torch.autograd.grad(
            o, t, dyv, retain_graph=True) for o, t in zip(outs, leaves)],
            torch, calls=3, reps=5),
        bytes=16 * elems)
    bwd["bound_ms"], bwd["bound_by"] = bound(16 * elems, (n + 8) * elems)
    return fwd, bwd


# ------------------------------------------------------------------ dropout
def dropout_case(torch, HK, prng, name, shape, rate=0.5, seed=0,
                 timed=True):
    """Kernel 4 against its plain version: bit-equal, 0 unequal."""
    dev = torch.device("cuda")
    x = torch.as_tensor(numpy.random.RandomState(seed).randn(*shape)
                        .astype(numpy.float32), device=dev)
    key = prng.fold_in(prng.PRNGKey(SEED), seed)
    got = HK.dropout(x, key, rate)
    ref = HK.dropout_ref(x, key, rate)
    torch.cuda.synchronize()
    unequal = int((got != ref).sum().item())
    check(unequal == 0, "dropout %s: %d elements differ from the plain "
          "version" % (name, unequal))
    n = x.numel()
    out = {"kernel": "dropout", "case": name, "shape": list(shape),
           "rate": rate, "unequal": unequal,
           "max_abs_err": (got - ref).abs().max().item(),
           "kept_share": (got != 0).float().mean().item()}
    if not timed:
        return out
    xs = [x] + [x.clone() for _ in range(COPIES - 1)]
    out.update(
        kernel_ms=time_ms([lambda t=t: HK.dropout(t, key, rate)
                           for t in xs], torch),
        plain_ms=time_ms([lambda t=t: HK.dropout_ref(t, key, rate)
                          for t in xs], torch, calls=3, reps=5),
        library_ms=None, bytes=8 * n, int_ops=DROPOUT_OPS * n)
    t_bytes = 8 * n / HBM_BYTES_S * 1e3
    t_ops = DROPOUT_OPS * n / INT32_OP_S * 1e3
    out["bound_ms"], out["bound_by"] = ((t_bytes, "bytes") if t_bytes >= t_ops
                                        else (t_ops, "operations"))
    return out


# ------------------------------------------------------- flash attention
def flash_faults(torch, HK, q, k, v, do, causal, o_ref, grads_ref, limit):
    """{fault: elements outside the limits} for four faulty plain
    versions: the causal mask as col < row (the forward; its row 0 has no
    key left, so NaN, which counts as outside), the backward without di,
    dQ without sm_scale, and the backward's products as one TF32 product
    each (what a kernel that dropped 3xTF32's small parts computes).  Each
    count must be nonzero, or the checks could not see that fault."""
    scale = float(1.0 / q.shape[-1] ** 0.5)

    def outside(got, want):
        return int((~((got - want).abs() <= limit)).sum().item())

    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    rows = torch.arange(q.shape[-2], device=q.device)[:, None]
    cols = torch.arange(k.shape[-2], device=q.device)[None, :]
    o_bad = torch.matmul(torch.softmax(s.masked_fill(
        cols >= rows, float("-inf")), dim=-1), v)
    del s
    out = {"mask_col_lt_row": outside(o_bad, o_ref)}
    del o_bad
    o, lse = HK.flash_attention_ref(q, k, v, causal)
    p = torch.exp(HK._flash_scores(q, k, causal, scale) - lse[..., None])
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = p * dp                                  # without di
    out["bwd_without_di"] = (outside(torch.matmul(ds, k) * scale,
                                     grads_ref[0])
                             + outside(torch.matmul(ds.transpose(-1, -2), q)
                                       * scale, grads_ref[1]))
    ds = p * (dp - (o * do).sum(-1)[..., None])
    out["dq_without_scale"] = outside(torch.matmul(ds, k), grads_ref[0])
    del p, dp, ds
    prior = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = HK.flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prior
    out["tf32_single_product"] = sum(outside(got, want)
                                     for got, want in zip(tf32, grads_ref))
    return out


def flash_case(torch, HK, b, h, s, dh, causal=True, seed=0, timed=True,
               peak=None):
    """Kernels 7a, 7b, 7c at (b, h, s, dh) against their plain versions
    (both backward kernels take the plain forward's o and lse, so each
    is held alone); each backward kernel also against an fp64 plain
    version beside the fp32 one, and launched twice (bit-equal); timed,
    also against SDPA and its autograd backward.  ``peak`` scales q so
    the largest score reaches it.  Returns three records: forward, dK/dV,
    dQ."""
    dev = torch.device("cuda")
    rng = numpy.random.RandomState(seed)

    def t():
        return torch.as_tensor(rng.randn(b, h, s, dh).astype(numpy.float32),
                               device=dev)

    q, k, v, do = t(), t(), t(), t()
    if peak:
        q = q * (peak / (torch.matmul(q, k.transpose(-1, -2))
                         / dh ** 0.5).abs().max())
    o, lse = HK.flash_attention_fwd(q, k, v, causal)
    o_ref, lse_ref = HK.flash_attention_ref(q, k, v, causal)
    inputs = (q, k, v, o_ref, lse_ref, do)
    dk, dv = HK.flash_attention_bwd_dkv(*inputs, causal)
    dq = HK.flash_attention_bwd_dq(*inputs, causal)
    # no atomics in either pass: a second launch repeats bit for bit
    dk2, dv2 = HK.flash_attention_bwd_dkv(*inputs, causal)
    dq2 = HK.flash_attention_bwd_dq(*inputs, causal)
    grads_ref = HK.flash_attention_bwd_ref(*inputs, causal)
    torch.cuda.synchronize()
    shape = (b, h, s, dh, causal, peak)
    repeat = all(torch.equal(x, y) for x, y in ((dq, dq2), (dk, dk2),
                                                 (dv, dv2)))
    check(repeat, "flash backward at %r: two launches differ" % (shape,))
    del dq2, dk2, dv2
    errs = {}
    for name, got, want in (("o", o, o_ref), ("lse", lse, lse_ref),
                            ("dq", dq, grads_ref[0]), ("dk", dk, grads_ref[1]),
                            ("dv", dv, grads_ref[2])):
        limit = FLASH_ATOL * (max(want.abs().max().item(), 1.0) if peak
                              else 1.0)
        errs[name] = (got - want).abs().max().item()
        check(bool(torch.isfinite(got).all()) and errs[name] <= limit,
              "flash %s at %r: max abs err %g > %g"
              % (name, shape, errs[name], limit))
    # the same function in fp64 on the same inputs: the kernels' error
    # beside the fp32 plain version's
    grads64 = HK.flash_attention_bwd_ref(*(x.double() for x in inputs),
                                         causal)
    fp64 = {}
    for name, got, plain, want in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                      grads_ref, grads64):
        fp64[name] = {"kernel": (got.double() - want).abs().max().item(),
                      "plain_fp32": (plain.double() - want).abs().max()
                      .item()}
        check(fp64[name]["kernel"]
              <= FLASH_FP64_FACTOR * fp64[name]["plain_fp32"],
              "flash %s at %r against fp64: kernel %g > %g x the fp32 "
              "plain version's %g" % (name, shape, fp64[name]["kernel"],
                                      FLASH_FP64_FACTOR,
                                      fp64[name]["plain_fp32"]))
    del grads64
    shape = {"b": b, "h": h, "s": s, "dh": dh, "causal": causal,
             "peak": peak}
    recs = [{"kernel": "flash_attention_fwd", "shape": shape,
             "max_abs_err": max(errs["o"], errs["lse"])},
            {"kernel": "flash_attention_bwd_dkv", "shape": shape,
             "max_abs_err": max(errs["dk"], errs["dv"]),
             "fp64_err": {n: fp64[n] for n in ("dk", "dv")},
             "bit_equal_repeat": repeat},
            {"kernel": "flash_attention_bwd_dq", "shape": shape,
             "max_abs_err": errs["dq"], "fp64_err": {"dq": fp64["dq"]},
             "bit_equal_repeat": repeat}]
    if not timed:
        return recs
    faults = flash_faults(torch, HK, q, k, v, do, causal, o_ref, grads_ref,
                          FLASH_ATOL)
    check(all(n > 0 for n in faults.values()), "flash: a fault would pass "
          "the limits: %r" % faults)
    recs[0]["faults_caught"] = {"mask_col_lt_row": faults["mask_col_lt_row"]}
    recs[1]["faults_caught"] = {n: faults[n] for n in (
        "bwd_without_di", "tf32_single_product")}
    recs[2]["faults_caught"] = {n: faults[n] for n in (
        "dq_without_scale", "bwd_without_di", "tf32_single_product")}
    del grads_ref
    # the main path hands both backward kernels one di per backward
    operands = inputs + (HK.flash_attention_di(o_ref, do),)
    sets = [operands] + [tuple(x.clone() for x in operands)
                         for _ in range(COPIES - 1)]
    fwd_ms = time_ms([lambda a=a: HK.flash_attention_fwd(*a[:3], causal)
                      for a in sets], torch)
    dkv_ms = time_ms([lambda a=a: HK.flash_attention_bwd_dkv(
        *a[:6], causal, di=a[6]) for a in sets], torch)
    dq_ms = time_ms([lambda a=a: HK.flash_attention_bwd_dq(
        *a[:6], causal, di=a[6]) for a in sets], torch)
    di_ms = time_ms([lambda a=a: HK.flash_attention_di(a[3], a[5])
                     for a in sets], torch)
    fwd_plain = time_ms([lambda a=a: HK.flash_attention_ref(*a[:3], causal)
                         for a in sets[:2]], torch, calls=3, reps=5)
    bwd_plain = time_ms([lambda a=a: HK.flash_attention_bwd_ref(
        *a[:6], causal) for a in sets[:2]], torch, calls=3, reps=5)
    # the library: SDPA (fp32, is_causal) and its autograd backward, which
    # computes dq, dk and dv in one call (timed here, never used by the port)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_err = (sdpa(q, k, v, is_causal=causal) - o_ref).abs().max().item()
    lib_fwd = time_ms([lambda a=a: sdpa(*a[:3], is_causal=causal)
                       for a in sets], torch, calls=3, reps=5)
    graphs = []
    for a in sets[:2]:
        leaves = [x.detach().clone().requires_grad_() for x in a[:3]]
        graphs.append((sdpa(*leaves, is_causal=causal), leaves, a[5]))
    lib_bwd = time_ms([lambda g=g: torch.autograd.grad(
        g[0], g[1], g[2], retain_graph=True) for g in graphs], torch,
        calls=3, reps=5)
    del graphs, sets
    # the work these inputs need: live (row, key) pairs, 2 flops a pair
    # and head column per product; each input read once, each output
    # written once.  The bound is 3xTF32 on the tensor cores (three TF32
    # products for each fp32-accurate one), the least time the card could
    # take for fp32 accuracy; fma_bound_ms is the same work as fp32 FMA
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    product = 2 * pairs * dh
    tensor = b * h * s * dh * 4
    row = b * h * s * 4
    for rec, n_products, n_bytes, ms, plain, lib in (
            (recs[0], 2, 4 * tensor + row, fwd_ms, fwd_plain, lib_fwd),
            (recs[1], 4, 6 * tensor + 2 * row, dkv_ms, bwd_plain, lib_bwd),
            (recs[2], 3, 5 * tensor + 2 * row, dq_ms, bwd_plain, lib_bwd)):
        flops = n_products * product
        rec["bound_ms"], rec["bound_by"] = bound(n_bytes, 3 * flops,
                                                 TF32_FLOP_S)
        rec.update(kernel_ms=ms, plain_ms=plain, library_ms=lib,
                   bytes=n_bytes, flops=flops,
                   fma_bound_ms=bound(n_bytes, flops)[0],
                   tflops_per_s=flops / ms * 1e-9)
    recs[0]["library_max_abs_err"] = lib_err
    for rec in recs[1:]:
        rec["plain_computes"] = rec["library_computes"] = "dq, dk and dv"
    # the backward's own work is 5 products (S, dP, dV, dK, dQ) from q, k,
    # v, o, do and lse to dq, dk, dv; the two passes recompute S and dP, 7
    # in all.  Beside SDPA's one backward call: the pair, and the pair with
    # the di reduction the backward runs before it
    recs[1]["backward_bound_ms"] = bound(8 * tensor + row, 3 * 5 * product,
                                         TF32_FLOP_S)[0]
    recs[1].update(di_ms=di_ms, pair_ms=dkv_ms + dq_ms,
                   pair_with_di_ms=dkv_ms + dq_ms + di_ms,
                   pair_over_library=(dkv_ms + dq_ms + di_ms) / lib_bwd)
    return recs


# -------------------------------------------------------------------- serve
def profile_steps(torch, step, n):
    """(busy share, {kernel: card us per step}) over ``n`` synchronous
    steps under torch.profiler.  The busy share is the union of the
    trace's kernel intervals over the wall time (None when the trace
    holds no kernel); the profiler's own host cost makes it a lower
    bound.  Kernel times sum each kernel's own intervals (the profiler's
    per-op device totals count a kernel twice: under the op that
    launched it and as itself)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(n):
            step()
        wall_us = (time.monotonic() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, end = 0.0, None
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in kernels):
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    per_kernel = {}
    for e in kernels:
        per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                              + e.time_range.elapsed_us() / n)
    return (busy / wall_us if kernels else None), per_kernel


def teacher_forced(torch, T, engine, seq, true_len, emitted):
    """Re-run ``seq`` (prompt + emitted) through the plain attention
    path on a fresh single-lane pool; returns (worst logit shortfall of
    an emitted token below its row max, exact argmax matches)."""
    page, dev = engine.prefill_chunk, engine.device
    n = -(-len(seq) // page)
    pools = [(torch.zeros((n + 1,) + k.shape[1:], device=dev),
              torch.zeros((n + 1,) + k.shape[1:], device=dev))
             for k, _ in engine._kv_pools]
    ptab = torch.zeros(1, engine.max_len // page, dtype=torch.int32,
                       device=dev)
    ptab[0, :n] = torch.arange(1, n + 1, dtype=torch.int32)
    toks = numpy.zeros(n * page, numpy.int32)
    toks[:len(seq)] = seq
    logits = []
    for start in range(0, n * page, page):
        h, _ = T.paged_chunk_apply(
            engine.params, torch.as_tensor(toks[None, start:start + page],
                                           device=dev),
            pools, ptab, torch.tensor([start], dtype=torch.int32,
                                      device=dev),
            engine.n_heads, attn_kernel=None)
        logits.append(T.head_logits(engine.params, h)[0])
    logits = torch.cat(logits)[true_len - 1:true_len - 1 + len(emitted)]
    tok = torch.as_tensor(emitted, device=dev).long()
    picked = logits.gather(1, tok[:, None])[:, 0]
    short = (logits.max(dim=1).values - picked).max().item()
    exact = int((logits.argmax(dim=1) == tok).sum().item())
    return short, exact


def serve(torch, HK, T, S, card):
    from veles_tpu_torch import prng
    cfg = LM_CONFIG
    t0 = time.monotonic()
    host = T.init_transformer_params(
        prng.RandomGenerator("init", SEED), cfg["vocab"],
        d_model=cfg["d_model"], n_heads=cfg["n_heads"],
        n_layers=cfg["n_layers"], max_len=cfg["max_len"])
    engine = S.LMEngine(host, cfg["n_heads"], cfg["max_len"], slots=8,
                        paged_kv=True, prefill_chunk=32, device="cuda",
                        name="chip_smoke")
    engine.start()
    setup_s = time.monotonic() - t0
    rng = numpy.random.RandomState(SEED)
    reqs = [(rng.randint(0, cfg["vocab"], rng.randint(20, 301))
             .astype(numpy.int32), int(rng.randint(32, 65)))
            for _ in range(16)]
    HK.reset_launch_counts()
    t0 = time.monotonic()
    futures = [engine.submit(p, k) for p, k in reqs]
    outs = [f.result(timeout=300) for f in futures]
    wall = time.monotonic() - t0
    launches = HK.launch_counts()
    engine.stop()
    m = engine.metrics
    check(m.errors == 0, "%d engine errors" % m.errors)
    for out, (_, k) in zip(outs, reqs):
        check(out.shape == (k,) and out.min() >= 0
              and out.max() < cfg["vocab"], "malformed output %r" % out)
    steps, chunks = (m.counter("decode_dispatches"),
                     m.counter("prefill_dispatches"))
    check(launches["paged_flash_decode"] == cfg["n_layers"] * steps > 0,
          "decode launches %d for %d steps" % (launches["paged_flash_decode"],
                                               steps))
    check(launches["paged_flash_prefill"] == cfg["n_layers"] * chunks > 0,
          "prefill launches %d for %d chunks"
          % (launches["paged_flash_prefill"], chunks))
    inv = engine.verify_pool_invariants()
    check(inv["free_pages"] == engine._pool.num_pages,
          "pool did not get every page back: %r" % inv)

    worst, exact, total = 0.0, 0, 0
    with torch.inference_mode():
        for (prompt, _), out in zip(reqs, outs):
            seq = numpy.concatenate([prompt, out])
            short, n_exact = teacher_forced(torch, T, engine, seq,
                                            len(prompt), out)
            worst = max(worst, short)
            exact += n_exact
            total += len(out)
        check(worst <= LOGIT_TOL, "an emitted token's logit sits %g below "
              "its row max (tolerance %g)" % (worst, LOGIT_TOL))
        # decode step alone: all 8 lanes 16 pages deep, every table
        # entry a distinct pool page (the 128 pages the serve freed)
        w = engine._max_pages
        ptabs = (1 + numpy.arange(engine.slots * w, dtype=numpy.int32)
                 ).reshape(engine.slots, w)
        pos = numpy.full(engine.slots, engine.max_len - 1, numpy.int32)
        last = numpy.zeros(engine.slots, numpy.int32)
        engine._step_program(ptabs, last, pos)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        for _ in range(20):
            engine._step_program(ptabs, last, pos)
        step_ms = (time.monotonic() - t1) / 20 * 1e3
        busy, _ = profile_steps(torch, lambda: engine._step_program(
            ptabs, last, pos), 10)
    ttft = sorted(f.ttft_s for f in futures)
    tokens = sum(len(o) for o in outs)
    report = {"phase": "serve", "card": card, "config": cfg,
              "slots": 8, "page": 32, "requests": len(reqs),
              "tokens": tokens, "wall_s": wall,
              "tokens_per_s": tokens / wall,
              "ttft_p50_s": statistics.median(ttft),
              "ttft_max_s": ttft[-1],
              "dispatch_ms_mean": m.decode_step.sum / m.decode_step.total
              * 1e3,
              "decode_step_ms_full_width": step_ms,
              "decode_step_device_busy_share": busy,
              "decode_dispatches": steps, "prefill_dispatches": chunks,
              "launches": launches, "setup_s": setup_s,
              "teacher_forced": {"worst_shortfall": worst,
                                 "exact_argmax": exact, "tokens": total,
                                 "tolerance": LOGIT_TOL}}
    print(json.dumps(report), flush=True)
    return launches


# -------------------------------------------------------------------- train
def mnist_run(prng, root, mnist, device, **overrides):
    """Seeded MNIST-FC sample run through ``mnist.train`` (sample
    defaults: 784→100 tanh→10 softmax, minibatch 100, lr 0.03, momentum
    0.9), with ``overrides`` for the loader and decision."""
    prng.reset()
    prng.seed_all(SEED)
    root.__dict__.pop("mnist", None)
    mnist.default_config()
    return mnist.train(fused=True, device=device, **overrides)


def train(torch, HK, card, device="cuda"):
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples import mnist

    # full width and full data, 2 epochs
    prng.reset()
    prng.seed_all(SEED)
    root.__dict__.pop("mnist", None)
    mnist.default_config()
    t0 = time.monotonic()
    wf = mnist.build(fused=True, decision={"max_epochs": 2})
    wf.initialize(device=device)
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    HK.reset_launch_counts()
    t0 = time.monotonic()
    wf.run()
    torch.cuda.synchronize()
    run_s = time.monotonic() - t0
    launches = HK.launch_counts()
    metrics = wf.decision.epoch_metrics
    check(len(metrics) == 2, "%d epochs ran, not 2" % len(metrics))
    val = [m["validation"] for m in metrics]
    steps = wf.fused_step.train_steps
    check(val[-1]["err_pct"] < 5.0, "validation err_pct %g >= 5"
          % val[-1]["err_pct"])
    check(val[1]["loss"] < val[0]["loss"], "validation loss did not fall: "
          "%r" % [v["loss"] for v in val])
    check(steps == 2 * 600 and launches["fused_sgd_update"] == 4 * steps,
          "fused_sgd_update launches %d for %d train minibatches"
          % (launches["fused_sgd_update"], steps))
    weights = [f.weights.mem for f in wf.forwards]
    check(all(numpy.isfinite(w).all() for w in weights),
          "non-finite weights after training")

    # device busy share of one fused train step (profiler, 20 steps)
    runner, loader = wf._fused_runner, wf.loader
    x = loader.original_data.devmem[:100]
    y = loader.original_labels.devmem[:100]
    mask = torch.ones(100, device=device)
    busy, _ = profile_steps(torch, lambda: (
        runner._train_step(runner.state, x, y, mask, 100),
        torch.cuda.synchronize()), 20)

    # the same seed on the card and on the CPU: 51 train minibatches, the
    # last gated by Decision (max_epochs 1), so 50 committed updates
    small = {"loader": {"n_train": 5100, "n_valid": 1000},
             "decision": {"max_epochs": 1}}
    on_card = mnist_run(prng, root, mnist, device, **small)
    on_cpu = mnist_run(prng, root, mnist, "cpu", **small)
    worst = 0.0
    for a, b in zip(on_card.forwards, on_cpu.forwards):
        for va, vb in ((a.weights, b.weights), (a.bias, b.bias)):
            worst = max(worst, float(numpy.abs(va.mem - vb.mem).max()))
    check(worst <= TRAIN_ATOL, "card vs CPU weights differ by %g > %g"
          % (worst, TRAIN_ATOL))
    report = {"phase": "train", "card": card,
              "config": {"layers": "784-100tanh-10softmax",
                         "minibatch": 100, "n_train": 60000,
                         "n_valid": 10000, "epochs": 2, "fused": True},
              "setup_s": setup_s, "run_s": run_s,
              "s_per_epoch": run_s / 2,
              "train_samples_per_s": 2 * 60000 / run_s,
              "train_steps": steps, "launches": launches,
              "step_device_busy_share": busy,
              "validation": [{k: v[k] for k in ("n_err", "err_pct", "loss")}
                             for v in val],
              "card_vs_cpu_max_abs_weight_diff": worst,
              "card_vs_cpu_committed_updates": 50,
              "tolerance": TRAIN_ATOL}
    print(json.dumps(report), flush=True)
    return launches


# ------------------------------------------------------------------ alexnet
def imagenet_build(prng, root, imagenet, layers, **loader):
    """A seeded ImageNet-sample workflow at ``layers`` on the synthetic
    loader (defaults: minibatch 128, 256x256, 1000 classes, 640 train /
    128 validation, 2 epochs)."""
    prng.reset()
    prng.seed_all(SEED)
    root.__dict__.pop("imagenet", None)
    loader = dict({"minibatch_size": 128, "records_path": None,
                   "n_train": 640, "n_valid": 128,
                   "image_hw": (256, 256), "n_classes": 1000}, **loader)
    epochs = loader.pop("epochs", 2)
    root.imagenet.update({"loader": loader,
                          "decision": {"max_epochs": epochs,
                                       "fail_iterations": 10},
                          "layers": layers})
    return imagenet.build(fused=True)


def committed_weights(run, device):
    """Initialize ``run`` on ``device`` and run it; returns each
    parameterized layer's (weights, bias) on the host at set-up and after
    every committed update."""
    run.initialize(device=device)
    runner, commit = run._fused_runner, run.fused_commit
    inner = commit.run

    def grab():
        return [[e[k].cpu().numpy().copy() for k in ("w", "b") if k in e]
                for e in runner.state if e]

    def run_and_keep():
        pending = run.fused_step.pending_state is not None
        inner()
        if pending:
            kept.append(grab())

    kept = [grab()]
    commit.run = run_and_keep
    run.run()
    return kept


def weight_gaps(card, cpu):
    """Per committed update (after the first, ..., the last) and per
    layer: the max |card - CPU| gap over weights and bias ("abs"), the
    CPU run's movement max |w - w0| ("movement"), and the gap as a share
    of the movement ("share")."""
    out = {"abs": [], "movement": [], "share": []}
    for k in range(1, len(cpu)):
        gaps = [max(float(numpy.abs(a - b).max()) for a, b in zip(x, y))
                for x, y in zip(card[k], cpu[k])]
        moved = [max(float(numpy.abs(a - b).max()) for a, b in zip(x, y))
                 for x, y in zip(cpu[k], cpu[0])]
        out["abs"].append(gaps)
        out["movement"].append(moved)
        out["share"].append([g / m for g, m in zip(gaps, moved)])
    return out


@contextlib.contextmanager
def fault(prng, name):
    """Within the block, ``name`` of ``ALEXNET_FAULTS`` is planted in the
    port's functional layer (the units look its functions up per call)."""
    from veles_tpu_torch.ops import functional as F
    if name == "dropout_key":
        attr, inner = "dropout", F.dropout

        def planted(x, rng, rate, train):
            return inner(x, rng if rng is None else prng.fold_in(rng, 1),
                         rate, train)
    else:
        attr, inner = "lrn_backward", F.lrn_backward

        def planted(x, d, err, *hyper):
            return inner(x, d - 1.0, err, *hyper)
    setattr(F, attr, planted)
    try:
        yield
    finally:
        setattr(F, attr, inner)


def alexnet(torch, HK, card, device="cuda", layers=None, small=None,
            **loader):
    """The ImageNet sample at full AlexNet width through
    ``imagenet.train``'s build + initialize + run, then card vs CPU."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples import imagenet
    layers = layers or imagenet.alexnet_layers()
    t0 = time.monotonic()
    wf = imagenet_build(prng, root, imagenet, layers, **loader)
    wf.initialize(device=device)
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    HK.reset_launch_counts()
    t0 = time.monotonic()
    wf.run()
    torch.cuda.synchronize()
    run_s = time.monotonic() - t0
    launches = HK.launch_counts()
    metrics = wf.decision.epoch_metrics
    check(len(metrics) == 2, "%d epochs ran, not 2" % len(metrics))
    steps = wf.fused_step.train_steps
    ld = wf.loader
    mb = ld.max_minibatch_size
    valid_mbs = 2 * -(-ld.class_lengths[1] // mb)
    check(steps == 2 * -(-ld.class_lengths[2] // mb),
          "%d train steps dispatched" % steps)
    # per train step: each LRN forward and backward once, each dropout
    # forward and backward, each parameter (weights, bias) one update;
    # each validation minibatch runs the LRN forwards (AlexNet: 2, 2, 4,
    # 16 per step)
    n_lrn = sum(1 for f in wf.forwards if f.layer_type == "norm")
    n_drop = sum(1 for f in wf.forwards if f.layer_type == "dropout")
    n_params = sum(2 for f in wf.forwards if f.has_params)
    want = {"lrn_forward": n_lrn * (steps + valid_mbs),
            "lrn_backward": n_lrn * steps, "dropout": 2 * n_drop * steps,
            "fused_sgd_update": n_params * steps}
    got = {k: launches[k] for k in want}
    check(got == want, "alexnet launches %r, expected %r" % (got, want))
    losses = [m[s]["loss"] for m in metrics for s in ("validation", "train")]
    check(all(numpy.isfinite(v) for v in losses), "non-finite loss %r"
          % losses)
    check(all(numpy.isfinite(f.weights.mem).all() for f in wf.forwards
              if f.has_params), "non-finite weights after training")

    # one steady train step: host clock over 5 synchronous steps, and the
    # card's busy share of it (profiler, 5 steps)
    runner = wf._fused_runner
    x = ld.original_data.devmem[:mb]
    y = ld.original_labels.devmem[:mb]
    mask = torch.ones(mb, device=device)
    key = prng.PRNGKey(SEED)

    def step():
        runner._train_step(runner.state, x, y, mask, mb, key)
        torch.cuda.synchronize()

    step()
    t0 = time.monotonic()
    for _ in range(5):
        step()
    step_s = (time.monotonic() - t0) / 5
    busy, per_kernel = profile_steps(torch, step, 5)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    ported = {tag: sum(v for k, v in per_kernel.items() if tag in k)
              for tag in ("lrn_fwd_kernel", "lrn_bwd_kernel",
                          "dropout_kernel", "fused_sgd_kernel")}

    # the same seed on the card and on the CPU at minibatch 16: 4 train
    # minibatches, the last gated by Decision (max_epochs 1), so 3
    # committed updates; then the faulty card runs
    small = dict(small or {"minibatch_size": 16, "n_train": 64,
                           "n_valid": 16}, epochs=1)

    def small_run(dev):
        return committed_weights(imagenet_build(
            prng, root, imagenet, layers, **dict(loader, **small)), dev)

    on_card, on_cpu = small_run(device), small_run("cpu")
    under_pool = [any(g.layer_type == "max_pooling"
                      for g in wf.forwards[i + 1:])
                  for i, f in enumerate(wf.forwards) if f.has_params]
    limits = [ALEXNET_CONV_SHARE if u else ALEXNET_FC_SHARE
              for u in under_pool]
    sound = weight_gaps(on_card, on_cpu)
    faults = {}
    for name in ALEXNET_FAULTS:
        with fault(prng, name):
            gaps = weight_gaps(small_run(device), on_cpu)
        faults[name] = {"abs": gaps["abs"], "share": gaps["share"]}
    card_vs_cpu = {
        "minibatch": small["minibatch_size"],
        "committed_updates": len(on_cpu) - 1,
        "layers": [f.layer_type for f in wf.forwards if f.has_params],
        "under_a_max_pool": under_pool, "first_update_limits": limits,
        "third_update_limit": ALEXNET_DRIFT_SHARE,
        "sound": sound, "faults": faults}
    report = {"phase": "alexnet", "card": card,
              "config": {"layers": "alexnet_layers()", "crop": 227,
                         "minibatch": mb, "image_hw": list(ld.image_hw),
                         "n_classes": ld.n_classes,
                         "n_train": ld.class_lengths[2],
                         "n_valid": ld.class_lengths[1], "epochs": 2,
                         "fused": True},
              "setup_s": setup_s, "run_s": run_s, "train_steps": steps,
              "validation_minibatches": valid_mbs,
              "s_per_step": step_s, "samples_per_s": mb / step_s,
              "step_device_busy_share": busy,
              "step_card_us": sum(per_kernel.values()),
              "step_top_kernels_us": [[k[:80], v] for k, v in top],
              "step_ported_kernels_us": ported,
              "launches": launches,
              "losses": [{s: m[s]["loss"] for s in ("validation", "train")}
                         for m in metrics],
              "card_vs_cpu": card_vs_cpu}
    print(json.dumps(report), flush=True)
    check(card_vs_cpu["committed_updates"] == 3, "%d committed updates, "
          "not 3" % card_vs_cpu["committed_updates"])
    check(all(g <= lim for g, lim in zip(sound["share"][0], limits))
          and max(sound["share"][-1]) <= ALEXNET_DRIFT_SHARE,
          "card vs CPU AlexNet weight gaps beyond their limits: %r"
          % sound["share"])
    for name, gaps in faults.items():
        check(any(g > lim for g, lim in zip(gaps["share"][0], limits)),
              "the card-vs-CPU check passed the faulty run %r: %r"
              % (name, gaps["share"][0]))
    return launches


# ----------------------------------------------------------------- lm_train
def lm_build(prng, root, char_lm, cfg):
    """A seeded char-LM sample workflow at ``cfg`` (loader, trainer,
    decision sections)."""
    prng.reset()
    prng.seed_all(SEED)
    root.__dict__.pop("char_lm", None)
    root.char_lm.update(cfg)
    return char_lm.build()


def flat_params(tree, prefix=""):
    """{name: host copy} of a param tree's leaves."""
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in flat_params(tree[key], prefix + "/" + key).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, item in enumerate(tree)
                for k, v in flat_params(item, "%s/%d" % (prefix, i)).items()}
    return {prefix: tree.detach().to("cpu", copy=True).numpy()}


def lm_committed(prng, root, char_lm, device, cfg):
    """The char-LM sample run on ``device``: the params at set-up and
    after every Adam update."""
    wf = lm_build(prng, root, char_lm, cfg)
    wf.initialize(device=device)
    trainer = wf.trainer
    inner = trainer.run
    kept = [flat_params(trainer.params)]

    def run_and_keep():
        train = trainer.is_train_minibatch()
        inner()
        if train:
            kept.append(flat_params(trainer.params))

    trainer.run = run_and_keep
    wf.run()
    return kept


def lm_shares(card, cpu):
    """Per update (after the first, ...) the per-tensor gap
    ||card - CPU|| / ||CPU - initial||."""
    return [{name: float(numpy.linalg.norm(card[k][name] - cpu[k][name])
                         / max(numpy.linalg.norm(cpu[k][name]
                                                 - cpu[0][name]), 1e-30))
             for name in cpu[k]} for k in range(1, len(cpu))]


@contextlib.contextmanager
def lm_fault(HK, name):
    """Within the block, the flash backward runs ``name`` of
    ``LM_FAULTS``: both passes launched with causal=False, or given the
    sm_scale of head_dim / 2 (FlashAttention looks them up per call)."""
    inner = (HK.flash_attention_bwd_dkv, HK.flash_attention_bwd_dq)

    def planted(fn):
        def call(q, k, v, o, lse, do, causal=True, sm_scale=None, di=None):
            if name == "bwd_not_causal":
                return fn(q, k, v, o, lse, do, False, sm_scale, di=di)
            return fn(q, k, v, o, lse, do, causal,
                      float(1.0 / (q.shape[-1] / 2) ** 0.5), di=di)
        # the wrapper counts its launch under its module name, which now
        # names this function (the counts are not read in a faulty run)
        call.launches = 0
        return call

    HK.flash_attention_bwd_dkv, HK.flash_attention_bwd_dq = map(planted,
                                                                inner)
    try:
        yield
    finally:
        HK.flash_attention_bwd_dkv, HK.flash_attention_bwd_dq = inner


def lm_train(torch, HK, card, device="cuda", cfg=None, small=None,
             steady_steps=3):
    """The char-LM sample at the repo's full LM width through
    ``char_lm.train``'s build + initialize + run under the 'flash_pallas'
    backend, then a steady step under each backend, greedy sampling, and
    card vs CPU at 2 layers."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.ops import attention as A
    from veles_tpu_torch.ops import transformer as T
    from veles_tpu_torch.samples import char_lm
    cfg, small = cfg or LM_TRAIN, small or LM_SMALL
    names = ("flash_attention_fwd", "flash_attention_bwd_dkv",
             "flash_attention_bwd_dq")
    A.set_attention_backend("flash_pallas")
    try:
        t0 = time.monotonic()
        wf = lm_build(prng, root, char_lm, cfg)
        wf.initialize(device=device)
        torch.cuda.synchronize()
        setup_s = time.monotonic() - t0
        trainer, ld = wf.trainer, wf.loader
        inner, step_losses = trainer.run, []

        def run_and_keep():
            train = trainer.is_train_minibatch()
            inner()
            if train:
                step_losses.append(trainer.metrics["loss_sum"]
                                   / trainer.metrics["tokens"])

        trainer.run = run_and_keep
        HK.reset_launch_counts()
        t0 = time.monotonic()
        wf.run()
        torch.cuda.synchronize()
        run_s = time.monotonic() - t0
        launches = HK.launch_counts()
        trainer.run = inner
        mb = ld.max_minibatch_size
        steps, n_layers = trainer.time, trainer.n_layers
        valid_mbs = -(-ld.class_lengths[1] // mb)
        check(steps == -(-ld.class_lengths[2] // mb),
              "%d train steps dispatched" % steps)
        want = {names[0]: n_layers * (steps + valid_mbs),
                names[1]: n_layers * steps, names[2]: n_layers * steps}
        got = {k: launches[k] for k in names}
        check(got == want, "lm_train launches %r, expected %r" % (got, want))
        losses = [float(x) for x in torch.stack(step_losses).cpu()]
        metrics = wf.decision.epoch_metrics
        check(all(numpy.isfinite(losses)) and all(
            numpy.isfinite(m[s]["loss"]) for m in metrics
            for s in ("validation", "train")), "non-finite loss %r" % losses)
        check(numpy.mean(losses[-3:]) < numpy.mean(losses[:3]),
              "train loss did not fall: %r" % losses)

        # one steady train step under each backend: host clock over
        # ``steady_steps`` synchronous steps, then the profiler's busy share
        tokens = ld.original_data.devmem[:mb]
        mask = torch.ones(mb, device=device)

        def step():
            trainer._train(trainer.params, trainer.opt_state, tokens, mask,
                           trainer.time)
            torch.cuda.synchronize()

        steady = {}
        for backend in ("flash_pallas", "xla"):
            A.set_attention_backend(backend)
            step()
            t0 = time.monotonic()
            for _ in range(steady_steps):
                step()
            step_s = (time.monotonic() - t0) / steady_steps
            busy, per_kernel = profile_steps(torch, step, 2)
            top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
            steady[backend] = {
                "step_s": step_s, "tokens_per_s": mb * (ld.seq_len - 1)
                / step_s, "step_device_busy_share": busy,
                "step_card_us": sum(per_kernel.values()),
                "step_top_kernels_us": [[k[:80], v] for k, v in top],
                "step_flash_kernels_us": {
                    tag: sum(v for k, v in per_kernel.items() if tag in k)
                    for tag in ("flash_fwd_kernel", "flash_bwd_dkv_kernel",
                                "flash_bwd_dq_kernel")}}
        A.set_attention_backend("flash_pallas")

        # greedy sampling on the card (the prefill through kernel 7a), each
        # emitted token held against a teacher-forced pass of the plain path
        prompt = ld.original_data.mem[:2, :64]
        before = HK.flash_attention_fwd.launches
        out = char_lm.sample_tokens(wf, prompt, n_new=32)
        prefill_launches = HK.flash_attention_fwd.launches - before
        check(out.shape == (2, 96) and out.min() >= 0 and out.max() < 256
              and (out[:, :64] == prompt).all(), "malformed sample %r" % out)
        check(prefill_launches == n_layers, "sample prefill launched 7a %d "
              "times" % prefill_launches)
        A.set_attention_backend("xla")
        with torch.no_grad():
            logits = T.transformer_forward(
                trainer.params, torch.as_tensor(out, device=device),
                trainer.n_heads)[:, 63:95]
        emitted = torch.as_tensor(out[:, 64:], device=device).long()
        picked = logits.gather(-1, emitted[..., None])[..., 0]
        short = (logits.max(dim=-1).values - picked).max().item()
        exact = int((logits.argmax(dim=-1) == emitted).sum().item())
        check(short <= LOGIT_TOL, "a sampled token's logit sits %g below "
              "its row max (tolerance %g)" % (short, LOGIT_TOL))
        del wf, trainer, tokens, logits

        # card vs CPU at 2 layers, then the faulty card runs
        A.set_attention_backend("flash_pallas")
        on_card = lm_committed(prng, root, char_lm, device, small)
        on_cpu = lm_committed(prng, root, char_lm, "cpu", small)
        sound = lm_shares(on_card, on_cpu)
        faults = {}
        for name in LM_FAULTS:
            with lm_fault(HK, name):
                faults[name] = lm_shares(lm_committed(
                    prng, root, char_lm, device, small), on_cpu)
    finally:
        A.set_attention_backend("xla")

    def worst(shares):
        return [max(d.values()) for d in shares]

    report = {"phase": "lm_train", "card": card,
              "config": {"vocab": 256, "d_model": cfg["trainer"]["d_model"],
                         "n_heads": cfg["trainer"]["n_heads"],
                         "n_layers": n_layers, "seq": ld.seq_len - 1,
                         "minibatch": mb, "n_train": ld.class_lengths[2],
                         "n_valid": ld.class_lengths[1], "epochs": 1,
                         "backend": "flash_pallas"},
              "setup_s": setup_s, "run_s": run_s, "train_steps": steps,
              "validation_minibatches": valid_mbs, "launches": launches,
              "train_step_losses": losses,
              "validation_loss": metrics[0]["validation"]["loss"],
              "steady": steady,
              "sample": {"prompts": 2, "prompt_len": 64, "new": 32,
                         "prefill_launches": prefill_launches,
                         "teacher_forced_worst_shortfall": short,
                         "exact_argmax": exact, "tolerance": LOGIT_TOL},
              "card_vs_cpu": {
                  "config": small, "limits": [LM_FIRST_SHARE,
                                              LM_THIRD_SHARE],
                  "sound_worst": worst(sound), "sound": sound,
                  "faults_worst": {k: worst(v) for k, v in faults.items()},
                  "faults_first": {k: v[0] for k, v in faults.items()}}}
    print(json.dumps(report), flush=True)
    check(len(sound) == 3, "%d committed updates, not 3" % len(sound))
    check(worst(sound)[0] <= LM_FIRST_SHARE
          and worst(sound)[-1] <= LM_THIRD_SHARE,
          "card vs CPU LM weight gaps beyond their limits: %r"
          % worst(sound))
    for name, shares in faults.items():
        check(worst(shares)[0] > LM_FIRST_SHARE, "the card-vs-CPU check "
              "passed the faulty run %r: %r" % (name, worst(shares)))
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip smoke: no CUDA device", file=sys.stderr)
        return 2
    from veles_tpu_torch.ops import _build
    from veles_tpu_torch.ops import attention as A
    from veles_tpu_torch.ops import hopper_kernels as HK
    from veles_tpu_torch.ops import transformer as T
    from veles_tpu_torch import prng, serving as S

    # 1. device
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    print("device: %s (count %d) | nvidia-smi: %s" % (name, count, smi),
          flush=True)
    print("torch %s, CUDA %s" % (torch.__version__, torch.version.cuda),
          flush=True)

    # 2. build, one nvcc per source, all started together
    t0 = time.monotonic()
    names = ("paged_flash_attention", "fused_sgd", "lrn", "dropout",
             "flash_attention")
    _build.load_all(names)
    libs = [str(_build.library_path(_build.CSRC_DIR / (n + ".cu"))
                .relative_to(_build.PACKAGE_DIR.parent)) for n in names]
    print("build: %.2f s -> %s" % (time.monotonic() - t0, ", ".join(libs)),
          flush=True)

    # 3. kernels against their plain versions, at the serving shapes
    cases = [decode_case(torch, HK, A),
             decode_case(torch, HK, A, kv=2, seed=1),
             decode_case(torch, HK, A, c=4, seed=2),
             decode_case(torch, HK, A, window=100, sinks=4, seed=3),
             prefill_case(torch, HK, A, 0),
             prefill_case(torch, HK, A, 15)]
    # no limit on the table width or head_dim: long tables (a
    # 16384-token view) and odd or wide heads, checked only
    checks = [decode_case(torch, HK, A, dh=128, m=512, seed=4, timed=False),
              decode_case(torch, HK, A, kv=2, c=4, dh=128, m=512,
                          window=3000, sinks=4, seed=5, timed=False),
              decode_case(torch, HK, A, b=2, h=4, kv=2, dh=18, page=8,
                          m=40, seed=6, timed=False),
              decode_case(torch, HK, A, b=2, h=4, kv=4, dh=320, page=64,
                          m=8, seed=7, timed=False),
              prefill_case(torch, HK, A, 400, kv=2, dh=128, m=512, seed=8,
                           timed=False)]
    sgd = sgd_cases(torch, HK)
    lrn = [c for i, (name, shape) in enumerate(LRN_SHAPES.items())
           for c in lrn_case(torch, HK, name, shape, seed=i)]
    lrn_checks = list(lrn_case(torch, HK, "c200_n4", (4, 32, 32, 200),
                               n=4, seed=5, timed=False))
    drop = [dropout_case(torch, HK, prng, name, shape, seed=i)
            for i, (name, shape) in enumerate(DROPOUT_SHAPES.items())]
    drop_checks = [dropout_case(torch, HK, prng, "n%d" % n, (n,), rate,
                                seed=10 + n, timed=False)
                   for n, rate in ((1, 0.5), (127, 0.3), (2 ** 16 + 3, 0.7))]
    flash = flash_case(torch, HK, *FLASH_MAIN)
    flash_checks = [rec for kw in (dict(dh=32), dict(dh=40), dict(dh=128))
                    for rec in flash_case(torch, HK, 2, 4, 200, causal=False,
                                          seed=kw["dh"], timed=False, **kw)]
    flash_checks += flash_case(torch, HK, 2, 4, 256, 64, seed=3, timed=False,
                               peak=100.0)
    # rows not 16-byte aligned: the backward stages by 4-byte copies
    flash_checks += flash_case(torch, HK, 2, 4, 200, 37, causal=False,
                               seed=37, timed=False)
    for case in (cases + checks + sgd + lrn + lrn_checks + drop + drop_checks
                 + flash + flash_checks):
        print(json.dumps(dict(case, card=smi)), flush=True)

    # 4. serve through the engine
    launches = serve(torch, HK, T, S, smi)

    # 5. train MNIST-FC through the sample's entry point
    launches["fused_sgd_update"] = train(torch, HK, smi)["fused_sgd_update"]

    # 6. train full-width AlexNet through the ImageNet sample
    alex = alexnet(torch, HK, smi)
    for k in ("lrn_forward", "lrn_backward", "dropout"):
        launches[k] = alex[k]

    # 7. train the full-width LM through the char-LM sample
    lm = lm_train(torch, HK, smi)
    for k in ("flash_attention_fwd", "flash_attention_bwd_dkv",
              "flash_attention_bwd_dq"):
        launches[k] = lm[k]

    # 8. the kernels line and the result
    main_case = {"flash_attention_fwd": flash[0],
                 "flash_attention_bwd_dkv": flash[1],
                 "flash_attention_bwd_dq": flash[2],
                 "fused_sgd_update": sgd[0],
                 "lrn_forward": lrn[0], "lrn_backward": lrn[1],
                 "dropout": drop[0],
                 "paged_flash_decode": cases[0],
                 "paged_flash_prefill": cases[5]}
    kernels = [{"name": k, "route": "cuda", "source": SOURCES[k],
                "replaces": REPLACES[k], "launches": launches[k],
                "max_abs_err": c["max_abs_err"], "ms": c["kernel_ms"],
                "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                "bound_by": c["bound_by"], "library_ms": c["library_ms"]}
               for k, c in main_case.items()]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
