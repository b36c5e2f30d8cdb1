#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits nonzero before the final line is printed):

1. device — the card's name, the device count and ``nvidia-smi``'s name
   and power limit;
2. build — the CUDA kernels compiled from ``veles_tpu_torch/csrc/``
   (``paged_flash_attention.cu``, ``fused_sgd.cu``; one nvcc per source,
   all started together) into ``build/kernels/``;
3. kernels — each kernel against its plain PyTorch version on the card
   at its main path's shapes, with kernel, plain-version and library
   card times (CUDA events; see ``time_ms``) and the card's bound for
   the same work: the paged attention kernels at the serving shapes
   (library: scaled_dot_product_attention on the gathered view), then
   (checked, not timed) long page tables — a 16384-token lane view at
   head_dim 128 — and a head_dim that is neither a multiple of 4 nor
   below 256; the fused SGD kernel at MNIST-FC's four parameters, a
   4096x4096 weight, odd sizes, weight decay with an L1 mix and a clip
   (no library call computes that function);
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
6. one JSON line listing every ported kernel, then the JSON result line.

It imports nothing of JAX and nothing of the ``veles_tpu`` package.
"""

import json
import statistics
import subprocess
import sys
import time
import numpy

SEED = 20261016
#: H100 SXM data-sheet peaks: HBM bytes/s and fp32 (non-tensor) flop/s
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
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

REPLACES = {
    "fused_sgd_update": "veles_tpu/ops/pallas_kernels.py:92",
    "paged_flash_decode": "veles_tpu/ops/pallas_kernels.py:367",
    "paged_flash_prefill": "veles_tpu/ops/pallas_kernels.py:443",
}
SOURCES = {
    "fused_sgd_update": "veles_tpu_torch/csrc/fused_sgd.cu",
    "paged_flash_decode": "veles_tpu_torch/csrc/paged_flash_attention.cu",
    "paged_flash_prefill": "veles_tpu_torch/csrc/paged_flash_attention.cu",
}
#: fused SGD kernel vs plain version: at most 1 ulp per element (the
#: plain version rounds each fused multiply-add once from float64)
SGD_MAX_ULPS = 1.0
#: MNIST-FC's parameters: (784, 100) and (100,) tanh, (100, 10) and (10,)
MNIST_PARAMS = ((784, 100), (100,), (100, 10), (10,))
#: card vs CPU weights after 50 committed updates: cuBLAS and the CPU
#: sum the GEMMs in different orders over 50 steps; weights are O(0.1)
TRAIN_ATOL = 1e-4
#: the repo's LM config at full width (bench.py's lm config)
LM_CONFIG = dict(vocab=256, d_model=512, n_heads=8, n_layers=8, max_len=512)


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


def bound(n_bytes, n_flops):
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = n_flops / FP32_FLOP_S * 1e3
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
            sgd_case(torch, HK, [big], "fc_4096x4096", seed=10, copies=2),
            sgd_case(torch, HK, [(1,), (127,), (129,)], "odd_sizes",
                     seed=20),
            sgd_case(torch, HK, MNIST_PARAMS, "decay_l1_mix", wd=0.0005,
                     l1=0.3, seed=30),
            sgd_case(torch, HK, MNIST_PARAMS, "clip", wd=0.0005, l1=0.3,
                     clip=0.05, seed=40)]


# -------------------------------------------------------------------- serve
def device_busy_share(torch, step, n):
    """Share of the wall time of ``n`` synchronous steps during which
    the card ran kernels, from a torch.profiler trace (kernel time
    summed over the trace's rows); None when the trace holds no device
    time.  The profiler's own host cost makes this a lower bound."""
    from torch.profiler import ProfilerActivity, profile
    step()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(n):
            step()
        wall_us = (time.monotonic() - t0) * 1e6
    device_us = sum(getattr(e, "self_device_time_total", 0)
                    for e in prof.key_averages())
    return device_us / wall_us if device_us else None


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
        busy = device_busy_share(torch, lambda: engine._step_program(
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
    busy = device_busy_share(torch, lambda: (
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


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip smoke: no CUDA device", file=sys.stderr)
        return 2
    from veles_tpu_torch.ops import _build
    from veles_tpu_torch.ops import attention as A
    from veles_tpu_torch.ops import hopper_kernels as HK
    from veles_tpu_torch.ops import transformer as T
    from veles_tpu_torch import serving as S

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
    names = ("paged_flash_attention", "fused_sgd")
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
    for case in cases + checks + sgd:
        print(json.dumps(dict(case, card=smi)), flush=True)

    # 4. serve through the engine
    launches = serve(torch, HK, T, S, smi)

    # 5. train MNIST-FC through the sample's entry point
    launches["fused_sgd_update"] = train(torch, HK, smi)["fused_sgd_update"]

    # 6. the kernels line and the result
    main_case = {"fused_sgd_update": sgd[0],
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
