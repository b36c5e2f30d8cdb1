"""The while megastep's launch at full width: card and host time against
the realised iterations, before and after a profiler session.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 -m veles_tpu_torch.tools.whilestep_profile

Two engines of the repo's LM config at full width (vocab 256, d_model
512, 8 heads, 8 layers, max_len 512, fp32, random weights from a seed),
8 slots, pages of 32, K = 16: the while program and the scan, every lane
16 pages deep on its own pages, as ``chip_smoke.py`` phase 19 times
them.  For the while program at 0, 1, 4 and 16 realised iterations and
the scan (16): the card ms of a launch (CUDA events around 20 launches
back to back) and the host ms of the launch call alone.  Then one
``torch.profiler`` session over three launches, and the same again:
CUPTI stays attached to the process afterwards, and the launches' host
cost with it.  Prints whether this torch's ``CUDAGraph`` has
``begin_capture_to_if_node``, and one JSON object.
"""

import json
import subprocess
import sys
import time

import numpy

SEED = 20261016
K, ITERS, REPS = 16, (0, 1, 4, 16), 20


def main():
    import torch
    if not torch.cuda.is_available():
        print("whilestep_profile: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    from veles_tpu_torch import prng, serving
    from veles_tpu_torch.ops import transformer
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    host = transformer.init_transformer_params(
        prng.RandomGenerator("init", SEED), 256, d_model=512, n_heads=8,
        n_layers=8, max_len=512)
    engines = {mode: serving.LMEngine(
        host, 8, 512, slots=8, prefill_chunk=32, device="cuda", megastep=K,
        megastep_mode=mode, name="profile_" + mode)
        for mode in ("while", "scan")}
    with torch.inference_mode():
        for engine in engines.values():
            engine.start()
            engine.stop()
            S, w = engine.slots, engine._max_pages
            stage = engine._ms_host
            stage["ptab"][:] = (1 + numpy.arange(S * w)).reshape(S, w)
            stage["pos"][:] = engine.max_len - K

        def launch(mode, n, reps=REPS):
            """(card ms, host ms of the call) of one launch with ``n``
            iterations of work."""
            engine = engines[mode]
            engine._ms_host["left"][:] = n
            engine._ms_in.copy_(engine._ms_stage)
            program = engine._megastep_programs[engine._max_pages]
            program()
            torch.cuda.synchronize()
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
            t0 = time.perf_counter()
            for _ in range(reps):
                program()
            host_ms = (time.perf_counter() - t0) / reps * 1e3
            events[1].record()
            torch.cuda.synchronize()
            return {"card_ms": events[0].elapsed_time(events[1]) / reps,
                    "host_ms": host_ms}

        def sweep():
            out = {"while_%d" % n: launch("while", n) for n in ITERS}
            out["scan_%d" % K] = launch("scan", K)
            return out

        report = {"card": smi, "torch": torch.__version__, "K": K,
                  "begin_capture_to_if_node": hasattr(
                      torch.cuda.CUDAGraph, "begin_capture_to_if_node"),
                  "before_profiler": sweep()}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            launch("while", 1, reps=3)
        report["after_profiler"] = sweep()
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
