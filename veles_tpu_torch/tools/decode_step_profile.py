"""The serving engine's decode step at full width: host-clock time and
card time by kernel.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 -m veles_tpu_torch.tools.decode_step_profile

The engine is the repo's LM config at full width (vocab 256, d_model
512, 8 heads, 8 layers, max_len 512, fp32, random weights from a seed)
with 8 slots and pages of 32, every lane 16 pages deep, as
``chip_smoke.py`` times its decode step.  Prints one JSON object: the
card's name and power limit, the step's host-clock ms (mean of 50
synchronous steps), the card's busy share of a step (the union of the
trace's kernel intervals over the wall time of 20 profiled steps, by
``chip_smoke.profile_steps``) and each kernel's card us per step.

To compare two trees on one card, run this file against each tree's
package in turns in one call, e.g. ``PYTHONPATH=<other tree> python3
veles_tpu_torch/tools/decode_step_profile.py``.
"""

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy

SEED = 20261016


def profile_steps():
    """``chip_smoke.profile_steps`` of the checkout this file sits in
    (busy share and card us per kernel over steps), whichever package
    the engine is imported from."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[2] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.profile_steps


def main():
    import torch
    if not torch.cuda.is_available():
        print("decode_step_profile: no CUDA device", file=sys.stderr)
        return 2
    import veles_tpu_torch
    from veles_tpu_torch import prng, serving
    from veles_tpu_torch.ops import transformer
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    host = transformer.init_transformer_params(
        prng.RandomGenerator("init", SEED), 256, d_model=512, n_heads=8,
        n_layers=8, max_len=512)
    engine = serving.LMEngine(host, 8, 512, slots=8, paged_kv=True,
                              prefill_chunk=32, device="cuda",
                              name="decode_step_profile")
    w = engine._max_pages
    ptabs = (1 + numpy.arange(engine.slots * w, dtype=numpy.int32)
             ).reshape(engine.slots, w)
    pos = numpy.full(engine.slots, engine.max_len - 1, numpy.int32)
    last = numpy.zeros(engine.slots, numpy.int32)
    with torch.inference_mode():
        def step():
            engine._step_program(ptabs, last, pos)
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(50):
            step()
        step_ms = (time.monotonic() - t0) / 50 * 1e3
        busy, per_kernel = profile_steps()(torch, step, 20)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps({"card": smi, "package": veles_tpu_torch.__file__,
                      "step_ms": step_ms, "busy_share": busy,
                      "card_us_per_step": sum(per_kernel.values()),
                      "top_kernels_us": [[k[:80], v] for k, v in top]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
