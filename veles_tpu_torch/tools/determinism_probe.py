"""Seeded reruns on the card with cuDNN's deterministic algorithms off
and on: whether they repeat bit for bit, what the switch costs a
full-width AlexNet step, and how often the full-size ``cifar_resnet``
run diverges.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 -m veles_tpu_torch.tools.determinism_probe [--resnet-runs N]

Every precision mode of the port sets ``torch.backends.cudnn.deterministic``
(``ops/functional.py``); "off" here clears it again after each mode
call.  Prints JSON lines, each with the card's name and power limit:

- ``reruns``: for each switch setting, whether two seeded runs of each
  conv-zoo sample (``chip_smoke.ZOO_SMALL``, 3 committed updates) and of
  AlexNet (384 train / 128 validation at minibatch 128, one epoch) end
  with bit-equal weights after every committed update;
- ``alexnet_step``: the synthetic AlexNet phase's steady train step
  (``_train_step`` at minibatch 128, host clock, mean of 20 synchronous
  steps after 3), off and on in turns, two rounds;
- ``cifar_resnet``: the sample at its defaults (50,000 / 10,000,
  minibatch 100) for 2 epochs from ``chip_smoke.SEED``, as
  ``chip_smoke.py``'s zoo phase trains it, ``N`` times with the switch
  off and twice on: each run's validation loss per epoch and the first
  train step whose update met a non-finite gradient or weight (None
  when none did).
"""

import argparse
import contextlib
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy


def load_smoke():
    """``chip_smoke.py`` of the checkout this file sits in."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[2] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@contextlib.contextmanager
def cudnn_deterministic(torch, F, on):
    """Within the block every precision-mode call leaves cuDNN's
    deterministic switch at ``on``."""
    inner = F._allow_tf32

    def pinned(allow):
        inner(allow)
        torch.backends.cudnn.deterministic = on

    F._allow_tf32 = pinned
    torch.backends.cudnn.deterministic = on
    try:
        yield
    finally:
        F._allow_tf32 = inner
        F.pin_fp32_matmul()


def equal_runs(a, b):
    return all(numpy.array_equal(x, y) for ka, kb in zip(a, b)
               for la, lb in zip(ka, kb) for x, y in zip(la, lb))


def reruns(smoke, prng, root):
    from veles_tpu_torch.samples import imagenet
    out = {}
    for name in smoke.ZOO:
        module = importlib.import_module("veles_tpu_torch.samples." + name)
        a, b = (smoke.committed_weights(smoke.zoo_build(
            prng, root, module, name, **smoke.ZOO_SMALL), "cuda")
            for _ in range(2))
        out[name] = equal_runs(a, b)
    a, b = (smoke.committed_weights(smoke.imagenet_build(
        prng, root, imagenet, imagenet.alexnet_layers(), n_train=384,
        n_valid=128, epochs=1), "cuda") for _ in range(2))
    out["alexnet"] = equal_runs(a, b)
    return out


def alexnet_step_ms(torch, smoke, prng, root):
    from veles_tpu_torch.samples import imagenet
    wf = smoke.imagenet_build(prng, root, imagenet,
                              imagenet.alexnet_layers(), epochs=1)
    wf.initialize(device="cuda")
    wf.run()
    ld, runner = wf.loader, wf._fused_runner
    mb = ld.max_minibatch_size
    x, y = ld.original_data.devmem[:mb], ld.original_labels.devmem[:mb]
    mask = torch.ones(mb, device="cuda")
    key = prng.PRNGKey(smoke.SEED)
    for _ in range(3):
        runner._train_step(runner.state, x, y, mask, mb, key)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(20):
        runner._train_step(runner.state, x, y, mask, mb, key)
    torch.cuda.synchronize()
    return (time.monotonic() - t0) / 20 * 1e3


def resnet_run(torch, F, prng, root, seed):
    """One full-size ``cifar_resnet`` run: validation losses and the first
    update that met a non-finite value."""
    from veles_tpu_torch.samples import cifar_resnet
    inner, seen = F.sgd_update_multi, []

    def watched(items, *rest):
        out = inner(items, *rest)
        seen.append(torch.stack(
            [torch.isfinite(it[2]).all() for it in items]
            + [torch.isfinite(p).all() for p, _ in out]).all())
        return out

    prng.reset()
    prng.seed_all(seed)
    root.__dict__.pop("cifar_resnet", None)
    cifar_resnet.default_config()
    F.sgd_update_multi = watched
    try:
        wf = cifar_resnet.train(loader={}, decision={"max_epochs": 2})
    finally:
        F.sgd_update_multi = inner
    finite = torch.stack(seen).cpu().numpy()
    bad = numpy.nonzero(~finite)[0]
    return {"validation_loss": [m["validation"]["loss"]
                                for m in wf.decision.epoch_metrics],
            "first_nonfinite_step": int(bad[0]) if len(bad) else None}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--resnet-runs", type=int, default=8)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("determinism_probe: no CUDA device", file=sys.stderr)
        return 2
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.ops import functional as F
    smoke = load_smoke()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]

    def say(**record):
        print(json.dumps(dict(record, card=card)), flush=True)

    for on in (False, True):
        with cudnn_deterministic(torch, F, on):
            say(reruns=reruns(smoke, prng, root), deterministic=on)
    for rnd in range(2):
        for on in (False, True):
            with cudnn_deterministic(torch, F, on):
                say(alexnet_step=alexnet_step_ms(torch, smoke, prng, root),
                    deterministic=on, round=rnd)
    for on, n in ((False, args.resnet_runs), (True, 2)):
        with cudnn_deterministic(torch, F, on):
            for i in range(n):
                say(cifar_resnet=resnet_run(torch, F, prng, root,
                                            smoke.SEED),
                    deterministic=on, run=i)
    return 0


if __name__ == "__main__":
    sys.exit(main())
