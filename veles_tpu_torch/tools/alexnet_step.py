"""The synthetic AlexNet's steady train step, host clock, as
``chip_smoke.py``'s AlexNet phase reads it: ``_train_step`` on one
minibatch of 128, synchronized after every step.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 -m veles_tpu_torch.tools.alexnet_step [--tiny]

To compare two commits on one host, run it from the root of each
checkout in turn (parent, change, change, parent).  The workflow is
built from ``imagenet.alexnet_layers()`` at full width on the seeded
synthetic set (256 x 256, 1000 classes, 256 train / 128 validation
images), trained one epoch (2 steps, the kernels built and cuDNN's
algorithms chosen), then timed: ``ROUNDS`` rounds of ``STEPS`` steps
after 3 warm-up steps.  Prints one JSON line: each round's mean step in
ms, their median, and the card's name and power limit.  ``--tiny`` runs
``imagenet.tiny_layers()`` on 32 x 32 images on the CPU instead, as a
check of the script.
"""

import argparse
import json
import statistics
import subprocess
import time

import torch

SEED = 20261016
ROUNDS, STEPS = 5, 20


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tiny", action="store_true")
    args = parser.parse_args(argv)
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples import imagenet
    prng.reset()
    prng.seed_all(SEED)
    hw, classes = ((32, 32), 10) if args.tiny else ((256, 256), 1000)
    layers = (imagenet.tiny_layers(n_classes=classes) if args.tiny
              else imagenet.alexnet_layers())
    mb = 128
    root.imagenet.update({
        "loader": {"minibatch_size": mb, "records_path": None,
                   "n_train": 2 * mb, "n_valid": mb, "image_hw": hw,
                   "n_classes": classes},
        "decision": {"max_epochs": 1, "fail_iterations": 10},
        "layers": layers})
    wf = imagenet.build(fused=True)
    wf.initialize(device="cpu" if args.tiny else None)
    wf.run()
    on_card = wf.device.type == "cuda"
    runner, ld = wf._fused_runner, wf.loader
    x = ld.original_data.devmem[:mb]
    y = ld.original_labels.devmem[:mb]
    mask = torch.ones(mb, device=wf.device)
    key = prng.PRNGKey(SEED)

    def step():
        runner._train_step(runner.state, x, y, mask, mb, key)
        if on_card:
            torch.cuda.synchronize()

    for _ in range(3):
        step()
    rounds = []
    for _ in range(ROUNDS):
        t0 = time.monotonic()
        for _ in range(STEPS):
            step()
        rounds.append((time.monotonic() - t0) / STEPS * 1e3)
    card = None
    if on_card:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    print(json.dumps({"step_ms": rounds,
                      "median_ms": statistics.median(rounds),
                      "steps_a_round": STEPS, "minibatch": mb,
                      "tiny": args.tiny, "card": card}), flush=True)


if __name__ == "__main__":
    main()
