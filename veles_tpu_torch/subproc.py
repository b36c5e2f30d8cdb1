"""Bounded worker-subprocess pool for population-style parallelism.

Port of ``veles_tpu/subproc.py``: the machinery behind genetics'
process-per-individual screening and parallel ensemble training.  Each
worker gets a JSON spec on stdin, prints a JSON result as its LAST
stdout line, and logs freely to stderr (captured to a temp file, so log
volume can never fill a pipe).  Results return in spec order; if any
worker fails, the rest are killed (no orphans) and its stderr tail is
raised.

Workers run on the device their spec names — the one the parent
resolved (the CUDA card unless the caller asked for the CPU); several
processes share one card.  A worker is a fresh interpreter, so a spec
also carries the process-wide settings the config tree lacks
(:func:`process_state`).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time


def plain_config(value):
    """Deep-convert a config value to JSON-serializable plain data (Tune
    leaves collapse to their current value) — the shape worker specs ship
    the config tree in."""
    from veles_tpu_torch.config import Tune
    if isinstance(value, Tune):
        return plain_config(value.value)
    if isinstance(value, dict):
        return {k: plain_config(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [plain_config(v) for v in value]
    if hasattr(value, "item") and getattr(value, "ndim", None) == 0:
        return value.item()     # numpy scalar
    return value


def process_state():
    """The process-wide settings a worker must share with its parent to
    compute what the parent would: the matmul precision mode (which also
    sets TF32 and cuDNN's deterministic switch), the attention backend,
    and torch's CPU thread count (CPU products sum in an order that
    depends on it)."""
    import torch
    from veles_tpu_torch.ops import attention, functional
    return {"precision": functional.get_matmul_precision(),
            "attention_backend": attention._ATTN_BACKEND,
            "threads": torch.get_num_threads()}


def apply_process_state(state):
    """Install a :func:`process_state` in this (worker) process."""
    import torch
    from veles_tpu_torch.ops import attention, functional
    functional.set_matmul_precision(state["precision"])
    attention.set_attention_backend(state["attention_backend"])
    torch.set_num_threads(state["threads"])


def worker_device(name):
    """A spec's device for ``run_sample``: a CUDA device with no card
    raises (a worker never carries on on the CPU)."""
    from veles_tpu_torch.device import resolve_device
    import torch
    if torch.device(name).type == "cuda":
        resolve_device(None)
    return name


def run_workers(module_name, specs, workers, env_overrides=None):
    """Run ``python -m <module_name>`` once per spec, ``workers`` at a
    time.  Returns the list of decoded result dicts, ordered like
    ``specs``."""
    if workers < 1:
        raise ValueError("workers must be >= 1")
    env = dict(os.environ, **(env_overrides or {}))
    pending = list(enumerate(specs))
    results = [None] * len(specs)
    running = []   # (index, Popen, stderr_file)

    def launch(index, spec):
        payload = json.dumps(spec).encode()  # serialize BEFORE spawning:
        # a TypeError here must not leave an orphaned worker behind
        # stderr goes to a FILE, not a pipe: a training worker logs far
        # more than a pipe buffer holds, and the parent may be blocked on
        # a DIFFERENT worker when this one fills up
        err_file = tempfile.TemporaryFile()
        proc = subprocess.Popen(
            [sys.executable, "-m", module_name],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=err_file, env=env)
        running.append((index, proc, err_file))
        try:
            proc.stdin.write(payload)
            proc.stdin.close()
        except BrokenPipeError:
            pass   # worker died before reading the spec; reap() reports it

    def reap(index, proc, err_file):
        out = proc.stdout.read().decode()  # result JSON only: tiny
        proc.stdout.close()
        with err_file:
            if proc.wait() != 0:
                err_file.seek(0)
                err = err_file.read().decode(errors="replace")
                raise RuntimeError("worker %d (%s) failed:\n%s"
                                   % (index, module_name, err[-2000:]))
        results[index] = json.loads(out.strip().splitlines()[-1])

    try:
        while pending or running:
            while pending and len(running) < workers:
                launch(*pending.pop(0))
            # reap ANY finished worker (not FIFO): a slow spec must not
            # hold finished slots hostage and serialize the batch
            done = next((entry for entry in running
                         if entry[1].poll() is not None), None)
            if done is None:
                time.sleep(0.05)
                continue
            running.remove(done)
            reap(*done)
    finally:
        for _, proc, err_file in running:   # error path: no orphans
            proc.kill()
            proc.wait()
            proc.stdout.close()
            err_file.close()
    return results
