"""One rank of the port's multi-process scenarios
(``tests/test_torch_multihost.py``), gloo on 127.0.0.1.

    python tests/torch_multihost_worker.py WORLD RANK SNAPDIR

Each scenario joins a run of its own and leaves it; rank 0 picks a free
coordinator port just before the scenario and hands it to the other
ranks through a file in SNAPDIR (a port picked long before may be taken
by then).  Scenarios, in order:

- ``cli``: ``python -m veles_tpu_torch``'s ``main`` with
  ``--distributed`` (graph loop): per-epoch metrics, the first layer's
  weight sum, the loader's local rows;
- ``cli_scan``: the same with ``--epoch-scan 2``;
- ``diverge``: rank 1 perturbs its initial weights; the trainer's
  digest guard must raise;
- ``full`` / ``first`` / ``second``: 2·K steps straight; K steps and a
  snapshot written by rank 0; a restore of that snapshot into a fresh
  build and the remaining K steps.

Each prints ``RESULT <name> <json>`` or ``ERROR <name> <json traceback>``.
"""

import datetime
import json
import os
import socket
import sys
import time
import traceback
import zlib

import numpy
import torch

K = 3
MNIST = [
    "root.mnist.loader.minibatch_size=32", "root.mnist.loader.n_train=128",
    "root.mnist.loader.n_valid=32", "root.mnist.decision.max_epochs=2",
    "root.mnist.layers=[{'type': 'all2all_tanh', 'output_sample_shape': "
    "16, 'learning_rate': 0.05, 'momentum': 0.9}, {'type': 'softmax', "
    "'output_sample_shape': 10, 'learning_rate': 0.05, 'momentum': 0.9}]"]


def cli_argv(extra=()):
    return (["veles_tpu_torch.samples.mnist", "-d", "cpu", "--no-stats",
             "--random-seed", "1"] + MNIST + list(extra))


def epoch_rows(wf):
    return [{s: {k: v for k, v in m.items() if isinstance(v, (int, float))}
             for s, m in em.items()} for em in wf.decision.epoch_metrics]


def run_cli(port, world, rank, extra=()):
    from veles_tpu_torch import __main__ as cli, prng
    from veles_tpu_torch.config import root
    prng.reset()
    root.__dict__.pop("mnist", None)
    assert cli.main(cli_argv(list(extra) + [
        "--distributed", "--coordinator-address", "127.0.0.1:%s" % port,
        "--num-processes", str(world), "--process-id", str(rank)])) == 0
    wf = cli.main.workflow
    return {"epochs": epoch_rows(wf),
            "wsum": float(numpy.abs(wf.forwards[0].weights.mem).sum()),
            "local_rows": wf.loader.local_minibatch_size,
            "backend": cli.main.launcher.backend}


def build():
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root, parse_override
    from veles_tpu_torch.samples import mnist
    prng.reset()
    prng.seed_all(1)
    root.__dict__.pop("mnist", None)
    for token in MNIST:
        parse_override(token)
    root.mnist.decision.max_epochs = 100
    return mnist.build(fused=True)


def joined(port, world, rank):
    from veles_tpu_torch import parallel
    parallel.initialize_multihost("127.0.0.1:%s" % port, world, rank,
                                  device="cpu")
    return parallel.make_mesh()


def train_steps(trainer, loader, steps, step0=0):
    from veles_tpu_torch.loader.base import TRAIN
    done = 0
    while done < steps:
        loader.run()
        if loader.minibatch_class != TRAIN:
            continue
        trainer.train_step(loader.minibatch_data.devmem,
                           loader.minibatch_labels.devmem,
                           loader.minibatch_mask.devmem,
                           loader.minibatch_size, step=step0 + done)
        done += 1


def digest(runner):
    return [zlib.crc32(numpy.ascontiguousarray(
        v.detach().cpu().numpy()).tobytes())
        for e in runner.state for _, v in sorted(e.items())]


def sharded(port, world, rank, snap_dir, phase):
    """One phase of the snapshot/resume scenario (or the divergence
    check): returns its result."""
    from veles_tpu_torch import parallel, snapshotter
    mesh = joined(port, world, rank)
    wf = build()
    wf.loader.shard_spmd(*parallel.spmd_loader_shard(mesh))
    wf.initialize(device="cpu")
    runner = wf._fused_runner
    path = os.path.join(snap_dir, "mid.pickle.gz")
    if phase == "diverge":
        if rank == 1:
            w = runner.state[0]["w"]
            runner.state[0]["w"] = w + 1e-3
        try:
            parallel.ShardedTrainer(runner, mesh)
        except AssertionError as exc:
            return {"caught": str(exc)}
        return {"caught": None}
    if phase == "second":
        snapshotter.restore(wf, path)
        trainer = parallel.ShardedTrainer(wf._fused_runner, mesh)
        train_steps(trainer, wf.loader, K, step0=K)
    else:
        trainer = parallel.ShardedTrainer(runner, mesh)
        train_steps(trainer, wf.loader, K if phase == "first" else 2 * K)
    trainer.sync_to_runner()
    if phase == "first":
        if rank == 0:
            snapshotter.save(wf, path)
        torch.distributed.barrier()
        return {"written": os.path.exists(path)}
    return {"digest": digest(wf._fused_runner),
            "local_rows": wf.loader.local_minibatch_size}


def port_for(name, rank, snap_dir):
    """Rank 0 picks a free port for scenario ``name`` and publishes it;
    the others wait for it."""
    path = os.path.join(snap_dir, "port_" + name)
    if rank == 0:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        with open(path + ".tmp", "w") as f:
            f.write(str(port))
        os.replace(path + ".tmp", path)
        return port
    for _ in range(600):
        if os.path.exists(path):
            with open(path) as f:
                return int(f.read())
        time.sleep(0.1)
    raise TimeoutError("no port published for " + name)


def main(world, rank, snap_dir):
    torch.set_num_threads(1)
    from veles_tpu_torch import parallel
    # a scenario that fails on one rank must not hold the other for long
    parallel.TIMEOUT = datetime.timedelta(seconds=60)
    scenarios = [
        ("cli", lambda p: run_cli(p, world, rank)),
        ("cli_scan", lambda p: run_cli(p, world, rank,
                                       ["--epoch-scan", "2"]))] + [
        (phase, lambda p, phase=phase: sharded(p, world, rank, snap_dir,
                                               phase))
        for phase in ("diverge", "full", "first", "second")]
    for name, fn in scenarios:
        try:
            port = port_for(name, rank, snap_dir)
            print("RESULT %s %s" % (name, json.dumps(fn(port))), flush=True)
        except Exception:   # noqa: BLE001 — reported per scenario
            print("ERROR %s %s" % (name, json.dumps(traceback.format_exc())),
                  flush=True)
        finally:
            parallel.shutdown()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
