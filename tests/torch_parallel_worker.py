"""One gloo rank of the port's data- and tensor-parallel scenarios
(``tests/test_torch_parallel.py``).

    python tests/torch_parallel_worker.py PORT WORLD RANK INPUTS.npz OUTDIR

``INPUTS.npz`` holds what the test made with the reference: each
scenario's initial state (``<scenario>/<layer>/<key>``), its global
batch (``<scenario>:x``, ``:labels``, ``:mask``) and keys.  Every rank
runs every scenario on the CPU under gloo and writes
``OUTDIR/rank<R>.npz`` (each scenario's final full state and metrics)
and ``OUTDIR/rank<R>.json`` (the scenarios that raised, with their
tracebacks, and the checks made on the rank).
"""

import json
import os
import sys
import traceback

import numpy
import torch


def load_state(inputs, name):
    """A scenario's per-layer state from the flat npz keys."""
    layers = {}
    for key in inputs.files:
        if key.startswith(name + "/"):
            _, i, k = key.split("/")
            layers.setdefault(int(i), {})[k] = inputs[key]
    n = int(inputs[name + ":layers"])
    return [layers.get(i, {}) for i in range(n)]


def put_state(out, name, state):
    for i, entry in enumerate(state):
        for k, v in entry.items():
            out["%s/%d/%s" % (name, i, k)] = v.detach().cpu().numpy()


def mnist_wf(mb, n_train=256, n_valid=64, hidden=32, seed=11):
    """The port's twin of ``tests/test_parallel.py::_build``."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples import mnist
    prng.reset()
    prng.seed_all(seed)
    root.__dict__.pop("mnist", None)
    root.mnist.update({
        "loader": {"minibatch_size": mb, "n_train": n_train,
                   "n_valid": n_valid},
        "decision": {"max_epochs": 1, "fail_iterations": 10},
        "layers": [
            {"type": "all2all_tanh", "output_sample_shape": hidden,
             "learning_rate": 0.05, "momentum": 0.9},
            {"type": "softmax", "output_sample_shape": 10,
             "learning_rate": 0.05, "momentum": 0.9},
        ],
    })
    wf = mnist.build(fused=True)
    wf.initialize(device="cpu")
    return wf


def alexnet_wf(mb):
    """The port's twin of ``test_tp_alexnet_fc_trunk_matches``'s build
    (64x64 images, crop 56, 16 classes)."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples import imagenet
    prng.reset()
    prng.seed_all(21)
    root.__dict__.pop("imagenet", None)
    root.imagenet.update({
        "loader": {"minibatch_size": mb, "records_path": None,
                   "n_train": mb, "n_valid": mb, "image_hw": (64, 64),
                   "n_classes": 16},
        "decision": {"max_epochs": 1, "fail_iterations": 5},
        "layers": imagenet.alexnet_layers(n_classes=16, crop=(56, 56)),
    })
    wf = imagenet.build(fused=True)
    wf.initialize(device="cpu")
    return wf


def with_state(wf, state):
    from veles_tpu_torch.compiled import load_fused_state, state_from_jax
    load_fused_state(wf, state_from_jax(state, "cpu"))
    return wf._fused_runner


def full_state(trainer):
    trainer.sync_to_runner()
    return trainer.runner.state


def batch(inputs, name, trainer):
    return [trainer.local_rows(inputs["%s:%s" % (name, k)])
            for k in ("x", "labels", "mask")]


def scenario_dp(inputs, out, checks):
    from veles_tpu_torch.parallel import ShardedTrainer, make_mesh
    runner = with_state(mnist_wf(64), load_state(inputs, "dp"))
    trainer = ShardedTrainer(runner, make_mesh())
    x, labels, mask = batch(inputs, "dp", trainer)
    checks["dp_local_rows"] = int(x.shape[0])
    for _ in range(3):
        metrics = trainer.train_step(x, labels, mask, 64)
    put_state(out, "dp", full_state(trainer))
    out["dp:n_err"] = numpy.asarray(int(metrics["n_err"]))


def scenario_tp(inputs, out, checks):
    from veles_tpu_torch.parallel import ShardedTrainer, make_mesh
    runner = with_state(mnist_wf(64), load_state(inputs, "tp"))
    trainer = ShardedTrainer(runner, make_mesh(model_parallel=2),
                             model_shard_layers=(0,))
    checks["tp_local_width"] = int(trainer.state[0]["w"].shape[-1])
    trainer.train_step(*batch(inputs, "tp", trainer), 64)
    put_state(out, "tp", full_state(trainer))


def scenario_tp_alexnet(inputs, out, checks):
    from veles_tpu_torch import prng
    from veles_tpu_torch.parallel import (ShardedTrainer, make_mesh,
                                          model_shard_candidates)
    mb = 16
    runner = with_state(alexnet_wf(mb), load_state(inputs, "alex"))
    fc = model_shard_candidates(runner, min_width=4096)
    checks["alex_fc"] = list(fc)
    trainer = ShardedTrainer(runner, make_mesh(model_parallel=2),
                             model_shard_layers=fc)
    checks["alex_local_widths"] = [int(trainer.state[i]["w"].shape[-1])
                                   for i in fc]
    metrics = trainer.train_step(*batch(inputs, "alex", trainer), mb,
                                 rng=prng.PRNGKey(4), step=0)
    put_state(out, "alex", full_state(trainer))
    out["alex:loss_sum"] = numpy.asarray(float(metrics["loss_sum"]))
    out["alex:n_err"] = numpy.asarray(int(metrics["n_err"]))


def scenario_scan(inputs, out, checks):
    """Every epoch-scan entry of the trainer against the per-step
    loop (2x2 mesh, layer 0 split, as the reference's tests)."""
    from veles_tpu_torch.loader.base import TRAIN, VALID
    from veles_tpu_torch.parallel import ShardedTrainer, make_mesh
    mesh = make_mesh(model_parallel=2)
    wf = mnist_wf(64, seed=17)
    runner = wf._fused_runner
    init = [dict(e) for e in runner.state]
    loader = wf.loader
    data = numpy.asarray(loader.original_data.mem)
    labels = numpy.asarray(loader.original_labels.mem)

    def fresh():
        runner.state = [dict(e) for e in init]
        trainer = ShardedTrainer(runner, mesh, model_shard_layers=(0,))
        trainer.place_dataset(data, labels)
        return trainer

    def plan():
        loader._plan_epoch()
        return loader.plan_arrays(TRAIN)

    idx0, mask0 = plan()
    idx1, mask1 = plan()
    vidx, vmask = loader.plan_arrays(VALID)
    steps = idx0.shape[0]

    loop = fresh()
    for i in range(steps):
        rows = idx0[i]
        loop.train_step(loop.local_rows(data[rows]),
                        loop.local_rows(labels[rows]),
                        loop.local_rows(mask0[i]), int(mask0[i].sum()),
                        step=i)
    put_state(out, "scan_loop", full_state(loop))
    scan = fresh()
    scan.train_epoch(idx0, mask0, step0=0)
    checks["scan_step_count"] = scan.step_count
    put_state(out, "scan_epoch", full_state(scan))

    # the eval epoch against the per-step eval sums
    totals = scan.eval_epoch(vidx, vmask)
    per = None
    for i in range(vidx.shape[0]):
        m = ShardedTrainer.fetch(scan.eval_step(
            scan.local_rows(data[vidx[i]]), scan.local_rows(labels[vidx[i]]),
            scan.local_rows(vmask[i])))
        per = m if per is None else {k: per[k] + m[k] for k in per}
    for k in totals:
        out["eval_epoch:" + k] = numpy.asarray(totals[k])
        out["eval_steps:" + k] = numpy.asarray(per[k])

    # two sequential epochs against one two-epoch chunk (and with eval)
    plans = numpy.stack([idx0, idx1]), numpy.stack([mask0, mask1])
    seq = fresh()
    seq_vals = []
    for e in range(2):
        last = seq.train_epoch(plans[0][e], plans[1][e], step0=e * steps)
        seq_vals.append(seq.eval_epoch(vidx, vmask))
    put_state(out, "scan_seq", full_state(seq))
    chunk = fresh()
    stacked = chunk.train_epochs(*plans, step0=0)
    checks["chunk_step_count"] = chunk.step_count
    put_state(out, "scan_chunk", full_state(chunk))
    for k in stacked:
        out["chunk_row1:" + k] = numpy.asarray(stacked[k][1])
        out["seq_last:" + k] = numpy.asarray(last[k])
    evals = fresh()
    _, val_stack = evals.train_epochs_eval(*plans, vidx, vmask, step0=0)
    put_state(out, "scan_chunk_eval", full_state(evals))
    for e in range(2):
        for k in seq_vals[e]:
            out["chunk_val%d:%s" % (e, k)] = numpy.asarray(val_stack[k][e])
            out["seq_val%d:%s" % (e, k)] = numpy.asarray(seq_vals[e][k])
    pending = fresh()
    before = [{k: v.clone() for k, v in e.items()} for e in pending.state]
    new, _, _, test = pending.chunk_eval_pending(*plans, vidx, vmask,
                                                step0=0)
    checks["pending_kept_state"] = all(
        torch.equal(a[k], b[k]) for a, b in zip(before, pending.state)
        for k in a)
    checks["pending_no_test"] = test is None
    pending.state = new
    put_state(out, "scan_pending", full_state(pending))

    # the divisibility error (13 columns on a 2-row data axis)
    try:
        scan.train_epoch(numpy.zeros((2, 13), numpy.int32),
                         numpy.ones((2, 13), numpy.float32))
        checks["indivisible_raised"] = None
    except ValueError as exc:
        checks["indivisible_raised"] = str(exc)


SCENARIOS = (("dp", scenario_dp), ("tp", scenario_tp),
             ("tp_alexnet", scenario_tp_alexnet), ("scan", scenario_scan))


def main(port, world, rank, inputs_path, out_dir):
    torch.set_num_threads(1)
    from veles_tpu_torch import parallel
    index, count, backend = parallel.initialize_multihost(
        "127.0.0.1:%s" % port, world, rank, device="cpu")
    inputs = numpy.load(inputs_path)
    out, checks, errors = {}, {"backend": backend}, {}
    for name, fn in SCENARIOS:
        try:
            fn(inputs, out, checks)
        except Exception:   # noqa: BLE001 — reported per scenario
            errors[name] = traceback.format_exc()
    checks["collectives"] = parallel.collective_counts()
    numpy.savez(os.path.join(out_dir, "rank%d.npz" % rank), **out)
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump({"errors": errors, "checks": checks}, f)
    parallel.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
