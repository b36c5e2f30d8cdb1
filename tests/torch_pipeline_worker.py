"""One gloo rank of the port's pipeline checks
(``tests/test_torch_pipeline.py``).

    python tests/torch_pipeline_worker.py MODE PORT WORLD RANK DIR

``DIR/inputs.npz`` holds the LM params of the loss cases (``p/<path>``),
of the forward case (``f/<path>``) and of the MoE case (``m/<path>``),
and the tokens.  Every rank joins a run of WORLD ranks on the CPU.
MODE ``pipe`` (WORLD 4) runs, in order:

- ``pipeline_lm_loss`` and its gradients (for every per-layer leaf) at
  (stages, microbatches) (2, 8) and (4, 4) on the ranks of each mesh,
  and at (1, 8) and (1, 4) on rank 0;
- ``pipeline_blocks``' forward at (4, 4); the MoE LM's loss and
  gradients at (4, 4);
- the shape guards' messages;
- the char-LM sample (``TINY``: 4 layers, 4 stages, 4 microbatches, 2
  epochs): validation losses, each rank's stacked block count, its
  ``state_dict`` (gathered), the eval loss of fixed tokens; then the
  reference pipelined trainer's state (``DIR/ref_state.pkl``, written by
  the test when ready) loaded and read back.

MODE ``cli`` (WORLD 2): ``python -m veles_tpu_torch``'s ``main`` on
``veles_tpu_torch.samples.char_lm`` with ``--distributed`` and
``pipeline_stages=2``: validation losses, the loader's local minibatch
size, whether a ``ShardedTrainer`` was wrapped, the backend.

Each rank writes ``DIR/<mode><R>.npz`` (and rank 0 ``DIR/states.pkl``).
"""

import os
import pickle
import sys
import time

import numpy
import torch

#: tests/test_transformer.py::TestPipelinedTrainer's run, every knob
#: pinned (the stage count is set per run)
TINY = {
    "loader": {"minibatch_size": 32, "n_train": 128, "n_valid": 64,
               "seq_len": 32, "vocab": 16},
    "trainer": {"vocab": 16, "d_model": 32, "n_heads": 2, "n_layers": 4,
                "max_len": 32, "learning_rate": 3e-3, "n_experts": 0,
                "pipeline_stages": 4, "pipeline_microbatches": 4,
                "remat": False, "rope": False, "window": None,
                "attn_sinks": 0, "n_kv_heads": None},
    "decision": {"max_epochs": 2, "fail_iterations": 10},
}
GEOMETRIES = ((2, 8), (4, 4), (1, 8), (1, 4))
N_HEADS = 2


def unflatten(flat, prefix):
    """{"<prefix>a/b/0/c": array} -> nested dicts/lists of tensors."""
    tree = {}
    for key in sorted(k for k in flat if k.startswith(prefix)):
        node = tree
        parts = key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.tensor(flat[key])

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[k]) for k in sorted(node, key=int)]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], "%s/%s" % (prefix, k) if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flat(v, "%s/%d" % (prefix, i))
    else:
        yield prefix, tree


def loss_and_grads(params, tokens, mask, mesh, n_micro, out, tag):
    """``pipeline_lm_loss`` of the per-layer tree ``params`` (stacked
    here) and the gradient of every per-layer leaf, into ``out``."""
    from veles_tpu_torch.ops import transformer as TT
    from veles_tpu_torch.parallel import pipeline as P
    for leaf in TT.tree_leaves(params):
        leaf.requires_grad_()
    stacked = dict(params, blocks=P.stack_blocks(params["blocks"]))
    loss = P.pipeline_lm_loss(stacked, tokens, mask, N_HEADS, mesh, n_micro)
    names = [name for name, _ in flat(params)]
    leaves = [leaf for _, leaf in flat(params)]
    out[tag + ":loss"] = loss.detach().numpy()
    for name, g in zip(names, torch.autograd.grad(loss, leaves)):
        out["%s:grad/%s" % (tag, name)] = g.numpy()


def error_of(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return "no error"


def configure(stages):
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    prng.reset()
    prng.seed_all(1)
    root.__dict__.pop("char_lm", None)
    root.char_lm.update(TINY)
    root.char_lm.trainer.pipeline_stages = stages


def pipe(world, rank, where, inputs):
    from veles_tpu_torch import parallel
    from veles_tpu_torch.parallel import pipeline as P
    from veles_tpu_torch.samples import char_lm
    out = {}
    tokens = torch.tensor(inputs["tokens"])
    mask = torch.ones(tokens.shape[0])
    meshes = {s: P.make_pipeline_mesh(s) for s in (1, 2, 3, 4)}
    for stages, n_micro in GEOMETRIES:
        if rank < stages:
            loss_and_grads(unflatten(inputs, "p/"), tokens, mask,
                           meshes[stages], n_micro, out,
                           "s%dm%d" % (stages, n_micro))
    params = unflatten(inputs, "f/")
    seq = tokens.shape[1]
    h = params["embed"][tokens.long()] + params["pos"][:seq]
    stacked = P.stack_blocks(params["blocks"])
    out["forward"] = P.pipeline_blocks(stacked, h, meshes[4], N_HEADS,
                                       n_microbatches=4).numpy()
    loss_and_grads(unflatten(inputs, "m/"), tokens, mask, meshes[4], 4, out,
                   "moe")
    h = torch.zeros(8, seq - 1, 16)
    out["guard_micro"] = numpy.asarray(error_of(lambda: P.pipeline_blocks(
        stacked, h, meshes[4], N_HEADS, n_microbatches=3)))
    if rank < 3:
        out["guard_stages"] = numpy.asarray(error_of(
            lambda: P.pipeline_blocks(stacked, h, meshes[3], N_HEADS,
                                      n_microbatches=4)))
    out["guard_mesh"] = numpy.asarray(error_of(
        lambda: P.make_pipeline_mesh(world + 1)))

    configure(4)
    wf = char_lm.train(device="cpu")
    tr = wf.trainer
    out["val_losses"] = numpy.asarray(
        [m["validation"]["loss"] for m in wf.decision.epoch_metrics])
    out["stage_blocks"] = numpy.asarray(
        tr.params["blocks"]["ln1"]["g"].shape[0])
    parallel.reset_collective_counts()
    state = tr.state_dict()
    tokens2 = torch.tensor(inputs["eval_tokens"])
    out["eval_loss_sum"] = tr._evalf(tr.params, tokens2,
                                     torch.ones(tokens2.shape[0]))[
        "loss_sum"].numpy()
    out["counts"] = numpy.asarray([parallel.collective_counts()[k] for k in (
        "p2p_exchange", "stage_output_all_reduce",
        "stage_input_grad_all_reduce")])
    path = os.path.join(where, "ref_state.pkl")
    deadline = time.monotonic() + 200
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError("no %s" % path)
        time.sleep(0.2)
    with open(path, "rb") as f:
        tr.load_state_dict(pickle.load(f))
    back = tr.state_dict()
    if rank == 0:
        with open(os.path.join(where, "states.pkl"), "wb") as f:
            pickle.dump({"trained": state, "ref_back": back}, f)
    return out


def cli(port, world, rank):
    from veles_tpu_torch import __main__ as main_mod
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    prng.reset()
    root.__dict__.pop("char_lm", None)
    sizes = ["root.char_lm.%s.%s=%r" % (section, k, v)
             for section, kv in TINY.items() for k, v in kv.items()
             if k != "pipeline_stages"]
    assert main_mod.main([
        "veles_tpu_torch.samples.char_lm", "-d", "cpu", "--no-stats",
        "--random-seed", "1", "root.char_lm.trainer.pipeline_stages=2",
        *sizes, "--distributed", "--coordinator-address",
        "127.0.0.1:%d" % port, "--num-processes", str(world),
        "--process-id", str(rank)]) == 0
    wf = main_mod.main.workflow
    return {"val_losses": numpy.asarray(
                [m["validation"]["loss"] for m in wf.decision.epoch_metrics]),
            "local_rows": numpy.asarray(wf.loader.local_minibatch_size),
            "sharded": numpy.asarray(hasattr(wf, "_sharded_trainer")),
            "backend": numpy.asarray(main_mod.main.launcher.backend),
            "stage_blocks": numpy.asarray(
                wf.trainer.params["blocks"]["ln1"]["g"].shape[0])}


def main(mode, port, world, rank, where):
    torch.set_num_threads(1)
    from veles_tpu_torch import parallel
    try:
        if mode == "pipe":
            inputs = dict(numpy.load(os.path.join(where, "inputs.npz")))
            parallel.initialize_multihost("127.0.0.1:%d" % port, world, rank,
                                          device="cpu")
            out = pipe(world, rank, where, inputs)
        else:
            out = cli(port, world, rank)
    finally:
        parallel.shutdown()
    numpy.savez(os.path.join(where, "%s%d.npz" % (mode, rank)), **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                  int(sys.argv[4]), sys.argv[5]))
