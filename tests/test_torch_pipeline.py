"""The port's GPipe pipeline (``veles_tpu_torch.parallel.pipeline``) and
the trainer's pipelined path against ``veles_tpu.parallel.pipeline`` and
``veles_tpu.ops.transformer``, at ``tests/test_pipeline.py``'s sizes
(vocab 32, d 16, 2 heads, 4 layers, seq 17, batch 8) and
``tests/test_transformer.py::TestPipelinedTrainer``'s char-LM run.

The port's stages are gloo CPU ranks (``tests/torch_pipeline_worker.py``:
one launch of four ranks for every pipeline case, one of two for the
CLI); the reference runs in this process on the suite's virtual CPU
mesh.  Bars, the reference's own: loss rtol 1e-5 / atol 1e-6, gradients
rtol 2e-4 / atol 1e-5, the stage forward rtol 2e-4 / atol 1e-5, the
pipelined trainer's validation losses rtol 2e-5 of the sequential run
(and rtol 1e-4 of the reference's, ``tests/test_torch_lm_train.py``'s
bar between the packages); state dicts equal.  The ranks are bit-equal
to the same arithmetic in one process at one stage.  The MoE case holds
routing as ``tests/test_torch_moe.py`` does: a token whose top-1 /
top-2 router margin is below ``FLIP_MARGIN`` could route otherwise by
roundoff, so the case needs every margin above it.
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

from veles_tpu import prng as jprng
from veles_tpu.config import root as jroot
from veles_tpu.ops import moe as JM
from veles_tpu.ops import transformer as JT
from veles_tpu.parallel import pipeline as JP
from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.ops import transformer as TT
from veles_tpu_torch.parallel import pipeline as P

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)

import torch_pipeline_worker as worker  # noqa: E402

VOCAB, D_MODEL, N_HEADS, N_LAYERS, SEQ = 32, 16, 2, 4, 17
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol=1e-5)
RUN_RTOL = 2e-5
REF_RUN_RTOL = 1e-4
FLIP_MARGIN = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _host(seed, **kwargs):
    """``tests/test_pipeline.py::_setup``'s params (numpy), the port's
    checked equal."""
    jprng.reset()
    jprng.seed_all(seed)
    host = JT.init_transformer_params(jprng.get("init"), VOCAB,
                                      d_model=D_MODEL, n_heads=N_HEADS,
                                      n_layers=N_LAYERS, max_len=64,
                                      **kwargs)
    prng.reset()
    prng.seed_all(seed)
    mine = TT.init_transformer_params(prng.get("init"), VOCAB,
                                      d_model=D_MODEL, n_heads=N_HEADS,
                                      n_layers=N_LAYERS, max_len=64,
                                      **kwargs)
    for (ka, a), (kb, b) in zip(worker.flat(host), worker.flat(mine)):
        assert ka == kb
        numpy.testing.assert_array_equal(a, b)
    return host


def _configure(cfg_root, package_prng, stages):
    package_prng.reset()
    package_prng.seed_all(1)
    cfg_root.__dict__.pop("char_lm", None)
    cfg_root.char_lm.update(worker.TINY)
    cfg_root.char_lm.trainer.pipeline_stages = stages


def _val_losses(wf):
    return [m["validation"]["loss"] for m in wf.decision.epoch_metrics]


def _router_margins(host, tokens):
    """The reference's top-1 / top-2 router margins of every token at
    every MoE block over one forward of ``tokens``."""
    kept, real = [], JM.router_probs

    def recording(params, x):
        p = real(params, x)
        kept.append(numpy.asarray(p))
        return p

    JM.router_probs = recording
    try:
        JT.transformer_forward(jax.tree.map(jnp.asarray, host),
                               jnp.asarray(tokens), N_HEADS)
    finally:
        JM.router_probs = real
    top2 = numpy.sort(numpy.concatenate(kept), axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def _reference(host, fwd_host, moe_host, tokens, where):
    """The reference's side, computed while the ranks run: lm_loss and
    its gradients (dense and MoE), the staged forward, the sequential
    char-LM run, and its state through a pipelined trainer (published
    to ``where`` for the ranks)."""
    from veles_tpu.samples import char_lm
    mask = jnp.ones(tokens.shape[0], jnp.float32)
    out = {}
    out["loss"] = jax.value_and_grad(JT.lm_loss)(
        jax.tree.map(jnp.asarray, host), jnp.asarray(tokens), mask, N_HEADS)
    out["moe"] = jax.value_and_grad(JT.lm_loss)(
        jax.tree.map(jnp.asarray, moe_host), jnp.asarray(tokens), mask,
        N_HEADS)
    out["moe_margins"] = _router_margins(moe_host, tokens[:, :-1])
    params = jax.tree.map(jnp.asarray, fwd_host)
    h = params["embed"][jnp.asarray(tokens)] + params["pos"][:SEQ]
    out["forward"] = numpy.asarray(JP.pipeline_blocks(
        JP.stack_blocks(params["blocks"]), h, JP.make_pipeline_mesh(4),
        N_HEADS, n_microbatches=4))
    _configure(jroot, jprng, 0)
    seq = char_lm.train()
    out["val_losses"] = _val_losses(seq)
    _configure(jroot, jprng, 4)
    piped = char_lm.build()
    piped.initialize()
    piped.trainer.load_state_dict(seq.trainer.state_dict())
    out["ref_state"] = piped.trainer.state_dict()
    out["ref_trainer"] = piped.trainer
    tmp = os.path.join(where, "ref_state.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(out["ref_state"], f)
    os.replace(tmp, os.path.join(where, "ref_state.pkl"))
    return out


def _spawn(mode, world, where):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_pipeline_worker.py"),
         mode, str(port), str(world), str(r), where],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO) for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, reference, four ranks' results, two CLI ranks' results,
    rank 0's states, the port's in-process runs)."""
    where = str(tmp_path_factory.mktemp("pipeline"))
    host, fwd_host = _host(3), _host(5)
    moe_host = _host(3, n_experts=4)
    tokens = numpy.random.RandomState(7).randint(0, VOCAB, (8, SEQ))
    eval_tokens = numpy.random.RandomState(2).randint(0, 16, (8, 32))
    numpy.savez(os.path.join(where, "inputs.npz"), tokens=tokens,
                eval_tokens=eval_tokens,
                **{p + name: a for p, tree in (("p/", host), ("f/", fwd_host),
                                               ("m/", moe_host))
                   for name, a in worker.flat(tree)})
    procs = _spawn("pipe", 4, where) + _spawn("cli", 2, where)
    errs = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # the ranks' summation order
    try:
        ref = _reference(host, fwd_host, moe_host, tokens, where)
        mine = {}
        for stages in (0, 1):
            from veles_tpu_torch.samples import char_lm
            _configure(root, prng, stages)
            mine[stages] = char_lm.train(device="cpu")
        for p in procs:
            _, err = p.communicate(timeout=240)
            errs.append(err)
    finally:
        torch.set_num_threads(threads)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-4000:]
    ranks = [dict(numpy.load(os.path.join(where, "pipe%d.npz" % r)))
             for r in range(4)]
    clis = [dict(numpy.load(os.path.join(where, "cli%d.npz" % r)))
            for r in range(2)]
    with open(os.path.join(where, "states.pkl"), "rb") as f:
        states = pickle.load(f)
    return {"host": host, "tokens": tokens, "eval_tokens": eval_tokens,
            "ref": ref, "ranks": ranks, "clis": clis, "states": states,
            "mine": mine}


def _own(name, stage, stages):
    """Whether leaf ``name`` (a per-layer path) is replicated or one of
    ``stage``'s blocks."""
    if not name.startswith("blocks/"):
        return True
    layer = int(name.split("/")[1])
    k = N_LAYERS // stages
    return stage * k <= layer < (stage + 1) * k


@pytest.mark.parametrize("stages,n_micro", [(2, 8), (4, 4)])
def test_pipeline_loss_and_grads_match_reference(runs, stages, n_micro):
    """Each stage's loss, replicated gradients and its blocks' gradients
    equal ``jax.value_and_grad(lm_loss)`` of the sequential stack."""
    loss, grads = runs["ref"]["loss"]
    want = dict(worker.flat(jax.tree.map(numpy.asarray, grads)))
    tag = "s%dm%d" % (stages, n_micro)
    for stage in range(stages):
        got = runs["ranks"][stage]
        numpy.testing.assert_allclose(got[tag + ":loss"], float(loss),
                                      **LOSS_TOL)
        for name, w in want.items():
            if _own(name, stage, stages):
                numpy.testing.assert_allclose(
                    got["%s:grad/%s" % (tag, name)], w, err_msg=name,
                    **GRAD_TOL)


@pytest.mark.parametrize("stages,n_micro", [(2, 8), (4, 4)])
def test_pipeline_ranks_bit_equal_to_one_stage(runs, stages, n_micro):
    """The hops and the zero-padded sums are exact: every stage's loss
    and gradients equal the same microbatching at one stage in one
    process bit for bit."""
    one = runs["ranks"][0]
    tag, single = "s%dm%d" % (stages, n_micro), "s1m%d" % n_micro
    for stage in range(stages):
        got = runs["ranks"][stage]
        numpy.testing.assert_array_equal(got[tag + ":loss"],
                                         one[single + ":loss"])
        for key in got:
            if key.startswith(tag + ":grad/"):
                name = key[len(tag + ":grad/"):]
                if _own(name, stage, stages):
                    numpy.testing.assert_array_equal(
                        got[key], one[single + ":grad/" + name],
                        err_msg=name)


def test_pipeline_blocks_forward_matches_reference(runs):
    """The staged forward at 4 stages and 4 microbatches equals the
    reference's ``pipeline_blocks`` on every rank (bit-equal across
    ranks)."""
    for r in runs["ranks"]:
        numpy.testing.assert_allclose(r["forward"], runs["ref"]["forward"],
                                      rtol=2e-4, atol=1e-5)
        numpy.testing.assert_array_equal(r["forward"],
                                         runs["ranks"][0]["forward"])


def test_pipeline_shape_guards(runs):
    """The reference's ValueErrors and messages."""
    for rank, r in enumerate(runs["ranks"]):
        assert str(r["guard_micro"]) == "batch 8 % n_microbatches 3 != 0"
        if rank < 3:
            assert str(r["guard_stages"]) == "n_layers 4 % n_stages 3 != 0"
        assert str(r["guard_mesh"]) == "need 5 devices, have 4"


def test_make_pipeline_mesh_needs_the_ranks():
    """With no joined run the mesh counts this one process."""
    mesh = P.make_pipeline_mesh(1)
    assert mesh.shape == {"stage": 1} and mesh.coords == {"stage": 0}
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        P.make_pipeline_mesh(2)


def test_stack_unstack_round_trip():
    host = _host(3)
    blocks = TT.tree_map(torch.tensor, host)["blocks"]
    stacked = P.stack_blocks(blocks)
    assert stacked["attn"]["wq"].shape == (N_LAYERS, D_MODEL, D_MODEL)
    back = P.unstack_blocks(stacked, N_LAYERS)
    for (ka, a), (kb, b) in zip(worker.flat(back), worker.flat(blocks)):
        assert ka == kb
        assert torch.equal(a, b)
    ref = JP.stack_blocks(jax.tree.map(jnp.asarray, host["blocks"]))
    for (ka, a), (kb, b) in zip(worker.flat(stacked), worker.flat(ref)):
        assert ka == kb
        numpy.testing.assert_array_equal(a.numpy(), numpy.asarray(b))


def test_pipelined_moe_loss_matches_reference(runs, record_property):
    """The MoE LM through 4 stages: loss and gradients equal the
    reference's sequential ``lm_loss`` (no aux term on the pipeline)."""
    margins = runs["ref"]["moe_margins"]
    record_property("min_router_margin", float(margins.min()))
    assert margins.min() >= FLIP_MARGIN, margins.min()
    loss, grads = runs["ref"]["moe"]
    want = dict(worker.flat(jax.tree.map(numpy.asarray, grads)))
    for stage, r in enumerate(runs["ranks"]):
        numpy.testing.assert_allclose(r["moe:loss"], float(loss), **LOSS_TOL)
        for name, w in want.items():
            if _own(name, stage, 4):
                numpy.testing.assert_allclose(r["moe:grad/" + name], w,
                                              err_msg=name, **GRAD_TOL)


def test_pipelined_trainer_matches_sequential(runs):
    """``char_lm`` at 4 layers on 4 stages, 4 microbatches, 2 epochs:
    each stage holds one block; validation losses equal the port's
    sequential run (rtol 2e-5), the reference's (rtol 1e-4), and the
    one-stage run in this process bit for bit."""
    seq = _val_losses(runs["mine"][0])
    one = _val_losses(runs["mine"][1])
    for r in runs["ranks"]:
        got = r["val_losses"].tolist()
        assert int(r["stage_blocks"]) == 1
        numpy.testing.assert_allclose(got, seq, rtol=RUN_RTOL, atol=1e-6)
        numpy.testing.assert_allclose(got, runs["ref"]["val_losses"],
                                      rtol=REF_RUN_RTOL)
        assert got == one


def _equal_trees(a, b):
    fa, fb = list(worker.flat(a)), list(worker.flat(b))
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (name, x), (_, y) in zip(fa, fb):
        numpy.testing.assert_array_equal(numpy.asarray(x), numpy.asarray(y),
                                         err_msg=name)


def test_pipelined_state_dict_carries_across_both_ways(runs):
    """The reference pipelined trainer's portable state loads into the
    port's four stages and reads back equal; the port's (gathered from
    its stages) loads into the reference's pipelined trainer and reads
    back equal."""
    ref_state = runs["ref"]["ref_state"]
    back = runs["states"]["ref_back"]
    assert isinstance(back["params"]["blocks"], list)
    assert back["time"] == ref_state["time"]
    _equal_trees(back["params"], ref_state["params"])
    _equal_trees(back["opt_state"], ref_state["opt_state"])
    mine = runs["states"]["trained"]
    assert len(mine["params"]["blocks"]) == N_LAYERS
    tr = runs["ref"]["ref_trainer"]
    tr.load_state_dict(mine)
    again = tr.state_dict()
    assert again["time"] == mine["time"]
    _equal_trees(again["params"], mine["params"])
    _equal_trees(again["opt_state"], mine["opt_state"])


def test_pipelined_snapshot_restores_into_sequential(runs):
    """The stages' gathered state restored into a sequential port
    trainer scores the same tokens within rtol 2e-5."""
    from veles_tpu_torch.samples import char_lm
    _configure(root, prng, 0)
    wf = char_lm.build()
    wf.initialize(device="cpu")
    wf.trainer.load_state_dict(runs["states"]["trained"])
    tokens = torch.tensor(runs["eval_tokens"])
    got = wf.trainer._evalf(wf.trainer.params, tokens,
                            torch.ones(tokens.shape[0]))["loss_sum"]
    for r in runs["ranks"]:
        numpy.testing.assert_allclose(got.item(), float(r["eval_loss_sum"]),
                                      rtol=RUN_RTOL)


def test_pipelined_collectives_counted(runs):
    """An eval pass at 4 stages and 4 microbatches: a stage exchanges on
    each tick it sends or receives, and the outputs are summed once."""
    for stage, r in enumerate(runs["ranks"]):
        ticks = sum(1 for t in range(7)
                    if (0 <= t - stage < 4 and stage < 3)
                    or (stage > 0 and 0 <= t - stage + 1 < 4))
        assert r["counts"].tolist() == [ticks, 1, 0]


def test_cli_pipelined_run_on_two_ranks(runs):
    """``python -m veles_tpu_torch veles_tpu_torch.samples.char_lm
    --distributed ... pipeline_stages=2`` on two gloo ranks: the loader
    is not sharded, no ShardedTrainer is wrapped, each rank holds two
    blocks, and the run equals the one-stage run in this process."""
    one = _val_losses(runs["mine"][1])
    for r in runs["clis"]:
        assert int(r["local_rows"]) == worker.TINY["loader"][
            "minibatch_size"]
        assert not bool(r["sharded"])
        assert str(r["backend"]) == "gloo"
        assert int(r["stage_blocks"]) == 2
        assert r["val_losses"].tolist() == one


def test_pipelined_trainer_refuses_rope_window_and_warns():
    """The reference's rope/window refusal, and its two warnings on the
    train loss (none on the eval loss)."""
    for kw in ({"rope": True}, {"window": 4}):
        with pytest.raises(ValueError, match="pipeline"):
            TT.TransformerTrainer(None, pipeline_stages=2, **kw)
    tr = TT.TransformerTrainer(None, pipeline_stages=1, remat=True,
                               n_experts=2, moe_aux_coef=1e-2)
    said = []
    tr.warning = lambda msg, *args: said.append(msg % args)
    tr._loss_fn(training=False)
    assert said == []
    tr._loss_fn(training=True)
    assert len(said) == 2
    assert "remat is not applied" in said[0]
    assert "moe_aux_coef is not applied" in said[1]
