"""The port's data- and tensor-parallel training (``veles_tpu_torch.
parallel``) against the reference's ``ShardedTrainer`` on the suite's
8-device virtual CPU mesh.

The reference side runs in this process; the port side is four gloo
ranks on 127.0.0.1 (``tests/torch_parallel_worker.py``, one launch for
every scenario), from the reference's initial weights carried across by
``state_from_jax``.  What is held, and how closely:

- DP, the MNIST build of ``tests/test_parallel.py::_build``, 3 steps at
  minibatch 64 (16 rows a rank): the reference's bars, rtol 2e-5 and
  atol 2e-6, and ``n_err`` equal; the four ranks bit-equal;
- TP of layer 0 on a 2x2 grid, 1 step, the same bars;
- TP of the AlexNet FC trunk at crop 56, minibatch 16, 16 classes (2x2:
  data-parallel too, so dropout and the crop draw by rank): 2048-wide
  slices, rtol 2e-4 / atol 2e-5, ``loss_sum`` within 1e-4, ``n_err``
  equal;
- every epoch-scan entry of the trainer against the per-step loop (the
  reference's bars), the eval epoch against summed eval steps, the
  non-committing chunk, the divisibility error;
- the dropout offset: the plain version on a rank's rows equals the
  global plain mask's rows and ``jax.random.bernoulli``'s, bit for bit;
  a crop's rank draws are the global draws' rows;
- loader sharding: ``shard`` and ``shard_spmd`` of the full-batch and
  record loaders yield the reference loader's rows, equal; a sharded
  reference loader's snapshot carries across (``state_from_reference``)
  with its global plan and position.
"""

import json
import os
import socket
import subprocess
import sys

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORLD = 4


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _put_state(out, name, state):
    state = [{k: numpy.asarray(v) for k, v in e.items()} for e in state]
    out[name + ":layers"] = numpy.asarray(len(state))
    for i, entry in enumerate(state):
        for k, v in entry.items():
            out["%s/%d/%s" % (name, i, k)] = v


def _get_state(npz, name, n):
    layers = [dict() for _ in range(n)]
    for key in npz.files:
        if key.startswith(name + "/"):
            _, i, k = key.split("/")
            layers[int(i)][k] = npz[key]
    return layers


class _JaxConfig:
    """The reference's ``root.<name>`` subtree for the block, restored
    after."""

    def __init__(self, name):
        from veles_tpu.config import root
        self.root, self.name = root, name

    def __enter__(self):
        self.saved = self.root.__dict__.pop(self.name, None)
        return self.root

    def __exit__(self, *exc):
        self.root.__dict__.pop(self.name, None)
        if self.saved is not None:
            self.root.__dict__[self.name] = self.saved


def _jax_mnist(seed, mb=64):
    from veles_tpu import prng
    from veles_tpu.samples import mnist
    prng.reset()
    prng.seed_all(seed)
    with _JaxConfig("mnist") as root:
        root.mnist.update({
            "loader": {"minibatch_size": mb, "n_train": 256, "n_valid": 64},
            "decision": {"max_epochs": 1, "fail_iterations": 10},
            "layers": [
                {"type": "all2all_tanh", "output_sample_shape": 32,
                 "learning_rate": 0.05, "momentum": 0.9},
                {"type": "softmax", "output_sample_shape": 10,
                 "learning_rate": 0.05, "momentum": 0.9},
            ],
        })
        wf = mnist.build(fused=True)
        wf.initialize()
    return wf._fused_runner


def _jax_alexnet(mb):
    from veles_tpu import prng
    from veles_tpu.loader.fullbatch import FullBatchLoader
    from veles_tpu.samples.imagenet import ImagenetWorkflow, alexnet_layers

    class _SmallImages(FullBatchLoader):
        def load_data(self):
            rng = numpy.random.RandomState(7)
            self.original_data.reset(
                rng.uniform(-1, 1, (mb * 2, 64, 64, 3))
                .astype(numpy.float32))
            self.original_labels.reset(
                rng.randint(0, 16, mb * 2).astype(numpy.int32))
            self.class_lengths = [0, mb, mb]

    prng.reset()
    prng.seed_all(21)
    wf = ImagenetWorkflow(
        None, name="tp_alexnet", loader_factory=_SmallImages,
        loader_config={"minibatch_size": mb},
        layers=alexnet_layers(n_classes=16, crop=(56, 56)),
        decision_config={"max_epochs": 1, "fail_iterations": 5},
        loss_function="softmax", fused=True)
    wf.initialize()
    return wf._fused_runner


def _batch(mb, seed=3):
    rng = numpy.random.RandomState(seed)
    return (rng.randn(mb, 784).astype(numpy.float32),
            rng.randint(0, 10, mb).astype(numpy.int32),
            numpy.ones(mb, numpy.float32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's results and the port's four ranks' outputs."""
    from veles_tpu.parallel import (ShardedTrainer, make_mesh,
                                    model_shard_candidates)
    tmp = tmp_path_factory.mktemp("parallel")
    inputs, ref = {}, {}

    # DP: 3 steps at minibatch 64 on the 8-device mesh
    runner = _jax_mnist(11)
    _put_state(inputs, "dp", runner.state)
    x, labels, mask = _batch(64)
    for k, v in (("x", x), ("labels", labels), ("mask", mask)):
        inputs["dp:" + k] = inputs["tp:" + k] = v
    trainer = ShardedTrainer(runner, make_mesh(8))
    for _ in range(3):
        metrics = trainer.train_step(x, labels, mask, 64)
    ref["dp"] = [{k: numpy.asarray(v) for k, v in e.items()}
                 for e in trainer.state]
    ref["dp:n_err"] = int(ShardedTrainer.fetch(metrics)["n_err"])

    # TP of layer 0 on a (4, 2) mesh, one step
    runner = _jax_mnist(11)
    _put_state(inputs, "tp", runner.state)
    trainer = ShardedTrainer(runner, make_mesh(8, model_parallel=2),
                             model_shard_layers=(0,))
    trainer.train_step(x, labels, mask, 64)
    ref["tp"] = [{k: numpy.asarray(v) for k, v in e.items()}
                 for e in trainer.state]

    # TP of AlexNet's FC trunk, one step with a key
    mb = 16
    runner = _jax_alexnet(mb)
    _put_state(inputs, "alex", runner.state)
    rng = numpy.random.RandomState(9)
    inputs["alex:x"] = rng.uniform(-1, 1, (mb, 64, 64, 3)).astype(
        numpy.float32)
    inputs["alex:labels"] = numpy.arange(mb, dtype=numpy.int32) % 16
    inputs["alex:mask"] = numpy.ones(mb, numpy.float32)
    fc = model_shard_candidates(runner, min_width=4096)
    trainer = ShardedTrainer(runner, make_mesh(8, model_parallel=2),
                             model_shard_layers=fc)
    metrics = ShardedTrainer.fetch(trainer.train_step(
        inputs["alex:x"], inputs["alex:labels"], inputs["alex:mask"], mb,
        rng=jax.random.PRNGKey(4), step=0))
    ref["alex"] = [{k: numpy.asarray(v) for k, v in e.items()}
                   for e in trainer.fetch(trainer.state)]
    ref["alex:fc"] = list(fc)
    ref["alex:loss_sum"] = float(metrics["loss_sum"])
    ref["alex:n_err"] = int(metrics["n_err"])

    path = str(tmp / "inputs.npz")
    numpy.savez(path, **inputs)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_parallel_worker.py"),
         str(port), str(WORLD), str(r), path, str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO) for r in range(WORLD)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = []
    for r in range(WORLD):
        with open(str(tmp / ("rank%d.json" % r))) as f:
            meta = json.load(f)
        ranks.append((numpy.load(str(tmp / ("rank%d.npz" % r))), meta))
    return ref, ranks


def _scenario(ranks, name):
    for _, meta in ranks:
        assert name not in meta["errors"], meta["errors"][name]
    return ranks[0]


def _close(got, want, rtol, atol, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys(), (what, i)
        for k in w:
            numpy.testing.assert_allclose(
                g[k], w[k], rtol=rtol, atol=atol,
                err_msg="%s layer %d %s" % (what, i, k))


def test_dp_matches_reference_sharded_trainer(runs):
    ref, ranks = runs
    npz, meta = _scenario(ranks, "dp")
    assert meta["checks"]["backend"] == "gloo"
    assert meta["checks"]["dp_local_rows"] == 16
    got = _get_state(npz, "dp", len(ref["dp"]))
    _close(got, ref["dp"], 2e-5, 2e-6, "dp")
    assert int(npz["dp:n_err"]) == ref["dp:n_err"]


def test_dp_ranks_bit_equal(runs):
    ref, ranks = runs
    first = _get_state(_scenario(ranks, "dp")[0], "dp", len(ref["dp"]))
    for npz, _ in ranks[1:]:
        for a, b in zip(first, _get_state(npz, "dp", len(ref["dp"]))):
            for k in a:
                assert numpy.array_equal(a[k], b[k]), k


def test_tp_one_layer_matches(runs):
    ref, ranks = runs
    npz, meta = _scenario(ranks, "tp")
    assert meta["checks"]["tp_local_width"] == 16
    _close(_get_state(npz, "tp", len(ref["tp"])), ref["tp"], 2e-5, 2e-6,
           "tp")
    # the replicated layer is bit-equal on every rank
    for other, _ in ranks[1:]:
        a = _get_state(npz, "tp", len(ref["tp"]))[1]
        b = _get_state(other, "tp", len(ref["tp"]))[1]
        assert all(numpy.array_equal(a[k], b[k]) for k in a)


def test_tp_alexnet_fc_trunk_matches(runs):
    ref, ranks = runs
    npz, meta = _scenario(ranks, "tp_alexnet")
    assert meta["checks"]["alex_fc"] == ref["alex:fc"]
    assert len(ref["alex:fc"]) == 2
    assert meta["checks"]["alex_local_widths"] == [2048, 2048]
    numpy.testing.assert_allclose(float(npz["alex:loss_sum"]),
                                  ref["alex:loss_sum"], rtol=1e-4)
    assert int(npz["alex:n_err"]) == ref["alex:n_err"]
    _close(_get_state(npz, "alex", len(ref["alex"])), ref["alex"], 2e-4,
           2e-5, "alexnet tp")


def test_epoch_scan_entries_match_per_step_loop(runs):
    _, ranks = runs
    npz, meta = _scenario(ranks, "scan")
    checks = meta["checks"]
    n = 2

    def state(name):
        return _get_state(npz, name, n)

    _close(state("scan_epoch"), state("scan_loop"), 2e-5, 2e-6, "epoch")
    assert checks["scan_step_count"] == 4
    _close(state("scan_chunk"), state("scan_seq"), 2e-5, 2e-6, "chunk")
    _close(state("scan_chunk_eval"), state("scan_seq"), 2e-5, 2e-6,
           "chunk+eval")
    _close(state("scan_pending"), state("scan_seq"), 2e-5, 2e-6, "pending")
    assert checks["chunk_step_count"] == 8
    assert checks["pending_kept_state"] and checks["pending_no_test"]
    for key in npz.files:
        if key.startswith("chunk_row1:"):
            numpy.testing.assert_allclose(
                npz[key], npz["seq_last:" + key.split(":")[1]], rtol=1e-5)
        if key.startswith("chunk_val"):
            numpy.testing.assert_allclose(
                npz[key], npz["seq" + key[len("chunk"):]], rtol=1e-5)
        if key.startswith("eval_epoch:"):
            numpy.testing.assert_allclose(
                npz[key], npz["eval_steps:" + key.split(":")[1]],
                rtol=1e-5)


def test_epoch_scan_requires_divisible_minibatch(runs):
    _, ranks = runs
    for _, meta in ranks:
        said = meta["checks"].get("indivisible_raised")
        assert said and "not divisible by data-axis size 2" in said


def test_collectives_counted(runs):
    _, ranks = runs
    counts = ranks[0][1]["checks"]["collectives"]
    # DP 3 + TP 1 + AlexNet 1 + the scan scenario's train steps
    assert counts["grad_all_reduce"] >= 5
    assert counts["tp_all_gather"] > 0
    assert counts["tp_input_grad_all_reduce"] > 0
    assert counts["metric_all_reduce"] > 0


@pytest.mark.parametrize("rows,features,rate", [(2, 9216, 0.5),
                                                (4, 4096, 0.3)])
def test_dropout_offset_draws_the_global_rows(rows, features, rate):
    from veles_tpu_torch import prng
    from veles_tpu_torch.ops import hopper_kernels as HK
    key = prng.PRNGKey(17)
    mb = 2 * rows
    x = torch.ones((mb, features))
    whole = HK.dropout_ref(x, key, rate)
    keep = jax.random.bernoulli(jnp.asarray(key), 1.0 - rate,
                                (mb, features))
    want = numpy.where(numpy.asarray(keep),
                       numpy.float32(1.0) / numpy.float32(1.0 - rate), 0.0)
    numpy.testing.assert_array_equal(whole.numpy(), want)
    for r in range(2):
        part = HK.dropout(x[r * rows:(r + 1) * rows].contiguous(), key,
                          rate, offset=r * rows * features)
        assert torch.equal(part, whole[r * rows:(r + 1) * rows])
    with pytest.raises(ValueError, match="offset"):
        HK.dropout(x, key, rate, offset=-1)


def test_row_shard_keys_draw_the_global_rows():
    from veles_tpu_torch import prng
    from veles_tpu_torch.ops import functional as F
    key = prng.PRNGKey(5)
    x = torch.arange(8 * 12 * 12 * 3, dtype=torch.float32).reshape(
        8, 12, 12, 3)
    whole_crop = F.random_crop_flip(x, key, (9, 9))
    whole_drop = F.dropout(x, key, 0.5, True)
    for r in range(2):
        rows = x[r * 4:(r + 1) * 4].contiguous()
        shard = F.RowShard((key, r, 2))
        assert torch.equal(F.random_crop_flip(rows, shard, (9, 9)),
                           whole_crop[r * 4:(r + 1) * 4])
        assert torch.equal(F.dropout(rows, shard, 0.5, True),
                           whole_drop[r * 4:(r + 1) * 4])


def _loader_rows(loader, n):
    """The first ``n`` minibatches' (class, indices, size, mask, data)."""
    out = []
    for _ in range(n):
        loader.run()
        out.append((loader.minibatch_class, numpy.array(
            loader.minibatch_indices.mem), loader.minibatch_size,
            numpy.array(loader.minibatch_mask.mem),
            numpy.array(loader.minibatch_data.mem)))
    return out


@pytest.mark.parametrize("mode", ["shard", "shard_spmd"])
def test_fullbatch_loader_shards_equal_reference(mode):
    from veles_tpu import prng as jax_prng
    from veles_tpu.samples import mnist as jax_mnist
    from veles_tpu.workflow import Workflow as JaxWorkflow
    from veles_tpu_torch import prng
    from veles_tpu_torch.samples import mnist
    from veles_tpu_torch.workflow import Workflow
    for pi in range(2):
        rows = []
        for mod, pkg, wf in ((jax_prng, jax_mnist, JaxWorkflow(None)),
                             (prng, mnist, Workflow(None))):
            mod.reset()
            mod.seed_all(5)
            loader = pkg.MnistLoader(wf, minibatch_size=32, n_train=100,
                                     n_valid=40)
            getattr(loader, mode)(pi, 2)
            kwargs = {"device": "cpu"} if pkg is mnist else {}
            loader.initialize(**kwargs)
            rows.append(_loader_rows(loader, 6))
        for got, want in zip(rows[1], rows[0]):
            for g, w in zip(got, want):
                numpy.testing.assert_array_equal(g, w)
        assert rows[1][0][1].shape[0] == (16 if mode == "shard_spmd"
                                          else 32)


@pytest.mark.parametrize("mode", ["shard", "shard_spmd"])
def test_records_loader_shards_equal_reference(tmp_path, mode):
    from veles_tpu import prng as jax_prng
    from veles_tpu.loader import records as jax_records
    from veles_tpu.workflow import Workflow as JaxWorkflow
    from veles_tpu_torch import prng
    from veles_tpu_torch.loader import records
    from veles_tpu_torch.workflow import Workflow
    rng = numpy.random.RandomState(2)
    path = str(tmp_path / "set.rec")
    data = rng.randint(0, 255, (70, 6, 6, 3)).astype(numpy.uint8)
    jax_records.write_records(path, data, rng.randint(0, 5, 70).astype(
        numpy.int32), [0, 20, 50])
    for pi in range(2):
        rows = []
        for mod, pkg, wf in ((jax_prng, jax_records, JaxWorkflow(None)),
                             (prng, records, Workflow(None))):
            mod.reset()
            mod.seed_all(3)
            loader = pkg.RecordsLoader(wf, path=path, minibatch_size=8)
            getattr(loader, mode)(pi, 2)
            kwargs = {"device": "cpu"} if pkg is records else {}
            loader.initialize(**kwargs)
            rows.append(_loader_rows(loader, 9))
        for got, want in zip(rows[1], rows[0]):
            for g, w in zip(got, want):
                numpy.testing.assert_array_equal(g, w)


def test_sharded_reference_snapshot_carried_across():
    """A reference SPMD-sharded loader's snapshot (process 0's, mid
    epoch) carries across with ``state_from_reference``: restored into
    the port's loader as shard 1 of 2, the global plan and position
    survive and the port yields shard 1's rows of the reference's next
    minibatch; a strided shard's plan is rebuilt."""
    from veles_tpu import prng as jax_prng
    from veles_tpu.samples import mnist as jax_mnist
    from veles_tpu.workflow import Workflow as JaxWorkflow
    from veles_tpu_torch import prng, snapshotter
    from veles_tpu_torch.samples import mnist
    from veles_tpu_torch.workflow import Workflow
    jax_prng.reset()
    jax_prng.seed_all(9)
    ref = jax_mnist.MnistLoader(JaxWorkflow(None), name="loader",
                                minibatch_size=32, n_train=100, n_valid=40)
    ref.shard_spmd(0, 2)
    ref.initialize()
    for _ in range(3):
        ref.run()
    state = {"units": {"loader": ref.state_dict()}, "prng": {}}
    carried = snapshotter.state_from_reference(state)["units"]["loader"]
    assert carried["_spmd_shard"] == (0, 2)
    prng.reset()
    prng.seed_all(9)
    port = mnist.MnistLoader(Workflow(None), name="loader",
                             minibatch_size=32, n_train=100, n_valid=40)
    port.shard_spmd(1, 2)
    port.initialize(device="cpu")
    port.load_state_dict(carried)
    assert port._spmd_shard == (1, 2) and port._position == 3
    ref.run()
    port.run()
    numpy.testing.assert_array_equal(
        numpy.asarray(port.minibatch_indices.mem),
        ref._order[3][1][16:32])
    strided = mnist.MnistLoader(Workflow(None), name="loader",
                                minibatch_size=32, n_train=100,
                                n_valid=40)
    strided.shard(1, 2)
    strided.initialize(device="cpu")
    strided.load_state_dict(dict(carried, _shard=(0, 2),
                                 _spmd_shard=None))
    assert strided._shard == (1, 2) and strided._position == 0
