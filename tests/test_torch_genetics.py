"""The port's population training — ``subproc`` and ``genetics`` (the
GA, its workers and ``--optimize``) — against ``veles_tpu.genetics``
(the ensemble: ``tests/test_torch_ensemble.py``).

Same configs as ``tests/test_genetics.py`` (MNIST-FC at 200 / 100
rows, 16 hidden; the PRNG streams seeded alike in both packages), run
through both.  Exact: ``find_tunes`` paths, the GA's history on the
quadratic, the GA winner and its fitness (sequential against the
reference; the port's ``workers=3`` against its ``workers=0``, both on
``device="cpu"``), and the CLI's printed winner.
"""

import os
import subprocess
import sys
import time

import pytest
import torch

from veles_tpu import genetics as jgenetics
from veles_tpu import prng as jprng
from veles_tpu import subproc as jsubproc
from veles_tpu.config import Config as JConfig
from veles_tpu.config import Tune as JTune
from veles_tpu.config import root as jroot
from veles_tpu.samples import mnist as jmnist
from veles_tpu_torch import ensemble, genetics, prng, subproc
from veles_tpu_torch.config import Config, Tune, root
from veles_tpu_torch.samples import mnist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POOL = "tests.torch_genetics_worker"


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU products run fastest single-threaded; the workers take
    the parent's count with its other process-wide settings."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
    for tree in (root, jroot):
        for name in ("mnist", "ga_test"):
            tree.__dict__.pop(name, None)


def _configure(package_prng, tree, tune):
    """``tests/test_genetics.py:94-109``'s MNIST config, layer 0's
    learning rate a Tune."""
    package_prng.reset()
    package_prng.seed_all(1)
    tree.__dict__.pop("mnist", None)
    tree.mnist.update({
        "loader": {"minibatch_size": 50, "n_train": 200, "n_valid": 100},
        "decision": {"max_epochs": 2, "fail_iterations": 5},
        "layers": [
            {"type": "all2all_tanh", "output_sample_shape": 16,
             "learning_rate": tune(0.001, 0.0005, 0.1), "momentum": 0.9},
            {"type": "softmax", "output_sample_shape": 10,
             "learning_rate": 0.03, "momentum": 0.9},
        ],
    })


def _tree(config, tune):
    cfg = config("root")
    cfg.model.lr = tune(0.01, 0.001, 0.1)
    cfg.model.momentum = 0.9
    cfg.loader.size = tune(100, 10, 1000)
    cfg.net.layers = [{"lr": tune(0.03, 0.005, 0.1), "n": 4},
                      {"decay": {"l2": tune(1e-4, 0.0, 1e-3)}}]
    cfg.net.shape = (tune(1, 0, 2),)     # tuples are not descended
    return cfg


def test_find_tunes_and_set_leaf_equal_reference():
    mine, theirs = _tree(Config, Tune), _tree(JConfig, JTune)
    paths = [p for p, _ in genetics.find_tunes(mine, "root")]
    assert paths == [p for p, _ in jgenetics.find_tunes(theirs, "root")]
    assert paths == ["root.loader.size", "root.model.lr",
                     "root.net.layers[0]['lr']",
                     "root.net.layers[1]['decay']['l2']"]
    for i, path in enumerate(paths):
        genetics.set_leaf(path, 0.5 + i, mine)
        jgenetics.set_leaf(path, 0.5 + i, theirs)
    assert (subproc.plain_config(mine.as_dict())
            == jsubproc.plain_config(theirs.as_dict()))
    assert genetics.find_tunes(mine, "root") == []


def test_quadratic_ga_equals_reference():
    """``tests/test_genetics.py``'s quadratic: the same individuals,
    history and winner from the same seeded ``genetics`` stream."""
    def evaluate(individual):
        x, y = individual
        return (x - 2.0) ** 2 + (y + 3.0) ** 2

    runs = []
    for package_prng, module, tune in ((jprng, jgenetics, JTune),
                                       (prng, genetics, Tune)):
        package_prng.reset()
        package_prng.seed_all(7)
        genes = [("root.ga_test.x", tune(5.0, -10.0, 10.0)),
                 ("root.ga_test.y", tune(-5.0, -10.0, 10.0))]
        runs.append(module.optimize(evaluate, generations=12,
                                    population=12, genes=genes))
    (want_fit, want_genes, want_pop), (got_fit, got_genes, got_pop) = runs
    assert got_fit == want_fit < 0.5
    assert got_genes == want_genes
    assert got_pop.history == want_pop.history
    assert got_pop.individuals == want_pop.individuals
    assert root.ga_test.x == jroot.ga_test.x == want_genes["root.ga_test.x"]


def test_optimize_workflow_equals_reference_and_workers():
    """The reference's winner and fitness, sequentially; the port's
    3-worker screening equal to its sequential one, history too."""
    _configure(jprng, jroot, JTune)
    want = jgenetics.optimize_workflow(jmnist, generations=2, population=3,
                                       seed=1)
    runs = []
    for workers in (0, 3):
        _configure(prng, root, Tune)
        runs.append(genetics.optimize_workflow(
            mnist, generations=2, population=3, seed=1, workers=workers,
            device="cpu"))
        # the winner is left in the config tree
        (path, value), = runs[-1][1].items()
        assert root.mnist.layers[0]["learning_rate"] == value
    (seq_fit, seq_genes, seq_pop), (par_fit, par_genes, par_pop) = runs
    assert seq_fit == float(want[0])
    assert seq_genes == want[1]
    assert seq_pop.history == [(float(f), g) for f, g in want[2].history]
    assert (par_fit, par_genes, par_pop.history) == (seq_fit, seq_genes,
                                                     seq_pop.history)


def test_pool_returns_in_spec_order():
    """A slow first spec does not hold back the others, results come
    back in spec order, and only the last stdout line is the result."""
    specs = [{"sleep": 1.0, "i": 0}, {"i": 1}, {"i": 2}]
    results = subproc.run_workers(POOL, specs, 2)
    assert [r["spec"] for r in results] == specs
    assert len({r["pid"] for r in results}) == 3
    with pytest.raises(ValueError, match="workers must be >= 1"):
        subproc.run_workers(POOL, specs, 0)


def test_failing_worker_raises_its_stderr_and_leaves_no_orphans(
        monkeypatch):
    started = []
    popen = subprocess.Popen

    def recording(*args, **kwargs):
        started.append(popen(*args, **kwargs))
        return started[-1]

    monkeypatch.setattr(subproc.subprocess, "Popen", recording)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError,
                       match="(?s)worker 1 .* failed:.*boom in the worker"):
        subproc.run_workers(POOL, [{"sleep": 60}, {"fail": "boom in the "
                                                             "worker"}], 2)
    assert time.monotonic() - t0 < 30
    assert len(started) == 2
    assert all(proc.poll() is not None for proc in started)
    monkeypatch.undo()
    genes = [("root.ga_fail.x", Tune(0.5, 0.0, 1.0))]
    with pytest.raises(RuntimeError, match="(?s)worker.*No module named"):
        genetics.evaluate_population("veles_tpu_torch.samples.no_such",
                                     genes, [[0.5], [0.6]], seed=1,
                                     workers=2, device="cpu")


def test_worker_asked_for_the_card_without_one_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        subproc.worker_device("cuda")
    assert subproc.worker_device("cpu") == "cpu"
    for call in (lambda: genetics.optimize_workflow(mnist, 1, 2),
                 lambda: ensemble.EnsembleTrainer(mnist, size=1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_cli_optimize_prints_the_reference_winner(tmp_path):
    """``python -m veles_tpu_torch ... -d cpu --optimize 1:2:2``: a
    config file with a Tune leaf, the GA across two worker processes,
    the reference's winner and fitness printed."""
    text = ("root.mnist.update({\n"
            "    'loader': {'minibatch_size': 50, 'n_train': 150,\n"
            "               'n_valid': 50},\n"
            "    'decision': {'max_epochs': 1, 'fail_iterations': 5},\n"
            "    'layers': [\n"
            "        {'type': 'all2all_tanh', 'output_sample_shape': 8,\n"
            "         'learning_rate': Tune(0.001, 0.0005, 0.1),\n"
            "         'momentum': 0.9},\n"
            "        {'type': 'softmax', 'output_sample_shape': 10,\n"
            "         'learning_rate': 0.03, 'momentum': 0.9},\n"
            "    ],\n"
            "})\n")
    cfg = tmp_path / "tunes.py"
    cfg.write_text(text)
    jprng.reset()
    jprng.seed_all(1)
    jroot.__dict__.pop("mnist", None)
    exec(compile(text, str(cfg), "exec"), {"root": jroot, "Tune": JTune})
    want_fit, want_genes, _ = jgenetics.optimize_workflow(
        jmnist, generations=1, population=2, seed=1)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch", "veles_tpu_torch.samples.mnist",
         str(cfg), "-d", "cpu", "--random-seed", "1", "--optimize", "1:2:2"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert "best fitness: %s" % float(want_fit) in lines
    for path, value in want_genes.items():
        assert "  %s = %s" % (path, value) in lines

