"""The port's ``ensemble`` against ``veles_tpu.ensemble``.

``tests/test_genetics.py``'s ensemble config (MNIST-FC at 300 / 100
rows, 16 hidden, 2 epochs; the PRNG streams seeded alike in both
packages), two members (seeds 5, 6) through both: each member's
weights within 1e-5 of the reference's (two frameworks' reduction
orders over two epochs), member and combined validation ``n_err``
equal; the port's members trained in two workers and restored from
their snapshots bit-equal to its sequential ones (``device="cpu"``).
"""

import numpy
import pytest
import torch

from veles_tpu import ensemble as jensemble
from veles_tpu import prng as jprng
from veles_tpu.config import root as jroot
from veles_tpu.samples import mnist as jmnist
from veles_tpu_torch import ensemble, prng
from veles_tpu_torch.config import root
from veles_tpu_torch.samples import mnist

WEIGHT_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU products run fastest single-threaded; the workers take
    the parent's count with its other process-wide settings."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
    for tree in (root, jroot):
        tree.__dict__.pop("mnist", None)


def _configure(package_prng, tree):
    package_prng.reset()
    package_prng.seed_all(1)
    tree.__dict__.pop("mnist", None)
    tree.mnist.update({
        "loader": {"minibatch_size": 50, "n_train": 300, "n_valid": 100},
        "decision": {"max_epochs": 2, "fail_iterations": 5},
        "layers": [
            {"type": "all2all_tanh", "output_sample_shape": 16,
             "learning_rate": 0.03, "momentum": 0.9},
            {"type": "softmax", "output_sample_shape": 10,
             "learning_rate": 0.03, "momentum": 0.9},
        ],
    })


def _weights(wf):
    return [numpy.asarray(v.mem) for f in wf.forwards
            for v in (f.weights, f.bias)]


def test_ensemble_equals_reference_and_workers():
    """Two members (seeds 5, 6) of ``tests/test_genetics.py``'s ensemble
    config: weights within 1e-5 of the reference's, member and ensemble
    ``n_err`` equal; members trained in two workers and restored from
    their snapshots bit-equal to the sequential ones."""
    _configure(jprng, jroot)
    want, want_combined = jensemble.train_ensemble(jmnist, size=2,
                                                   base_seed=5)
    runs = []
    for workers in (0, 2):
        _configure(prng, root)
        runs.append(ensemble.train_ensemble(mnist, size=2, base_seed=5,
                                            workers=workers, device="cpu"))
    (seq, seq_combined), (par, par_combined) = runs
    assert seq_combined == want_combined
    for (_, got, summary), (_, ref, ref_summary) in zip(seq.members,
                                                        want.members):
        assert summary == ref_summary
        for a, b in zip(_weights(got), _weights(ref)):
            numpy.testing.assert_allclose(a, b, rtol=0, atol=WEIGHT_ATOL)
    assert par_combined == seq_combined
    for (_, a, summary_a), (_, b, summary_b) in zip(seq.members,
                                                    par.members):
        assert summary_a == summary_b
        for wa, wb in zip(_weights(a), _weights(b)):
            numpy.testing.assert_array_equal(wa, wb)
