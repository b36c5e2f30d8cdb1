"""The port's Kohonen SOM against the JAX package on the CPU: the
functions (``kohonen_distances``, ``kohonen_winners``,
``kohonen_update``) on the same numpy inputs, the trainer's state carried
across (``trainer_state_from_jax`` / ``load_trainer_state``), and the
Kohonen sample at the reference test's small config run from one state.

Tolerances: distances and updates within 1e-5 of the largest reference
element (measured ~1e-7: XLA's and PyTorch's fp32 products sum the
cross term in other orders, ROADMAP Queue 3 item 2).  Winners are equal;
a winner may differ only where the reference's two distances are within
1e-6 of each other (a near tie that those last-place differences can
tip), and such a row is counted in the test's ``near_ties`` property.
The sample: the synthetic cloud bit-equal, the codebook within 1e-5
(measured 1.2e-7), per-epoch ``qerr`` within 1e-5 relative (measured
1.9e-7), ``hits`` and ``trainer.time`` equal.  Torch is pinned to one
thread.
"""

import numpy
import pytest
import torch

import jax.numpy as jnp

from veles_tpu import prng as jax_prng
from veles_tpu.config import root as jax_root
from veles_tpu.ops import functional as JF
from veles_tpu.ops.kohonen import grid_coords as jax_grid_coords
from veles_tpu.samples import kohonen as jax_kohonen
from veles_tpu_torch import prng
from veles_tpu_torch.compiled import load_trainer_state, trainer_state_from_jax
from veles_tpu_torch.config import root
from veles_tpu_torch.ops import functional as F
from veles_tpu_torch.ops.kohonen import grid_coords
from veles_tpu_torch.samples import kohonen

SEED = 3
RTOL = 1e-5
TIE = 1e-6

#: the reference's convergence test config (tests/test_kohonen.py:52),
#: with a train set that is not a whole number of minibatches so the last
#: minibatch is padded (30 live rows of 50)
SMALL = {"loader": {"minibatch_size": 50, "n_train": 480},
         "trainer": {"shape": (6, 6), "learning_rate": 0.3,
                     "decay_steps": 100},
         "decision": {"max_epochs": 5, "fail_iterations": 20}}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.as_tensor(numpy.asarray(a))


def _close(got, want, rtol=RTOL):
    want = numpy.asarray(want)
    scale = max(float(numpy.abs(want).max()), 1e-30)
    assert float(numpy.abs(numpy.asarray(got) - want).max()) <= rtol * scale


def _check_winners(got, want, d_ref, record_property):
    """Winners equal but at near ties of the reference's distances."""
    got, want = numpy.asarray(got), numpy.asarray(want)
    rows = numpy.nonzero(got != want)[0]
    for b in rows:
        assert abs(d_ref[b, got[b]] - d_ref[b, want[b]]) <= TIE, b
    record_property("near_ties", len(rows))


@pytest.mark.parametrize("mb,n_in,shape", [(16, 4, (3, 3)), (100, 2, (8, 8)),
                                           (33, 7, (4, 5))])
def test_distances_and_winners_match_reference(mb, n_in, shape,
                                               record_property):
    rng = numpy.random.RandomState(mb + n_in)
    x = rng.randn(mb, n_in).astype(numpy.float32)
    w = rng.randn(shape[0] * shape[1], n_in).astype(numpy.float32)
    d_ref = numpy.asarray(JF.kohonen_distances(jnp.asarray(x),
                                               jnp.asarray(w)))
    _close(F.kohonen_distances(_t(x), _t(w)), d_ref)
    win, dmin = F.kohonen_winners(_t(x), _t(w))
    win_ref, dmin_ref = JF.kohonen_winners(jnp.asarray(x), jnp.asarray(w))
    _check_winners(win, win_ref, d_ref, record_property)
    _close(dmin, dmin_ref)


@pytest.mark.parametrize("live", [100, 63, 1])
def test_update_matches_reference(live, record_property):
    rng = numpy.random.RandomState(live)
    x = rng.randn(100, 2).astype(numpy.float32)
    w = (rng.rand(64, 2).astype(numpy.float32) - 0.5) * 0.2
    mask = (numpy.arange(100) < live).astype(numpy.float32)
    grid = grid_coords(8, 8)
    assert numpy.array_equal(grid, jax_grid_coords(8, 8))
    lr, sigma = numpy.float32(0.2 / 1.3), numpy.float32(4.0 / 1.3)
    new_w, metrics = F.kohonen_update(_t(w), _t(x), _t(mask), _t(grid),
                                      float(lr), float(sigma))
    ref_w, ref_m = JF.kohonen_update(
        jnp.asarray(w), jnp.asarray(x), jnp.asarray(mask),
        jnp.asarray(grid), jnp.asarray(lr), jnp.asarray(sigma))
    _close(new_w, ref_w)
    _close(metrics["qe_sum"], ref_m["qe_sum"])
    assert isinstance(metrics["qe_sum"], torch.Tensor)
    d_ref = numpy.asarray(JF.kohonen_distances(jnp.asarray(x),
                                               jnp.asarray(w)))
    win, _ = F.kohonen_winners(_t(x), _t(w))
    _check_winners(win, d_ref.argmin(1), d_ref, record_property)


def test_update_pulls_winner_toward_sample():
    w = numpy.zeros((4, 2), numpy.float32)
    w[3] = [0.9, 0.9]
    x = numpy.array([[1.0, 1.0]], numpy.float32)
    new_w, metrics = F.kohonen_update(_t(w), _t(x), torch.ones(1),
                                      _t(grid_coords(2, 2)), 0.5, 0.5)
    new_w = new_w.numpy()
    numpy.testing.assert_allclose(new_w[3], [0.95, 0.95], atol=1e-5)
    assert abs(new_w[0]).max() < 0.05
    assert float(metrics["qe_sum"]) > 0


def test_masked_samples_do_not_update():
    rng = numpy.random.RandomState(2)
    w = rng.randn(4, 2).astype(numpy.float32)
    x = rng.randn(3, 2).astype(numpy.float32)
    new_w, metrics = F.kohonen_update(_t(w), _t(x), torch.zeros(3),
                                      _t(grid_coords(2, 2)), 0.5, 1.0)
    assert numpy.array_equal(new_w.numpy(), w)
    assert float(metrics["qe_sum"]) == 0.0


def _train_both(cfg, seed=SEED):
    """(port workflow, reference workflow) at ``cfg``, the port loaded
    with the reference trainer's initial state."""
    jax_prng.reset()
    jax_prng.seed_all(seed)
    jax_root.__dict__.pop("kohonen", None)
    jax_root.kohonen.update(cfg)
    try:
        ref = jax_kohonen.build()
        ref.initialize()
        state = {k: numpy.asarray(getattr(ref.trainer, k).mem)
                 if k != "time" else ref.trainer.time
                 for k in ref.trainer.snapshot_attrs}
        ref.run()
    finally:
        jax_root.__dict__.pop("kohonen", None)
    prng.reset()
    prng.seed_all(seed)
    root.__dict__.pop("kohonen", None)
    root.kohonen.update(cfg)
    try:
        wf = kohonen.build()
        wf.initialize(device="cpu")
    finally:
        root.__dict__.pop("kohonen", None)
    load_trainer_state(wf.trainer, trainer_state_from_jax(state, "cpu"))
    wf.run()
    return wf, ref


def test_sample_matches_reference_from_one_state():
    wf, ref = _train_both(SMALL)
    assert numpy.array_equal(wf.loader.original_data.mem,
                             numpy.asarray(ref.loader.original_data.mem))
    got = [m["train"]["qerr"] for m in wf.decision.epoch_metrics]
    want = [m["train"]["qerr"] for m in ref.decision.epoch_metrics]
    assert len(got) == 5
    numpy.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    assert got[-1] < got[0]
    _close(wf.trainer.weights.mem, ref.trainer.weights.mem)
    assert wf.trainer.time == ref.trainer.time == 5 * 10
    # the forward ran once, at completion, on the last (padded) minibatch:
    # its live rows only
    assert wf.forward.hits.sum() == 30
    assert numpy.array_equal(wf.forward.hits, ref.forward.hits)
    assert wf.forward.output.mem.dtype == numpy.int32


def test_eval_only_freezes_codebook():
    prng.reset()
    prng.seed_all(SEED)
    root.__dict__.pop("kohonen", None)
    kohonen.default_config()
    root.kohonen.update({
        "loader": {"minibatch_size": 50, "n_train": 100},
        "decision": {"max_epochs": 1, "fail_iterations": 5}})
    try:
        wf = kohonen.build()
        wf.initialize(device="cpu")
    finally:
        root.__dict__.pop("kohonen", None)
    wf.eval_only = True
    before = numpy.array(wf.trainer.weights.mem)
    wf.loader.run()
    assert wf.loader.minibatch_class == 2
    wf.trainer.run()
    assert numpy.array_equal(before, wf.trainer.weights.mem)
    assert wf.trainer.time == 0
    assert float(wf.trainer.metrics["qe_sum"]) > 0


def test_trainer_state_refuses_wrong_keys_and_shapes():
    prng.reset()
    root.__dict__.pop("kohonen", None)
    root.kohonen.update(SMALL)
    try:
        wf = kohonen.build()
        wf.initialize(device="cpu")
    finally:
        root.__dict__.pop("kohonen", None)
    before = wf.trainer.weights.mem.copy()
    good = {"weights": numpy.zeros((36, 2), numpy.float32), "time": 7}
    for bad in ({"weights": good["weights"]},
                dict(good, vbias=numpy.zeros(2, numpy.float32)),
                dict(good, weights=numpy.zeros((36, 3), numpy.float32))):
        with pytest.raises(ValueError):
            load_trainer_state(wf.trainer, trainer_state_from_jax(bad, "cpu"))
    assert numpy.array_equal(before, wf.trainer.weights.mem)
    load_trainer_state(wf.trainer, trainer_state_from_jax(good, "cpu"))
    assert wf.trainer.time == 7 and not wf.trainer.weights.mem.any()
