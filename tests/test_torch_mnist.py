"""The MNIST-FC slice of the port against the JAX package on the CPU, at
``tests/test_mnist.py``'s small size (hidden 64, 500 train / 200
validation, minibatch 100, 2 epochs, seed 42), plus the port's own
mirror of ``tests/test_mnist.py``.

Tolerances: the synthetic data and the initial weights are bit-equal
(one host PRNG stream feeds both); after training, validation ``n_err``
is equal and loss and every weight agree within 1e-5 absolute — the two
packages' CPU GEMMs sum in different orders (ROADMAP Queue 3 item 2) and
the JAX default update divides by the batch where the port's kernel
multiplies by its inverse (1 ulp per step), over 10 steps of O(0.1)
weights.
"""

import numpy
import pytest
import torch

from veles_tpu import prng as jax_prng
from veles_tpu.config import root as jax_root
from veles_tpu.samples import mnist as jax_mnist
from veles_tpu_torch import prng
from veles_tpu_torch.compiled import load_fused_state, state_from_jax
from veles_tpu_torch.config import root
from veles_tpu_torch.ops import hopper_kernels as HK
from veles_tpu_torch.samples import mnist

SEED = 42


def _configure(cfg_root, n_train=500, n_valid=200, max_epochs=2, hidden=64,
               lr=0.03, fail_iterations=50):
    cfg_root.mnist.update({
        "loader": {"minibatch_size": 100, "n_train": n_train,
                   "n_valid": n_valid},
        "decision": {"max_epochs": max_epochs,
                     "fail_iterations": fail_iterations},
        "layers": [
            {"type": "all2all_tanh", "output_sample_shape": hidden,
             "learning_rate": lr, "momentum": 0.9},
            {"type": "softmax", "output_sample_shape": 10,
             "learning_rate": lr, "momentum": 0.9},
        ],
    })


def _seed(*mods):
    for mod in mods:
        mod.reset()
        mod.seed_all(SEED)


@pytest.fixture(scope="module")
def jax_run():
    """The reference's trained workflow at the small size (its default,
    fused path); the reference's ``root.mnist`` is restored after."""
    saved = jax_root.__dict__.pop("mnist", None)
    try:
        _seed(jax_prng)
        _configure(jax_root)
        wf = jax_mnist.train(fused=True)
        wf.snapshot_state()
        yield wf
    finally:
        jax_root.__dict__.pop("mnist", None)
        if saved is not None:
            jax_root.__dict__["mnist"] = saved
        jax_prng.reset()


def _port_train(fused=True, **kw):
    _seed(prng)
    _configure(root, **kw)
    return mnist.train(fused=fused, device="cpu")


def test_data_and_initial_weights_bit_equal():
    _seed(prng, jax_prng)
    saved = jax_root.__dict__.pop("mnist", None)
    try:
        _configure(jax_root)
        ref = jax_mnist.build(fused=False)
        ref.initialize()
    finally:
        jax_root.__dict__.pop("mnist", None)
        if saved is not None:
            jax_root.__dict__["mnist"] = saved
    _configure(root)
    wf = mnist.build(fused=True)
    wf.initialize(device="cpu")
    numpy.testing.assert_array_equal(wf.loader.original_data.mem,
                                     numpy.asarray(ref.loader.original_data
                                                   .mem))
    numpy.testing.assert_array_equal(wf.loader.original_labels.mem,
                                     numpy.asarray(ref.loader
                                                   .original_labels.mem))
    for f, r in zip(wf.forwards, ref.forwards):
        numpy.testing.assert_array_equal(f.weights.mem,
                                         numpy.asarray(r.weights.mem))
        numpy.testing.assert_array_equal(f.bias.mem,
                                         numpy.asarray(r.bias.mem))
    # the same minibatch sequence: the loader plans match
    for (c1, i1, a1), (c2, i2, a2) in zip(wf.loader._order,
                                          ref.loader._order):
        assert (c1, a1) == (c2, a2)
        numpy.testing.assert_array_equal(i1, i2)
    jax_prng.reset()


def test_trained_port_matches_jax(jax_run):
    wf = _port_train()
    got = wf.decision.epoch_metrics
    ref = jax_run.decision.epoch_metrics
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        for set_name in ("validation", "train"):
            assert g[set_name]["n_err"] == r[set_name]["n_err"]
            assert abs(g[set_name]["loss"] - r[set_name]["loss"]) < 1e-5
            numpy.testing.assert_array_equal(g[set_name]["confusion"],
                                             r[set_name]["confusion"])
    for f, r in zip(wf.forwards, jax_run.forwards):
        numpy.testing.assert_allclose(f.weights.mem,
                                      numpy.asarray(r.weights.mem), rtol=0,
                                      atol=1e-5)
        numpy.testing.assert_allclose(f.bias.mem, numpy.asarray(r.bias.mem),
                                      rtol=0, atol=1e-5)


def _eval_valid(runner, loader, to_arrays):
    """n_err and loss_sum of ``runner``'s current state over the whole
    validation set as one batch."""
    begin, end = loader.class_offsets()[1]
    x, labels = to_arrays(numpy.asarray(loader.original_data.mem)[begin:end],
                          numpy.asarray(loader.original_labels
                                        .mem)[begin:end])
    mask = to_arrays(numpy.ones(end - begin, numpy.float32))[0]
    metrics = runner._eval_step(runner.state, x, labels, mask)
    return int(metrics["n_err"]), float(metrics["loss_sum"])


def test_state_from_jax_round_trip(jax_run):
    import jax.numpy as jnp
    ref_runner = jax_run._fused_runner
    ref = _eval_valid(ref_runner, jax_run.loader,
                      lambda *a: [jnp.asarray(x) for x in a])
    _seed(prng)
    _configure(root)
    wf = mnist.build(fused=True)
    wf.initialize(device="cpu")
    state = [{k: numpy.asarray(v) for k, v in e.items()}
             for e in ref_runner.state]
    load_fused_state(wf, state_from_jax(state, device="cpu"))
    got = _eval_valid(wf._fused_runner, wf.loader,
                      lambda *a: [torch.as_tensor(x) for x in a])
    assert got[0] == ref[0]
    assert abs(got[1] - ref[1]) <= 1e-5 * max(1.0, abs(ref[1]))
    numpy.testing.assert_array_equal(wf.forwards[0].weights.mem,
                                     state[0]["w"])


def test_fused_and_unit_mode_identical():
    finals, weights = [], []
    for fused in (True, False):
        HK.reset_launch_counts()
        wf = _port_train(fused=fused)
        finals.append(wf.decision.epoch_metrics[-1]["validation"])
        wf.snapshot_state()
        weights.append([numpy.array(f.weights.mem) for f in wf.forwards])
        # the CPU runs the plain version: no kernel launches counted
        assert HK.launch_counts()["fused_sgd_update"] == 0
    assert finals[0]["n_err"] == finals[1]["n_err"]
    assert abs(finals[0]["loss"] - finals[1]["loss"]) < 1e-5
    # FINAL WEIGHTS match exactly too — the last train minibatch is gated
    # by decision.complete in both modes
    for wa, wb in zip(*weights):
        numpy.testing.assert_array_equal(wa, wb)


def test_gd_skipped_on_validation_minibatches():
    _seed(prng)
    _configure(root, n_train=300, n_valid=200, max_epochs=1)
    wf = mnist.build(fused=False)
    wf.initialize(device="cpu")
    w_before = numpy.array(wf.forwards[0].weights.mem)
    wf.loader.run()
    for unit in (wf.forwards[0], wf.forwards[1], wf.evaluator, wf.decision):
        unit.run()
    assert bool(wf.decision.gd_skip)          # VALID minibatch -> no GD
    numpy.testing.assert_array_equal(w_before, wf.forwards[0].weights.mem)


def test_decision_fail_iterations_early_stop():
    _seed(prng)
    _configure(root, n_train=200, n_valid=100, max_epochs=50, hidden=16,
               lr=0.0, fail_iterations=2)
    wf = mnist.train(fused=True, device="cpu")
    assert len(wf.decision.epoch_metrics) <= 4


def test_snapshot_state_roundtrip_weights():
    wf = _port_train(n_train=300, n_valid=100, max_epochs=1)
    state = wf.snapshot_state()
    w_trained = numpy.array(wf.forwards[0].weights.mem)
    prng.reset()
    prng.seed_all(7)                          # different seed: other init
    wf2 = mnist.build(fused=True)
    wf2.initialize(device="cpu")
    wf2.load_snapshot_state(state)
    numpy.testing.assert_array_equal(w_trained, wf2.forwards[0].weights.mem)


def test_unported_options_raise():
    """Queue 2a items 1 (lr policies), 2 (grad_accum), 4 (the
    Snapshotter), 5 (the plotters) and 8 (loader sharding) are ported:
    those options build and run, and ``link_plotters`` builds the three
    standard plotters (``tests/test_torch_plotting.py`` runs them)."""
    _seed(prng)
    _configure(root, n_train=200, n_valid=100, max_epochs=1, hidden=16)
    accum = mnist.build(fused=True, grad_accum=2)
    accum.initialize(device="cpu")
    assert accum._fused_runner.grad_accum == 2
    policy = mnist.build(layers=[{"type": "softmax",
                                  "output_sample_shape": 10,
                                  "lr_policy": {"policy": "exp"}}])
    assert policy.gds[0]._live_lrs(1)[0] < policy.gds[0]._live_lrs(0)[0]
    snap = mnist.build(snapshotter_config={"prefix": "x"})
    assert snap.snapshotter.prefix == "x"
    plotters = mnist.build().link_plotters()
    assert [p.name for p in plotters] == ["plot_curve", "plot_confusion",
                                          "plot_weights"]
    assert mnist.build().loader.shard(1, 2)._shard == (1, 2)
    spmd = mnist.build().loader.shard_spmd(1, 2)
    assert spmd._spmd_shard == (1, 2)
    assert spmd.local_minibatch_size == spmd.max_minibatch_size // 2
