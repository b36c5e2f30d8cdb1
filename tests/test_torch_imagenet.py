"""The AlexNet slice of the port against the JAX package on the CPU:
``tiny_layers(n_classes=4)`` on 32×32 synthetic data (160 train / 64
validation, minibatch 32, 2 epochs, seed 3), fused and unit mode, with
the reference's LRN on its Pallas kernel (interpret mode) as the port's
runs on its kernel's plain version; plus the full-width AlexNet shape
test mirroring ``tests/test_imagenet.py``.

Tolerances: data, initial weights, dropout masks and crops are
bit-equal by construction (one host PRNG stream, one threefry);
validation ``n_err`` is equal per epoch, and weights agree within
``WEIGHT_ATOL`` after 2 epochs — the two packages' CPU convolutions and
GEMMs sum in different orders; one step from the same state agrees
within 1e-6.
"""

import numpy
import pytest
import torch

import jax.numpy as jnp

from veles_tpu import prng as jax_prng
from veles_tpu.config import root as jax_root
from veles_tpu.ops import functional as JF
from veles_tpu.samples import imagenet as jax_imagenet
from veles_tpu_torch import prng
from veles_tpu_torch.compiled import load_fused_state, state_from_jax
from veles_tpu_torch.config import root
from veles_tpu_torch.ops import hopper_kernels as HK
from veles_tpu_torch.samples import imagenet

SEED = 3
#: measured 4.5e-8 (fused) and 6.0e-8 (unit mode) after the 2 epochs;
#: the limit leaves ~17x for summation order, no more
WEIGHT_ATOL = 1e-6


def _configure(cfg_root, module, **loader):
    cfg_root.imagenet.update({
        "loader": dict({"minibatch_size": 32, "records_path": None,
                        "n_train": 160, "n_valid": 64,
                        "image_hw": (32, 32), "n_classes": 4}, **loader),
        "decision": {"max_epochs": 2, "fail_iterations": 10},
        "layers": module.tiny_layers(n_classes=4, crop=(28, 28), lr=0.02),
    })


def _seed(*mods):
    for mod in mods:
        mod.reset()
        mod.seed_all(SEED)


class _JaxImagenet:
    """The reference's ``root.imagenet`` for the block, its LRN on the
    Pallas kernel; both restored after."""

    def __enter__(self):
        self.saved = jax_root.__dict__.pop("imagenet", None)
        _configure(jax_root, jax_imagenet)
        JF.set_lrn_backend("pallas")
        return self

    def __exit__(self, *exc):
        JF.set_lrn_backend("xla")
        jax_root.__dict__.pop("imagenet", None)
        if self.saved is not None:
            jax_root.__dict__["imagenet"] = self.saved


def _port_build(fused=True):
    root.__dict__.pop("imagenet", None)
    _configure(root, imagenet)
    return imagenet.build(fused=fused)


_RUNS = {}


def _trained(fused):
    """(port workflow, reference workflow) trained from one seed, once
    per mode and module."""
    if fused not in _RUNS:
        _seed(jax_prng)
        with _JaxImagenet():
            ref = jax_imagenet.train(fused=fused)
            ref.snapshot_state()
        jax_prng.reset()
        _seed(prng)
        HK.reset_launch_counts()
        wf = _port_build(fused)
        wf.initialize(device="cpu")
        wf.run()
        wf.snapshot_state()
        _RUNS[fused] = (wf, ref, HK.launch_counts())
    return _RUNS[fused]


def test_initial_weights_bit_equal():
    _seed(prng, jax_prng)
    with _JaxImagenet():
        ref = jax_imagenet.build(fused=False)
        ref.initialize()
    wf = _port_build(False)
    wf.initialize(device="cpu")
    numpy.testing.assert_array_equal(
        wf.loader.original_data.mem, numpy.asarray(ref.loader.original_data
                                                   .mem))
    params = 0
    for f, r in zip(wf.forwards, ref.forwards):
        assert tuple(f.output.shape) == tuple(r.output.shape)
        if f.has_params:
            params += 1
            numpy.testing.assert_array_equal(f.weights.mem,
                                             numpy.asarray(r.weights.mem))
            numpy.testing.assert_array_equal(f.bias.mem,
                                             numpy.asarray(r.bias.mem))
    assert params == 4
    jax_prng.reset()


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unit"])
def test_trained_port_matches_jax(fused):
    wf, ref, launches = _trained(fused)
    got = wf.decision.epoch_metrics
    want = ref.decision.epoch_metrics
    assert len(got) == len(want) == 2
    for g, r in zip(got, want):
        assert g["validation"]["n_err"] == r["validation"]["n_err"]
        assert abs(g["validation"]["loss"] - r["validation"]["loss"]) < 1e-4
    for f, r in zip(wf.forwards, ref.forwards):
        if f.has_params:
            numpy.testing.assert_allclose(
                f.weights.mem, numpy.asarray(r.weights.mem), rtol=0,
                atol=WEIGHT_ATOL)
            numpy.testing.assert_allclose(
                f.bias.mem, numpy.asarray(r.bias.mem), rtol=0,
                atol=WEIGHT_ATOL)
    # the CPU runs the kernels' plain versions: nothing is launched
    assert all(n == 0 for n in launches.values())


def test_state_from_jax_one_step():
    """The reference's fused state carries over unchanged (HWIO conv
    weights included), and one train step from it agrees."""
    wf, ref, _ = _trained(True)
    ref_runner = ref._fused_runner
    state = [{k: numpy.asarray(v) for k, v in e.items()}
             for e in ref_runner.state]
    load_fused_state(wf, state_from_jax(state, device="cpu"))
    numpy.testing.assert_array_equal(wf.forwards[1].weights.mem,
                                     state[1]["w"])
    loader = wf.loader
    begin, end = loader.class_offsets()[2]
    x = numpy.asarray(loader.original_data.mem)[begin:begin + 32]
    labels = numpy.asarray(loader.original_labels.mem)[begin:begin + 32]
    mask = numpy.ones(32, numpy.float32)
    key = prng.PRNGKey(11)
    with _JaxImagenet():
        want, _ = ref_runner._train(
            ref_runner.state, jnp.asarray(x), jnp.asarray(labels),
            jnp.asarray(mask), jnp.asarray(32, jnp.int32),
            jnp.asarray(key), jnp.asarray(0, jnp.int32))
    runner = wf._fused_runner
    got, _ = runner._train_step(runner.state, torch.as_tensor(x),
                                torch.as_tensor(labels),
                                torch.as_tensor(mask), 32, key)
    for g, w in zip(got, want):
        for name in g:
            numpy.testing.assert_allclose(g[name].numpy(),
                                          numpy.asarray(w[name]), rtol=0,
                                          atol=1e-6)


def test_fused_chain_passes_residuals():
    """The fused chain hands each layer's residuals (the strict-ReLU
    z == 0 mask, LRN's d, the pool's argmax) from its forward to its GD
    itself: no unit keeps them, so another train forward before a
    backward cannot pair one pass's residuals with another's
    activations."""
    wf, _, _ = _trained(True)
    runner = wf._fused_runner
    x = torch.as_tensor(numpy.asarray(wf.loader.original_data.mem)[:32])
    acts, saved = runner._forward_chain(runner.state, x, prng.PRNGKey(11),
                                        train=True)
    kinds = [f.layer_type for f in wf.forwards]
    assert len(acts) == len(saved) + 1 == len(kinds) + 1
    assert [s is not None for s in saved] == [
        k in ("conv_str", "norm", "max_pooling") for k in kinds]
    assert all(f.saved is None for f in wf.forwards)


def test_full_alexnet_topology_builds():
    """The full-width 227×227 AlexNet graph at minibatch 4 (no JAX)."""
    _seed(prng)
    root.__dict__.pop("imagenet", None)
    root.imagenet.update({
        "loader": {"minibatch_size": 4, "records_path": None,
                   "n_train": 8, "n_valid": 4, "image_hw": (256, 256),
                   "n_classes": 1000},
        "decision": {"max_epochs": 1, "fail_iterations": 1},
        "layers": imagenet.alexnet_layers(),
    })
    wf = imagenet.build(fused=False)
    wf.initialize(device="cpu")
    shapes = [tuple(f.output.shape) for f in wf.forwards]
    assert shapes[0] == (4, 227, 227, 3)       # crop
    assert shapes[1] == (4, 55, 55, 96)        # conv1
    assert shapes[3] == (4, 27, 27, 96)        # pool1
    assert shapes[4] == (4, 27, 27, 256)       # conv2, SAME
    assert shapes[6] == (4, 13, 13, 256)       # pool2
    assert shapes[10] == (4, 6, 6, 256)        # pool5
    assert shapes[-1] == (4, 1000)             # softmax
    assert wf.forwards[-1].weights.shape == (4096, 1000)
    assert wf.forwards[12].weights.shape == (9216, 4096)


def test_unported_parts_raise(tmp_path):
    from veles_tpu_torch.standard_workflow import StandardWorkflow
    from veles_tpu_torch.workflow import Workflow
    # record files are ported (ImagenetRecordsLoader); loader sharding
    # is not, and a file that is not a record file is refused
    records = tmp_path / "set.rec"
    records.write_bytes(b"")
    loader = imagenet.make_loader(Workflow(None), records_path=str(records))
    assert isinstance(loader, imagenet.ImagenetRecordsLoader)
    with pytest.raises(NotImplementedError, match="Queue 2a, item 8"):
        loader.shard(0, 2)
    with pytest.raises(ValueError, match="not a record file"):
        loader.initialize(device="cpu")
    _seed(prng)
    with pytest.raises(NotImplementedError, match="Queue 2a, item 10"):
        StandardWorkflow(
            None, loader_factory=imagenet.make_loader,
            loader_config={"n_train": 8, "n_valid": 4},
            layers=[{"type": "stochastic_pooling", "kx": 2, "ky": 2},
                    {"type": "softmax", "output_sample_shape": 4}])
