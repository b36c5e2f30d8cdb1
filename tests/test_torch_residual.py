"""Residual (skip) connections in the port's fused chain against the JAX
package on the CPU: the forward's add, the hand-derived backward with
the stashed skip error (dense identity block, and a conv downsampling
block with a projected skip) against the reference's, every error the
reference raises, and ``cifar_resnet`` at the sample's topology with
narrow widths (stem 8, blocks 8 and 16; 200 train / 100 validation,
minibatch 50, 2 epochs, seed 5), then one train step from the
reference's state carried over.

Tolerances: initial weights bit-equal; each gradient's max gap within
``GRAD_SHARE`` of its largest reference element (measured 7.3e-7 for
the dense block, 1.2e-6 for the projection block: summation order over
sums of up to 8 x 32 x 32 terms); ``cifar_resnet`` validation ``n_err``
equal per epoch and weights within ``WEIGHT_ATOL`` (measured 1.9e-8);
one step from the same state within 1e-6 (measured 7.5e-9).  Torch is
pinned to one thread.
"""

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

from veles_tpu import prng as jax_prng
from veles_tpu.config import root as jax_root
from veles_tpu.samples import cifar_resnet as jax_resnet
from veles_tpu.samples import mnist as jax_mnist
from veles_tpu.samples.cifar import CifarLoader as JaxCifarLoader
from veles_tpu.standard_workflow import StandardWorkflow as JaxWorkflow
from veles_tpu_torch import prng
from veles_tpu_torch.compiled import load_fused_state, state_from_jax
from veles_tpu_torch.config import root
from veles_tpu_torch.ops.residual import Residual, ResidualProjection
from veles_tpu_torch.samples import cifar_resnet, mnist
from veles_tpu_torch.samples.cifar import CifarLoader
from veles_tpu_torch.standard_workflow import StandardWorkflow
from veles_tpu_torch.workflow import Workflow

#: measured 1.9e-8 after the 2 epochs; 50x for summation order
WEIGHT_ATOL = 1e-6
#: a gradient's max gap as a share of its largest element (measured
#: ≤ 1.2e-6)
GRAD_SHARE = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _seed(seed, *mods):
    for mod in mods:
        mod.reset()
        mod.seed_all(seed)


class _JaxConfig:
    def __init__(self, name, cfg):
        self.name, self.cfg = name, cfg

    def __enter__(self):
        self.saved = jax_root.__dict__.pop(self.name, None)
        getattr(jax_root, self.name).update(self.cfg)
        return self

    def __exit__(self, *exc):
        jax_root.__dict__.pop(self.name, None)
        if self.saved is not None:
            jax_root.__dict__[self.name] = self.saved
        jax_prng.reset()


def _mnist_cfg(skip=2):
    """784 -> 32 -> (dense 32 -> dense 32 -> +skip) -> softmax."""
    dense = lambda kind: {"type": kind, "output_sample_shape": 32,  # noqa
                          "learning_rate": 0.05, "momentum": 0.9}
    return {"loader": {"minibatch_size": 50, "n_train": 200, "n_valid": 100},
            "decision": {"max_epochs": 3, "fail_iterations": 10},
            "layers": [dense("all2all_tanh"), dense("all2all_tanh"),
                       dense("all2all"), {"type": "residual", "skip": skip},
                       {"type": "softmax", "output_sample_shape": 10,
                        "learning_rate": 0.05, "momentum": 0.9}]}


def _port_mnist(skip=2, fused=True):
    _seed(3, prng)
    root.__dict__.pop("mnist", None)
    root.mnist.update(_mnist_cfg(skip))
    return mnist.build(fused=fused)


def _jax_mnist(skip=2, fused=True):
    _seed(3, jax_prng)
    with _JaxConfig("mnist", _mnist_cfg(skip)):
        return jax_mnist.build(fused=fused)


def _batch(seed, shape, n=8):
    rs = numpy.random.RandomState(seed)
    return (rs.randn(n, *shape).astype(numpy.float32),
            rs.randint(0, 10, n).astype(numpy.int32),
            numpy.ones(n, numpy.float32))


def _grads_both(wf, ref, x, labels, mask):
    got, _ = wf._fused_runner._grads_and_metrics(
        wf._fused_runner.state, torch.as_tensor(x), torch.as_tensor(labels),
        torch.as_tensor(mask))
    runner = ref._fused_runner
    want, _ = jax.jit(runner._grads_and_metrics)(
        runner.state, jnp.asarray(x), jnp.asarray(labels),
        jnp.asarray(mask))
    return got, want


def _assert_grads(got, want):
    checked = 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None), i
        if g is None:
            continue
        for a, b in zip(g, w):
            assert (a is None) == (b is None), i
            if a is not None:
                b = numpy.asarray(b)
                gap = float(numpy.abs(a.numpy() - b).max())
                assert gap <= GRAD_SHARE * numpy.abs(b).max(), (i, gap)
        checked += 1
    return checked


def test_forward_adds_skip_source():
    wf = _port_mnist()
    wf.initialize(device="cpu")
    runner = wf._fused_runner
    x = torch.as_tensor(numpy.random.RandomState(0).randn(4, 784)
                        .astype(numpy.float32))
    acts, saved = runner._forward_chain(runner.state, x)
    # layer 3 is the residual with skip 2: output = input + acts[1]
    torch.testing.assert_close(acts[4], acts[3] + acts[1], rtol=0, atol=0)
    assert saved[3] is None


def test_dense_block_grads_match_jax():
    """The stashed skip error reaches layer 1 exactly as in the
    reference's backward walk."""
    ref = _jax_mnist()
    ref.initialize()
    wf = _port_mnist()
    wf.initialize(device="cpu")
    for f, r in zip(wf.forwards, ref.forwards):
        if f.has_params:
            numpy.testing.assert_array_equal(f.weights.mem,
                                             numpy.asarray(r.weights.mem))
    got, want = _grads_both(wf, ref, *_batch(1, (784,)))
    assert _assert_grads(got, want) == 4


def _proj_layers():
    conv = {"type": "conv_str", "n_kernels": 8, "kx": 3, "ky": 3,
            "padding": "SAME", "learning_rate": 0.02, "momentum": 0.9}
    return [dict(conv), dict(conv, sliding=2), dict(conv),
            {"type": "residual_proj", "skip": 2, "n_kernels": 8,
             "sliding": 2, "learning_rate": 0.02, "momentum": 0.9},
            {"type": "softmax", "output_sample_shape": 10,
             "learning_rate": 0.02, "momentum": 0.9}]


def _proj_workflow(cls, loader, **kw):
    return cls(None, name="resproj", loader_factory=loader,
               loader_config={"minibatch_size": 25, "n_train": 50,
                              "n_valid": 25},
               layers=_proj_layers(),
               decision_config={"max_epochs": 1, "fail_iterations": 5},
               loss_function="softmax", **kw)


def test_projection_block_grads_match_jax():
    """Downsampling block: conv(s=2) -> conv -> residual_proj(s=2).  The
    projection's weight gradient and the skip source's error come from
    one convolution backward."""
    _seed(9, jax_prng)
    ref = _proj_workflow(JaxWorkflow, JaxCifarLoader, fused=True)
    ref.initialize()
    jax_prng.reset()
    _seed(9, prng)
    wf = _proj_workflow(StandardWorkflow, CifarLoader, fused=True)
    wf.initialize(device="cpu")
    proj = wf.forwards[3]
    assert proj.weights.shape == (1, 1, 8, 8) and not proj.include_bias
    numpy.testing.assert_array_equal(proj.weights.mem,
                                     numpy.asarray(ref.forwards[3]
                                                   .weights.mem))
    got, want = _grads_both(wf, ref, *_batch(2, (32, 32, 3)))
    assert got[3][1] is None
    assert _assert_grads(got, want) == 5


def _resnet_cfg():
    lr = 0.02
    layers = [{"type": "conv_str", "n_kernels": 8, "kx": 5, "ky": 5,
               "padding": "SAME", "learning_rate": lr, "momentum": 0.9,
               "weights_filling": "gaussian", "weights_stddev": 0.05},
              {"type": "max_pooling", "kx": 2, "ky": 2},
              *cifar_resnet._block(8, lr), *cifar_resnet._down_block(16, lr),
              *cifar_resnet._block(16, lr),
              {"type": "avg_pooling", "kx": 2, "ky": 2},
              {"type": "softmax", "output_sample_shape": 10,
               "learning_rate": lr, "momentum": 0.9}]
    assert layers[2:-2] == (jax_resnet._block(8, lr)
                            + jax_resnet._down_block(16, lr)
                            + jax_resnet._block(16, lr))
    return {"loader": {"minibatch_size": 50, "n_train": 200,
                       "n_valid": 100},
            "decision": {"max_epochs": 2, "fail_iterations": 10},
            "layers": layers}


_RESNET = {}


def _resnet_trained():
    if not _RESNET:
        _seed(5, jax_prng)
        with _JaxConfig("cifar_resnet", _resnet_cfg()):
            ref = jax_resnet.train(fused=True)
            ref.snapshot_state()
        _seed(5, prng)
        root.__dict__.pop("cifar_resnet", None)
        root.cifar_resnet.update(_resnet_cfg())
        wf = cifar_resnet.train(fused=True, device="cpu")
        wf.snapshot_state()
        _RESNET.update(wf=wf, ref=ref)
    return _RESNET["wf"], _RESNET["ref"]


def test_cifar_resnet_tiny_matches_jax():
    wf, ref = _resnet_trained()
    kinds = [f.layer_type for f in wf.forwards]
    assert kinds.count("residual") == 2 and kinds.count("residual_proj") == 1
    got = wf.decision.epoch_metrics
    want = ref.decision.epoch_metrics
    assert len(got) == len(want) == 2
    for g, r in zip(got, want):
        assert g["validation"]["n_err"] == r["validation"]["n_err"]
        assert g["train"]["n_err"] == r["train"]["n_err"]
    for f, r in zip(wf.forwards, ref.forwards):
        if f.has_params:
            numpy.testing.assert_allclose(
                f.weights.mem, numpy.asarray(r.weights.mem), rtol=0,
                atol=WEIGHT_ATOL)


def test_state_from_jax_residual_net_one_step():
    """The reference's fused state of a residual net (empty entries for
    the residual and pooling layers, ``w``/``vw`` alone for the
    projection) carries over, and one train step from it agrees."""
    wf, ref = _resnet_trained()
    runner = ref._fused_runner
    state = [{k: numpy.asarray(v) for k, v in e.items()}
             for e in runner.state]
    kinds = [f.layer_type for f in wf.forwards]
    assert state[kinds.index("residual")] == {}
    assert sorted(state[kinds.index("residual_proj")]) == ["vw", "w"]
    load_fused_state(wf, state_from_jax(state, device="cpu"))
    x, labels, mask = _batch(4, (32, 32, 3), n=16)
    want, _ = runner._train(runner.state, jnp.asarray(x),
                            jnp.asarray(labels), jnp.asarray(mask),
                            jnp.asarray(16, jnp.int32), None,
                            jnp.asarray(0, jnp.int32))
    port = wf._fused_runner
    got, _ = port._train_step(port.state, torch.as_tensor(x),
                              torch.as_tensor(labels),
                              torch.as_tensor(mask), 16)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for name in g:
            numpy.testing.assert_allclose(g[name].numpy(),
                                          numpy.asarray(w[name]), rtol=0,
                                          atol=1e-6)
    bad = [dict(e) for e in state]
    bad[kinds.index("residual_proj")]["b"] = numpy.zeros(16, numpy.float32)
    with pytest.raises(ValueError, match="layer %d " % kinds.index(
            "residual_proj")):
        load_fused_state(wf, state_from_jax(bad, device="cpu"))


def _both_raise(port_call, jax_call, match):
    with pytest.raises(ValueError, match=match) as got:
        port_call()
    with pytest.raises(ValueError, match=match) as want:
        jax_call()
    assert str(got.value) == str(want.value)


def test_error_cases_match_reference():
    from veles_tpu.ops import residual as jax_residual
    from veles_tpu.workflow import Workflow as JaxBareWorkflow
    wf, jwf = Workflow(None), JaxBareWorkflow(None)
    _both_raise(lambda: Residual(wf, skip=0),
                lambda: jax_residual.Residual(jwf, skip=0), "skip must")
    _both_raise(lambda: ResidualProjection(wf, skip=0),
                lambda: jax_residual.ResidualProjection(jwf, skip=0),
                "skip must")
    _both_raise(lambda: ResidualProjection(wf, include_bias=True),
                lambda: jax_residual.ResidualProjection(
                    jwf, include_bias=True), "bias-free")
    for key in ("kx", "ky", "padding"):
        _both_raise(lambda: ResidualProjection(wf, **{key: 1}),
                    lambda: jax_residual.ResidualProjection(
                        jwf, **{key: 1}), key)
    # unit mode cannot route a skip edge
    _both_raise(lambda: _port_mnist(fused=False),
                lambda: _jax_mnist(fused=False), "fused")
    # a projection whose source lies before the chain input
    cfg = _mnist_cfg()
    cfg["layers"][3] = {"type": "residual_proj", "skip": 4}
    root.__dict__.pop("mnist", None)
    root.mnist.update(cfg)
    with _JaxConfig("mnist", cfg):
        _both_raise(lambda: mnist.build(), lambda: jax_mnist.build(),
                    "before the chain input")


def test_residual_errors_at_forward():
    """Unequal shapes, and a skip before the chain input, raise at the
    first forward (the reference's trace time) with its message."""
    x = numpy.zeros((4, 784), numpy.float32)
    for skip, match in ((3, "equal shapes"), (5, "before the chain input")):
        ref = _jax_mnist(skip)
        ref.initialize()
        wf = _port_mnist(skip)
        wf.initialize(device="cpu")
        runner = wf._fused_runner
        _both_raise(
            lambda: runner._forward_chain(runner.state, torch.as_tensor(x)),
            lambda: ref._fused_runner._forward_chain(
                ref._fused_runner.state, jnp.asarray(x)), match)


def test_lone_unit_paths_raise():
    wf = _port_mnist()
    wf.initialize(device="cpu")
    res = wf.forwards[3]
    with pytest.raises(RuntimeError, match="fused"):
        res.run()
    with pytest.raises(RuntimeError, match="activation list"):
        res.apply_fused(torch.zeros(2, 32), {})
