"""The port's learning-rate policies against the JAX package's on the CPU.

Each policy is evaluated at steps 0, 1, its boundary (the step where its
curve bends) and far out, by both packages from the same spec; the port
computes in fp32 scalars as the reference's ``jnp`` code does, and the
two agree within 1 ulp of fp32 (libm's ``powf``/``cosf`` against XLA's).
Then the policies inside training: a GD unit's ``_live_lrs`` equals the
reference's at every step, weight and bias policies are independent,
and the graph loop trains with a policy exactly as the epoch scan does
(the scan reads the same host values from its operand table).
"""

import numpy
import pytest
import torch

import jax.numpy as jnp

from veles_tpu.ops import lr_adjust as jax_lr
from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.launcher import Launcher
from veles_tpu_torch.ops import lr_adjust
from veles_tpu_torch.samples import mnist

#: (spec, steps to check: 0, 1, the boundary, far out)
POLICIES = [
    ({"policy": "fixed"}, (0, 1, 1000, 10 ** 6)),
    ({"policy": "exp", "gamma": 0.999}, (0, 1, 1000, 50000)),
    ({"policy": "exp", "gamma": 0.9}, (0, 1, 7, 300)),
    ({"policy": "step_exp", "gamma": 0.5, "step": 100}, (0, 1, 100, 2999)),
    ({"policy": "inv", "gamma": 0.0001, "power": 0.75},
     (0, 1, 10000, 10 ** 6)),
    ({"policy": "linear", "final": 0.001, "steps": 500},
     (0, 1, 250, 500, 10 ** 5)),
    ({"policy": "warmup_cosine", "warmup": 100, "steps": 1000,
      "final_scale": 0.1}, (0, 1, 99, 100, 101, 550, 1000, 5000)),
    ({"policy": "warmup_rsqrt", "warmup": 4000}, (0, 1, 3999, 4000, 10 ** 6)),
    ({"policy": "arbitrary", "points": [(0, 1.0), (100, 0.1), (1000, 0.01)]},
     (0, 1, 99, 100, 1000, 10 ** 6)),
    ({"policy": "arbitrary", "points": [(10.5, 0.5), (20.0, 0.25)]},
     (0, 10, 11, 20, 21)),
]


@pytest.fixture(autouse=True)
def _fresh_config():
    threads = torch.get_num_threads()
    yield
    torch.set_num_threads(threads)
    root.__dict__.pop("mnist", None)
    prng.reset()


def _ulps(a, b):
    a, b = numpy.float32(a), numpy.float32(b)
    if a == b:
        return 0.0
    return float(abs(a - b) / numpy.spacing(max(abs(a), abs(b))))


@pytest.mark.parametrize("spec,steps", POLICIES,
                         ids=lambda v: v.get("policy")
                         if isinstance(v, dict) else None)
@pytest.mark.parametrize("lr0", [0.03, 1.0])
def test_policy_matches_reference(spec, steps, lr0):
    ref = jax_lr.make_policy(dict(spec))
    got = lr_adjust.make_policy(dict(spec))
    for t in steps:
        want = numpy.float32(ref(lr0, jnp.asarray(t, jnp.int32)))
        have = got(lr0, t)
        assert isinstance(have, numpy.float32)
        assert _ulps(have, want) <= 1.0, (spec, t, have, want)


def test_unknown_policy_and_bad_warmup_raise():
    with pytest.raises(ValueError, match="unknown lr policy"):
        lr_adjust.make_policy({"policy": "cubic"})
    with pytest.raises(ValueError, match="warmup"):
        lr_adjust.make_policy({"policy": "warmup_cosine", "warmup": 10,
                               "steps": 10})
    fn = lambda lr0, t: lr0 / (t + 1)  # noqa: E731
    assert lr_adjust.make_policy(fn) is fn
    assert lr_adjust.make_policy(None) is None


def _configure(layers, max_epochs=2):
    root.__dict__.pop("mnist", None)
    root.mnist.update({
        "loader": {"minibatch_size": 50, "n_train": 230, "n_valid": 70},
        "decision": {"max_epochs": max_epochs, "fail_iterations": 50},
        "layers": layers})


POLICY_LAYERS = [
    {"type": "all2all_tanh", "output_sample_shape": 16,
     "learning_rate": 0.05, "momentum": 0.9,
     "lr_policy": {"policy": "exp", "gamma": 0.97}},
    {"type": "softmax", "output_sample_shape": 10, "learning_rate": 0.05,
     "learning_rate_bias": 0.02, "momentum": 0.9,
     "lr_policy": {"policy": "inv", "gamma": 0.01},
     "bias_lr_policy": {"policy": "step_exp", "gamma": 0.5, "step": 3}},
]


def test_live_lrs_match_reference():
    from veles_tpu import prng as jax_prng
    from veles_tpu.config import root as jax_root
    from veles_tpu.samples import mnist as jax_mnist
    prng.reset()
    _configure(POLICY_LAYERS)
    port = mnist.build(fused=True)
    saved = jax_root.__dict__.pop("mnist", None)
    try:
        jax_root.mnist.update(root.mnist.as_dict())
        ref = jax_mnist.build(fused=True)
    finally:
        jax_root.__dict__.pop("mnist", None)
        if saved is not None:
            jax_root.__dict__["mnist"] = saved
        jax_prng.reset()
    for gd, rgd in zip(port.gds, ref.gds):
        for t in (0, 1, 2, 3, 4, 17, 500):
            have = gd._live_lrs(t)
            want = rgd._live_lrs(jnp.asarray(t, jnp.int32))
            for h, w in zip(have, want):
                assert _ulps(h, w) <= 1.0, (gd.name, t, h, w)
    # the bias policy is the bias's own; unset, it follows the weights'
    lr_w, lr_b = port.gds[1]._live_lrs(3)
    assert lr_b == numpy.float32(0.02) * numpy.float32(0.5)
    assert port.gds[0]._live_lrs(2)[1] == port.gds[0]._live_lrs(2)[0]


def test_learning_rate_adjust_applies_to_gds():
    prng.reset()
    _configure(POLICY_LAYERS[:1] + [
        {"type": "softmax", "output_sample_shape": 10,
         "learning_rate": 0.05}])
    wf = mnist.build(fused=True)
    lr_adjust.LearningRateAdjust({"policy": "step_exp", "gamma": 0.1,
                                  "step": 2}).apply_to(wf.gds)
    for gd in wf.gds:
        assert gd._live_lrs(1) == (numpy.float32(gd.learning_rate),) * 2
        assert gd._live_lrs(2)[0] == numpy.float32(
            gd.learning_rate) * numpy.float32(0.1)


def _trained(scan):
    torch.set_num_threads(1)
    prng.reset()
    prng.seed_all(5)
    _configure(POLICY_LAYERS, max_epochs=3)
    wf = mnist.build(fused=True)
    Launcher(wf, stats=False, epoch_scan=scan, device="cpu").boot()
    return wf


def test_policy_training_same_in_loop_and_scan():
    """A policy's step is the global train step in both drivers: the
    graph loop's FusedStep counter and the scan's operand rows."""
    loop, scan = _trained(0), _trained(1)
    assert loop.fused_step.train_steps == scan.fused_step.train_steps == 15
    for a, b in zip(loop.forwards, scan.forwards):
        numpy.testing.assert_array_equal(a.weights.mem, b.weights.mem)
        numpy.testing.assert_array_equal(a.bias.mem, b.bias.mem)
    # and the policy moved the training: a fixed rate ends elsewhere
    prng.reset()
    prng.seed_all(5)
    _configure([dict(layer, lr_policy=None, bias_lr_policy=None)
                for layer in POLICY_LAYERS], max_epochs=3)
    fixed = mnist.train(fused=True, device="cpu")
    assert not numpy.array_equal(fixed.forwards[0].weights.mem,
                                 loop.forwards[0].weights.mem)
