"""The port's RBM against the JAX package on the CPU: the Bernoulli draw
(``HK.bernoulli``'s plain version, bit-equal to
``jax.random.bernoulli``), ``rbm_hidden``/``rbm_visible``, the CD-k step
with the reference's key flow, and the MNIST-RBM sample run from one
state (``trainer_state_from_jax`` / ``load_trainer_state``).

Tolerances: hidden and visible probabilities and the CD step within
1e-6 absolute (probabilities and parameters are O(1); XLA's and
PyTorch's fp32 products and sigmoids differ in the last place, ROADMAP
Queue 3 items 1-2), every hidden sample equal (a sample flips only where
the uniform lies between the two sides' p, ~1e-7 of draws, and these
tests make a few thousand).  The sample: parameters within 1e-5
(measured 8.8e-8), per-epoch ``recon_err`` within 1e-5 relative
(measured 1.8e-7), ``trainer.time`` equal.  Torch is pinned to one
thread.
"""

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

from veles_tpu import prng as jax_prng
from veles_tpu.config import root as jax_root
from veles_tpu.ops import functional as JF
from veles_tpu.samples import mnist_rbm as jax_mnist_rbm
from veles_tpu_torch import prng
from veles_tpu_torch.compiled import load_trainer_state, trainer_state_from_jax
from veles_tpu_torch.config import root
from veles_tpu_torch.ops import functional as F
from veles_tpu_torch.ops import hopper_kernels as HK
from veles_tpu_torch.samples import mnist_rbm

SEED = 3
ATOL = 1e-6
RTOL = 1e-5

#: the reference's convergence test config (tests/test_rbm.py:100) with a
#: validation set and a padded last train minibatch (30 live rows of 50)
SMALL = {"loader": {"minibatch_size": 50, "n_train": 230, "n_valid": 100},
         "trainer": {"n_hidden": 64, "learning_rate": 0.1, "cd_k": 1},
         "decision": {"max_epochs": 3, "fail_iterations": 20}}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.as_tensor(numpy.asarray(a))


def _probabilities(shape, kind, seed):
    p = numpy.random.RandomState(seed).rand(*shape).astype(numpy.float32)
    if kind == "exact_0_1":
        flat = p.reshape(-1)
        flat[::3] = 0.0
        flat[1::3] = 1.0
    return p


@pytest.mark.parametrize("kind", ["uniform", "exact_0_1"])
@pytest.mark.parametrize("shape", [(1,), (127,), (37, 29), (100, 256),
                                   (3, 5, 7)])
def test_bernoulli_bit_equal_to_jax(shape, kind):
    p = _probabilities(shape, kind, len(shape) * 10 + shape[0])
    key = prng.fold_in(prng.fold_in(prng.PRNGKey(SEED), 1), shape[0])
    got = HK.bernoulli(key, _t(p))
    want = numpy.asarray(jax.random.bernoulli(jnp.asarray(key),
                                              jnp.asarray(p)))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert numpy.array_equal(got.numpy(), want.astype(numpy.float32))
    if kind == "exact_0_1":
        flat = got.numpy().reshape(-1)
        assert not flat[::3].any() and flat[1::3].all()
    assert torch.equal(HK.bernoulli(key, _t(p)), got)
    assert HK.bernoulli.launches == 0


def test_bernoulli_takes_an_int_seed_and_rejects_bad_keys():
    p = _t(_probabilities((40,), "uniform", 0))
    want = numpy.asarray(jax.random.bernoulli(jax.random.PRNGKey(9),
                                              jnp.asarray(p.numpy())))
    assert numpy.array_equal(HK.bernoulli(9, p).numpy(), want)
    with pytest.raises(ValueError, match="two uint32 words"):
        HK.bernoulli(numpy.zeros(3, numpy.uint32), p)


def test_hidden_visible_match_reference():
    r = numpy.random.RandomState(1)
    v = r.rand(8, 12).astype(numpy.float32)
    w = (r.randn(12, 6) * 0.1).astype(numpy.float32)
    vb = r.randn(12).astype(numpy.float32)
    hb = r.randn(6).astype(numpy.float32)
    h = F.rbm_hidden(_t(v), _t(w), _t(hb))
    h_ref = JF.rbm_hidden(jnp.asarray(v), jnp.asarray(w), jnp.asarray(hb))
    numpy.testing.assert_allclose(h.numpy(), numpy.asarray(h_ref), rtol=0,
                                  atol=ATOL)
    v2 = F.rbm_visible(h, _t(w), _t(vb))
    v2_ref = JF.rbm_visible(h_ref, jnp.asarray(w), jnp.asarray(vb))
    numpy.testing.assert_allclose(v2.numpy(), numpy.asarray(v2_ref), rtol=0,
                                  atol=ATOL)


def _ref_samples(w, vb, hb, v0, rng, cd_k):
    """The reference's hidden samples of each Gibbs step."""
    w, vb, hb = map(jnp.asarray, (w, vb, hb))
    hk = JF.rbm_hidden(jnp.asarray(v0), w, hb)
    out = []
    for i in range(cd_k):
        s = jax.random.bernoulli(jax.random.fold_in(jnp.asarray(rng), i), hk)
        out.append(numpy.asarray(s).astype(numpy.float32))
        hk = JF.rbm_hidden(JF.rbm_visible(s.astype(jnp.float32), w, vb), w,
                           hb)
    return out


@pytest.mark.parametrize("cd_k,live", [(1, 40), (2, 40), (3, 17)])
def test_cd_step_matches_reference(cd_k, live, monkeypatch):
    r = numpy.random.RandomState(cd_k * 100 + live)
    w = (r.randn(30, 20) * 0.1).astype(numpy.float32)
    vb = (r.randn(30) * 0.1).astype(numpy.float32)
    hb = (r.randn(20) * 0.1).astype(numpy.float32)
    v0 = (r.rand(40, 30) > 0.5).astype(numpy.float32)
    mask = (numpy.arange(40) < live).astype(numpy.float32)
    rng = prng.fold_in(prng.PRNGKey(SEED), cd_k)
    drawn, inner = [], HK.bernoulli

    def recording(key, p):
        out = inner(key, p)
        drawn.append(out.numpy().copy())
        return out

    monkeypatch.setattr(HK, "bernoulli", recording)
    got = F.rbm_cd_step(_t(w), _t(vb), _t(hb), _t(v0), _t(mask), rng, 0.1,
                        cd_k)
    ref = JF.rbm_cd_step(jnp.asarray(w), jnp.asarray(vb), jnp.asarray(hb),
                         jnp.asarray(v0), jnp.asarray(mask),
                         jnp.asarray(rng), jnp.asarray(0.1, jnp.float32),
                         cd_k)
    assert len(drawn) == cd_k
    for mine, theirs in zip(drawn, _ref_samples(w, vb, hb, v0, rng, cd_k)):
        assert numpy.array_equal(mine, theirs)
    for a, b in zip(got[:3], ref[:3]):
        numpy.testing.assert_allclose(a.numpy(), numpy.asarray(b), rtol=0,
                                      atol=ATOL)
    numpy.testing.assert_allclose(float(got[3]["recon_sum"]),
                                  float(ref[3]["recon_sum"]), rtol=ATOL)


def test_masked_rows_do_not_move_params():
    r = numpy.random.RandomState(2)
    w = (r.randn(10, 4) * 0.1).astype(numpy.float32)
    v = r.rand(5, 10).astype(numpy.float32)
    nw, nvb, nhb, m = F.rbm_cd_step(_t(w), torch.zeros(10), torch.zeros(4),
                                    _t(v), torch.zeros(5), prng.PRNGKey(0),
                                    0.1)
    assert numpy.array_equal(nw.numpy(), w)
    assert not nvb.numpy().any() and not nhb.numpy().any()
    assert float(m["recon_sum"]) == 0.0


def _build_port(cfg, seed=SEED):
    prng.reset()
    prng.seed_all(seed)
    root.__dict__.pop("mnist_rbm", None)
    root.mnist_rbm.update(cfg)
    try:
        wf = mnist_rbm.build()
        wf.initialize(device="cpu")
    finally:
        root.__dict__.pop("mnist_rbm", None)
    return wf


def test_sample_matches_reference_from_one_state(monkeypatch):
    jax_prng.reset()
    jax_prng.seed_all(SEED)
    jax_root.__dict__.pop("mnist_rbm", None)
    jax_root.mnist_rbm.update(SMALL)
    try:
        ref = jax_mnist_rbm.build()
        ref.initialize()
        state = {k: numpy.asarray(getattr(ref.trainer, k).mem)
                 if k != "time" else ref.trainer.time
                 for k in ref.trainer.snapshot_attrs}
        ref.run()
    finally:
        jax_root.__dict__.pop("mnist_rbm", None)
    wf = _build_port(SMALL)
    load_trainer_state(wf.trainer, trainer_state_from_jax(state, "cpu"))
    draws, inner = [], HK.bernoulli

    def counting(key, p):
        draws.append(wf.loader.minibatch_class)
        return inner(key, p)

    monkeypatch.setattr(HK, "bernoulli", counting)
    wf.run()
    for name in ("train", "validation"):
        got = [m[name]["recon_err"] for m in wf.decision.epoch_metrics]
        want = [m[name]["recon_err"] for m in ref.decision.epoch_metrics]
        assert len(got) == 3
        numpy.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    for key in ("weights", "vbias", "hbias"):
        numpy.testing.assert_allclose(
            getattr(wf.trainer, key).mem,
            numpy.asarray(getattr(ref.trainer, key).mem), rtol=0,
            atol=RTOL)
    # 3 epochs x 5 train minibatches; validation draws nothing and leaves
    # the key stream alone
    assert wf.trainer.time == ref.trainer.time == 15
    assert draws == [2] * 2 * 15
    assert prng.get("rbm")._key_counter == 15
    assert wf.forward.output.shape == (50, 64)


def test_sample_defaults_have_no_validation_set():
    cfg = {"loader": {"n_train": 200}, "decision": {"max_epochs": 2}}
    wf = _build_port(cfg)
    assert wf.loader.class_lengths == [0, 0, 200]
    assert wf.trainer.weights.shape == (784, 256)
    wf.run()
    errs = [m["train"]["recon_err"] for m in wf.decision.epoch_metrics]
    assert list(wf.decision.epoch_metrics[-1]) == ["train"]
    assert wf.trainer.time == 4 and errs[-1] < errs[0]
