"""The port's stochastic pooling (``ops/functional.py::stochastic_pooling``
and the ``stochastic_pooling`` / ``stochastic_abs_pooling`` layers)
against the reference's ``veles_tpu/ops/functional.py`` on the CPU.

Both sides take the same seeded input and the same threefry key.  The
port draws jax's ``gumbel(rng, probs.shape)`` from the threefry bits of
the flat counters (within ``GUMBEL_ATOL`` = 4e-6 of jax's, PR 23's
bound), so a window whose two best scores log(max(p, 1e-30)) + gumbel
lie within ``TIE`` = 1e-5 may pick the other position: such windows are
counted (the ``near_ties`` junit property) and every other window's
output and position are held EQUAL.  Eval (the probability-weighted sum)
is within 1e-6; the backward (the gradient routed to the drawn position,
summed where windows overlap) equals ``jax.vjp`` of the reference within
1e-6 with the near-tie windows' gradients set to 0 on both sides.  A
data-parallel ``RowShard`` key draws, on each of two ranks, exactly its
rows of the one-process draw.  A tiny CIFAR workflow with the layer
trains two steps in fused and in unit mode, as the reference's does.
One planted fault (the gumbel added to p instead of log p) is caught.
"""

import inspect
import textwrap

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

from veles_tpu import prng as jax_prng
from veles_tpu.config import root as jax_root
from veles_tpu.ops import functional as JF
from veles_tpu.samples import cifar as jax_cifar
from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.ops import functional as F
from veles_tpu_torch.samples import cifar

#: two scores closer than this may swap under the gumbel's 4e-6 error
#: plus a few float32 ulps of log(p) at |score| < 16
TIE = 1e-5
#: (window, stride, input shape): non-overlapping with a ceil-padded
#: tail, and overlapping 3x3/2 windows
CASES = [((2, 2), (2, 2), (4, 9, 7, 5)), ((3, 3), (2, 2), (3, 10, 9, 4))]
SEED = 42


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _input(shape, seed=28):
    """Seeded values with whole windows zero and whole windows negative
    (the relu flavour's all-zero weights: uniform probabilities)."""
    x = numpy.random.RandomState(seed).randn(*shape).astype(numpy.float32)
    x[0, :4, :4, :] = 0.0
    x[1, :4, :4, :] = -numpy.abs(x[1, :4, :4, :]) - 0.1
    return x


def _reference_scores(x, window, stride, key, use_abs):
    """The reference's patches and per-position scores
    log(max(p, 1e-30)) + gumbel, as numpy (b, oh, ow, k, c)."""
    patches, _, _ = JF._pool_patches(jnp.asarray(x), window, stride, 0.0)
    weights = jnp.abs(patches) if use_abs else jnp.maximum(patches, 0.0)
    total = weights.sum(axis=3, keepdims=True)
    k = patches.shape[3]
    probs = jnp.where(total > 0, weights / jnp.maximum(total, 1e-30),
                      1.0 / k)
    gumbel = jax.random.gumbel(key, probs.shape, probs.dtype)
    return (numpy.asarray(patches),
            numpy.asarray(jnp.log(jnp.maximum(probs, 1e-30)) + gumbel))


def _near_ties(scores):
    top = numpy.sort(scores, axis=3)
    return (top[:, :, :, -1, :] - top[:, :, :, -2, :]) < TIE


def _compare_train(x, window, stride, seed, use_abs, func=None):
    """(port output, port idx, reference output, reference idx, near-tie
    mask (b, oh, ow, c))."""
    key = jax.random.PRNGKey(seed)
    want = numpy.asarray(JF.stochastic_pooling(
        jnp.asarray(x), window, stride, key, True, use_abs))
    patches, scores = _reference_scores(x, window, stride, key, use_abs)
    got, idx = (func or F.stochastic_pooling)(
        torch.from_numpy(x), window, stride, prng.PRNGKey(seed), True,
        use_abs)
    return (got.numpy(), idx[:, :, :, 0, :].numpy(), want,
            scores.argmax(axis=3), _near_ties(scores), patches)


@pytest.mark.parametrize("use_abs", [False, True], ids=["relu", "abs"])
@pytest.mark.parametrize("window,stride,shape", CASES,
                         ids=["2x2s2", "3x3s2"])
def test_training_draw_equals_the_reference(window, stride, shape, use_abs,
                                            record_property):
    ties = 0
    for seed in range(4):
        x = _input(shape, seed)
        got, idx, want, want_idx, near, patches = _compare_train(
            x, window, stride, seed, use_abs)
        ties += int(near.sum())
        assert got.shape == want.shape
        far = ~near
        numpy.testing.assert_array_equal(idx[far], want_idx[far])
        numpy.testing.assert_array_equal(got[far], want[far])
        # a near tie still takes one of its window's own values
        chosen = numpy.take_along_axis(patches, idx[:, :, :, None, :],
                                       axis=3)[:, :, :, 0, :]
        numpy.testing.assert_array_equal(got, chosen)
    record_property("near_ties", ties)


@pytest.mark.parametrize("use_abs", [False, True], ids=["relu", "abs"])
@pytest.mark.parametrize("window,stride,shape", CASES,
                         ids=["2x2s2", "3x3s2"])
def test_eval_is_the_weighted_sum_within_1e6(window, stride, shape,
                                             use_abs):
    x = _input(shape)
    want = numpy.asarray(JF.stochastic_pooling(
        jnp.asarray(x), window, stride, None, False, use_abs))
    got, idx = F.stochastic_pooling(torch.from_numpy(x), window, stride,
                                    None, False, use_abs)
    assert idx is None
    numpy.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_all_zero_windows_are_uniform():
    """Windows whose weights are all zero (zeros; negatives for relu)
    draw from a uniform distribution: eval is the window's mean, and in
    training the position is the gumbel's argmax alone."""
    window, stride, shape = CASES[0]
    x = _input(shape)
    got, _ = F.stochastic_pooling(torch.from_numpy(x), window, stride,
                                  None, False, False)
    neg = x[1, :4, :4, :].reshape(2, 2, 2, 2, -1).mean(axis=(1, 3))
    numpy.testing.assert_allclose(got.numpy()[1, :2, :2, :], neg,
                                  rtol=0, atol=1e-6)
    assert (got.numpy()[0, :2, :2, :] == 0.0).all()
    key = jax.random.PRNGKey(3)
    patches, _ = _reference_scores(x, window, stride, key, False)
    gumbel = numpy.asarray(jax.random.gumbel(key, patches.shape))
    _, idx = F.stochastic_pooling(torch.from_numpy(x), window, stride,
                                  prng.PRNGKey(3), True, False)
    idx = idx[:, :, :, 0, :].numpy()
    assert (idx[:2, :2, :2, :] == gumbel[:2, :2, :2].argmax(axis=3)).all()
    # every position of a uniform window is drawn somewhere
    assert set(idx[:2, :2, :2, :].ravel()) == {0, 1, 2, 3}


@pytest.mark.parametrize("use_abs", [False, True], ids=["relu", "abs"])
@pytest.mark.parametrize("window,stride,shape", CASES,
                         ids=["2x2s2", "3x3s2"])
def test_backward_equals_the_reference_vjp(window, stride, shape, use_abs):
    x = _input(shape, 5)
    key = jax.random.PRNGKey(5)
    _, idx = F.stochastic_pooling(torch.from_numpy(x), window, stride,
                                  prng.PRNGKey(5), True, use_abs)
    _, scores = _reference_scores(x, window, stride, key, use_abs)
    err = numpy.random.RandomState(6).randn(
        *idx[:, :, :, 0, :].shape).astype(numpy.float32)
    err[_near_ties(scores)] = 0.0
    _, vjp = jax.vjp(lambda a: JF.stochastic_pooling(
        a, window, stride, key, True, use_abs), jnp.asarray(x))
    want = numpy.asarray(vjp(jnp.asarray(err))[0])
    got = F.stochastic_pooling_backward(torch.from_numpy(x),
                                        torch.from_numpy(err), idx, window,
                                        stride)
    assert got.shape == x.shape
    numpy.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("use_abs", [False, True], ids=["relu", "abs"])
def test_row_shard_draws_the_ranks_rows_of_the_global_draw(use_abs):
    window, stride, _ = CASES[1]
    x = _input((6, 10, 9, 4))
    key = prng.PRNGKey(9)
    whole, whole_idx = F.stochastic_pooling(torch.from_numpy(x), window,
                                            stride, key, True, use_abs)
    rows = x.shape[0] // 2
    for rank in range(2):
        part = torch.from_numpy(x[rank * rows:(rank + 1) * rows])
        got, idx = F.stochastic_pooling(part, window, stride,
                                        F.RowShard((key, rank, 2)), True,
                                        use_abs)
        assert torch.equal(got, whole[rank * rows:(rank + 1) * rows])
        assert torch.equal(idx, whole_idx[rank * rows:(rank + 1) * rows])
    # a rank's draw is not the one-process draw of its own rows
    alone, _ = F.stochastic_pooling(torch.from_numpy(x[rows:]), window,
                                    stride, key, True, use_abs)
    assert not torch.equal(alone, whole[rows:])


def test_key_held_in_a_tensor_draws_the_host_keys_bits():
    """A key held as two int32 words in a tensor (on the card, the
    captured epoch scan's, never read on the host) draws what the host
    key draws, a word past 2**31 included."""
    window, stride, shape = CASES[0]
    x = torch.from_numpy(_input(shape))
    key = prng.PRNGKey(2 ** 31 + 17)
    key[0] = 0x9E3779B9
    want, want_idx = F.stochastic_pooling(x, window, stride, key, True,
                                          True)
    words = torch.from_numpy(key.view(numpy.int32).copy())
    assert words.dtype == torch.int32 and int(words[0]) < 0
    got, idx = F.stochastic_pooling(x, window, stride, words, True, True)
    assert torch.equal(got, want) and torch.equal(idx, want_idx)


CIFAR_STOCHASTIC = {
    "loader": {"minibatch_size": 8, "n_train": 16, "n_valid": 8},
    "decision": {"max_epochs": 1, "fail_iterations": 50},
    "layers": [
        {"type": "conv_str", "n_kernels": 4, "kx": 3, "ky": 3,
         "padding": "SAME", "learning_rate": 0.02, "weights_stddev": 0.05},
        {"type": "stochastic_pooling", "kx": 4, "ky": 4},
        {"type": "stochastic_abs_pooling", "kx": 2, "ky": 2},
        {"type": "softmax", "output_sample_shape": 10,
         "learning_rate": 0.02, "weights_stddev": 0.05},
    ],
}


def _train_both(fused):
    jax_prng.reset()
    jax_prng.seed_all(SEED)
    saved = jax_root.__dict__.pop("cifar", None)
    try:
        jax_root.cifar.update(CIFAR_STOCHASTIC)
        ref = jax_cifar.train(fused=fused)
        ref.snapshot_state()
    finally:
        jax_root.__dict__.pop("cifar", None)
        if saved is not None:
            jax_root.__dict__["cifar"] = saved
        jax_prng.reset()
    prng.reset()
    prng.seed_all(SEED)
    root.__dict__.pop("cifar", None)
    root.cifar.update(CIFAR_STOCHASTIC)
    wf = cifar.build(fused=fused)
    wf.initialize(device="cpu")
    wf.run()
    wf.snapshot_state()
    return wf, ref


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unit"])
def test_workflow_trains_two_steps_as_the_reference(fused):
    wf, ref = _train_both(fused)
    [got] = wf.decision.epoch_metrics
    [want] = ref.decision.epoch_metrics
    assert got["train"]["count"] == want["train"]["count"] == 16
    assert numpy.isfinite(got["train"]["loss"])
    assert abs(got["train"]["loss"] - want["train"]["loss"]) < 1e-5
    assert got["validation"]["n_err"] == want["validation"]["n_err"]
    assert abs(got["validation"]["loss"] - want["validation"]["loss"]) \
        < 1e-5
    for f, r in zip(wf.forwards, ref.forwards):
        if f.has_params:
            numpy.testing.assert_allclose(
                f.weights.mem, numpy.asarray(r.weights.mem), rtol=0,
                atol=1e-6)


def test_planted_gumbel_on_p_instead_of_log_p_is_caught():
    src = textwrap.dedent(inspect.getsource(F.stochastic_pooling))
    old = "torch.log(torch.clamp(probs, min=1e-30))"
    assert src.count(old) == 1
    scope = {}
    exec(compile(src.replace(old, "probs"), "<planted>", "exec"),
         vars(F), scope)
    window, stride, shape = CASES[0]
    x = _input(shape)
    got, idx, want, want_idx, near, _ = _compare_train(
        x, window, stride, 0, False, func=scope["stochastic_pooling"])
    far = ~near
    assert (idx[far] != want_idx[far]).sum() > 0.1 * far.sum()
