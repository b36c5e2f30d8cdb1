"""The multi-tensor fused SGD update and the split-KV prefill contract
against the JAX package on the CPU.

- ``fused_sgd_update_multi``'s plain version, per tensor, against the
  reference's Pallas ``fused_sgd_update`` in interpret mode: bit-equal
  (as ``tests/test_torch_functional.py`` holds the single-tensor call),
  over lists whose tensors take their own learning rate, weight decay
  and L1 mix; with a clip, against the reference's ``'xla'`` route
  (``functional.sgd_update`` jitted with a traced batch size) at that
  file's bounds: p' within 1 ulp, v' within 2 ulps of each final
  operation's largest operand (XLA divides by the batch where the kernel
  multiplies by its inverse).
- The fused MNIST-FC step makes ONE update call a train step (all four
  tensors), unit mode one a GD unit; both stay bit-equal to the
  per-tensor route the port took before (``sgd_items`` off), with a bias
  learning rate and weight decay of their own.
- The prefill split kernel's contract in plain PyTorch — each range of
  the table leaves an online-softmax state (m, l, acc), the combine meets
  them in split order — matches ``paged_flash_prefill_ref`` within 1e-6
  absolute for every split count from 1 to the table width (fp32 sums of
  O(1) terms regrouped: ~1e-7 apart), with all-dead ranges, a window with
  and without sinks, and grouped-query heads; and the port's plain prefill
  is held to the reference's Pallas kernel in ``test_torch_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu.ops import functional as JF
from veles_tpu.ops import pallas_kernels as PK
from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.ops import hopper_kernels as HK
from veles_tpu_torch.ops.nn_units import GradientDescentBase
from veles_tpu_torch.samples import mnist


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU products run far faster on one thread here."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _t(a):
    return torch.from_numpy(numpy.array(a))


def _operands(n, seed):
    rng = numpy.random.RandomState(seed)
    return (rng.uniform(-0.3, 0.3, n).astype(numpy.float32),
            (rng.randn(n) * 0.01).astype(numpy.float32),
            (rng.randn(n) * 5).astype(numpy.float32))


# ------------------------------------------------------------ fused SGD
LISTS = {
    # lengths, then each tensor's (batch, lr, momentum, wd, l1)
    "odd_lengths": ((1, 127, 129),
                    ((100, 0.03, 0.9, 0.0, 0.0), (100, 0.06, 0.9, 0.0005, 0.3),
                     (100, numpy.float32(0.01), 0.5, 0.001, 1.0))),
    "weight_and_bias": ((7850, 10),
                        ((37, 0.03, 0.9, 0.0005, 0.3),
                         (37, 0.06, 0.9, 0.0, 0.3))),
    "mnist_fc": ((78400, 100, 1000, 10),
                 ((100, 0.03, 0.9, 0.0, 0.0), (100, 0.05, 0.9, 0.0, 0.0),
                  (100, 0.03, 0.9, 0.0005, 0.0),
                  (100, 0.05, 0.9, 0.0002, 0.0))),
}


@pytest.mark.parametrize("name", sorted(LISTS))
def test_multi_plain_matches_pallas_per_tensor(name):
    lengths, scalars = LISTS[name]
    ops = [_operands(n, k + n) for k, n in enumerate(lengths)]
    before = HK.fused_sgd_update.launches
    got_p, got_v = HK.fused_sgd_update_multi(
        [_t(p) for p, _, _ in ops], [_t(v) for _, v, _ in ops],
        [_t(g) for _, _, g in ops], scalars)
    assert HK.fused_sgd_update.launches == before     # CPU: plain version
    for (p, v, g), s, gp, gv in zip(ops, scalars, got_p, got_v):
        ref_p, ref_v = PK.fused_sgd_update(
            jnp.asarray(p), jnp.asarray(v), jnp.asarray(g), *s,
            interpret=True)
        numpy.testing.assert_array_equal(gp.numpy(), numpy.asarray(ref_p))
        numpy.testing.assert_array_equal(gv.numpy(), numpy.asarray(ref_v))


@pytest.mark.parametrize("clips", [(0.05, 0.05), (0.05, None), (0.2, 0.01)])
def test_multi_clip_matches_xla_route(clips):
    step = jax.jit(JF.sgd_update, static_argnums=(5, 6, 7, 8))
    ops = [_operands(n, 5 + n) for n in (3000, 129)]
    scalars = [(100, 0.03, 0.9, 0.001, 0.3, clips[0]),
               (100, 0.06, 0.9, 0.0, 0.3, clips[1])]
    got_p, got_v = HK.fused_sgd_update_multi(
        [_t(p) for p, _, _ in ops], [_t(v) for _, v, _ in ops],
        [_t(g) for _, _, g in ops], scalars)
    f32 = numpy.float32
    for (p, v, g), s, gp, gv in zip(ops, scalars, got_p, got_v):
        batch, lr, mom, wd, l1, clip = s
        ref_p, ref_v = step(jnp.asarray(p), jnp.asarray(v), jnp.asarray(g),
                            jnp.asarray(batch, jnp.int32), lr, mom, wd, l1,
                            clip)
        ref_p, ref_v = numpy.asarray(ref_p), numpy.asarray(ref_v)
        gn = g / f32(batch)
        if clip:
            gn = numpy.clip(gn, -clip, clip)
        v_ops = numpy.maximum(numpy.abs(f32(mom) * v),
                              numpy.abs(f32(lr) * gn))
        p_ops = numpy.maximum.reduce([numpy.abs(p), numpy.abs(ref_v),
                                      numpy.abs(ref_p)])
        assert (numpy.abs(gv.numpy() - ref_v)
                / numpy.spacing(v_ops)).max() <= 2.0
        assert (numpy.abs(gp.numpy() - ref_p)
                / numpy.spacing(p_ops)).max() <= 1.0


def test_single_call_is_a_one_entry_multi():
    p, v, g = (_t(a) for a in _operands(1001, 9))
    args = (100, 0.03, 0.9, 0.0005, 0.3, 0.05)
    one = HK.fused_sgd_update(p, v, g, *args)
    (mp,), (mv,) = HK.fused_sgd_update_multi([p], [v], [g], [args])
    assert torch.equal(one[0], mp) and torch.equal(one[1], mv)


def test_multi_rejects_bad_lists():
    p = torch.zeros(8)
    with pytest.raises(ValueError, match="differ in number"):
        HK.fused_sgd_update_multi([p, p], [p], [p, p], [(1, 0.1)] * 2)
    with pytest.raises(ValueError, match="differ in shape"):
        HK.fused_sgd_update_multi([p], [torch.zeros(9)], [p], [(1, 0.1)])
    with pytest.raises(TypeError, match="not tensors"):
        HK.fused_sgd_update_multi([p], [p], [p], [(1, torch.tensor(0.1))])
    assert HK.fused_sgd_update_multi([], [], [], []) == ([], [])


# ---------------------------------------------------- the route (MNIST-FC)
def _configure(hidden=32):
    root.__dict__.pop("mnist", None)
    mnist.default_config()
    layer = {"learning_rate": 0.03, "learning_rate_bias": 0.05,
             "momentum": 0.9, "weight_decay": 0.0005,
             "weight_decay_bias": 0.0001, "l1_vs_l2": 0.2}
    root.mnist.update({
        "loader": {"minibatch_size": 100, "n_train": 400, "n_valid": 100},
        "decision": {"max_epochs": 2, "fail_iterations": 50},
        "layers": [dict(layer, type="all2all_tanh",
                        output_sample_shape=hidden),
                   dict(layer, type="softmax", output_sample_shape=10)],
    })


def _train(fused, monkeypatch, joint=True):
    """(final workflow, [tensors a call] for every update call)."""
    calls = []
    real = HK.fused_sgd_update_multi

    def counted(params, velocities, grads, scalars):
        calls.append(len(params))
        return real(params, velocities, grads, scalars)

    with monkeypatch.context() as patch:
        patch.setattr(HK, "fused_sgd_update_multi", counted)
        if not joint:
            patch.setattr(GradientDescentBase, "sgd_items",
                          lambda self, *a: None)
        prng.reset()
        prng.seed_all(42)
        _configure()
        wf = mnist.train(fused=fused, device="cpu")
    return wf, calls


def _state(wf):
    wf.snapshot_state()
    return [numpy.array(x.mem) for f, g in zip(wf.forwards, wf.gds)
            for x in (f.weights, f.bias, g.velocity_weights,
                      g.velocity_bias)]


def test_fused_step_makes_one_update_call_a_train_step(monkeypatch):
    wf, calls = _train(True, monkeypatch)
    assert wf.fused_step.train_steps == 8
    assert calls == [4] * wf.fused_step.train_steps


def test_unit_mode_makes_one_update_call_a_gd_unit(monkeypatch):
    wf, calls = _train(False, monkeypatch)
    # 8 train minibatches over 2 epochs, the last gated by Decision: 7
    # committed steps, each with two GD units
    assert calls == [2] * (7 * 2)


def test_joint_updates_bit_equal_to_per_tensor_route(monkeypatch):
    fused, _ = _train(True, monkeypatch)
    unit, _ = _train(False, monkeypatch)
    per_tensor, calls = _train(True, monkeypatch, joint=False)
    # the route of one update call a tensor: 8 train steps of 4 tensors
    assert calls == [1] * (8 * 4)
    want = _state(per_tensor)
    for got in (_state(fused), _state(unit)):
        for a, b in zip(got, want):
            numpy.testing.assert_array_equal(a, b)


# ------------------------------------------------- the prefill split contract
def _prefill_inputs(b, h, kv, dh, page, m, n_hist, seed):
    rng = numpy.random.RandomState(seed)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(numpy.float32))

    n_pages = b * m + 1
    q, kn, vn = t(b, h, page, dh), t(b, kv, page, dh), t(b, kv, page, dh)
    kp, vp = t(n_pages, kv, page, dh), t(n_pages, kv, page, dh)
    ptab = torch.from_numpy((1 + rng.permutation(b * m)).reshape(b, m)
                            .astype(numpy.int32))
    pos = torch.tensor([n * page for n in n_hist], dtype=torch.int32)
    return q, kn, vn, kp, vp, ptab, pos


PREFILL_CASES = {
    # b, h, kv, dh, page, m, n_hist per lane, window, sinks
    "no_history": (1, 4, 4, 16, 8, 6, (0,), None, 0),
    "ragged_lanes": (2, 4, 4, 16, 8, 7, (5, 1), None, 0),
    "gqa": (2, 8, 2, 8, 4, 9, (8, 3), None, 0),
    "window_sinks": (2, 4, 2, 16, 4, 10, (9, 6), 7, 2),
    "window_only": (1, 4, 4, 12, 8, 8, (7,), 10, 0),
}


@pytest.mark.parametrize("name", sorted(PREFILL_CASES))
def test_prefill_split_then_combine_matches_plain(name):
    b, h, kv, dh, page, m, n_hist, window, sinks = PREFILL_CASES[name]
    args = _prefill_inputs(b, h, kv, dh, page, m, n_hist, len(name))
    q, kn, vn, kp, vp, ptab, pos = args
    ref, _, _ = HK.paged_flash_prefill_ref(q, kn, vn, kp.clone(), vp.clone(),
                                           ptab, pos, window, sinks)
    for splits in range(1, m + 1):
        ms, ls, accs = HK.paged_flash_prefill_split_ref(
            q, kn, vn, kp, vp, ptab, pos, splits, window, sinks)
        assert ms.shape == (b, kv, (h // kv) * page, splits)
        assert accs.shape == ms.shape + (dh,)
        got = HK.paged_flash_combine_ref(ms, ls, accs).reshape(ref.shape)
        assert (got - ref).abs().max().item() <= 1e-6, splits


def test_dead_ranges_leave_the_empty_state():
    """A range of pages with no key live for the lane (past the frontier,
    or between the sinks and the window) leaves (NEG_INF, 0, 0) exactly,
    which the combine weighs exp(NEG_INF - M) = 0."""
    args = _prefill_inputs(1, 4, 2, 8, 4, 12, (10,), 11)
    ms, ls, accs = HK.paged_flash_prefill_split_ref(*args, 12, 6, 1)
    # pages 0 (the sinks) and 8, 9 (the window) hold live keys; 10 and 11
    # sit at or past the frontier; the last range also holds the chunk
    for s in (1, 2, 3, 4, 5, 6, 7, 10):
        assert (ms[..., s] == HK.NEG_INF).all()
        assert (ls[..., s] == 0).all() and (accs[..., s, :] == 0).all()
    for s in (0, 8, 9, 11):
        assert (ms[..., s] > HK.NEG_INF).any()


@pytest.mark.parametrize("m", [1, 5, 16, 17])
def test_split_ranges_cover_the_table_in_order(m):
    for splits in range(1, m + 1):
        ranges = HK.split_ranges(m, splits)
        assert len(ranges) == splits
        pages = [j for lo, hi in ranges for j in range(lo, hi)]
        assert pages == list(range(m))
