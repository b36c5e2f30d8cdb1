"""The port's transformer LM training slice against
``veles_tpu.ops.transformer`` and ``veles_tpu.samples.char_lm``.

Same inputs (numpy, from a seed; weights bit-equal from the same prng
stream) through both packages.  Tolerances, fp32 with two frameworks'
reduction orders:
- ``lm_loss`` rtol 1e-5; its gradients rtol 1e-4 / atol 1e-6 per
  element (O(1e-2) gradients summed over every position);
- Adam and training runs as each tensor's ‖port − ref‖ / ‖ref − init‖:
  Adam's first steps move an element by about lr·sign(g), so a
  near-zero gradient whose sign differs by roundoff moves one element a
  whole step; a norm weighs that against the whole tensor's movement.
  Limits 1e-3 after three steps, 1e-2 after a two-epoch run (16 steps);
  per-epoch losses rtol 1e-4;
- greedy tokens and state dicts: equal.
On the CPU the port's 'flash_pallas' backend runs the flash kernels'
plain versions, so both backends are held to the reference's 'xla'.
"""

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

from veles_tpu import prng as jprng
from veles_tpu.config import root as jroot
from veles_tpu.ops import transformer as JT
from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.ops import attention as TA
from veles_tpu_torch.ops import transformer as TT

GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
ADAM_SHARE = 1e-3
RUN_SHARE = 1e-2

#: tests/test_transformer.py::tiny_config, every optional knob pinned
TINY = {
    "loader": {"minibatch_size": 32, "n_train": 128, "n_valid": 64,
               "seq_len": 32, "vocab": 16},
    "trainer": {"vocab": 16, "d_model": 32, "n_heads": 2, "n_layers": 1,
                "max_len": 32, "learning_rate": 3e-3, "n_experts": 0,
                "pipeline_stages": 0, "remat": False, "rope": False,
                "window": None, "attn_sinks": 0, "n_kv_heads": None},
    "decision": {"max_epochs": 2, "fail_iterations": 10},
}


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU products run fastest single-threaded (and several test
    workers share the host's cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(params=["xla", "flash_pallas"])
def backend(request):
    TA.set_attention_backend(request.param)
    yield request.param
    TA.set_attention_backend("xla")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], "%s/%s" % (prefix, k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, "%s/%d" % (prefix, i))
    else:
        yield prefix, numpy.asarray(tree.detach().cpu() if isinstance(
            tree, torch.Tensor) else tree)


def _host_params(seed=7, **kwargs):
    """The reference's numpy param tree and the port's, checked equal."""
    jprng.reset()
    host = JT.init_transformer_params(jprng.RandomGenerator("init", seed),
                                      16, d_model=32, n_heads=4, n_layers=1,
                                      max_len=24, **kwargs)
    mine = TT.init_transformer_params(prng.RandomGenerator("init", seed),
                                      16, d_model=32, n_heads=4, n_layers=1,
                                      max_len=24, **kwargs)
    for (ka, a), (kb, b) in zip(_flat(host), _flat(mine)):
        assert ka == kb
        numpy.testing.assert_array_equal(a, b)
    return host


def _tensors(host, grad=False):
    return TT.tree_map(lambda a: torch.tensor(a, requires_grad=grad), host)


def _shares(got, want, init):
    """{name: ‖got − want‖ / ‖want − init‖} over matching leaves."""
    init = dict(_flat(init))
    out = {}
    for (name, a), (_, b) in zip(_flat(got), _flat(want)):
        moved = numpy.linalg.norm(b - init[name])
        out[name] = numpy.linalg.norm(a - b) / max(moved, 1e-30)
    return out


LOSS_CASES = {
    "dense": ({}, {}),
    "rope_gqa": ({"rope": True, "n_kv_heads": 1}, {"rope": True}),
    "window_sinks": ({}, {"window": 6, "sinks": 2}),
    "block_size": ({}, {"block_size": 8}),
    "remat": ({}, {"remat": True}),
}
#: options that change how the reference computes, not what: its
#: ``jax.checkpoint`` gives the plain loss and gradients, so the port's
#: remat is held to the reference's plain program
SAME_MATH = ("remat",)


@pytest.fixture(scope="module")
def loss_reference():
    """The reference's lm_loss and its gradients for every case of
    LOSS_CASES, from one compiled program: {case: (host params, tokens,
    mask, loss, grads)} with numpy leaves."""
    rng = numpy.random.RandomState(1)
    tokens = rng.randint(0, 16, (3, 17)).astype(numpy.int32)
    mask = numpy.array([1.0, 1.0, 0.0], numpy.float32)
    hosts = {case: _host_params(**LOSS_CASES[case][0])
             for case in LOSS_CASES}

    @jax.jit
    def run(params):
        return {case: jax.value_and_grad(JT.lm_loss)(
            params[case], tokens, mask, 4,
            **{k: v for k, v in LOSS_CASES[case][1].items()
               if k not in SAME_MATH}) for case in LOSS_CASES}

    out = jax.tree.map(numpy.asarray, run(hosts))
    return {case: (hosts[case], tokens, mask) + tuple(out[case])
            for case in LOSS_CASES}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_lm_loss_and_grads_match_reference(backend, loss_reference, case):
    host, tokens, mask, loss, grads = loss_reference[case]
    loss_kw = LOSS_CASES[case][1]
    params = _tensors(host, grad=True)
    got = TT.lm_loss(params, torch.from_numpy(tokens),
                     torch.from_numpy(mask), 4, **loss_kw)
    got_grads = torch.autograd.grad(got, TT.tree_leaves(params))
    numpy.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    grad_tree = dict(zip((k for k, _ in _flat(params)),
                         (g for _, g in _flat(
                             TT.tree_map(lambda g: g, _regrid(
                                 params, got_grads))))))
    for name, want in _flat(grads):
        numpy.testing.assert_allclose(grad_tree[name], want, err_msg=name,
                                      **GRAD_TOL)


def _regrid(tree, leaves):
    """``leaves`` (in ``tree_leaves`` order) put back into ``tree``'s
    structure."""
    it = iter(leaves)
    return TT.tree_map(lambda _: next(it), tree)


_REF_ADAM = jax.jit(JT.make_adam_train_step(
    lambda p, t, m: JT.lm_loss(p, t, m, 4), 3e-3))


def test_adam_three_steps_match_reference(backend):
    host = _host_params(seed=9)
    rng = numpy.random.RandomState(2)
    batches = [rng.randint(0, 16, (4, 17)).astype(numpy.int32)
               for _ in range(3)]
    mask = numpy.ones(4, numpy.float32)

    jp = jax.tree.map(jnp.asarray, host)
    jstate = (jax.tree.map(jnp.zeros_like, jp),
              jax.tree.map(jnp.zeros_like, jp))
    step = TT.make_adam_train_step(
        lambda p, t, m: TT.lm_loss(p, t, m, 4), 3e-3)
    tp = _tensors(host, grad=True)
    tstate = (TT.tree_map(torch.zeros_like, _tensors(host)),
              TT.tree_map(torch.zeros_like, _tensors(host)))
    for t, tokens in enumerate(batches):
        jp, jstate, jm = _REF_ADAM(jp, jstate, jnp.asarray(tokens),
                                  jnp.asarray(mask), jnp.asarray(t))
        tp, tstate, tm = step(tp, tstate, torch.from_numpy(tokens),
                              torch.from_numpy(mask), t)
        numpy.testing.assert_allclose(tm["loss_sum"].item(),
                                      float(jm["loss_sum"]), rtol=1e-5)
        assert tm["tokens"].item() == float(jm["tokens"])
    shares = _shares(tp, jp, host)
    assert max(shares.values()) <= ADAM_SHARE, shares
    for (name, a), (_, b) in zip(_flat(tstate), _flat(jstate)):
        assert numpy.linalg.norm(a - b) <= 1e-4 * numpy.linalg.norm(b), name


def _configure(cfg_root, package_prng):
    package_prng.reset()
    package_prng.seed_all(4)
    cfg_root.__dict__.pop("char_lm", None)
    cfg_root.char_lm.update(TINY)


@pytest.fixture(scope="module")
def reference_run():
    """The reference's char_lm.train at the tiny config: per-epoch
    losses, the initial and the final params."""
    from veles_tpu.samples import char_lm
    _configure(jroot, jprng)
    wf = char_lm.build()
    init = {}
    real = wf.trainer.initialize

    def keep_init(**kw):
        out = real(**kw)
        init["params"] = jax.tree.map(numpy.asarray, wf.trainer.params)
        return out

    wf.trainer.initialize = keep_init
    wf.initialize()
    wf.run()
    return ([{s: m[s]["loss"] for s in ("validation", "train")}
             for m in wf.decision.epoch_metrics], init["params"],
            TT.tree_map(numpy.array, wf.trainer.state_dict()["params"]), wf)


def test_char_lm_train_matches_reference(backend, reference_run):
    from veles_tpu_torch.samples import char_lm
    losses, init, final, _ = reference_run
    _configure(root, prng)
    wf = char_lm.train(device="cpu")
    got = [{s: m[s]["loss"] for s in ("validation", "train")}
           for m in wf.decision.epoch_metrics]
    assert len(got) == len(losses) == 2
    for a, b in zip(got, losses):
        for s in a:
            numpy.testing.assert_allclose(a[s], b[s], rtol=1e-4)
    assert wf.trainer.time == 8
    shares = _shares(wf.trainer.params, final, init)
    assert max(shares.values()) <= RUN_SHARE, shares


TOKENS_CASES = [
    ([[1, 2, 3], [4, 5, 6]], 8, {}),
    ([[7, 3]], 5, {}),
    ([[1, 2, 3, 4, 5], [9, 8, 7, 6, 5]], 6, {"max_len": 16}),
    ([[1, 2, 3, 4, 5, 0, 0, 0], [9, 8, 7, 6, 5, 0, 0, 0]], 6,
     {"max_len": 16, "true_len": 5}),
]


@pytest.mark.parametrize("prompt,n_new,kw", TOKENS_CASES)
def test_greedy_generate_equals_reference(backend, prompt, n_new, kw):
    """tests/test_transformer.py::TestGenerate's geometry: vocab 16,
    d_model 32, 2 heads, 2 layers, max_len 24, seed 13."""
    jprng.reset()
    host = JT.init_transformer_params(jprng.RandomGenerator("init", 13), 16,
                                      d_model=32, n_heads=2, n_layers=2,
                                      max_len=24)
    want = numpy.asarray(JT.generate(jax.tree.map(jnp.asarray, host),
                                     jnp.asarray(prompt, jnp.int32), n_new,
                                     2, temperature=0, **kw))
    got = TT.generate(_tensors(host), torch.tensor(prompt, dtype=torch.int32),
                      n_new, 2, temperature=0, **kw)
    assert got.dtype == torch.int32
    numpy.testing.assert_array_equal(got.numpy(), want)


def test_generate_refuses_sampling():
    """Sampling raises; greedy decoding drops an in-range ``top_k`` as
    the reference does ("greedy never reads top_k") and returns the
    reference's tokens."""
    host = _host_params()
    params = _tensors(host)
    prompt = torch.tensor([[1, 2]], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="Queue 1, item 6"):
        TT.generate(params, prompt, 3, 4, temperature=0.8)
    want = numpy.asarray(JT.generate(jax.tree.map(jnp.asarray, host),
                                     jnp.asarray(prompt.numpy()), 3, 4,
                                     temperature=0, top_k=4))
    got = TT.generate(params, prompt, 3, 4, temperature=0, top_k=4)
    numpy.testing.assert_array_equal(got.numpy(), want)
    numpy.testing.assert_array_equal(
        got.numpy(), TT.generate(params, prompt, 3, 4, temperature=0).numpy())
    with pytest.raises(ValueError, match="exceeds the positional table"):
        TT.generate(params, prompt, 40, 4, temperature=0)


@pytest.mark.parametrize("top_k", [0, 17, -1])
def test_generate_range_checks_top_k(top_k):
    """``top_k`` outside [1, vocab] raises the reference's ValueError,
    greedy or not (vocab 16)."""
    host = _host_params()
    prompt = numpy.array([[1, 2]], numpy.int32)
    with pytest.raises(ValueError, match="top_k .* out of range"):
        JT.generate(jax.tree.map(jnp.asarray, host), jnp.asarray(prompt), 3,
                    4, temperature=0, top_k=top_k)
    with pytest.raises(ValueError, match="top_k .* out of range"):
        TT.generate(_tensors(host), torch.from_numpy(prompt), 3, 4,
                    temperature=0, top_k=top_k)


@pytest.mark.parametrize("n_experts", [0, 4])
def test_ffn_relu_tie_gradient_matches_reference(n_experts):
    """A zero LN output row with b1 = 0 puts every FFN pre-activation
    of that row at exactly 0: the reference's ``jnp.maximum`` passes
    half the cotangent there, and so must the port (dense and MoE)."""
    jprng.reset()
    host = JT.init_transformer_params(jprng.RandomGenerator("init", 5), 16,
                                      d_model=32, n_heads=4, n_layers=1,
                                      max_len=24, n_experts=n_experts)
    blk = {k: v for k, v in host["blocks"][0].items()
           if k in ("moe", "w1", "b1", "w2", "b2")}
    rng = numpy.random.RandomState(4)
    hn = rng.randn(2, 5, 32).astype(numpy.float32)
    hn[1, 2] = 0.0
    cot = rng.randn(2, 5, 32).astype(numpy.float32)

    def ref_loss(b):
        return (JT._block_ffn(b, jnp.asarray(hn)) * cot).sum()

    want = jax.grad(ref_loss)(jax.tree.map(jnp.asarray, blk))
    mine = _tensors(blk, grad=True)
    loss = (TT._block_ffn(mine, torch.from_numpy(hn))
            * torch.from_numpy(cot)).sum()
    got = _regrid(mine, torch.autograd.grad(loss, TT.tree_leaves(mine)))
    sub = (lambda t: t["moe"]) if n_experts else (lambda t: t)
    numpy.testing.assert_allclose(sub(got)["b1"].numpy(),
                                  numpy.asarray(sub(want)["b1"]), **GRAD_TOL)
    for name, value in _flat(want):
        numpy.testing.assert_allclose(dict(_flat(got))[name], value,
                                      err_msg=name, **GRAD_TOL)


def test_state_dict_carries_across_both_ways(reference_run):
    """The reference trainer's state_dict (after its two-epoch run) loads
    into the port's and the port's into the reference's, equal leaf for
    leaf; one more train step on each side then agrees."""
    from veles_tpu_torch.samples import char_lm as tchar
    ref = reference_run[-1]
    _configure(root, prng)
    mine = tchar.build()
    mine.initialize(device="cpu")
    rng = numpy.random.RandomState(6)
    tokens = rng.randint(0, 16, (32, 32)).astype(numpy.int32)
    mask = numpy.ones(32, numpy.float32)

    def step_ref():
        tr = ref.trainer
        tr.params, tr.opt_state, _ = tr._train(
            tr.params, tr.opt_state, jnp.asarray(tokens), jnp.asarray(mask),
            jnp.asarray(tr.time, jnp.int32))
        tr.time += 1

    def step_mine():
        tr = mine.trainer
        tr.params, tr.opt_state, _ = tr._train(
            tr.params, tr.opt_state, torch.from_numpy(tokens),
            torch.from_numpy(mask), tr.time)
        tr.time += 1

    for src, dst, steps in ((ref, mine, (step_ref, step_mine)),
                            (mine, ref, (step_mine, step_ref))):
        state = src.trainer.state_dict()
        dst.trainer.load_state_dict(state)
        back = dst.trainer.state_dict()
        assert back["time"] == state["time"]
        for (ka, a), (kb, b) in zip(_flat(back["params"]),
                                    _flat(state["params"])):
            assert ka == kb
            numpy.testing.assert_array_equal(a, b)
        for (_, a), (_, b) in zip(_flat(back["opt_state"]),
                                  _flat(state["opt_state"])):
            numpy.testing.assert_array_equal(a, b)
        before = TT.tree_map(numpy.array, state["params"])
        for step in steps:
            step()
        shares = _shares(mine.trainer.params,
                         ref.trainer.state_dict()["params"], before)
        assert max(shares.values()) <= ADAM_SHARE, shares


def test_trainer_refuses_moe_pipeline_and_runs_nowhere_unasked():
    """The pipelined trainer builds, with or without experts
    (``tests/test_torch_pipeline.py`` runs it); with no joined run of two
    processes, a two-stage trainer cannot initialize."""
    assert TT.TransformerTrainer(None, n_experts=2).n_experts == 2
    for kw in ({"n_experts": 2}, {}):
        tr = TT.TransformerTrainer(None, pipeline_stages=2, **kw)
        assert tr.pipeline_stages == 2
        with pytest.raises(ValueError, match="need 2 devices, have 1"):
            tr._pipeline_mesh()
