"""The port's mixture of experts (``veles_tpu_torch.ops.moe`` and the MoE
blocks of ``ops/transformer.py``) against ``veles_tpu.ops.moe`` and
``veles_tpu.ops.transformer``, at the reference tests' sizes (d 16,
d_ff 32, E 4, x (6, 9, 16); LM d 16–32, 1–2 layers).

Same inputs (numpy, from a seed; weights bit-equal from the same prng
stream) through both packages.  Tolerances, fp32 with two frameworks'
reduction orders:
- ``moe_ffn`` and ``moe_ffn_ep`` (the reference's own bars,
  ``tests/test_moe.py``): values rtol 2e-5 / atol 1e-6, gradients rtol
  2e-4 / atol 1e-5; the EP ranks bit-equal to each other;
- ``lm_loss`` rtol 1e-5, its gradients rtol 1e-4 / atol 1e-6; Adam and
  training runs as ‖port − ref‖ / ‖ref − init‖ per tensor (1e-3 after
  three steps, 1e-2 after a two-epoch run), per-epoch losses rtol 1e-4
  (``tests/test_torch_lm_train.py``'s bars);
- initial weights, greedy tokens and state dicts: equal.

Routing is discrete: XLA's and PyTorch's CPU products differ by up to
an ulp, so a token whose two largest router probabilities lie within
roundoff may pick another expert, and its whole output row moves.
Every check of routed values compares the two packages' choices and
records the smallest top-1/top-2 margin of its inputs (the
``min_router_margin`` and ``routing_flips`` junit properties).  A
token routed differently at a margin below ``FLIP_MARGIN`` is counted
and left out of the elementwise comparison; one at a larger margin
fails the test; gradients, which mix every token, are compared only
when no token flipped.  A training run compounds roundoff step by step
(its weights drift by up to ``RUN_SHARE`` of their movement), so the
char-LM run routes each of the port's MoE calls as the reference's
same call routed (recorded in the reference's jitted step through
``jax.debug.callback``): the port's own choices are counted as flips
with their margins (below ``RUN_FLIP_MARGIN``), and the weights are
held to the run's limits with the routing equal.
"""

import os
import socket
import subprocess
import sys

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

from veles_tpu import prng as jprng
from veles_tpu.config import root as jroot
from veles_tpu.ops import moe as JM
from veles_tpu.ops import transformer as JT
from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.ops import attention as TA
from veles_tpu_torch.ops import moe as TM
from veles_tpu_torch.ops import transformer as TT

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
D_MODEL, D_FF, N_EXPERTS = 16, 32, 4
KEYS = ("router", "w1", "b1", "w2", "b2")
VALUE_TOL = dict(rtol=2e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol=1e-5)
LM_GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
ADAM_SHARE = 1e-3
RUN_SHARE = 1e-2
#: a top-1/top-2 router-probability margin below this is within the
#: two packages' roundoff (probabilities ≤ 1 move by ~1e-7 when a logit
#: moves by an ulp); a routing difference at a larger margin is a fault
FLIP_MARGIN = 1e-5
#: the same over a training run, whose router probabilities drift with
#: its weights (a flip at 2.4e-5 seen under 'flash_pallas', whose plain
#: attention sums in another order than the reference's)
RUN_FLIP_MARGIN = 1e-3

#: tests/test_torch_lm_train.py's TINY with 4 experts and 2 layers
TINY_MOE = {
    "loader": {"minibatch_size": 32, "n_train": 128, "n_valid": 64,
               "seq_len": 32, "vocab": 16},
    "trainer": {"vocab": 16, "d_model": 32, "n_heads": 2, "n_layers": 2,
                "max_len": 32, "learning_rate": 3e-3, "n_experts": 4,
                "moe_aux_coef": 1e-2, "pipeline_stages": 0,
                "remat": False, "rope": False, "window": None,
                "attn_sinks": 0, "n_kv_heads": None},
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


def _tensors(host, grad=False):
    return TT.tree_map(lambda a: torch.tensor(a, requires_grad=grad), host)


def _regrid(tree, leaves):
    it = iter(leaves)
    return TT.tree_map(lambda _: next(it), tree)


def _shares(got, want, init):
    """{name: ‖got − want‖ / ‖want − init‖} over matching leaves."""
    init = dict(_flat(init))
    out = {}
    for (name, a), (_, b) in zip(_flat(got), _flat(want)):
        moved = numpy.linalg.norm(b - init[name])
        out[name] = numpy.linalg.norm(a - b) / max(moved, 1e-30)
    return out


def _routing(want_probs, got_probs, record_property):
    """The tokens the port routes to another expert than the reference,
    as a boolean mask; fails on a flip at a margin of FLIP_MARGIN or
    more, and records the smallest margin and the flip count."""
    want_probs = numpy.asarray(want_probs).reshape(
        -1, numpy.shape(want_probs)[-1])
    got_probs = numpy.asarray(got_probs).reshape(want_probs.shape)
    top2 = numpy.sort(want_probs, axis=-1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    flips = want_probs.argmax(-1) != got_probs.argmax(-1)
    record_property("min_router_margin", float(margin.min()))
    record_property("routing_flips", int(flips.sum()))
    assert not (flips & (margin >= FLIP_MARGIN)).any(), (
        "routing differs at margins %r" % margin[flips].tolist())
    return flips


def _moe_setup(seed=11):
    """``tests/test_moe.py::_setup``: (host params, x) with the port's
    params checked bit-equal to the reference's."""
    jprng.reset()
    jprng.seed_all(seed)
    prng.reset()
    prng.seed_all(seed)
    host = JM.init_moe_params(jprng.get("init"), D_MODEL, D_FF, N_EXPERTS)
    mine = TM.init_moe_params(prng.get("init"), D_MODEL, D_FF, N_EXPERTS)
    assert sorted(host) == sorted(mine) == sorted(KEYS)
    for k in KEYS:
        assert mine[k].dtype == host[k].dtype
        numpy.testing.assert_array_equal(mine[k], host[k], err_msg=k)
    x = numpy.random.RandomState(3).randn(6, 9, D_MODEL).astype(
        numpy.float32)
    return host, x


# ------------------------------------------------------------ ops/moe.py
def test_init_moe_params_bit_equal():
    host, _ = _moe_setup()
    assert host["w1"].shape == (N_EXPERTS, D_MODEL, D_FF)
    assert host["w2"].shape == (N_EXPERTS, D_FF, D_MODEL)


@pytest.mark.parametrize("n_experts,kwargs", [
    (2, {}), (4, {}), (4, {"rope": True, "n_kv_heads": 2})])
def test_init_transformer_params_moe_bit_equal(n_experts, kwargs):
    """MoE blocks draw ``moe`` INSTEAD of the dense FFN weights, so every
    later draw stays where the reference's is."""
    jprng.reset()
    prng.reset()
    jprng.seed_all(5)
    prng.seed_all(5)
    want = JT.init_transformer_params(jprng.get("init"), 48, d_model=32,
                                      n_heads=4, n_layers=2, max_len=32,
                                      n_experts=n_experts, **kwargs)
    got = TT.init_transformer_params(prng.get("init"), 48, d_model=32,
                                     n_heads=4, n_layers=2, max_len=32,
                                     n_experts=n_experts, **kwargs)
    want, got = dict(_flat(want)), dict(_flat(got))
    assert sorted(want) == sorted(got)
    assert "/blocks/1/moe/w1" in got and "/blocks/1/w1" not in got
    assert got["/blocks/0/moe/w1"].shape == (n_experts, 32, 128)
    for key in want:
        assert got[key].dtype == want[key].dtype
        numpy.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_router_probs_match(record_property):
    host, x = _moe_setup()
    want = numpy.asarray(JM.router_probs(jax.tree.map(jnp.asarray, host),
                                         jnp.asarray(x)))
    got = TM.router_probs(_tensors(host), torch.from_numpy(x)).numpy()
    assert got.shape == (6 * 9, N_EXPERTS)
    numpy.testing.assert_allclose(got, want, **VALUE_TOL)
    assert not _routing(want, got, record_property).any()


def test_single_device_routing_semantics():
    """The port's twin of ``test_single_device_routing_semantics``: each
    token's output is its top-1 expert's FFN scaled by the gate."""
    host, x = _moe_setup()
    params = _tensors(host)
    out = TM.moe_ffn(params, torch.from_numpy(x))
    assert out.shape == x.shape
    probs = TM.router_probs(params, torch.from_numpy(x)).numpy()
    flat, outf = x.reshape(-1, D_MODEL), out.numpy().reshape(-1, D_MODEL)
    for t in (0, 17, 53):
        e = int(probs[t].argmax())
        h = numpy.maximum(flat[t] @ host["w1"][e] + host["b1"][e], 0.0)
        manual = (h @ host["w2"][e] + host["b2"][e]) * probs[t, e]
        numpy.testing.assert_allclose(outf[t], manual, **VALUE_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_moe_ffn_values_aux_and_grads_match(masked, record_property):
    """Values, the load-balancing loss and the gradients of
    ``sum(out²) + aux`` in every param and in x, against
    ``jax.value_and_grad`` of the reference."""
    host, x = _moe_setup()
    token_mask = (numpy.arange(6 * 9) % 5 != 0).astype(numpy.float32) \
        if masked else None

    def ref_loss(p, xx):
        out, aux = JM.moe_ffn(p, xx, return_aux=True,
                              token_mask=None if token_mask is None
                              else jnp.asarray(token_mask))
        return (out ** 2).sum() + aux, (out, aux)

    (_, (want_out, want_aux)), (want_g, want_gx) = jax.value_and_grad(
        ref_loss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, host), jnp.asarray(x))
    params = _tensors(host, grad=True)
    xt = torch.tensor(x, requires_grad=True)
    out, aux = TM.moe_ffn(params, xt, return_aux=True,
                          token_mask=None if token_mask is None
                          else torch.from_numpy(token_mask))
    grads = torch.autograd.grad((out ** 2).sum() + aux,
                                [params[k] for k in KEYS] + [xt])
    flips = _routing(JM.router_probs(jax.tree.map(jnp.asarray, host),
                                     jnp.asarray(x)),
                     TM.router_probs(params, xt).detach(), record_property)
    keep = ~flips
    numpy.testing.assert_allclose(
        out.detach().numpy().reshape(-1, D_MODEL)[keep],
        numpy.asarray(want_out).reshape(-1, D_MODEL)[keep], **VALUE_TOL)
    numpy.testing.assert_allclose(aux.item(), float(want_aux), rtol=2e-5)
    assert not flips.any(), "gradients mix every token: routing must agree"
    for key, g in zip(KEYS, grads):
        numpy.testing.assert_allclose(g.numpy(), numpy.asarray(want_g[key]),
                                      err_msg=key, **GRAD_TOL)
    numpy.testing.assert_allclose(grads[-1].numpy(), numpy.asarray(want_gx),
                                  **GRAD_TOL)


def test_load_balancing_loss_semantics():
    """1.0 at perfect balance; E when routing collapses."""
    e, t = 4, 400
    balanced = torch.eye(e)[torch.arange(t) % e]
    uniform = torch.full((t, e), 1.0 / e)
    numpy.testing.assert_allclose(
        TM.load_balancing_loss(uniform, balanced).item(), 1.0, rtol=1e-6)
    collapsed = torch.zeros(t, e)
    collapsed[:, 0] = 1.0
    numpy.testing.assert_allclose(
        TM.load_balancing_loss(collapsed, collapsed).item(), float(e),
        rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_load_balancing_loss_matches_reference(masked):
    """Random probabilities and routing, with and without a token mask
    (the masked statistics count live tokens only)."""
    rng = numpy.random.RandomState(4)
    logits = rng.randn(50, 4).astype(numpy.float32)
    probs = numpy.exp(logits) / numpy.exp(logits).sum(-1, keepdims=True)
    onehot = numpy.eye(4, dtype=numpy.float32)[probs.argmax(-1)]
    mask = (rng.rand(50) > 0.3).astype(numpy.float32) if masked else None
    want = float(JM.load_balancing_loss(
        jnp.asarray(probs), jnp.asarray(onehot),
        None if mask is None else jnp.asarray(mask)))
    got = TM.load_balancing_loss(
        torch.from_numpy(probs), torch.from_numpy(onehot),
        None if mask is None else torch.from_numpy(mask)).item()
    numpy.testing.assert_allclose(got, want, rtol=1e-6)


def test_aux_loss_spreads_experts():
    """The port's twin of ``test_aux_loss_spreads_experts``: training WITH
    the aux loss routes tokens across more experts than without it."""
    rng = numpy.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(0, 16, (16, 24)).astype(
        numpy.int32))
    mask = torch.ones(16)

    def train(coef, steps=60):
        prng.reset()
        prng.seed_all(2)
        params = _tensors(TT.init_transformer_params(
            prng.get("init"), 16, d_model=16, n_heads=2, n_layers=1,
            max_len=32, n_experts=4), grad=True)
        leaves = TT.tree_leaves(params)
        for _ in range(steps):
            grads = torch.autograd.grad(
                TT.lm_loss(params, tokens, mask, 2, moe_aux_coef=coef),
                leaves)
            with torch.no_grad():
                for p, g in zip(leaves, grads):
                    p -= 0.05 * g
        with torch.no_grad():
            probs = TM.router_probs(params["blocks"][0]["moe"],
                                    params["embed"][tokens.long()])
        return len(numpy.unique(probs.argmax(-1).numpy()))

    with_aux = train(coef=1e-2)
    assert with_aux >= train(coef=0.0)
    assert with_aux >= 2


def test_expert_count_guard():
    from veles_tpu_torch.parallel import Mesh
    host, x = _moe_setup()
    mesh = Mesh(numpy.arange(3).reshape(1, 3), ("data", "expert"))
    assert mesh.shape == {"data": 1, "expert": 3}
    assert mesh.index("expert") == 0
    with pytest.raises(ValueError, match="n_experts"):
        TM.moe_ffn_ep(_tensors(host), torch.from_numpy(x), mesh)


# -------------------------------------------- expert parallel (gloo, CPU)
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ep_runs(tmp_path_factory):
    """The reference's ``moe_ffn`` value and gradients of sum(out²), and
    four gloo ranks' ``moe_ffn_ep`` results at expert axes of 2 and 4
    (``tests/torch_moe_worker.py``)."""
    host, x = _moe_setup()
    want, (want_g, want_gx) = jax.value_and_grad(
        lambda p, xx: (JM.moe_ffn(p, xx) ** 2).sum(), argnums=(0, 1))(
        jax.tree.map(jnp.asarray, host), jnp.asarray(x))
    ref = {"loss": float(want), "out": numpy.asarray(JM.moe_ffn(
        jax.tree.map(jnp.asarray, host), jnp.asarray(x))),
        "x_grad": numpy.asarray(want_gx),
        "grads": {k: numpy.asarray(v) for k, v in want_g.items()},
        "probs": numpy.asarray(JM.router_probs(
            jax.tree.map(jnp.asarray, host), jnp.asarray(x)))}
    tmp = tmp_path_factory.mktemp("moe_ep")
    inputs = str(tmp / "inputs.npz")
    numpy.savez(inputs, x=x, **host)
    port, world = _free_port(), 4
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_moe_worker.py"),
         str(port), str(world), str(r), inputs, str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO) for r in range(world)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-4000:]
    ranks = [dict(numpy.load(str(tmp / ("rank%d.npz" % r))))
             for r in range(world)]
    return ref, ranks


@pytest.mark.parametrize("n", [2, 4])
def test_expert_parallel_matches_single_device(ep_runs, n,
                                               record_property):
    """EP over an expert axis of n ranks == the reference's single-device
    MoE, values AND gradients (each rank's expert slices gathered)."""
    ref, ranks = ep_runs
    tag = "ep%d:" % n
    # every rank routes with the same router: its probs are the port's
    host, x = _moe_setup()
    assert not _routing(ref["probs"], TM.router_probs(
        _tensors(host), torch.from_numpy(x)), record_property).any()
    r0 = ranks[0]
    numpy.testing.assert_allclose(float(r0[tag + "loss"]), ref["loss"],
                                  rtol=2e-5)
    numpy.testing.assert_allclose(r0[tag + "out"], ref["out"], **VALUE_TOL)
    numpy.testing.assert_allclose(r0[tag + "grad/router"],
                                  ref["grads"]["router"], **GRAD_TOL)
    numpy.testing.assert_allclose(r0[tag + "x_grad"], ref["x_grad"],
                                  **GRAD_TOL)
    k = N_EXPERTS // n
    for key in ("w1", "b1", "w2", "b2"):
        gathered = numpy.zeros_like(ref["grads"][key])
        for r in ranks[:n]:     # the first expert row: ranks 0 .. n-1
            lo = int(r[tag + "lo"])
            gathered[lo:lo + k] = r[tag + "grad/" + key]
        numpy.testing.assert_allclose(gathered, ref["grads"][key],
                                      err_msg=key, **GRAD_TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_expert_parallel_ranks_bit_equal(ep_runs, n):
    """Every rank holds the same output, loss, router and input gradient
    (each token's share comes from one rank, so the sums are exact); the
    ranks of each expert row hold the same expert slices as the other
    rows' ranks at the same expert index."""
    _, ranks = ep_runs
    tag = "ep%d:" % n
    for r in ranks[1:]:
        for key in ("out", "loss", "x_grad", "grad/router"):
            numpy.testing.assert_array_equal(r[tag + key],
                                             ranks[0][tag + key], key)
    for r, other in zip(ranks[:n], ranks[n:]):
        assert int(r[tag + "lo"]) == int(other[tag + "lo"])
        for key in ("w1", "b1", "w2", "b2"):
            numpy.testing.assert_array_equal(r[tag + "grad/" + key],
                                             other[tag + "grad/" + key])


@pytest.mark.parametrize("n", [2, 4])
def test_expert_parallel_sliced_tree_equals_whole(ep_runs, n):
    """A rank holding only its E/n experts (``expert_slice``, copied)
    computes the whole-tree call's output, loss, router and input
    gradients and its experts' gradients bit for bit, with n times
    fewer expert-weight bytes."""
    _, ranks = ep_runs
    tag = "ep%d:" % n
    for r in ranks:
        for key in ("out", "loss", "x_grad", "grad/router", "grad/w1",
                    "grad/b1", "grad/w2", "grad/b2"):
            numpy.testing.assert_array_equal(r[tag + "sliced/" + key],
                                             r[tag + key], key)
        assert int(r[tag + "expert_bytes"]) \
            == n * int(r[tag + "sliced/expert_bytes"])


def test_expert_slice_and_held_count_guard():
    """``expert_slice`` cuts the rank's experts and keeps the router;
    ``moe_ffn_ep`` refuses expert weights of neither E nor E/n
    experts."""
    from veles_tpu_torch.parallel import Mesh
    host, x = _moe_setup()
    mesh = Mesh(numpy.arange(2).reshape(1, 2), ("data", "expert"))
    params = _tensors(host)
    own = TM.expert_slice(params, mesh)
    assert own["router"] is params["router"]
    k = N_EXPERTS // 2
    for key in TM.EXPERT_KEYS:
        assert torch.equal(own[key], params[key][:k])
    bad = dict(params, w1=params["w1"][:1])
    with pytest.raises(ValueError, match="neither all"):
        TM.moe_ffn_ep(bad, torch.from_numpy(x), mesh)


@pytest.mark.parametrize("n", [2, 4])
def test_expert_parallel_collectives_counted(ep_runs, n):
    """One forward all-reduce of the experts' shares and one backward
    all-reduce of their input gradient a call; nothing else."""
    _, ranks = ep_runs
    tag = "ep%d:count/" % n
    for r in ranks:
        counts = {k[len(tag):]: int(v) for k, v in r.items()
                  if k.startswith(tag)}
        assert counts == {"grad_all_reduce": 0, "metric_all_reduce": 0,
                          "tp_all_gather": 0,
                          "tp_input_grad_all_reduce": 0,
                          "ep_all_reduce": 1,
                          "ep_input_grad_all_reduce": 1,
                          "p2p_exchange": 0, "stage_output_all_reduce": 0,
                          "stage_input_grad_all_reduce": 0,
                          "ring_all_gather": 0,
                          "ring_input_grad_all_reduce": 0}


# ----------------------------------------------------- the MoE transformer
def _moe_host(seed=7, n_experts=4, n_layers=2, **kwargs):
    """The reference's MoE LM param tree (vocab 16, d 32, 4 heads), the
    port's checked equal."""
    jprng.reset()
    host = JT.init_transformer_params(
        jprng.RandomGenerator("init", seed), 16, d_model=32, n_heads=4,
        n_layers=n_layers, max_len=24, n_experts=n_experts, **kwargs)
    mine = TT.init_transformer_params(
        prng.RandomGenerator("init", seed), 16, d_model=32, n_heads=4,
        n_layers=n_layers, max_len=24, n_experts=n_experts, **kwargs)
    for (ka, a), (kb, b) in zip(_flat(host), _flat(mine)):
        assert ka == kb
        numpy.testing.assert_array_equal(a, b)
    return host


def _block_routes(host, tokens, n_heads, record_property):
    """Each MoE block's routing in both packages over one forward of
    ``tokens`` (the router probabilities recorded as the blocks ask for
    them); the flips over all blocks."""
    kept = {"ref": [], "port": []}

    def recording(fn, store):
        def probs(params, x):
            p = fn(params, x)
            store.append(numpy.array(p.detach() if isinstance(
                p, torch.Tensor) else p))
            return p
        return probs

    real = (JM.router_probs, TM.router_probs)
    JM.router_probs = recording(real[0], kept["ref"])
    TM.router_probs = recording(real[1], kept["port"])
    try:
        JT.transformer_forward(jax.tree.map(jnp.asarray, host),
                               jnp.asarray(tokens), n_heads)
        with torch.no_grad():
            TT.transformer_forward(_tensors(host), torch.from_numpy(tokens),
                                   n_heads)
    finally:
        JM.router_probs, TM.router_probs = real
    assert len(kept["ref"]) == len(kept["port"]) == len(host["blocks"])
    return _routing(numpy.concatenate(kept["ref"]),
                    numpy.concatenate(kept["port"]), record_property)


LOSS_CASES = {
    "no_aux": {"moe_aux_coef": 0.0},
    "aux": {"moe_aux_coef": 1e-2},
    "aux_remat": {"moe_aux_coef": 1e-2, "remat": True},
}


@pytest.fixture(scope="module")
def moe_loss_reference():
    """The reference's lm_loss and gradients for every LOSS_CASES case
    (one compiled program): (host, tokens, mask, {case: (loss, grads)})."""
    rng = numpy.random.RandomState(1)
    tokens = rng.randint(0, 16, (3, 17)).astype(numpy.int32)
    mask = numpy.array([1.0, 1.0, 0.0], numpy.float32)
    host = _moe_host()

    @jax.jit
    def run(params):
        return {case: jax.value_and_grad(JT.lm_loss)(
            params, tokens, mask, 4, **kw) for case, kw in LOSS_CASES.items()}

    out = jax.tree.map(numpy.asarray, run(host))
    return host, tokens, mask, out


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_moe_lm_loss_and_grads_match_reference(backend, moe_loss_reference,
                                               case, record_property):
    host, tokens, mask, out = moe_loss_reference
    loss, grads = out[case]
    assert not _block_routes(host, tokens[:, :-1], 4,
                             record_property).any()
    params = _tensors(host, grad=True)
    got = TT.lm_loss(params, torch.from_numpy(tokens),
                     torch.from_numpy(mask), 4, **LOSS_CASES[case])
    got_grads = _regrid(params, torch.autograd.grad(
        got, TT.tree_leaves(params)))
    numpy.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    grad_tree = dict(_flat(got_grads))
    for name, want in _flat(grads):
        numpy.testing.assert_allclose(grad_tree[name], want, err_msg=name,
                                      **LM_GRAD_TOL)


def test_moe_aux_term_is_the_mean_block_aux():
    """lm_loss with a coefficient adds coef · (mean per-block aux over
    live tokens) to the plain NLL; remat gives the same loss."""
    host = _moe_host()
    rng = numpy.random.RandomState(1)
    tokens = torch.from_numpy(rng.randint(0, 16, (3, 17)).astype(
        numpy.int32))
    mask = torch.tensor([1.0, 1.0, 0.0])
    params = _tensors(host)
    with torch.no_grad():
        plain = TT.lm_loss(params, tokens, mask, 4)
        aux = TT.lm_loss(params, tokens, mask, 4, moe_aux_coef=0.5)
        remat = TT.lm_loss(params, tokens, mask, 4, moe_aux_coef=0.5,
                           remat=True)
        h = TT.embed_tokens(params, tokens[:, :-1])
        token_mask = mask[:, None].expand(3, 16).reshape(-1)
        auxes = []
        for blk in params["blocks"]:
            h, a = TT.block_forward(blk, h, 4, with_aux=True,
                                    token_mask=token_mask)
            auxes.append(a)
    assert remat.item() == aux.item()
    numpy.testing.assert_allclose(
        aux.item(), plain.item() + 0.5 * sum(a.item() for a in auxes) / 2,
        rtol=1e-6)


def _trainer_pair(**kwargs):
    kw = dict(vocab=16, d_model=32, n_heads=4, n_layers=2, max_len=24,
              learning_rate=3e-3, n_experts=4, moe_aux_coef=1e-2, **kwargs)
    return JT.TransformerTrainer(None, **kw), TT.TransformerTrainer(None, **kw)


def test_moe_trainer_adam_three_steps_match_reference(backend):
    """Three Adam steps of ``TransformerTrainer(n_experts=4)``'s train
    loss (the aux term in) through both packages' Adam step."""
    ref_tr, tr = _trainer_pair()
    host = _moe_host(seed=9)
    rng = numpy.random.RandomState(2)
    batches = [rng.randint(0, 16, (4, 17)).astype(numpy.int32)
               for _ in range(3)]
    mask = numpy.ones(4, numpy.float32)
    ref_step = jax.jit(JT.make_adam_train_step(ref_tr._loss_fn(True), 3e-3))
    step = TT.make_adam_train_step(tr._loss_fn(True), 3e-3)
    jp = jax.tree.map(jnp.asarray, host)
    jstate = (jax.tree.map(jnp.zeros_like, jp),
              jax.tree.map(jnp.zeros_like, jp))
    tp = _tensors(host, grad=True)
    tstate = (TT.tree_map(torch.zeros_like, _tensors(host)),
              TT.tree_map(torch.zeros_like, _tensors(host)))
    for t, tokens in enumerate(batches):
        jp, jstate, jm = ref_step(jp, jstate, jnp.asarray(tokens),
                                  jnp.asarray(mask), jnp.asarray(t))
        tp, tstate, tm = step(tp, tstate, torch.from_numpy(tokens),
                              torch.from_numpy(mask), t)
        numpy.testing.assert_allclose(tm["loss_sum"].item(),
                                      float(jm["loss_sum"]), rtol=1e-5)
    shares = _shares(tp, jp, host)
    assert max(shares.values()) <= ADAM_SHARE, shares


def test_moe_eval_loss_excludes_the_aux_term():
    """The eval loss is the pure NLL (the reference's
    ``_loss_fn(training=False)``); the train loss adds the aux term."""
    ref_tr, tr = _trainer_pair(remat=True)
    host = _moe_host()
    rng = numpy.random.RandomState(5)
    tokens = rng.randint(0, 16, (4, 17)).astype(numpy.int32)
    mask = numpy.array([1, 1, 1, 0], numpy.float32)
    jp = jax.tree.map(jnp.asarray, host)
    params = _tensors(host)
    t, m = torch.from_numpy(tokens), torch.from_numpy(mask)
    with torch.no_grad():
        got_eval = tr._loss_fn(False)(params, t, m).item()
        got_train = tr._loss_fn(True)(params, t, m).item()
        plain = TT.lm_loss(params, t, m, 4).item()
    want_eval = float(ref_tr._loss_fn(False)(jp, tokens, mask))
    want_train = float(ref_tr._loss_fn(True)(jp, tokens, mask))
    assert got_eval == plain
    numpy.testing.assert_allclose(got_eval, want_eval, rtol=1e-5)
    numpy.testing.assert_allclose(got_train, want_train, rtol=1e-5)
    assert got_train > got_eval


def _configure(cfg_root, package_prng, cfg=TINY_MOE):
    package_prng.reset()
    package_prng.seed_all(4)
    cfg_root.__dict__.pop("char_lm", None)
    cfg_root.char_lm.update(cfg)


@pytest.fixture(scope="module")
def moe_reference_run():
    """The reference's char_lm.train at TINY_MOE: per-epoch losses, the
    initial and final params, the router probabilities of every MoE
    call in order, and the workflow."""
    from veles_tpu.samples import char_lm
    _configure(jroot, jprng)
    wf = char_lm.build()
    init, calls = {}, []
    real = wf.trainer.initialize
    real_probs = JM.router_probs

    def keep_init(**kw):
        out = real(**kw)
        init["params"] = jax.tree.map(numpy.asarray, wf.trainer.params)
        return out

    def recorded(params, x):
        p = real_probs(params, x)
        jax.debug.callback(lambda v: calls.append(numpy.array(v)), p)
        return p

    wf.trainer.initialize = keep_init
    JM.router_probs = recorded
    try:
        wf.initialize()
        wf.run()
    finally:
        JM.router_probs = real_probs
    return ([{s: m[s]["loss"] for s in ("validation", "train")}
             for m in wf.decision.epoch_metrics], init["params"],
            TT.tree_map(numpy.array, wf.trainer.state_dict()["params"]),
            calls, wf)


def test_moe_char_lm_train_matches_reference(backend, moe_reference_run,
                                             record_property):
    """char_lm with 4 experts and 2 layers, loss for loss (validation
    losses without the aux term, as the reference's), each MoE call
    routed as the reference's same call."""
    from veles_tpu_torch.samples import char_lm
    losses, init, final, calls, _ = moe_reference_run
    real_route = TM._route
    at, flips, margins = [0], [], []

    def as_reference(params, flat):
        probs, _, _ = real_route(params, flat)
        want = calls[at[0]]
        at[0] += 1
        top = torch.from_numpy(want.argmax(-1))
        flipped = (probs.argmax(-1) != top).numpy()
        top2 = numpy.sort(want, axis=-1)[:, -2:]
        flips.append(int(flipped.sum()))
        margins.extend((top2[:, 1] - top2[:, 0])[flipped].tolist())
        experts = torch.arange(probs.shape[-1])
        return (probs, probs.gather(-1, top[:, None]),
                (top[:, None] == experts).to(flat.dtype))

    _configure(root, prng)
    TM._route = as_reference
    try:
        wf = char_lm.train(device="cpu")
    finally:
        TM._route = real_route
    record_property("routing_flips", sum(flips))
    record_property("flip_margins", margins)
    assert at[0] == len(calls) == 24
    assert all(m < RUN_FLIP_MARGIN for m in margins), margins
    assert wf.trainer.n_experts == 4
    assert "moe" in wf.trainer.params["blocks"][1]
    got = [{s: m[s]["loss"] for s in ("validation", "train")}
           for m in wf.decision.epoch_metrics]
    assert len(got) == len(losses) == 2
    for a, b in zip(got, losses):
        for s in a:
            numpy.testing.assert_allclose(a[s], b[s], rtol=1e-4)
    assert wf.trainer.time == 8
    shares = _shares(wf.trainer.params, final, init)
    assert max(shares.values()) <= RUN_SHARE, shares


def test_moe_state_dict_carries_across_both_ways(moe_reference_run):
    """A MoE trainer's state_dict loads from the reference's trainer into
    the port's and back, equal leaf for leaf."""
    from veles_tpu_torch.samples import char_lm as tchar
    ref = moe_reference_run[-1]
    _configure(root, prng)
    mine = tchar.build()
    mine.initialize(device="cpu")
    state = ref.trainer.state_dict()
    mine.trainer.load_state_dict(state)
    back = mine.trainer.state_dict()
    assert back["time"] == state["time"] == 8
    for part in ("params", "opt_state"):
        got, want = list(_flat(back[part])), list(_flat(state[part]))
        assert [k for k, _ in got] == [k for k, _ in want]
        assert any("/moe/w1" in k for k, _ in got)
        for (k, a), (_, b) in zip(got, want):
            numpy.testing.assert_array_equal(a, b, err_msg=k)
    ref.trainer.load_state_dict(back)
    for (k, a), (_, b) in zip(_flat(ref.trainer.state_dict()["params"]),
                              _flat(state["params"])):
        numpy.testing.assert_array_equal(a, b, err_msg=k)


def test_moe_reference_snapshot_resumes_in_port(moe_reference_run,
                                                tmp_path):
    """The reference MoE workflow's snapshot, read by the reference and
    carried across with ``state_from_reference``, restores the port's
    trainer bit for bit; the port's own snapshot of it round-trips."""
    from veles_tpu import snapshotter as jsnap
    from veles_tpu_torch import snapshotter
    from veles_tpu_torch.samples import char_lm as tchar
    ref = moe_reference_run[-1]
    path = str(tmp_path / "ref.pickle")
    jsnap.save(ref, path)
    carried = snapshotter.state_from_reference(jsnap.import_(path)["state"])
    _configure(root, prng)
    mine = tchar.build()
    mine.initialize(device="cpu")
    mine.load_snapshot_state(carried)
    want = ref.trainer.state_dict()
    assert mine.trainer.time == want["time"]
    for part in ("params", "opt_state"):
        for (k, a), (_, b) in zip(_flat(mine.trainer.state_dict()[part]),
                                  _flat(want[part])):
            numpy.testing.assert_array_equal(a, b, err_msg=k)
    own = str(tmp_path / "port.pickle")
    snapshotter.save(mine, own)
    _configure(root, prng)
    again = tchar.build()
    again.initialize(device="cpu")
    snapshotter.restore(again, own)
    for (k, a), (_, b) in zip(_flat(again.trainer.state_dict()["params"]),
                              _flat(want["params"])):
        numpy.testing.assert_array_equal(a, b, err_msg=k)


def test_moe_cli_trains_char_lm():
    """``python -m veles_tpu_torch veles_tpu_torch.samples.char_lm
    root.char_lm.trainer.n_experts=4`` (in process, on the CPU, at
    TINY_MOE's sizes) trains the same run as ``char_lm.train``."""
    from veles_tpu_torch import __main__ as cli
    from veles_tpu_torch.samples import char_lm
    sizes = ["root.char_lm.%s.%s=%r" % (section, k, v)
             for section, kv in TINY_MOE.items() for k, v in kv.items()
             if k not in ("n_experts", "moe_aux_coef")]
    root.__dict__.pop("char_lm", None)
    prng.reset()
    try:
        assert cli.main(["veles_tpu_torch.samples.char_lm", "-d", "cpu",
                         "--random-seed", "4", "--no-stats",
                         "root.char_lm.trainer.n_experts=4", *sizes]) == 0
        wf = cli.main.workflow
        got = [m["validation"]["loss"] for m in wf.decision.epoch_metrics]
        assert wf.trainer.n_experts == 4 and wf.trainer.time == 8
    finally:
        cli.main.workflow = cli.main.launcher = None
    _configure(root, prng)
    direct = char_lm.train(device="cpu")
    assert got == [m["validation"]["loss"]
                   for m in direct.decision.epoch_metrics]


# ------------------------------------------------------- serving a MoE LM
@pytest.mark.parametrize("prompt,n_new,kw", [
    ([[1, 2, 3], [4, 5, 6]], 8, {}),
    ([[1, 2, 3, 4, 5, 0, 0, 0], [9, 8, 7, 6, 5, 0, 0, 0]], 6,
     {"max_len": 16, "true_len": 5}),
])
def test_moe_greedy_generate_equals_reference(backend, prompt, n_new, kw):
    host = _moe_host(seed=13)
    want = numpy.asarray(JT.generate(jax.tree.map(jnp.asarray, host),
                                     jnp.asarray(prompt, jnp.int32), n_new,
                                     4, temperature=0, **kw))
    got = TT.generate(_tensors(host), torch.tensor(prompt, dtype=torch.int32),
                      n_new, 4, temperature=0, **kw)
    numpy.testing.assert_array_equal(got.numpy(), want)


def test_moe_paged_chunk_apply_matches_reference(record_property):
    """The paged serving step carries the MoE FFN unchanged (hidden
    states and logits at rtol 1e-5 / atol 1e-5, as the dense model's)."""
    host = _moe_host(n_kv_heads=2)
    rng = numpy.random.RandomState(2)
    page, m, n_pages, b, c = 8, 3, 7, 2, 3
    tokens = rng.randint(0, 16, (b, c)).astype(numpy.int32)
    pools = [(rng.randn(n_pages, 2, page, 8).astype(numpy.float32),
              rng.randn(n_pages, 2, page, 8).astype(numpy.float32))
             for _ in range(2)]
    ptab = rng.permutation(n_pages)[:b * m].reshape(b, m).astype(
        numpy.int32)
    pos = numpy.asarray([4, 17], numpy.int32)
    want_h, _ = JT.paged_chunk_apply(
        jax.tree.map(jnp.asarray, host), jnp.asarray(tokens),
        [tuple(map(jnp.asarray, pr)) for pr in pools], jnp.asarray(ptab),
        jnp.asarray(pos), 4)
    params = TT.params_from_jax(host, "cpu")
    got_h, _ = TT.paged_chunk_apply(
        params, torch.from_numpy(tokens),
        [tuple(torch.from_numpy(a.copy()) for a in pr) for pr in pools],
        torch.from_numpy(ptab), torch.from_numpy(pos), 4)
    numpy.testing.assert_allclose(got_h.numpy(), numpy.asarray(want_h),
                                  rtol=1e-5, atol=1e-5)
    numpy.testing.assert_allclose(
        TT.head_logits(params, got_h).numpy(),
        numpy.asarray(JT.head_logits(jax.tree.map(jnp.asarray, host),
                                     want_h)), rtol=1e-5, atol=1e-5)


def test_moe_params_from_jax_carry_the_moe_subtree():
    host = _moe_host()
    model = TT.TransformerLM.from_jax(host, device="cpu")
    names = {n for n, _ in model.named_parameters()}
    assert {"blocks.0.moe.router", "blocks.1.moe.w1",
            "blocks.1.moe.b2"} <= names
    assert not any(n.endswith((".w1", ".w2")) and ".moe." not in n
                   for n in names)
    back = dict(_flat(model.tree()))
    for key, want in _flat(host):
        numpy.testing.assert_array_equal(back[key], want)


def test_moe_engine_greedy_tokens_equal_reference():
    """``LMEngine`` (paged, 2 slots, chunked prefill) serves a MoE model
    on the CPU with the reference ``generate``'s greedy tokens."""
    from veles_tpu_torch.serving import LMEngine
    prng.reset()
    host = TT.init_transformer_params(prng.RandomGenerator("init", 7), 32,
                                      d_model=32, n_heads=4, n_layers=2,
                                      max_len=64, n_experts=4)
    rng = numpy.random.RandomState(11)
    requests = [(3, 5), (17, 8), (12, 6)]
    prompts = [rng.randint(0, 32, n).astype(numpy.int32)
               for n, _ in requests]
    params = jax.tree.map(jnp.asarray, host)
    want = []
    for p, (n, k) in zip(prompts, requests):
        toks = numpy.asarray(JT.generate(params, jnp.asarray(p[None]), k, 4,
                                         temperature=0.0, max_len=64))[0]
        want.append(toks[n:])
    engine = LMEngine(TT.TransformerLM.from_jax(host, device="cpu"), 4, 64,
                      slots=2, paged_kv=True, prefill_chunk=8,
                      device="cpu")
    engine.start()
    try:
        futures = [engine.submit(p, k) for p, (_, k) in zip(prompts,
                                                            requests)]
        got = [f.result(timeout=120) for f in futures]
    finally:
        engine.stop()
    for g, w in zip(got, want):
        numpy.testing.assert_array_equal(g, w)
