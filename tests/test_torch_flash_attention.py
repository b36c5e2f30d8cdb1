"""The port's training attention against ``veles_tpu.ops.attention``.

The bundled TPU flash kernel has no CPU lowering, so the oracle is the
reference's dense ``attention`` and ``jax.vjp`` of it (as
``tests/test_pallas.py`` holds the bundled kernel on a TPU).  On the CPU
the port's flash wrappers run their plain versions, so these tests hold
the arithmetic of kernels 7a–7c (scores, mask, log-sum-exp residual,
the dS = P(dP − di) backward) to the reference; the card tests
(``test_torch_cuda.py``) hold the kernels to those plain versions.

Tolerances.  fp32 throughout, two frameworks' matmuls and softmaxes
summing in different orders: rtol 1e-5 / atol 1e-5 on outputs and
gradients, which are O(1) here.  The scale also differs in the last
place: ``flash_attention_tpu`` multiplies by float(1/√dh) while
``attention`` divides by √dh; the two agree exactly at dh = 16, 64 and
256, and at dh = 8 or 40 a score moves by at most an ulp.  The peaked
case (scores reaching ±100) carries 8e-6 of roundoff per score, so its
limit scales with each output's largest value.  Blockwise attention
repeats the reference's block order: rtol/atol 1e-5.
"""

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

from veles_tpu import prng as jprng
from veles_tpu.ops import attention as JA
from veles_tpu_torch import prng
from veles_tpu_torch.ops import attention as TA
from veles_tpu_torch.ops import hopper_kernels as HK

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU products run fastest single-threaded (and several test
    workers share the host's cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(seed, b, h, s, dh, peak=1.0):
    rng = numpy.random.RandomState(seed)
    q, k, v, do = (rng.randn(b, h, s, dh).astype(numpy.float32)
                   for _ in range(4))
    return q * numpy.float32(peak), k, v, do


def _attention_vjp(q, k, v, do, causal):
    out, vjp = jax.vjp(lambda a, b_, c: JA.attention(a, b_, c,
                                                     causal=causal), q, k, v)
    return out, vjp(do)


def _peaked_inputs():
    """Scores reaching ±100 (a nearly one-hot softmax)."""
    q, k, v, do = _inputs(7, 2, 3, 40, 16)
    peak = 100.0 / numpy.abs(q @ k.transpose(0, 1, 3, 2) / 4.0).max()
    return (q * peak).astype(numpy.float32), k, v, do


VJP_GEOMETRIES = [(16, 8), (16, 16), (40, 40), (128, 16), (40, 8), (128, 40)]
#: every case held to the reference's attention and its vjp:
#: name -> ((q, k, v, do), causal)
VJP_CASES = dict(
    [("%d-%d-%s" % (s, dh, causal), (_inputs(s * dh, 2, 3, s, dh), causal))
     for causal in (True, False) for s, dh in VJP_GEOMETRIES]
    + [("peaked", (_peaked_inputs(), True)),
       ("faults", (_inputs(5, 2, 3, 40, 40), True))])


@pytest.fixture(scope="module")
def reference():
    """The reference's attention output and (dq, dk, dv) for every case
    of VJP_CASES, from one compiled program (XLA compiles it about 3x
    faster than one program per geometry)."""
    causal = {name: c for name, (_, c) in VJP_CASES.items()}

    @jax.jit
    def run(inputs):
        return {name: _attention_vjp(*args, causal[name])
                for name, args in inputs.items()}

    out = run({name: args for name, (args, _) in VJP_CASES.items()})
    return {name: (numpy.asarray(o), [numpy.asarray(g) for g in grads])
            for name, (o, grads) in out.items()}


def _port(q, k, v, do, causal):
    """The port's FlashAttention (plain versions on the CPU): output and
    autograd (dq, dk, dv)."""
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = HK.FlashAttention.apply(*leaves, causal, None)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,dh", VJP_GEOMETRIES)
def test_flash_matches_reference_attention_and_vjp(reference, s, dh,
                                                    causal):
    name = "%d-%d-%s" % (s, dh, causal)
    q, k, v, do = VJP_CASES[name][0]
    want, want_grads = reference[name]
    got, grads = _port(q, k, v, do, causal)
    numpy.testing.assert_allclose(got, want, **TOL)
    for g, w in zip(grads, want_grads):
        numpy.testing.assert_allclose(g, w, **TOL)
    o, lse = HK.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                    causal)
    numpy.testing.assert_allclose(o.numpy(), want, **TOL)
    assert lse.shape == (2, 3, s)


def test_flash_peaked_scores(reference):
    want, want_grads = reference["peaked"]
    got, grads = _port(*VJP_CASES["peaked"][0], True)
    for g, w in zip([got] + grads, [want] + want_grads):
        assert numpy.isfinite(g).all()
        limit = 1e-4 * max(numpy.abs(w).max(), 1.0)
        assert numpy.abs(g - w).max() <= limit


def _backward_matches(name, grads, want_grads):
    for g, w in zip(grads, want_grads):
        if name == "peaked":
            assert numpy.isfinite(g).all()
            assert numpy.abs(g - w).max() <= 1e-4 * max(numpy.abs(w).max(),
                                                        1.0)
        else:
            numpy.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("form", ["di_passed", "di_formed"])
@pytest.mark.parametrize("name", [n for n in VJP_CASES if n != "faults"])
def test_backward_wrappers_match_reference_vjp(reference, name, form):
    """The two backward wrappers called directly, with di handed in (as
    FlashAttention.backward does) or formed by each wrapper from o and
    do, against jax.vjp of the reference's attention."""
    (q, k, v, do), causal = VJP_CASES[name]
    q, k, v, do = (torch.from_numpy(t) for t in (q, k, v, do))
    o, lse = HK.flash_attention_fwd(q, k, v, causal)
    kw = {"di": HK.flash_attention_di(o, do)} if form == "di_passed" else {}
    dk, dv = HK.flash_attention_bwd_dkv(q, k, v, o, lse, do, causal, **kw)
    dq = HK.flash_attention_bwd_dq(q, k, v, o, lse, do, causal, **kw)
    _backward_matches(name, [g.numpy() for g in (dq, dk, dv)],
                      reference[name][1])


@pytest.mark.parametrize("name", ["16-8-True", "40-40-False", "128-40-True",
                                  "peaked"])
def test_backward_forms_di_once_as_the_reference(monkeypatch, reference,
                                                 name):
    """FlashAttention.backward forms di once and hands the same tensor to
    both wrappers; it equals the reference's jnp.sum(o * do, axis=-1) on
    the same o and do (the bundled kernel's _flash_attention_bwd forms it
    so in XLA), and the gradients still match jax.vjp."""
    calls = []

    def spy(fn):
        def call(*args, **kw):
            calls.append((args, kw))
            return fn(*args, **kw)
        return call

    for wrapper in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        monkeypatch.setattr(HK, wrapper, spy(getattr(HK, wrapper)))
    _, grads = _port(*VJP_CASES[name][0], VJP_CASES[name][1])
    assert len(calls) == 2 and calls[0][1]["di"] is calls[1][1]["di"]
    args, kw = calls[0]
    o, do = (args[i].detach().numpy() for i in (3, 5))
    want = numpy.asarray(jnp.sum(jnp.asarray(o) * jnp.asarray(do), axis=-1))
    numpy.testing.assert_allclose(kw["di"].detach().numpy(), want,
                                  rtol=1e-6, atol=1e-6)
    _backward_matches(name, grads, reference[name][1])


def test_backward_wrappers_check_di_shape():
    q, lse = torch.zeros(1, 2, 8, 4), torch.zeros(1, 2, 8)
    for wrapper in (HK.flash_attention_bwd_dkv, HK.flash_attention_bwd_dq):
        with pytest.raises(ValueError, match="does not match"):
            wrapper(q, q, q, q, lse, q, di=lse[..., :4])


BAND_CASES = [(8, False, None, 0), (8, True, None, 0), (16, True, 12, 0),
              (8, True, 10, 3), (32, True, None, 0)]


@pytest.fixture(scope="module")
def band_reference():
    """The reference's blockwise_attention and attention for every case
    of BAND_CASES, from one compiled program: {(case, name): output}."""
    cases = {case: _inputs(case[0] + (case[2] or 0), 2, 2, 32, 16)[:3]
             for case in BAND_CASES}

    @jax.jit
    def run(inputs):
        out = {}
        for (block, causal, window, sinks) in BAND_CASES:
            args = inputs["%d-%s-%s-%d" % (block, causal, window, sinks)]
            kw = dict(causal=causal, window=window, sinks=sinks)
            out["%d-%s-%s-%d-blockwise" % (block, causal, window, sinks)] = \
                JA.blockwise_attention(*args, block, **kw)
            out["%d-%s-%s-%d-dense" % (block, causal, window, sinks)] = \
                JA.attention(*args, **kw)
        return out

    out = run({"%d-%s-%s-%d" % case: args for case, args in cases.items()})
    return cases, {k: numpy.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("block,causal,window,sinks", BAND_CASES)
def test_blockwise_and_dense_match_reference(band_reference, block, causal,
                                             window, sinks):
    cases, want = band_reference
    case = (block, causal, window, sinks)
    args = [torch.from_numpy(t) for t in cases[case]]
    kw = dict(causal=causal, window=window, sinks=sinks)
    numpy.testing.assert_allclose(
        TA.blockwise_attention(*args, block, **kw).numpy(),
        want["%d-%s-%s-%d-blockwise" % case], **TOL)
    numpy.testing.assert_allclose(TA.attention(*args, **kw).numpy(),
                                  want["%d-%s-%s-%d-dense" % case], **TOL)


def _mha_params(n_kv_heads, seed=3):
    jprng.reset()
    prng.reset()
    host = JA.init_mha_params(jprng.RandomGenerator("init", seed), 32, 4,
                              n_kv_heads=n_kv_heads)
    mine = TA.init_mha_params(prng.RandomGenerator("init", seed), 32, 4,
                              n_kv_heads=n_kv_heads)
    for key in host:
        numpy.testing.assert_array_equal(mine[key], host[key])
    return host


@pytest.fixture
def flash_backend():
    TA.set_attention_backend("flash_pallas")
    yield
    TA.set_attention_backend("xla")


MHA_CASES = [(False, None), (True, None), (False, 1), (True, 1)]


@pytest.fixture(scope="module")
def mha_reference():
    """The reference's mha_forward under 'xla' for every case of
    MHA_CASES, with its vjp, from one compiled program: {case: (params,
    x, dy, out, (g_params, g_x))} with numpy leaves."""
    rng = numpy.random.RandomState(11)
    x = rng.randn(2, 24, 32).astype(numpy.float32)
    dy = rng.randn(2, 24, 32).astype(numpy.float32)
    hosts = {"%s-%s" % case: _mha_params(case[1]) for case in MHA_CASES}

    @jax.jit
    def run(params):
        out = {}
        for rope, n_kv_heads in MHA_CASES:
            name = "%s-%s" % (rope, n_kv_heads)
            y, vjp = jax.vjp(lambda p, a: JA.mha_forward(p, a, 4, rope=rope),
                             params[name], x)
            out[name] = (y, vjp(dy))
        return out

    out = jax.tree.map(numpy.asarray, run(hosts))
    return {case: (hosts["%s-%s" % case], x, dy) + out["%s-%s" % case]
            for case in MHA_CASES}


@pytest.mark.parametrize("rope,n_kv_heads", MHA_CASES)
def test_mha_forward_flash_matches_reference_xla(flash_backend,
                                                 mha_reference, rope,
                                                 n_kv_heads):
    """The port under 'flash_pallas' (FlashAttention, GQA through
    _repeat_kv) against the reference under 'xla': output and the
    gradients of x and of every weight."""
    host, x, dy, out, (g_params, g_x) = mha_reference[(rope, n_kv_heads)]
    params = {k: torch.from_numpy(v).requires_grad_()
              for k, v in host.items()}
    xt = torch.from_numpy(x).requires_grad_()
    before = HK.launch_counts()
    got = TA.mha_forward(params, xt, 4, rope=rope)
    grads = torch.autograd.grad(got, [xt] + list(params.values()),
                                torch.from_numpy(dy))
    # the plain versions ran (CPU tensors): nothing was launched
    assert HK.launch_counts() == before
    numpy.testing.assert_allclose(got.detach().numpy(), numpy.asarray(out),
                                  **TOL)
    numpy.testing.assert_allclose(grads[0].numpy(), numpy.asarray(g_x),
                                  **TOL)
    for key, g in zip(params, grads[1:]):
        numpy.testing.assert_allclose(g.numpy(),
                                      numpy.asarray(g_params[key]), **TOL)


def test_window_and_sinks_route_away_from_flash():
    """A window (with or without sinks) takes the band path under
    'flash_pallas', bit-equal to 'xla'; 'flash_serve' keeps mha_forward
    on 'xla' and only flips serving_kernel_default."""
    host = _mha_params(None)
    params = {k: torch.from_numpy(v) for k, v in host.items()}
    x = torch.from_numpy(numpy.random.RandomState(0).randn(2, 16, 32)
                         .astype(numpy.float32))
    ref_window = TA.mha_forward(params, x, 4, window=8, sinks=2)
    ref_block = TA.mha_forward(params, x, 4, block_size=8, window=8)
    ref_plain = TA.mha_forward(params, x, 4)
    calls = []
    real = TA.flash_attention
    TA.flash_attention = lambda *a, **kw: calls.append(1) or real(*a, **kw)
    try:
        TA.set_attention_backend("flash_pallas")
        assert torch.equal(TA.mha_forward(params, x, 4, window=8, sinks=2),
                           ref_window)
        assert torch.equal(TA.mha_forward(params, x, 4, block_size=8,
                                          window=8), ref_block)
        assert not calls
        TA.mha_forward(params, x, 4)
        assert calls == [1]
        TA.set_attention_backend("flash_serve")
        assert TA.serving_kernel_default()
        assert torch.equal(TA.mha_forward(params, x, 4), ref_plain)
        assert calls == [1]
    finally:
        TA.flash_attention = real
        TA.set_attention_backend("xla")
    assert not TA.serving_kernel_default()
    with pytest.raises(ValueError, match="unknown attention backend"):
        TA.set_attention_backend("pallas")


# ------------------------------------------------------- faulty versions
def _faulty_forward(q, k, v):
    """The causal mask as col < row: the diagonal key dropped (row 0 is
    left with no key at all)."""
    s = torch.matmul(q, k.transpose(-1, -2)) * float(1 / q.shape[-1] ** 0.5)
    rows = torch.arange(q.shape[-2])[:, None]
    s = s.masked_fill(torch.arange(k.shape[-2])[None, :] >= rows,
                      float("-inf"))
    return torch.matmul(torch.softmax(s, dim=-1), v)


def _faulty_backward(q, k, v, do, fault):
    """The plain backward with one fault: 'no_di' drops di from dS,
    'dq_unscaled' leaves dQ without sm_scale.  Returns (dq, dk, dv)."""
    scale = float(1 / q.shape[-1] ** 0.5)
    o, lse = HK.flash_attention_ref(q, k, v, True)
    p = torch.exp(HK._flash_scores(q, k, True, scale) - lse[..., None])
    dp = torch.matmul(do, v.transpose(-1, -2))
    di = 0.0 if fault == "no_di" else (o * do).sum(-1)[..., None]
    ds = p * (dp - di)
    dq = torch.matmul(ds, k) * (1.0 if fault == "dq_unscaled" else scale)
    return (dq, torch.matmul(ds.transpose(-1, -2), q) * scale,
            torch.matmul(p.transpose(-1, -2), do))


def _outside(got, want):
    """Elements outside the limits (NaN counts as outside)."""
    return int((~numpy.isclose(got, want, **TOL)).sum())


@pytest.mark.parametrize("fault", ["col_lt_row", "no_di", "dq_unscaled"])
def test_faulty_plain_versions_fail_the_limits(reference, fault):
    q, k, v, do = VJP_CASES["faults"][0]
    want, want_grads = reference["faults"]
    args = [torch.from_numpy(t) for t in (q, k, v, do)]
    if fault == "col_lt_row":
        assert _outside(_faulty_forward(*args[:3]).numpy(), want) > 0
        return
    dq, dk, dv = (g.numpy() for g in _faulty_backward(*args, fault))
    assert _outside(dq, want_grads[0]) > 0
    if fault == "no_di":
        assert _outside(dk, want_grads[1]) > 0
    numpy.testing.assert_allclose(dv, want_grads[2], **TOL)
