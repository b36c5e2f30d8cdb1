"""The port's ring attention (``veles_tpu_torch.parallel.ring``) on four
gloo CPU ranks (``tests/torch_ring_worker.py``, one launch for every
case) against ``veles_tpu.parallel.ring`` on the suite's virtual CPU
mesh and the reference's dense ``attention``, at the reference tests'
cases (``tests/test_attention.py``: batch 2, 2 heads, seq 32, head_dim
8; causal and not, on (data 2, seq 2) and (1, 4) grids; windows 1, 5,
12 and 999; window 5 with sinks 3 and window 2 with sinks 1) and its
injected-forward case (``tests/test_transformer.py::TestRingLMForward``).

Tolerances are the reference's own: values rtol 1e-4 / atol 1e-5
(``TestRingAttention.test_matches_dense``), gradients rtol 1e-3 / atol
1e-4 (``test_grad_flows_through_ring``), the injected forward rtol 1e-3
/ atol 1e-4.  The ranks hold the global output and gradients, bit-equal
to each other; the skipped attends are counted exactly.
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
from veles_tpu.ops import attention as JA
from veles_tpu.ops import transformer as JT
from veles_tpu.parallel import ring as JR

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)

import torch_ring_worker as worker  # noqa: E402

WORLD = 4
VALUE_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)
LM_TOL = dict(rtol=1e-3, atol=1e-4)
CASES = sorted(worker.CASES)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], "%s/%s" % (prefix, k) if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, "%s/%d" % (prefix, i))
    else:
        yield prefix, numpy.asarray(tree)


def _reference(q, k, v, host, tokens):
    """{case: (ring out, (dq, dk, dv), dense out)} and the injected LM
    forward's (ring logits, dense logits), from the reference."""
    devices = jax.devices("cpu")
    meshes = {dp: JR.make_seq_mesh(WORLD, data_parallel=dp,
                                   devices=devices[:WORLD])
              for dp in (1, 2)}
    q, k, v = map(jnp.asarray, (q, k, v))

    @jax.jit
    def rings(q, k, v):
        """Every case's ring output and gradients, one compiled program
        (eager shard_map gradients compile per call)."""
        out = {}
        for name, (dp, causal, window, sinks) in worker.CASES.items():
            def ring(q_, k_, v_, mesh=meshes[dp], causal=causal,
                     window=window, sinks=sinks):
                return JR.ring_attention(q_, k_, v_, mesh, causal=causal,
                                         window=window, sinks=sinks)

            out[name] = (ring(q, k, v), jax.grad(
                lambda *a, ring=ring: (ring(*a) ** 2).sum(),
                argnums=(0, 1, 2))(q, k, v))
        return out

    out = {}
    for name, (ring, grads) in rings(q, k, v).items():
        _, causal, window, sinks = worker.CASES[name]
        dense = JA.attention(q, k, v, causal=causal, window=window,
                             sinks=sinks)
        out[name] = (numpy.asarray(ring), [numpy.asarray(g) for g in grads],
                     numpy.asarray(dense))
    # tests/test_transformer.py::TestRingLMForward, on its (1, 8) mesh
    mesh = JR.make_seq_mesh(8, data_parallel=1, devices=devices[:8])
    from veles_tpu.ops.functional import matmul

    def ring_attn(p, x):
        b, s, d = x.shape

        def split(w):
            return matmul(x, w).reshape(b, s, 2, d // 2).transpose(0, 2, 1, 3)

        qq, kk, vv = (split(p[key]) for key in ("wq", "wk", "wv"))
        o = JR.ring_attention(qq, kk, vv, mesh, causal=True)
        return matmul(o.transpose(0, 2, 1, 3).reshape(b, s, d), p["wo"])

    params = jax.tree.map(jnp.asarray, host)
    lm = (numpy.asarray(JT.transformer_forward(params, jnp.asarray(tokens),
                                               2, attn_fn=ring_attn)),
          numpy.asarray(JT.transformer_forward(params, jnp.asarray(tokens),
                                               2)))
    return out, lm


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, [rank 0's npz, ...]): the workers run while
    the reference computes."""
    rs = numpy.random.RandomState(0)
    q, k, v = (rs.randn(2, 2, 32, 8).astype(numpy.float32) for _ in range(3))
    jprng.reset()
    jprng.seed_all(1)
    host = JT.init_transformer_params(jprng.get("init"), vocab=16,
                                      d_model=16, n_heads=2, n_layers=1,
                                      max_len=64)
    tokens = numpy.random.RandomState(0).randint(0, 16, (2, 64))
    tmp = tmp_path_factory.mktemp("ring")
    inputs = str(tmp / "inputs.npz")
    numpy.savez(inputs, q=q, k=k, v=v, tokens=tokens,
                **{"lm/" + name: a for name, a in _flat(host)})
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_ring_worker.py"),
         str(port), str(WORLD), str(r), inputs, str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO) for r in range(WORLD)]
    errs = []
    try:
        ref = _reference(q, k, v, host, tokens)
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
             for r in range(WORLD)]
    return (q, k, v), ref, ranks


@pytest.mark.parametrize("case", CASES)
def test_ring_matches_reference_and_dense(runs, case):
    """Every rank's global output equals the reference's ring and its
    dense attention, and the ranks agree bit for bit."""
    _, (ref, _), ranks = runs
    ring, _, dense = ref[case]
    for r in ranks:
        numpy.testing.assert_allclose(r[case + ":out"], ring, **VALUE_TOL)
        numpy.testing.assert_allclose(r[case + ":out"], dense, **VALUE_TOL)
        numpy.testing.assert_array_equal(r[case + ":out"],
                                         ranks[0][case + ":out"])


@pytest.mark.parametrize("case", CASES)
def test_ring_gradients_match_reference(runs, case):
    """dq, dk, dv of sum(out²) against ``jax.grad`` of the reference's
    ring, on every rank (bit-equal across ranks)."""
    _, (ref, _), ranks = runs
    _, grads, _ = ref[case]
    for r in ranks:
        for n, want in zip("qkv", grads):
            got = r["%s:d%s" % (case, n)]
            numpy.testing.assert_allclose(got, want, err_msg=n, **GRAD_TOL)
            numpy.testing.assert_array_equal(
                got, ranks[0]["%s:d%s" % (case, n)])


@pytest.mark.parametrize("case", CASES)
def test_ring_local_block_equals_dense_block(runs, case):
    """A rank's ``ring_attention_local`` output is its (data, seq) block
    of the dense output."""
    _, (ref, _), ranks = runs
    dp = worker.CASES[case][0]
    dense = ref[case][2]
    n_seq = WORLD // dp
    b, s = dense.shape[0] // dp, dense.shape[2] // n_seq
    for rank, r in enumerate(ranks):
        i, j = divmod(rank, n_seq)
        numpy.testing.assert_allclose(
            r[case + ":local"], dense[i * b:(i + 1) * b, :,
                                      j * s:(j + 1) * s], **VALUE_TOL)


def _live_blocks(seq_rank, n, s_local, causal, window, sinks):
    """Key blocks holding a live (query, key) pair for the queries of
    ``seq_rank``, counted pair by pair from the band's definition."""
    if not causal:
        return n
    qs = numpy.arange(seq_rank * s_local, (seq_rank + 1) * s_local)
    live = 0
    for src in range(n):
        ks = numpy.arange(src * s_local, (src + 1) * s_local)
        ok = qs[:, None] >= ks[None, :]
        if window:
            ok &= ((qs[:, None] - ks[None, :] < window)
                   | (ks[None, :] < sinks))
        live += bool(ok.any())
    return live


@pytest.mark.parametrize("case", CASES)
def test_ring_skip_counts(runs, case):
    """The attends the early exit skips, per rank: exactly the key
    blocks with no live pair."""
    _, _, ranks = runs
    dp, causal, window, sinks = worker.CASES[case]
    n = WORLD // dp
    for rank, r in enumerate(ranks):
        want = _live_blocks(rank % n, n, 32 // n, causal, window, sinks)
        assert int(r[case + ":attends"]) == want
        assert int(r[case + ":skipped"]) == n - want


def test_ring_collectives_counted(runs):
    """One exchange a rotation (n − 1 forward, n backward), one
    all-gather a mesh axis of more than one rank, and one input-gradient
    all-reduce a tensor and such axis."""
    _, _, ranks = runs
    rot = gather = reduce = 0
    for dp, *_ in worker.CASES.values():
        n, axes = WORLD // dp, (dp > 1) + 1
        rot += (n - 1) + n + (n - 1)       # ring, its backward, the local
        gather += axes
        reduce += 3 * axes
    rot += WORLD - 1                        # the injected forward
    gather += 1
    for r in ranks:
        assert r["counts"].tolist() == [rot, gather, reduce]


def test_ring_in_transformer_forward(runs):
    """The ring injected as ``attn_fn`` into ``transformer_forward``
    equals the reference's injected forward and the dense one."""
    _, (_, (ring_logits, dense_logits)), ranks = runs
    for r in ranks:
        numpy.testing.assert_allclose(r["lm:logits"], ring_logits, **LM_TOL)
        numpy.testing.assert_allclose(r["lm:logits"], dense_logits, **LM_TOL)


def test_ring_window_requires_causal():
    """The reference's ValueError, on a one-process mesh."""
    from veles_tpu_torch.parallel import ring
    mesh = ring.make_seq_mesh()
    q = torch.zeros(1, 1, 8, 4)
    with pytest.raises(ValueError, match="causal"):
        ring.ring_attention(q, q, q, mesh, causal=False, window=2)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        ring.make_seq_mesh(2)
