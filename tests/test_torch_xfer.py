"""The port's transfer shims and transfer-guard witness
(``veles_tpu_torch/serving/xfer.py``), the twins of
``tests/test_lint.py::TestTransferGuardWitness`` that run on the CPU.

The guard sets the card's process-wide ``torch.cuda.set_sync_debug_mode``,
which initializes CUDA, so here it is checked with the setter and getter
monkeypatched: the unarmed guard is inert, an unknown mode is refused,
the shims round-trip under the armed guard, a CPU device's guard never
touches the mode, and the count of open guards and boundaries puts the
prior mode back through nested and concurrent use from two threads.
Pins: the engine's and the batcher's hot paths move data only through
the shims (``tests/test_lint.py:577-600`` is the batcher's in the
reference).  The card's half is ``tests/test_torch_cuda.py -k guard``.
"""

import ast
import sys
import threading
from pathlib import Path

import numpy
import pytest
import torch

from veles_tpu_torch import prng
from veles_tpu_torch.ops import transformer as TT
from veles_tpu_torch.serving import LMEngine, MicroBatcher, lockcheck, xfer

SERVING = Path(__file__).resolve().parent.parent / "veles_tpu_torch" / \
    "serving"


@pytest.fixture(autouse=True)
def _disarmed():
    yield
    xfer.disarm()
    assert (xfer._guards, xfer._boundaries) == (0, 0)


@pytest.fixture
def card_mode(monkeypatch):
    """The card's sync debug mode as a host value: the setter and getter
    patched, every set recorded in ``card_mode["sets"]``."""
    state = {"mode": 1, "sets": []}

    def set_mode(mode):
        state["sets"].append(mode)
        state["mode"] = mode
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: state["mode"])
    return state


def test_unarmed_guard_is_inert(card_mode):
    assert not xfer.armed()
    with xfer.guard():
        with xfer.boundary():
            pass
    with xfer.guard("cuda"):
        pass
    assert card_mode["sets"] == []


def test_arm_rejects_unknown_mode():
    with pytest.raises(ValueError):
        xfer.arm("explode")
    assert not xfer.armed()
    xfer.arm("log")
    with pytest.raises(ValueError):
        xfer.arm("error")        # the torch name is not an armed mode
    assert xfer._mode == "log"


def test_explicit_shims_pass_under_armed_guard():
    xfer.arm("disallow")
    with xfer.guard("cpu"):
        dev = xfer.to_device([1, 2, 3], numpy.int32, "cpu")
        host = xfer.to_host(dev)
        tree = xfer.to_host({"a": dev, "b": [dev * 2, 5]})
    assert dev.dtype == torch.int32 and dev.device.type == "cpu"
    assert list(host) == [1, 2, 3]
    assert isinstance(host, numpy.ndarray)
    numpy.testing.assert_array_equal(tree["b"][0], [2, 4, 6])
    assert tree["b"][1] == 5 and isinstance(tree["b"], list)
    assert xfer.to_device(7, numpy.int32, "cpu").shape == ()
    ptab = numpy.arange(12, dtype=numpy.int32).reshape(3, 4)
    narrow = xfer.to_device(ptab[:, :2], numpy.int32, "cpu")
    assert narrow.is_contiguous() and narrow.tolist() == ptab[:, :2].tolist()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks a CPU build")
def test_to_device_defaults_to_the_card():
    """``device=None`` means the card, by the port's rule: it raises on a
    machine without one."""
    with pytest.raises((RuntimeError, AssertionError)):
        xfer.to_device([1, 2], numpy.int32)


def test_cpu_guard_never_touches_the_mode(card_mode):
    xfer.arm("disallow")
    with xfer.guard("cpu"):
        with xfer.boundary():
            xfer.to_host(torch.ones(2))
        with xfer.guard(torch.device("cpu")):
            pass
    assert card_mode["sets"] == [] and card_mode["mode"] == 1


def test_depth_bookkeeping_nested(card_mode):
    """Nested guards and boundaries: the mode is "error" (2) exactly
    while a guard is open and no boundary is, and the last guard out
    puts back the prior mode (1)."""
    xfer.arm("disallow")
    seen = []
    with xfer.boundary():                 # no guard yet: nothing set
        seen.append(card_mode["mode"])
        with xfer.guard("cuda"):          # a boundary is open
            seen.append(card_mode["mode"])
        seen.append(card_mode["mode"])
    with xfer.guard("cuda"):
        seen.append(card_mode["mode"])
        with xfer.guard("cuda"):
            with xfer.boundary():
                seen.append(card_mode["mode"])
                with xfer.boundary():
                    seen.append(card_mode["mode"])
                seen.append(card_mode["mode"])
            seen.append(card_mode["mode"])
        seen.append(card_mode["mode"])
    seen.append(card_mode["mode"])
    assert seen == [1, 1, 1, 2, 1, 1, 1, 2, 2, 1]
    assert card_mode["sets"] == [2, 1, 2, 1]
    xfer.arm("log")
    with xfer.guard("cuda"):
        assert card_mode["mode"] == 1     # "warn" is the prior already
    xfer.arm("allow")
    with xfer.guard("cuda"):
        assert card_mode["mode"] == 0
    assert card_mode["mode"] == 1


def test_depth_bookkeeping_two_threads(card_mode, monkeypatch):
    """One thread's guard and another's boundary in lockstep, then eight
    threads opening both at random with a short switch interval: every
    set is the mode the open counts call for, and the prior mode comes
    back when all are done."""
    xfer.arm("disallow")
    states, seen = [], {}
    real_set = torch.cuda.set_sync_debug_mode

    def checked_set(mode):
        states.append((mode, xfer._guards, xfer._boundaries))
        real_set(mode)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", checked_set)
    a_in, b_in, a_out = (threading.Event() for _ in range(3))

    def thread_a():
        with xfer.guard("cuda"):
            a_in.set()
            b_in.wait(10)
            seen["a_under_b_boundary"] = card_mode["mode"]
            a_out.set()

    def thread_b():
        a_in.wait(10)
        seen["b_under_a_guard"] = card_mode["mode"]
        with xfer.boundary():
            b_in.set()
            a_out.wait(10)
        seen["b_after_both"] = card_mode["mode"]

    def churn(seed):
        rng = numpy.random.RandomState(seed)
        for _ in range(300):
            if rng.rand() < 0.5:
                with xfer.guard("cuda"):
                    if rng.rand() < 0.5:
                        with xfer.boundary():
                            pass
            else:
                with xfer.boundary():
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for group in ([threading.Thread(target=thread_a),
                       threading.Thread(target=thread_b)],
                      [threading.Thread(target=churn, args=(s,))
                       for s in range(8)]):
            for t in group:
                t.start()
            for t in group:
                t.join(30)
            assert all(not t.is_alive() for t in group)
    finally:
        sys.setswitchinterval(interval)
    assert seen == {"b_under_a_guard": 2, "a_under_b_boundary": 1,
                    "b_after_both": 1}
    assert card_mode["mode"] == 1 and len(states) > 4
    for mode, guards, bounds in states:
        want = 2 if guards and not bounds else 1
        assert mode == want, (mode, guards, bounds)


def test_a_mode_that_does_not_take_raises(monkeypatch, card_mode):
    """With a card, an armed guard whose mode does not take raises
    rather than running unguarded."""
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda mode: None)
    xfer.arm("disallow")
    with pytest.raises(RuntimeError, match="sync debug mode"):
        with xfer.guard("cuda"):
            pass
    assert xfer._guards == 0


def _with_boundaries(tree):
    """(with-nodes under ``xfer.boundary()``) of a parsed module."""
    return [n for n in ast.walk(tree) if isinstance(n, ast.With) and any(
        isinstance(i.context_expr, ast.Call)
        and ast.unparse(i.context_expr.func) == "xfer.boundary"
        for i in n.items)]


def test_hot_paths_move_data_only_through_the_shims():
    """The engine and the batcher hold no ``torch.as_tensor(...,
    device=)``, ``.cpu()``, ``.item()`` or ``int()`` of a card value:
    the uploads go through ``xfer.to_device``, the reads through
    ``xfer.to_host``, and every stream synchronize sits inside a
    declared ``xfer.boundary()``."""
    for name in ("lm_engine.py", "batcher.py"):
        tree = ast.parse((SERVING / name).read_text())
        inside = {id(n) for w in _with_boundaries(tree)
                  for n in ast.walk(w)}
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            func = ast.unparse(node.func)
            assert not func.endswith((".cpu", ".item")), (name, func)
            if func.endswith("as_tensor"):
                assert not any(k.arg == "device" for k in node.keywords), \
                    (name, ast.unparse(node))
            if func.endswith(".synchronize"):
                assert id(node) in inside, (name, node.lineno)
            if func == "int" and node.args:
                arg = ast.unparse(node.args[0])
                assert arg != "tok", (name, node.lineno)
    src = (SERVING / "lm_engine.py").read_text()
    assert src.count("int(xfer.to_host(tok))") == 2
    assert "return xfer.to_host(self._pick(logits, seeds, at))" in src
    assert "return xfer.to_device(arr, numpy.int32, self.device)" in src


def test_batcher_dispatch_routes_through_xfer_shims():
    """The reference's one host-sync find, pinned in the port: the
    batcher's dispatch reads the forward's result through
    ``xfer.to_host`` inside a declared boundary, never
    ``numpy.asarray(self.forward(chunk))``; and at run time the forward
    runs inside the boundary, its tensor result comes back as numpy, and
    the dispatch reports to the lock-order witness."""
    src = (SERVING / "batcher.py").read_text()
    assert "out = xfer.to_host(self.forward(chunk))" in src
    assert "= numpy.asarray(self.forward(chunk" not in src
    seen = []

    def forward(x):
        seen.append(xfer._boundaries)
        return torch.from_numpy(x) * 2

    witness = lockcheck.arm(lockcheck.LockOrderWitness(name="t_batcher"))
    xfer.arm("disallow")
    batcher = MicroBatcher(forward, max_batch=4, sample_shape=(3,),
                           dtype=numpy.float32).start()
    try:
        out = batcher.submit(numpy.ones((2, 3), numpy.float32))
    finally:
        batcher.stop()
        lockcheck.disarm()
    assert isinstance(out, numpy.ndarray)
    numpy.testing.assert_array_equal(out, numpy.full((2, 3), 2.0))
    assert seen and all(depth >= 1 for depth in seen[-1:])
    assert witness.violations == [] and witness.dispatch_checks >= 1


def test_engine_routes_through_the_shims(monkeypatch):
    """A CPU engine under the armed guard uploads every dispatch operand
    through ``to_device`` and reads back through ``to_host``; its tokens
    equal the same run unarmed."""
    prng.reset()
    params = TT.init_transformer_params(
        prng.RandomGenerator("init", 3), 32, d_model=32, n_heads=4,
        n_layers=2, max_len=128)
    calls = {"to_device": 0, "to_host": 0}
    for name in calls:
        real = getattr(xfer, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(xfer, name, counted)

    def run():
        engine = LMEngine(params, 4, 64, slots=2, prefill_chunk=8,
                          device="cpu").start()
        try:
            return [list(engine.submit(p, 5).result(timeout=60))
                    for p in ([1, 2, 3], list(range(2, 13)))]
        finally:
            engine.stop()
    plain = run()
    xfer.arm("disallow")
    assert run() == plain
    assert calls["to_device"] > 0 and calls["to_host"] > 0
