"""The skeleton of the port — config tree, mutable gates, units, the
workflow scheduler, Vector and the host PRNG — held to the assertions of
``tests/test_config.py``, ``test_mutable.py``, ``test_units.py`` and
``test_workflow.py``, plus Vector's device binding and the PRNG's
bit-equality with the reference."""

import io
import logging

import numpy
import pytest
import torch

from veles_tpu import prng as jax_prng
from veles_tpu_torch import prng
from veles_tpu_torch.config import Config, Tune, get, parse_override
from veles_tpu_torch.memory import Vector
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.units import Unit, TrivialUnit, UnitRegistry
from veles_tpu_torch.workflow import (Workflow, Repeater,
                                      DeferredInitError)


class Recorder(Unit):
    def __init__(self, workflow, log, **kwargs):
        super().__init__(workflow, **kwargs)
        self.log = log

    def run(self):
        self.log.append(self.name)


# ------------------------------------------------------------------- config
def test_config_autocreate_set_and_default():
    cfg = Config("root")
    cfg.loader.minibatch_size = 100
    assert cfg.loader.minibatch_size == 100
    assert get(cfg.loader.minibatch_size) == 100
    assert get(cfg.never.set_before, 42) == 42
    assert get(cfg.never.set_before) is None


def test_config_update_and_dict_subtree():
    cfg = Config("root")
    cfg.a.x = 1
    cfg.update({"a": {"y": 2}, "b": 3})
    assert (cfg.a.x, cfg.a.y, cfg.b) == (1, 2, 3)
    cfg.layers = [{"type": "all2all", "n": 100}]
    assert cfg.layers[0]["type"] == "all2all"
    cfg.decision = {"max_epochs": 3}
    assert cfg.decision.max_epochs == 3


def test_config_tune_override_and_print():
    t = Tune(0.01, 0.001, 0.1)
    assert get(t) == 0.01 and t.minv == 0.001 and t.maxv == 0.1
    cfg = Config("root")
    parse_override("root.loader.minibatch_size=64", cfg)
    parse_override("root.name=hello", cfg)
    parse_override("root.lr=0.05", cfg)
    assert cfg.loader.minibatch_size == 64
    assert cfg.name == "hello"
    assert abs(cfg.lr - 0.05) < 1e-12
    out = io.StringIO()
    cfg.print_(file=out)
    assert "loader:" in out.getvalue() and "minibatch_size: 64" in \
        out.getvalue()


def test_config_root_is_the_ports_own():
    from veles_tpu.config import root as jax_root
    from veles_tpu_torch.config import root
    assert root is not jax_root


def test_logger_does_not_touch_root_handlers():
    sentinel = logging.NullHandler()
    logging.root.addHandler(sentinel)
    try:
        TrivialUnit(Workflow(None, name="wf"), name="u").info("hello")
        assert sentinel in logging.root.handlers
    finally:
        logging.root.removeHandler(sentinel)


# ------------------------------------------------------------------ mutable
def test_bool_assign_and_derived_expressions():
    b = Bool()
    assert not b
    b <<= True
    assert b
    b.unset()
    assert not b
    a, c = Bool(False), Bool(False)
    both, either, nota = a & c, a | c, ~a
    assert not both and not either and nota
    a <<= True
    assert not both and either and not nota
    c <<= True
    assert both and either
    assert (a & True) and (a | False)


def test_derived_bool_is_not_assignable():
    expr = ~Bool(True)
    with pytest.raises(ValueError):
        expr <<= True
    with pytest.raises(ValueError):
        expr.set(True)


# -------------------------------------------------------------------- units
def test_link_from_and_open_gate():
    wf = Workflow(None, name="wf")
    a, b, c = (TrivialUnit(wf, name=n) for n in "abc")
    c.link_from(a, b)
    assert not c.open_gate(a)      # only one of two fired
    assert c.open_gate(b)          # both fired -> opens
    assert not c.open_gate(a)      # marks were reset by the open
    r = Repeater(wf, name="rep")
    r.link_from(a, b)
    assert r.open_gate(a) and r.open_gate(b)     # OR semantics
    with pytest.raises(ValueError):
        a.link_from(a)
    c.unlink_from(a)
    assert c not in a.links_to and a not in c.links_from


def test_link_attrs():
    wf = Workflow(None, name="wf")
    src = TrivialUnit(wf, name="src")
    dst = TrivialUnit(wf, name="dst")
    src.output = 123
    dst.link_attrs(src, ("input", "output"))
    assert dst.input == 123
    src.output = 456
    assert dst.input == 456
    dst.input = 789                # two-way: writes through to src
    assert src.output == 789
    src.value = 1
    dst.value = 99                 # local value must be dropped by the link
    dst.link_attrs(src, "value")
    assert dst.value == 1
    with pytest.raises(AttributeError):
        dst.no_such_attribute

    class WithDefault(Unit):
        value = "CLASS_DEFAULT"

    other = WithDefault(wf, name="other")
    other.link_attrs(src, "value")
    assert other.value == 1        # alias beats the class attribute


def test_registry_qualified_names():
    key = "%s.%s" % (TrivialUnit.__module__, "TrivialUnit")
    assert key.startswith("veles_tpu_torch.")
    assert UnitRegistry.units[key] is TrivialUnit


@pytest.mark.parametrize("gate,expected", [
    ("block", ["a"]),              # b blocked, c never reached
    ("skip", ["a", "c"]),          # b skipped, c still runs
])
def test_gates(gate, expected):
    wf = Workflow(None, name="wf")
    log = []
    a, b, c = (Recorder(wf, log, name=n) for n in "abc")
    a.link_from(wf.start_point)
    b.link_from(a)
    c.link_from(b)
    getattr(b, "gate_" + gate).set(True)
    wf.end_point.link_from(c)
    wf.run()
    assert log == expected


def test_gate_expression_flips_mid_run():
    wf = Workflow(None, name="wf")
    log = []
    gate = Bool(False)

    class Flipper(Recorder):
        def run(self):
            super().run()
            gate.set(True)

    a = Flipper(wf, log, name="a")
    b = Recorder(wf, log, name="b")
    a.link_from(wf.start_point)
    b.link_from(a)
    b.gate_skip = ~(~gate)         # derived expression evaluated at fire time
    wf.end_point.link_from(b)
    wf.run()
    assert log == ["a"]


# ----------------------------------------------------------------- workflow
def test_linear_chain_and_diamond():
    wf = Workflow(None, name="wf")
    log = []
    units = [Recorder(wf, log, name="u%d" % i) for i in range(4)]
    units[0].link_from(wf.start_point)
    units[1].link_from(units[0])
    units[2].link_from(units[0])
    units[3].link_from(units[1], units[2])       # AND join
    wf.end_point.link_from(units[3])
    wf.run()
    assert log == ["u0", "u1", "u2", "u3"]
    assert wf.is_finished


def test_repeater_cycle_terminates_via_gate():
    wf = Workflow(None, name="wf")
    log = []
    complete = Bool(False)

    class Body(Recorder):
        def run(self):
            super().run()
            if len(self.log) >= 5:
                complete.set(True)

    rep = Repeater(wf, name="rep")
    body = Body(wf, log, name="body")
    rep.link_from(wf.start_point)
    body.link_from(rep)
    rep.link_from(body)
    wf.end_point.link_from(body)
    wf.end_point.gate_block = ~complete
    body.gate_block = complete
    wf.run()
    assert log == ["body"] * 5
    assert wf.is_finished


def test_stop_mid_run():
    wf = Workflow(None, name="wf")
    log = []

    class Stopper(Recorder):
        def run(self):
            super().run()
            self.workflow.stop()

    rep = Repeater(wf, name="rep")
    s = Stopper(wf, log, name="s")
    rep.link_from(wf.start_point)
    s.link_from(rep)
    rep.link_from(s)
    wf.run()
    assert log == ["s"]
    assert not wf.is_finished


def test_initialize_deferred_ordering_and_device():
    wf = Workflow(None, name="wf")
    order = []

    class Producer(TrivialUnit):
        def initialize(self, **kwargs):
            self.ready = True
            order.append("producer")
            super().initialize(**kwargs)

    class Consumer(TrivialUnit):
        def initialize(self, **kwargs):
            if not getattr(producer, "ready", False):
                raise DeferredInitError()
            order.append(("consumer", kwargs["device"]))
            super().initialize(**kwargs)

    Consumer(wf, name="consumer")           # consumer-first forces deferral
    producer = Producer(wf, name="producer")
    wf.initialize(device="cpu")
    assert order == ["producer", ("consumer", torch.device("cpu"))]
    assert wf.device == torch.device("cpu")


def test_stats_graph_and_unique_names():
    wf = Workflow(None, name="wf")
    log = []
    a = Recorder(wf, log, name="a")
    a.link_from(wf.start_point)
    wf.end_point.link_from(a)
    wf.run()
    assert a.run_count == 1 and a.run_time >= 0.0
    wf.print_stats()
    dot = wf.generate_graph()
    assert "digraph" in dot and "->" in dot and '"a"' in dot
    names = {TrivialUnit(wf).name for _ in range(3)}
    assert len(names) == 3


# ------------------------------------------------------------------- Vector
def test_vector_binds_to_its_units_device():
    wf = Workflow(None, name="wf")
    unit = TrivialUnit(wf, name="u")
    unit.data = Vector(numpy.arange(6, dtype=numpy.float32).reshape(2, 3))
    with pytest.raises(RuntimeError, match="no device"):
        unit.data.devmem
    wf.initialize(device="cpu")
    dev = unit.data.devmem
    assert isinstance(dev, torch.Tensor) and dev.device.type == "cpu"
    assert unit.data.shape == (2, 3) and unit.data.dtype == numpy.float32
    # device results are adopted without a copy, host reads pull once
    unit.data.assign_device(dev * 2)
    assert unit.data.dtype == numpy.float32
    numpy.testing.assert_array_equal(unit.data.mem[1], [6, 8, 10])
    unit.data[0, 0] = 7.0                        # host write, then upload
    assert unit.data.devmem[0, 0].item() == 7.0


# --------------------------------------------------------------------- prng
@pytest.mark.parametrize("pinned", [False, True])
def test_prng_streams_bit_equal_to_reference(pinned):
    for mod in (prng, jax_prng):
        mod.reset()
        mod.seed_all(42)
    a = prng.get("init", pinned=pinned)
    b = jax_prng.get("init", pinned=pinned)
    assert a.initial_seed == b.initial_seed
    wa, wb = numpy.zeros((7, 5), numpy.float32), numpy.zeros((7, 5),
                                                             numpy.float32)
    a.fill(wa, -0.1, 0.1)
    b.fill(wb, -0.1, 0.1)
    numpy.testing.assert_array_equal(wa, wb)
    ia, ib = numpy.arange(50), numpy.arange(50)
    a.shuffle(ia)
    b.shuffle(ib)
    numpy.testing.assert_array_equal(ia, ib)
    numpy.testing.assert_array_equal(a.normal(0, 1, 9), b.normal(0, 1, 9))
    state = prng.state_dict()
    x = prng.get("init").uniform(size=4)
    prng.load_state_dict(state)
    numpy.testing.assert_array_equal(prng.get("init").uniform(size=4), x)
    numpy.testing.assert_array_equal(a.key(), numpy.asarray(b.key()))
    prng.reset()
