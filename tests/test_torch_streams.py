"""The port's minibatch stream modules against the JAX package on the
CPU: ``MinibatchesSaver`` captures byte-equal to the reference's (the
same header, ``MAGIC`` string and one pickled record of numpy arrays a
minibatch), the port's replay of the reference's capture re-captured
byte for byte, and the reference's replay of the port's capture
re-captured as of its own; a replay through ``MinibatchesLoader``
trains an RBM to the parameters of the direct run bit for bit;
``InteractiveLoader`` accepting and refusing the same shapes as the
reference's, its minibatches equal, and feeding a SOM forward whose
winners equal a direct pass; ``InputJoiner`` outputs equal.  Everything
here is exact (bit- or byte-equal).
"""

import types

import numpy
import pytest
import torch

from veles_tpu import input_joiner as jax_input_joiner
from veles_tpu import prng as jax_prng
from veles_tpu.config import root as jax_root
from veles_tpu.loader import interactive as jax_interactive
from veles_tpu.loader import saver as jax_saver
from veles_tpu.memory import Vector as JaxVector
from veles_tpu.ops import nn_units as jax_nn_units
from veles_tpu.ops import rbm as jax_rbm
from veles_tpu.samples import mnist_rbm as jax_mnist_rbm
from veles_tpu.units import Unit as JaxUnit
from veles_tpu.workflow import DeferredInitError as JaxDeferredInitError
from veles_tpu.workflow import Repeater as JaxRepeater
from veles_tpu_torch import input_joiner, prng
from veles_tpu_torch.config import root
from veles_tpu_torch.loader import interactive, saver
from veles_tpu_torch.memory import Vector
from veles_tpu_torch.ops import functional as F
from veles_tpu_torch.ops import nn_units, rbm
from veles_tpu_torch.samples import kohonen, mnist_rbm
from veles_tpu_torch.units import Unit
from veles_tpu_torch.workflow import DeferredInitError, Repeater

SEED = 11
#: one epoch of a small MNIST-RBM: 230 train samples at minibatch 50, so
#: the fifth minibatch is padded (30 live rows)
RBM_SMALL = {"loader": {"minibatch_size": 50, "n_train": 230, "n_valid": 0},
             "trainer": {"n_hidden": 32, "learning_rate": 0.1, "cd_k": 1},
             "decision": {"max_epochs": 1, "fail_iterations": 20}}

PORT = types.SimpleNamespace(
    prng=prng, root=root, sample=mnist_rbm, saver=saver, rbm=rbm,
    NNWorkflow=nn_units.NNWorkflow, Repeater=Repeater,
    init=lambda wf: wf.initialize(device="cpu"))
REF = types.SimpleNamespace(
    prng=jax_prng, root=jax_root, sample=jax_mnist_rbm, saver=jax_saver,
    rbm=jax_rbm, NNWorkflow=jax_nn_units.NNWorkflow, Repeater=JaxRepeater,
    init=lambda wf: wf.initialize())


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(trainer):
    return [numpy.asarray(getattr(trainer, k).mem).copy()
            for k in ("weights", "vbias", "hbias")]


def _capture(pkg, path):
    """The small MNIST-RBM run of ``pkg`` (one epoch) with its loader's
    stream captured to ``path``; returns the trained parameters."""
    pkg.prng.reset()
    pkg.prng.seed_all(SEED)
    pkg.root.__dict__.pop("mnist_rbm", None)
    pkg.root.mnist_rbm.update(RBM_SMALL)
    try:
        wf = pkg.sample.build()
        pkg.saver.MinibatchesSaver.attach_to(wf.loader, str(path))
        pkg.init(wf)
        wf.run()
    finally:
        pkg.root.__dict__.pop("mnist_rbm", None)
    return _params(wf.trainer)


def _replay(pkg, path, capture=None):
    """A fresh RBM of ``pkg`` trained one epoch on the capture at
    ``path`` (re-captured to ``capture`` when given); returns its
    parameters."""
    pkg.prng.reset()
    pkg.prng.seed_all(SEED)
    wf = pkg.NNWorkflow(None, name="replay")
    wf.repeater = pkg.Repeater(wf, name="repeater")
    wf.repeater.link_from(wf.start_point)
    wf.loader = pkg.saver.MinibatchesLoader(wf, path=str(path),
                                            name="loader")
    wf.loader.link_from(wf.repeater)
    wf.trainer = pkg.rbm.RBMTrainer(wf, name="trainer",
                                    **RBM_SMALL["trainer"])
    wf.trainer.link_from(wf.loader)
    wf.trainer.link_attrs(wf.loader, ("input", "minibatch_data"),
                          ("mask", "minibatch_mask"), "minibatch_class")
    wf.decision = pkg.rbm.RBMDecision(wf, name="decision",
                                      **RBM_SMALL["decision"])
    wf.decision.link_from(wf.trainer)
    wf.decision.link_attrs(wf.loader, "minibatch_class", "minibatch_size",
                           "last_minibatch", "class_lengths", "epoch_number")
    wf.decision.link_attrs(wf.trainer, "metrics")
    if capture is not None:
        pkg.saver.MinibatchesSaver.attach_to(wf.loader, str(capture))
    wf.repeater.link_from(wf.decision)
    wf.end_point.link_from(wf.decision)
    wf.end_point.gate_block = ~wf.decision.complete
    pkg.init(wf)
    wf.run()
    assert wf.trainer.time == 5
    return _params(wf.trainer)


def test_captures_are_byte_equal_and_replay_both_ways(tmp_path):
    ref_file, port_file = tmp_path / "ref.pickle", tmp_path / "port.pickle"
    ref_params = _capture(REF, ref_file)
    port_params = _capture(PORT, port_file)
    assert ref_file.read_bytes() == port_file.read_bytes()
    # the port replays the reference's capture: its re-capture is the
    # original byte for byte
    again = tmp_path / "again.pickle"
    port_replay = _replay(PORT, ref_file, capture=again)
    assert again.read_bytes() == ref_file.read_bytes()
    # the reference replays the port's capture exactly as its own: the
    # two re-captures are byte-equal (not to their source: its replay
    # keeps the unpickled arrays' dtype objects, which pickle does not
    # memoize, so each record grows by one dtype's bytes)
    ref_own, ref_port = tmp_path / "own.pickle", tmp_path / "port2.pickle"
    ref_replays = [_replay(REF, ref_file, capture=ref_own),
                   _replay(REF, port_file, capture=ref_port)]
    assert ref_own.read_bytes() == ref_port.read_bytes()
    for a, b in zip(*ref_replays):
        assert numpy.array_equal(a, b)
    # both packages trained on the same stream (within fp32 roundoff)
    for params in (port_params, port_replay, ref_replays[0]):
        for a, b in zip(params, ref_params):
            numpy.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_replay_trains_bit_equal_to_the_direct_run(tmp_path):
    path = tmp_path / "stream.pickle"
    direct = _capture(PORT, path)
    replayed = _replay(PORT, path)
    for a, b in zip(direct, replayed):
        assert numpy.array_equal(a, b)


def test_replay_refuses_foreign_and_empty_files(tmp_path):
    import pickle
    bad = tmp_path / "bad.pickle"
    bad.write_bytes(pickle.dumps({"magic": "something else"}))
    empty = tmp_path / "empty.pickle"
    empty.write_bytes(pickle.dumps({"magic": saver.MAGIC,
                                    "class_lengths": [0, 0, 1],
                                    "minibatch_size": 1}))
    assert saver.MAGIC == jax_saver.MAGIC
    for path, match in ((bad, "not a minibatch capture"),
                        (empty, "holds no minibatches")):
        loader = saver.MinibatchesLoader(None, path=str(path))
        with pytest.raises(ValueError, match=match):
            loader.initialize(device="cpu")
        loader.stop()


SHAPES = [(2,), (5, 2), (0, 2), (3,), (2, 1), (2, 2, 1), (1, 3), ()]


@pytest.mark.parametrize("shape", SHAPES)
def test_interactive_feed_takes_and_refuses_what_the_reference_does(shape):
    mine = interactive.InteractiveLoader(None, sample_shape=(2,))
    theirs = jax_interactive.InteractiveLoader(None, sample_shape=(2,))
    data = numpy.arange(int(numpy.prod(shape)), dtype=numpy.float32)
    data = data.reshape(shape)
    outcomes = []
    for loader in (mine, theirs):
        try:
            loader.feed(data, 1)
            outcomes.append(len(loader._queue))
        except ValueError as err:
            outcomes.append(str(err))
    assert outcomes[0] == outcomes[1]


def test_interactive_minibatches_equal_the_reference():
    mine = interactive.InteractiveLoader(None, sample_shape=(3,),
                                         minibatch_size=4)
    theirs = jax_interactive.InteractiveLoader(None, sample_shape=(3,),
                                               minibatch_size=4)
    mine.initialize(device="cpu")
    theirs.initialize()
    data = numpy.random.RandomState(0).randn(6, 3).astype(numpy.float32)
    for loader in (mine, theirs):
        loader.feed(data, list(range(6)))
        loader.feed(data[0], 9)
    for _ in range(3):        # 4 live rows, then 3, then none
        mine.run()
        theirs.run()
        assert mine.minibatch_size == theirs.minibatch_size
        assert mine.minibatch_class == theirs.minibatch_class == 0
        for name in ("minibatch_data", "minibatch_labels", "minibatch_mask"):
            assert numpy.array_equal(
                getattr(mine, name).devmem.numpy(),
                numpy.asarray(getattr(theirs, name).mem))


def test_interactive_feeds_a_som_forward_like_a_direct_pass():
    prng.reset()
    prng.seed_all(SEED)
    root.__dict__.pop("kohonen", None)
    root.kohonen.update({"loader": {"minibatch_size": 50, "n_train": 230},
                         "trainer": {"shape": (5, 5)},
                         "decision": {"max_epochs": 2}})
    try:
        som = kohonen.train(device="cpu")
    finally:
        root.__dict__.pop("kohonen", None)
    points = som.loader.original_data.mem
    weights = som.trainer.weights.devmem
    feed = interactive.InteractiveLoader(None, sample_shape=(2,),
                                         minibatch_size=50)
    fwd = kohonen.KohonenForward(None)
    fwd.link_attrs(feed, ("input", "minibatch_data"),
                   ("mask", "minibatch_mask"))
    fwd.weights = som.trainer.weights
    feed.initialize(device="cpu")
    fwd.initialize(device="cpu")
    feed.feed(points)
    got, want = [], []
    for at in range(0, len(points), 50):
        feed.run()
        fwd.run()
        live = feed.minibatch_size
        got.append(fwd.output.mem[:live])
        direct, _ = F.kohonen_winners(torch.as_tensor(points[at:at + 50]),
                                      weights)
        want.append(direct.numpy())
    got, want = numpy.concatenate(got), numpy.concatenate(want)
    assert len(got) == len(points) == 230
    assert numpy.array_equal(got, want)
    assert numpy.array_equal(fwd.hits, numpy.bincount(want, minlength=25))


class _Source(Unit):
    def __init__(self, workflow, data, **kwargs):
        super().__init__(workflow, **kwargs)
        self.output = Vector(data)


class _JaxSource(JaxUnit):
    def __init__(self, workflow, data, **kwargs):
        super().__init__(workflow, **kwargs)
        self.output = JaxVector(data)


def test_input_joiner_equals_the_reference():
    rng = numpy.random.RandomState(4)
    parts = [rng.randn(6, 3).astype(numpy.float32),
             rng.randn(6, 2, 2, 1).astype(numpy.float32),
             rng.randn(6, 1).astype(numpy.float32)]
    sources = [_Source(None, p) for p in parts]
    for s in sources:
        s.initialize(device="cpu")
    join = input_joiner.InputJoiner(None, inputs=sources[:2])
    join.link_inputs(sources[2])
    join.initialize(device="cpu")
    join.run()
    ref = jax_input_joiner.InputJoiner(
        None, inputs=[_JaxSource(None, p) for p in parts])
    ref.initialize()
    ref.run()
    assert join.output_sample_shape == ref.output_sample_shape == (8,)
    assert numpy.array_equal(join.output.mem, numpy.asarray(ref.output.mem))
    assert set(join.links_from) == set(sources)


def test_input_joiner_refuses_what_the_reference_does():
    with pytest.raises(ValueError, match="no inputs"):
        input_joiner.InputJoiner(None).initialize(device="cpu")
    with pytest.raises(ValueError, match="no inputs"):
        jax_input_joiner.InputJoiner(None).initialize()
    two = [numpy.zeros((4, 2), numpy.float32),
           numpy.zeros((5, 2), numpy.float32)]
    with pytest.raises(ValueError, match="batch mismatch"):
        input_joiner.InputJoiner(
            None, inputs=[_Source(None, p) for p in two]).initialize(
                device="cpu")
    with pytest.raises(ValueError, match="batch mismatch"):
        jax_input_joiner.InputJoiner(
            None, inputs=[_JaxSource(None, p) for p in two]).initialize()
    with pytest.raises(DeferredInitError):
        input_joiner.InputJoiner(
            None, inputs=[_Source(None, None)]).initialize(device="cpu")
    with pytest.raises(JaxDeferredInitError):
        jax_input_joiner.InputJoiner(
            None, inputs=[_JaxSource(None, None)]).initialize()
