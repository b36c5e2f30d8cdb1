"""The port's ``ZeroMQLoader`` against ``veles_tpu.zmq_loader``.

``tests/test_services.py::TestZmqLoader``'s stream (five 4-float
samples, minibatch 3) and a longer seeded one pushed through both
packages' loaders: every minibatch (data, labels, mask), its live size,
``exhausted`` and ``complete`` equal, bit for bit.
"""

import numpy
import pytest

from veles_tpu import zmq_loader as jax_zmq
from veles_tpu_torch import zmq_loader


def _loaders(sample_shape, minibatch_size):
    mine = zmq_loader.ZeroMQLoader(None, sample_shape=sample_shape,
                                   minibatch_size=minibatch_size,
                                   timeout_ms=10000, name="loader")
    theirs = jax_zmq.ZeroMQLoader(None, sample_shape=sample_shape,
                                  minibatch_size=minibatch_size,
                                  timeout_ms=10000, name="loader")
    mine.initialize(device="cpu")
    theirs.initialize()
    return mine, theirs


def _minibatch(loader):
    return tuple(numpy.asarray(getattr(loader, name).mem)
                 for name in ("minibatch_data", "minibatch_labels",
                              "minibatch_mask"))


def _same_stream(samples, sample_shape, minibatch_size, runs):
    mine, theirs = _loaders(sample_shape, minibatch_size)
    try:
        zmq_loader.push_samples(mine.endpoint, samples)
        jax_zmq.push_samples(theirs.endpoint, samples)
        seen = []
        for _ in range(runs):
            mine.run()
            theirs.run()
            for got, want in zip(_minibatch(mine), _minibatch(theirs)):
                assert got.dtype == want.dtype
                numpy.testing.assert_array_equal(got, want)
            # the device minibatch is the host one
            numpy.testing.assert_array_equal(
                mine.minibatch_data.devmem.numpy(), _minibatch(mine)[0])
            state = (mine.minibatch_size, mine.minibatch_class,
                     mine.exhausted, bool(mine.complete))
            assert state == (theirs.minibatch_size, theirs.minibatch_class,
                             theirs.exhausted, bool(theirs.complete))
            seen.append(state)
        return seen
    finally:
        mine.stop()
        theirs.stop()


def test_services_stream_equals_reference():
    """3 live rows, then 2 and the end of the stream, then the empty
    minibatch that flips ``complete``."""
    samples = [{"data": numpy.full(4, i, numpy.float32), "label": i}
               for i in range(5)]
    seen = _same_stream(samples, (4,), 3, 3)
    assert seen == [(3, 2, False, False), (2, 2, True, False),
                    (0, 2, True, True)]


@pytest.mark.parametrize("n,minibatch_size", [(100, 25), (37, 10)])
def test_seeded_stream_equals_reference(n, minibatch_size):
    rng = numpy.random.default_rng(n)
    samples = [{"data": rng.standard_normal((2, 3)).astype(numpy.float32),
                "label": int(rng.integers(0, 10))} for _ in range(n)]
    runs = -(-n // minibatch_size) + 1
    seen = _same_stream(samples, (2, 3), minibatch_size, runs)
    assert sum(s[0] for s in seen) == n
    assert seen[-1][3]


def test_timeout_with_nothing_buffered_raises():
    mine = zmq_loader.ZeroMQLoader(None, sample_shape=(1,),
                                   minibatch_size=2, timeout_ms=50)
    mine.initialize(device="cpu")
    try:
        with pytest.raises(TimeoutError, match="no sample within 50ms"):
            mine.run()
    finally:
        mine.stop()
