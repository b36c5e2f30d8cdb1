"""ZeroMQLoader — feed external data into a running graph over ZeroMQ.

Port of ``veles_tpu/zmq_loader.py`` (ref: veles/zmq_loader.py::
ZeroMQLoader [M], SURVEY §2.1): a PULL socket receives pickled samples
from external producers; the loader waits (with a timeout) for a
minibatch-worth.  Producers connect with PUSH and send ``{"data":
ndarray, "label": int}`` pickles (:func:`push_samples`); ``None``
signals end-of-stream.  Each minibatch is assembled on the host
(``loader/stream.py``) and uploads to the loader's device on first use.

Delivery semantics: a receive timeout mid-minibatch delivers the samples
already buffered as a PARTIAL minibatch (the mask handles short
batches); only a timeout with NOTHING buffered raises.  Gate the
workflow's end on ``complete`` — it flips True once the end-of-stream
``None`` has been consumed.  Unpickle only what trusted producers send:
a pickle can run code.
"""

from __future__ import annotations

import pickle

import numpy

from veles_tpu_torch.loader.base import TRAIN
from veles_tpu_torch.loader.stream import StreamLoaderBase
from veles_tpu_torch.mutable import Bool


class ZeroMQLoader(StreamLoaderBase):
    def __init__(self, workflow, endpoint="tcp://127.0.0.1:0",
                 sample_shape=(1,), timeout_ms=10000, **kwargs):
        super().__init__(workflow, sample_shape=sample_shape, **kwargs)
        self.endpoint = endpoint
        self.timeout_ms = timeout_ms
        self._sock = None
        self.exhausted = False
        self.complete = Bool(False)
        self._delivered_any = False

    def load_data(self):
        import zmq
        ctx = zmq.Context.instance()
        self._sock = ctx.socket(zmq.PULL)
        if self.endpoint.endswith(":0"):
            port = self._sock.bind_to_random_port(self.endpoint[:-2])
            self.endpoint = "%s:%d" % (self.endpoint[:-2], port)
        else:
            self._sock.bind(self.endpoint)
        # stream length is unknown; advertise one epoch of one minibatch and
        # keep re-planning until the producer sends the end-of-stream None
        self.class_lengths = [0, 0, self.max_minibatch_size]

    def next_sample(self):
        import zmq
        if self.exhausted:
            return None
        if not self._sock.poll(self.timeout_ms, zmq.POLLIN):
            if self._delivered_any:
                return None   # deliver what we have as a partial minibatch
            raise TimeoutError("ZeroMQLoader: no sample within %dms"
                               % self.timeout_ms)
        message = pickle.loads(self._sock.recv())
        if message is None:
            self.exhausted = True
            return None
        self._delivered_any = True
        return (numpy.asarray(message["data"], numpy.float32),
                int(message.get("label", 0)))

    def fill_minibatch(self, indices, actual_size):
        self._delivered_any = False
        super().fill_minibatch(indices, actual_size)
        if self.exhausted and self.minibatch_size == 0:
            self.complete.set(True)

    def run(self):
        # the one-minibatch plan makes every delivery its own "epoch", so
        # downstream epoch bookkeeping (decision, snapshotter) advances per
        # delivery automatically
        super().run()
        self.minibatch_class = TRAIN

    def stop(self):
        if self._sock is not None:
            self._sock.close(linger=0)
            self._sock = None


def push_samples(endpoint, samples, context=None):
    """Producer-side helper: PUSH samples (then None) to a ZeroMQLoader."""
    import zmq
    ctx = context or zmq.Context.instance()
    sock = ctx.socket(zmq.PUSH)
    sock.connect(endpoint)
    for sample in samples:
        sock.send(pickle.dumps(sample, pickle.HIGHEST_PROTOCOL))
    sock.send(pickle.dumps(None))
    sock.close(linger=1000)
