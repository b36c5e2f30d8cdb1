"""Graphics transport: plot specs over ZeroMQ PUB/SUB.

Port of ``veles_tpu/graphics_server.py`` (ref: veles/graphics_server.py::
GraphicsServer [H]): the reference pickled matplotlib state and
published it to a separate renderer process, so drawing never blocked
training.  The same topology with spec dicts (``veles_tpu_torch.plotter``)
as the wire format: the server owns a PUB socket, the client
(``veles_tpu_torch.graphics_client``) subscribes and renders to files.
A spec holds only numpy arrays and Python values, so either package's
client reads either package's server.
"""

from __future__ import annotations

import pickle


class GraphicsServer:
    """PUB endpoint the workflow's plotters send specs through.

    ``endpoint`` "tcp://127.0.0.1:0" binds an ephemeral port (read it
    back from ``self.endpoint``); "inproc://..." works in one process.
    """

    def __init__(self, endpoint="tcp://127.0.0.1:0", context=None):
        import zmq
        self._ctx = context or zmq.Context.instance()
        self._sock = self._ctx.socket(zmq.PUB)
        if endpoint.endswith(":0"):
            port = self._sock.bind_to_random_port(endpoint[:-2])
            self.endpoint = "%s:%d" % (endpoint[:-2], port)
        else:
            self._sock.bind(endpoint)
            self.endpoint = endpoint

    def send(self, spec):
        self._sock.send(pickle.dumps(spec, pickle.HIGHEST_PROTOCOL))

    def close(self):
        """Broadcast the end of the stream (``None``) and close."""
        import zmq
        try:
            self._sock.send(pickle.dumps(None))
        except zmq.ZMQError:
            pass
        self._sock.close(linger=200)
