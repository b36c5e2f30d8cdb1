"""Graphics renderer client: the separate drawing process.

Port of ``veles_tpu/graphics_client.py`` (ref: veles/graphics_client.py
[H]).  Subscribes to a GraphicsServer endpoint and renders every spec it
receives to a PNG under ``--out`` (the headless form of the reference's
live matplotlib windows).

CLI: ``python -m veles_tpu_torch.graphics_client tcp://127.0.0.1:PORT
--out plots``
"""

from __future__ import annotations

import argparse
import os
import pickle


class GraphicsClient:
    def __init__(self, endpoint, out_dir="plots", context=None):
        import zmq
        self._ctx = context or zmq.Context.instance()
        self._sock = self._ctx.socket(zmq.SUB)
        self._sock.connect(endpoint)
        self._sock.setsockopt(zmq.SUBSCRIBE, b"")
        self.out_dir = out_dir
        self.rendered = 0

    def poll_once(self, timeout_ms=1000):
        """Render one spec; False at the end of the stream or on a
        timeout."""
        import zmq
        if not self._sock.poll(timeout_ms, zmq.POLLIN):
            return False
        spec = pickle.loads(self._sock.recv())
        if spec is None:
            return False
        from veles_tpu_torch.plotter import render_spec
        os.makedirs(self.out_dir, exist_ok=True)
        self.rendered += 1
        name = spec.get("name", "plot")
        render_spec(spec, os.path.join(
            self.out_dir, "%s_%04d.png" % (name, self.rendered)))
        return True

    def run_forever(self, timeout_ms=30000):
        while self.poll_once(timeout_ms):
            pass

    def close(self):
        self._sock.close(linger=0)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("endpoint")
    parser.add_argument("--out", default="plots")
    parser.add_argument("--timeout", type=int, default=30000)
    args = parser.parse_args(argv)
    client = GraphicsClient(args.endpoint, args.out)
    client.run_forever(args.timeout)
    client.close()


if __name__ == "__main__":
    main()
