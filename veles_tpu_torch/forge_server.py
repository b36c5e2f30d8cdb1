"""Forge server — HTTP transport for the model store.

Port of ``veles_tpu/forge_server.py`` (no device code, so the semantics
carry over verbatim): a threading HTTP server over a store directory,
speaking the package format of ``veles_tpu_torch.forge`` (one
``.forge.tar.gz`` per version, manifest inside).

Endpoints:
- ``GET  /list``            → JSON [[package_file_name, manifest], ...]
- ``GET  /fetch/<name>``    → newest package tarball named <name>
- ``POST /upload``          → request body is a package tarball; stored
  versioned by (manifest name, packaged_at), like ``forge.publish``.

Client helpers (``upload``, ``list_remote``, ``fetch_remote``) use
urllib — no third-party dependencies, usable from training scripts.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from veles_tpu_torch import forge


class _ForgeHandler(BaseHTTPRequestHandler):
    server_version = "VelesTPUForge/1"

    # -- helpers -------------------------------------------------------------
    def _json(self, payload, status=200):
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, status, message):
        self._json({"error": message}, status=status)

    def log_message(self, fmt, *args):  # route through the server's logger
        self.server.log("%s %s", self.address_string(), fmt % args)

    # -- GET -----------------------------------------------------------------
    def do_GET(self):
        store = self.server.store_dir
        if self.path == "/list":
            listing = [(os.path.basename(path), manifest)
                       for path, manifest in forge.list_store(store)]
            return self._json(listing)
        if self.path.startswith("/fetch/"):
            name = urllib.parse.unquote(self.path[len("/fetch/"):])
            for path, manifest in forge.list_store(store):
                if manifest["name"] == name:
                    size = os.path.getsize(path)
                    self.send_response(200)
                    self.send_header("Content-Type", "application/gzip")
                    self.send_header("Content-Length", str(size))
                    self.send_header(
                        "X-Forge-Package", os.path.basename(path))
                    self.end_headers()
                    with open(path, "rb") as f:
                        shutil.copyfileobj(f, self.wfile)
                    return
            return self._error(404, "no package named %r" % name)
        return self._error(404, "unknown path %r" % self.path)

    # -- POST ----------------------------------------------------------------
    def do_POST(self):
        if self.path != "/upload":
            return self._error(404, "unknown path %r" % self.path)
        length = int(self.headers.get("Content-Length", 0))
        if length <= 0:
            return self._error(400, "empty upload")
        if length > self.server.max_package_bytes:
            return self._error(413, "package exceeds %d bytes"
                               % self.server.max_package_bytes)
        # stage to a temp file, validate it IS a forge package (readable
        # manifest with safe member names), then publish atomically.
        # The staging suffix must NOT look like a package, or a concurrent
        # /list would try to read the half-written file.
        fd, tmp = tempfile.mkstemp(suffix=".upload.tmp",
                                   dir=self.server.store_dir)
        try:
            with os.fdopen(fd, "wb") as f:
                remaining = length
                while remaining:
                    chunk = self.rfile.read(min(65536, remaining))
                    if not chunk:
                        return self._error(400, "truncated upload")
                    f.write(chunk)
                    remaining -= len(chunk)
            try:
                manifest = forge.read_manifest(tmp)
                forge._safe_member(manifest["snapshot"])
                if "artifact" in manifest:
                    forge._safe_member(manifest["artifact"])
            except Exception as e:
                return self._error(400, "not a valid forge package: %s" % e)
            dest = forge.publish(tmp, self.server.store_dir)
            self._json({"stored": os.path.basename(dest),
                        "name": manifest["name"]})
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)


class ForgeServer:
    """Owns the HTTP server thread over a store directory."""

    def __init__(self, store_dir, host="127.0.0.1", port=0,
                 max_package_bytes=1 << 31):
        os.makedirs(store_dir, exist_ok=True)
        self._httpd = ThreadingHTTPServer((host, port), _ForgeHandler)
        self._httpd.store_dir = store_dir
        self._httpd.max_package_bytes = max_package_bytes
        from veles_tpu_torch.logger import Logger
        logger = Logger()
        self._httpd.log = lambda fmt, *a: logger.debug(fmt, *a)
        self._thread = None

    @property
    def port(self):
        return self._httpd.server_address[1]

    @property
    def url(self):
        return "http://%s:%d" % self._httpd.server_address[:2]

    def start(self):
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)


# ------------------------------------------------------------------ client
def upload(package_path, base_url, timeout=60):
    """Upload a package to a forge server; returns the server's record.

    The file object streams as the request body (packages can be GBs —
    never buffered whole in RAM)."""
    size = os.path.getsize(package_path)
    with open(package_path, "rb") as f:
        req = urllib.request.Request(
            base_url.rstrip("/") + "/upload", data=f,
            headers={"Content-Type": "application/gzip",
                     "Content-Length": str(size)}, method="POST")
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read().decode())


def list_remote(base_url, timeout=60):
    """[(package_file_name, manifest)] from a forge server."""
    with urllib.request.urlopen(base_url.rstrip("/") + "/list",
                                timeout=timeout) as resp:
        return [tuple(item) for item in json.loads(resp.read().decode())]


def fetch_remote(base_url, name, out_dir, timeout=60):
    """Download + unpack the newest package named ``name``; returns
    (manifest, snapshot_path) like ``forge.fetch``."""
    if not name or os.path.basename(name) != name:
        raise ValueError("unsafe package name %r" % (name,))
    os.makedirs(out_dir, exist_ok=True)
    url = base_url.rstrip("/") + "/fetch/" + urllib.parse.quote(name)
    package_path = os.path.join(out_dir, name + ".forge.tar.gz")
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        with open(package_path, "wb") as f:
            shutil.copyfileobj(resp, f)
    return forge.unpack(package_path, out_dir)
