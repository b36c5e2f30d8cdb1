"""Web status: a live dashboard of running workflows.

Port of ``veles_tpu/web_status.py`` (ref: veles/web_status.py and its
web/ frontend [M]): a standard-library HTTP server on a background
thread serving

- ``/status.json``        — a machine-readable snapshot;
- ``/``                   — a self-refreshing HTML table (a row per
  workflow per process, keyed by the ``torch.distributed`` rank);
- ``/metrics``            — Prometheus text: the serving engines'
  counters (``serving/metrics.py``) and a gauge set per row;
- ``/graph/<name>.dot``   — the unit graph as graphviz dot text
  (``Workflow.generate_graph``);
- ``/graph/<name>.svg``   — the same graph drawn by a small built-in
  layered-DAG renderer (no graphviz binary needed);
- ``/timeseries.json``    — the process's default telemetry store
  (``serving/timeseries.py``'s ``get_default``, published by
  ``serve_lm(telemetry=)``), so the dashboard and the serving port
  expose the same rings, with the same ``?window=S`` (a bad value
  falls back to 60 s: the dashboard is best-effort, not an API); 404
  while no store is published;
- ``POST /report``        — a row from another process (400 on a bad
  body).

Workflows register themselves through :class:`StatusReporter`; the
other ranks of a distributed run (or remote launchers) report into rank
0's dashboard over ``POST /report``.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from veles_tpu_torch.units import Unit

_PAGE = """<!doctype html><html><head><meta charset="utf-8">
<meta http-equiv="refresh" content="2"><title>veles_tpu_torch status</title>
<style>body{font-family:monospace} table{border-collapse:collapse}
td,th{border:1px solid #999;padding:4px 8px}</style></head><body>
<h2>veles_tpu_torch — running workflows</h2><table><tr>
<th>workflow</th><th>proc</th><th>epoch</th><th>best</th>
<th>last metrics</th><th>graph</th><th>updated</th></tr>%s</table>
</body></html>"""


def _svg_escape(s):
    return (str(s).replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;").replace('"', "&quot;"))


def render_graph_svg(nodes, edges):
    """Layered-DAG SVG of a unit graph — the dependency-free stand-in
    for the reference's JS graph viewer.

    ``nodes``: list of labels; ``edges``: list of (src_idx, dst_idx).
    Layering = longest path from any source, with back-edges (the
    Repeater cycle) ignored for layout but still DRAWN (curved, dashed)
    so the control loop stays visible.
    """
    n = len(nodes)
    adj = [[] for _ in range(n)]
    for s, d in edges:
        if 0 <= s < n and 0 <= d < n:
            adj[s].append(d)

    # DFS from every source to find back-edges (cycle closers)
    color = [0] * n          # 0 white, 1 on-stack, 2 done
    back = set()

    def dfs(u):
        color[u] = 1
        for v in adj[u]:
            if color[v] == 1:
                back.add((u, v))
            elif color[v] == 0:
                dfs(v)
        color[u] = 2

    for u in range(n):
        if color[u] == 0:
            dfs(u)

    fwd = [(s, d) for s, d in edges
           if 0 <= s < n and 0 <= d < n and (s, d) not in back]
    # longest-path layering over the acyclic forward edges
    layer = [0] * n
    for _ in range(n):
        changed = False
        for s, d in fwd:
            if layer[d] < layer[s] + 1:
                layer[d] = layer[s] + 1
                changed = True
        if not changed:
            break

    by_layer = {}
    for i in range(n):
        by_layer.setdefault(layer[i], []).append(i)
    bw, bh, hgap, vgap, pad = 150, 28, 30, 46, 20
    pos = {}
    width = pad * 2
    for ly in sorted(by_layer):
        row = by_layer[ly]
        for col, i in enumerate(row):
            pos[i] = (pad + col * (bw + hgap), pad + ly * (bh + vgap))
        width = max(width, pad * 2 + len(row) * (bw + hgap) - hgap)
    height = pad * 2 + (max(by_layer) + 1) * (bh + vgap) - vgap \
        if by_layer else pad * 2

    parts = ['<svg xmlns="http://www.w3.org/2000/svg" width="%d" '
             'height="%d" font-family="monospace" font-size="12">'
             % (width, height),
             '<defs><marker id="arr" markerWidth="8" markerHeight="8" '
             'refX="7" refY="3" orient="auto"><path d="M0,0 L7,3 L0,6 z" '
             'fill="#555"/></marker></defs>']
    for s, d in edges:
        if not (0 <= s < n and 0 <= d < n):
            continue
        x1, y1 = pos[s][0] + bw / 2, pos[s][1] + bh
        x2, y2 = pos[d][0] + bw / 2, pos[d][1]
        if (s, d) in back:    # curved dashed return edge (the cycle)
            y1, y2 = pos[s][1] + bh / 2, pos[d][1] + bh / 2
            x1, x2 = pos[s][0], pos[d][0]
            bend = min(pos[s][0], pos[d][0]) - 40
            parts.append(
                '<path d="M%g,%g C%g,%g %g,%g %g,%g" fill="none" '
                'stroke="#999" stroke-dasharray="4 3" '
                'marker-end="url(#arr)"/>' % (x1, y1, bend, y1,
                                              bend, y2, x2, y2))
        else:
            parts.append('<line x1="%g" y1="%g" x2="%g" y2="%g" '
                         'stroke="#555" marker-end="url(#arr)"/>'
                         % (x1, y1, x2, y2))
    for i, label in enumerate(nodes):
        x, y = pos[i]
        parts.append('<rect x="%g" y="%g" width="%d" height="%d" '
                     'fill="#eef" stroke="#336"/>' % (x, y, bw, bh))
        parts.append('<text x="%g" y="%g" text-anchor="middle">%s</text>'
                     % (x + bw / 2, y + bh / 2 + 4,
                        _svg_escape(label[:22])))
    parts.append("</svg>")
    return "".join(parts)


class WebStatus:
    """The dashboard server; share one instance per process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries = {}
        self._server = None
        self._thread = None
        self.port = None

    # ------------------------------------------------------------- reporting
    def update(self, name, **fields):
        with self._lock:
            entry = self._entries.setdefault(name, {})
            entry.update(fields, updated=time.time())

    def snapshot(self):
        with self._lock:
            return json.loads(json.dumps(self._entries, default=str))

    def _graph_entry(self, name):
        with self._lock:
            for key, e in self._entries.items():
                if (key == name or e.get("workflow") == name) \
                        and "graph_nodes" in e:
                    return (e["graph_nodes"],
                            [tuple(x) for x in e.get("graph_edges", [])],
                            e.get("graph_dot", ""))
        return None

    def render_metrics(self):
        """Prometheus text: serving-engine counters + one gauge set per
        workflow row (epoch, best metric when numeric, completeness).

        Rows arrive over ``POST /report`` (arbitrary JSON), so every
        interpolated value is sanitized — label values escaped per the
        exposition format, sample values emitted only when numeric — or
        one malformed report would invalidate the whole scrape."""
        from veles_tpu_torch.serving import metrics as serving_metrics

        def esc(v):     # Prometheus label-value escaping
            return (str(v).replace("\\", "\\\\").replace('"', '\\"')
                    .replace("\n", "\\n"))

        def num(v):
            return v if isinstance(v, (int, float)) \
                and not isinstance(v, bool) else None

        lines = []
        for name, e in sorted(self.snapshot().items()):
            label = '{workflow="%s",process="%s"}' % (
                esc(e.get("workflow", name)), esc(e.get("process", 0)))
            if num(e.get("epoch")) is not None:
                lines.append("veles_workflow_epoch%s %g"
                             % (label, e["epoch"]))
            if num(e.get("best")) is not None:
                lines.append("veles_workflow_best_metric%s %g"
                             % (label, e["best"]))
            lines.append("veles_workflow_complete%s %d"
                         % (label, 1 if e.get("complete") else 0))
            stream = e.get("stream")
            if isinstance(stream, dict):
                # streaming windowed epoch-scan health (epoch_driver.py):
                # is the input pipeline keeping the device fed?
                for key, gauge in (
                        ("samples_per_sec",
                         "veles_stream_samples_per_sec"),
                        ("staging_stall_fraction",
                         "veles_stream_staging_stall_fraction"),
                        ("windows", "veles_stream_windows_total"),
                        ("dispatches", "veles_stream_dispatches_total")):
                    if num(stream.get(key)) is not None:
                        lines.append("%s%s %g"
                                     % (gauge, label, stream[key]))
        return serving_metrics.render_prometheus(lines)

    # ---------------------------------------------------------------- server
    def start(self, host="127.0.0.1", port=0):
        status = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.startswith("/status.json"):
                    body = json.dumps(status.snapshot(),
                                      default=str).encode()
                    ctype = "application/json"
                elif self.path.rstrip("/") == "/metrics":
                    # one scrape surface for everything: the serving
                    # engines' counters (the serving.metrics registry)
                    # plus this dashboard's workflow rows as gauges
                    body = status.render_metrics().encode()
                    ctype = "text/plain; version=0.0.4"
                elif self.path.split("?")[0].rstrip("/") \
                        == "/timeseries.json":
                    import urllib.parse
                    from veles_tpu_torch.serving import timeseries
                    store = timeseries.get_default()
                    if store is None:
                        self.send_error(404)
                        return
                    query = urllib.parse.parse_qs(
                        urllib.parse.urlsplit(self.path).query)
                    window = 60.0
                    try:
                        w = float(query.get("window", ["60"])[0])
                        if w > 0 and w != float("inf"):
                            window = w
                    except ValueError:
                        pass
                    body = json.dumps(
                        store.snapshot(window_s=window)).encode()
                    ctype = "application/json"
                elif self.path.startswith("/graph/"):
                    target = self.path[len("/graph/"):]
                    base, _, ext = target.rpartition(".")
                    found = status._graph_entry(base)
                    if found is None or ext not in ("svg", "dot"):
                        self.send_error(404)
                        return
                    nodes, graph_edges, dot = found
                    if ext == "dot":
                        body, ctype = dot.encode(), "text/plain"
                    else:
                        body = render_graph_svg(
                            nodes, graph_edges).encode()
                        ctype = "image/svg+xml"
                elif self.path == "/" or self.path.startswith("/index"):
                    import html as html_mod
                    rows = ""
                    for name, e in sorted(status.snapshot().items()):
                        wf_name = e.get("workflow", name)
                        graph = ('<a href="/graph/%s.svg">svg</a> '
                                 '<a href="/graph/%s.dot">dot</a>'
                                 % (name, name)
                                 if "graph_nodes" in e else "")
                        cells = "".join(
                            "<td>%s</td>" % html_mod.escape(str(v))
                            for v in (
                                wf_name,
                                "%s/%s" % (e.get("process", 0),
                                           e.get("processes", 1)),
                                e.get("epoch", ""), e.get("best", ""),
                                e.get("metrics", "")))
                        rows += ("<tr>%s<td>%s</td><td>%s</td></tr>"
                                 % (cells, graph,
                                    html_mod.escape(
                                        str(e.get("updated", "")))))
                    body = (_PAGE % rows).encode()
                    ctype = "text/html"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                # remote report-in: the other ranks of a distributed
                # run (or remote launchers) push their rows here, as
                # the reference's slaves reported to its master
                if self.path.rstrip("/") != "/report":
                    self.send_error(404)
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length))
                    name = payload.pop("name")
                    status.update(str(name), **payload)
                    body = b'{"ok": true}'
                    self.send_response(200)
                except Exception as e:   # noqa: BLE001 — told to client
                    body = json.dumps({"error": str(e)}).encode()
                    self.send_response(400)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


_default = None


def get_default():
    global _default
    if _default is None:
        _default = WebStatus()
    return _default


def post_report(url, name, **fields):
    """Report one row into a remote dashboard (``POST /report``)."""
    import urllib.request
    req = urllib.request.Request(
        url.rstrip("/") + "/report",
        data=json.dumps({"name": name, **fields}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as resp:
        return json.loads(resp.read())


def attach_web_status(workflow, port=0, report_url=None,
                      host="127.0.0.1"):
    """The dashboard's wiring (CLI ``--web-status``): start a local
    server (or target a remote one through ``report_url``) and link a
    :class:`StatusReporter` off the workflow's decision so every epoch
    pushes a row.  Returns the local WebStatus (None with
    ``report_url``).  Across hosts, rank 0 must bind a reachable
    interface (``host="0.0.0.0"``, CLI ``--web-status-host``) or the
    other ranks' ``POST /report`` cannot reach it."""
    status = None
    if report_url is None:
        status = WebStatus().start(host=host, port=port)
    reporter = StatusReporter(workflow, status=status,
                              report_url=report_url,
                              name="web_status_reporter")
    decision = getattr(workflow, "decision", None)
    if decision is not None:
        reporter.link_from(decision)
    return status


class StatusReporter(Unit):
    """Graph unit pushing the decision's progress into a WebStatus.

    Link it from the decision (``attach_web_status`` does); it reads the
    decision directly.  Rows are keyed ``<workflow>[@<rank>]``, so a
    distributed run shows one row a rank; the unit graph is pushed with
    the first row and served at ``/graph/<row>.svg`` / ``.dot``.  Pass
    ``report_url`` to push rows to another process's dashboard instead
    of a local one (how the reference's slaves reported to its master).

    It reports on its first run, at each epoch end and once more at
    ``stop()``: the completion wave ends the graph loop before a unit
    linked after the end point fires, so without the last report the
    row would stay an epoch behind (the reference's does; it runs on
    every minibatch, which only repeats the same row).  The epoch-scan
    driver calls :meth:`report` at its chunk boundaries.  Every value is
    a host copy: a report reads nothing from the card.
    """

    def __init__(self, workflow, status=None, report_url=None, **kwargs):
        super().__init__(workflow, **kwargs)
        self.report_url = report_url
        self.status = None if report_url else (status or get_default())
        self._graph_pushed = False
        self._reported = False

    def _process_info(self):
        """(rank, world size) of the joined ``torch.distributed`` run,
        or (0, 1) outside one."""
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
        return 0, 1

    def run(self):
        if self._reported and not getattr(
                getattr(self.workflow, "loader", None), "epoch_ended", True):
            return
        self.report()

    def stop(self):
        if self._reported:
            self.report()

    def report(self):
        """Push the current row."""
        self._reported = True
        wf = self.workflow
        decision = getattr(wf, "decision", None)
        if decision is None:
            return
        proc, procs = self._process_info()
        row = wf.name if procs == 1 else "%s@%d" % (wf.name, proc)
        last = decision.epoch_metrics[-1] if decision.epoch_metrics else {}
        metrics = {set_name: {k: v for k, v in m.items()
                              if isinstance(v, (int, float))}
                   for set_name, m in last.items()}
        fields = dict(
            workflow=wf.name, process=proc, processes=procs,
            epoch=int(getattr(decision, "epoch_number", 0)),
            best=decision.best_metric,
            complete=bool(decision.complete),
            metrics=metrics)
        stream = getattr(wf, "_stream_stats", None)
        if stream:
            # streaming windowed epoch-scan counters (numbers only —
            # rows also arrive over POST /report from remote processes)
            fields["stream"] = {k: v for k, v in stream.items()
                                if isinstance(v, (int, float))
                                and not isinstance(v, bool)}
        if not self._graph_pushed:
            nodes, edges = wf.graph_data()
            fields.update(graph_nodes=nodes,
                          graph_edges=[list(e) for e in edges],
                          graph_dot=wf.generate_graph())
            self._graph_pushed = True
        if self.report_url is not None:
            # best-effort: a dashboard outage or network blip must never
            # abort the training run it reports on
            try:
                post_report(self.report_url, row, **fields)
            except Exception as e:   # noqa: BLE001 — logged, not fatal
                self._graph_pushed = False     # retry the graph later
                self.warning("status report to %s failed: %s",
                             self.report_url, e)
        else:
            self.status.update(row, **fields)
