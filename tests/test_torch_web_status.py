"""The port's web status (``web_status``) and structured event sinks
(``logger``) against the JAX package on the CPU.

What is held, and how closely:

- ``render_graph_svg`` gives the same text for the same nodes and edges,
  a cycle and out-of-range edges included;
- two dashboards fed the same rows answer the same ``/status.json``
  (apart from each row's ``updated``), ``/metrics``, ``/graph/*.dot``
  and ``.svg``, the same 400 for a bad report and the same 404s;
  ``/timeseries.json`` is 404 while no telemetry store is published
  (``tests/test_torch_timeseries.py`` serves one);
- ``StatusReporter``: under the epoch scan a run's row equals the
  reference's (numbers exact but the loss, within 1e-5, the MNIST-FC
  tolerance); in the graph loop the port's final row is the result's
  (epoch, best metric, complete) while the reference's stays an epoch
  behind (ROADMAP Queue 3); the row is keyed by the ``torch.distributed``
  rank; ``report_url`` posts into another dashboard; a streamed run's
  ``veles_stream_*`` gauges reach ``/metrics``;
- event sinks: the same records give JSON lines with the same keys and
  values apart from the time; ``MongoHandler`` raises the same
  ``RuntimeError`` text in both packages without ``pymongo``; a second
  ``setup_logging`` closes only the sinks the first installed.

The default dashboard and the logging namespace are process-global:
each test that touches them restores them.
"""

import json
import logging
import re
import socket
import urllib.error
import urllib.request

import numpy
import pytest
import torch

from veles_tpu import web_status as ref_ws
from veles_tpu_torch import prng
from veles_tpu_torch import web_status as ws
from veles_tpu_torch.config import root

GRAPHS = {
    "chain": (["a", "b", "c"], [(0, 1), (1, 2)]),
    "cycle": (["start", "repeater", "loader", "step", "decision", "end"],
              [(0, 1), (1, 2), (2, 3), (3, 4), (4, 1), (4, 5)]),
    "out_of_range": (["x", "y"], [(0, 1), (1, 5), (-1, 0)]),
    "escaped": (['<a&b>', 'a "quoted" label much longer than 22'],
                [(0, 1), (1, 0)]),
    "empty": ([], []),
    "diamond": (["s", "l", "r", "t"], [(0, 1), (0, 2), (1, 3), (2, 3)]),
}


@pytest.fixture(autouse=True)
def _fresh():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    for mod in (ws, ref_ws):
        if mod._default is not None:
            mod._default.stop()
        mod._default = None


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_svg_equals_the_reference(name):
    nodes, edges = GRAPHS[name]
    ours = ws.render_graph_svg(nodes, edges)
    assert ours == ref_ws.render_graph_svg(nodes, edges)
    assert ours.startswith("<svg") and ours.endswith("</svg>")


# ---------------------------------------------------------------- servers
ROWS = [
    ("mnist", dict(workflow="mnist", process=0, processes=1, epoch=3,
                   best=7, complete=True,
                   metrics={"validation": {"n_err": 7, "loss": 0.25}},
                   stream={"samples_per_sec": 1234.5, "windows": 6,
                           "dispatches": 42,
                           "staging_stall_fraction": 0.125},
                   graph_nodes=GRAPHS["cycle"][0],
                   graph_edges=[list(e) for e in GRAPHS["cycle"][1]],
                   graph_dot="digraph mnist {\n  u0 -> u1;\n}")),
    ("mnist@1", dict(workflow="mnist", process=1, processes=2, epoch=2,
                     best=None, complete=False, metrics={})),
    ('odd"name', dict(workflow='wf "q"\nx', process="p\\1", epoch="2",
                      best=1.5, complete=0)),
]


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, b""


def _post(url, body):
    req = urllib.request.Request(url, data=body, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        body = e.read()
        return e.code, (json.loads(body) if e.code == 400 else body)


@pytest.fixture
def servers(monkeypatch):
    """A dashboard of each package fed ``ROWS``; each package's registry
    of serving engines is emptied for the test (other test files in the
    process may have registered engines in one of them)."""
    from veles_tpu.serving import metrics as ref_metrics
    from veles_tpu_torch.serving import metrics
    for mod in (metrics, ref_metrics):
        monkeypatch.setattr(mod, "_registry", {})
    pair = [mod.WebStatus().start() for mod in (ws, ref_ws)]
    for status in pair:
        for name, fields in ROWS:
            status.update(name, **fields)
    yield ["http://127.0.0.1:%d" % s.port for s in pair]
    for status in pair:
        status.stop()


def _without_updated(body):
    snap = json.loads(body)
    for row in snap.values():
        assert isinstance(row.pop("updated"), float)
    return snap


def test_status_json_equals_the_reference(servers):
    (code_a, a), (code_b, b) = (_get(u + "/status.json") for u in servers)
    assert code_a == code_b == 200
    assert _without_updated(a) == _without_updated(b)


def test_metrics_equal_the_reference(servers):
    (code_a, a), (code_b, b) = (_get(u + "/metrics") for u in servers)
    assert code_a == code_b == 200
    assert a == b
    text = a.decode()
    assert 'veles_workflow_epoch{workflow="mnist",process="0"} 3' in text
    assert 'veles_stream_dispatches_total{workflow="mnist",process="0"} ' \
        '42' in text
    assert 'workflow="wf \\"q\\"\\nx",process="p\\\\1"' in text


@pytest.mark.parametrize("path", ["/graph/mnist.dot", "/graph/mnist.svg",
                                  "/", "/index.html"])
def test_pages_equal_the_reference(servers, path):
    (code_a, a), (code_b, b) = (_get(u + path) for u in servers)
    assert code_a == code_b == 200
    if path.startswith("/graph/"):
        assert a == b and a
    else:       # the page names its package; the rows are the same
        strip = re.compile(rb"veles_tpu(_torch)?|<td>[0-9.]+</td></tr>")
        assert strip.sub(b"", a) == strip.sub(b"", b)


@pytest.mark.parametrize("path", ["/nope", "/graph/unknown.svg",
                                  "/graph/mnist.png", "/graph/mnist@1.svg"])
def test_404s_equal_the_reference(servers, path):
    assert _get(servers[0] + path)[0] == _get(servers[1] + path)[0] == 404


def test_timeseries_is_404_without_a_store(servers):
    from veles_tpu_torch.serving import timeseries
    old = timeseries.get_default()
    timeseries.set_default(None)
    try:
        assert _get(servers[0] + "/timeseries.json?window=5")[0] == 404
    finally:
        timeseries.set_default(old)


@pytest.mark.parametrize("body", [b"not json", b'{"epoch": 1}', b"[1, 2]"])
def test_bad_report_is_400_in_both(servers, body):
    (code_a, a), (code_b, b) = (_post(u + "/report", body) for u in servers)
    assert code_a == code_b == 400
    assert a == b and "error" in a


def test_report_and_wrong_post_path(servers):
    for url in servers:
        assert _post(url + "/report", json.dumps(
            {"name": "remote", "epoch": 4}).encode()) == (200, {"ok": True})
        assert _post(url + "/other", b"{}")[0] == 404
    (_, a), (_, b) = (_get(u + "/status.json") for u in servers)
    assert _without_updated(a)["remote"] == {"epoch": 4}
    assert _without_updated(a) == _without_updated(b)


# -------------------------------------------------------- status reporter
SMALL = {"loader": {"minibatch_size": 50, "n_train": 230, "n_valid": 70},
         "decision": {"max_epochs": 2, "fail_iterations": 50},
         "layers": [{"type": "all2all_tanh", "output_sample_shape": 16,
                     "learning_rate": 0.03, "momentum": 0.9},
                    {"type": "softmax", "output_sample_shape": 10,
                     "learning_rate": 0.03, "momentum": 0.9}]}


def _port_workflow(seed=3, **kw):
    from veles_tpu_torch.samples import mnist
    prng.reset()
    prng.seed_all(seed)
    root.__dict__.pop("mnist", None)
    root.mnist.update({k: dict(v) if isinstance(v, dict) else list(v)
                       for k, v in SMALL.items()})
    wf = mnist.build(fused=True, **kw)
    root.__dict__.pop("mnist", None)
    return wf


def _port_run(scan=0, stream_window=0, seed=3, report_url=None):
    from veles_tpu_torch.launcher import Launcher
    wf = _port_workflow(seed)
    status = ws.attach_web_status(wf, report_url=report_url)
    launcher = Launcher(wf, stats=False, device="cpu", epoch_scan=scan,
                        stream_window=stream_window)
    launcher.boot()
    return wf, status, launcher


def _reference_run(scan=0, seed=3):
    from veles_tpu import prng as jax_prng
    from veles_tpu.config import root as jax_root
    from veles_tpu.launcher import Launcher
    from veles_tpu.samples import mnist
    saved = jax_root.__dict__.pop("mnist", None)
    try:
        jax_prng.reset()
        jax_prng.seed_all(seed)
        jax_root.mnist.update({k: dict(v) if isinstance(v, dict)
                               else list(v) for k, v in SMALL.items()})
        wf = mnist.build(fused=True)
        status = ref_ws.attach_web_status(wf)
        Launcher(wf, stats=False, epoch_scan=scan).boot()
        return wf, status
    finally:
        jax_root.__dict__.pop("mnist", None)
        if saved is not None:
            jax_root.__dict__["mnist"] = saved
        jax_prng.reset()


def _rows_match(ours, theirs):
    ours, theirs = dict(ours), dict(theirs)
    for row in (ours, theirs):
        row.pop("updated")
    m_ours, m_theirs = ours.pop("metrics"), theirs.pop("metrics")
    assert ours == theirs
    assert list(m_ours) == list(m_theirs)
    for set_name, values in m_ours.items():
        assert list(values) == list(m_theirs[set_name])
        for key, value in values.items():
            if key == "loss":
                assert abs(value - m_theirs[set_name][key]) < 1e-5
            else:
                assert value == m_theirs[set_name][key]


def test_scan_row_equals_the_reference():
    wf, status, _ = _port_run(scan=1)
    ref_wf, ref_status = _reference_run(scan=1)
    try:
        ours, theirs = status.snapshot(), ref_status.snapshot()
        assert list(ours) == list(theirs) == ["mnist"]
        _rows_match(ours["mnist"], theirs["mnist"])
        assert ours["mnist"]["epoch"] == 2 and ours["mnist"]["complete"]
        assert ours["mnist"]["graph_nodes"] == wf.graph_data()[0]
    finally:
        status.stop()
        ref_status.stop()


def test_graph_loop_final_row_is_the_result():
    """The port reports once more at stop(), so its row holds the run's
    end; the reference's reporter, linked after the end point, misses
    the completion wave and keeps the epoch before."""
    wf, status, launcher = _port_run()
    ref_wf, ref_status = _reference_run()
    try:
        row = status.snapshot()["mnist"]
        summary = launcher.result_summary()
        assert row["epoch"] == 2 == summary["best_epoch"]
        assert row["best"] == summary["best_metric"]
        assert row["complete"] is True
        assert row["metrics"] == summary["last_epoch_metrics"]
        theirs = ref_status.snapshot()["mnist"]
        assert theirs["epoch"] == 1 and theirs["complete"] is False
        assert ref_wf.decision.best_epoch == 2
    finally:
        status.stop()
        ref_status.stop()


def test_reporter_reads_only_epoch_ends():
    """Besides its first report, the reporter reports at epoch ends and
    at stop(): the same rows as a report every minibatch."""
    from veles_tpu_torch.launcher import Launcher
    wf = _port_workflow()
    status = ws.WebStatus()
    reporter = ws.StatusReporter(wf, status=status, name="rep")
    reporter.link_from(wf.decision)
    reports = []
    inner = reporter.report
    reporter.report = lambda: (reports.append(int(wf.loader.epoch_number)),
                               inner())
    Launcher(wf, stats=False, device="cpu").boot()
    assert reports == [0, 1, 2]
    assert reporter.run_count > len(reports)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_process_info_and_row_key(monkeypatch):
    import torch.distributed as dist
    wf = _port_workflow()
    reporter = ws.StatusReporter(wf, status=ws.WebStatus(), name="rep")
    assert reporter._process_info() == (0, 1)
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d"
                            % _free_port(), rank=0, world_size=1)
    try:
        assert reporter._process_info() == (0, 1)
    finally:
        dist.destroy_process_group()
    monkeypatch.setattr(ws.StatusReporter, "_process_info",
                        lambda self: (1, 2))
    wf.initialize(device="cpu")
    reporter.report()
    row = reporter.status.snapshot()["mnist@1"]
    assert (row["process"], row["processes"]) == (1, 2)


def test_report_url_posts_into_another_dashboard():
    remote = ws.WebStatus().start()
    try:
        _port_run(report_url="http://127.0.0.1:%d" % remote.port)
        row = remote.snapshot()["mnist"]
        assert row["epoch"] == 2 and row["complete"] is True
        assert "graph_dot" in row
    finally:
        remote.stop()


def test_stream_gauges_reach_metrics():
    wf, status, _ = _port_run(stream_window=2)
    try:
        stats = wf._stream_stats
        # 2 epochs x (5 train steps + 2 validation minibatches)
        assert stats["dispatches"] == 2 * (5 + 2)
        code, body = _get("http://127.0.0.1:%d/metrics" % status.port)
        text = body.decode()
        assert code == 200
        for gauge in ("veles_stream_samples_per_sec",
                      "veles_stream_staging_stall_fraction",
                      "veles_stream_windows_total"):
            assert gauge + '{workflow="mnist",process="0"}' in text
        assert 'veles_stream_dispatches_total{workflow="mnist",' \
            'process="0"} 14' in text
        assert 'veles_workflow_complete{workflow="mnist",process="0"} 1' \
            in text
    finally:
        status.stop()


# ------------------------------------------------------------ event sinks
@pytest.fixture
def namespace():
    """Restore the logging namespace and both packages' sink state."""
    from veles_tpu import logger as ref_logger
    from veles_tpu_torch import logger
    base = logging.getLogger(logger.NAMESPACE)
    saved = (base.handlers[:], base.level, base.propagate,
             list(logger._State.installed), logger._State.configured,
             list(ref_logger._installed), ref_logger._configured)
    yield base
    for h in base.handlers[:]:
        if h not in saved[0]:
            base.removeHandler(h)
            h.close()
    base.handlers[:] = saved[0]
    base.setLevel(saved[1])
    base.propagate = saved[2]
    logger._State.installed, logger._State.configured = saved[3], saved[4]
    ref_logger._installed, ref_logger._configured = saved[5], saved[6]


def _records():
    out = []
    for i, level in enumerate((logging.INFO, logging.WARNING,
                               logging.ERROR, logging.DEBUG)):
        rec = logging.LogRecord("veles.Unit.u%d" % i, level, __file__, 1,
                                "epoch %d — %s", (i, "ü"), None)
        rec.created = 1000.0 + i
        out.append(rec)
    return out


def test_json_lines_equal_the_reference(tmp_path):
    from veles_tpu import logger as ref_logger
    from veles_tpu_torch import logger
    lines = []
    for mod, name in ((logger, "ours"), (ref_logger, "theirs")):
        handler = mod.JsonLinesHandler(str(tmp_path / name))
        for rec in _records():
            handler.emit(rec)
        handler.close()
        lines.append((tmp_path / name).read_text().splitlines())
    assert len(lines[0]) == len(lines[1]) == 4
    for a, b in zip(*lines):
        a, b = json.loads(a), json.loads(b)
        assert list(a) == list(b) == ["t", "level", "logger", "msg"]
        assert a == b


def test_mongo_gate_text_equals_the_reference():
    from veles_tpu import logger as ref_logger
    from veles_tpu_torch import logger
    texts = []
    for mod in (logger, ref_logger):
        with pytest.raises(RuntimeError) as info:
            mod.MongoHandler("mongodb://127.0.0.1:1")
        texts.append(str(info.value))
    assert texts[0] == texts[1] and "pymongo" in texts[0]


def test_setup_logging_closes_only_its_own_sinks(tmp_path, namespace):
    from veles_tpu_torch import logger
    host = logging.StreamHandler()
    namespace.addHandler(host)
    logger.setup_logging(events_file=str(tmp_path / "a.jsonl"))
    first = list(logger._State.installed)
    assert len(first) == 2
    logging.getLogger("veles.test").info("one")
    logger.setup_logging(events_file=str(tmp_path / "b.jsonl"))
    assert host in namespace.handlers
    assert not any(h in namespace.handlers for h in first)
    assert first[1]._file.closed
    logging.getLogger("veles.test").info("two")
    a = [json.loads(x) for x in (tmp_path / "a.jsonl").read_text()
         .splitlines()]
    b = [json.loads(x) for x in (tmp_path / "b.jsonl").read_text()
         .splitlines()]
    assert [e["msg"] for e in a] == ["one"] and [e["msg"] for e in b] == \
        ["two"]
    with pytest.raises(RuntimeError, match="pymongo"):
        logger.setup_logging(events_mongo="mongodb://127.0.0.1:1")
    numpy.testing.assert_equal(logger._State.installed, [])
    assert host in namespace.handlers
