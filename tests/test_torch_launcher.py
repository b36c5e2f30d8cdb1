"""The port's Launcher and CLI (``python -m veles_tpu_torch``) on the CPU:
the reference's launcher and CLI tests (``tests/test_launcher.py``,
``tests/test_snapshot.py::test_cli_*``) run on the port, in process
(``main(argv)`` with ``-d cpu``), and one run in a subprocess that shows
the CLI never imports ``jax`` or ``veles_tpu``."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy
import pytest
import torch

from veles_tpu_torch import __main__ as cli
from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.launcher import Launcher
from veles_tpu_torch.samples import mnist

ROOT = Path(__file__).resolve().parent.parent
SMALL = ["root.mnist.loader.n_train=230", "root.mnist.loader.n_valid=70",
         "root.mnist.loader.minibatch_size=50",
         "root.mnist.decision.max_epochs=2",
         "root.mnist.layers=[{'type': 'all2all_tanh', "
         "'output_sample_shape': 16, 'learning_rate': 0.03, "
         "'momentum': 0.9}, {'type': 'softmax', 'output_sample_shape': 10, "
         "'learning_rate': 0.03, 'momentum': 0.9}]"]


@pytest.fixture(autouse=True)
def _fresh():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prng.reset()
    root.__dict__.pop("mnist", None)
    yield
    root.__dict__.pop("mnist", None)
    torch.set_num_threads(threads)


def _cli(*argv):
    assert cli.main(["veles_tpu_torch.samples.mnist", "-d", "cpu",
                     "--random-seed", "3", "--no-stats", *argv,
                     *SMALL]) == 0
    return cli.main.workflow, cli.main.launcher


def _weights(wf):
    return [numpy.array(v.mem) for f in wf.forwards if f.has_params
            for v in (f.weights, f.bias)]


def test_cli_trains_writes_result_and_snapshots(tmp_path):
    result = tmp_path / "r.json"
    wf, launcher = _cli("--epoch-scan", "1", "--snapshot-dir",
                        str(tmp_path / "snaps"), "--result-file", str(result))
    assert wf.is_finished and int(wf.loader.epoch_number) == 2
    summary = json.loads(result.read_text())
    assert summary["workflow"] == "mnist"
    assert summary["best_epoch"] == wf.decision.best_epoch
    assert summary["last_epoch_metrics"]["validation"]["n_err"] == \
        wf.decision.epoch_metrics[-1]["validation"]["n_err"]
    assert summary["snapshot"].startswith(str(tmp_path / "snaps"))
    assert launcher.driver is not None


def test_cli_overrides_after_flags_and_config_file(tmp_path):
    config = tmp_path / "cfg.py"
    config.write_text("root.mnist.decision.fail_iterations = 7\n")
    argv = ["veles_tpu_torch.samples.mnist", str(config), "-d", "cpu",
            "--no-stats", "--graph", str(tmp_path / "g.dot")] + SMALL
    assert cli.main(argv) == 0
    wf = cli.main.workflow
    assert wf.decision.fail_iterations == 7
    assert (tmp_path / "g.dot").read_text().startswith("digraph")


def test_cli_dump_config_list_units_version(capsys):
    assert cli.main(["veles_tpu_torch.samples.mnist", "--dump-config",
                     "root.mnist.loader.n_train=123"]) == 0
    assert "123" in capsys.readouterr().out
    assert cli.main(["x", "--list-units"]) == 0
    units = capsys.readouterr().out.split()
    assert "veles_tpu_torch.ops.decision.DecisionGD" in units
    with pytest.raises(SystemExit):
        cli.main(["x", "--version"])
    assert capsys.readouterr().out.startswith("veles_tpu_torch ")


@pytest.mark.parametrize("flags,item", [
    (["--serve-tp", "2"], "Queue 1, item 4"),
    (["--serve-trace", "all", "--serve-telemetry"], "Queue 1, item 7"),
    (["--serve-model-dir", "d"], "Queue 1, item 9"),
    (["--fault-plan", "p.json"], "Queue 2a, item 15"),
])
def test_unported_flags_raise_before_training(flags, item, monkeypatch):
    """Each unported flag raises naming its item before anything trains
    (``--serve`` and the engine's ``--serve-*`` flags are ported: see
    ``test_lm_serve_flags_reach_serve_lm``).  ``--fault-plan`` and the
    trace and telemetry flags (their items done) are not refused: the
    run starts, and they are armed when it serves
    (``tests/test_torch_serving_faults.py``,
    ``tests/test_torch_timeseries.py``)."""
    booted = []
    if flags[0] in ("--fault-plan", "--serve-trace"):
        monkeypatch.setattr(Launcher, "boot",
                            lambda self: booted.append(True))
        try:
            assert cli.main(["veles_tpu_torch.samples.char_lm", "-d", "cpu",
                             *flags]) == 0
        finally:
            root.__dict__.pop("char_lm", None)
        assert booted == [True]
        return
    monkeypatch.setattr(Launcher, "boot", lambda self: pytest.fail(
        "the run started before %s was refused" % flags[0]))
    with pytest.raises(NotImplementedError, match=item):
        cli.main(["veles_tpu_torch.samples.char_lm", "-d", "cpu", *flags])
    root.__dict__.pop("char_lm", None)


@pytest.mark.parametrize("flags,want", [
    (["--serve", "0"], dict(slots=0, prefix_cache=0, prefill_chunk=0,
                            spec_k=0, paged_kv=True, megastep=0,
                            replicas=1, router="metrics", health=False,
                            hedge=0.0, retries=0,
                            fault_plan=None, trace="off", trace_last=256,
                            telemetry=0.0, slo=None)),
    (["--serve", "0", "--serve-slots", "4", "--serve-prefix-cache", "8",
      "--serve-prefill-chunk", "16", "--serve-spec-k", "2",
      "--serve-paged-kv", "40", "--serve-megastep", "4",
      "--serve-replicas", "2", "--serve-router", "round_robin",
      "--serve-health", "--serve-hedge", "0.5", "--serve-retries", "2",
      "--serve-trace", "sample:0.5", "--serve-trace-last", "32",
      "--serve-telemetry", "--serve-slo", "default"],
     dict(slots=4, prefix_cache=8, prefill_chunk=16, spec_k=2,
          paged_kv=40, megastep=4, replicas=2, router="round_robin",
          health=True, hedge=0.5, retries=2, fault_plan=None, trace="sample:0.5",
          trace_last=32, telemetry=1.0, slo=True)),
])
def test_lm_serve_flags_reach_serve_lm(flags, want, monkeypatch, capsys):
    """``--serve`` on an LM workflow serves it through ``serve_lm`` after
    the run, with the engine's six ``--serve-*`` flags forwarded
    (``--serve-paged-kv`` 0 is the port's paged default), the fleet's
    ``--serve-replicas`` and ``--serve-router``, its resilience flags
    ``--serve-health``, ``--serve-hedge`` and ``--serve-retries``, and
    the trace,
    telemetry (a bare flag: 1 s) and SLO (``default``: the stock
    objectives) flags."""
    from veles_tpu_torch import restful_api
    seen = {}

    class Served:
        port = 4321
        stopped = False

        def stop(self):
            Served.stopped = True

    def fake_serve_lm(wf, port, **kw):
        seen.update(kw, port=port, trainer=wf.trainer)
        return Served()
    monkeypatch.setattr(Launcher, "boot", lambda self: None)
    monkeypatch.setattr(restful_api, "serve_lm", fake_serve_lm)
    monkeypatch.setattr(cli, "_wait_for_interrupt", lambda: None)
    try:
        assert cli.main(["veles_tpu_torch.samples.char_lm", "-d", "cpu",
                         *flags]) == 0
    finally:
        root.__dict__.pop("char_lm", None)
    assert hasattr(seen.pop("trainer"), "n_heads")
    assert seen == dict(want, port=0) and Served.stopped
    assert "SERVING http://127.0.0.1:4321/predict" in capsys.readouterr().out


@pytest.fixture
def dashboards(monkeypatch):
    """Every dashboard ``--web-status`` starts in this process, stopped
    after the test."""
    from veles_tpu_torch import web_status
    started = []
    attach = web_status.attach_web_status

    def keep(*args, **kwargs):
        status = attach(*args, **kwargs)
        if status is not None:
            started.append(status)
        return status
    monkeypatch.setattr(web_status, "attach_web_status", keep)
    yield started
    for status in started:
        status.stop()


def _status_json(url):
    import urllib.request
    with urllib.request.urlopen(url.rstrip("/") + "/status.json",
                                timeout=10) as resp:
        return json.loads(resp.read())


def test_web_status_prints_its_line_and_serves_the_row(capsys, dashboards):
    wf, launcher = _cli("--web-status", "0")
    line = [x for x in capsys.readouterr().out.splitlines()
            if x.startswith("WEBSTATUS ")]
    assert line == ["WEBSTATUS http://127.0.0.1:%d/" % dashboards[0].port]
    row = _status_json(line[0].split()[1])["mnist"]
    assert row["epoch"] == 2 == int(wf.loader.epoch_number)
    assert row["best"] == wf.decision.best_metric
    assert row["complete"] is True and "graph_dot" in row


def test_web_status_url_posts_into_a_dashboard(capsys):
    from veles_tpu_torch.web_status import WebStatus
    remote = WebStatus().start()
    try:
        wf, launcher = _cli("--web-status-url",
                            "http://127.0.0.1:%d" % remote.port,
                            "--epoch-scan", "1")
        assert "WEBSTATUS" not in capsys.readouterr().out
        row = remote.snapshot()["mnist"]
        summary = launcher.result_summary()
        assert row["epoch"] == summary["best_epoch"] == 2
        assert row["metrics"] == summary["last_epoch_metrics"]
    finally:
        remote.stop()


@pytest.fixture
def namespace():
    """The framework's logging namespace, restored after the test."""
    import logging
    from veles_tpu_torch import logger
    base = logging.getLogger(logger.NAMESPACE)
    saved = (base.handlers[:], base.level, list(logger._State.installed),
             logger._State.configured)
    yield base
    for h in base.handlers[:]:
        if h not in saved[0]:
            base.removeHandler(h)
            h.close()
    base.handlers[:] = saved[0]
    base.setLevel(saved[1])
    logger._State.installed, logger._State.configured = saved[2], saved[3]


def test_events_file_writes_parseable_lines(tmp_path, namespace):
    events = tmp_path / "events.jsonl"
    wf, _ = _cli("--events-file", str(events))
    lines = [json.loads(x) for x in events.read_text().splitlines()]
    assert lines and all(list(e) == ["t", "level", "logger", "msg"]
                         for e in lines)
    epochs = [e for e in lines if e["logger"] == "veles.DecisionGD.decision"]
    assert [e["msg"].split(" ")[1] for e in epochs] == ["1", "2"]
    assert all(e["level"] == "INFO" for e in epochs)


def test_events_mongo_exits_2_naming_pymongo(capsys, namespace):
    with pytest.raises(SystemExit) as info:
        cli.main(["veles_tpu_torch.samples.mnist", "-d", "cpu",
                  "--events-mongo", "mongodb://127.0.0.1:1"])
    assert info.value.code == 2
    assert "pymongo" in capsys.readouterr().err
    assert "mnist" not in root.__dict__ or "layers" not in root.mnist


def test_every_reference_flag_parses():
    """Any reference command line parses: every reference option is an
    option here too."""
    from veles_tpu.__main__ import build_argparser as reference
    ours = {a for action in cli.build_argparser()._actions
            for a in action.option_strings}
    theirs = {a for action in reference()._actions
              for a in action.option_strings}
    assert theirs <= ours


def test_evaluate_leaves_weights_bit_equal(tmp_path):
    snaps = tmp_path / "snaps"
    trained, _ = _cli("--snapshot-dir", str(snaps))
    before = _weights(trained)
    prng.reset()
    root.__dict__.pop("mnist", None)
    wf, launcher = _cli("--snapshot", "auto", "--snapshot-dir", str(snaps),
                        "--evaluate")
    assert launcher.restored_payload["epoch"] == 2
    assert wf.fused_step.train_steps == trained.fused_step.train_steps
    for a, b in zip(before, _weights(wf)):
        numpy.testing.assert_array_equal(a, b)
    assert len(wf.decision.epoch_metrics) == 3
    assert wf.decision.best_epoch == trained.decision.best_epoch


def test_snapshot_auto_fresh_run_and_missing_snapshotter(tmp_path):
    wf, launcher = _cli("--snapshot", "auto", "--snapshot-dir",
                        str(tmp_path / "empty"))
    assert launcher.restored_payload is None and wf.is_finished
    prng.reset()
    root.__dict__.pop("mnist", None)
    with pytest.raises(ValueError, match="snapshotter"):
        _cli("--snapshot", "auto")


def _tiny(seed=1, max_epochs=2):
    prng.reset()
    prng.seed_all(seed)
    root.mnist.update({
        "loader": {"minibatch_size": 50, "n_train": 210, "n_valid": 100},
        "decision": {"max_epochs": max_epochs, "fail_iterations": 5},
        "layers": [{"type": "all2all_tanh", "output_sample_shape": 16,
                    "learning_rate": 0.03, "momentum": 0.9},
                   {"type": "softmax", "output_sample_shape": 10,
                    "learning_rate": 0.03, "momentum": 0.9}]})
    return mnist.build(fused=True)


@pytest.mark.parametrize("scan", [0, 1])
def test_device_step_time_never_moves_weights(scan):
    wf = _tiny()
    Launcher(wf, stats=False, epoch_scan=scan, device="cpu").boot()
    runner = wf._fused_runner
    before = [{k: v.clone() for k, v in e.items()} for e in runner.state]
    step = runner.measure_device_step_time(iters=2)
    if scan:
        assert step is None        # the CPU captures nothing to replay
    else:
        assert step is not None and 0.0 < step < 60.0
    wf.print_stats()
    for a, b in zip(before, runner.state):
        for k in a:
            assert torch.equal(a[k], b[k])


def test_profile_writes_chrome_trace(tmp_path):
    wf = _tiny(max_epochs=1)
    Launcher(wf, stats=False, profile=str(tmp_path / "trace"),
             device="cpu").boot()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_launcher_refuses_distributed_and_scan_with_evaluate():
    wf = _tiny()
    # a distributed run needs its coordinator, size and rank: no cluster
    # environment is read
    with pytest.raises(ValueError, match="coordinator-address"):
        Launcher(wf, distributed=True, stats=False, device="cpu").boot()
    with pytest.raises(ValueError, match="TRAINING driver"):
        Launcher(wf, stats=False, evaluate=True, epoch_scan=1,
                 device="cpu").boot()


def test_cli_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in ([], ["-d", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["veles_tpu_torch.samples.mnist", "--no-stats",
                      *device, *SMALL])


def test_python_m_runs_without_jax(tmp_path):
    """``python -m veles_tpu_torch`` end to end in a fresh process on the
    CPU, the epoch scan writing snapshots and a result file: it never
    imports jax or the JAX package."""
    code = ("import runpy, sys\n"
            "sys.argv = ['veles_tpu_torch'] + sys.argv[1:]\n"
            "try:\n"
            "    runpy.run_module('veles_tpu_torch', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert not e.code, e.code\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'veles_tpu')"
            " or m.startswith(('jax.', 'jaxlib', 'veles_tpu.')))\n"
            "print('BAD=%s' % bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-c", code, "veles_tpu_torch.samples.mnist",
         "-d", "cpu", "--epoch-scan", "1", "--snapshot-dir",
         str(tmp_path / "d"), "--result-file", str(tmp_path / "r.json"),
         *SMALL], env=env, cwd=tmp_path, capture_output=True, text=True,
        timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD=[]" in out.stdout, out.stdout
    assert json.loads((tmp_path / "r.json").read_text())["best_epoch"] >= 1
    assert os.path.exists(tmp_path / "d" / "mnist_current.pickle.gz")


def test_serve_after_training_answers_with_the_trained_weights(tmp_path):
    """``--serve 0 --serve-batch 4`` on MNIST in a subprocess: the CLI
    trains, prints the SERVING line and answers ``/predict`` through the
    micro-batcher with the trained weights' eval forward (the final
    snapshot restored here; one row a request, one thread each side)."""
    import signal
    import urllib.request
    from veles_tpu_torch import snapshotter
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "veles_tpu_torch",
         "veles_tpu_torch.samples.mnist", "-d", "cpu", "--random-seed", "3",
         "--no-stats", "--serve", "0", "--serve-batch", "4",
         "--snapshot-dir", str(tmp_path / "snaps"), *SMALL],
        env=env, cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("SERVING http://127.0.0.1:"), line
        url = line.split()[1]
        for part in SMALL:
            from veles_tpu_torch.config import parse_override
            parse_override(part)
        wf = mnist.build()
        wf.initialize(device="cpu")
        snapshotter.restore(wf, str(tmp_path / "snaps" /
                                    "mnist_current.pickle.gz"))
        runner = wf._fused_runner
        x = numpy.asarray(wf.loader.original_data.mem[:6])
        for row in x:
            req = urllib.request.Request(
                url, data=json.dumps({"input": [row.tolist()]}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                out = json.loads(resp.read())
            want = runner.eval_forward()(
                runner.state, torch.from_numpy(row[None])).numpy()
            numpy.testing.assert_allclose(out["output"], want, rtol=0,
                                          atol=1e-6)
            assert out["argmax"] == want.argmax(1).tolist()
        with urllib.request.urlopen(url.replace("/predict", "/metrics.json"),
                                    timeout=10) as resp:
            assert json.loads(resp.read())["responses"] == 6
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
